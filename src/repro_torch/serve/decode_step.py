"""Serve-side step factories: prefill and single-token decode.

The port of ``repro/serve/decode_step.py``. ``make_serve_step(cfg)``
returns (params, tokens (B, 1), pos, cache) -> (logits, cache); the cache
backend follows ``cfg.attention_backend``:

  softmax    O(S) KV cache — the exact-model baseline
  maclaurin  O(d^2) moment state — the paper's collapse (context-length-free)

``make_prefill_step(cfg)`` runs the full-sequence forward (logits only).
Every step, and ``greedy_generate``, runs under ``torch.inference_mode``:
serving records no graph, even on parameters a trainer left requiring
gradients.
A VLM's steps also take the image embeddings, as the reference's do:
prefill (params, tokens, image_embeds), decode (params, tokens, pos,
cache, image_embeds).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode, forward


def make_prefill_step(cfg: ModelConfig) -> Callable:
    if cfg.family == "vlm":

        @torch.inference_mode()
        def prefill_step(params, tokens, image_embeds):
            logits, _ = forward(cfg, params, tokens, image_embeds)
            return logits

    else:

        @torch.inference_mode()
        def prefill_step(params, tokens):
            logits, _ = forward(cfg, params, tokens)
            return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    if cfg.family == "vlm":

        @torch.inference_mode()
        def serve_step(params, tokens, pos, cache, image_embeds):
            return decode(cfg, params, tokens, pos, cache, image_embeds)

    else:

        @torch.inference_mode()
        def serve_step(params, tokens, pos, cache):
            return decode(cfg, params, tokens, pos, cache)

    return serve_step


@torch.inference_mode()
def greedy_generate(
    cfg: ModelConfig,
    params,
    prompt,
    cache,
    *,
    steps: int,
    start_pos: int = 0,
    image_embeds=None,
):
    """Greedy decode loop. As in the reference, it feeds only the prompt's
    last token (``prompt[:, -1:]``) at ``start_pos`` and does not fill the
    cache from the prompt: a caller that wants the prompt in the cache
    decodes it first. A VLM passes ``image_embeds`` to each step. Returns
    (tokens (B, steps) int32, cache)."""
    step = make_serve_step(cfg)
    extra = (image_embeds,) if cfg.family == "vlm" else ()
    tok = prompt[:, -1:]
    out = []
    pos = start_pos
    for _ in range(steps):
        logits, cache = step(params, tok, pos, cache, *extra)
        tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1), cache
