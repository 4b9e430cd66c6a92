"""Decoder stack for the dense and audio families: parameters, forward
(prefill) and one-token decode.

The port of ``repro/models/transformer.py`` for the homogeneous stack
(``dense`` and ``audio``). ``lax.scan`` over stacked layers becomes a
loop over an ``nn.ModuleList``; the reference's sharding hints and
``jax.checkpoint`` have no job off a mesh and outside training. The other
families raise ``NotImplementedError`` naming their ROADMAP item.

What is cast to ``cfg.dtype``, as in the reference: the layer stack
(every layer parameter, norms included) and the LM head, at each call.
The embedding table is gathered in f32 and the rows cast; ``final_ln``
stays f32.

Attention backends:
  "softmax"    exact attention (``attention_impl`` "blockwise": plain
               tensor code; "flash": kernel B9, one launch a layer)
  "maclaurin"  the paper's second-order collapse (from T = 1024 kernel
               B8, one launch a layer; decode from the O(d^2) state)
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models import maclaurin_attention as mac
from repro_torch.models.attention import (
    Attention,
    _project_qkv,
    decode_attention,
    decode_attention_quant,
    kv_quant_groups,
    self_attention,
)
from repro_torch.models.layers import (
    Embedding,
    LMHead,
    ParamModule,
    RMSNorm,
    SwiGLU,
    embed,
    lm_head,
    rmsnorm,
    swiglu,
)

SEED = 0
# Families of the reference that wait for their own slice (ROADMAP A10).
_LATER = {
    "moe": "A10 (models/moe.py)",
    "ssm": "A10 (models/rwkv.py)",
    "hybrid": "A10 (models/ssm.py)",
    "vlm": "A10 (cross-attention)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _LATER or cfg.moe_num_experts:
        item = _LATER.get(cfg.family, _LATER["moe"])
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP {item})"
        )


# ======================================================================
# parameter construction
# ======================================================================


class DenseLayer(ParamModule):
    """Pre-norm attention + SwiGLU block: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, device)
        self.attn = Attention(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.qkv_bias, generator, device
        )
        self.ln2 = RMSNorm(d, device)
        self.ffn = SwiGLU(d, cfg.d_ff, generator, device)


class LMParams(ParamModule):
    """``embed``, ``lm_head``, ``final_ln`` and ``layers`` (one module a
    layer, where the reference stacks every leaf along a layer axis)."""

    def __init__(self, cfg: ModelConfig, generator, device=None):
        super().__init__()
        _check_family(cfg)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, generator, device)
        self.lm_head = LMHead(cfg.d_model, cfg.vocab_size, generator, device)
        self.final_ln = RMSNorm(cfg.d_model, device)
        self.layers = nn.ModuleList(
            DenseLayer(cfg, generator, device) for _ in range(cfg.n_layers)
        )


def init_params(cfg: ModelConfig, seed: int = SEED, device=None) -> LMParams:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, at
    the reference's scales. Built on ``device``: CUDA unless the caller
    says, raising when there is no card."""
    dev = _device.resolve(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return LMParams(cfg, generator, dev)


# ======================================================================
# forward (prefill)
# ======================================================================


def _attn_forward(cfg: ModelConfig, p_attn, x, positions):
    """Self-attention dispatch over backends/implementations."""
    B, T, _ = x.shape
    if cfg.attention_backend == "maclaurin":
        q, k, v = _project_qkv(
            p_attn, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta
        )
        out = mac.maclaurin_attention_gqa(q, k, v)
        return out.reshape(B, T, cfg.n_heads * cfg.hd) @ p_attn["w_o"]
    if cfg.attention_impl == "flash":
        q, k, v = _project_qkv(
            p_attn, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta
        )
        g = cfg.n_heads // cfg.n_kv_heads
        kq = torch.repeat_interleave(k, g, dim=2).transpose(1, 2)
        vq = torch.repeat_interleave(v, g, dim=2).transpose(1, 2)
        out = flash_attention(q.transpose(1, 2), kq, vq)
        out = out.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.hd)
        return out @ p_attn["w_o"]
    return self_attention(
        p_attn, x,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        positions=positions, rope_theta=cfg.rope_theta, causal=True,
        scores_dtype=getattr(torch, cfg.attn_scores_dtype),
    )


def _dense_block(cfg: ModelConfig, p, x, positions):
    """Pre-norm attention + FFN block."""
    x = x + _attn_forward(cfg, p["attn"], rmsnorm(p["ln1"], x), positions)
    return x + swiglu(p["ffn"], rmsnorm(p["ln2"], x))


@torch.inference_mode()
def forward(cfg: ModelConfig, params: LMParams, tokens: torch.Tensor):
    """Full-sequence forward -> (logits, aux_loss). tokens: (B, T)."""
    _check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    T = tokens.shape[1]
    x = embed(params.embed.tensors(), tokens).to(dtype)
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    for layer in params.layers:
        x = _dense_block(cfg, layer.tensors(dtype), x, positions)
    x = rmsnorm(params.final_ln.tensors(), x)
    logits = lm_head(params.lm_head.tensors(dtype), x)
    return logits, torch.zeros((), dtype=torch.float32, device=tokens.device)


# ======================================================================
# decode (serve_step substrate)
# ======================================================================


def _mac_attn_decode(cfg: ModelConfig, p_attn, x, pos, state: mac.MacState):
    """Maclaurin-state decode attention: the paper's O(d^2) collapse.

    state leaves have batch dims (B, Hkv). Extend-then-readout = causal
    inclusive of the current token (matches the kernel/ref semantics).
    """
    B = x.shape[0]
    Hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(
        p_attn, x, cfg.n_heads, cfg.n_kv_heads, cfg.hd, positions, cfg.rope_theta
    )
    k_bh = k.transpose(1, 2)  # (B, Hkv, 1, hd)
    v_bh = v.transpose(1, 2)
    f32 = torch.float32
    state = mac.extend_state(state, k_bh.to(f32), v_bh.to(f32))
    q_bh = q.reshape(B, 1, Hkv, g, cfg.hd)[:, 0].to(f32)  # (B, Hkv, g, hd)
    out, _valid = mac.readout(state, q_bh)  # (B, Hkv, g, hd)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd).to(x.dtype)
    return out @ p_attn["w_o"], state


def _dense_block_decode(cfg: ModelConfig, p, x, pos, attn_cache):
    """One-token dense block. attn_cache: (ck, cv) | int8 4-tuple | MacState."""
    h = rmsnorm(p["ln1"], x)
    if cfg.attention_backend == "maclaurin":
        attn_out, attn_cache = _mac_attn_decode(cfg, p["attn"], h, pos, attn_cache)
    elif len(attn_cache) == 4:
        ck, cv, ks, vs = attn_cache
        attn_out, *attn_cache = decode_attention_quant(
            p["attn"], h, ck, cv, ks, vs, pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta,
        )
    else:
        ck, cv = attn_cache
        attn_out, *attn_cache = decode_attention(
            p["attn"], h, ck, cv, pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta,
        )
    x = x + attn_out
    return x + swiglu(p["ffn"], rmsnorm(p["ln2"], x)), attn_cache


def init_cache(cfg: ModelConfig, B: int, S: int, dtype=torch.bfloat16, device=None):
    """The decode cache for a context window of S tokens.

    softmax backend: {"kv": (k, v)}, (L, B, S, Hkv, hd) tensors of ``dtype``
    — O(S) memory; with ``kv_cache_dtype="int8"`` {"kv": (k, v, k_scale,
    v_scale)}, int8 values and f32 scales per 16-channel group.
    maclaurin backend: {"kv": MacState} with (L, B, Hkv, ...) f32 leaves —
    O(d^2), independent of S (S only bounds positions).
    Built on ``device``: CUDA unless the caller says.
    """
    _check_family(cfg)
    dev = _device.resolve(device)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    if cfg.attention_backend == "maclaurin":
        return {"kv": mac.init_state((L, B, Hkv), hd, hd, device=dev)}
    shape = (L, B, S, Hkv, hd)
    if cfg.kv_cache_dtype == "int8":
        G = kv_quant_groups(hd)
        scales = (L, B, S, Hkv, G)
        return {
            "kv": (
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(scales, dtype=torch.float32, device=dev),
                torch.zeros(scales, dtype=torch.float32, device=dev),
            )
        }
    return {
        "kv": (
            torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev),
        )
    }


def cache_bytes(cache) -> int:
    """Bytes the decode cache holds on the device."""
    return sum(t.numel() * t.element_size() for t in cache["kv"])


@torch.inference_mode()
def decode(cfg: ModelConfig, params: LMParams, tokens: torch.Tensor, pos: int, cache):
    """One decode step. tokens: (B, 1) -> (logits (B, 1, V), cache).

    The KV caches are written in place (slot ``pos`` of each layer) and the
    ``MacState`` leaves are overwritten layer by layer, so the returned
    cache is the one passed in.
    """
    _check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    x = embed(params.embed.tensors(), tokens).to(dtype)
    kv = cache["kv"]
    mac_state = cfg.attention_backend == "maclaurin"
    for i, layer in enumerate(params.layers):
        layer_cache = [leaf[i] for leaf in kv]
        layer_cache = mac.MacState(*layer_cache) if mac_state else tuple(layer_cache)
        x, new = _dense_block_decode(cfg, layer.tensors(dtype), x, pos, layer_cache)
        if mac_state:
            for leaf, value in zip(kv, new):
                leaf[i] = value
    x = rmsnorm(params.final_ln.tensors(), x)
    logits = lm_head(params.lm_head.tensors(dtype), x)
    return logits, cache
