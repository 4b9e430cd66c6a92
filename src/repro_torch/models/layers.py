"""Shared transformer layer primitives: norms, RoPE, FFN, embeddings.

The port of ``repro/models/layers.py``. Parameters live in ``nn.Module``s
whose attribute names are the reference's dict keys (``scale``,
``w_gate``/``w_up``/``w_down``, ``table``, ``w``), in the reference's
(in, out) layout, so ``x @ w`` and ``convert`` stay one-to-one. The layer
functions take the parameters as a dict of tensors, as the reference
does: ``ParamModule.tensors(dtype)`` gives that dict with every tensor
cast to the dtype the caller computes in (the reference's ``cast``).

Weights come from ``init_``: normal draws from an explicit
``torch.Generator`` times the reference's scales (``1/sqrt(fan_in)``
unless stated). The two packages draw different numbers from one seed, so
the tests carry the reference's weights across with ``convert``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def init_(shape, generator: torch.Generator, device, scale=None) -> nn.Parameter:
    """A frozen f32 parameter of normal draws times ``scale`` (default
    ``1/sqrt(shape[0])``, the reference's ``_init``)."""
    if scale is None:
        scale = 1.0 / (shape[0] ** 0.5)
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return nn.Parameter(x * scale, requires_grad=False)


def zeros_(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)


class ParamModule(nn.Module):
    """An ``nn.Module`` whose parameters read as the reference's dict.

    ``SPEC`` holds the spec half of the reference's ``*_params`` builder:
    a tuple of logical axis names (``sharding.partitioning``'s vocabulary:
    "vocab", "embed", "heads", "kv_heads", "ffn", "experts", None) for each
    parameter, and for a child whose spec differs from its own."""

    SPEC: dict = {}

    def spec(self) -> dict:
        """The reference's spec tree of this module: ``SPEC``'s entry for
        each parameter present, each child's own ``spec()`` unless
        ``SPEC`` names the child."""
        own = self.named_parameters(recurse=False)
        out = {name: self.SPEC[name] for name, _ in own}
        for name, child in self.named_children():
            out[name] = self.SPEC[name] if name in self.SPEC else child.spec()
        return out

    def tensors(self, dtype: torch.dtype | None = None) -> dict:
        """Nested dict of this module's parameters, each cast to ``dtype``
        (as they are when None). Children appear under their names."""
        out = {
            name: (p if dtype is None else p.to(dtype))
            for name, p in self.named_parameters(recurse=False)
        }
        for name, child in self.named_children():
            out[name] = child.tensors(dtype)
        return out


def _records(tree) -> bool:
    """Whether a tensor in ``tree`` (dicts, lists, tuples) requires grad."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_records(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_records(v) for v in tree)
    return False


def remat(fn, *args):
    """``fn(*args)`` recomputed in the backward pass instead of keeping its
    intermediates, where the reference wraps ``fn`` in ``jax.checkpoint``:
    ``torch.utils.checkpoint`` (non-reentrant) while autograd records a
    graph through ``args``, a plain call otherwise (serving, evaluation).
    Nothing here draws random numbers, so no RNG state is kept."""
    if torch.is_grad_enabled() and _records(args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------- norms


class RMSNorm(ParamModule):
    SPEC = {"scale": ("embed",)}

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), device=device), requires_grad=False)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in f32 and cast back to x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * params["scale"]
    return out.to(dtype)


# ---------------------------------------------------------------- RoPE


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: (B, T, H, hd); positions: (T,) or (B, T). Rotates the interleaved
    pairs (x[..., 0::2], x[..., 1::2]), not the two halves."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    inv = 1.0 / (theta**exps)
    ang = positions[..., None].to(torch.float32) * inv  # (..., T, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if cos.ndim == 2:  # (T, hd/2) -> broadcast over batch
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, T, hd/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------- FFN


class SwiGLU(ParamModule):
    SPEC = {
        "w_gate": ("embed", "ffn"),
        "w_up": ("embed", "ffn"),
        "w_down": ("ffn", "embed"),
    }

    def __init__(self, d: int, d_ff: int, generator: torch.Generator, device=None):
        super().__init__()
        self.w_gate = init_((d, d_ff), generator, device)
        self.w_up = init_((d, d_ff), generator, device)
        self.w_down = init_((d_ff, d), generator, device, scale=1.0 / (d_ff**0.5))


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------- embeddings


class Embedding(ParamModule):
    SPEC = {"table": ("vocab", "embed")}

    def __init__(self, vocab: int, d: int, generator: torch.Generator, device=None):
        super().__init__()
        self.table = init_((vocab, d), generator, device, scale=0.02)


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


class LMHead(ParamModule):
    SPEC = {"w": ("embed", "vocab")}

    def __init__(self, d: int, vocab: int, generator: torch.Generator, device=None):
        super().__init__()
        self.w = init_((d, vocab), generator, device, scale=0.02)


def lm_head(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


# ---------------------------------------------------------------- losses


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; stable logsumexp; logits (B,T,V) f32;
    labels (B,T) of any integer type."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    return torch.mean(lse - gold)
