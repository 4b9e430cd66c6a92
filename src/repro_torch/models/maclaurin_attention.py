"""Maclaurin linear attention as a drop-in decoder-attention backend.

The port of ``repro/models/maclaurin_attention.py``: the paper's technique
operating as attention. The KV set plays the support vectors, the query
plays the test instance, and the running moment state (S0..S2) is the
(c, v, M) quadratic form. Decode cost/state is O(d_k^2 d_v) per head —
independent of context length, exactly as the paper's predictor is
independent of n_sv.

State layout per (batch, kv-head):
    s1  (d_k, d_v)      sum_j k_j v_j^T          — the paper's  v = Xw
    s2  (d_k^2, d_v)    sum_j phi2(k_j) v_j^T    — the paper's  M = XDX^T
    k1  (d_k,)          sum_j k_j                |
    k2  (d_k^2,)        sum_j phi2(k_j)          |- normalizer moments
    n   ()              count                    |
    v0  (d_v,)          sum_j v_j                — order-0 numerator

The Eq 3.11 analogue: validity needs |q.k|/sqrt(d) < 1/2; the state
tracks max ||k||^2 so serving can check ||q||^2 max||k||^2 < d/4 per
query at no extra cost (``readout`` returns the flag).

Routing of the full-sequence form (``maclaurin_attention_gqa``), as in the
reference: below T = 1024 the O(T^2) quadratic form in plain tensor code;
from T = 1024 the chunked form ``maclaurin_attention_chunked``. The
reference writes that chunked form twice — the Pallas kernel, and a
``lax.scan`` twin with "the same math" that exists only so it lowers under
GSPMD. The port has no GSPMD, so ``maclaurin_attention_chunked(q, k, v,
scale, chunk)`` is kernel B8's dispatch (the kernel on CUDA tensors, its
plain twin on CPU tensors), keeping the reference's refusal of a T that is
not a multiple of the chunk: of ``chunk`` where one is named, else of the
reference's default ``REF_CHUNK`` = 256. A named chunk is also the one B8
runs at; unnamed, B8 runs at the port's one chunk, ``tuning``'s default
(64), as ``use_kernel=True`` does: the chunk changes the order of the
sums, not the function.

Under a gradient the chunked form is ``ChunkedMaclaurin``, an autograd
``Function``: its forward is B8's dispatch as above, and its backward
recomputes the plain chunked twin (``maclaurin_attention_torch``) and
returns that twin's vector-Jacobian product. That is the reference's
gradient, JAX's autodiff of the same chunked algebra; the reference has
no backward kernel, and neither does the port.

``MacState``, ``init_state`` and ``extend_state`` live beside the
quadratic oracle in ``kernels/maclaurin_attn/ref.py``, which B8's plain
twin shares, and are re-exported here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import tuning
from repro_torch.kernels.maclaurin_attn import (
    maclaurin_attention,
    maclaurin_attention_cuda,
    maclaurin_attention_ref,
    maclaurin_attention_torch,
)
from repro_torch.kernels.maclaurin_attn.ref import (  # noqa: F401  (re-exported)
    MacState,
    extend_state,
    init_state,
    moment_terms,
)

REF_CHUNK = 256  # the reference's default chunk, which sets its refusal
# What the backward's twin may keep for autograd at once: heads are
# independent, so it runs over groups of heads whose saved moments (one
# (d^2, dv) S2 and two (chunk, d^2) feature maps a chunk) fit in this.
BACKWARD_BYTES = 4 << 30


def readout(state: MacState, q: torch.Tensor, scale: float | None = None):
    """Evaluate the quadratic form for queries q (..., T, d_k).

    Returns (out (..., T, d_v), valid (..., T)) — ``valid`` is the Eq 3.11
    analogue computed from ||q||^2 · max||k||^2 · scale^2 < 1/4.
    """
    d_k = q.shape[-1]
    if scale is None:
        scale = 1.0 / float(d_k) ** 0.5
    num, den = moment_terms(state, q, scale)
    q_sq = torch.sum(q * q, dim=-1)
    valid = (scale * scale) * q_sq * state.max_k_sq < 0.25
    return num / den[..., None], valid


def maclaurin_attention_gqa(q, k, v, scale: float | None = None, use_kernel: bool = False):
    """Full-sequence causal maclaurin attention with GQA head layout.

    q: (B, T, Hq, hd), k/v: (B, T, Hkv, hd) -> (B, T, Hq, hd).

    ``use_kernel=True`` routes through kernel B8; otherwise T >= 1024 takes
    the chunked form (B8 as well, at the same chunk) and shorter sequences
    the O(T^2) form.
    """
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    # Expand kv heads to query heads (GQA) and move to (B, H, T, d).
    kq = torch.repeat_interleave(k, g, dim=2).transpose(1, 2)
    vq = torch.repeat_interleave(v, g, dim=2).transpose(1, 2)
    qq = q.transpose(1, 2)
    if use_kernel:
        out = maclaurin_attention(qq, kq, vq, scale=scale)
    elif T >= 1024:
        out = maclaurin_attention_chunked(qq, kq, vq, scale=scale)
    else:
        out = maclaurin_attention_ref(qq, kq, vq, scale=scale)
    return out.transpose(1, 2)


def maclaurin_attention_chunked(
    q, k, v, scale: float | None = None, chunk: int | None = None
):
    """Chunked causal Maclaurin attention: kernel B8 at this chunk (``None``:
    the port's default from ``tuning``), through ``ChunkedMaclaurin``, so
    that a gradient flows (the plain twin's).

    q,k,v: (B, H, T, d) -> (B, H, T, d_v) in v's dtype, computed in f32.
    Refuses, as the reference does, a T that is not a multiple of the
    chunk, which is the reference's ``REF_CHUNK`` where none is named.
    """
    config = tuning.lookup("maclaurin_attn")
    if chunk is not None:
        config = config.with_(chunk=chunk)
    refused = REF_CHUNK if chunk is None else config.chunk
    b, h, T, _ = q.shape
    if T % refused:
        raise ValueError(f"T={T} % chunk={refused}")
    dv = v.shape[-1]

    def flat(x):
        return x.reshape(b * h, T, x.shape[-1])

    out = ChunkedMaclaurin.apply(flat(q), flat(k), flat(v), scale, config)
    return out.reshape(b, h, T, dv).to(v.dtype)


def backward_group(bh: int, t: int, d: int, dv: int, chunk: int) -> int:
    """Heads a group of the backward's twin takes: as many as keep its
    saved moments within ``BACKWARD_BYTES``."""
    c = min(chunk, t)
    n_chunks = -(-t // c)
    per_head = 4 * n_chunks * (d * d * dv + 2 * c * d * d + d * dv + 3 * c * c)
    return max(1, min(bh, BACKWARD_BYTES // per_head))


class ChunkedMaclaurin(torch.autograd.Function):
    """Chunked causal Maclaurin attention with a gradient. q, k (BH, T, d),
    v (BH, T, dv) -> (BH, T, dv) f32.

    forward: kernel B8 on CUDA tensors, its plain twin on CPU tensors
    (``maclaurin_attention_cuda``; autograd records nothing inside).
    backward: the twin rerun under ``torch.enable_grad()`` over groups of
    heads (``backward_group``), and its vector-Jacobian product returned:
    plain PyTorch, as the reference differentiates its plain ``lax.scan``
    form. Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, scale, config):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.config = scale, config
        return maclaurin_attention_cuda(q, k, v, scale=scale, config=config)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        bh, t, d = q.shape
        group = backward_group(bh, t, d, v.shape[-1], ctx.config.chunk)
        grads = [torch.empty_like(x) if n else None for x, n in zip((q, k, v), needs)]
        for i in range(0, bh, group):
            with torch.enable_grad():
                part = [
                    x[i : i + group].detach().requires_grad_(n)
                    for x, n in zip((q, k, v), needs)
                ]
                out = maclaurin_attention_torch(*part, scale=ctx.scale, config=ctx.config)
                wrt = [x for x, n in zip(part, needs) if n]
                got = iter(torch.autograd.grad(out, wrt, grad_out[i : i + group]))
            for g, n in zip(grads, needs):
                if n:
                    g[i : i + group] = next(got)
        return (*grads, None, None)
