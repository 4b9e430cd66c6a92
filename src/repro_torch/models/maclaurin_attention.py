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

``MacState``, ``init_state`` and ``extend_state`` live beside the
quadratic oracle in ``kernels/maclaurin_attn/ref.py``, which B8's plain
twin shares, and are re-exported here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import tuning
from repro_torch.kernels.maclaurin_attn import maclaurin_attention, maclaurin_attention_ref
from repro_torch.kernels.maclaurin_attn.ref import (  # noqa: F401  (re-exported)
    MacState,
    extend_state,
    init_state,
    moment_terms,
)

REF_CHUNK = 256  # the reference's default chunk, which sets its refusal


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
    the port's default from ``tuning``).

    q,k,v: (B, H, T, d) -> (B, H, T, d_v) in v's dtype, computed in f32.
    Refuses, as the reference does, a T that is not a multiple of the
    chunk, which is the reference's ``REF_CHUNK`` where none is named.
    """
    config = tuning.lookup("maclaurin_attn")
    if chunk is not None:
        config = config.with_(chunk=chunk)
    refused = REF_CHUNK if chunk is None else config.chunk
    T = q.shape[2]
    if T % refused:
        raise ValueError(f"T={T} % chunk={refused}")
    return maclaurin_attention(q, k, v, scale=scale, config=config)
