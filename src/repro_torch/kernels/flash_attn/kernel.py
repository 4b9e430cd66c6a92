"""Kernel B9: fused causal softmax attention with an online softmax.

``flash_attention_cuda`` launches ``csrc/flash_attn.cu`` (CUDA C++ for
``sm_90a`` on the tensor-core tile engine of ``csrc/attn_tile.cuh``; the
source's header note says what bounds it, which MMA each product uses and
its precision contract) on CUDA tensors, and computes with its plain twin
``flash_attention_torch`` on CPU tensors. It replaces
``repro/kernels/flash_attn/kernel.py::flash_attention_pallas``.

Both take (BH, T, d) q and k and (BH, T, dv) v of one type (f32 or bf16),
compute in f32 and return q's type. Both keep the reference's refusal: a
full (non-causal) attention whose T is not a multiple of the key block
would need a mask for the padded keys, so it raises ``ValueError``
instead of padding silently. ``block_q`` and ``block_k`` keep the
reference's signature and defaults (256 x 256), and so refuse exactly
where it does; they set that refusal only. The kernel runs its one 64 x
64 tile whatever blocks are named, and masks keys past T itself.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_operands, on_card
from repro_torch.kernels.common import tiles

NEG_INF = -1e30
REF_BLOCK = 256  # the reference's default block_q and block_k
MAX_D = 128  # widest head (q/k and v) the source takes
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention",
    "flash_attn.cu",
    "flash_attn_fwd",
    [_P] * 4 + [_I] * 4 + [ctypes.c_float, _I, _I, _P],
)


def _resolve(q, scale, block_k, causal):
    """The scale after its default, and the reference's refusal of padded
    keys without a causal mask, judged with its blocks: ``block_k``
    (``REF_BLOCK`` unless named) cut to T."""
    block_k = REF_BLOCK if block_k is None else int(block_k)
    t, d = q.shape[-2], q.shape[-1]
    bk = min(block_k, t)
    if not causal and tiles.round_up(t, bk) != t:
        raise ValueError(
            f"flash_attention: non-causal attention over T={t} would pad the keys "
            f"to a multiple of block_k={bk}; padding needs an explicit mask"
        )
    return 1.0 / float(d) ** 0.5 if scale is None else float(scale)


def flash_attention_torch(q, k, v, *, scale=None, causal=True, block_q=None, block_k=None):
    """Plain twin: the whole (T, T) score matrix in f32, masked to NEG_INF
    above the diagonal, softmax, times v in f32, cast to q's type."""
    scale = _resolve(q, scale, block_k, causal)
    t = q.shape[-2]
    s = scale * (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2))
    if causal:
        tri = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.to(torch.float32)).to(q.dtype)


def flash_attention_cuda(q, k, v, *, scale=None, causal=True, block_q=None, block_k=None):
    """Softmax attention. q, k (BH, T, d), v (BH, T, dv), all f32 or all
    bf16. Returns (BH, T, dv) in q's type.

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise. Nothing falls back from the card to the plain version.
    """
    if not on_card(q, "flash_attention"):
        return flash_attention_torch(
            q, k, v, scale=scale, causal=causal, block_q=block_q, block_k=block_k
        )
    scale = _resolve(q, scale, block_k, causal)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q is {q.dtype}; the kernel takes {DTYPES}")
    bh, t, d = q.shape
    dv = v.shape[-1]
    if not (1 <= d <= MAX_D and 1 <= dv <= MAX_D):
        raise ValueError(f"flash_attention: d={d}, dv={dv}; at most {MAX_D}")
    check_operands(
        q, {"k": (k, (bh, t, d), q.dtype), "v": (v, (bh, t, dv), q.dtype)}, z_dtype=q.dtype
    )
    out = torch.empty((bh, t, dv), dtype=q.dtype, device=q.device)
    if bh == 0 or t == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(
            q.data_ptr(),
            k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(),
            bh,
            t,
            d,
            dv,
            scale,
            int(causal),
            int(q.dtype == torch.bfloat16),
            stream,
        )
    return out
