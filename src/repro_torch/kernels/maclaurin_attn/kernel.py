"""Kernel B8: chunked causal Maclaurin attention, w(u) = 1 + u + u^2/2.

``maclaurin_attention_cuda`` launches ``csrc/maclaurin_attn.cu`` (CUDA C++
for ``sm_90a``; the source's header note says what bounds it and how the
(D^2, DV) moment S2 is split over blocks) on CUDA tensors, and computes
with its plain twin ``maclaurin_attention_torch`` on CPU tensors. It
replaces ``repro/kernels/maclaurin_attn/kernel.py::maclaurin_attention_pallas``.

Both take (BH, T, d) inputs, compute in f32 as the reference casts them,
and return (BH, T, dv) f32. The chunk is ``TileConfig.chunk`` (the
port's default from ``tuning``), cut to T as the reference does: keys of
earlier chunks reach a query through the running moments, keys of its own
chunk exactly.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_operands, on_card
from repro_torch.kernels.common import TileConfig, tiles, tuning
from repro_torch.kernels.maclaurin_attn.ref import extend_state, init_state, moment_terms

HEAD_DIMS = (16, 32, 64, 96, 128)  # d the source is compiled for

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "maclaurin_attention",
    "maclaurin_attn.cu",
    "maclaurin_attn_f32",
    [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P],
)


def _scale(scale, d: int) -> float:
    return 1.0 / float(d) ** 0.5 if scale is None else float(scale)


def maclaurin_attention_torch(q, k, v, *, scale=None, config: TileConfig | None = None):
    """Plain twin: the chunked schedule of the reference kernel, one chunk
    at a time over every (batch*head) at once, with the decode state's
    moment algebra (``ref.moment_terms``, ``ref.extend_state``). q, k (BH,
    T, d), v (BH, T, dv) -> (BH, T, dv) f32. T is zero-padded to a
    multiple of the chunk; the padded keys sit after every real row, so the
    causal mask removes them, and the padded rows are sliced off."""
    config = config or tuning.lookup("maclaurin_attn")
    bh, t, d = q.shape
    dv = v.shape[-1]
    scale = _scale(scale, d)
    chunk = min(config.chunk, t)
    t_pad = tiles.round_up(t, chunk)

    def prep(x):
        x = x.to(torch.float32)
        return torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))

    qp, kp, vp = prep(q), prep(k), prep(v)
    state = init_state((bh,), d, dv, device=q.device)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    outs = []
    for c0 in range(0, t_pad, chunk):
        qc, kc, vc = (x[:, c0 : c0 + chunk] for x in (qp, kp, vp))
        # earlier chunks through the moments, this chunk's keys exactly
        num, den = moment_terms(state, qc, scale)
        u = scale * (qc @ kc.transpose(1, 2))
        w = (1.0 + u + 0.5 * u * u).masked_fill(~tri, 0.0)
        outs.append((num + w @ vc) / (den + w.sum(-1))[..., None])
        # after the readout: chunk c's keys are 'previous' only for c + 1
        state = extend_state(state, kc, vc)
    return torch.cat(outs, dim=1)[:, :t]


def maclaurin_attention_cuda(q, k, v, *, scale=None, config: TileConfig | None = None):
    """Causal Maclaurin attention. q, k (BH, T, d), v (BH, T, dv), any float
    type (cast to f32 as the reference does). Returns (BH, T, dv) f32.

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise. Nothing falls back from the card to the plain version.
    """
    if not on_card(q, "maclaurin_attention"):
        return maclaurin_attention_torch(q, k, v, scale=scale, config=config)
    config = config or tuning.lookup("maclaurin_attn")
    bh, t, d = q.shape
    dv = v.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"maclaurin_attention: d={d}; compiled for {HEAD_DIMS}")
    if not 1 <= dv <= 1024:
        raise ValueError(f"maclaurin_attention: dv={dv} out of range")
    q, k, v = (x.to(torch.float32).contiguous() for x in (q, k, v))
    f32 = torch.float32
    check_operands(q, {"k": (k, (bh, t, d), f32), "v": (v, (bh, t, dv), f32)})
    chunk = min(config.chunk, t)
    out = torch.empty((bh, t, dv), dtype=f32, device=q.device)
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
            chunk,
            _scale(scale, d),
            stream,
        )
    return out
