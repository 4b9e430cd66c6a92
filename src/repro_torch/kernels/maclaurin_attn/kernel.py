"""Kernel B8: causal Maclaurin attention, w(u) = 1 + u + u^2/2.

``maclaurin_attention_cuda`` launches ``csrc/maclaurin_attn.cu`` (CUDA C++
for ``sm_90a``; the source's header note says what bounds it, how its
quadratic route runs on the tensor-core tile engine of ``attn_tile.cuh``
and how its moments route splits the (D^2, DV) moment S2 over blocks) on
CUDA tensors, and computes with its plain twin
``maclaurin_attention_torch`` on CPU tensors. It replaces
``repro/kernels/maclaurin_attn/kernel.py::maclaurin_attention_pallas``.

Both take (BH, T, d) inputs, compute in f32 as the reference casts them,
and return (BH, T, dv) f32. The chunk is ``TileConfig.chunk`` (the
port's default from ``tuning``), cut to T as the reference does: in the
twin and the kernel's moments route, keys of earlier chunks reach a query
through the running moments, keys of its own chunk exactly. ``route``
picks the kernel's route: the one a cost model fitted on the card finds
faster. On the card, a d the source is not compiled for is zero-padded
to the next width it is (``pad_head_dim``), which leaves every q.k, and
so the function, unchanged.

The launch is one op, ``torch.ops.repro_torch.maclaurin_attention``
(``launch_op``), so that a dispatch mode sees it whole: its shape rule
gives the dry run (``launch.dryrun``) the output, and ``launch.op_cost``
counts its work with ``maclaurin_work``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (
    CudaKernel,
    check_operands,
    on_card,
    refuse_grad,
)
from repro_torch.kernels.common import TileConfig, tiles, tuning
from repro_torch.kernels.maclaurin_attn.ref import extend_state, init_state, moment_terms

HEAD_DIMS = (16, 32, 64, 96, 128)  # d the source is compiled for
ROUTES = ("moments", "quadratic")  # the entry point's route argument, by index

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "maclaurin_attention",
    "maclaurin_attn.cu",
    "maclaurin_attn_f32",
    [_P] * 4 + [_I] * 6 + [ctypes.c_float, _P],
)


# The two routes' times on an H100 (ms), fitted to ``python3 chip_smoke.py
# --route-sweep`` (both routes forced at d = dv in HEAD_DIMS and five other
# (d, dv), BH 1-256, T 256-65536, chunk 64) on an H100 80GB HBM3 at 700 W.
# Quadratic route (attn_tile.cuh, width W = 64, or 128 past 64): a block per
# (head, W value columns, 64-row query tile) runs one 64 x 64 key-tile step
# per tile on or below the diagonal; the card clears TILE_STEP_MS[W] a step
# with every SM busy, and one block BLOCK_STEP_MS[W] a step alone, so the
# longest block's chain bounds small grids. Moments route (a block per
# (head, dvt value columns), its chunks in order): a block takes KEY_MS[d] a
# key with its shared memory full of columns, less in proportion to its
# columns, and BLOCKS_PER_SM[d] run at once on each SM.
SMS = 132
TILE_STEP_MS = {64: 1.9e-5, 128: 5.3e-5}
BLOCK_STEP_MS = {64: 3.3e-3, 128: 7.3e-3}
KEY_MS = {16: 5.8e-4, 32: 8.6e-4, 64: 1.0e-3, 96: 8.7e-4, 128: 8.1e-4}
BLOCKS_PER_SM = {16: 1.3, 32: 1.15, 64: 1.0, 96: 1.0, 128: 1.0}
MAX_SMEM, MAX_COLS = 232448, 16  # maclaurin_attn.cu's kMaxSmem and kMaxCols


def value_columns(d: int, dv: int) -> tuple[int, int]:
    """(value columns a moments block keeps, the most that fit): the
    source's ``value_columns``, from the shared memory of ``smem_floats``."""

    def smem_floats(ncols: int) -> int:
        return ncols * d * d + d * ncols + ncols + 2 * 64 * (d + 1) + 64 * ncols * 2 + 64 * 65

    most = max(c for c in range(1, min(dv, MAX_COLS) + 1) if 4 * smem_floats(c + 1) <= MAX_SMEM)
    blocks = -(-dv // most)
    return -(-dv // blocks), most


def route_ms(bh: int, t: int, d: int, dv: int) -> dict[str, float]:
    """Each route's time in ms on the card at (BH, T, d, dv), from the cost
    model above."""
    w = 64 if d <= 64 and dv <= 64 else 128
    n = -(-t // 64)
    steps = bh * -(-dv // w) * n * (n + 1) / 2
    quadratic = max(steps * TILE_STEP_MS[w], n * BLOCK_STEP_MS[w])
    dvt, most = value_columns(d, dv)
    blocks = bh * -(-dv // dvt)
    waves = max(1.0, blocks / (SMS * BLOCKS_PER_SM[d]))
    moments = t * KEY_MS[d] * (dvt + 1) / (most + 1) * waves
    return {"moments": moments, "quadratic": quadratic}


def route(bh: int, t: int, d: int, dv: int) -> str:
    """The kernel's route at (BH, T, d, dv): the one ``route_ms`` finds
    faster. The quadratic form's work grows with BH T^2 on a full card, the
    moments' with T alone while their blocks fit on the SMs, so the moments
    win only at long T and few blocks, e.g. BH = 64, d = dv = 16 past T =
    4096; every shape of the repo's models takes the quadratic form."""
    times = route_ms(bh, t, d, dv)
    return "quadratic" if times["quadratic"] <= times["moments"] else "moments"


def _scale(scale, d: int) -> float:
    return 1.0 / float(d) ** 0.5 if scale is None else float(scale)


def pad_head_dim(q, k):
    """q and k zero-padded along d to the next width in ``HEAD_DIMS``; a
    zero column adds nothing to any q.k. The caller keeps the scale of the
    original d. Raises past the widest."""
    d = q.shape[-1]
    width = next((w for w in HEAD_DIMS if w >= d), None)
    if width is None:
        raise ValueError(f"maclaurin_attention: d={d}; at most {HEAD_DIMS[-1]}")
    if width == d:
        return q, k
    pad = (0, width - d)
    return torch.nn.functional.pad(q, pad), torch.nn.functional.pad(k, pad)


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


def maclaurin_attention_cuda(
    q, k, v, *, scale=None, config: TileConfig | None = None, force_route: str | None = None
):
    """Causal Maclaurin attention. q, k (BH, T, d), v (BH, T, dv), any float
    type (cast to f32 as the reference does). Returns (BH, T, dv) f32. On
    the card q and k are padded to a compiled width (``pad_head_dim``), and
    the kernel takes ``route(BH, T, that width, dv)``, or ``force_route``
    where given (to time or test one route alone).

    CPU tensors take the plain twin; CUDA tensors launch the kernel or
    raise. Nothing falls back from the card to the plain version.
    """
    if not on_card(q, "maclaurin_attention"):
        return maclaurin_attention_torch(q, k, v, scale=scale, config=config)
    refuse_grad("maclaurin_attention", q, k, v)
    config = config or tuning.lookup("maclaurin_attn")
    bh, t, d = q.shape
    dv = v.shape[-1]
    if not 1 <= dv <= 1024:
        raise ValueError(f"maclaurin_attention: dv={dv} out of range")
    scale = _scale(scale, d)  # of the d asked for, not the padded width
    q, k = pad_head_dim(q, k)
    d = q.shape[-1]
    q, k, v = (x.to(torch.float32).contiguous() for x in (q, k, v))
    f32 = torch.float32
    check_operands(q, {"k": (k, (bh, t, d), f32), "v": (v, (bh, t, dv), f32)})
    chunk = min(config.chunk, t)
    taken = force_route or route(bh, t, d, dv)
    if taken not in ROUTES:
        raise ValueError(f"maclaurin_attention: route {taken!r} not in {ROUTES}")
    return launch_op(q, k, v, chunk, ROUTES.index(taken), scale)


@torch.library.custom_op("repro_torch::maclaurin_attention", mutates_args=())
def launch_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int, route_index: int, scale: float
) -> torch.Tensor:
    """One launch on checked f32 operands (d a compiled width): (BH, T, dv)
    f32."""
    bh, t, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((bh, t, dv), dtype=torch.float32, device=q.device)
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
            route_index,
            scale,
            stream,
        )
    return out


@launch_op.register_fake
def _(q, k, v, chunk, route_index, scale):
    return q.new_empty((q.shape[0], q.shape[1], v.shape[-1]), dtype=torch.float32)
