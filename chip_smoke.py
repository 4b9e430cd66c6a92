#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Builds the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
source, all started together) and drives five paths: four at the
paper's mnist width (d=780, 10 one-vs-rest heads), and the LM side:

1. compile -> save/load -> ``SVMEngine`` for the maclaurin family, with
   rows scaled just out of the Eq 3.11 envelope so the exact fallback
   (kernel B2) runs beside the fast path (kernel B1);
2. ``compile_model`` over maclaurin, poly2 and dense fourier at f32 and
   int8 (kernels B1, B3, B4, B5), the winner saved, loaded and served,
   then each of the six (family, dtype) artifacts served with rows pushed
   out of the envelope, and a fourier artifact whose held-out verdict
   failed, which sends every row to B2;
3. training on the card (one-vs-rest LS-SVMs on 8192 rows, and a dual
   C-SVC with ``compress_support``), ``compile_model`` over every family
   with the Fastfood projection for fourier, and the Fastfood artifacts
   at f32 and int8 (kernels B6, B7) saved, loaded and served, beside
   copies whose held-out verdict failed;
4. ``smollm-135m`` at full width (30 layers, d_model 576, 9/3 GQA heads)
   from seeded random weights: bf16 prefill of 4 x 2048 tokens with
   blockwise attention, flash attention (kernel B9, one launch a layer)
   and the maclaurin backend (kernel B8, one launch a layer); f32 decode
   of a 1024-token prompt through an f32 and a bf16 KV cache, an int8 KV
   cache and the ``MacState``, held against the matching forward (B9 or
   B8 at f32) or the next wider cache; then 32 greedy tokens from the
   bf16, int8 and ``MacState`` caches;
5. the serving runtime (``repro_torch.serve.runtime``), after a check
   that ``SVMEngine.submit`` returns before the work queued ahead of it
   ends: path 1's maclaurin f32 and int8 artifacts published as two
   tenants of one ``Runtime`` and served to 8 client threads in
   coalesced steps (each request held against its artifact's direct
   submit, beside the same clients on direct submits), an overload burst
   shed with retry hints, three engine faults opening the breaker (the
   degraded requests through B2) and a probe closing it, a drift that
   ``DriftGuard`` heals (``compile_model`` on the live traffic, a canary,
   an alias flip), and last a ``torch.profiler`` trace of one step.

Each path is driven with the launch counts set to 0 just before it and
read just after. Each kernel is held against its plain PyTorch twin at
full width, and timed beside its twin, a library call and the least time
the card could take.

The model of paths 1 and 2 (16384 SVs) is random from a seed, shaped like
a trained one so that no constant swamps what the checks look at: each
head's ``alpha_y`` sums to 0 (the SVM dual's equality constraint), and
``b`` makes every head score 0 at z = 0, so the labels follow z. Path 3's
model is trained. Path 4's weights are random from a seeded
``torch.Generator`` at the reference's scales.

Output: phase lines (each with its seconds), the card line from
nvidia-smi, one JSON line of kernels, and last ``{"ok": true, "device":
{...}}``. Exits non-zero, printing no result, on any failed phase,
without a card, or without the repo's ``src/`` beside it.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
K, N_SV = 10, 16384
REQUEST_ROWS = (1, 37, 256, 1024)
SCALED_ROWS = (0, 3, 8, 16)  # rows per request pushed out of the envelope
# Scaled rows land at msq * |z|^2 = OUTSIDE / (16 gamma^2): outside the
# bound by a margin no rounding closes, yet near enough to the SVs that
# their exact scores still differ from b (further out they equal b).
OUTSIDE = 1.25
EXACT_ROWS = 64

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# f32-accurate products from the tensor cores: 3xTF32 spends three TF32
# products (hi*hi + hi*lo + lo*hi) on one, at the 495 TFLOP/s dense TF32
# rate of NVIDIA's H100 SXM data sheet. The bound of every kernel whose work
# is f32 products, whatever implements it: B1-B5, B9 in f32, B8 by either
# route (its moments are products too) and B6/B7's readout. B6/B7's
# transforms, diagonals and cos are adds and multiplies of their own, bound
# at the fp32 rate.
PEAK_F32_3XTF32 = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12

# Tolerances: fp32 on both sides, sums taken in another order.
# B1: |delta| <= B1_REL * max|ref| + B1_ABS on the served artifact, and
# <= B1_REL * max|ref| alone on its quadratic term (c = v = b = 0), which
# the served scores hold only at ~1e-3 of their size at gamma = 1e-4.
B1_REL, B1_ABS, B1_ZSQ_REL = 1e-4, 1e-5, 1e-5
# B2: the K sums of 16384 terms cancel to ~1e-5 of their terms' size, so
# fp32 resolves them only to ~1e-4 absolute, and no tolerance relative to
# the output holds for either side. B2 may be at most B2_TWIN times as far
# from its fp32 twin as that twin is from the float64 answer, + B2_ABS.
B2_TWIN, B2_ABS = 4.0, 1e-6
MIN_AGREE_IN_ENVELOPE = 0.99
MAX_MODE_SHARE = 0.5  # reference labels must not be one class on most rows

# Second path: compile_model over every (family, dtype) candidate.
KERNEL_ROWS = (32, 1024)  # batch sizes the kernels are checked and timed at
FEATURES = (1024, 4096)  # fourier's default basis, and a wider one
# Mean |error| against the exact expansion within 5% of the mean |exact
# score| on the verification sample.
BUDGET = dict(max_err=0.05, metric="mean_abs", relative=True)
CELL_ROWS = (1, 1024)  # requests served through each (family, dtype) artifact
CELL_SCALED = (1, 16)  # rows of each pushed out of the envelope
# B3 is held to its twin as B1 is; its and the twin's distances from the
# twin in float64 on the same int8 codes are printed beside it (the card
# tests hold B3 to B2's rule there). B4/B5: the readout sums cancel as B2's
# do, so B2's rule: at most B45_TWIN times the f32 twin's distance from
# float64, + B45_ABS.
B45_TWIN, B45_ABS = 4.0, 1e-6

# Third path: K Gaussian classes at d=780 with means 3 N(0, I) apart (the
# reference suite's one-vs-rest recipe at the mnist width), LS-SVMs at
# gamma = 0.5 gamma_max(X) and reg_c = 10.
OVR_TRAIN, OVR_TEST = 8192, 2048
OVR_GAMMA_SHARE, OVR_REG_C = 0.5, 10.0
MIN_OVR_TRAIN_ACC = 0.9  # what the recipe reaches in the JAX suite
# The dual C-SVC: 4096 rows, 500 steps, C = 1, on make_dataset("mnist") at
# the spec gamma, and on class 0 against the rest of the OvR rows.
SVC_ROWS, SVC_STEPS, SVC_C = 4096, 500, 1.0
SVC_RTOL = SVC_ATOL = 1e-4  # compressed against dense decision values
# n_sv of the reference trainer (repro.svm.dual.train_svc) on the mnist
# task, from scripts/svc_reference_count.py: at gamma 1e-4 the kernel is
# nearly constant over these rows and every row stays a support vector.
SVC_MNIST_N_SV = 4096
FF_FEATURES = (4096, 1024)  # Fastfood basis served, and the default
# B6/B7: B4's rule, at most FF_TWIN times the twin's distance from float64.
FF_TWIN, FF_ABS = 4.0, 1e-6

# Fourth path: the LM side at full width, weights random from SEED.
LM_NAME = "smollm-135m"
LM_B, LM_T = 4, 2048  # prefill batch and tokens
LM_ATTN = (LM_B * 9, LM_T, 64, 64)  # (B*Hq, T, hd, hd) that B8/B9 see in prefill
ATTN_CASES = (  # (kernel, case, (bh, t, d, dv), dtype)
    ("flash_attention", "model bf16", LM_ATTN, "bfloat16"),
    ("flash_attention", "model f32", LM_ATTN, "float32"),
    ("maclaurin_attention", "model", LM_ATTN, "float32"),
    ("flash_attention", "ragged bf16", (LM_B * 9, 2000, 64, 64), "bfloat16"),
    ("flash_attention", "ragged f32", (LM_B * 9, 2000, 64, 64), "float32"),
    ("maclaurin_attention", "ragged", (LM_B * 9, 2000, 64, 64), "float32"),
    ("maclaurin_attention", "hd128", (8, 1024, 128, 128), "float32"),  # S2 8 MB a head
    # past T ~ 2 d dv, where the moments' count is ~6.8x below the quadratic
    # form's, yet the quadratic route is faster; and where the moments route is
    ("maclaurin_attention", "d16", (8, 4096, 16, 16), "float32"),
    ("maclaurin_attention", "long d16", (64, 8192, 16, 16), "float32"),
)
# ``--route-sweep``: B8's routes timed apart at these head counts and T.
SWEEP_HEADS = (1, 4, 16, 64, 256)
SWEEP_T = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
SWEEP_MS = 100.0
# B8/B9: at most ATTN_TWIN times the twin's distance from the float64
# quadratic-form oracle, + ATTN_ABS. B9 in bf16 is also held element by
# element against the twin's f32 value before rounding (the twin on the same
# inputs widened to f32, as the kernel widens them): the kernel rounds a
# value within the f32 rule's tolerance ``tol32`` of it, so each element may
# differ by half a bf16 step of itself, BF16_HALF_STEP |x|, + (1 +
# BF16_HALF_STEP) tol32. A control (the twin with the first key tile dropped
# for every later row) must fail that check.
ATTN_TWIN, ATTN_ABS = 4.0, 1e-6
BF16_HALF_STEP = 2.0**-8
# Logits against a reference run of the same weights, |delta| <= REL *
# max|ref logit|, each REL about twice the reading on an H100 80GB HBM3 at
# 700 W (chip_smoke.py's lm_prefill and lm_consistency lines): flash against
# blockwise prefill in bf16 0.0197 (each layer's attention differs by bf16
# rounding: blockwise rounds its softmax weights, flash keeps them f32); an
# f32 decode's bf16 KV cache against its f32 one 0.0068; the int8 KV cache
# against the bf16 one 0.0206. Top-1 must also agree wherever the
# reference's top-2 gap exceeds GAP * max|ref logit|, a fixed share above
# twice the reading (so no such position may flip at the measured error) and
# below twice REL (so the check is not implied by the max one). The
# maclaurin backend, another attention function, is the control: its logits
# must be further than every REL from the softmax ones.
PREFILL_REL, PREFILL_GAP = 0.04, 0.0625
BF16_CACHE_REL, BF16_CACHE_GAP = 0.015, 0.02
INT8_CACHE_REL, INT8_CACHE_GAP = 0.045, 0.06
CONS_B, CONS_T, GEN_STEPS = 2, 1024, 32  # f32 decode batch, prompt, generation
# Decode against the forward: the reference's own tolerance
# (tests/test_models.py:72-74), elementwise |delta| <= atol + rtol |ref|.
CONS_RTOL = CONS_ATOL = 2e-2

# Fifth path: the serving runtime. Deferred sync: a DEFER_ROWS-row submit
# behind ~DEFER_QUEUED_MS of B2 must return to the host before that work
# ends; DEFER_SUBMITS submits back to back cycle every staging buffer.
DEFER_ROWS, DEFER_QUEUED_MS, DEFER_REPEATS, DEFER_SUBMITS = 1024, 20.0, 5, 9
RT_OPTS = dict(min_bucket=32, max_batch=1024)
RT_WAIT_US = 500.0  # a lone request waits at most this long for company
RT_CLIENTS, RT_REQUESTS, RT_MAX_ROWS = 8, 40, 8  # clients x requests of 1-8 rows
RT_TOL = 2e-4  # coalesced against direct: rtol, and atol x max|score|
RT_QUEUE_ROWS = 256  # the admission bound
RT_BURST = (4, 40, 8)  # overload: threads x requests x rows, past the bound
RT_SLOW_STEP_S = 0.02  # the service time the fault injector pins in the burst
RT_BREAKER = dict(fail_threshold=3, reset_after_s=0.3)
# Drift: path 1's model scores b alone beyond its envelope (1/(16 gamma^2 msq)
# is ~2000x its rows' |z|^2 at the paper's gamma), so no family can heal a
# drift there. The drift act serves its own model at the same width: path
# 3's 10 Gaussian classes, DRIFT_N_SV SVs with each head's alpha the class
# indicator less its mean, gamma at DRIFT_GAMMA_SHARE of gamma_max (the
# envelope just covers the SVs); rows scaled by DRIFT_SCALE leave it. The
# heal's budget and basis are examples/svm_runtime.py's.
DRIFT_N_SV, DRIFT_GAMMA_SHARE, DRIFT_SCALE, DRIFT_ROWS = 16384, 0.8, 1.5, 512
DRIFT_BUDGET = dict(max_err=0.2, metric="mean_abs", relative=True)
DRIFT_FEATURES, DRIFT_THRESHOLD, DRIFT_AGREEMENT = 4096, 0.25, 0.9


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def phase(name: str, **fields) -> None:
    print(f"{name}: {json.dumps(fields, sort_keys=True)}", flush=True)


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 20) -> float:
    """Time of one call when the card, not the host, sets the pace: CUDA
    events around ``calls`` calls queued behind a kernel that spins for
    ~50 ms, so that no launch waits on the host. Where a call's kernels
    take less time than the host takes to launch them, ``time_ms`` reads
    the host's rate and this the card's (the card's own gaps between
    kernels included). No profiler: once started, ``torch.profiler`` slows
    every later launch of the process."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # clock cycles: ~50 ms, while the calls queue up
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_ms(fn, calls: int = 20) -> float:
    """Host time of one call, up to its return (no synchronize): the rate
    at which the host can launch it."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two rates sets it
    (operations at ``peak``, fp32 unless stated)."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def quadform_work(n: int, k: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of kernel B1: the K quadratic forms, the linear terms,
    |z|^2 and the epilogue; each input read once, each output written once."""
    flops = 2.0 * n * k * d * d + 2.0 * n * k * d + 2.0 * n * d + 6.0 * n * k
    nbytes = 4.0 * (n * d + k * d * d + k * d + 4 * k) + 4.0 * n * k + 4.0 * n + n * k
    return flops, nbytes


def rbf_work(n: int, m: int, k: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of kernel B2: the distance products, both row norms,
    5 operations per distance (add, subtract, clamp, scale, exp) and the K
    accumulations."""
    flops = 2.0 * n * m * d + 2.0 * (n + m) * d + 5.0 * n * m + 2.0 * n * m * k
    nbytes = 4.0 * (n * d + m * d + k * m + k + 1) + 4.0 * n * k
    return flops, nbytes


def quadform_q8_work(n: int, k: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of kernel B3: B1's work plus one scale multiply per
    (row, head, column), with the Hessian at 1 byte and the (K, d)
    column scales read once."""
    flops, _ = quadform_work(n, k, d)
    flops += 1.0 * n * k * d
    nbytes = 4.0 * (n * d + k * d + k * d + 4 * k) + 1.0 * k * d * d
    nbytes += 4.0 * n * k + 4.0 * n + n * k
    return flops, nbytes


def rff_work(n: int, f: int, k: int, d: int, w_bytes: int) -> tuple[float, float]:
    """(flops, bytes) of kernels B4 (``w_bytes`` 4) and B5 (1): the
    projection, one cos per (row, feature), the readout and the bias; W
    and the readout at ``w_bytes`` a value, B5's row and head scales f32."""
    flops = 2.0 * n * f * d + 2.0 * n * f * k + 1.0 * n * f + 1.0 * n * k
    nbytes = 4.0 * (n * d + f + k + n * k) + w_bytes * (f * d + k * f)
    if w_bytes == 1:
        nbytes += 4.0 * (f + k)
    return flops, nbytes


def fastfood_work(
    n: int, f: int, k: int, d: int, w_bytes: int
) -> tuple[float, float, float]:
    """(fp32 flops, f32-product flops, bytes) of kernels B6 (``w_bytes`` 4)
    and B7 (1). fp32: per row and stack two transforms of d' log2 d' adds,
    the three diagonals, the phase add and the cos (the gather is a move,
    not an operation), the bias (B7: the stack and head scales too).
    Products: the readout's 2 n F K, bound at the 3xTF32 rate. Bytes: Z, the
    O(F) operators (perm and phase 4 bytes in B6, 2 in B7), the readout, the
    scales and the output."""
    dd = 1 << max(1, (d - 1).bit_length())
    per_elem = 2.0 * (dd.bit_length() - 1) + 3.0 + 2.0
    flops = n * f * per_elem + 1.0 * n * k
    products = 2.0 * n * f * k
    small = 4 if w_bytes == 4 else 2
    nbytes = 4.0 * (n * d + k + n * k) + f * (3 * w_bytes + 2 * small) + w_bytes * k * f
    if w_bytes == 1:
        flops += 1.0 * n * f + 1.0 * n * k
        nbytes += 4.0 * (f // dd + k)
    return flops, products, nbytes


def fastfood_bound(n: int, f: int, k: int, d: int, w_bytes: int) -> tuple[float, str]:
    """B6/B7's least time in ms: their fp32 work at the fp32 rate plus their
    readout's products at the 3xTF32 rate, or their bytes, whichever is
    longer."""
    flops, products, nbytes = fastfood_work(n, f, k, d, w_bytes)
    t_ops = (flops / PEAK_FP32_FLOPS + products / PEAK_F32_3XTF32) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_work(bh: int, t: int, d: int, dv: int, nbytes_per: int) -> tuple[float, float]:
    """(flops, bytes) of kernel B9, causal: for each (row, key) pair on or
    below the diagonal, the q.k product (2d), p.v (2dv) and four
    elementwise operations (scale, subtract, exp, add); q, k, v read once
    and the output written once at ``nbytes_per`` a value."""
    pairs = bh * t * (t + 1) / 2.0
    flops = pairs * (2.0 * d + 2.0 * dv + 4.0)
    nbytes = nbytes_per * bh * t * (2.0 * d + 2.0 * dv)
    return flops, nbytes


def maclaurin_work(bh: int, t: int, d: int, dv: int, chunk: int) -> tuple[float, float]:
    """(flops, bytes) of the function kernel B8 computes: the smaller of two
    ways to the same sums. The chunked moments, as the reference kernel
    computes them: per query phi2(q) (d^2), the readout phi2(q).S2 and
    phi2(q).k2 (2 d^2 (dv + 1)), q.S1 and q.k1 (2 d (dv + 1)), and the sums
    (2 dv + 6); per key of every chunk but the last phi2(k) (d^2), S2 and
    k2 (2 d^2 (dv + 1)), S1 and k1 (2 d (dv + 1)), v0 (dv); per (row, key)
    pair of a chunk on or below the diagonal q.k (2d), w(u) (4) and w v plus
    the row sum (2 dv + 2). The causal quadratic form: that last count over
    every pair on or below the diagonal, the smaller below T ~ 2 d dv. The
    inputs are f32 (the reference casts them), read once; the output is
    written once."""
    per_q = d * d + 2.0 * d * d * (dv + 1) + 2.0 * d * (dv + 1) + 2.0 * dv + 6.0
    folded = min(t, (t - 1) // chunk * chunk)  # keys of every chunk but the last
    per_k = d * d + 2.0 * d * d * (dv + 1) + 2.0 * d * (dv + 1) + dv
    pairs = 0.0
    for c0 in range(0, t, chunk):
        n = min(chunk, t - c0)
        pairs += n * (n + 1) / 2.0
    per_pair = 2.0 * d + 2.0 * dv + 6.0
    chunked = bh * (t * per_q + folded * per_k + pairs * per_pair)
    quadratic = bh * t * (t + 1) / 2.0 * per_pair
    nbytes = 4.0 * bh * t * (2.0 * d + 2.0 * dv)
    return min(chunked, quadratic), nbytes


def kernel_args(art):
    """(plain twin, kernel wrapper, operands after Z) of the kernel that
    serves ``art``, for every family, projection and dtype."""
    from repro_torch.core.families import maclaurin
    from repro_torch.kernels.fwht import kernel as ff
    from repro_torch.kernels.quadform import kernel as qf
    from repro_torch.kernels.rff_score import kernel as rk

    a = art.arrays
    q8 = art.dtype == "int8"
    if art.meta["kind"] == "quadform":
        rest = (a["c"], a["b"], a["gamma"], a["msq"])
        if not q8:
            args = (a["M"], a["v"]) + rest
            return qf.quadform_heads_torch, qf.quadform_heads_cuda, args
        args = (a["M"], *maclaurin.q8_operands(art)) + rest
        return qf.quadform_heads_q8_torch, qf.quadform_heads_q8_cuda, args
    if art.meta["projection"] == "fastfood":
        ops = (a["ff_b"], a["ff_g"], a["ff_perm"], a["ff_scale"])
        if not q8:
            args = ops + (a["phase"], a["weights"], a["b"])
            return ff.fastfood_score_torch, ff.fastfood_score_cuda, args
        args = ops + (a["ff_stack_scale"], a["phase"], a["weights"])
        args += (a["weights_scale"], a["b"])
        return ff.fastfood_score_q8_torch, ff.fastfood_score_q8_cuda, args
    if not q8:
        args = (a["W"], a["phase"], a["weights"], a["b"])
        return rk.rff_score_torch, rk.rff_score_cuda, args
    args = (a["W"], a["W_scale"], a["phase"], a["weights"], a["weights_scale"])
    return rk.rff_score_q8_torch, rk.rff_score_q8_cuda, args + (a["b"],)


def twin_tol(twin, args, Zd, ratio: float, floor: float):
    """(twin scores, kernel tolerance, twin's distance from float64) for a
    fourier kernel: ``ratio`` times the twin's distance from its float64
    evaluation, + ``floor``; its readout sums cancel, so no tolerance
    relative to the output holds."""
    import torch

    out0 = twin(Zd, *args)
    d64 = [a if a.dtype == torch.int8 else a.double() for a in args]
    twin_err = max_err(out0, twin(Zd.double(), *d64))
    return out0, ratio * twin_err + floor, twin_err


def plain_scores(art, Zd):
    """The plain twin of ``art``'s kernel on the card: (scores, kernel
    tolerance)."""
    twin, _, args = kernel_args(art)
    if art.meta["kind"] == "quadform":
        s0 = twin(Zd, *args)[0]
        return s0, B1_REL * float(s0.abs().max()) + B1_ABS
    if art.meta["projection"] == "fastfood":
        return twin_tol(twin, args, Zd, FF_TWIN, FF_ABS)[:2]
    return twin_tol(twin, args, Zd, B45_TWIN, B45_ABS)[:2]


def exact64(model, dev):
    """``fn(Z) -> (float64 scores, B2 tolerance)`` for ``model``'s exact
    expansion on the rows of the numpy array ``Z``: the plain twin in
    float64, and B2_TWIN times the fp32 twin's distance from it + B2_ABS."""
    import torch

    from repro_torch.kernels.rbf_pred import kernel as rp

    X64, A64, b64 = model.X.double(), model.alpha_y.double(), model.b.double()
    g64 = float(model.gamma)

    def fn(Z):
        Zd = torch.from_numpy(Z).to(dev)
        ref = rp.rbf_scores_torch(Zd.double(), X64, A64, g64, b64)
        twin = rp.rbf_scores_torch(Zd, model.X, model.alpha_y, model.gamma, model.b)
        return ref.cpu().numpy(), B2_TWIN * max_err(twin, ref) + B2_ABS

    return fn


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt())


def median_request_ms(engine, Z, repeats: int = 10) -> float:
    """Median host time of ``engine.submit(Z)`` through labels on the host."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        engine.submit(Z).labels
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_kernel_times(timings: dict) -> None:
    """One ``kernel_time`` line per (kernel, n, F) entry of ``timings``."""
    for (name, n, f), t in timings.items():
        bound_ms, bound_by = t["bound"]
        times = {k: v for k, v in t.items() if k.endswith("_ms") or k == "ms"}
        phase(
            "kernel_time",
            kernel=name,
            n=n,
            f=f,
            bound_ms=bound_ms,
            bound_by=bound_by,
            **times,
        )


def check_fourier_kernel(phase_name, launch, twin, args, Z, ratio, floor, **fields):
    """Hold a fourier kernel's wrapper ``launch`` (B4-B7) against its plain
    twin on ``Z``: max|Δ| within ``ratio`` times the twin's distance from
    float64 + ``floor``, and the same bits on a second launch. Prints the
    phase line and returns its results."""
    import torch

    out = launch(Z, *args)
    again = launch(Z, *args)
    out0, tol, twin_err = twin_tol(twin, args, Z, ratio, floor)
    torch.cuda.synchronize()
    err = max_err(out, out0)
    res = dict(
        max_abs_err=err,
        twin_max_abs_err_vs_float64=twin_err,
        tol=tol,
        max_abs_ref=float(out0.abs().max()),
        same_bits_again=bool(torch.equal(again, out)),
    )
    phase(phase_name, **fields, **res)
    what = " ".join(f"{k}={v}" for k, v in fields.items())
    check(err <= tol, f"{what}: {err} > {tol}")
    check(res["same_bits_again"], f"{what}: bits differ run to run")
    return res


def push_out(Z, msq: float, gamma: float):
    """Scale each row of ``Z`` to msq * |z|^2 = OUTSIDE / (16 gamma^2)."""
    zsq = (Z.astype(np.float64) ** 2).sum(1, keepdims=True)
    target = OUTSIDE * 0.0625 / (gamma * gamma * msq)
    return (Z * np.sqrt(target / zsq)).astype(np.float32)


_FUNCTION = re.compile(r"Function : (\S+)")
_OPCODE = re.compile(r"\b((?:HGMMA|HMMA|LDSM|LDGSTS)\.?[\w.]*)")
_USAGE = re.compile(r"Function ([^\s:]+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)")


def read_compiled(sass: str, usage: str) -> dict[str, dict]:
    """Per function of a ``cuobjdump -sass`` listing, the count of each
    tensor-core MMA (HMMA, HGMMA), ldmatrix (LDSM) and cp.async (LDGSTS)
    opcode; with its registers and its stack and local bytes (spills) from
    the ``cuobjdump -res-usage`` text."""
    kernels: dict[str, dict] = {}
    current = None
    for line in sass.splitlines():
        if m := _FUNCTION.search(line):
            current = kernels.setdefault(m.group(1), {}).setdefault("sass", {})
        elif current is not None:
            for op in _OPCODE.findall(line):
                current[op] = current.get(op, 0) + 1
    for name, regs, stack, local in _USAGE.findall(usage):
        kernels.setdefault(name, {}).update(
            registers=int(regs), stack_bytes=int(stack), local_bytes=int(local)
        )
    return kernels


# Per library: the name fragment of every function whose products must run
# on the tensor cores, of those that must not (none is left since B3 joined
# B1's template), and whether the tensor-core bodies must have no stack or
# local memory (B1/B3, B4/B5, B6/B7: every d' instantiation).
TENSOR_CORE_BODIES = {
    "fastfood-": ("fastfood_tile", None, True),
    "flash_attn-": ("attn_fwd", None, False),
    "maclaurin_attn-": ("attn_fwd", None, False),
    "quadform-": ("quadform_tf32", None, True),
    "rbf_pred-": ("rbf_tf32", None, False),
    "rff_score-": ("rff_tf32", None, True),
}


def compiled_bodies(
    lib: Path, cuobjdump: Path, mma_in: str, simt: str | None, spill_free: bool = False
) -> dict:
    """What nvcc made of a built library's kernel bodies (``read_compiled``)
    whose names hold ``mma_in`` or ``simt``; fails unless each ``mma_in``
    instantiation runs its products on the tensor cores (with ``spill_free``,
    with no stack or local bytes) and each ``simt`` one holds no tensor-core
    MMA."""
    sass, usage = (
        subprocess.run([str(cuobjdump), flag, str(lib)], capture_output=True, text=True, check=True).stdout
        for flag in ("-sass", "-res-usage")
    )
    found = read_compiled(sass, usage)
    bodies = {n: k for n, k in found.items() if mma_in in n or (simt and simt in n)}
    check(any(mma_in in n for n in bodies), f"{lib.name}: no {mma_in} instantiation in the SASS")
    for name, k in bodies.items():
        mma = sum(c for op, c in k.get("sass", {}).items() if "MMA" in op)
        if mma_in in name:
            check(mma > 0, f"{lib.name}: {name} holds no tensor-core MMA")
            if spill_free:
                spill = k.get("stack_bytes", 0) + k.get("local_bytes", 0)
                check(spill == 0, f"{lib.name}: {name} has {spill} stack/local bytes")
        else:
            check(mma == 0, f"{lib.name}: {name} holds a tensor-core MMA")
    return bodies


def route_sweep(dev, out_path: Path) -> None:
    """Time kernel B8's two routes apart (``force_route``) over head counts,
    lengths and widths, into ``out_path`` as JSON lines: the measurements
    ``maclaurin_attn.route``'s cost model is fitted to. Each (route, width,
    heads) series runs T upward until one call passes SWEEP_MS."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.maclaurin_attn import kernel as ma

    build.build_all(["maclaurin_attn.cu"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    widths = [(d, d) for d in ma.HEAD_DIMS] + [(16, 64), (32, 20), (64, 24), (64, 160), (128, 64)]
    with open(out_path, "w") as f:
        for d, dv in widths:
            for bh in SWEEP_HEADS:
                for taken in ma.ROUTES:
                    for t in SWEEP_T:
                        if 4 * bh * t * (2 * d + 2 * dv) > 8e9:
                            break
                        q, k = (torch.randn((bh, t, d), generator=gen, device=dev) for _ in range(2))
                        v = torch.randn((bh, t, dv), generator=gen, device=dev)
                        launch = lambda: ma.maclaurin_attention_cuda(q, k, v, force_route=taken)  # noqa: E731
                        once = time_ms(launch, iters=1, warm=1)
                        iters = max(1, min(10, int(SWEEP_MS / 2 / max(once, 1e-3))))
                        ms = time_ms(launch, iters=iters, warm=0) if iters > 1 else once
                        row = dict(route=taken, bh=bh, t=t, d=d, dv=dv, ms=ms)
                        f.write(json.dumps(row) + "\n")
                        phase("route_sweep", **row)
                        del q, k, v
                        if once > SWEEP_MS:
                            break
    torch.cuda.empty_cache()


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--route-sweep"]:
        route_sweep(torch.device("cuda"), Path(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--submit-deferral"]:
        from repro_torch.core import families
        from repro_torch.kernels import build
        from repro_torch.serve import SVMEngine

        dev = torch.device("cuda")
        print(card_line(), flush=True)
        build.build_all(["quadform.cu", "rbf_pred.cu"])
        svm, X_te, _, _ = smoke_model(dev)
        engine = SVMEngine(families.maclaurin.compile(svm), svm, device=dev)
        phase("submit_deferral", **submit_deferral(dev, engine, svm, X_te))
        return 0
    card = card_line()
    kernels = run(torch.device("cuda"))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


def smoke_model(dev, n_sv: int = N_SV):
    """The random mnist-width model of paths 1, 2 and 5: (svm, test rows,
    dataset spec, the generator its ``alpha_y`` was drawn from)."""
    from repro_torch import convert
    from repro_torch.data.synthetic import make_dataset

    X_tr, _, X_te, _, spec = make_dataset("mnist", scale=0.3, seed=SEED)
    rng = np.random.default_rng(SEED)
    X = X_tr[:n_sv]
    alpha_y = rng.standard_normal((K, n_sv))
    alpha_y = (alpha_y - alpha_y.mean(1, keepdims=True)).astype(np.float32)
    gamma = np.float32(spec.paper_gamma)
    sv_sq = (X.astype(np.float64) ** 2).sum(1)
    b = -(alpha_y.astype(np.float64) @ np.exp(-float(gamma) * sv_sq))
    svm = convert.svm_from_numpy(X, alpha_y, b.astype(np.float32), gamma, device=dev)
    return svm, X_te, spec, rng


def submit_deferral(dev, engine, svm, X_te) -> dict:
    """Deferred sync, held on the card: the host return of
    ``engine.submit`` for DEFER_ROWS rows queued behind ~DEFER_QUEUED_MS
    of kernel B2 (n=256 against the model's SVs), beside that queued work's
    device time and, as the control, the host return of a blocking copy
    of the same rows from pageable memory behind the same work. Then
    DEFER_SUBMITS submits of different rows back to back behind queued
    work, each result held bit for bit against the same rows submitted
    with nothing queued (a staging buffer reused while its copy is pending
    would corrupt one). Median of DEFER_REPEATS for each time."""
    import torch

    from repro_torch.kernels.rbf_pred import kernel as rp

    Zr = torch.from_numpy(X_te[:256].copy()).to(dev)
    X, A, g, bias = svm.X, svm.alpha_y, svm.gamma, svm.b
    one = time_ms(lambda: rp.rbf_scores_cuda(Zr, X, A, g, bias), iters=5)
    calls = max(1, round(DEFER_QUEUED_MS / one))
    Zs = np.ascontiguousarray(X_te[:DEFER_ROWS])
    engine.submit(Zs).labels  # warm: the bucket's config, staging buffers

    def behind_queued(fn):
        """(host ms of fn(), device ms of the work queued before it)."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        mid = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            rp.rbf_scores_cuda(Zr, X, A, g, bias)
        mid.record()
        t0 = time.perf_counter()
        out = fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return host, start.elapsed_time(mid), out

    submit, queued, pageable = [], [], []
    for _ in range(DEFER_REPEATS):
        h, q, r = behind_queued(lambda: engine.submit(Zs))
        r.labels
        submit.append(h)
        queued.append(q)
        pageable.append(behind_queued(lambda: torch.from_numpy(Zs).to(dev))[0])
    sets = [X_te[i : i + DEFER_ROWS].copy() for i in range(DEFER_SUBMITS)]
    want = [engine.submit(Zi).values for Zi in sets]
    got = behind_queued(lambda: [engine.submit(Zi) for Zi in sets])[2]
    equal = all(np.array_equal(r.values, w) for r, w in zip(got, want))
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return dict(
        rows=DEFER_ROWS,
        queued_b2_launches=calls,
        submit_host_ms=med(submit),
        device_ms=med(queued),
        pageable_copy_host_ms=med(pageable),
        submits_behind_queue=DEFER_SUBMITS,
        results_equal_unqueued=equal,
    )


def run_threads(target, args) -> None:
    """``target(*a)`` on one thread per entry of ``args``; fails the phase
    if any raised or is still running after 300 s."""
    import threading

    errors = []

    def body(*a):
        try:
            target(*a)
        except BaseException as e:  # surfaced after the join
            errors.append(e)

    threads = [threading.Thread(target=body, args=a) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    if errors:
        raise errors[0]


def read(result) -> tuple:
    """(values, valid, labels) of an engine or runtime result, on the host."""
    return result.values, result.valid, result.labels


def nearest_rank(xs, q: float) -> float:
    """The q-th percentile of the sorted ``xs``, nearest rank (as the
    runtime's telemetry takes it)."""
    return xs[min(len(xs) - 1, max(0, int(np.ceil(q / 100 * len(xs))) - 1))]


def drift_model(dev):
    """The drift act's model and rows (see DRIFT_*): (svm, in-distribution
    rows, the same rows scaled out of the envelope)."""
    import torch

    from repro_torch import convert
    from repro_torch.core.bounds import gamma_max

    rng = np.random.default_rng(SEED + 3)
    mus = rng.standard_normal((K, 780)) * 3
    y = np.arange(DRIFT_N_SV + DRIFT_ROWS) % K
    X_all = (rng.standard_normal((len(y), 780)) + mus[y]).astype(np.float32)
    X, Z = X_all[:DRIFT_N_SV], X_all[DRIFT_N_SV:]
    ay = (y[None, :DRIFT_N_SV] == np.arange(K)[:, None]) - 1.0 / K
    ay = (ay / (DRIFT_N_SV / K)).astype(np.float32)
    gamma = DRIFT_GAMMA_SHARE * float(gamma_max(torch.from_numpy(X)))
    svm = convert.svm_from_numpy(X, ay, np.zeros(K, np.float32), gamma, device=dev)
    return svm, Z, (Z * DRIFT_SCALE).astype(np.float32)


def fifth_path(dev, svm, mac, X_te, requests, exact):
    """The serving runtime (``repro_torch.serve.runtime``) on the card, in
    the acts of ``examples/svm_runtime.py``: deferred sync held on the
    card; publish and coalesce (two tenants, 8 clients, each request held
    against its artifact's direct ``SVMEngine.submit``); overload; the
    breaker degrading to B2; drift healed by ``DriftGuard``; a profile.

    ``mac`` is path 1's f32 maclaurin artifact, ``requests`` its
    (rows, pushed-out mask) list, ``exact`` its float64 reference. Returns
    every kernel's launches on this path (read after the deferred-sync
    check, which launches B2 directly) and the path's numbers.
    """
    import json as _json
    import threading

    import torch

    from repro_torch.core.families import Budget, maclaurin
    from repro_torch.kernels import build
    from repro_torch.serve import (
        DriftGuard,
        FaultInjector,
        PublishSpec,
        Runtime,
        RuntimeOverloaded,
        SVMEngine,
    )
    from repro_torch.serve.runtime import ENGINE_STEP, InjectedFault

    seconds, out = {}, {}
    t0 = time.perf_counter()
    arts = {"mnist-f32": mac, "mnist-int8": maclaurin.quantize_quadform_artifact(mac)}
    direct = {a: SVMEngine(art, svm, device=dev, **RT_OPTS) for a, art in arts.items()}
    for engine in direct.values():
        engine.warmup()

    # ----------------------------------------------- deferred sync (F4)
    defer = submit_deferral(dev, direct["mnist-f32"], svm, X_te)
    phase("submit_deferral", **defer)
    check(defer["results_equal_unqueued"], "a submit behind queued work changed")
    check(
        defer["submit_host_ms"] < defer["device_ms"],
        f"submit waited for the work queued ahead of it: {defer}",
    )
    out["submit_deferral"] = defer
    seconds["submit_deferral"] = time.perf_counter() - t0

    build.reset_counts()
    faults = FaultInjector(seed=SEED, slow_step_s=RT_SLOW_STEP_S)
    rt = Runtime(
        engine_opts=dict(device=dev, **RT_OPTS),
        max_wait_us=RT_WAIT_US,
        max_queue_rows=RT_QUEUE_ROWS,
        breaker=dict(RT_BREAKER),
        fault_injector=faults,
    )
    try:
        # ------------------------------------- act 1: publish and coalesce
        t0 = time.perf_counter()
        cpu_arts = {a: art.to("cpu") for a, art in arts.items()}  # engines copy
        digests = {
            a: rt.publish(a, art, PublishSpec(exact=svm)) for a, art in cpu_arts.items()
        }
        again = rt.publish("mnist-f32", cpu_arts["mnist-f32"], PublishSpec(exact=svm))
        check(again == digests["mnist-f32"], "publishing the same artifact again")
        check(len(set(digests.values())) == 2, "the two tenants share a digest")
        check(digests["mnist-f32"] == mac.digest(), "the registry's digest")
        for a in arts:
            rt.warmup(a)
        engines = {a: rt.registry.get_engine(a)[1] for a in arts}
        configs = {a: e.stats.compiled_steps for a, e in engines.items()}

        pool = np.concatenate([Z for Z, _ in requests])
        rng = np.random.default_rng(SEED + 5)
        work = [
            [
                (
                    ("mnist-f32", "mnist-int8")[int(rng.integers(0, 2))],
                    rng.choice(len(pool), size=int(rng.integers(1, RT_MAX_ROWS + 1))),
                )
                for _ in range(RT_REQUESTS)
            ]
            for _ in range(RT_CLIENTS)
        ]
        want = [[read(direct[a].submit(pool[i])) for a, i in w] for w in work]

        def clients(fn):
            """Every client's requests through ``fn(alias, rows)``, one at a
            time per client: (results, per-request host ms, wall seconds)."""
            got = [[None] * RT_REQUESTS for _ in range(RT_CLIENTS)]
            lat, lock = [], threading.Lock()

            def client(c):
                for k, (a, idx) in enumerate(work[c]):
                    t = time.perf_counter()
                    got[c][k] = read(fn(a, pool[idx]))
                    with lock:
                        lat.append((time.perf_counter() - t) * 1e3)

            t = time.perf_counter()
            run_threads(client, [(c,) for c in range(RT_CLIENTS)])
            return got, sorted(lat), time.perf_counter() - t

        st0 = {a: rt.stats(a) for a in arts}
        got, lat, wall = clients(lambda a, Z: rt.submit(a, Z).result(timeout=60))
        _, lat_direct, wall_direct = clients(lambda a, Z: direct[a].submit(Z))
        st1 = {a: rt.stats(a) for a in arts}
        rows = sum(len(i) for w in work for _, i in w)
        worst, far_rows, far_labels = 0.0, [], []
        for c in range(RT_CLIENTS):
            for k, (a, idx) in enumerate(work[c]):
                (v, ok, lab), (v0, ok0, lab0) = got[c][k], want[c][k]
                scale = max(1.0, float(np.abs(v0).max()))
                tol = RT_TOL * scale + RT_TOL * np.abs(v0)
                ratio = float((np.abs(v - v0) / tol).max())
                worst = max(worst, ratio)
                check(ratio <= 1.0, f"client {c} request {k}: values, x{ratio} tol")
                check(bool((lab == lab0).all()), f"client {c} request {k}: labels")
                check(bool((ok == ok0).all()), f"client {c} request {k}: valid")
                far_rows.append(pool[idx][~ok])
                far_labels.append(lab[~ok])
        far_rows, far_labels = np.concatenate(far_rows), np.concatenate(far_labels)
        check(len(far_rows) > 0, "no request carried a row out of the envelope")
        far_agree = float((far_labels == exact(far_rows)[0].argmax(-1)).mean())
        check(far_agree == 1.0, f"fallback rows' labels against float64: {far_agree}")
        steps = sum(st1[a]["flushes"] - st0[a]["flushes"] for a in arts)
        reqs = sum(st1[a]["requests"] - st0[a]["requests"] for a in arts)
        recompiles = sum(engines[a].stats.compiled_steps - configs[a] for a in arts)
        act1 = dict(
            digests={a: d[:16] for a, d in digests.items()},
            requests=reqs,
            rows=rows,
            fallback_rows=int(len(far_rows)),
            fallback_label_agree=far_agree,
            engine_steps=steps,
            coalescing_factor=reqs / max(1, steps),
            p50_ms=nearest_rank(lat, 50),
            p99_ms=nearest_rank(lat, 99),
            rows_per_s=rows / wall,
            direct_p50_ms=nearest_rank(lat_direct, 50),
            direct_p99_ms=nearest_rank(lat_direct, 99),
            direct_rows_per_s=rows / wall_direct,
            max_err_over_tol=worst,
            steady_state_recompiles=recompiles,
        )
        # where a request's time goes, from the runtime's own spans: time
        # queued, the flush's host dispatch, dispatch start to the first read
        tracer = rt.obs.tracer
        for name in ("request.queue_wait", "engine.step", "flush.sync"):
            ms = sorted(
                (sp["t_end"] - sp["t_start"]) * 1e3
                for d in digests.values()
                for sp in tracer.spans(d[:12], name)
            )
            act1[f"{name}_p50_ms"] = nearest_rank(ms, 50)
            act1[f"{name}_p99_ms"] = nearest_rank(ms, 99)
        phase("runtime_coalesce", **act1)
        check(reqs == RT_CLIENTS * RT_REQUESTS, f"requests admitted: {reqs}")
        check(recompiles == 0, f"{recompiles} new bucket configs after warm-up")
        out["coalesce"] = act1

        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        rt.registry.evict("mnist-int8")
        del engines["mnist-int8"]
        torch.cuda.synchronize()
        freed = held - torch.cuda.memory_allocated()
        phase(
            "runtime_evict",
            memory_allocated_before=held,
            memory_allocated_after=held - freed,
            artifact_bytes=arts["mnist-int8"].nbytes(),
        )
        check(freed > 0, "evicting an engine released no card memory")
        seconds["coalesce"] = time.perf_counter() - t0

        # ------------------------------------------------- act 2: overload
        t0 = time.perf_counter()
        n_threads, n_req, n_rows = RT_BURST
        faults.slow_next(ENGINE_STEP, 1000)  # pin each flush's service time
        shed, admitted, lock = [], [], threading.Lock()
        burst = [
            [pool[rng.choice(len(pool), size=n_rows)] for _ in range(n_req)]
            for _ in range(n_threads)
        ]

        def bursty(batches):
            for Z in batches:
                try:
                    f = rt.submit("mnist-f32", Z)
                except RuntimeOverloaded as e:
                    with lock:
                        shed.append(e.retry_after_s)
                else:
                    with lock:
                        admitted.append(f)

        st0 = rt.stats("mnist-f32")
        run_threads(bursty, [(b,) for b in burst])
        for f in admitted:
            f.result(timeout=60).labels
        faults.clear_scripts(ENGINE_STEP)
        st = rt.stats("mnist-f32")
        act2 = dict(
            submitted=n_threads * n_req,
            admitted=len(admitted),
            shed=len(shed),
            telemetry_shed=st["shed_requests"] - st0["shed_requests"],
            telemetry_admitted=st["requests"] - st0["requests"],
            retry_after_ms_min=1e3 * min(shed, default=0.0),
            retry_after_ms_max=1e3 * max(shed, default=0.0),
            queue_rows=st["queue_rows"],
            queue_high_water_rows=st["max_queue_rows"],
        )
        phase("runtime_overload", **act2)
        check(len(shed) > 0, "the burst shed nothing")
        check(min(shed) > 0.0, "a shed without a retry_after")
        check(len(shed) + len(admitted) == act2["submitted"], "admitted + shed")
        check(act2["telemetry_shed"] == len(shed), "telemetry's shed count")
        check(act2["telemetry_admitted"] == len(admitted), "telemetry's admitted")
        check(st["queue_rows"] == 0, "the queue did not drain")
        out["overload"] = act2
        seconds["overload"] = time.perf_counter() - t0

        # -------------------------------------------------- act 3: breaker
        t0 = time.perf_counter()
        Zb = pool[rng.choice(len(pool), size=16, replace=False)]
        faults.fail_next(ENGINE_STEP, RT_BREAKER["fail_threshold"])
        failures = 0
        for _ in range(RT_BREAKER["fail_threshold"]):
            try:
                rt.predict("mnist-f32", Zb)
            except InjectedFault:
                failures += 1
        opened = rt.stats("mnist-f32")["breaker"]
        b2 = build.counts()["rbf_scores"]
        res = rt.submit("mnist-f32", Zb).result(timeout=60)
        vals, valid, labels = res.values, res.valid, res.labels
        b2 = build.counts()["rbf_scores"] - b2
        ref, tol = exact(Zb)
        top2 = np.sort(ref, -1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * tol
        time.sleep(RT_BREAKER["reset_after_s"] + 0.05)
        rt.predict("mnist-f32", Zb)  # the half-open probe
        st = rt.stats("mnist-f32")
        done = (
            st["served_requests"]
            + st["failed_requests"]
            + st["deadline_timeouts"]
            + st["closed_requests"]
        )
        act3 = dict(
            failures=failures,
            state_after_faults=opened["state"],
            trips=opened["trips"],
            degraded_rows=st["breaker"]["degraded_rows"],
            degraded_b2_launches=b2,
            degraded_max_abs_err=float(np.abs(vals - ref).max()),
            degraded_tol=tol,
            degraded_label_agree=float((labels == ref.argmax(-1))[decided].mean()),
            degraded_rows_tied_in_fp32=int((~decided).sum()),
            state_after_probe=st["breaker"]["state"],
            probes=st["breaker"]["probes"],
            admitted=st["requests"],
            served_failed_expired_closed=done,
        )
        phase("runtime_breaker", **act3)
        check(failures == RT_BREAKER["fail_threshold"], "injected faults")
        check(opened["state"] == "open", "the breaker did not open")
        check(b2 > 0, "the degraded request did not launch B2")
        check(not valid.any(), "a degraded row claims the fast path")
        check(act3["degraded_max_abs_err"] <= tol, "degraded values against float64")
        check(act3["degraded_label_agree"] == 1.0, "degraded labels against float64")
        check(st["breaker"]["state"] == "closed", "the probe did not close the breaker")
        check(done == st["requests"], f"served + failed + expired + closed: {act3}")
        out["breaker"] = act3
        seconds["breaker"] = time.perf_counter() - t0

        # ---------------------------------------------------- act 4: drift
        t0 = time.perf_counter()
        dsvm, Z_in, Z_drift = drift_model(dev)
        rt.publish("ovr", maclaurin.compile(dsvm).to("cpu"), PublishSpec(exact=dsvm))
        guard = DriftGuard(
            rt,
            "ovr",
            exact=dsvm,
            budget=Budget(**DRIFT_BUDGET),
            threshold=DRIFT_THRESHOLD,
            min_rows=64,
            min_agreement=DRIFT_AGREEMENT,
            seed=SEED,
            compile_opts={"family_opts": {"fourier": {"num_features": DRIFT_FEATURES}}},
        ).attach()
        old = rt.registry.resolve("ovr")
        for i in range(0, len(Z_in), 8):
            rt.submit("ovr", Z_in[i : i + 8]).result(timeout=60).labels
        calm = guard.fallback_rate()
        check(not guard.check()["triggered"], f"in-distribution traffic: {calm}")
        for i in range(0, len(Z_drift), 8):
            rt.submit("ovr", Z_drift[i : i + 8]).result(timeout=60).labels
        drifted = guard.fallback_rate()
        before = build.counts()
        t_heal = time.perf_counter()
        verdict = guard.check()
        heal_s = time.perf_counter() - t_heal
        heal_launches = {k: v - before[k] for k, v in build.counts().items()}
        for i in range(0, len(Z_drift), 8):
            rt.submit("ovr", Z_drift[i : i + 8]).result(timeout=60).labels
        healed = guard.fallback_rate()
        act4 = dict(
            model=f"{K} Gaussian classes at d=780, n_sv={DRIFT_N_SV}, class-mean alpha",
            window_in_distribution=calm,
            window_drifted=drifted,
            healed=verdict.get("healed"),
            family=verdict.get("family"),
            dtype=verdict.get("dtype"),
            agreement=verdict.get("agreement"),
            canary_rows=verdict.get("canary_rows"),
            reason=verdict.get("reason"),
            heal_s=heal_s,
            heal_launches=heal_launches,
            old_digest=old[:16],
            new_digest=rt.registry.resolve("ovr")[:16],
            window_after_flip=healed,
        )
        phase("runtime_drift", **act4)
        check(drifted["rate"] > DRIFT_THRESHOLD, f"the drift did not trip: {drifted}")
        check(bool(verdict.get("healed")), f"the heal failed: {verdict}")
        check(verdict["agreement"] >= DRIFT_AGREEMENT, "canary agreement")
        check(rt.registry.resolve("ovr") != old, "the alias did not flip")
        check(healed["rows"] > 0 and healed["rate"] == 0.0, f"after the flip: {healed}")
        for name in ("quadform_heads", "quadform_heads_q8", "rbf_scores"):
            check(heal_launches[name] > 0, f"the heal did not launch {name}")
        check(heal_launches["rff_score"] + heal_launches["rff_score_q8"] > 0, "B4/B5")
        out["drift"] = act4
        seconds["drift"] = time.perf_counter() - t0

        # ------------------------------------------ act 5: profile, last
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "step.json"
            rt.profile("mnist-f32", pool[:64], trace)
            events = _json.loads(trace.read_text())["traceEvents"]
            trace_bytes = trace.stat().st_size
        names = [e.get("name", "") for e in events]
        steps = sorted({n for n in names if n.startswith("svm_engine.step/")})
        b1 = sorted(set(re.findall(r"quadform_tf32<float[^>]*>", " ".join(names))))
        phase("runtime_profile", bytes=trace_bytes, events=len(events), steps=steps, b1=b1)
        check(any(n.startswith("svm_engine.step/maclaurin/") for n in steps), "the step")
        check(len(b1) > 0, "no launch of B1's symbol in the trace")
        seconds["profile"] = time.perf_counter() - t0
    finally:
        rt.close()
    launches = build.counts()
    phase("fifth_path_launches", **launches)
    for name in ("quadform_heads", "quadform_heads_q8", "rbf_scores"):
        check(launches[name] > 0, f"{name} never launched on the fifth path")
    phase("fifth_path_seconds", **seconds)
    return launches, out


def run(dev) -> list[dict]:
    """Every phase on ``dev``; returns the ``kernels`` entries."""
    import torch

    from repro_torch.core import families
    from repro_torch.core.families import CompiledArtifact
    from repro_torch.kernels import build
    from repro_torch.kernels.quadform import kernel as qf
    from repro_torch.kernels.rbf_pred import kernel as rp
    from repro_torch.serve import SVMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    libs = build.build_all()
    phase("build", seconds=time.perf_counter() - t0, libs=[p.name for p in libs])
    for lib in libs:
        for prefix, (mma_in, simt, spill_free) in TENSOR_CORE_BODIES.items():
            if lib.name.startswith(prefix):
                cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
                bodies = compiled_bodies(lib, cuobjdump, mma_in, simt, spill_free)
                phase("compiled", lib=lib.name, **bodies)

    # ------------------------------------------------------------ main path
    seconds = {}
    t_phase = time.perf_counter()
    svm, X_te, spec, rng = smoke_model(dev)
    gamma, b = np.float32(spec.paper_gamma), svm.b.cpu().numpy()

    t0 = time.perf_counter()
    art = families.maclaurin.compile(svm)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        loaded = CompiledArtifact.load(art.save(str(Path(tmp) / "mnist.npz")), dev)
    check(loaded.digest() == art.digest(), "save/load changed the artifact digest")
    engine = SVMEngine(loaded, svm, device=dev)
    engine.warmup(list(REQUEST_ROWS))
    msq = float(loaded.arrays["msq"].max())

    requests, off = [], 0
    for n, n_scaled in zip(REQUEST_ROWS, SCALED_ROWS):
        Z = X_te[off : off + n].copy()
        off += n
        scaled = np.zeros(n, bool)
        scaled[rng.choice(n, size=n_scaled, replace=False)] = True
        Z[scaled] = push_out(Z[scaled], msq, float(gamma))
        requests.append((Z, scaled))
    Z_exact = X_te[off : off + EXACT_ROWS]

    build.reset_counts()
    served, request_ms = [], []
    for Z, _ in requests:
        t0 = time.perf_counter()
        r = engine.submit(Z)
        served.append((r.values, r.valid, r.labels))
        request_ms.append((time.perf_counter() - t0) * 1e3)
    rx = engine.submit_exact(Z_exact)
    exact_served = (rx.values, rx.valid, rx.labels)
    launches = build.counts()

    # Reference: the exact model in float64 through the plain twin, and the
    # fp32 twin's distance from it, which sets B2's tolerance.
    exact = exact64(svm, dev)

    n_scaled_total = int(sum(s.sum() for _, s in requests))
    agree_in, agree_out, n_in = 0, 0, 0
    ref_in_labels, margins = [], []
    fallback_err, fallback_tol, fallback_scale = 0.0, np.inf, 0.0
    for (Z, scaled), (vals, valid, labels) in zip(requests, served):
        check(bool((valid == ~scaled).all()), "valid mask != rows inside the envelope")
        ref = exact(Z)[0]
        ref_labels = ref.argmax(-1)
        agree_in += int((labels[~scaled] == ref_labels[~scaled]).sum())
        agree_out += int((labels[scaled] == ref_labels[scaled]).sum())
        n_in += int((~scaled).sum())
        ref_in_labels.append(ref_labels[~scaled])
        top2 = np.sort(ref[~scaled], -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if scaled.any():
            tol = exact(Z[scaled])[1]
            err = float(np.abs(vals[scaled] - ref[scaled]).max())
            fallback_err = max(fallback_err, err)
            fallback_tol = min(fallback_tol, tol)
            fallback_scale = max(fallback_scale, float(np.abs(ref[scaled] - b).max()))
            check(err <= tol, f"fallback values: {err} > {tol}")
    ref_in_labels = np.concatenate(ref_in_labels)
    mode_share = np.bincount(ref_in_labels, minlength=K).max() / len(ref_in_labels)
    ref_x, exact_tol = exact(Z_exact)
    exact_err = float(np.abs(exact_served[0] - ref_x).max())
    # fp32 resolves B2's scores only to ~exact_tol: rows whose float64 top
    # two lie closer than twice that are ties to fp32, and their label is
    # not checked.
    top2 = np.sort(ref_x, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * exact_tol
    exact_agree = exact_served[2][decided] == ref_x.argmax(-1)[decided]
    stats = engine.stats.snapshot()
    phase(
        "main_path",
        compile_s=compile_s,
        digest=loaded.digest()[:16],
        request_rows=list(REQUEST_ROWS),
        request_ms=request_ms,
        fallback_rows=stats["fallback_instances"],
        scaled_rows=n_scaled_total,
        agree_in_envelope=agree_in / n_in,
        agree_fallback=agree_out / n_scaled_total,
        ref_labels_used=int(np.unique(ref_in_labels).size),
        ref_mode_share=float(mode_share),
        ref_min_top2_margin=float(np.concatenate(margins).min()),
        fallback_max_abs_err=fallback_err,
        fallback_tol=fallback_tol,
        fallback_max_abs_ref_minus_b=fallback_scale,
        submit_exact_max_abs_err=exact_err,
        submit_exact_tol=exact_tol,
        submit_exact_label_agree=float((exact_served[2] == ref_x.argmax(-1)).mean()),
        submit_exact_rows_tied_in_fp32=int((~decided).sum()),
        launches=launches,
        buckets=engine.jit_cache_size(),
    )
    check(stats["fallback_instances"] == n_scaled_total > 0, "fallback count")
    check(mode_share <= MAX_MODE_SHARE, "reference labels nearly constant")
    check(agree_in / n_in >= MIN_AGREE_IN_ENVELOPE, "label agreement in envelope")
    check(agree_out == n_scaled_total, "label agreement on fallback rows")
    check(exact_err <= exact_tol, f"submit_exact values: {exact_err} > {exact_tol}")
    check(bool(exact_agree.all()), "submit_exact labels on rows fp32 can decide")
    check(launches["quadform_heads"] > 0, "quadform_heads never launched")
    check(launches["rbf_scores"] > 0, "rbf_scores never launched")

    seconds["main_path"] = time.perf_counter() - t_phase

    # ------------------------------------------ kernels against plain twins
    t_phase = time.perf_counter()
    a = loaded.arrays
    heads = (a["M"], a["v"], a["c"], a["b"], a["gamma"], a["msq"])
    zero = torch.zeros_like(a["c"])
    quad_only = (a["M"], torch.zeros_like(a["v"]), zero, zero) + heads[4:]
    Zq = X_te[:1024].copy()
    Zq[::37] = push_out(Zq[::37], msq, float(gamma))  # both sides of the envelope
    Zq = torch.from_numpy(Zq).to(dev)
    b1 = {}
    for n in (32, 1024):
        cases = (("all", heads, B1_ABS), ("quad", quad_only, 0.0))
        for terms, args, abs_tol in cases:
            s, zsq, v = qf.quadform_heads_cuda(Zq[:n], *args)
            s0, zsq0, v0 = qf.quadform_heads_torch(Zq[:n], *args)
            again = qf.quadform_heads_cuda(Zq[:n], *args)
            torch.cuda.synchronize()
            err, scale = max_err(s, s0), float(s0.abs().max())
            tol = B1_REL * scale + abs_tol
            zsq_rel = float(((zsq - zsq0).abs() / zsq0.abs().clamp(min=1e-30)).max())
            res = dict(max_abs_err=err, max_abs_ref=scale, tol=tol, zsq_rel_err=zsq_rel)
            res["masks_equal"] = bool((v == v0).all())
            res["same_bits_again"] = all(torch.equal(x, y) for x, y in zip(again, (s, zsq, v)))
            phase(
                "kernel_check",
                kernel="quadform_heads",
                terms=terms,
                n=n,
                k=K,
                d=spec.d,
                **res,
            )
            what = f"quadform_heads n={n} terms={terms}"
            check(err <= tol, f"{what}: {err} > {tol}")
            check(zsq_rel <= B1_ZSQ_REL, f"{what}: |z|^2 rel {zsq_rel}")
            check(res["masks_equal"], f"{what}: masks differ")
            check(res["same_bits_again"], f"{what}: bits differ run to run")
            b1[n, terms] = res

    Zr = torch.from_numpy(X_te[:256].copy()).to(dev)
    Xd, Ad = svm.X, svm.alpha_y
    bd, gd = svm.b, svm.gamma
    b64 = svm.b.double()
    X64, A64 = svm.X.double(), svm.alpha_y.double()
    for n in (16, 256):  # a request's fallback rows (BN=32), and a full tile (BN=128)
        Zn = Zr[:n]
        out = rp.rbf_scores_cuda(Zn, Xd, Ad, gd, bd)
        again = rp.rbf_scores_cuda(Zn, Xd, Ad, gd, bd)
        out0 = rp.rbf_scores_torch(Zn, Xd, Ad, gd, bd)
        out64 = rp.rbf_scores_torch(Zn.double(), X64, A64, float(gamma), b64)
        torch.cuda.synchronize()
        err, twin_err = max_err(out, out0), max_err(out0, out64)
        tol = B2_TWIN * twin_err + B2_ABS
        same = bool(torch.equal(again, out))
        phase(
            "kernel_check",
            kernel="rbf_scores",
            n=n,
            m=N_SV,
            k=K,
            d=spec.d,
            max_abs_err=err,
            max_abs_err_vs_float64=max_err(out, out64),
            twin_max_abs_err_vs_float64=twin_err,
            rms_err_vs_float64=rms(out - out64),
            twin_rms_err_vs_float64=rms(out0 - out64),
            max_abs_ref_minus_b=float((out64 - b64).abs().max()),
            tol=tol,
            same_bits_again=same,
        )
        check(err <= tol, f"rbf_scores n={n}: {err} > {tol}")
        check(same, f"rbf_scores n={n}: bits differ run to run")
    b2_err = err  # n = 256

    seconds["kernel_check"] = time.perf_counter() - t_phase

    # --------------------------------------------------------------- timing
    t_phase = time.perf_counter()
    Zt = Zq[:1024]
    q_ms = time_ms(lambda: qf.quadform_heads_cuda(Zt, *heads))
    q_dev = device_ms(lambda: qf.quadform_heads_cuda(Zt, *heads))
    q_plain = time_ms(lambda: qf.quadform_heads_torch(Zt, *heads))
    q_lib = time_ms(lambda: torch.einsum("ni,kij,nj->nk", Zt, a["M"], Zt))
    q_bound, q_by = bound(*quadform_work(1024, K, spec.d), peak=PEAK_F32_3XTF32)
    Z32 = Zq[:32]
    q32 = time_ms(lambda: qf.quadform_heads_cuda(Z32, *heads))
    q32_plain = time_ms(lambda: qf.quadform_heads_torch(Z32, *heads))
    q32_lib = time_ms(lambda: torch.einsum("ni,kij,nj->nk", Z32, a["M"], Z32))
    q32_bound, q32_by = bound(*quadform_work(32, K, spec.d), peak=PEAK_F32_3XTF32)
    phase(
        "quadform_heads_n32",
        ms=q32,
        device_ms=device_ms(lambda: qf.quadform_heads_cuda(Z32, *heads)),
        host_ms=host_ms(lambda: qf.quadform_heads_cuda(Z32, *heads)),
        plain_ms=q32_plain,
        library_ms=q32_lib,
        bound_ms=q32_bound,
        bound_by=q32_by,
    )
    r_ms = time_ms(lambda: rp.rbf_scores_cuda(Zr, Xd, Ad, gd, bd))
    r_dev = device_ms(lambda: rp.rbf_scores_cuda(Zr, Xd, Ad, gd, bd))
    r_plain = time_ms(lambda: rp.rbf_scores_torch(Zr, Xd, Ad, gd, bd))
    r_lib = time_ms(lambda: torch.cdist(Zr, Xd))
    r_bound, r_by = bound(*rbf_work(256, N_SV, K, spec.d), peak=PEAK_F32_3XTF32)
    Z16 = Zr[:16]  # a request's fallback rows
    phase(
        "rbf_scores_n16",
        ms=time_ms(lambda: rp.rbf_scores_cuda(Z16, Xd, Ad, gd, bd)),
        device_ms=device_ms(lambda: rp.rbf_scores_cuda(Z16, Xd, Ad, gd, bd)),
        host_ms=host_ms(lambda: rp.rbf_scores_cuda(Z16, Xd, Ad, gd, bd)),
        plain_ms=time_ms(lambda: rp.rbf_scores_torch(Z16, Xd, Ad, gd, bd)),
        library_ms=time_ms(lambda: torch.cdist(Z16, Xd)),
    )

    # End to end after warmup: host clock around submit -> labels on host.
    e2e = {
        f"rows_{n}": median_request_ms(engine, Z)
        for (Z, _), n in zip(requests, REQUEST_ROWS)
    }
    phase("serve_median_ms", **e2e)
    seconds["timing"] = time.perf_counter() - t_phase
    phase("first_path_seconds", **seconds)

    # ================================================= second path (B3-B5)
    kernels_q8_rff, launches2 = second_path(
        dev, svm, loaded, X_te, Zq, exact, msq, float(gamma)
    )
    # ================================================== third path (B6, B7)
    kernels_ff, launches3 = third_path(dev)
    # =================================================== fourth path (B8, B9)
    kernels_lm, launches4 = fourth_path(dev)
    # ================================ fifth path (the runtime; a profile last)
    launches5, _ = fifth_path(dev, svm, loaded, X_te, requests, exact)
    per_path = {
        n: [launches[n], launches2[n], launches3[n], launches4[n], launches5[n]]
        for n in launches4
    }

    kernels = [
        {
            "name": "quadform_heads",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quadform.cu",
            "replaces": "src/repro/kernels/quadform/kernel.py:125",
            "launches": sum(per_path["quadform_heads"]),
            "launches_per_path": per_path["quadform_heads"],
            "max_abs_err": b1[1024, "all"]["max_abs_err"],
            "ms": q_ms,
            "device_ms": q_dev,
            "plain_ms": q_plain,
            "bound_ms": q_bound,
            "bound_by": q_by,
            "library_ms": q_lib,
        },
        {
            "name": "rbf_scores",
            "route": "cuda",
            "source": "src/repro_torch/csrc/rbf_pred.cu",
            "replaces": "src/repro/kernels/rbf_pred/kernel.py:114",
            "launches": sum(per_path["rbf_scores"]),
            "launches_per_path": per_path["rbf_scores"],
            "max_abs_err": b2_err,
            "ms": r_ms,
            "device_ms": r_dev,
            "plain_ms": r_plain,
            "bound_ms": r_bound,
            "bound_by": r_by,
            "library_ms": r_lib,
        },
    ]
    for entry in kernels + kernels_q8_rff + kernels_ff + kernels_lm:
        entry["launches"] = sum(per_path[entry["name"]])
        entry["launches_per_path"] = per_path[entry["name"]]
    return kernels + kernels_q8_rff + kernels_ff + kernels_lm


def second_path(dev, svm, mac, X_te, Zq, exact, msq: float, gamma: float):
    """``compile_model`` over every (family, dtype) and kernels B3-B5.

    ``mac`` is the first path's f32 maclaurin artifact, ``Zq`` its kernel
    check rows (both sides of the envelope), ``exact`` its float64
    reference. Returns (the B3-B5 ``kernels`` entries, every kernel's
    launches on this path's serving phases).
    """
    import torch

    from repro_torch.core import families
    from repro_torch.core.families import Budget, CompiledArtifact, compile_model
    from repro_torch.core.families import quantize
    from repro_torch.kernels import build
    from repro_torch.kernels.quadform import kernel as qf
    from repro_torch.serve import SVMEngine

    d = svm.X.shape[1]
    seconds = {}

    # ------------------------------------------------- B3 against its twin
    t0 = time.perf_counter()
    q8 = families.maclaurin.quantize_quadform_artifact(mac)
    _, _, q8_heads = kernel_args(q8)
    M_q, col, v_deq, _, _, g, m = q8_heads
    zero = torch.zeros_like(g)
    q8_quad = (M_q, col, torch.zeros_like(v_deq), zero, zero, g, m)
    b3 = {}
    for n in KERNEL_ROWS:
        cases = (("all", q8_heads, B1_ABS), ("quad", q8_quad, 0.0))
        for terms, args, abs_tol in cases:
            s, zsq, v = qf.quadform_heads_q8_cuda(Zq[:n], *args)
            s0, zsq0, v0 = qf.quadform_heads_q8_torch(Zq[:n], *args)
            d64 = [x if x.dtype == torch.int8 else x.double() for x in args]
            s64 = qf.quadform_heads_q8_torch(Zq[:n].double(), *d64)[0]  # the same codes
            again = qf.quadform_heads_q8_cuda(Zq[:n], *args)[0]
            torch.cuda.synchronize()
            err, scale = max_err(s, s0), float(s0.abs().max())
            tol = B1_REL * scale + abs_tol
            zsq_rel = float(((zsq - zsq0).abs() / zsq0.abs().clamp(min=1e-30)).max())
            res = dict(max_abs_err=err, max_abs_ref=scale, tol=tol, zsq_rel_err=zsq_rel)
            res["max_abs_err_vs_float64"] = max_err(s, s64)
            res["twin_max_abs_err_vs_float64"] = max_err(s0, s64)
            res["rms_err_vs_float64"] = rms(s.double() - s64)
            res["twin_rms_err_vs_float64"] = rms(s0.double() - s64)
            res["masks_equal"] = bool((v == v0).all())
            res["same_bits_again"] = bool(torch.equal(again, s))
            phase(
                "kernel_check_q8",
                kernel="quadform_heads_q8",
                terms=terms,
                n=n,
                k=K,
                d=d,
                **res,
            )
            what = f"quadform_heads_q8 n={n} terms={terms}"
            check(err <= tol, f"{what}: {err} > {tol}")
            check(zsq_rel <= B1_ZSQ_REL, f"{what}: |z|^2 rel {zsq_rel}")
            check(res["masks_equal"], f"{what}: masks differ")
            check(res["same_bits_again"], f"{what}: bits differ run to run")
            b3[n, terms] = res
    seconds["kernel_check_q8"] = time.perf_counter() - t0

    # ---------------------------------------------- B4/B5 against their twins
    t0 = time.perf_counter()
    rff_arts = {
        (f, dt): families.fourier.compile(svm, num_features=f, dtype=dt, seed=SEED)
        for f in FEATURES
        for dt in quantize.DTYPES
    }
    Zf = torch.from_numpy(X_te[: max(KERNEL_ROWS)].copy()).to(dev)
    b45 = {}
    for (f, dt), art in rff_arts.items():
        twin, kernel, args = kernel_args(art)
        name = kernel.__name__.removesuffix("_cuda")
        W = art.arrays["W"].to(torch.float32)
        if dt == "int8":
            W = W * art.arrays["W_scale"][:, None]
        for n in KERNEL_ROWS:
            # the largest cos argument, less its phase
            proj = float((Zf[:n] @ W.T).abs().max())
            b45[name, n, f] = check_fourier_kernel(
                "kernel_check_rff",
                kernel,
                twin,
                args,
                Zf[:n],
                B45_TWIN,
                B45_ABS,
                kernel=name,
                n=n,
                k=K,
                d=d,
                f=f,
                max_abs_proj=proj,
            )
    seconds["kernel_check_rff"] = time.perf_counter() - t0

    # ---------------------------------------------------------------- timing
    t0 = time.perf_counter()
    timings = {}
    M_deq = M_q.to(torch.float32) * col[:, None, :]
    for n in KERNEL_ROWS:
        Zn = Zq[:n]
        timings["quadform_heads_q8", n, None] = dict(
            ms=time_ms(lambda: qf.quadform_heads_q8_cuda(Zn, *q8_heads)),
            device_ms=device_ms(lambda: qf.quadform_heads_q8_cuda(Zn, *q8_heads)),
            host_ms=host_ms(lambda: qf.quadform_heads_q8_cuda(Zn, *q8_heads)),
            plain_ms=time_ms(lambda: qf.quadform_heads_q8_torch(Zn, *q8_heads)),
            library_ms=time_ms(lambda: torch.einsum("ni,kij,nj->nk", Zn, M_deq, Zn)),
            bound=bound(*quadform_q8_work(n, K, d), peak=PEAK_F32_3XTF32),
        )
    for (f, dt), art in rff_arts.items():
        twin, kernel, args = kernel_args(art)
        name = kernel.__name__.removesuffix("_cuda")
        W = art.arrays["W"].to(torch.float32)
        if dt == "int8":
            W = W * art.arrays["W_scale"][:, None]
        w_bytes = 1 if dt == "int8" else 4
        for n in KERNEL_ROWS:
            Zn = Zf[:n]
            timings[name, n, f] = dict(
                ms=time_ms(lambda: kernel(Zn, *args)),
                device_ms=device_ms(lambda: kernel(Zn, *args)),
                plain_ms=time_ms(lambda: twin(Zn, *args)),
                library_ms=time_ms(lambda: torch.matmul(Zn, W.T)),
                bound=bound(*rff_work(n, f, K, d, w_bytes), peak=PEAK_F32_3XTF32),
            )
    phase_kernel_times(timings)
    seconds["kernel_time"] = time.perf_counter() - t0

    # --------------------------------------------------------- compile_model
    t0 = time.perf_counter()
    budget = Budget(**BUDGET)
    winner = compile_model(svm, budget, seed=SEED)
    report = winner.meta["compile_report"]
    for row in report["families"]:
        phase("compile_model_row", **row)
    summary = {k: v for k, v in report.items() if k != "families"}
    phase("compile_model", **summary)
    rows = {(r["family"], r["dtype"]): r for r in report["families"]}
    check(len(rows) == 6, f"compile_model report cells: {sorted(rows)}")
    chosen = rows[report["chosen"], report["chosen_dtype"]]
    check(chosen["meets_budget"], "compile_model chose a candidate over budget")
    seconds["compile_model"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    structured = compile_model(
        svm,
        budget,
        seed=SEED,
        families=("maclaurin", "fourier"),
        family_opts={"fourier": {"structured": True}},
    )
    for row in structured.meta["compile_report"]["families"]:
        phase("compile_model_structured_row", **row)
        if row["family"] == "fourier":  # measured (B6/B7) or pruned, not skipped
            reason = row.get("skipped")
            check(reason in (None, "pruned_by_cost"), f"structured fourier: {row}")
    seconds["compile_model_structured"] = time.perf_counter() - t0

    # ------------------------------------- serving: the winner and every cell
    t0 = time.perf_counter()
    sample = families.fourier.holdout_sample(svm, SEED, 256)
    cells = {
        (name, dt): families.get_family(name).compile(
            svm, dtype=dt, seed=SEED, holdout=sample
        )
        for name in ("maclaurin", "poly2", "fourier")
        for dt in quantize.DTYPES
    }
    with tempfile.TemporaryDirectory() as tmp:
        path = winner.save(str(Path(tmp) / "winner.npz"))
        won = CompiledArtifact.load(path, dev)
    check(won.digest() == winner.digest(), "save/load changed the winner's digest")
    failed = cells["fourier", "float32"].with_meta(valid_globally=False)
    served = [("winner", won)] + [(f"{n}/{dt}", a) for (n, dt), a in cells.items()]
    served.append(("fourier/float32, failed verdict", failed))

    rng = np.random.default_rng(SEED + 1)
    requests, off = [], 0
    for n, n_scaled in zip(CELL_ROWS, CELL_SCALED):
        Z = X_te[off : off + n].copy()
        off += n
        scaled = np.zeros(n, bool)
        scaled[rng.choice(n, size=n_scaled, replace=False)] = True
        Z[scaled] = push_out(Z[scaled], msq, gamma)
        requests.append((Z, scaled))
    refs = [exact(Z) for Z, _ in requests]
    engines = []
    for _, art in served:
        engine = SVMEngine(art, svm, device=dev)
        engine.warmup(list(CELL_ROWS))
        engines.append(engine)
    seconds["serve_setup"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    build.reset_counts()
    results = [[e.submit(Z) for Z, _ in requests] for e in engines]
    for per_engine in results:
        for r in per_engine:
            r.labels  # materialize: the fallback rows are scored here
    launches = build.counts()
    seconds["serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for (label, art), engine, per_engine in zip(served, engines, results):
        fields = serve_cell_checks(
            label, art, engine, per_engine, requests, refs, exact, dev
        )
        row = rows.get((art.family, art.dtype), {})
        if "mean_abs" in row:
            fields["compile_mean_abs_err"] = row["mean_abs"]
            fields["budget_limit"] = report["limit"]
        phase("serve_cell", cell=label, **fields)
        if art.family == "maclaurin" and label != "winner":
            check(fields["decided_rows"] > 0, f"{label}: no decided rows")
            share = fields["ref_mode_share"]
            check(share <= MAX_MODE_SHARE, f"{label}: reference labels one class")
            agree = fields["label_agree"]
            check(agree >= MIN_AGREE_IN_ENVELOPE, f"{label}: label agreement {agree}")
    seconds["serve_checks"] = time.perf_counter() - t0

    # End to end after warmup, per cell: host clock around submit -> labels.
    t0 = time.perf_counter()
    for (label, _), engine in zip(served, engines):
        medians = {
            f"rows_{n}": median_request_ms(engine, Z)
            for (Z, _), n in zip(requests, CELL_ROWS)
        }
        phase("serve_cell_median_ms", cell=label, **medians)
    seconds["serve_timing"] = time.perf_counter() - t0
    phase("second_path_launches", **launches)
    path_kernels = ("quadform_heads", "quadform_heads_q8", "rbf_scores")
    for name in path_kernels + ("rff_score", "rff_score_q8"):
        check(launches[name] > 0, f"{name} never launched on the second path")
    phase("second_path_seconds", **seconds)

    n_t, f_t = max(KERNEL_ROWS), FEATURES[0]
    meta = {
        "quadform_heads_q8": (
            "quadform.cu",
            "src/repro/kernels/quadform/kernel.py:222",
            b3[n_t, "all"]["max_abs_err"],
            timings["quadform_heads_q8", n_t, None],
        ),
        "rff_score": (
            "rff_score.cu",
            "src/repro/kernels/rff_score/kernel.py:169",
            b45["rff_score", n_t, f_t]["max_abs_err"],
            timings["rff_score", n_t, f_t],
        ),
        "rff_score_q8": (
            "rff_score.cu",
            "src/repro/kernels/rff_score/kernel.py:121",
            b45["rff_score_q8", n_t, f_t]["max_abs_err"],
            timings["rff_score_q8", n_t, f_t],
        ),
    }
    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": t["ms"],
            **({"device_ms": t["device_ms"]} if "device_ms" in t else {}),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        }
        for name, (source, replaces, err, t) in meta.items()
    ]
    return entries, launches


def third_path(dev):
    """Training on the card, ``compile_model`` with the Fastfood projection
    and kernels B6/B7.

    Returns (the B6/B7 ``kernels`` entries, every kernel's launches on
    this path: training, ``compile_model`` and serving; the kernel checks
    and timings come after the count is read).
    """
    import torch

    from repro_torch import svm as training
    from repro_torch.core import backend, families, gamma_max
    from repro_torch.core.families import Budget, CompiledArtifact, compile_model
    from repro_torch.core.families import quantize
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.fwht import ref as ffref
    from repro_torch.serve import SVMEngine
    from repro_torch.svm import dual

    seconds = {}
    rng = np.random.default_rng(SEED + 2)
    X_mnist, y_mnist, Xm_te, ym_te, spec = make_dataset("mnist", scale=0.1, seed=SEED)
    d = spec.d
    mus = rng.standard_normal((K, d)) * 3
    y_all = np.arange(OVR_TRAIN + OVR_TEST) % K
    X_all = (rng.standard_normal((len(y_all), d)) + mus[y_all]).astype(np.float32)
    X_tr, y_tr = X_all[:OVR_TRAIN], y_all[:OVR_TRAIN]
    X_te, y_te = X_all[OVR_TRAIN:], y_all[OVR_TRAIN:]

    # ---------------------------------------------------------------- train
    build.reset_counts()
    t_train = t0 = time.perf_counter()
    Xd = torch.from_numpy(X_tr).to(dev)
    gamma = OVR_GAMMA_SHARE * float(gamma_max(Xd))
    ovr = training.train_one_vs_rest(
        Xd, torch.from_numpy(y_tr).to(dev), K, gamma, OVR_REG_C
    )
    torch.cuda.synchronize()
    ovr_s = time.perf_counter() - t0
    acc_tr = float((training.ovr_predict(ovr, X_tr).cpu().numpy() == y_tr).mean())
    acc_te = float((training.ovr_predict(ovr, X_te).cpu().numpy() == y_te).mean())
    phase(
        "train_one_vs_rest",
        seconds=ovr_s,
        n=OVR_TRAIN,
        d=d,
        k=K,
        gamma=gamma,
        reg_c=OVR_REG_C,
        train_acc=acc_tr,
        test_acc=acc_te,
        max_abs_alpha=float(ovr.alpha_y.abs().max()),
    )
    check(acc_tr > MIN_OVR_TRAIN_ACC, f"one-vs-rest train accuracy {acc_tr}")

    # The dual C-SVC, "class vs others": on mnist rows at the spec gamma, and
    # on class 0 of the one-vs-rest rows at their gamma.
    svc_tasks = {
        "mnist": (X_mnist, y_mnist, Xm_te, ym_te, spec.paper_gamma),
        "class0": (
            X_tr,
            np.where(y_tr == 0, 1.0, -1.0),
            X_te,
            np.where(y_te == 0, 1.0, -1.0),
            gamma,
        ),
    }
    svc_n_sv = {}
    for task, (Xs, ys, Xs_te, ys_te, g) in svc_tasks.items():
        t0 = time.perf_counter()
        Xs_d = torch.from_numpy(Xs[:SVC_ROWS]).to(dev)
        ys_d = torch.from_numpy(ys[:SVC_ROWS].astype(np.float32)).to(dev)
        model, mask = training.train_svc(Xs_d, ys_d, g, SVC_C, num_steps=SVC_STEPS)
        small = dual.compress_support(model, mask)
        torch.cuda.synchronize()
        svc_s = time.perf_counter() - t0
        Zs = torch.from_numpy(np.ascontiguousarray(Xs_te[:1024])).to(dev)

        def decide(m, Z):
            return backend.rbf_scores(Z, m.X, m.alpha_y, m.gamma, m.b)

        dense, comp = decide(model, Zs), decide(small, Zs)
        gap = float((comp - dense).abs().max())
        tol_ok = bool(
            ((comp - dense).abs() <= SVC_ATOL + SVC_RTOL * dense.abs()).all()
        )
        on_tr = torch.sign(decide(model, Xs_d)) == ys_d
        on_te = torch.sign(dense).cpu().numpy() == ys_te[:1024]
        svc_n_sv[task] = small.n_sv
        kept = model.alpha_y.abs()[mask]
        phase(
            "train_svc",
            task=task,
            seconds=svc_s,
            n=SVC_ROWS,
            steps=SVC_STEPS,
            c=SVC_C,
            gamma=float(g),
            n_sv=small.n_sv,
            min_kept_alpha_over_threshold=float(kept.min()) / (1e-6 * SVC_C),
            train_acc=float(on_tr.float().mean()),
            test_acc=float(on_te.mean()),
            compressed_max_abs_diff=gap,
        )
        check(tol_ok, f"svc {task}: compressed and dense differ by {gap}")
    # On the mnist rows the reference trainer keeps every row (its smallest
    # alpha is ~6e4 times the threshold, so no row is near the cut); the
    # class-0 task shows the sparsity.
    n_sv = svc_n_sv["mnist"]
    check(n_sv == SVC_MNIST_N_SV, f"svc mnist: n_sv {n_sv}, reference {SVC_MNIST_N_SV}")
    n_sv = svc_n_sv["class0"]
    check(0 < n_sv < SVC_ROWS, f"svc class0: n_sv {n_sv} of {SVC_ROWS}")
    seconds["train"] = time.perf_counter() - t_train

    # --------------------------------------------------------- compile_model
    t0 = time.perf_counter()
    budget = Budget(**BUDGET)
    ff_opts = {"structured": True, "num_features": FF_FEATURES[0]}
    winner = compile_model(ovr, budget, seed=SEED, family_opts={"fourier": ff_opts})
    report = winner.meta["compile_report"]
    for row in report["families"]:
        phase("compile_model_row", path=3, **row)
    summary = {k: v for k, v in report.items() if k != "families"}
    phase("compile_model", path=3, **summary)
    rows = {(r["family"], r["dtype"]): r for r in report["families"]}
    check(len(rows) == 6, f"compile_model report cells: {sorted(rows)}")
    for dt in quantize.DTYPES:
        row = rows["fourier", dt]
        reason = row.get("skipped")
        check(reason in (None, "pruned_by_cost"), f"structured fourier {dt}: {row}")
    seconds["compile_model"] = time.perf_counter() - t0

    # ------------------------------------ serve the Fastfood artifacts (B6/B7)
    t0 = time.perf_counter()
    sample = families.fourier.holdout_sample(ovr, SEED, 256)
    arts = {
        dt: training.compile_ovr(
            ovr, "fourier", dtype=dt, seed=SEED, holdout=sample, **ff_opts
        )
        for dt in quantize.DTYPES
    }
    served = []
    with tempfile.TemporaryDirectory() as tmp:
        for dt, art in arts.items():
            loaded = CompiledArtifact.load(art.save(str(Path(tmp) / f"{dt}.npz")), dev)
            check(loaded.digest() == art.digest(), f"save/load changed fastfood {dt}")
            served.append((f"fastfood/{dt}", loaded))
            failed = loaded.with_meta(valid_globally=False)
            served.append((f"fastfood/{dt}, failed verdict", failed))
    requests, off = [], 0
    for n in CELL_ROWS:
        requests.append((X_te[off : off + n].copy(), np.zeros(n, bool)))
        off += n
    exact = exact64(ovr, dev)
    refs = [exact(Z) for Z, _ in requests]
    engines = []
    for _, art in served:
        engine = SVMEngine(art, ovr, device=dev)
        engine.warmup(list(CELL_ROWS))
        engines.append(engine)
    results = [[e.submit(Z) for Z, _ in requests] for e in engines]
    for per_engine in results:
        for r in per_engine:
            r.labels  # materialize: the fallback rows are scored here
    launches = build.counts()
    seconds["serve"] = time.perf_counter() - t0
    phase("third_path_launches", **launches)
    for name in ("fastfood_score", "fastfood_score_q8", "rbf_scores"):
        check(launches[name] > 0, f"{name} never launched on the third path")

    for (label, art), engine, per_engine in zip(served, engines, results):
        fields = serve_cell_checks(
            label, art, engine, per_engine, requests, refs, exact, dev
        )
        fields["compile_mean_abs_err"] = rows["fourier", art.dtype].get("mean_abs")
        fields["budget_limit"] = report["limit"]
        phase("serve_cell", path=3, cell=label, **fields)
    for (label, _), engine in zip(served, engines):
        medians = {
            f"rows_{n}": median_request_ms(engine, Z)
            for (Z, _), n in zip(requests, CELL_ROWS)
        }
        phase("serve_cell_median_ms", path=3, cell=label, **medians)

    # --------------------------------- B6/B7 against their twins, and timed
    t0 = time.perf_counter()
    ff_arts = {(FF_FEATURES[0], dt): a.to(dev) for dt, a in arts.items()}
    for dt in quantize.DTYPES:
        opts = dict(ff_opts, num_features=FF_FEATURES[1])
        ff_arts[FF_FEATURES[1], dt] = training.compile_ovr(
            ovr, "fourier", dtype=dt, seed=SEED, holdout=sample, **opts
        )
    Zf = torch.from_numpy(X_te[: max(KERNEL_ROWS)].copy()).to(dev)
    eye = torch.eye(d, device=dev)
    checks, timings = {}, {}
    for (f, dt), art in ff_arts.items():
        twin, kernel, args = kernel_args(art)
        name = kernel.__name__.removesuffix("_cuda")
        for n in KERNEL_ROWS:
            checks[name, n, f] = check_fourier_kernel(
                "kernel_check_fastfood",
                kernel,
                twin,
                args,
                Zf[:n],
                FF_TWIN,
                FF_ABS,
                kernel=name,
                n=n,
                k=K,
                d=d,
                f=f,
            )
        # The dense (F, d) matrix the structured operator stands for: the
        # library yardstick is the one product that projects Z through it.
        a = art.arrays
        B, G, S = (a[k].to(torch.float32) for k in ("ff_b", "ff_g", "ff_scale"))
        if dt == "int8":
            S = S * a["ff_stack_scale"][:, None]
        W_eq = ffref.fastfood_project(eye, B, G, a["ff_perm"], S).T.contiguous()
        w_bytes = 1 if dt == "int8" else 4
        for n in KERNEL_ROWS:
            Zn = Zf[:n]
            timings[name, n, f] = dict(
                ms=time_ms(lambda: kernel(Zn, *args)),
                device_ms=device_ms(lambda: kernel(Zn, *args)),
                host_ms=host_ms(lambda: kernel(Zn, *args)),
                plain_ms=time_ms(lambda: twin(Zn, *args)),
                library_ms=time_ms(lambda: torch.matmul(Zn, W_eq.T)),
                bound=fastfood_bound(n, f, K, d, w_bytes),
            )
    phase_kernel_times(timings)
    seconds["kernel_checks"] = time.perf_counter() - t0
    phase("third_path_seconds", **seconds)

    n_t, f_t = max(KERNEL_ROWS), FF_FEATURES[0]
    entries = []
    for name, line in (("fastfood_score", 137), ("fastfood_score_q8", 198)):
        t = timings[name, n_t, f_t]
        entries.append(
            {
                "name": name,
                "route": "cuda",
                "source": "src/repro_torch/csrc/fastfood.cu",
                "replaces": f"src/repro/kernels/fwht/kernel.py:{line}",
                "launches": launches[name],
                "max_abs_err": checks[name, n_t, f_t]["max_abs_err"],
                "ms": t["ms"],
                "device_ms": t["device_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
            }
        )
    return entries, launches


def lm_config(**changes):
    """The fourth path's model configuration: ``LM_NAME`` at full width."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_NAME), **changes)


def attention_kernel_checks(dev) -> tuple[dict, dict]:
    """B9 and B8 against their plain twins and float64 at the model's
    attention shapes, and timed; B8 by each of its routes, forced, and
    unforced by the one ``route`` picks, which must be the faster. Returns
    (checks, timings), keyed by (kernel, case), for B8 of the route taken."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.common import tuning
    from repro_torch.kernels.flash_attn import kernel as fa
    from repro_torch.kernels.maclaurin_attn import kernel as ma
    from repro_torch.kernels.maclaurin_attn.ref import (
        maclaurin_attention_ref,
        softmax_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(bh, t, d, dv, dtype):
        q, k = (torch.randn((bh, t, d), generator=gen, device=dev) for _ in range(2))
        v = torch.randn((bh, t, dv), generator=gen, device=dev)
        return [x.to(dtype).contiguous() for x in (q, k, v)]

    def oracle(fn, q, k, v):
        """``fn`` in float64, a few heads at a time (it holds T x T weights)."""
        g = max(1, 2**28 // q.shape[1] ** 2)
        scale = q.shape[-1] ** -0.5
        parts = [
            fn(*(x[i : i + g].double() for x in (q, k, v)), scale=scale)
            for i in range(0, q.shape[0], g)
        ]
        return torch.cat(parts)

    checks, timings = {}, {}
    chunk = tuning.lookup("maclaurin_attn").chunk  # the model's, the one B8 chunk
    for name, case, (bh, t, d, dv), dtype in ATTN_CASES:
        is_flash = name == "flash_attention"
        dtype = getattr(torch, dtype)
        q, k, v = inputs(bh, t, d, dv, dtype)
        if is_flash:
            launches = {None: lambda: fa.flash_attention_cuda(q, k, v)}
            plain = lambda: fa.flash_attention_torch(q, k, v)  # noqa: E731
            exact_fn = softmax_attention_ref
            route = None
        else:
            route = ma.route(bh, t, d, dv)
            launches = {
                r: (lambda r=r: ma.maclaurin_attention_cuda(q, k, v, force_route=r))
                for r in (route, *(r for r in ma.ROUTES if r != route))
            }
            plain = lambda: ma.maclaurin_attention_torch(q, k, v)  # noqa: E731
            exact_fn = maclaurin_attention_ref
        twin = plain()
        exact = oracle(exact_fn, q, k, v)
        twin_err = max_err(twin, exact)
        tol = ATTN_TWIN * twin_err + ATTN_ABS
        for r, launch in launches.items():
            out, again = launch(), launch()
            torch.cuda.synchronize()
            err = max_err(out, twin)
            res = dict(
                max_abs_err=err,
                twin_max_abs_err_vs_float64=twin_err,
                max_abs_err_vs_float64=max_err(out, exact),
                tol=tol,
                max_abs_ref=float(twin.double().abs().max()),
                same_bits_again=bool(torch.equal(again, out)),
            )
            if r == route and not is_flash:
                unforced = ma.maclaurin_attention_cuda(q, k, v)
                res["unforced_same_bits"] = bool(torch.equal(unforced, out))
            if dtype == torch.bfloat16:
                res.update(bf16_rounding_check(q, k, v, out, exact))
            phase(
                "kernel_check",
                kernel=name,
                case=case,
                bh=bh,
                t=t,
                d=d,
                dv=dv,
                dtype=str(dtype).removeprefix("torch."),
                chunk=None if is_flash else chunk,
                route=r,
                route_taken=route,
                **res,
            )
            what = f"{name} {case}" + (f" ({r} route)" if r else "")
            check(err <= tol, f"{what}: {err} > {tol}")
            if dtype == torch.bfloat16:
                check(res["bf16_worst_margin"] >= 0, f"{what}: beyond bf16 rounding of the f32 twin")
                check(res["control_bf16_worst_margin"] < 0, f"{what}: the dropped-tile control passed")
            check(res["same_bits_again"], f"{what}: bits differ run to run")
            check(res.get("unforced_same_bits", True), f"{what}: unforced, another route ran")
            check(bool(torch.isfinite(out).all()), f"{what}: not finite")
            if r == route:
                checks[name, case] = res
            del out, again
        del exact
        if t % 64:  # ragged cases are checked, not timed
            continue
        iters = 5 if is_flash else 3
        if is_flash:
            q4, k4, v4 = (x.view(1, bh, t, -1) for x in (q, k, v))
            library = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)  # noqa: E731
            work = flash_work(bh, t, d, dv, q.element_size())
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_3XTF32
        else:
            library = None  # no PyTorch call computes w(u) attention
            work = maclaurin_work(bh, t, d, dv, chunk)
            peak = PEAK_F32_3XTF32  # the card's f32-accurate product rate, whichever route
        route_ms = {r: time_ms(launch, iters=iters, warm=1) for r, launch in launches.items()}
        timings[name, case] = dict(
            ms=route_ms[route],
            plain_ms=time_ms(plain, iters=iters, warm=1),
            library_ms=time_ms(library, iters=iters, warm=1) if library else None,
            bound=bound(*work, peak=peak),
        )
        t_ = timings[name, case]
        for r, ms in route_ms.items():
            check(ms >= t_["bound"][0], f"{name} {case} ({r} route): faster than its bound")
        if not is_flash:
            other = min(ms for r, ms in route_ms.items() if r != route)
            check(t_["ms"] <= other, f"{name} {case}: the {route} route taken is the slower")
        phase(
            "kernel_time",
            kernel=name,
            case=case,
            route=route,
            route_ms={r: ms for r, ms in route_ms.items() if r},
            bound_ms=t_["bound"][0],
            bound_by=t_["bound"][1],
            **{k_: t_[k_] for k_ in ("ms", "plain_ms", "library_ms")},
        )
    return checks, timings


def bf16_rounding_check(q, k, v, out, exact) -> dict:
    """B9's bf16 output against the f32 twin's value before rounding, element
    by element (see BF16_HALF_STEP), and the same check of a control: the
    output with the last query tile's rows recomputed without the first key
    tile, the rows whose values are smallest and change least. Returns the
    worst margin of each (negative: the check fails) and the control's
    max|delta| (one bf16 step of max|out|, the limit this check replaced,
    would let it pass)."""
    import torch

    from repro_torch.kernels.common import tuning
    from repro_torch.kernels.flash_attn import kernel as fa

    twin32 = fa.flash_attention_torch(q.float(), k.float(), v.float()).double()
    tol32 = ATTN_TWIN * max_err(twin32, exact) + ATTN_ABS

    def margin(x):
        room = BF16_HALF_STEP * twin32.abs() + (1 + BF16_HALF_STEP) * tol32
        return float((room - (x.double() - twin32).abs()).min())

    tile = tuning.lookup("flash_attn").block_k  # the kernel's key tile
    rows = min(tile, q.shape[1] - tile)
    late = fa.flash_attention_torch(q[:, tile:], k[:, tile:], v[:, tile:])[:, -rows:]
    control = torch.cat([out[:, :-rows], late], dim=1)
    return dict(
        bf16_worst_margin=margin(out),
        bf16_tol32=tol32,
        control_bf16_worst_margin=margin(control),
        control_max_abs_err=max_err(control, twin32),
    )


def logit_gate(test, ref, rel: float, gap: float, against: str = "ref") -> dict:
    """``test`` logits against ``ref``: max|delta| within ``rel`` of
    max|ref|, and top-1 equal wherever ref's top-2 gap exceeds ``gap`` of
    max|ref| (see PREFILL_REL)."""
    test, ref = test.float(), ref.float()
    delta = float((test - ref).abs().max())
    scale = float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > gap * scale
    agree = test.argmax(-1) == ref.argmax(-1)
    return {
        f"max_abs_vs_{against}": delta,
        "max_abs_ref": scale,
        "rel": delta / scale,
        "rel_tol": rel,
        "max_ok": delta <= rel * scale,
        "top1_agree": float(agree.float().mean()),
        "decided_positions": int(decided.sum()),
        "gap": gap,
        "top1_ok": bool(agree[decided].all()),
    }


def fourth_path(dev):
    """Path 4, the LM side (kernels B8, B9): ``LM_NAME`` at full width from
    seeded random weights. Prefill through ``make_prefill_step`` with the
    blockwise, flash and maclaurin attention; decode token by token through
    ``make_serve_step`` at f32 with an f32, a bf16 and an int8 KV cache and
    the ``MacState``, held against the matching forward or the next wider
    cache; then ``greedy_generate`` from the filled caches. Returns (the
    B8/B9 ``kernels`` entries, every kernel's launches on this path)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.serve.decode_step import (
        greedy_generate,
        make_prefill_step,
        make_serve_step,
    )

    seconds = {}
    t0 = time.perf_counter()
    checks, timings = attention_kernel_checks(dev)
    torch.cuda.empty_cache()
    seconds["lm_kernels"] = time.perf_counter() - t0

    # ---------------------------------------------------------- lm_prefill
    t0 = time.perf_counter()
    cfg = lm_config()
    params = tf.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_T), generator=gen, device=dev)
    prefill_cfgs = {
        "blockwise": lm_config(attention_impl="blockwise"),
        "flash": lm_config(attention_impl="flash"),
        "maclaurin": lm_config(attention_backend="maclaurin"),
    }
    want = {
        "blockwise": {},
        "flash": {"flash_attention": cfg.n_layers},
        "maclaurin": {"maclaurin_attention": cfg.n_layers},
    }
    build.reset_counts()
    logits, per_cfg = {}, {}
    for label, c in prefill_cfgs.items():
        before = build.counts()
        logits[label] = make_prefill_step(c)(params, tokens)
        torch.cuda.synchronize()
        after = build.counts()
        per_cfg[label] = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        check(
            per_cfg[label] == want[label],
            f"prefill {label}: launches {per_cfg[label]}, want {want[label]}",
        )
        check(bool(torch.isfinite(logits[label]).all()), f"prefill {label}: not finite")
    flash = logit_gate(logits["flash"], logits["blockwise"], PREFILL_REL, PREFILL_GAP)
    control = logit_gate(logits["maclaurin"], logits["blockwise"], PREFILL_REL, PREFILL_GAP)
    phase(
        "lm_prefill",
        model=cfg.name,
        params=n_params,
        dtype=cfg.dtype,
        batch=LM_B,
        tokens=LM_T,
        launches=per_cfg,
        flash_vs_blockwise=flash,
        control_maclaurin_vs_blockwise=control,
    )
    check(flash["max_ok"], f"flash vs blockwise logits beyond {PREFILL_REL} of max|logit|")
    check(flash["top1_ok"], "flash vs blockwise top-1 on decided positions")
    check(not control["max_ok"], "the maclaurin control passed the flash gate")
    del logits
    seconds["lm_prefill"] = time.perf_counter() - t0

    # ------------------------------------------------------ lm_consistency
    t0 = time.perf_counter()
    cfg32 = lm_config(dtype="float32")
    prompt = tokens[:CONS_B, :CONS_T]
    s_max = CONS_T + GEN_STEPS
    kinds = {  # config, and the KV cache's dtype where it has one
        "f32": (lm_config(dtype="float32", attention_impl="flash"), torch.float32),
        "bf16": (lm_config(dtype="float32"), torch.bfloat16),
        "int8": (lm_config(dtype="float32", kv_cache_dtype="int8"), None),
        "maclaurin": (lm_config(dtype="float32", attention_backend="maclaurin"), None),
    }
    full = {
        "f32": tf.forward(kinds["f32"][0], params, prompt)[0],  # B9 at f32
        "maclaurin": tf.forward(kinds["maclaurin"][0], params, prompt)[0],  # B8, chunk 64
    }
    caches, decoded, step_ms = {}, {}, {}
    for kind, (c, cache_dtype) in kinds.items():
        cache = tf.init_cache(c, CONS_B, s_max, dtype=cache_dtype, device=dev)
        step = make_serve_step(c)
        outs = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for pos in range(CONS_T):
            lg, cache = step(params, prompt[:, pos : pos + 1], pos, cache)
            outs.append(lg)
        torch.cuda.synchronize()
        step_ms[kind] = (time.perf_counter() - t1) * 1e3 / CONS_T
        caches[kind], decoded[kind] = cache, torch.cat(outs, dim=1)
    gates = {}
    # the reference's consistency check: decode against the forward
    for kind in ("f32", "maclaurin"):
        dec, ref = decoded[kind], full[kind]
        err = (dec - ref).abs()
        over = float((err - (CONS_ATOL + CONS_RTOL * ref.abs())).max())
        gates[kind] = dict(
            max_abs_err_vs_forward=float(err.max()),
            max_abs_ref=float(ref.abs().max()),
            worst_margin_to_tol=-over,
            top1_agree=float((dec.argmax(-1) == ref.argmax(-1)).float().mean()),
        )
        check(over <= 0, f"{kind} decode vs forward beyond rtol=atol={CONS_RTOL}")
    # a narrower cache against the next wider one, and the control
    for kind, wider, rel, gap in (
        ("bf16", "f32", BF16_CACHE_REL, BF16_CACHE_GAP),
        ("int8", "bf16", INT8_CACHE_REL, INT8_CACHE_GAP),
    ):
        gates[kind] = logit_gate(decoded[kind], decoded[wider], rel, gap, against=wider)
        check(gates[kind]["max_ok"], f"{kind} cache vs {wider} beyond {rel} of max|logit|")
        check(gates[kind]["top1_ok"], f"{kind} cache top-1 on decided positions")
    rel = max(BF16_CACHE_REL, INT8_CACHE_REL)
    control = logit_gate(decoded["maclaurin"], decoded["f32"], rel, INT8_CACHE_GAP, against="f32")
    gates["control_maclaurin"] = control
    check(not control["max_ok"], "the maclaurin control passed the cache gates")
    phase(
        "lm_consistency",
        model=cfg32.name,
        dtype="float32",
        batch=CONS_B,
        tokens=CONS_T,
        step_ms=step_ms,
        **gates,
    )
    next_tok = decoded["bf16"][:, -1:].argmax(-1).to(torch.int32)
    del full, decoded, dec, ref
    seconds["lm_consistency"] = time.perf_counter() - t0

    # --------------------------------------------------------- lm_generate
    t0 = time.perf_counter()
    generated = {}
    for kind in ("bf16", "int8", "maclaurin"):
        c = kinds[kind][0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, cache = greedy_generate(
            c, params, next_tok, caches[kind], steps=GEN_STEPS, start_pos=CONS_T
        )
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / GEN_STEPS
        check(toks.shape == (CONS_B, GEN_STEPS), f"generate {kind}: shape {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < c.vocab_size)).all()), f"generate {kind}: token ids")
        generated[kind] = toks
        grown = tf.cache_bytes(tf.init_cache(c, CONS_B, 16 * s_max, device=dev))
        if kind == "maclaurin":
            check(grown == tf.cache_bytes(cache), "MacState bytes grew with the context")
        else:
            check(grown == 16 * tf.cache_bytes(cache), f"{kind} KV bytes not linear in S")
        phase(
            "lm_generate",
            cache=kind,
            steps=GEN_STEPS,
            start_pos=CONS_T,
            ms_per_token=ms,
            state_bytes=tf.cache_bytes(cache),
            state_bytes_at_16x_context=grown,
            first_tokens=toks[0, :8].tolist(),
        )
    same = float((generated["int8"] == generated["bf16"]).float().mean())
    phase("lm_generate_agreement", int8_vs_bf16_tokens=same)
    launches = build.counts()
    phase("fourth_path_launches", **launches)
    seconds["lm_generate"] = time.perf_counter() - t0

    # ---------------------------------------------------- prefill timings
    t0 = time.perf_counter()
    for label, c in prefill_cfgs.items():
        step = make_prefill_step(c)
        ms = time_ms(lambda: step(params, tokens), iters=3, warm=1)
        phase("lm_prefill_time", config=label, ms=ms, tokens_per_s=LM_B * LM_T / ms * 1e3)
    seconds["prefill_timing"] = time.perf_counter() - t0
    phase("fourth_path_seconds", **seconds)

    entries = []
    for name, source, line in (
        ("maclaurin_attention", "maclaurin_attn", 137),
        ("flash_attention", "flash_attn", 95),
    ):
        case = "model" if name == "maclaurin_attention" else "model bf16"
        t = timings[name, case]
        entries.append(
            {
                "name": name,
                "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}.cu",
                "replaces": f"src/repro/kernels/{source}/kernel.py:{line}",
                "launches": launches[name],
                "max_abs_err": checks[name, case]["max_abs_err"],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
            }
        )
    return entries, launches


def serve_cell_checks(
    label, art, engine, results, requests, refs, exact, dev
) -> dict:
    """Check one served artifact's results and return its phase fields
    (errors and tolerances listed per request that has such rows).

    Rows the artifact vouches for (inside the envelope for quadform
    families; all or none for fourier, by its held-out verdict) must
    carry the plain twin's scores within the kernel's tolerance; the
    others must fall back to the exact scores within B2's. Labels of
    vouched rows are compared with the float64 model's where fp32 can
    decide them (top-two gap over twice B2's tolerance, as for
    ``submit_exact``).
    """
    import torch

    quadform = art.meta["kind"] == "quadform"
    verdict = bool(art.meta.get("valid_globally", True))
    want_fallback, agree, decided_n, in_n = 0, 0, 0, 0
    score_err, score_tol, fb_err, fb_tol = [], [], [], []  # per request
    in_labels = []
    for (Z, scaled), r, (ref, ref_tol) in zip(requests, results, refs):
        want_valid = ~scaled if quadform else np.full(len(Z), verdict)
        check(bool((r.valid == want_valid).all()), f"{label}: valid mask")
        want_fallback += int((~want_valid).sum())
        v = r.valid
        if v.any():
            s0, tol = plain_scores(art, torch.from_numpy(Z[v]).to(dev))
            err = float(np.abs(r.values[v] - s0.cpu().numpy()).max())
            score_err.append(err)
            score_tol.append(tol)
            check(err <= tol, f"{label}: served scores {err} > {tol}")
            top2 = np.sort(ref[v], -1)[:, -2:]
            decided = top2[:, 1] - top2[:, 0] > 2 * ref_tol
            ref_labels = ref[v].argmax(-1)
            agree += int((r.labels[v][decided] == ref_labels[decided]).sum())
            decided_n += int(decided.sum())
            in_n += int(v.sum())
            in_labels.append(ref_labels)
        if (~v).any():
            tol = exact(Z[~v])[1]
            err = float(np.abs(r.values[~v] - ref[~v]).max())
            fb_err.append(err)
            fb_tol.append(tol)
            check(err <= tol, f"{label}: fallback scores {err} > {tol}")
    fallback = engine.stats.snapshot()["fallback_instances"]
    check(fallback == want_fallback, f"{label}: {fallback} rows fell back")
    fields = dict(
        family=art.family,
        dtype=art.dtype,
        valid_globally=verdict,
        fallback_rows=fallback,
        in_envelope_rows=in_n,
        decided_rows=decided_n,
        max_abs_err_vs_twin=score_err,
        tol_vs_twin=score_tol,
        fallback_max_abs_err=fb_err,
        fallback_tol=fb_tol,
    )
    if decided_n:
        labels = np.concatenate(in_labels)
        fields["label_agree"] = agree / decided_n
        fields["ref_mode_share"] = float(np.bincount(labels).max() / len(labels))
    for key in ("holdout_mean_abs_err", "quant_mean_abs_err"):
        if key in art.meta:
            fields[key] = art.meta[key]
    return fields


if __name__ == "__main__":
    sys.exit(main())
