#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

    python3 chip_smoke.py          # from the root of a checkout

Builds both CUDA kernels from ``src/repro_torch/csrc``, serves the
paper's mnist width (d=780, 10 one-vs-rest heads, 16384 SVs) through
compile -> save/load -> ``SVMEngine`` on the card, with rows scaled just
out of the Eq 3.11 envelope so the exact fallback (kernel B2) runs beside
the fast path (kernel B1), holds each kernel against its plain PyTorch
twin at full width, and times each kernel, its twin and a library call
beside the least time the card could take.

The model is random from a seed, shaped like a trained one so that no
constant swamps what the checks look at: each head's ``alpha_y`` sums to
0 (the SVM dual's equality constraint), and ``b`` makes every head score
0 at z = 0, so the labels follow z.

Output: phase lines, the card line from nvidia-smi, one JSON line of
kernels, and last ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, on any failed phase, without a card, or without the
repo's ``src/`` beside it.
"""

from __future__ import annotations

import json
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time in ms for the work, and which of the two rates sets it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
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


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def push_out(Z, msq: float, gamma: float):
    """Scale each row of ``Z`` to msq * |z|^2 = OUTSIDE / (16 gamma^2)."""
    zsq = (Z.astype(np.float64) ** 2).sum(1, keepdims=True)
    target = OUTSIDE * 0.0625 / (gamma * gamma * msq)
    return (Z * np.sqrt(target / zsq)).astype(np.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import convert
    from repro_torch.core import families
    from repro_torch.core.families import CompiledArtifact
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.quadform import kernel as qf
    from repro_torch.kernels.rbf_pred import kernel as rp
    from repro_torch.serve import SVMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    libs = build.build_all()
    phase("build", seconds=time.perf_counter() - t0, libs=[p.name for p in libs])

    # ------------------------------------------------------------ main path
    X_tr, _, X_te, _, spec = make_dataset("mnist", scale=0.3, seed=SEED)
    rng = np.random.default_rng(SEED)
    X = X_tr[:N_SV]
    alpha_y = rng.standard_normal((K, N_SV))
    alpha_y = (alpha_y - alpha_y.mean(1, keepdims=True)).astype(np.float32)
    gamma = np.float32(spec.paper_gamma)
    sv_sq = (X.astype(np.float64) ** 2).sum(1)
    b = -(alpha_y.astype(np.float64) @ np.exp(-float(gamma) * sv_sq))
    b = b.astype(np.float32)
    svm = convert.svm_from_numpy(X, alpha_y, b, gamma, device=dev)

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
    X64 = torch.from_numpy(X).to(dev, torch.float64)
    A64 = torch.from_numpy(alpha_y).to(dev, torch.float64)
    b64 = torch.from_numpy(b).to(dev, torch.float64)

    def exact64(Z):
        """(float64 scores, B2 tolerance) for the rows of ``Z``."""
        Zd = torch.from_numpy(Z).to(dev)
        ref = rp.rbf_scores_torch(Zd.double(), X64, A64, float(gamma), b64)
        twin = rp.rbf_scores_torch(Zd, svm.X, svm.alpha_y, svm.gamma, svm.b)
        return ref.cpu().numpy(), B2_TWIN * max_err(twin, ref) + B2_ABS

    n_scaled_total = int(sum(s.sum() for _, s in requests))
    agree_in, agree_out, n_in = 0, 0, 0
    ref_in_labels, margins = [], []
    fallback_err, fallback_tol, fallback_scale = 0.0, np.inf, 0.0
    for (Z, scaled), (vals, valid, labels) in zip(requests, served):
        check(bool((valid == ~scaled).all()), "valid mask != rows inside the envelope")
        ref = exact64(Z)[0]
        ref_labels = ref.argmax(-1)
        agree_in += int((labels[~scaled] == ref_labels[~scaled]).sum())
        agree_out += int((labels[scaled] == ref_labels[scaled]).sum())
        n_in += int((~scaled).sum())
        ref_in_labels.append(ref_labels[~scaled])
        top2 = np.sort(ref[~scaled], -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if scaled.any():
            tol = exact64(Z[scaled])[1]
            err = float(np.abs(vals[scaled] - ref[scaled]).max())
            fallback_err = max(fallback_err, err)
            fallback_tol = min(fallback_tol, tol)
            fallback_scale = max(fallback_scale, float(np.abs(ref[scaled] - b).max()))
            check(err <= tol, f"fallback values: {err} > {tol}")
    ref_in_labels = np.concatenate(ref_in_labels)
    mode_share = np.bincount(ref_in_labels, minlength=K).max() / len(ref_in_labels)
    ref_x, exact_tol = exact64(Z_exact)
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

    # ------------------------------------------ kernels against plain twins
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
            torch.cuda.synchronize()
            err, scale = max_err(s, s0), float(s0.abs().max())
            tol = B1_REL * scale + abs_tol
            zsq_rel = float(((zsq - zsq0).abs() / zsq0.abs().clamp(min=1e-30)).max())
            res = dict(max_abs_err=err, max_abs_ref=scale, tol=tol, zsq_rel_err=zsq_rel)
            res["masks_equal"] = bool((v == v0).all())
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
            b1[n, terms] = res

    Zr = torch.from_numpy(X_te[:256].copy()).to(dev)
    Xd, Ad = svm.X, svm.alpha_y
    bd, gd = svm.b, svm.gamma
    out = rp.rbf_scores_cuda(Zr, Xd, Ad, gd, bd)
    out0 = rp.rbf_scores_torch(Zr, Xd, Ad, gd, bd)
    out64 = rp.rbf_scores_torch(Zr.double(), X64, A64, float(gamma), b64)
    torch.cuda.synchronize()
    b2_err, twin_err = max_err(out, out0), max_err(out0, out64)
    b2_tol = B2_TWIN * twin_err + B2_ABS
    phase(
        "kernel_check",
        kernel="rbf_scores",
        n=256,
        m=N_SV,
        k=K,
        d=spec.d,
        max_abs_err=b2_err,
        max_abs_err_vs_float64=max_err(out, out64),
        twin_max_abs_err_vs_float64=twin_err,
        max_abs_ref_minus_b=float((out64 - b64).abs().max()),
        tol=b2_tol,
    )
    check(b2_err <= b2_tol, f"rbf_scores: {b2_err} > {b2_tol}")

    # --------------------------------------------------------------- timing
    Zt = Zq[:1024]
    q_ms = time_ms(lambda: qf.quadform_heads_cuda(Zt, *heads))
    q_plain = time_ms(lambda: qf.quadform_heads_torch(Zt, *heads))
    q_lib = time_ms(lambda: torch.einsum("ni,kij,nj->nk", Zt, a["M"], Zt))
    q_bound, q_by = bound(*quadform_work(1024, K, spec.d))
    Z32 = Zq[:32]
    q32 = time_ms(lambda: qf.quadform_heads_cuda(Z32, *heads))
    q32_plain = time_ms(lambda: qf.quadform_heads_torch(Z32, *heads))
    q32_lib = time_ms(lambda: torch.einsum("ni,kij,nj->nk", Z32, a["M"], Z32))
    q32_bound, q32_by = bound(*quadform_work(32, K, spec.d))
    phase(
        "quadform_heads_n32",
        ms=q32,
        plain_ms=q32_plain,
        library_ms=q32_lib,
        bound_ms=q32_bound,
        bound_by=q32_by,
    )
    r_ms = time_ms(lambda: rp.rbf_scores_cuda(Zr, Xd, Ad, gd, bd))
    r_plain = time_ms(lambda: rp.rbf_scores_torch(Zr, Xd, Ad, gd, bd))
    r_lib = time_ms(lambda: torch.cdist(Zr, Xd))
    r_bound, r_by = bound(*rbf_work(256, N_SV, K, spec.d))

    # End to end after warmup: host clock around submit -> labels on host.
    e2e = {}
    for (Z, _), n in zip(requests, REQUEST_ROWS):
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine.submit(Z).labels
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[n] = sorted(times)[len(times) // 2]
    phase("serve_median_ms", **{f"rows_{n}": t for n, t in e2e.items()})

    kernels = [
        {
            "name": "quadform_heads",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quadform.cu",
            "replaces": "src/repro/kernels/quadform/kernel.py:125",
            "launches": launches["quadform_heads"],
            "max_abs_err": b1[1024, "all"]["max_abs_err"],
            "ms": q_ms,
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
            "launches": launches["rbf_scores"],
            "max_abs_err": b2_err,
            "ms": r_ms,
            "plain_ms": r_plain,
            "bound_ms": r_bound,
            "bound_by": r_by,
            "library_ms": r_lib,
        },
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
