"""Kernels B4 and B5 (``csrc/rff_score.cu``) against variants of their own
body, on one card in one process: what each part of the design costs.

Each variant is a text substitution on the source, compiled by nvcc into its
own library under ``build/rff_variants/`` and swapped in for the wrapper's
(``build._libs``), so every variant runs through ``rff_score_cuda`` and
``rff_score_q8_cuda`` as served. Variants, in the order run (then reversed):

- ``as_built``: the source as it is;
- ``fold_each_kstep``: a fresh MMA accumulator every k-step (8 products)
  instead of every stage, added to the running tile each time;
- ``two_stage_ring``: a ring of 2 stages at 128 rows instead of 3;
- ``no_splits``: no TF32 split (hi = lo = the raw bits: wrong values), the
  cost of the splits' arithmetic;
- ``no_copies``: no copy of the Z and W tiles (wrong values), the cost of
  moving them;
- ``no_mma``: no projection at all (wrong values), what is left.

Prints one JSON line per (variant, pass, kernel, F): CUDA-event ms at
n=1024, d=780, K=10, and for the first pass of each variant its distance
from the f32 twin and from float64 on inputs whose cos arguments reach
~30 radians (bias 0, so the distance is the readout's own).

    python3 scripts/rff_variants.py        # on a machine with a CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPLITS_A = """      ptx::split_tf32(top.x, ah[i][0], al[i][0]);  // (g, k = t: column 2t)
      ptx::split_tf32(bot.x, ah[i][1], al[i][1]);  // (g + 8, 2t)
      ptx::split_tf32(top.y, ah[i][2], al[i][2]);  // (g, k = t + 4: column 2t + 1)
      ptx::split_tf32(bot.y, ah[i][3], al[i][3]);  // (g + 8, 2t + 1)"""
RAW_A = """      ah[i][0] = al[i][0] = __float_as_uint(top.x);
      ah[i][1] = al[i][1] = __float_as_uint(bot.x);
      ah[i][2] = al[i][2] = __float_as_uint(top.y);
      ah[i][3] = al[i][3] = __float_as_uint(bot.y);"""
SPLITS_B = """        ptx::split_tf32(w.x, bh[j][0], bl[j][0]);
        ptx::split_tf32(w.y, bh[j][1], bl[j][1]);"""
RAW_B = """        bh[j][0] = bl[j][0] = __float_as_uint(w.x);
        bh[j][1] = bl[j][1] = __float_as_uint(w.y);"""
CALL = "stage_product<T, L::kSteps>(acc, zs(st), ws(st), row, group * L::kSteps, g, t);"
Z_COPY = "    ptx::copy_tile<BN, kStride, kThreads>(zs(st), Z, row0, n, c0, d, d, vec);"
W_COPY = "      ptx::copy_tile<kBlockF, kStride, kThreads>(reinterpret_cast<float*>(ws(st)), W, f0, F,"
W8_COPY = "      unsigned char* dst = ws(st);\n      if (vec) {"
PRODUCT = "  constexpr bool kInt8 = std::is_same<T, int8_t>::value;\n  const float* zr"

VARIANTS = {
    "as_built": [],
    "fold_each_kstep": [
        (
            CALL,
            "for (int q = 0; q < L::kSteps; ++q)\n      stage_product<T, 1>(acc, zs(st), "
            "ws(st), row, group * L::kSteps + q, g, t);",
        )
    ],
    "two_stage_ring": [("BN == 128 ? 3 :", "BN == 128 ? 2 :")],
    "no_splits": [(SPLITS_A, RAW_A), (SPLITS_B, RAW_B)],
    "no_copies": [
        (Z_COPY, "    if (n < 0)" + Z_COPY[3:]),
        (W_COPY, "      if (n < 0)" + W_COPY[5:]),
        (W8_COPY, W8_COPY.replace("if (vec)", "if (n >= 0) {\n      } else if (vec)")),
    ],
    "no_mma": [
        (PRODUCT, PRODUCT.replace("\n  const", "\n  if (kk0 >= 0) return;\n  const"))
    ],
}
D, K = 780, 10


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.core.families import quantize
    from repro_torch.kernels import build
    from repro_torch.kernels.rff_score import kernel as rk

    if not torch.cuda.is_available():
        print("rff_variants: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    work = ROOT / "build" / "rff_variants"
    work.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "rff_score.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        (work / f"{name}.cu").write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC)]
        cmd += ["-o", str(work / f"{name}.so"), str(work / f"{name}.cu")]
        jobs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        usage = subprocess.run(
            [str(cuobjdump), "-res-usage", str(work / f"{name}.so")],
            capture_output=True,
            text=True,
            check=True,
        ).stdout
        regs = re.findall(r"rff_tf32I(\w)Li(\d+)E\S*:\s*REG:(\d+) STACK:(\d+)", usage)
        compiled = {
            f"{'q8' if t == 'a' else 'f32'}_{bn}": [int(r), int(s)]
            for t, bn, r, s in regs
        }
        print(json.dumps({"variant": name, "registers_stack": compiled}), flush=True)
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    Z = (rng.random((1024, D)) * (rng.random((1024, D)) < 0.3)).astype(np.float32)
    Z = torch.from_numpy(Z).to(dev)

    def inputs(f, scale, q8, zero_bias):
        W = rng.normal(0.0, scale, size=(f, D)).astype(np.float32)
        ph = rng.uniform(0.0, 2.0 * np.pi, f).astype(np.float32)
        wt = (rng.standard_normal((K, f)) * 2.0 / f).astype(np.float32)
        b = rng.standard_normal(K).astype(np.float32)
        if zero_bias:
            b[:] = 0.0
        if q8:
            W_q, w_s = quantize.quantize_rows(W)
            wt_q, wt_s = quantize.quantize_rows(wt)
            arrays = (W_q, w_s, ph, wt_q, wt_s, b)
        else:
            arrays = (W, ph, wt, b)
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    cases = {}
    for q8 in (False, True):
        for f in (1024, 4096):
            twin = rk.rff_score_q8_torch if q8 else rk.rff_score_torch
            timed, wide = inputs(f, 0.014, q8, False), inputs(f, 0.6, q8, True)
            d64 = [a if a.dtype == torch.int8 else a.double() for a in wide]
            out0, out64 = twin(Z, *wide), twin(Z.double(), *d64)
            cases[q8, f] = (timed, wide, out0, out64)
            W = wide[0].float() * (wide[1][:, None] if q8 else 1.0)
            twin_err = float((out0.double() - out64).abs().max())
            line = dict(q8=q8, f=f, max_abs_proj=float((Z @ W.T).abs().max()))
            line["twin_max_abs_err_vs_float64"] = twin_err
            print(json.dumps(line), flush=True)
    order = list(libs) + list(libs)[::-1]
    for rep, name in enumerate(order):
        build._libs["rff_score.cu"] = libs[name]
        rk.KERNEL._fn = rk.KERNEL_Q8._fn = None
        for (q8, f), (timed, wide, out0, out64) in cases.items():
            fn = rk.rff_score_q8_cuda if q8 else rk.rff_score_cuda
            line = dict(variant=name, rep=rep, kernel=fn.__name__, f=f)
            line["ms"] = chip_smoke.time_ms(lambda: fn(Z, *timed), iters=30, warm=5)
            if rep < len(libs):
                out = fn(Z, *wide).double()
                line["max_abs_err"] = float((out - out0.double()).abs().max())
                line["max_abs_err_vs_float64"] = float((out - out64).abs().max())
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
