"""Kernels B6 and B7 (``csrc/fastfood.cu``) over their tile choices, on one card.

Every rows-a-block (16, 32, 64), with one stack in one launch (the block
writes the scores) and in two (a second pass, as more stacks take), and
the wrappers' default (``tuning``'s ``fwht``/``fwht_q8`` through ``block_rows``), at n =
32 and 1024 rows, F = 1024 and 4096 features (one and four stacks of
d' = 1024), K=10 heads, d=780: the shapes of ``chip_smoke.py``'s third
path, on seeded operators. Prints the card line, then one JSON line per
(kernel, n, F, block_n, launches): ``measure_ms``, the best of 20 calls
each timed alone by ``autotune.measure`` (CUDA events after a synchronize,
so at n=32 it holds the host's launch), and ``device_ms``, the mean of 20
calls queued behind a spinning kernel (``chip_smoke.device_ms``); then,
per (kernel, n, F), the fastest by each reading beside the default's.

With ``--against SOURCE`` (another tree's ``fastfood.cu`` with the same C
entry points, e.g. the parent commit's), that source is built too and its
kernels are timed through the same operators at its own 8 rows a block
and two launches, in turns with the default of this tree (other, this,
this, other; ``device_ms``), one ``against`` line per (kernel, n, F).

    python3 scripts/fastfood_sweep.py [--against OTHER/fastfood.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

K, D, DD = 10, 780, 1024
ROWS, FEATURES = (32, 1024), (1024, 4096)
BLOCKS = (16, 32, 64)


class OtherBuild:
    """One C entry point of a separately built ``fastfood.cu``, with the
    ``launch`` that ``fwht.kernel.launch_tile`` calls."""

    def __init__(self, lib: ctypes.CDLL, symbol: str, argtypes: list):
        self.lib, self.fn = lib, getattr(lib, symbol)
        self.fn.argtypes, self.fn.restype = argtypes, ctypes.c_int

    def launch(self, *args) -> None:
        err = self.fn(*args)
        if err != 0:
            msg = self.lib.repro_error_string(err).decode()
            raise RuntimeError(f"CUDA error {err} ({msg})")


def build_other(source: Path, out_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build

    out = out_dir / "fastfood_other.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(source.parent), "-o", str(out)]
    subprocess.run([*cmd, str(source)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def operands(stacks: int, dev, q8: bool) -> tuple:
    """(operators, scales, bias) of B6 or B7, seeded, as the artifacts store
    them: the arguments between Z and the sizes, in the entry points' order."""
    import torch

    from repro_torch.core.families import quantize

    rng = np.random.default_rng(stacks)
    f = stacks * DD
    B = rng.choice(np.float32([-1.0, 1.0]), (stacks, DD))
    G = rng.standard_normal((stacks, DD)).astype(np.float32)
    perm = np.stack([rng.permutation(DD) for _ in range(stacks)]).astype(np.int32)
    chi = np.sqrt(rng.chisquare(DD, (stacks, DD)))
    S = (np.sqrt(2.0 / D) * chi / DD).astype(np.float32)
    phase = rng.uniform(0.0, 2.0 * np.pi, f).astype(np.float32)
    wt = (rng.standard_normal((K, f)) * 2.0 / f).astype(np.float32)
    bias = rng.standard_normal(K).astype(np.float32)
    if q8:
        g_q, g_s = quantize.quantize_rows(G)
        s_q, s_s = quantize.quantize_rows(S)
        wt_q, wt_s = quantize.quantize_rows(wt)
        ss = (g_s.astype(np.float64) * s_s).astype(np.float32)
        ops = (quantize.quantize_signs(B), g_q, perm.astype(np.int16), s_q, ss)
        ops += (phase.astype(np.float16), wt_q)
        scales = (wt_s,)
    else:
        ops, scales = (B, G, perm, S, phase, wt), ()

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return tuple(map(dev_t, ops)), tuple(map(dev_t, scales)), dev_t(bias)


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels.common import autotune
    from repro_torch.kernels.fwht import kernel as ff

    parser = argparse.ArgumentParser()
    parser.add_argument("--against", type=Path, help="a fastfood.cu to time in turns")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("fastfood_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    Z = np.random.default_rng(0).random((max(ROWS), D), np.float32)
    Z = torch.from_numpy(Z).to(dev)
    kernels = {"fastfood_score": ff.KERNEL, "fastfood_score_q8": ff.KERNEL_Q8}

    def timed(fn) -> dict:
        best = autotune.measure(fn, repeats=20, warmup=3, device=dev)
        return {"measure_ms": best * 1e3, "device_ms": chip_smoke.device_ms(fn)}

    with tempfile.TemporaryDirectory() as tmp:
        other = {}
        if opts.against is not None:
            lib = build_other(opts.against, Path(tmp))
            for name, k in kernels.items():
                other[name] = OtherBuild(lib, k.symbol, k.argtypes)
        for name, kernel in kernels.items():
            q8 = name.endswith("_q8")
            wrapper = ff.fastfood_score_q8_cuda if q8 else ff.fastfood_score_cuda
            for f in FEATURES:
                stacks = f // DD
                ops, scales, bias = operands(stacks, dev, q8)
                for n in ROWS:
                    Zn = Z[:n]

                    def tile(knl, bn, one):
                        shape = (stacks, DD)
                        return lambda: ff.launch_tile(
                            knl, Zn, ops, shape, scales, bias, bn, one
                        )

                    cell = dict(kernel=name, n=n, f=f)
                    lines = []
                    for bn in BLOCKS:
                        for one in (True, False):
                            if one and stacks != 1:
                                continue  # one launch adds no stacks
                            line = dict(cell, block_n=bn, one_launch=one)
                            line.update(timed(tile(kernel, bn, one)))
                            print(json.dumps(line), flush=True)
                            lines.append(line)
                    ours = lambda: wrapper(Zn, *ops, *scales, bias)  # noqa: E731
                    default = dict(cell, block_n="default", one_launch="default")
                    default.update(timed(ours))
                    print(json.dumps(default), flush=True)
                    for key in ("measure_ms", "device_ms"):
                        best = min(lines, key=lambda x: x[key])
                        best = dict(best, fastest_by=key, default=default[key])
                        print(json.dumps(best), flush=True)
                    if name in other:
                        theirs = tile(other[name], 8, False)
                        turns = (theirs, ours, ours, theirs)
                        turns = [chip_smoke.device_ms(fn) for fn in turns]
                        line = dict(cell, against=str(opts.against))
                        line["against_device_ms"] = [turns[0], turns[3]]
                        line["device_ms"] = turns[1:3]
                        line["max_abs_diff"] = float((theirs() - ours()).abs().max())
                        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
