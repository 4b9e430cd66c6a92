"""Kernels B6 and B7 (``csrc/fastfood.cu``) against variants of their own
body, on one card in one process: what each part of the design costs.

Each variant is a text substitution on the source, compiled by nvcc (with
only the d' = 1024 instantiation, to build fast) into its own library
under ``build/fastfood_variants/``, and launched through
``fwht.kernel.launch_tile`` on seeded operators. Variants:

- ``as_built``: the source as it is;
- ``no_cos``: the projection plus phase in place of its cos (wrong values);
- ``no_readout``: no readout MMAs (the partial tiles are zeros);
- ``no_rows``: no row work at all (no transforms, gather or cos), what the
  staging, the readout and the launch cost;
- ``staging_only``: neither rows nor readout;
- ``w8_slice_from_l2``: eight warps a block (two rows each a tile) and
  the slice read from L2, so that two blocks fit an SM;
- ``slice_from_l2``: the readout's fragments load the readout slice from
  L2 instead of from its copy in shared memory;
- ``cos_select``: cos_rn's arithmetic with both polynomials evaluated and
  one selected, in place of its branch on the quadrant (the same values).

Prints the card line, one ``compiled`` line per variant (registers, stack
and local bytes of each body) and one JSON line per (variant, pass, kernel,
n, F, block_n, launches) with ``device_ms`` (``chip_smoke.device_ms``); the
variants run in order, then in reverse.

    python3 scripts/fastfood_variants.py    # on a machine with a CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

CELLS = ((1024, 4096, 16, False), (1024, 4096, 32, False), (1024, 1024, 16, True))
CELLS += ((32, 4096, 16, False),)  # (n, F, block_n, one launch)
ONLY_1024 = [
    (f"    case {dd}: err = launch_tile<kInt8, {dd}>(a); break;\n", "")
    for dd in (2, 4, 8, 16, 32, 64, 128, 256, 512, 2048)
]
COS = "buf[p] = cos_rn(__fadd_rn(__fmul_rn(buf[p], sp.x), sp.y));"
READOUT = "readout<kInt8, DD>(acc, ct, ws, ws_ld<kInt8, DD>(), kh, warp, lane);"
ROWS = "row_wide<DD>(t0 + tr < row_end, d, Bs, GP, SP, buf, l);"
WT_SMEM = "static constexpr bool kWtSmem = DD >= 64 && DD <= 1024;"
BOUNDS = "__launch_bounds__(Geo<DD>::kThreads, 1)"
# cos_rn's arithmetic with both polynomials evaluated and one selected, in
# place of its branch on the quadrant: the same values.
COS_SELECT = """#include "ptx.cuh"

namespace {
__device__ __forceinline__ float cos_select(float a) {
  const float j = rintf(__fmul_rn(a, 0x1.45f306p-1f));
  float r = fmaf(j, -0x1.921fb4p+0f, a);
  r = fmaf(j, -0x1.4442d2p-24f, r);
  r = fmaf(j, 0x1.ee59dap-50f, r);
  int q = (int)j;
  if (!(fabsf(a) <= 105615.0f)) r = reduce_large(a, q);
  const float z = __fmul_rn(r, r);
  float ps = fmaf(-0x1.9943f2p-13f, z, 0x1.11073cp-7f);
  ps = fmaf(ps, z, -0x1.555546p-3f);
  const float vs = fmaf(__fmul_rn(ps, z), r, r);
  float pc = fmaf(0x1.99eb9cp-16f, z, -0x1.6c0c34p-10f);
  pc = fmaf(pc, z, 0x1.55554ap-5f);
  pc = fmaf(pc, z, -0.5f);
  const float vc = fmaf(pc, z, 1.0f);
  const float v = (q & 1) ? vs : vc;
  return ((q + 1) & 2) ? -v : v;
}
}  // namespace
"""
VARIANTS = {
    "as_built": [],
    "no_cos": [(COS, "buf[p] = __fadd_rn(__fmul_rn(buf[p], sp.x), sp.y);")],
    "no_readout": [(READOUT, "")],
    "no_rows": [(ROWS, "")],
    "staging_only": [(ROWS, ""), (READOUT, "")],
    "w8_slice_from_l2": [
        ("DD <= 1024 ? 16 : 8;", "8;"),
        (BOUNDS, BOUNDS.replace(", 1)", ", 2)")),
        (WT_SMEM, "static constexpr bool kWtSmem = false;"),
    ],
    "slice_from_l2": [(WT_SMEM, "static constexpr bool kWtSmem = false;")],
    "cos_select": [
        ('#include "ptx.cuh"\n', COS_SELECT),
        (COS, COS.replace("cos_rn", "cos_select")),
    ],
}


def main() -> int:
    import torch

    import chip_smoke
    from fastfood_sweep import OtherBuild, operands
    from repro_torch.kernels import build
    from repro_torch.kernels.fwht import kernel as ff

    if not torch.cuda.is_available():
        print("fastfood_variants: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    out = ROOT / "build" / "fastfood_variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "fastfood.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in ONLY_1024 + subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in fastfood.cu")
            text = text.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC)]
        cmd += ["-o", str(out / f"{name}.so"), str(src)]
        jobs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
    libs = {}
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log.decode()[:4000]}")
        lib = out / f"{name}.so"
        usage = subprocess.run(
            [str(cuobjdump), "-res-usage", str(lib)], capture_output=True, text=True
        ).stdout
        bodies = {
            k.split("fastfood_tile")[1][:12]: v
            for k, v in chip_smoke.read_compiled("", usage).items()
            if "fastfood_tile" in k
        }
        print(json.dumps({"compiled": name, **bodies}), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].repro_error_string.argtypes = [ctypes.c_int]
        libs[name].repro_error_string.restype = ctypes.c_char_p
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    Z = torch.rand((1024, 780), generator=torch.Generator().manual_seed(0)).to(dev)
    inputs = {
        (f, q8): operands(f // 1024, dev, q8)
        for f in (1024, 4096)
        for q8 in (False, True)
    }
    order = list(VARIANTS)
    for pass_, names in enumerate((order, order[::-1])):
        for name in names:
            lib = libs[name]
            for kernel in (ff.KERNEL, ff.KERNEL_Q8):
                q8 = kernel is ff.KERNEL_Q8
                shim = OtherBuild(lib, kernel.symbol, kernel.argtypes)
                for n, f, bn, one in CELLS:
                    ops, scales, bias = inputs[f, q8]
                    Zn = Z[:n]

                    def fn():
                        shape = (f // 1024, 1024)
                        return ff.launch_tile(
                            shim, Zn, ops, shape, scales, bias, bn, one
                        )

                    row = dict(variant=name, pass_=pass_, kernel=kernel.name, n=n, f=f)
                    row.update(block_n=bn, one_launch=one)
                    row["device_ms"] = chip_smoke.device_ms(fn)
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
