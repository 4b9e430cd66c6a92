"""Peak rate of the card's legacy tensor-core MMAs (``mma.sync``), as the
hand-written kernels issue them: m16n8k8 on TF32 operands (B1, B2, B4, B5
and the f32 tile engine) and m16n8k16 on bf16 (B9 bf16).

Each warp issues MMAs from registers into ``acc`` independent accumulators
(each MMA waits on the one ``acc`` before it), with no memory traffic. The
peak runs 8 blocks of 8 warps an SM, 8 accumulators deep; the TF32 rows at
one and two blocks an SM, 16 deep, are the shape of B4/B5's warps (8 warps
an SM, 16 fragments a warp). Prints one JSON line per row with the card's
name and power limit.

    python3 scripts/mma_peak.py        # on a machine with a CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "ptx.cuh"

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kBf16, int kAcc>
__global__ void spin(float* out, int iters) {
  float acc[kAcc][4] = {};
  const uint32_t x = 0x3f800000u ^ (threadIdx.x << 13);
  const uint32_t a[4] = {x, x ^ 1u, x ^ 2u, x ^ 3u};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      if constexpr (kBf16) mma_bf16(acc[j], a, x + j, x - j);
      else ptx::mma_tf32(acc[j], a, x + j, x - j);
    }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 1.2345f) out[threadIdx.x] = s;  // keeps the MMAs
}

extern "C" int run(int bf16, int acc, int blocks, int iters, float* out) {
  if (bf16) spin<true, 8><<<blocks, 256>>>(out, iters);
  else if (acc == 16) spin<false, 16><<<blocks, 256>>>(out, iters);
  else spin<false, 8><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("mma_peak: no CUDA device is available", file=sys.stderr)
        return 2
    work = ROOT / "build" / "mma_peak"
    work.mkdir(parents=True, exist_ok=True)
    (work / "mma_peak.cu").write_text(SOURCE)
    lib_path = work / "mma_peak.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib_path)]
    subprocess.run(cmd + [str(work / "mma_peak.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(256, device="cuda")
    iters = 4096
    rows = (  # (bf16, shape, flops an MMA, accumulators, blocks an SM)
        (0, "m16n8k8.tf32", 2 * 16 * 8 * 8, 8, 8),
        (1, "m16n8k16.bf16", 2 * 16 * 8 * 16, 8, 8),
        (0, "m16n8k8.tf32", 2 * 16 * 8 * 8, 16, 1),
        (0, "m16n8k8.tf32", 2 * 16 * 8 * 8, 16, 2),
    )
    for bf16, shape, flops, acc, per_sm in rows:
        blocks = per_sm * sms
        for _ in range(2):  # warm-up, then the timed launch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.run(bf16, acc, blocks, iters, ctypes.c_void_p(out.data_ptr()))
            assert err == 0, err
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end)
        mmas = blocks * 8 * iters * acc  # blocks x warps x iterations x accumulators
        line = {"card": card, "mma": shape, "accumulators": acc}
        line.update(warps_per_sm=8 * per_sm, ms=ms, tflops=mmas * flops / ms / 1e9)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
