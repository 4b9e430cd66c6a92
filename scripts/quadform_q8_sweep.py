"""Kernel B3 (``quadform_heads_q8_cuda``) over its tile choices, on one card.

Every ``block_n`` the source is compiled for (32, 64, 128) against every
split count of the Hessian's column tiles (1 .. 13 at d=780) and the
wrapper's default (``splits`` None: about two blocks an SM), at n = 32 and
1024 rows, K=10 heads, d=780: the shapes of ``chip_smoke.py``'s second
path. Prints the card line, then one JSON line per (n, block_n, splits):
``measure_ms``, the best of 20 calls each timed alone by
``autotune.measure`` (CUDA events after a synchronize, so at n=32 it holds
the host's launch), and ``device_ms``, the mean of 20 calls queued behind
a spinning kernel (``chip_smoke.device_ms``); then, per n, the fastest
configuration by each reading beside the default's.

    python3 scripts/quadform_q8_sweep.py     # on a machine with a CUDA card and nvcc
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

K, D, ROWS = 10, 780, (32, 1024)


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.core.families import quantize
    from repro_torch.kernels.common import TileConfig, autotune, tiles
    from repro_torch.kernels.quadform import kernel as qf

    if not torch.cuda.is_available():
        print("quadform_q8_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    M = rng.standard_normal((K, D, D)).astype(np.float32) * 1e-2
    M_q, scale = quantize.quantize_col_groups((M + M.transpose(0, 2, 1)) / 2)
    col = quantize.expand_group_scales(scale, D)
    Z = rng.random((max(ROWS), D)).astype(np.float32)
    V = rng.standard_normal((K, D)).astype(np.float32) * 0.1
    c, b = rng.standard_normal((2, K)).astype(np.float32)
    gamma = np.full(K, 1e-4, np.float32)
    msq = np.full(K, 0.3 * D, np.float32)
    args = [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (M_q, col, V, c, b, gamma, msq)
    ]
    Zd = torch.from_numpy(Z).to(dev)
    launch = qf.quadform_heads_q8_cuda

    def timed(fn) -> dict:
        best = autotune.measure(fn, repeats=20, warmup=3, device=dev)
        return {"measure_ms": best * 1e3, "device_ms": chip_smoke.device_ms(fn)}

    for n in ROWS:
        Zn = Zd[:n]
        lines = []
        for block_n in qf.BLOCK_N:
            if TileConfig(block_n=block_n).clamp_block_n(n).block_n != block_n:
                continue  # the wrapper runs a smaller block at this n
            for splits in (None, *range(1, tiles.grid_blocks(D, qf.BLOCK_J) + 1)):
                cfg = TileConfig(block_n=block_n, splits=splits)
                line = dict(n=n, block_n=block_n, splits=splits)
                line.update(timed(lambda: launch(Zn, *args, config=cfg)))
                print(json.dumps(line), flush=True)
                lines.append(line)
        line = dict(n=n, block_n="default", splits="default")  # the wrapper's tiles
        line.update(timed(lambda: launch(Zn, *args)))
        print(json.dumps(line), flush=True)
        for key in ("measure_ms", "device_ms"):
            best = min(lines, key=lambda x: x[key])
            print(json.dumps({"n": n, "fastest_by": key, **best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
