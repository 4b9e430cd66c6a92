"""Trace a part of the dry run's grid, a process a cell, several at a time.

Each (arch, shape, mesh) cell runs ``python -m repro_torch.launch.dryrun
--arch A --shape S [--multi-pod] --force`` in a process of its own (which
traces its depths in worker processes of its own); ``--jobs`` cells run at
once. Each cell's wall seconds, exit code and summary line go to ``--log``
(one JSON line a cell) as it ends; the cells' results are the dry run's
own files under ``results/dryrun_torch``. Then ``python -m
repro_torch.launch.roofline --keep`` rewrites ``results/roofline_torch.
{md,json}``: the traced cells' rows anew, every other row as it was.

    PYTHONPATH=src python3 scripts/dryrun_grid.py --shapes prefill_32k decode_32k long_500k \\
        --jobs 6 --log grid.jsonl
    PYTHONPATH=src python3 scripts/dryrun_grid.py --cells yi-34b:prefill_32k yi-34b:train_4k --log grid.jsonl

``--cells`` names (arch, shape) pairs instead of ``--shapes`` x ``--archs``,
run in the order named (longest first: none then ends the run alone),
each on both meshes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--archs", nargs="+", default=sorted(ARCHS), choices=sorted(ARCHS))
    ap.add_argument("--cells", nargs="+", default=None, metavar="ARCH:SHAPE")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--log", type=Path, required=True)
    args = ap.parse_args()

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    pairs = [(a, s) for s in args.shapes for a in args.archs]
    if args.cells:
        pairs = [tuple(c.split(":")) for c in args.cells]
        bad = [c for c in pairs if c[0] not in ARCHS or c[1] not in SHAPES]
        if bad:
            ap.error(f"no such cells: {bad}")
    todo = [(arch, shape, multi_pod) for arch, shape in pairs for multi_pod in (False, True)]
    if not args.cells:  # the longest cells first, so that they do not end the run alone
        todo.sort(key=lambda c: (c[0] != "zamba2-2.7b", c[1] != "prefill_32k", not c[2]))
    args.log.parent.mkdir(parents=True, exist_ok=True)
    running: dict = {}
    failed = 0
    t_all = time.time()
    with open(args.log, "w") as log:
        while todo or running:
            while todo and len(running) < args.jobs:
                arch, shape, multi_pod = cell = todo.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--force"]
                if multi_pod:
                    cmd.append("--multi-pod")
                proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                running[proc] = (cell, time.time())
            time.sleep(1)
            for proc in [p for p in running if p.poll() is not None]:
                (arch, shape, multi_pod), t0 = running.pop(proc)
                out = proc.stdout.read()
                lines = [ln for ln in out.splitlines() if ln.startswith(("OK ", "FAIL "))]
                row = dict(arch=arch, shape=shape, mesh="2x16x16" if multi_pod else "16x16",
                           rc=proc.returncode, wall_s=round(time.time() - t0, 1),
                           line=lines[0] if lines else out[-2000:])
                failed += proc.returncode != 0
                log.write(json.dumps(row) + "\n")
                log.flush()
                print(json.dumps(row), flush=True)
    print(f"grid: {failed} failed, {round(time.time() - t_all, 1)} s of wall", flush=True)
    roof = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--keep"], cwd=ROOT, env=env,
                          capture_output=True, text=True)
    print(roof.stdout[-400:], roof.stderr[-2000:], flush=True)
    return 1 if failed or roof.returncode else 0


if __name__ == "__main__":
    sys.exit(main())
