"""Time one production cell's class trace with FakeTensorMode's dispatch
cache on and off, in turns (off, on, on, off), at one period of layers.

``launch.dryrun`` turns the cache off past FAKE_CACHE_DEVICES mesh
positions, where most lookups miss and a miss costs more than no cache;
this measures whether that still holds once only one position of each
class runs.

  PYTHONPATH=src python scripts/dryrun_cache.py smollm-135m train_4k [--multi-pod]
"""

import argparse
import json
import time

from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.specs import choose_optimizer, choose_rules, pick_backend


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    mesh = dryrun.production_mesh(args.multi_pod)
    shape = SHAPES[args.shape]
    full = pick_backend(dryrun.cell_config(args.arch), shape)
    rules = choose_rules(full, shape, None)
    dp_ways = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    ocfg = choose_optimizer(full, shape, dp_ways=dp_ways)
    cfg = dryrun.cut(full, 1)
    seconds = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        dryrun.FAKE_CACHE_DEVICES = 1 << 20 if label == "on" else 0
        t0 = time.perf_counter()
        dryrun.trace_cell(cfg, shape, mesh, rules, ocfg)
        seconds[label].append(time.perf_counter() - t0)
    cell = dict(arch=args.arch, shape=args.shape, mesh=dryrun.mesh_name(args.multi_pod))
    print(json.dumps({"fake_cache_seconds": seconds, **cell}))


if __name__ == "__main__":
    main()
