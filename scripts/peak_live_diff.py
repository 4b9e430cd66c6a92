"""What is live at the peak of a prefill step, on fake devices and on the
card: ``smollm-135m`` at full width and depth, a bf16 flash prefill of 4 x
2048 tokens on a 1 x 1 mesh (path 14's cell), traced once on a fake
``meta:0`` (``launch.dryrun``) and run once on ``cuda:0``, each under a
``launch.op_cost.CostRecorder`` that also keeps every live storage's
origin (the op that made it, its shape and dtype). Prints the card's name
and power limit, then for each side the peak of new bytes and the
storages live at that moment, largest first.

    python3 scripts/peak_live_diff.py        # on a machine with a CUDA card
"""

from __future__ import annotations

import collections
import dataclasses
import subprocess
import sys
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.build import build_all, card_stand_in
    from repro_torch.launch import dryrun, make_mesh
    from repro_torch.launch.op_cost import CostRecorder, _base
    from repro_torch.launch.specs import build_cell

    if not torch.cuda.is_available():
        print("peak_live_diff: no CUDA device is available", file=sys.stderr)
        return 2

    class Live(CostRecorder):
        """The recorder, with each live storage's origin and a snapshot of
        them at the peak."""

        def __init__(self):
            super().__init__()
            self.origin, self.best, self.snapshot, self.op = {}, 0, None, None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.op = _base(func)
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _track(self, outs, ins):
            held = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                st = t.untyped_storage()
                if st._cdata not in held:
                    key = id(st)
                    self.origin[key] = (self.op, tuple(t.shape), str(t.dtype), st.nbytes())
                    weakref.finalize(st, self.origin.pop, key, None)
            super()._track(outs, ins)
            top = max(self.live.values(), default=0)
            if top > self.best:
                self.best, self.snapshot = top, collections.Counter(self.origin.values())

    def show(side: str, rec: Live) -> None:
        print(f"{side}: peak {rec.best} B of new storage")
        for (op, shape, dtype, nbytes), n in sorted(rec.snapshot.items(), key=lambda kv: -kv[0][3] * kv[1]):
            print(f"   {n:3d} x {op} {list(shape)} {dtype} ({nbytes} B)")

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    cfg = dataclasses.replace(get_config("smollm-135m"), attention_impl="flash")
    shape = ShapeConfig("prefill", 2048, 4, "prefill")
    build_all(["flash_attn.cu"])
    with FakeTensorMode(), card_stand_in():
        cell = build_cell(cfg, shape, dryrun.fake_mesh((1, 1), ("data", "model")), None)
        with Live() as fake:
            cell.step_fn(*cell.args)
    show("fake meta:0", fake)
    cell = build_cell(cfg, shape, make_mesh((1, 1), ("data", "model"), devices=["cuda:0"]), None)
    with Live() as card:
        cell.step_fn(*cell.args)
    torch.cuda.synchronize()
    show("cuda:0", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
