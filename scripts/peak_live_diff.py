"""What is live at the peak of a prefill step, on fake devices and on the
card: ``smollm-135m`` at full width and depth, a bf16 flash prefill of 4 x
2048 tokens on a 1 x 1 mesh (path 14's cell), traced once on a fake
``meta:0`` (``launch.dryrun``) and run once on ``cuda:0``, each under a
``launch.op_cost.CostRecorder`` that also keeps every live storage's
origin (the op that made it, its shape and dtype). Prints the card's name
and power limit, then for each side the peak of new bytes and the
storages live at that moment, largest first.

With ``--cycles``: what a prefill leaves to Python's cycle collector on
the card. For flash and maclaurin attention, on the 1 x 1 mesh and on a
(data, model) mesh of 2 x 2 slots of the card, a warm prefill, then one
under ``gc.disable()`` and ``gc.DEBUG_SAVEALL``, without and then with a
``CostRecorder`` around it: ``gc.collect()`` then lists the unreachable
objects. Prints their count by type, the tensors among them (shape, dtype,
device) and, for each kind of object that refers to such a tensor, its
description (a frame's function and line, a function's name), so that the
cycle's owner can be named.

With ``--cell ARCH SHAPE [--multi-pod]``: what is live at the peak of
each class representative of one production cell of the dry run
(``launch.dryrun``'s 16 x 16 or 2 x 16 x 16 mesh of fake devices, one
period of layers, the cell's rules and optimizer), largest first. No card
is needed, but a full-width trace wants a large host.

    python3 scripts/peak_live_diff.py             # on a machine with a CUDA card
    python3 scripts/peak_live_diff.py --cycles
    python3 scripts/peak_live_diff.py --cell yi-34b prefill_32k
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import subprocess
import sys
import types
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def describe(obj) -> str:
    """A short name for an object the cycle collector found."""
    if isinstance(obj, types.FrameType):
        return f"frame {obj.f_code.co_name} ({Path(obj.f_code.co_filename).name}:{obj.f_lineno})"
    if isinstance(obj, types.FunctionType):
        return f"function {obj.__module__}.{obj.__qualname__}"
    if isinstance(obj, types.MethodType):
        return f"method {obj.__qualname__}"
    if isinstance(obj, types.CellType):
        return "cell"
    if isinstance(obj, dict):
        return f"dict keys {sorted(map(str, obj))[:6]}"
    if isinstance(obj, (list, tuple)):
        return f"{type(obj).__name__} of {len(obj)}"
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


def unreachable(step) -> dict:
    """Run ``step()`` with the cycle collector off and every unreachable
    object kept; what ``gc.collect()`` then found: {"objects", "by_type",
    "tensors", "tensor_bytes", "holders"}."""
    import torch

    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        step()
        torch.cuda.synchronize()
        gc.collect()
        found = list(gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    tensors = [o for o in found if isinstance(o, torch.Tensor)]
    ids = {id(t) for t in tensors}
    holders = collections.Counter()
    for o in found:
        if any(id(r) in ids for r in gc.get_referents(o)) and not isinstance(o, torch.Tensor):
            holders[describe(o)] += 1
    frames = collections.Counter(describe(o) for o in found if isinstance(o, types.FrameType))
    out = {
        "objects": len(found),
        "by_type": dict(collections.Counter(type(o).__name__ for o in found).most_common(12)),
        "tensors": dict(collections.Counter(f"{list(t.shape)} {t.dtype} {t.device}" for t in tensors)),
        "tensor_bytes": sum(t.untyped_storage().nbytes() for t in tensors),
        "holders": dict(holders.most_common(12)),
        "frames": dict(frames.most_common(12)),
    }
    del found, tensors
    return out


def cycles() -> int:
    """``--cycles``: the unreachable objects of one prefill, by route and
    mesh, with and without the recorder."""
    import json

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.build import build_all
    from repro_torch.launch import make_mesh
    from repro_torch.launch.op_cost import CostRecorder
    from repro_torch.launch.specs import build_cell

    build_all(["flash_attn.cu", "maclaurin_attn.cu"])
    dev = torch.device("cuda", 0)
    shape = ShapeConfig("prefill", 2048, 4, "prefill")
    for impl, backend in (("flash", "softmax"), ("blockwise", "maclaurin")):
        cfg = dataclasses.replace(get_config("smollm-135m"), attention_impl=impl, attention_backend=backend)
        for sizes in ((1, 1), (2, 2)):
            mesh = make_mesh(sizes, ("data", "model"), devices=[dev] * (sizes[0] * sizes[1]))
            cell = build_cell(cfg, shape, mesh, None)
            cell.step_fn(*cell.args)  # warm: kernels loaded, tables read

            def recorded():
                with CostRecorder():
                    cell.step_fn(*cell.args)

            for label, step in (("plain", lambda: cell.step_fn(*cell.args)), ("recorder", recorded)):
                got = unreachable(step)
                row = dict(route=backend if backend == "maclaurin" else impl, mesh=list(sizes), run=label, **got)
                print("cycles:", json.dumps(row, sort_keys=True), flush=True)
            del cell
            gc.collect()
            torch.cuda.empty_cache()
    return 0


def live_recorder():
    """``launch.op_cost.CostRecorder`` with each live storage's origin (the
    op that made it, its shape, dtype and bytes) and, for each device, a
    snapshot of them at its peak (``snapshot[dev]``, ``best[dev]``)."""
    from repro_torch.launch.op_cost import CostRecorder, _base

    class Live(CostRecorder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.origin = collections.defaultdict(dict)
            self.best, self.snapshot, self.op = collections.Counter(), {}, None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.op = _base(func)
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _track(self, outs, ins):
            held = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                st, dev = t.untyped_storage(), str(t.device)
                if st._cdata not in held and dev not in self.skip:
                    held.add(st._cdata)
                    self.origin[dev][id(st)] = (self.op, tuple(t.shape), str(t.dtype), st.nbytes())
                    weakref.finalize(st, self.origin[dev].pop, id(st), None)
            super()._track(outs, ins)
            for dev in {str(t.device) for t in outs} - self.skip:
                if self.live[dev] > self.best[dev]:
                    self.best[dev] = self.live[dev]
                    self.snapshot[dev] = collections.Counter(self.origin[dev].values())

    return Live


def show(side: str, rec, dev: str, top: int | None = None) -> None:
    print(f"{side}: peak {rec.best[dev]} B of new storage")
    items = sorted(rec.snapshot.get(dev, {}).items(), key=lambda kv: -kv[0][3] * kv[1])
    for (op, shape, dtype, nbytes), n in items[:top]:
        print(f"   {n:3d} x {op} {list(shape)} {dtype} ({nbytes} B)")


def cell_peak(arch: str, shape_name: str, multi_pod: bool) -> int:
    """``--cell``: the live set at each class representative's peak of one
    production cell, one period of layers, on fake devices."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import choose_optimizer, choose_rules, pick_backend
    from repro_torch.sharding.spmd import class_reps

    shape = SHAPES[shape_name]
    cfg = pick_backend(dryrun.cell_config(arch), shape)
    rules = choose_rules(cfg, shape, None)
    mesh = dryrun.production_mesh(multi_pod)
    dp_ways = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    ocfg = choose_optimizer(cfg, shape, dp_ways=dp_ways)
    Live, made = live_recorder(), []

    def recorder(**kwargs):  # the trace's recorder, kept to be read after it
        made.append(Live(**kwargs))
        return made[-1]

    dryrun.CostRecorder = recorder
    dryrun.trace_cell(dryrun.cut(cfg, 1), shape, mesh, rules, ocfg)
    for p in sorted(set(class_reps(mesh.sizes))):
        dev = str(mesh.devices[p])
        show(f"{arch} {shape_name} {dryrun.mesh_name(multi_pod)}, one period, position {p} ({dev})", made[0], dev, 25)
    return 0


def main() -> int:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.build import build_all, card_stand_in
    from repro_torch.launch import dryrun, make_mesh
    from repro_torch.launch.specs import build_cell

    if sys.argv[1:2] == ["--cell"]:
        return cell_peak(sys.argv[2], sys.argv[3], sys.argv[4:5] == ["--multi-pod"])
    if not torch.cuda.is_available():
        print("peak_live_diff: no CUDA device is available", file=sys.stderr)
        return 2

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    if sys.argv[1:2] == ["--cycles"]:
        return cycles()

    Live = live_recorder()
    cfg = dataclasses.replace(get_config("smollm-135m"), attention_impl="flash")
    shape = ShapeConfig("prefill", 2048, 4, "prefill")
    build_all(["flash_attn.cu"])
    with FakeTensorMode(), card_stand_in():
        cell = build_cell(cfg, shape, dryrun.fake_mesh((1, 1), ("data", "model")), None)
        with Live() as fake:
            cell.step_fn(*cell.args)
    show("fake meta:0", fake, "meta:0")
    cell = build_cell(cfg, shape, make_mesh((1, 1), ("data", "model"), devices=["cuda:0"]), None)
    with Live() as card:
        cell.step_fn(*cell.args)
    torch.cuda.synchronize()
    show("cuda:0", card, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
