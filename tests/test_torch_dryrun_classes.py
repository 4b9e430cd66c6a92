"""The dry run's class trace against the full trace, on the CPU.

A class trace runs one mesh position of each class (``spmd.class_reps``:
the positions with coordinate 0 or 1 on every axis), every other member of
a group it runs standing in with a tensor of its representative's shape,
and ``launch.dryrun`` gives every other position its class's counts. Here
the same cell is traced both ways on a (4, 4) mesh of fake devices (4 of
16 positions run) and held equal at every one of the 16 positions: flops,
bytes and matmul flops by dtype (priced from its records), the records
themselves, the peak, B8/B9 launches and the collective records phase by
phase; and over the program, every collective call (kind, bytes, group
size) as the calls each class's representative joins times its class's
size, a call counted once at each place it spans (``dryrun.
program_calls``), and the host's counts. Reduced configs at one layer:

* smollm-135m's train step under DEFAULT (FSDP over "data", and 2 kv heads
  that do not divide model = 4: k and v gathered, each member attends
  with its own q head, each its ``w_o`` rows);
* its SP prefill (the residual cut along the sequence).

(the optimizer options: ``..._classes_optim.py``; qwen3-moe's EP_DP step:
``..._classes_moe.py``; a TP_ONLY decode and the
pod axis: ``..._classes_pod.py``; the 2 x 16 x 16 mesh through the CLI:
``test_torch_dryrun_multipod.py``.) A block that differs in shape from its
class representative's raises.
"""

import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_cost import price  # noqa: E402
from repro_torch.launch.specs import build_cell, choose_rules  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402
from repro_torch.train.train_step import OptimizerConfig  # noqa: E402

OCFG = OptimizerConfig(warmup=2, total_steps=10)
AXES = ("data", "model")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(trace: dict, dev: str) -> collections.Counter:
    return collections.Counter({trace["records"][i]: c for i, c in trace["counts"].get(dev, {}).items()})


def _launches(trace: dict, dev: str) -> collections.Counter:
    return collections.Counter(
        {rec[0]: c for rec, c in _records(trace, dev).items() if rec[3] is not None}
    )


def assert_class_trace_equals_full(
    name, kind, rules, sizes=(4, 4), axes=AXES, T=16, B=16, ocfg=OCFG, changes=None
):
    cfg = dataclasses.replace(ARCHS[name].reduced(), n_layers=1, **(changes or {}))
    shape = ShapeConfig("c", T, B, kind)
    rules = choose_rules(cfg, shape, getattr(part, rules))
    ocfg = ocfg if kind == "train" else None
    mesh = dryrun.fake_mesh(sizes, axes)
    got = dryrun.trace_cell(cfg, shape, mesh, rules, ocfg)
    full = dryrun.trace_cell(cfg, shape, mesh, rules, ocfg, classes=False)
    rep = spmd.class_reps(mesh.sizes)
    assert got["run"] == sorted(set(rep)) and len(got["run"]) < mesh.size
    devs = [str(d) for d in mesh.devices]
    for p in range(mesh.size):
        mine, want = devs[rep[p]], devs[p]
        what = (name, kind, p)
        assert price(got["records"], got["counts"][mine]) == price(full["records"], full["counts"][want]), what
        assert _records(got, mine) == _records(full, want), what
        assert got["peak"][mine] == full["peak"][want], what
        assert _launches(got, mine) == _launches(full, want), what
        phases = lambda t, d: {ph: c for (ph, x), c in t["collectives"].items() if x == d}  # noqa: E731
        assert phases(got, mine) == phases(full, want), what
    size = collections.Counter(rep)
    calls = dryrun.program_calls([got["collectives"]], lambda d: size[devs.index(d)], 1)
    assert calls == collections.Counter(c for cs in full["calls"].values() for c in cs) and calls
    for host in set(full["counts"]) - set(devs):
        assert price(got["records"], got["counts"][host]) == price(full["records"], full["counts"][host])
    return got, full


@pytest.mark.parametrize(
    "name, kind, rules",
    [
        ("smollm-135m", "train", "DEFAULT_RULES"),
        ("smollm-135m", "prefill", "SP_RULES"),
    ],
)
def test_class_trace_equals_the_full_trace(name, kind, rules):
    assert_class_trace_equals_full(name, kind, rules)


def test_a_block_unlike_its_representative_raises():
    """Position 2's block of the LM head cut short by hand: a class trace
    of a (1, 4) mesh, which runs positions 0 and 1, would need a stand-in
    of another shape than position 1's for it, and raises."""
    cfg = dataclasses.replace(ARCHS["smollm-135m"].reduced(), n_layers=1)
    with FakeTensorMode():
        mesh = dryrun.fake_mesh((1, 4), AXES)
        cell = build_cell(cfg, ShapeConfig("p", 16, 4, "prefill"), mesh, part.TP_ONLY_RULES)
        params = dict(cell.args[0])
        head = params["lm_head"]["w"]
        shards = list(head.shards)
        shards[2] = shards[2][:, :8]
        params["lm_head"] = {"w": dataclasses.replace(head, shards=tuple(shards))}
        spmd.Lockstep(cfg, mesh, part.TP_ONLY_RULES, params, 4)  # every position run: no stand-in
        with pytest.raises(ValueError, match="position 2's block"):
            spmd.Lockstep(cfg, mesh, part.TP_ONLY_RULES, params, 4, run=spmd.class_reps((1, 4)))
