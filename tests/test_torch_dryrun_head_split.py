"""The dry run against the JAX package's where the heads do not make whole
head shards of the "model" axis, on the CPU.

Reduced smollm-135m widened to H q and Hkv kv heads (d_model 32 H,
head_dim 32, two layers, global batch 4, T = 64 unless named) on a (1, 4)
("data", "model") mesh. The reference compiles each cell for four forced host devices in one
subprocess (as ``test_torch_dryrun.py``'s ``REF_CODE``, with the mesh and
the heads named); the port traces it on four fake devices, every position
run. Under the rules ``choose_rules`` picks for serving, and DEFAULT for
the train cell.

* q heads that divide "model" (4q/2kv, 8q/2kv; the kv heads do not): each
  member attends with its own q heads, as each of GSPMD's devices does.
  Argument, output and alias bytes and every position's matmul FLOPs
  equal the reference's per-device numbers exactly; so do a decode cell's
  (T = 128), whose route is not this one: every member attends with every
  head, as GSPMD's devices do.
* q heads that do not (6q/2kv, 14q/2kv): the port spreads the group's
  attention over its members by batch rows (``spmd.Lockstep.spread``).
  GSPMD's compiled cells cut "model" into the two kv groups times two
  halves of head_dim: each pair of devices gathers its kv group's q
  heads, both compute the group's scores, and each its half of the value
  columns, 3/8 of the attention a device. The port's positions carry
  equal matmul FLOPs (within 0.1%), none more than the reference's.

And the class trace of a (2, 4) cell on that route, held equal to the
full trace at every position (``test_torch_dryrun_classes``).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_cost import price  # noqa: E402
from repro_torch.launch.specs import choose_rules  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from test_torch_dryrun_classes import _one_thread, assert_class_trace_equals_full  # noqa: E402, F401

REPO = Path(__file__).resolve().parents[1]
NAME, B = "smollm-135m", 4
MESH = ((1, 4), ("data", "model"))
SPREAD_REL = 1e-3
CELLS = {  # (q heads, kv heads, kind, rules, T): whether the dot FLOPs equal the reference's
    (4, 2, "prefill", None, 64): True,
    (8, 2, "prefill", None, 64): True,
    (8, 2, "train", "DEFAULT_RULES", 64): True,
    (8, 2, "decode", None, 128): True,
    (6, 2, "prefill", None, 64): False,
    (14, 2, "prefill", None, 64): False,
}

REF_CODE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax
from repro.configs import ARCHS
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.launch.profile_cell import profile
from repro.launch.specs import build_cell, choose_rules, pick_backend
from repro.sharding import partitioning
from repro.sharding.hints import use_hints

name, B, (sizes, axes), cells = json.loads(sys.argv[1])
mesh = make_mesh(tuple(sizes), tuple(axes))
for H, Hkv, kind, rules_name, T in cells:
    rules = getattr(partitioning, rules_name) if rules_name else None
    cfg = dataclasses.replace(ARCHS[name].reduced(), n_heads=H, n_kv_heads=Hkv, d_model=32 * H)
    shape = ShapeConfig("c", T, B, kind)
    cell = build_cell(cfg, shape, mesh, rules)
    active = choose_rules(pick_backend(cfg, shape), shape, rules)
    with mesh, use_hints(mesh, active):
        c = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings,
                    donate_argnums=cell.donate_argnums).lower(*cell.args).compile()
    ma = c.memory_analysis()
    print(json.dumps(dict(
        cell=[H, Hkv, kind, rules_name, T], argument=ma.argument_size_in_bytes,
        output=ma.output_size_in_bytes, alias=ma.alias_size_in_bytes,
        dot=profile(c.as_text())[0]["dot"])), flush=True)
"""


class Reference:
    """The subprocess that prints the reference's per-device numbers, one
    JSON line a cell, started once and read at the first ``row``: it runs
    while the port traces."""

    def __init__(self, cells):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        arg = json.dumps([NAME, B, MESH, [list(c) for c in cells]])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REF_CODE, arg],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
        )
        self.rows = None

    def row(self, cell) -> dict:
        if self.rows is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, out[-2000:] + err[-3000:]
            lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
            self.rows = {tuple(r["cell"]): r for r in lines}
        return self.rows[cell]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture(scope="module")
def reference():
    ref = Reference(CELLS)
    yield ref
    ref.close()


def config(H: int, Hkv: int):
    return dataclasses.replace(ARCHS[NAME].reduced(), n_heads=H, n_kv_heads=Hkv, d_model=32 * H)


@functools.cache
def port(H: int, Hkv: int, kind: str, rules_name, T: int) -> dict:
    """The port's full trace of a cell: per position argument, output and
    alias bytes, and matmul FLOPs."""
    cfg, shape = config(H, Hkv), ShapeConfig("c", T, B, kind)
    rules = choose_rules(cfg, shape, getattr(part, rules_name) if rules_name else None)
    t = dryrun.trace_cell(cfg, shape, dryrun.fake_mesh(*MESH), rules, classes=False)
    n = len(t["arguments"])
    per = [price(t["records"], t["counts"].get(f"meta:{p}", {})) for p in range(n)]
    return dict(
        argument=t["arguments"],
        output=t["outputs"],
        alias=t["aliases"],
        matmul=[sum(x["matmul_flops"].values()) for x in per],
    )


@pytest.mark.parametrize("cell", [c for c, exact in CELLS.items() if exact], ids=str)
def test_head_shards_equal_the_reference(reference, cell):
    """Each member its own q heads: bytes and every position's matmul FLOPs
    exactly the reference's (attention once a group, on its first member,
    put 62,914,560 on position 0 and 46,137,344 on the others against
    50,331,648 for 4q/2kv)."""
    got, want = port(*cell), reference.row(cell)
    assert got["argument"] == [want["argument"]] * 4, cell
    assert got["output"] == [want["output"]] * 4, cell
    assert got["alias"] == [want["alias"]] * 4, cell
    assert got["matmul"] == [want["dot"]] * 4, (cell, got["matmul"], want["dot"])


@pytest.mark.parametrize("cell", [c for c, exact in CELLS.items() if not exact], ids=str)
def test_rows_route_is_even_and_within_the_reference(reference, cell):
    """The group's attention spread by rows: every position's matmul FLOPs
    within SPREAD_REL of the others' and at most the reference's dot
    FLOPs (attention once a group, on its first member: 100,663,296 at
    position 0 against 84,934,656 for 6q/2kv)."""
    got, want = port(*cell), reference.row(cell)
    mm = got["matmul"]
    assert max(mm) <= min(mm) * (1 + SPREAD_REL), (cell, mm)
    assert max(mm) <= want["dot"], (cell, mm, want["dot"])


@pytest.mark.parametrize("kind, rules", [("prefill", "TP_ONLY_RULES"), ("train", "DEFAULT_RULES")])
def test_class_trace_on_the_rows_route(kind, rules):
    """6q/2kv on a (2, 4) mesh: 6 heads do not divide model = 4, so q is
    all-to-all'd to batch rows and back; the class trace (4 of 8
    positions run, the others standing in) equals the full trace."""
    got, _ = assert_class_trace_equals_full(
        NAME, kind, rules, sizes=(2, 4), changes=dict(n_heads=6, n_kv_heads=2, d_model=192)
    )
    kinds = {k[0] for ks in got["calls"].values() for k in ks}
    assert "all-to-all" in kinds
