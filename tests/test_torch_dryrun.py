"""The dry run (``launch.dryrun``, ``launch.op_cost``) against the JAX
package's, on the CPU: reduced smollm-135m, and the cost model's parts.

The reference compiles each cell for a (2, 2) mesh of four forced host
devices in one subprocess (``XLA_FLAGS=--xla_force_host_platform_device_
count=4``, as ``tests/test_sharding.py`` lowers its cells) and reads
``memory_analysis()``, the dot FLOPs of ``profile_cell.profile`` and the
total of ``hlo_cost.analyze_text``. The port traces the same cell (global
batch 4; T = 64 train and prefill, 128 decode; the rules ``choose_rules``
picks) once on a (2, 2) mesh of fake devices, at its reduced depth. At
every position: argument and output bytes equal the reference's per-device
bytes, matmul FLOPs equal its dot FLOPs, and the total FLOPs lie within
TOTAL_REL of its total (the port's eager ops are not XLA's fusions:
measured within 1.2% here). qwen3-moe's cells: ``test_torch_dryrun_moe.py``.

Then the cost model's parts: each weight of ``op_cost`` on a small op, the
live and peak bytes, a copy between devices, the collective records, the
launch ops of B8 and B9 on fake tensors (their shape rules and their work
formulas, and ``on_card``'s refusal of a bare ``meta`` tensor), the
production mesh's refusals, and ``roofline``'s ``wire_bytes`` and
``model_flops`` against the reference's on the same inputs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.build import card_stand_in, on_card  # noqa: E402
from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.maclaurin_attn.kernel import maclaurin_attention_cuda  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.op_cost import (  # noqa: E402
    CostRecorder,
    device_position,
    F32_PRODUCTS,
    flash_work,
    maclaurin_work,
)
from repro_torch.launch.specs import choose_rules  # noqa: E402
from repro_torch.sharding import collectives as coll  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOTAL_REL = 0.10
CELLS = (("train", 64), ("prefill", 64), ("decode", 128))

# One subprocess, one JSON line a cell: the reference's per-device numbers.
REF_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax
from repro.configs import ARCHS
from repro.configs.base import ShapeConfig
from repro.launch.hlo_cost import analyze_text
from repro.launch.mesh import make_mesh
from repro.launch.profile_cell import profile
from repro.launch.specs import build_cell, choose_rules, pick_backend
from repro.sharding import partitioning
from repro.sharding.hints import use_hints

mesh = make_mesh((2, 2), ("data", "model"))
for name, rules_name, kind, T in json.loads(sys.argv[1]):
    rules = getattr(partitioning, rules_name) if rules_name else None
    cfg, shape = ARCHS[name].reduced(), ShapeConfig("c", T, 4, kind)
    cell = build_cell(cfg, shape, mesh, rules)
    active = choose_rules(pick_backend(cfg, shape), shape, rules)
    with mesh, use_hints(mesh, active):
        c = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings,
                    donate_argnums=cell.donate_argnums).lower(*cell.args).compile()
    ma, text = c.memory_analysis(), c.as_text()
    print(json.dumps(dict(
        cell=[name, rules_name, kind], argument=ma.argument_size_in_bytes,
        output=ma.output_size_in_bytes, alias=ma.alias_size_in_bytes,
        dot=profile(text)[0]["dot"], flops=analyze_text(text)["flops"])), flush=True)
"""


def reference(cells) -> subprocess.Popen:
    """The subprocess that prints the reference's per-device numbers, one
    JSON line a cell; it runs while the port traces (``reference_rows``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", REF_CODE, json.dumps(cells)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env,
    )


def reference_rows(proc: subprocess.Popen) -> dict:
    """{(name, rules, kind): the reference's per-device numbers}."""
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    return {tuple(r["cell"]): r for r in rows}


def port(name: str, rules_name, kind: str, T: int) -> dict:
    """The port's trace of the same cell: per position argument, output
    bytes, matmul and total FLOPs."""
    from repro_torch.launch.op_cost import price
    from repro_torch.sharding import partitioning

    cfg, shape = ARCHS[name].reduced(), ShapeConfig("c", T, 4, kind)
    rules = choose_rules(cfg, shape, getattr(partitioning, rules_name) if rules_name else None)
    t = dryrun.trace_cell(cfg, shape, dryrun.fake_mesh((2, 2), ("data", "model")), rules)
    per = [price(t["records"], t["counts"].get(f"meta:{p}", {})) for p in range(4)]
    return dict(
        argument=t["arguments"],
        output=t["outputs"],
        alias=t["aliases"],
        matmul=[sum(x["matmul_flops"].values()) for x in per],
        flops=[x["flops"] for x in per],
    )


def check_cells(cells, exact_dots, dot_rel: float = 0.01) -> None:
    proc = reference(cells)
    try:
        ours = [port(*cell) for cell in cells]
        ref = reference_rows(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for (name, rules_name, kind, T), got in zip(cells, ours):
        want = ref[(name, rules_name, kind)]
        what = f"{name} {rules_name or 'choose_rules'} {kind}"
        assert got["argument"] == [want["argument"]] * 4, what
        assert got["output"] == [want["output"]] * 4, what
        assert got["alias"] == [want["alias"]] * 4, what
        for mm, flops in zip(got["matmul"], got["flops"]):
            if (name, rules_name, kind) in exact_dots:
                assert mm == want["dot"], what
            else:
                assert abs(mm / want["dot"] - 1) <= dot_rel, (what, mm, want["dot"])
            assert abs(flops / want["flops"] - 1) <= TOTAL_REL, (what, flops, want["flops"])


def test_smollm_cells_against_reference():
    cells = [("smollm-135m", None, kind, T) for kind, T in CELLS]
    check_cells(cells, exact_dots={("smollm-135m", None, kind) for kind, _ in CELLS})


# ----------------------------------------------------------- cost model


def _record(fn, *shapes, dtype=torch.float32, device="cpu"):
    xs = [torch.ones(s, dtype=dtype, device=device) for s in shapes]
    with CostRecorder() as rec:
        out = fn(*xs)
    return rec, out


@pytest.mark.parametrize(
    "fn, shapes, flops, matmul, nbytes",
    [
        (lambda a, b: a @ b, [(8, 4), (4, 3)], 2 * 8 * 4 * 3, 2 * 8 * 4 * 3, 4 * (32 + 12 + 24)),
        (lambda a, b: torch.bmm(a, b), [(2, 8, 4), (2, 4, 3)], 2 * 2 * 8 * 4 * 3, 2 * 2 * 8 * 4 * 3,
         4 * (64 + 24 + 48)),
        (lambda a, b: a + b, [(8, 4), (8, 4)], 32, 0, 0),
        (lambda a: torch.exp(a), [(8, 4)], 4 * 32, 0, 0),
        (lambda a: torch.sum(a, dim=1), [(8, 4)], 8, 0, 4 * (32 + 8)),
        (lambda a: torch.cat([a, a]), [(8, 4)], 0, 0, 4 * (32 + 32 + 64)),
        (lambda a: a[torch.tensor([0, 2])], [(8, 4)], 0, 0, 4 * 8),
        (lambda a, b: a.index_put_((torch.tensor([1, 3]),), b), [(8, 4), (2, 4)], 0, 0, 2 * 4 * 8),
        (lambda a: a.t().contiguous(), [(8, 4)], 0, 0, 0),
    ],
)
def test_op_weights(fn, shapes, flops, matmul, nbytes):
    """hlo_cost's weights: products 2 M N K (by dtype), elementwise 1 and
    transcendental 4 a result element, a reduction 1 a result element and
    its operand and result bytes, a concatenation's bytes, an indexed read
    its rows, an indexed write its slots read and written; a layout copy
    nothing."""
    rec, _ = _record(fn, *shapes)
    got = rec.totals()
    assert got["flops"] == flops
    assert sum(got["matmul_flops"].values()) == matmul
    assert got["bytes_accessed"] == nbytes


def test_live_and_peak_bytes():
    with CostRecorder() as rec:
        a = torch.ones(256)  # 1 KiB
        b = torch.exp(a)  # 1 KiB more
        c = b + 1  # 3 KiB live
        del b, c
        d = a[:128]  # a view: nothing new
        e = a * 2
    assert rec.peak["cpu"] == 3 * 1024 and rec.live["cpu"] == 2 * 1024
    del a, d, e
    assert rec.live["cpu"] == 0


def test_copy_across_devices_and_collectives():
    """A copy between two fake devices: read at its source and written at
    its destination, no flops; an all-reduce over them: one call, recorded
    at both members, its copies and adds counted at theirs, half each: a
    member adds its half (32 flops), sends and receives a half twice (4 x
    128 B) and copies its own half into its result (2 x 128 B)."""
    with FakeTensorMode():
        x = torch.ones(64, device="meta:0")
        y = torch.ones(64, device="meta:9")
        with CostRecorder() as rec:
            z = x.to("meta:9", copy=True)
            out = coll.all_reduce([x, y])
    assert z.device == torch.device("meta", 9) and len(out) == 2
    mine = {"flops": 32.0, "matmul_flops": {}, "bytes_accessed": 256.0 + 6 * 128}
    assert rec.totals("meta:0") == rec.totals("meta:9") == mine
    assert rec.calls == {0: [("all-reduce", 256, 2)]}
    key = ("all-reduce", 256, 2, 2, 2)  # two devices, on two nodes of eight
    assert rec.collectives == {(0, "meta:0"): [key], (0, "meta:9"): [key]}


def test_inference_mode_counts_the_decomposition():
    """Under inference_mode a composite op (matmul, einsum) reaches the mode
    whole: it is counted as the products it runs."""
    a, b = torch.ones(3, 8, 4), torch.ones(4, 5)
    with torch.inference_mode(), CostRecorder() as rec:
        a @ b
        torch.einsum("bij,jk->bik", a, b)
    assert rec.totals()["matmul_flops"] == {"torch.float32": 2 * (2 * 3 * 8 * 4 * 5)}


@pytest.mark.parametrize(
    "kind, dtype, shape",
    [
        ("flash", torch.float32, (6, 128, 64, 32)),
        ("flash", torch.bfloat16, (4, 256, 128, 128)),
        ("maclaurin", torch.float32, (6, 256, 64, 64)),
    ],
)
def test_launch_op_shape_rule_and_cost(kind, dtype, shape):
    """Inside ``card_stand_in`` a fake ``meta`` tensor reaches B8's or B9's
    launch op, whose shape rule gives the output on the card's path, and
    the recorder counts one call at the kernel's work formula."""
    bh, t, d, dv = shape
    with FakeTensorMode(), card_stand_in():
        q, k = (torch.empty(bh, t, d, dtype=dtype, device="meta:3") for _ in range(2))
        v = torch.empty(bh, t, dv, dtype=dtype, device="meta:3")
        with CostRecorder() as rec:
            if kind == "flash":
                out = flash_attention_cuda(q, k, v)
            else:
                out = maclaurin_attention_cuda(q, k, v)
    want_dtype = dtype if kind == "flash" else torch.float32
    # the rate the body runs at: bf16 products, or f32 ones as 3xTF32
    rate = str(dtype) if dtype == torch.bfloat16 else F32_PRODUCTS
    assert tuple(out.shape) == (bh, t, dv) and out.dtype == want_dtype
    assert out.device == torch.device("meta", 3)
    name = "flash_attention" if kind == "flash" else "maclaurin_attention"
    assert rec.kernels == {name: 1}
    if kind == "flash":
        flops, nbytes = flash_work(bh, t, d, dv, q.element_size())
    else:
        from repro_torch.kernels.common import tuning

        flops, nbytes = maclaurin_work(bh, t, d, dv, min(tuning.lookup("maclaurin_attn").chunk, t))
    got = rec.totals("meta:3")
    assert got["matmul_flops"] == {rate: flops}
    assert got["bytes_accessed"] == nbytes


def test_on_card_refuses_bare_meta():
    """A bare ``meta`` tensor raises inside and outside the stand-in, a fake
    one outside it; CPU tensors take the twin."""
    bare = torch.empty(2, 8, 4, device="meta")
    with pytest.raises(ValueError):
        on_card(bare, "flash_attention")
    with card_stand_in(), pytest.raises(ValueError):
        on_card(bare, "flash_attention")
    with FakeTensorMode():
        fake = torch.empty(2, 8, 4, device="meta:0")
        with pytest.raises(ValueError):
            on_card(fake, "flash_attention")
    assert on_card(torch.ones(2), "flash_attention") is False


def test_production_mesh():
    """The reference's meshes, refused with too few devices; the dry run's
    256 fake positions (an index has 8 bits: meta:0-127, then lazy:0-127),
    each recorded apart."""
    mesh = make_production_mesh(devices=dryrun.fake_devices(256))
    assert mesh.shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True, devices=[torch.device("cpu")] * 512)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError):
        make_production_mesh(devices=dryrun.fake_devices(255))
    with pytest.raises(ValueError):
        make_production_mesh(multi_pod=True, devices=dryrun.fake_devices(256))
    with pytest.raises(NotImplementedError):
        dryrun.fake_devices(512)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_production_mesh()
    devices = mesh.devices
    assert len({str(d) for d in devices}) == 256
    assert [device_position(d) for d in devices] == list(range(256))
    with FakeTensorMode(), CostRecorder() as rec:
        for d in (devices[127], devices[128], devices[255]):
            torch.ones(4, device=d) * 2
    assert set(rec.counts) == {"meta:127", "lazy:0", "lazy:127"}


OPS = [
    {"kind": "all-reduce", "bytes": 4096, "group_size": 16, "count": 3},
    {"kind": "all-gather", "bytes": 1 << 20, "group_size": 4, "count": 2},
    {"kind": "reduce-scatter", "bytes": 512, "group_size": 8, "count": 1},
    {"kind": "all-to-all", "bytes": 2048, "group_size": 16, "count": 5},
    {"kind": "collective-permute", "bytes": 64, "group_size": None, "count": 7},
]
META = [
    {"active_params": 135e6, "global_batch": 256, "kind": "train", "seq_len": 4096},
    {"active_params": 3.3e9, "global_batch": 32, "kind": "prefill", "seq_len": 32768},
    {"active_params": 34e9, "global_batch": 128, "kind": "decode", "seq_len": 32768},
]


def test_wire_bytes_and_model_flops_equal_reference():
    from repro.launch import roofline as ref

    assert roofline.wire_bytes(OPS) == ref.wire_bytes(OPS)
    for meta in META:
        assert roofline.model_flops(meta) == ref.model_flops(meta)


def test_route_and_compute_terms():
    """The port's route, spread over the members: what a member receives
    from the other s - 1 devices' members, (s - 1) / s of a result, twice
    for an all-reduce, g results' worth for a reduce-scatter; on its own
    device (s = g) the reference's ring multipliers; the first-member sums
    of scalars (a "reduce") as many wholes. Matmul flops at their dtype's
    peak, the kernels' f32 work at the 3xTF32 rate, the rest at the f32
    peak."""
    op = {"kind": "all-reduce", "bytes": 100, "group_size": 4, "span": 4, "count": 2}
    assert roofline.route_bytes(op) == 2 * 3 / 4 * 200
    assert roofline.route_bytes({**op, "kind": "all-max"}) == 2 * 3 / 4 * 200
    assert roofline.route_bytes({**op, "kind": "all-gather"}) == 3 / 4 * 200
    assert roofline.route_bytes({**op, "kind": "reduce-scatter"}) == 3 * 200
    assert roofline.route_bytes({**op, "kind": "all-to-all"}) == 3 / 4 * 200
    assert roofline.route_bytes({**op, "kind": "reduce"}) == 3 * 200
    assert roofline.route_bytes({**op, "span": 1}) == 0  # slots of one device
    assert roofline.route_bytes({**op, "span": 2}) == 2 * 1 / 2 * 200  # two members a device
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"):
        for g in (2, 4, 16):
            ring = {**op, "kind": kind, "group_size": g, "span": g}
            assert roofline.route_bytes(ring) == pytest.approx(roofline.wire_bytes([ring]), rel=1e-12), (kind, g)
    near, far = {**op, "nodes": 1}, {**op, "nodes": 2}
    assert roofline.link_seconds([near]) == 300 / roofline.NVLINK_BW
    assert roofline.link_seconds([far]) == 300 / roofline.NODE_LINK_BW
    mm = {"torch.bfloat16": 1e12, "torch.float32": 1e12, F32_PRODUCTS: 1e12}
    cost = {"flops": 4e12, "matmul_flops": mm}
    want = 1e12 / roofline.PEAK_BF16 + 1e12 / roofline.PEAK_F32_3XTF32 + 2e12 / roofline.PEAK_F32
    assert abs(roofline.compute_seconds(cost) - want) < 1e-15
    assert roofline.PEAK_F32_3XTF32 == roofline.PEAK_TF32 / 3 > roofline.PEAK_F32


def test_chip_smoke_bounds_share_the_roofline_table():
    """chip_smoke.py's kernel bounds and the dry run's roofline use one
    table of the card's peaks."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.PEAK_FP32_FLOPS == roofline.PEAK_F32
    assert smoke.PEAK_BF16_FLOPS == roofline.PEAK_BF16
    assert smoke.PEAK_F32_3XTF32 == roofline.PEAK_F32_3XTF32
    assert smoke.PEAK_HBM_BYTES == roofline.HBM_BW
