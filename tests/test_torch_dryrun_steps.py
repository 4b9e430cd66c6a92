"""The dry run held against real runs and deeper traces, on the CPU.

* The dry run of a cell (fake devices) against the same cell run on 2 x 2
  slots of the CPU under the same recorder: flops, matmul flops by dtype,
  launches and every collective call (kind, bytes, group size, count)
  equal, for reduced smollm-135m's train step (DP_ONLY) and reduced
  qwen3-moe's train step under EP_DATA (the experts' all-to-all) and its
  prefill under SP (the sequence-cut residual). Bytes differ: slots of one
  device copy nothing between positions.
* Depth: a cell traced at ``depths`` periods and extrapolated equals the
  same cell traced at full reduced depth, in flops, bytes, peak, matmul
  flops, launches and collectives at every position: smollm-135m's train
  (1, 2, 3 periods against 4: its cost has a term in L^2) and prefill,
  zamba2's and the VLM's prefills at 3 periods.
* ``run_cell`` and ``main`` end to end on a small fake mesh: the JSON's
  keys, ``--reanalyze`` pricing the stored counts to the same cost,
  ``profile_cell``'s four sections and ``roofline``'s table.
"""

import collections
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, make_mesh, profile_cell, roofline  # noqa: E402
from repro_torch.launch.op_cost import price  # noqa: E402
from repro_torch.launch.specs import build_cell, choose_rules  # noqa: E402
from repro_torch.sharding.partitioning import EP_DATA_RULES, SP_RULES  # noqa: E402
from repro_torch.train.train_step import OptimizerConfig  # noqa: E402

AXES = ("data", "model")
OCFG = OptimizerConfig(warmup=2, total_steps=10)


def _totals(trace: dict) -> dict:
    out = {"flops": 0.0, "matmul_flops": {}}
    for counts in trace["counts"].values():
        got = price(trace["records"], counts)
        out["flops"] += got["flops"]
        for k, v in got["matmul_flops"].items():
            out["matmul_flops"][k] = out["matmul_flops"].get(k, 0.0) + v
    return out


@pytest.mark.parametrize(
    "name, kind, rules",
    [
        ("smollm-135m", "train", None),
        ("qwen3-moe-30b-a3b", "train", EP_DATA_RULES),
        ("qwen3-moe-30b-a3b", "prefill", SP_RULES),
    ],
)
def test_dry_run_equals_a_real_run_on_slots(name, kind, rules):
    cfg, shape = ARCHS[name].reduced(), ShapeConfig("c", 64, 4, kind)
    rules = choose_rules(cfg, shape, rules)
    ocfg = OCFG if kind == "train" else None
    dry = dryrun.trace_cell(cfg, shape, dryrun.fake_mesh((2, 2), AXES), rules, ocfg)
    mesh = make_mesh((2, 2), AXES, devices=["cpu"] * 4)
    cell = build_cell(cfg, shape, mesh, rules, ocfg)
    real = dryrun.measure(cell.step_fn, *cell.args)
    want = _totals(dry)
    assert real["total"]["flops"] == want["flops"]
    assert real["total"]["matmul_flops"] == want["matmul_flops"]
    assert real["kernels"] == dry["kernels"]
    counts = collections.Counter(k for keys in dry["calls"].values() for k in keys)
    calls = [{"kind": k, "bytes": b, "group_size": g, "count": c} for (k, b, g), c in sorted(counts.items())]
    assert real["calls"] == calls and calls


@pytest.mark.parametrize(
    "name, kind, periods",
    [
        ("smollm-135m", "train", 4),
        ("smollm-135m", "prefill", 4),
        ("zamba2-2.7b", "prefill", 3),
        ("llama-3.2-vision-90b", "prefill", 3),
    ],
)
def test_extrapolated_depth_equals_a_full_trace(name, kind, periods):
    base = ARCHS[name].reduced()
    cfg = dryrun.cut(base, periods)
    shape = ShapeConfig("c", 64, 2, kind)
    mesh = dryrun.fake_mesh((1, 2), AXES)
    ocfg = OCFG if kind == "train" else None
    got, _ = dryrun.predict(cfg, shape, mesh, None, ocfg)
    assert got["depth_traced"] == list(dryrun.depths(shape)) and got["periods"] == periods
    full = dryrun.trace_cell(cfg, shape, mesh, choose_rules(cfg, shape, None), ocfg)
    pos = got["position"]
    dev = f"meta:{pos}"
    want = price(full["records"], full["counts"][dev])
    assert got["cost"]["flops"] == want["flops"]
    assert got["cost"]["bytes_accessed"] == want["bytes_accessed"]
    assert got["cost"]["matmul_flops"] == want["matmul_flops"]
    assert got["total"]["flops"] == _totals(full)["flops"]
    assert got["memory"]["argument_bytes"] == full["arguments"][pos]
    assert got["memory"]["output_bytes"] == full["outputs"][pos]
    assert got["memory"]["peak_device_bytes"] == full["arguments"][pos] + full["peak"][dev]
    assert got["kernels"] == full["kernels"]
    keys = collections.Counter(k for (_, d), ks in full["collectives"].items() if d == dev for k in ks)
    assert got["collective_ops"] == dryrun._collective_ops(keys)


def test_run_cell_main_reanalyze_profile_and_roofline(tmp_path, monkeypatch, capsys):
    """The CLI on a reduced smollm-135m at decode_32k, its production mesh
    swapped for a (1, 2) mesh of fake devices and its depths traced in
    this process."""
    name = "smollm-135m"
    monkeypatch.setitem(dryrun.ARCHS, name, dataclasses.replace(ARCHS[name].reduced(), n_layers=3))
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda devices: dryrun.fake_mesh((1, 2), AXES))
    traced = dryrun.predict  # in this process: no fork from a test worker's threads
    monkeypatch.setattr(dryrun, "predict", lambda *args, workers=1: traced(*args))
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(roofline, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(profile_cell, "RESULTS_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", name, "--shape", "decode_32k"])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 0
    assert "OK   smollm-135m" in capsys.readouterr().out
    tag = dryrun.cell_tag(name, "decode_32k")
    rec = json.loads((tmp_path / f"{tag}.json").read_text())
    for key in ("kind", "arch", "shape", "params", "active_params", "seq_len", "global_batch",
                "mesh", "rules", "n_devices", "memory", "cost", "collectives", "collective_ops",
                "trace_seconds", "depth_traced"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                                  "peak_device_bytes"}
    assert rec["periods"] == 3 and rec["depth_traced"] == [1, 2]
    again = dryrun.run_cell(name, "decode_32k", reanalyze=True)
    assert again["cost"] == rec["cost"] and again["collective_ops"] == rec["collective_ops"]
    monkeypatch.setattr("sys.argv", ["profile_cell", tag])
    profile_cell.main()
    out = capsys.readouterr().out
    for section in ("bytes by op kind", "bytes by result shape", "matmul flops by result shape",
                    "collective bytes by kind/group"):
        assert section in out
    roofline.main()
    table = (tmp_path / "results" / "roofline_torch.md").read_text()
    assert "| smollm-135m | decode_32k |" in table
    rows = json.loads((tmp_path / "results" / "roofline_torch.json").read_text())
    assert rows[0]["dominant"] in ("compute", "memory", "collective")
