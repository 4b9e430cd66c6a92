"""The 2 x 16 x 16 mesh through the dry run's CLI, on the CPU.

``python -m repro_torch.launch.dryrun --multi-pod`` on a reduced
smollm-135m (one layer: traced whole) at ``decode_32k``: 512 positions,
8 of them traced (the positions at coordinates 0 or 1 on every axis, each
on a fake device of its own; the others share the remaining 248 indices),
the classes' sizes summing to 512. The JSON carries the reference's keys
under a ``__2x16x16`` tag; ``profile_cell`` and ``roofline`` read it.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import dryrun, profile_cell, roofline  # noqa: E402
from repro_torch.sharding.spmd import class_reps  # noqa: E402


def test_fake_devices_of_the_multi_pod_mesh():
    run = sorted(set(class_reps((2, 16, 16))))
    assert run == [0, 1, 16, 17, 256, 257, 272, 273]
    devices = [str(d) for d in dryrun.production_mesh(True).devices]
    mine = [devices[p] for p in run]
    assert len(set(mine)) == 8
    assert not set(mine) & {d for p, d in enumerate(devices) if p not in run}
    assert len(set(devices)) == 256


def test_multi_pod_cell_through_the_cli(tmp_path, monkeypatch, capsys):
    name = "smollm-135m"
    monkeypatch.setitem(dryrun.ARCHS, name, dataclasses.replace(ARCHS[name].reduced(), n_layers=1))
    traced = dryrun.predict  # in this process: no fork from a test worker's threads
    monkeypatch.setattr(dryrun, "predict", lambda *args, workers=1: traced(*args))
    for module in (dryrun, roofline, profile_cell):
        monkeypatch.setattr(module, "RESULTS_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", name, "--shape", "decode_32k", "--multi-pod"])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 0
    assert "OK   smollm-135m" in capsys.readouterr().out
    tag = dryrun.cell_tag(name, "decode_32k", multi_pod=True)
    assert tag.endswith("__2x16x16")
    rec = json.loads((tmp_path / f"{tag}.json").read_text())
    for key in ("kind", "arch", "shape", "params", "active_params", "seq_len", "global_batch",
                "mesh", "rules", "n_devices", "memory", "cost", "collectives", "collective_ops",
                "trace_seconds", "depth_traced", "classes", "class_peaks", "total", "kernels", "calls"):
        assert key in rec, key
    assert rec["n_devices"] == 512 and rec["mesh"] == "2x16x16"
    assert len(rec["classes"]) == 8 and sum(rec["classes"].values()) == 512
    assert rec["memory"]["peak_device_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert max(rec["class_peaks"].values()) == rec["memory"]["peak_device_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["total"]["flops"] > rec["cost"]["flops"]
    monkeypatch.setattr("sys.argv", ["profile_cell", tag])
    profile_cell.main()
    assert "collective bytes by kind/group" in capsys.readouterr().out
    roofline.main()
    assert "| smollm-135m | decode_32k | 2x16x16 |" in (tmp_path / "results" / "roofline_torch.md").read_text()
