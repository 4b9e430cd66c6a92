"""What the port imports, and where its entry points run."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import families  # noqa: E402
from repro_torch.core.families import CompiledArtifact  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.quadform import kernel as qf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ModelNotFound,
    PublishSpec,
    Runtime,
    SVMEngine,
)
from repro_torch.serve.runtime import registry as registry_mod  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20  # every module was imported
    assert out[1].strip() == "[]"


def _artifact():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((30, 4)).astype(np.float32)
    svm = convert.svm_from_numpy(X, rng.standard_normal(30), 0.1, 0.05, device="cpu")
    return families.maclaurin.compile(svm), svm


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch, tmp_path):
    art, svm = _artifact()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SVMEngine(art)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SVMEngine(art, svm, device="cuda")
    path = art.save(str(tmp_path / "a.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledArtifact.load(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.svm_from_numpy(np.zeros((2, 2)), np.zeros(2), 0.0, 1.0)
    assert CompiledArtifact.load(path, device="cpu").digest() == art.digest()


def test_runtime_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    """With no ``device`` in ``engine_opts`` the runtime serves on the card:
    publishing or loading raises where there is none, and no engine is
    built on the CPU instead. Named, the CPU serves."""
    art, svm = _artifact()
    path = art.save(str(tmp_path / "a.npz"))
    built = []
    real = registry_mod.SVMEngine
    monkeypatch.setattr(
        registry_mod, "SVMEngine", lambda *a, **k: built.append(k) or real(*a, **k)
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with Runtime(engine_opts=dict(min_bucket=8, max_batch=64)) as rt:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.publish("m", art, PublishSpec(exact=svm))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.registry.add_file(path)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rt.load_directory(str(tmp_path))
        with Runtime(engine_opts=dict(device="cuda")) as named:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                named.publish("m", art)
        with pytest.raises(ModelNotFound):  # nothing was registered
            rt.submit("m", np.zeros((1, 4), np.float32))
    assert built == []
    with Runtime(engine_opts=dict(device="cpu", min_bucket=8, max_batch=64)) as rt:
        rt.publish("m", art, PublishSpec(exact=svm))
        values, valid = rt.predict("m", np.full((2, 4), 30.0, np.float32))
        assert values.shape == (2,) and not valid.any()
        assert rt.registry.get_engine("m")[1].device.type == "cpu"
    assert [k["device"] for k in built] == ["cpu"]


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    """The plain twin runs because the tensor lies on the CPU, not because a
    build failed: the build is never even attempted."""

    def no_build(source):
        raise AssertionError(f"tried to build {source}")

    monkeypatch.setattr(build, "load", no_build)
    art, svm = _artifact()
    eng = SVMEngine(art, svm, device="cpu")
    Z = np.full((5, 4), 30.0, np.float32)  # outside the envelope: B2 too
    assert not eng.predict(Z)[1].any()
    assert build.counts() == {k: v.launches for k, v in build.KERNELS.items()}


def test_other_devices_raise():
    z = torch.zeros((2, 3), device="meta")
    m = torch.zeros((1, 3, 3), device="meta")
    v = torch.zeros((1, 3), device="meta")
    k1 = torch.zeros((1,), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        qf.quadform_heads_cuda(z, m, v, k1, k1, k1, k1)


def test_lm_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    cfg = get_config("smollm-135m").reduced()
    params = transformer.init_params(cfg, device="cpu")
    tree = {
        name: {path: p.numpy() for path, p in getattr(params, name).named_parameters()}
        for name in ("embed", "lm_head", "final_ln")
    }
    layers = [dict(layer.named_parameters()) for layer in params.layers]
    stacked = {}
    for path in layers[0]:
        group, key = path.split(".")
        stacked.setdefault(group, {})[key] = np.stack([lay[path].numpy() for lay in layers])
    tree["layers"] = stacked
    back = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(), params.parameters()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy(cfg, tree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(cfg, 1, 8)


SOURCES = [
    "quadform.cu",
    "rbf_pred.cu",
    "rff_score.cu",
    "fastfood.cu",
    "flash_attn.cu",
    "maclaurin_attn.cu",
]


@pytest.mark.parametrize("source", SOURCES)
def test_failed_build_raises_with_the_log(monkeypatch, tmp_path, source):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match=f"nvcc failed on {source}"):
        build.build_all([source])
    assert not list(tmp_path.iterdir())  # no half-written library left behind
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == sorted(SOURCES)
    assert len({build.library_path(s) for s in SOURCES}) == len(SOURCES)
    assert set(build.KERNELS) == {
        "fastfood_score",
        "fastfood_score_q8",
        "flash_attention",
        "maclaurin_attention",
        "quadform_heads",
        "quadform_heads_q8",
        "rbf_scores",
        "rff_score",
        "rff_score_q8",
    }


def test_training_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    """``init_opt_state`` and the launcher build on the card unless told
    the CPU; the optimizer's state lies where it was asked for."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train.train_step import OptimizerConfig, init_opt_state

    cfg = get_config("smollm-135m").reduced()
    params = transformer.init_params(cfg, device="cpu")
    state = init_opt_state(OptimizerConfig(), params, device="cpu")
    assert {t.device.type for t in state["m"]["layers"]["attn"].values()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_opt_state(OptimizerConfig(), params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
