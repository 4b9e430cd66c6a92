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
from repro_torch.serve import SVMEngine  # noqa: E402

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


def test_failed_build_raises_with_the_log(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="nvcc failed on quadform.cu"):
        build.build_all(["quadform.cu"])
    assert not list(tmp_path.iterdir())  # no half-written library left behind
    assert build.library_path("quadform.cu") != build.library_path("rbf_pred.cu")
    assert set(build.KERNELS) == {"quadform_heads", "rbf_scores"}
