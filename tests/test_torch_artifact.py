"""``CompiledArtifact`` bytes and the maclaurin family against ``repro``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core import approximate as japproximate  # noqa: E402
from repro.core.families import CompiledArtifact as JArtifact  # noqa: E402
from repro.core.families import maclaurin as jmac  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import families, maclaurin  # noqa: E402
from repro_torch.core.families import (  # noqa: E402
    ARTIFACT_FORMAT_VERSION,
    CompiledArtifact,
)


def _svm(k, seed=0, n_sv=120, d=12):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n_sv, d)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((k, n_sv) if k > 1 else (n_sv,)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32) if k > 1 else np.float32(0.1)
    gamma = np.float32(0.05)
    j = JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.asarray(b),
        gamma=jnp.asarray(gamma),
    )
    return j, convert.svm_from_numpy(X, ay, b, gamma, device="cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_jax_written_artifact_keeps_its_digest(k, tmp_path):
    jm, _ = _svm(k, seed=k)
    j_art = jmac.compile(jm)
    path = j_art.save(str(tmp_path / "j.npz"))
    t_art = CompiledArtifact.load(path, device="cpu")
    assert t_art.digest() == j_art.digest()
    t_art.save(str(tmp_path / "t.npz"))
    assert (tmp_path / "t.npz").read_bytes() == (tmp_path / "j.npz").read_bytes()
    # and back: repro reads the port's file
    assert JArtifact.load(str(tmp_path / "t.npz")).digest() == j_art.digest()
    arrays = {name: np.asarray(a) for name, a in j_art.arrays.items()}
    from_np = convert.artifact_from_numpy(
        j_art.family, arrays, j_art.meta, device="cpu"
    )
    assert from_np.digest() == j_art.digest()


@pytest.mark.parametrize("k", [1, 3])
def test_port_compile_matches_jax_compile(k):
    """Same arrays within 1e-5 relative and the same meta. The digests may
    differ: the collapse's sums run in another order in each package, so
    the f32 arrays can differ in the last bits, and the digest hashes
    every bit."""
    jm, tm = _svm(k, seed=10 + k)
    j_art, t_art = jmac.compile(jm), families.maclaurin.compile(tm)
    assert t_art.meta == j_art.meta
    assert sorted(t_art.arrays) == sorted(j_art.arrays)
    for name, ja in j_art.arrays.items():
        ja = np.asarray(ja)
        ta = t_art.arrays[name].numpy()
        assert ta.shape == ja.shape and ta.dtype == ja.dtype
        np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-5 * np.abs(ja).max())
    assert t_art.nbytes() == j_art.nbytes()


def test_from_approx_matches_jax():
    jm, tm = _svm(1, seed=7)
    j_art = jmac.from_approx(japproximate(jm))
    t_art = families.maclaurin.from_approx(maclaurin.approximate(tm))
    assert t_art.meta == j_art.meta
    for name, ja in j_art.arrays.items():
        np.testing.assert_allclose(
            t_art.arrays[name].numpy(), np.asarray(ja), rtol=1e-5, atol=1e-7
        )


def test_load_rejects_newer_versions_and_foreign_files(tmp_path, monkeypatch):
    import repro_torch.core.families.base as base

    _, tm = _svm(1)
    art = families.maclaurin.compile(tm)
    path = str(tmp_path / "new.npz")
    monkeypatch.setattr(base, "ARTIFACT_FORMAT_VERSION", ARTIFACT_FORMAT_VERSION + 1)
    art.save(path)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="newer"):
        CompiledArtifact.load(path, device="cpu")
    np.savez(tmp_path / "plain.npz", x=np.zeros(3))
    with pytest.raises(ValueError, match="not a CompiledArtifact"):
        CompiledArtifact.load(str(tmp_path / "plain.npz"), device="cpu")


def test_unported_families_and_dtypes_say_so():
    """Every family, projection and dtype of the reference is ported (the
    Fastfood projection came with kernels B6/B7); an unknown family raises
    and lists the known ones."""
    assert sorted(families.FAMILIES) == ["fourier", "maclaurin", "poly2"]
    with pytest.raises(KeyError, match="unknown"):
        families.get_family("nope")
    _, tm = _svm(1)
    for dtype in ("float32", "int8"):
        ff = families.fourier.compile(tm, structured=True, dtype=dtype, num_features=64)
        assert ff.meta["projection"] == "fastfood" and ff.dtype == dtype
    art = families.maclaurin.compile(tm)
    assert families.maclaurin.tile_lookup(art, 64) == ("quadform", "d12_k1_n64")
    q8 = families.maclaurin.quantize_quadform_artifact(art)
    assert families.maclaurin.tile_lookup(q8, 64) == ("quadform_q8", "d12_k1_n64")
