"""The slice as a whole: ``repro``'s SVMEngine and the port's, on the CPU,
serving the same model to the same traffic."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core.families import maclaurin as jmac  # noqa: E402
from repro.serve.svm_engine import SVMEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend, families  # noqa: E402
from repro_torch.core.maclaurin import approximate  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.serve import SVMEngine, bucket_size  # noqa: E402

N_SV = 200
BATCHES = (1, 7, 33, 100)
SCALE = 60.0  # pushes a row far outside the Eq 3.11 envelope


def _pair(d, k, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((N_SV, d)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((k, N_SV) if k > 1 else (N_SV,)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32) if k > 1 else np.float32(0.2)
    gamma = np.float32(0.5 / d)
    jm = JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.asarray(b),
        gamma=jnp.asarray(gamma),
    )
    tm = convert.svm_from_numpy(X, ay, b, gamma, device="cpu")
    j_eng = JEngine(jmac.compile(jm), jm)
    t_eng = SVMEngine(families.maclaurin.compile(tm), tm, device="cpu")
    return j_eng, t_eng, rng


def _batch(rng, n, d):
    Z = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    scaled = np.zeros(n, bool)
    scaled[::5] = True
    Z[scaled] *= SCALE
    return Z, scaled


def _same(jr, tr):
    scale = max(1.0, float(np.abs(jr.values).max()))
    np.testing.assert_allclose(tr.values, jr.values, rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_array_equal(tr.valid, jr.valid)
    np.testing.assert_array_equal(tr.labels, jr.labels)
    assert tr.values.dtype == jr.values.dtype == np.float32


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("d", [16, 64])
def test_engine_matches_jax_engine(d, k):
    j_eng, t_eng, rng = _pair(d, k, seed=d + k)
    scaled_total = 0
    for n in BATCHES:
        Z, scaled = _batch(rng, n, d)
        scaled_total += int(scaled.sum())
        jr, tr = j_eng.submit(Z), t_eng.submit(Z)
        _same(jr, tr)
        np.testing.assert_array_equal(tr.valid, ~scaled)
    assert scaled_total > 0
    assert t_eng.stats.fallback_instances == j_eng.stats.fallback_instances
    assert t_eng.stats.fallback_instances == scaled_total
    assert t_eng.stats.snapshot()["instances"] == j_eng.stats.snapshot()["instances"]
    assert t_eng.stats.padded_instances == j_eng.stats.padded_instances


@pytest.mark.parametrize("k", [1, 3])
def test_submit_exact_matches_jax(k):
    j_eng, t_eng, rng = _pair(16, k, seed=5)
    Z, _ = _batch(rng, 45, 16)
    jr, tr = j_eng.submit_exact(Z), t_eng.submit_exact(Z)
    _same(jr, tr)
    assert not tr.valid.any()
    assert t_eng.stats.degraded_instances == 45 and t_eng.stats.instances == 0


def test_buckets_bounded_and_results_split():
    _, eng, rng = _pair(16, 3, seed=2)
    for n in (1, 3, 9, 17, 31, 32, 33, 200, 513, 1000):
        eng.predict(rng.standard_normal((n, 16)).astype(np.float32))
    bound = int(math.log2(eng.max_batch / eng.min_bucket)) + 1
    assert eng.jit_cache_size() <= bound
    buckets = {bucket_size(n) for n in (1, 33, 200, 513, 1000)}
    assert eng.jit_cache_size() == len(buckets)
    Z, _ = _batch(rng, 10, 16)
    r = eng.submit(Z)
    parts = r.split([4, 6])
    np.testing.assert_array_equal(np.concatenate([p.labels for p in parts]), r.labels)
    with pytest.raises(ValueError):
        r.split([3, 3])
    assert eng.predict_labels(Z).shape == (10,)
    assert eng.bucket_for(40) == 64


def test_engine_takes_an_approx_model_and_warms_up():
    j_eng, _, rng = _pair(16, 1, seed=3)
    X, ay = np.asarray(j_eng.exact.X), np.asarray(j_eng.exact.alpha_y)
    tm = convert.svm_from_numpy(X, ay, 0.2, 0.5 / 16, device="cpu")
    eng = SVMEngine(approximate(tm), tm, device="cpu", max_batch=256)
    assert eng.warmup() == 4  # buckets 32, 64, 128, 256
    assert eng.stats.instances == 0 and eng.stats.compiled_steps == 4
    Z, scaled = _batch(rng, 20, 16)
    values, valid = eng.predict(Z)
    np.testing.assert_array_equal(valid, ~scaled)
    assert set(np.unique(eng.predict_labels(Z))) <= {-1, 1}


def test_sharded_serving_is_not_ported():
    """Sharded serving refuses what it cannot serve, with ``ValueError``: a
    head count that does not split over the mesh's axis (the engine pads
    to it; the primitives take no padding), a ``device`` other than the
    mesh's first, where every batch is staged, and meshes that start on
    different devices. A bucket that is not a power of two is refused too."""
    _, eng, _ = _pair(16, 3)
    art = eng.artifact
    mesh = make_mesh((2,), ("heads",), devices=["cpu", "cpu"])
    a = art.arrays
    Z = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="must divide by mesh axis 'heads' \\(2\\)"):
        backend.quadform_heads_sharded(
            Z, a["M"], a["v"], a["c"], a["b"], a["gamma"], a["msq"], mesh=mesh
        )
    assert SVMEngine(art, head_mesh=mesh, device="cpu").num_heads == 3
    assert SVMEngine(art, mesh=mesh).device == torch.device("cpu")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        SVMEngine(art, head_mesh=mesh, device="meta")
    other = make_mesh((2,), ("sv",), devices=["meta", "cpu"])
    with pytest.raises(ValueError, match="different devices"):
        SVMEngine(art, mesh=other, head_mesh=mesh, device="cpu")
    with pytest.raises(ValueError):
        SVMEngine(art, device="cpu", min_bucket=24)
