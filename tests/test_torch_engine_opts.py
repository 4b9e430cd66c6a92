"""The engine options the reference's callers pass (``allow_fallback``,
``tile_config``): the port's ``SVMEngine`` and ``repro``'s on the CPU,
one seeded model and the same traffic, and a runtime whose
``engine_opts`` carry both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core.families import maclaurin as jmac  # noqa: E402
from repro.kernels.common import TileConfig as JTileConfig  # noqa: E402
from repro.serve.svm_engine import SVMEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.families import maclaurin  # noqa: E402
from repro_torch.kernels.common import TileConfig  # noqa: E402
from repro_torch.serve import PublishSpec, Runtime, SVMEngine  # noqa: E402

D, N_SV = 12, 80
SCALE = 6.0  # pushes a row out of the Eq 3.11 envelope, not out of the SVs' reach


def _models(k, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((N_SV, D)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((k, N_SV) if k > 1 else (N_SV,)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32) if k > 1 else np.float32(0.2)
    gamma = np.float32(0.5 / D)
    jm = JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.asarray(b),
        gamma=jnp.asarray(gamma),
    )
    return jm, convert.svm_from_numpy(X, ay, b, gamma, device="cpu")


def _traffic(seed, n):
    rng = np.random.default_rng(seed)
    Z = (rng.standard_normal((n, D)) * 0.3).astype(np.float32)
    far = np.zeros(n, bool)
    far[::3] = True
    Z[far] *= SCALE
    return Z, far


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * scale)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("k", [1, 3])
def test_allow_fallback_false_matches_repro(k, dtype):
    """Rows outside the envelope come back unpatched with ``valid`` False
    in both packages, no row is re-scored, and the result keeps no copy of
    the rows; the exact model still serves ``submit_exact``."""
    jm, tm = _models(k, seed=k)
    j_art = jmac.compile(jm, dtype=dtype)
    t_art = maclaurin.compile(tm, dtype=dtype)
    j_eng = JEngine(j_art, jm, allow_fallback=False)
    t_eng = SVMEngine(t_art, tm, allow_fallback=False, device="cpu")
    patched = SVMEngine(t_art, tm, device="cpu")
    assert not t_eng.allow_fallback and not j_eng.allow_fallback
    assert t_eng.exact_available and j_eng.exact_available
    for n in (1, 9, 40):
        Z, far = _traffic(100 + n, n)
        jr, tr = j_eng.submit(Z), t_eng.submit(Z)
        assert tr._Z is None and jr._Z is None
        _close(tr.values, jr.values)
        np.testing.assert_array_equal(tr.valid, jr.valid)
        np.testing.assert_array_equal(tr.valid, ~far)
        np.testing.assert_array_equal(tr.labels, jr.labels)
        pr = patched.submit(Z)
        assert pr._Z is not None
        np.testing.assert_array_equal(pr.valid, tr.valid)
        if far.any():  # the patched engine re-scored exactly those rows
            assert not np.allclose(pr.values[far], tr.values[far])
        np.testing.assert_array_equal(pr.values[~far], tr.values[~far])
    assert t_eng.stats.fallback_instances == j_eng.stats.fallback_instances == 0
    assert patched.stats.fallback_instances > 0
    Z, _ = _traffic(7, 5)
    jx, tx = j_eng.submit_exact(Z), t_eng.submit_exact(Z)
    _close(tx.values, jx.values)
    assert not tx.valid.any() and not jx.valid.any()


def test_allow_fallback_without_exact_is_false_in_both():
    jm, tm = _models(1)
    assert not JEngine(jmac.compile(jm), None, allow_fallback=True).allow_fallback
    t_eng = SVMEngine(maclaurin.compile(tm), None, allow_fallback=True, device="cpu")
    assert not t_eng.allow_fallback and not t_eng.exact_available


@pytest.mark.parametrize("block_n", [32, 64, 256])
def test_pinned_tile_config_matches_repro(block_n):
    """A pinned ``tile_config`` replaces the tuning table in every bucket,
    ``block_n`` clamped to the bucket, as in the reference."""
    jm, tm = _models(3)
    opts = dict(min_bucket=32, max_batch=256)
    j_cfg = JTileConfig(block_n=block_n)
    j_eng = JEngine(jmac.compile(jm), jm, tile_config=j_cfg, **opts)
    t_eng = SVMEngine(
        maclaurin.compile(tm),
        tm,
        tile_config=TileConfig(block_n=block_n),
        device="cpu",
        **opts,
    )
    assert t_eng.warmup() == j_eng.warmup() == 4
    j_blocks = {b: c.block_n for b, c in j_eng.bucket_configs.items()}
    t_blocks = {b: c.block_n for b, c in t_eng.bucket_configs.items()}
    assert t_blocks == j_blocks == {b: min(block_n, b) for b in (32, 64, 128, 256)}
    Z, _ = _traffic(3, 70)
    jr, tr = j_eng.submit(Z), t_eng.submit(Z)
    _close(tr.values, jr.values)
    np.testing.assert_array_equal(tr.labels, jr.labels)
    np.testing.assert_array_equal(tr.valid, jr.valid)


def test_runtime_engine_opts_carry_both_options():
    """``engine_opts`` reach every engine the registry builds: the runtime
    publishes and serves with the fallback off and the tile pinned."""
    _, tm = _models(3, seed=5)
    art = maclaurin.compile(tm)
    opts = dict(
        device="cpu",
        min_bucket=8,
        max_batch=64,
        allow_fallback=False,
        tile_config=TileConfig(block_n=32),
    )
    direct = SVMEngine(art, tm, **opts)
    with Runtime(max_wait_us=1_000, engine_opts=opts) as rt:
        rt.publish("m", art, PublishSpec(exact=tm))
        _, eng = rt.registry.get_engine("m")
        assert not eng.allow_fallback and eng.exact_available
        for n in (3, 17, 40):
            Z, far = _traffic(200 + n, n)
            got = rt.submit("m", Z).result(timeout=30)
            want = direct.submit(Z)
            np.testing.assert_array_equal(got.values, want.values)
            np.testing.assert_array_equal(got.valid, ~far)
        assert {c.block_n for c in eng.bucket_configs.values()} <= {8, 16, 32}
        assert rt.stats("m")["engine"]["fallback_instances"] == 0
