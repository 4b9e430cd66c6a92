"""Kernel B1's plain side against the JAX package's quadform kernel.

The same seeded numpy inputs go through ``quadform_heads_pallas`` (run in
interpret mode, as the JAX tests run it on the CPU) and its ``ref``
oracle, and through the port's plain twin, its oracle and the kernel
wrapper on CPU tensors (which computes with the plain twin).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.backend import quadform_heads_xla  # noqa: E402
from repro.kernels.common import TileConfig as JTileConfig  # noqa: E402
from repro.kernels.common import tuning as jtuning  # noqa: E402
from repro.kernels.quadform.kernel import quadform_heads_pallas  # noqa: E402
from repro.kernels.quadform.ref import quadform_heads_ref as jref  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.kernels.common import TileConfig, tiles, tuning  # noqa: E402
from repro_torch.kernels.quadform import (  # noqa: E402
    KERNEL,
    eq311_valid,
    quadform_heads_cuda,
    quadform_heads_ref,
    quadform_heads_torch,
)

RTOL = ATOL = 2e-4  # as tests/test_kernels.py's quadform sweep
ZSQ_TOL = 1e-5
NEAR_BOUND = 1e-3  # masks compared on rows this far (relative) from Eq 3.11


def _inputs(n, k, d, seed):
    rng = np.random.default_rng(seed)
    Z = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    M = (rng.standard_normal((k, d, d)) * 0.1).astype(np.float32)
    M = (M + M.transpose(0, 2, 1)) / 2
    V = rng.standard_normal((k, d)).astype(np.float32)
    c = rng.standard_normal(k).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    gamma = rng.uniform(0.01, 0.05, k).astype(np.float32)
    # Put the Eq 3.11 bound inside the batch's spread of ||z||^2, so both
    # sides of it are exercised.
    z_sq = (Z.astype(np.float64) ** 2).sum(-1)
    msq = (0.0625 / gamma.astype(np.float64) ** 2 / np.median(z_sq)).astype(np.float32)
    return Z, M, V, c, b, gamma, msq


def _away_from_bound(z_sq, gamma, msq):
    lhs = msq[None, :].astype(np.float64) * z_sq[:, None]
    rhs = 0.0625 / gamma[None, :].astype(np.float64) ** 2
    return np.abs(lhs - rhs) >= NEAR_BOUND * rhs


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("d", [22, 123])
@pytest.mark.parametrize("n", [5, 100])
def test_quadform_plain_matches_pallas(n, d, k):
    arrays = _inputs(n, k, d, seed=n * d + k)
    j_s, j_zsq, j_v = quadform_heads_pallas(
        *map(jnp.asarray, arrays), config=JTileConfig(block_n=64), interpret=True
    )
    j_s, j_zsq, j_v = map(np.asarray, (j_s, j_zsq, j_v))
    r_s, r_zsq, _ = map(np.asarray, jref(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(j_s, r_s, rtol=RTOL, atol=ATOL)
    t_args = [torch.from_numpy(a) for a in arrays]
    launches = KERNEL.launches
    for fn in (quadform_heads_torch, quadform_heads_ref, quadform_heads_cuda):
        s, zsq, v = (x.numpy() for x in fn(*t_args))
        np.testing.assert_allclose(s, j_s, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(zsq, j_zsq, rtol=ZSQ_TOL, atol=ZSQ_TOL)
        keep = _away_from_bound(j_zsq, arrays[5], arrays[6])
        assert keep.sum() > 0
        np.testing.assert_array_equal(v[keep], j_v[keep])
    assert KERNEL.launches == launches  # CPU tensors never launch the kernel


def test_quadform_plain_matches_xla_twin():
    arrays = _inputs(37, 3, 16, seed=5)
    j = quadform_heads_xla(*map(jnp.asarray, arrays))
    t = backend.quadform_heads(*[torch.from_numpy(a) for a in arrays])
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=ZSQ_TOL)


def test_eq311_strict_and_gamma_floor():
    """Strict ``<`` at the bound, and the 1e-30 floor on gamma^2: a row
    exactly at the bound is invalid, a gamma = 0 head is always valid."""
    from repro.kernels.quadform.ref import eq311_valid as j_eq311

    z_sq = np.array([1.0, 0.5, 2.0], np.float32)
    gamma = np.array([0.25, 0.0], np.float32)  # rhs = 1.0 and 6.25e28
    msq = np.array([1.0, 1e6], np.float32)
    t = eq311_valid(*(torch.from_numpy(a) for a in (z_sq, gamma, msq))).numpy()
    j = np.asarray(j_eq311(*(jnp.asarray(a) for a in (z_sq, gamma, msq))))
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[:, 0], [False, True, False])
    assert t[:, 1].all()


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 100, 1000, 5000, 9000])
def test_bucket_and_shape_key_match_jax(n):
    assert tuning.bucket(n) == jtuning.bucket(n)
    key = dict(d=780, k=10, n=tuning.bucket(n))
    assert tuning.shape_key(**key) == jtuning.shape_key(**key)


def test_tile_config_clamp_and_splits():
    cfg = TileConfig()
    assert cfg.clamp_block_n(1).block_n == 32
    assert cfg.clamp_block_n(32).block_n == 32
    assert cfg.clamp_block_n(33).block_n == 64
    assert cfg.clamp_block_n(5000) is cfg
    with pytest.raises(ValueError):
        TileConfig(splits=0)
    # no split is ever empty, and the count never exceeds the tiles
    for n_tiles in range(1, 70):
        for blocks in (1, 10, 160, 1000):
            s = tiles.split_count(n_tiles, blocks, 264)
            per = -(-n_tiles // s)
            assert 1 <= s <= n_tiles and (s - 1) * per < n_tiles


def test_tuning_lookup_defaults():
    for kernel in ("quadform", "rbf_pred"):
        key = tuning.shape_key(d=780, k=10, n=32)
        assert tuning.lookup(kernel, key) == tuning.DEFAULTS[kernel]
        assert tuning.lookup(kernel) == tuning.DEFAULTS[kernel]
    with pytest.raises(KeyError):
        tuning.lookup("fwht")
