"""Kernel B2's plain side against the JAX package's rbf_pred kernel.

The same seeded numpy inputs go through ``rbf_predict_pallas`` (interpret
mode) and its ``ref`` oracle, and through the port's plain twin, its
oracle and the kernel wrapper on CPU tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.common import TileConfig as JTileConfig  # noqa: E402
from repro.kernels.rbf_pred.kernel import rbf_predict_pallas  # noqa: E402
from repro.kernels.rbf_pred.ref import rbf_predict_ref as jref  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.kernels.rbf_pred import (  # noqa: E402
    KERNEL,
    rbf_predict_ref,
    rbf_scores_cuda,
    rbf_scores_torch,
)

TOL = 2e-5  # as tests/test_kernels.py's rbf_pred sweep
GAMMA, BIAS = 0.05, -0.2


def _inputs(n, m, d, k=None, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, d)).astype(np.float32)
    X = rng.standard_normal((m, d)).astype(np.float32)
    shape = (m,) if k is None else (k, m)
    a = rng.standard_normal(shape).astype(np.float32)
    return Z, X, a


@pytest.mark.parametrize(
    "n,m,d", [(7, 13, 3), (64, 128, 22), (33, 257, 100), (128, 64, 123)]
)
def test_rbf_plain_matches_pallas(n, m, d):
    Z, X, a = _inputs(n, m, d, seed=n * m)
    j_out = rbf_predict_pallas(
        *map(jnp.asarray, (Z, X, a)),
        GAMMA,
        BIAS,
        config=JTileConfig(block_n=32, block_m=64),
        interpret=True,
    )
    j_ref = np.asarray(jref(*map(jnp.asarray, (Z, X, a)), GAMMA, BIAS))
    t = [torch.from_numpy(x) for x in (Z, X, a)]
    launches = KERNEL.launches
    for fn in (rbf_scores_torch, rbf_predict_ref, rbf_scores_cuda, backend.rbf_scores):
        out = fn(*t, GAMMA, BIAS).numpy()
        assert out.shape == (n,)
        np.testing.assert_allclose(out, np.asarray(j_out), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out, j_ref, rtol=TOL, atol=TOL)
    assert KERNEL.launches == launches  # CPU tensors never launch the kernel


@pytest.mark.parametrize("k", [1, 3])
def test_rbf_heads_written_out_match_per_head_pallas(k):
    """alpha_y (K, m) with b (K,) gives (n, K): the engine's vmap over heads
    written out as a head dimension."""
    Z, X, A = _inputs(20, 70, 9, k=k, seed=k)
    b = np.linspace(-1.0, 1.0, k).astype(np.float32)
    cols = [
        np.asarray(
            rbf_predict_pallas(
                *map(jnp.asarray, (Z, X, A[h])),
                GAMMA,
                float(b[h]),
                config=JTileConfig(block_n=32, block_m=64),
                interpret=True,
            )
        )
        for h in range(k)
    ]
    t = [torch.from_numpy(x) for x in (Z, X, A, b)]
    out = rbf_scores_cuda(t[0], t[1], t[2], GAMMA, t[3]).numpy()
    assert out.shape == (20, k)
    np.testing.assert_allclose(out, np.stack(cols, 1), rtol=TOL, atol=TOL)


def test_rbf_zero_coefficients_contribute_nothing():
    """The invariant TPU padding relied on: an SV with a = 0 adds exactly 0."""
    Z, X, a = _inputs(11, 40, 5, seed=3)
    Xp = np.concatenate([X, np.full((24, 5), 7.0, np.float32)])
    ap = np.concatenate([a, np.zeros(24, np.float32)])
    t = [torch.from_numpy(x) for x in (Z, X, a, Xp, ap)]
    base = rbf_scores_torch(t[0], t[1], t[2], GAMMA, BIAS)
    padded = rbf_scores_torch(t[0], t[3], t[4], GAMMA, BIAS)
    np.testing.assert_allclose(padded.numpy(), base.numpy(), rtol=1e-6, atol=1e-6)
