"""Kernels B4 and B5's plain side against the JAX package's RFF kernels.

The same seeded numpy inputs go through ``rff_score_pallas`` /
``rff_score_q8_pallas`` (run in interpret mode, as the JAX tests run them
on the CPU), their XLA twins and ``rff_score_ref``, and through the port's
plain twins, its oracle, the kernel wrappers and the backend on CPU
tensors (which compute with the twins). F is never a multiple of the
port's 64-feature tile, so the ragged feature edge is in every case.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.backend import rff_score_q8_xla, rff_score_xla  # noqa: E402
from repro.core.families import quantize as jq  # noqa: E402
from repro.kernels.common import TileConfig as JTileConfig  # noqa: E402
from repro.kernels.rff_score.kernel import (  # noqa: E402
    rff_score_pallas,
    rff_score_q8_pallas,
)
from repro.kernels.rff_score.ref import rff_score_ref as j_ref  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.kernels.rff_score import kernel as rk  # noqa: E402
from repro_torch.kernels.rff_score.ref import rff_score_ref  # noqa: E402

RTOL = ATOL = 2e-4


def _inputs(n, d, f, k, seed):
    """f32 Z, W ~ N(0, 2 gamma), phase ~ U[0, 2 pi), readout and bias."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.normal(0.0, np.sqrt(2.0 * 0.3), size=(f, d)).astype(np.float32)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=f).astype(np.float32)
    weights = (rng.standard_normal((k, f)) * 2.0 / f).astype(np.float32)
    bias = rng.standard_normal(k).astype(np.float32)
    return Z, W, phase, weights, bias


def _q8(Z, W, phase, weights, bias):
    W_q, w_scale = map(np.array, jq.quantize_rows(W))
    wt_q, wt_scale = map(np.array, jq.quantize_rows(weights))
    return Z, W_q, w_scale, phase, wt_q, wt_scale, bias


CASES = [(5, 13, 100, 1), (70, 40, 200, 3), (33, 7, 65, 17)]


@pytest.mark.parametrize("n,d,f,k", CASES)
def test_rff_plain_matches_pallas_and_ref(n, d, f, k):
    arrays = _inputs(n, d, f, k, seed=n + d + f + k)
    j_args = [jnp.asarray(a) for a in arrays]
    j_p = np.asarray(rff_score_pallas(*j_args, config=JTileConfig(), interpret=True))
    j_r = np.asarray(j_ref(*j_args))
    j_x = np.asarray(rff_score_xla(*j_args))
    np.testing.assert_allclose(j_p, j_r, rtol=RTOL, atol=ATOL)
    t_args = [torch.from_numpy(a) for a in arrays]
    launches = rk.KERNEL.launches
    for fn in (rk.rff_score_torch, rff_score_ref, rk.rff_score_cuda, backend.rff_score):
        out = fn(*t_args).numpy()
        assert out.shape == (n, k)
        for ref in (j_p, j_r, j_x):
            np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    assert rk.KERNEL.launches == launches  # CPU tensors never launch it


@pytest.mark.parametrize("n,d,f,k", CASES)
def test_rff_q8_plain_matches_pallas_and_xla(n, d, f, k):
    arrays = _q8(*_inputs(n, d, f, k, seed=7 * n + f))
    j_args = [jnp.asarray(a) for a in arrays]
    cfg = JTileConfig()
    j_p = np.asarray(rff_score_q8_pallas(*j_args, config=cfg, interpret=True))
    j_x = np.asarray(rff_score_q8_xla(*j_args))
    np.testing.assert_allclose(j_p, j_x, rtol=RTOL, atol=ATOL)
    t_args = [torch.from_numpy(a) for a in arrays]
    assert t_args[1].dtype == t_args[4].dtype == torch.int8
    launches = rk.KERNEL_Q8.launches
    for fn in (rk.rff_score_q8_torch, rk.rff_score_q8_cuda, backend.rff_score_q8):
        out = fn(*t_args).numpy()
        for ref in (j_p, j_x):
            np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    assert rk.KERNEL_Q8.launches == launches


def test_rff_q8_twin_is_b4_on_the_dequantized_weights():
    """The oracle: B5 computes B4 on W_q * w_scale and weights_q *
    wt_scale (both scales sit on output axes of their products)."""
    Z, W_q, w_scale, phase, wt_q, wt_scale, bias = (
        torch.from_numpy(a) for a in _q8(*_inputs(20, 30, 130, 4, seed=2))
    )
    W = W_q.to(torch.float32) * w_scale[:, None]
    wt = wt_q.to(torch.float32) * wt_scale[:, None]
    got = rk.rff_score_q8_torch(Z, W_q, w_scale, phase, wt_q, wt_scale, bias)
    torch.testing.assert_close(
        got, rff_score_ref(Z, W, phase, wt, bias), rtol=1e-5, atol=1e-5
    )


def test_float64_inputs_stay_float64():
    """The twins compute in the inputs' dtype (the card's float64
    yardstick relies on it), int8 operands upcast to Z's dtype."""
    Z, W_q, w_scale, phase, wt_q, wt_scale, bias = (
        torch.from_numpy(a) for a in _q8(*_inputs(4, 9, 70, 2, seed=3))
    )
    d64 = [t.double() for t in (Z, w_scale, phase, wt_scale, bias)]
    out = rk.rff_score_q8_torch(d64[0], W_q, d64[1], d64[2], wt_q, d64[3], d64[4])
    assert out.dtype == torch.float64


@pytest.mark.parametrize("q8", [False, True])
def test_twins_match_pallas_when_the_cos_arguments_span_tens_of_radians(q8):
    """Fourier's W ~ N(0, 2 gamma) on real rows puts the cos arguments tens
    of radians from 0, where a cos that reduces its argument badly drifts;
    the card's kernels are held to these twins."""
    n, d, f, k = 37, 40, 300, 3
    Z, W, phase, weights, bias = _inputs(n, d, f, k, seed=11)
    W = (W * np.sqrt(4.5 / 0.3)).astype(np.float32)  # gamma 4.5
    assert np.abs(Z @ W.T).max() > 20.0
    arrays = (Z, W, phase, weights, bias)
    if q8:
        arrays = _q8(*arrays)
    j_args = [jnp.asarray(a) for a in arrays]
    pallas = rff_score_q8_pallas if q8 else rff_score_pallas
    xla = rff_score_q8_xla if q8 else rff_score_xla
    j_p = np.asarray(pallas(*j_args, config=JTileConfig(), interpret=True))
    j_x = np.asarray(xla(*j_args))
    t_args = [torch.from_numpy(a) for a in arrays]
    twin = rk.rff_score_q8_torch if q8 else rk.rff_score_torch
    wrapper = rk.rff_score_q8_cuda if q8 else rk.rff_score_cuda
    for fn in (twin, wrapper):
        out = fn(*t_args).numpy()
        for ref in (j_p, j_x):
            np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_every_clamped_block_is_one_the_kernels_are_compiled_for():
    """A wrapper shrinks its block to the batch; with 128-row defaults a
    batch of 65-96 rows once asked for a 96-row block, which no kernel is
    compiled for, and the card refused it."""
    from repro_torch.kernels.common import tuning
    from repro_torch.kernels.quadform import kernel as qf
    from repro_torch.kernels.rbf_pred import kernel as rp

    compiled = {
        "quadform": qf.BLOCK_N,
        "quadform_q8": qf.BLOCK_N,
        "rbf_pred": rp.BLOCK_N,
        "rff_score": rk.BLOCK_N,
        "rff_score_q8": rk.BLOCK_N,
    }
    for name, blocks in compiled.items():
        cfg = tuning.lookup(name)
        for n in range(1, 300):
            assert cfg.clamp_block_n(n).block_n in blocks, (name, n)
    assert tuning.lookup("rff_score").clamp_block_n(65).block_n == 128
