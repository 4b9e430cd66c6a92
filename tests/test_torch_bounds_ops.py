"""The reference surfaces the port completes, on the CPU against the JAX
package on the same seeded inputs: the ``core.bounds`` diagnostics (the
poly2 approximation of exp, Eq 3.9 itself, the largest exponent), the
LOOPS oracle ``decision_function_loops``, and the public kernel shims
``quadform_predict``, ``quadform_predict_heads`` and ``rbf_predict`` with
``use_pallas`` off (the oracle) and on (the port's wrapper, its plain twin
on CPU tensors; the reference's Pallas body in interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.core as jcore  # noqa: E402
from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core import bounds as jbounds  # noqa: E402
from repro.core import rbf as jrbf  # noqa: E402
from repro.kernels.quadform import ops as jqops  # noqa: E402
from repro.kernels.rbf_pred import ops as jrops  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bounds  # noqa: E402
from repro_torch.core import rbf  # noqa: E402
from repro_torch.kernels.common import TileConfig  # noqa: E402
from repro_torch.kernels.quadform import (  # noqa: E402
    quadform_predict,
    quadform_predict_heads,
)
from repro_torch.kernels.rbf_pred import rbf_predict  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ bounds


def test_core_exports_poly2_constant_as_the_reference():
    assert "POLY2_REL_ERR_AT_HALF" in tcore.__all__
    assert tcore.POLY2_REL_ERR_AT_HALF == jcore.POLY2_REL_ERR_AT_HALF
    assert set(jcore.__all__) <= set(tcore.__all__)


def test_poly2_exp_and_rel_error_match_jax():
    x = np.linspace(-2.0, 2.0, 801, dtype=np.float32)
    for fn in ("poly2_exp", "poly2_rel_error", "maclaurin_exp", "maclaurin_rel_error"):
        got = getattr(bounds, fn)(_t(x)).numpy()
        want = np.asarray(getattr(jbounds, fn)(jnp.asarray(x)))
        # rel_error cancels e^x against its approximation: the float32
        # exps of the two packages differ by an ulp, ~1e-7 absolute
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=fn)


def test_bound_constants_are_the_sups():
    """Both families' per-term constants are the numerical sups of their
    relative errors on the Eq 3.9 envelope (tests/test_families.py)."""
    x = torch.linspace(-0.5, 0.5, 20001)
    cases = (
        (bounds.maclaurin_rel_error, tcore.REL_ERR_AT_HALF),
        (bounds.poly2_rel_error, tcore.POLY2_REL_ERR_AT_HALF),
    )
    for rel_err, const in cases:
        sup = float(rel_err(x).max())
        assert const - 5e-4 <= sup <= const


@pytest.mark.parametrize("seed", range(6))
def test_exact_bound_holds_matches_jax_and_follows_eq311(seed):
    """Eq 3.9 per row, as the reference computes it; where Eq 3.11 holds,
    Eq 3.9 holds too (the Cauchy-Schwarz chain) and every term's relative
    error is under REL_ERR_AT_HALF (tests/test_maclaurin_core.py)."""
    rng = np.random.default_rng(seed)
    d = int(rng.integers(2, 12))
    X = rng.standard_normal((30, d)).astype(np.float32)
    gamma = np.float32(rng.uniform(0.001, 0.3))
    max_sq = (X.astype(np.float64) ** 2).sum(1).max()
    for _ in range(8):
        z = rng.standard_normal(d).astype(np.float32)
        got = bool(bounds.exact_bound_holds(_t(X), _t(z), float(gamma)))
        want = bool(jbounds.exact_bound_holds(jnp.asarray(X), jnp.asarray(z), gamma))
        assert got == want
        z_sq = float((z.astype(np.float64) ** 2).sum())
        if bool(bounds.bound_holds(max_sq, z_sq, gamma)):
            assert got
            u = 2 * float(gamma) * (_t(X) @ _t(z))
            assert float(bounds.maclaurin_rel_error(u).max()) < bounds.REL_ERR_AT_HALF


def test_max_abs_exponent_matches_jax_and_conservatism_grows_with_d():
    """§4.2: Cauchy-Schwarz is more conservative at higher d."""
    rng = np.random.default_rng(4)
    ratios = []
    for d in (4, 64, 512):
        X = (rng.standard_normal((100, d)) / np.sqrt(d)).astype(np.float32)
        Z = (rng.standard_normal((100, d)) / np.sqrt(d)).astype(np.float32)
        actual = float(bounds.max_abs_exponent(_t(X), _t(Z), 1.0))
        want = float(jbounds.max_abs_exponent(jnp.asarray(X), jnp.asarray(Z), 1.0))
        np.testing.assert_allclose(actual, want, rtol=1e-5)
        worst = 2.0 * np.sqrt((X**2).sum(1).max() * (Z**2).sum(1).max())
        ratios.append(actual / worst)
    assert ratios[0] > ratios[1] > ratios[2]


# ------------------------------------------------------------- loop oracle


def test_decision_function_loops_matches_jax_and_the_gemm_form():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((50, 7)).astype(np.float32) * 0.5
    ay = rng.standard_normal(50).astype(np.float32)
    Z = rng.standard_normal((15, 7)).astype(np.float32)
    jm = JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.float32(0.3),
        gamma=jnp.float32(0.05),
    )
    tm = convert.svm_from_numpy(X, ay, 0.3, 0.05, device="cpu")
    got = rbf.decision_function_loops(tm, _t(Z)).numpy()
    want = np.asarray(jrbf.decision_function_loops(jm, jnp.asarray(Z)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    gemm = rbf.decision_function(tm, _t(Z)).numpy()
    np.testing.assert_allclose(got, gemm, rtol=1e-4, atol=1e-5)
    two = np.stack([ay, ay])
    heads = convert.svm_from_numpy(X, two, [0.3, 0.3], 0.05, device="cpu")
    with pytest.raises(ValueError, match="n_sv"):
        rbf.decision_function_loops(heads, _t(Z))


# ------------------------------------------------------------------- shims


def _quadform_operands(seed, n, d, k):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, d)).astype(np.float32) * 0.5
    Z[::4] *= 20.0  # outside the Eq 3.11 envelope
    M = rng.standard_normal((k, d, d)).astype(np.float32) * 0.1
    M = (M + M.transpose(0, 2, 1)) / 2
    V = rng.standard_normal((k, d)).astype(np.float32) * 0.3
    c = rng.standard_normal(k).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32) * 0.1
    gamma = rng.uniform(0.01, 0.05, k).astype(np.float32)
    msq = rng.uniform(1.0, 3.0, k).astype(np.float32)
    return Z, M, V, c, b, gamma, msq


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,d,k", [(7, 8, 1), (40, 20, 3)])
def test_quadform_predict_heads_matches_jax(n, d, k, use_pallas):
    ops = _quadform_operands(n + k, n, d, k)
    cfg = TileConfig(block_n=32)
    got = quadform_predict_heads(*map(_t, ops), use_pallas=use_pallas, config=cfg)
    want = jqops.quadform_predict_heads(*map(jnp.asarray, ops), use_pallas=use_pallas)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    assert not _np(got[2]).all()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_quadform_predict_single_head_matches_jax(use_pallas):
    Z, M, V, c, b, gamma, _ = _quadform_operands(3, 24, 10, 1)
    args = (Z, M[0], V[0])
    scalars = (float(c[0]), float(b[0]), float(gamma[0]))
    got = quadform_predict(*map(_t, args), *scalars, use_pallas=use_pallas)
    jargs = map(jnp.asarray, args)
    want = jqops.quadform_predict(*jargs, *scalars, use_pallas=use_pallas)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,m", [(5, 37), (70, 200)])
def test_rbf_predict_matches_jax(n, m, use_pallas):
    rng = np.random.default_rng(n + m)
    Z = rng.standard_normal((n, 9)).astype(np.float32) * 0.5
    X = rng.standard_normal((m, 9)).astype(np.float32) * 0.5
    ay = rng.standard_normal(m).astype(np.float32)
    got = rbf_predict(_t(Z), _t(X), _t(ay), 0.2, 0.1, use_pallas=use_pallas)
    want = jrops.rbf_predict(
        jnp.asarray(Z), jnp.asarray(X), jnp.asarray(ay), 0.2, 0.1, use_pallas=use_pallas
    )
    assert got.shape == (n,)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
