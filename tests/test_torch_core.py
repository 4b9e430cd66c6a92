"""The port's core (rbf, bounds, maclaurin) against the JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import bounds as jbounds  # noqa: E402
from repro.core import maclaurin as jmac  # noqa: E402
from repro.core import rbf as jrbf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bounds, maclaurin, rbf  # noqa: E402

REL = 1e-5


def _model(n_sv=200, d=16, k=None, seed=0, gamma=0.05):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n_sv, d)) * 0.3).astype(np.float32)
    shape = (n_sv,) if k is None else (k, n_sv)
    ay = rng.standard_normal(shape).astype(np.float32)
    b = np.float32(0.3) if k is None else rng.standard_normal(k).astype(np.float32)
    j = jrbf.SVMModel(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.asarray(b),
        gamma=jnp.float32(gamma),
    )
    return j, convert.svm_from_numpy(X, ay, b, gamma, device="cpu")


def _close(t, j, rel=REL):
    j = np.asarray(j)
    atol = rel * max(1.0, np.abs(j).max())
    np.testing.assert_allclose(t.numpy(), j, rtol=rel, atol=atol)


@pytest.mark.parametrize("d", [16, 64])
def test_approximate_matches_jax(d):
    jm, tm = _model(d=d, seed=d)
    ja, ta = jmac.approximate(jm), maclaurin.approximate(tm)
    for name in ("c", "v", "M", "b", "gamma", "max_sv_sq_norm"):
        _close(getattr(ta, name), getattr(ja, name))
    assert ta.num_parameters() == ja.num_parameters()


def test_approximate_heads_written_out_match_vmap():
    """(K, n_sv) alpha_y: the head axis written out equals jax.vmap."""
    jm, tm = _model(k=3, seed=4)

    def one(ay_k, b_k):
        one = jrbf.SVMModel(X=jm.X, alpha_y=ay_k, b=b_k, gamma=jm.gamma)
        return jmac.approximate(one)

    ja = jax.vmap(one)(jm.alpha_y, jm.b)
    ta = maclaurin.approximate(tm)
    for name in ("c", "v", "M", "b"):
        _close(getattr(ta, name), getattr(ja, name))


def test_decision_function_and_kernel_match_jax():
    jm, tm = _model(seed=1)
    rng = np.random.default_rng(9)
    Z = (rng.standard_normal((23, 16)) * 0.3).astype(np.float32)
    Zj, Zt = jnp.asarray(Z), torch.from_numpy(Z)
    _close(rbf.rbf_kernel(Zt, tm.X, tm.gamma), jrbf.rbf_kernel(Zj, jm.X, jm.gamma))
    _close(rbf.decision_function(tm, Zt), jrbf.decision_function(jm, Zj))
    np.testing.assert_array_equal(
        rbf.predict_labels(tm, Zt).numpy(), np.asarray(jrbf.predict_labels(jm, Zj))
    )
    assert rbf.model_bytes(tm) == jrbf.model_bytes(jm)
    assert tm.num_parameters() == jm.num_parameters()


def test_approx_decision_functions_match_jax():
    jm, tm = _model(seed=2)
    ja, ta = jmac.approximate(jm), maclaurin.approximate(tm)
    rng = np.random.default_rng(3)
    Z = (rng.standard_normal((40, 16)) * 0.3).astype(np.float32)
    Z[::7] *= 50.0  # outside the Eq 3.11 envelope
    Zj, Zt = jnp.asarray(Z), torch.from_numpy(Z)
    _close(
        maclaurin.approx_decision_function(ta, Zt),
        jmac.approx_decision_function(ja, Zj),
    )
    f_t, v_t = maclaurin.approx_decision_function_checked(ta, Zt)
    f_j, v_j = jmac.approx_decision_function_checked(ja, Zj)
    _close(f_t, f_j)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert 0 < int(v_t.sum()) < len(Z)
    h_t, hv_t = maclaurin.hybrid_decision_function(ta, tm, Zt)
    h_j, hv_j = jmac.hybrid_decision_function(ja, jm, Zj)
    _close(h_t, h_j)
    np.testing.assert_array_equal(hv_t.numpy(), np.asarray(hv_j))
    np.testing.assert_array_equal(
        maclaurin.approx_predict_labels(ta, Zt).numpy(),
        np.asarray(jmac.approx_predict_labels(ja, Zj)),
    )
    assert maclaurin.approx_model_bytes(ta) == jmac.approx_model_bytes(ja)


def test_bounds_match_jax():
    assert bounds.REL_ERR_AT_HALF == jbounds.REL_ERR_AT_HALF
    x = np.linspace(-0.5, 0.5, 101).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(bounds.maclaurin_exp(xt), jbounds.maclaurin_exp(xj))
    rel_t = bounds.maclaurin_rel_error(xt)
    _close(rel_t, jbounds.maclaurin_rel_error(xj), rel=1e-4)
    assert float(rel_t.max()) < bounds.REL_ERR_AT_HALF
    rng = np.random.default_rng(0)
    X = rng.standard_normal((50, 8)).astype(np.float32)
    _close(bounds.gamma_max(torch.from_numpy(X)), jbounds.gamma_max(jnp.asarray(X)))
    z_sq = np.array([0.5, 1.0, 4.0], np.float32)
    t = bounds.bound_holds(2.0, torch.from_numpy(z_sq), 0.1).numpy()
    j = jbounds.bound_holds(2.0, jnp.asarray(z_sq), 0.1)
    np.testing.assert_array_equal(t, np.asarray(j))
    Z = rng.standard_normal((64, 8)).astype(np.float32)
    frac_t = float(bounds.validity_fraction(10.0, torch.from_numpy(Z), 0.05))
    frac_j = float(jbounds.validity_fraction(10.0, jnp.asarray(Z), 0.05))
    assert frac_t == frac_j and 0.0 < frac_t < 1.0
