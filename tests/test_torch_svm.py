"""Training on the CPU against the JAX package: LS-SVM, the dual C-SVC
with ``compress_support``, one-vs-rest and its collapse, on the same
seeded data.

Decision values are compared, not bytes: the two packages solve and sum
in another order. The KKT solve and the projected-gradient loop run in
f32 on both sides, so values agree to 1e-4 of their scale + 1e-4 (the
reference suite's compressed-vs-dense tolerance). Alphas are compared
only where the reference's own tests compare them (a compressed model
against its dense one); the SV masks may differ on rows at the
threshold, so their counts are compared within 2% of the rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import decision_function as j_decision  # noqa: E402
from repro.core import gamma_max  # noqa: E402
from repro.data.synthetic import make_blobs  # noqa: E402
from repro.svm import dual as jdual  # noqa: E402
from repro.svm import multiclass as jmc  # noqa: E402
from repro.svm import train_lssvm as j_lssvm  # noqa: E402
from repro_torch import svm  # noqa: E402
from repro_torch.core import decision_function, families  # noqa: E402
from repro_torch.svm import dual, multiclass  # noqa: E402


def _close(port, ref, rel=1e-4, atol=1e-4):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    tol = rel * float(np.abs(ref).max()) + atol
    assert float(np.abs(port - ref).max()) <= tol


def _blob_task(seed=0, n=240, d=6):
    X, y = make_blobs(n, d, seed=seed, separation=3.0)
    n_tr = (2 * n) // 3
    return X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]


def _classes(seed=3, k=3, n=120, d=5):
    """The reference suite's one-vs-rest recipe: k Gaussian classes."""
    rng = np.random.default_rng(seed)
    mus = rng.standard_normal((k, d)) * 3
    X = np.concatenate([rng.standard_normal((n // k, d)) + mus[c] for c in range(k)])
    y = np.concatenate([np.full(n // k, c) for c in range(k)])
    return X.astype(np.float32), y


@pytest.mark.parametrize("seed", [0, 7])
def test_lssvm_matches_jax(seed):
    X, y, Xte, yte = _blob_task(seed)
    gamma = np.float32(float(gamma_max(jnp.asarray(X))) * 0.8)
    jm = j_lssvm(jnp.asarray(X), jnp.asarray(y), gamma, jnp.float32(10.0))
    tm = svm.train_lssvm(X, y, gamma, 10.0, device="cpu")
    assert tm.n_sv == len(y) and tm.X.device.type == "cpu"
    f = decision_function(tm, torch.from_numpy(Xte))
    _close(f, j_decision(jm, jnp.asarray(Xte)))
    _close(tm.b, jm.b)
    assert (np.sign(f.numpy()) == yte).mean() >= 0.88


def test_svc_matches_jax_and_compresses():
    X, y, Xte, yte = _blob_task(seed=5)
    gamma = np.float32(float(gamma_max(jnp.asarray(X))) * 0.8)
    jm, jmask = jdual.train_svc(
        jnp.asarray(X), jnp.asarray(y), gamma, jnp.float32(1.0), num_steps=800
    )
    tm, tmask = svm.train_svc(X, y, gamma, 1.0, num_steps=800, device="cpu")
    Zt = torch.from_numpy(Xte)
    f = decision_function(tm, Zt)
    _close(f, j_decision(jm, jnp.asarray(Xte)))
    n_sv = int(tmask.sum())
    assert 0 < n_sv < len(y)
    assert abs(n_sv - int(jmask.sum())) <= 0.02 * len(y)
    tc = dual.compress_support(tm, tmask)
    assert tc.n_sv == n_sv
    _close(decision_function(tc, Zt), f)  # the reference test's 1e-4
    assert (np.sign(f.numpy()) == yte).mean() > 0.85


def test_one_vs_rest_and_its_collapse_match_jax():
    X, y = _classes()
    gamma = np.float32(float(gamma_max(jnp.asarray(X))) * 0.5)
    jm = jmc.train_one_vs_rest(jnp.asarray(X), jnp.asarray(y), 3, gamma, 10.0)
    tm = svm.train_one_vs_rest(X, y, 3, gamma, 10.0, device="cpu")
    assert tuple(tm.alpha_y.shape) == (3, len(y)) and tuple(tm.b.shape) == (3,)
    s = multiclass.ovr_scores(tm, X)
    _close(s, jmc.ovr_scores(jm, jnp.asarray(X)))
    pred = svm.ovr_predict(tm, X).numpy()
    assert (pred == y).mean() > 0.9
    np.testing.assert_array_equal(pred, np.asarray(jmc.ovr_predict(jm, jnp.asarray(X))))
    ja, ta = jmc.approximate_ovr(jm), multiclass.approximate_ovr(tm)
    for name in ("c", "v", "M", "b", "gamma", "max_sv_sq_norm"):
        got, ref = getattr(ta, name), np.asarray(getattr(ja, name))
        assert tuple(got.shape) == ref.shape, name
        _close(got, ref, rel=1e-4, atol=1e-6)
    sa = multiclass.approx_ovr_scores(ta, X)
    _close(sa, jmc.approx_ovr_scores(ja, jnp.asarray(X)))
    pred_a = multiclass.approx_ovr_predict(ta, X).numpy()
    assert (pred_a != pred).mean() < 0.05


@pytest.mark.parametrize(
    "family,opts",
    [("maclaurin", {}), ("fourier", {"structured": True, "num_features": 64})],
)
def test_compile_ovr_matches_the_family_compile(family, opts):
    X, y = _classes(seed=4)
    gamma = np.float32(float(gamma_max(jnp.asarray(X))) * 0.5)
    tm = svm.train_one_vs_rest(X, y, 3, gamma, 10.0, device="cpu")
    art = svm.compile_ovr(tm, family, seed=1, **opts)
    want = families.get_family(family).compile(tm, seed=1, **opts)
    assert art.digest() == want.digest()
    assert art.num_heads == 3 and art.multiclass


def test_labels_and_devices(monkeypatch):
    y = torch.tensor([0.0, 2.0, 1.0, 2.0])
    assert multiclass.binary_labels(y, 2).tolist() == [-1.0, 1.0, -1.0, 1.0]
    X, yb, _, _ = _blob_task(n=30)
    tm = svm.train_lssvm(torch.from_numpy(X), torch.from_numpy(yb), 0.05, 10.0)
    assert tm.X.device.type == "cpu"  # tensors train where they lie
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svm.train_lssvm(X, yb, 0.05, 10.0)  # numpy: cuda by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svm.train_svc(X, yb, 0.05, 1.0, num_steps=3)
