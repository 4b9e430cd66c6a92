"""The slice as a whole on the CPU: poly2, dense and Fastfood fourier and
the int8 variants, ``compile_model`` and the engine over every (family,
dtype) cell, against the JAX package on the same seeded models."""

from itertools import product

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import Budget as JBudget  # noqa: E402
from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core import compile_model as j_compile_model  # noqa: E402
from repro.core import gamma_max  # noqa: E402
from repro.core import poly2 as jpoly2  # noqa: E402
from repro.core.families import fourier as jfourier  # noqa: E402
from repro.core.families import get_family as j_get_family  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.serve.svm_engine import SVMEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Budget, compile_model, families  # noqa: E402
from repro_torch.core import poly2 as tpoly2  # noqa: E402
from repro_torch.core.families import CompiledArtifact  # noqa: E402
from repro_torch.kernels.common import autotune  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.serve import SVMEngine  # noqa: E402

NUM_FEATURES = 200  # not a multiple of the 64-feature tile
FAMILY_NAMES = ("maclaurin", "poly2", "fourier")
CELLS = [(f, dt) for f in FAMILY_NAMES for dt in ("float32", "int8")]
# "fastfood" is fourier with structured=True (kernels B6/B7)
ALL_CELLS = CELLS + [("fastfood", dt) for dt in ("float32", "int8")]


def _family(cell):
    """(family name, compile options) of a parametrized cell name."""
    if cell == "fastfood":
        return "fourier", {"structured": True, "num_features": NUM_FEATURES}
    return cell, {"num_features": NUM_FEATURES}


def _svm(seed=0, d=8, n_sv=60, heads=None, scale=0.6):
    """A small model straight from an rng, in both packages (the
    reference suite's ``_svm``)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_sv, d)).astype(np.float32) * scale
    gamma = np.float32(float(gamma_max(jnp.asarray(X))) * 0.8)
    if heads is None:
        ay = rng.standard_normal(n_sv).astype(np.float32) * 0.5
        b = np.float32(0.1)
    else:
        ay = rng.standard_normal((heads, n_sv)).astype(np.float32) * 0.5
        b = (0.1 * rng.standard_normal(heads)).astype(np.float32)
    jm = JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.asarray(b),
        gamma=jnp.float32(gamma),
    )
    return jm, convert.svm_from_numpy(X, ay, b, gamma, device="cpu")


def _close(port, ref, rtol=1e-5, atol=1e-6):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


# ------------------------------------------------------------------- poly2


@pytest.mark.parametrize("heads", [None, 3])
def test_poly2_collapse_matches_jax(heads):
    jm, tm = _svm(1, d=9, heads=heads)
    if heads is None:
        j = jpoly2.collapse_rbf_as_poly2(jm)
    else:
        one = lambda ay, b: jpoly2.collapse_rbf_as_poly2(  # noqa: E731
            JSVM(X=jm.X, alpha_y=ay, b=b, gamma=jm.gamma)
        )
        j = jax.vmap(one)(jm.alpha_y, jm.b)
    t = tpoly2.collapse_rbf_as_poly2(tm)
    for name in ("c", "v", "M", "b", "gamma", "max_sv_sq_norm"):
        _close(getattr(t, name), getattr(j, name), rtol=1e-5, atol=1e-6)


def test_exact_poly2_model_and_its_collapse_match_jax():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((40, 6)).astype(np.float32)
    ay = rng.standard_normal(40).astype(np.float32)
    Z = rng.standard_normal((25, 6)).astype(np.float32)
    args = dict(b=np.float32(0.3), gamma=np.float32(0.2), beta=np.float32(1.5))
    jm = jpoly2.Poly2Model(X=jnp.asarray(X), alpha_y=jnp.asarray(ay), **args)
    tm = tpoly2.Poly2Model(
        X=torch.from_numpy(X),
        alpha_y=torch.from_numpy(ay),
        **{k: torch.tensor(v) for k, v in args.items()},
    )
    Zt = torch.from_numpy(Z)
    want = jpoly2.decision_function(jm, Z)
    _close(tpoly2.decision_function(tm, Zt), want, rtol=1e-5, atol=1e-5)
    tc, jc = tpoly2.collapse(tm), jpoly2.collapse(jm)
    for name in ("c", "v", "M", "gamma", "max_sv_sq_norm"):
        _close(getattr(tc, name), getattr(jc, name), rtol=1e-5, atol=1e-5)
    # the collapse is exact: its quadratic form is the kernel sum
    quad = tc.c + Zt @ tc.v + ((Zt @ tc.M) * Zt).sum(-1) + tc.b
    exact = tpoly2.decision_function(tm, Zt)
    torch.testing.assert_close(quad, exact, rtol=1e-4, atol=1e-4)
    sv_sq = (X**2).sum(-1)
    ay_t, sq_t = torch.from_numpy(ay), torch.from_numpy(sv_sq)
    _close(
        tpoly2.equivalent_poly2_alphas(ay_t, sq_t, 0.2),
        jpoly2.equivalent_poly2_alphas(jnp.asarray(ay), jnp.asarray(sv_sq), 0.2),
    )


# -------------------------------------------------------- compile, per cell


@pytest.mark.parametrize("family,dtype", ALL_CELLS)
@pytest.mark.parametrize("heads", [None, 3])
def test_compile_matches_jax(family, dtype, heads):
    """Same arrays (W, the Fastfood operators, phase and every int8 code of
    an operand whose f32 parent is identical: byte for byte; the rest
    within f32 tolerance), same meta keys, same measured errors to f32
    rounding."""
    jm, tm = _svm(7, d=10, heads=heads)
    cell = family
    family, opts = _family(cell)
    opts = dict(dtype=dtype, seed=5, **opts)
    j = j_get_family(family).compile(jm, **opts)
    t = families.get_family(family).compile(tm, **opts)
    assert set(t.arrays) == set(j.arrays)
    assert set(t.meta) == set(j.meta)
    for key, value in j.meta.items():
        if isinstance(value, float):
            np.testing.assert_allclose(t.meta[key], value, rtol=0.05, atol=1e-6)
        else:
            assert t.meta[key] == value, key
    for name, ref in j.arrays.items():
        got, ref = t.arrays[name].numpy(), np.asarray(ref)
        assert got.dtype == ref.dtype, name
        seeded = ("W", "W_scale", "phase") + tuple(a for a in j.arrays if "ff_" in a)
        if family == "fourier" and name in seeded:
            assert got.tobytes() == ref.tobytes(), name
        elif got.dtype == np.int8:  # codes of a parent equal to f32 rounding
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, name
        else:
            _close(got, ref, rtol=2e-4, atol=2e-6)


def test_holdout_sample_bytes_equal():
    jm, tm = _svm(3, d=12, n_sv=50)
    for seed, n in ((0, 256), (9, 31)):
        got = families.fourier.holdout_sample(tm, seed, n)
        ref = np.asarray(jfourier.holdout_sample(jm, seed, n))
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("family,dtype", ALL_CELLS)
def test_port_scores_repro_written_artifacts(family, dtype, tmp_path):
    """A ``repro``-written artifact of every cell, loaded by the port,
    scores the same rows to the same values and validity."""
    jm, _ = _svm(11, d=10, heads=3)
    family, opts = _family(family)
    j_art = j_get_family(family).compile(jm, dtype=dtype, **opts)
    path = j_art.save(str(tmp_path / "a.npz"))
    t_art = CompiledArtifact.load(path, device="cpu")
    assert t_art.digest() == j_art.digest()
    rng = np.random.default_rng(0)
    Z = (rng.standard_normal((40, 10)) * 0.6).astype(np.float32)
    Z[::4] *= 25.0  # outside the Eq 3.11 envelope
    j_s, j_v = map(np.asarray, j_get_family(family).score(j_art, jnp.asarray(Z)))
    t_s, t_v = families.score_artifact(t_art, torch.from_numpy(Z))
    _close(t_s, j_s, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(t_v.numpy(), j_v)
    assert j_v.all() == (family == "fourier")


def test_structured_fourier_waits_for_b6():
    """Kernels B6/B7 are in: structured fourier compiles (F rounded up to
    whole stacks of d' = 8), scores, and resolves the fwht tuning keys."""
    _, tm = _svm(2)
    ff = families.fourier.compile(tm, structured=True, num_features=60)
    assert (ff.meta["dd"], ff.meta["stacks"], ff.meta["num_features"]) == (8, 8, 64)
    scores, valid = families.fourier.score(ff, tm.X)
    assert tuple(scores.shape) == (tm.n_sv, 1) and bool(valid.all())
    assert families.fourier.tile_lookup(ff, 32) == ("fwht", "d8_f64_n32")
    ff8 = families.fourier.quantize_rff_artifact(ff)
    assert families.fourier.tile_lookup(ff8, 32) == ("fwht_q8", "d8_f64_n32")
    art = families.fourier.compile(tm, num_features=64)
    assert families.fourier.tile_lookup(art, 32) == ("rff_score", "d8_f64_n32")
    q8 = families.fourier.quantize_rff_artifact(art)
    assert families.fourier.tile_lookup(q8, 32) == ("rff_score_q8", "d8_f64_n32")


def test_fourier_err_tolerance_sets_the_verdict():
    jm, tm = _svm(5, heads=2)
    for tol in (1e-9, 1e3):
        j = jfourier.compile(jm, num_features=64, err_tolerance=tol)
        t = families.fourier.compile(tm, num_features=64, err_tolerance=tol)
        assert t.meta["valid_globally"] == j.meta["valid_globally"] == (tol > 1)
        _, valid = families.fourier.score(t, tm.X[:7])
        assert valid.shape == (7,) and bool(valid.all()) == (tol > 1)


# ----------------------------------------------------------- compile_model


def _rows(report):
    return {(r["family"], r["dtype"]): r for r in report["families"]}


@pytest.mark.parametrize("cost_margin", [4.0, None])
@pytest.mark.parametrize("seed", [21, 22])
def test_compile_model_matches_jax(seed, cost_margin, monkeypatch):
    """Same (family, dtype) cells, same skips, and the same budget verdict
    on every row whose error is not within 1% of the limit. The winner
    may differ: it is chosen by measured latency. The reference prunes
    with the same prior at the H100's constants (its own are a TPU's)."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    jm, tm = _svm(seed, d=10, n_sv=80, heads=3)
    kw = dict(seed=3, cost_margin=cost_margin)
    j_fo = {"fourier": {"num_features": NUM_FEATURES}}
    j = j_compile_model(jm, JBudget(max_err=0.05), family_opts=j_fo, **kw)
    t = compile_model(tm, Budget(max_err=0.05), family_opts=j_fo, **kw)
    j_rep, t_rep = j.meta["compile_report"], t.meta["compile_report"]
    np.testing.assert_allclose(t_rep["limit"], j_rep["limit"], rtol=1e-5)
    assert t_rep["sample_n"] == j_rep["sample_n"] == 256
    j_rows, t_rows = _rows(j_rep), _rows(t_rep)
    assert [(r["family"], r["dtype"]) for r in t_rep["families"]] == [
        (r["family"], r["dtype"]) for r in j_rep["families"]
    ]
    assert set(t_rows) == set(CELLS)
    for cell, jr in j_rows.items():
        tr = t_rows[cell]
        assert tr.get("skipped") == jr.get("skipped"), cell
        assert set(tr) == set(jr), cell
        if "skipped" in jr:
            continue
        np.testing.assert_allclose(tr["mean_abs"], jr["mean_abs"], rtol=0.05, atol=1e-6)
        assert tr["valid_fraction"] == jr["valid_fraction"]
        assert tr["artifact_bytes"] == jr["artifact_bytes"]
        if abs(jr["mean_abs"] - j_rep["limit"]) > 0.01 * j_rep["limit"]:
            assert tr["meets_budget"] == jr["meets_budget"], cell
    assert t_rows[(t.family, t.dtype)]["meets_budget"]
    assert t_rep["chosen"] == t.family and t_rep["chosen_dtype"] == t.dtype


def test_compile_model_reports_structured_fourier_as_skipped(monkeypatch):
    """Structured fourier is no longer skipped: both of its cells are
    measured or pruned by the prior, exactly as the reference's are at the
    H100's constants, with the same budget verdicts."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    jm, tm = _svm(21, d=10, n_sv=80, heads=3)
    fo = {"fourier": {"structured": True, "num_features": 256}}
    j = j_compile_model(jm, JBudget(max_err=0.05), seed=3, family_opts=fo)
    t = compile_model(tm, Budget(max_err=0.05), seed=3, family_opts=fo)
    j_rows, t_rows = _rows(j.meta["compile_report"]), _rows(t.meta["compile_report"])
    assert set(t_rows) == set(j_rows) == set(CELLS)
    for dt in ("float32", "int8"):
        tr, jr = t_rows[("fourier", dt)], j_rows[("fourier", dt)]
        assert tr.get("skipped") in (None, "pruned_by_cost")
        assert tr.get("skipped") == jr.get("skipped")
        assert "predicted_cost_s" in tr
        if "mean_abs" in jr:
            np.testing.assert_allclose(tr["mean_abs"], jr["mean_abs"], rtol=0.05)
            assert tr["meets_budget"] == jr["meets_budget"]
            assert tr["artifact_bytes"] == jr["artifact_bytes"]


def test_compile_model_impossible_budget_raises_and_budget_validates():
    _, tm = _svm(22)
    with pytest.raises(ValueError, match="no family meets"):
        compile_model(tm, Budget(max_err=1e-12, metric="max_abs"), seed=1)
    with pytest.raises(ValueError):
        Budget(max_err=0.1, metric="p99")
    with pytest.raises(ValueError):
        Budget(max_err=0.1, min_valid=1.5)
    with pytest.raises(ValueError, match="dtype"):
        compile_model(tm, Budget(max_err=1.0), dtypes=("float16",))


def test_compile_model_family_opts_override_defaults():
    _, tm = _svm(23, d=6, n_sv=30)
    art = compile_model(
        tm,
        Budget(max_err=10.0),
        seed=1,
        families=("fourier",),
        family_opts={"fourier": {"seed": 7, "num_features": 32}},
    )
    assert art.meta["seed"] == 7 and art.meta["num_features"] == 32


def test_roofline_priors_are_the_reference_at_h100_constants(monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (67e12, 3.35e12)
    for n, d, k in ((1, 780, 10), (256, 10, 3), (4096, 64, 1)):
        for family in ("maclaurin", "poly2", "fourier"):
            for dt in ("float32", "int8"):
                for f, structured in product((None, 4096), (False, True)):
                    args = dict(n=n, d=d, k=k, num_features=f, structured=structured)
                    want = jroofline.family_candidate_seconds(family, dt, **args)
                    got = roofline.family_candidate_seconds(family, dt, **args)
                    assert got == pytest.approx(want, rel=1e-12)
    prior = roofline.family_candidate_seconds
    assert prior("nope", "int8", n=1, d=8, k=1) is None


def test_autotune_measure_on_the_cpu():
    calls = []
    t = autotune.measure(lambda: calls.append(1), repeats=3, warmup=2)
    assert len(calls) == 5 and 0.0 <= t < 1.0


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("family,dtype", ALL_CELLS)
def test_engine_serves_every_cell_like_the_jax_engine(family, dtype, tmp_path):
    """One ``repro``-written artifact of each cell, served by both engines
    to the same traffic: same values, validity, labels and fallbacks."""
    jm, tm = _svm(31, d=10, heads=3)
    family, opts = _family(family)
    j_art = j_get_family(family).compile(jm, dtype=dtype, **opts)
    t_art = CompiledArtifact.load(j_art.save(str(tmp_path / "a.npz")), device="cpu")
    arts = [(j_art, t_art)]
    if family == "fourier":  # a failed held-out verdict sends every row back
        failed = {"valid_globally": False}
        arts.append((j_art.with_meta(**failed), t_art.with_meta(**failed)))
    rng = np.random.default_rng(2)
    sizes = (1, 33, 64)
    for j_a, t_a in arts:
        j_eng, t_eng = JEngine(j_a, jm), SVMEngine(t_a, tm, device="cpu")
        assert t_eng.warmup([1, 64]) == 2
        for n in sizes:
            Z = (rng.standard_normal((n, 10)) * 0.6).astype(np.float32)
            Z[::3] *= 25.0
            jr, tr = j_eng.submit(Z), t_eng.submit(Z)
            _close(tr.values, jr.values, rtol=2e-4, atol=2e-4)
            np.testing.assert_array_equal(tr.valid, jr.valid)
            np.testing.assert_array_equal(tr.labels, jr.labels)
        t_fb = t_eng.stats.fallback_instances
        assert t_fb == j_eng.stats.fallback_instances
        if not t_a.meta.get("valid_globally", True):
            assert t_fb == sum(sizes)
        else:
            assert (t_fb > 0) == (family != "fourier")
