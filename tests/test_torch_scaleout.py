"""The port's scale-out layer on the CPU: replicated engine dispatch
(round-robin flushes, per-replica breakers, fault isolation, atomic
replica retirement), head-sharded serving over a 4-way mesh of CPU
devices (pad -> split -> gather parity for every (family, dtype), and
K = 4096), the SV-sharded exact path, and the roofline prior's pieces
(``rbf_tile_seconds``, ``prune_candidates``, cost pruning in
``compile_model``); the cases of ``tests/test_scaleout.py`` with
``device="cpu"``. ``repro``'s suite forces host devices to shard; here a
mesh may list one device several times, so its four shards always pad
and split. Then the parity of the two packages on the same seeded
inputs: ``pad_heads``, ``score_sharded``, the SV-sharded
``submit_exact`` and the prior."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.core.families import get_family as j_get_family  # noqa: E402
from repro.core.rbf import SVMModel as JSVM  # noqa: E402
from repro.kernels.common import autotune as jautotune  # noqa: E402
from repro.kernels.common.config import TileConfig as JTileConfig  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.serve.svm_engine import SVMEngine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend, gamma_max  # noqa: E402
from repro_torch.core.families import (  # noqa: E402
    PAD_HEAD_BIAS,
    Budget,
    CompiledArtifact,
    compile_model,
    fourier,
    get_family,
    maclaurin,
)
from repro_torch.core.families.base import base_meta  # noqa: E402
from repro_torch.kernels.common import TileConfig, autotune, tuning  # noqa: E402
from repro_torch.launch import Mesh, make_mesh, roofline  # noqa: E402
from repro_torch.serve import PublishSpec, Runtime, SVMEngine  # noqa: E402
from repro_torch.serve.runtime import (  # noqa: E402
    ENGINE_STEP,
    ArtifactRegistry,
    FaultInjector,
    InjectedFault,
    MetricsRegistry,
    Observability,
)

ENGINE_OPTS = dict(device="cpu", min_bucket=8, max_batch=64)
SHARDS = 4
TIMEOUT = 30.0  # seconds any one future is waited on


def _arrays(seed=0, d=8, n_sv=40, k=None, bias=0.1, scale=0.6):
    """(X, alpha_y, b, gamma) of a seeded model: binary, or one-vs-rest
    with ``k`` heads."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_sv, d)).astype(np.float32) * scale
    gamma = np.float32(float(gamma_max(torch.from_numpy(X))) * 0.8)
    if k is None:
        ay = rng.standard_normal(n_sv).astype(np.float32) * 0.5
        return X, ay, np.float32(bias), gamma
    ay = rng.standard_normal((k, n_sv)).astype(np.float32) * 0.5
    b = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return X, ay, b, gamma


def _svm(seed=0, d=8, n_sv=40, bias=0.1, scale=0.6):
    return convert.svm_from_numpy(*_arrays(seed, d, n_sv, None, bias, scale), device="cpu")


def _svm_mc(seed=0, d=8, n_sv=40, k=6, scale=0.6):
    """One-vs-rest multiclass model: (k, n_sv) duals, (k,) biases."""
    return convert.svm_from_numpy(*_arrays(seed, d, n_sv, k, scale=scale), device="cpu")


def _jsvm(X, ay, b, gamma):
    return JSVM(
        X=jnp.asarray(X), alpha_y=jnp.asarray(ay), b=jnp.asarray(b), gamma=jnp.float32(gamma)
    )


def _exact_scores(m, Z):
    """float64 exact expansion, (n, K)."""
    X = m.X.double().numpy()
    ay = m.alpha_y.double().numpy()
    ay2 = ay if ay.ndim == 2 else ay[None, :]
    b = np.broadcast_to(m.b.double().numpy(), (ay2.shape[0],))
    d2 = ((Z.astype(np.float64)[:, None, :] - X[None]) ** 2).sum(-1)
    return np.exp(-float(m.gamma) * d2) @ ay2.T + b[None, :]


def _rows(rng, n, d=8, scale=0.3):
    return rng.standard_normal((n, d)).astype(np.float32) * scale


def _head_mesh():
    return make_mesh((SHARDS,), ("heads",), devices=["cpu"] * SHARDS)


# ---------------------------------------------------------- replica dispatch


def test_replicated_publish_spreads_flushes_and_conserves():
    m = _svm(1)
    art = maclaurin.compile(m)
    with Runtime(engine_opts=ENGINE_OPTS, max_wait_us=500.0) as rt:
        rt.publish("m", art, PublishSpec(exact=m, replicas=3))
        _, engines = rt.registry.get_engines("m")
        assert len(engines) == 3
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))  # warm + build
        cache_before = sum(e.jit_cache_size() for e in engines)
        # sequential submits: idle replicas tie on load, so the round-robin
        # tiebreak must rotate flushes across all three
        for _ in range(6):
            Z = _rows(rng, 8)
            res = rt.submit("m", Z).result(timeout=TIMEOUT)
            np.testing.assert_allclose(res.values, _exact_scores(m, Z)[:, 0], atol=0.15)
        st = rt.stats("m")
        per = st["replicas"]
        assert sorted(per) == ["0", "1", "2"]
        assert all(per[i]["flushes"] >= 1 for i in per)
        assert sum(per[i]["flushes"] for i in per) == st["flushes"]
        assert sum(per[i]["rows"] for i in per) == st["rows"]
        assert st["failed_requests"] == 0 and st["shed_requests"] == 0
        assert st["queue_rows"] == 0
        # replicated dispatch resolves no new bucket after warm-up
        assert sum(e.jit_cache_size() for e in engines) == cache_before


def test_replica_fault_trips_only_its_own_breaker():
    m = _svm(2)
    fi = FaultInjector(0)
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        max_wait_us=500.0,
        breaker=dict(fail_threshold=1, reset_after_s=60.0),
    ) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m, replicas=3))
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))  # warm flush -> replica 0
        # script the NEXT flush on replica 1 only; siblings stay healthy
        fi.fail_next(FaultInjector.replica_site(ENGINE_STEP, 1), 1)
        doomed = rt.submit("m", _rows(rng, 3))  # rotation -> replica 1
        with pytest.raises(InjectedFault):
            doomed.result(timeout=TIMEOUT)
        # replica 1 is open (threshold 1); 0 and 2 keep the fast path, the
        # model never degrades to exact serving
        served = 0
        for _ in range(6):
            res = rt.submit("m", _rows(rng, 4)).result(timeout=TIMEOUT)
            assert res.valid.all()  # fast path, not degraded
            served += 1
        st = rt.stats("m")
        per = st["replicas"]
        assert per["1"]["breaker_state"] == "open"
        assert per["1"]["trips"] == 1 and per["1"]["failures"] == 1
        assert per["0"]["breaker_state"] == "closed"
        assert per["2"]["breaker_state"] == "closed"
        assert per["0"]["flushes"] >= 1 and per["2"]["flushes"] >= 1
        assert st["batch_failures"] == 1 and st["failed_requests"] == 1
        assert st["breaker"]["degraded_requests"] == 0
        # accounting conserves: warm + doomed + served all enqueued
        assert st["requests"] == 1 + 1 + served
        assert st["queue_rows"] == 0


def test_all_replicas_open_degrades_once_and_keeps_drift_window_clean():
    m = _svm(3)
    fi = FaultInjector(0)
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        max_wait_us=500.0,
        breaker=dict(fail_threshold=1, reset_after_s=60.0),
    ) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m, replicas=2))
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))  # warm: 2 valid fast-path rows
        for i in range(2):
            fi.fail_next(FaultInjector.replica_site(ENGINE_STEP, i), 1)
        for _ in range(2):  # rotation trips replica 0 then replica 1
            with pytest.raises(InjectedFault):
                rt.submit("m", _rows(rng, 2)).result(timeout=TIMEOUT)
        # every breaker refuses -> ONE degraded exact flush for the model
        Z = _rows(rng, 5)
        res = rt.submit("m", Z).result(timeout=TIMEOUT)
        np.testing.assert_allclose(
            res.values, _exact_scores(m, Z)[:, 0], rtol=1e-4, atol=1e-5
        )
        assert not res.valid.any()  # exact-served rows
        st = rt.stats("m")
        assert st["replicas"]["0"]["breaker_state"] == "open"
        assert st["replicas"]["1"]["breaker_state"] == "open"
        assert st["breaker"]["degraded_requests"] == 1
        assert st["breaker"]["degraded_rows"] == 5
        # degraded rows never enter the drift window: only the warm flush's
        # 2 valid rows were recorded (a fault is not drift)
        win = st["fallback_window"]
        assert win["rows"] == 2 and win["invalid"] == 0


def test_registry_retires_every_replica_on_count_change():
    art = maclaurin.compile(_svm(4))
    reg = ArtifactRegistry(warmup_on_load=False, engine_opts=ENGINE_OPTS)
    reg.publish("m", art, PublishSpec(replicas=2))
    _, two = reg.get_engines("m")
    assert len(two) == 2
    reg.publish("m", art, PublishSpec(replicas=3))  # same digest, new scale
    _, three = reg.get_engines("m")
    assert len(three) == 3
    # atomic retirement: no old engine survives into the new set
    assert not set(map(id, two)) & set(map(id, three))
    # replicas=None re-publish keeps the scale AND the built engines
    reg.publish("m", art)
    _, again = reg.get_engines("m")
    assert len(again) == 3
    assert [id(e) for e in again] == [id(e) for e in three]


def test_runtime_survives_replica_count_change_mid_traffic():
    m = _svm(5)
    art = maclaurin.compile(m)
    with Runtime(engine_opts=ENGINE_OPTS, max_wait_us=500.0) as rt:
        rt.publish("m", art, PublishSpec(exact=m, replicas=2))
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))
        rt.publish("m", art, PublishSpec(exact=m, replicas=3))  # hot re-scale
        Z = _rows(rng, 4)
        vals, _ = rt.predict("m", Z)  # stale batcher retired, rebuilt
        np.testing.assert_allclose(vals, _exact_scores(m, Z)[:, 0], atol=0.15)
        assert len(rt.registry.get_engines("m")[1]) == 3


# ------------------------------------------------------ head-sharded serving


def test_pad_heads_is_argmax_and_validity_neutral():
    art = maclaurin.compile(_svm_mc(6, k=6))
    padded = maclaurin.pad_heads(art, 4)  # 6 -> 8 heads
    assert padded.meta["padded_heads"] == 8
    assert padded.meta["num_heads"] == 6  # real width preserved
    Z = torch.from_numpy(_rows(np.random.default_rng(0), 16))
    ref, ref_valid = maclaurin.score(art, Z)
    got, got_valid = maclaurin.score(padded, Z)
    np.testing.assert_allclose(got[:, :6].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    # pad heads score PAD_HEAD_BIAS: argmax can never land on them
    assert int(got.argmax(1).max()) < 6
    assert torch.equal(got_valid, ref_valid)
    # already-aligned width is a no-op, not a copy
    assert maclaurin.pad_heads(art, 2) is art


def _sharded_pair(art, **opts):
    """(unsharded, head-sharded) engines on ``art``."""
    opts = dict(ENGINE_OPTS, **opts)
    return SVMEngine(art, **opts), SVMEngine(art, head_mesh=_head_mesh(), **opts)


def _assert_same(r_shd, r_ref, valid=True):
    np.testing.assert_allclose(r_shd.values, r_ref.values, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(r_shd.labels, r_ref.labels)
    if valid:
        np.testing.assert_array_equal(r_shd.valid, r_ref.valid)


def test_head_sharded_engine_matches_unsharded():
    k = 4 * SHARDS + 1  # forces padding
    m = _svm_mc(7, k=k)
    art = maclaurin.compile(m)
    ref, shd = _sharded_pair(art)
    assert shd._serve_artifact.meta["padded_heads"] % SHARDS == 0
    Z = _rows(np.random.default_rng(0), 32)
    r_ref = ref.submit(Z)
    r_shd = shd.submit(Z)
    assert r_shd.values.shape == (32, k)  # pad columns sliced
    _assert_same(r_shd, r_ref)


def test_head_sharded_fourier_matches_unsharded():
    k = 2 * SHARDS + 1
    m = _svm_mc(8, k=k, scale=0.4)
    art = fourier.compile(m, num_features=512)
    ref, shd = _sharded_pair(art)
    Z = _rows(np.random.default_rng(1), 16, scale=0.25)
    _assert_same(shd.submit(Z), ref.submit(Z), valid=False)


def test_head_sharded_int8_quadform_matches_unsharded():
    k = 2 * SHARDS + 1  # forces padding
    m = _svm_mc(9, k=k)
    q = maclaurin.compile(m, dtype="int8")
    ref, shd = _sharded_pair(q)
    Z = _rows(np.random.default_rng(0), 16)
    _assert_same(shd.submit(Z), ref.submit(Z))


def test_head_sharded_fastfood_matches_unsharded():
    k = 2 * SHARDS + 1
    m = _svm_mc(9, k=k, scale=0.4)
    for dtype in ("float32", "int8"):
        art = fourier.compile(m, num_features=256, structured=True, dtype=dtype)
        ref, shd = _sharded_pair(art)
        Z = _rows(np.random.default_rng(1), 16, scale=0.25)
        _assert_same(shd.submit(Z), ref.submit(Z), valid=False)


def _fastfood_arrays(k, d, num_features, seed):
    """numpy arrays of a K-head Fastfood artifact built straight from an rng
    (the reference suite's ``_synthetic_fastfood_artifact``): compiling a
    real K = 4096 one-vs-rest model would dwarf the test."""
    rng = np.random.default_rng(seed)
    arrays, f, proj_meta = fourier._fastfood_arrays(rng, d, num_features, 0.5)
    arrays = dict(arrays)
    arrays["phase"] = rng.uniform(0, 2 * np.pi, (f,)).astype(np.float32)
    arrays["weights"] = (rng.standard_normal((k, f)) * 0.05).astype(np.float32)
    arrays["b"] = (rng.standard_normal(k) * 0.1).astype(np.float32)
    meta = base_meta(
        d=d,
        num_heads=k,
        multiclass=True,
        kind="rff",
        validity="global",
        num_features=f,
        seed=seed,
        **proj_meta,
    )
    return arrays, meta


def _synthetic_fastfood_artifact(k, d=32, num_features=64, seed=0, dtype="float32"):
    arrays, meta = _fastfood_arrays(k, d, num_features, seed)
    art = CompiledArtifact(
        family="fourier",
        arrays={n: torch.from_numpy(a) for n, a in arrays.items()},
        meta=meta,
    )
    if dtype == "int8":
        art = fourier.quantize_fastfood_artifact(art)
    return art


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_head_sharded_fastfood_argmax_parity_at_k4096(dtype):
    """Extreme multiclass (K = 4096) Fastfood serving under a head mesh keeps
    exact argmax parity with the unsharded path."""
    art = _synthetic_fastfood_artifact(4096, dtype=dtype)
    Z = _rows(np.random.default_rng(2), 24, d=32)
    ref, shd = _sharded_pair(art)
    r_ref = ref.submit(Z)
    r_shd = shd.submit(Z)
    assert r_shd.values.shape == (24, 4096)
    _assert_same(r_shd, r_ref, valid=False)


def test_runtime_serves_head_sharded_replicas():
    """The two scale-out axes compose: replicated dispatch over engines that
    each serve the head-sharded path."""
    m = _svm_mc(10, k=6)
    art = maclaurin.compile(m)
    opts = dict(ENGINE_OPTS, head_mesh=_head_mesh())
    with Runtime(engine_opts=opts, max_wait_us=500.0) as rt:
        rt.publish("mc", art, PublishSpec(replicas=2))
        rng = np.random.default_rng(0)
        Z = _rows(rng, 8)
        res = rt.submit("mc", Z).result(timeout=TIMEOUT)
        assert res.values.shape == (8, 6)
        np.testing.assert_array_equal(res.labels, _exact_scores(m, Z).argmax(1))


# ------------------------------------------------------------ roofline prior


def test_roofline_prior_ranks_bigger_tiles_cheaper():
    # the H100 does 20 fp32 flops a byte of HBM: a 64-row tile already
    # binds on operations here, so the small tile is 8 rows (the
    # reference's prior, at a TPU's 240 flops a byte, takes 64)
    small = TileConfig(block_n=8)
    big = TileConfig(block_n=512)
    t_small = roofline.quadform_tile_seconds(small, n=1024, d=64, k=8)
    t_big = roofline.quadform_tile_seconds(big, n=1024, d=64, k=8)
    # fewer row blocks stream the stacked Hessian fewer times
    assert t_big < t_small
    assert roofline.rbf_tile_seconds(big, n=1024, d=64, m=512) < roofline.rbf_tile_seconds(
        small, n=1024, d=64, m=512
    )
    # family-level closed forms: int8 streams fewer weight bytes (at 8 rows,
    # where the H100's prior binds on them)
    f32 = roofline.family_candidate_seconds("maclaurin", "float32", n=8, d=32, k=8)
    i8 = roofline.family_candidate_seconds("maclaurin", "int8", n=8, d=32, k=8)
    assert i8 < f32
    nope = roofline.family_candidate_seconds("nope", "float32", n=256, d=32, k=8)
    assert nope is None


def test_prune_candidates_keeps_default_under_any_prior():
    default = tuning.DEFAULTS["quadform"]
    # the port's default is block_n=128, so the other candidates are tiles
    # beside it (the reference's list would name the default twice)
    cands = [TileConfig(block_n=b) for b in (32, 64, 256)] + [default]
    prior = lambda cfg: roofline.quadform_tile_seconds(cfg, n=512, d=32, k=4)
    kept = autotune.prune_candidates(cands, default, prior, keep=1)
    assert default in kept  # never-worse-than-default survives pruning
    assert len(kept) <= 2
    assert kept == [c for c in cands if c in set(kept)]  # order preserved
    # an adversarial prior (default ranked worst) still keeps it
    bad = autotune.prune_candidates(cands, default, lambda c: -prior(c), keep=1)
    assert default in bad


def test_compile_model_prunes_predictably_expensive_candidates():
    m = _svm(11, scale=0.4)
    sample = _rows(np.random.default_rng(0), 64, scale=0.3)
    art = compile_model(
        m,
        Budget(max_err=0.05),
        sample=sample,
        families=("maclaurin", "fourier"),
        family_opts={"fourier": {"num_features": 65536}},
    )
    rows = art.meta["compile_report"]["families"]
    pruned = [r for r in rows if r.get("skipped") == "pruned_by_cost"]
    assert pruned, rows  # a 65536-feature basis prices itself out
    assert all("predicted_cost_s" in r for r in pruned)
    assert art.family == "maclaurin"
    # exhaustive mode: cost_margin=None measures everything
    art2 = compile_model(
        m,
        Budget(max_err=0.05),
        sample=sample,
        families=("maclaurin",),
        cost_margin=None,
    )
    rows2 = art2.meta["compile_report"]["families"]
    assert not any(r.get("skipped") == "pruned_by_cost" for r in rows2)


# --------------------------------------------- observability across replicas


def test_per_replica_span_counts_sum_to_model_totals_under_faults():
    """The tracer's per-replica served sub-keys (plus the degraded sub-key)
    partition the model's served total, and a scripted per-replica fault
    is attributed to exactly that replica's flush."""
    m = _svm(5)
    fi = FaultInjector(0)
    obs = Observability(seed=2, registry=MetricsRegistry())
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        max_wait_us=500.0,
        breaker=dict(fail_threshold=1, reset_after_s=60.0),
        obs=obs,
    ) as rt:
        digest = rt.publish(
            "m", maclaurin.compile(m), PublishSpec(exact=m, replicas=3)
        )
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))  # warm flush -> replica 0
        fi.fail_next(FaultInjector.replica_site(ENGINE_STEP, 1), 1)
        doomed = rt.submit("m", _rows(rng, 3))  # rotation -> replica 1
        with pytest.raises(InjectedFault):
            doomed.result(timeout=TIMEOUT)
        for _ in range(6):
            rt.submit("m", _rows(rng, 4)).result(timeout=TIMEOUT)

        st = rt.stats("m")
        counts = obs.tracer.counts(digest[:12])
        per_replica = {
            i: counts.get(f"request.served[replica={i}]", 0) for i in range(3)
        }
        degraded = counts.get("request.served[degraded]", 0)
        assert sum(per_replica.values()) + degraded == counts["request.served"]
        assert counts["request.served"] == st["served_requests"] == 7
        assert degraded == 0  # siblings kept the fast path
        # replica 1 served nothing after its trip; 0 and 2 carried the load
        assert per_replica[1] == 0
        assert per_replica[0] >= 1 and per_replica[2] >= 1
        # the injected fault is attributed to replica 1, span- and count-wise
        assert counts.get("flush.failed[replica=1]", 0) == 1
        assert counts.get("request.failed", 0) == 1 == st["failed_requests"]
        cons = obs.tracer.conservation(digest[:12])
        assert cons["unaccounted"] == 0 and cons["submitted"] == 8


def test_degraded_rows_never_appear_in_validity_spans():
    """flush.validity spans cover fast-path rows only: a degraded
    (all-breakers-open) exact flush emits flush.degraded and degraded
    request.served spans instead, so the validity spans' row total equals
    the fallback window's."""
    m = _svm(3)
    fi = FaultInjector(0)
    obs = Observability(seed=4, registry=MetricsRegistry())
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        max_wait_us=500.0,
        breaker=dict(fail_threshold=1, reset_after_s=60.0),
        obs=obs,
    ) as rt:
        digest = rt.publish(
            "m", maclaurin.compile(m), PublishSpec(exact=m, replicas=2)
        )
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))  # warm: 2 fast-path rows
        for i in range(2):
            fi.fail_next(FaultInjector.replica_site(ENGINE_STEP, i), 1)
        for _ in range(2):  # trip both breakers
            with pytest.raises(InjectedFault):
                rt.submit("m", _rows(rng, 2)).result(timeout=TIMEOUT)
        res = rt.submit("m", _rows(rng, 5)).result(timeout=TIMEOUT)
        assert not res.valid.any()  # exact-served rows

        key = digest[:12]
        validity = obs.tracer.spans(key, "flush.validity")
        assert validity, "fast-path flushes must record validity spans"
        assert all(not s["attrs"].get("degraded") for s in validity)
        valid_rows = sum(s["attrs"]["rows"] for s in validity)
        st = rt.stats("m")
        assert valid_rows == st["fallback_window"]["rows"] == 2
        # the degraded flush is traced as degraded, not as drift evidence
        degraded = obs.tracer.spans(key, "flush.degraded")
        assert len(degraded) == 1 and degraded[0]["attrs"]["rows"] == 5
        served = obs.tracer.spans(key, "request.served")
        by_degraded = [s for s in served if s["attrs"].get("degraded")]
        assert len(by_degraded) == 1
        assert all("replica" not in s["attrs"] for s in by_degraded)
        assert obs.tracer.counts(key).get("request.served[degraded]") == 1


# ------------------------------------------------------------ the port's mesh


def test_make_mesh_lays_devices_out_and_refuses_bad_shapes():
    mesh = make_mesh((2, 3), ("heads", "data"), devices=["cpu"] * 6)
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ("heads", "data")
    assert mesh.shape == {"heads": 2, "data": 3}
    assert mesh.devices == (torch.device("cpu"),) * 6 and mesh.size == 6
    assert mesh.shard_devices() == (torch.device("cpu"),) * 2
    assert make_mesh((3,), ("heads",), devices=["cpu"] * 3) == make_mesh(
        (3,), ("heads",), devices=[torch.device("cpu")] * 3
    )
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("heads",), devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("heads",), devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("heads", "heads"), devices=["cpu"] * 4)


def test_mesh_without_devices_takes_the_cards_and_raises_without_one():
    if torch.cuda.is_available():
        mesh = make_mesh((torch.cuda.device_count(),), ("heads",))
        assert all(d.type == "cuda" for d in mesh.devices)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1,), ("heads",))


def test_sharded_primitives_refuse_heads_that_do_not_split():
    mesh = _head_mesh()
    rng = np.random.default_rng(0)
    k, d = 5, 4
    M = torch.from_numpy(rng.standard_normal((k, d, d)).astype(np.float32))
    vecs = [torch.ones(k) for _ in range(4)]
    with pytest.raises(ValueError, match="must divide by mesh axis 'heads'"):
        backend.quadform_heads_sharded(
            torch.ones(3, d), M, torch.ones(k, d), *vecs, mesh=mesh
        )
    with pytest.raises(ValueError, match="must divide"):
        backend.rff_score_sharded(
            torch.ones(3, d),
            torch.ones(8, d),
            torch.ones(8),
            torch.ones(k, 8),
            torch.ones(k),
            mesh=mesh,
        )


def test_sharded_primitive_takes_placed_operands_and_moves_none():
    """Operands passed as the tuples ``shard_heads`` / ``replicate`` give are
    used as they are, and a placed artifact is placed once per mesh."""
    mesh = _head_mesh()
    art = maclaurin.compile(_svm_mc(12, k=8))
    a = art.arrays
    names = ("M", "v", "c", "b", "gamma", "msq")
    Z = torch.from_numpy(_rows(np.random.default_rng(3), 10))
    whole = backend.quadform_heads_sharded(Z, *(a[n] for n in names), mesh=mesh)
    parts = [backend.shard_heads(a[n], mesh) for n in names]
    assert all(p.data_ptr() == a["M"][2 * i].data_ptr() for i, p in enumerate(parts[0]))
    placed = backend.quadform_heads_sharded(Z, *parts, mesh=mesh)
    assert all(torch.equal(x, y) for x, y in zip(whole, placed))
    first = maclaurin.place_shards(art, mesh)
    assert maclaurin.place_shards(art, mesh) is first
    assert maclaurin.place_shards(art, make_mesh((2,), ("h",), ["cpu"] * 2)) is not first


def test_pad_heads_gives_neutral_heads_for_every_family():
    m = _svm_mc(13, k=5)
    Z = torch.from_numpy(_rows(np.random.default_rng(4), 12))
    Z[::3] *= 40.0  # outside the Eq 3.11 envelope
    for family, opts in (("maclaurin", {}), ("poly2", {}), ("fourier", {}), ("ff", {})):
        for dtype in ("float32", "int8"):
            fam = get_family("fourier" if family == "ff" else family)
            kw = dict(opts, dtype=dtype)
            if family == "ff":
                kw.update(structured=True, num_features=64)
            art = fam.compile(m, **kw)
            padded = fam.pad_heads(art, SHARDS)
            assert padded.meta["padded_heads"] == 8 and padded.num_heads == 5
            assert padded.digest() != art.digest()
            s0, v0 = fam.score(art, Z)
            s1, v1 = fam.score(padded, Z)
            assert torch.isfinite(s1).all()
            assert torch.equal(s1[:, 5:], torch.full((12, 3), PAD_HEAD_BIAS))
            assert int(s1.argmax(1).max()) < 5
            assert torch.equal(v0, v1)
            np.testing.assert_allclose(s1[:, :5].numpy(), s0.numpy(), rtol=1e-6, atol=1e-6)


def test_sv_sharded_exact_path_matches_unsharded():
    """``mesh=`` splits the exact model's SVs (zero-padded: 41 SVs on 4
    shards) for the per-row fallback and ``submit_exact`` alike."""
    m = _svm_mc(14, n_sv=41, k=3)
    art = maclaurin.compile(m)
    ref = SVMEngine(art, m, **ENGINE_OPTS)
    shd = SVMEngine(art, m, mesh=_head_mesh(), **ENGINE_OPTS)
    assert [x.shape[0] for x in shd._X] == [11] * 4
    Z = _rows(np.random.default_rng(5), 20)
    Z[::4] *= 40.0  # the fallback re-scores these through the shards
    r_ref, r_shd = ref.submit(Z), shd.submit(Z)
    assert not r_shd.valid.all()
    _assert_same(r_shd, r_ref)
    x_ref, x_shd = ref.submit_exact(Z), shd.submit_exact(Z)
    np.testing.assert_allclose(x_shd.values, x_ref.values, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_shd.values, _exact_scores(m, Z), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(x_shd.labels, x_ref.labels)
    # both axes at once: 3 heads padded to 4 on the fast path, the rows
    # outside the envelope patched through the split SVs, columns sliced
    both = SVMEngine(art, m, mesh=_head_mesh(), head_mesh=_head_mesh(), **ENGINE_OPTS)
    _assert_same(both.submit(Z), r_ref)


# ------------------------------------------------------ parity with repro


CELLS = [
    ("maclaurin", "float32", {}),
    ("maclaurin", "int8", {}),
    ("fourier", "float32", {"num_features": 200}),
    ("fourier", "int8", {"num_features": 200}),
    ("fastfood", "float32", {"num_features": 200, "structured": True}),
    ("fastfood", "int8", {"num_features": 200, "structured": True}),
]


def _one_file(cell, tmp_path, k=6):
    """(repro artifact, the port's load of its file, port model, rows)."""
    name, dtype, opts = cell
    family = "fourier" if name == "fastfood" else name
    arrays = _arrays(15, d=10, n_sv=50, k=k)
    j_art = j_get_family(family).compile(_jsvm(*arrays), dtype=dtype, seed=2, **opts)
    t_art = CompiledArtifact.load(j_art.save(str(tmp_path / "a.npz")), device="cpu")
    rng = np.random.default_rng(6)
    Z = (rng.standard_normal((30, 10)) * 0.4).astype(np.float32)
    Z[::5] *= 30.0  # outside the Eq 3.11 envelope
    return j_art, t_art, convert.svm_from_numpy(*arrays, device="cpu"), Z


@pytest.mark.parametrize("cell", CELLS, ids=[f"{c[0]}-{c[1]}" for c in CELLS])
def test_pad_heads_matches_repro(cell, tmp_path):
    j_art, t_art, _, _ = _one_file(cell, tmp_path)
    family = "fourier" if cell[0] == "fastfood" else cell[0]
    j_pad = j_get_family(family).pad_heads(j_art, SHARDS)
    t_pad = get_family(family).pad_heads(t_art, SHARDS)
    assert t_pad.meta == j_pad.meta
    assert set(t_pad.arrays) == set(j_pad.arrays)
    for name, ref in j_pad.arrays.items():
        got, ref = t_pad.arrays[name].numpy(), np.asarray(ref)
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes(), name
    assert t_pad.digest() == j_pad.digest()


@pytest.mark.parametrize("cell", CELLS, ids=[f"{c[0]}-{c[1]}" for c in CELLS])
def test_score_sharded_matches_repro(cell, tmp_path):
    """The port's ``score_sharded`` on a 4-way CPU mesh against the
    reference's ``score`` and its ``score_sharded`` on its one-device mesh."""
    j_art, t_art, _, Z = _one_file(cell, tmp_path)
    family = "fourier" if cell[0] == "fastfood" else cell[0]
    jf, tf = j_get_family(family), get_family(family)
    j_mesh = JMesh(np.array(jax.local_devices()[:1]), ("heads",))
    j_s, j_v = map(np.asarray, jf.score(j_art, jnp.asarray(Z)))
    j_ss, j_sv = map(np.asarray, jf.score_sharded(j_art, jnp.asarray(Z), mesh=j_mesh))
    t_pad = tf.pad_heads(t_art, SHARDS)
    t_s, t_v = tf.score_sharded(t_pad, torch.from_numpy(Z), mesh=_head_mesh())
    assert tuple(t_s.shape) == (30, 8)
    for s, v in ((j_s, j_v), (j_ss, j_sv)):
        np.testing.assert_allclose(t_s[:, :6].numpy(), s, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(t_v.numpy(), v)
    np.testing.assert_array_equal(t_s.argmax(1).numpy(), j_s.argmax(1))


def test_sv_sharded_submit_exact_matches_repro():
    arrays = _arrays(16, d=10, n_sv=50, k=4)
    jm, tm = _jsvm(*arrays), convert.svm_from_numpy(*arrays, device="cpu")
    j_mesh = JMesh(np.array(jax.local_devices()[:1]), ("sv",))
    j_art = j_get_family("maclaurin").compile(jm)
    t_art = maclaurin.compile(tm)
    Z = _rows(np.random.default_rng(7), 21, d=10)
    opts = dict(min_bucket=8, max_batch=64)
    want = JEngine(j_art, jm, mesh=j_mesh, **opts).submit_exact(Z)
    plain = JEngine(j_art, jm, **opts).submit_exact(Z)
    got = SVMEngine(t_art, tm, mesh=_head_mesh(), device="cpu", **opts).submit_exact(Z)
    for ref in (want, plain):
        np.testing.assert_allclose(got.values, np.asarray(ref.values), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.labels, np.asarray(ref.labels))
        np.testing.assert_array_equal(got.valid, np.asarray(ref.valid))


def test_rbf_tile_seconds_and_prune_candidates_match_repro(monkeypatch):
    """The port's prior is the reference's formula at the H100's constants."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    configs = [(None, None)] + [
        (TileConfig(block_n=b), JTileConfig(block_n=b)) for b in (32, 128, 4096)
    ]
    for cfg, jcfg in configs:
        for n, d, m in ((1, 780, 16384), (1024, 780, 16384), (256, 32, 64)):
            got = roofline.rbf_tile_seconds(cfg, n=n, d=d, m=m)
            want = jroofline.rbf_tile_seconds(jcfg, n=n, d=d, m=m)
            assert got == pytest.approx(want, rel=1e-12)
    sizes = (32, 64, 128, 256, 512)
    t_cands = [TileConfig(block_n=b) for b in sizes]
    j_cands = [JTileConfig(block_n=b) for b in sizes]
    for keep in (1, 2, 4):
        for default in (0, 2, 4):
            for sign in (1.0, -1.0):

                def t_prior(c):
                    return sign * roofline.quadform_tile_seconds(c, n=512, d=32, k=4)

                def j_prior(c):
                    return sign * jroofline.quadform_tile_seconds(c, n=512, d=32, k=4)

                got = autotune.prune_candidates(t_cands, t_cands[default], t_prior, keep)
                want = jautotune.prune_candidates(
                    j_cands, j_cands[default], j_prior, keep
                )
                assert [c.block_n for c in got] == [c.block_n for c in want]


def test_replicated_runtime_answers_match_repro():
    """Three replicas in either package serve the same requests to the same
    answers (the same model, compiled by each)."""
    from repro.serve import PublishSpec as JPublishSpec
    from repro.serve import Runtime as JRuntime

    arrays = _arrays(17, d=8, n_sv=40, k=5)
    jm, tm = _jsvm(*arrays), convert.svm_from_numpy(*arrays, device="cpu")
    rng = np.random.default_rng(8)
    batches = [_rows(rng, int(n)) for n in rng.integers(1, 9, size=9)]
    opts = dict(min_bucket=8, max_batch=64)
    with JRuntime(engine_opts=opts, max_wait_us=500.0) as jrt:
        jrt.publish("m", j_get_family("maclaurin").compile(jm), JPublishSpec(replicas=3))
        want = [jrt.submit("m", Z).result(timeout=TIMEOUT) for Z in batches]
        want = [(np.asarray(r.values), np.asarray(r.labels)) for r in want]
    with Runtime(engine_opts=ENGINE_OPTS, max_wait_us=500.0) as rt:
        rt.publish("m", maclaurin.compile(tm), PublishSpec(replicas=3))
        got = [rt.submit("m", Z).result(timeout=TIMEOUT) for Z in batches]
        per = rt.stats("m")["replicas"]
        assert all(per[i]["flushes"] >= 1 for i in per)
    for r, (v, lab) in zip(got, want):
        np.testing.assert_allclose(r.values, v, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(r.labels, lab)
