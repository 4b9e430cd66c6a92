"""The port's robustness layer on the CPU: admission control (bounded
queues, typed shed, deadlines, wait tightening), fault isolation (failure
scatter, the circuit breaker degrading to the exact path, half-open
recovery), corruption quarantine, shutdown and eviction accounting, the
fault-injection harness, and the DriftGuard recompile -> canary -> flip
loop; the cases of ``tests/test_robustness.py``, with ``device="cpu"``.
Then the parity of the two packages on the same seeds: fault schedules,
breaker transitions, degraded rows, corrupted bytes, error codes, the
reservoir's rows and a heal on the same drifted traffic."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.families import Budget as JBudget  # noqa: E402
from repro.core.families import compile_model as jcompile_model  # noqa: E402
from repro.core.families import maclaurin as jmac  # noqa: E402
from repro.core.rbf import SVMModel as JSVM  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.serve import PublishSpec as JPublishSpec  # noqa: E402
from repro.serve import Runtime as JRuntime  # noqa: E402
from repro.serve import runtime as jruntime  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.families import Budget, compile_model, maclaurin  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.serve import PublishSpec, Runtime, SVMEngine  # noqa: E402
from repro_torch.serve import runtime as truntime  # noqa: E402
from repro_torch.serve.runtime import (  # noqa: E402
    ENGINE_STEP,
    REGISTRY_LOAD,
    ArtifactCorrupt,
    ArtifactRegistry,
    BatcherClosed,
    CircuitBreaker,
    DeadlineExceeded,
    DriftGuard,
    FaultInjector,
    InjectedFault,
    ReservoirSampler,
    RuntimeOverloaded,
)

ENGINE_OPTS = dict(device="cpu", min_bucket=8, max_batch=64)
J_ENGINE_OPTS = dict(min_bucket=8, max_batch=64)


def _arrays(seed=0, d=8, n_sv=40, bias=0.1, scale=0.6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_sv, d)).astype(np.float32) * scale
    gamma = np.float32(0.8 / (4.0 * float((X.astype(np.float64) ** 2).sum(1).max())))
    ay = rng.standard_normal(n_sv).astype(np.float32) * 0.5
    return X, ay, np.float32(bias), gamma


def _svm(seed=0, d=8, n_sv=40, bias=0.1, scale=0.6):
    return convert.svm_from_numpy(*_arrays(seed, d, n_sv, bias, scale), device="cpu")


def _jsvm(seed=0, d=8, n_sv=40, bias=0.1, scale=0.6):
    X, ay, b, g = _arrays(seed, d, n_sv, bias, scale)
    return JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.float32(b),
        gamma=jnp.float32(g),
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


# ---------------------------------------------------------- circuit breaker


def test_breaker_state_machine():
    t = [0.0]
    br = CircuitBreaker(fail_threshold=3, reset_after_s=1.0, clock=lambda: t[0])
    assert br.state == "closed" and br.allow_fast()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"  # below the threshold
    br.record_failure()
    assert br.state == "open" and not br.allow_fast()
    assert 0.0 < br.retry_after() <= 1.0
    t[0] = 0.5
    assert not br.allow_fast()  # inside the reset window
    t[0] = 1.5
    assert br.allow_fast()  # this call is the probe
    assert br.state == "half_open"
    br.record_failure()  # the probe fails: open again
    assert br.state == "open"
    t[0] = 3.0
    assert br.allow_fast() and br.state == "half_open"
    br.record_success()  # the probe passes: closed
    assert br.state == "closed" and br.consecutive_failures == 0
    assert br.retry_after() == 0.0


def test_breaker_success_resets_failure_streak():
    br = CircuitBreaker(fail_threshold=2)
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == "closed"  # not two in a row


# ------------------------------------------------------------ fault harness


def _verdicts(make, seed, n=64):
    fi = make(
        seed,
        engine_fault_rate=0.3,
        slow_step_rate=0.2,
        slow_step_s=0.0,
        sleep=lambda s: None,
    )
    out = []
    for _ in range(n):
        try:
            fi.check(ENGINE_STEP)
            out.append("ok")
        except Exception as e:
            assert e.code == "injected_fault"
            out.append("fault")
    return out, fi.snapshot()


def test_fault_injector_is_deterministic():
    a, b = _verdicts(FaultInjector, 7)[0], _verdicts(FaultInjector, 7)[0]
    assert a == b  # same seed, same run
    assert a != _verdicts(FaultInjector, 8)[0]
    assert "fault" in a and "ok" in a


def test_fault_injector_scripts_override_rates():
    fi = FaultInjector(0, engine_fault_rate=1.0)  # every check would fault
    fi.pass_next(ENGINE_STEP, 2)
    fi.check(ENGINE_STEP)  # scripted passes win
    fi.check(ENGINE_STEP)
    with pytest.raises(InjectedFault) as ei:
        fi.check(ENGINE_STEP)  # back on the seeded rate
    assert ei.value.site == ENGINE_STEP and ei.value.ordinal == 3
    snap = fi.snapshot()[ENGINE_STEP]
    assert snap["checks"] == 3 and snap["faults"] == 1


def test_corrupt_bytes_deterministic_and_corrupting():
    data = bytes(range(256)) * 8
    c1 = FaultInjector.corrupt_bytes(data, seed=5)
    c2 = FaultInjector.corrupt_bytes(data, seed=5)
    assert c1 == c2 and c1 != data and len(c1) == len(data)
    assert FaultInjector.corrupt_bytes(data, seed=6) != c1


# -------------------------------------------------------- admission control


def test_bounded_queue_sheds_with_retry_after():
    m = _svm(1)
    fi = FaultInjector(0, slow_step_rate=1.0, slow_step_s=0.02)
    with Runtime(
        engine_opts=ENGINE_OPTS, fault_injector=fi, max_queue_rows=16, max_wait_us=100.0
    ) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        rt.predict("m", _rows(np.random.default_rng(0), 2))  # warm
        rng = np.random.default_rng(1)
        futs, shed = [], 0
        for _ in range(80):
            try:
                futs.append(rt.submit("m", _rows(rng, 4)))
            except RuntimeOverloaded as e:
                shed += 1
                assert e.retry_after_s > 0.0  # the server names its backoff
        for f in futs:
            f.result(timeout=30.0)  # every admitted request serves
        st = rt.stats("m")
        assert shed > 0
        assert st["shed_requests"] == shed
        assert st["requests"] == len(futs) + 1  # shed never enqueued (+ warm)
        assert st["queue_rows"] == 0  # accounting drains to zero


def test_empty_queue_always_admits_oversized_request():
    m = _svm(2)
    with Runtime(engine_opts=ENGINE_OPTS, max_queue_rows=8) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        vals, _ = rt.predict("m", _rows(np.random.default_rng(0), 32))
        assert vals.shape == (32,)


def test_deadline_exceeded_fails_future_not_batcher():
    m = _svm(3)
    with Runtime(engine_opts=ENGINE_OPTS, max_wait_us=50_000.0) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        rng = np.random.default_rng(0)
        fut = rt.submit("m", _rows(rng, 1), deadline_s=0.005)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=10.0)
        st = rt.stats("m")
        assert st["deadline_timeouts"] == 1
        assert st["queue_rows"] == 0  # expired rows left the gauge
        vals, _ = rt.predict("m", _rows(rng, 3))  # the batcher survived
        assert vals.shape == (3,)


def test_queue_pressure_tightens_wait():
    m = _svm(4)
    bounded = dict(max_queue_rows=16, max_wait_us=10_000.0)
    with Runtime(engine_opts=ENGINE_OPTS, **bounded) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        rng = np.random.default_rng(0)
        rt.submit("m", _rows(rng, 3)).result(timeout=10.0)  # ~19% pressure
        st = rt.stats("m")
        assert st["deadline_flushes"] >= 1
        assert st["tightened_waits"] >= 1
        with Runtime(engine_opts=ENGINE_OPTS, max_wait_us=10_000.0) as rt2:
            rt2.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
            rt2.submit("m", _rows(rng, 3)).result(timeout=10.0)
            assert rt2.stats("m")["tightened_waits"] == 0  # unbounded: no pressure


# ----------------------------------------------------------- fault isolation


def test_engine_fault_fails_only_its_batch():
    m = _svm(5)
    fi = FaultInjector(0)
    with Runtime(
        engine_opts=ENGINE_OPTS, fault_injector=fi, breaker=dict(fail_threshold=5)
    ) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))  # warm
        fi.fail_next(ENGINE_STEP, 1)
        doomed = rt.submit("m", _rows(rng, 3))
        with pytest.raises(InjectedFault):
            doomed.result(timeout=10.0)
        Z = _rows(rng, 4)
        vals, _ = rt.predict("m", Z)  # the worker survived
        np.testing.assert_allclose(vals, _exact_scores(m, Z)[:, 0], atol=0.15)
        st = rt.stats("m")
        assert st["batch_failures"] == 1
        assert st["failed_requests"] == 1 and st["failed_rows"] == 3
        assert st["breaker"]["state"] == "closed"  # one failure < threshold


def test_fault_on_one_model_leaves_others_serving():
    m1, m2 = _svm(6), _svm(7)
    fi = FaultInjector(0)
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        breaker=dict(fail_threshold=1, reset_after_s=60.0),
    ) as rt:
        rt.publish("a", maclaurin.compile(m1), PublishSpec(exact=m1))
        rt.publish("b", maclaurin.compile(m2), PublishSpec(exact=m2))
        rng = np.random.default_rng(0)
        rt.predict("a", _rows(rng, 2))
        rt.predict("b", _rows(rng, 2))
        fi.fail_next(ENGINE_STEP, 1)
        with pytest.raises(InjectedFault):
            rt.submit("a", _rows(rng, 2)).result(timeout=10.0)
        ra = rt.submit("a", _rows(rng, 3)).result(timeout=10.0)
        assert not np.asarray(ra.valid).any()  # exact-served rows
        rb = rt.submit("b", _rows(rng, 3)).result(timeout=10.0)
        assert rb.values.shape == (3,)
        assert rt.stats("a")["breaker"]["state"] == "open"
        assert rt.stats("b")["breaker"]["state"] == "closed"
        assert rt.stats("b")["batch_failures"] == 0


def test_breaker_degrades_to_exact_and_recovers():
    """The open breaker serves through ``submit_exact`` (the engine has an
    exact model, ``exact_available``): exact scores, ``valid`` all False."""
    m = _svm(8)
    fi = FaultInjector(0)
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        breaker=dict(fail_threshold=2, reset_after_s=0.1),
    ) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))
        assert rt.registry.get_engine("m")[1].exact_available
        fi.fail_next(ENGINE_STEP, 2)
        for _ in range(2):
            with pytest.raises(InjectedFault):
                rt.submit("m", _rows(rng, 2)).result(timeout=10.0)
        st = rt.stats("m")
        assert st["breaker"]["state"] == "open" and st["breaker"]["trips"] == 1
        Z = _rows(rng, 5)
        res = rt.submit("m", Z).result(timeout=10.0)
        np.testing.assert_allclose(
            np.asarray(res.values), _exact_scores(m, Z)[:, 0], rtol=1e-4, atol=1e-5
        )
        assert not np.asarray(res.valid).any()
        st = rt.stats("m")
        assert st["breaker"]["degraded_requests"] == 1
        assert st["breaker"]["degraded_rows"] == 5
        assert st["breaker"]["shed_requests"] == 0
        assert st["engine"]["degraded_instances"] == 5
        win = st["fallback_window"]  # degraded traffic is not drift
        assert win["rows"] == 0 or win["invalid"] < win["rows"]
        time.sleep(0.15)  # past reset_after_s
        rt.submit("m", _rows(rng, 3)).result(timeout=10.0)  # the probe
        st = rt.stats("m")
        assert st["breaker"]["state"] == "closed"
        assert st["breaker"]["probes"] >= 1


def test_open_breaker_without_exact_sheds_typed():
    m = _svm(9)
    fi = FaultInjector(0)
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        breaker=dict(fail_threshold=1, reset_after_s=60.0),
    ) as rt:
        rt.publish("m", maclaurin.compile(m))  # no exact model
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))
        assert not rt.registry.get_engine("m")[1].exact_available
        fi.fail_next(ENGINE_STEP, 1)
        with pytest.raises(InjectedFault):
            rt.submit("m", _rows(rng, 2)).result(timeout=10.0)
        fut = rt.submit("m", _rows(rng, 2))
        with pytest.raises(RuntimeOverloaded) as ei:
            fut.result(timeout=10.0)
        assert ei.value.retry_after_s > 0.0
        assert rt.stats("m")["breaker"]["shed_requests"] == 1


# ------------------------------------------------------- registry hardening


def test_add_file_rejects_corrupt_and_truncated(tmp_path):
    art = maclaurin.compile(_svm(10))
    good = str(tmp_path / "good.npz")
    art.save(good)
    ArtifactRegistry(engine_opts=ENGINE_OPTS).add_file(good)  # a clean file indexes

    flipped = str(tmp_path / "flipped.npz")
    art.save(flipped)
    FaultInjector.corrupt_file(flipped, seed=1)
    with pytest.raises(ArtifactCorrupt):
        ArtifactRegistry(engine_opts=ENGINE_OPTS).add_file(flipped)

    trunc = str(tmp_path / "trunc.npz")
    art.save(trunc)
    FaultInjector.truncate_file(trunc, keep_fraction=0.4)
    with pytest.raises(ArtifactCorrupt):
        ArtifactRegistry(engine_opts=ENGINE_OPTS).add_file(trunc)


def test_mutated_file_never_serves_under_old_digest(tmp_path):
    art = maclaurin.compile(_svm(11))
    path = str(tmp_path / "m.npz")
    art.save(path)
    reg = ArtifactRegistry(warmup_on_load=False, engine_opts=ENGINE_OPTS)
    digest = reg.add_file(path, alias="m@latest")
    maclaurin.compile(_svm(12)).save(path)  # a valid npz, other content
    with pytest.raises(ArtifactCorrupt) as ei:
        reg.get_engine("m")
    assert ei.value.digest == digest
    with pytest.raises(ArtifactCorrupt) as ei2:  # quarantined: fail fast
        reg.get_engine("m")
    assert "quarantined" in str(ei2.value)
    assert reg.snapshot()["quarantined"] == 1


def test_reload_after_evict_reverifies_sha(tmp_path):
    art = maclaurin.compile(_svm(13))
    path = str(tmp_path / "m.npz")
    art.save(path)
    reg = ArtifactRegistry(
        warmup_on_load=False, engine_opts=ENGINE_OPTS, memory_budget_bytes=1
    )
    reg.add_file(path, alias="m@latest")
    reg.register(maclaurin.compile(_svm(14)), PublishSpec(alias="other@latest"))
    reg.get_engine("m@latest")  # load 1 verifies and serves
    reg.get_engine("other@latest")  # budget 1 evicts "m"
    assert reg.eviction_count >= 1
    FaultInjector.corrupt_file(path, seed=2)  # mutated while evicted
    with pytest.raises(ArtifactCorrupt):
        reg.get_engine("m@latest")  # the reload re-hashes and refuses


def test_injected_load_fault_is_transient_not_quarantined(tmp_path):
    art = maclaurin.compile(_svm(15))
    path = str(tmp_path / "m.npz")
    art.save(path)
    fi = FaultInjector(0)
    reg = ArtifactRegistry(
        warmup_on_load=False, engine_opts=ENGINE_OPTS, fault_injector=fi
    )
    reg.add_file(path, alias="m@latest")
    fi.fail_next(REGISTRY_LOAD, 1)
    with pytest.raises(InjectedFault):
        reg.get_engine("m")
    _, engine = reg.get_engine("m")  # the next resolve retries
    assert engine is not None
    assert reg.snapshot()["quarantined"] == 0


# ------------------------------------------------------ shutdown / eviction


def test_close_resolves_every_pending_future_and_joins_threads():
    m = _svm(16)
    fi = FaultInjector(0, slow_step_rate=1.0, slow_step_s=0.02)
    rt = Runtime(engine_opts=ENGINE_OPTS, fault_injector=fi, max_wait_us=50_000.0)
    try:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        rng = np.random.default_rng(0)
        rt.predict("m", _rows(rng, 2))
        batcher = rt._batchers[rt.registry.resolve("m")]
        futs = [rt.submit("m", _rows(rng, 2)) for _ in range(6)]
    finally:
        t0 = time.perf_counter()
        rt.close()
    assert time.perf_counter() - t0 < 10.0
    resolved = 0
    for f in futs:
        assert f.done()  # nothing left pending
        try:
            f.result(timeout=0)
            resolved += 1
        except (BatcherClosed, InjectedFault):
            resolved += 1
    assert resolved == len(futs)
    batcher._worker.join(timeout=5.0)
    assert not batcher._worker.is_alive()
    with pytest.raises(BatcherClosed):
        batcher.submit(_rows(rng, 1))


def test_eviction_mid_traffic_resolves_pending_futures():
    m1, m2 = _svm(17), _svm(18)
    rt = Runtime(
        engine_opts=ENGINE_OPTS,
        memory_budget_bytes=1,
        warmup_on_load=False,
        max_wait_us=20_000.0,
    )
    try:
        rt.publish("a", maclaurin.compile(m1), PublishSpec(exact=m1))
        rt.publish("b", maclaurin.compile(m2), PublishSpec(exact=m2))
        rng = np.random.default_rng(0)
        futs = [rt.submit("a", _rows(rng, 2)) for _ in range(4)]
        rt.predict("b", _rows(rng, 2))  # evicts "a"
        for f in futs:  # the eviction's close drained them
            assert f.result(timeout=10.0).values.shape == (2,)
    finally:
        rt.close()


# --------------------------------------------------------------- chaos suite


def _chaos_run(
    seed,
    *,
    threads=8,
    per_thread=25,
    fi_kwargs=None,
    runtime_kwargs=None,
    deadline_every=0,
):
    """Seeded multi-threaded storm; returns exact outcome accounting."""
    m = _svm(seed)
    fi = FaultInjector(seed, **(fi_kwargs or {}))
    counts = {"served": 0, "shed": 0, "failed": 0, "expired": 0}
    lock = threading.Lock()
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        breaker=dict(fail_threshold=3, reset_after_s=0.05),
        **(runtime_kwargs or {}),
    ) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        try:
            rt.predict("m", _rows(np.random.default_rng(seed), 2))
        except InjectedFault:
            pass  # the warm-up is best effort under a fault rate

        def client(tid):
            rng = np.random.default_rng((seed, tid))
            got = {"served": 0, "shed": 0, "failed": 0, "expired": 0}
            for i in range(per_thread):
                dl = 0.002 if deadline_every and i % deadline_every == 0 else None
                try:
                    fut = rt.submit(
                        "m", _rows(rng, int(rng.integers(1, 5))), deadline_s=dl
                    )
                except RuntimeOverloaded:
                    got["shed"] += 1
                    continue
                try:
                    fut.result(timeout=30.0)
                    got["served"] += 1
                except DeadlineExceeded:
                    got["expired"] += 1
                except (InjectedFault, RuntimeOverloaded):
                    got["failed"] += 1
            with lock:
                for k in got:
                    counts[k] += got[k]

        ts = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
            assert not t.is_alive(), "a client hung: a future never resolved"
        stats = rt.stats("m")
    return counts, stats, threads * per_thread


@pytest.mark.stress
def test_chaos_engine_faults_exact_accounting():
    counts, stats, submitted = _chaos_run(
        21,
        fi_kwargs=dict(engine_fault_rate=0.15),
        runtime_kwargs=dict(max_queue_rows=64),
    )
    assert sum(counts.values()) == submitted  # every request accounted
    assert counts["served"] > 0
    assert stats["queue_rows"] == 0
    assert stats["shed_requests"] == counts["shed"]


@pytest.mark.stress
def test_chaos_slow_steps_with_deadlines_and_shedding():
    counts, stats, submitted = _chaos_run(
        22,
        fi_kwargs=dict(engine_fault_rate=0.05, slow_step_rate=0.5, slow_step_s=0.01),
        runtime_kwargs=dict(max_queue_rows=48, max_wait_us=2_000.0),
        deadline_every=5,
    )
    assert sum(counts.values()) == submitted
    assert counts["served"] > 0
    assert stats["queue_rows"] == 0
    assert stats["deadline_timeouts"] == counts["expired"]


@pytest.mark.stress
def test_chaos_corrupt_file_under_load(tmp_path):
    m1, m2 = _svm(23), _svm(24)
    p1 = str(tmp_path / "a.npz")
    maclaurin.compile(m1).save(p1)
    rt = Runtime(engine_opts=ENGINE_OPTS, warmup_on_load=False, memory_budget_bytes=1)
    try:
        rt.registry.add_file(p1, alias="a@latest", exact=m1)
        rt.publish("b", maclaurin.compile(m2), PublishSpec(exact=m2))
        rt.predict("a", _rows(np.random.default_rng(0), 2))
        FaultInjector.corrupt_file(p1, seed=3)  # mutated behind the registry
        outcomes = {"served": 0, "corrupt": 0}
        lock = threading.Lock()

        def client(tid):
            rng = np.random.default_rng((23, tid))
            got = {"served": 0, "corrupt": 0}
            for i in range(20):
                model = "a" if (tid + i) % 2 == 0 else "b"
                try:
                    rt.submit(model, _rows(rng, 2)).result(timeout=30.0)
                    got["served"] += 1
                except ArtifactCorrupt:
                    assert model == "a"  # only the mutated model
                    got["corrupt"] += 1
            with lock:
                for k in got:
                    outcomes[k] += got[k]

        ts = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
            assert not t.is_alive()
        assert outcomes["served"] + outcomes["corrupt"] == 8 * 20
        assert outcomes["served"] > 0  # "b" never stopped
    finally:
        rt.close()


# ------------------------------------------ interleaving conservation law


def _conservation_world(max_queue_rows, fault_rate, schedule, seed):
    """Replay one submit schedule; shed + served + failed + expired ==
    submitted, and no future is left unresolved."""
    m = _svm(seed % 7)
    fi = FaultInjector(
        seed, engine_fault_rate=fault_rate, slow_step_rate=0.3, slow_step_s=0.003
    )
    submitted = served = shed = failed = expired = 0
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        max_queue_rows=max_queue_rows,
        max_wait_us=1_000.0,
        breaker=dict(fail_threshold=2, reset_after_s=0.02),
    ) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        rng = np.random.default_rng(seed)
        futs = []
        for step in schedule:
            submitted += 1
            dl = 0.002 if step % 3 == 0 else None
            try:
                futs.append(rt.submit("m", _rows(rng, (step % 4) + 1), deadline_s=dl))
            except RuntimeOverloaded:
                shed += 1
            if step % 5 == 0:
                time.sleep(0.002)  # vary the interleaving
        for f in futs:
            try:
                f.result(timeout=30.0)
                served += 1
            except DeadlineExceeded:
                expired += 1
            except (InjectedFault, RuntimeOverloaded, BatcherClosed):
                failed += 1
    assert shed + served + failed + expired == submitted
    assert all(f.done() for f in futs)


@pytest.mark.stress
@pytest.mark.parametrize("seed", [31, 32, 33, 34])
def test_conservation_seeded_interleavings(seed):
    rng = np.random.default_rng(seed)
    schedule = [int(s) for s in rng.integers(0, 16, size=40)]
    _conservation_world(
        max_queue_rows=int(rng.integers(8, 48)),
        fault_rate=float(rng.uniform(0, 0.3)),
        schedule=schedule,
        seed=seed,
    )


@pytest.mark.stress
def test_conservation_property_hypothesis():
    """Property form of the conservation law (runs where hypothesis is
    installed; the seeded cases above always run)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(
        schedule=st.lists(st.integers(0, 15), min_size=1, max_size=30),
        max_queue_rows=st.integers(8, 48),
        fault_rate=st.floats(0, 0.3),
        seed=st.integers(0, 2**16),
    )
    @hyp.settings(max_examples=15, deadline=None)
    def prop(schedule, max_queue_rows, fault_rate, seed):
        _conservation_world(max_queue_rows, fault_rate, schedule, seed)

    prop()


# -------------------------------------------------------------- drift guard


def test_reservoir_sampler_seeded_and_bounded():
    r1 = ReservoirSampler(capacity=16, seed=3)
    r2 = ReservoirSampler(capacity=16, seed=3)
    stream = np.random.default_rng(0).standard_normal((200, 4)).astype(np.float32)
    for i in range(0, 200, 7):
        r1.offer(stream[i : i + 7])
        r2.offer(stream[i : i + 7])
    assert len(r1) == 16 and r1.seen == 200
    np.testing.assert_array_equal(r1.sample(), r2.sample())  # seeded replay
    assert all(any(np.array_equal(row, x) for x in stream) for row in r1.sample())


def test_drift_guard_green_window_is_cheap_noop():
    m = _svm(26, scale=0.4)
    art = compile_model(
        m, Budget(max_err=0.05), sample=_rows(np.random.default_rng(0), 128, scale=0.3)
    )
    with Runtime(engine_opts=ENGINE_OPTS) as rt:
        rt.publish("clf", art, PublishSpec(exact=m))
        guard = DriftGuard(
            rt,
            "clf",
            exact=m,
            budget=Budget(max_err=0.05),
            threshold=0.5,
            min_rows=32,
            seed=5,
        ).attach()
        rng = np.random.default_rng(1)
        for _ in range(6):
            rt.submit("clf", _rows(rng, 8, scale=0.3)).result(timeout=30).values
        assert not guard.check()["healed"]
        assert rt.stats("clf")["canary"]["recompiles"] == 0


def test_drift_guard_end_to_end_heal():
    """In-distribution traffic fast-paths; drifted traffic pushes the
    windowed fallback rate over the threshold; the guard recompiles on the
    reservoir, canaries against the exact judge and flips the alias with
    no request dropped; the drifted traffic then fast-paths."""
    m = _svm(27, scale=0.35)
    rng = np.random.default_rng(2)
    sample = _rows(rng, 256, scale=0.25)
    art = compile_model(m, Budget(max_err=0.05), sample=sample, families=("maclaurin",))
    with Runtime(engine_opts=ENGINE_OPTS) as rt:
        rt.publish("clf", art, PublishSpec(exact=m))
        guard = DriftGuard(
            rt,
            "clf",
            exact=m,
            budget=Budget(max_err=0.08),
            threshold=0.3,
            min_rows=48,
            min_agreement=0.9,
            capacity=192,
            seed=9,
        ).attach()
        for _ in range(8):  # in distribution: the fast path, a green window
            r = rt.submit("clf", _rows(rng, 8, scale=0.25)).result(timeout=30)
            assert np.asarray(r.valid).all()
        assert guard.fallback_rate()["rate"] < 0.05
        assert not guard.check()["triggered"]
        old_digest = rt.registry.resolve("clf")

        in_flight = [rt.submit("clf", _rows(rng, 8, scale=1.5)) for _ in range(12)]
        for f in in_flight:  # reading the values feeds the validity window
            assert f.result(timeout=30.0).values.shape == (8,)
        window = guard.fallback_rate()
        assert window["rate"] > 0.3 and window["rows"] >= 48

        concurrent = [rt.submit("clf", _rows(rng, 4, scale=1.5)) for _ in range(4)]
        verdict = guard.check()
        assert verdict["triggered"] and verdict["healed"], verdict
        assert verdict["agreement"] >= 0.9
        for f in concurrent:  # nothing in flight dropped by the flip
            assert f.result(timeout=30.0).values.shape == (4,)

        new_digest = rt.registry.resolve("clf")
        assert new_digest == verdict["new_digest"] != old_digest
        old_stats = rt.stats(old_digest)
        assert old_stats["canary"]["recompiles"] == 1
        assert old_stats["canary"]["passed"] == 1

        for _ in range(10):  # the same drifted traffic now fast-paths
            rt.submit("clf", _rows(rng, 8, scale=1.5)).result(timeout=30).values
        assert guard.fallback_rate()["rate"] < 0.3


def test_drift_guard_rejects_bad_canary():
    m = _svm(28, scale=0.35)
    rng = np.random.default_rng(3)
    sample = _rows(rng, 128, scale=0.25)
    art = compile_model(m, Budget(max_err=0.05), sample=sample, families=("maclaurin",))
    with Runtime(engine_opts=ENGINE_OPTS) as rt:
        rt.publish("clf", art, PublishSpec(exact=m))
        guard = DriftGuard(  # min_agreement 1.01 is unreachable
            rt,
            "clf",
            exact=m,
            budget=Budget(max_err=0.08),
            threshold=0.2,
            min_rows=32,
            min_agreement=1.01,
            capacity=128,
            seed=11,
        ).attach()
        old_digest = rt.registry.resolve("clf")
        for _ in range(10):
            rt.submit("clf", _rows(rng, 8, scale=1.5)).result(timeout=30).values
        verdict = guard.check()
        assert verdict["triggered"] and not verdict["healed"]
        assert rt.registry.resolve("clf") == old_digest  # the alias stays
        st = rt.stats("clf")
        assert st["canary"]["failed"] >= 1 or "reason" in verdict


def test_drift_guard_cooldown_limits_heal_rate():
    m = _svm(29, scale=0.35)
    rng = np.random.default_rng(4)
    sample = _rows(rng, 128, scale=0.25)
    art = compile_model(m, Budget(max_err=0.05), sample=sample, families=("maclaurin",))
    with Runtime(engine_opts=ENGINE_OPTS) as rt:
        rt.publish("clf", art, PublishSpec(exact=m))
        guard = DriftGuard(
            rt,
            "clf",
            exact=m,
            budget=Budget(max_err=0.08),
            threshold=0.2,
            min_rows=32,
            min_agreement=1.01,
            capacity=128,
            seed=13,
            cooldown_s=300.0,
        ).attach()
        for _ in range(10):
            rt.submit("clf", _rows(rng, 8, scale=1.5)).result(timeout=30).values
        v1 = guard.check()  # attempts (and fails its canary)
        v2 = guard.check()  # inside the cooldown: no attempt
        assert v1["triggered"] and v2["triggered"]
        assert v2.get("reason") == "cooldown"
        assert rt.stats("clf")["canary"]["recompiles"] == 1


# ------------------------------------------------- parity with repro's runtime


def test_parity_fault_schedule_and_corrupted_bytes(tmp_path):
    """(c) One seed and script: the same verdicts and counters, and the
    same corrupted and truncated file bytes."""
    for seed in (0, 7, 123):
        assert _verdicts(FaultInjector, seed) == _verdicts(jruntime.FaultInjector, seed)
    scripted = []
    pairs = ((FaultInjector, InjectedFault), (jruntime.FaultInjector, Exception))
    for make, fault in pairs:
        fi = make(3, engine_fault_rate=0.5)
        fi.fail_next(ENGINE_STEP, 2)
        fi.pass_next(ENGINE_STEP, 1)
        fi.fail_next(fi.replica_site(ENGINE_STEP, 1), 1)
        out = []
        for i in range(12):
            try:
                fi.check_replica(ENGINE_STEP, i % 2)
                out.append("ok")
            except fault as e:
                out.append((e.site, e.ordinal))
        scripted.append((out, fi.snapshot()))
    assert scripted[0] == scripted[1]
    data = maclaurin.compile(_svm(10)).to_bytes()
    ours = FaultInjector.corrupt_bytes(data, seed=4)
    assert ours == jruntime.FaultInjector.corrupt_bytes(data, seed=4)
    paths = []
    for make in (FaultInjector, jruntime.FaultInjector):
        p = tmp_path / f"{make.__module__}.npz"
        p.write_bytes(data)
        make.corrupt_file(str(p), seed=9)
        make.truncate_file(str(p), keep_fraction=0.7)
        paths.append(p.read_bytes())
    assert paths[0] == paths[1] != data[: len(paths[0])]


def _breaker_trace(rt, fi, model, rng, now):
    """Drive ``rt`` through a scripted fault sequence; return per-request
    verdicts and the breaker state after each."""
    out = []
    fi.fail_next(ENGINE_STEP, 3)
    for step in range(8):
        if step == 6:
            now[0] = 10.0  # past reset_after_s: the next flush is the probe
        try:
            r = rt.submit(model, _rows(rng, 3)).result(timeout=30)
            verdict = "degraded" if not np.asarray(r.valid).any() else "fast"
        except Exception as e:
            verdict = e.code
        out.append((verdict, rt.stats(model)["breaker"]["state"]))
    return out


def test_parity_breaker_transitions_and_degraded_rows():
    """(c) The same scripted faults open, degrade and close the breaker
    at the same requests in both packages, with the same degraded rows."""
    traces, stats = [], []
    for pkg in ("repro", "repro_torch"):
        now = [0.0]
        cfg = dict(fail_threshold=3, reset_after_s=1.0, clock=lambda: now[0])
        if pkg == "repro":
            m = _jsvm(8)
            fi = jruntime.FaultInjector(0)
            rt = JRuntime(engine_opts=J_ENGINE_OPTS, fault_injector=fi, breaker=cfg)
            spec, art = JPublishSpec(exact=m), jmac.compile(m)
        else:
            m = _svm(8)
            fi = FaultInjector(0)
            rt = Runtime(engine_opts=ENGINE_OPTS, fault_injector=fi, breaker=cfg)
            spec, art = PublishSpec(exact=m), maclaurin.compile(m)
        with rt:
            rt.publish("m", art, spec)
            rt.predict("m", _rows(np.random.default_rng(0), 2))
            traces.append(_breaker_trace(rt, fi, "m", np.random.default_rng(1), now))
            st = rt.stats("m")
        stats.append(
            (
                st["breaker"],
                st["engine"]["degraded_instances"],
                st["failed_requests"],
                st["served_requests"],
            )
        )
    assert traces[0] == traces[1]
    want = ["injected_fault"] * 3 + ["degraded"] * 3 + ["fast"] * 2
    assert [v for v, _ in traces[1]] == want
    assert stats[0] == stats[1]


def test_parity_error_codes_and_statuses():
    """(d) Every error class carries the reference's code and status."""
    names = [
        "ServingError",
        "RuntimeOverloaded",
        "DeadlineExceeded",
        "BatcherClosed",
        "ArtifactCorrupt",
        "ModelNotFound",
        "InjectedFault",
    ]
    for name in names:
        ours, theirs = getattr(truntime.errors, name), getattr(jruntime.errors, name)
        assert (ours.code, ours.http_status) == (theirs.code, theirs.http_status)
        mro = [[b.__name__ for b in cls.__mro__] for cls in (ours, theirs)]
        assert mro[0] == mro[1]
    e = (truntime.RuntimeOverloaded("a", 0.5), jruntime.RuntimeOverloaded("a", 0.5))
    assert e[0].to_wire() == e[1].to_wire()
    e = (truntime.ModelNotFound("x", ref="m"), jruntime.ModelNotFound("x", ref="m"))
    assert e[0].to_wire() == e[1].to_wire() and str(e[0]) == str(e[1])
    e = (truntime.InjectedFault("s", 3), jruntime.InjectedFault("s", 3))
    assert e[0].to_wire() == e[1].to_wire()


def test_parity_reservoir_and_heal(monkeypatch):
    """(f) One reservoir seed keeps the same rows; the same drifted
    traffic heals in both packages with canary agreement >= 0.9 (the
    family each picks may differ: ``compile_model`` times its candidates)."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    stream = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)
    ours, theirs = ReservoirSampler(32, seed=4), jruntime.ReservoirSampler(32, seed=4)
    for i in range(0, 300, 11):
        ours.offer(stream[i : i + 11])
        theirs.offer(stream[i : i + 11])
    np.testing.assert_array_equal(ours.sample(), theirs.sample())

    rng = np.random.default_rng(2)
    fit = _rows(rng, 256, scale=0.25)
    calm = [_rows(rng, 8, scale=0.25) for _ in range(8)]
    traffic = [_rows(rng, 8, scale=1.5) for _ in range(12)]
    verdicts = []
    for pkg in ("repro", "repro_torch"):
        if pkg == "repro":
            m, budget, compile_fn = _jsvm(27, scale=0.35), JBudget, jcompile_model
            rt, spec = JRuntime(engine_opts=J_ENGINE_OPTS), JPublishSpec
            guard_cls = jruntime.DriftGuard
        else:
            m, budget, compile_fn = _svm(27, scale=0.35), Budget, compile_model
            rt, spec = Runtime(engine_opts=ENGINE_OPTS), PublishSpec
            guard_cls = DriftGuard
        art = compile_fn(m, budget(max_err=0.05), sample=fit, families=("maclaurin",))
        with rt:
            rt.publish("clf", art, spec(exact=m))
            guard = guard_cls(
                rt,
                "clf",
                exact=m,
                budget=budget(max_err=0.08),
                threshold=0.3,
                min_rows=48,
                min_agreement=0.9,
                capacity=192,
                seed=9,
            ).attach()
            for Z in calm + traffic:
                rt.submit("clf", Z).result(timeout=30).values
            window = guard.fallback_rate()
            verdict = guard.check()
            for Z in traffic:
                rt.submit("clf", Z).result(timeout=30).values
            post = guard.fallback_rate()
            verdicts.append((window, verdict, post, guard.reservoir.sample()))
    (jw, jv, jpost, jres), (tw, tv, tpost, tres) = verdicts
    assert tw["rows"] == jw["rows"] and tw["invalid"] == jw["invalid"]
    np.testing.assert_array_equal(tres, jres)  # one reservoir of the traffic
    for v in (jv, tv):
        assert v["triggered"] and v["healed"], v
        assert v["agreement"] >= 0.9
    assert tpost["rate"] < 0.3 and jpost["rate"] < 0.3
