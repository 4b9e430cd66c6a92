"""The port's multi-tenant serving runtime on the CPU: content-addressed
registry (dedupe, aliases, lazy directory loads, LRU eviction), the
micro-batching scheduler (coalescing, row order, flush rules, no new
bucket configs after warm-up under concurrency), the fourier per-artifact
fallback through the coalesced path, alias hot-swap mid-traffic, and
thread-safety of the engine's statistics; the cases of
``tests/test_runtime.py``, with ``device="cpu"``. Then the parity of the
two packages' runtimes on the same seeded inputs: one artifact file, one
digest in both registries; one request list, the same answers."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.families import maclaurin as jmac  # noqa: E402
from repro.core.rbf import SVMModel as JSVM  # noqa: E402
from repro.serve import PublishSpec as JPublishSpec  # noqa: E402
from repro.serve import Runtime as JRuntime  # noqa: E402
from repro.serve.runtime import ArtifactRegistry as JRegistry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.families import CompiledArtifact, fourier, maclaurin  # noqa: E402
from repro_torch.serve import PublishSpec, Runtime, SVMEngine  # noqa: E402
from repro_torch.serve.runtime import ArtifactRegistry, MicroBatcher  # noqa: E402

ENGINE_OPTS = dict(device="cpu", min_bucket=8, max_batch=64)
J_ENGINE_OPTS = dict(min_bucket=8, max_batch=64)


def _arrays(seed=0, d=8, n_sv=40, bias=0.1, scale=0.6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_sv, d)).astype(np.float32) * scale
    gamma = np.float32(0.8 / (4.0 * float((X.astype(np.float64) ** 2).sum(1).max())))
    ay = rng.standard_normal(n_sv).astype(np.float32) * 0.5
    return X, ay, np.float32(bias), gamma


def _svm(seed=0, d=8, n_sv=40, bias=0.1):
    return convert.svm_from_numpy(*_arrays(seed, d, n_sv, bias), device="cpu")


def _jsvm(seed=0, d=8, n_sv=40, bias=0.1):
    X, ay, b, g = _arrays(seed, d, n_sv, bias)
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


def _batches(rng, count, d=8, lo=1, hi=5):
    return [
        rng.standard_normal((int(rng.integers(lo, hi + 1)), d)).astype(np.float32) * 0.3
        for _ in range(count)
    ]


# ----------------------------------------------------------------- registry


def test_registry_dedupes_identical_compiles():
    m = _svm(3)
    reg = ArtifactRegistry(warmup_on_load=False, engine_opts=ENGINE_OPTS)
    d1 = reg.register(maclaurin.compile(m), PublishSpec(alias="a@latest"))
    d2 = reg.register(maclaurin.compile(m), PublishSpec(alias="b@latest"))
    assert d1 == d2
    snap = reg.snapshot()
    assert snap["models"] == 1
    assert snap["aliases"] == {"a@latest": d1, "b@latest": d1}
    _, e1 = reg.get_engine("a@latest")
    _, e2 = reg.get_engine("b@latest")
    assert e1 is e2  # one engine, one copy of the arrays
    assert reg.loads == 1


def test_registry_ref_resolution():
    reg = ArtifactRegistry(warmup_on_load=False, engine_opts=ENGINE_OPTS)
    digest = reg.register(maclaurin.compile(_svm(3)), PublishSpec(alias="det@latest"))
    assert reg.resolve(digest) == digest
    assert reg.resolve("det@latest") == digest
    assert reg.resolve("det") == digest  # @latest convention
    assert reg.resolve(digest[:10]) == digest  # unique prefix
    with pytest.raises(KeyError):
        reg.resolve("nope")


def test_registry_lazy_directory_load(tmp_path):
    m1, m2 = _svm(1), _svm(2)
    maclaurin.compile(m1).save(str(tmp_path / "alpha.npz"))
    maclaurin.compile(m2).save(str(tmp_path / "beta.npz"))
    reg = ArtifactRegistry(warmup_on_load=False, engine_opts=ENGINE_OPTS)
    added = reg.add_directory(str(tmp_path))
    assert set(added) == {"alpha@latest", "beta@latest"}
    assert all(e.artifact is None and e.engine is None for e in reg._entries.values())
    assert added["alpha@latest"] == maclaurin.compile(m1).digest()
    digest, eng = reg.get_engine("alpha")
    assert eng.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in eng.artifact.arrays.values())
    Z = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        eng.predict(Z)[0],
        SVMEngine(maclaurin.compile(m1), None, **ENGINE_OPTS).predict(Z)[0],
        rtol=1e-6,
        atol=1e-6,
    )
    assert reg.snapshot()["loaded"] == 1  # beta is still cold


def test_registry_lru_eviction_under_budget(tmp_path):
    arts = [maclaurin.compile(_svm(s)) for s in (1, 2, 3)]
    for i, a in enumerate(arts):
        a.save(str(tmp_path / f"m{i}.npz"))
    budget = 2 * arts[0].nbytes() + 8  # room for two engines
    reg = ArtifactRegistry(
        memory_budget_bytes=budget, warmup_on_load=False, engine_opts=ENGINE_OPTS
    )
    reg.add_directory(str(tmp_path))
    reg.get_engine("m0")
    reg.get_engine("m1")
    assert reg.eviction_count == 0
    reg.get_engine("m2")  # busts the budget
    assert reg.eviction_count == 1
    snap = reg.snapshot()
    assert snap["loaded"] == 2
    assert snap["loaded_bytes"] <= budget
    e0 = reg._entries[reg.resolve("m0")]  # least recently used
    assert e0.engine is None and e0.artifact is None and e0.path is not None
    _, eng = reg.get_engine("m0")  # transparent reload
    Z = np.random.default_rng(1).standard_normal((3, 8)).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        eng.predict(Z)[0],
        SVMEngine(arts[0], None, **ENGINE_OPTS).predict(Z)[0],
        rtol=1e-6,
        atol=1e-6,
    )
    assert reg.loads == 4  # 3 cold loads + 1 reload


def test_registry_in_memory_entry_never_loses_arrays():
    arts = [maclaurin.compile(_svm(s)) for s in (1, 2)]
    reg = ArtifactRegistry(
        memory_budget_bytes=arts[0].nbytes() + 8,
        warmup_on_load=False,
        engine_opts=ENGINE_OPTS,
    )
    d0 = reg.register(arts[0], PublishSpec(alias="m0"))
    reg.register(arts[1], PublishSpec(alias="m1"))
    reg.get_engine("m0")
    reg.get_engine("m1")
    assert reg.eviction_count == 1
    entry = reg._entries[d0]
    assert entry.engine is None and entry.artifact is not None


# ---------------------------------------------------------------- scheduler


def test_microbatcher_coalesces_one_bucket_fill():
    eng = SVMEngine(maclaurin.compile(_svm(5)), None, **ENGINE_OPTS)
    eng.warmup([8])
    with MicroBatcher(eng, max_wait_us=200_000, flush_rows=8) as mb:
        rng = np.random.default_rng(2)
        Zs = [rng.standard_normal((1, 8)).astype(np.float32) * 0.3 for _ in range(8)]
        futs = [mb.submit(Z) for Z in Zs]  # 8 rows == flush_rows
        for Z, f in zip(Zs, futs):
            got = f.result(timeout=10).values
            np.testing.assert_allclose(got, eng.predict(Z)[0], rtol=1e-6, atol=1e-6)
        snap = mb.telemetry.snapshot()
        assert snap["flushes"] == 1  # one engine step for all 8
        assert snap["requests"] == 8
        assert snap["coalescing_factor"] == 8.0
        assert snap["deadline_flushes"] == 0  # the bucket filled


def test_microbatcher_deadline_flushes_lone_request():
    eng = SVMEngine(maclaurin.compile(_svm(5)), None, **ENGINE_OPTS)
    eng.warmup([8])
    with MicroBatcher(eng, max_wait_us=2_000, flush_rows=64) as mb:
        Z = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
        t0 = time.perf_counter()
        res = mb.submit(Z).result(timeout=10)
        np.testing.assert_allclose(res.values, eng.predict(Z)[0], rtol=1e-6, atol=1e-6)
        assert time.perf_counter() - t0 < 5.0  # deadline, not forever
        assert mb.telemetry.snapshot()["deadline_flushes"] >= 1


def test_microbatcher_preserves_row_order_under_concurrency():
    eng = SVMEngine(maclaurin.compile(_svm(6)), None, **ENGINE_OPTS)
    eng.warmup()
    rng = np.random.default_rng(4)
    Zs = _batches(rng, 24)
    expected = [eng.predict(Z)[0] for Z in Zs]
    results = [None] * len(Zs)
    with MicroBatcher(eng, max_wait_us=1_000, flush_rows=16) as mb:

        def client(i):
            results[i] = mb.submit(Zs[i]).result(timeout=10)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(Zs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    for i, res in enumerate(results):
        assert len(res) == Zs[i].shape[0]
        np.testing.assert_allclose(res.values, expected[i], rtol=1e-6, atol=1e-6)


def test_microbatcher_no_new_bucket_config_after_warmup():
    eng = SVMEngine(maclaurin.compile(_svm(7)), None, **ENGINE_OPTS)
    eng.warmup()  # every bucket resolved
    before = eng.jit_cache_size()
    Zs = _batches(np.random.default_rng(5), 40)
    with MicroBatcher(eng, max_wait_us=500, flush_rows=8) as mb:
        futs = [mb.submit(Z) for Z in Zs]
        for f in futs:
            f.result(timeout=10).values
    assert eng.jit_cache_size() == before
    assert eng.stats.compiled_steps == before


def test_microbatcher_survives_cancelled_future():
    eng = SVMEngine(maclaurin.compile(_svm(5)), None, **ENGINE_OPTS)
    eng.warmup([8])
    with MicroBatcher(eng, max_wait_us=20_000, flush_rows=64) as mb:
        doomed = mb.submit(np.zeros((1, 8), np.float32))
        assert doomed.cancel()  # still queued -> cancellable
        Z = np.random.default_rng(12).standard_normal((2, 8)).astype(np.float32)
        res = mb.submit(Z).result(timeout=10)  # the worker is still alive
        np.testing.assert_allclose(res.values, eng.predict(Z)[0], rtol=1e-6, atol=1e-6)


def test_microbatcher_empty_submit_is_free():
    eng = SVMEngine(maclaurin.compile(_svm(5)), None, **ENGINE_OPTS)
    with MicroBatcher(eng, max_wait_us=1_000) as mb:
        before = eng.stats.snapshot()
        res = mb.submit(np.zeros((0, 8), np.float32)).result(timeout=10)
        assert res.values.shape == (0,)
        assert res.valid.shape == (0,) and res.labels.shape == (0,)
        assert len(res) == 0
        assert eng.stats.snapshot() == before  # engine never touched


def test_runtime_eviction_retires_idle_batcher():
    arts = [maclaurin.compile(_svm(s)) for s in (1, 2)]
    with Runtime(
        memory_budget_bytes=arts[0].nbytes() + 8,
        max_wait_us=200,
        warmup_on_load=False,
        engine_opts=ENGINE_OPTS,
    ) as rt:
        d0 = rt.publish("m0", arts[0])
        rt.publish("m1", arts[1])
        Z = np.random.default_rng(13).standard_normal((2, 8)).astype(np.float32)
        v0 = rt.predict("m0", Z)[0]
        rt.predict("m1", Z)  # busts the budget, evicts m0
        assert rt.registry.eviction_count == 1
        assert d0 not in rt._batchers  # batcher retired with the engine
        np.testing.assert_allclose(rt.predict("m0", Z)[0], v0, rtol=1e-6, atol=1e-6)


def test_served_request_counted_before_its_answer():
    """A flush and its requests are counted, and their spans emitted,
    before any of its futures resolves, so whatever reads the metrics
    (the HTTP front door's ``/metrics``) or the tracer's conservation after
    its answer finds the request there. The callbacks run on the flush
    thread at the moment each future resolves (a lone request waits its
    50 ms deadline, so each is attached before)."""
    with Runtime(max_wait_us=50_000, warmup_on_load=False, engine_opts=ENGINE_OPTS) as rt:
        digest = rt.publish("m", maclaurin.compile(_svm(3)))
        tel = rt.telemetry("m")
        tracer = rt.obs.tracer
        Z = np.random.default_rng(14).standard_normal((2, 8)).astype(np.float32)
        seen = []

        def read(_):
            seen.append((tel.snapshot(), tracer.conservation(digest[:12])))

        for _ in range(3):
            fut = rt.submit("m", Z)
            fut.add_done_callback(read)
            fut.result()
        assert [s["served_requests"] for s, _ in seen] == [1, 2, 3]
        assert [s["flushes"] for s, _ in seen] == [1, 2, 3]
        assert [c["served"] for _, c in seen] == [1, 2, 3]
        assert all(c["unaccounted"] == 0 for _, c in seen)


def test_runtime_warmup_without_warmup_on_load():
    with Runtime(warmup_on_load=False, engine_opts=ENGINE_OPTS) as rt:
        rt.publish("m", maclaurin.compile(_svm(4)))
        assert rt.warmup("m") >= 4  # buckets 8..64 resolved now


def test_engine_result_split_rejects_bad_sizes():
    eng = SVMEngine(maclaurin.compile(_svm(5)), None, **ENGINE_OPTS)
    res = eng.submit(np.zeros((5, 8), np.float32))
    with pytest.raises(ValueError):
        res.split([2, 2])  # 4 != 5


def test_slice_result_defers_and_shares_one_materialize():
    eng = SVMEngine(maclaurin.compile(_svm(5)), None, **ENGINE_OPTS)
    Z = np.random.default_rng(6).standard_normal((6, 8)).astype(np.float32) * 0.3
    res = eng.submit(Z)
    fired = []
    res.on_materialize = fired.append
    a, b = res.split([2, 4])
    assert res._done is None  # nothing synced yet
    _ = a.values  # the first slice materializes
    assert res._done is not None and len(fired) == 1
    _ = b.labels
    assert len(fired) == 1  # the hook fires once
    np.testing.assert_allclose(
        np.concatenate([a.values, b.values]), eng.predict(Z)[0], rtol=1e-6, atol=1e-6
    )


# ------------------------------------------------- fourier artifact fallback


def test_fourier_artifact_fallback_through_runtime():
    m = _svm(8, d=6, n_sv=30)
    art = fourier.compile(m, num_features=32, err_tolerance=0.0)  # verdict: invalid
    assert art.meta["valid_globally"] is False
    rng = np.random.default_rng(7)
    Zs = [
        rng.standard_normal((n, 6)).astype(np.float32) * 0.3
        for n in (1, 3, 2, 4, 1, 2, 3, 1)
    ]
    with Runtime(max_wait_us=100_000, flush_rows=17, engine_opts=ENGINE_OPTS) as rt:
        rt.publish("rff", art, PublishSpec(exact=m))
        rt.warmup("rff")
        results = [None] * len(Zs)

        def client(i):
            results[i] = rt.submit("rff", Zs[i]).result(timeout=10)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(Zs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for i, res in enumerate(results):
            assert not res.valid.any()  # per-artifact verdict
            np.testing.assert_allclose(
                res.values, _exact_scores(m, Zs[i])[:, 0], rtol=1e-4, atol=1e-4
            )
        assert rt.stats("rff")["fallback_rate"] == 1.0  # every row fell back


# ----------------------------------------------------------------- hot swap


def test_alias_hot_swap_atomic():
    m1, m2 = _svm(1, bias=5.0), _svm(1, bias=-5.0)
    with Runtime(max_wait_us=200, engine_opts=ENGINE_OPTS) as rt:
        d1 = rt.publish("det", maclaurin.compile(m1))
        Z = np.random.default_rng(8).standard_normal((3, 8)).astype(np.float32) * 0.3
        v1 = rt.predict("det", Z)[0]
        d2 = rt.publish("det", maclaurin.compile(m2))  # hot swap
        assert d1 != d2
        v2 = rt.predict("det", Z)[0]
        np.testing.assert_allclose(v2 - v1, np.full(3, -10.0), atol=1e-4)
        np.testing.assert_allclose(rt.predict(d1, Z)[0], v1, rtol=1e-6)


def test_alias_hot_swap_mid_traffic():
    a_old = maclaurin.compile(_svm(2, bias=5.0))
    a_new = maclaurin.compile(_svm(2, bias=-5.0))
    Z = np.random.default_rng(9).standard_normal((2, 8)).astype(np.float32) * 0.3
    with Runtime(max_wait_us=200, engine_opts=ENGINE_OPTS) as rt:
        rt.publish("det", a_old)
        rt.warmup("det")
        want_old = rt.predict("det", Z)[0].copy()
        want_new = SVMEngine(a_new, None, **ENGINE_OPTS).predict(Z)[0]
        stop = threading.Event()
        errors = []
        saw = {"old": 0, "new": 0}

        def client():
            while not stop.is_set():
                got = rt.predict("det", Z)[0]
                if np.allclose(got, want_old, atol=1e-4):
                    saw["old"] += 1
                elif np.allclose(got, want_new, atol=1e-4):
                    saw["new"] += 1
                else:
                    errors.append(got)
                    return

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        rt.publish("det", a_new)  # swap under live traffic
        np.testing.assert_allclose(rt.predict("det", Z)[0], want_new, atol=1e-4)
        time.sleep(0.25)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not errors, f"torn or unknown result: {errors[0]}"
        assert saw["old"] > 0 and saw["new"] > 0


# ------------------------------------------------------------ thread safety


def test_engine_stats_thread_safe_under_concurrent_predict():
    eng = SVMEngine(maclaurin.compile(_svm(3)), None, **ENGINE_OPTS)
    eng.warmup([8])
    Z = np.zeros((3, 8), np.float32)
    threads_n, reps = 8, 50

    def worker():
        for _ in range(reps):
            eng.predict(Z)

    base = eng.stats.snapshot()
    threads = [threading.Thread(target=worker) for _ in range(threads_n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    snap = eng.stats.snapshot()
    assert snap["instances"] - base["instances"] == threads_n * reps * 3
    assert snap["batches"] - base["batches"] == threads_n * reps
    hits = sum(snap["bucket_hits"].values()) - sum(base["bucket_hits"].values())
    assert hits == threads_n * reps


@pytest.mark.stress
def test_runtime_multithreaded_stress():
    a1, a2 = maclaurin.compile(_svm(1)), maclaurin.compile(_svm(2))
    ref1 = SVMEngine(a1, None, **ENGINE_OPTS)
    ref2 = SVMEngine(a2, None, **ENGINE_OPTS)
    clients, reps = 8, 25
    rng = np.random.default_rng(10)
    work = [
        [
            ("m1", Z, ref1.predict(Z)[0])
            if rng.random() < 0.5
            else ("m2", Z, ref2.predict(Z)[0])
            for Z in _batches(rng, reps)
        ]
        for _ in range(clients)
    ]
    with Runtime(max_wait_us=300, flush_rows=16, engine_opts=ENGINE_OPTS) as rt:
        rt.publish("m1", a1)
        rt.publish("m2", a2)
        rt.warmup("m1"), rt.warmup("m2")
        engines = [rt.registry.get_engine(m)[1] for m in ("m1", "m2")]
        configs = [e.jit_cache_size() for e in engines]
        errors = []

        def client(items):
            try:
                futs = [(rt.submit(name, Z), want) for name, Z, want in items]
                for fut, want in futs:
                    got = fut.result(timeout=30).values
                    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            except Exception as e:  # surfaced after join
                errors.append(e)

        threads = [threading.Thread(target=client, args=(w,)) for w in work]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[0]
        assert time.perf_counter() - t0 < 30.0
        stats = rt.stats()
        total_requests = sum(ms["requests"] for ms in stats["models"].values())
        total_rows = sum(ms["rows"] for ms in stats["models"].values())
        assert total_requests == clients * reps
        assert total_rows == sum(Z.shape[0] for w in work for _, Z, _ in w)
        total_flushes = sum(ms["flushes"] for ms in stats["models"].values())
        assert total_flushes <= total_requests
        assert [e.jit_cache_size() for e in engines] == configs  # none new


# --------------------------------------------------- parity with repro's runtime


def test_parity_digest_and_add_file(tmp_path):
    """(a) An artifact compiled and saved by ``repro`` has one digest in
    both registries, and ``add_file`` indexes the file in both."""
    path = str(tmp_path / "m.npz")
    jart = jmac.compile(_jsvm(11))
    jart.save(path)
    j_reg = JRegistry(warmup_on_load=False, engine_opts=J_ENGINE_OPTS)
    t_reg = ArtifactRegistry(warmup_on_load=False, engine_opts=ENGINE_OPTS)
    jd = j_reg.add_file(path, alias="m@latest")
    td = t_reg.add_file(path, alias="m@latest")
    assert jd == td == jart.digest()
    assert t_reg.register(CompiledArtifact.load(path, device="cpu")) == jd
    assert t_reg.snapshot()["models"] == 1  # the same entry
    _, eng = t_reg.get_engine("m")  # loads, re-hashing the file
    _, jeng = j_reg.get_engine("m")
    Z = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        eng.predict(Z)[0], jeng.predict(Z)[0], rtol=2e-4, atol=1e-5
    )


def _requests(seed, d=8, count=30):
    """Requests of 1-6 rows; every fourth row pushed far out of the
    Eq 3.11 envelope (no row lies near the bound)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        Z = rng.standard_normal((int(rng.integers(1, 7)), d)).astype(np.float32) * 0.3
        far = rng.random(Z.shape[0]) < 0.25
        Z[far] *= 60.0
        out.append(Z)
    return out


def _serve(rt, model, requests):
    """Every request through ``rt`` from 4 client threads."""
    results = [None] * len(requests)

    def client(idx):
        futs = [(i, rt.submit(model, requests[i])) for i in idx]
        for i, f in futs:
            r = f.result(timeout=30)
            results[i] = (r.values, r.valid, r.labels)

    threads = [
        threading.Thread(target=client, args=(range(c, len(requests), 4),))
        for c in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


@pytest.mark.parametrize("k", [1, 3])
def test_parity_coalesced_serving(k):
    """(b) One request list, out-of-envelope rows included, through both
    packages' runtimes: the same values per request (rtol 2e-4, atol
    2e-4 max|score|), labels, validity and fallback totals."""
    rng = np.random.default_rng(20 + k)
    X = (rng.standard_normal((40, 8)) * 0.6).astype(np.float32)
    ay = rng.standard_normal((k, 40) if k > 1 else 40).astype(np.float32) * 0.5
    b = rng.standard_normal(k).astype(np.float32) if k > 1 else np.float32(0.1)
    g = np.float32(0.8 / (4.0 * float((X.astype(np.float64) ** 2).sum(1).max())))
    jm = JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.asarray(b),
        gamma=jnp.float32(g),
    )
    tm = convert.svm_from_numpy(X, ay, b, g, device="cpu")
    requests = _requests(30 + k)
    with (
        JRuntime(max_wait_us=2_000, engine_opts=J_ENGINE_OPTS) as jrt,
        Runtime(max_wait_us=2_000, engine_opts=ENGINE_OPTS) as trt,
    ):
        jrt.publish("m", jmac.compile(jm), JPublishSpec(exact=jm))
        trt.publish("m", maclaurin.compile(tm), PublishSpec(exact=tm))
        got_j = _serve(jrt, "m", requests)
        got_t = _serve(trt, "m", requests)
        sj, st = jrt.stats("m"), trt.stats("m")
    far = 0
    for Z, (jv, jval, jl), (tv, tval, tl) in zip(requests, got_j, got_t):
        scale = max(1.0, float(np.abs(jv).max()))
        np.testing.assert_allclose(tv, jv, rtol=2e-4, atol=2e-4 * scale)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tval, jval)
        far += int((~tval).sum())
    assert far > 0
    fallbacks = (st["engine"]["fallback_instances"], sj["engine"]["fallback_instances"])
    assert fallbacks == (far, far)
    assert st["requests"] == sj["requests"] == len(requests)
    assert st["rows"] == sj["rows"]


def test_engine_surface_the_runtime_reads_matches_repro():
    """The engine attributes the runtime reads: ``exact_available`` (the
    breaker degrades only when it is true), ``fallback_rate`` and
    ``padding_overhead`` on ``EngineStats``, equal to ``repro``'s on the
    same traffic."""
    from repro.serve import SVMEngine as JEngine

    jm, tm = _jsvm(4), _svm(4)
    engines = [
        (JEngine(jmac.compile(jm), jm, **J_ENGINE_OPTS), JEngine(jmac.compile(jm))),
        (
            SVMEngine(maclaurin.compile(tm), tm, **ENGINE_OPTS),
            SVMEngine(maclaurin.compile(tm), **ENGINE_OPTS),
        ),
    ]
    for with_exact, without in engines:
        assert with_exact.exact_available and not without.exact_available
        for Z in _requests(3, count=12):
            with_exact.submit(Z).values
    (j, _), (t, _) = engines
    assert t.stats.fallback_instances > 0
    for name in ("fallback_rate", "padding_overhead"):
        assert getattr(t.stats, name) == getattr(j.stats, name)
        assert t.stats.snapshot()[name] == getattr(t.stats, name)
