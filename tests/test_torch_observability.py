"""The port's observability layer on the CPU: deterministic request
tracing, the metrics registry and its Prometheus text, nearest-rank
percentiles, the DriftGuard heal history, and the ``torch.profiler``
hooks; the cases of ``tests/test_observability.py``, with
``device="cpu"``. The load-bearing property is three-way conservation:
every submitted request is accounted for in the telemetry counters, the
tracer's span counts and the Prometheus text alike. Then the parity of
the two packages: the same scripted traffic renders the same metric
names and label sets."""

import contextlib
import json
import re
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.families import maclaurin as jmac  # noqa: E402
from repro.core.rbf import SVMModel as JSVM  # noqa: E402
from repro.serve import PublishSpec as JPublishSpec  # noqa: E402
from repro.serve import Runtime as JRuntime  # noqa: E402
from repro.serve import runtime as jruntime  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import backend  # noqa: E402
from repro_torch.core.families import Budget, compile_model, maclaurin  # noqa: E402
from repro_torch.serve import PublishSpec, Runtime, svm_engine  # noqa: E402
from repro_torch.serve.runtime import (  # noqa: E402
    ENGINE_STEP,
    DriftGuard,
    FaultInjector,
    InjectedFault,
    MetricsRegistry,
    Observability,
    Tracer,
)
from repro_torch.serve.runtime.obs import profile as obs_profile  # noqa: E402
from repro_torch.serve.runtime.telemetry import (  # noqa: E402
    LatencyWindow,
    _nearest_rank,
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


def _rows(rng, n, d=8, scale=0.6):
    return rng.standard_normal((n, d)).astype(np.float32) * scale


_SAMPLE_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? [^ ]+$")


def _parse_prometheus(text):
    """Validate the text format line by line; return {metric: n_samples}."""
    samples, typed = {}, set()
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            assert len(parts) >= 3, line
            if line.startswith("# TYPE "):
                assert parts[3] in ("counter", "gauge", "histogram"), line
                typed.add(parts[2])
            continue
        assert _SAMPLE_RE.match(line), f"bad sample line: {line!r}"
        name = line.split("{", 1)[0].split(" ", 1)[0]
        samples[name] = samples.get(name, 0) + 1
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        assert name in typed or base in typed, f"untyped sample: {line!r}"
    return samples


def _counter_total(registry, name):
    """Sum a counter family's children across all label sets."""
    return sum(registry.collect().get(name, {}).values())


# ---------------------------------------------------------------- metrics


def test_registry_renders_valid_prometheus_text():
    reg = MetricsRegistry()
    c = reg.counter("demo_requests_total", "Requests.", ("model", "verdict"))
    c.labels(model="m1", verdict="ok").inc()
    c.labels(model="m1", verdict="ok").inc(2)
    c.labels(model='we"ird\\na{me}', verdict="shed").inc()
    reg.gauge("demo_depth", "Queue depth.", ("model",)).labels(model="m1").set(7)
    h = reg.histogram(
        "demo_latency_seconds", "Latency.", ("model",), buckets=(0.1, 1.0)
    )
    for v in (0.05, 0.5, 5.0):
        h.labels(model="m1").observe(v)

    text = reg.render()
    samples = _parse_prometheus(text)
    assert samples["demo_requests_total"] == 2
    assert samples["demo_depth"] == 1
    assert samples["demo_latency_seconds_bucket"] == 3  # 2 finite + +Inf
    assert samples["demo_latency_seconds_sum"] == 1
    assert samples["demo_latency_seconds_count"] == 1
    assert 'demo_latency_seconds_bucket{model="m1",le="+Inf"} 3' in text
    assert 'demo_latency_seconds_bucket{model="m1",le="0.1"} 1' in text
    assert 'demo_latency_seconds_bucket{model="m1",le="1"} 2' in text
    assert 'model="we\\"ird\\\\na{me}"' in text  # escaped, not mangled
    assert c.labels(model="m1", verdict="ok").value == 3


def test_registry_rejects_type_and_label_conflicts():
    reg = MetricsRegistry()
    reg.counter("demo_total", "x", ("a",))
    reg.counter("demo_total", "x", ("a",))  # re-registration is idempotent
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("demo_total", "x", ("a",))
    with pytest.raises(ValueError, match="labels"):
        reg.counter("demo_total", "x", ("b",))
    with pytest.raises(ValueError, match="expected labels"):
        reg.counter("demo_total", "x", ("a",)).labels(wrong="v")
    with pytest.raises(ValueError, match=">= 0"):
        reg.counter("demo_total", "x", ("a",)).labels(a="v").inc(-1)


# ----------------------------------------------------------------- tracer


def _drive(tracer):
    ids = [tracer.new_trace()]
    ids.append(tracer.span("m", "request.admitted", attrs={"rows": 3}))
    ids.append(tracer.span("m", "request.served", attrs={"replica": 1}))
    ids.append(tracer.span("other", "engine.step"))
    return ids


def test_span_ids_are_deterministic_replay():
    a, b = Tracer(seed=7), Tracer(seed=7)
    assert _drive(a) == _drive(b)  # a function of (seed, ordinal) alone
    assert _drive(a) != _drive(Tracer(seed=8))
    assert a.new_id() == f"{7:04x}-{8:012x}"  # 2 drives x 4 ids minted
    frozen = Tracer(seed=7, clock=lambda: 123.0)  # no clock in the ids
    assert _drive(frozen) == _drive(Tracer(seed=7))
    assert _drive(Tracer(seed=7)) == _drive(jruntime.Tracer(seed=7))  # repro's ids


def test_ring_bounds_spans_but_counts_survive_eviction():
    tracer = Tracer(seed=1, capacity=8)
    for i in range(50):
        tracer.span("m", "request.admitted", attrs={"rows": 1})
        tracer.span("m", "request.served", attrs={"replica": i % 2})
    assert len(tracer.spans("m")) == 8  # the ring forgot the early spans
    counts = tracer.counts("m")
    assert counts["request.admitted"] == 50  # the accounting did not
    assert counts["request.served"] == 50
    assert counts["request.served[replica=0]"] == 25
    assert counts["request.served[replica=1]"] == 25
    cons = tracer.conservation("m")
    assert cons["submitted"] == 50 and cons["unaccounted"] == 0


def test_jsonl_export_round_trips(tmp_path):
    tracer = Tracer(seed=2, clock=lambda: 5.0)
    trace = tracer.new_trace()
    tracer.span("m", "request.admitted", trace_id=trace, attrs={"rows": 4})
    tracer.span("m", "request.served", trace_id=trace, attrs={"replica": 0})
    path = tmp_path / "spans.jsonl"
    assert tracer.export_jsonl(path) == 2
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["name"] for r in records] == ["request.admitted", "request.served"]
    assert all(r["trace_id"] == trace for r in records)
    assert records[0]["attrs"] == {"rows": 4}
    assert records[0]["t_start"] == records[0]["t_end"] == 5.0


# ------------------------------------------------------------ percentiles


def test_nearest_rank_percentiles_at_small_n():
    assert _nearest_rank([3.0], 50) == 3.0
    assert _nearest_rank([3.0], 99) == 3.0
    assert _nearest_rank([1.0, 2.0], 50) == 1.0
    assert _nearest_rank([1.0, 2.0], 99) == 2.0
    assert _nearest_rank([1.0, 2.0, 3.0, 4.0], 50) == 2.0
    assert _nearest_rank([1.0, 2.0, 3.0, 4.0], 99) == 4.0
    for n, p50, p99 in [(1, 10.0, 10.0), (2, 10.0, 20.0), (4, 20.0, 40.0)]:
        win = LatencyWindow(maxlen=64)
        for i in range(n):
            win.record((i + 1) * 0.010)
        snap = win.snapshot()
        assert snap["n"] == n
        assert snap["p50_ms"] == pytest.approx(p50)
        assert snap["p99_ms"] == pytest.approx(p99)


# ---------------------------------------------------- runtime integration


def test_runtime_exposes_first_class_gauges_and_spans():
    m = _svm(0)
    obs = Observability(seed=3, registry=MetricsRegistry())
    rng = np.random.default_rng(1)
    with Runtime(engine_opts=ENGINE_OPTS, max_wait_us=500.0, obs=obs) as rt:
        spec = PublishSpec(exact=m, replicas=2)
        digest = rt.publish("m", maclaurin.compile(m), spec)
        rt.predict("m", _rows(rng, 2))
        futs = [rt.submit("m", _rows(rng, 3)) for _ in range(8)]
        for f in futs:
            f.result(timeout=30.0)

        text = rt.render_prometheus()
        samples = _parse_prometheus(text)
        for gauge in (
            "repro_serve_validity_fraction",
            "repro_serve_fallback_rate",
            "repro_serve_queue_rows",
            "repro_serve_step_time_ewma_seconds",
        ):
            assert samples.get(gauge) == 1, gauge
        assert samples.get("repro_serve_breaker_state") == 2  # one per replica
        assert _counter_total(obs.metrics, "repro_serve_requests_total") == 9
        assert "repro_serve_request_latency_seconds_bucket" in text

        key = digest[:12]
        steps = rt.obs.tracer.spans(key, "engine.step")
        assert steps, "engine steps must be traced"
        for s in steps:
            assert s["attrs"]["bucket"] in (8, 16, 32, 64)
            assert "TileConfig" in s["attrs"]["tile_config"]
            assert s["attrs"]["recompiled"] in (True, False)
            assert s["attrs"]["replica"] in (0, 1)
        waits = rt.obs.tracer.spans(key, "request.queue_wait")
        assert waits and all(w["trace_id"] is not None for w in waits)
        served = rt.obs.tracer.spans(key, "request.served")
        assert {s["attrs"]["replica"] for s in served} <= {0, 1}


def _conservation_identities(rt, model, digest, registry):
    """The three-way conservation identity; returns the tracer's counts."""
    st = rt.stats(model)
    done = (
        st["served_requests"]
        + st["failed_requests"]
        + st["deadline_timeouts"]
        + st["closed_requests"]
    )
    assert st["requests"] == done, st

    cons = rt.obs.tracer.conservation(digest[:12])
    assert cons["unaccounted"] == 0, cons
    assert cons["admitted"] == st["requests"], (cons, st["requests"])
    assert cons["shed"] == st["shed_requests"]
    assert cons["served"] == st["served_requests"]
    assert cons["failed"] == st["failed_requests"]
    assert cons["expired"] == st["deadline_timeouts"]
    assert cons["closed"] == st["closed_requests"]

    names = (
        "requests",
        "served_requests",
        "failed_requests",
        "deadline_timeouts",
        "closed_requests",
        "shed_requests",
    )
    prom = {n: _counter_total(registry, f"repro_serve_{n}_total") for n in names}
    assert prom["requests"] == st["requests"], prom
    assert prom["requests"] == (
        prom["served_requests"]
        + prom["failed_requests"]
        + prom["deadline_timeouts"]
        + prom["closed_requests"]
    ), prom
    assert prom["shed_requests"] == st["shed_requests"]
    return cons


def test_conservation_holds_under_scripted_faults():
    m = _svm(2)
    fi = FaultInjector(0)
    obs = Observability(seed=5, registry=MetricsRegistry())
    rng = np.random.default_rng(0)
    with Runtime(
        engine_opts=ENGINE_OPTS,
        fault_injector=fi,
        max_wait_us=500.0,
        breaker=dict(fail_threshold=1, reset_after_s=60.0),
        obs=obs,
    ) as rt:
        spec = PublishSpec(exact=m, replicas=2)
        digest = rt.publish("m", maclaurin.compile(m), spec)
        rt.predict("m", _rows(rng, 2))
        fi.fail_next(FaultInjector.replica_site(ENGINE_STEP, 1), 1)
        doomed = rt.submit("m", _rows(rng, 3))
        with pytest.raises(InjectedFault):
            doomed.result(timeout=30.0)
        for _ in range(5):
            rt.submit("m", _rows(rng, 4)).result(timeout=30.0)

        cons = _conservation_identities(rt, "m", digest, obs.metrics)
        assert cons["submitted"] == 7
        assert cons["failed"] == 1 and cons["served"] == 6
        key = digest[:12]
        flush_failures = rt.obs.tracer.spans(key, "flush.failed")
        assert len(flush_failures) == 1
        assert flush_failures[0]["attrs"]["replica"] == 1
        failed = rt.obs.tracer.spans(key, "request.failed")
        assert failed[0]["attrs"]["error"] == "InjectedFault"


@pytest.mark.stress
def test_conservation_under_seeded_chaos_interleavings():
    """Concurrent submitters, seeded faults, admission pressure and a close
    with work in flight: no request unaccounted in any of the three views."""
    m = _svm(4)
    for chaos_seed in (0, 1):
        fi = FaultInjector(chaos_seed, engine_fault_rate=0.15)
        obs = Observability(seed=chaos_seed, registry=MetricsRegistry())
        rt = Runtime(
            engine_opts=ENGINE_OPTS,
            fault_injector=fi,
            max_wait_us=200.0,
            max_queue_rows=64,
            breaker=dict(fail_threshold=2, reset_after_s=0.05),
            obs=obs,
        )
        try:
            spec = PublishSpec(exact=m, replicas=2)
            digest = rt.publish("m", maclaurin.compile(m), spec)
            rng = np.random.default_rng(chaos_seed)
            try:
                rt.predict("m", _rows(rng, 2))  # warm; may itself be faulted
            except Exception:
                pass

            def submitter(worker):
                wrng = np.random.default_rng(100 + worker)
                for _ in range(12):
                    try:
                        fut = rt.submit("m", _rows(wrng, int(wrng.integers(1, 9))))
                        fut.result(timeout=30.0)
                    except Exception:
                        pass  # any verdict; the accounting must balance

            threads = [threading.Thread(target=submitter, args=(w,)) for w in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            rt.close()
        cons = _conservation_identities(rt, "m", digest, obs.metrics)
        assert cons["submitted"] == 1 + 4 * 12


# ------------------------------------------------------------ heal history


def test_heal_history_in_stats_with_injected_clock():
    m = _svm(27, scale=0.35)
    rng = np.random.default_rng(2)
    art = compile_model(
        m,
        Budget(max_err=0.05),
        sample=_rows(rng, 256, scale=0.25),
        families=("maclaurin",),
    )
    now = [100.0]
    obs = Observability(seed=9, registry=MetricsRegistry())
    with Runtime(engine_opts=ENGINE_OPTS, obs=obs) as rt:
        old_digest = rt.publish("clf", art, PublishSpec(exact=m))
        guard = DriftGuard(
            rt,
            "clf",
            exact=m,
            budget=Budget(max_err=0.08),
            threshold=0.3,
            min_rows=48,
            min_agreement=1.5,  # an impossible bar: the first canary fails
            capacity=192,
            seed=9,
            clock=lambda: now[0],
        ).attach()
        for _ in range(12):
            fut = rt.submit("clf", _rows(rng, 8, scale=1.5))
            assert fut.result(timeout=30.0).values.shape == (8,)

        now[0] = 111.5
        verdict = guard.check()
        assert verdict["triggered"] and not verdict["healed"]
        heals = rt.stats("clf")["heals"]
        assert heals["attempts"] == 1
        assert heals["last_trigger_at"] == 111.5
        assert heals["flipped_digests"] == []
        assert heals["history"][-1]["healed"] is False
        assert heals["history"][-1]["trigger_at"] == 111.5

        now[0] = 222.5
        guard.min_agreement = 0.8
        verdict = guard.check()
        assert verdict["healed"], verdict
        new_digest = rt.registry.resolve("clf")
        assert new_digest != old_digest
        heals = rt.stats(old_digest)["heals"]  # the arc, on the digest that drifted
        assert heals["attempts"] == 2
        assert heals["last_trigger_at"] == 222.5
        assert heals["flipped_digests"] == [new_digest]
        assert [h["healed"] for h in heals["history"]] == [False, True]
        assert heals["history"][-1]["new_digest"] == new_digest
        heals = rt.stats("clf")["heals"]  # ... mirrored onto the new digest
        assert heals["attempts"] == 1
        assert heals["last_trigger_at"] == 222.5
        assert [h["healed"] for h in heals["history"]] == [True]

        key = old_digest[:12]
        arcs = {
            name: rt.obs.tracer.spans(key, name)
            for name in (
                "heal.trigger",
                "heal.reservoir",
                "heal.recompile",
                "heal.canary",
                "heal.flip",
            )
        }
        assert len(arcs["heal.trigger"]) == 2
        assert len(arcs["heal.canary"]) == 2
        assert len(arcs["heal.flip"]) == 1
        flip, trigger = arcs["heal.flip"][0], arcs["heal.trigger"][-1]
        assert flip["trace_id"] == trigger["trace_id"]
        assert flip["parent_id"] == trigger["span_id"]
        assert flip["attrs"]["new_digest"] == new_digest[:12]
        assert [c["attrs"]["passed"] for c in arcs["heal.canary"]] == [False, True]
        collected = obs.metrics.collect()["repro_serve_heals_total"]
        outcomes = {dict(k)["outcome"]: v for k, v in collected.items()}
        assert outcomes == {"failed": 1, "healed": 1}


# -------------------------------------------------------------- profiling


def test_runtime_profile_writes_a_chrome_trace(tmp_path):
    m = _svm(0)
    rng = np.random.default_rng(0)
    path = tmp_path / "step.json"
    with Runtime(engine_opts=ENGINE_OPTS, obs=Observability()) as rt:
        rt.publish("m", maclaurin.compile(m), PublishSpec(exact=m))
        Z = _rows(rng, 4)
        Z[1] *= 60.0  # out of the envelope: the exact fallback runs in-session
        assert rt.profile("m", Z, path) == str(path)
    assert not obs_profile.enabled()  # capture() restored the hook state
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert "svm_engine.step/maclaurin/b8" in names
    assert "repro.backend/rbf_scores" in names


def test_profile_hooks_install_and_uninstall_cleanly():
    assert not obs_profile.enabled()
    assert backend._profile_scope is None
    assert svm_engine._profile_annotation is None
    prev = obs_profile.enable(True)
    try:
        assert prev is False and obs_profile.enabled()
        assert backend._profile_scope is torch.profiler.record_function
        assert svm_engine._profile_annotation is torch.profiler.record_function
        with obs_profile.annotate("test/annotation"):
            pass
    finally:
        obs_profile.enable(False)
    assert backend._profile_scope is None
    assert svm_engine._profile_annotation is None


def test_engine_and_backend_name_their_ranges_as_repro_does(monkeypatch):
    """The engine wraps each bucket step, and the backend its dispatch
    seams, in ranges named as ``repro``'s are, on the same calls."""
    from repro.core import backend as jbackend
    from repro.serve import svm_engine as jsvm_engine

    def recorder(seen):
        def factory(name):
            seen.append(name)
            return contextlib.nullcontext()

        return factory

    Z = _rows(np.random.default_rng(0), 3)
    Z[0] *= 60.0  # one row out of the envelope: the exact fallback runs
    names = []
    for engine_mod, backend_mod, m, art, opts, as_input in (
        (svm_engine, backend, _svm(0), maclaurin.compile, ENGINE_OPTS, torch.tensor),
        (jsvm_engine, jbackend, _jsvm(0), jmac.compile, J_ENGINE_OPTS, jnp.asarray),
    ):
        seen = []
        monkeypatch.setattr(engine_mod, "_profile_annotation", recorder(seen))
        monkeypatch.setattr(backend_mod, "_profile_scope", recorder(seen))
        eng = engine_mod.SVMEngine(art(m), m, **opts)
        eng.submit(Z).values
        eng.submit_exact(Z[:2]).values
        backend_mod.family_scores(eng.artifact, as_input(Z))
        names.append(seen)
    assert names[0] == [
        "svm_engine.step/maclaurin/b8",
        "repro.backend/rbf_scores",  # the fallback row, when it is read
        "svm_engine.step_exact/b8",
        "repro.backend/rbf_scores",
        "repro.backend/family_scores/maclaurin",
    ]
    assert set(names[0]) == set(names[1])  # repro traces each name once


# ----------------------------------------------- parity with repro's runtime


def _label_sets(text):
    """{metric name: sorted label-name tuples}, histogram samples folded
    into their family; values (times among them) are left out."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head = line.rsplit(" ", 1)[0]
        name, _, labels = head.partition("{")
        name = re.sub(r"_(bucket|sum|count)$", "", name)
        keys = tuple(sorted(re.findall(r'(\w+)="', labels)))
        out.setdefault(name, set()).add(keys)
    return {k: sorted(v) for k, v in out.items()}


def _scripted_traffic(rt, fi, model, rng):
    rt.predict(model, _rows(rng, 2))
    fi.fail_next(ENGINE_STEP, 1)
    with pytest.raises(Exception):
        rt.submit(model, _rows(rng, 3)).result(timeout=30)
    for n in (1, 4, 9, 3):
        rt.submit(model, _rows(rng, n)).result(timeout=30).values


def test_parity_prometheus_names_and_label_sets():
    """(e) The same scripted traffic renders the same metric names, label
    names and non-time values in both packages."""
    texts = []
    for pkg in ("repro", "repro_torch"):
        fi = (jruntime.FaultInjector if pkg == "repro" else FaultInjector)(0)
        if pkg == "repro":
            obs = jruntime.Observability(registry=jruntime.MetricsRegistry())
            m = _jsvm(3)
            rt = JRuntime(engine_opts=J_ENGINE_OPTS, fault_injector=fi, obs=obs)
            art, spec = jmac.compile(m), JPublishSpec(exact=m)
        else:
            m, obs = _svm(3), Observability(registry=MetricsRegistry())
            rt = Runtime(engine_opts=ENGINE_OPTS, fault_injector=fi, obs=obs)
            art, spec = maclaurin.compile(m), PublishSpec(exact=m)
        with rt:
            rt.publish("m", art, spec)
            _scripted_traffic(rt, fi, "m", np.random.default_rng(5))
            texts.append(rt.render_prometheus())
    ref, ours = _label_sets(texts[0]), _label_sets(texts[1])
    assert ours == ref
    assert "repro_serve_requests_total" in ours

    def counts(text):  # counters that are not times, by name and labels
        rows = {}
        for line in text.splitlines():
            if line.startswith("repro_serve_") and "_total" in line.split("{")[0]:
                head, value = line.rsplit(" ", 1)
                rows[re.sub(r'model_digest="\w+"', "", head)] = float(value)
        return rows

    assert counts(texts[1]) == counts(texts[0])
