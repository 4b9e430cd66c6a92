"""The port's HTTP front door (``repro_torch.serve.server``) on the CPU: a
real localhost server, real ``http.client`` requests with no imports of
either package on the client side of the wire, driving the port's
coalescing, admission and observability stack with
``engine_opts=dict(device="cpu")``; the cases of ``tests/test_server.py``.
Then the parity of the two packages' servers: the same artifact bytes
POSTed to each give one digest and agreeing ``:predict`` answers.

Every client has a 60 s socket timeout, every thread join a bound, and
every server and runtime is closed by a context manager.
"""

import base64
import http.client
import json
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core.families import get_family as j_get_family  # noqa: E402
from repro.serve.server import create_app as j_create_app  # noqa: E402
from repro.serve.server import serve as j_serve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.families import fourier, maclaurin  # noqa: E402
from repro_torch.serve import PublishSpec, create_app  # noqa: E402
from repro_torch.serve.runtime import FaultInjector, Runtime  # noqa: E402
from repro_torch.serve.server import TenantConfig, serve  # noqa: E402

ENGINE_OPTS = dict(device="cpu", min_bucket=8, max_batch=64)
J_ENGINE_OPTS = dict(min_bucket=8, max_batch=64)
JOIN_S = 120.0


def _arrays(seed=0, d=8, n_sv=40, bias=0.1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_sv, d)).astype(np.float32) * 0.6
    gamma = np.float32(0.8 / (4.0 * float((X.astype(np.float64) ** 2).sum(1).max())))
    ay = rng.standard_normal(n_sv).astype(np.float32) * 0.5
    return X, ay, np.float32(bias), gamma


def _svm(seed=0, d=8, n_sv=40, bias=0.1):
    return convert.svm_from_numpy(*_arrays(seed, d, n_sv, bias), device="cpu")


def _rows(rng, n, d=8):
    """n rows of width d; ``rng`` a generator or a seed."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    return (rng.standard_normal((n, d)) * 0.3).tolist()


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


class _Client:
    """Tiny JSON-over-HTTP client: stdlib only, one connection."""

    def __init__(self, host, port):
        self.conn = http.client.HTTPConnection(host, port, timeout=60)

    def request(self, method, path, body=None, headers=None):
        hdrs = dict(headers or {})
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        self.conn.request(method, path, body=data, headers=hdrs)
        resp = self.conn.getresponse()
        raw = resp.read()
        ctype = resp.headers.get("content-type", "")
        is_json = raw and ctype.startswith("application/json")
        parsed = json.loads(raw) if is_json else raw
        return resp.status, parsed, {k.lower(): v for k, v in resp.headers.items()}

    def predict(self, ref, rows, headers=None, **fields):
        body = {"rows": rows, **fields}
        return self.request("POST", f"/v1/models/{ref}:predict", body, headers)

    def publish(self, payload, **spec):
        body = {"artifact_b64": payload, "spec": spec}
        return self.request("POST", "/v1/models", body)

    def close(self):
        self.conn.close()


def _app_and_server(runtime=None, tenants=None, **runtime_kw):
    runtime_kw.setdefault("engine_opts", ENGINE_OPTS)
    runtime_kw.setdefault("warmup_on_load", False)
    kw = runtime_kw if runtime is None else {}
    app = create_app(runtime, tenants=tenants, **kw)
    return app, serve(app)


def _publish(app, model, alias, family=maclaurin, **spec_kw):
    art = family.compile(model)
    return app.runtime.publish(alias, art, PublishSpec(exact=model, **spec_kw))


# ------------------------------------------------------------ basic contract


def test_predict_returns_scores_validity_and_digest():
    app, h = _app_and_server()
    with app, h:
        digest = _publish(app, _svm(0), "det")
        c = _Client(h.host, h.port)
        status, body, _ = c.predict("det", _rows(0, 5))
        assert status == 200
        assert body["digest"] == digest
        assert body["n"] == 5
        assert len(body["scores"]) == 5 and len(body["labels"]) == 5
        assert body["valid"] == [True] * 5  # in-envelope traffic
        assert body["family"] == "maclaurin"
        assert body["dtype"] == "float32"
        # digest-addressed and prefix-addressed refs serve identically
        status2, body2, _ = c.predict(digest[:12], _rows(0, 5))
        assert status2 == 200 and body2["scores"] == body["scores"]
        c.close()


def test_error_taxonomy_maps_onto_http():
    app, h = _app_and_server()
    with app, h:
        _publish(app, _svm(0), "det")
        c = _Client(h.host, h.port)
        ZERO = {"rows": [[0.0] * 8]}
        cases = [
            ("POST", "/v1/models/nope:predict", ZERO, 404, "model_not_found"),
            ("POST", "/v1/models/det:predict", {"rowz": []}, 400, "invalid_request"),
            ("POST", "/v1/models/det:predict", None, 400, "invalid_request"),
            ("GET", "/v1/nowhere", None, 404, "not_found"),
            ("DELETE", "/v1/models", None, 405, "method_not_allowed"),
        ]
        for method, path, body, want_status, want_code in cases:
            status, parsed, _ = c.request(method, path, body)
            assert status == want_status, (path, status, parsed)
            assert parsed["error"]["code"] == want_code
            assert parsed["error"]["status"] == want_status
        c.close()


def test_http_publish_then_predict_no_client_imports():
    """Artifact bytes over the wire, the digest back, predictions against
    the digest; the client knows nothing of either package."""
    app, h = _app_and_server()
    with app, h:
        art = maclaurin.compile(_svm(4))
        payload = base64.b64encode(art.to_bytes()).decode()
        c = _Client(h.host, h.port)
        status, body, _ = c.publish(payload, alias="uploaded")
        assert status == 201
        digest = body["digest"]
        assert digest == art.digest()  # content addressing end to end
        status, listing, _ = c.request("GET", "/v1/models")
        assert status == 200
        assert [m["digest"] for m in listing["models"]] == [digest]
        assert listing["models"][0]["aliases"] == ["uploaded"]
        status, body, _ = c.predict("uploaded", _rows(1, 3))
        assert status == 200 and body["digest"] == digest
        # a corrupt upload is refused with the taxonomy, never indexed
        bad = base64.b64encode(art.to_bytes()[:100]).decode()
        status, body, _ = c.publish(bad)
        assert status == 503
        assert body["error"]["code"] == "artifact_corrupt"
        c.close()


# ------------------------------------------------------------- coalescing


def test_concurrent_clients_coalesce_into_shared_flushes():
    # a wide flush window so a burst of HTTP requests lands in one
    # coalescing window; each client sends 1 row, the engine's min_bucket
    # is 8: shared flushes are the only way this stays under requests/2
    app, h = _app_and_server(max_wait_us=100_000.0)
    with app, h:
        _publish(app, _svm(0), "det")
        warm = _Client(h.host, h.port)
        warm.predict("det", _rows(0, 2))
        warm.close()
        n_clients = 12
        barrier = threading.Barrier(n_clients)
        results = [None] * n_clients

        def worker(i):
            c = _Client(h.host, h.port)
            rows = _rows(np.random.default_rng(100 + i), 1)
            barrier.wait(timeout=60)
            results[i] = c.predict("det", rows)
            c.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        _join(threads)
        assert all(r[0] == 200 for r in results)
        st = app.runtime.stats("det")
        burst_flushes = st["flushes"] - 1  # minus the warm-up flush
        assert st["requests"] == n_clients + 1
        assert burst_flushes <= n_clients // 2, st["flushes"]
        assert st["served_requests"] == n_clients + 1


# ------------------------------------------------- overload + Retry-After


def test_overload_returns_429_with_parseable_retry_after():
    fi = FaultInjector(0, slow_step_rate=1.0, slow_step_s=0.05)
    rt = Runtime(
        engine_opts=ENGINE_OPTS,
        warmup_on_load=False,
        fault_injector=fi,
        max_queue_rows=16,
        max_wait_us=100.0,
    )
    app = create_app(rt)
    with rt, app, serve(app) as h:
        _publish(app, _svm(1), "det")
        warm = _Client(h.host, h.port)
        warm.predict("det", _rows(0, 2))
        n_clients, per_client = 10, 6
        outcomes = []
        lock = threading.Lock()

        def worker(i):
            c = _Client(h.host, h.port)
            rng = np.random.default_rng(200 + i)
            for _ in range(per_client):
                out = c.predict("det", _rows(rng, 4))
                with lock:
                    outcomes.append(out)
            c.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        _join(threads)
        ok = [o for o in outcomes if o[0] == 200]
        shed = [o for o in outcomes if o[0] == 429]
        assert len(ok) + len(shed) == n_clients * per_client
        assert shed, "burst never overloaded the bounded queue"
        for _, body, headers in shed:
            retry = headers.get("retry-after")
            assert retry is not None and int(retry) >= 1  # parseable, RFC 9110
            assert body["error"]["code"] == "overloaded"
            assert body["error"]["retry_after_s"] > 0.0
        # client-observed sheds match the runtime's own accounting
        st = rt.stats("det")
        assert st["shed_requests"] == len(shed)
        cons = rt.obs.tracer.conservation(st["digest"][:12])
        assert cons["unaccounted"] == 0, cons
        assert cons["shed"] == len(shed)
        assert cons["served"] == len(ok) + 1  # + warm-up
        warm.close()


def test_deadline_maps_to_504():
    fi = FaultInjector(0, slow_step_rate=1.0, slow_step_s=0.25)
    rt = Runtime(
        engine_opts=ENGINE_OPTS,
        warmup_on_load=False,
        fault_injector=fi,
        max_wait_us=100.0,
    )
    app = create_app(rt)
    with rt, app, serve(app) as h:
        _publish(app, _svm(1), "det")
        c = _Client(h.host, h.port)
        c.predict("det", _rows(0, 2))

        # occupy the engine with a slow flush so the deadline request
        # expires in the queue (deadlines bound queue wait, not service)
        def occupy():
            blocker = _Client(h.host, h.port)
            blocker.predict("det", _rows(2, 2))
            blocker.close()

        t = threading.Thread(target=occupy)
        t.start()
        time.sleep(0.05)  # the blocker's flush is in service
        status, body, _ = c.predict("det", _rows(1, 2), deadline_s=0.05)
        _join([t])
        assert status == 504
        assert body["error"]["code"] == "deadline_exceeded"
        c.close()


# ----------------------------------------------------------------- tenancy


def test_tenant_quota_sheds_conserve_across_all_layers():
    # rate 1e-6 rps with burst 3: exactly 3 admits, then sheds for the
    # next ~11 days, deterministic without a clock
    tenants = [
        TenantConfig(name="acme", api_key="k-acme", rate_rps=1e-6, burst=3),
        TenantConfig(name="umbrella", api_key="k-umb", rows_per_s=1e-6, row_burst=8),
    ]
    app, h = _app_and_server(tenants=tenants)
    with app, h:
        digest = _publish(app, _svm(0), "det")
        c = _Client(h.host, h.port)
        rng = np.random.default_rng(0)
        # no key / bad key: 401 before anything is accounted
        status, body, _ = c.predict("det", _rows(rng, 1))
        assert status == 401 and body["error"]["code"] == "unauthenticated"
        status, _, _ = c.predict("det", _rows(rng, 1), headers={"x-api-key": "wrong"})
        assert status == 401

        # acme: 3 request tokens, then request-rate sheds
        acme_ok = acme_shed = 0
        for _ in range(7):
            key = {"x-api-key": "k-acme"}
            status, body, headers = c.predict("det", _rows(rng, 2), headers=key)
            if status == 200:
                acme_ok += 1
            else:
                acme_shed += 1
                assert status == 429
                assert body["error"]["code"] == "tenant_quota"
                assert body["error"]["tenant"] == "acme"
                assert body["error"]["quota"] == "rate_rps"
                assert int(headers["retry-after"]) >= 1
        assert (acme_ok, acme_shed) == (3, 4)

        # umbrella: 8 row tokens, a 5-row then a 3-row pass, then shed
        umb_ok = umb_shed = 0
        for n in (5, 3, 2, 2):
            key = {"x-api-key": "k-umb"}
            status, body, _ = c.predict("det", _rows(rng, n), headers=key)
            if status == 200:
                umb_ok += 1
            else:
                umb_shed += 1
                assert body["error"]["quota"] == "rows_per_s"
        assert (umb_ok, umb_shed) == (2, 2)

        # three-way conservation: client == telemetry == spans
        client_shed = acme_shed + umb_shed
        client_ok = acme_ok + umb_ok
        st = app.runtime.stats("det")
        assert st["shed_requests"] == client_shed
        assert st["served_requests"] == client_ok
        cons = app.runtime.obs.tracer.conservation(digest[:12])
        assert cons["unaccounted"] == 0, cons
        assert cons["shed"] == client_shed
        assert cons["served"] == client_ok
        assert cons["submitted"] == client_ok + client_shed
        # the shed spans name the tenant and the quota
        sheds = app.runtime.obs.tracer.spans(digest[:12], "request.shed")
        assert sorted(s["attrs"]["tenant"] for s in sheds) == sorted(
            ["acme"] * acme_shed + ["umbrella"] * umb_shed
        )
        assert all(s["attrs"]["reason"] == "tenant_quota" for s in sheds)
        # per-tenant accounting agrees with the client too
        status, tsnap, _ = c.request("GET", "/v1/tenants")
        by_name = {t["name"]: t for t in tsnap["tenants"]}
        assert by_name["acme"]["shed"] == acme_shed
        assert by_name["acme"]["admitted"] == acme_ok
        assert by_name["umbrella"]["shed_rows"] == 4
        c.close()


def test_tenant_max_rows_is_a_400_not_a_shed():
    tenants = [TenantConfig(name="t", api_key="k", max_rows=4)]
    app, h = _app_and_server(tenants=tenants)
    with app, h:
        _publish(app, _svm(0), "det")
        c = _Client(h.host, h.port)
        status, body, _ = c.predict("det", _rows(0, 5), headers={"x-api-key": "k"})
        assert status == 400
        assert body["error"]["code"] == "invalid_request"
        assert app.runtime.stats("det")["shed_requests"] == 0
        c.close()


# --------------------------------------------------------------- hot swap


def test_alias_hot_swap_mid_traffic_routes_new_requests():
    app, h = _app_and_server(max_wait_us=500.0)
    with app, h:
        m = _svm(0)
        d1 = _publish(app, m, "det", family=maclaurin)
        art2 = fourier.compile(m)
        stop = threading.Event()
        seen, errors = [], []
        lock = threading.Lock()

        def traffic(i):
            c = _Client(h.host, h.port)
            rng = np.random.default_rng(300 + i)
            while not stop.is_set():
                status, body, _ = c.predict("det", _rows(rng, 2))
                with lock:
                    if status == 200:
                        seen.append(body["digest"])
                    else:
                        errors.append((status, body))
            c.close()

        threads = [threading.Thread(target=traffic, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        admin = _Client(h.host, h.port)

        def wait_for(count, timeout=60.0):
            t0 = time.monotonic()
            while time.monotonic() - t0 < timeout:
                with lock:
                    if len(seen) >= count or errors:
                        return
                time.sleep(0.005)
            raise AssertionError(f"traffic stalled below {count} responses")

        try:
            wait_for(8)  # live old-digest traffic first
            payload = base64.b64encode(art2.to_bytes()).decode()
            status, body, _ = admin.publish(payload, alias="det")
            assert status == 201
            d2 = body["digest"]
            assert d2 != d1
            # every new request routes to the new digest
            with lock:
                after_flip = len(seen)
            wait_for(after_flip + 8)
        finally:
            stop.set()
            _join(threads)
        assert not errors, errors[:3]
        assert set(seen) == {d1, d2}  # both digests served, no third
        assert all(d == d2 for d in seen[-4:]), "new requests still on old digest"
        admin.close()


# -------------------------------------------------------------- management


def test_evict_replicas_and_stats_routes():
    app, h = _app_and_server()
    with app, h:
        digest = _publish(app, _svm(0), "det")
        c = _Client(h.host, h.port)
        rng = np.random.default_rng(0)
        c.predict("det", _rows(rng, 2))

        status, body, _ = c.request("POST", "/v1/models/det:replicas", {"replicas": 2})
        assert status == 200 and body == {"digest": digest, "replicas": 2}
        status, body, _ = c.predict("det", _rows(rng, 2))
        assert status == 200  # rescale is a live operation

        status, body, _ = c.request("POST", "/v1/models/det:evict", None)
        assert status == 200 and body["evicted"]
        status, listing, _ = c.request("GET", "/v1/models")
        assert listing["models"][0]["loaded"] is False
        status, body, _ = c.predict("det", _rows(rng, 2))
        assert status == 200  # transparent rebuild

        status, body, _ = c.request("POST", "/v1/models/det:alias", {"alias": "prod"})
        assert status == 200 and body["digest"] == digest
        status, st, _ = c.request("GET", "/v1/models/det/stats")
        assert status == 200 and st["digest"] == digest
        assert st["served_requests"] >= 3
        status, st, _ = c.request("GET", "/v1/stats")
        assert status == 200 and digest[:12] in st["models"]
        c.close()


# ----------------------------------------------------------------- metrics


_PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")


def test_metrics_endpoint_parses_as_prometheus_text():
    app, h = _app_and_server()
    with app, h:
        _publish(app, _svm(0), "det")
        c = _Client(h.host, h.port)
        c.predict("det", _rows(0, 3))
        status, raw, headers = c.request("GET", "/metrics")
        assert status == 200
        assert headers["content-type"].startswith("text/plain")
        text = raw.decode() if isinstance(raw, bytes) else raw
        assert text == app.runtime.render_prometheus()  # served verbatim
        names = set()
        for line in text.strip().splitlines():
            if line.startswith("# HELP") or line.startswith("# TYPE"):
                assert len(line.split(None, 3)) >= 3
                continue
            assert _PROM_LINE.match(line), line
            names.add(line.split("{")[0].split(" ")[0])
        assert any(n.startswith("repro_serve_") for n in names)
        c.close()


# ------------------------------------------------- parity with repro's server


PARITY_CELLS = [
    ("maclaurin", "float32", {}),
    ("maclaurin", "int8", {}),
    ("fourier", "float32", {"num_features": 200}),
]


@pytest.mark.parametrize("family,dtype,opts", PARITY_CELLS)
def test_parity_same_bytes_same_digest_and_answers(family, dtype, opts):
    """One ``repro``-compiled artifact's bytes POSTed to both packages'
    servers: the same digest, and ``:predict`` answers that agree (scores
    within the families' twin tolerance, rtol 2e-4 and atol 2e-4
    max|score|; ``valid``, ``labels``, ``family`` and ``dtype`` equal),
    rows out of the envelope included (no exact model crosses the wire,
    so those come back unpatched in both)."""
    X, ay, _, gamma = _arrays(9, d=10, n_sv=60)
    rng = np.random.default_rng(9)
    ay = rng.standard_normal((3, 60)).astype(np.float32) * 0.5
    b = (0.1 * rng.standard_normal(3)).astype(np.float32)
    jm = JSVM(
        X=jnp.asarray(X),
        alpha_y=jnp.asarray(ay),
        b=jnp.asarray(b),
        gamma=jnp.float32(gamma),
    )
    raw = j_get_family(family).compile(jm, dtype=dtype, **opts).to_bytes()
    payload = base64.b64encode(raw).decode()
    requests = []
    for n in (1, 5, 12):
        Z = rng.standard_normal((n, 10)) * 0.4
        Z[::3] *= 25.0  # outside the Eq 3.11 envelope
        requests.append(Z.tolist())
    answers = []
    j_app = j_create_app(engine_opts=J_ENGINE_OPTS, warmup_on_load=False)
    t_app = create_app(engine_opts=ENGINE_OPTS, warmup_on_load=False)
    with j_app, t_app, j_serve(j_app) as jh, serve(t_app) as th:
        for h in (jh, th):
            c = _Client(h.host, h.port)
            status, body, _ = c.publish(payload, alias="m")
            assert status == 201, body
            got = [body["digest"]]
            for rows in requests:
                status, body, _ = c.predict("m", rows)
                assert status == 200, body
                got.append(body)
            answers.append(got)
            c.close()
    (j_digest, *j_bodies), (t_digest, *t_bodies) = answers
    assert t_digest == j_digest
    saw_invalid = False
    for jb, tb in zip(j_bodies, t_bodies):
        want = np.asarray(jb["scores"], np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        got = np.asarray(tb["scores"], np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * scale)
        for key in ("digest", "family", "dtype", "n", "valid", "labels"):
            assert tb[key] == jb[key], key
        saw_invalid |= not all(tb["valid"])
    assert tb["family"] == family and tb["dtype"] == dtype
    assert saw_invalid == (family == "maclaurin")
