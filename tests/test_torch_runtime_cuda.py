"""The serving runtime on the card: coalesced serving against the engine's
direct submit, the breaker's degraded rows through kernel B2, deferred
sync (``submit`` returns before the work queued ahead of it ends, and the
pinned staging buffers are never overwritten under a pending copy),
eviction releasing card memory, and a profile holding kernel B1.

Marked ``cuda``; each test skips inside its body where no card is present.
On a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_runtime_cuda.py
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core.families import maclaurin  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.serve import PublishSpec, Runtime, SVMEngine  # noqa: E402
from repro_torch.serve.runtime import ENGINE_STEP, FaultInjector  # noqa: E402

pytestmark = pytest.mark.cuda

D, K, N_SV = 64, 3, 2048
OPTS = dict(device="cuda", min_bucket=32, max_batch=1024)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(dev, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((N_SV, D)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((K, N_SV)).astype(np.float32)
    ay -= ay.mean(1, keepdims=True)
    gamma = np.float32(0.5 / (4.0 * float((X.astype(np.float64) ** 2).sum(1).max())))
    b = rng.standard_normal(K).astype(np.float32) * 0.1
    return convert.svm_from_numpy(X, ay, b, gamma, device=dev)


def _requests(seed, count, far_every=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        Z = (rng.standard_normal((int(rng.integers(1, 9)), D)) * 0.3).astype(np.float32)
        if i % far_every == 0:
            Z[0] *= 40.0  # out of the Eq 3.11 envelope: B2 on this row
        out.append(Z)
    return out


def _same(got, want):
    scale = max(1.0, float(np.abs(want.values).max()))
    np.testing.assert_allclose(got.values, want.values, rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.valid, want.valid)


def test_coalesced_serving_matches_direct_submit(cuda):
    svm = _model(cuda)
    art = maclaurin.compile(svm)
    direct = SVMEngine(art, svm, **OPTS)
    requests = _requests(1, 64)
    wants = [direct.submit(Z) for Z in requests]
    results = [None] * len(requests)
    with Runtime(max_wait_us=2_000, engine_opts=OPTS) as rt:
        rt.publish("m", art, PublishSpec(exact=svm))
        rt.warmup("m")
        engine = rt.registry.get_engine("m")[1]
        before = engine.jit_cache_size()
        build.reset_counts()

        def client(c):
            mine = range(c, len(requests), 8)
            futs = [(i, rt.submit("m", requests[i])) for i in mine]
            for i, f in futs:
                results[i] = f.result(timeout=60)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for got, want in zip(results, wants):
            _same(got, want)
        launches = build.counts()
        st = rt.stats("m")
    assert engine.jit_cache_size() == before  # no new bucket config
    assert launches["quadform_heads"] == st["flushes"] > 0
    assert launches["rbf_scores"] > 0  # the far rows' fallback
    assert st["coalescing_factor"] > 1.0


def test_breaker_degrades_through_kernel_b2(cuda):
    svm = _model(cuda, seed=1)
    fi = FaultInjector(0)
    rng = np.random.default_rng(2)
    breaker = dict(fail_threshold=3, reset_after_s=60.0)
    with Runtime(engine_opts=OPTS, fault_injector=fi, breaker=breaker) as rt:
        rt.publish("m", maclaurin.compile(svm), PublishSpec(exact=svm))
        rt.predict("m", rng.standard_normal((4, D)).astype(np.float32) * 0.3)
        fi.fail_next(ENGINE_STEP, 3)
        for _ in range(3):
            with pytest.raises(Exception):
                rt.submit("m", np.zeros((2, D), np.float32)).result(timeout=60)
        assert rt.stats("m")["breaker"]["state"] == "open"
        Z = (rng.standard_normal((20, D)) * 0.3).astype(np.float32)
        build.reset_counts()
        res = rt.submit("m", Z).result(timeout=60)
        values, valid, labels = res.values, res.valid, res.labels
        launches = build.counts()
        st = rt.stats("m")
    assert launches["rbf_scores"] >= 1 and launches["quadform_heads"] == 0
    assert not valid.any()
    Zd = torch.from_numpy(Z).to(cuda).double()
    X, A = svm.X.double(), svm.alpha_y.double()
    d2 = (Zd * Zd).sum(1)[:, None] + (X * X).sum(1)[None] - 2 * Zd @ X.T
    ref = (torch.exp(-float(svm.gamma) * d2) @ A.T + svm.b.double()).cpu().numpy()
    np.testing.assert_allclose(values, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(labels, ref.argmax(1))
    assert st["breaker"]["degraded_rows"] == 20


def test_submit_returns_before_queued_work_ends(cuda):
    svm = _model(cuda, seed=2)
    engine = SVMEngine(maclaurin.compile(svm), svm, **OPTS)
    Z = (np.random.default_rng(3).standard_normal((1024, D)) * 0.3).astype(np.float32)
    want = engine.submit(Z).values  # warm: the bucket and its staging
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(200_000_000)  # clock cycles: ~100 ms on the card
    mid.record()
    t0 = time.perf_counter()
    r = engine.submit(Z)
    host_ms = (time.perf_counter() - t0) * 1e3
    assert not mid.query()  # the queued work was still running
    torch.cuda.synchronize()
    queued_ms = start.elapsed_time(mid)
    assert host_ms < 0.5 * queued_ms, (host_ms, queued_ms)
    np.testing.assert_array_equal(r.values, want)


def test_staging_buffers_are_not_reused_under_a_pending_copy(cuda):
    svm = _model(cuda, seed=3)
    engine = SVMEngine(maclaurin.compile(svm), svm, **OPTS)
    rng = np.random.default_rng(4)
    sizes = (40, 64) * 6
    sets = [(rng.standard_normal((n, D)) * 0.3).astype(np.float32) for n in sizes]
    wants = [engine.submit(Z).values for Z in sets]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # every copy below waits behind this
    results = [engine.submit(Z) for Z in sets]  # 12 submits, 4 buffers
    for r, want in zip(results, wants):
        np.testing.assert_array_equal(r.values, want)


def test_staging_under_concurrent_submits(cuda):
    """More threads than cores submit to one engine at once, with the
    interpreter switching threads every microsecond, behind queued work:
    a staging buffer shared by two submits, or reused under a pending
    copy, would hand some thread another's rows."""
    import sys

    svm = _model(cuda, seed=8)
    engine = SVMEngine(maclaurin.compile(svm), svm, **OPTS)
    rng = np.random.default_rng(9)
    mine = [(rng.standard_normal((33, D)) * 0.3).astype(np.float32) for _ in range(16)]
    wants = [engine.submit(Z).values for Z in mine]
    wrong, lock = [], threading.Lock()

    def client(i):
        results = [engine.submit(mine[i]) for _ in range(10)]
        for r in results:
            if not np.array_equal(r.values, wants[i]):
                with lock:
                    wrong.append(i)

    torch.cuda.synchronize()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        torch.cuda._sleep(100_000_000)  # every copy waits behind this
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []


def test_eviction_releases_card_memory(cuda, tmp_path):
    svms = [_model(cuda, seed=s) for s in (5, 6)]
    paths = []
    for i, svm in enumerate(svms):
        paths.append(maclaurin.compile(svm).save(str(tmp_path / f"m{i}.npz")))
    with Runtime(engine_opts=OPTS, warmup_on_load=False) as rt:
        for i, path in enumerate(paths):
            rt.registry.add_file(path, alias=f"m{i}@latest")
        Z = np.zeros((4, D), np.float32)
        rt.predict("m0", Z)
        rt.predict("m1", Z)
        torch.cuda.synchronize()
        loaded = torch.cuda.memory_allocated()
        rt.registry.evict("m0")
        torch.cuda.synchronize()
        freed = loaded - torch.cuda.memory_allocated()
        assert freed >= maclaurin.compile(svms[0]).nbytes()  # its engine's arrays
        rt.predict("m0", Z)  # reloads from its file


def test_server_over_a_cuda_runtime_answers_as_direct_submits(cuda):
    """The HTTP front door over a runtime on the card: an f32 artifact
    published in process with its exact model (fallback rows through B2)
    and its int8 twin published over the wire (B3, no exact model), each
    request's answer equal to its artifact's direct submit."""
    import base64
    import http.client

    from repro_torch.serve import create_app, serve

    svm = _model(cuda, seed=3)
    f32 = maclaurin.compile(svm)
    q8 = maclaurin.quantize_quadform_artifact(f32)
    direct = {"f32": SVMEngine(f32, svm, **OPTS), "q8": SVMEngine(q8, None, **OPTS)}
    requests = _requests(4, 24)
    build.reset_counts()
    rt = Runtime(max_wait_us=2_000, engine_opts=OPTS)
    app = create_app(runtime=rt)
    handle = serve(app)
    try:
        rt.publish("f32", f32.to("cpu"), PublishSpec(exact=svm))
        conn = http.client.HTTPConnection(handle.host, handle.port, timeout=60)

        def post(path, body):
            conn.request("POST", path, body=json.dumps(body).encode())
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())

        payload = base64.b64encode(q8.to_bytes()).decode()
        spec = {"alias": "q8"}
        status, body = post("/v1/models", {"artifact_b64": payload, "spec": spec})
        assert status == 201 and body["digest"] == q8.digest()
        for alias, engine in direct.items():
            for Z in requests:
                status, body = post(f"/v1/models/{alias}:predict", {"rows": Z.tolist()})
                assert status == 200, body
                want = engine.submit(Z)
                got = np.asarray(body["scores"], np.float32)
                scale = max(1.0, float(np.abs(want.values).max()))
                np.testing.assert_allclose(
                    got, want.values, rtol=2e-4, atol=2e-4 * scale
                )
                assert body["labels"] == want.labels.tolist()
                assert body["valid"] == want.valid.tolist()
                assert body["dtype"] == engine.dtype
        conn.close()
    finally:
        handle.close()
        rt.close()
    counts = build.counts()
    for name in ("quadform_heads", "quadform_heads_q8", "rbf_scores"):
        assert counts[name] > 0, name


def test_profile_holds_the_step_range_and_kernel_b1(cuda, tmp_path):
    """Last in this file: ``torch.profiler`` slows every later launch of
    its process."""
    svm = _model(cuda, seed=7)
    path = tmp_path / "step.json"
    with Runtime(engine_opts=OPTS) as rt:
        rt.publish("m", maclaurin.compile(svm), PublishSpec(exact=svm))
        rt.profile("m", np.zeros((5, D), np.float32), path)
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert "svm_engine.step/maclaurin/b32" in names
    assert any("quadform_tf32<float" in n for n in names)
