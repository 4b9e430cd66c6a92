"""``Runtime`` — the multi-tenant serving front door.

One object per server process:

    rt = Runtime(memory_budget_bytes=256 << 20)
    rt.publish("detector", artifact, PublishSpec(exact=svm))
    fut = rt.submit("detector", Z)                   # async, coalesced
    values = fut.result().values                     # one shared host sync

``submit(model, Z)`` resolves ``model`` through the ``ArtifactRegistry``
(digest, alias, ``name@latest``, digest prefix), lazily builds + warms
the model's ``SVMEngine``, and enqueues the rows on that model's
``MicroBatcher``. Because batchers are keyed on the immutable DIGEST,
alias hot-swaps compose naturally: after ``publish`` flips an alias,
new submits route to the new digest's batcher while requests already
queued on the old digest drain on the old engine — no lock spans a
batch, nothing is torn.

``predict`` is the synchronous convenience (submit + materialize), and
``stats()`` exports the whole telemetry tree: per-model scheduler +
engine counters, plus the registry's load/eviction/alias state.

Robustness knobs (all per-runtime, applied to every model's batcher):

  * ``max_queue_rows`` — admission bound per model; a submit that would
    overflow the queue raises ``RuntimeOverloaded(retry_after_s=...)``
    instead of queueing unboundedly (bounded queue ⇒ bounded latency
    for everything that IS admitted).
  * ``default_deadline_s`` / ``submit(..., deadline_s=...)`` — per-
    request deadline; an admitted request that cannot reach a flush in
    time fails its future with ``DeadlineExceeded``.
  * ``breaker`` — per-model circuit breaker config (``True`` default,
    ``False`` off, or a kwargs dict for ``CircuitBreaker``). While open,
    traffic degrades to the exact streaming ``rbf_pred`` path when the
    model was published with ``exact=``, or is shed otherwise.
  * ``fault_injector`` — one ``FaultInjector`` threaded through both
    the batchers (``engine_step`` site) and the registry
    (``registry_load`` site) for deterministic chaos testing.

Traffic listeners (``add_traffic_listener``) observe every submitted
batch — the hook the ``DriftGuard`` reservoir-samples from to get a
recompile dataset that reflects CURRENT traffic, not compile-time
assumptions.

Observability: every runtime owns an ``obs.Observability``
(``obs=False`` disables, an explicit instance isolates). Request
lifecycle spans are recorded by the batchers under each model's digest
prefix; ``ModelTelemetry`` counters mirror onto the bundle's metrics
registry labelled (model_digest, alias, family, dtype);
``render_prometheus()`` exposes them as Prometheus text; and
``profile(model, Z, path)`` writes a ``torch.profiler`` Chrome trace of
one coalesced step.
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.families import CompiledArtifact
from repro_torch.serve.runtime.errors import BatcherClosed
from repro_torch.serve.runtime.faults import FaultInjector
from repro_torch.serve.runtime.obs import Observability
from repro_torch.serve.runtime.obs import profile as obs_profile
from repro_torch.serve.runtime.publish import PublishSpec, resolve_spec
from repro_torch.serve.runtime.registry import ArtifactRegistry
from repro_torch.serve.runtime.scheduler import DEFAULT_MAX_WAIT_US, MicroBatcher
from repro_torch.serve.runtime.telemetry import ModelTelemetry


class Runtime:
    def __init__(
        self,
        registry: ArtifactRegistry | None = None,
        *,
        max_wait_us: float = DEFAULT_MAX_WAIT_US,
        flush_rows: int | None = None,
        memory_budget_bytes: int | None = None,
        warmup_on_load: bool = True,
        engine_opts: dict | None = None,
        max_queue_rows: int | None = None,
        default_deadline_s: float | None = None,
        breaker=True,
        fault_injector: FaultInjector | None = None,
        obs=None,
    ):
        # obs=None -> own bundle on the process default metrics registry;
        # obs=False -> observability off (no spans, no metric mirroring);
        # an Observability instance -> use it (isolated registries/tracers)
        if obs is None:
            obs = Observability()
        self.obs: Observability | None = obs or None
        if registry is None:
            registry = ArtifactRegistry(
                memory_budget_bytes=memory_budget_bytes,
                warmup_on_load=warmup_on_load,
                engine_opts=engine_opts,
                fault_injector=fault_injector,
                obs=self.obs,
            )
        elif getattr(registry, "obs", None) is None and self.obs is not None:
            registry.obs = self.obs
        self.registry = registry
        self.max_wait_us = max_wait_us
        self.flush_rows = flush_rows
        self.max_queue_rows = max_queue_rows
        self.default_deadline_s = default_deadline_s
        self.breaker = breaker
        self.faults = fault_injector
        self._batchers: dict[str, MicroBatcher] = {}
        self._telemetry: dict[str, ModelTelemetry] = {}
        self._traffic_listeners: list = []
        self._lock = threading.Lock()
        self._closed = False
        # an idle batcher pins its engine; retire it on eviction so the
        # registry's memory budget actually frees the engine's arrays
        self.registry.add_evict_listener(self._on_evict)

    # ------------------------------------------------------------ publishing

    def publish(self, alias: str, artifact: CompiledArtifact,
                spec: PublishSpec | None = None, *, exact=None,
                replicas: int | None = None) -> str:
        """Register ``artifact`` and atomically point ``alias`` at it.

        Options travel in one ``PublishSpec`` (``spec=PublishSpec(
        replicas=2, warmup=True)``) — the same shape the HTTP management
        API serializes; the bare ``exact=``/``replicas=`` kwargs are
        deprecated-but-accepted for one release.

        ``replicas=N`` scales the model out over N engines (pinned
        round-robin across local devices); the model's batcher then
        routes each flush to the least-loaded replica. ``None`` keeps
        the current count (default 1).
        """
        spec = resolve_spec(spec, caller="Runtime.publish",
                            exact=exact, replicas=replicas)
        return self.registry.publish(alias, artifact, spec)

    def register(self, artifact: CompiledArtifact,
                 spec: PublishSpec | None = None, **kw) -> str:
        return self.registry.register(artifact, spec, **kw)

    def load_directory(self, dirpath: str, **kw) -> dict[str, str]:
        return self.registry.add_directory(dirpath, **kw)

    def set_alias(self, alias: str, ref: str) -> str:
        return self.registry.set_alias(alias, ref)

    # --------------------------------------------------------------- serving

    def _batcher(self, digest: str, engines: list) -> MicroBatcher:
        engine = engines[0]
        b = self._batchers.get(digest)
        if b is not None and b.engine is engine:
            return b
        stale = None
        with self._lock:
            if self._closed:
                raise RuntimeError("Runtime is closed")
            b = self._batchers.get(digest)
            if b is None or b.engine is not engine:
                # first use, or the registry evicted + rebuilt this model's
                # engines (including a replica-count change, which swaps
                # the whole replica set atomically): retire the old
                # batcher (it drains in-flight work on the old engines)
                # and route new traffic to the fresh ones.
                stale = b
                tel = self._telemetry.setdefault(digest, ModelTelemetry())
                if self.obs is not None:
                    tel.bind_obs(self.obs.metrics, self._labels(digest, engine))
                b = MicroBatcher(
                    engine,
                    max_wait_us=self.max_wait_us,
                    flush_rows=self.flush_rows,
                    telemetry=tel,
                    name=digest[:12],
                    max_queue_rows=self.max_queue_rows,
                    breaker=self.breaker,
                    fault_injector=self.faults,
                    engines=engines,
                    tracer=self.obs.tracer if self.obs is not None else None,
                )
                self._batchers[digest] = b
        if stale is not None:
            stale.close()
        return b

    def _labels(self, digest: str, engine) -> dict:
        """Metric label set for one served digest: digest prefix, the
        alias currently pointing at it (first match; "" if served by
        digest only), and the engine's family/dtype dimensions."""
        alias = ""
        for a, d in self.registry.aliases().items():
            if d == digest:
                alias = a
                break
        return {
            "model_digest": digest[:12],
            "alias": alias,
            "family": getattr(engine, "family", ""),
            "dtype": getattr(engine, "dtype", ""),
        }

    def _on_evict(self, digest: str) -> None:
        """Registry evicted ``digest``'s engine: retire its batcher (the
        close drains in-flight work on the old engine first, and resolves
        every still-pending future — eviction never strands a caller)."""
        with self._lock:
            b = self._batchers.pop(digest, None)
        if b is not None:
            b.close()

    def add_traffic_listener(self, fn) -> None:
        """``fn(model_ref, digest, Z)`` observes every submitted batch
        AFTER admission (shed requests are not traffic). Listener errors
        propagate to the submitter — keep listeners trivial (the
        ``DriftGuard`` reservoir offer is an O(rows) numpy copy)."""
        self._traffic_listeners.append(fn)

    def submit(self, model: str, Z, *, deadline_s: float | None = None):
        """Async scoring: ``Future[SliceResult]`` for ``Z`` on ``model``.

        Raises ``RuntimeOverloaded`` when admission sheds, and the
        future fails with ``DeadlineExceeded`` when ``deadline_s`` (or
        the runtime's ``default_deadline_s``) expires before service.
        """
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        while True:
            digest, engines = self.registry.get_engines(model)
            try:
                fut = self._batcher(digest, engines).submit(
                    Z, deadline_s=deadline_s
                )
            except BatcherClosed:
                # the batcher was retired between lookup and submit (engine
                # evicted + reloaded under us); re-resolve onto the fresh one
                continue
            for fn in self._traffic_listeners:
                fn(model, digest, Z)
            return fut

    def predict(self, model: str, Z) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous convenience: (values, valid) like ``SVMEngine.predict``."""
        res = self.submit(model, Z).result()
        return res.values, res.valid

    def warmup(self, model: str) -> int:
        """Force-load + warm ``model`` now; returns its compiled variants."""
        _, engine = self.registry.get_engine(model)
        if not self.registry.warmup_on_load:
            engine.warmup()  # registry didn't warm at load time
        return engine.jit_cache_size()

    # ------------------------------------------------------------- telemetry

    def telemetry(self, model: str) -> ModelTelemetry:
        """The live ``ModelTelemetry`` for ``model``'s current digest
        (created if the model has not served yet) — what ``DriftGuard``
        reads its fallback window from and records canary verdicts on."""
        digest = self.registry.resolve(model)
        with self._lock:
            return self._telemetry.setdefault(digest, ModelTelemetry())

    def stats(self, model: str | None = None) -> dict:
        """Telemetry snapshot: one model's, or the whole runtime tree."""
        if model is not None:
            digest = self.registry.resolve(model)
            tel = self._telemetry.get(digest)
            batcher = self._batchers.get(digest)
            if batcher is not None:
                engine = batcher.engine  # the engine traffic actually hits
            else:
                entry = self.registry._entries.get(digest)
                engine = entry.engine if entry is not None else None
            if tel is None:
                tel = ModelTelemetry()  # zeroed snapshot pre-traffic
            out = tel.snapshot(engine)
            out["digest"] = digest
            if batcher is not None and batcher.breaker is not None:
                out["breaker"]["config"] = batcher.breaker.snapshot()
                # live per-replica circuits (telemetry's "replicas" block
                # holds the counters; this is current state + config)
                out["breaker"]["per_replica"] = [
                    r.breaker.snapshot() if r.breaker is not None else None
                    for r in batcher.replicas
                ]
            entry = self.registry._entries.get(digest)
            if entry is not None:
                out["evictions"] = entry.evictions
                out["quarantined"] = entry.quarantined
            return out
        with self._lock:
            digests = list(self._telemetry)
        return {
            "registry": self.registry.snapshot(),
            "models": {d[:12]: self.stats(d) for d in digests},
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition of this runtime's metrics registry
        ("" when observability is disabled): the string an HTTP front door
        serves on ``/metrics``."""
        if self.obs is None:
            return ""
        return self.obs.render_prometheus()

    def profile(self, model: str, Z, path) -> str:
        """Capture a ``torch.profiler`` trace of ONE coalesced step.

        Warms ``model`` first so the capture shows steady-state serving
        (step dispatch + device compute), not the first use of a bucket;
        then submits ``Z`` and materializes the result inside the
        profiler session, with engine-step ranges enabled for the
        duration. The Chrome trace is written to the file ``path``
        (``obs.profile.capture``). Returns ``path``.
        """
        self.warmup(model)
        with obs_profile.capture(path):
            res = self.submit(model, Z).result()
            np.asarray(res.values)  # device -> host sync in-session
        return str(path)

    # -------------------------------------------------------------- lifetime

    def close(self) -> None:
        """Shut down every batcher; EVERY pending future resolves (with
        its result if the final flush served it, ``BatcherClosed`` if
        not) and every worker thread is joined — no caller blocked on
        ``future.result()`` survives a close un-woken."""
        with self._lock:
            self._closed = True
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
