"""Per-model serving telemetry for the multi-tenant runtime.

One ``ModelTelemetry`` per served digest, fed by the micro-batcher
(enqueue / flush / materialize events) and merged with the engine's own
``EngineStats.snapshot()`` when exported. Everything is lock-guarded —
the writers are N client threads plus the flush thread.

The exported snapshot answers the operational questions of a service
under heavy traffic:

  * **p50 / p99 latency** — end-to-end per request: enqueue into the
    scheduler queue → the coalesced result's host materialization. A
    bounded ring buffer (default 4096 samples) keeps the percentile
    memory constant under unbounded traffic.
  * **queue depth** — current and high-water pending rows, the signal
    that a model needs a bigger flush target (or more capacity).
  * **coalescing factor** — requests per engine step; 1.0 means the
    scheduler is adding latency without amortizing anything, ≫1 is the
    micro-batching win.
  * **fallback rate / compile count** — straight from the engine's
    thread-safe stats (accuracy-contract violations, trace activity).
  * **evictions / loads** — registry-level counters (cold-model churn).

Robustness counters (every failure mode the overload/fault/drift layer
can produce is observable — nothing sheds or fails silently):

  * **shed_requests / shed_rows** — rejected by admission control
    (bounded queue) with ``RuntimeOverloaded``;
  * **deadline_timeouts** — admitted requests failed with
    ``DeadlineExceeded`` because their per-submit deadline expired
    before a flush could include them;
  * **batch_failures / failed_requests / failed_rows** — engine-step
    exceptions scattered to exactly the affected batch's futures;
  * **tightened_waits** — flushes whose ``max_wait_us`` was shortened
    by queue pressure (the SLO-aware knob engaging);
  * **breaker** — current circuit state plus trip/probe counters,
    ``degraded_*`` accounting for batches served by the exact
    ``rbf_pred`` path while the breaker holds the fast path open, and
    ``breaker_shed_requests`` for open-breaker sheds when no exact
    model was published;
  * **canary / recompiles** — the ``DriftGuard`` self-healing loop's
    verdicts (recompiles triggered, canaries passed/failed);
  * **replicas** — per-replica flush/row/failure counters plus each
    replica's last observed breaker state: the scale-out dispatcher's
    observability (is load actually spreading? which replica is the
    one tripping?). The model-level ``breaker.state`` keeps its
    single-replica meaning and mirrors the most recent transition of
    ANY replica — per-replica truth lives here;
  * **fallback_window** — a bounded window of recent per-row validity
    (fast-path batches only), the drift signal ``DriftGuard`` watches:
    the LIFETIME fallback rate of a long-lived model dilutes a sudden
    input shift, the windowed rate does not.

Observability binding: ``bind_obs(registry, labels)`` mirrors
every ``record_*`` call onto typed instruments in an
``obs.MetricsRegistry`` — counters for the full request-accounting
identity (served + failed + expired + breaker-shed + closed ==
admitted), gauges for queue depth, the §4 validity fraction /
windowed fallback rate, the EWMA step time, and per-replica breaker
state, and a latency histogram — dimensioned by (model_digest, alias,
family, dtype) plus replica/bucket/verdict where they apply. The
snapshot dict stays the source of truth for tests; the registry is
the Prometheus-facing projection of the SAME call sites, so the
conservation identity cannot diverge between the two.
"""

from __future__ import annotations

import collections
import math
import threading

DEFAULT_WINDOW = 4096
DEFAULT_VALIDITY_WINDOW = 256  # recent flushes tracked for drift
HEAL_HISTORY = 32  # DriftGuard heal verdicts retained

BREAKER_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


def _nearest_rank(sorted_samples: list, pct: float) -> float:
    """Nearest-rank percentile: the ceil(p/100 * n)-th smallest sample.

    Always an OBSERVED sample — no interpolation — so low-traffic
    dashboard gauges step between real latencies instead of jittering
    through synthetic in-between values (n=1 returns that sample for
    every percentile; n=2 puts p50 on the 1st and p99 on the 2nd).
    """
    n = len(sorted_samples)
    idx = max(0, math.ceil((pct / 100.0) * n) - 1)
    return sorted_samples[min(idx, n - 1)]


class LatencyWindow:
    """Bounded sample window with percentile export (thread-safe)."""

    def __init__(self, maxlen: int = DEFAULT_WINDOW):
        self._samples = collections.deque(maxlen=maxlen)
        self._count = 0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            samples = sorted(self._samples)
            total = self._count
        if not samples:
            return {"n": 0, "p50_ms": None, "p99_ms": None}
        return {
            "n": total,  # recorded ever; window may be smaller
            "p50_ms": round(_nearest_rank(samples, 50) * 1e3, 4),
            "p99_ms": round(_nearest_rank(samples, 99) * 1e3, 4),
        }


class _BoundMetrics:
    """Typed-instrument projection of one model's telemetry.

    Holds the pre-resolved children for the base label set
    (model_digest, alias, family, dtype) plus family handles for the
    metrics that carry extra labels (replica, bucket, verdict,
    outcome). Created by ``ModelTelemetry.bind_obs``; every record_*
    site then feeds both the snapshot counters and these instruments.
    """

    BASE_LABELS = ("model_digest", "alias", "family", "dtype")

    def __init__(self, registry, labels: dict):
        self.registry = registry
        base = {k: str(labels.get(k, "")) for k in self.BASE_LABELS}
        self.base = base
        L = self.BASE_LABELS
        c, g, h = registry.counter, registry.gauge, registry.histogram

        def _c(name, help_text, extra=()):
            return c(name, help_text, L + tuple(extra))

        self.requests = _c(
            "repro_serve_requests_total", "Requests admitted to the queue."
        ).labels(**base)
        self.rows = _c(
            "repro_serve_rows_total", "Rows admitted to the queue."
        ).labels(**base)
        self.shed = _c(
            "repro_serve_shed_requests_total",
            "Requests rejected at admission (bounded queue).",
        ).labels(**base)
        self.served = _c(
            "repro_serve_served_requests_total",
            "Requests whose future resolved with scores.",
        ).labels(**base)
        self.served_rows = _c(
            "repro_serve_served_rows_total", "Rows scored and scattered back."
        ).labels(**base)
        self.failed = _c(
            "repro_serve_failed_requests_total",
            "Requests failed by an engine-step exception.",
        ).labels(**base)
        self.expired = _c(
            "repro_serve_deadline_timeouts_total",
            "Admitted requests expired before a flush included them.",
        ).labels(**base)
        self.closed = _c(
            "repro_serve_closed_requests_total",
            "Admitted requests failed because the batcher closed.",
        ).labels(**base)
        self.breaker_shed = _c(
            "repro_serve_breaker_shed_requests_total",
            "Requests shed under an open breaker with no exact fallback.",
        ).labels(**base)
        self.degraded = _c(
            "repro_serve_degraded_requests_total",
            "Requests served by the exact path under an open breaker.",
        ).labels(**base)
        self.flushes = _c(
            "repro_serve_flushes_total", "Coalesced engine flushes."
        ).labels(**base)
        self.batch_failures = _c(
            "repro_serve_batch_failures_total", "Engine flushes that raised."
        ).labels(**base)
        self.recompiles = _c(
            "repro_serve_recompiles_total", "DriftGuard recompiles triggered."
        ).labels(**base)
        self._canary = _c(
            "repro_serve_canary_total",
            "DriftGuard canary verdicts.",
            ("verdict",),
        )
        self._heals = _c(
            "repro_serve_heals_total",
            "DriftGuard heal attempts by outcome.",
            ("outcome",),
        )
        self._replica_flushes = _c(
            "repro_serve_replica_flushes_total",
            "Fast-path flushes per replica and shape bucket.",
            ("replica", "bucket"),
        )
        self._replica_failures = _c(
            "repro_serve_replica_failures_total",
            "Failed fast-path flushes per replica.",
            ("replica",),
        )
        self.queue_rows = g(
            "repro_serve_queue_rows", "Rows currently pending in the queue.", L
        ).labels(**base)
        self.validity_fraction = g(
            "repro_serve_validity_fraction",
            "Windowed fraction of fast-path rows inside the Eq 3.11 bound.",
            L,
        ).labels(**base)
        self.fallback_rate = g(
            "repro_serve_fallback_rate",
            "Windowed fraction of fast-path rows re-scored exactly.",
            L,
        ).labels(**base)
        self.step_time_ewma = g(
            "repro_serve_step_time_ewma_seconds",
            "EWMA of coalesced engine step wall time.",
            L,
        ).labels(**base)
        self._breaker_state = g(
            "repro_serve_breaker_state",
            "Per-replica breaker state (0=closed, 1=half_open, 2=open).",
            L + ("replica",),
        )
        self.latency = h(
            "repro_serve_request_latency_seconds",
            "End-to-end request latency (enqueue to materialize).",
            L,
        ).labels(**base)

    def canary(self, verdict: str):
        return self._canary.labels(**self.base, verdict=verdict)

    def heals(self, outcome: str):
        return self._heals.labels(**self.base, outcome=outcome)

    def replica_flushes(self, replica, bucket):
        return self._replica_flushes.labels(
            **self.base, replica=str(replica), bucket=str(bucket)
        )

    def replica_failures(self, replica):
        return self._replica_failures.labels(**self.base, replica=str(replica))

    def breaker_state(self, replica):
        return self._breaker_state.labels(**self.base, replica=str(replica))


class ModelTelemetry:
    """Counters + latency window for one served model (one digest)."""

    def __init__(self, window: int = DEFAULT_WINDOW,
                 validity_window: int = DEFAULT_VALIDITY_WINDOW):
        self.latency = LatencyWindow(window)
        self._lock = threading.Lock()
        self._requests = 0
        self._rows = 0
        self._flushes = 0
        self._deadline_flushes = 0  # flushed because max_wait_us expired
        self._queue_rows = 0  # rows currently pending
        self._max_queue_rows = 0
        # -- admission / deadline / failure accounting
        self._shed_requests = 0
        self._shed_rows = 0
        self._deadline_timeouts = 0
        self._batch_failures = 0
        self._failed_requests = 0
        self._failed_rows = 0
        self._tightened_waits = 0
        # -- circuit breaker / degraded serving
        self._breaker_state = "closed"
        self._breaker_trips = 0
        self._breaker_probes = 0
        self._degraded_flushes = 0
        self._degraded_requests = 0
        self._degraded_rows = 0
        self._breaker_shed_requests = 0
        # -- self-healing loop
        self._recompiles = 0
        self._canary_pass = 0
        self._canary_fail = 0
        self._heal_attempts = 0
        self._last_heal_trigger_at = None
        self._flipped_digests: list[str] = []
        self._heal_history = collections.deque(maxlen=HEAL_HISTORY)
        # -- terminal accounting (conservation: served + failed + expired
        #    + breaker_shed + closed == requests once drained)
        self._served_requests = 0
        self._served_rows = 0
        self._closed_requests = 0
        # -- EWMA engine step time (mirrored from the scheduler)
        self._step_time_ewma = None
        # -- drift signal: (rows, invalid_rows) per recent fast-path flush
        self._validity = collections.deque(maxlen=validity_window)
        # -- per-replica dispatch accounting (scale-out)
        self._replicas: dict[int, dict] = {}
        # -- typed-metrics projection (None until bind_obs)
        self._obs: _BoundMetrics | None = None

    def bind_obs(self, registry, labels: dict | None = None) -> None:
        """Mirror every future ``record_*`` onto typed instruments in
        ``registry`` (an ``obs.MetricsRegistry``), labelled by the given
        (model_digest, alias, family, dtype). Idempotent for the same
        registry; rebinding to a different registry replaces the mirror.
        """
        with self._lock:
            if self._obs is not None and self._obs.registry is registry:
                return
            self._obs = _BoundMetrics(registry, labels or {})

    # ------------------------------------------------------------- recording

    def record_enqueue(self, rows: int) -> None:
        with self._lock:
            self._requests += 1
            self._rows += rows
            self._queue_rows += rows
            self._max_queue_rows = max(self._max_queue_rows, self._queue_rows)
            depth = self._queue_rows
        m = self._obs
        if m is not None:
            m.requests.inc()
            m.rows.inc(rows)
            m.queue_rows.set(depth)

    def record_flush(self, requests: int, rows: int, *, deadline: bool,
                     tightened: bool = False) -> None:
        with self._lock:
            self._flushes += 1
            self._deadline_flushes += int(deadline)
            self._tightened_waits += int(tightened)
            self._queue_rows -= rows
            depth = self._queue_rows
        m = self._obs
        if m is not None:
            m.flushes.inc()
            m.queue_rows.set(depth)

    def record_latency(self, seconds: float) -> None:
        self.latency.record(seconds)
        m = self._obs
        if m is not None:
            m.latency.observe(seconds)

    def record_shed(self, rows: int) -> None:
        """Request rejected at admission (never entered the queue)."""
        with self._lock:
            self._shed_requests += 1
            self._shed_rows += rows
        m = self._obs
        if m is not None:
            m.shed.inc()

    def record_served(self, requests: int, rows: int) -> None:
        """Requests whose futures resolved with scores (fast OR degraded
        path) — the success leg of the conservation identity."""
        with self._lock:
            self._served_requests += requests
            self._served_rows += rows
        m = self._obs
        if m is not None:
            m.served.inc(requests)
            m.served_rows.inc(rows)

    def record_closed(self, requests: int, rows: int = 0) -> None:
        """Admitted requests failed because the batcher shut down."""
        with self._lock:
            self._closed_requests += requests
            self._queue_rows -= rows
            depth = self._queue_rows
        m = self._obs
        if m is not None:
            m.closed.inc(requests)
            m.queue_rows.set(depth)

    def record_step_time(self, seconds: float) -> None:
        """Mirror the scheduler's EWMA engine-step time estimate."""
        with self._lock:
            self._step_time_ewma = float(seconds)
        m = self._obs
        if m is not None:
            m.step_time_ewma.set(seconds)

    def record_deadline_timeout(self, requests: int = 1, rows: int = 0) -> None:
        """Admitted requests expired while queued (left without a flush)."""
        with self._lock:
            self._deadline_timeouts += requests
            self._queue_rows -= rows
            depth = self._queue_rows
        m = self._obs
        if m is not None:
            m.expired.inc(requests)
            m.queue_rows.set(depth)

    def record_batch_failure(self, requests: int, rows: int) -> None:
        """One engine step failed; its futures got the exception."""
        with self._lock:
            self._batch_failures += 1
            self._failed_requests += requests
            self._failed_rows += rows
        m = self._obs
        if m is not None:
            m.batch_failures.inc()
            m.failed.inc(requests)

    def _replica_locked(self, index: int) -> dict:
        return self._replicas.setdefault(int(index), {
            "flushes": 0,
            "requests": 0,
            "rows": 0,
            "failures": 0,
            "breaker_state": "closed",
            "trips": 0,
            "probes": 0,
        })

    def record_replica_flush(self, index: int, requests: int, rows: int,
                             bucket: int | None = None) -> None:
        """One fast-path flush served by replica ``index`` (``bucket`` is
        the padded shape bucket it dispatched into, when known)."""
        with self._lock:
            c = self._replica_locked(index)
            c["flushes"] += 1
            c["requests"] += requests
            c["rows"] += rows
        m = self._obs
        if m is not None:
            m.replica_flushes(index, bucket if bucket is not None else "").inc()

    def record_replica_failure(self, index: int) -> None:
        """One fast-path flush FAILED on replica ``index``."""
        with self._lock:
            self._replica_locked(index)["failures"] += 1
        m = self._obs
        if m is not None:
            m.replica_failures(index).inc()

    def record_breaker_state(self, state: str, *, tripped: bool = False,
                             probe: bool = False, replica: int = 0) -> None:
        with self._lock:
            # model-level state keeps its pre-replica meaning: the most
            # recent transition anywhere (exact for a single replica)
            self._breaker_state = state
            self._breaker_trips += int(tripped)
            self._breaker_probes += int(probe)
            c = self._replica_locked(replica)
            c["breaker_state"] = state
            c["trips"] += int(tripped)
            c["probes"] += int(probe)
        m = self._obs
        if m is not None:
            m.breaker_state(replica).set(BREAKER_STATE_VALUES.get(state, -1))

    def record_degraded(self, requests: int, rows: int) -> None:
        """One flush served by the exact path under an open breaker."""
        with self._lock:
            self._degraded_flushes += 1
            self._degraded_requests += requests
            self._degraded_rows += rows
        m = self._obs
        if m is not None:
            m.degraded.inc(requests)

    def record_breaker_shed(self, requests: int = 1) -> None:
        with self._lock:
            self._breaker_shed_requests += requests
        m = self._obs
        if m is not None:
            m.breaker_shed.inc(requests)

    def record_recompile(self) -> None:
        with self._lock:
            self._recompiles += 1
        m = self._obs
        if m is not None:
            m.recompiles.inc()

    def record_canary(self, passed: bool) -> None:
        with self._lock:
            if passed:
                self._canary_pass += 1
            else:
                self._canary_fail += 1
        m = self._obs
        if m is not None:
            m.canary("pass" if passed else "fail").inc()

    def record_heal(self, *, trigger_at: float, healed: bool,
                    old_digest: str = "", new_digest: str = "",
                    detail: dict | None = None, mirror: bool = False) -> None:
        """One DriftGuard heal attempt (trigger through verdict).

        ``trigger_at`` comes from the guard's injected clock, so tests
        with a fake clock see deterministic history timestamps.
        ``mirror=True`` marks the copy the guard writes onto the flipped-
        to digest's telemetry: it lands in the snapshot history but not
        the heals counter, so the process-wide metric counts each heal
        once.
        """
        with self._lock:
            self._heal_attempts += 1
            self._last_heal_trigger_at = float(trigger_at)
            entry = {
                "trigger_at": float(trigger_at),
                "healed": bool(healed),
                "old_digest": old_digest,
                "new_digest": new_digest,
            }
            if detail:
                entry.update(detail)
            self._heal_history.append(entry)
            if healed and new_digest:
                self._flipped_digests.append(new_digest)
                del self._flipped_digests[:-HEAL_HISTORY]
        m = self._obs
        if m is not None and not mirror:
            m.heals("healed" if healed else "failed").inc()

    def record_validity(self, rows: int, invalid: int) -> None:
        """Per-row validity of one FAST-PATH flush (drift window input).

        Degraded (breaker-open) flushes must NOT be recorded here: their
        rows are exact-served by construction and would read as 100%
        fallback, turning an engine fault into a phantom drift signal.
        """
        if rows <= 0:
            return
        with self._lock:
            self._validity.append((int(rows), int(invalid)))
            w_rows = sum(r for r, _ in self._validity)
            w_invalid = sum(i for _, i in self._validity)
        m = self._obs
        if m is not None and w_rows:
            rate = w_invalid / w_rows
            m.fallback_rate.set(rate)
            m.validity_fraction.set(1.0 - rate)

    def fallback_window(self) -> dict:
        """Recent-traffic fallback rate — the ``DriftGuard`` signal."""
        with self._lock:
            rows = sum(r for r, _ in self._validity)
            invalid = sum(i for _, i in self._validity)
        return {
            "rows": rows,
            "invalid": invalid,
            "rate": invalid / rows if rows else 0.0,
        }

    def reset_fallback_window(self) -> None:
        with self._lock:
            self._validity.clear()

    # -------------------------------------------------------------- exporting

    def snapshot(self, engine=None) -> dict:
        with self._lock:
            out = {
                "requests": self._requests,
                "rows": self._rows,
                "flushes": self._flushes,
                "deadline_flushes": self._deadline_flushes,
                "queue_rows": self._queue_rows,
                "max_queue_rows": self._max_queue_rows,
                "coalescing_factor": round(
                    self._requests / max(1, self._flushes), 3
                ),
                "rows_per_flush": round(self._rows / max(1, self._flushes), 2),
                "shed_requests": self._shed_requests,
                "shed_rows": self._shed_rows,
                "served_requests": self._served_requests,
                "served_rows": self._served_rows,
                "closed_requests": self._closed_requests,
                "deadline_timeouts": self._deadline_timeouts,
                "batch_failures": self._batch_failures,
                "failed_requests": self._failed_requests,
                "failed_rows": self._failed_rows,
                "tightened_waits": self._tightened_waits,
                "step_time_ewma_s": self._step_time_ewma,
                "breaker": {
                    "state": self._breaker_state,
                    "trips": self._breaker_trips,
                    "probes": self._breaker_probes,
                    "degraded_flushes": self._degraded_flushes,
                    "degraded_requests": self._degraded_requests,
                    "degraded_rows": self._degraded_rows,
                    "shed_requests": self._breaker_shed_requests,
                },
                "canary": {
                    "recompiles": self._recompiles,
                    "passed": self._canary_pass,
                    "failed": self._canary_fail,
                },
                "heals": {
                    "attempts": self._heal_attempts,
                    "last_trigger_at": self._last_heal_trigger_at,
                    "flipped_digests": list(self._flipped_digests),
                    "history": list(self._heal_history),
                },
                "replicas": {
                    str(i): dict(c)
                    for i, c in sorted(self._replicas.items())
                },
            }
        out["fallback_window"] = self.fallback_window()
        out["latency"] = self.latency.snapshot()
        if engine is not None:
            eng = engine.stats.snapshot()
            out["engine"] = eng
            out["fallback_rate"] = eng["fallback_rate"]
            out["compiled_steps"] = eng["compiled_steps"]
        return out
