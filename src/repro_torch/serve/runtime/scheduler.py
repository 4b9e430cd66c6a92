"""``MicroBatcher`` — async request coalescing in front of one ``SVMEngine``.

The engine's fast path is a fixed-shape fused step over a power-of-two
shape bucket; a single-row request therefore pays for a whole
``min_bucket``-row step. Under concurrent traffic that cost is shared:
the batcher queues small requests per model and flushes them as ONE
engine submit — the rows land in the same padded bucket one request
would have paid for alone, so N coalesced requests cost ~1/N each.

Scheduling is queue + deadline, the classic micro-batching rule:

  * **bucket fills** — pending rows reach ``flush_rows`` (a bucket
    boundary of the engine, default ``min_bucket``): flush immediately,
    the step's padding waste is zero at that point;
  * **deadline expires** — the OLDEST queued request has waited
    ``max_wait_us``: flush whatever is pending. A lone request on an
    idle model therefore sees at most ``max_wait_us`` of added latency,
    and heavy traffic never waits at all (the bucket fills first).

Robustness layer (overload, faults, graceful degradation):

  * **admission control** — ``max_queue_rows`` bounds the queue: a
    submit that would grow the queue past the bound is SHED with a
    typed ``RuntimeOverloaded`` carrying ``retry_after_s`` (estimated
    from the measured per-step service time), instead of queueing
    unboundedly. The queue is a shock absorber, not a reservoir: under
    sustained overload, bounded depth means bounded latency for every
    request that IS admitted.
  * **per-submit deadlines** — ``submit(Z, deadline_s=...)`` fails the
    future with ``DeadlineExceeded`` if the request cannot reach a
    flush in time (checked both while queued and again at flush
    assembly, so a slow engine step ahead of it cannot sneak an expired
    request into a batch).
  * **SLO-aware wait tightening** — under queue pressure the effective
    ``max_wait_us`` shrinks proportionally to queue fullness (floored
    at 10%): a loaded batcher stops trading latency for coalescing it
    is already getting for free.
  * **fault isolation** — an exception from the engine step fails ONLY
    that batch's futures; the flush worker survives and keeps serving.
    Repeated consecutive failures trip a per-model ``CircuitBreaker``:
    while open, traffic degrades to the exact streaming ``rbf_pred``
    path (``engine.submit_exact``) if an exact model was published, or
    is shed with ``RuntimeOverloaded`` if not. After ``reset_after_s``
    the breaker half-opens and sends ONE probe batch down the fast
    path: success closes it, failure re-opens it.
  * **no hung futures** — ``close()`` flushes what it can and resolves
    anything left with ``BatcherClosed``; a crashed worker resolves the
    queue exceptionally on the way out. Every admitted future
    terminates, exactly once.

Scale-out layer (``engines=[...]``): the batcher can front N
REPLICA engines built from the same digest (content addressing makes
them interchangeable — same artifact bytes, same compiled step). One
coalescing queue feeds a least-loaded dispatcher: each flush routes to
the admitted replica with the fewest in-flight rows, round-robin among
ties. Every replica carries its OWN circuit breaker, so a faulting
device degrades only itself — flushes simply stop selecting it while
its siblings keep the fast path, and the half-open probe window re-
admits it replica-by-replica. Only when EVERY replica refuses the fast
path does the batcher fall back to the degraded exact path (or shed).
With more than one replica each gets a dedicated dispatch thread:
host-side padding + device dispatch for replica i never head-of-line
blocks replica j, which is what turns N devices into ~N× throughput.
Flushes are capped at the engine's ``max_batch`` rows (the engine's
own chunking unit), so a deep queue SPREADS across replicas instead of
riding one replica as a single mega-flush the engine would chunk
serially.
With a single replica (the default) dispatch stays inline on the flush
thread — byte-identical behavior to the pre-replica batcher.

Everything the engine guarantees survives coalescing:

  * **zero steady-state recompiles** — the concatenated rows go through
    ``engine.submit``'s existing bucket padding, so the flush hits the
    same bounded set of compiled variants (asserted in the throughput
    benchmark via ``jit_cache_size`` before/after);
  * **deferred sync** — the flush thread never blocks on device compute:
    futures resolve with ``SliceResult`` views of the shared
    ``EngineResult`` the moment the submit returns, and the one
    device→host sync happens when the FIRST client materializes (the
    engine's materialize lock makes that race safe);
  * **per-request row order** — ``EngineResult.split`` carves the
    coalesced result at the original request boundaries, so each caller
    sees its rows in the order it sent them, including rows the engine
    patched through the exact fallback path.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.serve.runtime.errors import (
    BatcherClosed,
    DeadlineExceeded,
    RuntimeOverloaded,
)
from repro_torch.serve.runtime.faults import ENGINE_STEP, FaultInjector
from repro_torch.serve.runtime.telemetry import ModelTelemetry

DEFAULT_MAX_WAIT_US = 200.0

# SLO tightening floor: a fully-pressured queue still waits 10% of
# max_wait_us (zero would busy-spin the flush thread on a trickle).
MIN_WAIT_FRACTION = 0.1

# A flush counts as "tightened" in telemetry only when pressure cut the
# wait by more than 10% — any non-empty queue shortens it a little, and
# counting that would make the counter fire on every deadline flush.
TIGHTENED_BELOW = 0.9


class CircuitBreaker:
    """Per-model circuit over the engine fast path.

    closed --[``fail_threshold`` consecutive step failures]--> open
    open   --[``reset_after_s`` elapsed]--> half_open (one probe batch)
    half_open --[probe succeeds]--> closed / --[probe fails]--> open

    Internally locked: with replica dispatch threads, ``allow_fast``
    (flush thread) and ``record_*`` (the replica's dispatch thread) may
    race; ``state`` reads from other threads stay single attribute loads.
    """

    def __init__(self, *, fail_threshold: int = 3, reset_after_s: float = 0.25,
                 clock=time.monotonic):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.fail_threshold = int(fail_threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self.state = "closed"
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def clone(self) -> "CircuitBreaker":
        """A fresh breaker with this one's configuration (per-replica)."""
        return CircuitBreaker(fail_threshold=self.fail_threshold,
                              reset_after_s=self.reset_after_s,
                              clock=self._clock)

    def allow_fast(self) -> bool:
        """May the next batch use the fast path? Transitions open →
        half_open when the probe window arrives (that batch IS the probe)."""
        with self._lock:
            if self.state == "open":
                if self._clock() - self._opened_at >= self.reset_after_s:
                    self.state = "half_open"
                    return True
                return False
            return True                 # closed, or half_open (another probe)

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            self.state = "closed"

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self.state == "half_open" or \
                    self.consecutive_failures >= self.fail_threshold:
                self.state = "open"
                self._opened_at = self._clock()

    def retry_after(self) -> float:
        """Time until the breaker would next admit a probe (0 if not open)."""
        with self._lock:
            if self.state != "open":
                return 0.0
            return max(
                0.0, self.reset_after_s - (self._clock() - self._opened_at)
            )

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "fail_threshold": self.fail_threshold,
            "reset_after_s": self.reset_after_s,
        }


def _resolve_breaker(breaker) -> CircuitBreaker | None:
    """True → default breaker; dict → kwargs; instance → itself; falsy → off."""
    if breaker is True:
        return CircuitBreaker()
    if isinstance(breaker, dict):
        return CircuitBreaker(**breaker)
    if isinstance(breaker, CircuitBreaker) or breaker is None or breaker is False:
        return breaker or None
    raise TypeError(f"breaker must be bool, dict or CircuitBreaker, got {breaker!r}")


class _Replica:
    """One engine instance behind the batcher (usually one device).

    Owns its breaker (a faulting replica degrades only itself) and —
    when the batcher runs more than one replica — a dedicated dispatch
    thread, so padding + device dispatch for one replica never blocks
    its siblings. ``inflight_rows`` (guarded by the batcher's
    accounting lock) counts rows dispatched but not yet materialized or
    failed; it is the least-loaded dispatch signal.
    """

    __slots__ = ("index", "engine", "breaker", "inflight_rows", "flushes",
                 "rows", "failures", "last_state", "jobs", "thread")

    def __init__(self, index: int, engine, breaker: CircuitBreaker | None):
        self.index = index
        self.engine = engine
        self.breaker = breaker
        self.inflight_rows = 0
        self.flushes = 0
        self.rows = 0
        self.failures = 0
        self.last_state = "closed"
        self.jobs: queue.SimpleQueue | None = None   # set when threaded
        self.thread: threading.Thread | None = None


class _EmptyResult:
    """Zero-row result with the engine's output shapes; no device step."""

    def __init__(self, engine):
        k = engine.num_heads
        self.values = (np.zeros((0, k), np.float32) if engine.multiclass
                       else np.zeros((0,), np.float32))
        self.valid = np.zeros((0,), bool)
        self.labels = np.zeros((0,), np.int32)

    def __len__(self) -> int:
        return 0

    def block_until_ready(self):
        return self


class _Pending:
    __slots__ = ("Z", "future", "t_enqueue", "deadline", "trace")

    def __init__(self, Z: np.ndarray, future: Future, t_enqueue: float,
                 deadline: float | None = None, trace: str | None = None):
        self.Z = Z
        self.future = future
        self.t_enqueue = t_enqueue
        self.deadline = deadline          # absolute perf_counter time, or None
        self.trace = trace                # obs trace id linking this
                                          # request's lifecycle spans


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into bucket-sized engine steps.

    ``submit(Z) -> Future[SliceResult]``: the future resolves as soon as
    the coalesced engine step is ENQUEUED on the device (deferred sync);
    materializing the result's ``.values`` / ``.labels`` / ``.valid``
    performs the one host transfer, shared with every sibling request.

    Robustness knobs (all optional; defaults keep plain coalescing
    except the breaker, which is on and inert until steps actually fail):

      * ``max_queue_rows`` — admission bound; ``None`` = unbounded.
      * ``breaker`` — ``True`` (default config), ``False``/``None``
        (off), a kwargs dict, or a ``CircuitBreaker``.
      * ``fault_injector`` — a ``faults.FaultInjector`` consulted at the
        ``engine_step`` site before every fast-path flush (chaos tests).
      * ``engines`` — replica engines for the same digest
        (``engines[0]`` must be ``engine``); flushes spread over them
        least-loaded, each behind its own breaker clone.
      * ``tracer`` — an ``obs.Tracer``; when given, every request's
        lifecycle (admission → queue wait → dispatch → engine step →
        scatter → sync, plus shed/expired/failed/closed verdicts and
        breaker transitions) is recorded as linked spans under this
        batcher's ``name``.
    """

    def __init__(
        self,
        engine,
        *,
        max_wait_us: float = DEFAULT_MAX_WAIT_US,
        flush_rows: int | None = None,
        telemetry: ModelTelemetry | None = None,
        name: str = "model",
        max_queue_rows: int | None = None,
        breaker=True,
        fault_injector: FaultInjector | None = None,
        engines: list | None = None,
        tracer=None,
    ):
        engs = [engine] if engines is None else list(engines)
        if not engs or engs[0] is not engine:
            raise ValueError("engines[0] must be the primary engine")
        if flush_rows is None:
            flush_rows = engine.min_bucket
        if flush_rows < 1 or flush_rows > engine.max_batch:
            raise ValueError(
                f"flush_rows must be in [1, {engine.max_batch}], got {flush_rows}"
            )
        if max_queue_rows is not None and max_queue_rows < flush_rows:
            raise ValueError(
                f"max_queue_rows ({max_queue_rows}) must be >= flush_rows "
                f"({flush_rows}) or admission would starve every flush"
            )
        self.engine = engine
        self.max_wait_s = max_wait_us * 1e-6
        self.flush_rows = flush_rows
        self.max_queue_rows = max_queue_rows
        self.telemetry = telemetry if telemetry is not None else ModelTelemetry()
        self.name = name
        # replica 0 keeps the caller-supplied breaker (and the public
        # ``self.breaker`` back-compat handle); siblings get fresh clones
        # of the same config so one replica's failures never bleed into
        # another's consecutive-failure count
        primary = _resolve_breaker(breaker)
        self.breaker = primary
        self.replicas = [
            _Replica(i, eng, primary if i == 0
                     else (primary.clone() if primary is not None else None))
            for i, eng in enumerate(engs)
        ]
        self.faults = fault_injector
        # surface every replica's breaker gauge from birth (closed == 0)
        # rather than waiting for a first transition to materialize it
        for r in self.replicas:
            if r.breaker is not None:
                self.telemetry.record_breaker_state("closed", replica=r.index)
        # obs.Tracer (or None): every admitted request gets a trace id at
        # submit; lifecycle spans (queue wait, dispatch, engine step,
        # scatter, sync, verdicts) link to it. Span recording is a dict
        # append under one lock — cheap enough for the hot path.
        self._tracer = tracer
        self._cfg_strs: dict[int, str] = {}
        self._step_time_s = self.max_wait_s or 1e-4   # EWMA of measured steps
        self._queue: collections.deque[_Pending] = collections.deque()
        self._queued_rows = 0
        self._cond = threading.Condition()
        self._acct = threading.Lock()     # replica inflight/counter guard
        self._rr = 0                      # round-robin tiebreak cursor
        self._closed = False
        if len(self.replicas) > 1:
            for r in self.replicas:
                r.jobs = queue.SimpleQueue()
                r.thread = threading.Thread(
                    target=self._replica_run, args=(r,),
                    name=f"microbatch-{name}-r{r.index}", daemon=True,
                )
                r.thread.start()
        self._worker = threading.Thread(
            target=self._run, name=f"microbatch-{name}", daemon=True
        )
        self._worker.start()

    # ---------------------------------------------------------------- client

    def submit(self, Z, *, deadline_s: float | None = None) -> Future:
        """Enqueue one request; returns a future of its ``SliceResult``.

        Raises ``RuntimeOverloaded`` (typed, with ``retry_after_s``) when
        the bounded queue is full, ``BatcherClosed`` after ``close()``.
        With ``deadline_s`` the future fails with ``DeadlineExceeded``
        if the request cannot be flushed within that many seconds of
        submission.
        """
        Z = np.asarray(Z, dtype=np.float32)
        if Z.ndim == 1:
            Z = Z[None, :]
        if Z.ndim != 2 or Z.shape[1] != self.engine.d:
            raise ValueError(
                f"expected (n, {self.engine.d}) batch, got {Z.shape}"
            )
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        fut: Future = Future()
        if Z.shape[0] == 0:                       # nothing to coalesce
            with self._cond:
                if self._closed:
                    raise BatcherClosed(f"MicroBatcher({self.name!r}) is closed")
            fut.set_result(_EmptyResult(self.engine))
            return fut
        now = time.perf_counter()
        tr = self._tracer
        item = _Pending(Z, fut, now,
                        None if deadline_s is None else now + deadline_s,
                        trace=tr.new_trace() if tr is not None else None)
        with self._cond:
            if self._closed:
                raise BatcherClosed(f"MicroBatcher({self.name!r}) is closed")
            rows = Z.shape[0]
            if (self.max_queue_rows is not None
                    and self._queued_rows > 0
                    and self._queued_rows + rows > self.max_queue_rows):
                # shed BEFORE enqueueing (the queue is the bound); an
                # empty queue always admits so a single request larger
                # than the bound is still servable (the engine chunks it)
                self.telemetry.record_shed(rows)
                retry = self._retry_after_locked()
                self._span("request.shed", trace_id=item.trace,
                           attrs={"rows": rows, "retry_after_s": retry})
                raise RuntimeOverloaded(
                    f"model {self.name!r}: queue full "
                    f"({self._queued_rows}/{self.max_queue_rows} rows)",
                    retry_after_s=retry,
                )
            self._queue.append(item)
            self._queued_rows += rows
            self.telemetry.record_enqueue(rows)
            self._span("request.admitted", trace_id=item.trace,
                       t_start=now, attrs={
                           "rows": rows,
                           "deadline": item.deadline is not None,
                       })
            self._cond.notify()
        return fut

    def _span(self, name: str, **kw) -> str | None:
        """Record one span under this batcher's model key (no-op untraced)."""
        tr = self._tracer
        if tr is None:
            return None
        return tr.span(self.name, name, **kw)

    def _retry_after_locked(self) -> float:
        """Expected time for the current queue to drain: queued flushes ×
        the EWMA of measured step time (+ one flush wait)."""
        flushes = max(1.0, self._queued_rows / self.flush_rows)
        return flushes * self._step_time_s + self.max_wait_s

    def flush(self) -> None:
        """Drain the queue synchronously (tests, shutdown)."""
        with self._cond:
            batch = self._drain_locked()
        if batch:
            self._execute(batch, deadline=False)

    def close(self) -> None:
        """Stop the flush thread; every pending future RESOLVES.

        Requests already queued are flushed (served or failed by the
        engine's verdict); anything left after the worker exits — e.g. a
        worker that died, or raced past the drain — is failed with
        ``BatcherClosed``. A caller blocked on ``future.result()`` is
        never left hanging.
        """
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=5.0)
        self.flush()                               # anything enqueued at the wire
        for r in self.replicas:                    # drain replica dispatchers:
            if r.jobs is not None:                 # the sentinel queues BEHIND
                r.jobs.put(None)                   # any still-pending flushes
        for r in self.replicas:
            if r.thread is not None:
                r.thread.join(timeout=5.0)
        with self._cond:                           # belt and braces: no future
            leftovers = self._drain_locked()       # survives close unresolved
        if leftovers:
            self.telemetry.record_closed(
                len(leftovers), sum(p.Z.shape[0] for p in leftovers)
            )
        self._fail_batch(leftovers,
                         BatcherClosed(f"MicroBatcher({self.name!r}) is closed"),
                         verdict="closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------------- worker

    def _drain_locked(self, limit: int | None = None) -> list[_Pending]:
        """Pop queued requests: all of them, or whole requests up to
        ``limit`` rows (always at least one — a single oversized request
        still flushes; the engine chunks it internally)."""
        if limit is None:
            batch = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            return batch
        batch, rows = [], 0
        while self._queue:
            r = self._queue[0].Z.shape[0]
            if batch and rows + r > limit:
                break
            batch.append(self._queue.popleft())
            rows += r
        self._queued_rows -= rows
        return batch

    def _flush_limit(self) -> int:
        """Max rows per flush: the engine's ``max_batch``.

        The engine chunks anything larger into sequential ``max_batch``
        steps anyway, so an unbounded flush is one giant serialized
        submit — under replicas it would ride ONE replica while its
        siblings idle. Capping the flush at the engine's own compute
        unit keeps dispatch and compute granularity aligned and lets
        the least-loaded dispatcher spread a deep queue."""
        return self.engine.max_batch

    def _pop_expired_locked(self, now: float) -> list[_Pending]:
        """Remove queued items whose deadline has passed; returns them."""
        if not any(p.deadline is not None for p in self._queue):
            return []
        live, expired = [], []
        for p in self._queue:
            (expired if p.deadline is not None and now >= p.deadline
             else live).append(p)
        if expired:
            self._queue = collections.deque(live)
            self._queued_rows = sum(p.Z.shape[0] for p in live)
        return expired

    def _effective_wait_locked(self) -> float:
        """``max_wait_s`` tightened by queue pressure (SLO-aware): a
        batcher at 60% of its admission bound only waits 40% as long."""
        if self.max_queue_rows is None:
            return self.max_wait_s
        pressure = self._queued_rows / self.max_queue_rows
        return self.max_wait_s * min(1.0, max(MIN_WAIT_FRACTION, 1.0 - pressure))

    def _run(self) -> None:
        try:
            while True:
                expired = None
                with self._cond:
                    while not self._queue and not self._closed:
                        self._cond.wait()
                    if self._closed:
                        batch, deadline_hit, tightened = \
                            self._drain_locked(), False, False
                    elif self._queued_rows >= self.flush_rows:
                        batch, deadline_hit, tightened = \
                            self._drain_locked(self._flush_limit()), False, False
                    else:
                        now = time.perf_counter()
                        expired = self._pop_expired_locked(now)
                        batch = None
                        if not expired:
                            wait_s = self._effective_wait_locked()
                            wake = self._queue[0].t_enqueue + wait_s
                            dls = [p.deadline for p in self._queue
                                   if p.deadline is not None]
                            if dls:
                                wake = min(wake, min(dls))
                            remaining = wake - now
                            if remaining > 0:
                                self._cond.wait(timeout=remaining)
                                continue                   # re-evaluate
                            batch, deadline_hit = \
                                self._drain_locked(self._flush_limit()), True
                            tightened = wait_s < self.max_wait_s * TIGHTENED_BELOW
                if expired:
                    self._fail_expired(expired)
                    continue
                if batch:
                    self._execute(batch, deadline=deadline_hit,
                                  tightened=tightened)
                if self._closed and not batch:
                    return
        finally:
            # the worker exits via close() or a crash; either way nothing
            # may be left in the queue to hang a caller forever
            with self._cond:
                self._closed = True
                leftovers = self._drain_locked()
            if leftovers:
                self.telemetry.record_closed(
                    len(leftovers), sum(p.Z.shape[0] for p in leftovers)
                )
            self._fail_batch(
                leftovers,
                BatcherClosed(f"MicroBatcher({self.name!r}) worker exited"),
                verdict="closed",
            )

    # -------------------------------------------------------------- execution

    def _fail_batch(self, batch: list[_Pending], exc: BaseException,
                    verdict: str | None = "failed",
                    attrs: dict | None = None) -> None:
        # ``verdict`` names the terminal span ("failed" / "closed");
        # None means the caller already recorded its own verdict spans
        for p in batch:
            if verdict is not None:
                span_attrs = {"rows": p.Z.shape[0], "error": type(exc).__name__}
                if attrs:
                    span_attrs.update(attrs)
                self._span(f"request.{verdict}", trace_id=p.trace,
                           t_start=p.t_enqueue, attrs=span_attrs)
            # a client may have cancelled while queued; a cancelled future
            # must not take the whole flush worker down with it
            if p.future.set_running_or_notify_cancel():
                p.future.set_exception(exc)

    def _fail_expired(self, expired: list[_Pending]) -> None:
        rows = sum(p.Z.shape[0] for p in expired)
        self.telemetry.record_deadline_timeout(len(expired), rows)
        now = time.perf_counter()
        for p in expired:
            self._span("request.expired", trace_id=p.trace,
                       t_start=p.t_enqueue, t_end=now,
                       attrs={"rows": p.Z.shape[0],
                              "queued_s": now - p.t_enqueue})
        self._fail_batch(expired, DeadlineExceeded(
            f"model {self.name!r}: {len(expired)} request(s) expired "
            f"before a flush could serve them"
        ), verdict=None)

    def _sync_breaker_telemetry(self, replica: _Replica) -> None:
        if replica.breaker is None:
            return
        st = replica.breaker.state
        if st != replica.last_state:
            self.telemetry.record_breaker_state(
                st,
                tripped=(st == "open"),
                probe=(st == "half_open"),
                replica=replica.index,
            )
            self._span("breaker.transition", attrs={
                "replica": replica.index,
                "from": replica.last_state,
                "to": st,
            })
            replica.last_state = st

    def _select_replica(self) -> _Replica | None:
        """Least-loaded replica whose breaker admits the fast path
        (round-robin among ties); ``None`` when every replica refuses —
        the all-breakers-open signal that degrades the whole flush.
        ``allow_fast`` is consulted per replica, so an open sibling is
        simply skipped while its probe window has not arrived."""
        n = len(self.replicas)
        allowed = [r for r in self.replicas
                   if r.breaker is None or r.breaker.allow_fast()]
        if not allowed:
            return None
        with self._acct:
            chosen = min(allowed, key=lambda r: (r.inflight_rows,
                                                 (r.index - self._rr) % n))
            self._rr = (chosen.index + 1) % n
        return chosen

    def _execute(self, batch: list[_Pending], *, deadline: bool,
                 tightened: bool = False) -> None:
        # re-check deadlines at flush assembly: a slow step ahead of this
        # batch may have burned the queue time an expired item had left
        now = time.perf_counter()
        live, expired = [], []
        for p in batch:
            (expired if p.deadline is not None and now >= p.deadline
             else live).append(p)
        if expired:
            self._fail_expired(expired)
        batch = live
        if not batch:
            return
        sizes = [p.Z.shape[0] for p in batch]
        rows = int(sum(sizes))

        replica = self._select_replica()
        for r in self.replicas:
            self._sync_breaker_telemetry(r)       # open -> half_open probes
        if replica is None:                       # every breaker refused
            self._execute_degraded(batch, sizes, rows,
                                   deadline=deadline, tightened=tightened)
            return
        with self._acct:
            replica.inflight_rows += rows
        if replica.jobs is not None:              # threaded replica dispatch
            replica.jobs.put((batch, sizes, rows, deadline, tightened))
            return
        self._dispatch(replica, batch, sizes, rows,
                       deadline=deadline, tightened=tightened)

    def _replica_run(self, replica: _Replica) -> None:
        while True:
            job = replica.jobs.get()
            if job is None:
                return
            batch, sizes, rows, deadline, tightened = job
            try:
                self._dispatch(replica, batch, sizes, rows,
                               deadline=deadline, tightened=tightened)
            except BaseException as e:            # _dispatch's own handling
                for p in batch:                   # failed: nothing may hang
                    if not p.future.done():
                        try:
                            p.future.set_exception(e)
                        except Exception:
                            pass

    def _dispatch(self, replica: _Replica, batch: list[_Pending], sizes,
                  rows: int, *, deadline: bool, tightened: bool) -> None:
        """One fast-path flush on ``replica`` — inline on the flush
        thread (single replica) or on the replica's dispatch thread."""
        t0 = time.perf_counter()
        tr = self._tracer
        flush_trace = tr.new_trace() if tr is not None else None
        bucket = replica.engine.bucket_for(
            min(rows, replica.engine.max_batch)
        )
        def _emit_queue_waits():
            # coalesce: each request's time in the queue, linked both to
            # its own trace and (via attrs) to the flush that drained it.
            # Emitted AFTER the engine step is dispatched: span bookkeeping
            # for a deep coalesced batch then overlaps the asynchronous
            # kernels instead of sitting between the queue and the card.
            if tr is not None:
                for p in batch:
                    self._span("request.queue_wait", trace_id=p.trace,
                               t_start=p.t_enqueue, t_end=t0,
                               attrs={"rows": p.Z.shape[0],
                                      "flush": flush_trace})

        try:
            if self.faults is not None:
                if len(self.replicas) > 1:
                    self.faults.check_replica(ENGINE_STEP, replica.index)
                else:
                    self.faults.check(ENGINE_STEP)
            Z = np.concatenate([p.Z for p in batch], axis=0)
            compiled_before = replica.engine.stats.compiled_steps
            result = replica.engine.submit(Z)
            recompiled = replica.engine.stats.compiled_steps > compiled_before
            # e2e latency closes when the SHARED result first materializes
            # (one sample per coalesced request, recorded by whichever
            # client thread syncs first); per-row validity feeds the
            # drift window the DriftGuard watches.
            enqueued = [p.t_enqueue for p in batch]
            telemetry = self.telemetry

            def _on_materialize(done, ts=enqueued, tel=telemetry, n=rows,
                                rep=replica, ftrace=flush_trace, t_sync=t0):
                t_done = time.perf_counter()
                for t_enq in ts:
                    tel.record_latency(t_done - t_enq)
                valid = np.asarray(done[1])
                invalid = int(n - int(valid.sum()))
                tel.record_validity(n, invalid)
                self._span("flush.sync", trace_id=ftrace,
                           t_start=t_sync, t_end=t_done,
                           attrs={"replica": rep.index, "rows": n})
                # fast-path ONLY: degraded flushes never emit a validity
                # span (mirrors record_validity's drift-window contract)
                self._span("flush.validity", trace_id=ftrace,
                           t_end=t_done, attrs={"replica": rep.index,
                                                "rows": n,
                                                "invalid": invalid})
                with self._acct:
                    rep.inflight_rows -= n

            result.on_materialize = _on_materialize
            slices = result.split(sizes)
        except BaseException as e:                 # scatter the failure too
            with self._acct:
                replica.inflight_rows -= rows
                replica.failures += 1
            self.telemetry.record_flush(len(batch), rows, deadline=deadline,
                                        tightened=tightened)
            self.telemetry.record_batch_failure(len(batch), rows)
            self.telemetry.record_replica_failure(replica.index)
            _emit_queue_waits()          # the wait happened even if the step failed
            self._span("flush.failed", trace_id=flush_trace, t_start=t0,
                       attrs={"replica": replica.index, "rows": rows,
                              "error": type(e).__name__})
            if replica.breaker is not None:
                replica.breaker.record_failure()
                self._sync_breaker_telemetry(replica)
            self._fail_batch(batch, e, attrs={"replica": replica.index})
            return
        if replica.breaker is not None:
            replica.breaker.record_success()
            self._sync_breaker_telemetry(replica)
        with self._acct:
            # EWMA of step enqueue time feeds the retry_after_s estimate
            self._step_time_s = 0.8 * self._step_time_s + \
                0.2 * (time.perf_counter() - t0)
            step_ewma = self._step_time_s
            replica.flushes += 1
            replica.rows += rows
        # resolve every future FIRST: clients can start materializing the
        # (asynchronously computing) result — which drops the GIL while it
        # waits for the card — while the span/telemetry bookkeeping below
        # runs in Python
        for p, s in zip(batch, slices):
            if p.future.set_running_or_notify_cancel():
                p.future.set_result(s)
        self.telemetry.record_step_time(step_ewma)
        self.telemetry.record_flush(len(batch), rows, deadline=deadline,
                                    tightened=tightened)
        self.telemetry.record_replica_flush(replica.index, len(batch), rows,
                                            bucket=bucket)
        self.telemetry.record_served(len(batch), rows)
        if tr is not None:
            cfg_str = self._cfg_strs.get(bucket)
            if recompiled or cfg_str is None:
                # dataclass repr is slow; cache per bucket, refresh on
                # recompile (the one event that can change the config)
                cfg_str = str(replica.engine.bucket_configs.get(bucket))
                self._cfg_strs[bucket] = cfg_str
            # one batched enqueue for the whole flush: step + dispatch
            # plus per-request queue-wait (linked to the flush trace via
            # attrs) and served verdicts — same spans and the same id
            # order as per-call emission, a fraction of the hot-path cost
            now = tr.clock()
            ridx = replica.index
            events = [
                ("engine.step", flush_trace, None, t0, now, {
                    "replica": ridx,
                    "bucket": bucket,
                    "tile_config": cfg_str,
                    "recompiled": recompiled,
                    "rows": rows,
                }),
            ]
            for p in batch:
                events.append(
                    ("request.queue_wait", p.trace, None, p.t_enqueue, t0,
                     {"rows": p.Z.shape[0], "flush": flush_trace})
                )
            events.append(
                ("flush.dispatch", flush_trace, None, t0, now,
                 {"replica": ridx, "requests": len(batch), "rows": rows,
                  "bucket": bucket, "deadline": deadline,
                  "tightened": tightened})
            )
            for p in batch:
                events.append(
                    ("request.served", p.trace, None, p.t_enqueue, now,
                     {"rows": p.Z.shape[0], "replica": ridx,
                      "flush": flush_trace})
                )
            tr.span_many(self.name, events)

    def _execute_degraded(self, batch: list[_Pending], sizes, rows: int, *,
                          deadline: bool, tightened: bool) -> None:
        """Breaker-open serving: exact ``rbf_pred`` path, or shed.

        Reached only when EVERY replica's breaker refuses the fast path;
        it runs inline on the flush thread against the primary engine
        (the exact path is the already-degraded slow lane — fanning it
        out across replicas would just multiply pressure on the host).
        """
        t0 = time.perf_counter()
        tr = self._tracer
        flush_trace = tr.new_trace() if tr is not None else None
        if not getattr(self.engine, "exact_available", False):
            # soonest probe window across replicas: the honest retry hint
            retry = min((r.breaker.retry_after() for r in self.replicas
                         if r.breaker is not None), default=0.0)
            self.telemetry.record_flush(len(batch), rows, deadline=deadline,
                                        tightened=tightened)
            self.telemetry.record_breaker_shed(len(batch))
            self._fail_batch(batch, RuntimeOverloaded(
                f"model {self.name!r}: circuit breaker open and no exact "
                f"model published to degrade to",
                retry_after_s=retry or self.max_wait_s,
            ), attrs={"reason": "breaker_shed"})
            return
        try:
            Z = np.concatenate([p.Z for p in batch], axis=0)
            result = self.engine.submit_exact(Z)
            enqueued = [p.t_enqueue for p in batch]
            telemetry = self.telemetry

            # latency only — degraded rows are exact-served and must NOT
            # feed the drift window (a fault is not input drift); for the
            # same reason no flush.validity span is emitted here
            def _on_materialize(done, ts=enqueued, tel=telemetry,
                                ftrace=flush_trace, n=rows, t_sync=t0):
                t_done = time.perf_counter()
                for t_enq in ts:
                    tel.record_latency(t_done - t_enq)
                self._span("flush.sync", trace_id=ftrace,
                           t_start=t_sync, t_end=t_done,
                           attrs={"rows": n, "degraded": True})

            result.on_materialize = _on_materialize
            slices = result.split(sizes)
        except BaseException as e:
            self.telemetry.record_flush(len(batch), rows, deadline=deadline,
                                        tightened=tightened)
            self.telemetry.record_batch_failure(len(batch), rows)
            self._span("flush.failed", trace_id=flush_trace, t_start=t0,
                       attrs={"rows": rows, "degraded": True,
                              "error": type(e).__name__})
            self._fail_batch(batch, e, attrs={"degraded": True})
            return
        self.telemetry.record_flush(len(batch), rows, deadline=deadline,
                                    tightened=tightened)
        self.telemetry.record_degraded(len(batch), rows)
        self.telemetry.record_served(len(batch), rows)
        self._span("flush.degraded", trace_id=flush_trace, t_start=t0,
                   attrs={"requests": len(batch), "rows": rows})
        for p, s in zip(batch, slices):
            self._span("request.served", trace_id=p.trace,
                       t_start=p.t_enqueue, attrs={
                           "rows": p.Z.shape[0],
                           "degraded": True,
                           "flush": flush_trace,
                       })
            if p.future.set_running_or_notify_cancel():
                p.future.set_result(s)
