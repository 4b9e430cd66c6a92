"""Request-lifecycle tracing with deterministic span identity.

A ``Tracer`` records *completed* spans — small dicts with a name, a
model key, start/end timestamps from an injectable clock, a trace id
linking the spans of one request (or one coalesced flush, or one
DriftGuard heal arc), an optional parent id, and free-form attrs.
Spans land in a bounded per-model ring buffer (``deque(maxlen=...)``)
so a hot runtime can trace forever without growing, and can be dumped
as JSONL for offline inspection.

``span()`` itself is asynchronous: it mints the deterministic id
(lock-free counter) and enqueues an event tuple — about a microsecond
on the caller. A daemon writer thread materializes the record dicts
and monotone counts off the serving path (under a coalesced flush,
every microsecond spent in ``span()`` lands on the latency of every
request in the batch). Readers drain the queue before answering, so
the view any reader gets includes every span recorded before its
call. One contract follows: the ``attrs`` dict is taken by reference
and must not be mutated by the caller after ``span()`` returns.

Determinism contract
--------------------
Span and trace ids derive from a seeded monotone counter:
``{seed:04x}-{ordinal:012x}``. They never encode wall-clock time,
thread identity, or ``id()`` of objects, so a replay that performs the
same allocations in the same order yields byte-identical ids — the
same contract the ``FaultInjector`` gives for fault verdicts (pure
function of seed and ordinal). Under concurrent traffic the allocation
*order* is whatever the thread interleaving produced, but the id of
the N-th allocated span is always the same function of (seed, N).

Conservation
------------
Ring buffers forget; accounting must not. Alongside the ring, the
tracer keeps unbounded monotone per-(model, span-name) counters,
bumped on every ``span()`` call — including per-replica and degraded
sub-keys (``request.served[replica=1]``, ``request.served[degraded]``)
when the span attrs carry those fields. ``conservation(model)``
evaluates the runtime's accounting identity over those counters:

    submitted == admitted + shed
    admitted  == served + failed + expired + closed + in_flight

so ``unaccounted == 0`` must hold after a drained runtime closes, no
matter how many spans the ring evicted.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from queue import Empty, SimpleQueue

# Request lifecycle verdict span names. Every admitted request must
# terminate in exactly one of the TERMINAL names.
ADMITTED = "request.admitted"
SHED = "request.shed"
SERVED = "request.served"
FAILED = "request.failed"
EXPIRED = "request.expired"
CLOSED = "request.closed"
TERMINAL = (SERVED, FAILED, EXPIRED, CLOSED)

_COUNT_ATTR_KEYS = ("replica",)


class Tracer:
    """Bounded per-model span recorder with deterministic ids."""

    def __init__(
        self,
        seed: int = 0,
        capacity: int = 4096,
        clock=time.perf_counter,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.seed = int(seed)
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._id_prefix = f"{self.seed & 0xFFFF:04x}-"
        self._rings: dict[str, deque] = {}
        self._counts: dict[str, dict[str, int]] = {}
        # Async span writer. ``span()`` is called on the serving hot path
        # — under a coalesced flush, every microsecond it spends lands on
        # the latency of EVERY request in the batch — so it only mints an
        # ordinal (lock-free ``itertools.count``) and enqueues a tuple;
        # the writer thread materializes records and counts during the
        # batcher's idle coalesce windows. Readers drain the queue under
        # the same lock before answering, so every span enqueued
        # before a read is visible to it (the conservation barrier).
        self._ordinals = itertools.count()
        self._events: SimpleQueue = SimpleQueue()
        self._wake = threading.Event()
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True, name="tracer-writer"
        )
        self._writer.start()

    # -- identity ---------------------------------------------------------

    def new_id(self) -> str:
        """Next deterministic id: ``{seed:04x}-{ordinal:012x}``."""
        return self._id_prefix + format(next(self._ordinals), "012x")

    def new_trace(self) -> str:
        """Fresh trace id linking the spans of one request/flush/heal."""
        return self.new_id()

    # -- recording --------------------------------------------------------

    def span(
        self,
        model: str,
        name: str,
        *,
        trace_id: str | None = None,
        parent_id: str | None = None,
        t_start: float | None = None,
        t_end: float | None = None,
        attrs: dict | None = None,
    ) -> str:
        """Record one completed span; returns its span id.

        Hot-path cost is one lock-free counter bump plus a queue put;
        the record itself is materialized by the writer thread (or by
        the next reader, whichever comes first).
        """
        if t_end is None:
            t_end = self.clock()
        if t_start is None:
            t_start = t_end
        span_id = self._id_prefix + format(next(self._ordinals), "012x")
        self._events.put(
            (span_id, model, name, trace_id, parent_id,
             float(t_start), float(t_end), attrs)
        )
        self._wake.set()
        return span_id

    def span_many(self, model: str, events: list) -> None:
        """Record many completed spans for one model in ONE enqueue.

        The per-flush emission path: a coalesced flush produces one
        ``engine.step``/``flush.dispatch`` span plus a queue-wait and a
        verdict span per request — batching them amortizes the queue
        put and the call overhead across the whole flush. Each event is
        ``(name, trace_id, parent_id, t_start, t_end, attrs)``; span
        ids are minted here in event order (same (seed, ordinal)
        contract as ``span()``). Attrs dicts are taken by reference.
        """
        prefix = self._id_prefix
        ordinals = self._ordinals
        self._events.put(
            [
                (prefix + format(next(ordinals), "012x"),
                 model, name, trace_id, parent_id,
                 float(t_start), float(t_end), attrs)
                for name, trace_id, parent_id, t_start, t_end, attrs in events
            ]
        )
        self._wake.set()

    # -- span materialization (writer thread / readers) -------------------

    def _apply_locked(self, event: tuple) -> None:
        (span_id, model, name, trace_id, parent_id,
         t_start, t_end, attrs) = event
        record = {
            "span_id": span_id,
            "trace_id": trace_id,
            "parent_id": parent_id,
            "model": model,
            "name": name,
            "t_start": t_start,
            "t_end": t_end,
            "attrs": dict(attrs) if attrs else {},
        }
        ring = self._rings.get(model)
        if ring is None:
            ring = deque(maxlen=self.capacity)
            self._rings[model] = ring
        ring.append(record)
        counts = self._counts.setdefault(model, {})
        counts[name] = counts.get(name, 0) + 1
        if attrs:
            for key in _COUNT_ATTR_KEYS:
                if key in attrs:
                    sub = f"{name}[{key}={attrs[key]}]"
                    counts[sub] = counts.get(sub, 0) + 1
            if attrs.get("degraded"):
                sub = f"{name}[degraded]"
                counts[sub] = counts.get(sub, 0) + 1

    def _drain_locked(self) -> None:
        """Move every queued event into rings/counts; caller holds lock.

        All dequeues happen here, under the lock — the writer thread
        never holds an event outside it, so a reader that drains sees
        every span enqueued before its call.
        """
        while True:
            try:
                event = self._events.get_nowait()
            except Empty:
                return
            if isinstance(event, list):     # span_many batch
                for item in event:
                    self._apply_locked(item)
            else:
                self._apply_locked(event)

    def _write_loop(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            with self._lock:
                self._drain_locked()

    # -- inspection -------------------------------------------------------

    def models(self) -> list[str]:
        with self._lock:
            self._drain_locked()
            return sorted(self._rings)

    def spans(self, model: str, name: str | None = None) -> list[dict]:
        """Spans currently held in ``model``'s ring (oldest first)."""
        with self._lock:
            self._drain_locked()
            ring = self._rings.get(model)
            records = list(ring) if ring is not None else []
        if name is not None:
            records = [r for r in records if r["name"] == name]
        return records

    def counts(self, model: str | None = None) -> dict:
        """Monotone span counts; survive ring eviction."""
        with self._lock:
            self._drain_locked()
            if model is not None:
                return dict(self._counts.get(model, {}))
            return {m: dict(c) for m, c in self._counts.items()}

    def conservation(self, model: str) -> dict:
        """Evaluate the accounting identity over monotone span counts."""
        counts = self.counts(model)
        admitted = counts.get(ADMITTED, 0)
        shed = counts.get(SHED, 0)
        terminal = sum(counts.get(name, 0) for name in TERMINAL)
        return {
            "submitted": admitted + shed,
            "admitted": admitted,
            "shed": shed,
            "served": counts.get(SERVED, 0),
            "failed": counts.get(FAILED, 0),
            "expired": counts.get(EXPIRED, 0),
            "closed": counts.get(CLOSED, 0),
            "terminal": terminal,
            "unaccounted": admitted - terminal,
        }

    # -- export -----------------------------------------------------------

    def export_jsonl(self, path, model: str | None = None) -> int:
        """Write ring-resident spans as JSONL; returns the line count."""
        models = [model] if model is not None else self.models()
        n = 0
        with open(path, "w", encoding="utf-8") as fh:
            for key in models:
                for record in self.spans(key):
                    fh.write(json.dumps(record, sort_keys=True))
                    fh.write("\n")
                    n += 1
        return n
