"""Observability subsystem for the serving runtime.

Three layers, one bundle:

* ``trace`` — per-request lifecycle spans with deterministic seeded
  ids, bounded per-model ring buffers, JSONL export, and monotone
  conservation counters (see ``obs/README.md`` for the id contract).
* ``metrics`` — typed counter/gauge/histogram registry with Prometheus
  text exposition (``render_prometheus()``).
* ``profile`` — opt-in ``torch.profiler.record_function`` ranges
  around engine steps and the backend dispatch seam, and a Chrome-trace
  capture.

``Observability`` ties a ``Tracer`` to a ``MetricsRegistry``; every
``Runtime`` owns one (sharing the process default metrics registry
unless given its own) and threads it through scheduler, registry, and
DriftGuard.
"""

from __future__ import annotations

import time

from repro_torch.serve.runtime.obs import profile
from repro_torch.serve.runtime.obs.metrics import (
    DEFAULT_BUCKETS,
    DEFAULT_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    render_prometheus,
)
from repro_torch.serve.runtime.obs.trace import Tracer

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "DEFAULT_REGISTRY",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Observability",
    "Tracer",
    "profile",
    "render_prometheus",
]


class Observability:
    """A tracer plus a metrics registry, threaded through one runtime.

    ``registry=None`` binds to the process default registry so the
    module-level ``render_prometheus()`` sees every runtime; pass a
    private ``MetricsRegistry()`` for isolation (tests, benchmarks).
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        capacity: int = 4096,
        registry: MetricsRegistry | None = None,
        clock=time.perf_counter,
    ):
        self.tracer = Tracer(seed=seed, capacity=capacity, clock=clock)
        self.metrics = registry if registry is not None else DEFAULT_REGISTRY

    def render_prometheus(self) -> str:
        return self.metrics.render()
