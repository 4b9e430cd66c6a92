"""Multi-tenant serving runtime: many models × many concurrent callers.

The layer a service under heavy traffic needs on top of ``SVMEngine``,
ported from ``repro.serve.runtime`` module for module (same classes,
same error codes, same metric names):

  * ``ArtifactRegistry`` — content-addressed model store (SHA-256 of the
    deterministic artifact bytes), named aliases with atomic hot-swap,
    lazy directory loads, LRU engine eviction under a memory budget,
    corruption quarantine (``ArtifactCorrupt``) with SHA re-verification
    on every load from disk;
  * ``MicroBatcher`` — async scheduler coalescing concurrent small
    requests into the engine's power-of-two buckets (flush on bucket
    fill or ``max_wait_us`` deadline), scattering results back to
    per-request futures without losing the engine's deferred-sync or
    zero-recompile properties; bounded-queue admission control
    (``RuntimeOverloaded``), per-submit deadlines (``DeadlineExceeded``),
    and a per-model ``CircuitBreaker`` that degrades repeated engine
    failures to the exact streaming ``rbf_pred`` path;
  * ``Runtime`` — the front door (``submit(model, Z) -> future``),
    per-model telemetry (p50/p99, queue depth, coalescing factor,
    fallback rate, evictions, shed/timeout/failure/breaker counters);
  * ``DriftGuard`` — the self-healing loop: windowed fallback-rate
    watch, reservoir-sampled recompile, exact-RBF canary, atomic alias
    flip;
  * ``FaultInjector`` — deterministic chaos harness (seeded engine
    faults, slow steps, registry load failures, file corruption).
"""

from repro_torch.serve.runtime.errors import (
    ArtifactCorrupt,
    BatcherClosed,
    DeadlineExceeded,
    InjectedFault,
    ModelNotFound,
    RuntimeOverloaded,
    ServingError,
)
from repro_torch.serve.runtime.faults import ENGINE_STEP, REGISTRY_LOAD, FaultInjector
from repro_torch.serve.runtime.guard import DriftGuard, ReservoirSampler
from repro_torch.serve.runtime.obs import (
    MetricsRegistry,
    Observability,
    Tracer,
    render_prometheus,
)
from repro_torch.serve.runtime.publish import PublishSpec
from repro_torch.serve.runtime.registry import ArtifactRegistry, RegistryEntry
from repro_torch.serve.runtime.runtime import Runtime
from repro_torch.serve.runtime.scheduler import CircuitBreaker, MicroBatcher
from repro_torch.serve.runtime.telemetry import LatencyWindow, ModelTelemetry

__all__ = [
    "ENGINE_STEP",
    "REGISTRY_LOAD",
    "ArtifactCorrupt",
    "ArtifactRegistry",
    "BatcherClosed",
    "CircuitBreaker",
    "DeadlineExceeded",
    "DriftGuard",
    "FaultInjector",
    "InjectedFault",
    "LatencyWindow",
    "MetricsRegistry",
    "MicroBatcher",
    "ModelNotFound",
    "ModelTelemetry",
    "Observability",
    "PublishSpec",
    "RegistryEntry",
    "ReservoirSampler",
    "Runtime",
    "RuntimeOverloaded",
    "ServingError",
    "Tracer",
    "render_prometheus",
]
