"""``repro_torch.serve`` — the serving surface of the port.

The same names as ``repro.serve.__all__``, less the HTTP front door:

  * ``compile_model`` (re-exported from ``repro_torch.core.families``) —
    train-time: turn an exact ``SVMModel`` into a ``CompiledArtifact``;
  * ``Runtime`` / ``ArtifactRegistry`` / ``SVMEngine`` / ``PublishSpec``
    — the serve-time Python API (``runtime``: coalescing, admission
    control, deadlines, the circuit breaker, the drift guard);
  * the error taxonomy (``ServingError`` and its subclasses), each with
    the reference's ``code`` and ``http_status``;
  * ``make_prefill_step`` / ``make_serve_step`` — the LM's prefill and
    decode steps (``decode_step``).

``create_app`` and ``serve``, the HTTP server over a ``Runtime``, wait
for the server slice of ROADMAP queue A8.
"""

from repro_torch.core.families import compile_model
from repro_torch.serve.decode_step import make_prefill_step, make_serve_step
from repro_torch.serve.runtime import (
    ArtifactCorrupt,
    ArtifactRegistry,
    BatcherClosed,
    CircuitBreaker,
    DeadlineExceeded,
    DriftGuard,
    FaultInjector,
    MicroBatcher,
    ModelNotFound,
    PublishSpec,
    Runtime,
    RuntimeOverloaded,
    ServingError,
)
from repro_torch.serve.svm_engine import (
    EngineResult,
    EngineStats,
    SliceResult,
    SVMEngine,
    bucket_size,
)

__all__ = [
    "ArtifactCorrupt",
    "ArtifactRegistry",
    "BatcherClosed",
    "CircuitBreaker",
    "DeadlineExceeded",
    "DriftGuard",
    "EngineResult",
    "EngineStats",
    "FaultInjector",
    "MicroBatcher",
    "ModelNotFound",
    "PublishSpec",
    "Runtime",
    "RuntimeOverloaded",
    "SVMEngine",
    "ServingError",
    "SliceResult",
    "bucket_size",
    "compile_model",
    "make_prefill_step",
    "make_serve_step",
]
