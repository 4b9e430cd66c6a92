"""``repro_torch.serve`` — the serving engine, and the LM's prefill and
decode steps (``decode_step``). The runtime and the HTTP front door follow
in ROADMAP queue A8."""

from repro_torch.serve.svm_engine import (
    EngineResult,
    EngineStats,
    SliceResult,
    SVMEngine,
    bucket_size,
)

__all__ = ["EngineResult", "EngineStats", "SVMEngine", "SliceResult", "bucket_size"]
