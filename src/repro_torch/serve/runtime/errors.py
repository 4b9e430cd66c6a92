"""Unified failure taxonomy for the serving stack.

Every way the runtime (or the HTTP front door over it) can refuse or
fail a request is a ``ServingError`` subclass carrying two STABLE,
machine-readable attributes:

  * ``code`` — a frozen string identifier (``"overloaded"``,
    ``"deadline_exceeded"``, ...) that wire clients may switch on.
    Codes are part of the public API: renaming one is a breaking
    change (each code and status equals ``repro``'s, so a client of
    either package reads the same wire errors).
  * ``http_status`` — the HTTP status the front door maps the error to.
    The server maps BY ATTRIBUTE (``getattr(exc, "http_status")``),
    never by an isinstance ladder, so a new error type only has to set
    the two class attributes to be wired end to end.

The taxonomy (status → type):

  * 429 ``RuntimeOverloaded`` — admission control shed the request
    before it entered the queue (bounded queue full, a tripped breaker
    with no exact model to degrade to, or a tenant quota). Carries
    ``retry_after_s``, the server's own estimate of when capacity
    returns; the front door surfaces it as a ``Retry-After`` header.
  * 504 ``DeadlineExceeded`` — the request was admitted but its
    per-submit deadline expired before a flush could serve it.
  * 503 ``BatcherClosed`` — the model's batcher was retired (shutdown,
    or an engine eviction/hot-reload); ``Runtime.submit`` retries
    internally, a bare ``MicroBatcher`` caller sees it directly.
  * 503 ``ArtifactCorrupt`` — an artifact file failed structural
    validation or its bytes no longer hash to the registered digest;
    the registry QUARANTINES the entry (no retry loop) and every
    subsequent resolve fails fast with this error.
  * 404 ``ModelNotFound`` — a ref that resolves to no registered
    digest, alias, or unique prefix (also raised for an ambiguous
    prefix). Subclasses ``KeyError`` so pre-taxonomy callers that
    caught ``KeyError`` from ``ArtifactRegistry.resolve`` keep working.
  * 500 ``InjectedFault`` — raised only by the deterministic
    fault-injection harness (``repro_torch.serve.runtime.faults``); chaos
    tests assert on this type to distinguish injected failures from
    real bugs.

The old concrete bases are preserved (``RuntimeOverloaded`` is still a
``RuntimeError``, ``DeadlineExceeded`` a ``TimeoutError``) so every
pre-taxonomy ``except`` clause keeps catching what it caught.
"""

from __future__ import annotations


class ServingError(Exception):
    """Base of the serving failure taxonomy.

    ``code`` and ``http_status`` are class attributes frozen per
    subclass; ``to_wire()`` is the canonical JSON-able error body the
    HTTP front door returns (subclasses extend it with their extra
    fields, e.g. ``retry_after_s``).
    """

    code: str = "serving_error"
    http_status: int = 500

    def to_wire(self) -> dict:
        return {
            "code": self.code,
            "status": self.http_status,
            "message": str(self),
        }


class RuntimeOverloaded(ServingError, RuntimeError):
    """Request shed by admission control; retry after ``retry_after_s``."""

    code = "overloaded"
    http_status = 429

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)

    def to_wire(self) -> dict:
        out = super().to_wire()
        out["retry_after_s"] = self.retry_after_s
        return out


class DeadlineExceeded(ServingError, TimeoutError):
    """Admitted request could not be flushed within its deadline."""

    code = "deadline_exceeded"
    http_status = 504


class BatcherClosed(ServingError, RuntimeError):
    """Raised by ``submit`` on a closed batcher (e.g. retired after an
    engine reload); ``Runtime`` re-resolves and retries on a fresh one."""

    code = "batcher_closed"
    http_status = 503


class ArtifactCorrupt(ServingError, RuntimeError):
    """Artifact file is structurally invalid or no longer matches its
    registered content digest. The entry is quarantined, not retried."""

    code = "artifact_corrupt"
    http_status = 503

    def __init__(self, message: str, *, digest: str | None = None,
                 path: str | None = None):
        super().__init__(message)
        self.digest = digest
        self.path = path

    def to_wire(self) -> dict:
        out = super().to_wire()
        if self.digest is not None:
            out["digest"] = self.digest
        return out


class ModelNotFound(ServingError, KeyError):
    """``ref`` resolves to no registered model (or is ambiguous).

    Subclasses ``KeyError`` for back-compat with callers that caught the
    registry's pre-taxonomy raise. ``__str__`` is overridden because
    ``KeyError`` quotes its args.
    """

    code = "model_not_found"
    http_status = 404

    def __init__(self, message: str, *, ref: str | None = None):
        super().__init__(message)
        self.ref = ref

    def __str__(self) -> str:
        return self.args[0] if self.args else ""

    def to_wire(self) -> dict:
        out = super().to_wire()
        if self.ref is not None:
            out["ref"] = self.ref
        return out


class InjectedFault(ServingError, RuntimeError):
    """A fault deliberately raised by the fault-injection harness."""

    code = "injected_fault"
    http_status = 500

    def __init__(self, site: str, ordinal: int):
        super().__init__(f"injected fault at {site!r} (check #{ordinal})")
        self.site = site
        self.ordinal = ordinal
