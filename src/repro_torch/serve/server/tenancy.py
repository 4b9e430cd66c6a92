"""Per-tenant admission control for the HTTP front door.

The runtime's bounded queues protect the SERVER (total work is capped);
tenancy protects tenants from EACH OTHER: an API key resolves to a
``Tenant`` whose token buckets meter requests/s and rows/s before the
request ever reaches ``Runtime.submit``. The layering is deliberate —
a tenant-shed request costs one dict lookup and two float compares,
never an engine, a queue slot, or a numpy parse of a giant body.

Sheds here are still SHEDS in the one true accounting: the predict
route records a tenant-quota shed into the model's ``ModelTelemetry``
and emits a ``request.shed`` span, so ``Tracer.conservation`` holds
(submitted == admitted + shed) whether the shed came from a full queue,
a tripped breaker, or a tenant quota. ``TenantQuotaExceeded`` subclasses
``RuntimeOverloaded``: same HTTP 429, same ``Retry-After`` machinery,
distinct stable ``code`` so clients can tell "server is busy" from
"YOU are over quota".

Token buckets take an injectable ``clock`` so tests refill time
deterministically instead of sleeping.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from repro_torch.serve.runtime.errors import RuntimeOverloaded, ServingError
from repro_torch.serve.server.wire import InvalidRequest

API_KEY_HEADER = "x-api-key"


class Unauthenticated(ServingError):
    """No/unknown API key on a server that has tenants configured."""

    code = "unauthenticated"
    http_status = 401


class TenantQuotaExceeded(RuntimeOverloaded):
    """Tenant-level token bucket empty; retry after ``retry_after_s``.

    A ``RuntimeOverloaded`` (same 429 + ``Retry-After`` path), with its
    own ``code`` and the offending quota named in ``quota``.
    """

    code = "tenant_quota"

    def __init__(self, message: str, retry_after_s: float = 0.0, *,
                 tenant: str = "", quota: str = ""):
        super().__init__(message, retry_after_s)
        self.tenant = tenant
        self.quota = quota

    def to_wire(self) -> dict:
        out = super().to_wire()
        out["tenant"] = self.tenant
        out["quota"] = self.quota
        return out


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s, capacity ``burst``.

    ``take(n)`` either debits n tokens and returns 0.0, or debits
    nothing and returns the seconds until n tokens will exist — the
    caller's ``Retry-After``. A request for more than ``burst`` tokens
    can never succeed; ``take`` reports the refill time for the full
    burst so the caller still gets a finite hint.
    """

    def __init__(self, rate: float, burst: float, *, clock=time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate and burst must be > 0, got {rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = self.burst
        self._stamp = clock()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> float:
        with self._lock:
            now = self.clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            need = min(n, self.burst) - self._tokens
            return need / self.rate


@dataclasses.dataclass
class TenantConfig:
    """Declarative limits for one tenant (all Nones = unlimited)."""

    name: str
    api_key: str
    rate_rps: float | None = None  # request token bucket: rate
    burst: float | None = None  # ... capacity (default 2*rate)
    rows_per_s: float | None = None  # row token bucket: rate
    row_burst: float | None = None  # ... capacity (default 2*rate)
    max_rows: int | None = None  # hard per-request row cap (400)


class Tenant:
    """Live admission state for one configured tenant."""

    def __init__(self, cfg: TenantConfig, *, clock=time.monotonic):
        self.cfg = cfg
        self.name = cfg.name
        self.requests = TokenBucket(
            cfg.rate_rps, cfg.burst or 2 * cfg.rate_rps, clock=clock
        ) if cfg.rate_rps else None
        self.rows = TokenBucket(
            cfg.rows_per_s, cfg.row_burst or 2 * cfg.rows_per_s, clock=clock
        ) if cfg.rows_per_s else None
        self._lock = threading.Lock()
        self.admitted = 0
        self.shed = 0
        self.admitted_rows = 0
        self.shed_rows = 0

    def admit(self, n_rows: int) -> None:
        """Debit both buckets or raise ``TenantQuotaExceeded``.

        Request-then-rows order with a refund: if the request token is
        taken but the row bucket refuses, the request token is NOT
        returned (the tenant did make a request) — but the row bucket
        was never debited, so a smaller retry is not double-charged.
        """
        cfg = self.cfg
        if cfg.max_rows is not None and n_rows > cfg.max_rows:
            raise InvalidRequest(
                f"request of {n_rows} rows exceeds tenant {self.name!r} "
                f"per-request cap of {cfg.max_rows}"
            )
        retry = self.requests.take(1.0) if self.requests else 0.0
        quota = "rate_rps"
        if retry == 0.0 and self.rows is not None:
            retry = self.rows.take(float(n_rows))
            quota = "rows_per_s"
        if retry > 0.0:
            with self._lock:
                self.shed += 1
                self.shed_rows += n_rows
            raise TenantQuotaExceeded(
                f"tenant {self.name!r} over {quota} quota; "
                f"retry in {retry:.3f}s",
                retry, tenant=self.name, quota=quota,
            )
        with self._lock:
            self.admitted += 1
            self.admitted_rows += n_rows

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "admitted": self.admitted,
                "shed": self.shed,
                "admitted_rows": self.admitted_rows,
                "shed_rows": self.shed_rows,
                "limits": {
                    "rate_rps": self.cfg.rate_rps,
                    "rows_per_s": self.cfg.rows_per_s,
                    "max_rows": self.cfg.max_rows,
                },
            }


class TenantTable:
    """API key → ``Tenant`` resolution.

    With no tenants configured the server is OPEN: every request maps
    to one implicit unlimited ``public`` tenant (the single-user dev
    loop should not need key management). With ANY tenant configured,
    authentication is mandatory — an unknown or missing key is 401,
    never a silent fall-through to public.
    """

    def __init__(self, tenants=None, *, clock=time.monotonic):
        self._by_key: dict[str, Tenant] = {}
        self._public = Tenant(TenantConfig(name="public", api_key=""),
                              clock=clock)
        for cfg in tenants or ():
            if cfg.api_key in self._by_key:
                raise ValueError(
                    f"duplicate api_key for tenant {cfg.name!r}"
                )
            self._by_key[cfg.api_key] = Tenant(cfg, clock=clock)

    @property
    def open(self) -> bool:
        return not self._by_key

    def resolve(self, api_key: str | None) -> Tenant:
        if self.open:
            return self._public
        if not api_key:
            raise Unauthenticated(
                f"missing {API_KEY_HEADER!r} header (server has tenants "
                f"configured)"
            )
        tenant = self._by_key.get(api_key)
        if tenant is None:
            raise Unauthenticated("unknown API key")
        return tenant

    def snapshot(self) -> dict:
        tenants = [self._public] if self.open else list(self._by_key.values())
        return {
            "open": self.open,
            "tenants": [t.snapshot() for t in tenants],
        }
