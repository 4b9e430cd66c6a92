"""HTTP front door over ``repro_torch.serve.runtime.Runtime``, the port of
``repro.serve.server`` module for module (the same routes, wire shapes,
error codes and tenancy).

Public surface: ``create_app`` builds the ASGI application,
``serve`` runs it on a background localhost server, ``TenantConfig``
declares per-tenant quotas. Everything else in this package is wiring.
"""

from repro_torch.serve.server.app import App, create_app
from repro_torch.serve.server.httpd import ServerHandle, serve
from repro_torch.serve.server.tenancy import (
    TenantConfig,
    TenantQuotaExceeded,
    TenantTable,
    Unauthenticated,
)
from repro_torch.serve.server.wire import InvalidRequest

__all__ = [
    "App",
    "InvalidRequest",
    "ServerHandle",
    "TenantConfig",
    "TenantQuotaExceeded",
    "TenantTable",
    "Unauthenticated",
    "create_app",
    "serve",
]
