"""``create_app`` — the ASGI 3 application over a ``Runtime``.

The app is a plain ASGI callable (``await app(scope, receive, send)``)
with no framework dependency: CI images do not ship FastAPI, and the
surface is small enough that the standard protocol IS the framework.
It composes the other modules — ``routes`` for handlers, ``wire`` for
shapes, ``tenancy`` for admission — and owns exactly two concerns:

  * **routing** — a literal table of ``(method, pattern)`` pairs where
    a pattern segment ``{ref}`` captures one path segment. Google-style
    custom verbs (``/v1/models/{ref}:predict``) keep actions on a
    resource without overloading POST semantics.
  * **error mapping** — one ``except Exception`` around dispatch that
    maps BY ATTRIBUTE: anything carrying ``http_status``/``to_wire``
    (i.e. any ``ServingError``, including ones that do not exist yet)
    becomes ``{"error": {code, status, message, ...}}`` with its
    status; a 429 with ``retry_after_s`` grows a ``Retry-After``
    header. There is deliberately no isinstance ladder to extend —
    defining a new error type IS wiring it end to end.

Everything else (HTTP parsing, sockets) lives in ``httpd``, which
adapts a TCP byte stream onto this same callable.
"""

from __future__ import annotations

import math
import tempfile

from repro_torch.serve.runtime.runtime import Runtime
from repro_torch.serve.server import routes
from repro_torch.serve.server.tenancy import TenantTable
from repro_torch.serve.server.wire import (
    MAX_BODY_BYTES,
    InvalidRequest,
    Request,
    Response,
    dump_json,
    error_body,
)

_ROUTES = (
    ("GET", "/healthz", routes.healthz),
    ("GET", "/metrics", routes.metrics),
    ("GET", "/v1/models", routes.list_models),
    ("POST", "/v1/models", routes.publish),
    ("GET", "/v1/stats", routes.runtime_stats),
    ("GET", "/v1/tenants", routes.tenants),
    ("POST", "/v1/models/{ref}:predict", routes.predict),
    ("POST", "/v1/models/{ref}:alias", routes.set_alias),
    ("POST", "/v1/models/{ref}:replicas", routes.set_replicas),
    ("POST", "/v1/models/{ref}:evict", routes.evict),
    ("GET", "/v1/models/{ref}/stats", routes.stats),
)


def _match(pattern: str, path: str):
    """Match ``path`` against ``pattern``; ``{name}`` captures one
    segment (including a ``:verb`` suffix when the pattern has one).
    Returns the captured args tuple or None."""
    pparts = pattern.split("/")
    parts = path.split("/")
    if len(pparts) != len(parts):
        return None
    args = []
    for pp, p in zip(pparts, parts):
        if pp.startswith("{"):
            close = pp.index("}")
            suffix = pp[close + 1:]  # e.g. ":predict" or ""
            if suffix:
                if not p.endswith(suffix):
                    return None
                p = p[: -len(suffix)]
            if not p:
                return None
            args.append(p)
        elif pp != p:
            return None
    return tuple(args)


class App:
    """ASGI 3 callable serving one ``Runtime``.

    ``app.runtime`` / ``app.tenants`` / ``app.spool_dir`` are the state
    the handlers in ``routes`` read. The app does not own the runtime's
    lifetime unless it created it (``create_app`` with no runtime):
    then ``close()`` tears the runtime down too.
    """

    def __init__(self, runtime: Runtime, tenants: TenantTable,
                 spool_dir: str, *, owns_runtime: bool):
        self.runtime = runtime
        self.tenants = tenants
        self.spool_dir = spool_dir
        self._owns_runtime = owns_runtime

    # -- dispatch ----------------------------------------------------------

    async def handle(self, request: Request) -> Response:
        """Route + run one request; every failure becomes a wire error."""
        try:
            found_path = False
            for method, pattern, handler in _ROUTES:
                args = _match(pattern, request.path)
                if args is None:
                    continue
                found_path = True
                if method == request.method:
                    return await handler(self, request, *args)
            if found_path:
                return self._error_response(
                    405, {"error": {
                        "code": "method_not_allowed", "status": 405,
                        "message": f"{request.method} not allowed on "
                                   f"{request.path}",
                    }})
            return self._error_response(
                404, {"error": {
                    "code": "not_found", "status": 404,
                    "message": f"no route for {request.path}",
                }})
        except Exception as exc:  # noqa: BLE001
            return self._map_exception(exc)

    def _map_exception(self, exc: Exception) -> Response:
        status = getattr(exc, "http_status", None)
        to_wire = getattr(exc, "to_wire", None)
        if status is None or to_wire is None:
            body = {"error": {
                "code": "internal", "status": 500,
                "message": f"{type(exc).__name__}: {exc}",
            }}
            return self._error_response(500, body)
        headers = ()
        retry = getattr(exc, "retry_after_s", None)
        if retry is not None:
            # integral per RFC 9110; at least 1 so a client that honors
            # it literally cannot busy-loop
            headers = (("Retry-After", str(max(1, math.ceil(retry)))),)
        return self._error_response(int(status), error_body(exc), headers)

    @staticmethod
    def _error_response(status: int, body: dict, headers: tuple = ()):
        return Response(status=status, body=dump_json(body), headers=headers)

    # -- ASGI --------------------------------------------------------------

    async def __call__(self, scope, receive, send) -> None:
        if scope["type"] == "lifespan":  # accept, do nothing
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported ASGI scope {scope['type']!r}")
        headers = {
            k.decode("latin-1").lower(): v.decode("latin-1")
            for k, v in scope.get("headers", ())
        }
        body = bytearray()
        while True:
            msg = await receive()
            if msg["type"] != "http.request":
                break
            body.extend(msg.get("body", b""))
            if len(body) > MAX_BODY_BYTES:
                resp = self._map_exception(InvalidRequest(
                    f"body exceeds {MAX_BODY_BYTES} bytes"
                ))
                await self._send_response(send, resp)
                return
            if not msg.get("more_body"):
                break
        request = Request(
            method=scope["method"],
            path=scope["path"],
            headers=headers,
            body=bytes(body),
        )
        resp = await self.handle(request)
        await self._send_response(send, resp)

    @staticmethod
    async def _send_response(send, resp: Response) -> None:
        headers = [
            (b"content-type", resp.content_type.encode("latin-1")),
            (b"content-length", str(len(resp.body)).encode("latin-1")),
        ]
        for name, value in resp.headers:
            headers.append(
                (name.encode("latin-1").lower(), value.encode("latin-1"))
            )
        await send({"type": "http.response.start", "status": resp.status,
                    "headers": headers})
        await send({"type": "http.response.body", "body": resp.body})

    # -- lifetime ----------------------------------------------------------

    def close(self) -> None:
        if self._owns_runtime:
            self.runtime.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def create_app(
    runtime: Runtime | None = None,
    *,
    tenants=None,
    spool_dir: str | None = None,
    **runtime_kw,
) -> App:
    """Build the front door.

    ``runtime=None`` creates one (any ``runtime_kw`` — ``max_wait_us``,
    ``max_queue_rows``, ... — are forwarded) and ties its lifetime to
    the app; passing a runtime leaves its lifetime with the caller. The
    runtime's engines run on the card unless ``engine_opts`` names the
    CPU: without a card, publishing to such a runtime raises.
    ``tenants`` is an iterable of ``TenantConfig``; none ⇒ open server.
    ``spool_dir`` receives uploaded artifacts (default: a fresh temp
    directory).
    """
    owns = runtime is None
    if runtime is None:
        runtime = Runtime(**runtime_kw)
    elif runtime_kw:
        raise TypeError(
            f"runtime_kw {sorted(runtime_kw)} only apply when create_app "
            f"builds the runtime"
        )
    if spool_dir is None:
        spool_dir = tempfile.mkdtemp(prefix="repro-artifact-spool-")
    table = tenants if isinstance(tenants, TenantTable) \
        else TenantTable(tenants)
    return App(runtime, table, spool_dir, owns_runtime=owns)
