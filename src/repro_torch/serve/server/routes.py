"""Route handlers for the HTTP front door.

Every handler is ``async def handler(app, req, *path_params) ->
Response`` and raises ``ServingError`` subclasses for every refusal —
the app's single error mapper turns them into wire bodies, so no
handler ever builds an error response by hand.

Anything that takes a runtime lock or touches a device runs in the
loop's default executor via ``_off_loop``; the event loop only ever
shuffles parsed JSON.

The one subtle handler is ``predict``, whose ORDER of refusals is the
accounting contract:

  1. parse (400) — a malformed body is not a submitted request;
  2. authenticate (401) — an unknown key is nobody's traffic;
  3. resolve the ref (404) — sheds must attach to a real digest;
  4. tenant admission (429) — a quota shed is recorded into the
     digest's ``ModelTelemetry`` and traced as a ``request.shed`` span
     BEFORE the error propagates, so ``Tracer.conservation`` counts it
     exactly like a queue-full shed;
  5. ``bridge.submit`` — runtime refusals (429/503/504) flow through
     untouched; the batcher already accounted for them.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import hashlib
import os

from repro_torch.serve.runtime.obs import trace
from repro_torch.serve.runtime.publish import PublishSpec
from repro_torch.serve.server import bridge, wire
from repro_torch.serve.server.tenancy import TenantQuotaExceeded
from repro_torch.serve.server.wire import InvalidRequest, Response


async def _off_loop(fn, *args):
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: fn(*args)
    )


def _json(obj, status: int = 200) -> Response:
    return Response(status=status, body=wire.dump_json(obj))


# ------------------------------------------------------------------ scoring

async def predict(app, req, ref: str) -> Response:
    data = wire.parse_json(req.body)
    Z, deadline_s = wire.parse_predict(data)
    n = int(Z.shape[0])
    tenant = app.tenants.resolve(req.headers.get("x-api-key"))
    digest = await _off_loop(app.runtime.registry.resolve, ref)
    try:
        tenant.admit(n)
    except TenantQuotaExceeded as e:
        await _off_loop(_account_tenant_shed, app.runtime, digest, n,
                        tenant.name, e.retry_after_s)
        raise
    values, valid, labels = await bridge.submit(
        app.runtime, digest, Z, deadline_s=deadline_s
    )
    entry = app.runtime.registry._entries.get(digest)
    engine = entry.engine if entry is not None else None
    return _json(wire.predict_response(
        digest, values, valid, labels,
        family=getattr(engine, "family", ""),
        dtype=getattr(engine, "dtype", ""),
    ))


def _account_tenant_shed(runtime, digest: str, rows: int, tenant: str,
                         retry_after_s: float) -> None:
    """A tenant-quota shed is a shed: same telemetry counter, same span
    name, same conservation identity as a queue-full shed."""
    runtime.telemetry(digest).record_shed(rows)
    if runtime.obs is not None:
        runtime.obs.tracer.span(
            digest[:12], trace.SHED,
            attrs={"rows": rows, "retry_after_s": retry_after_s,
                   "tenant": tenant, "reason": "tenant_quota"},
        )


# --------------------------------------------------------------- management

async def list_models(app, req) -> Response:
    models = await _off_loop(app.runtime.registry.list_models)
    return _json({"models": models})


async def publish(app, req) -> Response:
    """``POST /v1/models`` — publish an artifact, return its digest.

    Body: ``{"artifact_b64": <base64 npz bytes>, "spec": {...}}`` or
    ``{"path": <server-visible file>, "spec": {...}}``. Uploaded bytes
    are spooled to the app's spool directory and indexed via
    ``add_file`` so they get the same structural validation + content
    addressing as any on-disk artifact (a corrupt upload is rejected
    with 503 ``artifact_corrupt`` and never acquires an identity).
    """
    data = wire.parse_json(req.body)
    spec = PublishSpec.from_wire(data.get("spec") or {})
    if ("artifact_b64" in data) == ("path" in data):
        raise InvalidRequest(
            'expected exactly one of "artifact_b64" or "path"'
        )
    if "artifact_b64" in data:
        try:
            raw = base64.b64decode(data["artifact_b64"], validate=True)
        except (binascii.Error, TypeError) as e:
            raise InvalidRequest(f'"artifact_b64" is not base64: {e}') from e
        path = os.path.join(
            app.spool_dir, hashlib.sha256(raw).hexdigest() + ".npz"
        )
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)  # atomic: no torn spool files
    else:
        path = str(data["path"])
        if not os.path.isfile(path):
            raise InvalidRequest(f"no such artifact file: {path}")
    digest = await _off_loop(app.runtime.registry.add_file, path, spec)
    return _json({"digest": digest, "spec": spec.to_wire()}, status=201)


async def set_alias(app, req, ref: str) -> Response:
    data = wire.parse_json(req.body)
    alias = data.get("alias")
    if not alias or not isinstance(alias, str):
        raise InvalidRequest('expected {"alias": "<name>"}')
    digest = await _off_loop(app.runtime.set_alias, alias, ref)
    return _json({"alias": alias, "digest": digest})


async def set_replicas(app, req, ref: str) -> Response:
    data = wire.parse_json(req.body)
    try:
        n = int(data["replicas"])
    except (KeyError, TypeError, ValueError) as e:
        raise InvalidRequest('expected {"replicas": <int >= 1>}') from e
    if n < 1:
        raise InvalidRequest(f"replicas must be >= 1, got {n}")
    digest = await _off_loop(app.runtime.registry.set_replicas, ref, n)
    return _json({"digest": digest, "replicas": n})


async def evict(app, req, ref: str) -> Response:
    digest = await _off_loop(app.runtime.registry.evict, ref)
    return _json({"digest": digest, "evicted": True})


# ------------------------------------------------------------ observability

async def stats(app, req, ref: str) -> Response:
    return _json(await _off_loop(app.runtime.stats, ref))

async def runtime_stats(app, req) -> Response:
    return _json(await _off_loop(app.runtime.stats))


async def metrics(app, req) -> Response:
    text = await _off_loop(app.runtime.render_prometheus)
    return Response(
        body=text.encode("utf-8"),
        content_type="text/plain; version=0.0.4; charset=utf-8",
    )


async def tenants(app, req) -> Response:
    return _json(app.tenants.snapshot())


async def healthz(app, req) -> Response:
    return _json({"ok": True})
