"""Minimal asyncio HTTP/1.1 server for the ASGI app.

The container has no uvicorn/hypercorn, so this module adapts a TCP
byte stream onto the ASGI callable with the standard library only. It
is deliberately a SUBSET of HTTP/1.1 — exactly what the wire contract
needs and nothing speculative:

  * requests with ``Content-Length`` bodies (no chunked uploads; the
    JSON contract never needs them);
  * keep-alive with pipelined sequential requests per connection;
  * bounded header block (64 KiB) and body (``wire.MAX_BODY_BYTES``),
    closing the connection on violation — malformed framing gets a
    400 and a close, never a hang;
  * concurrency by asyncio task per connection; the app itself pushes
    blocking work to the executor, so one loop thread serves many
    in-flight requests (that overlap is what feeds the micro-batcher's
    coalescing window).

``serve(app)`` runs the loop in a daemon background thread and returns
a ``ServerHandle`` — tests and the example get a real localhost server
with two lines and no external process.
"""

from __future__ import annotations

import asyncio
import threading

from repro_torch.serve.server.wire import MAX_BODY_BYTES

MAX_HEADER_BYTES = 64 << 10
_HTTP_STATUS_TEXT = {
    200: "OK", 201: "Created", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
    504: "Gateway Timeout",
}


def _reason(status: int) -> str:
    return _HTTP_STATUS_TEXT.get(status, "Unknown")


async def _handle_connection(app, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
    try:
        while True:
            try:
                head = await reader.readuntil(b"\r\n\r\n")
            except asyncio.IncompleteReadError:
                return  # client closed between requests
            except asyncio.LimitOverrunError:
                writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                             b"content-length: 0\r\nconnection: close\r\n\r\n")
                await writer.drain()
                return
            request_line, *header_lines = head.decode("latin-1").split("\r\n")
            try:
                method, target, _version = request_line.split(" ", 2)
            except ValueError:
                writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                             b"content-length: 0\r\nconnection: close\r\n\r\n")
                await writer.drain()
                return
            headers = []
            for line in header_lines:
                if not line:
                    continue
                name, _, value = line.partition(":")
                headers.append((name.strip().lower().encode("latin-1"),
                                value.strip().encode("latin-1")))
            hmap = dict(headers)
            length = int(hmap.get(b"content-length", b"0") or 0)
            if length > MAX_BODY_BYTES:
                writer.write(b"HTTP/1.1 413 Payload Too Large\r\n"
                             b"content-length: 0\r\nconnection: close\r\n\r\n")
                await writer.drain()
                return
            body = await reader.readexactly(length) if length else b""
            path, _, query = target.partition("?")
            scope = {
                "type": "http",
                "asgi": {"version": "3.0", "spec_version": "2.3"},
                "http_version": "1.1",
                "method": method.upper(),
                "path": path,
                "raw_path": target.encode("latin-1"),
                "query_string": query.encode("latin-1"),
                "headers": headers,
            }
            messages = [
                {"type": "http.request", "body": body, "more_body": False}
            ]

            async def receive():
                if messages:
                    return messages.pop(0)
                return {"type": "http.disconnect"}

            state = {"status": 500, "headers": []}
            chunks: list[bytes] = []

            async def send(message):
                if message["type"] == "http.response.start":
                    state["status"] = message["status"]
                    state["headers"] = list(message.get("headers", ()))
                elif message["type"] == "http.response.body":
                    chunks.append(message.get("body", b""))

            await app(scope, receive, send)
            payload = b"".join(chunks)
            keep = hmap.get(b"connection", b"keep-alive").lower() != b"close"
            out = [f"HTTP/1.1 {state['status']} "
                   f"{_reason(state['status'])}\r\n".encode("latin-1")]
            has_length = False
            for name, value in state["headers"]:
                if name == b"content-length":
                    has_length = True
                out.append(name + b": " + value + b"\r\n")
            if not has_length:
                out.append(f"content-length: {len(payload)}\r\n"
                           .encode("latin-1"))
            out.append(b"connection: keep-alive\r\n" if keep
                       else b"connection: close\r\n")
            out.append(b"\r\n")
            out.append(payload)
            writer.write(b"".join(out))
            await writer.drain()
            if not keep:
                return
    except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
        return
    finally:
        try:
            writer.close()
        except Exception:  # noqa: BLE001
            pass


class ServerHandle:
    """A running front door: ``host``/``port``/``url`` + ``close()``."""

    def __init__(self, host: str, port: int, loop, thread, server):
        self.host = host
        self.port = port
        self._loop = loop
        self._thread = thread
        self._server = server

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        if self._loop.is_closed():
            return

        async def _shutdown():
            self._server.close()
            await self._server.wait_closed()
            # idle keep-alive connections sit parked in readuntil();
            # cancel them so the loop stops clean instead of destroying
            # pending tasks
            me = asyncio.current_task()
            pending = [t for t in asyncio.all_tasks() if t is not me]
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)

        asyncio.run_coroutine_threadsafe(_shutdown(), self._loop).result(10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        self._loop.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve(app, host: str = "127.0.0.1", port: int = 0) -> ServerHandle:
    """Serve ``app`` on a background-thread event loop; returns a handle.

    ``port=0`` binds an ephemeral port (read it off the handle). The
    loop thread is a daemon: an un-closed handle never blocks process
    exit.
    """
    loop = asyncio.new_event_loop()
    started = threading.Event()
    box: dict = {}

    async def _start():
        server = await asyncio.start_server(
            lambda r, w: _handle_connection(app, r, w),
            host, port, limit=MAX_HEADER_BYTES,
        )
        box["server"] = server
        box["port"] = server.sockets[0].getsockname()[1]
        started.set()

    def _run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(_start())
        loop.run_forever()

    thread = threading.Thread(target=_run, name="repro-httpd", daemon=True)
    thread.start()
    if not started.wait(timeout=10):
        raise RuntimeError("HTTP server failed to start within 10s")
    return ServerHandle(host, box["port"], loop, thread, box["server"])
