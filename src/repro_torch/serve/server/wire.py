"""Wire schemas for the HTTP front door.

One module owns every JSON shape that crosses the network, so the
contract documented in ``serve/server/README.md`` has exactly one
implementation to drift from. Two rules govern the shapes:

  * **Errors are the taxonomy.** Every error body is
    ``{"error": ServingError.to_wire()}`` — the stable ``code`` /
    ``status`` / ``message`` triple (plus per-type extras such as
    ``retry_after_s``). Malformed requests raise ``InvalidRequest``,
    which is itself a ``ServingError`` (code ``invalid_request``,
    HTTP 400), so the app's single attribute-based error mapper covers
    client mistakes and runtime sheds alike.
  * **Predictions carry the §4 verdicts.** A predict response is not
    just scores: every row ships its run-time validity bit (the
    paper's certificate that the fast path was trustworthy for THAT
    row), the serving digest (so a client can pin what scored it),
    and the model's family/dtype provenance.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.serve.runtime.errors import ServingError

# Request bodies are bounded: a predict payload is rows of floats, a
# publish payload is one artifact — 64 MiB covers both with headroom
# while keeping a malicious body from ballooning the process.
MAX_BODY_BYTES = 64 << 20


class InvalidRequest(ServingError, ValueError):
    """Malformed request body / params — the client's bug, HTTP 400."""

    code = "invalid_request"
    http_status = 400


@dataclasses.dataclass
class Request:
    """One parsed HTTP request, transport-agnostic (the ASGI app and
    the stdlib socket adapter both build exactly this)."""

    method: str
    path: str
    headers: dict  # lower-cased names -> values
    body: bytes = b""


@dataclasses.dataclass
class Response:
    """One response; ``headers`` are extras beyond Content-Type/-Length."""

    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: tuple = ()


def parse_json(body: bytes) -> dict:
    if not body:
        raise InvalidRequest("empty body; expected a JSON object")
    try:
        data = json.loads(body)
    except ValueError as e:
        raise InvalidRequest(f"body is not valid JSON: {e}") from e
    if not isinstance(data, dict):
        raise InvalidRequest(
            f"expected a JSON object, got {type(data).__name__}"
        )
    return data


def parse_predict(data: dict) -> tuple[np.ndarray, float | None]:
    """``{"rows": [[...], ...], "deadline_s": 0.5?}`` → (Z, deadline_s).

    Rows must be a non-empty rectangular 2-D array of finite-parseable
    numbers; shape errors fail here with a 400, not deep in the engine
    with a 500.
    """
    if "rows" not in data:
        raise InvalidRequest('missing "rows": expected [[...], ...]')
    rows = data["rows"]
    try:
        Z = np.asarray(rows, dtype=np.float64)
    except (TypeError, ValueError) as e:
        raise InvalidRequest(f'"rows" is not numeric: {e}') from e
    if Z.ndim == 1 and Z.size:
        Z = Z[None, :]  # single row convenience
    if Z.ndim != 2 or Z.shape[0] == 0 or Z.shape[1] == 0:
        raise InvalidRequest(
            f'"rows" must be a non-empty 2-D array, got shape {Z.shape}'
        )
    deadline_s = data.get("deadline_s")
    if deadline_s is not None:
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError) as e:
            raise InvalidRequest(f'"deadline_s" is not a number: {e}') from e
        if deadline_s <= 0:
            raise InvalidRequest(f'"deadline_s" must be > 0, got {deadline_s}')
    return Z, deadline_s


def predict_response(digest: str, values, valid, labels, *,
                     family: str = "", dtype: str = "") -> dict:
    """The scoring contract: per-row scores + §4 validity + provenance."""
    return {
        "digest": digest,
        "family": family,
        "dtype": dtype,
        "n": int(np.asarray(values).shape[0]),
        "scores": np.asarray(values).tolist(),
        "labels": np.asarray(labels).tolist(),
        "valid": [bool(v) for v in np.asarray(valid)],
    }


def error_body(exc: ServingError) -> dict:
    return {"error": exc.to_wire()}


def dump_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True).encode("utf-8")
