"""``PublishSpec`` — the one shape a model publication takes.

Before the HTTP front door, publication options had drifted across
layers: ``Runtime.publish`` took ``exact=``/``replicas=``,
``ArtifactRegistry.register`` additionally took ``alias=``/``path=``,
and warmup policy lived on the registry constructor only. A wire API
cannot serialize "whichever kwargs this layer grew", so publication is
now a single dataclass that the Python API, the HTTP management API,
and the tests all speak:

    spec = PublishSpec(alias="detector", replicas=2, warmup=True)
    runtime.publish("detector", artifact, spec=spec)       # python
    POST /v1/models {"artifact_b64": ..., "spec": spec}    # wire

``to_wire()``/``from_wire()`` define the JSON projection. ``exact``
(the fallback ``SVMModel`` object) is deliberately NOT wire-serializable
— a remote client cannot ship a live training object; it stays a
Python-API-only field and ``to_wire`` records only its presence.

The old per-layer kwargs (``Runtime.publish(alias, art, exact=m,
replicas=2)``) are DEPRECATED but still accepted for one release: they
are folded into a spec internally and raise a ``DeprecationWarning``.
Passing both a spec and old kwargs is an error — there must be exactly
one source of truth per call.
"""

from __future__ import annotations

import dataclasses
import warnings

_WIRE_FIELDS = ("alias", "replicas", "warmup", "path")


@dataclasses.dataclass(frozen=True)
class PublishSpec:
    """Options for one model publication, identical across API layers.

    Every field defaults to ``None`` = "leave the current/registry
    default alone", so a plain re-register never silently collapses a
    scaled-out model or flips warmup policy.

      * ``alias`` — mutable name to (atomically) point at the digest.
      * ``replicas`` — engines to build from this digest (>= 1).
      * ``warmup`` — per-model override of the registry's
        ``warmup_on_load`` (pre-compile every bucket variant at build).
      * ``path`` — file backing the artifact (makes the entry
        evictable + reloadable under the memory budget).
      * ``exact`` — fallback ``SVMModel`` for breaker-open degraded
        serving and per-row out-of-envelope rescoring. Python API only;
        never crosses the wire.
    """

    alias: str | None = None
    replicas: int | None = None
    warmup: bool | None = None
    path: str | None = None
    exact: object | None = None

    def __post_init__(self):
        if self.replicas is not None and int(self.replicas) < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")

    def to_wire(self) -> dict:
        """JSON-able projection (drops ``exact``; records its presence)."""
        out = {k: getattr(self, k) for k in _WIRE_FIELDS
               if getattr(self, k) is not None}
        if self.exact is not None:
            out["has_exact"] = True
        return out

    @classmethod
    def from_wire(cls, data: dict) -> "PublishSpec":
        """Parse the wire projection; unknown keys are rejected so a
        typo'd field fails loudly instead of silently defaulting."""
        if not isinstance(data, dict):
            raise TypeError(f"spec must be an object, got {type(data).__name__}")
        unknown = set(data) - set(_WIRE_FIELDS) - {"has_exact"}
        if unknown:
            raise ValueError(f"unknown PublishSpec fields {sorted(unknown)}; "
                             f"known: {list(_WIRE_FIELDS)}")
        kw = {}
        if data.get("alias") is not None:
            kw["alias"] = str(data["alias"])
        if data.get("replicas") is not None:
            kw["replicas"] = int(data["replicas"])
        if data.get("warmup") is not None:
            kw["warmup"] = bool(data["warmup"])
        if data.get("path") is not None:
            kw["path"] = str(data["path"])
        return cls(**kw)


def resolve_spec(spec: PublishSpec | None, *, caller: str,
                 **legacy) -> PublishSpec:
    """Fold deprecated per-layer kwargs into one ``PublishSpec``.

    ``spec`` given → legacy kwargs must all be None (one source of
    truth). Legacy kwargs given → DeprecationWarning naming the caller,
    then folded. Neither → an empty spec (all defaults).
    """
    used = {k: v for k, v in legacy.items() if v is not None}
    if spec is not None:
        if used:
            raise TypeError(
                f"{caller}: pass either spec= or the legacy kwargs "
                f"({sorted(used)}), not both"
            )
        if not isinstance(spec, PublishSpec):
            raise TypeError(f"{caller}: spec must be a PublishSpec, "
                            f"got {type(spec).__name__}")
        return spec
    if used:
        warnings.warn(
            f"{caller}: the {sorted(used)} kwargs are deprecated; pass "
            f"spec=PublishSpec(...) (one shape across the Python and "
            f"HTTP APIs)",
            DeprecationWarning,
            stacklevel=3,
        )
    return PublishSpec(**used)
