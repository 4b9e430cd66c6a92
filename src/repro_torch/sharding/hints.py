"""Activation-sharding hints (logical constraints, opt-in).

The port of ``repro/sharding/hints.py``. Model code calls
``hint(x, "batch", None, "vocab")`` at the reference's layout-critical
points (the residual stream of each scanned layer, the embedding, the
logits, the MoE dispatch buffers). Outside ``use_hints`` it returns ``x``
itself. Inside, it resolves the spec exactly as the reference does
(``spec_to_pspec``, then any dim whose size does not divide its mesh
extent downgraded to replication) and hands ``x`` with that sharding to
``constrain``, which returns ``x`` unchanged.

That is all a hint can do here. A sharding constraint never changes a
value; the reference's is an instruction to XLA's partitioner, and an
eager PyTorch program on one controller has no compiler to give one to.
The rule-sharded steps (``sharding.spmd``) place their collectives
themselves, from the parameters' layout, and run no hint; the one-device
model keeps the reference's call sites, and tests watch ``constrain`` to
hold the specs they resolve against the reference's.
"""

from __future__ import annotations

import contextvars
import math
from contextlib import contextmanager

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.partitioning import (
    AxisRules,
    NamedSharding,
    PartitionSpec,
    spec_to_pspec,
)

_ACTIVE: contextvars.ContextVar[tuple[Mesh, AxisRules] | None]
_ACTIVE = contextvars.ContextVar("repro_torch_sharding_hints", default=None)


@contextmanager
def use_hints(mesh: Mesh, rules: AxisRules):
    token = _ACTIVE.set((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def resolve(
    shape: tuple[int, ...], logical: tuple, mesh: Mesh, rules: AxisRules
) -> PartitionSpec:
    """The spec a hint of ``logical`` names for a ``shape`` tensor: the
    rules' spec, each dim that does not divide by its mesh extent
    replicated."""
    spec = spec_to_pspec(tuple(logical), rules, mesh)
    fixed = []
    for dim, s in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if s is None:
            fixed.append(None)
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        extent = math.prod(mesh.shape[a] for a in axes)
        fixed.append(s if dim % extent == 0 else None)
    return PartitionSpec(*fixed)


def constrain(x, sharding: NamedSharding):
    """The counterpart of ``jax.lax.with_sharding_constraint``: ``x``, as
    it is (see the module's note)."""
    return x


def hint(x, *logical):
    active = _ACTIVE.get()
    if active is None:
        return x
    mesh, rules = active
    spec = resolve(tuple(x.shape), logical, mesh, rules)
    return constrain(x, NamedSharding(mesh, spec))
