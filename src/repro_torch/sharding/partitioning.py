"""Logical-axis -> mesh-axis partitioning rules, and placing tensors by them.

The port of ``repro/sharding/partitioning.py``. Every parameter module in
``repro_torch.models`` gives a spec tree (``LMParams.spec()``) whose leaves
are tuples of logical axis names (or None), in ``LMParams.tree()``'s
layout. This module maps those to ``PartitionSpec``s and ``NamedSharding``s
over a ``launch.mesh.Mesh``, with the reference's rules and arithmetic:

  model axis  : tensor-parallel dims (heads / kv_heads / ffn / vocab /
                experts)
  data axis   : FSDP/ZeRO-3, the "embed" dim of weight matrices
  pod axis    : pure data parallelism; weights replicated across pods

A mesh axis is consumed at most once per ``PartitionSpec`` (first logical
axis wins; later mentions degrade to replication), so specs like
("embed", "embed") stay valid.

``PartitionSpec`` is a ``tuple`` (``tuple(spec)`` compares with the
reference's), ``NamedSharding`` pairs a ``Mesh`` with one.
``device_put`` is the counterpart of ``jax.device_put`` onto a
``NamedSharding`` in the single-controller idiom of ``core.backend``'s
sharded primitives: a tensor becomes its shards, one a mesh position, each
on its position's device (``Sharded``; ``local(p)`` is position p's
block, ``replica_groups()`` the positions that hold the same one).
``axis_groups`` lists the positions that a collective along some mesh
axes joins. The rule-sharded LM steps run on those shards
(``sharding.spmd``, ``sharding.step``), with the collectives of
``sharding.collectives`` where the reference's GSPMD inserts its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh

MeshAxes = tuple[str, ...] | str | None


class PartitionSpec(tuple):
    """One mesh axis (a name), several (a tuple of names) or None a dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __reduce__(self):
        return (PartitionSpec, tuple(self))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh``: which mesh axes cut each dim of a tensor."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        named = [a for s in self.spec for a in _names(s)]
        for a in named:
            if a not in self.mesh.axis_names:
                raise ValueError(
                    f"mesh axis {a!r} of {self.spec} is not in the mesh's "
                    f"axes {self.mesh.axis_names}"
                )
        if len(set(named)) != len(named):  # as jax's DuplicateSpecError
            raise ValueError(f"{self.spec} names a mesh axis twice")

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The shape of each shard of a ``shape`` tensor; raises
        ``ValueError`` where a dim does not divide by its mesh extent
        (``launch.specs.sanitize`` drops such axes first)."""
        return tuple(size // parts for size, parts in zip(shape, self._parts(shape)))

    def dim_axes(self, ndim: int) -> list[tuple[str, ...]]:
        """The mesh axes that cut each of ``ndim`` dims (() for none)."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than {ndim} dims")
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [_names(s) for s in spec]

    def _parts(self, shape: tuple[int, ...]) -> list[int]:
        sizes = self.mesh.shape
        axes = self.dim_axes(len(shape))
        parts = [math.prod(sizes[a] for a in dim_axes) for dim_axes in axes]
        for dim, (size, n) in enumerate(zip(shape, parts)):
            if size % n:
                raise ValueError(
                    f"dim {dim} of {tuple(shape)} does not divide into {n} "
                    f"shards under {self.spec}"
                )
        return parts

    def index(self, shape: tuple[int, ...], position: int) -> tuple[slice, ...]:
        """The block of a ``shape`` tensor that mesh position ``position``
        (row-major over the mesh's axes) holds."""
        where = np.unravel_index(position, self.mesh.sizes)
        coords = dict(zip(self.mesh.axis_names, where))
        sizes = self.mesh.shape
        out = []
        cuts = zip(shape, self.dim_axes(len(shape)), self._parts(shape))
        for size, axes, parts in cuts:
            i = 0
            for a in axes:  # the first axis named is the major one
                i = i * sizes[a] + int(coords[a])
            step = size // parts
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)


def axis_groups(mesh: Mesh, axes) -> list[list[int]]:
    """The positions of ``mesh`` (row-major) that differ only along
    ``axes``: one list a group, its members ordered row-major over
    ``axes`` in the order named, which is the order ``NamedSharding.index``
    gives the blocks of a dim cut over them. No axes: each position alone."""
    axes = _names(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh axis {a!r} is not in the mesh's {mesh.axis_names}")
    others = [a for a in mesh.axis_names if a not in axes]
    order = [mesh.axis_names.index(a) for a in others + list(axes)]
    grid = np.arange(math.prod(mesh.sizes)).reshape(mesh.sizes).transpose(order)
    members = math.prod(mesh.shape[a] for a in axes)
    return [[int(p) for p in row] for row in grid.reshape(-1, members)]


def abstract_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of names and sizes with no devices: what the rule and spec
    arithmetic needs (``device_put`` onto it raises)."""
    shape, axes = tuple(int(s) for s in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up, distinct")
    return Mesh(devices=(), axis_names=axes, sizes=shape)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name -> mesh axis (or tuple of mesh axes)."""

    rules: dict[str, MeshAxes]

    def lookup(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical, None)

    def replace(self, **kv) -> "AxisRules":
        return AxisRules({**self.rules, **kv})


DEFAULT_RULES = AxisRules(
    {
        "batch": ("pod", "data"),
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "experts": "model",
        "embed": "data",  # FSDP: weight-matrix d_model dim sharded over data
        "layers": None,  # stacked-layer leading axis: never sharded
    }
)

# Tensor parallelism alone (no FSDP): for serving and small models, where
# gathering the weights each layer costs more than the memory it saves.
TP_ONLY_RULES = DEFAULT_RULES.replace(embed=None)

# Pure data parallelism over the whole mesh, weights replicated: for small
# models whose head counts do not divide the model axis.
DP_ONLY_RULES = AxisRules(
    {
        "batch": ("pod", "data", "model"),
        "layers": None,
    }
)

# Expert parallelism over the data axis: expert weights fully sharded
# (experts x data, ffn x model), tokens moved to their experts' owners.
EP_DATA_RULES = DEFAULT_RULES.replace(experts="data", embed=None)

# Sequence parallelism: the residual stream sequence-sharded over 'model'
# between blocks.
SP_RULES = DEFAULT_RULES.replace(seq="model")

# Experts over data and pure data parallelism (batch over data and model)
# for the dense parts, whose weights replicate.
EP_DP_RULES = AxisRules(
    {
        "batch": ("pod", "data", "model"),
        "experts": "data",
        "ffn": "model",
        "layers": None,
    }
)


def spec_to_pspec(spec: tuple, rules: AxisRules, mesh: Mesh) -> PartitionSpec:
    """Map one leaf spec (tuple of logical names) to a PartitionSpec."""
    used: set[str] = set()
    out = []
    for logical in spec:
        mesh_axes = rules.lookup(logical)
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        # keep only axes present in the mesh and not already consumed
        usable = tuple(a for a in mesh_axes if a in mesh.axis_names and a not in used)
        used.update(usable)
        if not usable:
            out.append(None)
        elif len(usable) == 1:
            out.append(usable[0])
        else:
            out.append(usable)
    return PartitionSpec(*out)


def _is_spec_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _never(x) -> bool:
    return False


def _names(s) -> tuple[str, ...]:
    """The mesh axes of one spec entry: None, a name or a tuple of names."""
    return () if s is None else (s,) if isinstance(s, str) else tuple(s)


def map_tree(fn: Callable, tree: Any, *rest: Any, is_leaf: Callable = _never) -> Any:
    """``fn`` at every leaf of ``tree`` (dicts, lists, tuples and named
    tuples), ``rest`` read at the same positions; ``is_leaf`` stops the
    descent early."""
    if is_leaf(tree) or not isinstance(tree, (dict, list, tuple)):
        return fn(tree, *rest)
    keys = tree.keys() if isinstance(tree, dict) else range(len(tree))
    out = {
        k: map_tree(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf) for k in keys
    }
    if isinstance(tree, dict):
        return out
    items = [out[i] for i in keys]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def param_shardings(spec_tree, rules: AxisRules, mesh: Mesh):
    """Map a spec tree to a NamedSharding tree."""
    return map_tree(
        lambda s: NamedSharding(mesh, spec_to_pspec(s, rules, mesh)),
        spec_tree,
        is_leaf=_is_spec_leaf,
    )


def param_pspecs(spec_tree, rules: AxisRules, mesh: Mesh):
    return map_tree(
        lambda s: spec_to_pspec(s, rules, mesh), spec_tree, is_leaf=_is_spec_leaf
    )


def batch_pspec(mesh: Mesh, rules: AxisRules = DEFAULT_RULES) -> PartitionSpec:
    """PartitionSpec for the leading batch dim of inputs/activations."""
    axes = rules.lookup("batch")
    if isinstance(axes, str):
        axes = (axes,)
    usable = tuple(a for a in axes if a in mesh.axis_names)
    if not usable:
        return PartitionSpec(None)
    return PartitionSpec(usable if len(usable) > 1 else usable[0])


def batch_sharding(mesh: Mesh, rules: AxisRules, global_batch: int) -> NamedSharding:
    """The sharding of a step's batch inputs: ``batch_pspec``, or
    replicated where ``global_batch`` does not divide over its axes (the
    reference's ``build_cell``)."""
    bspec = batch_pspec(mesh, rules)
    ways = math.prod(mesh.shape[a] for a in _names(bspec[0]))
    if global_batch % ways:
        return NamedSharding(mesh, PartitionSpec(None))
    return NamedSharding(mesh, bspec)


def zero1_opt_sharding(
    param_sharding: NamedSharding, shape: tuple[int, ...], mesh: Mesh
):
    """ZeRO-1: additionally shard optimizer moments over 'data' along the
    largest currently-unsharded dim (falls back to the param sharding)."""
    spec = list(param_sharding.spec) + [None] * (len(shape) - len(param_sharding.spec))
    if "data" in [a for s in spec if s for a in (s if isinstance(s, tuple) else (s,))]:
        return param_sharding
    # find largest unsharded, divisible dim
    data_size = mesh.shape.get("data", 1)
    best, best_dim = -1, -1
    for i, (s, n) in enumerate(zip(spec, shape)):
        if s is None and n % data_size == 0 and n > best:
            best, best_dim = n, i
    if best_dim < 0:
        return param_sharding
    spec[best_dim] = "data"
    return NamedSharding(mesh, PartitionSpec(*spec))


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor placed over a mesh by ``device_put``: ``shards[p]`` is the
    block mesh position ``p`` (row-major) holds, on that position's device.
    Positions along axes the spec does not name hold replicas."""

    shards: tuple[torch.Tensor, ...]
    sharding: NamedSharding
    shape: tuple[int, ...]
    dtype: torch.dtype

    def local(self, position: int) -> torch.Tensor:
        """The block mesh position ``position`` holds."""
        return self.shards[position]

    def replica_groups(self) -> list[list[int]]:
        """The positions that hold each block, one list a block, in the
        order of their first positions."""
        groups: dict[tuple, list[int]] = {}
        for p in range(len(self.shards)):
            block = tuple((s.start, s.stop) for s in self.sharding.index(self.shape, p))
            groups.setdefault(block, []).append(p)
        return list(groups.values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first by default),
        each block copied once."""
        mesh = self.sharding.mesh
        device = device or mesh.devices[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for p, shard in enumerate(self.shards):
            index = self.sharding.index(self.shape, p)
            block = tuple((s.start, s.stop) for s in index)
            if block not in seen:
                seen.add(block)
                out[index] = shard.to(out.device)
        return out

    def position_bytes(self) -> list[int]:
        """Bytes each mesh position holds."""
        return [s.numel() * s.element_size() for s in self.shards]

    def device_bytes(self) -> dict[torch.device, int]:
        """Bytes each device holds (a device that repeats in the mesh holds
        every one of its positions' shards)."""
        out: dict[torch.device, int] = {}
        for dev, nbytes in zip(self.sharding.mesh.devices, self.position_bytes()):
            out[dev] = out.get(dev, 0) + nbytes
        return out


def _place(x, sharding: NamedSharding) -> Sharded:
    if not isinstance(sharding, NamedSharding):
        got = type(sharding).__name__
        raise TypeError(f"device_put takes NamedShardings, got {got}")
    mesh = sharding.mesh
    if not mesh.devices:
        raise ValueError("device_put onto an abstract mesh, which has no devices")
    x = torch.as_tensor(x).detach()  # placed blocks carry no autograd history
    shape = tuple(x.shape)
    shards = []
    for p, dev in enumerate(mesh.devices):
        block = x[sharding.index(shape, p)]
        shard = torch.empty(block.shape, dtype=x.dtype, device=dev)
        shards.append(shard.copy_(block))
    return Sharded(tuple(shards), sharding, shape, x.dtype)


def device_put(tree, shardings):
    """Every tensor of ``tree`` placed by its ``NamedSharding`` (a tree of
    them matching ``tree``, or one for all): a tree of ``Sharded``."""
    if isinstance(shardings, NamedSharding):
        return map_tree(lambda x: _place(x, shardings), tree)
    return map_tree(_place, tree, shardings)
