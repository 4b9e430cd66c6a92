"""Collectives over a group of mesh positions, as peer copies and adds.

What GSPMD inserts into the reference's partitioned steps, written out for
the port's single-controller mesh (``launch.mesh``): every function takes
one tensor a member of a group, in the group's order (``partitioning.
axis_groups``), each on its member's device, and returns one a member.

Every reduction is spread over the members, as GSPMD's collectives are:
member j owns chunk j of the result (the first dim that the members cut
evenly), receives chunk j of every member's tensor and adds the chunks on
its own device, in the group's order (a reduce-scatter is that step
alone); an all-reduce then copies every chunk from its owner straight into
each member's result, and an all-gather copies every member's tensor into
each member's result. So every member sends, receives and adds the same
share, every element is added in the group's order and replicas come out
bit for bit equal. A tensor that no dim splits evenly (the loss and norm
scalars) is still added on the first member and copied to each. A class
trace (``spmd.Lockstep``'s ``run``) makes a stand-in of a chunk or a
result whose member it does not run, and only the copies that members it
runs send or receive: a member it runs does O(g) operations a collective.
Nothing goes through NCCL: it refuses a communicator in which one card
appears twice, which a mesh of slots of one card is, and
``torch.cuda.nccl`` has no all-to-all. One route for every placement
keeps the CPU and the card on the same code.

Each collective with a gradient is an ``autograd.Function`` whose backward
is its forward's conjugate (the exact vector-Jacobian product of the
members' tensors): all-gather and reduce-scatter are each other's,
all-to-all's is its inverse, and the all-reduce's is itself. The sharded
steps count each data group's loss once and sum each parameter's gradient
over its replicas afterwards, so a value replicated over a group carries
a share of its gradient on each member, and the all-reduce's backward
adds those shares: Megatron's pair of "g" (all-reduce, then identity) and
"f" (identity, then all-reduce), which assumes every replica seeds the
whole loss, composes to it. ``all_max`` and ``gather`` carry no custom
backward: the max is taken on values a caller detaches, and ``gather`` is
copies and a concatenation, which autograd differentiates itself.

``OBSERVERS`` (empty unless a cost recorder runs: ``launch.op_cost``)
hear of each collective of two members or more once, backward ones
included, under the reference's kinds ("all-reduce", "all-gather",
"reduce-scatter", "all-to-all") or their own ("gather", "all-max", and
"reduce" for a ``sum_in_order`` that no other collective called, a sum
of scalars on the first member): the kind, the members' devices and the
bytes of each member's result (the gathered whole on the first member for
"gather" and "reduce"), as the reference's HLO gives a collective's
result shape.
"""

from __future__ import annotations

import threading

import torch
from torch.autograd import Function

OBSERVERS: list = []  # callables (kind, members' places, result bytes a member)
_inside = threading.local()  # set while a noted collective runs
_quiet = threading.local()  # set while a stand-in is made


def quiet() -> bool:
    """Whether the op now dispatched makes a stand-in (no recorder counts
    it)."""
    return getattr(_quiet, "on", False)


def stand_in(like, device, position: int) -> torch.Tensor:
    """A tensor of ``like``'s shape, strides and dtype (a tensor, or a
    (shape, dtype) pair: contiguous) on ``device``, with no values set,
    standing for mesh position ``position``'s tensor."""
    _quiet.on = True
    try:
        if isinstance(like, torch.Tensor):
            t = torch.empty_strided(like.shape, like.stride(), dtype=like.dtype, device=device)
        else:
            t = torch.empty(like[0], dtype=like[1], device=device)
    finally:
        _quiet.on = False
    t.mesh_position = position
    return t


def places(xs) -> list:
    """Each member's (device, mesh position where it is a stand-in, else
    None)."""
    return [(x.device, getattr(x, "mesh_position", None)) for x in xs]


class _noted:
    """Tell ``OBSERVERS`` of one collective over members at ``where``
    (``places``), and not of the collectives it calls."""

    def __init__(self, kind: str, where: list, result_bytes: int):
        self.outer = len(where) > 1 and bool(OBSERVERS) and not getattr(_inside, "on", False)
        if self.outer:
            for observe in OBSERVERS:
                observe(kind, where, int(result_bytes))

    def __enter__(self):
        if self.outer:
            _inside.on = True

    def __exit__(self, *exc):
        if self.outer:
            _inside.on = False


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


class _Reduce(Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        with _noted("reduce", places(xs), _nbytes(xs[0])):
            total = xs[0]
            for x in xs[1:]:
                total = total + x.to(total.device)
            return total

    @staticmethod
    def backward(ctx, grad):
        return tuple(grad.to(d) for d in ctx.devices)


def sum_in_order(xs):
    """The members' tensors added in order on the first member's device
    (the gradient copied back to each)."""
    return _Reduce.apply(*xs) if len(xs) > 1 else xs[0]


def _copies(x, devices):
    """``x`` copied to each device (a new tensor on each, ``x``'s own too)."""
    return tuple(x.to(d, copy=True) for d in devices)


def _even_dim(shape, n: int):
    """The first dim of ``shape`` that ``n`` members cut into equal chunks,
    None where none does (the first-member route)."""
    return next((d for d, size in enumerate(shape) if size and size % n == 0), None)


def _reduced(xs, where: list, dim: int, sizes: list, combine) -> list:
    """Member j's chunk j (``sizes`` along ``dim``) of every member's
    tensor, combined in the group's order on member j's device: one a
    member. Where member j is a stand-in (``where``: ``places``; a class
    trace does not run it), its chunk is a stand-in too, and only the
    chunks that members that run send it are copied."""
    live = [i for i, (_, position) in enumerate(where) if position is None]
    mine = {i: torch.split(xs[i], sizes, dim) for i in live}

    def chunk(i: int, j: int):
        return mine[i][j] if i in mine else xs[i].narrow(dim, sum(sizes[:j]), sizes[j])

    out = []
    for j, (device, position) in enumerate(where):
        if position is None:
            total = chunk(0, j).to(device)
            for i in range(1, len(xs)):
                total = combine(total, chunk(i, j).to(device))
        else:
            for i in live:
                mine[i][j].to(device)
            shape = list(xs[j].shape)
            shape[dim] = sizes[j]
            total = stand_in((shape, xs[j].dtype), device, position)
        out.append(total)
    return out


def _assembled(parts, where: list, dim: int) -> tuple:
    """The members' ``parts`` concatenated along ``dim`` on each member's
    device (``where``: ``places``), each part copied from its owner into
    its place. Where member i is a stand-in, a stand-in, and only the parts
    of members that run are copied to it."""
    sizes = [p.shape[dim] for p in parts]
    shape = list(parts[0].shape)
    shape[dim] = sum(sizes)
    live = [j for j, (_, position) in enumerate(where) if position is None]
    out = []
    for device, position in where:
        if position is None:
            whole = torch.empty(shape, dtype=parts[0].dtype, device=device)
            for place, part in zip(torch.split(whole, sizes, dim), parts):
                place.copy_(part)
        else:
            for j in live:
                parts[j].to(device)
            whole = stand_in((shape, parts[0].dtype), device, position)
        out.append(whole)
    return tuple(out)


def _combined(xs, where: list, combine) -> tuple:
    """The members' tensors combined elementwise in the group's order, on
    every member: chunk j combined on member j, then every chunk copied
    from its owner (the first member's sum, copied, where no dim splits
    evenly)."""
    dim = _even_dim(xs[0].shape, len(xs))
    if dim is None:
        top = xs[0]
        for x in xs[1:]:
            top = combine(top, x.to(top.device))
        return _copies(top, [d for d, _ in where])
    sizes = [xs[0].shape[dim] // len(xs)] * len(xs)
    return _assembled(_reduced(xs, where, dim, sizes, combine), where, dim)


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.places = places(xs)
        with _noted("all-reduce", ctx.places, _nbytes(xs[0])):
            return _combined(xs, ctx.places, torch.add)

    @staticmethod
    def backward(ctx, *grads):
        with _noted("all-reduce", ctx.places, _nbytes(grads[0])):
            return _combined(grads, ctx.places, torch.add)


class _AllGather(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.places = dim, places(xs)
        ctx.sizes = [x.shape[dim] for x in xs]
        with _noted("all-gather", ctx.places, sum(_nbytes(x) for x in xs)):
            return _assembled(xs, ctx.places, dim)

    @staticmethod
    def backward(ctx, *grads):
        with _noted("reduce-scatter", ctx.places, _nbytes(grads[0]) // len(grads)):
            return (None, *_reduced(grads, ctx.places, ctx.dim, ctx.sizes, torch.add))


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.places = dim, places(xs)
        n, size = len(xs), xs[0].shape[dim]
        if size % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {size} does not split {n}")
        with _noted("reduce-scatter", ctx.places, _nbytes(xs[0]) // n):
            return tuple(_reduced(xs, ctx.places, dim, [size // n] * n, torch.add))

    @staticmethod
    def backward(ctx, *grads):
        with _noted("all-gather", ctx.places, sum(_nbytes(g) for g in grads)):
            return (None, *_assembled(grads, ctx.places, ctx.dim))


def _exchange(xs, split_dim, concat_dim):
    """Member j gets chunk j (along ``split_dim``) of every member's tensor,
    concatenated along ``concat_dim`` in member order."""
    n = len(xs)
    for x in xs:
        if x.shape[split_dim] % n:
            shape = tuple(x.shape)
            raise ValueError(f"all_to_all: dim {split_dim} of {shape} splits not {n}")
    chunks = [torch.chunk(x, n, split_dim) for x in xs]
    return tuple(
        torch.cat([chunks[i][j].to(xs[j].device) for i in range(n)], concat_dim)
        for j in range(n)
    )


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, split_dim, concat_dim, *xs):
        ctx.dims, ctx.places = (split_dim, concat_dim), places(xs)
        with _noted("all-to-all", ctx.places, _nbytes(xs[0])):
            return _exchange(xs, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim = ctx.dims
        with _noted("all-to-all", ctx.places, _nbytes(grads[0])):
            return (None, None, *_exchange(grads, concat_dim, split_dim))


class _Gather(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.devices = dim, [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        with _noted("gather", places(xs), sum(_nbytes(x) for x in xs)):
            return torch.cat([x.to(xs[0].device) for x in xs], dim)

    @staticmethod
    def backward(ctx, grad):
        chunks = torch.split(grad, ctx.sizes, ctx.dim)
        return (None, *(c.to(d) for c, d in zip(chunks, ctx.devices)))


def all_reduce(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the members' tensors, on every member."""
    return list(_AllReduce.apply(*xs)) if len(xs) > 1 else list(xs)


def all_gather(xs: list[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """The members' tensors concatenated along ``dim``, on every member."""
    return list(_AllGather.apply(dim, *xs)) if len(xs) > 1 else list(xs)


def reduce_scatter(xs: list[torch.Tensor], dim: int) -> list[torch.Tensor]:
    """The sum of the members' tensors cut into equal chunks along ``dim``:
    chunk i on member i."""
    return list(_ReduceScatter.apply(dim, *xs)) if len(xs) > 1 else list(xs)


def all_to_all(xs: list[torch.Tensor], split_dim: int, concat_dim: int) -> list:
    """Each member's tensor cut into one chunk a member along ``split_dim``;
    member j gets every member's chunk j, concatenated along ``concat_dim``."""
    if len(xs) == 1:
        return list(xs)
    return list(_AllToAll.apply(split_dim, concat_dim, *xs))


@torch.no_grad()
def all_max(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise max of the members' tensors, on every member (no
    gradient): ``all_reduce``'s route with a max for the add."""
    where = places(xs)
    with _noted("all-max", where, _nbytes(xs[0])):
        return list(_combined(xs, where, torch.maximum))


def gather(xs: list[torch.Tensor], dim: int) -> torch.Tensor:
    """The members' tensors concatenated along ``dim`` on the first
    member's device only."""
    return _Gather.apply(dim, *xs) if len(xs) > 1 else xs[0]
