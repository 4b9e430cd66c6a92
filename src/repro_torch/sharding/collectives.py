"""Collectives over a group of mesh positions, as peer copies and adds.

What GSPMD inserts into the reference's partitioned steps, written out for
the port's single-controller mesh (``launch.mesh``): every function takes
one tensor a member of a group, in the group's order (``partitioning.
axis_groups``), each on its member's device, and returns one a member.

Every reduction adds the members' tensors once, on the first member's
device, in the group's order, and copies the result to each member, so
that replicas come out bit for bit equal. Nothing goes through NCCL: it
refuses a communicator in which one card appears twice, which a mesh of
slots of one card is, and ``torch.cuda.nccl`` has no all-to-all. One
route for every placement keeps the CPU and the card on the same code.

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
"reduce" for a ``sum_in_order`` that no other collective called): the
kind, the members' devices and the bytes of each member's result (the
gathered whole on the first member for "gather" and "reduce"), as the
reference's HLO gives a collective's result shape.
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


def _split(x, sizes, dim, devices):
    chunks = torch.split(x, sizes, dim)
    return tuple(c.to(d, copy=True) for c, d in zip(chunks, devices))


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.devices, ctx.places = [x.device for x in xs], places(xs)
        with _noted("all-reduce", ctx.places, _nbytes(xs[0])):
            return _copies(sum_in_order(xs), ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        with _noted("all-reduce", ctx.places, _nbytes(grads[0])):
            return _copies(sum_in_order(grads), ctx.devices)


class _AllGather(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.devices, ctx.places = dim, [x.device for x in xs], places(xs)
        ctx.sizes = [x.shape[dim] for x in xs]
        with _noted("all-gather", ctx.places, sum(_nbytes(x) for x in xs)):
            whole = torch.cat([x.to(xs[0].device) for x in xs], dim)
            return _copies(whole, ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        with _noted("reduce-scatter", ctx.places, _nbytes(grads[0]) // len(grads)):
            return (None, *_split(sum_in_order(grads), ctx.sizes, ctx.dim, ctx.devices))


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.devices, ctx.places = dim, [x.device for x in xs], places(xs)
        n, size = len(xs), xs[0].shape[dim]
        if size % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {size} does not split {n}")
        with _noted("reduce-scatter", ctx.places, _nbytes(xs[0]) // n):
            return _split(sum_in_order(xs), [size // n] * n, dim, ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        with _noted("all-gather", ctx.places, sum(_nbytes(g) for g in grads)):
            whole = torch.cat([g.to(grads[0].device) for g in grads], ctx.dim)
            return (None, *_copies(whole, ctx.devices))


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
    gradient)."""
    with _noted("all-max", places(xs), _nbytes(xs[0])):
        top = xs[0]
        for x in xs[1:]:
            top = torch.maximum(top, x.to(top.device))
        return list(_copies(top, [x.device for x in xs]))


def gather(xs: list[torch.Tensor], dim: int) -> torch.Tensor:
    """The members' tensors concatenated along ``dim`` on the first
    member's device only."""
    return _Gather.apply(dim, *xs) if len(xs) > 1 else xs[0]
