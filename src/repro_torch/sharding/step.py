"""The rule-sharded LM steps: train, prefill and decode over a mesh.

The counterparts of ``train.train_step.make_train_step`` and
``serve.decode_step.make_prefill_step``/``make_serve_step`` for the
reference's sharded cells (``launch.specs.build_cell``): the same
signatures, on placed trees (``partitioning.Sharded`` leaves) instead of
one device's tensors; a VLM's steps take ``image_embeds`` as the
reference's do. The batch inputs may come placed by the batch sharding or
whole (they are then placed by it). Each step runs through
``spmd.Lockstep``.

The train step: ``loss = xent + aux_weight * aux`` over the mesh, one
autograd graph, then each position's gradient of its parameter blocks
all-reduced over the positions that hold a replica of the block
(``collectives.all_reduce``: spread over them, the same bits on each).
With ``microbatches`` n > 1, microbatch i is the global rows [i GB/n,
(i+1) GB/n): each position's block of them, as the batch sharding places
GB/n rows (as GSPMD would reshard the reference's slice), copied straight
from the positions that hold those rows, so that no device ever holds the
whole batch; each gradient summed over the microbatches and divided by n,
the loss their mean, the other metrics the last one's. Then, in the
reference's order, at each position on its own blocks: the int8
error-feedback compression (``compress_grads``; the per-tensor scale the
max over the leaf's blocks, all-maxed along the axes that cut it), the
global norm (each leaf's squares summed over its blocks along the axes
that cut it, never over replicas, then over the leaves in order), the
clip, the cosine schedule and the update, which each replica applies to
its own copy, as every device runs GSPMD's program: AdamW on its block
and moments; Adafactor with its row and column sums, the mean of ``vr``
and the RMS update clip all-reduced along the axes that cut the dims
they sum over, and its own blocks of ``vr``/``vc`` (placed by the
reference's ``_opt_spec_tree``; a dim that they cut over an axis the
leaf spends on another dim gathered first) written in place. The
parameters and the optimizer state are updated in place and returned
(the reference's cell donates both): they keep their shardings, replicas
bit for bit equal.

The prefill step returns the logits placed where they were computed (a
``Sharded``, in the layout the reference's compiled cell leaves its
output: ``spmd.Lockstep.placed_logits``); ``.gather()`` gives the whole
tensor. The decode step writes each position's blocks of the cache in
place and returns its logits so placed, and the cache.

Under a class trace (``spmd.running``) only the positions that run
compute; a member of a collective that does not run is a stand-in
(``collectives.stand_in``), and of the rows a microbatch moves only those
that reach or leave a position that runs are copied.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import spmd
from repro_torch.sharding.partitioning import AxisRules, Sharded, axis_groups, device_put, map_tree
from repro_torch.train import compression
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import OptimizerConfig


def _scalar(x) -> int:
    return int(x.local(0) if isinstance(x, Sharded) else x)


def _place(ctx: spmd.Lockstep, x) -> list:
    """A batch input's block a position: ``x`` placed by the batch
    sharding, or as it was placed (which must be that sharding)."""
    if not isinstance(x, Sharded):
        x = device_put(x, ctx.batch)
    elif x.sharding.spec != ctx.batch.spec:
        got, want = x.sharding.spec, ctx.batch.spec
        raise ValueError(f"a batch input placed by {got}, not by {want}")
    ctx.check_blocks(x, "a batch input")
    return ctx.each(x.local)


def _locals(ctx: spmd.Lockstep, leaves: dict, grad: bool) -> list[dict]:
    def own(s: Sharded, p: int):
        return s.local(p).detach().requires_grad_(True) if grad else s.local(p)

    return ctx.each(lambda p: {path: own(s, p) for path, s in leaves.items()})


def _images(ctx: spmd.Lockstep, x) -> list | None:
    return None if x is None else _place(ctx, x)


def _holder(mesh: Mesh, x: Sharded, p: int, block: int) -> int:
    """The position that sends position ``p`` rows of ``x``'s batch block
    ``block``: the one with ``p``'s coordinates on the mesh axes that do
    not cut the batch (``p`` itself where it holds the block)."""
    coords = list(np.unravel_index(p, mesh.sizes))
    axes = x.sharding.dim_axes(len(x.shape))[0]
    for a, c in zip(axes, np.unravel_index(block, [mesh.shape[a] for a in axes])):
        coords[mesh.axis_names.index(a)] = c
    return int(np.ravel_multi_index(coords, mesh.sizes))


def _rows(ctx: spmd.Lockstep, x, first: int) -> list:
    """Each position's block of the global rows [first, first + B) of a
    batch input ``x`` (B: ``ctx``'s batch), as the batch sharding of B rows
    places them. Placed (cut along its rows), each position's block is
    copied straight from the positions that hold its rows (``_holder``),
    so that no device holds more than its blocks; at a position that is
    not run only the rows that positions that run send it are copied.
    Whole, the rows are placed."""
    B = ctx.global_batch
    if not isinstance(x, Sharded):
        return _place(ctx, x[first : first + B])
    if any(x.sharding.dim_axes(len(x.shape))[1:]):
        raise ValueError(f"a batch input placed by {x.sharding.spec}, not along its rows")
    step = x.sharding.shard_shape(x.shape)[0]  # the rows of a block of x
    shape = (B,) + tuple(x.shape[1:])

    def mine(p: int):
        rows = ctx.batch.index(shape, p)[0]
        live = p in ctx.live
        size = (rows.stop - rows.start,) + shape[1:]
        block = torch.empty(size, dtype=x.dtype, device=ctx.devices[p]) if live else None
        at = rows.start
        while at < rows.stop:
            row = first + at
            src = _holder(ctx.mesh, x, p, row // step)
            n = min(rows.stop - at, step - row % step)
            part = x.local(src)[row % step : row % step + n]
            if live:
                block[at - rows.start : at - rows.start + n].copy_(part)
            elif src in ctx.live:
                part.to(ctx.devices[p])
            at += n
        return block

    return [mine(p) for p in range(ctx.n)]


def _cut_groups(mesh: Mesh, leaf: Sharded) -> list[list[int]]:
    """The positions that together hold one copy of each of ``leaf``'s
    blocks, in block order: the groups along the mesh axes that cut it."""
    named = {a for axes in leaf.sharding.dim_axes(len(leaf.shape)) for a in axes}
    return axis_groups(mesh, tuple(a for a in mesh.axis_names if a in named))


def _block_grads(cfg, mesh, rules, ocfg, params, leaves, paths, groups, batch, i: int, n: int):
    """Microbatch ``i`` of ``n``'s loss over the mesh and each position's
    gradient of its blocks, all-reduced over the block's replicas: (loss,
    xent, aux, {path: a gradient a position}, the program)."""
    GB, T = batch["tokens"].shape
    B = GB // n
    ctx = spmd.Lockstep(cfg, mesh, rules, params, B)

    def take(x):
        return _place(ctx, x) if n == 1 else _rows(ctx, x, i * B)

    local = _locals(ctx, leaves, grad=True)
    with torch.enable_grad():
        images = batch.get("image_embeds")
        images = None if images is None else take(images)
        logits, aux = ctx.forward(local, take(batch["tokens"]), images)
        del images
        sums = ctx.xent_sums(logits, take(batch["labels"]))
        del logits
        xent = coll.sum_in_order([ctx.have(sums, r) for r in ctx.reps]) / (B * T)
        loss = xent + ocfg.aux_loss_weight * aux[0].to(xent.device)
        wrt = [local[p][path] for path in paths for p in ctx.run]
        got = torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)
    del local, wrt
    k = len(ctx.run)
    blocks = {}
    for j, path in enumerate(paths):
        per = [None] * ctx.n
        for p, g in zip(ctx.run, got[j * k : (j + 1) * k]):
            per[p] = g
        blocks[path] = ctx.over(groups[path], per, coll.all_reduce)
    del got
    aux0 = aux[0].detach().to(ctx.devices[0])
    return loss.detach(), xent.detach(), aux0, blocks, ctx


def _compress(ctx, leaf: Sharded, grads: list, ef: Sharded) -> list:
    """The int8 round trip of one leaf's gradient at each position with
    error feedback: the scale is the whole leaf's (the max over its blocks,
    all-maxed along the axes that cut it); ``ef`` (placed as the leaf) is
    written in place."""
    f32 = torch.float32
    g32 = ctx.each(lambda p: grads[p].to(f32) + ef.local(p))
    peak = ctx.over(_cut_groups(ctx.mesh, leaf), ctx.each(lambda p: torch.amax(torch.abs(g32[p]))), coll.all_max)

    def round_trip(p):
        scale = compression.q8_scale(peak[p])
        deq = compression.q8_codes(g32[p], scale).to(f32) * scale
        ef.local(p).copy_(g32[p] - deq)
        return deq

    return ctx.each(round_trip)


def _widened(ctx, state: Sharded, cut: list) -> list:
    """Each position's block of ``state`` on the entries its leaf block
    covers (``cut``: the mesh axes that cut each of those dims of the
    leaf): a dim that the state cuts over more axes (a later one, which the
    leaf spends on another dim) all-gathered over them."""
    xs = ctx.each(state.local)
    for d, (have, want) in enumerate(zip(state.sharding.dim_axes(len(state.shape)), cut)):
        if have != want:
            if tuple(have[: len(want)]) != tuple(want):
                raise NotImplementedError(f"an optimizer state cut over {have} where its leaf's dim is over {want}")
            groups = axis_groups(ctx.mesh, have[len(want) :])
            xs = ctx.over(groups, xs, lambda m, d=d: coll.all_gather(m, d))
    return xs


def _write_back(ctx, state: Sharded, values: list, entries) -> None:
    """Each position's block of ``state`` set from its ``values`` over the
    entries ``entries(p)`` (global ranges, one a dim)."""
    for p in ctx.run:
        have = state.sharding.index(state.shape, p)
        at = tuple(slice(h.start - e.start, h.stop - e.start) for h, e in zip(have, entries(p)))
        state.local(p).copy_(values[p][at])


def _adafactor(ctx, leaf: Sharded, grads: list, state: dict, lr, wd: float) -> None:
    """``optimizer.adafactor_update`` of one placed leaf at each position,
    on its own block: the row and column sums, the mean of ``vr`` and the
    RMS update clip all-reduced along the axes that cut the dims they sum
    over, each position's own blocks of ``vr``/``vc`` (placed by the
    reference's ``_opt_spec_tree``) written in place."""
    b2, eps, clip = opt.ADAFACTOR_B2, opt.ADAFACTOR_EPS, opt.ADAFACTOR_CLIP
    f32 = torch.float32
    shape = leaf.shape
    mesh = ctx.mesh
    cut = leaf.sharding.dim_axes(len(shape))
    g32 = ctx.each(lambda p: grads[p].to(f32))
    if len(shape) >= 2:
        g2 = ctx.each(lambda p: g32[p] * g32[p] + eps)
        row = ctx.over(axis_groups(mesh, cut[-1]), ctx.each(lambda p: torch.sum(g2[p], dim=-1)), coll.all_reduce)
        col = ctx.over(axis_groups(mesh, cut[-2]), ctx.each(lambda p: torch.sum(g2[p], dim=-2)), coll.all_reduce)
        del g2
        vr, vc = _widened(ctx, state["vr"], cut[:-1]), _widened(ctx, state["vc"], cut[:-2] + cut[-1:])
        vr = ctx.each(lambda p: b2 * vr[p] + (1 - b2) * (row[p] / shape[-1]))
        vc = ctx.each(lambda p: b2 * vc[p] + (1 - b2) * (col[p] / shape[-2]))
        total = ctx.each(lambda p: torch.sum(vr[p], dim=-1, keepdim=True))
        total = ctx.over(axis_groups(mesh, cut[-2]), total, coll.all_reduce)
        index = lambda p: leaf.sharding.index(shape, p)  # noqa: E731
        _write_back(ctx, state["vr"], vr, lambda p: index(p)[:-1])
        _write_back(ctx, state["vc"], vc, lambda p: index(p)[:-2] + index(p)[-1:])

        def factored(p):
            denom = torch.clamp(total[p] / shape[-2], min=eps)
            vhat = vr[p][..., None] * vc[p][..., None, :] / denom[..., None]
            return g32[p] * torch.rsqrt(vhat + eps)

        u = ctx.each(factored)
    else:

        def unfactored(p):
            v = b2 * state["v"].local(p) + (1 - b2) * (g32[p] * g32[p] + eps)
            state["v"].local(p).copy_(v)
            return g32[p] * torch.rsqrt(v + eps)

        u = ctx.each(unfactored)
    squares = ctx.over(_cut_groups(mesh, leaf), ctx.each(lambda p: torch.sum(u[p] * u[p])), coll.all_reduce)

    def update(p):
        rms = torch.sqrt(squares[p] / math.prod(shape) + eps)  # the update clip
        denom = torch.clamp(rms / clip, min=1.0)
        p32 = leaf.local(p).to(f32)
        leaf.local(p).copy_((p32 - lr * (u[p] / denom + wd * p32)).to(leaf.dtype))

    for p in ctx.run:
        update(p)


def _adamw(ctx, leaf: Sharded, grads: list, opt_state, path, lr, ocfg) -> None:
    """``optimizer.adamw_update`` at each position, on its own block and
    its own ``m``, ``v`` and count."""
    m_in, v_in = spmd.flat(opt_state["m"])[path], spmd.flat(opt_state["v"])[path]

    def update(p):
        state = {
            "m": {"x": m_in.local(p)},
            "v": {"x": v_in.local(p)},
            "count": opt_state["count"].local(p),
        }
        upd, st = opt.adamw_update(
            {"x": leaf.local(p)}, {"x": grads[p]}, state, lr, weight_decay=ocfg.weight_decay
        )
        for target, value in zip((leaf, m_in, v_in), (upd["x"], st["m"]["x"], st["v"]["x"])):
            target.local(p).copy_(value)

    for p in ctx.run:
        update(p)


def make_train_step(
    cfg: ModelConfig, ocfg: OptimizerConfig, mesh: Mesh, rules: AxisRules
) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics),
    every tree of ``Sharded``; ``opt_state`` is AdamW's ``{"m", "v",
    "count"}`` or Adafactor's ``{"v", "count"}`` (with ``"ef"`` when
    ``compress_grads``), placed by the reference's ``_opt_spec_tree``
    (``launch.specs``)."""
    spmd.check_supported(cfg, mesh, rules)
    n_micro = ocfg.microbatches

    def train_step(params, opt_state, batch, step):
        leaves = spmd.flat(params)
        paths = sorted(leaves)
        groups = {path: leaves[path].replica_groups() for path in paths}
        acc, loss = None, 0.0
        for i in range(n_micro):
            args = (cfg, mesh, rules, ocfg, params, leaves, paths, groups, batch, i, n_micro)
            l, xent, aux0, grads, ctx = _block_grads(*args)
            if acc is None:
                acc = grads
            else:
                acc = {k: ctx.each(lambda p, k=k: acc[k][p] + grads[k][p]) for k in paths}
            loss = loss + l / n_micro if n_micro > 1 else l
            del grads
        if n_micro > 1:
            acc = {k: ctx.each(lambda p, k=k: acc[k][p] / n_micro) for k in paths}
        grads = acc
        del acc
        if ocfg.compress_grads:
            ef = spmd.flat(opt_state["ef"])
            for path in paths:
                grads[path] = _compress(ctx, leaves[path], grads[path], ef[path])
        total = None
        for path in paths:  # the global norm: each leaf's squares over its blocks, then the leaves
            got = ctx.each(lambda p, g=grads[path]: opt.square_sum(g[p]))
            got = ctx.over(_cut_groups(mesh, leaves[path]), got, coll.all_reduce)
            total = got if total is None else ctx.each(lambda p, got=got: total[p] + got[p])
        gnorm = ctx.each(lambda p: torch.sqrt(total[p]))
        scale = ctx.each(lambda p: opt.clip_scale(gnorm[p], ocfg.clip_norm))
        lr = opt.cosine_schedule(
            _scalar(step),
            peak_lr=ocfg.peak_lr,
            warmup=ocfg.warmup,
            total=ocfg.total_steps,
        )
        for path in paths:
            g = grads[path]
            clipped = ctx.each(lambda p: (g[p] * scale[p]).to(g[p].dtype))
            if ocfg.name == "adafactor":
                state = {k[-1]: v for k, v in spmd.flat(opt_state["v"]).items() if k[:-1] == path}
                _adafactor(ctx, leaves[path], clipped, state, lr, ocfg.weight_decay)
            else:
                _adamw(ctx, leaves[path], clipped, opt_state, path, lr, ocfg)
            del grads[path], g, clipped
        for p in ctx.run:
            opt_state["count"].local(p).add_(1)
        metrics = dict(xent=xent, aux=aux0, loss=loss, grad_norm=gnorm[ctx.run[0]], lr=lr)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh: Mesh, rules: AxisRules) -> Callable:
    """(params, tokens (GB, T)[, image_embeds (GB, N, d)]) -> the (GB, T,
    V) logits as a ``Sharded``: each position's block on its device."""
    spmd.check_supported(cfg, mesh, rules)

    @torch.inference_mode()
    def prefill_step(params, tokens, image_embeds=None):
        ctx = spmd.Lockstep(cfg, mesh, rules, params, tokens.shape[0])
        local = _locals(ctx, spmd.flat(params), grad=False)
        logits, _ = ctx.forward(local, _place(ctx, tokens), _images(ctx, image_embeds))
        return ctx.placed_logits(logits)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh: Mesh, rules: AxisRules) -> Callable:
    """(params, tokens (GB, 1), pos, cache[, image_embeds]) -> (the (GB, 1,
    V) logits as a ``Sharded``, each position's block on its device,
    cache): ``cache`` is ``init_cache``'s tree placed by the cell's cache
    shardings, its blocks written in place. A VLM takes
    ``image_embeds`` and reads its image context from the cache, as the
    reference does."""
    spmd.check_supported(cfg, mesh, rules)

    @torch.inference_mode()
    def serve_step(params, tokens, pos, cache, image_embeds=None):
        ctx = spmd.Lockstep(cfg, mesh, rules, params, tokens.shape[0])
        local = _locals(ctx, spmd.flat(params), grad=False)
        layouts = ctx.cache_layouts(cache)
        blocks = ctx.each(lambda p: map_tree(lambda s: s.local(p), cache))
        logits = ctx.decode(local, _place(ctx, tokens), _scalar(pos), blocks, layouts)
        return ctx.placed_logits(logits), cache

    return serve_step
