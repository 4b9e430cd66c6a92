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
autograd graph, then each parameter block's gradient summed over the
positions that hold a replica of it (in position order, on the first
one's device). With ``microbatches`` n > 1, microbatch i is the global
rows [i GB/n, (i+1) GB/n) placed by the batch sharding (as GSPMD would
reshard the reference's slice), each block's gradient summed over the
microbatches and divided by n, the loss their mean, the other metrics the
last one's. Then, in the reference's order: the int8 error-feedback
compression (``compress_grads``; the per-tensor scale the max over a
leaf's distinct blocks), the global norm over the distinct blocks of
every leaf (never over their replicas), the clip, the cosine schedule and
the update: AdamW on each distinct block; Adafactor with its row and
column means, the mean of ``vr`` and the RMS update clip each reduced
over the whole leaf (the partial sums of the blocks that cut a dim added
in position order, then divided by the global count), ``vr``/``vc``
updated whole and written into their own placement. Each result is
copied to the block's replicas. The parameters and the optimizer state
are updated in place and returned (the reference's cell donates both):
they keep their shardings, replicas bit for bit equal.

The prefill step returns the logits placed where they were computed (a
``Sharded``, in the layout the reference's compiled cell leaves its
output: ``spmd.Lockstep.placed_logits``); ``.gather()`` gives the whole
tensor. The decode step writes each position's blocks of the cache in
place and returns its logits so placed, and the cache.

Under a class trace (``spmd.running``) only the positions that run
compute; a block whose replica group's first member does not run is a
stand-in (``collectives.stand_in``), and of its update only what reaches
a position that runs is carried out: its copies to and from the mesh's
first device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import spmd
from repro_torch.sharding.partitioning import AxisRules, Sharded, device_put, map_tree
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


def _by_group(ctx: spmd.Lockstep, groups: list, fn, like=None) -> list:
    """``fn(i)`` for each replica group ``i`` whose first member runs; for
    the others a stand-in on their first member's device, of ``like``'s
    (shape, dtype), else of their class representative's group's result
    (groups are in position order, so it comes first)."""
    out, index = [], {}
    for i, grp in enumerate(groups):
        lead = grp[0]
        if lead in ctx.live:
            out.append(fn(i))
        else:
            shape = like if like is not None else out[index[ctx.rep[lead]]]
            out.append(coll.stand_in(shape, ctx.devices[lead], lead))
        index[lead] = i
    return out


def _images(ctx: spmd.Lockstep, x) -> list | None:
    return None if x is None else _place(ctx, x)


def _microbatches(batch: dict, n: int) -> list[dict]:
    """The batch as n microbatches of consecutive global rows, whole."""
    if n == 1:
        return [batch]
    whole = {k: v.gather() if isinstance(v, Sharded) else v for k, v in batch.items()}
    rows = whole["tokens"].shape[0] // n
    return [{k: v[i * rows : (i + 1) * rows] for k, v in whole.items()} for i in range(n)]


def _block_grads(cfg, mesh, rules, ocfg, params, leaves, paths, groups, batch):
    """One (micro)batch's loss over the mesh and each distinct block's
    gradient (summed over its replicas, on its first position's device):
    (loss, xent, aux, {path: [a gradient a replica group]}, the program)."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    ctx = spmd.Lockstep(cfg, mesh, rules, params, B)
    local = _locals(ctx, leaves, grad=True)
    with torch.enable_grad():
        images = _images(ctx, batch.get("image_embeds"))
        logits, aux = ctx.forward(local, _place(ctx, tokens), images)
        sums = ctx.xent_sums(logits, _place(ctx, batch["labels"]))
        del logits
        xent = coll.sum_in_order([ctx.have(sums, r) for r in ctx.reps]) / (B * T)
        loss = xent + ocfg.aux_loss_weight * aux[0].to(xent.device)
        wrt = [local[p][path] for path in paths for p in ctx.run]
        got = torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True)
    del local, wrt
    n = len(ctx.run)
    blocks = {}
    for i, path in enumerate(paths):
        per = [None] * ctx.n
        for p, g in zip(ctx.run, got[i * n : (i + 1) * n]):
            per[p] = g
        blocks[path] = _by_group(
            ctx, groups[path], lambda j: coll.sum_in_order([ctx.have(per, p) for p in groups[path][j]])
        )
    del got
    aux0 = aux[0].detach().to(ctx.devices[0])
    return loss.detach(), xent.detach(), aux0, blocks, ctx


def _write(target: Sharded, group: list[int], value) -> None:
    for p in group:  # computed once, copied to each replica
        target.local(p).copy_(value)


def _compress(ctx, leaf: Sharded, blocks: list, groups: list, ef: Sharded) -> list:
    """The int8 round trip of one leaf's gradient blocks with error
    feedback: the scale is the whole leaf's (the max over its distinct
    blocks); ``ef`` (placed as the leaf) is written in place."""
    f32 = torch.float32
    g32 = _by_group(ctx, groups, lambda i: blocks[i].to(f32) + ef.local(groups[i][0]))
    peak = coll.all_max(_by_group(ctx, groups, lambda i: torch.amax(torch.abs(g32[i])), ((), f32)))

    def round_trip(i):
        scale = compression.q8_scale(peak[i])
        deq = compression.q8_codes(g32[i], scale).to(f32) * scale
        _write(ef, groups[i], g32[i] - deq)
        return deq

    return [round_trip(i) if grp[0] in ctx.live else g32[i] for i, grp in enumerate(groups)]


def _scatter(target: Sharded, whole: torch.Tensor) -> None:
    """Each shard of ``target`` set to its block of ``whole``."""
    for p, shard in enumerate(target.shards):
        shard.copy_(whole[target.sharding.index(target.shape, p)])


def _adafactor(ctx, leaf: Sharded, blocks: list, groups: list, state: dict, lr, wd: float):
    """``optimizer.adafactor_update`` of one placed leaf from its clipped
    gradient blocks: its reductions over the whole leaf, the state written
    in place."""
    b2, eps, clip = opt.ADAFACTOR_B2, opt.ADAFACTOR_EPS, opt.ADAFACTOR_CLIP
    f32 = torch.float32
    shape = leaf.shape
    dev0 = leaf.sharding.mesh.devices[0]
    index = [leaf.sharding.index(shape, grp[0]) for grp in groups]
    g32 = _by_group(ctx, groups, lambda i: blocks[i].to(f32))
    if len(shape) >= 2:
        row = torch.zeros(shape[:-1], dtype=f32, device=dev0)
        col = torch.zeros(shape[:-2] + shape[-1:], dtype=f32, device=dev0)

        def sums(g, grp, idx):  # one block's partial sums, added on the first device
            if grp[0] in ctx.live:
                g2 = g * g + eps
                row[idx[:-1]] += torch.sum(g2, dim=-1).to(dev0)
                col[idx[:-2] + idx[-1:]] += torch.sum(g2, dim=-2).to(dev0)
            else:
                row[idx[:-1]] += coll.stand_in((g.shape[:-1], f32), g.device, grp[0]).to(dev0)
                rest = g.shape[:-2] + g.shape[-1:]
                col[idx[:-2] + idx[-1:]] += coll.stand_in((rest, f32), g.device, grp[0]).to(dev0)

        for g, grp, idx in zip(g32, groups, index):  # in order
            sums(g, grp, idx)
        vr = b2 * state["vr"].gather() + (1 - b2) * (row / shape[-1])
        vc = b2 * state["vc"].gather() + (1 - b2) * (col / shape[-2])
        denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
        _scatter(state["vr"], vr)
        _scatter(state["vc"], vc)

        def factored(g, grp, idx):
            r = vr[idx[:-1]][..., None]
            c = vc[idx[:-2] + idx[-1:]][..., None, :]
            vhat = (r * c / denom[idx[:-2]][..., None]).to(g.device)
            return g * torch.rsqrt(vhat + eps) if grp[0] in ctx.live else g

        u = [factored(g, grp, idx) for g, grp, idx in zip(g32, groups, index)]
    else:

        def unfactored(g, grp):
            v = b2 * state["v"].local(grp[0]) + (1 - b2) * (g * g + eps)
            _write(state["v"], grp, v)
            return g * torch.rsqrt(v + eps)

        u = [unfactored(g, grp) if grp[0] in ctx.live else g for g, grp in zip(g32, groups)]

    def square(x, grp):
        if grp[0] in ctx.live:
            return torch.sum(x * x).to(dev0)
        return coll.stand_in(((), f32), x.device, grp[0]).to(dev0)

    squares = coll.sum_in_order([square(x, grp) for x, grp in zip(u, groups)])
    rms = torch.sqrt(squares / math.prod(shape) + eps)  # the update clip
    denom = torch.clamp(rms / clip, min=1.0)

    def update(x, grp):
        d = denom.to(x.device)
        if grp[0] in ctx.live:
            p32 = leaf.local(grp[0]).to(f32)
            _write(leaf, grp, (p32 - lr * (x / d + wd * p32)).to(leaf.dtype))

    for x, grp in zip(u, groups):
        update(x, grp)


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
        for mb in _microbatches(batch, n_micro):
            args = (cfg, mesh, rules, ocfg, params, leaves, paths, groups, mb)
            l, xent, aux0, grads, ctx = _block_grads(*args)
            if acc is None:
                acc = grads
            else:
                acc = {k: _by_group(ctx, groups[k], lambda i, k=k: acc[k][i] + grads[k][i]) for k in paths}
            loss = loss + l / n_micro if n_micro > 1 else l
            del grads
        if n_micro > 1:
            acc = {k: _by_group(ctx, groups[k], lambda i, k=k: acc[k][i] / n_micro) for k in paths}
        grads = acc
        del acc
        if ocfg.compress_grads:
            ef = spmd.flat(opt_state["ef"])
            for path in paths:
                grads[path] = _compress(ctx, leaves[path], grads[path], groups[path], ef[path])
        dev0 = mesh.devices[0]
        f32 = torch.float32
        squares = []
        for path in paths:
            got = _by_group(ctx, groups[path], lambda i, g=grads[path]: opt.square_sum(g[i]), ((), f32))
            squares += [x.to(dev0) for x in got]
        gnorm = torch.sqrt(coll.sum_in_order(squares))
        scale = opt.clip_scale(gnorm, ocfg.clip_norm)
        lr = opt.cosine_schedule(
            _scalar(step),
            peak_lr=ocfg.peak_lr,
            warmup=ocfg.warmup,
            total=ocfg.total_steps,
        )

        def clip(g, grp):  # the scale copied to each block's device
            s = scale.to(g.device)
            return (g * s).to(g.dtype) if grp[0] in ctx.live else g

        for path in paths:
            clipped = [clip(g, grp) for g, grp in zip(grads[path], groups[path])]
            if ocfg.name == "adafactor":
                state = {k[-1]: v for k, v in spmd.flat(opt_state["v"]).items() if k[:-1] == path}
                _adafactor(ctx, leaves[path], clipped, groups[path], state, lr, ocfg.weight_decay)
            else:
                _adamw(ctx, leaves[path], clipped, groups[path], opt_state, path, lr, ocfg)
            del grads[path]
        for p in ctx.run:
            opt_state["count"].local(p).add_(1)
        metrics = dict(xent=xent, aux=aux0, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step


def _adamw(ctx, leaf: Sharded, blocks: list, groups: list, opt_state, path, lr, ocfg) -> None:
    """``optimizer.adamw_update`` on each distinct block of one leaf."""
    m_in, v_in = spmd.flat(opt_state["m"])[path], spmd.flat(opt_state["v"])[path]

    def update(gr, g):
        p0 = g[0]
        state = {
            "m": {"x": m_in.local(p0)},
            "v": {"x": v_in.local(p0)},
            "count": opt_state["count"].local(p0),
        }
        upd, st = opt.adamw_update(
            {"x": leaf.local(p0)}, {"x": gr}, state, lr, weight_decay=ocfg.weight_decay
        )
        for target, value in zip((leaf, m_in, v_in), (upd["x"], st["m"]["x"], st["v"]["x"])):
            _write(target, g, value)

    for gr, g in zip(blocks, groups):
        if g[0] in ctx.live:
            update(gr, g)


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
