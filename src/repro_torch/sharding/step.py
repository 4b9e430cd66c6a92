"""The rule-sharded LM steps: train, prefill and decode over a mesh.

The counterparts of ``train.train_step.make_train_step`` and
``serve.decode_step.make_prefill_step``/``make_serve_step`` for the
reference's sharded cells (``launch.specs.build_cell``): the same
signatures, on placed trees (``partitioning.Sharded`` leaves) instead of
one device's tensors. The batch inputs may come placed by the batch
sharding or whole (they are then placed by it). Each step runs through
``spmd.Lockstep``.

The train step: ``loss = xent + aux_weight * aux`` over the mesh, one
autograd graph, then each parameter block's gradient summed over the
positions that hold a replica of it (in position order, on the first
one's device, copied to each), the global norm over the distinct blocks
of every leaf (never over their replicas), the clip, the cosine schedule
and ``optimizer.adamw_update`` on each distinct block, the result copied
to its replicas. The parameters and the optimizer state are updated in
place and returned (the reference's cell donates both): they keep their
shardings, replicas bit for bit equal. Microbatches, compressed gradients
and Adafactor raise ``NotImplementedError``.

The prefill step returns the whole logits on the mesh's first device. The
decode step writes each position's blocks of the cache in place and
returns the whole logits and the cache.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import spmd
from repro_torch.sharding.partitioning import AxisRules, Sharded, device_put, map_tree
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
    return [x.local(p) for p in range(ctx.n)]


def _locals(ctx: spmd.Lockstep, leaves: dict, grad: bool) -> list[dict]:
    def own(s: Sharded, p: int):
        return s.local(p).detach().requires_grad_(True) if grad else s.local(p)

    return [{path: own(s, p) for path, s in leaves.items()} for p in range(ctx.n)]


def refuse(ocfg: OptimizerConfig) -> None:
    """Raise for the options this sharded step does not carry out."""
    if ocfg.name != "adamw":
        raise NotImplementedError(f"the sharded train step runs AdamW, not {ocfg.name}")
    if ocfg.microbatches > 1:
        raise NotImplementedError("the sharded train step takes no microbatches")
    if ocfg.compress_grads:
        raise NotImplementedError("the sharded train step does not compress gradients")


def make_train_step(
    cfg: ModelConfig, ocfg: OptimizerConfig, mesh: Mesh, rules: AxisRules
) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics),
    every tree of ``Sharded``; ``opt_state`` is ``{"m", "v", "count"}``
    placed by the reference's ``_opt_spec_tree`` (``launch.specs``)."""
    spmd.check_supported(cfg, mesh, rules)
    refuse(ocfg)

    def train_step(params, opt_state, batch, step):
        tokens = batch["tokens"]
        B, T = tokens.shape
        ctx = spmd.Lockstep(cfg, mesh, rules, params, B)
        leaves = spmd.flat(params)
        paths = sorted(leaves)
        local = _locals(ctx, leaves, grad=True)
        with torch.enable_grad():
            logits, aux = ctx.forward(local, _place(ctx, tokens))
            sums = ctx.xent_sums(logits, _place(ctx, batch["labels"]))
            del logits
            xent = coll.sum_in_order([sums[r] for r in ctx.reps]) / (B * T)
            loss = xent + ocfg.aux_loss_weight * aux[0].to(xent.device)
            wrt = [local[p][path] for path in paths for p in range(ctx.n)]
            got = torch.autograd.grad(
                loss, wrt, allow_unused=True, materialize_grads=True
            )
        del local, wrt
        n = ctx.n
        grads = {path: list(got[i * n : (i + 1) * n]) for i, path in enumerate(paths)}
        del got
        groups = {path: leaves[path].replica_groups() for path in paths}
        for path in paths:  # each block's gradient: the sum over its replicas
            for g in groups[path]:
                if len(g) > 1:
                    total = coll.sum_in_order([grads[path][p] for p in g])
                    for p in g:
                        grads[path][p] = total.to(ctx.devices[p], copy=True)
        dev0 = ctx.devices[0]
        squares = [
            opt.square_sum(grads[path][g[0]]).to(dev0)
            for path in paths
            for g in groups[path]
        ]
        gnorm = torch.sqrt(coll.sum_in_order(squares))
        scale = opt.clip_scale(gnorm, ocfg.clip_norm)
        lr = opt.cosine_schedule(
            _scalar(step),
            peak_lr=ocfg.peak_lr,
            warmup=ocfg.warmup,
            total=ocfg.total_steps,
        )
        m_in, v_in = spmd.flat(opt_state["m"]), spmd.flat(opt_state["v"])
        for path in paths:
            targets = (leaves[path], m_in[path], v_in[path])
            for g in groups[path]:
                p0 = g[0]
                gr = grads[path][p0]
                gr = (gr * scale.to(gr.device)).to(gr.dtype)
                state = {
                    "m": {"x": m_in[path].local(p0)},
                    "v": {"x": v_in[path].local(p0)},
                    "count": opt_state["count"].local(p0),
                }
                upd, st = opt.adamw_update(
                    {"x": leaves[path].local(p0)}, {"x": gr}, state, lr,
                    weight_decay=ocfg.weight_decay,
                )
                done = (upd["x"], st["m"]["x"], st["v"]["x"])
                for target, value in zip(targets, done):
                    for p in g:  # computed once, copied to each replica
                        target.local(p).copy_(value)
            del grads[path]
        for c in opt_state["count"].shards:
            c.add_(1)
        aux0 = aux[0].detach().to(dev0)
        metrics = dict(
            xent=xent.detach(), aux=aux0, loss=loss.detach(), grad_norm=gnorm, lr=lr
        )
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh: Mesh, rules: AxisRules) -> Callable:
    """(params, tokens (GB, T)) -> the whole logits (GB, T, V)."""
    spmd.check_supported(cfg, mesh, rules)

    @torch.inference_mode()
    def prefill_step(params, tokens):
        ctx = spmd.Lockstep(cfg, mesh, rules, params, tokens.shape[0])
        local = _locals(ctx, spmd.flat(params), grad=False)
        logits, _ = ctx.forward(local, _place(ctx, tokens))
        return ctx.gather_logits(logits)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh: Mesh, rules: AxisRules) -> Callable:
    """(params, tokens (GB, 1), pos, cache) -> (the whole logits (GB, 1, V),
    cache): ``cache`` is ``init_cache``'s tree placed by the cell's cache
    shardings, its blocks written in place."""
    spmd.check_supported(cfg, mesh, rules)

    @torch.inference_mode()
    def serve_step(params, tokens, pos, cache):
        ctx = spmd.Lockstep(cfg, mesh, rules, params, tokens.shape[0])
        local = _locals(ctx, spmd.flat(params), grad=False)
        kv = cache["kv"]
        layout = ctx.cache_layout(kv)
        blocks = [map_tree(lambda s, p=p: s.local(p), kv) for p in range(ctx.n)]
        logits = ctx.decode(local, _place(ctx, tokens), _scalar(pos), blocks, layout)
        return ctx.gather_logits(logits), cache

    return serve_step
