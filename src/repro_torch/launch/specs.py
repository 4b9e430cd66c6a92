"""Layout policy for an LM cell: the attention backend, the optimizer and
its microbatches, the partitioning rules, and shardings cut to what
divides.

The port of ``repro/launch/specs.py``'s policy functions, with the
reference's arithmetic. Its budgets are a TPU v5e's: 16 GB of device
memory, about 10 GB of it for bf16 weights under tensor parallelism and
5 GB for the per-device activation stash, over 16 devices a parallel
axis. They stay the defaults, so that the port and the reference agree on
the same inputs; an H100 caller passes ``device_bytes=80e9`` (and its own
``dp_ways`` to ``choose_optimizer``), which scales both budgets by 80/16.

``build_cell`` builds one cell's sharded step as the reference's does,
with its shardings, ``meta`` and donated arguments, but its ``args`` are
placed trees (``partitioning.Sharded``) of the port's weights and zeros,
not ``jax.ShapeDtypeStruct``s, and its ``step_fn`` runs the rule-sharded
step (``sharding.step``) on them. The reference's ``jax.jit(...).lower``
of that step has no counterpart: the port lowers nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import (
    SEED,
    LMParams,
    cache_spec,
    init_cache,
    init_params,
)
from repro_torch.sharding import spmd
from repro_torch.sharding import step as sharded
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES,
    DP_ONLY_RULES,
    EP_DATA_RULES,
    TP_ONLY_RULES,
    AxisRules,
    NamedSharding,
    PartitionSpec,
    _is_spec_leaf,
    batch_sharding,
    device_put,
    map_tree,
    param_shardings,
    spec_to_pspec,
)
from repro_torch.train import compression
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import OptimizerConfig

DEVICE_BYTES = 16e9  # the reference's device: a TPU v5e
WEIGHT_SHARE = 10 / 16  # of it for bf16 weights under tensor parallelism
STASH_SHARE = 5 / 16  # of it for the activation stash a device keeps
PARALLEL_WAYS = 16  # the reference mesh's data and model axes


def pick_backend(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k: the paper's Maclaurin attention for every arch that has
    attention (full softmax at 500k would be quadratic); rwkv6 runs its
    native O(d) recurrence."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.with_backend("maclaurin")
    return cfg


def choose_optimizer(
    cfg: ModelConfig,
    shape: ShapeConfig | None = None,
    dp_ways: int = PARALLEL_WAYS,
    *,
    device_bytes: float = DEVICE_BYTES,
) -> OptimizerConfig:
    """Adafactor past 100B parameters, AdamW below, and enough
    gradient-accumulation microbatches that the per-layer activation stash
    fits ``STASH_SHARE`` of ``device_bytes``.

    Stash estimate (remat saves the residual stream per layer):
        L x (global_tokens / dp_ways) x d_model x 2 bytes
    microbatches = the power of two that brings it under the target,
    capped so each microbatch still divides over the data-parallel ways.
    """
    name = "adafactor" if cfg.param_count() > 100e9 else "adamw"
    mb = 1
    if shape is not None and shape.kind == "train":
        local_tokens = shape.global_batch * shape.seq_len / dp_ways
        stash = cfg.n_layers * local_tokens * cfg.d_model * 2
        target = STASH_SHARE * device_bytes
        mb_cap = max(1, shape.global_batch // dp_ways)
        while mb < mb_cap and stash / mb > target:
            mb *= 2
    return OptimizerConfig(name=name, microbatches=mb)


def choose_rules(
    cfg: ModelConfig,
    shape: ShapeConfig,
    rules: AxisRules | None,
    *,
    device_bytes: float = DEVICE_BYTES,
) -> AxisRules:
    """The rules a cell runs under (``rules`` where given):

    train, dense/audio up to 1B -> DP_ONLY (weights replicated: such models'
                                   head counts do not divide the model axis)
    train, MoE with experts of 10M+ elements -> EP_DATA
    train, otherwise            -> DEFAULT (TP + FSDP over data)
    serve -> TP_ONLY where the bf16 weights cut ``PARALLEL_WAYS`` ways fit
             ``WEIGHT_SHARE`` of ``device_bytes``, else DEFAULT
    """
    if rules is not None:
        return rules
    if shape.kind == "train":
        if cfg.param_count() <= 1e9 and cfg.family in ("dense", "audio"):
            return DP_ONLY_RULES
        if cfg.moe_num_experts and cfg.moe_d_ff * cfg.d_model >= 10e6:
            return EP_DATA_RULES
        return DEFAULT_RULES
    tp_bytes = cfg.param_count() * 2 / PARALLEL_WAYS
    return TP_ONLY_RULES if tp_bytes <= WEIGHT_SHARE * device_bytes else DEFAULT_RULES


def sanitize(sharding_tree, shape_tree, mesh):
    """Drop sharding on any dim not divisible by its mesh extent.
    ``shape_tree`` matches ``sharding_tree`` with anything that has a
    ``shape`` at its leaves."""

    def fix(sh: NamedSharding, leaf):
        shape = tuple(leaf.shape)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        out = []
        for dim, s in zip(shape, spec):
            if s is None:
                out.append(None)
                continue
            axes = (s,) if isinstance(s, str) else tuple(s)
            extent = math.prod(mesh.shape[a] for a in axes)
            out.append(s if dim % extent == 0 else None)
        return NamedSharding(mesh, PartitionSpec(*out))

    return map_tree(fix, sharding_tree, shape_tree)


def _opt_spec_tree(ocfg: OptimizerConfig, param_spec, params):
    """Logical spec tree for the optimizer state, mirroring
    ``init_opt_state``; ``params`` gives each leaf's shape."""
    if ocfg.name == "adafactor":

        def leaf(s, p):
            s = tuple(s) + (None,) * (len(p.shape) - len(s))
            if len(p.shape) >= 2:
                return {"vr": s[:-1], "vc": s[:-2] + s[-1:]}
            return {"v": s}

        v = map_tree(leaf, param_spec, params, is_leaf=_is_spec_leaf)
        state = {"v": v, "count": ()}
    else:
        state = {"m": param_spec, "v": param_spec, "count": ()}
    if ocfg.compress_grads:
        state["ef"] = param_spec
    return state


def _named(spec_tree, rules: AxisRules, mesh: Mesh):
    return map_tree(
        lambda s: NamedSharding(mesh, spec_to_pspec(tuple(s), rules, mesh)),
        spec_tree,
        is_leaf=_is_spec_leaf,
    )


def cache_shardings(
    cfg: ModelConfig,
    cache,
    rules: AxisRules,
    mesh: Mesh,
    global_batch: int,
    seq_len: int,
):
    """The reference's decode-cell cache shardings: ``cache_spec`` by the
    rules, cut to what divides; the batch dim replicated where the batch
    is; a (L, B, S, Hkv, hd) leaf whose kv heads do not divide the model
    axis cut along its sequence over "model" instead."""
    c_sh = sanitize(_named(cache_spec(cfg), rules, mesh), cache, mesh)
    if batch_sharding(mesh, rules, global_batch).spec == PartitionSpec(None):

        def unbatched(sh: NamedSharding):
            spec = [None if i == 1 else s for i, s in enumerate(sh.spec)]
            return NamedSharding(mesh, PartitionSpec(*spec))

        c_sh = map_tree(unbatched, c_sh)
    model_ways = mesh.shape.get("model", 1)

    def seq_shard(sh: NamedSharding, leaf):
        shape = tuple(leaf.shape)
        if (
            len(shape) == 5
            and shape[2] == seq_len
            and shape[3] % model_ways != 0
            and seq_len % model_ways == 0
        ):
            spec = list(sh.spec) + [None] * (5 - len(sh.spec))
            if spec[3] in (None, "model") and spec[2] is None:
                spec[2], spec[3] = "model", None
                return NamedSharding(mesh, PartitionSpec(*spec))
        return sh

    return map_tree(seq_shard, c_sh, cache)


@dataclasses.dataclass
class CellSpec:
    """One (arch x shape) cell: its sharded step, its placed arguments,
    their shardings and the outputs', what it is (``meta``) and which
    arguments the step consumes."""

    step_fn: Any
    args: tuple  # placed trees (``Sharded``) and scalars
    in_shardings: tuple
    out_shardings: Any
    meta: dict
    donate_argnums: tuple = ()


def build_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: Mesh,
    rules: AxisRules | None = None,
    ocfg: OptimizerConfig | None = None,
    *,
    params: LMParams | None = None,
) -> CellSpec:
    """The reference's ``build_cell`` on ``mesh``'s devices: the layout
    policy, the parameters (``params``, else ``init_params`` on the mesh's
    first device; bf16 for serving, as the reference's) placed by their
    shardings, and for a train cell the optimizer's state (AdamW's or
    Adafactor's, with ``ef`` under ``compress_grads``), for a decode cell the
    cache (``init_cache``, bf16), each placed by the reference's
    shardings, with zero tokens (and labels, position, step) of the cell's
    shape; a VLM's cells also take zero ``image_embeds`` (GB, N, d) in bf16,
    placed by the batch sharding, and its decode cache's image K/V are
    computed from them with the cell's weights. Rule sets and mesh axes the
    sharded steps do not carry out raise ``NotImplementedError``."""
    cfg = pick_backend(cfg, shape)
    rules = choose_rules(cfg, shape, rules)
    dp_ways = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    ocfg = ocfg or choose_optimizer(cfg, shape, dp_ways=dp_ways)
    spmd.check_supported(cfg, mesh, rules)
    dev = mesh.devices[0]
    params = params if params is not None else init_params(cfg, seed=SEED, device=dev)
    spec, tree = params.spec(), params.tree()
    if shape.kind != "train":  # serving weights are bf16-resident
        tree = map_tree(
            lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x, tree
        )
    p_sh = sanitize(param_shardings(spec, rules, mesh), tree, mesh)
    GB, T = shape.global_batch, shape.seq_len
    bsh = batch_sharding(mesh, rules, GB)
    repl = NamedSharding(mesh, PartitionSpec())

    def zeros(*dims):
        return torch.zeros(dims, dtype=torch.int32, device=dev)

    placed = device_put(tree, p_sh)
    vlm = cfg.family == "vlm"
    images = None
    if vlm:
        dims = (GB, cfg.n_image_tokens, cfg.d_model)
        images = torch.zeros(dims, dtype=torch.bfloat16, device=dev)
    if shape.kind == "train":
        if ocfg.name == "adafactor":
            state = opt.adafactor_init(tree)
        else:
            state = opt.adamw_init(tree)
        if ocfg.compress_grads:
            state["ef"] = compression.init_error_feedback(tree)
        o_spec = _opt_spec_tree(ocfg, spec, tree)
        o_sh = sanitize(_named(o_spec, rules, mesh), state, mesh)
        b_sh = {"tokens": bsh, "labels": bsh}
        whole = {"tokens": zeros(GB, T), "labels": zeros(GB, T)}
        if vlm:
            b_sh["image_embeds"] = bsh
            whole["image_embeds"] = images
        batch = device_put(whole, b_sh)
        args = (placed, device_put(state, o_sh), batch, device_put(zeros(), repl))
        in_sh = (p_sh, o_sh, b_sh, repl)
        out_sh = (p_sh, o_sh, None)
        donate = (0, 1)
        meta = {"kind": "train", "optimizer": ocfg.name}
        step_fn = sharded.make_train_step(cfg, ocfg, mesh, rules)
    elif shape.kind == "prefill":
        args = (placed, device_put(zeros(GB, T), bsh))
        in_sh = (p_sh, bsh)
        if vlm:
            args += (device_put(images, bsh),)
            in_sh += (bsh,)
        out_sh = None
        donate = ()
        meta = {"kind": "prefill"}
        step_fn = sharded.make_prefill_step(cfg, mesh, rules)
    else:  # decode
        cache = init_cache(cfg, GB, T, image_embeds=images, params=params, device=dev)
        c_sh = cache_shardings(cfg, cache, rules, mesh, GB, T)
        tokens, pos = device_put(zeros(GB, 1), bsh), device_put(zeros(), repl)
        args = (placed, tokens, pos, device_put(cache, c_sh))
        in_sh = (p_sh, bsh, repl, c_sh)
        if vlm:
            args += (device_put(images, bsh),)
            in_sh += (bsh,)
        out_sh = (None, c_sh)
        donate = (3,)
        meta = {"kind": "decode", "backend": cfg.attention_backend}
        step_fn = sharded.make_serve_step(cfg, mesh, rules)
    meta.update(
        arch=cfg.name, shape=shape.name, family=cfg.family,
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        seq_len=T, global_batch=GB,
    )
    return CellSpec(step_fn, args, in_sh, out_sh, meta, donate)
