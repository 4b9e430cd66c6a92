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

``build_cell`` has no counterpart: it builds ``jax.ShapeDtypeStruct``
arguments for ``jax.jit(...).lower`` of a sharded step, which the port
does not lower.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES,
    DP_ONLY_RULES,
    EP_DATA_RULES,
    TP_ONLY_RULES,
    AxisRules,
    NamedSharding,
    PartitionSpec,
    map_tree,
)
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
