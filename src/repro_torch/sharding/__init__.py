"""Logical-axis partitioning rules, spec trees to shardings, placement over
a ``launch.Mesh`` (``partitioning``) and activation hints (``hints``): the
port of ``repro.sharding``."""

from repro_torch.sharding.partitioning import (
    AxisRules,
    DEFAULT_RULES,
    param_shardings,
    spec_to_pspec,
    batch_pspec,
)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "param_shardings",
    "spec_to_pspec",
    "batch_pspec",
]
