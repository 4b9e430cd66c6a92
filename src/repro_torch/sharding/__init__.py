"""Logical-axis partitioning rules, spec trees to shardings, placement over
a ``launch.Mesh`` (``partitioning``) and activation hints (``hints``): the
port of ``repro.sharding``. Beyond it, what the reference leaves to GSPMD:
the collectives (``collectives``), the lockstep executor of a rule-sharded
LM program (``spmd``) and its train, prefill and decode steps (``step``).
``__all__`` keeps the reference's names."""

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
