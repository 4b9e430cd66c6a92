"""``TileConfig`` — the block shape a kernel wrapper launches with.

  ==============  ========================================================
  field           meaning
  ==============  ========================================================
  ``block_n``     Z rows per block: quadform is compiled for 32, 64 and
                  128, rbf_pred for 32 and 64
  ``splits``      blocks that share the reduction axis (Hessian column
                  tiles for quadform, SV tiles for rbf_pred), summed by
                  a second pass in a fixed order; ``None`` picks enough
                  to fill the card
  ==============  ========================================================

The TPU config's ``vmem_limit_mb`` and ``resolve_block_k`` sized a
Hessian slice resident in VMEM; no Hopper kernel keeps one resident, so
they have no counterpart. The SV tile of rbf_pred is fixed in its source
(``kernels/rbf_pred/kernel.py::BLOCK_M``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.common.tiles import ROW_QUANTUM, round_up


@dataclasses.dataclass(frozen=True)
class TileConfig:
    block_n: int = 64
    splits: int | None = None

    def __post_init__(self):
        if not (isinstance(self.block_n, int) and self.block_n > 0):
            raise ValueError(
                f"TileConfig.block_n must be a positive int, got {self.block_n!r}"
            )
        if self.splits is not None and not (
            isinstance(self.splits, int) and self.splits > 0
        ):
            raise ValueError("TileConfig.splits must be None or a positive int")

    def with_(self, **updates) -> "TileConfig":
        """Functional update (``dataclasses.replace`` spelled tersely)."""
        return dataclasses.replace(self, **updates)

    def clamp_block_n(self, n: int) -> "TileConfig":
        """Shrink block_n to the batch so small buckets run small tiles."""
        target = min(self.block_n, max(ROW_QUANTUM, round_up(n, ROW_QUANTUM)))
        return self if target == self.block_n else self.with_(block_n=target)
