"""``TileConfig`` — the block shape a kernel wrapper launches with.

  ==============  ========================================================
  field           meaning
  ==============  ========================================================
  ``block_n``     Z rows per block: quadform (f32 and int8) and
                  rbf_pred are compiled for 32, 64 and 128, rff_score
                  (f32 and int8) for 32 and 64; fwht (f32 and int8)
                  takes any positive count
  ``splits``      blocks that share the reduction axis (Hessian column
                  tiles for quadform, SV tiles for rbf_pred, feature
                  tiles for rff_score), summed by a second pass in a
                  fixed order; ``None`` picks enough to fill the card.
                  fwht splits by Fastfood stack, one a block, and
                  ignores it
  ``chunk``       maclaurin_attn: sequence positions per chunk. Keys of
                  earlier chunks reach a query through the running
                  moments, keys of its own chunk exactly (the TPU
                  kernel's grid step; any positive count)
  ``block_q``     flash_attn: query rows per block (the kernel is
                  compiled for 64 only)
  ``block_k``     flash_attn: key rows per tile of the block's loop
                  (64 only). The wrapper's own ``block_q`` and
                  ``block_k`` arguments are the reference's blocks: they
                  set its refusal of padded non-causal keys, not the tile
  ==============  ========================================================

The TPU config's ``vmem_limit_mb`` and ``resolve_block_k`` sized a
Hessian slice resident in VMEM; no Hopper kernel keeps one resident, so
they have no counterpart. The SV tile of rbf_pred is fixed in its source
(``kernels/rbf_pred/kernel.py::BLOCK_M``), and so is the feature tile of
rff_score (``kernels/rff_score/kernel.py::BLOCK_F``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.common.tiles import ROW_QUANTUM, round_up


@dataclasses.dataclass(frozen=True)
class TileConfig:
    block_n: int = 64
    splits: int | None = None
    chunk: int = 128
    block_q: int = 64
    block_k: int = 64

    def __post_init__(self):
        for name in ("block_n", "chunk", "block_q", "block_k"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v > 0):
                raise ValueError(f"TileConfig.{name} must be a positive int, got {v!r}")
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
