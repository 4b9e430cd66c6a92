"""Shared tiling and tuning for ``repro_torch.kernels.*``.

  * ``tiles``    — round-up and split arithmetic for grids over ragged
    shapes (the kernels mask their own edges, so nothing is padded);
  * ``config``   — the frozen ``TileConfig`` every kernel wrapper takes;
  * ``tuning``   — measured-or-default ``TileConfig`` resolution per
    (kernel, platform, shape bucket), backed by the checked-in
    ``tuning_table.json`` of H100 picks;
  * ``autotune`` — the timing and sweep harness that produces such
    measurements (``scripts/tile_sweep.py`` drives it on the card).
"""

from repro_torch.kernels.common import autotune, tiles, tuning
from repro_torch.kernels.common.config import TileConfig

__all__ = ["TileConfig", "autotune", "tiles", "tuning"]
