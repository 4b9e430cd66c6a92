"""Best-of-N timing of a callable on the device it runs on, and the
rank-and-prune step of a tile search.

``repro``'s ``autotune`` also sweeps ``TileConfig`` candidates and
records winners into a tuning table; the port gets that once there are
H100 measurements to record. ``measure`` is what ``compile_model`` needs
to time each candidate artifact; ``prune_candidates`` picks which
candidates a sweep measures from a cost prior (``launch.roofline``).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.kernels.common.config import TileConfig


def measure(
    fn: Callable[[], object],
    *,
    repeats: int = 5,
    warmup: int = 2,
    device=None,
) -> float:
    """Best-of-``repeats`` seconds of one call of ``fn``, after ``warmup``
    calls.

    On a CUDA ``device`` each call is timed with CUDA events on the
    current stream after a synchronize, so the time is the device's; on
    the CPU with ``time.perf_counter`` around the call.
    """
    device = torch.device("cpu" if device is None else device)
    for _ in range(warmup):
        fn()
    best = float("inf")
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(repeats):
            torch.cuda.synchronize(device)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def prune_candidates(
    candidates: list[TileConfig],
    default: TileConfig,
    prior: Callable[[TileConfig], float],
    keep: int,
) -> list[TileConfig]:
    """The ``keep`` candidates of least predicted cost under ``prior``, and
    ``default`` always, in the order given.

    Pruning decides only what is measured; keeping the default in the
    measured set keeps a tuned pick never worse than the default, however
    wrong the prior is.
    """
    ranked = sorted(candidates, key=prior)
    kept = set(ranked[: max(1, int(keep))])
    kept.add(default)
    return [c for c in candidates if c in kept]
