"""Measure-don't-guess block-size selection.

``sweep`` times one kernel family over a list of candidate
``TileConfig``s on the device it runs on and returns every measurement;
``autotune`` also records the winner into the tuning registry, so later
``tuning.lookup`` calls (and so the serving engine) pick it up. The
candidate list always holds the default, so the recorded pick is never
slower than the default as measured: with one round, the argmin over a
set holding it; with several (``rounds``), a candidate must beat the
default timed beside it in every round by more than the default's own
spread. ``scripts/tile_sweep.py`` writes the checked-in table this way.
``measure`` is also what ``compile_model`` times each candidate artifact
with, and ``prune_candidates`` picks which candidates a sweep measures
from a cost prior (``launch.roofline``).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Iterable

import torch

from repro_torch.kernels.common import tuning
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


def sweep(
    build: Callable[[TileConfig], Callable[[], object]],
    candidates: Iterable[TileConfig],
    *,
    repeats: int = 5,
    warmup: int = 2,
    device=None,
    timer: Callable[[Callable[[], object]], float] | None = None,
) -> list[dict]:
    """Time ``build(config)()`` for every candidate with ``measure`` on
    ``device``, or with ``timer`` (milliseconds of one call) where given.

    ``build`` returns a nullary callable closing over operands already on
    the device (so no build or host-to-device copy is timed). Returns one
    row per candidate: {"config": TileConfig, "ms": float}.
    """
    timer = timer or _measure_ms(repeats, warmup, device)
    return [{"config": cfg, "ms": timer(build(cfg))} for cfg in candidates]


def _measure_ms(repeats: int, warmup: int, device) -> Callable:
    """``measure`` as a timer: milliseconds of one call of ``fn``."""
    return lambda fn: 1e3 * measure(fn, repeats=repeats, warmup=warmup, device=device)


def _in_turns(
    build: Callable[[TileConfig], Callable[[], object]],
    candidates: list[TileConfig],
    default: TileConfig,
    rounds: int,
    timer: Callable[[Callable[[], object]], float],
) -> tuple[TileConfig, list[dict]]:
    """Time every other candidate right after the default, ``rounds``
    times, and keep the default unless a candidate beats the reading
    beside it in every round by more than the default's spread (max - min
    of all its readings); of those that do, the least median wins.

    Rows are in ``candidates``' order, ``ms`` their median; the default's
    row carries ``spread``, every other row its (default, candidate)
    ``pairs``.
    """
    fns = {cfg: build(cfg) for cfg in candidates}
    rest = [cfg for cfg in candidates if cfg != default]
    base, pairs = [], {cfg: [] for cfg in rest}
    for _ in range(rounds):
        for cfg in rest:
            d = timer(fns[default])
            pairs[cfg].append((d, timer(fns[cfg])))
            base.append(d)
    if not rest:  # the default alone
        base = [timer(fns[default]) for _ in range(rounds)]
    spread = max(base) - min(base)
    median = {cfg: statistics.median(x for _, x in pairs[cfg]) for cfg in rest}
    median[default] = statistics.median(base)
    wins = [cfg for cfg in rest if all(d - x > spread for d, x in pairs[cfg])]
    winner = min(wins, key=median.get) if wins else default
    rows = [
        {"config": cfg, "ms": median[cfg], "spread": spread}
        if cfg == default
        else {"config": cfg, "ms": median[cfg], "pairs": pairs[cfg]}
        for cfg in candidates
    ]
    return winner, rows


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


def autotune(
    kernel: str,
    key: str,
    build: Callable[[TileConfig], Callable[[], object]],
    candidates: Iterable[TileConfig],
    *,
    repeats: int = 5,
    warmup: int = 2,
    source: str | None = None,
    prior: Callable[[TileConfig], float] | None = None,
    prior_keep: int | None = None,
    device=None,
    rounds: int = 1,
    timer: Callable[[Callable[[], object]], float] | None = None,
    default: TileConfig | None = None,
) -> tuple[TileConfig, list[dict]]:
    """Sweep, pick the fastest, record it for (kernel, platform(), key).

    Returns (winner, all sweep rows). The default config (``default``,
    else ``tuning.lookup(kernel)``) is appended to the candidates if
    absent, so the recorded winner can only tie or beat it. With
    ``prior`` and ``prior_keep``, only the ``prior_keep`` candidates of
    least predicted cost are measured (``prune_candidates``): rank and
    prune, never pick by prediction; the winner is still chosen by
    measurement over a set that holds the default. With ``rounds`` > 1 the
    pick is guarded against noise (``_in_turns``); ``timer`` replaces
    ``measure`` (milliseconds of one call).
    """
    cands = list(candidates)
    if default is None:
        default = tuning.lookup(kernel)
    if default not in cands:
        cands.append(default)
    if prior is not None and prior_keep is not None:
        cands = prune_candidates(cands, default, prior, prior_keep)
    timer = timer or _measure_ms(repeats, warmup, device)
    if rounds > 1:
        winner, rows = _in_turns(build, cands, default, rounds, timer)
    else:
        rows = sweep(build, cands, timer=timer)
        winner = min(rows, key=lambda r: r["ms"])["config"]
    ms = {r["config"]: r["ms"] for r in rows}
    tuning.record(
        kernel,
        key,
        winner,
        measured_ms=ms[winner],
        default_ms=ms[default],
        source=source,
    )
    return winner, rows
