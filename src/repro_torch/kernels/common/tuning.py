"""Per-(kernel, platform, shape bucket) tile tuning registry.

The registry answers one question on the serving hot path: *which
``TileConfig`` should this kernel use for this shape on this card?*
Resolution order, as ``repro``'s:

  1. in-process overrides (``record(...)``: what the autotuner and tests
     write);
  2. the checked-in measured table ``tuning_table.json`` next to this
     module (written by ``scripts/tile_sweep.py`` on the card, keyed by
     ``platform()``, the card's name, so a pick measured on one card
     model never reaches another, nor the CPU);
  3. the per-kernel Hopper default (``DEFAULTS``).

Keys are canonical strings from ``shape_key(d=.., k=.., n=..)``, the
dimension names sorted, batch dimensions bucketed by ``bucket`` (the
serving engine's bucketing policy), so every caller produces the same key
for the same bucket. Lookup never fails on a known kernel: an unknown key
falls back to ``DEFAULTS``; ``lookup(..., strict=True)`` raises instead.

To add a measured entry, call ``record(...)`` and ``save_table()``, or
append under ``entries.<platform>.<kernel>.<key>`` in the JSON.
``validate_table`` drops, with a warning, an entry whose config its
kernel cannot launch.
"""

from __future__ import annotations

import functools
import json
import os
import re
import threading
import warnings

import torch

from repro_torch.kernels.common.config import TileConfig

TABLE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tuning_table.json"
)

DEFAULTS: dict[str, TileConfig] = {
    # B1 and B2: 128 rows a block (eight warps), the most that a block's
    # shared memory holds in a three-stage ring; small batches clamp down.
    # B3 likewise: 128 rows ran fastest at n=1024 in
    # scripts/quadform_q8_sweep.py (64 and 32 rows 1.3x and 1.9x slower).
    "quadform": TileConfig(block_n=128),
    "quadform_q8": TileConfig(block_n=128),
    "rbf_pred": TileConfig(block_n=128),
    # B4 and B5: 128 rows a block, so the W tiles are read 8 times at n=1024
    # (a block's warps split each stage's k-steps in two).
    "rff_score": TileConfig(block_n=128),
    "rff_score_q8": TileConfig(block_n=128),
    # B6/B7: the most rows a block may own (whole 16-row cos tiles); the
    # wrapper (fwht.kernel.block_rows) takes fewer where that spreads the
    # rows over more SMs. 32 gives the fastest tile of
    # scripts/fastfood_sweep.py at n=32 and 1024, F=1024 and 4096 (16, 16,
    # 16, 32 rows; NVIDIA H100 80GB HBM3, 700.00 W).
    "fwht": TileConfig(block_n=32),
    "fwht_q8": TileConfig(block_n=32),
    # B8: one 64-row sub-tile a chunk, so the exact intra-chunk term (which
    # grows with the chunk) is as small as the kernel's tiling allows. The
    # model's chunked form runs at this chunk too.
    "maclaurin_attn": TileConfig(chunk=64),
    # B9: the one tile the kernel is compiled for, whatever blocks a call
    # names (those set the reference's refusal of padded keys only).
    "flash_attn": TileConfig(block_q=64, block_k=64),
}

# Canonical shape_key grammar: underscore-joined <dims><int> groups, e.g.
# "d64_k10_n1024" (whatever shape_key() can emit).
_KEY_RE = re.compile(r"^[a-z]+\d+(?:_[a-z]+\d+)*$")

_lock = threading.Lock()
_overrides: dict[tuple[str, str, str], dict] = {}
_overrides_meta: dict[tuple[str, str, str], dict] = {}
_table_cache: dict | None = None


@functools.cache
def platform() -> str:
    """The key the registry partitions on: the card's name as
    ``torch.cuda.get_device_name()`` gives it (e.g. ``"NVIDIA H100 80GB
    HBM3"``), or ``"cpu"`` where no card is present."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"


def shape_key(**dims) -> str:
    """Canonical bucket key: ``shape_key(d=64, k=10, n=1024) -> 'd64_k10_n1024'``.

    Dimension names are sorted so call-site order never matters. Batch-like
    dimensions should be passed through ``bucket()`` first so every caller
    lands on the keys the sweep records.
    """
    return "_".join(f"{name}{int(dims[name])}" for name in sorted(dims))


def bucket(n: int, lo: int = 32, hi: int = 8192) -> int:
    """Canonical batch bucket: next power of two, floored at lo, capped at hi.

    The serving engine's shape buckets, the sweep's recorded keys and the
    dispatch-level lookups all share it, so a batch of 1000 resolves the
    entry measured for the 1024 bucket.
    """
    if n <= lo:
        return lo
    return min(hi, 1 << (int(n) - 1).bit_length())


def launch_refusal(kernel: str, config: TileConfig) -> str | None:
    """Why ``kernel``'s wrapper would refuse to launch ``config``, or None:
    the sets the wrappers enforce (``BLOCK_N`` rows for B1-B5, whole
    16-row tiles for B6/B7, B9's one compiled tile; B8 takes any chunk)."""
    from repro_torch.kernels.fwht.kernel import TILE_ROWS
    from repro_torch.kernels.quadform import kernel as quadform
    from repro_torch.kernels.rbf_pred import kernel as rbf_pred
    from repro_torch.kernels.rff_score import kernel as rff_score

    rows = {
        "quadform": quadform.BLOCK_N,
        "quadform_q8": quadform.BLOCK_N,
        "rbf_pred": rbf_pred.BLOCK_N,
        "rff_score": rff_score.BLOCK_N,
        "rff_score_q8": rff_score.BLOCK_N,
    }
    if kernel in rows:
        if config.block_n not in rows[kernel]:
            return f"block_n={config.block_n} not one of {rows[kernel]}"
    elif kernel in ("fwht", "fwht_q8"):
        if config.block_n % TILE_ROWS:
            return f"block_n={config.block_n} not a multiple of {TILE_ROWS}"
    elif kernel == "flash_attn":
        tile = DEFAULTS["flash_attn"]
        if (config.block_q, config.block_k) != (tile.block_q, tile.block_k):
            return f"flash_attn runs one {tile.block_q} x {tile.block_k} tile"
    return None


def _read_table(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {"version": 1, "entries": {}}


def validate_table(table: dict, *, origin: str = "tuning table") -> dict:
    """Drop malformed entries, warning once per problem instead of letting a
    corrupt checked-in table surface later deep in a launch. Checks, per
    ``entries.<platform>.<kernel>.<key>``:

      * the kernel is a known family (has a ``DEFAULTS`` entry);
      * the key matches the ``shape_key`` grammar;
      * the entry carries a ``config`` dict that ``TileConfig`` accepts;
      * the kernel's wrapper can launch that config (``launch_refusal``).

    Returns a NEW table containing only the surviving entries (input is
    not mutated); table-level shape problems reset to an empty table.
    """
    if not isinstance(table, dict) or not isinstance(table.get("entries", {}), dict):
        warnings.warn(f"{origin}: top-level structure malformed; ignoring table")
        return {"version": 1, "entries": {}}
    clean: dict = {"version": table.get("version", 1), "entries": {}}
    for plat, kernels in table.get("entries", {}).items():
        if not isinstance(kernels, dict):
            warnings.warn(f"{origin}: platform {plat!r} entries malformed; dropped")
            continue
        for kernel, keys in kernels.items():
            if kernel not in DEFAULTS:
                warnings.warn(
                    f"{origin}: unknown kernel {kernel!r} under {plat!r} "
                    f"(known: {sorted(DEFAULTS)}); dropped"
                )
                continue
            if not isinstance(keys, dict):
                warnings.warn(f"{origin}: {plat}/{kernel} entries malformed; dropped")
                continue
            for key, entry in keys.items():
                where = f"{plat}/{kernel}/{key}"
                if not _KEY_RE.match(key):
                    warnings.warn(
                        f"{origin}: malformed shape_key {key!r} under "
                        f"{plat}/{kernel}; dropped"
                    )
                    continue
                cfg = entry.get("config") if isinstance(entry, dict) else None
                if not isinstance(cfg, dict):
                    warnings.warn(
                        f"{origin}: entry {where} has no config dict; dropped"
                    )
                    continue
                try:
                    refusal = launch_refusal(kernel, TileConfig.from_json(cfg))
                except (TypeError, ValueError) as e:
                    warnings.warn(f"{origin}: bad config for {where} ({e}); dropped")
                    continue
                if refusal is not None:
                    warnings.warn(
                        f"{origin}: {where} cannot launch ({refusal}); dropped"
                    )
                    continue
                slot = clean["entries"].setdefault(plat, {}).setdefault(kernel, {})
                slot[key] = entry
    return clean


def load_table(path: str = TABLE_PATH) -> dict:
    """Read + validate a tuning table file (malformed entries are dropped
    with a warning; a missing/unreadable file is an empty table)."""
    return validate_table(_read_table(path), origin=path)


def _load_table() -> dict:
    """The checked-in default table, read once per process (lookup tier 2)."""
    global _table_cache
    if _table_cache is None:
        _table_cache = load_table(TABLE_PATH)
    return _table_cache


def lookup(
    kernel: str,
    key: str | None = None,
    *,
    platform_name: str | None = None,
    strict: bool = False,
) -> TileConfig:
    """Resolve the ``TileConfig`` for one (kernel, platform, bucket).

    ``key=None`` skips the measured tiers and returns the kernel default
    (what a caller with no shape information gets).
    """
    plat = platform_name or platform()
    if key is not None:
        with _lock:
            hit = _overrides.get((plat, kernel, key))
        if hit is not None:
            return TileConfig.from_json(hit)
        entry = _load_table().get("entries", {}).get(plat, {}).get(kernel, {}).get(key)
        if entry is not None:
            return TileConfig.from_json(entry["config"])
    if strict:
        raise KeyError(f"no measured tuning for ({plat}, {kernel}, {key})")
    if kernel not in DEFAULTS:
        raise KeyError(f"unknown kernel family {kernel!r}; known: {sorted(DEFAULTS)}")
    return DEFAULTS[kernel]


def record(
    kernel: str,
    key: str,
    config: TileConfig,
    *,
    platform_name: str | None = None,
    measured_ms: float | None = None,
    default_ms: float | None = None,
    source: str | None = None,
) -> None:
    """Write one measured entry into the in-process override tier."""
    meta = {
        k: v
        for k, v in (
            ("measured_ms", measured_ms),
            ("default_ms", default_ms),
            ("source", source),
        )
        if v is not None
    }
    slot = (platform_name or platform(), kernel, key)
    with _lock:
        _overrides[slot] = config.to_json()
        _overrides_meta[slot] = meta


def clear_overrides() -> None:
    """Drop every in-process override (test isolation)."""
    with _lock:
        _overrides.clear()
        _overrides_meta.clear()


def save_table(path: str = TABLE_PATH) -> str:
    """Merge the in-process overrides into the table at ``path`` and write it.

    The sweep calls this after recording its picks, producing the
    checked-in ``tuning_table.json`` the next process reads back. The
    TARGET file is re-read and merged (never the in-process cache, which
    may belong to a different path); the cached default table is refreshed
    only when writing to the default location.
    """
    global _table_cache
    table = _read_table(path)
    entries = table.setdefault("entries", {})
    with _lock:
        for (plat, kernel, key), cfg in _overrides.items():
            slot = entries.setdefault(plat, {}).setdefault(kernel, {})
            slot[key] = {"config": cfg, **_overrides_meta.get((plat, kernel, key), {})}
    table["version"] = 1
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    if path == TABLE_PATH:
        _table_cache = table
    return path


def reload_table() -> None:
    """Forget the cached table so the next lookup re-reads the file."""
    global _table_cache
    _table_cache = None
