"""Kernels B1-B7 over their tiles at the keys the serving engine asks for,
on one card; the picks go into the tuning table.

The keys are those of the artifacts ``chip_smoke.py``'s paths 1-3 serve
(d=780, K=10 heads, the random 16384-SV model of ``chip_smoke.smoke_model``),
derived through each family's ``tile_lookup`` at the engine's buckets
32-1024: maclaurin at f32 and int8 (B1, B3; poly2 shares their keys),
dense fourier (B4, B5) and Fastfood (B6, B7) at F = 1024 and 4096, and the
exact fallback B2 at m = 16384 and buckets 32-256. Candidates, each with
the default among them, cut to the bucket (``clamp_block_n``) and without
repeats: ``block_n`` 32, 64 and 128 for B1-B5, with ``splits`` of auto,
1, 2, 4 and 8 for B1/B3; ``block_n`` 16, 32, 48 and 64 for B6/B7 (one
candidate a distinct ``fwht.kernel.block_rows`` tile). B8 and B9 are not
swept: B9 is compiled for one tile, and B8's chunk is read only by its
moments route, which no shape of the repo's models takes
(``maclaurin_attn.kernel.route``).

Noise guard (``autotune.autotune`` with ``rounds=3``): each candidate is
timed in turns with the default (default, candidate), over three rounds,
by ``chip_smoke.device_ms`` (20 calls queued behind a spinning kernel,
so the card sets the pace): at every
bucket here a call's kernels take less time than the host takes to
launch them, so ``chip_smoke.time_ms`` would read the host's launch rate,
which no tile changes. A candidate qualifies only if it beats the
default's reading beside it in every round by more than the default's
own spread (max - min of all its readings for the key); the qualifying
candidate of least median time is recorded, else the default, either way
with both medians and the card line in ``source``.

Prints the card line, one JSON line per key (``tile_sweep``), and writes
the table with ``tuning.save_table`` (merged into what ``--table``
holds). Needs a card.

    python3 scripts/tile_sweep.py [--table PATH] [--log PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BUCKETS = (32, 64, 128, 256, 512, 1024)
B2_BUCKETS = (32, 64, 128, 256)
ROUNDS = 3
SPLITS = (None, 1, 2, 4, 8)
ROWS = {"fwht": (16, 32, 48, 64), "fwht_q8": (16, 32, 48, 64)}
SPLIT_KERNELS = ("quadform", "quadform_q8")
SOURCE = "scripts/tile_sweep.py"


def candidates(kernel: str, bucket: int, art=None) -> list:
    """The default first, then every other tile to time at ``bucket``."""
    from repro_torch.kernels.common import TileConfig, tuning
    from repro_torch.kernels.fwht.kernel import block_rows
    from repro_torch.kernels.quadform.kernel import BLOCK_N

    default = tuning.lookup(kernel).clamp_block_n(bucket)
    splits = SPLITS if kernel in SPLIT_KERNELS else (None,)
    rows = ROWS.get(kernel, BLOCK_N)
    raw = [TileConfig(block_n=bn, splits=s) for bn in rows for s in splits]
    out, seen = [default], set()

    def launched(cfg):
        if kernel not in ROWS:
            return cfg
        stacks = art.arrays["ff_perm"].shape[0]
        return block_rows(cfg.block_n, bucket, stacks, art.num_heads)

    seen.add(launched(default))
    for cfg in raw:
        cfg = cfg.clamp_block_n(bucket)
        if launched(cfg) not in seen:
            seen.add(launched(cfg))
            out.append(cfg)
    return out


def sweep_key(kernel: str, key: str, build, cands, timer, card: str) -> dict:
    """Sweep ``cands`` (the default first) by ``autotune.autotune`` in
    ``ROUNDS`` rounds in turns with the default, record the guarded pick,
    and return the key's line."""
    from repro_torch.kernels.common import autotune

    default = cands[0]
    pick, rows = autotune.autotune(
        kernel,
        key,
        build,
        cands,
        rounds=ROUNDS,
        timer=timer,
        default=default,
        source=f"{SOURCE}; {card}",
    )
    ms = {row["config"]: row["ms"] for row in rows}
    return {
        "kernel": kernel,
        "key": key,
        "pick": pick.to_json(),
        "default": default.to_json(),
        "measured_ms": ms[pick],
        "default_ms": ms[default],
        "default_spread_ms": rows[0]["spread"],
        "candidates": [
            {"config": r["config"].to_json(), "median_ms": r["ms"], "pairs": r["pairs"]}
            for r in rows[1:]
        ],
    }


def run(dev, card: str, timer, buckets=BUCKETS, b2_buckets=B2_BUCKETS) -> list[dict]:
    """Sweep every key on ``dev``; returns the keys' lines (the picks are
    recorded in ``tuning``'s override tier)."""
    import torch

    from chip_smoke import kernel_args, served_artifacts, smoke_model
    from repro_torch.kernels.common import tuning
    from repro_torch.kernels.rbf_pred import kernel as rp

    svm, X_te, _, _ = smoke_model(dev)
    Z = torch.from_numpy(X_te[: max(buckets)].copy()).to(dev)
    lines = []
    for family, art in served_artifacts(svm):
        _, launch, args = kernel_args(art)
        for b in buckets:
            kernel, key = family.tile_lookup(art, b)

            def build(cfg, Zb=Z[:b]):
                return lambda: launch(Zb, *args, config=cfg)

            cands = candidates(kernel, b, art)
            lines.append(sweep_key(kernel, key, build, cands, timer, card))
            print("tile_sweep: " + json.dumps(lines[-1]), flush=True)
    X, A = svm.X, svm.alpha_y
    for b in b2_buckets:
        key = tuning.shape_key(d=X.shape[1], m=X.shape[0], n=b)

        def build(cfg, Zb=Z[:b]):
            return lambda: rp.rbf_scores_cuda(Zb, X, A, svm.gamma, svm.b, config=cfg)

        cands = candidates("rbf_pred", b)
        lines.append(sweep_key("rbf_pred", key, build, cands, timer, card))
        print("tile_sweep: " + json.dumps(lines[-1]), flush=True)
    return lines


def main() -> int:
    import torch

    from chip_smoke import card_line, device_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.common import tuning

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--table", default=tuning.TABLE_PATH, help="table to write")
    parser.add_argument("--log", default=None, help="also write the key lines here")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    build.build_all(["quadform.cu", "rbf_pred.cu", "rff_score.cu", "fastfood.cu"])
    lines = run(torch.device("cuda"), card, device_ms)
    if opts.log:
        Path(opts.log).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.log).write_text("".join(json.dumps(x) + "\n" for x in lines))
    Path(opts.table).parent.mkdir(parents=True, exist_ok=True)
    print(f"tile_sweep: wrote {tuning.save_table(opts.table)} ({tuning.platform()})")
    picks = sum(line["pick"] != line["default"] for line in lines)
    print(json.dumps({"keys": len(lines), "picks_other_than_default": picks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
