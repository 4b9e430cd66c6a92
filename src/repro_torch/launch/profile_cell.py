"""Per-cell profile of a dry run: where its flops, bytes and collectives
come from.

    PYTHONPATH=src python -m repro_torch.launch.profile_cell <cell-tag>

The counterpart of ``repro/launch/profile_cell.py``, which walks a cell's
stored HLO. This reads ``results/dryrun_torch/<tag>.ops.json.gz`` (the op
counts of the cell's reported position at each depth traced,
``launch.dryrun``) and prints the top contributors: bytes by op kind and
collective bytes by kind and group, extrapolated to the full depth; bytes
and matmul flops by result shape, at the deepest depth traced.
"""

from __future__ import annotations

import gzip
import json
import sys
from collections import defaultdict

from repro_torch.launch.dryrun import (
    RESULTS_DIR,
    _extrapolate_counts,
    _record,
    fit_sequences,
    stored_collectives,
)
from repro_torch.launch.op_cost import cost


def _shape(rec) -> str:
    _, outs, _, _ = rec
    if not outs:
        return "-"
    shape, dtype = outs[0]
    return f"{dtype.split('.')[-1]}[{','.join(str(s) for s in shape)}]"


def profile(saved: dict):
    """(flops by op kind, bytes by op kind, bytes by result shape, matmul
    flops by result shape, collective bytes by kind and group) of a stored
    position: by kind at the full depth; by shape at the deepest depth
    traced (a stacked leaf's shapes change with the depth)."""
    P = saved["periods"]
    flops_by, bytes_by = [], []
    for recs, counts in zip(saved["records"], saved["counts"]):
        f_by, b_by = defaultdict(float), defaultdict(float)
        for i, n in counts.items():
            rec = _record(recs[int(i)])
            f, _, b = cost(rec)
            f_by[rec[0]] += n * f
            b_by[rec[0]] += n * b
        flops_by.append(f_by)
        bytes_by.append(b_by)
    bytes_by_shape, flops_by_shape = defaultdict(float), defaultdict(float)
    for i, n in saved["counts"][-1].items():
        rec = _record(saved["records"][-1][int(i)])
        _, mm, b = cost(rec)
        bytes_by_shape[_shape(rec)] += n * b
        if mm:
            flops_by_shape[_shape(rec)] += n * sum(mm.values())
    coll_by = defaultdict(float)
    for (kind, nbytes, group, *_), n in fit_sequences(stored_collectives(saved), P).items():
        coll_by[f"{kind} g={group}"] += n * nbytes
    return (
        _extrapolate_counts(flops_by, P),
        _extrapolate_counts(bytes_by, P),
        dict(bytes_by_shape),
        dict(flops_by_shape),
        dict(coll_by),
    )


def main():
    tag = sys.argv[1]
    with gzip.open(f"{RESULTS_DIR}/{tag}.ops.json.gz", "rt") as f:
        saved = json.load(f)
    _, bb, bbs, fbs, cb = profile(saved)
    print(f"== {tag} (position {saved['position']})")
    print("-- bytes by op kind (GB):")
    for k, v in sorted(bb.items(), key=lambda kv: -kv[1])[:8]:
        print(f"   {k:24s} {v/1e9:10.2f}")
    print(f"-- bytes by result shape (GB), at {len(saved['counts'])} periods:")
    for k, v in sorted(bbs.items(), key=lambda kv: -kv[1])[:10]:
        print(f"   {k:44s} {v/1e9:10.2f}")
    print(f"-- matmul flops by result shape (GFLOP), at {len(saved['counts'])} periods:")
    for k, v in sorted(fbs.items(), key=lambda kv: -kv[1])[:10]:
        print(f"   {k:44s} {v/1e9:10.2f}")
    print("-- collective bytes by kind/group (GB):")
    for k, v in sorted(cb.items(), key=lambda kv: -kv[1])[:8]:
        print(f"   {k:24s} {v/1e9:10.2f}")


if __name__ == "__main__":
    main()
