"""Roofline terms on an NVIDIA H100: the serving kernels' cost priors, and
the analysis of the dry run's cells.

The serving half is a copy of ``repro.launch.roofline``'s (the prior
``compile_model`` prunes candidates with), with the card's constants in
place of the TPU's: 67 TFLOP/s fp32 outside the tensor cores (every
serving kernel here is fp32 SIMT) and 3.35 TB/s of HBM, the H100 SXM
data-sheet peaks at 700 W. The prior ranks candidates; measurement still
decides.

The analysis half (``model_flops``, ``wire_bytes``, ``analyze_cell``,
``load_all``, ``to_markdown``, ``main``) reads the dry run's cells
(``launch.dryrun``, ``results/dryrun_torch``) and derives, per device of
the 16 x 16 and the 2 x 16 x 16 meshes:

    compute term    = matmul flops of each dtype at that dtype's peak
                      (989.4 TFLOP/s dense bf16, 67 TFLOP/s f32: the port
                      keeps TF32 off in its library products), kernels B8
                      and B9's f32 work at the rate of f32-accurate 3xTF32
                      products (495 / 3 TFLOP/s, as the kernels' own
                      bounds count it) + the other flops at the f32 peak
    memory term     = bytes accessed / 3.35 TB/s
    collective term = the port's route (``route_bytes``: spread over the
                      members, what a member receives from the other
                      devices, the ring's multipliers where each member
                      is a device of its own) over NVLink, 450 GB/s a
                      direction, where a group's members lie in one node
                      of ``NODE_GPUS`` consecutive device indices, else
                      over the network between nodes, 50 GB/s a card
                      (NDR 400 Gb/s)

beside the reference's ring multipliers (``wire_bytes``, a copy) at the
same links: what an NCCL route would move. MODEL flops are the classic 6 N
D (train) or 2 N D, against the program's flops over every position.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.core.families.fourier import DEFAULT_NUM_FEATURES
from repro_torch.launch.op_cost import F32_PRODUCTS

PEAK_FLOPS = 67e12
HBM_BW = 3.35e12


def predict_seconds(flops: float, bytes_accessed: float) -> float:
    """Roofline lower bound for one kernel invocation: the binding term."""
    return max(flops / PEAK_FLOPS, bytes_accessed / HBM_BW)


def _row_blocks(n: int, block_n) -> int:
    """How many row tiles a batch of ``n`` splits into under ``block_n``."""
    n = max(1, int(n))
    b = int(block_n) if block_n else n
    b = max(1, min(b, n))
    return -(-n // b)


def quadform_tile_seconds(
    cfg, *, n: int, d: int, k: int, weight_bytes: int = 4
) -> float:
    """Analytic cost of one fused quadform step (Eq 3.8, all K heads).

    The (K, d, d) stacked Hessian is streamed once per row tile;
    ``weight_bytes=1`` models the int8 variant.
    """
    blocks = _row_blocks(n, getattr(cfg, "block_n", None) if cfg else None)
    flops = 2.0 * n * k * d * (d + 1)
    stream = float(blocks) * k * d * d * weight_bytes
    io = 4.0 * (n * d + n * k) + float(weight_bytes) * k * d
    return predict_seconds(flops, stream + io)


def rbf_tile_seconds(cfg, *, n: int, d: int, m: int) -> float:
    """Analytic cost of the exact expansion over ``m`` SVs (kernel B2):
    the SVs are streamed once per row tile."""
    blocks = _row_blocks(n, getattr(cfg, "block_n", None) if cfg else None)
    flops = 2.0 * n * m * d
    stream = float(blocks) * m * d * 4.0
    io = 4.0 * (n * d + n)
    return predict_seconds(flops, stream + io)


def rff_tile_seconds(
    cfg, *, n: int, d: int, f: int, k: int, weight_bytes: int = 4
) -> float:
    """Analytic cost of the fused RFF step (projection + readout)."""
    blocks = _row_blocks(n, getattr(cfg, "block_n", None) if cfg else None)
    flops = 2.0 * n * f * (d + k)
    stream = float(blocks) * (f * d + k * f) * float(weight_bytes)
    io = 4.0 * (n * d + n * k)
    return predict_seconds(flops, stream + io)


def fwht_tile_seconds(
    cfg, *, n: int, d: int, f: int, k: int, weight_bytes: int = 4
) -> float:
    """Analytic cost of the fused Fastfood step (FWHT stacks + readout).

    Per row, each of the F / d' stacks runs two d'-wide Walsh-Hadamard
    transforms plus the diagonals and the permutation, ~2 d' (log2 d' + 2)
    flops a stack, then the 2 F K readout. The O(F) diagonals (three at
    ``weight_bytes``, the phase at 4) and the (K, F) readout are streamed
    once per row tile.
    """
    blocks = _row_blocks(n, getattr(cfg, "block_n", None) if cfg else None)
    dd = 1 << max(1, (d - 1).bit_length())  # next pow2 >= d
    stacks = -(-int(f) // dd)
    fp = stacks * dd  # F rounded to stacks
    log_dd = max(1, dd.bit_length() - 1)
    flops = float(n) * (2.0 * stacks * dd * (log_dd + 2) + 2.0 * fp * k)
    stream = float(blocks) * (fp * (3.0 * weight_bytes + 4.0) + k * fp * weight_bytes)
    io = 4.0 * (n * d + n * k)
    return predict_seconds(flops, stream + io)


def family_candidate_seconds(
    family: str,
    dtype: str,
    *,
    n: int,
    d: int,
    k: int,
    num_features: int | None = None,
    structured: bool = False,
    cfg=None,
) -> float | None:
    """Predicted serving seconds for one ``compile_model`` candidate, or
    ``None`` where there is no model (the caller then measures)."""
    wb = 1 if dtype == "int8" else 4
    if family in ("maclaurin", "poly2"):
        return quadform_tile_seconds(cfg, n=n, d=d, k=k, weight_bytes=wb)
    if family == "fourier":
        f = int(num_features) if num_features else DEFAULT_NUM_FEATURES
        if structured:
            return fwht_tile_seconds(cfg, n=n, d=d, f=f, k=k, weight_bytes=wb)
        return rff_tile_seconds(cfg, n=n, d=d, f=f, k=k, weight_bytes=wb)
    return None


# ---------------------------------------------------------------- analysis

PEAK_BF16 = 989.4e12  # dense bf16 on the tensor cores, H100 SXM5 80GB at 700 W
PEAK_F32 = 67e12  # f32 without TF32
PEAK_TF32 = 495e12  # dense TF32 on the tensor cores
# f32-accurate products as the hand-written kernels make them: 3xTF32,
# three TF32 products (hi*hi + hi*lo + lo*hi) for one
PEAK_F32_3XTF32 = PEAK_TF32 / 3
NVLINK_BW = 450e9  # a direction, between two cards of one node
NODE_LINK_BW = 50e9  # a card's share of the network between nodes (NDR 400 Gb/s)
MATMUL_PEAKS = {
    "torch.bfloat16": PEAK_BF16,
    "torch.float16": PEAK_BF16,
    F32_PRODUCTS: PEAK_F32_3XTF32,
}
RESULTS_DIR = "results/dryrun_torch"


def wire_bytes(collective_ops: list[dict], default_group: int = 16) -> float:
    """The reference's ring multipliers on each op's result bytes."""
    total = 0.0
    for op in collective_ops:
        g = op.get("group_size") or default_group
        b = op.get("total_bytes", op["bytes"] * op.get("count", 1))
        k = op["kind"]
        if k == "all-reduce":
            total += 2 * (g - 1) / g * b
        elif k == "all-gather":
            total += (g - 1) / g * b
        elif k == "reduce-scatter":
            total += (g - 1) * b
        elif k == "all-to-all":
            total += (g - 1) / g * b
        else:  # collective-permute
            total += b
    return total


def route_bytes(op: dict) -> float:
    """Bytes a member receives over its links in one op (all its calls) on
    the port's route (``sharding.collectives``), from its result bytes b a
    member and the s distinct devices of its g members (g / s on each):
    what comes from the other devices' members. Spread over the members,
    an all-reduce or a max takes (s - 1) / s of a result twice (its chunk
    from each, then every chunk from its owner), an all-gather or an
    all-to-all once, a reduce-scatter its chunk of each of those members'
    g (s - 1) / s inputs; on devices of their own (s = g), ``wire_bytes``'
    ring multipliers. A "reduce" (scalars summed on the first member)
    brings it those members' wholes, a "gather" their parts."""
    b = op.get("total_bytes", op["bytes"] * op.get("count", 1))
    g = op.get("group_size") or 1
    s = op.get("span", g)
    away = (s - 1) / s  # the share of the members on other devices
    if op["kind"] in ("all-reduce", "all-max"):
        return 2 * away * b
    if op["kind"] in ("reduce-scatter", "reduce"):
        return away * g * b
    return away * b


def route_wire_bytes(collective_ops: list[dict]) -> float:
    return sum(route_bytes(op) for op in collective_ops)


def link_seconds(collective_ops: list[dict], ring: bool = False) -> float:
    """Time of the ops on their links: NVLink within a node, the network
    between nodes (an op's ``nodes`` > 1)."""
    t = 0.0
    for op in collective_ops:
        nbytes = wire_bytes([op]) if ring else route_bytes(op)
        t += nbytes / (NVLINK_BW if op.get("nodes", 1) <= 1 else NODE_LINK_BW)
    return t


def compute_seconds(cost: dict) -> float:
    """Matmul flops of each dtype (and the kernels' work at their rate)
    at its peak, the rest at the f32 peak."""
    mm = cost.get("matmul_flops", {})
    rest = cost["flops"] - sum(mm.values())
    return sum(f / MATMUL_PEAKS.get(dt, PEAK_F32) for dt, f in mm.items()) + rest / PEAK_F32


def model_flops(meta: dict) -> float:
    n = meta["active_params"]
    tokens = meta["global_batch"] * (1 if meta["kind"] == "decode" else meta["seq_len"])
    mult = 6 if meta["kind"] == "train" else 2
    return mult * n * tokens


def analyze_cell(rec: dict) -> dict:
    n_dev = rec["n_devices"]
    ops = rec.get("collective_ops", [])
    terms = {
        "compute": compute_seconds(rec["cost"]),
        "memory": rec["cost"]["bytes_accessed"] / HBM_BW,
        "collective": link_seconds(ops),
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    flops_global = rec.get("total", {}).get("flops", rec["cost"]["flops"] * n_dev)
    ideal = mf / n_dev / PEAK_BF16
    bound = max(terms.values())
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec.get("mesh", "16x16"),
        "kind": rec["kind"],
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "t_collective_ring_s": link_seconds(ops, ring=True),
        "route_wire_bytes": route_wire_bytes(ops),
        "ring_wire_bytes": wire_bytes(ops),
        "dominant": dominant,
        "model_flops": mf,
        "flops_global": flops_global,
        "useful_ratio": mf / flops_global if flops_global else 0.0,
        "roofline_fraction": ideal / bound if bound else 0.0,
        "bound_s": bound,
        "mem_gib_per_dev": rec["memory"]["peak_device_bytes"] / 2**30,
        "collectives": rec.get("collectives", {}),
        "rules": rec.get("rules", "auto"),
        "rule_set": rec.get("rule_set"),
    }


def load_all(mesh: str = "16x16", rules: str = "auto") -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(RESULTS_DIR, f"*__{mesh}.json"))):
        # exact arch__shape__mesh tags only: variants carry more __suffixes
        with open(path) as f:
            rec = json.load(f)
        if rec.get("rules", "auto") != rules or rec["mesh"] != mesh:
            continue
        out.append(analyze_cell(rec))
    return out


def to_markdown(rows: list[dict]) -> str:
    hdr = (
        "| arch | shape | mesh | compute (s) | memory (s) | collective (s) | ring (s) | dominant | "
        "MODEL/flops | roofline frac | mem GiB/dev |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"{r['t_collective_ring_s']:.3e} | **{r['dominant']}** | "
            f"{r['useful_ratio']:.2f} | {r['roofline_fraction']:.3f} | "
            f"{r['mem_gib_per_dev']:.1f} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main():
    """Writes ``results/roofline_torch.{md,json}`` from the dry run's cells;
    with ``--keep``, the rows of cells that ``results/dryrun_torch`` does
    not hold are kept from the existing ``results/roofline_torch.json``
    (a part of the grid traced again)."""
    rows = load_all("16x16") + load_all("2x16x16")
    if "--keep" in sys.argv[1:] and os.path.exists("results/roofline_torch.json"):
        with open("results/roofline_torch.json") as f:
            old = json.load(f)
        key = lambda r: (r["mesh"] != "16x16", r["arch"], r["shape"])  # noqa: E731
        new = {key(r) for r in rows}
        rows = sorted(rows + [r for r in old if key(r) not in new], key=key)
    os.makedirs("results", exist_ok=True)
    md = to_markdown(rows)
    with open("results/roofline_torch.md", "w") as f:
        f.write(md)
    with open("results/roofline_torch.json", "w") as f:
        json.dump(rows, f, indent=1)
    print(md)
    print(f"{len(rows)} cells analyzed -> results/roofline_torch.md")


if __name__ == "__main__":
    main()
