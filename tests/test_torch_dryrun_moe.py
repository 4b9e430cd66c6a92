"""The dry run against the JAX package's on reduced qwen3-moe, on the CPU.

As ``test_torch_dryrun.py`` holds smollm-135m's cells: the reference's
cells compiled for four forced host devices in one subprocess, the port's
traced once on a (2, 2) mesh of fake devices. Under the rules
``choose_rules`` picks (DEFAULT for the train cell, TP_ONLY for serving)
and under EP_DATA: argument, output and alias bytes equal at every
position; matmul FLOPs equal the reference's dot FLOPs for the prefill,
the decode and the EP_DATA train cells, and lie within 1% for the
DEFAULT train cell (+0.15%).

That gap is the router's weight gradient. GSPMD computes each device's
FSDP shard of it (``f32[8,64]``: the (E, d/2) block over the data group's
tokens) where the port computes a position's whole (d, E) block over its
own 128 tokens and then sums it over the replicas: 2 x 128 x 64 x 8 =
131072 more flops a layer, 262144 over the cell's two layers, exactly the
difference. Under EP_DATA the router is unsharded on both sides and the
counts are equal.
"""

import pytest

pytest.importorskip("torch")

from test_torch_dryrun import check_cells  # noqa: E402

MOE = "qwen3-moe-30b-a3b"
CELLS = [
    (MOE, None, "train", 64),
    (MOE, None, "prefill", 64),
    (MOE, None, "decode", 128),
    (MOE, "EP_DATA_RULES", "train", 64),
]


def test_qwen3_moe_cells_against_reference():
    exact = {(MOE, None, "prefill"), (MOE, None, "decode"), (MOE, "EP_DATA_RULES", "train")}
    check_cells(CELLS, exact_dots=exact, dot_rel=0.01)
