"""Every mesh position of a sharded step does the same work, on the CPU.

The reference compiles one SPMD program: every device runs the same ops
and holds the same bytes. The port's sharded steps hold to that through
``sharding.collectives`` (member j adds chunk j of every member's tensor
on its own device, then each member takes every chunk from its owner),
the train step (each replica updates its own copy of a block; a
microbatch's rows go straight to the positions that compute them, never
through one device) and Adafactor (each position's own block of
``vr``/``vc``). Here each cell is traced at every position
(``dryrun.trace_cell(..., classes=False)``) on fake devices, and across
positions max/min - 1 of the traced peak and of the bytes accessed is at
most LEVEL_BYTES, and of the flops at most LEVEL_FLOPS. What a position
may still do alone is the first-member route of a tensor with fewer
elements than its group has members (the loss and norm scalars).

Reduced configs, T = 16, B = 16:

* smollm-135m, one layer, train, DP_ONLY on (4, 1): every block's gradient
  all-reduced over the four replicas, AdamW on each replica (and Adafactor
  on each, its row and column sums over the same);
* smollm-135m, one layer, train, DEFAULT on (4, 1): FSDP's gathers and
  their reduce-scatters;
* smollm-135m, one layer, prefill, TP_ONLY on (1, 4): the tensor-parallel
  all-reduces of every block;
* llama-3.2-vision-90b, four layers, train, DEFAULT on (4, 1), two
  microbatches with image embeddings: each microbatch's rows and images
  copied from the positions that hold them.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_cost import price  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.train.train_step import OptimizerConfig  # noqa: E402

LEVEL_BYTES = 0.01
LEVEL_FLOPS = 0.001
OCFG = OptimizerConfig(warmup=2, total_steps=10)
T, B = 16, 16


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spread(values) -> float:
    return max(values) / min(values) - 1


@pytest.mark.parametrize(
    "name, layers, kind, rules, sizes, ocfg",
    [
        ("smollm-135m", 1, "train", "DP_ONLY_RULES", (4, 1), OCFG),
        ("smollm-135m", 1, "train", "DP_ONLY_RULES", (4, 1), dataclasses.replace(OCFG, name="adafactor")),
        ("smollm-135m", 1, "train", "DEFAULT_RULES", (4, 1), OCFG),
        ("smollm-135m", 1, "prefill", "TP_ONLY_RULES", (1, 4), None),
        ("llama-3.2-vision-90b", 4, "train", "DEFAULT_RULES", (4, 1), dataclasses.replace(OCFG, microbatches=2)),
    ],
    ids=["dp-adamw", "dp-adafactor", "default", "tp-prefill", "vlm-microbatches"],
)
def test_every_position_does_the_same_work(name, layers, kind, rules, sizes, ocfg):
    cfg = dataclasses.replace(ARCHS[name].reduced(), n_layers=layers)
    mesh = dryrun.fake_mesh(sizes, ("data", "model"))
    got = dryrun.trace_cell(cfg, ShapeConfig("c", T, B, kind), mesh, getattr(part, rules), ocfg, classes=False)
    devs = [str(d) for d in mesh.devices]
    costs = [price(got["records"], got["counts"][d]) for d in devs]
    peaks = [got["peak"][d] for d in devs]
    what = (name, kind, rules, peaks, [c["bytes_accessed"] for c in costs], [c["flops"] for c in costs])
    assert _spread(peaks) <= LEVEL_BYTES, what
    assert _spread([c["bytes_accessed"] for c in costs]) <= LEVEL_BYTES, what
    assert _spread([c["flops"] for c in costs]) <= LEVEL_FLOPS, what
