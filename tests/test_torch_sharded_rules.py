"""The rule-sharded LM steps under the last two rule sets, SP_RULES and
EP_DP_RULES, against the port's one-device steps, on a (data, model) mesh
of 2 x 2 CPU slots.

SP_RULES is DEFAULT_RULES with the residual stream cut along the sequence
over "model" between blocks: each block takes its RMSNorm on its rows,
all-gathers the sequence, and reduce-scatters its row-cut outputs back to
the sequence blocks (the embedding's vocab-cut lookup too; the LM head
gathers first). Where T does not divide the model axis the residual is
not cut, as the reference's hint downgrades. EP_DP_RULES cuts the batch
over (data, model), the experts over "data" and every "ffn" dim over
"model": those weights are gathered before their block, the experts'
buffers are exchanged over "data", and no activation is all-reduced.

Each of the six sharded families (smollm-135m, qwen3-moe, musicgen-medium,
rwkv6-7b, zamba2-2.7b, llama-3.2-vision-90b, reduced) under each set: a
train step and a prefill, and decode for qwen3-moe and rwkv6, held against
``make_train_step``, ``make_prefill_step`` and ``make_serve_step`` on one
device at ``tests/test_torch_sharded_families.py``'s tolerances (its
helpers). Then SP at T = 15, and the collectives each set runs, counted by
wrapping ``sharding.collectives``.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded_families import (  # noqa: E402
    RTOL,
    B,
    T,
    _close,
    _mesh,
    _one_thread,  # noqa: F401
    _rounded,
    _setup,
    decode_against_one_device,
    prefill_against_one_device,
    train_against_one_device,
)

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402
from repro_torch.sharding import collectives as coll  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402

FAMILIES = (
    "smollm-135m",
    "qwen3-moe-30b-a3b",
    "musicgen-medium",
    "rwkv6-7b",
    "zamba2-2.7b",
    "llama-3.2-vision-90b",
)
RULES = ("SP_RULES", "EP_DP_RULES")
CASES = [(name, rules) for name in FAMILIES for rules in RULES]
MODEL_GROUPS, DATA_GROUPS = [[0, 1], [2, 3]], [[0, 2], [1, 3]]  # (data, model) = (2, 2)


@pytest.mark.parametrize("name, rules", CASES)
def test_train_step_matches_one_device(name, rules):
    train_against_one_device(name, rules)


@pytest.mark.parametrize("name, rules", CASES)
def test_prefill_matches_one_device(name, rules):
    prefill_against_one_device(name, rules)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "rwkv6-7b"])
@pytest.mark.parametrize("rules", RULES)
def test_decode_matches_one_device(name, rules):
    decode_against_one_device(name, rules)


# ------------------------------------------------ what each set runs


@pytest.fixture
def record(monkeypatch):
    """Every collective a step calls: (name, its other arguments, the
    first member's shape, the groups of the ``Lockstep.over`` call it runs
    under or None, whether the forward pass called it), one entry a group;
    and each dense block's input residual shapes, one a position."""
    log = {"calls": [], "residual": []}
    groups = []
    inside = []
    over = spmd.Lockstep.over
    forward = spmd.Lockstep.forward

    def forward_(self, *args):
        inside.append(True)
        try:
            return forward(self, *args)
        finally:
            inside.pop()

    def over_(self, groups_, xs, fn):
        groups.append(groups_)
        try:
            return over(self, groups_, xs, fn)
        finally:
            groups.pop()

    def spy(name, real):
        def call(xs, *args):
            log["calls"].append((name, args, tuple(xs[0].shape), groups[-1] if groups else None, bool(inside)))
            return real(xs, *args)

        return call

    for name in ("all_gather", "reduce_scatter", "all_reduce", "all_to_all"):
        monkeypatch.setattr(coll, name, spy(name, getattr(coll, name)))
    monkeypatch.setattr(spmd.Lockstep, "over", over_)
    monkeypatch.setattr(spmd.Lockstep, "forward", forward_)
    layer = spmd.Lockstep.layer

    def layer_(self, i, stacks, x, *rest, **kw):
        log["residual"].append([tuple(xi.shape) for xi in x])
        return layer(self, i, stacks, x, *rest, **kw)

    monkeypatch.setattr(spmd.Lockstep, "layer", layer_)
    return log


def _count(log, name, groups, ndim=None, dim=None):
    """Collectives ``name`` over ``groups`` (one a call, not a group)."""
    hits = [
        c for c in log["calls"]
        if c[0] == name and c[3] == groups
        and (ndim is None or len(c[2]) == ndim) and (dim is None or c[1][:1] == (dim,))
    ]
    return len(hits) // len(groups)


def test_sequence_parallel_pattern(record):
    """smollm-135m (dense, 2 layers), one SP train step: per layer two
    sequence all-gathers and two reduce-scatters over "model", one more of
    each for the LM head and the embedding, no all-reduce of a (B, T, d)
    activation; the residual entering each layer is each position's
    (B / 2, T / 2, d) block."""
    cfg = ARCHS["smollm-135m"].reduced()
    L, d = cfg.n_layers, cfg.d_model
    train_against_one_device("smollm-135m", "SP_RULES")
    assert _count(record, "all_gather", MODEL_GROUPS, ndim=3, dim=1) == 2 * L + 1
    assert _count(record, "reduce_scatter", MODEL_GROUPS, ndim=3, dim=1) == 2 * L + 1
    assert not [c for c in record["calls"] if c[0] == "all_reduce" and len(c[2]) >= 3]
    assert record["residual"] == [[(B // 2, T // 2, d)] * 4] * L


def test_sequence_not_cut_where_it_does_not_divide(record):
    """T = 15 over a model axis of 2: the DEFAULT layout (whole rows, the
    partial sums all-reduced, no reduce-scatter), the same values."""
    train_against_one_device("smollm-135m", "SP_RULES", seq=15)
    cfg, params, tokens, _, _ = _setup("qwen3-moe-30b-a3b", (), B, 15)
    shape = ShapeConfig("p", 15, B, "prefill")
    cell = specs.build_cell(cfg, shape, _mesh(), part.SP_RULES, params=params)
    got = cell.step_fn(cell.args[0], tokens).gather()
    want = ds.make_prefill_step(cfg)(_rounded(params), tokens)
    _close(got, want, "logits", atol=RTOL * float(want.abs().max()))
    assert not [c for c in record["calls"] if c[0] == "reduce_scatter"]
    assert _count(record, "all_reduce", MODEL_GROUPS, ndim=3) > 0
    d = ARCHS["smollm-135m"].reduced().d_model
    assert all(shape == (B // 2, 15, d) for shapes in record["residual"] for shape in shapes)


def test_expert_and_data_parallel_pattern(record):
    """qwen3-moe (2 MoE layers), one EP_DP train step: the batch cut four
    ways, no activation all-reduced in the forward pass (only the aux
    loss's (E,) sums, over all four positions; after it the gradients are
    all-reduced over their blocks' replicas), the experts' buffers
    all-to-all'd twice a layer over "data", and the experts' ffn dims
    gathered over "model"."""
    cell, _ = train_against_one_device("qwen3-moe-30b-a3b", "EP_DP_RULES")
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced()
    L, d = cfg.n_layers, cfg.d_model
    assert tuple(cell.in_shardings[2]["tokens"].spec) == (("data", "model"),)
    w_gate = spmd.flat(cell.in_shardings[0])[("layers", "moe", "w_gate")]
    assert tuple(w_gate.spec) == (None, "data", None, "model")
    reduces = [c for c in record["calls"] if c[0] == "all_reduce" and c[4]]
    assert reduces and all(len(c[2]) == 1 and c[3] == [[0, 1, 2, 3]] for c in reduces)
    assert _count(record, "all_to_all", DATA_GROUPS, ndim=4) == 2 * L
    assert _count(record, "all_to_all", MODEL_GROUPS) == 0
    assert _count(record, "all_gather", MODEL_GROUPS, ndim=3) == 3 * L  # w_gate, w_up, w_down
    assert record["residual"] == [[(B // 4, T, d)] * 4] * L
