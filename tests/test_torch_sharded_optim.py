"""The rule-sharded train step's optimizer options against the port's
one-device step, on a (data, model) mesh of 2 x 2 CPU slots: Adafactor,
gradient-accumulation microbatches and int8 error-feedback gradient
compression, the options the reference's ``choose_optimizer`` gives its
large cells (arctic-480b's train cell uses all three).

Each case starts from the state one one-device step leaves and takes the
same steps on both sides (``test_torch_sharded_families.
train_against_one_device``: metrics, parameters and every optimizer-state
leaf within RTOL = 1e-5 and ATOL = 1e-6, replicas bit-equal, layouts
kept):

  * Adafactor, two steps, on qwen3-moe under DEFAULT and EP_DATA rules and
    rwkv6 under DEFAULT: its row and column means, the mean of ``vr`` and
    the RMS update clip reduce over dims the rules cut (the experts over
    "data", ``ffn`` over "model", the "embed" dim over "data"), and a
    stacked (L, d) leaf is factored across its layers, as the reference's
    is; ``vr``/``vc`` placed by the reference's ``_opt_spec_tree``;
  * two microbatches on qwen3-moe under EP_DATA, smollm-135m under
    DP_ONLY and llama-vision (with its image embeddings, the batch placed)
    under DEFAULT; a microbatch is the global rows [i GB/n, (i+1) GB/n),
    whose MoE aux loss differs from that of each data shard's local rows
    split in two;
  * compressed gradients, two steps so that the error feedback carries
    over, under DEFAULT: the per-tensor scale is the whole leaf's, and an
    element whose code flips at a rounding tie is allowed only there.

Then every (arch x shape) cell of the reference: its rules and optimizer
options are ones the sharded steps take.
"""

import copy

import pytest

torch = pytest.importorskip("torch")

from test_torch_sharded_families import (  # noqa: E402
    ATOL,
    OCFG,
    RTOL,
    B,
    T,
    _batch,
    _close,
    _mesh,
    _one_thread,  # noqa: F401
    _replicas_equal,
    _setup,
    train_against_one_device,
)

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402
from repro_torch.sharding import step as sharded  # noqa: E402
from repro_torch.sharding.partitioning import device_put  # noqa: E402
from repro_torch.train.train_step import init_opt_state, make_train_step  # noqa: E402

ADAFACTOR = OCFG.__class__(**{**OCFG.__dict__, "name": "adafactor"})
MICRO = OCFG.__class__(**{**OCFG.__dict__, "microbatches": 2})
COMPRESSED = OCFG.__class__(**{**OCFG.__dict__, "compress_grads": True})


@pytest.mark.parametrize(
    "name, rules",
    [
        ("qwen3-moe-30b-a3b", "DEFAULT_RULES"),
        ("qwen3-moe-30b-a3b", "EP_DATA_RULES"),
        ("rwkv6-7b", "DEFAULT_RULES"),
    ],
)
def test_adafactor_matches_one_device(name, rules):
    """rwkv6 computes at f64 here: its gradient at this state is
    ill-conditioned (the decay's exp(+-30) factors), and a float64 pass
    puts both f32 sides' gradients 2e-5 to 8e-5 off the exact one, the
    sharded side no farther than the one-device side; at f64 the two
    differ by far less, which is what holds Adafactor's cross-block
    reductions at RTOL."""
    changes = (("dtype", "float64"),) if name == "rwkv6-7b" else ()
    cell, _ = train_against_one_device(name, rules, ADAFACTOR, changes=changes, steps=(3, 4))
    assert cell.meta["optimizer"] == "adafactor"
    state = spmd.flat(cell.in_shardings[1]["v"])
    if name.startswith("qwen3"):  # (L, E, d, f): experts and f cut, vr over (L, E, d)
        w_up = state[("layers", "moe", "w_up", "vr")]
        want = {"DEFAULT_RULES": (None, "model", "data"), "EP_DATA_RULES": (None, "data", None)}
        assert tuple(w_up.spec) == want[rules]
    else:  # a stacked (L, d) norm: factored across its layers, vc over d
        assert set(k[-1] for k in state if k[:-1] == ("layers", "ln1")) == {"vr", "vc"}
        assert tuple(state[("layers", "ln1", "vr")].spec) == (None,)
        assert tuple(state[("layers", "ln1", "vc")].spec) == ("data",)


@pytest.mark.parametrize(
    "name, rules, batch, placed",
    [
        ("qwen3-moe-30b-a3b", "EP_DATA_RULES", 4, False),
        ("smollm-135m", "DP_ONLY_RULES", 8, False),
        ("llama-3.2-vision-90b", "DEFAULT_RULES", 4, True),
    ],
)
def test_microbatches_match_one_device(name, rules, batch, placed):
    """The VLM's batch (with its image embeddings) comes placed by the
    batch sharding: each position's rows of a microbatch are copied from
    the positions that hold them."""
    train_against_one_device(name, rules, MICRO, batch=batch, place_batch=placed)


def test_microbatch_is_global_rows_not_each_shards():
    """The metrics are the last microbatch's: its aux loss is the one of
    global rows 2 and 3, not of rows 1 and 3 (the second local row of
    each data shard), which differs by far more than the tolerance."""
    name = "qwen3-moe-30b-a3b"
    _, got = train_against_one_device(name, "EP_DATA_RULES", MICRO)
    cfg, params, tokens, labels, _ = _setup(name)
    start = copy.deepcopy(params)
    state = init_opt_state(MICRO, start, device="cpu")
    start, _, _ = make_train_step(cfg, MICRO)(start, state, _batch(tokens, labels, None), 2)
    with torch.no_grad():
        global_rows = tf.forward(cfg, start, tokens[2:4])[1]
        shard_rows = tf.forward(cfg, start, tokens[[1, 3]])[1]
    _close(got["aux"], global_rows, "aux")
    assert abs(float(shard_rows - global_rows)) > 100 * (ATOL + RTOL * float(global_rows))


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-moe-30b-a3b"])
def test_compressed_gradients_match_one_device(name):
    """Two compressed steps, each from the one-device step's state (its
    ``ef`` carried over from the step before). The int8 code of a
    gradient element sitting on a rounding tie (g / scale = k + 1/2 to
    f32 rounding) may go either way: there the two residuals are half a
    code step of opposite signs (a handful of elements a leaf), and the
    element's parameter and moments follow its code. Everything else is
    held at RTOL/ATOL, and every element beyond it must be such a tie."""
    cfg, params, tokens, labels, _ = _setup(name)
    data = _batch(tokens, labels, None)
    start = copy.deepcopy(params)
    state = init_opt_state(COMPRESSED, start, device="cpu")
    step = make_train_step(cfg, COMPRESSED)
    start, state, _ = step(start, state, data, 2)
    shape = ShapeConfig("t", T, B, "train")
    cell = specs.build_cell(cfg, shape, _mesh(), part.DEFAULT_RULES, COMPRESSED, params=start)
    ties, elements = 0, 0
    for s in (3, 4):
        placed = device_put(start.tree(lambda p: p.detach()), cell.in_shardings[0])
        placed_state = device_put(state, cell.in_shardings[1])
        placed, placed_state, got = cell.step_fn(placed, placed_state, data, s)
        start, state, want = step(start, state, data, s)
        for key in want:
            _close(got[key], want[key], key)
        ef_got, ef_want = spmd.flat(placed_state["ef"]), spmd.flat(state["ef"])
        trees = [(spmd.flat(placed), spmd.flat(start.tree(lambda p: p.detach())))]
        trees += [(spmd.flat(placed_state[k]), spmd.flat(state[k])) for k in ("m", "v")]
        for path, e_want in ef_want.items():
            e_got = ef_got[path].gather()
            tie = (e_got - e_want).abs() > ATOL + RTOL * e_want.abs()
            half = float(e_want.abs().max())  # half a code step, to f32 rounding
            assert bool((e_want[tie].abs() >= (1 - 1e-3) * half).all()), path
            assert bool(((e_got + e_want)[tie].abs() <= 1e-3 * half).all()), path
            ties += int(tie.sum())
            elements += e_want.numel()
            for got_tree, want_tree in trees:
                g, w = got_tree[path].gather(), want_tree[path]
                _close(g[~tie], w[~tie], path)
        _replicas_equal(placed)
        _replicas_equal({k: v for k, v in placed_state.items() if k != "count"})
    assert ties <= 1e-3 * elements
    ef = spmd.flat(cell.in_shardings[1]["ef"])
    for path, sh in spmd.flat(cell.in_shardings[0]).items():
        assert ef[path] == sh


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_reference_cell_is_taken(name):
    """The reference's 40 (arch x shape) cells (``launch/dryrun.py
    --all``) at full size: each one's backend (``pick_backend``), rules
    (``choose_rules``) and, for training, optimizer (``choose_optimizer``
    over the reference mesh's 16 data ways) are ones the sharded steps
    take on a (data, model) mesh. Every train_4k cell past 1 B parameters
    takes microbatches (2-16), and arctic-480b's takes Adafactor."""
    cfg = ARCHS[name]
    mesh = _mesh()
    for shape in SHAPES.values():
        c = specs.pick_backend(cfg, shape)
        rules = specs.choose_rules(c, shape, None)
        spmd.check_supported(c, mesh, rules)
        if shape.kind == "train":
            ocfg = specs.choose_optimizer(c, shape)
            assert (ocfg.microbatches > 1) == (c.param_count() > 1e9)
            assert (ocfg.name == "adafactor") == (c.param_count() > 100e9)
            sharded.make_train_step(c, ocfg, mesh, rules)
        else:
            sharded.make_prefill_step(c, mesh, rules)
            sharded.make_serve_step(c, mesh, rules)
