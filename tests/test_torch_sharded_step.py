"""The rule-sharded LM steps (``sharding.step`` through
``launch.specs.build_cell``) against the port's one-device steps, on a
(data, model) mesh of 2 x 2 CPU slots.

smollm-135m and qwen3-moe, reduced, under each rule set ``choose_rules``
picks (EP_DATA only for the MoE): one train step, a prefill and two decode
steps, each held against ``make_train_step``, ``make_prefill_step`` and
``make_serve_step`` on one device from the same weights and batch, and the
replicas of every placed leaf bit for bit equal. Then the layouts that
need more than a head shard: smollm-135m's 9 q and 3 kv heads at
head_dim 8 (a ``model`` shard ends mid-head, and the decode cache is cut
along its sequence), with remat; a decode batch that does not divide over
``data`` (the cache's batch replicated); qwen3-moe's maclaurin backend at
T = 1024 (the chunked route, B8's dispatch, on each head shard). Then the
MoE aux loss under data sharding, which must be the global one, what
the sharded steps refuse, and, with remat on, a prefill that leaves no
tensor to Python's cycle collector. (SP_RULES and EP_DP_RULES:
``tests/test_torch_sharded_rules.py``.)

Tolerance: logits, loss and its parts, the gradient norm, the learning
rate and the updated parameters and moments within RTOL = 1e-5 and ATOL
= 1e-6 (``torch.allclose``): f32 sums in other orders. The compared train
step starts from the state one one-device step leaves (``_warm``): from
zero moments the first AdamW update is lr g / (|g| + eps), which at an
element whose gradient is near eps moves by lr times that gradient's
relative rounding (2e-3 at one ``w_down`` element, 1.1e-6 at lr 1e-3).
Decode is held at these through an f32 cache (its entries, the k and v
of each layer's input, within RTOL of the largest); through the cell's bf16
cache the greedy tokens must agree and the first layer's entries lie
within one bf16 step (BF16_STEP, at most, of an entry's magnitude): they
are rounded from f32 projections computed in another order, and a flipped
last bit there moves what the next layers compute, and their entries, by
more than f32 rounding. Serving cells hold bf16
weights (the reference's ``build_cell``), so the one-device serving steps
run on the same weights rounded to bf16.
"""

import copy
import dataclasses
import functools
import gc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402
from repro_torch.sharding import step as sharded  # noqa: E402
from repro_torch.sharding.partitioning import PartitionSpec as P  # noqa: E402
from repro_torch.sharding.partitioning import Sharded, device_put  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    OptimizerConfig,
    init_opt_state,
    make_train_step,
)

RTOL, ATOL = 1e-5, 1e-6
BF16_STEP = 2.0**-7  # the widest spacing of bf16 values, relative
B, T = 4, 16
OCFG = OptimizerConfig(warmup=2, total_steps=10)
RULES = {
    "smollm-135m": ("DEFAULT_RULES", "TP_ONLY_RULES", "DP_ONLY_RULES"),
    "qwen3-moe-30b-a3b": ("DEFAULT_RULES", "TP_ONLY_RULES", "DP_ONLY_RULES", "EP_DATA_RULES"),
}
CASES = [(name, rules) for name, sets in RULES.items() for rules in sets]
NARROW = dict(n_heads=9, n_kv_heads=3, head_dim=8, remat=True)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the steps here are many small tensor
    operations, which lose more to a thread pool contended by the other
    test workers than they gain from it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh():
    return make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)


@functools.cache
def _setup(name: str, changes: tuple = (), batch: int = B, seq: int = T):
    """(cfg, weights, tokens, labels) from seeds."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), **dict(changes))
    params = tf.init_params(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, dtype=torch.int32)
    return cfg, params, tokens, labels


def _rounded(params):
    """The weights a serving cell holds (bf16), as one device's f32."""
    out = copy.deepcopy(params)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(torch.bfloat16))
    return out


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, what
    worst = float((got - want).abs().max()) if got.numel() else 0.0
    assert torch.allclose(got, want, rtol=rtol, atol=atol), (what, worst)


def _replicas_equal(tree):
    for path, leaf in spmd.flat(tree).items():
        for group in leaf.replica_groups():
            first = leaf.local(group[0])
            assert all(torch.equal(leaf.local(p), first) for p in group), path


def _copy_state(state):
    if isinstance(state, torch.Tensor):
        return state.clone()
    return {k: _copy_state(v) for k, v in state.items()}


def _warm(cfg, params, batch):
    """One one-device step from zero moments: (weights, state)."""
    p = copy.deepcopy(params)
    state = init_opt_state(OCFG, p, device="cpu")
    p, state, _ = make_train_step(cfg, OCFG)(p, state, batch, 2)
    return p, state


def _train(name, rules, changes=(), batch=B, seq=T):
    cfg, params, tokens, labels = _setup(name, changes, batch, seq)
    batch_ = {"tokens": tokens, "labels": labels}
    start, state = _warm(cfg, params, batch_)
    shape = ShapeConfig("t", seq, batch, "train")
    cell = specs.build_cell(cfg, shape, _mesh(), getattr(part, rules), OCFG, params=start)
    placed = device_put(start.tree(lambda p: p.detach()), cell.in_shardings[0])
    placed_state = device_put(state, cell.in_shardings[1])
    got_p, got_state, got = cell.step_fn(placed, placed_state, batch_, 3)
    want_p, want_state, want = make_train_step(cfg, OCFG)(start, _copy_state(state), batch_, 3)
    assert set(got) == set(want) == {"xent", "aux", "loss", "grad_norm", "lr"}
    for key in want:
        _close(got[key], want[key], key)
    for path, leaf in spmd.flat(want_p.tree(lambda p: p.detach())).items():
        _close(spmd.flat(got_p)[path].gather(), leaf, path)
    for key in ("m", "v"):
        for path, leaf in spmd.flat(want_state[key]).items():
            _close(spmd.flat(got_state[key])[path].gather(), leaf, (key,) + path)
    assert [int(c) for c in got_state["count"].shards] == [int(want_state["count"])] * 4
    for tree in (got_p, got_state["m"], got_state["v"]):
        _replicas_equal(tree)
    # the layouts kept: every leaf under its cell sharding
    for path, leaf in spmd.flat(got_p).items():
        assert leaf.sharding == spmd.flat(cell.out_shardings[0])[path]
    return cell


def _prefill(name, rules, changes=(), scaled=False):
    """A prefill cell against one device's prefill: logits at RTOL/ATOL,
    or (``scaled``) within RTOL of the largest logit."""
    cfg, params, tokens, _ = _setup(name, changes)
    shape = ShapeConfig("p", T, B, "prefill")
    cell = specs.build_cell(cfg, shape, _mesh(), getattr(part, rules), params=params)
    assert all(leaf.dtype == torch.bfloat16 for leaf in spmd.flat(cell.args[0]).values())
    got = cell.step_fn(cell.args[0], tokens).gather()
    want = ds.make_prefill_step(cfg)(_rounded(params), tokens)
    atol = RTOL * float(want.abs().max()) if scaled else ATOL
    _close(got, want, "logits", atol=atol)


def _decode(name, rules, changes=(), batch=B):
    """Two decode steps through an f32 cache placed by the cell's cache
    shardings (logits and cache at RTOL/ATOL), then through the cell's own
    bf16 cache (greedy tokens equal, layer 0's entries within one bf16
    step)."""
    cfg, params, tokens, _ = _setup(name, changes, batch)
    shape = ShapeConfig("d", T, batch, "decode")
    cell = specs.build_cell(cfg, shape, _mesh(), getattr(part, rules), params=params)
    rounded = _rounded(params)
    step = ds.make_serve_step(cfg)
    f32 = torch.float32
    for dtype, cache in ((f32, None), (torch.bfloat16, cell.args[3])):
        want_cache = tf.init_cache(cfg, batch, T, dtype=dtype, device="cpu")
        if cache is None:
            whole = tf.init_cache(cfg, batch, T, dtype=dtype, device="cpu")
            cache = device_put(whole, cell.in_shardings[3])
        tok = want_tok = tokens[:, :1]
        for pos in range(2):
            logits, cache = cell.step_fn(cell.args[0], tok, pos, cache)
            logits = logits.gather()
            want, want_cache = step(rounded, want_tok, pos, want_cache)
            if dtype == f32:
                _close(logits, want, f"logits at {pos}")
            tok = torch.argmax(logits, -1).to(torch.int32)
            want_tok = torch.argmax(want, -1).to(torch.int32)
            assert torch.equal(tok, want_tok)
        for got, want in zip(cache["kv"], want_cache["kv"]):
            assert got.dtype == dtype
            if dtype == f32:  # k, v of each layer's input: within RTOL of the largest
                _close(got.gather(), want, "cache", atol=RTOL * float(want.abs().max()))
            else:  # layer 0's entries, which no rounded entry feeds
                _close(got.gather()[0], want[0], "cache", rtol=BF16_STEP)
            _replicas_equal({"kv": got})
    return cell


@pytest.mark.parametrize("name, rules", CASES)
def test_train_step_matches_one_device(name, rules):
    _train(name, rules)


@pytest.mark.parametrize("name, rules", CASES)
def test_prefill_matches_one_device(name, rules):
    _prefill(name, rules)


@pytest.mark.parametrize("name, rules", CASES)
def test_decode_matches_one_device(name, rules):
    _decode(name, rules)


# ------------------------------------------ layouts past a head shard


def test_mid_head_shards_train_and_prefill():
    """576 -> 288 q columns at full width is 4.5 heads a shard; here 72 ->
    36, and 24 kv columns -> 12: the attention spread over the group by
    batch rows (q all-to-all'd, k and v gathered), remat on (the FSDP
    gathers rerun in the backward)."""
    changes = tuple(NARROW.items())
    cell = _train("smollm-135m", "DEFAULT_RULES", changes)
    w_q = spmd.flat(cell.in_shardings[0])[("layers", "attn", "w_q")]
    assert tuple(w_q.spec) == (None, "data", "model")
    _prefill("smollm-135m", "TP_ONLY_RULES", changes)


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "TP_ONLY_RULES"])
def test_sequence_sharded_decode_cache(rules):
    """3 kv heads do not divide the model axis: the cache is cut along its
    sequence over "model", each shard's softmax partials combined."""
    cell = _decode("smollm-135m", rules, tuple(NARROW.items()))
    for sh in cell.in_shardings[3]["kv"]:
        assert tuple(sh.spec) == (None, "data", "model", None, None)


def test_dense_residual_beside_the_experts():
    """arctic-480b's dense SwiGLU beside its experts, under DEFAULT_RULES:
    the two partial sums reduce apart, so its prefill logits are held
    within RTOL of their largest (1.5e-6 off at a logit near 0)."""
    _train("arctic-480b", "DEFAULT_RULES")
    _prefill("arctic-480b", "DEFAULT_RULES", scaled=True)
    _decode("arctic-480b", "DEFAULT_RULES")


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "EP_DATA_RULES", "EP_DP_RULES"])
def test_decode_batch_that_does_not_divide(rules):
    """One row over two data shards: tokens and the cache's batch dim are
    replicated, as the reference's cell replicates them (under EP_DATA and
    EP_DP the replicas' buffers still go to the experts' owners and back;
    under EP_DP "model", freed of the batch, cuts the ffn dims as tensor
    parallelism does)."""
    cell = _decode("qwen3-moe-30b-a3b", rules, batch=1)
    assert tuple(cell.in_shardings[1].spec) == (None,)
    heads = None if rules == "EP_DP_RULES" else "model"  # EP_DP cuts no kv heads
    for sh in cell.in_shardings[3]["kv"]:
        assert tuple(sh.spec) == (None, None, None, heads, None)


def test_maclaurin_train_step_on_head_shards():
    """T = 1024: each position's 2 of 4 heads through the chunked form
    (``ChunkedMaclaurin``: B8's dispatch, here its twin), under remat."""
    changes = (("attention_backend", "maclaurin"), ("remat", True))
    _train("qwen3-moe-30b-a3b", "DEFAULT_RULES", changes, batch=2, seq=1024)


def test_moe_aux_loss_is_the_global_one():
    """E sum(me ce) over all B T tokens: the product is not linear, so the
    mean of each data shard's aux differs from it, and the step's equals
    it."""
    cfg, params, tokens, _ = _setup("qwen3-moe-30b-a3b")
    mesh = _mesh()
    rules = part.EP_DATA_RULES
    tree = params.tree()
    shardings = part.param_shardings(params.spec(), rules, mesh)
    placed = device_put(tree, specs.sanitize(shardings, tree, mesh))
    ctx = spmd.Lockstep(cfg, mesh, rules, placed, B)
    local = [{k: v.local(p) for k, v in spmd.flat(placed).items()} for p in range(4)]
    with torch.no_grad():
        _, aux = ctx.forward(local, [tokens[ctx.batch.index((B, T), p)] for p in range(4)])
        _, want = tf.forward(cfg, params, tokens)
        halves = [tf.forward(cfg, params, tokens[i : i + 2])[1] for i in (0, 2)]
    assert all(torch.equal(a, aux[0]) for a in aux)
    _close(aux[0], want, "aux")
    assert abs(float(sum(halves) / 2 - want)) > 100 * (ATOL + RTOL * float(want))


# --------------------------------------------------------- refusals


def test_rule_sets_without_a_sharded_step_raise():
    """Only the reference's six rule sets have a sharded step: heads cut
    over "data" is none of them."""
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced()
    odd = part.DEFAULT_RULES.replace(heads="data")
    with pytest.raises(NotImplementedError, match="rules"):
        specs.build_cell(cfg, ShapeConfig("p", T, B, "prefill"), _mesh(), odd)


def test_other_meshes_and_caches_raise():
    cfg = ARCHS["smollm-135m"].reduced()
    odd = make_mesh((2, 2), ("data", "seq"), devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="seq"):
        sharded.make_prefill_step(cfg, odd, part.DEFAULT_RULES)
    with pytest.raises(ValueError, match="abstract"):
        abstract = part.abstract_mesh((2, 2), ("data", "model"))
        sharded.make_prefill_step(cfg, abstract, part.DEFAULT_RULES)
    # a cache whose kv heads are cut over "data": refused, never decoded
    # unsharded (a cache whose kv heads do not divide "model" is decoded:
    # tests/test_torch_sharded_decode.py)
    cell = specs.build_cell(cfg, ShapeConfig("d", T, B, "decode"), _mesh(), part.DEFAULT_RULES)
    by_data = part.NamedSharding(_mesh(), P(None, None, None, "data", None))
    odd_cache = device_put(tf.init_cache(cfg, B, T, dtype=torch.bfloat16, device="cpu"), by_data)
    with pytest.raises(NotImplementedError, match="kv-head"):
        cell.step_fn(cell.args[0], torch.zeros((B, 1), dtype=torch.int32), 0, odd_cache)
    # a batch placed by another sharding than the step's
    by_model = part.NamedSharding(_mesh(), P("model"))
    tokens = device_put(torch.zeros((B, T), dtype=torch.int32), by_model)
    prefill = sharded.make_prefill_step(cfg, _mesh(), part.DEFAULT_RULES)
    shape = ShapeConfig("p", T, B, "prefill")
    placed = specs.build_cell(cfg, shape, _mesh(), part.DEFAULT_RULES).args[0]
    with pytest.raises(ValueError, match="batch"):
        prefill(placed, tokens)
    assert isinstance(placed[("embed")]["table"], Sharded)


@pytest.mark.parametrize("sizes", [(1, 1), (2, 2)])
def test_prefill_leaves_no_cycle(sizes):
    """With remat on (every full-size config's default), a prefill leaves
    no tensor to Python's cycle collector: each layer's weights and
    residual are freed when the layer ends, not when the collector runs.
    (A first call imports lazily, which leaves cycles of its own: warm.)"""
    cfg, params, tokens, _ = _setup("smollm-135m", (("remat", True),))
    mesh = make_mesh(sizes, ("data", "model"), devices=["cpu"] * (sizes[0] * sizes[1]))
    cell = specs.build_cell(cfg, ShapeConfig("p", T, B, "prefill"), mesh, part.TP_ONLY_RULES, params=params)
    cell.step_fn(cell.args[0], tokens)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        cell.step_fn(cell.args[0], tokens)
        gc.collect()
        found = [tuple(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not found, found
