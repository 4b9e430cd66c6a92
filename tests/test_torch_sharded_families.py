"""The rule-sharded LM steps of the families past dense and MoE against the
port's one-device steps, on a (data, model) mesh of 2 x 2 CPU slots.

musicgen-medium (``audio``), rwkv6-7b (``ssm``), zamba2-2.7b (``hybrid``)
and llama-3.2-vision-90b (``vlm``), reduced, under DEFAULT, TP_ONLY and
DP_ONLY rules: one train step, a prefill and two decode steps, each held
against ``make_train_step``, ``make_prefill_step`` and ``make_serve_step``
on one device from the same weights, batch and (for the VLM) image
embeddings, and the replicas of every placed leaf bit for bit equal. Then
the layouts these families add: zamba2's packed ``w_in`` and ``conv``
cut mid-segment (552 -> 276 columns: shard 0 holds all of z and 20
columns of x), the replicated per-head ``u``, ``A_log``, ``D`` and
``dt_bias`` sliced to a head shard, a VLM whose kv heads do not divide the
model axis (cross-attention spread over the group by batch rows; its
image cache, of as many tokens as the cell's sequence, cut along them as
the reference's ``build_cell`` cuts a KV cache there), the hybrid and VLM
caches of the maclaurin backend cut by kv heads, and remat.

Tolerance, as ``tests/test_torch_sharded_step.py``'s: logits, loss and
its parts, the gradient norm, the learning rate and the updated
parameters and moments within RTOL = 1e-5 and ATOL = 1e-6 (f32 sums in
other orders), the compared train step starting from the state one
one-device step leaves. Prefill logits are held within RTOL of the
largest logit: the Mamba2 and RWKV6 scans and the VLM's cross block put
sums of other orders under every later logit, which lands up to 1.6e-6
off at a logit of magnitude 0.05 (zamba2). Decode is held through an f32
cache (logits at RTOL/ATOL, every cache leaf within RTOL of its largest
entry); through a bf16 cache the greedy tokens must agree. Serving cells
hold bf16 weights, so the one-device serving steps run on the same weights
rounded to bf16.
"""

import copy
import dataclasses
import functools

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
from repro_torch.sharding.partitioning import device_put  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    OptimizerConfig,
    init_opt_state,
    make_train_step,
)

RTOL, ATOL = 1e-5, 1e-6
B, T = 4, 16
OCFG = OptimizerConfig(warmup=2, total_steps=10)
FAMILIES = ("musicgen-medium", "rwkv6-7b", "zamba2-2.7b", "llama-3.2-vision-90b")
RULES = ("DEFAULT_RULES", "TP_ONLY_RULES", "DP_ONLY_RULES")
CASES = [(name, rules) for name in FAMILIES for rules in RULES]


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
    """(cfg, weights, tokens, labels, image embeddings or None) from seeds."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), **dict(changes))
    params = tf.init_params(cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, dtype=torch.int32)
    images = None
    if cfg.family == "vlm":
        images = torch.randn((batch, cfg.n_image_tokens, cfg.d_model), generator=g)
    return cfg, params, tokens, labels, images


def _extra(images):
    return () if images is None else (images,)


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
        for x in leaf if isinstance(leaf, tuple) else (leaf,):
            for group in x.replica_groups():
                first = x.local(group[0])
                assert all(torch.equal(x.local(p), first) for p in group), path


def _copy_state(state):
    if isinstance(state, torch.Tensor):
        return state.clone()
    return {k: _copy_state(v) for k, v in state.items()}


def _batch(tokens, labels, images):
    batch = {"tokens": tokens, "labels": labels}
    if images is not None:
        batch["image_embeds"] = images
    return batch


def train_against_one_device(
    name, rules, ocfg=OCFG, changes=(), batch=B, seq=T, steps=(3,), mesh=None, place_batch=False
):
    """A train cell's steps from the state one one-device step (at step 2)
    leaves, against the one-device steps from the same state: metrics,
    parameters and every optimizer-state leaf at RTOL/ATOL, replicas
    bit-equal, layouts kept; the batch whole, or placed by the cell's
    batch sharding (``place_batch``). Returns (the cell, the last
    metrics)."""
    cfg, params, tokens, labels, images = _setup(name, changes, batch, seq)
    data = _batch(tokens, labels, images)
    start = copy.deepcopy(params)
    state = init_opt_state(ocfg, start, device="cpu")
    step = make_train_step(cfg, ocfg)
    start, state, _ = step(start, state, data, 2)
    shape = ShapeConfig("t", seq, batch, "train")
    mesh = mesh or _mesh()
    cell = specs.build_cell(cfg, shape, mesh, getattr(part, rules), ocfg, params=start)
    placed = device_put(start.tree(lambda p: p.detach()), cell.in_shardings[0])
    placed_state = device_put(state, cell.in_shardings[1])
    want_p, want_state = start, _copy_state(state)
    given = device_put(data, cell.in_shardings[2]) if place_batch else data
    for s in steps:
        placed, placed_state, got = cell.step_fn(placed, placed_state, given, s)
        want_p, want_state, want = step(want_p, want_state, data, s)
    assert set(got) == set(want) == {"xent", "aux", "loss", "grad_norm", "lr"}
    for key in want:
        _close(got[key], want[key], key)
    for path, leaf in spmd.flat(want_p.tree(lambda p: p.detach())).items():
        _close(spmd.flat(placed)[path].gather(), leaf, path)
    got_flat = spmd.flat({k: v for k, v in placed_state.items() if k != "count"})
    want_flat = spmd.flat({k: v for k, v in want_state.items() if k != "count"})
    assert set(got_flat) == set(want_flat)
    for path, leaf in want_flat.items():
        _close(got_flat[path].gather(), leaf, path)
    count = int(want_state["count"])
    assert [int(c) for c in placed_state["count"].shards] == [count] * mesh.size
    _replicas_equal(placed)
    _replicas_equal({k: v for k, v in placed_state.items() if k != "count"})
    for path, leaf in spmd.flat(placed).items():  # the layouts kept
        assert leaf.sharding == spmd.flat(cell.out_shardings[0])[path]
    for path, leaf in spmd.flat(placed_state).items():
        assert leaf.sharding == spmd.flat(cell.out_shardings[1])[path]
    return cell, got


def prefill_against_one_device(name, rules, changes=(), mesh=None):
    """A prefill cell against one device's prefill, logits within RTOL of
    the largest."""
    cfg, params, tokens, _, images = _setup(name, changes)
    shape = ShapeConfig("p", T, B, "prefill")
    cell = specs.build_cell(cfg, shape, mesh or _mesh(), getattr(part, rules), params=params)
    assert all(leaf.dtype == torch.bfloat16 for leaf in spmd.flat(cell.args[0]).values())
    assert len(cell.args) == 2 + (images is not None)
    got = cell.step_fn(cell.args[0], tokens, *_extra(images)).gather()
    want = ds.make_prefill_step(cfg)(_rounded(params), tokens, *_extra(images))
    _close(got, want, "logits", atol=RTOL * float(want.abs().max()))
    return cell


def decode_against_one_device(name, rules, changes=(), mesh=None):
    """Two decode steps through an f32 cache placed by the cell's cache
    shardings (logits at RTOL/ATOL, every cache leaf within RTOL of its
    largest entry), then through a bf16 one (greedy tokens equal); replicas
    of the cache bit-equal."""
    cfg, params, tokens, _, images = _setup(name, changes)
    shape = ShapeConfig("d", T, B, "decode")
    cell = specs.build_cell(cfg, shape, mesh or _mesh(), getattr(part, rules), params=params)
    rounded = _rounded(params)
    step = ds.make_serve_step(cfg)
    extra = _extra(images)
    for dtype in (torch.float32, torch.bfloat16):
        opts = dict(image_embeds=images, params=rounded, dtype=dtype, device="cpu")
        want_cache = tf.init_cache(cfg, B, T, **opts)
        cache = device_put(tf.init_cache(cfg, B, T, **opts), cell.in_shardings[3])
        tok = want_tok = tokens[:, :1]
        for pos in range(2):
            logits, cache = cell.step_fn(cell.args[0], tok, pos, cache, *extra)
            logits = logits.gather()
            want, want_cache = step(rounded, want_tok, pos, want_cache, *extra)
            if dtype == torch.float32:
                _close(logits, want, f"logits at {pos}")
            tok = torch.argmax(logits, -1).to(torch.int32)
            want_tok = torch.argmax(want, -1).to(torch.int32)
            assert torch.equal(tok, want_tok)
        got_flat, want_flat = spmd.flat(cache), spmd.flat(want_cache)
        for path, want_leaf in want_flat.items():
            leaves = got_flat[path] if isinstance(want_leaf, tuple) else (got_flat[path],)
            wants = want_leaf if isinstance(want_leaf, tuple) else (want_leaf,)
            for got, want in zip(leaves, wants):
                assert got.dtype == want.dtype, path
                if dtype == torch.float32:
                    scale = float(want.abs().max())
                    _close(got.gather(), want, path, atol=RTOL * max(scale, 1e-30))
        _replicas_equal(cache)
    return cell


@pytest.mark.parametrize("name, rules", CASES)
def test_train_step_matches_one_device(name, rules):
    train_against_one_device(name, rules)


@pytest.mark.parametrize("name, rules", CASES)
def test_prefill_matches_one_device(name, rules):
    prefill_against_one_device(name, rules)


@pytest.mark.parametrize("name, rules", CASES)
def test_decode_matches_one_device(name, rules):
    decode_against_one_device(name, rules)


# -------------------------------------- layouts these families add


def test_zamba2_packed_projection_is_cut_mid_segment():
    """The packed [z | x | B | C | dt] of 552 columns cut in two: shard 0
    holds z (256) and 20 of x's 256 columns, so the split needs the whole
    projection; the conv's 288 channels [x | B | C] are cut at 144, inside
    x. Trained with remat on (the gathers rerun in the backward)."""
    changes = (("remat", True),)
    cell, _ = train_against_one_device("zamba2-2.7b", "DEFAULT_RULES", changes=changes)
    cuts = spmd.flat(cell.in_shardings[0])
    assert tuple(cuts[("layers", "w_in")].spec) == (None, "data", "model")
    assert tuple(cuts[("layers", "conv")].spec) == (None, None, "model")
    cfg = ARCHS["zamba2-2.7b"].reduced()
    d_inner = cfg.ssm_expand * cfg.d_model
    assert 552 // 2 - d_inner == 20 and (d_inner + 2 * cfg.ssm_state) // 2 == 144
    for name in ("A_log", "D", "dt_bias"):  # replicated, sliced per head shard
        assert tuple(cuts[("layers", name)].spec) == (None, None)
    cache = decode_against_one_device("zamba2-2.7b", "TP_ONLY_RULES").in_shardings[3]
    assert tuple(cache["ssm"].spec) == (None, "data", "model", None, None)
    assert tuple(cache["conv"].spec) == (None, "data", None, "model")


def test_rwkv6_replicated_bonus_is_sliced_per_head():
    """``u`` (H, hd) is replicated, yet each head shard reads only its
    heads' rows of it: a ``u`` with distinct rows moves the shards apart
    if a shard reads another's. The decode state ``S`` is cut by heads,
    the token shifts replicated over "model"."""
    cfg, params, *_ = _setup("rwkv6-7b")
    with torch.no_grad():
        for layer in params.layers:
            layer.u.copy_(torch.linspace(-1.0, 1.0, layer.u.numel()).reshape(layer.u.shape))
    try:
        train_against_one_device("rwkv6-7b", "DEFAULT_RULES")
        prefill_against_one_device("rwkv6-7b", "TP_ONLY_RULES")
        cell = decode_against_one_device("rwkv6-7b", "TP_ONLY_RULES")
    finally:
        _setup.cache_clear()
    cache = cell.in_shardings[3]
    assert tuple(cache["S"].spec) == (None, "data", "model", None, None)
    assert tuple(cache["x_tm"].spec) == (None, "data", None, None)


def test_vlm_cross_attention_on_gathered_heads():
    """3 q and 3 kv heads at head_dim 8 do not divide the model axis: the
    self- and cross-attention are spread over the group by batch rows (the
    q columns 24 -> 12 cut mid-head, k and v gathered). The image cache holds N = T = 16 tokens, so the cell
    cuts it along them over "model": each member scores its 8 image
    tokens, one combine over the group, no mask."""
    changes = (("n_heads", 3), ("n_kv_heads", 3), ("head_dim", 8))
    train_against_one_device("llama-3.2-vision-90b", "DEFAULT_RULES", changes=changes)
    prefill_against_one_device("llama-3.2-vision-90b", "TP_ONLY_RULES", changes)
    cell = decode_against_one_device("llama-3.2-vision-90b", "TP_ONLY_RULES", changes)
    for sh in cell.in_shardings[3]["cross"]:
        assert tuple(sh.spec) == (None, "data", "model", None, None)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "llama-3.2-vision-90b"])
def test_maclaurin_state_cut_by_kv_heads(name):
    """The long-context backend's ``MacState`` caches (the hybrid's shared
    attention, the VLM's self and cross stacks) cut by kv heads over
    "model"."""
    changes = (("attention_backend", "maclaurin"),)
    cell = decode_against_one_device(name, "TP_ONLY_RULES", changes)
    for key, stack in cell.in_shardings[3].items():
        if isinstance(stack, tf.mac.MacState):
            assert tuple(stack.s1.spec)[:3] == (None, "data", "model"), key


@pytest.mark.parametrize("name, model_ways", [("rwkv6-7b", 8), ("zamba2-2.7b", 16)])
def test_heads_cut_mid_head_on_a_wide_model_axis(name, model_ways):
    """A "model" axis wider than the heads: rwkv6's 128 columns over 8 are
    16 a shard, half a 32-wide head (every head-cut leaf gathered, each
    member computes all heads, ``u`` whole, the state replicated); zamba2's
    256 inner columns over 16 are 16 a shard, half a head (each member
    computes the head that covers its rows, the ssm state replicated), and
    its 288 conv channels are 18 a shard, across the x | B boundary."""
    mesh = make_mesh((1, model_ways), ("data", "model"), devices=["cpu"] * model_ways)
    train_against_one_device(name, "TP_ONLY_RULES", mesh=mesh)
    prefill_against_one_device(name, "TP_ONLY_RULES", mesh=mesh)
    cell = decode_against_one_device(name, "TP_ONLY_RULES", mesh=mesh)
    key = "S" if name == "rwkv6-7b" else "ssm"
    assert tuple(cell.in_shardings[3][key].spec) == (None, "data", None, None, None)
