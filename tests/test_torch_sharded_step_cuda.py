"""The rule-sharded LM steps over distinct cards: paths 11 and 12 of
``chip_smoke.py`` on a (data, model) mesh of (2, n/2) cards (the dense
and MoE models; rwkv6, zamba2, llama-vision and musicgen at a cut depth;
Adafactor, microbatches and compressed gradients; qwen3-moe and zamba2
under SP_RULES and EP_DP_RULES, path 13), one full-width arctic-480b
layer with its experts spread over four cards, the serving steps'
logits left on the card of the position that computed them (four cards),
attention whose heads do not divide "model" spread over every card
of its group (four cards), a data-parallel step with microbatches whose
work and memory every card shares alike (four cards);
and a sharded prefill that leaves no tensor to Python's cycle collector
(one card's 2 x 2 slots).

Marked ``cuda``; each test skips inside its body unless the cards it needs
are present (two; four for arctic, the logits' cards, the spread
attention and the level step; one for the cycle check, whose mesh repeats it; one card
repeated as the mesh's slots is otherwise driven by ``chip_smoke.py``'s
path 11). On a machine with them:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharded_step_cuda.py

Each sharded step is held against the one-device step of the same weights
on the first card, both at f32 (serving cells on the bf16 weights they
hold): logits within REL of max|logit| (an MoE's on SHARE of the
positions: its routing is discontinuous, and a near-tie token may move to
another expert), loss within 1e-5, the gradient norm within 1e-4 and the
updated parameters within 1e-6 + 1e-5 |p| but where the gradient's
running RMS (AdamW's bias-corrected sqrt(v)) is below TINY_GRAD, and each
within two learning rates (an AdamW step at a gradient near 0 moves by
lr times its relative rounding; path 11 states the same limits). Under
Adafactor and compressed gradients (whose int8 code of an element may
flip at a rounding tie) at most OFF_SHARE of the parameters may lie
beyond 1e-6 + 1e-5 |p|.
Arctic's one layer (13.4 B expert parameters, 53.5 GB at f32, 26.8 GB as
the cell's bf16) fits no one card, so its prefill is held against the
same prefill on the CPU, blockwise.
"""

import collections
import copy
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import make_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding.partitioning import device_put  # noqa: E402
from repro_torch.sharding.spmd import flat  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    OptimizerConfig,
    init_opt_state,
    make_train_step,
)

pytestmark = pytest.mark.cuda

REL, SHARE = 1e-4, 0.999
RTOL, ATOL, NORM_RTOL, TINY_GRAD = 1e-5, 1e-6, 1e-4, 1e-5
OFF_SHARE = 1e-4
LEVEL = 0.05  # the most one card's peak may lie above another's
FAMILY_DEPTH = {  # layers: two RWKV6 blocks, one zamba2 group, one superblock
    "rwkv6-7b": 2,
    "zamba2-2.7b": 6,
    "llama-3.2-vision-90b": 5,
    "musicgen-medium": 4,
}
OCFG = OptimizerConfig(warmup=2, total_steps=10)


def _cards(n: int):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} or more CUDA cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh(cards):
    n = len(cards) // 2 * 2
    return make_mesh((2, n // 2), ("data", "model"), devices=cards[:n])


def _cfg(name, layers, **changes):
    return dataclasses.replace(ARCHS[name], n_layers=layers, dtype="float32", **changes)


def _logits_close(got, want, share=None):
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max())
    within = (got - want).abs().amax(-1) <= REL * scale
    if share is None:
        assert bool(within.all()), float((got - want).abs().max()) / scale
    else:
        assert float(within.float().mean()) >= share


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _bf16_weights(params):
    with torch.no_grad():
        for p in params.parameters():
            p.copy_(p.to(torch.bfloat16))
    return params


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "smollm-135m"])
def test_prefill_and_decode_across_cards(name):
    cards = _cards(2)
    mesh = _mesh(cards)
    layers = 2 if name.startswith("qwen3") else ARCHS[name].n_layers
    cfg = _cfg(name, layers, attention_impl="flash")
    params = _bf16_weights(tf.init_params(cfg, seed=0, device=cards[0]))
    share = SHARE if cfg.moe_num_experts else None
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    tokens = torch.randint(
        0, cfg.vocab_size, (2, 1024), generator=gen, device=cards[0], dtype=torch.int32
    )
    cell = build_cell(cfg, ShapeConfig("prefill", 1024, 2, "prefill"), mesh, params=params)
    build.reset_counts()
    got = cell.step_fn(cell.args[0], tokens).gather()
    # on every position, whether on a head shard or spread over its group
    assert build.counts()["flash_attention"] == mesh.size * layers
    _logits_close(got, ds.make_prefill_step(cfg)(params, tokens), share)
    del cell, got
    cell = build_cell(cfg, ShapeConfig("decode", 32, 2, "decode"), mesh, params=params)
    f32_cache = tf.init_cache(cfg, 2, 32, dtype=torch.float32, device=cards[0])
    cache = device_put(f32_cache, cell.in_shardings[3])
    want_cache = tf.init_cache(cfg, 2, 32, dtype=torch.float32, device=cards[0])
    tok = tokens[:, :1]
    for pos in range(3):
        logits, cache = cell.step_fn(cell.args[0], tok, pos, cache)
        logits = logits.gather()
        want, want_cache = ds.make_serve_step(cfg)(params, tok, pos, want_cache)
        _logits_close(logits, want, share)
        tok = torch.argmax(want, -1).to(torch.int32)
    for leaf in cache["kv"]:
        assert {s.device for s in leaf.shards} == set(mesh.devices)


def test_prefill_leaves_no_cycle_on_the_card():
    """A sharded prefill with remat on (the full config's default) on 2 x 2
    slots of one card, flash: after a warm call, one under ``gc.disable()``
    leaves no tensor unreachable (each layer's weights and residual freed
    when the layer ends, not when the cycle collector runs)."""
    import gc

    card = _cards(1)[0]
    mesh = make_mesh((2, 2), ("data", "model"), devices=[card] * 4)
    cfg = dataclasses.replace(ARCHS["smollm-135m"], n_layers=4, attention_impl="flash")
    assert cfg.remat
    cell = build_cell(cfg, ShapeConfig("prefill", 1024, 4, "prefill"), mesh)
    cell.step_fn(*cell.args)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        cell.step_fn(*cell.args)
        torch.cuda.synchronize(card)
        gc.collect()
        found = [tuple(o.shape) for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not found, found


def test_spread_attention_on_every_card():
    """smollm-135m's 9 q heads over model = 4 on a 1 x 4 mesh of distinct
    cards (``spmd.Lockstep.spread``: each card attends with every head of
    its batch row): a flash prefill launches B9 on every card once a
    layer, and its logits agree with the one-device prefill's within REL
    of max|logit|."""
    from repro_torch.launch.op_cost import CostRecorder

    cards = _cards(4)[:4]
    mesh = make_mesh((1, 4), ("data", "model"), devices=cards)
    cfg = _cfg("smollm-135m", 4, attention_impl="flash")
    params = _bf16_weights(tf.init_params(cfg, seed=0, device=cards[0]))
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), generator=gen, device=cards[0], dtype=torch.int32)
    cell = build_cell(cfg, ShapeConfig("prefill", 1024, 4, "prefill"), mesh, params=params)
    with CostRecorder() as rec:
        got = cell.step_fn(cell.args[0], tokens)
    launched = collections.Counter()
    for dev, counts in rec.counts.items():
        for i, c in counts.items():
            if rec.records[i][0] == "flash_attention":
                launched[dev] += c
    assert launched == {str(card): cfg.n_layers for card in cards}
    _logits_close(got.gather(), ds.make_prefill_step(cfg)(params, tokens))


def test_logits_stay_on_their_cards():
    """Over four distinct cards (2 x 2), the prefill's and decode's logits
    stay where they were computed: each position's block on its own card
    with its sharding's block shape, the first card's memory grown by less
    than the whole logits; gathered, they equal the one-device step's."""
    cards = _cards(4)[:4]
    mesh = make_mesh((2, 2), ("data", "model"), devices=cards)
    cfg = _cfg("smollm-135m", 4, attention_impl="flash")
    params = _bf16_weights(tf.init_params(cfg, seed=0, device=cards[0]))
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen, device=cards[0], dtype=torch.int32)

    def blocks_on_cards(logits):
        block = logits.sharding.shard_shape(logits.shape)
        for p, shard in enumerate(logits.shards):
            assert shard.device == cards[p], (p, shard.device)
            assert tuple(shard.shape) == block, p

    cell = build_cell(cfg, ShapeConfig("prefill", 512, 4, "prefill"), mesh, params=params)
    for card in cards:
        torch.cuda.synchronize(card)
    before = torch.cuda.memory_allocated(cards[0])
    got = cell.step_fn(cell.args[0], tokens)
    torch.cuda.synchronize(cards[0])
    grown = torch.cuda.memory_allocated(cards[0]) - before
    blocks_on_cards(got)
    whole = math.prod(got.shape) * got.dtype.itemsize
    assert got.local(0).nbytes <= grown < whole, (grown, whole)
    _logits_close(got.gather(), ds.make_prefill_step(cfg)(params, tokens))
    del cell, got
    cell = build_cell(cfg, ShapeConfig("decode", 32, 4, "decode"), mesh, params=params)
    cache = device_put(tf.init_cache(cfg, 4, 32, dtype=torch.float32, device=cards[0]), cell.in_shardings[3])
    want_cache = tf.init_cache(cfg, 4, 32, dtype=torch.float32, device=cards[0])
    tok = tokens[:, :1]
    for pos in range(2):
        logits, cache = cell.step_fn(cell.args[0], tok, pos, cache)
        blocks_on_cards(logits)
        want, want_cache = ds.make_serve_step(cfg)(params, tok, pos, want_cache)
        _logits_close(logits.gather(), want)
        tok = torch.argmax(want, -1).to(torch.int32)


@pytest.mark.parametrize(
    "name, rules",
    [
        ("qwen3-moe-30b-a3b", "DEFAULT_RULES"),
        ("qwen3-moe-30b-a3b", "EP_DATA_RULES"),
        ("smollm-135m", "DP_ONLY_RULES"),
        ("smollm-135m", "DEFAULT_RULES"),
        ("qwen3-moe-30b-a3b", "SP_RULES"),
        ("qwen3-moe-30b-a3b", "EP_DP_RULES"),
    ],
)
def test_train_step_across_cards(name, rules):
    cards = _cards(2)
    mesh = _mesh(cards)
    moe = name.startswith("qwen3")
    changes = {"attention_backend": "maclaurin"} if moe else {}
    cfg = _cfg(name, 1 if moe else ARCHS[name].n_layers, **changes)
    B, T = 4, 1024
    gen = torch.Generator(device=cards[0]).manual_seed(0)

    def batch():
        return {
            k: torch.randint(
                0, cfg.vocab_size, (B, T), generator=gen, device=cards[0], dtype=torch.int32
            )
            for k in ("tokens", "labels")
        }

    params = tf.init_params(cfg, seed=0, device=cards[0])
    step = make_train_step(cfg, OCFG)
    state = init_opt_state(OCFG, params, device=cards[0])
    params, state, _ = step(params, state, batch(), 2)
    start, start_state = copy.deepcopy(params), _clone(state)
    b3 = batch()
    params, state, want = step(params, state, b3, 3)
    del state
    shape = ShapeConfig("train", T, B, "train")
    cell = build_cell(cfg, shape, mesh, getattr(part, rules), OCFG, params=start)
    placed_state = device_put(start_state, cell.in_shardings[1])
    build.reset_counts()
    got_p, got_state, got = cell.step_fn(cell.args[0], placed_state, b3, 3)
    if moe:
        assert build.counts()["maclaurin_attention"] >= mesh.size
    for key in ("loss", "xent", "aux", "lr"):
        assert math.isclose(float(got[key]), float(want[key]), rel_tol=RTOL, abs_tol=ATOL), key
    assert math.isclose(float(got["grad_norm"]), float(want["grad_norm"]), rel_tol=NORM_RTOL)
    unbias = 1 - 0.95 ** int(got_state["count"].local(0))  # AdamW's b2
    v = flat(got_state["v"])
    for path, leaf in flat(params.tree(lambda p: p.detach())).items():
        delta = (flat(got_p)[path].gather(cards[0]) - leaf).abs()
        off = delta > ATOL + RTOL * leaf.abs()
        rms = (v[path].gather(cards[0])[off] / unbias).sqrt()
        assert bool((rms < TINY_GRAD).all()), path
        assert float(delta.max()) <= 2 * float(want["lr"]), path


@pytest.mark.parametrize("rules", ["SP_RULES", "EP_DP_RULES"])
def test_rule_set_prefill_across_cards(rules):
    """qwen3-moe, two layers, a flash prefill under SP (the residual cut
    along the sequence; B9 on each position's head shard) and EP_DP (the
    batch over both axes; B9 on all heads of each position's rows)."""
    cards = _cards(2)
    mesh = _mesh(cards)
    cfg = _cfg("qwen3-moe-30b-a3b", 2, attention_impl="flash")
    params = _bf16_weights(tf.init_params(cfg, seed=0, device=cards[0]))
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    B, T = 4, 1024
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=cards[0], dtype=torch.int32)
    shape = ShapeConfig("prefill", T, B, "prefill")
    cell = build_cell(cfg, shape, mesh, getattr(part, rules), params=params)
    build.reset_counts()
    got = cell.step_fn(cell.args[0], tokens).gather()
    assert build.counts()["flash_attention"] == mesh.size * 2
    _logits_close(got, ds.make_prefill_step(cfg)(params, tokens), SHARE)


def test_arctic_layer_with_experts_over_four_cards():
    """One full-width arctic-480b layer (its 128 experts of 7168 x 4864,
    and the dense residual beside them) served as a prefill with the
    experts cut four ways over ``model``: 32 experts, 6.7 GB of bf16, a
    card. Held against the same prefill on the CPU."""
    cards = _cards(4)
    mesh = make_mesh((1, 4), ("data", "model"), devices=cards[:4])
    cfg = _cfg("arctic-480b", 1, attention_impl="flash")
    params = tf.init_params(cfg, seed=0, device=cards[0]).cpu()  # 56 GB at f32
    torch.cuda.empty_cache()
    params = _bf16_weights(params)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen, dtype=torch.int32)
    shape = ShapeConfig("prefill", 256, 1, "prefill")
    cell = build_cell(cfg, shape, mesh, part.TP_ONLY_RULES, params=params)
    w_gate = flat(cell.args[0])[("layers", "moe", "w_gate")]
    assert tuple(w_gate.sharding.spec)[1] == "model"
    held = {dev: 0 for dev in mesh.devices}
    for leaf in flat(cell.args[0]).values():
        for dev, nbytes in leaf.device_bytes().items():
            held[dev] += nbytes
    experts = 3 * 128 * 7168 * 4864 * 2  # bytes of the bf16 experts
    assert all(n >= experts // 4 for n in held.values()) and max(held.values()) < experts // 2
    build.reset_counts()
    got = cell.step_fn(cell.args[0], tokens.to(cards[0])).gather()
    assert build.counts()["flash_attention"] == 4
    assert bool(torch.isfinite(got).all())
    blockwise = dataclasses.replace(cfg, attention_impl="blockwise")
    want = ds.make_prefill_step(blockwise)(params, tokens)
    _logits_close(got, want, share=0.99)


def _images(cfg, card, batch):
    if cfg.family != "vlm":
        return ()
    gen = torch.Generator(device=card).manual_seed(1)
    dims = (batch, cfg.n_image_tokens, cfg.d_model)
    return (torch.randn(dims, generator=gen, device=card),)


@pytest.mark.parametrize("name", list(FAMILY_DEPTH))
def test_family_prefill_and_decode_across_cards(name):
    """Each family past dense and MoE at full width and a cut depth: a
    flash prefill (B9 on the head shards of every self-attention) and
    three decode steps through an f32 cache, under ``choose_rules``."""
    cards = _cards(2)
    mesh = _mesh(cards)
    cfg = _cfg(name, FAMILY_DEPTH[name], attention_impl="flash")
    params = _bf16_weights(tf.init_params(cfg, seed=0, device=cards[0]))
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    T = 256
    tokens = torch.randint(0, cfg.vocab_size, (2, T), generator=gen, device=cards[0], dtype=torch.int32)
    images = _images(cfg, cards[0], 2)
    cell = build_cell(cfg, ShapeConfig("prefill", T, 2, "prefill"), mesh, params=params)
    build.reset_counts()
    got = cell.step_fn(cell.args[0], tokens, *images).gather()
    if cfg.family != "ssm":
        assert build.counts()["flash_attention"] > 0
    _logits_close(got, ds.make_prefill_step(cfg)(params, tokens, *images))
    del cell, got
    cell = build_cell(cfg, ShapeConfig("decode", 32, 2, "decode"), mesh, params=params)
    opts = dict(dtype=torch.float32, device=cards[0])
    if images:
        opts.update(image_embeds=images[0], params=params)
    cache = device_put(tf.init_cache(cfg, 2, 32, **opts), cell.in_shardings[3])
    want_cache = tf.init_cache(cfg, 2, 32, **opts)
    tok = tokens[:, :1]
    for pos in range(3):
        logits, cache = cell.step_fn(cell.args[0], tok, pos, cache, *images)
        logits = logits.gather()
        want, want_cache = ds.make_serve_step(cfg)(params, tok, pos, want_cache, *images)
        _logits_close(logits, want)
        tok = torch.argmax(want, -1).to(torch.int32)


def _train_against_one_device(cfg, mesh, rules, ocfg, cards, B=4, T=256):
    """One sharded train step from the state one one-device step leaves,
    against the one-device step: (got metrics, want metrics, the share of
    parameters beyond 1e-6 + 1e-5 |p|, the largest difference)."""
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    images = _images(cfg, cards[0], B)

    def batch():
        out = {
            k: torch.randint(
                0, cfg.vocab_size, (B, T), generator=gen, device=cards[0], dtype=torch.int32
            )
            for k in ("tokens", "labels")
        }
        if images:
            out["image_embeds"] = images[0]
        return out

    params = tf.init_params(cfg, seed=0, device=cards[0])
    step = make_train_step(cfg, ocfg)
    state = init_opt_state(ocfg, params, device=cards[0])
    params, state, _ = step(params, state, batch(), 2)
    start, start_state = copy.deepcopy(params), _clone(state)
    b3 = batch()
    params, state, want = step(params, state, b3, 3)
    del state
    cell = build_cell(cfg, ShapeConfig("train", T, B, "train"), mesh, getattr(part, rules), ocfg, params=start)
    placed_state = device_put(start_state, cell.in_shardings[1])
    got_p, _, got = cell.step_fn(cell.args[0], placed_state, b3, 3)
    off, total, worst = 0, 0, 0.0
    for path, leaf in flat(params.tree(lambda p: p.detach())).items():
        delta = (flat(got_p)[path].gather(cards[0]) - leaf).abs()
        off += int((delta > ATOL + RTOL * leaf.abs()).sum())
        total += leaf.numel()
        worst = max(worst, float(delta.max()))
    return got, want, off / total, worst


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b", "musicgen-medium"])
def test_family_train_step_across_cards(name):
    """Trained as path 12 trains them (llama-vision's one superblock, 25.5
    GB of f32 weights, needs 102 GB with its gradients and moments for the
    one-device reference, so it is served only)."""
    cards = _cards(2)
    changes = {"attention_backend": "maclaurin"} if name == "zamba2-2.7b" else {}
    cfg = _cfg(name, FAMILY_DEPTH[name], **changes)
    got, want, off, worst = _train_against_one_device(cfg, _mesh(cards), "DEFAULT_RULES", OCFG, cards)
    for key in ("loss", "xent", "aux", "lr"):
        assert math.isclose(float(got[key]), float(want[key]), rel_tol=RTOL, abs_tol=ATOL), key
    assert math.isclose(float(got["grad_norm"]), float(want["grad_norm"]), rel_tol=NORM_RTOL)
    assert off <= OFF_SHARE and worst <= 2 * float(want["lr"])


@pytest.mark.parametrize("rules", ["SP_RULES", "EP_DP_RULES"])
def test_hybrid_train_step_under_rule_sets_across_cards(rules):
    """zamba2, one group, under SP (Mamba2 and the shared attention block
    on the gathered sequence, their outputs reduce-scattered) and EP_DP
    (the Mamba2 and FFN weights gathered over "model")."""
    cards = _cards(2)
    cfg = _cfg("zamba2-2.7b", FAMILY_DEPTH["zamba2-2.7b"], attention_backend="maclaurin")
    got, want, off, worst = _train_against_one_device(cfg, _mesh(cards), rules, OCFG, cards, T=1024)
    for key in ("loss", "xent", "aux", "lr"):
        assert math.isclose(float(got[key]), float(want[key]), rel_tol=RTOL, abs_tol=ATOL), key
    assert math.isclose(float(got["grad_norm"]), float(want["grad_norm"]), rel_tol=NORM_RTOL)
    assert off <= OFF_SHARE and worst <= 2 * float(want["lr"])


def test_optimizer_options_across_cards():
    """qwen3-moe, one layer, under EP_DATA with Adafactor, two microbatches
    and compressed gradients: the options arctic-480b's train cell uses."""
    cards = _cards(2)
    cfg = _cfg("qwen3-moe-30b-a3b", 1, attention_backend="maclaurin")
    ocfg = dataclasses.replace(OCFG, name="adafactor", microbatches=2, compress_grads=True)
    got, want, off, _ = _train_against_one_device(cfg, _mesh(cards), "EP_DATA_RULES", ocfg, cards, T=1024)
    for key in ("loss", "xent", "aux", "lr"):
        assert math.isclose(float(got[key]), float(want[key]), rel_tol=RTOL, abs_tol=ATOL), key
    assert math.isclose(float(got["grad_norm"]), float(want["grad_norm"]), rel_tol=NORM_RTOL)
    assert off <= OFF_SHARE


def test_data_parallel_microbatches_level_across_cards():
    """smollm-135m at full width, 2 layers, one DP_ONLY training step with
    two microbatches over four cards (4, 1), the batch placed by its
    sharding: each card's rows of a microbatch are copied from the card
    that holds them, every gradient is all-reduced with each card adding
    its chunk, and each replica is updated on its own card. So no card
    holds the whole batch or does the others' sums: each card's
    ``max_memory_allocated`` lies within LEVEL of the others', the
    replicas are bit-equal, and the loss and gradient norm are the
    one-device step's (run after it, on the first card)."""
    cards = _cards(4)[:4]
    mesh = make_mesh((4, 1), ("data", "model"), devices=cards)
    cfg = _cfg("smollm-135m", 2)
    ocfg = dataclasses.replace(OCFG, microbatches=2)
    B, T = 8, 1024
    gen = torch.Generator().manual_seed(0)
    batch = {
        k: torch.randint(0, cfg.vocab_size, (B, T), generator=gen, dtype=torch.int32)
        for k in ("tokens", "labels")
    }
    params = tf.init_params(cfg, seed=0, device="cpu")
    state = init_opt_state(ocfg, params, device="cpu")
    cell = build_cell(cfg, ShapeConfig("train", T, B, "train"), mesh, part.DP_ONLY_RULES, ocfg, params=params)
    placed_state = device_put(state, cell.in_shardings[1])
    placed_batch = device_put(batch, cell.in_shardings[2])
    for card in cards:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
    got_p, _, got = cell.step_fn(cell.args[0], placed_state, placed_batch, 3)
    peaks = [torch.cuda.max_memory_allocated(card) for card in cards]
    print("peak bytes a card:", peaks)
    assert max(peaks) / min(peaks) - 1 <= LEVEL, peaks
    for path, leaf in flat(got_p).items():
        for g in leaf.replica_groups():
            assert all(torch.equal(leaf.local(p).cpu(), leaf.local(g[0]).cpu()) for p in g), path
    del cell, got_p, placed_state, placed_batch
    params = params.to(cards[0])
    state = init_opt_state(ocfg, params, device=cards[0])
    one = {k: v.to(cards[0]) for k, v in batch.items()}
    _, _, want = make_train_step(cfg, ocfg)(params, state, one, 3)
    for key in ("loss", "xent", "aux", "lr"):
        assert math.isclose(float(got[key]), float(want[key]), rel_tol=RTOL, abs_tol=ATOL), key
    assert math.isclose(float(got["grad_norm"]), float(want["grad_norm"]), rel_tol=NORM_RTOL)
