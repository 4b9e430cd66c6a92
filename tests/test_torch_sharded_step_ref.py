"""The rule-sharded LM steps against the JAX package, on the CPU.

``launch.specs.build_cell``'s ``meta``, donated arguments and shardings
(in and out) against the reference's ``build_cell`` on an abstract mesh of
the same (2, 2) shape, for reduced smollm-135m and qwen3-moe cells of each
kind, the rules ``choose_rules`` picks and EP_DATA, and the decode cells'
two special layouts (a batch that does not divide over ``data``; kv heads
that do not divide ``model``, whose cache is cut along its sequence).

The families past dense and MoE (musicgen-medium, rwkv6-7b, zamba2-2.7b,
llama-3.2-vision-90b: a train, a prefill and a decode cell each under
``choose_rules``, the VLM's with its image embeddings and its image
cache) and the optimizer options (an Adafactor cell's ``vr``/``vc``
shardings, a compressed cell's ``ef``, a microbatched one). The last two
rule sets, SP_RULES and EP_DP_RULES: a train, a prefill and a decode cell
of smollm-135m, qwen3-moe and zamba2-2.7b under each.

Then one case a model held against the reference's one-device steps on the
same weights (``convert``) and batch: smollm-135m under DEFAULT_RULES (FSDP
and tensor parallelism) and SP_RULES (the residual cut along the
sequence), qwen3-moe under EP_DATA_RULES (the experts' all-to-all) and
EP_DP_RULES (the batch over both axes, the ffn dims gathered), and one a
family past them (musicgen-medium, rwkv6-7b and
zamba2-2.7b under DEFAULT_RULES, llama-3.2-vision-90b under its serving
rules, TP_ONLY, with its image embeddings), each a train step at steps 0
and 3 on two batches (as
``tests/test_torch_train.py`` takes them), a prefill and two decode steps
through an f32 cache. The reference's sharded step computes its
one-device step's function, so this pins the port's sharded step to it.
Tolerance: STEP_TOL = 1e-5 of max(1, max|ref|), ``test_torch_train.py``'s.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import decode_step as jds  # noqa: E402
from repro.sharding import partitioning as jpart  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding import spmd  # noqa: E402
from repro_torch.sharding.partitioning import NamedSharding, device_put  # noqa: E402
from repro_torch.train.train_step import OptimizerConfig  # noqa: E402

STEP_TOL = 1e-5
B, T = 4, 16
NARROW = dict(n_heads=9, n_kv_heads=3, head_dim=8)
OCFG = OptimizerConfig(peak_lr=1e-3, warmup=2, total_steps=10)

CELLS = [  # (model, kind, rules (None: choose_rules), batch, config changes)
    ("smollm-135m", "train", None, B, ()),
    ("smollm-135m", "prefill", None, B, ()),
    ("smollm-135m", "decode", None, B, ()),
    ("smollm-135m", "decode", "DEFAULT_RULES", B, tuple(NARROW.items())),
    ("qwen3-moe-30b-a3b", "train", None, B, ()),
    ("qwen3-moe-30b-a3b", "train", "EP_DATA_RULES", B, ()),
    ("qwen3-moe-30b-a3b", "prefill", None, B, ()),
    ("qwen3-moe-30b-a3b", "decode", "DEFAULT_RULES", 1, ()),
] + [
    (name, kind, None, B, ())
    for name in ("musicgen-medium", "rwkv6-7b", "zamba2-2.7b", "llama-3.2-vision-90b")
    for kind in ("train", "prefill", "decode")
] + [
    (name, kind, rules, B, ())
    for rules in ("SP_RULES", "EP_DP_RULES")
    for name in ("smollm-135m", "qwen3-moe-30b-a3b", "zamba2-2.7b")
    for kind in ("train", "prefill", "decode")
]


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


def _specs(tree) -> list:
    """Each sharding's spec of either package, in JAX's leaf order (dict
    keys sorted, Nones dropped)."""
    if isinstance(tree, (NamedSharding, JNamedSharding)):
        return [tuple(tree.spec)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _specs(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _specs(v)]
    assert tree is None
    return []


@pytest.mark.parametrize("name, kind, rules, batch, changes", CELLS)
def test_build_cell_equals_the_reference(name, kind, rules, batch, changes):
    cfg = dataclasses.replace(ARCHS[name].reduced(), **dict(changes))
    jcfg = dataclasses.replace(JARCHS[name].reduced(), **dict(changes))
    shape, jshape = ShapeConfig(kind, T, batch, kind), JShapeConfig(kind, T, batch, kind)
    cell = specs.build_cell(cfg, shape, _mesh(), rules and getattr(part, rules))
    jcell = jspecs.build_cell(
        jcfg, jshape, jpart.abstract_mesh((2, 2), ("data", "model")), rules and getattr(jpart, rules)
    )
    assert cell.meta == jcell.meta
    assert cell.donate_argnums == jcell.donate_argnums
    assert _specs(cell.in_shardings) == _specs(jcell.in_shardings)
    assert _specs(cell.out_shardings) == _specs(jcell.out_shardings)
    # the placed arguments: every leaf by its in-sharding, serving weights bf16
    for arg, sh in zip(cell.args, cell.in_shardings):
        placed, want = spmd.flat(arg), spmd.flat(sh)
        for path, leaf in placed.items():
            if isinstance(leaf, tuple):  # the cache's stacks
                assert [x.sharding for x in leaf] == list(want[path])
            else:
                assert leaf.sharding == want[path]
    floating = {leaf.dtype for leaf in spmd.flat(cell.args[0]).values()}
    assert floating == ({torch.float32} if kind == "train" else {torch.bfloat16})


def test_a_cache_cut_twice_over_model_raises_as_the_reference():
    """EP_DP's batch holds "model", and 3 kv heads send the decode cache's
    sequence to "model" too (the reference's ``_seq_shard``): a spec that
    names one mesh axis twice, which both packages refuse."""
    cfg = dataclasses.replace(ARCHS["smollm-135m"].reduced(), **NARROW)
    jcfg = dataclasses.replace(JARCHS["smollm-135m"].reduced(), **NARROW)
    jmesh = jpart.abstract_mesh((2, 2), ("data", "model"))
    with pytest.raises(Exception, match="duplicate"):
        jspecs.build_cell(jcfg, JShapeConfig("d", T, B, "decode"), jmesh, jpart.EP_DP_RULES)
    with pytest.raises(ValueError, match="twice"):
        specs.build_cell(cfg, ShapeConfig("d", T, B, "decode"), _mesh(), part.EP_DP_RULES)


def _close(t, j, what):
    t = np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape, what
    tol = STEP_TOL * max(1.0, float(np.abs(j).max())) if j.size else 0.0
    assert float(np.abs(t - j).max()) <= tol, (what, float(np.abs(t - j).max()))


def _trees_close(tree, jtree, what):
    jflat = spmd.flat(jtree)
    for path, leaf in spmd.flat(tree).items():
        _close(leaf.gather(), jflat[path], (what,) + path)


@functools.cache
def _reference_weights(name):
    jcfg = JARCHS[name].reduced()
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, jparams)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return tokens, labels


@pytest.mark.parametrize(
    "name, rules",
    [
        ("smollm-135m", "DEFAULT_RULES"),
        ("qwen3-moe-30b-a3b", "EP_DATA_RULES"),
        ("smollm-135m", "SP_RULES"),
        ("qwen3-moe-30b-a3b", "EP_DP_RULES"),
    ],
)
def test_sharded_steps_match_the_reference(name, rules):
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    rules_ = getattr(part, rules)
    np_params = _reference_weights(name)
    params = convert.lm_params_from_numpy(cfg, np_params, device="cpu")
    tokens, labels = _batch(cfg)
    mesh = _mesh()

    # train: steps 0 and 3 from zero moments
    jocfg = jts.OptimizerConfig(**dataclasses.asdict(OCFG))
    cell = specs.build_cell(cfg, ShapeConfig("t", T, B, "train"), mesh, rules_, OCFG, params=params)
    placed, state = cell.args[0], cell.args[1]
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = jts.init_opt_state(jocfg, jparams)
    jstep = jax.jit(jts.make_train_step(jcfg, jocfg))
    for s in (0, 3):  # a batch a step, as the port's loader gives them
        b = dict(zip(("tokens", "labels"), _batch(cfg, seed=s)))
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
        placed, state, metrics = cell.step_fn(placed, state, batch, s)
        jparams, jstate, jmetrics = jstep(jparams, jstate, jbatch, jnp.int32(s))
    assert set(metrics) == set(jmetrics)
    for key in jmetrics:
        _close(metrics[key], jmetrics[key], key)
    _trees_close(placed, jparams, "params")
    for key in ("m", "v"):
        _trees_close(state[key], jstate[key], key)

    # serving: the cell's bf16 weights, as the reference's
    rounded = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), np_params)
    cell = specs.build_cell(cfg, ShapeConfig("p", T, B, "prefill"), mesh, rules_, params=params)
    logits = cell.step_fn(cell.args[0], torch.from_numpy(tokens)).gather()
    _close(logits, jds.make_prefill_step(jcfg)(rounded, jnp.asarray(tokens)), "prefill logits")

    cell = specs.build_cell(cfg, ShapeConfig("d", T, B, "decode"), mesh, rules_, params=params)
    cache = device_put(tf.init_cache(cfg, B, T, dtype=torch.float32, device="cpu"), cell.in_shardings[3])
    jcache = jtf.init_cache(jcfg, B, T, dtype=jnp.float32)
    jserve = jax.jit(jds.make_serve_step(jcfg))
    for pos in range(2):
        tok = tokens[:, pos : pos + 1]
        logits, cache = cell.step_fn(cell.args[0], torch.from_numpy(tok), pos, cache)
        logits = logits.gather()
        jlogits, jcache = jserve(rounded, jnp.asarray(tok), jnp.int32(pos), jcache)
        _close(logits, jlogits, f"decode logits at {pos}")
    for got, want in zip(cache["kv"], jcache["kv"]):
        _close(got.gather(), want, "cache")


TINY_GRAD = 1e-6  # a gradient RMS far below the ~1e-4 typical of these models


def _params_close(placed, jparams, v, lr):
    """Updated parameters at STEP_TOL, but where the gradient's running RMS
    (AdamW's bias-corrected sqrt(v), after steps 0 and 3) is below
    TINY_GRAD: there the update lr m / (sqrt(v) + eps) divides two
    cancellation residues (llama-vision reduced: one embedding element
    whose gradient RMS is 6e-11), which the port's own one-device step
    moves 2.8e-4 from the reference's there, and the sharded one 5.6e-5.
    Such an element is held within 2 lr."""
    b2 = 0.95
    unbias = 1 - b2**2
    jflat, vflat = spmd.flat(jparams), spmd.flat(v)
    for path, leaf in spmd.flat(placed).items():
        got, want = leaf.gather().double().numpy(), np.asarray(jflat[path], np.float64)
        tol = STEP_TOL * max(1.0, float(np.abs(want).max()))
        off = np.abs(got - want) > tol
        rms = np.sqrt(vflat[path].gather().double().numpy() / unbias)
        assert (rms[off] < TINY_GRAD).all(), (path, float(np.abs(got - want).max()))
        assert float(np.abs(got - want).max()) <= 2 * lr, path


OPTION_CELLS = [  # (model, rules, optimizer options)
    ("qwen3-moe-30b-a3b", "DEFAULT_RULES", dict(name="adafactor")),
    ("qwen3-moe-30b-a3b", "EP_DATA_RULES", dict(name="adafactor", microbatches=2, compress_grads=True)),
    ("smollm-135m", "DEFAULT_RULES", dict(compress_grads=True)),
    ("rwkv6-7b", "DEFAULT_RULES", dict(microbatches=2)),
]


@pytest.mark.parametrize("name, rules, options", OPTION_CELLS)
def test_optimizer_cells_equal_the_reference(name, rules, options):
    """Adafactor's factored ``vr``/``vc`` and the compressed cells' ``ef``
    placed as the reference's ``_opt_spec_tree`` places them."""
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    ocfg = OptimizerConfig(**options)
    jocfg = jts.OptimizerConfig(**dataclasses.asdict(ocfg))
    shape, jshape = ShapeConfig("t", T, B, "train"), JShapeConfig("t", T, B, "train")
    cell = specs.build_cell(cfg, shape, _mesh(), getattr(part, rules), ocfg)
    jmesh = jpart.abstract_mesh((2, 2), ("data", "model"))
    jcell = jspecs.build_cell(jcfg, jshape, jmesh, getattr(jpart, rules), jocfg)
    assert cell.meta == jcell.meta
    assert _specs(cell.in_shardings) == _specs(jcell.in_shardings)
    assert _specs(cell.out_shardings) == _specs(jcell.out_shardings)
    state = cell.args[1]
    assert set(state) == set(jcell.args[1])
    for path, leaf in spmd.flat(state).items():
        assert leaf.sharding == spmd.flat(cell.in_shardings[1])[path]
        assert leaf.shape == tuple(spmd.flat(jcell.args[1])[path].shape)


@functools.cache
def _family_weights(name):
    jcfg = JARCHS[name].reduced()
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, jparams)


def _images(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize(
    "name, rules",
    [
        ("musicgen-medium", "DEFAULT_RULES"),
        ("rwkv6-7b", "DEFAULT_RULES"),
        ("zamba2-2.7b", "DEFAULT_RULES"),
        ("llama-3.2-vision-90b", "TP_ONLY_RULES"),
    ],
)
def test_family_steps_match_the_reference(name, rules):
    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    rules_ = getattr(part, rules)
    np_params = _family_weights(name)
    params = convert.lm_params_from_numpy(cfg, np_params, device="cpu")
    tokens, _ = _batch(cfg)
    vlm = cfg.family == "vlm"
    images = _images(cfg) if vlm else None
    extra = (torch.from_numpy(images),) if vlm else ()
    jextra = (jnp.asarray(images),) if vlm else ()
    mesh = _mesh()

    # train: steps 0 and 3 from zero moments, a batch a step
    jocfg = jts.OptimizerConfig(**dataclasses.asdict(OCFG))
    cell = specs.build_cell(cfg, ShapeConfig("t", T, B, "train"), mesh, rules_, OCFG, params=params)
    placed, state = cell.args[0], cell.args[1]
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = jts.init_opt_state(jocfg, jparams)
    jstep = jax.jit(jts.make_train_step(jcfg, jocfg))
    for s in (0, 3):
        b = dict(zip(("tokens", "labels"), _batch(cfg, seed=s)))
        if vlm:
            b["image_embeds"] = images
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        jbatch = {k: jnp.asarray(v) for k, v in b.items()}
        placed, state, metrics = cell.step_fn(placed, state, batch, s)
        jparams, jstate, jmetrics = jstep(jparams, jstate, jbatch, jnp.int32(s))
    assert set(metrics) == set(jmetrics)
    for key in jmetrics:
        _close(metrics[key], jmetrics[key], key)
    for key in ("m", "v"):
        _trees_close(state[key], jstate[key], key)
    _params_close(placed, jparams, state["v"], float(jmetrics["lr"]))

    # serving: the cell's bf16 weights, as the reference's
    rounded = jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), np_params
    )
    cell = specs.build_cell(cfg, ShapeConfig("p", T, B, "prefill"), mesh, rules_, params=params)
    logits = cell.step_fn(cell.args[0], torch.from_numpy(tokens), *extra).gather()
    want = jds.make_prefill_step(jcfg)(rounded, jnp.asarray(tokens), *jextra)
    _close(logits, want, "prefill logits")

    cell = specs.build_cell(cfg, ShapeConfig("d", T, B, "decode"), mesh, rules_, params=params)
    opts = dict(dtype=torch.float32, device="cpu")
    if vlm:
        opts.update(image_embeds=extra[0], params=convert.lm_params_from_numpy(cfg, rounded, device="cpu"))
    cache = device_put(tf.init_cache(cfg, B, T, **opts), cell.in_shardings[3])
    jopts = dict(image_embeds=jextra[0], params=rounded) if vlm else {}
    jcache = jtf.init_cache(jcfg, B, T, dtype=jnp.float32, **jopts)
    jserve = jax.jit(jds.make_serve_step(jcfg))
    for pos in range(2):
        tok = tokens[:, pos : pos + 1]
        logits, cache = cell.step_fn(cell.args[0], torch.from_numpy(tok), pos, cache, *extra)
        logits = logits.gather()
        jlogits, jcache = jserve(rounded, jnp.asarray(tok), jnp.int32(pos), jcache, *jextra)
        _close(logits, jlogits, f"decode logits at {pos}")
    jflat = spmd.flat(jcache)
    for path, leaf in spmd.flat(cache).items():
        leaves = leaf if isinstance(leaf, tuple) else (leaf,)
        jleaves = jflat[path] if isinstance(leaf, tuple) else (jflat[path],)
        for got, want in zip(leaves, jleaves):
            _close(got.gather(), want, ("cache",) + path)
