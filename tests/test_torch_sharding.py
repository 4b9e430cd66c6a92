"""``repro_torch.sharding`` and ``launch.specs`` held against ``repro``'s in
one process: the reference's partitioning cases on the port; rules, specs,
shardings and the layout policy over every configuration, rule set and
mesh; the spec trees; the hint call sites; and placement over a mesh of
CPU slots, through ``device_put`` and a checkpoint's restore.

The reference's end-to-end sharded lowering (``tests/test_sharding.py``'s
slow case) has no counterpart: the port lowers nothing."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.sharding import partitioning as jpart  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import hints  # noqa: E402
from repro_torch.sharding import partitioning as part  # noqa: E402
from repro_torch.sharding.partitioning import (  # noqa: E402
    DEFAULT_RULES,
    TP_ONLY_RULES,
    NamedSharding,
    PartitionSpec as P,
    abstract_mesh,
    batch_pspec,
    device_put,
    spec_to_pspec,
)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

RULES = ("DEFAULT_RULES", "TP_ONLY_RULES", "DP_ONLY_RULES", "EP_DATA_RULES", "SP_RULES", "EP_DP_RULES")
MESHES = {
    "model4": ((4,), ("model",)),
    "data2_model2": ((2, 2), ("data", "model")),
    "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model")),
}


def _mesh(shape=(2, 2), axes=("data", "model")):
    return abstract_mesh(shape, axes)


# ------------------------------------------ the reference's unit cases


def test_spec_to_pspec_basic():
    mesh = _mesh()
    assert spec_to_pspec(("embed", "ffn"), DEFAULT_RULES, mesh) == P("data", "model")
    assert spec_to_pspec(("vocab", "embed"), DEFAULT_RULES, mesh) == P("model", "data")
    assert spec_to_pspec((None, "heads"), DEFAULT_RULES, mesh) == P(None, "model")


def test_mesh_axis_used_at_most_once():
    mesh = _mesh()
    # ("embed", "embed") must not map 'data' twice
    ps = spec_to_pspec(("embed", "embed"), DEFAULT_RULES, mesh)
    assert ps == P("data", None)


def test_missing_mesh_axes_degrade_to_replication():
    mesh = _mesh((4,), ("model",))
    ps = spec_to_pspec(("embed", "ffn"), DEFAULT_RULES, mesh)  # no 'data' axis
    assert ps == P(None, "model")


def test_batch_pspec_single_and_multipod():
    assert batch_pspec(_mesh()) == P("data")
    m3 = _mesh((2, 2, 2), ("pod", "data", "model"))
    assert batch_pspec(m3) == P(("pod", "data"))


def test_tp_only_rules_drop_fsdp():
    mesh = _mesh()
    assert spec_to_pspec(("embed", "ffn"), TP_ONLY_RULES, mesh) == P(None, "model")


def test_rules_replace():
    r = DEFAULT_RULES.replace(ffn=("data", "model"))
    mesh = _mesh()
    assert spec_to_pspec((None, "ffn"), r, mesh) == P(None, ("data", "model"))


# ------------------------------------------------ against the reference


def _flat(tree, path=()):
    """{path: leaf} over nested dicts (and the cache specs' tuples of
    spec tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _spec(x) -> tuple:
    """A PartitionSpec of either package, or a sharding's, as a tuple."""
    if isinstance(x, (NamedSharding, JNamedSharding)):
        x = x.spec
    return tuple(x)


def _outcome(fn, *args):
    """``fn(*args)``'s spec, or the ``ValueError`` both packages raise for
    a mesh axis the mesh lacks (ZeRO-1 names "data" on a mesh without it)."""
    try:
        return _spec(fn(*args))
    except ValueError:
        return ValueError


@functools.cache
def _trees(name: str):
    """(port spec, port tree of parameters, reference spec, reference
    shapes) of the reduced ``name``."""
    params = transformer.init_params(ARCHS[name].reduced(), device="cpu")
    box = {}

    def build(key):
        p, s = jtransformer.init_params(JARCHS[name].reduced(), key)
        box["spec"] = s
        return p

    sds = jax.eval_shape(build, jax.random.PRNGKey(0))
    return params.spec(), params.tree(), box["spec"], sds


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_spec_tree_equals_the_reference(name):
    spec, tree, jspec, jsds = _trees(name)
    jflat = {k: tuple(v) for k, v in _flat(jspec).items()}
    assert _flat(spec) == jflat
    shapes = {k: tuple(v.shape) for k, v in _flat(tree).items()}
    assert shapes == {k: tuple(v.shape) for k, v in _flat(jsds).items()}
    # every spec names one axis a dim
    assert all(len(jflat[k]) == len(shapes[k]) for k in jflat)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_rules_specs_and_shardings_equal_the_reference(name, mesh_name):
    """spec_to_pspec (through param_pspecs), param_shardings, sanitize,
    zero1_opt_sharding and batch_pspec under all six rule sets."""
    shape, axes = MESHES[mesh_name]
    mesh, jmesh = abstract_mesh(shape, axes), jpart.abstract_mesh(shape, axes)
    spec, tree, jspec, jsds = _trees(name)
    shapes = _flat(tree)
    for rules_name in RULES:
        rules, jrules = getattr(part, rules_name), getattr(jpart, rules_name)
        assert rules.rules == jrules.rules
        got = _flat(part.param_pspecs(spec, rules, mesh))
        want = _flat(jpart.param_pspecs(jspec, jrules, jmesh))
        assert {k: _spec(v) for k, v in got.items()} == {k: _spec(v) for k, v in want.items()}
        sh = part.param_shardings(spec, rules, mesh)
        jsh = jpart.param_shardings(jspec, jrules, jmesh)
        clean = _flat(specs.sanitize(sh, tree, mesh))
        jclean = _flat(jspecs.sanitize(jsh, jsds, jmesh))
        assert {k: _spec(v) for k, v in clean.items()} == {k: _spec(v) for k, v in jclean.items()}
        for k, s in clean.items():
            z = _outcome(part.zero1_opt_sharding, s, tuple(shapes[k].shape), mesh)
            jz = _outcome(jpart.zero1_opt_sharding, jclean[k], tuple(shapes[k].shape), jmesh)
            assert z == jz, (rules_name, k)
        assert _spec(batch_pspec(mesh, rules)) == _spec(jpart.batch_pspec(jmesh, jrules))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_spec_shardings_equal_the_reference(mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh, jmesh = abstract_mesh(shape, axes), jpart.abstract_mesh(shape, axes)
    for name in sorted(ARCHS):
        for backend in ("softmax", "maclaurin"):
            cfg = ARCHS[name].reduced().with_backend(backend)
            jcfg = JARCHS[name].reduced().with_backend(backend)
            got = part.param_pspecs(transformer.cache_spec(cfg), DEFAULT_RULES, mesh)
            want = jpart.param_pspecs(jtransformer.cache_spec(jcfg), jpart.DEFAULT_RULES, jmesh)
            flat = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, JP))
            mine = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, P))
            assert [_spec(x) for x in mine] == [_spec(x) for x in flat], (name, backend)


def _cfg_pairs():
    return [(name, shape) for name in sorted(ARCHS) for shape in sorted(SHAPES)]


@pytest.mark.parametrize("name, shape", _cfg_pairs())
def test_layout_policy_equals_the_reference(name, shape):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    s, js = SHAPES[shape], JSHAPES[shape]
    picked, jpicked = specs.pick_backend(cfg, s), jspecs.pick_backend(jcfg, js)
    assert picked.attention_backend == jpicked.attention_backend
    for dp in (1, 16, 64):
        got = specs.choose_optimizer(picked, s, dp_ways=dp)
        want = jspecs.choose_optimizer(jpicked, js, dp_ways=dp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(specs.choose_optimizer(cfg)) == dataclasses.asdict(
        jspecs.choose_optimizer(jcfg)
    )
    rules = specs.choose_rules(picked, s, None)
    assert rules.rules == jspecs.choose_rules(jpicked, js, None).rules
    assert specs.choose_rules(picked, s, TP_ONLY_RULES) is TP_ONLY_RULES


def test_an_h100_budget_keeps_more_models_under_tp_only():
    """``device_bytes`` scales the reference's weight budget: at 80 GB a
    model whose bf16 weights cut 16 ways pass 10 GB (llama-3.2-vision's
    ~11 GB) serves under TP_ONLY."""
    cfg = ARCHS["llama-3.2-vision-90b"]
    serve = SHAPES["decode_32k"]
    assert specs.choose_rules(cfg, serve, None) == DEFAULT_RULES
    assert specs.choose_rules(cfg, serve, None, device_bytes=80e9) == TP_ONLY_RULES
    train = SHAPES["train_4k"]
    small = specs.choose_optimizer(cfg, train, dp_ways=16)
    big = specs.choose_optimizer(cfg, train, dp_ways=16, device_bytes=80e9)
    assert big.microbatches <= small.microbatches


# -------------------------------------------------------- hint call sites


HINT_MODELS = ("smollm-135m", "qwen3-moe-30b-a3b")


def _hint_runs(name, monkeypatch, loss: bool):
    """(port's sequence of (shape, spec), reference's) from one forward, or
    one train step's loss, under hints on a one-device (1, 1) mesh."""
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.sharding.hints import use_hints as juse_hints

    cfg, jcfg = ARCHS[name].reduced(), JARCHS[name].reduced()
    jparams, _ = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}

    seen, jseen = [], []

    def watch(x, sharding):
        seen.append((tuple(x.shape), _spec(sharding)))
        return x

    def jwatch(x, sharding):
        jseen.append((tuple(x.shape), _spec(sharding)))
        return x

    monkeypatch.setattr(hints, "constrain", watch)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", jwatch)
    mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    with hints.use_hints(mesh, DEFAULT_RULES), torch.no_grad():
        if loss:
            out = train_step.make_loss_fn(cfg)(params, tbatch)[0]
        else:
            out = transformer.forward(cfg, params, tbatch["tokens"])[0]
    with juse_hints(jmesh, jpart.DEFAULT_RULES):
        if loss:
            jout = jtrain_step.make_loss_fn(jcfg)(jparams, jbatch)[0]
        else:
            jout = jtransformer.forward(jcfg, jparams, jbatch["tokens"])[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-4, atol=2e-4)
    return seen, jseen, cfg.n_layers


@pytest.mark.parametrize("loss", [False, True], ids=["forward", "loss"])
@pytest.mark.parametrize("name", HINT_MODELS)
def test_hint_call_sites_equal_the_reference(name, loss, monkeypatch):
    """The reference's ``lax.scan`` traces its layer body once, so it hands
    the layer's hints over once; the port's loop calls them every layer.
    Past that, the (shape, resolved spec) sequences are the same, and no
    hint changes a value (the outputs agree)."""
    seen, jseen, n_layers = _hint_runs(name, monkeypatch, loss)
    head = 1  # the embedding's
    tail = 2 if loss else 1  # the logits' (and the loss's)
    body = jseen[head : len(jseen) - tail]
    assert seen == jseen[:head] + body * n_layers + jseen[len(jseen) - tail :]
    assert jseen[0][1] == ("data", None, None)
    assert jseen[-1][1] == ("data", None, "model")
    if name.startswith("qwen3-moe"):
        assert ("data", "model", None, None) in [s for _, s in body]


def test_hint_is_identity_outside_and_inside(monkeypatch):
    x = torch.arange(12.0).reshape(3, 4)
    assert hints.hint(x, "batch", None) is x
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    seen = []
    monkeypatch.setattr(hints, "constrain", lambda x, s: seen.append(s) or x)
    with hints.use_hints(mesh, DEFAULT_RULES):
        assert hints.hint(x, "batch", "vocab") is x
    # 3 rows do not divide over 'data': downgraded, as the reference's
    assert seen[0].spec == P(None, "model")
    assert hints.hint(x, "batch") is x and len(seen) == 1


# ------------------------------------------------- placement over a mesh


def _cpu_mesh():
    return make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)


@pytest.mark.parametrize("rules_name", ["DEFAULT_RULES", "TP_ONLY_RULES", "EP_DATA_RULES"])
def test_device_put_cuts_and_gathers_bit_for_bit(rules_name):
    mesh = _cpu_mesh()
    params = transformer.init_params(ARCHS["qwen3-moe-30b-a3b"].reduced(), device="cpu")
    tree = params.tree()
    sh = specs.sanitize(part.param_shardings(params.spec(), getattr(part, rules_name), mesh), tree, mesh)
    placed = device_put(tree, sh)
    for path, leaf in _flat(tree).items():
        got = _flat(placed)[path]
        parts = [1] * leaf.ndim
        for dim, s in enumerate(tuple(got.sharding.spec)):
            for a in (() if s is None else (s,) if isinstance(s, str) else s):
                parts[dim] *= mesh.shape[a]
        cut = tuple(n // p for n, p in zip(leaf.shape, parts))
        assert all(tuple(s.shape) == cut for s in got.shards), path
        assert torch.equal(got.gather(), leaf), path
        nbytes = leaf.numel() * leaf.element_size()
        assert sum(got.position_bytes()) == nbytes * 4 // np.prod(parts)
        assert got.device_bytes() == {torch.device("cpu"): sum(got.position_bytes())}
    # the experts are cut over the data axis only under EP_DATA_RULES
    w_gate = _flat(placed)[("layers", "moe", "w_gate")].sharding.spec
    assert tuple(w_gate)[1] == ("data" if rules_name == "EP_DATA_RULES" else "model")


def test_device_put_refuses_what_does_not_divide_and_abstract_meshes():
    mesh = _cpu_mesh()
    with pytest.raises(ValueError, match="divide"):
        device_put(torch.zeros(3, 4), NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="abstract"):
        device_put(torch.zeros(4), NamedSharding(abstract_mesh((2,), ("data",)), P("data")))
    # one sharding for a whole tree; replicated positions each hold a copy
    placed = device_put({"a": torch.ones(4, 2), "b": [torch.ones(2)]}, NamedSharding(mesh, P("model")))
    assert [tuple(s.shape) for s in placed["a"].shards] == [(2, 2)] * 4
    assert placed["b"][0].position_bytes() == [4] * 4


def test_restore_onto_shardings(tmp_path):
    """The reference's restore-with-resharding case, and an LMParams
    restored onto its spec tree's shardings over four CPU slots."""
    tree = {"layers": {"w": torch.arange(12.0).reshape(4, 3)}, "b": torch.ones(2)}
    ckpt.save(str(tmp_path), 3, tree)
    one = make_mesh((1,), ("data",), devices=["cpu"])
    sh = {"layers": {"w": NamedSharding(one, P())}, "b": NamedSharding(one, P())}
    r = ckpt.restore(str(tmp_path), 3, tree, shardings=sh)
    assert r["layers"]["w"].sharding == sh["layers"]["w"] and r["b"].sharding == sh["b"]
    assert torch.equal(r["layers"]["w"].gather(), tree["layers"]["w"])

    mesh = _cpu_mesh()
    params = transformer.init_params(ARCHS["smollm-135m"].reduced(), device="cpu")
    ckpt.save(str(tmp_path), 4, params)
    want = params.tree()
    shardings = specs.sanitize(part.param_shardings(params.spec(), DEFAULT_RULES, mesh), want, mesh)
    got = ckpt.restore(str(tmp_path), 4, params, shardings=shardings)
    for path, leaf in _flat(want).items():
        placed = _flat(got)[path]
        assert placed.sharding == _flat(shardings)[path]
        assert torch.equal(placed.gather(), leaf), path
    # the tree of devices still restores an LMParams
    again = ckpt.restore(str(tmp_path), 4, params, shardings="cpu")
    assert isinstance(again, transformer.LMParams)
