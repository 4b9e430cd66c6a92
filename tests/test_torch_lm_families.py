"""The LM families past dense against the JAX package: MoE (qwen3-moe,
arctic with its dense residual), RWKV6 (``ssm``), Mamba2 with a shared
attention block (``hybrid``) and the VLM's cross-attention (``vlm``).

Each module and each whole model runs on the same numpy inputs in both
packages, reduced configurations at f32, with the reference's weights
carried across by ``convert.lm_params_from_numpy``. Flash attention runs
the reference's Pallas kernel in interpret mode, as ``test_torch_lm.py``
runs it. Then the reference's own smoke and consistency tests
(``tests/test_models.py``) for the port. Two more files share this one's
configurations and helpers, each on its own xdist worker:
``test_torch_lm_families_long.py`` (the forward at T = 1024) and
``test_torch_lm_families_decode.py`` (decode, caches, greedy tokens).

Tolerances (|delta| <= tol * max(1, max|ref|)):

- LOGIT_TOL = 5e-5 for logits, the MoE aux loss and every module: f32
  on both sides, sums taken in other orders. It holds for the chunked
  RWKV6 and Mamba2 scans too (their exp-of-cumsum factors cost no more
  here): the largest reading on these shapes is 3.3e-6 of max|ref|, the
  zamba2 forward.
- Greedy tokens must be equal.
- Caches after decode: f32 leaves at 1e-4; bf16 KV leaves within one
  bf16 step (BF16_STEP = 2^-7 of the value, + 1e-4), since f32 values a
  few ulp apart may round to neighbouring bf16 values; int8 codes within
  one.

Routing ties: ``torch.topk`` promises no order for equal probabilities,
and ``lax.top_k`` puts the lower index first; the inputs here are normal
draws, so no two routing probabilities tie.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe, rwkv, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402

LOGIT_TOL = 5e-5
# The reference's forward, compiled whole (the configuration is static):
# the same function as its eager form, and far cheaper to run.
_jforward = jax.jit(jtf.forward, static_argnums=0)
FAMILIES = [
    "qwen3-moe-30b-a3b",
    "arctic-480b",
    "rwkv6-7b",
    "zamba2-2.7b",
    "llama-3.2-vision-90b",
]


def _close(t, j, tol=LOGIT_TOL):
    j = np.asarray(j, dtype=np.float32)
    t = t.float().numpy()
    assert t.shape == j.shape
    err = float(np.abs(t - j).max()) if t.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(j).max()))


def _t(x):
    return torch.from_numpy(np.array(x))


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _convert(cfg, jparams):
    arrays = jax.tree.map(np.asarray, jparams)
    return convert.lm_params_from_numpy(cfg, arrays, device="cpu")


# ----------------------------------------------------------------- modules


def _moe_case(drops: bool):
    rng = np.random.default_rng(11)
    d, f, E, k, B, T = 32, 48, 4, 2, 2, 16
    params, _ = jmoe.moe_params(jax.random.PRNGKey(3), d, f, E)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    if drops:
        # a shared direction the router reads on expert 0 only: every token
        # picks expert 0, which holds C = int(1.25 T k / E) = 10 < T slots
        x = x + 2.0
        params = dict(params, router=params["router"].at[:, 0].set(0.5))
    return params, x, E, k, T


@pytest.mark.parametrize("drops", [False, True])
def test_moe_forward_matches_jax(drops):
    jparams, x, E, k, T = _moe_case(drops)
    params = {name: _t(v) for name, v in jparams.items()}
    jout, jaux = jmoe.moe_forward(jparams, jnp.asarray(x), top_k=k)
    out, aux = moe.moe_forward(params, torch.from_numpy(x), top_k=k)
    _close(out, jout)
    _close(aux, jaux)
    _, idx = torch.topk(torch.softmax(torch.from_numpy(x) @ params["router"], -1), k)
    per_expert = torch.nn.functional.one_hot(idx, E).sum(dim=(1, 2))  # (B, E)
    C = moe.capacity(T, k, E)
    assert bool((per_expert > C).any()) == drops
    jout2, _ = jmoe.moe_forward(jparams, jnp.asarray(x), top_k=k, return_aux=False)
    out2, aux2 = moe.moe_forward(params, torch.from_numpy(x), top_k=k, return_aux=False)
    _close(out2, jout2)
    assert float(aux2) == 0.0


def test_moe_drops_leave_the_residual_alone():
    """Top-1 routing with every token on expert 0: the tokens past its C
    slots (the later ones, by the stable sort) combine with gate 0, so
    their rows are exactly zero and the block's residual carries them."""
    jparams, x, E, _, T = _moe_case(True)
    params = {name: _t(v) for name, v in jparams.items()}
    out, _ = moe.moe_forward(params, torch.from_numpy(x), top_k=1)
    jout, _ = jmoe.moe_forward(jparams, jnp.asarray(x), top_k=1)
    C = moe.capacity(T, 1, E)
    assert C < T
    assert bool((out[:, C:] == 0).all()) and bool((out[:, :C] != 0).any(-1).all())
    _close(out, jout)


def _rwkv_params(d, d_ff, hd, seed):
    p, _ = jrwkv.rwkv6_params(jax.random.PRNGKey(seed), d, d_ff, head_dim=hd)
    rng = np.random.default_rng(seed)
    # the reference's zero bonus u and flat lerps carried nonzero and uneven
    p["u"] = jnp.asarray(_normal(rng, p["u"].shape) * 0.5)
    p["mu"] = jnp.asarray(rng.uniform(0.2, 0.8, p["mu"].shape).astype(np.float32))
    return p, {name: _t(v) for name, v in p.items()}


def test_rwkv6_modules_match_jax():
    d, T, B, hd = 64, 16, 2, 32
    jp, p = _rwkv_params(d, 128, hd, 3)
    x = np.random.default_rng(4).standard_normal((B, T, d)).astype(np.float32) * 0.5
    jfull = jrwkv.time_mix_forward(jp, jnp.asarray(x), head_dim=hd, chunk=4)
    _close(rwkv.time_mix_forward(p, torch.from_numpy(x), head_dim=hd, chunk=4), jfull)
    jst = jrwkv.rwkv6_init_state(B, d, head_dim=hd)[:2]
    st = rwkv.rwkv6_init_state(B, d, head_dim=hd)[:2]
    for t in range(3):
        xt = x[:, t : t + 1]
        jo, jst = jrwkv.time_mix_decode(jp, jnp.asarray(xt), jst, head_dim=hd)
        o, st = rwkv.time_mix_decode(p, torch.from_numpy(xt), st, head_dim=hd)
        _close(o, jo)
        _close(st[0], jst[0])
    jcm, _ = jrwkv.channel_mix(jp, jnp.asarray(x))
    _close(rwkv.channel_mix(p, torch.from_numpy(x))[0], jcm)
    last = x[:, :1] * 0.3
    jcm1, _ = jrwkv.channel_mix(jp, jnp.asarray(x[:, 1:2]), jnp.asarray(last))
    cm1, _ = rwkv.channel_mix(p, torch.from_numpy(x[:, 1:2]), torch.from_numpy(last))
    _close(cm1, jcm1)


def _mamba_params(d, N, hd, seed):
    p, _ = jssm.mamba2_params(jax.random.PRNGKey(seed), d, d_state=N, head_dim=hd)
    rng = np.random.default_rng(seed)
    p["dt_bias"] = jnp.asarray(_normal(rng, p["dt_bias"].shape) * 0.3)
    p["D"] = jnp.asarray(1.0 + _normal(rng, p["D"].shape) * 0.3)
    tree = {name: _t(v) for name, v in p.items() if name != "norm"}
    tree["norm"] = {"scale": _t(p["norm"]["scale"])}
    return p, tree


def test_mamba2_modules_match_jax():
    d, T, B, N, hd = 64, 16, 2, 16, 32
    jp, p = _mamba_params(d, N, hd, 2)
    x = np.random.default_rng(5).standard_normal((B, T, d)).astype(np.float32) * 0.5
    jfull = jssm.mamba2_forward(jp, jnp.asarray(x), d_state=N, head_dim=hd, chunk=4)
    full = ssm.mamba2_forward(p, torch.from_numpy(x), d_state=N, head_dim=hd, chunk=4)
    _close(full, jfull)
    jst = jssm.mamba2_init_state(B, d, d_state=N, head_dim=hd)
    st = ssm.mamba2_init_state(B, d, d_state=N, head_dim=hd)
    for t in range(3):
        xt = x[:, t : t + 1]
        jo, jst = jssm.mamba2_decode(jp, jnp.asarray(xt), jst, d_state=N, head_dim=hd)
        o, st = ssm.mamba2_decode(p, torch.from_numpy(xt), st, d_state=N, head_dim=hd)
        _close(o, jo)
        _close(st[0], jst[0])
        _close(st[1], jst[1])


def test_cross_attention_matches_jax():
    d, H, Hkv, hd, B, T, N = 64, 4, 2, 16, 2, 8, 12
    jp, _ = jattn.cross_attention_params(jax.random.PRNGKey(6), d, H, Hkv, hd)
    p = {name: _t(v) for name, v in jp.items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    ctx = rng.standard_normal((B, N, d)).astype(np.float32)
    opts = dict(n_heads=H, n_kv=Hkv, head_dim=hd)
    jout = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(ctx), **opts)
    out = attn.cross_attention(p, torch.from_numpy(x), torch.from_numpy(ctx), **opts)
    _close(out, jout)


# ------------------------------------------------------------ whole models


def _carry_nonzero(jcfg, jparams):
    """The reference's zero-initialised leaves that a test would not see
    carried (RWKV6's ``u``) made nonzero."""
    if jcfg.family == "ssm":
        rng = np.random.default_rng(8)
        u = jparams["layers"]["u"]
        jparams["layers"]["u"] = jnp.asarray(_normal(rng, u.shape) * 0.3)
    return jparams


@functools.lru_cache(maxsize=None)
def _models(name):
    """(jax cfg, jax params, port cfg, port params, image embeds or None)
    for one reduced configuration at f32, built once a process."""
    jcfg = dataclasses.replace(JARCHS[name].reduced(), dtype="float32")
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    jparams = _carry_nonzero(jcfg, jparams)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    params = _convert(cfg, jparams)
    img = None
    if cfg.family == "vlm":
        img = _normal(np.random.default_rng(9), (2, cfg.n_image_tokens, cfg.d_model))
    return jcfg, jparams, cfg, params, img


def _kinds(name):
    """The cache kinds a family allows: RWKV6 its state; the others an f32
    and a bf16 KV cache, the int8 setting (an int8 cache for MoE; hybrid
    and vlm keep a KV pair under it, as the reference's ``kv()``) and the
    ``MacState``."""
    if ARCHS[name].family == "ssm":
        return ["state"]
    return ["bf16", "f32", "int8", "maclaurin"]


CACHE_CASES = [(name, kind) for name in FAMILIES for kind in _kinds(name)]


def _tokens(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _img(img, B):
    if img is None:
        return None, None
    return jnp.asarray(img[:B]), torch.from_numpy(img[:B])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _paths(value, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("name", FAMILIES)
def test_converted_parameters_are_the_references(name):
    jcfg, jparams, cfg, params, _ = _models(name)
    want = {}
    for path, leaf in _paths(jparams):
        want[path] = leaf.shape
    got = {}
    for path, p in params.named_parameters():
        parts = path.split(".")
        if parts[0] in ("layers", "cross_layers"):
            path = ".".join([parts[0]] + parts[2:])
            shape = (len(getattr(params, parts[0])),) + tuple(p.shape)
        else:
            shape = tuple(p.shape)
        assert got.setdefault(path, shape) == shape
    assert got == want
    n = sum(p.numel() for p in params.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(jparams))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_parameter_count_matches_the_reference(name):
    """Every configuration builds, with the reference's leaf count."""
    cfg = ARCHS[name].reduced()
    params = tf.init_params(cfg, device="cpu")
    jcfg = JARCHS[name].reduced()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k)[0], key)
    assert sum(p.numel() for p in params.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)
    )


FORWARD_CASES = [
    ("softmax", "blockwise"),
    ("softmax", "flash"),
    ("maclaurin", "blockwise"),  # from T = 1024 the chunked branch (B8's twin)
]
# RWKV6 has no attention: it runs its one stack at each T.
FORWARD_PARAMS = [
    (name, *case)
    for name in FAMILIES
    for case in FORWARD_CASES
    if ARCHS[name].family != "ssm" or case == ("softmax", "blockwise")
]


def check_forward(name, backend, impl, T):
    """Logits and the aux loss through ``forward`` and
    ``make_prefill_step`` against the reference's."""
    jcfg, jparams, cfg, params, img = _models(name)
    jc = dataclasses.replace(jcfg.with_backend(backend), attention_impl=impl)
    c = dataclasses.replace(cfg.with_backend(backend), attention_impl=impl)
    B = 2 if T == 64 else 1
    tokens = _tokens(cfg, B, T)
    jimg, timg = _img(img, B)
    jlogits, jaux = _jforward(jc, jparams, jnp.asarray(tokens), jimg)
    logits, aux = tf.forward(c, params, torch.from_numpy(tokens), timg)
    assert logits.dtype == torch.float32
    _close(logits, jlogits)
    _close(aux, jaux)
    step = ds.make_prefill_step(c)
    again = step(params, torch.from_numpy(tokens), *(() if timg is None else (timg,)))
    assert torch.equal(again, logits)


@pytest.mark.parametrize("name,backend,impl", FORWARD_PARAMS)
def test_forward_matches_jax(name, backend, impl):
    """T = 64 (T = 1024: ``test_torch_lm_families_long.py``)."""
    check_forward(name, backend, impl, 64)


def _plain(spec):
    if isinstance(spec, dict):
        return {k: _plain(v) for k, v in spec.items()}
    if hasattr(spec, "_fields"):
        return (type(spec).__name__, spec._fields, tuple(spec))
    return spec


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("variant", ["softmax", "int8", "maclaurin"])
def test_cache_spec_matches_jax(name, variant):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    if variant == "maclaurin":
        cfg, jcfg = cfg.with_backend("maclaurin"), jcfg.with_backend("maclaurin")
    elif variant == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    assert _plain(tf.cache_spec(cfg)) == _plain(jtf.cache_spec(jcfg))


# ----------------------------------------- the reference's own smoke tests


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_smoke_forward_and_decode(name):
    """``tests/test_models.py``'s smoke for the port: one forward and one
    decode step of each reduced configuration, shapes and finiteness, the
    cache's structure kept."""
    cfg = ARCHS[name].reduced()
    params = tf.init_params(cfg, device="cpu")
    B, T = 2, 32
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
    img = None
    if cfg.family == "vlm":
        img = torch.randn((B, cfg.n_image_tokens, cfg.d_model), generator=gen)
    logits, aux = tf.forward(cfg, params, tokens, img)
    assert logits.shape == (B, T, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    cache = tf.init_cache(
        cfg, B, 64, image_embeds=img, params=params, dtype=torch.float32, device="cpu"
    )
    shapes = [tuple(t.shape) for t in tf._tensors(cache)]
    lg, cache2 = tf.decode(cfg, params, tokens[:, :1], 0, cache, img)
    assert lg.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(lg).all())
    assert [tuple(t.shape) for t in tf._tensors(cache2)] == shapes


def test_mamba2_decode_matches_forward():
    gen = torch.Generator().manual_seed(2)
    d, T, B = 64, 12, 2
    p = ssm.Mamba2(d, gen, "cpu", d_state=16, head_dim=32).tensors()
    x = torch.randn((B, T, d), generator=gen) * 0.5
    full = ssm.mamba2_forward(p, x, d_state=16, head_dim=32, chunk=4)
    state = ssm.mamba2_init_state(B, d, d_state=16, head_dim=32)
    outs = []
    for t in range(T):
        o, state = ssm.mamba2_decode(p, x[:, t : t + 1], state, d_state=16, head_dim=32)
        outs.append(o)
    seq = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(seq, full.numpy(), rtol=2e-3, atol=2e-3)


def test_rwkv6_decode_matches_forward():
    gen = torch.Generator().manual_seed(3)
    d, T, B = 64, 8, 2
    p = rwkv.RWKV6(d, 128, gen, "cpu", head_dim=32).tensors()
    x = torch.randn((B, T, d), generator=gen) * 0.5
    full = rwkv.time_mix_forward(p, x, head_dim=32, chunk=4)
    S, x_tm, _ = rwkv.rwkv6_init_state(B, d, head_dim=32)
    st, outs = (S, x_tm), []
    for t in range(T):
        o, st = rwkv.time_mix_decode(p, x[:, t : t + 1], st, head_dim=32)
        outs.append(o)
    seq = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(seq, full.numpy(), rtol=2e-3, atol=2e-3)


def test_rwkv6_channel_mix_shift_consistency():
    gen = torch.Generator().manual_seed(4)
    d, T, B = 32, 6, 1
    p = rwkv.RWKV6(d, 64, gen, "cpu", head_dim=16).tensors()
    x = torch.randn((B, T, d), generator=gen)
    full, _ = rwkv.channel_mix(p, x)
    last, outs = torch.zeros((B, 1, d)), []
    for t in range(T):
        o, last = rwkv.channel_mix(p, x[:, t : t + 1], last)
        outs.append(o)
    seq = torch.cat(outs, 1).numpy()
    np.testing.assert_allclose(seq, full.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-2.7b"])
def test_stateful_decode_matches_the_forward(name):
    """Token-by-token decode of a whole stateful model reproduces its
    forward (the reference's 2e-2), and its state bytes do not grow with
    the context."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    params = tf.init_params(cfg, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 1, 16, seed=6))
    full, _ = tf.forward(cfg, params, tokens)
    for c in (cfg, cfg.with_backend("maclaurin")):
        cache = tf.init_cache(c, 1, 16, dtype=torch.float32, device="cpu")
        steps = []
        for t in range(16):
            steps.append(tf.decode(c, params, tokens[:, t : t + 1], t, cache)[0])
        dec = torch.cat(steps, 1)
        ref = full if c is cfg else tf.forward(c, params, tokens)[0]
        assert float((dec - ref).abs().max()) <= 2e-2 * max(1.0, float(ref.abs().max()))
    mac_cfg = cfg.with_backend("maclaurin")
    small = tf.cache_bytes(tf.init_cache(mac_cfg, 1, 16, device="cpu"))
    assert small == tf.cache_bytes(tf.init_cache(mac_cfg, 1, 1 << 16, device="cpu"))


def test_refusals_match_the_reference():
    """A VLM forward without image embeddings, and a scan whose T is not a
    multiple of its chunk, are refused (the reference asserts)."""
    cfg = get_config("llama-3.2-vision-90b").reduced()
    params = tf.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="image_embeds"):
        tf.forward(cfg, params, torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="image_embeds"):
        tf.init_cache(cfg, 1, 4, device="cpu")
    for name in ("rwkv6-7b", "zamba2-2.7b"):
        c = get_config(name).reduced()
        with pytest.raises(ValueError, match="chunk"):
            tokens = torch.zeros((1, c.scan_chunk + 1), dtype=torch.int64)
            tf.forward(c, tf.init_params(c, device="cpu"), tokens)
