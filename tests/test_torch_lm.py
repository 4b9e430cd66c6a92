"""The port's LM serving path against the JAX package: ``forward``,
``decode`` with each cache kind and ``greedy_generate`` of the reduced
``smollm-135m`` and ``qwen2-0.5b`` at f32, with the reference's weights
carried across by ``convert.lm_params_from_numpy``.

Tolerance: logits within LOGIT_TOL of the reference's, relative to
max(1, max|logit|): f32 on both sides through two layers, sums taken in
other orders (each attention path, the blockwise chunks and the
Maclaurin moments round differently), so a few hundred ulp of the
largest logit. Greedy tokens must be equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import decode_step as jds  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402

LOGIT_TOL = 5e-5
NAMES = ["smollm-135m", "qwen2-0.5b"]


def _close(t, j, tol=LOGIT_TOL):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape
    assert float(np.abs(t - j).max()) <= tol * max(1.0, float(np.abs(j).max()))


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    """(jax cfg, jax params, port cfg, port params) for one reduced config
    at f32. The reference's zero QKV biases are made nonzero so that they
    are carried and used."""
    name = request.param
    jcfg = dataclasses.replace(JARCHS[name].reduced(), dtype="float32")
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(1)
        attn = jparams["layers"]["attn"]
        for key in ("b_q", "b_k", "b_v"):
            attn[key] = jnp.asarray(rng.standard_normal(attn[key].shape).astype(np.float32) * 0.1)
    arrays = jax.tree.map(np.asarray, jparams)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    return jcfg, jparams, cfg, convert.lm_params_from_numpy(cfg, arrays, device="cpu")


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def test_configs_match_the_reference():
    assert sorted(ARCHS) == sorted(JARCHS)
    for name, jc in JARCHS.items():
        c = ARCHS[name]
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert dataclasses.asdict(c.reduced()) == dataclasses.asdict(jc.reduced())
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()


def test_converted_parameters_are_the_references(models):
    jcfg, jparams, cfg, params = models
    assert params.layers[1].attn.w_q.shape == (cfg.d_model, cfg.n_heads * cfg.hd)
    np.testing.assert_array_equal(
        params.layers[1].ffn.w_down.numpy(), np.asarray(jparams["layers"]["ffn"]["w_down"][1])
    )
    n = sum(p.numel() for p in params.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(jparams))


@pytest.mark.parametrize(
    "backend,impl,T",
    [
        ("softmax", "blockwise", 64),
        ("softmax", "flash", 64),
        ("maclaurin", "blockwise", 64),
        ("maclaurin", "blockwise", 1024),  # the chunked branch (B8's twin)
    ],
)
def test_forward_matches_jax(models, backend, impl, T):
    jcfg, jparams, cfg, params = models
    jc = dataclasses.replace(jcfg.with_backend(backend), attention_impl=impl)
    c = dataclasses.replace(cfg.with_backend(backend), attention_impl=impl)
    B = 2 if T == 64 else 1
    tokens = _tokens(cfg, B, T)
    jlogits, _ = jtf.forward(jc, jparams, jnp.asarray(tokens))
    logits = ds.make_prefill_step(c)(params, torch.from_numpy(tokens))
    assert logits.dtype == torch.float32
    _close(logits, jlogits)


def test_audio_family_forward_matches_jax():
    """musicgen-medium (the ``audio`` family, MHA) runs the dense stack."""
    jcfg = dataclasses.replace(JARCHS["musicgen-medium"].reduced(), dtype="float32")
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    cfg = dataclasses.replace(get_config("musicgen-medium").reduced(), dtype="float32")
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = _tokens(cfg, 2, 16, seed=7)
    jlogits = jds.make_prefill_step(jcfg)(jparams, jnp.asarray(tokens))
    _close(ds.make_prefill_step(cfg)(params, torch.from_numpy(tokens)), jlogits)


def test_blockwise_chunks_above_512(models):
    """T = 1024 runs the blockwise path in two 512-row query chunks."""
    jcfg, jparams, cfg, params = models
    tokens = _tokens(cfg, 1, 1024, seed=3)
    jlogits, _ = jtf.forward(jcfg, jparams, jnp.asarray(tokens))
    _close(tf.forward(cfg, params, torch.from_numpy(tokens))[0], jlogits)


def _caches(cfg, jcfg, kind, B, S):
    if kind == "maclaurin":
        cfg, jcfg = cfg.with_backend("maclaurin"), jcfg.with_backend("maclaurin")
    elif kind == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    cache = tf.init_cache(cfg, B, S, device="cpu")
    jcache = jtf.init_cache(jcfg, B, S)
    return cfg, jcfg, cache, jcache


@pytest.mark.parametrize("kind", ["bf16", "int8", "maclaurin"])
def test_decode_matches_jax(models, kind):
    """Three decode steps, each against the reference's, and the caches
    after them."""
    jcfg, jparams, cfg, params = models
    cfg, jcfg, cache, jcache = _caches(cfg, jcfg, kind, B=2, S=16)
    tokens = _tokens(cfg, 2, 3, seed=4)
    for t in range(3):
        tok = tokens[:, t : t + 1]
        jlogits, jcache = jtf.decode(jcfg, jparams, jnp.asarray(tok), jnp.int32(t), jcache)
        logits, cache = ds.make_serve_step(cfg)(params, torch.from_numpy(tok), t, cache)
        assert logits.shape == (2, 1, cfg.vocab_size)
        _close(logits, jlogits)
    for leaf, jleaf in zip(cache["kv"], jax.tree.leaves(jcache["kv"])):
        jleaf = np.asarray(jleaf.astype(jnp.float32))
        if kind == "int8" and leaf.dtype == torch.int8:
            # round-half-even of values computed in another order: a code
            # may differ by one where a value sits on a rounding boundary
            assert int((leaf.float().numpy() - jleaf).__abs__().max()) <= 1
        else:
            _close(leaf.float(), jleaf, 1e-4)


@pytest.mark.parametrize("backend", ["softmax", "maclaurin"])
def test_greedy_generate_matches_jax(models, backend):
    jcfg, jparams, cfg, params = models
    jc, c = jcfg.with_backend(backend), cfg.with_backend(backend)
    prompt = _tokens(cfg, 2, 4, seed=5)
    jcache = jtf.init_cache(jc, 2, 32, dtype=jnp.float32)
    jtoks, _ = jds.greedy_generate(jc, jparams, jnp.asarray(prompt), jcache, steps=8, start_pos=2)
    cache = tf.init_cache(c, 2, 32, dtype=torch.float32, device="cpu")
    toks, _ = ds.greedy_generate(c, params, torch.from_numpy(prompt), cache, steps=8, start_pos=2)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


def test_decode_matches_the_forward():
    """Teacher-forced decode reproduces the forward logits (the reference's
    own consistency check, at its 2e-2) for each cache kind."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), dtype="float32")
    params = tf.init_params(cfg, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, 1, 8, seed=6))
    for kind in ("bf16", "int8", "maclaurin"):
        c = cfg.with_backend("maclaurin") if kind == "maclaurin" else cfg
        if kind == "int8":
            c = dataclasses.replace(c, kv_cache_dtype="int8")
        full, _ = tf.forward(c, params, tokens)
        cache = tf.init_cache(c, 1, 8, device="cpu")
        steps = [tf.decode(c, params, tokens[:, t : t + 1], t, cache)[0] for t in range(8)]
        dec = torch.cat(steps, dim=1)
        assert float((dec - full).abs().max()) <= 2e-2 * max(1.0, float(full.abs().max()))
        assert bool((dec.argmax(-1) == full.argmax(-1)).all())


def test_state_bytes_do_not_grow_with_context():
    cfg = get_config("smollm-135m").reduced()
    mac_cfg = cfg.with_backend("maclaurin")
    small = tf.cache_bytes(tf.init_cache(mac_cfg, 2, 128, device="cpu"))
    assert small == tf.cache_bytes(tf.init_cache(mac_cfg, 2, 1 << 19, device="cpu"))
    kv = tf.cache_bytes(tf.init_cache(cfg, 2, 128, device="cpu"))
    assert tf.cache_bytes(tf.init_cache(cfg, 2, 4096, device="cpu")) == 32 * kv


def test_prefill_on_cpu_launches_no_kernel():
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), attention_impl="flash")
    params = tf.init_params(cfg, device="cpu")
    before = build.counts()
    logits = ds.make_prefill_step(cfg)(params, torch.from_numpy(_tokens(cfg, 1, 16)))
    assert logits.shape == (1, 16, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert build.counts() == before
