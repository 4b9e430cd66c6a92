"""The LM families past dense against the JAX package, part 3: ``decode``
through every cache kind each family allows (and the caches after it),
``init_cache``'s leaves, ``greedy_generate`` tokens, and bf16 decode over
the f32 states, for the reduced qwen3-moe, arctic, rwkv6, zamba2 and
llama-3.2-vision. The configurations, weights, helpers and tolerances
are ``test_torch_lm_families.py``'s (see its docstring); this file runs
on its own xdist worker.
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
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402
from test_torch_lm_families import (  # noqa: E402
    CACHE_CASES,
    FAMILIES,
    _close,
    _convert,
    _img,
    _models,
    _normal,
    _tokens,
)

BF16_STEP = 2.0**-7  # a bf16 cache value's step, relative to the value
# The reference's decode, compiled whole (the configuration is static).
_jdecode = jax.jit(jtf.decode, static_argnums=0)


def _cache_cfgs(cfg, jcfg, kind):
    if kind == "maclaurin":
        return cfg.with_backend("maclaurin"), jcfg.with_backend("maclaurin")
    if kind == "int8":
        # hybrid and vlm keep a KV pair under int8, as the reference's kv()
        return (
            dataclasses.replace(cfg, kv_cache_dtype="int8"),
            dataclasses.replace(jcfg, kv_cache_dtype="int8"),
        )
    return cfg, jcfg


def _caches(cfg, jcfg, kind, B, S, params, jparams, img):
    cfg, jcfg = _cache_cfgs(cfg, jcfg, kind)
    f32 = kind == "f32"
    dtype = torch.float32 if f32 else torch.bfloat16
    jdtype = jnp.float32 if f32 else jnp.bfloat16
    jimg, timg = _img(img, B)
    cache = tf.init_cache(
        cfg, B, S, image_embeds=timg, params=params, dtype=dtype, device="cpu"
    )
    jcache = jtf.init_cache(jcfg, B, S, image_embeds=jimg, params=jparams, dtype=jdtype)
    return cfg, jcfg, cache, jcache


def _pairs(tree, jtree):
    """(port leaf, reference leaf) of one cache, matched by key and index."""
    if isinstance(tree, torch.Tensor):
        yield tree, jtree
    elif isinstance(tree, dict):
        assert sorted(tree) == sorted(jtree)
        for key in tree:
            yield from _pairs(tree[key], jtree[key])
    else:
        assert type(tree).__name__ == type(jtree).__name__ and len(tree) == len(jtree)
        for a, b in zip(tree, jtree):
            yield from _pairs(a, b)


@pytest.mark.parametrize("name,kind", CACHE_CASES)
def test_decode_matches_jax(name, kind):
    """Three decode steps through ``make_serve_step``, each against the
    reference's, and the caches after them."""
    jcfg, jparams, cfg, params, img = _models(name)
    cfg, jcfg, cache, jcache = _caches(cfg, jcfg, kind, 2, 16, params, jparams, img)
    jimg, timg = _img(img, 2)
    extra, jextra = ((timg,), (jimg,)) if cfg.family == "vlm" else ((), ())
    tokens = _tokens(cfg, 2, 3, seed=4)
    step = ds.make_serve_step(cfg)
    for t in range(3):
        tok = tokens[:, t : t + 1]
        jtok = jnp.asarray(tok)
        jlogits, jcache = _jdecode(jcfg, jparams, jtok, jnp.int32(t), jcache, *jextra)
        logits, cache = step(params, torch.from_numpy(tok), t, cache, *extra)
        assert logits.shape == (2, 1, cfg.vocab_size)
        _close(logits, jlogits)
    for leaf, jleaf in _pairs(cache, jcache):
        jleaf = np.asarray(jleaf.astype(jnp.float32))
        if leaf.dtype == torch.int8:
            # round-half-even of values computed in another order
            assert int(np.abs(leaf.float().numpy() - jleaf).max()) <= 1
        elif leaf.dtype == torch.bfloat16:
            # f32 values a few ulp apart may round to neighbouring bf16
            # values: one bf16 step, 2^-7 of the value, apart at most
            err = np.abs(leaf.float().numpy() - jleaf)
            assert bool((err <= BF16_STEP * np.abs(jleaf) + 1e-4).all())
        else:
            _close(leaf.float(), jleaf, 1e-4)


@pytest.mark.parametrize("name,kind", CACHE_CASES)
def test_init_cache_matches_jax(name, kind):
    """Leaf shapes, dtypes (and the VLM's precomputed image context) of
    every cache kind the family allows."""
    jcfg, jparams, cfg, params, img = _models(name)
    _, _, cache, jcache = _caches(cfg, jcfg, kind, 2, 16, params, jparams, img)
    for leaf, jleaf in _pairs(cache, jcache):
        assert tuple(leaf.shape) == tuple(jleaf.shape)
        assert str(leaf.dtype).removeprefix("torch.") == str(jleaf.dtype)
        if leaf.dtype != torch.bfloat16:
            _close(leaf.float(), np.asarray(jleaf.astype(jnp.float32)), 1e-4)
    assert tf.cache_bytes(cache) == sum(x.nbytes for x in jax.tree.leaves(jcache))


GENERATE_PARAMS = [
    (name, backend)
    for name in FAMILIES
    for backend in ("softmax", "maclaurin")
    if ARCHS[name].family != "ssm" or backend == "softmax"
]


@pytest.mark.parametrize("name,backend", GENERATE_PARAMS)
def test_greedy_generate_matches_jax(name, backend):
    jcfg, jparams, cfg, params, img = _models(name)
    jc, c = jcfg.with_backend(backend), cfg.with_backend(backend)
    prompt = _tokens(cfg, 2, 4, seed=5)
    jimg, timg = _img(img, 2)
    jcache = jtf.init_cache(
        jc, 2, 32, image_embeds=jimg, params=jparams, dtype=jnp.float32
    )
    jprompt = jnp.asarray(prompt)
    jtoks, _ = jds.greedy_generate(
        jc, jparams, jprompt, jcache, steps=8, start_pos=2, image_embeds=jimg
    )
    cache = tf.init_cache(
        c, 2, 32, image_embeds=timg, params=params, dtype=torch.float32, device="cpu"
    )
    prompt = torch.from_numpy(prompt)
    toks, _ = ds.greedy_generate(
        c, params, prompt, cache, steps=8, start_pos=2, image_embeds=timg
    )
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


@pytest.mark.parametrize(
    "name", ["rwkv6-7b", "zamba2-2.7b", "llama-3.2-vision-90b", "qwen3-moe-30b-a3b"]
)
def test_bf16_decode_promotes_as_the_reference(name):
    """A bf16 model over f32 states (the stateful families store them f32)
    decodes without a dtype clash and matches the reference at bf16's
    resolution."""
    jcfg = JARCHS[name].reduced()  # reduced() is f32; run it at bf16
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    params = _convert(cfg, jparams)
    img = _normal(np.random.default_rng(2), (1, cfg.n_image_tokens, cfg.d_model))
    jimg, timg = _img(img if cfg.family == "vlm" else None, 1)
    cache = tf.init_cache(cfg, 1, 8, image_embeds=timg, params=params, device="cpu")
    jcache = jtf.init_cache(jcfg, 1, 8, image_embeds=jimg, params=jparams)
    tokens = _tokens(cfg, 1, 2, seed=3)
    for t in range(2):
        tok = tokens[:, t : t + 1]
        jtok = jnp.asarray(tok)
        jlogits, jcache = _jdecode(jcfg, jparams, jtok, jnp.int32(t), jcache)
        logits, cache = tf.decode(cfg, params, torch.from_numpy(tok), t, cache)
        assert logits.dtype == torch.bfloat16
        _close(logits, np.asarray(jlogits.astype(jnp.float32)), 0.05)
