"""The LM families past dense on the card, held against the port's CPU
twins: each reduced configuration's prefill with kernels B9 (flash) and B8
(maclaurin, from T = 1024) launched once per self-attention application,
and its decode through every cache kind it allows; arctic's dense
residual beside its experts included.

The same f32 weights run on both devices (TF32 off). Tolerance: logits
within CARD_TOL of the CPU's, relative to max(1, max|logit|): B8 and B9
compute f32 products in 3xTF32, and the card's other products and sums
run in other orders. Marked ``cuda``; each test skips inside its body
where no card is present. On a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_families_cuda.py
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402

pytestmark = pytest.mark.cuda

CARD_TOL = 1e-4
PREFILL_REL = 0.04  # chip_smoke.py's PREFILL_REL
MOE_SHARE, MOE_F32_SHARE = 0.9, 0.99
FAMILIES = [
    "qwen3-moe-30b-a3b",
    "arctic-480b",
    "rwkv6-7b",
    "zamba2-2.7b",
    "llama-3.2-vision-90b",
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(card, cpu, tol=CARD_TOL):
    card, cpu = card.float().cpu(), cpu.float()
    assert card.shape == cpu.shape
    assert bool(torch.isfinite(card).all())
    err = float((card - cpu).abs().max())
    assert err <= tol * max(1.0, float(cpu.abs().max())), err


def _setup(name, dev, **changes):
    changes = {"dtype": "float32", **changes}
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    params = tf.init_params(cfg, seed=1, device="cpu")
    return cfg, params, copy.deepcopy(params).to(dev)


def _inputs(cfg, B, T, seed=0):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
    img = None
    if cfg.family == "vlm":
        img = torch.randn((B, cfg.n_image_tokens, cfg.d_model), generator=gen)
    return tokens, img


def _attention_layers(cfg) -> int:
    """Self-attention applications in one forward."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "vlm":
        return tf.vlm_layout(cfg)[1]
    return cfg.n_layers


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize(
    "backend,impl,T,kernel",
    [
        ("softmax", "flash", 64, "flash_attention"),
        ("softmax", "flash", 1024, "flash_attention"),
        ("maclaurin", "blockwise", 1024, "maclaurin_attention"),
    ],
)
def test_prefill_on_the_card_matches_the_cpu(cuda, name, backend, impl, T, kernel):
    changes = dict(attention_backend=backend, attention_impl=impl)
    cfg, params, params_d = _setup(name, cuda, **changes)
    B = 2 if T == 64 else 1
    tokens, img = _inputs(cfg, B, T)
    extra = () if img is None else (img,)
    want, want_aux = tf.forward(cfg, params, tokens, *extra)
    build.reset_counts()
    got, aux = tf.forward(cfg, params_d, tokens.to(cuda), *(x.to(cuda) for x in extra))
    torch.cuda.synchronize()
    launches = build.counts()
    _close(got, want)
    _close(aux, want_aux)
    assert launches[kernel] == _attention_layers(cfg)
    assert sum(launches.values()) == launches[kernel]


def _kinds(name):
    if get_config(name).family == "ssm":
        return ["state"]
    return ["f32", "bf16", "int8", "maclaurin"]


@pytest.mark.parametrize("name,kind", [(n, k) for n in FAMILIES for k in _kinds(n)])
def test_decode_on_the_card_matches_the_cpu(cuda, name, kind):
    """Six steps through ``make_serve_step`` on each device, then four
    greedy tokens from the filled caches, equal on both."""
    changes = {}
    if kind == "maclaurin":
        changes["attention_backend"] = "maclaurin"
    if kind == "int8":
        changes["kv_cache_dtype"] = "int8"
    cfg, params, params_d = _setup(name, cuda, **changes)
    dtype = torch.float32 if kind in ("f32", "state", "maclaurin") else torch.bfloat16
    tokens, img = _inputs(cfg, 2, 6, seed=3)
    img_d = None if img is None else img.to(cuda)
    cache = tf.init_cache(
        cfg, 2, 16, image_embeds=img, params=params, dtype=dtype, device="cpu"
    )
    cache_d = tf.init_cache(
        cfg, 2, 16, image_embeds=img_d, params=params_d, dtype=dtype, device=cuda
    )
    step = ds.make_serve_step(cfg)
    extra, extra_d = ((img,), (img_d,)) if img is not None else ((), ())
    build.reset_counts()
    for t in range(6):
        tok = tokens[:, t : t + 1]
        want, cache = step(params, tok, t, cache, *extra)
        got, cache_d = step(params_d, tok.to(cuda), t, cache_d, *extra_d)
        _close(got, want, CARD_TOL if dtype == torch.float32 else 1e-2)
    assert sum(build.counts().values()) == 0  # decode runs no kernel
    assert tf.cache_bytes(cache_d) == tf.cache_bytes(cache)
    want_toks, _ = ds.greedy_generate(
        cfg, params, tokens[:, -1:], cache, steps=4, start_pos=6, image_embeds=img
    )
    last = tokens[:, -1:].to(cuda)
    got_toks, _ = ds.greedy_generate(
        cfg, params_d, last, cache_d, steps=4, start_pos=6, image_embeds=img_d
    )
    np.testing.assert_array_equal(got_toks.cpu().numpy(), want_toks.numpy())


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_prefill_on_the_card(cuda, name):
    """At bf16, flash (B9) against blockwise on the card, at path 4's rule
    (max|delta| within PREFILL_REL of max|logit|), all logits finite. MoE
    routing is a discontinuous function of its input: rounding that differs
    between the two attentions moves a near-tie token to another expert
    (and, through the capacity, may drop a later one), which changes that
    position's logits wholesale. So an MoE is held at the rule on a share
    of its positions: MOE_SHARE at bf16 (the reduced models read
    0.977-0.990 on the CPU), and MOE_F32_SHARE at f32, where the two
    attentions differ by ~1e-6 (chip_smoke.py's full-width MoE read one
    position of 8192 off)."""
    cfg, _, params_d = _setup(name, cuda, dtype="bfloat16")
    tokens, img = _inputs(cfg, 2, 256, seed=5)
    extra = () if img is None else (img.to(cuda),)
    tokens = tokens.to(cuda)
    moe = bool(cfg.moe_num_experts)
    for dtype in ("bfloat16", "float32") if moe else ("bfloat16",):
        c = dataclasses.replace(cfg, dtype=dtype)
        flash_cfg = dataclasses.replace(c, attention_impl="flash")
        flash, _ = tf.forward(flash_cfg, params_d, tokens, *extra)
        block, _ = tf.forward(c, params_d, tokens, *extra)
        assert bool(torch.isfinite(flash).all()) and bool(torch.isfinite(block).all())
        err = (flash.float() - block.float()).abs().amax(-1)
        within = err <= PREFILL_REL * float(block.float().abs().max())
        share = 1.0
        if moe:
            share = MOE_SHARE if dtype == "bfloat16" else MOE_F32_SHARE
        assert float(within.float().mean()) >= share


def test_arctic_dense_residual_on_the_card(cuda):
    """Arctic's layer runs its dense FFN beside the experts on the card as
    on the CPU; without the dense branch the logits move."""
    cfg, params, params_d = _setup("arctic-480b", cuda)
    assert cfg.moe_dense_residual and hasattr(params_d.layers[0], "ffn")
    tokens, _ = _inputs(cfg, 2, 32, seed=7)
    want, _ = tf.forward(cfg, params, tokens)
    got, _ = tf.forward(cfg, params_d, tokens.to(cuda))
    _close(got, want)
    with torch.no_grad():
        for layer in params_d.layers:
            layer.ffn.w_down.zero_()
    dropped, _ = tf.forward(cfg, params_d, tokens.to(cuda))
    moved = float((dropped.cpu() - want).abs().max())
    assert moved > 100 * CARD_TOL * float(want.abs().max())
