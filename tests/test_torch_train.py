"""Training on the port against the JAX package, on the CPU.

The optimizers, the schedule, clipping and the int8 compression on the
same trees; one ``train_step`` of AdamW, Adafactor, four microbatches and
compressed gradients from the same weights and batch, the parameters,
state and metrics held against the reference's; then the reference's own
cases (``tests/test_train.py``) rerun on the port. Then the repairs this
training path needed: the forward records a graph once a trainer turns
gradients on, and serving records none (F6); the chunked maclaurin
``Function`` carries the twin's gradient (F7); every kernel wrapper and
both attention ops refuse a gradient instead of dropping it (F8).

Tolerances: optimizer, schedule and compression outputs within OPT_TOL =
1e-6 of max(1, max|ref|) (f32 on both sides; ``pow``/``rsqrt``/``cos``
may differ in the last bit), int8 codes equal. One train step: parameters
and moments within STEP_TOL = 1e-5 of each leaf's max(1, max|ref|)
(gradients 2e-6 of max|grad| apart, ``test_torch_train_families.py``,
divided by sqrt(v) in the first AdamW step), metrics within 1e-5. With
compressed gradients, up to COMPRESS_FLIPS = 2 elements a leaf may differ
by more: a gradient entry within rounding of a half-code boundary takes
the neighbouring int8 code in one package (one code step, max|g|/127,
moved between the gradient and the error feedback); on these inputs one
element of ``w_k`` and one of ``lm_head`` do, every other element agrees
within 1e-7.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.kernels.flash_attn import flash_attention as j_flash  # noqa: E402
from repro.kernels.maclaurin_attn import maclaurin_attention as j_mac  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data.loader import lm_token_batches  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as fa  # noqa: E402
from repro_torch.kernels.fwht import kernel as ff  # noqa: E402
from repro_torch.kernels.maclaurin_attn import maclaurin_attention  # noqa: E402
from repro_torch.kernels.maclaurin_attn import kernel as ma  # noqa: E402
from repro_torch.kernels.quadform import kernel as qf  # noqa: E402
from repro_torch.kernels.rbf_pred import kernel as rp  # noqa: E402
from repro_torch.kernels.rff_score import kernel as rf  # noqa: E402
from repro_torch.models import maclaurin_attention as mac  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import decode_step as ds  # noqa: E402
from repro_torch.train import compression  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.train.train_step import (  # noqa: E402
    OptimizerConfig,
    init_opt_state,
    make_eval_step,
    make_train_step,
)

OPT_TOL = 1e-6
STEP_TOL = 1e-5
COMPRESS_FLIPS = 2


def _close(t, j, tol, flips=0):
    """|t - j| <= tol * max(1, max|j|), at all but ``flips`` elements."""
    t = np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape
    over = np.abs(t - j) > tol * max(1.0, float(np.abs(j).max())) if t.size else np.zeros(0)
    assert int(over.sum()) <= flips, (int(over.sum()), float(np.abs(t - j).max()))


def _trees_close(t, j, tol, flips=0):
    jl = jax.tree_util.tree_flatten_with_path(j)[0]
    tl = jax.tree.leaves(convert.opt_state_to_numpy(t))
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        assert np.asarray(a).dtype == b.dtype, path
        _close(b, a, tol, flips)


def _tree(rng):
    """A tree with a matrix, a stacked (L, d, f) leaf, a vector and a scalar."""
    return {
        "w": rng.standard_normal((6, 5)).astype(np.float32),
        "layers": {"w_up": rng.standard_normal((3, 4, 7)).astype(np.float32)},
        "scale": rng.standard_normal((5,)).astype(np.float32),
        "bias": np.float32(rng.standard_normal()),
    }


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return convert.opt_state_from_numpy(tree, device="cpu")


def _tiny_cfg(arch=ARCHS, **changes):
    return dataclasses.replace(
        arch["smollm-135m"].reduced(), n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128, **changes,
    )


def _both(cfg_changes=None, seed=1):
    """The tiny configuration in both packages and the reference's weights
    in each."""
    changes = cfg_changes or {}
    jcfg, cfg = _tiny_cfg(JARCHS, **changes), _tiny_cfg(**changes)
    jparams, _ = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    params = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params


# ------------------------------------------------------- optimizer parity


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(name):
    rng = np.random.default_rng(0)
    params, lr = _tree(rng), 0.05
    jinit, jupd = (jopt.adamw_init, jopt.adamw_update) if name == "adamw" else (
        jopt.adafactor_init, jopt.adafactor_update)
    init, upd = (adamw_init, adamw_update) if name == "adamw" else (
        adafactor_init, adafactor_update)
    jp, p = _jt(params), _tt(params)
    jst, st = jinit(jp), init(p)
    _trees_close(st, jst, 0.0)
    for _ in range(3):  # bias correction and moments past the first step
        grads = _tree(rng)
        jp, jst = jupd(jp, _jt(grads), jst, lr, weight_decay=0.1)
        p, st = upd(p, _tt(grads), st, lr, weight_decay=0.1)
        _trees_close(p, jp, OPT_TOL)
        _trees_close(st, jst, OPT_TOL)
    assert int(st["count"]) == 3 and st["count"].dtype == torch.int32


def test_schedule_and_clip_match_jax():
    for step in (0, 3, 5, 17, 59, 60, 80):
        j = jopt.cosine_schedule(step, peak_lr=3e-3, warmup=5, total=60)
        t = cosine_schedule(step, peak_lr=3e-3, warmup=5, total=60)
        assert t.dtype == torch.float32
        _close(t, j, OPT_TOL)
    rng = np.random.default_rng(1)
    grads = _tree(rng)
    for max_norm in (0.5, 1e3):  # clipped, and left as it is
        jg, jn = jopt.clip_by_global_norm(_jt(grads), max_norm)
        g, n = clip_by_global_norm(_tt(grads), max_norm)
        _close(n, jn, OPT_TOL)
        _trees_close(g, jg, OPT_TOL)


def test_compression_matches_jax():
    rng = np.random.default_rng(2)
    grads, ef = _tree(rng), jax.tree.map(lambda x: 0.01 * x, _tree(rng))
    grads["w"][0, 0] = 0.5 * np.abs(grads["w"]).max() * 2  # a row at the scale
    for x in jax.tree.leaves(grads):
        jq, js = jcomp._q8(jnp.asarray(x))
        q, s = compression._q8(torch.from_numpy(np.array(x)))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        _close(s, js, OPT_TOL)
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0]) * (127.0 / 127.0)
    q, _ = compression._q8(half)  # scale 1: ties round to even as jnp.round
    np.testing.assert_array_equal(q.numpy(), np.asarray(jcomp._q8(jnp.asarray(half.numpy()))[0]))
    jd, je = jcomp.compress_decompress(_jt(grads), _jt(ef))
    d, e = compression.compress_decompress(_tt(grads), _tt(ef))
    _trees_close(d, jd, OPT_TOL)
    _trees_close(e, je, OPT_TOL)
    assert compression.wire_bytes(_tt(grads)) == jcomp.wire_bytes(_jt(grads))
    params = tf.init_params(_tiny_cfg(), device="cpu")
    assert compression.wire_bytes(params) == sum(p.numel() for p in params.parameters())


# --------------------------------------------------------- one train step


OCFGS = {
    "adamw": OptimizerConfig(peak_lr=1e-3, warmup=2, total_steps=10),
    "adafactor": OptimizerConfig(name="adafactor", peak_lr=1e-3, warmup=2, total_steps=10),
    "microbatches": OptimizerConfig(peak_lr=1e-3, warmup=2, total_steps=10, microbatches=4),
    "compress": OptimizerConfig(peak_lr=1e-3, warmup=2, total_steps=10, compress_grads=True),
}


@pytest.mark.parametrize("case", sorted(OCFGS))
def test_train_step_matches_jax(case):
    ocfg = OCFGS[case]
    jocfg = jts.OptimizerConfig(**dataclasses.asdict(ocfg))
    jcfg, cfg, jparams, params = _both()
    make = lm_token_batches(cfg.vocab_size, batch=8, seq_len=16, seed=3)
    jstep = jax.jit(jts.make_train_step(jcfg, jocfg))
    step = make_train_step(cfg, ocfg)
    jst = jts.init_opt_state(jocfg, jparams)
    st = init_opt_state(ocfg, params, device="cpu")
    _trees_close(st, jst, 0.0)
    for s in (0, 3):  # the warm-up's first step (lr 0) and a later one
        b = make(s)
        jparams, jst, jm = jstep(jparams, jst, _jt(b), jnp.int32(s))
        params, st, m = step(params, st, {k: torch.from_numpy(v) for k, v in b.items()}, s)
    assert set(m) == set(jm) == {"xent", "aux", "loss", "grad_norm", "lr"}
    for key in jm:
        _close(m[key], jm[key], STEP_TOL)
    flips = COMPRESS_FLIPS if ocfg.compress_grads else 0
    _trees_close(params.tree(lambda p: p.detach()), jparams, STEP_TOL, flips)
    _trees_close(st, jst, STEP_TOL, flips)


def test_eval_step_matches_jax():
    jcfg, cfg, jparams, params = _both()
    b = lm_token_batches(cfg.vocab_size, batch=4, seq_len=16, seed=4)(0)
    jm = jts.make_eval_step(jcfg)(jparams, _jt(b))
    m = make_eval_step(cfg)(params, {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "xent", "aux"):
        _close(m[key], jm[key], 5e-6)
    assert m["loss"].grad_fn is None


# ---------------------------------------------- the reference's own cases


def test_loss_decreases():
    cfg = _tiny_cfg()
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup=5, total_steps=60)
    params = tf.init_params(cfg, seed=0, device="cpu")
    state = init_opt_state(ocfg, params, device="cpu")
    step_fn = make_train_step(cfg, ocfg)
    make = lm_token_batches(cfg.vocab_size, batch=8, seq_len=32, seed=1)
    losses = []
    for s in range(40):
        b = {k: torch.from_numpy(v) for k, v in make(s).items()}
        params, state, metrics = step_fn(params, state, b, s)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_microbatch_equivalence():
    """k microbatches of size n/k == one batch of size n (same grads)."""
    cfg = dataclasses.replace(_tiny_cfg(), remat=False, dtype="float32")
    base = OptimizerConfig(peak_lr=1e-3, microbatches=1)
    micro = OptimizerConfig(peak_lr=1e-3, microbatches=4)
    params = tf.init_params(cfg, seed=1, device="cpu")
    p1, p2 = copy.deepcopy(params), copy.deepcopy(params)  # the step updates in place
    b = {k: torch.from_numpy(v) for k, v in lm_token_batches(cfg.vocab_size, 8, 16, seed=2)(0).items()}
    p1, _, _ = make_train_step(cfg, base)(p1, init_opt_state(base, p1, device="cpu"), b, 0)
    p2, _, _ = make_train_step(cfg, micro)(p2, init_opt_state(micro, p2, device="cpu"), b, 0)
    pairs = zip(p1.parameters(), p2.parameters())
    err = max(float((a - c).detach().abs().max()) for a, c in pairs)
    assert err < 5e-3


def test_adamw_reduces_quadratic():
    w = {"w": torch.tensor([5.0, -3.0])}
    st = adamw_init(w)
    for _ in range(200):
        g = {"w": 2 * w["w"]}
        w, st = adamw_update(w, g, st, 0.05, weight_decay=0.0)
    assert float(w["w"].abs().max()) < 0.5


def test_adafactor_reduces_quadratic_matrix():
    w = {"w": torch.ones((8, 4)) * 3.0}
    st = adafactor_init(w)
    for _ in range(300):
        g = {"w": 2 * w["w"]}
        w, st = adafactor_update(w, g, st, 0.05)
    assert float(w["w"].abs().max()) < 0.5
    # factored state is O(n+m), not O(nm)
    assert st["v"]["w"]["vr"].shape == (8,)
    assert st["v"]["w"]["vc"].shape == (4,)


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0])}  # norm 5
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5.0) < 1e-5
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


def test_cosine_schedule_shape():
    lr0 = float(cosine_schedule(0, peak_lr=1.0, warmup=10, total=100))
    lr_peak = float(cosine_schedule(10, peak_lr=1.0, warmup=10, total=100))
    lr_end = float(cosine_schedule(100, peak_lr=1.0, warmup=10, total=100))
    assert lr0 < 0.05 and abs(lr_peak - 1.0) < 1e-5 and 0.09 < lr_end < 0.11


def test_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.standard_normal((64,)).astype(np.float32))}
    ef = compression.init_error_feedback(g_true)
    total = torch.zeros((64,))
    for _ in range(50):
        deq, ef = compression.compress_decompress(g_true, ef)
        total = total + deq["w"]
    np.testing.assert_allclose((total / 50).numpy(), g_true["w"].numpy(), atol=0.01)


def test_compressed_training_converges():
    cfg = _tiny_cfg()
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup=5, total_steps=60, compress_grads=True)
    params = tf.init_params(cfg, seed=3, device="cpu")
    state = init_opt_state(ocfg, params, device="cpu")
    step_fn = make_train_step(cfg, ocfg)
    make = lm_token_batches(cfg.vocab_size, batch=8, seq_len=32, seed=4)
    losses = []
    for s in range(30):
        b = {k: torch.from_numpy(v) for k, v in make(s).items()}
        params, state, metrics = step_fn(params, state, b, s)
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


# ------------------------------------------------------------------- F6


def test_forward_records_a_graph_only_for_a_trainer():
    """Parameters are built frozen; a trainer turns them on and ``forward``
    then records a graph; the serving steps record none either way."""
    cfg = _tiny_cfg()
    params = tf.init_params(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (2, 16))
    assert tf.forward(cfg, params, tokens)[0].grad_fn is None
    params.requires_grad_(True)
    logits, _ = tf.forward(cfg, params, tokens)
    assert logits.grad_fn is not None
    logits.sum().backward()
    assert all(p.grad is not None for p in params.parameters())
    served = ds.make_prefill_step(cfg)(params, tokens)
    assert served.grad_fn is None and served.is_inference()
    cache = tf.init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    out, cache = ds.make_serve_step(cfg)(params, tokens[:, :1], 0, cache)
    assert out.grad_fn is None and out.is_inference()
    toks, _ = ds.greedy_generate(cfg, params, tokens[:, :1], cache, steps=2, start_pos=1)
    assert toks.shape == (2, 2)
    with torch.no_grad():  # serving never turned a gradient on
        fresh = tf.init_params(cfg, seed=0, device="cpu")
    ds.make_prefill_step(cfg)(fresh, tokens)
    assert not any(p.requires_grad for p in fresh.parameters())


def test_remat_recomputes_and_keeps_the_gradients():
    """``cfg.remat`` only changes what is kept for the backward pass."""
    grads = {}
    for remat in (False, True):
        cfg = _tiny_cfg(remat=remat)
        params = tf.init_params(cfg, seed=5, device="cpu").requires_grad_(True)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
        tf.forward(cfg, params, tokens)[0].square().mean().backward()
        grads[remat] = [p.grad for p in params.parameters()]
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- F7


def _qkv(bh=3, t=256, d=16, dv=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [0.5 * torch.randn((bh, t, n), generator=g) for n in (d, d, dv)]


@pytest.mark.parametrize("group", [None, 1])
def test_chunked_function_carries_the_twins_gradient(monkeypatch, group):
    """Through ``ChunkedMaclaurin`` the gradient is the plain twin's own
    autograd, whole or a head at a time."""
    if group is not None:
        monkeypatch.setattr(mac, "BACKWARD_BYTES", 1)
    q, k, v = _qkv()
    w = torch.randn((3, 256, 16), generator=torch.Generator().manual_seed(1))
    config = ma.tuning.lookup("maclaurin_attn")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = mac.ChunkedMaclaurin.apply(*leaves, None, config)
    (out * w).sum().backward()
    twin = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = ma.maclaurin_attention_torch(*twin, config=config)
    (ref * w).sum().backward()
    assert torch.equal(out, ref)
    for a, b in zip(leaves, twin):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)
    bf = [x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    mac.maclaurin_attention_chunked(*(x[None] for x in bf)).float().sum().backward()
    assert all(x.grad.dtype == torch.bfloat16 for x in bf)


def test_chunked_gqa_gradient_matches_jax():
    """The maclaurin backend's T >= 1024 route (B8's ``Function``, chunk 64)
    against ``jax.grad`` of the reference's ``lax.scan`` form (chunk 256)."""
    from repro.models import maclaurin_attention as jmac

    rng = np.random.default_rng(0)
    q, k, v = (0.5 * rng.standard_normal((1, 1024, n, 16)).astype(np.float32) for n in (4, 2, 2))
    w = rng.standard_normal((1, 1024, 4, 16)).astype(np.float32)
    jloss = lambda q, k, v: jnp.sum(jmac.maclaurin_attention_gqa(q, k, v) * w)
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (mac.maclaurin_attention_gqa(*leaves) * torch.from_numpy(w)).sum().backward()
    for t, j in zip(leaves, jgrads):
        j = np.asarray(j)
        assert float(np.abs(t.grad.numpy() - j).max()) <= 1e-5 * float(np.abs(j).max())


# ------------------------------------------------------------------- F8


def _wrapper_calls():
    """Each of the nine ``*_cuda`` wrappers with small CPU operands, one of
    which requires a gradient."""
    f = torch.float32
    z = torch.randn((4, 8), requires_grad=True)
    heads = (torch.randn((2, 8, 8)), torch.randn((2, 8)), *(torch.ones(2) for _ in range(4)))
    q8 = (torch.zeros((2, 8, 8), dtype=torch.int8), torch.ones((2, 8)), *heads[1:])
    rff = (torch.randn((16, 8)), torch.randn(16), torch.randn((2, 16)), torch.randn(2))
    rff8 = (torch.zeros((16, 8), dtype=torch.int8), torch.ones(16), torch.randn(16),
            torch.zeros((2, 16), dtype=torch.int8), torch.ones(2), torch.randn(2))
    st = (torch.ones((2, 8)), torch.ones((2, 8)), torch.zeros((2, 8), dtype=torch.int32),
          torch.ones((2, 8)), torch.randn(16), torch.randn((2, 16)), torch.randn(2))
    st8 = (*(torch.zeros((2, 8), dtype=torch.int8) for _ in range(2)),
           torch.zeros((2, 8), dtype=torch.int16), torch.zeros((2, 8), dtype=torch.int8),
           torch.ones(2), torch.zeros(16, dtype=torch.float16),
           torch.zeros((2, 16), dtype=torch.int8), torch.ones(2), torch.randn(2))
    qkv = [torch.randn((2, 64, 16), dtype=f, requires_grad=True) for _ in range(3)]
    return {
        "quadform_heads": (qf, lambda: qf.quadform_heads_cuda(z, *heads)),
        "quadform_heads_q8": (qf, lambda: qf.quadform_heads_q8_cuda(z, *q8)),
        "rbf_scores": (rp, lambda: rp.rbf_scores_cuda(z, torch.randn((5, 8)), torch.randn(5), 0.1, 0.0)),
        "rff_score": (rf, lambda: rf.rff_score_cuda(z, *rff)),
        "rff_score_q8": (rf, lambda: rf.rff_score_q8_cuda(z, *rff8)),
        "fastfood_score": (ff, lambda: ff.fastfood_score_cuda(z, *st)),
        "fastfood_score_q8": (ff, lambda: ff.fastfood_score_q8_cuda(z, *st8)),
        "flash_attention": (fa, lambda: fa.flash_attention_cuda(*qkv)),
        "maclaurin_attention": (ma, lambda: ma.maclaurin_attention_cuda(*qkv)),
    }


@pytest.mark.parametrize("name", sorted(build.KERNELS))
def test_every_wrapper_refuses_a_gradient_before_any_launch(monkeypatch, name):
    """With ``on_card`` forced true on CPU tensors, a wrapper under a
    gradient raises, naming its kernel, before the build is reached; under
    ``no_grad`` the same call gets past the refusal to the build."""

    def no_build(source):
        raise AssertionError(f"reached the build of {source}")

    module, call = _wrapper_calls()[name]
    monkeypatch.setattr(module, "on_card", lambda *_: True)
    monkeypatch.setattr(build, "load", no_build)
    before = build.counts()[name]
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
        call()
    assert build.counts()[name] == before
    with torch.no_grad(), pytest.raises((AssertionError, RuntimeError, ValueError, TypeError)) as e:
        call()  # past the refusal: whatever stops it now is not the refusal
    assert "no backward" not in str(e.value)


@pytest.mark.parametrize("which", ["flash", "maclaurin"])
def test_attention_ops_refuse_a_gradient_in_both_packages(which):
    """``jax.grad`` through the reference's kernels raises (they have no
    VJP); the port's ops raise under a gradient on either device. Without
    one, the port's ops compute."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 128, 16)).astype(np.float32) for _ in range(3))
    jfn, fn = (j_flash, flash_attention) if which == "flash" else (j_mac, maclaurin_attention)
    with pytest.raises(AssertionError):
        jax.grad(lambda q: jfn(q, jnp.asarray(k), jnp.asarray(v)).sum())(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(tq, torch.from_numpy(k), torch.from_numpy(v))
    with torch.no_grad():
        assert fn(tq, torch.from_numpy(k), torch.from_numpy(v)).shape == (1, 2, 128, 16)


def test_flash_training_raises_in_both_packages():
    """``attention_impl="flash"`` training fails in the reference and the port."""
    jcfg, cfg, jparams, params = _both({"attention_impl": "flash"})
    b = lm_token_batches(cfg.vocab_size, batch=2, seq_len=16, seed=0)(0)
    ocfg = OptimizerConfig()
    jocfg = jts.OptimizerConfig()
    with pytest.raises(AssertionError):
        jts.make_train_step(jcfg, jocfg)(jparams, jts.init_opt_state(jocfg, jparams), _jt(b), 0)
    state = init_opt_state(ocfg, params, device="cpu")
    with pytest.raises(RuntimeError, match="flash_attention: the kernel has no backward"):
        make_train_step(cfg, ocfg)(params, state, {k: torch.from_numpy(x) for k, x in b.items()}, 0)
