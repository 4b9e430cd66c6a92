"""The port's attention kernels' plain twins (B8, B9), Maclaurin attention
and layer primitives against the JAX package, on the same numpy inputs.

Tolerances: both sides compute in f32 and sum in other orders, so outputs
of size ~1 agree to a few ulp of the largest term; each test states its
bound. The Pallas kernels run in interpret mode, as the reference's own
tests run them on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.common import TileConfig as JTileConfig  # noqa: E402
from repro.kernels.flash_attn import flash_attention as j_flash  # noqa: E402
from repro.kernels.maclaurin_attn import maclaurin_attention as j_mac  # noqa: E402
from repro.kernels.maclaurin_attn import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import maclaurin_attention as jmac  # noqa: E402
from repro_torch.kernels.common import TileConfig  # noqa: E402
from repro_torch.kernels.flash_attn import (  # noqa: E402
    flash_attention,
    flash_attention_cuda,
    flash_attention_torch,
)
from repro_torch.kernels.maclaurin_attn import (  # noqa: E402
    maclaurin_attention,
    maclaurin_attention_torch,
    maclaurin_weights,
)
from repro_torch.kernels.maclaurin_attn import ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import maclaurin_attention as mac  # noqa: E402

# f32 on both sides, sums in another order: |delta| within TOL (relative to
# max(1, max|ref|)) for outputs that are convex combinations of unit-normal
# values.
TOL = 2e-5


def _close(t, j, tol=TOL):
    j = np.asarray(j)
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.shape == j.shape
    bound = tol * max(1.0, float(np.abs(j).max()))
    assert float(np.abs(t - j).max()) <= bound


def _qkv(shape_qk, dv, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal(shape_qk) * scale).astype(np.float32)
    k = (rng.standard_normal(shape_qk) * scale).astype(np.float32)
    v = rng.standard_normal(shape_qk[:-1] + (dv,)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------ B8: maclaurin


@pytest.mark.parametrize(
    "B,H,T,D,DV,chunk",
    [
        (1, 1, 32, 8, 8, 8),
        (2, 3, 100, 16, 16, 32),  # T not divisible by chunk -> padding
        (1, 2, 256, 32, 32, 128),
        (2, 1, 64, 24, 48, 16),  # d_v != d_k
    ],
)
def test_maclaurin_twin_matches_pallas_and_ref(B, H, T, D, DV, chunk):
    q, k, v = _qkv((B, H, T, D), DV, seed=B * T + D, scale=0.3)
    out = maclaurin_attention(*_t(q, k, v), config=TileConfig(chunk=chunk))
    pallas = j_mac(*_j(q, k, v), config=JTileConfig(chunk=chunk))
    _close(out, pallas)
    _close(out, jref.maclaurin_attention_ref(*_j(q, k, v)))
    # the (BH, T, d) twin itself, on the flattened layout
    flat = [torch.from_numpy(a.reshape(B * H, T, -1)) for a in (q, k, v)]
    twin = maclaurin_attention_torch(*flat, config=TileConfig(chunk=chunk))
    _close(twin.reshape(B, H, T, DV), pallas)


def test_maclaurin_ref_and_weights_match_jax():
    q, k, v = _qkv((2, 2, 40, 16), 16, seed=3, scale=0.4)
    _close(ref.maclaurin_attention_ref(*_t(q, k, v)), jref.maclaurin_attention_ref(*_j(q, k, v)))
    _close(ref.softmax_attention_ref(*_t(q, k, v)), jref.softmax_attention_ref(*_j(q, k, v)))
    u = np.linspace(-100, 100, 1001).astype(np.float32)
    _close(maclaurin_weights(torch.from_numpy(u)), jref.maclaurin_weights(jnp.asarray(u)), 1e-6)


def test_maclaurin_cpu_dispatch_returns_v_dtype():
    q, k, v = _t(*_qkv((1, 2, 48, 16), 16, seed=5, scale=0.3))
    out = maclaurin_attention(q.double(), k.double(), v.double())
    assert out.dtype == torch.float64  # computed in f32, returned in v's dtype


# ---------------------------------------------------------------- B9: flash


@pytest.mark.parametrize(
    "B,H,T,D,DV,bq,bk",
    [
        (1, 1, 64, 16, 16, 16, 16),
        (2, 3, 128, 32, 32, 32, 64),
        (1, 2, 100, 16, 16, 32, 32),  # T not divisible by blocks -> padding
        (2, 1, 96, 24, 48, 32, 32),  # dv != d
        (1, 1, 256, 64, 64, 256, 64),  # single q block, multi kv
    ],
)
def test_flash_twin_matches_pallas(B, H, T, D, DV, bq, bk):
    q, k, v = _qkv((B, H, T, D), DV, seed=B * T + D)
    out = flash_attention(*_t(q, k, v), block_q=bq, block_k=bk)
    pallas = j_flash(*_j(q, k, v), block_q=bq, block_k=bk)
    _close(out, pallas)
    _close(out, jref.softmax_attention_ref(*_j(q, k, v)))


def test_flash_large_logits_stay_finite():
    """Large logits: the max-shift must prevent overflow (the reference's
    stability case, 1e-3 as it states)."""
    rng = np.random.default_rng(0)
    q = (rng.standard_normal((1, 1, 64, 16)) * 30).astype(np.float32)
    k = (rng.standard_normal((1, 1, 64, 16)) * 30).astype(np.float32)
    v = rng.standard_normal((1, 1, 64, 16)).astype(np.float32)
    out = flash_attention(*_t(q, k, v), block_q=16, block_k=16)
    assert bool(torch.isfinite(out).all())
    _close(out, j_flash(*_j(q, k, v), block_q=16, block_k=16), 1e-3)
    _close(out, jref.softmax_attention_ref(*_j(q, k, v)), 1e-3)


def test_flash_non_causal_padding_is_refused():
    q, k, v = _t(*_qkv((2, 100, 16), 16, seed=1))
    for fn in (flash_attention_torch, flash_attention_cuda):
        with pytest.raises(ValueError, match="explicit mask"):
            fn(q, k, v, causal=False, block_q=32, block_k=32)
    # the same T at a key block that divides it is a full attention
    out = flash_attention_cuda(q, k, v, causal=False, block_q=32, block_k=100)
    s = (q @ k.transpose(1, 2)) / 4.0
    assert torch.allclose(out, torch.softmax(s, -1) @ v, atol=1e-5)


def test_flash_keeps_q_dtype():
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv((1, 2, 32, 16), 16, seed=2)))
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 32, 16)


# ------------------------------------------- models/maclaurin_attention.py


def _state_pair(B=2, Hkv=2, T=24, D=8, seed=1):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B, Hkv, T, D)) * 0.4).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    js = jmac.extend_state(jmac.init_state((B, Hkv), D, D), *_j(k, v))
    ts = mac.extend_state(mac.init_state((B, Hkv), D, D), *_t(k, v))
    return js, ts


def test_extend_state_matches_jax():
    js, ts = _state_pair()
    for name in mac.MacState._fields:
        _close(getattr(ts, name), getattr(js, name), 1e-5)


@pytest.mark.parametrize("q_scale", [0.1, 100.0])
def test_readout_matches_jax(q_scale):
    js, ts = _state_pair()
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((2, 2, 3, 8)) * q_scale).astype(np.float32)
    jo, jv = jmac.readout(js, jnp.asarray(q))
    to, tv = mac.readout(ts, torch.from_numpy(q))
    _close(to, jo, 1e-5)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert bool(tv.all()) == (q_scale < 1)  # the flag flips outside the envelope


@pytest.mark.parametrize("T", [24, 1024])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_maclaurin_attention_gqa_matches_jax(T, use_kernel):
    rng = np.random.default_rng(T)
    B, Hkv, g, D = 1, 2, 2, 16
    q = (rng.standard_normal((B, T, Hkv * g, D)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((B, T, Hkv, D)) * 0.4).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    out = mac.maclaurin_attention_gqa(*_t(q, k, v), use_kernel=use_kernel)
    _close(out, jmac.maclaurin_attention_gqa(*_j(q, k, v), use_kernel=use_kernel))


@pytest.mark.parametrize("chunk", [16, 64])
def test_maclaurin_attention_chunked_matches_jax(chunk):
    q, k, v = _qkv((2, 2, 128, 16), 16, seed=chunk, scale=0.4)
    out = mac.maclaurin_attention_chunked(*_t(q, k, v), chunk=chunk)
    _close(out, jmac.maclaurin_attention_chunked(*_j(q, k, v), chunk=chunk))
    with pytest.raises(ValueError, match="chunk"):
        mac.maclaurin_attention_chunked(*_t(q[:, :, :100], k[:, :, :100], v[:, :, :100]), chunk=chunk)


# ------------------------------------------------------------ models/layers


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 32)) * 3).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    out = layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    _close(out, jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), 1e-6)
    # bf16 in, computed in f32, bf16 out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert layers.rmsnorm({"scale": torch.from_numpy(scale)}, xb).dtype == torch.bfloat16


@pytest.mark.parametrize("per_batch", [False, True])
def test_apply_rope_matches_jax(per_batch):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 1000
    if per_batch:
        pos = np.stack([pos, pos + 5])
    out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    ref_out = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(out, ref_out, 1e-5)
    # interleaved pairs, not halves: position 0 is the identity and a pair
    # (2i, 2i+1) keeps its norm
    zero = layers.apply_rope(torch.from_numpy(x), torch.zeros(7, dtype=torch.int32))
    assert torch.equal(zero, torch.from_numpy(x))
    pairs = out.reshape(2, 7, 3, 8, 2).norm(dim=-1)
    assert torch.allclose(pairs, torch.from_numpy(x).reshape(2, 7, 3, 8, 2).norm(dim=-1), atol=1e-5)


def test_swiglu_embed_head_and_xent_match_jax():
    rng = np.random.default_rng(2)
    d, d_ff, vocab = 16, 40, 30
    p = {
        "w_gate": rng.standard_normal((d, d_ff)).astype(np.float32) / 4,
        "w_up": rng.standard_normal((d, d_ff)).astype(np.float32) / 4,
        "w_down": rng.standard_normal((d_ff, d)).astype(np.float32) / 6,
    }
    x = rng.standard_normal((3, 4, d)).astype(np.float32)
    out = layers.swiglu({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(out, jlayers.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)), 1e-5)
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    tokens = rng.integers(0, vocab, (3, 4))
    _close(layers.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tokens)), table[tokens], 0)
    w = rng.standard_normal((d, vocab)).astype(np.float32)
    logits = layers.lm_head({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    _close(logits, jlayers.lm_head({"w": jnp.asarray(w)}, jnp.asarray(x)), 1e-5)
    labels = rng.integers(0, vocab, (3, 4))
    xent = layers.softmax_xent(logits, torch.from_numpy(labels))
    _close(xent, jlayers.softmax_xent(jnp.asarray(logits.numpy()), jnp.asarray(labels)), 1e-6)
