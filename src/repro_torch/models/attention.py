"""GQA attention: full causal (prefill), cached decode, and the VLM's
cross-attention to image tokens.

The port of ``repro/models/attention.py``. Head layout convention:
activations (B, T, H, hd). ``Attention`` holds the projections under the
reference's keys (``w_q``, ``w_k``, ``w_v``, ``w_o`` and, with
``qkv_bias``, ``b_q``, ``b_k``, ``b_v``), in its (in, out) layout;
``CrossAttention`` the same four without biases.

The reference's decode writes one cache slot with
``dynamic_update_slice`` and returns new arrays; the port writes the slot
in place (an index write into the cache tensors) and returns the same
tensors, so a decode step allocates no second cache.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import ParamModule, apply_rope, init_, remat, zeros_


class Attention(ParamModule):
    SPEC = {
        "w_q": ("embed", "heads"),
        "w_k": ("embed", "kv_heads"),
        "w_v": ("embed", "kv_heads"),
        "w_o": ("heads", "embed"),
        "b_q": ("heads",),
        "b_k": ("kv_heads",),
        "b_v": ("kv_heads",),
    }

    def __init__(self, d, n_heads, n_kv, head_dim, qkv_bias, generator, device=None):
        super().__init__()
        self.w_q = init_((d, n_heads * head_dim), generator, device)
        self.w_k = init_((d, n_kv * head_dim), generator, device)
        self.w_v = init_((d, n_kv * head_dim), generator, device)
        hq = n_heads * head_dim
        self.w_o = init_((hq, d), generator, device, scale=1.0 / (hq**0.5))
        if qkv_bias:
            self.b_q = zeros_((n_heads * head_dim,), device)
            self.b_k = zeros_((n_kv * head_dim,), device)
            self.b_v = zeros_((n_kv * head_dim,), device)


def qkv_columns(params, x):
    """The q, k and v projections of x (B, T, d), biases added: (B, T, .)
    each, heads still flat in the last dim."""
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if "b_q" in params:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    return q, k, v


def split_heads(q, k, v, n_heads, n_kv, head_dim, positions, rope_theta):
    """Flat projections -> (B, T, H, hd) heads, q and k rotated."""
    B, T = q.shape[:2]
    q = q.reshape(B, T, n_heads, head_dim)
    k = k.reshape(B, T, n_kv, head_dim)
    v = v.reshape(B, T, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _project_qkv(params, x, n_heads, n_kv, head_dim, positions, rope_theta):
    q, k, v = qkv_columns(params, x)
    return split_heads(q, k, v, n_heads, n_kv, head_dim, positions, rope_theta)


def _gqa_scores_full(
    q, k, v, causal: bool, chunk: int = 512, scores_dtype=torch.float32, offset: int | None = None
):
    """q: (B,T,Hq,hd), k/v: (B,S,Hkv,hd). Softmax attention, blockwise over
    query chunks of 512, so the (T x S) score matrix never materializes —
    peak extra memory is one (B,Hkv,g,chunk,S) slab, recomputed in the
    backward pass (each chunk under ``remat``, as the reference
    ``jax.checkpoint``s each chunk body). Full-softmax rows per chunk (S is
    not chunked), so no online-softmax state is needed. ``offset``: the
    position of q's first row among the S keys, for the causal mask
    (default S - T: q holds the last T rows).
    """
    B, T, Hq, hd = q.shape
    Hkv, S = k.shape[2], k.shape[1]
    g = Hq // Hkv
    scale = 1.0 / (hd**0.5)
    first = S - T if offset is None else offset
    qh = q.reshape(B, T, Hkv, g, hd)
    if T <= chunk:
        return _attn_chunk(qh, k, v, first, causal, scale, S, scores_dtype).reshape(B, T, Hq, hd)
    n_chunks = T // chunk
    assert n_chunks * chunk == T, f"T={T} not divisible by attention chunk {chunk}"
    outs = [
        remat(_attn_chunk, qh[:, c0 : c0 + chunk], k, v, first + c0, causal, scale, S, scores_dtype)
        for c0 in range(0, T, chunk)
    ]
    return torch.cat(outs, dim=1).reshape(B, T, Hq, hd)


def _attn_chunk(qc, k, v, offset, causal: bool, scale: float, T: int, scores_dtype=torch.float32):
    """One query chunk against the full key set. qc: (B,c,Hkv,g,hd).

    The scores accumulate in f32 (the products of bf16 inputs are exact in
    f32, so this is the reference's ``preferred_element_type``) and are kept
    in ``scores_dtype``; the normalizer accumulates in f32."""
    c = qc.shape[1]
    S = k.shape[1]
    f32 = torch.float32
    u = torch.einsum("bthgd,bshd->bhgts", qc.to(f32), k.to(f32)).to(scores_dtype) * scale
    if causal:
        rows = offset + torch.arange(c, device=qc.device)[:, None] + (S - T)
        cols = torch.arange(S, device=qc.device)[None, :]
        u = u.masked_fill(rows < cols, -torch.inf)
    m = torch.amax(u, dim=-1, keepdim=True)
    e = torch.exp(u - m)
    den = torch.sum(e.to(f32), dim=-1, keepdim=True)
    w = (e / den.to(e.dtype)).to(qc.dtype)
    return torch.einsum("bhgts,bshd->bthgd", w, v.to(qc.dtype))


def self_attention(
    params, x, *, n_heads, n_kv, head_dim, positions, rope_theta=10000.0,
    causal=True, scores_dtype=torch.float32,
):
    """Prefill path: full attention over the sequence."""
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, rope_theta)
    out = _gqa_scores_full(q, k, v, causal, scores_dtype=scores_dtype)
    B, T = x.shape[:2]
    return out.reshape(B, T, n_heads * head_dim) @ params["w_o"]


def _decode_scores(q, cache_k, pos, n_heads, head_dim):
    """Softmax weights of one query over the cache, slots past ``pos``
    masked: (B, Hkv, g, 1, S) f32."""
    B, _, Hkv, _ = cache_k.shape
    g = n_heads // Hkv
    qh = q.reshape(B, 1, Hkv, g, head_dim)
    f32 = torch.float32
    u = torch.einsum("bthgd,bshd->bhgts", qh.to(f32), cache_k.to(f32)) * (1.0 / head_dim**0.5)
    valid = torch.arange(cache_k.shape[1], device=q.device) <= pos
    return torch.softmax(u.masked_fill(~valid, -torch.inf), dim=-1)


def decode_attention(params, x, cache_k, cache_v, pos, *, n_heads, n_kv, head_dim, rope_theta=10000.0):
    """One-token cached decode. x: (B, 1, d); cache_k/v: (B, S, Hkv, hd).

    Returns (out (B,1,d), cache_k, cache_v): slot ``pos`` is written in
    place. Reads the full cache (the memory-bound op) and writes one slot.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, rope_theta)
    write_slot(cache_k, cache_v, k, v, pos)
    out = decode_attend(q, cache_k, cache_v, pos, n_heads, head_dim)
    return out @ params["w_o"], cache_k, cache_v


def write_slot(cache_k, cache_v, k, v, slot: int) -> None:
    """One token's k, v (B, 1, Hkv, hd) into cache slot ``slot``, in place."""
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)


def decode_attend(q, cache_k, cache_v, pos, n_heads, head_dim):
    """One query (B, 1, Hq, hd) over the cache's slots up to ``pos``:
    (B, 1, Hq hd), before the output projection."""
    w = _decode_scores(q, cache_k, pos, n_heads, head_dim).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", w, cache_v.to(q.dtype))
    return out.reshape(q.shape[0], 1, n_heads * head_dim)


# int8 KV quantization granularity: symmetric scale per (token, head,
# KV_QUANT_GROUP-channel group). Per-token-per-head scales (one scale over
# the whole head_dim) lose argmax parity against the fp path on small
# models — one outlier channel inflates the scale and the other channels'
# resolution collapses; 16-channel groups restore exact argmax agreement.
KV_QUANT_GROUP = 16


def _kv_group(head_dim: int) -> int:
    """Channels per scale group: the largest divisor of head_dim that is
    <= KV_QUANT_GROUP (gcd), so grouping works for any head_dim."""
    return math.gcd(head_dim, KV_QUANT_GROUP)


def kv_quant_groups(head_dim: int) -> int:
    """Scale entries per (token, head); init_cache sizes the scale caches
    with this so it stays in lock-step with decode_attention_quant."""
    return head_dim // _kv_group(head_dim)


def decode_attention_quant(
    params, x, cache_k, cache_v, k_scale, v_scale, pos,
    *, n_heads, n_kv, head_dim, rope_theta=10000.0,
):
    """Cached decode with an int8 KV cache (grouped sub-channel symmetric
    scales). The cache tiles are dequantized group-wise right before the
    dot:

        k_s = k_int8_s,g * kscale_s,g          (g = 16-channel group)

    The new token is quantized with round-half-even (``torch.round``, as
    ``jnp.round``) at scales max|t|/127 + 1e-9, and slot ``pos`` of the four
    cache tensors is written in place."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, rope_theta)
    write_slot_q8(cache_k, cache_v, k_scale, v_scale, k, v, pos)
    k_deq = dequantize_kv(cache_k, k_scale).to(q.dtype)
    w = _decode_scores(q, k_deq, pos, n_heads, head_dim)
    out = torch.einsum(
        "bhgts,bshd->bthgd", w.to(q.dtype), dequantize_kv(cache_v, v_scale).to(q.dtype)
    )
    out = out.reshape(B, 1, n_heads * head_dim) @ params["w_o"]
    return out, cache_k, cache_v, k_scale, v_scale


def quantize_kv(t):
    """(B, 1, Hkv, hd) -> its int8 values and (B, 1, Hkv, G) group scales."""
    group = _kv_group(t.shape[-1])
    tg = t.reshape(*t.shape[:-1], t.shape[-1] // group, group)
    s = torch.amax(torch.abs(tg), dim=-1, keepdim=True) / 127.0 + 1e-9
    q8 = torch.clamp(torch.round(tg / s), -127, 127).to(torch.int8)
    return q8.reshape(t.shape), s[..., 0]


def dequantize_kv(c8, s):
    """(B, S, Hkv, hd) int8 and (B, S, Hkv, G) group scales -> f32."""
    group = _kv_group(c8.shape[-1])
    cg = c8.to(torch.float32).reshape(*c8.shape[:-1], c8.shape[-1] // group, group)
    return (cg * s[..., None]).reshape(c8.shape)


def write_slot_q8(cache_k, cache_v, k_scale, v_scale, k, v, slot: int) -> None:
    """One token's k, v (B, 1, Hkv, hd) quantized into slot ``slot`` of an
    int8 cache and its scales, in place."""
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    cache_k[:, slot] = kq[:, 0]
    cache_v[:, slot] = vq[:, 0]
    k_scale[:, slot] = ks[:, 0].to(k_scale.dtype)
    v_scale[:, slot] = vs[:, 0].to(v_scale.dtype)


def write_kv(cache: tuple, k, v, slot: int) -> None:
    """One token's k, v into slot ``slot`` of a (k, v) cache, or of int8's
    (k, v, k scales, v scales)."""
    if len(cache) == 4:
        write_slot_q8(*cache, k, v, slot)
    else:
        write_slot(*cache, k, v, slot)


def read_kv(cache: tuple) -> tuple:
    """A cache's (k, v) as stored, or int8's dequantized (f32) with their
    per-token scales."""
    if len(cache) == 4:
        ck, cv, ks, vs = cache
        return dequantize_kv(ck, ks), dequantize_kv(cv, vs)
    return cache


class CrossAttention(ParamModule):
    """``w_q`` (d, Hq hd), ``w_k``/``w_v`` (d, Hkv hd), ``w_o`` (Hq hd, d)."""

    SPEC = {
        "w_q": ("embed", "heads"),
        "w_k": ("embed", "kv_heads"),
        "w_v": ("embed", "kv_heads"),
        "w_o": ("heads", "embed"),
    }

    def __init__(self, d, n_heads, n_kv, head_dim, generator, device=None):
        super().__init__()
        hq = n_heads * head_dim
        self.w_q = init_((d, hq), generator, device)
        self.w_k = init_((d, n_kv * head_dim), generator, device)
        self.w_v = init_((d, n_kv * head_dim), generator, device)
        self.w_o = init_((hq, d), generator, device, scale=1.0 / (hq**0.5))


def cross_attention(params, x, ctx, *, n_heads, n_kv, head_dim):
    """Queries from x (B,T,d), keys/values from ctx (B,N,d). No mask, no RoPE
    (the Llama-3.2-vision convention for image cross-attention); plain
    blockwise softmax, as the reference's."""
    B, T, _ = x.shape
    N = ctx.shape[1]
    q = (x @ params["w_q"]).reshape(B, T, n_heads, head_dim)
    k = (ctx @ params["w_k"]).reshape(B, N, n_kv, head_dim)
    v = (ctx @ params["w_v"]).reshape(B, N, n_kv, head_dim)
    out = _gqa_scores_full(q, k, v, causal=False)
    return out.reshape(B, T, n_heads * head_dim) @ params["w_o"]
