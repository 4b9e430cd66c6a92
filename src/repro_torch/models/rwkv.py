"""RWKV6 ("Finch", arXiv:2404.05892): attention-free, data-dependent decay.

The port of ``repro/models/rwkv.py``. Time-mixing recurrence per head
(K = V = head size):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t            S: (K, V)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w0 + lora(x_t))) in (0,1) per channel (the
data-dependent decay) and u the current-token bonus.

Chunked evaluation (GLA-style factorized decay): within a chunk, with
lw = cumsum(log w) (lw <= 0), the decay from s to t factorizes
exp(lw_t - lw_s) = exp(lw_t) * exp(-lw_s) per channel, so the
intra-chunk contribution is a plain product of transformed r/k. Exponents
are clipped to +-30, as in the reference. The reference's ``lax.scan``
over chunks is a loop carrying the (B, H, K, V) state.

The paper's technique does not apply here (no exponential of an inner
product), and the reference runs no Pallas kernel: this is plain tensor
code, as the reference's is plain ``jnp``.

Mixed dtypes: the decode state is stored f32 while a bf16 model computes
in bf16; JAX promotes the mixed products to f32, and ``_einsum``/``_mm``
do the same here (torch's products refuse mixed operands).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import ParamModule, init_

CLIP = 30.0


def _einsum(eq: str, *ops):
    """``torch.einsum`` with the operands promoted to one dtype, as JAX's
    einsum promotes them."""
    dtype = ops[0].dtype
    for t in ops[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.einsum(eq, *(t.to(dtype) for t in ops))


def _mm(a, b):
    """``a @ b`` at the promoted dtype of the two."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype) @ b.to(dtype)


def _full(shape, value: float, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, device=device), requires_grad=False)


class RWKV6(ParamModule):
    """One RWKV6 layer under the reference's keys: the raw ``ln1``/``ln2``
    RMSNorm scales, the time-mix lerps ``mu`` (5, d), ``w_r``/``w_k``/
    ``w_v``/``w_g``, the decay ``w0`` and its LoRA, the bonus ``u`` (H, hd),
    the group-norm ``ln_scale``, ``w_o``, and the channel mix's ``mu_ffn``
    (2, d), ``w_ffn_k``, ``w_ffn_v``, ``w_ffn_r``. Scales are the
    reference's."""

    SPEC = {
        "ln1": ("embed",),
        "ln2": ("embed",),
        "mu": (None, "embed"),
        "w_r": ("embed", "heads"),
        "w_k": ("embed", "heads"),
        "w_v": ("embed", "heads"),
        "w_g": ("embed", "heads"),
        "w0": ("heads",),
        "w_lora_a": ("embed", None),
        "w_lora_b": (None, "heads"),
        "u": (None, None),
        "ln_scale": ("heads",),
        "w_o": ("heads", "embed"),
        "mu_ffn": (None, "embed"),
        "w_ffn_k": ("embed", "ffn"),
        "w_ffn_v": ("ffn", "embed"),
        "w_ffn_r": ("embed", "embed"),
    }

    def __init__(
        self, d: int, d_ff: int, generator, device=None, *, head_dim=64, lora_r=64
    ):
        super().__init__()
        n_heads = d // head_dim
        self.ln1 = _full((d,), 1.0, device)
        self.ln2 = _full((d,), 1.0, device)
        self.mu = _full((5, d), 0.5, device)
        self.w_r = init_((d, d), generator, device)
        self.w_k = init_((d, d), generator, device)
        self.w_v = init_((d, d), generator, device)
        self.w_g = init_((d, d), generator, device)
        self.w0 = _full((d,), -6.0 / 3.0, device)
        self.w_lora_a = init_((d, lora_r), generator, device)
        self.w_lora_b = init_((lora_r, d), generator, device, scale=0.01)
        self.u = _full((n_heads, head_dim), 0.0, device)
        self.ln_scale = _full((d,), 1.0, device)
        self.w_o = init_((d, d), generator, device, scale=1.0 / (d**0.5))
        self.mu_ffn = _full((2, d), 0.5, device)
        self.w_ffn_k = init_((d, d_ff), generator, device)
        self.w_ffn_v = init_((d_ff, d), generator, device, scale=1.0 / (d_ff**0.5))
        self.w_ffn_r = init_((d, d), generator, device)


def _token_shift(x, last=None):
    """x_{t-1}; for decode, ``last`` carries the previous token."""
    if last is None:
        return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1, :]
    return last


def _group_norm(x, scale, n_heads: int, eps: float = 1e-5):
    """Per-head LayerNorm of the wkv output (RWKV convention), in f32."""
    B, T, d = x.shape
    xh = x.reshape(B, T, n_heads, d // n_heads).to(torch.float32)
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, correction=0)
    out = (xh - mu) * torch.rsqrt(var + eps)
    return (out.reshape(B, T, d) * scale).to(x.dtype)


def _decay(params, xw):
    """log w in (-inf, 0): -exp(w0 + lora(x)), clipped away from 0."""
    lora = torch.tanh(xw @ params["w_lora_a"]) @ params["w_lora_b"]
    return -torch.exp(params["w0"] + lora) - 1e-4


def time_mix_forward(params, x, *, head_dim: int = 64, chunk: int = 32):
    """Training/prefill path. x: (B, T, d) -> (B, T, d). T must be a
    multiple of ``chunk``, as the reference asserts. The heads are those
    ``w_r``'s columns hold (all d // head_dim, or a head shard's, whose
    ``u`` rows and ``w_o`` rows are that shard's)."""
    B, T, d = x.shape
    H = params["w_r"].shape[1] // head_dim
    n_chunks = T // chunk
    if n_chunks * chunk != T:
        raise ValueError(f"time_mix_forward: T={T} is not a multiple of chunk={chunk}")
    xs = _token_shift(x)

    def mix(i):
        return x + (xs - x) * params["mu"][i]

    r = (mix(0) @ params["w_r"]).reshape(B, T, H, head_dim)
    k = (mix(1) @ params["w_k"]).reshape(B, T, H, head_dim)
    v = (mix(2) @ params["w_v"]).reshape(B, T, H, head_dim)
    lw = _decay(params, mix(3)).reshape(B, T, H, head_dim)  # log w
    g = torch.nn.functional.silu(mix(4) @ params["w_g"])
    u = params["u"]
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril(-1)

    S = torch.zeros((B, H, head_dim, head_dim), dtype=x.dtype, device=x.device)
    ys = []
    for c0 in range(0, T, chunk):
        rc, kc, vc, lwc = (t[:, c0 : c0 + chunk] for t in (r, k, v, lw))  # (B,Cs,H,K)
        L = torch.cumsum(lwc, dim=1)  # inclusive cumsum of log w
        # decay between s and t (exclusive of s): exp(L_{t-1} - L_s); the
        # query side decays up to but excluding token t's own w
        Lq = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], dim=1)
        r_t = rc * torch.exp(torch.clamp(Lq, -CLIP, CLIP))
        k_s = kc * torch.exp(torch.clamp(-L, -CLIP, CLIP))
        A = torch.einsum("bthk,bshk->bhts", r_t, k_s)  # strict lower part valid
        A = A.masked_fill(~tri, 0.0)
        # current-token bonus u
        diag = torch.einsum("bthk,hk,bthk->bth", rc, u, kc)
        y = torch.einsum("bhts,bshv->bthv", A, vc)
        y = y + diag[..., None] * vc
        # inter-chunk: the state seen by token t, decayed by Lq
        y = y + torch.einsum("bthk,bhkv->bthv", r_t, S)
        # S' = diag(prod w) S + sum_s (k_s * exp(L_end - L_s)) v_s
        L_end = L[:, -1]  # (B,H,K)
        k_upd = kc * torch.exp(torch.clamp(L_end[:, None] - L, -CLIP, CLIP))
        S = torch.exp(torch.clamp(L_end, -CLIP, CLIP))[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", k_upd, vc
        )
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, T, H * head_dim)
    y = _group_norm(y, params["ln_scale"], H) * g
    return y @ params["w_o"]


def time_mix_decode(params, x, state, *, head_dim: int = 64):
    """One-token decode. state = (S (B,H,K,V), x_prev (B,1,d)). Returns
    (out (B,1,d), (S, x)); S in the promoted dtype of the state and x.
    The heads are ``w_r``'s, as in ``time_mix_forward``."""
    B = x.shape[0]
    H = params["w_r"].shape[1] // head_dim
    S, x_prev = state

    def mix(i):
        return x + (x_prev - x) * params["mu"][i]

    r = (mix(0) @ params["w_r"]).reshape(B, H, head_dim)
    k = (mix(1) @ params["w_k"]).reshape(B, H, head_dim)
    v = (mix(2) @ params["w_v"]).reshape(B, H, head_dim)
    lw = _decay(params, mix(3)).reshape(B, H, head_dim)
    g = torch.nn.functional.silu(mix(4) @ params["w_g"])
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    y = _einsum("bhk,bhkv->bhv", r, S + params["u"][None, :, :, None] * kv)
    S = torch.exp(lw)[..., None] * S + kv
    y = y.reshape(B, 1, H * head_dim)
    y = _group_norm(y, params["ln_scale"], H) * g
    return _mm(y, params["w_o"]), (S, x)


def channel_mix(params, x, last=None):
    """RWKV6 FFN ('channel mixing'). Returns (out, x): x is the new shift."""
    gate, value = channel_mix_parts(params, x, last)
    return gate * value, x


def channel_mix_parts(params, x, last=None):
    """The channel mix's two factors: (sigmoid of the receptance, the value
    projection ``relu(xk W_k)^2 W_v``). On an "ffn" shard of ``w_ffn_k``
    and ``w_ffn_v`` the value is that shard's partial sum."""
    xs = _token_shift(x, last)
    xk = x + (xs - x) * params["mu_ffn"][0]
    xr = x + (xs - x) * params["mu_ffn"][1]
    kk = torch.square(torch.relu(xk @ params["w_ffn_k"]))
    return torch.sigmoid(xr @ params["w_ffn_r"]), kk @ params["w_ffn_v"]


def rwkv6_init_state(
    B: int, d: int, *, head_dim: int = 64, dtype=torch.float32, device=None
):
    """(S (B, H, hd, hd), x_prev_tm (B, 1, d), x_prev_cm (B, 1, d)), zeros."""
    H = d // head_dim
    S = torch.zeros((B, H, head_dim, head_dim), dtype=dtype, device=device)
    x_prev_tm = torch.zeros((B, 1, d), dtype=dtype, device=device)
    x_prev_cm = torch.zeros((B, 1, d), dtype=dtype, device=device)
    return S, x_prev_tm, x_prev_cm
