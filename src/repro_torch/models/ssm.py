"""Mamba2 (SSD) block in the chunked state-space-duality form
(arXiv:2405.21060).

The port of ``repro/models/ssm.py``. Recurrence (per head h, scalar decay):
    h_t = exp(A dt_t) h_{t-1} + dt_t * B_t x_t^T        h: (N, P)
    y_t = C_t h_t + D * x_t

Chunked evaluation (chunk Cs): within a chunk the quadratic form
    Y_intra[t] = sum_{s<=t} (C_t . B_s) exp(l_t - l_s) dt_s x_s,
    l = cumsum(A dt)
is a masked (Cs x Cs) product per head; across chunks a loop carries the
(B, H, N, P) state, where the reference runs a ``lax.scan``. n_groups = 1
(B/C shared across heads), as in the Zamba2 configuration. The reference
runs no Pallas kernel here: this is plain tensor code, as its is plain
``jnp``. Decode promotes mixed operands as JAX does (the state is stored
f32): ``rwkv._einsum``/``rwkv._mm``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import ParamModule, RMSNorm, init_, rmsnorm
from repro_torch.models.rwkv import CLIP, _einsum, _mm


def _frozen(x) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class Mamba2(ParamModule):
    """One Mamba2 layer under the reference's keys: the fused input
    projection ``w_in`` (z gate | x | B | C | dt), the depthwise ``conv``
    (W, d_inner + 2N), ``A_log`` = log(linspace(1, 16, H)), ``D`` (ones),
    ``dt_bias`` (zeros), ``norm.scale`` and ``w_out``."""

    SPEC = {
        "w_in": ("embed", "ffn"),
        "conv": (None, "ffn"),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm": {"scale": ("ffn",)},  # the inner width, not the model's
        "w_out": ("ffn", "embed"),
    }

    def __init__(
        self,
        d: int,
        generator,
        device=None,
        *,
        d_state=64,
        head_dim=64,
        expand=2,
        conv_w=4,
    ):
        super().__init__()
        d_inner = expand * d
        n_heads = d_inner // head_dim
        self.w_in = init_((d, 2 * d_inner + 2 * d_state + n_heads), generator, device)
        self.conv = init_((conv_w, d_inner + 2 * d_state), generator, device, scale=0.5)
        a = torch.linspace(1.0, 16.0, n_heads, dtype=torch.float32, device=device)
        self.A_log = _frozen(torch.log(a))
        self.D = _frozen(torch.ones((n_heads,), device=device))
        self.dt_bias = _frozen(torch.zeros((n_heads,), device=device))
        self.norm = RMSNorm(d_inner, device)
        scale = 1.0 / math.sqrt(d_inner)
        self.w_out = init_((d_inner, d), generator, device, scale=scale)


def _split_proj(proj, d_inner: int, d_state: int, n_heads: int):
    z = proj[..., :d_inner]
    x = proj[..., d_inner : 2 * d_inner]
    Bmat = proj[..., 2 * d_inner : 2 * d_inner + d_state]
    Cmat = proj[..., 2 * d_inner + d_state : 2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state :]
    return z, x, Bmat, Cmat, dt


def _causal_conv(x, w, carry=None):
    """Depthwise causal conv. x: (B, T, C), w: (W, C), carry: (B, W-1, C).
    Returns (silu(out), the new carry: the last W-1 inputs)."""
    W = w.shape[0]
    if carry is None:
        xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([carry, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i : i + T, :] * w[i] for i in range(W))
    return torch.nn.functional.silu(out), xp[:, -(W - 1) :, :]


def _conv_inputs(params, x_in, d_state: int, carry=None):
    """The projection, split, with x | B | C through the causal conv."""
    d_inner = params["w_out"].shape[0]
    n_heads = params["A_log"].shape[0]
    proj = x_in @ params["w_in"]
    z, x, Bm, Cm, dt = _split_proj(proj, d_inner, d_state, n_heads)
    xbc, carry = _causal_conv(torch.cat([x, Bm, Cm], dim=-1), params["conv"], carry)
    x, Bm, Cm = (
        xbc[..., :d_inner],
        xbc[..., d_inner : d_inner + d_state],
        xbc[..., d_inner + d_state :],
    )
    dt = torch.nn.functional.softplus(dt + params["dt_bias"])  # (B, T, H)
    return z, x, Bm, Cm, dt, carry


def ssd_scan(xh, Bm, Cm, dt, A, chunk: int):
    """The chunked SSD over heads: xh (B, T, H, P), Bm/Cm (B, T, N), dt
    (B, T, H), A (H,) -> y (B, T, H, P) before the D skip."""
    B, T, H, P = xh.shape
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device).tril()
    state = xh.new_zeros((B, H, Bm.shape[-1], P))
    ys = []
    for c0 in range(0, T, chunk):
        xc, bc, cc, dtc = (t[:, c0 : c0 + chunk] for t in (xh, Bm, Cm, dt))
        l = torch.cumsum(A[None, None, :] * dtc, dim=1)  # (B,Cs,H) log-decay
        # intra-chunk: G[t,s] = (C_t.B_s) exp(l_t - l_s) dt_s, s<=t
        cb = torch.einsum("btn,bsn->bts", cc, bc)  # (B,Cs,Cs)
        decay = torch.exp(torch.clamp(l[:, :, None, :] - l[:, None, :, :], -CLIP, 0.0))
        G = cb[..., None] * decay * dtc[:, None, :, :]  # (B,Cs,Cs,H)
        G = G.masked_fill(~mask[None, :, :, None], 0.0)
        y_intra = torch.einsum("btsh,bshp->bthp", G, xc)
        # inter-chunk: y += C_t exp(l_t) S_prev
        y_inter = torch.einsum("btn,bth,bhnp->bthp", cc, torch.exp(l), state)
        # S = exp(l_end) S + sum_s exp(l_end - l_s) dt_s B_s x_s^T
        l_end = l[:, -1:, :]  # (B,1,H)
        w_s = torch.exp(torch.clamp(l_end - l, -CLIP, 0.0)) * dtc  # (B,Cs,H)
        ds = torch.einsum("bsn,bsh,bshp->bhnp", bc, w_s, xc)
        state = torch.exp(l_end[:, 0, :])[:, :, None, None] * state + ds
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)


def ssd_step(ssm, xh, Bm, Cm, dt, A):
    """One token of the SSD: ssm (B, H, N, P), xh (B, H, P), Bm/Cm (B, N),
    dt (B, H) -> (y (B, H, P) before the D skip, the new ssm)."""
    alpha = torch.exp(A[None, :] * dt)  # (B,H)
    ssm = alpha[:, :, None, None] * ssm + _einsum("bn,bh,bhp->bhnp", Bm, dt, xh)
    return _einsum("bn,bhnp->bhp", Cm, ssm), ssm


def mamba2_forward(
    params, x_in, *, d_state: int = 64, head_dim: int = 64, chunk: int = 128
):
    """Training/prefill path. x_in: (B, T, d) -> (B, T, d). T must be a
    multiple of ``chunk``, as the reference asserts."""
    B, T, d = x_in.shape
    d_inner = params["w_out"].shape[0]
    n_heads = d_inner // head_dim
    n_chunks = T // chunk
    if n_chunks * chunk != T:
        raise ValueError(f"mamba2_forward: T={T} is not divisible by chunk={chunk}")
    z, x, Bm, Cm, dt, _ = _conv_inputs(params, x_in, d_state)
    A = -torch.exp(params["A_log"])  # (H,) negative
    xh = x.reshape(B, T, n_heads, head_dim)
    y = ssd_scan(xh, Bm, Cm, dt, A, chunk)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(B, T, d_inner)
    y = rmsnorm(params["norm"], y) * torch.nn.functional.silu(z)
    return y @ params["w_out"]


def mamba2_decode(params, x_in, state, *, d_state: int = 64, head_dim: int = 64):
    """One-token decode. x_in: (B, 1, d); state = (ssm (B,H,N,P), conv
    carry (B, W-1, C)). O(H N P) a token, constant in the context length."""
    B = x_in.shape[0]
    d_inner = params["w_out"].shape[0]
    n_heads = d_inner // head_dim
    ssm, conv_carry = state
    z, x, Bm, Cm, dt, conv_carry = _conv_inputs(params, x_in, d_state, conv_carry)
    A = -torch.exp(params["A_log"])
    xh = x.reshape(B, n_heads, head_dim)
    y, ssm = ssd_step(ssm, xh, Bm[:, 0], Cm[:, 0], dt[:, 0], A)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(B, 1, d_inner)
    y = rmsnorm(params["norm"], y) * torch.nn.functional.silu(z)
    return _mm(y, params["w_out"]), (ssm, conv_carry)


def mamba2_init_state(
    B: int,
    d: int,
    *,
    d_state=64,
    head_dim=64,
    expand=2,
    conv_w=4,
    dtype=torch.float32,
    device=None,
):
    """(ssm (B, H, N, P), conv carry (B, W-1, d_inner + 2N)), zeros."""
    d_inner = expand * d
    n_heads = d_inner // head_dim
    opts = dict(dtype=dtype, device=device)
    ssm = torch.zeros((B, n_heads, d_state, head_dim), **opts)
    conv = torch.zeros((B, conv_w - 1, d_inner + 2 * d_state), **opts)
    return ssm, conv
