"""Plain-torch oracles for Maclaurin (second-order) linear attention.

The paper's Eq 3.6 applied to attention: replace exp(u), u = q.k / sqrt(d),
by w(u) = 1 + u + u^2/2. w is positive (min 1/2 at u = -1), so the
normalizer is well-defined. Quadratic O(T^2) references — kernel B8 must
match the first (it is the same math, chunked); the second is the exact
softmax attention the approximation targets (and B9's oracle).

Below them, the moment form of the same sums, in one place for kernel
B8's plain twin and the decode state (``models/maclaurin_attention``
re-exports it): ``MacState``, ``init_state``, ``extend_state`` and
``moment_terms``, the numerator and denominator of a readout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def maclaurin_weights(u):
    """Second-order Maclaurin surrogate of exp(u) (Eq 3.6/A.1)."""
    return 1.0 + u + 0.5 * u * u


def _scaled_scores(q, k, scale):
    """u = scale q k^T. A default scale is an f32 value, as the reference's
    ``1 / sqrt(float32(d_k))``, and promotes the scores to f32 as it does."""
    u = torch.einsum("...td,...sd->...ts", q, k)
    if scale is None:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
        u = u.to(torch.promote_types(u.dtype, torch.float32))
    return u * scale


def _causal(T: int, device) -> torch.Tensor:
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


def maclaurin_attention_ref(q, k, v, scale=None):
    """Causal Maclaurin attention. q,k: (..., T, d_k), v: (..., T, d_v)."""
    u = _scaled_scores(q, k, scale)
    w = maclaurin_weights(u)
    w = w.masked_fill(~_causal(q.shape[-2], q.device), 0.0)
    num = torch.einsum("...ts,...sv->...tv", w, v.to(w.dtype))
    den = torch.sum(w, dim=-1)[..., None]
    return num / den


def softmax_attention_ref(q, k, v, scale=None):
    """Exact causal softmax attention — the 'exact model' the approximation
    targets."""
    u = _scaled_scores(q, k, scale)
    causal = _causal(q.shape[-2], q.device)
    u = u.masked_fill(~causal, -torch.inf)
    w = torch.exp(u - torch.amax(u, dim=-1, keepdim=True))
    w = w.masked_fill(~causal, 0.0)
    num = torch.einsum("...ts,...sv->...tv", w, v.to(w.dtype))
    return num / torch.sum(w, dim=-1)[..., None]


class MacState(NamedTuple):
    s1: torch.Tensor  # (..., d_k, d_v)
    s2: torch.Tensor  # (..., d_k*d_k, d_v)
    k1: torch.Tensor  # (..., d_k)
    k2: torch.Tensor  # (..., d_k*d_k)
    n: torch.Tensor  # (..., 1)
    v0: torch.Tensor  # (..., d_v)
    max_k_sq: torch.Tensor  # (..., 1)


def init_state(
    batch_dims: tuple[int, ...], d_k: int, d_v: int, dtype=torch.float32, device=None
) -> MacState:
    def z(*s):
        return torch.zeros(tuple(batch_dims) + s, dtype=dtype, device=device)

    return MacState(
        s1=z(d_k, d_v), s2=z(d_k * d_k, d_v), k1=z(d_k), k2=z(d_k * d_k),
        n=z(1), v0=z(d_v), max_k_sq=z(1),
    )


def phi2(x: torch.Tensor) -> torch.Tensor:
    """vec(x x^T) over the last axis: (..., d) -> (..., d*d)."""
    return (x[..., :, None] * x[..., None, :]).flatten(-2)


def extend_state(state: MacState, k: torch.Tensor, v: torch.Tensor) -> MacState:
    """Absorb a block of tokens. k: (..., T, d_k), v: (..., T, d_v)."""
    k2f = phi2(k)
    t = k.shape[-2]
    return MacState(
        s1=state.s1 + torch.einsum("...td,...tv->...dv", k, v),
        s2=state.s2 + torch.einsum("...tp,...tv->...pv", k2f, v),
        k1=state.k1 + torch.sum(k, dim=-2),
        k2=state.k2 + torch.sum(k2f, dim=-2),
        n=state.n + float(t),
        v0=state.v0 + torch.sum(v, dim=-2),
        max_k_sq=torch.maximum(
            state.max_k_sq, torch.amax(torch.sum(k * k, dim=-1), dim=-1, keepdim=True)
        ),
    )


def moment_terms(state: MacState, q: torch.Tensor, scale: float):
    """The absorbed keys' share of the Maclaurin sums for queries q (..., T,
    d_k): (numerator (..., T, d_v), denominator (..., T)), the quadratic
    form V0 + scale q.S1 + scale^2/2 phi2(q).S2 and its count analogue."""
    q2 = phi2(q)
    num = (
        state.v0[..., None, :]
        + scale * torch.einsum("...td,...dv->...tv", q, state.s1)
        + (0.5 * scale * scale) * torch.einsum("...tp,...pv->...tv", q2, state.s2)
    )
    den = (
        state.n
        + scale * torch.einsum("...td,...d->...t", q, state.k1)
        + (0.5 * scale * scale) * torch.einsum("...tp,...p->...t", q2, state.k2)
    )
    return num, den
