"""Plain-torch formulation of the fused Fastfood scoring path.

The Fastfood construction (Le et al. 2013) replaces the dense RFF
projection W (F, d) with ``stacks`` structured operators

    V_s = S_s H G_s Pi_s H B_s        (each d' = 2^ceil(log2 d) wide)

where B (signs), G (Gaussian) and S (chi row-norm correction) are
diagonal, Pi is a permutation and H is the unnormalized Hadamard matrix
applied by the Walsh-Hadamard transform: O(d' log d') adds per row
instead of O(d'^2) multiplies. A copy of ``repro.kernels.fwht.ref``
without jax.

One transform, two schedules: ``fwht`` is the radix-2 butterfly (the
arithmetic kernels B6/B7 run, stage by stage); ``fwht_kron`` is the same
H x through Sylvester's Kronecker factorization as two small dense
products, which is what ``fastfood_project`` (the plain twin and the
oracle) uses, as ``repro``'s ``fwht_xla`` does. The tests pin both to the
explicit Hadamard matrix.

Everything computes in Z's dtype, so the same functions evaluate the
float64 reference the kernels' tolerances are set from.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform over the last axis (a power
    of two): H x with H entries +-1, H^T H = d I. O(d log d) adds.

    At half-size h the vector splits into (d // 2h) blocks of [lo | hi]
    pairs that recombine as [lo + hi | lo - hi].
    """
    d = x.shape[-1]
    y = x.reshape(-1, d)
    h = 1
    while h < d:
        y = y.reshape(-1, d // (2 * h), 2, h)
        y = torch.cat([y[:, :, 0] + y[:, :, 1], y[:, :, 0] - y[:, :, 1]], dim=-1)
        h *= 2
    return y.reshape(x.shape)


@lru_cache(maxsize=None)
def _hadamard(m: int) -> np.ndarray:
    """Sylvester Hadamard matrix H_m (m a power of two), +-1 entries."""
    H = np.array([[1.0]], dtype=np.float32)
    while H.shape[0] < m:
        H = np.block([[H, H], [H, -H]])
    return H


def fwht_kron(x: torch.Tensor) -> torch.Tensor:
    """The same H x as ``fwht``, as two products.

    H_{2^k} = H_{2^a} (x) H_{2^b} for any a + b = k, so with the last axis
    reshaped to (2^a, 2^b) the transform is Ha @ X @ Hb (32 x 32 each at
    d' = 1024).
    """
    d = x.shape[-1]
    k = max(0, d.bit_length() - 1)
    da = 1 << (k - k // 2)
    db = d // da
    Ha = torch.from_numpy(_hadamard(da)).to(x.device, x.dtype)
    Hb = torch.from_numpy(_hadamard(db)).to(x.device, x.dtype)
    y = Ha @ x.reshape(-1, da, db) @ Hb
    return y.reshape(x.shape)


def fastfood_project(Z, B, G, perm, scale):
    """Z (n, d) -> (n, F) by the per-stack structured transform (no W).

    B/G/scale: (stacks, d') diagonals; perm: (stacks, d') integers. Z is
    zero-padded to d' (exact: the sign flip of a zero column is zero). The
    gather is ``out[:, j] = t[:, perm[j]]``. Features are stack-major.
    """
    stacks, dd = B.shape
    n = Z.shape[0]
    dt = Z.dtype
    Zp = torch.nn.functional.pad(Z, (0, dd - Z.shape[1]))
    t = fwht_kron(Zp[:, None, :] * B.to(dt)[None])  # (n, stacks, dd)
    idx = perm.to(torch.int64)[None].expand(n, stacks, dd)
    t = torch.gather(t, 2, idx)
    t = fwht_kron(t * G.to(dt)[None])
    return (t * scale.to(dt)[None]).reshape(n, stacks * dd)


def fastfood_score_ref(Z, B, G, perm, scale, phase, weights, bias):
    """Structured-projection RFF scores: (n, K) = cos(proj + phase) @ W^T + b,
    with the 2/F feature scaling already folded into ``weights``."""
    dt = Z.dtype
    proj = fastfood_project(Z, B, G, perm, scale)
    phi = torch.cos(proj + phase.to(dt)[None, :])
    return phi @ weights.to(dt).T + bias.to(dt)[None, :]


def fastfood_score_q8_ref(
    Z, b_q, g_q, perm, s_q, stack_scale, phase, weights_q, wt_scale, bias
):
    """Int8-operator oracle: dequantize everything to Z's dtype, then score.

    ``stack_scale`` is the per-stack product of the G and S row scales:
    both diagonals multiply the same output columns, so one fold per stack
    on the transform output reconstructs both.
    """
    dt = Z.dtype
    S = s_q.to(dt) * stack_scale.to(dt)[:, None]
    proj = fastfood_project(Z, b_q.to(dt), g_q.to(dt), perm, S)
    phi = torch.cos(proj + phase.to(dt)[None, :])
    scores = (phi @ weights_q.to(dt).T) * wt_scale.to(dt)[None, :]
    return scores + bias.to(dt)[None, :]
