"""Int8 error-feedback gradient compression (the cross-pod wire format).

The port of ``repro/train/compression.py``: per-tensor symmetric int8
quantization whose residual is carried into the next step, so the
average gradient is unbiased. A stacked layer leaf is one tensor here, as
it is to the reference: one scale over all its layers. The port has no
cross-pod hop; the pair is applied to the assembled gradient, which is
numerically what the reference does on a single reduction.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import LMParams
from repro_torch.train.tree import as_tree, leaves, tree_map, unzip


@torch.no_grad()
def init_error_feedback(params):
    params = as_tree(params)
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _q8(x):
    """(int8 codes, f32 scale): scale max|x| / 127 (at least 1e-12 / 127),
    round half to even as ``jnp.round``, clipped to +-127."""
    scale = q8_scale(torch.max(torch.abs(x)))
    return q8_codes(x, scale), scale


def q8_scale(peak):
    """The per-tensor scale of a tensor whose max|x| is ``peak``."""
    return torch.clamp(peak, min=1e-12) / 127.0


def q8_codes(x, scale):
    """``x``'s int8 codes at ``scale`` (a whole tensor's, where ``x`` is one
    block of it)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def compress_decompress(grads, ef):
    """Returns (decompressed grads, new error feedback)."""
    grads = as_tree(grads)

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = _q8(g32)
        deq = q.to(torch.float32) * scale
        return deq, g32 - deq

    return unzip(tree_map(one, grads, ef), grads, 2)


def wire_bytes(params) -> int:
    """Bytes on the cross-pod wire per step with int8 (vs 4 bytes f32)."""
    if isinstance(params, LMParams):
        return sum(p.numel() for p in params.parameters())
    return sum(leaf.numel() for leaf in leaves(params))
