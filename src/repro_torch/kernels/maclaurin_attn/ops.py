"""Public wrapper for chunked Maclaurin linear attention (kernel B8).

Accepts (batch, heads, T, d) layouts, flattens to (B*H, T, d) for the
kernel grid and returns the result in v's dtype, as the reference's
``ops.py`` does. The chunk size travels as ``TileConfig.chunk`` (``None``
resolves the port's default from ``tuning``). On CPU tensors the plain
twin computes; on CUDA tensors the kernel launches.
"""

from __future__ import annotations

from repro_torch.kernels.common import TileConfig
from repro_torch.kernels.maclaurin_attn.kernel import maclaurin_attention_cuda


def maclaurin_attention(q, k, v, scale: float | None = None, config: TileConfig | None = None):
    """Causal Maclaurin attention. q,k: (B, H, T, d_k), v: (B, H, T, d_v)."""
    b, h, t, _ = q.shape
    dv = v.shape[-1]

    def flat(x):
        return x.reshape(b * h, t, x.shape[-1])

    out = maclaurin_attention_cuda(flat(q), flat(k), flat(v), scale=scale, config=config)
    return out.reshape(b, h, t, dv).to(v.dtype)
