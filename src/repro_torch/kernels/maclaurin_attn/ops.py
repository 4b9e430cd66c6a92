"""Public wrapper for chunked Maclaurin linear attention (kernel B8).

Accepts (batch, heads, T, d) layouts, flattens to (B*H, T, d) for the
kernel grid and returns the result in v's dtype, as the reference's
``ops.py`` does. The chunk size travels as ``TileConfig.chunk`` (``None``
resolves the port's default from ``tuning``). On CPU tensors the plain
twin computes; on CUDA tensors the kernel launches. Under a gradient it
raises on both devices, as ``jax.grad`` through the reference's kernel
fails: training reaches B8 through
``models.maclaurin_attention.maclaurin_attention_chunked`` instead, whose
backward is the plain chunked twin's.
"""

from __future__ import annotations

from repro_torch.kernels.build import refuse_grad
from repro_torch.kernels.common import TileConfig
from repro_torch.kernels.maclaurin_attn.kernel import maclaurin_attention_cuda


def maclaurin_attention(q, k, v, scale: float | None = None, config: TileConfig | None = None):
    """Causal Maclaurin attention. q,k: (B, H, T, d_k), v: (B, H, T, d_v)."""
    refuse_grad("maclaurin_attention", q, k, v)
    b, h, t, _ = q.shape
    dv = v.shape[-1]

    def flat(x):
        return x.reshape(b * h, t, x.shape[-1])

    out = maclaurin_attention_cuda(flat(q), flat(k), flat(v), scale=scale, config=config)
    return out.reshape(b, h, t, dv).to(v.dtype)
