"""Public wrapper for fused flash attention (kernel B9), GQA layout aware."""

from __future__ import annotations

from repro_torch.kernels.build import refuse_grad
from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda


def flash_attention(
    q, k, v, scale: float | None = None, causal: bool = True,
    block_q: int | None = None, block_k: int | None = None,
):
    """Causal fused attention. q,k: (B, H, T, d); v: (B, H, T, dv).

    GQA callers repeat kv heads to q heads before the call. ``block_q`` and
    ``block_k`` are the reference's (256 x 256 unless named): they set its
    refusal of padded non-causal keys, and the kernel runs its own 64 x 64
    tile. On CPU tensors the plain twin computes; on CUDA tensors the
    kernel launches.

    Under a gradient it raises on both devices: the reference's kernel has
    no VJP, so ``jax.grad`` through it fails, and training takes the
    blockwise attention."""
    refuse_grad("flash_attention", q, k, v)
    b, h, t, _ = q.shape
    dv = v.shape[-1]

    def flat(x):
        return x.reshape(b * h, t, x.shape[-1]).contiguous()

    out = flash_attention_cuda(
        flat(q), flat(k), flat(v), scale=scale, causal=causal,
        block_q=block_q, block_k=block_k,
    )
    return out.reshape(b, h, t, dv)
