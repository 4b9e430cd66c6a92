"""Plain-torch oracle for the fused softmax-attention kernel."""

from repro_torch.kernels.maclaurin_attn.ref import softmax_attention_ref

__all__ = ["softmax_attention_ref"]
