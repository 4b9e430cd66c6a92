"""Model/run configuration dataclasses + the input-shape suite.

The port's own copy of ``repro/configs/base.py``: shapes only, no
weights. Every assigned architecture is a ``ModelConfig`` in its own
module (``repro_torch/configs/<id>.py``) built from the public-literature
numbers. ``reduced()`` shrinks any config to a CPU-smoke-testable size
while preserving the family topology (MoE stays MoE, hybrid stays
hybrid, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    hybrid_attn_every: int = 0      # zamba2: shared attn block every k mamba layers
    # --- rwkv ---
    rwkv_head_dim: int = 64
    # --- vlm ---
    cross_attn_every: int = 0       # 1 cross-attn layer per k self-attn layers
    n_image_tokens: int = 0
    # --- execution ---
    attention_backend: str = "softmax"  # softmax | maclaurin (paper technique)
    remat: bool = True
    dtype: str = "bfloat16"
    scan_chunk: int = 128           # SSD / linear-attn chunk length
    attn_scores_dtype: str = "float32"  # float32 | bfloat16 (perf option:
    # halves the dominant HBM term of the unfused blockwise attention;
    # softmax stats still accumulate in f32)
    attention_impl: str = "blockwise"   # blockwise (plain tensor code) |
    # flash (the fused kernel kernels/flash_attn; removes the score-slab
    # HBM term entirely)
    kv_cache_dtype: str = "bfloat16"    # bfloat16 | int8 (grouped sub-channel
    # symmetric scales, one per (token, head, KV_QUANT_GROUP channels) —
    # see models/attention.py; ~2x on the decode memory term)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def with_backend(self, backend: str) -> "ModelConfig":
        return dataclasses.replace(self, attention_backend=backend)

    def reduced(self) -> "ModelConfig":
        """Family-preserving shrink for CPU smoke tests."""
        r_hybrid_every = min(self.hybrid_attn_every, 2) if self.hybrid_attn_every else 0
        r_cross_every = min(self.cross_attn_every, 2) if self.cross_attn_every else 0
        if self.family == "hybrid":
            n_layers = 2 * r_hybrid_every      # 2 groups of mamba + shared attn
        elif self.family == "vlm":
            n_layers = 2 * r_cross_every       # 2 super-blocks (self+cross)
        else:
            n_layers = 2
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            moe_num_experts=min(self.moe_num_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=128 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            rwkv_head_dim=32,
            n_image_tokens=16 if self.n_image_tokens else 0,
            hybrid_attn_every=r_hybrid_every,
            cross_attn_every=r_cross_every,
            scan_chunk=16,
            dtype="float32",
            remat=False,
        )

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.hd
        emb = V * d * 2  # embed + head
        per_layer = 0
        if self.family == "ssm":  # rwkv6
            per_layer = 4 * d * d + d * d + 2 * d * 64 + 2 * d * self.d_ff + d * d
        else:
            attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
            if self.family == "hybrid":
                d_in = self.ssm_expand * d
                mamba = d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * d
                shared = attn + 3 * d * self.d_ff
                return emb + L * mamba + shared
            if self.moe_num_experts:
                ffn = 3 * d * self.moe_d_ff * self.moe_num_experts + d * self.moe_num_experts
                if self.moe_dense_residual:
                    ffn += 3 * d * self.d_ff
            else:
                ffn = 3 * d * self.d_ff
            per_layer = attn + ffn
            if self.cross_attn_every:
                # every k-th layer is cross-attn (same shapes as self-attn + ffn)
                pass
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if not self.moe_num_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.hd
        emb = self.vocab_size * d * 2
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        ffn = 3 * d * self.moe_d_ff * self.moe_top_k + d * self.moe_num_experts
        if self.moe_dense_residual:
            ffn += 3 * d * self.d_ff
        return emb + L * (attn + ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the evaluation grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
