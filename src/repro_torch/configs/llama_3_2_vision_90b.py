"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision scaled] —
100 layers: cross-attention to image tokens every 5th layer (20 cross +
80 self). Vision frontend is a STUB: input_specs() provides precomputed
patch embeddings (B, 4096, d)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,   # 100 // 5 = 20 cross-attn layers
    n_image_tokens=4096,
)
