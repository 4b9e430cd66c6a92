"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128-expert top-8 MoE,
per-expert FFN hidden 768, GQA 32/4, head_dim 128."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,             # listed d_ff == per-expert hidden
    vocab_size=151936,
    moe_num_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
)
