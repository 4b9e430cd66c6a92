"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + ONE shared
attention+MLP block applied every 6 Mamba layers (weight-shared)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,          # 2560 / 32
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,  # 54 mamba layers -> 9 shared-attn applications
)
