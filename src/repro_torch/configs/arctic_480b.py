"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — dense FFN
residual in PARALLEL with a 128-expert top-2 MoE per layer."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,            # the dense-residual FFN hidden
    vocab_size=32000,
    moe_num_experts=128,
    moe_top_k=2,
    moe_d_ff=4864,
    moe_dense_residual=True,
)
