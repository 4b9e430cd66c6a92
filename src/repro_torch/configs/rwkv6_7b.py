"""RWKV6-7B 'Finch' [arXiv:2404.05892; hf] — attention-free, data-dependent
decay. The paper's Maclaurin technique is INAPPLICABLE here (DESIGN.md §7):
no exponential-of-inner-product exists; decode is already O(d) state."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # 4096 / 64 rwkv heads (bookkeeping only)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
)
