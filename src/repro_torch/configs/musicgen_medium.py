"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only transformer over
EnCodec tokens (vocab 2048). The EnCodec codec frontend is a STUB: the
model consumes the post-codec token stream (codebook-interleaved)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
)
