"""Architecture registry: ``get_config(name)`` / ``ARCHS``."""

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES
from repro_torch.configs import (
    zamba2_2_7b,
    phi3_mini_3_8b,
    smollm_135m,
    yi_34b,
    qwen2_0_5b,
    rwkv6_7b,
    qwen3_moe_30b_a3b,
    arctic_480b,
    llama_3_2_vision_90b,
    musicgen_medium,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        zamba2_2_7b.CONFIG,
        phi3_mini_3_8b.CONFIG,
        smollm_135m.CONFIG,
        yi_34b.CONFIG,
        qwen2_0_5b.CONFIG,
        rwkv6_7b.CONFIG,
        qwen3_moe_30b_a3b.CONFIG,
        arctic_480b.CONFIG,
        llama_3_2_vision_90b.CONFIG,
        musicgen_medium.CONFIG,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config"]
