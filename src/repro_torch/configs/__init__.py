"""Architecture config registry (``--arch <id>``)."""
from repro_torch.configs.base import ModelConfig, ShapeConfig, reduce_for_smoke
from repro_torch.configs.shapes import SHAPES

from repro_torch.configs import (
    starcoder2_7b, mamba2_370m, zamba2_7b, llama4_scout_17b_a16e,
    stablelm_12b, qwen2_72b, deepseek_v3_671b, gemma_7b, whisper_tiny,
    pixtral_12b,
)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    starcoder2_7b, mamba2_370m, zamba2_7b, llama4_scout_17b_a16e,
    stablelm_12b, qwen2_72b, deepseek_v3_671b, gemma_7b, whisper_tiny,
    pixtral_12b,
)}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]
