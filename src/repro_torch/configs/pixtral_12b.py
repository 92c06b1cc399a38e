"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — ViT STUBBED + Nemo backbone.

``input_specs`` supplies precomputed patch embeddings (projector output,
already at d_model) interleaved before the text tokens; the language
backbone (mistral-nemo-style dense decoder) is fully implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1e6, num_patches=1024,
    source="hf:mistralai/Pixtral-12B-2409",
)
