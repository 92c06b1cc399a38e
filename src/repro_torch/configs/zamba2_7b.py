"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention block.

81 Mamba2 layers at d_model=3584 with one weight-shared attention+MLP block
applied every ``attn_every`` Mamba blocks (Zamba2's shared-block design).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6,
    source="arXiv:2411.15242",
)
