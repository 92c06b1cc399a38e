"""Mamba2-370M [arXiv:2405.21060] — attention-free SSM, SSD algorithm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    source="arXiv:2405.21060",
)
