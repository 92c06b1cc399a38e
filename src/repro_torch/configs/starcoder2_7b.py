"""StarCoder2-7B [arXiv:2402.19173] — dense, GQA kv=4, RoPE, GELU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152,
    act="gelu", norm="layernorm", use_qkv_bias=True,
    rope_theta=1e5,
    source="arXiv:2402.19173",
)
