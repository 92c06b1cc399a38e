"""Llama-4 Scout 17B-A16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE 16e top-1."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=16, num_shared_experts=1, moe_top_k=1, moe_d_ff=8192,
    rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
