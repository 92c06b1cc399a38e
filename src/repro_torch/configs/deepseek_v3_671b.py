"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA, 1 shared + 256 routed top-8.

First 3 layers dense (d_ff=18432), remaining 58 MoE with per-expert
hidden 2048. MLA compresses the KV cache to kv_lora_rank + rope dims.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129280,
    use_mla=True,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    num_experts=256, num_shared_experts=1, moe_top_k=8, moe_d_ff=2048,
    num_dense_layers=3,
    source="arXiv:2412.19437",
)
