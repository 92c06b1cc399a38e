"""Whisper-tiny [arXiv:2212.04356] — enc-dec; conv frontend STUBBED.

``input_specs`` supplies precomputed (batch, 1500, 384) frame embeddings;
we implement the transformer encoder + decoder (self-attn KV cache +
fixed cross-attn cache during decode).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6, head_dim=64,
    d_ff=1536, vocab_size=51865,
    act="gelu", norm="layernorm", pos_emb="learned",
    is_encoder_decoder=True, encoder_layers=4, encoder_seq=1500,
    source="arXiv:2212.04356",
)
