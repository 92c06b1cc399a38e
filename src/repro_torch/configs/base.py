"""Config system: architecture + input-shape configs.

Every assigned architecture has one ``<arch>.py`` module exporting
``CONFIG`` (the exact assigned full-size config) built from
:class:`ModelConfig`.  ``reduce_for_smoke`` derives the CPU-runnable
reduced variant used by tests (2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    source: str = ""                 # citation for the config

    # --- norm / activation / embeddings -----------------------------------
    act: str = "silu"                # silu | gelu | geglu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    use_qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"            # rope | learned | none
    norm_eps: float = 1e-6

    # --- attention variants ------------------------------------------------
    use_mla: bool = False
    mla: Optional[MLAConfig] = None
    sliding_window: int = 0          # 0 = full attention (may be overridden
                                     # per-shape for long-context decode)

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0             # routed experts (0 = dense FFN)
    num_shared_experts: int = 0
    moe_top_k: int = 1
    moe_d_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    num_dense_layers: int = 0        # leading dense layers (deepseek: 3)
    router_aux_coef: float = 0.001

    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: 1 shared attn block per N
                                     # mamba blocks (zamba2-style)

    # --- encoder-decoder (whisper) ------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # stubbed conv-frontend output frames

    # --- VLM -----------------------------------------------------------------
    num_patches: int = 0             # stubbed vision-tower patch embeddings
                                     # prepended to the token sequence

    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 512

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.use_mla and self.mla is None:
            object.__setattr__(self, "mla", MLAConfig())

    # ------------------------------------------------------------------ utils
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6ND)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k routed experts)."""
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.use_mla:
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        p = d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk_head
        p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
        p += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
        p += cfg.num_heads * m.v_head_dim * d
        return p
    hd = cfg.head_dim
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    return q + kv + o


def _ffn_params(d_model: int, d_ff: int, act: str) -> int:
    n_in = 3 if act in ("silu", "geglu") else 2  # gated acts: up+gate+down
    return n_in * d_model * d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    d, di, ns, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    # in_proj -> [z, x, B, C, dt], out_proj, conv (ignored, small), A/D/dt_bias
    p = d * (2 * di + 2 * ns + nh)
    p += di * d
    p += 2 * nh + nh
    return p


def _layer_params(cfg: ModelConfig, moe_layer: bool) -> int:
    p = 2 * cfg.d_model  # two norms
    if cfg.family == "ssm" or (cfg.family == "hybrid" and True):
        pass
    if moe_layer:
        ffn = (cfg.num_experts + cfg.num_shared_experts) * _ffn_params(
            cfg.d_model, cfg.moe_d_ff, cfg.act)
        ffn += cfg.d_model * cfg.num_experts  # router
    else:
        ffn = _ffn_params(cfg.d_model, cfg.d_ff, cfg.act)
    return p + _attn_params(cfg) + ffn


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    total = cfg.padded_vocab * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab * d
    if cfg.family == "ssm":
        per = 2 * d + _ssm_params(cfg)
        total += cfg.num_layers * per
    elif cfg.family == "hybrid":
        per = 2 * d + _ssm_params(cfg)
        total += cfg.num_layers * per
        # one shared attention+mlp block
        total += _attn_params(cfg) + _ffn_params(d, cfg.d_ff, cfg.act) + 2 * d
    elif cfg.num_experts > 0:
        n_moe = cfg.num_layers - cfg.num_dense_layers
        dense = cfg.num_dense_layers * _layer_params(cfg, moe_layer=False)
        if active_only:
            per_tok_ffn = ((cfg.moe_top_k + cfg.num_shared_experts)
                           * _ffn_params(d, cfg.moe_d_ff, cfg.act)
                           + d * cfg.num_experts)
            moe = n_moe * (2 * d + _attn_params(cfg) + per_tok_ffn)
        else:
            moe = n_moe * _layer_params(cfg, moe_layer=True)
        total += dense + moe
    else:
        total += cfg.num_layers * _layer_params(cfg, moe_layer=False)
        if cfg.is_encoder_decoder:
            # encoder layers + cross-attention in decoder layers
            enc = cfg.encoder_layers * _layer_params(cfg, moe_layer=False)
            xattn = cfg.num_layers * (_attn_params(cfg) + d)
            total += enc + xattn
    return int(total)


# --------------------------------------------------------------------------
# Input shapes (assigned)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """CPU-runnable reduced variant of the same family (tests only)."""
    d_model = min(cfg.d_model, 256)
    num_heads = max(2, min(cfg.num_heads, 4))
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    if cfg.num_kv_heads == cfg.num_heads:
        num_kv = num_heads
    head_dim = max(8, d_model // num_heads)
    kw = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        vocab_pad_multiple=64,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
    )
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 4),
                  moe_top_k=min(cfg.moe_top_k, 2),
                  moe_d_ff=min(cfg.moe_d_ff, 256),
                  num_dense_layers=min(cfg.num_dense_layers, 1))
    if cfg.use_mla:
        kw.update(mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                qk_nope_head_dim=16, qk_rope_head_dim=8,
                                v_head_dim=16))
    if cfg.ssm_state:
        kw.update(ssm_state=min(cfg.ssm_state, 32), ssm_headdim=16,
                  ssm_chunk=32)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.is_encoder_decoder:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.num_patches:
        kw.update(num_patches=8)
    return replace(cfg, name=cfg.name + "-smoke", **kw)
