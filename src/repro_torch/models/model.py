"""Model facade: init / forward / decode for every family (port of ``repro.models.model``).

``batch`` dicts, as in the reference::

    dense|moe|ssm|hybrid: {"tokens": (B, S) integer tensor}
    audio (whisper):      {"frames": (B, encoder_seq, D), "tokens": (B, S)}
    vlm (pixtral):        {"patches": (B, P, D), "tokens": (B, S - P)}

Decode caches, built by ``init_decode_cache`` and updated in place by
``decode_step`` (``pos == -1`` marks an empty attention slot):

    dense/vlm/moe: {"dense": ..., "moe": ...} (the stacks present), each
            {"k","v": (L, B, W, Hkv, hd), "pos": (L, B, W)} or, with
            MLA, {"ckv": (L, B, W, kv_lora), "krope": (L, B, W, rope),
            "pos"}
    ssm:    {"ssm": {"conv": (L, B, 3, di+2N), "ssm": (L, B, H, P, N)}}
    hybrid: the ssm cache plus {"attn": {"k","v","pos"}} stacked over
            the shared block's groups (G, B, W, ...)
    audio:  {"self": {"k","v","pos"} over the decoder layers,
             "cross": {"k","v": (L, B, encoder_seq, Hkv, hd)}}

``params`` is the :class:`~repro_torch.models.transformer.LM` (or, for
audio, :class:`~repro_torch.models.encdec.EncDec`) built by :func:`init`
or by ``convert.params_from_reference``.

``forward`` is differentiable: training (``loss_fn``) sets the
parameters' ``requires_grad`` and backpropagates through it, the
kernels included (``kernels.ops``).  Serving builds no graph: the
parameters are frozen as built, and the engine and the serve launcher
run under ``torch.inference_mode()``.  ``remat`` recomputes each
layer in the backward pass instead of keeping its activations
(``torch.utils.checkpoint``, one layer per checkpoint), as the
reference's ``jax.checkpoint`` does.

``make_inputs``, ``merge_prefill_cache`` and ``cache_logical_axes`` are
the reference's helpers of the same names; the dry run
(``launch.dryrun``) builds its inputs and caches with them on the meta
device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import is_placed, place_tree, replicated_like
from repro_torch.models import attention as attn
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_tokens, lm_head, model_dtype


def module(cfg: ModelConfig, device=None) -> nn.Module:
    """The family's parameter container, uninitialised."""
    if cfg.family == "audio":
        return encdec_mod.EncDec(cfg, device)
    return tfm.LM(cfg, device)


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device: DeviceLike = None) -> nn.Module:
    """Random weights drawn on ``device`` (CUDA unless asked otherwise).

    ``jax.random`` cannot be reproduced in torch, so the values differ
    from ``repro.models.model.init``; the scales are the reference's.
    Without a generator, one seeded with 0 on ``device`` is used.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if cfg.family == "audio":
        return encdec_mod.init_encdec(cfg, generator, dev)
    return tfm.init_lm(cfg, generator, dev)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(cfg: ModelConfig, params: nn.Module, batch: Dict, *,
            return_cache: bool = False, remat: bool = False,
            window: Optional[int] = None):
    """Returns (logits (B, S, padded_vocab), cache or None, aux_loss);
    aux_loss is the MoE layers' load-balance loss (0.0 without
    experts).  An audio model's frames are cast to the model dtype first
    (the reference runs fp32 frames through its bf16 encoder in fp32;
    torch's products do not mix the two)."""
    tokens = batch["tokens"]
    if cfg.family == "audio":
        memory = encdec_mod.encode(params,
                                   batch["frames"].to(model_dtype(cfg)), cfg)
        h, cache = encdec_mod.decoder_forward(params, tokens, memory, cfg,
                                              return_cache=return_cache,
                                              remat=remat)
        if return_cache:
            cache = {"self": cache,
                     "cross": encdec_mod.build_cross_cache(params, memory,
                                                           cfg)}
        return lm_head(params.embed, h, cfg), cache, 0.0

    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    if cfg.family == "vlm":
        patches = batch["patches"].to(model_dtype(cfg))
        x = torch.cat([patches, embed_tokens(params.embed, tokens, cfg)],
                      dim=1)
        positions = _positions(B, x.shape[1], tokens.device)
    else:
        x = embed_tokens(params.embed, tokens, cfg, positions=positions)
    backbone = (tfm.ssm_backbone_forward if tfm.is_ssm(cfg)
                else tfm.backbone_forward)
    h, cache, aux = backbone(params, x, cfg, positions, window=window,
                             return_cache=return_cache, remat=remat)
    return lm_head(params.embed, h, cfg), cache, aux


def lm_loss(cfg: ModelConfig, logits, batch: Dict) -> torch.Tensor:
    """Next-token cross-entropy in fp32 over the padded vocabulary, as the
    reference computes it; a VLM's text positions only."""
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        logits = logits[:, batch["patches"].shape[1]:, :]
    lg = logits[:, :-1, :].float()
    tg = tokens[:, 1:].long()
    if is_placed(lg):
        # vocab-split logits: the log-sum-exp and the pick reduce each
        # device's own columns (a (B, S) all-reduce each); DTensor would
        # gather the logits for ``logsumexp`` and cannot partition a
        # gather on a split dimension
        top = lg.detach().amax(-1, keepdim=True)
        lse = (lg - top).exp().sum(-1).log() + top[..., 0]
        cols = replicated_like(lg, torch.arange(lg.shape[-1],
                                                device=lg.device))
        picked = torch.where(cols == tg[..., None], lg, 0.0).sum(-1)
    else:
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, -1, tg[..., None])[..., 0]
    return torch.mean(lse - picked)


def loss_fn(cfg: ModelConfig, params: nn.Module, batch: Dict, *,
            remat: bool = False) -> torch.Tensor:
    """The training loss: ``lm_loss`` plus the MoE aux loss."""
    logits, _, aux = forward(cfg, params, batch, remat=remat)
    return lm_loss(cfg, logits, batch) + aux


def decode_step(cfg: ModelConfig, params: nn.Module, tokens, cache, cur_pos,
                *, window: Optional[int] = None):
    """tokens: (B, 1); cur_pos: (B,).  Returns (logits, cache), the cache
    updated in place (an audio model's ``cross`` cache is only read)."""
    if cfg.family == "audio":
        h, _ = encdec_mod.decoder_decode(params, tokens, cfg, cache["self"],
                                         cache["cross"], cur_pos)
        return lm_head(params.embed, h, cfg), cache
    x = embed_tokens(params.embed, tokens, cfg, positions=cur_pos[:, None])
    backbone = (tfm.ssm_backbone_decode if tfm.is_ssm(cfg)
                else tfm.backbone_decode)
    h, cache = backbone(params, x, cfg, cache, cur_pos, window=window)
    return lm_head(params.embed, h, cfg), cache


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      window: Optional[int] = None,
                      device: DeviceLike = None, mesh=None,
                      rules=None) -> Dict:
    """Empty stacked cache on ``device`` (CUDA unless asked otherwise);
    with a ``mesh``, each leaf placed by ``rules`` and its
    ``cache_logical_axes``."""
    if mesh is not None:
        cache = init_decode_cache(cfg, batch, max_seq, window, device)
        return place_tree(cache, cache_logical_axes(cache), mesh, rules)
    dev = resolve_device(device)
    if cfg.family == "audio":
        kv = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
              cfg.head_dim)
        dt = model_dtype(cfg)
        return {"self": attn.init_cache(cfg, batch, max_seq, window,
                                        layers=cfg.num_layers, device=dev),
                "cross": {"k": torch.zeros(kv, dtype=dt, device=dev),
                          "v": torch.zeros(kv, dtype=dt, device=dev)}}
    if not tfm.is_ssm(cfg):
        n_dense, n_moe = tfm.layer_counts(cfg)
        return {key: attn.init_cache(cfg, batch, max_seq, window, layers=n,
                                     device=dev)
                for key, n in (("dense", n_dense), ("moe", n_moe)) if n}
    cache = {"ssm": ssm_mod.init_ssm_cache(cfg, batch,
                                           layers=cfg.num_layers, device=dev)}
    if cfg.family == "hybrid":
        cache["attn"] = attn.init_cache(
            cfg, batch, max_seq, window,
            layers=len(tfm._hybrid_groups(cfg)), device=dev)
    return cache


def merge_prefill_cache(decode_cache: Dict, prefill_cache: Dict) -> Dict:
    """Write a prefill-produced cache into the (larger) decode cache's
    slots in place and return it.  Leaves of equal shape are copied;
    leaves differing along one axis (the sequence axis) are written at
    offset 0 of that axis."""
    for name, dst in decode_cache.items():
        src = prefill_cache[name]
        if isinstance(dst, dict):
            merge_prefill_cache(dst, src)
            continue
        diff = [i for i, (a, b) in enumerate(zip(dst.shape, src.shape))
                if a != b]
        if len(diff) > 1 or dst.ndim != src.ndim:
            raise ValueError(f"{name}: cannot write {tuple(src.shape)} into "
                             f"{tuple(dst.shape)}")
        view = dst.narrow(diff[0], 0, src.shape[diff[0]]) if diff else dst
        view.copy_(src)
    return decode_cache


def cache_logical_axes(cache: Dict, _path=()) -> Dict:
    """A decode cache's logical axis tuples, leaf by leaf (by leaf name
    and rank, as the reference's): every leaf leads with the stacked
    layer axis."""
    out = {}
    for name, leaf in cache.items():
        path = _path + (name,)
        if isinstance(leaf, dict):
            out[name] = cache_logical_axes(leaf, path)
            continue
        extra = ("layer",)
        if name in ("k", "v"):
            if "cross" in path:
                # encoder cross-KV: fixed encoder_seq (e.g. 1500), not
                # shardable over the data axes; replicate the seq dim
                out[name] = extra + ("batch", None, "kv_heads", "head_dim")
            else:
                out[name] = extra + ("batch", "kv_seq", "kv_heads",
                                     "head_dim")
        elif name == "ckv":
            out[name] = extra + ("batch", "kv_seq", "lora")
        elif name == "krope":
            out[name] = extra + ("batch", "kv_seq", None)
        elif name == "pos":
            out[name] = extra + ("batch", "kv_seq")
        elif name == "conv":
            out[name] = extra + ("batch", None, "ssm_inner")
        elif name == "ssm":
            out[name] = extra + ("batch", "ssm_heads", None, "state")
        else:
            out[name] = (None,) * leaf.ndim
    return out


def make_inputs(cfg: ModelConfig, batch: int, seq_len: int, *,
                device: DeviceLike,
                generator: Optional[torch.Generator] = None,
                mesh=None, rules=None) -> Dict:
    """Model inputs with the reference's keys, shapes and dtypes: int32
    tokens, frames or patches in the model dtype (a VLM's ``Pn =
    min(num_patches, max(1, seq_len // 4))`` patches and ``seq_len - Pn``
    tokens).  Without ``generator``, empty tensors on ``device`` (shapes
    only: ``"meta"`` for the dry run); with one, tokens uniform in the
    vocabulary and embeddings 0.02 * normal, drawn on ``device``.  With
    a ``mesh``, each placed by ``rules`` over ``batch`` (every rank
    draws them alike)."""
    if mesh is not None:
        inputs = make_inputs(cfg, batch, seq_len, device=device,
                             generator=generator)
        return place_tree(inputs, batch_axes(inputs), mesh, rules)
    dev = resolve_device(device)
    dt = model_dtype(cfg)

    def tok(shape):
        if generator is None:
            return torch.empty(shape, dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                             dtype=torch.int32, device=dev)

    def emb(shape):
        if generator is None:
            return torch.empty(shape, dtype=dt, device=dev)
        return (torch.randn(shape, generator=generator, device=dev)
                * 0.02).to(dt)

    if cfg.family == "audio":
        return {"frames": emb((batch, cfg.encoder_seq, cfg.d_model)),
                "tokens": tok((batch, seq_len))}
    if cfg.family == "vlm":
        Pn = min(cfg.num_patches, max(1, seq_len // 4))
        return {"patches": emb((batch, Pn, cfg.d_model)),
                "tokens": tok((batch, seq_len - Pn))}
    return {"tokens": tok((batch, seq_len))}


def batch_axes(batch: Dict) -> Dict:
    """A batch's logical axes: ``batch`` first, every other dim None."""
    return {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in batch.items()}
