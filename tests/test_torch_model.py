"""repro_torch's models vs the JAX reference on the same weights.

The reference's parameter tree (``unbox(repro.models.model.init)``) is
carried into the port with ``params_from_reference``; ``forward`` and
``decode_step`` logits and caches are then compared on identical
inputs.  fp32: atol/rtol 1e-4.  bf16: the two frameworks round matmul
outputs, norms and activations to bf16 at different points (XLA's CPU
backend fuses elementwise chains in fp32, eager torch rounds after each
op); on these inputs the logits differ by one bf16 ulp of the largest
logits (0.031 for StarCoder2's |logits| <= 4.3, 0.0625 for Gemma's
<= 13.3), so bf16 is held to atol = rtol = 6e-2, and greedy tokens must
agree wherever the reference's top-2 margin exceeds that.  The MoE
families in bf16 also leave out the tokens whose router choice is a
near tie (``clear_positions``), and count them.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduce_for_smoke as jreduce
from repro.dist.sharding import unbox
from repro.models import model as jmodel
from repro_torch.configs import ARCHS as ALL_ARCHS
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models import model, moe
from repro_torch.models.convert import STACKED, _flatten, params_from_reference
from repro_torch.serving.engine import _write_slot

ARCHS = ["starcoder2-7b", "gemma-7b"]
NEW_ARCHS = ["llama4-scout-17b-a16e", "deepseek-v3-671b", "pixtral-12b",
             "whisper-tiny"]
TOL = {"float32": 1e-4, "bfloat16": 6e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: SSM and hybrid variants: the reduced configs, and a 5-layer hybrid
#: with the shared block after every 2 SSM layers (groups 2, 2 and a
#: tail of 1)
SSM_ARCHS = {"mamba2-370m": ("mamba2-370m", {}),
             "zamba2-7b": ("zamba2-7b", {}),
             "zamba2-7b-l5": ("zamba2-7b", dict(num_layers=5, attn_every=2))}


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            base, kw = SSM_ARCHS.get(arch, (arch, {}))
            kw = dict(kw, dtype=dtype)
            jcfg = dataclasses.replace(jreduce(jget_arch(base)), **kw)
            cfg = dataclasses.replace(reduce_for_smoke(get_arch(base)), **kw)
            tree = jax.tree.map(np.asarray,
                                unbox(jmodel.init(jcfg, jax.random.PRNGKey(0))))
            cache[(arch, dtype)] = (jcfg, cfg, tree,
                                    params_from_reference(cfg, tree, "cpu"))
        return cache[(arch, dtype)]

    return get


def tokens_for(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, dtype):
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def to_torch(x):
    a = np.asarray(x)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if a.dtype != np.float32 else torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_over_exactly(built, arch, dtype):
    _, cfg, tree, lm = built(arch, dtype)
    sd = lm.state_dict()
    for l in range(cfg.num_layers):
        np.testing.assert_array_equal(
            f32(sd[f"dense_layers.{l}.attn.wq"]),
            f32(tree["dense_layers"]["attn"]["wq"][l]))
        np.testing.assert_array_equal(
            f32(sd[f"dense_layers.{l}.norm1.scale"]),
            f32(tree["dense_layers"]["norm1"]["scale"][l]))
    np.testing.assert_array_equal(f32(sd["embed.tok"]),
                                  f32(tree["embed"]["tok"]))
    assert sd["embed.tok"].dtype == getattr(torch, dtype)
    assert sd["final_norm.scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_reference_layout_and_scales(built, arch):
    _, cfg, _, ref_lm = built(arch, "bfloat16")
    gen = torch.Generator().manual_seed(0)
    lm = model.init(cfg, gen, device="cpu")
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in ref_lm.state_dict().items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in lm.state_dict().items()}
    assert got == want
    wq = lm.dense_layers[0].attn.wq.float()
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    tok = lm.embed.tok.float()
    assert abs(tok.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.all(lm.final_norm.scale == 1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(built, arch, dtype):
    jcfg, cfg, tree, lm = built(arch, dtype)
    toks = tokens_for(cfg, 2, 20, 1)
    want, jcache, _ = jmodel.forward(jcfg, tree, {"tokens": jnp.asarray(toks)},
                                     return_cache=True)
    got, cache, _ = model.forward(cfg, lm, {"tokens": torch.from_numpy(toks)},
                                  return_cache=True)
    assert got.shape == (2, 20, cfg.padded_vocab)
    assert torch.isfinite(got.float()).all()
    close(got, want, dtype)
    for name in ("k", "v"):
        assert cache["dense"][name].shape == jcache["dense"][name].shape
        close(cache["dense"][name], jcache["dense"][name], dtype)
    np.testing.assert_array_equal(cache["dense"]["pos"].numpy(),
                                  np.asarray(jcache["dense"]["pos"]))
    if dtype == "bfloat16":
        # greedy tokens agree wherever the reference's top-2 margin is
        # wider than the tolerance
        w = f32(want)
        top2 = np.sort(w, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 2 * TOL[dtype]
        assert np.array_equal(got.float().argmax(-1).numpy()[clear],
                              w.argmax(-1)[clear])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(built, arch, dtype):
    """A prefill cache written into a ragged decode cache, then one
    decode step for two sequences at different positions."""
    jcfg, cfg, tree, lm = built(arch, dtype)
    B, S, max_seq = 2, 11, 32
    toks = tokens_for(cfg, B, S + 1, 2)
    _, jpre, _ = jmodel.forward(jcfg, tree,
                                {"tokens": jnp.asarray(toks[:, :S])},
                                return_cache=True)
    jcache = jmodel.merge_prefill_cache(
        jmodel.init_decode_cache(jcfg, B, max_seq), jpre)
    # sequence 1 is shorter: its last prompt slot is stale (masked by pos)
    cur = np.asarray([S, S - 1], np.int32)
    nxt = toks[np.arange(B), cur][:, None]
    want, jnew = jmodel.decode_step(jcfg, tree, jnp.asarray(nxt), jcache,
                                    jnp.asarray(cur))
    cache = jax.tree.map(to_torch, jcache)
    got, new = model.decode_step(cfg, lm, torch.from_numpy(nxt), cache,
                                 torch.from_numpy(cur))
    assert got.shape == (B, 1, cfg.padded_vocab)
    close(got, want, dtype)
    for name in ("k", "v"):
        close(new["dense"][name], jnew["dense"][name], dtype)
    np.testing.assert_array_equal(new["dense"]["pos"].numpy(),
                                  np.asarray(jnew["dense"]["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(built, arch):
    """The port alone: prefill S-1 tokens, decode the last, against the
    full forward (the reference smoke property, fp32, < 1e-3)."""
    _, cfg, _, lm = built(arch, "float32")
    S = 12
    toks = torch.from_numpy(tokens_for(cfg, 2, S, 7))
    full, _, _ = model.forward(cfg, lm, {"tokens": toks})
    _, pre, _ = model.forward(cfg, lm, {"tokens": toks[:, :S - 1]},
                              return_cache=True)
    cache = model.init_decode_cache(cfg, 2, S + 4, device="cpu")
    for b in range(2):
        one = {"dense": {k: v[:, b:b + 1] for k, v in pre["dense"].items()}}
        _write_slot(cache, one, b)
    cur = torch.full((2,), S - 1, dtype=torch.int32)
    lg, _ = model.decode_step(cfg, lm, toks[:, S - 1:], cache, cur)
    assert float((lg[:, 0] - full[:, -1]).abs().max()) < 1e-3


def test_windowed_decode_matches_windowed_forward(built):
    """A ring cache of W slots (slot = pos % W) against the windowed
    forward."""
    _, cfg, _, lm = built("starcoder2-7b", "float32")
    S, W = 12, 4
    toks = torch.from_numpy(tokens_for(cfg, 2, S, 5))
    full, _, _ = model.forward(cfg, lm, {"tokens": toks}, window=W)
    _, pre, _ = model.forward(cfg, lm, {"tokens": toks[:, :S - 1]},
                              return_cache=True, window=W)
    cache = model.init_decode_cache(cfg, 2, S + 4, window=W, device="cpu")
    for p in range(S - 1 - W, S - 1):
        for name in ("k", "v", "pos"):
            cache["dense"][name][:, :, p % W] = pre["dense"][name][:, :, p]
    cur = torch.full((2,), S - 1, dtype=torch.int32)
    lg, _ = model.decode_step(cfg, lm, toks[:, S - 1:], cache, cur, window=W)
    assert float((lg[:, 0] - full[:, -1]).abs().max()) < 1e-3
    plain, _, _ = model.forward(cfg, lm, {"tokens": toks})
    assert float((plain[:, -1] - full[:, -1]).abs().max()) > 1e-6


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_every_arch_builds_forwards_and_decodes(arch):
    """Every architecture of ``configs.ARCHS`` (its reduced variant, fp32,
    on the CPU): ``init``, a forward with its cache, the cache written
    into a decode slot and two decode steps, all finite and of the
    expected shapes (no family raises any more)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                              dtype="float32")
    lm = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: to_torch(v) for k, v in batch_for(cfg, 1, 9, 3).items()}
    S = 9 + n_patches(batch)
    logits, pre, aux = model.forward(cfg, lm, batch, return_cache=True)
    assert logits.shape == (1, S, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    assert (aux != 0) == bool(cfg.num_experts)
    cache = model.init_decode_cache(cfg, 2, 16, device="cpu")
    _write_slot(cache, pre, 1)
    for t in range(2):
        cur = torch.tensor([t, S + t], dtype=torch.int32)
        toks = torch.tensor([[1], [2 + t]])
        lg, cache = model.decode_step(cfg, lm, toks, cache, cur)
        assert lg.shape == (2, 1, cfg.padded_vocab)
        assert torch.isfinite(lg).all()


# --------------------------------------------------------------------------
# MoE (Llama-4 Scout, DeepSeek-V3 with MLA), VLM (Pixtral), audio (Whisper)
# --------------------------------------------------------------------------

def n_patches(batch):
    return batch["patches"].shape[1] if "patches" in batch else 0


def batch_for(cfg, B, S, seed):
    """numpy inputs of the family: S tokens, and the reduced Whisper's
    encoder_seq frames or 3 Pixtral patch embeddings (0.02 * normal)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["frames"] = 0.02 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = 0.02 * rng.standard_normal(
            (B, 3, cfg.d_model)).astype(np.float32)
    return batch


def jbatch(batch, dtype):
    return {k: jnp.asarray(v).astype(jnp.dtype(dtype))
            if v.dtype == np.float32 else jnp.asarray(v)
            for k, v in batch.items()}


def tbatch(batch, dtype):
    return {k: torch.from_numpy(np.array(jnp.asarray(v).astype(
        jnp.dtype(dtype)).astype(jnp.float32))).to(getattr(torch, dtype))
            if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in batch.items()}


def reference_routing(jcfg, fn):
    """Run ``fn`` (a reference model call) eagerly and return its result
    and the router probabilities of every MoE layer call, in order (the
    input of each ``jax.lax.top_k``)."""
    probs = []
    top_k = jax.lax.top_k

    def recording(x, k):
        probs.append(np.asarray(x))
        return top_k(x, k)

    with jax.disable_jit(), mock.patch.object(jax.lax, "top_k", recording):
        out = fn()
    return out, probs


def clear_positions(probs, k, B, S):
    """(B, S) positions held in bf16: a token whose k-th and (k+1)-th
    router probabilities lie within one bf16 ulp (2^-7) of the k-th may
    take the other expert in either framework, so it is left out, and
    with it every later position of its sequence when the near tie is in
    a layer before the last (attention carries it forward)."""
    clear = np.ones((B, S), bool)
    for i, p in enumerate(probs):
        q = np.sort(p.reshape(B, S, -1), axis=-1)[..., ::-1]
        tie = (q[..., k - 1] - q[..., k]) <= 2.0 ** -7 * q[..., k - 1]
        if i < len(probs) - 1:
            tie = np.maximum.accumulate(tie, axis=1)
        clear &= ~tie
    return clear


def close_where(got, want, dtype, held):
    """close() on the positions ``held`` (B, S) of (B, S, ...) leaves."""
    np.testing.assert_allclose(f32(got)[held], f32(want)[held],
                               atol=TOL[dtype], rtol=TOL[dtype])


def close_cache_at(got, want, dtype, held):
    """Every cache leaf against the reference's; (L, B, S, ...) leaves at
    the held positions, the encoder-decoder's cross cache whole."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        t = got
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape, keys
        if keys[-1] == "pos":
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
        elif keys[0] == "cross":
            close(t, leaf, dtype)
        else:
            for layer in range(leaf.shape[0]):
                close_where(t[layer], leaf[layer], dtype, held)


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_new_family_params_carry_over_exactly(built, arch, dtype):
    """Every reference leaf, layer by layer for the stacked ones, equals
    the port's parameter (MoE stacks, MLA leaves, the encoder-decoder's
    stacks and its unstacked ``enc_pos``/``enc_norm``, ``embed.pos``)."""
    _, cfg, tree, lm = built(arch, dtype)
    sd = lm.state_dict()
    n = 0
    for name, leaf in _flatten(tree).items():
        stack = next((s for s in STACKED if name.startswith(s)), None)
        if stack is None:
            np.testing.assert_array_equal(f32(sd[name]), f32(leaf))
            n += 1
            continue
        rest = name[len(stack):]
        for i in range(np.asarray(leaf).shape[0]):
            np.testing.assert_array_equal(f32(sd[f"{stack}{i}.{rest}"]),
                                          f32(leaf[i]))
            n += 1
    assert n == len(sd)
    assert sd["embed.tok"].dtype == getattr(torch, dtype)
    assert sd["final_norm.scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_family_init_has_reference_layout(built, arch):
    _, cfg, _, ref_lm = built(arch, "bfloat16")
    lm = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in ref_lm.state_dict().items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in lm.state_dict().items()}
    assert got == want
    tok = lm.embed.tok.float()
    assert abs(tok.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    if cfg.family == "audio":
        assert abs(lm.enc_pos.float().std().item() / 0.02 - 1.0) < 0.05
        assert lm.embed.pos.shape == (32_768, cfg.d_model)


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_new_family_forward_matches_reference(built, arch, dtype):
    """Logits, aux loss and every cache leaf against the reference, at the
    config's capacity factor in fp32 (the reduced MoE configs drop pairs
    here) and, in bf16, at capacity 8 with near ties left out
    (``clear_positions``)."""
    jcfg, cfg, tree, lm = built(arch, dtype)
    if dtype == "bfloat16" and cfg.num_experts:
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    batch = batch_for(cfg, 2, 12, 1)
    (want, jcache, jaux), probs = reference_routing(
        jcfg, lambda: jmodel.forward(jcfg, tree, jbatch(batch, dtype),
                                     return_cache=True))
    moe.DROPPED = 0
    got, cache, aux = model.forward(cfg, lm, tbatch(batch, dtype),
                                    return_cache=True)
    S = 12 + (3 if cfg.family == "vlm" else 0)
    assert got.shape == (2, S, cfg.padded_vocab)
    assert torch.isfinite(got.float()).all()
    held = np.ones((2, S), bool)
    if dtype == "bfloat16" and cfg.num_experts:
        held = clear_positions(probs, cfg.moe_top_k, 2, S)
        assert held.sum() >= S, held.sum()
    close_where(got, want, dtype, held)
    assert abs(float(aux) - float(jaux)) < 1e-6
    if dtype == "float32" and cfg.num_experts:
        assert moe.DROPPED > 0
    assert set(cache) == set(jcache)
    close_cache_at(cache, jcache, dtype, held)


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_new_family_decode_step_matches_reference(built, arch, dtype):
    """The reference's prefill cache merged into its decode cache, carried
    over exactly; one decode step for two sequences at different
    positions: logits and the updated caches (MLA's latent and rope keys,
    the self and the unchanged cross cache)."""
    jcfg, cfg, tree, lm = built(arch, dtype)
    B, S, max_seq = 2, 11, 32
    batch = batch_for(cfg, B, S + 1, 2)
    pre_batch = dict(batch, tokens=batch["tokens"][:, :S])
    _, jpre, _ = jmodel.forward(jcfg, tree, jbatch(pre_batch, dtype),
                                return_cache=True)
    jcache = jmodel.merge_prefill_cache(
        jmodel.init_decode_cache(jcfg, B, max_seq), jpre)
    P = 3 if cfg.family == "vlm" else 0
    cur = np.asarray([S + P, S + P - 1], np.int32)
    nxt = batch["tokens"][np.arange(B), cur - P][:, None]
    (want, jnew), probs = reference_routing(
        jcfg, lambda: jmodel.decode_step(jcfg, tree, jnp.asarray(nxt),
                                         jcache, jnp.asarray(cur)))
    cache = jax.tree.map(to_torch, jcache)
    got, new = model.decode_step(cfg, lm, torch.from_numpy(nxt), cache,
                                 torch.from_numpy(cur))
    assert new is cache
    assert got.shape == (B, 1, cfg.padded_vocab)
    held = np.ones((B, 1), bool)
    if dtype == "bfloat16" and cfg.num_experts:
        held = clear_positions(probs, cfg.moe_top_k, B, 1)
        assert held.sum() >= 1
    close_where(got, want, dtype, held)
    close_cache_at(new, jnew, dtype, np.ones((B, max_seq), bool))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_family_decode_matches_full_forward(built, arch):
    """The port alone, fp32, at ``capacity_factor=8.0`` (nothing dropped,
    as the reference's smoke test runs it): prefill S-1 tokens, write
    each sequence into its slot, decode the last token, against the full
    forward (< 1e-3)."""
    _, cfg, _, lm = built(arch, "float32")
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    S = 12
    batch = {k: to_torch(v) for k, v in batch_for(cfg, 2, S, 7).items()}
    full, _, _ = model.forward(cfg, lm, batch)
    pre_batch = dict(batch, tokens=batch["tokens"][:, :S - 1])
    _, pre, _ = model.forward(cfg, lm, pre_batch, return_cache=True)
    P = n_patches(batch)
    cache = model.init_decode_cache(cfg, 2, S + P + 4, device="cpu")
    for b in range(2):
        _write_slot(cache, jax.tree.map(lambda v: v[:, b:b + 1], pre), b)
    cur = torch.full((2,), S - 1 + P, dtype=torch.int32)
    lg, _ = model.decode_step(cfg, lm, batch["tokens"][:, S - 1:], cache,
                              cur)
    assert float((lg[:, 0] - full[:, -1]).abs().max()) < 1e-3


# --------------------------------------------------------------------------
# SSM (Mamba2) and hybrid (Zamba2) families
# --------------------------------------------------------------------------

def close_cache(got, want, dtype):
    for family, leaves in want.items():
        assert set(got[family]) == set(leaves), family
        for name, leaf in leaves.items():
            assert tuple(got[family][name].shape) == leaf.shape, name
            if name == "pos":
                np.testing.assert_array_equal(got[family][name].numpy(),
                                              np.asarray(leaf))
            else:
                close(got[family][name], leaf, dtype)


@pytest.mark.parametrize("arch", list(SSM_ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_params_carry_over_exactly(built, arch, dtype):
    _, cfg, tree, lm = built(arch, dtype)
    sd = lm.state_dict()
    assert len(lm.layers) == cfg.num_layers
    for l in range(cfg.num_layers):
        for leaf in ("in_proj", "A_log", "conv_w"):
            np.testing.assert_array_equal(
                f32(sd[f"layers.{l}.mixer.{leaf}"]),
                f32(tree["layers"]["mixer"][leaf][l]))
        np.testing.assert_array_equal(f32(sd[f"layers.{l}.norm.scale"]),
                                      f32(tree["layers"]["norm"]["scale"][l]))
    assert sd["layers.0.mixer.A_log"].dtype == torch.float32
    assert sd["layers.0.mixer.in_proj"].dtype == getattr(torch, dtype)
    assert ("shared_attn" in tree) == bool(cfg.attn_every)
    if cfg.attn_every:
        np.testing.assert_array_equal(f32(sd["shared_attn.attn.wq"]),
                                      f32(tree["shared_attn"]["attn"]["wq"]))
        np.testing.assert_array_equal(f32(sd["shared_attn.mlp.wo"]),
                                      f32(tree["shared_attn"]["mlp"]["wo"]))


@pytest.mark.parametrize("arch", list(SSM_ARCHS))
def test_ssm_init_has_reference_layout(built, arch):
    _, cfg, _, ref_lm = built(arch, "bfloat16")
    lm = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in ref_lm.state_dict().items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in lm.state_dict().items()}
    assert got == want
    mixer = lm.layers[0].mixer
    assert abs(mixer.in_proj.float().std().item() * cfg.d_model ** 0.5
               - 1.0) < 0.05
    np.testing.assert_allclose(
        mixer.A_log.numpy(), np.log(np.arange(1, cfg.ssm_nheads + 1)),
        rtol=1e-6)


@pytest.mark.parametrize("arch", list(SSM_ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_matches_reference(built, arch, dtype):
    """A 45-token prompt: one full chunk of 32 and a padded one."""
    jcfg, cfg, tree, lm = built(arch, dtype)
    toks = tokens_for(cfg, 2, 45, 1)
    want, jcache, _ = jmodel.forward(jcfg, tree, {"tokens": jnp.asarray(toks)},
                                     return_cache=True)
    got, cache, _ = model.forward(cfg, lm, {"tokens": torch.from_numpy(toks)},
                                  return_cache=True)
    assert got.shape == (2, 45, cfg.padded_vocab)
    assert torch.isfinite(got.float()).all()
    close(got, want, dtype)
    assert set(cache) == ({"ssm", "attn"} if cfg.attn_every else {"ssm"})
    close_cache(cache, jcache, dtype)


@pytest.mark.parametrize("arch", list(SSM_ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_matches_reference(built, arch, dtype):
    """A prefill cache written into a decode cache, then one decode step
    for two sequences at different positions."""
    jcfg, cfg, tree, lm = built(arch, dtype)
    B, S, max_seq = 2, 11, 32
    toks = tokens_for(cfg, B, S + 1, 2)
    _, jpre, _ = jmodel.forward(jcfg, tree,
                                {"tokens": jnp.asarray(toks[:, :S])},
                                return_cache=True)
    jcache = jmodel.merge_prefill_cache(
        jmodel.init_decode_cache(jcfg, B, max_seq), jpre)
    cur = np.asarray([S, S - 1], np.int32)
    nxt = toks[np.arange(B), cur][:, None]
    want, jnew = jmodel.decode_step(jcfg, tree, jnp.asarray(nxt), jcache,
                                    jnp.asarray(cur))
    cache = jax.tree.map(to_torch, jcache)
    got, new = model.decode_step(cfg, lm, torch.from_numpy(nxt), cache,
                                 torch.from_numpy(cur))
    assert new is cache          # updated in place
    assert got.shape == (B, 1, cfg.padded_vocab)
    close(got, want, dtype)
    close_cache(new, jnew, dtype)


@pytest.mark.parametrize("arch", list(SSM_ARCHS))
def test_ssm_decode_matches_full_forward(built, arch):
    """The port alone: prefill S-1 tokens, write each sequence into its
    slot, decode the last token, against the full forward (fp32, <
    1e-3), at prompt lengths that cross a chunk boundary (33) and that
    leave the conv window short (2)."""
    _, cfg, _, lm = built(arch, "float32")
    for S in (34, 3):
        toks = torch.from_numpy(tokens_for(cfg, 2, S, 7))
        full, _, _ = model.forward(cfg, lm, {"tokens": toks})
        _, pre, _ = model.forward(cfg, lm, {"tokens": toks[:, :S - 1]},
                                  return_cache=True)
        cache = model.init_decode_cache(cfg, 2, S + 4, device="cpu")
        for b in range(2):
            one = {fam: {k: v[:, b:b + 1] for k, v in leaves.items()}
                   for fam, leaves in pre.items()}
            _write_slot(cache, one, b)
        cur = torch.full((2,), S - 1, dtype=torch.int32)
        lg, _ = model.decode_step(cfg, lm, toks[:, S - 1:], cache, cur)
        assert float((lg[:, 0] - full[:, -1]).abs().max()) < 1e-3
