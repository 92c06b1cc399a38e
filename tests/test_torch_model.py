"""repro_torch dense model vs the JAX reference on the same weights.

The reference's parameter tree (``unbox(repro.models.model.init)``) is
carried into the port with ``params_from_reference``; ``forward`` and
``decode_step`` logits and caches are then compared on identical
inputs.  fp32: atol/rtol 1e-4.  bf16: the two frameworks round matmul
outputs, norms and activations to bf16 at different points (XLA's CPU
backend fuses elementwise chains in fp32, eager torch rounds after each
op); on these inputs the logits differ by one bf16 ulp of the largest
logits (0.031 for StarCoder2's |logits| <= 4.3, 0.0625 for Gemma's
<= 13.3), so bf16 is held to atol = rtol = 6e-2, and greedy tokens must
agree wherever the reference's top-2 margin exceeds that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduce_for_smoke as jreduce
from repro.dist.sharding import unbox
from repro.models import model as jmodel
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models import model
from repro_torch.models.convert import params_from_reference
from repro_torch.serving.engine import _write_slot

ARCHS = ["starcoder2-7b", "gemma-7b"]
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


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "whisper-tiny",
                                  "pixtral-12b", "llama4-scout-17b-a16e"])
def test_unported_families_raise(arch):
    cfg = reduce_for_smoke(get_arch(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init_decode_cache(cfg, 1, 8, device="cpu")


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
