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


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            jcfg = dataclasses.replace(jreduce(jget_arch(arch)), dtype=dtype)
            cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                                      dtype=dtype)
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


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-370m",
                                  "zamba2-7b", "whisper-tiny",
                                  "pixtral-12b", "llama4-scout-17b-a16e"])
def test_unported_families_raise(arch):
    cfg = reduce_for_smoke(get_arch(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init_decode_cache(cfg, 1, 8, device="cpu")
