"""repro_torch's MoE FFN vs ``repro.models.moe.apply_moe`` on the same weights.

The reference's ``init_moe`` tree is carried into the port's ``MoE``
leaf by leaf; inputs are made from a seed with numpy.  fp32: atol =
rtol = 1e-4, the aux loss to 1e-6.  bf16: 6e-2, as the dense family's
model test, and only for tokens clear of a near tie: where the
reference's k-th and (k+1)-th router probabilities lie within one bf16
ulp (2^-7) of the k-th, rounding may pick the other expert in either
framework (on the reduced DeepSeek-V3, two of 288 token-layers flipped
over 12 seeds, at relative margins 1.3e-3 and 1.9e-3), so those tokens
are left out and counted; the bf16 prefill runs at capacity 8 so that
no token's output depends on another's routing.  Dropping at capacity
is held in fp32.
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
from repro.models import moe as jmoe
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.models import moe
from repro_torch.models.convert import _flatten, _tensor

ARCHS = ["llama4-scout-17b-a16e", "deepseek-v3-671b"]
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
NEAR_TIE = 2.0 ** -7      # one bf16 ulp of the k-th gate, relative


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(arch, dtype, **overrides):
    """(reference cfg, tree, port cfg, port MoE) on the same weights."""
    kw = dict(overrides, dtype=dtype)
    jcfg = dataclasses.replace(jreduce(jget_arch(arch)), **kw)
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), **kw)
    tree = jax.tree.map(np.asarray,
                        unbox(jmoe.init_moe(jcfg, jax.random.PRNGKey(3))))
    m = moe.MoE(cfg, "cpu")
    params = dict(m.named_parameters())
    leaves = _flatten(tree)
    assert set(leaves) == set(params)
    with torch.no_grad():
        for name, leaf in leaves.items():
            params[name].copy_(_tensor(leaf).to(params[name].dtype))
    return jcfg, tree, cfg, m


def hidden(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def run_both(arch, dtype, x, decode, **overrides):
    jcfg, tree, cfg, m = both(arch, dtype, **overrides)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    want, jaux = jmoe.apply_moe(tree, jx, jcfg, decode=decode)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    moe.DROPPED = 0
    got, aux = moe.apply_moe(m, tx, cfg, decode=decode)
    probs = np.asarray(jax.nn.softmax(
        jx.reshape(-1, cfg.d_model).astype(jnp.float32) @ tree["router"],
        axis=-1))
    return cfg, np.asarray(want, np.float32), float(jaux), got, aux, probs


def clear_tokens(probs, k):
    """Tokens whose k-th and (k+1)-th router probabilities differ by more
    than NEAR_TIE of the k-th."""
    p = np.sort(probs, axis=-1)[:, ::-1]
    return (p[:, k - 1] - p[:, k]) > NEAR_TIE * p[:, k - 1]


def reference_drops(probs, cfg):
    """(token, expert) pairs the reference's own routing drops at
    capacity: ceil(T*K/E * capacity_factor) per expert."""
    T, K, E = probs.shape[0], cfg.moe_top_k, cfg.num_experts
    _, eidx = jax.lax.top_k(jnp.asarray(probs), K)
    counts = np.bincount(np.asarray(eidx).ravel(), minlength=E)
    C = max(1, int(np.ceil(T * K / E * cfg.capacity_factor)))
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_dispatch_matches_reference(arch):
    """fp32 capacity dispatch at the config's capacity factor (1.25)."""
    x = hidden(reduce_for_smoke(get_arch(arch)), 2, 12, 1)
    cfg, want, jaux, got, aux, probs = run_both(arch, "float32", x, False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert isinstance(aux, torch.Tensor) and aux.dtype == torch.float32
    assert abs(float(aux) - jaux) < 1e-6
    assert moe.DROPPED == reference_drops(probs, cfg)


def test_reference_drops_tokens_and_port_drops_the_same():
    """The reduced DeepSeek-V3 (E 4, top 2, capacity 1.25: C = 15 of 24
    tokens) over 24 tokens that share one direction, so that most pick
    the same two experts: the reference's own routing drops pairs; the
    port drops as many and agrees on every token's output."""
    cfg = reduce_for_smoke(get_arch("deepseek-v3-671b"))
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(cfg.d_model)
         + 0.5 * hidden(cfg, 2, 12, 5)).astype(np.float32)
    cfg, want, jaux, got, aux, probs = run_both("deepseek-v3-671b",
                                                "float32", x, False)
    dropped = reference_drops(probs, cfg)
    assert dropped >= 1
    assert moe.DROPPED == dropped
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert abs(float(aux) - jaux) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_gather_matches_reference(arch, dtype):
    """Decode gathers each token's experts (no capacity, aux 0.0)."""
    x = hidden(reduce_for_smoke(get_arch(arch)), 4, 1, 2)
    cfg, want, jaux, got, aux, probs = run_both(arch, dtype, x, True)
    assert aux == 0.0 and jaux == 0.0
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    held = clear_tokens(probs, cfg.moe_top_k) if dtype == "bfloat16" \
        else np.ones(4, bool)
    assert held.sum() >= 3
    np.testing.assert_allclose(got.float().numpy()[held[:, None]],
                               want[held[:, None]], atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_matches_reference_off_near_ties(arch):
    """bf16 dispatch at capacity 8 (nothing dropped): every token clear
    of a near tie within 6e-2; most tokens are clear."""
    x = hidden(reduce_for_smoke(get_arch(arch)), 2, 16, 4)
    cfg, want, jaux, got, aux, probs = run_both(arch, "bfloat16", x, False,
                                                capacity_factor=8.0)
    held = clear_tokens(probs, cfg.moe_top_k).reshape(2, 16)
    assert held.sum() >= 28, held.sum()
    np.testing.assert_allclose(got.float().numpy()[held], want[held],
                               atol=6e-2, rtol=6e-2)
    assert moe.DROPPED == 0
    assert abs(float(aux) - jaux) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_gather_path_equals_dispatch_without_drops(arch):
    """The port alone: decode's per-token gather and the prefill dispatch
    at a capacity that drops nothing give the same rows (fp32)."""
    _, _, cfg, m = both(arch, "float32", capacity_factor=8.0)
    x = torch.from_numpy(hidden(cfg, 3, 7, 6))
    moe.DROPPED = 0
    y_dispatch, _ = moe.apply_moe(m, x, cfg)
    y_gather, _ = moe.apply_moe(m, x, cfg, decode=True)
    assert moe.DROPPED == 0
    torch.testing.assert_close(y_gather, y_dispatch, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_reference_layout_and_scales(arch):
    """Drawn expert by expert with the reference's scales: 1/sqrt(d) for
    the router, wi and wg, 1/sqrt(moe_d_ff) for wo."""
    _, tree, cfg, ref_m = both(arch, "bfloat16")
    m = moe.MoE(cfg, "cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    want = {k: (tuple(v.shape), v.dtype) for k, v in ref_m.state_dict().items()}
    got = {k: (tuple(v.shape), v.dtype) for k, v in m.state_dict().items()}
    assert got == want
    assert m.router.dtype == torch.float32
    for w, fan_in in ((m.router, cfg.d_model), (m.wi, cfg.d_model),
                      (m.wg, cfg.d_model), (m.wo, cfg.moe_d_ff)):
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1.0) < 0.05
    assert not torch.equal(m.wi[0], m.wi[1])
