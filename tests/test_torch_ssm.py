"""repro_torch SSD pieces vs the JAX package: K3's plain version, ssd_chunked, one mixer.

Inputs are made with numpy from a seed and handed to both sides.  K3's
plain version is held to ``repro.kernels.ref`` and to the Pallas kernel
in interpret mode (``repro.kernels.ops``) at the reference sweep's
atol 1e-6 (``tests/test_kernels.py``); ``ssd_chunked`` to the
reference's in fp32 at 1e-5 (einsums summed in another order); one
``SSM`` mixer's prefill and decode to the reference on carried weights
in fp32 at 1e-4 (the model tolerance of ``tests/test_torch_model.py``)
and in bf16 at 1e-3 (both sides round the same ops).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduce_for_smoke as jreduce
from repro.dist.sharding import unbox
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as tssm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: mixer-level tolerances, atol = rtol: the decode step, and the prefill
#: (in bf16 the chunked SSD's einsums round in another order than XLA's,
#: so a few outputs differ by one bf16 ulp; 3e-2 is the bf16 kernel
#: tolerance of ``tests/test_kernels.py``)
MIXER_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
PREFILL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def scan_inputs(seed, b, c, h, p, n, decay="uniform"):
    rng = np.random.default_rng(seed)
    st, s0 = normal(rng, (b, c, h, p, n)), normal(rng, (b, h, p, n))
    dec = {"uniform": rng.uniform(size=(b, c, h)),
           "zero": np.zeros((b, c, h)),
           "one": np.ones((b, c, h))}[decay].astype(np.float32)
    return st, dec, s0


SCAN_SHAPES = [(1, 4, 2, 8, 16), (2, 8, 3, 16, 32), (1, 16, 1, 32, 8),
               (2, 1, 3, 8, 16)]


@pytest.mark.parametrize("b,c,h,p,n", SCAN_SHAPES)
@pytest.mark.parametrize("decay", ["uniform", "zero", "one"])
def test_ssd_scan_plain_matches_reference_and_pallas(b, c, h, p, n, decay):
    st, dec, s0 = scan_inputs(b * 100 + c, b, c, h, p, n, decay)
    n_launch = tssd.LAUNCHES
    prev, fin = tops.ssd_state_scan(*map(torch.from_numpy, (st, dec, s0)))
    assert tssd.LAUNCHES == n_launch     # CPU tensors take the plain version
    assert prev.shape == (b, c, h, p, n) and fin.shape == (b, h, p, n)
    np.testing.assert_array_equal(prev[:, 0].numpy(), s0)
    for want_prev, want_fin in (jref.ssd_state_scan_ref(st, dec, s0),
                                jops.ssd_state_scan(st, dec, s0)):
        np.testing.assert_allclose(prev.numpy(), np.asarray(want_prev),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(fin.numpy(), np.asarray(want_fin),
                                   atol=1e-6, rtol=0)
    if decay == "zero":   # exp(sum dt*A) underflowed: exact states, no NaN
        np.testing.assert_array_equal(prev[:, 1:].numpy(), st[:, :-1])
        np.testing.assert_array_equal(fin.numpy(), st[:, -1])


def test_ssd_scan_kernel_wrapper_raises_on_cpu_tensors():
    st, dec, s0 = map(torch.from_numpy, scan_inputs(0, 1, 2, 2, 4, 8))
    with pytest.raises(ValueError, match="not the CUDA device"):
        tssd.ssd_state_scan(st, dec, s0)


def ssd_inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x = normal(rng, (b, l, h, p))
    dt = np.log1p(np.exp(normal(rng, (b, l, h))))          # softplus
    A = -np.exp(0.3 * normal(rng, (h,)))
    Bm, Cm = normal(rng, (b, l, n)), normal(rng, (b, l, n))
    s0 = normal(rng, (b, h, p, n))
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("l,chunk", [(50, 16), (64, 16), (7, 32), (1, 8)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(l, chunk, with_state):
    x, dt, A, Bm, Cm, s0 = ssd_inputs(l, 2, l, 4, 16, 32)
    init = s0 if with_state else None
    want_y, want_f = jssm.ssd_chunked(x, dt, A, Bm, Cm, chunk,
                                      initial_state=init)
    t = torch.from_numpy
    got_y, got_f = tssm.ssd_chunked(
        t(x), t(dt), t(A), t(Bm), t(Cm), chunk,
        initial_state=None if init is None else t(init))
    assert got_y.shape == (2, l, 4, 16) and got_f.shape == (2, 4, 16, 32)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _mixer(dtype):
    """One Mamba2 mixer of the reduced Mamba2-370M in ``dtype``, the
    reference's weights carried into the port's ``SSM`` (bf16 rounds the
    same fp32 draws to the same values on both sides)."""
    jcfg = dataclasses.replace(jreduce(jget_arch("mamba2-370m")),
                               dtype=dtype)
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("mamba2-370m")),
                              dtype=dtype)
    f32 = dataclasses.replace(jcfg, dtype="float32")
    tree = jax.tree.map(np.asarray,
                        unbox(jssm.init_ssm(f32, jax.random.PRNGKey(4))))
    # a non-trivial conv bias (the reference initialises it to zero)
    rng = np.random.default_rng(9)
    tree["conv_b"] = normal(rng, tree["conv_b"].shape) * 0.1
    mod = tssm.SSM(cfg, "cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(tree[name])))
    like = unbox(jssm.init_ssm(jcfg, jax.random.PRNGKey(4)))
    jtree = {k: jnp.asarray(v).astype(like[k].dtype)
             for k, v in tree.items()}
    return jcfg, cfg, jtree, mod


@pytest.fixture(scope="module")
def mixer():
    """The fp32 mixer, with the reference's weights as numpy arrays."""
    jcfg, cfg, jtree, mod = _mixer("float32")
    return jcfg, cfg, {k: np.asarray(v) for k, v in jtree.items()}, mod


def test_ssm_param_layout_matches_reference(mixer):
    _, cfg, tree, mod = mixer
    got = {k: tuple(v.shape) for k, v in mod.named_parameters()}
    assert got == {k: v.shape for k, v in tree.items()}
    fresh = tssm.SSM(dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    for name in ("A_log", "D", "dt_bias", "gate_norm"):
        assert getattr(fresh, name).dtype == torch.float32
    for name in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert getattr(fresh, name).dtype == torch.bfloat16
    np.testing.assert_allclose(fresh.A_log.numpy(), tree["A_log"])
    dt = torch.nn.functional.softplus(fresh.dt_bias)
    assert torch.all((dt > 0.00099) & (dt < 0.101))


@pytest.mark.parametrize("dtype,L", [
    ("float32", 1), ("float32", 2), ("float32", 3), ("float32", 45),
    ("bfloat16", 1), ("bfloat16", 3), ("bfloat16", 45)])
def test_ssm_forward_and_decode_match_reference(dtype, L):
    """Prefill of L tokens with its cache (left-padded conv window when
    L < 3), then one decode step from that cache, held to the reference
    at ``MIXER_TOL``: the decode conv runs in fp32 on both sides."""
    jcfg, cfg, tree, mod = _mixer(dtype)
    rng = np.random.default_rng(L)
    x = normal(rng, (2, L + 1, cfg.d_model))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))

    def close(got, want, tol):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol[dtype], rtol=tol[dtype])

    want, jcache = jssm.ssm_forward(tree, jx[:, :L], jcfg,
                                    return_cache=True)
    got, cache = tssm.ssm_forward(mod, tx[:, :L], cfg, return_cache=True)
    close(got, want, PREFILL_TOL)
    for name in ("conv", "ssm"):
        assert cache[name].shape == jcache[name].shape
        close(cache[name], jcache[name], PREFILL_TOL)
    want, jnew = jssm.ssm_decode(tree, jx[:, L:], jcfg, jcache)
    got, new = tssm.ssm_decode(mod, tx[:, L:], cfg, cache)
    assert new is cache          # updated in place
    assert got.dtype == tx.dtype
    close(got, want, MIXER_TOL)
    for name in ("conv", "ssm"):
        close(new[name], jnew[name], MIXER_TOL)


def test_ssm_forward_with_initial_state_matches_reference(mixer):
    jcfg, cfg, tree, mod = mixer
    rng = np.random.default_rng(11)
    x = normal(rng, (2, 40, cfg.d_model))
    s0 = normal(rng, (2, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state))
    want, _ = jssm.ssm_forward(tree, x, jcfg, initial_state={"ssm": s0})
    got, _ = tssm.ssm_forward(mod, torch.from_numpy(x), cfg,
                              initial_state={"ssm": torch.from_numpy(s0)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
