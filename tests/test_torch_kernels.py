"""repro_torch prefill attention (K2) vs the JAX package's Pallas kernel and oracle.

On the CPU, ``repro_torch.kernels.ops`` takes the plain PyTorch version;
it is held against ``repro.kernels.ops`` (Pallas, interpret mode) and
``repro.kernels.ref`` on the same inputs, made with numpy from a seed.
Tolerances are the reference sweep's (``tests/test_kernels.py``): fp32
2e-5, bf16 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny CPU ops: more threads only contend with the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def both(x, dtype):
    """The same values as a jax array and a torch tensor (bf16 rounds the
    same way in both)."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def flash_inputs(seed, B, H, Hkv, S, T, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [normal(rng, (B, H, S, hd)), normal(rng, (B, Hkv, T, hd)),
            normal(rng, (B, Hkv, T, hd))]
    return [both(a, dtype) for a in arrs]


def check_flash(qkv, qpos, kpos, dtype, window, block_q, block_k):
    (jq, tq), (jk, tk), (jv, tv) = qkv
    hd = tq.shape[-1]
    scale = hd ** -0.5
    got = tops.flash_attention(tq, tk, tv, torch.from_numpy(qpos),
                               torch.from_numpy(kpos), scale=scale,
                               window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.flash_attention(jq, jk, jv, jnp.asarray(qpos),
                                  jnp.asarray(kpos), scale=scale,
                                  window=window, block_q=block_q,
                                  block_k=block_k)
    oracle = jref.flash_attention_ref(jq, jk, jv, jnp.asarray(qpos),
                                      jnp.asarray(kpos), scale=scale,
                                      window=window)
    close(got.float(), pallas, dtype)
    close(got.float(), oracle, dtype)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,T,hd,bq,bk", [
    (1, 2, 2, 128, 128, 32, 64, 64),
    (2, 4, 2, 256, 256, 64, 128, 128),
    (1, 8, 1, 64, 192, 16, 64, 64),     # MQA, S != T
])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_attention_sweep(dtype, B, H, Hkv, S, T, hd, bq, bk, window):
    qkv = flash_inputs(0, B, H, Hkv, S, T, hd, dtype)
    qpos = np.broadcast_to(np.arange(S, dtype=np.int32) + (T - S),
                           (B, S)).copy()
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    check_flash(qkv, qpos, kpos, dtype, window, bq, bk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [160, 256])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
def test_flash_attention_wide_head_dims(dtype, hd, H, Hkv):
    """StableLM-12B's hd 160 and Gemma-7B's hd 256, which the card runs on
    the wide kernel: S and T off its tiles (64, 96 and 128 keys), groups
    of 1 and 4."""
    B, S, T = 1, 37, 101
    qkv = flash_inputs(3, B, H, Hkv, S, T, hd, dtype)
    qpos = np.broadcast_to(np.arange(S, dtype=np.int32) + (T - S),
                           (B, S)).copy()
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    check_flash(qkv, qpos, kpos, dtype, 0, S, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
def test_flash_attention_gqa9_ragged_strided(dtype, window):
    """StarCoder2's group of 9, S and T that no tile divides, and q/k/v
    given as transposed views of (B, S, H, hd) buffers, as the model
    passes them."""
    B, H, Hkv, S, T, hd = 2, 18, 2, 37, 53, 32
    rng = np.random.default_rng(1)
    q = normal(rng, (B, S, H, hd))
    k = normal(rng, (B, T, Hkv, hd))
    v = normal(rng, (B, T, Hkv, hd))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    qkv = [(jq.transpose(0, 2, 1, 3), tq.transpose(1, 2)),
           (jk.transpose(0, 2, 1, 3), tk.transpose(1, 2)),
           (jv.transpose(0, 2, 1, 3), tv.transpose(1, 2))]
    qpos = np.broadcast_to(np.arange(S, dtype=np.int32) + (T - S),
                           (B, S)).copy()
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    check_flash(qkv, qpos, kpos, dtype, window, S, T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_fully_masked_rows(dtype):
    """Padding rows (q_pos < 0), padded keys (k_pos < 0) and a row whose
    window holds no key: a row with every key masked returns mean(V)."""
    B, H, Hkv, S, T, hd = 2, 4, 2, 16, 24, 16
    qkv = flash_inputs(2, B, H, Hkv, S, T, hd, dtype)
    qpos = np.broadcast_to(np.arange(S, dtype=np.int32) + (T - S),
                           (B, S)).copy()
    qpos[0, :3] = -1
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    kpos[1, 10:20] = -1   # batch 1: queries at 13..19 see no key in window
    got = check_flash(qkv, qpos, kpos, dtype, 4, S, T)
    mean_v = qkv[2][1].float().mean(dim=2)              # (B, Hkv, hd)
    torch.testing.assert_close(got[0, :, 0].float(),
                               mean_v[0].repeat_interleave(2, dim=0),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; only ops picks the plain
    version, and only for CPU tensors."""
    q = torch.zeros(1, 2, 4, 16)
    kv = torch.zeros(1, 2, 4, 16)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    before = (tfa.LAUNCHES, tdec.LAUNCHES)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfa.flash_attention(q, kv, kv, pos, pos, scale=0.25)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tdec.decode_attention(q[:, :, 0], kv, kv, pos,
                              torch.zeros(1, dtype=torch.int32), scale=0.25)
    tops.flash_attention(q, kv, kv, pos, pos, scale=0.25)
    assert (tfa.LAUNCHES, tdec.LAUNCHES) == before
