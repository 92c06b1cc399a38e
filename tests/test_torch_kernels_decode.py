"""repro_torch decode attention (K1) vs the JAX package's Pallas kernel and oracle.

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


def decode_inputs(seed, B, H, Hkv, T, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [normal(rng, (B, H, hd)), normal(rng, (B, Hkv, T, hd)),
            normal(rng, (B, Hkv, T, hd))]
    return [both(a, dtype) for a in arrs]


def check_decode(qkv, kpos, cur, dtype, window, block_k):
    (jq, tq), (jk, tk), (jv, tv) = qkv
    scale = tq.shape[-1] ** -0.5
    got = tops.decode_attention(tq, tk, tv, torch.from_numpy(kpos),
                                torch.from_numpy(cur), scale=scale,
                                window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(kpos),
                                   jnp.asarray(cur), scale=scale,
                                   window=window, block_k=block_k)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(kpos),
                                       jnp.asarray(cur), scale=scale,
                                       window=window)
    close(got.float(), pallas, dtype)
    close(got.float(), oracle, dtype)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,hd,bk", [
    (2, 4, 2, 256, 64, 64),
    (1, 8, 8, 128, 32, 128),
    (3, 6, 2, 512, 16, 256),
])
@pytest.mark.parametrize("window", [0, 100])
def test_decode_attention_sweep(dtype, B, H, Hkv, T, hd, bk, window):
    qkv = decode_inputs(1, B, H, Hkv, T, hd, dtype)
    cur = np.asarray([T - 1, T // 2, T // 3][:B], np.int32)
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    kpos = np.where(kpos <= cur[:, None], kpos, -1).astype(np.int32)
    check_decode(qkv, kpos, cur, dtype, window, bk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 30])
def test_decode_attention_gqa9_ring_strided(dtype, window):
    """Group of 9, a ragged ring cache (slot = pos % W, stale and empty
    slots) read as a transposed view of the model's (B, W, Hkv, hd)."""
    B, H, Hkv, W, hd = 3, 18, 2, 100, 32
    rng = np.random.default_rng(3)
    q = normal(rng, (B, H, hd))
    k = normal(rng, (B, W, Hkv, hd))
    v = normal(rng, (B, W, Hkv, hd))
    (jq, tq), (jk, tk), (jv, tv) = (both(a, dtype) for a in (q, k, v))
    qkv = [(jq, tq), (jk.transpose(0, 2, 1, 3), tk.transpose(1, 2)),
           (jv.transpose(0, 2, 1, 3), tv.transpose(1, 2))]
    cur = np.asarray([250, 40, 99], np.int32)
    kpos = np.full((B, W), -1, np.int32)
    for b in range(B):
        for p in range(cur[b] + 1):
            kpos[b, p % W] = p
    kpos[1, 60:70] = 300             # stale entries from a longer request
    check_decode(qkv, kpos, cur, dtype, window, W)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_fully_masked_rows(dtype):
    """A sequence with no kept slot (empty cache, or cur_pos < 0)
    returns mean(V) over every slot."""
    B, H, Hkv, T, hd = 3, 4, 2, 64, 16
    qkv = decode_inputs(4, B, H, Hkv, T, hd, dtype)
    cur = np.asarray([10, -1, 20], np.int32)
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    kpos[2] = -1
    got = check_decode(qkv, kpos, cur, dtype, 0, T)
    mean_v = qkv[2][1].float().mean(dim=2)              # (B, Hkv, hd)
    for b in (1, 2):
        torch.testing.assert_close(got[b].float(),
                                   mean_v[b].repeat_interleave(2, dim=0),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,Hkv,T,hd,sms,want", [
    (4, 4, 4096, 128, 132, (8, 512)),     # StarCoder2: 256 KB of cache a block
    (4, 32, 4096, 112, 132, (3, 1408)),   # Zamba2: one wave, 2 blocks an SM
    (1, 1, 100, 128, 132, (1, 128)),      # short cache: one piece
])
def test_decode_split_plan(B, Hkv, T, hd, sms, want):
    nsplit, chunk = tdec.split_plan(B, Hkv, T, hd, 2, sms)
    assert (nsplit, chunk) == want
    assert chunk % tdec.TILE == 0 and chunk <= tdec.MAX_CHUNK
    assert (nsplit - 1) * chunk < T <= nsplit * chunk
