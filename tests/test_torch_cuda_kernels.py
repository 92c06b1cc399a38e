"""The CUDA kernels of repro_torch against their plain versions, on the card.

Every test here needs a CUDA device and ``nvcc`` (the kernels are built
from ``src/repro_torch/kernels/csrc`` at first use) and skips without
one.  The file imports no JAX, so it runs on a machine without it::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: fp32 2e-5 (both sides compute in fp32, no TF32), bf16 3e-2
(one bf16 ulp of outputs up to 4 in magnitude, both sides accumulating
in fp32).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.launch.serve import make_requests
from repro_torch.models import model
from repro_torch.serving.engine import ServingEngine

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(dev, shape, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, dtype))


def close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,T,hd,window", [
    (1, 36, 4, 300, 300, 128, 0),      # StarCoder2 widths, ragged S = T
    (2, 18, 2, 37, 53, 32, 16),        # S != T, windowed
    (1, 16, 16, 130, 130, 256, 0),     # Gemma: hd 256, g = 1
    (2, 4, 4, 70, 70, 64, 0),          # smoke configs' hd
])
def test_flash_kernel_matches_plain(dev, dtype, B, H, Hkv, S, T, hd, window):
    q = randn(dev, (B, S, H, hd), dtype, 1).transpose(1, 2)
    k = randn(dev, (B, T, Hkv, hd), dtype, 2).transpose(1, 2)
    v = randn(dev, (B, T, Hkv, hd), dtype, 3).transpose(1, 2)
    qpos = (torch.arange(S, device=dev) + (T - S)).expand(B, S)
    kpos = torch.arange(T, device=dev).expand(B, T)
    n = tfa.LAUNCHES
    got = tfa.flash_attention(q, k, v, qpos, kpos, scale=hd ** -0.5,
                              window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == n + 1
    want = tref.flash_attention_ref(q, k, v, qpos, kpos, scale=hd ** -0.5,
                                    window=window)
    assert got.shape == want.shape and got.dtype == want.dtype
    close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_fully_masked_rows(dev, dtype):
    B, H, Hkv, S, T, hd = 2, 8, 2, 90, 90, 128
    q = randn(dev, (B, H, S, hd), dtype, 4)
    k = randn(dev, (B, Hkv, T, hd), dtype, 5)
    v = randn(dev, (B, Hkv, T, hd), dtype, 6)
    qpos = torch.arange(S, device=dev, dtype=torch.int32).repeat(B, 1)
    qpos[0, :5] = -1
    kpos = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
    kpos[1, 20:70] = -1
    got = tfa.flash_attention(q, k, v, qpos, kpos, scale=hd ** -0.5,
                              window=16)
    want = tref.flash_attention_ref(q, k, v, qpos, kpos, scale=hd ** -0.5,
                                    window=16)
    close(got, want, dtype)
    close(got[0, :, 0], v[0].float().mean(1).repeat_interleave(4, 0), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,T,hd,window", [
    (4, 36, 4, 4096, 128, 0),          # StarCoder2 decode at max_seq 4096
    (3, 18, 2, 100, 32, 30),
    (2, 16, 16, 300, 256, 0),          # Gemma
])
def test_decode_kernel_matches_plain(dev, dtype, B, H, Hkv, T, hd, window):
    q = randn(dev, (B, H, hd), dtype, 7)
    k = randn(dev, (B, T, Hkv, hd), dtype, 8).transpose(1, 2)
    v = randn(dev, (B, T, Hkv, hd), dtype, 9).transpose(1, 2)
    cur = torch.arange(B, device=dev, dtype=torch.int32) * 7 + T // 2
    kpos = torch.arange(T, device=dev, dtype=torch.int32).expand(B, T)
    kpos = torch.where(kpos <= cur[:, None], kpos, -1)
    n = tdec.LAUNCHES
    got = tdec.decode_attention(q, k, v, kpos, cur, scale=hd ** -0.5,
                                window=window)
    torch.cuda.synchronize()
    assert tdec.LAUNCHES == n + 1
    want = tref.decode_attention_ref(q, k, v, kpos, cur, scale=hd ** -0.5,
                                     window=window)
    close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_fully_masked_rows(dev, dtype):
    B, H, Hkv, T, hd = 3, 9, 1, 700, 128
    q = randn(dev, (B, H, hd), dtype, 10)
    k = randn(dev, (B, Hkv, T, hd), dtype, 11)
    v = randn(dev, (B, Hkv, T, hd), dtype, 12)
    cur = torch.tensor([600, -1, 300], device=dev, dtype=torch.int32)
    kpos = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
    kpos[2] = -1
    got = tdec.decode_attention(q, k, v, kpos, cur, scale=hd ** -0.5)
    want = tref.decode_attention_ref(q, k, v, kpos, cur, scale=hd ** -0.5)
    close(got, want, dtype)
    close(got[1], v[1].float().mean(1).expand(H, hd), dtype)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(dev):
    """The smoke StarCoder2 in fp32 serves the same tokens on the card
    (through the kernels) as on the CPU (through the plain versions)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch("starcoder2-7b")),
                              dtype="float32")
    lm = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for where in ("cpu", "cuda"):
        reqs = make_requests(cfg, 6, max_new=6)
        eng = ServingEngine(cfg, lm.to(where), max_batch=3, max_seq=64,
                            scheduler="dpa", device=where)
        for r in reqs:
            eng.submit(r)
        n = (tfa.LAUNCHES, tdec.LAUNCHES)
        eng.run()
        launched = (tfa.LAUNCHES - n[0], tdec.LAUNCHES - n[1])
        out[where] = [(r.tokens, r.ttft_step, r.done_step) for r in reqs]
        assert (launched == (0, 0)) == (where == "cpu")
    assert out["cpu"] == out["cuda"]
    assert np.all([len(t) == 6 for t, _, _ in out["cuda"]])
