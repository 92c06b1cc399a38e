"""The CUDA kernels of repro_torch against their plain versions, on the card.

Every test here needs a CUDA device and ``nvcc`` (the kernels are built
from ``src/repro_torch/kernels/csrc`` at first use) and skips without
one.  The file imports no JAX, so it runs on a machine without it::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: attention fp32 2e-5 (both sides compute in fp32, no TF32),
bf16 3e-2 (one bf16 ulp of outputs up to 4 in magnitude, both sides
accumulating in fp32); the SSD state scan (K3) atol 1e-6, the reference
sweep's, though kernel and plain version round the same two ops and
agree bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
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
    (1, 32, 32, 333, 333, 112, 0),     # Zamba2's shared block: hd 112
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
    (4, 32, 32, 4096, 112, 0),         # Zamba2's shared block: hd 112
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
@pytest.mark.parametrize("b,c,h,p,n,decay,s0,strided", [
    (1, 8, 112, 64, 64, "uniform", False, False),   # Zamba2 prefill
    (1, 8, 32, 64, 128, "uniform", False, False),   # Mamba2-370M prefill
    (2, 1, 112, 64, 64, "uniform", True, False),    # one chunk
    (1, 33, 32, 64, 128, "uniform", True, True),    # strided states
    (1, 8, 112, 64, 64, "zero", True, False),       # decay underflowed
    (1, 8, 112, 64, 64, "one", True, False),
])
def test_ssd_scan_kernel_matches_plain(dev, b, c, h, p, n, decay, s0,
                                       strided):
    shape = (b, h, c, p, n) if strided else (b, c, h, p, n)
    states = randn(dev, shape, "float32", 13)
    if strided:
        states = states.transpose(1, 2)
    # the model reads the chunk decays as a strided view of a cumsum
    gen = torch.Generator(device=dev).manual_seed(14)
    dec = torch.rand((b, c, 2, h), generator=gen, device=dev)[:, :, -1]
    if decay != "uniform":
        dec.fill_(0.0 if decay == "zero" else 1.0)
    init = (randn(dev, (b, h, p, n), "float32", 15) if s0 else
            torch.zeros((b, h, p, n), device=dev))
    n_launch = tssd.LAUNCHES
    prev, fin = tssd.ssd_state_scan(states, dec, init)
    torch.cuda.synchronize()
    assert tssd.LAUNCHES == n_launch + 1
    want_prev, want_fin = tref.ssd_state_scan_ref(states, dec, init)
    torch.testing.assert_close(prev, want_prev, atol=1e-6, rtol=0)
    torch.testing.assert_close(fin, want_fin, atol=1e-6, rtol=0)
    assert torch.equal(prev[:, 0], init)
    assert torch.isfinite(prev).all() and torch.isfinite(fin).all()


@pytest.mark.cuda
def test_ssd_scan_kernel_rejects_what_it_cannot_read(dev):
    states = torch.zeros((1, 2, 3, 4, 8), device=dev)
    dec = torch.ones((1, 2, 3), device=dev)
    init = torch.zeros((1, 3, 4, 8), device=dev)
    with pytest.raises(ValueError, match="unit-stride"):
        tssd.ssd_state_scan(states.transpose(3, 4).contiguous()
                            .transpose(3, 4), dec, init)
    with pytest.raises(ValueError, match="float32"):
        tssd.ssd_state_scan(states.double(), dec, init)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_ssm_engine_on_card_matches_cpu(dev, arch):
    """The smoke SSM and hybrid models in fp32 serve the same tokens on
    the card (through K3 and, for the hybrid, K1 and K2) as on the CPU
    (through the plain versions)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                              dtype="float32")
    lm = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for where in ("cpu", "cuda"):
        reqs = make_requests(cfg, 5, max_new=6, prompt_len=(2, 70))
        eng = ServingEngine(cfg, lm.to(where), max_batch=3, max_seq=96,
                            scheduler="dpa", device=where)
        for r in reqs:
            eng.submit(r)
        n = tssd.LAUNCHES
        eng.run()
        out[where] = [(r.tokens, r.ttft_step, r.done_step) for r in reqs]
        assert (tssd.LAUNCHES == n) == (where == "cpu")
    assert out["cpu"] == out["cuda"]


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
