"""The CUDA kernels of repro_torch against their plain versions, on the card.

Every test here needs a CUDA device and ``nvcc`` (the kernels are built
from ``src/repro_torch/kernels/csrc`` at first use) and skips without
one.  The file imports no JAX, so it runs on a machine without it::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: attention fp32 2e-5 (both sides compute in fp32, no TF32),
bf16 3e-2 (one bf16 ulp of outputs up to 4 in magnitude, both sides
accumulating in fp32); the SSD state scan (K3) atol 1e-6, the reference
sweep's, though kernel and plain version round the same two ops and
agree bit for bit; the ARMA fit 0: kernel and plain version round every
op alike, and near an optimum Adam amplifies any rounding difference
into a different trajectory, so only bit equality is a meaningful bound.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import arma_fit as tarma
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
@pytest.mark.parametrize("B,H,Hkv,S,T,hd,window,layout", [
    (1, 36, 4, 300, 300, 128, 0, "view"),   # StarCoder2 widths, ragged S = T
    (2, 18, 2, 37, 53, 32, 16, "view"),     # S != T, windowed
    (1, 16, 16, 130, 130, 256, 0, "view"),  # Gemma: hd 256, g = 1
    (2, 4, 4, 70, 70, 64, 0, "view"),       # smoke configs' hd
    (1, 32, 32, 333, 333, 112, 0, "view"),  # Zamba2's shared block: hd 112
    # around the 128-row q tile and the 128-key kv tile
    (1, 9, 1, 127, 127, 128, 0, "view"),
    (1, 9, 1, 129, 257, 128, 0, "view"),
    (1, 4, 4, 255, 385, 112, 0, "view"),
    (2, 9, 1, 40, 40, 112, 0, "view"),      # S < 64, g = 9
    (1, 4, 4, 1, 300, 128, 0, "view"),      # one query row
    (1, 9, 1, 200, 200, 112, 0, "view"),    # hd 112, g = 9
    (1, 4, 4, 200, 200, 128, 0, "view"),    # hd 128, g = 1
    (1, 9, 1, 300, 300, 128, 64, "view"),   # window inside the kv tile
    (2, 9, 1, 200, 200, 128, 0, "padded"),  # padded and live rows in a tile
    (2, 8, 2, 150, 150, 112, 0, "contiguous"),  # (B, H, S, hd) buffers
    (1, 9, 1, 1024, 8192, 128, 0, "view"),  # T >= 8192
    (1, 4, 2, 160, 160, 160, 0, "view"),    # hd 160: 64-key tiles
])
def test_flash_kernel_matches_plain(dev, dtype, B, H, Hkv, S, T, hd, window,
                                    layout):
    if layout == "contiguous":
        q = randn(dev, (B, H, S, hd), dtype, 1)
        k = randn(dev, (B, Hkv, T, hd), dtype, 2)
        v = randn(dev, (B, Hkv, T, hd), dtype, 3)
    else:
        q = randn(dev, (B, S, H, hd), dtype, 1).transpose(1, 2)
        k = randn(dev, (B, T, Hkv, hd), dtype, 2).transpose(1, 2)
        v = randn(dev, (B, T, Hkv, hd), dtype, 3).transpose(1, 2)
    qpos = (torch.arange(S, device=dev, dtype=torch.int32)
            + (T - S)).repeat(B, 1)
    kpos = torch.arange(T, device=dev, dtype=torch.int32).expand(B, T)
    if layout == "padded":   # left padding: q_pos -1 before live rows
        qpos[0, :70] = -1
        qpos[1, :3] = -1
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
    (3, 9, 1, 1000, 112, 0),           # hd 112, g = 9
    (4, 8, 8, 777, 128, 0),            # hd 128, g = 1, ragged cache
    (3, 18, 2, 3000, 128, 500),        # windowed
    (2, 36, 4, 9000, 128, 0),          # T >= 8192: several chunks
    (2, 4, 4, 5, 64, 0),               # a cache shorter than a sub-tile
    (2, 4, 2, 130, 16, 0),             # hd 16
    (2, 4, 2, 400, 160, 0),            # hd 160
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
def test_decode_kernel_repeats_bit_identical(dev):
    """The warps' and the chunks' partials merge in a fixed order, with
    no atomics: the same inputs give the same bits."""
    B, H, Hkv, T, hd = 4, 32, 32, 4096, 112
    q = randn(dev, (B, H, hd), "bfloat16", 16)
    k = randn(dev, (B, T, Hkv, hd), "bfloat16", 17).transpose(1, 2)
    v = randn(dev, (B, T, Hkv, hd), "bfloat16", 18).transpose(1, 2)
    cur = torch.tensor([4095, 1999, 777, 130], device=dev, dtype=torch.int32)
    kpos = torch.arange(T, device=dev, dtype=torch.int32).expand(B, T)
    kpos = torch.where(kpos <= cur[:, None], kpos, -1)
    first = tdec.decode_attention(q, k, v, kpos, cur, scale=hd ** -0.5)
    again = tdec.decode_attention(q, k, v, kpos, cur, scale=hd ** -0.5)
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_attention_kernels_reject_misaligned_views(dev):
    """TMA (prefill) and the 16-byte copies (decode) need 16-byte aligned
    base addresses and strides: the wrappers raise, never fall back."""
    B, H, S, hd = 1, 4, 64, 128
    flat = randn(dev, (B * S * H * hd + 8,), "bfloat16", 19)
    good = flat[:B * S * H * hd].view(B, S, H, hd).transpose(1, 2)
    bad = flat[1:1 + B * S * H * hd].view(B, S, H, hd).transpose(1, 2)
    pos = torch.arange(S, device=dev).expand(B, S)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(bad, good, good, pos, pos, scale=hd ** -0.5)
    wide = randn(dev, (B, S, H, hd + 4), "bfloat16", 20)[..., :hd]
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(good, good, wide.transpose(1, 2), pos, pos,
                            scale=hd ** -0.5)
    cur = torch.full((B,), S - 1, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        tdec.decode_attention(bad[:, :, 0], good, good, pos, cur,
                              scale=hd ** -0.5)


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


# ------------------------------------------------------------ ARMA fit
def arma_inputs(dev, rows, length, k, warm, seed):
    """Rows as the forecast engine fits them (a differenced series with
    some persistence, normalized), and a zero or a small random init."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((rows, length), generator=gen, device=dev)
    y = w + 0.6 * torch.roll(w, 1, dims=1) + 0.02 * torch.cumsum(w, 1)
    if length > 1:
        y = (y - y.mean(1, keepdim=True)) / (y.std(1, keepdim=True) + 1e-6)
    init = (0.1 * torch.randn((rows, k), generator=gen, device=dev) if warm
            else torch.zeros((rows, k), device=dev))
    return y, init


def arma_plain(y, init, p, q, steps):
    prm, loss = tref.arma_fit_ref(y.cpu(), init.cpu(), p, q, steps, 0.05)
    return prm.to(y.device), loss.to(y.device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 12, 37])
@pytest.mark.parametrize("length", [1, 8, 255, 2815])
@pytest.mark.parametrize("p,q", [(1, 1), (2, 1), (2, 2), (3, 1), (2, 0),
                                 (0, 1)])
def test_arma_fit_kernel_matches_plain_bit_for_bit(dev, p, q, length, rows):
    """Kernel and plain version round every op alike (tolerance 0), cold
    and warm; a diverging row must diverge alike (NaN where NaN)."""
    for warm in (False, True):
        y, init = arma_inputs(dev, rows, length, p + 1 + q, warm,
                              seed=length + rows)
        prm, loss = tarma.arma_fit(y, init, p, q, 100, 0.05)
        want_prm, want_loss = arma_plain(y, init, p, q, 100)
        assert prm.shape == want_prm.shape and loss.shape == (rows,)
        assert torch.equal(prm.isnan(), want_prm.isnan())
        assert torch.equal(prm.nan_to_num(), want_prm.nan_to_num()), warm
        assert torch.equal(loss.nan_to_num(), want_loss.nan_to_num()), warm


@pytest.mark.cuda
def test_arma_fit_kernel_rows_are_pure_and_repeat(dev):
    """A row's bits: the same in repeats, alone, in a batch and permuted
    (the forecast engine's dedupe and fit cache rest on it)."""
    y, init = arma_inputs(dev, 37, 2815, 4, True, seed=3)
    prm, loss = tarma.arma_fit(y, init, 2, 1, 150, 0.05)
    again = tarma.arma_fit(y, init, 2, 1, 150, 0.05)
    assert torch.equal(again[0], prm) and torch.equal(again[1], loss)
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(1))
    perm = perm.to(dev)
    permuted = tarma.arma_fit(y[perm], init[perm], 2, 1, 150, 0.05)
    assert torch.equal(permuted[0], prm[perm])
    for i in (0, 17, 36):
        alone = tarma.arma_fit(y[i:i + 1], init[i:i + 1], 2, 1, 150, 0.05)
        assert torch.equal(alone[0][0], prm[i])
        assert torch.equal(alone[1][0], loss[i])


@pytest.mark.cuda
def test_arma_fit_kernel_strided_rows_and_all_orders(dev):
    """Rows read through a row stride (a view of wider rows) and every
    order with p + q <= 8 (each its own instantiation)."""
    y, init = arma_inputs(dev, 5, 300, 4, True, seed=9)
    wide = torch.zeros((5, 400), device=dev)
    wide[:, :300] = y
    got = tarma.arma_fit(wide[:, :300], init, 2, 1, 30, 0.05)
    want = tarma.arma_fit(y, init, 2, 1, 30, 0.05)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for p in range(9):
        for q in range(9 - p):
            y, init = arma_inputs(dev, 3, 64, p + 1 + q, True, seed=p * 9 + q)
            prm, loss = tarma.arma_fit(y, init, p, q, 20, 0.05)
            want_prm, want_loss = arma_plain(y, init, p, q, 20)
            assert torch.equal(prm.nan_to_num(), want_prm.nan_to_num()), (p,
                                                                          q)
            assert torch.equal(loss.nan_to_num(), want_loss.nan_to_num())


@pytest.mark.cuda
def test_arma_fit_kernel_rejects_what_it_does_not_take(dev):
    y = torch.zeros((2, 16), device=dev)
    with pytest.raises(ValueError, match="p \\+ q"):
        tarma.arma_fit(y, torch.zeros((2, 10), device=dev), 5, 4, 10, 0.05)
    with pytest.raises(ValueError, match="float32"):
        tarma.arma_fit(y.double(), torch.zeros((2, 4), device=dev), 2, 1,
                       10, 0.05)
    with pytest.raises(ValueError, match="row length"):
        tarma.arma_fit(torch.zeros((2, tarma.MAX_LEN + 1), device=dev),
                       torch.zeros((2, 4), device=dev), 2, 1, 10, 0.05)
