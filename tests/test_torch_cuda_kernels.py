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
into a different trajectory, so only bit equality is a meaningful bound;
the vector engine's bucket step 0, for the same reason: kernel and plain
version do the same float32 ops in the same order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import arma_fit as tarma
from repro_torch.kernels import bucket_step as tbs
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
    (8, 8, 8, 128, 128, 96, 0, "view"),     # hd 96: the train example
    (1, 9, 1, 200, 333, 96, 32, "view"),    # hd 96, g 9, S != T, window
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
@pytest.mark.parametrize("S,T,causal", [
    (333, 333, True),       # MLA prefill, ragged S = T
    (129, 129, True),       # one row past a 128-row q tile
    (70, 200, False),       # bidirectional / cross: S != T
    (1, 64, False),         # one query row, one 64-key tile
])
def test_flash_kernel_hd192_mla_layout(dev, dtype, S, T, causal):
    """Head dim 192 (MLA's nope 128 + rope 64): q and k concatenated and
    V zero-padded from 128 to 192 in a real buffer, the (192, 192) pair;
    the first 128 output columns against the plain version on the
    unpadded V, the last 64 zero."""
    B, H, vd, hd = 2, 16, 128, 192
    q = randn(dev, (B, S, H, hd), dtype, 11).transpose(1, 2)
    k = randn(dev, (B, T, H, hd), dtype, 12).transpose(1, 2)
    v = torch.zeros((B, T, H, hd), dtype=getattr(torch, dtype), device=dev)
    v[..., :vd] = randn(dev, (B, T, H, vd), dtype, 13)
    v = v.transpose(1, 2)
    qpos = (torch.arange(S, device=dev, dtype=torch.int32)
            + (T - S)).repeat(B, 1)
    kpos = torch.arange(T, device=dev, dtype=torch.int32).expand(B, T)
    n = tfa.LAUNCHES
    got = tfa.flash_attention(q, k, v, qpos, kpos, scale=hd ** -0.5,
                              causal=causal)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == n + 1
    want = tref.flash_attention_ref(q, k, v[..., :vd], qpos, kpos,
                                    scale=hd ** -0.5, causal=causal)
    close(got[..., :vd], want, dtype)
    assert not got[..., vd:].any()


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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v3-671b",
                                  "whisper-tiny"])
def test_new_family_engine_on_card_matches_cpu(dev, arch):
    """The smoke MoE (with MLA) and audio models in fp32, at a capacity
    that drops nothing, serve the same tokens on the card (K2 in every
    prefill; K1 in decode, but for MLA's plain latent attention) as on
    the CPU (the plain versions).  The reduced DeepSeek-V3's MLA head dim
    is 24, which K2 does not take, so it is served at the full model's
    MLA widths (nope 128, rope 64, v 128: K2 at hd 192)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                              dtype="float32", capacity_factor=8.0)
    if cfg.use_mla:
        cfg = dataclasses.replace(cfg, mla=get_arch(arch).mla)
    lm = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for where in ("cpu", "cuda"):
        reqs = make_requests(cfg, 5, max_new=6, prompt_len=(2, 70))
        eng = ServingEngine(cfg, lm.to(where), max_batch=3, max_seq=96,
                            scheduler="dpa", device=where)
        for r in reqs:
            eng.submit(r)
        n = (tfa.LAUNCHES, tdec.LAUNCHES)
        eng.run()
        launched = (tfa.LAUNCHES - n[0], tdec.LAUNCHES - n[1])
        out[where] = [(r.tokens, r.ttft_step, r.done_step) for r in reqs]
        if where == "cpu":
            assert launched == (0, 0)
        else:
            assert launched[0] > 0 and (launched[1] > 0) != cfg.use_mla
    assert out["cpu"] == out["cuda"]


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
@pytest.mark.parametrize("length", [1, 8, 255, 257, 511, 2815, 2817,
                                    "longest"])
@pytest.mark.parametrize("p,q", [(1, 1), (2, 1), (2, 2), (3, 1), (2, 0),
                                 (0, 1), (0, 0), (3, 5), (0, 8), (8, 0)])
def test_arma_fit_kernel_matches_plain_bit_for_bit(dev, p, q, length, rows):
    """Kernel and plain version round every op alike (tolerance 0), cold
    and warm; a diverging row must diverge alike (NaN where NaN).  The
    lengths sit at the chunk edges: one point, fewer points than threads
    (a point a chunk), 256 T +- 1 (a ragged last chunk, a chunk more) and
    the longest row the wrapper takes (10 steps there)."""
    steps = 100
    if length == "longest":
        length, steps = tarma.MAX_LEN, 10
    for warm in (False, True):
        y, init = arma_inputs(dev, rows, length, p + 1 + q, warm,
                              seed=length + rows)
        prm, loss = tarma.arma_fit(y, init, p, q, steps, 0.05)
        want_prm, want_loss = arma_plain(y, init, p, q, steps)
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


#: the edge cases of chip_smoke.py's phase 3 (``bucket_step.synthetic_case``
#: arguments; b0 where the segment starts)
BUCKET_CASES = {
    "R=1, one bucket": dict(seed=1, modes=("lt-ua",), buckets=1),
    "R=1, reactive": dict(seed=2, modes=("reactive",)),
    "R=5, every mode, unified": dict(seed=3, modes=tuple(tbs.MODES)),
    "R=5, siloed": dict(seed=4, modes=tuple(tbs.MODES), P=2),
    "R=8, 8 models x 2 pools (C*J = 48)": dict(
        seed=5, modes=tuple(tbs.MODES) + ("reactive", "lt-ua", "chiron"),
        M=8, P=2),
    "ring collision": dict(seed=6, modes=tuple(tbs.MODES), collide=True),
    "region down": dict(seed=7, modes=tuple(tbs.MODES), down=True),
    "dead model past its budget": dict(seed=8, modes=tuple(tbs.MODES),
                                       dead=True),
    "no plan rows": dict(seed=9, modes=tuple(tbs.MODES), plan=False),
    "wraps the ring": dict(seed=10, modes=tuple(tbs.MODES), b0=3 * 481 - 100),
    # one case per instantiation of the kernel's template (J = 3 above)
    "J=1": dict(seed=11, modes=tuple(tbs.MODES), J=1),
    "J=2": dict(seed=16, modes=tuple(tbs.MODES), J=2),
    "J=4": dict(seed=17, modes=tuple(tbs.MODES), J=4),
    "J=5": dict(seed=12, modes=tuple(tbs.MODES), J=5),
    "J=8": dict(seed=18, modes=tuple(tbs.MODES), M=3, J=8),
    "J=6 (J at run time)": dict(seed=13, modes=tuple(tbs.MODES), M=2, J=6),
    "L=96 (whole chunks of 32 rows)": dict(seed=19, modes=tuple(tbs.MODES),
                                           L=96),
    "C*J=72 (8 models x 3 pools, 4 cells a lane)": dict(
        seed=14, modes=tuple(tbs.MODES), M=8, P=3),
    "C*J=144 (32 cells a lane), L=121": dict(
        seed=15, modes=("lt-ua", "chiron"), M=16, P=3, L=121, buckets=24),
    "C*J=330, outputs not staged in shared memory, L=121": dict(
        seed=20, modes=("lt-ua",), M=110, L=121, buckets=24),
}


def bucket_inputs(dev, case):
    kw = dict(BUCKET_CASES[case])
    b0 = kw.pop("b0", 0)
    lay, *arrays = tbs.synthetic_case(**kw)
    consts, prm, carry, xs = (torch.from_numpy(a).to(dev) for a in arrays)
    return lay, consts, prm, carry, xs, b0, b0 + xs.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_bucket_step_kernel_matches_plain_bit_for_bit(dev, case):
    args = bucket_inputs(dev, case)
    got_c, got_y = tbs.bucket_segment(*args)
    want_c, want_y = tref.bucket_segment_ref(*args)
    assert torch.equal(got_c, want_c)
    assert torch.equal(got_y, want_y)
    assert torch.isfinite(got_y).all()


@pytest.mark.cuda
def test_bucket_step_kernel_replicas_are_pure(dev):
    """A replica alone, in a batch and in a permuted batch: the same bits;
    repeats too."""
    lay, consts, prm, carry, xs, b0, b1 = bucket_inputs(
        dev, "R=5, every mode, unified")
    c, y = tbs.bucket_segment(lay, consts, prm, carry, xs, b0, b1)
    again = tbs.bucket_segment(lay, consts, prm, carry, xs, b0, b1)
    assert torch.equal(again[0], c) and torch.equal(again[1], y)
    perm = torch.tensor([3, 0, 4, 1, 2], device=dev)
    pc, py = tbs.bucket_segment(lay, consts, prm[perm], carry[perm], xs, b0,
                                b1)
    assert torch.equal(pc, c[perm]) and torch.equal(py, y[perm])
    ac, ay = tbs.bucket_segment(lay, consts, prm[2:3], carry[2:3], xs, b0,
                                b1)
    assert torch.equal(ac[0], c[2]) and torch.equal(ay[0], y[2])


@pytest.mark.cuda
def test_bucket_step_kernel_rejects_what_it_does_not_take(dev):
    lay, consts, prm, carry, xs, b0, b1 = bucket_inputs(dev,
                                                        "R=1, reactive")
    with pytest.raises(ValueError, match="CUDA"):
        tbs.bucket_segment(lay, consts, prm, carry.cpu(), xs, b0, b1)
    with pytest.raises(ValueError, match="float32"):
        tbs.bucket_segment(lay, consts, prm, carry.double(), xs, b0, b1)
    big = tref.BucketLayout(16, 2, 8, 481, 15.0)
    z = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match="227 KB"):
        tbs.bucket_segment(big, z(big.NC), z(1, big.K), z(1, big.F),
                           z(1, big.X), 0, 1)


# ---------------------------------------------------------------- backward
#: K2's backward against its plain version: fp32 1e-4 (both fp32, the
#: sums over up to a few thousand keys or rows in other orders), bf16 3e-2
#: (outputs rounded once to bf16 on both sides, one ulp at magnitudes up
#: to 4)
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def flash_bwd_inputs(dev, dtype, B, H, Hkv, S, T, hd, masked=False,
                     hd_v=None):
    """``masked``: padding rows and a gap of keys no windowed row sees
    past; ``"dead"``: five padding rows in the middle of the second query
    tile of every sequence, whose other rows keep every key of the tile;
    ``hd_v``: V's own head dim (hd by default)."""
    q = randn(dev, (B, S, H, hd), dtype, 21).transpose(1, 2)
    k = randn(dev, (B, T, Hkv, hd), dtype, 22).transpose(1, 2)
    v = randn(dev, (B, T, Hkv, hd_v or hd), dtype, 23).transpose(1, 2)
    qpos = (torch.arange(S, device=dev, dtype=torch.int32)
            + max(T - S, 0)).repeat(B, 1)
    kpos = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
    if masked == "dead":
        qpos[:, 90:95] = -1
    elif masked:
        qpos[0, : max(S // 8, 1)] = -1
        kpos[-1, T // 4: 3 * T // 4] = -1
    return q, k, v, qpos, kpos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,T,hd,causal,window,masked", [
    (1, 36, 4, 300, 300, 128, True, 0, False),    # StarCoder2 widths, g 9
    (2, 8, 2, 37, 53, 32, True, 16, False),       # S != T, windowed
    (1, 8, 8, 130, 130, 256, True, 0, False),     # Gemma: hd 256, g 1
    (2, 4, 4, 70, 70, 64, True, 0, False),
    (1, 8, 8, 133, 133, 112, True, 0, False),     # Zamba2's shared block
    (1, 4, 2, 100, 100, 160, True, 0, False),
    (1, 8, 8, 97, 97, 192, True, 0, False),       # MLA's hd 192
    (2, 6, 6, 70, 150, 64, False, 0, False),      # cross: S != T
    (1, 6, 6, 150, 150, 64, False, 0, False),     # bidirectional encoder
    (2, 10, 2, 90, 90, 128, True, 16, True),      # fully masked rows, g 5
    (1, 4, 1, 65, 65, 16, True, 0, False),        # hd 16, g 4
    (2, 36, 4, 2048, 2048, 128, True, 0, False),  # StarCoder2-7B trained
    (1, 8, 2, 200, 333, 128, True, 0, False),     # T % 128 != 0, S != T
    (2, 6, 6, 130, 333, 64, False, 0, False),     # cross, T % 128 != 0
    (2, 10, 2, 90, 90, 64, True, 0, True),        # masked rows, hd 64, g 5
    (1, 8, 2, 200, 333, 112, False, 0, "dead"),   # dead rows, hd 112, g 4
    (1, 36, 4, 300, 300, 128, True, 40, False),   # window < one tile
    (1, 8, 8, 200, 200, 112, False, 0, "dead"),   # dead rows, FULL tile
    (2, 36, 4, 200, 200, 128, True, 0, "dead"),   # dead rows, g 9
    (1, 40, 8, 200, 200, 128, True, 0, False),    # g 5
    (1, 8, 8, 150, 150, 16, True, 0, False),      # hd 16, g 1
    (8, 8, 8, 128, 128, 96, True, 0, False),      # hd 96: the train example
    (2, 10, 2, 90, 90, 96, True, 16, True),       # hd 96, masked rows, g 5
])
def test_flash_bwd_kernel_matches_plain(dev, dtype, B, H, Hkv, S, T, hd,
                                        causal, window, masked):
    """The kernel's (dq, dk, dv) against ``flash_attention_bwd_ref`` on
    the same forward output and log-sum-exp (the kernel's own), and that
    log-sum-exp against the plain version's.  The cases cover the tile
    edges of the tensor-core kernels (bf16, hd <= 128: 64-key dK/dV
    blocks over 64-row query tiles, 128-row dQ blocks over 64-key tiles):
    ragged S and T, a window inside one tile, rows that kept no key inside
    a tile every other row keeps whole, g 1, 4, 5 and 9."""
    q, k, v, qpos, kpos = flash_bwd_inputs(dev, dtype, B, H, Hkv, S, T, hd,
                                           masked)
    opts = dict(scale=hd ** -0.5, causal=causal, window=window)
    out, lse = tfa.flash_attention(q, k, v, qpos, kpos, return_lse=True,
                                   **opts)
    _, want_lse = tref.flash_attention_lse_ref(q, k, v, qpos, kpos, **opts)
    dead = want_lse <= 0.5 * tref.NEG_INF
    assert torch.equal(lse <= 0.5 * tref.NEG_INF, dead)
    torch.testing.assert_close(lse[~dead], want_lse[~dead], atol=1e-3,
                               rtol=1e-5)
    do = randn(dev, (B, S, H, hd), dtype, 24).transpose(1, 2)
    n = tfa.BWD_LAUNCHES
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, qpos, kpos, **opts)
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES == n + 1
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, do, qpos, kpos,
                                        **opts)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv", [(36, 4), (8, 8)])
def test_flash_bwd_kernel_repeats_bit_identical_and_takes_strided_do(
        dev, H, Hkv):
    """No atomics: the same inputs give the same bits; a dO that is not
    unit-stride along hd is copied into the layout the kernel reads.  g 9
    (a dK/dV block walks the group) and g 1."""
    B, S, hd = 2, 257, 128
    q, k, v, qpos, kpos = flash_bwd_inputs(dev, "bfloat16", B, H, Hkv, S, S,
                                           hd)
    out, lse = tfa.flash_attention(q, k, v, qpos, kpos, scale=hd ** -0.5,
                                   return_lse=True)
    do = randn(dev, (B, S, H, hd), "bfloat16", 25).transpose(1, 2)
    first = tfa.flash_attention_bwd(q, k, v, out, lse, do, qpos, kpos,
                                    scale=hd ** -0.5)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do, qpos, kpos,
                                    scale=hd ** -0.5)
    strided = do.transpose(2, 3).contiguous().transpose(2, 3)
    other = tfa.flash_attention_bwd(q, k, v, out, lse, strided, qpos, kpos,
                                    scale=hd ** -0.5)
    for a, b, c in zip(first, again, other):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_flash_bwd_routes_by_head_dim(dev):
    """bf16 takes the tensor-core kernels at every head dim; fp32 always
    the scalar ones."""
    for hd in tfa.HEAD_DIMS:
        assert tfa.bwd_route(torch.bfloat16, hd) == "wgmma"
        assert tfa.bwd_route(torch.float32, hd) == "fma"


WIDE_PAIRS = [(160, 160), (192, 192), (192, 128), (256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hd_v", WIDE_PAIRS)
@pytest.mark.parametrize("B,H,Hkv,S,T,causal,window,masked", [
    (1, 8, 8, 97, 97, True, 0, False),       # ragged, g 1
    (2, 8, 2, 200, 333, True, 0, False),     # S != T, T % 32 != 0, g 4
    (2, 10, 2, 90, 90, True, 16, True),      # fully masked rows, window
    (1, 6, 6, 70, 150, False, 0, False),     # cross: every pair kept
    (1, 4, 4, 31, 31, True, 0, False),       # S < 32: one partial tile
])
def test_flash_wide_head_dims_match_plain(dev, hd, hd_v, B, H, Hkv, S, T,
                                          causal, window, masked):
    """bf16 at head dims 160-256 and MLA's (192, 128), V at its own head
    dim: the forward and the tensor-core backward (no producer warp,
    32-row tiles) against the plain versions at 3e-2 + 3e-2 |x|."""
    q, k, v, qpos, kpos = flash_bwd_inputs(dev, "bfloat16", B, H, Hkv, S,
                                           T, hd, masked, hd_v)
    do = randn(dev, (B, S, H, hd_v), "bfloat16", 44).transpose(1, 2)
    opts = dict(scale=hd ** -0.5, causal=causal, window=window)
    out, lse = tfa.flash_attention(q, k, v, qpos, kpos, return_lse=True,
                                   **opts)
    want_out, want_lse = tref.flash_attention_lse_ref(q, k, v, qpos, kpos,
                                                      **opts)
    assert out.shape == (B, H, S, hd_v)
    close(out, want_out, "bfloat16")
    dead = want_lse <= 0.5 * tref.NEG_INF
    assert torch.equal(lse <= 0.5 * tref.NEG_INF, dead)
    assert tfa.bwd_route(torch.bfloat16, hd) == "wgmma"
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, qpos, kpos, **opts)
    torch.cuda.synchronize()
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, do, qpos, kpos,
                                        **opts)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=BWD_TOL["bfloat16"],
                                   rtol=BWD_TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hd_v", WIDE_PAIRS)
def test_flash_wide_head_dims_repeat_bit_identical(dev, hd, hd_v):
    """No atomics at the wide head dims either: two calls, the same bits,
    forward and backward (g 4, a dK/dV block walks its group)."""
    q, k, v, qpos, kpos = flash_bwd_inputs(dev, "bfloat16", 2, 8, 2, 257,
                                           257, hd, hd_v=hd_v)
    do = randn(dev, (2, 257, 8, hd_v), "bfloat16", 44).transpose(1, 2)
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_attention(q, k, v, qpos, kpos,
                                       scale=hd ** -0.5, return_lse=True)
        runs.append((out, lse) + tfa.flash_attention_bwd(
            q, k, v, out, lse, do, qpos, kpos, scale=hd ** -0.5))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,hd_v", [(128, 64), (192, 64), (256, 128),
                                     (128, 192)])
def test_flash_rejects_unsupported_head_dim_pairs(dev, dtype, hd, hd_v):
    """A (hd, hd_v) pair outside ``HEAD_DIM_PAIRS`` raises in the wrapper,
    forward and backward, before any launch."""
    q, k, v, qpos, kpos = flash_bwd_inputs(dev, dtype, 1, 4, 4, 64, 64, hd,
                                           hd_v=hd_v)
    n = (tfa.LAUNCHES, tfa.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="hd_v"):
        tfa.flash_attention(q, k, v, qpos, kpos, scale=hd ** -0.5)
    lse = torch.zeros((1, 4, 64), device=dev)
    with pytest.raises(ValueError, match="hd_v"):
        tfa.flash_attention_bwd(q, k, v, v, lse, v, qpos, kpos,
                                scale=hd ** -0.5)
    assert (tfa.LAUNCHES, tfa.BWD_LAUNCHES) == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,S,T,vd", [
    (True, 0, 150, 150, 0), (True, 32, 150, 150, 0), (False, 0, 40, 90, 0),
    (True, 0, 120, 120, 128)])
def test_flash_function_grads_match_autograd_of_plain(dev, dtype, causal,
                                                      window, S, T, vd):
    """``ops.flash_attention`` (K2 forward, K2 backward) against torch
    autograd through the plain forward, on a loss of the output; ``vd``:
    V zero-padded from vd to hd in a real buffer, the gradient leaving
    through the pad."""
    from repro_torch.kernels import ops

    B, H, Hkv, hd = 2, 8, 2, 192 if vd else 64
    q0, k0, v0, qpos, kpos = flash_bwd_inputs(dev, dtype, B, H, Hkv, S, T, hd)
    w = randn(dev, (B, S, H, vd or hd), dtype, 26).float()
    opts = dict(scale=hd ** -0.5, causal=causal, window=window)

    def run(fn):
        q, k = (x.detach().requires_grad_() for x in (q0, k0))
        vs = (v0[..., :vd] if vd else v0).detach().requires_grad_()
        v = vs
        if vd:
            v = torch.zeros_like(v0)
            v[..., :vd] = vs
        out = fn(q, k, v, qpos, kpos, **opts).transpose(1, 2)
        loss = (out[..., :vd or hd].float() * w).sum()
        return torch.autograd.grad(loss, (q, k, vs))

    n = (tfa.LAUNCHES, tfa.BWD_LAUNCHES)
    got = run(ops.flash_attention)
    assert (tfa.LAUNCHES, tfa.BWD_LAUNCHES) == (n[0] + 1, n[1] + 1)
    want = run(tref.flash_attention_ref)
    for g, x in zip(got, want):
        torch.testing.assert_close(g.float(), x.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_function_own_v_width_grads_match_autograd_of_plain(dev,
                                                                   dtype):
    """``ops.flash_attention`` with V at its own head dim, MLA's (192,
    128), as ``_mla_forward`` calls it: the output and (dq, dk, dv) of
    the autograd Function (K2 forward and backward) against torch
    autograd through the plain forward."""
    from repro_torch.kernels import ops

    B, H, S, hd, vd = 2, 8, 120, 192, 128
    q0, k0, v0, qpos, kpos = flash_bwd_inputs(dev, dtype, B, H, H, S, S, hd,
                                              hd_v=vd)
    w = randn(dev, (B, H, S, vd), dtype, 46).float()
    opts = dict(scale=hd ** -0.5, causal=True, window=0)

    def run(fn):
        q, k, v = (x.detach().requires_grad_() for x in (q0, k0, v0))
        out = fn(q, k, v, qpos, kpos, **opts)
        return (out,) + torch.autograd.grad((out.float() * w).sum(),
                                            (q, k, v))

    n = (tfa.LAUNCHES, tfa.BWD_LAUNCHES)
    got = run(ops.flash_attention)
    assert (tfa.LAUNCHES, tfa.BWD_LAUNCHES) == (n[0] + 1, n[1] + 1)
    want = run(tref.flash_attention_ref)
    assert got[0].shape == (B, H, S, vd)
    for g, x in zip(got, want):
        assert g.shape == x.shape
        torch.testing.assert_close(g.detach().float(), x.detach().float(),
                                   atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])


def scan_bwd_inputs(dev, b, c, h, p, n, decay="uniform"):
    gen = torch.Generator(device=dev).manual_seed(31)
    dec = torch.rand((b, c, 2, h), generator=gen, device=dev)[:, :, -1]
    if decay != "uniform":
        dec.fill_(0.0 if decay == "zero" else 1.0)
    prev = torch.randn((b, c, h, p, n), generator=gen, device=dev)
    dprev = torch.randn((b, c, h, p, n), generator=gen, device=dev)
    dfin = torch.randn((b, h, p, n), generator=gen, device=dev)
    return dec, prev, dprev, dfin


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,p,n,decay", [
    (1, 8, 112, 64, 64, "uniform"),   # Zamba2 prefill
    (4, 8, 32, 64, 128, "uniform"),   # Mamba2-370M at B = 4, S = 2048
    (2, 1, 112, 64, 64, "uniform"),   # one chunk
    (1, 33, 32, 64, 128, "uniform"),
    (1, 8, 112, 64, 64, "zero"),
    (1, 8, 112, 64, 64, "one"),
    (2, 3, 4, 16, 32, "uniform"),     # the smoke configs' tile
])
def test_ssd_scan_bwd_kernel_matches_plain(dev, b, c, h, p, n, decay):
    """dstates and ds0 bit for bit; ddecay, a sum over p*n elements in
    another order, within 1e-5 of the sum of its terms' magnitudes."""
    dec, prev, dprev, dfin = scan_bwd_inputs(dev, b, c, h, p, n, decay)
    k = tssd.BWD_LAUNCHES
    got = tssd.ssd_state_scan_bwd(dec, prev, dprev, dfin)
    torch.cuda.synchronize()
    assert tssd.BWD_LAUNCHES == k + 1
    want = tref.ssd_state_scan_bwd_ref(dec, prev, dprev, dfin)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    mag = (want[0].abs() * prev.abs()).sum(dim=(-2, -1))
    assert torch.all((got[1] - want[1]).abs() <= 1e-5 * mag + 1e-6)


@pytest.mark.cuda
def test_ssd_scan_function_grads_match_autograd_of_plain(dev):
    """``ops.ssd_state_scan`` (K3 and its reverse scan) against torch
    autograd through the plain recurrence; decay a strided view as the
    model passes it."""
    from repro_torch.kernels import ops

    b, c, h, p, n = 2, 5, 8, 16, 32
    gen = torch.Generator(device=dev).manual_seed(32)
    st0 = torch.randn((b, c, h, p, n), generator=gen, device=dev)
    dec0 = torch.rand((b, c, 2, h), generator=gen, device=dev)
    s00 = torch.randn((b, h, p, n), generator=gen, device=dev)
    wp = torch.randn((b, c, h, p, n), generator=gen, device=dev)
    wf = torch.randn((b, h, p, n), generator=gen, device=dev)

    def run(fn):
        st, dec, s0 = (x.clone().requires_grad_() for x in (st0, dec0, s00))
        prev, fin = fn(st, dec[:, :, -1], s0)
        loss = (prev * wp).sum() + (fin * wf).sum()
        return torch.autograd.grad(loss, (st, dec, s0))

    k = (tssd.LAUNCHES, tssd.BWD_LAUNCHES)
    got = run(ops.ssd_state_scan)
    assert (tssd.LAUNCHES, tssd.BWD_LAUNCHES) == (k[0] + 1, k[1] + 1)
    want = run(tref.ssd_state_scan_ref)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-7b", "zamba2-7b", "whisper-tiny",
                                  "llama4-scout-17b-a16e", "deepseek-v3-671b"])
def test_train_loss_and_grads_on_card_match_cpu(dev, arch):
    """``model.loss_fn`` and its gradients in fp32 on the card (K2, K3 and
    their backward kernels, each layer recomputed) against the CPU (the
    plain versions, no recompute) on the same weights and batch: loss
    rel 1e-5, each gradient leaf rel L2 1e-4 (the CPU parity tests'
    bounds against JAX).  MLA at the full model's widths (K2 at hd 192),
    MoE at a capacity that drops nothing."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import loop

    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                              dtype="float32", capacity_factor=8.0)
    if cfg.use_mla:
        cfg = dataclasses.replace(cfg, mla=get_arch(arch).mla)
    lm = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(SyntheticLM(cfg, DataConfig(batch_size=2,
                                             seq_len=64)).batches(1))
    out = {}
    for where, remat in (("cpu", False), ("cuda", True)):
        params = lm.to(where)
        params.requires_grad_(True)
        n = (tfa.BWD_LAUNCHES, tssd.BWD_LAUNCHES)
        loss = model.loss_fn(cfg, params, loop.batch_to(batch, where),
                             remat=remat)
        loss.backward()
        launched = (tfa.BWD_LAUNCHES - n[0], tssd.BWD_LAUNCHES - n[1])
        assert (sum(launched) == 0) == (where == "cpu")
        out[where] = (loss.item(), {k: p.grad.cpu() for k, p in
                                    params.named_parameters()})
        for p in params.parameters():
            p.grad = None
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k, g in gc.items():
        assert float((gg[k] - g).norm()) <= 1e-4 * max(float(g.norm()),
                                                       1e-30), k


@pytest.mark.cuda
def test_train_cli_on_card(dev, capsys):
    """``python -m repro_torch.launch.train`` on its default device (the
    card), reduced Gemma-7B, 10 steps: the loss falls."""
    from repro_torch.launch import train as train_cli

    assert train_cli.main(["--arch", "gemma-7b", "--steps", "10"]) == 0
    assert "(improved)" in capsys.readouterr().out


@pytest.mark.cuda
def test_trace_tier_on_the_card(dev):
    """reprolint's trace tier (T1-T4) on the card: the real bucket_step
    and arma_fit kernels, T1 under the sync debug mode "error", the
    carry's memory flat across segments."""
    from repro_torch.analysis.trace import TRACE_RULES, run_trace

    result = run_trace(device=dev)
    assert not result.violations, [v.render() for v in result.violations]
    assert {c.rule for c in result.checks} == set(TRACE_RULES)
    assert result.device.startswith("cuda")


@pytest.mark.cuda
def test_trace_t1_fires_on_host_syncs_on_the_card(dev):
    """T1's two detectors on the card: the dispatch mode records a
    tensor read on the host and a copy to the CPU, and the sync debug
    mode raises on them; the fit's pinned init copy trips neither."""
    from repro_torch.analysis.trace import audit_call, canonical_fit

    x = torch.arange(4, dtype=torch.float32, device=dev)
    syncs, _ = audit_call(lambda: x.sum().item(), dev)
    assert any("_local_scalar_dense" in s for s in syncs)
    assert any("synchronizing CUDA call" in s for s in syncs)
    syncs, _ = audit_call(lambda: x.cpu(), dev)
    assert any("copied to the CPU" in s for s in syncs)
    fit = canonical_fit(dev)
    fit()
    assert audit_call(fit, dev) == ([], [])
