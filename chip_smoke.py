#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device and ``nvcc``, and
imports nothing of JAX or of the JAX package ``repro``.  Phases, each of
which must pass for the run to exit 0:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel source in ``src/repro_torch/kernels/csrc/`` is
   compiled into ``build/torch_kernels/`` (one ``nvcc`` each, in
   parallel);
3. kernels: the prefill (K2) and decode (K1) attention kernels against
   their plain PyTorch versions on the card, in bf16 and fp32, at
   StarCoder2-7B's and Zamba2-7B's attention widths (head_dim 128 and
   112, each also at the other's GQA group, g = 9 and g = 1), a long
   cache (T = 8192 and 16384), Gemma's head_dim 256 and head_dim 160, a
   sliding window, fully masked rows, a q tile of padded and live rows,
   S and T off the 128-row tiles, S < 64 and one query row; the SSD
   state scan (K3) in fp32 at Zamba2-7B's and Mamba2-370M's prefill
   shapes, one chunk, 33 chunks from a random state, decays all 0 and
   all 1, and strided states.  Then each is
   timed at the served shapes beside its bound, its plain version and,
   for attention, ``scaled_dot_product_attention`` (timed only; the port
   never calls it; no single PyTorch call computes K3's scan);
4. serve: StarCoder2-7B (dense), then Zamba2-7B (hybrid: 81 Mamba2
   layers and a shared attention block after every 6), both at full
   width and depth, bf16, random weights from a seeded generator, behind
   ``ServingEngine`` with DPA scheduling: 8 requests of 100-2000 prompt
   tokens, 32 new tokens each; then Mamba2-370M (pure SSM) at full size
   with 4 requests of 16 new tokens.  Each run's launch counts must
   match its served work (K3 once per SSM layer per prefill; K2 and K1
   once per attention layer or group per prefill and per decode step),
   and the longest request's last decode logits are held to a full
   forward over its prompt and generated tokens: in bf16 for the dense
   model; for every model, the same tokens through the same model in
   fp32, a prefill and 31 decode steps against a full forward
   (``SERVE_LOGIT_TOL``, ``FP32_LOGIT_TOL``);
5. simulate: the paper's main path.  A 3-day trace
   (``generate_trace(WorkloadSpec(days=3, scale=0.05, seed=0))``, about
   745k requests) through ``build_stack(...).simulate`` on the fully
   co-optimised ``lt-ua+plan`` stack (LT-UA scaling, the routing-aware
   ``sageserve`` forecast + ILP planner, the ``plan`` router), with
   every hourly ARIMA fit on the card: 12 series (4 models x 3
   regions) of 60-s buckets, up to 2,815 points unseasoned and 1,439
   seasonal, 150 Adam steps.  ``scale`` (the request volume) is the one
   cut, for host time; it does not change the fits' sizes.  Every
   boundary is replayed with the fit's plain version on the host: its
   parameters must equal the kernel's bit for bit, and the ILP targets
   its forecasts give are counted against the run's.

The ARMA fit kernel (``arma_fit``) is also checked in phase 3 against
its plain version bit for bit: orders (1,1), (2,1), (2,2), (3,1), (2,0),
(0,1), rows of 1 to 2,815 points, cold and warm inits, repeats, and a
row alone, in a batch and permuted.

The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM bandwidth and its operations
# over the tensor-core rate for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # attention: atol = rtol
SCAN_ATOL = 1e-6         # K3 (fp32), the reference sweep's tolerance
# Decode path vs a full forward over the same tokens, relative L2 error of
# the last logits.  bf16, as served: dense models only (StarCoder2-7B
# keeps 1.2e-2).  The SSM and hybrid models' bf16 gap is printed, not
# bounded: on an H100 Zamba2-7B's decode drifts from the full forward by
# 3.3e-2 after one step and 6.3e-2 after 31 (scripts/torch_decode_drift.py,
# with the decode conv in bf16), with the attention kernels replaced by
# their plain versions too: rounding noise of GEMMs that pick other
# kernels at M = 4 than at M = 1862, compounded by the SSM recurrence
# over 95 blocks.  The decode conv now runs in fp32, as the reference's
# does, which rounds it apart from the prefill's bf16 conv: the gap goes
# back toward the 8.3e-2 of the first such run.  fp32, every model: the
# same path agrees to 2.0e-5, and is held to 1e-3, the reference's own
# bound for a decode step against the full forward in fp32.
SERVE_LOGIT_TOL = 3e-2
FP32_LOGIT_TOL = 1e-3
PROFILED_CALL = 2        # which prefill and which decode call to profile
PORT_KERNELS = ("flash_fwd_wgmma", "flash_fwd", "decode_split_mma",
                "decode_split", "decode_combine", "ssd_scan")
SPIN_CYCLES = 4_000_000  # ~2 ms at H100 clocks: longer than any call's host time
# The ARMA fit (phase 5): the lt-ua+plan stack of benchmarks/common.py
# (stack_spec(BenchSpec(), "lt-ua+plan")), written out: that module
# imports jax.  Kernel and plain version round every op alike and must
# agree bit for bit (ARMA_ATOL = 0).
SIM_WORKLOAD = dict(days=3.0, scale=0.05, seed=0)
SIM_PLANNER = {"min_instances": 2, "epsilon": 0.8, "fit_steps": 150,
               "theta_headroom": 0.7, "use_routing": True}
ARMA_ATOL = 0.0
ARMA_ORDERS = ((1, 1), (2, 1), (2, 2), (3, 1), (2, 0), (0, 1))
FMA_LATENCY_CYCLES = 4   # one dependent fp32 FMA on Hopper


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
class L2Flush:
    """Evicts the 50 MB L2 between timed launches: the served path reads
    each layer's weights and cache cold."""

    def __init__(self, dev):
        self.buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def __call__(self):
        self.buf.zero_()


def time_ms(fn, flush, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call: CUDA events around each call, the L2
    flushed before each.  A spin kernel runs between the flush and the
    start event, so the host has enqueued the whole call before the
    device reaches it: the events time device work, not the host's
    Python and launch overhead."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def profiled(label: str, fn):
    """Run fn once under torch.profiler and print where its device time
    went: wall time (inflated by the profiler), device-busy share, the
    kernels with the most self device time and the port's own kernels,
    and the host ops with the most self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  [profile] {label}: wall {wall_ms:.2f} ms under the profiler, "
        f"device busy {busy:.2f} ms ({busy / wall_ms:.0%}), "
        f"{sum(r[1] for r in rows)} kernel launches")
    ours = [r for r in rows[8:] if any(k in r[2] for k in PORT_KERNELS)]
    for ms, count, key in rows[:8] + ours:
        log(f"    {ms:8.3f} ms {ms / busy:5.1%} x{count:<5d} {key[:80]}")
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    log("    host ops with the most self CPU time: " + ", ".join(
        f"{key} {ms:.1f} ms x{count}" for ms, count, key in host[:6]))
    return out


# ---------------------------------------------------------------- kernels
def randn(dev, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_case(dev, dtype, gen, B, H, Hkv, S, T, hd, window=0,
               masked=False, padded=False):
    """Inputs laid out as the model passes them: transposed views of
    (B, S, H, hd) activations.  ``padded``: the first q tile of sequence
    0 holds padding (q_pos -1) and live rows."""
    q = randn(dev, (B, S, H, hd), dtype, gen).transpose(1, 2)
    k = randn(dev, (B, T, Hkv, hd), dtype, gen).transpose(1, 2)
    v = randn(dev, (B, T, Hkv, hd), dtype, gen).transpose(1, 2)
    qpos = (torch.arange(S, device=dev, dtype=torch.int32)
            + (T - S)).repeat(B, 1)
    kpos = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
    if masked:   # padding rows, and a gap no windowed row can see past
        qpos[0, : S // 8] = -1
        kpos[-1, T // 4: 3 * T // 4] = -1
    if padded:
        qpos[0, :70] = -1
    return (q, k, v, qpos, kpos), dict(scale=hd ** -0.5, window=window)


def decode_case(dev, dtype, gen, B, H, Hkv, T, hd, cur, window=0,
                ring=False, masked=False):
    """A (B, T, Hkv, hd) cache read through a transposed view; slots past
    cur are empty (-1), or hold a ring (slot = pos % T)."""
    q = randn(dev, (B, H, hd), dtype, gen)
    k = randn(dev, (B, T, Hkv, hd), dtype, gen).transpose(1, 2)
    v = randn(dev, (B, T, Hkv, hd), dtype, gen).transpose(1, 2)
    cur = torch.tensor(cur, device=dev, dtype=torch.int32)
    slots = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
    if ring:   # latest position p <= cur in slot p % T
        kpos = cur[:, None] - torch.remainder(cur[:, None] - slots, T)
    else:
        kpos = torch.where(slots <= cur[:, None], slots, -1)
    if masked:   # one sequence with an empty cache, one with cur < 0
        kpos[0] = -1
        cur[-1] = -1
    return (q, k, v, kpos, cur), dict(scale=hd ** -0.5, window=window)


def scan_case(dev, gen, b, c, h, p, n, decay=None, s0=False,
              strided=False):
    """K3's inputs as the model passes them: states (b,c,h,p,n) fp32 (or
    a strided view of a (b,h,c,p,n) buffer), the chunk decays as a
    strided view of a (b,c,cl,h) buffer, uniform in [0, 1) unless fixed
    to ``decay``, and s0 zero unless asked for."""
    shape = (b, h, c, p, n) if strided else (b, c, h, p, n)
    states = torch.randn(shape, generator=gen, device=dev)
    if strided:
        states = states.transpose(1, 2)
    dec = torch.rand((b, c, 2, h), generator=gen, device=dev)[:, :, -1]
    if decay is not None:
        dec.fill_(decay)
    init = (torch.randn((b, h, p, n), generator=gen, device=dev) if s0
            else torch.zeros((b, h, p, n), device=dev))
    return states, dec, init


def check_kernels(dev):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=dev).manual_seed(0)
    flash_cases = [
        ("starcoder2 prefill S=T=1999", dict(B=1, H=36, Hkv=4, S=1999,
                                              T=1999, hd=128)),
        ("starcoder2 prefill S=T=333", dict(B=1, H=36, Hkv=4, S=333,
                                             T=333, hd=128)),
        ("zamba2 prefill hd=112 S=T=1999", dict(B=1, H=32, Hkv=32, S=1999,
                                                 T=1999, hd=112)),
        ("zamba2 prefill hd=112 S=T=130", dict(B=1, H=32, Hkv=32, S=130,
                                                T=130, hd=112)),
        ("long: S=1024 of T=8192", dict(B=1, H=36, Hkv=4, S=1024, T=8192,
                                         hd=128)),
        ("gemma hd=256 g=1", dict(B=1, H=16, Hkv=16, S=700, T=700,
                                   hd=256)),
        ("window=256", dict(B=2, H=36, Hkv=4, S=1000, T=1000, hd=128,
                            window=256)),
        ("fully masked rows", dict(B=2, H=36, Hkv=4, S=200, T=200, hd=128,
                                   window=32, masked=True)),
        ("S=T=40 (S < 64)", dict(B=2, H=36, Hkv=4, S=40, T=40, hd=128)),
        ("S=1 of T=300", dict(B=1, H=32, Hkv=32, S=1, T=300, hd=112)),
        ("padded+live rows in a q tile", dict(B=2, H=36, Hkv=4, S=300,
                                              T=300, hd=128, padded=True)),
        ("hd=112 g=9 S=T=500", dict(B=1, H=36, Hkv=4, S=500, T=500,
                                     hd=112)),
        ("hd=128 g=1 S=T=500", dict(B=1, H=32, Hkv=32, S=500, T=500,
                                     hd=128)),
        ("hd=160 S=T=300", dict(B=1, H=8, Hkv=2, S=300, T=300, hd=160)),
        ("hd=32 S=T=300", dict(B=1, H=8, Hkv=2, S=300, T=300, hd=32)),
    ]
    decode_cases = [
        ("starcoder2 decode B=4 W=4096", dict(
            B=4, H=36, Hkv=4, T=4096, hd=128, cur=[4095, 1999, 777, 130])),
        ("zamba2 decode hd=112 B=4 W=4096", dict(
            B=4, H=32, Hkv=32, T=4096, hd=112, cur=[4095, 1999, 777, 130])),
        ("long: T=16384", dict(B=4, H=36, Hkv=4, T=16384, hd=128,
                               cur=[16383, 12000, 9000, 8192])),
        ("gemma hd=256 g=1", dict(B=4, H=16, Hkv=16, T=3000, hd=256,
                                  cur=[2999, 2000, 1000, 5])),
        ("ring W=1024 window=512", dict(B=4, H=36, Hkv=4, T=1024, hd=128,
                                        cur=[5000, 1500, 1023, 600],
                                        window=512, ring=True)),
        ("fully masked rows", dict(B=4, H=36, Hkv=4, T=4096, hd=128,
                                   cur=[3000, 100, 2000, 50], masked=True)),
        ("hd=112 g=9 B=4 W=4096", dict(
            B=4, H=36, Hkv=4, T=4096, hd=112, cur=[4095, 1999, 777, 130])),
        ("hd=128 g=1 B=4 W=4096", dict(
            B=4, H=32, Hkv=32, T=4096, hd=128, cur=[4095, 1999, 777, 130])),
        ("ragged W=1000, one chunk", dict(B=1, H=9, Hkv=1, T=1000, hd=128,
                                          cur=[999])),
    ]
    scan_cases = [
        ("zamba2 b=1 c=8 h=112 p=n=64", dict(b=1, c=8, h=112, p=64, n=64)),
        ("mamba2 b=1 c=8 h=32 p=64 n=128", dict(b=1, c=8, h=32, p=64,
                                                 n=128)),
        ("c=1", dict(b=2, c=1, h=112, p=64, n=64, s0=True)),
        ("c=33, random s0", dict(b=1, c=33, h=32, p=64, n=128, s0=True)),
        ("decays all 0", dict(b=1, c=8, h=112, p=64, n=64, decay=0.0,
                              s0=True)),
        ("decays all 1", dict(b=1, c=8, h=112, p=64, n=64, decay=1.0,
                              s0=True)),
        ("strided states", dict(b=2, c=5, h=112, p=64, n=64, s0=True,
                                strided=True)),
    ]
    errs = {"flash_attention": 0.0, "decode_attention": 0.0,
            "ssd_scan": 0.0, "arma_fit": 0.0}
    failed = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[dtype]
        for label, kw in flash_cases:
            args, opts = flash_case(dev, dtype, gen, **kw)
            got = fa.flash_attention(*args, **opts)
            want = ref.flash_attention_ref(*args, **opts)
            failed += report("flash_attention", label, dtype, got, want,
                             errs, tol, tol)
        for label, kw in decode_cases:
            args, opts = decode_case(dev, dtype, gen, **kw)
            got = dec.decode_attention(*args, **opts)
            want = ref.decode_attention_ref(*args, **opts)
            failed += report("decode_attention", label, dtype, got, want,
                             errs, tol, tol)
    for label, kw in scan_cases:
        args = scan_case(dev, gen, **kw)
        prev, fin = ssd.ssd_state_scan(*args)
        want_prev, want_fin = ref.ssd_state_scan_ref(*args)
        got = torch.cat([prev.flatten(), fin.flatten()])
        want = torch.cat([want_prev.flatten(), want_fin.flatten()])
        failed += report("ssd_scan", label, torch.float32, got, want, errs,
                         SCAN_ATOL, 0.0)
        if not torch.equal(prev[:, 0], args[2]):
            failed.append(f"ssd_scan {label}: prev[:, 0] is not s0")
    failed += check_arma(dev, gen, errs)
    if failed:
        raise SystemExit(f"kernel check failed: {failed}")
    return errs


def arma_rows(dev, gen, rows, length):
    """Rows as the forecast engine fits them: a differenced series with
    some persistence, normalized per row, fp32 on the card."""
    w = torch.randn((rows, length), generator=gen, device=dev)
    y = w + 0.6 * torch.roll(w, 1, dims=1) + 0.02 * torch.cumsum(w, 1)
    if length > 1:
        y = (y - y.mean(1, keepdim=True)) / (y.std(1, keepdim=True) + 1e-6)
    return y


def arma_plain(y, init, p, q, steps, lr=0.05):
    """The fit's plain version (host, float32) on card tensors."""
    from repro_torch.kernels import ref

    prm, loss = ref.arma_fit_ref(y.cpu(), init.cpu(), p, q, steps, lr)
    return prm.to(y.device), loss.to(y.device)


def check_arma(dev, gen, errs, steps=150):
    """The ARMA fit kernel against its plain version, bit for bit: every
    order of ``ARMA_ORDERS``, rows of 1, 8, 255 and 2,815 points (the
    unseasoned maximum), 12 rows, cold and warm inits; then repeats and a
    row alone, in a batch and permuted, at 37 rows."""
    from repro_torch.kernels import arma_fit

    failed = []
    for p, q in ARMA_ORDERS:
        k = p + 1 + q
        for length in (1, 8, 255, 2815):
            y = arma_rows(dev, gen, 12, length)
            for warm in (False, True):
                init = (0.1 * torch.randn((12, k), generator=gen, device=dev)
                        if warm else torch.zeros((12, k), device=dev))
                got = torch.cat([t.flatten() for t in arma_fit.arma_fit(
                    y, init, p, q, steps, 0.05)])
                want = torch.cat([t.flatten() for t in arma_plain(
                    y, init, p, q, steps)])
                failed += report("arma_fit", f"p={p} q={q} L={length} "
                                 f"{'warm' if warm else 'cold'}",
                                 torch.float32, got, want, errs, ARMA_ATOL,
                                 0.0)
    y = arma_rows(dev, gen, 37, 2815)
    init = 0.1 * torch.randn((37, 4), generator=gen, device=dev)
    prm, loss = arma_fit.arma_fit(y, init, 2, 1, steps, 0.05)
    again = arma_fit.arma_fit(y, init, 2, 1, steps, 0.05)
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(0))
    perm = perm.to(dev)
    permuted = arma_fit.arma_fit(y[perm], init[perm], 2, 1, steps, 0.05)
    alone = arma_fit.arma_fit(y[5:6], init[5:6], 2, 1, steps, 0.05)
    checks = {"repeat": torch.equal(again[0], prm)
              and torch.equal(again[1], loss),
              "permuted": torch.equal(permuted[0], prm[perm])
              and torch.equal(permuted[1], loss[perm]),
              "alone": torch.equal(alone[0][0], prm[5])
              and torch.equal(alone[1][0], loss[5])}
    log(f"  arma_fit         37 rows x 2815, (2,1): bit-identical "
        + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    failed += [f"arma_fit {k}" for k, v in checks.items() if not v]
    return failed


def report(name, label, dtype, got, want, errs, atol, rtol):
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool(torch.all(diff <= atol + rtol * want.float().abs())) \
        and bool(torch.isfinite(got).all()) \
        and got.shape == want.shape and got.dtype == want.dtype
    errs[name] = max(errs[name], err)
    log(f"  {name:16s} {str(dtype)[6:]:8s} {label:31s} max_abs_err={err:.3e}"
        f" atol={atol:g} rtol={rtol:g} {'ok' if ok else 'FAIL'}")
    return [] if ok else [f"{name} {dtype} {label}"]


def time_kernels(dev, errs):
    """Each kernel at the served shapes: the kernel, its plain version,
    the library call that computes the same function where there is one,
    and the bound computed from these inputs.  K2 and K1 are timed at
    StarCoder2-7B's widths (the row) and Zamba2-7B's hd = 112
    (``other_shapes``), K3 at Zamba2-7B's prefill of 2000 tokens."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = L2Flush(dev)
    cases = []

    def flash_row(label, B, H, Hkv, S, hd):
        """K2 at an S-token prompt, causal, positions 0..S-1."""
        args, opts = flash_case(dev, bf16, gen, B, H, Hkv, S, S, hd)
        q, k, v, _, _ = args
        kept = S * (S + 1) // 2                    # causal (q, k) pairs
        cases.append(dict(
            name="flash_attention", dtype=bf16,
            fn=lambda: fa.flash_attention(*args, **opts),
            plain=lambda: ref.flash_attention_ref(*args, **opts),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=opts["scale"],
                enable_gqa=True),
            flops=4 * B * H * hd * kept,           # QK^T and PV
            bytes=(2 * B * H * S * hd + 2 * B * Hkv * S * hd) * 2
            + 2 * B * S * 4,
            shape=f"{label}: B={B} H={H} Hkv={Hkv} S=T={S} hd={hd} bf16 "
                  f"causal",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:26"))

    def decode_row(label, B, H, Hkv, T, hd, cur):
        """K1 at B slots of a T-slot cache filled to ragged lengths."""
        args, opts = decode_case(dev, bf16, gen, B, H, Hkv, T, hd, cur)
        q, k, v, kpos, cpos = args
        kept = sum(c + 1 for c in cur)
        mask = (kpos >= 0) & (kpos <= cpos[:, None])
        cases.append(dict(
            name="decode_attention", dtype=bf16,
            fn=lambda: dec.decode_attention(*args, **opts),
            plain=lambda: ref.decode_attention_ref(*args, **opts),
            library=lambda: F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=mask[:, None, None],
                scale=opts["scale"], enable_gqa=True),
            flops=4 * H * hd * kept,
            bytes=(2 * kept * Hkv * hd + 2 * B * H * hd) * 2 + B * T * 4
            + B * 4,
            shape=f"{label}: B={B} H={H} Hkv={Hkv} W={T} hd={hd} bf16 "
                  f"cur={cur}",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:23"))

    flash_row("starcoder2-7b", 1, 36, 4, 2000, 128)
    decode_row("starcoder2-7b", 4, 36, 4, 4096, 128, [1999, 1499, 999, 499])
    flash_row("zamba2-7b", 1, 32, 32, 2000, 112)
    decode_row("zamba2-7b", 4, 32, 32, 4096, 112, [1999, 1499, 999, 499])

    # K3 at Zamba2-7B's prefill of a 2000-token prompt: 8 chunks of 256
    b, c, h, p, n = 1, 8, 112, 64, 64
    sargs = scan_case(dev, gen, b, c, h, p, n)
    cases.append(dict(
        name="ssd_scan", dtype=f32,
        fn=lambda: ssd.ssd_state_scan(*sargs),
        plain=lambda: ref.ssd_state_scan_ref(*sargs),
        library=None,            # no single PyTorch call computes the scan
        flops=2 * b * c * h * p * n,
        bytes=4 * (2 * b * c * h * p * n + 2 * b * h * p * n + b * c * h),
        shape=f"zamba2-7b: b={b} c={c} h={h} p={p} n={n} fp32",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:22"))

    rows = {}
    for r in cases:
        t_kernel = time_ms(r["fn"], flush)
        t_plain = time_ms(r["plain"], flush)
        t_lib = time_ms(r["library"], flush) if r["library"] else None
        t_ops = r["flops"] / PEAK_FLOPS[r["dtype"]] * 1e3
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        timed = dict(ms=t_kernel, plain_ms=t_plain,
                     bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes",
                     library_ms=t_lib, shape=r["shape"])
        if r["name"] in rows:
            rows[r["name"]]["other_shapes"].append(timed)
        else:
            rows[r["name"]] = dict(
                name=r["name"], route="cuda", source=r["source"],
                replaces=r["replaces"], launches=None,
                max_abs_err=errs[r["name"]], **timed, other_shapes=[])
        lib = "n/a" if t_lib is None else f"{t_lib:.4f} ms"
        log(f"  {r['name']:16s} {r['shape']}: kernel {t_kernel:.4f} ms, "
            f"plain {t_plain:.4f} ms, library {lib}, bound "
            f"{timed['bound_ms']:.4f} ms ({timed['bound_by']})")
    del flush
    return list(rows.values())


# ---------------------------------------------------------------- serving
#: (arch, requests, new tokens per request) served in turn; the kernels
#: each run must launch follow from its config (``expected_launches``)
SERVED = (("starcoder2-7b", 8, 32), ("zamba2-7b", 8, 32),
          ("mamba2-370m", 4, 16))


def expected_launches(cfg, prefill_calls: int, decode_calls: int):
    """K3 once per SSM layer per prefill; K2 (prefill) and K1 (decode)
    once per attention layer, or per shared-block group of the hybrid."""
    from repro_torch.models import transformer as tfm

    if not tfm.is_ssm(cfg):
        n_ssm, n_attn = 0, cfg.num_layers
    else:
        n_ssm = cfg.num_layers
        n_attn = len(tfm._hybrid_groups(cfg)) if cfg.attn_every else 0
    return {"flash_attention": n_attn * prefill_calls,
            "decode_attention": n_attn * decode_calls,
            "ssd_scan": n_ssm * prefill_calls}


def serve(dev, arch: str, n_requests: int, max_new: int):
    """Serve ``arch`` at full size.  Returns its kernel launch counts and
    the longest request's prompt and generated tokens but the last."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_arch(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name} ({cfg.family}): {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B params in {cfg.dtype}, "
        f"init {time.perf_counter() - t0:.1f} s")

    eng = ServingEngine(cfg, params, max_batch=4, max_seq=4096,
                        scheduler="dpa", device=dev)
    cache_gib = sum(t.numel() * t.element_size()
                    for leaves in eng.cache.values()
                    for t in leaves.values()) / 2**30
    log(f"  decode cache for 4 slots x 4096: {cache_gib:.2f} GiB")
    reqs = make_requests(cfg, n_requests, max_new=max_new,
                         prompt_len=(100, 2001))
    for r in reqs:
        eng.submit(r)

    # Record each step's logits per request and the time in each path;
    # profile one decode step (all four slots busy) and one prefill
    # instead of timing them.
    last_logits = {}
    stats = {"decode_calls": 0, "decode_steps": 0, "decode_s": 0.0,
             "decode_tokens": 0, "prefill_calls": 0, "prefill_s": 0.0,
             "prefill_tokens": 0}
    decode, prefill = eng._decode, eng._prefill

    def timed(fn, kind, label, ntok):
        stats[f"{kind}_calls"] += 1
        if stats[f"{kind}_calls"] == PROFILED_CALL:
            return profiled(label, fn)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stats[f"{kind}_s"] += time.perf_counter() - t
        stats[f"{kind}_tokens"] += ntok
        if kind == "decode":
            stats["decode_steps"] += 1
        return out

    def timed_decode(p, toks, cache, pos):
        owners = [s.req.rid if s.req is not None else None
                  for s in eng.slots]
        active = sum(rid is not None for rid in owners)
        logits, cache = timed(lambda: decode(p, toks, cache, pos), "decode",
                              f"decode step, {active} active slots", active)
        for i, rid in enumerate(owners):
            if rid is not None:
                last_logits[rid] = logits[i, 0].float()
        return logits, cache

    def timed_prefill(p, batch):
        n = batch["tokens"].shape[1]
        return timed(lambda: prefill(p, batch), "prefill",
                     f"prefill of {n} tokens", n)

    eng._decode, eng._prefill = timed_decode, timed_prefill
    fa.LAUNCHES = dec.LAUNCHES = ssd.LAUNCHES = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES,
                "decode_attention": dec.LAUNCHES,
                "ssd_scan": ssd.LAUNCHES}

    for r in reqs:
        log(f"  req {r.rid} [{r.tier}] prompt={len(r.prompt)} "
            f"ttft_step={r.ttft_step} done_step={r.done_step} "
            f"tokens={len(r.tokens)}")
    if any(r.done_step is None or len(r.tokens) != r.max_new_tokens
           for r in reqs):
        raise SystemExit(f"serve {arch}: a request did not finish")
    want = expected_launches(cfg, stats["prefill_calls"],
                             stats["decode_calls"])
    log(f"  launches {launches}, expected {want} ({stats['prefill_calls']} "
        f"prefill calls, {stats['decode_calls']} decode calls)")
    if launches != want:
        raise SystemExit(f"serve {arch}: kernel launch counts do not match "
                         f"the served work")
    log(f"  {eng.step_count} engine steps in {wall:.2f} s (one prefill and "
        f"one decode step profiled, the rest timed): prefill "
        f"{stats['prefill_tokens']} tokens in {stats['prefill_s']:.3f} s = "
        f"{stats['prefill_tokens'] / stats['prefill_s']:.0f} tokens/s; decode "
        f"{stats['decode_steps']} steps, {stats['decode_tokens']} tokens in "
        f"{stats['decode_s']:.3f} s = "
        f"{stats['decode_tokens'] / stats['decode_s']:.1f} tokens/s "
        f"({stats['decode_s'] / stats['decode_steps'] * 1e3:.2f} ms/step)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
        f" GiB")

    # The decode path's last logits for the longest request against a
    # full forward over its prompt and all but its last generated token.
    r = max(reqs, key=lambda x: len(x.prompt))
    seq = list(r.prompt) + r.tokens[:-1]
    full, _, _ = model.forward(
        cfg, params, {"tokens": torch.tensor([seq], device=dev)})
    ref_logits = full[0, -1].float()
    got = last_logits[r.rid]
    rel = float((got - ref_logits).norm() / ref_logits.norm())
    mx = float((got - ref_logits).abs().max())
    bounded = cfg.family == "dense"
    log(f"  req {r.rid}: last decode logits vs full forward over {len(seq)} "
        f"tokens: rel L2 {rel:.3e} "
        f"({f'tol {SERVE_LOGIT_TOL:g}' if bounded else 'bf16, not bounded'})"
        f", max abs {mx:.3e} of max |logit| "
        f"{float(ref_logits.abs().max()):.3f}, argmax {int(got.argmax())} vs "
        f"{int(ref_logits.argmax())}, emitted {r.tokens[-1]}")
    if not (torch.isfinite(got).all()
            and (rel <= SERVE_LOGIT_TOL or not bounded)):
        raise SystemExit(f"serve {arch}: decode logits disagree with the "
                         f"full forward")
    return launches, seq


def check_fp32_decode(dev, arch: str, seq, steps: int) -> float:
    """``seq`` through ``arch`` in fp32 (the same seeded draws as the
    served bf16 weights, before rounding): a prefill of all but the last
    ``steps`` tokens, ``steps`` decode steps over those, and the last
    logits against a full forward over ``seq``."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model
    from repro_torch.serving.engine import _write_slot

    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    toks = torch.tensor([seq], device=dev)
    n = len(seq)
    want = model.forward(cfg, params, {"tokens": toks})[0][0, -1].float()
    _, pre, _ = model.forward(cfg, params, {"tokens": toks[:, :n - steps]},
                              return_cache=True)
    cache = model.init_decode_cache(cfg, 1, n, device=dev)
    _write_slot(cache, pre, 0)
    for t in range(n - steps, n):
        pos = torch.tensor([t], dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(cfg, params, toks[:, t:t + 1],
                                          cache, pos)
    got = logits[0, 0].float()
    rel = float((got - want).norm() / want.norm())
    log(f"  fp32: {steps} decode steps after a prefill of {n - steps} "
        f"tokens vs full forward over {n}: rel L2 {rel:.3e} (tol "
        f"{FP32_LOGIT_TOL:g}), argmax {int(got.argmax())} vs "
        f"{int(want.argmax())}")
    if not (rel <= FP32_LOGIT_TOL and torch.isfinite(got).all()):
        raise SystemExit(f"{arch}: fp32 decode logits disagree with the "
                         f"full forward")
    return rel


# ---------------------------------------------------------------- simulate
def sim_stack(dev):
    """The lt-ua+plan stack, its forecast fits on ``dev``."""
    from repro_torch.api import PolicySpec, StackSpec, build_stack
    from repro_torch.sim.workload import PAPER_MODELS, REGIONS

    return build_stack(StackSpec(
        models=PAPER_MODELS, regions=REGIONS, scaler="lt-ua", router="plan",
        initial_instances=5, spot_spare=30, scheduler="fcfs",
        planner=PolicySpec("sageserve", dict(SIM_PLANNER))), device=dev)


def simulate(dev):
    """Run the 3-day trace through the lt-ua+plan stack with its fits on
    ``dev``.  Records, per hourly boundary, the planner's inputs, the
    forecast engine's warm parameters before and after and the Plan, and
    every batch the fit kernel was given.  Returns the run and the kernel
    launch counts, set to 0 just before ``simulate`` and read just
    after."""
    from repro_torch.api import stack as stack_mod
    from repro_torch.control import forecast
    from repro_torch.kernels import arma_fit
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.sim.workload import WorkloadSpec, generate_trace

    t0 = time.perf_counter()
    reqs = generate_trace(WorkloadSpec(**SIM_WORKLOAD)).to_requests()
    log(f"  trace: {len(reqs)} requests over {SIM_WORKLOAD['days']:g} days "
        f"(scale {SIM_WORKLOAD['scale']}, seed {SIM_WORKLOAD['seed']}) in "
        f"{time.perf_counter() - t0:.1f} s")
    stack = sim_stack(dev)
    planner, engine = stack.planner, stack.planner.engine
    run = dict(stack=stack, requests=len(reqs), boundaries=[], fits=[],
               sims=[])
    plan, fit_batch = planner.plan, forecast._fit_arma_batch

    def recorded_plan(now, instances, history, niw):
        rec = dict(now=now, instances=dict(instances), niw=dict(niw),
                   history={k: np.array(v) for k, v in history.items()},
                   warm_before=copy.deepcopy(engine._warm))
        out = plan(now, instances, history, niw)
        rec.update(plan=out, warm_after=copy.deepcopy(engine._warm))
        run["boundaries"].append(rec)
        return out

    def recorded_fit(y, init, p, q, steps=400, lr=0.05):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fit_batch(y, init, p, q, steps=steps, lr=lr)
        end.record()
        run["fits"].append(dict(y=y, init=forecast._pack(init, len(y), p, q),
                                p=p, q=q, steps=steps, lr=lr,
                                events=(start, end)))
        return out

    class Counted(stack_mod.Simulation):
        def run(self):
            run["sims"].append(self)
            return super().run()

    planner.plan = recorded_plan
    fa.LAUNCHES = dec.LAUNCHES = ssd.LAUNCHES = arma_fit.LAUNCHES = 0
    t0 = time.perf_counter()
    with mock.patch.object(forecast, "_fit_arma_batch", recorded_fit), \
            mock.patch.object(stack_mod, "Simulation", Counted):
        run["report"] = stack.simulate(reqs, name="lt-ua+plan")
    torch.cuda.synchronize()
    run["wall"] = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES,
                "decode_attention": dec.LAUNCHES,
                "ssd_scan": ssd.LAUNCHES, "arma_fit": arma_fit.LAUNCHES}
    del planner.plan
    return run, launches


def report_simulation(run, launches) -> None:
    """Print the run's Report and control-plane counters; fail on a run
    that did not complete, fitted nothing or fitted off the kernel."""
    rep, stack = run["report"], run["stack"]
    planner, engine = stack.planner, stack.planner.engine
    done = sum(rep.completed.values())
    total = done + sum(rep.dropped.values())
    hist = planner.solve_history
    log(f"  {run['requests']} requests, {run['sims'][0].events_processed} "
        f"events in {run['wall']:.1f} s wall; completed {done} of {total} "
        f"({done / max(total, 1):.5f})")
    log(f"  GPU-hours {rep.total_instance_hours():.2f}, dollars "
        f"{rep.total_gpu_dollars():.2f}, SLA attainment "
        + ", ".join(f"{t} {1 - v:.5f}" for t, v in rep.sla_violations.items()))
    log(f"  {len(run['boundaries'])} hourly boundaries; fits {engine.fits}, "
        f"unique fits {engine.unique_fits}, dedupe hits {engine.dedup_hits}, "
        f"cache hits {engine.cache_hits}; fit-kernel launches "
        f"{launches['arma_fit']} (engine batches {engine.batches}); host "
        f"forecast {sum(h['forecast_s'] for h in hist):.2f} s, ILP "
        f"{sum(h['ilp_s'] for h in hist):.2f} s")
    lengths = sorted({f["y"].shape[1] for f in run["fits"]})
    fit_s = sum(f["events"][0].elapsed_time(f["events"][1])
                for f in run["fits"]) / 1e3
    log(f"  fitted row lengths {lengths[0]}..{lengths[-1]} "
        f"({len(lengths)} distinct); the fit calls' device time (kernel "
        f"and its parameter upload, CUDA events) {fit_s:.3f} s, "
        f"{fit_s / run['wall']:.1%} of the run's wall time")
    if not (total == run["requests"] and done > 0 and engine.unique_fits > 0
            and launches["arma_fit"] == engine.batches > 0
            and engine.device.type == "cuda"):
        raise SystemExit("simulate: the run did not complete or did not fit "
                         "on the kernel")
    if any(n for k, n in launches.items() if k != "arma_fit"):
        raise SystemExit(f"simulate: unexpected launches {launches}")


def replay_plain(run) -> dict:
    """Every boundary again with the fit's plain version on the host: the
    engine from the same warm parameters, its parameters against the
    kernel's, and the ILP targets of its forecasts against the run's."""
    from repro_torch.control import forecast

    planner, engine = run["stack"].planner, run["stack"].planner.engine
    cfg = planner.cfg
    out = dict(keys=0, equal=0, diverged=0, max_abs_err=0.0, targets=0,
               flips=0, peak_rel=0.0, seasonal=0, longest=0)
    forecast.clear_fit_cache()
    t0 = time.perf_counter()
    for rec in run["boundaries"]:
        cpu = forecast.BatchForecastEngine(
            p=engine.p, d=engine.d, q=engine.q,
            seasonal_period=engine.seasonal_period,
            fit_steps=engine.fit_steps, device="cpu")
        cpu._warm = copy.deepcopy(rec["warm_before"])
        fitted = cpu.fit_forecast(rec["history"], cfg.horizon_windows)
        for key, prm in rec["warm_after"].items():
            got = np.concatenate([np.ravel(prm[n])
                                  for n in forecast.PARAM_NAMES])
            want = np.concatenate([np.ravel(cpu._warm[key][n])
                                   for n in forecast.PARAM_NAMES])
            out["keys"] += 1
            out["equal"] += bool(np.array_equal(got, want, equal_nan=True))
            out["diverged"] += not np.isfinite(got).all()
            err = np.abs(got - want)
            if np.isnan(err).any() and not np.array_equal(
                    np.isnan(got), np.isnan(want)):
                err = np.array([np.inf])
            out["max_abs_err"] = max(out["max_abs_err"],
                                     float(np.nanmax(err, initial=0.0)))
        n = max((len(h) for h in rec["history"].values()), default=0)
        out["seasonal"] += engine._seasonal_for(engine._fit_len(n)) > 0
        out["longest"] = max(out["longest"], engine._fit_len(n))
        plain = planner.plan(rec["now"], rec["instances"], rec["history"],
                             rec["niw"], fitted=fitted)
        for key, target in rec["plan"].targets.items():
            out["targets"] += 1
            out["flips"] += plain.targets[key] != target
            ref = rec["plan"].forecasts[key]
            out["peak_rel"] = max(out["peak_rel"], abs(
                plain.forecasts[key] - ref) / max(abs(ref), 1.0))
    log(f"  plain replay of {len(run['boundaries'])} boundaries "
        f"({out['seasonal']} seasonal, longest fit window {out['longest']} "
        f"buckets) in {time.perf_counter() - t0:.1f} s: {out['equal']} of "
        f"{out['keys']} fitted parameter sets bit-identical (max abs err "
        f"{out['max_abs_err']:.3e}, tol {ARMA_ATOL:g}; {out['diverged']} "
        f"diverged to inf/nan on both, which the planner replaces by the "
        f"observed peak); {out['flips']} of "
        f"{out['targets']} ILP instance targets changed; forecast peaks "
        f"rel diff up to {out['peak_rel']:.3e}")
    if not (out["keys"] and out["equal"] == out["keys"] and out["seasonal"]
            and out["flips"] == 0):
        raise SystemExit("simulate: the fit kernel disagrees with its plain "
                         "version on the run's own inputs")
    return out


def arma_bound(rows, length, p, q, steps):
    """(operations, bytes, dependency-chain steps) of one fit launch:
    per point and step, the residual (1 + 2p + 2q ops), its square sum
    (2), p+q+1 sensitivity chains (2q each) and their sums (2 each); the
    rows read once, init read and params written, the losses written."""
    k = p + 1 + q
    per_point = 1 + 2 * p + 2 * q + 2 + k * 2 * q + 2 * k
    return (rows * steps * length * per_point,
            4 * (rows * length + 2 * rows * k + rows), steps * length)


def time_arma(dev, run, errs, launches, replay):
    """The fit kernel at the run's longest fitted rows: CUDA events (L2
    flushed), its plain version on the host, its bound and the chain
    floor of the simple design."""
    from repro_torch.kernels import arma_fit

    fit = max(run["fits"], key=lambda f: (f["y"].shape[1], f["y"].shape[0]))
    y, p, q, steps = fit["y"], fit["p"], fit["q"], fit["steps"]
    init = torch.from_numpy(fit["init"]).to(dev)
    flush = L2Flush(dev)
    t_kernel = time_ms(lambda: arma_fit.arma_fit(y, init, p, q, steps,
                                                 fit["lr"]), flush, reps=5)
    t0 = time.perf_counter()
    arma_plain(y, init, p, q, steps, fit["lr"])
    t_plain = (time.perf_counter() - t0) * 1e3
    del flush
    ops, nbytes, chain = arma_bound(y.shape[0], y.shape[1], p, q, steps)
    t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    clock_mhz = float(smi_line("clocks.max.sm").split()[0])
    chain_ms = chain * FMA_LATENCY_CYCLES / (clock_mhz * 1e6) * 1e3
    shape = (f"lt-ua+plan run, longest rows: S={y.shape[0]} L={y.shape[1]} "
             f"p={p} q={q} steps={steps} fp32")
    log(f"  arma_fit         {shape}: kernel {t_kernel:.4f} ms, plain "
        f"{t_plain:.1f} ms (host), library n/a, bound "
        f"{max(t_ops, t_bytes):.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), chain floor "
        f"{chain_ms:.4f} ms ({steps} x {y.shape[1]} x {FMA_LATENCY_CYCLES} "
        f"cycles at {clock_mhz:.0f} MHz)")
    return dict(
        name="arma_fit", route="cuda",
        source="src/repro_torch/kernels/csrc/arma_fit.cu",
        replaces="src/repro/control/forecast.py:145",
        launches=launches["arma_fit"],
        max_abs_err=max(errs["arma_fit"], replay["max_abs_err"]),
        ms=t_kernel, plain_ms=t_plain, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, chain_floor_ms=chain_ms, shape=shape,
        plain_on="host (float32 numpy/scipy)",
        launches_by_run={"lt-ua+plan": launches["arma_fit"]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} of {len(_build.SOURCES)} kernel sources "
        f"compiled into {_build.BUILD_DIR.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)] \
            or [0]
        spill = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                            text)] or [0]
        log(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers per thread, spill stores up to {max(spill)} bytes")
        for fn, n in re.findall(r"Function properties for (\S+)\s+\d+ "
                                r"bytes stack frame, (\d+) bytes spill "
                                r"stores", text):
            if int(n):
                log(f"    {n} bytes spilled by {fn}")
        # the Hopper kernels one by one: <head dim> registers
        found = re.findall(r"Compiling entry function '\S*?(flash_fwd_wgmma|"
                           r"decode_split_mma)ILi(\d+)E\S*'[\s\S]*?Used "
                           r"(\d+) registers", text)
        if found:
            log("    " + ", ".join(f"{k}<{d}> {r}" for k, d, r in found)
                + " registers")

    log("[kernels] kernel vs plain PyTorch version on the card")
    errs = check_kernels(dev)
    log("[kernels] timing at the served shapes (L2 flushed per launch)")
    rows = time_kernels(dev, errs)

    by_run = {}
    for arch, n_requests, max_new in SERVED:
        log(f"[serve] {arch}, full width and depth, DPA, {n_requests} "
            f"requests of {max_new} new tokens")
        by_run[arch], seq = serve(dev, arch, n_requests, max_new)
        gc.collect()             # the engine's timing hooks form a cycle
        torch.cuda.empty_cache()
        log(f"  freed: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
            f"still allocated")
        check_fp32_decode(dev, arch, seq, max_new - 1)
        gc.collect()
        torch.cuda.empty_cache()
    for row in rows:
        row["launches_by_run"] = {a: n[row["name"]]
                                  for a, n in by_run.items()}
        row["launches"] = sum(row["launches_by_run"].values())
        if row["launches"] <= 0:
            raise SystemExit(f"{row['name']} never launched on the served "
                             f"paths")

    log(f"[simulate] lt-ua+plan, event loop, {SIM_WORKLOAD['days']:g} days, "
        f"forecast fits on the card")
    run, sim_launches = simulate(dev)
    report_simulation(run, sim_launches)
    replay = replay_plain(run)
    rows.append(time_arma(dev, run, errs, sim_launches, replay))

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
