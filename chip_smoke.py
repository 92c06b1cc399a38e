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
   cache (T = 8192 and 16384), Gemma's head_dim 256, head_dim 160 and
   head_dim 96 (the train example's, B = 8, S = T = 128),
   DeepSeek-V3's MLA head_dim 192 (H = Hkv = 128, S = T = 1999 and a
   ragged 333), Llama-4 Scout's group of 5, Whisper-tiny's bidirectional
   encoder (S = T = 1500), its cross-attention (S != T) and its decode
   against the 1500-slot cross cache, a sliding window, fully masked
   rows, a q tile of padded and live rows, S and T off the 128-row
   tiles, S < 64 and one query row, and V at its own head dim: MLA's
   q/k 192 against V 128 (S = T = 1999, a ragged 333, fully masked
   rows), Gemma-7B's causal hd 256 (H = Hkv = 16, S = T = 2048) and
   hd 160 at g 4 (S = T = 2048), and K1 also at StableLM-12B's hd 160
   (g 4), Qwen2-72B's group of 8 and the train example's hd 96 (B = 8,
   H = Hkv = 8, a 4096-slot cache); the SSD state scan (K3) in fp32 at
   Zamba2-7B's and Mamba2-370M's prefill shapes, one chunk, 33 chunks
   from a random state, decays all 0 and all 1, strided states and
   Mamba2-370M's trained shape (b = 4).  The two backward kernels
   against their plain versions (``ref.flash_attention_bwd_ref``,
   ``ref.ssd_state_scan_bwd_ref``) at every one of those K2 and K3
   shapes: K2's in bf16 and fp32, from its own forward output and
   log-sum-exp (held to the plain version's too), K3's dstates and ds0
   bit for bit and ddecay to ``DDECAY_RTOL``; each K2 shape is logged
   with the route its backward took (``wgmma``: bf16 at every head dim;
   ``fma``: fp32).  Then each is timed at
   the served shapes beside its bound, its plain version and, for
   attention, ``scaled_dot_product_attention`` (timed only; the port
   never calls it; no single PyTorch call computes K3's scan); the
   backward kernels at the trained shapes and at StableLM-12B's,
   Gemma-7B's and DeepSeek-V3's MLA widths (K2's forward also at
   StableLM-12B's hd 160, Gemma-7B's hd 256 and, both ways, at the train
   example's hd 96, B = 8, S = T = 128; K1 at its model's decode, B = 8
   over 4096 slots), K2's beside the autograd
   backward of ``scaled_dot_product_attention`` (timed only), with each
   of its kernels' device time;
4. serve: StarCoder2-7B (dense), Zamba2-7B (hybrid: 81 Mamba2 layers
   and a shared attention block after every 6), Mamba2-370M (pure SSM),
   Llama-4 Scout (MoE, 16 experts top-1 and a shared one; 8 of 48
   layers), DeepSeek-V3 (MLA and MoE, 256 experts top-8 and a shared
   one; its 3 dense and 2 MoE layers of 61), Pixtral-12B (VLM: 4 zero
   patch embeddings ahead of each prompt), Whisper-tiny (audio:
   1500 zero frames, encoder and decoder), StableLM-12B (LayerNorm, hd
   160, g 4), Gemma-7B (GeGLU, hd 256, tied embeddings) and Qwen2-72B
   (QKV biases, theta 1e6, g 8; 8 of 80 layers), all at their published
   widths, in bf16, random weights from a seeded generator (expert
   stacks drawn expert by expert), each freed before the next, behind
   ``ServingEngine`` with DPA scheduling: 8 requests of 100-2000 prompt
   tokens and 32 new tokens each (Mamba2-370M, Whisper-tiny and the
   last three 4 of 16).  Each run's launch counts must match its served
   work (K3 once per SSM layer per prefill; K2 once per attention layer
   or group per prefill, and for Whisper also once per encoder layer and
   cross-attention; K1 once per attention layer or group per decode
   step, for Whisper twice, for MLA never: its latent attention is
   plain), and the longest request's last decode logits are held to a
   full forward over its prompt and generated tokens: in bf16 for the
   dense, VLM and audio models (``SERVE_LOGIT_TOL``; the SSM, hybrid and
   MoE models' gaps are printed, with the pairs the MoE forward dropped
   at capacity); for every model, the same tokens through the same
   model in fp32, a prefill and all but one of its new tokens as decode
   steps against a full forward (``FP32_LOGIT_TOL``), at a capacity
   where nothing drops and, where the served depth does not fit in
   fp32, at the depth of ``FP32_CUT``.  Each prints prefill tokens/s,
   ms per decode step, peak memory and a profiled prefill and decode
   step with the device-busy share and the MoE expert products' and
   MLA latent attention's shares.  Serving launches no backward kernel;
5. train: ``train.loop.train`` (AdamW on a cosine schedule, synthetic
   ``SyntheticLM`` batches, each layer recomputed in the backward pass)
   at full published width for a few steps: StarCoder2-7B at 16 of its
   32 layers (3.93 B parameters, a 47.1 GB training state), B = 2,
   S = 2048, through K2 and its backward kernel, and Mamba2-370M whole,
   B = 4, S = 2048, through K3 and its backward (``TRAINED``).  Each
   prints the loss, gradient norm, time and tokens/s of every step
   (one profiled), the peak memory and the launches, which must match
   the trained work (K2 and K3 forward once per layer and again for the
   recompute, their backward once); every gradient must be present and
   finite and the loss must fall.  DeepSeek-V3 at its 3 dense layers
   (3.6 B parameters, a 43 GB state), B = 2, S = 2048, trains MLA through
   K2 at q/k 192 and V 128, forward and backward, and Gemma-7B at 4 of
   its 28 layers, B = 2, S = 2048, 3 steps, K2's wide backward at hd
   256.  Then one fp32 forward and backward at full width and cut depth
   (``FP32_TRAIN``: also StableLM-12B's hd 160 and Gemma-7B's hd 256)
   through the kernels against the same with ``kernels.ops`` patched to
   the plain versions on the card: the loss and every gradient leaf;
6. placement: an NCCL process group of one rank and ``make_local_mesh()``
   = (1, 1) with a ``DeviceMesh``.  The train phase's StarCoder2-7B
   case and Mamba2-370M at B 2 x S 1024 (``PLACED_TRAIN``) each take one
   step with their parameters, AdamW's moments and their batch placed by
   ``TRAIN_RULES`` (DTensors; the SSM's in_proj re-split by
   ``sharding.take``, forward and backward), against the same step
   unplaced from the same weights and batch (Mamba2-370M in fp32): the
   loss and every gradient leaf, bit for bit or within
   ``PLACED_LOSS_TOL`` / ``PLACED_GRAD_TOL`` (fp32: the fp32 training
   check's; printed which); K2's forward and backward launches by the
   profiler must be equal, and every placed K2 and K3 call goes through
   ``local_map``; both steps' ms.  DeepSeek-V3 (5 of 61 layers: MLA,
   MoE) and Zamba2-7B (K3) run a prefill and ``PLACED_DECODE`` decode
   steps under ``SERVE_RULES`` against the unplaced run: logits within
   ``PLACED_LOGIT_TOL`` (or bit for bit), the MoE pairs dropped at
   capacity (``moe.DROPPED``) equal, K1, K2 and K3 launches matching
   the work, each through ``local_map``;
7. dryrun: ``launch.dryrun`` on the host, on the meta device, for all 10
   architectures x 4 shapes at full size (parameters, argument bytes on
   one card, whether they fit 80 GB, counted FLOPs and unfused bytes,
   their times at the H100's peaks, the bottleneck and the useful
   share), and each placed on 16x16 (a fake process group of 256): one
   device's FLOPs, bytes and collective bytes, the compute, memory and
   collective terms and the bottleneck, and the trace seconds; any
   failing case fails the phase, as does a placed SSM train step
   (Mamba2-370M, Zamba2-7B at train_4k) whose collective term is more
   than ``TORCH_VERSION_TOL`` from the one this repo's CPU dry run gives
   under torch 2.13 (``SSM_TRAIN_COLLECTIVE_MS``).
   For each config phase 5 trained, the dry run's argument bytes
   (parameters, AdamW's state, the batch) must equal the device memory
   the run had requested when its first step started, within
   ``DRY_MEMORY_SLACK``, and ``memory_allocated`` within the caching
   allocator's rounding; its roofline is printed beside the measured
   step;
8. simulate: the paper's main path.  A 3-day trace
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

9. vector: the paper's main path on the vector engine.
   ``run_experiment(ExperimentSpec(engine="vector"), device=cuda)`` over
   the same 3-day trace with the seven strategies of the reference's
   benchmarks (siloed, reactive, LT-I, LT-U, LT-UA, ``lt-ua+plan``,
   chiron): the unified stacks step as one batch of 6 replicas, siloed
   alone, every segment of buckets one launch of the ``bucket_step``
   kernel (the launch count must equal the segments) and every hourly
   boundary's forecast fits one ``arma_fit`` batch across the fleet.
   Each Report is printed; the vector ``lt-ua+plan`` Report must lie
   within the reference's vector-vs-event tolerance of phase 8's (0.02
   completion, 10% GPU-hours and dollars).  The run is made once more
   under torch.profiler for the kernels' own device time and the run's
   device-busy share (the CUDA events around each launch also hold the
   host's enqueue gaps).  Every segment of both batches (78 hourly
   segments of 6 replicas, the siloed run's one segment of 18,721
   buckets) is replayed bucket by bucket through the plain step on the
   card, one bucket's plain step captured in a CUDA graph, and must
   equal the kernel's bit for bit.  Then
   ``bucket_step`` is timed at a 240-bucket segment (an hour between two
   boundaries) for one replica and for 8, beside its byte bound, the
   chain floor of one bucket's dependent ops (``BUCKET_CHAIN``), the
   eager plain step and the plain step captured in a CUDA graph (a
   measurement only);
10. analysis: reprolint on the card's host, which has no JAX: the AST
   tier (``repro_torch.analysis.run_lint``) over ``src/repro_torch`` must
   find no violation and no stale suppression, and the trace tier
   (``run_trace(device=cuda)``) must pass T1-T4 against the vector
   engine's segment and the batched forecast fit through the real
   ``bucket_step`` and ``arma_fit`` kernels: no host sync in either
   (recorded by a dispatch mode and under
   ``torch.cuda.set_sync_debug_mode("error")``), no float64, an honest
   segment-cache key, at most two carries alive across five segments
   of a real ``VectorBatch`` with ``memory_allocated`` flat; each
   check's time is printed;
11. examples: the four ``examples/torch_*.py`` (``EXAMPLES``), each in a
    process of its own on the card with its counterpart's defaults, all
    started together: each must exit 0, and prints its wall time.

The bucket step is also checked in phase 3 against its plain version bit
for bit on seeded segments (``bucket_step.synthetic_case``): one replica
and one bucket, every mode in one batch, unified and siloed pools, 8
models x 2 pools (48 cells, more than a warp), 8 replicas, a ring
collision (a cell's swap, local and remote delays equal), a region down,
a dead model past its drop budget, no plan rows, a segment that wraps
the ring, J = 1, 2, 4, 5, 8 and 6 (each region count the kernel
specialises, and one it takes at run time), a ring of 96 rows (whole
chunks of 32), 72 cells (4 a lane), 144 (the kernel for more than 128
cells) and 330 (too many to stage the outputs in shared memory); then a
replica alone, in a permuted batch, and a repeat.

The ARMA fit kernel (``arma_fit``) is also checked in phase 3 against
its plain version bit for bit: orders (1,1), (2,1), (2,2), (3,1), (2,0),
(0,1) and, at p + q = 8, (3,5), (0,8), (8,0); rows at the edges of its
chunk layout (one chunk of 256 T consecutive points a thread): 1, 8 and
255 points (a point a chunk), 257, 511, 2,815 and 2,817 (256 T +- 1)
and the longest row the wrapper takes; cold and warm
inits, repeats, and a row alone, in a batch and permuted.  After the
simulation it is timed at the run's longest rows and at 8 replicas of
them (the batch a fleet of replicas fits at once).

The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` line,
phase 6's summary (``{"placement": ...}``: each run's step ms or
seconds, whether bit for bit, the pairs dropped; placed, then unplaced)
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
# The backward kernels against their plain versions.  K2's: fp32 1e-4
# (both fp32, sums over up to 8192 keys or rows in other orders), bf16
# 3e-2 (gradients rounded once to bf16 on both sides); its log-sum-exp
# to LSE_ATOL (fp32 on both sides; the bf16 forward's scores come from
# the tensor cores).  K3's: dstates and ds0 bit for bit (the same two
# ops, rounded apart), ddecay (a sum over p*n elements in another order)
# within DDECAY_RTOL of the sum of its terms' magnitudes.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LSE_ATOL = 1e-3
DDECAY_RTOL = 1e-5
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
# back toward the 8.3e-2 of the first such run.  The JAX package drifts
# the same way: on the CPU the port's bf16 gap stays within 2x of the
# reference's on the same weights (tests/test_torch_ssm_bf16.py).  So the
# gap is printed beside a yardstick, the bf16 full forward's own error
# against the fp32 full forward of the same weights.  fp32, every model:
# the same path agrees to 2.0e-5, and is held to 1e-3, the reference's
# own bound for a decode step against the full forward in fp32.
SERVE_LOGIT_TOL = 3e-2
FP32_LOGIT_TOL = 1e-3
PROFILED_CALL = 2        # which prefill and which decode call to profile
#: K2's backward kernels: the tensor-core route (bf16), then the scalar
#: one (fp32)
BWD_KERNELS = ("bwd_prep", "bwd_deadsum", "bwd_dkdv_wgmma", "bwd_dq_wgmma",
               "bwd_dsum", "bwd_dkdv", "bwd_dq")
#: the port's own profiler ranges (``repro_torch.tracing``): the device
#: timeline shows them too, where they are no kernel
RANGE_PREFIXES = ("kernel.", "serve.", "tracing.")
PORT_KERNELS = ("flash_fwd_wgmma", "flash_fwd", "decode_split_mma",
                "decode_split", "decode_combine", "ssd_scan") + BWD_KERNELS
#: the Hopper kernels the build phase logs instantiation by instantiation
WGMMA_KERNELS = ("flash_fwd_wgmma", "flash_fwd_wide", "decode_split_mma",
                 "bwd_dkdv_wgmma", "bwd_dq_wgmma")
SPIN_CYCLES = 4_000_000  # ~2 ms at H100 clocks: longer than any call's host time
# The ARMA fit (phase 8): the lt-ua+plan stack of benchmarks/common.py
# (stack_spec(BenchSpec(), "lt-ua+plan")), written out: that module
# imports jax.  Kernel and plain version round every op alike and must
# agree bit for bit (ARMA_ATOL = 0).
SIM_WORKLOAD = dict(days=3.0, scale=0.05, seed=0)
SIM_PLANNER = {"min_instances": 2, "epsilon": 0.8, "fit_steps": 150,
               "theta_headroom": 0.7, "use_routing": True}
ARMA_ATOL = 0.0
ARMA_ORDERS = ((1, 1), (2, 1), (2, 2), (3, 1), (2, 0), (0, 1), (3, 5),
               (0, 8), (8, 0))
#: row lengths of the edge cases: "longest" is the wrapper's limit,
#: fitted with ARMA_LONGEST_STEPS Adam steps (host time)
ARMA_LENGTHS = (1, 8, 255, 257, 511, 2815, 2817, "longest")
ARMA_LONGEST_STEPS = 20
ARMA_REPLICAS = 8        # the timed batch of replicas of the run's rows
FMA_LATENCY_CYCLES = 4   # one dependent fp32 FMA on Hopper
# The vector engine (phase 9): the seven strategies of
# benchmarks/common.py:115-142 (stack_spec(BenchSpec(), s)), written out:
# that module imports jax.  The bucket step's kernel and plain version do
# the same float32 ops in the same order (BUCKET_ATOL = 0).
VECTOR_STRATEGIES = ("siloed", "reactive", "lt-i", "lt-u", "lt-ua",
                     "lt-ua+plan", "chiron")
BUCKET_ATOL = 0.0
#: edge cases of the bucket step (bucket_step.synthetic_case arguments;
#: b0 where the segment starts)
BUCKET_CASES = (
    ("R=1, one bucket", dict(seed=1, modes=("lt-ua",), buckets=1)),
    ("R=1, reactive", dict(seed=2, modes=("reactive",))),
    ("R=5, every mode, unified", dict(seed=3, modes="all")),
    ("R=5, every mode, siloed", dict(seed=4, modes="all", P=2)),
    ("R=8, C*J=48 (8 models x 2 pools)", dict(seed=5, modes="all+3", M=8,
                                              P=2)),
    ("ring collision", dict(seed=6, modes="all", collide=True)),
    ("region down", dict(seed=7, modes="all", down=True)),
    ("dead model past its budget", dict(seed=8, modes="all", dead=True)),
    ("no plan rows", dict(seed=9, modes="all", plan=False)),
    ("wraps the ring", dict(seed=10, modes="all", b0=3 * 481 - 100)),
    # one case per instantiation of the kernel's template: J = 1, 2, 4, 5
    # and 8 (3 above), J at run time (6), 2 and 4 cells a lane (C*J = 48
    # above, 72 here) and the 32 cells a lane of C*J > 128
    ("J=1", dict(seed=11, modes="all", J=1)),
    ("J=2", dict(seed=16, modes="all", J=2)),
    ("J=4", dict(seed=17, modes="all", J=4)),
    ("J=5", dict(seed=12, modes="all", J=5)),
    ("J=8", dict(seed=18, modes="all", M=3, J=8)),
    ("J=6 (J at run time)", dict(seed=13, modes="all", M=2, J=6)),
    ("L=96 (whole chunks of 32 rows)", dict(seed=19, modes="all", L=96)),
    ("C*J=72 (8 models x 3 pools x 3 regions)", dict(seed=14, modes="all",
                                                     M=8, P=3)),
    ("C*J=144 (32 cells a lane), L=121",
     dict(seed=15, modes=("lt-ua", "chiron"), M=16, P=3, L=121,
          buckets=24)),
    ("C*J=330, outputs not staged in shared memory, L=121",
     dict(seed=20, modes=("lt-ua",), M=110, L=121, buckets=24)),
)
COMPLETION_ABS_TOL = 0.02   # vector vs event loop: tests/test_vector_sim.py
HOURS_REL_TOL = 0.10
# The bucket step's chain floor: the longest dependent chain of one
# bucket, counted from csrc/bucket_step.cu at the run's unified layout (J =
# 3, P = 1, C = 4), each op at an assumed Hopper latency in cycles.  The
# ring's sum runs on other warps, off the chain.  The chain: u (a
# division) -> published -> Rm (a division) -> published -> the scaling
# decision -> published -> the row's queue-manager release (fr, sf) ->
# admission (frac), occupancy, TBT, decode (dnv / tbt, done, rel_tok) ->
# the delay (dd) -> published -> the delay seen from the home.
BUCKET_CHAIN = {          # kind: (ops on the chain, cycles each)
    "fp32 add/mul/min/max/select": (75, FMA_LATENCY_CYCLES),
    "fp32 division (MUFU.RCP, 4 dependent FFMAs, a warp vote)": (10, 40),
    "shared-memory round trip (store, barrier, load)": (4, 60),
}
BUCKET_OPS_PER_CELL = 250   # float ops of one cell and bucket (counted)


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
    Python and launch overhead.  A call whose start event the device
    has already passed once the call is enqueued was timed with the host
    in it: it is dropped and the spin doubled."""
    for _ in range(warmup):
        fn()
    spin, times = SPIN_CYCLES, []
    while len(times) < reps:
        flush()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        outran = start.query()
        end.synchronize()
        if not outran:
            times.append(start.elapsed_time(end))
        elif spin < 64 * SPIN_CYCLES:
            spin *= 2
            log(f"  [time] the device left the spin before the call was "
                f"enqueued: call dropped, spin doubled to {spin} cycles")
        else:
            raise SystemExit("time_ms: the host outran a spin of "
                             f"{spin} cycles")
    return sum(times) / reps


def kernel_resources(text: str):
    """The Hopper kernels of an ``nvcc -Xptxas -v`` log one by one: a list
    of (kernel, its template arguments, registers, spill store bytes)
    for each instantiation of ``WGMMA_KERNELS``, and the instantiations
    whose wgmmas ptxas serialised, each with its reason (C7512: too few
    registers; C7510, C7515 and others: what else stopped the
    pipeline)."""
    names = "|".join(WGMMA_KERNELS)

    def readable(mangled):
        m = re.search(rf"({names})I((?:Li\d+E)+)", mangled)
        return (m[1], ",".join(re.findall(r"\d+", m[2]))) if m \
            else (mangled, "")

    found = [
        (*readable(m[1]), int(m[3]),
         int((re.search(r"(\d+) bytes spill stores", m[2]) or [0, "0"])[1]))
        for m in re.finditer(r"Compiling entry function '(\S+)'"
                             r"([\s\S]*?)Used (\d+) registers", text)
        if re.search(rf"({names})I", m[1])]
    serial = ["{}<{}> ({}: {})".format(*readable(fn), code, why.strip())
              for code, why, fn in re.findall(
                  r"\((C75\d\d)\) Potential Performance Loss: "
                  r"wgmma.mma_async instructions are serialized ([^']*?)"
                  r"(?:in the function|in function)? '(\S+)'", text)]
    return found, serial


def ranged(name: str, fn):
    """fn inside a profiler range ``name``."""
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def kernel_name(key: str) -> str:
    """A kernel's name and template arguments out of its profiler key."""
    m = re.search(r"(\w+)(<[^<>]*>)?\(", key)
    return "".join(m.groups("")) if m else key[:40]


def profiled(label: str, fn, ranges=None, shares=None):
    """Run fn once under torch.profiler and print where its device time
    went: wall time (inflated by the profiler), device-busy share, the
    kernels with the most self device time and the port's own kernels,
    the host ops with the most self CPU time and, for each of
    ``ranges`` (name: the (module of ``repro_torch.models``, function)
    pairs run inside a range of that name), the device time of the
    kernels launched inside it and its share of the busy time; for each
    of ``shares`` (name: kernel names), those kernels' device time and
    share of the busy time."""
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = ranges or {}
    torch.cuda.synchronize()
    with contextlib.ExitStack() as patches:
        for name, targets in ranges.items():
            for mod, fname in targets:
                module = importlib.import_module(f"repro_torch.models.{mod}")
                patches.enter_context(mock.patch.object(
                    module, fname, ranged(name, getattr(module, fname))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and e.key not in ranges
                   and not e.key.startswith(RANGE_PREFIXES)), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  [profile] {label}: wall {wall_ms:.2f} ms under the profiler, "
        f"device busy {busy:.2f} ms ({busy / wall_ms:.0%}), "
        f"{sum(r[1] for r in rows)} kernel launches")
    ours = [r for r in rows[8:] if any(k in r[2] for k in PORT_KERNELS)]
    for ms, count, key in rows[:8] + ours:
        log(f"    {ms:8.3f} ms {ms / busy:5.1%} x{count:<5d} {key[:80]}")
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in events
                   if e.device_type == DeviceType.CPU), reverse=True)
    log("    host ops with the most self CPU time: " + ", ".join(
        f"{key} {ms:.1f} ms x{count}" for ms, count, key in host[:6]))
    for name in ranges:
        hits = [e for e in events if e.key == name
                and e.device_type == DeviceType.CPU]
        if not hits:
            continue
        ms = sum(e.device_time_total for e in hits) / 1e3
        share = f"{ms / busy:.1%} of the busy time" if ms > 0 \
            else "device time not measured (no kernels attributed)"
        log(f"    range {name}: {sum(e.count for e in hits)} calls, their "
            f"kernels {ms:.3f} ms, {share}")
    for name, kernels in (shares or {}).items():
        hit = [r for r in rows if any(k in r[2] for k in kernels)]
        if not hit:
            continue
        ms = sum(r[0] for r in hit)
        log(f"    {name}: {ms:.3f} ms, {ms / busy:.1%} of the busy time, "
            f"{sum(r[1] for r in hit)} launches ("
            + ", ".join(f"{kernel_name(key)} {t:.3f} ms x{n}"
                        for t, n, key in hit) + ")")
    return out


def bwd_kernel_times(fn) -> dict:
    """The device time (ms) of each kernel that one call of fn launches,
    from torch.profiler, in K2's backward's launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {kernel_name(e.key): e.self_device_time_total / 1e3
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0
             and not e.key.startswith(RANGE_PREFIXES)}
    order = {k: i for i, k in enumerate(BWD_KERNELS)}
    return dict(sorted(times.items(), key=lambda kv: order.get(
        kv[0].split("<")[0], len(order))))


# ---------------------------------------------------------------- kernels
def randn(dev, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_case(dev, dtype, gen, B, H, Hkv, S, T, hd, window=0,
               masked=False, padded=False, causal=True, vd=None):
    """Inputs laid out as the model passes them: transposed views of
    (B, S, H, hd) activations, V at its own head dim ``vd`` (hd by
    default).  ``padded``: the first q tile of sequence 0 holds padding
    (q_pos -1) and live rows; ``causal=False``: every pair kept (an
    encoder, cross-attention)."""
    q = randn(dev, (B, S, H, hd), dtype, gen).transpose(1, 2)
    k = randn(dev, (B, T, Hkv, hd), dtype, gen).transpose(1, 2)
    v = randn(dev, (B, T, Hkv, vd or hd), dtype, gen).transpose(1, 2)
    qpos = (torch.arange(S, device=dev, dtype=torch.int32)
            + max(T - S, 0)).repeat(B, 1)
    kpos = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
    if masked:   # padding rows, and a gap no windowed row can see past
        qpos[0, : S // 8] = -1
        kpos[-1, T // 4: 3 * T // 4] = -1
    if padded:
        qpos[0, :70] = -1
    return (q, k, v, qpos, kpos), dict(scale=hd ** -0.5, window=window,
                                       causal=causal)


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


#: K2's checked shapes (``flash_case`` arguments), forward and backward
FLASH_CASES = [
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
    ("deepseek-v3 MLA hd=192 S=T=1999", dict(B=1, H=128, Hkv=128,
                                             S=1999, T=1999, hd=192)),
    ("MLA hd=192 ragged S=T=333", dict(B=1, H=128, Hkv=128, S=333,
                                       T=333, hd=192)),
    ("hd=192 g=4 S=T=70", dict(B=2, H=8, Hkv=2, S=70, T=70, hd=192)),
    ("whisper encoder bidir S=T=1500", dict(B=1, H=6, Hkv=6, S=1500,
                                            T=1500, hd=64,
                                            causal=False)),
    ("whisper cross S=333 T=1500", dict(B=2, H=6, Hkv=6, S=333,
                                        T=1500, hd=64, causal=False)),
    ("bidir hd=192 S=T=200", dict(B=1, H=16, Hkv=16, S=200, T=200,
                                  hd=192, causal=False)),
    ("llama4 prefill g=5 S=T=700", dict(B=1, H=40, Hkv=8, S=700,
                                        T=700, hd=128)),
    ("MLA 192/V 128 S=T=1999", dict(B=1, H=128, Hkv=128, S=1999, T=1999,
                                    hd=192, vd=128)),
    ("MLA 192/V 128 ragged S=T=333", dict(B=1, H=128, Hkv=128, S=333,
                                          T=333, hd=192, vd=128)),
    ("MLA 192/V 128 fully masked", dict(B=2, H=128, Hkv=128, S=200,
                                        T=200, hd=192, vd=128, window=32,
                                        masked=True)),
    ("gemma-7b hd=256 S=T=2048", dict(B=1, H=16, Hkv=16, S=2048, T=2048,
                                      hd=256)),
    ("hd=160 g=4 S=T=2048", dict(B=1, H=32, Hkv=8, S=2048, T=2048,
                                 hd=160)),
    ("train example hd=96 B=8 S=T=128", dict(B=8, H=8, Hkv=8, S=128,
                                             T=128, hd=96)),
    ("hd=96 g=4 ragged S=T=333", dict(B=1, H=8, Hkv=2, S=333, T=333,
                                      hd=96)),
]
#: K3's checked shapes (``scan_case`` arguments), forward and backward
SCAN_CASES = [
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
    ("mamba2 train b=4 c=8 h=32 p=64 n=128", dict(b=4, c=8, h=32, p=64,
                                                  n=128)),
]


def check_kernels(dev):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=dev).manual_seed(0)
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
        ("llama4 decode g=5 B=4 W=4096", dict(
            B=4, H=40, Hkv=8, T=4096, hd=128, cur=[4095, 1999, 777, 130])),
        ("whisper self hd=64 B=4 W=4096", dict(
            B=4, H=6, Hkv=6, T=4096, hd=64, cur=[4095, 1999, 777, 130])),
        ("whisper cross W=1500 every slot", dict(
            B=4, H=6, Hkv=6, T=1500, hd=64, cur=[1499] * 4)),
        ("stablelm decode hd=160 g=4 B=4 W=4096", dict(
            B=4, H=32, Hkv=8, T=4096, hd=160, cur=[4095, 1999, 777, 130])),
        ("qwen2 decode g=8 B=4 W=4096", dict(
            B=4, H=64, Hkv=8, T=4096, hd=128, cur=[4095, 1999, 777, 130])),
        ("train example decode hd=96 B=8 W=4096", dict(
            B=8, H=8, Hkv=8, T=4096, hd=96,
            cur=[4095, 1999, 777, 130] * 2)),
    ]
    errs = {"flash_attention": 0.0, "decode_attention": 0.0,
            "ssd_scan": 0.0, "arma_fit": 0.0, "bucket_step": 0.0,
            "flash_attention_bwd": 0.0, "ssd_scan_bwd": 0.0}
    failed = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[dtype]
        for label, kw in FLASH_CASES:
            args, opts = flash_case(dev, dtype, gen, **kw)
            route = fa.fwd_route(dtype, kw["hd"])
            if route != expected_fwd_route(dtype, kw["hd"]):
                failed.append(f"flash_attention {label} {dtype}: {route} "
                              f"route")
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
    for label, kw in SCAN_CASES:
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
    failed += check_bucket(dev, errs)
    failed += check_backward(dev, errs)
    if failed:
        raise SystemExit(f"kernel check failed: {failed}")
    return errs


def expected_fwd_route(dtype, hd: int) -> str:
    """The kernel K2's forward must take: for bf16 the narrow wgmma kernel
    up to a padded head dim of 128 and the wide one above it, for fp32
    the scalar FMA kernel (never TF32)."""
    if dtype != torch.bfloat16:
        return "fma"
    return "wide" if hd > 128 else "wgmma"


def expected_bwd_route(dtype, hd: int) -> str:
    """The kernels K2's backward must take: the tensor cores for bf16 at
    every head dim, the scalar FMA kernels for fp32 (never TF32)."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def check_backward(dev, errs):
    """The two backward kernels against their plain versions: K2's at
    every shape of ``FLASH_CASES`` in bf16 and fp32 (dq, dk, dv from the
    kernel's own forward output and log-sum-exp, which is also held to
    the plain version's, and a random dO laid out as the model's
    gradient arrives: a transposed view), each logged with the route it
    took, which must be ``expected_bwd_route``'s, and run twice: the
    bits must repeat (no atomics); K3's at every shape of
    ``SCAN_CASES`` (dstates and ds0 bit for bit, ddecay within
    ``DDECAY_RTOL`` of the sum of its terms' magnitudes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=dev).manual_seed(3)
    failed = []
    for dtype in (torch.bfloat16, torch.float32):
        tol = BWD_TOL[dtype]
        for label, kw in FLASH_CASES:
            route = fa.bwd_route(dtype, kw["hd"])
            if route != expected_bwd_route(dtype, kw["hd"]):
                failed.append(f"flash_attention_bwd {dtype} {label}: route "
                              f"{route}")
            label = f"{label} [{route}]"
            args, opts = flash_case(dev, dtype, gen, **kw)
            out, lse = fa.flash_attention(*args, return_lse=True, **opts)
            _, want_lse = ref.flash_attention_lse_ref(*args, **opts)
            dead = want_lse <= 0.5 * ref.NEG_INF
            lse_ok = torch.equal(lse <= 0.5 * ref.NEG_INF, dead) and bool(
                torch.all((lse - want_lse)[~dead].abs() <= LSE_ATOL))
            if not lse_ok:
                failed.append(f"flash_attention lse {dtype} {label}")
            do = randn(dev, out.transpose(1, 2).shape, dtype,
                       gen).transpose(1, 2)
            q, k, v, qpos, kpos = args
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, qpos, kpos,
                                         **opts)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, qpos,
                                           kpos, **opts)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if not same:
                failed.append(f"flash_attention_bwd {dtype} {label}: the "
                              f"bits differ between two calls")
            label = f"{label}, {'bits repeat' if same else 'BITS DIFFER'}"
            del again
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, qpos,
                                               kpos, **opts)
            failed += report("flash_attention_bwd", label, dtype,
                             torch.cat([g.flatten() for g in got]),
                             torch.cat([w.flatten() for w in want]), errs,
                             tol, tol)
            del got, want
    for label, kw in SCAN_CASES:
        states, dec, init = scan_case(dev, gen, **kw)
        prev, _ = ssd.ssd_state_scan(states, dec, init)
        dprev = torch.randn(prev.shape, generator=gen, device=dev)
        dfin = torch.randn(init.shape, generator=gen, device=dev)
        got = ssd.ssd_state_scan_bwd(dec, prev, dprev, dfin)
        want = ref.ssd_state_scan_bwd_ref(dec, prev, dprev, dfin)
        failed += report("ssd_scan_bwd", label + " dstates, ds0",
                         torch.float32,
                         torch.cat([got[0].flatten(), got[2].flatten()]),
                         torch.cat([want[0].flatten(), want[2].flatten()]),
                         errs, 0.0, 0.0)
        mag = (want[0].abs() * prev.abs()).sum(dim=(-2, -1))
        err = (got[1] - want[1]).abs()
        ok = bool(torch.all(err <= DDECAY_RTOL * mag + 1e-6))
        log(f"  {'ssd_scan_bwd':16s} {'float32':8s} {label + ' ddecay':31s} "
            f"max_abs_err={float(err.max()):.3e} (of sums up to "
            f"{float(mag.max()):.3e}) rtol={DDECAY_RTOL:g} of the terms' "
            f"magnitudes {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"ssd_scan_bwd {label} ddecay")
    return failed


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
    order of ``ARMA_ORDERS`` at every length of ``ARMA_LENGTHS`` (2,815
    is the run's unseasoned maximum), 12 rows, cold and warm inits; then
    repeats and a row alone, in a batch and permuted, at 37 rows."""
    from repro_torch.kernels import arma_fit

    failed = []
    for p, q in ARMA_ORDERS:
        k = p + 1 + q
        for length in ARMA_LENGTHS:
            n_steps = steps
            if length == "longest":
                length, n_steps = arma_fit.MAX_LEN, ARMA_LONGEST_STEPS
            y = arma_rows(dev, gen, 12, length)
            for warm in (False, True):
                init = (0.1 * torch.randn((12, k), generator=gen, device=dev)
                        if warm else torch.zeros((12, k), device=dev))
                got = torch.cat([t.flatten() for t in arma_fit.arma_fit(
                    y, init, p, q, n_steps, 0.05)])
                want = torch.cat([t.flatten() for t in arma_plain(
                    y, init, p, q, n_steps)])
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
    StarCoder2-7B's widths (the row) and, in ``other_shapes``, at
    Zamba2-7B's hd = 112, Llama-4 Scout's and Pixtral-12B's widths,
    DeepSeek-V3's MLA prefill (q/k 192, V 128), Whisper-tiny's encoder,
    cross-attention and decode, StableLM-12B's hd 160, Gemma-7B's hd
    256, Qwen2-72B's group of 8 and the train example's hd 96 (K2 at its
    B = 8, S = T = 128; K1 at B = 8 over a 4096-slot cache);
    K3 at Zamba2-7B's prefill of 2000
    tokens; the backward kernels at the trained shapes (``bwd_row``: also
    StableLM-12B's hd 160 and Gemma-7B's hd 256; K3's at Mamba2-370M's
    B = 4, S = 2048)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = L2Flush(dev)
    cases = []

    def flash_row(label, B, H, Hkv, S, hd, T=None, causal=True, vd=None):
        """K2 at an S-token prompt (positions 0..S-1) over T keys: causal,
        or with every pair kept.  ``vd``: V's own head dim (MLA's 128)."""
        T = T or S
        args, opts = flash_case(dev, bf16, gen, B, H, Hkv, S, T, hd,
                                causal=causal, vd=vd)
        q, k, v, _, _ = args
        vd = vd or hd
        kept = S * (S + 1) // 2 if causal else S * T   # kept (q, k) pairs
        route = fa.fwd_route(bf16, hd)
        cases.append(dict(
            name="flash_attention", dtype=bf16,
            fn=lambda: fa.flash_attention(*args, **opts),
            plain=lambda: ref.flash_attention_ref(*args, **opts),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=opts["scale"],
                enable_gqa=True),
            flops=2 * B * H * (hd + vd) * kept,    # QK^T and PV
            bytes=(B * H * S * (hd + vd) + B * Hkv * T * (hd + vd)) * 2
            + B * (S + T) * 4,
            shape=f"{label}: B={B} H={H} Hkv={Hkv} S={S} T={T} hd={hd}"
                  + (f" V {vd}" if vd < hd else "")
                  + f" bf16 {'causal' if causal else 'every pair kept'}"
                  + f", {route} route",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:26",
            extra=dict(fwd_route=route)))

    def bwd_row(label, B, H, Hkv, S, hd, T=None, causal=True, vd=None):
        """K2's backward at K2's shapes: dq, dk, dv from the kernel's
        forward output and log-sum-exp and a random dO.  The library call
        is the autograd backward of ``scaled_dot_product_attention`` at
        the same shape (timed only; the port never calls it).  Bound: 5
        products (S and dP recomputed, dV, dK, dQ), S, dK and dQ over hd,
        dP and dV over vd, V's own head dim; bytes: q, k, v, o, dO and lse
        read once, dq, dk, dv written.  Logged with its route, and the
        device time of each of its kernels (one call under the
        profiler)."""
        T = T or S
        args, opts = flash_case(dev, bf16, gen, B, H, Hkv, S, T, hd,
                                causal=causal, vd=vd)
        q, k, v, qpos, kpos = args
        vd = vd or hd
        out, lse = fa.flash_attention(q, k, v, qpos, kpos, return_lse=True,
                                      **opts)
        do = randn(dev, (B, S, H, vd), bf16, gen).transpose(1, 2)
        lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
        lout = F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=causal, scale=opts["scale"],
            enable_gqa=True)
        kept = S * (S + 1) // 2 if causal else S * T
        route = fa.bwd_route(bf16, hd)
        grads = (q, k, v, out, lse, do, qpos, kpos)
        extra = dict(bwd_route=route, kernels=bwd_kernel_times(
            lambda: fa.flash_attention_bwd(*grads, **opts)))
        cases.append(dict(
            name="flash_attention_bwd", dtype=bf16,
            fn=lambda: fa.flash_attention_bwd(*grads, **opts),
            plain=lambda: ref.flash_attention_bwd_ref(*grads, **opts),
            library=lambda: torch.autograd.grad(
                lout, (lq, lk, lv), do, retain_graph=True),
            flops=2 * B * H * (3 * hd + 2 * vd) * kept,
            bytes=(2 * B * H * S * (hd + vd) + 2 * B * Hkv * T * (hd + vd))
            * 2 + B * H * S * 4 + B * (S + T) * 4,
            shape=f"{label}: B={B} H={H} Hkv={Hkv} S={S} T={T} hd={hd}"
                  + (f" V {vd}" if vd < hd else "")
                  + f" bf16 {'causal' if causal else 'every pair kept'}"
                  + f", {route} route",
            source="src/repro_torch/kernels/csrc/"
                   + ("flash_attention_bwd_wgmma.cuh" if route == "wgmma"
                      else "flash_attention_bwd.cuh"),
            replaces="src/repro/models/attention.py:118", extra=extra))

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

    fill = [1999, 1499, 999, 499]
    flash_row("starcoder2-7b", 1, 36, 4, 2000, 128)
    decode_row("starcoder2-7b", 4, 36, 4, 4096, 128, fill)
    flash_row("zamba2-7b", 1, 32, 32, 2000, 112)
    decode_row("zamba2-7b", 4, 32, 32, 4096, 112, fill)
    flash_row("llama4-scout-17b-a16e", 1, 40, 8, 2000, 128)
    decode_row("llama4-scout-17b-a16e", 4, 40, 8, 4096, 128, fill)
    flash_row("deepseek-v3-671b MLA", 1, 128, 128, 2000, 192, vd=128)
    flash_row("pixtral-12b", 1, 32, 8, 2004, 128)
    decode_row("pixtral-12b", 4, 32, 8, 4096, 128,
               [c + 4 for c in fill])
    flash_row("whisper-tiny encoder", 1, 6, 6, 1500, 64, causal=False)
    flash_row("whisper-tiny cross", 1, 6, 6, 2000, 64, T=1500,
              causal=False)
    flash_row("stablelm-12b", 1, 32, 8, 2048, 160)
    flash_row("gemma-7b", 1, 16, 16, 2048, 256)
    flash_row("train example", 8, 8, 8, 128, 96)
    decode_row("whisper-tiny self", 4, 6, 6, 4096, 64, fill)
    decode_row("whisper-tiny cross", 4, 6, 6, 1500, 64, [1499] * 4)
    decode_row("stablelm-12b", 4, 32, 8, 4096, 160, fill)
    decode_row("gemma-7b", 4, 16, 16, 4096, 256, fill)
    flash_row("qwen2-72b", 1, 64, 8, 2000, 128)
    decode_row("qwen2-72b", 4, 64, 8, 4096, 128, fill)
    decode_row("train example", 8, 8, 8, 4096, 96, fill * 2)

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

    # K2's backward at the trained shape (StarCoder2-7B, B = 2, S = 2048)
    # and at the other families' widths
    bwd_row("starcoder2-7b train", 2, 36, 4, 2048, 128)
    bwd_row("zamba2-7b shared block", 1, 32, 32, 2000, 112)
    bwd_row("deepseek-v3-671b MLA", 1, 128, 128, 2000, 192, vd=128)
    bwd_row("stablelm-12b", 1, 32, 8, 2048, 160)
    bwd_row("gemma-7b", 1, 16, 16, 2048, 256)
    bwd_row("train example", 8, 8, 8, 128, 96)
    bwd_row("whisper-tiny encoder", 1, 6, 6, 1500, 64, causal=False)
    bwd_row("whisper-tiny cross", 1, 6, 6, 2000, 64, T=1500, causal=False)

    # K3's backward at Mamba2-370M's trained shape: B = 4, S = 2048
    b, c, h, p, n = 4, 8, 32, 64, 128
    st, dec_, init = scan_case(dev, gen, b, c, h, p, n)
    prev, _ = ssd.ssd_state_scan(st, dec_, init)
    dprev = torch.randn(prev.shape, generator=gen, device=dev)
    dfin = torch.randn(init.shape, generator=gen, device=dev)
    cases.append(dict(
        name="ssd_scan_bwd", dtype=f32,
        fn=lambda: ssd.ssd_state_scan_bwd(dec_, prev, dprev, dfin),
        plain=lambda: ref.ssd_state_scan_bwd_ref(dec_, prev, dprev, dfin),
        library=None,            # no single PyTorch call computes the scan
        flops=4 * b * c * h * p * n,
        bytes=4 * (3 * b * c * h * p * n + 2 * b * h * p * n + 2 * b * c * h),
        shape=f"mamba2-370m train: b={b} c={c} h={h} p={p} n={n} fp32",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/models/ssm.py:134"))

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
                     library_ms=t_lib, shape=r["shape"], **r.get("extra", {}))
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
        if "kernels" in timed:
            log("    its kernels, one call under the profiler: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in timed["kernels"].items()))
    del flush
    return list(rows.values())


# ---------------------------------------------------------------- serving
#: (arch, requests, new tokens per request) served in turn; the kernels
#: each run must launch follow from its config (``expected_launches``)
SERVED = (("starcoder2-7b", 8, 32), ("zamba2-7b", 8, 32),
          ("mamba2-370m", 4, 16), ("llama4-scout-17b-a16e", 8, 32),
          ("deepseek-v3-671b", 8, 32), ("pixtral-12b", 8, 32),
          ("whisper-tiny", 4, 16), ("stablelm-12b", 4, 16),
          ("gemma-7b", 4, 16), ("qwen2-72b", 4, 16))
#: depth cuts of the served models that do not fit one card whole, in
#: bf16: Llama-4 Scout 8 of 48 layers (about 2.21 B params a layer and
#: 2.07 B of embeddings: 39.6 GB), DeepSeek-V3 5 of 61 (its 3 dense
#: layers, 1.17 GB each, and 2 MoE layers of 256 routed experts and a
#: shared one, 23.0 GB each; 3.7 GB of embeddings: 53 GB), Qwen2-72B 8
#: of 80 (0.878 B params a layer: 0.151 B of attention with its QKV
#: biases, 0.727 B of SwiGLU at 29,568; 7.02 B in layers and 2.49 B of
#: untied embeddings at vocabulary 152,064: 9.51 B, 19.0 GB, and 38.1 GB
#: in fp32, which fits); every width is the published one.  StableLM-12B
#: (12.14 B: 24.3 GB, 48.6 GB in fp32) and Gemma-7B (8.54 B: 17.1 GB,
#: 34.2 GB in fp32) are served whole
SERVED_CUT = {"llama4-scout-17b-a16e": dict(num_layers=8),
              "deepseek-v3-671b": dict(num_layers=5),
              "qwen2-72b": dict(num_layers=8)}
#: the depths of the fp32 check where the served depth does not fit in
#: fp32: Llama-4 Scout 4 layers (43.6 GB), DeepSeek-V3 1 dense and 1 MoE
#: layer (55 GB)
FP32_CUT = {"llama4-scout-17b-a16e": dict(num_layers=4),
            "deepseek-v3-671b": dict(num_layers=2, num_dense_layers=1)}
#: profiler ranges around the MoE expert products (the prefill dispatch's
#: and decode's per-token gather) and MLA's latent attention: (module,
#: function) patched with a ``record_function`` of the range's name
RANGES = {"moe.expert_products": (("moe", "_expert_products"),
                                  ("moe", "_gather_experts")),
          "mla.latent_attention": (("attention", "_mla_latent_attention"),)}


def served_config(arch: str, cut=None):
    """The arch's config, cut to ``cut`` (``SERVED_CUT`` by default)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    cut = SERVED_CUT.get(arch, {}) if cut is None else cut
    return dataclasses.replace(cfg, **cut) if cut else cfg


def depth_note(cfg) -> str:
    from repro_torch.configs import get_arch

    full = get_arch(cfg.name)
    if cfg.num_layers == full.num_layers:
        return "full depth"
    dense = (f", {cfg.num_dense_layers} of them dense"
             if cfg.num_experts and cfg.num_dense_layers else "")
    return f"depth cut to {cfg.num_layers} of {full.num_layers} layers{dense}"


def expected_launches(cfg, prefill_calls: int, decode_calls: int):
    """K3 once per SSM layer per prefill; K2 (prefill) and K1 (decode)
    once per attention layer, or per shared-block group of the hybrid;
    an encoder-decoder also runs K2 once per encoder layer and per
    cross-attention in a prefill, and K1 once per cross-attention in a
    decode; MLA decode runs no K1 (its latent attention is plain)."""
    from repro_torch.models import transformer as tfm

    n_ssm, n_attn, n_dec = 0, cfg.num_layers, cfg.num_layers
    if tfm.is_ssm(cfg):
        n_ssm = cfg.num_layers
        n_attn = n_dec = (len(tfm._hybrid_groups(cfg)) if cfg.attn_every
                          else 0)
    elif cfg.family == "audio":
        n_attn = cfg.encoder_layers + 2 * cfg.num_layers
        n_dec = 2 * cfg.num_layers
    elif cfg.use_mla:
        n_dec = 0
    return {"flash_attention": n_attn * prefill_calls,
            "decode_attention": n_dec * decode_calls,
            "ssd_scan": n_ssm * prefill_calls}


def full_forward(cfg, params, seq, dev):
    """Logits of a full forward over ``seq`` with the engine's inputs
    (``prefill_batch``), and the MoE pairs it dropped at capacity."""
    from repro_torch.models import model, moe
    from repro_torch.serving.engine import prefill_batch

    batch, _ = prefill_batch(cfg, torch.tensor([seq], device=dev))
    moe.DROPPED = 0
    logits = model.forward(cfg, params, batch)[0]
    return logits, moe.DROPPED


def serve(dev, arch: str, n_requests: int, max_new: int):
    """Serve ``arch`` at full width (depth cut by ``SERVED_CUT``).
    Returns its kernel launch counts, the longest request's prompt and
    generated tokens but the last, and its bf16 decode gap: the relative
    L2 error of its last decode logits and the bf16 full forward's
    logits they are held to."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import model
    from repro_torch.serving.engine import ServingEngine

    cfg = served_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name} ({cfg.family}): {cfg.num_layers} layers "
        f"({depth_note(cfg)}), d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params in {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f} s")

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
            return profiled(label, fn, ranges=RANGES)
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
    reset_model_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = model_counts()

    for r in reqs:
        log(f"  req {r.rid} [{r.tier}] prompt={len(r.prompt)} "
            f"ttft_step={r.ttft_step} done_step={r.done_step} "
            f"tokens={len(r.tokens)}")
    if any(r.done_step is None or len(r.tokens) != r.max_new_tokens
           for r in reqs):
        raise SystemExit(f"serve {arch}: a request did not finish")
    want = expected_launches(cfg, stats["prefill_calls"],
                             stats["decode_calls"])
    want.update(flash_attention_bwd=0, ssd_scan_bwd=0)   # no graph, no bwd
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
    full, dropped = full_forward(cfg, params, seq, dev)
    ref_logits = full[0, -1].float()
    got = last_logits[r.rid]
    rel = float((got - ref_logits).norm() / ref_logits.norm())
    mx = float((got - ref_logits).abs().max())
    bounded = cfg.family in ("dense", "vlm", "audio")
    drops = (f"; the full forward dropped {dropped} (token, expert) pairs "
             f"at capacity {cfg.capacity_factor:g}" if cfg.num_experts
             else "")
    log(f"  req {r.rid}: last decode logits vs full forward over {len(seq)} "
        f"tokens: rel L2 {rel:.3e} "
        f"({f'tol {SERVE_LOGIT_TOL:g}' if bounded else 'bf16, not bounded'})"
        f", max abs {mx:.3e} of max |logit| "
        f"{float(ref_logits.abs().max()):.3f}, argmax {int(got.argmax())} vs "
        f"{int(ref_logits.argmax())}, emitted {r.tokens[-1]}{drops}")
    if not (torch.isfinite(got).all()
            and (rel <= SERVE_LOGIT_TOL or not bounded)):
        raise SystemExit(f"serve {arch}: decode logits disagree with the "
                         f"full forward")
    return launches, seq, (rel, ref_logits)


def drop_free(cfg, params, seq, steps, dev):
    """The config at a capacity factor (1.25 doubled until nothing drops)
    at which neither the full forward over ``seq`` nor the prefill of all
    but its last ``steps`` tokens drops a pair; with its full forward's
    logits.  Without experts, the config as it is."""
    while True:
        full, dropped = full_forward(cfg, params, seq, dev)
        if cfg.num_experts:
            dropped += full_forward(cfg, params, seq[:len(seq) - steps],
                                    dev)[1]
        if not dropped:
            return cfg, full[0, -1].float()
        cfg = dataclasses.replace(cfg, capacity_factor=2 * cfg.capacity_factor)


def check_fp32_decode(dev, arch: str, seq, steps: int, bf16_gap) -> float:
    """``seq`` through ``arch`` in fp32 (the same seeded draws as the
    served bf16 weights, before rounding): a prefill of all but the last
    ``steps`` tokens, ``steps`` decode steps over those, and the last
    logits against a full forward over ``seq``, at a capacity where
    neither drops a pair.  Where the served depth does not fit in fp32
    (``FP32_CUT``), and for every MoE model (whose served forward may
    drop), the yardstick's bf16 full forward is rerun at the fp32 check's
    depth and capacity first.  ``bf16_gap`` (the served bf16 decode's gap
    and the bf16 full forward's logits) is printed beside the yardstick:
    the bf16 full forward's error against this fp32 full forward."""
    from repro_torch.models import model
    from repro_torch.serving.engine import _write_slot, prefill_batch

    gap, bf16_full = bf16_gap
    cut = FP32_CUT.get(arch)
    base = served_config(arch, cut)
    n = len(seq)
    if cut or base.num_experts:
        params = model.init(base, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        base, bf16_full = drop_free(base, params, seq, steps, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(base, dtype="float32")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    cfg, want = drop_free(cfg, params, seq, steps, dev)
    toks = torch.tensor([seq], device=dev)
    pre_batch, offset = prefill_batch(cfg, toks[:, :n - steps])
    _, pre, _ = model.forward(cfg, params, pre_batch, return_cache=True)
    cache = model.init_decode_cache(cfg, 1, n + offset, device=dev)
    _write_slot(cache, pre, 0)
    for t in range(n - steps, n):
        pos = torch.tensor([t + offset], dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(cfg, params, toks[:, t:t + 1],
                                          cache, pos)
    got = logits[0, 0].float()
    rel = float((got - want).norm() / want.norm())
    where = depth_note(cfg) + (f", capacity {cfg.capacity_factor:g}, 0 "
                               f"pairs dropped" if cfg.num_experts else "")
    log(f"  fp32 ({where}): {steps} decode steps after a prefill of "
        f"{n - steps} tokens vs full forward over {n}: rel L2 {rel:.3e} "
        f"(tol {FP32_LOGIT_TOL:g}), argmax {int(got.argmax())} vs "
        f"{int(want.argmax())}")
    if not (rel <= FP32_LOGIT_TOL and torch.isfinite(got).all()):
        raise SystemExit(f"{arch}: fp32 decode logits disagree with the "
                         f"full forward")
    yard = float((bf16_full - want).norm() / want.norm())
    log(f"  bf16: decode vs full forward rel L2 {gap:.3e} (served depth); "
        f"yardstick, the bf16 full forward vs the fp32 full forward "
        f"{yard:.3e} ({depth_note(cfg)}; gap / yardstick "
        f"{gap / yard:.2f})")
    return rel


# ---------------------------------------------------------------- train
#: (arch, depth cut, batch, sequence length, steps, remat, peak lr)
#: trained in turn through ``train.loop.train`` at full published width:
#: StarCoder2-7B at 16 of its 32 layers (3.93 B parameters: bf16 weights
#: and gradients and fp32 AdamW moments take 47.1 GB), Mamba2-370M
#: whole, DeepSeek-V3 at its 3 dense layers (3.61 B, 43.3 GB; MLA
#: through K2 at q/k 192 and V 128).  AdamW's first step moves every
#: weight by about lr (m/sqrt(v) is +-1): at StarCoder2-7B's width that
#: swings the loss of step 1 from 11.4 to 18-25 for any peak from 3e-5 to
#: 5e-4, and back by step 5 only some of the time; at 1e-5 it falls at
#: once.  DeepSeek-V3's swings from 12.2 to 14.8 at 3e-5 and 18.9 at
#: 1e-4; at 1e-5 it falls at once (to 9.9 by step 5; 3e-6: 11.9).
#: Mamba2-370M falls smoothly at 3e-4 (``scripts/torch_train_lr.py``
#: runs other peaks).  Gemma-7B at 4 of its 28 layers (1.9 B parameters,
#: most of them its 256k-row tied embedding) takes K2's wide backward at
#: hd 256 end to end, 3 steps at StarCoder2-7B's peak.
TRAINED = (("starcoder2-7b", dict(num_layers=16), 2, 2048, 6, True, 1e-5),
           ("mamba2-370m", {}, 4, 2048, 6, True, 3e-4),
           ("deepseek-v3-671b", dict(num_layers=3), 2, 2048, 6, True, 1e-5),
           ("gemma-7b", dict(num_layers=4), 2, 2048, 3, True, 1e-5))
PROFILED_STEP = 2        # which training step to profile
#: the fp32 step, kernels against plain versions on the card: (arch,
#: depth cut, batch, sequence length)
FP32_TRAIN = (("starcoder2-7b", dict(num_layers=2), 1, 2048),
              ("mamba2-370m", dict(num_layers=4), 2, 2048),
              ("deepseek-v3-671b", dict(num_layers=1, num_dense_layers=1), 1,
               2048),
              ("stablelm-12b", dict(num_layers=2), 1, 2048),
              ("gemma-7b", dict(num_layers=2), 1, 2048))
# fp32, kernels vs plain versions (both fp32, no TF32): loss rel 1e-5 and
# each gradient leaf rel L2 1e-4, the CPU parity tests' bounds against
# jax.value_and_grad (tests/test_torch_train.py)
FP32_TRAIN_LOSS_TOL = 1e-5
FP32_TRAIN_GRAD_TOL = 1e-4


def model_counts():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    return {"flash_attention": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "decode_attention": dec.LAUNCHES, "ssd_scan": ssd.LAUNCHES,
            "ssd_scan_bwd": ssd.BWD_LAUNCHES}


def reset_model_counts() -> None:
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    fa.LAUNCHES = fa.BWD_LAUNCHES = dec.LAUNCHES = 0
    ssd.LAUNCHES = ssd.BWD_LAUNCHES = 0


def expected_train_launches(cfg, steps: int, remat: bool):
    """Per step: K2 and K3 forward once per attention and SSM layer (as a
    prefill runs them, ``expected_launches``), their backward kernels
    once each; with ``remat`` the forward again for every layer the
    backward recomputes: every layer of a dense, MoE or VLM stack and
    every SSM layer, an encoder-decoder's decoder layers (self and cross)
    but not its encoder, and not the hybrid's shared block."""
    per = expected_launches(cfg, 1, 0)
    attn, scan = per["flash_attention"], per["ssd_scan"]
    again_attn = again_scan = 0
    if remat:
        again_scan = scan
        if cfg.family == "audio":
            again_attn = 2 * cfg.num_layers
        elif cfg.family not in ("ssm", "hybrid"):
            again_attn = attn
    return {"flash_attention": steps * (attn + again_attn),
            "flash_attention_bwd": steps * attn,
            "decode_attention": 0,
            "ssd_scan": steps * (scan + again_scan),
            "ssd_scan_bwd": steps * scan}


def device_memory(dev) -> dict:
    """The bytes live tensors on ``dev`` asked the caching allocator for
    (``requested``) and the bytes of the blocks it gave them
    (``allocated``, ``torch.cuda.memory_allocated``)."""
    return {"requested": torch.cuda.memory_stats(dev)[
                "requested_bytes.all.current"],
            "allocated": torch.cuda.memory_allocated(dev)}


def train_run(dev, arch, cut, batch, seq, steps, remat, lr):
    """``train.loop.train`` on ``arch`` at full width (depth ``cut``) for
    ``steps`` steps of ``batch`` x ``seq`` synthetic tokens, AdamW on a
    cosine schedule peaking at ``lr`` (warmup 1 step).  Each step is
    timed (host clock around a synchronised step; step PROFILED_STEP
    under the profiler instead); prints the loss, gradient norm, time and
    tokens/s of each, the peak memory and the kernel launches against
    the expected counts.  Fails unless every gradient is present (the
    step raises on one left None) and finite (its global norm is), the
    loss falls and the counts match.  Returns the counts and, for the
    parameters, AdamW's state and the first batch as the first step
    starts (before its backward), the device memory they were
    ``requested`` and ``allocated`` (``device_memory``) and the
    ``tensors`` they are; and ``step_s``, the steady step."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import check_fits, train_state_bytes
    from repro_torch.train import loop
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    cfg = served_config(arch, cut)
    check_fits(cfg, dev)
    log(f"  {cfg.name} ({cfg.family}): {cfg.num_layers} layers "
        f"({depth_note(cfg)}), d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B params, training state "
        f"{train_state_bytes(cfg) / 1e9:.1f} GB ({cfg.dtype} weights and "
        f"gradients, fp32 AdamW moments); B={batch} S={seq}, "
        f"{steps} steps, remat {remat}, peak lr {lr:g}")
    stats = []
    held = {}
    make = loop.make_train_step

    def timed_factory(cfg_, opt_, remat=False, **placed):
        step = make(cfg_, opt_, remat=remat, **placed)

        def timed(params, state, batch_):
            if not held:
                now = device_memory(dev)
                held.update({k: now[k] - base[k] for k in now})
                held["tensors"] = (len(state.m) + len(state.v) + 1
                                   + sum(1 for _ in params.parameters())
                                   + len(batch_))
            if len(stats) == PROFILED_STEP:
                out = profiled(f"training step {PROFILED_STEP}",
                               lambda: step(params, state, batch_),
                               shares={"K2 backward": BWD_KERNELS,
                                       "K2 forward": ("flash_fwd",)})
                stats.append(dict(s=None, loss=float(out[2]["loss"]),
                                  gnorm=float(out[2]["grad_norm"])))
                return out
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(params, state, batch_)
            torch.cuda.synchronize()
            stats.append(dict(s=time.perf_counter() - t,
                              loss=float(out[2]["loss"]),
                              gnorm=float(out[2]["grad_norm"])))
            return out

        return timed

    torch.cuda.reset_peak_memory_stats(dev)
    opt = AdamW(lr=cosine_schedule(lr, warmup=1, total=steps))
    data = DataConfig(batch_size=batch, seq_len=seq, seed=0)
    reset_model_counts()
    gc.collect()
    base = device_memory(dev)
    t0 = time.perf_counter()
    with mock.patch.object(loop, "make_train_step", timed_factory):
        out = loop.train(cfg, steps=steps, data=data, opt=opt, seed=0,
                         remat=remat, verbose=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = model_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for i, st in enumerate(stats):
        when = ("profiled" if st["s"] is None else
                f"{st['s'] * 1e3:.1f} ms, "
                f"{batch * seq / st['s']:.0f} tokens/s")
        log(f"    step {i}: loss {st['loss']:.4f}, grad norm "
            f"{st['gnorm']:.4f}, {when}")
    timed_s = [st["s"] for st in stats[1:] if st["s"] is not None]
    step_s = sum(timed_s) / len(timed_s)
    log(f"  {steps} steps in {wall:.1f} s with init; steady step "
        f"{step_s * 1e3:.1f} ms (mean of steps 1.. but the profiled), "
        f"{batch * seq / step_s:.0f} tokens/s; peak device memory "
        f"{peak:.2f} GiB")
    want = expected_train_launches(cfg, steps, remat)
    log(f"  launches {counts}, expected {want}")
    if counts != want:
        raise SystemExit(f"train {arch}: kernel launch counts do not match "
                         f"the trained work")
    if not all(np.isfinite(st["gnorm"]) and np.isfinite(st["loss"])
               for st in stats):
        raise SystemExit(f"train {arch}: a loss or gradient is not finite")
    if not stats[-1]["loss"] < stats[0]["loss"]:
        raise SystemExit(f"train {arch}: the loss did not fall "
                         f"({stats[0]['loss']:.4f} -> "
                         f"{stats[-1]['loss']:.4f})")
    del out
    return counts, dict(held, step_s=step_s)


def check_fp32_train(dev, arch, cut, batch, seq) -> None:
    """One fp32 forward and backward (``model.loss_fn``) at full width
    and depth ``cut`` through the kernels, against the same with
    ``kernels.ops`` patched to the plain versions (torch autograd
    through them), on the card, from the same weights and batch: the
    loss and every gradient leaf (relative L2)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model
    from repro_torch.train import loop

    cfg = dataclasses.replace(served_config(arch, cut), dtype="float32")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    params.requires_grad_(True)
    inputs = loop.batch_to(next(SyntheticLM(
        cfg, DataConfig(batch_size=batch, seq_len=seq)).batches(1)), dev)

    def plain_flash(q, k, v, q_pos, k_pos, *, scale, causal=True,
                    window=0):
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, scale=scale,
                                       causal=causal, window=window)

    def loss_and_grads():
        for p in params.parameters():
            p.grad = None
        loss = model.loss_fn(cfg, params, inputs)
        loss.backward()
        return loss.item(), {n: p.grad for n, p in params.named_parameters()}

    reset_model_counts()
    loss_k, grads_k = loss_and_grads()
    kernel_counts = model_counts()
    reset_model_counts()
    with mock.patch.object(ops, "flash_attention", plain_flash), \
            mock.patch.object(ops, "ssd_state_scan", ref.ssd_state_scan_ref):
        loss_p, grads_p = loss_and_grads()
    if any(model_counts().values()):
        raise SystemExit(f"fp32 train {arch}: the plain run launched a "
                         f"kernel")
    rel = {n: float((g - grads_p[n]).norm() / grads_p[n].norm().clamp_min(
        1e-30)) for n, g in grads_k.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"  fp32 {cfg.name} ({depth_note(cfg)}), B={batch} S={seq}: loss "
        f"{loss_k:.6f} (kernels) vs {loss_p:.6f} (plain), rel "
        f"{loss_rel:.2e} (tol {FP32_TRAIN_LOSS_TOL:g}); {len(rel)} gradient "
        f"leaves, worst rel L2 {rel[worst]:.2e} ({worst}; tol "
        f"{FP32_TRAIN_GRAD_TOL:g}); kernel launches {kernel_counts}")
    if not (loss_rel <= FP32_TRAIN_LOSS_TOL
            and rel[worst] <= FP32_TRAIN_GRAD_TOL
            and kernel_counts["flash_attention_bwd"]
            + kernel_counts["ssd_scan_bwd"] > 0):
        raise SystemExit(f"fp32 train {arch}: the kernels' step disagrees "
                         f"with the plain versions'")
    del params, grads_k, grads_p


# -------------------------------------------------------------- placement
#: [placement]: one rank's NCCL group, ``make_local_mesh()`` = (1, 1).
#: Training: ``PLACED_TRAIN``, by ``TRAIN_RULES``;
#: serving: a prefill and ``PLACED_DECODE`` decode steps (the unplaced
#: run's greedy tokens fed to both) of ``PLACED_BATCH`` prompts of
#: ``PLACED_PROMPT`` tokens, by ``SERVE_RULES``, at ``SERVED_CUT`` depth
#: (arch, depth cut, batch, sequence length, peak lr, dtype) trained
#: placed: the train phase's StarCoder2-7B case, and Mamba2-370M whole
#: at B 2 x S 1024 (the SSM's in_proj re-split by ``sharding.take`` and
#: its gradient) in fp32.  In bf16 the placed loss's log-sum-exp over the
#: split vocabulary
#: (``model.lm_loss``) rounds the logits' gradient apart from the
#: unplaced ``logsumexp`` (the logits bit for bit, their gradient not),
#: and Mamba2-370M's 48 layers carry that to 3.6e-2 on a dt_bias leaf
#: (on an H100), past the bf16 tolerance, whatever take does; in fp32 the
#: two steps are held to the fp32 training tolerances
PLACED_TRAIN = (("starcoder2-7b", dict(num_layers=16), 2, 2048, 1e-5,
                 "bfloat16"),
                ("mamba2-370m", {}, 2, 1024, 3e-4, "float32"))
PLACED_SERVED = ("deepseek-v3-671b", "zamba2-7b")
PLACED_BATCH, PLACED_PROMPT, PLACED_DECODE = 2, 500, 4
#: placed vs unplaced in bf16: the train phase's tolerances (loss rel
#: 1e-5 would be fp32's; in bf16 the two paths' losses differ by the
#: placed loss's own reduction of the split vocabulary) and the serve
#: phase's for logits; in fp32 the fp32 training check's
PLACED_LOSS_TOL = 1e-3
PLACED_GRAD_TOL = 3e-2
PLACED_LOGIT_TOL = SERVE_LOGIT_TOL


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def local_map_calls():
    """{op: calls} of the placed route to local shards,
    ``dist.sharding.on_shards`` (``local_map``): K1 and K2 through
    ``kernels.ops``, K3 inside the SSD scan the SSM runs on its shards."""
    from repro_torch.dist import sharding

    calls = {}
    route = sharding.on_shards

    def counted(name, *args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return route(name, *args, **kwargs)

    with mock.patch.object(sharding, "on_shards", counted):
        yield calls


def k2_profiled_launches(fn):
    """fn() under torch.profiler: its K2 forward and backward kernels'
    launches (device kernels by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fwd = bwd = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = kernel_name(e.key)
        if name.startswith("flash_fwd"):
            fwd += e.count
        elif any(name.startswith(k) for k in BWD_KERNELS):
            bwd += e.count
    return fwd, bwd


def placed_train(dev, mesh, arch, cut, batch, seq, lr, dtype) -> dict:
    """One training step of ``arch`` (a ``PLACED_TRAIN`` case) in
    ``dtype`` from the same seeded weights and batch, unplaced and with
    the parameters, AdamW's moments and the batch placed by
    ``TRAIN_RULES`` on ``mesh``: the loss and every gradient leaf (bit
    for bit, or within ``PLACED_LOSS_TOL`` / ``PLACED_GRAD_TOL`` in bf16,
    ``FP32_TRAIN_LOSS_TOL`` / ``FP32_TRAIN_GRAD_TOL`` in fp32: printed
    which), K2's
    forward and backward launches by the profiler (equal), the placed
    route's ``local_map`` calls (every K2 and K3 forward through it),
    and each path's step ms (the mean of two steps after the compared
    one).  Returns the placed run's kernel launch counts."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model
    from repro_torch.train import loop
    from repro_torch.train.optimizer import AdamW

    cfg = dataclasses.replace(served_config(arch, cut), dtype=dtype)
    loss_tol, grad_tol = ((FP32_TRAIN_LOSS_TOL, FP32_TRAIN_GRAD_TOL)
                          if dtype == "float32"
                          else (PLACED_LOSS_TOL, PLACED_GRAD_TOL))
    inputs = loop.batch_to(next(SyntheticLM(
        cfg, DataConfig(batch_size=batch, seq_len=seq, seed=0))
        .batches(1)), dev)
    runs = {}
    for placed in (False, True):
        params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        b = inputs
        if placed:
            sh.distribute(params, mesh, sh.TRAIN_RULES)
            b = sh.place_tree(inputs, model.batch_axes(inputs), mesh,
                              sh.TRAIN_RULES)
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        opt = AdamW(lr=lr)
        state = opt.init(named)
        def step(record=None):
            for p in named.values():
                p.grad = None
            with (sh.axis_rules(mesh, sh.TRAIN_RULES) if placed
                  else contextlib.nullcontext()):
                loss = model.loss_fn(cfg, params, b, remat=True)
                loss.backward()
                grads = {n: p.grad for n, p in named.items()}
                if record is not None:
                    record["loss"] = float(sh.gather(loss.detach()))
                    record["grads"] = {n: sh.gather(g).detach().clone()
                                       for n, g in grads.items()}
                opt.step_(named, grads, state)

        rec = {}
        reset_model_counts()
        with local_map_calls() as calls:
            step(rec)
            torch.cuda.synchronize()
        counts = model_counts()
        # K2's launches by the profiler, where the step launches K2
        fwd, bwd = (k2_profiled_launches(step) if counts["flash_attention"]
                    else (0, 0))
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        rec.update(counts=counts, k2=(fwd, bwd), local_map=dict(calls),
                   ms=1e3 * sum(times) / len(times))
        runs[placed] = rec
        del params, named, state, opt
        gc.collect()
        torch.cuda.empty_cache()
    want, got = runs[False], runs[True]
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    rel = {n: float((g.float() - want["grads"][n].float()).norm()
                    / want["grads"][n].float().norm().clamp_min(1e-30))
           for n, g in got["grads"].items()}
    worst = max(rel, key=rel.get)
    exact = loss_rel == 0 and all(torch.equal(g, want["grads"][n])
                                  for n, g in got["grads"].items())
    log(f"  train {cfg.name} ({depth_note(cfg)}, {dtype}), B={batch} "
        f"S={seq}: loss {got['loss']:.6f} placed vs {want['loss']:.6f}, rel "
        f"{loss_rel:.2e}; {len(rel)} gradient leaves, worst rel L2 "
        f"{rel[worst]:.2e} ({worst}): "
        + ("bit for bit" if exact else
           f"held to loss {loss_tol:g}, leaves {grad_tol:g}"))
    k2 = (f"placed {got['k2']}, unplaced {want['k2']}"
          if got["counts"]["flash_attention"] else "none, not profiled")
    log(f"    K2 forward/backward launches by the profiler, a step: {k2}; "
        f"the compared step's launches {got['counts']}, its local_map "
        f"calls {got['local_map']}")
    log(f"    step {want['ms']:.1f} ms unplaced, {got['ms']:.1f} ms placed "
        f"({got['ms'] / want['ms']:.3f}x; mean of 2 steps each, after the "
        f"compared one" + (" and the profiled one)"
                           if got["counts"]["flash_attention"] else ")"))
    if not (exact or (loss_rel <= loss_tol and rel[worst] <= grad_tol)):
        raise SystemExit(f"placement {arch}: the placed training step "
                         f"disagrees with the unplaced one")
    if got["k2"] != want["k2"] or (got["counts"]["flash_attention"]
                                   and got["k2"][1] == 0):
        raise SystemExit(f"placement {arch}: K2's launches differ between "
                         f"the placed and the unplaced step")
    if got["counts"] != want["counts"] or any(
            got["local_map"].get(op, 0) != got["counts"][kernel]
            for op, kernel in (("flash_attention", "flash_attention"),
                               ("ssd_chunked", "ssd_scan"))):
        raise SystemExit(f"placement {arch}: a placed K2 or K3 call did not "
                         f"go through local_map")
    return got["counts"], {"step_ms": [got["ms"], want["ms"]],
                           "bit_for_bit": exact}


def placed_serve(dev, mesh, arch: str) -> dict:
    """A prefill of ``PLACED_BATCH`` x ``PLACED_PROMPT`` tokens and
    ``PLACED_DECODE`` decode steps of ``arch`` (``SERVED_CUT`` depth),
    unplaced and then with the same weights, inputs and tokens placed
    by ``SERVE_RULES`` on ``mesh``: every step's logits against the
    unplaced run's (rel L2, ``PLACED_LOGIT_TOL``; printed whether bit
    for bit), the MoE pairs each run dropped at capacity (``moe.DROPPED``,
    equal), and the placed run's K1/K2/K3 launches, which must match
    the work and all go through ``local_map``.  Returns them and the
    run's summary figures."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import model, moe

    cfg = served_config(arch)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    inputs = model.make_inputs(cfg, PLACED_BATCH, PLACED_PROMPT, device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(1))
    S = PLACED_PROMPT

    def run(placed, tokens=None):
        b, ctx = inputs, contextlib.nullcontext()
        if placed:
            b = sh.place_tree(inputs, model.batch_axes(inputs), mesh,
                              sh.SERVE_RULES)
            ctx = sh.axis_rules(mesh, sh.SERVE_RULES)
        out, toks = [], []
        with torch.no_grad(), ctx:
            logits, pre, _ = model.forward(cfg, params, b, return_cache=True)
            cache = model.init_decode_cache(
                cfg, PLACED_BATCH, S + PLACED_DECODE, device=dev,
                **(dict(mesh=mesh, rules=sh.SERVE_RULES) if placed else {}))
            model.merge_prefill_cache(cache, pre)
            out.append(sh.gather(logits[:, -1]).float())
            for i in range(PLACED_DECODE):
                tok = (out[-1].argmax(-1).to(torch.int32)[:, None]
                       if tokens is None else tokens[i])
                toks.append(tok)
                cur = torch.full((PLACED_BATCH,), S + i, dtype=torch.int32,
                                 device=dev)
                if placed:
                    tok = sh.place(tok, mesh, sh.SERVE_RULES, ("batch", None))
                    cur = sh.place(cur, mesh, sh.SERVE_RULES, ("batch",))
                logits, cache = model.decode_step(cfg, params, tok, cache,
                                                  cur)
                out.append(sh.gather(logits[:, 0]).float())
        torch.cuda.synchronize()
        return out, toks

    moe.DROPPED = 0
    t = time.perf_counter()
    want, toks = run(False)
    plain_s = time.perf_counter() - t
    dropped = [0, moe.DROPPED]
    sh.distribute(params, mesh, sh.SERVE_RULES)
    reset_model_counts()
    moe.DROPPED = 0
    with local_map_calls() as calls:
        t = time.perf_counter()
        got, _ = run(True, toks)
        placed_s = time.perf_counter() - t
    dropped[0] = moe.DROPPED
    counts = model_counts()
    rel = [float((g - w).norm() / w.norm()) for g, w in zip(got, want)]
    exact = all(torch.equal(g, w) for g, w in zip(got, want))
    expect = expected_launches(cfg, 1, PLACED_DECODE)
    log(f"  serve {cfg.name} ({depth_note(cfg)}): prefill {PLACED_BATCH} x "
        f"{S} and {PLACED_DECODE} decode steps, logits placed vs unplaced: "
        f"rel L2 up to {max(rel):.2e} "
        f"({'bit for bit' if exact else f'tol {PLACED_LOGIT_TOL:g}'}); "
        f"{plain_s:.2f} s unplaced, {placed_s:.2f} s placed (host "
        f"clock, first calls); MoE pairs dropped at capacity {dropped[0]} "
        f"placed, {dropped[1]} unplaced; launches {counts}, expected "
        f"{expect}; local_map calls {calls}")
    if not (exact or max(rel) <= PLACED_LOGIT_TOL):
        raise SystemExit(f"placement {arch}: placed logits disagree")
    if dropped[0] != dropped[1]:
        raise SystemExit(f"placement {arch}: the placed run dropped "
                         f"{dropped[0]} pairs, the unplaced one {dropped[1]}")
    if any(counts[k] != v for k, v in expect.items()):
        raise SystemExit(f"placement {arch}: launch counts do not match the "
                         f"served work")
    for op, kernel in (("flash_attention", "flash_attention"),
                       ("decode_attention", "decode_attention"),
                       ("ssd_chunked", "ssd_scan")):
        if calls.get(op, 0) != counts[kernel]:
            raise SystemExit(f"placement {arch}: {counts[kernel]} {kernel} "
                             f"launches, {calls.get(op, 0)} through "
                             f"local_map")
    del params, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"s": [placed_s, plain_s], "bit_for_bit": exact,
                    "dropped": dropped}


def placement(dev):
    """[placement]: an NCCL process group of one rank on ``dev`` and
    ``make_local_mesh()``, (1, 1) with a ``DeviceMesh``; the placed
    training step and the placed serving runs.  Nothing is caught: a
    failing group or ``local_map`` fails the run.  Returns each run's
    kernel launch counts and the phase's summary (each figure placed,
    then unplaced), which ``main`` prints next to the last line so that
    it reaches the record whatever the log's length."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_local_mesh()
        if mesh.device_mesh is None or mesh.size != 1:
            raise SystemExit(f"placement: make_local_mesh() gave {mesh}")
        log(f"  make_local_mesh(): {mesh.shape}, {mesh.device_mesh}")
        by_run, summary = {}, {}
        for case in PLACED_TRAIN:
            by_run[f"placed train {case[0]}"], summary[f"train {case[0]}"] \
                = placed_train(dev, mesh, *case)
            gc.collect()
            torch.cuda.empty_cache()
        for arch in PLACED_SERVED:
            by_run[f"placed serve {arch}"], summary[f"serve {arch}"] = \
                placed_serve(dev, mesh, arch)
    finally:
        dist.destroy_process_group()
    return by_run, summary


# ---------------------------------------------------------------- dry run
#: the dry run's argument bytes against the device memory the trained run
#: asked for, for the same config and batch: equal, but for a stray
#: scalar.  ``memory_allocated`` is larger by the caching allocator's
#: rounding: each block is a multiple of 512 bytes, and a block carved
#: from a larger free one is not split when 1 MiB or less would remain,
#: so a tensor may hold up to 1 MiB + 511 bytes more than it asked for
#: (2.2% of Mamba2-370M's 4.2 GB over its 1,300 tensors)
DRY_MEMORY_SLACK = 1e-4
ALLOCATOR_ROUNDING = 2**20 + 511     # bytes a tensor's block may add
DRY_WORKERS = 6          # processes tracing the 40 cases on the host
#: the placed SSM train steps' collective term on 16x16 at train_4k (ms)
#: under torch 2.13.0+cpu, ``python -m repro_torch.launch.dryrun --arch
#: ARCH --shape train_4k --mesh 16x16`` (PERF.md): the port asks for
#: each of their collectives, so the card's torch must give the same
#: term within ``TORCH_VERSION_TOL``
SSM_TRAIN_COLLECTIVE_MS = {"mamba2-370m": 786.8894, "zamba2-7b": 4941.7492}
TORCH_VERSION_TOL = 0.05


def dry_case(arch: str, shape: str):
    """One case on the local mesh and on 16x16 (placed on a fake group of
    256, each device's terms); a pool worker's task."""
    from repro_torch.launch import dryrun

    return (dryrun.run_case(arch, shape, verbose=False),
            dryrun.run_case(arch, shape, mesh="16x16", verbose=False))


def dry_run(trained) -> None:
    """``launch.dryrun`` on every ``ARCHS`` x ``SHAPES`` case at full size on
    the meta device (host only, in DRY_WORKERS spawned processes); any
    case that fails fails the phase.  Then, for each config the train
    phase trained, the dry run's argument bytes at its depth and batch
    against the device memory the run had requested when its first step
    started (``DRY_MEMORY_SLACK``) and, within the allocator's rounding
    (``ALLOCATOR_ROUNDING`` a tensor), against ``memory_allocated``; and
    the dry run's roofline (the larger of its
    counted FLOPs over the bf16 peak and its unfused bytes over HBM's
    rate) beside the measured steady step: printed, not held."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    log(f"[dryrun] {len(ARCHS)} architectures x {len(SHAPES)} shapes at full "
        f"size on the meta device, one H100 (local mesh) and 16x16; "
        f"{DRY_WORKERS} processes")
    cases = [(a, s) for a in ARCHS for s in SHAPES]
    failed, placed = [], {}
    with ProcessPoolExecutor(
            DRY_WORKERS, mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        futures = [pool.submit(dry_case, a, s) for a, s in cases]
        for (a, s), fut in zip(cases, futures):
            try:
                local, prod = fut.result()
            except Exception as e:  # every failing case is reported
                failed.append(f"{a} x {s}: {type(e).__name__}: {e}")
                log(f"  {a} x {s}: FAILED: {type(e).__name__}: {e}")
                continue
            placed[a, s] = prod
            log(f"  {dryrun.format_case(local)}")
            log(f"    {dryrun.format_case(prod)}")
    for arch, want in SSM_TRAIN_COLLECTIVE_MS.items():
        if (arch, "train_4k") not in placed:
            continue
        got = placed[arch, "train_4k"]["collective_t"] * 1e3
        rel = abs(got - want) / want
        log(f"  {arch} train_4k 16x16 collective term: {got:.2f} ms under "
            f"torch {torch.__version__}, {want:.2f} ms under 2.13.0+cpu, "
            f"{rel:.2%} apart (tol {TORCH_VERSION_TOL:.0%})")
        if rel > TORCH_VERSION_TOL:
            failed.append(f"{arch} x train_4k: the collective term depends "
                          f"on the torch version")
    if failed:
        raise SystemExit(f"dryrun: {len(failed)} of {len(cases)} cases "
                         f"failed: {failed}")
    log(f"  {len(cases)} cases in {time.perf_counter() - t0:.1f} s wall")

    for arch, cut, batch, seq, _, remat, _ in TRAINED:
        cfg = served_config(arch, cut)
        shape = ShapeConfig("trained", seq, batch, "train")
        case = dryrun.build_case(cfg, shape, remat=remat)
        want = dryrun.argument_bytes(case, make_local_mesh(),
                                     dryrun.rules_for(cfg, shape, 1))
        run = trained[arch]
        rel = abs(run["requested"] - want) / want
        over = run["allocated"] - run["requested"]
        flops, nbytes = dryrun.measure(case.fn)
        compute_s = flops / PEAK_FLOPS[torch.bfloat16]
        memory_s = nbytes / HBM_BYTES_PER_S
        step_s = run["step_s"]
        log(f"  {cfg.name} ({depth_note(cfg)}), B={batch} S={seq}: dry-run "
            f"arguments {want:,} B; the card, before the first backward: "
            f"requested {run['requested']:,} B, rel {rel:.2e} (slack "
            f"{DRY_MEMORY_SLACK:g}), allocated {run['allocated']:,} B (rel "
            f"{(run['allocated'] - want) / want:.2e}; rounding {over:,} B "
            f"over {run['tensors']} tensors, at most "
            f"{run['tensors'] * ALLOCATOR_ROUNDING:,}); roofline compute "
            f"{compute_s * 1e3:.1f} ms, memory (unfused) "
            f"{memory_s * 1e3:.1f} ms, max {max(compute_s, memory_s) * 1e3:.1f}"
            f" ms against the measured step {step_s * 1e3:.1f} ms: "
            f"{max(compute_s, memory_s) / step_s:.3f} of it (compute "
            f"{compute_s / step_s:.3f})")
        if rel > DRY_MEMORY_SLACK or not \
                0 <= over <= run["tensors"] * ALLOCATOR_ROUNDING:
            raise SystemExit(f"dryrun {arch}: the dry run's argument bytes "
                             f"disagree with the card's allocation")
    log(f"[dryrun] done in {time.perf_counter() - t0:.1f} s wall")


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
    rows read once, init read and params written, the losses written.
    The chain is that of a walk over t one point at a time (the
    sequential design's floor, not the blocked scan's)."""
    k = p + 1 + q
    per_point = 1 + 2 * p + 2 * q + 2 + k * 2 * q + 2 * k
    return (rows * steps * length * per_point,
            4 * (rows * length + 2 * rows * k + rows), steps * length)


def time_arma(dev, run, errs, launches, replay):
    """The fit kernel at the run's longest fitted rows, and at
    ``ARMA_REPLICAS`` copies of them: CUDA events (L2 flushed), its plain
    version on the host, its bound and the sequential chain floor."""
    from repro_torch.kernels import arma_fit

    fit = max(run["fits"], key=lambda f: (f["y"].shape[1], f["y"].shape[0]))
    p, q, steps, lr = fit["p"], fit["q"], fit["steps"], fit["lr"]
    clock_mhz = float(smi_line("clocks.max.sm").split()[0])
    flush = L2Flush(dev)
    shapes = []
    for copies in (1, ARMA_REPLICAS):
        y = fit["y"].repeat(copies, 1)
        init = torch.from_numpy(fit["init"]).to(dev).repeat(copies, 1)
        t_kernel = time_ms(lambda: arma_fit.arma_fit(y, init, p, q, steps,
                                                     lr), flush, reps=5)
        t0 = time.perf_counter()
        arma_plain(y, init, p, q, steps, lr)
        t_plain = (time.perf_counter() - t0) * 1e3
        ops, nbytes, chain = arma_bound(y.shape[0], y.shape[1], p, q, steps)
        t_ops = ops / PEAK_FLOPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        chain_ms = chain * FMA_LATENCY_CYCLES / (clock_mhz * 1e6) * 1e3
        what = ("lt-ua+plan run, longest rows" if copies == 1 else
                f"{copies} replicas of the run's longest rows")
        shape = (f"{what}: S={y.shape[0]} L={y.shape[1]} p={p} q={q} "
                 f"steps={steps} fp32")
        log(f"  arma_fit         {shape}: kernel {t_kernel:.4f} ms, plain "
            f"{t_plain:.1f} ms (host), library n/a, bound "
            f"{max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}), sequential "
            f"chain floor {chain_ms:.4f} ms ({steps} x {y.shape[1]} x "
            f"{FMA_LATENCY_CYCLES} cycles at {clock_mhz:.0f} MHz)")
        shapes.append(dict(
            ms=t_kernel, plain_ms=t_plain, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, chain_floor_ms=chain_ms, shape=shape))
    del flush
    return dict(
        name="arma_fit", route="cuda",
        source="src/repro_torch/kernels/csrc/arma_fit.cu",
        replaces="src/repro/control/forecast.py:145",
        launches=launches["arma_fit"],
        max_abs_err=max(errs["arma_fit"], replay["max_abs_err"]),
        **shapes[0], other_shapes=shapes[1:],
        plain_on="host (float32 numpy)",
        launches_by_run={"lt-ua+plan": launches["arma_fit"]})


# ---------------------------------------------------------------- vector
def bucket_case(dev, seed, modes, b0=0, **kw):
    """A seeded segment of the bucket step on the card
    (``bucket_step.synthetic_case``): (layout, consts, prm, carry, xs,
    b0, b1)."""
    from repro_torch.kernels import bucket_step

    every = tuple(bucket_step.MODES)
    modes = {"all": every, "all+3": every + ("reactive", "lt-ua",
                                             "chiron")}.get(modes, modes)
    lay, *arrays = bucket_step.synthetic_case(seed, modes, **kw)
    consts, prm, carry, xs = (torch.from_numpy(a).to(dev) for a in arrays)
    return lay, consts, prm, carry, xs, b0, b0 + xs.shape[0]


def check_bucket(dev, errs):
    """The bucket step's kernel against its plain version on the card, bit
    for bit, on every case of ``BUCKET_CASES``; then a replica alone and
    in a permuted batch, and a repeat."""
    from repro_torch.kernels import bucket_step, ref

    failed = []
    for label, kw in BUCKET_CASES:
        args = bucket_case(dev, **kw)
        got = bucket_step.bucket_segment(*args)
        want = ref.bucket_segment_ref(*args)
        failed += report("bucket_step", label, torch.float32,
                         torch.cat([got[0].flatten(), got[1].flatten()]),
                         torch.cat([want[0].flatten(), want[1].flatten()]),
                         errs, BUCKET_ATOL, 0.0)
    lay, consts, prm, carry, xs, b0, b1 = bucket_case(
        dev, **dict(BUCKET_CASES)["R=5, every mode, unified"])
    c, y = bucket_step.bucket_segment(lay, consts, prm, carry, xs, b0, b1)
    again = bucket_step.bucket_segment(lay, consts, prm, carry, xs, b0, b1)
    perm = torch.tensor([3, 0, 4, 1, 2], device=dev)
    pc, py = bucket_step.bucket_segment(lay, consts, prm[perm], carry[perm],
                                        xs, b0, b1)
    ac, ay = bucket_step.bucket_segment(lay, consts, prm[2:3], carry[2:3],
                                        xs, b0, b1)
    checks = {"repeat": torch.equal(again[0], c) and torch.equal(again[1], y),
              "permuted": torch.equal(pc, c[perm]) and torch.equal(py, y[perm]),
              "alone": torch.equal(ac[0], c[2]) and torch.equal(ay[0], y[2])}
    log("  bucket_step      5 replicas x 240 buckets: bit-identical "
        + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    failed += [f"bucket_step {k}" for k, v in checks.items() if not v]
    return failed


def vector_specs():
    """The seven strategies of ``benchmarks/common.py:stack_spec`` at
    ``BenchSpec()``'s defaults (5 initial instances, 30 spot spares,
    FCFS), written out: that module imports jax."""
    from repro_torch.api import PolicySpec, StackSpec
    from repro_torch.sim.workload import PAPER_MODELS, REGIONS

    common = dict(models=PAPER_MODELS, regions=REGIONS, scheduler="fcfs",
                  spot_spare=30)
    plan = {k: v for k, v in SIM_PLANNER.items() if k != "use_routing"}
    out = {"siloed": StackSpec(scaler="reactive", queue=None, siloed=True,
                               siloed_iw=4, siloed_niw=2,
                               initial_instances=5, **common),
           "chiron": StackSpec(scaler=PolicySpec("chiron", {
               "theta": 0.6, "init_interactive": 3, "init_mixed": 1,
               "init_batch": 1}), initial_instances=None, **common),
           "lt-ua+plan": StackSpec(
               scaler="lt-ua", planner=PolicySpec("sageserve",
                                                  dict(SIM_PLANNER)),
               router="plan", initial_instances=5, **common)}
    for s in ("reactive", "lt-i", "lt-u", "lt-ua"):
        out[s] = StackSpec(scaler=s, planner=None if s == "reactive" else
                           PolicySpec("sageserve", dict(plan)),
                           initial_instances=5, **common)
    return {s: out[s] for s in VECTOR_STRATEGIES}


def vector_experiment():
    """The seven strategies over phase 8's 3-day trace on the vector
    engine, with the fit and ILP caches emptied (phase 8 and its replay
    filled them with this trace's fits and plans), so a run fits and
    solves its own."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.control import amortize, forecast
    from repro_torch.sim.workload import WorkloadSpec

    forecast.clear_fit_cache()
    amortize.clear_solve_cache()
    return ExperimentSpec(name="vector", strategies=vector_specs(),
                          workloads={"3d": WorkloadSpec(**SIM_WORKLOAD)},
                          engine="vector")


def vector(dev):
    """``run_experiment(engine="vector")`` over the 3-day trace of phase
    5 with the seven strategies, on ``dev``: the unified stacks step as
    one batch, siloed alone.  Records every segment the engine launches
    (its input carry, the kernel's outputs and CUDA events around the
    launch).  Returns the results, the records and the kernel launch
    counts, set to 0 just before the run and read just after."""
    from repro_torch.api import run_experiment
    from repro_torch.kernels import arma_fit, bucket_step, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    segs, segment = [], ops.bucket_segment

    def recorded(lay, consts, prm, carry, xs, b0, b1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = bucket_step.LAUNCHES
        start.record()
        out, ys = segment(lay, consts, prm, carry, xs, b0, b1)
        end.record()
        segs.append(dict(lay=lay, consts=consts, prm=prm, carry=carry,
                         xs=xs, b0=b0, b1=b1, out=out, ys=ys,
                         events=(start, end),
                         kernel=bucket_step.LAUNCHES - before))
        return out, ys

    exp = vector_experiment()
    fa.LAUNCHES = dec.LAUNCHES = ssd.LAUNCHES = arma_fit.LAUNCHES = 0
    bucket_step.LAUNCHES = 0
    t0 = time.perf_counter()
    with mock.patch.object(ops, "bucket_segment", recorded):
        results = run_experiment(exp, jobs=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES,
                "decode_attention": dec.LAUNCHES,
                "ssd_scan": ssd.LAUNCHES, "arma_fit": arma_fit.LAUNCHES,
                "bucket_step": bucket_step.LAUNCHES}
    return dict(results=results, segs=segs, wall=wall), launches


def report_vector(vrun, launches, event_run) -> None:
    """Print each strategy's Report and the batches' control-plane
    counters; fail unless every segment launched the kernel, every run
    completed, and the vector ``lt-ua+plan`` Report is within the
    reference's vector-vs-event tolerance of phase 8's."""
    results, segs = vrun["results"], vrun["segs"]
    for r in results:
        log(f"  {r.strategy:10s} [{r.engine}] GPU-hours "
            f"{r.total_instance_hours:.2f}, dollars "
            f"{r.total_gpu_dollars:.2f}, SLA attainment "
            + ", ".join(f"{t} {r.sla_attainment(t):.5f}"
                        for t in sorted(r.sla_violations))
            + f", completed {r.completed_total} of {r.n_requests} "
            f"({r.completion:.5f})")
    batches = {}
    for r in results:
        ctl = r.extras.get("control")
        if ctl:
            batches[ctl["batch"]] = ctl
    for name, ctl in batches.items():
        log(f"  batch of {ctl['replicas']} (first {name}): "
            + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in sorted(ctl.items())
                        if k not in ("batch", "replicas")))
    dev_s = sum(g["events"][0].elapsed_time(g["events"][1])
                for g in segs) / 1e3
    buckets = sum(g["b1"] - g["b0"] for g in segs)
    log(f"  {len(results)} runs in {vrun['wall']:.1f} s wall; "
        f"{len(segs)} segments ({buckets} buckets x their replicas), "
        f"bucket_step launches {launches['bucket_step']}, arma_fit "
        f"launches {launches['arma_fit']}; the segments' device time "
        f"(CUDA events) {dev_s:.3f} s, {dev_s / vrun['wall']:.1%} of the "
        f"wall time")
    if not (len(segs) == launches["bucket_step"] > 0
            and all(g["kernel"] == 1 for g in segs)
            and all(r.engine == "vector" for r in results)):
        raise SystemExit("vector: a segment did not run on the kernel")
    if any(launches[k] for k in ("flash_attention", "decode_attention",
                                 "ssd_scan")) or not launches["arma_fit"]:
        raise SystemExit(f"vector: unexpected launches {launches}")
    if any(r.n_requests != event_run["requests"] or r.completed_total <= 0
           for r in results):
        raise SystemExit("vector: a run did not complete")
    ev = event_run["report"]
    ev_done = sum(ev.completed.values())
    ev_frac = ev_done / max(ev_done + sum(ev.dropped.values()), 1)
    vec = {r.strategy: r for r in results}["lt-ua+plan"]
    vec_frac = vec.completed_total / max(
        vec.completed_total + vec.dropped_total, 1)
    d_frac = vec_frac - ev_frac
    d_hours = vec.total_instance_hours / ev.total_instance_hours() - 1.0
    d_dollars = vec.total_gpu_dollars / ev.total_gpu_dollars() - 1.0
    log(f"  lt-ua+plan, vector vs event loop (phase 8): completion "
        f"{vec_frac:.5f} vs {ev_frac:.5f} ({d_frac:+.5f}, tol "
        f"{COMPLETION_ABS_TOL}), GPU-hours {d_hours:+.4%}, dollars "
        f"{d_dollars:+.4%} (tol {HOURS_REL_TOL:.0%})")
    if not (abs(d_frac) <= COMPLETION_ABS_TOL
            and abs(d_hours) <= HOURS_REL_TOL
            and abs(d_dollars) <= HOURS_REL_TOL):
        raise SystemExit("vector: lt-ua+plan disagrees with the event loop")


class PlainStepGraph:
    """The plain step of one bucket (``ref.bucket_step_ref``) for R
    replicas of one layout, captured once in a CUDA graph: its carry,
    parameters, inputs and bucket index are static device tensors, so a
    replay steps any bucket of any segment of that layout.  The graph
    writes the new carry to its own output, copied back to the input
    after each replay (a graph that also wrote its input carry in place
    replayed wrong on the card).  A measurement and check only, never the
    path."""

    def __init__(self, lay, consts, prm, carry, x):
        from repro_torch.kernels import ref

        dev = carry.device
        self.lay = lay
        self.prm, self.carry, self.x = prm.clone(), carry.clone(), x.clone()
        self.b = torch.zeros((), dtype=torch.int64, device=dev)
        self.consts = lay.consts(consts.clone())

        def step():
            tree, y = ref.bucket_step_ref(lay, self.consts, lay.prm(self.prm),
                                          lay.carry(self.carry),
                                          lay.xs(self.x), self.b)
            out = torch.empty_like(self.carry)
            lay.pack_into(out, tree, lay.carry_shapes, lay.carry_off)
            ys = torch.empty((self.carry.shape[0], lay.Y), device=dev)
            lay.pack_into(ys, y, lay.ys_shapes, lay.ys_off)
            return out, ys

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()                       # builds the layout's index tensors
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out, self.ys = step()

    def segment(self, prm, carry, xs, b0):
        """Buckets b0 .. b0 + len(xs) - 1 from ``carry``: (carry, ys),
        as ``ref.bucket_segment_ref`` returns them."""
        self.prm.copy_(prm)
        self.carry.copy_(carry)
        ys = torch.empty((carry.shape[0], xs.shape[0], self.lay.Y),
                         device=carry.device)
        for s in range(xs.shape[0]):
            self.b.fill_(b0 + s)
            self.x.copy_(xs[s])
            self.graph.replay()
            self.carry.copy_(self.out)
            ys[:, s].copy_(self.ys)
        return self.carry.clone(), ys


def profile_vector(dev, launches) -> None:
    """The vector run once more under torch.profiler (device activity
    only): the bucket_step kernels' own device time (phase 9's events
    around each launch also hold the host's enqueue gaps), the fit
    kernels', and the run's device-busy share of its wall time (which
    the profiler inflates)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import run_experiment

    exp = vector_experiment()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # one trivial kernel first: a run on the card once recorded every
        # launch of the run but its first, the siloed segment
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_experiment(exp, jobs=1, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.count, e.self_device_time_total / 1e6)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    mine = lambda name: [r for r in rows if name in r[0]]
    bucket, fit = mine("bucket_segment_kernel"), mine("arma")
    busy = sum(r[2] for r in rows)
    n_bucket = sum(r[1] for r in bucket)
    log(f"  profiled again: bucket_step kernels {sum(r[2] for r in bucket):.4f}"
        f" s of device time over {n_bucket} launches, arma_fit kernels "
        f"{sum(r[2] for r in fit):.4f} s, all device work {busy:.4f} s = "
        f"{busy / wall:.1%} of {wall:.2f} s wall under the profiler")
    if n_bucket != launches["bucket_step"]:
        raise SystemExit(f"vector: the profiled run launched {n_bucket} "
                         f"bucket_step kernels, the first "
                         f"{launches['bucket_step']}; recorded: "
                         + ", ".join(f"{k} x{n} {s:.4f} s"
                                     for k, n, s in bucket))


def replay_vector(vrun, errs) -> int:
    """Every recorded segment of the run again through the plain step on
    the card, bucket by bucket from the segment's recorded input carry
    (one captured bucket replayed, ``PlainStepGraph``): every bucket's
    outputs and the segment's final carry must equal the kernel's bit for
    bit.  Returns the replica-buckets replayed."""
    n, t0, worst, graphs = 0, time.perf_counter(), 0.0, {}
    for g in vrun["segs"]:
        key = (id(g["lay"]), g["carry"].shape[0])
        if key not in graphs:
            graphs[key] = PlainStepGraph(g["lay"], g["consts"], g["prm"],
                                         g["carry"], g["xs"][0])
        want_c, want_y = graphs[key].segment(g["prm"], g["carry"], g["xs"],
                                             g["b0"])
        got_c, got_y = g["out"], g["ys"]
        diff = max(float((got_c - want_c).abs().max()),
                   float((got_y - want_y).abs().max()))
        worst = max(worst, diff)
        if not (torch.equal(got_c, want_c) and torch.equal(got_y, want_y)):
            bad = int((got_y != want_y).any(dim=2).any(dim=0).nonzero()[0])\
                if not torch.equal(got_y, want_y) else g["b1"] - g["b0"]
            raise SystemExit(f"vector: the kernel disagrees with its plain "
                             f"version on segment [{g['b0']}, {g['b1']}) "
                             f"from bucket {g['b0'] + bad} (max abs err "
                             f"{diff:.3e})")
        n += (g["b1"] - g["b0"]) * g["carry"].shape[0]
    errs["bucket_step"] = max(errs["bucket_step"], worst)
    log(f"  plain replay of all {len(vrun['segs'])} segments of the run "
        f"(both batches, every bucket) on the card, the plain step of one "
        f"bucket in a CUDA graph: {n} replica-buckets bit-identical in "
        f"{time.perf_counter() - t0:.1f} s (max abs err {worst:.3e}, tol "
        f"{BUCKET_ATOL:g})")
    return n


def time_bucket(dev, vrun, errs, launches):
    """The bucket step at a 240-bucket segment of the run (an hour between
    two control boundaries) for its first replica and for 8 replicas:
    the kernel (CUDA events, L2 flushed), its plain version on the card,
    the byte bound and the chain floor of the segment's buckets
    (``BUCKET_CHAIN``)."""
    from repro_torch.kernels import bucket_step, ref

    g = next(g for g in vrun["segs"]
             if g["b1"] - g["b0"] == 240 and g["carry"].shape[0] > 1)
    lay, b0, b1 = g["lay"], g["b0"], g["b1"]
    clock_mhz = float(smi_line("clocks.max.sm").split()[0])
    flush = L2Flush(dev)
    shapes = []
    for reps in (1, ARMA_REPLICAS):
        idx = torch.arange(reps, device=dev) % g["carry"].shape[0]
        args = (lay, g["consts"], g["prm"][idx], g["carry"][idx], g["xs"],
                b0, b1)
        t_kernel = time_ms(lambda: bucket_step.bucket_segment(*args), flush,
                           reps=5)
        ref.bucket_segment_ref(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ref.bucket_segment_ref(*args)
        torch.cuda.synchronize()
        t_plain = (time.perf_counter() - t0) * 1e3
        # the plain step of one bucket captured in a CUDA graph, replayed
        # bucket by bucket: a measurement only, never the path; timed by
        # the host clock, as eager is
        graph = PlainStepGraph(*args[:4], args[4][0])
        graph.segment(*args[2:5], b0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        captured = graph.segment(*args[2:5], b0)
        torch.cuda.synchronize()
        t_graph = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(captured[0], want[0])
                and torch.equal(captured[1], want[1])):
            raise SystemExit("bucket_step: the captured plain step "
                             "disagrees with the eager one")
        del graph, captured
        S = b1 - b0
        nbytes = 4 * (S * lay.X + reps * S * lay.Y + 2 * reps * lay.F
                      + reps * lay.K + lay.NC)
        ops_n = reps * S * lay.C * lay.J * BUCKET_OPS_PER_CELL
        t_ops = ops_n / PEAK_FLOPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        chain_cycles = sum(n * c for n, c in BUCKET_CHAIN.values())
        chain_ms = S * chain_cycles / (clock_mhz * 1e6) * 1e3
        shape = (f"{S}-bucket segment [{b0}, {b1}) of the unified batch, "
                 f"R={reps}, C={lay.C} J={lay.J} L={lay.L} fp32")
        log(f"  bucket_step      {shape}: kernel {t_kernel:.4f} ms, plain "
            f"{t_plain:.1f} ms (card, eager, host clock), plain in a CUDA "
            f"graph {t_graph:.3f} ms (host clock), library n/a, bound "
            f"{max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}; out of "
            f"reach of a sequential step), chain floor {chain_ms:.4f} ms "
            f"({S} buckets x {chain_cycles} cycles at {clock_mhz:.0f} MHz: "
            + ", ".join(f"{n} x {c} {k}" for k, (n, c) in
                        BUCKET_CHAIN.items())
            + f"); {t_kernel / S * clock_mhz * 1e3:.0f} cycles a bucket")
        shapes.append(dict(
            ms=t_kernel, plain_ms=t_plain, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, chain_floor_ms=chain_ms, plain_graph_ms=t_graph,
            shape=shape))
    del flush
    return dict(
        name="bucket_step", route="cuda",
        source="src/repro_torch/kernels/csrc/bucket_step.cu",
        replaces="src/repro/sim/vector/engine.py:120",
        launches=launches["bucket_step"], max_abs_err=errs["bucket_step"],
        **shapes[0], other_shapes=shapes[1:],
        plain_on="card (eager PyTorch, one op at a time)",
        launches_by_run={"vector (7 strategies)": launches["bucket_step"]})


# ---------------------------------------------------------------- analysis
def analysis(dev) -> dict:
    """reprolint on the card's host, which has no JAX: the AST tier
    (``run_lint``) over ``src/repro_torch`` must find no violation and no
    stale suppression; the trace tier (``run_trace``) runs T1-T4 on the
    card against the vector engine's segment and the batched forecast fit
    through the real ``bucket_step`` and ``arma_fit`` kernels (T1 under
    ``torch.cuda.set_sync_debug_mode("error")``, T4 with
    ``memory_allocated`` flat across segments) and must find no violation.
    Returns the kernels' launches in the trace tier, set to 0 just before
    it and read just after."""
    from repro_torch.analysis import run_lint
    from repro_torch.analysis.trace import run_trace
    from repro_torch.kernels import arma_fit, bucket_step

    t0 = time.perf_counter()
    lint = run_lint()
    log(f"  AST tier (R0-R5, R7, R8): {lint.files_checked} files of "
        f"src/repro_torch, {len(lint.violations)} violation(s), "
        f"{len(lint.suppressed)} suppressed, {len(lint.warnings)} "
        f"stale suppression(s) (W0) in {time.perf_counter() - t0:.2f} s")
    for v in lint.violations + lint.warnings:
        log(f"    {v.render()}")
    bucket_step.LAUNCHES = arma_fit.LAUNCHES = 0
    result = run_trace(device=dev)
    launches = {"bucket_step": bucket_step.LAUNCHES,
                "arma_fit": arma_fit.LAUNCHES}
    log(f"  trace tier on {result.device}: {len(result.checks)} checks, "
        f"{len(result.violations)} violation(s) in {result.elapsed_s:.2f} s; "
        f"launches {launches}")
    for c in result.checks:
        log(f"    {c.rule} {c.target}: {'ok' if c.ok else 'FAIL'} in "
            f"{c.seconds:.3f} s{': ' + c.detail if c.detail else ''}")
    if lint.violations or lint.warnings or result.violations:
        raise SystemExit("analysis: reprolint found violations")
    if min(launches.values()) <= 0:
        raise SystemExit(f"analysis: the trace tier launched no kernel: "
                         f"{launches}")
    return launches


# ---------------------------------------------------------------- examples
#: the four examples of the port, run at their counterparts' defaults
EXAMPLES = ("torch_quickstart.py", "torch_autoscale_simulation.py",
            "torch_serve_cluster.py", "torch_train_small.py")
EXAMPLE_TIMEOUT_S = 300


def examples() -> None:
    """``EXAMPLES``, each in a process of its own on the card, all four
    started together (most of their time is host time, and the card's
    host has cores to spare), from the checkout's ``examples/``: each
    must exit 0 within EXAMPLE_TIMEOUT_S.  Prints each one's wall time
    (from the common start) and the last lines of its output (the whole
    output goes to ``build/examples/<name>.log``)."""
    import os
    import signal

    out_dir = ROOT / "build" / "examples"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running, done = {}, {}
    try:
        for name in EXAMPLES:
            fh = open(out_dir / f"{Path(name).stem}.log", "w")
            running[name] = (subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / name)],
                stdout=fh, stderr=subprocess.STDOUT, cwd=str(ROOT),
                start_new_session=True), fh)
        while running:
            for name, (proc, fh) in list(running.items()):
                rc = proc.poll()
                over = time.perf_counter() - t0 > EXAMPLE_TIMEOUT_S
                if rc is None and not over:
                    continue
                if rc is None:
                    os.killpg(proc.pid, signal.SIGKILL)   # workers too
                    proc.wait()
                    rc = "timeout"
                fh.close()
                done[name] = (rc, time.perf_counter() - t0)
                del running[name]
            time.sleep(0.2)
    finally:
        for proc, fh in running.values():
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            fh.close()
    failed = []
    for name in EXAMPLES:
        rc, wall = done[name]
        logfile = out_dir / f"{Path(name).stem}.log"
        tail = [line for line in logfile.read_text().splitlines()
                if line.strip()][-3:]
        log(f"  {name}: exit {rc} in {wall:.1f} s wall")
        for line in tail:
            log(f"    {line}")
        if rc != 0:
            failed.append(f"{name} (exit {rc})")
    if failed:
        raise SystemExit(f"examples failed: {failed}")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # the port's default:
    torch.backends.cudnn.allow_tf32 = False         # fp32 is full fp32
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
        found, serial = kernel_resources(text)
        if found:
            log("    " + ", ".join(f"{k}<{d}> {r} registers, {n} bytes "
                                   f"spilled" for k, d, r, n in found))
        for fn in serial:
            log(f"    wgmma serialized in {fn}")

    log("[kernels] kernel vs plain PyTorch version on the card")
    errs = check_kernels(dev)
    log("[kernels] timing at the served shapes (L2 flushed per launch)")
    rows = time_kernels(dev, errs)

    by_run = {}
    for arch, n_requests, max_new in SERVED:
        log(f"[serve] {arch}, full width, "
            f"{depth_note(served_config(arch))}, DPA, {n_requests} "
            f"requests of {max_new} new tokens")
        by_run[arch], seq, gap = serve(dev, arch, n_requests, max_new)
        gc.collect()             # the engine's timing hooks form a cycle
        torch.cuda.empty_cache()
        log(f"  freed: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
            f"still allocated")
        check_fp32_decode(dev, arch, seq, max_new - 1, gap)
        del gap
        gc.collect()
        torch.cuda.empty_cache()

    trained = {}
    for arch, cut, batch, seq, steps, remat, lr in TRAINED:
        log(f"[train] {arch}, full width, "
            f"{depth_note(served_config(arch, cut))}, train.loop.train, "
            f"B={batch} S={seq}, {steps} steps")
        by_run[f"train {arch}"], trained[arch] = train_run(
            dev, arch, cut, batch, seq, steps, remat, lr)
        gc.collect()             # the timing hooks form a cycle
        torch.cuda.empty_cache()
        log(f"  freed: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
            f"still allocated")
    for arch, cut, batch, seq in FP32_TRAIN:
        log(f"[train] fp32 step, kernels vs plain versions: {arch}")
        check_fp32_train(dev, arch, cut, batch, seq)
        gc.collect()
        torch.cuda.empty_cache()
    log("[placement] an NCCL process group of one rank, make_local_mesh() "
        "= (1, 1): the placed training step and serving runs against the "
        "unplaced ones, every kernel through local_map")
    t0 = time.perf_counter()
    placed_runs, placed_summary = placement(dev)
    by_run.update(placed_runs)
    log(f"[placement] done in {time.perf_counter() - t0:.1f} s wall")
    for row in rows:
        row["launches_by_run"] = {a: n[row["name"]]
                                  for a, n in by_run.items()}
        row["launches"] = sum(row["launches_by_run"].values())
        if row["launches"] <= 0:
            raise SystemExit(f"{row['name']} never launched on the served "
                             f"and trained paths")

    dry_run(trained)

    log(f"[simulate] lt-ua+plan, event loop, {SIM_WORKLOAD['days']:g} days, "
        f"forecast fits on the card")
    run, sim_launches = simulate(dev)
    report_simulation(run, sim_launches)
    replay = replay_plain(run)
    rows.append(time_arma(dev, run, errs, sim_launches, replay))

    log(f"[vector] run_experiment(engine=\"vector\"), "
        f"{len(VECTOR_STRATEGIES)} strategies over the same trace, every "
        f"segment on the bucket_step kernel")
    vrun, vec_launches = vector(dev)
    report_vector(vrun, vec_launches, run)
    profile_vector(dev, vec_launches)
    replay_vector(vrun, errs)
    rows.append(time_bucket(dev, vrun, errs, vec_launches))
    for row in rows:
        if row["name"] == "arma_fit":
            row["launches_by_run"]["vector (7 strategies)"] = \
                vec_launches["arma_fit"]

    log("[analysis] reprolint: the AST tier over src/repro_torch, the "
        "trace tier (T1-T4) on the card")
    t0 = time.perf_counter()
    trace_launches = analysis(dev)
    for row in rows:
        if row["name"] in trace_launches:
            row["launches_by_run"]["trace tier"] = trace_launches[row["name"]]
    log(f"[analysis] done in {time.perf_counter() - t0:.1f} s wall")

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[examples] the {len(EXAMPLES)} examples of the port, each in a "
        f"process of its own on the card, started together")
    t0 = time.perf_counter()
    examples()
    log(f"[examples] done in {time.perf_counter() - t0:.1f} s wall")

    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s"
        f" wall")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"placement": placed_summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
