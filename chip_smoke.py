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
3. kernels: the prefill (K2) and decode (K1) kernels against their plain
   PyTorch versions on the card, in bf16 and fp32, at StarCoder2-7B's
   attention widths, a long cache, Gemma's head_dim 256, a sliding
   window and fully masked rows; then each is timed at the served
   shapes beside its bound, its plain version and
   ``scaled_dot_product_attention`` (timed only; the port never calls it);
4. serve: StarCoder2-7B at full width and depth, bf16, random weights
   from a seeded generator, behind ``ServingEngine`` with DPA
   scheduling: 8 requests of 100-2000 prompt tokens, 32 new tokens each.
   Both kernels' launch counts must match the served work, and one
   request's last decode logits must match a full forward over its
   prompt and generated tokens.

The last lines are the ``kernels`` JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM bandwidth and its operations
# over the tensor-core rate for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SERVE_LOGIT_TOL = 3e-2   # relative L2 error, decode path vs full forward
PROFILED_CALL = 2        # which prefill and which decode call to profile
SPIN_CYCLES = 4_000_000  # ~2 ms at H100 clocks: longer than any call's host time


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
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
    went: wall time (inflated by the profiler), device-busy share, and
    the kernels with the most self device time."""
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
    for ms, count, key in rows[:8]:
        log(f"    {ms:8.3f} ms {ms / busy:5.1%} x{count:<5d} {key[:80]}")
    return out


# ---------------------------------------------------------------- kernels
def randn(dev, shape, dtype, gen):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_case(dev, dtype, gen, B, H, Hkv, S, T, hd, window=0,
               masked=False):
    """Inputs laid out as the model passes them: transposed views of
    (B, S, H, hd) activations."""
    q = randn(dev, (B, S, H, hd), dtype, gen).transpose(1, 2)
    k = randn(dev, (B, T, Hkv, hd), dtype, gen).transpose(1, 2)
    v = randn(dev, (B, T, Hkv, hd), dtype, gen).transpose(1, 2)
    qpos = (torch.arange(S, device=dev, dtype=torch.int32)
            + (T - S)).repeat(B, 1)
    kpos = torch.arange(T, device=dev, dtype=torch.int32).repeat(B, 1)
    if masked:   # padding rows, and a gap no windowed row can see past
        qpos[0, : S // 8] = -1
        kpos[-1, T // 4: 3 * T // 4] = -1
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


def check_kernels(dev):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(0)
    flash_cases = [
        ("starcoder2 prefill S=T=1999", dict(B=1, H=36, Hkv=4, S=1999,
                                              T=1999, hd=128)),
        ("starcoder2 prefill S=T=333", dict(B=1, H=36, Hkv=4, S=333,
                                             T=333, hd=128)),
        ("long: S=1024 of T=8192", dict(B=1, H=36, Hkv=4, S=1024, T=8192,
                                         hd=128)),
        ("gemma hd=256 g=1", dict(B=1, H=16, Hkv=16, S=700, T=700,
                                   hd=256)),
        ("window=256", dict(B=2, H=36, Hkv=4, S=1000, T=1000, hd=128,
                            window=256)),
        ("fully masked rows", dict(B=2, H=36, Hkv=4, S=200, T=200, hd=128,
                                   window=32, masked=True)),
    ]
    decode_cases = [
        ("starcoder2 decode B=4 W=4096", dict(
            B=4, H=36, Hkv=4, T=4096, hd=128, cur=[4095, 1999, 777, 130])),
        ("long: T=16384", dict(B=4, H=36, Hkv=4, T=16384, hd=128,
                               cur=[16383, 12000, 9000, 8192])),
        ("gemma hd=256 g=1", dict(B=4, H=16, Hkv=16, T=3000, hd=256,
                                  cur=[2999, 2000, 1000, 5])),
        ("ring W=1024 window=512", dict(B=4, H=36, Hkv=4, T=1024, hd=128,
                                        cur=[5000, 1500, 1023, 600],
                                        window=512, ring=True)),
        ("fully masked rows", dict(B=4, H=36, Hkv=4, T=4096, hd=128,
                                   cur=[3000, 100, 2000, 50], masked=True)),
    ]
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    failed = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, kw in flash_cases:
            args, opts = flash_case(dev, dtype, gen, **kw)
            got = fa.flash_attention(*args, **opts)
            want = ref.flash_attention_ref(*args, **opts)
            failed += report("flash_attention", label, dtype, got, want, errs)
        for label, kw in decode_cases:
            args, opts = decode_case(dev, dtype, gen, **kw)
            got = dec.decode_attention(*args, **opts)
            want = ref.decode_attention_ref(*args, **opts)
            failed += report("decode_attention", label, dtype, got, want,
                             errs)
    if failed:
        raise SystemExit(f"kernel check failed: {failed}")
    return errs


def report(name, label, dtype, got, want, errs):
    torch.cuda.synchronize()
    tol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool(torch.all(diff <= tol + tol * want.float().abs())) \
        and got.shape == want.shape and got.dtype == want.dtype
    errs[name] = max(errs[name], err)
    log(f"  {name:16s} {str(dtype)[6:]:8s} {label:30s} max_abs_err={err:.3e}"
        f" tol={tol:g} (atol=rtol) {'ok' if ok else 'FAIL'}")
    return [] if ok else [f"{name} {dtype} {label}"]


def time_kernels(dev, errs):
    """Each kernel at the served shapes (bf16): the kernel, its plain
    version, SDPA, and the bound computed from these inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = L2Flush(dev)
    rows = []

    # K2 at a 2000-token prompt, causal, positions 0..S-1
    B, H, Hkv, S, hd = 1, 36, 4, 2000, 128
    args, opts = flash_case(dev, dt, gen, B, H, Hkv, S, S, hd)
    q, k, v, qpos, kpos = args
    kept = S * (S + 1) // 2                       # causal (q, k) pairs
    flops = 4 * B * H * hd * kept                 # QK^T and PV
    nbytes = (2 * B * H * S * hd + 2 * B * Hkv * S * hd) * 2 + 2 * B * S * 4
    rows.append(dict(
        name="flash_attention", fn=lambda: fa.flash_attention(*args, **opts),
        plain=lambda: ref.flash_attention_ref(*args, **opts),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=opts["scale"], enable_gqa=True),
        flops=flops, bytes=nbytes,
        shape=f"B={B} H={H} Hkv={Hkv} S=T={S} hd={hd} bf16 causal",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:26"))

    # K1 at 4 slots of a 4096-slot cache filled to ragged lengths
    B, T = 4, 4096
    cur = [1999, 1499, 999, 499]
    dargs, dopts = decode_case(dev, dt, gen, B, H, Hkv, T, hd, cur)
    dq, dk, dv, dkpos, dcur = dargs
    kept = sum(c + 1 for c in cur)
    dflops = 4 * H * hd * kept
    dbytes = (2 * kept * Hkv * hd + 2 * B * H * hd) * 2 + B * T * 4 + B * 4
    mask = (dkpos >= 0) & (dkpos <= dcur[:, None])
    rows.append(dict(
        name="decode_attention",
        fn=lambda: dec.decode_attention(*dargs, **dopts),
        plain=lambda: ref.decode_attention_ref(*dargs, **dopts),
        library=lambda: F.scaled_dot_product_attention(
            dq[:, :, None], dk, dv, attn_mask=mask[:, None, None],
            scale=dopts["scale"], enable_gqa=True),
        flops=dflops, bytes=dbytes,
        shape=f"B={B} H={H} Hkv={Hkv} W={T} hd={hd} bf16 cur={cur}",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:23"))

    out = []
    for r in rows:
        t_kernel = time_ms(r["fn"], flush)
        t_plain = time_ms(r["plain"], flush)
        t_lib = time_ms(r["library"], flush)
        t_ops = r["flops"] / PEAK_FLOPS[dt] * 1e3
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        out.append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"], launches=None,
            max_abs_err=errs[r["name"]], ms=t_kernel, plain_ms=t_plain,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=t_lib, shape=r["shape"]))
        log(f"  {r['name']:16s} {r['shape']}: kernel {t_kernel:.4f} ms, "
            f"plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms, bound "
            f"{max(t_ops, t_bytes):.4f} ms ({out[-1]['bound_by']})")
    del flush
    return out


# ---------------------------------------------------------------- serving
def serve(dev):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_arch("starcoder2-7b")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {n_params / 1e9:.3f} B "
        f"params in {cfg.dtype}, init {time.perf_counter() - t0:.1f} s")

    eng = ServingEngine(cfg, params, max_batch=4, max_seq=4096,
                        scheduler="dpa", device=dev)
    reqs = make_requests(cfg, 8, max_new=32, prompt_len=(100, 2001))
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
    fa.LAUNCHES = dec.LAUNCHES = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.LAUNCHES,
                "decode_attention": dec.LAUNCHES}

    for r in reqs:
        log(f"  req {r.rid} [{r.tier}] prompt={len(r.prompt)} "
            f"ttft_step={r.ttft_step} done_step={r.done_step} "
            f"tokens={len(r.tokens)}")
    if any(r.done_step is None or len(r.tokens) != r.max_new_tokens
           for r in reqs):
        raise SystemExit("serve: a request did not finish")
    want = {"flash_attention": cfg.num_layers * stats["prefill_calls"],
            "decode_attention": cfg.num_layers * stats["decode_calls"]}
    log(f"  launches {launches}, expected {want} (prefill: one per layer "
        f"per admitted request; decode: one per layer per step)")
    if launches != want:
        raise SystemExit("serve: kernel launch counts do not match the "
                         "served work")
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
    log(f"  req {r.rid}: last decode logits vs full forward over {len(seq)} "
        f"tokens: rel L2 {rel:.3e} (tol {SERVE_LOGIT_TOL:g}), max abs "
        f"{mx:.3e} of max |logit| {float(ref_logits.abs().max()):.3f}, "
        f"argmax {int(got.argmax())} vs {int(ref_logits.argmax())}, "
        f"emitted {r.tokens[-1]}")
    if not (rel <= SERVE_LOGIT_TOL and torch.isfinite(got).all()):
        raise SystemExit("serve: decode logits disagree with the full "
                         "forward")
    return launches


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

    log("[kernels] kernel vs plain PyTorch version on the card")
    errs = check_kernels(dev)
    log("[kernels] timing at the served shapes (L2 flushed per launch)")
    rows = time_kernels(dev, errs)

    log("[serve] StarCoder2-7B, full width and depth, DPA, 8 requests")
    launches = serve(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            raise SystemExit(f"{row['name']} never launched on the served "
                             f"path")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
