#!/usr/bin/env python3
"""K2's bf16 forward at ``chip_smoke.py``'s ``flash_row`` shapes beside SDPA, for a checkout and for other versions of its kernel source (one CUDA device).

    python3 scripts/torch_flash_fwd_times.py [--tree DIR] [--baseline NAME=FILE ...]
        [--reps 20] [--sass]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` of ``DIR`` (by
default the checkout this script lies in), and once per ``--baseline
NAME=FILE`` another version of that source (say the parent commit's, or
a copy with an alternative design compiled in; its headers sit beside
it) into ``DIR/build/``, all at once.  Prints each build's registers and
spill stores per wgmma kernel (``chip_smoke.kernel_resources``; with
``--sass`` also counts of some SASS instructions in each, from
``cuobjdump``) and checks each build against the plain version
(``ref.flash_attention_lse_ref``: output and lse at bf16's 3e-2) at edge
cases of the widths above a padded 128.  Then times ``flash_attention``
of every build in turns with ``chip_smoke.time_ms`` (CUDA events, the
L2 flushed before each launch) at each shape, beside
``scaled_dot_product_attention`` (timed only; the port never calls it)
and the bound computed as ``chip_smoke.time_kernels`` does.  Baselines
need a tree whose wrapper has ``entry_point``.  Two trees timed in turns
in one call (parent, change, change, parent) compare two versions on one
card.  Exits 1 if a build disagrees with the plain version.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

#: (label, B, H, Hkv, S, T, hd, vd, causal): chip_smoke.time_kernels'
#: flash_row shapes
SHAPES = (
    ("starcoder2-7b", 1, 36, 4, 2000, 2000, 128, None, True),
    ("zamba2-7b", 1, 32, 32, 2000, 2000, 112, None, True),
    ("llama4-scout-17b-a16e", 1, 40, 8, 2000, 2000, 128, None, True),
    ("deepseek-v3-671b MLA", 1, 128, 128, 2000, 2000, 192, 128, True),
    ("pixtral-12b", 1, 32, 8, 2004, 2004, 128, None, True),
    ("whisper-tiny encoder", 1, 6, 6, 1500, 1500, 64, None, False),
    ("whisper-tiny cross", 1, 6, 6, 2000, 1500, 64, None, False),
    ("stablelm-12b", 1, 32, 8, 2048, 2048, 160, None, True),
    ("gemma-7b", 1, 16, 16, 2048, 2048, 256, None, True),
)
#: (hd, vd) above a padded 128, and the edge cases each build is held to
WIDE = ((160, None), (192, None), (192, 128), (256, None))
CHECKS = (
    dict(B=1, H=8, Hkv=8, S=97, T=97),
    dict(B=2, H=8, Hkv=2, S=200, T=333),
    dict(B=2, H=10, Hkv=2, S=90, T=90, window=16, masked=True),
    dict(B=1, H=6, Hkv=6, S=70, T=150, causal=False),
    dict(B=1, H=4, Hkv=4, S=31, T=31),
    dict(B=1, H=8, Hkv=2, S=1000, T=1000),
)
TOL = 3e-2


def build(tree: Path, name: str, source: Path, ab):
    """Start nvcc on ``source`` with the tree's flags into
    ``tree/build/flash_fwd_variants/<name>.so``."""
    out = tree / "build" / "flash_fwd_variants" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [ab._nvcc(), *ab.NVCC_FLAGS, "-o", str(out), str(source)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def resources(name: str, log: str, cs) -> None:
    found, serial = cs.kernel_resources(log)
    print(f"  {name}: " + ", ".join(
        f"{k}<{d}> {r} registers, {n} bytes spilled"
        for k, d, r, n in found)
        + "".join(f"; wgmma serialized in {s}" for s in serial), flush=True)


#: SASS instructions counted per wgmma kernel with ``--sass``
SASS_OPS = ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "BAR.SYNC",
            "BAR.ARV", "MUFU.EX2", "LDL", "STL")


def sass(name: str, lib: Path, ab, cs) -> None:
    """Count SASS_OPS in each wgmma kernel of a built library
    (``cuobjdump -sass``)."""
    tool = Path(ab._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], text=True,
                          capture_output=True).stdout
    for fn, body in re.findall(r"Function : (\S+)\n([\s\S]*?)(?=Function :|\Z)",
                               text):
        if not re.search(rf"({'|'.join(cs.WGMMA_KERNELS)})I", fn):
            continue
        k = re.search(r"(flash_\w+?)I((?:Li\d+E)+)", fn)
        label = f"{k[1]}<{','.join(re.findall(r'[0-9]+', k[2]))}>" if k \
            else fn[:60]
        counts = {op: len(re.findall(rf"\b{re.escape(op)}\b", body))
                  for op in SASS_OPS}
        print(f"  {name} sass {label}: "
              + ", ".join(f"{op} {n}" for op, n in counts.items())
              + f", {len(re.findall(r'/\*[0-9a-f]{4,}\*/', body))} "
              "instructions", flush=True)


def check(cs, fa, ref, dev) -> float:
    """The largest gap to the plain version over the wide edge cases
    (output and lse of kept rows); inf if a row's kept-ness differs."""
    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(7)
    for hd, vd in WIDE:
        for kw in CHECKS:
            args, opts = cs.flash_case(dev, torch.bfloat16, gen, hd=hd,
                                       vd=vd, **kw)
            out, lse = fa.flash_attention(*args, return_lse=True, **opts)
            want, wlse = ref.flash_attention_lse_ref(*args, **opts)
            dead = wlse <= 0.5 * ref.NEG_INF
            if not torch.equal(lse <= 0.5 * ref.NEG_INF, dead):
                return float("inf")
            worst = max(worst, (out.float() - want.float()).abs().max().item(),
                        (lse - wlse)[~dead].abs().max().item()
                        if (~dead).any() else 0.0)
    torch.cuda.synchronize()
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="NAME=FILE",
                    help="another version of flash_attention.cu (say the "
                         "parent commit's), built and timed beside")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="count SASS instructions of each wgmma kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_fwd_times: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    # the tree's package first: chip_smoke's own src comes after it
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build as ab
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    print(f"{cs.smi_line()} | tree {tree}", flush=True)
    procs = {n: build(tree, n, Path(f).resolve(), ab)
             for n, f in (b.split("=", 1) for b in args.baseline)}
    logs = ab.build_all(["flash_attention"])
    resources("base", logs.get("flash_attention", ""), cs)
    fns = {"base": fa._fn()}
    if args.sass:
        sass("base", ab._target("flash_attention"), ab, cs)
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"  {name}: nvcc failed\n{log}", flush=True)
            return 1
        resources(name, log, cs)
        fns[name] = fa.entry_point(ctypes.CDLL(str(out)))
        if args.sass:
            sass(name, out, ab, cs)
    ok = True
    for name, fn in fns.items():
        fa._fn = lambda fn=fn: fn
        err = check(cs, fa, ref, dev)
        ok &= err <= TOL
        print(f"  {name}: wide edge cases vs plain, max abs err {err:.3e} "
              f"({'ok' if err <= TOL else 'FAILED'}, tol {TOL})", flush=True)

    import torch.nn.functional as F
    flush = cs.L2Flush(dev)
    bf16 = torch.bfloat16
    for label, B, H, Hkv, S, T, hd, vd, causal in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(1)
        (q, k, v, qpos, kpos), opts = cs.flash_case(
            dev, bf16, gen, B, H, Hkv, S, T, hd, causal=causal, vd=vd)
        w = vd or hd
        kept = S * (S + 1) // 2 if causal else S * T
        bound = 2 * B * H * (hd + w) * kept / cs.PEAK_FLOPS[bf16] * 1e3
        times = []
        for name, fn in fns.items():
            fa._fn = lambda fn=fn: fn
            ms = cs.time_ms(lambda: fa.flash_attention(q, k, v, qpos, kpos,
                                                       **opts),
                            flush, reps=args.reps)
            times.append(f"{name} {ms:.4f}")
        sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=opts["scale"], enable_gqa=True),
            flush, reps=args.reps)
        print(f"  {label}: B={B} H={H} Hkv={Hkv} S={S} T={T} hd={hd}"
              + (f" V {vd}" if vd else "") + ": " + ", ".join(times)
              + f" ms; SDPA {sdpa:.4f} ms; bound {bound:.4f} ms",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
