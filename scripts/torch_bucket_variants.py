#!/usr/bin/env python3
"""Where the bucket step's time goes on the card: ablations of its kernel.

    python3 scripts/torch_bucket_variants.py [--sass FILE] [--baseline NAME=FILE ...]

Run from the repository root on a machine with one CUDA device and
``nvcc``.  Builds variants of ``src/repro_torch/kernels/csrc/bucket_step.cu``
into ``build/bucket_variants/`` (text edits of the source or an extra
compiler flag, never used by the port) and times each at seeded
240-bucket segments (``bucket_step.synthetic_case``, every mode) of the
vector engine's two fleets, 4 models x 1 pool x 3 regions (unified) for
1 and 8 replicas and 4 models x 2 pools x 3 regions (siloed) for 1,
twice, with ``chip_smoke.time_ms`` (CUDA events, L2 flushed):

- ``base``: the kernel as it is (also timed at a 1-bucket segment, the
  launch's fixed cost: loading the carry and writing it back);
- ``no_ring_sum``: the ring's warp-order sum over its rows (the ring's
  warp's work) replaced by one read;
- ``no_ys``: the per-bucket outputs staged in shared memory and never
  written out;
- ``no_prefetch``: each bucket waits for its own inputs (the copy of
  the next bucket's inputs is waited for at once);
- ``unpadded``: the ring's rows C*J words apart (bank conflicts in the
  sum);
- ``fast_div``: built with ``-prec-div=false`` (the rare fallback of
  the kernel's own division made approximate);
- ``ring6``: 6 warps sum the ring instead of 3;
- ``ring_w0_free``: the first ring warp, which also writes the outputs
  out, sums no columns;
- with ``--baseline NAME=FILE`` (repeatable), other versions of the
  source (say, a parent commit's ``bucket_step.cu``) timed in the same
  call under NAME.

Each line says whether the variant still equals the plain version
(``ref.bucket_segment_ref``); those that drop or change work do not.
``--sass FILE`` writes ``cuobjdump -sass`` of the base build to FILE.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, bucket_step, ref  # noqa: E402

OUT = ROOT / "build" / "bucket_variants"


def variants(src: str) -> dict:
    """name: (source, extra nvcc flags)."""
    def edit(text, old, new):
        if old not in text:
            raise SystemExit(f"variant edit not found: {old[:60]!r}")
        return text.replace(old, new)

    return {
        "base": (src, ()),
        "no_ring_sum": (edit(
            src, "      for (int base = rw * RB; base < CJ;",
            "      for (int q = lane; q < CJ; q += 32) pPD[q] = ring[q];\n"
            "      for (int base = rw * RB; base < 0;"), ()),
        "no_ys": (edit(
            src, "for (int q = lane; q < lay.Y; q += 32) gy[q] = yb[q];",
            ""), ()),
        "no_prefetch": (edit(
            src, "      for (int q = lane; q < X; q += 32) copy_async4(nx + q,"
            " gx + q);\n",
            "      for (int q = lane; q < X; q += 32) copy_async4(nx + q,"
            " gx + q);\n      copy_async_wait();\n"), ()),
        "unpadded": (edit(src, "const int X = lay.X, S = plan.stride;",
                          "const int X = lay.X, S = CJ;"), ()),
        "fast_div": (src, ("-prec-div=false",)),
        "ring6": (edit(src, "constexpr int RING_WARPS = 3;",
                       "constexpr int RING_WARPS = 6;"), ()),
        "ring_w0_free": (edit(
            src, "      for (int base = rw * RB; base < CJ; base += "
            "RING_WARPS * RB) {",
            "      for (int base = (rw - 1) * RB; rw > 0 && base < CJ;"
            " base += (RING_WARPS - 1) * RB) {"), ()),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", type=Path, default=None)
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="NAME=FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bucket_variants: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "bucket_step.cu").read_text()
    procs = []
    todo = variants(src)
    for spec in args.baseline:
        name, _, path = spec.partition("=")
        todo[name] = (Path(path).read_text(), ())
    for name, (text, extra) in todo.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs.append((name, subprocess.Popen(
            [_build._nvcc(), *_build._flags("bucket_step"), *extra, "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(f"{name}: registers {re.findall(r'Used (\d+) registers', log)}")
        built.append(name)
    if args.sass is not None:
        tool = shutil.which("cuobjdump") or str(
            Path(_build._nvcc()).with_name("cuobjdump"))
        args.sass.parent.mkdir(parents=True, exist_ok=True)
        with open(args.sass, "w") as f:
            subprocess.run([tool, "-sass", str(OUT / "base.so")], stdout=f,
                           check=True)
        print(f"SASS of the base build in {args.sass}")

    dev = torch.device("cuda", 0)
    cases = {"unified": cs.bucket_case(dev, seed=3, modes="all"),
             "siloed": cs.bucket_case(dev, seed=4, modes="all", P=2)}
    flush = cs.L2Flush(dev)
    fns = {}
    for name in built:
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).bucket_segment
        fn.argtypes = ([bucket_step.Layout] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    shapes = [(name, fleet, reps, 240) for name in built
              for fleet, reps in (("unified", 1), ("unified", 8),
                                  ("siloed", 1))]
    shapes.append(("base", "unified", 1, 1))
    wants = {}
    for rnd in range(2):
        for name, fleet, reps, nb in shapes:
            lay, consts, prm, carry, xs, b0, b1 = cases[fleet]
            idx = torch.arange(reps, device=dev) % prm.shape[0]
            p, c = prm[idx].contiguous(), carry[idx].contiguous()
            x = xs[:nb].contiguous()
            if (fleet, reps, nb) not in wants:
                wants[fleet, reps, nb] = ref.bucket_segment_ref(
                    lay, consts, p[:1], c[:1], x, b0, b0 + nb)
            want = wants[fleet, reps, nb]
            out = torch.empty_like(c)
            ys = torch.empty((reps, nb, lay.Y), device=dev)

            def call(fn=fns[name]):
                err = fn(bucket_step.c_layout(lay), consts.data_ptr(),
                         p.data_ptr(), c.data_ptr(), out.data_ptr(),
                         x.data_ptr(), ys.data_ptr(), reps, b0, nb,
                         torch.cuda.current_stream().cuda_stream)
                _build.check(err, name)

            call()
            torch.cuda.synchronize()
            same = (torch.equal(out[:1], want[0])
                    and torch.equal(ys[:1], want[1]))
            t = cs.time_ms(call, flush, reps=10)
            print(f"round {rnd} {name:12s} {fleet:7s} R={reps} {nb:3d} "
                  f"buckets: "
                  f"{t:.4f} ms ({t / nb * 1e3:.2f} us a bucket), equal to "
                  f"plain: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
