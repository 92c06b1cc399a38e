#!/usr/bin/env python3
"""Where the bucket step's time goes on the card: timing variants of its kernel.

    python3 scripts/torch_bucket_variants.py

Run from the repository root on a machine with one CUDA device and
``nvcc``.  Builds variants of ``src/repro_torch/kernels/csrc/bucket_step.cu``
into ``build/bucket_variants/`` (text edits of the source, never used
by the port) and times each at a seeded 240-bucket segment
(``bucket_step.synthetic_case``, 4 models x 1 pool x 3 regions, every
mode) for 1 and 8 replicas, twice, with ``chip_smoke.time_ms`` (CUDA
events, L2 flushed):

- ``base``: the kernel as it is;
- ``xs_in_smem``: each bucket's inputs staged in shared memory first;
- ``no_ring_sum``: the ring's 481-row warp sum replaced by one read;
- ``nt128``: 128 threads a block instead of 256;
- ``no_ys``: the per-bucket outputs written to shared memory only.

Each line says whether the variant still equals the plain version
(``ref.bucket_segment_ref``); the ones that drop work do not.
"""
from __future__ import annotations

import ctypes
import re
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
    def edit(text, old, new):
        if old not in text:
            raise SystemExit(f"variant edit not found: {old[:60]!r}")
        return text.replace(old, new)

    stage = edit(src, "float* SREL2O = SREL2P + C;         // [C]",
                 "float* SREL2O = SREL2P + C;         // [C]\n"
                 "  float* XS = SREL2O + C;")
    stage = edit(stage, "const float* x = g_xs + (size_t)s * lay.X;",
                 "for (int i = tid; i < lay.X; i += NT)\n"
                 "      XS[i] = g_xs[(size_t)s * lay.X + i];\n"
                 "    __syncthreads();\n"
                 "    const float* x = XS;")
    stage = edit(stage, "l.M + 3LL * l.C;", "l.M + 3LL * l.C + l.X;")
    return {
        "base": src,
        "xs_in_smem": stage,
        "no_ring_sum": edit(src, """      const float pend =
          lane_sum(L, lane, [&](int r) { return ring[r * CJ + i]; });""",
                            "      const float pend = ring[lane * CJ + i];"),
        "nt128": edit(src, "constexpr int NT = 256;",
                      "constexpr int NT = 128;"),
        "no_ys": edit(src,
                      "float* y = g_ys + ((size_t)rep * nb + s) * lay.Y;",
                      "__shared__ float ydump[4096];\n    float* y = ydump;"),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bucket_variants: no CUDA device", file=sys.stderr)
        return 1
    print(cs.smi_line(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "bucket_step.cu").read_text()
    procs = []
    for name, text in variants(src).items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs.append((name, subprocess.Popen(
            [_build._nvcc(), *_build._flags("bucket_step"), "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(f"{name}: {re.findall(r'Used \d+ registers', log)}")
        built.append(name)

    dev = torch.device("cuda", 0)
    lay, consts, prm, carry, xs, b0, b1 = cs.bucket_case(dev, seed=3,
                                                         modes="all")
    want = ref.bucket_segment_ref(lay, consts, prm[:1], carry[:1], xs, b0,
                                  b1)
    flush = cs.L2Flush(dev)
    for rnd in range(2):
        for name in built:
            fn = ctypes.CDLL(str(OUT / f"{name}.so")).bucket_segment
            fn.argtypes = ([bucket_step.Layout] + [ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            for reps in (1, 8):
                idx = torch.arange(reps, device=dev) % prm.shape[0]
                p, c = prm[idx].contiguous(), carry[idx].contiguous()
                out = torch.empty_like(c)
                ys = torch.empty((reps, b1 - b0, lay.Y), device=dev)

                def call():
                    err = fn(bucket_step.c_layout(lay), consts.data_ptr(),
                             p.data_ptr(), c.data_ptr(), out.data_ptr(),
                             xs.data_ptr(), ys.data_ptr(), reps, b0,
                             b1 - b0,
                             torch.cuda.current_stream().cuda_stream)
                    _build.check(err, name)

                call()
                torch.cuda.synchronize()
                same = (torch.equal(out[:1], want[0])
                        and torch.equal(ys[:1], want[1]))
                t = cs.time_ms(call, flush, reps=5)
                print(f"round {rnd} {name:12s} R={reps}: {t:.4f} ms a "
                      f"{b1 - b0}-bucket segment ({t / (b1 - b0) * 1e3:.2f} "
                      f"us a bucket), equal to plain: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
