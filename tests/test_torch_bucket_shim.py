"""The bucket step's CUDA kernel body on the CPU, against its plain version, bit for bit.

``src/repro_torch/kernels/csrc/bucket_step.cu`` is compiled with the
host's g++ (C++20, ``-ffp-contract=off``: no fused multiply-add, as
nvcc's ``--fmad=false``) under ``tests/cuda_shim.h``, which runs each
CUDA thread as a ``std::thread`` with a ``std::barrier`` for
``__syncwarp`` and per-warp slots for the shuffles
(``tests/bucket_step_shim.cpp`` is the launcher).  Its output on the
seeded edge cases of ``chip_smoke.py``'s ``BUCKET_CASES``
(``bucket_step.synthetic_case``, cut to a few buckets for time; a
segment that wraps the ring still wraps), and on J = 2, 4 and 8, so
that every J the launcher specialises is run must equal
``ref.bucket_segment_ref``'s bit for bit, carry and outputs.  So the
kernel's arithmetic order is held here on every run of the tests, and on
the card by ``chip_smoke.py``.  Skipped only where there is no g++.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import bucket_step as tbs
from repro_torch.kernels import ref as tref

HERE = Path(__file__).resolve().parent
EVERY = tuple(tbs.MODES)
#: chip_smoke.py's BUCKET_CASES (synthetic_case arguments; b0 where the
#: segment starts), at BUCKETS buckets unless a case says otherwise
BUCKETS = 8
CASES = {
    "R=1, one bucket": dict(seed=1, modes=("lt-ua",), buckets=1),
    "R=1, reactive": dict(seed=2, modes=("reactive",)),
    "R=5, every mode, unified": dict(seed=3, modes=EVERY),
    "R=5, every mode, siloed": dict(seed=4, modes=EVERY, P=2),
    "R=8, C*J=48 (8 models x 2 pools)": dict(
        seed=5, modes=EVERY + ("reactive", "lt-ua", "chiron"), M=8, P=2),
    "ring collision": dict(seed=6, modes=EVERY, collide=True),
    "region down": dict(seed=7, modes=EVERY, down=True),
    "dead model past its budget": dict(seed=8, modes=EVERY, dead=True),
    "no plan rows": dict(seed=9, modes=EVERY, plan=False),
    "wraps the ring": dict(seed=10, modes=EVERY, b0=3 * 481 - 4),
    "J=1": dict(seed=11, modes=EVERY, J=1),
    "J=2": dict(seed=16, modes=EVERY, J=2),
    "J=4": dict(seed=17, modes=EVERY, J=4),
    "J=5": dict(seed=12, modes=EVERY, J=5),
    "J=8": dict(seed=18, modes=EVERY, M=3, J=8),
    "J=6 (J at run time)": dict(seed=13, modes=EVERY, M=2, J=6),
    "C*J=72 (8 models x 3 pools)": dict(seed=14, modes=EVERY, M=8, P=3),
    "L=96 (whole chunks of 32 rows)": dict(seed=19, modes=EVERY, L=96),
    "C*J=144 (16 models x 3 pools, 32 cells a lane), L=121": dict(
        seed=15, modes=("lt-ua", "chiron"), M=16, P=3, L=121, buckets=4),
    "C*J=330, outputs not staged in shared memory, L=121": dict(
        seed=20, modes=("lt-ua",), M=110, L=121, buckets=3),
}


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine")
    exe = tmp_path_factory.mktemp("bucket_shim") / "bucket_step_shim"
    subprocess.run([gxx, "-std=c++20", "-O0", "-ffp-contract=off",
                    "-pthread", "-include", str(HERE / "cuda_shim.h"),
                    "-o", str(exe), str(HERE / "bucket_step_shim.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    return exe


def run_shim(exe, lay, consts, prm, carry, xs, b0):
    """The kernel under the shim: (carry (R, F), ys (R, nb, Y))."""
    R, nb = carry.shape[0], xs.shape[0]
    work = exe.parent
    blob = (bytes(tbs.c_layout(lay))
            + np.asarray([R, b0, nb], np.int32).tobytes()
            + b"".join(np.ascontiguousarray(a, np.float32).tobytes()
                       for a in (consts, prm, carry, xs)))
    (work / "in.bin").write_bytes(blob)
    subprocess.run([str(exe), str(work / "in.bin"), str(work / "out.bin")],
                   check=True, timeout=600)
    got = np.fromfile(work / "out.bin", np.float32)
    assert got.size == R * lay.F + R * nb * lay.Y
    return (got[:R * lay.F].reshape(R, lay.F),
            got[R * lay.F:].reshape(R, nb, lay.Y))


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_body_matches_plain_bit_for_bit(shim, case):
    kw = dict(CASES[case])
    b0 = kw.pop("b0", 0)
    kw.setdefault("buckets", BUCKETS)
    lay, consts, prm, carry, xs = tbs.synthetic_case(**kw)
    tbs.check_args(lay, *map(torch.from_numpy, (consts, prm, carry, xs)),
                   b0, b0 + xs.shape[0])
    got_c, got_y = run_shim(shim, lay, consts, prm, carry, xs, b0)
    want_c, want_y = tref.bucket_segment_ref(
        lay, *map(torch.from_numpy, (consts, prm, carry, xs)), b0,
        b0 + xs.shape[0])
    assert np.isfinite(got_y).all()
    np.testing.assert_array_equal(got_c.view(np.uint32),
                                  want_c.numpy().view(np.uint32))
    np.testing.assert_array_equal(got_y.view(np.uint32),
                                  want_y.numpy().view(np.uint32))
