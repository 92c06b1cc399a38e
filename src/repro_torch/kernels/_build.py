"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own, for Hopper only, into ``build/torch_kernels/`` under the
repository root::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/<name>-<hash>.so <name>.cu

(``SOURCE_FLAGS`` adds flags for one source: ``--fmad=false`` for the
bucket step.)  The file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  A file with a
plain C interface builds in seconds, where one that includes PyTorch's
headers takes minutes.  ``build_all`` starts one ``nvcc`` per source,
all at once.

Every C entry point takes its pointers and the stream as ``void*``
(``ctypes.c_void_p``) and returns ``cudaGetLastError()`` after its
launches; :func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "decode_attention", "ssd_scan", "arma_fit",
           "bucket_step")
#: flags of one source beside ``NVCC_FLAGS``: the bucket step must round
#: every multiply and add apart, as its plain version does
SOURCE_FLAGS = {"bucket_step": ("--fmad=false",)}
#: input types the kernels take, and their code in the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _flags(name: str):
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source not yet built, one nvcc each, in parallel.

    Returns each built source's compiler output (register and shared
    memory use from ``-Xptxas -v``); raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs: Dict[str, str] = {}
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


INT64_PTR = ctypes.POINTER(ctypes.c_longlong)


def int64s(values) -> ctypes.Array:
    """A host array of int64 (shapes and strides, passed as INT64_PTR)."""
    vals = [int(v) for v in values]
    return (ctypes.c_longlong * len(vals))(*vals)


def check_qkv(kernel: str, head_dims, **tensors: torch.Tensor) -> None:
    """Raise unless the tensors are what the attention kernels read: on a
    CUDA device, one dtype of ``DTYPES``, one head dimension out of
    ``head_dims``, unit-stride along it, and every row starting on a
    16-byte boundary (rows are read as 16-byte vectors)."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel} kernel: {name} is on {t.device}, "
                             f"not a CUDA device")
        if t.dtype != first.dtype or t.dtype not in DTYPES:
            raise ValueError(f"{kernel} kernel: {name} has dtype {t.dtype};"
                             f" all must be float32 or bfloat16, alike")
        if t.shape[-1] != first.shape[-1] or t.shape[-1] not in head_dims:
            raise ValueError(f"{kernel} kernel: {name} has head_dim "
                             f"{t.shape[-1]}; supported: {head_dims}, "
                             f"equal for all")
        size = t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (st * size) % 16 for n, st in zip(t.shape[:-1], t.stride())
                if n > 1):
            raise ValueError(f"{kernel} kernel: {name} must have a "
                             f"unit-stride head dimension and 16-byte "
                             f"aligned rows (strides {t.stride()})")
