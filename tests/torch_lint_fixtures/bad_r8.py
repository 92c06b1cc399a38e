"""R8 fixture: torch/CUDA hazards, one per marked line.

Never imported — parsed only by reprolint in tests/test_torch_analysis.py.
"""
import ctypes
import functools

import torch
from torch import cuda

from repro_torch.kernels import _build

step = torch.compile(lambda y: y + 1)  # ok: built once, at module level


def host_syncs(xs):
    total, n, h = 0.0, 0, None
    for x in xs:
        total += x.sum().item()  # R8-VIOLATION-ITEM
        h = x.cpu()  # R8-VIOLATION-CPU
        torch.cuda.synchronize()  # R8-VIOLATION-SYNC
        cuda.synchronize()  # R8-VIOLATION-ALIASED-SYNC
        n += int(torch.count_nonzero(x))  # R8-VIOLATION-INT
    while total > 0:
        total -= float(torch.linalg.norm(h))  # R8-VIOLATION-FLOAT
    return total, n


def once(x):
    return x.sum().item()  # ok: not inside a loop


def compiled(x):
    fn = torch.compile(lambda y: y * 2)  # R8-VIOLATION-COMPILE
    return fn(x)


def scripted(f):
    return torch.jit.script(f)  # R8-VIOLATION-SCRIPT


def captured():
    graph = torch.cuda.CUDAGraph()  # R8-VIOLATION-GRAPH
    return graph


class Runner:
    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()  # ok: one per instance


def kernel():
    return _build.load("bucket_step")  # R8-VIOLATION-LOAD


def library(path):
    return ctypes.CDLL(path)  # R8-VIOLATION-CDLL


@functools.lru_cache(maxsize=None)
def cached_kernel():
    return _build.load("arma_fit")  # ok: cached


@functools.cache
def cached_library(path):
    return ctypes.CDLL(path)  # ok: cached


def suppressed(xs):
    for x in xs:
        # reprolint: disable=R8 -- fixture: one read a batch is the point
        x.item()  # R8-SUPPRESSED
