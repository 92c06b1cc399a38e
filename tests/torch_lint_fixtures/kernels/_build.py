"""R8 fixture: the kernels' build module, whose ``load`` owns the library cache.

Never imported — parsed only by reprolint in tests/test_torch_analysis.py.
"""
import ctypes

import torch

_LIBS = {}
DTYPES = {torch.float32: 0}


def load(name):
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(name)  # ok: load owns the _LIBS cache
        _LIBS[name] = lib
    return lib


def reload(name):
    return ctypes.CDLL(name)  # R8-VIOLATION-UNCACHED
