"""R8 fixture: a measurement path (``launch/``), allowlisted.

Never imported — parsed only by reprolint in tests/test_torch_analysis.py.
"""
import torch


def timed(xs):
    for x in xs:
        torch.cuda.synchronize()  # ok: a measurement syncs on purpose
        x.item()  # ok: allowlisted path
