"""R8 fixture: a module that does not import torch is out of R8's scope.

Never imported — parsed only by reprolint in tests/test_torch_analysis.py.
"""


def host_values(xs):
    return [x.item() for x in xs if x.cpu() is not None]


def loop(xs):
    out = 0.0
    for x in xs:
        out += x.item()  # ok: no torch import here
    return out
