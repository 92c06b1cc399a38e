"""Collective bytes of one placed dry-run case, by the call site that moved them.

    PYTHONPATH=src python scripts/torch_collective_sites.py ARCH SHAPE [--mesh 16x16|2x16x16|2x4] [--top 20]

Runs ARCH x SHAPE placed on a fake process group (meta tensors, nothing
allocated) with the step counter's collectives attributed to the
innermost frames of ``repro_torch`` that issued them, and prints the
case's total, then the sites by bytes: which op's placement makes a
case's collective term.  On 16x16 and 2x16x16 the case is
``launch.dryrun.run_case``'s at full size; ``2x4`` is the reduced fp32
case that ``tests/test_torch_placement.py`` (b) holds to XLA (SHAPE is
then the mode, train, prefill or decode, at B 8 x S 64).  DTensor
chooses the collectives, so the breakdown depends on the torch version
(printed).
"""
import argparse
import collections
import contextlib
import dataclasses
import traceback

import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group, make_mesh


@contextlib.contextmanager
def by_site():
    """{(collective, call site): bytes} of the counts taken inside."""
    sites = collections.Counter()
    count = dryrun.StepCounter.__torch_dispatch__

    def attributed(self, func, types, args=(), kwargs=None):
        before = sum(self.collectives.values())
        out = count(self, func, types, args, kwargs)
        moved = sum(self.collectives.values()) - before
        if moved:
            frames = [f for f in traceback.extract_stack()
                      if "repro_torch" in f.filename
                      and "launch/dryrun" not in f.filename][-3:]
            where = " <- ".join(
                f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
                for f in reversed(frames))
            sites[func.overloadpacket.__name__, where] += moved
        return out

    dryrun.StepCounter.__torch_dispatch__ = attributed
    try:
        yield sites
    finally:
        dryrun.StepCounter.__torch_dispatch__ = count


def reduced_case(arch: str, mode: str) -> int:
    """The (2, 4) case of ``tests/torch_placement_worker.py``'s counts:
    its collective bytes a device."""
    with fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                                  dtype="float32")
        shape = ShapeConfig(f"{mode}_small", 64, 8, mode)
        rules = dryrun.rules_for(cfg, shape, 4)
        case = dryrun.build_case(cfg, shape, mesh=mesh, rules=rules)
        return sum(dryrun.count(case.fn).collectives.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--mesh", default="16x16",
                    choices=("16x16", "2x16x16", "2x4"))
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    with by_site() as sites:
        if args.mesh == "2x4":
            total = reduced_case(args.arch, args.shape)
        else:
            total = dryrun.run_case(args.arch, args.shape, mesh=args.mesh)[
                "collective_bytes_per_device"]
    print(f"torch {torch.__version__}: {total:,} collective bytes a "
          f"device, by site")
    for (op, where), moved in sites.most_common(args.top):
        print(f"  {moved:>16,} {moved / total:6.3f} {op:24s} {where}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
