"""Collective bytes, or product FLOPs, of one placed dry-run case, by site.

    PYTHONPATH=src python scripts/torch_collective_sites.py ARCH SHAPE [--mesh 16x16|2x16x16|2x4] [--flops] [--heads H] [--top 20]

Runs ARCH x SHAPE placed on a fake process group (meta tensors, nothing
allocated) with the step counter's collectives (or, with ``--flops``,
its matrix-product FLOPs) attributed to the frames of ``repro_torch``
that issued them (``launch.dryrun.site``: in a backward, the frames
that run it, then "backward of" and the forward op's), and prints the
case's total, then the sites by amount, each with its innermost frames:
which op's placement makes a case's collective term or its FLOPs.  On
16x16 and 2x16x16 the case is ``launch.dryrun.run_case``'s at full
size; ``2x4`` is the reduced fp32 case that
``tests/test_torch_placement.py`` (b) holds to XLA (SHAPE is then the
mode, train, prefill or decode, at B 8 x S 64; ``--heads`` sets the
query and kv heads, e.g. Whisper-tiny's 6, where head_dim is split).
DTensor chooses the collectives of the ops the port leaves to it, so
the breakdown may depend on the torch version (printed).
"""
import argparse
import collections
import dataclasses

import torch

from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group, make_mesh

#: frames shown a site, on each side of "backward of"
DEPTH = 3


def reduced_case(arch: str, mode: str, heads=None) -> dryrun.StepCounter:
    """The counts, by site, of the (2, 4) case of
    ``tests/torch_placement_worker.py``."""
    with fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                                  dtype="float32")
        if heads:
            cfg = dataclasses.replace(cfg, num_heads=heads,
                                      num_kv_heads=heads)
        shape = ShapeConfig(f"{mode}_small", 64, 8, mode)
        rules = dryrun.rules_for(cfg, shape, 4)
        case = dryrun.build_case(cfg, shape, mesh=mesh, rules=rules)
        return dryrun.count(case.fn, sites=True)


def where(frames) -> str:
    """A site's innermost frames on each side of "backward of"."""
    if dryrun.BACKWARD_OF not in frames:
        return " <- ".join(frames[:DEPTH]) or "(no frame)"
    cut = frames.index(dryrun.BACKWARD_OF)
    return (" <- ".join(frames[:cut][:DEPTH]) or "(DTensor)") + \
        " | backward of " + " <- ".join(frames[cut + 1:][:DEPTH])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--mesh", default="16x16",
                    choices=("16x16", "2x16x16", "2x4"))
    ap.add_argument("--flops", action="store_true")
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    if args.mesh == "2x4":
        c = reduced_case(args.arch, args.shape, args.heads)
        flops, coll, by_site = c.flops, sum(c.collectives.values()), c.sites
    else:
        if args.heads:
            ap.error("--heads takes the 2x4 case only")
        r = dryrun.run_case(args.arch, args.shape, mesh=args.mesh,
                            sites=True)
        flops, coll, by_site = (r["flops_per_device"],
                                r["collective_bytes_per_device"], r["sites"])
    sites = collections.Counter()
    for (what, frames), n in by_site.items():
        if (what == "flops") == args.flops:
            sites[what, where(frames)] += n
    total = flops if args.flops else coll
    unit = "FLOPs" if args.flops else "collective bytes"
    print(f"torch {torch.__version__}: {total:,} {unit} a device, by site")
    for (what, at), n in sites.most_common(args.top):
        print(f"  {n:>18,} {n / total:6.3f} {what:14s} {at}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
