"""Placement runs that need a process group, each in a process of its own.

    python tests/torch_placement_worker.py gloo OUT.json
    python tests/torch_placement_worker.py fake OUT.json
    python tests/torch_placement_worker.py dryrun OUT.json
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tests/torch_placement_worker.py xla OUT.json

``tests/test_torch_placement.py`` starts each in a subprocess, so that
no test worker inherits process-group or XLA device state, and reads
OUT.json:

- ``gloo``: 4 CPU processes on a (2, 2) ("data", "model") mesh over
  gloo, real collectives.  For each family's reduced fp32 config, the
  placed forward (serve rules), one placed train step (train rules) and
  one placed decode step against a prefilled cache (serve rules), each
  against the same step unplaced in the same process, from the same
  seeded weights and inputs, and the pairs each step drops at capacity
  (``moe.DROPPED``); the MoE families again with the decode step on the
  dispatch (``MOE_DECODE_DISPATCH``) and a capacity that drops pairs
  (``DROPPING_CAPACITY``), with the experts whose pairs come from both
  data ranks and are dropped.  Rank 0 writes the differences.
- ``fake``: fake groups of 256, 512 and 8 ranks: every parameter of the
  10 architectures at full size on meta, placed by the train rules on
  16x16 and 2x16x16, DTensor's local shape on rank 0 and on the last
  rank beside ``dist.sharding.local_shape``; the port's per-device
  counts of the 7 families' reduced fp32 steps on a (2, 4) mesh; and
  the largest local tensor inside the MoE layers of the two MoE
  families' steps there and in one process.
- ``dryrun``: ``launch.dryrun.run_case`` on 16x16 (a fake group of
  256) for the 10 architectures at ``train_4k``, full width, 2 layers.
- ``xla``: the reference's ``build_case`` for the same 21 steps,
  compiled on 8 host devices on an ``AxisType.Auto`` (2, 4) mesh (jax
  0.9's default Explicit axes fail the reference's own ``shard``) under
  ``flags.unrolled_scans()``: XLA's FLOPs (``cost_analysis``), its dot
  instructions' FLOPs and collective bytes a device.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import ARCHS, get_arch, get_shape, reduce_for_smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (fake_group, make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import flags  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.train import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

#: the families: dense, SSM, hybrid, MoE, MLA + MoE, audio, VLM
FAMILIES = ["starcoder2-7b", "mamba2-370m", "zamba2-7b",
            "llama4-scout-17b-a16e", "deepseek-v3-671b", "whisper-tiny",
            "pixtral-12b"]
MODES = ("train", "prefill", "decode")
MOE_FAMILIES = ["llama4-scout-17b-a16e", "deepseek-v3-671b"]
#: E*C = T*K / 2: at least half the pairs of a prefill or train step
#: find no slot, whatever the routing
DROPPING_CAPACITY = 0.5
GLOO_WORLD = 4
GLOO_MESH = (2, 2)
BATCH, SEQ, DECODE_MAX = 4, 16, 24
#: the per-device counts' mesh and steps, against XLA's
COUNT_WORLD = 8
COUNT_MESH = (2, 4)
COUNT_BATCH, COUNT_SEQ = 8, 64


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _max_diff(a, b) -> float:
    return float((sh.gather(a).detach().float()
                  - sh.gather(b).detach().float()).abs().max())


def _rel_l2(a, b) -> float:
    a, b = sh.gather(a).detach().float(), sh.gather(b).detach().float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _dropped(fn):
    """(fn(), the pairs ``moe.DROPPED`` counted while it ran)."""
    moe_mod.DROPPED = 0
    res = fn()
    return res, moe_mod.DROPPED


def _routing(fn):
    """(fn(), each dispatch's (T, K) expert ids), ``moe._route`` recorded."""
    seen, route = [], moe_mod._route

    def recorded(*args):
        probs, gates, eidx = route(*args)
        seen.append(sh.gather(eidx).detach().clone())
        return probs, gates, eidx

    moe_mod._route = recorded
    try:
        return fn(), seen
    finally:
        moe_mod._route = route


def _spanning_drops(eidx, cfg, pieces: int) -> int:
    """The experts, over every dispatch, whose pairs come from more than
    one of ``pieces`` contiguous pieces of the tokens (the data ranks'
    rows) and that drop pairs at capacity: where a pair's rank is
    global, not its piece's."""
    n = 0
    for e in eidx:
        T, K = e.shape
        C = max(1, math.ceil(T * K / cfg.num_experts * cfg.capacity_factor))
        per = torch.stack([moe_mod.expert_counts(p.reshape(-1),
                                                 cfg.num_experts)
                           for p in e.chunk(pieces)])
        n += int(((per > 0).sum(0) > 1).logical_and(per.sum(0) > C).sum())
    return n


def _family(arch: str, mesh, path: str, capacity_factor=None) -> dict:
    """``arch``'s placed steps against one process; ``capacity_factor``
    replaces the config's (the MoE dispatch runs)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                              dtype="float32")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)

    def fresh():            # the same seeded weights every call
        return model_mod.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")

    lm = fresh()
    batch = model_mod.make_inputs(cfg, BATCH, SEQ, device="cpu",
                                  generator=torch.Generator().manual_seed(1))
    prefill = ShapeConfig("prefill_small", SEQ, BATCH, "prefill")
    train = ShapeConfig("train_small", SEQ, BATCH, "train")
    serve = dryrun.rules_for(cfg, prefill, GLOO_MESH[1])
    trules = dryrun.rules_for(cfg, train, GLOO_MESH[1])
    out = {}

    # forward; each step's pairs dropped at capacity, placed and not
    dropped = out["dropped"] = {}
    with torch.no_grad():
        ((want, _, _), drop_want), routes = _routing(lambda: _dropped(
            lambda: model_mod.forward(cfg, lm, batch)))
        placed = sh.distribute(fresh(), mesh, serve)
        pbatch = sh.place_tree(batch, model_mod.batch_axes(batch), mesh,
                               serve)
        with sh.axis_rules(mesh, serve):
            (got, _, _), drop_got = _dropped(
                lambda: model_mod.forward(cfg, placed, pbatch))
    out["forward_max_abs"] = _max_diff(got, want)
    dropped["forward"] = [drop_got, drop_want]
    if cfg.num_experts:
        out["spanning_drops"] = _spanning_drops(routes, cfg, GLOO_MESH[0])

    # one train step
    opt = AdamW()

    def train_step(params, b, mesh_=None, rules=None):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        state = opt.init(named)
        with (sh.axis_rules(mesh_, rules) if mesh_ is not None
              else contextlib.nullcontext()):
            loss = model_mod.loss_fn(cfg, params, b)
            loss.backward()
            grads = {n: p.grad for n, p in named.items()}
            kept = {n: sh.gather(g).clone() for n, g in grads.items()}
            opt.step_(named, grads, state)
        return float(sh.gather(loss.detach())), kept, named

    (loss_ref, g_ref, p_ref), drop_want = _dropped(
        lambda: train_step(fresh(), batch))
    placed = sh.distribute(fresh(), mesh, trules)
    tbatch = sh.place_tree(batch, model_mod.batch_axes(batch), mesh, trules)
    (loss_got, g_got, p_got), drop_got = _dropped(
        lambda: train_step(placed, tbatch, mesh, trules))
    dropped["train"] = [drop_got, drop_want]
    out["loss_abs"] = abs(loss_got - loss_ref)
    out["grad_rel_l2"] = max(_rel_l2(g_got[n], g_ref[n]) for n in g_ref)
    # the whole model's updated parameters at once: AdamW's first step
    # is about lr * sign(g), so a zero-initialised leaf whose gradient is
    # rounding noise in places (a key bias under RoPE) differs there by a
    # fraction of lr whatever the tolerance on its gradient
    diff = sum(float((sh.gather(p_got[n]).detach()
                      - p_ref[n].detach()).square().sum()) for n in p_ref)
    norm = sum(float(p_ref[n].detach().square().sum()) for n in p_ref)
    out["params_rel_l2"] = (diff / norm) ** 0.5
    out["param_max_abs"] = max(_max_diff(p_got[n], p_ref[n]) for n in p_ref)
    out["lr"] = float(opt.lr)

    # the trained placed model through a checkpoint: gathered whole to
    # save (rank 0 writes), placed again as it restores
    ckpt = os.path.join(os.path.dirname(path),
                        f"{arch}-{cfg.capacity_factor}.npz")
    ckpt_mod.save(ckpt, placed, step=1)
    dist.barrier()
    back, step = ckpt_mod.restore(ckpt, sh.distribute(fresh(), mesh, trules))
    named = dict(back.named_parameters())
    out["checkpoint_step"] = step
    out["checkpoint_max_abs"] = max(_max_diff(named[n], p_got[n])
                                    for n in p_got)
    out["checkpoint_placed"] = all(
        tuple(named[n].placements) == tuple(p_got[n].placements)
        for n in p_got)

    # one decode step against a prefilled cache
    with torch.no_grad():
        _, pre, _ = model_mod.forward(cfg, lm, batch, return_cache=True)
        cache = model_mod.merge_prefill_cache(
            model_mod.init_decode_cache(cfg, BATCH, DECODE_MAX,
                                        device="cpu"), pre)
        pcache = sh.place_tree(copy.deepcopy(cache),
                               model_mod.cache_logical_axes(cache), mesh,
                               serve)
        tok = torch.randint(0, cfg.vocab_size, (BATCH, 1),
                            generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
        cur = torch.full((BATCH,), SEQ, dtype=torch.int32)
        (want, cache), drop_want = _dropped(
            lambda: model_mod.decode_step(cfg, lm, tok, cache, cur))
        placed = sh.distribute(fresh(), mesh, serve)
        ptok = sh.place(tok, mesh, serve, ("batch", None))
        pcur = sh.place(cur, mesh, serve, ("batch",))
        with sh.axis_rules(mesh, serve):
            (got, pcache), drop_got = _dropped(
                lambda: model_mod.decode_step(cfg, placed, ptok, pcache,
                                              pcur))
    out["decode_max_abs"] = _max_diff(got, want)
    dropped["decode"] = [drop_got, drop_want]
    leaves = zip(torch.utils._pytree.tree_leaves(pcache),
                 torch.utils._pytree.tree_leaves(cache))
    out["cache_max_abs"] = max(_max_diff(a, b) for a, b in leaves)
    return out


def _gloo_rank(rank: int, port: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=GLOO_WORLD)
    try:
        mesh = make_mesh(GLOO_MESH, ("data", "model"), device_type="cpu")
        res = {arch: _family(arch, mesh, path) for arch in FAMILIES}
        # the MoE families again with the decode step on the dispatch and
        # a capacity that drops pairs whatever the routing
        flags.MOE_DECODE_DISPATCH = True
        for arch in MOE_FAMILIES:
            res[f"{arch}/dispatch"] = _family(arch, mesh, path,
                                              DROPPING_CAPACITY)
        if rank == 0:
            with open(path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def gloo(path: str) -> None:
    mp.start_processes(_gloo_rank, args=(_free_port(), path),
                       nprocs=GLOO_WORLD, join=True, start_method="spawn")


def _shards() -> list:
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    rows = []
    for multi_pod in (False, True):
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            dm = mesh.device_mesh
            for arch in ARCHS:
                cfg = get_arch(arch)
                rules = dryrun.rules_for(cfg, get_shape("train_4k"),
                                         mesh.shape["model"])
                lm = sh.distribute(model_mod.module(cfg, "meta"), mesh,
                                   rules)
                for name, p in lm.named_parameters():
                    want = sh.local_shape(p.shape, rules.spec(
                        p.logical_axes, mesh), mesh)
                    first, _ = compute_local_shape_and_global_offset(
                        p.shape, dm, p.placements, (0,) * dm.ndim)
                    last, _ = compute_local_shape_and_global_offset(
                        p.shape, dm, p.placements,
                        tuple(n - 1 for n in dm.shape))
                    rows.append({"chips": mesh.size, "arch": arch,
                                 "leaf": name, "want": list(want),
                                 "rank0": list(first), "last": list(last),
                                 "local": list(p.to_local().shape)})
    return rows


def _counts() -> dict:
    out = {}
    with fake_group(COUNT_WORLD):
        mesh = make_mesh(COUNT_MESH, ("data", "model"))
        for arch in FAMILIES:
            cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                                      dtype="float32")
            for mode in MODES:
                shape = ShapeConfig(f"{mode}_small", COUNT_SEQ, COUNT_BATCH,
                                    mode)
                rules = dryrun.rules_for(cfg, shape, COUNT_MESH[1])
                case = dryrun.build_case(cfg, shape, mesh=mesh, rules=rules)
                c = dryrun.count(case.fn)
                out[f"{arch}/{mode}"] = {"flops": c.flops,
                                         "collectives": c.collectives}
    return out


class _Largest(TorchDispatchMode):
    """The bytes of the largest tensor a local op produces (views, which
    hold no storage of their own, and DTensor's propagation on fake
    tensors left out); an op on DTensors is left to DTensor, whose local
    ops and collectives then reach this mode, as in ``dryrun.StepCounter``."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        leaves = torch.utils._pytree.tree_leaves((args, kwargs))
        if not func.is_view and not any(isinstance(t, FakeTensor)
                                        for t in leaves):
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.bytes = max(self.bytes,
                                     t.numel() * t.element_size())
        return out


def _largest_in_moe(case) -> int:
    """The largest local tensor any op inside ``moe.apply_moe`` produces
    while ``case`` runs (its recomputation under remat included)."""
    mode, apply = _Largest(), moe_mod.apply_moe

    def recorded(*args, **kwargs):
        with mode:
            return apply(*args, **kwargs)

    moe_mod.apply_moe = recorded
    try:
        dryrun.count(case.fn)
    finally:
        moe_mod.apply_moe = apply
    return mode.bytes


def _moe_largest() -> dict:
    """{arch/mode: (placed, unplaced)}: the largest local tensor inside the
    MoE layers of the MoE families' reduced fp32 steps at B 8 x S 64,
    on a device of the fake (2, 4) mesh and in one process, the decode
    step on the dispatch (``MOE_DECODE_DISPATCH``)."""
    out = {}
    with fake_group(COUNT_WORLD), dryrun.model_flags({"moe_dispatch"}):
        mesh = make_mesh(COUNT_MESH, ("data", "model"))
        for arch in MOE_FAMILIES:
            cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                                      dtype="float32")
            for mode in MODES:
                shape = ShapeConfig(f"{mode}_small", COUNT_SEQ, COUNT_BATCH,
                                    mode)
                rules = dryrun.rules_for(cfg, shape, COUNT_MESH[1])
                out[f"{arch}/{mode}"] = [
                    _largest_in_moe(dryrun.build_case(cfg, shape, **where))
                    for where in (dict(mesh=mesh, rules=rules), {})]
    return out


def fake(path: str) -> None:
    torch.set_num_threads(1)
    with open(path, "w") as f:
        json.dump({"shards": _shards(), "counts": _counts(),
                   "moe_largest": _moe_largest()}, f)


def dry(path: str) -> None:
    torch.set_num_threads(1)
    res = [dryrun.run_case(arch, "train_4k", mesh="16x16", layers=2,
                           verbose=False) for arch in ARCHS]
    with open(path, "w") as f:
        json.dump(res, f)


_DOT = re.compile(r"%\S+ = \w+\[([0-9,]*)\]\{[^}]*\} dot\(%(\S+), %\S+\),"
                  r" .*lhs_contracting_dims=\{([0-9,]*)\}")
_SHAPE = re.compile(r"%(\S+) = \w+\[([0-9,]*)\]")


def _dims(text: str) -> list:
    return [int(d) for d in text.split(",") if d]


def dot_flops(hlo: str) -> int:
    """2 x (output elements) x (contracted elements) summed over the dot
    instructions of an SPMD-partitioned HLO module: its matrix-product
    FLOPs a device, what ``launch.dryrun`` counts."""
    shapes = {m.group(1): _dims(m.group(2)) for m in _SHAPE.finditer(hlo)}
    total = 0
    for m in _DOT.finditer(hlo):
        lhs = shapes[m.group(2)]
        total += 2 * math.prod(_dims(m.group(1))) * math.prod(
            lhs[d] for d in _dims(m.group(3)))
    return total


def xla(path: str) -> None:
    import jax
    from jax.sharding import AxisType

    if len(jax.devices()) != COUNT_WORLD:
        raise RuntimeError(f"{len(jax.devices())} devices; run with "
                           f"XLA_FLAGS=--xla_force_host_platform_device_"
                           f"count={COUNT_WORLD}")
    # imported after jax is up: the module sets XLA_FLAGS to 512 devices
    # and a persistent compilation cache when it is imported
    from repro.configs import get_arch as jget_arch
    from repro.configs import reduce_for_smoke as jreduce
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.dist.sharding import axis_rules
    from repro.launch import dryrun as rd
    from repro.launch.hlo_analysis import collective_bytes
    from repro.models import flags

    jax.config.update("jax_compilation_cache_dir", None)
    mesh = jax.make_mesh(COUNT_MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in FAMILIES:
        cfg = dataclasses.replace(jreduce(jget_arch(arch)), dtype="float32")
        for mode in MODES:
            shape = JShapeConfig(f"{mode}_small", COUNT_SEQ, COUNT_BATCH,
                                 mode)
            rules = rd.rules_for(cfg, shape, COUNT_MESH[1])
            with flags.unrolled_scans(), axis_rules(mesh, rules):
                fn, specs, ins, outs = rd.build_case(cfg, shape, mesh, rules)
                compiled = jax.jit(fn, in_shardings=ins, out_shardings=outs,
                                   keep_unused=True).lower(*specs).compile()
            hlo = compiled.as_text()
            out[f"{arch}/{mode}"] = {
                "flops": compiled.cost_analysis()["flops"],
                "dot_flops": dot_flops(hlo),
                "collectives": collective_bytes(hlo)}
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    {"gloo": gloo, "fake": fake, "dryrun": dry,
     "xla": xla}[sys.argv[1]](sys.argv[2])
