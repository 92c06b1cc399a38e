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
  seeded weights and inputs, the forward's prefill cache too, and the
  pairs each step drops at capacity (``moe.DROPPED``); the SSM decode
  again through ``take``'s form before it had a gradient
  (``_take_before``), bit for bit; the MoE families again with the
  decode step on the dispatch (``MOE_DECODE_DISPATCH``) and a capacity
  that drops pairs (``DROPPING_CAPACITY``), with the experts whose
  pairs come from both data ranks and are dropped; and ``take`` on a
  1-D mesh of the 4 ranks against slicing the whole tensor, its
  gradient too.  Rank 0 writes the differences.
- ``fake``: fake groups of 256, 512 and 8 ranks: every parameter of the
  10 architectures at full size on meta, placed by the train rules on
  16x16 and 2x16x16, DTensor's local shape on rank 0 and on the last
  rank beside ``dist.sharding.local_shape``; the port's per-device
  counts of the 7 families' reduced fp32 steps on a (2, 4) mesh and of
  Whisper-tiny's at its 6 heads (head_dim split), with the collectives
  of the latter and of the SSM prefill and train steps by their sites
  (``launch.dryrun.site``); and the largest local tensor inside the MoE layers
  of the two MoE families' steps there and in one process.
- ``dryrun``: ``launch.dryrun.run_case`` on 16x16 (a fake group of
  256) for the 10 architectures at ``train_4k``, full width, 2 layers.
- ``xla``: the reference's ``build_case`` for the same 23 steps,
  compiled on 8 host devices on an ``AxisType.Auto`` (2, 4) mesh (jax
  0.9's default Explicit axes fail the reference's own ``shard``) under
  ``flags.unrolled_scans()``: XLA's FLOPs (``cost_analysis``), its dot
  instructions' FLOPs and collective bytes a device, at Whisper-tiny's
  6 heads the kinds of the collectives that move attention scores, and
  in the SSM train step those that move the tensors whose collectives
  the port pins (``ssm_collectives``).
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
from repro_torch.models import transformer as tfm  # noqa: E402
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


def _take_before(x, dim, want, name):
    """``dist.sharding.take`` as it was before it had a gradient, kept
    here to hold the placed decode to it bit for bit."""
    from torch.distributed._functional_collectives import \
        all_to_all_single
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    (a,) = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    parts, n = mesh.size(a), x.shape[dim]
    me = mesh.get_coordinate()[a]

    def clip(lo, hi, i):
        lo_i, hi_i = sh.chunk(n, parts, i)
        lo = min(max(lo, lo_i), hi_i)
        return lo, max(lo, min(hi, hi_i))

    local = x.to_local().movedim(dim, 0)
    own = sh.chunk(n, parts, me)[0]
    send = [[clip(lo, hi, me) for lo, hi in want(j)] for j in range(parts)]
    recv = [[clip(lo, hi, i) for lo, hi in want(me)] for i in range(parts)]
    data = all_to_all_single(
        torch.cat([local[:0]] + [local[lo - own:hi - own]
                                 for pieces in send for lo, hi in pieces]),
        [sum(hi - lo for lo, hi in p) for p in recv],
        [sum(hi - lo for lo, hi in p) for p in send], (mesh, a))
    at, rows = 0, {}
    for i, pieces in enumerate(recv):
        for k, (lo, hi) in enumerate(pieces):
            rows[k, i] = (at, at + hi - lo)
            at += hi - lo
    return torch.cat([data[rows[k, i][0]:rows[k, i][1]]
                      for k in range(len(want(me)))
                      for i in range(parts)]).movedim(0, dim)


@contextlib.contextmanager
def _take_without_grad():
    take, sh.take = sh.take, _take_before
    try:
        yield
    finally:
        sh.take = take


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

    # forward with its prefill cache; each step's pairs dropped at
    # capacity, placed and not
    dropped = out["dropped"] = {}
    with torch.no_grad():
        ((want, want_cache, _), drop_want), routes = _routing(
            lambda: _dropped(lambda: model_mod.forward(
                cfg, lm, batch, return_cache=True)))
        placed = sh.distribute(fresh(), mesh, serve)
        pbatch = sh.place_tree(batch, model_mod.batch_axes(batch), mesh,
                               serve)
        with sh.axis_rules(mesh, serve):
            (got, got_cache, _), drop_got = _dropped(
                lambda: model_mod.forward(cfg, placed, pbatch,
                                          return_cache=True))
    out["forward_max_abs"] = _max_diff(got, want)
    out["prefill_cache_max_abs"] = max(
        _max_diff(a, b) for a, b in zip(
            torch.utils._pytree.tree_leaves(got_cache),
            torch.utils._pytree.tree_leaves(want_cache)))
    if tfm.is_ssm(cfg):
        conv = [t for path, t in torch.utils._pytree.tree_flatten_with_path(
            got_cache)[0] if "conv" in torch.utils._pytree.keystr(path)]
        out["prefill_conv_placements"] = [
            [str(p) for p in t.placements] for t in conv]
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
        before_cache = sh.place_tree(copy.deepcopy(cache),
                                     model_mod.cache_logical_axes(cache),
                                     mesh, serve)
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
    if tfm.is_ssm(cfg):
        # the placed decode again, its in_proj re-split by take's form
        # before it had a gradient: bit for bit
        with torch.no_grad(), sh.axis_rules(mesh, serve), \
                _take_without_grad():
            before, bcache = model_mod.decode_step(
                cfg, placed, ptok, before_cache, pcur)
        out["decode_take_bit_for_bit"] = bool(
            torch.equal(sh.gather(before), sh.gather(got)) and all(
                torch.equal(sh.gather(a), sh.gather(b)) for a, b in zip(
                    torch.utils._pytree.tree_leaves(bcache),
                    torch.utils._pytree.tree_leaves(pcache))))
    return out


#: take's check on the gloo ranks: a dimension of TAKE_N rows over the 4
#: ranks (chunks of 3, 3, 3 and 1), each rank taking what
#: ``tests/test_torch_take.py`` has its ranks take
TAKE_N = 10


def _take_check(rank: int) -> dict:
    """``sharding.take`` on a 1-D mesh of the 4 gloo ranks, dim 0 split:
    this rank's pieces and the gathered gradient of x against slicing
    the whole tensor (``test_torch_take._reference``)."""
    from torch.distributed.tensor import Shard
    from test_torch_take import _reference, _wants

    mesh = make_mesh((GLOO_WORLD,), ("model",), device_type="cpu")
    want = _wants(TAKE_N)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(TAKE_N, 3, 2, generator=g, dtype=torch.float64)
    ups = [torch.randn(sum(hi - lo for lo, hi in want(j)), 3, 2,
                       generator=g, dtype=torch.float64)
           for j in range(GLOO_WORLD)]
    want_out, want_grad = _reference(x, ups, want, GLOO_WORLD)
    dx = sh.place(x, mesh, sh.ShardingRules({"rows": "model"}),
                  ("rows", None, None)).requires_grad_(True)
    assert tuple(dx.placements) == (Shard(0),)
    out = sh.take(dx, 0, want, "take check")
    (out * ups[rank]).sum().backward()
    return {"out_max_abs": float((out.detach() - want_out[rank]).abs().max()),
            "grad_max_abs": float((sh.gather(dx.grad) - want_grad)
                                  .abs().max()),
            "grad_placements": [str(p) for p in dx.grad.placements]}


def _gloo_rank(rank: int, port: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=GLOO_WORLD)
    try:
        mesh = make_mesh(GLOO_MESH, ("data", "model"), device_type="cpu")
        res = {"take": _take_check(rank)}
        res.update({arch: _family(arch, mesh, path) for arch in FAMILIES})
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


def split_head_dim_whisper(cfg):
    """Whisper-tiny's reduced config with its published 6 heads, which
    do not divide the (2, 4) mesh's model axis: ``rules_for`` then splits
    head_dim, as it does for the whole model on 16x16."""
    return dataclasses.replace(cfg, num_heads=SPLIT_HEADS,
                               num_kv_heads=SPLIT_HEADS)


#: Whisper-tiny's heads, at which the (2, 4) mesh splits head_dim
SPLIT_HEADS = 6
SPLIT_MODES = ("train", "prefill")
#: the SSM steps whose in_proj and conv cache re-split by all-to-all
SSM_FAMILIES = ["mamba2-370m", "zamba2-7b"]
#: the family whose train step's SSM tensors XLA's collectives are found
#: for by shape: the pure SSM stack (the hybrid's shared attention block
#: moves tensors of the residual's shape by other collectives)
SSM_SITES_ARCH = "mamba2-370m"


def _records(counter) -> list:
    """[kind, bytes, frames] of each collective site the step counter
    kept (``launch.dryrun.site``'s frames: those that issued it, and in a
    backward ``BACKWARD_OF`` and the forward op's)."""
    return [[what, n, list(frames)] for (what, frames), n
            in counter.sites.items() if what != "flops"]


def _counts() -> dict:
    """The per-device counts of the families' (2, 4) steps, those of
    Whisper-tiny at 6 heads (``split/{mode}``) and, for it and the SSM
    families' prefill and train, each collective by its site
    (``sites``)."""
    out, sites = {}, {}
    with fake_group(COUNT_WORLD):
        mesh = make_mesh(COUNT_MESH, ("data", "model"))
        runs = [(arch, arch, mode, lambda c: c) for arch in FAMILIES
                for mode in MODES]
        runs += [(f"split/{mode}", "whisper-tiny", mode,
                  split_head_dim_whisper) for mode in SPLIT_MODES]
        for key, arch, mode, adapt in runs:
            cfg = adapt(dataclasses.replace(
                reduce_for_smoke(get_arch(arch)), dtype="float32"))
            shape = ShapeConfig(f"{mode}_small", COUNT_SEQ, COUNT_BATCH,
                                mode)
            rules = dryrun.rules_for(cfg, shape, COUNT_MESH[1])
            case = dryrun.build_case(cfg, shape, mesh=mesh, rules=rules)
            if "/" not in key:
                key = f"{arch}/{mode}"
            by_site = key.startswith("split/") or (arch in SSM_FAMILIES
                                                   and mode != "decode")
            c = dryrun.count(case.fn, sites=by_site)
            out[key] = {"flops": c.flops, "collectives": c.collectives}
            if by_site:
                sites[key] = _records(c)
    out["sites"] = sites
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


_COLL = re.compile(r"= (\(?[^\n]*?) (all-reduce|reduce-scatter|all-gather|"
                   r"all-to-all|collective-permute)(-start)?\(")


def score_collectives(hlo: str, batch: int, heads: int) -> list:
    """The kinds of the collectives in an SPMD-partitioned HLO module that
    move attention scores: a result (of a tuple's, any element) whose
    dimensions, ones left out, are the local batch, the heads and two
    sequence lengths (queries, keys)."""
    kinds = set()
    for m in _COLL.finditer(hlo):
        for dims in re.findall(r"\w+\[([0-9,]*)\]", m.group(1)):
            d = [n for n in _dims(dims) if n != 1]
            if len(d) == 4 and d[:2] == [batch, heads]:
                kinds.add(m.group(2))
    return sorted(kinds)


_COLL_OP = re.compile(r"= (\(?[^\n]*?) (all-reduce|reduce-scatter|"
                      r"all-gather|all-to-all|collective-permute)"
                      r"(?:-start)?\(")


def ssm_collectives(hlo: str, batch: int, seq: int, d_model: int,
                    chunk: int, state: int) -> dict:
    """The kinds of the collectives in the reference's partitioned SSM
    train step that move each tensor whose site the port pins, found by
    its shape (a float's, ones left out), forward and backward together
    (XLA's combiner merges the two directions' all-reduces into one op):
    ``norm``, the gate norm's mean (local batch, seq); ``bc``, B or C
    and G = C B^T (local batch, chunks, chunk, state, with the chunk as
    long as the state); ``residual``, the layer's output and the
    gradient of its input (local batch, seq, d_model)."""
    shapes = {"norm": [batch, seq],
              "bc": [batch, seq // chunk, chunk, state],
              "residual": [batch, seq, d_model]}
    out = {name: set() for name in shapes}
    for m in _COLL_OP.finditer(hlo):
        for dtype, dims in re.findall(r"(\w+)\[([0-9,]*)\]", m.group(1)):
            if dtype not in ("f32", "bf16"):       # token ids, positions
                continue
            d = [n for n in _dims(dims) if n != 1]
            for name, want in shapes.items():
                if d == want:
                    out[name].add(m.group(2))
    return {name: sorted(kinds) for name, kinds in out.items()}


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
            if arch == SSM_SITES_ARCH and mode == "train":
                out[f"{arch}/{mode}"]["ssm_sites"] = ssm_collectives(
                    hlo, COUNT_BATCH // COUNT_MESH[0], COUNT_SEQ,
                    cfg.d_model, cfg.ssm_chunk, cfg.ssm_state)
    # Whisper-tiny at 6 heads, head_dim split: the collectives XLA emits
    # for the attention scores
    for mode in SPLIT_MODES:
        cfg = split_head_dim_whisper(dataclasses.replace(
            jreduce(jget_arch("whisper-tiny")), dtype="float32"))
        shape = JShapeConfig(f"{mode}_small", COUNT_SEQ, COUNT_BATCH, mode)
        rules = rd.rules_for(cfg, shape, COUNT_MESH[1])
        with flags.unrolled_scans(), axis_rules(mesh, rules):
            fn, specs, ins, outs = rd.build_case(cfg, shape, mesh, rules)
            compiled = jax.jit(fn, in_shardings=ins, out_shardings=outs,
                               keep_unused=True).lower(*specs).compile()
        hlo = compiled.as_text()
        out[f"split/{mode}"] = {
            "flops": compiled.cost_analysis()["flops"],
            "dot_flops": dot_flops(hlo),
            "collectives": collective_bytes(hlo),
            "score_collectives": score_collectives(
                hlo, COUNT_BATCH // COUNT_MESH[0], SPLIT_HEADS)}
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    {"gloo": gloo, "fake": fake, "dryrun": dry,
     "xla": xla}[sys.argv[1]](sys.argv[2])
