"""Dry run: every (architecture x input shape) at full size on the meta device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh local|16x16|2x16x16] [--opts ...] [--out f.json]

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
case with XLA on a 512-device host mesh.  Here the model is built on
``torch.device("meta")`` (shapes and dtypes, no storage, no weights
drawn) and the reference's three steps run on meta tensors:

- train: ``loss_fn`` with per-layer remat, its backward, ``AdamW.step_``;
- prefill: ``forward(..., return_cache=True)``;
- decode: one ``decode_step`` against a full ``init_decode_cache``, with
  ``window_for``'s window.

Each step runs under :class:`StepCounter`, a dispatch mode that counts
each op's matrix-product FLOPs (``torch.utils.flop_counter``'s
formulas), its tensor input and output bytes (views skipped) and each
collective's result bytes by kind.  The FLOPs are matrix products only
(XLA's count adds elementwise work).  The bytes are the counterpart of
XLA's "bytes accessed", but unfused: every op reads its inputs from and
writes its outputs to memory, so they are an upper bound on the traffic.
``kernels.ops`` takes the plain versions for meta tensors, as for CPU
ones, so attention is counted as its plain version computes it: the full
S x T scores, materialised (XLA's count of the reference's jnp
attention is full-block too).  The counters see every layer at full
depth, so the reference's cost probes (``probe_variants`` /
``probe_costs``, which extrapolate from unrolled shallow variants
because XLA counts a while loop's body once) are not carried.

On the ``local`` mesh (one device) a case reports the parameter count,
the argument bytes (params, AdamW state and batch for train; params,
batch and cache otherwise: the counterpart of XLA's
``memory_analysis().argument_size_in_bytes``), whether they fit the
card's 80 GB (activations are not counted), the counted FLOPs and bytes,
their times at the H100's peaks (``hlo_analysis``), the bottleneck and
the useful share of the FLOPs (``6 N_active`` per trained token, ``2
N_active`` per served one).  On a production mesh (16x16, 2x16x16) the
case is placed: inside a fake process group of the mesh's size
(``mesh.fake_group``) the parameters, AdamW's moments, the batch and
the cache are DTensors placed by ``rules_for``'s specs, the step runs
under ``axis_rules`` with the model's activation constraints, and the
counter sees one device's local ops and DTensor's collectives, each
collective's bytes by the reference's rule (result bytes, an all-reduce
twice) under the reference's names.  It reports that device's argument
bytes (``local_shape``; DTensor's local shards hold the same), FLOPs,
bytes, collective bytes, the compute, memory and collective terms (a
collective at NVLink's rate within a node of ``NODE_CARDS``, at
InfiniBand's across nodes: every axis of both production meshes) and
the bottleneck among the three.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import time
import traceback
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (LONG_CTX_RULES, SERVE_RULES,
                                       TRAIN_RULES, ShardingRules, axes_of,
                                       axis_rules, clear_propagation_cache,
                                       distribute, place_tree,
                                       local_shape, unbox)
from repro_torch.launch.hlo_analysis import (HBM_BW, HBM_BYTES, IB_BW,
                                             NODE_CARDS, NVLINK_BW,
                                             PEAK_FLOPS, PEAK_FLOPS_FP32)
from repro_torch.launch.mesh import (Mesh, fake_group, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import flags
from repro_torch.models import model as model_mod
from repro_torch.train.optimizer import AdamW

SLIDING_WINDOW_500K = 8192   # beyond-paper: ring-cache for dense 500k decode
META = torch.device("meta")
MESHES: Dict[str, Callable[[], Mesh]] = {
    "local": make_local_mesh,
    "16x16": make_production_mesh,
    "2x16x16": lambda: make_production_mesh(multi_pod=True),
}
#: the opts run_case takes: the two model flags and two rule changes
OPTS = ("bf16_stream", "moe_dispatch", "decode_kv_shard",
        "attn_no_headdim_shard")
REFUSED = {"where_cache": "where_cache steers how GSPMD partitions the "
                          "decode cache update; the port writes an "
                          "unplaced cache's slot in place and a placed one "
                          "by that select form always"}


# --------------------------------------------------------------------------
# Rules per (arch, shape): the reference's, rule for rule
# --------------------------------------------------------------------------

def rules_for(cfg: ModelConfig, shape: ShapeConfig,
              model_axis: int = 16, opts=frozenset()) -> ShardingRules:
    if shape.mode == "train":
        base = TRAIN_RULES
    elif shape.name == "long_500k":
        base = ShardingRules({**LONG_CTX_RULES, "batch": None,
                              "kv_seq": ("pod", "data")})
    else:
        base = SERVE_RULES
    rules = ShardingRules(base)
    # kv heads that don't divide the model axis: shard head_dim instead of
    # padding the KV cache 4-16x (GSPMD would pad uneven head sharding)
    if (cfg.num_kv_heads and cfg.num_kv_heads % model_axis != 0
            and not cfg.use_mla):
        rules["kv_heads"] = None
        rules["head_dim"] = "model"
    if cfg.num_heads and cfg.num_heads % model_axis != 0:
        rules["heads"] = None
    if cfg.num_experts and cfg.num_experts % model_axis != 0:
        rules["expert"] = "data"
    # ---- §Perf opt: distributed flash-decode over a model-sharded cache.
    # Replaces the head_dim-sharded contraction (which all-reduces
    # (B,H,T) fp32 scores per layer) with a kv_seq-sharded cache: softmax
    # and A@V reduce over the sharded T axis with tiny (B,H[,hd])
    # all-reduces instead.
    if ("decode_kv_shard" in opts and shape.mode == "decode"
            and shape.name != "long_500k" and not cfg.use_mla):
        rules["kv_seq"] = "model"
        rules["head_dim"] = None
        rules["kv_heads"] = None
    if "attn_no_headdim_shard" in opts:
        rules["head_dim"] = None
        rules["kv_heads"] = None
    return rules


def window_for(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Sub-quadratic guard for 500k decode on pure-attention archs."""
    if shape.name != "long_500k":
        return None
    if cfg.family in ("ssm", "hybrid"):
        return None          # native sub-quadratic state
    return SLIDING_WINDOW_500K


# --------------------------------------------------------------------------
# Counting
# --------------------------------------------------------------------------

#: ops that move no data (views are skipped by ``OpOverload.is_view``)
_NO_DATA = {"_unsafe_view", "empty", "empty_like", "empty_strided",
            "new_empty", "new_empty_strided", "wait_tensor",
            "_wrap_tensor_autograd"}
_DEVICE = torch.ops.prim.device.default
#: DTensor's collectives (``_c10d_functional``, ``_dtensor``) under the
#: reference's names for them (``hlo_analysis.collective_bytes``)
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}
#: a ring all-reduce moves its buffer twice (reduce-scatter, all-gather)
COLLECTIVE_FACTOR = {"all-reduce": 2}


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


#: a frame of ``traceback.format_stack``'s text (autograd's record of
#: where a backward node's forward op ran)
_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')
#: where a site's frames pass from a backward to its forward's
BACKWARD_OF = "backward of"
#: the files of the autograd engine's entry (``backward()``): frames
#: further out made the step, not the backward op
_ENGINE_ENTRIES = ("torch/autograd/graph.py", "torch/autograd/__init__.py")


def _port_frame(filename: str, name: str, line) -> Optional[str]:
    """"file:function:line" for a frame of ``repro_torch`` (this module's
    left out), else None."""
    path = filename.replace(os.sep, "/")
    if "repro_torch/" not in path or path.endswith("launch/dryrun.py"):
        return None
    return f"{os.path.basename(path)}:{name}:{line}"


def site() -> Tuple[str, ...]:
    """The frames of ``repro_torch`` ("file:function:line", innermost
    first) that issued the op running now.  In a backward, those of the
    code that runs it (an autograd Function's ``backward``; none for an
    aten op's backward, which DTensor partitions itself), then
    ``BACKWARD_OF`` and the frames where its forward op ran (recorded
    under ``torch.autograd.detect_anomaly``, which ``count(sites=True)``
    turns on).  A forward that remat recomputes inside a backward is a
    forward."""
    here = []
    node = torch._C._current_autograd_node()
    for f in reversed(traceback.extract_stack()):
        path = f.filename.replace(os.sep, "/")
        if node is not None and path.endswith("torch/utils/checkpoint.py"):
            return tuple(here)                      # a recomputed forward
        if node is not None and path.endswith(_ENGINE_ENTRIES):
            break                                   # backward() itself
        frame = _port_frame(f.filename, f.name, f.lineno)
        if frame is not None:
            here.append(frame)
            if node is not None and f.name == "backward":
                break
    if node is None:
        return tuple(here)
    fwd = [_port_frame(m.group(1), m.group(3), m.group(2))
           for text in reversed(node.metadata.get("traceback_", ()))
           for m in _FRAME.finditer(text)]
    return tuple(here) + (BACKWARD_OF,) + tuple(f for f in fwd if f)


class StepCounter(TorchDispatchMode):
    """What one device does in a step: the matrix-product FLOPs
    (``torch.utils.flop_counter``'s formulas), each op's tensor input
    and output bytes (an in-place op's operand counts as read and as
    written; views and allocations that write nothing are skipped) and
    each collective's result bytes by kind, an all-reduce's twice.
    With ``sites``, the FLOPs and each collective's bytes also by the
    frames that issued them (``sites[what, site()]``, ``what`` "flops"
    or the collective's kind).

    Over DTensors it counts the local ops only: an op on a DTensor is
    left to DTensor (``NotImplemented``), whose local ops and
    collectives then reach this mode on plain tensors; the fake tensors
    DTensor runs to propagate global shapes are not counted."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {}
        self.collective_t = 0.0
        self.sites = collections.Counter() if sites else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if func is not _DEVICE:
            # a composite op (``matmul`` under inference mode) is counted
            # as the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        leaves, _ = tree_flatten((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in leaves):
            return out
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops
            if self.sites is not None and flops:
                self.sites["flops", site()] += flops
        name = packet.__name__
        if not (func.is_view or name in _NO_DATA):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        kind = COLLECTIVES.get(name) if func.namespace in (
            "_c10d_functional", "_dtensor") else None
        if kind is not None:
            moved = _nbytes(out) * COLLECTIVE_FACTOR.get(kind, 1)
            self.collectives[kind] = self.collectives.get(kind, 0) + moved
            self.collective_t += moved / link_bw(_group_size(args))
            if self.sites is not None:
                self.sites[kind, site()] += moved
        return out


@contextlib.contextmanager
def _uncounted_sharding_propagation():
    """DTensor runs each new op, or its decomposition, once more on meta
    tensors at the global shapes to choose placements and learn the
    output's shape (``ShardingPropagator``): run that with no mode
    active, so that no device's count includes it.  The propagator's
    cache starts empty (and is emptied again on exit), so every op of
    the step is propagated through the quiet path."""
    prop = DTensor._op_dispatcher.sharding_propagator
    names = ("propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")

    def quiet(run):
        def call(*args, **kwargs):
            with _disable_current_modes():
                return run(*args, **kwargs)
        return call

    cached = prop.propagate_op_sharding
    for name in names:
        setattr(prop, name, quiet(getattr(prop, name)))
    prop.propagate_op_sharding = type(cached)(
        prop.propagate_op_sharding_non_cached)
    clear_propagation_cache()
    try:
        yield
    finally:
        for name in names:
            delattr(prop, name)
        prop.propagate_op_sharding = cached
        clear_propagation_cache()


def link_bw(cards: int) -> float:
    """The per-card rate a collective over ``cards`` cards moves at:
    NVLink within one node, InfiniBand across nodes."""
    return NVLINK_BW if cards <= NODE_CARDS else IB_BW


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name (its
    last string argument; a reduction's op is a string too)."""
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def count(fn: Callable[[], object], sites: bool = False) -> StepCounter:
    """The counts of running ``fn``; with ``sites``, by site too (under
    anomaly mode, which records where each backward node's forward ran)."""
    with contextlib.ExitStack() as stack:
        if sites:
            stack.enter_context(warnings.catch_warnings())
            warnings.filterwarnings("ignore", "Anomaly Detection")
            stack.enter_context(torch.autograd.detect_anomaly(
                check_nan=False))
        stack.enter_context(_uncounted_sharding_propagation())
        counter = stack.enter_context(StepCounter(sites))
        fn()
    return counter


def measure(fn: Callable[[], object]) -> Tuple[int, int]:
    """(matrix-product FLOPs, unfused bytes) of running ``fn``."""
    c = count(fn)
    return c.flops, c.bytes


# --------------------------------------------------------------------------
# Step functions and their arguments
# --------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig):
    """The model on the meta device: every parameter's shape and dtype,
    no storage and no generator draws."""
    return model_mod.module(cfg, META)


@dataclasses.dataclass
class Case:
    """A step on meta tensors and its arguments: (label, shape, dtype,
    logical axes) of every argument leaf, and the leaves themselves
    (DTensors where the case is placed)."""
    fn: Callable[[], object]
    arguments: List[Tuple[str, Tuple[int, ...], torch.dtype, Tuple]]
    param_elements: int
    tensors: List[torch.Tensor]


def _leaves(prefix: str, tensors: Dict, axes: Dict) -> List:
    out = []
    for name, t in tensors.items():
        if isinstance(t, dict):
            out += _leaves(f"{prefix}{name}.", t, axes[name])
        else:
            out.append((prefix + name, tuple(t.shape), t.dtype, axes[name]))
    return out


def _flat(tree) -> List[torch.Tensor]:
    leaves, _ = tree_flatten(tree)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def build_case(cfg: ModelConfig, shape: ShapeConfig, remat: bool = True,
               mesh: Optional[Mesh] = None,
               rules: Optional[ShardingRules] = None) -> Case:
    """The reference's step for ``shape.mode`` on meta tensors, with its
    arguments' logical axes (parameters by ``dist.sharding.axes_of``,
    the batch over ``batch``, the cache by ``model.cache_logical_axes``).
    On a ``mesh`` with a ``DeviceMesh`` (inside ``mesh.fake_group``) the
    parameters, AdamW's moments, the batch and the cache are placed by
    ``rules``, and the step runs under ``axis_rules(mesh, rules)``."""
    placed = mesh is not None and mesh.device_mesh is not None
    lm = abstract_params(cfg)
    boxed = unbox(lm)
    param_axes = axes_of(lm)
    params = _leaves("params.", boxed, param_axes)
    n_elements = sum(math.prod(s) for _, s, _, _ in params)
    B, S = shape.global_batch, shape.seq_len
    where = dict(mesh=mesh, rules=rules) if placed else {}
    if placed:
        distribute(lm, mesh, rules)
    tensors = list(lm.parameters())

    def run(step):
        def fn():
            with (axis_rules(mesh, rules) if placed
                  else contextlib.nullcontext()):
                step()
        return fn

    if shape.mode == "train":
        opt = AdamW()
        lm.requires_grad_(True)
        named = dict(lm.named_parameters())
        state = opt.init(named)
        batch = model_mod.make_inputs(cfg, B, S, device=META, **where)
        args = params + [("opt.step", tuple(state.step.shape),
                          state.step.dtype, ())]
        for moment in ("m", "v"):
            args += [(f"opt.{moment}.{key}", shape_, opt.state_dtype, axes)
                     for key, shape_, _, axes in
                     _leaves("", boxed, param_axes)]
        args += _leaves("batch.", batch, model_mod.batch_axes(batch))
        tensors += ([state.step] + _flat(state.m) + _flat(state.v)
                    + _flat(batch))

        def train_step():
            loss = model_mod.loss_fn(cfg, lm, batch, remat=remat)
            loss.backward()
            opt.step_(named, {n: p.grad for n, p in named.items()}, state)

        return Case(run(train_step), args, n_elements, tensors)

    if shape.mode == "prefill":
        batch = model_mod.make_inputs(cfg, B, S, device=META, **where)

        def prefill_step():
            with torch.no_grad():
                model_mod.forward(cfg, lm, batch, return_cache=True)

        return Case(run(prefill_step),
                    params + _leaves("batch.", batch,
                                     model_mod.batch_axes(batch)),
                    n_elements, tensors + _flat(batch))

    # decode: one token against a full cache
    window = window_for(cfg, shape)
    cache = model_mod.init_decode_cache(cfg, B, S, window=window,
                                        device=META, **where)
    inputs = {"tokens": torch.empty((B, 1), dtype=torch.int32, device=META),
              "cur": torch.empty((B,), dtype=torch.int32, device=META)}
    input_axes = {"tokens": ("batch", None), "cur": ("batch",)}
    if placed:
        inputs = place_tree(inputs, input_axes, mesh, rules)

    def decode_step():
        with torch.no_grad():
            model_mod.decode_step(cfg, lm, inputs["tokens"], cache,
                                  inputs["cur"], window=window)

    args = (params + _leaves("cache.", cache,
                             model_mod.cache_logical_axes(cache))
            + _leaves("", inputs, input_axes))
    return Case(run(decode_step), args, n_elements,
                tensors + _flat(cache) + _flat(inputs))


def argument_bytes(case: Case, mesh: Mesh, rules: ShardingRules) -> int:
    """The bytes of the step's arguments held by one device of ``mesh``:
    each leaf's shard under ``rules`` (``local_shape``, rounded up)."""
    return sum(math.prod(local_shape(shape, rules.spec(axes, mesh), mesh))
               * dtype.itemsize
               for _, shape, dtype, axes in case.arguments)


def local_argument_bytes(case: Case) -> int:
    """The bytes of the step's arguments as this rank holds them: each
    DTensor's local shard, each plain tensor whole."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in case.tensors)


@contextlib.contextmanager
def model_flags(opts):
    """The model flags ``opts`` turn on, restored on exit."""
    saved = flags.ATTN_BF16_STREAM, flags.MOE_DECODE_DISPATCH
    flags.ATTN_BF16_STREAM = "bf16_stream" in opts
    flags.MOE_DECODE_DISPATCH = "moe_dispatch" in opts
    try:
        yield
    finally:
        flags.ATTN_BF16_STREAM, flags.MOE_DECODE_DISPATCH = saved


def check_opts(opts) -> None:
    for opt in sorted(opts):
        if opt in REFUSED:
            raise ValueError(f"--opts {opt} is refused: {REFUSED[opt]}")
        if opt not in OPTS:
            raise ValueError(f"unknown opt {opt!r}; known: {OPTS}")


# --------------------------------------------------------------------------
# Runner
# --------------------------------------------------------------------------

def model_flops_per_device(cfg: ModelConfig, shape: ShapeConfig,
                           chips: int) -> float:
    """6 N_active per trained token, 2 per prefilled or decoded one."""
    tokens = shape.global_batch * (1 if shape.mode == "decode"
                                   else shape.seq_len)
    mult = 6 if shape.mode == "train" else 2
    return mult * cfg.active_param_count() * tokens / chips


def cut_depth(cfg: ModelConfig, layers: Optional[int]) -> ModelConfig:
    """``cfg`` at ``layers`` layers (all of them for None); a MoE model
    keeps at least one MoE layer behind its dense ones."""
    if layers is None:
        return cfg
    dense = min(cfg.num_dense_layers, max(layers - 1, 0))
    return dataclasses.replace(cfg, num_layers=layers,
                               num_dense_layers=dense)


def run_case(arch: str, shape_name: str, mesh: str = "local",
             remat: bool = True, verbose: bool = True,
             opts=frozenset(), layers: Optional[int] = None,
             sites: bool = False) -> Dict:
    """One case on ``mesh``; a production mesh's inside a fake process
    group of its size.  ``layers`` cuts the depth (``cut_depth``);
    ``sites`` adds the counts by site (``StepCounter.sites``)."""
    check_opts(opts)
    cfg = cut_depth(get_arch(arch), layers)
    shape = get_shape(shape_name)
    m = MESHES[mesh]()
    rules = rules_for(cfg, shape, m.shape["model"], opts=opts)
    t0 = time.perf_counter()
    with (fake_group(m.size) if m.size > 1 else contextlib.nullcontext()), \
            model_flags(opts):
        m = MESHES[mesh]()
        case = build_case(cfg, shape, remat=remat, mesh=m, rules=rules)
        counts = count(case.fn, sites)
        local_bytes = local_argument_bytes(case)
    arg_bytes = argument_bytes(case, m, rules)
    peak = PEAK_FLOPS_FP32 if cfg.dtype == "float32" else PEAK_FLOPS
    terms = {"compute": counts.flops / peak,
             "memory": counts.bytes / HBM_BW,
             "collective": counts.collective_t}
    model_flops = model_flops_per_device(cfg, shape, m.size)
    result = {
        "arch": arch, "shape": shape_name, "opts": sorted(opts),
        "mesh": mesh, "chips": m.size, "layers": cfg.num_layers,
        # DTensor chooses a placed case's collectives, and its choices
        # differ between versions
        "torch": torch.__version__,
        "trace_s": time.perf_counter() - t0,
        "params": cfg.param_count(),
        "param_elements": case.param_elements,
        "argument_bytes_per_device": arg_bytes,
        "local_argument_bytes": local_bytes,
        "fits": arg_bytes <= HBM_BYTES,
        "flops_per_device": counts.flops,
        "bytes_per_device": counts.bytes,
        "collective_bytes_per_device": sum(counts.collectives.values()),
        "collectives": dict(counts.collectives),
        "compute_t": terms["compute"],
        "memory_t": terms["memory"],
        "collective_t": terms["collective"],
        "bottleneck": max(terms, key=terms.get),
        "model_flops_per_device": model_flops,
        "useful_flops_frac": (model_flops / counts.flops if counts.flops
                              else None),
    }
    if sites:
        result["sites"] = counts.sites
    if verbose:
        print(format_case(result), flush=True)
    return result


def format_case(r: Dict) -> str:
    useful = r["useful_flops_frac"]
    return (f"[{r['arch']} x {r['shape']} @ {r['mesh']}] "
            f"params {r['params'] / 1e9:.3f} B, arguments "
            f"{r['argument_bytes_per_device'] / 1e9:.3f} GB/device "
            f"({'fits' if r['fits'] else 'does not fit'} 80 GB), "
            f"{r['flops_per_device'] / 1e9:.1f} GFLOP, "
            f"{r['bytes_per_device'] / 1e9:.1f} GB accessed, "
            f"{r['collective_bytes_per_device'] / 1e9:.3f} GB collective; "
            f"compute {r['compute_t'] * 1e3:.2f} ms, memory "
            f"{r['memory_t'] * 1e3:.2f} ms, collective "
            f"{r['collective_t'] * 1e3:.2f} ms, {r['bottleneck']}-bound, "
            f"useful {'-' if useful is None else f'{useful:.3f}'}, traced "
            f"in {r['trace_s']:.1f} s"
            + (f", torch {r['torch']}" if r["chips"] > 1 else ""))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="local", choices=sorted(MESHES))
    ap.add_argument("--opts", nargs="*", default=[])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    opts = frozenset(args.opts)
    try:
        check_opts(opts)
    except ValueError as e:
        ap.error(str(e))

    if args.all:
        cases = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cases = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    results = []
    for a, s in cases:
        try:
            results.append(run_case(a, s, mesh=args.mesh,
                                    remat=not args.no_remat, opts=opts))
        except Exception as e:  # record failures; they are bugs to fix
            print(f"[{a} x {s}] FAILED: {type(e).__name__}: {e}",
                  flush=True)
            results.append({"arch": a, "shape": s, "error": str(e)})
            if not args.all:
                raise
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    nfail = sum(1 for r in results if "error" in r)
    print(f"{len(results) - nfail}/{len(results)} cases traced OK")
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())
