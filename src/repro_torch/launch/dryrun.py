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

Each step runs under ``torch.utils.flop_counter.FlopCounterMode`` and
:class:`ByteCounter`, a dispatch mode that sums every op's tensor input
and output bytes, views skipped.  The FLOPs are matrix products only
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
N_active`` per served one).  On a production mesh (16x16, 2x16x16) it
reports only what it can compute exactly: the argument bytes per device,
from ``rules_for``'s specs and ``dist.sharding.local_shape``, and the
model FLOPs per device.  The measured FLOPs, bytes and the collective
term need a partitioner, which the port does not have: they read None.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist.sharding import (LONG_CTX_RULES, SERVE_RULES,
                                       TRAIN_RULES, ShardingRules, axes_of,
                                       local_shape, unbox)
from repro_torch.launch.hlo_analysis import (HBM_BW, HBM_BYTES, PEAK_FLOPS,
                                             PEAK_FLOPS_FP32)
from repro_torch.launch.mesh import (Mesh, make_local_mesh,
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
                          "decode cache update; the port writes the cache "
                          "slot in place and has no partitioner"}


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
            "new_empty", "new_empty_strided"}


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums each op's tensor input and output bytes (an in-place op's
    operand counts as read and as written); views and allocations that
    write nothing are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view
                or func.overloadpacket.__name__ in _NO_DATA):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def measure(fn: Callable[[], object]) -> Tuple[int, int]:
    """(matrix-product FLOPs, unfused bytes) of running ``fn``."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        fn()
    return flops.get_total_flops(), nbytes.bytes


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
    logical axes) of every argument leaf."""
    fn: Callable[[], object]
    arguments: List[Tuple[str, Tuple[int, ...], torch.dtype, Tuple]]
    param_elements: int


def _leaves(prefix: str, tensors: Dict, axes: Dict) -> List:
    out = []
    for name, t in tensors.items():
        if isinstance(t, dict):
            out += _leaves(f"{prefix}{name}.", t, axes[name])
        else:
            out.append((prefix + name, tuple(t.shape), t.dtype, axes[name]))
    return out


def _batch_axes(batch: Dict) -> Dict:
    return {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in batch.items()}


def build_case(cfg: ModelConfig, shape: ShapeConfig,
               remat: bool = True) -> Case:
    """The reference's step for ``shape.mode`` on meta tensors, with its
    arguments' logical axes (parameters by ``dist.sharding.axes_of``,
    the batch over ``batch``, the cache by ``model.cache_logical_axes``)."""
    lm = abstract_params(cfg)
    boxed = unbox(lm)
    param_axes = axes_of(lm)
    params = _leaves("params.", boxed, param_axes)
    n_elements = sum(math.prod(s) for _, s, _, _ in params)
    B, S = shape.global_batch, shape.seq_len

    if shape.mode == "train":
        opt = AdamW()
        lm.requires_grad_(True)
        named = dict(lm.named_parameters())
        state = opt.init(named)
        batch = model_mod.make_inputs(cfg, B, S, device=META)
        args = params + [("opt.step", tuple(state.step.shape),
                          state.step.dtype, ())]
        for moment in ("m", "v"):
            args += [(f"opt.{moment}.{key}", shape_, opt.state_dtype, axes)
                     for key, shape_, _, axes in
                     _leaves("", boxed, param_axes)]
        args += _leaves("batch.", batch, _batch_axes(batch))

        def train_step():
            loss = model_mod.loss_fn(cfg, lm, batch, remat=remat)
            loss.backward()
            opt.step_(named, {n: p.grad for n, p in named.items()}, state)

        return Case(train_step, args, n_elements)

    if shape.mode == "prefill":
        batch = model_mod.make_inputs(cfg, B, S, device=META)

        def prefill_step():
            with torch.inference_mode():
                model_mod.forward(cfg, lm, batch, return_cache=True)

        return Case(prefill_step,
                    params + _leaves("batch.", batch, _batch_axes(batch)),
                    n_elements)

    # decode: one token against a full cache
    window = window_for(cfg, shape)
    cache = model_mod.init_decode_cache(cfg, B, S, window=window,
                                        device=META)
    tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
    cur = torch.empty((B,), dtype=torch.int32, device=META)
    inputs = {"tokens": tokens, "cur": cur}

    def decode_step():
        with torch.inference_mode():
            model_mod.decode_step(cfg, lm, tokens, cache, cur, window=window)

    args = (params + _leaves("cache.", cache,
                             model_mod.cache_logical_axes(cache))
            + _leaves("", inputs, {"tokens": ("batch", None),
                                   "cur": ("batch",)}))
    return Case(decode_step, args, n_elements)


def argument_bytes(case: Case, mesh: Mesh, rules: ShardingRules) -> int:
    """The bytes of the step's arguments held by one device of ``mesh``:
    each leaf's shard under ``rules`` (``local_shape``, rounded up)."""
    return sum(math.prod(local_shape(shape, rules.spec(axes, mesh), mesh))
               * dtype.itemsize
               for _, shape, dtype, axes in case.arguments)


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


def run_case(arch: str, shape_name: str, mesh: str = "local",
             remat: bool = True, verbose: bool = True,
             opts=frozenset()) -> Dict:
    check_opts(opts)
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    m = MESHES[mesh]()
    rules = rules_for(cfg, shape, m.shape["model"], opts=opts)
    t0 = time.perf_counter()
    with model_flags(opts):
        case = build_case(cfg, shape, remat=remat)
        flops = nbytes = None
        if m.size == 1:   # a partitioner would be needed to split the count
            flops, nbytes = measure(case.fn)
    arg_bytes = argument_bytes(case, m, rules)
    peak = PEAK_FLOPS_FP32 if cfg.dtype == "float32" else PEAK_FLOPS
    compute_t = flops / peak if flops is not None else None
    memory_t = nbytes / HBM_BW if nbytes is not None else None
    model_flops = model_flops_per_device(cfg, shape, m.size)
    result = {
        "arch": arch, "shape": shape_name, "opts": sorted(opts),
        "mesh": mesh, "chips": m.size,
        "trace_s": time.perf_counter() - t0,
        "params": cfg.param_count(),
        "param_elements": case.param_elements,
        "argument_bytes_per_device": arg_bytes,
        "fits": arg_bytes <= HBM_BYTES,
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "collective_bytes_per_device": None,
        "compute_t": compute_t,
        "memory_t": memory_t,
        "collective_t": None,
        "bottleneck": None if flops is None else
        ("compute" if compute_t >= memory_t else "memory"),
        "model_flops_per_device": model_flops,
        "useful_flops_frac": model_flops / flops if flops else None,
    }
    if verbose:
        print(format_case(result), flush=True)
    return result


def format_case(r: Dict) -> str:
    head = (f"[{r['arch']} x {r['shape']} @ {r['mesh']}] "
            f"params {r['params'] / 1e9:.3f} B, arguments "
            f"{r['argument_bytes_per_device'] / 1e9:.3f} GB/device "
            f"({'fits' if r['fits'] else 'does not fit'} 80 GB)")
    if r["flops_per_device"] is None:
        return head + ", FLOPs and bytes not measured (no partitioner)"
    return (head + f", {r['flops_per_device'] / 1e9:.1f} GFLOP, "
            f"{r['bytes_per_device'] / 1e9:.1f} GB accessed, compute "
            f"{r['compute_t'] * 1e3:.2f} ms, memory "
            f"{r['memory_t'] * 1e3:.2f} ms, {r['bottleneck']}-bound, "
            f"useful {r['useful_flops_frac']:.3f}, traced in "
            f"{r['trace_s']:.1f} s")


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
