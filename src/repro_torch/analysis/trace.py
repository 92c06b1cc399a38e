"""Trace-tier reprolint for the port: contract checks over what the hot programs do.

Counterpart of ``repro.analysis.trace``.  Unlike the AST tier (parsed,
never imported), this tier imports the port's two hot programs, builds
the reference's tiny canonical instances of them and runs them on the
device, CUDA unless asked otherwise:

- the vector engine's segment, ``kernels.ops.bucket_segment``: the
  ``bucket_step`` kernel (``csrc/bucket_step.cu``) on CUDA, its plain
  version ``kernels.ref.bucket_segment_ref`` on the CPU;
- the batched forecast fit, ``control.forecast._fit_arma_batch``: the
  ``arma_fit`` kernel (``csrc/arma_fit.cu``) on CUDA, ``ref.arma_fit_ref``
  on the CPU.

In the reference a ``lax.scan`` body is the audited region; here the
scan body is the kernel, so the audited region is one call from device
inputs to device outputs.  The rules:

- **T1** no host sync inside a segment or a fit: a ``TorchDispatchMode``
  records every ``aten._local_scalar_dense`` (``.item()``, ``float()``
  of a tensor) and every copy of a device tensor to the CPU; on CUDA the
  call also runs under ``torch.cuda.set_sync_debug_mode("error")``,
  which raises on any synchronizing CUDA call (a blocking copy, a
  stream sync).  The host copy of the segment's outputs
  (``VectorBatch._segment``) comes after the region, as in the
  reference;
- **T2** dtype stability: the same dispatch mode records every tensor an
  op takes or returns, and one float64 tensor is a violation (a
  ``torch.from_numpy`` of a float64 array is one as soon as an op reads
  it).  A Python float is no tensor and promotes to the float32 state,
  like the reference's weak literals.  On the CPU the fit's plain
  version runs in numpy, which the dispatch mode does not see;
- **T3** an honest segment-cache key: across the reference's five
  perturbations of the static config, ``_Static.key()`` is held to the
  bytes it stands for, the kernel's ``Layout`` struct and the packed
  per-cell constants (``engine._build_segment``).  A key that differs
  over identical bytes fragments ``_SEG_CACHE``; an equal key over
  different bytes would serve the wrong constants;
- **T4** the carry handoff: each segment writes its carry to a fresh
  buffer (``ops.bucket_segment``), so the contract is that at most two
  carries are alive at once, the input and the output of the segment
  in flight.  Five segments run through the real ``VectorBatch`` loop
  with weak references on every carry; on CUDA ``memory_allocated``
  after segment 4 must also equal its value after segment 1.

A program's first call in a process fills caches (the kernel library,
the fit's bias table), so T1 and T2 audit its second call, the one a
sweep repeats.  Run via ``python -m repro_torch.analysis --trace
[--device cpu]`` or programmatically::

    from repro_torch.analysis.trace import run_trace
    result = run_trace(device="cpu")
    assert not result.violations
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple
from unittest import mock

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import DeviceLike, resolve_device
from repro_torch.analysis.core import Violation

TRACE_RULES = ("T1", "T2", "T3", "T4")

TRACE_RULE_DOCS = {
    "T1": "no host sync inside a segment or a fit",
    "T2": "dtype stability: no float64 tensor in the hot programs",
    "T3": "segment-cache key audit: _Static.key() vs the bytes it stands for",
    "T4": "carry handoff: at most two carries alive, memory flat",
}

#: steps of the canonical fit, and of the fits the T4 run's planner makes
#: (one bias table between them: ``kernels.arma_fit._bias``)
FIT_STEPS = 8
#: segments the T4 run must reach: "after segment 1" and "after segment
#: 4" are read as segments 2 and 5 start
T4_SEGMENTS = 5


# ------------------------------------------------------------- T1 / T2
def _to_cpu(func, args, kwargs) -> bool:
    """Whether this op copies a tensor off a device to the CPU (the two
    ATen ops that move data between devices: ``.to``/``.cpu()`` and
    ``copy_``)."""
    aten = torch.ops.aten
    if func is aten._to_copy.default:
        dst = kwargs.get("device")
        return dst is not None and torch.device(dst).type == "cpu" \
            and args[0].device.type != "cpu"
    if func is aten.copy_.default:
        return args[0].device.type == "cpu" and args[1].device.type != "cpu"
    return False


class DispatchLog(TorchDispatchMode):
    """Records, for every ATen op dispatched while active, the host
    syncs (T1) and the float64 tensors it takes or returns (T2)."""

    def __init__(self):
        super().__init__()
        self.syncs: List[str] = []
        self.float64: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if func is torch.ops.aten._local_scalar_dense.default:
            self.syncs.append(f"{name} (a tensor read on the host: "
                              f".item(), float(), int(), bool())")
        elif _to_cpu(func, args, kwargs):
            self.syncs.append(f"{name}: a device tensor copied to the CPU")
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in ins + outs:
            if t.dtype == torch.float64:
                self.float64.append(f"{name} -> float64 "
                                    f"{tuple(t.shape)}")
        return out


def audit_call(fn: Callable[[], object],
               device: torch.device) -> Tuple[List[str], List[str]]:
    """T1 and T2 core: run ``fn`` once under a :class:`DispatchLog` (and,
    on CUDA, the sync debug mode "error") and return (host syncs,
    float64 leaks).  ``fn``'s inputs must already be on ``device``."""
    log = DispatchLog()
    syncs: List[str] = []
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with log:
            out = fn()
    except RuntimeError as exc:
        if not cuda or "synchroniz" not in str(exc):
            raise
        syncs.append(f"a synchronizing CUDA call: {exc}".splitlines()[0])
        out = None
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev)
    del out
    if cuda:
        torch.cuda.synchronize(device)
    return log.syncs + syncs, log.float64


# ----------------------------------------------------- canonical programs
def canonical_static():
    """The reference's canonical static config: the first profiled
    model, two regions, the unified pool, the default tick.  Returns
    (engine module, ReplicaParams, _Static)."""
    from repro_torch.core.scaling import ReactivePolicy
    from repro_torch.sim.perfmodel import PROFILES
    from repro_torch.sim.simulator import SimConfig
    from repro_torch.sim.vector import engine as eng
    from repro_torch.sim.vector.params import extract

    model = sorted(PROFILES)[0]
    models, regions = [model], ["east", "west"]
    profiles = {model: PROFILES[model]}
    cfg = SimConfig(policy=ReactivePolicy())
    rp = extract(cfg, models, regions, profiles, "trace-tier")
    st = eng._Static(models, regions, rp.pools, profiles, cfg.tick)
    return eng, rp, st


def canonical_segment(device: torch.device) -> Callable[[], object]:
    """One 2-bucket segment of the canonical config, its inputs packed
    on ``device`` as ``VectorBatch`` packs them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import BucketLayout

    eng, rp, st = canonical_static()
    seg = eng._build_segment(st)
    lay, consts = seg["layout"], torch.from_numpy(seg["consts"]).to(device)

    def packed(tree, shapes, offsets, width, lead=1):
        flat = np.zeros((lead, width), np.float32)
        BucketLayout.pack_into(flat, {k: np.asarray(tree[k], np.float32)
                                      for k in shapes}, shapes, offsets)
        return torch.from_numpy(flat).to(device)

    B = 2
    xs = {k: np.zeros((B,) + s, np.float32)
          for k, s in lay.xs_shapes.items()}
    prm = packed(eng._prm(st, rp), lay.prm_shapes, lay.prm_off, lay.K)
    carry = packed(eng._init_carry(st, rp), lay.carry_shapes,
                   lay.carry_off, lay.F)
    xs = packed(xs, lay.xs_shapes, lay.xs_off, lay.X, lead=B)
    return lambda: ops.bucket_segment(lay, consts, prm, carry, xs, 0, B)


def canonical_fit(device: torch.device) -> Callable[[], object]:
    """The reference's canonical fit: a (2, 16) batch, p=2, q=1,
    ``FIT_STEPS`` Adam steps, zero init; ``y`` on ``device``."""
    from repro_torch.control import forecast as fc

    y = torch.zeros((2, 16), dtype=torch.float32, device=device)
    init = {"c": np.zeros((2,), np.float32),
            "phi": np.zeros((2, 2), np.float32),
            "theta": np.zeros((2, 1), np.float32)}
    return lambda: fc._fit_arma_batch(y, init, 2, 1, steps=FIT_STEPS)


# ------------------------------------------------------------------- T3
@dataclasses.dataclass(frozen=True)
class KeyVariant:
    """One point of the static-config grid: the cache key the code
    would use and the bytes the kernel would actually be given."""
    name: str
    key: Tuple
    packed: bytes


def audit_static_key(baseline: KeyVariant,
                     variants: Sequence[KeyVariant]) -> List[str]:
    """T3 core: cross-check cache keys against the packed bytes."""
    msgs = []
    for v in variants:
        same_key = v.key == baseline.key
        same_bytes = v.packed == baseline.packed
        if not same_key and same_bytes:
            msgs.append(
                f"{v.name}: static key differs but the packed layout and "
                f"constants are byte-identical — the key fragments the "
                f"cache (the same constants built and uploaded twice)")
        elif same_key and not same_bytes:
            msgs.append(
                f"{v.name}: packed layout or constants differ under an "
                f"identical static key — the cache would serve the wrong "
                f"constants")
    return msgs


def segment_bytes(eng, st) -> bytes:
    """What a segment's kernel is given for this static config: its
    ``Layout`` struct (passed by value) and the packed constants."""
    from repro_torch.kernels import bucket_step

    seg = eng._build_segment(st)
    return bytes(bucket_step.c_layout(seg["layout"])) \
        + seg["consts"].tobytes()


def key_variant_args():
    """The T3 grid as constructor arguments of ``_Static``: (name, models,
    regions, pools, profiles, dt) for the baseline and the reference's
    five perturbations — three renames, which must change neither the
    key nor the bytes, and two numeric changes, which must change
    both."""
    import dataclasses as dc

    from repro_torch.sim.perfmodel import PROFILES

    _, _, st = canonical_static()
    model = st.models[0]
    prof = PROFILES[model]

    def args(name, models=None, regions=None, pools=None, dt=None,
             profile=None):
        models = list(models or st.models)
        return (name, models, list(regions or st.regions),
                tuple(pools or st.pools),
                {m: (profile or prof) for m in models}, dt or st.dt)

    return [
        args("baseline"),
        args("model renamed", models=[model + "-renamed"]),
        args("regions renamed", regions=["north", "south"]),
        args("pool renamed", pools=("primary",)),
        args("tick doubled", dt=st.dt * 2),
        args("profile prompt_tps doubled",
             profile=dc.replace(prof, prompt_tps=prof.prompt_tps * 2)),
    ]


def engine_key_variants() -> Tuple[KeyVariant, List[KeyVariant]]:
    """The T3 grid: the baseline and its five variants, each with its
    ``_Static.key()`` and its packed bytes."""
    from repro_torch.sim.vector import engine as eng

    out = []
    for name, *args in key_variant_args():
        st = eng._Static(*args)
        out.append(KeyVariant(name, st.key(), segment_bytes(eng, st)))
    return out[0], out[1:]


# ------------------------------------------------------------------- T4
class CarryWatch:
    """Wraps a segment function of ``ops.bucket_segment``'s signature
    and watches the carries it takes and returns: weak references to
    every one (how many are alive when a segment returns) and, on CUDA,
    ``memory_allocated`` as each segment starts."""

    def __init__(self, device: torch.device):
        self.device = device
        self._refs: List[weakref.ref] = []
        self.alive: List[int] = []      # carries alive as each returns
        self.memory: List[int] = []     # bytes allocated as each starts

    def _see(self, t: torch.Tensor) -> None:
        if not any(r() is t for r in self._refs):
            self._refs.append(weakref.ref(t))

    def wrap(self, fn):
        def segment(lay, consts, prm, carry, xs, b0, b1):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                self.memory.append(torch.cuda.memory_allocated(self.device))
            self._see(carry)
            out, ys = fn(lay, consts, prm, carry, xs, b0, b1)
            self._see(out)
            self.alive.append(sum(r() is not None for r in self._refs))
            return out, ys
        return segment


def audit_carries(watch: CarryWatch,
                  segments: int = T4_SEGMENTS) -> List[str]:
    """T4 core: at most two carries alive when any segment returns, and
    on CUDA the same bytes allocated after segment 1 as after segment
    ``segments - 1`` (read as segments 2 and ``segments`` start)."""
    msgs = []
    if len(watch.alive) < segments:
        return [f"only {len(watch.alive)} segment(s) ran; the audit needs "
                f"{segments}"]
    most = max(watch.alive)
    if most > 2:
        msgs.append(
            f"{most} carries alive when a segment returned (per segment: "
            f"{watch.alive}); the contract is two, the input and the "
            f"output of the segment in flight — the loop keeps carries "
            f"of finished segments")
    if watch.device.type == "cuda":
        after_1, after_n = watch.memory[1], watch.memory[segments - 1]
        if after_1 != after_n:
            msgs.append(
                f"memory_allocated after segment {segments - 1} is "
                f"{after_n} B, after segment 1 {after_1} B: a carry or "
                f"another buffer per segment stays alive")
    return msgs


def canonical_vector_run(device: torch.device):
    """A real ``VectorBatch`` over a short trace of the canonical model
    on the ``lt-ua+plan`` stack (the hourly planner fitting
    ``FIT_STEPS`` steps on ``device``): hourly boundaries split it into
    ``T4_SEGMENTS`` segments.  Returns the batch, not yet run."""
    from repro_torch.api import PolicySpec, StackSpec, build_stack
    from repro_torch.sim.vector import VectorBatch
    from repro_torch.sim.workload import REGIONS, WorkloadSpec, generate_trace

    _, _, st = canonical_static()
    models = tuple(st.models)
    spec = StackSpec(models=models, regions=REGIONS, scaler="lt-ua",
                     planner=PolicySpec("sageserve", {
                         "min_instances": 2, "fit_steps": FIT_STEPS}),
                     router="plan", initial_instances=2, spot_spare=8,
                     tick=60.0, drain_grace=(T4_SEGMENTS - 1) * 3600.0)
    trace = generate_trace(WorkloadSpec(days=0.01, scale=0.01, seed=0,
                                        models=models))
    cfg = build_stack(spec, device=device).sim_config()
    return VectorBatch(trace, [cfg], models=list(models),
                       regions=list(REGIONS), control_workers=1,
                       device=device)


def watch_vector_run(batch, device: torch.device) -> CarryWatch:
    """Run ``batch`` with every segment it launches watched."""
    from repro_torch.kernels import ops

    watch = CarryWatch(device)
    with mock.patch.object(ops, "bucket_segment",
                           watch.wrap(ops.bucket_segment)):
        batch.run()
    return watch


# ------------------------------------------------------------------ runner
@dataclasses.dataclass
class TraceCheck:
    rule: str
    target: str
    ok: bool
    detail: str = ""
    seconds: float = 0.0


@dataclasses.dataclass
class TraceResult:
    violations: List[Violation]
    checks: List[TraceCheck]
    elapsed_s: float
    device: str = "cpu"

    def to_json(self) -> Dict:
        return {
            "device": self.device,
            "elapsed_s": round(self.elapsed_s, 2),
            "checks": [dataclasses.asdict(c) for c in self.checks],
            "violations": [v.to_json() for v in self.violations],
        }


def _loc(obj) -> Tuple[str, int]:
    """(display path, line) of a live object, for violation reports."""
    try:
        path = inspect.getsourcefile(obj) or "<unknown>"
        line = inspect.getsourcelines(obj)[1]
    except (TypeError, OSError):
        return "<unknown>", 1
    try:
        path = str(Path(path).resolve().relative_to(Path.cwd()))
    except ValueError:
        pass
    return path, line


def run_trace(device: DeviceLike = None) -> TraceResult:
    """Run T1–T4 over the canonical hot-path instances on ``device``
    (CUDA unless asked otherwise; raises when CUDA is asked for and
    absent) and return every violation (empty = the sweep's performance
    contracts hold)."""
    from repro_torch.control import forecast as fc
    from repro_torch.kernels import ops
    from repro_torch.sim.vector import engine as eng

    dev = resolve_device(device)
    t0 = time.perf_counter()
    checks: List[TraceCheck] = []
    violations: List[Violation] = []

    @contextlib.contextmanager
    def timed(rule, target, file, line):
        msgs: List[str] = []
        t = time.perf_counter()
        yield msgs
        checks.append(TraceCheck(rule, target, not msgs,
                                 "; ".join(msgs)[:300],
                                 time.perf_counter() - t))
        for m in msgs:
            violations.append(Violation(rule, file, line, 0, m))

    targets = (
        ("engine segment", canonical_segment, _loc(ops.bucket_segment),
         "the segment"),
        ("batched forecast fit", canonical_fit, _loc(fc._fit_arma_batch),
         "the fit"))
    for target, build, (file, line), what in targets:
        call = build(dev)
        call()                   # fills the per-process caches
        with timed("T1", target, file, line) as msgs:
            syncs, leaks = audit_call(call, dev)
            msgs += [f"host sync inside {what}: {s}" for s in syncs]
        with timed("T2", target, file, line) as msgs:
            msgs += [f"float64 in {what}: {m}" for m in leaks]

    kfile, kline = _loc(eng._Static.key)
    with timed("T3", "engine _SEG_CACHE static key", kfile, kline) as msgs:
        baseline, variants = engine_key_variants()
        msgs += audit_static_key(baseline, variants)

    sfile, sline = _loc(eng.VectorBatch.run)
    with timed("T4", "engine carry handoff", sfile, sline) as msgs:
        watch = watch_vector_run(canonical_vector_run(dev), dev)
        msgs += audit_carries(watch)

    return TraceResult(violations, checks,
                       elapsed_s=time.perf_counter() - t0, device=str(dev))
