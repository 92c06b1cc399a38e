"""One run of one cell: set up, measure, check, and report.

1. Set-up: build the cell's kernels, draw the weights from the seed on
   the device and hand them to the port's module, allocate the engine's
   cache, fill every slot (outputs staggered, ``serve.Clients.fill``) and
   run ``warmup_steps`` steps of the cell's own traffic, the IW stream
   included.  All of it counts in ``setup_s``, from process start.
2. The window: ``seconds`` of steps.  With ``trace``, once it closes,
   ``trace_steps`` more steps under ``torch.profiler`` (after
   ``TRACE_WARMUP`` steps that start it); ``info.trace_vs_window`` is
   their host time over what the window's own step times predict.
3. The peak device memory is read, the program freed, and a sample of
   the requests finished inside the window compared with the plain
   reference (``check``).
4. Every metric of the cell is read by its reader
   (``bench/metrics/<name>.py``): the end-to-end ones without a trace,
   the per-layer ones with it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

from bench.harness import check, serve, spec, traffic
from bench.harness import trace as trace_mod
from bench.harness import weights as weights_mod

#: steps the profiler runs before its stretch, so that its start-up
#: falls outside what the device metrics read
TRACE_WARMUP = 2


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    model: Dict
    family: ModuleType   # bench/families/<family>.py
    slots: int
    setup_s: float
    window: serve.Window
    traced: List[serve.StepRec]
    trace: Optional[trace_mod.Trace]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def start(cell: spec.Cell, seed: int, device,
          clock: Callable[[], float] = time.perf_counter,
          marks: Optional[Dict[str, float]] = None) -> serve.Clients:
    """Set the cell up to its filled slots: the kernels built, the weights
    drawn from ``seed`` and handed to the port, the engine and its cache,
    every slot filled by one step.  ``marks`` gets the time each part
    ended."""
    import torch

    from repro_torch.models import model as model_mod
    from repro_torch.serving.engine import ServeRequest, ServingEngine

    marks = {} if marks is None else marks
    m, eng, mix = cell.config["model"], cell.config["engine"], cell.mix
    traffic.check_mix(mix, eng["max_seq"])
    marks["imports"] = time.perf_counter()
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(eng["kernels"])
        torch.cuda.reset_peak_memory_stats()
    marks["build"] = time.perf_counter()
    cfg = cell.family.config(m)
    module = model_mod.module(cfg, "meta")
    weights_mod.load(module,
                     weights_mod.make(cell.family.leaves(m), seed, device))
    engine = ServingEngine(cfg, module, max_batch=mix["slots"],
                           max_seq=eng["max_seq"], scheduler=eng["scheduler"],
                           device=device)
    drv = serve.Clients(engine, mix, seed, m["vocab_size"], ServeRequest,
                       clock)
    marks["weights_and_cache"] = time.perf_counter()
    drv.fill()
    drv.step()
    marks["fill"] = time.perf_counter()
    return drv


def stretch_vs_window(window: serve.Window,
                      traced: List[serve.StepRec]) -> Optional[float]:
    """The traced steps' host time over what the window's own steps
    predict for them (``Window.predict_s``): 1 where the profiler costs
    the host nothing."""
    want = window.predict_s(traced)
    if want is None:
        return None
    return sum(st.end - st.start for st in traced) / want


def execute(root: Path, cell: spec.Cell, seed: int, seconds: float,
            trace: bool, device, t_start: float, control: bool = False,
            clock: Callable[[], float] = time.perf_counter) -> Dict:
    """Run ``cell`` once and return the result line's fields, with the
    check's readings under ``check`` (and the control's, with
    ``control``).  ``clock`` times the steps (tests give a clock of
    their own, so that a run's steps do not depend on the host)."""
    import torch

    m, mix = cell.config["model"], cell.mix
    cuda = torch.device(device).type == "cuda"
    marks: Dict[str, float] = {}
    drv = start(cell, seed, device, clock, marks)
    engine = drv.engine
    drv.start_iw()
    for _ in range(mix["warmup_steps"]):
        drv.step()
    _sync(device)
    marks["warmup"] = time.perf_counter()
    setup_s = marks["warmup"] - t_start
    parts, last = {}, t_start
    for name, t in marks.items():
        parts[name], last = t - last, t

    traced: List[serve.StepRec] = []
    tr: Optional[trace_mod.Trace] = None

    def stretch(until: float) -> None:
        nonlocal tr
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile, schedule

        # On the card only the device's activity is recorded (kernels,
        # copies and the runtime calls that launch them), so the host pays
        # no profiler cost on every operator; the first TRACE_WARMUP steps
        # start the profiler and are left out of the stretch.
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        got: List[trace_mod.Trace] = []
        drv.step_context = lambda: record_function(trace_mod.STEP)
        with trace_mod.ranges(engine), profile(
                activities=acts,
                schedule=schedule(wait=0, warmup=TRACE_WARMUP,
                                  active=mix["trace_steps"], repeat=1),
                on_trace_ready=lambda p: got.append(trace_mod.read(p))) \
                as prof:
            for i in range(TRACE_WARMUP + mix["trace_steps"]):
                rec = drv.step(release_until=until)
                if i >= TRACE_WARMUP:
                    traced.append(rec)
                prof.step()
        drv.step_context = contextlib.nullcontext
        tr = got[0] if got else None

    window = serve.measure(drv, seconds, on_close=stretch if trace else None)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    finished = [check.Served(t.req.prompt, list(t.req.tokens))
                for t in drv.done if window.t0 < t.times[-1] <= window.t_end]
    del engine, drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = Run(m, cell.family, mix["slots"], setup_s, window, traced, tr)
    metrics = {}
    for mt in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(root, mt["name"])(run)
        if value is not None:
            metrics[mt["name"]] = {"value": value, "unit": mt["unit"]}

    sample = check.sample(finished, seed, mix["check_tokens"])
    t_check = time.perf_counter()
    res = check.compare(cell, seed, sample, device, control=control)
    check_s = time.perf_counter() - t_check
    limit = cell.limits["max_logit_gap"]
    correct = bool(sample) and not math.isnan(res.max_gap) \
        and res.max_gap <= limit
    out = {"correct": correct, "attempted": window.attempted(),
           "failed": window.missing(), "metrics": metrics,
           "device": {"count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    plain = sum(1 for st in window.steps if not st.prompts)
    out["info"] = {"setup_s": setup_s, "window_s": window.t_end - window.t0,
                   "steps": len(window.steps), "plain_steps": plain,
                   "admitting_steps": len(window.steps) - plain,
                   "iw_due": len(window.iw),
                   "generator_late_s": window.generator_late_s,
                   "finished": len(finished), "check_s": check_s,
                   "setup_parts_s": parts}
    if traced:
        out["info"]["trace_vs_window"] = stretch_vs_window(window, traced)
    out["check"] = {"max_logit_gap": {"value": res.max_gap, "limit": limit},
                    "requests_compared": res.requests,
                    "tokens_compared": res.tokens}
    if control:
        out["check"]["control_gap"] = res.control_gap
    return out
