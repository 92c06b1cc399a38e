"""The port's own spans (``repro_torch.tracing``) on tiny serving engines.

No JAX: the engine's spans per step (names, nesting, request ids and
counts), the bounded ring and its drops, no profiler work without a
profiler, and the link to a CPU profile's clock.
"""
import dataclasses
from collections import Counter

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.launch.serve import make_requests
from repro_torch.models import model as model_mod
from repro_torch.serving.engine import ServingEngine

ARCHS = ["starcoder2-7b", "zamba2-7b"]
#: the spans a profiler shows as ``record_function`` events
MIRRORED = ("serve.step", "serve.admit", "serve.prefill",
            "serve.first_token", "serve.write_slot", "serve.decode",
            "serve.sample")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    """A fresh ring of the usual capacity for each test."""
    r = tracing.Ring()
    monkeypatch.setattr(tracing, "RING", r)
    return r


def engine(arch, n=5, max_new=4, slots=2):
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                              dtype="float32")
    params = model_mod.init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = ServingEngine(cfg, params, max_batch=slots, max_seq=64,
                        scheduler="dpa", device="cpu")
    reqs = make_requests(cfg, n, max_new=max_new, prompt_len=(4, 20),
                         seed=2)
    for r in reqs:
        eng.submit(r)
    return eng, reqs


@pytest.mark.parametrize("arch", ARCHS)
def test_spans_name_nest_and_count_each_step(arch, ring):
    eng, reqs = engine(arch)
    submits = [s for s in tracing.spans() if s.name == "serve.submit"]
    assert [s.rid for s in submits] == [r.rid for r in reqs]
    assert all(s.t0 == s.t1 and s.parent_seq == -1 for s in submits)
    assert [r.submit_ns for r in reqs] == [s.t0 for s in submits]
    while eng.has_work:
        queued = len(eng.queue)
        before = {r.rid: len(r.tokens) for r in reqs}
        seen = len(ring.spans)
        eng.step()
        new = tracing.spans()[seen:]
        by = {}
        for s in new:
            by.setdefault(s.name, []).append(s)
            assert s.step == eng.step_count
        (step,), (admit,) = by["serve.step"], by["serve.admit"]
        assert step.parent_seq == -1 and admit.parent_seq == step.seq
        assert admit.n == queued
        admitted = [r for r in reqs if r.ttft_step == eng.step_count]
        pre = by.get("serve.prefill", [])
        assert [(p.rid, p.n) for p in pre] == \
            [(r.rid, len(r.prompt)) for r in admitted]
        assert all(p.parent_seq == admit.seq for p in pre)
        for child in ("serve.first_token", "serve.write_slot"):
            kids = by.get(child, [])
            assert [(k.parent_seq, k.rid) for k in kids] == \
                [(p.seq, p.rid) for p in pre]
            assert all(p.t0 <= k.t0 <= k.t1 <= p.t1
                       for k, p in zip(kids, pre))
        decoded = sum(1 for r in reqs if len(r.tokens) - before[r.rid]
                      - (r in admitted) > 0)
        assert step.n == decoded
        if decoded:
            (dec,), (smp,) = by["serve.decode"], by["serve.sample"]
            assert dec.parent_seq == step.seq and dec.n == decoded
            assert smp.parent_seq == dec.seq
            assert admit.t1 <= dec.t0 <= smp.t0 <= smp.t1 <= dec.t1
        else:
            assert "serve.decode" not in by
        assert sum(len(v) for v in by.values()) == \
            2 + 3 * len(pre) + 2 * bool(decoded)
        for r in admitted:
            assert r.ttft_s == pytest.approx((step.t1 - r.submit_ns) / 1e9)
    assert all(r.ttft_s > 0 for r in reqs)
    assert ring.dropped == 0 and not ring.open


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    small = tracing.Ring(capacity=6)
    monkeypatch.setattr(tracing, "RING", small)
    eng, reqs = engine("starcoder2-7b", n=3)
    eng.run()
    total = small.next_seq
    assert total > 6
    assert len(small.spans) == 6 and small.dropped == total - 6
    kept = tracing.spans()
    # the newest spans stay; the latest end among those dropped is known
    assert kept[-1].name == "serve.step"
    assert small.dropped_since(kept[0].t0 - 1)
    assert not small.dropped_since(kept[-1].t1 + 1)
    assert not tracing.Ring().dropped_since(0)


def test_no_profiler_enters_no_record_function(monkeypatch, ring):
    entered = []

    def count(name):
        entered.append(name)
        return tracing._NOOP
    monkeypatch.setattr(tracing, "record_function", count)
    eng, _ = engine("zamba2-7b")
    eng.run()
    assert not entered
    # the kernel ranges: one shared no-op, nothing in the ring
    n = len(ring.spans)
    assert tracing.range("kernel.k1") is tracing.range("kernel.k3")
    with tracing.range("kernel.k2"):
        pass
    assert len(ring.spans) == n and not entered


def _events(prof):
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            out.setdefault(e.name(), []).append(e.start_ns())
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_profiled_spans_start_on_the_profilers_clock(arch, ring):
    """Under a CPU profiler each span is also a ``record_function`` event,
    which starts within 200 us after its span's ``profiler_ns(t0)``; the
    kernel ranges show too."""
    from torch.profiler import ProfilerActivity, profile

    eng, _ = engine(arch)
    eng.step()
    seen = ring.next_seq
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            eng.step()
    spans = [s for s in tracing.spans() if s.seq >= seen]
    events = _events(prof)
    names = Counter(s.name for s in spans)
    assert set(names) == set(MIRRORED)
    for name in MIRRORED:
        starts = sorted(tracing.profiler_ns(s.t0) for s in spans
                        if s.name == name)
        got = events.get(name, [])
        assert len(got) == len(starts), name
        lags = [e - s for e, s in zip(got, starts)]
        assert all(0 <= lag <= 200_000 for lag in lags), (name, lags)
    kernels = {"kernel.k1", "kernel.k2"} | (
        {"kernel.k3"} if arch == "zamba2-7b" else set())
    assert kernels <= set(events)
