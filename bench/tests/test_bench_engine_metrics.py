"""The readers of the engine's own spans (``bench/harness/spans.py``): by
hand on a ring and window made up here, nothing where the ring dropped
spans of the window or the program keeps none, and all five in a tiny
run on the real clock."""
import sys
import time
import types

import pytest
import torch

from bench.harness import runner, serve, spec
from bench.tests.tiny import BENCH, make_root

torch.set_num_threads(1)

ENGINE = ["decode_step_ms.engine", "decode_dispatch_ms",
          "prefill_ms_per_ktok.engine", "iw_queue_wait_p50_ms.engine",
          "iw_first_token_hold_p50_ms"]
IW = ["iw_queue_wait_p50_ms.engine", "iw_first_token_hold_p50_ms"]
T0 = 10_000_000_000           # the window opens 10 s into the clock


def reader(name):
    return spec.reader(BENCH.parent, name)


class Maker:
    """Spans by hand into ``ring``, times in ms after ``T0``."""

    def __init__(self, ring):
        self.ring, self.seq = ring, 0

    def __call__(self, name, a, b, step, rid=-1, n=0, parent=-1):
        from repro_torch.tracing import Span
        seq, self.seq = self.seq, self.seq + 1
        self.ring.add(Span(seq, parent, name, T0 + round(a * 1e6),
                           T0 + round(b * 1e6), step, rid, n))
        return seq


def fill(ring):
    """Three window steps and one after it.  IW requests 1 and 2 are due
    in the window and admitted in it, 3 is batch, IW 4 is admitted after
    the window closed."""
    s = Maker(ring)
    s("serve.submit", 10, 10, 0, rid=1)
    st = s("serve.step", 20, 200, 1, n=4)
    ad = s("serve.admit", 20, 120, 1, n=3, parent=st)
    pre = s("serve.prefill", 30, 110, 1, rid=1, n=2000, parent=ad)
    s("serve.first_token", 100, 105, 1, rid=1, parent=pre)
    s("serve.write_slot", 105, 110, 1, rid=1, parent=pre)
    dec = s("serve.decode", 120, 200, 1, n=4, parent=st)
    s("serve.sample", 150, 199, 1, parent=dec)
    s("serve.submit", 210, 210, 1, rid=2)
    st = s("serve.step", 220, 300, 2, n=4)
    s("serve.admit", 220, 221, 2, parent=st)
    dec = s("serve.decode", 221, 300, 2, n=4, parent=st)
    s("serve.sample", 241, 299, 2, parent=dec)
    s("serve.submit", 305, 305, 2, rid=3)
    s("serve.submit", 306, 306, 2, rid=4)
    st = s("serve.step", 310, 600, 3, n=4)
    ad = s("serve.admit", 310, 500, 3, n=2, parent=st)
    for rid, a in ((2, 320), (3, 400)):
        pre = s("serve.prefill", a, a + 80, 3, rid=rid, n=1000, parent=ad)
        s("serve.first_token", a + 70, a + 75, 3, rid=rid, parent=pre)
        s("serve.write_slot", a + 75, a + 80, 3, rid=rid, parent=pre)
    dec = s("serve.decode", 500, 600, 3, n=4, parent=st)
    s("serve.sample", 530, 599, 3, parent=dec)
    st = s("serve.step", 1100, 1300, 4, n=4)
    ad = s("serve.admit", 1100, 1200, 4, n=1, parent=st)
    pre = s("serve.prefill", 1100, 1190, 4, rid=4, n=3000, parent=ad)
    s("serve.first_token", 1180, 1185, 4, rid=4, parent=pre)
    dec = s("serve.decode", 1200, 1300, 4, n=4, parent=st)
    s("serve.sample", 1201, 1299, 4, parent=dec)


def run_of(t0_ms=0.0, t_end_ms=600.0):
    def iw(rid, due_ms):
        return serve.Tracked(types.SimpleNamespace(rid=rid), "iw",
                             10 + due_ms / 1e3)
    w = serve.Window(t0=10 + t0_ms / 1e3, t_end=10 + t_end_ms / 1e3,
                     seconds=0.6, steps=[], requests=[],
                     iw=[iw(1, 5), iw(2, 205), iw(4, 306)],
                     generator_late_s=0.0, drain_end=11.5)
    return types.SimpleNamespace(window=w)


@pytest.fixture
def ring(monkeypatch):
    from repro_torch import tracing
    r = tracing.Ring()
    monkeypatch.setattr(tracing, "RING", r)
    return r


def test_engine_readers_by_hand(ring):
    fill(ring)
    run = run_of()
    # decodes of 80, 79 and 100 ms; the step after the window is left out
    assert reader("decode_step_ms.engine")(run) == pytest.approx(259 / 3)
    # less their samples of 49, 58 and 69 ms
    assert reader("decode_dispatch_ms")(run) == pytest.approx(83 / 3)
    # three prefills of 80 ms over 4,000 prompt tokens
    assert reader("prefill_ms_per_ktok.engine")(run) == pytest.approx(60.0)
    # IW 1: submit 10 -> prefill 30; IW 2: 210 -> 320; IW 4 after the window
    assert reader("iw_queue_wait_p50_ms.engine")(run) == pytest.approx(65.0)
    # IW 1: first token 105 -> step end 200; IW 2: 395 -> 600
    assert reader("iw_first_token_hold_p50_ms")(run) == pytest.approx(150.0)


def test_a_window_without_steps_reads_nothing(ring):
    fill(ring)
    for name in ENGINE:
        assert reader(name)(run_of(700, 1000)) is None
    # a window on another clock (a test's own) holds none of the spans
    for name in ENGINE:
        assert reader(name)(run_of(-1e4, -9e3)) is None


def test_spans_dropped_from_the_window_read_nothing(monkeypatch):
    from repro_torch import tracing
    r = tracing.Ring(capacity=20)
    monkeypatch.setattr(tracing, "RING", r)
    fill(r)
    assert r.dropped and r.dropped_since(T0)
    for name in ENGINE:
        assert reader(name)(run_of()) is None
    # spans dropped before the window opened do not matter
    r = tracing.Ring(capacity=31)
    monkeypatch.setattr(tracing, "RING", r)
    Maker(r)("serve.step", -900, -800, 0)
    Maker(r)("serve.step", -700, -600, 0)
    fill(r)
    assert r.dropped == 2 and not r.dropped_since(T0)
    assert reader("decode_step_ms.engine")(run_of()) == pytest.approx(259 / 3)


def test_a_program_without_spans_reads_nothing(ring, monkeypatch):
    """Where the program has no ``repro_torch.tracing`` (the commit
    before it), every reader returns nothing and raises nothing."""
    import repro_torch
    fill(ring)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    for name in ENGINE:
        assert reader(name)(run_of()) is None


@pytest.mark.parametrize("cell", ["starcoder2-7b.repo-completion",
                                  "zamba2-7b.long-doc",
                                  "starcoder2-7b.long-context"])
def test_the_engine_metrics_belong_to_their_cells(cell):
    names = [m["name"] for m in spec.load_cell(BENCH.parent, cell).per_layer]
    want = ENGINE if cell.endswith("repo-completion") else \
        [n for n in ENGINE if n not in IW]
    assert [n for n in names if n in ENGINE] == want


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny-dense.short", "tiny-hybrid.short"])
def test_a_tiny_run_on_the_real_clock_reports_all_five(root, cell):
    out = runner.execute(root, spec.load_cell(root, cell), 1, 1.0, True,
                         "cpu", time.perf_counter(), clock=time.perf_counter)
    assert out["correct"], out["check"]
    got = {n: out["metrics"][n]["value"] for n in ENGINE
           if n in out["metrics"]}
    assert set(got) == set(ENGINE)
    assert all(v > 0 for v in got.values()), got
    # the decode spans sit inside whole steps, the dispatch inside them
    assert got["decode_dispatch_ms"] < got["decode_step_ms.engine"]
