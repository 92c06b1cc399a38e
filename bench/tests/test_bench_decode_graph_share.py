"""``decode_graph_share``, the share of the window's decodes that were one
launch of the engine's CUDA graph: by hand on the ring and window of
``test_bench_engine_metrics``, nothing where the program captures no
graph or keeps no spans, and nothing in a tiny run on the CPU, whose
engine decodes op by op."""
import sys
import time

import pytest
import torch

from bench.harness import runner, spec
from bench.tests.test_bench_engine_metrics import (  # noqa: F401
    BENCH, Maker, fill, reader, ring, root, run_of)

torch.set_num_threads(1)

CELLS = ["starcoder2-7b.repo-completion", "zamba2-7b.long-doc",
         "starcoder2-7b.long-context"]


def fill_replays(ring, replayed, captured=True):
    """``fill``'s ring with, before the window, the capture of the
    decode's graph (``captured``) and, inside each of the window's
    decodes among ``replayed`` (steps 1-3), a ``serve.replay`` beside
    its sample."""
    fill(ring)
    s = Maker(ring)
    s.seq = ring.added
    decodes = [sp for sp in ring.spans if sp[2] == "serve.decode"]
    if captured:
        st = s("serve.step", -50, -10, 0, n=4)
        dec = s("serve.decode", -40, -10, 0, n=4, parent=st)
        s("serve.capture", -40, -30, 0, parent=dec)
    starts = {1: 120, 2: 221, 3: 500}
    for sp in decodes:
        if sp[5] in replayed:
            t = starts[sp[5]]
            s("serve.replay", t, t + 1, sp[5], n=4, parent=sp[0])


@pytest.mark.parametrize("replayed,captured,want", [
    ({1, 2, 3}, True, 100.0),       # every decode one graph launch
    ({1, 2, 3}, False, 100.0),      # the capture dropped from the ring
    ({2}, True, 100 / 3),
    (set(), True, 0.0),             # captured, then never replayed
    (set(), False, None),           # a program that captures nothing
])
def test_decode_graph_share_by_hand(ring, replayed, captured, want):
    fill_replays(ring, replayed, captured)
    got = reader("decode_graph_share")(run_of())
    assert got == (None if want is None else pytest.approx(want))
    # the dispatch reads the decode less its sample, replay or not
    assert reader("decode_dispatch_ms")(run_of()) == pytest.approx(83 / 3)


def test_decode_graph_share_reads_nothing_without_spans(ring, monkeypatch):
    import repro_torch
    assert reader("decode_graph_share")(run_of()) is None
    fill_replays(ring, {1, 2, 3})
    assert reader("decode_graph_share")(run_of(700, 1000)) is None
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert reader("decode_graph_share")(run_of()) is None


@pytest.mark.parametrize("cell", CELLS)
def test_decode_graph_share_belongs_to_every_cell(cell):
    names = [m["name"] for m in spec.load_cell(BENCH.parent, cell).per_layer]
    assert "decode_graph_share" in names


@pytest.mark.parametrize("cell", ["tiny-dense.short", "tiny-hybrid.short"])
def test_a_tiny_cpu_run_reports_no_decode_graph_share(root, cell):
    out = runner.execute(root, spec.load_cell(root, cell), 1, 1.0, True,
                         "cpu", time.perf_counter(), clock=time.perf_counter)
    assert out["correct"], out["check"]
    assert "decode_dispatch_ms" in out["metrics"]
    assert "decode_graph_share" not in out["metrics"]
