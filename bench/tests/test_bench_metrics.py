"""Each metric reader's operations and bytes on a hand-worked small case,
and the trace reduction on a hand-made trace."""
import math
import types

import pytest

from bench.families import dense, hybrid
from bench.harness import peaks, serve, spec, trace
from bench.tests.tiny import BENCH

M = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 4,
     "num_kv_heads": 2, "head_dim": 4, "d_ff": 16, "vocab_size": 60,
     "vocab_pad_multiple": 32, "act": "gelu", "dtype": "bfloat16"}
HY = dict(M, family="hybrid", num_layers=5, attn_every=2, num_kv_heads=4,
          ssm_expand=2, ssm_state=4, ssm_headdim=4, ssm_chunk=8,
          act="silu")


def reader(name):
    return spec.reader(BENCH.parent, name)


def module(name):
    import importlib.util
    path = BENCH / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location("m_" + name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_k1_work_by_hand():
    # 2 layers; slots 3, two active at positions 5 and 9, one idle (1 key)
    # keys = 6 + 10 + 1 = 17; per key K and V: 2*2*4*2 bytes + 4 (pos) = 36
    # per slot q and out: 2*4*4*2 + 4 = 68
    flops, nbytes = dense.k1_work(M, [5, 9], 3)
    assert nbytes == 2 * (17 * 36 + 3 * 68)
    assert flops == 2 * 17 * 4 * 4 * 4


def test_k2_work_by_hand():
    # S = 3: 2*H*hd*S*(S+1) = 2*4*4*3*4 = 384 flops per layer
    # q, k, v, o: (2*4 + 2*2)*3*4*2 = 288 bytes, positions 2*3*4 = 24
    flops, nbytes = dense.k2_work(M, 3)
    assert flops == 2 * 384
    assert nbytes == 2 * (288 + 24)


def test_attention_applications_of_the_hybrid():
    assert hybrid.attention_layers(HY) == 3       # after 2, 4 and the last
    assert dense.attention_layers(M) == 2


def test_mfu_weights_and_flops_by_hand():
    mfu = module("mfu")
    # per layer: q, o 8*16 each, k, v 8*8 each = 384; mlp 2*8*16 = 256;
    # head 8*64 = 512 (vocab padded to 64)
    assert dense.matmul_weights(M) == 2 * (384 + 256) + 512
    w = dense.matmul_weights(M)
    # one prefill of 3 tokens and one decode at position 5
    want = 2 * w * 3 + 2 * 2 * 4 * 4 * 3 * 4 + 2 * w + 2 * 4 * 4 * 4 * 6
    assert mfu.step_flops(dense, M, [3], [5]) == want
    # hybrid: ssm 8*(32+8+4) + 16*8 = 480 per layer; 3 attention blocks
    # of 8*16*2 + 8*16*2 = 512 and gated mlp 3*8*16 = 384
    assert hybrid.matmul_weights(HY) == 5 * 480 + 3 * (512 + 384) + 512


def _run(steps, traced=(), tr=None, slots=4, model=M):
    w = serve.Window(t0=0.0, t_end=10.0, seconds=10.0, steps=list(steps),
                     requests=[], iw=[], generator_late_s=0.0, drain_end=10.0)
    return types.SimpleNamespace(model=model,
                                 family=hybrid if model is HY else dense,
                                 slots=slots, setup_s=1.0,
                                 window=w, traced=list(traced), trace=tr)


def test_host_clock_step_metrics_by_hand():
    steps = [serve.StepRec(0.0, 0.1, [], [5]),
             serve.StepRec(0.1, 0.3, [], [6]),
             serve.StepRec(0.3, 0.9, [1000, 500], [7])]
    run = _run(steps)
    assert reader("decode_step_ms")(run) == pytest.approx(150.0)
    # 0.6 s - 0.15 s extra over 1.5 ktok
    assert reader("prefill_ms_per_ktok")(run) == pytest.approx(300.0)
    assert reader("decode_step_ms")(_run(steps[2:])) is None


def test_device_metrics_by_hand():
    tr = trace.Trace(ops=[("flash_fwd_wgmma<128, 128>", 2e-6),
                          ("decode_split_mma<128>", 1e-6),
                          ("decode_combine", 1e-6), ("nvjet_gemm", 5e-6)],
                     busy_s=8e-6, window_s=10e-6, idle_by_host={})
    traced = [serve.StepRec(0.0, 1.0, [3], [5, 9])]
    run = _run([], traced, tr, slots=3)
    assert reader("device_idle")(run) == pytest.approx(20.0)
    f, b = dense.k2_work(M, 3)
    assert reader("k2_roofline")(run) == pytest.approx(
        100 * peaks.bound_s(f, b) / 2e-6)
    f, b = dense.k1_work(M, [5, 9], 3)
    assert reader("k1_roofline")(run) == pytest.approx(
        100 * peaks.bound_s(f, b) / 2e-6)
    # mfu reads the window, not the traced stretch: 10 s of these steps
    steps = [serve.StepRec(0.0, 4.0, [3], [5, 9]),
             serve.StepRec(4.0, 9.0, [], [6, 10])]
    flops = module("mfu").step_flops(dense, M, [3], [5, 9]) \
        + module("mfu").step_flops(dense, M, [], [6, 10])
    assert reader("mfu")(_run(steps, traced, tr)) == pytest.approx(
        100 * flops / (10.0 * peaks.BF16_FLOPS))
    assert reader("mfu")(run) is None
    # no trace: a device reader finds nothing and returns nothing
    assert reader("k1_roofline")(_run([], traced, None)) is None
    # no prefill in the traced steps: K2's reader returns nothing
    assert reader("k2_roofline")(_run([], [serve.StepRec(0, 1, [], [5])],
                                      tr)) is None


def test_kernel_names_keep_their_templates():
    assert trace.short("void (anonymous namespace)::wg::flash_fwd_wgmma"
                       "<128, 128>(CUtensorMap_st, Args)") == \
        "wg::flash_fwd_wgmma<128, 128>"
    assert trace.short("void at::native::(anonymous namespace)::k<4, "
                       "f<(int)3> >(int)") == "at::native::k<4, f<(int)3> >"
    assert trace.short("nvjet_tst_256x152_64x4_2x1_v_bz_coopA_NNT") == \
        "nvjet_tst_256x152_64x4_2x1_v_bz_coopA_NNT"


class _Ev:
    """A raw profiler event (``kineto_results.events()``), times in us."""

    def __init__(self, name, a, b, cuda):
        from torch.autograd import DeviceType
        self._name, self._a, self._b = name, a, b
        self._dev = DeviceType.CUDA if cuda else DeviceType.CPU
        self._annotation = cuda and name in trace.RANGES

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._a * 1000

    def duration_ns(self):
        return (self._b - self._a) * 1000

    def is_user_annotation(self):
        return self._annotation


def test_trace_reduction_by_hand():
    # host ranges, the same ranges on the device timeline, device ops
    events = [_Ev(trace.STEP, 0, 100, False),
              _Ev(trace.STEP, 110, 200, False),
              _Ev("engine.decode", 5, 60, False),
              _Ev("aten::mm", 10, 20, False),
              _Ev(trace.STEP, 0, 100, True), _Ev("engine.decode", 5, 60, True),
              _Ev("void k(int)", 0, 10, True), _Ev("void k(int)", 8, 30, True),
              _Ev("g", 40, 100, True), _Ev("g", 150, 250, True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    t = trace.read(prof)
    assert t.window_s == pytest.approx(200e-6)
    # busy: [0, 30] + [40, 100] + [150, 200] = 140 us
    assert t.busy_s == pytest.approx(140e-6)
    # idle: [30, 40] inside engine.decode (no op at 35), [100, 150]:
    # 100-110 between steps (mid 125 is inside the second step: no op)
    assert t.idle_by_host == pytest.approx(
        {"engine.decode": 10e-6, "python (no op)": 50e-6})
    assert t.seconds("k") == pytest.approx(32e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["g", pytest.approx(160e-6)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_a_trace_of_the_device_alone_spans_its_events():
    # no step ranges: runtime calls on the host, kernels on the device
    events = [_Ev("cudaLaunchKernel", 0, 5, False),
              _Ev("cudaLaunchKernel", 40, 45, False),
              _Ev("k", 4, 20, True), _Ev("k", 44, 60, True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    t = trace.read(prof)
    assert t.window_s == pytest.approx(60e-6)
    assert t.busy_s == pytest.approx(32e-6)
    # idle [0, 4] inside the first launch, [20, 44] with no call in flight
    assert t.idle_by_host == pytest.approx(
        {"cudaLaunchKernel": 4e-6, "python (no op)": 24e-6})
    empty = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: [])))
    assert trace.read(empty).window_s == 0


def test_only_the_longest_gaps_are_named(monkeypatch):
    monkeypatch.setattr(trace, "NAMED_GAPS", 1)
    events = [_Ev(trace.STEP, 0, 100, False), _Ev("aten::mm", 0, 100, False),
              _Ev("g", 10, 20, True), _Ev("g", 50, 60, True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    # idle: [0, 10], [20, 50] and [60, 100]: only the longest is named
    t = trace.read(prof)
    assert t.idle_by_host == pytest.approx(
        {"aten::mm": 40e-6, "gaps under 40 us": 40e-6})


def test_roofline_shares_cannot_pass_100_when_time_is_the_bound():
    f, b = dense.k2_work(M, 3)
    tr = trace.Trace([("flash_fwd", peaks.bound_s(f, b))], 1.0, 1.0, {})
    run = _run([], [serve.StepRec(0, 1, [3], [])], tr)
    assert reader("k2_roofline")(run) == pytest.approx(100.0)
    # the window at the card's peak for its whole 10 s reads 100%
    flops = module("mfu").step_flops(dense, M, [3], [])
    full = _run([serve.StepRec(0.0, 10.0, [3], [])], model=M)
    full.window.t_end = flops / peaks.BF16_FLOPS
    assert reader("mfu")(full) == pytest.approx(100.0)
    assert math.isfinite(reader("mfu")(full))


def test_ssd_scan_time_per_ktok_by_hand():
    tr = trace.Trace(ops=[("ssd_scan", 3e-3), ("ssd_scan_rev", 1e-3),
                          ("nvjet_gemm", 5e-3)],
                     busy_s=9e-3, window_s=1e-2, idle_by_host={})
    traced = [serve.StepRec(0.0, 1.0, [1000, 500], [5]),
              serve.StepRec(1.0, 2.0, [500], [6])]
    # 3 ms of ssd_scan over 2,000 prompt tokens
    assert reader("ssd_scan_ms_per_ktok")(_run([], traced, tr, model=HY)) \
        == pytest.approx(1.5)
    decode_only = [serve.StepRec(0.0, 1.0, [], [5])]
    assert reader("ssd_scan_ms_per_ktok")(
        _run([], decode_only, tr, model=HY)) is None
    assert reader("ssd_scan_ms_per_ktok")(_run([], traced, None)) is None


def test_device_idle_leaves_out_the_host_time_the_profiler_added():
    # the window's decode steps take 0.1 s; the two traced ones took 0.2 s
    # each, so the profiler added 0.2 s of the stretch's 0.5 s
    steps = [serve.StepRec(0.0, 0.1, [], [5]), serve.StepRec(0.1, 0.2, [], [6])]
    traced = [serve.StepRec(1.0, 1.2, [], [7]), serve.StepRec(1.2, 1.4, [], [8])]
    tr = trace.Trace(ops=[("k", 0.15)], busy_s=0.15, window_s=0.5,
                     idle_by_host={})
    # 1 - 0.15 / (0.5 - 0.2); the stretch as traced reads 70%
    assert reader("device_idle")(_run(steps, traced, tr)) == pytest.approx(50.0)
    # traced steps faster than the window predicts add nothing back
    fast = [serve.StepRec(1.0, 1.05, [], [7])]
    assert reader("device_idle")(_run(steps, fast, tr)) == pytest.approx(70.0)


def test_a_stretch_is_held_to_the_window_step_times():
    from bench.harness import runner
    # window: decode steps of 0.1 s; an admitting step of 0.3 s with 1,000
    # prompt tokens, so 0.2 ms a token beyond a decode step
    steps = [serve.StepRec(0.0, 0.1, [], [5]), serve.StepRec(0.1, 0.2, [], [6]),
             serve.StepRec(0.2, 0.5, [1000], [7])]
    w = _run(steps).window
    # predicted 0.1 + 0.2 = 0.3 s for these; they took 0.33 s
    traced = [serve.StepRec(1.0, 1.11, [], [8]),
              serve.StepRec(1.11, 1.33, [500], [9])]
    assert runner.stretch_vs_window(w, traced) == pytest.approx(1.1)
    assert runner.stretch_vs_window(_run(steps[2:]).window, traced) is None
