"""The port's vector engine against repro's, on the CPU.

``repro_torch.sim.vector`` steps buckets with the plain version of the
``bucket_step`` kernel (``kernels.ref.bucket_segment_ref``): PyTorch on
tensors with a leading replica dimension, every reduction in a fixed
order.  The reference runs ``_build_step`` under ``lax.scan`` and lets
XLA order its sums, so the two agree to float32 rounding, not bit for
bit:

- The step, one bucket and a 240-bucket segment, on the seeded inputs
  of ``bucket_step.synthetic_case`` for every mode, unified and siloed
  pools, a ring collision, a region down with a dead model, and 8
  models x 2 pools: each key within 1e-6 of its largest magnitude
  (``STEP_TOL``; max norm, since ``f_tok - rel_tok`` and the queues
  cancel to values near 0 whose error is an ulp of the operands).
  Measured: 2.3e-7 after one bucket, 6.0e-7 after 240.
- Runs: the golden trace (``tests/test_vector_sim.py``'s stack) and
  ``WorkloadSpec(days=0.1, scale=0.01, seed=3)``: completed and dropped
  counts equal, instance-hours and gpu_dollars within ``RUN_RTOL``
  (measured: equal).
- The reference's invariants hold on the port: repeats, a batch of one
  against the unbatched path and batch members against their solo runs
  are equal field for field; siloed LT is refused; an hourly plan
  crosses into array state; LT-I targets actuate like the event loop.
- An ``lt-ua+plan`` run through ``simulate_vector`` (its forecast fits
  on the plain ARMA fit) against the reference's.
"""
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

from repro.api import StackSpec as RefStackSpec
from repro.api import build_stack as ref_build_stack
from repro.core.queue_manager import QueueManager as RefQueueManager
from repro.core.scaling import make_policy as ref_make_policy
from repro.sim import workload as ref_workload
from repro.sim.metrics import report_to_dict as ref_report_to_dict
from repro.sim.simulator import SimConfig as RefSimConfig
from repro.sim.vector import VectorBatch as RefVectorBatch
from repro.sim.vector import engine as ref_engine
from repro_torch.api import PolicySpec, StackSpec, build_stack
from repro_torch.api.plan import Plan, RoutingPlan
from repro_torch.core.queue_manager import QueueManager
from repro_torch.core.scaling import make_policy
from repro_torch.kernels import bucket_step, ref
from repro_torch.sim import workload
from repro_torch.sim.metrics import report_to_dict
from repro_torch.sim.simulator import SimConfig, Simulation
from repro_torch.sim.vector import (VectorBatch, VectorSimulation,
                                    VectorUnsupported)
from repro_torch.sim.vector import engine

torch.set_num_threads(1)

STEP_TOL = 1e-6          # max |port - JAX| / max |JAX| per key; measured 6.0e-7
RUN_RTOL = 1e-4          # instance-hours and gpu_dollars; measured 0
COMPLETION_ABS_TOL = 0.02    # the reference's vector-vs-event contract
HOURS_REL_TOL = 0.10
MODES = tuple(bucket_step.MODES)
GOLDEN = str(pathlib.Path(__file__).parent / "golden" / "trace_small.csv.gz")


# ------------------------------------------------------------------ step
def _jax_segment(lay, consts, prm, carry, xs, b0, n):
    """The reference step under ``lax.scan`` (``jax.vmap`` over
    replicas) on a static config carrying the case's per-cell constants.
    Returns each bucket's input carry (n, R, ...), the final carry and
    the ys (n, R, ...), as numpy."""
    cs = lay.consts(consts)
    pm = np.zeros((lay.M, lay.C))
    for m in range(lay.M):
        pm[m, m * lay.P:(m + 1) * lay.P] = 1.0
    st = types.SimpleNamespace(
        C=lay.C, J=lay.J, L=lay.L, LD=lay.LD, dt=lay.dt, kv=cs["kv"],
        ptps=cs["ptps"], tbt0=cs["tbt0"], alpha=cs["alpha"], mb=cs["mb"],
        swap_b=cs["swap_b"].astype(np.int32),
        local_b=cs["local_b"].astype(np.int32),
        remote_b=cs["remote_b"].astype(np.int32), pm=pm,
        cell_model=np.repeat(np.arange(lay.M), lay.P))
    step = ref_engine._build_step(st)

    def body(p, c, x):
        out, ys = step(p, c, x)
        return out, (c, ys)

    p = {k: v.copy() for k, v in lay.prm(prm).items()}
    p["mode"] = p["mode"].astype(np.int32)
    c = {k: v.copy() for k, v in lay.carry(carry).items()}
    x = {k: v.copy() for k, v in lay.xs(xs[:n]).items()}
    x["b"] = np.arange(b0, b0 + n, dtype=np.int32)
    out, (ins, ys) = jax.vmap(lambda pp, cc: jax.lax.scan(
        lambda c1, x1: body(pp, c1, x1), cc, x), in_axes=(0, 0))(p, c)
    host = lambda tree: {k: np.asarray(v) for k, v in tree.items()}
    return host(ins), host(out), host(ys)


STEP_CASES = {
    "unified": dict(seed=2, modes=MODES),
    "siloed": dict(seed=3, modes=MODES, P=2),
    "ring collision": dict(seed=5, modes=MODES, collide=True),
    "region down, dead model": dict(seed=7, modes=MODES, down=True,
                                    dead=True),
    "8 models x 2 pools": dict(seed=4, modes=MODES[:3], M=8, P=2),
}


def _errors(got, want, errs):
    """Per key, max |got - want| over the key's largest |want|."""
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-30)
        errs[k] = max(errs.get(k, 0.0),
                      float(np.abs(got[k] - w).max()) / scale)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_reference(case):
    """One bucket from the case's carry, then every bucket of a
    240-bucket segment from the reference's own carry before it.  (Run
    free, the two trajectories agree to 6e-7 until a cell's rounding
    crosses a discontinuity of the model, then part: in the siloed case
    a dead cell's TBT jumps from tbt0 to tbt0 (1 + alpha) once any
    decode work is left, at bucket 97 of replica 4.)"""
    b0, buckets = 3 * 481 - 100, 240       # the segment wraps the ring
    lay, consts, prm, carry, xs = bucket_step.synthetic_case(
        buckets=buckets, **STEP_CASES[case])
    ins, out, ys = _jax_segment(lay, consts, prm, carry, xs, b0, buckets)
    t = torch.from_numpy
    cs, xt = t(consts), t(xs)
    errs = {}
    packed = np.zeros_like(carry)
    for s in range(buckets):
        lay.pack_into(packed, {k: v[:, s] for k, v in ins.items()},
                      lay.carry_shapes, lay.carry_off)
        got_c, got_y = ref.bucket_segment_ref(
            lay, cs, t(prm), t(packed), xt[s:s + 1], b0 + s, b0 + s + 1)
        want_c = ({k: v[:, s + 1] for k, v in ins.items()}
                  if s + 1 < buckets else out)
        _errors(lay.carry(got_c.numpy()), want_c, errs)
        _errors(lay.ys(got_y[:, 0].numpy()),
                {k: v[:, s] for k, v in ys.items()}, errs)
        if s == 0:
            first = max(errs.values())
    worst = max(errs, key=errs.get)
    assert first <= STEP_TOL
    assert errs[worst] <= STEP_TOL, (worst, errs[worst])


def test_segment_is_its_buckets_in_turn():
    """A segment equals its buckets run one launch each (what the
    boundaries of a run cut it into), bit for bit."""
    lay, consts, prm, carry, xs = [
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in bucket_step.synthetic_case(11, MODES, buckets=30)]
    whole_c, whole_y = ref.bucket_segment_ref(lay, consts, prm, carry, xs,
                                              0, 30)
    c, ys = carry, []
    for b0, b1 in ((0, 7), (7, 8), (8, 30)):
        c, y = ref.bucket_segment_ref(lay, consts, prm, c, xs[b0:b1], b0,
                                      b1)
        ys.append(y)
    assert torch.equal(c, whole_c)
    assert torch.equal(torch.cat(ys, dim=1), whole_y)


def test_step_takes_the_bucket_as_a_tensor():
    """The plain step with its bucket index as an int64 tensor (so one
    CUDA graph of it replays any bucket: chip_smoke.PlainStepGraph),
    carried bucket by bucket in static buffers across a wrap of the ring,
    equals the segment, bit for bit."""
    lay, consts, prm, carry, xs = [
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in bucket_step.synthetic_case(12, MODES, buckets=12)]
    b0 = 3 * lay.L - 5
    want_c, want_y = ref.bucket_segment_ref(lay, consts, prm, carry, xs, b0,
                                            b0 + 12)
    c, x = carry.clone(), xs[0].clone()
    b = torch.zeros((), dtype=torch.int64)
    out, y_out = torch.empty_like(carry), torch.empty((carry.shape[0], lay.Y))
    ys = torch.empty((carry.shape[0], 12, lay.Y))
    for s in range(12):
        b.fill_(b0 + s)
        x.copy_(xs[s])
        tree, y = ref.bucket_step_ref(lay, lay.consts(consts), lay.prm(prm),
                                      lay.carry(c), lay.xs(x), b)
        lay.pack_into(out, tree, lay.carry_shapes, lay.carry_off)
        lay.pack_into(y_out, y, lay.ys_shapes, lay.ys_off)
        c.copy_(out)
        ys[:, s].copy_(y_out)
    assert torch.equal(c, want_c)
    assert torch.equal(ys, want_y)


def test_oversized_carry_is_refused():
    lay = ref.BucketLayout(16, 2, 8, 481, 15.0)
    z = torch.zeros
    with pytest.raises(ValueError, match="227 KB"):
        bucket_step.check_args(lay, z(lay.NC), z(1, lay.K), z(1, lay.F),
                               z(1, lay.X), 0, 1)


def _block_kernel_smem(lay):
    """Shared memory of the block-per-replica kernel the bucket step had
    before its warp-per-replica redesign (its ``smem_floats``: the carry,
    parameters, constants and 25 scratch arrays of one bucket), in
    bytes."""
    cj = lay.C * lay.J
    return 4 * (lay.F + lay.K + lay.NC + 25 * cj + cj * lay.J + lay.J
                + lay.M * lay.J + lay.M + 3 * lay.C)


def test_kernel_takes_every_layout_the_block_kernel_took():
    """The warp-per-replica kernel refuses no layout the block-per-replica
    kernel it replaced took (shared memory within 227 KB)."""
    z = torch.zeros
    took = 0
    for L in (1, 31, 32, 33, 96, 121, 481, 1441):
        for J in (1, 2, 3, 5, 8, 13):
            for P in (1, 2, 3):
                for M in (1, 2, 4, 8, 16, 40, 100, 300):
                    lay = ref.BucketLayout(M, P, J, L, 15.0)
                    if _block_kernel_smem(lay) > bucket_step.SMEM_BYTES:
                        continue
                    took += 1
                    bucket_step.check_args(lay, z(lay.NC), z(1, lay.K),
                                           z(1, lay.F), z(1, lay.X), 0, 1)
    assert took > 400


# ------------------------------------------------------------------- runs
def _golden_cfg(mods):
    sim_config, queue, policy = mods
    return sim_config(policy=policy("reactive"), queue_manager=queue(),
                      initial_instances=3, spot_spare=8,
                      drain_grace=3 * 3600.0)


PORT = (SimConfig, QueueManager, make_policy)
REF = (RefSimConfig, RefQueueManager, ref_make_policy)


@pytest.fixture(scope="module")
def golden():
    return (workload.replay_csv(GOLDEN), ref_workload.replay_csv(GOLDEN))


@pytest.fixture(scope="module")
def tiny():
    """Where the port runs alone: 528 buckets of its plain step."""
    return workload.generate_trace(workload.WorkloadSpec(
        days=0.05, scale=0.01, seed=3))


def _tiny_cfg():
    cfg = _golden_cfg(PORT)
    cfg.drain_grace = 3600.0
    return cfg


@pytest.fixture(scope="module")
def small():
    spec = dict(days=0.1, scale=0.01, seed=3)
    return (workload.generate_trace(workload.WorkloadSpec(**spec)),
            ref_workload.generate_trace(ref_workload.WorkloadSpec(**spec)))


def _assert_run_parity(got, want):
    assert got["completed"] == want["completed"]
    assert got["dropped"] == want["dropped"]
    assert sum(want["completed"].values()) > 0
    for k, w in want["instance_hours"].items():
        assert got["instance_hours"][k] == pytest.approx(w, rel=RUN_RTOL), k
    assert got["gpu_dollars_total"] == pytest.approx(
        want["gpu_dollars_total"], rel=RUN_RTOL)


@pytest.mark.parametrize("trace", ["golden", "small"])
def test_run_matches_reference(trace, golden, small):
    port_tr, ref_tr = {"golden": golden, "small": small}[trace]
    got = report_to_dict(VectorSimulation(
        port_tr, _golden_cfg(PORT), name="v", device="cpu").run())
    want = ref_report_to_dict(RefVectorBatch(
        ref_tr, [_golden_cfg(REF)], ["v"], batched=False).run()[0])
    _assert_run_parity(got, want)


def test_repeats_bit_identical(tiny):
    a = report_to_dict(VectorSimulation(tiny, _tiny_cfg(), name="r",
                                        device="cpu").run())
    b = report_to_dict(VectorSimulation(tiny, _tiny_cfg(), name="r",
                                        device="cpu").run())
    assert a == b


def test_batch_of_one_matches_unbatched(tiny):
    single = VectorBatch(tiny, [_tiny_cfg()], ["v"], batched=False,
                         device="cpu").run()[0]
    batched = VectorBatch(tiny, [_tiny_cfg()], ["v"], batched=True,
                          device="cpu").run()[0]
    assert report_to_dict(single) == report_to_dict(batched)


def test_batch_members_independent(tiny):
    """Two replicas in one batch reproduce their solo runs, and an LT-U
    replica between them changes neither."""
    other = _tiny_cfg()
    other.policy = make_policy("lt-u")
    cfgs = [_tiny_cfg(), other, _tiny_cfg()]
    reps = VectorBatch(tiny, cfgs, ["a", "c", "b"], batched=True,
                       device="cpu").run()
    solo = VectorBatch(tiny, [_tiny_cfg()], ["a"], batched=False,
                       device="cpu").run()[0]
    da, db = report_to_dict(reps[0]), report_to_dict(reps[2])
    ds = report_to_dict(solo)
    da["name"] = db["name"] = ds["name"] = "x"
    assert da == db == ds


def test_siloed_lt_unsupported(small):
    cfg = SimConfig(policy=make_policy("lt-ua"), siloed=True,
                    initial_instances=3, spot_spare=8)
    with pytest.raises(VectorUnsupported):
        VectorBatch(small[0], [cfg], ["s"], device="cpu")


# ------------------------------------------------------- control boundary
class _StubController:
    """Deterministic hourly plan: fixed targets + routing split."""

    def __init__(self, targets, fractions=None):
        self.targets = targets
        self.fractions = fractions
        self.calls = 0

    def plan(self, now, instances, history, niw_last_hour_tps):
        self.calls += 1
        routing = (RoutingPlan(fractions=self.fractions)
                   if self.fractions else None)
        return Plan(t=now, targets=dict(self.targets),
                    forecasts={k: 100.0 for k in self.targets},
                    routing=routing)


def test_hourly_plan_crosses_into_array_state(small):
    """A Plan lands in the packed carry as the event loop hands it to
    ``set_targets``/``update_plan``: targets and forecasts in the home
    cells, routing fractions as normalized omega rows; and the carry the
    boundary writes back to the device holds them."""
    from repro_torch.api import resolve
    from repro_torch.api.stack import BuildContext
    from repro_torch.sim.perfmodel import PROFILES
    from repro_torch.sim.vector.buckets import bucketize

    trace = small[0]
    models, regions = list(trace.models), list(trace.regions)
    m0, r0, r1 = models[0], regions[0], regions[1]
    targets = {(m, r): 4 for m in models for r in regions}
    ctl = _StubController(targets, {(m0, r0): {r0: 0.5, r1: 0.5}})
    cfg = SimConfig(policy=make_policy("lt-i"), controller=ctl,
                    initial_instances=2, spot_spare=20)
    ctx = BuildContext(tuple(models), tuple(regions),
                       {m: PROFILES[m] for m in models})
    cfg.router = resolve("router", PolicySpec("plan"), ctx)
    vb = VectorBatch(trace, [cfg], ["plan"], models=models,
                     regions=regions, batched=True, device="cpu")
    st, lay = vb.st, vb.layout
    kv = {m: PROFILES[m].kv_capacity_tokens for m in models}
    horizon = float(trace.arrival[-1]) + cfg.drain_grace
    bk = bucketize(trace, st.dt, horizon, kv, hist_window=cfg.tps_window)
    carry = vb._pack(engine._init_carry(st, vb.rps[0]), lay.carry_shapes,
                     lay.carry_off, lay.F)
    vb.control_stats = {k: 0 for k in ("boundaries", "plans", "forecast_s",
                                       "ilp_s", "transfer_s", "apply_s")}
    vb._fleet = engine.FleetForecast({}, device="cpu")
    vb._pool = None
    carry = vb._hour_round_batched(carry, 3600.0, bk, [])
    assert ctl.calls == 1
    cv = lay.carry(carry[0].numpy())
    for mi, m in enumerate(models):
        for ji, r in enumerate(regions):
            assert cv["tgt"][mi * st.P, ji] == 4.0, (m, r)
            assert cv["fc"][mi * st.P, ji] == 100.0, (m, r)
    row = cv["omega"][0, 0, :]
    assert row[regions.index(r0)] == pytest.approx(0.5)
    assert row[regions.index(r1)] == pytest.approx(0.5)
    assert cv["has_om"][0, 0] == 1.0
    assert cv["has_om"][0, regions.index(r1)] == 0.0
    assert np.array_equal(cv["live"], engine._init_carry(
        st, vb.rps[0])["live"])


def test_lt_targets_actuate_like_event_loop(tiny):
    """The same stub plan drives both engines of the port; the fleets
    they scale to agree (LT-I jumps straight to the hourly target)."""
    trace = tiny
    models, regions = list(trace.models), list(trace.regions)
    targets = {(m, r): 3 for m in models for r in regions}

    def mk_cfg():
        return SimConfig(policy=make_policy("lt-i"),
                         controller=_StubController(targets),
                         initial_instances=2, spot_spare=30,
                         drain_grace=3600.0)

    ev = Simulation(trace.to_requests(), mk_cfg(), models=models,
                    regions=regions, name="ev").run()
    vec = VectorSimulation(trace, mk_cfg(), models=models, regions=regions,
                           name="vec", device="cpu").run()
    ev_ih = sum(ev.instance_hours.values())
    vec_ih = sum(vec.instance_hours.values())
    assert vec_ih == pytest.approx(ev_ih, rel=HOURS_REL_TOL)
    ev_done = sum(ev.completed.values())
    vec_done = sum(vec.completed.values())
    assert abs(vec_done - ev_done) / max(len(trace), 1) <= COMPLETION_ABS_TOL


# ---------------------------------------------------------- plan router
def _plan_stack():
    return dict(models=list(workload.PAPER_MODELS),
                regions=list(workload.REGIONS), scaler="lt-ua",
                router="plan", initial_instances=5, spot_spare=30,
                scheduler="fcfs", drain_grace=3600.0, planner={"name": "sageserve", "kwargs": {
                    "min_instances": 2, "epsilon": 0.8, "fit_steps": 150,
                    "theta_headroom": 0.7, "use_routing": True}})


def test_plan_router_run_matches_reference():
    """``lt-ua+plan`` (``benchmarks/common.py:stack_spec``) over 2.4
    hours (2 hourly plans) and a 1-hour drain through ``simulate_vector``: the fits run on the plain ARMA fit here
    and in JAX there, which round apart (``tests/test_torch_control.py``
    counts the ILP targets that flips), so the Reports are held to
    ``RUN_RTOL`` and equal counts only while no target flips: measured
    equal."""
    spec = dict(days=0.1, scale=0.01, seed=5)
    stack = build_stack(StackSpec.from_dict(_plan_stack()), device="cpu")
    ref_stack = ref_build_stack(RefStackSpec.from_dict(_plan_stack()))
    got = report_to_dict(stack.simulate_vector(
        workload.generate_trace(workload.WorkloadSpec(**spec)),
        name="lt-ua+plan"))
    want = ref_report_to_dict(ref_stack.simulate_vector(
        ref_workload.generate_trace(ref_workload.WorkloadSpec(**spec)),
        name="lt-ua+plan"))
    _assert_run_parity(got, want)
