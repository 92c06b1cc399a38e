"""The port's reprolint trace tier (T1-T4, ``repro_torch.analysis.trace``).

Each T rule is shown twice: it FIRES on a small bad fixture built here
(a loop with ``.item()``, a float64 constant, a key with a phantom field
or one that leaves a field out, a loop that keeps every carry alive),
and it PASSES on the real hot paths, the vector engine's segment and the
batched forecast fit, through one shared ``run_trace(device="cpu")``.
T3's keys are also held to the reference's ``_Static.key()`` for the
same five perturbations.  The card's case (``run_trace("cuda")``, T1
under the sync debug mode) is in ``tests/test_torch_cuda_kernels.py``,
which imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro.sim.perfmodel import PROFILES as REF_PROFILES
from repro.sim.vector import engine as ref_engine
from repro_torch.analysis import trace as tr
from repro_torch.kernels import bucket_step, ops
from repro_torch.sim.vector import engine as eng

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def trace_result():
    return tr.run_trace(device="cpu")


# ------------------------------------------------------------- T1 fires
def test_t1_fires_on_item_in_a_loop():
    x = torch.arange(4, dtype=torch.float32)

    def bad():
        total = torch.zeros(())
        for i in range(3):
            if (x[i] > 0).item():
                total = total + x[i]
        return total

    syncs, leaks = tr.audit_call(bad, CPU)
    assert len(syncs) == 3 and all("_local_scalar_dense" in s for s in syncs)
    assert leaks == []


def test_t1_silent_on_device_only_work():
    x = torch.arange(4, dtype=torch.float32)
    syncs, _ = tr.audit_call(lambda: torch.where(x > 1.0, x, 0.0).cumsum(0),
                             CPU)
    assert syncs == []


def test_t1_records_copies_to_the_cpu():
    log = tr.DispatchLog()
    meta = torch.empty(3, device="meta")
    with log:
        # a meta tensor stands in for a device one: the copy is recorded
        # at dispatch, before any data would move
        try:
            meta.to("cpu")
        except (NotImplementedError, RuntimeError):
            pass
    assert any("copied to the CPU" in s for s in log.syncs)


# ------------------------------------------------------------- T2 fires
@pytest.mark.parametrize("constant", ["from_numpy", "scalar_tensor"])
def test_t2_fires_on_float64_constant(constant):
    x = torch.ones(3)

    def bad():
        if constant == "from_numpy":
            c = torch.from_numpy(np.array([2.0, 2.0, 2.0]))
        else:
            c = torch.tensor(2.0, dtype=torch.float64)
        return x * c

    _, leaks = tr.audit_call(bad, CPU)
    assert leaks and all("float64" in m for m in leaks)


def test_t2_tolerates_python_floats():
    x = torch.ones(3)
    _, leaks = tr.audit_call(lambda: torch.where(x > 0.5, 1.0, 0.0) * x * 2.0,
                             CPU)
    assert leaks == []


# ------------------------------------------------------------- T3 fires
def test_t3_flags_phantom_static_key():
    base = tr.KeyVariant("baseline", ("cfg", 1.0), b"A")
    phantom = tr.KeyVariant("renamed label", ("cfg-renamed", 1.0), b"A")
    msgs = tr.audit_static_key(base, [phantom])
    assert len(msgs) == 1 and "fragments the cache" in msgs[0]


def test_t3_flags_key_that_leaves_a_field_out():
    base = tr.KeyVariant("baseline", ("cfg", 1.0), b"A")
    unsound = tr.KeyVariant("tick changed", ("cfg", 1.0), b"B")
    msgs = tr.audit_static_key(base, [unsound])
    assert len(msgs) == 1 and "wrong constants" in msgs[0]


def test_t3_passes_honest_variants():
    base = tr.KeyVariant("baseline", ("cfg", 1.0), b"A")
    honest = [tr.KeyVariant("same", ("cfg", 1.0), b"A"),
              tr.KeyVariant("changed", ("cfg", 2.0), b"B")]
    assert tr.audit_static_key(base, honest) == []


def test_t3_catches_a_real_key_without_prompt_tps(monkeypatch):
    """``_Static.key()`` with the prompt throughput left out: the
    variant that doubles it changes the packed constants under the
    same key."""
    key = eng._Static.key
    monkeypatch.setattr(eng._Static, "key",
                        lambda self: key(self)[:5] + key(self)[6:])
    msgs = tr.audit_static_key(*tr.engine_key_variants())
    assert len(msgs) == 1 and msgs[0].startswith("profile prompt_tps")


def test_t3_catches_name_keyed_seg_cache_regression():
    """Port of the reference's regression test: a key made of the
    model, region and pool names (the reference's pre-fix scheme) over
    the real packed bytes is flagged; the committed counts-based key is
    not."""
    baseline, variants = tr.engine_key_variants()
    renamed = next(v for v in variants if v.name == "model renamed")
    # the rename really does not change what the kernel is given
    assert renamed.packed == baseline.packed
    assert renamed.key == baseline.key   # fixed key: names are not keyed
    old_base = tr.KeyVariant("baseline", baseline.key + (("m",),),
                             baseline.packed)
    old_renamed = tr.KeyVariant("model renamed",
                                renamed.key + (("m-renamed",),),
                                renamed.packed)
    msgs = tr.audit_static_key(old_base, [old_renamed])
    assert msgs and "fragments the cache" in msgs[0]


def test_t3_keys_equal_the_reference_keys():
    """For the baseline and each of the five perturbations, the port's
    ``_Static.key()`` equals ``repro.sim.vector.engine._Static.key()``
    built from the same arguments (the reference's profiles)."""
    grid = tr.key_variant_args()
    assert [g[0] for g in grid] == [
        "baseline", "model renamed", "regions renamed", "pool renamed",
        "tick doubled", "profile prompt_tps doubled"]
    ref_base = REF_PROFILES[sorted(REF_PROFILES)[0]]
    fields = list(ref_base.__dataclass_fields__)
    base = grid[0][4][grid[0][1][0]]
    assert [getattr(base, f) for f in fields] == \
        [getattr(ref_base, f) for f in fields]
    for name, models, regions, pools, profiles, dt in grid:
        prof = profiles[models[0]]
        ref_prof = type(ref_base)(**{f: getattr(prof, f) for f in fields})
        want = ref_engine._Static(models, regions, pools,
                                  {m: ref_prof for m in models}, dt).key()
        got = eng._Static(models, regions, pools, profiles, dt).key()
        assert got == want, name


# ------------------------------------------------------------- T4 fires
def _tiny_segments(keep_all: bool):
    lay, *arrays = bucket_step.synthetic_case(0, ["reactive"], M=1, J=2,
                                              L=96, buckets=8)
    consts, prm, carry, xs = map(torch.from_numpy, arrays)
    carry = carry.clone()
    watch = tr.CarryWatch(CPU)
    seg = watch.wrap(ops.bucket_segment)
    kept = [carry] if keep_all else []
    for s in range(tr.T4_SEGMENTS):
        carry, _ = seg(lay, consts, prm, carry, xs[s:s + 1], s, s + 1)
        if keep_all:
            kept.append(carry)
    return watch


def test_t4_fires_on_a_loop_that_keeps_every_carry():
    watch = _tiny_segments(keep_all=True)
    assert watch.alive == [2, 3, 4, 5, 6]
    msgs = tr.audit_carries(watch)
    assert len(msgs) == 1 and "6 carries alive" in msgs[0]


def test_t4_passes_on_a_loop_that_hands_the_carry_on():
    watch = _tiny_segments(keep_all=False)
    assert watch.alive == [2] * tr.T4_SEGMENTS
    assert tr.audit_carries(watch) == []


def test_t4_needs_enough_segments():
    watch = tr.CarryWatch(CPU)
    watch.alive = [2, 2]
    msgs = tr.audit_carries(watch)
    assert msgs and "only 2 segment(s)" in msgs[0]


def test_t4_real_vector_loop_keeps_two_carries():
    watch = tr.watch_vector_run(tr.canonical_vector_run(CPU), CPU)
    assert len(watch.alive) >= tr.T4_SEGMENTS
    assert max(watch.alive) == 2


# ------------------------------------------- real hot paths stay clean
def test_real_hot_paths_pass_all_trace_rules(trace_result):
    msgs = "\n".join(v.render() for v in trace_result.violations)
    assert not trace_result.violations, f"trace-tier violations:\n{msgs}"
    assert trace_result.device == "cpu"


def test_trace_covers_every_rule_on_both_paths(trace_result):
    by_rule = {}
    for c in trace_result.checks:
        by_rule.setdefault(c.rule, set()).add(c.target)
    assert set(by_rule) == set(tr.TRACE_RULES)
    for rule in ("T1", "T2"):
        assert by_rule[rule] == {"engine segment", "batched forecast fit"}
    assert all("engine" in t for t in by_rule["T3"] | by_rule["T4"])


def test_trace_within_check_budget(trace_result):
    assert trace_result.elapsed_s <= 60.0


def test_run_trace_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.run_trace()


def test_cli_trace_on_the_cpu():
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json", "--trace",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=str(repo), timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    data = json.loads(proc.stdout)
    assert data["counts"] == {} and data["warnings"] == []
    assert data["trace"]["device"] == "cpu"
    assert {c["rule"] for c in data["trace"]["checks"]} == set(tr.TRACE_RULES)
    assert not data["trace"]["violations"]
