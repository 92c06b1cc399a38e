"""repro_torch's placement across devices (DTensor behind ``dist.sharding``).

The runs that need a process group go through
``tests/torch_placement_worker.py``, each mode in a subprocess of its
own (started together by the module fixture), so that no test worker
inherits process-group or XLA device state:

(a) every parameter of the 10 architectures at full size, placed by the
    train rules on a fake group of 256 (16x16) and 512 (2x16x16) ranks:
    DTensor's local shape on rank 0, on the last rank and of the local
    shard equals ``dist.sharding.local_shape``, exactly;
(b) per-device counts on a (2, 4) mesh: the port's placed steps on a
    fake group of 8 (meta tensors) against the reference's
    ``build_case`` compiled by XLA on 8 host devices, for the reduced
    fp32 configs of the 7 families in train, prefill and decode at
    B 8 x S 64: FLOPs within ``FLOPS_FRAC`` of XLA's (of its dot
    instructions' in the ``DOT_HELD`` cases), total collective bytes
    within ``COLLECTIVE_BAND`` of the reference's ``collective_bytes``;
    the largest local tensor inside a placed MoE layer against the
    unplaced step's (``MOE_SPLIT_FRAC``); the collectives of the SSM
    prefill and train steps' in_proj and conv cache by the frames that
    issued them (all-to-alls); in the SSM train step, each collective
    asked for by ``dist.sharding`` and each pinned site's kinds equal to
    XLA's for its tensor; and Whisper-tiny at its 6 heads, where
    head_dim is split, its FLOPs within ``FLOPS_FRAC`` of XLA's and its
    attention scores' collective against the one XLA emits for them;
(c) real collectives: 4 gloo processes on a (2, 2) mesh, the placed
    forward and its prefill cache, train step and decode step of each
    family's reduced fp32 config against the same step in one process,
    and the trained placed model through a checkpoint; the MoE families
    again with the decode step on the dispatch and a capacity that drops
    pairs, the pairs dropped equal to one process's; the SSM decode
    bit for bit with ``take``'s form before it had a gradient; and
    ``take``'s pieces and gradient against slicing the whole tensor;
(d) the dry run on 16x16 for the 10 architectures at ``train_4k``, full
    width and 2 layers: every term a number, and the argument bytes of
    DTensor's local shards equal to ``argument_bytes``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.dist import sharding as sh
from repro_torch.launch.dryrun import BACKWARD_OF
from repro_torch.launch.mesh import Mesh, make_mesh

WORKER = Path(__file__).with_name("torch_placement_worker.py")
ROOT = WORKER.parent.parent
FAMILIES = ["starcoder2-7b", "mamba2-370m", "zamba2-7b",
            "llama4-scout-17b-a16e", "deepseek-v3-671b", "whisper-tiny",
            "pixtral-12b"]
MODES = ("train", "prefill", "decode")
MOE_FAMILIES = ["llama4-scout-17b-a16e", "deepseek-v3-671b"]
SSM_FAMILIES = ["mamba2-370m", "zamba2-7b"]
#: Whisper-tiny's steps at its published 6 heads, where head_dim is split
SPLIT_MODES = ("train", "prefill")
#: the placed SSM train step's sites whose collectives the port asks
#: for as XLA emits them: the (model function, ``dist.sharding`` call in
#: it) that move each tensor, by the name the worker's xla mode gives the
#: reference's tensor (the residual: the layer's output constraint, and
#: its input's gradient where the norm before it hands it on)
SSM_PINNED = {"norm": {("ssm.py:_gated_out", "sharding.py:reduced"),
                       ("ssm.py:_gated_out", "sharding.py:reduced_grad")},
              "bc": {("ssm.py:_placed_bc", "sharding.py:shard")},
              "residual": {("ssm.py:ssm_forward", "sharding.py:shard"),
                           ("layers.py:apply_norm",
                            "sharding.py:reduced_grad")}}
#: as tests/test_torch_dryrun.py: matrix products against XLA's whole count
FLOPS_FRAC = (0.85, 1.0)
#: the port's collective bytes a device over the reference's
COLLECTIVE_BAND = (0.5, 2.0)
#: the cases whose FLOPs are held to XLA's dot FLOPs (its matrix
#: products, what the port counts) instead of its whole count, which
#: there holds work no product count sees (PERF.md, PR 25): in the MoE
#: decode steps the masked gather of each token's experts' weights and
#: the adds of its all-reduce, 37% of XLA's count, where the port's
#: products equal XLA's dots exactly; in Zamba2-7B's train and decode
#: steps products of the shared block that GSPMD forms whole on every
#: device where the port splits them by heads (0.89 of XLA's dots)
DOT_HELD = {("llama4-scout-17b-a16e", "decode"),
            ("deepseek-v3-671b", "decode"), ("zamba2-7b", "train"),
            ("zamba2-7b", "decode")}
#: fp32: logits and decode 1e-5; the train step's loss 1e-5 and every
#: gradient leaf and the updated parameters rel L2 1e-4 (the port's fp32
#: training tolerances)
LOGIT_TOL = 1e-5
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
#: AdamW's first step is about lr * sign(g): an element whose gradient is
#: rounding noise (a zero-initialised key bias under RoPE) may move by a
#: fraction of lr whatever the gradient's tolerance
UPDATE_FRAC_OF_LR = 0.2
#: the largest local tensor any op inside a placed MoE layer produces, at
#: most this share of the unplaced step's: the split dispatch holds its
#: own tokens' rows and its experts' rows of the buffer, never all of
#: either (the (2, 4) mesh splits the tokens in 2 and the experts in 4)
MOE_SPLIT_FRAC = 0.5
TIMEOUT_S = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mode: the worker's JSON}, the four modes run concurrently."""
    out = tmp_path_factory.mktemp("placement")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    procs = {}
    for mode in ("gloo", "fake", "dryrun", "xla"):
        menv = dict(env)
        if mode == "xla":
            menv["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
            menv["JAX_PLATFORMS"] = "cpu"
        procs[mode] = subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(out / f"{mode}.json")],
            env=menv, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    res, logs = {}, {}
    for mode, p in procs.items():
        try:
            logs[mode], _ = p.communicate(timeout=TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        path = out / f"{mode}.json"
        res[mode] = (json.loads(path.read_text())
                     if p.returncode == 0 and path.exists() else None)
    res["logs"] = {m: t[-4000:] for m, t in logs.items()}
    return res


def _get(runs, mode):
    if runs[mode] is None:
        pytest.fail(f"the {mode} run failed:\n{runs['logs'][mode]}")
    return runs[mode]


# --------------------------------------------------------------------------
# (a) shards against local_shape
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_local_shards_equal_local_shape(runs, arch, chips):
    rows = [r for r in _get(runs, "fake")["shards"]
            if r["arch"] == arch and r["chips"] == chips]
    assert rows
    for r in rows:
        assert r["rank0"] == r["want"] == r["last"] == r["local"], r


# --------------------------------------------------------------------------
# (b) per-device counts against XLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_per_device_counts_match_xla(runs, arch, mode):
    got = _get(runs, "fake")["counts"][f"{arch}/{mode}"]
    want = _get(runs, "xla")[f"{arch}/{mode}"]
    held = "dot_flops" if (arch, mode) in DOT_HELD else "flops"
    flops = got["flops"] / want[held]
    assert FLOPS_FRAC[0] <= flops <= FLOPS_FRAC[1], (held, flops, got, want)
    coll = (sum(got["collectives"].values())
            / sum(want["collectives"].values()))
    assert COLLECTIVE_BAND[0] <= coll <= COLLECTIVE_BAND[1], \
        (coll, got, want)


def _split(frames):
    """A site's frames: (those that issued the collective, those where
    the forward op ran whose backward it is, or None in a forward),
    each "file:function" innermost first."""
    names = [f.rsplit(":", 1)[0] if f != BACKWARD_OF else f for f in frames]
    if BACKWARD_OF not in names:
        return names, None
    cut = names.index(BACKWARD_OF)
    return names[:cut], names[cut + 1:]


def _frames_with(records, *functions):
    """The (kind, bytes, frames) records issued inside any of
    ``functions`` ("file:function")."""
    return [r for r in records if set(functions) & set(_split(r[2])[0])]


def _entry(frames):
    """(the innermost frame outside ``dist/sharding.py``, the
    ``dist.sharding`` function it called): where the port asked for a
    collective."""
    for i, f in enumerate(frames):
        if not f.startswith("sharding.py:"):
            return f, frames[i - 1] if i else None
    return None, None


@pytest.mark.parametrize("mode", SPLIT_MODES)
def test_split_head_dim_scores_reduce_as_xla(runs, mode):
    """Whisper-tiny at its 6 heads on the (2, 4) mesh, head_dim split:
    the plain attention's partial Q K^T scores (and its backward's dP
    and rowsum(dO o O)) move by the collective XLA emits for the
    reference's scores, an all-reduce, whatever DTensor would choose;
    the step's collective bytes within the band of XLA's."""
    sites = _get(runs, "fake")["counts"]["sites"][f"split/{mode}"]
    want = _get(runs, "xla")[f"split/{mode}"]
    got = sorted({k for k, _, _ in _frames_with(
        sites, "ref.py:_masked_scores", "ref.py:flash_attention_bwd_ref",
        "ref.py:decode_attention_ref")})
    assert want["score_collectives"] == ["all-reduce"], want
    assert got == want["score_collectives"], sites
    counts = _get(runs, "fake")["counts"][f"split/{mode}"]
    coll = (sum(counts["collectives"].values())
            / sum(want["collectives"].values()))
    assert COLLECTIVE_BAND[0] <= coll <= COLLECTIVE_BAND[1], (coll, counts)


@pytest.mark.parametrize("mode", SPLIT_MODES)
def test_split_head_dim_flops_match_xla(runs, mode):
    """Whisper-tiny at its 6 heads on the (2, 4) mesh, head_dim split:
    the step's FLOPs within ``FLOPS_FRAC`` of XLA's whole count, as every
    case not in ``DOT_HELD``.  The projections' forward and their inputs'
    gradients are formed whole on every device, as GSPMD forms them, but
    their weights' gradients split over the axis that splits neither
    operand (``sharding.product``), where DTensor formed them whole on
    each device (1.132 of XLA's count, 1.201 of its dots, before)."""
    got = _get(runs, "fake")["counts"][f"split/{mode}"]["flops"]
    want = _get(runs, "xla")[f"split/{mode}"]["flops"]
    assert FLOPS_FRAC[0] <= got / want <= FLOPS_FRAC[1], (got, want)


@pytest.mark.parametrize("site", SSM_PINNED)
def test_placed_ssm_train_sites_move_as_xla(runs, site):
    """In the placed Mamba2-370M train step on the (2, 4) mesh, each
    tensor whose collective the port asks for (``SSM_PINNED``) moves by
    the kinds XLA's partitioned reference moves it by (the worker's xla
    mode finds it by its shape; forward and backward together, which
    XLA's combiner merges), whatever DTensor would choose: the gate
    norm's mean and its scale's gradient all-reduced; B and C
    all-gathered and their gradients all-reduced (XLA also all-reduces
    G = C B^T, formed over the split state); the layer's output and its
    input's gradient (at the norm before it, in_proj's backward in XLA)
    all-reduced.  The port's site moves in both directions."""
    records = _get(runs, "fake")["counts"]["sites"]["mamba2-370m/train"]
    want = _get(runs, "xla")["mamba2-370m/train"]["ssm_sites"][site]
    got = {"forward": set(), "backward": set()}
    for kind, _, frames in records:
        issued, forward = _split(frames)
        if _entry(issued if forward is None else forward) in \
                SSM_PINNED[site]:
            got["backward" if forward else "forward"].add(kind)
    assert got["forward"] and got["backward"], got
    assert sorted(got["forward"] | got["backward"]) == want, (got, want)


@pytest.mark.parametrize("arch", SSM_FAMILIES)
def test_placed_ssm_train_collectives_all_asked_for(runs, arch):
    """Every collective of the SSM layers in the placed train step on the
    (2, 4) mesh, in their forward or in the backward of an op made
    there, is issued by ``dist.sharding`` at the port's request (a
    constraint, ``reduced``, ``take``, a parameter's gather on use or
    their backward): none is DTensor's own choice inside an op (before,
    the gate norm's backward re-split its (B, L, d_inner) operands by
    ``shard_dim_alltoall`` under torch 2.13 and by a reduce-scatter
    under 2.11)."""
    records = _get(runs, "fake")["counts"]["sites"][f"{arch}/train"]
    inside = [r for r in records
              if any(f.startswith("ssm.py:") for f in r[2])]
    assert inside
    for kind, moved, frames in inside:
        issued, _ = _split(frames)
        assert issued and issued[0].startswith("sharding.py:"), \
            (kind, moved, frames)


@pytest.mark.parametrize("mode", ("train", "prefill"))
@pytest.mark.parametrize("arch", SSM_FAMILIES)
def test_placed_ssm_in_proj_and_conv_cache_move_by_all_to_all(runs, arch,
                                                              mode):
    """In the placed SSM prefill and train steps on the (2, 4) mesh,
    in_proj's product, the conv's weights and the prefill's conv cache
    are re-split by all-to-alls: nothing in ``_placed_in_proj`` or
    ``_placed_conv_cache`` gathers, but the train rules' FSDP gather of
    in_proj over the data axis as it is read (``__getattr__``), which
    GSPMD makes too."""
    sites = _get(runs, "fake")["counts"]["sites"][f"{arch}/{mode}"]
    inside = _frames_with(sites, "ssm.py:_placed_in_proj",
                          "ssm.py:_placed_conv_cache")
    assert any(k == "all-to-all" for k, _, _ in _frames_with(
        inside, "ssm.py:_placed_in_proj")), sites
    if mode == "prefill":
        assert any(k == "all-to-all" for k, _, _ in _frames_with(
            inside, "ssm.py:_placed_conv_cache")), sites
    for kind, moved, frames in inside:
        assert kind == "all-to-all" or (
            kind == "all-gather" and mode == "train"
            and "sharding.py:__getattr__" in _split(frames)[0]), \
            (kind, moved, frames)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE_FAMILIES)
def test_placed_moe_dispatch_holds_no_whole_buffer(runs, arch, mode):
    """Inside the MoE layers of a step on the fake (2, 4) mesh (the decode
    step on the dispatch), no local tensor comes near the unplaced
    step's (E*C + 1, D) buffer or its T*K rows."""
    placed, whole = _get(runs, "fake")["moe_largest"][f"{arch}/{mode}"]
    assert 0 < placed <= MOE_SPLIT_FRAC * whole, (placed, whole)


# --------------------------------------------------------------------------
# (c) real collectives against one process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_gloo_forward_matches_one_process(runs, arch):
    assert _get(runs, "gloo")[arch]["forward_max_abs"] <= LOGIT_TOL


@pytest.mark.parametrize("arch", FAMILIES)
def test_gloo_prefill_cache_matches_one_process(runs, arch):
    """The placed forward's prefill cache, leaf by leaf; the SSM conv
    cache laid out by ``ssm_cache_logical_axes`` from each device's
    pieces (the stacked layer axis leads: batch over data, channels over
    model), never gathered whole."""
    r = _get(runs, "gloo")[arch]
    assert r["prefill_cache_max_abs"] <= LOGIT_TOL, r
    if arch in SSM_FAMILIES:
        assert r["prefill_conv_placements"] and all(
            p == ["S(1)", "S(3)"] for p in r["prefill_conv_placements"]), r


@pytest.mark.parametrize("arch", SSM_FAMILIES)
def test_gloo_ssm_decode_bit_for_bit_with_take_before(runs, arch):
    """The placed SSM decode through ``take`` with its gradient equals the
    same decode through the form it had before (kept in the worker),
    logits and cache, bit for bit."""
    assert _get(runs, "gloo")[arch]["decode_take_bit_for_bit"]


def test_gloo_take_gradient_equals_slicing(runs):
    """``take`` on 4 gloo ranks (chunks of 3, 3, 3, 1; ranges across chunk
    bounds, taken by several ranks and twice by one): each rank's pieces
    equal the slices of the whole tensor, and x's gradient the gradient
    of those slices, placed as x."""
    r = _get(runs, "gloo")["take"]
    assert r["out_max_abs"] == 0.0, r
    assert r["grad_max_abs"] <= 1e-12, r
    assert r["grad_placements"] == ["S(0)"], r


@pytest.mark.parametrize("arch", FAMILIES)
def test_gloo_train_step_matches_one_process(runs, arch):
    r = _get(runs, "gloo")[arch]
    assert r["loss_abs"] <= LOSS_TOL, r
    assert r["grad_rel_l2"] <= LEAF_TOL, r
    assert r["params_rel_l2"] <= LEAF_TOL, r
    assert r["param_max_abs"] <= UPDATE_FRAC_OF_LR * r["lr"], r


@pytest.mark.parametrize("arch", FAMILIES)
def test_gloo_checkpoint_gathers_and_places_back(runs, arch):
    """The placed model after its step, saved (gathered, rank 0 writes)
    and restored into a placed model: every leaf exact, placed alike."""
    r = _get(runs, "gloo")[arch]
    assert r["checkpoint_step"] == 1
    assert r["checkpoint_max_abs"] == 0.0
    assert r["checkpoint_placed"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_gloo_decode_step_matches_one_process(runs, arch):
    r = _get(runs, "gloo")[arch]
    assert r["decode_max_abs"] <= LOGIT_TOL, r
    assert r["cache_max_abs"] <= LOGIT_TOL, r


@pytest.mark.parametrize("arch", MOE_FAMILIES)
def test_gloo_moe_dispatch_matches_one_process(runs, arch):
    """The split dispatch where it drops pairs: the forward, train step
    and a decode step on the dispatch (``MOE_DECODE_DISPATCH``) at a
    capacity that drops pairs, against one process."""
    r = _get(runs, "gloo")[f"{arch}/dispatch"]
    assert r["forward_max_abs"] <= LOGIT_TOL, r
    assert r["loss_abs"] <= LOSS_TOL, r
    assert r["grad_rel_l2"] <= LEAF_TOL, r
    assert r["params_rel_l2"] <= LEAF_TOL, r
    assert r["param_max_abs"] <= UPDATE_FRAC_OF_LR * r["lr"], r
    assert r["decode_max_abs"] <= LOGIT_TOL, r
    assert r["cache_max_abs"] <= LOGIT_TOL, r


@pytest.mark.parametrize("run", ["config", "dispatch"])
@pytest.mark.parametrize("arch", MOE_FAMILIES)
def test_gloo_moe_drops_the_pairs_one_process_drops(runs, arch, run):
    """``moe.DROPPED`` of each placed step equals one process's.  At the
    dropping capacity the forward and the train step drop pairs, and
    the unplaced routing has an expert whose pairs come from both data
    ranks and are dropped: a pair's rank there is global, not its
    rank's."""
    r = _get(runs, "gloo")[arch if run == "config" else f"{arch}/dispatch"]
    for step, (got, want) in r["dropped"].items():
        assert got == want, (step, r["dropped"])
    if run == "dispatch":
        assert r["dropped"]["forward"][1] > 0, r["dropped"]
        assert r["dropped"]["train"][1] > 0, r["dropped"]
        assert r["spanning_drops"] > 0, r


# --------------------------------------------------------------------------
# (d) the dry run on 16x16
# --------------------------------------------------------------------------

TERMS = ("flops_per_device", "bytes_per_device",
         "collective_bytes_per_device", "compute_t", "memory_t",
         "collective_t", "bottleneck", "useful_flops_frac")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_dry_run_on_16x16_gives_every_term(runs, arch):
    (r,) = [r for r in _get(runs, "dryrun") if r["arch"] == arch]
    assert r["chips"] == 256 and r["layers"] == 2
    for key in TERMS:
        assert r[key] is not None, key
    assert r["flops_per_device"] > 0 and r["collective_bytes_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert set(r["collectives"]) <= {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"}
    assert r["local_argument_bytes"] == r["argument_bytes_per_device"]
    assert r["torch"] == torch.__version__


# --------------------------------------------------------------------------
# In this process: the pieces that need no process group
# --------------------------------------------------------------------------

def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = Mesh(("pod", "data", "model"), {"pod": 2, "data": 16,
                                           "model": 16})
    spec = sh.PartitionSpec(("pod", "data"), None, "model")
    assert sh.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.PartitionSpec(None, None), mesh) == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements(sh.PartitionSpec(("data", "pod")), mesh)


def test_meshes_carry_no_device_mesh_without_a_process_group():
    assert not torch.distributed.is_initialized()
    m = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    assert m.device_mesh is None and m.size == 4
    with pytest.raises(ValueError, match="no process"):
        sh.place(torch.ones(4, 4), m, sh.TRAIN_RULES, ("batch", "embed"))
