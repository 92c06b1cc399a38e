"""repro_torch's dry run (``launch.dryrun``) against the reference's.

``rules_for`` and ``window_for`` are the reference's, rule for rule, on
all 40 architecture x shape cases and under every opt.  On reduced
configs (one CPU device, small shapes per mode) the port's argument
bytes equal XLA's ``memory_analysis().argument_size_in_bytes`` of the
reference's own step (``repro.launch.dryrun.build_case``) exactly, and
its counted FLOPs lie within ``FLOPS_FRAC`` of XLA's
``cost_analysis()["flops"]`` under ``flags.unrolled_scans()``.

The reference's module sets ``XLA_FLAGS`` to 512 host devices and a
persistent compilation cache when it is imported; jax is initialised
first (so this process keeps its one CPU device) and both are restored
at once, so that a later test in the same worker, or a process it
starts, does not inherit them.
"""
import dataclasses
import json
import os

import jax
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.configs import reduce_for_smoke as jreduce
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import flags as jflags
from repro_torch.configs import ARCHS, SHAPES, get_arch, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh

#: the dry run counts matrix products only; XLA's count adds the
#: elementwise work (norms, softmax, rope, activations, the SSM's decay
#: chain, AdamW's updates), which on these reduced configs is 1-11% of
#: the total.  So the port's count must lie in [0.85, 1.0] of XLA's.
#: The configs are fp32: XLA's CPU backend widens every bf16 weight to
#: fp32 before a product and counts each widening as a FLOP, which at a
#: decode step of 2 tokens doubles its count.
FLOPS_FRAC = (0.85, 1.0)
#: the families: dense, SSM, hybrid, MoE, MLA + MoE, audio, VLM
CASE_ARCHS = ["starcoder2-7b", "mamba2-370m", "zamba2-7b",
              "llama4-scout-17b-a16e", "deepseek-v3-671b", "whisper-tiny",
              "pixtral-12b"]
SMALL = {"train": (64, 2), "prefill": (64, 2), "decode": (64, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rd():
    """``repro.launch.dryrun``, imported without keeping its XLA_FLAGS or
    its persistent compilation cache under /tmp."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    cache = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    try:
        from repro.launch import dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
        for k, v in cache.items():
            jax.config.update(k, v)
    assert len(jax.devices()) == 1
    return mod


@pytest.mark.parametrize("opt", [None, "bf16_stream", "moe_dispatch",
                                 "decode_kv_shard", "attn_no_headdim_shard"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_rules_and_window_match_reference(rd, arch, opt):
    """Every shape, at the production model axis (16) and at one card's
    (1)."""
    opts = frozenset() if opt is None else frozenset({opt})
    for name, shape in SHAPES.items():
        jcfg, jshape = jget_arch(arch), JSHAPES[name]
        for axis in (16, 1):
            want = rd.rules_for(jcfg, jshape, axis, opts=opts)
            got = dryrun.rules_for(get_arch(arch), shape, axis, opts=opts)
            assert dict(got) == dict(want), (name, axis)
        assert dryrun.window_for(get_arch(arch), shape) == \
            rd.window_for(jcfg, jshape)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_and_per_device_arguments_on_the_production_mesh(arch):
    """``params`` is the config's analytic count (the figure model FLOPs
    use); ``param_elements`` sums the meta-built parameters.  On 16x16
    (a fake group of 256) the step is placed and traced, here at full
    width and 2 layers: FLOPs, bytes, collective bytes, the three terms
    and the bottleneck are numbers; the arguments are split over the
    mesh, DTensor's local shards as ``argument_bytes`` counts them."""
    cfg = dryrun.cut_depth(get_arch(arch), 2)
    prod = dryrun.run_case(arch, "train_4k", mesh="16x16", verbose=False,
                           layers=2)
    assert prod["params"] == cfg.param_count()
    lm = dryrun.abstract_params(cfg)
    assert prod["param_elements"] == sum(p.numel() for p in lm.parameters())
    assert prod["chips"] == 256 and prod["layers"] == 2
    for key in ("flops_per_device", "bytes_per_device", "compute_t",
                "memory_t", "collective_t", "useful_flops_frac",
                "collective_bytes_per_device"):
        assert prod[key] > 0, key
    assert prod["bottleneck"] in ("compute", "memory", "collective")
    assert prod["local_argument_bytes"] == prod["argument_bytes_per_device"]
    whole = dryrun.argument_bytes(
        dryrun.build_case(cfg, SHAPES["train_4k"]), make_local_mesh(),
        dryrun.rules_for(cfg, SHAPES["train_4k"], 1))
    assert whole / 256 <= prod["argument_bytes_per_device"] < whole / 16
    assert prod["model_flops_per_device"] == pytest.approx(
        6 * cfg.active_param_count() * 256 * 4096 / 256)
    assert not torch.distributed.is_initialized()


def _small(mode):
    seq, batch = SMALL[mode]
    return (ShapeConfig(f"{mode}_small", seq, batch, mode),
            JShapeConfig(f"{mode}_small", seq, batch, mode))


@pytest.mark.parametrize("mode", list(SMALL))
@pytest.mark.parametrize("arch", CASE_ARCHS)
def test_argument_bytes_and_flops_match_xla(rd, arch, mode):
    """fp32 reduced configs on one CPU device.  The reference's step is
    compiled with ``keep_unused=True``: by default jit drops the
    arguments a step never reads (Whisper's encoder at decode, an SSM's
    ``cur_pos``), which a card holds all the same."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                              dtype="float32")
    jcfg = dataclasses.replace(jreduce(jget_arch(arch)), dtype="float32")
    shape, jshape = _small(mode)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with jflags.unrolled_scans():
        fn, specs, in_sh, out_sh = rd.build_case(
            jcfg, jshape, mesh, rd.rules_for(jcfg, jshape, 1))
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           keep_unused=True).lower(*specs).compile()
    case = dryrun.build_case(cfg, shape)
    got = dryrun.argument_bytes(case, make_local_mesh(),
                                dryrun.rules_for(cfg, shape, 1))
    assert got == compiled.memory_analysis().argument_size_in_bytes
    flops, nbytes = dryrun.measure(case.fn)
    xla = compiled.cost_analysis()["flops"]
    assert FLOPS_FRAC[0] * xla <= flops <= FLOPS_FRAC[1] * xla, flops / xla
    assert nbytes > 0


@pytest.mark.parametrize("mode", list(SMALL))
def test_bf16_argument_bytes_match_xla(rd, mode):
    """The model dtype's widths: DeepSeek-V3 (MLA and MoE) in bf16."""
    cfg = reduce_for_smoke(get_arch("deepseek-v3-671b"))
    jcfg = jreduce(jget_arch("deepseek-v3-671b"))
    shape, jshape = _small(mode)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    fn, specs, in_sh, out_sh = rd.build_case(
        jcfg, jshape, mesh, rd.rules_for(jcfg, jshape, 1))
    compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                       keep_unused=True).lower(*specs).compile()
    got = dryrun.argument_bytes(dryrun.build_case(cfg, shape),
                                make_local_mesh(),
                                dryrun.rules_for(cfg, shape, 1))
    assert got == compiled.memory_analysis().argument_size_in_bytes


def test_model_flags_follow_opts_and_are_restored():
    from repro_torch.models import flags

    with dryrun.model_flags({"bf16_stream", "moe_dispatch"}):
        assert flags.ATTN_BF16_STREAM and flags.MOE_DECODE_DISPATCH
    assert not (flags.ATTN_BF16_STREAM or flags.MOE_DECODE_DISPATCH)
    with pytest.raises(ValueError, match="refused"):
        dryrun.run_case("starcoder2-7b", "decode_32k",
                        opts=frozenset({"where_cache"}))
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "starcoder2-7b", "--shape", "decode_32k",
                     "--opts", "where_cache"])


def test_cli_all_for_one_arch(tmp_path, monkeypatch, capsys):
    """``--all`` over Whisper-tiny's four shapes at full size on the meta
    device: every case traced and written, exit 0; a case that fails is
    recorded and the exit code is 1; on 16x16 every case is placed and
    traced with its three terms."""
    monkeypatch.setattr(dryrun, "ARCHS", {"whisper-tiny":
                                          ARCHS["whisper-tiny"]})
    out = tmp_path / "report.json"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["shape"] for r in rows] == list(SHAPES)
    for r in rows:
        assert r["mesh"] == "local" and r["chips"] == 1 and r["fits"]
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["bottleneck"] in ("compute", "memory")
        assert 0 < r["useful_flops_frac"] < 1.5
    assert "4/4 cases traced OK" in capsys.readouterr().out

    real = dryrun.run_case

    def fail_decode(arch, shape, **kw):
        if shape == "decode_32k":
            raise RuntimeError("boom")
        return real(arch, shape, **kw)

    monkeypatch.setattr(dryrun, "run_case", fail_decode)
    assert dryrun.main(["--all", "--mesh", "16x16", "--out", str(out)]) == 1
    rows = json.loads(out.read_text())
    assert rows[2] == {"arch": "whisper-tiny", "shape": "decode_32k",
                       "error": "boom"}
    for r in rows:
        if "error" in r:
            continue
        assert r["mesh"] == "16x16" and r["chips"] == 256
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["collective_bytes_per_device"] > 0
        assert r["collective_t"] > 0
        assert r["bottleneck"] in ("compute", "memory", "collective")
    assert not torch.distributed.is_initialized()
