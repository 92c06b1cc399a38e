"""repro_torch ServingEngine vs repro.serving.engine.ServingEngine.

Same weights (carried over with ``params_from_reference``), float32
smoke configs, identical request streams: the greedy tokens,
``ttft_step`` and ``done_step`` of every request must be identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduce_for_smoke as jreduce
from repro.dist.sharding import unbox
from repro.models import model as jmodel
from repro.serving.engine import ServeRequest as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch.serve import make_requests
from repro_torch.models.convert import params_from_reference
from repro_torch.serving.engine import ServeRequest, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_params(arch, **overrides):
    kw = dict(overrides, dtype="float32")
    jcfg = dataclasses.replace(jreduce(jget_arch(arch)), **kw)
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), **kw)
    tree = jax.tree.map(np.asarray,
                        unbox(jmodel.init(jcfg, jax.random.PRNGKey(0))))
    return jcfg, tree, cfg, params_from_reference(cfg, tree, "cpu")


def mirror(req):
    """The reference's request with the same fields."""
    return JRequest(rid=req.rid, prompt=np.asarray(req.prompt, np.int32),
                    max_new_tokens=req.max_new_tokens, tier=req.tier,
                    arrival=req.arrival, ttft_deadline=req.ttft_deadline)


def serve_both(arch, reqs, overrides=None, **engine_kw):
    jcfg, tree, cfg, lm = both_params(arch, **(overrides or {}))
    jeng = JEngine(jcfg, tree, **engine_kw)
    eng = ServingEngine(cfg, lm, device="cpu", **engine_kw)
    jreqs = [mirror(r) for r in reqs]
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    eng.run()
    jeng.run()
    assert eng.step_count == jeng.step_count
    for r, jr in zip(reqs, jreqs):
        assert r.done_step is not None
        assert (r.tokens, r.ttft_step, r.done_step) == \
            (jr.tokens, jr.ttft_step, jr.done_step), r.rid
    return eng


def test_launcher_dpa_mix_matches_reference():
    """``launch/serve.py``'s mix: 8 requests, IW-F every third, DPA,
    4 slots over a 256-slot cache; the CPU path never launches a kernel."""
    cfg = reduce_for_smoke(get_arch("starcoder2-7b"))
    reqs = make_requests(cfg, 8, max_new=8)
    before = (tfa.LAUNCHES, tdec.LAUNCHES)
    eng = serve_both("starcoder2-7b", reqs, max_batch=4, max_seq=256,
                     scheduler="dpa")
    assert (tfa.LAUNCHES, tdec.LAUNCHES) == before
    # DPA admitted the IW-F requests first
    first = sorted(reqs, key=lambda r: (r.ttft_step, r.rid))[:4]
    assert {r.rid for r in first} >= {0, 3, 6}
    assert eng.step_count > 8


def test_multi_request_batched_matches_reference():
    """``tests/test_serving_engine.py``'s multi-request case: 5 requests
    through 2 slots (slots are reused with stale cache entries)."""
    cfg = reduce_for_smoke(get_arch("qwen2-72b"))
    rng = np.random.default_rng(0)
    reqs = [ServeRequest(rid=i,
                         prompt=rng.integers(0, cfg.vocab_size, 6).astype(
                             np.int32),
                         max_new_tokens=5) for i in range(5)]
    serve_both("qwen2-72b", reqs, max_batch=2, max_seq=64)
    assert all(len(r.tokens) == 5 for r in reqs)


def test_max_seq_stop_matches_reference():
    """A request that reaches ``pos >= max_seq - 1`` stops there, as in
    the reference, on Gemma's tied embeddings and GeGLU."""
    cfg = reduce_for_smoke(get_arch("gemma-7b"))
    reqs = make_requests(cfg, 3, max_new=40, prompt_len=(10, 20), seed=1)
    serve_both("gemma-7b", reqs, max_batch=2, max_seq=32, scheduler="edf")
    assert any(len(r.tokens) < 40 for r in reqs)


@pytest.mark.parametrize("arch,overrides", [
    ("mamba2-370m", {}),
    ("zamba2-7b", {}),
    ("zamba2-7b", dict(num_layers=5, attn_every=2)),
], ids=["mamba2-370m", "zamba2-7b", "zamba2-7b-l5"])
def test_ssm_engine_matches_reference(arch, overrides):
    """The SSM and hybrid families behind DPA: 6 requests through 3
    slots (slots reused, so prefill overwrites whole SSM states and conv
    windows that idle decode steps kept advancing), prompts of 2 to 40
    tokens (a conv window left-padded, a chunk boundary crossed); the CPU
    path never launches a kernel."""
    cfg = reduce_for_smoke(get_arch(arch))
    reqs = make_requests(cfg, 6, max_new=5, prompt_len=(2, 41), seed=3)
    reqs[1].prompt = reqs[1].prompt[:2]
    before = (tfa.LAUNCHES, tdec.LAUNCHES, tssd.LAUNCHES)
    serve_both(arch, reqs, overrides, max_batch=3, max_seq=64,
               scheduler="dpa")
    assert (tfa.LAUNCHES, tdec.LAUNCHES, tssd.LAUNCHES) == before
    assert all(len(r.tokens) == 5 for r in reqs)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v3-671b",
                                  "pixtral-12b", "whisper-tiny"])
def test_new_family_engine_matches_reference(arch):
    """The MoE (with MLA), VLM and audio families behind DPA: 6 requests
    through 3 slots (slots reused; the VLM's prompts follow 4 zero
    patches, the audio model's decode against zero frames through a
    cross cache that idle decode steps must leave alone), prompts of 2
    to 40 tokens; the CPU path never launches a kernel."""
    cfg = reduce_for_smoke(get_arch(arch))
    reqs = make_requests(cfg, 6, max_new=5, prompt_len=(2, 41), seed=4)
    before = (tfa.LAUNCHES, tdec.LAUNCHES)
    eng = serve_both(arch, reqs, max_batch=3, max_seq=64, scheduler="dpa")
    assert (tfa.LAUNCHES, tdec.LAUNCHES) == before
    assert all(len(r.tokens) == 5 for r in reqs)
    if cfg.family == "audio":
        assert bool(eng.cache["cross"]["k"].abs().sum() > 0)
