"""repro_torch's training path against the JAX package's (``repro.train``, ``repro.data``).

Inputs and weights are made once and handed to both sides: the
reference's parameter tree (``unbox(repro.models.model.init)``) is
carried into the port with ``params_from_reference``, batches come from
``SyntheticLM`` (numpy, equal in both packages bit for bit).  Tolerances:

- ``loss_fn`` and its gradients in fp32 on ``reduce_for_smoke`` of one
  config per family: loss rel 1e-5, each gradient leaf rel L2 1e-4
  (autodiff in two frameworks, sums in other orders; the observed worst
  leaf is about 1.5e-5, MoE's fp32 router);
- AdamW on identical gradients: fp32 parameters and the moments rel
  1e-6 (the moments of the leaf's largest element); bf16
  parameters at most one bf16 ulp per element (the fp32 update is
  rounded to bf16, then added and rounded again, as in the reference:
  an fp32 update that differs in its last bits may round the other way);
- ``cosine_schedule``: 1e-7 absolute;
- three train steps: losses rel 1e-4 (Adam's first step is near sign(g),
  so parameters are compared through the losses they give, not element
  by element);
- checkpoints and batches: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduce_for_smoke as jreduce
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.dist.sharding import unbox
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import model
from repro_torch.models.convert import (_flatten, params_from_reference,
                                        params_to_reference,
                                        reference_leaves)
from repro_torch.serving.engine import ServingEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optimizer as topt

#: one config per family: dense, MoE, MLA (with MoE), SSM, hybrid, VLM,
#: audio
FAMILIES = ["starcoder2-7b", "llama4-scout-17b-a16e", "deepseek-v3-671b",
            "mamba2-370m", "zamba2-7b", "pixtral-12b", "whisper-tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, dtype="float32"):
    return (dataclasses.replace(jreduce(jget_arch(arch)), dtype=dtype),
            dataclasses.replace(reduce_for_smoke(get_arch(arch)),
                                dtype=dtype))


def reference_tree(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        unbox(jmodel.init(jcfg, jax.random.PRNGKey(seed))))


def port_model(cfg, tree):
    lm = params_from_reference(cfg, tree, "cpu")
    lm.requires_grad_(True)
    return lm


def first_batch(cfg, B=2, S=64, seed=0):
    return next(SyntheticLM(cfg, DataConfig(batch_size=B, seq_len=S,
                                            seed=seed)).batches(1))


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def rel_l2(got, want):
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.abs(got).max()


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["starcoder2-7b", "pixtral-12b",
                                  "whisper-tiny"])
def test_synthetic_batches_equal_the_reference_bit_for_bit(arch):
    jcfg, cfg = configs(arch)
    data = dict(batch_size=3, seq_len=40, seed=5)
    mine = list(SyntheticLM(cfg, DataConfig(**data)).batches(3))
    theirs = list(JSyntheticLM(jcfg, JDataConfig(**data)).batches(3))
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# ------------------------------------------------------------ optimizer
def optimizer_case(dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 24), "b": (24,), "norm": (16,), "router": (16, 4)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: (0.3 * rng.standard_normal(s)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    tdt = getattr(torch, dtype)
    # the fp32 router of a bf16 MoE model stays fp32
    kinds = {n: (torch.float32 if n == "router" else tdt) for n in shapes}
    tp = {n: torch.from_numpy(a).to(kinds[n]) for n, a in params.items()}
    # copies: jax may alias a numpy buffer, which the port updates in place
    jp = {n: jnp.asarray(t.float().numpy().copy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for n, t in tp.items()}
    tg = [{n: torch.from_numpy(a).to(kinds[n]) for n, a in g.items()}
          for g in grads]
    jg = [{n: jnp.asarray(t.float().numpy().copy()).astype(jp[n].dtype)
           for n, t in g.items()} for g in tg]
    return tp, jp, tg, jg


def bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_matches_the_reference_on_identical_gradients(dtype, clip):
    """Three updates on the same gradients; with clip 0.5 the global norm
    (about 3.2 here) is clipped.  The moments, the updates and the
    parameters after ``apply_updates`` against the reference's."""
    tp, jp, tg, jg = optimizer_case(dtype, seed=1)
    lr = topt.cosine_schedule(1e-2, warmup=1, total=5)
    mine = topt.AdamW(lr=lr, grad_clip=clip)
    theirs = jopt.AdamW(lr=jopt.cosine_schedule(1e-2, warmup=1, total=5),
                        grad_clip=clip)
    ts, js = mine.init(tp), theirs.init(jp)
    if clip:
        assert float(topt.global_norm(tg[0])) > 2 * clip
    for step in range(3):
        upd, ts = mine.update(tg[step], ts, tp)
        jupd, js = theirs.update(jg[step], js, jp)
        topt.apply_updates(tp, upd)
        jp = jopt.apply_updates(jp, jupd)
        assert int(ts.step) == int(js.step) == step + 1
        for n in tp:
            # the moments to 1e-6 of the leaf's largest: an element whose
            # moment nearly cancels (0.9 m + 0.1 g) carries the clip
            # scale's last-bit difference (the norm summed in another
            # order) at a larger relative size
            for mine_, theirs_ in ((ts.m[n], js.m[n]), (ts.v[n], js.v[n])):
                want = np.asarray(theirs_)
                np.testing.assert_allclose(mine_.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())
            got = tp[n].float().numpy()
            want = np.asarray(jp[n].astype(jnp.float32))
            if tp[n].dtype == torch.bfloat16:
                assert np.all(np.abs(got - want) <= bf16_ulp(want))
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_adamw_step_in_place_equals_update_then_apply():
    tp, _, tg, _ = optimizer_case("bfloat16", seed=2)
    other = {n: t.clone() for n, t in tp.items()}
    opt = topt.AdamW(lr=3e-3)
    s1, s2 = opt.init(tp), opt.init(other)
    for g in tg:
        upd, s1 = opt.update(g, s1, tp)
        topt.apply_updates(tp, upd)
        s2 = opt.step_(other, g, s2)
    for n in tp:
        assert torch.equal(tp[n], other[n])
        assert torch.equal(s1.m[n], s2.m[n]) and torch.equal(s1.v[n], s2.v[n])


def test_cosine_schedule_matches_the_reference():
    mine = topt.cosine_schedule(1e-3, warmup=10, total=100)
    theirs = jopt.cosine_schedule(1e-3, warmup=10, total=100)
    for step in (0, 10, 55, 100):
        assert abs(float(mine(torch.tensor(step, dtype=torch.int32)))
                   - float(theirs(jnp.asarray(step)))) <= 1e-7


# ---------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", ["starcoder2-7b", "zamba2-7b",
                                  "whisper-tiny"])
def test_checkpoints_restore_in_the_other_package_bit_for_bit(arch,
                                                              tmp_path):
    """bf16 weights: the port's file into ``repro.train.checkpoint.restore``
    (template ``unbox(init)`` of another seed) and the reference's file
    into the port's ``restore``, both equal to the saved values bit for
    bit, with the step."""
    jcfg, cfg = configs(arch, "bfloat16")
    lm = model.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    path = str(tmp_path / "port.npz")
    ckpt.save(path, lm, step=7)
    like = unbox(jmodel.init(jcfg, jax.random.PRNGKey(3)))
    restored, step = jckpt.restore(path, like)
    assert step == 7
    mine = reference_leaves(lm)
    theirs = _flatten(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), restored))
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert restored is not None
        np.testing.assert_array_equal(mine[key], theirs[key])
    assert all(a.dtype == jnp.bfloat16 for a in jax.tree.leaves(restored)
               if a.dtype != jnp.float32)

    tree = unbox(jmodel.init(jcfg, jax.random.PRNGKey(4)))
    path = str(tmp_path / "reference.npz")
    jckpt.save(path, tree, step=11)
    other = model.init(cfg, torch.Generator().manual_seed(2), device="cpu")
    _, step = ckpt.restore(path, other)
    assert step == 11
    want = _flatten(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), tree))
    got = reference_leaves(other)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    dtypes = {p.dtype for p in other.parameters()}
    assert torch.bfloat16 in dtypes


# --------------------------------------------------------- loss, grads
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_jax_value_and_grad(arch):
    jcfg, cfg = configs(arch)
    tree = reference_tree(jcfg)
    batch = first_batch(cfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, to_jax(batch)))(
            jax.tree.map(jnp.asarray, tree))
    lm = port_model(cfg, tree)
    loss = model.loss_fn(cfg, lm, loop.batch_to(batch, "cpu"))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    mine = _flatten(params_to_reference(cfg, lm, grads=True))
    theirs = _flatten(jax.tree.map(np.asarray, jgrads))
    assert mine.keys() == theirs.keys()
    worst = {k: rel_l2(mine[k], theirs[k]) for k in theirs}
    assert max(worst.values()) <= 1e-4, sorted(worst.items(),
                                               key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("arch", ["starcoder2-7b", "zamba2-7b",
                                  "whisper-tiny"])
def test_remat_gives_the_same_gradients(arch):
    """Each layer recomputed in the backward pass (torch.utils.checkpoint)
    gives the gradients of the plain pass, bit for bit on the CPU; the
    plain attention and scan run once more per layer."""
    from repro_torch.kernels import ref

    jcfg, cfg = configs(arch)
    tree = reference_tree(jcfg)
    batch = loop.batch_to(first_batch(cfg), "cpu")
    grads, calls = [], []
    for remat in (False, True):
        lm = port_model(cfg, tree)
        count = {"attn": 0, "scan": 0}

        def counted(fn, key):
            def wrapper(*args, **kwargs):
                count[key] += 1
                return fn(*args, **kwargs)
            return wrapper

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref, "flash_attention_lse_ref", counted(
                ref.flash_attention_lse_ref, "attn"))
            mp.setattr(ref, "ssd_state_scan_ref", counted(
                ref.ssd_state_scan_ref, "scan"))
            model.loss_fn(cfg, lm, batch, remat=remat).backward()
        grads.append({n: p.grad for n, p in lm.named_parameters()})
        calls.append(count)
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
    # the layers recomputed: the decoder stack (audio) or every layer; the
    # hybrid's shared block and the encoder are not
    if cfg.family == "audio":
        assert calls[1]["attn"] == calls[0]["attn"] + 2 * cfg.num_layers
    elif cfg.family == "hybrid":
        assert calls[1]["scan"] == 2 * calls[0]["scan"]
        assert calls[1]["attn"] == calls[0]["attn"]
    else:
        assert calls[1]["attn"] == 2 * calls[0]["attn"] > 0


@pytest.mark.parametrize("arch", ["starcoder2-7b", "llama4-scout-17b-a16e",
                                  "zamba2-7b"])
def test_three_train_steps_match_the_reference(arch):
    """``make_train_step`` three times on the same weights and batches:
    the losses against the reference's jitted step."""
    jcfg, cfg = configs(arch)
    tree = reference_tree(jcfg)
    batches = list(SyntheticLM(cfg, DataConfig(batch_size=2, seq_len=64))
                   .batches(3))
    kw = dict(lr=topt.cosine_schedule(3e-3, warmup=1, total=3))
    step = loop.make_train_step(cfg, topt.AdamW(**kw))
    lm = port_model(cfg, tree)
    state = topt.AdamW(**kw).init(dict(lm.named_parameters()))
    jkw = dict(lr=jopt.cosine_schedule(3e-3, warmup=1, total=3))
    jopt_ = jopt.AdamW(**jkw)
    jstep = jloop.make_train_step(jcfg, jopt_, donate=False)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt_.init(jparams)
    mine, theirs = [], []
    for b in batches:
        lm, state, metrics = step(lm, state, loop.batch_to(b, "cpu"))
        jparams, jstate, jm = jstep(jparams, jstate, to_jax(b))
        mine.append(float(metrics["loss"]))
        theirs.append(float(jm["loss"]))
        assert abs(float(metrics["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-4 * float(jm["grad_norm"])
    np.testing.assert_allclose(mine, theirs, rtol=1e-4)
    assert all(p.grad is None for p in lm.parameters())


def test_a_parameter_without_gradient_is_an_error():
    _, cfg = configs("starcoder2-7b")
    lm = model.init(cfg, device="cpu")
    lm.requires_grad_(True)
    lm.final_norm.scale.requires_grad_(False)   # autograd leaves it None
    opt = topt.AdamW()
    step = loop.make_train_step(cfg, opt)
    batch = loop.batch_to(first_batch(cfg), "cpu")
    with pytest.raises(RuntimeError, match="no gradient reached"):
        step(lm, opt.init(dict(lm.named_parameters())), batch)


def test_loss_decreases():
    """The reference's ``test_loss_decreases`` through the port."""
    cfg = reduce_for_smoke(get_arch("gemma-7b"))
    out = loop.train(cfg, steps=25, data=DataConfig(batch_size=4, seq_len=32),
                     opt=topt.AdamW(lr=2e-3), verbose=False, log_every=5,
                     device="cpu")
    losses = [lv for (_, lv) in out["losses"]]
    assert losses[-1] < losses[0] * 0.8


def test_train_checkpoints_and_restores(tmp_path):
    cfg = reduce_for_smoke(get_arch("mamba2-370m"))
    path = str(tmp_path / "run.npz")
    out = loop.train(cfg, steps=3, data=DataConfig(batch_size=2, seq_len=32),
                     ckpt_path=path, verbose=False, device="cpu")
    lm = model.init(cfg, torch.Generator().manual_seed(9), device="cpu")
    _, step = ckpt.restore(path, lm)
    assert step == 3
    for a, b in zip(lm.parameters(), out["params"].parameters()):
        assert torch.equal(a, b.detach())


def test_train_cli_on_the_cpu(capsys):
    assert train_cli.main(["--arch", "gemma-7b", "--steps", "10",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "(improved)" in out and "step     9" in out


def test_train_cli_defaults_to_cuda_and_refuses_what_does_not_fit():
    """Without a card the launcher raises; with one it compares the
    training state (bf16 parameters and gradients, fp32 moments: 12
    bytes a parameter) with the free memory before drawing a weight:
    full StarCoder2-7B (7.40 B parameters, 88.8 GB) does not fit 79 GB
    free, its 16-layer cut (3.93 B parameters, 47.1 GB) does.
    ``mem_get_info`` is mocked, so this runs on the CPU."""
    from unittest import mock

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--arch", "gemma-7b", "--steps", "1"])
    full = get_arch("starcoder2-7b")
    cut = dataclasses.replace(full, num_layers=16)
    assert 3.9e9 < cut.param_count() < 4.0e9
    free = (79_000_000_000, 85_000_000_000)
    cuda = torch.device("cuda", 0)
    with mock.patch.object(torch.cuda, "mem_get_info", return_value=free):
        with pytest.raises(RuntimeError, match=r"88\.8 GB .* 79\.0 GB"):
            train_cli.check_fits(full, cuda)
        train_cli.check_fits(cut, cuda)
        with mock.patch.object(train_cli, "resolve_device",
                               return_value=cuda), \
                mock.patch.object(train_cli, "train") as run:
            with pytest.raises(RuntimeError, match="GB free"):
                train_cli.main(["--arch", "starcoder2-7b", "--full"])
        run.assert_not_called()


# -------------------------------------------------------------- serving
def test_serving_builds_no_graph_even_with_trainable_parameters():
    """The engine's steps run under inference_mode: with every parameter
    requiring grad (as after training), the served logits do not, and no
    parameter gains a gradient."""
    from repro_torch.launch.serve import make_requests

    cfg = reduce_for_smoke(get_arch("zamba2-7b"))
    lm = model.init(cfg, device="cpu")
    lm.requires_grad_(True)
    eng = ServingEngine(cfg, lm, max_batch=2, max_seq=64, device="cpu")
    seen = []
    decode = eng._decode

    def spy(*args, **kwargs):
        logits, cache = decode(*args, **kwargs)
        seen.append(logits)
        return logits, cache

    eng._decode = spy
    for r in make_requests(cfg, 3, max_new=4):
        eng.submit(r)
    eng.run()
    assert seen and not any(t.requires_grad for t in seen)
    assert all(p.grad is None for p in lm.parameters())
    assert all(not t.requires_grad for leaves in eng.cache.values()
               for t in leaves.values())
