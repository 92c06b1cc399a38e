"""repro_torch's logical-axis layer (``dist.sharding``, ``launch.mesh``) and
the model helpers the dry run needs, against the JAX reference.

Held exactly: every spec ``ShardingRules.spec`` gives, for every axes
tuple the reference's parameters, caches and batches carry, under the
three rule sets, on a single-pod and a multi-pod mesh; every parameter's
reference key, logical axes, shape and dtype for all ten architectures
at full size (the port built on the meta device, the reference by
``jax.eval_shape``); per-device shard shapes against ``NamedSharding``;
the cache axes, ``make_inputs`` and ``merge_prefill_cache``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JSpec

from repro.configs import ARCHS as JARCHS
from repro.configs import reduce_for_smoke as jreduce
from repro.dist import sharding as jsh
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch.configs import ARCHS, get_arch, reduce_for_smoke
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import (Mesh, fake_group, make_local_mesh,
                                     make_mesh, make_production_mesh)
from repro_torch.models import attention, model, ssm

META = torch.device("meta")
RULES = {"train": (jsh.TRAIN_RULES, sh.TRAIN_RULES),
         "serve": (jsh.SERVE_RULES, sh.SERVE_RULES),
         "long_ctx": (jsh.LONG_CTX_RULES, sh.LONG_CTX_RULES)}
AXIS_NAMES = (("data", "model"), ("pod", "data", "model"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keyed(tree):
    """{dotted key: leaf} of a nested-dict pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (jsh._AxesLeaf, tuple)))
    return {".".join(str(p.key) for p in path): leaf for path, leaf in flat}


@pytest.fixture(scope="module")
def reference():
    """{arch: (reference key -> axes, reference key -> ShapeDtypeStruct)}
    at full size."""
    out = {}
    for name, cfg in JARCHS.items():
        boxed = jax.eval_shape(lambda c=cfg: jmodel.init(
            c, jax.random.PRNGKey(0)))
        axes = {k: a.axes for k, a in _keyed(jsh.axes_of(boxed)).items()}
        out[name] = (axes, _keyed(jsh.unbox(boxed)))
    return out


@pytest.fixture(scope="module")
def port():
    """{arch: the port's model on the meta device}, full size."""
    return {name: model.module(cfg, META) for name, cfg in ARCHS.items()}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_axes_shapes_and_dtypes_match_reference(arch, reference,
                                                       port):
    """Leaf by leaf at full size: the same reference keys, the logical
    axes the reference boxes each leaf with (a stack's leading None
    included), the shape and the dtype; ``unbox`` stacks the layers."""
    want_axes, want = reference[arch]
    got_axes = sh.axes_of(port[arch])
    got = sh.unbox(port[arch])
    assert sorted(got_axes) == sorted(want_axes) == sorted(got)
    for key, ax in want_axes.items():
        assert got_axes[key] == ax, key
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert _dtype_name(got[key].dtype) == str(want[key].dtype), key
        assert got[key].is_meta


def _all_axes(reference):
    """Every axes tuple the reference's parameters, decode caches and
    batches carry, over all architectures and shapes."""
    seen = set()
    for axes, _ in reference.values():
        seen.update(axes.values())
    for cfg in JARCHS.values():
        cache = jax.eval_shape(lambda c=cfg: jmodel.init_decode_cache(
            c, 2, 16))
        seen.update(_keyed(jmodel.cache_logical_axes(cache)).values())
    seen.update({("batch", None), ("batch",), ("batch", None, None)})
    return sorted(seen, key=repr)


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("names", AXIS_NAMES, ids=["pod1", "pod2"])
def test_rules_spec_matches_reference(rules, names, reference):
    """``spec`` entry for entry: mesh axes the mesh lacks dropped, each
    mesh axis used at most once.  The reference's ``spec`` reads only
    ``mesh.axis_names``."""
    jrules, trules = RULES[rules]
    mesh = types.SimpleNamespace(axis_names=names)
    for axes in _all_axes(reference):
        want = jrules.spec(axes, mesh)
        got = trules.spec(axes, mesh)
        assert isinstance(got, sh.PartitionSpec)
        assert tuple(got) == tuple(want), axes
    assert tuple(trules.spec(("batch", "embed"))) == \
        tuple(jrules.spec(("batch", "embed")))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_local_shape_matches_named_sharding(multi_pod, reference):
    """Each full-size parameter's per-device shard under the train and
    serve rules equals ``NamedSharding(...).shard_shape`` over an
    ``AbstractMesh`` of the same axes (every split is even); an uneven
    split, which ``shard_shape`` refuses, rounds up as GSPMD pads."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    amesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
    for rules in (sh.TRAIN_RULES, sh.SERVE_RULES):
        for axes_by_key, shapes in reference.values():
            for key, axes in axes_by_key.items():
                shape = shapes[key].shape
                spec = rules.spec(axes, mesh)
                want = NamedSharding(amesh, JSpec(*spec)).shard_shape(shape)
                assert sh.local_shape(shape, spec, mesh) == tuple(want), \
                    (key, shape, spec)
    spec = sh.PartitionSpec("data", None, ("model",))
    with pytest.raises(ValueError):
        NamedSharding(amesh, JSpec(*spec)).shard_shape((33, 5, 40))
    assert sh.local_shape((33, 5, 40), spec, mesh) == (3, 5, 3)


def test_meshes():
    local = make_local_mesh()
    assert local.axis_names == ("data", "model")
    assert local.shape == {"data": 1, "model": 1} and local.size == 1
    prod = make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and not prod.devices
    pods = make_production_mesh(multi_pod=True)
    assert pods.axis_names == ("pod", "data", "model") and pods.size == 512


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_logical_axes_match_reference(arch):
    """The stacked decode cache's axes by leaf name, and the per-layer
    ``attention.cache_logical_axes`` / ``ssm.ssm_cache_logical_axes``."""
    jcfg, cfg = JARCHS[arch], get_arch(arch)
    cache = model.init_decode_cache(cfg, 2, 16, device=META)
    jcache = jax.eval_shape(lambda: jmodel.init_decode_cache(jcfg, 2, 16))
    want = _keyed(jmodel.cache_logical_axes(jcache))
    got = _keyed(model.cache_logical_axes(cache))
    assert got == want
    assert attention.cache_logical_axes(cfg) == \
        jattn.cache_logical_axes(jcfg)
    if cfg.ssm_state:
        assert ssm.ssm_cache_logical_axes(cfg) == \
            jssm.ssm_cache_logical_axes(jcfg)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("batch,seq", [(2, 64), (1, 3), (4, 4096)])
def test_make_inputs_match_reference(arch, batch, seq):
    """Keys, shapes and dtypes of the full-size config's inputs (a VLM's
    patch count, audio's frames); a generator draws seeded values in
    range."""
    jcfg, cfg = JARCHS[arch], get_arch(arch)
    want = jmodel.make_inputs(jcfg, batch, seq, abstract=True)
    got = model.make_inputs(cfg, batch, seq, device=META)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert _dtype_name(got[k].dtype) == str(v.dtype), k
        assert got[k].is_meta
    if batch * seq <= 128:
        small = reduce_for_smoke(cfg)
        draw = [model.make_inputs(small, batch, seq, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
                for _ in range(2)]
        for k in draw[0]:
            assert torch.equal(draw[0][k], draw[1][k])
        toks = draw[0]["tokens"]
        assert int(toks.min()) >= 0 and int(toks.max()) < small.vocab_size


@pytest.mark.parametrize("arch", ["starcoder2-7b", "zamba2-7b",
                                  "deepseek-v3-671b", "whisper-tiny"])
def test_merge_prefill_cache_matches_reference(arch):
    """Seeded values in a prefill cache of S slots written into a decode
    cache of S + 5 slots (equal leaves copied, the sequence axis at
    offset 0), in place; the reduced configs' cache structures."""
    jcfg = jreduce(JARCHS[arch])
    cfg = reduce_for_smoke(get_arch(arch))
    S = 6
    batch = jmodel.make_inputs(jcfg, 2, S, abstract=True)
    params = jax.eval_shape(lambda: jsh.unbox(jmodel.init(
        jcfg, jax.random.PRNGKey(0))))
    _, pshape, _ = jax.eval_shape(lambda p, b: jmodel.forward(
        jcfg, p, b, return_cache=True), params, batch)
    dshape = jax.eval_shape(lambda: jmodel.init_decode_cache(jcfg, 2, S + 5))
    rng = np.random.default_rng(0)

    def fill(sds):
        return rng.standard_normal(sds.shape).astype(np.float32) * 8

    pre = jax.tree.map(fill, pshape)
    dec = jax.tree.map(fill, dshape)
    dtypes = jax.tree.map(lambda s: s.dtype, dshape)
    want = jmodel.merge_prefill_cache(
        jax.tree.map(lambda a, d: jnp.asarray(a.copy()).astype(d), dec,
                     dtypes),
        jax.tree.map(lambda a, s: jnp.asarray(a.copy()).astype(s.dtype),
                     pre, pshape))

    def to_torch(a, dt):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(dt)
                                         .astype(jnp.float32))).to(
            getattr(torch, str(dt)))

    got_dec = jax.tree.map(to_torch, dec, dtypes)
    got_pre = jax.tree.map(to_torch, pre,
                           jax.tree.map(lambda s: s.dtype, pshape))
    # the port's caches have the reference's structure
    assert jax.tree.structure(got_dec) == jax.tree.structure(
        model.init_decode_cache(cfg, 2, S + 5, device=META))
    out = model.merge_prefill_cache(got_dec, got_pre)
    assert out is got_dec
    for key, w in _keyed(want).items():
        g = _keyed(out)[key]
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)),
                                      err_msg=key)
    with pytest.raises(ValueError):
        model.merge_prefill_cache(
            {"x": torch.zeros(2, 3, 4)}, {"x": torch.zeros(1, 2, 4)})


def test_shard_is_a_noop_outside_axis_rules_and_raises_across_devices():
    """No-op outside ``axis_rules`` and on one device without a process
    group; across devices it places ``x`` (a fake group of 2: batch
    over data, embed's data axis already used), and it raises only on a
    mesh no process group spans."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.ones(4, 4)
    assert sh.shard(x, "batch", "embed") is x
    with sh.axis_rules(make_local_mesh(), sh.TRAIN_RULES):
        assert sh.shard(x, "batch", "embed") is x
        with pytest.raises(ValueError):
            sh.shard(x, "batch")
    two = Mesh(("data", "model"), {"data": 2, "model": 1})
    with sh.axis_rules(two, sh.TRAIN_RULES):
        with pytest.raises(ValueError, match="no process group"):
            sh.shard(x, "batch", "embed")
    with fake_group(2):
        mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
        with sh.axis_rules(mesh, sh.TRAIN_RULES):
            y = sh.shard(x, "batch", "embed")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert tuple(y.to_local().shape) == (2, 4)
    assert not torch.distributed.is_initialized()
    assert sh.shard(x, "batch") is x      # the context is gone again


def test_named_sharding_tree_places_a_full_size_model():
    """The train rules on 16x16 shard StarCoder2-7B's embedding table
    over (model, data) and stack a layer axis unsharded."""
    lm = model.module(get_arch("starcoder2-7b"), META)
    specs = sh.named_sharding_tree(sh.axes_of(lm), make_production_mesh(),
                                   sh.TRAIN_RULES)
    assert tuple(specs["embed.tok"]) == ("model", "data")
    assert tuple(specs["dense_layers.mlp.wi"]) == (None, "data", "model")
    assert sh.local_shape((49152, 4608), specs["embed.tok"],
                          make_production_mesh()) == (3072, 288)
