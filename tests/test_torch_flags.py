"""repro_torch's model flags (``models.flags``) against the reference's, and
the MoE dispatch's static shapes against its former data-dependent form.

Each flag is held as ``tests/test_perf_opts.py`` holds the reference's:
fp32 configs, atol = rtol = 1e-5 for ``ATTN_BF16_STREAM`` (fp32 inputs:
the flag changes nothing but where V's dtype rounds) and 1e-4 for
``MOE_DECODE_DISPATCH``, here with the flag on in both packages.  In
bf16 the flagged plain attention is held to the reference's flagged
``_attend`` at the kernels' bf16 tolerance (3e-2).  The flags are
restored in ``finally``.

The MoE dispatch writes dropped pairs to a dump row instead of
selecting the kept ones with ``nonzero``, so that every shape follows
from the inputs' (the dry run traces it on the meta device).  Its
outputs, aux loss and ``moe.DROPPED`` count are held bit for bit to the
former form, kept below as ``_nonzero_dispatch``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduce_for_smoke as jreduce
from repro.dist.sharding import unbox
from repro.models import attention as jattn
from repro.models import flags as jflags
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.kernels import ref
from repro_torch.models import flags, model, moe
from repro_torch.models.convert import _flatten, _tensor, params_from_reference

MOE_ARCHS = ["llama4-scout-17b-a16e", "deepseek-v3-671b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp32(name):
    return (dataclasses.replace(jreduce(jget_arch(name)), dtype="float32"),
            dataclasses.replace(reduce_for_smoke(get_arch(name)),
                                dtype="float32"))


def _both_flags(name, on):
    setattr(flags, name, on)
    setattr(jflags, name, on)


def test_bf16_stream_forward_matches_reference():
    """Reduced Gemma-7B in fp32, the reference's weights and inputs: the
    port's forward with the flag against the reference's with the flag,
    and against its own without it."""
    jcfg, cfg = _fp32("gemma-7b")
    tree = unbox(jmodel.init(jcfg, jax.random.PRNGKey(0)))
    lm = params_from_reference(cfg, jax.tree.map(np.asarray, tree), "cpu")
    batch = jmodel.make_inputs(jcfg, 2, 16, key=jax.random.PRNGKey(1))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with torch.no_grad():
        base = model.forward(cfg, lm, tbatch)[0]
    try:
        _both_flags("ATTN_BF16_STREAM", True)
        want = jmodel.forward(jcfg, tree, batch)[0]
        with torch.no_grad():
            got = model.forward(cfg, lm, tbatch)[0]
    finally:
        _both_flags("ATTN_BF16_STREAM", False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-5,
                               rtol=1e-5)


def _qkv(seed, B=2, S=24, T=24, H=4, Hkv=2, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd))]


def _to_jnp_bf16(*arrays):
    return [jnp.asarray(a.copy()).astype(jnp.bfloat16) for a in arrays]


def _to_torch(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_stream_plain_attention_matches_reference_in_bf16(seed):
    """bf16 q, k, v: the port's plain prefill and decode attention with the
    flag against the reference's ``blockwise_attention`` and ``_attend``
    with the flag.  The flag rounds the softmax weights to bf16, so the
    port's flagged output differs from its unflagged one."""
    q, k, v = _to_jnp_bf16(*_qkv(seed))
    B, S, H, hd = q.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    scale = 1.0 / math.sqrt(hd)
    tq, tk, tv = (_to_torch(x).transpose(1, 2) for x in (q, k, v))
    tpos = torch.from_numpy(np.array(pos))
    cur = jnp.asarray([S - 1, S // 2], jnp.int32)
    kpos = jnp.where(pos <= cur[:, None], pos, -1)
    mask = ((kpos >= 0) & (kpos <= cur[:, None]))[:, None, :]
    args = (tq, tk, tv, tpos, tpos)
    dec = (tq[:, :, -1], tk, tv, torch.from_numpy(np.array(kpos)),
           torch.from_numpy(np.array(cur)))
    base = ref.flash_attention_ref(*args, scale=scale)
    base_dec = ref.decode_attention_ref(*dec, scale=scale)
    try:
        _both_flags("ATTN_BF16_STREAM", True)
        want = jattn.blockwise_attention(q, k, v, pos, pos, scale=scale)
        want_dec = jattn._attend(q[:, -1:], k, v, mask, scale)[:, 0]
        got = ref.flash_attention_ref(*args, scale=scale)
        got_dec = ref.decode_attention_ref(*dec, scale=scale)
    finally:
        _both_flags("ATTN_BF16_STREAM", False)
    for g, w in ((got.transpose(1, 2), want), (got_dec, want_dec)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=3e-2, rtol=3e-2)
    assert not torch.equal(got, base) and not torch.equal(got_dec, base_dec)


def test_moe_decode_dispatch_matches_reference():
    """Reduced Llama-4 Scout in fp32 at capacity 8 (no drops), 16 tokens
    (T * top_k >= E): decode through the dispatch in both packages, and
    the port's dispatch against its own gather."""
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=8.0)
                 for c in _fp32("llama4-scout-17b-a16e"))
    tree = jax.tree.map(np.asarray,
                        unbox(jmoe.init_moe(jcfg, jax.random.PRNGKey(0))))
    m = moe.MoE(cfg, "cpu")
    params = dict(m.named_parameters())
    with torch.no_grad():
        for name, leaf in _flatten(tree).items():
            params[name].copy_(_tensor(leaf))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 8, cfg.d_model), jnp.float32) * 0.1)
    tx = torch.from_numpy(x.copy())
    gathered, _ = moe.apply_moe(m, tx, cfg, decode=True)
    moe.DROPPED = 0
    try:
        _both_flags("MOE_DECODE_DISPATCH", True)
        want, _ = jmoe.apply_moe(tree, jnp.asarray(x), jcfg, decode=True)
        got, aux = moe.apply_moe(m, tx, cfg, decode=True)
    finally:
        _both_flags("MOE_DECODE_DISPATCH", False)
    assert isinstance(aux, torch.Tensor)        # the dispatch ran
    assert moe.DROPPED == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(got, gathered, atol=1e-4, rtol=1e-4)
    # one token of a 16-expert model: T * top_k < E, so it gathers
    one = tx[:1, :1]
    try:
        _both_flags("MOE_DECODE_DISPATCH", True)
        _, aux = moe.apply_moe(m, one, cfg, decode=True)
    finally:
        _both_flags("MOE_DECODE_DISPATCH", False)
    assert aux == 0.0


def _nonzero_dispatch(params, x, cfg):
    """The dispatch as it was: the kept pairs selected by ``nonzero``, an
    (E*C, D) buffer, the count of dropped pairs."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, gates, eidx = moe._route(params, xt, cfg)
    e_flat = eidx.reshape(-1)
    counts = torch.bincount(e_flat, minlength=E)
    f_e = counts.float() / (T * K)
    aux = E * torch.sum(f_e * probs.mean(0)) * cfg.router_aux_coef
    C = max(1, int(math.ceil(T * K / E * cfg.capacity_factor)))
    order = torch.argsort(e_flat, stable=True)
    group_start = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(e_flat)
    pos[order] = (torch.arange(T * K) - group_start[e_flat[order]])
    keep = pos < C
    kept = keep.nonzero()[:, 0]
    dropped = T * K - int(kept.numel())
    dest = e_flat * C + pos
    buf = x.new_zeros((E * C, D))
    buf[dest[kept]] = xt[kept // K]
    eo = moe._expert_products(params, buf.view(E, C, D), cfg)
    rows = x.new_zeros((T * K, D))
    rows[kept] = eo.reshape(E * C, D)[dest[kept]]
    rows = rows * gates.reshape(-1, 1).to(rows.dtype)
    y = rows.view(T, K, D).sum(1)
    if "shared" in params._modules:
        y = y + moe.apply_mlp(params.shared, xt, cfg)
    return y.reshape(B, S, D), aux, dropped


@pytest.mark.parametrize("capacity", [1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_static_dispatch_is_bit_for_bit_the_nonzero_one(arch, dtype,
                                                        capacity):
    """Seeded weights and 2 x 24 tokens sharing a direction, so that the
    config's capacity (1.25) drops pairs: the same bits out, the same
    aux loss, the same count in ``DROPPED``."""
    cfg = dataclasses.replace(reduce_for_smoke(get_arch(arch)), dtype=dtype,
                              capacity_factor=capacity)
    m = moe.MoE(cfg, "cpu")
    m.reset_parameters(torch.Generator().manual_seed(7))
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(cfg.d_model)
         + 0.5 * rng.standard_normal((2, 24, cfg.d_model))).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype))
    want, want_aux, dropped = _nonzero_dispatch(m, x, cfg)
    moe.DROPPED = 0
    got, aux = moe.apply_moe(m, x, cfg)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    assert moe.DROPPED == dropped
    assert (dropped > 0) == (capacity < 2)


def test_dispatch_traces_on_the_meta_device():
    """Full-width DeepSeek-V3 MoE layer on meta: shapes out, no count."""
    cfg = get_arch("deepseek-v3-671b")
    m = moe.MoE(cfg, torch.device("meta"))
    x = torch.empty((2, 64, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    moe.DROPPED = 3
    y, aux = moe.apply_moe(m, x, cfg)
    assert y.shape == x.shape and y.is_meta and aux.is_meta
    assert moe.DROPPED == 3
    moe.DROPPED = 0
