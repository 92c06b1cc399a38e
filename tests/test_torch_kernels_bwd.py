"""The plain backward versions of K2 and K3 against the JAX package's autodiff.

``ref.flash_attention_bwd_ref`` and ``ref.ssd_state_scan_bwd_ref`` are
written from the explicit formulas; they are the yardsticks of the
backward kernels on the card and what the CPU path trains with.  Here
they are held to ``jax.vjp`` of what the JAX package trains through (its
``_attend`` for every mask, ``blockwise_attention`` for the causal one,
and the ``lax.scan`` of ``repro.kernels.ref.ssd_state_scan_ref``) and to
torch autograd of the port's plain forwards, on the same inputs made
with numpy from a seed, in fp32.  Tolerances: 1e-5 (atol = rtol; both
sides fp32, the sums in another order), except ddecay, a sum over the
p*n state elements, which is held to 1e-5 of the sum of its terms'
magnitudes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def positions(B, S, T, masked):
    qpos = np.broadcast_to(np.arange(S, dtype=np.int32) + max(T - S, 0),
                           (B, S)).copy()
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if masked:   # padding rows (q_pos < 0) and a gap of padded keys
        qpos[0, :3] = -1
        kpos[-1, T // 4: 3 * T // 4] = -1
    return qpos, kpos


def jax_mask(qpos, kpos, causal, window):
    qp, kp = qpos[:, :, None], kpos[:, None, :]
    mask = (kp >= 0) & (qp >= 0)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    return jnp.asarray(mask)


CASES = {   # B, H, Hkv, S, T, hd, causal, window, masked, vd
    "causal gqa 2": (2, 4, 2, 19, 19, 16, True, 0, False, 0),
    "causal g 4, window": (2, 8, 2, 23, 23, 16, True, 5, False, 0),
    "fully masked rows": (2, 4, 2, 16, 24, 16, True, 4, True, 0),
    "bidirectional": (1, 4, 4, 17, 17, 32, False, 0, False, 0),
    "cross S != T": (2, 4, 4, 9, 21, 16, False, 0, False, 0),
    "MLA padded V": (1, 4, 4, 13, 13, 24, True, 0, False, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_bwd_ref_matches_jax_vjp(case):
    """(dq, dk, dv) of the plain backward against ``jax.vjp`` of the
    reference's ``_attend`` on the same mask; in the padded case V is
    zero-padded from vd to hd (the (hd, hd) pair), and dV's first vd
    columns are held to the reference's gradient of the unpadded V."""
    B, H, Hkv, S, T, hd, causal, window, masked, vd = CASES[case]
    vd = vd or hd
    rng = np.random.default_rng(sum(map(ord, case)))
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, vd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, vd)).astype(np.float32)
    qpos, kpos = positions(B, S, T, masked)
    scale = hd ** -0.5

    mask = jax_mask(qpos, kpos, causal, window)
    out, vjp = jax.vjp(lambda a, b, c: jattn._attend(a, b, c, mask, scale),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    vpad = np.zeros((B, T, Hkv, hd), np.float32)
    vpad[..., :vd] = v
    dpad = np.zeros((B, S, H, hd), np.float32)
    dpad[..., :vd] = do
    tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2)
                       for a in (q, k, vpad, dpad))
    tqp, tkp = torch.from_numpy(qpos), torch.from_numpy(kpos)
    opts = dict(scale=scale, causal=causal, window=window)
    o, lse = tref.flash_attention_lse_ref(tq, tk, tv, tqp, tkp, **opts)
    close(o.transpose(1, 2)[..., :vd], out)
    dq, dk, dv = tref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, tqp,
                                              tkp, **opts)
    close(dq.transpose(1, 2), want[0])
    close(dk.transpose(1, 2), want[1])
    close(dv.transpose(1, 2)[..., :vd], want[2])
    if masked:   # the padding rows took mean(V): dV got 1/T of their dO
        assert bool((lse[0, :, :3] <= 0.5 * tref.NEG_INF).all())


@pytest.mark.parametrize("window", [0, 6])
def test_flash_attention_bwd_ref_matches_jax_blockwise(window):
    """The causal case against the reference's training path,
    ``blockwise_attention`` (query blocks scanned), differentiated."""
    B, H, Hkv, S, hd = 2, 6, 2, 40, 16
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jp = jnp.asarray(pos)
    _, vjp = jax.vjp(lambda a, b, c: jattn.blockwise_attention(
        a, b, c, jp, jp, window=window, scale=hd ** -0.5, block_q=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2)
                       for a in (q, k, v, do))
    tp = torch.from_numpy(pos)
    opts = dict(scale=hd ** -0.5, causal=True, window=window)
    o, lse = tref.flash_attention_lse_ref(tq, tk, tv, tp, tp, **opts)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, tp, tp,
                                       **opts)
    for g, w in zip(got, want):
        close(g.transpose(1, 2), w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_op_grads_match_autograd_of_plain(case):
    """``ops.flash_attention`` on CPU tensors (the plain forward with its
    log-sum-exp, then the plain backward) against torch autograd through
    the plain forward ``ref.flash_attention_ref``."""
    B, H, Hkv, S, T, hd, causal, window, masked, _ = CASES[case]
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd))]
    w = torch.from_numpy(rng.standard_normal((B, H, S, hd))
                         .astype(np.float32))
    qpos, kpos = (torch.from_numpy(a) for a in positions(B, S, T, masked))

    def grads(fn):
        q, k, v = (torch.from_numpy(a).transpose(1, 2).requires_grad_()
                   for a in arrs)
        out = fn(q, k, v, qpos, kpos, scale=hd ** -0.5, causal=causal,
                 window=window)
        return torch.autograd.grad((out * w).sum(), (q, k, v))

    for g, want in zip(grads(tops.flash_attention),
                       grads(tref.flash_attention_ref)):
        close(g.detach(), want)


@pytest.mark.parametrize("hd,vd", [(192, 128), (32, 16)])
def test_flash_attention_op_own_v_width_matches_jax_blockwise(hd, vd):
    """V at its own head dim, not padded: ``ops.flash_attention`` on CPU
    tensors (the plain forward and backward) against the reference's
    ``blockwise_attention`` handed V at its own width, as its MLA
    prefill does, and ``jax.vjp`` of it: the output and (dq, dk, dv)."""
    B, H, Hkv, S = 1, 4, 4, 21
    rng = np.random.default_rng(hd + vd)
    q, k = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
            for n in (H, Hkv))
    v = rng.standard_normal((B, S, Hkv, vd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, vd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jp = jnp.asarray(pos)
    out, vjp = jax.vjp(lambda a, b, c: jattn.blockwise_attention(
        a, b, c, jp, jp, window=0, scale=hd ** -0.5, block_q=8),
        jnp.asarray(q.copy()), jnp.asarray(k.copy()), jnp.asarray(v.copy()))
    want = vjp(jnp.asarray(do.copy()))

    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).requires_grad_()
                  for a in (q, k, v))
    tp = torch.from_numpy(pos)
    got = tops.flash_attention(tq, tk, tv, tp, tp, scale=hd ** -0.5,
                               causal=True)
    assert got.shape == (B, H, S, vd)
    close(got.detach().transpose(1, 2), out)
    grads = torch.autograd.grad(got, (tq, tk, tv),
                                torch.from_numpy(do).transpose(1, 2))
    for g, w, x in zip(grads, want, (q, k, v)):
        assert g.transpose(1, 2).shape == x.shape
        close(g.transpose(1, 2), w)


def test_mla_prefill_hands_k2_v_at_its_own_width(monkeypatch):
    """``_mla_forward`` calls ``ops.flash_attention`` with q and k at
    nope + rope and V at ``v_head_dim``: no padded V buffer."""
    import dataclasses

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import model

    cfg = dataclasses.replace(reduce_for_smoke(get_arch("deepseek-v3-671b")),
                              dtype="float32")
    m = cfg.mla
    params = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    seen = []
    real = tops.flash_attention

    def record(q, k, v, *args, **kwargs):
        out = real(q, k, v, *args, **kwargs)
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], out.shape[-1]))
        return out

    monkeypatch.setattr(tops, "flash_attention", record)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int64))
    with torch.no_grad():
        logits, _, _ = model.forward(cfg, params, {"tokens": tokens})
    assert torch.isfinite(logits).all()
    hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert m.v_head_dim < hd
    assert seen == [(hd, hd, m.v_head_dim, m.v_head_dim)] * cfg.num_layers


@pytest.mark.parametrize("b,c,h,p,n,decay", [
    (2, 5, 3, 4, 8, "uniform"),
    (1, 1, 2, 4, 8, "uniform"),     # one chunk
    (1, 33, 2, 4, 8, "uniform"),
    (2, 4, 3, 4, 8, "zero"),
    (2, 4, 3, 4, 8, "one"),
])
def test_ssd_state_scan_bwd_ref_matches_jax_vjp(b, c, h, p, n, decay):
    """(dstates, ddecay, ds0) of the plain reverse recurrence against
    ``jax.vjp`` of the reference's ``lax.scan``, and against torch
    autograd of the port's plain forward."""
    rng = np.random.default_rng(c * 10 + b)
    states = rng.standard_normal((b, c, h, p, n)).astype(np.float32)
    dec = rng.uniform(0, 1, (b, c, h)).astype(np.float32)
    if decay != "uniform":
        dec[:] = 0.0 if decay == "zero" else 1.0
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    dprev = rng.standard_normal((b, c, h, p, n)).astype(np.float32)
    dfin = rng.standard_normal((b, h, p, n)).astype(np.float32)

    _, vjp = jax.vjp(jref.ssd_state_scan_ref, jnp.asarray(states),
                     jnp.asarray(dec), jnp.asarray(s0))
    want = vjp((jnp.asarray(dprev), jnp.asarray(dfin)))
    prev, _ = tref.ssd_state_scan_ref(*(torch.from_numpy(a) for a in
                                        (states, dec, s0)))
    got = tref.ssd_state_scan_bwd_ref(torch.from_numpy(dec), prev,
                                      torch.from_numpy(dprev),
                                      torch.from_numpy(dfin))
    close(got[0], want[0])
    close(got[2], want[2])
    mag = (got[0].abs() * prev.abs()).sum(dim=(-2, -1)).numpy()
    assert np.all(np.abs(got[1].numpy() - np.asarray(want[1]))
                  <= 1e-5 * mag + 1e-6)

    ts = [torch.from_numpy(a).requires_grad_() for a in (states, dec, s0)]
    pv, fin = tref.ssd_state_scan_ref(*ts)
    auto = torch.autograd.grad(
        (pv * torch.from_numpy(dprev)).sum()
        + (fin * torch.from_numpy(dfin)).sum(), ts)
    for g, a in zip(got, auto):
        close(g, a)
    # the op (an autograd Function over the plain versions on the CPU)
    ts = [torch.from_numpy(a).requires_grad_() for a in (states, dec, s0)]
    pv, fin = tops.ssd_state_scan(*ts)
    op = torch.autograd.grad(
        (pv * torch.from_numpy(dprev)).sum()
        + (fin * torch.from_numpy(dfin)).sum(), ts)
    for g, a in zip(got, op):
        assert torch.equal(g, a)
