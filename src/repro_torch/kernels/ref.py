"""Plain versions of the kernels (the correctness oracles).

Same signatures and layouts as ``repro.kernels.ref``.  Attention: fp32
math (the weights rounded to V's dtype under ``flags.ATTN_BF16_STREAM``),
the finite ``NEG_INF`` mask value (a row whose keys are all masked
returns mean(V), not 0 or NaN), output in ``q.dtype``.  Inputs may be
strided views.  ``ops`` runs these for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.

The ARMA fit (``arma_fit_ref``) stands in for the JAX program
``repro.control.forecast._fit_arma_batch``, not for a Pallas kernel; it
computes in float32 numpy on the host, in the kernel's blocked order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist import sharding
from repro_torch.models import flags

NEG_INF = -1e30


def _prefill_mask(q_pos, k_pos, causal: bool, window: int):
    """(B, S, T): the pairs the prefill kernel keeps."""
    kp, qp = k_pos[:, None, :], q_pos[:, :, None]
    mask = (kp >= 0) & (qp >= 0)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    return mask


def _group(x, Hkv: int):
    """(B, H, S, d) -> (B, Hkv, g, S, d) fp32."""
    B, H, S, d = x.shape
    return x.reshape(B, Hkv, H // Hkv, S, d).float()


def _masked_scores(q, k, mask, scale: float):
    """(B, Hkv, g, S, T) fp32: the scaled scores, NEG_INF where masked.
    Placed with head_dim split, the partial products are all-reduced, as
    GSPMD does (``sharding.reduced``)."""
    s = sharding.reduced(torch.einsum("bkgsd,bktd->bkgst",
                                      _group(q, k.shape[1]), k.float()))
    return (s * scale).masked_fill(~mask[:, None, None], NEG_INF)


def _stream(w, v):
    """The softmax weights as the weighted sum over V takes them: fp32, or
    with ``flags.ATTN_BF16_STREAM`` rounded to V's dtype first (the
    reference's bf16 operands with fp32 accumulation; the products of
    bf16 values are exact in fp32, so widening them loses nothing)."""
    return w.to(v.dtype).float() if flags.ATTN_BF16_STREAM else w


def flash_attention_ref(q, k, v, q_pos, k_pos, *, scale: float,
                        causal: bool = True, window: int = 0):
    """q: (B,H,S,hd); k: (B,Hkv,T,hd); v: (B,Hkv,T,hd_v); q_pos: (B,S);
    k_pos: (B,T).  Returns (B,H,S,hd_v)."""
    return _prefill_ref(q, k, v, q_pos, k_pos, scale, causal, window)[0]


def flash_attention_lse_ref(q, k, v, q_pos, k_pos, *, scale: float,
                            causal: bool = True, window: int = 0):
    """``flash_attention_ref``'s output and each row's log-sum-exp (B,H,S)
    fp32 of its scaled, masked scores; about NEG_INF for a row that keeps
    no key (NEG_INF + log T rounds to NEG_INF)."""
    return _prefill_ref(q, k, v, q_pos, k_pos, scale, causal, window,
                        lse=True)


def _prefill_ref(q, k, v, q_pos, k_pos, scale, causal, window, lse=False):
    B, H, S, _ = q.shape
    s = _masked_scores(q, k, _prefill_mask(q_pos, k_pos, causal, window),
                       scale)
    w = _stream(torch.softmax(s, dim=-1), v)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    o = o.reshape(B, H, S, v.shape[-1]).to(q.dtype)
    if not lse:
        return o, None
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, o, lse, do, q_pos, k_pos, *,
                            scale: float, causal: bool = True,
                            window: int = 0):
    """The gradients (dq, dk, dv) of the prefill attention's output ``o``
    given its gradient ``do`` (B,H,S,hd_v) and the forward's ``lse``
    (B,H,S), from the explicit formulas (fp32, each in its input's
    dtype)::

        P  = exp(scale Q K^T - lse) on kept pairs, 0 on masked ones
        dV = P^T dO     dP = dO V^T     D = rowsum(dO o O)
        dS = P o (dP - D)     dQ = scale dS K     dK = scale dS^T Q

    summed over each kv head's group of query heads.  The reference masks
    with ``jnp.where``, so a masked score's gradient is 0; a row that
    keeps no key (lse <= NEG_INF / 2) took mean(V): P = 1/T over every
    key feeds dV, and its dS is 0.  This is the yardstick of the kernel
    ``csrc/flash_attention_bwd.cuh``, which computes the same.
    """
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    mask = _prefill_mask(q_pos, k_pos, causal, window)[:, None, None]
    s = _masked_scores(q, k, mask[:, 0, 0], scale)
    lse = lse.float().reshape(B, Hkv, H // Hkv, S, 1)
    none = lse <= 0.5 * NEG_INF
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    p = torch.where(none, 1.0 / T, p)
    dog = _group(do, Hkv)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = sharding.reduced(torch.einsum("bkgsd,bktd->bkgst", dog,
                                       v.float()))
    dsum = sharding.reduced((dog * _group(o, Hkv)).sum(-1, keepdim=True))
    ds = torch.where(mask & ~none, p * (dp - dsum), 0.0)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, _group(q, Hkv)) * scale
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q, k, v, k_pos, cur_pos, *, scale: float,
                         window: int = 0):
    """q: (B,H,hd); k/v: (B,Hkv,T,hd); k_pos: (B,T); cur_pos: (B,)."""
    B, H, hd = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    s = sharding.reduced(torch.einsum("bkgd,bktd->bkgt", qg,
                                      k.float())) * scale
    cur = cur_pos[:, None]
    mask = (k_pos >= 0) & (k_pos <= cur)
    if window:
        mask &= (cur - k_pos) < window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    w = _stream(torch.softmax(s, dim=-1), v)
    o = torch.einsum("bkgt,bktd->bkgd", w, v.float())
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


def ssd_state_scan_ref(states, decay, s0):
    """Cross-chunk SSD recurrence, S_i = S_{i-1} * decay_i + states_i.

    states: (b,c,h,p,n) fp32; decay: (b,c,h); s0: (b,h,p,n).  Returns
    (prev (b,c,h,p,n), the state entering each chunk, and final
    (b,h,p,n)).  The product and the sum are separate ops (no FMA), which
    the CUDA kernel repeats bit for bit.
    """
    carry = s0
    prev = []
    for i in range(states.shape[1]):
        prev.append(carry)
        carry = carry * decay[:, i, :, None, None] + states[:, i]
    return torch.stack(prev, dim=1), carry


def ssd_state_scan_bwd_ref(decay, prev, dprev, dfinal):
    """The reverse recurrence of ``ssd_state_scan_ref``: with G_{c-1} =
    dfinal, dstates_i = G_i, ddecay_i = sum_{p,n} G_i prev_i and G_{i-1} =
    dprev_i + decay_i G_i (product and sum separate ops, which the CUDA
    kernel repeats bit for bit); ds0 = G_{-1}.  decay (b,c,h), prev and
    dprev (b,c,h,p,n), dfinal (b,h,p,n), fp32.  Returns (dstates,
    ddecay, ds0)."""
    g = dfinal
    dstates, ddecay = [], []
    for i in range(prev.shape[1] - 1, -1, -1):
        dstates.append(g)
        ddecay.append((g * prev[:, i]).sum(dim=(-2, -1)))
        g = dprev[:, i] + decay[:, i, :, None, None] * g
    return (torch.stack(dstates[::-1], dim=1), torch.stack(ddecay[::-1], 1),
            g)


def arma_residuals(y, c, phi, theta):
    """CSS residuals of ARMA(p, q), float32 (numpy in, numpy out):

        e_t = y_t - c - sum_i phi_i y_{t-1-i} - sum_j theta_j e_{t-1-j},

    with y and e zero before t = 0.  The recursion is an IIR filter with
    denominator [1, theta_1..theta_q] (``scipy.signal.lfilter``)."""
    from scipy.signal import lfilter

    y = np.asarray(y, np.float32)
    phi = np.asarray(phi, np.float32)
    theta = np.asarray(theta, np.float32)
    x = y - np.float32(c)
    for i in range(min(len(phi), len(y) - 1)):
        x[i + 1:] -= phi[i] * y[:len(y) - 1 - i]
    den = np.concatenate([np.ones(1, np.float32), theta])
    return lfilter(np.ones(1, np.float32), den, x).astype(np.float32)


#: threads a block of the ``arma_fit`` kernel: each owns one chunk of the row
ARMA_THREADS = 256
_WARP = 32
_LANE_BITS = 5       # log2(32): the shuffle levels of the kernel's scan


def arma_chunks(length: int):
    """The chunk layout of a row of ``length`` points, a function of the
    length alone: (T, chunks).  Thread i owns the points [i T, min((i +
    1) T, L)) with T = ceil(L / 256); the first ``chunks`` = ceil(L / T)
    threads own points (all T of them but the last, which may own
    fewer)."""
    span = -(-length // ARMA_THREADS)
    return span, -(-length // span)


def adam_bias(steps: int) -> np.ndarray:
    """(steps, 2) float32: Adam's bias corrections 1 - 0.9^t and
    1 - 0.999^t for t = 1..steps, each power taken in float64 and rounded
    once to float32.  The plain version and the kernel (which gets them
    from the host) read the same values."""
    f32 = np.float32
    out = np.empty((steps, 2), f32)
    for it in range(steps):
        for j, beta in enumerate((0.9, 0.999)):
            out[it, j] = f32(1) - f32(np.float64(f32(beta)) ** (it + 1))
    return out


def _ma(th, h):
    """-theta_q h_q - theta_{q-1} h_{q-1} - ... - theta_1 h_1, each
    product and difference rounded on its own, in this order; ``h[j]``
    is the value j + 1 steps back."""
    z = -(th[-1] * h[-1])
    for j in range(len(th) - 2, -1, -1):
        z = z - th[j] * h[j]
    return z


def _matvec(pw, v):
    """(pw v)_r = pw_r0 v_0 + pw_r1 v_1 + ..., summed from the left."""
    out = []
    for row in pw:
        acc = row[0] * v[0]
        for m in range(1, len(v)):
            acc = acc + row[m] * v[m]
        out.append(acc)
    return out


def _scan(b, powers):
    """Chunk carries -> the state entering each chunk (chunk axis last).

    ``b[r]`` is component r of each chunk's end state from a zero entry;
    ``powers[k]`` = M^(2^k), k = 0..5.  The kernel's order, on the 256
    threads as 8 warps of 32 lanes (threads without points hold 0): a
    Hillis-Steele scan within each warp (at level k lane l >= d = 2^k adds
    M^d times lane l - d's state); each warp's entering state E folded
    from the totals of the warps before it (E = M^32 E + total, from 0);
    then lane l enters at lane l - 1's state plus M^l E, M^l applied by
    the bits of l from the lowest (lane 0 at E)."""
    chunks = b[0].shape[-1]
    lead = b[0].shape[:-1]
    v = []
    for comp in b:
        w = np.zeros(lead + (ARMA_THREADS,), comp.dtype)
        w[..., :chunks] = comp
        v.append(w.reshape(lead + (ARMA_THREADS // _WARP, _WARP)))
    for k in range(_LANE_BITS):
        d = 1 << k
        add = _matvec(powers[k], [comp[..., :-d] for comp in v])
        nv = []
        for comp, a in zip(v, add):
            comp = comp.copy()
            comp[..., d:] = comp[..., d:] + a
            nv.append(comp)
        v = nv
    enter = [np.zeros(lead + (1, 1), v[0].dtype) for _ in v]
    warps = [enter]
    for w in range(ARMA_THREADS // _WARP - 1):
        enter = [a + comp[..., w:w + 1, _WARP - 1:]
                 for a, comp in zip(_matvec(powers[_LANE_BITS], enter), v)]
        warps.append(enter)
    lane = np.arange(_WARP)
    ins = [np.broadcast_to(np.concatenate(e, axis=-2), comp.shape)
           for e, comp in zip(zip(*warps), v)]
    for k in range(_LANE_BITS):
        moved = _matvec(powers[k], ins)
        ins = [np.where((lane >> k) & 1 > 0, a, e)
               for a, e in zip(moved, ins)]
    out = []
    for comp, e in zip(v, ins):
        prev = np.zeros_like(comp)
        prev[..., 1:] = comp[..., :-1]
        s = np.where(lane == 0, e, prev + e)
        out.append(s.reshape(lead + (ARMA_THREADS,))[..., :chunks])
    return out


def _tree_sum(parts):
    """(S, chunks, n) per-thread sums -> (S, n): the kernel's fixed tree,
    halving within each warp of 32 threads, then across its 8 warps."""
    n_rows, chunks, width = parts.shape
    w = np.zeros((n_rows, ARMA_THREADS, width), parts.dtype)
    w[:, :chunks] = parts
    w = w.reshape(n_rows, ARMA_THREADS // _WARP, _WARP, width)
    h = _WARP // 2
    while h:
        w = w[:, :, :h] + w[:, :, h:2 * h]
        h //= 2
    w = w[:, :, 0]
    h = ARMA_THREADS // _WARP // 2
    while h:
        w = w[:, :h] + w[:, h:2 * h]
        h //= 2
    return w[:, 0]


def arma_fit_ref(y, init, p: int, q: int, steps: int, lr: float):
    """CSS/Adam fit of ARMA(p, q) per row, the plain version of the
    ``arma_fit`` kernel, in float32 numpy on the host.

    y: (S, L) float32; init: (S, p+1+q) float32 packed as (c, phi_1..p,
    theta_1..q).  Returns (params (S, p+1+q), loss (S,)), the loss being
    mean(e^2) at the last step's parameters before its update, as
    ``repro.control.forecast._fit_arma_core`` returns it.

    Each Adam step computes the residual e and its sensitivities
    de/d(c, phi, theta), all of which obey e's recursion, by a blocked
    scan over each row's chunks (``arma_chunks``): every chunk runs from
    a zero state to its end state, a scan carries the end states across
    chunks with powers of the chunk's homogeneous response M, and every
    chunk runs again from the state so found.  The first scan carries
    e, s_c and s_phi; the second s_theta_1, whose input -e_{t-1} needs
    the final e; s_theta_j is s_theta_1 delayed by j - 1 points.  The
    gradient is g = (2/L) sum_t e_t s_t, each chunk's sum taken in t
    order and the chunks' sums by the kernel's tree; Adam as the
    reference: beta 0.9/0.999, eps 1e-8, bias correction 1 - beta^t with
    t = step + 1.  Loops run over the point inside a chunk, the scan's
    levels and the steps; every op is vectorised over rows and chunks
    and rounded on its own in float32, in the kernel's order, which
    the kernel repeats bit for bit.  Rows are independent."""
    f32 = np.float32
    if torch.is_tensor(y):
        y, init = y.detach().cpu().numpy(), init.detach().cpu().numpy()
    ys = np.asarray(y, f32)
    n_rows, length = ys.shape
    k_all = p + 1 + q
    prm = np.array(init, f32).reshape(n_rows, k_all)
    if steps < 1:
        raise ValueError(f"arma_fit: steps must be >= 1, got {steps}")
    span, chunks = arma_chunks(length)
    padded = np.zeros((n_rows, p + chunks * span), f32)
    padded[:, p:p + length] = ys
    # yc[:, i, tau] = y at i T + tau; lags[l][:, i, tau] = y l + 1 points
    # earlier (0 before t = 0 and past the row's end)
    at = p + np.arange(chunks)[:, None] * span + np.arange(span)
    yc = padded[:, at]
    lags = [padded[:, at - 1 - i] for i in range(p)]
    valid = (at - p) < length
    # inputs of the chains that do not depend on e: -1 (c), -y_{t-1-i}
    u = np.empty((p + 2, n_rows, chunks, span), f32)
    u[1] = -1.0
    for i in range(p):
        u[2 + i] = -lags[i]
    zeros = np.zeros((n_rows, chunks), f32)
    bias = adam_bias(steps)
    m = np.zeros_like(prm)
    v = np.zeros_like(prm)
    losses = np.zeros(n_rows, f32)
    lr, two_over_l = f32(lr), f32(2.0) / f32(length)
    # a diverging fit overflows to inf/nan, as the reference does, quietly
    with np.errstate(over="ignore", invalid="ignore"):
        for it in range(steps):
            x = yc - prm[:, 0, None, None]
            for i in range(p):
                x = x - prm[:, 1 + i, None, None] * lags[i]
            parts = _chains(x, u, prm[:, 1 + p:], valid, span, zeros)
            tot = _tree_sum(parts)
            losses = tot[:, 0] / f32(length)
            g = tot[:, 1:] * two_over_l
            m = f32(0.9) * m + f32(0.1) * g
            v = f32(0.999) * v + f32(0.001) * g * g
            mh = m / bias[it, 0]
            vh = v / bias[it, 1]
            prm = prm - lr * mh / (np.sqrt(vh) + f32(1e-8))
    return torch.from_numpy(prm), torch.from_numpy(losses)


def _chains(x, u, theta, valid, span, zeros):
    """One step's per-chunk sums (S, chunks, 2+p+q): sum e^2, then sum
    e s for s = s_c, s_phi_1..p, s_theta_1..q, each over the chunk's
    points in t order.  x: (S, chunks, T) the residual's input; u: the
    inputs of e (slot 0, filled here), s_c and s_phi."""
    q = theta.shape[1]
    u[0] = x
    n_a = len(u)
    acc = [zeros] * (n_a + q)

    def add(i, tau, val):
        acc[i] = np.where(valid[:, tau], acc[i] + val, acc[i])

    if q == 0:
        for tau in range(span):
            e = u[0, ..., tau]
            for i in range(n_a):
                add(i, tau, e * e if i == 0 else e * u[i, ..., tau])
        return np.stack(acc, axis=-1)
    th = [theta[:, j, None] for j in range(q)]
    # M = the homogeneous response over T points: column j from the
    # state that is 1 at lag j + 1
    eye = np.eye(q, dtype=np.float32)
    h = [np.broadcast_to(eye[r], theta.shape).copy() for r in range(q)]
    for _ in range(span):
        h = [_ma(th, h)] + h[:-1]
    powers = [h]
    for _ in range(_LANE_BITS):
        pw = powers[-1]
        nxt = []
        for r in range(q):
            a = pw[r][:, 0, None] * pw[0]
            for mm in range(1, q):
                a = a + pw[r][:, mm, None] * pw[mm]
            nxt.append(a)
        powers.append(nxt)
    powers = [[[pw[r][:, c, None, None] for c in range(q)] for r in range(q)]
              for pw in powers]
    # scan 1: e, s_c, s_phi from zero, carried, run again from the carry
    st = [np.zeros_like(u[:, ..., 0]) for _ in range(q)]
    for tau in range(span):
        st = [_ma(th, st) + u[..., tau]] + st[:-1]
    enter = _scan(st, powers)
    st = list(enter)
    sq = [zeros] * q
    for tau in range(span):
        val = _ma(th, st) + u[..., tau]
        vq = _ma(th, sq) + -st[0][0]
        e = val[0]
        add(0, tau, e * e)
        for i in range(1, n_a):
            add(i, tau, e * val[i])
        st = [val] + st[:-1]
        sq = [vq] + sq[:-1]
    # scan 2: s_theta_1, input -e_{t-1}, with e run again from its carry
    enter_q = _scan(sq, powers)
    es = [s[0] for s in enter]
    sq = list(enter_q)
    for tau in range(span):
        e = _ma(th, es) + x[..., tau]
        vq = _ma(th, sq) + -es[0]
        add(n_a, tau, e * vq)
        for j in range(1, q):
            add(n_a + j, tau, e * sq[j - 1])
        es = [e] + es[:-1]
        sq = [vq] + sq[:-1]
    return np.stack(acc, axis=-1)


# ------------------------------------------------------------ bucket step
# The plain version of the vector engine's bucket step (``bucket_step``
# kernel), in place of the JAX program ``_build_step`` of
# ``repro.sim.vector.engine`` run under ``lax.scan`` and ``jax.vmap``:
# replicas are the leading dimension R.  Every op is one IEEE float32 op
# in the order the kernel does it (no fused multiply-add, ``fmod`` for
# the reference's float ``mod``), and every reduction has a fixed order:
# a left fold in index order (``_fold``), or, for the ring's pending
# instances and the per-bucket scale-out/-in totals, a warp's order
# (``_lane_sum``).  So the kernel and this version agree bit for bit, on
# the card and on the CPU.

BUCKET_EPS = 1e-9
DRAIN_RING = 3        # scale-ins serve ~1 bucket before reaping to spot

#: carry keys, in the reference's order (``engine._init_carry``)
BUCKET_CARRY = ("live", "f_tok", "qp", "qo", "qn", "d_o", "d_n", "ring",
                "drainq", "spot", "warm", "wloc", "cd", "tgt", "fc", "dep",
                "down", "dead", "park_p", "park_o", "park_n", "relcum",
                "omega", "has_om")
#: per-replica parameters (``engine._prm``); ``mode`` is held as a float
BUCKET_PRM = ("mode", "lt_i", "lt_ua", "up", "down", "cd_b", "min_inst",
              "ua_hi", "ua_lo", "ua_win_b", "hour_b", "route_thr",
              "plan_router", "has_qm", "qm_sig", "qm_one", "qm_two",
              "qm_age", "chiron_theta", "chiron_mixed", "chiron_prof",
              "drop_budget_b", "caps")
#: per-bucket inputs, shared by the replicas; the bucket index is b0 + s
BUCKET_XS = ("iw_n", "iw_p", "iw_o", "niw_n", "niw_p", "niw_o", "obs",
             "fcum")
#: per-bucket outputs
BUCKET_YS = ("delay", "tbt", "nw", "util", "inst", "waste", "spot", "done",
             "drop", "so", "si")
#: per-cell constants of a fleet (``engine._Static``): service rates,
#: then the acquisition delays in buckets (small integers, exact)
BUCKET_CONSTS = ("kv", "ptps", "tbt0", "alpha", "mb", "swap_b", "local_b",
                 "remote_b")


class BucketLayout:
    """Where each array of the bucket step lies in its packed float32 row.

    The carry of a replica is one row of F floats, its parameters one of
    K, a bucket's inputs one of X and its outputs one of Y; each key's
    array is a contiguous slice in the order of ``BUCKET_*``.  The
    kernel reads these offsets (``bucket_step.Layout``).
    """

    def __init__(self, M: int, P: int, J: int, L: int, dt: float):
        self.M, self.P, self.J, self.L, self.LD = M, P, J, L, DRAIN_RING
        self.C = C = M * P
        self.dt = float(dt)
        cj = (C, J)
        self.carry_shapes = {
            "ring": (L, C, J), "drainq": (self.LD, C, J), "spot": (J,),
            "warm": (M, J), "wloc": (M, J), "dep": (M, J), "down": (J,),
            "dead": (C,), "relcum": (C,), "omega": (C, J, J)}
        self.carry_shapes = {k: self.carry_shapes.get(k, cj)
                             for k in BUCKET_CARRY}
        self.prm_shapes = {k: () for k in BUCKET_PRM}
        self.prm_shapes.update(chiron_prof=(C,), caps=(J,))
        self.xs_shapes = {k: cj for k in BUCKET_XS}
        self.xs_shapes["fcum"] = (C,)
        self.ys_shapes = {k: cj for k in BUCKET_YS}
        self.ys_shapes.update(nw=(C,), spot=(J,), so=(), si=())
        self.consts_shapes = {k: (C,) for k in BUCKET_CONSTS}
        self.carry_off, self.F = self._offsets(self.carry_shapes)
        self.prm_off, self.K = self._offsets(self.prm_shapes)
        self.xs_off, self.X = self._offsets(self.xs_shapes)
        self.ys_off, self.Y = self._offsets(self.ys_shapes)
        self.consts_off, self.NC = self._offsets(self.consts_shapes)
        self._index = {}

    @staticmethod
    def _offsets(shapes):
        off, at = {}, 0
        for k, s in shapes.items():
            off[k] = at
            at += int(np.prod(s, dtype=np.int64))
        return off, at

    @staticmethod
    def unpack(flat, shapes, offsets):
        """Views of each key's array in ``flat`` (..., n): numpy or torch;
        writing a view writes ``flat``."""
        lead = tuple(flat.shape[:-1])
        out = {}
        for k, s in shapes.items():
            n = int(np.prod(s, dtype=np.int64))
            part = flat[..., offsets[k]:offsets[k] + n]
            out[k] = part.reshape(lead + tuple(s))
        return out

    @staticmethod
    def pack_into(flat, tree, shapes, offsets):
        """Write each key of ``tree`` into its slice of ``flat``."""
        lead = tuple(flat.shape[:-1])
        for k, s in shapes.items():
            n = int(np.prod(s, dtype=np.int64))
            flat[..., offsets[k]:offsets[k] + n] = tree[k].reshape(lead + (n,))
        return flat

    def carry(self, flat):
        return self.unpack(flat, self.carry_shapes, self.carry_off)

    def prm(self, flat):
        return self.unpack(flat, self.prm_shapes, self.prm_off)

    def xs(self, flat):
        return self.unpack(flat, self.xs_shapes, self.xs_off)

    def ys(self, flat):
        return self.unpack(flat, self.ys_shapes, self.ys_off)

    def consts(self, flat):
        return self.unpack(flat, self.consts_shapes, self.consts_off)

    def index(self, device):
        """Tensors of the step on ``device``, made once: each home's
        priority order (home, then the other regions ascending), the
        regions, the cells, and J as a float32 tensor (CUDA divides by a
        host scalar as a product with its reciprocal, which rounds
        apart from a division)."""
        got = self._index.get(str(device))
        if got is None:
            J = self.J
            pri = [[h] + [k for k in range(J) if k != h] for h in range(J)]
            got = (torch.tensor(pri, device=device),
                   torch.arange(J, device=device),
                   torch.arange(self.C, device=device),
                   torch.tensor(float(J), device=device))
            self._index[str(device)] = got
        return got


def _fold(x, dim: int):
    """Sum over ``dim`` as a left fold in index order: x0 + x1 + ..."""
    s = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        s = s + x.select(dim, i)
    return s


def _lane_sum(x, dim: int):
    """Sum over ``dim`` in a warp's order: lane l folds elements l, l + 32,
    l + 64, ... (zeros past the end) in index order, then the 32 lanes
    halve as ``__shfl_down_sync`` by 16, 8, 4, 2, 1."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    k = max(1, -(-n // _WARP))
    if k * _WARP != n:
        x = torch.nn.functional.pad(x, (0, k * _WARP - n))
    x = x.reshape(x.shape[:-1] + (k, _WARP))
    s = _fold(x, x.dim() - 2)
    h = _WARP // 2
    while h:
        s = s[..., :h] + s[..., h:2 * h]
        h //= 2
    return s[..., 0]


def _pool_sum(x, M: int, P: int):
    """(R, C, J) cells -> (R, M, J): each model's pools, folded."""
    return _fold(x.reshape(x.shape[0], M, P, x.shape[-1]), 2)


def _cells(x, P: int):
    """(R, M, ...) per model -> (R, C, ...): each cell takes its model's."""
    return x.repeat_interleave(P, dim=1)


def _route(a, rm):
    """out[c, k] = fold over j of a[c, j] * rm[c, j, k]."""
    return _fold(a[..., None] * rm, 2)


def bucket_step_ref(lay: BucketLayout, consts, prm, carry, x, b):
    """One bucket for R replicas, step by step as ``engine.py``'s
    ``step`` (its numbered sections).  ``consts``: per-cell arrays (C,);
    ``prm``: (R, ...); ``carry``: (R, ...); ``x``: one bucket's inputs
    (C, J) or (C,), shared; ``b``: the bucket's index, an int or an int64
    tensor on the carry's device (then the step never reads it on the
    host, and one CUDA graph of it serves every bucket).  Returns (carry,
    ys), new tensors."""
    C, J, M, P, L, LD, dt = (lay.C, lay.J, lay.M, lay.P, lay.L, lay.LD,
                             lay.dt)
    eps = BUCKET_EPS
    R = carry["live"].shape[0]
    where, mn_, mx_ = torch.where, torch.minimum, torch.maximum
    lo = torch.clamp_min
    one = lambda v: v.reshape(R, 1, 1)          # per replica, vs (R, C, J)
    KV, PTPS, TBT0, ALPHA, MB = (consts[k].reshape(1, C, 1) for k in
                                 ("kv", "ptps", "tbt0", "alpha", "mb"))
    delays = [consts[k].long() for k in ("swap_b", "local_b", "remote_b")]
    dev = carry["live"].device
    pri, regions, ci, j_f = lay.index(dev)
    b = torch.as_tensor(b, dtype=torch.int64, device=dev)

    # -- 1. activate pending instances / reap drained ones
    idx = (b % L).view(1)
    ring = carry["ring"].clone()
    live = carry["live"] + ring.index_select(1, idx)[:, 0]
    ring.index_fill_(1, idx, 0.0)
    idx_d = (b % LD).view(1)
    drainq = carry["drainq"].clone()
    reap = drainq.index_select(1, idx_d)[:, 0]
    drainq.index_fill_(1, idx_d, 0.0)
    spot = carry["spot"] + _fold(reap, 1)
    warm = carry["warm"] + _pool_sum(reap, M, P)
    draining = _fold(drainq, 1)
    pend = _lane_sum(ring, 1)
    dep_c = _cells(carry["dep"], P)
    down = carry["down"]

    # -- 2. utilization
    outst = carry["qp"] + carry["qo"] + carry["f_tok"]
    alive = live > 0.5
    u = where(alive, torch.clamp(outst / lo(KV * live, 1.0), 0.0, 1.0),
              1.0)
    total = live + pend

    # -- 3. routing matrix Rm[c, home, dest]
    ok_region = (dep_c > 0.5) & (down[:, None, :] < 0.5)
    score = where(alive, u, where(ok_region, 1.5, 2.0))
    below = score < one(prm["route_thr"])
    fallback = torch.argmin(score, dim=2)
    bp = below[:, :, pri]                        # (R, C, home, priority)
    first = pri[regions[None, None, :],
                torch.argmax(bp.to(torch.uint8), dim=3)]
    dest = where(bp.any(dim=3), first, fallback[:, :, None])
    # one-hot by comparison: ``F.one_hot`` reads the indices' range on
    # the host on the CPU (the trace tier's T1)
    thr_mat = (dest[..., None] == regions).to(torch.float32)
    om = carry["omega"] * alive[:, :, None, :].to(torch.float32)
    rs = _fold(om, 3)[..., None]
    om = where(rs > eps, om / lo(rs, eps), thr_mat)
    use_om = (one(prm["plan_router"]) > 0.5) & (carry["has_om"] > 0.5)
    rm = where(use_om[..., None], om, thr_mat)

    # -- 4. route this bucket's arrivals (NIW parks under a QM)
    hq = one(prm["has_qm"])
    nq = 1.0 - hq
    r_n = _route(x["iw_n"] + nq * x["niw_n"], rm)
    r_p = _route(x["iw_p"] + nq * x["niw_p"], rm)
    r_o = _route(x["iw_o"] + nq * x["niw_o"], rm)

    # -- 5. scaling policy
    cd_now = lo(carry["cd"] - 1.0, 0.0)
    obs = x["obs"]
    mn = one(prm["min_inst"])
    up, dn = one(prm["up"]), one(prm["down"])
    d_re = where(u > up, 1.0,
                 where((u < dn) & (total > mn + 0.5), -1.0, 0.0))
    d_re = where((r_n > eps) & alive, d_re, 0.0)
    tgtv = carry["tgt"]
    has_t = tgtv > -0.5
    target = mx_(tgtv, mn)
    jump = where(has_t & ((target - total).abs() > 0.49), target - total,
                 0.0)
    fcv = lo(carry["fc"], 1e-9)
    hour_b = one(prm["hour_b"])
    pos = torch.fmod(b.to(torch.float32).expand(R, 1, 1), hour_b)
    in_win = (one(prm["lt_ua"]) > 0.5) & (pos >= hour_b
                                          - one(prm["ua_win_b"]))
    up_a = (u > up) & (total < target - 0.5)
    dn_a = (u < dn) & (total > mx_(target, mn) + 0.5)
    ua_up = in_win & (total > target - 0.5) & \
        (obs >= one(prm["ua_hi"]) * fcv) & (u > up)
    ua_dn = in_win & (total < target + 0.5) & (total > mn + 0.5) & \
        (obs <= one(prm["ua_lo"]) * fcv)
    d_ltu = where(up_a, 1.0, where(dn_a, -1.0, where(
        ua_up, 1.0, where(ua_dn, -1.0, 0.0))))
    d_ltu = where(has_t, d_ltu, 0.0)
    lt_i = one(prm["lt_i"]) > 0.5
    d_lt = where(lt_i, jump, d_ltu)
    park_v = carry["park_p"] + carry["park_o"] + hq * (x["niw_p"]
                                                       + x["niw_o"])
    park_tok = _fold(_pool_sum(park_v, M, P), 2)            # (R, M)
    bk_c = _cells(park_tok, P) / j_f                         # (R, C)
    prof = prm["chiron_prof"][:, :, None]
    req_i = torch.ceil(obs / lo(one(prm["chiron_theta"]) * prof, 1e-9))
    req_b = torch.ceil(bk_c[:, :, None] / lo(prof * 3600.0, 1e-9))
    tgt_ch = mx_(req_i + req_b + one(prm["chiron_mixed"]), mn)
    d_ch = where((tgt_ch - total).abs() > 0.49, tgt_ch - total, 0.0)
    mode = one(prm["mode"])
    delta = where(mode == 0.0, d_re, where(mode == 1.0, d_lt, d_ch))
    act = ((cd_now < 0.5) | lt_i) & (delta.abs() > 0.49)
    delta = where(act, delta, 0.0)
    cd = where(act & ~lt_i, one(prm["cd_b"]), cd_now)

    # -- 6. actuate: spot acquisition (warm-first) and drains
    want_up = where(ok_region, lo(delta, 0.0), 0.0)
    req_j = _fold(want_up, 1)
    inst = live + pend + draining
    used_j = _fold(inst, 1)
    avail_j = lo(mn_(spot, lo(prm["caps"] - used_j, 0.0)), 0.0)
    fac = where(req_j > eps, torch.clamp_max(avail_j / lo(req_j, eps), 1.0),
                0.0)
    grant = want_up * fac[:, None, :]
    g_m = _pool_sum(grant, M, P)
    ratio = grant / lo(_cells(g_m, P), eps)
    warm_take = mn_(grant, _cells(warm, P) * ratio)
    cold = grant - warm_take
    warm = lo(warm - _pool_sum(warm_take, M, P), 0.0)
    spot = spot - _fold(grant, 1)
    cold_loc = cold * where(_cells(carry["wloc"], P) > 0.5, 1.0, 0.0)
    cold_rem = cold - cold_loc
    for val, delay in zip((warm_take, cold_loc, cold_rem), delays):
        rows = (b + delay) % L
        ring[:, rows, ci] = ring[:, rows, ci] + val
    wloc = mx_(carry["wloc"], where(_pool_sum(cold, M, P) > eps, 1.0, 0.0))
    want_dn = mn_(lo(-delta, 0.0), live)
    live_after = live - want_dn
    row_d = ((b + LD - 1) % LD).view(1)
    drainq.index_copy_(1, row_d, drainq.index_select(1, row_d)
                       + want_dn[:, None])

    # -- 7. queue manager: park NIW, forced + capacity releases
    park_p = carry["park_p"] + hq * x["niw_p"]
    park_o = carry["park_o"] + hq * x["niw_o"]
    park_n = carry["park_n"] + hq * x["niw_n"]
    pk_tot = _fold(park_n, 2)
    need = mn_(lo(x["fcum"] - carry["relcum"], 0.0), pk_tot)
    fr = (need / lo(pk_tot, eps))[:, :, None]
    rel_n, rel_p, rel_o = park_n * fr, park_p * fr, park_o * fr
    park_n, park_p, park_o = park_n - rel_n, park_p - rel_p, park_o - rel_o
    q_add_n, q_add_p, q_add_o = (_route(rel_n, rm), _route(rel_p, rm),
                                 _route(rel_o, rm))
    relcum = carry["relcum"] + need
    per_inst = where(u < one(prm["qm_two"]), 2.0,
                     where(u < one(prm["qm_one"]), 1.0, 0.0))
    cap_dest = hq * where((u < one(prm["qm_sig"])) & (live_after > 0.5),
                          per_inst * live_after, 0.0)
    cap_tot = _fold(cap_dest, 2)
    pk_tot2 = _fold(park_n, 2)
    take = mn_(cap_tot, pk_tot2)
    sf = (take / lo(pk_tot2, eps))[:, :, None]
    rel2_p, rel2_o = park_p * sf, park_o * sf
    park_n, park_p, park_o = (park_n - park_n * sf, park_p - rel2_p,
                              park_o - rel2_o)
    df = cap_dest / lo(cap_tot[:, :, None], eps)
    q_add_n = q_add_n + take[:, :, None] * df
    q_add_p = q_add_p + _fold(rel2_p, 2)[:, :, None] * df
    q_add_o = q_add_o + _fold(rel2_o, 2)[:, :, None] * df
    relcum = relcum + take

    # -- 8/9. enqueue, admit to service, decode
    qn = carry["qn"] + r_n + q_add_n
    qp = carry["qp"] + r_p + q_add_p
    qo = carry["qo"] + r_o + q_add_o
    svc = live + draining
    pre_cap = PTPS * svc * dt
    slots = lo(MB * svc - carry["d_n"], 0.0)
    frac = torch.clamp(mn_(pre_cap / lo(qp, eps), slots / lo(qn, eps)),
                       0.0, 1.0)
    adm_n, adm_p, adm_o = qn * frac, qp * frac, qo * frac
    qn, qp, qo = qn - adm_n, qp - adm_p, qo - adm_o
    f_tok = carry["f_tok"] + adm_p + adm_o
    d_n = carry["d_n"] + adm_n
    d_o = carry["d_o"] + adm_o
    occ = torch.clamp(d_n / lo(MB * svc, eps), 0.0, 1.0)
    tbt = TBT0 * (1.0 + ALPHA * occ)
    srv_o = mn_(d_o, where(svc > eps, (d_n / tbt) * dt, 0.0))
    done_n = where(d_o > eps, d_n * srv_o / lo(d_o, eps), 0.0)
    rel_tok = where(d_n > eps, f_tok * done_n / lo(d_n, eps), f_tok)
    d_o, d_n, f_tok = d_o - srv_o, d_n - done_n, f_tok - rel_tok
    tiny = d_n < 1e-6
    d_o = where(tiny, 0.0, d_o)
    f_tok = where(tiny, 0.0, f_tok)
    d_n = where(tiny, 0.0, d_n)

    # -- 10. dead cells: drop queues past the retry budget
    dead = where(_fold(live_after, 2) < 0.5, carry["dead"] + 1.0, 0.0)
    flush = (dead > prm["drop_budget_b"][:, None])[:, :, None]
    drop = where(flush, qn, 0.0)
    qn = where(flush, 0.0, qn)
    qp = where(flush, 0.0, qp)
    qo = where(flush, 0.0, qo)

    # -- 11. emissions for per-request reconstruction
    delay_dest = where(qn >= 1.0, torch.clamp(
        qp * dt / lo(adm_p + 0.5 * rel_tok, eps), 0.0, 1e6), 0.0)
    delay_h = _fold(rm * delay_dest[:, :, None, :], 3)
    tbt_h = _fold(rm * tbt[:, :, None, :], 3)
    pk_fin = _fold(park_n, 2)
    nw = where(prm["has_qm"][:, None] > 0.5, mn_(lo(
        0.5 * dt + pk_fin * dt / lo(take + need, eps), 0.5 * dt),
        prm["qm_age"][:, None]), 0.0)
    out = {"live": live_after, "f_tok": f_tok, "qp": qp, "qo": qo,
           "qn": qn, "d_o": d_o, "d_n": d_n, "ring": ring,
           "drainq": drainq, "spot": spot, "warm": warm, "wloc": wloc,
           "cd": cd, "tgt": carry["tgt"], "fc": carry["fc"],
           "dep": carry["dep"], "down": down, "dead": dead,
           "park_p": park_p, "park_o": park_o, "park_n": park_n,
           "relcum": relcum, "omega": carry["omega"],
           "has_om": carry["has_om"]}
    ys = {"delay": delay_h, "tbt": tbt_h, "nw": nw, "util": u,
          "inst": inst, "waste": pend, "spot": spot, "done": done_n,
          "drop": drop, "so": _lane_sum(grant.reshape(R, C * J), 1),
          "si": _lane_sum(want_dn.reshape(R, C * J), 1)}
    return out, ys


def bucket_segment_ref(lay: BucketLayout, consts, prm, carry, xs,
                       b0: int, b1: int):
    """Buckets b0..b1-1 for R replicas on packed tensors, the plain
    version of the ``bucket_step`` kernel.  consts: (NC,); prm: (R, K);
    carry: (R, F); xs: (b1 - b0, X), row s the inputs of bucket b0 + s.
    Returns (carry (R, F), ys (R, b1 - b0, Y)), new tensors."""
    cs, pm = lay.consts(consts), lay.prm(prm)
    tree = lay.carry(carry)
    x_all = lay.xs(xs)
    steps = []
    for s in range(b1 - b0):
        tree, y = bucket_step_ref(lay, cs, pm, tree,
                                  {k: v[s] for k, v in x_all.items()},
                                  b0 + s)
        steps.append(y)
    ys = torch.empty((carry.shape[0], b1 - b0, lay.Y), dtype=torch.float32,
                     device=carry.device)
    lay.pack_into(ys, {k: torch.stack([y[k] for y in steps], dim=1)
                       for k in BUCKET_YS}, lay.ys_shapes, lay.ys_off)
    out = torch.empty_like(carry)
    lay.pack_into(out, tree, lay.carry_shapes, lay.carry_off)
    return out, ys
