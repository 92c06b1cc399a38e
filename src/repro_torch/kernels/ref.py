"""Plain versions of the kernels (the correctness oracles).

Same signatures and layouts as ``repro.kernels.ref``.  Attention: fp32
math, the finite ``NEG_INF`` mask value (a row whose keys are all
masked returns mean(V), not 0 or NaN), output in ``q.dtype``.  Inputs
may be strided views.  ``ops`` runs these for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.

The ARMA fit (``arma_fit_ref``) stands in for the JAX program
``repro.control.forecast._fit_arma_batch``, not for a Pallas kernel; it
computes in float32 numpy on the host, in the kernel's blocked order.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, q_pos, k_pos, *, scale: float,
                        causal: bool = True, window: int = 0):
    """q: (B,H,S,hd); k/v: (B,Hkv,T,hd); q_pos: (B,S); k_pos: (B,T)."""
    B, H, S, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, S, hd).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    kp, qp = k_pos[:, None, :], q_pos[:, :, None]
    mask = (kp >= 0) & (qp >= 0)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return o.reshape(B, H, S, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k, v, k_pos, cur_pos, *, scale: float,
                         window: int = 0):
    """q: (B,H,hd); k/v: (B,Hkv,T,hd); k_pos: (B,T); cur_pos: (B,)."""
    B, H, hd = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    s = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) * scale
    cur = cur_pos[:, None]
    mask = (k_pos >= 0) & (k_pos <= cur)
    if window:
        mask &= (cur - k_pos) < window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
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
