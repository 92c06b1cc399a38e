"""Plain versions of the kernels (the correctness oracles).

Same signatures and layouts as ``repro.kernels.ref``.  Attention: fp32
math, the finite ``NEG_INF`` mask value (a row whose keys are all
masked returns mean(V), not 0 or NaN), output in ``q.dtype``.  Inputs
may be strided views.  ``ops`` runs these for CPU tensors;
``chip_smoke.py`` holds the CUDA kernels against them on the card.

The ARMA fit (``arma_fit_ref``) stands in for the JAX program
``repro.control.forecast._fit_arma_batch``, not for a Pallas kernel; it
computes in float32 numpy and scipy on the host.
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


def _lagged(x, lag):
    """x delayed by ``lag`` steps, zero before t = 0."""
    out = np.zeros_like(x)
    if lag < len(x):
        out[lag:] = x[:len(x) - lag]
    return out


def _beta_pow(beta: float, t: int) -> np.float32:
    """fp32 beta to the power t, computed in float64 and rounded once."""
    return np.float32(np.float64(np.float32(beta)) ** t)


def arma_fit_ref(y, init, p: int, q: int, steps: int, lr: float):
    """CSS/Adam fit of ARMA(p, q) per row, the plain version of the
    ``arma_fit`` kernel, in float32 on the host.

    y: (S, L) float32; init: (S, p+1+q) float32 packed as (c, phi_1..p,
    theta_1..q).  Returns (params (S, p+1+q), loss (S,)), the loss being
    mean(e^2) at the last step's parameters before its update, as
    ``repro.control.forecast._fit_arma_core`` returns it.  Each step
    filters the residual and its p+q+1 sensitivities de_t/d(c, phi,
    theta) with ``lfilter`` (they share the residual's denominator) and
    takes g = (2/L) sum_t e_t de_t/dparam; Adam as the reference: beta
    0.9/0.999, eps 1e-8, bias correction 1 - beta^t with t = step + 1.
    Rows are independent.  Every op is rounded on its own in float32 and
    the sums over t run from t = 0 up (``cumsum``), which the kernel
    repeats bit for bit."""
    from scipy.signal import lfilter

    f32 = np.float32
    if torch.is_tensor(y):
        y, init = y.detach().cpu().numpy(), init.detach().cpu().numpy()
    ys = np.asarray(y, f32)
    prms = np.array(init, f32).reshape(len(ys), p + 1 + q)
    if steps < 1:
        raise ValueError(f"arma_fit: steps must be >= 1, got {steps}")
    n_rows, length = ys.shape
    losses = np.zeros(n_rows, f32)
    one = np.ones(1, f32)
    lr, two_over_l = f32(lr), f32(2.0) / f32(length)
    # a diverging fit overflows to inf/nan, as the reference does, quietly
    with np.errstate(over="ignore", invalid="ignore"):
        for r in range(n_rows):
            yr = ys[r]
            prm = prms[r]
            m = np.zeros_like(prm)
            v = np.zeros_like(prm)
            u = np.empty((p + 1 + q, length), f32)
            u[0] = -1.0
            for i in range(p):
                u[1 + i] = -_lagged(yr, 1 + i)
            for it in range(steps):
                theta = prm[1 + p:]
                e = arma_residuals(yr, prm[0], prm[1:1 + p], theta)
                for j in range(q):
                    u[1 + p + j] = -_lagged(e, 1 + j)
                sens = lfilter(one, np.concatenate([one, theta]), u, axis=-1)
                g = np.cumsum(sens * e, axis=-1)[:, -1] * two_over_l
                losses[r] = np.cumsum(e * e)[-1] / f32(length)
                m = f32(0.9) * m + f32(0.1) * g
                v = f32(0.999) * v + f32(0.001) * g * g
                mh = m / (f32(1) - _beta_pow(0.9, it + 1))
                vh = v / (f32(1) - _beta_pow(0.999, it + 1))
                prm = prm - lr * mh / (np.sqrt(vh) + f32(1e-8))
            prms[r] = prm
    return torch.from_numpy(prms), torch.from_numpy(losses)
