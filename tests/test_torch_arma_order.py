"""The ARMA fit's blocked order against the sequential recursion, on the CPU.

The ``arma_fit`` kernel and its plain version (``ref.arma_fit_ref``) run
each Adam step as a blocked scan over a row's chunks: the residual and
its sensitivities per chunk from a zero state, the chunks' end states
carried by a scan with powers of the chunk's state map (shuffles within
a warp, the warps' totals folded), each chunk again from the carried
state, the sums by a fixed tree.  That
rounds in another order than a walk over t one point at a time, which
``sequential_fit`` below is (the fit's plain version before the scan:
``scipy.signal.lfilter`` per row, sums from t = 0 up).  It is an oracle
of these tests only.

Held to: parameters within ``PARAM_ATOL`` = 1e-5 of the sequential fit
at 50 Adam steps (the port's tolerance against the JAX package at the
same step count, ``tests/test_torch_forecast.py``), on every order of
``ORDERS`` and on rows of 1, 255 and 2,815 points.  The rows are what
the forecast engine fits, differenced histories scaled by their standard
deviation (``tests/test_torch_forecast.py``'s): well-conditioned fits.
On a row centred to mean 0 the constant's gradient is rounding noise
from the first step, which Adam's normalised step turns into +-lr in
either order, so any two summation orders part there; the JAX
comparison pins the math on the same kind of rows for that reason.

Within the blocked order the fit is exact: a row's bits do not depend on
its batch, since the chunk layout is a function of the row's length.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import arma_fit, ref

torch.set_num_threads(1)

#: select_order's orders and q = 0, then the kernel's edge orders
ORDERS = [(1, 1), (2, 1), (2, 2), (3, 1), (2, 0), (0, 1), (0, 0), (3, 5),
          (0, 8)]
LENGTHS = [1, 255, 2815]
MATH_STEPS = 50
PARAM_ATOL = 1e-5


def sequential_fit(y, init, p, q, steps, lr):
    """The CSS/Adam fit walking t one point at a time: e and each
    sensitivity filtered by ``lfilter`` (denominator [1, theta]), the
    sums over t from t = 0 up; Adam as the kernel.  Row by row."""
    from scipy.signal import lfilter

    f32 = np.float32
    ys = np.asarray(y, f32)
    prms = np.array(init, f32).reshape(len(ys), p + 1 + q)
    n_rows, length = ys.shape
    one = np.ones(1, f32)
    lr, two_over_l = f32(lr), f32(2.0) / f32(length)

    def lagged(x, lag):
        out = np.zeros_like(x)
        if lag < len(x):
            out[lag:] = x[:len(x) - lag]
        return out

    for r in range(n_rows):
        yr, prm = ys[r], prms[r]
        m, v = np.zeros_like(prm), np.zeros_like(prm)
        u = np.empty((p + 1 + q, length), f32)
        u[0] = -1.0
        for i in range(p):
            u[1 + i] = -lagged(yr, 1 + i)
        for it in range(steps):
            theta = prm[1 + p:]
            e = ref.arma_residuals(yr, prm[0], prm[1:1 + p], theta)
            for j in range(q):
                u[1 + p + j] = -lagged(e, 1 + j)
            sens = lfilter(one, np.concatenate([one, theta]), u, axis=-1)
            g = np.cumsum(sens * e, axis=-1)[:, -1] * two_over_l
            m = f32(0.9) * m + f32(0.1) * g
            v = f32(0.999) * v + f32(0.001) * g * g
            mh = m / (f32(1) - f32(np.float64(f32(0.9)) ** (it + 1)))
            vh = v / (f32(1) - f32(np.float64(f32(0.999)) ** (it + 1)))
            prm = prm - lr * mh / (np.sqrt(vh) + f32(1e-8))
        prms[r] = prm
    return prms


def _rows(length, n_rows=4, seed=11):
    """Differenced diurnal + trend + random-walk histories, scaled by
    their standard deviation, as the forecast engine fits them."""
    out = []
    for i in range(n_rows):
        rng = np.random.default_rng(seed + 97 * i)
        t = np.arange(length + 1, dtype=float)
        h = (800 + 300 * np.sin(2 * np.pi * t / 1440 + 0.7 * i) + 0.05 * t
             + np.cumsum(rng.normal(0, 5, length + 1)))
        z = np.diff(h.astype(np.float32))
        out.append(z / float(np.std(z) + 1e-6))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("p,q", ORDERS)
def test_blocked_fit_matches_sequential(p, q, length):
    """Cold and warm inits; the largest difference is printed."""
    y = _rows(length)
    rng = np.random.default_rng(p * 9 + q)
    worst = 0.0
    for init in (np.zeros((len(y), p + 1 + q), np.float32),
                 rng.normal(0, 0.1, (len(y), p + 1 + q)).astype(np.float32)):
        got, _ = ref.arma_fit_ref(y, init, p, q, MATH_STEPS, 0.05)
        want = sequential_fit(y, init, p, q, MATH_STEPS, 0.05)
        assert got.dtype == torch.float32 and got.shape == want.shape
        worst = max(worst, float(np.abs(got.numpy() - want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=PARAM_ATOL)
    print(f"({p},{q}) L={length}: max |param diff| vs sequential "
          f"{worst:.2e}")


@pytest.mark.parametrize("length", [255, 257, 2815])
def test_blocked_fit_rows_are_batch_pure(length):
    """A row's parameters and loss are the same bits alone, in a batch and
    in a permuted batch."""
    p, q = 2, 2
    y = _rows(length, n_rows=5)
    init = np.random.default_rng(1).normal(0, 0.1, (5, p + 1 + q))
    init = init.astype(np.float32)
    prm, loss = ref.arma_fit_ref(y, init, p, q, 40, 0.05)
    perm = [3, 0, 4, 1, 2]
    pprm, ploss = ref.arma_fit_ref(y[perm], init[perm], p, q, 40, 0.05)
    assert torch.equal(pprm, prm[perm]) and torch.equal(ploss, loss[perm])
    for i in range(5):
        alone, aloss = ref.arma_fit_ref(y[i:i + 1], init[i:i + 1], p, q, 40,
                                        0.05)
        assert torch.equal(alone[0], prm[i]) and torch.equal(aloss[0],
                                                             loss[i])


@pytest.mark.parametrize("length", [1, 2, 255, 256, 257, 511, 512, 513,
                                    2815, 2816, 2817, arma_fit.MAX_LEN])
def test_chunk_layout_depends_on_the_length_alone(length):
    """``arma_chunks`` takes the length and nothing else; its chunks tile
    the row in order, all T long but the last, within the 256 threads."""
    span, chunks = ref.arma_chunks(length)
    assert span == -(-length // ref.ARMA_THREADS)
    assert 1 <= chunks <= ref.ARMA_THREADS
    assert (chunks - 1) * span < length <= chunks * span
    # the same row fitted in batches of 1 and 3 (other rows differ):
    # the layout, hence the bits, do not follow the batch
    if length <= 2817:
        y = _rows(length, n_rows=3)
        init = np.zeros((3, 4), np.float32)
        batch, _ = ref.arma_fit_ref(y, init, 2, 1, 5, 0.05)
        alone, _ = ref.arma_fit_ref(y[1:2], init[1:2], 2, 1, 5, 0.05)
        assert torch.equal(alone[0], batch[1])


@pytest.mark.parametrize("p,q", [(2, 1), (3, 5), (0, 0)])
def test_fit_takes_rows_up_to_the_kernels_limit(p, q):
    """The row sits in shared memory: every order takes rows of up to
    ``MAX_LEN`` points, and both paths refuse a longer one."""
    from repro_torch.kernels import ops

    n = arma_fit.MAX_LEN
    init = torch.zeros((1, p + 1 + q))
    with pytest.raises(ValueError, match="row length"):
        ops.arma_fit(torch.zeros((1, n + 1)), init, p, q, 1, 0.05)
    prm, loss = ops.arma_fit(torch.zeros((1, n)), init, p, q, 1, 0.05)
    assert prm.shape == (1, p + 1 + q) and torch.isfinite(loss).all()
