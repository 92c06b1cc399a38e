"""The port's ARIMA fit and forecast engine against repro's, on the CPU.

On the CPU the port fits with the plain version of the ``arma_fit``
kernel (float32 numpy/scipy); ``repro`` with the JAX program
``_fit_arma_batch`` (reverse-mode gradient through ``lax.scan``).  Both
run the same math in float32 but round in another order, and the
CSS/Adam trajectory amplifies a rounding difference: an MA term through
a ~1,400-step recurrence near a ridge of the loss, or a gradient
component that is only rounding noise (the constant c of a normalized
series), sends the two to different points of an oscillating search.
So, as ``tests/test_control.py`` does for repro's own batched and serial
paths:

- the math is pinned at 50 Adam steps, on histories whose fits are
  well-conditioned (a diurnal sine, a trend and a random walk, which
  first and seasonal differences leave without a unit root): params
  within atol 1e-5 and the final loss within rtol 1e-5 (measured on
  the CPU: at most 7.2e-7 and 1.9e-6 over every case below, which the
  test prints); forecasts within rtol 1e-4 of their scale;
- at production step counts the port is held to forecast quality (it
  beats persistence on a diurnal series), and end to end by the
  ``lt-ua+plan`` Report and its ILP target flips
  (``tests/test_torch_control.py``).

Within the port the fit is exact: a row's bits do not depend on its
batch, so the dedupe and the fit cache are exact too.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.control import forecast as ref_forecast
from repro_torch.control import forecast
from repro_torch.control.forecast import (ARIMAForecaster,
                                          BatchForecastEngine, select_order)
from repro_torch.kernels import arma_fit, ops

torch.set_num_threads(1)

ORDERS = [(1, 1), (2, 1), (2, 2), (3, 1), (2, 0)]   # select_order's + q = 0
#: (kind, history length, seasonal period): the planner's two regimes at
#: 60-s buckets (2,816 buckets unseasoned -> 2,815 points; 2,880 with
#: the 1,440 period -> 1,439 points) and a short history
KINDS = [("unseasoned", 2816, 0), ("seasonal", 2880, 1440),
         ("short", 256, 0)]
MATH_STEPS = 50
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
FORECAST_RTOL = 1e-4


def _history(n, i, seed=11):
    """Diurnal sine + trend + random walk, seeded per row."""
    rng = np.random.default_rng(seed + 97 * i)
    t = np.arange(n, dtype=float)
    return (800 + 300 * np.sin(2 * np.pi * t / 1440 + 0.7 * i) + 0.05 * t
            + np.cumsum(rng.normal(0, 5, n))).astype(np.float32)


def _rows(n, s, offset=0, n_rows=4):
    """Differenced, normalized rows as BatchForecastEngine fits them."""
    out = []
    for i in range(n_rows):
        y = _history(n + 60, i)[offset:offset + n]
        z = forecast._difference(y, 1, s)
        out.append(z / float(np.std(z) + 1e-6))
    return np.stack(out).astype(np.float32)


def _stack(prm, n_rows):
    return {k: np.stack([np.asarray(v, np.float32)] * n_rows)
            for k, v in prm.items()}


def _both(y, init, p, q, steps):
    got, got_loss = forecast._fit_arma_batch(torch.from_numpy(y), init, p,
                                             q, steps=steps)
    want, want_loss = ref_forecast._fit_arma_batch(
        jnp.asarray(y), {k: jnp.asarray(v) for k, v in init.items()}, p, q,
        steps=steps)
    return ({k: v.numpy() for k, v in got.items()}, got_loss.numpy(),
            {k: np.asarray(v) for k, v in want.items()},
            np.asarray(want_loss))


@pytest.mark.parametrize("kind,n,s", KINDS)
@pytest.mark.parametrize("p,q", ORDERS)
def test_fit_batch_matches_reference(p, q, kind, n, s):
    """Cold (zero) init, then a warm init from the reference's fit, on
    the next hour's window."""
    y = _rows(n, s)
    cold = _stack(forecast.zero_params(p, q), len(y))
    got, got_loss, want, want_loss = _both(y, cold, p, q, MATH_STEPS)
    warm = {k: v.copy() for k, v in want.items()}
    got2, got_loss2, want2, want_loss2 = _both(_rows(n, s, offset=60), warm,
                                               p, q, MATH_STEPS)
    for g, w, gl, wl in ((got, want, got_loss, want_loss),
                         (got2, want2, got_loss2, want_loss2)):
        print(f"({p},{q}) {kind}: max |param diff| "
              f"{max(np.abs(g[k] - w[k]).max(initial=0) for k in g):.2e}, "
              f"loss rel diff {np.abs(gl / wl - 1).max():.2e}")
        assert set(g) == set(w) == {"c", "phi", "theta"}
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == np.float32
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL)


def _histories(keys_lengths):
    return {key: _history(n, i) for i, (key, n) in enumerate(keys_lengths)}


def test_fit_forecast_matches_reference():
    """``BatchForecastEngine.fit_forecast`` over 12 (model, region)
    series of three lengths, seasonal period 1,440: forecasts, twice (the
    second call warm-starts from the first)."""
    lengths = [2880, 2880, 2880, 2880, 2900, 2816, 2816, 2000, 1500, 300,
               300, 5]
    hist = _histories([((f"m{i % 4}", f"r{i // 4}"), n)
                       for i, n in enumerate(lengths)])
    forecast.clear_fit_cache()
    ref_forecast.clear_fit_cache()
    kw = dict(p=2, d=1, q=1, seasonal_period=1440, fit_steps=MATH_STEPS)
    eng = BatchForecastEngine(**kw, device="cpu")
    ref = ref_forecast.BatchForecastEngine(**kw)
    for call in range(2):
        got, want = eng.fit_forecast(hist, 60), ref.fit_forecast(hist, 60)
        assert set(got) == set(want)
        assert (("m3", "r2") in got) == (call == 1)   # 5 points, then 65
        for key, fc in want.items():
            scale = max(float(np.abs(fc).max()), 1.0)
            np.testing.assert_allclose(got[key] / scale, fc / scale,
                                       rtol=0, atol=FORECAST_RTOL,
                                       err_msg=f"call {call}, {key}")
        for name in ("fits", "batches", "unique_fits", "dedup_hits",
                     "cache_hits"):
            assert getattr(eng, name) == getattr(ref, name), name
        hist = {k: np.concatenate([v, v[-60:]]) for k, v in hist.items()}


def test_fit_rows_are_batch_pure():
    """A row's parameters are the same bits alone, in a batch and in a
    permuted batch (the contract the dedupe and the fit cache rest on)."""
    p, q = 2, 1
    y = _rows(300, 0, n_rows=5)
    init = np.random.default_rng(0).normal(0, 0.1, (5, p + 1 + q))
    init = torch.from_numpy(init.astype(np.float32))
    batch, loss = ops.arma_fit(torch.from_numpy(y), init, p, q, 40, 0.05)
    perm = [3, 0, 4, 1, 2]
    pbatch, ploss = ops.arma_fit(torch.from_numpy(y[perm]), init[perm], p,
                                 q, 40, 0.05)
    assert torch.equal(pbatch, batch[perm]) and torch.equal(ploss,
                                                            loss[perm])
    for i in range(5):
        alone, aloss = ops.arma_fit(torch.from_numpy(y[i:i + 1]),
                                    init[i:i + 1], p, q, 40, 0.05)
        assert torch.equal(alone[0], batch[i]) and torch.equal(aloss[0],
                                                               loss[i])


def test_dedupe_and_fit_cache_are_exact():
    base = _histories([(("a", "x"), 600), (("b", "x"), 600),
                       (("c", "x"), 900)])
    hist = dict(base)
    hist[("d", "x")] = base[("a", "x")].copy()      # same series twice
    forecast.clear_fit_cache()
    stats0 = forecast.fit_cache_stats()
    eng = BatchForecastEngine(2, 1, 1, fit_steps=30, device="cpu")
    out = eng.fit_forecast(hist, 20)
    assert eng.dedup_hits == 1 and eng.unique_fits == 3
    assert np.array_equal(out[("a", "x")], out[("d", "x")])
    # a fresh engine replays the same boundary from the cache
    eng2 = BatchForecastEngine(2, 1, 1, fit_steps=30, device="cpu")
    out2 = eng2.fit_forecast(hist, 20)
    assert eng2.cache_hits == 3 and eng2.unique_fits == 0
    assert eng2.batches == 0
    for key in hist:
        assert np.array_equal(out[key], out2[key]), key
    stats = forecast.fit_cache_stats()
    assert stats["hits"] - stats0["hits"] == 3
    # the device type is part of a fit's signature
    sig = eng._row_sig(hist[("a", "x")], forecast.zero_params(2, 1), 0)
    eng2.device = torch.device("cuda")
    assert eng2._row_sig(hist[("a", "x")], forecast.zero_params(2, 1),
                         0) != sig
    forecast.clear_fit_cache()


def test_arima_forecaster_and_select_order_match_reference():
    """The serial forecaster and AIC order selection on the reference's
    own diurnal series (``tests/test_forecast.py``), at 50 steps."""
    rng = np.random.default_rng(0)
    t = np.arange(24 * 6, dtype=float)
    y = (1000 + 500 * np.sin(2 * np.pi * (t % 24) / 24 - 1.3) + 0.3 * t
         + rng.normal(0, 30.0, t.shape))
    for p, d, q in ((1, 1, 1), (2, 1, 0)):
        got = ARIMAForecaster(p=p, d=d, q=q, seasonal_period=24,
                              fit_steps=MATH_STEPS, device="cpu").fit(y)
        want = ref_forecast.ARIMAForecaster(
            p=p, d=d, q=q, seasonal_period=24, fit_steps=MATH_STEPS).fit(y)
        for k in ("c", "phi", "theta"):
            np.testing.assert_allclose(got.params[k], want.params[k],
                                       rtol=0, atol=PARAM_ATOL)
        np.testing.assert_allclose(got.aic(), want.aic(), rtol=1e-5)
        fc = want.forecast(12)
        np.testing.assert_allclose(got.forecast(12), fc,
                                   rtol=FORECAST_RTOL)
    best = select_order(y, seasonal_period=24, fit_steps=MATH_STEPS,
                        device="cpu")
    ref_best = ref_forecast.select_order(y, seasonal_period=24,
                                         fit_steps=MATH_STEPS)
    assert (best.p, best.d, best.q) == (ref_best.p, ref_best.d, ref_best.q)


def test_production_steps_quality_on_diurnal_series():
    """At production step counts the fit is held to forecast quality
    (repro's ``test_batched_quality_parity_at_production_steps``): both
    the batched and the serial port paths beat persistence."""
    period = 288
    t = np.arange(4 * period, dtype=float)
    rng = np.random.default_rng(0)
    clean = {(f"m{i}", "e"): 800 + 300 * np.roll(
        np.sin(2 * np.pi * t / period), 37 * i) for i in range(3)}
    hist = {k: v[:3 * period] + rng.normal(0, 10.0, 3 * period)
            for k, v in clean.items()}
    eng = BatchForecastEngine(2, 1, 1, seasonal_period=period,
                              fit_steps=150, warm_start=False, device="cpu")
    for out in (eng.fit_forecast(hist, period // 4),
                eng.fit_forecast_serial(hist, period // 4)):
        for k, fc in out.items():
            want = clean[k][3 * period:3 * period + period // 4]
            mape = np.mean(np.abs(fc - want) / np.abs(want))
            naive = np.mean(np.abs(hist[k][-1] - want) / np.abs(want))
            assert mape < 0.2 and mape < naive, k


@pytest.mark.parametrize("bad", [dict(p=5, q=4), dict(p=-1, q=1),
                                 dict(steps=0)])
def test_fit_rejects_what_the_kernel_does_not_take(bad):
    args = dict(p=2, q=1, steps=10)
    args.update(bad)
    k = max(args["p"] + 1 + args["q"], 1)
    with pytest.raises(ValueError):
        ops.arma_fit(torch.zeros(2, 16), torch.zeros(2, k), args["p"],
                     args["q"], args["steps"], 0.05)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; only ``ops`` takes the plain
    version, and only for CPU tensors."""
    y, init = torch.zeros(2, 16), torch.zeros(2, 4)
    before = arma_fit.LAUNCHES
    with pytest.raises(ValueError, match="not a CUDA device"):
        arma_fit.arma_fit(y, init, 2, 1, 10, 0.05)
    prm, loss = ops.arma_fit(y, init, 2, 1, 10, 0.05)
    assert prm.shape == (2, 4) and loss.shape == (2,)
    assert arma_fit.LAUNCHES == before
