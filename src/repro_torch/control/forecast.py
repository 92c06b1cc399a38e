"""ARIMA traffic forecasting, fit by a hand-written CUDA kernel (CSS, Adam).

Port of ``repro.control.forecast``.  The paper forecasts next-hour input
TPS per (model, region) with ARIMA and selects hyper-parameters by AIC
(§6.3, §7.1).  We implement ARIMA(p, d, q) with optional seasonal
differencing: the series is differenced ``d`` times (+ one seasonal
difference of period ``s`` when ``seasonal_period`` is set), then an
ARMA(p, q) is fit by conditional sum-of-squares, its parameters
optimized by Adam.  The reference runs the residual recursion under
``jax.lax.scan`` and takes ``jax.grad`` through it; here the whole fit
(every Adam step, with the gradient from forward sensitivities of the
linear recursion) is the kernel ``repro_torch.kernels.arma_fit`` on
CUDA, and its plain float32 version (``kernels.ref.arma_fit_ref``) on
the CPU.  Forecasting recurses the fitted ARMA forward and integrates
the differences back, on the host.

Two fitting paths share the same math:

- ``ARIMAForecaster`` — one series per object, the original serial path.
- ``BatchForecastEngine`` — the hourly controller's engine: all
  (model, region) series of one length are stacked into a ``(S, L)``
  array and fit by one kernel launch (one block per row), with
  warm-started parameters carried fit-to-fit.  Ragged histories fall
  back to smaller per-length batches, and series too short to fit are
  left to the caller's persistence fallback.

Both fit on the device they are given (CUDA unless the caller passes
``device="cpu"``).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import arma_residuals

Key = Tuple[str, str]

# Process-wide content-addressed fit cache: signature of (trimmed series,
# init params, fit config) -> fitted param pytree.  Fits are pure
# functions of that signature (see ``fit_forecast``'s batch-purity
# contract), so replaying a boundary whose histories were already fitted
# — e.g. the same trace swept under a different stress scenario — skips
# the Adam scan entirely and returns the identical parameters.
_FIT_CACHE_MAX = 4096
_FIT_CACHE: "collections.OrderedDict[bytes, dict]" = collections.OrderedDict()
_FIT_CACHE_LOCK = threading.Lock()
_FIT_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def clear_fit_cache() -> None:
    """Drop the process-wide fit cache (tests / memory pressure).
    Lifetime hit/miss/eviction counters are kept — consumers record
    deltas (see the vector engine's control_stats)."""
    with _FIT_CACHE_LOCK:
        _FIT_CACHE.clear()


def fit_cache_stats() -> Dict[str, int]:
    """Uniform cache telemetry (see docs/PERF.md): lifetime hit/miss/
    eviction counts plus current size of the process-wide fit cache."""
    with _FIT_CACHE_LOCK:
        return {**_FIT_CACHE_STATS, "entries": len(_FIT_CACHE)}


def _fit_cache_get(sig: bytes) -> Optional[dict]:
    with _FIT_CACHE_LOCK:
        prm = _FIT_CACHE.get(sig)
        if prm is not None:
            _FIT_CACHE.move_to_end(sig)
            _FIT_CACHE_STATS["hits"] += 1
        else:
            _FIT_CACHE_STATS["misses"] += 1
        return prm


def _fit_cache_put(sig: bytes, prm: dict) -> None:
    with _FIT_CACHE_LOCK:
        _FIT_CACHE[sig] = prm
        while len(_FIT_CACHE) > _FIT_CACHE_MAX:
            _FIT_CACHE.popitem(last=False)
            _FIT_CACHE_STATS["evictions"] += 1


#: parameter names, in the order the fit packs them and ``_row_sig``
#: hashes them (the reference's ``jax.tree.leaves`` order)
PARAM_NAMES = ("c", "phi", "theta")


def _css_residuals(params, y, p: int, q: int) -> np.ndarray:
    """Conditional-sum-of-squares residuals of ARMA(p, q), float32."""
    return arma_residuals(y, params["c"], params["phi"][:p],
                          params["theta"][:q])


def zero_params(p: int, q: int) -> dict:
    return {"c": np.zeros((), np.float32), "phi": np.zeros((p,), np.float32),
            "theta": np.zeros((q,), np.float32)}


def _pack(init: dict, n_rows: int, p: int, q: int) -> np.ndarray:
    """Param dict of stacked rows -> (S, p+1+q) float32 (c, phi, theta)."""
    return np.concatenate(
        [np.asarray(init["c"], np.float32).reshape(n_rows, 1),
         np.asarray(init["phi"], np.float32).reshape(n_rows, p),
         np.asarray(init["theta"], np.float32).reshape(n_rows, q)], axis=1)


def _fit_arma_batch(y, init, p: int, q: int, steps: int = 400,
                    lr: float = 0.05):
    """Batched fit: ``y`` is an (S, L) float32 tensor, ``init`` a param
    dict with a leading S axis.  One kernel launch for the whole stack
    when ``y`` is on CUDA, the plain version when it is on the CPU.
    Returns (params dict of (S,), (S, p), (S, q) tensors, final loss
    (S,)) on ``y``'s device."""
    n_rows = y.shape[0]
    packed = torch.from_numpy(_pack(init, n_rows, p, q))
    if y.is_cuda:
        # from pinned memory, asynchronously: a pageable copy would make
        # the host wait for the stream (the trace tier's T1)
        packed = packed.pin_memory().to(y.device, non_blocking=True)
    prm, loss = ops.arma_fit(y, packed, p, q, steps, lr)
    return {"c": prm[:, 0], "phi": prm[:, 1:1 + p],
            "theta": prm[:, 1 + p:]}, loss


def _fit_arma_core(y, init, p: int, q: int, steps: int, lr: float):
    """One CSS/Adam fit of a 1-D float32 tensor ``y`` from ``init``:
    (params, final loss), as a batch of one."""
    params, loss = _fit_arma_batch(
        y[None], {k: np.asarray(v)[None] for k, v in init.items()}, p, q,
        steps=steps, lr=lr)
    return {k: v[0] for k, v in params.items()}, loss[0]


def _fit_arma(y, p: int, q: int, steps: int = 400, lr: float = 0.05):
    return _fit_arma_core(y, zero_params(p, q), p, q, steps, lr)


def _difference(y: np.ndarray, d: int, seasonal_period: int) -> np.ndarray:
    z = y
    if seasonal_period and len(z) > seasonal_period:
        z = z[seasonal_period:] - z[:-seasonal_period]
    for _ in range(d):
        z = np.diff(z)
    return z


def _arma_forecast(params: dict, history: np.ndarray, p: int, d: int,
                   q: int, seasonal_period: int, scale: float,
                   horizon: int) -> np.ndarray:
    """Recurse the fitted ARMA forward and undo the differencing — the
    single forecasting path shared by the serial forecaster and the
    batched engine (bit-identical given identical params)."""
    y = np.asarray(history, np.float64)
    z = _difference(y, d, seasonal_period).astype(np.float64) / scale
    phi = np.asarray(params["phi"], np.float64)
    theta = np.asarray(params["theta"], np.float64)
    c = float(params["c"])
    resid = np.asarray(_css_residuals(params, z.astype(np.float32), p, q),
                       np.float64)
    zs = list(z)
    es = list(resid)
    out = []
    for h in range(horizon):
        ar = sum(phi[i] * zs[-1 - i] for i in range(p)) if p else 0.0
        ma = sum(theta[j] * es[-1 - j] for j in range(q)) if q else 0.0
        znew = c + ar + ma
        zs.append(znew)
        es.append(0.0)
        out.append(znew)
    fz = np.asarray(out) * scale
    # Undo differencing in reverse order of application:
    # _difference applies seasonal first, then d ordinary diffs.
    s = seasonal_period
    base = y[s:] - y[:-s] if (s and len(y) > s) else y
    levels = [base]
    for _ in range(d):
        levels.append(np.diff(levels[-1]))
    for k in range(d, 0, -1):
        fz = np.cumsum(fz) + levels[k - 1][-1]
    if s and len(y) > s:
        vals = []
        hist = list(y)
        for dz in fz:
            vals.append(dz + hist[-s])
            hist.append(vals[-1])
        fz = np.asarray(vals)
    return np.maximum(fz, 0.0)


@dataclasses.dataclass
class ARIMAForecaster:
    p: int = 2
    d: int = 1
    q: int = 1
    seasonal_period: int = 0     # one seasonal difference of this period
    fit_steps: int = 400
    device: DeviceLike = None    # where the fit runs: CUDA unless "cpu"

    params: Optional[dict] = None
    _history: Optional[np.ndarray] = None
    _scale: float = 1.0
    _sse: float = 0.0
    _n: int = 0

    # ------------------------------------------------------------------ fit
    def _difference(self, y: np.ndarray) -> np.ndarray:
        return _difference(y, self.d, self.seasonal_period)

    def fit(self, series: Sequence[float]) -> "ARIMAForecaster":
        y = np.asarray(series, dtype=np.float32)
        self._history = y
        z = self._difference(y)
        self._scale = float(np.std(z) + 1e-6)
        zn = torch.from_numpy(np.asarray(z / self._scale, np.float32))
        params, mse = _fit_arma(zn.to(resolve_device(self.device)), self.p,
                                self.q, steps=self.fit_steps)
        self.params = {k: v.cpu().numpy() for k, v in params.items()}
        self._sse = float(mse) * len(z)
        self._n = len(z)
        return self

    def aic(self) -> float:
        k = self.p + self.q + 1
        n = max(self._n, 1)
        return n * float(np.log(self._sse / n + 1e-12)) + 2 * k

    # ------------------------------------------------------------- forecast
    def forecast(self, horizon: int) -> np.ndarray:
        assert self.params is not None, "fit() first"
        return _arma_forecast(self.params, self._history, self.p, self.d,
                              self.q, self.seasonal_period, self._scale,
                              horizon)


def select_order(series, grid=((1, 1, 1), (2, 1, 1), (2, 1, 2), (3, 1, 1)),
                 seasonal_period: int = 0, fit_steps: int = 300,
                 device: DeviceLike = None):
    """AIC-based order selection (paper §7.1: 'ARIMA via AIC testing')."""
    best, best_aic = None, np.inf
    for (p, d, q) in grid:
        f = ARIMAForecaster(p=p, d=d, q=q, seasonal_period=seasonal_period,
                            fit_steps=fit_steps, device=device).fit(series)
        a = f.aic()
        if a < best_aic:
            best, best_aic = f, a
    return best


class BatchForecastEngine:
    """Stacked ARMA fitting for the hourly controller.

    ``fit_forecast`` groups the (model, region) series by length, fits
    each group with one kernel launch (one block per row), carries the
    fitted
    parameters as the next fit's initialization (warm start: hour-to-
    hour traffic changes little, so re-fits converge from the previous
    optimum instead of zero), and returns per-key forecast arrays.

    Series shorter than ``min_history()`` are skipped — the caller
    applies its persistence fallback.  Seasonal differencing is applied
    per group only when the history covers at least two full periods
    (``len >= 2 * seasonal_period``), so short histories degrade to the
    plain ARIMA rather than a truncated seasonal fit.
    """

    def __init__(self, p: int = 2, d: int = 1, q: int = 1,
                 seasonal_period: int = 0, fit_steps: int = 200,
                 warm_start: bool = True,
                 max_fit_len: Optional[int] = None,
                 length_quantum: int = 256,
                 device: DeviceLike = None):
        self.p, self.d, self.q = p, d, q
        self.device = resolve_device(device)
        self.seasonal_period = seasonal_period
        self.fit_steps = fit_steps
        self.warm_start = warm_start
        # Fits run on the most recent ``max_fit_len`` buckets (default:
        # two seasonal periods, or two days of minutes), with shorter
        # histories rounded down to a ``length_quantum`` multiple, as
        # the reference does (there to bound the jitted fit's retraces;
        # the kernel has none, but the trim decides what is fitted).
        self.max_fit_len = max_fit_len
        self.length_quantum = length_quantum
        self._warm: Dict[Key, dict] = {}     # key -> np param pytree
        self.fits = 0                        # series fitted (lifetime)
        self.batches = 0                     # kernel launches (lifetime)
        self.unique_fits = 0                 # rows actually run through Adam
        self.dedup_hits = 0                  # rows served by an identical row
        self.cache_hits = 0                  # rows served by the process cache

    def min_history(self) -> int:
        return max(8, self.p + self.q + 2)

    def _seasonal_for(self, n: int) -> int:
        s = self.seasonal_period
        return s if (s and n >= 2 * s) else 0

    def _fit_len(self, n: int) -> int:
        cap = self.max_fit_len or (2 * self.seasonal_period
                                   if self.seasonal_period else 2880)
        cap = max(cap, self.min_history())
        if n >= cap:
            return cap
        if n >= self.length_quantum:
            return (n // self.length_quantum) * self.length_quantum
        return n

    # reprolint: cache-key=__init__
    def _row_sig(self, y: np.ndarray, init: dict, s_eff: int) -> bytes:
        """Content signature of one fit: trimmed series + init params +
        everything else the fit (and the forecast recursion) reads,
        including the device type: the kernel and the plain version
        round alike, but a signature promises the same bits, so a
        CPU fit never serves a CUDA engine.  Two rows with equal
        signatures produce bit-identical fitted parameters and
        forecasts — see the batch-purity contract in ``fit_forecast``."""
        # reprolint: key-exempt=seasonal_period -- hashed as s_eff (the per-group effective period)
        # reprolint: key-exempt=warm_start -- selects init, whose leaves are hashed
        # reprolint: key-exempt=_warm -- init source; the chosen init's leaves are hashed
        # reprolint: key-exempt=max_fit_len -- determines the trim of y, which is hashed
        # reprolint: key-exempt=length_quantum -- determines the trim of y, which is hashed
        # reprolint: key-exempt=fits -- telemetry counter, not a fit input
        # reprolint: key-exempt=batches -- telemetry counter, not a fit input
        # reprolint: key-exempt=unique_fits -- telemetry counter, not a fit input
        # reprolint: key-exempt=dedup_hits -- telemetry counter, not a fit input
        # reprolint: key-exempt=cache_hits -- telemetry counter, not a fit input
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(y, np.float32).tobytes())
        for name in PARAM_NAMES:
            h.update(np.ascontiguousarray(init[name], np.float32).tobytes())
        h.update(repr((self.p, self.d, self.q, s_eff, self.fit_steps,
                       self.device.type)).encode())
        return h.digest()

    # ------------------------------------------------------------------ fit
    def fit_forecast(self, history: Dict[Key, np.ndarray], horizon: int
                     ) -> Dict[Key, np.ndarray]:
        """Fit every series long enough and forecast ``horizon`` steps.
        Returns {key: forecast array}; too-short keys are absent.

        Batch-purity contract: the fitted parameters of a row are a
        pure function of (trimmed series, init params, fit config) —
        independent of which other rows share the batch and of the row
        order.  The kernel fits each row in its own block and the plain
        version each row on its own, so a batch of one needs no padding
        (the reference pads it with a duplicate row, because XLA lowers
        a batch of one differently).  That purity is what makes the two
        amortizations below *exact*:

        - rows with identical signatures inside one call are fitted
          once and fanned out (``dedup_hits``) — this is how a fleet of
          replicas sweeping the same trace pays for one fit per
          boundary, not one per replica;
        - rows already fitted anywhere in this process are served from
          the content-addressed ``_FIT_CACHE`` (``cache_hits``), e.g.
          the same workload swept under a different stress scenario.
        """
        by_len: Dict[int, list] = {}
        series: Dict[Key, np.ndarray] = {}
        # sorted: batch composition (and thus emitted plans) must not
        # depend on the caller's dict insertion order
        for key, raw in sorted(history.items()):
            y = np.asarray(raw, np.float32)
            if len(y) < self.min_history():
                continue
            y = y[len(y) - self._fit_len(len(y)):]
            series[key] = y
            by_len.setdefault(len(y), []).append(key)

        out: Dict[Key, np.ndarray] = {}
        cold = zero_params(self.p, self.q)
        for n, keys in sorted(by_len.items()):
            s_eff = self._seasonal_for(n)
            inits = [self._warm.get(k, cold) if self.warm_start else cold
                     for k in keys]
            sigs = [self._row_sig(series[k], ini, s_eff)
                    for k, ini in zip(keys, inits)]
            # one fit per unique signature; cached signatures skip even
            # that (first occurrence wins, preserving sorted-key order)
            params_by_sig: Dict[bytes, dict] = {}
            fit_rows: list = []        # (sig, z_row, init) to actually fit
            fit_seen: set = set()
            for key, sig, ini in zip(keys, sigs, inits):
                if sig in fit_seen or sig in params_by_sig:
                    self.dedup_hits += 1
                    continue
                prm = _fit_cache_get(sig)
                if prm is not None:
                    params_by_sig[sig] = prm
                    self.cache_hits += 1
                    continue
                z = _difference(series[key], self.d, s_eff)
                sc = float(np.std(z) + 1e-6)
                fit_rows.append((sig, z / sc, ini))
                fit_seen.add(sig)
            if fit_rows:
                ybatch = torch.from_numpy(np.stack(
                    [z for _, z, _ in fit_rows]).astype(np.float32))
                init = {name: np.stack([ini[name] for _, _, ini in fit_rows])
                        for name in PARAM_NAMES}
                params, _ = _fit_arma_batch(ybatch.to(self.device), init,
                                            self.p, self.q,
                                            steps=self.fit_steps)
                # reprolint: disable=R8 -- one copy a fit batch (one batch per row length): the host's forecast recursion reads the fitted parameters
                params = {k: v.cpu().numpy() for k, v in params.items()}
                self.batches += 1
                for i, (sig, _, _) in enumerate(fit_rows):
                    prm = {k: v[i] for k, v in params.items()}
                    params_by_sig[sig] = prm
                    _fit_cache_put(sig, prm)
                    self.unique_fits += 1
            # fan out: forecasts computed once per signature, shared by
            # every key whose (series, init) matched
            fc_by_sig: Dict[bytes, np.ndarray] = {}
            for key, sig in zip(keys, sigs):
                prm = params_by_sig[sig]
                if self.warm_start:
                    self._warm[key] = prm
                self.fits += 1
                fc = fc_by_sig.get(sig)
                if fc is None:
                    sc = float(np.std(_difference(series[key], self.d,
                                                  s_eff)) + 1e-6)
                    fc = _arma_forecast(prm, series[key], self.p,
                                        self.d, self.q, s_eff,
                                        sc, horizon)
                    fc_by_sig[sig] = fc
                out[key] = fc
        return out

    def fit_forecast_serial(self, history: Dict[Key, np.ndarray],
                            horizon: int) -> Dict[Key, np.ndarray]:
        """Reference path: one cold ``ARIMAForecaster`` per series.
        Used by the equivalence tests and the perf probe's baseline."""
        out: Dict[Key, np.ndarray] = {}
        for key, raw in sorted(history.items()):
            y = np.asarray(raw, np.float32)
            if len(y) < self.min_history():
                continue
            y = y[len(y) - self._fit_len(len(y)):]
            f = ARIMAForecaster(p=self.p, d=self.d, q=self.q,
                                seasonal_period=self._seasonal_for(len(y)),
                                fit_steps=self.fit_steps,
                                device=self.device).fit(y)
            out[key] = f.forecast(horizon)
        return out


from repro_torch.api.registry import register


@register("forecaster", "arima")
def _make_arima(ctx, **kwargs) -> ARIMAForecaster:
    if ctx is not None:
        kwargs.setdefault("device", getattr(ctx, "device", None))
    return ARIMAForecaster(**kwargs)
