"""Streaming autocorrelation of scalar observable series + Sokal tau.

The port's own copy of ``peapods_tpu/utils/autocorr.py`` (numpy only), the
host-side counterpart of the reference accumulator
(``spin-sim/src/statistics/autocorrelation.rs``).  The engine folds the
per-sweep observable series (m^2(t), q^2(t) per temperature) on the device
(``engine/loop.py`` ``_fold_series``) and injects the ring's sums into an
:class:`AutocorrStream`, or pushes the recorded series into one chunk by
chunk (the ``fft`` backend); the taus come out of this module.

Two backends with identical results (the reference enforces agreement to
1e-10, autocorrelation.rs:345-373):

* ``ring`` — exact bounded-memory lagged-product accumulation: only the last
  ``max_lag`` values are retained (autocorrelation.rs:77-101), vectorized over
  a feature axis (disorder x temperature).
* ``fft`` — retains the full series and evaluates all lagged products with a
  zero-padded FFT (autocorrelation.rs:126-163).

Values are cast to f32 before accumulating in f64, matching the reference's
``f32`` ring storage (autocorrelation.rs:74).
"""

from __future__ import annotations

import numpy as np

__all__ = ["AutocorrStream", "sokal_tau", "clamp_max_lag"]


def clamp_max_lag(max_lag: int, n_measurement_sweeps: int) -> int:
    """``min(max_lag, n_meas/4)`` clamped to >= 1 (reference mod.rs:343-345)."""
    return max(1, min(max_lag, n_measurement_sweeps // 4))


class AutocorrStream:
    """Streaming Gamma(delta) accumulator over a flattened feature axis."""

    def __init__(self, max_lag: int, n_features: int, backend: str = "ring"):
        self.max_lag = int(max_lag)
        self.n_features = int(n_features)
        self.backend = backend
        self.sum_o = np.zeros(n_features, np.float64)
        self.sum_o2 = np.zeros(n_features, np.float64)
        self.n_recorded = 0
        self._hist = np.zeros((0, n_features), np.float32)
        self._sum_prod = np.zeros((max_lag + 1, n_features), np.float64)
        self._series = [] if backend == "fft" else None

    def push_block(self, block: np.ndarray) -> None:
        """Append ``[n_new, n_features]`` values."""
        o = np.ascontiguousarray(block, dtype=np.float32)
        if o.size == 0:
            return
        o64 = o.astype(np.float64)
        self.sum_o += o64.sum(0)
        self.sum_o2 += (o64 * o64).sum(0)

        if self.backend == "fft":
            self._series.append(o)
        else:
            ext = np.concatenate([self._hist, o], axis=0)
            offset = self._hist.shape[0]
            n_new = o.shape[0]
            for delta in range(self.max_lag + 1):
                j0 = max(0, delta - offset)  # skip pairs with t < delta
                if j0 >= n_new:
                    continue
                a = o[j0:].astype(np.float64)
                b = ext[offset + j0 - delta : offset + n_new - delta].astype(
                    np.float64
                )
                self._sum_prod[delta] += (a * b).sum(0)
            keep = min(self.max_lag, ext.shape[0])
            self._hist = ext[ext.shape[0] - keep :]
        self.n_recorded += o.shape[0]

    def _normalize(self, sum_prod: np.ndarray) -> np.ndarray:
        """Gamma from lagged-product sums (autocorrelation.rs:165-186)."""
        m = self.n_recorded
        gamma = np.zeros((self.max_lag + 1, self.n_features), np.float64)
        gamma[0] = 1.0
        if m == 0:
            return gamma
        mean = self.sum_o / m
        var = self.sum_o2 / m - mean * mean
        good = var > 0.0
        for delta in range(self.max_lag + 1):
            count = m - delta
            if count <= 0:
                gamma[delta] = 1.0 if delta == 0 else 0.0
                continue
            row = (sum_prod[delta] / count - mean * mean)
            gamma[delta] = np.where(good, np.divide(row, np.where(good, var, 1.0)), 0.0)
        gamma[0] = np.where(good, gamma[0], 1.0)
        return gamma

    def gamma(self) -> np.ndarray:
        """``f64 [max_lag + 1, n_features]`` normalized autocorrelation."""
        if self.backend != "fft":
            return self._normalize(self._sum_prod)
        if self.n_recorded == 0:
            return self._normalize(np.zeros_like(self._sum_prod))
        series = np.concatenate(self._series, axis=0).astype(np.float64)
        n = series.shape[0]
        fft_len = 1
        while fft_len < 2 * n:
            fft_len *= 2
        spec = np.fft.rfft(series, n=fft_len, axis=0)
        corr = np.fft.irfft(np.abs(spec) ** 2, n=fft_len, axis=0)
        sum_prod = corr[: self.max_lag + 1]
        return self._normalize(sum_prod)

    def taus(self) -> np.ndarray:
        """Integrated autocorrelation times, ``f64 [n_features]``."""
        gamma = self.gamma()
        return np.array(
            [sokal_tau(gamma[:, f]) for f in range(self.n_features)], np.float64
        )


def sokal_tau(gamma) -> float:
    """Windowed integrated autocorrelation time (autocorrelation.rs:199-208)."""
    tau = 0.5
    for w in range(1, len(gamma)):
        tau += float(gamma[w])
        if w >= 5.0 * tau:
            return tau
    return tau
