"""Parameter sweeps of the port (counterpart of ``peapods_tpu/sweep.py``).

For now it holds the overlap statistic that the physics scripts read
(``tests/overlap_histogram.py``); ``run_sweep`` comes with the port's
Python layer.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_cumulative_overlap_ratio"]


def _cumulative_overlap_ratio(per_sample_hist):
    """I(q)/X(q) from per-sample overlap histograms (Billoire et al. 2014;
    peapods_tpu/sweep.py:55).

    ``per_sample_hist``: ``[n_disorder, n_temps, n_bins]``.  X_s(q) is each
    sample's cumulative weight in ``[-q, q]``; the statistic compares the
    disorder median I(q) to the disorder mean X(q).

    Returns ``(q_grid, ratio [n_temps, n_q], x_mean, x_median)``.
    """
    n_disorder, n_temps, n_bins = per_sample_hist.shape
    center = n_bins // 2
    q_grid = np.linspace(-1, 1, n_bins)[center:]

    x = np.zeros((n_disorder, n_temps, len(q_grid)))
    for qi in range(len(q_grid)):
        x[:, :, qi] = per_sample_hist[:, :, center - qi : center + qi + 1].sum(2)
    totals = per_sample_hist.sum(2, keepdims=True)
    x = x / np.where(totals == 0, 1, totals)

    x_mean = x.mean(0)
    x_median = np.median(x, 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        # np.where evaluates both branches; mask the divide itself.
        ratio = np.where(x_mean > 0, x_median / x_mean, 0.0)
    return q_grid, ratio, x_mean, x_median
