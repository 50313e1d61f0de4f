"""Observable plots for parameter sweeps (Binder, C_v, CSD, P(q), I/X, tau).

The port's own copy of ``peapods_tpu/plot/observables.py`` (numpy and
matplotlib, imported lazily): the same figures under the same file names,
from the port's `Ising` models returned by
:func:`peapods_tpu_torch.sweep.run_sweep`, around two shared helpers: a
per-size line plot and a temperature-colormapped per-model plot.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "plot_binder",
    "plot_heat_capacity",
    "plot_csd",
    "plot_overlap_histogram",
    "plot_cumulative_overlap_ratio",
    "plot_autocorrelation_time",
]


def _save(fig, path):
    import matplotlib.pyplot as plt

    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"  Plot saved to {path}")


def _per_size_lines(models, temps, value_fn, *, ylabel, title, path, logx=False):
    """One line per lattice size, temperature on x."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for size_label, model in models.items():
        ax.plot(temps, value_fn(model), label=size_label)
    ax.set_xlabel("Temperature")
    ax.set_ylabel(ylabel)
    if logx:
        ax.set_xscale("log")
    ax.legend()
    ax.set_title(title)
    _save(fig, path)


def _temp_colored(temps, series_fn, *, ax_setup, title, path):
    """One curve per temperature, colored by a viridis temperature scale.

    ``series_fn(t_idx)`` returns ``(x, y, style)`` or None to skip;
    ``style`` is "line" or "scatter".
    """
    import matplotlib.pyplot as plt
    from matplotlib.cm import ScalarMappable
    from matplotlib.colors import Normalize

    norm = Normalize(vmin=temps.min(), vmax=temps.max())
    cmap = plt.get_cmap("viridis")
    fig, ax = plt.subplots(figsize=(6, 4))
    for t_idx in range(len(temps)):
        out = series_fn(t_idx)
        if out is None:
            continue
        x, y, style = out
        color = cmap(norm(temps[t_idx]))
        if style == "scatter":
            ax.scatter(x, y, s=8, color=color, alpha=0.7)
        else:
            ax.plot(x, y, color=color, alpha=0.7)
    fig.colorbar(ScalarMappable(norm=norm, cmap=cmap), ax=ax, label="Temperature")
    ax_setup(ax)
    ax.set_title(title)
    _save(fig, path)


def plot_binder(models, config_label, temps, output_dir):
    has_overlap = any(hasattr(m, "sg_binder") for m in models.values())
    _per_size_lines(
        models,
        temps,
        lambda m: m.sg_binder if has_overlap else m.binder_cumulant,
        ylabel="SG Binder" if has_overlap else "Binder cumulant",
        title=config_label,
        path=Path(output_dir) / f"binder_{config_label}.png",
        logx=True,
    )


def plot_heat_capacity(models, config_label, temps, output_dir):
    _per_size_lines(
        models,
        temps,
        lambda m: m.heat_capacity,
        ylabel="$C_v$",
        title=f"Heat capacity — {config_label}",
        path=Path(output_dir) / f"heat_capacity_{config_label}.png",
    )


def plot_csd(model, size_label, config_label, temps, output_dir):
    def series(t_idx):
        hist = model.fk_csd[t_idx]
        total = hist.sum()
        if total == 0:
            return None
        sizes = np.arange(len(hist))
        mask = hist > 0
        return sizes[mask], hist[mask] / total, "scatter"

    def setup(ax):
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("Cluster size $s$")
        ax.set_ylabel("$P(s)$")

    _temp_colored(
        temps, series, ax_setup=setup,
        title=f"CSD — {size_label}, {config_label}",
        path=Path(output_dir) / f"csd_{size_label}_{config_label}.png",
    )


def plot_overlap_histogram(model, size_label, config_label, temps, output_dir):
    n_bins = len(model.overlap_histogram[0])
    q_values = np.linspace(-1, 1, n_bins)
    bin_width = 2.0 / (n_bins - 1)

    def series(t_idx):
        hist = model.overlap_histogram[t_idx]
        total = hist.sum()
        if total == 0:
            return None
        return q_values, hist / total / bin_width, "line"

    def setup(ax):
        ax.set_xlabel("$q$")
        ax.set_ylabel("$P(q)$")

    _temp_colored(
        temps, series, ax_setup=setup,
        title=f"Overlap distribution — {size_label}, {config_label}",
        path=Path(output_dir) / f"pq_{size_label}_{config_label}.png",
    )


def plot_cumulative_overlap_ratio(model, size_label, config_label, temps, output_dir):
    from ..sweep import _cumulative_overlap_ratio

    q_grid, ratio, _, _ = _cumulative_overlap_ratio(model.per_sample_overlap_histogram)

    def series(t_idx):
        return q_grid, ratio[t_idx], "line"

    def setup(ax):
        ax.axhline(1.0, ls="--", color="gray", lw=0.8)
        ax.set_xlabel("$q$")
        ax.set_ylabel("$I(q) / X(q)$")

    _temp_colored(
        temps, series, ax_setup=setup,
        title=f"Cumulative overlap ratio — {size_label}, {config_label}",
        path=Path(output_dir) / f"iq_xq_{size_label}_{config_label}.png",
    )


def plot_autocorrelation_time(all_results, temps, plot_temp, output_dir):
    """tau_int vs L per config label, for m^2 and q^2."""
    import matplotlib.pyplot as plt

    if plot_temp is not None:
        t_idx = int(np.argmin(np.abs(temps - plot_temp)))
        subtitle = f"at $T={temps[t_idx]:.4f}$"
    else:
        t_idx = None
        subtitle = "(peak $T$)"

    for obs_name, attr in [("m2", "mags2_tau"), ("q2", "overlap2_tau")]:
        points = {}  # config_label -> list of (L, tau)
        for config_label, models in all_results.items():
            for model in models.values():
                tau_arr = getattr(model, attr, None)
                if tau_arr is None:
                    continue
                tau = tau_arr[t_idx] if t_idx is not None else tau_arr.max()
                points.setdefault(config_label, []).append(
                    (max(model.lattice_shape), tau)
                )
        if not points:
            continue

        fig, ax = plt.subplots(figsize=(6, 4))
        for config_label, pts in points.items():
            pts.sort()
            ax.plot([p[0] for p in pts], [p[1] for p in pts], "o-",
                    label=config_label)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("$L$")
        ax.set_ylabel(rf"$\tau_{{\mathrm{{int}}}}({obs_name})$")
        ax.legend()
        ax.set_title(rf"$\tau({obs_name})$ vs $L$ {subtitle}")
        _save(fig, Path(output_dir) / f"tau_{obs_name}.png")
