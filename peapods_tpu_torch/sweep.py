"""Parameter sweeps over lattice sizes and sampler configurations.

The port's own copy of ``peapods_tpu/sweep.py``: the same Cartesian product
over couplings x overlap build modes x overlap cluster modes x sizes, the
same order-stable child seeds (SeedSequence words + a (coupling tag, shape)
spawn key), the same printed lines, the same ``.npz`` schema with flattened
per-disorder keys, and the same plots
(:mod:`peapods_tpu_torch.plot.observables`).  :func:`run_sweep` takes one
more keyword, ``device`` (``"cuda"`` by default), handed to every ``Ising``.
"""

from __future__ import annotations

import itertools
import sys
import time
from pathlib import Path

import numpy as np

from .models.ising import Ising

_COUPLING_SEED_TAGS = {"ferro": 0, "bimodal": 1, "gaussian": 2}

__all__ = ["run_sweep", "_cumulative_overlap_ratio"]


def _run_seed_words(seed):
    if seed is not None and (not isinstance(seed, (int, np.integer)) or seed < 0):
        raise ValueError("seed must be a non-negative integer or None")
    root = np.random.SeedSequence(seed)
    return [int(w) for w in root.generate_state(4, dtype=np.uint32)]


def _run_child_seed(root_words, coupling, shape):
    child = np.random.SeedSequence(
        root_words,
        spawn_key=(_COUPLING_SEED_TAGS[coupling], len(shape), *shape),
    )
    return int(child.generate_state(1, dtype=np.uint64)[0])


def _flatten_per_disorder_arrays(per_disorder, prefix=""):
    """Flatten the nested per-disorder dict into npz-safe keys."""
    head = f"{prefix}_" if prefix else ""
    flat = {}
    for kind, fields in per_disorder.get("cluster_observations", {}).items():
        for field, values in fields.items():
            flat[f"{head}per_disorder_cluster_observations_{kind}_{field}"] = values
    for field, values in (per_disorder.get("parallel_tempering") or {}).items():
        flat[f"{head}per_disorder_pt_{field}"] = values
    return flat


def _cumulative_overlap_ratio(per_sample_hist):
    """I(q)/X(q) from per-sample overlap histograms (Billoire et al. 2014;
    the physics scripts read it through ``tools/physics_torch.py``).

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


def _config_label(coupling, build_mode, oc_mode):
    parts = [coupling]
    if build_mode != "houdayer":
        parts.append(build_mode)
    if oc_mode != "wolff":
        parts.append(oc_mode)
    return "_".join(parts)


# (attribute, npz suffix) pairs saved per model when present.
_SAVED_ATTRS = [
    ("binder_cumulant", "binder_cumulant"),
    ("heat_capacity", "heat_capacity"),
    ("energies_avg", "energies"),
    ("sg_binder", "sg_binder"),
    ("mean_cluster_size", "mean_cluster_size"),
    ("top_cluster_sizes", "top_cluster_sizes"),
    ("per_sample_overlap_histogram", "per_sample_overlap_histogram"),
    ("mags2_tau", "mags2_tau"),
    ("overlap2_tau", "overlap2_tau"),
    ("_equil_sweeps", "equil_sweeps"),
    ("_equil_energy_avg", "equil_energy_avg"),
    ("_equil_link_overlap_avg", "equil_link_overlap_avg"),
]


def _model_npz_entries(prefix, model):
    entries = {f"{prefix}_lattice_shape": np.array(model.lattice_shape)}
    for attr, suffix in _SAVED_ATTRS:
        if hasattr(model, attr):
            entries[f"{prefix}_{suffix}"] = getattr(model, attr)
    if hasattr(model, "overlap_histogram"):
        entries[f"{prefix}_overlap_histogram"] = np.array(
            list(model.overlap_histogram)
        )
    if hasattr(model, "per_sample_overlap_histogram"):
        q_grid, ratio, _, _ = _cumulative_overlap_ratio(
            model.per_sample_overlap_histogram
        )
        entries[f"{prefix}_cumulative_overlap_q"] = q_grid
        entries[f"{prefix}_cumulative_overlap_ratio"] = ratio
    if hasattr(model, "cluster_snapshots"):
        snaps = model.cluster_snapshots
        entries[f"{prefix}_snapshot_sweep_ids"] = np.array(
            [s["sweep_id"] for s in snaps], np.int64
        )
        entries[f"{prefix}_snapshot_mode_idxs"] = np.array(
            [s["mode_idx"] for s in snaps], np.int64
        )
        for field in ("cluster_ids", "spins", "system_ids"):
            entries[f"{prefix}_snapshot_{field}"] = np.stack(
                [s[field] for s in snaps]
            )
        if "blue_ids" in snaps[0]:
            entries[f"{prefix}_snapshot_blue_ids"] = np.stack(
                [s["blue_ids"] for s in snaps]
            )
    entries.update(_flatten_per_disorder_arrays(model.per_disorder, prefix=prefix))
    return entries


def _save_data(models, config_label, temperatures, output_dir):
    save_dict = {"temperatures": temperatures}
    for size_label, model in models.items():
        save_dict.update(_model_npz_entries(size_label, model))
    path = Path(output_dir) / f"sweep_{config_label}.npz"
    np.savez(path, **save_dict)
    print(f"  Data saved to {path}")


def _emit_plots(models, label, temperatures, output_dir, collect_cluster_stats):
    from .plot import observables as obs

    obs.plot_binder(models, label, temperatures, output_dir)
    obs.plot_heat_capacity(models, label, temperatures, output_dir)
    for slabel, model in models.items():
        if hasattr(model, "overlap_histogram"):
            obs.plot_overlap_histogram(model, slabel, label, temperatures, output_dir)
        if hasattr(model, "per_sample_overlap_histogram"):
            obs.plot_cumulative_overlap_ratio(
                model, slabel, label, temperatures, output_dir
            )
        if collect_cluster_stats and hasattr(model, "fk_csd"):
            obs.plot_csd(model, slabel, label, temperatures, output_dir)


def run_sweep(
    sizes,
    *,
    couplings=("ferro",),
    temperatures,
    n_replicas=1,
    n_disorder=1,
    neighbor_offsets=None,
    geometry=None,
    n_sweeps,
    sweep_mode="metropolis",
    cluster_update_interval=None,
    cluster_mode="sw",
    cluster_action="update",
    pt_interval=None,
    pt_schedule="single_random_edge",
    overlap_cluster_update_interval=None,
    overlap_cluster_build_modes=("houdayer",),
    overlap_cluster_modes=("wolff",),
    overlap_cluster_action="update",
    warmup_ratio=0.25,
    collect_cluster_stats=False,
    autocorrelation_max_lag=None,
    autocorrelation_backend="ring",
    autocorrelation_plot_temp=None,
    equilibration_diagnostic=False,
    save_plots=False,
    save_data=False,
    output_dir=".",
    sequential=False,
    snapshot_interval=None,
    seed=None,
    device="cuda",
):
    """Run a parameter sweep over sizes and configurations.

    Sizes share a plot (as legend entries); every other Cartesian combination
    of couplings x overlap build modes x overlap cluster modes gets its own
    figure/data set.  Every model runs on ``device`` (``"cuda"``: the
    CUDA kernels; ``"cpu"``: their plain torch versions).  Returns
    ``{config_label: {size_label: Ising}}``.
    """
    if save_plots:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print(
                "error: matplotlib is required for --save-plots. "
                "Install it with: uv pip install matplotlib",
                file=sys.stderr,
            )
            sys.exit(1)

    if save_plots or save_data:
        Path(output_dir).mkdir(parents=True, exist_ok=True)

    combos = []
    for coupling, build_mode, oc_mode in itertools.product(
        couplings, overlap_cluster_build_modes, overlap_cluster_modes
    ):
        if build_mode != "houdayer" and overlap_cluster_update_interval is None:
            print(
                f"  skip: {_config_label(coupling, build_mode, oc_mode)} — "
                f"overlap_cluster_build_mode={build_mode} set but no "
                "--overlap-cluster-update-interval",
                file=sys.stderr,
            )
            continue
        combos.append((coupling, build_mode, oc_mode))

    total_runs = len(combos) * len(sizes)
    all_results = {}
    run_idx = 0
    wall_start = time.perf_counter()
    seed_words = _run_seed_words(seed)

    for coupling, build_mode, oc_mode in combos:
        label = _config_label(coupling, build_mode, oc_mode)
        models = {}
        for shape in sizes:
            run_idx += 1
            slabel = "x".join(str(s) for s in shape)
            print(f"[{run_idx}/{total_runs}] {slabel}, {label}")
            model = Ising(
                shape,
                couplings=coupling,
                temperatures=temperatures,
                n_replicas=n_replicas,
                n_disorder=n_disorder,
                neighbor_offsets=neighbor_offsets,
                geometry=geometry,
                seed=_run_child_seed(seed_words, coupling, shape),
                device=device,
            )
            t0 = time.perf_counter()
            model.sample(
                n_sweeps,
                sweep_mode=sweep_mode,
                cluster_update_interval=cluster_update_interval,
                cluster_mode=cluster_mode,
                cluster_action=cluster_action,
                pt_interval=pt_interval,
                pt_schedule=pt_schedule,
                overlap_cluster_update_interval=overlap_cluster_update_interval,
                overlap_cluster_build_mode=build_mode,
                overlap_cluster_mode=oc_mode,
                overlap_cluster_action=overlap_cluster_action,
                warmup_ratio=warmup_ratio,
                collect_cluster_stats=collect_cluster_stats,
                autocorrelation_max_lag=autocorrelation_max_lag,
                autocorrelation_backend=autocorrelation_backend,
                sequential=sequential,
                equilibration_diagnostic=equilibration_diagnostic,
                snapshot_interval=snapshot_interval,
            )
            print(f"  {time.perf_counter() - t0:.2f}s")
            models[slabel] = model

        all_results[label] = models
        if save_data:
            _save_data(models, label, temperatures, output_dir)
        if save_plots:
            _emit_plots(models, label, temperatures, output_dir,
                        collect_cluster_stats)

    if save_plots and autocorrelation_max_lag is not None:
        from .plot import observables as obs

        obs.plot_autocorrelation_time(
            all_results, temperatures, autocorrelation_plot_temp, output_dir
        )

    print(
        f"\nSweep complete: {total_runs} runs in "
        f"{time.perf_counter() - wall_start:.1f}s"
    )
    return all_results
