"""Command-line interface of the port: ``peapods-torch simulate | bench | sweep``.

The port's own copy of ``peapods_tpu/cli.py``: the same subcommands, flags,
defaults, temperature grids, TOML schema, precedence CLI > TOML > defaults,
results table and ``-o`` export, plus one flag on every subcommand,
``--device {cuda,cpu}`` (default ``cuda``: the CUDA kernels; ``cpu``: their
plain torch versions).  Without a GPU a ``cuda`` run exits with an error; it
never falls back to the CPU.  Run it as ``peapods-torch ...`` or
``python -m peapods_tpu_torch.cli ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import tomllib

import numpy as np

from .models.ising import Ising
from .sweep import _flatten_per_disorder_arrays, run_sweep

COUPLING_CHOICES = ["ferro", "bimodal", "gaussian"]
DEVICE_CHOICES = ["cuda", "cpu"]
OVERLAP_CLUSTER_CHOICES = ["wolff", "sw"]

# (flag, kwargs builder) shared by simulate/bench; `sweepable` entries are
# re-declared on the sweep subcommand with default=None so the TOML config
# can fill them (precedence CLI > TOML > defaults, cli.py:463-533).
_GEOMETRY_CHOICES = ["triangular", "tri", "fcc", "bcc"]


def _common_options(required_temps: bool):
    req = {"required": True} if required_temps else {"default": None}
    return [
        ("--geometry", dict(choices=_GEOMETRY_CHOICES, help="Named lattice geometry")),
        (
            "--neighbor-offsets",
            dict(
                type=str,
                default=None,
                help="JSON list of offset vectors, e.g. '[[1,0],[0,1]]'",
            ),
        ),
        ("--n-replicas", dict(type=int, default=1 if required_temps else None)),
        ("--n-disorder", dict(type=int, default=1 if required_temps else None)),
        ("--seed", dict(type=int, default=None)),
        ("--temp-min", dict(type=float, **req)),
        ("--temp-max", dict(type=float, **req)),
        ("--n-temps", dict(type=int, default=32 if required_temps else None)),
        (
            "--temp-scale",
            dict(
                default="log" if required_temps else None,
                choices=["linear", "log"],
                help="Temperature spacing (default: log)",
            ),
        ),
        ("--n-sweeps", dict(type=int, **({"required": True} if required_temps else {"default": None}))),
        (
            "--sweep-mode",
            dict(
                default="metropolis" if required_temps else None,
                choices=["metropolis", "gibbs"],
            ),
        ),
        (
            "--cluster-interval",
            dict(type=int, default=None, help="Cluster update every N sweeps"),
        ),
        (
            "--cluster-mode",
            dict(default="sw" if required_temps else None, choices=["sw", "wolff"]),
        ),
        (
            "--cluster-action",
            dict(
                default="update" if required_temps else None,
                choices=["update", "observe"],
            ),
        ),
        (
            "--pt-interval",
            dict(type=int, default=None, help="Parallel tempering every N sweeps"),
        ),
        (
            "--pt-schedule",
            dict(
                default="single_random_edge" if required_temps else None,
                choices=["single_random_edge", "full_ladder"],
            ),
        ),
        (
            "--overlap-cluster-update-interval",
            dict(
                type=int,
                default=None,
                help="Overlap cluster move every N sweeps (requires n_replicas >= 2)",
            ),
        ),
        (
            "--collect-cluster-stats",
            dict(
                action="store_true",
                default=False if required_temps else None,
                help="Collect FK cluster size distribution and top-4 overlap "
                "cluster sizes",
            ),
        ),
        (
            "--autocorrelation-max-lag",
            dict(
                type=int,
                default=None,
                help="Max lag for autocorrelation of m² and q²",
            ),
        ),
        (
            "--autocorrelation-backend",
            dict(
                default="ring" if required_temps else None,
                choices=["ring", "fft"],
                help="Autocorrelation backend (default: ring; FFT retains full "
                "history)",
            ),
        ),
        (
            "--equilibration-diagnostic",
            dict(
                action="store_true",
                default=False if required_temps else None,
                help="Track energy + link-overlap running averages for "
                "equilibration check",
            ),
        ),
    ]


def _apply(parser, options):
    for flag, kw in options:
        parser.add_argument(flag, **kw)


def add_simulation_args(parser):
    _apply(parser, [
        ("--shape", dict(type=int, nargs="+", required=True,
                         help="Lattice dimensions, e.g. --shape 32 32")),
        ("--couplings", dict(default="ferro", choices=COUPLING_CHOICES,
                             help="Coupling distribution (default: ferro)")),
        ("--overlap-cluster-build-mode", dict(default="houdayer")),
        ("--overlap-cluster-mode", dict(default="wolff",
                                        choices=OVERLAP_CLUSTER_CHOICES)),
        ("--overlap-cluster-action", dict(default="update",
                                          choices=["update", "observe"])),
    ])
    _apply(parser, _common_options(required_temps=True))


def _add_sweep_args(parser):
    _apply(parser, [
        ("--config", dict(type=str, default=None,
                          help="Path to TOML config file")),
        ("--sizes", dict(nargs="+", default=None,
                         help="Lattice sizes as comma-separated dims, e.g. "
                         "--sizes 8,8 16,16 8,8,8")),
        ("--couplings", dict(nargs="+", default=None,
                             choices=COUPLING_CHOICES,
                             help="Coupling distributions to sweep "
                             "(default: ferro)")),
        ("--overlap-cluster-build-mode", dict(nargs="+", default=None)),
        ("--overlap-cluster-mode", dict(nargs="+", default=None,
                                        choices=OVERLAP_CLUSTER_CHOICES)),
        ("--overlap-cluster-action", dict(default=None,
                                          choices=["update", "observe"])),
    ])
    _apply(parser, _common_options(required_temps=False))
    _apply(parser, [
        ("--sequential", dict(action="store_true", default=None,
                              help="Layout hint kept for API compatibility "
                              "(the engine runs every replica and "
                              "realization in the same launches)")),
        ("--snapshot-interval", dict(type=int, default=None,
                                     help="Save cluster snapshots every N "
                                     "sweeps (must be multiple of "
                                     "overlap_cluster interval)")),
        ("--warmup-ratio", dict(type=float, default=None)),
        ("--autocorrelation-plot-temp", dict(
            type=float, default=None,
            help="Temperature at which to plot τ vs L (uses nearest T in "
            "grid)")),
        ("--save-plots", dict(action="store_true", default=None,
                              help="Save plots to disk")),
        ("--save-data", dict(action="store_true", default=None,
                             help="Save data as .npz")),
        ("--output-dir", dict(default=None,
                              help="Output directory (default: .)")),
    ])


def _temperature_grid(tmin, tmax, count, scale):
    """Temperature ladder: geometric by default, linear on request."""
    spacing = np.linspace if scale == "linear" else np.geomspace
    return spacing(tmin, tmax, count)


def build_model(args):
    offsets = args.neighbor_offsets
    return Ising(
        tuple(args.shape),
        couplings=args.couplings,
        temperatures=_temperature_grid(
            args.temp_min, args.temp_max, args.n_temps, args.temp_scale
        ),
        n_replicas=args.n_replicas,
        n_disorder=args.n_disorder,
        neighbor_offsets=json.loads(offsets) if offsets is not None else None,
        geometry=args.geometry,
        seed=args.seed,
        device=args.device,
    )


# `Ising.sample` kwargs forwarded straight from the parsed namespace; values
# whose CLI flag is spelled differently go through _ARG_ALIASES.
_SAMPLE_FORWARDS = (
    "sweep_mode",
    "cluster_update_interval",
    "cluster_mode",
    "cluster_action",
    "pt_interval",
    "pt_schedule",
    "overlap_cluster_update_interval",
    "overlap_cluster_build_mode",
    "overlap_cluster_mode",
    "overlap_cluster_action",
    "collect_cluster_stats",
    "autocorrelation_max_lag",
    "autocorrelation_backend",
    "equilibration_diagnostic",
)
_ARG_ALIASES = {"cluster_update_interval": "cluster_interval"}


def sample_kwargs(args):
    return {
        kw: getattr(args, _ARG_ALIASES.get(kw, kw)) for kw in _SAMPLE_FORWARDS
    }


# Sweep-tool defaults, grouped like the TOML sections; required-but-unset
# entries are None and checked in run_sweep_cli.
_SWEEP_DEFAULTS = {
    # lattice
    "sizes": None, "couplings": ("ferro",),
    "geometry": None, "neighbor_offsets": None,
    # temperatures
    "temp_min": None, "temp_max": None, "n_temps": 32, "temp_scale": "log",
    # replicas
    "n_replicas": 1, "n_disorder": 1,
    # sampling
    "n_sweeps": None, "sweep_mode": "metropolis", "warmup_ratio": 0.25,
    "seed": None, "sequential": False,
    # cluster
    "cluster_interval": None, "cluster_mode": "sw", "cluster_action": "update",
    # parallel tempering
    "pt_interval": None, "pt_schedule": "single_random_edge",
    # overlap cluster
    "overlap_cluster_update_interval": None,
    "overlap_cluster_build_mode": ("houdayer",),
    "overlap_cluster_mode": ("wolff",),
    "overlap_cluster_action": "update",
    "snapshot_interval": None,
    # diagnostics
    "collect_cluster_stats": False,
    "autocorrelation_max_lag": None, "autocorrelation_backend": "ring",
    "autocorrelation_plot_temp": None, "equilibration_diagnostic": False,
    # output
    "save_plots": False, "save_data": False, "output_dir": ".",
}

# TOML section -> (toml key, run_sweep kwarg) mapping
_TOML_SCHEMA = {
    "lattice": [
        ("geometry", "geometry"),
        ("couplings", "couplings", tuple),
    ],
    "temperatures": [
        ("min", "temp_min"),
        ("max", "temp_max"),
        ("count", "n_temps"),
        ("scale", "temp_scale"),
    ],
    "replicas": [
        ("n_replicas", "n_replicas"),
        ("n_disorder", "n_disorder"),
    ],
    "sampling": [
        ("n_sweeps", "n_sweeps"),
        ("sweep_mode", "sweep_mode"),
        ("warmup_ratio", "warmup_ratio"),
        ("sequential", "sequential"),
        ("seed", "seed"),
    ],
    "cluster": [
        ("interval", "cluster_interval"),
        ("mode", "cluster_mode"),
        ("action", "cluster_action"),
    ],
    "parallel_tempering": [
        ("interval", "pt_interval"),
        ("schedule", "pt_schedule"),
    ],
    "overlap_cluster": [
        ("interval", "overlap_cluster_update_interval"),
        ("build_modes", "overlap_cluster_build_mode", tuple),
        ("snapshot_interval", "snapshot_interval"),
        ("action", "overlap_cluster_action"),
    ],
}


def _load_sweep_config(path):
    with open(path, "rb") as f:
        cfg = tomllib.load(f)

    kw = {}
    for section, entries in _TOML_SCHEMA.items():
        data = cfg.get(section, {})
        for entry in entries:
            toml_key, kwarg = entry[0], entry[1]
            conv = entry[2] if len(entry) > 2 else (lambda v: v)
            if toml_key in data:
                kw[kwarg] = conv(data[toml_key])

    lat = cfg.get("lattice", {})
    if "sizes" in lat:
        kw["sizes"] = [tuple(s) for s in lat["sizes"]]
    if "neighbor_offsets" in lat:
        kw["neighbor_offsets"] = [list(o) for o in lat["neighbor_offsets"]]

    oc = cfg.get("overlap_cluster", {})
    if "cluster_mode" in oc:
        v = oc["cluster_mode"]
        kw["overlap_cluster_mode"] = tuple(v if isinstance(v, list) else [v])

    d = cfg.get("diagnostics", {})
    if "collect_cluster_stats" in d:
        kw["collect_cluster_stats"] = d["collect_cluster_stats"]
    ac = d.get("autocorrelation", {})
    if "max_lag" in ac:
        kw["autocorrelation_max_lag"] = ac["max_lag"]
    if "backend" in ac:
        kw["autocorrelation_backend"] = ac["backend"]
    if "plot_temp" in ac:
        kw["autocorrelation_plot_temp"] = ac["plot_temp"]
    if "equilibration_diagnostic" in d:
        kw["equilibration_diagnostic"] = d["equilibration_diagnostic"]

    out = cfg.get("output", {})
    if "save_plots" in out:
        kw["save_plots"] = out["save_plots"]
    if "save_data" in out:
        kw["save_data"] = out["save_data"]
    if "dir" in out:
        kw["output_dir"] = out["dir"]

    return kw


# run_sweep kwargs whose CLI/TOML spelling differs, and kwargs that must
# arrive as tuples (the sweep tool Cartesian-products over them).
_RUN_SWEEP_RENAMES = {
    "cluster_interval": "cluster_update_interval",
    "overlap_cluster_build_mode": "overlap_cluster_build_modes",
    "overlap_cluster_mode": "overlap_cluster_modes",
}
_RUN_SWEEP_TUPLES = {
    "couplings",
    "overlap_cluster_build_modes",
    "overlap_cluster_modes",
}
# Consumed before forwarding (turned into `sizes` / the temperature grid).
_RUN_SWEEP_LOCAL = {"sizes", "temp_min", "temp_max", "n_temps", "temp_scale"}


def _parse_sizes(sizes):
    """Normalize CLI ('8,8') or TOML ([8, 8]) size entries to int tuples."""
    return [
        tuple(int(d) for d in (s.split(",") if isinstance(s, str) else s))
        for s in sizes
    ]


def run_sweep_cli(args):
    # Precedence: CLI flag > TOML config > _SWEEP_DEFAULTS.  Every sweep flag
    # defaults to None, so "the user typed it" is simply "it is not None".
    merged = dict(_SWEEP_DEFAULTS)
    if args.config is not None:
        merged.update(_load_sweep_config(args.config))
    merged.update(
        {
            k: v
            for k, v in vars(args).items()
            if k in _SWEEP_DEFAULTS and v is not None
        }
    )

    missing = [
        k for k in ("sizes", "temp_min", "temp_max", "n_sweeps") if merged[k] is None
    ]
    if missing:
        flags = ", ".join("--" + k.replace("_", "-") for k in missing)
        print(
            f"error: required option(s) not set: {flags} "
            "(pass on the command line or in the config file)",
            file=sys.stderr,
        )
        sys.exit(1)

    forwarded = {}
    for key, value in merged.items():
        if key in _RUN_SWEEP_LOCAL:
            continue
        name = _RUN_SWEEP_RENAMES.get(key, key)
        if name in _RUN_SWEEP_TUPLES:
            value = tuple(value)
        elif name == "neighbor_offsets" and isinstance(value, str):
            value = json.loads(value)
        forwarded[name] = value

    run_sweep(
        _parse_sizes(merged["sizes"]),
        temperatures=_temperature_grid(
            merged["temp_min"],
            merged["temp_max"],
            merged["n_temps"],
            merged["temp_scale"],
        ),
        **forwarded,
        device=args.device,
    )


# ------------------------------------------------------------------ report

# Results table, declaratively: (header, width, model attribute, cell
# formatter).  Optional columns render only when the attribute exists —
# presence mirrors the conditional result keys (engine/results.py).
def _fmt_top4(quad):
    return "(%.3f, %.3f, %.3f, %.3f)" % tuple(quad)


def _top4_rows(model):
    """Per-temperature quads for the table: ``top_cluster_sizes`` is a
    per-overlap-mode list of (n_temps, 4) arrays (engine/results.py:333);
    show the first populated mode."""
    tops = model.top_cluster_sizes
    return next((t for t in tops if len(t)), tops[0])


_TABLE_COLUMNS = (
    ("T", 8, "temperatures", "{:.4f}".format),
    ("E", 10, "energies_avg", "{:.6f}".format),
    ("Binder", 10, "binder_cumulant", "{:.6f}".format),
    ("C_v", 10, "heat_capacity", "{:.4f}".format),
    ("Overlap Binder", 15, "sg_binder", "{:.6f}".format),
    ("Cluster Size", 14, "mean_cluster_size", "{:.2f}".format),
    ("Top-4 Clusters", 30, "top_cluster_sizes", _fmt_top4),
)

# attributes that are not already a per-temperature sequence
_COLUMN_ROWS = {"top_cluster_sizes": _top4_rows}


def print_table(model):
    """Per-temperature observable table from whatever the model exposes."""
    live = [c for c in _TABLE_COLUMNS if hasattr(model, c[2])]
    header = "  ".join(title.rjust(width) for title, width, _, _ in live)
    lines = [header, "-" * len(header)]
    columns = [
        [
            fmt(cell).rjust(width)
            for cell in _COLUMN_ROWS.get(attr, lambda m, a=attr: getattr(m, a))(model)
        ]
        for _, width, attr, fmt in live
    ]
    lines.extend("  ".join(cells) for cells in zip(*columns))
    print("\n".join(lines))


# npz export spec for `simulate -o`: raw result-dict keys plus derived model
# attributes, each included only when present (src/lib.rs result presence
# conditions flow through unchanged).
_EXPORT_RESULT_KEYS = (
    "mags", "mags2", "mags4", "energies", "energies2",
    "overlap", "overlap2", "overlap4",
)
_EXPORT_MODEL_ATTRS = (
    "sg_binder", "mean_cluster_size", "fk_csd", "top_cluster_sizes",
    "per_sample_overlap_histogram",
)


def _export_payload(model, result):
    payload = {
        "temperatures": model.temperatures,
        "binder_cumulant": model.binder_cumulant,
        "heat_capacity": model.heat_capacity,
    }
    payload.update((k, result[k]) for k in _EXPORT_RESULT_KEYS if k in result)
    payload.update(
        (a, getattr(model, a)) for a in _EXPORT_MODEL_ATTRS if hasattr(model, a)
    )
    payload.update(_flatten_per_disorder_arrays(model.per_disorder))
    return payload


# ------------------------------------------------------------- subcommands


def run_simulate(args):
    model = build_model(args)
    result = model.sample(
        args.n_sweeps, warmup_ratio=args.warmup_ratio, **sample_kwargs(args)
    )
    print_table(model)
    if args.output:
        np.savez(args.output, **_export_payload(model, result))
        print(f"\nResults saved to {args.output}")


def run_bench(args):
    model = build_model(args)
    started = time.perf_counter()
    # sample() returns host copies of its results, so the window ends after
    # the device has finished every launch
    model.sample(args.n_sweeps, warmup_ratio=0.0, **sample_kwargs(args))
    seconds = time.perf_counter() - started

    dims = "x".join(str(d) for d in args.shape)
    flip_attempts = (
        int(np.prod(args.shape)) * args.n_replicas * args.n_temps * args.n_sweeps
    )
    print(f"Lattice: {dims}  |  Temps: {args.n_temps}  |  Sweeps: {args.n_sweeps}")
    print(
        f"Total: {seconds:.3f} s  |  {1e3 * seconds / args.n_sweeps:.3f} ms/sweep"
        f"  |  {flip_attempts / seconds:.3e} flip attempts/s"
    )


def _install_simulate(parser):
    add_simulation_args(parser)
    parser.add_argument("--warmup-ratio", type=float, default=0.25)
    parser.add_argument(
        "-o", "--output", type=str, default=None,
        help="Save full results to .npz file",
    )


def _add_device(parser):
    parser.add_argument(
        "--device", default="cuda", choices=DEVICE_CHOICES,
        help="Where to run: cuda (the CUDA kernels) or cpu (their plain torch "
        "versions); default: cuda",
    )


# name -> (help text, argument installer, runner); build_parser and main are
# both driven by this registry.
_SUBCOMMANDS = {
    "simulate": ("Run an Ising simulation", _install_simulate, run_simulate),
    "bench": ("Benchmark sampling performance", add_simulation_args, run_bench),
    "sweep": (
        "Run parameter sweeps with optional plotting",
        _add_sweep_args,
        run_sweep_cli,
    ),
}


def build_parser():
    parser = argparse.ArgumentParser(
        prog="peapods-torch",
        description="Ising Monte Carlo simulations from the command line "
        "(PyTorch / CUDA engine).",
    )
    subparsers = parser.add_subparsers(dest="command")
    for name, (help_text, install_args, runner) in _SUBCOMMANDS.items():
        sub = subparsers.add_parser(name, help=help_text)
        install_args(sub)
        _add_device(sub)
        sub.set_defaults(_runner=runner)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    runner = getattr(args, "_runner", None)
    if runner is None:
        parser.print_help()
        sys.exit(1)
    from .engine.simulation import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as err:
        print(f"error: {err}", file=sys.stderr)
        sys.exit(1)
    runner(args)


if __name__ == "__main__":
    main()
