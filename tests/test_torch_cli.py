"""The port's command line (``peapods_tpu_torch/cli.py``) against the JAX
package's, on the CPU.

* Parser parity: every option of every subcommand has the JAX option's
  dest, default, choices, nargs, type and required flag; the port's one
  extra option is ``--device``.
* The TOML reader, the temperature grid, the size parser and the sweep's
  child seeds are bitwise the JAX package's.
* ``simulate --device cpu -o`` writes the JAX run's ``.npz`` keys, shapes
  and dtypes and prints its table header, one row a temperature; two runs
  from one seed are bitwise equal.  ``bench`` prints its line, ``sweep
  --config`` writes the JAX run's keys, the top-4 column renders one quad a
  temperature.
* Without CUDA and without ``--device cpu`` the command exits with
  ``resolve_device``'s message; it never runs on the CPU instead.
* ``python -m peapods_tpu_torch.cli`` imports neither jax nor the JAX
  package.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from peapods_tpu import cli as ref_cli
from peapods_tpu import sweep as ref_sweep
from peapods_tpu_torch import cli, sweep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIMULATE = ["simulate", "--shape", "4", "4", "--temp-min", "1.5", "--temp-max", "3.0",
            "--n-temps", "3", "--n-sweeps", "8", "--n-replicas", "2", "--pt-interval",
            "1", "--seed", "3"]
CPU = ["--device", "cpu"]


def _subparsers(parser):
    return next(a for a in parser._actions if a.dest == "command").choices


@pytest.mark.parametrize("command", ["simulate", "bench", "sweep"])
def test_parser_parity(command):
    ref = _subparsers(ref_cli.build_parser())[command]
    port = _subparsers(cli.build_parser())[command]
    ref_opts = {a.option_strings[-1]: a for a in ref._actions}
    port_opts = {a.option_strings[-1]: a for a in port._actions}
    assert set(port_opts) - set(ref_opts) == {"--device"}
    assert set(ref_opts) <= set(port_opts)
    for flag, a in ref_opts.items():
        b = port_opts[flag]
        for attr in ("option_strings", "dest", "default", "choices", "nargs", "type",
                     "required", "const"):
            assert getattr(b, attr) == getattr(a, attr), (command, flag, attr)
        assert type(b) is type(a), flag
    dev = port_opts["--device"]
    assert (dev.default, dev.choices, dev.required) == ("cuda", ["cuda", "cpu"], False)


def _all_keys_toml(path):
    path.write_text("\n".join([
        "[lattice]", "sizes = [[4, 4], [6, 6]]", 'couplings = ["bimodal", "ferro"]',
        'geometry = "triangular"', "neighbor_offsets = [[1, 0], [0, 1], [1, 1]]",
        "[temperatures]", "min = 0.5", "max = 2.5", "count = 7", 'scale = "linear"',
        "[replicas]", "n_replicas = 4", "n_disorder = 3",
        "[sampling]", "n_sweeps = 123", 'sweep_mode = "gibbs"', "warmup_ratio = 0.5",
        "sequential = true", "seed = 11",
        "[cluster]", "interval = 3", 'mode = "wolff"', 'action = "observe"',
        "[parallel_tempering]", "interval = 2", 'schedule = "full_ladder"',
        "[overlap_cluster]", "interval = 5", 'build_modes = ["jorg", "cmr+houd4"]',
        "snapshot_interval = 10", 'action = "observe"', 'cluster_mode = ["sw", "wolff"]',
        "[diagnostics]", "collect_cluster_stats = true", "equilibration_diagnostic = true",
        "[diagnostics.autocorrelation]", "max_lag = 50", 'backend = "fft"',
        "plot_temp = 1.25",
        "[output]", "save_plots = true", "save_data = true", 'dir = "out"',
    ]))
    return path


def test_sweep_config_matches_reference(tmp_path):
    every = _all_keys_toml(tmp_path / "all.toml")
    for path in (ROOT / "examples" / "sweep_config.toml", every):
        got, want = cli._load_sweep_config(path), ref_cli._load_sweep_config(path)
        assert got == want
    got = cli._load_sweep_config(every)
    schema = {e[1] for entries in ref_cli._TOML_SCHEMA.values() for e in entries}
    assert schema <= set(got)


def test_grids_sizes_and_seeds_match_reference():
    for args in [(1.8, 3.2, 24, "log"), (0.8, 1.4, 12, "linear"), (1.0, 2.0, 1, "log"),
                 (0.1, 10.0, 32, "log"), (1.5, 3.0, 3, "linear")]:
        got, want = cli._temperature_grid(*args), ref_cli._temperature_grid(*args)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    sizes = ["8,8", "8,8,8", [10, 10, 10], (4,), "3,5,7,9"]
    assert cli._parse_sizes(sizes) == ref_cli._parse_sizes(sizes)
    shapes = [(4,), (8, 8), (8, 8, 8), (10, 10, 10), (255, 255), (16, 16, 16, 16)]
    seeds = [0, 1, 7, 42, 2**32 - 1, 2**32, 2**62 + 3, 2**63 - 1]
    for seed in seeds:
        words = sweep._run_seed_words(seed)
        assert words == ref_sweep._run_seed_words(seed)
        for coupling in ("ferro", "bimodal", "gaussian"):
            for shape in shapes:
                assert (sweep._run_child_seed(words, coupling, shape)
                        == ref_sweep._run_child_seed(words, coupling, shape))
    with pytest.raises(ValueError):
        sweep._run_seed_words(-1)


def _table(out):
    lines = out.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("-----"))
    rows = [ln for ln in lines[i + 1:] if ln.strip() and not ln.startswith("Results")]
    return lines[i - 1], rows


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_simulate_matches_reference(tmp_path, capsys):
    ref_cli.main(SIMULATE + ["-o", str(tmp_path / "ref.npz")])
    ref_out = capsys.readouterr().out
    outs = []
    for name in ("a", "b"):
        cli.main(SIMULATE + CPU + ["-o", str(tmp_path / f"{name}.npz")])
        outs.append(capsys.readouterr().out)
    ref, a, b = (_npz(tmp_path / f"{x}.npz") for x in ("ref", "a", "b"))
    assert sorted(a) == sorted(ref)
    for k in ref:
        assert (a[k].shape, a[k].dtype) == (ref[k].shape, ref[k].dtype), k
        assert a[k].tobytes() == b[k].tobytes(), k
    header, rows = _table(outs[0])
    ref_header, ref_rows = _table(ref_out)
    assert header == ref_header and "Overlap Binder" in header
    assert len(rows) == len(ref_rows) == 3
    for name, out in zip("ab", outs):
        assert out.endswith(f"\nResults saved to {tmp_path / f'{name}.npz'}\n")
    assert outs[0].rsplit("\n", 2)[0] == outs[1].rsplit("\n", 2)[0]


def test_simulate_table_with_cluster_stats(capsys):
    """The top-4 column of tests/test_cli.py: one quad a temperature."""
    cli.main(["simulate", "--shape", "4", "4", "--temp-min", "1.5", "--temp-max", "3.0",
              "--n-temps", "3", "--n-sweeps", "16", "--n-replicas", "2",
              "--pt-interval", "1", "--cluster-interval", "4",
              "--overlap-cluster-update-interval", "8", "--collect-cluster-stats",
              "--seed", "3"] + CPU)
    out = capsys.readouterr().out
    assert "Top-4 Clusters" in out
    quads = [ln for ln in out.splitlines() if ln.rstrip().endswith(")")]
    assert len(quads) == 3, out


def test_bench_reports_ms_per_sweep(capsys):
    cli.main(["bench", "--shape", "4", "4", "--temp-min", "1.0", "--temp-max", "2.0",
              "--n-temps", "2", "--n-sweeps", "4", "--seed", "1"] + CPU)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Lattice: 4x4  |  Temps: 2  |  Sweeps: 4"
    assert "ms/sweep" in out[1] and "flip attempts/s" in out[1]


def test_sweep_from_toml_matches_reference_keys(tmp_path, capsys):
    for name, main, extra in (("ref", ref_cli.main, []), ("port", cli.main, CPU)):
        out = tmp_path / name
        config = tmp_path / f"{name}.toml"
        config.write_text("\n".join([
            "[lattice]", "sizes = [[4, 4]]", "[temperatures]", "min = 1.0", "max = 2.0",
            "count = 2", "[sampling]", "n_sweeps = 4", "seed = 5", "[output]",
            "save_data = true", f'dir = "{out}"']))
        main(["sweep", "--config", str(config)] + extra)
    capsys.readouterr()
    ref, port = _npz(tmp_path / "ref" / "sweep_ferro.npz"), _npz(
        tmp_path / "port" / "sweep_ferro.npz")
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert (port[k].shape, port[k].dtype) == (ref[k].shape, ref[k].dtype), k


@pytest.mark.skipif(torch.cuda.is_available(), reason="the device exists here")
def test_no_cuda_exits_with_the_device_error(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(SIMULATE)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "device='cuda' was requested but torch sees no CUDA device" in err


def test_module_run_imports_no_jax(tmp_path):
    out = tmp_path / "m.npz"
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "peapods_tpu_torch.cli", *SIMULATE,
         *CPU, "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out.exists() and "Binder" in proc.stdout
    modules = [ln.rsplit("|", 1)[-1].strip() for ln in proc.stderr.splitlines()
               if ln.startswith("import time:")]
    assert "peapods_tpu_torch.sweep" in modules  # the CLI's own imports
    bad = [m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "peapods_tpu")]
    assert bad == []
