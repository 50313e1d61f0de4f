"""The port's ``run_sweep`` (``peapods_tpu_torch/sweep.py``) and snapshot
reader against the JAX package's, on the CPU.

The configuration of tests/test_sweep_tool.py (4x4 +-J, R = 2, two
realizations, PT, CMR SW every 2 sweeps with cluster statistics, snapshots
every 4 sweeps, data and plots) through both engines: the same ``.npz``
keys, shapes and dtypes, finite where the JAX run's values are, the same
PNG files and the same printed lines (seconds and the output directory
masked).  ``SnapshotSet.from_npz(...).rgb(0, 0)`` of the port is bitwise
the JAX package's on both engines' files.  Without matplotlib,
``save_plots`` exits 1 with the JAX package's message before any run.
"""

import contextlib
import io
import re
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from peapods_tpu.plot.cluster_snapshots import SnapshotSet as RefSnapshotSet  # noqa: E402
from peapods_tpu.sweep import run_sweep as ref_run_sweep  # noqa: E402
from peapods_tpu_torch.plot.cluster_snapshots import SnapshotSet  # noqa: E402
from peapods_tpu_torch.sweep import run_sweep  # noqa: E402

torch.set_num_threads(1)

KW = dict(
    couplings=("bimodal",),
    temperatures=np.array([1.0, 2.0], dtype=np.float32),
    n_replicas=2,
    n_disorder=2,
    n_sweeps=8,
    pt_interval=1,
    overlap_cluster_update_interval=2,
    overlap_cluster_build_modes=("cmr",),
    overlap_cluster_modes=("sw",),
    collect_cluster_stats=True,
    snapshot_interval=4,
    warmup_ratio=0.25,
    save_data=True,
    save_plots=True,
    seed=9,
)
NPZ = "sweep_bimodal_cmr_sw.npz"


def _run(fn, out, **extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = fn([(4, 4)], output_dir=str(out), **KW, **extra)
    text = buf.getvalue()
    masked = re.sub(r"\d+\.\d+s", "<s>s", text.replace(str(out), "<out>"))
    with np.load(out / NPZ) as data:
        arrays = {k: data[k] for k in data.files}
    return dict(out=out, results=results, lines=masked.splitlines(), arrays=arrays,
                pngs=sorted(p.name for p in out.glob("*.png")))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _run(ref_run_sweep, tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return _run(run_sweep, tmp_path_factory.mktemp("port"), device="cpu")


def test_run_sweep_matches_reference(ref, port):
    assert port["lines"] == ref["lines"]
    assert "[1/1] 4x4, bimodal_cmr_sw" in port["lines"]
    assert port["pngs"] == ref["pngs"]
    assert "binder_bimodal_cmr_sw.png" in port["pngs"]
    got, want = port["arrays"], ref["arrays"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
        if v.dtype.kind == "f":
            np.testing.assert_array_equal(np.isfinite(got[k]), np.isfinite(v), err_msg=k)
    for k in ("temperatures", "4x4_lattice_shape", "4x4_snapshot_sweep_ids",
              "4x4_snapshot_mode_idxs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = port["results"]["bimodal_cmr_sw"]["4x4"]
    assert type(model).__module__ == "peapods_tpu_torch.models.ising"
    assert model._sim.device.type == "cpu"


def test_snapshot_reader_matches_reference(ref, port):
    for path in (ref["out"] / NPZ, port["out"] / NPZ):
        mine, theirs = SnapshotSet.from_npz(path), RefSnapshotSet.from_npz(path)
        assert (mine.n_snaps, mine.n_temps, mine.is_cmr) == (
            theirs.n_snaps, theirs.n_temps, theirs.is_cmr)
        for snap in range(mine.n_snaps):
            img = mine.rgb(snap, 0)
            assert img.shape == (4, 4, 3)
            assert img.tobytes() == theirs.rgb(snap, 0).tobytes()
        assert mine.panel_title(0, 1) == theirs.panel_title(0, 1)


def test_save_plots_without_matplotlib_exits(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as exc:
        run_sweep([(4, 4)], temperatures=KW["temperatures"], n_sweeps=2, save_plots=True,
                  output_dir=str(tmp_path / "none"), device="cpu")
    assert exc.value.code == 1
    assert capsys.readouterr().err == ("error: matplotlib is required for --save-plots. "
                                       "Install it with: uv pip install matplotlib\n")
    assert not (tmp_path / "none").exists()
