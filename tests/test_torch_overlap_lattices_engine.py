"""The engine with overlap moves on the triangular, BCC and offset-table
lattices, against the JAX package.

* The engine against the reference's per-sweep step body under zero
  uniforms (interpret mode; the port's uniform sources patched to zeros):
  triangular 8x16 with ``jorg+cmr`` and ``cmr+houd4``, BCC 8x4x4 with
  ``jorg+cmr``, R = 4, the move every 2nd sweep with its statistics, PT
  every sweep; spins, system ids, PT state, records (rtol 2e-5, atol 1e-6:
  the reference keeps f32 sums), ``overlap_csd``, ``overlap_histogram``
  and ``cluster_snapshots``.  Where the reference draws jax.random bond
  uniforms (its staged moves: BCC, and the snapshot sweeps), couplings of
  magnitude 50 make every bond probability 1 in f32, so the draws decide
  nothing.
* Overlap observe on an offset table bitwise the run without the observer.
"""

import numpy as np
import pytest
import torch

from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu_torch import Ising
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
BCC = GEOMETRY_OFFSETS["bcc"]
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The reference's interpret mode draws zero uniforms in its sweep and
    event kernels; the port's plain path gets zeros in their place."""
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "site_uniforms",
        lambda words, n, c, n_spins: torch.zeros(words.shape[:-1] + (n, n_spins)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n, n_dirs=2, first=0: torch.zeros(words.shape[:-1] + (n, n_dirs)))


def _equal(a, b, key):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, key
    np.testing.assert_array_equal(a, b, err_msg=key)


def _engines(shape, offsets, n_rep, n_temps, kw, J=1.0, n_sweeps=8):
    """Both engines on one +-J glass of magnitude ``J``, ``n_sweeps`` sweeps
    with PT every sweep: states, PT state and records compared."""
    rng = np.random.default_rng(8)
    coup = (J * rng.choice([-1.0, 1.0], size=(2,) + shape + (len(offsets),))
            ).astype(np.float32)
    temps = np.geomspace(1.0, 2.4, n_temps).astype(np.float32)
    kw = dict(kw, pt_interval=1, warmup_ratio=0.25)
    ref = RefSimulation(list(shape), coup, temps, n_rep, offsets, 5, mesh=None)
    r_ref = ref.sample(n_sweeps, "metropolis", **kw)
    assert not next(iter(ref._programs.values())).megapair
    port = IsingSimulation(list(shape), coup, temps, n_rep, offsets, 5, device="cpu")
    r_port = port.sample(n_sweeps, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts", "pt_edge_acceptances",
                "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(), np.asarray(ref.state[key]),
                                      err_msg=key)
    for key in ("energies", "energies2", "mags", "mags2", "overlap", "overlap2",
                "overlap4", "link_overlap", "link_overlap2", "ql_at_q_sum",
                "ql2_at_q_sum"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=2e-5, atol=1e-6,
                                   err_msg=key)
    _equal(r_port["overlap_histogram"], r_ref["overlap_histogram"], "overlap_histogram")
    for key in ("overlap_csd", "top_cluster_sizes"):
        assert (key in r_port) == (key in r_ref), key
        if key in r_ref:
            _equal(r_port[key], r_ref[key], key)
    snaps = r_port.get("cluster_snapshots", [])
    assert len(snaps) == len(r_ref.get("cluster_snapshots", []))
    for a, b in zip(snaps, r_ref.get("cluster_snapshots", [])):
        assert sorted(a) == sorted(b)
        for key in b:
            _equal(a[key], b[key], f"snapshot {key}")
    return r_port


STATS = dict(overlap_cluster_update_interval=2, collect_cluster_stats=True)


@pytest.mark.parametrize("shape,offsets,kw,J", [
    ((8, 16), TRI, dict(STATS, overlap_cluster_build_mode="jorg+cmr",
                        overlap_cluster_mode="sw", snapshot_interval=2), 50.0),
    ((8, 16), TRI, dict(STATS, overlap_cluster_build_mode="cmr+houd4",
                        overlap_cluster_mode="sw"), 1.0),
    ((8, 4, 4), BCC, dict(STATS, overlap_cluster_build_mode="jorg+cmr",
                          overlap_cluster_mode="wolff", snapshot_interval=2), 50.0),
], ids=["tri-jorg+cmr-snapshots", "tri-cmr+houd4", "bcc-jorg+cmr-wolff-snapshots"])
def test_engine_matches_reference_under_zero_uniforms(zero_uniforms, shape, offsets,
                                                      kw, J):
    """The move every 2nd sweep with its statistics, PT every sweep on
    energies re-derived after each move (measure_nb's partials off the
    square and cubic lattices), R = 4."""
    r = _engines(shape, offsets, 4, 2, kw, J=J)
    assert len(r["overlap_csd"]) == 2
    if "snapshot_interval" in kw:
        assert [x["sweep_id"] for x in r["cluster_snapshots"]] == [2, 4, 6]


def test_observe_on_a_table_leaves_the_run_alone():
    """NNN table, R = 2, houdayer+jorg+cmr SW observe every sweep: spins,
    sid, PT state and records bitwise the run without the observer; the
    observations finite."""
    kw = dict(pt_interval=1, warmup_ratio=0.25)
    runs = []
    for extra in ({}, dict(overlap_cluster_update_interval=1, overlap_cluster_mode="sw",
                           overlap_cluster_action="observe",
                           overlap_cluster_build_mode="houdayer+jorg+cmr")):
        m = Ising((6, 8), neighbor_offsets=NNN, couplings="bimodal",
                  temperatures=[1.2, 2.0], n_replicas=2, n_disorder=2, seed=3,
                  device="cpu")
        runs.append((m, m.sample(8, **kw, **extra)))
    (m0, r0), (m1, r1) = runs
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
        assert torch.equal(m0._sim.state[key], m1._sim.state[key]), key
    for key in ("energies", "overlap2", "link_overlap"):
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    obs = r1["per_disorder"]["cluster_observations"]
    assert list(obs) == ["houdayer", "jorg", "cmr_blue"]
    for name, o in obs.items():
        assert "winding_x" not in o, name
        for key, v in o.items():
            assert np.isfinite(np.asarray(v, np.float64)).all(), (name, key)
