"""The engine with replicas on the table lattices (four dimensions or more,
or 7 to 32 offsets) against the JAX package and exact enumeration.

* The engine bitwise the JAX engine (its jnp path: ``mc_sweep``, the FK
  bonds and the staged moves on ``GridOps``) when both draw zero uniforms,
  on a 3^4 +-J glass of magnitude 50 (every bond probability 1 in f32, so
  the moves' jax.random bond uniforms decide nothing), R = 2, Houdayer and
  CMR SW moves every sweep with their statistics, SW every 2 sweeps with
  its statistics, full-ladder PT: spins, system ids, PT state, records
  (rtol 2e-5, atol 1e-6: the reference keeps f32 sums), the histograms.
* A 2^4 +-J glass (16 spins, four double bonds a site) against exact
  enumeration with each move kind: <e> within 0.03 and <q^2> within 0.05,
  as PERF.md section 2 holds the 4 x 4 glass.
* A 3^4 +-J glass against the JAX engine by a z-test of <E>, <m^2> and
  <q^2> per temperature (|z| < 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import peapods_tpu.engine.loop as ref_loop
from peapods_tpu import Ising as RefIsing
from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.ops import cluster as ref_cluster
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch import Ising
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import rng as trng

torch.set_num_threads(1)


@pytest.fixture
def zero_uniforms(monkeypatch):
    """Both engines draw zero uniforms: the port's sources, and the
    reference's jnp sweep and FK bonds (which would draw from
    ``jax.random``)."""
    monkeypatch.setattr(
        trng, "site_uniforms",
        lambda words, n, c, n_spins: torch.zeros(words.shape[:-1] + (n, n_spins)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n, n_dirs=2, first=0: torch.zeros(words.shape[:-1] + (n, n_dirs)))
    sweep, bonds = ref_loop.mc_sweep, ref_cluster.fk_bond_activation

    def zero_sweep(spins, coup, coup_bwd, geom, masks, temps, key, *, gibbs):
        u = jnp.zeros((masks.shape[0],) + spins.shape, jnp.float32)
        return sweep(spins, coup, coup_bwd, geom, masks, temps, key, gibbs=gibbs,
                     uniforms=u)

    def zero_bonds(spins, coup, geom, temp, key, **kw):
        return bonds(spins, coup, geom, temp, key,
                     u=jnp.zeros(spins.shape + (geom.n_neighbors,), jnp.float32), **kw)

    monkeypatch.setattr(ref_loop, "mc_sweep", zero_sweep)
    monkeypatch.setattr(ref_cluster, "fk_bond_activation", zero_bonds)


def test_engine_matches_reference_under_zero_uniforms(zero_uniforms):
    """3^4, |J| = 50, R = 2, houdayer+cmr SW every sweep with statistics, SW
    every 2 sweeps with statistics, full-ladder PT, 8 sweeps."""
    shape = (3, 3, 3, 3)
    rng = np.random.default_rng(8)
    coup = (50.0 * rng.choice([-1.0, 1.0], size=(2,) + shape + (4,))).astype(np.float32)
    temps = np.geomspace(1.0, 2.4, 2).astype(np.float32)
    kw = dict(pt_interval=1, pt_schedule="full_ladder", overlap_cluster_update_interval=1,
              overlap_cluster_build_mode="houdayer+cmr", overlap_cluster_mode="sw",
              cluster_update_interval=2, cluster_mode="sw", collect_cluster_stats=True,
              warmup_ratio=0.25)
    ref = RefSimulation(list(shape), coup, temps, 2, None, 5, mesh=None)
    r_ref = ref.sample(8, "metropolis", **kw)
    port = IsingSimulation(list(shape), coup, temps, 2, None, 5, device="cpu")
    r_port = port.sample(8, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts", "pt_edge_acceptances",
                "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(), np.asarray(ref.state[key]),
                                      err_msg=key)
    for key in ("energies", "energies2", "mags", "mags2", "overlap", "overlap2",
                "overlap4", "link_overlap", "link_overlap2", "ql_at_q_sum",
                "ql2_at_q_sum"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=2e-5, atol=1e-6,
                                   err_msg=key)
    for key in ("overlap_histogram", "overlap_csd", "fk_csd"):
        np.testing.assert_array_equal(np.asarray(r_port[key]), np.asarray(r_ref[key]),
                                      err_msg=key)
    # the top-4 fractions: the reference adds them in f32
    np.testing.assert_allclose(np.asarray(r_port["top_cluster_sizes"]),
                               np.asarray(r_ref["top_cluster_sizes"]), rtol=2e-5)


def _exact_glass(J, T):
    """Exact <e> and <q^2> of one +-J glass on 2^4 by enumeration of its
    2^16 states, bonds from the forward table (double bonds count twice):
    <q^2> = sum_ij <s_i s_j>^2 / n^2."""
    lat = RefLattice([2, 2, 2, 2])
    n = lat.n_spins
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    bi = np.repeat(np.arange(n), lat.n_neighbors)
    # the engine's energy is the bond sum sum J s_i s_j (its weight e^(E / T))
    E = (states[:, bi] * states[:, lat.fwd.reshape(-1)] * J.reshape(-1)).sum(1)
    w = np.exp((E - E.max()) / T)
    w /= w.sum()
    corr = np.einsum("k,ki,kj->ij", w, states.astype(np.float64), states.astype(np.float64))
    return (w * E).sum() / n, (corr ** 2).sum() / n ** 2


@pytest.mark.parametrize("build", ["houdayer", "jorg", "cmr"])
def test_glass_2to4_against_exact_enumeration(build):
    """64 chains (realizations of one 2^4 +-J glass, T = 1.5), R = 2, the move
    (SW) every sweep, 300 sweeps: <e> within 0.03 and <q^2> within 0.05 of
    exact enumeration (seen within 0.003 and 0.006)."""
    T = 1.5
    J = np.random.default_rng(44).choice([-1.0, 1.0], size=(16, 4)).astype(np.float32)
    e_ex, q2_ex = _exact_glass(J, T)
    coup = np.broadcast_to(J.reshape(2, 2, 2, 2, 4), (64, 2, 2, 2, 2, 4)).copy()
    m = IsingSimulation([2, 2, 2, 2], coup, np.array([T], np.float32), 2, None, 12,
                        device="cpu")
    r = m.sample(300, "metropolis", warmup_ratio=0.2, overlap_cluster_update_interval=1,
                 overlap_cluster_build_mode=build, overlap_cluster_mode="sw")
    assert abs(r["energies"][0] - e_ex) < 0.03, (r["energies"][0], e_ex)
    assert abs(r["overlap2"][0] - q2_ex) < 0.05, (r["overlap2"][0], q2_ex)


def test_z_test_3to4_glass_against_jax_engine():
    """Batch means of <E>, <m^2> and <q^2> per temperature from 8
    consecutive sample() calls of 20 sweeps on each engine (one 3^4 +-J
    glass, R = 2, houdayer+cmr Wolff every sweep and PT; the reference's
    jnp path): |z| < 4."""
    temps = np.array([1.6, 2.4, 4.0], np.float32)
    kw = dict(pt_interval=1, overlap_cluster_update_interval=1,
              overlap_cluster_build_mode="houdayer+cmr", overlap_cluster_mode="wolff",
              warmup_ratio=0)
    J = np.random.default_rng(74).choice([-1.0, 1.0], size=(3, 3, 3, 3, 4)).astype(np.float32)
    stats = {}
    for name, make in (("jax", RefIsing), ("port", Ising)):
        extra = {} if name == "jax" else dict(device="cpu")
        model = make((3, 3, 3, 3), couplings=J, temperatures=temps, n_replicas=2,
                     seed=75 if name == "jax" else 76, **extra)
        model.sample(20, **kw)  # burn-in
        rows = []
        for _ in range(8):
            r = model.sample(20, **kw)
            rows.append((r["energies"], r["mags2"], r["overlap2"]))
        stats[name] = np.array(rows)  # [8, 3, T]
    for k, label in enumerate(("E", "m2", "q2")):
        a, b = stats["jax"][:, k], stats["port"][:, k]
        se = np.sqrt(a.var(0, ddof=1) / 8 + b.var(0, ddof=1) / 8)
        z = (a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)
        assert (np.abs(z) < 4).all(), (label, z)
