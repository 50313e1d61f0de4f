"""The port's cluster path on the CPU: physics, statistics and schema.

``Ising(..., device="cpu").sample(..., cluster_update_interval=k)`` runs
the plain torch versions of the per-sweep path's kernels.  SW and Wolff
must reach the 4x4 exact enumeration (the oracle and tolerances of
tests/test_exact_equilibrium.py), agree statistically with the JAX engine's
jnp path, collect cluster-size histograms that account for every site, and
return the reference's results keys and dtypes.
"""

import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu_torch import Ising, IsingSimulation

torch.set_num_threads(1)


def _exact_4x4(T):
    n = 16
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    idx = np.arange(16).reshape(4, 4)
    bi = np.repeat(idx.reshape(-1), 2)
    bj = np.stack([np.roll(idx, -1, 0), np.roll(idx, -1, 1)], -1).reshape(-1)
    E = (states[:, bi] * states[:, bj]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    w = np.exp(E / T - E.max() / T)
    return (E * w).sum() / w.sum() / n, ((M / n) ** 2 * w).sum() / w.sum()


def _schema(x):
    if isinstance(x, dict):
        return {k: _schema(v) for k, v in x.items()}
    return (np.asarray(x).shape, np.asarray(x).dtype)


@pytest.mark.parametrize("mode", ["sw", "wolff"])
def test_4x4_exact(mode):
    """Half the sweeps of tests/test_exact_equilibrium.py: a cluster update
    every sweep decorrelates a 4x4 lattice within a sweep or two, so 3000
    recorded sweeps put the statistical error far below the tolerances."""
    T = 2.3
    e_ex, m2_ex = _exact_4x4(T)
    m = Ising((4, 4), temperatures=np.array([T], np.float32), seed=11,
              device="cpu")
    m.sample(4000, warmup_ratio=0.25, cluster_update_interval=1,
             cluster_mode=mode)
    assert abs(m.energies_avg[0] - e_ex) < 0.05
    assert abs(m.mags2[0] - m2_ex) < 0.06


def test_z_test_sw_pt_against_jax_engine():
    """Batch means of <E> and <m^2> per temperature from 8 consecutive
    sample() calls on each engine (16x16, 4 temps around T_c, SW every
    sweep, PT): |z| < 4."""
    temps = np.array([2.0, 2.2, 2.4, 2.7], np.float32)
    kw = dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1,
              warmup_ratio=0)
    n_batches, n_sweeps = 8, 150
    stats = {}
    for name, model in (
        ("jax", RefIsing((16, 16), temperatures=temps, seed=21)),
        ("port", Ising((16, 16), temperatures=temps, seed=22, device="cpu")),
    ):
        model.sample(100, **kw)  # burn-in
        e, m2 = [], []
        for _ in range(n_batches):
            model.sample(n_sweeps, **kw)
            e.append(model.energies_avg)
            m2.append(model.mags2)
        stats[name] = (np.array(e), np.array(m2))
    for k, label in enumerate(("E", "m2")):
        a, b = stats["jax"][k], stats["port"][k]
        se = np.sqrt(a.var(0, ddof=1) / n_batches + b.var(0, ddof=1) / n_batches)
        z = (a.mean(0) - b.mean(0)) / se
        assert (np.abs(z) < 4).all(), (label, z)


@pytest.mark.parametrize("mode", ["sw", "wolff"])
def test_collected_cluster_sizes_account_for_every_site(mode):
    """Each recorded update's histogram covers the n_spins sites of every
    system at that temperature: sum_s s * hist[s] = n_spins per update."""
    temps = np.array([2.0, 2.5, 3.0], np.float32)
    sim = IsingSimulation([8, 8], np.ones((2, 8, 8, 2), np.float32), temps, 1,
                          None, 4, default_chunk=7, device="cpu")
    n_sweeps, interval = 24, 3
    r = sim.sample(n_sweeps, "gibbs", cluster_update_interval=interval,
                   cluster_mode=mode, collect_cluster_stats=True,
                   pt_interval=2, warmup_ratio=0.25)
    csd = r["fk_csd"]
    assert len(csd) == len(temps)
    recorded = sum(1 for s in range(6, n_sweeps) if s % interval == 0)
    for h in csd:
        assert h.dtype == np.uint64 and h.shape == (65,)
        # 2 realizations x one system per temperature per recorded update
        assert int((np.arange(65) * h).sum()) == 2 * recorded * 64
    # no statistics unless asked for
    r2 = sim.sample(8, "gibbs", cluster_update_interval=1, cluster_mode=mode)
    assert "fk_csd" not in r2


def test_cluster_chunk_invariance():
    """Chunks of 5 sweeps and one chunk of 24 run the same trajectory: the
    keys, the FK sweeps (interval 3) and the PT events follow the sweep
    index, not the chunk."""
    kw = dict(cluster_update_interval=3, cluster_mode="sw", pt_interval=2,
              pt_schedule="full_ladder", warmup_ratio=0)
    coup = np.ones((2, 8, 8, 2), np.float32)
    temps = np.geomspace(1.8, 3.2, 3).astype(np.float32)
    a = IsingSimulation([8, 8], coup, temps, 1, None, 3, default_chunk=24,
                        device="cpu")
    b = IsingSimulation([8, 8], coup, temps, 1, None, 3, default_chunk=5,
                        device="cpu")
    ra = a.sample(24, "metropolis", **kw)
    rb = b.sample(24, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_trip_state"):
        assert torch.equal(a.state[key], b.state[key]), key
    for key in ("mags2", "energies"):
        np.testing.assert_allclose(ra[key], rb[key], rtol=1e-12)


@pytest.mark.parametrize("mode", ["sw", "wolff"])
def test_results_schema_matches_reference(mode):
    temps = np.geomspace(1.8, 3.2, 3).astype(np.float32)
    kw = dict(cluster_update_interval=2, cluster_mode=mode, pt_interval=1,
              collect_cluster_stats=True)
    ref = RefIsing((8, 8), temperatures=temps, seed=4)
    port = Ising((8, 8), temperatures=temps, seed=4, device="cpu")
    r_ref, r_port = ref.sample(16, **kw), port.sample(16, **kw)
    assert _schema(r_port) == _schema(r_ref)
    for attr in ("binder_cumulant", "heat_capacity", "fk_csd",
                 "mean_cluster_size"):
        assert np.shape(getattr(port, attr)) == np.shape(getattr(ref, attr))
    assert _schema(port.sample(8, cluster_update_interval=1)) == _schema(
        ref.sample(8, cluster_update_interval=1))
