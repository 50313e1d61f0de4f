"""The overlap moves' physics off the square and cubic lattices: exact
enumeration of a 4x4 triangular +-J glass with R = 2 under each move, and a
z-test against the JAX engine (its staged jnp path) on a small FCC glass
with ``jorg+cmr``.
"""

import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu_torch import Ising
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]


def _tri_glass_exact(J, T):
    """Exact <e> per spin and <q^2> = sum_ij <s_i s_j>^2 / N^2 of a 4x4
    triangular +-J glass (forward couplings J [16, 3])."""
    n = 16
    states = ((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1
    idx = np.arange(n).reshape(4, 4)
    fwd = np.stack([np.roll(idx, (-o[0], -o[1]), (0, 1)) for o in TRI], -1).reshape(n, 3)
    E = sum((states * states[:, fwd[:, k]] * J[:, k]).sum(1) for k in range(3))
    E = E.astype(np.float64)
    w = np.exp((E - E.max()) / T)
    w /= w.sum()
    corr = (states.T * w) @ states
    return (E * w).sum() / n, (corr**2).sum() / n**2


@pytest.mark.parametrize("build,mode", [("houdayer", "wolff"), ("jorg", "sw"),
                                        ("cmr", "wolff")])
def test_4x4_triangular_glass_exact(build, mode):
    """8 copies of one 4x4 triangular +-J glass, R = 2, the move and PT
    every sweep, 1200 sweeps: <e> within 0.03 and <q^2> within 0.05 of exact
    enumeration at each of three temperatures."""
    rng = np.random.default_rng(21)
    J = rng.choice([-1.0, 1.0], size=(4, 4, 3)).astype(np.float32)
    temps = np.array([1.0, 1.6, 2.6], np.float32)
    m = IsingSimulation([4, 4], np.broadcast_to(J, (8, 4, 4, 3)).copy(), temps, 2, TRI,
                        17, device="cpu")
    r = m.sample(1200, "metropolis", pt_interval=1, overlap_cluster_update_interval=1,
                 overlap_cluster_build_mode=build, overlap_cluster_mode=mode,
                 warmup_ratio=0.1)
    for i, t in enumerate(temps):
        e, q2 = _tri_glass_exact(J.reshape(16, 3), float(t))
        assert abs(r["energies"][i] - e) < 0.03, (t, r["energies"][i], e)
        assert abs(r["overlap2"][i] - q2) < 0.05, (t, r["overlap2"][i], q2)


def test_z_test_fcc_glass_jorg_cmr_against_jax_engine():
    """Batch means of <E>, <m^2> and <q^2> per temperature from 6
    consecutive sample() calls on each engine (one 4^3 FCC +-J glass, R = 2,
    jorg+cmr SW every sweep and PT; the reference's staged jnp path): |z|
    < 4."""
    temps = np.array([2.0, 3.0, 4.5], np.float32)
    kw = dict(pt_interval=1, overlap_cluster_update_interval=1,
              overlap_cluster_build_mode="jorg+cmr", overlap_cluster_mode="sw",
              warmup_ratio=0)
    J = np.random.default_rng(60).choice([-1.0, 1.0], size=(4, 4, 4, 6)).astype(np.float32)
    stats = {}
    for name, make in (("jax", RefIsing), ("port", Ising)):
        extra = {} if name == "jax" else dict(device="cpu")
        model = make((4, 4, 4), geometry="fcc", couplings=J, temperatures=temps,
                     n_replicas=2, seed=61 if name == "jax" else 62, **extra)
        model.sample(40, **kw)  # burn-in
        rows = []
        for _ in range(6):
            r = model.sample(60, **kw)
            rows.append((r["energies"], r["mags2"], r["overlap2"]))
        stats[name] = np.array(rows)  # [6, 3, T]
    for k, label in enumerate(("E", "m2", "q2")):
        a, b = stats["jax"][:, k], stats["port"][:, k]
        se = np.sqrt(a.var(0, ddof=1) / 6 + b.var(0, ddof=1) / 6)
        z = (a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)
        assert (np.abs(z) < 4).all(), (label, z)
