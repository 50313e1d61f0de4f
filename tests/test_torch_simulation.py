"""The port's whole slice on the CPU: schema, physics and bookkeeping.

``Ising(..., device="cpu")`` runs the plain torch versions of the mega
path's kernels.  Its results dict must have the reference's keys, shapes and
dtypes; its equilibrium must match exact enumeration (the oracles and
tolerances of tests/test_exact_equilibrium.py) and, statistically, the JAX
engine; chunking must not change a trajectory; and the PT bookkeeping must
keep its invariants (tests/test_mega.py).
"""

import jax
import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu_torch import Ising, IsingSimulation
from peapods_tpu_torch.engine import convert

torch.set_num_threads(1)

TEMPS8 = np.geomspace(1.8, 3.2, 4).astype(np.float32)


def enumerate_2x2x4():
    """4x4 ferromagnet exact enumeration (tests/test_exact_equilibrium.py):
    (E, M) over all states, E the positive forward-bond sum."""
    n = 16
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    idx = np.arange(16).reshape(4, 4)
    bi, bj = [], []
    for i in range(4):
        for j in range(4):
            bi += [idx[i, j], idx[i, j]]
            bj += [idx[(i + 1) % 4, j], idx[i, (j + 1) % 4]]
    E = (states[:, bi] * states[:, bj]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    return E, M


def exact_em(E, M, T, n=16):
    w = np.exp(E / T - E.max() / T)
    z = w.sum()
    return (E * w).sum() / z / n, ((M / n) ** 2 * w).sum() / z


def _schema(x):
    if isinstance(x, dict):
        return {k: _schema(v) for k, v in x.items()}
    return (np.asarray(x).shape, np.asarray(x).dtype)


@pytest.mark.parametrize("pt_schedule", ["single_random_edge", "full_ladder"])
def test_results_schema_matches_reference(pt_schedule):
    kw = dict(pt_interval=1, pt_schedule=pt_schedule)
    ref = RefIsing((8, 8), temperatures=TEMPS8, seed=4)
    port = Ising((8, 8), temperatures=TEMPS8, seed=4, device="cpu")
    r_ref = ref.sample(16, **kw)
    r_port = port.sample(16, **kw)
    assert _schema(r_port) == _schema(r_ref)
    for attr in ("binder_cumulant", "heat_capacity", "energies_avg", "mags2"):
        assert np.shape(getattr(port, attr)) == np.shape(getattr(ref, attr))
    # no PT: no per_disorder entry, as in the reference
    assert _schema(port.sample(8)) == _schema(ref.sample(8))


@pytest.mark.parametrize("mode", ["metropolis", "gibbs"])
def test_4x4_exact(mode):
    E, M = enumerate_2x2x4()
    T = 2.3
    e_ex, m2_ex = exact_em(E, M, T)
    m = Ising((4, 4), temperatures=np.array([T], dtype=np.float32), seed=11,
              device="cpu")
    m.sample(8000, sweep_mode=mode, warmup_ratio=0.25)
    assert abs(m.energies_avg[0] - e_ex) < 0.05
    assert abs(m.mags2[0] - m2_ex) < 0.06


def test_pt_each_temperature_reaches_equilibrium():
    E, M = enumerate_2x2x4()
    temps = np.array([2.0, 3.0], dtype=np.float32)
    m = Ising((4, 4), temperatures=temps, n_replicas=1, seed=13, device="cpu")
    m.sample(8000, pt_interval=1, warmup_ratio=0.25)
    for i, T in enumerate(temps):
        e_ex, m2_ex = exact_em(E, M, float(T))
        assert abs(m.energies_avg[i] - e_ex) < 0.05
        assert abs(m.mags2[i] - m2_ex) < 0.06


def test_z_test_against_jax_engine():
    """Batch means of <E> and <m^2> per temperature from 10 consecutive
    sample() calls on each engine (8x8, 4 temps, PT): |z| < 4."""
    n_batches, n_sweeps = 10, 300
    stats = {}
    for name, model in (
        ("jax", RefIsing((8, 8), temperatures=TEMPS8, seed=21)),
        ("port", Ising((8, 8), temperatures=TEMPS8, seed=22, device="cpu")),
    ):
        model.sample(200, pt_interval=1, warmup_ratio=0)  # burn-in
        e, m2 = [], []
        for _ in range(n_batches):
            model.sample(n_sweeps, pt_interval=1, warmup_ratio=0)
            e.append(model.energies_avg)
            m2.append(model.mags2)
        stats[name] = (np.array(e), np.array(m2))
    for k, label in enumerate(("E", "m2")):
        a, b = stats["jax"][k], stats["port"][k]
        se = np.sqrt(a.var(0, ddof=1) / n_batches + b.var(0, ddof=1) / n_batches)
        z = (a.mean(0) - b.mean(0)) / se
        assert (np.abs(z) < 4).all(), (label, z)


def _state_np(sim):
    return convert.to_reference(sim.state)


def test_chunk_invariance():
    a = IsingSimulation([8, 8], np.ones((8, 8, 2), np.float32), TEMPS8, 1, None,
                        3, default_chunk=32, device="cpu")
    ra = a.sample(32, "metropolis", pt_interval=1, warmup_ratio=0)
    b = IsingSimulation([8, 8], np.ones((8, 8, 2), np.float32), TEMPS8, 1, None,
                        3, default_chunk=5, device="cpu")
    rb1 = b.sample(16, "metropolis", pt_interval=1, warmup_ratio=0)
    rb2 = b.sample(16, "metropolis", pt_interval=1, warmup_ratio=0)
    sa, sb = _state_np(a), _state_np(b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    np.testing.assert_allclose(ra["mags2"], (rb1["mags2"] + rb2["mags2"]) / 2,
                               rtol=1e-12)


def test_pt_bookkeeping_invariants():
    sim = IsingSimulation([8, 8], np.ones((8, 8, 2), np.float32), TEMPS8, 1,
                          None, 5, default_chunk=16, device="cpu")
    n_sweeps = 40
    r = sim.sample(n_sweeps, "metropolis", pt_interval=1, warmup_ratio=0)
    pt = r["per_disorder"]["parallel_tempering"]
    assert pt["edge_attempts"].sum() == n_sweeps
    assert (pt["edge_acceptances"] <= pt["edge_attempts"]).all()
    sid = sim.state["system_ids"].numpy().reshape(-1)
    assert sorted(sid.tolist()) == list(range(4))
    r2 = sim.sample(n_sweeps, "metropolis", pt_interval=1, warmup_ratio=0)
    assert r2["per_disorder"]["parallel_tempering"]["edge_attempts"].sum() == (
        2 * n_sweeps
    )

    full = IsingSimulation([8, 8], np.ones((8, 8, 2), np.float32),
                           np.geomspace(1.8, 3.2, 5), 1, None, 6, device="cpu")
    r = full.sample(12, "metropolis", pt_interval=1, pt_schedule="full_ladder",
                    warmup_ratio=0)
    np.testing.assert_array_equal(
        r["per_disorder"]["parallel_tempering"]["edge_attempts"][0],
        np.full(4, 12, np.uint64),
    )


def test_state_converts_both_ways():
    coup = np.ones((2, 4, 6, 2), np.float32)
    temps = np.geomspace(1.8, 3.2, 3).astype(np.float32)
    ref = RefSimulation([4, 6], coup, temps, 1, None, 8, mesh=None)
    ref.sample(5, "metropolis", pt_interval=1)
    ref_np = {k: np.asarray(v) for k, v in ref.state.items() if k != "base_keys"}
    ref_np["base_keys"] = np.asarray(jax.random.key_data(ref.state["base_keys"]))
    port = IsingSimulation([4, 6], coup, temps, 1, None, 8, device="cpu")
    port.state = convert.from_reference(ref_np, "cpu")
    back = convert.to_reference(port.state)
    assert set(back) == set(ref_np)
    for k in ref_np:
        np.testing.assert_array_equal(back[k], ref_np[k], err_msg=k)
    port.sample(4, "metropolis", pt_interval=1)  # runs on the converted state
    assert int(port.state["counter"]) == int(ref_np["counter"]) + 4


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(cluster_update_interval=1, cluster_action="observe"),
        dict(overlap_cluster_update_interval=1),
        dict(autocorrelation_max_lag=4),
        dict(equilibration_diagnostic=True),
    ],
    ids=["cluster", "overlap", "autocorrelation", "equilibration"],
)
def test_out_of_slice_sample_options_raise(kwargs):
    m = Ising((4, 4), temperatures=[2.0], seed=1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        m.sample(4, **kwargs)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(lattice_shape=(4, 4, 4)),
        dict(lattice_shape=(5, 4)),
        dict(lattice_shape=(4, 4), n_replicas=2),
        dict(lattice_shape=(4, 4), geometry="tri"),
    ],
    ids=["3d", "odd", "replicas", "geometry"],
)
def test_out_of_slice_models_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Ising(temperatures=[2.0], seed=1, device="cpu", **kwargs)


def test_out_of_slice_engine_options_raise(tmp_path):
    coup = np.ones((4, 4, 2), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        IsingSimulation([4, 4], coup, [2.0], mesh=object(), device="cpu")
    sim = IsingSimulation([4, 4], coup, [2.0], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sim.save_checkpoint(tmp_path / "ck.npz")


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ising((4, 4), temperatures=[2.0], seed=1)  # device="cuda" by default
