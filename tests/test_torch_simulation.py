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


@pytest.mark.parametrize("options", [{}, dict(autocorrelation_max_lag=8,
                                               equilibration_diagnostic=True)],
                         ids=["plain", "4b"])
@pytest.mark.parametrize("pt_schedule", ["single_random_edge", "full_ladder"])
def test_results_schema_matches_reference(pt_schedule, options):
    """The keys, shapes and dtypes of the reference's results dict; with
    both 4b options on, the taus and ``equil_*`` too (and ``overlap2_tau``
    with replicas, on the fft backend)."""
    kw = dict(pt_interval=1, pt_schedule=pt_schedule, **options)
    ref = RefIsing((8, 8), temperatures=TEMPS8, seed=4)
    port = Ising((8, 8), temperatures=TEMPS8, seed=4, device="cpu")
    n = 130 if options else 16  # past the first equilibration checkpoint
    r_ref = ref.sample(n, **kw)
    r_port = port.sample(n, **kw)
    assert _schema(r_port) == _schema(r_ref)
    for attr in ("binder_cumulant", "heat_capacity", "energies_avg", "mags2",
                 *(("mags2_tau", "_equil_sweeps", "_equil_energy_avg") if options else ())):
        assert np.shape(getattr(port, attr)) == np.shape(getattr(ref, attr))
    if options:
        assert [np.shape(x) for x in port.equilibration_delta()] == [
            np.shape(x) for x in ref.equilibration_delta()]
        if pt_schedule == "full_ladder":
            return
        kw.update(autocorrelation_backend="fft", warmup_ratio=0.5)
        ref = RefIsing((4, 4), temperatures=TEMPS8, n_replicas=2, seed=4)
        port = Ising((4, 4), temperatures=TEMPS8, n_replicas=2, seed=4, device="cpu")
        assert _schema(port.sample(n, **kw)) == _schema(ref.sample(n, **kw))
        return
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
        dict(overlap_cluster_update_interval=1, snapshot_interval=1),
        dict(autocorrelation_max_lag=4),
        dict(equilibration_diagnostic=True),
    ],
    ids=["cluster", "overlap", "autocorrelation", "equilibration"],
)
def test_out_of_slice_sample_options_raise(kwargs):
    """Options that once lay outside the slice run: FK observe and
    snapshots with replicas since item 7a (the per-sweep replica path): the
    FK observations, and a snapshot at every sweep past warmup; the
    autocorrelation times and the equilibration diagnostic since item 4b:
    ``mags2_tau`` and ``overlap2_tau``, or the ``equil_*`` curves."""
    m = Ising((4, 4), temperatures=[2.0], n_replicas=2, seed=1, device="cpu")
    r = m.sample(4, warmup_ratio=0.25, **kwargs)
    assert np.asarray(r["overlap_histogram"]).sum() == 3  # recorded sweeps, 1 pair
    observe = kwargs.get("cluster_action") == "observe"
    assert ("fk" in r.get("per_disorder", {}).get("cluster_observations", {})) == observe
    snaps = r.get("cluster_snapshots", [])
    want = [1, 2, 3] if "snapshot_interval" in kwargs else []
    assert [x["sweep_id"] for x in snaps] == want
    for x in snaps:
        assert x["cluster_ids"].shape == (1, 16) and x["spins"].shape == (1, 2, 16)
    tau = "autocorrelation_max_lag" in kwargs
    assert ("mags2_tau" in r, "overlap2_tau" in r) == (tau, tau)
    for k in ("mags2_tau", "overlap2_tau") if tau else ():
        assert r[k].shape == (1,) and r[k].dtype == np.float64 and np.isfinite(r[k]).all()
    equil = bool(kwargs.get("equilibration_diagnostic"))
    assert ("equil_sweeps" in r) == equil
    if equil:
        # one checkpoint, the full run: the means over every sweep
        assert r["equil_sweeps"].tolist() == [4] and r["equil_sweeps"].dtype == np.uint64
        sweeps, delta = m.equilibration_delta()
        assert sweeps.tolist() == [4] and delta.shape == (1, 1)
        assert np.isfinite(delta).all() and (np.abs(r["equil_link_overlap_avg"]) <= 1).all()


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(lattice_shape=(4, 4, 4), geometry="bcc", n_replicas=2), None),
        (dict(lattice_shape=(5, 4), n_replicas=2), None),
        (dict(lattice_shape=(4, 4, 5), n_replicas=2), None),
        (dict(lattice_shape=(4, 4), geometry="tri", n_replicas=2), None),
        (dict(lattice_shape=(2, 2, 2, 2), n_replicas=2), None),
    ],
    ids=["3d", "odd", "replicas", "geometry", "replicas-4d"],
)
def test_out_of_slice_models_raise(kwargs, item):
    """Models outside the slice raise, naming the ROADMAP item; replicas on
    the BCC and triangular lattices run since item 7a, and on odd extents
    and past three dimensions since item 4a, with the pair records over the
    lattice's offsets."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, queue 1, item {item}"):
            Ising(temperatures=[2.0], seed=1, device="cpu", **kwargs)
        return
    m = Ising(temperatures=[2.0], seed=1, device="cpu", **kwargs)
    r = m.sample(4, warmup_ratio=0)
    assert np.asarray(r["overlap_histogram"]).sum() == 4
    assert np.isfinite(r["link_overlap"]).all() and (np.abs(r["link_overlap"]) <= 1).all()


def test_out_of_slice_engine_options_raise(tmp_path):
    """A mesh of another type raises, naming the ROADMAP; checkpoints run
    since item 4c: a saved state reloads bitwise."""
    coup = np.ones((4, 4, 2), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        IsingSimulation([4, 4], coup, [2.0], mesh=object(), device="cpu")
    sim = IsingSimulation([4, 4], coup, [2.0, 3.0], device="cpu")
    sim.sample(5, "metropolis", pt_interval=1)
    sim.save_checkpoint(tmp_path / "ck.npz")
    other = IsingSimulation([4, 4], coup, [2.0, 3.0], device="cpu")
    other.load_checkpoint(tmp_path / "ck.npz")
    a, b = convert.to_reference(sim.state), convert.to_reference(other.state)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Ising((4, 4), temperatures=[2.0], seed=1)  # device="cuda" by default
