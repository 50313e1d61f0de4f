"""Autocorrelation times and the equilibration diagnostic on the port's
paths, on the CPU.

* The port's ``utils/autocorr.py`` is bitwise the JAX package's on seeded
  series: ring and fft, uneven blocks, degenerate series, the Sokal window
  and the lag clamp.
* The device fold (``engine/loop.py`` ``_fold_series``) against an
  ``AutocorrStream`` fed the same series and a numpy model of the
  equilibration sums: chunk splits, warmup ending mid-chunk, a lag longer
  than the recorded series; 1e-12 relative.
* On each runner (mega, replica pairs, per-sweep SW, space in 2 CPU bands)
  the ring backend's taus equal the fft backend's to 1e-10, and the fold
  leaves the run alone: the state is bitwise the run without the options.
* Chunk length changes no tau or ``equil_*`` value beyond 1e-12; the
  sweep-128 checkpoint is the 128-sweep run's last (the twin of
  ``tests/test_autocorr.py``'s prefix test); without warmup the last
  ``equil_energy_avg`` is ``energies``.
* Against the JAX engine (8x8, 4 temperatures, 10 ``reset(seed)`` +
  ``sample`` runs each): two-sample z-tests of the sweep-128
  ``equil_energy_avg`` and of ``mags2_tau``, |z| < 4.
"""

import contextlib

import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu.utils import autocorr as ref_ac
from peapods_tpu_torch import Ising, IsingSimulation
from peapods_tpu_torch.engine import convert, loop, simulation
from peapods_tpu_torch.engine.config import SimConfig
from peapods_tpu_torch.parallel.mesh import make_mesh
from peapods_tpu_torch.utils import autocorr as port_ac

torch.set_num_threads(1)

TEMPS = np.geomspace(1.8, 3.2, 4).astype(np.float32)
OPTS = dict(autocorrelation_max_lag=16, equilibration_diagnostic=True)
SERIES_KEYS = ("mags2_tau", "overlap2_tau", "equil_energy_avg", "equil_link_overlap_avg")


# ------------------------------------------------------------ the module


def _series(seed, n, f):
    rng = np.random.default_rng(seed)
    # an AR(1) series, so that the lagged products carry a signal
    x = np.zeros((n, f))
    for t in range(1, n):
        x[t] = 0.8 * x[t - 1] + rng.standard_normal(f)
    return x + 1.5


@pytest.mark.parametrize("backend", ["ring", "fft"])
@pytest.mark.parametrize("splits", [[], [5, 12, 30], [1, 2, 3, 50]],
                         ids=["whole", "uneven", "short"])
def test_autocorr_module_bitwise(backend, splits):
    series = _series(7, 61, 3)
    streams = [mod.AutocorrStream(9, 3, backend) for mod in (ref_ac, port_ac)]
    for s in streams:
        for block in np.array_split(series, splits):
            s.push_block(block)
    ref, port = streams
    np.testing.assert_array_equal(port.gamma(), ref.gamma())
    np.testing.assert_array_equal(port.taus(), ref.taus())
    np.testing.assert_array_equal(port.sum_o, ref.sum_o)
    assert port.n_recorded == ref.n_recorded


@pytest.mark.parametrize("backend", ["ring", "fft"])
def test_autocorr_module_degenerate(backend):
    for push in ([], [np.full((8, 1), 3.5)], [np.zeros((0, 1))], [np.ones((2, 1))]):
        ref, port = (mod.AutocorrStream(4, 1, backend) for mod in (ref_ac, port_ac))
        for block in push:
            ref.push_block(block)
            port.push_block(block)
        np.testing.assert_array_equal(port.gamma(), ref.gamma())
        np.testing.assert_array_equal(port.taus(), ref.taus())
    gamma = np.exp(-np.arange(100) / 5.0)
    assert port_ac.sokal_tau(gamma) == ref_ac.sokal_tau(gamma)
    for lag, n in ((1000, 100), (10, 100), (1000, 0), (7, 3)):
        assert port_ac.clamp_max_lag(lag, n) == ref_ac.clamp_max_lag(lag, n)


# ---------------------------------------------------------- the device fold


def _fold_runtime(n_replicas):
    sim = IsingSimulation([4, 4], np.ones((2, 4, 4, 2), np.float32), TEMPS[:3],
                          n_replicas, None, 1, device="cpu")
    return sim.rt


def _model_series(rt, e, m, qs, ql):
    """numpy model of the series: f32 values [4, d, n, T]."""
    d, n = e.shape[:2]
    R, T = rt.n_replicas, rt.n_temps
    m2 = ((m.reshape(d, n, R, T) / rt.n_spins) ** 2).sum(2) / R
    em = e.reshape(d, n, R, T).astype(np.float64).sum(2) / R
    if qs is None:
        q2 = ql_m = np.zeros_like(m2)
    else:
        P = rt.n_pairs
        q2 = ((qs.reshape(d, n, P, T) / rt.n_spins) ** 2).sum(2) / P
        ql_m = (ql.reshape(d, n, P, T) / (rt.n_spins * 2)).sum(2) / P
    return np.stack([m2, q2, em, ql_m]).astype(np.float32)


@pytest.mark.parametrize("n_replicas", [1, 2])
@pytest.mark.parametrize("chunks,warmup,lag,declared", [
    ([300], 0, 16, 300),
    ([5, 64, 7, 224], 37, 16, 300),  # warmup ending mid-chunk
    # a run stopped early: a lag of 60 over the 40 recorded sweeps
    ([130, 170], 260, 60, 100000),
    ([1] * 20 + [280], 150, 33, 300),
], ids=["one", "warmup-mid", "lag-long", "singles"])
def test_fold_matches_stream(n_replicas, chunks, warmup, lag, declared):
    rt = _fold_runtime(n_replicas)
    n = sum(chunks)
    d, S, P, T = rt.n_disorder, rt.n_systems, rt.n_pairs, rt.n_temps
    rng = np.random.default_rng(n_replicas * 100 + warmup)
    e = rng.standard_normal((d, n, S)).astype(np.float32)
    m = rng.integers(-16, 17, (d, n, S)).astype(np.int32)
    qs = ql = None
    if P:
        qs = rng.integers(-16, 17, (d, n, P * T)).astype(np.int32)
        ql = rng.integers(-32, 33, (d, n, P * T)).astype(np.int32)
    cfg = SimConfig(n_sweeps=declared, warmup_sweeps=warmup,
                    autocorrelation_max_lag=lag, equilibration_diagnostic=True)
    acc = loop.init_accumulators(rt, cfg)
    state = {"warmup": np.int32(warmup)}
    s = 0
    for k in chunks:
        pair = None if qs is None else tuple(torch.from_numpy(x[:, s:s + k])
                                             for x in (qs, ql))
        loop._fold_series(rt, state, acc, torch.from_numpy(e[:, s:s + k]),
                          torch.from_numpy(m[:, s:s + k]), pair, s, k)
        s += k
    vals = _model_series(rt, e, m, qs, ql)
    eff = port_ac.clamp_max_lag(lag, declared - warmup)
    assert (eff == 60) == (declared > n)
    c = 2 if P else 1
    stream = port_ac.AutocorrStream(eff, c * d * T, "ring")
    stream.push_block(vals[:c, :, warmup:].transpose(2, 0, 1, 3).reshape(n - warmup, -1))
    for key, want in (("ac_sum_prod", stream._sum_prod), ("ac_sum", stream.sum_o),
                      ("ac_sum2", stream.sum_o2)):
        np.testing.assert_allclose(acc[key].numpy(), want, rtol=1e-12, atol=0,
                                   err_msg=key)
    assert acc["ac_count"] == stream.n_recorded == n - warmup
    # the equilibration sums over every sweep and the means at 128, 256
    run = np.cumsum(vals[2:].astype(np.float64), axis=2)  # [2, d, n, T]
    np.testing.assert_allclose(acc["eq_sum"].numpy(), run[:, :, -1].transpose(1, 0, 2),
                               rtol=1e-12)
    for j, count in enumerate((128, 256)):
        np.testing.assert_allclose(
            acc["eq_ckpt"][j].numpy(),
            run[:, :, count - 1].transpose(1, 0, 2) / count, rtol=1e-12)
    assert not acc["eq_ckpt"][2:].any()


def test_fold_bounds_its_temporaries(monkeypatch):
    """The lag range is split so that a window product stays under
    ``FOLD_BYTES``: the sums are the same."""
    rt = _fold_runtime(2)
    rng = np.random.default_rng(3)
    d, S, n = rt.n_disorder, rt.n_systems, 90
    e = torch.from_numpy(rng.standard_normal((d, n, S)).astype(np.float32))
    m = torch.from_numpy(rng.integers(-16, 17, (d, n, S)).astype(np.int32))
    pair = tuple(torch.from_numpy(rng.integers(-16, 17, (d, n, rt.n_temps))
                                  .astype(np.int32)) for _ in range(2))
    cfg = SimConfig(n_sweeps=n, autocorrelation_max_lag=20)
    sums = []
    for limit in (loop.FOLD_BYTES, 8 * 2 * d * rt.n_temps * 30 * 3):
        monkeypatch.setattr(loop, "FOLD_BYTES", limit)
        acc = loop.init_accumulators(rt, cfg)
        for s in (0, 30, 60):
            loop._fold_series(rt, {"warmup": 0}, acc, e[:, s:s + 30], m[:, s:s + 30],
                              tuple(x[:, s:s + 30] for x in pair), s, 30)
        sums.append(acc["ac_sum_prod"])
    np.testing.assert_allclose(sums[1].numpy(), sums[0].numpy(), rtol=1e-14)


# ------------------------------------------------------------- the runners


@contextlib.contextmanager
def per_sweep_path():
    old = simulation.run_chunk
    simulation.run_chunk = loop.run_chunk_sweeps
    try:
        yield
    finally:
        simulation.run_chunk = old


def _runner(name):
    coup = np.ones((8, 8, 2), np.float32)
    if name == "mega":
        return IsingSimulation([8, 8], coup, TEMPS, 1, None, 3, device="cpu"), {}
    if name == "pairs":
        j = np.random.default_rng(1).choice([-1.0, 1.0], (8, 8, 2)).astype(np.float32)
        return (IsingSimulation([8, 8], j, TEMPS, 2, None, 3, device="cpu"),
                dict(overlap_cluster_update_interval=3))
    if name == "sweeps":
        return (IsingSimulation([8, 8], coup, TEMPS, 1, None, 3, device="cpu"),
                dict(cluster_update_interval=1))
    mesh = make_mesh(2, ("space",), devices=["cpu"] * 2)
    return (IsingSimulation([8, 8], coup, TEMPS, 1, None, 3, mesh=mesh, device="cpu"),
            dict(cluster_update_interval=2))


@pytest.mark.parametrize("name", ["mega", "pairs", "sweeps", "space"])
def test_ring_equals_fft_on_each_runner(name):
    sim, kw = _runner(name)
    kw = dict(kw, pt_interval=1, warmup_ratio=0.3)
    n = 40 if name == "space" else 130  # the space path's CPU sweeps are slow
    runs = {}
    for backend in ("ring", "fft", None):
        sim.reset(9)
        opts = {} if backend is None else dict(OPTS, autocorrelation_backend=backend)
        runs[backend] = (sim.sample(n, "metropolis", **kw, **opts),
                         convert.to_reference({**sim.state, "spins": sim.all_spins()}))
    (ring, s_ring), (fft, s_fft), (off, s_off) = runs["ring"], runs["fft"], runs[None]
    for k in s_off:  # the fold writes no state and draws nothing
        np.testing.assert_array_equal(s_ring[k], s_off[k], err_msg=k)
        np.testing.assert_array_equal(s_fft[k], s_off[k], err_msg=k)
    for k in off:
        if k != "per_disorder":
            np.testing.assert_array_equal(ring[k], off[k], err_msg=k)
    taus = [k for k in ("mags2_tau", "overlap2_tau") if k in ring]
    assert taus == (["mags2_tau", "overlap2_tau"] if name == "pairs" else ["mags2_tau"])
    for k in taus:
        assert np.isfinite(ring[k]).all()
        np.testing.assert_allclose(ring[k], fft[k], rtol=0, atol=1e-10, err_msg=k)
    for k in ("equil_sweeps", "equil_energy_avg", "equil_link_overlap_avg"):
        np.testing.assert_array_equal(ring[k], fft[k], err_msg=k)
    np.testing.assert_array_equal(ring["equil_sweeps"], [n] if n < 128 else [128, n])
    assert (ring["equil_link_overlap_avg"] == 0).all() == (name != "pairs")


@pytest.mark.parametrize("name", ["mega", "pairs"])
def test_chunk_length_changes_nothing(name):
    out = []
    for chunk in (5, 64):
        sim, kw = _runner(name)
        sim.default_chunk = chunk
        out.append(sim.sample(160, "metropolis", pt_interval=1, warmup_ratio=0.2,
                              **kw, **OPTS))
    a, b = out
    for k in SERIES_KEYS:
        if k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=0, err_msg=k)
    np.testing.assert_array_equal(a["equil_sweeps"], [128, 160])


def test_space_series_equal_unsharded():
    mesh = make_mesh(2, ("space",), devices=["cpu"] * 2)
    coup = np.ones((8, 8, 2), np.float32)
    out = []
    for m, path in ((mesh, contextlib.nullcontext), (None, per_sweep_path)):
        sim = IsingSimulation([8, 8], coup, TEMPS, 1, None, 3, mesh=m, device="cpu")
        with path():
            out.append(sim.sample(40, "metropolis", pt_interval=1, **OPTS,
                                  cluster_update_interval=2))
    for k in ("mags2_tau", "equil_energy_avg", "equil_sweeps"):
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)


def test_equil_checkpoint_prefix_consistency():
    """Twin of tests/test_autocorr.py's prefix test: a 256-sweep run's
    first checkpoint (sweep 128) equals a 128-sweep run's last on the same
    trajectory."""

    def run(n):
        m = Ising((8, 8), couplings="bimodal", temperatures=np.array([1.5, 2.5], np.float32),
                  n_replicas=2, seed=11, device="cpu")
        return m.sample(n, "metropolis", pt_interval=1, equilibration_diagnostic=True,
                        warmup_ratio=0)

    r256, r128 = run(256), run(128)
    np.testing.assert_array_equal(r256["equil_sweeps"], [128, 256])
    np.testing.assert_array_equal(r128["equil_sweeps"], [128])
    for k in ("equil_energy_avg", "equil_link_overlap_avg"):
        np.testing.assert_allclose(r256[k][0], r128[k][0], rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("n_replicas", [1, 2])
def test_no_warmup_last_equil_is_energies(n_replicas):
    m = Ising((8, 8), couplings="bimodal", temperatures=TEMPS, n_replicas=n_replicas,
              seed=2, device="cpu")
    r = m.sample(200, pt_interval=1, warmup_ratio=0, equilibration_diagnostic=True)
    np.testing.assert_allclose(r["equil_energy_avg"][-1], r["energies"], rtol=1e-12)
    if n_replicas > 1:
        np.testing.assert_allclose(r["equil_link_overlap_avg"][-1], r["link_overlap"],
                                   rtol=1e-12)
    sweeps, delta = m.equilibration_delta()
    np.testing.assert_array_equal(sweeps, [128, 200])
    assert delta.shape == (2, len(TEMPS)) and np.isfinite(delta).all()


# --------------------------------------------------------- the JAX engine


def test_z_test_against_jax_engine():
    """Sweep-128 ``equil_energy_avg`` (from random spins: the approach to
    equilibrium) and ``mags2_tau`` (lag 16, 300 sweeps) over 10
    ``reset(seed)`` + ``sample`` runs of each engine: |z| < 4."""
    n_runs = 10
    kw = dict(pt_interval=1, warmup_ratio=0.25, autocorrelation_max_lag=16,
              equilibration_diagnostic=True)
    stats = {}
    for name, model in (("jax", RefIsing((8, 8), temperatures=TEMPS, seed=21)),
                        ("port", Ising((8, 8), temperatures=TEMPS, seed=21, device="cpu"))):
        e128, tau = [], []
        for i in range(n_runs):
            model.reset(1000 + i + (0 if name == "jax" else 500))
            r = model.sample(300, **kw)
            e128.append(r["equil_energy_avg"][0])
            tau.append(r["mags2_tau"])
        stats[name] = (np.array(e128), np.array(tau))
    for k, label in enumerate(("equil_energy_avg@128", "mags2_tau")):
        a, b = stats["jax"][k], stats["port"][k]
        se = np.sqrt(a.var(0, ddof=1) / n_runs + b.var(0, ddof=1) / n_runs)
        z = (a.mean(0) - b.mean(0)) / se
        assert (np.abs(z) < 4).all(), (label, z)
