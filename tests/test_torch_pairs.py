"""The port's replica path (sweeps, pair measurement, PT on each replica's
ladder), bitwise against the JAX package, and its physics.

The reference's pairs megakernel ``pallas_megapair.megapair_chunk`` runs
here in interpret mode, whose PRNG draws zeros; the port's plain
``pairs_chunk_plain`` gets zero site uniforms.  Every flip decision (3D and
2D), the per-slot (e, m), the pair sums (q, q_l) and the PT step on every
replica's ladder (whose murmur draws come from the real PT words in both)
must then agree bit for bit on +-J couplings, whose sums are exact
integers in f32.  The reference keeps spins by slot and swaps tiles; the
port keeps them by system and swaps ``sid`` entries, so spins are compared
through ``sid``.  The engine tests hold the whole replica path against the
reference's engine under zero uniforms; the physics tests hold it against
exact enumeration (a 4x4 +-J glass) and, by a z-test, against the JAX
engine on a small 3D glass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu.ops import pallas_megapair as pmp
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu.ops.measure import overlap_dots as ref_overlap_dots
from peapods_tpu_torch import Ising
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import megapair, tempering
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.energy import energies_and_mags
from peapods_tpu_torch.ops.measure import overlap_dots
from peapods_tpu_torch.ops.sweep import pack_coupling_grids

torch.set_num_threads(1)


@pytest.fixture
def zero_site_uniforms(monkeypatch):
    monkeypatch.setattr(
        trng, "colour_uniforms",
        lambda words, n, c, shape: torch.zeros(words.shape[:-1] + (n, *shape)))


@pytest.mark.parametrize(
    "shape,n_rep,pt_full,pt_interval,sweep_base",
    [((8, 8, 8), 4, False, 1, 0), ((8, 8, 8), 4, True, 2, 3),
     ((8, 64), 2, True, 1, 0), ((8, 64), 2, False, 3, 1)],
    ids=["8cube-single", "8cube-full-interval2", "2d-full", "2d-single-interval3"],
)
def test_plain_pairs_chunk_matches_megapair_chunk(zero_site_uniforms, shape, n_rep,
                                                  pt_full, pt_interval, sweep_base):
    d, n_temps, n = 2, 3, 4
    nd = len(shape)
    n_sp = int(np.prod(shape))
    s = n_rep * n_temps
    n_edges = n_temps - 1
    rng = np.random.default_rng(n_sp + n_rep + 7 * pt_full)
    lat = RefLattice(list(shape))
    kp, rp = pmp.supports_megapair(lat, n_rep, n_temps)
    temps = np.geomspace(0.9, 2.2, n_temps).astype(np.float32)
    hot, cold = tempering.hot_cold_slots(temps)
    coup = rng.choice([-1.0, 1.0], size=(d, n_sp, nd)).astype(np.float32)
    spins = rng.choice([-1, 1], size=(d, s, n_sp)).astype(np.int8)
    sid = np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)
    ea = rng.integers(0, 5, (d, n_edges)).astype(np.int32)
    ec = np.minimum(ea, rng.integers(0, 5, (d, n_edges))).astype(np.int32)
    rt = rng.integers(0, 3, (d, s)).astype(np.int32)
    ts = rng.integers(0, 3, (d, s)).astype(np.int32)
    parity = int(rng.integers(0, 2))
    words = rng.integers(-2**31, 2**31, (2, n, d, 2)).astype(np.int32)

    l0, block = shape[0], n_sp // shape[0]
    jg = jax.vmap(lambda c: pmp.pack_coupling_grids_mp(c, shape, kp, rp))(
        jnp.asarray(coup))
    out = pmp.megapair_chunk(
        pmp.pack_slots(jnp.asarray(spins), jnp.asarray(sid).reshape(d, n_rep, n_temps),
                       l0, block, kp, rp),
        jg, jnp.asarray(temps)[None],
        jnp.asarray(words[0].transpose(1, 0, 2).reshape(d, -1)),
        jnp.asarray(words[1].transpose(1, 0, 2).reshape(d, -1)),
        jnp.tile(jnp.asarray([[sweep_base, n]], jnp.int32), (d, 1)), jnp.asarray(sid),
        jnp.asarray(ea), jnp.asarray(ec), jnp.asarray(rt), jnp.asarray(ts),
        jnp.full((d, 1), parity, jnp.int32), shape=shape, gibbs=False, n_inner=n,
        n_temps=n_temps, n_replicas=n_rep, kp=kp, rp=rp, pt_interval=pt_interval,
        pt_full=pt_full, hot_slot=hot, cold_slot=cold, interpret=True)
    (tiles, e_r, m_r, qs_r, ql_r, sid_r, ea_r, ec_r, rt_r, ts_r, par_r) = out
    spins_r = pmp.unpack_slots(tiles, sid_r.reshape(d, n_rep, n_temps), l0, block,
                               kp, rp)

    t_coup = torch.from_numpy(coup)
    st = {k: torch.from_numpy(v.copy()) for k, v in
          dict(spins=spins, sid=sid, ea=ea, ec=ec, rt=rt, ts=ts).items()}
    dr = tempering.pt_draws_pairs(torch.from_numpy(words[1]), n_rep, n_edges,
                                  pt_full=pt_full)
    e, m, qs, ql, par = megapair.pairs_chunk(
        st["spins"], pack_coupling_grids(t_coup, shape), t_coup,
        torch.from_numpy(temps), torch.from_numpy(np.tile(temps, n_rep)), st["sid"],
        st["ea"], st["ec"], st["rt"], st["ts"], torch.from_numpy(words[0]),
        dr if pt_full else (dr[0].to(torch.int32), dr[1]), None, shape=shape,
        n_replicas=n_rep, sweep_base=sweep_base, parity=parity, gibbs=False,
        pt_interval=pt_interval, pt_full=pt_full, hot_slot=hot, cold_slot=cold,
        wolff=True)
    np.testing.assert_array_equal(st["spins"].numpy(), np.asarray(spins_r))
    for k, ref in (("sid", sid_r), ("ea", ea_r), ("ec", ec_r), ("rt", rt_r),
                   ("ts", ts_r)):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(ref), err_msg=k)
    assert par == int(np.asarray(par_r)[0, 0])
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_r))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_r))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(qs_r))
    np.testing.assert_array_equal(ql.numpy(), np.asarray(ql_r))
    assert int(st["ec"].sum()) > int(ec.sum())  # some swap was taken


@pytest.mark.parametrize("shape,n_rep", [((6, 4, 8), 4), ((8, 10), 6)])
def test_overlap_dots_matches_reference(shape, n_rep):
    lat = RefLattice(list(shape))
    geom = GridOps.from_lattice(lat)
    n_temps, d = 3, 2
    rng = np.random.default_rng(2)
    spins = rng.choice([-1, 1], size=(d, n_rep * n_temps, lat.n_spins)).astype(np.int8)
    sid = np.stack([rng.permutation(n_rep * n_temps) for _ in range(d)]).astype(np.int32)
    qs, ql = overlap_dots(torch.from_numpy(spins), torch.from_numpy(sid), shape, n_rep)
    for r in range(d):
        ws, wl = ref_overlap_dots(jnp.asarray(spins[r]),
                                  jnp.asarray(sid[r]).reshape(n_rep, n_temps), geom)
        np.testing.assert_array_equal(qs[r].numpy(), np.asarray(ws))
        np.testing.assert_array_equal(ql[r].numpy(), np.asarray(wl))


@pytest.mark.parametrize("n_rep", [2, 4])
@pytest.mark.parametrize("pt_full", [False, True], ids=["single", "full"])
def test_pt_ladders_match_pt_event_jnp(n_rep, pt_full):
    """pt_step_plain on R ladders with the replica path's draws against the
    reference's jnp mirror of the kernel's PT, realization by realization,
    over 12 events."""
    d, n_temps, n_sp = 2, 5, 512
    s = n_rep * n_temps
    rng = np.random.default_rng(n_rep + 5 * pt_full)
    temps = np.geomspace(0.9, 2.2, n_temps).astype(np.float32)
    hot, cold = tempering.hot_cold_slots(temps)
    sid = np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)
    ref = dict(sid=sid.reshape(d, n_rep, n_temps),
               ea=np.zeros((d, n_temps - 1), np.int32),
               ec=np.zeros((d, n_temps - 1), np.int32),
               rt=np.zeros((d, s), np.int32),
               ts=rng.integers(0, 3, (d, s)).astype(np.int32), par=[1] * d)
    port = {k: torch.from_numpy(np.array(v)) for k, v in ref.items() if k != "par"}
    port["sid"] = port["sid"].reshape(d, s)
    parity = 1
    slot_temps = torch.from_numpy(np.tile(temps, n_rep))
    pt_event = jax.jit(pmp.pt_event_jnp, static_argnames=(
        "n_spins", "pt_full", "hot_slot", "cold_slot"))
    for _ in range(12):
        # integer energy sums, as with +-J couplings
        e_tot = rng.integers(-800, -200, (d, s)).astype(np.float32)
        words = rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)
        es = e_tot / np.float32(n_sp)
        for r in range(d):
            es_slot = es[r][ref["sid"][r].reshape(-1)].reshape(n_rep, n_temps)
            out = pt_event(
                jnp.zeros((n_rep, n_temps, 1), jnp.int8), jnp.asarray(es_slot),
                jnp.asarray(ref["sid"][r]), jnp.asarray(temps), jnp.int32(words[r, 0]),
                jnp.int32(words[r, 1]), jnp.asarray(ref["ea"][r]),
                jnp.asarray(ref["ec"][r]), jnp.asarray(ref["rt"][r]),
                jnp.asarray(ref["ts"][r]), jnp.int32(ref["par"][r]), n_spins=n_sp,
                pt_full=pt_full, hot_slot=hot, cold_slot=cold)
            _, _, sid_r, ea_r, ec_r, rt_r, ts_r, par_r = out
            ref["sid"][r], ref["ea"][r], ref["ec"][r] = sid_r, ea_r, ec_r
            ref["rt"][r], ref["ts"][r], ref["par"][r] = rt_r, ts_r, int(par_r)
        dr = tempering.pt_draws_pairs(torch.from_numpy(words), n_rep, n_temps - 1,
                                      pt_full=pt_full)
        parity = megapair.mega.pt_step_plain(
            torch.from_numpy(e_tot)[..., None], torch.zeros((d, s, 1), dtype=torch.int32),
            None, None, port["sid"], port["ea"], port["ec"], port["rt"], port["ts"],
            slot_temps, dr, torch.empty((d, s)), do_pt=True, pt_full=pt_full,
            parity=parity, hot_slot=hot, cold_slot=cold, n_spins=n_sp,
            n_replicas=n_rep)
    np.testing.assert_array_equal(port["sid"].numpy(), ref["sid"].reshape(d, s))
    for k in ("ea", "ec", "rt", "ts"):
        np.testing.assert_array_equal(port[k].numpy(), ref[k], err_msg=k)
    assert parity == ref["par"][0]
    assert 0 < int(port["ec"].sum()) < int(port["ea"].sum())
    att = 12 * n_rep * ((n_temps - 1) if pt_full else 1)
    assert int(port["ea"].sum()) == d * att


def test_permutation_and_task_keys_match_jax():
    """permutation (one sort round for R < 2**10, a second one above, stable
    sorts), the tasks and task keys of an event, and the event scalars and
    probes, bitwise jax.random."""
    from peapods_tpu.ops import pallas_event as pe

    for n in (2, 4, 6, 8, 1500):
        keys = jax.random.split(jax.random.key(n), 6)
        want = np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])
        got = seeds.permutation(np.asarray(jax.random.key_data(keys)), n)
        np.testing.assert_array_equal(got, want)
    base = jax.random.split(jax.random.key(3), 2)  # two realizations
    n_rep, n_temps, ctr = 4, 3, 17
    tasks, tkeys = seeds.overlap_tasks(np.asarray(jax.random.key_data(base)),
                                       [ctr, ctr + 10], n_rep, n_temps)
    for i, c in enumerate((ctr, ctr + 10)):
        for r in range(2):
            key = jax.random.fold_in(jax.random.fold_in(base[r], c), 3)
            k_shuffle, k_tasks = jax.random.split(key)
            perm = jax.vmap(lambda k: jax.random.permutation(k, n_rep))(
                jax.random.split(k_shuffle, n_temps))
            np.testing.assert_array_equal(
                tasks[i, r], np.asarray(perm).reshape(n_temps, n_rep // 2, 2))
            np.testing.assert_array_equal(
                tkeys[i, r],
                np.asarray(jax.random.key_data(jax.random.split(
                    k_tasks, n_temps * (n_rep // 2)))))
    tk = jax.random.split(jax.random.key(8), 9)
    for kind in ("houdayer", "jorg", "cmr"):
        for wolff in (False, True):
            sc, pr = seeds.event_scalars(kind, wolff,
                                         np.asarray(jax.random.key_data(tk)), 512)
            rs, rp = pe.mp_event_scalars(kind, wolff, tk, 512)
            np.testing.assert_array_equal(sc, np.asarray(rs))
            np.testing.assert_array_equal(pr, np.asarray(rp))


def _glass(seed, shape, n_rep, n_temps, chunk=256):
    rng = np.random.default_rng(seed)
    coup = rng.choice(np.float32([-1, 1]), size=tuple(shape) + (len(shape),))
    temps = np.geomspace(0.9, 2.2, n_temps).astype(np.float32)
    return IsingSimulation(list(shape), coup, temps, n_rep, None, seed,
                           default_chunk=chunk, device="cpu")


@pytest.mark.parametrize("shape,n_rep", [((8, 8, 8), 4), ((16, 16, 16), 2),
                                          ((8, 128), 2)])
def test_measurement_identities(shape, n_rep):
    """One recorded sweep, no PT (tests/test_megapair.py:90-125 on the
    port): every record (e, m, q, q_l) equals a recompute from the final
    spins."""
    sim = _glass(5, shape, n_rep, 3)
    r = sim.sample(1, "metropolis", warmup_ratio=0)
    rt = sim.rt
    spins = sim.state["spins"][0]
    sid = sim.state["system_ids"][0].numpy()
    e, m = energies_and_mags(spins, rt.coup[0], shape)
    e_rt = e.numpy()[sid].astype(np.float64)
    m_rt = m.numpy()[sid].astype(np.float64) / rt.n_spins
    np.testing.assert_allclose(r["mags"], m_rt.sum(0) / n_rep, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(r["energies"], e_rt.sum(0) / n_rep, rtol=1e-6)
    qs, ql = overlap_dots(sim.state["spins"], sim.state["system_ids"].view(1, -1),
                          shape, n_rep)
    n_pairs = n_rep // 2
    q = qs[0].numpy().astype(np.float64) / rt.n_spins
    q_l = ql[0].numpy().astype(np.float64) / (rt.n_spins * len(shape))
    np.testing.assert_allclose(r["overlap"], q.sum(0) / n_pairs, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(r["link_overlap"], q_l.sum(0) / n_pairs, rtol=1e-12,
                               atol=1e-15)
    hist = np.asarray(r["overlap_histogram"])
    assert hist.sum() == n_pairs * 3
    for t in range(3):
        for p in range(n_pairs):
            assert hist[t, (int(qs[0, p, t]) + rt.n_spins) // 2] >= 1


def test_chunk_invariance():
    """Chunks of 20 sweeps, or of 7 over two sample() calls, give one
    trajectory: the moves (every 5th sweep of each call), their keys and
    the PT draws follow the sweep index and the counter, not the chunks."""
    kw = dict(pt_interval=1, overlap_cluster_update_interval=5,
              overlap_cluster_build_mode="jorg+cmr", warmup_ratio=0)
    a = _glass(13, (4, 4, 6), 4, 3, chunk=20)
    ra = a.sample(20, "metropolis", **kw)
    b = _glass(13, (4, 4, 6), 4, 3, chunk=7)
    rb1 = b.sample(10, "metropolis", **kw)
    rb2 = b.sample(10, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_trip_state"):
        assert torch.equal(a.state[key], b.state[key]), key
    np.testing.assert_allclose(ra["overlap2"], (rb1["overlap2"] + rb2["overlap2"]) / 2,
                               rtol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(ra["overlap_histogram"]),
        np.asarray(rb1["overlap_histogram"]) + np.asarray(rb2["overlap_histogram"]))


@pytest.fixture
def zero_uniforms(monkeypatch):
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "colour_uniforms",
        lambda words, n, c, shape: torch.zeros(words.shape[:-1] + (n, *shape)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n, n_dirs=2, first=0: torch.zeros(words.shape[:-1] + (n, n_dirs)))


@pytest.mark.parametrize("mode,schedule", [("wolff", "single_random_edge"),
                                           ("sw", "full_ladder")],
                         ids=["wolff-single", "sw-full"])
def test_engine_matches_reference_under_zero_uniforms(zero_uniforms, mode, schedule):
    """8^3, R = 4, T = 3, d = 2, Houdayer every 2nd sweep, PT every sweep:
    the reference's megapair path and fused event in interpret mode against
    the port's replica path, bitwise (records within the reference's f32
    sums, rtol 2e-5)."""
    from test_torch_overlap import engine_pair

    engine_pair((8, 8, 8), 4, "houdayer", mode, schedule)


def glass_4x4_exact(J, T):
    """Exact <e> per spin and <q^2> = sum_ij <s_i s_j>^2 / N^2 of a 4x4
    glass with forward couplings ``J [16, 2]`` (E the positive bond sum)."""
    n = 16
    states = ((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1
    idx = np.arange(16).reshape(4, 4)
    fwd = np.stack([np.roll(idx, -1, 0), np.roll(idx, -1, 1)], -1).reshape(n, 2)
    E = sum((states * states[:, fwd[:, k]] * J[:, k]).sum(1) for k in range(2))
    w = np.exp((E - E.max()) / T)
    w /= w.sum()
    corr = (states.T * w) @ states
    return (E * w).sum() / n, (corr**2).sum() / n**2


@pytest.mark.parametrize("build", ["houdayer", "jorg", "cmr"])
def test_4x4_glass_exact(build):
    """A fixed 4x4 +-J glass, R = 2, three temperatures, PT every sweep and
    the overlap move every 5th, 4000 sweeps: <E> within 0.03 and <q^2>
    within 0.05 of exact enumeration (deviations of 0.009 and 0.012 at
    most were seen)."""
    rng = np.random.default_rng(44)
    J = rng.choice([-1.0, 1.0], size=(4, 4, 2)).astype(np.float32)
    temps = np.array([0.8, 1.3, 2.0], np.float32)
    m = Ising((4, 4), couplings=J, temperatures=temps, n_replicas=2, seed=7,
              device="cpu")
    m.sample(4000, pt_interval=1, overlap_cluster_update_interval=5,
             overlap_cluster_build_mode=build, warmup_ratio=0.1)
    for i, t in enumerate(temps):
        e_ex, q2_ex = glass_4x4_exact(J.reshape(16, 2), float(t))
        assert abs(m.energies_avg[i] - e_ex) < 0.03, (t, m.energies_avg[i], e_ex)
        assert abs(m.overlap2[i] - q2_ex) < 0.05, (t, m.overlap2[i], q2_ex)


def test_z_test_against_jax_engine_3d():
    """Batch means of <E> and <q^2> per temperature from 8 consecutive
    sample() calls on each engine (4^3 +-J glass, R = 2, 3 temps, PT and
    Houdayer every 2nd sweep): |z| < 4."""
    rng = np.random.default_rng(12)
    coup = rng.choice(np.float32([-1, 1]), size=(4, 4, 4, 3))
    temps = np.geomspace(1.0, 2.2, 3).astype(np.float32)
    kw = dict(pt_interval=1, overlap_cluster_update_interval=2, warmup_ratio=0)
    stats = {}
    for name, model in (
        ("jax", RefIsing((4, 4, 4), couplings=coup, temperatures=temps,
                         n_replicas=2, seed=21)),
        ("port", Ising((4, 4, 4), couplings=coup, temperatures=temps,
                       n_replicas=2, seed=22, device="cpu")),
    ):
        model.sample(200, **kw)  # burn-in
        e, q2 = [], []
        for _ in range(8):
            model.sample(250, **kw)
            e.append(model.energies_avg)
            q2.append(model.overlap2)
        stats[name] = (np.array(e), np.array(q2))
    for k, label in enumerate(("E", "q2")):
        a, b = stats["jax"][k], stats["port"][k]
        se = np.sqrt(a.var(0, ddof=1) / 8 + b.var(0, ddof=1) / 8)
        z = (a.mean(0) - b.mean(0)) / se
        assert (np.abs(z) < 4).all(), (label, z)


def _schema(x):
    if isinstance(x, dict):
        return {k: _schema(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_schema(v) for v in x]
    return (np.asarray(x).shape, np.asarray(x).dtype)


@pytest.mark.parametrize("n_disorder", [1, 2])
def test_results_schema_matches_reference(n_disorder):
    """Keys, shapes and dtypes of the results dict and the model's
    attributes, with and without per-sample entries (d > 1)."""
    kw = dict(pt_interval=1, overlap_cluster_update_interval=2,
              overlap_cluster_build_mode="jorg")
    temps = np.geomspace(0.9, 2.2, 3).astype(np.float32)
    ref = RefIsing((4, 4, 4), couplings="bimodal", temperatures=temps, n_replicas=2,
                   n_disorder=n_disorder, seed=4)
    port = Ising((4, 4, 4), couplings="bimodal", temperatures=temps, n_replicas=2,
                 n_disorder=n_disorder, seed=4, device="cpu")
    r_ref, r_port = ref.sample(8, **kw), port.sample(8, **kw)
    assert _schema(r_port) == _schema(r_ref)
    assert ("per_sample_overlap_histogram" in r_port) == (n_disorder > 1)
    for attr in ("sg_binder", "link_overlap_binder", "overlap_histogram",
                 "ql_at_q_sum", "overlap2", "link_overlap4"):
        assert np.shape(getattr(port, attr)) == np.shape(getattr(ref, attr)), attr
    np.testing.assert_array_equal(port.couplings, ref.couplings)


@pytest.mark.parametrize("kwargs,item", [
    (dict(cluster_update_interval=1), None),
    (dict(overlap_cluster_update_interval=1, overlap_cluster_mode="sw",
          overlap_cluster_action="observe"), None),
    (dict(overlap_cluster_update_interval=1, collect_cluster_stats=True), None),
    (dict(overlap_cluster_update_interval=2, snapshot_interval=2), None),
    (dict(overlap_cluster_update_interval=1, overlap_cluster_build_mode="houd4"),
     None),
    (dict(overlap_cluster_update_interval=1, overlap_cluster_build_mode="houd4",
          lattice_shape=(3, 3, 3, 3)), None),
], ids=["fk-phase", "observe", "collect-stats", "snapshots", "houd4", "houd4-4d"])
def test_out_of_slice_replica_options_raise(kwargs, item):
    """Options outside the slice raise, naming the ROADMAP item that brings
    them; the ones that items 7a, 7b, 7c and 4a brought in (an FK phase and
    snapshots with replicas, overlap observe, the overlap moves' cluster
    statistics, Houdayer(N), replicas on a 4D lattice) run: an FK phase
    takes the per-sweep path with its pair records, snapshots come at every
    second sweep past warmup."""
    kwargs = dict(kwargs)
    shape = kwargs.pop("lattice_shape", (4, 4, 4))
    m = Ising(shape, temperatures=[1.0, 2.0], n_replicas=4, seed=1, device="cpu")
    if item is not None:
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP.md, queue 1, item {item}"):
            m.sample(4, **kwargs)
        return
    r = m.sample(4, warmup_ratio=0, **kwargs)
    assert int(m._sim.state["counter"]) == 4
    observe = kwargs.get("overlap_cluster_action") == "observe"
    assert ("overlap_csd" in r) == (observe or "collect_cluster_stats" in kwargs)
    assert ("cluster_observations" in r.get("per_disorder", {})) == observe
    assert np.asarray(r["overlap_histogram"]).sum() == 4 * 2 * 2  # sweeps, pairs, T
    assert np.isfinite(r["link_overlap"]).all()
    snaps = r.get("cluster_snapshots", [])
    assert [x["sweep_id"] for x in snaps] == ([0, 2] if "snapshot_interval" in kwargs
                                              else [])
    if snaps:  # the model's attribute, as the reference passes it through
        assert m.cluster_snapshots is r["cluster_snapshots"]
    for x in snaps:
        assert x["spins"].shape == (2, 2, 64) and x["system_ids"].dtype == np.uint64


def test_overlap_needs_enough_replicas():
    m = Ising((4, 4), temperatures=[2.0], seed=1, device="cpu")
    with pytest.raises(ValueError, match="n_replicas >= max group_size"):
        m.sample(4, overlap_cluster_update_interval=1)
    # replicas and their overlap moves run on every lattice
    m = Ising((4, 4, 4), geometry="fcc", temperatures=[2.0], n_replicas=2, seed=1,
              device="cpu")
    r = m.sample(4, overlap_cluster_update_interval=1)
    assert np.asarray(r["overlap_histogram"]).sum() == 3  # recorded sweeps x pairs x T
    for key in ("energies", "overlap2", "link_overlap"):
        assert np.isfinite(r[key]).all(), key
