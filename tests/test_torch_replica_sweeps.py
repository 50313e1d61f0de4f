"""The per-sweep replica path: replicas with an FK phase, replicas on every
lattice, snapshots, and the pair overlaps over offset tables, against the
JAX package.

* The jnp-form PT draws of R ladders (``seeds.pt_draws_jnp(n_replicas=R)``)
  bitwise the draws of ``ops/tempering.py`` ``pt_single_random_edge`` and
  ``pt_full_ladder`` at R = 1, 2 and 4, and the port's PT step on them
  bitwise those functions' outputs (repeated edges of a single-edge event
  scatter-added into the attempts).
* The overlap moves' slot tasks mapped through ``system_ids``
  (``overlap.gather_tasks``) bitwise ``ops/overlap.py`` ``build_tasks``.
* ``megapair.pair_overlap_plain`` over offset tables bitwise
  ``ops/measure.py`` ``overlap_dots`` on the square, cubic, triangular,
  BCC, FCC and NNN lattices.
* The engine against the reference's per-sweep step body under zero
  uniforms (the reference in interpret mode, whose Pallas kernels draw
  zeros; the port with its uniform sources patched to zeros), as
  ``tests/test_torch_cluster.py`` does: spins, system ids, the PT state,
  ``fk_csd``, ``overlap_csd``, the q / q_l records, ``overlap_histogram``
  and the ``cluster_snapshots`` entries.  Shapes are those at which the
  reference's sweep kernels run (a lane-packed 2D width of 16, a 3D L0 of
  8).  Where the reference draws jax.random uniforms in place of a kernel's
  (the BCC FK bonds; the staged Joerg and CMR bonds of its snapshot
  sweeps), couplings of magnitude 50 make every bond probability 1 in f32,
  so the draws decide nothing.
* Exact enumeration of a 4x4 ferromagnet with R = 2 and SW: <q^2> =
  N^-2 sum_ij <s_i s_j>^2 and <q_l> = N_b^-1 sum_<ij> <s_i s_j>^2.
* A z-test of <E>, <m^2> and <q^2> against the JAX jnp path at 8x8
  triangular, R = 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.ops import overlap as ref_ov
from peapods_tpu.ops import tempering as ref_pt
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu.ops.measure import overlap_dots as ref_overlap_dots
from peapods_tpu_torch import Ising
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import megapair
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS
from peapods_tpu_torch.ops.overlap import gather_tasks
from peapods_tpu_torch.ops.tempering import hot_cold_slots, init_trip_state, pt_apply

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
BCC = GEOMETRY_OFFSETS["bcc"]
FCC = GEOMETRY_OFFSETS["fcc"]
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]


def _jkey(words):
    return jax.random.wrap_key_data(jnp.asarray(np.asarray(words, np.uint32)))


def _base(d, root=3):
    return np.stack([seeds.key_from_u64(seeds.realization_seed(root, r))
                     for r in range(d)])


# ------------------------------------------------------------ PT draws


@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("pt_full", [False, True], ids=["single", "full"])
def test_pt_draws_of_r_ladders_match_reference(n_rep, pt_full):
    """The draws of pt_single_random_edge (randint(k_edge, (R,)), uniform(k_u,
    (R,))) and pt_full_ladder (uniform(fold_in(k, i), (R, n_edges))) from k =
    fold_in(fold_in(key, ctr), PH_PT): threefry bits of shape (R,) are not R
    draws of shape ()."""
    d, n, n_edges, ctr = 2, 4, 5, 17
    base = _base(d)
    got = seeds.pt_draws_jnp(base, ctr, n, n_edges, pt_full=pt_full, n_replicas=n_rep)
    lead = (n, d) + ((n_rep,) if n_rep > 1 else ())
    for t in range(n):
        for r in range(d):
            k = jax.random.fold_in(jax.random.fold_in(_jkey(base[r]), ctr + t),
                                   seeds.PH_PT)
            if pt_full:
                assert got.shape == lead + (2, n_edges)
                for i in range(2):
                    u = np.asarray(jax.random.uniform(jax.random.fold_in(k, i),
                                                      (n_rep, n_edges)))
                    np.testing.assert_array_equal(
                        got[t, r, ..., i, :].reshape(n_rep, n_edges), u)
            else:
                assert got[0].shape == got[1].shape == lead
                k_edge, k_u = jax.random.split(k)
                edge = np.asarray(jax.random.randint(k_edge, (n_rep,), 0, n_edges))
                u = np.asarray(jax.random.uniform(k_u, (n_rep,), dtype=jnp.float32))
                np.testing.assert_array_equal(got[0][t, r].reshape(-1), edge)
                np.testing.assert_array_equal(got[1][t, r].reshape(-1), u)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("pt_full", [False, True], ids=["single", "full"])
def test_pt_event_of_r_ladders_matches_reference(n_rep, pt_full):
    """Twelve PT events on random energies: the port's ``pt_apply`` on the
    widened draws bitwise pt_single_random_edge / pt_full_ladder (new
    system ids, edge attempts and acceptances, round trips and trip state;
    a single-edge event's repeated edges scatter-added into the
    counters)."""
    n_temps, n_events = 4, 12
    s = n_rep * n_temps
    temps = np.geomspace(1.0, 2.0, n_temps).astype(np.float32)
    hot, cold = hot_cold_slots(temps)
    rng = np.random.default_rng(n_rep + 10 * pt_full)
    base = _base(1, 9)
    draws = seeds.pt_draws_jnp(base, 0, n_events, n_temps - 1, pt_full=pt_full,
                               n_replicas=n_rep)
    sid = rng.permutation(s).reshape(n_rep, n_temps).astype(np.int32)
    ref = dict(sid=jnp.asarray(sid), ea=jnp.zeros(n_temps - 1, jnp.int32),
               ec=jnp.zeros(n_temps - 1, jnp.int32), rt=jnp.zeros(s, jnp.int32),
               ts=ref_pt.init_trip_state(jnp.asarray(sid), hot))
    sid_t = torch.from_numpy(sid.reshape(1, s).copy())
    port = dict(ea=torch.zeros((1, n_temps - 1), dtype=torch.int32),
                ec=torch.zeros((1, n_temps - 1), dtype=torch.int32),
                rt=torch.zeros((1, s), dtype=torch.int32),
                ts=init_trip_state(sid_t.view(1, n_rep, n_temps), hot))
    parity = 0
    repeated = False
    for t in range(n_events):
        e_sys = rng.normal(-1.4, 0.05, s).astype(np.float32)
        k = jax.random.fold_in(jax.random.fold_in(_jkey(base[0]), t), seeds.PH_PT)
        args = (jnp.asarray(e_sys), ref["sid"], jnp.asarray(temps), k, 16)
        tail = (ref["ea"], ref["ec"], ref["rt"], ref["ts"], hot, cold)
        if pt_full:
            out = ref_pt.pt_full_ladder(*args, parity, *tail)
            dr = torch.from_numpy(draws[t]).reshape(1, n_rep, 2, n_temps - 1)
        else:
            out = ref_pt.pt_single_random_edge(*args, *tail)
            edge = draws[0][t].reshape(-1)
            repeated |= len(set(edge.tolist())) < len(edge)
            dr = (torch.from_numpy(edge.astype(np.int64)).reshape(1, -1),
                  torch.from_numpy(draws[1][t]).reshape(1, -1))
        ref.update(zip(("sid", "ea", "ec", "rt", "ts"), out))
        es = torch.from_numpy(e_sys)[sid_t.long()]
        parity = pt_apply(es, sid_t, port["ea"], port["ec"], port["rt"], port["ts"],
                          torch.from_numpy(np.tile(temps, n_rep)), dr,
                          pt_full=pt_full, parity=parity, n_spins=16, hot_slot=hot,
                          cold_slot=cold, n_replicas=n_rep)
        np.testing.assert_array_equal(sid_t.numpy().reshape(n_rep, n_temps),
                                      np.asarray(ref["sid"]))
        for key in ("ea", "ec", "rt", "ts"):
            np.testing.assert_array_equal(port[key].numpy()[0], np.asarray(ref[key]),
                                          err_msg=key)
    assert int(port["ec"].sum()) > 0
    if n_rep == 4 and not pt_full:
        assert repeated  # some event drew one edge for two ladders


# ------------------------------------------------------------ tasks


@pytest.mark.parametrize("n_rep,g", [(2, 2), (4, 2), (4, 4), (6, 2)])
def test_tasks_by_system_match_build_tasks(n_rep, g):
    """The slot tasks of ``seeds.overlap_tasks`` mapped through
    ``system_ids`` (``overlap.gather_tasks``' systems, which the moves and
    the snapshots read) bitwise ``build_tasks(sid, k_shuffle, g)`` with
    ``k_shuffle, _ = split(fold_in(fold_in(key, ctr), PH_OVERLAP))`` at
    each sweep."""
    d, n_temps, ctrs, n = 2, 3, [0, 5, 6], 4
    base = _base(d, 4)
    rng = np.random.default_rng(n_rep * g)
    sid = np.stack([rng.permutation(n_rep * n_temps).reshape(n_rep, n_temps)
                    for _ in range(d)]).astype(np.int32)
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        size=(d, n_rep * n_temps, n)))
    tasks, _ = seeds.overlap_tasks(base, ctrs, n_rep, n_temps, g)
    for i, ctr in enumerate(ctrs):
        sys, *members = gather_tasks(spins, torch.from_numpy(sid.reshape(d, -1)),
                                     torch.from_numpy(tasks[i]), n_temps)
        assert sys.shape == (d, n_temps, n_rep // g, g)
        for r in range(d):
            k = jax.random.fold_in(jax.random.fold_in(_jkey(base[r]), ctr),
                                   seeds.PH_OVERLAP)
            k_shuffle, _ = jax.random.split(k)
            want = np.asarray(ref_ov.build_tasks(jnp.asarray(sid[r]), k_shuffle, g))
            np.testing.assert_array_equal(sys[r].numpy(), want)
            # each member's spins are its system's
            for j in range(g):
                np.testing.assert_array_equal(
                    members[j].view(d, n_temps, -1, n)[r].numpy(),
                    spins[r].numpy()[want[..., j]])


# ------------------------------------------------------------ pair overlaps


LATTICES = [("square", (6, 8), None), ("cubic", (4, 6, 4), None),
            ("triangular", (8, 6), TRI), ("bcc", (4, 4, 6), BCC), ("fcc", (6, 4, 4), FCC),
            ("nnn", (6, 10), NNN)]


@pytest.mark.parametrize("n_rep", [2, 4])
@pytest.mark.parametrize("name,shape,offsets", LATTICES, ids=[x[0] for x in LATTICES])
def test_pair_overlap_plain_matches_overlap_dots(name, shape, offsets, n_rep):
    """qs, ql over the lattice's forward offsets bitwise the reference's
    ``overlap_dots`` with ``neighbor_sum_fwd``; the axes' table gives the
    hypercubic sums as before."""
    d, n_temps = 2, 3
    n = int(np.prod(shape))
    s = n_rep * n_temps
    rng = np.random.default_rng(n + n_rep)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(d, s, n))
    sid = np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)
    qs, ql = megapair.pair_overlap_plain(torch.from_numpy(spins), torch.from_numpy(sid),
                                         shape, n_rep, offsets)
    geom = GridOps.from_lattice(RefLattice(list(shape), offsets))
    for r in range(d):
        ws, wl = ref_overlap_dots(jnp.asarray(spins[r]),
                                  jnp.asarray(sid[r]).reshape(n_rep, n_temps), geom)
        np.testing.assert_array_equal(qs[r].numpy(), np.asarray(ws).reshape(-1))
        np.testing.assert_array_equal(ql[r].numpy(), np.asarray(wl).reshape(-1))
    if offsets is None:
        table = np.eye(len(shape), dtype=np.int64)
        qt, lt = megapair.pair_overlap_plain(torch.from_numpy(spins),
                                             torch.from_numpy(sid), shape, n_rep, table)
        assert torch.equal(qt, qs) and torch.equal(lt, ql)


# ------------------------------------------------------------ the engine


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The reference's interpret mode draws zero uniforms in its sweep, FK
    and event kernels; the port's plain path gets zeros in their place."""
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "colour_uniforms",
        lambda words, n, c, shape: torch.zeros(words.shape[:-1] + (n, *shape)))
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
    """Both engines on one +-J glass (``J`` its magnitude), 8 sweeps: the
    states, the PT state and the records compared."""
    nb = len(offsets) if offsets else len(shape)
    rng = np.random.default_rng(8)
    coup = (J * rng.choice([-1.0, 1.0], size=(2,) + shape + (nb,))).astype(np.float32)
    temps = np.geomspace(1.0, 2.4, n_temps).astype(np.float32)
    kw = dict(kw, warmup_ratio=0.25)
    ref = RefSimulation(list(shape), coup, temps, n_rep, offsets, 5, mesh=None)
    r_ref = ref.sample(n_sweeps, "metropolis", **kw)
    prog = next(iter(ref._programs.values()))
    assert not prog.megapair  # the reference's per-sweep step body
    port = IsingSimulation(list(shape), coup, temps, n_rep, offsets, 5, device="cpu")
    r_port = port.sample(n_sweeps, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts", "pt_edge_acceptances",
                "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(), np.asarray(ref.state[key]),
                                      err_msg=key)
    assert int(port.state["counter"]) == int(ref.state["counter"]) == n_sweeps
    assert int(port.state["pt_parity"]) == int(ref.state["pt_parity"])
    for key in ("energies", "energies2", "mags", "mags2", "overlap", "overlap2",
                "overlap4", "link_overlap", "link_overlap2", "link_overlap4",
                "ql_at_q_sum", "ql2_at_q_sum"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=2e-5, atol=1e-6,
                                   err_msg=key)
    _equal(r_port["overlap_histogram"], r_ref["overlap_histogram"], "overlap_histogram")
    for key in ("fk_csd", "overlap_csd", "top_cluster_sizes"):
        assert (key in r_port) == (key in r_ref), key
        if key in r_ref:
            _equal(r_port[key], r_ref[key], key)
    if "pt_interval" in kw:
        assert r_port["per_disorder"]["parallel_tempering"]["edge_acceptances"].sum() > 0
    assert ("cluster_snapshots" in r_port) == ("cluster_snapshots" in r_ref)
    snaps = r_port.get("cluster_snapshots", [])
    assert len(snaps) == len(r_ref.get("cluster_snapshots", []))
    for a, b in zip(snaps, r_ref.get("cluster_snapshots", [])):
        assert sorted(a) == sorted(b)
        for key in b:
            _equal(a[key], b[key], f"snapshot {key}")
    return r_port, port


SW_PT = dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1)


@pytest.mark.parametrize("shape,offsets,schedule", [
    ((8, 16), None, "full_ladder"), ((8, 16), TRI, "single_random_edge")],
    ids=["square-full", "triangular-single"])
def test_engine_r2_sw_pt_matches_reference(zero_uniforms, shape, offsets, schedule):
    """R = 2, SW and PT every sweep, the FK statistics collected: the
    per-sweep path with the pair overlaps (q_l over the triangular
    lattice's three offsets)."""
    r, _ = _engines(shape, offsets, 2, 4, dict(SW_PT, pt_schedule=schedule,
                                               collect_cluster_stats=True))
    assert "fk_csd" in r


def test_engine_r2_sw_bcc_matches_reference(zero_uniforms):
    """R = 2 on BCC with SW and PT: the staged FK path and q_l over four
    offsets.  |J| = 50: the reference's staged bonds draw jax.random
    uniforms, which decide nothing at bond probability 1."""
    _engines((8, 4, 4), BCC, 2, 4, SW_PT, J=50.0)


def test_engine_r4_cubic_sw_cmr_houd4_matches_reference(zero_uniforms):
    """R = 4 on the cubic lattice: SW every sweep, ``cmr+houd4`` SW every
    2nd sweep with its statistics, PT every sweep; after each move PT reads
    energies re-derived from the moved spins."""
    r, _ = _engines((8, 4, 4), None, 4, 2, dict(
        SW_PT, overlap_cluster_update_interval=2, overlap_cluster_build_mode="cmr+houd4",
        overlap_cluster_mode="sw", collect_cluster_stats=True))
    assert len(r["overlap_csd"]) == 2


@pytest.mark.parametrize("kw,J,n_rep", [
    (dict(overlap_cluster_build_mode="houdayer+houd4", overlap_cluster_mode="wolff"),
     1.0, 4),
    (dict(SW_PT, overlap_cluster_build_mode="cmr+houd4", overlap_cluster_mode="sw"),
     50.0, 4),
    (dict(overlap_cluster_build_mode="jorg", overlap_cluster_mode="wolff"), 50.0, 2),
], ids=["houdayer+houd4-wolff", "sw-cmr+houd4", "jorg-wolff"])
def test_engine_snapshots_match_reference(zero_uniforms, kw, J, n_rep):
    """``snapshot_interval=2`` with the move every 2nd sweep and PT: each
    snapshot of the sweeps past warmup (realization 0, the first group at
    each temperature, its first two replicas' systems and spins before the
    move, the labels, CMR's blue ones) bitwise the reference's."""
    n_temps = 8 // n_rep
    r, port = _engines((8, 4, 4), None, n_rep, n_temps, dict(
        kw, pt_interval=1, overlap_cluster_update_interval=2, snapshot_interval=2), J=J)
    snaps = r["cluster_snapshots"]
    assert [x["sweep_id"] for x in snaps] == [2, 4, 6]
    cmr = "cmr" in kw["overlap_cluster_build_mode"]
    for x in snaps:
        assert x["cluster_ids"].shape == (n_temps, 128)
        assert x["spins"].shape == (n_temps, 2, 128)
        assert x["system_ids"].shape == (n_temps, 2)
        assert ("blue_ids" in x) == (cmr and x["mode_idx"] == 0)
    assert port.n_replicas == n_rep


# ------------------------------------------------------------ physics


def _ferro_4x4_exact(T):
    """Exact <q^2> = N^-2 sum_ij <s_i s_j>^2 and <q_l> = N_b^-1 sum over the
    forward bonds of <s_i s_j>^2 of a 4x4 ferromagnet (two independent
    replicas), and <E> per spin, from the 2^16 states."""
    n = 16
    states = ((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1
    idx = np.arange(n).reshape(4, 4)
    fwd = np.stack([np.roll(idx, -1, 0), np.roll(idx, -1, 1)], -1).reshape(n, 2)
    E = sum((states * states[:, fwd[:, k]]).sum(1) for k in range(2)).astype(np.float64)
    w = np.exp((E - E.max()) / T)
    w /= w.sum()
    corr = (states.T * w) @ states
    bonds = corr[np.arange(n)[:, None], fwd]
    return (corr**2).sum() / n**2, (bonds**2).sum() / (2 * n), (E * w).sum() / n


def test_4x4_ferromagnet_r2_sw_exact():
    """16 realizations of one 4x4 ferromagnet, R = 2, SW and PT every sweep,
    1500 sweeps: <q^2> and <q_l> within 0.03 and <E> within 0.05 of exact
    enumeration at each of three temperatures (deviations below 0.01 were
    seen)."""
    temps = np.array([2.0, 2.6, 3.4], np.float32)
    coup = np.ones((16, 4, 4, 2), np.float32)
    m = IsingSimulation([4, 4], coup, temps, 2, None, 13, device="cpu")
    r = m.sample(1500, "metropolis", cluster_update_interval=1, cluster_mode="sw",
                 pt_interval=1, warmup_ratio=0.1)
    for i, t in enumerate(temps):
        q2, ql, e = _ferro_4x4_exact(float(t))
        assert abs(r["overlap2"][i] - q2) < 0.03, (t, r["overlap2"][i], q2)
        assert abs(r["link_overlap"][i] - ql) < 0.03, (t, r["link_overlap"][i], ql)
        assert abs(r["energies"][i] - e) < 0.05, (t, r["energies"][i], e)


def test_z_test_tri_r2_against_jax_engine():
    """Batch means of <E>, <m^2> and <q^2> per temperature from 8
    consecutive sample() calls on each engine (8x8 triangular ferromagnet
    around T_c = 4 / ln 3, R = 2, SW and PT every sweep; the reference's
    jnp path): |z| < 4."""
    temps = np.array([3.0, 3.6, 4.4], np.float32)
    kw = dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1,
              warmup_ratio=0)
    stats = {}
    for name, model in (
        ("jax", RefIsing((8, 8), geometry="triangular", temperatures=temps,
                         n_replicas=2, seed=31)),
        ("port", Ising((8, 8), geometry="triangular", temperatures=temps,
                       n_replicas=2, seed=32, device="cpu")),
    ):
        model.sample(100, **kw)  # burn-in
        rows = []
        for _ in range(8):
            r = model.sample(150, **kw)
            rows.append((r["energies"], r["mags2"], r["overlap2"]))
        stats[name] = np.array(rows)  # [8, 3, T]
    for k, label in enumerate(("E", "m2", "q2")):
        a, b = stats["jax"][:, k], stats["port"][:, k]
        se = np.sqrt(a.var(0, ddof=1) / 8 + b.var(0, ddof=1) / 8)
        z = (a.mean(0) - b.mean(0)) / se
        assert (np.abs(z) < 4).all(), (label, z)
