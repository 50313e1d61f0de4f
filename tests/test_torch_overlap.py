"""The port's pair overlap moves, bitwise against the JAX package.

``ops/overlap.py``'s plain versions (``houdayer_plain``, ``jorg_plain``,
``cmr_plain``, ``overlap_event_plain``) are held against the reference's
fused event ``overlap_event_batch(interpret=True)`` and against its staged
functions (``jorg_bonds(u_bond=)``, ``cmr_blue_bonds(u_blue=)``,
``cmr_mid(u_red=)``) fed the same per-bond uniforms, Wolff and SW, in 2D
and 3D.  The per-task scalars come from the same task keys through the
port's numpy key algebra (``seeds.event_scalars``), whose Wolff probes the
plain version (and the CUDA kernel) searches as ``find_seed`` does.
Couplings are gaussian: J/T is the same f32 quotient on both sides, and
the factors -2 and -4 are exact, so every bond decision is bitwise.

The engine tests run the reference's megapair path in interpret mode (zero
site and bond uniforms) against the port's replica path with its uniform
sources replaced by zeros: the whole order sweep -> measure -> move -> PT
on re-derived energies, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.ops import cluster as cl
from peapods_tpu.ops import overlap as ov
from peapods_tpu.ops import pallas_cc_batch as ccb
from peapods_tpu.ops import pallas_event as pe
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import cluster, overlap
from peapods_tpu_torch.ops import rng as trng

torch.set_num_threads(1)


def _batch(shape, n_tasks, seed):
    lat = RefLattice(list(shape))
    n, nd = lat.n_spins, lat.n_dims
    rng = np.random.default_rng(seed)
    a = rng.choice(np.array([-1, 1], np.int8), size=(n_tasks, n))
    b = rng.choice(np.array([-1, 1], np.int8), size=(n_tasks, n))
    coup = rng.normal(size=(n, nd)).astype(np.float32)
    temps = np.linspace(0.8, 1.6, n_tasks).astype(np.float32)
    u = rng.random((2, n_tasks, n, nd), dtype=np.float32)
    tkeys = jax.random.split(jax.random.key(seed), n_tasks)
    return lat, a, b, coup, temps, u, tkeys


def _fused(lat, a, b, tkeys, kind, wolff, coup, temps, u_slots):
    """The reference's fused event in interpret mode on a flat task batch
    (tasks at temps[i]); labels with the Wolff marker rewritten as the
    engine does (loop.py:2418-2429)."""
    shape = tuple(lat.shape)
    n = lat.n_spins
    n_tasks = a.shape[0]
    kp, ks = ccb.cc_batch_factors(lat, n_tasks)
    tile = kp * ks
    l0, block = shape[0], n // shape[0]
    a, b = jnp.asarray(a), jnp.asarray(b)
    gscal = pe.event_scalars(kind, wolff, a, b, tkeys, n)
    words = jax.lax.bitcast_convert_type(
        jax.random.key_data(tkeys).astype(jnp.uint32), jnp.int32)
    pad = (-n_tasks) % tile
    u_slots = [jnp.asarray(x) for x in u_slots]
    if pad:
        zrow = lambda x: jnp.zeros((pad,) + x.shape[1:], x.dtype)  # noqa: E731
        a, b, words = (jnp.concatenate([x, zrow(x)]) for x in (a, b, words))
        gscal = jnp.concatenate(
            [gscal, jnp.zeros((pad, 6), jnp.int32).at[:, 4].set(n)])
        u_slots = [jnp.concatenate([x, zrow(x)]) for x in u_slots]
    g = (n_tasks + pad) // tile
    jt = (pe.pack_event_jt(jnp.asarray(coup)[None], jnp.asarray(temps), 1, shape,
                           kp, ks) if kind != "houdayer" else None)
    u = (jnp.stack([ccb._pack(x, l0, block, kp, ks) for x in u_slots], axis=1)
         if kind != "houdayer" else None)
    out = pe.overlap_event_batch(
        ccb._pack(a, l0, block, kp, ks), ccb._pack(b, l0, block, kp, ks),
        gscal.reshape(g, tile, 6), words.reshape(g, tile, 2)[:, :1, :], jt, u,
        kind=kind, wolff=wolff, shape=shape, kp=kp, ks=ks, interpret=True,
        with_labels=True)
    a2, b2, labels = (np.asarray(ccb._unpack(o, l0, block, kp, ks)[:n_tasks])
                      for o in out)
    if wolff:
        neg = labels == -1
        mn = np.where(neg, np.arange(n), n).min(-1, keepdims=True)
        labels = np.where(neg, mn, labels)
    return a2, b2, labels


def _port(lat, a, b, tkeys, kind, wolff, coup, temps, u):
    """The port's plain move on the same tasks."""
    shape = tuple(lat.shape)
    n = lat.n_spins
    scal, probes = seeds.event_scalars(kind, wolff,
                                       np.asarray(jax.random.key_data(tkeys)), n)
    scal, probes = torch.from_numpy(scal), torch.from_numpy(probes)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jt = torch.from_numpy(coup)[None] / torch.from_numpy(temps)[:, None, None]
    if kind == "houdayer":
        out = overlap.houdayer_plain(ta, tb, scal, probes, shape, wolff=wolff)
    elif kind == "jorg":
        out = overlap.jorg_plain(ta, tb, jt, scal, probes, shape, wolff=wolff,
                                 u=torch.from_numpy(u[0]))
    else:
        out = overlap.cmr_plain(ta, tb, jt, scal, shape, wolff=wolff,
                                u_blue=torch.from_numpy(u[0]),
                                u_red=torch.from_numpy(u[1]))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("shape", [(8, 16), (8, 8, 8)])
@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
def test_plain_move_matches_fused_event(kind, wolff, shape):
    """Spins (both replicas) and the labels of the move's last graph,
    bitwise; CMR's blue labels against the reference's stats labels."""
    lat, a, b, coup, temps, u, tkeys = _batch(shape, 6, 7 + len(shape) + 3 * wolff)
    nd = lat.n_dims
    slots = [u[0][..., d] for d in range(nd)] + (
        [u[1][..., d] for d in range(nd)] if kind == "cmr" else [])
    ra, rb, rlab = _fused(lat, a, b, tkeys, kind, wolff, coup, temps, slots)
    got = _port(lat, a, b, tkeys, kind, wolff, coup, temps, u)
    np.testing.assert_array_equal(got[0], ra)
    np.testing.assert_array_equal(got[1], rb)
    # the reference emits the stats graph's labels: the blue one for CMR
    np.testing.assert_array_equal(got[3] if kind == "cmr" else got[2], rlab)
    assert (got[0] != a).any()


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("kind", ["jorg", "cmr"])
def test_plain_move_matches_staged_functions(kind, wolff):
    """The staged ops/overlap.py chain with injected uniforms (u_bond /
    u_blue, u_red) on a 3D batch: spins and final labels bitwise."""
    shape = (4, 6, 8)
    lat, a, b, coup, temps, u, tkeys = _batch(shape, 5, 31 + 2 * wolff)
    geom = GridOps.from_lattice(lat)
    cj = jnp.asarray(coup)

    def staged(av, bv, k, t, u0, u1):
        ts = jnp.stack([av, bv])
        if kind == "jorg":
            bonds, aux = ov.jorg_bonds(ts, k, cj, t, geom, u_bond=u0)
            labels = cl.connected_components(bonds, geom)
            out = ov.jorg_finish(ts, labels, bonds, aux, geom, wolff=wolff,
                                 update=True, with_winding=False, with_stats=False)
            return out.spins, out.labels
        blue, aux = ov.cmr_blue_bonds(ts, k, cj, t, geom, u_blue=u0)
        blue_labels = cl.connected_components(blue, geom)
        ts, grey, carry = ov.cmr_mid(ts, blue_labels, blue, aux, cj, geom,
                                     wolff=wolff, update=True, with_winding=False,
                                     with_stats=False, u_red=u1)
        grey_labels = cl.connected_components(grey, geom)
        out = ov.cmr_finish(ts, grey_labels, grey, blue_labels, carry, geom,
                            wolff=wolff, update=True)
        return out.spins, out.labels

    spins, labels = jax.vmap(staged)(jnp.asarray(a), jnp.asarray(b), tkeys,
                                     jnp.asarray(temps), jnp.asarray(u[0]),
                                     jnp.asarray(u[1]))
    got = _port(lat, a, b, tkeys, kind, wolff, coup, temps, u)
    np.testing.assert_array_equal(got[0], np.asarray(spins)[:, 0])
    np.testing.assert_array_equal(got[1], np.asarray(spins)[:, 1])
    np.testing.assert_array_equal(got[2], np.asarray(labels))


def test_find_seed_and_nonsingleton_match_reference():
    lat = RefLattice([4, 6, 8])
    geom = GridOps.from_lattice(lat)
    n = lat.n_spins
    rng = np.random.default_rng(3)
    keys = jax.random.split(jax.random.key(9), 40)
    for p in (0.002, 0.05, 0.5):
        eligible = rng.random((40, n)) < p
        seed, found = jax.vmap(cl.find_seed)(keys, jnp.asarray(eligible))
        probes = jax.vmap(lambda k: jax.random.randint(k, (64,), 0, n))(keys)
        got = cluster.find_seed(torch.from_numpy(np.array(probes)),
                                torch.from_numpy(eligible)).numpy()
        want = np.where(np.asarray(found), np.asarray(seed), n)
        np.testing.assert_array_equal(got, want)
    bonds = rng.random((5, n, 3)) < 0.1
    want = jax.vmap(lambda x: cl.nonsingleton_mask(x, geom))(jnp.asarray(bonds))
    got = cluster.nonsingleton_mask(torch.from_numpy(bonds), tuple(lat.shape))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_connected_components_3d_against_union_find():
    """Min-site-index labels on 3D bond graphs against a sequential
    union-find, from sparse to percolating."""
    shape = (4, 6, 8)
    n = 4 * 6 * 8
    idx = np.arange(n).reshape(shape)
    fwd = np.stack([np.roll(idx, -1, a).reshape(-1) for a in range(3)], -1)
    rng = np.random.default_rng(11)
    for p in (0.1, 0.3, 0.8):
        active = rng.random((3, n, 3)) < p
        got = cluster.connected_components(torch.from_numpy(active), shape)
        for g in range(3):
            parent = list(range(n))

            def find(x):
                while parent[x] != x:
                    x = parent[x]
                return x

            for i in range(n):
                for k in range(3):
                    if active[g, i, k]:
                        ra, rb = find(i), find(int(fwd[i, k]))
                        parent[max(ra, rb)] = min(ra, rb)
            assert got[g].tolist() == [find(i) for i in range(n)]


def test_overlap_event_plain_gathers_and_scatters_by_slot():
    """The move through sid and the task table equals the per-task move on
    the gathered pairs, and leaves every other system alone."""
    shape = (4, 4, 6)
    d, n_rep, n_temps = 2, 4, 3
    n = 96
    rng = np.random.default_rng(5)
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        size=(d, n_rep * n_temps, n)))
    sid = torch.from_numpy(np.stack([rng.permutation(n_rep * n_temps)
                                     for _ in range(d)]).astype(np.int32))
    coup = torch.from_numpy(rng.choice([-1.0, 1.0], size=(d, n, 3)).astype(np.float32))
    temps = torch.tensor([0.9, 1.4, 2.0])
    tasks, tkeys = seeds.overlap_tasks(np.array([[1, 2], [3, 4]], np.uint32), [7],
                                       n_rep, n_temps)
    scal, probes = seeds.event_scalars("jorg", True, tkeys[0], n)
    tab = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        tasks[0], scal.reshape(-1, 6), probes.reshape(-1, 64),
        tkeys[0].view(np.int32).reshape(-1, 2))]
    sys, a, b = overlap.gather_tasks(spins, sid, tab[0], n_temps)
    jt = overlap.task_jt(coup, temps, n_rep // 2)
    u = trng.bond_uniforms(tab[3], n, 3)
    a2, b2, _ = overlap.jorg_plain(a, b, jt, tab[1], tab[2], shape, wolff=True, u=u)
    moved = spins.clone()
    overlap.overlap_event_plain(moved, sid, tab[0], coup, temps, *tab[1:],
                                kind="jorg", wolff=True, shape=shape)
    _, a3, b3 = overlap.gather_tasks(moved, sid, tab[0], n_temps)
    assert torch.equal(a3, a2) and torch.equal(b3, b2)
    touched = torch.zeros((d, n_rep * n_temps), dtype=torch.bool)
    touched[torch.arange(d)[:, None], sys.reshape(d, -1)] = True
    assert torch.equal(moved[~touched], spins[~touched])
    assert not torch.equal(moved, spins)


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The reference's interpret mode draws zero site and bond uniforms; the
    port's plain path gets zeros in their place."""
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "colour_uniforms",
        lambda words, n, c, shape: torch.zeros(words.shape[:-1] + (n, *shape)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n, n_dirs=2, first=0: torch.zeros(words.shape[:-1] + (n, n_dirs)))


def engine_pair(shape, n_rep, build, mode, schedule, couplings="pm"):
    """Both engines, 8 sweeps with PT every sweep and the move every 2nd:
    the final states must be equal and the records within rtol 2e-5 (the
    reference keeps f32 sums)."""
    rng = np.random.default_rng(3)
    nd = len(shape)
    coup = (rng.choice(np.float32([-1, 1]), size=(2,) + tuple(shape) + (nd,))
            if couplings == "pm" else
            rng.normal(size=(2,) + tuple(shape) + (nd,)).astype(np.float32))
    temps = np.geomspace(0.9, 2.2, 3).astype(np.float32)
    kw = dict(pt_interval=1, pt_schedule=schedule, overlap_cluster_update_interval=2,
              overlap_cluster_build_mode=build, overlap_cluster_mode=mode,
              warmup_ratio=0.25)
    ref = RefSimulation(list(shape), coup, temps, n_rep, None, 5, mesh=None)
    r_ref = ref.sample(8, "metropolis", **kw)
    prog = next(iter(ref._programs.values()))
    assert prog.megapair and prog.event_kernel  # the kernels this port ports
    port = IsingSimulation(list(shape), coup, temps, n_rep, None, 5, device="cpu")
    r_port = port.sample(8, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts", "pt_edge_acceptances",
                "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(),
                                      np.asarray(ref.state[key]), err_msg=key)
    assert int(port.state["counter"]) == int(ref.state["counter"]) == 8
    assert int(port.state["pt_parity"]) == int(ref.state["pt_parity"])
    for key in ("energies", "energies2", "mags", "mags2", "overlap", "overlap2",
                "overlap4", "link_overlap", "link_overlap2", "ql_at_q_sum",
                "ql2_at_q_sum"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=2e-5, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_array_equal(np.asarray(r_port["overlap_histogram"]),
                                  np.asarray(r_ref["overlap_histogram"]))
    assert r_port["per_disorder"]["parallel_tempering"]["edge_acceptances"].sum() > 0


@pytest.mark.parametrize("build,mode,schedule", [
    ("jorg+cmr", "wolff", "full_ladder"), ("jorg+cmr", "sw", "single_random_edge"),
], ids=["jorg+cmr-wolff-full", "jorg+cmr-sw-single"])
def test_engine_matches_reference_under_zero_uniforms(zero_uniforms, build, mode,
                                                      schedule):
    engine_pair((8, 8, 8), 4, build, mode, schedule)


def test_engine_2d_matches_reference_under_zero_uniforms(zero_uniforms):
    """(8, 64) with R = 2, where the reference also takes megapair."""
    engine_pair((8, 64), 2, "cmr", "wolff", "single_random_edge")
