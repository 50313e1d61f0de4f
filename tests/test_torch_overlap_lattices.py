"""The overlap moves (Houdayer(N), Joerg, CMR) on the triangular, BCC, FCC
and offset-table lattices, against the JAX package.

* The plain moves over a lattice's offsets (``ops/overlap.py`` with a
  ``Lattice``) bitwise the reference's fused triangular events
  ``overlap_event_batch(tri=True)`` and ``houdn_event_batch(tri=True)``
  (interpret mode) at 8x16, fed the same uniforms (``_fused`` packs them as
  ``tests/test_torch_overlap.py`` does), and bitwise the staged functions
  (``houdayer_task``, ``jorg_bonds(u_bond=)``, ``cmr_blue_bonds(u_blue=)``,
  ``cmr_mid(u_red=)`` on ``GridOps.from_lattice``) on BCC, FCC and the NNN
  table.  Spins of every member and the labels, bitwise.
* CMR's red bond counters start at the lattice's ``n_neighbors``, disjoint
  from its blue ones (on the triangular lattice ``n_dims = 2 < 3``).

The engine's moves on these lattices: ``test_torch_overlap_lattices_engine.py``;
their physics: ``test_torch_overlap_lattices_physics.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.ops import cluster as cl
from peapods_tpu.ops import overlap as ov
from peapods_tpu.ops import pallas_cc_batch as ccb
from peapods_tpu.ops import pallas_event as pe
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.ops import overlap
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
BCC = GEOMETRY_OFFSETS["bcc"]
FCC = GEOMETRY_OFFSETS["fcc"]
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]


def _batch(shape, offsets, n_tasks, seed, g=2):
    """Tasks of ``g`` random replicas, gaussian couplings, per-task
    temperatures, two sets of bond uniforms and task keys."""
    lat = RefLattice(list(shape), offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1, 1], np.int8), size=(n_tasks, g, n))
    coup = rng.normal(size=(n, nb)).astype(np.float32)
    temps = np.linspace(0.8, 1.6, n_tasks).astype(np.float32)
    u = rng.random((2, n_tasks, n, nb), dtype=np.float32)
    tkeys = jax.random.split(jax.random.key(seed), n_tasks)
    return lat, x, coup, temps, u, tkeys


def _wolff_labels(labels, wolff):
    """The fused kernels' labels with the Wolff marker rewritten to the
    seed cluster's least site, as the engine does (loop.py:2418-2429)."""
    if not wolff:
        return labels
    n = labels.shape[-1]
    neg = labels == -1
    return np.where(neg, np.where(neg, np.arange(n), n).min(-1, keepdims=True), labels)


def _fused_tri(lat, x, tkeys, kind, wolff, coup, temps, u):
    """The reference's fused triangular event in interpret mode on a flat
    task batch (task i at temps[i]; the bond uniforms as its injected
    slots, blue then red)."""
    shape = tuple(lat.shape)
    n = lat.n_spins
    b, g = x.shape[:2]
    kp, ks = ccb.cc_batch_factors(lat, b)
    tile = kp * ks
    l0, block = shape[0], n // shape[0]
    pad = (-b) % tile
    zrow = lambda v: jnp.concatenate([v, jnp.zeros((pad,) + v.shape[1:], v.dtype)])  # noqa: E731
    pack = lambda v: ccb._pack(zrow(jnp.asarray(v)), l0, block, kp, ks)  # noqa: E731
    unpack = lambda o: np.asarray(ccb._unpack(o, l0, block, kp, ks)[:b])  # noqa: E731
    if kind == "houdayer" and g > 2:
        gscal = pe.houdn_scalars(wolff, jnp.asarray(x), tkeys, n)
        gscal = jnp.concatenate([gscal, jnp.zeros((pad, 6), jnp.int32).at[:, 4].set(n)])
        outs = pe.houdn_event_batch(
            tuple(pack(x[:, i]) for i in range(g)), gscal.reshape(-1, tile, 6),
            wolff=wolff, shape=shape, kp=kp, ks=ks, interpret=True, with_labels=True,
            tri=True)
        out = [unpack(o) for o in outs]
        return np.stack(out[:g], 1), _wolff_labels(out[g], wolff)
    a, bb = jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1])
    gscal = pe.event_scalars(kind, wolff, a, bb, tkeys, n)
    gscal = jnp.concatenate([gscal, jnp.zeros((pad, 6), jnp.int32).at[:, 4].set(n)])
    words = jax.lax.bitcast_convert_type(
        jax.random.key_data(tkeys).astype(jnp.uint32), jnp.int32)
    jt = uu = None
    if kind != "houdayer":
        jt = pe.pack_event_jt(jnp.asarray(coup)[None], jnp.asarray(temps), 1, shape,
                              kp, ks)
        slots = [u[0][..., d] for d in range(3)]
        if kind == "cmr":
            slots += [u[1][..., d] for d in range(3)]
        uu = jnp.stack([pack(s) for s in slots], axis=1)
    out = pe.overlap_event_batch(
        pack(x[:, 0]), pack(x[:, 1]), gscal.reshape(-1, tile, 6),
        zrow(words).reshape(-1, tile, 2)[:, :1, :], jt, uu, kind=kind, wolff=wolff,
        shape=shape, kp=kp, ks=ks, interpret=True, with_labels=True, tri=True)
    a2, b2, labels = (unpack(o) for o in out)
    return np.stack([a2, b2], 1), _wolff_labels(labels, wolff)


def _port(lat, x, tkeys, kind, wolff, coup, temps, u):
    """The port's plain move on the same tasks: ``(spins, labels, blue
    labels)`` (blue ``None`` but for CMR)."""
    n = lat.n_spins
    scal, probes = seeds.event_scalars(kind, wolff,
                                       np.asarray(jax.random.key_data(tkeys)), n)
    scal, probes = torch.from_numpy(scal), torch.from_numpy(probes)
    tx = torch.from_numpy(x)
    jt = torch.from_numpy(coup)[None] / torch.from_numpy(temps)[:, None, None]
    if kind == "houdayer":
        got, labels = overlap.houdn_plain(tx, scal, probes, lat, wolff=wolff)
        return got.numpy(), labels.numpy(), None
    if kind == "jorg":
        a, b, labels = overlap.jorg_plain(tx[:, 0], tx[:, 1], jt, scal, probes, lat,
                                          wolff=wolff, u=torch.from_numpy(u[0]))
        blue = None
    else:
        a, b, labels, blue = overlap.cmr_plain(tx[:, 0], tx[:, 1], jt, scal, lat,
                                               wolff=wolff, u_blue=torch.from_numpy(u[0]),
                                               u_red=torch.from_numpy(u[1]))
        blue = blue.numpy()
    return torch.stack([a, b], 1).numpy(), labels.numpy(), blue


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("kind,g", [("houdayer", 2), ("jorg", 2), ("cmr", 2),
                                    ("houdayer", 4)],
                         ids=["houdayer", "jorg", "cmr", "houd4"])
def test_plain_moves_match_fused_triangular_events(kind, g, wolff):
    """8x16 triangular: every member's spins and the stats graph's labels
    (CMR: the blue ones) bitwise the fused event's."""
    shape = (8, 16)
    _, x, coup, temps, u, tkeys = _batch(shape, TRI, 6, 40 + g + 3 * wolff, g)
    lat = RefLattice(list(shape), TRI)
    want, want_labels = _fused_tri(lat, x, tkeys, kind, wolff, coup, temps, u)
    got, labels, blue = _port(Lattice(shape, TRI), x, tkeys, kind, wolff, coup,
                              temps, u)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(blue if kind == "cmr" else labels, want_labels)
    assert (got != x).any()


def _staged(lat, x, tkeys, kind, wolff, coup, temps, u):
    """The reference's staged chain on ``GridOps.from_lattice`` with the
    injected uniforms: spins ``[B, g, n]`` and the final labels."""
    geom = GridOps.from_lattice(lat)
    cj = jnp.asarray(coup)

    def one(ts, k, t, u0, u1):
        if kind == "houdayer":
            out = ov.houdayer_task(ts, k, geom, wolff=wolff, update=True,
                                   with_winding=False, with_stats=False)
            return out.spins, out.labels
        if kind == "jorg":
            bonds, aux = ov.jorg_bonds(ts, k, cj, t, geom, u_bond=u0)
            labels = cl.connected_components(bonds, geom)
            out = ov.jorg_finish(ts, labels, bonds, aux, geom, wolff=wolff,
                                 update=True, with_winding=False, with_stats=False)
            return out.spins, out.labels
        blue, aux = ov.cmr_blue_bonds(ts, k, cj, t, geom, u_blue=u0)
        blue_labels = cl.connected_components(blue, geom)
        ts, grey, carry = ov.cmr_mid(ts, blue_labels, blue, aux, cj, geom, wolff=wolff,
                                     update=True, with_winding=False, with_stats=False,
                                     u_red=u1)
        grey_labels = cl.connected_components(grey, geom)
        out = ov.cmr_finish(ts, grey_labels, grey, blue_labels, carry, geom,
                            wolff=wolff, update=True)
        return out.spins, out.labels

    spins, labels = jax.vmap(one)(jnp.asarray(x), tkeys, jnp.asarray(temps),
                                  jnp.asarray(u[0]), jnp.asarray(u[1]))
    return np.asarray(spins), np.asarray(labels)


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
@pytest.mark.parametrize("shape,offsets", [((4, 4, 6), BCC), ((4, 6, 4), FCC),
                                           ((6, 8), NNN)], ids=["bcc", "fcc", "nnn"])
def test_plain_moves_match_staged_functions(shape, offsets, kind, wolff):
    """BCC, FCC and the NNN table: spins and the move's last labels (CMR's
    grey ones) bitwise the staged chain's."""
    rlat, x, coup, temps, u, tkeys = _batch(shape, offsets, 4, 50 + len(offsets) + wolff)
    want, want_labels = _staged(rlat, x, tkeys, kind, wolff, coup, temps, u)
    got, labels, _ = _port(Lattice(shape, offsets), x, tkeys, kind, wolff, coup,
                           temps, u)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels, want_labels)
    assert (got != x).any()


def test_cmr_red_counters_follow_the_offsets(monkeypatch):
    """On the triangular lattice (n_dims 2, n_neighbors 3) CMR draws its
    blue bonds at Philox counters 0, 1, 2 and its red ones at 3, 4, 5: the
    plain move asks rng.bond_uniforms for exactly these, and red bond 0's
    uniforms are not blue bond 2's (the fault a counter n_dims + dir would
    make)."""
    shape = (8, 16)
    lat = Lattice(shape, TRI)
    n = lat.n_spins
    d, n_rep, n_temps = 1, 2, 2
    rng = np.random.default_rng(12)
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                        size=(d, n_rep * n_temps, n)))
    sid = torch.arange(n_rep * n_temps, dtype=torch.int32)[None]
    coup = torch.from_numpy(rng.normal(size=(d, n, 3)).astype(np.float32))
    temps = torch.tensor([1.0, 1.5])
    tasks, tkeys = seeds.overlap_tasks(np.array([[5, 6]], np.uint32), [3], n_rep, n_temps)
    scal, probes = seeds.event_scalars("cmr", False, tkeys[0], n)
    words = torch.from_numpy(tkeys[0].view(np.int32).reshape(-1, 2).copy())
    calls = []
    draw = trng.bond_uniforms

    def spy(w, n_spins, n_dirs=2, first=0):
        calls.append(list(range(first, first + n_dirs)))
        return draw(w, n_spins, n_dirs, first)

    monkeypatch.setattr(trng, "bond_uniforms", spy)
    overlap.bond_states_plain(spins, sid, torch.from_numpy(tasks[0]), coup, temps,
                              torch.from_numpy(scal.reshape(-1, 6)),
                              torch.from_numpy(probes.reshape(-1, 64)), words,
                              kind="cmr", wolff=False, shape=lat)
    assert calls == [[0, 1, 2], [3, 4, 5]]
    blue, red = draw(words, n, 3), draw(words, n, 3, 3)
    assert not torch.equal(red[..., 0], blue[..., 2])
    assert (red[..., 0] != blue[..., 2]).float().mean() > 0.99
