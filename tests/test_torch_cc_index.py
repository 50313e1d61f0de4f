"""The labelling of offset tables (``csrc/cc.cu`` ``cc_link``,
``cc_link_border``, then ``fk.cu``'s ``fk_link_flatten``) on the CPU: its
host words, index arithmetic and union order, as
``tests/test_torch_link.py`` models ``fk_link``'s.

* ``cc.link_words`` decodes to the lattice, its boxes, the residues ``off
  mod L`` and multiply-shift divisors that are exact over every box and
  box index; ``cc.fast_offset`` finds the fast axis' unit step.
* A numpy model of the kernels' indices (``cc_box``, ``cc_coords``,
  ``cc_site``, ``cc_step``, ``cc_neighbour``): every site lies in one box
  at one box index; each neighbour inside the box, and each neighbour
  across it, is the lattice's own (``Lattice.fwd``: nb.cuh's ``wrap`` of
  each axis) on BCC, FCC, NNN, triangular and tables with offsets of
  length 2, at extents down to 2.
* A sequential model of the kernels (the ballot's runs, the unions of a
  round of sites in any order, the round's finds, the box or slab roots;
  the whole-graph form's unions across its cluster's slabs; the border's
  unions of box roots; the flatten) gives labels bitwise
  ``cluster.connected_components``, the link alone each site's box
  component's minimum, and small graphs bitwise the JAX package's
  ``connected_components_batch`` run in interpret mode, as its own tests
  run it on the CPU.
* ``cc.link_plan``'s choice of form and cluster from the shape alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.ops import pallas_cc_batch as ccb
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch.ops import _build, cc, cluster, fk
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

torch.set_num_threads(1)

NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
LEN2 = [[2, 0], [0, 1], [1, -2]]
LEN2_3D = [[0, 0, 1], [2, 1, 0], [0, -2, 1]]
# (name, shape, offsets, tiles the model takes besides the whole graph)
LATTICES = [
    ("bcc-4x4x8", (4, 4, 8), GEOMETRY_OFFSETS["bcc"], [(2, 4, 8), (3, 2, 4)]),
    ("fcc-6x4x4", (6, 4, 4), GEOMETRY_OFFSETS["fcc"], [(4, 4, 4), (2, 2, 4), (6, 3, 2)]),
    ("fcc-2x2x6", (2, 2, 6), GEOMETRY_OFFSETS["fcc"], [(1, 2, 6), (2, 1, 4)]),
    ("nnn-8x12", (8, 12), NNN, [(3, 12, 1), (8, 4, 1), (5, 5, 1)]),
    ("nnn-2x8", (2, 8), NNN, [(1, 8, 1), (2, 3, 1)]),
    ("tri-6x10", (6, 10), GEOMETRY_OFFSETS["triangular"], [(4, 4, 1), (6, 10, 1)]),
    ("len2-8x6", (8, 6), LEN2, [(2, 6, 1), (3, 2, 1)]),
    ("len2-2x4", (2, 4), LEN2, [(1, 4, 1), (2, 1, 1)]),
    ("len2-3d-4x6x4", (4, 6, 4), LEN2_3D, [(2, 2, 4), (4, 6, 1), (3, 4, 2)]),
    ("square-6x8", (6, 8), None, [(2, 8, 1), (6, 2, 1)]),
]


def _lattice(shape, offsets):
    return Lattice(shape, offsets)


def _div(q, m, s):
    q = np.asarray(q, np.uint64)
    out = ((q * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)
    return (q if m == 0 else out).astype(np.int64)


class Walk:
    """``cc.link_words`` decoded as ``csrc/cc.cu`` ``make_cc_walk`` reads
    them."""

    def __init__(self, words):
        w = words.astype(np.int64)
        self.L, self.t, self.nt = list(w[0:3]), list(w[3:6]), list(w[6:9])
        self.n_nb, self.fast_d = int(w[9]), int(w[10])
        self.off = w[11:29].reshape(6, 3)
        self.res = w[29:47].reshape(6, 3)
        self.div = words[47:57].view(np.uint32).astype(np.int64).reshape(5, 2)
        self.C, self.bs = int(w[57]), int(w[58])
        self.k3 = self.L[2] > 1
        self.sites = int(np.prod(self.t))
        self.whole = int(np.prod(self.nt)) == 1


class Model:
    """The kernels' index arithmetic over numpy arrays."""

    def __init__(self, lat, tile, cluster=1):
        self.lat = lat
        self.w = Walk(cc.link_words(lat, tile, cluster))

    def slabs(self):
        """The whole-graph form's slabs ``(lo, sites)``, one a CTA of the
        cluster (the tiled form: one, of the box's sites)."""
        w = self.w
        if not w.whole:
            return [(0, w.sites)]
        n = self.lat.n_spins
        return [(q * w.bs, max(0, min(w.bs, n - q * w.bs))) for q in range(w.C)]

    def box(self, bx):
        w = self.w
        if w.whole:
            return [0, 0, 0], list(w.L)
        i0 = int(_div(bx, *w.div[2]))
        r = bx - i0 * w.nt[1] * w.nt[2]
        i1 = int(_div(r, *w.div[3]))
        i = (i0, i1, r - i1 * w.nt[2])
        o = [i[k] * w.t[k] for k in range(3)]
        return o, [min(w.t[k], w.L[k] - o[k]) for k in range(3)]

    def coords(self, l):
        w = self.w
        l = np.asarray(l, np.int64)
        x0 = _div(l, *w.div[0])
        r = l - x0 * w.t[1] * w.t[2]
        if w.k3:
            x1 = _div(r, *w.div[1])
            return np.stack([x0, x1, r - x1 * w.t[2]], -1)
        return np.stack([x0, r, np.zeros_like(r)], -1)

    def inside(self, e, x):
        return (x[..., 0] < e[0]) & (x[..., 1] < e[1]) & (x[..., 2] < e[2])

    def site(self, o, x):
        w = self.w
        return ((o[0] + x[..., 0]) * w.L[1] + o[1] + x[..., 1]) * w.L[2] + o[2] + x[..., 2]

    def step(self, e, x, d):
        """Box index of the neighbour at offset d, -1 where it leaves."""
        w = self.w
        y, out = [], np.zeros(x.shape[:-1], bool)
        for k in range(3 if w.k3 else 2):
            if w.whole or w.nt[k] == 1:
                v = x[..., k] + w.res[d][k]
                v = np.where(v >= w.L[k], v - w.L[k], v)
            else:
                v = x[..., k] + w.off[d][k]
                out |= (v < 0) | (v >= e[k])
            y.append(v)
        if not w.k3:
            y.append(np.zeros_like(y[0]))
        l = (y[0] * w.t[1] + y[1]) * w.t[2] + y[2]
        return np.where(out, -1, l)

    def neighbour(self, o, x, d):
        w = self.w
        y = []
        for k in range(3):
            v = o[k] + x[..., k] + w.res[d][k]
            y.append(np.where(v >= w.L[k], v - w.L[k], v))
        return (y[0] * w.L[1] + y[1]) * w.L[2] + y[2]

    def link(self, state, threads, order_rng=None):
        """cc_link over every box (tiled) or every slab (the whole graph
        over a cluster) of one graph (state bytes [n]): the box or slab
        roots as sites (the labels where one CTA holds the graph)."""
        w = self.w
        n = self.lat.n_spins
        out = np.full(n, -1, np.int64)
        fa = 2 if w.k3 else 1
        for bx in range(int(np.prod(w.nt))):
            o, e = self.box(bx)
            for lo, sites in self.slabs():
                ls = np.arange(sites)
                # box coordinates (whole: of the slab's sites)
                x = self.coords(lo + ls)
                ins = self.inside(e, x)
                S = np.where(ins, state[np.where(ins, self.site(o, x), 0)], 0)
                P = np.empty(sites, np.int64)
                rounds = -(-sites // threads)
                for it in range(rounds):  # (1) the ballot's runs, warp by warp
                    tid = np.arange(threads)
                    l = it * threads + tid
                    on = l < sites
                    lc = np.clip(l, 0, max(sites - 1, 0))
                    run = (on & (w.fast_d >= 0) & ((S[lc] >> max(w.fast_d, 0)) & 1 == 1)
                           & (x[lc, fa] + 1 < e[fa]) & (l + 1 < sites))
                    for t in range(threads):
                        if not on[t]:
                            continue
                        first = t
                        if w.fast_d >= 0:
                            while first % 32 and run[first - 1]:
                                first -= 1
                        P[l[t]] = l[t] - (t - first)

                def root(v):
                    while P[v] != v:
                        v = P[v]
                    return v
                for it in range(rounds):  # (2) a round's unions, then its finds
                    ts = np.arange(threads)
                    if order_rng is not None:
                        order_rng.shuffle(ts)
                    for t in ts:
                        l = it * threads + t
                        if l >= sites or not S[l]:
                            continue
                        for d in range(w.n_nb):
                            if not (S[l] >> d) & 1:
                                continue
                            if (d == w.fast_d and x[l, fa] + 1 < e[fa] and t % 32 != 31
                                    and l + 1 < sites):
                                continue
                            j = int(self.step(e, x[l], d))
                            if w.whole:
                                j = j - lo if 0 <= j - lo < sites else -1
                            if j >= 0:
                                a, b = root(l), root(j)
                                P[max(a, b)] = min(a, b)  # tile_unite: the smaller wins
                    for t in range(threads):
                        l = it * threads + t
                        if l < sites:
                            P[l] = root(l)
                r = np.array([root(v) for v in ls], np.int64)
                if w.whole:
                    out[lo + ls] = lo + r
                else:
                    out[self.site(o, x[ins])] = self.site(o, x[r[ins]])
        assert (out >= 0).all(), "a site no CTA wrote"
        return out

    def label(self, state, threads, order_rng=None):
        """The whole labelling of one graph: cc_link, then where boxes split
        it cc_link_border (unions of box roots) and fk_link_flatten."""
        P = self.link(state, threads, order_rng)
        w = self.w

        def groot(v):
            while P[v] != v:
                v = P[v]
            return v
        if w.whole:
            if w.C == 1:
                return P
            # (2b) the bonds between slabs, united across the cluster
            n = self.lat.n_spins
            x = self.coords(np.arange(n))
            for d in range(w.n_nb):
                j = self.step([0, 0, 0], x, d)
                cross = ((state >> d) & 1 == 1) & (np.arange(n) // w.bs != j // w.bs)
                for a0, b0 in zip(np.nonzero(cross)[0], j[cross]):
                    a, b = groot(int(a0)), groot(int(b0))
                    P[max(a, b)] = min(a, b)
            return np.array([groot(v) for v in range(n)])
        for bx in range(int(np.prod(w.nt))):
            o, e = self.box(bx)
            x = self.coords(np.arange(w.sites))
            x = x[self.inside(e, x)]
            i = self.site(o, x)
            for d in range(w.n_nb):
                cross = ((state[i] >> d) & 1 == 1) & (self.step(e, x, d) < 0)
                for a0, b0 in zip(i[cross], self.neighbour(o, x[cross], d)):
                    a, b = groot(int(P[a0])), groot(int(P[b0]))
                    P[max(a, b)] = min(a, b)
        return np.array([groot(v) for v in range(len(P))])


def _state(bonds):
    return cc.pack_masks(torch.from_numpy(bonds)).numpy().astype(np.int64)


def _bonds(lat, b, seed):
    rng = np.random.default_rng(seed)
    dens = np.linspace(0.0, 1.0, b)[:, None, None]
    return rng.random((b, lat.n_spins, lat.n_neighbors)) < dens


@pytest.mark.parametrize("name,shape,offsets,tiles", LATTICES, ids=[c[0] for c in LATTICES])
def test_link_words_decode_and_divide_exactly(name, shape, offsets, tiles):
    lat = _lattice(shape, offsets)
    dims = _build.dims3(shape)
    for tile in [dims, *tiles]:
        w = Walk(cc.link_words(lat, tile))
        assert w.L == list(dims) and w.t == list(tile)
        assert w.nt == [-(-a // t) for a, t in zip(dims, tile)]
        assert w.n_nb == lat.n_neighbors
        np.testing.assert_array_equal(w.off[:w.n_nb, :lat.n_dims], lat.offsets)
        np.testing.assert_array_equal(w.res, w.off % np.asarray(dims))
        assert (w.res >= 0).all() and (w.res < np.asarray(dims)).all()
        unit = [0] * (lat.n_dims - 1) + [1]
        want = next((d for d, o in enumerate(lat.offsets.tolist()) if o == unit), -1)
        assert w.fast_d == want == cc.fast_offset(lat.offsets, lat.n_dims)
        ls = np.arange(w.sites)
        for k, dv in enumerate((w.t[1] * w.t[2], w.t[2])):
            np.testing.assert_array_equal(_div(ls, *w.div[k]), ls // dv)
        bxs = np.arange(int(np.prod(w.nt)))
        for k, dv in enumerate((w.nt[1] * w.nt[2], w.nt[2])):
            np.testing.assert_array_equal(_div(bxs, *w.div[2 + k]), bxs // dv)


@pytest.mark.parametrize("name,shape,offsets,tiles", LATTICES, ids=[c[0] for c in LATTICES])
def test_box_mapping_and_neighbours_are_the_lattice_tables(name, shape, offsets, tiles):
    """Every site lies in one box at one box index, in site order; each
    neighbour the link takes inside a box and each one the border takes
    across it is ``Lattice.fwd``'s (each axis wrapped on its own)."""
    lat = _lattice(shape, offsets)
    dims = _build.dims3(shape)
    for tile in [dims, *tiles]:
        m = Model(lat, tile)
        seen = np.zeros(lat.n_spins, np.int64)
        for bx in range(int(np.prod(m.w.nt))):
            o, e = m.box(bx)
            x = m.coords(np.arange(m.w.sites))
            ins = m.inside(e, x)
            i = m.site(o, x[ins])
            np.testing.assert_array_equal(np.diff(i) > 0, True)  # box order is site order
            np.add.at(seen, i, 1)
            for d in range(lat.n_neighbors):
                j = m.step(e, x[ins], d)
                inner = j >= 0
                np.testing.assert_array_equal(m.site(o, m.coords(j[inner])),
                                              lat.fwd[i[inner], d])
                np.testing.assert_array_equal(m.neighbour(o, x[ins], d), lat.fwd[i, d])
                if m.w.whole:
                    assert inner.all()
        np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("name,shape,offsets,tiles", LATTICES, ids=[c[0] for c in LATTICES])
def test_model_labels_are_the_plain_labels(name, shape, offsets, tiles):
    """The whole graph in one box and every tiling: labels bitwise
    ``cluster.connected_components`` at densities 0 to 1, whatever the
    order of a round's unions; the link alone leaves each site its box
    component's minimum."""
    lat = _lattice(shape, offsets)
    dims = _build.dims3(shape)
    b = 5
    bonds = _bonds(lat, b, len(shape) + lat.n_neighbors)
    want = cluster.connected_components(torch.from_numpy(bonds), shape, lat.offsets).numpy()
    order = np.random.default_rng(3)
    for tile, c in [(dims, 1), (dims, 2), (dims, 4), (dims, 8), *((t, 1) for t in tiles)]:
        m = Model(lat, tile, c)
        threads = min(1024, -(-max(s for _, s in m.slabs()) // 32) * 32)
        for g in range(b):
            st = _state(bonds[g:g + 1])[0]
            np.testing.assert_array_equal(m.label(st, threads), want[g], err_msg=str(tile))
            np.testing.assert_array_equal(m.label(st, 32, order), want[g], err_msg=str(tile))
            # the link alone: connected components of the bonds inside boxes
            # (slabs)
            inner = np.zeros_like(bonds[g])
            for bx in range(int(np.prod(m.w.nt))):
                o, e = m.box(bx)
                x = m.coords(np.arange(m.w.sites))
                x = x[m.inside(e, x)]
                for d in range(lat.n_neighbors):
                    j = m.step(e, x, d)
                    i = m.site(o, x)
                    inner[i, d] = j >= 0
                    if m.w.whole:
                        inner[i, d] &= i // m.w.bs == j // m.w.bs
            box_min = cluster.connected_components(
                torch.from_numpy(bonds[g:g + 1] & inner[None]), shape, lat.offsets).numpy()
            np.testing.assert_array_equal(m.link(st, threads), box_min[0])


@pytest.mark.parametrize("shape,offsets,tile", [
    ((8, 16), NNN, (3, 16, 1)), ((8, 16), [[1, 2], [2, 1]], (8, 5, 1)),
    ((8, 8, 8), [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], (4, 4, 8)),
    ((8, 24), GEOMETRY_OFFSETS["triangular"], (8, 24, 1)),
], ids=["nnn", "knight", "3d-table", "tri"])
def test_model_labels_are_the_jax_batch_kernels(shape, offsets, tile):
    """Small graphs against ``connected_components_batch`` in interpret
    mode (offset tables through ``cc_gen_offsets``, the triangular lattice
    through ``tri``), as ``tests/test_cc_batch.py`` runs it on the CPU."""
    ref = RefLattice(list(shape), offsets)
    tri = offsets == GEOMETRY_OFFSETS["triangular"]
    kw = dict(tri=True) if tri else dict(offsets=ccb.cc_gen_offsets(ref))
    kp, ks = ccb.cc_batch_factors(ref, 8)
    b = -(-8 // (kp * ks)) * (kp * ks)
    lat = _lattice(shape, offsets)
    bonds = _bonds(lat, b, 61)
    want = np.asarray(ccb.connected_components_batch(
        jnp.asarray(bonds), shape=shape, kp=kp, ks=ks, interpret=True, **kw))
    for t, c in ((_build.dims3(shape), 1), (_build.dims3(shape), 4), (tile, 1)):
        m = Model(lat, t, c)
        threads = min(1024, -(-max(s for _, s in m.slabs()) // 32) * 32)
        got = np.stack([m.label(_state(bonds[g:g + 1])[0], threads) for g in range(b)])
        np.testing.assert_array_equal(got, want, err_msg=str(t))


@pytest.mark.parametrize("shape,b,tiled,cluster", [
    ((16, 16, 16), 8, False, 8), ((64, 64), 8, False, 8), ((64, 64), 2048, False, 1),
    ((2, 4096), 8, False, 8), ((64, 2, 64), 4, False, 8), ((8, 8, 8), 96, False, 1),
    ((8, 8, 8), 40, False, 2), ((4, 4, 4), 8, False, 1), ((4, 4, 8), 8, False, 2),
    ((256, 256), 1, True, 1), ((32, 32, 32), 8, True, 1), ((2, 4100), 8, True, 1),
    ((96, 96), 8, True, 1), ((128, 128, 128), 8, True, 1),
])
def test_link_plan_picks_the_form_from_the_shape(shape, b, tiled, cluster):
    """One box of the whole graph up to 8192 sites (a fast axis longer than
    a CTA too), over a cluster of up to 8 CTAs while the launch holds fewer
    than 132 (slabs of at least 64 sites), else fk_link's tiles; CTAs of at
    most 1024 threads, a multiple of 32, no more than a box's or slab's
    sites need and enough for 8 a thread; the launches each form names."""
    dims = _build.dims3(shape)
    plan = cc.link_plan(dims, b)
    assert plan.tiled == tiled == (int(np.prod(shape)) > cc.LINK_TILE_SITES)
    assert plan.cluster == cluster
    boxsites = int(np.prod(plan.tile))
    slab = -(-boxsites // plan.cluster)
    assert boxsites <= cc.LINK_TILE_SITES and b * plan.cluster <= max(b, 132)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= cc.LINK_THREADS
    assert slab <= plan.threads * 8 and plan.threads < slab + 32
    if tiled:
        assert plan.tile == fk.link_plan(dims, b).tile
        assert cc.link_launches(shape, b) == {"cc_link": 1, "cc_link_border": 1,
                                              "fk_link_flatten": 1}
    else:
        assert plan.tile == dims
        assert cc.link_launches(shape, b) == {"cc_link": 1}
