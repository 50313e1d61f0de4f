"""The partition and index arithmetic of ``fk_bonds`` and ``fk_bonds_band``
(``csrc/fk.cu`` ``bonds_body``) on the CPU, as
``tests/test_torch_finish_index.py`` models ``fk_finish``'s.

* ``fk.bonds_words`` are ``csrc/band.cuh``'s ``BandWalk`` words of the
  whole periodic lattice (a window of all its rows, no halo), and
  ``fk.bonds_per`` divides a realization's graphs.
* A numpy model of the launch: ``blockIdx.x`` a realization's graphs
  ``per`` at a time, ``y`` the blocks of 256 groups of four sites (a thread
  striding by the grid), ``z`` the realization.  Every (graph, site) is
  written exactly once; each group's coordinates (the multiply-shift
  divisors), its forward neighbours (residues and one compare an axis, on
  the vector path four along the fast axis from the first site's, wrapping
  after ``split`` of them) are the lattice's neighbour table (a band's, in
  window indices, where the bond stays in the window); each bond's Philox
  counter and word are ``rng.bond_uniforms_at``'s; and the groups that take
  the vector path are those of aligned graphs that lie in one row of the
  fast axis.
* The model's state bytes (bond bits and "s differs" bits; at ``inter ==
  1`` the bond an integer comparison of the uniform's word with the
  graph's ``unit_threshold``) are bitwise
  ``fk.fk_state_plain``'s and ``fk.fk_bonds_band_plain``'s on random spins
  and gaussian or +-1 couplings.
* The staged form (``fk_bonds_staged``, the lattices of an offset table):
  ``Lattice.sweep_words`` as its ``BandWalk`` (BCC, FCC, NNN, a 3-offset
  table, a negative axis-0 offset, an offset of length 2 along the fast
  axis, a self-bond), the partition, neighbours and Philox counters
  against ``rng.bond_uniforms_at``, its spread launch (a CTA of n_dirs
  warps, warp d drawing direction d of 32 groups, warp 0 storing) drawing
  every (group, direction) once, and the model's bond bits bitwise
  ``fk_bonds_plain(..., offsets)``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops import fk, rng
from peapods_tpu_torch.ops.cc_band import window_reach
from peapods_tpu_torch.ops.lattice import (GEOMETRY_OFFSETS, BandGeometry, Lattice,
                                           fast_divisor)

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
THREADS = 256
# the resident threads of the card the rule is modelled for (the H100: 132
# SMs x 2048); fk.resident_threads reads them from the card
RESIDENT = 132 * 2048


def _div(n, m, s):
    n = np.asarray(n, np.uint64)
    q = ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)
    return (n if m == 0 else q).astype(np.int64)


class Walk:
    """The words of a ``BandWalk`` (``csrc/band.cuh`` ``make_band_walk``)."""

    def __init__(self, words):
        w = words.astype(np.int64)
        self.rows, self.L1, self.L2, self.nb = (int(x) for x in w[:4])
        self.off = w[4:22].reshape(6, 3)[:self.nb]
        self.L0, self.row0, self.halo, self.hl = (int(x) for x in w[22:26])
        self.res = w[26:50].reshape(6, 4)[:self.nb]
        self.div = words[50:56].view(np.uint32).astype(np.int64).reshape(3, 2)
        self.block = self.L1 * self.L2
        self.n = self.rows * self.block
        self.three = self.L2 > 1
        self.lf = self.L2 if self.three else self.L1


def _coords(g, w0):
    """``band_coords``: the row and (c1, c2) of sites ``w0``."""
    r = _div(w0, *g.div[0])
    p = w0 - r * g.block
    c1 = _div(p, *g.div[1])
    return r, c1, p - c1 * g.L2


def _neighbour(g, w, r, c1, c2, d, band):
    """``band_neighbour`` (+ the row's wrap of the whole lattice): the
    forward neighbour at offset d and whether the bond is drawn."""
    n1 = c1 + g.res[d, 0]
    n1 = np.where(n1 >= g.L1, n1 - g.L1, n1)
    n2 = c2 + g.res[d, 1]
    n2 = np.where(n2 >= g.L2, n2 - g.L2, n2)
    j = w + g.off[d, 0] * g.block + (n1 - c1) * g.L2 + (n2 - c2)
    to = r + g.off[d, 0]
    if band:
        return j, (to >= 0) & (to < g.rows)
    return j + np.where(to >= g.rows, -g.n, np.where(to < 0, g.n, 0)), np.ones_like(j, bool)


def _global_row(g, r, band):
    if not band:
        return r
    gr = g.row0 - g.halo + r
    return np.where(gr < 0, gr + g.L0, np.where(gr >= g.L0, gr - g.L0, gr))


def model(words, band, vec, groups=None):
    """The kernel's work on the groups ``groups`` (default: all): per group
    its path (vector or per site) and per (group, q, d) its site, global
    site, neighbour, whether the bond is drawn, and its Philox counter and
    word."""
    g = Walk(words)
    n_grp = (g.n + 3) // 4
    grp = np.arange(n_grp, dtype=np.int64) if groups is None else np.asarray(groups, np.int64)
    w0 = 4 * grp
    r, c1, c2 = _coords(g, w0)
    gr = _global_row(g, r, band)
    f0 = c2 if g.three else c1
    vector = vec & (f0 + 3 < g.lf)
    sites = np.full((len(grp), 4), -1, np.int64)
    glob = np.full_like(sites, -1)
    nbr = np.full((len(grp), 4, g.nb), -1, np.int64)
    on = np.zeros(nbr.shape, bool)
    ctr = np.full_like(sites, -1)
    word = np.full_like(sites, -1)
    # the vector path: the first site's neighbours, then along the fast axis
    v = np.flatnonzero(vector)
    for d in range(g.nb):
        j, ok = _neighbour(g, w0[v], r[v], c1[v], c2[v], d, band)
        t = f0[v] + (g.res[d, 1] if g.three else g.res[d, 0])
        split = g.lf - np.where(t >= g.lf, t - g.lf, t)
        for q in range(4):
            nbr[v, q, d] = j + q - np.where(q >= split, g.lf, 0)
            on[v, q, d] = ok
    g0 = gr[v] * g.block + (w0[v] - r[v] * g.block)
    for q in range(4):
        sites[v, q] = w0[v] + q
        glob[v, q] = g0 + q
        ctr[v, q] = g0 >> 2
        word[v, q] = q
    # the per-site path: each site's coordinates stepped from the first's
    s = np.flatnonzero(~vector)
    rr, gg, e1, e2 = r[s], gr[s], c1[s], c2[s]
    for q in range(4):
        w = w0[s] + q
        if q:
            e2 = e2 + 1
            wrap2 = e2 == g.L2
            e2 = np.where(wrap2, 0, e2)
            e1 = np.where(wrap2, e1 + 1, e1)
            wrap1 = e1 == g.L1
            e1 = np.where(wrap1, 0, e1)
            rr = np.where(wrap1, rr + 1, rr)
            gg = np.where(wrap1, np.where(gg + 1 == g.L0, 0, gg + 1), gg)
        live = w < g.n
        gid = gg * g.block + e1 * g.L2 + e2 if band else w
        sites[s, q] = np.where(live, w, -1)
        glob[s, q] = np.where(live, gid, -1)
        ctr[s, q] = np.where(live, gid >> 2, -1)
        word[s, q] = np.where(live, gid & 3, -1)
        for d in range(g.nb):
            j, ok = _neighbour(g, w, rr, e1, e2, d, band)
            nbr[s, q, d] = np.where(live, j, -1)
            on[s, q, d] = ok & live
    return dict(walk=g, groups=grp, vector=vector, sites=sites, glob=glob, nbr=nbr, on=on,
                ctr=ctr, word=word)


def launch_cover(n_sites, n_graphs, n_systems, per, max_blocks=65535):
    """How often the launch's threads write each group and each graph: the
    grid (x: a realization's graphs ``per`` at a time; y: the groups'
    blocks, at most ``max_blocks``, a thread striding over the rest; z: the
    realization).  Returns ``([groups], [graphs])``."""
    n_grp = (n_sites + 3) // 4
    gy = min(-(-n_grp // THREADS), max_blocks)
    first = np.arange(gy * THREADS, dtype=np.int64)  # each thread's first group
    seen = np.zeros(n_grp, np.int64)
    k = 0
    while k * gy * THREADS < n_grp:
        g = first + k * gy * THREADS
        seen += np.bincount(g[g < n_grp], minlength=n_grp)
        k += 1
    graphs = np.zeros(n_graphs, np.int64)
    for z in range(n_graphs // n_systems):
        for x in range(n_systems // per):
            graphs[z * n_systems + x * per:][:per] += 1
    return seen, graphs


def _covered(n_sites, n_graphs, n_systems, per, **kw):
    seen, graphs = launch_cover(n_sites, n_graphs, n_systems, per, **kw)
    return bool((seen == 1).all() and (graphs == 1).all())


# (name, shape, triangular, realizations, systems each): config 3, the
# harness, config 2, 32^3 x 16, ragged squares and a ragged box, a 3D
# lattice whose rows of 4 sites straddle, the unsharded 4096^2 x 4
UNSHARDED = [("config3", (256, 256), False, 1, 1), ("harness", (64, 64), False, 128, 16),
             ("config2", (32, 32), True, 1, 8), ("cubic32", (32, 32, 32), False, 1, 16),
             ("6x6", (6, 6), False, 2, 3), ("6x10x4", (6, 10, 4), False, 1, 4),
             ("10x6", (10, 6), True, 2, 2), ("4x6x6", (4, 6, 6), False, 1, 2),
             ("space4096", (4096, 4096), False, 1, 4)]
BIG = 2**20  # above this many sites, index level on a sample of groups


def _sample(n_grp, rng_):
    """Groups of a large lattice: the first and last blocks, every group of
    a row's end, and random ones."""
    return np.unique(np.concatenate([np.arange(2048), np.arange(n_grp - 2048, n_grp),
                                     rng_.integers(0, n_grp, 50000)]))


def _fwd_of(lat, sites):
    """``lat.fwd[sites]``, computed for those sites only."""
    shape = np.asarray(lat.shape)
    c = np.stack(np.unravel_index(sites, lat.shape), -1)
    return np.stack([np.ravel_multi_index(tuple(((c + off) % shape).T), lat.shape)
                     for off in lat.offsets], -1)


@pytest.mark.parametrize("name,shape,tri,d,s", UNSHARDED, ids=[c[0] for c in UNSHARDED])
def test_bonds_words_and_per(name, shape, tri, d, s):
    nd = 3 if tri or len(shape) == 3 else 2
    w = fk.bonds_words(shape, nd)
    g = Walk(w)
    dims = tuple(shape) + (1,) * (3 - len(shape))
    assert (g.rows, g.L1, g.L2, g.nb) == (*dims, nd)
    assert (g.L0, g.row0, g.halo, g.hl) == (dims[0], 0, 0, dims[0])
    np.testing.assert_array_equal(g.off[:, :len(shape)], Lattice(shape, TRI if tri else None).offsets)
    for dd in range(nd):
        o = g.off[dd]
        assert list(g.res[dd]) == [o[1] % g.L1, o[2] % g.L2, -o[1] % g.L1, -o[2] % g.L2]
    assert tuple(g.div[0]) == fast_divisor(g.block) and tuple(g.div[1]) == fast_divisor(g.L2)
    b = d * s
    per = fk.bonds_per(g.n, b, s, RESIDENT)
    # a realization's graphs a thread, halved while the launch is short of
    # RESIDENT threads; one where an odd count stays short
    halved = [s >> k for k in range(32) if s % (1 << k) == 0]
    fits = [p for p in halved if -(-g.n // 4) * (b // p) >= RESIDENT]
    assert s % per == 0 and per == (fits[0] if fits else 1)
    expect = {"config3": 1, "harness": 4, "config2": 1, "cubic32": 1, "space4096": 4}
    if name in expect:
        assert per == expect[name]


@pytest.mark.parametrize("name,shape,tri,d,s", UNSHARDED, ids=[c[0] for c in UNSHARDED])
def test_partition_covers_every_site_and_finds_the_neighbours(name, shape, tri, d, s):
    nd = 3 if tri or len(shape) == 3 else 2
    lat = Lattice(shape, TRI if tri else None)
    words = fk.bonds_words(shape, nd)
    n = lat.n_spins
    vec = n % 4 == 0
    b = d * s
    per = fk.bonds_per(n, b, s, RESIDENT)
    assert _covered(n, b, s, per)
    groups = _sample(n // 4, np.random.default_rng(n)) if n > BIG else None
    m = model(words, False, vec, groups)
    sites, live = m["sites"], m["sites"] >= 0
    if groups is None:  # every site once over the groups
        assert np.array_equal(np.sort(sites[live]), np.arange(n))
    # the global site is the site; counter and word are bond_uniforms_at's
    np.testing.assert_array_equal(m["glob"][live], sites[live])
    np.testing.assert_array_equal(m["ctr"][live], sites[live] // 4)
    np.testing.assert_array_equal(m["word"][live], sites[live] % 4)
    want = lat.fwd[sites[live]] if n <= BIG else _fwd_of(lat, sites[live])
    np.testing.assert_array_equal(m["nbr"][live], want)
    assert m["on"][live].all()
    # the vector path: groups in one row of the fast axis (all of them where
    # its length is a multiple of 4)
    w0 = 4 * m["groups"]
    lf = shape[-1]
    np.testing.assert_array_equal(m["vector"], (w0 % lf) + 3 < lf)
    if lf % 4 == 0:
        assert m["vector"].all()
    else:
        assert 0 < m["vector"].sum() < len(w0)


def test_grid_stride_covers_more_blocks_than_the_grid():
    """A lattice of more blocks of groups than the grid's 65535 (8192^2 has
    65536): each thread strides by the grid over the rest, every group once
    (the stride shown with grids of 1 to 7 blocks)."""
    assert -(-8192 * 8192 // 4 // THREADS) == 65536
    for blocks in range(1, 8):
        assert _covered(6 * THREADS * 4 + 36, 4, 2, 1, max_blocks=blocks)


# band 0 (and the last) of each: (name, shape, offsets, bands, graphs)
BANDS = [("band4096", (4096, 4096), None, 4, 4), ("band128", (128, 128, 128), None, 4, 8),
         ("bandfcc32", (32, 32, 32), GEOMETRY_OFFSETS["fcc"], 4, 8),
         ("band6wide", (12, 6), None, 3, 3), ("band6x6x4", (6, 6, 4), None, 3, 2),
         ("bandtri", (16, 12), TRI, 2, 2), ("band6tri", (6, 6), TRI, 6, 2)]


@pytest.mark.parametrize("name,shape,offsets,ns,gr", BANDS, ids=[c[0] for c in BANDS])
def test_band_partition_counters_and_neighbours(name, shape, offsets, ns, gr):
    lat = Lattice(shape, offsets)
    geom = BandGeometry(lat, ns)
    for band in (geom.bands[0], geom.bands[-1]):
        nw = band.n_window
        vec = nw % 4 == 0 and band.block % 4 == 0
        per = fk.bonds_per(nw, gr, gr, RESIDENT)
        assert _covered(nw, gr, gr, per)
        groups = _sample(nw // 4, np.random.default_rng(nw)) if nw > BIG else None
        m = model(band.words, True, vec, groups)
        sites, live = m["sites"], m["sites"] >= 0
        if groups is None:
            assert np.array_equal(np.sort(sites[live]), np.arange(nw))
        win = band.window_sites()
        np.testing.assert_array_equal(m["glob"][live], win[sites[live]])
        np.testing.assert_array_equal(m["ctr"][live], win[sites[live]] // 4)
        np.testing.assert_array_equal(m["word"][live], win[sites[live]] % 4)
        reach = window_reach(band)
        on = m["on"][live]
        np.testing.assert_array_equal(on, reach[sites[live]])
        nbr = m["nbr"][live]
        gsite = win[sites[live]]
        want = lat.fwd[gsite] if lat.n_spins <= BIG else _fwd_of(lat, gsite)
        for d in range(lat.n_neighbors):
            ok = on[:, d]
            np.testing.assert_array_equal(win[nbr[ok, d]], want[ok, d])
        w0 = 4 * m["groups"]
        fast = shape[2] if len(shape) == 3 else shape[1]
        np.testing.assert_array_equal(m["vector"], vec & ((w0 % fast) + 3 < fast))
        if name in ("band4096", "band128", "bandfcc32"):
            assert m["vector"].all()
        if name in ("band6wide", "band6tri"):  # rows of 6 sites: every group per site
            assert not m["vector"].any()


def unit_threshold(t):
    """``csrc/fk.cu`` ``unit_threshold``: int64 ``ceil(p1 2^24)`` of ``p1 =
    1 - exp(-2 * 1 / T)`` (f32), clipped to 2^24; 0 where p1 is not above
    0."""
    p1 = 1.0 - torch.exp(-2.0 * torch.ones_like(t) / t)
    thr = torch.clamp(torch.ceil(p1 * 16777216.0), max=16777216.0)
    return torch.where(p1 > 0, thr, torch.zeros_like(thr)).to(torch.int64)


def _state_from_model(m, spins, j, temps, kb, nd_bits):
    """State bytes ``[G, n]`` from the model's indices, the arithmetic of
    the kernel in torch f32 (p kept for inter == 1, computed as for any
    other bond)."""
    g = m["walk"]
    G = spins.shape[0]
    out = np.zeros((G, g.n), np.uint8)
    sites, live = m["sites"], m["sites"] >= 0
    s = spins.to(torch.float32)
    kbl = kb.to(torch.int64) & 0xFFFFFFFF
    for q in range(4):
        lv = live[:, q]
        w = torch.from_numpy(sites[lv, q])
        st = torch.zeros((G, len(w)), dtype=torch.uint8)
        si = s[:, w]
        ctr = torch.from_numpy(m["ctr"][lv, q])
        word = torch.from_numpy(m["word"][lv, q])
        for d in range(g.nb):
            ok = torch.from_numpy(m["on"][lv, q, d])
            jn = torch.from_numpy(np.where(m["on"][lv, q, d], m["nbr"][lv, q, d], 0))
            sf = s[:, jn]
            inter = si * sf * j[:, w, d]
            t = temps[:, None]
            dd = torch.full_like(ctr, d)
            zero = torch.zeros_like(ctr)
            words = torch.stack(rng.philox4x32(kbl[:, 0:1], kbl[:, 1:2], dd, ctr, zero, zero), -1)
            uw = words.gather(-1, word.expand(G, -1)[..., None])[..., 0]
            drawn = rng.uniform24(uw) < 1.0 - torch.exp(-2.0 * inter / t)
            bond = torch.where(inter == 1.0, (uw >> 8) < unit_threshold(t),
                               (inter > 0) & drawn) & ok
            st |= bond.to(torch.uint8) << d
            if nd_bits:
                st |= ((si != sf) & ok).to(torch.uint8) << (3 + d)
        out[:, w.numpy()] = st.numpy()
    return torch.from_numpy(out)


MODEL_UNSHARDED = [c for c in UNSHARDED if c[0] in ("6x6", "6x10x4", "10x6", "4x6x6", "config2")]


@pytest.mark.parametrize("coup", ["gauss", "pm"])
@pytest.mark.parametrize("name,shape,tri,d,s", MODEL_UNSHARDED,
                         ids=[c[0] for c in MODEL_UNSHARDED])
def test_model_state_bytes_match_plain(name, shape, tri, d, s, coup):
    nd = 3 if tri or len(shape) == 3 else 2
    n = int(np.prod(shape))
    r = np.random.default_rng(n + d + s)
    b = d * s
    spins = torch.from_numpy(r.choice([-1, 1], size=(b, *shape)).astype(np.int8))
    j = (r.standard_normal((d, n, nd)) if coup == "gauss"
         else r.choice([-1.0, 1.0], size=(d, n, nd)))
    j = torch.from_numpy(j.astype(np.float32))
    temps = torch.from_numpy(r.uniform(0.5, 4.0, b).astype(np.float32))
    kb = torch.from_numpy(r.integers(-2**31, 2**31, (b, 2)).astype(np.int32))
    m = model(fk.bonds_words(shape, nd), False, n % 4 == 0)
    jg = j.repeat_interleave(s, 0)
    got = _state_from_model(m, spins.view(b, n), jg, temps, kb, True)
    assert torch.equal(got, fk.fk_state_plain(spins, j, temps, kb))


@pytest.mark.parametrize("name,shape,offsets,ns,gr", [c for c in BANDS if c[0] not in (
    "band4096", "band128")], ids=[c[0] for c in BANDS if c[0] not in ("band4096", "band128")])
def test_band_model_state_bytes_match_plain(name, shape, offsets, ns, gr):
    lat = Lattice(shape, offsets)
    r = np.random.default_rng(lat.n_spins + ns)
    for band in BandGeometry(lat, ns).bands:
        nw, nb = band.n_window, lat.n_neighbors
        spins = torch.from_numpy(r.choice([-1, 1], size=(gr, nw)).astype(np.int8))
        j = torch.from_numpy(r.standard_normal((1, nw, nb)).astype(np.float32))
        temps = torch.from_numpy(r.uniform(0.5, 8.0, gr).astype(np.float32))
        kb = torch.from_numpy(r.integers(-2**31, 2**31, (gr, 2)).astype(np.int32))
        m = model(band.words, True, nw % 4 == 0 and band.block % 4 == 0)
        got = _state_from_model(m, spins, j.expand(gr, -1, -1), temps, kb, nb <= 3)

        buf = SimpleNamespace(state=torch.empty((gr, nw), dtype=torch.uint8))
        fk.fk_bonds_band_plain(spins, j, temps, kb, buf, band)
        assert torch.equal(got, buf.state)


def test_unit_threshold_is_the_bond_comparison():
    """``unit_threshold``'s integer comparison ``x < ceil(p1 2^24)`` of a
    uniform's 24-bit word x is ``uniform24 < p1`` with ``p1 = 1 - exp(-2 *
    1 / T)``, the per-bond expression at inter == 1 (f32, the same
    operation order), at every word near the threshold and at both ends,
    for temperatures from 0.01 (p1 rounds to 1) to 1e4, and where p1 is NaN
    (T = NaN: no bond)."""
    t = torch.from_numpy(np.concatenate([np.geomspace(0.01, 1e4, 20001), [np.nan]]).astype(
        np.float32))[:, None]
    thr = unit_threshold(t)
    p1 = 1.0 - torch.exp(-2.0 * torch.ones_like(t) / t)
    x = (thr + torch.arange(-3, 4)).clamp(0, 2**24 - 1)
    x = torch.cat([x, torch.zeros_like(thr), torch.full_like(thr, 2**24 - 1)], 1)
    u = (x << 8) | 0xAB  # the uniform's low 8 bits are dropped
    assert torch.equal((u >> 8) < thr, rng.uniform24(u) < p1)
    assert int(thr[0]) == 2**24 and int(thr[-1]) == 0


# ---------------------------------------------------------------- staged form
#
# fk_bonds_staged (csrc/fk.cu): bonds_body's whole-lattice form on a lattice
# given by its offset table, with the words of Lattice.sweep_words (each
# offset's axis-0 component reduced into [0, L0): the body's one-compare
# wrap of axis 0 then holds for offsets as long as the lattice, the
# self-bond of an offset [2, 0] on two rows among them), and no "s
# differs" bits.  (name, shape, offsets, realizations, systems each): the
# smoke's BCC / FCC 16^3 x 8 and NNN 64^2 x 8, the 2 x 8 lattices of the
# card tests, a 3-offset table, a table with a negative axis-0 offset, and
# one with an offset of length 2 along the fast axis.
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
STAGED = [("bcc16", (16, 16, 16), GEOMETRY_OFFSETS["bcc"], 1, 8),
          ("fcc16", (16, 16, 16), GEOMETRY_OFFSETS["fcc"], 1, 8),
          ("nnn64", (64, 64), NNN, 1, 8), ("nnn2x8", (2, 8), NNN, 2, 3),
          ("self-bond-2x8", (2, 8), [[1, 0], [0, 1], [2, 0]], 2, 3),
          ("three-6x8x4", (6, 8, 4), [[1, 0, 0], [0, 1, 1], [1, -1, 2]], 2, 2),
          ("neg0-8x12", (8, 12), [[-1, 2], [0, 1]], 1, 4),
          ("len2-6x10", (6, 10), [[0, 2], [1, 0], [1, -2]], 2, 2),
          ("fcc-6x4x6", (6, 4, 6), GEOMETRY_OFFSETS["fcc"], 1, 3)]
STAGED_IDS = [c[0] for c in STAGED]


@pytest.mark.parametrize("name,shape,offsets,d,s", STAGED, ids=STAGED_IDS)
def test_staged_words(name, shape, offsets, d, s):
    lat = Lattice(shape, offsets)
    g = Walk(lat.sweep_words)
    dims = tuple(shape) + (1,) * (3 - len(shape))
    assert (g.rows, g.L1, g.L2, g.nb) == (*dims, lat.n_neighbors)
    assert (g.L0, g.row0, g.halo, g.hl) == (dims[0], 0, 0, dims[0])
    off = np.zeros((lat.n_neighbors, 3), np.int64)
    off[:, :len(shape)] = lat.offsets
    np.testing.assert_array_equal(g.off[:, 0], off[:, 0] % dims[0])
    np.testing.assert_array_equal(g.off[:, 1:], off[:, 1:])
    for dd in range(lat.n_neighbors):
        o = off[dd]
        assert list(g.res[dd]) == [o[1] % g.L1, o[2] % g.L2, -o[1] % g.L1, -o[2] % g.L2]
    assert tuple(g.div[0]) == fast_divisor(g.block) and tuple(g.div[1]) == fast_divisor(g.L2)
    # the smoke's 8 graphs of 16^3 or 64^2: one graph a thread
    per = fk.bonds_per(lat.n_spins, d * s, s, RESIDENT)
    assert s % per == 0
    if name in ("bcc16", "fcc16", "nnn64"):
        assert per == 1


@pytest.mark.parametrize("name,shape,offsets,d,s", STAGED, ids=STAGED_IDS)
def test_staged_partition_counters_and_neighbours(name, shape, offsets, d, s):
    lat = Lattice(shape, offsets)
    n = lat.n_spins
    vec = n % 4 == 0
    b = d * s
    assert _covered(n, b, s, fk.bonds_per(n, b, s, RESIDENT))
    m = model(lat.sweep_words, False, vec)
    sites, live = m["sites"], m["sites"] >= 0
    assert np.array_equal(np.sort(sites[live]), np.arange(n))
    np.testing.assert_array_equal(m["glob"][live], sites[live])
    np.testing.assert_array_equal(m["nbr"][live], lat.fwd[sites[live]])
    assert m["on"][live].all()
    # each bond's Philox counter and word give bond_uniforms_at's uniform
    kb = torch.from_numpy(np.random.default_rng(n).integers(-2**31, 2**31, (2, 2)).astype(
        np.int32))
    kbl = kb.to(torch.int64) & 0xFFFFFFFF
    ctr = torch.from_numpy(m["ctr"][live])
    word = torch.from_numpy(m["word"][live])
    want = rng.bond_uniforms_at(kb, torch.from_numpy(sites[live]), lat.n_neighbors)
    zero = torch.zeros_like(ctr)
    for dd in range(lat.n_neighbors):
        w = torch.stack(rng.philox4x32(kbl[:, 0:1], kbl[:, 1:2], torch.full_like(ctr, dd),
                                       ctr, zero, zero), -1)
        u = rng.uniform24(w.gather(-1, word.expand(2, -1)[..., None])[..., 0])
        assert torch.equal(u, want[..., dd])
    # the vector path: groups of aligned graphs in one row of the fast axis
    fast = shape[-1]
    w0 = 4 * m["groups"]
    np.testing.assert_array_equal(m["vector"], vec & ((w0 % fast) + 3 < fast))
    if fast % 4 == 0:
        assert m["vector"].all()


@pytest.mark.parametrize("coup", ["gauss", "pm"])
@pytest.mark.parametrize("name,shape,offsets,d,s", [c for c in STAGED if c[0] not in (
    "bcc16", "fcc16")], ids=[c for c in STAGED_IDS if c not in ("bcc16", "fcc16")])
def test_staged_model_bond_bits_match_plain(name, shape, offsets, d, s, coup):
    """The model's state bytes are the bonds alone, bit ``k`` bitwise
    ``fk_bonds_plain(..., offsets)``'s bond along offset ``k``."""
    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    r = np.random.default_rng(n + nb)
    b = d * s
    spins = torch.from_numpy(r.choice([-1, 1], size=(b, *shape)).astype(np.int8))
    j = (r.standard_normal((d, n, nb)) if coup == "gauss"
         else r.choice([-1.0, 1.0], size=(d, n, nb)))
    j = torch.from_numpy(j.astype(np.float32))
    temps = torch.from_numpy(r.uniform(0.5, 8.0, b).astype(np.float32))
    kb = torch.from_numpy(r.integers(-2**31, 2**31, (b, 2)).astype(np.int32))
    m = model(lat.sweep_words, False, n % 4 == 0)
    got = _state_from_model(m, spins.view(b, n), j.repeat_interleave(s, 0), temps, kb, False)
    bonds = fk.fk_bonds_plain(spins, j, temps, kb, offsets=lat.offsets)
    want = (bonds.to(torch.uint8) << torch.arange(nb, dtype=torch.uint8)).sum(-1, dtype=torch.uint8)
    assert torch.equal(got, want)
    assert torch.equal(fk.state_masks(got, nb), bonds)


def spread_cover(n_sites, n_dirs, max_blocks=65535):
    """The staged form's spread launch (``bonds_body``'s kSpread, one graph
    a thread): a CTA of ``n_dirs`` warps takes 32 groups at a time, warp
    ``d`` drawing direction ``d`` of its lane's group, the grid's y blocks
    striding over the rest; warp 0 stores each group.  Returns ``(drawn
    [groups, n_dirs], stored [groups])``, the count of each."""
    n_grp = (n_sites + 3) // 4
    gy = min(-(-n_grp // 32), max_blocks)
    drawn = np.zeros((n_grp, n_dirs), np.int64)
    stored = np.zeros(n_grp, np.int64)
    lane = np.arange(32)
    for y in range(gy):
        g0 = y * 32
        while g0 < n_grp:  # the CTA's iterations, the same in every warp
            g = g0 + lane
            live = g[g < n_grp]
            for d in range(n_dirs):
                drawn[live, d] += 1
            stored[live] += 1
            g0 += gy * 32
    return drawn, stored


@pytest.mark.parametrize("n_sites,n_dirs,max_blocks", [
    (4096, 6, 65535), (4096, 4, 65535), (16, 3, 65535), (144, 6, 65535), (36, 1, 65535),
    (4 * 32 * 7 + 12, 5, 3)], ids=["fcc16", "bcc16", "2x8", "6x4x6", "6x6", "strided"])
def test_staged_spread_draws_every_direction_once(n_sites, n_dirs, max_blocks):
    drawn, stored = spread_cover(n_sites, n_dirs, max_blocks)
    assert (drawn == 1).all() and (stored == 1).all()


@pytest.mark.parametrize("name,shape,offsets,d,s", STAGED, ids=STAGED_IDS)
def test_staged_small_launches_spread(name, shape, offsets, d, s):
    """The spread launch is taken where one graph is a thread's
    (``bonds_per`` 1): the smoke's 8 graphs of 16^3 and 64^2, whose launch
    of 8192 threads would hold 32 CTAs, become 256 CTAs of n_dirs warps."""
    n = int(np.prod(shape))
    per = fk.bonds_per(n, d * s, s, RESIDENT)
    if name in ("bcc16", "fcc16", "nnn64"):
        assert per == 1
        n_dirs = len(offsets)
        assert -(-n // 4 // 32) * (d * s) == 256
        assert -(-n // 4 // 256) * (d * s) == 32 and 32 * n_dirs <= THREADS
