"""The table form's launch plans and models of its two redesigned kernels
(``csrc/cc.cu`` ``cc_table_link`` / ``cc_table_border``,
``csrc/sweep_nb.cu`` ``sweep_nb_table``), from the shape alone:

* ``cc.table_link_plan`` over a grid of shapes (4D 10^4 and 16^4, 5D 6^5,
  odd 9^4, extent-1 axes, 16^3 with 9, 13 and 32 offsets, 32^4) and 1 to
  384 graphs: every site in exactly one slab, shared memory at most 232,448
  bytes a CTA, a cluster of at most 8 CTAs (the portable limit), the
  launches ``cc.table_link_launches`` names, and ``table_link_words``'
  slab divisor;
* a sequential model of the labelling's steps (the unions inside a slab,
  the bonds between slabs) bitwise ``connected_components`` on every form,
  small slabs forced;
* ``sweep.table_sweep_plan`` (systems a thread, a CTA's threads) and the
  lattice's per-colour site lists: every (realization, system, site) once,
  and a model of the pass (a thread a site of ``per`` systems, the tables'
  rows and both couplings read once, offsets outermost) bitwise
  ``sweep_nb_plain``.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops import cc
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops import sweep as tsweep
from peapods_tpu_torch.ops.cluster import connected_components
from peapods_tpu_torch.ops.lattice import Lattice

torch.set_num_threads(1)

# the cubic lattice's first shell (3), second (6) and third (4): 13 forward
# offsets; the first two: 9
SHELLS3 = ([[1, 0, 0], [0, 1, 0], [0, 0, 1]]
           + [[1, s, 0] for s in (1, -1)] + [[1, 0, s] for s in (1, -1)]
           + [[0, 1, s] for s in (1, -1)]
           + [[1, a, b] for a in (1, -1) for b in (1, -1)])
# 32 offsets of a 3D lattice: the 13 above and 19 longer ones
LONG32 = SHELLS3 + [[2, 0, 0], [0, 2, 0], [0, 0, 2]] + [
    [2, a, 0] for a in (1, -1)] + [[2, 0, a] for a in (1, -1)] + [
    [0, 2, a] for a in (1, -1)] + [[a, 2, 0] for a in (1, -1)] + [
    [a, 0, 2] for a in (1, -1)] + [[0, a, 2] for a in (1, -1)] + [
    [2, 2, 0], [2, 0, 2], [2, -2, 0], [2, 0, -2]]
# (name, sites, offsets) of the plan grid
PLAN_SHAPES = [
    ("4d10", 10 ** 4, 4), ("4d16", 16 ** 4, 4), ("5d6", 6 ** 5, 5), ("4d9", 9 ** 4, 4),
    ("1x3x3x3", 27, 4), ("1x1x16x16", 256, 4), ("shells9", 16 ** 3, 9),
    ("shells13", 16 ** 3, 13), ("long32", 16 ** 3, 32), ("4d32", 32 ** 4, 4),
]
GRAPHS = [1, 2, 8, 16, 24, 192, 384]
SMEM = 232448


@pytest.mark.parametrize("graphs", GRAPHS)
@pytest.mark.parametrize("name,n,nb", PLAN_SHAPES)
def test_table_link_plan(name, n, nb, graphs):
    """Every site in exactly one slab; a CTA's shared memory and threads and
    a graph's cluster within the card's limits; the launches the plan
    names."""
    plan = cc.table_link_plan(n, nb, graphs)
    assert plan.smem == plan.slab * (4 + cc.table_state_bytes(nb)) <= SMEM
    assert 1 <= plan.cluster <= 8 and plan.cluster & (plan.cluster - 1) == 0
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    slabs = -(-n // plan.slab)
    if plan.slabs:
        assert plan.cluster == 1 and slabs > 8
    else:
        assert slabs == plan.cluster
    owner = np.arange(n) // plan.slab
    assert np.array_equal(np.bincount(owner, minlength=slabs),
                          [min(plan.slab, n - q * plan.slab) for q in range(slabs)])
    assert (np.bincount(owner) > 0).all()
    want = ({"cc_table_link": 1, "cc_table_border": 1, "fk_link_flatten": 1} if plan.slabs
            else {"cc_table_link": 1})
    assert cc.table_link_launches(n, nb, graphs) == want


def test_table_link_plan_forms():
    """The forms the shapes of the smoke's runs take: the 4D glass one CTA
    a graph, 16^4 x 16 a cluster of 8, 16^3 with 13 offsets x 8 one CTA,
    32^4 slabs."""
    glass = cc.table_link_plan(10 ** 4, 4, 384)
    assert (glass.cluster, glass.slab, glass.slabs, glass.threads) == (1, 10 ** 4, False, 1024)
    assert cc.table_link_plan(10 ** 4, 4, 8)[:2] == (2, 5000)
    assert cc.table_link_plan(16 ** 4, 4, 16)[:2] == (8, 8192)
    assert cc.table_link_plan(16 ** 3, 13, 8)[:2] == (1, 4096)
    big = cc.table_link_plan(32 ** 4, 4, 2)
    assert big.slabs and big.slab * (4 + 1) <= SMEM
    # the fewest CTAs a graph of 16^4 can take: 2 (65,536 sites x 5 B)
    assert cc.table_link_plan(16 ** 4, 4, 384).cluster == 2


@pytest.mark.parametrize("shape,offsets,graphs", [
    ((10, 10, 10, 10), None, 384), ((3, 1, 3, 3), None, 2), ((6, 6, 6), SHELLS3, 8),
])
def test_table_link_words(shape, offsets, graphs):
    """The host words: the plan's fields and the slab's multiply-shift
    divisor, exact over the graph's sites."""
    lat = Lattice(shape, offsets)
    plan = cc.table_link_plan(lat.n_spins, lat.n_neighbors, graphs)
    w = cc.table_link_words(lat, graphs).view(np.uint32).astype(np.int64)
    assert list(w[[0, 1, 2, 3, 6, 7]]) == [lat.n_spins, lat.n_neighbors, plan.cluster,
                                           plan.slab, int(plan.slabs), plan.threads]
    v = np.arange(lat.n_spins, dtype=np.int64)
    q = ((v * w[4]) >> 32) >> w[5] if w[4] else v
    assert np.array_equal(q, v // plan.slab)


def model_table_link(state, fwd, plan):
    """The labelling's steps in order, one thread after another: per slab
    the slab's bonds united (the smaller root wins), its sites' slab roots
    as site indices; then the bonds that leave a slab united across the
    graph, and each site's root."""
    b, n = state.shape
    nb = fwd.shape[1]
    out = np.empty((b, n), np.int32)

    def root(p, x):
        while p[x] != x:
            x = p[x]
        return x

    def unite(p, x, y):
        x, y = root(p, x), root(p, y)
        if x != y:
            p[max(x, y)] = min(x, y)

    for g in range(b):
        s_all = state[g]
        par = np.empty(n, np.int64)
        slab = plan.slab
        for lo in range(0, n, slab):
            sites = min(slab, n - lo)
            p = np.arange(sites)
            for l in range(sites):
                i = lo + l
                for d in range(nb):
                    j = int(fwd[i, d])
                    if (s_all[i] >> d) & 1 and lo <= j < lo + sites:
                        unite(p, l, j - lo)
            for l in range(sites):
                par[lo + l] = lo + root(p, l)
        for i in range(n):
            for d in range(nb):
                j = int(fwd[i, d])
                if (s_all[i] >> d) & 1 and j // slab != i // slab:
                    unite(par, i, j)
        out[g] = [root(par, i) for i in range(n)]
    return out


@pytest.mark.parametrize("shape,offsets,slab,p", [
    ((4, 4, 4, 4), None, None, 0.30), ((4, 4, 4, 4), None, 100, 0.30),
    ((4, 4, 4, 4), None, 37, 0.55), ((3, 1, 3, 3), None, 10, 0.6),
    ((6, 6, 6), SHELLS3, None, 0.12), ((6, 6, 6), SHELLS3, 64, 0.12),
    ((5, 5, 5), LONG32, 50, 0.05),
])
def test_table_link_model(shape, offsets, slab, p):
    """The model of the labelling, on the plan's slabs or smaller ones
    forced (the slab and cluster forms' bonds between slabs), bitwise
    ``connected_components``, at densities below and above percolation."""
    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    rng = np.random.default_rng(27)
    masks = torch.from_numpy(rng.random((3, n, nb)) < p)
    state = cc.pack_masks(masks, torch.int32).numpy().view(np.uint32)
    plan = cc.table_link_plan(n, nb, 3)
    if slab is not None:
        plan = plan._replace(slab=slab, slabs=True, cluster=1)
    got = model_table_link(state, lat.fwd, plan)
    want = connected_components(masks, lat.shape, lat.offsets).numpy()
    assert np.array_equal(got, want)


# (sites of the colour, realizations, systems, threads, SMs)
SWEEP_SHAPES = [(5000, 16, 24), (32768, 1, 16), (512, 1, 8), (3888, 4, 8), (6561 // 2, 1, 1),
                (1, 1, 1), (2048, 384, 1), (100, 2, 48)]


@pytest.mark.parametrize("count,d,s", SWEEP_SHAPES)
def test_table_sweep_plan(count, d, s):
    """Systems a thread a divisor of the systems, at most 8; CTAs of 32 to
    256 threads, as large as keeps at least an SM's worth of CTAs; the grid
    covering every (realization, system, site of the colour) once."""
    threads, sms = 132 * 2048 // 2, 132
    plan = tsweep.table_sweep_plan(count, d, s, threads, sms)
    assert s % plan.per == 0 and 1 <= plan.per <= 8
    assert plan.per == tsweep.systems_per(count, d, s, threads)
    assert plan.threads in (32, 64, 128, 256)
    ctas = -(-count // plan.threads) * d * (s // plan.per)
    assert ctas >= sms or plan.threads == 32
    if plan.threads < 256:
        assert -(-count // (2 * plan.threads)) * d * (s // plan.per) < sms
    grid = np.zeros((d, s, count), np.int64)
    for bx in range(-(-count // plan.threads)):
        t = bx * plan.threads + np.arange(plan.threads)
        t = t[t < count]
        for y in range(s // plan.per):
            grid[:, y * plan.per:(y + 1) * plan.per, t] += 1
    assert (grid == 1).all()


@pytest.mark.parametrize("shape,offsets", [
    ((4, 4, 4, 4), None), ((3, 3, 3, 3), None), ((1, 3, 3, 3), None), ((4, 4, 4), SHELLS3),
    ((2, 3, 4, 5), None),
])
def test_colour_sites(shape, offsets):
    """Each colour's list holds its sites in index order, and the lists
    together every site once."""
    lat = Lattice(shape, offsets)
    sites, starts = lat.colour_sites
    assert sites.dtype == np.int32 and starts[0] == 0 and starts[-1] == lat.n_spins
    assert np.array_equal(np.sort(sites), np.arange(lat.n_spins))
    for c in range(lat.n_colors):
        run = sites[starts[c]:starts[c + 1]]
        assert np.array_equal(run, np.flatnonzero(lat.colors == c))
    assert torch.equal(lat.device_colour_sites("cpu"), torch.from_numpy(sites))
    assert lat.device_colour_sites("cpu") is lat.device_colour_sites(torch.device("cpu"))


def model_table_sweep(spins, coup, temps, words, lat, per, gibbs):
    """A sweep as ``sweep_nb_table`` runs it, colour by colour: a thread a
    site of the colour's list for ``per`` systems, the site's table rows
    and both couplings read once, each system's field summed over the
    offsets in order (forward term, then backward), self offsets left out;
    Philox word ``i % 4`` of the block ``(system, colour, i // 4, 0)``."""
    d, s, n = spins.shape
    fwd = torch.from_numpy(lat.fwd).long()
    bwd = torch.from_numpy(lat.bwd).long()
    sites_all, starts = lat.colour_sites
    for c in range(lat.n_colors):
        sites = torch.from_numpy(sites_all[starts[c]:starts[c + 1]]).long()
        u = trng.site_uniforms(words, s, c, n)[..., sites]
        new = spins.clone()
        for y in range(s // per):
            sys = slice(y * per, (y + 1) * per)
            sv = spins[:, sys].to(torch.float32)
            h = torch.zeros((d, per, len(sites)))
            for k in range(lat.n_neighbors):
                if lat.self_bonds[k]:
                    continue
                f, b = fwd[sites, k], bwd[sites, k]
                jf = coup[:, sites, k][:, None]
                jb = coup[:, b, k][:, None]
                h = h + sv[..., f] * jf
                h = h + sv[..., b] * jb
            s_i = sv[..., sites]
            eng = -s_i * h
            t = temps[:, sys][..., None]
            uu = u[:, sys]
            if gibbs:
                flip = eng >= (t * 0.5) * torch.log(uu / (1.0 - uu))
            else:
                flip = uu < 0.9375 * torch.exp(torch.clamp(eng * (1.0 / (t * 0.5)), max=0.0))
            new[:, sys, sites] = torch.where(flip, -s_i, s_i).to(torch.int8)
        spins = new
    return spins


@pytest.mark.parametrize("gibbs", [False, True])
@pytest.mark.parametrize("shape,offsets,d,s", [
    ((4, 4, 4, 4), None, 2, 6), ((3, 3, 3, 3), None, 1, 4), ((1, 3, 3, 3), None, 2, 2),
    ((4, 4, 4), SHELLS3, 1, 8), ((4, 4, 4), LONG32, 1, 2),
])
def test_table_sweep_model(shape, offsets, d, s, gibbs):
    """The model of the redesigned pass, at the plan's systems a thread,
    bitwise ``sweep_nb_plain``."""
    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    rng = np.random.default_rng(2027)
    spins = torch.from_numpy(rng.choice([-1, 1], (d, s, n)).astype(np.int8))
    coup = torch.from_numpy(rng.standard_normal((d, n, nb)).astype(np.float32))
    coup_bwd = coup[:, torch.from_numpy(lat.bwd).long(), torch.arange(nb)]
    temps = torch.from_numpy(rng.uniform(0.5, 3.0, (d, s)).astype(np.float32))
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (d, 2)).astype(np.int32))
    count = int(np.diff(lat.colour_sites[1]).min())
    per = tsweep.table_sweep_plan(count, d, s, 64, 132).per
    want = spins.clone()
    tsweep.sweep_nb_plain(want, coup, coup_bwd, torch.from_numpy(lat.colors.astype(np.uint8)),
                          temps, words, lat, gibbs=gibbs)
    got = model_table_sweep(spins, coup, temps, words, lat, per, gibbs)
    assert torch.equal(got, want) and not torch.equal(got, spins)
