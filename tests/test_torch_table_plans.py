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
  ``sweep_nb_plain``;
* ``energy.table_measure_plan`` (``csrc/sweep_nb.cu`` ``measure_nb_table``:
  a group of four sites of ``per`` systems a thread) over the same shapes
  and 1 to 384 systems: every (realization, system, site) once, and a
  model of the measurement's order (each site's terms in offset order, in
  one step or steps of four, the group's sums from 0, the warp's pairing)
  bitwise ``measure_nb_plain(blocks=True)`` at the plan's and every other
  ``per``;
* ``megapair.pair_table_plan`` (``csrc/pairs.cu`` ``pair_overlap_table``:
  a cluster of CTAs staging a realization's disagreement words, or past a
  cluster's shared memory copies of one CTA counting shares of the sites)
  over the shapes and 1 to 130 columns: every (realization, column, site)
  staged and counted once, shared memory and clusters within the card's
  limits, one cluster of 8 CTAs a realization at the 4D glass, houd4 and
  nine16; and a model of the launch (the words, the byte counters and
  their flushes, the cluster's and the copies' sums) bitwise
  ``pair_overlap_table_plain`` on the plan's and forced forms.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops import cc, energy, megapair
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


# -------------------------------------------------- the table measurement

# (realizations, systems a realization) of the measurement's plan grid
SYSTEMS = [(1, 1), (2, 3), (1, 8), (1, 16), (16, 24), (8, 48), (1, 384)]
CARD = dict(threads=132 * 2048 // 8, sms=132)  # an H100: the wrapper's rule


@pytest.mark.parametrize("d,s", SYSTEMS, ids=[f"{d}x{s}" for d, s in SYSTEMS])
@pytest.mark.parametrize("name,n,nb", PLAN_SHAPES)
def test_table_measure_plan(name, n, nb, d, s):
    """Systems a thread a divisor of the systems, at most 8, the largest
    whose launch keeps an eighth of the card's resident threads and a CTA
    an SM; the grid (blocks of 1024 sites, system sets, realizations)
    covering every (realization, system, site) once; static shared memory
    within a CTA's."""
    plan = energy.table_measure_plan(n, d, s, CARD["threads"], CARD["sms"])
    assert s % plan.per == 0 and 1 <= plan.per <= 8
    groups = -(-n // 4)
    blocks = -(-groups // 256)
    assert plan.grid == (blocks, s // plan.per, d)
    assert plan.smem <= SMEM

    def ok(p):
        return (s % p == 0 and groups * d * (s // p) >= CARD["threads"]
                and blocks * d * (s // p) >= CARD["sms"])

    assert plan.per == 1 or ok(plan.per)
    assert not any(ok(p) for p in range(plan.per + 1, 9))
    # thread t of CTA (x, y, z): sites 4 (256 x + t) + k < n of systems y per + q
    taken = np.zeros((d, s), np.int64)
    sites = np.zeros(n, np.int64)
    i0 = 4 * np.arange(blocks * 256)
    live = (i0[:, None] + np.arange(4)[None]).reshape(-1)
    np.add.at(sites, live[live < n], 1)
    assert (sites == 1).all()
    for y in range(s // plan.per):
        taken[:, y * plan.per:(y + 1) * plan.per] += 1
    assert (taken == 1).all()


def test_table_measure_plan_forms():
    """The smoke's runs: the 4D glass 8 systems a thread (480 CTAs), nine16
    8 (192), 16^4 x 16 4 (256), 16^3 with 13 offsets x 8 one (32 CTAs: the
    launch cannot fill the card)."""
    plan = lambda *a: energy.table_measure_plan(*a, CARD["threads"], CARD["sms"])  # noqa: E731
    assert plan(10 ** 4, 16, 24)[:2] == (8, (10, 3, 16))
    assert plan(16 ** 3, 8, 48)[:2] == (8, (4, 6, 8))
    assert plan(16 ** 4, 1, 16)[:2] == (4, (64, 4, 1))
    assert plan(16 ** 3, 1, 8)[:2] == (1, (4, 8, 1))


def warp_tree(x):
    """``csrc/mega.cuh`` ``warp_tree`` of ``x [..., 256]``: each lane's eight
    values paired, then the shuffles' tree."""
    v = (((x[..., 0:32] + x[..., 128:160]) + (x[..., 64:96] + x[..., 192:224]))
         + ((x[..., 32:64] + x[..., 160:192]) + (x[..., 96:128] + x[..., 224:256])))
    off = 16
    while off:
        v = v[..., :off] + v[..., off:2 * off]
        off //= 2
    return v[..., 0]


UNROLLED = (4, 5, 8, 9, 13)  # csrc/sweep_nb.cu: the offset counts unrolled


def model_table_measure(spins, coup, fwd, per):
    """``measure_nb_table`` in numpy, CTA after CTA: a thread the group of
    four sites 4 (256 x + t) of ``per`` systems of one realization, the
    group's table rows and couplings read once for them; each site's e from
    0, its terms (J with its sign flipped where the spins differ) added in
    offset order, in one step at the unrolled counts or steps of four; the
    group's values added from 0 (absent sites none), each block's 256
    group sums paired by the warp; m the group's spins, summed.  Returns
    the partials and the (realization, system, site) counts taken."""
    d, s, n = spins.shape
    nb = fwd.shape[1]
    step = nb if nb in UNROLLED else 4
    blocks = -(-(-(-n // 4)) // 256)
    e_part = np.zeros((d, s, blocks), np.float32)
    m_part = np.zeros((d, s, blocks), np.int64)
    taken = np.zeros((d, s, n), np.int64)
    for x in range(blocks):
        i0 = 4 * (256 * x + np.arange(256))
        cnt = np.clip(n - i0, 0, 4)
        for z in range(d):
            for y in range(s // per):
                for q in range(y * per, (y + 1) * per):
                    sp = spins[z, q]
                    acc = np.zeros(256, np.float32)
                    mag = np.zeros(256, np.int64)
                    for k in range(4):
                        i = np.minimum(i0 + k, n - 1)
                        on = k < cnt
                        e = np.zeros(256, np.float32)
                        for d0 in range(0, nb, step):
                            for dd in range(d0, min(d0 + step, nb)):
                                j = coup[z, i, dd]
                                term = np.where(sp[i] == sp[fwd[i, dd]], j, -j)
                                e = (e + term).astype(np.float32)
                        acc = np.where(on, acc + e, acc).astype(np.float32)
                        mag = mag + np.where(on, sp[i], 0)
                        np.add.at(taken[z, q], i[on], 1)
                    e_part[z, q, x] = warp_tree(acc)
                    m_part[z, q, x] = mag.sum()
    return e_part, m_part, taken


MEASURE_LATTICES = [
    ("4d4", (4, 4, 4, 4), None, 2, 6), ("3^4-tail", (3, 3, 3, 3), None, 1, 4),
    ("1x3x3x3-self", (1, 3, 3, 3), None, 2, 2), ("5d3", (3, 3, 3, 3, 3), None, 1, 2),
    ("shells13", (4, 4, 4), SHELLS3, 1, 8), ("nine9", (4, 4, 4), SHELLS3[:9], 2, 4),
    ("long32", (4, 4, 4), LONG32, 1, 2), ("ten7x9", (7, 9), None, 1, 3),
]


@pytest.mark.parametrize("name,shape,offsets,d,s", MEASURE_LATTICES,
                         ids=[x[0] for x in MEASURE_LATTICES])
def test_table_measure_model(name, shape, offsets, d, s):
    """The model of the redesigned measurement, at the plan's and every
    other count of systems a thread, bitwise ``measure_nb_plain(...,
    blocks=True)`` on gaussian couplings (the order of the adds shows),
    every (realization, system, site) taken once."""
    offsets = ([[1, 0], [0, 1], [1, 1], [1, -1], [2, 0], [0, 2], [2, 1]]
               if name == "ten7x9" else offsets)  # 7 offsets: steps of four, a tail
    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    rng = np.random.default_rng(2028)
    spins = rng.choice(np.array([-1, 1], np.int8), (d, s, n))
    coup = rng.standard_normal((d, n, nb)).astype(np.float32)
    want = energy.measure_nb_plain(torch.from_numpy(spins), torch.from_numpy(coup), lat,
                                   blocks=True)
    plan = energy.table_measure_plan(n, d, s, 64, 4).per
    for per in sorted({plan} | {p for p in range(1, 9) if s % p == 0}):
        e, m, taken = model_table_measure(spins, coup, lat.fwd, per)
        assert (taken == 1).all()
        assert np.array_equal(e.view(np.int32), want[0].numpy().view(np.int32)), per
        assert np.array_equal(m, want[1].numpy()), per


# ------------------------------------------------ the table pair overlaps

# (name, sites, offsets, realizations, columns) of the pair plan's grid
PAIR_SHAPES = [
    ("glass4d", 10 ** 4, 4, 16, 12), ("houd4", 10 ** 4, 4, 16, 24),
    ("nine16", 16 ** 3, 9, 8, 24), ("4d16", 16 ** 4, 4, 1, 12), ("5d6", 6 ** 5, 5, 4, 3),
    ("4d9", 9 ** 4, 4, 2, 1), ("1x3x3x3", 27, 4, 2, 5), ("shells13", 16 ** 3, 13, 1, 33),
    ("long32", 16 ** 3, 32, 2, 48), ("cols130", 10 ** 4, 4, 2, 130),
    ("4d32", 32 ** 4, 4, 2, 12), ("4d28x48", 28 ** 4, 4, 1, 48),
]


def pair_coverage(plan, n, d, cols):
    """Each (realization, column, site) the plan's CTAs stage and count,
    CTA (copy, rank) of a cluster in realization z and column group g."""
    staged = np.zeros((d, cols, n), np.int64)
    counted = np.zeros((d, cols, n), np.int64)
    span = plan.slice or n
    gcols = 32 * plan.words
    for g in range(plan.groups):
        c0 = gcols * g
        cs = slice(c0, min(cols, c0 + gcols))
        for copy in range(plan.copies):
            for r in range(plan.cluster):
                lo = min(n, r * span) if plan.slice else 0
                hi = min(n, lo + span)
                if copy == 0 and plan.slice:
                    staged[:, cs, lo:hi] += 1
                c_lo = min(hi, lo + copy * plan.share)
                c_hi = min(hi, c_lo + plan.share)
                counted[:, cs, c_lo:c_hi] += 1
    return staged, counted


@pytest.mark.parametrize("name,n,nb,d,cols", PAIR_SHAPES, ids=[x[0] for x in PAIR_SHAPES])
def test_pair_table_plan(name, n, nb, d, cols):
    """Words of 32 columns (1, 2 or 4 a site, groups past 128 columns);
    clusters of 1 to 8 CTAs whose slices of words fit a CTA's shared memory,
    the fewest that fill the card, one a realization and group (none staged
    past 8 CTAs': copies of one CTA until the launch holds a CTA an SM);
    every (realization, column, site) staged by one CTA and counted by one
    CTA; the host words."""
    plan = megapair.pair_table_plan(n, cols, d, CARD["sms"])
    assert plan.words in (1, 2, 4) and cols <= 32 * plan.words * plan.groups
    assert plan.words == 4 or plan.groups == 1
    assert plan.words == 1 or cols > 32 * plan.words // 2
    assert plan.cluster in (1, 2, 4, 8) and plan.copies >= 1
    assert plan.threads == 256 >= 64 * plan.words
    assert plan.smem == megapair.pair_table_smem(plan.slice, plan.words) <= SMEM
    ctas = plan.cluster * plan.copies * d * plan.groups
    if plan.slice:
        assert plan.copies == 1 and plan.share == plan.slice
        assert plan.slice % 4 == 0 and plan.cluster * plan.slice >= n
        half = plan.cluster // 2  # the fewest CTAs that fill the card, else 8
        half_slice = (-(-n // max(half, 1)) + 3) // 4 * 4
        assert (plan.cluster == 1 or half * d * plan.groups < CARD["sms"]
                or megapair.pair_table_smem(half_slice, plan.words) > SMEM)
        assert ctas >= CARD["sms"] or plan.cluster == 8
        staged, counted = pair_coverage(plan, n, d, cols)
        assert (staged == 1).all()
    else:
        assert plan.cluster == 1 and (n + 3) // 4 * 4 * 4 * plan.words > SMEM
        assert ctas >= CARD["sms"] and plan.share <= 64 * plan.threads
        _, counted = pair_coverage(plan, n, d, cols)
    assert (counted == 1).all()
    w = megapair.pair_table_words(n, nb, 3, cols, 2 * cols, plan).view(np.uint32)
    assert list(w[:12]) == [n, nb, 3, cols, 2 * cols, plan.words, plan.groups, plan.cluster,
                            plan.copies, plan.slice, plan.share, plan.threads]
    assert len(w) == 15 and w[14] == plan.smem
    v = np.arange(n, dtype=np.int64)
    m, sh = int(w[12]), int(w[13])
    if plan.slice:
        assert np.array_equal(((v * m) >> 32) >> sh if m else v, v // plan.slice)


def test_pair_table_plan_forms():
    """One cluster of 8 CTAs a realization at the 4D glass (12 columns x
    16: 128 CTAs, the form that ran fastest on the card), Wolff houd4 (24
    columns) and nine16 (16^3 with 9 offsets, 24 columns x 8: 64 CTAs) and
    16^4 x 1; 2 CTAs a cluster at 384 realizations; past 8 CTAs' shared
    memory no staging, copies of one CTA filling the card."""
    plan = lambda *a: megapair.pair_table_plan(*a, CARD["sms"])  # noqa: E731
    glass = plan(10 ** 4, 12, 16)
    assert (glass.words, glass.cluster, glass.copies, glass.slice) == (1, 8, 1, 1252)
    assert plan(10 ** 4, 24, 16)[2:4] == (8, 1)
    nine = plan(16 ** 3, 24, 8)
    assert (nine.cluster, nine.copies, nine.slice) == (8, 1, 512)
    assert plan(16 ** 4, 12, 1)[2:5] == (8, 1, 8192)
    assert plan(10 ** 4, 12, 100)[2:4] == (2, 1)
    big = plan(48 ** 4, 12, 1)
    assert big.slice == 0 and big.cluster == 1 and big.copies == 324


def model_pair_table(spins, sid, fwd, n_rep, plan):
    """``pair_overlap_table`` in numpy, CTA after CTA: each site's
    disagreement bits of a column group as 32-bit words (bit c of word u:
    column 32 u + c); CTA r of each copy stages its slice's words (unstaged:
    none), counts the sites of its share in rounds of ``threads`` x
    ``255 // nb`` sites, thread t the sites base + k threads + t: into 8
    counter words a word, byte b of word m the column 32 u + 8 b + m,
    ``x >> m & 0x01010101`` for each bond's xor ``x`` (and each own word for
    qs), each neighbour's word from the shared memory of its owner (the
    slice divisor's multiply-shift), the bytes flushed after each round
    (each byte at most 255) as each warp's sums of two pairs of 16-bit
    lanes a word (no lane past 2^16 - 1); the CTAs' sums, the cluster's,
    then the copies'.  Returns (qs, ql) and the (realization, column, site)
    counts taken."""
    d, s, n = spins.shape
    nb = fwd.shape[1]
    n_temps = s // n_rep
    cols = (n_rep // 2) * n_temps
    words_n = plan.words
    w = megapair.pair_table_words(n, nb, n_temps, cols, s, plan).view(np.uint32)
    m_div, s_div = int(w[12]), int(w[13])
    qs = np.zeros((d, cols), np.int64)
    ql = np.zeros((d, cols), np.int64)
    taken = np.zeros((d, cols, n), np.int64)
    per_round = max(1, 255 // nb)
    lanes = np.arange(8, dtype=np.uint32)
    gcols = 32 * words_n
    for z in range(d):
        for g in range(plan.groups):
            c0 = gcols * g
            nc = min(gcols, cols - c0)
            c = c0 + np.arange(nc)
            p, t = c // n_temps, c % n_temps
            a = spins[z, sid[z, 2 * p * n_temps + t]]
            b = spins[z, sid[z, (2 * p + 1) * n_temps + t]]
            delta = (a != b).astype(np.uint32)  # [nc, n]
            words = np.zeros((n, words_n), np.uint32)
            for k in range(nc):
                words[:, k // 32] |= delta[k] << np.uint32(k % 32)
            span = plan.slice or n
            total = np.zeros((2, 32 * words_n), np.int64)
            for copy in range(plan.copies):
                for r in range(plan.cluster):
                    lo = min(n, r * span) if plan.slice else 0
                    hi = min(n, lo + span)
                    c_lo = min(hi, lo + copy * plan.share)
                    c_hi = min(hi, c_lo + plan.share)
                    for base in range(c_lo, c_hi, plan.threads * per_round):
                        cq = np.zeros((plan.threads, words_n, 8), np.uint32)
                        cl = np.zeros((plan.threads, words_n, 8), np.uint32)
                        for k in range(per_round):
                            i = base + k * plan.threads + np.arange(plan.threads)
                            i = i[i < c_hi]
                            if not len(i):
                                break
                            tid = i - base - k * plan.threads
                            own = words[i]  # the slice's own words
                            cq[tid] += (own[..., None] >> lanes) & np.uint32(0x01010101)
                            for dd in range(nb):
                                j = fwd[i, dd].astype(np.int64)
                                if plan.slice:
                                    owner = ((j * m_div) >> 32) >> s_div if m_div else j
                                    assert np.array_equal(owner, j // plan.slice)
                                    assert ((j - owner * plan.slice) < plan.slice).all()
                                x = own ^ words[j]
                                cl[tid] += (x[..., None] >> lanes) & np.uint32(0x01010101)
                            taken[z, c0:c0 + nc, i] += 1
                        # each warp's sums: a word's bytes as two pairs of
                        # 16-bit lanes, summed over the warp's 32 threads
                        for row, cnt in ((0, cq), (1, cl)):
                            c64 = cnt.astype(np.int64).reshape(-1, 32, words_n, 8)
                            lo = (c64 & 0x00FF00FF).sum(1)  # [warps, words, 8]
                            hi = ((c64 >> 8) & 0x00FF00FF).sum(1)
                            for sh in (0, 8, 16, 24):  # no lane carries into the next
                                assert ((c64 >> sh) & 0xFF).sum(1).max() < 2 ** 16
                            for u in range(words_n):
                                for mm in range(8):
                                    for bb in range(4):
                                        col = 32 * u + 8 * bb + mm
                                        v = (hi if bb & 1 else lo)[:, u, mm]
                                        v = v >> 16 if bb & 2 else v & 0xFFFF
                                        total[row, col] += int(v.sum())
            qs[z, c0:c0 + nc] = n - 2 * total[0, :nc]
            ql[z, c0:c0 + nc] = nb * n - 2 * total[1, :nc]
    return qs, ql, taken


def forced_pair_plan(n, cols, cluster=1, copies=1, threads=256):
    """A consistent plan of threads ``threads``, staged on ``cluster`` CTAs,
    or unstaged on ``copies`` CTAs, as the tests force it."""
    words = 1 if cols <= 32 else 2 if cols <= 64 else 4
    groups = -(-cols // (32 * words))
    if copies == 1:
        slice_ = share = (-(-n // cluster) + 3) // 4 * 4
    else:
        cluster, slice_, share = 1, 0, -(-n // copies)
    return megapair.PairTablePlan(words, groups, cluster, copies, slice_, share,
                                  max(threads, 64 * words),
                                  megapair.pair_table_smem(slice_, words))


PAIR_LATTICES = [
    ("3^4-r2", (3, 3, 3, 3), None, 2, 3), ("2^5-r4", (2, 2, 2, 2, 2), None, 4, 4),
    ("nine-r6", (4, 4, 4), SHELLS3[:9], 6, 1), ("self-r2", (1, 3, 3, 3), None, 2, 5),
    ("long32-r2", (8, 8, 8), LONG32, 2, 20), ("4^4-cols40", (4, 4, 4, 4), None, 2, 40),
    ("3^4-cols80", (3, 3, 3, 3), None, 4, 40), ("3^4-cols130", (3, 3, 3, 3), None, 2, 130),
]
PAIR_FORMS = [None, 1, 2, 4, 8, "t64", "unstaged"]


@pytest.mark.parametrize("form", PAIR_FORMS, ids=["plan", "c1", "c2", "c4", "c8", "c1-t64",
                                                  "unstaged"])
@pytest.mark.parametrize("name,shape,offsets,n_rep,n_temps", PAIR_LATTICES,
                         ids=[x[0] for x in PAIR_LATTICES])
def test_pair_table_model(name, shape, offsets, n_rep, n_temps, form):
    """The model of the redesigned pair measurement, on the plan's form and
    forced ones (1 to 8 CTAs a cluster, no staging on three copies),
    bitwise ``pair_overlap_table_plain``, every (realization, column, site)
    taken once; a CTA of 64 threads on 8^3 with 32 offsets (rounds of 7
    sites a thread) flushes its byte counters more than once."""
    lat = Lattice(shape, offsets)
    n = lat.n_spins
    d, s = 2, n_rep * n_temps
    cols = (n_rep // 2) * n_temps
    rng = np.random.default_rng(31 + n_rep + n_temps)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(d, s, n))
    sid = np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)
    if form is None:
        plan = megapair.pair_table_plan(n, cols, d, 132)
    elif form == "unstaged":
        plan = forced_pair_plan(n, cols, copies=3)
    elif form == "t64":
        plan = forced_pair_plan(n, cols, threads=64)
    else:
        plan = forced_pair_plan(n, cols, form)
    qs, ql, taken = model_pair_table(spins, sid, lat.fwd, n_rep, plan)
    assert (taken == 1).all()
    pq, pl = megapair.pair_overlap_table_plain(torch.from_numpy(spins), torch.from_numpy(sid),
                                               torch.from_numpy(lat.fwd), n_rep)
    np.testing.assert_array_equal(qs, pq.numpy())
    np.testing.assert_array_equal(ql, pl.numpy())
