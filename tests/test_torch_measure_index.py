"""The launch mapping and index arithmetic of the two measurement kernels on
the CPU, as ``tests/test_torch_pairs_index.py`` models ``pair_overlap``'s:
``csrc/sweep_nb.cu`` ``measure_nb`` (the per-sweep path's (e, m) partials
on the coloured lattices) and ``csrc/overlap.cu`` ``energy_partials`` (the
replica path's energies after a move).

* ``measure_nb`` on ``Lattice.sweep_words`` (a ``BandWalk``): block
  ``blockIdx.x`` of 256 groups of four sites, systems ``blockIdx.y per ..``
  of realization ``blockIdx.z``; a numpy model of the launch reads every
  (realization, system, site) once, finds each site's forward neighbours
  by one multiply-shift division, a step a site and residues (``nb_site``),
  as the lattice's modulo tables give them, and adds a site's terms (J with
  its sign flipped where the spins differ, ``bond_term``) in offset order,
  a group's four sites in order from 0 and the 256 group sums as
  ``warp_tree`` pairs them: bitwise ``energy.measure_nb_plain(...,
  blocks=True)`` (the first design's ``block_partials`` order, four sites
  a thread, products in floats), for several ``per``; ``energy.measure_per``'s
  rule.
* ``energy_partials`` on ``overlap.energy_words``: a warp a 256-site block
  of ``per`` systems of one realization (multiply-shift divisions of the
  warp index), a lane eight sites as 8-, 4- or 1-byte words; the words'
  neighbour words (the line's next word, wrapping at its end; the same word
  of the next line and plane) hold the forward neighbours; a site's terms
  are J's sign flipped by the sign bits of XORed words and m is ``W - 2
  popc`` of a word's sign bits; the model is bitwise
  ``overlap.energy_partials_plain(..., blocks=True)`` (a site a thread,
  products in floats) at every word width and ``per``.
* Each system's summed e and m equal the JAX package's ``energies_and_mags``
  (``peapods_tpu/ops/energy.py:28-41``): exactly on +-1 couplings, within
  ``E_TOL`` sum |J| / n on gaussian ones (f32 sums in another order).

Lattices: BCC and FCC at 4^3, the NNN table, a table with the self-bond
``[2, 0]`` on two rows, the triangular lattice, 2D 8 x 64, widths that are
not a multiple of 4 or 8, and sizes that leave the last block padded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.ops.energy import energies_and_mags as ref_energies_and_mags
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch.ops import energy, overlap
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

torch.set_num_threads(1)

NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
SELF = [[1, 0], [0, 1], [2, 0]]  # on two rows: the bond of a site to itself
# gaussian couplings: |sum_kernel - sum_reference| <= E_TOL sum |J| / n, two
# f32 sums of n terms in different orders (each within n 2^-24 sum |J|)
E_TOL = 1e-5

# (name, shape, offsets): measure_nb's lattices
NB_CASES = [
    ("bcc-4", (4, 4, 4), "bcc"), ("fcc-4", (4, 4, 4), "fcc"),
    ("nnn-8x12", (8, 12), NNN), ("self-2x6", (2, 6), SELF),
    ("tri-6x10", (6, 10), "triangular"), ("square-8x64", (8, 64), None),
    ("square-6x10", (6, 10), None), ("cubic-4x6x2", (4, 6, 2), None),
    ("fcc-8x8x20", (8, 8, 20), "fcc"),  # 1280 sites: a padded second block
    ("nnn-34x32", (34, 32), NNN),       # 1088 sites
]
NB_IDS = [c[0] for c in NB_CASES]
PERS = [1, 2, 3]

# replica-path lattices of energy_partials: 8-byte words, 4-byte words, the
# per-site path (a fast extent that is not a multiple of 4), padded blocks
EP_SHAPES = [(8, 64), (6, 10), (6, 12), (4, 4, 4), (8, 8, 8), (4, 6, 8), (6, 6, 10),
             (2, 2, 2), (16, 24)]
EP_IDS = ["x".join(map(str, s)) for s in EP_SHAPES]


def _div(n, m, s):
    n = np.asarray(n, np.uint64)
    q = ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)
    return (n if m == 0 else q).astype(np.int64)


def warp_tree(x):
    """``csrc/mega.cuh`` ``warp_tree`` of ``x [..., 256]`` (f32 or int):
    three levels read from shared memory by lane l, then five
    ``__shfl_down_sync`` levels; lane 0's value."""
    lane = np.arange(32)
    v = (((x[..., lane] + x[..., lane + 128]) + (x[..., lane + 64] + x[..., lane + 192]))
         + ((x[..., lane + 32] + x[..., lane + 160]) + (x[..., lane + 96] + x[..., lane + 224])))
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def flip_sign(J, differ):
    """``bond_term``: f32 ``J`` with its sign bit flipped where ``differ``."""
    bits = np.ascontiguousarray(J, np.float32).view(np.uint32)
    return (bits ^ (np.asarray(differ, np.uint32) << np.uint32(31))).view(np.float32)


def _offsets(geometry):
    return GEOMETRY_OFFSETS[geometry] if isinstance(geometry, str) else geometry


def _inputs(shape, offsets, d, n_sys, couplings, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    nb = len(offsets) if offsets is not None else len(shape)
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nb)) if couplings == "pm"
            else rng.standard_normal((d, n, nb))).astype(np.float32)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(d, n_sys, n))
    return spins, coup


def _reference(spins, coup, shape, offsets):
    """The JAX package's per-system (e, m), realization by realization."""
    geom = GridOps.from_lattice(RefLattice(list(shape), offsets))
    out = [ref_energies_and_mags(jnp.asarray(spins[r]), jnp.asarray(coup[r]), geom)
           for r in range(spins.shape[0])]
    return (np.stack([np.asarray(e) for e, _ in out]),
            np.stack([np.asarray(m) for _, m in out]))


def _hold_to_reference(e_part, m_part, spins, coup, shape, offsets, couplings):
    n = spins.shape[-1]
    e_ref, m_ref = _reference(spins, coup, shape, offsets)
    np.testing.assert_array_equal(np.asarray(m_part, np.int64).sum(-1), m_ref)
    tot = np.asarray(e_part, np.float64).sum(-1)
    if couplings == "pm":  # integers: exact in any order
        np.testing.assert_array_equal(tot.astype(np.float32) / np.float32(n), e_ref)
    else:
        lim = E_TOL * np.abs(coup).sum((1, 2))[:, None] / n
        assert (np.abs(tot / n - e_ref) <= lim).all()


# ------------------------------------------------------------- measure_nb


class Walk:
    """``Lattice.sweep_words``: a ``csrc/band.cuh`` ``BandWalk``."""

    def __init__(self, words):
        w = words.astype(np.int64)
        self.L = [int(x) for x in w[:3]]
        self.nb = int(w[3])
        self.off = w[4:22].reshape(6, 3)[:self.nb]
        self.res = w[26:50].reshape(6, 4)[:self.nb]
        self.div = words[50:56].view(np.uint32).astype(np.int64).reshape(3, 2)
        self.block = self.L[1] * self.L[2]
        self.n = self.L[0] * self.block


def nb_neighbours(w, first, spl):
    """int64 ``[len(first), spl, n_nb]``: the forward neighbours of sites
    ``first .. first + spl - 1`` as ``measure_nb_kernel`` finds them: the
    first site's row and (c1, c2) by ``band_coords`` (multiply-shift), a step
    a site, then ``nb_site(..., back=false)``: axis 0 one compare, axes 1
    and 2 a residue and one compare."""
    first = np.asarray(first, np.int64)
    r = _div(first, *w.div[0])
    p = first - r * w.block
    c1 = _div(p, *w.div[1])
    c2 = p - c1 * w.L[2]
    three = w.L[2] > 1
    out = np.zeros((len(first), spl, w.nb), np.int64)
    for k in range(spl):
        if k:
            if three:
                c2 = c2 + 1
                wrap2 = c2 == w.L[2]
                c2 = np.where(wrap2, 0, c2)
            else:
                wrap2 = np.ones_like(c1, bool)
            c1 = np.where(wrap2, c1 + 1, c1)
            wrap1 = c1 == w.L[1]
            c1 = np.where(wrap1, 0, c1)
            r = np.where(wrap1, r + 1, r)
        for d in range(w.nb):
            n0 = r + w.off[d, 0]
            n0 = np.where(n0 >= w.L[0], n0 - w.L[0], n0)
            n1 = c1 + w.res[d, 0]
            n1 = np.where(n1 >= w.L[1], n1 - w.L[1], n1)
            n2 = c2 + w.res[d, 1] if three else 0
            if three:
                n2 = np.where(n2 >= w.L[2], n2 - w.L[2], n2)
            out[:, k, d] = (n0 * w.L[1] + n1) * w.L[2] + n2
    return out


def measure_model(spins, coup, lat, per):
    """``(e_part, m_part, seen)`` of a ``measure_nb`` launch with ``per``
    systems a thread: each CTA (block x, system set y, realization z) of
    256 threads, thread t the group of sites ``4 (256 x + t) ..``; per
    system a site's e is ``0 + bond_term`` over the offsets in order, the
    thread adds its four values in order from 0, and one warp pairs the
    block's 256 group sums (``warp_tree``); ``seen`` counts each
    (realization, system, site) read as a group's own."""
    w = Walk(lat.sweep_words)
    n, nb = w.n, w.nb
    d, n_sys, _ = spins.shape
    blocks = -(-(-(-n // 4)) // 256)
    t = np.arange(256)
    e_part = np.zeros((d, n_sys, blocks), np.float32)
    m_part = np.zeros((d, n_sys, blocks), np.int64)
    seen = np.zeros((d, n_sys, n), np.int64)
    for bx in range(blocks):
        i0 = 4 * (bx * 256 + t)
        has = i0 < n
        sites = np.where(has[:, None], i0[:, None] + np.arange(4), 0)
        nbr = np.where(has[:, None, None], nb_neighbours(w, np.where(has, i0, 0), 4), 0)
        for bz in range(d):
            # the thread's 4 nb couplings, read once for its systems
            jc = coup[bz].reshape(-1)[(sites[..., None] * nb + np.arange(nb)).reshape(256, -1)]
            for by in range(n_sys // per):
                for q in range(per):
                    sy = by * per + q
                    s = spins[bz, sy]
                    acc = np.zeros(256, np.float32)
                    for k in range(4):
                        e = np.zeros(256, np.float32)
                        for dd in range(nb):
                            differ = s[sites[:, k]] != s[nbr[:, k, dd]]
                            e = e + flip_sign(jc[:, k * nb + dd], differ)
                        acc = acc + np.where(has, e, np.float32(0))
                    m = np.where(has[:, None], s[sites], 0).astype(np.int64)
                    np.add.at(seen[bz, sy], sites[has].reshape(-1), 1)
                    e_part[bz, sy, bx] = warp_tree(acc)
                    m_part[bz, sy, bx] = warp_tree(m.sum(1))
    return e_part, m_part, seen


@pytest.mark.parametrize("name,shape,geometry", NB_CASES, ids=NB_IDS)
def test_measure_neighbours_are_the_modulo_ones(name, shape, geometry):
    """From a group's first site, the stepped coordinates and residues give
    ``Lattice.fwd``."""
    lat = Lattice(shape, _offsets(geometry))
    w = Walk(lat.sweep_words)
    got = nb_neighbours(w, np.arange(0, w.n, 4), 4).reshape(w.n, w.nb)
    np.testing.assert_array_equal(got, lat.fwd)


@pytest.mark.parametrize("per", PERS)
@pytest.mark.parametrize("name,shape,geometry", NB_CASES[:6] + NB_CASES[8:9],
                         ids=NB_IDS[:6] + NB_IDS[8:9])
def test_measure_launch_reads_every_site_once(name, shape, geometry, per):
    lat = Lattice(shape, _offsets(geometry))
    spins, coup = _inputs(shape, lat.offsets, 2, 6, "pm", 1)
    _, _, seen = measure_model(spins, coup, lat, per)
    assert (seen == 1).all()


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("name,shape,geometry", NB_CASES, ids=NB_IDS)
def test_measure_model_is_bitwise_block_plain_and_reference(name, shape, geometry,
                                                            couplings):
    """The partials at every ``per`` are bitwise
    ``measure_nb_plain(blocks=True)`` (gaussian couplings included); their
    sums are the JAX package's."""
    offsets = _offsets(geometry)
    lat = Lattice(shape, offsets)
    d, n_sys = 2, 3
    spins, coup = _inputs(shape, lat.offsets, d, n_sys, couplings, 7 + len(shape))
    pe, pm = energy.measure_nb_plain(torch.from_numpy(spins), torch.from_numpy(coup), lat,
                                     blocks=True)
    blocks = -(-(-(-lat.n_spins // 4)) // 256)
    assert pe.shape == pm.shape == (d, n_sys, blocks)
    for per in (1, 3):
        me, mm, _ = measure_model(spins, coup, lat, per)
        np.testing.assert_array_equal(me.view(np.int32), pe.numpy().view(np.int32))
        np.testing.assert_array_equal(mm, pm.numpy())
    _hold_to_reference(pe.numpy(), pm.numpy(), spins, coup, shape,
                       None if geometry is None else offsets, couplings)
    se, sm = energy.measure_nb_plain(torch.from_numpy(spins), torch.from_numpy(coup), lat)
    np.testing.assert_array_equal(sm.numpy()[..., 0], pm.numpy().sum(-1))
    if couplings == "pm":
        np.testing.assert_array_equal(se.numpy()[..., 0], pe.numpy().sum(-1))


@pytest.mark.parametrize("n,d,n_sys,want", [
    (4096, 1, 8, 1),       # BCC / FCC 16^3 x 8, the staged paths
    (1024, 1, 8, 1),       # config 2, 32^2 triangular x 8
    (32768, 1, 16, 2),     # 32^3 x 16
    (65536, 1, 24, 8),     # 256^2 x 24
    (2097152, 1, 8, 8),    # 128^3 x 8
    (36, 3, 5, 1),
])
def test_measure_per_rule(n, d, n_sys, want):
    """``sweep.systems_per`` of the launch's groups against an eighth of
    the resident threads of 132 SMs x 2048."""
    assert energy.measure_per(n, d, n_sys, 132 * 2048 // 8) == want


# -------------------------------------------------------- energy_partials


class EWalk:
    """The words of an ``EnergyWalk`` (``csrc/overlap.cu``
    ``make_energy_walk``)."""

    def __init__(self, words):
        w = words.astype(np.int64)
        (self.W, self.n, self.nw, self.wpl, self.Lb, self.La, self.nd, self.per, self.S,
         self.nb, self.sets, self.d, self.warps) = (int(x) for x in w[:13])
        self.div = words[13:21].view(np.uint32).astype(np.int64).reshape(4, 2)


_UINT = {8: "<u8", 4: "<u4", 1: "u1"}


def energy_layout(g):
    """Per (warp, lane, word): the realization, system set and block of the
    warp, the word index, whether it holds sites, and its neighbour words
    (the line's next, the inner slow axis', the outer one's in 3D), as
    ``energy_partials_kernel`` computes them."""
    gw = np.arange(g.warps)
    rest = _div(gw, *g.div[2])
    blk = gw - rest * g.nb
    dz = _div(rest, *g.div[3])
    st = rest - dz * g.sets
    lane = np.arange(32)
    i0 = blk[:, None] * 256 + 8 * lane  # [warps, 32]
    j = np.arange(8 // g.W)
    k = (i0 // g.W)[..., None] + j
    on = j * g.W < (g.n - i0)[..., None]
    k = np.where(on, k, 0)
    line = _div(k, *g.div[0])
    pos = k - line * g.wpl
    kf = np.where(pos + 1 < g.wpl, k + 1, k + 1 - g.wpl)
    if g.La:
        ca = _div(line, *g.div[1])
        cb = line - ca * g.Lb
        plane = g.Lb * g.wpl
        ka = np.where(ca + 1 < g.La, k + plane, k + plane - g.nw)
    else:
        cb, ka = line, None
    kb = np.where(cb + 1 < g.Lb, k + g.wpl, k + g.wpl - g.Lb * g.wpl)
    return dict(dz=dz, st=st, blk=blk, i0=i0, k=k, on=on, kf=kf, kb=kb, ka=ka)


def _byte(x, b):
    return ((x >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8).view(np.int8)


def energy_model(spins, coup, g):
    """``(e_part, m_part, seen)`` of an ``energy_partials`` launch on words
    ``g``: per warp and system, each lane's words and neighbour words; a
    site's e ``0 + (s s_a) J[i, a]`` over the axes in order, each term J's
    sign flipped by the sign bit of the XORed words' byte; the block's 256
    values (lane l's sites at 8 l ..) paired by ``warp_tree``; m the warp's
    sum of each word's ``W - 2 popc`` of its sign bits."""
    lay = energy_layout(g)
    d, n_sys, n = spins.shape
    words = np.ascontiguousarray(spins).view(_UINT[g.W]).astype(np.uint64)
    e_part = np.zeros((d, n_sys, g.nb), np.float32)
    m_part = np.zeros((d, n_sys, g.nb), np.int64)
    seen = np.zeros((d, n_sys, n), np.int64)
    dz = lay["dz"][:, None, None]
    nd, W = g.nd, g.W
    signs = np.uint64(0x8080808080808080 >> (64 - 8 * W))
    for q in range(g.per):
        sy = (lay["st"] * g.per + q)[:, None, None]
        at = lambda kk: words[dz, sy, kk]  # noqa: E731
        w0, wf, wb = at(lay["k"]), at(lay["kf"]), at(lay["kb"])
        xf = w0 ^ ((w0 >> np.uint64(8)) | (wf << np.uint64(8 * (W - 1))))
        xb = w0 ^ wb
        xa = w0 ^ at(lay["ka"]) if nd == 3 else None
        on = lay["on"]
        m = np.where(on, W - 2 * np.bitwise_count(w0 & signs).astype(np.int64), 0)
        e = np.zeros(lay["k"].shape[:2] + (8,), np.float32)
        for j in range(8 // W):
            for b in range(W):
                site = j * W + b
                i = np.where(on[..., j], lay["i0"] + site, 0)
                jc = coup[dz[..., 0], i]  # [warps, 32, nd]
                bit = lambda x: (x[..., j] >> np.uint64(8 * b + 7)) & np.uint64(1)  # noqa
                x = np.zeros(i.shape, np.float32)
                if nd == 3:
                    x = x + flip_sign(jc[..., 0], bit(xa))
                x = x + flip_sign(jc[..., nd - 2], bit(xb))
                x = x + flip_sign(jc[..., nd - 1], bit(xf))
                e[..., site] = np.where(on[..., j], x, np.float32(0))
                oj = on[..., j]
                np.add.at(seen, (np.broadcast_to(dz[..., 0], oj.shape)[oj],
                                 np.broadcast_to(sy[..., 0], oj.shape)[oj], i[oj]), 1)
        e_part[dz[:, 0, 0], sy[:, 0, 0], lay["blk"]] = warp_tree(e.reshape(-1, 256))
        m_part[dz[:, 0, 0], sy[:, 0, 0], lay["blk"]] = m.sum((1, 2))
    return e_part, m_part, seen


@pytest.mark.parametrize("shape", EP_SHAPES, ids=EP_IDS)
def test_energy_neighbour_words_hold_the_forward_neighbours(shape):
    """Byte b of word k is site k W + b; its forward neighbour along the
    fast axis is byte b + 1, or byte 0 of the line's next word for the last
    byte; along each slower axis byte b of the next line's (plane's) word:
    the modulo tables', at every word width the fast extent allows."""
    fwd = Lattice(shape).fwd
    for align in (0, 4, 2):
        g = EWalk(overlap.energy_words(shape, 2, 3, align, per=1))
        lay = energy_layout(g)
        on = lay["on"]
        for b in range(g.W):
            site = lay["k"] * g.W + b
            fast = np.where(b + 1 < g.W, site + 1, lay["kf"] * g.W)
            np.testing.assert_array_equal(fast[on], fwd[site[on], len(shape) - 1])
            inner = 0 if len(shape) == 2 else 1
            np.testing.assert_array_equal((lay["kb"] * g.W + b)[on], fwd[site[on], inner])
            if len(shape) == 3:
                np.testing.assert_array_equal((lay["ka"] * g.W + b)[on], fwd[site[on], 0])


@pytest.mark.parametrize("shape,align,W", [
    ((8, 64), 0, 8), ((8, 64), 4, 4), ((8, 64), 2, 1), ((6, 12), 0, 4), ((6, 10), 0, 1),
    ((4, 4, 4), 0, 4), ((8, 8, 8), 0, 8), ((8, 8, 8), 4, 4), ((16, 16, 16), 6, 1)])
def test_energy_words_pick_the_word(shape, align, W):
    """8 or 4 bytes where the fast extent holds whole words and the spins'
    address allows it, else the per-site path; ``per`` from
    ``sweep.systems_per`` of the launch's lanes against a quarter of the
    resident threads (config 5: 4, config 4: 1)."""
    g = EWalk(overlap.energy_words(shape, 2, 6, align, per=3))
    assert g.W == W and g.nw * W == g.n and g.wpl == shape[-1] // W
    assert (g.per, g.sets, g.warps) == (3, 2, 2 * 2 * g.nb)
    threads = 132 * 2048 // 4
    assert EWalk(overlap.energy_words((16, 16, 16), 8, 96, 0, threads)).per == 4
    assert EWalk(overlap.energy_words((8, 8, 8), 8, 96, 0, threads)).per == 1


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("shape", EP_SHAPES, ids=EP_IDS)
def test_energy_model_is_bitwise_block_plain_and_reference(shape, couplings):
    """Every (realization, system, site) read once; the partials bitwise
    ``energy_partials_plain(blocks=True)`` at each word width and ``per``;
    their sums the JAX package's."""
    d, n_sys = 2, 4
    spins, coup = _inputs(shape, None, d, n_sys, couplings, 3 + sum(shape))
    pe, pm = overlap.energy_partials_plain(torch.from_numpy(spins), torch.from_numpy(coup),
                                           shape, blocks=True)
    n = int(np.prod(shape))
    assert pe.shape == (d, n_sys, -(-n // 256))
    for align, per in ((0, 1), (4, 2), (2, 4), (0, 4)):
        g = EWalk(overlap.energy_words(shape, d, n_sys, align, per=per))
        me, mm, seen = energy_model(spins, coup, g)
        assert (seen == 1).all()
        np.testing.assert_array_equal(me.view(np.int32), pe.numpy().view(np.int32))
        np.testing.assert_array_equal(mm, pm.numpy())
    _hold_to_reference(pe.numpy(), pm.numpy(), spins, coup, shape, None, couplings)
    se, sm = overlap.energy_partials_plain(torch.from_numpy(spins), torch.from_numpy(coup),
                                           shape)
    np.testing.assert_array_equal(sm.numpy()[..., 0], pm.numpy().sum(-1))
    if couplings == "pm":
        np.testing.assert_array_equal(se.numpy()[..., 0], pe.numpy().sum(-1))
