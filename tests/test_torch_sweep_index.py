"""The launch mappings and index arithmetic of ``sweep_2d`` (``csrc/sweep.cu``)
and ``sweep_nb`` (``csrc/sweep_nb.cu``) on the CPU, as
``tests/test_torch_bonds_index.py`` models ``fk_bonds``'.

* A numpy model of each launch: ``blockIdx.x`` the blocks of 256 groups of
  four (active) sites, ``y`` a realization's systems ``per`` at a time
  (``sweep.systems_per``), ``z`` the realization.  Every (realization,
  system, active site) is updated exactly once; each site's row and column
  (the multiply-shift division of ``fast_divisor``, then a step a site),
  its neighbours (``sweep_2d``: the vector path's bytes of three rows and
  an edge byte; ``sweep_nb``: residues and one compare an axis) and its
  couplings (``sweep_2d``: the forward bonds of the site and of its up and
  left neighbours; ``sweep_nb``: the forward couplings at the site and at
  its backward neighbour) are the modulo ones and the pre-shifted grids' /
  backward couplings'; each site's Philox counter and word are
  ``rng.colour_uniforms``' / ``rng.site_uniforms``'.
* The model's sweeps (the kernels' order of float operations) are bitwise
  ``sweep_2d_plain`` / ``sweep_nb_plain``, and its partials (a thread's
  four sites in order, then the warp's pairing) bitwise
  ``sweep.sweep_2d_partials``, whose sums are ``sweep_2d_plain``'s:
  bitwise on +-1 couplings, within the f32 bound of two summation orders
  on gaussian ones.
* The grids stay within CUDA's limits past 65535 blocks; ``systems_per``
  picks the largest divisor up to 8 that keeps half the card's resident
  threads; the engine hands ``sweep_2d`` its forward couplings, whose
  pre-shifted grids ``pack_coupling_grids`` alone makes.
"""

import inspect

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops import rng, sweep
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice, fast_divisor

torch.set_num_threads(1)

THREADS = 256
# half the resident threads of the card the rule is modelled for (the H100:
# 132 SMs x 2048), the least a launch keeps; fk.resident_threads reads them
# from the card
HALF = 132 * 2048 // 2
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]


def _div(n, m, s):
    n = np.asarray(n, np.uint64)
    q = ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)
    return (n if m == 0 else q).astype(np.int64)


# ------------------------------------------------------------- sweep_2d


def model_2d(H, W, colour, vec):
    """The ``sweep_2d`` kernel's indices for one colour pass of an ``[H,
    W]`` system: per thread ``g`` (blockIdx.x * 256 + lane) with a group,
    and site ``k`` of it, the active index ``i``, the site, its up, down,
    left and right neighbours and the coupling indices (into the forward
    bonds ``[H W, 2]`` flattened) of ju, jd, jl, jr.  Sites past the last
    are marked in ``ok``."""
    wh = W // 2
    n_half = H * wh
    blocks = -(-(-(-n_half // 4)) // THREADS)
    g = np.arange(blocks * THREADS)
    g = g[4 * g < n_half]
    i0 = 4 * g
    r0 = _div(i0, *fast_divisor(wh))
    j0 = i0 - r0 * wh
    k = np.arange(4)
    out = dict(g=g, i=i0[:, None] + k, ok=i0[:, None] + k < n_half)
    if vec:
        assert W % 8 == 0
        r = np.repeat(r0[:, None], 4, 1)
        c0 = 2 * j0[:, None]
        a = (r + colour) & 1
        rw, c = r * W, c0 + a + 2 * k
        up = np.where(r == 0, H - 1, r - 1) * W
        dn = np.where(r == H - 1, 0, r + 1) * W
        edge = rw + np.where(a == 1, np.where(c0 + 8 == W, 0, c0 + 8),
                             np.where(c0 == 0, W - 1, c0 - 1))
        # the bytes of x (the row shifted by a) and the edge byte
        byte = lambda j: np.where(j == 8 - a, edge, rw + c0 + a + j)  # noqa: E731
        left = np.where(k == 0, np.where(a == 1, rw + c0, edge), byte(2 * k - 1))
        e0 = 2 * (rw + c0)  # e[0] of the four float4 loads
        out.update(site=rw + c, up=up + c, dn=dn + c, left=left, right=byte(2 * k + 1),
                   ju=2 * (up + c), jd=e0 + np.where(a == 1, 4 * k + 2, 4 * k),
                   jr=e0 + np.where(a == 1, 4 * k + 3, 4 * k + 1),
                   jl=np.where(k == 0, np.where(a == 1, e0 + 1, 2 * edge + 1),
                               e0 + np.where(a == 1, 4 * k + 1, 4 * k - 1)))
        return out
    rows, cols = [], []
    r, j = r0.copy(), j0.copy()
    for _ in range(4):
        rows.append(r.copy())
        cols.append(2 * j + ((r + colour) & 1))
        j = j + 1
        r = np.where(j == wh, r + 1, r)
        j = np.where(j == wh, 0, j)
    r, c = np.stack(rows, 1), np.stack(cols, 1)
    r = np.where(out["ok"], r, 0)  # past the last site: unread
    c = np.where(out["ok"], c, 0)
    idx = r * W + c
    up = np.where(r == 0, H - 1, r - 1) * W + c
    lf = np.where(c == 0, idx + W - 1, idx - 1)
    out.update(site=idx, up=up, dn=np.where(r == H - 1, 0, r + 1) * W + c, left=lf,
               right=np.where(c == W - 1, idx + 1 - W, idx + 1), ju=2 * up, jd=2 * idx,
               jl=2 * lf + 1, jr=2 * idx + 1)
    return out


# (H, W): every width of the card tests' per-site path, the vector path's
# smallest, row 4's, the harness'
SHAPES_2D = [(4, 6), (6, 10), (2, 34), (10, 34), (4, 2), (2, 4), (2, 8), (8, 16),
             (32, 32), (64, 64), (6, 256)]


@pytest.mark.parametrize("colour", [0, 1])
@pytest.mark.parametrize("shape", SHAPES_2D, ids=[f"{h}x{w}" for h, w in SHAPES_2D])
def test_sweep_2d_sites_neighbours_and_couplings_are_the_modulo_ones(shape, colour):
    H, W = shape
    for vec in ([False, True] if W % 8 == 0 else [False]):
        m = model_2d(H, W, colour, vec)
        ok = m["ok"]
        i = m["i"][ok]
        # every active site once, in its thread's group
        np.testing.assert_array_equal(np.sort(i), np.arange(H * W // 2))
        np.testing.assert_array_equal((m["i"] // 4)[ok], np.repeat(m["g"], 4)[ok.ravel()])
        r = i // (W // 2)
        c = 2 * (i % (W // 2)) + ((r + colour) & 1)
        want = dict(site=r * W + c, up=(r - 1) % H * W + c, dn=(r + 1) % H * W + c,
                    left=r * W + (c - 1) % W, right=r * W + (c + 1) % W,
                    ju=2 * ((r - 1) % H * W + c), jd=2 * (r * W + c),
                    jl=2 * (r * W + (c - 1) % W) + 1, jr=2 * (r * W + c) + 1)
        for key, v in want.items():
            np.testing.assert_array_equal(m[key][ok], v, err_msg=f"{key} vec={vec}")
        # the partner of the column pair (m's second term) is the left
        # neighbour on odd columns, the right one on even columns
        partner = np.where(c & 1, m["left"][ok], m["right"][ok])
        np.testing.assert_array_equal(partner, m["site"][ok] ^ 1)


def test_sweep_2d_couplings_are_the_pre_shifted_grids():
    """The model's coupling reads of the forward bonds are, value for value,
    ``pack_coupling_grids``' ju, jd, jl, jr at each active site."""
    H, W = 6, 16
    coup = torch.from_numpy(np.random.default_rng(3).standard_normal((1, H * W, 2))
                            .astype(np.float32))
    jg = sweep.pack_coupling_grids(coup, (H, W))[0].reshape(4, -1)
    flat = coup[0].reshape(-1)
    for colour in (0, 1):
        for vec in (False, True):
            m = model_2d(H, W, colour, vec)
            ok = torch.from_numpy(m["ok"])
            site = torch.from_numpy(m["site"])[ok]
            for q, key in enumerate(("ju", "jd", "jl", "jr")):
                assert torch.equal(flat[torch.from_numpy(m[key])[ok]], jg[q][site]), key


@pytest.mark.parametrize("shape,d,n_sys", [((4, 6), 2, 3), ((6, 10), 1, 2), ((8, 16), 2, 3),
                                           ((10, 34), 1, 2)],
                         ids=["4x6", "6x10", "8x16", "10x34"])
def test_sweep_2d_philox_counter_and_word_are_colour_uniforms(shape, d, n_sys):
    H, W = shape
    words = torch.from_numpy(np.random.default_rng(5).integers(
        -2**31, 2**31, (d, 2)).astype(np.int32))
    k = words.to(torch.int64) & rng.MASK32
    for colour in (0, 1):
        want = rng.colour_uniforms(words, n_sys, colour, shape).reshape(d, n_sys, -1)
        m = model_2d(H, W, colour, W % 8 == 0)
        ok = torch.from_numpy(m["ok"])
        g = torch.from_numpy(np.repeat(m["g"][:, None], 4, 1))[ok]
        site = torch.from_numpy(m["site"])[ok]
        word = torch.arange(4).expand(ok.shape)[ok]
        for dz in range(d):
            for s in range(n_sys):
                out = rng.philox4x32(k[dz, 0], k[dz, 1], torch.tensor(s),
                                     torch.tensor(colour), g, torch.tensor(0))
                u = rng.uniform24(torch.stack(out, -1).gather(-1, word[:, None])[:, 0])
                assert torch.equal(u, want[dz, s, site])


def _flip_probability(x, gibbs):
    """The kernels' rules (``flip_probability``), x = (-s field) / (T/2)."""
    if gibbs:
        return 1.0 / (1.0 + torch.exp(-x))
    return sweep._KEEP * torch.exp(torch.clamp(x, max=0.0))


def model_sweep_2d(spins, coup, sys_temps, words, *, gibbs, per):
    """Both passes of the model (in place), ``per`` systems a thread: the
    spins, and the measuring pass's partials as the kernel adds them."""
    d, n_sys, H, W = spins.shape
    flat_j = coup.reshape(d, -1)
    s = spins.reshape(d, n_sys, -1)
    parts = None
    for colour in (0, 1):
        m = model_2d(H, W, colour, W % 8 == 0)
        ok = torch.from_numpy(m["ok"])
        n_thr = ok.shape[0]
        blocks = -(-n_thr // THREADS)
        terms = torch.zeros((d, n_sys, blocks * THREADS, 4))
        mterms = torch.zeros((d, n_sys, blocks * THREADS, 4), dtype=torch.int32)
        idx = {key: torch.from_numpy(m[key]) for key in
               ("site", "up", "dn", "left", "right", "ju", "jd", "jl", "jr")}
        u = rng.colour_uniforms(words, n_sys, colour, (H, W)).reshape(d, n_sys, -1)
        for y in range(n_sys // per):
            for q in range(per):  # a thread's systems in turn
                sys_ = y * per + q
                old = s[:, sys_].to(torch.float32)
                jv = {key: flat_j[:, idx[key]] for key in ("ju", "jd", "jl", "jr")}
                sp = {key: old[:, idx[key]] for key in ("site", "up", "dn", "left", "right")}
                field = sp["up"] * jv["ju"] + sp["dn"] * jv["jd"]
                field = field + sp["left"] * jv["jl"]
                field = field + sp["right"] * jv["jr"]
                inv = (1.0 / (0.5 * sys_temps[:, sys_]))[:, None, None]
                p = _flip_probability((-sp["site"] * field) * inv, gibbs)
                flip = (u[:, sys_][:, idx["site"]] < p) & ok
                sv = torch.where(flip, -sp["site"], sp["site"])
                new = s[:, sys_].clone()
                new.scatter_(1, idx["site"][ok].expand(d, -1),
                             sv[:, ok].to(torch.int8))
                s[:, sys_] = new
                partner = torch.where(idx["site"] % 2 == 1, sp["left"], sp["right"])
                terms[:, sys_, :n_thr] = torch.where(ok, sv * field, 0.0)
                mterms[:, sys_, :n_thr] = torch.where(
                    ok, sv.to(torch.int32) + partner.to(torch.int32), 0)
        if colour == 1:
            parts = []
            for t in (terms, mterms):
                acc = torch.zeros_like(t[..., 0])  # e_acc from 0, a site at a time
                for k in range(4):
                    acc = acc + t[..., k]
                acc = acc.reshape(d, n_sys, blocks, THREADS)
                # warp_tree: three levels read by a warp, then the shuffles
                lane = torch.arange(32)
                x = lambda o: acc[..., lane + o]  # noqa: E731
                v = ((x(0) + x(128)) + (x(64) + x(192))) + ((x(32) + x(160)) + (x(96) + x(224)))
                off = 16
                while off:
                    v = v[..., :off] + v[..., off:2 * off]
                    off //= 2
                parts.append(v[..., 0])
    return tuple(parts)


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("shape,d,n_sys,per", [((4, 6), 2, 3, 3), ((6, 10), 1, 4, 2),
                                               ((10, 34), 2, 2, 1), ((8, 16), 2, 3, 3),
                                               ((64, 64), 1, 2, 2), ((40, 48), 1, 1, 1)],
                         ids=["4x6", "6x10", "10x34", "8x16", "64x64", "40x48"])
def test_sweep_2d_model_is_bitwise_plain(shape, d, n_sys, per, gibbs, couplings):
    g = np.random.default_rng(7 + n_sys)
    H, W = shape
    coup = torch.from_numpy((g.choice([-1.0, 1.0], (d, H * W, 2)) if couplings == "pm"
                             else g.standard_normal((d, H * W, 2))).astype(np.float32))
    spins = torch.from_numpy(g.choice([-1, 1], (d, n_sys, H, W)).astype(np.int8))
    temps = torch.from_numpy(g.uniform(1.0, 3.5, (d, n_sys)).astype(np.float32))
    words = torch.from_numpy(g.integers(-2**31, 2**31, (d, 2)).astype(np.int32))
    jg = sweep.pack_coupling_grids(coup, shape)
    a, b, c = spins.clone(), spins.clone(), spins.clone()
    got = model_sweep_2d(a, coup, temps, words, gibbs=gibbs, per=per)
    pp = sweep.sweep_2d_plain(b, jg, temps, words, gibbs=gibbs, measure=True)
    want = sweep.sweep_2d_partials(c, jg, temps, words, gibbs=gibbs)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, spins)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(want[1].sum(-1), pp[1][..., 0])
    if couplings == "pm":  # even integers below 2^24: exact in any order
        assert torch.equal(want[0].sum(-1), pp[0][..., 0])


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (6, 10)], ids=["64", "256", "6x10"])
def test_sweep_2d_partials_sum_to_the_plain_energy(shape):
    """Gaussian couplings: the partials' in-order sum against torch.sum of
    the same terms, within the f32 bound of two summation orders, 2 (n - 1)
    2^-24 sum |term| (n terms)."""
    g = np.random.default_rng(11)
    H, W = shape
    d, n_sys = 2, 3
    coup = torch.from_numpy(g.standard_normal((d, H * W, 2)).astype(np.float32))
    spins = torch.from_numpy(g.choice([-1, 1], (d, n_sys, H, W)).astype(np.int8))
    temps = torch.from_numpy(g.uniform(1.0, 3.5, (d, n_sys)).astype(np.float32))
    words = torch.from_numpy(g.integers(-2**31, 2**31, (d, 2)).astype(np.int32))
    jg = sweep.pack_coupling_grids(coup, shape)
    b, c = spins.clone(), spins.clone()
    pp = sweep.sweep_2d_plain(b, jg, temps, words, gibbs=False, measure=True)
    pe, _ = sweep.sweep_2d_partials(c, jg, temps, words, gibbs=False)
    # the magnitudes of the terms: |s field| = |field| at the odd sites
    s = c.to(torch.float32)
    field = sweep.local_field(s, jg[:, None])
    mag = field.abs()[..., sweep.colour_mask(shape, 1, "cpu")].sum(-1).double()
    n = H * W // 2
    err = (pe.double().sum(-1) - pp[0][..., 0].double()).abs()
    assert bool((err <= 2 * (n - 1) * 2.0**-24 * mag).all()), (err, mag)


# ------------------------------------------------------------- sweep_nb


class Walk:
    """``Lattice.sweep_words``: a ``csrc/band.cuh`` ``BandWalk``."""

    def __init__(self, words):
        w = words.astype(np.int64)
        self.L = [int(x) for x in w[:3]]
        self.nb = int(w[3])
        self.off = w[4:22].reshape(6, 3)[:self.nb]
        assert list(w[22:26]) == [self.L[0], 0, 0, self.L[0]]
        self.res = w[26:50].reshape(6, 4)[:self.nb]
        self.div = words[50:56].view(np.uint32).astype(np.int64).reshape(3, 2)
        self.block = self.L[1] * self.L[2]
        self.n = self.L[0] * self.block


def model_nb(lat, colour):
    """The ``sweep_nb`` kernel's indices for one colour pass: per thread g
    whose group holds a site of the colour, its sites' activity, index,
    forward and backward neighbours per offset (``nb_site``)."""
    w = Walk(lat.sweep_words)
    n = w.n
    col = lat.colors.astype(np.int64)
    g = np.arange(-(-n // 4))
    i = 4 * g[:, None] + np.arange(4)
    act = (i < n) & (col[np.minimum(i, n - 1)] == colour)
    keep = act.any(1)  # the other groups return
    g, i, act = g[keep], i[keep], act[keep]
    i0 = 4 * g
    r = _div(i0, *w.div[0])
    p = i0 - r * w.block
    c1 = _div(p, *w.div[1])
    c2 = p - c1 * w.L[2]
    three = w.L[2] > 1
    coords = []
    for k in range(4):
        if k:  # the step to the next site
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
        coords.append((r.copy(), c1.copy(), c2.copy()))
    fwd = np.zeros(i.shape + (w.nb,), np.int64)
    bwd = np.zeros_like(fwd)
    for k, (rk, a1, a2) in enumerate(coords):
        for d in range(w.nb):
            for back, out in ((False, fwd), (True, bwd)):
                n0 = rk - w.off[d, 0] if back else rk + w.off[d, 0]
                n0 = np.where(n0 < 0, n0 + w.L[0], n0) if back else \
                    np.where(n0 >= w.L[0], n0 - w.L[0], n0)
                n1 = a1 + w.res[d, 2 if back else 0]
                n1 = np.where(n1 >= w.L[1], n1 - w.L[1], n1)
                n2 = a2 + w.res[d, 3 if back else 1]
                n2 = np.where(n2 >= w.L[2], n2 - w.L[2], n2) if three else 0
                out[:, k, d] = (n0 * w.L[1] + n1) * w.L[2] + n2
    return dict(g=g, i=i, act=act, fwd=fwd, bwd=bwd)


# (name, shape, offsets): extents 2, 4, 6, 10, 34, 256 on the square,
# cubic, triangular, BCC, FCC and NNN offsets, and offsets past the extents
NB_LATTICES = [
    ("square-2x4", (2, 4), None), ("square-34x10", (34, 10), None),
    ("cubic-2x4x6", (2, 4, 6), None), ("cubic-6x10x34", (6, 10, 34), None),
    ("tri-4x6", (4, 6), "triangular"), ("tri-10x34", (10, 34), "triangular"),
    ("tri-2x256", (2, 256), "triangular"),
    ("bcc-2x4x6", (2, 4, 6), "bcc"), ("bcc-6x10x34", (6, 10, 34), "bcc"),
    ("fcc-4x2x10", (4, 2, 10), "fcc"), ("fcc-6x6x34", (6, 6, 34), "fcc"),
    ("nnn-6x10", (6, 10), NNN), ("nnn-34x256", (34, 256), NNN),
    ("far-8x6", (8, 6), [[3, 0], [1, 2], [9, -7]]),
    ("far-4x6x2", (4, 6, 2), [[5, -1, 0], [0, 7, 3]]),
]


def _lattice(shape, offsets):
    return Lattice(shape, GEOMETRY_OFFSETS[offsets] if isinstance(offsets, str) else offsets)


@pytest.mark.parametrize("name,shape,offsets", NB_LATTICES, ids=[c[0] for c in NB_LATTICES])
def test_sweep_nb_division_free_neighbours_are_the_lattice_tables(name, shape, offsets):
    lat = _lattice(shape, offsets)
    seen = np.zeros(lat.n_spins, np.int64)
    for colour in range(lat.n_colors):
        m = model_nb(lat, colour)
        i, act = m["i"][m["act"]], m["act"]
        seen[i] += 1
        np.testing.assert_array_equal(lat.colors[i], colour)
        np.testing.assert_array_equal(m["fwd"][act], lat.fwd[i])
        np.testing.assert_array_equal(m["bwd"][act], lat.bwd[i])
        # the groups skipped hold no site of the colour
        rest = np.setdiff1d(np.arange(-(-lat.n_spins // 4)), m["g"])
        assert not np.isin(4 * rest[:, None] + np.arange(4), np.flatnonzero(
            lat.colors == colour)).any()
    np.testing.assert_array_equal(seen, 1)  # every site once a sweep


@pytest.mark.parametrize("name,shape,offsets", NB_LATTICES[4:8],
                         ids=[c[0] for c in NB_LATTICES[4:8]])
def test_sweep_nb_philox_counter_and_word_are_site_uniforms(name, shape, offsets):
    lat = _lattice(shape, offsets)
    d, n_sys = 2, 3
    words = torch.from_numpy(np.random.default_rng(9).integers(
        -2**31, 2**31, (d, 2)).astype(np.int32))
    k = words.to(torch.int64) & rng.MASK32
    for colour in range(lat.n_colors):
        want = rng.site_uniforms(words, n_sys, colour, lat.n_spins)
        m = model_nb(lat, colour)
        act = torch.from_numpy(m["act"])
        g = torch.from_numpy(np.repeat(m["g"][:, None], 4, 1))[act]
        word = torch.arange(4).expand(act.shape)[act]
        site = torch.from_numpy(m["i"])[act]
        for dz in range(d):
            for s in range(n_sys):
                out = rng.philox4x32(k[dz, 0], k[dz, 1], torch.tensor(s),
                                     torch.tensor(colour), g, torch.tensor(0))
                u = rng.uniform24(torch.stack(out, -1).gather(-1, word[:, None])[:, 0])
                assert torch.equal(u, want[dz, s, site])


def model_sweep_nb(spins, coup, lat, sys_temps, words, *, gibbs):
    """One sweep of the model (in place): each site's field from the
    forward couplings at the site and at its backward neighbour, adds in
    the kernel's order, the flips stored after the group's decisions."""
    d, n_sys, n = spins.shape
    for colour in range(lat.n_colors):
        m = model_nb(lat, colour)
        act = torch.from_numpy(m["act"])
        i = torch.from_numpy(m["i"])[act]
        fwd = torch.from_numpy(m["fwd"])[act]
        bwd = torch.from_numpy(m["bwd"])[act]
        u = rng.site_uniforms(words, n_sys, colour, n)[..., i]
        s = spins.to(torch.float32)
        field = torch.zeros((d, n_sys, i.numel()))
        for dd in range(lat.n_neighbors):
            jf = coup[:, i, dd][:, None]
            jb = coup[:, bwd[:, dd], dd][:, None]
            field = field + s[..., fwd[:, dd]] * jf
            field = field + s[..., bwd[:, dd]] * jb
        sv = s[..., i]
        eng = -sv * field
        if gibbs:
            flip = eng >= (sys_temps * 0.5)[..., None] * torch.log(u / (1.0 - u))
        else:
            x = eng * (1.0 / (sys_temps * 0.5))[..., None]
            flip = u < _flip_probability(x, False)
        spins[..., i] = torch.where(flip, -sv, sv).to(torch.int8)


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("name,shape,offsets", NB_LATTICES, ids=[c[0] for c in NB_LATTICES])
def test_sweep_nb_model_is_bitwise_plain(name, shape, offsets, couplings):
    lat = _lattice(shape, offsets)
    g = np.random.default_rng(13)
    d, n_sys, n, nb = 2, 3, lat.n_spins, lat.n_neighbors
    coup = (g.choice([-1.0, 1.0], (d, n, nb)) if couplings == "pm"
            else g.standard_normal((d, n, nb))).astype(np.float32)
    coup_t = torch.from_numpy(coup)
    coup_bwd = torch.from_numpy(np.ascontiguousarray(coup[:, lat.bwd, np.arange(nb)[None]]))
    spins = torch.from_numpy(g.choice([-1, 1], (d, n_sys, n)).astype(np.int8))
    temps = torch.from_numpy(g.uniform(1.0, 9.0, (d, n_sys)).astype(np.float32))
    colours = torch.from_numpy(lat.colors.astype(np.uint8))
    a, b = spins.clone(), spins.clone()
    for gibbs in (False, True):
        words = torch.from_numpy(g.integers(-2**31, 2**31, (d, 2)).astype(np.int32))
        model_sweep_nb(a, coup_t, lat, temps, words, gibbs=gibbs)
        sweep.sweep_nb_plain(b, coup_t, coup_bwd, colours, temps, words, lat, gibbs=gibbs)
        assert torch.equal(a, b), gibbs
    assert not torch.equal(a, spins)


# ------------------------------------------------------- grids and the rule


def _grid(n_groups, d, n_sys, per):
    """The kernels' launch: (blocks of 256 groups, systems / per, d)."""
    return (-(-n_groups // THREADS), n_sys // per, d)


@pytest.mark.parametrize("shape,d,n_sys", [((16384, 16384), 1, 4), ((1024, 1024, 1024), 1, 2),
                                           ((32768, 16384), 2, 8)],
                         ids=["16384^2", "1024^3", "32768x16384"])
def test_grids_past_65535_blocks_stay_within_cuda_limits(shape, d, n_sys):
    """x holds the blocks of groups (up to 2^31 - 1), y the systems / per and
    z the realizations (up to 65535 each); each thread one group, no
    stride.  The square lattice counts its active sites, the others all."""
    n = int(np.prod(shape))
    for n_groups in (-(-(n // 2) // 4), -(-n // 4)):
        per = sweep.systems_per(n_groups, d, n_sys, HALF)
        x, y, z = _grid(n_groups, d, n_sys, per)
        assert x > 65535 and x < 2**31 and y <= 65535 and z <= 65535
        assert x * THREADS >= n_groups > (x - 1) * THREADS
        # the largest group's first site and the divisions stay below 2^31
        assert 4 * (n_groups - 1) < 2**31
    W = shape[-1]
    m, s = fast_divisor(W // 2)
    i0 = np.array([0, 4, n // 2 - 4, n // 2 - 4 - 2 * W], np.int64)
    np.testing.assert_array_equal(_div(i0, m, s), i0 // (W // 2))


@pytest.mark.parametrize("n_groups,d,n_sys,want", [
    (4096 * 2048 // 4, 1, 4, 4),      # the unsharded 4096^2 x 4: all four
    (64 * 32 // 4, 128, 16, 4),       # the harness: 4 keeps 262,144 threads
    (256 * 128 // 4, 1, 1, 1),        # config 3
    (32 * 16 // 4, 1, 16, 1),         # row 4's 32^2 x 16: 1 (2048 threads)
    (4096 * 2048 // 4, 1, 24, 8),     # the cap of 8
    (4096 * 2048 // 4, 1, 9, 3),      # the largest divisor up to 8
    (4096 * 2048 // 4, 1, 7, 7),
    (2 ** 20, 1, 1024, 8),
    (1024, 16, 8, 1),                 # 131,072 threads with one system a thread
    (8192, 1, 16, 1),                 # 32^3 x 16: 2 would keep 65,536
], ids=["4096", "harness", "config3", "row4", "cap", "nine", "seven", "wide", "short",
        "cubic32"])
def test_systems_per_rule(n_groups, d, n_sys, want):
    per = sweep.systems_per(n_groups, d, n_sys, HALF)
    assert per == want
    assert n_sys % per == 0 and per <= sweep.MAX_PER
    if per > 1:  # it still fills the card, and the next divisor would not
        assert n_groups * d * (n_sys // per) >= HALF
    bigger = [p for p in range(per + 1, sweep.MAX_PER + 1) if n_sys % p == 0]
    assert all(n_groups * d * (n_sys // p) < HALF for p in bigger)


def test_the_engine_hands_sweep_2d_the_forward_couplings(monkeypatch):
    """The square lattice's per-sweep run passes ``rt.coup`` to ``sweep_2d``;
    its pre-shifted grids (the mega path's ``rt.jgrids``) are
    ``pack_coupling_grids`` of it, bit for bit, and the engine builds them
    nowhere else."""
    from peapods_tpu_torch.engine import loop, simulation

    seen = []
    real = loop.sweep_2d

    def spy(spins, coup, *args, **kw):
        seen.append(coup)
        return real(spins, coup, *args, **kw)

    monkeypatch.setattr(loop, "sweep_2d", spy)
    g = np.random.default_rng(2)
    coup = g.standard_normal((2, 8, 8, 2)).astype(np.float32)
    sim = simulation.IsingSimulation([8, 8], coup, np.array([1.5, 2.5], np.float32), 1, None,
                                     4, device="cpu")
    sim.sample(4, "metropolis", warmup_ratio=0.0, cluster_update_interval=2,
               cluster_mode="sw")
    rt = sim.rt
    assert seen and all(c is rt.coup for c in seen)
    assert torch.equal(rt.coup, torch.from_numpy(coup.reshape(2, 64, 2)))
    assert torch.equal(rt.jgrids, sweep.pack_coupling_grids(rt.coup, (8, 8)))
    src = inspect.getsource(loop.Runtime.build)
    assert src.count("jgrids=") == 2 and "pack_coupling_grids(coup, lattice.shape)" in src
