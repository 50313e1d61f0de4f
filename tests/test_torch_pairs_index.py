"""The launch mapping and word arithmetic of ``pair_overlap``
(``csrc/pairs.cu``, the replica path's pair measurement) on the CPU, as
``tests/test_torch_colour_index.py`` models ``colour_pass``'s.

* ``megapair.pair_words``: the word of ``W`` bytes (8 or 4 where the fast
  extent holds whole words and the spins are aligned to them, else 1: the
  per-site path), the lines, the threads a column (one word each: 64 at
  8^3, 128 at 32^2, 512 at 16^3), the CTA and each forward offset's steps;
  a numpy model of the launch: every (realization, pair, temperature,
  word) is read once, every warp lies in one column, and a CTA holds
  ``block / tpc`` columns.
* Each word's neighbour words along each offset (the word of the line
  that its slower components reach, found with the multiply-shift
  divisions and one compare an axis, at the fast component's word shift
  and the next word, shifted by its byte shift; on the square and cubic
  lattices the line's next word and the same word of the next line or
  plane) hold the forward neighbours of its sites, as the lattice's modulo
  tables give them: the axes, and the triangular, BCC, FCC and NNN
  lattices and offset tables with negative, long and self-bond components.
* The popcount identity: with spins in {-1, +1}, the sign bits of ``a ^ b``
  are the disagreements, ``q_i q_j = 1 - 2 (delta_i XOR delta_j)``, and the
  model's counts give ``qs`` and ``ql`` bitwise
  ``megapair.pair_overlap_plain`` and the JAX package's ``overlap_dots``
  (``peapods_tpu/ops/measure.py``), 2D and 3D, extents 2 to 32, R = 2, 4
  and 6, random ``sid`` permutations, on every lattice above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu.ops.measure import overlap_dots as ref_overlap_dots
from peapods_tpu_torch.ops import megapair
from peapods_tpu_torch.ops.lattice import Lattice, fast_divisor

torch.set_num_threads(1)

# (shape, realizations, replicas, temperatures): configs 4, 5 and 1, and
# extents from 2 to 32 whose fast axis holds 8-byte words, 4-byte words or
# neither (the per-site path)
CASES = [((8, 8, 8), 2, 4, 24), ((16, 16, 16), 1, 4, 6), ((32, 32), 2, 2, 16),
         ((2, 2), 2, 2, 3), ((2, 8), 1, 6, 2), ((4, 12), 2, 4, 3), ((6, 6), 1, 2, 5),
         ((10, 2), 2, 6, 2), ((2, 2, 2), 3, 2, 2), ((4, 6, 4), 1, 6, 3),
         ((2, 4, 8), 2, 4, 2), ((6, 2, 10), 1, 2, 4), ((4, 4, 32), 1, 4, 2),
         ((32, 2, 16), 1, 2, 2)]
IDS = ["x".join(map(str, c[0])) + f"-R{c[2]}" for c in CASES]


def _div(n, m, s):
    n = np.asarray(n, np.uint64)
    q = ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)
    return (n if m == 0 else q).astype(np.int64)


class Walk:
    """The words of a ``PairWalk`` (``csrc/pairs.cu`` ``make_pair_walk``)."""

    def __init__(self, words):
        w = words.astype(np.int64)
        (self.W, self.n, self.nw, self.wpl, self.Lb, self.La, self.nd, self.T, self.cols,
         self.n_slots, self.tpc, self.lt, self.block, self.n_nb,
         self.axes) = (int(x) for x in w[:15])
        self.div = words[15:21].view(np.uint32).astype(np.int64).reshape(3, 2)
        self.steps = w[21:45].reshape(6, 4)[:self.n_nb]  # (ra, rb, q, b) an offset


def launch_cover(g, d):
    """The words each thread of the launch reads: ``(count [d, cols, nw],
    warps)``, the count of reads of each (realization, column, word) and,
    per warp, the set of columns its threads take."""
    cpc = g.block // g.tpc
    gx = -(-g.cols // cpc)
    tid = np.arange(g.block)
    seen = np.zeros((d, g.cols, g.nw), np.int64)
    warps = []
    for by in range(d):
        for bx in range(gx):
            x = tid & (g.tpc - 1)
            col = bx * cpc + (tid >> g.lt)
            for w in range(g.block // 32):
                warps.append(set(col[32 * w:32 * w + 32].tolist()))
            for t in tid[col < g.cols]:
                seen[by, col[t], np.arange(x[t], g.nw, g.tpc)] += 1
    return seen, warps


def axes_words(g, k):
    """``pair_link_bits``' axes form (``AXES``): the line's next word, the
    same word of the next line and, in 3D, of the next plane."""
    k = np.asarray(k, np.int64)
    line = _div(k, *g.div[0])
    pos = k - line * g.wpl
    kf = np.where(pos + 1 < g.wpl, k + 1, k + 1 - g.wpl)
    if g.La:
        ca = _div(line, *g.div[1])
        cb = line - ca * g.Lb
    else:
        ca, cb = np.zeros_like(line), line
    kb = np.where(cb + 1 < g.Lb, k + g.wpl, k + g.wpl - g.Lb * g.wpl)
    plane = g.Lb * g.wpl
    ka = np.where(ca + 1 < g.La, k + plane, k + plane - g.nw) if g.La else None
    return kf, kb, ka


def neighbour_words(g, k):
    """``pair_link_bits``' words of words ``k``, one ``(k1, k2, b)`` an
    offset: the words at the offset's word shift and the next one on the
    line its slower components reach, and its byte shift (``k1`` is ``k``
    itself where the offset stays on the line and shifts no word)."""
    k = np.asarray(k, np.int64)
    line = _div(k, *g.div[0])
    pos = k - line * g.wpl
    if g.La:
        ca = _div(line, *g.div[1])
        cb = line - ca * g.Lb
    else:
        ca, cb = np.zeros_like(line), line
    out = []
    for ra, rb, q, b in g.steps:
        nb = cb + rb
        nb = np.where(nb >= g.Lb, nb - g.Lb, nb)
        if g.La:
            na = ca + ra
            nb = nb + np.where(na >= g.La, na - g.La, na) * g.Lb
        p1 = pos + q
        p1 = np.where(p1 >= g.wpl, p1 - g.wpl, p1)
        p2 = np.where(p1 + 1 < g.wpl, p1 + 1, 0)
        out.append((nb * g.wpl + p1, nb * g.wpl + p2, int(b)))
    return out


_UINT = {8: "<u8", 4: "<u4", 1: "u1"}


def delta_bits(a, b, W):
    """``delta_bits``: the sign bits of ``a ^ b`` (int8 ``[..., n]``) as
    ``W``-byte little-endian words ``[..., n / W]`` in uint64."""
    x = np.ascontiguousarray(a).view(_UINT[W]) ^ np.ascontiguousarray(b).view(_UINT[W])
    return x.astype(np.uint64) & np.uint64(0x8080808080808080 >> (64 - 8 * W))


def _popc(x):
    return np.bitwise_count(x).astype(np.int64)


def model_counts(a, b, g):
    """``(sum delta, sum over forward bonds of delta_i XOR delta_j)`` of the
    systems ``a``, ``b`` (int8 ``[..., n]``) with the kernel's word
    arithmetic: ``pair_overlap_kernel``'s loop over all words."""
    m = delta_bits(a, b, g.W)
    k = np.arange(g.nw)
    full = np.uint64((2**64 - 1) >> (64 - 8 * g.W))
    nx = 0
    for k1, k2, sh in neighbour_words(g, k):
        nbits = m[..., k1]
        if g.W > 1 and sh:
            nbits = ((nbits >> np.uint64(8 * sh))
                     | (m[..., k2] << np.uint64(8 * (g.W - sh)))) & full
        nx = nx + _popc(m ^ nbits)
    return _popc(m).sum(-1), nx.sum(-1)


def model_pair_overlap(spins, sid, shape, n_rep, align=0, offsets=None):
    """The kernel's ``(qs, ql)`` int32 ``[d, P T]``: each column's systems
    through ``sid`` (slot ``col + p T`` and its partner ``T`` later), the
    counts as ``n - 2 nq`` and ``n_nb n - 2 nx``."""
    d, n_slots, n = spins.shape
    g = Walk(megapair.pair_words(tuple(shape), n_rep, n_slots, align, offsets))
    col = np.arange(g.cols)
    p = _div(col, *g.div[2])
    sa = col + p * g.T
    di = np.arange(d)[:, None]
    a = spins[di, sid[di, sa]]
    b = spins[di, sid[di, sa + g.T]]
    nq, nx = model_counts(a, b, g)
    return (g.n - 2 * nq).astype(np.int32), (g.n_nb * g.n - 2 * nx).astype(np.int32)


def _inputs(shape, d, n_rep, n_temps, seed):
    r = np.random.default_rng(seed)
    n = int(np.prod(shape))
    s = n_rep * n_temps
    spins = r.choice(np.array([-1, 1], np.int8), size=(d, s, n))
    sid = np.stack([r.permutation(s) for _ in range(d)]).astype(np.int32)
    return spins, sid


@pytest.mark.parametrize("shape,d,n_rep,n_temps", CASES, ids=IDS)
def test_words_and_launch_read_every_word_once(shape, d, n_rep, n_temps):
    s = n_rep * n_temps
    w = megapair.pair_words(shape, n_rep, s)
    g = Walk(w)
    n = int(np.prod(shape))
    fast = shape[-1]
    want_w = 8 if fast % 8 == 0 else 4 if fast % 4 == 0 else 1
    assert (g.W, g.n, g.nw, g.wpl) == (want_w, n, n // want_w, fast // want_w)
    assert (g.Lb, g.La, g.nd, g.n_nb) == ((shape[0], 0, 2, 2) if len(shape) == 2
                                          else (shape[1], shape[0], 3, 3))
    assert (g.T, g.cols, g.n_slots) == (n_temps, (n_rep // 2) * n_temps, s)
    # the fewest threads a column (a power of two from 32) that read at
    # most one word each, and CTAs of 128 threads or one column
    assert g.tpc == 1 << g.lt and 32 <= g.tpc <= 1024
    assert g.tpc * megapair.PAIR_WORDS_A_THREAD >= g.nw or g.tpc == 1024
    assert g.tpc == 32 or (g.tpc // 2) * megapair.PAIR_WORDS_A_THREAD < g.nw
    assert g.block == max(128, g.tpc) and g.block % g.tpc == 0
    for k, x in enumerate((g.wpl, g.Lb, n_temps)):
        assert tuple(g.div[k]) == fast_divisor(x)
    seen, warps = launch_cover(g, d)
    assert (seen == 1).all()
    # each warp takes one column, or none (the last CTA's ragged end)
    assert all(len(c) == 1 for c in warps)


@pytest.mark.parametrize("shape,words_a_thread,tpc", [
    ((8, 8, 8), 1, 64), ((32, 32), 1, 128), ((16, 16, 16), 1, 512),
    ((64, 64, 64), 32, 1024), ((2, 2), 1, 32)],
    ids=["config4", "config1", "config5", "64^3", "2x2"])
def test_threads_a_column(shape, words_a_thread, tpc):
    """A word a thread: two warps a column at config 4's 8^3 (two columns a
    CTA), four at config 1's 32^2 and sixteen at config 5's 16^3 (a CTA a
    column); 1024 threads and more words each beyond 32^3 sites."""
    g = Walk(megapair.pair_words(shape, 4, 96))
    assert g.tpc == tpc
    assert -(-g.nw // g.tpc) == min(words_a_thread, -(-g.nw // 32))
    assert g.block // g.tpc == max(1, 128 // tpc)


@pytest.mark.parametrize("fast,align,w", [
    (8, 0, 8), (16, 4, 4), (16, 2, 1), (12, 0, 4), (12, 4, 4), (6, 0, 1), (2, 0, 1),
    (32, 1, 1)])
def test_word_bytes_follow_the_fast_extent_and_alignment(fast, align, w):
    assert megapair.pair_word_bytes(fast, align) == w


def _assert_neighbours(g, fwd):
    """Byte j of an offset's neighbour bits of word k is the forward
    neighbour of site k W + j: byte j + b of word k1 below W - b, else byte
    j - (W - b) of word k2."""
    k = np.arange(g.nw)
    j = np.arange(g.W)
    site = k[:, None] * g.W + j
    for d, (k1, k2, b) in enumerate(neighbour_words(g, k)):
        got = np.where(j + b < g.W, k1[:, None] * g.W + j + b,
                       k2[:, None] * g.W + j + b - g.W)
        np.testing.assert_array_equal(got, fwd[site, d])
        ra, rb, q = g.steps[d][:3]
        if ra == rb == q == 0:  # the kernel takes the word itself
            np.testing.assert_array_equal(k1, k)


@pytest.mark.parametrize("shape,d,n_rep,n_temps", CASES, ids=IDS)
def test_neighbour_words_hold_the_forward_neighbours(shape, d, n_rep, n_temps):
    """Along the fast axis byte q's forward neighbour is byte q + 1 of the
    word, or byte 0 of the line's next word (the shifted-in one) for the
    last byte; along each slower axis it is byte q of the next line's
    (plane's) word: the modulo tables'."""
    g = Walk(megapair.pair_words(shape, n_rep, n_rep * n_temps))
    nd = len(shape)
    k = np.arange(g.nw)
    fast, *slow = neighbour_words(g, k)[::-1]
    assert fast[2] == (1 if g.W > 1 else 0)
    assert all(b == 0 for _, _, b in slow)
    _assert_neighbours(g, Lattice(shape).fwd)  # offsets along axes 0 .. nd-1
    assert g.n_nb == nd and g.axes == 1
    # the axes form reads the same words as the steps
    kf, kb, ka = axes_words(g, k)
    np.testing.assert_array_equal(fast[1] if g.W > 1 else fast[0], kf)
    np.testing.assert_array_equal(slow[0][0], kb)  # slow: axes nd-2 .. 0
    if nd == 3:
        np.testing.assert_array_equal(slow[1][0], ka)
    else:
        assert ka is None


def test_popcount_identity():
    """Spin bytes are 0x01 and 0xff: the sign bit of a ^ b is a != b, so
    q = a b = 1 - 2 delta, and q_i q_j = 1 - 2 (delta_i XOR delta_j) for
    each of the sixteen spin combinations; a word's popcount of those bits
    is its count of disagreements."""
    v = np.array([-1, 1], np.int8)
    a, b, c, e = np.meshgrid(v, v, v, v, indexing="ij")
    a, b, c, e = (x.reshape(-1) for x in (a, b, c, e))
    da = (((a.view(np.uint8) ^ b.view(np.uint8)) & 0x80) >> 7).astype(np.int64)
    dc = (((c.view(np.uint8) ^ e.view(np.uint8)) & 0x80) >> 7).astype(np.int64)
    np.testing.assert_array_equal(a.astype(np.int64) * b, 1 - 2 * da)
    np.testing.assert_array_equal(a.astype(np.int64) * b * c * e, 1 - 2 * (da ^ dc))
    r = np.random.default_rng(0)
    x, y = (r.choice(v, size=(64, 8)) for _ in range(2))
    for W in (8, 4, 1):
        got = _popc(delta_bits(x, y, W)).sum(-1)
        np.testing.assert_array_equal(got, (x != y).sum(-1))


@pytest.mark.parametrize("shape,d,n_rep,n_temps", CASES, ids=IDS)
def test_model_is_bitwise_plain_and_reference(shape, d, n_rep, n_temps):
    spins, sid = _inputs(shape, d, n_rep, n_temps, int(np.prod(shape)) + n_rep)
    qs, ql = model_pair_overlap(spins, sid, shape, n_rep)
    ps, pl = megapair.pair_overlap_plain(torch.from_numpy(spins), torch.from_numpy(sid),
                                         shape, n_rep)
    np.testing.assert_array_equal(qs, ps.numpy())
    np.testing.assert_array_equal(ql, pl.numpy())
    geom = GridOps.from_lattice(RefLattice(list(shape)))
    for r in range(d):
        ws, wl = ref_overlap_dots(jnp.asarray(spins[r]),
                                  jnp.asarray(sid[r]).reshape(n_rep, n_temps), geom)
        np.testing.assert_array_equal(qs[r], np.asarray(ws).reshape(-1))
        np.testing.assert_array_equal(ql[r], np.asarray(wl).reshape(-1))


@pytest.mark.parametrize("align", [0, 4, 2], ids=["w8", "w4", "w1"])
@pytest.mark.parametrize("shape", [(16, 16), (4, 6, 16)], ids=["16x16", "4x6x16"])
def test_word_widths_agree(shape, align):
    """The 8-byte, 4-byte and per-site words (the spins' alignment picks
    them) give the same sums."""
    spins, sid = _inputs(shape, 2, 4, 3, 5)
    assert megapair.pair_words(shape, 4, 12, align)[0] == {0: 8, 4: 4, 2: 1}[align]
    qs, ql = model_pair_overlap(spins, sid, shape, 4, align)
    ps, pl = megapair.pair_overlap_plain(torch.from_numpy(spins), torch.from_numpy(sid),
                                         shape, 4)
    np.testing.assert_array_equal(qs, ps.numpy())
    np.testing.assert_array_equal(ql, pl.numpy())


# lattices given by offset tables: the triangular lattice (its [1, -1]
# wraps the fast axis backwards), BCC, FCC, the NNN square, and tables with
# a negative axis-0 component, a component of length 2 and a self-bond
TRI = [[1, 0], [0, 1], [1, -1]]
BCC = [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1]]
FCC = [[1, 1, 0], [1, 0, 1], [0, 1, 1], [1, -1, 0], [1, 0, -1], [0, 1, -1]]
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
OFFSET_CASES = [
    ((8, 8), TRI, 2, 2, 3), ((4, 12), TRI, 1, 4, 2), ((6, 6), TRI, 2, 2, 2),
    ((32, 32), TRI, 1, 2, 4), ((8, 16), NNN, 2, 4, 2), ((6, 10), NNN, 1, 2, 3),
    ((4, 4, 4), BCC, 2, 2, 2), ((4, 4, 8), BCC, 1, 4, 2), ((10, 10, 10), BCC, 1, 2, 2),
    ((4, 4, 4), FCC, 1, 2, 3), ((6, 4, 8), FCC, 2, 2, 2), ((10, 10, 10), FCC, 1, 2, 2),
    ((8, 8), [[-1, 2], [0, -3], [2, 1]], 2, 2, 2), ((4, 6, 8), [[0, 0, -1], [2, 0, 3]], 1, 2, 2),
    ((4, 8), [[0, 8], [1, 0]], 1, 2, 2), ((8, 4), [[1, 0], [0, 5]], 1, 2, 3)]
OFFSET_IDS = ["x".join(map(str, c[0])) + f"-{len(c[1])}nb-{i}"
              for i, c in enumerate(OFFSET_CASES)]


@pytest.mark.parametrize("shape,offsets,d,n_rep,n_temps", OFFSET_CASES, ids=OFFSET_IDS)
def test_offset_steps_and_neighbour_words(shape, offsets, d, n_rep, n_temps):
    """Each offset's steps are its components reduced into the extents (the
    fast one into q words and b bytes), and its neighbour words hold the
    forward neighbours of the lattice's modulo tables at every word."""
    for align in (0, 4, 1):
        g = Walk(megapair.pair_words(shape, n_rep, n_rep * n_temps, align, offsets))
        off = np.asarray(offsets)
        assert g.n_nb == len(offsets) and g.nd == len(shape)
        axes = Walk(megapair.pair_words(shape, n_rep, n_rep * n_temps, align))
        assert g.axes == int(g.n_nb == g.nd and np.array_equal(g.steps, axes.steps))
        fast = off[:, -1] % shape[-1]
        np.testing.assert_array_equal(g.steps[:, 2] * g.W + g.steps[:, 3], fast)
        assert ((g.steps[:, 3] >= 0) & (g.steps[:, 3] < g.W)).all()
        np.testing.assert_array_equal(g.steps[:, 1], off[:, -2] % g.Lb)
        np.testing.assert_array_equal(g.steps[:, 0], off[:, 0] % g.La if g.La else 0)
        _assert_neighbours(g, Lattice(shape, offsets).fwd)


@pytest.mark.parametrize("shape,offsets,d,n_rep,n_temps", OFFSET_CASES, ids=OFFSET_IDS)
def test_offset_model_is_bitwise_plain_and_reference(shape, offsets, d, n_rep, n_temps):
    """The model's qs / ql over the offsets bitwise ``pair_overlap_plain``
    and the JAX package's ``overlap_dots`` with the lattice's
    ``neighbor_sum_fwd``, at each word width."""
    spins, sid = _inputs(shape, d, n_rep, n_temps, int(np.prod(shape)) + len(offsets))
    ps, pl = megapair.pair_overlap_plain(torch.from_numpy(spins), torch.from_numpy(sid),
                                         shape, n_rep, offsets)
    for align in (0, 4, 1):
        qs, ql = model_pair_overlap(spins, sid, shape, n_rep, align, offsets)
        np.testing.assert_array_equal(qs, ps.numpy())
        np.testing.assert_array_equal(ql, pl.numpy())
    geom = GridOps.from_lattice(RefLattice(list(shape), offsets))
    for r in range(d):
        ws, wl = ref_overlap_dots(jnp.asarray(spins[r]),
                                  jnp.asarray(sid[r]).reshape(n_rep, n_temps), geom)
        np.testing.assert_array_equal(ps[r].numpy(), np.asarray(ws).reshape(-1))
        np.testing.assert_array_equal(pl[r].numpy(), np.asarray(wl).reshape(-1))
