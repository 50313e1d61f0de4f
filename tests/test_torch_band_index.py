"""The host words and the index arithmetic of the band kernels
(``csrc/band.cuh``; ``csrc/fk.cu`` ``fk_bonds_band``, ``fk_finish_band``;
``csrc/halo.cu`` ``sweep_halo``, ``measure_halo``), and the pairing of their
partial sums, on the CPU.

* ``fast_divisor``'s multiplier and shift give ``n // d`` for every ``0 <=
  n < 2**31`` tried, and ``Band.words`` hold them and the residues of the
  offsets after the words the kernels read before.
* A numpy model of the kernels' division-free coordinates (``band_coords``,
  ``band_next``) and neighbours (``band_neighbour``: a residue added and one
  compare per axis), run over every window site of each geometry of
  ``tests/test_torch_halo.py``, gives the window rows and coordinates of
  ``//`` and ``%`` and the lattice's own neighbour tables wherever the
  step stays in the window (``fk_bonds_band`` tests the row it reaches);
  the square form's colour sites are the plain pass's active sites.
* The warp's reduction of a block's 256 partial terms (three tree levels
  read from shared memory, then five shuffles) pairs the terms as the
  shared-memory tree of ``block_partials`` does: float32 sums from a fixed
  numpy seed, bitwise.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops.lattice import (GEOMETRY_OFFSETS, BandGeometry, Lattice,
                                           fast_divisor)

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
FCC = GEOMETRY_OFFSETS["fcc"]
BCC = GEOMETRY_OFFSETS["bcc"]
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
FAR = [[1, 0], [0, 2], [1, -2], [2, -1]]

# every geometry of tests/test_torch_halo.py (and one that reaches two rows)
GEOMETRIES = [
    ("square", (16, 16), None, 4), ("square-split", (6, 6), None, 3),
    ("square-1", (16, 16), None, 1), ("cubic", (8, 4, 6), None, 4),
    ("cubic-8", (8, 8, 8), None, 2), ("tri", (16, 16), TRI, 4),
    ("tri-wide", (16, 128), TRI, 2), ("bcc", (8, 4, 8), BCC, 2),
    ("fcc", (8, 8, 4), FCC, 4), ("fcc-wide", (16, 16, 8), FCC, 2),
    ("nnn", (16, 16), NNN, 4), ("nnn-wide", (16, 128), NNN, 2), ("far", (16, 12), FAR, 2),
]

N_WORDS = 4 + 3 * 6 + 4  # the words the band kernels read before this layout grew


def _div(n, m, s):
    """The kernels' ``band_div``: ``umulhi(n, m) >> s``, or ``n`` when m = 0."""
    n = np.asarray(n, np.uint64)
    q = ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)
    return (n if m == 0 else q).astype(np.int64)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 10, 12, 16, 63, 64, 65, 100, 128, 255,
                               256, 1000, 1024, 2047, 2048, 4095, 4096, 16384, 65536,
                               4096 * 4096, 2**30 + 3, 2**31 - 1])
def test_fast_divisor_is_floor_division(d):
    m, s = fast_divisor(d)
    assert 0 <= m < 2**32 and 0 <= s < 32
    rng = np.random.default_rng(d % 9973)
    k = np.arange(-2, 3)
    n = np.concatenate([np.arange(0, 4 * d + 8) if d < 5000 else np.arange(0, 4096),
                        (np.arange(1, 64)[:, None] * d + k).ravel(),
                        rng.integers(0, 2**31, 20000), [2**31 - 1, 2**31 - 2]])
    n = n[(n >= 0) & (n < 2**31)]
    np.testing.assert_array_equal(_div(n, m, s), n // d)


def _geometry(shape, offsets, ns):
    lat = Lattice(shape, offsets)
    return lat, BandGeometry(lat, ns)


@pytest.mark.parametrize("name,shape,offsets,ns", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_band_words_hold_residues_and_divisors(name, shape, offsets, ns):
    lat, geom = _geometry(shape, offsets, ns)
    L1 = shape[1]
    L2 = shape[2] if len(shape) == 3 else 1
    for b in geom.bands:
        w = b.words.astype(np.int64)
        assert b.words.dtype == np.int32 and len(b.words) == N_WORDS + 4 * 6 + 6
        np.testing.assert_array_equal(w[:4], [b.rows, L1, L2, lat.n_neighbors])
        np.testing.assert_array_equal(w[22:26], [shape[0], b.row0, b.halo, b.hl])
        off = w[4:22].reshape(6, 3)
        res = w[26:50].reshape(6, 4)
        for d in range(6):
            o = off[d]
            assert list(res[d]) == [o[1] % L1, o[2] % L2, -o[1] % L1, -o[2] % L2]
            assert all(0 <= r < L for r, L in zip(res[d], (L1, L2, L1, L2)))
        div = b.words[50:56].view(np.uint32).astype(np.int64).reshape(3, 2)
        for (m, s), dv in zip(div, (L1 * L2, L2, L1 // 2)):
            assert (m, s) == fast_divisor(dv)


def _model_coords(words, i):
    """``band_coords``: (row, c1, c2) of sites ``i`` through the words'
    divisors."""
    L1, L2 = int(words[1]), int(words[2])
    div = words[50:56].view(np.uint32).astype(np.int64).reshape(3, 2)
    row = _div(i, *div[0])
    p = i - row * (L1 * L2)
    c1 = _div(p, *div[1])
    return row, c1, p - c1 * L2


def _model_neighbour(words, w, c1, c2, d, back):
    """``band_neighbour``: a residue added and one compare on each periodic
    axis, the row offset along axis 0."""
    L1, L2 = int(words[1]), int(words[2])
    res = words[26:50].astype(np.int64).reshape(6, 4)
    o0 = int(words[4 + 3 * d])
    n1 = c1 + res[d, 2 if back else 0]
    n1 = np.where(n1 >= L1, n1 - L1, n1)
    n2 = c2 + res[d, 3 if back else 1]
    n2 = np.where(n2 >= L2, n2 - L2, n2)
    return w + (-o0 if back else o0) * L1 * L2 + (n1 - c1) * L2 + (n2 - c2)


def _model_next(words, c1, c2):
    """``band_next``: the next site's (c1, c2)."""
    L1, L2 = int(words[1]), int(words[2])
    c2 = c2 + 1
    wrap = c2 == L2
    c2 = np.where(wrap, 0, c2)
    c1 = np.where(wrap, c1 + 1, c1)
    return np.where(c1 == L1, 0, c1), c2


@pytest.mark.parametrize("name,shape,offsets,ns", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_division_free_neighbours_are_the_lattice_neighbours(name, shape, offsets, ns):
    """Every window site: the model's coordinates are those of ``//`` and
    ``%``, stepping from a thread's first site gives the next sites', and
    each neighbour within the window, at +-offset, is the window site at the
    periodic coordinates, whose global site is the lattice's neighbour."""
    lat, geom = _geometry(shape, offsets, ns)
    L1 = shape[1]
    L2 = shape[2] if len(shape) == 3 else 1
    for b in geom.bands:
        words = b.words
        w = np.arange(b.n_window, dtype=np.int64)
        row, c1, c2 = _model_coords(words, w)
        np.testing.assert_array_equal(row, w // b.block)
        np.testing.assert_array_equal(c1, (w % b.block) // L2)
        np.testing.assert_array_equal(c2, w % L2)
        # a thread's four sites from its first (kSitesPerThread consecutive)
        n1, n2 = c1[::4], c2[::4]
        for k in range(1, 4):
            n1, n2 = _model_next(words, n1, n2)
            ok = np.arange(k, b.n_window, 4)
            np.testing.assert_array_equal(n1[:len(ok)], c1[ok])
            np.testing.assert_array_equal(n2[:len(ok)], c2[ok])
        glob = b.window_sites()
        for d, off in enumerate(lat.offsets):
            off3 = list(off) + [0] * (3 - len(off))
            for back, table in ((False, lat.fwd), (True, lat.bwd)):
                sg = -1 if back else 1
                j = _model_neighbour(words, w, c1, c2, d, back)
                r = row + sg * off3[0]
                inside = (r >= 0) & (r < b.rows)
                want = (r * b.block + ((c1 + sg * off3[1]) % L1) * L2
                        + (c2 + sg * off3[2]) % L2)
                np.testing.assert_array_equal(j[inside], want[inside])
                np.testing.assert_array_equal(glob[j[inside]], table[glob[inside], d])
        # every interior site's neighbours lie in the window
        inner = (row >= b.halo) & (row < b.halo + b.hl)
        assert np.abs(lat.offsets[:, 0]).max() <= b.halo and inner.sum() == b.n_band


@pytest.mark.parametrize("shape,ns", [((16, 16), 4), ((6, 6), 3), ((64, 64), 4),
                                      ((24, 14), 3), ((128, 32), 2)])
def test_square_form_colour_sites_are_the_active_sites(shape, ns):
    """The square form's colour site i: row ``i // (W / 2)`` by the words'
    divisor, column ``2 (i % (W / 2)) + parity``, stepping as a thread
    steps; its window index and periodic left / right neighbours are the
    plain pass's active sites and their neighbours, in order."""
    lat, geom = _geometry(shape, None, ns)
    W = shape[1]
    wh = W // 2
    for b in geom.bands:
        div = b.words[50:56].view(np.uint32).astype(np.int64).reshape(3, 2)
        for colour in (0, 1):
            i = np.arange(b.hl * wh, dtype=np.int64)
            i0 = i[::4]
            r = _div(i0, *div[2])
            jc = i0 - r * wh
            rows, cols = [], []
            for _ in range(4):
                rows.append(r)
                cols.append(2 * jc + ((b.row0 + r + colour) & 1))
                jc = jc + 1
                r = np.where(jc == wh, r + 1, r)
                jc = np.where(jc == wh, 0, jc)
            r = np.stack(rows, 1).ravel()[:len(i)]
            col = np.stack(cols, 1).ravel()[:len(i)]
            idx = (b.halo + r) * W + col
            gr = b.row0 + np.arange(b.hl)[:, None]
            active = ((gr + np.arange(W)) & 1) == colour
            np.testing.assert_array_equal(idx, b.halo * W + np.flatnonzero(active.ravel()))
            lf = np.where(col == 0, idx + W - 1, idx - 1)
            rg = np.where(col == W - 1, idx - W + 1, idx + 1)
            np.testing.assert_array_equal(lf % W, (col - 1) % W)
            np.testing.assert_array_equal(rg % W, (col + 1) % W)
            np.testing.assert_array_equal(lf // W, idx // W)
            np.testing.assert_array_equal(rg // W, idx // W)


def _shared_tree(x):
    """``block_partials``: level by level, ``x[t] += x[t + off]`` for ``t <
    off``, off = 128 .. 1."""
    x = x.copy()
    off = x.shape[-1] // 2
    while off:
        x[..., :off] = x[..., :off] + x[..., off:2 * off]
        off //= 2
    return x[..., 0]


def _warp_tree(x):
    """``warp_tree``: lane l of one warp adds x[l], x[l + 128], x[l + 64],
    x[l + 192], x[l + 32], ... as the first three levels pair them, then
    ``v += shfl_down(v, off)`` for off = 16 .. 1 (a lane past the warp's
    end reads its own value, which no lane below 32 - off uses)."""
    lane = np.arange(32)
    v = ((x[..., lane] + x[..., lane + 128]) + (x[..., lane + 64] + x[..., lane + 192])) + (
        (x[..., lane + 32] + x[..., lane + 160]) + (x[..., lane + 96] + x[..., lane + 224]))
    for off in (16, 8, 4, 2, 1):
        src = np.where(lane + off < 32, lane + off, lane)
        v = v + v[..., src]
    return v[..., 0]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_warp_tree_pairs_as_the_shared_memory_tree(dtype):
    rng = np.random.default_rng(2026)
    if dtype == np.float32:
        x = np.concatenate([rng.standard_normal((400, 256)),
                            rng.standard_normal((400, 256)) * 10.0 ** rng.integers(-6, 7, (400, 1)),
                            rng.choice([-1.0, 1.0, 0.0, 3.5], (200, 256))]).astype(np.float32)
    else:
        x = rng.integers(-4, 5, (1000, 256)).astype(np.int32)
    a, b = _shared_tree(x), _warp_tree(x)
    assert a.dtype == dtype and b.dtype == dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    # another pairing differs: the test can tell pairings apart
    if dtype == np.float32:
        assert (x.sum(-1, dtype=np.float32) != a).any()
