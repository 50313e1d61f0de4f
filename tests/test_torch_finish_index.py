"""The host words and the partition of ``fk_finish`` (``csrc/fk.cu``) on the
CPU, as ``tests/test_torch_band_index.py`` models the band form's.

* ``fk.finish_words`` hold the extents, the bond directions, a CTA's
  partial blocks (halved from 32 until a launch has ``fk.FINISH_CTAS``
  CTAs, but not below the tile that stages the farthest forward neighbour
  a tile of 32 blocks stages) and the sites it stages (its tile and the farthest forward
  neighbour within it), and the multiply-shift divisors of ``n / (L1 L2)``
  and ``n / L2``.  ``fk_finish_band``'s tile (``fk.band_finish_tile``)
  comes from the same rule, ``fk.finish_tile``, over a band's interior
  sites and its offsets' window distances.
* A numpy model of each CTA over every site of a shape: its own sites
  (consecutive partial blocks: every site once over the launch), the sites
  it stages, each site's forward neighbours by the division-free
  coordinates and one compare an axis (the lattice's neighbour tables), and
  which neighbours' coins come from the staged flags and which are drawn
  again: the coins a site at the main paths' shapes.
* The model's flips and post-update terms, paired as one warp adds a
  block's 256 terms (``mega.cuh`` ``warp_tree``), bitwise
  ``fk_finish_plain``'s partials per block on random labels, SW and Wolff,
  gaussian couplings.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops import fk
from peapods_tpu_torch.ops.cluster import cluster_coin_flip_mask, wolff_flip_mask
from peapods_tpu_torch.ops.lattice import (GEOMETRY_OFFSETS, BandGeometry, Lattice,
                                           fast_divisor)

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]

# (name, shape, triangular, graphs): config 3, the harness, 32^3 x 16,
# config 2, a ragged square and cube, 256^2 x 4, the unsharded 4096^2 x 4
SHAPES = [("config3", (256, 256), False, 1), ("harness", (64, 64), False, 2048),
          ("cubic32", (32, 32, 32), False, 16), ("config2", (32, 32), True, 8),
          ("6x10", (6, 10), False, 3), ("8x6x10", (8, 6, 10), False, 6),
          ("256x4", (256, 256), False, 4), ("tri-48", (48, 40), True, 2),
          ("space4096", (4096, 4096), False, 4)]


def _words(shape, tri, b):
    dims = tuple(shape) + (1,) * (3 - len(shape))
    nd = 3 if (tri or len(shape) == 3) else 2
    return fk.finish_words(dims, nd, tri, b), dims, nd


def _div(n, m, s):
    n = np.asarray(n, np.uint64)
    q = ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)
    return (n if m == 0 else q).astype(np.int64)


@pytest.mark.parametrize("name,shape,tri,b", SHAPES, ids=[s[0] for s in SHAPES])
def test_finish_words(name, shape, tri, b):
    w, dims, nd = _words(shape, tri, b)
    assert w.dtype == np.int32 and len(w) == 11
    np.testing.assert_array_equal(w[:5], [*dims, nd, int(tri)])
    parts, ext = int(w[5]), int(w[6])
    n = int(np.prod(dims))
    n_blk = -(-n // 256)
    ctas = -(-n_blk // parts) * b
    # halved from 32 while the launch has fewer than FINISH_CTAS CTAs and
    # half the tile still stages the farthest neighbour 32 blocks stage
    fwd = fk.finish_offsets(dims, nd, tri)
    far = max([0] + [f for f in fwd if f <= 32 * 256])
    assert parts in (1, 2, 4, 8, 16, 32)
    assert parts == 1 or ctas >= fk.FINISH_CTAS or parts * 128 < far
    assert parts == 32 or -(-n_blk // (2 * parts)) * b < fk.FINISH_CTAS
    assert parts * 256 >= far
    tile = parts * 256
    assert ext == tile + max([f for f in fwd if f <= tile], default=0) <= 2 * tile
    assert (parts, ext) == fk.finish_tile(n, tuple(fwd), b)
    div = w[7:11].view(np.uint32).astype(np.int64).reshape(2, 2)
    assert tuple(div[0]) == fast_divisor(dims[1] * dims[2])
    assert tuple(div[1]) == fast_divisor(dims[2])
    # no measurement: no neighbours, no floor, the CTA stages its own sites
    w0 = fk.finish_words(dims, 0, tri, b)
    assert int(w0[3]) == 0 and int(w0[6]) == int(w0[5]) * 256 <= tile
    assert (int(w0[5]), int(w0[6])) == fk.finish_tile(n, (), b)


# fk_finish_band's bands: the space path's 4096^2, 128^3 and 256^2
# triangular in 4 bands, 32^3 FCC, an offset table that reaches two rows,
# one band of a small square: (name, shape, offsets, bands, graphs)
BANDS = [("space4096", (4096, 4096), None, 4, 4), ("cubic128", (128, 128, 128), None, 4, 8),
         ("tri256", (256, 256), TRI, 4, 8), ("fcc32", (32, 32, 32),
                                               GEOMETRY_OFFSETS["fcc"], 4, 4),
         ("far", (16, 12), [[1, 0], [0, 2], [1, -2], [2, -1]], 2, 3),
         ("square-1", (16, 16), None, 1, 2)]


@pytest.mark.parametrize("name,shape,offsets,ns,g", BANDS, ids=[c[0] for c in BANDS])
def test_band_finish_tile_is_the_whole_forms_rule(name, shape, offsets, ns, g):
    """Each band's tile: partial blocks halved from 32 while the launch has
    fewer than fk.FINISH_CTAS CTAs and half the tile stages the farthest
    neighbour 32 blocks stage, as fk_finish's, and the staged sites the
    tile and the farthest forward neighbour within it, each offset's
    distance in window index taken from a site mid-row of the band's first
    interior row and its neighbour's coordinates."""
    lat = Lattice(shape, offsets)
    for band in BandGeometry(lat, ns).bands:
        parts, ext = fk.band_finish_tile(band, g)
        n_blk = -(-band.n_band // 256)
        at = np.array([band.row0] + [x // 2 for x in shape[1:]])
        i = np.ravel_multi_index(at, shape)
        reach = [int(np.ravel_multi_index((at + off) % shape, shape)) - int(i)
                 for off in lat.offsets]
        far = max([0] + [f for f in reach if f <= 32 * 256])
        assert parts in (1, 2, 4, 8, 16, 32)
        assert parts == 1 or -(-n_blk // parts) * g >= fk.FINISH_CTAS or parts * 128 < far
        assert parts == 32 or -(-n_blk // (2 * parts)) * g < fk.FINISH_CTAS
        assert parts * 256 >= far
        tile = parts * 256
        assert ext == tile + max([0] + [f for f in reach if f <= tile]) <= 2 * tile
        assert (parts, ext) == fk.finish_tile(band.n_band, tuple(reach), g)


def _cta(w, q):
    """Model of CTA q (measuring): its first site, own sites, the sites its
    flags cover, and each own site's forward neighbours (the kernel's
    finish_fwd) ``[n_own, nd]``."""
    l0, l1, l2, nd, tri, parts, ext = (int(x) for x in w[:7])
    div = w[7:11].view(np.uint32).astype(np.int64).reshape(2, 2)
    block = l1 * l2
    n = l0 * block
    i0 = q * parts * 256
    n_own = min(parts * 256, n - i0)
    n_flag = min(ext, n - i0)
    i = np.arange(i0, i0 + n_own, dtype=np.int64)
    r = _div(i, *div[0])
    p = i - r * block
    c1 = _div(p, *div[1])
    c2 = p - c1 * l2
    down = np.where(r + 1 == l0, i + block - n, i + block)
    nbrs = []
    for d in range(nd):
        if d == 0:
            nbrs.append(down)
        elif d == 2 and tri:
            nbrs.append(np.where(c1 == 0, down + l1 - 1, down - 1))
        elif d == 1:
            nbrs.append(np.where(c1 + 1 == l1, i + l2 - block, i + l2))
        else:
            nbrs.append(np.where(c2 + 1 == l2, i + 1 - l2, i + 1))
    return i0, n_own, n_flag, np.stack(nbrs, -1)


def _model(shape, tri, b, ctas=None):
    """Every CTA (or those of ``ctas``): own sites, neighbours, staged or
    redrawn."""
    w, dims, nd = _words(shape, tri, b)
    n = int(np.prod(dims))
    n_cta = -(-(-(-n // 256)) // int(w[5]))
    for q in (range(n_cta) if ctas is None else ctas):
        i0, n_own, n_flag, nbrs = _cta(w, q)
        yield q, i0, n_own, n_flag, nbrs, (nbrs - i0 >= 0) & (nbrs - i0 < n_flag)


# coins drawn a site over a launch (staged flags and the coins drawn
# again): a CTA of one row at config 3 and at 256^2 x 4 also stages the
# next row; the harness's CTA takes a whole graph
COINS = {"config3": 2.0, "256x4": 2.0, "harness": 1.0}


@pytest.mark.parametrize("name,shape,tri,b", SHAPES, ids=[s[0] for s in SHAPES])
def test_partition_covers_every_site_and_finds_the_neighbours(name, shape, tri, b):
    w, dims, nd = _words(shape, tri, b)
    n = int(np.prod(dims))
    lat = Lattice(tuple(shape), TRI if tri else None)
    big = n > 2**20
    n_cta = -(-(-(-n // 256)) // int(w[5]))
    ctas = [0, 1, n_cta // 2, n_cta - 2, n_cta - 1] if big else None
    covered = max(fk.finish_offsets(dims, nd, tri)) <= int(w[5]) * 256
    seen = np.zeros(n, np.int64)
    coins = redrawn = 0
    for q, i0, n_own, n_flag, nbrs, staged in _model(shape, tri, b, ctas):
        assert i0 == q * int(w[5]) * 256 and 0 < n_own <= n_flag <= n - i0
        seen[i0:i0 + n_own] += 1
        sites = np.arange(i0, i0 + n_own)
        np.testing.assert_array_equal(nbrs, lat.fwd[sites])
        coins += n_flag
        redrawn += int((~staged).sum())
        if covered:
            # the tile reaches every forward neighbour: only those reached
            # across a periodic boundary are drawn again
            unwrapped = sites[:, None] + np.array(fk.finish_offsets(dims, nd, tri))
            assert (nbrs[~staged] != unwrapped[~staged]).all()
    if big:
        assert (seen[seen > 0] == 1).all()
    else:
        assert (seen == 1).all()
        if name in COINS:
            assert (coins + redrawn) / n == pytest.approx(COINS[name])
    if name == "space4096":
        # the CTA of two rows stages the next row: only the last row's
        # forward neighbour (row 0) and, along axis 1, none is drawn again
        q, i0, n_own, n_flag, nbrs, staged = next(_model(shape, tri, b, [5]))
        assert n_own == 8192 and n_flag == 12288 and staged.all()
        q, *_, staged = next(_model(shape, tri, b, [n_cta - 1]))
        assert (~staged).sum() == 4096 and staged[:, 1].all()
    if name == "harness":
        # one CTA a graph: every neighbour staged, the wrapped ones too
        assert int(w[5]) * 256 >= n
    if name == "cubic32":
        # a plane a CTA (the floor: 1024 CTAs of half a plane would draw
        # every +x coin again), the next staged: the +x neighbour is drawn
        # again only from the last plane
        assert int(w[5]) * 256 == 32 * 32 and covered
        *_, nbrs, staged = next(_model(shape, tri, b, [n_cta - 1]))
        assert (~staged[:, 0]).sum() == 32 * 32 and staged[:, 2].all()


def _warp_pairs(x):
    """One warp's sum of each block's 256 terms (mega.cuh warp_tree), the
    last block padded with zeros: ``[B, blocks]``."""
    b, n = x.shape
    nb = -(-n // 256)
    t = torch.zeros((b, nb * 256), dtype=x.dtype)
    t[:, :n] = x
    t = t.view(b, nb, 256)
    lane = torch.arange(32)
    v = ((t[..., lane] + t[..., lane + 128]) + (t[..., lane + 64] + t[..., lane + 192])) + (
        (t[..., lane + 32] + t[..., lane + 160]) + (t[..., lane + 96] + t[..., lane + 224]))
    for off in (16, 8, 4, 2, 1):
        src = torch.where(lane + off < 32, lane + off, lane)
        v = v + v[..., src]
    return v[..., 0]


MODEL = [s for s in SHAPES if s[0] in ("6x10", "8x6x10", "tri-48", "256x4", "config2")]


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,tri,b", MODEL, ids=[s[0] for s in MODEL])
def test_model_partials_match_plain(name, shape, tri, b, wolff):
    """The model's flips (staged once, or drawn again from the neighbour's
    label), its per-site terms from the "s differs" bits and the two
    decisions, and each block's warp sum: bitwise fk_finish_plain's
    partials per block."""
    w, dims, nd = _words(shape, tri, b)
    n = int(np.prod(dims))
    rng = np.random.default_rng(n + b + wolff)
    spins = torch.from_numpy(rng.choice([-1, 1], size=(b, *shape)).astype(np.int8))
    labels = torch.from_numpy(np.minimum.accumulate(  # labels of some clusters
        np.where(rng.random((b, n)) < 0.3, np.arange(n), 0), axis=1).astype(np.int32))
    j_fwd = torch.from_numpy(rng.standard_normal((1, n, nd)).astype(np.float32))
    scal = torch.from_numpy(np.stack([rng.integers(-2**31, 2**31, b),
                                      rng.integers(-2**31, 2**31, b),
                                      rng.integers(0, n, b)], -1).astype(np.int32))
    flip = (wolff_flip_mask(labels, scal[:, 2]) if wolff
            else cluster_coin_flip_mask(labels, scal[:, :2])).numpy()
    s0 = spins.view(b, n).numpy().astype(np.int64)
    e = np.zeros((b, n), np.float32)
    m = np.zeros((b, n), np.int32)
    for _, i0, n_own, n_flag, nbrs, staged in _model(shape, tri, b):
        i = np.arange(i0, i0 + n_own)
        fl = flip[:, i]
        acc = np.zeros((b, n_own), np.float32)
        for d in range(nd):
            j = nbrs[:, d]
            ff = flip[:, j]  # staged or drawn again: the same decision
            differs = s0[:, i] != s0[:, j]
            prod = np.where(differs != (fl != ff), np.float32(-1), np.float32(1))
            acc = acc + prod * j_fwd[0, i, d].numpy()
        e[:, i] = acc
        m[:, i] = np.where(fl, -s0[:, i], s0[:, i])
    ep, mp = fk.fk_finish_plain(spins.clone(), labels, j_fwd, scal, wolff=wolff,
                                with_measure=True, blocks=True)
    assert torch.equal(_warp_pairs(torch.from_numpy(e)), ep)
    assert torch.equal(_warp_pairs(torch.from_numpy(m)), mp)
    assert torch.equal(fk.block_partials_plain(torch.from_numpy(e)), ep)
    # and the partials add up to the plain version's sums
    e1, m1 = fk.fk_finish_plain(spins.clone(), labels, j_fwd, scal, wolff=wolff,
                                with_measure=True)
    assert torch.equal(mp.sum(-1, keepdim=True, dtype=torch.int32), m1)
    torch.testing.assert_close(ep.sum(-1, keepdim=True), e1, rtol=1e-5, atol=1e-4)
