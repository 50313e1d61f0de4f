"""The winding flags' decomposition (``csrc/winding.cu``) on the CPU, against
the JAX package.

* ``winding.winding_flags_open``, the kernels' steps in plain torch: the
  open graph (the bond graph less its wrap bonds) in boxes that split the
  lattice, the open bonds that leave a box united over the boxes' roots,
  the wrap bonds as edges of the contracted open components with a sheet
  potential, and the error check.  Flags bitwise ``winding_batch`` in
  interpret mode and ``cluster.winding_flags`` at densities that straddle
  the bond-percolation threshold; each step against its plain version.
* The hand cases of ``tests/test_cluster.py:90-113`` and three more: a
  (1, 1) staircase that winds both axes at once, a cycle across the row
  seam twice with no net shift, a ring along y only.
* A model of the kernels' union-find with sheet offsets (``W``: the larger
  root hung under the smaller, the offsets mod 2**16), the wrap bonds taken
  in several orders: the same flags.
* The error mark: set exactly where the plain version raises (a component
  with no site labelled as itself), and not where labels name two roots in
  one component while every component holds one.
* The kernels' form: one launch up to one CTA's box, four beyond.
* The extent limit: a helix that winds an axis as often as the other
  extent allows, at the largest extent the kernels take, keeps the model's
  offsets mod 2**16 exact; the limit is the source's.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.ops import pallas_cc_batch as ccb
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch.ops import cluster, fk, winding

torch.set_num_threads(1)

# (shape, box) pairs: boxes that split both axes, one, none (the whole form)
SPLITS = [((8, 8), (4, 4, 1)), ((16, 16), (4, 8, 1)), ((8, 128), (4, 32, 1)),
          ((16, 32), (8, 8, 1)), ((8, 8), (8, 8, 1)), ((16, 16), (16, 4, 1))]


def _batch(shape, seed, count=12):
    """Masks of a batch a multiple of winding_batch's tile: empty, full,
    and densities from 0.3 to 0.75."""
    lat = RefLattice(list(shape))
    kp, ks = ccb.cc_batch_factors(lat, count)
    b = -(-count // (kp * ks)) * (kp * ks)
    rng = np.random.default_rng(seed)
    active = rng.random((b, lat.n_spins, 2)) < np.linspace(0.3, 0.75, b)[:, None, None]
    active[0] = False
    active[1] = True
    return active, kp, ks


@pytest.mark.parametrize("shape,tile", SPLITS,
                         ids=[f"{s[0]}x{s[1]}-box{t[0]}x{t[1]}" for s, t in SPLITS])
def test_decomposition_matches_reference(shape, tile):
    active, kp, ks = _batch(shape, 7 + shape[1] + tile[1])
    masks = torch.from_numpy(active)
    labels = cluster.connected_components(masks, shape)
    ref_labels = ccb.connected_components_batch(jnp.asarray(active), shape=shape, kp=kp,
                                                ks=ks, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref_labels), labels.numpy())
    rx, ry = ccb.winding_batch(jnp.asarray(active), ref_labels, shape=shape, kp=kp, ks=ks,
                               interpret=True)
    ox, oy = winding.winding_flags_open(masks, labels, shape, tile)
    px, py = cluster.winding_flags(masks, labels, shape)
    np.testing.assert_array_equal(ox.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(oy.numpy(), np.asarray(ry))
    assert torch.equal(ox, px) and torch.equal(oy, py)
    assert 0 < int(ox.sum()) < len(ox)  # the densities straddle the transition
    # each step against its plain version
    boxes = winding.winding_link_plain(masks, shape, tile)
    opened = winding.open_masks(masks, shape)
    assert torch.equal(boxes, fk.fk_link_tiles_plain(opened, shape, tile))
    open_labels = winding.winding_border_unions(boxes, masks, shape, tile)
    assert torch.equal(open_labels, winding.winding_border_plain(masks, shape))
    assert torch.equal(open_labels, cluster.connected_components(opened, shape))
    assert not bool(winding.winding_check_plain(masks, labels, shape).any())


def test_open_masks_drop_exactly_the_wrap_bonds():
    shape = (6, 10)
    masks = torch.ones((1, 60, 2), dtype=torch.bool)
    opened = winding.open_masks(masks, shape).view(6, 10, 2)
    assert not opened[-1, :, 0].any() and not opened[:, -1, 1].any()
    assert int(opened.sum()) == 2 * 60 - 6 - 10
    # the open graph of the full lattice is one component, and it does not wind
    lab = winding.winding_border_plain(masks, shape)
    assert not lab.any()
    wx, wy = cluster.winding_flags(winding.open_masks(masks, shape), lab, shape)
    assert not wx.any() and not wy.any()


def _hand_cases(l0, l1):
    """Bool masks [n, 2] and their flags (wx, wy) on an l0 x l1 torus."""
    def grid():
        return np.zeros((l0, l1, 2), bool)

    ring = grid()
    ring[:, 0, 0] = True  # column 0 closes along x
    seam = ring.copy()
    seam[l0 // 2, 0, 0] = False  # a path across the seam, no cycle
    stair = grid()
    for k in range(l0):  # (k, k) -> (k, k+1) -> (k+1, k+1): winds (1, 1)
        stair[k, k % l1, 1] = True
        stair[k, (k + 1) % l1, 0] = True
    twice = grid()  # across the row seam down at column 0, back up at 1
    twice[l0 - 1, 0, 0] = twice[l0 - 1, 1, 0] = True
    twice[0, 0, 1] = twice[l0 - 1, 0, 1] = True
    row = grid()
    row[0, :, 1] = True  # row 0 closes along y
    cases = {"full": (np.ones((l0, l1, 2), bool), (True, True)),
             "column-ring": (ring, (True, False)), "seam-path": (seam, (False, False)),
             "empty": (grid(), (False, False)), "staircase": (stair, (True, True)),
             "twice-across-the-seam": (twice, (False, False)),
             "row-ring": (row, (False, True))}
    return {k: (m.reshape(l0 * l1, 2), f) for k, (m, f) in cases.items()}


HAND = list(_hand_cases(4, 4))


@pytest.mark.parametrize("shape,tile", [((4, 4), (4, 4, 1)), ((4, 4), (2, 2, 1)),
                                        ((16, 16), (4, 8, 1))],
                         ids=["4-whole", "4-box2x2", "16-box4x8"])
@pytest.mark.parametrize("case", HAND)
def test_hand_cases(case, shape, tile):
    """tests/test_cluster.py:90-113 (full lattice, one column ring, a path
    across the seam, the empty graph) and the staircase, the seam crossed
    twice, the ring along y: the plain settle loop, the wrapper's CPU path
    and the decomposition give the expected flags."""
    masks_np, want = _hand_cases(*shape)[case]
    masks = torch.from_numpy(masks_np[None])
    labels = cluster.connected_components(masks, shape)
    for flags in (cluster.winding_flags(masks, labels, shape),
                  winding.winding_flags(masks, labels, shape),
                  winding.winding_flags_open(masks, labels, shape, tile)):
        assert (bool(flags[0][0]), bool(flags[1][0])) == want


def test_hand_cases_match_winding_batch():
    shape = (4, 4)
    cases = _hand_cases(*shape)
    active = np.stack([m for m, _ in cases.values()])
    kp, ks = ccb.cc_batch_factors(RefLattice(list(shape)), len(active))
    b = -(-len(active) // (kp * ks)) * (kp * ks)
    active = np.concatenate([active, np.zeros((b - len(active), 16, 2), bool)])
    labels = ccb.connected_components_batch(jnp.asarray(active), shape=shape, kp=kp, ks=ks,
                                            interpret=True)
    rx, ry = ccb.winding_batch(jnp.asarray(active), labels, shape=shape, kp=kp, ks=ks,
                               interpret=True)
    want = np.array([f for _, f in cases.values()] + [(False, False)] * (b - len(cases)))
    np.testing.assert_array_equal(np.stack([np.asarray(rx), np.asarray(ry)], -1), want)


def _model_flags(masks, open_labels, shape, order):
    """The kernels' union-find with sheet offsets, sequentially: each active
    wrap bond (in ``order``) from its row-L0-1 / column-L1-1 end's node to
    the other end's: a shared root is a chord, checked mod 2**16; else the
    larger root is hung under the smaller with the offset that makes the
    ends' sheets differ by the bond's shift.  Finds halve the path."""
    l0, l1 = shape
    W = {}

    def find(x):
        ox = oy = 0
        while True:
            p, ax, ay = W.setdefault(x, (x, 0, 0))
            if p == x:
                return x, ox, oy
            gp, bx, by = W.setdefault(p, (p, 0, 0))
            if gp == p:
                return p, (ox + ax) & 0xffff, (oy + ay) & 0xffff
            ax, ay = (ax + bx) & 0xffff, (ay + by) & 0xffff
            W[x] = (gp, ax, ay)
            ox, oy, x = (ox + ax) & 0xffff, (oy + ay) & 0xffff, gp

    flags = [False, False]
    for k in order:
        if k < l1:
            u, v, axis = (l0 - 1) * l1 + k, k, 0
        else:
            u, v, axis = (k - l1) * l1 + l1 - 1, (k - l1) * l1, 1
        if not masks[u, axis]:
            continue
        ra, ax, ay = find(int(open_labels[u]))
        rb, bx, by = find(int(open_labels[v]))
        dx, dy = (bx - ax - (axis == 0)) & 0xffff, (by - ay - (axis == 1)) & 0xffff
        if ra == rb:
            flags[0] |= dx != 0
            flags[1] |= dy != 0
        elif ra > rb:
            W[ra] = (rb, dx, dy)
        else:
            W[rb] = (ra, -dx & 0xffff, -dy & 0xffff)
    return tuple(flags)


@pytest.mark.parametrize("shape", [(8, 8), (16, 32), (6, 10)])
def test_sheet_union_find_model_gives_the_flags(shape):
    """Random graphs near the threshold and the hand cases: the kernels'
    union-find over the wrap bonds, in order, reversed and shuffled, gives
    the plain flags."""
    n = shape[0] * shape[1]
    rng = np.random.default_rng(shape[1])
    masks = torch.from_numpy(rng.random((24, n, 2)) < np.linspace(0.35, 0.7, 24)[:, None, None])
    if shape[0] == shape[1]:
        hand = _hand_cases(*shape)
        masks = torch.cat([masks, torch.from_numpy(np.stack([m for m, _ in hand.values()]))])
    labels = cluster.connected_components(masks, shape)
    px, py = cluster.winding_flags(masks, labels, shape)
    open_labels = winding.winding_border_plain(masks, shape)
    m = masks.numpy()
    edges = np.arange(sum(shape))
    for g in range(len(m)):
        for order in (edges, edges[::-1], rng.permutation(edges)):
            assert _model_flags(m[g], open_labels[g].numpy(), shape, order) == (
                bool(px[g]), bool(py[g])), g


def test_error_mark_is_where_the_plain_version_raises():
    shape, n = (8, 8), 64
    rng = np.random.default_rng(5)
    masks = torch.from_numpy(rng.random((1, n, 2)) < 0.45)
    labels = cluster.connected_components(masks, shape)
    big = int(torch.bincount(labels[0].long()).argmax())
    other = int(labels[0, (labels[0] != big).nonzero()[0, 0]])
    cases = {
        # one component, no bonds: every site but 0 holds no root
        "labels of other masks": (torch.zeros_like(masks), torch.zeros((1, n), dtype=torch.int32)),
        # the largest component named by another's root
        "a component without its root": (masks, torch.where(labels == big, other, labels)),
        # two roots in one component, every component holding one: no error
        "two roots in one": (masks, torch.where(labels == big, torch.arange(n, dtype=torch.int32)
                                                .expand(1, n), labels).to(torch.int32)),
        "the min labels": (masks, labels),
    }
    for name, (m, lab) in cases.items():
        try:
            cluster.winding_flags(m, lab, shape)
            raises = False
        except ValueError:
            raises = True
        assert bool(winding.winding_check_plain(m, lab, shape)[0]) == raises, name
        if raises:
            with pytest.raises(ValueError, match="unsettled"):
                winding.winding_flags_open(m, lab, shape, (4, 4, 1))
        assert raises == name.startswith(("labels", "a component")), name


@pytest.mark.parametrize("shape,b,launches", [
    ((64, 64), 2048, {"winding": 1}), ((8, 8), 64, {"winding": 1}),
    ((64, 128), 32, {"winding": 1}), ((256, 256), 1, dict.fromkeys(winding.TILED, 1)),
    ((2048, 2048), 1, dict.fromkeys(winding.TILED, 1)), ((96, 160), 8, dict.fromkeys(
        winding.TILED, 1))])
def test_the_kernels_form(shape, b, launches):
    """One launch where the graph fits one CTA (link_plan's whole-graph
    form: at most 8192 sites), four beyond, in link_plan's boxes."""
    assert winding.winding_launches(shape, b) == launches
    plan = winding.winding_plan(shape, b)
    assert plan == fk.link_plan((*shape, 1), b)
    assert plan.tile[0] * plan.tile[1] <= fk.LINK_TILE_SITES and plan.tile[2] == 1
    assert max(shape) <= winding.MAX_EXTENT


def _helix(l0, l1):
    """Bool masks [n, 2] of the (1, 1) staircase from (0, 0) until it
    closes: lcm(l0, l1) steps, across the row seam lcm / l0 times and the
    column seam lcm / l1 times."""
    m = np.zeros((l0, l1, 2), bool)
    for k in range(math.lcm(l0, l1)):  # (k, k) -> (k, k+1) -> (k+1, k+1)
        m[k % l0, k % l1, 1] = True
        m[k % l0, (k + 1) % l1, 0] = True
    return m.reshape(l0 * l1, 2)


def _open_labels(masks, shape):
    """Each site's open-component minimum (a sequential union-find)."""
    l0, l1 = shape
    n = l0 * l1
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    opened = winding.open_masks(torch.from_numpy(masks[None]), shape)[0].numpy()
    for i, d in zip(*np.nonzero(opened)):
        a, b = find(i), find(i + (l1 if d == 0 else 1))
        parent[max(a, b)] = min(a, b)
    return np.array([find(i) for i in range(n)])


@pytest.mark.parametrize("shape", [(2, winding.MAX_EXTENT), (winding.MAX_EXTENT, 2),
                                   (3, 20000), (6, 10)],
                         ids=["2xmax", "maxx2", "3x20000", "6x10"])
def test_sheet_offsets_stay_exact_at_the_extent_limit(shape):
    """A helix whose one cycle crosses an axis's seam as often as the other
    extent has wrap bonds (the most a path of the spanning forest can): at
    2 x 32767 the chord that closes it disagrees by 32767 along x, still
    nonzero mod 2**16, so the model of the kernels' union-find flags both
    axes in any order of the wrap bonds."""
    l0, l1 = shape
    masks = _helix(l0, l1)
    lab = _open_labels(masks, shape)
    turns = (math.lcm(l0, l1) // l0, math.lcm(l0, l1) // l1)
    assert max(turns) == max(shape) // math.gcd(l0, l1)
    edges = np.arange(l0 + l1)
    for order in (edges, edges[::-1], np.random.default_rng(l1).permutation(edges)):
        assert _model_flags(masks, lab, shape, order) == (True, True)
    if l0 * l1 <= 64:
        labels = cluster.connected_components(torch.from_numpy(masks[None]), shape)
        px, py = cluster.winding_flags(torch.from_numpy(masks[None]), labels, shape)
        assert bool(px[0]) and bool(py[0])


def test_extent_limit_is_the_kernels():
    """MAX_EXTENT is csrc/winding.cu's kMaxExtent: each extent below 2**15
    (a sheet offset sums at most the other extent's wrap bonds), the sites
    of a graph below 2**30."""
    src = (Path(winding.__file__).parent.parent / "csrc" / "winding.cu").read_text()
    assert int(re.search(r"kMaxExtent = (\d+);", src).group(1)) == winding.MAX_EXTENT
    assert winding.MAX_EXTENT == 2**15 - 1 and winding.MAX_EXTENT**2 < 2**30
