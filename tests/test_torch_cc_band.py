"""The banded connected components' plain sequence (``ops/cc_band.py``):
link, export, merge and write, the plain versions of ``csrc/cc_band.cu``.

* Over 1, 2 and 4 bands on the square, cubic, triangular and FCC
  lattices at three bond densities (all bonds on: spanning clusters), every
  window site's label, the halo sites' too, is bitwise the unsharded
  ``connected_components`` label of the site it holds; each band's halo
  labels equal the labels of the owner band's edge rows they copy (one
  band owns its own halos).
* The link's roots are each window component's site of smallest (global
  index, window index), and ``cmin`` at a root its smallest boundary slot,
  against a breadth-first search of the window.
* The merge against a union-find written out in Python on random boundary
  graphs.
* The sequence of steps does not depend on the bonds.

``tests/test_torch_halo.py`` holds the same labels against the reference's
``connected_components_banded`` (row 17, interpret mode);
``tests/test_torch_cuda.py`` holds each kernel against these plain versions
on the card.
"""

from collections import deque

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops import cc_band
from peapods_tpu_torch.ops.cluster import connected_components
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, BandGeometry, Lattice

torch.set_num_threads(1)

CASES = [("square", (16, 16), None), ("cubic", (8, 8, 8), None),
         ("tri", (16, 16), GEOMETRY_OFFSETS["triangular"]),
         ("fcc", (8, 8, 8), GEOMETRY_OFFSETS["fcc"])]
DENSITIES = (0.3, 0.6, 1.01)


def _masks(lat, p, seed, n_graphs=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n_graphs, lat.n_spins, lat.n_neighbors)) < p)


def _buffers(masks, geom):
    """Each band's :class:`BandCC` with the state bytes of ``masks``."""
    lat = geom.lattice
    bits = torch.arange(lat.n_neighbors, dtype=torch.uint8)
    ccs = []
    for b in geom.bands:
        m = masks[:, torch.from_numpy(b.window_sites())] & torch.from_numpy(
            cc_band.window_reach(b))
        cc = cc_band.BandCC.empty(masks.shape[0], b, "cpu")
        cc.state.copy_((m.to(torch.uint8) << bits).sum(-1, dtype=torch.uint8))
        ccs.append(cc)
    return ccs


@pytest.mark.parametrize("p", DENSITIES)
@pytest.mark.parametrize("n_bands", [1, 2, 4])
@pytest.mark.parametrize("name,shape,offsets", CASES, ids=[c[0] for c in CASES])
def test_plain_sequence_is_the_unsharded_labelling(name, shape, offsets, n_bands, p):
    lat = Lattice(shape, offsets)
    geom = BandGeometry(lat, n_bands)
    masks = _masks(lat, p, 5 + n_bands)
    want = connected_components(masks, shape, lat.offsets)
    ccs = _buffers(masks, geom)
    cc_band.banded_labels(ccs, geom.bands)
    for cc, b in zip(ccs, geom.bands):
        np.testing.assert_array_equal(cc.labels.numpy(),
                                      want[:, torch.from_numpy(b.window_sites())].numpy(),
                                      err_msg=f"band {b.k}")
    if p > 1:  # all bonds on: one component, two on FCC's parity sublattices
        assert len(np.unique(want.numpy())) <= 2


@pytest.mark.parametrize("n_bands", [1, 2, 4])
@pytest.mark.parametrize("name,shape,offsets", CASES, ids=[c[0] for c in CASES])
def test_halo_labels_are_the_owners_labels(name, shape, offsets, n_bands):
    """A band's top halo holds the previous band's last rows, its bottom
    halo the next band's first rows (in one band, its own)."""
    lat = Lattice(shape, offsets)
    geom = BandGeometry(lat, n_bands)
    ccs = _buffers(_masks(lat, 0.55, 11), geom)
    cc_band.banded_labels(ccs, geom.bands)
    m, blk, hl = geom.halo, geom.block, geom.hl
    for k, cc in enumerate(ccs):
        prev, nxt = ccs[k - 1], ccs[(k + 1) % n_bands]
        np.testing.assert_array_equal(cc.labels[:, :m * blk].numpy(),
                                      prev.labels[:, hl * blk:(hl + m) * blk].numpy())
        np.testing.assert_array_equal(cc.labels[:, (m + hl) * blk:].numpy(),
                                      nxt.labels[:, m * blk:2 * m * blk].numpy())


def _window_components(state, band):
    """Each window site's component (a list of window sites), by
    breadth-first search over the state bytes ``[n_window]``."""
    nw = band.n_window
    lat = band.lattice
    shape = band.window_shape
    coords = np.stack(np.unravel_index(np.arange(nw), shape), -1)
    adj = [[] for _ in range(nw)]
    for w in range(nw):
        for k, off in enumerate(lat.offsets):
            if state[w] >> k & 1:
                c = coords[w] + off
                c[1:] %= shape[1:]
                j = int(np.ravel_multi_index(tuple(c), shape))
                adj[w].append(j)
                adj[j].append(w)
    comp = [None] * nw
    for s in range(nw):
        if comp[s] is None:
            members, queue = [s], deque([s])
            comp[s] = members
            while queue:
                for j in adj[queue.popleft()]:
                    if comp[j] is None:
                        comp[j] = members
                        members.append(j)
                        queue.append(j)
    return comp


@pytest.mark.parametrize("n_bands", [1, 4])
@pytest.mark.parametrize("name,shape,offsets", CASES, ids=[c[0] for c in CASES])
def test_link_roots_are_the_smallest_band_keys(name, shape, offsets, n_bands):
    """The root of each window component is its site of smallest (global
    index, window index); in one band the halo rows repeat the band's own
    global rows, so the window index breaks the tie."""
    lat = Lattice(shape, offsets)
    geom = BandGeometry(lat, n_bands)
    ccs = _buffers(_masks(lat, 0.5, 3, n_graphs=1), geom)
    for cc, b in zip(ccs, geom.bands):
        cc_band.link_plain(cc, b)
        glob = b.window_sites()
        slot_of = {}
        for s, w in enumerate(cc_band.edge_windows(b)):
            slot_of.setdefault(int(w), s)
        comp = _window_components(cc.state[0].numpy(), b)
        parent, cmin = cc.parent[0].numpy(), cc.cmin[0].numpy()
        for w in range(b.n_window):
            root = min(comp[w], key=lambda x: (glob[x], x))
            assert parent[w] == root, (b.k, w)
            slots = [slot_of[x] for x in comp[w] if x in slot_of]
            assert cmin[root] == (min(slots) if slots else cc_band.INT32_MAX), (b.k, w)


def _brute_force_sets(rep, val, n_bands, e):
    """Set minima of the merge graph by a union-find written out."""
    n = n_bands * e
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    def union(x, y):
        x, y = find(x), find(y)
        if x != y:
            parent[max(x, y)] = min(x, y)

    for x in range(n):
        union(x, int(rep[x // e, x % e]))
    a, b = cc_band.merge_pairs(n_bands, e, "cpu")
    for x, y in zip(a.tolist(), b.tolist()):
        union(x, y)
    least = {}
    for x in range(n):
        r = find(x)
        least[r] = min(least.get(r, cc_band.INT32_MAX), int(val[x // e, x % e]))
    return np.array([least[find(x)] for x in range(n)]).reshape(n_bands, e)


@pytest.mark.parametrize("n_bands,e,n_roots", [(1, 8, 3), (2, 12, 5), (4, 16, 6),
                                               (3, 40, 30)])
def test_merge_matches_a_brute_force_union_find(n_bands, e, n_roots):
    """Random boundary graphs: each band's slots fall into random local
    components (representative: the component's smallest slot), each with
    a random root value; the set minima of ``merge_plain`` are those of a
    union-find over the same edges."""
    rng = np.random.default_rng(n_bands * 100 + e)
    g = 3
    rep = np.empty((n_bands, g, e), np.int32)
    val = np.empty((n_bands, g, e), np.int32)
    for k in range(n_bands):
        for b in range(g):
            root = rng.integers(0, n_roots, e)
            values = rng.integers(0, 10 * e, n_roots)
            first = {}
            for s, r in enumerate(root):
                first.setdefault(r, s)
            rep[k, b] = [k * e + first[r] for r in root]
            val[k, b] = values[root]
    mb = cc_band.BandMerge(torch.from_numpy(rep), torch.from_numpy(val),
                           torch.empty((n_bands, g, e), dtype=torch.int32))
    cc_band.merge(mb)
    for b in range(g):
        np.testing.assert_array_equal(mb.labels[:, b].numpy(),
                                      _brute_force_sets(rep[:, b], val[:, b], n_bands, e))


def test_the_sequence_does_not_depend_on_the_bonds(monkeypatch):
    """The same steps in the same order at every bond density: a link and
    an export a band, one merge, a write a band."""
    calls = []
    for name in ("link_plain", "export_plain", "merge_plain", "write_plain"):
        fn = getattr(cc_band, name)
        monkeypatch.setattr(cc_band, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    lat = Lattice((16, 16))
    geom = BandGeometry(lat, 4)
    seen = []
    for p in DENSITIES:
        calls.clear()
        cc_band.banded_labels(_buffers(_masks(lat, p, 7), geom), geom.bands)
        seen.append(list(calls))
    assert seen[0] == seen[1] == seen[2]
    assert seen[0] == (["link_plain"] * 4 + ["export_plain"] * 4 + ["merge_plain"]
                       + ["write_plain"] * 4)
