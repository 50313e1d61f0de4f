"""Connected components of bond graphs split into row bands.

Counterpart of ``peapods_tpu/ops/pallas_cc_band.py`` ``band_cc_batch``
(:198, kernel ``_band_kernel`` :169) as ``peapods_tpu/ops/cluster.py``
``connected_components_banded`` (:194) drives it under the reference's
``space`` mesh: every site gets its component's minimum global site index,
bitwise the unsharded labelling; every halo site too, the same label as the
site it copies.

Each band of a :class:`~.lattice.BandGeometry` keeps per graph and window
site (the band's rows and its halos) a :class:`BandCC` buffer: the bond
bits of the state byte (bit ``k``: the bond to the forward neighbour at
offset ``k``, set only where that neighbour lies in the window), a
union-find parent, the site's label and ``cmin``, a slot per root.  A
band's boundary slots (:func:`edge_windows`) are its sites of the top halo,
top edge, bottom edge and bottom halo rows, in that order.  The labelling
(:func:`banded_labels`) is one fixed sequence, with no host sync and no
label exchange between bands:

1. :func:`link` per band: each parent becomes its window component's root,
   the site of smallest ``(global index, window index)``, and
   ``cmin[root]`` the component's smallest slot (``INT32_MAX`` for none);
2. :func:`export` per band: each slot's representative, as a merge node
   ``band * E + cmin[root]``, and its root's global index, into a
   :class:`BandMerge` on the first band's device;
3. :func:`merge` there: a union-find over every band's slots, joining the
   slots of one root and each halo slot with the slot of the same global
   site in the band that owns it; each set takes the minimum of its roots'
   global indices;
4. :func:`write` per band: every window site takes its root's set minimum,
   or its root's own global index where the root has no slot (that
   component never reaches a band edge, so it is whole).

On CUDA tensors each step launches ``csrc/cc_band.cu`` (counted in
:data:`LAUNCHES`: 5 launches a band and 2 an FK phase); on CPU tensors it
runs its plain version (``*_plain``), which computes the same values;
:func:`banded_labels_plain` runs the plain versions on any device.  The FK
bonds of the bands (``fk.fk_bonds_band``) fill the state bytes;
:func:`band_cc_labels` fills them from global bond masks.

The engine keeps the reference's limit (``cluster.banded_supports``,
:187-191): an FK phase on a space mesh needs offsets that reach at most one
row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .cluster import connected_components

__all__ = ["LAUNCHES", "INT32_MAX", "BandCC", "BandMerge", "window_reach", "n_slots",
           "edge_windows", "merge_pairs", "link", "link_plain", "export", "export_plain",
           "merge", "merge_plain", "write", "write_plain", "banded_labels",
           "banded_labels_plain", "band_cc_labels"]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"cc_band_link": 0, "cc_band_border": 0, "cc_band_flatten": 0,
            "cc_band_export": 0, "cc_band_merge": 0, "cc_band_resolve": 0,
            "cc_band_write": 0}

INT32_MAX = 2**31 - 1


@dataclass
class BandCC:
    """One band's buffers ``[G, n_window]``."""

    state: torch.Tensor
    parent: torch.Tensor
    labels: torch.Tensor
    cmin: torch.Tensor

    @classmethod
    def empty(cls, n_graphs, band, device):
        shape = (n_graphs, band.n_window)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(torch.empty(shape, dtype=torch.uint8, device=device),
                   torch.empty(shape, **i32), torch.empty(shape, **i32),
                   torch.empty(shape, **i32))


@dataclass
class BandMerge:
    """The boundary slots of every band, int32 ``[n_bands, G, E]``: each
    slot's merge parent (exported as its representative node), its root's
    global index, and its set's minimum."""

    rep: torch.Tensor
    val: torch.Tensor
    labels: torch.Tensor

    @classmethod
    def empty(cls, n_graphs, bands, device):
        shape = (len(bands), n_graphs, n_slots(bands[0]))
        return cls(*(torch.empty(shape, dtype=torch.int32, device=device)
                     for _ in range(3)))


def window_reach(band):
    """bool ``[n_window, n_neighbors]``: whether each window site's forward
    neighbour lies in the window."""
    rows = np.arange(band.rows)[:, None] + band.lattice.offsets[:, 0][None, :]
    inside = (rows >= 0) & (rows < band.rows)
    return np.repeat(inside, band.block, axis=0)


def n_slots(band) -> int:
    """``E``: a band's boundary slots a graph, four halos of rows."""
    return 4 * band.halo * band.block


def edge_windows(band):
    """int64 ``[E]``: the window site of each boundary slot (the top halo
    and top edge rows, then the bottom edge and bottom halo rows)."""
    top = 2 * band.halo * band.block
    return np.concatenate([np.arange(top), band.hl * band.block + np.arange(top)])


def _on(x, dev):
    return torch.from_numpy(x).to(dev)


def _masks(state, band):
    bits = torch.arange(band.lattice.n_neighbors, device=state.device, dtype=torch.uint8)
    return ((state[..., None] >> bits) & 1).to(torch.bool)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def link_plain(cc, band):
    """Plain version of :func:`link`: each window site's parent becomes its
    component's site of smallest ``(global index, window index)`` (the
    window is periodic along the rows here, but no bond leaves it, so no
    wrap joins sites), and ``cmin`` the smallest slot at each root,
    ``INT32_MAX`` elsewhere."""
    dev = cc.state.device
    nw = band.n_window
    lab = connected_components(_masks(cc.state, band), band.window_shape,
                               band.lattice.offsets).to(torch.int64)
    key = (_on(band.window_sites(), dev) * nw + torch.arange(nw, device=dev)).expand_as(lab)
    least = torch.full_like(lab, np.iinfo(np.int64).max).scatter_reduce_(1, lab, key, "amin")
    root = least.gather(1, lab) % nw
    cc.parent.copy_(root)
    slots = torch.arange(n_slots(band), dtype=torch.int32, device=dev)
    cc.cmin.fill_(INT32_MAX).scatter_reduce_(
        1, root[:, _on(edge_windows(band), dev)], slots.expand(lab.shape[0], -1), "amin")


def link(cc, band):
    """Unite every window's bonds (see :func:`link_plain`): the plain
    version for CPU tensors; for CUDA tensors ``cc_band_link`` (a
    union-find in shared memory per tile of the window), ``cc_band_border``
    (the bonds across tile edges) and ``cc_band_flatten``."""
    if _build.device_kind(cc.state) == "cpu":
        link_plain(cc, band)
        return
    g = _check(cc, band)
    lib = _build.library()
    s = _stream(cc.state)
    geom = band.words.ctypes.data
    _build.check(lib.peapods_cc_band_link(cc.state.data_ptr(), cc.parent.data_ptr(),
                                          cc.cmin.data_ptr(), geom, g, s), "cc_band_link")
    LAUNCHES["cc_band_link"] += 1
    _build.check(lib.peapods_cc_band_border(cc.state.data_ptr(), cc.parent.data_ptr(), geom,
                                            g, s), "cc_band_border")
    LAUNCHES["cc_band_border"] += 1
    _build.check(lib.peapods_cc_band_flatten(cc.parent.data_ptr(), cc.cmin.data_ptr(), geom,
                                             g, s), "cc_band_flatten")
    LAUNCHES["cc_band_flatten"] += 1


def export_plain(cc, band, rep, val):
    """Plain version of :func:`export` into ``rep``, ``val`` int32 ``[G,
    E]`` on the band's device."""
    dev = cc.state.device
    root = cc.parent[:, _on(edge_windows(band), dev)].to(torch.int64)
    rep.copy_(band.k * n_slots(band) + cc.cmin.gather(1, root))
    val.copy_(_on(band.window_sites(), dev)[root])


def export(cc, band, mb):
    """Band ``band.k``'s slots into the merge buffers ``mb``: each slot's
    representative node ``k E + cmin[root]`` and its root's global index
    (after :func:`link`).  The plain version for CPU tensors, the
    ``cc_band_export`` kernel for CUDA tensors."""
    _export_into(mb, cc, band, export_plain if _build.device_kind(cc.state) == "cpu"
                 else _export_kernel)


def _export_kernel(cc, band, rep, val):
    g = _check(cc, band)
    _build.check(_build.library().peapods_cc_band_export(
        cc.parent.data_ptr(), cc.cmin.data_ptr(), rep.data_ptr(), val.data_ptr(),
        band.words.ctypes.data, band.k, g, _stream(cc.state)), "cc_band_export")
    LAUNCHES["cc_band_export"] += 1


def _export_into(mb, cc, band, fill):
    """``fill(cc, band, rep, val)`` into band ``band.k``'s slice of ``mb``,
    through a copy when ``mb`` lies on another device."""
    if mb.rep.device == cc.state.device:
        fill(cc, band, mb.rep[band.k], mb.val[band.k])
        return
    rep, val = (torch.empty(mb.rep.shape[1:], dtype=torch.int32, device=cc.state.device)
                for _ in range(2))
    fill(cc, band, rep, val)
    mb.rep[band.k].copy_(rep)
    mb.val[band.k].copy_(val)


def merge_pairs(n_bands, e, device):
    """int64 ``(a, b)``: the merge nodes of each halo slot and of the slot
    of the same global site in the band that owns it (the previous band's
    bottom edge for a top halo, the next band's top edge for a bottom
    halo; one band owns its own halos)."""
    hb = e // 4
    j = torch.arange(hb, device=device)
    k = torch.arange(n_bands, device=device)[:, None]
    a = torch.cat([k * e + j, k * e + 3 * hb + j], -1)
    b = torch.cat([(k - 1) % n_bands * e + 2 * hb + j, (k + 1) % n_bands * e + hb + j], -1)
    return a.reshape(-1), b.reshape(-1)


def merge_plain(mb):
    """Plain version of :func:`merge`: each slot's set minimum into
    ``mb.labels``, by min-key propagation over the merge's edges (each node
    to its representative, the pairs of :func:`merge_pairs`) with pointer
    jumping; a node's key is ``(root global index, node)``."""
    nb, g, e = mb.rep.shape
    n = nb * e
    dev = mb.rep.device
    nodes = lambda x: x.permute(1, 0, 2).reshape(g, n).to(torch.int64)  # noqa: E731
    a, b = merge_pairs(nb, e, dev)
    a = torch.cat([torch.arange(n, device=dev).expand(g, n), a.expand(g, -1)], -1)
    b = torch.cat([nodes(mb.rep), b.expand(g, -1)], -1)
    lab = nodes(mb.val) * n + torch.arange(n, device=dev)
    while True:
        old = lab
        low = torch.minimum(lab.gather(1, a), lab.gather(1, b))
        lab = lab.scatter_reduce(1, a, low, "amin").scatter_reduce(1, b, low, "amin")
        while True:  # a key names a node of the same set: take that node's key
            nxt = torch.minimum(lab, lab.gather(1, lab % n))
            if torch.equal(nxt, lab):
                break
            lab = nxt
        if torch.equal(lab, old):
            break
    mb.labels.copy_((lab // n).to(torch.int32).view(g, nb, e).permute(1, 0, 2))


def merge(mb):
    """Join the bands' slots (after :func:`export`): the plain version for
    CPU tensors; for CUDA tensors ``cc_band_merge`` (a union-find over the
    nodes, each starting under its representative, the root of smaller key
    winning) and ``cc_band_resolve`` (each node's set root's global
    index).  ``mb.rep`` is spent."""
    if _build.device_kind(mb.rep) == "cpu":
        merge_plain(mb)
        return
    nb, g, e = mb.rep.shape
    for name in ("rep", "val", "labels"):
        _build.expect(getattr(mb, name), name, torch.int32, (nb, g, e), mb.rep.device)
    lib = _build.library()
    s = _stream(mb.rep)
    _build.check(lib.peapods_cc_band_merge(mb.rep.data_ptr(), mb.val.data_ptr(), e, nb, g, s),
                 "cc_band_merge")
    LAUNCHES["cc_band_merge"] += 1
    _build.check(lib.peapods_cc_band_resolve(mb.rep.data_ptr(), mb.val.data_ptr(),
                                             mb.labels.data_ptr(), e, nb, g, s),
                 "cc_band_resolve")
    LAUNCHES["cc_band_resolve"] += 1


def write_plain(cc, band, sets):
    """Plain version of :func:`write`."""
    root = cc.parent.to(torch.int64)
    slot = cc.cmin.gather(1, root)
    own = _on(band.window_sites(), cc.state.device).to(torch.int32)[root]
    if sets.shape[1] == 0:
        cc.labels.copy_(own)
        return
    none = slot == INT32_MAX
    cc.labels.copy_(torch.where(none, own, sets.gather(1, slot.masked_fill(none, 0).long())))


def write(cc, band, sets):
    """Every window site's label (after :func:`merge`): its root's set
    minimum from ``sets`` int32 ``[G, E]`` (the band's slice of
    ``BandMerge.labels``) where the root has a slot, else the root's global
    index.  The plain version for CPU tensors, the ``cc_band_write`` kernel
    for CUDA tensors."""
    sets = sets.to(cc.state.device)
    if _build.device_kind(cc.state) == "cpu":
        write_plain(cc, band, sets)
        return
    g = _check(cc, band)
    _build.expect(sets, "sets", torch.int32, (g, n_slots(band)), cc.state.device)
    _build.check(_build.library().peapods_cc_band_write(
        cc.parent.data_ptr(), cc.cmin.data_ptr(), sets.data_ptr(), cc.labels.data_ptr(),
        band.words.ctypes.data, g, _stream(cc.state)), "cc_band_write")
    LAUNCHES["cc_band_write"] += 1


def _check(cc, band):
    dev = cc.state.device
    g = cc.state.shape[0]
    shape = (g, band.n_window)
    _build.expect(cc.state, "state", torch.uint8, shape, dev)
    for name in ("parent", "labels", "cmin"):
        _build.expect(getattr(cc, name), name, torch.int32, shape, dev)
    if not 1 <= g <= 65535:
        raise ValueError("1 to 65535 graphs per band")
    return g


def _label(ccs, bands, link_fn, export_fn, merge_fn, write_fn):
    mb = BandMerge.empty(ccs[0].state.shape[0], bands, ccs[0].state.device)
    for cc, band in zip(ccs, bands):
        link_fn(cc, band)
    if n_slots(bands[0]):
        for cc, band in zip(ccs, bands):
            export_fn(cc, band, mb)
        merge_fn(mb)
    for cc, band in zip(ccs, bands):
        write_fn(cc, band, mb.labels[band.k])


def banded_labels_plain(ccs, bands) -> None:
    """Plain version of :func:`banded_labels` on tensors of any device."""
    _label(ccs, bands, link_plain,
           lambda cc, band, mb: _export_into(mb, cc, band, export_plain), merge_plain,
           lambda cc, band, sets: write_plain(cc, band, sets.to(cc.state.device)))


def banded_labels(ccs, bands) -> None:
    """Label the bands' graphs from their state bytes (``fk.fk_bonds_band``
    fills them): :func:`link` and :func:`export` on every band,
    :func:`merge` on the first band's device, :func:`write` on every band.
    Every window site's label is its component's minimum global site
    index.  CPU tensors take :func:`banded_labels_plain`; CUDA tensors the
    kernels, a number of launches fixed by the geometry."""
    if _build.device_kind(ccs[0].state) == "cpu":
        banded_labels_plain(ccs, bands)
        return
    _label(ccs, bands, link, export, merge, write)


def band_cc_labels(masks, geometry):
    """int32 ``[G, n_spins]`` labels of global bond masks bool ``[G,
    n_spins, n_neighbors]`` on ``geometry``'s lattice, labelled in its bands
    on the masks' device.  The FK path fills the bands' buffers with
    ``fk.fk_bonds_band`` instead."""
    lat = geometry.lattice
    g = masks.shape[0]
    dev = masks.device
    bits = torch.arange(lat.n_neighbors, device=dev, dtype=torch.uint8)
    ccs = []
    for band in geometry.bands:
        m = masks[:, _on(band.window_sites(), dev)] & _on(window_reach(band), dev)
        cc = BandCC.empty(g, band, dev)
        cc.state.copy_((m.to(torch.uint8) << bits).sum(-1, dtype=torch.uint8))
        ccs.append(cc)
    banded_labels(ccs, geometry.bands)
    return torch.cat([cc.labels[:, b.interior] for cc, b in zip(ccs, geometry.bands)], -1)
