"""Connected components of bond graphs split into row bands.

Counterpart of ``peapods_tpu/ops/pallas_cc_band.py`` ``band_cc_batch``
(:198, kernel ``_band_kernel`` :169) as ``peapods_tpu/ops/cluster.py``
``connected_components_banded`` (:194) drives it under the reference's
``space`` mesh: every site gets its component's minimum global site index,
bitwise the unsharded labelling.

Each band of a :class:`~.lattice.BandGeometry` keeps per graph and window
site (the band's rows and its halos) a :class:`BandCC` buffer: the bond
bits of the state byte (bit ``k``: the bond to the forward neighbour at
offset ``k``, set only where that neighbour lies in the window), a
union-find parent, the site's label (global indices, starting at its own)
and ``cmin``, a minimum per root (starting at the site's own index).
:func:`link` unites each window's bonds once; a round (:func:`band_round`)
takes, over each window component, the minimum of its sites' labels and
gives it to the band's sites;
:func:`banded_labels` runs rounds, copying the edge label rows into the
neighbours' halos between them, until a round changes no band's labels
(:func:`banded_labels_plain` with the plain versions on any device).
On CUDA tensors :func:`link` and :func:`band_round` launch ``csrc/cc_band.cu``
(counted in :data:`LAUNCHES`); on CPU tensors they run :func:`link_plain` /
:func:`band_round_plain`.  The FK bonds of the bands (``fk.fk_bonds_band``)
fill the buffers; :func:`band_cc_labels` fills them from global bond masks.

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
from .halo import exchange

__all__ = ["LAUNCHES", "INT32_MAX", "BandCC", "window_reach", "link", "link_plain",
           "band_round", "band_round_plain", "banded_labels", "banded_labels_plain",
           "band_cc_labels"]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"cc_band_link": 0, "cc_band_min": 0, "cc_band_write": 0}

INT32_MAX = 2**31 - 1


@dataclass
class BandCC:
    """One band's buffers ``[G, n_window]`` and its round flag (int32
    ``[1]``, the number of the last round that lowered a label)."""

    state: torch.Tensor
    parent: torch.Tensor
    labels: torch.Tensor
    cmin: torch.Tensor
    flag: torch.Tensor

    @classmethod
    def empty(cls, n_graphs, band, device):
        shape = (n_graphs, band.n_window)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(torch.empty(shape, dtype=torch.uint8, device=device),
                   torch.empty(shape, **i32), torch.empty(shape, **i32),
                   torch.empty(shape, **i32), torch.zeros(1, **i32))


def window_reach(band):
    """bool ``[n_window, n_neighbors]``: whether each window site's forward
    neighbour lies in the window."""
    rows = np.arange(band.rows)[:, None] + band.lattice.offsets[:, 0][None, :]
    inside = (rows >= 0) & (rows < band.rows)
    return np.repeat(inside, band.block, axis=0)


def _masks(state, band):
    bits = torch.arange(band.lattice.n_neighbors, device=state.device, dtype=torch.uint8)
    return ((state[..., None] >> bits) & 1).to(torch.bool)


def link_plain(cc, band):
    """Plain ``cc_band_link``: each window site's parent becomes its
    component's root, the minimum window index (the window is periodic
    along the rows here, but no bond leaves it, so no wrap joins sites)."""
    lab = connected_components(_masks(cc.state, band), band.window_shape,
                               band.lattice.offsets)
    cc.parent.copy_(lab)


def link(cc, band):
    """Unite every window's bonds (see :func:`link_plain`): the plain
    version for CPU tensors, the ``cc_band_link`` kernel for CUDA tensors."""
    if _build.device_kind(cc.state) == "cpu":
        link_plain(cc, band)
        return
    g = _check(cc, band)
    _build.check(_build.library().peapods_cc_band_link(
        cc.state.data_ptr(), cc.parent.data_ptr(), band.words.ctypes.data, g,
        torch.cuda.current_stream(cc.state.device).cuda_stream), "cc_band_link")
    LAUNCHES["cc_band_link"] += 1


def band_round_plain(cc, band, rnd):
    """Plain version of a round: ``cmin[root] = min(cmin[root], label)``
    over the window (the first round too: the plain link's roots are the
    smallest window indices, not the smallest global ones), then each band
    site takes its root's ``cmin``; the flag becomes ``rnd`` when a label
    falls."""
    root = cc.parent.to(torch.int64)
    while True:  # a kernel-built parent array is a forest: find the roots
        nxt = root.gather(1, root)
        if torch.equal(nxt, root):
            break
        root = nxt
    cc.cmin.scatter_reduce_(1, root, cc.labels, "amin")
    inner = band.interior
    new = cc.cmin.gather(1, root[:, inner])
    if bool((new < cc.labels[:, inner]).any()):
        cc.flag.fill_(rnd)
    cc.labels[:, inner] = new


def band_round(cc, band, rnd, first=False):
    """One round over a band (see :func:`band_round_plain`): the plain
    version for CPU tensors; for CUDA tensors ``cc_band_min`` over the halo
    sites (not in the ``first`` round, whose roots, the components' sites
    of smallest global index, already hold the minimum of the starting
    labels) then ``cc_band_write``."""
    if _build.device_kind(cc.state) == "cpu":
        band_round_plain(cc, band, rnd)
        return
    g = _check(cc, band)
    lib = _build.library()
    stream = torch.cuda.current_stream(cc.state.device).cuda_stream
    if not first:
        _build.check(lib.peapods_cc_band_min(
            cc.parent.data_ptr(), cc.labels.data_ptr(), cc.cmin.data_ptr(),
            band.words.ctypes.data, g, stream), "cc_band_min")
        LAUNCHES["cc_band_min"] += 1
    _build.check(lib.peapods_cc_band_write(
        cc.parent.data_ptr(), cc.labels.data_ptr(), cc.cmin.data_ptr(),
        cc.flag.data_ptr(), band.words.ctypes.data, rnd, g, stream), "cc_band_write")
    LAUNCHES["cc_band_write"] += 1


def _check(cc, band):
    dev = cc.state.device
    g = cc.state.shape[0]
    shape = (g, band.n_window)
    _build.expect(cc.state, "state", torch.uint8, shape, dev)
    for name in ("parent", "labels", "cmin"):
        _build.expect(getattr(cc, name), name, torch.int32, shape, dev)
    _build.expect(cc.flag, "flag", torch.int32, (1,), dev)
    if not 1 <= g <= 65535:
        raise ValueError("1 to 65535 graphs per band")
    return g


def _label_rounds(ccs, bands, rounds, link_fn, round_fn):
    for cc, band in zip(ccs, bands):
        link_fn(cc, band)
    first = rounds + 1
    while True:
        rounds += 1
        for cc, band in zip(ccs, bands):
            round_fn(cc, band, rounds, rounds == first)
        if not any(int(cc.flag.item()) == rounds for cc in ccs):
            return rounds
        exchange([cc.labels for cc in ccs], bands)


def banded_labels_plain(ccs, bands, rounds: int) -> int:
    """Plain version of :func:`banded_labels` on tensors of any device:
    :func:`link_plain` and :func:`band_round_plain` rounds."""
    return _label_rounds(ccs, bands, rounds, link_plain,
                         lambda cc, band, rnd, first: band_round_plain(cc, band, rnd))


def banded_labels(ccs, bands, rounds: int) -> int:
    """Label the bands' graphs: link each band, then rounds numbered from
    ``rounds + 1`` until one lowers no label in any band, the halos' labels
    copied from the neighbours between rounds.  The first round needs no
    copy: every label starts at its site's own index, the neighbours' too.
    Returns the number of the last round (a run's round numbers keep
    growing, so a flag left from an earlier labelling never reads as
    set).  The buffers start as ``fk.fk_bonds_band`` leaves them: parent,
    label and cmin each the site's own window and global index.  CPU
    tensors take :func:`banded_labels_plain`; CUDA tensors the kernels."""
    if _build.device_kind(ccs[0].state) == "cpu":
        return banded_labels_plain(ccs, bands, rounds)
    return _label_rounds(ccs, bands, rounds, link, band_round)


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
        sites = torch.from_numpy(band.window_sites()).to(dev)
        m = masks[:, sites] & torch.from_numpy(window_reach(band)).to(dev)
        cc = BandCC.empty(g, band, dev)
        cc.state.copy_((m.to(torch.uint8) << bits).sum(-1, dtype=torch.uint8))
        cc.parent.copy_(torch.arange(band.n_window, dtype=torch.int32, device=dev))
        cc.labels.copy_(sites.to(torch.int32))
        cc.cmin.copy_(sites.to(torch.int32))
        ccs.append(cc)
    banded_labels(ccs, geometry.bands, 0)
    return torch.cat([cc.labels[:, b.interior] for cc, b in zip(ccs, geometry.bands)], -1)
