"""Connected components of a batch of bond graphs on any lattice.

Counterpart of ``connected_components_batch`` (``peapods_tpu/ops/
pallas_cc_batch.py:428``, kernel ``_cc_batch_kernel`` :394, with offset
tables through ``cc_gen_offsets`` :332) and ``connected_components_2d``
(``peapods_tpu/ops/pallas_cc.py:66``): int32 labels ``[B, n]``, each site's
component's minimum site index, of bool masks ``[B, n, n_nb]`` whose entry
``[b, i, d]`` is the bond from site ``i`` to its neighbour at the lattice's
forward offset ``d``.

:func:`cc_labels` launches ``csrc/cc.cu``'s labelling on CUDA tensors
(:func:`launch`, counted in :data:`LAUNCHES`) and runs the plain version
:func:`~.cluster.connected_components` on CPU tensors.  The kernels read
the masks packed into one state byte a site (bit ``d``: bond ``d``) and
nothing else; the FK bonds of the staged path (``fk.fk_staged``) write
those bytes and call :func:`launch` directly.  :func:`link_plan` picks the
form from the shape alone: a graph of at most :data:`LINK_TILE_SITES`
sites is one box, labelled by one ``cc_link`` launch (a cluster of CTAs a
graph where the batch is small); a larger one is cut into
``fk.link_plan``'s tiles, and ``cc_link_border`` and
``fk.launch_flatten`` complete it.  On a table lattice (4D and up, or 7
to 32 offsets) :func:`table_link_plan` picks the table form's: a graph's
union-find in one CTA's shared memory, or over a cluster of up to
:data:`LINK_MAX_CLUSTER` CTAs, in one ``cc_table_link`` launch; past one
cluster's shared memory, slabs of one CTA each, completed by
``cc_table_border`` and ``fk.launch_flatten`` (:func:`table_link_launches`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .cluster import connected_components
from .lattice import MAX_OFFSETS, check_tables, fast_divisor

__all__ = ["LAUNCHES", "LinkPlan", "TableLinkPlan", "cc_labels", "cc_labels_plain", "launch",
           "link_launches", "link_plan", "link_words", "pack_masks", "table_link_launches",
           "table_link_plan", "table_link_words"]

# kernel launches since the last reset, by kernel name (the tiled forms'
# flatten is fk.cu's fk_link_flatten, counted in fk.LAUNCHES)
LAUNCHES = {"cc_link": 0, "cc_link_border": 0, "cc_table_link": 0, "cc_table_border": 0}

# csrc/cc.cu kCcSites, kCcThreads, kCcMaxCluster: a box of at most
# LINK_TILE_SITES sites in a CTA's shared memory, a CTA of at most
# LINK_THREADS threads; the whole-graph form spreads a graph over a cluster
# of up to LINK_MAX_CLUSTER CTAs (slabs of at least LINK_MIN_SLAB sites),
# until a launch has LINK_CLUSTER_CTAS CTAs
LINK_TILE_SITES = 8192
LINK_THREADS = 1024
LINK_MAX_CLUSTER = 8
LINK_CLUSTER_CTAS = 132
LINK_MIN_SLAB = 64


class LinkPlan(NamedTuple):
    """How the labelling cuts a graph: boxes of ``tile`` sites (an ``(l0,
    l1, l2)`` box), CTAs of ``threads`` threads (a multiple of 32), whether
    the boxes split the graph (``tiled``: ``cc_link_border`` and
    ``fk_link_flatten`` follow ``cc_link``) and, in the whole-graph form,
    the CTAs of a graph's cluster (``cluster``: slabs of consecutive
    sites)."""

    tile: tuple
    threads: int
    tiled: bool
    cluster: int = 1


def _threads(sites: int) -> int:
    """A CTA's threads for ``sites`` sites: a multiple of 32, at most
    ``LINK_THREADS``."""
    return min(LINK_THREADS, -(-int(sites) // 32) * 32)


@functools.lru_cache(maxsize=None)
def link_plan(dims, n_graphs: int) -> LinkPlan:
    """The labelling's form for ``n_graphs`` graphs of ``dims = (l0, l1,
    l2)`` sites (``l2 = 1`` in 2D), from the shape alone: the whole graph,
    in one launch, where it has at most :data:`LINK_TILE_SITES` sites, over
    a cluster of up to :data:`LINK_MAX_CLUSTER` CTAs (a power of two) while
    the launch holds fewer than :data:`LINK_CLUSTER_CTAS` CTAs; else
    ``fk_link``'s tiles (``fk.link_plan``).  A CTA takes up to
    :data:`LINK_THREADS` threads, a round of sites each."""
    from .fk import link_plan as fk_link_plan

    dims = tuple(int(x) for x in dims)
    n = math.prod(dims)
    if n > LINK_TILE_SITES:
        tile = tuple(fk_link_plan(dims, n_graphs).tile)
        return LinkPlan(tile, _threads(math.prod(tile)), True)
    c = 1
    while (c < LINK_MAX_CLUSTER and n // (2 * c) >= LINK_MIN_SLAB
           and n_graphs * 2 * c <= LINK_CLUSTER_CTAS):
        c *= 2
    return LinkPlan(dims, _threads(-(-n // c)), False, c)


def link_launches(shape, n_graphs: int) -> dict:
    """The launches of one labelling of ``n_graphs`` graphs of ``shape`` (a
    walk-form lattice's kernel shape), by kernel name."""
    plan = link_plan(_build.dims3(shape), n_graphs)
    names = ("cc_link", "cc_link_border", "fk_link_flatten") if plan.tiled else ("cc_link",)
    return dict.fromkeys(names, 1)


# csrc/cc.cu kTableSmem: the dynamic shared memory a table-form CTA takes at
# most (the H100's 227 KB a block); a graph spreads over more CTAs than its
# shared memory needs only while their slabs keep TABLE_MIN_SLAB sites
# (tools/probe_colour_cc.py, NVIDIA H100 80GB HBM3: 16^3 with 13 offsets x
# 8 graphs 0.0327 ms a labelling in one CTA a graph, 0.0475 over 2, 0.0358
# over 4; 16^4 x 16 over 8 CTAs 0.125, over 4 0.160)
TABLE_SMEM = 232448
TABLE_MIN_SLAB = 4096


class TableLinkPlan(NamedTuple):
    """How the table form cuts a graph of ``n`` sites: slabs of ``slab``
    consecutive sites, a CTA each, of ``threads`` threads; ``cluster``
    CTAs a graph (a thread-block cluster when more than 1), or, where
    ``slabs``, as many one-CTA slabs as the graph needs, completed by
    ``cc_table_border`` and ``fk_link_flatten``; ``smem`` the bytes of
    shared memory a CTA takes."""

    cluster: int
    slab: int
    threads: int
    slabs: bool
    smem: int


def table_state_bytes(n_neighbors: int) -> int:
    """Bytes of a site's state bits in a table-form CTA's shared memory."""
    return 1 if n_neighbors <= 8 else 2 if n_neighbors <= 16 else 4


@functools.lru_cache(maxsize=None)
def table_link_plan(n: int, n_neighbors: int, n_graphs: int) -> TableLinkPlan:
    """The table form's plan for ``n_graphs`` graphs of ``n`` sites and
    ``n_neighbors`` offsets, from the shape alone: the whole graph over the
    fewest CTAs (a power of two up to :data:`LINK_MAX_CLUSTER`) whose
    slabs fit one CTA's shared memory (:data:`TABLE_SMEM`, 4 bytes of
    parent and :func:`table_state_bytes` a site), doubled while slabs keep
    :data:`TABLE_MIN_SLAB` sites and the launch holds at most
    :data:`LINK_CLUSTER_CTAS` CTAs; past eight such slabs, as many
    balanced slabs as fit.  A CTA takes a thread a site up to
    :data:`LINK_THREADS` (fewer threads, more rounds, were slower at every
    shape the probe timed)."""
    n, nb, b = int(n), int(n_neighbors), int(n_graphs)
    per_site = 4 + table_state_bytes(nb)
    cap = TABLE_SMEM // per_site
    if n <= LINK_MAX_CLUSTER * cap:
        c = 1
        while -(-n // c) > cap:
            c *= 2
        while (c < LINK_MAX_CLUSTER and n // (2 * c) >= TABLE_MIN_SLAB
               and b * 2 * c <= LINK_CLUSTER_CTAS):
            c *= 2
        slab, slabs = -(-n // c), False
    else:
        slab, slabs, c = -(-n // -(-n // cap)), True, 1
    return TableLinkPlan(c, slab, _threads(slab), slabs, slab * per_site)


def table_link_launches(n: int, n_neighbors: int, n_graphs: int) -> dict:
    """The launches of one table-form labelling, by kernel name."""
    names = (("cc_table_link", "cc_table_border", "fk_link_flatten")
             if table_link_plan(n, n_neighbors, n_graphs).slabs else ("cc_table_link",))
    return dict.fromkeys(names, 1)


def table_link_words(lattice, n_graphs: int) -> np.ndarray:
    """int32 host words of ``csrc/cc.cu``'s table form (``make_cc_table``):
    the sites, the offsets, the plan's CTAs a graph, a slab's sites,
    :func:`~.lattice.fast_divisor` ``(m, s)`` of the slab, whether the
    slabs split the graph, and a CTA's threads."""
    n, nb = lattice.n_spins, lattice.n_neighbors
    plan = table_link_plan(n, nb, n_graphs)
    m, s = fast_divisor(plan.slab)
    return np.asarray([n, nb, plan.cluster, plan.slab, m, s, int(plan.slabs), plan.threads],
                      np.int64).astype(np.uint32).view(np.int32)


def fast_offset(offsets, n_dims: int) -> int:
    """The index of the offset that is the fast axis' unit step (``[0, 1]``
    in 2D, ``[0, 0, 1]`` in 3D), whose runs ``cc_link`` hangs with a ballot,
    or -1."""
    unit = [0] * (n_dims - 1) + [1]
    for d, off in enumerate(np.asarray(offsets).tolist()):
        if off == unit:
            return d
    return -1


@functools.lru_cache(maxsize=None)
def _words(geometry: tuple, n_dims: int, tile: tuple, cluster: int) -> np.ndarray:
    L = np.asarray(geometry[:3], np.int64)
    n_nb = int(geometry[3])
    off = np.asarray(geometry[4:], np.int64).reshape(MAX_OFFSETS, 3)
    t = np.asarray(tile, np.int64)
    nt = -(-L // t)
    res = off % L
    bs = -(-int(np.prod(L)) // cluster)
    div = [fast_divisor(int(x)) for x in (t[1] * t[2], t[2], nt[1] * nt[2], nt[2], bs)]
    words = np.concatenate([L, t, nt, [n_nb, fast_offset(off[:n_nb, :n_dims], n_dims)],
                            off.reshape(-1), res.reshape(-1),
                            np.asarray(div, np.int64).reshape(-1), [cluster, bs]])
    return words.astype(np.uint32).view(np.int32)


def link_words(lattice, tile, cluster: int = 1) -> np.ndarray:
    """int32 host words of ``csrc/cc.cu``'s kernels (``make_cc_walk``): the
    extents, the box extents ``tile``, the boxes along each axis, the
    number of offsets and the fast axis' unit step (:func:`fast_offset`),
    the six zero-padded offsets, their residues ``off mod L`` per axis,
    :func:`~.lattice.fast_divisor` ``(m, s)`` of ``t1 t2``, ``t2``, ``nt1
    nt2``, ``nt2`` and the slab ``bs``, then the whole-graph form's
    ``cluster`` of CTAs a graph and ``bs = ceil(n / cluster)``, the sites of
    a CTA's slab."""
    return _words(tuple(int(x) for x in lattice.kernel_geometry), len(lattice.kernel_shape),
                  tuple(int(x) for x in tile), int(cluster))


def cc_labels_plain(masks, lattice):
    """The plain version: the min-label fixed point on the lattice's
    offsets."""
    return connected_components(masks.to(torch.bool), lattice.shape, lattice.offsets)


def pack_masks(masks, dtype=torch.uint8):
    """``[..., n]`` state words of bool masks ``[..., n, n_nb]``: bit ``d``
    is bond ``d``; uint8 bytes, or int32 words for the table form."""
    bits = torch.arange(masks.shape[-1], device=masks.device, dtype=dtype)
    return (masks.to(dtype) << bits).sum(-1, dtype=dtype)


def launch(lib, stream, p_state, p_labels, lattice, n_graphs, tables=None):
    """Label ``n_graphs`` graphs of ``lattice`` on raw pointers: their state
    bytes (bit ``d``: bond ``d``) in, every label written to ``p_labels``
    (int32 ``[n_graphs, n]``).  ``cc_link``, and where :func:`link_plan`
    cuts a graph into boxes ``cc_link_border`` and ``fk_link_flatten`` on
    the labels as parents.  On a table lattice (:attr:`~.lattice.Lattice.
    table`) the state is an int32 word a site, and the table form labels it
    (:func:`table_link_plan`): ``cc_table_link`` (a graph's union-find in
    shared memory, over a cluster of CTAs where the plan says so) and,
    where slabs split a graph, ``cc_table_border`` and ``fk_link_flatten``,
    reading the forward table of the checked device ``tables``."""
    from . import fk

    if lattice.table:
        n = lattice.n_spins
        fwd = tables[0].data_ptr()
        words = table_link_words(lattice, n_graphs)
        _build.check(lib.peapods_cc_table_link(p_state, p_labels, fwd, words.ctypes.data,
                                               n_graphs, stream), "cc_table_link")
        LAUNCHES["cc_table_link"] += 1
        if not words[6]:
            return
        _build.check(lib.peapods_cc_table_border(p_state, p_labels, fwd, words.ctypes.data,
                                                 n_graphs, stream), "cc_table_border")
        LAUNCHES["cc_table_border"] += 1
        fk.launch_flatten(lib, stream, p_labels, n_graphs, n)
        return
    dims = _build.dims3(lattice.kernel_shape)
    plan = link_plan(dims, n_graphs)
    words = link_words(lattice, plan.tile, plan.cluster).ctypes.data
    _build.check(lib.peapods_cc_link(p_state, p_labels, words, n_graphs, plan.threads,
                                     stream), "cc_link")
    LAUNCHES["cc_link"] += 1
    if not plan.tiled:
        return
    _build.check(lib.peapods_cc_link_border(p_state, p_labels, words, n_graphs, stream),
                 "cc_link_border")
    LAUNCHES["cc_link_border"] += 1
    fk.launch_flatten(lib, stream, p_labels, n_graphs, lattice.n_spins)


def cc_labels(masks, lattice, tables=None):
    """int32 ``[B, n]`` component labels of bool masks ``[B, n, n_nb]`` on
    ``lattice`` (any lattice: the table form's past six offsets or three
    dimensions, on the device ``tables``, :func:`~.lattice.check_tables`):
    the plain version for CPU tensors, the kernels for CUDA tensors."""
    if _build.device_kind(masks) == "cpu":
        return cc_labels_plain(masks, lattice)
    dev = masks.device
    b = masks.shape[0]
    n, n_nb = lattice.n_spins, lattice.n_neighbors
    _build.expect(masks, "masks", torch.bool, (b, n, n_nb), dev)
    if not 1 <= b <= 65535:
        raise ValueError("1 to 65535 graphs per call")
    if lattice.table:
        check_tables(tables, lattice, dev)
    state = pack_masks(masks, torch.int32 if lattice.table else torch.uint8)
    labels = torch.empty((b, n), dtype=torch.int32, device=dev)
    launch(_build.library(), torch.cuda.current_stream(dev).cuda_stream,
           state.data_ptr(), labels.data_ptr(), lattice, b, tables)
    return labels
