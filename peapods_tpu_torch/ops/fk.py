"""The FK cluster update (Swendsen-Wang or Wolff) of a flat graph batch.

Counterpart of ``peapods_tpu/ops/pallas_event.py`` ``fk_update_batch``
(:759, kernel ``_fk_kernel`` :621) and of the engine's staged chain
``fk_bond_activation -> connected_components -> coin / Wolff flips``
(``peapods_tpu/engine/loop.py:1883-1976``).  The graphs are the
(realization, system) pairs, flat and disorder-major: spins int8 ``[B,
*shape]`` by system (``B = d * S``), the forward couplings f32 ``[d, n,
n_dirs]`` of the realizations, one temperature and one row of scalars
``(salt0, salt1, seed)`` (:func:`~peapods_tpu_torch.engine.seeds.fk_scalars`)
and two key words ``kb`` per graph.  A graph is a 2D square (two bond
directions), a 2D triangular (three: down, right and ``[1, -1]``, the
reference's ``tri=True``) or a 3D cubic lattice (three); its bond offsets
are :func:`~.cluster.fk_offsets`.  The graphs are not packed into tiles.

:func:`fk_update` launches the kernels of ``csrc/fk.cu`` on CUDA tensors
(counted in :data:`LAUNCHES`): ``fk_bonds``, the labelling
(:func:`launch_link`: ``fk_link``, and where :func:`link_plan` cuts a graph
into tiles ``fk_link_border`` and ``fk_link_flatten``) and ``fk_finish``;
it runs :func:`fk_update_plain` on CPU tensors.  Both update the spins in
place and return the same values: bond uniforms from Philox keyed by
``kb`` (``rng.bond_uniforms``), labels
equal to each component's minimum site index, and per-graph partial sums
of the post-update energy and magnetization (one partial per kernel block;
one per graph in the plain version).

:func:`fk_observe` is FK observe on those lattices: the same bonds and
labels, ``fk_finish`` in observe form (labels only, the spins untouched),
and the bond masks, bits of the kernels' state bytes.  :func:`fk_staged`
is the staged path of the lattices given by an offset table (BCC, FCC,
custom offsets): ``fk_bonds_nb`` draws the bonds along each offset, the
connected-components kernels of :mod:`.cc` label them, and ``fk_finish``
flips from those labels (nothing, when observing); the caller measures.

The band forms serve a lattice split into row bands over a ``space`` mesh
(:class:`~.lattice.Band`: each band's rows and its halos, the window):
:func:`fk_bonds_band` draws the bonds of every window site whose forward
neighbour lies in the window, with the unsharded kernels' uniforms, and
writes the state bytes of the band's :class:`~.cc_band.BandCC`; after
``cc_band.banded_labels``, :func:`fk_finish_band` flips the band's sites
from the global labels (:func:`wolff_seed_labels` reads each Wolff seed's
label from the band that holds it) and optionally measures them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build, cc, rng
from .cc_band import INT32_MAX, window_reach
from .cluster import (
    cluster_coin_flip_mask,
    connected_components,
    fk_bond_activation,
    fk_offsets,
    wolff_flip_mask,
)
from .energy import per_spin
from .lattice import neighbour_values

__all__ = [
    "LAUNCHES",
    "fused_lattice",
    "fk_update",
    "fk_update_plain",
    "fk_observe",
    "fk_observe_plain",
    "fk_staged",
    "fk_staged_plain",
    "state_masks",
    "fk_bonds_plain",
    "fk_link_plain",
    "fk_link_tiles_plain",
    "fk_link_flatten_plain",
    "tile_bonds",
    "fk_finish_plain",
    "fk_energy_mag",
    "launch_link",
    "LinkPlan",
    "link_plan",
    "link_launches",
    "fk_bonds_band",
    "fk_bonds_band_plain",
    "fk_finish_band",
    "fk_finish_band_plain",
    "wolff_seed_labels",
]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"fk_bonds": 0, "fk_bonds_nb": 0, "fk_link": 0, "fk_link_border": 0,
            "fk_link_flatten": 0, "fk_finish": 0, "fk_bonds_band": 0,
            "fk_finish_band": 0}

# fk_link (csrc/fk.cu kLinkSites, kLinkThreads): a CTA holds a tile of at
# most LINK_TILE_SITES sites of one graph in shared memory, its threads
# along the fast axis.  A graph that fits is one tile; a larger graph is cut
# into tiles that shrink, down to LINK_MIN_TILE sites, until a launch has
# LINK_MIN_CTAS CTAs.  A launch of fewer CTAs gives each LINK_THREADS
# threads, else LINK_THREADS // 2 (more CTAs in flight an SM).
LINK_TILE_SITES = 8192
LINK_THREADS = 1024
LINK_MIN_TILE = 512
LINK_MIN_CTAS = 1024


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_lattice(lattice) -> bool:
    """Whether the FK kernels (``fk_bonds`` / ``fk_link`` / ``fk_finish``)
    take the lattice's graphs: square, triangular or 3D cubic.  The others
    (BCC, FCC, offset tables) take the staged path, :func:`fk_staged`."""
    return lattice.hypercubic or lattice.triangular


def fk_energy_mag(e_part, m_part, n_spins: int):
    """``(e f32 [B], m int32 [B])`` from partials ``[B, blocks]``, added in
    order: the energy per spin and the magnetization sum."""
    return per_spin(e_part.sum(-1), n_spins), m_part.sum(-1, dtype=torch.int32)


def fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms=None, offsets=None):
    """Plain version of ``fk_bonds`` (and, given an offset table's
    ``offsets``, of ``fk_bonds_nb``): bool ``[B, n, n_dirs]`` FK bonds of
    every graph (arguments as in :func:`fk_update_plain`)."""
    b, shape = spins.shape[0], tuple(spins.shape[1:])
    d, n, n_dirs = j_fwd.shape
    u = (uniforms if uniforms is not None
         else rng.bond_uniforms(kb_words, n, n_dirs=n_dirs))
    bonds = fk_bond_activation(spins.reshape(d, b // d, n), j_fwd[:, None],
                               shape, temps.reshape(d, -1),
                               u.reshape(d, -1, n, n_dirs),
                               fk_offsets(shape, n_dirs) if offsets is None else offsets)
    return bonds.reshape(b, n, n_dirs)


def fk_link_plain(bonds, shape):
    """Plain version of ``fk_link``: int32 ``[B, n]`` labels, each
    component's minimum site index."""
    return connected_components(bonds, shape, fk_offsets(shape, bonds.shape[-1]))


def tile_bonds(shape, n_dirs: int, tile, device):
    """bool ``[n, n_dirs]``: which forward bonds stay inside their site's
    tile of ``tile`` sites (an ``(l0, l1, l2)`` box; a tile that spans an
    axis keeps the bonds that wrap around it)."""
    dims = _build.dims3(shape)
    c = torch.stack(torch.meshgrid(*(torch.arange(d, device=device) for d in dims),
                                   indexing="ij"), -1).reshape(-1, 3)
    keep = torch.ones((c.shape[0], n_dirs), dtype=torch.bool, device=device)
    for k, off in enumerate(fk_offsets(tuple(shape), n_dirs)):
        for a, o in enumerate(tuple(off) + (0,) * (3 - len(off))):
            if dims[a] > tile[a] and o:
                to = c[:, a] + o
                keep[:, k] &= (to >= 0) & (to < dims[a]) & (to // tile[a] == c[:, a] // tile[a])
    return keep


def fk_link_tiles_plain(bonds, shape, tile):
    """Plain version of ``fk_link`` in the tiled form: int32 ``[B, n]``, each
    site's parent the minimum site of its component inside its tile."""
    keep = tile_bonds(shape, bonds.shape[-1], tile, bonds.device)
    return fk_link_plain(bonds & keep, shape)


def fk_link_flatten_plain(parent):
    """Plain version of ``fk_link_flatten``: int32 ``[B, n]``, every parent
    replaced by its root (the labels that ``fk_link_border``'s parents lead
    to)."""
    p = parent.long()
    while True:
        q = p.gather(-1, p)
        if torch.equal(q, p):
            return q.to(torch.int32)
        p = q


def state_masks(state, n_dirs: int):
    """bool ``[B, n, n_dirs]`` bond masks from the kernels' state bytes
    ``[B, n]``: bits ``0 .. n_dirs - 1``."""
    bits = torch.arange(n_dirs, device=state.device, dtype=torch.uint8)
    return ((state[..., None] >> bits) & 1).to(torch.bool)


def fk_finish_plain(spins, labels, j_fwd, scalars, *, wolff, with_measure):
    """Plain version of ``fk_finish``: flip the clusters in place (SW coin
    or Wolff seed) and, when ``with_measure``, return the post-update
    partials ``(e_part f32 [B, 1], m_part int32 [B, 1])``."""
    b, shape = spins.shape[0], tuple(spins.shape[1:])
    d, n, n_dirs = j_fwd.shape
    if wolff:
        flip = wolff_flip_mask(labels, scalars[:, 2])
    else:
        flip = cluster_coin_flip_mask(labels, scalars[:, :2])
    s = spins.reshape(b, n)
    new = torch.where(flip, -s, s)
    spins.copy_(new.reshape(spins.shape))
    if not with_measure:
        return None, None
    sf = new.to(torch.float32).reshape(d, b // d, n)
    e = torch.zeros_like(sf)
    for k, off in enumerate(fk_offsets(shape, n_dirs)):
        e = e + sf * neighbour_values(sf, shape, off) * j_fwd[:, None, :, k]
    return (e.reshape(b, n).sum(-1, keepdim=True),
            new.to(torch.int32).sum(-1, keepdim=True, dtype=torch.int32))


def fk_update_plain(spins, j_fwd, temps, scalars, kb_words, *, wolff,
                    with_measure, with_labels, uniforms=None):
    """One FK update of every graph, in place, in plain torch: the three
    kernels' plain versions in turn.

    Args:
        spins: int8 ``[B, *shape]``, updated in place.
        j_fwd: f32 ``[d, n, n_dirs]`` forward couplings; graph ``b`` reads
            realization ``b // (B // d)``.
        temps: f32 ``[B]``.
        scalars: int32 ``[B, 3]`` ``(salt0, salt1, seed)``.
        kb_words: int32 ``[B, 2]`` bond-draw key words (unused when
            ``uniforms`` is given).
        uniforms: optional f32 ``[B, n, n_dirs]`` injected bond uniforms.

    Returns:
        ``(e_part f32 [B, 1], m_part int32 [B, 1])`` of the post-update
        spins when ``with_measure`` (else ``None, None``), and the int32
        ``[B, *shape]`` labels when ``with_labels`` (else ``None``).
    """
    bonds = fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms)
    labels = fk_link_plain(bonds, tuple(spins.shape[1:]))
    e_part, m_part = fk_finish_plain(spins, labels, j_fwd, scalars, wolff=wolff,
                                     with_measure=with_measure)
    return e_part, m_part, labels.reshape(spins.shape) if with_labels else None


class LinkPlan(NamedTuple):
    """How ``fk_link`` cuts a graph: tiles of ``tile`` sites (an ``(l0, l1,
    l2)`` box), CTAs of up to ``threads`` threads, and whether the tiles
    split the graph (``tiled``: ``fk_link_border`` and ``fk_link_flatten``
    follow the link)."""

    tile: tuple
    threads: int
    tiled: bool


def _link_tile(dims, sites):
    """A box of at most ``sites`` sites: in 2D 32 to 128 sites along the
    rows and as many rows as fit; in 3D lines of up to 32 sites along axis
    2 in a square of lines, then as many planes as fit."""
    l0, l1, l2 = dims
    if l2 > 1:
        t2 = min(l2, 32)
        lines = max(1, sites // t2)
        w = 1
        while (2 * w) ** 2 <= lines:
            w *= 2
        t1 = min(l1, w)
        return min(l0, max(1, lines // t1)), t1, t2
    w = 32
    while w < 128 and w * w < sites:
        w *= 2
    t1 = min(l1, w)
    return min(l0, max(1, sites // t1)), t1, 1


@functools.lru_cache(maxsize=None)
def link_plan(dims, n_graphs: int) -> LinkPlan:
    """``fk_link``'s form for ``n_graphs`` graphs of ``dims = (l0, l1, l2)``
    sites (``l2 = 1`` in 2D), from the shape alone: the whole-graph form
    where a graph fits a CTA's tile, else the tiled form."""
    dims = tuple(int(x) for x in dims)
    n = math.prod(dims)
    fast = dims[2] if dims[2] > 1 else dims[1]
    if n <= LINK_TILE_SITES and fast <= LINK_THREADS:
        tile = dims
    else:
        sites = LINK_TILE_SITES
        tile = _link_tile(dims, sites)
        while sites > LINK_MIN_TILE and _n_tiles(dims, tile) * n_graphs < LINK_MIN_CTAS:
            sites //= 2
            tile = _link_tile(dims, sites)
    return LinkPlan(tile, _link_threads(dims, tile, n_graphs), tile != dims)


def _n_tiles(dims, tile):
    return math.prod(-(-d // t) for d, t in zip(dims, tile))


def _link_threads(dims, tile, n_graphs):
    few = _n_tiles(dims, tile) * n_graphs < LINK_MIN_CTAS
    wide = tile[2 if dims[2] > 1 else 1] > LINK_THREADS // 2
    return LINK_THREADS if few or wide else LINK_THREADS // 2


def link_launches(shape, n_graphs: int) -> dict:
    """The launches of one labelling of ``n_graphs`` graphs of ``shape``, by
    kernel name."""
    plan = link_plan(_build.dims3(shape), n_graphs)
    names = ("fk_link", "fk_link_border", "fk_link_flatten") if plan.tiled else ("fk_link",)
    return dict.fromkeys(names, 1)


def launch_link(lib, stream, p_state, p_parent, n_graphs, l0, l1, l2, tri=False,
                plan=None):
    """Label ``n_graphs`` bond graphs of an ``(l0, l1, l2)`` lattice (``l2 =
    1`` in 2D) on raw pointers: state bytes with the forward bonds in bits
    ``0 .. n_dirs - 1`` (``tri``: the triangular lattice's three) in,
    every parent written out.  When the launches end each parent is the
    site's component's minimum site index: ``fk_link`` in shared memory,
    and where the tiles split a graph (``plan``, default
    :func:`link_plan`) ``fk_link_border`` and ``fk_link_flatten``.  The FK
    update and the overlap moves (:mod:`.overlap`) both label their graphs
    so."""
    plan = plan or link_plan((l0, l1, l2), n_graphs)
    _build.check(lib.peapods_fk_link(p_state, p_parent, n_graphs, l0, l1, l2,
                                     int(tri), *plan.tile, plan.threads, stream),
                 "fk_link")
    LAUNCHES["fk_link"] += 1
    if not plan.tiled:
        return
    _build.check(lib.peapods_fk_link_border(p_state, p_parent, n_graphs, l0, l1, l2,
                                            int(tri), *plan.tile, stream),
                 "fk_link_border")
    LAUNCHES["fk_link_border"] += 1
    _build.check(lib.peapods_fk_link_flatten(p_parent, n_graphs, l0 * l1 * l2, stream),
                 "fk_link_flatten")
    LAUNCHES["fk_link_flatten"] += 1


def _check_graphs(spins, j_fwd, temps, kb_words, scalars=None):
    """Raise unless the flat graph batch is what the FK kernels take;
    ``(b, n, d)``."""
    dev = spins.device
    b, shape = spins.shape[0], tuple(spins.shape[1:])
    n = spins[0].numel()
    d, n_dirs = j_fwd.shape[0], j_fwd.shape[-1]
    if d == 0 or b % d:
        raise ValueError(f"{b} graphs do not split over {d} realizations")
    _build.expect(spins, "spins", torch.int8, (b, *shape), dev)
    _build.expect(j_fwd, "j_fwd", torch.float32, (d, n, n_dirs), dev)
    _build.expect(temps, "temps", torch.float32, (b,), dev)
    if scalars is not None:
        _build.expect(scalars, "scalars", torch.int32, (b, 3), dev)
    _build.expect(kb_words, "kb_words", torch.int32, (b, 2), dev)
    if b > 65535:
        raise ValueError("at most 65535 graphs per update")
    return b, n, d


def _bonds_and_link(spins, j_fwd, temps, kb_words, scalars=None):
    """Check the arguments, then launch ``fk_bonds`` and ``fk_link``:
    ``(lib, stream, state, parent, dims)``."""
    dev = spins.device
    shape = tuple(spins.shape[1:])
    n_dirs = j_fwd.shape[-1]
    fk_offsets(shape, n_dirs)  # raises for a graph the kernels do not take
    b, n, d = _check_graphs(spins, j_fwd, temps, kb_words, scalars)
    tri = len(shape) == 2 and n_dirs == 3
    l0, l1, l2 = _build.dims3(shape)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = torch.empty((b, n), dtype=torch.uint8, device=dev)
    parent = torch.empty((b, n), dtype=torch.int32, device=dev)
    _build.check(lib.peapods_fk_bonds(
        spins.data_ptr(), j_fwd.data_ptr(), temps.data_ptr(),
        kb_words.data_ptr(), state.data_ptr(), parent.data_ptr(), b, b // d,
        l0, l1, l2, int(tri), stream), "fk_bonds")
    LAUNCHES["fk_bonds"] += 1
    launch_link(lib, stream, state.data_ptr(), parent.data_ptr(), b, l0, l1, l2, tri)
    return lib, stream, state, parent, (l0, l1, l2, int(tri))


def fk_update(spins, j_fwd, temps, scalars, kb_words, *, wolff, with_measure,
              with_labels, uniforms=None):
    """One FK update of every graph (see :func:`fk_update_plain`): the plain
    version for CPU tensors, the ``fk_bonds``, ``fk_link`` and
    ``fk_finish`` kernels for CUDA tensors (2 or 3 bond directions, see the
    module docstring).  The kernel partials have one entry per block of 256
    sites.  ``uniforms`` (CPU only) are the bond
    uniforms of ``kb_words`` drawn ahead by the caller."""
    kw = dict(wolff=wolff, with_measure=with_measure, with_labels=with_labels)
    if _build.device_kind(spins) == "cpu":
        return fk_update_plain(spins, j_fwd, temps, scalars, kb_words,
                               uniforms=uniforms, **kw)
    if uniforms is not None:
        raise ValueError("the FK kernels draw their own uniforms")
    lib, stream, state, parent, dims = _bonds_and_link(spins, j_fwd, temps, kb_words,
                                                       scalars)
    dev = spins.device
    b, n, d = spins.shape[0], spins[0].numel(), j_fwd.shape[0]
    labels = (torch.empty((b, *spins.shape[1:]), dtype=torch.int32, device=dev)
              if with_labels else None)
    e_part = m_part = None
    if with_measure:
        nb = lib.peapods_fk_blocks(n)
        e_part = torch.empty((b, nb), dtype=torch.float32, device=dev)
        m_part = torch.empty((b, nb), dtype=torch.int32, device=dev)
    _build.check(lib.peapods_fk_finish(
        spins.data_ptr(), state.data_ptr(), parent.data_ptr(), _ptr(labels),
        j_fwd.data_ptr(), scalars.data_ptr(), _ptr(e_part), _ptr(m_part), b, b // d,
        *dims, int(wolff), 0, stream), "fk_finish")
    LAUNCHES["fk_finish"] += 1
    return e_part, m_part, labels


def fk_observe_plain(spins, j_fwd, temps, kb_words, uniforms=None):
    """Plain version of the observe form: the FK bond graphs of the spins,
    which stay as they are.  Returns the int32 labels ``[B, *shape]`` and
    the bool bond masks ``[B, n, n_dirs]``."""
    bonds = fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms)
    labels = fk_link_plain(bonds, tuple(spins.shape[1:]))
    return labels.reshape(spins.shape).to(torch.int32), bonds


def fk_observe(spins, j_fwd, temps, kb_words, *, uniforms=None):
    """FK observe (``cluster_action="observe"``) on the FK kernels' lattices
    (see :func:`fk_observe_plain`): ``fk_bonds``, ``fk_link`` and
    ``fk_finish`` in observe form, which writes the labels and leaves the
    spins alone; the masks are bits ``0 .. n_dirs - 1`` of the state
    bytes."""
    if _build.device_kind(spins) == "cpu":
        return fk_observe_plain(spins, j_fwd, temps, kb_words, uniforms)
    if uniforms is not None:
        raise ValueError("the FK kernels draw their own uniforms")
    lib, stream, state, parent, dims = _bonds_and_link(spins, j_fwd, temps, kb_words)
    b, d = spins.shape[0], j_fwd.shape[0]
    labels = torch.empty(spins.shape, dtype=torch.int32, device=spins.device)
    _build.check(lib.peapods_fk_finish(
        spins.data_ptr(), state.data_ptr(), parent.data_ptr(), labels.data_ptr(),
        j_fwd.data_ptr(), None, None, None, b, b // d, *dims, 0, 1, stream),
        "fk_finish")
    LAUNCHES["fk_finish"] += 1
    return labels, state_masks(state, j_fwd.shape[-1])


def fk_staged_plain(spins, j_fwd, temps, scalars, kb_words, lattice, *, wolff,
                    uniforms=None):
    """Plain version of the staged FK path on a lattice given by its offset
    table (the reference's ``fk_bond_activation -> _cc_many -> coin / Wolff
    flips``, peapods_tpu/engine/loop.py:1883-1976): the bonds along
    ``lattice.offsets``, their min-label components, and, unless
    ``scalars`` is ``None`` (observe), the flips in place.  Returns the
    int32 labels ``[B, n]`` and the bool masks ``[B, n, n_nb]``."""
    bonds = fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms, lattice.offsets)
    labels = connected_components(bonds, lattice.shape, lattice.offsets)
    if scalars is not None:
        fk_finish_plain(spins, labels, j_fwd, scalars, wolff=wolff, with_measure=False)
    return labels, bonds


def fk_staged(spins, j_fwd, temps, scalars, kb_words, lattice, *, wolff,
              with_masks=False, uniforms=None):
    """The staged FK path (see :func:`fk_staged_plain`): the plain version
    for CPU tensors; for CUDA tensors ``fk_bonds_nb``, ``csrc/cc.cu``'s
    ``cc_link`` and ``cc_label`` and, to update, ``fk_finish`` reading the
    roots from those labels.  Nothing is measured: the caller measures the
    spins after (``energy.measure_nb``).  The masks are returned when
    ``with_masks`` (else ``None``)."""
    if _build.device_kind(spins) == "cpu":
        labels, bonds = fk_staged_plain(spins, j_fwd, temps, scalars, kb_words,
                                        lattice, wolff=wolff, uniforms=uniforms)
        return labels, bonds if with_masks else None
    if uniforms is not None:
        raise ValueError("the FK kernels draw their own uniforms")
    if tuple(spins.shape[1:]) != tuple(lattice.shape):
        raise ValueError(f"spins of shape {tuple(spins.shape[1:])} on a "
                         f"{lattice.shape} lattice")
    b, n, d = _check_graphs(spins, j_fwd, temps, kb_words, scalars)
    if j_fwd.shape[-1] != lattice.n_neighbors:
        raise ValueError("the couplings do not match the lattice's offsets")
    dev = spins.device
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = torch.empty((b, n), dtype=torch.uint8, device=dev)
    parent = torch.empty((b, n), dtype=torch.int32, device=dev)
    labels = torch.empty((b, n), dtype=torch.int32, device=dev)
    _build.check(lib.peapods_fk_bonds_nb(
        spins.data_ptr(), j_fwd.data_ptr(), temps.data_ptr(), kb_words.data_ptr(),
        state.data_ptr(), parent.data_ptr(), lattice.kernel_geometry.ctypes.data, b,
        b // d, stream), "fk_bonds_nb")
    LAUNCHES["fk_bonds_nb"] += 1
    cc.launch(lib, stream, state.data_ptr(), parent.data_ptr(), labels.data_ptr(),
              lattice, b)
    if scalars is not None:
        _build.check(lib.peapods_fk_finish(
            spins.data_ptr(), state.data_ptr(), None, labels.data_ptr(),
            j_fwd.data_ptr(), scalars.data_ptr(), None, None, b, b // d,
            *_build.dims3(lattice.shape), 0, int(wolff), 0, stream), "fk_finish")
        LAUNCHES["fk_finish"] += 1
    return labels, state_masks(state, lattice.n_neighbors) if with_masks else None


# ------------------------------------------------------------- band forms


def _graph_couplings(j_win, n_graphs):
    """``[G, n_window, n_nb]`` couplings of every graph from ``[d,
    n_window, n_nb]``."""
    d = j_win.shape[0]
    return j_win[:, None].expand(d, n_graphs // d, *j_win.shape[1:]).reshape(
        n_graphs, *j_win.shape[1:])


def _window_shift(x, off, band):
    """``x [G, n_window]`` at each window site's neighbour at ``off``
    (periodic along the window's rows too: the caller masks the sites whose
    neighbour leaves the window)."""
    g = x.reshape(x.shape[0], *band.window_shape)
    nd = len(band.window_shape)
    return torch.roll(g, tuple(-int(o) for o in off), tuple(range(1, nd + 1))).reshape(
        x.shape)


def fk_bonds_band_plain(spins, j_win, temps, kb_words, cc_buf, band, uniforms=None):
    """Plain version of ``fk_bonds_band``: the FK bonds of every window site
    of a band whose forward neighbour lies in the window (bit ``k`` of the
    state byte; with three directions or fewer, bit ``3 + k`` when the two
    spins differ), drawn with the unsharded kernels' uniforms, into
    ``cc_buf.state``.

    Args:
        spins: int8 ``[G, n_window]`` the graphs' windows (halos current).
        j_win: f32 ``[d, n_window, n_nb]`` forward couplings of the window
            sites; graph ``b`` reads realization ``b // (G // d)``.
        temps: f32 ``[G]``.
        kb_words: int32 ``[G, 2]`` (unused when ``uniforms`` is given).
        cc_buf: the band's :class:`~.cc_band.BandCC`.
        uniforms: optional f32 ``[G, n_window, n_nb]``.
    """
    g, nw = spins.shape
    nb = band.lattice.n_neighbors
    dev = spins.device
    sites = torch.from_numpy(band.window_sites()).to(dev)
    u = uniforms if uniforms is not None else rng.bond_uniforms_at(kb_words, sites, nb)
    reach = torch.from_numpy(window_reach(band)).to(dev)
    s = spins.to(torch.float32)
    j = _graph_couplings(j_win, g)
    t = temps[:, None]
    st = torch.zeros((g, nw), dtype=torch.uint8, device=dev)
    for k, off in enumerate(band.lattice.offsets):
        sf = _window_shift(s, off, band)
        inter = s * sf * j[..., k]
        p = 1.0 - torch.exp(-2.0 * inter / t)
        bond = (inter > 0.0) & (u[..., k] < p) & reach[:, k]
        st |= bond.to(torch.uint8) << k
        if nb <= 3:
            st |= ((s != sf) & reach[:, k]).to(torch.uint8) << (3 + k)
    cc_buf.state.copy_(st)


def fk_bonds_band(spins, j_win, temps, kb_words, cc_buf, band, *, uniforms=None):
    """The FK bonds of a band (see :func:`fk_bonds_band_plain`): the plain
    version for CPU tensors, the ``fk_bonds_band`` kernel for CUDA
    tensors."""
    if _build.device_kind(spins) == "cpu":
        fk_bonds_band_plain(spins, j_win, temps, kb_words, cc_buf, band, uniforms)
        return
    if uniforms is not None:
        raise ValueError("the FK kernels draw their own uniforms")
    dev = spins.device
    g, d = _check_band(spins, j_win, band)
    _build.expect(temps, "temps", torch.float32, (g,), dev)
    _build.expect(kb_words, "kb_words", torch.int32, (g, 2), dev)
    _build.expect(cc_buf.state, "state", torch.uint8, (g, band.n_window), dev)
    _build.check(_build.library().peapods_fk_bonds_band(
        spins.data_ptr(), j_win.data_ptr(), temps.data_ptr(), kb_words.data_ptr(),
        cc_buf.state.data_ptr(), band.words.ctypes.data, g, g // d,
        torch.cuda.current_stream(dev).cuda_stream), "fk_bonds_band")
    LAUNCHES["fk_bonds_band"] += 1


def _check_band(spins, j_win, band):
    dev = spins.device
    g = spins.shape[0]
    d, nb = j_win.shape[0], band.lattice.n_neighbors
    if d == 0 or g % d:
        raise ValueError(f"{g} graphs do not split over {d} realizations")
    _build.expect(spins, "spins", torch.int8, (g, band.n_window), dev)
    _build.expect(j_win, "j_win", torch.float32, (d, band.n_window, nb), dev)
    if not 1 <= g <= 65535:
        raise ValueError("1 to 65535 graphs per band")
    return g, d


def wolff_seed_labels(ccs, bands, seeds):
    """int32 ``[G]``: the label of each graph's Wolff seed (global site
    ``seeds [G]``), read from the band that holds it, on the seeds'
    device."""
    dev = seeds.device
    seeds = seeds.to(torch.int64)
    out = None
    for cc_buf, band in zip(ccs, bands):
        lo = band.row0 * band.block
        mine = (seeds >= lo) & (seeds < lo + band.n_band)
        at = (seeds - lo).clamp(0, band.n_band - 1) + band.halo * band.block
        lab = cc_buf.labels.gather(1, at.to(cc_buf.labels.device)[:, None])[:, 0].to(dev)
        lab = torch.where(mine, lab, INT32_MAX)
        out = lab if out is None else torch.minimum(out, lab)
    return out.to(torch.int32)


def fk_finish_band_plain(spins, cc_buf, j_win, scalars, seed_labels, band, *, wolff,
                         measure):
    """Plain version of ``fk_finish_band``: flip the band's sites in place
    from the global labels (SW coin on the label, or Wolff: the label is
    the seed's) and, when ``measure``, return the post-update partials
    ``(e_part f32 [G, 1], m_part int32 [G, 1])`` of the band's sites, the
    forward neighbours across its edge flipped from the halo labels."""
    g = spins.shape[0]
    labels = cc_buf.labels
    if wolff:
        flip = labels == seed_labels[:, None]
    else:
        flip = cluster_coin_flip_mask(labels, scalars[:, :2])
    new = torch.where(flip, -spins, spins)
    inner = band.interior
    spins[:, inner] = new[:, inner]
    if not measure:
        return None, None
    sf = new.to(torch.float32)
    j = _graph_couplings(j_win, g)[:, inner]
    e = torch.zeros_like(sf[:, inner])
    for k, off in enumerate(band.lattice.offsets):
        e = e + sf[:, inner] * _window_shift(sf, off, band)[:, inner] * j[..., k]
    return (e.sum(-1, keepdim=True),
            new[:, inner].to(torch.int32).sum(-1, keepdim=True, dtype=torch.int32))


def fk_finish_band(spins, cc_buf, j_win, scalars, seed_labels, band, *, wolff,
                   measure):
    """The flips of a band (see :func:`fk_finish_band_plain`): the plain
    version for CPU tensors, the ``fk_finish_band`` kernel for CUDA
    tensors, whose partials have one entry per block of 256 sites of the
    band.  Measuring needs the "s differs" bits: three bond directions or
    fewer."""
    if _build.device_kind(spins) == "cpu":
        return fk_finish_band_plain(spins, cc_buf, j_win, scalars, seed_labels, band,
                                    wolff=wolff, measure=measure)
    dev = spins.device
    g, d = _check_band(spins, j_win, band)
    _build.expect(scalars, "scalars", torch.int32, (g, 3), dev)
    if wolff:
        _build.expect(seed_labels, "seed_labels", torch.int32, (g,), dev)
    if measure and band.lattice.n_neighbors > 3:
        raise ValueError("the band measurement reads at most three bond directions")
    lib = _build.library()
    parts = (None, None)
    if measure:
        nb = lib.peapods_fk_blocks(band.n_band)
        parts = (torch.empty((g, nb), dtype=torch.float32, device=dev),
                 torch.empty((g, nb), dtype=torch.int32, device=dev))
    _build.check(lib.peapods_fk_finish_band(
        spins.data_ptr(), cc_buf.state.data_ptr(), cc_buf.labels.data_ptr(),
        j_win.data_ptr(), scalars.data_ptr(),
        seed_labels.data_ptr() if wolff else None,
        *(None if t is None else t.data_ptr() for t in parts), band.words.ctypes.data,
        g, g // d, int(wolff), torch.cuda.current_stream(dev).cuda_stream),
        "fk_finish_band")
    LAUNCHES["fk_finish_band"] += 1
    return parts
