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
(counted in :data:`LAUNCHES`): ``fk_bonds`` (:func:`fk_bonds`, the state
bytes, a thread a group of four sites of :func:`bonds_per` graphs), the labelling
(:func:`launch_link`: ``fk_link``, and where :func:`link_plan` cuts a graph
into tiles ``fk_link_border`` and ``fk_link_flatten``) and ``fk_finish``;
it runs :func:`fk_update_plain` on CPU tensors.  Both update the spins in
place and return the same values: bond uniforms from Philox keyed by
``kb`` (``rng.bond_uniforms``), labels
equal to each component's minimum site index (on the card the labelling's
parents, each its site's root), and per-graph partial sums of the
post-update energy and magnetization (one partial per kernel block of 256
sites, :func:`block_partials_plain`; one per graph in the plain version).

:func:`fk_observe` is FK observe on those lattices: the same bonds and
labels (the parents, handed on: no flip launch, the spins untouched), and
the bond masks, bits of the kernels' state bytes.  :func:`fk_staged`
is the staged path of the lattices given by an offset table (BCC, FCC,
custom offsets): ``fk_bonds_staged`` (``fk_bonds``' body on the table's
whole lattice, :func:`launch_staged_bonds`) draws the bonds along each
offset, the connected-components kernels of :mod:`.cc` label them, and ``fk_finish``
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

import numpy as np
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
from .lattice import MAX_OFFSETS, check_tables, fast_divisor, neighbour_values, walk_tail

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
    "fk_bonds",
    "fk_bonds_plain",
    "fk_state_plain",
    "bonds_words",
    "resident_threads",
    "bonds_per",
    "TableBondsPlan",
    "table_bonds_plan",
    "launch_bonds",
    "launch_staged_bonds",
    "fk_link_plain",
    "fk_link_tiles_plain",
    "fk_link_flatten_plain",
    "tile_bonds",
    "fk_finish",
    "fk_finish_plain",
    "block_partials_plain",
    "finish_words",
    "finish_tile",
    "band_finish_tile",
    "fk_energy_mag",
    "launch_link",
    "launch_flatten",
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
LAUNCHES = {"fk_bonds": 0, "fk_bonds_staged": 0, "fk_bonds_table": 0, "fk_link": 0,
            "fk_link_border": 0, "fk_link_flatten": 0, "fk_finish": 0, "fk_bonds_band": 0,
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
    take the lattice's graphs: square, triangular or 3D cubic, with even
    extents.  The others (odd extents, 1D chains, BCC, FCC, offset tables,
    4D and up) take the staged path, :func:`fk_staged`."""
    return lattice.axes_form or lattice.triangular


def fk_energy_mag(e_part, m_part, n_spins: int):
    """``(e f32 [B], m int32 [B])`` from partials ``[B, blocks]``, added in
    order: the energy per spin and the magnetization sum."""
    return per_spin(e_part.sum(-1), n_spins), m_part.sum(-1, dtype=torch.int32)


def fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms=None, offsets=None):
    """Plain version of ``fk_bonds`` (and, given an offset table's
    ``offsets``, of ``fk_bonds_staged``): bool ``[B, n, n_dirs]`` FK bonds of
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


def fk_state_plain(spins, j_fwd, temps, kb_words, uniforms=None):
    """Plain version of ``fk_bonds``' state bytes: uint8 ``[B, n]``, bit
    ``k`` the FK bond of direction ``k`` (:func:`fk_bonds_plain`), bit ``3 +
    k`` where the site's spin and its forward neighbour's differ."""
    b, shape = spins.shape[0], tuple(spins.shape[1:])
    n_dirs = j_fwd.shape[-1]
    bonds = fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms)
    s = spins.reshape(b, -1)
    st = torch.zeros(s.shape, dtype=torch.uint8, device=s.device)
    for k, off in enumerate(fk_offsets(shape, n_dirs)):
        differs = s != neighbour_values(s, shape, off)
        st |= (bonds[..., k].to(torch.uint8) << k) | (differs.to(torch.uint8) << (3 + k))
    return st


# fk_bonds and fk_bonds_band (csrc/fk.cu bonds_body): a thread takes a group
# of four sites of `per` graphs of one realization and reads the group's
# couplings once for them; `per` is the realization's graphs, halved while a
# launch would have fewer threads than the card holds resident
# (resident_threads: the H100's 132 SMs x 2048), the other graphs then side
# by side, reading the couplings from L2.
@functools.lru_cache(maxsize=None)
def resident_threads(index: int) -> int:
    """The threads card ``index`` holds resident at once: its SMs times
    each SM's most resident threads."""
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count * p.max_threads_per_multi_processor


@functools.lru_cache(maxsize=None)
def bonds_per(n_sites: int, n_graphs: int, n_systems: int, threads: int) -> int:
    """The graphs a thread of ``fk_bonds`` / ``fk_bonds_band`` takes in
    turn: ``n_systems`` (a realization's graphs), halved while the launch of
    ``n_graphs`` graphs of ``n_sites`` sites would have fewer than
    ``threads`` threads (:func:`resident_threads` of the card); 1 where an
    odd count is still short."""
    groups = -(-int(n_sites) // 4)
    per = int(n_systems)
    while per % 2 == 0 and groups * (n_graphs // per) < threads:
        per //= 2
    return per if groups * (n_graphs // per) >= threads else 1


@functools.lru_cache(maxsize=None)
def bonds_words(shape, n_dirs: int):
    """int32 host words of ``fk_bonds`` (``csrc/band.cuh`` ``BandWalk``): the
    whole periodic lattice of ``shape`` as a window of all its rows with no
    halo, its bond directions' offsets (:func:`~.cluster.fk_offsets`), their
    residues and the multiply-shift divisors of ``L1 L2`` and ``L2``."""
    shape = tuple(int(x) for x in shape)
    dims = _build.dims3(shape)
    off = np.zeros((MAX_OFFSETS, 3), np.int64)
    off[:n_dirs, :len(shape)] = fk_offsets(shape, n_dirs)
    geometry = np.concatenate([dims, [n_dirs], off.reshape(-1)])
    words = np.concatenate([geometry, [dims[0], 0, 0, dims[0]], walk_tail(geometry)])
    return words.astype(np.uint32).view(np.int32)


def launch_bonds(lib, stream, spins, j_fwd, temps, kb_words, state):
    """One ``fk_bonds`` launch on checked CUDA tensors (not counted): the
    state bytes of every graph into ``state`` uint8 ``[B, n]``."""
    b, n = spins.shape[0], spins[0].numel()
    d, n_dirs = j_fwd.shape[0], j_fwd.shape[-1]
    words = bonds_words(tuple(spins.shape[1:]), n_dirs)
    _build.check(lib.peapods_fk_bonds(
        spins.data_ptr(), j_fwd.data_ptr(), temps.data_ptr(), kb_words.data_ptr(),
        state.data_ptr(), words.ctypes.data, b, b // d,
        bonds_per(n, b, b // d, resident_threads(spins.device.index)), stream),
        "fk_bonds")


# fk_bonds_table (csrc/fk.cu kTableMaxPer, kTableMaxSplit, kThreads): a
# thread takes a group of four sites of `per` graphs of one realization; a
# CTA 256 threads, or in the split form `split` warps over 32 groups of one
# graph, each warp a share of the offsets
TABLE_BONDS_MAX_PER = 8
TABLE_BONDS_MAX_SPLIT = 8
TABLE_BONDS_THREADS = 256


class TableBondsPlan(NamedTuple):
    """``fk_bonds_table``'s launch: the graphs a thread (``per``), the warps
    that share a group's offsets (``split``, 1: none), a CTA's threads and
    the grid ``(group blocks, n_systems / per, n_disorder)``."""

    per: int
    split: int
    threads: int
    grid: tuple


@functools.lru_cache(maxsize=None)
def table_bonds_plan(n_spins: int, n_neighbors: int, n_disorder: int, n_systems: int,
                     threads: int, sms: int) -> TableBondsPlan:
    """The table form's bonds of ``n_disorder`` x ``n_systems`` graphs of
    ``n_spins`` sites and ``n_neighbors`` offsets, from the shape alone: a
    thread a group of four sites of ``per`` graphs of one realization,
    reading the group's table rows and couplings once for them: the largest
    divisor of ``n_systems`` up to :data:`TABLE_BONDS_MAX_PER` whose launch
    still has ``threads`` threads (an eighth of the card's resident threads,
    as ``energy.table_measure_plan``) and at least ``sms`` CTAs; 1 where
    none has.  Where one graph a thread is still fewer than ``sms`` CTAs of
    256 threads, the split form: a CTA of ``split`` warps over 32 groups,
    each warp ``ceil(n_neighbors / split)`` of the offsets, ``split`` the
    least that gives the launch ``threads`` threads (at most
    :data:`TABLE_BONDS_MAX_SPLIT` and the offsets), taken down to the
    warps that hold offsets."""
    groups = -(-int(n_spins) // 4)
    blocks = -(-groups // TABLE_BONDS_THREADS)
    d, s, nb = int(n_disorder), int(n_systems), int(n_neighbors)
    fits = [p for p in range(1, min(s, TABLE_BONDS_MAX_PER) + 1)
            if s % p == 0 and groups * d * (s // p) >= threads and blocks * d * (s // p) >= sms]
    per = max(fits, default=1)
    if blocks * d * s >= sms or nb == 1:
        return TableBondsPlan(per, 1, TABLE_BONDS_THREADS, (blocks, s // per, d))
    split = min(nb, TABLE_BONDS_MAX_SPLIT, max(2, -(-threads // (groups * d * s))))
    split = -(-nb // -(-nb // split))  # the warps that hold offsets
    return TableBondsPlan(1, split, 32 * split, (-(-groups // 32), s, d))


def launch_staged_bonds(lib, stream, spins, j_fwd, temps, kb_words, state, lattice,
                        tables=None, plan=None):
    """One ``fk_bonds_staged`` launch on checked CUDA tensors (not counted):
    the bonds of every graph of ``lattice`` (an offset table's, 1 to 6
    offsets; its words :attr:`~.lattice.Lattice.sweep_words`) into ``state``
    uint8 ``[B, n]``, bit ``k`` the bond along offset ``k``; on a table
    lattice (:attr:`~.lattice.Lattice.table`, up to 32 offsets) the table
    form ``fk_bonds_table``, into int32 ``[B, n]``, on its checked device
    ``tables`` (the forward table 16-byte aligned) and ``plan`` (default
    :func:`table_bonds_plan`'s)."""
    b, n = spins.shape[0], lattice.n_spins
    d = j_fwd.shape[0]
    if lattice.table:
        fwd, _ = tables
        if fwd.data_ptr() % 16:
            raise ValueError("the forward table must be 16-byte aligned")
        dev = spins.device
        plan = plan or table_bonds_plan(
            n, lattice.n_neighbors, d, b // d, resident_threads(dev.index) // 8,
            torch.cuda.get_device_properties(dev.index).multi_processor_count)
        _build.check(lib.peapods_fk_bonds_table(
            spins.data_ptr(), j_fwd.data_ptr(), temps.data_ptr(), kb_words.data_ptr(),
            state.data_ptr(), fwd.data_ptr(), n, lattice.n_neighbors, b, b // d, plan.per,
            plan.split, stream),
            "fk_bonds_table")
        return
    _build.check(lib.peapods_fk_bonds_staged(
        spins.data_ptr(), j_fwd.data_ptr(), temps.data_ptr(), kb_words.data_ptr(),
        state.data_ptr(), lattice.sweep_words.ctypes.data, b, b // d,
        bonds_per(n, b, b // d, resident_threads(spins.device.index)), stream),
        "fk_bonds_staged")


def fk_bonds(spins, j_fwd, temps, kb_words):
    """The state bytes of every graph (see :func:`fk_state_plain`): the
    plain version for CPU tensors, the ``fk_bonds`` kernel for CUDA tensors
    (2 or 3 bond directions)."""
    if _build.device_kind(spins) == "cpu":
        return fk_state_plain(spins, j_fwd, temps, kb_words)
    fk_offsets(tuple(spins.shape[1:]), j_fwd.shape[-1])  # raises for a graph it does not take
    b, n, _ = _check_graphs(spins, j_fwd, temps, kb_words)
    state = torch.empty((b, n), dtype=torch.uint8, device=spins.device)
    launch_bonds(_build.library(), torch.cuda.current_stream(spins.device).cuda_stream,
                 spins, j_fwd, temps, kb_words, state)
    LAUNCHES["fk_bonds"] += 1
    return state


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
    ``[B, n]`` (or the table form's int32 words): bits ``0 .. n_dirs -
    1``."""
    bits = torch.arange(n_dirs, device=state.device, dtype=state.dtype)
    return ((state[..., None] >> bits) & 1).to(torch.bool)


def fk_finish_plain(spins, labels, j_fwd, scalars, *, wolff, with_measure, blocks=False):
    """Plain version of ``fk_finish``: flip the clusters in place (SW coin
    or Wolff seed) and, when ``with_measure``, return the post-update
    partials ``(e_part f32, m_part int32)``: ``[B, 1]``, or with ``blocks``
    the kernel's ``[B, fk_blocks(n)]``, one a block of 256 sites added in
    its pairing (:func:`block_partials_plain`)."""
    b, shape = spins.shape[0], tuple(spins.shape[1:])
    d, n, n_dirs = j_fwd.shape
    labels = labels.reshape(b, n)
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
    e, m = e.reshape(b, n), new.to(torch.int32)
    if blocks:
        return block_partials_plain(e), block_partials_plain(m)
    return e.sum(-1, keepdim=True), m.sum(-1, keepdim=True, dtype=torch.int32)


def block_partials_plain(x, per_thread: int = 1):
    """``[..., ceil(n / (256 per_thread))]`` sums of ``x [..., n]`` over
    blocks of 256 threads of ``per_thread`` consecutive sites each (the
    last block padded with zeros): a thread's sites added in order from 0,
    the threads' sums paired as ``csrc/mega.cuh`` ``block_partials`` and
    ``warp_tree`` pair them: ``x[t] += x[t + off]`` for ``off = 128 .. 1``."""
    n = x.shape[-1]
    block = 256 * per_thread
    nb = (n + block - 1) // block
    t = torch.nn.functional.pad(x, (0, nb * block - n)).reshape(*x.shape[:-1], nb, 256,
                                                              per_thread)
    acc = torch.zeros_like(t[..., 0])
    for k in range(per_thread):
        acc = acc + t[..., k]
    off = 128
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    return acc[..., 0]


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
    launch_flatten(lib, stream, p_parent, n_graphs, l0 * l1 * l2)


def launch_flatten(lib, stream, p_parent, n_graphs, n):
    """Launch ``fk_link_flatten`` on raw pointers: every parent of
    ``n_graphs`` graphs of ``n`` sites pointed at its root.  The tiled
    labellings end with it (:func:`launch_link`, ``cc.launch``)."""
    _build.check(lib.peapods_fk_link_flatten(p_parent, n_graphs, n, stream),
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
    """Check the arguments, then launch ``fk_bonds`` and the labelling:
    ``(state, parent)``, every parent its site's root."""
    dev = spins.device
    shape = tuple(spins.shape[1:])
    if scalars is not None:
        _build.expect(scalars, "scalars", torch.int32, (spins.shape[0], 3), dev)
    state = fk_bonds(spins, j_fwd, temps, kb_words)
    b, n = state.shape
    parent = torch.empty((b, n), dtype=torch.int32, device=dev)
    launch_link(_build.library(), torch.cuda.current_stream(dev).cuda_stream,
                state.data_ptr(), parent.data_ptr(), b, *_build.dims3(shape),
                len(shape) == 2 and j_fwd.shape[-1] == 3)
    return state, parent


# fk_finish and fk_finish_band (csrc/fk.cu kMaxFinishParts): a CTA takes up
# to FINISH_PARTS partial blocks of 256 sites, fewer until a launch has
# FINISH_CTAS CTAs (a count tuned by measurement, not read from the card:
# one wave of the H100's 256-thread CTAs is 1056), but not
# fewer than stage the farthest forward neighbour a tile can reach
# (finish_tile, the one rule of both forms).  Below that floor every site
# draws that neighbour's coin again: 32^3 x 16 takes four blocks a CTA, a
# plane, where 1024 CTAs of two ran 13% slower; 128^3 in 4 bands, whose
# plane no tile reaches, keeps 1024 CTAs, where 512 ran 13% slower (NVIDIA
# H100: tools/probe_finish_winding.py --ctas, chip_smoke.py).
FINISH_PARTS = 32
FINISH_CTAS = 1024


@functools.lru_cache(maxsize=None)
def finish_tile(n_sites: int, reaches: tuple, n_graphs: int):
    """``(parts, ext)`` of an ``fk_finish`` or ``fk_finish_band`` CTA on
    ``n_graphs`` graphs (or bands) of ``n_sites`` sites: its partial blocks
    of 256 sites, halved from :data:`FINISH_PARTS` while the launch has
    fewer than :data:`FINISH_CTAS` CTAs and the tile still holds the
    farthest forward neighbour that a tile of :data:`FINISH_PARTS` blocks
    holds, and the sites whose flips it stages: its ``parts * 256`` and the
    farthest forward neighbour within that tile (``reaches``: each bond
    direction's distance in site index)."""
    n_blk = -(-int(n_sites) // 256)
    far = max([0] + [f for f in reaches if f <= FINISH_PARTS * 256])
    parts = FINISH_PARTS
    while (parts > 1 and (parts // 2) * 256 >= far
           and -(-n_blk // parts) * n_graphs < FINISH_CTAS):
        parts //= 2
    tile = parts * 256
    return parts, tile + max([0] + [f for f in reaches if f <= tile])


def band_finish_tile(band, n_graphs: int):
    """:func:`finish_tile` of ``fk_finish_band`` on ``n_graphs`` graphs of
    ``band``: its interior sites, each offset's distance in window index."""
    geo = band.lattice.kernel_geometry
    l2, n_nb = int(geo[2]), int(geo[3])
    off = geo[4:4 + 3 * n_nb].tolist()
    reaches = tuple(off[3 * d] * band.block + off[3 * d + 1] * l2 + off[3 * d + 2]
                    for d in range(n_nb))
    return finish_tile(band.n_band, reaches, n_graphs)


def finish_offsets(dims, n_dirs: int, tri: bool):
    """The forward neighbours' distances in site index of each bond
    direction of a ``dims = (l0, l1, l2)`` lattice, unwrapped: ``l1 l2``
    along axis 0, ``l2`` along axis 1, 1 along axis 2, ``l1 l2 - 1`` along
    the triangular lattice's ``[1, -1]``."""
    _, l1, l2 = dims
    return [(l1 * l2, l2, l1 * l2 - 1 if tri else 1)[k] for k in range(n_dirs)]


@functools.lru_cache(maxsize=None)
def finish_words(dims, n_dirs: int, tri: bool, n_graphs: int):
    """int32 host words of ``fk_finish`` (``csrc/fk.cu`` ``FinishWalk``):
    ``dims = (l0, l1, l2)``, the bond directions it measures (0: none), the
    triangular flag, the CTA's partial blocks ``parts`` and the sites it
    stages ``ext`` (:func:`finish_tile`), then ``n // (l1 l2)`` and ``n //
    l2`` as :func:`~.lattice.fast_divisor` pairs."""
    dims = tuple(int(x) for x in dims)
    parts, ext = finish_tile(math.prod(dims), tuple(finish_offsets(dims, n_dirs, tri)),
                             n_graphs)
    div = [x for d in (dims[1] * dims[2], dims[2]) for x in fast_divisor(d)]
    words = np.array([*dims, n_dirs, int(tri), parts, ext, *div], np.int64)
    return words.astype(np.uint32).view(np.int32)


def fk_finish(spins, state, labels, j_fwd, scalars, *, wolff, with_measure):
    """The flips of every graph from its labels, in place (see
    :func:`fk_finish_plain`): the plain version for CPU tensors, the
    ``fk_finish`` kernel for CUDA tensors, whose partials have one entry per
    block of 256 sites.  ``labels`` int32 ``[B, n]`` hold each site's root
    (``fk_link``'s parents or the CC labels); ``state`` the kernels' state
    bytes ``[B, n]``, read only when measuring (the "s differs" bits: the
    square, triangular and cubic lattices)."""
    b, shape = spins.shape[0], tuple(spins.shape[1:])
    if _build.device_kind(spins) == "cpu":
        return fk_finish_plain(spins, labels, j_fwd, scalars, wolff=wolff,
                               with_measure=with_measure)
    dev = spins.device
    d, n, n_dirs = j_fwd.shape
    tri = len(shape) == 2 and n_dirs == 3
    if with_measure:
        fk_offsets(shape, n_dirs)  # raises for a lattice the measurement does not take
    _build.expect(labels, "labels", torch.int32, (b, n), dev)
    _build.expect(scalars, "scalars", torch.int32, (b, 3), dev)
    lib = _build.library()
    parts = (None, None)
    if with_measure:
        _build.expect(state, "state", torch.uint8, (b, n), dev)
        nb = lib.peapods_fk_blocks(n)
        parts = (torch.empty((b, nb), dtype=torch.float32, device=dev),
                 torch.empty((b, nb), dtype=torch.int32, device=dev))
    words = finish_words(_build.dims3(shape), n_dirs if with_measure else 0, tri, b)
    _build.check(lib.peapods_fk_finish(
        spins.data_ptr(), _ptr(state) if with_measure else None, labels.data_ptr(),
        j_fwd.data_ptr(), scalars.data_ptr(), *map(_ptr, parts), words.ctypes.data, b,
        b // d, int(wolff), torch.cuda.current_stream(dev).cuda_stream), "fk_finish")
    LAUNCHES["fk_finish"] += 1
    return parts


def fk_update(spins, j_fwd, temps, scalars, kb_words, *, wolff, with_measure,
              with_labels, uniforms=None):
    """One FK update of every graph (see :func:`fk_update_plain`): the plain
    version for CPU tensors, the ``fk_bonds``, ``fk_link`` and
    ``fk_finish`` kernels for CUDA tensors (2 or 3 bond directions, see the
    module docstring).  The kernel partials have one entry per block of 256
    sites; the labels are the labelling's parents, each its site's root.
    ``uniforms`` (CPU only) are the bond uniforms of ``kb_words`` drawn
    ahead by the caller."""
    kw = dict(wolff=wolff, with_measure=with_measure, with_labels=with_labels)
    if _build.device_kind(spins) == "cpu":
        return fk_update_plain(spins, j_fwd, temps, scalars, kb_words,
                               uniforms=uniforms, **kw)
    if uniforms is not None:
        raise ValueError("the FK kernels draw their own uniforms")
    state, parent = _bonds_and_link(spins, j_fwd, temps, kb_words, scalars)
    e_part, m_part = fk_finish(spins, state, parent, j_fwd, scalars, wolff=wolff,
                               with_measure=with_measure)
    return e_part, m_part, parent.view(spins.shape) if with_labels else None


def fk_observe_plain(spins, j_fwd, temps, kb_words, uniforms=None):
    """Plain version of the observe form: the FK bond graphs of the spins,
    which stay as they are.  Returns the int32 labels ``[B, *shape]`` and
    the bool bond masks ``[B, n, n_dirs]``."""
    bonds = fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms)
    labels = fk_link_plain(bonds, tuple(spins.shape[1:]))
    return labels.reshape(spins.shape).to(torch.int32), bonds


def fk_observe(spins, j_fwd, temps, kb_words, *, uniforms=None):
    """FK observe (``cluster_action="observe"``) on the FK kernels' lattices
    (see :func:`fk_observe_plain`): ``fk_bonds`` and ``fk_link``, whose
    parents, each its site's root, are the labels (no flip: the spins stay
    as they are); the masks are bits ``0 .. n_dirs - 1`` of the state
    bytes."""
    if _build.device_kind(spins) == "cpu":
        return fk_observe_plain(spins, j_fwd, temps, kb_words, uniforms)
    if uniforms is not None:
        raise ValueError("the FK kernels draw their own uniforms")
    state, parent = _bonds_and_link(spins, j_fwd, temps, kb_words)
    return parent.view(spins.shape), state_masks(state, j_fwd.shape[-1])


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
              with_masks=False, uniforms=None, tables=None):
    """The staged FK path (see :func:`fk_staged_plain`): the plain version
    for CPU tensors; for CUDA tensors ``fk_bonds_staged`` (the state bytes:
    the bonds alone, bits ``0 .. n_nb - 1``), the labelling of
    :func:`.cc.launch` (``cc_link``; where its boxes split a graph,
    ``cc_link_border`` and ``fk_link_flatten``) and, to update,
    ``fk_finish`` reading the roots from those labels.  A table lattice
    (:attr:`~.lattice.Lattice.table`) takes the table forms: the bonds in an
    int32 word a site (``fk_bonds_table``), the table labelling
    (``cc.table_link_launches``: ``cc_table_link``, and past one cluster's
    shared memory ``cc_table_border`` and ``fk_link_flatten``), and
    ``fk_finish`` on the graphs
    seen as ``[B, 1, n]`` (its words hold three extents; it measures
    nothing here), reading the neighbours from the device ``tables``
    (:func:`~.lattice.check_tables`).  Nothing is measured: the caller
    measures the spins after (``energy.measure_nb``).  The masks are
    returned when ``with_masks`` (else ``None``)."""
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
    if lattice.table:
        check_tables(tables, lattice, dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = torch.empty((b, n), dtype=torch.int32 if lattice.table else torch.uint8,
                        device=dev)
    labels = torch.empty((b, n), dtype=torch.int32, device=dev)
    launch_staged_bonds(lib, stream, spins, j_fwd, temps, kb_words, state, lattice, tables)
    LAUNCHES["fk_bonds_table" if lattice.table else "fk_bonds_staged"] += 1
    cc.launch(lib, stream, state.data_ptr(), labels.data_ptr(), lattice, b, tables)
    if scalars is not None:
        flat = spins.view(b, 1, n) if lattice.table else spins
        fk_finish(flat, None, labels, j_fwd, scalars, wolff=wolff, with_measure=False)
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
        bonds_per(band.n_window, g, g // d, resident_threads(dev.index)),
        torch.cuda.current_stream(dev).cuda_stream),
        "fk_bonds_band")
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
        g, g // d, int(wolff), *band_finish_tile(band, g),
        torch.cuda.current_stream(dev).cuda_stream), "fk_finish_band")
    LAUNCHES["fk_finish_band"] += 1
    return parts
