"""Periodic Bravais lattices of the port: neighbour tables and the greedy
site colouring.

Counterpart of ``Lattice`` in ``peapods_tpu/ops/lattice.py`` (:26-175) for
every lattice the reference runs: any dimension, any extents >= 1, and up
to :data:`MAX_TABLE_OFFSETS` forward offsets (the named geometries
``GEOMETRY_OFFSETS`` or any offset table; one forward bond per axis when
none is given).  Sites are in row-major order, couplings are stored as
``[n_spins, n_neighbors]`` forward bonds (reference layout), and ``fwd`` /
``bwd`` are the int32 tables of the neighbour at ``+offset`` / ``-offset``
with each axis wrapped on its own (``rem_euclid``).

The colouring is the reference's, site for site, because the per-sweep
path's site schedule is the colouring: the checkerboard ``sum(coords) & 1``
on hypercubic lattices whose extents are all even, otherwise the greedy
pass in site order, each site taking the smallest colour unused by its
forward and backward neighbours of smaller index, self-bonds ignored.

The kernels take a lattice in one of two forms.  The walk form
(:attr:`Lattice.kernel_geometry`, ``csrc/nb.cuh`` and ``csrc/band.cuh``)
holds three extents and :data:`MAX_OFFSETS` offsets, and finds neighbours
from residues; a 1D lattice ``(L,)`` is presented to it as the 2D lattice
``[1, L]`` with offsets ``[0, o]`` (:attr:`Lattice.kernel_shape`,
:attr:`Lattice.kernel_offsets`: the same site order, and no axis-0
component).  The table form (:attr:`Lattice.table`: four dimensions or
more, or more than six offsets) reads the int32 ``fwd`` / ``bwd`` tables
from device memory: :meth:`Lattice.device_tables` builds them on a device,
once a run (``engine.loop.Runtime.tables``), and the table form's wrappers
take them as ``tables``.

An offset that is 0 modulo every extent joins each site to itself (an axis
of extent 1 makes one): :attr:`Lattice.self_bonds`.  Its bond counts in the
energy, as the reference's does, but never in the local field, where the
reference's ``_roll`` adds ``2 J s_i`` that a flip cannot change (a
departure by design, ROADMAP.md section 3).

:class:`BandGeometry` splits a lattice into contiguous row bands along its
leading axis (the ``space`` mesh axis): each band holds its rows plus ``m =
max |offset[0]|`` halo rows on each side, the window that its kernels
read.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..engine.config import not_ported

__all__ = ["GEOMETRY_OFFSETS", "MAX_OFFSETS", "MAX_TABLE_OFFSETS", "Lattice", "Band",
           "BandGeometry",
           "check_tables", "hypercubic_offsets", "neighbour_values", "fast_divisor",
           "walk_tail"]

# named geometries (peapods_tpu/ops/lattice.py:26-31)
GEOMETRY_OFFSETS = {
    "triangular": [[1, 0], [0, 1], [1, -1]],
    "tri": [[1, 0], [0, 1], [1, -1]],
    "fcc": [[1, 1, 0], [1, 0, 1], [0, 1, 1], [1, -1, 0], [1, 0, -1], [0, 1, -1]],
    "bcc": [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1]],
}

# forward offsets of the kernels' walk form (csrc/nb.cuh kMaxOffsets)
MAX_OFFSETS = 6
# forward offsets of the table form (csrc/sweep_nb.cu kMaxTableOffsets: a
# 32-bit word of bonds a site, ops/fk.py fk_staged)
MAX_TABLE_OFFSETS = 32

_TRI = [[1, 0], [0, 1], [1, -1]]


def check_tables(tables, lattice, device):
    """``tables``, the table form's int32 ``(fwd, bwd)`` ``[n_spins,
    n_neighbors]`` on ``device`` (:meth:`Lattice.device_tables`), checked:
    a table lattice's wrappers read their neighbours from them."""
    from . import _build

    if tables is None:
        raise ValueError(f"a {lattice.n_dims}D lattice of {lattice.n_neighbors} offsets "
                         "takes the table form: pass tables=lattice.device_tables(device)")
    for t, name in zip(tables, ("fwd", "bwd")):
        _build.expect(t, name, torch.int32, (lattice.n_spins, lattice.n_neighbors), device)
    return tables


def hypercubic_offsets(n_dims: int) -> list[list[int]]:
    """Unit vectors along each axis."""
    return np.eye(n_dims, dtype=np.int64).tolist()


def neighbour_values(x, shape, off):
    """``x [..., n_spins]`` read at every site's neighbour at offset ``off``
    (periodic): a roll of the grid, as the reference's ``GridOps`` shifts."""
    nd = len(shape)
    g = x.reshape(*x.shape[:-1], *shape)
    g = torch.roll(g, tuple(-int(o) for o in off), tuple(range(-nd, 0)))
    return g.reshape(x.shape)


def fast_divisor(d: int) -> tuple[int, int]:
    """``(m, s)`` with ``n // d == (n * m >> 32) >> s`` for ``0 <= n <
    2**31``: ``m = ceil(2**(31 + l) / d)``, ``s = l - 1``, ``l = ceil(log2
    d)`` (Granlund and Montgomery; CUTLASS's ``FastDivmod``), ``m < 2**32``;
    ``(0, 0)`` for ``d = 1``, whose quotient is ``n``."""
    if d < 1:
        raise ValueError(f"divisor {d} < 1")
    if d == 1:
        return 0, 0
    lg = (d - 1).bit_length()
    return (2 ** (31 + lg) + d - 1) // d, lg - 1


def walk_tail(geometry):
    """int64 words that follow a window's ``make_band_geom`` words
    (``csrc/band.cuh`` ``make_band_walk``) of a lattice with
    ``kernel_geometry`` words ``geometry``: per offset ``d`` the residues
    ``off[d][1] % L1, off[d][2] % L2, -off[d][1] % L1, -off[d][2] % L2``,
    then :func:`fast_divisor` ``(m, s)`` of ``L1 L2``, ``L2`` and ``L1 //
    2``."""
    _, L1, L2 = (int(x) for x in geometry[:3])
    off = np.asarray(geometry[4:], np.int64).reshape(-1, 3)
    res = np.stack([off[:, 1] % L1, off[:, 2] % L2, -off[:, 1] % L1, -off[:, 2] % L2], 1)
    div = [fast_divisor(x) for x in (L1 * L2, L2, max(L1 // 2, 1))]
    return np.concatenate([res.reshape(-1), np.asarray(div, np.int64).reshape(-1)])


def _greedy_colours(fwd, bwd):
    """int32 colours of the greedy pass in site order: each site takes the
    smallest colour that no neighbour of smaller index holds."""
    n = fwd.shape[0]
    nbrs = np.concatenate([fwd, bwd], axis=1)
    earlier = [row[row < i].tolist() for i, row in enumerate(nbrs)]
    colours = [0] * n
    for i, nb in enumerate(earlier):
        used = 0
        for j in nb:
            used |= 1 << colours[j]
        c = 0
        while used >> c & 1:
            c += 1
        colours[i] = c
    return np.asarray(colours, dtype=np.int32)


class Lattice:
    """Periodic lattice of any dimension and extents >= 1: neighbour tables,
    the site colouring of the per-sweep path and the kernels' words."""

    def __init__(self, shape, offsets=None):
        shape = tuple(int(s) for s in shape)
        n_dims = len(shape)
        if n_dims < 1 or any(s < 1 for s in shape):
            raise ValueError(f"lattice extents {list(shape)} must be >= 1")
        # built without explicit offsets: the reference's canonical lattice,
        # whose 2D form reports winding (peapods_tpu/ops/lattice.py:57-92)
        self.canonical = offsets is None
        if offsets is None:
            offsets = hypercubic_offsets(n_dims)
        offsets = [[int(x) for x in off] for off in offsets]
        for idx, off in enumerate(offsets):
            if len(off) != n_dims:
                raise ValueError(
                    f"offset {idx} has length {len(off)}, expected {n_dims}")
        if not 1 <= len(offsets) <= MAX_TABLE_OFFSETS:
            not_ported(f"{len(offsets)} neighbour offsets (1 to {MAX_TABLE_OFFSETS} run)",
                       "4a")
        self.shape = shape
        self.n_dims = n_dims
        self.n_neighbors = len(offsets)
        self.n_spins = int(np.prod(shape))
        self.offsets = np.asarray(offsets, dtype=np.int64)
        even = all(s % 2 == 0 for s in shape)
        # the offsets are the axes (the reference's _is_hypercubic)
        self.hypercubic = offsets == hypercubic_offsets(n_dims)
        # the two-colour checkerboard: hypercubic with every extent even
        # (peapods_tpu/ops/lattice.py:130-133)
        self.checkerboard = self.hypercubic and even
        # 2D with the triangular offsets and even extents: the FK kernels'
        # third direction
        self.triangular = offsets == _TRI and even
        # offsets that join each site to itself (0 modulo every extent)
        self.self_bonds = (self.offsets % np.asarray(shape) == 0).all(1)
        # the kernels' table form: more than the walk words hold
        self.table = n_dims > 3 or self.n_neighbors > MAX_OFFSETS
        if self.checkerboard:
            self.colors = (np.indices(shape).sum(0) % 2).reshape(-1).astype(np.int32)
        else:
            self.colors = _greedy_colours(self.fwd, self.bwd)
        self.n_colors = int(self.colors.max()) + 1
        self.kernel_geometry = None
        if not self.table:
            # csrc/nb.cuh's geometry words of kernel_shape: L0, L1, L2 (L2 =
            # 1 in 2D), the number of offsets, six zero-padded offsets of
            # three components
            kshape = self.kernel_shape
            off = np.zeros((MAX_OFFSETS, 3), np.int32)
            off[:self.n_neighbors, :len(kshape)] = self.kernel_offsets
            self.kernel_geometry = np.concatenate(
                [kshape + (1,) * (3 - len(kshape)), [self.n_neighbors], off.reshape(-1)]
            ).astype(np.int32)

    @property
    def kernel_shape(self) -> tuple:
        """The extents the walk-form kernels take: a 1D lattice ``(L,)`` as
        ``(1, L)``, any other as it is."""
        return (1,) + self.shape if self.n_dims == 1 else self.shape

    @property
    def kernel_offsets(self) -> np.ndarray:
        """int64 ``[n_neighbors, len(kernel_shape)]``: a 1D lattice's offsets
        ``[o]`` as ``[0, o]``, any other's as they are."""
        if self.n_dims == 1:
            return np.concatenate([np.zeros_like(self.offsets), self.offsets], 1)
        return self.offsets

    @property
    def self_mask(self) -> int:
        """:attr:`self_bonds` as bits: bit ``d`` for a self offset ``d``."""
        return int(sum(1 << d for d, x in enumerate(self.self_bonds) if x))

    @cached_property
    def sweep_words(self) -> np.ndarray:
        """int32 host words of ``csrc/sweep_nb.cu`` ``sweep_nb`` (a
        ``csrc/band.cuh`` ``BandWalk``): the whole periodic lattice as a
        window of all its rows with no halo, each offset's axis-0 component
        reduced into ``[0, L0)`` (the kernel wraps axis 0 with one compare),
        then :func:`walk_tail`'s residues and divisors.  A self offset is
        the one whose reduced axis-0 component and residues are all 0."""
        if self.table:
            raise ValueError(f"a {self.n_dims}D lattice of {self.n_neighbors} offsets "
                             "takes the table form")
        geometry = self.kernel_geometry.astype(np.int64)
        L0 = int(geometry[0])
        geometry[4::3] %= L0
        words = np.concatenate([geometry, [L0, 0, 0, L0], walk_tail(geometry)])
        return words.astype(np.uint32).view(np.int32)

    @cached_property
    def colour_sites(self) -> tuple:
        """``(sites, starts)``: int32 ``[n_spins]``, every site sorted by
        colour (index order within a colour), and ``[n_colors + 1]`` the
        first entry of each colour's run: ``sweep_nb_table``'s per-colour
        lists (a thread a site of the pass's colour)."""
        sites = np.argsort(self.colors, kind="stable").astype(np.int32)
        starts = np.searchsorted(self.colors[sites], np.arange(self.n_colors + 1))
        return sites, starts.astype(np.int64)

    def device_colour_sites(self, device):
        """:attr:`colour_sites`' sites on ``device``, copied there once and
        kept with the lattice."""
        cache = self.__dict__.setdefault("_device_colour_sites", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = torch.from_numpy(self.colour_sites[0]).to(device)
        return cache[key]

    def device_tables(self, device):
        """int32 ``(fwd, bwd)`` ``[n_spins, n_neighbors]`` copied to
        ``device``: the table form's neighbours, which its wrappers take as
        ``tables`` (:func:`check_tables`)."""
        return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                     for t in (self.fwd, self.bwd))

    def _table(self, sign):
        shape = self.shape
        strides = np.cumprod((1,) + shape[:0:-1])[::-1]
        coords = (np.arange(self.n_spins)[:, None] // strides) % shape
        c = (coords[:, None, :] + sign * self.offsets[None]) % shape
        return (c * strides).sum(-1).astype(np.int32)

    @cached_property
    def fwd(self) -> np.ndarray:
        """int32 ``[n_spins, n_neighbors]``: the neighbour at ``+offset``
        (built at first use: a lattice of millions of sites needs it only
        on the greedy-coloured lattices)."""
        return self._table(1)

    @cached_property
    def bwd(self) -> np.ndarray:
        """int32 ``[n_spins, n_neighbors]``: the neighbour at ``-offset``."""
        return self._table(-1)

    @property
    def square(self) -> bool:
        """The 2D checkerboard (one forward bond per axis, even extents): the
        mega path's and ``sweep_2d``'s lattice."""
        return self.checkerboard and self.n_dims == 2

    @property
    def axes_form(self) -> bool:
        """The square or cubic checkerboard: the lattices of the kernels'
        axes forms (the coupling grids, the replica megakernel, the FK
        kernels' two and three directions, ``energy_partials``, the overlap
        moves' own form, ``fk_link``'s labelling)."""
        return self.checkerboard and self.n_dims in (2, 3)

    @property
    def canonical_square(self) -> bool:
        """A 2D lattice built without explicit offsets: the one whose FK
        observations carry the winding flags (the reference's
        ``canonical_square_shape``)."""
        return self.canonical and self.n_dims == 2

    def color_masks(self) -> np.ndarray:
        """``bool [n_colors, n_spins]`` one mask per colour."""
        return self.colors[None, :] == np.arange(self.n_colors)[:, None]


@dataclass(frozen=True)
class Band:
    """Row band ``k`` of a lattice: interior rows ``row0 .. row0 + hl - 1``
    held in a window of ``rows = hl + 2 halo`` rows whose first and last
    ``halo`` rows are copies of the neighbouring bands' edge rows (global
    rows ``row0 - halo ..`` and ``row0 + hl ..``, periodic).  A window
    index is ``window_row * block + rest``; ``words`` are the kernels'
    geometry words (``csrc/band.cuh`` ``make_band_geom``): the window's
    ``kernel_geometry``, ``L0, row0, halo, hl``, then per offset ``d``
    the residues ``off[d][1] % L1, off[d][2] % L2, -off[d][1] % L1,
    -off[d][2] % L2``, then :func:`fast_divisor` ``(m, s)`` of ``L1 L2``,
    ``L2`` and ``L1 // 2``."""

    lattice: Lattice
    k: int
    row0: int
    hl: int
    halo: int
    block: int
    words: np.ndarray

    @property
    def rows(self) -> int:
        return self.hl + 2 * self.halo

    @property
    def n_window(self) -> int:
        return self.rows * self.block

    @property
    def n_band(self) -> int:
        return self.hl * self.block

    @property
    def interior(self) -> slice:
        """The band's own sites in a window's last axis."""
        return slice(self.halo * self.block, (self.halo + self.hl) * self.block)

    @property
    def window_shape(self) -> tuple:
        return (self.rows,) + tuple(self.lattice.shape[1:])

    def window_sites(self):
        """int64 ``[n_window]`` global site index of every window site."""
        L0 = self.lattice.shape[0]
        rows = (self.row0 - self.halo + np.arange(self.rows)) % L0
        return (rows[:, None] * self.block + np.arange(self.block)).reshape(-1)

    def band_sites(self):
        """int64 ``[n_band]`` global site index of every interior site."""
        return self.row0 * self.block + np.arange(self.n_band)


class BandGeometry:
    """A lattice split into ``n_shards`` row bands of ``hl = L0 /
    n_shards`` rows along its leading axis, with halos of ``m = max
    |offset[0]|`` rows (the reference's ``halo_gen_meta``,
    peapods_tpu/ops/pallas_sweep_diag.py:629-652: 1 on the square, cubic,
    triangular, BCC and FCC lattices)."""

    def __init__(self, lattice: Lattice, n_shards: int):
        L0 = lattice.shape[0]
        n_shards = int(n_shards)
        if n_shards < 1 or L0 % n_shards:
            raise ValueError(f"lattice extent {L0} does not divide over the "
                             f"{n_shards}-way 'space' mesh axis")
        hl = L0 // n_shards
        halo = int(np.abs(lattice.offsets[:, 0]).max())
        if hl < halo:
            raise ValueError(f"bands of {hl} rows are thinner than the halo of "
                             f"{halo} rows that the offsets reach")
        self.lattice = lattice
        self.n_shards = n_shards
        self.hl = hl
        self.halo = halo
        self.block = lattice.n_spins // L0
        self.bands = []
        tail = walk_tail(lattice.kernel_geometry)
        for k in range(n_shards):
            words = lattice.kernel_geometry.copy()
            words[0] = hl + 2 * halo
            words = np.concatenate([words, [L0, k * hl, halo, hl], tail])
            words = words.astype(np.uint32).view(np.int32)
            self.bands.append(Band(lattice, k, k * hl, hl, halo, self.block, words))
