"""Periodic Bravais lattices of the port: neighbour tables and the greedy
site colouring.

Counterpart of ``Lattice`` in ``peapods_tpu/ops/lattice.py`` (:26-175) for
the lattices the port runs: 2D and 3D, with even extents, and at most six
forward offsets (the named geometries ``GEOMETRY_OFFSETS`` or any offset
table; one forward bond per axis when none is given).  Sites are in
row-major order, couplings are stored as ``[n_spins, n_neighbors]`` forward
bonds (reference layout), and ``fwd`` / ``bwd`` are the int32 tables of the
neighbour at ``+offset`` / ``-offset`` with each axis wrapped on its own
(``rem_euclid``).

The colouring is the reference's, site for site, because the per-sweep
path's site schedule is the colouring: the checkerboard ``sum(coords) & 1``
on hypercubic lattices (all extents are even), otherwise the greedy pass in
site order, each site taking the smallest colour unused by its forward and
backward neighbours of smaller index, self-bonds ignored.

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

__all__ = ["GEOMETRY_OFFSETS", "MAX_OFFSETS", "Lattice", "Band", "BandGeometry",
           "hypercubic_offsets", "neighbour_values", "fast_divisor", "walk_tail"]

# named geometries (peapods_tpu/ops/lattice.py:26-31)
GEOMETRY_OFFSETS = {
    "triangular": [[1, 0], [0, 1], [1, -1]],
    "tri": [[1, 0], [0, 1], [1, -1]],
    "fcc": [[1, 1, 0], [1, 0, 1], [0, 1, 1], [1, -1, 0], [1, 0, -1], [0, 1, -1]],
    "bcc": [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1]],
}

# forward offsets the sweep kernel takes (csrc/sweep_nb.cu kMaxOffsets)
MAX_OFFSETS = 6

_TRI = [[1, 0], [0, 1], [1, -1]]


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
    """2D or 3D periodic lattice with even extents: neighbour tables and the
    site colouring of the per-sweep path."""

    def __init__(self, shape, offsets=None):
        shape = tuple(int(s) for s in shape)
        n_dims = len(shape)
        if n_dims not in (2, 3):
            not_ported(f"a {n_dims}D lattice", "4a")
        if any(s < 2 or s % 2 for s in shape):
            not_ported(f"lattice extents {list(shape)} (odd or < 2)", "4a")
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
        if not 1 <= len(offsets) <= MAX_OFFSETS:
            not_ported(f"{len(offsets)} neighbour offsets (1 to {MAX_OFFSETS} run)",
                       "4a")
        self.shape = shape
        self.n_dims = n_dims
        self.n_neighbors = len(offsets)
        self.n_spins = int(np.prod(shape))
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.hypercubic = offsets == hypercubic_offsets(n_dims)
        # 2D with the triangular offsets: the FK kernels' third direction
        self.triangular = offsets == _TRI
        if self.hypercubic:
            self.colors = (np.indices(shape).sum(0) % 2).reshape(-1).astype(np.int32)
        else:
            self.colors = _greedy_colours(self.fwd, self.bwd)
        self.n_colors = int(self.colors.max()) + 1
        # csrc/sweep_nb.cu's geometry words: L0, L1, L2 (L2 = 1 in 2D), the
        # number of offsets, six zero-padded offsets of three components
        off = np.zeros((MAX_OFFSETS, 3), np.int32)
        off[:self.n_neighbors, :n_dims] = self.offsets
        self.kernel_geometry = np.concatenate(
            [shape + (1,) * (3 - n_dims), [self.n_neighbors], off.reshape(-1)]
        ).astype(np.int32)

    @cached_property
    def sweep_words(self) -> np.ndarray:
        """int32 host words of ``csrc/sweep_nb.cu`` ``sweep_nb`` (a
        ``csrc/band.cuh`` ``BandWalk``): the whole periodic lattice as a
        window of all its rows with no halo, each offset's axis-0 component
        reduced into ``[0, L0)`` (the kernel wraps axis 0 with one compare),
        then :func:`walk_tail`'s residues and divisors."""
        geometry = self.kernel_geometry.astype(np.int64)
        L0 = int(geometry[0])
        geometry[4::3] %= L0
        words = np.concatenate([geometry, [L0, 0, 0, L0], walk_tail(geometry)])
        return words.astype(np.uint32).view(np.int32)

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
        """2D with one forward bond per axis: the mega path's and
        ``sweep_2d``'s lattice."""
        return self.hypercubic and self.n_dims == 2

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
