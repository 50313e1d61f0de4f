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
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.config import not_ported

__all__ = ["GEOMETRY_OFFSETS", "MAX_OFFSETS", "Lattice", "hypercubic_offsets",
           "neighbour_values"]

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
        strides = np.cumprod((1,) + shape[:0:-1])[::-1]
        coords = (np.arange(self.n_spins)[:, None] // strides) % shape

        def table(sign):
            c = (coords[:, None, :] + sign * self.offsets[None]) % shape
            return (c * strides).sum(-1).astype(np.int32)

        self.fwd, self.bwd = table(1), table(-1)
        if self.hypercubic:
            self.colors = (coords.sum(1) % 2).astype(np.int32)
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
