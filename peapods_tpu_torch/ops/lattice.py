"""The 2D square periodic lattice of the port's slice.

Counterpart of ``Lattice`` in ``peapods_tpu/ops/lattice.py``, restricted to what
the mega path reads: sites in row-major order, two forward bonds per site
(``[1, 0]`` down, ``[0, 1]`` right), couplings stored as ``[n_spins, 2]``
forward bonds (reference layout), and the two-colour checkerboard.  Even
extents keep the checkerboard proper across the periodic boundary.
"""

from __future__ import annotations

import numpy as np

from ..engine.config import not_ported

__all__ = ["Lattice", "OFFSETS"]

OFFSETS = np.array([[1, 0], [0, 1]], dtype=np.int64)


class Lattice:
    """2D square periodic lattice with even extents."""

    def __init__(self, shape):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            not_ported(f"a {len(shape)}D lattice", "4a")
        if any(s < 2 or s % 2 for s in shape):
            not_ported(f"lattice extents {list(shape)} (odd or < 2)", "4a")
        self.shape = shape
        self.n_dims = 2
        self.n_neighbors = 2
        self.n_spins = shape[0] * shape[1]
        self.offsets = OFFSETS
