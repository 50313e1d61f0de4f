"""The hypercubic periodic lattices of the port: 2D square and 3D cubic.

Counterpart of ``Lattice`` in ``peapods_tpu/ops/lattice.py``, restricted to the
hypercubic lattices the port runs: sites in row-major order, one forward
bond per axis (axis ``d`` + 1: ``[1, 0]`` down and ``[0, 1]`` right in 2D),
couplings stored as ``[n_spins, n_dims]`` forward bonds (reference layout),
and the two-colour checkerboard ``sum(coords) & 1``.  Even extents keep the
checkerboard proper across the periodic boundary.
"""

from __future__ import annotations

import numpy as np

from ..engine.config import not_ported

__all__ = ["Lattice"]


class Lattice:
    """2D square or 3D cubic periodic lattice with even extents."""

    def __init__(self, shape):
        shape = tuple(int(s) for s in shape)
        if len(shape) not in (2, 3):
            not_ported(f"a {len(shape)}D lattice", "4a")
        if any(s < 2 or s % 2 for s in shape):
            not_ported(f"lattice extents {list(shape)} (odd or < 2)", "4a")
        self.shape = shape
        self.n_dims = len(shape)
        self.n_neighbors = self.n_dims
        self.n_spins = int(np.prod(shape))
        self.offsets = np.eye(self.n_dims, dtype=np.int64)
