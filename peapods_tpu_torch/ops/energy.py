"""Per-system energy and magnetization, recomputed from the spins.

Counterpart of ``peapods_tpu/ops/energy.py``: the recompute oracle for the
fused measurement.  The reported "energy" keeps the reference's sign: the
positive forward-bond sum per spin, ``e = +sum_{i,d} J[i,d] s_i s_fwd / N``.
"""

from __future__ import annotations

import torch

__all__ = ["energies_and_mags", "per_spin"]


def per_spin(total, n_spins: int):
    """``total / n_spins`` as an IEEE division on every device, as the
    kernels and the reference divide.  On CUDA, torch turns a division by a
    Python scalar into a multiplication by its reciprocal, which rounds
    differently unless ``n_spins`` is a power of two."""
    return total / torch.full_like(total, float(n_spins))


def energies_and_mags(spins, coup_fwd, shape):
    """``(e f32 [...], m int32 [...])`` of int8 spins ``[..., n_spins]``
    with forward couplings ``[n_spins, 2]``."""
    h, w = shape
    s = spins.to(torch.float32).reshape(*spins.shape[:-1], h, w)
    tot = torch.zeros(spins.shape[:-1], dtype=torch.float32, device=s.device)
    for dim, j in ((-2, coup_fwd[:, 0]), (-1, coup_fwd[:, 1])):
        fwd = torch.roll(s, -1, dim)  # s at the forward neighbour
        tot = tot + (s * fwd * j.reshape(h, w)).sum((-2, -1))
    m = spins.to(torch.int32).sum(-1, dtype=torch.int32)
    return per_spin(tot, h * w), m
