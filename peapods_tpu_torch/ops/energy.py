"""Per-system energy and magnetization, recomputed from the spins.

Counterpart of ``peapods_tpu/ops/energy.py``: the recompute oracle for the
fused measurement.  The reported "energy" keeps the reference's sign: the
positive forward-bond sum per spin, ``e = +sum_{i,d} J[i,d] s_i s_fwd / N``.
"""

from __future__ import annotations

import torch

__all__ = ["bond_sums", "energies_and_mags", "per_spin"]


def per_spin(total, n_spins: int):
    """``total / n_spins`` as an IEEE division on every device, as the
    kernels and the reference divide.  On CUDA, torch turns a division by a
    Python scalar into a multiplication by its reciprocal, which rounds
    differently unless ``n_spins`` is a power of two."""
    return total / torch.full_like(total, float(n_spins))


def bond_sums(spins, coup_fwd, shape):
    """f32 ``[...]`` forward-bond energy sums ``sum_{i,d} J s_i s_fwd`` of
    int8 spins ``[..., n_spins]`` on a 2D or 3D lattice ``shape``, with
    forward couplings ``[..., n_spins, n_dims]`` (broadcast against the
    spins' leading axes); the axes' sums are added in axis order."""
    shape = tuple(shape)
    nd = len(shape)
    s = spins.to(torch.float32).reshape(*spins.shape[:-1], *shape)
    tot = torch.zeros(spins.shape[:-1], dtype=torch.float32, device=s.device)
    spatial = tuple(range(-nd, 0))
    lead = coup_fwd.shape[:-2]
    for d in range(nd):
        fwd = torch.roll(s, -1, d - nd)  # s at the forward neighbour
        tot = tot + (s * fwd * coup_fwd[..., d].reshape(*lead, *shape)).sum(spatial)
    return tot


def energies_and_mags(spins, coup_fwd, shape):
    """``(e f32 [...], m int32 [...])`` of int8 spins ``[..., n_spins]``
    with forward couplings ``[n_spins, n_dims]`` on a 2D or 3D lattice."""
    m = spins.to(torch.int32).sum(-1, dtype=torch.int32)
    return per_spin(bond_sums(spins, coup_fwd, shape), spins.shape[-1]), m
