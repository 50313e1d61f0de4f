"""The cluster layer of the FK update, in plain torch.

Counterpart of ``peapods_tpu/ops/cluster.py`` for what SW and Wolff
updates need: FK bond activation (:555), connected components with the
minimum-site-index labels (:113; only the fixed point, none of the TPU's
scan devices), the per-cluster coin ``salted_uniform`` (:516), the SW and
Wolff flip masks (:537, :550), component counts and the cluster-size
histogram (:460, :466; a scatter-add count in place of the TPU's one-hot
matmul, which only worked around slow scatters there).  Every function takes a leading batch of graphs; a graph is the
``[H, W]`` square lattice with forward bonds (down, right) stored as
``[..., n_spins, 2]``.
"""

from __future__ import annotations

import torch

from .rng import MASK32, mul_lo32

__all__ = [
    "salted_uniform",
    "fk_bond_activation",
    "connected_components",
    "cluster_coin_flip_mask",
    "wolff_flip_mask",
    "component_counts",
    "csd_histogram",
]

_INV24 = 1.0 / (1 << 24)


def _fwd(x, shape, d):
    """``x [..., n_spins]`` read at every site's forward neighbour along
    ``d`` (0 down, 1 right), periodic."""
    h, w = shape
    g = x.reshape(*x.shape[:-1], h, w)
    return torch.roll(g, -1, dims=-2 + d).reshape(x.shape)


def _bwd(x, shape, d):
    h, w = shape
    g = x.reshape(*x.shape[:-1], h, w)
    return torch.roll(g, 1, dims=-2 + d).reshape(x.shape)


def salted_uniform(labels, salt0, salt1):
    """f32 murmur-style hash of ``(label, salt)`` to a 24-bit uniform,
    bitwise the reference's uint32 arithmetic (cluster.py:516-526).
    ``salt0`` / ``salt1`` broadcast against ``labels``."""
    x = (labels.to(torch.int64) & MASK32) ^ (salt0.to(torch.int64) & MASK32)
    x = mul_lo32(x ^ (x >> 16), 0x85EBCA6B)
    x = mul_lo32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16) ^ (salt1.to(torch.int64) & MASK32)
    x = mul_lo32(x ^ (x >> 16), 0x7FEB352D)
    x = mul_lo32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * _INV24


def fk_bond_activation(spins, coup_fwd, shape, temps, u):
    """bool ``[..., n_spins, 2]`` FK forward bonds (fk.rs:74,106-114).

    ``spins`` int8 ``[..., n_spins]``; ``coup_fwd`` f32 ``[..., n_spins,
    2]``; ``temps`` f32 ``[...]``; ``u`` f32 ``[..., n_spins, 2]``.  A bond
    is active iff ``inter = s * s_fwd * J > 0`` and ``u < 1 - exp(-2 *
    inter / T)``, in this operation order (the reference's).
    """
    s = spins.to(torch.float32)
    t = temps[..., None]
    bonds = []
    for d in range(2):
        inter = s * _fwd(s, shape, d) * coup_fwd[..., d]
        p = 1.0 - torch.exp(-2.0 * inter / t)
        bonds.append((inter > 0.0) & (u[..., d] < p))
    return torch.stack(bonds, dim=-1)


def connected_components(active_fwd, shape):
    """int32 ``[..., n_spins]`` labels of the bond graphs' components:
    every site gets the minimum site index of its component.

    Min-label propagation over the active bonds, with pointer jumping
    (``label[label]``: a label is a site of the same component with a
    smaller or equal index), until nothing changes.
    """
    n = active_fwd.shape[-2]
    lead = active_fwd.shape[:-2]
    big = torch.full((), n, dtype=torch.int64, device=active_fwd.device)
    fwd_on = [active_fwd[..., d] for d in range(2)]
    bwd_on = [_bwd(active_fwd[..., d], shape, d) for d in range(2)]
    lab = torch.arange(n, device=active_fwd.device).expand(*lead, n)
    while True:
        new = lab
        for d in range(2):
            new = torch.minimum(new, torch.where(fwd_on[d], _fwd(lab, shape, d), big))
            new = torch.minimum(new, torch.where(bwd_on[d], _bwd(lab, shape, d), big))
        new = new.gather(-1, new)
        if torch.equal(new, lab):
            return lab.to(torch.int32)
        lab = new


def cluster_coin_flip_mask(labels, salts):
    """SW: flip every cluster whose coin ``salted_uniform(label, salt) <
    1/2``; singletons too (fk.rs:153-162).  ``salts`` int32 ``[..., 2]``."""
    return salted_uniform(labels, salts[..., 0:1], salts[..., 1:2]) < 0.5


def wolff_flip_mask(labels, seed):
    """Wolff: the component of site ``seed`` (int ``[...]``)."""
    return labels == labels.gather(-1, seed.to(torch.int64)[..., None])


def _count(index, weights, n_bins):
    """int32 ``[B, n_bins]`` per-row histogram of ``index [B, m]``: a
    scatter-add, which (unlike ``torch.bincount`` on CUDA) needs no host
    synchronisation to size its output."""
    out = torch.zeros((index.shape[0], n_bins), dtype=torch.int32,
                      device=index.device)
    return out.scatter_add_(1, index.to(torch.int64), weights.to(torch.int32))


def component_counts(labels):
    """int32 ``[B, n_spins]``: ``counts[b, x]`` = size of graph ``b``'s
    component labelled ``x`` (0 elsewhere)."""
    return _count(labels, torch.ones_like(labels), labels.shape[1])


def csd_histogram(counts):
    """int32 ``[B, n_spins + 1]`` cluster-size histogram, ``hist[b, s]`` =
    number of clusters of size ``s`` (clusters/utils.rs:297-303)."""
    return _count(counts, counts > 0, counts.shape[1] + 1)
