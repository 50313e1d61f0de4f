"""The cluster layer of the FK update and the overlap moves, in plain
torch.

Counterpart of ``peapods_tpu/ops/cluster.py`` for what SW, Wolff and the
pair overlap moves need: FK bond activation (:555), connected components
with the minimum-site-index labels (:113; only the fixed point, none of the
TPU's scan devices), the per-cluster coin ``salted_uniform`` (:516), the SW
and Wolff flip masks (:537, :550), ``find_seed`` (:481) and
``nonsingleton_mask`` (:529), component counts and the cluster-size
histogram (:460, :466; a scatter-add count in place of the TPU's one-hot
matmul, which only worked around slow scatters there), and FK observe's
``top4_sizes`` (:475), ``graph_observation`` (:585) and ``winding_flags``
(:612, the plain version of ``csrc/winding.cu``).  Every function
takes a leading batch of graphs; a graph is a 2D ``[H, W]`` or 3D ``[L0,
L1, L2]`` periodic lattice with one forward bond per axis, or per offset of
``offsets`` (the triangular lattice's three, :func:`fk_offsets`), stored as
``[..., n_spins, n_bonds]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .lattice import GEOMETRY_OFFSETS, neighbour_values
from .rng import MASK32, mul_lo32

__all__ = [
    "fk_offsets",
    "salted_uniform",
    "fk_bond_activation",
    "connected_components",
    "cluster_coin_flip_mask",
    "wolff_flip_mask",
    "find_seed",
    "nonsingleton_mask",
    "component_counts",
    "csd_histogram",
    "top4_sizes",
    "GraphObservation",
    "graph_observation",
    "winding_flags",
]

_INV24 = 1.0 / (1 << 24)


def _fwd(x, shape, d):
    """``x [..., n_spins]`` read at every site's forward neighbour along
    axis ``d`` (2D: 0 down, 1 right), periodic."""
    g = x.reshape(*x.shape[:-1], *shape)
    return torch.roll(g, -1, dims=d - len(shape)).reshape(x.shape)


def _bwd(x, shape, d):
    g = x.reshape(*x.shape[:-1], *shape)
    return torch.roll(g, 1, dims=d - len(shape)).reshape(x.shape)


def fk_offsets(shape, n_dirs: int):
    """int64 ``[n_dirs, n_dims]`` forward bond offsets of an FK graph: one
    per axis, or the triangular lattice's three in 2D with three directions
    (``pallas_cc_batch.dir_shifts``, :105-120)."""
    nd = len(shape)
    if n_dirs == nd:
        return np.eye(nd, dtype=np.int64)
    if nd == 2 and n_dirs == 3:
        return np.asarray(GEOMETRY_OFFSETS["triangular"], dtype=np.int64)
    raise ValueError(f"no FK graph with {n_dirs} bond directions on a {nd}D lattice")


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


def fk_bond_activation(spins, coup_fwd, shape, temps, u, offsets=None):
    """bool ``[..., n_spins, n_bonds]`` FK forward bonds (fk.rs:74,106-114).

    ``spins`` int8 ``[..., n_spins]``; ``coup_fwd`` f32 ``[..., n_spins,
    n_bonds]``; ``temps`` f32 ``[...]``; ``u`` f32 ``[..., n_spins,
    n_bonds]``; ``offsets`` the bonds' forward offsets (one per axis when
    ``None``).  A bond is active iff ``inter = s * s_fwd * J > 0`` and ``u <
    1 - exp(-2 * inter / T)``, in this operation order (the reference's).
    """
    if offsets is None:
        offsets = np.eye(len(shape), dtype=np.int64)
    s = spins.to(torch.float32)
    t = temps[..., None]
    bonds = []
    for d, off in enumerate(offsets):
        inter = s * neighbour_values(s, shape, off) * coup_fwd[..., d]
        p = 1.0 - torch.exp(-2.0 * inter / t)
        bonds.append((inter > 0.0) & (u[..., d] < p))
    return torch.stack(bonds, dim=-1)


def connected_components(active_fwd, shape, offsets=None):
    """int32 ``[..., n_spins]`` labels of the bond graphs' components:
    every site gets the minimum site index of its component.  The bonds
    ``[..., n_spins, n_bonds]`` join each site to its neighbour at each of
    ``offsets`` (one per axis when ``None``).

    Min-label propagation over the active bonds, with pointer jumping
    (``label[label]``: a label is a site of the same component with a
    smaller or equal index), until nothing changes.
    """
    n = active_fwd.shape[-2]
    if offsets is None:
        offsets = np.eye(len(shape), dtype=np.int64)
    lead = active_fwd.shape[:-2]
    big = torch.full((), n, dtype=torch.int64, device=active_fwd.device)
    fwd_on = [active_fwd[..., d] for d in range(len(offsets))]
    bwd_on = [neighbour_values(active_fwd[..., d], shape, -off)
              for d, off in enumerate(offsets)]
    lab = torch.arange(n, device=active_fwd.device).expand(*lead, n)
    while True:
        new = lab
        for d, off in enumerate(offsets):
            new = torch.minimum(new, torch.where(
                fwd_on[d], neighbour_values(lab, shape, off), big))
            new = torch.minimum(new, torch.where(
                bwd_on[d], neighbour_values(lab, shape, -off), big))
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


def find_seed(probes, eligible):
    """The Wolff seed of the overlap moves (clusters/utils.rs:107-119): the
    first of the 64 probe sites (int ``[..., 64]``) that is eligible (bool
    ``[..., n_spins]``); ``n_spins`` when none is (the move is then a
    no-op).  int64 ``[...]``."""
    probes = probes.to(torch.int64)
    hits = eligible.gather(-1, probes)
    first = hits.to(torch.int8).argmax(-1, keepdim=True)  # first True
    seed = probes.gather(-1, first)[..., 0]
    return torch.where(hits.any(-1), seed, eligible.shape[-1])


def nonsingleton_mask(active_fwd, shape, offsets=None):
    """bool ``[..., n_spins]``: sites with any bond (own forward bonds or a
    backward neighbour's forward bond, the neighbour at ``-offset`` of each
    of ``offsets``, one per axis when ``None``), i.e. in a cluster of size
    > 1."""
    inc = active_fwd.any(-1)
    for d in range(active_fwd.shape[-1]):
        bwd = (_bwd(active_fwd[..., d], shape, d) if offsets is None
               else neighbour_values(active_fwd[..., d], shape, -offsets[d]))
        inc = inc | bwd
    return inc


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


def top4_sizes(counts):
    """int32 ``[B, 4]``: the four largest component sizes, descending, 0
    where a graph has fewer components (clusters/utils.rs:305-315)."""
    return counts.topk(4, dim=-1).values


class GraphObservation(NamedTuple):
    """The observables of a batch of bond graphs (clusters/utils.rs:317-325):
    ``top4`` int32 ``[B, 4]``, ``active_bonds`` and ``large_components``
    int32 ``[B]``, ``winding_x`` / ``winding_y`` bool ``[B]``."""

    top4: torch.Tensor
    active_bonds: torch.Tensor
    winding_x: torch.Tensor
    winding_y: torch.Tensor
    large_components: torch.Tensor


def graph_observation(active_fwd, counts, winding=None):
    """The graph observables (clusters/utils.rs:334-368) of bond masks
    ``[B, n_spins, n_bonds]`` with component counts ``[B, n_spins]``
    (:func:`component_counts`): the top-4 sizes, the active (site, offset)
    entries of the masks, the components of at least ``ceil(0.05 n)``
    sites, and the winding flags ``winding = (wx, wy)`` (all False when
    ``None``: lattices other than the canonical 2D square)."""
    n = counts.shape[-1]
    threshold = -(-n * 5 // 100)
    if winding is None:
        no = torch.zeros(counts.shape[:-1], dtype=torch.bool, device=counts.device)
        winding = (no, no)
    return GraphObservation(
        top4=top4_sizes(counts),
        active_bonds=active_fwd.sum((-2, -1), dtype=torch.int32),
        winding_x=winding[0],
        winding_y=winding[1],
        large_components=(counts >= threshold).sum(-1, dtype=torch.int32),
    )


def winding_flags(active_fwd, labels, shape):
    """bool ``(wx, wy) [B]``: does any component of each 2D square bond graph
    wrap the torus along axis 0 (x) / axis 1 (y) (cluster.py:612-677).

    The jnp settle loop: from each component's root (``labels == site``)
    an unwrapped displacement potential ``d`` is settled along the active
    bonds, one round at a time (a site settles from a neighbour settled in
    the previous round); a component winds along axis ``a`` iff an active
    bond has ``d[j] - d[i] != off[a]``.  Raises ``ValueError`` when a round
    settles nothing while sites remain unsettled: the labels do not belong
    to the masks.
    """
    n = active_fwd.shape[-2]
    dev = active_fwd.device
    offsets = np.eye(2, dtype=np.int64)
    settled = labels == torch.arange(n, device=dev, dtype=labels.dtype)
    disp = torch.zeros(labels.shape[:-1] + (2, n), dtype=torch.int32, device=dev)
    fwd_on = [active_fwd[..., d] for d in range(2)]
    bwd_on = [neighbour_values(active_fwd[..., d], shape, -off)
              for d, off in enumerate(offsets)]
    off_col = [torch.as_tensor(off, dtype=torch.int32, device=dev)[:, None]
               for off in offsets]
    while not bool(settled.all()):
        new_settled, new_disp = settled, disp
        for d, off in enumerate(offsets):
            ok = fwd_on[d] & neighbour_values(settled, shape, off) & ~new_settled
            cand = neighbour_values(disp, shape, off) - off_col[d]
            new_disp = torch.where(ok[..., None, :], cand, new_disp)
            new_settled = new_settled | ok
            ok = bwd_on[d] & neighbour_values(settled, shape, -off) & ~new_settled
            cand = neighbour_values(disp, shape, -off) + off_col[d]
            new_disp = torch.where(ok[..., None, :], cand, new_disp)
            new_settled = new_settled | ok
        if torch.equal(new_settled, settled):
            raise ValueError("winding: sites left unsettled, the labels do not "
                             "belong to the bond masks")
        settled, disp = new_settled, new_disp
    flags = []
    for axis in range(2):
        hit = torch.zeros(labels.shape[:-1], dtype=torch.bool, device=dev)
        for d, off in enumerate(offsets):
            x = disp[..., axis, :]
            viol = neighbour_values(x, shape, off) - x - int(off[axis])
            hit = hit | (fwd_on[d] & (viol != 0)).any(-1)
        flags.append(hit)
    return flags[0], flags[1]
