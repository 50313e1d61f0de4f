"""Slot <-> system maps and the pair overlaps.

Counterpart of ``slot_temps_for_systems``, ``per_slot_values`` and
``overlap_dots`` in ``peapods_tpu/ops/measure.py`` (:18-53), batched over
realizations: ``system_ids`` is int32 ``[d, n_slots]``, slot ``r T + t``
being replica ``r`` at temperature ``t``.
"""

from __future__ import annotations

import torch

__all__ = ["slot_temps_for_systems", "per_slot_values", "overlap_dots"]


def slot_temps_for_systems(system_ids, temps):
    """f32 ``[d, n_systems]``: the temperature each system sits at."""
    d, n = system_ids.shape
    out = torch.empty((d, n), dtype=temps.dtype, device=temps.device)
    return out.scatter_(1, system_ids.long(), temps.expand(d, n))


def per_slot_values(values_by_system, system_ids):
    """Gather ``[d, n_systems, ...]`` values into slot order ``[d, n_slots,
    ...]``."""
    idx = system_ids.long()
    idx = idx.reshape(idx.shape + (1,) * (values_by_system.dim() - 2))
    return values_by_system.gather(1, idx.expand(
        idx.shape[:2] + values_by_system.shape[2:]))


def overlap_dots(spins, system_ids, shape, n_replicas: int, offsets=None):
    """Spin and link overlap dot products of every replica pair ``(2p,
    2p+1)`` at every temperature (overlap.rs:251-333): ``q_i = a_i b_i``,
    ``qs = sum_i q_i`` and ``ql = sum_i q_i sum_o q_{i + o}`` over the
    forward neighbours (the reference's ``geom.neighbor_sum_fwd``).

    Args:
        spins: int8 ``[d, n_systems, n_spins]`` by system.
        system_ids: int32 ``[d, n_slots]`` (``n_slots = R T``).
        shape: the lattice extents (2D or 3D).
        offsets: the forward offsets ``[n_nb, n_dims]`` (the axes when
            ``None``).

    Returns:
        ``(qs, ql)``, each int32 ``[d, n_pairs, T]``.
    """
    shape = tuple(shape)
    nd = len(shape)
    d = spins.shape[0]
    n_pairs = n_replicas // 2
    sid = system_ids.to(torch.int64).reshape(d, n_replicas, -1)
    di = torch.arange(d, device=spins.device)[:, None, None]
    a = spins[di, sid[:, 0:2 * n_pairs:2]].to(torch.int32)
    b = spins[di, sid[:, 1:2 * n_pairs:2]].to(torch.int32)
    q = (a * b).reshape(*a.shape[:-1], *shape)
    spatial = tuple(range(-nd, 0))
    if offsets is None:
        offsets = torch.eye(nd, dtype=torch.int64)
    nbr = sum(torch.roll(q, tuple(-int(o) for o in off), spatial) for off in offsets)
    return (q.sum(spatial, dtype=torch.int32),
            (q * nbr).sum(spatial, dtype=torch.int32))
