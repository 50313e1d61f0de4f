"""Slot <-> system maps of the per-sweep path.

Counterpart of ``slot_temps_for_systems`` and ``per_slot_values`` in
``peapods_tpu/ops/measure.py`` (:18-33), batched over realizations:
``system_ids`` is int32 ``[d, n_slots]`` (one replica, so a slot is a
temperature).
"""

from __future__ import annotations

import torch

__all__ = ["slot_temps_for_systems", "per_slot_values"]


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
