"""Simulation configuration of the slice: the fields the mega path and the
per-sweep (cluster) path read.

Counterpart of ``peapods_tpu/engine/config.py``, with the same parse
helpers, validation and error strings for the options the port runs today.
Options the port does not run yet raise ``NotImplementedError`` through
:func:`not_ported`, naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "SWEEP_MODES",
    "PT_SCHEDULES",
    "CLUSTER_MODES",
    "CLUSTER_ACTIONS",
    "ClusterUpdate",
    "SimConfig",
    "parse_sweep_mode",
    "parse_pt_schedule",
    "parse_cluster_mode",
    "parse_cluster_action",
    "not_ported",
]

SWEEP_MODES = ("metropolis", "gibbs")
PT_SCHEDULES = ("single_random_edge", "full_ladder")
CLUSTER_MODES = ("wolff", "sw")
CLUSTER_ACTIONS = ("update", "observe")

# ROADMAP.md, queue 1 ("Modules to port"): the item that brings each option
_ROADMAP_ITEMS = {
    "4a": "item 4a, the per-sweep path for other lattices",
    "4b": "item 4b, autocorrelation and the equilibration diagnostic",
    "4c": "item 4c, checkpoints",
    "6": "item 6, the cluster layer",
    "6o": "item 6, the cluster layer's observe mode",
    "7": "item 7, replicas and overlap moves",
    "9": "item 9, multi-GPU",
}


def not_ported(what: str, item: str):
    """Raise ``NotImplementedError`` for a configuration outside the slice."""
    raise NotImplementedError(
        f"{what} is not ported to peapods_tpu_torch yet: see ROADMAP.md, "
        f"queue 1, {_ROADMAP_ITEMS[item]}"
    )


def parse_sweep_mode(s: str) -> str:
    if s not in SWEEP_MODES:
        raise ValueError(f"unknown sweep_mode '{s}', expected 'metropolis' or 'gibbs'")
    return s


def parse_cluster_mode(s: str) -> str:
    if s not in CLUSTER_MODES:
        raise ValueError(f"unknown cluster_mode '{s}', expected 'wolff' or 'sw'")
    return s


def parse_cluster_action(s: str) -> str:
    if s not in CLUSTER_ACTIONS:
        raise ValueError(f"unknown cluster action '{s}', expected 'update' or 'observe'")
    return s


def parse_pt_schedule(s: str) -> str:
    if s not in PT_SCHEDULES:
        raise ValueError(
            f"unknown pt_schedule '{s}', expected 'single_random_edge' or 'full_ladder'"
        )
    return s


@dataclass(frozen=True)
class ClusterUpdate:
    """The FK cluster phase (the reference's ``ClusterConfig``): every
    ``interval`` sweeps, an SW or Wolff update of every system."""

    interval: int
    mode: str = "sw"  # "wolff" | "sw"
    action: str = "update"  # "update" | "observe"
    collect_stats: bool = False


@dataclass(frozen=True)
class SimConfig:
    """The slice's subset of the reference config (config.rs:249-263)."""

    n_sweeps: int
    warmup_sweeps: int = 0
    sweep_mode: str = "metropolis"
    cluster_update: ClusterUpdate | None = None
    pt_interval: int | None = None
    pt_schedule: str = "single_random_edge"

    def validate(self) -> None:
        """Cross-field validation, mirroring config.rs:180-247."""
        if self.n_sweeps < 1:
            raise ValueError("n_sweeps must be >= 1")
        if self.warmup_sweeps > self.n_sweeps:
            raise ValueError("warmup_sweeps must be <= n_sweeps")
        c = self.cluster_update
        if c is not None:
            if c.interval < 1:
                raise ValueError("cluster_update interval must be >= 1")
            if c.action == "observe" and c.mode == "wolff":
                raise ValueError("cluster_action='observe' requires cluster_mode='sw'")
        if self.pt_interval is not None and self.pt_interval == 0:
            raise ValueError("pt_interval must be >= 1")
