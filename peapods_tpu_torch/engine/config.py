"""Simulation configuration of the slice: the fields the mega path reads.

Counterpart of :mod:`peapods_tpu.engine.config`, with the same parse
helpers and error strings for the options the port runs today.  Options
the port does not run yet raise ``NotImplementedError`` through
:func:`not_ported`, naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "SWEEP_MODES",
    "PT_SCHEDULES",
    "SimConfig",
    "parse_sweep_mode",
    "parse_pt_schedule",
    "not_ported",
]

SWEEP_MODES = ("metropolis", "gibbs")
PT_SCHEDULES = ("single_random_edge", "full_ladder")

# ROADMAP.md, queue 1 ("Modules to port"): the item that brings each option
_ROADMAP_ITEMS = {
    "4a": "item 4a, the per-sweep path for other lattices",
    "4b": "item 4b, autocorrelation and the equilibration diagnostic",
    "4c": "item 4c, checkpoints",
    "6": "item 6, the cluster layer",
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


def parse_pt_schedule(s: str) -> str:
    if s not in PT_SCHEDULES:
        raise ValueError(
            f"unknown pt_schedule '{s}', expected 'single_random_edge' or 'full_ladder'"
        )
    return s


@dataclass(frozen=True)
class SimConfig:
    """The slice's subset of the reference config (config.rs:249-263)."""

    n_sweeps: int
    warmup_sweeps: int = 0
    sweep_mode: str = "metropolis"
    pt_interval: int | None = None
    pt_schedule: str = "single_random_edge"

    def validate(self) -> None:
        if self.n_sweeps < 1:
            raise ValueError("n_sweeps must be >= 1")
        if self.warmup_sweeps > self.n_sweeps:
            raise ValueError("warmup_sweeps must be <= n_sweeps")
        if self.pt_interval is not None and self.pt_interval == 0:
            raise ValueError("pt_interval must be >= 1")
