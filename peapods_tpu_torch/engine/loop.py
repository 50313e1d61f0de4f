"""Device constants and the chunk runner of the mega path.

Counterpart of ``Runtime`` and ``LoopProgram._mega_chunk_runner`` in
``peapods_tpu/engine/loop.py`` (:125-471, :2960-3135).  For each chunk the
host computes every sweep's key words with the numpy threefry
(:func:`~peapods_tpu_torch.engine.seeds.sweep_words`) and uploads them in
one copy; :func:`~peapods_tpu_torch.ops.mega.mega_chunk` then launches the
kernels sweep after sweep with no host synchronisation, and the per-sweep
``(e, m)`` rows are folded into the record sums on the device.

The reference's sentinel padding of short chunks and its ``n_inner <= 256``
SMEM cap exist only to keep one compiled TPU program per chunk length; a
chunk here is as long as it needs to be.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import mega
from ..ops.lattice import Lattice
from ..ops.sweep import pack_coupling_grids
from ..ops.tempering import hot_cold_slots
from . import seeds
from .config import SimConfig
from .records import N_REC, REC

__all__ = ["Runtime", "init_accumulators", "run_chunk"]


@dataclass
class Runtime:
    """Device-resident constants for one model instance."""

    lattice: Lattice
    n_replicas: int
    n_temps: int
    n_disorder: int
    device: torch.device
    temps_np: np.ndarray  # f32 [n_temps]
    temps: torch.Tensor  # f32 [n_temps]
    jgrids: torch.Tensor  # f32 [n_disorder, 4, H, W]

    @classmethod
    def build(cls, lattice, couplings_nd, temps, n_replicas, device):
        """couplings_nd: f32 ``[n_disorder, n_spins, 2]`` (numpy)."""
        coup = torch.as_tensor(np.asarray(couplings_nd, np.float32), device=device)
        temps_np = np.asarray(temps, dtype=np.float32)
        return cls(
            lattice=lattice,
            n_replicas=int(n_replicas),
            n_temps=len(temps_np),
            n_disorder=int(coup.shape[0]),
            device=device,
            temps_np=temps_np,
            temps=torch.as_tensor(temps_np, device=device),
            jgrids=pack_coupling_grids(coup, lattice.shape).contiguous(),
        )

    @property
    def n_spins(self):
        return self.lattice.n_spins

    @property
    def n_systems(self):
        return self.n_replicas * self.n_temps

    @property
    def hot_slot(self):
        return hot_cold_slots(self.temps_np)[0]

    @property
    def cold_slot(self):
        return hot_cold_slots(self.temps_np)[1]


def init_accumulators(rt: Runtime) -> dict:
    """Record sums per (realization, record row, temperature).

    They accumulate on the device in float64, where the reference keeps
    Kahan-compensated f32 pairs (peapods_tpu/engine/loop.py:99-104) only
    because the TPU has no f64.
    """
    return {
        "rec_sums": torch.zeros((rt.n_disorder, N_REC, rt.n_temps),
                                dtype=torch.float64, device=rt.device),
        "n_recorded": 0,
    }


def _upload(words: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(words))
    if device.type == "cuda":
        # pinned + non_blocking: the copy is ordered on the stream and the
        # host does not wait for it
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def run_chunk(rt: Runtime, cfg: SimConfig, state: dict, acc: dict,
              s_begin: int, n: int) -> None:
    """Run sweeps ``s_begin .. s_begin + n - 1`` of a sample() call,
    updating ``state`` and ``acc`` in place."""
    pt_on = cfg.pt_interval is not None and rt.n_temps >= 2
    d, n_slots = rt.n_disorder, rt.n_systems
    counter = int(state["counter"])
    sweep_w = _upload(
        seeds.sweep_words(state["base_keys"], counter, n, seeds.PH_SWEEP),
        rt.device,
    )
    pt_w = (
        _upload(seeds.sweep_words(state["base_keys"], counter, n, seeds.PH_PT),
                rt.device)
        if pt_on else torch.zeros((n, d, 2), dtype=torch.int32, device=rt.device)
    )
    h, w = rt.lattice.shape
    e, m, parity = mega.mega_chunk(
        state["spins"].view(d, n_slots, h, w),
        rt.jgrids,
        rt.temps,
        state["system_ids"].view(d, n_slots),
        state["pt_edge_attempts"],
        state["pt_edge_acceptances"],
        state["pt_round_trips"],
        state["pt_trip_state"],
        sweep_w,
        pt_w,
        sweep_base=s_begin,
        parity=int(state["pt_parity"]),
        gibbs=cfg.sweep_mode == "gibbs",
        pt_interval=cfg.pt_interval if pt_on else None,
        pt_full=cfg.pt_schedule == "full_ladder",
        hot_slot=rt.hot_slot,
        cold_slot=rt.cold_slot,
    )
    state["counter"] = np.int32(counter + n)
    state["pt_parity"] = np.int32(parity)

    # records of the sweeps past warmup (slot == temperature, R == 1)
    lo = max(0, int(state["warmup"]) - s_begin)
    if lo < n:
        m_rt = m[:, lo:].to(torch.float64) / rt.n_spins  # [d, k, T]
        e_rt = e[:, lo:].to(torch.float64)
        m2 = m_rt * m_rt
        sums = acc["rec_sums"]
        sums[:, REC["m_sum"]] += m_rt.sum(1)
        sums[:, REC["m2_sum"]] += m2.sum(1)
        sums[:, REC["m4_sum"]] += (m2 * m2).sum(1)
        sums[:, REC["e_sum"]] += e_rt.sum(1)
        sums[:, REC["e2_sum"]] += (e_rt * e_rt).sum(1)
        acc["n_recorded"] += n - lo
