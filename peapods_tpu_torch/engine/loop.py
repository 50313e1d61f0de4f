"""Device constants and the chunk runners: the mega path and the per-sweep
(cluster) path.

Counterpart of ``Runtime``, ``LoopProgram._mega_chunk_runner`` and the
per-sweep ``_make_step_body`` in ``peapods_tpu/engine/loop.py`` (:125-471,
:2960-3135, :2708-2954).  For each chunk the host computes every sweep's
key words (and the FK phase's scalars and the PT draws) with the numpy
threefry (:mod:`~peapods_tpu_torch.engine.seeds`) and uploads them in one
copy; the kernels then run sweep after sweep with no host synchronisation,
and the per-sweep ``(e, m)`` rows are folded into the record sums on the
device.  :func:`run_chunk` takes the mega path unless the run has a cluster
phase.

The reference's sentinel padding of short chunks and its ``n_inner <= 256``
SMEM cap exist only to keep one compiled TPU program per chunk length; a
chunk here is as long as it needs to be.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import fk, mega, rng
from ..ops.cluster import component_counts, csd_histogram
from ..ops.lattice import Lattice
from ..ops.measure import per_slot_values, slot_temps_for_systems
from ..ops.sweep import pack_coupling_grids, sweep_2d
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
    coup: torch.Tensor  # f32 [n_disorder, n_spins, 2] forward couplings

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
            coup=coup.contiguous(),
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


def init_accumulators(rt: Runtime, cfg: SimConfig) -> dict:
    """Record sums per (realization, record row, temperature), and the FK
    cluster-size histograms ``fk_csd`` int64 ``[d, T, n_spins + 1]`` when
    the run collects cluster statistics.

    They accumulate on the device in float64 / int64, where the reference
    keeps Kahan-compensated f32 pairs (peapods_tpu/engine/loop.py:99-104)
    and int32 only because the TPU has no 64-bit types.
    """
    acc = {
        "rec_sums": torch.zeros((rt.n_disorder, N_REC, rt.n_temps),
                                dtype=torch.float64, device=rt.device),
        "n_recorded": 0,
    }
    c = cfg.cluster_update
    if c is not None and c.collect_stats:
        acc["fk_csd"] = torch.zeros(
            (rt.n_disorder, rt.n_temps, rt.n_spins + 1), dtype=torch.int64,
            device=rt.device)
    return acc


def _upload(words: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(words))
    if device.type == "cuda":
        # pinned + non_blocking: the copy is ordered on the stream and the
        # host does not wait for it
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _fold_records(rt: Runtime, state: dict, acc: dict, e, m, s_begin: int,
                  n: int) -> None:
    """Add the records of the sweeps past warmup: ``e`` f32 / ``m`` int32
    ``[d, n, T]`` by slot (slot == temperature, R == 1)."""
    lo = max(0, int(state["warmup"]) - s_begin)
    if lo >= n:
        return
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


def run_chunk(rt: Runtime, cfg: SimConfig, state: dict, acc: dict,
              s_begin: int, n: int) -> None:
    """Run sweeps ``s_begin .. s_begin + n - 1`` of a sample() call,
    updating ``state`` and ``acc`` in place: the per-sweep path when the
    run has a cluster phase, else the mega path."""
    if cfg.cluster_update is not None:
        run_chunk_cluster(rt, cfg, state, acc, s_begin, n)
        return
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
    _fold_records(rt, state, acc, e, m, s_begin, n)


def run_chunk_cluster(rt: Runtime, cfg: SimConfig, state: dict, acc: dict,
                      s_begin: int, n: int) -> None:
    """The per-sweep path with an FK cluster phase (the reference's
    ``_make_step_body``, peapods_tpu/engine/loop.py:2723-2952).  Per sweep:

    1. the checkerboard sweep of every system at its temperature
       (:func:`~peapods_tpu_torch.ops.sweep.sweep_2d`);
    2. on sweeps ``s`` with ``s % interval == 0``, the FK update of every
       system with the measurement of the updated spins
       (:func:`~peapods_tpu_torch.ops.fk.fk_update`); on the others the
       sweep's second colour pass measures;
    3. ``pt_step`` reduces the measurement into the sweep's (e, m) rows and,
       on PT sweeps, runs the PT event with the reference's jnp-form draws;
    4. the records (and the cluster-size histograms) of the sweeps past
       warmup are folded into the sums.
    """
    c = cfg.cluster_update
    wolff = c.mode == "wolff"
    pt_on = cfg.pt_interval is not None and rt.n_temps >= 2
    pt_full = cfg.pt_schedule == "full_ladder"
    d, n_sys = rt.n_disorder, rt.n_systems
    h, w = rt.lattice.shape
    dev = rt.device
    counter = int(state["counter"])
    base = state["base_keys"]
    warmup = int(state["warmup"])

    sweep_w = _upload(seeds.sweep_words(base, counter, n, seeds.PH_SWEEP), dev)
    fk_t = [t for t in range(n) if (s_begin + t) % c.interval == 0]
    fk_at = {t: k for k, t in enumerate(fk_t)}
    if fk_t:
        kb, kf = seeds.fk_keys(base, counter + np.asarray(fk_t), n_sys)
        kb_w = _upload(kb.view(np.int32), dev)
        scal = _upload(seeds.fk_scalars(kf, rt.n_spins, wolff=wolff), dev)
    draws = None
    if pt_on:
        dr = seeds.pt_draws_jnp(base, counter, n, n_sys - 1, pt_full=pt_full)
        draws = (_upload(dr, dev) if pt_full
                 else tuple(_upload(x, dev) for x in dr))

    sweep_u = bond_u = None
    if dev.type == "cpu":
        sweep_u = rng.blocked(lambda a, b: torch.stack(
            [rng.colour_uniforms(sweep_w[a:b], n_sys, col, (h, w))
             for col in (0, 1)], dim=3), d * n_sys * h * w * 2)
        if fk_t:
            bond_u = rng.blocked(
                lambda a, b: rng.bond_uniforms(kb_w[a:b], h * w),
                d * n_sys * h * w * 2)

    spins = state["spins"].view(d, n_sys, h, w)
    graphs = state["spins"].view(d * n_sys, h, w)
    sid = state["system_ids"].view(d, n_sys)
    sys_temps = slot_temps_for_systems(sid, rt.temps)
    pt_state = [state[k] for k in ("pt_edge_attempts", "pt_edge_acceptances",
                                   "pt_round_trips", "pt_trip_state")]
    e = torch.empty((d, n, n_sys), dtype=torch.float32, device=dev)
    m = torch.empty((d, n, n_sys), dtype=torch.int32, device=dev)
    parity = int(state["pt_parity"])
    gibbs = cfg.sweep_mode == "gibbs"
    collect = "fk_csd" in acc
    for t in range(n):
        k = fk_at.get(t)
        parts = sweep_2d(spins, rt.jgrids, sys_temps, sweep_w[t], gibbs=gibbs,
                         measure=k is None,
                         uniforms=None if sweep_u is None else sweep_u(t))
        if k is not None:
            e_part, m_part, labels = fk.fk_update(
                graphs, rt.coup, sys_temps.view(-1), scal[k], kb_w[k],
                wolff=wolff, with_measure=True, with_labels=collect,
                uniforms=None if bond_u is None else bond_u(k))
            parts = (e_part.view(d, n_sys, -1), m_part.view(d, n_sys, -1))
            if collect and s_begin + t >= warmup:
                csd = csd_histogram(component_counts(labels.view(d * n_sys, -1)))
                acc["fk_csd"] += per_slot_values(csd.view(d, n_sys, -1), sid)
        do_pt = pt_on and (s_begin + t) % cfg.pt_interval == 0
        parity = mega.pt_step(
            *parts, e[:, t], m[:, t], sid, *pt_state, rt.temps,
            None if not do_pt else (
                draws[t] if pt_full else (draws[0][t], draws[1][t])),
            sys_temps, do_pt=do_pt, pt_full=pt_full, parity=parity,
            hot_slot=rt.hot_slot, cold_slot=rt.cold_slot, n_spins=rt.n_spins)
    state["counter"] = np.int32(counter + n)
    state["pt_parity"] = np.int32(parity)
    _fold_records(rt, state, acc, e, m, s_begin, n)
