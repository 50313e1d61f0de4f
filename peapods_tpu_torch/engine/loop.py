"""Device constants and the chunk runners: the mega path, the per-sweep
(cluster) path and the replica path.

Counterpart of ``Runtime``, ``LoopProgram._mega_chunk_runner``, the
per-sweep ``_make_step_body`` and ``_megapair_chunk_runner`` in
``peapods_tpu/engine/loop.py`` (:125-471, :2960-3135, :2708-2954,
:3205-3741).  For each chunk the host computes every sweep's key words (and
the FK phase's scalars, the overlap moves' tasks and scalars and the PT
draws) with the numpy threefry (:mod:`~peapods_tpu_torch.engine.seeds`)
and uploads them in one copy; the kernels then run sweep after sweep with
no host synchronisation, and the per-sweep rows are folded into the record
sums on the device.  :func:`run_chunk` takes the replica path when there
are two replicas or more on a square or cubic lattice with even extents
without an FK phase or snapshots, the mega path for one replica on such a
square lattice without a cluster phase, and the per-sweep path otherwise (a
cluster phase, snapshots, or any other lattice: triangular, BCC, FCC, 3D
cubic with one replica, odd extents, 1D, 4D and up, an offset table), with
the pair measurement and the overlap moves when there are replicas.  On a
``space`` mesh, :func:`run_chunk_space` runs the per-sweep path over the
lattice's row bands.

Each runner marks its phases with the reference's two profiling scopes
(``utils/profiling.py`` ``phase_scope``, peapods_tpu/engine/loop.py:2736,
:2794): ``"sweep"`` around the sweep launches and ``"measure"`` around the
measurement and the fold of the records.

The reference's sentinel padding of short chunks and its ``n_inner <= 256``
SMEM cap exist only to keep one compiled TPU program per chunk length; a
chunk here is as long as it needs to be.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import cc_band, fk, halo, mega, megapair, overlap, rng, winding
from ..ops.cluster import (component_counts, csd_histogram, graph_observation,
                            top4_sizes)
from ..ops.energy import measure_nb
from ..ops.lattice import BandGeometry, Lattice, neighbour_values
from ..ops.measure import per_slot_values, slot_temps_for_systems
from ..ops.overlap import KINDS, gather_tasks
from ..ops.sweep import pack_coupling_grids, sweep_2d, sweep_nb
from ..ops.tempering import hot_cold_slots, pt_draws_pairs
from . import seeds
from ..utils.autocorr import AutocorrStream, clamp_max_lag
from ..utils.profiling import phase_scope
from .config import SimConfig
from .records import N_EQ_SLOTS, N_FK_OBS, N_REC, REC, SERIES, link_bonds

__all__ = ["Runtime", "SpaceRuntime", "init_accumulators", "run_chunk",
           "run_chunk_sweeps", "run_chunk_space", "run_chunk_pairs"]


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
    slot_temps: torch.Tensor  # f32 [n_replicas * n_temps]: temps by slot
    # f32 [n_disorder, 2 n_dims, *shape] on the square and cubic
    # checkerboards (Lattice.axes_form), else None
    jgrids: torch.Tensor | None
    coup: torch.Tensor  # f32 [n_disorder, n_spins, n_neighbors] forward couplings
    coup_bwd: torch.Tensor  # f32 [n_disorder, n_spins, n_neighbors]: J[i - off_d, d]
    colours: torch.Tensor  # uint8 [n_spins] the lattice's colouring
    # int32 (fwd, bwd) [n_spins, n_neighbors] on a table lattice
    # (Lattice.table: the table form's neighbours), else None
    tables: tuple | None = None
    # the row bands on a space mesh (the couplings then live in the bands
    # only: jgrids, coup and coup_bwd are None)
    space: SpaceRuntime | None = None

    @classmethod
    def build(cls, lattice, couplings_nd, temps, n_replicas, device, space=None):
        """couplings_nd: f32 ``[n_disorder, n_spins, n_neighbors]`` (numpy);
        ``space``: the bands' :class:`SpaceRuntime` on a space mesh."""
        temps_np = np.asarray(temps, dtype=np.float32)
        t = torch.as_tensor(temps_np, device=device)
        colours = torch.as_tensor(lattice.colors.astype(np.uint8), device=device)
        if space is not None:
            return cls(lattice=lattice, n_replicas=int(n_replicas),
                       n_temps=len(temps_np), n_disorder=int(couplings_nd.shape[0]),
                       device=device, temps_np=temps_np, temps=t,
                       slot_temps=t.repeat(int(n_replicas)).contiguous(),
                       jgrids=None, coup=None, coup_bwd=None, colours=colours,
                       space=space)
        coup = torch.as_tensor(np.asarray(couplings_nd, np.float32), device=device)
        coup_bwd = torch.stack(
            [neighbour_values(coup[..., k], lattice.shape, -off)
             for k, off in enumerate(lattice.offsets)], dim=-1)
        return cls(
            lattice=lattice,
            n_replicas=int(n_replicas),
            n_temps=len(temps_np),
            n_disorder=int(coup.shape[0]),
            device=device,
            temps_np=temps_np,
            temps=t,
            slot_temps=t.repeat(int(n_replicas)).contiguous(),
            jgrids=(pack_coupling_grids(coup, lattice.shape).contiguous()
                    if lattice.axes_form else None),
            coup=coup.contiguous(),
            coup_bwd=coup_bwd.contiguous(),
            colours=colours,
            tables=lattice.device_tables(device) if lattice.table else None,
        )

    @property
    def n_spins(self):
        return self.lattice.n_spins

    @property
    def n_systems(self):
        return self.n_replicas * self.n_temps

    @property
    def n_pairs(self):
        return self.n_replicas // 2

    @property
    def hot_slot(self):
        return hot_cold_slots(self.temps_np)[0]

    @property
    def cold_slot(self):
        return hot_cold_slots(self.temps_np)[1]


@dataclass
class SpaceRuntime:
    """The row bands of a lattice on a ``space`` mesh: the band geometry,
    each band's device and its window constants (``halo.band_couplings``;
    the colour table at the window sites)."""

    geometry: BandGeometry
    devices: list
    coup_fwd: list  # f32 [n_disorder, n_window, n_neighbors] per band
    coup_bwd: list
    colours: list  # uint8 [n_window] per band

    @classmethod
    def build(cls, lattice, couplings_nd, devices):
        geom = BandGeometry(lattice, len(devices))
        coup = np.asarray(couplings_nd, np.float32)
        coup_bwd = halo.backward_couplings(coup, lattice)
        fwd, bwd, col = [], [], []
        for band, dev in zip(geom.bands, devices):
            f, b = halo.band_couplings(coup, band, dev, coup_bwd)
            fwd.append(f)
            bwd.append(b)
            col.append(torch.as_tensor(lattice.colors[band.window_sites()].astype(np.uint8),
                                       device=dev))
        return cls(geom, list(devices), fwd, bwd, col)

    @property
    def bands(self):
        return self.geometry.bands

    def windows(self, spins):
        """The bands' spin windows ``[d, S, n_window]`` of spins ``[d, S,
        n_spins]``, on their devices."""
        return [spins[..., torch.from_numpy(b.window_sites()).to(spins.device)]
                .to(dev).contiguous() for b, dev in zip(self.bands, self.devices)]


def init_accumulators(rt: Runtime, cfg: SimConfig) -> dict:
    """Record sums per (realization, record row, temperature); the FK
    cluster-size histograms ``fk_csd`` int64 ``[d, T, n_spins + 1]`` when
    the run collects cluster statistics; on FK observe runs the graph
    observation sums ``fk_obs`` (int64 ``[d, T, N_FK_OBS]``, the columns of
    ``records.FK_OBS``; the fractions are taken when the results are built,
    where the reference sums them in f32) and ``winding_errors`` (int32
    ``[1]``, set by the winding kernel when labels and masks disagree); and
    with replica pairs the P(q)
    histogram ``q_hist`` and the sums ``ql_at_q`` / ``ql2_at_q`` of the
    link-overlap integers ``ql`` and ``ql**2`` at each q bin, int64 ``[d, T,
    n_spins + 1]``.  Runs whose overlap moves collect statistics (or
    observe) keep per mode ``n_modes`` the stats graphs' cluster-size
    histograms ``overlap_csd`` int64 ``[d, n_modes, T, n_spins + 1]``, their
    top-4 sizes over n_spins ``top4_sum`` f64 ``[d, n_modes, T, 4]`` and the
    moves counted ``top4_n`` int64 ``[d, n_modes]``; overlap observe runs
    add per kind used ``ov_obs_<kind>`` (as ``fk_obs``) and
    ``winding_errors``.

    With ``autocorrelation_max_lag`` (clamped to a quarter of the recorded
    sweeps, ``lag``) the series m2_ac (and q2_ac with replica pairs: ``c``
    series) of the recorded sweeps feed, on the ``ring`` backend, the
    lagged-product sums ``ac_sum_prod`` f64 ``[lag + 1, c d T]`` (rows by
    lag, features ``[c, d, T]``), ``ac_sum`` / ``ac_sum2`` f64 ``[c d T]``,
    the last ``lag`` values ``ac_hist`` f64 ``[lag, c d T]`` (zeros before
    the first) and their count ``ac_count``; on the ``fft`` backend the
    host streams ``ac_stream`` (m2_ac) and ``ac_stream_q`` (q2_ac), each an
    :class:`~peapods_tpu_torch.utils.autocorr.AutocorrStream` over ``d T``
    features.  The equilibration diagnostic keeps the sums of diag_e and
    diag_ql over every sweep ``eq_sum`` f64 ``[d, 2, T]`` and their means
    at the sweep counts 128 * 2**k ``eq_ckpt`` f64 ``[N_EQ_SLOTS, d, 2,
    T]`` (the reference's shapes, loop.py:1099-1115).

    They accumulate on the device in float64 / int64, where the reference
    keeps Kahan-compensated f32 pairs (peapods_tpu/engine/loop.py:99-104)
    and int32 only because the TPU has no 64-bit types; the ql sums stay
    integers, exact and independent of the order of the device's adds, and
    are scaled when the results are built.
    """
    d = rt.n_disorder
    acc = {
        "rec_sums": torch.zeros((d, N_REC, rt.n_temps),
                                dtype=torch.float64, device=rt.device),
        "n_recorded": 0,
    }
    if rt.n_pairs:
        for key in ("q_hist", "ql_at_q", "ql2_at_q"):
            acc[key] = torch.zeros((rt.n_disorder, rt.n_temps, rt.n_spins + 1),
                                   dtype=torch.int64, device=rt.device)
    c = cfg.cluster_update
    if c is not None and c.collect_stats:
        acc["fk_csd"] = torch.zeros(
            (rt.n_disorder, rt.n_temps, rt.n_spins + 1), dtype=torch.int64,
            device=rt.device)
    if c is not None and c.action == "observe":
        acc["fk_obs"] = torch.zeros((rt.n_disorder, rt.n_temps, N_FK_OBS),
                                    dtype=torch.int64, device=rt.device)
        acc["winding_errors"] = torch.zeros(1, dtype=torch.int32, device=rt.device)
    h = cfg.overlap_cluster
    if h is not None and h.collect_stats and rt.n_pairs:
        m, T, nb = len(h.modes), rt.n_temps, rt.n_spins + 1
        z = dict(device=rt.device)
        acc["overlap_csd"] = torch.zeros((d, m, T, nb), dtype=torch.int64, **z)
        acc["top4_sum"] = torch.zeros((d, m, T, 4), dtype=torch.float64, **z)
        acc["top4_n"] = torch.zeros((d, m), dtype=torch.int64, **z)
        if h.action == "observe":
            for kind in (k for k in KINDS if k in {x.kind for x in h.modes}):
                acc[f"ov_obs_{kind}"] = torch.zeros((d, T, N_FK_OBS),
                                                    dtype=torch.int64, **z)
            acc["winding_errors"] = torch.zeros(1, dtype=torch.int32, **z)
    if cfg.autocorrelation_max_lag is not None:
        lag = clamp_max_lag(cfg.autocorrelation_max_lag,
                            cfg.n_sweeps - cfg.warmup_sweeps)
        f = (2 if rt.n_pairs else 1) * d * rt.n_temps
        if cfg.autocorrelation_backend == "fft":
            acc["ac_stream"] = AutocorrStream(lag, d * rt.n_temps, "fft")
            if rt.n_pairs:
                acc["ac_stream_q"] = AutocorrStream(lag, d * rt.n_temps, "fft")
        else:
            z = dict(dtype=torch.float64, device=rt.device)
            acc.update(ac_sum_prod=torch.zeros((lag + 1, f), **z),
                       ac_sum=torch.zeros(f, **z), ac_sum2=torch.zeros(f, **z),
                       ac_hist=torch.zeros((lag, f), **z), ac_count=0)
    if cfg.equilibration_diagnostic:
        z = dict(dtype=torch.float64, device=rt.device)
        acc["eq_sum"] = torch.zeros((d, 2, rt.n_temps), **z)
        acc["eq_ckpt"] = torch.zeros((N_EQ_SLOTS, d, 2, rt.n_temps), **z)
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
    ``[d, n, R T]`` by slot, summed over the replicas."""
    lo = max(0, int(state["warmup"]) - s_begin)
    if lo >= n:
        return
    d, R, T = rt.n_disorder, rt.n_replicas, rt.n_temps
    k = n - lo
    m_rt = m[:, lo:].reshape(d, k, R, T).to(torch.float64) / rt.n_spins
    e_rt = e[:, lo:].reshape(d, k, R, T).to(torch.float64)
    m2 = m_rt * m_rt
    sums = acc["rec_sums"]
    over = (1, 2)  # sweeps and replicas
    sums[:, REC["m_sum"]] += m_rt.sum(over)
    sums[:, REC["m2_sum"]] += m2.sum(over)
    sums[:, REC["m4_sum"]] += (m2 * m2).sum(over)
    sums[:, REC["e_sum"]] += e_rt.sum(over)
    sums[:, REC["e2_sum"]] += (e_rt * e_rt).sum(over)
    acc["n_recorded"] += k


def _fold_pairs(rt: Runtime, state: dict, acc: dict, qs, ql, s_begin: int,
                n: int) -> None:
    """Add the pair records of the sweeps past warmup (loop.py:3358-3394):
    ``qs`` / ``ql`` int32 ``[d, n, P T]`` (pair-major); q = qs / n_spins,
    q_l = ql / :func:`~.records.link_bonds`, and ``(qs + n_spins) // 2`` is
    the P(q) bin."""
    lo = max(0, int(state["warmup"]) - s_begin)
    if lo >= n:
        return
    d, P, T, n_sp = rt.n_disorder, rt.n_pairs, rt.n_temps, rt.n_spins
    k = n - lo
    qs_i = qs[:, lo:].reshape(d, k, P, T).to(torch.int64)
    ql_i = ql[:, lo:].reshape(d, k, P, T).to(torch.int64)
    q = qs_i.to(torch.float64) / n_sp
    q_l = ql_i.to(torch.float64) / link_bonds(rt.lattice)
    sums = acc["rec_sums"]
    over = (1, 2)  # sweeps and pairs
    for name, x in (("q", q), ("ql", q_l)):
        x2 = x * x
        sums[:, REC[f"{name}_sum"]] += x.sum(over)
        sums[:, REC[f"{name}2_sum"]] += x2.sum(over)
        sums[:, REC[f"{name}4_sum"]] += (x2 * x2).sum(over)
    nb = n_sp + 1
    row = (torch.arange(d, device=qs.device)[:, None, None, None] * T
           + torch.arange(T, device=qs.device))  # [d, 1, 1, T]
    idx = (row * nb + (qs_i + n_sp) // 2).reshape(-1)
    acc["q_hist"].view(-1).index_add_(0, idx, torch.ones_like(idx))
    acc["ql_at_q"].view(-1).index_add_(0, idx, ql_i.reshape(-1))
    acc["ql2_at_q"].view(-1).index_add_(0, idx, (ql_i * ql_i).reshape(-1))


# the largest temporary of the ring's fold (the lag range is split to keep
# each window product under it)
FOLD_BYTES = 256 << 20


def _series(rt: Runtime, e, m, pair_rows, n: int) -> torch.Tensor:
    """The chunk's series (``records.SERIES``) per sweep and temperature,
    f64 ``[N_SERIES, d, n, T]`` holding f32 values (the reference's series
    are f32, utils/autocorr.py:48): the replica means of (m / N)^2 and e,
    and with replica pairs the pair means of q^2 and q_l (else 0)
    (peapods_tpu/engine/loop.py:2645-2662, :3070-3110, :3345-3407)."""
    d, R, T = rt.n_disorder, rt.n_replicas, rt.n_temps
    f64 = torch.float64
    m_rt = m.reshape(d, n, R, T).to(f64) / rt.n_spins
    rows = [(m_rt * m_rt).sum(2) / R, None,
            e.reshape(d, n, R, T).to(f64).sum(2) / R, None]
    if pair_rows is None:
        rows[1] = rows[3] = torch.zeros_like(rows[0])
    else:
        P = rt.n_pairs
        q = pair_rows[0].reshape(d, n, P, T).to(f64) / rt.n_spins
        rows[1] = (q * q).sum(2) / P
        rows[3] = (pair_rows[1].reshape(d, n, P, T).to(f64)
                   / link_bonds(rt.lattice)).sum(2) / P
    return torch.stack(rows).to(torch.float32).to(f64)


def _fold_ring(acc: dict, o) -> None:
    """Add a block of recorded values ``o`` f64 ``[k, F]`` to the ring's
    sums (``AutocorrStream.push_block``'s ring, in one product a piece of
    the lag range): value j of the block times the value ``delta`` before
    it, which is 0 where fewer than ``delta`` values were recorded before
    (the history's leading zeros)."""
    k, f = o.shape
    lag = acc["ac_hist"].shape[0]
    acc["ac_sum"] += o.sum(0)
    acc["ac_sum2"] += (o * o).sum(0)
    ext = torch.cat([acc["ac_hist"], o])  # [lag + k, F]
    # reversed: window delta of ext's reverse, against o's reverse, pairs
    # o[j] with ext[lag + j - delta]
    win = ext.flip(0).unfold(0, k, 1)  # [lag + 1, F, k]
    o_rev = o.flip(0).t()  # [F, k]
    step = max(1, FOLD_BYTES // (8 * f * k))
    for a in range(0, lag + 1, step):
        acc["ac_sum_prod"][a:a + step] += (win[a:a + step] * o_rev).sum(-1)
    acc["ac_hist"] = ext[k:].clone()
    acc["ac_count"] += k


def _fold_series(rt: Runtime, state: dict, acc: dict, e, m, pair_rows,
                 s_begin: int, n: int) -> None:
    """Fold the series of sweeps ``s_begin .. s_begin + n - 1`` (the
    reference's ``ac_equil_block``, peapods_tpu/engine/loop.py:1153-1231):
    the recorded sweeps' m2_ac (and q2_ac) into the ring's sums or, on the
    fft backend, into the host streams (one copy a chunk); every sweep's
    diag_e and diag_ql, warmup included (mod.rs:511,531), into the
    equilibration sums, whose means are kept at the sweep counts 128 * 2**k.
    Products and sums in f64 on the device; no state is read but the
    warmup, none written."""
    if not ("eq_sum" in acc or "ac_sum" in acc or "ac_stream" in acc):
        return
    vals = _series(rt, e, m, pair_rows, n)
    c = 2 if rt.n_pairs else 1
    lo = max(0, int(state["warmup"]) - s_begin)
    if lo < n and "ac_sum" in acc:
        _fold_ring(acc, vals[:c, :, lo:].permute(2, 0, 1, 3).reshape(n - lo, -1))
    if lo < n and "ac_stream" in acc:
        block = vals[:c, :, lo:].to(torch.float32).cpu().numpy()  # [c, d, k, T]
        for i, key in enumerate(("ac_stream", "ac_stream_q")[:c]):
            acc[key].push_block(block[i].transpose(1, 0, 2).reshape(n - lo, -1))
    if "eq_sum" in acc:
        dv = vals[SERIES["diag_e"]:].permute(2, 1, 0, 3)  # [n, d, 2, T]
        # the sweep counts 128 * 2**k that end in the chunk (indexed by host
        # integers: an index tensor's upload would wait for the device)
        ends = [j for j in range(N_EQ_SLOTS) if s_begin < 128 << j <= s_begin + n]
        if ends:
            run = torch.cumsum(dv, 0)
            for j in ends:
                count = 128 << j
                acc["eq_ckpt"][j] = (acc["eq_sum"] + run[count - s_begin - 1]) / count
        acc["eq_sum"] += dv.sum(0)


def run_chunk(rt: Runtime, cfg: SimConfig, state: dict, acc: dict,
              s_begin: int, n: int) -> None:
    """Run sweeps ``s_begin .. s_begin + n - 1`` of a sample() call,
    updating ``state`` and ``acc`` in place: the row bands' path on a space
    mesh; the replica path with two replicas or more on a square or cubic
    lattice with even extents, unless the run has an FK phase or snapshots;
    the mega path for one replica on such a square lattice without a
    cluster phase; else the per-sweep path (with replicas: the reference's
    ``_make_step_body``, which its engine runs wherever the pairs
    megakernel is off, peapods_tpu/engine/loop.py:666-682)."""
    if rt.space is not None:
        run_chunk_space(rt, cfg, state, acc, s_begin, n)
        return
    if megapair.supports_megapair(rt.lattice, rt.n_replicas) and not _sweeps_with_pairs(cfg):
        run_chunk_pairs(rt, cfg, state, acc, s_begin, n)
        return
    if cfg.cluster_update is not None or not mega.supports_mega(rt.lattice,
                                                                rt.n_replicas):
        run_chunk_sweeps(rt, cfg, state, acc, s_begin, n)
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
    # one launch sweeps and measures the chunk: a single "sweep" scope
    with phase_scope("sweep"):
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
    with phase_scope("measure"):
        _fold_records(rt, state, acc, e, m, s_begin, n)
        _fold_series(rt, state, acc, e, m, None, s_begin, n)


def _sweeps_with_pairs(cfg: SimConfig) -> bool:
    """Whether a replica run takes the per-sweep path on a square or cubic
    lattice: it has an FK phase or takes snapshots."""
    h = cfg.overlap_cluster
    return cfg.cluster_update is not None or (h is not None
                                              and h.snapshot_interval is not None)


def _snapshot(rt: Runtime, spins, sid, tasks, mode: int, s: int):
    """The snapshot of an overlap move at sweep ``s`` before its flips
    (``_overlap_branch(with_snapshot=True)``, peapods_tpu/engine/
    loop.py:2579-2592): realization 0, the first group at each
    temperature, its first two replicas' systems and spins (copied now);
    the move's labels are added when it has run."""
    sys, a, b = gather_tasks(spins[:1], sid[:1], tasks[:1, :, :1, :2], rt.n_temps)
    return {"sweep_id": s, "mode_idx": mode, "spins": torch.stack([a, b], 1),
            "system_ids": sys[0, :, 0]}


def _by_temp(rt: Runtime, values, sid):
    """Per-system values ``[d * n_systems, ...]`` summed into their
    temperatures' rows ``[d, n_temps, ...]`` (over the replicas), in int64."""
    d, R, T = rt.n_disorder, rt.n_replicas, rt.n_temps
    v = values.reshape(d, R * T, *values.shape[1:])
    return per_slot_values(v, sid).reshape(d, R, T, *v.shape[2:]).sum(
        1, dtype=torch.int64)


def _fold_fk_graphs(rt: Runtime, acc: dict, labels, masks, sid) -> None:
    """Add one recorded FK sweep's graphs to the sums: the cluster-size
    histograms ``fk_csd`` and, on observe runs, the graph observations
    ``fk_obs`` (the reference's ``_sum_slots_obs`` / ``_obs_add``,
    peapods_tpu/engine/loop.py:498-527): per temperature the count of
    graphs, the sums of their top-4 sizes, active bonds, large components
    and winding flags ``(x, y, x | y, x & y)`` (winding on the canonical 2D
    square only), all integers, in the columns of ``records.FK_OBS``."""
    b = rt.n_disorder * rt.n_systems
    counts = component_counts(labels.reshape(b, -1))
    acc["fk_csd"] += _by_temp(rt, csd_histogram(counts), sid)
    if "fk_obs" not in acc:
        return
    wind = None
    if rt.lattice.canonical_square:
        wind = winding.winding_flags(masks, labels.reshape(b, -1), rt.lattice.shape,
                                     errors=acc["winding_errors"])
    g = graph_observation(masks, counts, wind)
    wx, wy = g.winding_x, g.winding_y
    cols = torch.cat([torch.ones_like(g.active_bonds)[:, None], g.top4,
                      g.active_bonds[:, None], g.large_components[:, None],
                      torch.stack([wx, wy, wx | wy, wx & wy], -1).to(torch.int32)], -1)
    acc["fk_obs"] += _by_temp(rt, cols, sid)


def run_chunk_sweeps(rt: Runtime, cfg: SimConfig, state: dict, acc: dict,
                     s_begin: int, n: int) -> None:
    """The per-sweep path (the reference's ``_make_step_body``,
    peapods_tpu/engine/loop.py:2708-2952), with or without an FK cluster
    phase, with one replica or more.  Per sweep:

    1. the sweep of every system at its temperature: the checkerboard
       :func:`~peapods_tpu_torch.ops.sweep.sweep_2d` on a square lattice,
       one :func:`~peapods_tpu_torch.ops.sweep.sweep_nb` pass per colour on
       any other;
    2. on sweeps ``s`` with ``s % interval == 0``, the FK phase of every
       system.  On the FK kernels' lattices (square, triangular, 3D cubic)
       an update measures the updated spins
       (:func:`~peapods_tpu_torch.ops.fk.fk_update`); on the lattices given
       by an offset table (BCC, FCC, custom) the staged path
       (:func:`~peapods_tpu_torch.ops.fk.fk_staged`: bonds, the CC kernels,
       flips) updates them.  Observe (``cluster_action="observe"``) builds
       the bond graphs and their labels (:func:`~peapods_tpu_torch.ops.fk.
       fk_observe` or ``fk_staged``), leaves the spins alone and is skipped
       on sweeps that record nothing;
    3. the measurement, unless the FK update made it: ``sweep_2d``'s second
       colour pass (the counterpart of ``pallas_sweep.sweep_2d_fused``,
       every sweep of an observe run) or
       :func:`~peapods_tpu_torch.ops.energy.measure_nb` after the FK phase;
       with replica pairs, :func:`~peapods_tpu_torch.ops.megapair.
       pair_overlap` of every pair over the lattice's offsets (the
       reference's ``_measure_phase``, :2623-2666; on a table lattice
       :func:`~peapods_tpu_torch.ops.megapair.pair_overlap_table` over
       ``rt.tables``); ``pt_step`` reduces the measurement into the sweep's
       (e, m) rows;
    4. on sweeps ``s`` with ``s % interval == 0``, the overlap move
       (:func:`~peapods_tpu_torch.ops.overlap.overlap_event` over the
       lattice's offsets, every lattice; its table form on a table
       lattice, over ``rt.tables``), its statistics or observations
       folded, and on the snapshot sweeps its snapshot taken (the spins
       before it, its labels);
    5. on PT sweeps, ``pt_step``'s PT event on each replica's ladder with
       the reference's jnp-form draws (:func:`~.seeds.pt_draws_jnp`): on
       the sweep's (e, m), or after an overlap update on energies re-derived
       from the moved spins (:2888-2900: :func:`~peapods_tpu_torch.ops.
       overlap.energy_partials` on the square and cubic lattices,
       :func:`~peapods_tpu_torch.ops.energy.measure_nb` on the others); an
       observe run's PT reads the sweep's (e, m), as a run without the
       observer does;
    6. the records of the sweeps past warmup, the pair records, the
       cluster-size histograms and the graph observations of their FK
       phases are folded into the sums.
    """
    c = cfg.cluster_update
    h = cfg.overlap_cluster
    wolff = c is not None and c.mode == "wolff"
    observe = c is not None and c.action == "observe"
    pt_on = cfg.pt_interval is not None and rt.n_temps >= 2
    pt_full = cfg.pt_schedule == "full_ladder"
    lat = rt.lattice
    staged = not fk.fused_lattice(lat)
    d, n_sys, n_sp = rt.n_disorder, rt.n_systems, rt.n_spins
    R, T = rt.n_replicas, rt.n_temps
    n_dirs = lat.n_neighbors
    dev = rt.device
    counter = int(state["counter"])
    base = state["base_keys"]
    warmup = int(state["warmup"])

    sweep_w = _upload(seeds.sweep_words(base, counter, n, seeds.PH_SWEEP), dev)
    # the FK phase's sweeps; observe skips those that record nothing
    fk_t = ([t for t in range(n) if (s_begin + t) % c.interval == 0
             and not (observe and s_begin + t < warmup)]
            if c is not None else [])
    fk_at = {t: k for k, t in enumerate(fk_t)}
    scal = None
    if fk_t:
        kb, kf = seeds.fk_keys(base, counter + np.asarray(fk_t), n_sys)
        kb_w = _upload(kb.view(np.int32), dev)
        if not observe:
            scal = _upload(seeds.fk_scalars(kf, n_sp, wolff=wolff), dev)
    draws = None
    if pt_on:
        dr = seeds.pt_draws_jnp(base, counter, n, T - 1, pt_full=pt_full, n_replicas=R)
        draws = (_upload(dr, dev) if pt_full
                 else tuple(_upload(x, dev) for x in dr))
    fold = None
    if "overlap_csd" in acc:
        fold = lambda mode, graphs: _fold_overlap_graphs(rt, cfg, acc, mode, graphs)  # noqa: E731
    events = _event_tables(rt, cfg, base, counter, s_begin, n, fold)
    ev_at = {} if events is None else {t: k for k, t in enumerate(events.at)}
    si = None if h is None else h.snapshot_interval

    sweep_u = bond_u = None
    if dev.type == "cpu":
        if lat.square:
            sweep_u = rng.blocked(lambda a, b: torch.stack(
                [rng.colour_uniforms(sweep_w[a:b], n_sys, col, lat.shape)
                 for col in (0, 1)], dim=3), d * n_sys * n_sp * 2)
        else:
            sweep_u = rng.blocked(lambda a, b: torch.stack(
                [rng.site_uniforms(sweep_w[a:b], n_sys, col, n_sp)
                 for col in range(lat.n_colors)], dim=2),
                d * n_sys * n_sp * lat.n_colors)
        if fk_t:
            bond_u = rng.blocked(
                lambda a, b: rng.bond_uniforms(kb_w[a:b], n_sp, n_dirs=n_dirs),
                d * n_sys * n_sp * n_dirs)

    flat = state["spins"].view(d, n_sys, n_sp)
    spins = state["spins"].view(d, n_sys, *lat.shape)
    graphs = state["spins"].view(d * n_sys, *lat.shape)
    sid = state["system_ids"].view(d, n_sys)
    sys_temps = slot_temps_for_systems(sid, rt.slot_temps)
    graph_temps = sys_temps.view(-1)
    pt_state = [state[k] for k in ("pt_edge_attempts", "pt_edge_acceptances",
                                   "pt_round_trips", "pt_trip_state")]
    e = torch.empty((d, n, n_sys), dtype=torch.float32, device=dev)
    m = torch.empty((d, n, n_sys), dtype=torch.int32, device=dev)
    pair_rows = None
    if rt.n_pairs:
        pair_rows = [torch.empty((d, n, rt.n_pairs * T), dtype=torch.int32, device=dev)
                     for _ in range(2)]
    parity = int(state["pt_parity"])
    gibbs = cfg.sweep_mode == "gibbs"
    collect = "fk_csd" in acc
    pt_kw = dict(pt_full=pt_full, hot_slot=rt.hot_slot, cold_slot=rt.cold_slot,
                 n_spins=n_sp, n_replicas=R)
    for t in range(n):
        s = s_begin + t
        k = fk_at.get(t)
        # the FK kernels' update measures the spins it leaves
        fk_measures = k is not None and not (observe or staged)
        u = None if sweep_u is None else sweep_u(t)
        parts = None
        with phase_scope("sweep"):
            if lat.square:
                parts = sweep_2d(spins, rt.coup, sys_temps, sweep_w[t], gibbs=gibbs,
                                 measure=not fk_measures, uniforms=u)
            else:
                sweep_nb(flat, rt.coup, rt.coup_bwd, rt.colours, sys_temps,
                         sweep_w[t], lat, gibbs=gibbs, uniforms=u, tables=rt.tables)
        if k is not None:
            bu = None if bond_u is None else bond_u(k)
            masks = None
            if staged:
                labels, masks = fk.fk_staged(
                    graphs, rt.coup, graph_temps, None if scal is None else scal[k],
                    kb_w[k], lat, wolff=wolff, with_masks=observe, uniforms=bu,
                    tables=rt.tables)
            elif observe:
                labels, masks = fk.fk_observe(graphs, rt.coup, graph_temps, kb_w[k],
                                              uniforms=bu)
            else:
                e_part, m_part, labels = fk.fk_update(
                    graphs, rt.coup, graph_temps, scal[k], kb_w[k],
                    wolff=wolff, with_measure=True, with_labels=collect, uniforms=bu)
                parts = (e_part.view(d, n_sys, -1), m_part.view(d, n_sys, -1))
            if collect and s >= warmup:
                _fold_fk_graphs(rt, acc, labels, masks, sid)
        do_pt = pt_on and s % cfg.pt_interval == 0
        draw = None if not do_pt else (draws[t] if pt_full
                                       else (draws[0][t], draws[1][t]))
        ev = ev_at.get(t)
        # pt_step reduces the partials into the sweep's rows (and, without a
        # move this sweep, takes the PT step in the same launch)
        with phase_scope("measure"):
            if parts is None:
                parts = measure_nb(flat, rt.coup, lat, tables=rt.tables)
            if pair_rows is not None:
                megapair.pair_overlap(flat, sid, pair_rows[0][:, t],
                                      pair_rows[1][:, t], n_replicas=R, lattice=lat,
                                      tables=rt.tables)
            if ev is None:
                parity = mega.pt_step(*parts, e[:, t], m[:, t], sid, *pt_state,
                                      rt.slot_temps, draw, sys_temps, do_pt=do_pt,
                                      parity=parity, **pt_kw)
            else:
                mega.pt_step(*parts, e[:, t], m[:, t], sid, *pt_state,
                             rt.slot_temps, None, sys_temps, do_pt=False,
                             parity=parity, **pt_kw)
        if ev is None:
            continue
        tasks, scal_ev, probes, words = events.table(ev)
        mode = ((s // h.interval) % len(h.modes))
        snap = (_snapshot(rt, flat, sid, tasks, mode, s)
                if si is not None and s % si == 0 and s >= warmup else None)
        want = events.wants(ev)
        moved = overlap.overlap_event(
            flat, sid, tasks, rt.coup, rt.temps, scal_ev, probes, words,
            kind=events.kinds[ev], wolff=h.cluster_mode == "wolff", shape=lat,
            with_labels=want or snap is not None,
            with_masks=want and events.observe, observe=events.observe,
            tables=rt.tables)
        if want:
            events.fold(ev, moved)
        if snap is not None:
            lab = lambda x: x.view(d, T, -1, n_sp)[0, :, 0]  # noqa: E731
            snap["cluster_ids"] = lab(moved.labels)
            if moved.blue is not None:
                snap["blue_ids"] = lab(moved.blue)
            acc.setdefault("snapshots", []).append(snap)
        if do_pt:
            e2 = (parts if events.observe
                  else overlap.energy_partials(flat, rt.coup, lat.shape) if lat.axes_form
                  else measure_nb(flat, rt.coup, lat, tables=rt.tables))
            parity = mega.pt_step(*e2, None, None, sid, *pt_state, rt.slot_temps, draw,
                                  sys_temps, do_pt=True, parity=parity, **pt_kw)
    state["counter"] = np.int32(counter + n)
    state["pt_parity"] = np.int32(parity)
    with phase_scope("measure"):
        _fold_records(rt, state, acc, e, m, s_begin, n)
        _fold_series(rt, state, acc, e, m, pair_rows, s_begin, n)
        if pair_rows is not None:
            _fold_pairs(rt, state, acc, *pair_rows, s_begin, n)


def run_chunk_space(rt: Runtime, cfg: SimConfig, state: dict, acc: dict,
                    s_begin: int, n: int) -> None:
    """The per-sweep path over the row bands of a ``space`` mesh (the
    reference's step body under its space axis, peapods_tpu/engine/
    loop.py:2723-2952 with ``_sweep_phase_halo`` :1541, ``_halo3d`` :1646,
    ``_halo_gen`` :1727 and the banded ``_cc_many`` :1463-1484), one replica,
    bitwise :func:`run_chunk_sweeps` at any band count.  ``state["bands"]``
    holds each band's spin window ``[d, S, n_window]`` on its device.  Per
    sweep:

    1. each colour pass: the halos copied from the neighbouring bands
       (``halo.exchange``), then ``halo.sweep_halo`` on every band; on the
       square and cubic lattices the last pass also measures, unless an FK
       update will;
    2. on FK sweeps: fresh halos, ``fk.fk_bonds_band`` on every band, the
       banded labels (``cc_band.banded_labels``: each band's window
       linked, the bands' boundary rows merged on the first device, every
       window site labelled, halos included; no host sync), each Wolff
       seed's label read from its band, and ``fk.fk_finish_band`` (which
       measures on the square, triangular and cubic lattices); the
       cluster-size histograms fold the bands' labels gathered on the first
       device;
    3. the measurement, unless made: fresh halos and ``halo.measure_halo``;
    4. the bands' partials gathered, in band order, on the mesh's first
       device for ``pt_step`` (the reference's psum over ``space``,
       loop.py:1602), which folds them in that order, then the records.

    Halos are copied only when a band's spins changed since the last copy.
    """
    sp = rt.space
    bands, devs = sp.bands, sp.devices
    c = cfg.cluster_update
    wolff = c is not None and c.mode == "wolff"
    pt_on = cfg.pt_interval is not None and rt.n_temps >= 2
    pt_full = cfg.pt_schedule == "full_ladder"
    lat = rt.lattice
    staged = not fk.fused_lattice(lat)
    d, n_sys, n_sp = rt.n_disorder, rt.n_systems, rt.n_spins
    n_graphs = d * n_sys
    dev = rt.device
    counter = int(state["counter"])
    base = state["base_keys"]
    warmup = int(state["warmup"])

    def on(x, k):
        """``x`` on band ``k``'s device."""
        return x if x is None or x.device == devs[k] else x.to(devs[k])

    sweep_w = _upload(seeds.sweep_words(base, counter, n, seeds.PH_SWEEP), dev)
    fk_t = ([t for t in range(n) if (s_begin + t) % c.interval == 0]
            if c is not None else [])
    fk_at = {t: k for k, t in enumerate(fk_t)}
    ccs = None
    if fk_t:
        kb, kf = seeds.fk_keys(base, counter + np.asarray(fk_t), n_sys)
        kb_w = _upload(kb.view(np.int32), dev)
        scal = _upload(seeds.fk_scalars(kf, n_sp, wolff=wolff), dev)
        ccs = [cc_band.BandCC.empty(n_graphs, b, dv) for b, dv in zip(bands, devs)]
    draws = None
    if pt_on:
        dr = seeds.pt_draws_jnp(base, counter, n, n_sys - 1, pt_full=pt_full)
        draws = (_upload(dr, dev) if pt_full
                 else tuple(_upload(x, dev) for x in dr))

    windows = state["bands"]
    graphs = [w.view(n_graphs, -1) for w in windows]
    sid = state["system_ids"].view(d, n_sys)
    sys_temps = slot_temps_for_systems(sid, rt.temps)
    pt_state = [state[k] for k in ("pt_edge_attempts", "pt_edge_acceptances",
                                   "pt_round_trips", "pt_trip_state")]
    e = torch.empty((d, n, n_sys), dtype=torch.float32, device=dev)
    m = torch.empty((d, n, n_sys), dtype=torch.int32, device=dev)
    parity = int(state["pt_parity"])
    gibbs = cfg.sweep_mode == "gibbs"
    collect = "fk_csd" in acc
    fresh = False  # the halos hold the neighbours' current edge rows

    def refresh():
        nonlocal fresh
        if not fresh:
            halo.exchange(windows, bands)
            fresh = True

    for t in range(n):
        k = fk_at.get(t)
        fk_measures = k is not None and not staged
        temps_b = [on(sys_temps, j) for j in range(len(bands))]
        words_b = [on(sweep_w[t], j) for j in range(len(bands))]
        parts = None
        with phase_scope("sweep"):
            for colour in range(lat.n_colors):
                refresh()
                measure = (colour == lat.n_colors - 1 and lat.checkerboard
                           and not fk_measures)
                out = [halo.sweep_halo(windows[j], sp.coup_fwd[j], sp.coup_bwd[j],
                                       sp.colours[j], temps_b[j], words_b[j], band,
                                       colour, gibbs=gibbs, measure=measure)
                       for j, band in enumerate(bands)]
                fresh = False
                if measure:
                    parts = out
        if k is not None:
            refresh()
            for j, band in enumerate(bands):
                fk.fk_bonds_band(graphs[j], sp.coup_fwd[j], temps_b[j].view(-1),
                                 on(kb_w[k], j), ccs[j], band)
            cc_band.banded_labels(ccs, bands)
            seed_lab = (fk.wolff_seed_labels(ccs, bands, scal[k][:, 2]) if wolff
                        else None)
            out = [fk.fk_finish_band(graphs[j], ccs[j], sp.coup_fwd[j], on(scal[k], j),
                                     on(seed_lab, j), band, wolff=wolff,
                                     measure=fk_measures)
                   for j, band in enumerate(bands)]
            fresh = False
            if fk_measures:
                parts = [(ep.view(d, n_sys, -1), mp.view(d, n_sys, -1))
                         for ep, mp in out]
            if collect and s_begin + t >= warmup:
                labels = torch.cat([cb.labels[:, b.interior].to(dev)
                                    for cb, b in zip(ccs, bands)], -1)
                _fold_fk_graphs(rt, acc, labels, None, sid)
        do_pt = pt_on and (s_begin + t) % cfg.pt_interval == 0
        with phase_scope("measure"):
            if parts is None:
                refresh()
                parts = [halo.measure_halo(windows[j], sp.coup_fwd[j], band)
                         for j, band in enumerate(bands)]
            e_part = torch.cat([p[0].to(dev) for p in parts], -1)
            m_part = torch.cat([p[1].to(dev) for p in parts], -1)
            parity = mega.pt_step(
                e_part, m_part, e[:, t], m[:, t], sid, *pt_state, rt.temps,
                None if not do_pt else (
                    draws[t] if pt_full else (draws[0][t], draws[1][t])),
                sys_temps, do_pt=do_pt, pt_full=pt_full, parity=parity,
                hot_slot=rt.hot_slot, cold_slot=rt.cold_slot, n_spins=n_sp)
    state["counter"] = np.int32(counter + n)
    state["pt_parity"] = np.int32(parity)
    with phase_scope("measure"):
        _fold_records(rt, state, acc, e, m, s_begin, n)
        _fold_series(rt, state, acc, e, m, None, s_begin, n)


def _event_tables(rt: Runtime, cfg: SimConfig, base, counter: int,
                  s_begin: int, n: int, fold=None):
    """The overlap moves of sweeps ``s_begin .. s_begin + n - 1``: on sweep
    ``s`` with ``s % interval == 0``, mode ``(s // interval) % n_modes``
    (loop.py:3550-3595), its tasks and scalars from the sweep's counter, a
    table per group size; uploaded as one
    :class:`~peapods_tpu_torch.ops.megapair.Events`, or ``None`` when the
    chunk has no move.  The moves of the sweeps past warmup are
    ``record``-ed for ``fold``; an observe run, whose moves change nothing,
    runs only those."""
    h = cfg.overlap_cluster
    if h is None:
        return None
    warmup = int(cfg.warmup_sweeps)
    observe = h.action == "observe"
    at = [t for t in range(n) if (s_begin + t) % h.interval == 0
          and not (observe and s_begin + t < warmup)]
    if not at:
        return None
    modes = [((s_begin + t) // h.interval) % len(h.modes) for t in at]
    wolff = h.cluster_mode == "wolff"
    dev = rt.device
    groups = [h.modes[m].group_size for m in modes]
    rows, tables = [0] * len(at), {}
    for g in sorted(set(groups)):
        sel = [i for i, x in enumerate(groups) if x == g]
        tasks, tkeys = seeds.overlap_tasks(base, counter + np.asarray(at)[sel],
                                           rt.n_replicas, rt.n_temps, g)
        b = tkeys.shape[1] * tkeys.shape[2]
        scal = np.empty((len(sel), b, 6), np.int32)
        probes = np.empty((len(sel), b, 64), np.int32)
        kinds = [h.modes[modes[i]].kind for i in sel]
        for kind in set(kinds):
            sub = [j for j, k in enumerate(kinds) if k == kind]
            sc, pr = seeds.event_scalars(kind, wolff, tkeys[sub], rt.n_spins)
            scal[sub] = sc.reshape(len(sub), -1, 6)
            probes[sub] = pr.reshape(len(sub), -1, 64)
        words = tkeys.view(np.int32).reshape(len(sel), -1, 2)
        tables[g] = tuple(_upload(x, dev) for x in (tasks, scal, probes, words))
        for j, i in enumerate(sel):
            rows[i] = j
    record = frozenset(k for k, t in enumerate(at) if s_begin + t >= warmup)
    return megapair.Events(
        at=at, kinds=[h.modes[m].kind for m in modes], groups=groups, rows=rows,
        tables=tables, observe=observe, record=record,
        fold=None if fold is None else (lambda k, graphs: fold(modes[k], graphs)))


def _fold_overlap_graphs(rt: Runtime, cfg: SimConfig, acc: dict, mode: int,
                         graphs) -> None:
    """Add one recorded overlap move's stats graphs (mode ``mode``, tasks
    ``[d T G]``) to the sums (the reference's ``_task_stats`` and its
    ``rec_i_evt``-gated adds, peapods_tpu/engine/loop.py:2517-2536,
    3554-3590): per temperature the cluster-size histogram ``overlap_csd``
    and the top-4 sizes ``top4_sum`` (summed over the groups, over n_spins)
    of the mode, one more move in ``top4_n``; on observe runs the graph
    observations of the move's kind in ``ov_obs_<kind>`` (columns of
    ``records.FK_OBS``: the groups observed, their top-4 sizes, active
    bonds, large components and winding flags on the canonical 2D
    square)."""
    h = cfg.overlap_cluster
    kind = h.modes[mode].kind
    d, T = rt.n_disorder, rt.n_temps
    labels = graphs.stats
    counts = component_counts(labels)
    by_temp = lambda x: x.reshape(d, T, -1, *x.shape[1:]).sum(2, dtype=torch.int64)  # noqa: E731
    acc["overlap_csd"][:, mode] += by_temp(csd_histogram(counts))
    acc["top4_sum"][:, mode] += (by_temp(top4_sizes(counts)).to(torch.float64)
                                 / rt.n_spins)
    acc["top4_n"][:, mode] += 1
    if h.action != "observe":
        return
    wind = None
    if rt.lattice.canonical_square:
        wind = winding.winding_flags(graphs.masks, labels, rt.lattice.shape,
                                     errors=acc["winding_errors"])
    g = graph_observation(graphs.masks, counts, wind)
    wx, wy = g.winding_x, g.winding_y
    cols = torch.cat([torch.ones_like(g.active_bonds)[:, None], g.top4,
                      g.active_bonds[:, None], g.large_components[:, None],
                      torch.stack([wx, wy, wx | wy, wx & wy], -1).to(torch.int32)], -1)
    acc[f"ov_obs_{kind}"] += by_temp(cols)


def run_chunk_pairs(rt: Runtime, cfg: SimConfig, state: dict, acc: dict,
                    s_begin: int, n: int) -> None:
    """The replica path (the reference's ``_megapair_chunk_runner``,
    peapods_tpu/engine/loop.py:3205-3741): the host makes the chunk's sweep
    words, PT draws (the pairs megakernel's murmur draws of the PT words,
    made on the device) and overlap-move tables, and
    :func:`~peapods_tpu_torch.ops.megapair.pairs_chunk` runs the sweeps; the
    records, taken before each move, are folded into the sums."""
    R, T = rt.n_replicas, rt.n_temps
    pt_on = cfg.pt_interval is not None and T >= 2
    pt_full = cfg.pt_schedule == "full_ladder"
    dev = rt.device
    counter = int(state["counter"])
    base = state["base_keys"]
    sweep_w = _upload(seeds.sweep_words(base, counter, n, seeds.PH_SWEEP), dev)
    draws = None
    if pt_on:
        pt_w = _upload(seeds.sweep_words(base, counter, n, seeds.PH_PT), dev)
        dr = pt_draws_pairs(pt_w, R, T - 1, pt_full=pt_full)
        draws = (dr.contiguous() if pt_full
                 else (dr[0].to(torch.int32).contiguous(), dr[1].contiguous()))
    fold = None
    if "overlap_csd" in acc:
        fold = lambda mode, graphs: _fold_overlap_graphs(rt, cfg, acc, mode, graphs)  # noqa: E731
    events = _event_tables(rt, cfg, base, counter, s_begin, n, fold)
    d = rt.n_disorder
    h = cfg.overlap_cluster
    # the chunk's launches (sweeps, pair measurements, moves, PT) in one
    # "sweep" scope, as on the mega path
    with phase_scope("sweep"):
        e, m, qs, ql, parity = megapair.pairs_chunk(
            state["spins"], rt.jgrids, rt.coup, rt.temps, rt.slot_temps,
            state["system_ids"].view(d, -1), state["pt_edge_attempts"],
            state["pt_edge_acceptances"], state["pt_round_trips"],
            state["pt_trip_state"], sweep_w, draws, events,
            shape=rt.lattice.shape, n_replicas=R, sweep_base=s_begin,
            parity=int(state["pt_parity"]), gibbs=cfg.sweep_mode == "gibbs",
            pt_interval=cfg.pt_interval if pt_on else None, pt_full=pt_full,
            hot_slot=rt.hot_slot, cold_slot=rt.cold_slot,
            wolff=h is not None and h.cluster_mode == "wolff",
        )
    state["counter"] = np.int32(counter + n)
    state["pt_parity"] = np.int32(parity)
    with phase_scope("measure"):
        _fold_records(rt, state, acc, e, m, s_begin, n)
        _fold_series(rt, state, acc, e, m, (qs, ql) if rt.n_pairs else None,
                     s_begin, n)
        if rt.n_pairs:
            _fold_pairs(rt, state, acc, qs, ql, s_begin, n)
