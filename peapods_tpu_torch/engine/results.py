"""Assembly of the public results dict for the slice.

Counterpart of the subset of ``HostAccum.finalize``
(``peapods_tpu/engine/results.py:244-346``) that the slice produces: the
magnetization and energy moments, the overlap and link-overlap moments
with the P(q) histograms and ``ql_at_q`` sums when there are replica pairs
(and their ``per_sample_*`` copies with more than one realization),
``per_disorder.parallel_tempering`` when PT is configured,
``per_disorder.cluster_observations`` (``fk`` on FK observe runs;
``houdayer``, ``jorg`` and ``cmr_blue`` on overlap observe runs), the FK
cluster-size histograms ``fk_csd`` when cluster statistics are collected,
the overlap moves' ``overlap_csd`` and ``top_cluster_sizes``, their
``cluster_snapshots``, the integrated autocorrelation times ``mags2_tau``
/ ``overlap2_tau`` and the equilibration curves ``equil_*``, with the
reference's keys, dtypes and presence rules.
"""

from __future__ import annotations

import numpy as np

from ..utils.autocorr import AutocorrStream
from .records import FK_OBS, REC

__all__ = ["finalize", "autocorr_streams", "equil_snaps"]


def autocorr_streams(acc: dict, d: int, t: int) -> list:
    """The run's m2_ac (and, with replica pairs, q2_ac) autocorrelation
    streams over ``d * t`` features: the fft backend's host streams, or
    ring streams holding the device ring's sums (the reference's
    ``drain_device_acc``, peapods_tpu/engine/results.py:166-191); ``[]``
    without autocorrelation."""
    if "ac_stream" in acc:
        return [acc[k] for k in ("ac_stream", "ac_stream_q") if k in acc]
    if "ac_sum" not in acc:
        return []
    sp, so, so2 = (acc[k].cpu().numpy() for k in ("ac_sum_prod", "ac_sum", "ac_sum2"))
    f = d * t
    streams = []
    for ci in range(sp.shape[1] // f):
        cols = slice(ci * f, (ci + 1) * f)
        stream = AutocorrStream(sp.shape[0] - 1, f, "ring")
        stream._sum_prod = np.ascontiguousarray(sp[:, cols])
        stream.sum_o = np.ascontiguousarray(so[cols])
        stream.sum_o2 = np.ascontiguousarray(so2[cols])
        stream.n_recorded = int(acc["ac_count"])
        streams.append(stream)
    return streams


def equil_snaps(acc: dict, n_sweeps: int) -> list:
    """The equilibration checkpoints ``(count, e_avg [d, T], ql_avg [d,
    T])`` at the sweep counts 128 * 2**k below ``n_sweeps`` and at
    ``n_sweeps`` (peapods_tpu/engine/results.py:60-73, :184-197); ``[]``
    without the diagnostic."""
    if "eq_sum" not in acc:
        return []
    ck = acc["eq_ckpt"].cpu().numpy()
    sums = acc["eq_sum"].cpu().numpy()
    counts = []
    p = 128
    while p < n_sweeps:
        counts.append(p)
        p *= 2
    counts.append(n_sweeps)
    snaps = []
    for c in counts:
        # c == 128 * 2**j below n_sweeps; the full run from the sums
        avg = sums / n_sweeps if c == n_sweeps else ck[c.bit_length() - 8]
        snaps.append((c, avg[:, 0], avg[:, 1]))
    return snaps


def finalize(rec_sums: np.ndarray, n_recorded: int, n_replicas: int,
             pt_state: dict | None, fk_csd: np.ndarray | None = None,
             pairs: dict | None = None, fk_obs: dict | None = None,
             overlap: dict | None = None, snapshots: list | None = None,
             streams: list | None = None, equil: list | None = None) -> dict:
    """Build the results dict.

    Args:
        rec_sums: f64 ``[d, N_REC, T]`` record sums.
        n_recorded: number of recorded sweeps.
        pt_state: numpy ``pt_edge_attempts``, ``pt_edge_acceptances`` and
            ``pt_round_trips`` when PT is configured, else ``None``.
        fk_csd: integer ``[d, T, n_spins + 1]`` cluster-size histograms of
            the recorded FK updates per temperature, when collected.
        pairs: with replica pairs, ``n_pairs``, ``n_bonds``
            (:func:`~.records.link_bonds`) and the integer ``[d, T, n_spins + 1]`` arrays
            ``q_hist``, ``ql_at_q`` and ``ql2_at_q`` (sums of the link
            overlap integers ``ql`` and ``ql**2`` at each q bin).
        fk_obs: on FK observe runs, ``sums`` (the integer ``[d, T,
            N_FK_OBS]`` sums of the graph observations, columns
            ``records.FK_OBS``), ``n_spins``, ``n_neighbors`` and
            ``with_winding``; their histograms are ``fk_csd``.
        overlap: when the overlap moves collect statistics, ``overlap_csd``
            (integer ``[d, n_modes, T, n_spins + 1]``), ``top4_sum`` (f64
            ``[d, n_modes, T, 4]``), ``top4_n`` (integer ``[d, n_modes]``),
            ``kinds`` (each mode's move kind), ``n_pairs``, and for observe
            runs ``obs`` (per kind used, the integer ``[d, T, N_FK_OBS]``
            sums) with ``n_spins``, ``n_neighbors`` and ``with_winding``.
        snapshots: the overlap moves' snapshots in the reference's form
            (``cluster_snapshots``), when any was taken.
        streams: :func:`autocorr_streams`: each realization's Sokal tau of
            m2_ac (and q2_ac), averaged over the realizations.
        equil: :func:`equil_snaps`.
    """
    d, _, t = rec_sums.shape
    result = {}
    # mean over (recorded sweeps x replicas), then disorder (results.rs:166-259)
    denom = max(n_recorded * n_replicas, 1)
    for key, row in (("mags", "m_sum"), ("mags2", "m2_sum"),
                     ("mags4", "m4_sum"), ("energies", "e_sum"),
                     ("energies2", "e2_sum")):
        per_d = (rec_sums[:, REC[row], :] / denom if n_recorded
                 else np.full((d, t), np.nan))
        result[key] = per_d.mean(0)
    if pairs is not None:
        # mean over (recorded sweeps x pairs), then disorder
        # (peapods_tpu/engine/results.py:268-287)
        denom_p = max(n_recorded * pairs["n_pairs"], 1)
        for key, row in (("overlap", "q_sum"), ("overlap2", "q2_sum"),
                         ("overlap4", "q4_sum"), ("link_overlap", "ql_sum"),
                         ("link_overlap2", "ql2_sum"),
                         ("link_overlap4", "ql4_sum")):
            per_p = (rec_sums[:, REC[row], :] / denom_p if n_recorded
                     else np.full((d, t), np.nan))
            result[key] = per_p.mean(0)
        q_hist = pairs["q_hist"].astype(np.uint64)
        nb = float(pairs["n_bonds"])
        ql_at_q = pairs["ql_at_q"].astype(np.float64) / nb
        ql2_at_q = pairs["ql2_at_q"].astype(np.float64) / (nb * nb)
        hist_sum = q_hist.sum(0)  # aggregated over disorder
        result["overlap_histogram"] = [hist_sum[i] for i in range(t)]
        result["ql_at_q_sum"] = ql_at_q.sum(0)
        result["ql2_at_q_sum"] = ql2_at_q.sum(0)
        if d > 1:
            result["per_sample_overlap_histogram"] = q_hist
            result["per_sample_ql_at_q_sum"] = ql_at_q
            result["per_sample_ql2_at_q_sum"] = ql2_at_q
    per_disorder = {}
    obs_sets = []
    if fk_obs is not None:
        obs_sets.append(("fk", fk_obs["sums"], fk_csd, fk_obs))
    if overlap is not None:
        for kind, sums in overlap["obs"].items():
            # a kind's histograms are those of its modes
            csd = sum(overlap["overlap_csd"][:, m] for m, k in
                      enumerate(overlap["kinds"]) if k == kind)
            obs_sets.append(("cmr_blue" if kind == "cmr" else kind, sums, csd,
                             overlap))
    observations = {}
    for name, sums, csd, meta in obs_sets:
        count = sums[..., FK_OBS["count"]][..., 0]
        if not (count.sum(1) > 0).all():
            # the kind is kept only when every realization observed a graph
            # (peapods_tpu/engine/results.py:289-327)
            continue
        safe = np.maximum(count, 1)[..., None].astype(np.float64)

        def mean(key, scale=1.0):
            total = sums[..., FK_OBS[key]].astype(np.float64)
            return np.where(count[..., None] > 0, total / scale / safe, 0.0)

        n = meta["n_spins"]
        graph = {
            "observation_count": count.astype(np.uint64),
            "cluster_size_counts": csd.astype(np.uint64),
            "top_four_component_fractions": mean("top4", n),
            "active_bond_density": mean("bonds", n * meta["n_neighbors"])[..., 0],
            "large_component_count": mean("large")[..., 0],
        }
        if meta["with_winding"]:
            wind = mean("winding")
            for k, wname in enumerate(("winding_x", "winding_y", "winding_either",
                                       "winding_both")):
                graph[wname] = wind[..., k]
        observations[name] = graph
    if observations:
        per_disorder["cluster_observations"] = observations
    if pt_state is not None:
        per_disorder["parallel_tempering"] = {
            "edge_attempts": pt_state["pt_edge_attempts"].astype(np.uint64),
            "edge_acceptances": pt_state["pt_edge_acceptances"].astype(np.uint64),
            "round_trips": pt_state["pt_round_trips"]
            .astype(np.uint64)
            .reshape(d, n_replicas, t),
        }
    if per_disorder:
        result["per_disorder"] = per_disorder
    if fk_csd is not None and fk_csd.sum() > 0:
        # summed over realizations, one uint64 histogram per temperature
        # (peapods_tpu/engine/results.py:344-346)
        agg = fk_csd.astype(np.uint64).sum(0)
        result["fk_csd"] = [agg[i] for i in range(t)]
    if overlap is not None:
        csd = overlap["overlap_csd"]
        n_modes = csd.shape[1]
        if csd.sum() > 0:
            # per mode, one uint64 histogram per temperature summed over the
            # realizations (peapods_tpu/engine/results.py:348-353)
            agg = csd.astype(np.uint64).sum(0)
            result["overlap_csd"] = [[agg[m, i] for i in range(t)]
                                     for m in range(n_modes)]
        top4_n = overlap["top4_n"]
        if top4_n.sum() > 0:
            # per-realization average, then the disorder mean, over the moves
            # times n_pairs whatever the mode's group size, as the reference
            # divides (peapods_tpu/engine/results.py:355-365)
            tops = []
            for m in range(n_modes):
                counts = top4_n[:, m].astype(np.float64)
                if counts.sum() == 0:
                    tops.append(np.zeros((0, 4), np.float64))
                    continue
                denom = np.maximum(counts * overlap["n_pairs"], 1.0)[:, None, None]
                tops.append((overlap["top4_sum"][:, m] / denom).mean(0))
            result["top_cluster_sizes"] = tops
    # peapods_tpu/engine/results.py:367-380
    for key, stream in zip(("mags2_tau", "overlap2_tau"), streams or ()):
        result[key] = stream.taus().reshape(d, t).mean(0)
    if equil:
        result["equil_sweeps"] = np.array([x[0] for x in equil], np.uint64)
        result["equil_energy_avg"] = np.stack([x[1].mean(0) for x in equil])
        result["equil_link_overlap_avg"] = np.stack([x[2].mean(0) for x in equil])
    if snapshots:
        # peapods_tpu/engine/results.py:382-383
        result["cluster_snapshots"] = snapshots
    return result
