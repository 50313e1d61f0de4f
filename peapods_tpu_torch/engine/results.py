"""Assembly of the public results dict for the slice.

Counterpart of the subset of ``HostAccum.finalize``
(``peapods_tpu/engine/results.py:244-346``) that the slice produces: the
magnetization and energy moments, the overlap and link-overlap moments
with the P(q) histograms and ``ql_at_q`` sums when there are replica pairs
(and their ``per_sample_*`` copies with more than one realization),
``per_disorder.parallel_tempering`` when PT is configured, and the FK
cluster-size histograms ``fk_csd`` when cluster statistics are collected,
with the reference's keys, dtypes and presence rules.
"""

from __future__ import annotations

import numpy as np

from .records import REC

__all__ = ["finalize"]


def finalize(rec_sums: np.ndarray, n_recorded: int, n_replicas: int,
             pt_state: dict | None, fk_csd: np.ndarray | None = None,
             pairs: dict | None = None) -> dict:
    """Build the results dict.

    Args:
        rec_sums: f64 ``[d, N_REC, T]`` record sums.
        n_recorded: number of recorded sweeps.
        pt_state: numpy ``pt_edge_attempts``, ``pt_edge_acceptances`` and
            ``pt_round_trips`` when PT is configured, else ``None``.
        fk_csd: integer ``[d, T, n_spins + 1]`` cluster-size histograms of
            the recorded FK updates per temperature, when collected.
        pairs: with replica pairs, ``n_pairs``, ``n_bonds`` (n_spins
            n_dims) and the integer ``[d, T, n_spins + 1]`` arrays
            ``q_hist``, ``ql_at_q`` and ``ql2_at_q`` (sums of the link
            overlap integers ``ql`` and ``ql**2`` at each q bin).
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
    if pt_state is not None:
        result["per_disorder"] = {
            "parallel_tempering": {
                "edge_attempts": pt_state["pt_edge_attempts"].astype(np.uint64),
                "edge_acceptances":
                    pt_state["pt_edge_acceptances"].astype(np.uint64),
                "round_trips": pt_state["pt_round_trips"]
                .astype(np.uint64)
                .reshape(d, n_replicas, t),
            }
        }
    if fk_csd is not None and fk_csd.sum() > 0:
        # summed over realizations, one uint64 histogram per temperature
        # (peapods_tpu/engine/results.py:344-346)
        agg = fk_csd.astype(np.uint64).sum(0)
        result["fk_csd"] = [agg[i] for i in range(t)]
    return result
