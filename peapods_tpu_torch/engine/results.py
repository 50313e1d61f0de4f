"""Assembly of the public results dict for the slice.

Counterpart of the subset of ``HostAccum.finalize``
(``peapods_tpu/engine/results.py:244-346``) that the slice produces: the
magnetization and energy moments, ``per_disorder.parallel_tempering`` when
PT is configured, and the FK cluster-size histograms ``fk_csd`` when
cluster statistics are collected, with the reference's keys, dtypes and
presence rules.
"""

from __future__ import annotations

import numpy as np

from .records import REC

__all__ = ["finalize"]


def finalize(rec_sums: np.ndarray, n_recorded: int, n_replicas: int,
             pt_state: dict | None, fk_csd: np.ndarray | None = None) -> dict:
    """Build the results dict.

    Args:
        rec_sums: f64 ``[d, N_REC, T]`` record sums.
        n_recorded: number of recorded sweeps.
        pt_state: numpy ``pt_edge_attempts``, ``pt_edge_acceptances`` and
            ``pt_round_trips`` when PT is configured, else ``None``.
        fk_csd: integer ``[d, T, n_spins + 1]`` cluster-size histograms of
            the recorded FK updates per temperature, when collected.
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
