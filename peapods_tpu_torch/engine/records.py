"""Row layout of the per-temperature record sums (no backend).

The same rows, in the same order, as ``REC`` / ``N_REC`` in
``peapods_tpu/engine/loop.py:59-81``; the slice fills the magnetization and
energy rows.  ``FK_OBS`` lays out the integer sums of the graph
observations per (realization, temperature), the columns of the
reference's ``_zero_obs`` (:486-495) but the histograms: FK observe's sums
(whose histograms are ``fk_csd``) and overlap observe's, one per move kind
(whose histograms are the ``overlap_csd`` rows of that kind's modes).
``link_bonds`` is the count the link-overlap rows divide by.  ``SERIES``
lays out the per-sweep series of autocorrelation and the equilibration
diagnostic (the reference's ``SERIES``, :85-89), ``N_EQ_SLOTS`` the
equilibration checkpoints kept at sweep counts 128 * 2**k (:93-97).
"""

__all__ = ["REC", "N_REC", "FK_OBS", "N_FK_OBS", "SERIES", "N_SERIES", "N_EQ_SLOTS",
           "link_bonds"]


def link_bonds(lattice) -> int:
    """The bonds the link overlap q_l is a mean over: each site's bonds to
    its neighbours at the lattice's offsets, ``n_spins * n_neighbors`` (the
    reference's ``_measure_phase``, ``peapods_tpu/engine/loop.py:2651``)."""
    return lattice.n_spins * lattice.n_neighbors

REC = {
    name: i
    for i, name in enumerate(
        [
            "m_sum",  # sum over replicas of m per temp
            "m2_sum",
            "m4_sum",
            "e_sum",
            "e2_sum",
            "q_sum",  # sum over pairs of q per temp
            "q2_sum",
            "q4_sum",
            "ql_sum",
            "ql2_sum",
            "ql4_sum",
            "m2_ac",  # replica-averaged m^2 (autocorrelation series)
            "q2_ac",  # pair-averaged q^2
            "diag_e",  # replica-averaged energy (equilibration series)
            "diag_ql",  # pair-averaged link overlap
        ]
    )
}
N_REC = len(REC)

# the observed graphs, then the sums of their top-4 component sizes, active
# bonds, large components and winding flags (x, y, either, both)
FK_OBS = {"count": slice(0, 1), "top4": slice(1, 5), "bonds": slice(5, 6),
          "large": slice(6, 7), "winding": slice(7, 11)}
N_FK_OBS = 11

# per sweep and temperature: the replica mean of (m / N)^2, the pair mean of
# q^2 (the autocorrelation series), the replica mean of e and the pair mean
# of q_l (the equilibration diagnostic's)
SERIES = {"m2_ac": 0, "q2_ac": 1, "diag_e": 2, "diag_ql": 3}
N_SERIES = len(SERIES)

# equilibration checkpoints at sweep counts 128 * 2**k (equilibration.rs:
# 17-59); 24 slots reach ~1e9 sweeps, and the last checkpoint, the full run,
# comes from the running sums
N_EQ_SLOTS = 24
