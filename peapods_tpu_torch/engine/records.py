"""Row layout of the per-temperature record sums (no backend).

The same rows, in the same order, as ``REC`` / ``N_REC`` in
``peapods_tpu/engine/loop.py:59-81``; the slice fills the magnetization and
energy rows.  ``FK_OBS`` lays out the integer sums of the graph
observations per (realization, temperature), the columns of the
reference's ``_zero_obs`` (:486-495) but the histograms: FK observe's sums
(whose histograms are ``fk_csd``) and overlap observe's, one per move kind
(whose histograms are the ``overlap_csd`` rows of that kind's modes).
``link_bonds`` is the count the link-overlap rows divide by.
"""

__all__ = ["REC", "N_REC", "FK_OBS", "N_FK_OBS", "link_bonds"]


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
