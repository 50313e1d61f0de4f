"""Row layout of the per-temperature record sums (no backend).

The same rows, in the same order, as ``REC`` / ``N_REC`` in
``peapods_tpu/engine/loop.py:59-81``; the slice fills the magnetization and
energy rows.
"""

__all__ = ["REC", "N_REC"]

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
