"""Per-system energy and magnetization, recomputed from the spins.

Counterpart of ``peapods_tpu/ops/energy.py``: the recompute oracle for the
fused measurement.  The reported "energy" keeps the reference's sign: the
positive forward-bond sum per spin, ``e = +sum_{i,d} J[i,d] s_i s_fwd / N``.

:func:`measure_nb` measures the per-sweep path on the coloured lattices
(``csrc/sweep_nb.cu``): per-block partial sums of e and m on CUDA tensors
(counted in :data:`LAUNCHES`), :func:`measure_nb_plain` on CPU tensors;
:func:`site_energies` is both measurement kernels' per-site order of adds.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .lattice import check_tables

__all__ = ["LAUNCHES", "bond_sums", "energies_and_mags", "per_spin", "site_energies",
           "measure_nb", "measure_nb_plain", "measure_per", "TableMeasurePlan",
           "table_measure_plan"]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"measure_nb": 0, "measure_nb_table": 0}


def per_spin(total, n_spins: int):
    """``total / n_spins`` as an IEEE division on every device, as the
    kernels and the reference divide.  On CUDA, torch turns a division by a
    Python scalar into a multiplication by its reciprocal, which rounds
    differently unless ``n_spins`` is a power of two."""
    return total / torch.full_like(total, float(n_spins))


def bond_sums(spins, coup_fwd, shape, offsets=None):
    """f32 ``[...]`` forward-bond energy sums ``sum_{i,d} J s_i s_fwd`` of
    int8 spins ``[..., n_spins]`` on a 2D or 3D lattice ``shape`` with
    forward ``offsets`` (one per axis when ``None``) and forward couplings
    ``[..., n_spins, n_offsets]`` (broadcast against the spins' leading
    axes); the offsets' sums are added in order (``energies``,
    peapods_tpu/ops/energy.py:28-34)."""
    shape = tuple(shape)
    nd = len(shape)
    if offsets is None:
        offsets = np.eye(nd, dtype=np.int64)
    s = spins.to(torch.float32).reshape(*spins.shape[:-1], *shape)
    tot = torch.zeros(spins.shape[:-1], dtype=torch.float32, device=s.device)
    spatial = tuple(range(-nd, 0))
    lead = coup_fwd.shape[:-2]
    for d, off in enumerate(offsets):
        # s at the forward neighbour
        fwd = torch.roll(s, tuple(-int(o) for o in off), spatial)
        tot = tot + (s * fwd * coup_fwd[..., d].reshape(*lead, *shape)).sum(spatial)
    return tot


def energies_and_mags(spins, coup_fwd, shape, offsets=None):
    """``(e f32 [...], m int32 [...])`` of int8 spins ``[..., n_spins]``
    with forward couplings ``[n_spins, n_offsets]`` on a 2D or 3D lattice
    (``energies_and_mags``, peapods_tpu/ops/energy.py:37-41)."""
    m = spins.to(torch.int32).sum(-1, dtype=torch.int32)
    return per_spin(bond_sums(spins, coup_fwd, shape, offsets), spins.shape[-1]), m


def site_energies(spins, coup_fwd, shape, offsets=None):
    """f32 ``[..., n_spins]``: each site's forward-bond energy ``0 + (s_i
    s_fwd) J[i, d]``, added over the offsets in order (one per axis when
    ``None``), as ``measure_nb`` and ``energy_partials`` add a site's
    terms; int8 spins ``[..., n_spins]``, couplings ``[..., n_spins,
    n_offsets]`` (broadcast)."""
    shape = tuple(shape)
    if offsets is None:
        offsets = np.eye(len(shape), dtype=np.int64)
    s = spins.to(torch.float32)
    g = s.reshape(*s.shape[:-1], *shape)
    spatial = tuple(range(-len(shape), 0))
    e = torch.zeros_like(s)
    for d, off in enumerate(offsets):
        fwd = torch.roll(g, tuple(-int(o) for o in off), spatial).reshape(s.shape)
        e = e + s * fwd * coup_fwd[..., d]
    return e


def measure_nb_plain(spins, coup_fwd, lattice, blocks=False):
    """Plain version of ``measure_nb``: ``(e_part f32 [d, S, 1], m_part
    int32 [d, S, 1])``, the forward-bond energy sum and the magnetization
    of spins int8 ``[d, S, n_spins]`` with couplings ``[d, n_spins,
    n_neighbors]``; with ``blocks`` the kernel's partials ``[d, S,
    nb_blocks]``, one a block of 256 groups of four sites, added as the
    kernel adds them (:func:`site_energies`, then
    :func:`~.fk.block_partials_plain` with four sites a thread)."""
    if blocks:
        from .fk import block_partials_plain

        e = site_energies(spins, coup_fwd[:, None], lattice.shape, lattice.offsets)
        return (block_partials_plain(e, 4),
                block_partials_plain(spins.to(torch.int32), 4))
    e = bond_sums(spins, coup_fwd[:, None], lattice.shape, lattice.offsets)
    m = spins.to(torch.int32).sum(-1, dtype=torch.int32)
    return e[..., None], m[..., None]


def measure_per(n_spins: int, n_disorder: int, n_systems: int, threads: int) -> int:
    """The systems a thread of ``measure_nb`` takes, reading its couplings
    once for them: ``sweep.systems_per`` of the launch's groups of four
    sites against ``threads`` (an eighth of the card's resident threads:
    tools/probe_measure.py, NVIDIA H100 80GB HBM3, 32^3 x 16 0.0050 ms a
    launch with 1, 0.0042 with 2 (65,536 threads); at the staged shapes,
    8,192 threads, 2 systems ran 9-16% slower than 1)."""
    from .sweep import systems_per

    return systems_per(-(-n_spins // 4), n_disorder, n_systems, threads)


# csrc/sweep_nb.cu kMaxPer, kThreads: the most systems a thread of
# measure_nb_table takes (its CTA's shared rows), and a CTA's threads, a
# block of 256 groups of four sites
TABLE_MEASURE_MAX_PER = 8
TABLE_MEASURE_THREADS = 256


class TableMeasurePlan(NamedTuple):
    """``measure_nb_table``'s launch: the systems a thread (``per``), the
    grid ``(blocks, n_systems / per, n_disorder)`` and a CTA's static shared
    memory in bytes (``per`` rows of 256 partial sums of e and m)."""

    per: int
    grid: tuple
    smem: int


@functools.lru_cache(maxsize=None)
def table_measure_plan(n_spins: int, n_disorder: int, n_systems: int, threads: int,
                       sms: int) -> TableMeasurePlan:
    """The table form's measurement of ``n_disorder`` x ``n_systems``
    systems of ``n_spins`` sites, from the shape alone: a thread a group of
    four sites of ``per`` systems of one realization, reading the group's
    table rows and couplings once for them: the largest divisor of
    ``n_systems`` up to :data:`TABLE_MEASURE_MAX_PER` whose launch still
    has ``threads`` threads (an eighth of the card's resident threads, as
    :func:`measure_per`) and at least ``sms`` CTAs (one a streaming
    multiprocessor); 1 where none has."""
    groups = -(-int(n_spins) // 4)
    blocks = -(-groups // TABLE_MEASURE_THREADS)
    d, s = int(n_disorder), int(n_systems)
    fits = [p for p in range(1, min(s, TABLE_MEASURE_MAX_PER) + 1)
            if s % p == 0 and groups * d * (s // p) >= threads and blocks * d * (s // p) >= sms]
    per = max(fits, default=1)
    return TableMeasurePlan(per, (blocks, s // per, d),
                            8 * TABLE_MEASURE_MAX_PER * TABLE_MEASURE_THREADS)


def measure_nb(spins, coup_fwd, lattice, per=None, tables=None):
    """The (e, m) partials of every (realization, system) on a coloured
    lattice (see :func:`measure_nb_plain`): the plain version for CPU
    tensors, the ``measure_nb`` kernel for CUDA tensors, whose partials have
    one entry per block of 1024 sites, bitwise ``measure_nb_plain(...,
    blocks=True)``.  ``per``: the systems a thread, in place of
    :func:`measure_per`'s.  A table lattice (:attr:`~.lattice.Lattice.table`)
    takes the table form, ``measure_nb_table``, on its device ``tables``
    (:func:`~.lattice.check_tables`), ``per`` in place of
    :func:`table_measure_plan`'s."""
    if _build.device_kind(spins) == "cpu":
        return measure_nb_plain(spins, coup_fwd, lattice)
    from .fk import resident_threads

    dev = spins.device
    d, n_sys, n = spins.shape
    _build.expect(spins, "spins", torch.int8, (d, n_sys, lattice.n_spins), dev)
    _build.expect(coup_fwd, "coup_fwd", torch.float32, (d, n, lattice.n_neighbors),
                  dev)
    if d > 65535 or n_sys > 65535:
        raise ValueError("at most 65535 realizations and systems")
    if coup_fwd.data_ptr() % 16:
        raise ValueError("coup_fwd must be 16-byte aligned")
    lib = _build.library()
    nb = lib.peapods_nb_blocks(n)
    e_part = torch.empty((d, n_sys, nb), dtype=torch.float32, device=dev)
    m_part = torch.empty((d, n_sys, nb), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lattice.table:
        fwd, _ = check_tables(tables, lattice, dev)
        if fwd.data_ptr() % 16:
            raise ValueError("the forward table must be 16-byte aligned")
        if not per:
            sms = torch.cuda.get_device_properties(dev.index).multi_processor_count
            per = table_measure_plan(n, d, n_sys, resident_threads(dev.index) // 8, sms).per
        _build.check(lib.peapods_measure_nb_table(
            spins.data_ptr(), coup_fwd.data_ptr(), fwd.data_ptr(), e_part.data_ptr(),
            m_part.data_ptr(), n, lattice.n_neighbors, d, n_sys, per, stream),
            "measure_nb_table")
        LAUNCHES["measure_nb_table"] += 1
        return e_part, m_part
    per = per or measure_per(n, d, n_sys, resident_threads(dev.index) // 8)
    _build.check(lib.peapods_measure_nb(
        spins.data_ptr(), coup_fwd.data_ptr(), lattice.sweep_words.ctypes.data,
        e_part.data_ptr(), m_part.data_ptr(), d, n_sys, per, stream), "measure_nb")
    LAUNCHES["measure_nb"] += 1
    return e_part, m_part
