"""The replica path: sweeps, pair measurement, PT on each replica's ladder
and the pair overlap moves of a chunk.

Counterpart of ``peapods_tpu/ops/pallas_megapair.py`` (``supports_megapair``
:114-143, ``megapair_chunk`` :1111-1309, ``pt_event_jnp`` :1314-1413) and of
the megapair runner that interleaves it with the overlap moves
(``peapods_tpu/engine/loop.py:3205-3741``).  The TPU keeps every slot of a
realization in VMEM and runs the interval between two moves as one Pallas
call; on the H100 a sweep ``s`` of a realization is, on the current stream
and with no host synchronisation inside a chunk::

    colour_pass(colour 0) -> colour_pass(colour 1, partial e and m sums)
        -> pair_overlap (q and q_l of every pair at every temperature)
        -> pt_step (the sweep's (e, m) rows; PT on each ladder when
           s % pt_interval == 0)

and on a move's sweep (``s % interval == 0``) the records are still taken
before the move, and PT runs on energies re-derived from the moved spins
(loop.py:3550-3612; the reference cites mod.rs:748-754)::

    ... -> pair_overlap -> pt_step (rows only) -> the move's ov_* kernels
        -> energy_partials -> pt_step (PT only)

An observed move (``overlap_cluster_action="observe"``) writes no spin,
so PT then reads the sweep's own (e, m), as a run without the move does.
A move whose statistics are collected hands its stats graph to the
caller's fold (:class:`Events`) right after its launches.

``colour_pass`` and ``pt_step`` are the mega path's kernels
(``csrc/mega.cu``) with a 3D body and ``R`` ladders; ``pair_overlap`` is
``csrc/pairs.cu``; the move is :mod:`~peapods_tpu_torch.ops.overlap`.
Spins stay by system ``[d, R T, n_spins]``, slot ``r T + t`` being replica
``r`` at temperature ``t``; a PT swap exchanges ``sid`` entries.

:func:`pairs_chunk` launches the kernels on raw pointers, checking the
tensors once per chunk; on CPU tensors it runs :func:`pairs_chunk_plain`,
the kernels' plain versions in the same order.  :data:`LAUNCHES` counts
``pair_overlap``; the other kernels count in their own modules.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import _build, fk, mega, overlap, rng
from ._build import expect as _expect
from .lattice import Lattice, check_tables, fast_divisor
from .measure import overlap_dots

__all__ = [
    "LAUNCHES",
    "Events",
    "supports_megapair",
    "pair_overlap",
    "pair_overlap_plain",
    "pair_overlap_table",
    "pair_overlap_table_plain",
    "PairTablePlan",
    "pair_table_plan",
    "pair_table_smem",
    "pair_table_words",
    "pair_words",
    "pair_word_bytes",
    "pairs_chunk",
    "pairs_chunk_plain",
]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"pair_overlap": 0, "pair_overlap_table": 0}


def supports_megapair(lattice, n_replicas) -> bool:
    """2D square or 3D cubic lattice with even extents and two replicas or
    more (the TPU's lane and row packing rules do not apply here)."""
    return isinstance(lattice, Lattice) and lattice.axes_form and n_replicas >= 2


@dataclass
class Events:
    """The overlap moves of a chunk.  Move ``k`` runs after the measurement
    of sweep ``at[k]`` of the chunk, of kind ``kinds[k]`` on groups of
    ``groups[k]`` replicas, on row ``rows[k]`` of the tables of its group
    size: ``tables[g] = (tasks, scal, probes, words)``, int32 ``[e_g, d, T,
    G, g]``, ``[e_g, B, 6]``, ``[e_g, B, 64]`` and ``[e_g, B, 2]`` with ``G
    = R // g`` and ``B = d T G`` (a chunk may mix pairs and Houdayer(N)'s
    groups, whose task counts differ).

    ``observe``: the moves build their graphs and leave the spins alone,
    and PT reads the sweep's own energies.  ``fold``: ``None``, or
    ``fold(k, graphs)``, handed the :class:`~.overlap.MoveGraphs` of every
    move ``k`` in ``record`` (the stats graph's labels; its masks too when
    ``observe``) right after the move's launches, on the same stream."""

    at: list
    kinds: list
    groups: list
    rows: list
    tables: dict
    observe: bool = False
    record: frozenset = frozenset()
    fold: object = None

    def table(self, k):
        return tuple(t[self.rows[k]] for t in self.tables[self.groups[k]])

    def wants(self, k):
        return self.fold is not None and k in self.record


# ------------------------------------------------------------ pair_overlap


def pair_overlap_plain(spins, sid, shape, n_replicas, offsets=None):
    """``(qs, ql)`` int32 ``[d, P T]`` (pair-major) of spins ``[d, R T,
    n_spins]`` by system, ``ql`` over the forward ``offsets`` (the axes
    when ``None``; see :func:`~.measure.overlap_dots`)."""
    qs, ql = overlap_dots(spins, sid, shape, n_replicas, offsets)
    return qs.flatten(1), ql.flatten(1)


# pair_overlap (csrc/pairs.cu): a column's threads, a power of two from 32 to
# 1024, are the fewest that take at most PAIR_WORDS_A_THREAD words each (one
# word a thread: 0.0026, 0.0036, 0.0024 ms at configs 4, 5, 1; four words a
# thread 0.0029, 0.0038, 0.0034; tools/probe_pairs.py, NVIDIA H100 80GB
# HBM3, 700 W); a CTA holds PAIR_BLOCK // tpc columns (one column where tpc
# is larger)
PAIR_WORDS_A_THREAD = 1
PAIR_BLOCK = 128
PAIR_MAX_THREADS = 1024
# the forward offsets a PairWalk holds (csrc/pairs.cu kPairMaxOffsets)
PAIR_MAX_OFFSETS = 6


def pair_word_bytes(fast: int, align: int) -> int:
    """The bytes of a ``pair_overlap`` word: 8 or 4 where the fast axis of
    ``fast`` sites holds whole words (and the spins are aligned to them,
    ``align``), else 1 (the per-site path)."""
    for w in (8, 4):
        if fast % w == 0 and align % w == 0:
            return w
    return 1


def _offset_table(shape, offsets):
    """The forward offsets as a tuple of tuples (the axes when ``None``)."""
    if offsets is None:
        offsets = np.eye(len(shape), dtype=np.int64)
    return tuple(tuple(int(x) for x in off) for off in np.asarray(offsets))


def pair_words(shape, n_replicas: int, n_slots: int, align: int = 0, offsets=None):
    """int32 host words of ``pair_overlap`` (``csrc/pairs.cu`` ``PairWalk``):
    ``W, n, n / W, wpl, Lb, La, nd, T, P T, n_slots, tpc, log2 tpc, block,
    n_nb, axes``, then :func:`~.lattice.fast_divisor` ``(m, s)`` of
    ``wpl``, ``Lb`` and ``T``, then per forward offset (six, zero-padded)
    its steps ``ra, rb, q, b``.  A system is ``n / W`` words of ``W`` bytes
    (:func:`pair_word_bytes` of the fast extent and ``align``, the spins'
    address modulo 8), in lines of ``wpl`` words along the fast axis; the
    lines run over an inner slow axis of extent ``Lb`` (2D: ``L0``; 3D:
    ``L1``) and in 3D an outer one of extent ``La = L0`` (0 in 2D).  An
    offset ``o`` (``offsets``: the axes when ``None``) steps the line by
    ``ra = o[0] mod La`` (3D; 0 in 2D) and ``rb`` (its inner slow component
    mod ``Lb``), and its fast component mod the fast extent is ``q W + b``:
    ``q`` words and ``b`` bytes.  ``axes`` is 1 where the steps are those
    of the lattice's axes (the kernel's form of its own for them)."""
    return _pair_words(tuple(int(x) for x in shape), n_replicas, n_slots, align,
                       _offset_table(shape, offsets))


def _pair_steps(shape, w, offsets):
    """int64 ``[len(offsets), 4]``: each offset's ``(ra, rb, q, b)``."""
    lb, la = (shape[0], 0) if len(shape) == 2 else (shape[1], shape[0])
    steps = np.zeros((len(offsets), 4), np.int64)
    for k, off in enumerate(offsets):
        fast = off[-1] % shape[-1]
        steps[k] = (off[0] % la if la else 0, off[-2] % lb, fast // w, fast % w)
    return steps


@functools.lru_cache(maxsize=None)
def _pair_words(shape, n_replicas, n_slots, align, offsets):
    nd = len(shape)
    n = int(np.prod(shape))
    w = pair_word_bytes(shape[-1], align)
    wpl = shape[-1] // w
    lb, la = (shape[0], 0) if nd == 2 else (shape[1], shape[0])
    n_temps = n_slots // n_replicas
    cols = (n_replicas // 2) * n_temps
    nw = n // w
    tpc = 32
    while tpc * PAIR_WORDS_A_THREAD < nw and tpc < PAIR_MAX_THREADS:
        tpc *= 2
    if not 1 <= len(offsets) <= PAIR_MAX_OFFSETS:
        raise ValueError(f"pair_overlap takes 1 to {PAIR_MAX_OFFSETS} offsets")
    steps = _pair_steps(shape, w, offsets)
    axes = int(np.array_equal(steps, _pair_steps(shape, w, np.eye(nd, dtype=np.int64))))
    head = [w, n, nw, wpl, lb, la, nd, n_temps, cols, n_slots, tpc,
            tpc.bit_length() - 1, max(PAIR_BLOCK, tpc), len(offsets), axes]
    div = [fast_divisor(x) for x in (wpl, lb, n_temps)]
    table = np.zeros((PAIR_MAX_OFFSETS, 4), np.int64)
    table[:len(offsets)] = steps
    words = np.concatenate([np.asarray(head + [v for md in div for v in md], np.int64),
                            table.reshape(-1)])
    return words.astype(np.uint32).view(np.int32)


def _launch_pair(lib, stream, p_spins, p_sid, p_qs, p_ql, out_stride, d, words):
    _build.check(lib.peapods_pair_overlap(
        p_spins, p_sid, p_qs, p_ql, out_stride, d, words.ctypes.data, stream),
        "pair_overlap")
    LAUNCHES["pair_overlap"] += 1


def pair_overlap(spins, sid, qs_row, ql_row, *, n_replicas, shape=None, offsets=None,
                 lattice=None, tables=None):
    """Write every pair's ``(qs, ql)`` into the rows ``qs_row`` / ``ql_row``
    (int32 ``[d, P T]`` views with unit stride along the columns), ``ql``
    over the forward ``offsets`` (the axes when ``None``): the plain
    version for CPU tensors, the ``pair_overlap`` kernel for CUDA
    tensors.  Given a :class:`~.lattice.Lattice` as ``lattice``, its walk
    view (``kernel_shape``, ``kernel_offsets``) stands for ``shape`` and
    ``offsets``, and a table lattice takes :func:`pair_overlap_table` over
    ``tables``."""
    if lattice is not None:
        if lattice.table:
            pair_overlap_table(spins, sid, qs_row, ql_row, lattice=lattice,
                               n_replicas=n_replicas, tables=tables)
            return
        shape, offsets = lattice.kernel_shape, lattice.kernel_offsets
    if _build.device_kind(spins) == "cpu":
        qs, ql = pair_overlap_plain(spins, sid, shape, n_replicas, offsets)
        qs_row.copy_(qs)
        ql_row.copy_(ql)
        return
    dev = spins.device
    d, n_slots, n = spins.shape
    n_pairs = n_replicas // 2
    cols = n_pairs * (n_slots // n_replicas)
    _expect(spins, "spins", torch.int8, (d, n_slots, n), dev)
    _expect(sid, "sid", torch.int32, (d, n_slots), dev)
    for name, t in (("qs_row", qs_row), ("ql_row", ql_row)):
        if (t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (d, cols)
                or t.stride(1) != 1 or t.stride(0) != qs_row.stride(0)):
            raise ValueError(f"{name} must be an int32 [d, n_pairs T] row view")
    _launch_pair(_build.library(), torch.cuda.current_stream(dev).cuda_stream,
                 spins.data_ptr(), sid.data_ptr(), qs_row.data_ptr(),
                 ql_row.data_ptr(), qs_row.stride(0), d,
                 pair_words(tuple(shape), n_replicas, n_slots, spins.data_ptr() % 8,
                            offsets))


# ------------------------------------------------------ pair_overlap, tables


def pair_overlap_table_plain(spins, sid, fwd, n_replicas):
    """Plain version of ``pair_overlap_table``: ``(qs, ql)`` int32 ``[d, P
    T]`` (pair-major) of spins ``[d, R T, n_spins]`` by system, each site's
    forward neighbours read from the table ``fwd`` (int ``[n_spins,
    n_neighbors]``, :meth:`~.lattice.Lattice.device_tables`).  A self
    offset's neighbour is the site itself (``q_i q_i = 1``), as the
    reference's ``_roll`` on an extent of 1 gives; bitwise
    :func:`~.measure.overlap_dots`."""
    d, n_slots, _ = spins.shape
    n_pairs = n_replicas // 2
    sys = sid.to(torch.int64).reshape(d, n_replicas, n_slots // n_replicas)
    di = torch.arange(d, device=spins.device)[:, None, None]
    a = spins[di, sys[:, 0:2 * n_pairs:2]].to(torch.int32)
    b = spins[di, sys[:, 1:2 * n_pairs:2]].to(torch.int32)
    q = a * b  # [d, P, T, n]
    fwd = fwd.to(device=spins.device, dtype=torch.int64)
    nbr = sum(q[..., fwd[:, k]] for k in range(fwd.shape[1]))
    return (q.sum(-1, dtype=torch.int32).flatten(1),
            (q * nbr).sum(-1, dtype=torch.int32).flatten(1))


# csrc/pairs.cu: a CTA's threads (kPairTableThreads), the shared memory a
# CTA can have (kPairTableSmem), the most 32-bit words of columns a site
# (its kernels' instances: 1, 2 or 4)
PAIR_TABLE_THREADS = 256
PAIR_TABLE_SMEM = 232448
PAIR_TABLE_MAX_WORDS = 4


class PairTablePlan(NamedTuple):
    """``pair_overlap_table``'s launch (``csrc/pairs.cu``): a site's
    disagreement bits of a column group are ``words`` 32-bit words, the
    columns in ``groups`` groups of ``32 words``; a realization's group
    takes a thread-block cluster of ``cluster`` CTAs of ``threads``
    threads, CTA ``r`` staging and counting the words of sites ``[r slice,
    (r + 1) slice)``, or (``slice`` 0: none staged, each word made where it
    is needed) ``copies`` CTAs, copy ``j`` counting the lattice's ``share``
    from ``j share``; ``smem`` the dynamic shared memory a CTA."""

    words: int
    groups: int
    cluster: int
    copies: int
    slice: int
    share: int
    threads: int
    smem: int


def pair_table_smem(slice_: int, words: int) -> int:
    """``csrc/pairs.cu`` ``PairSmem``'s bytes: the slice's words, two 8-byte
    row offsets a column, eight warps' and the CTA's two int sums a column,
    the last-copy flag."""
    return slice_ * 4 * words + (16 * 32 + 8 * 64 * 4 + 64 * 4) * words + 16


@functools.lru_cache(maxsize=None)
def pair_table_plan(n_spins: int, cols: int, n_disorder: int, sms: int) -> PairTablePlan:
    """The table form's pair measurement of ``cols`` columns (pair,
    temperature) of ``n_disorder`` realizations of ``n_spins`` sites, from
    the shape alone: columns in 32-bit words (1, 2 or 4 a site: up to 128
    columns a group); the fewest CTAs a cluster (1 to 8) whose slices' words
    fit a CTA's shared memory and whose launch holds ``sms`` CTAs, else 8,
    one cluster a realization and group (``chip_smoke.py`` phase 38: the 4D
    glass, 16 realizations, 8 CTAs a cluster, 128 CTAs; copies of the
    cluster that filled the card ran slower, each staging every word
    again); past 8 CTAs' shared memory no staging, and copies of one CTA,
    each counting its share of the lattice, until the launch holds ``sms``
    CTAs and a CTA counts at most 64 sites a thread."""
    n, cols, d = int(n_spins), int(cols), int(n_disorder)
    words = next(w for w in (1, 2, PAIR_TABLE_MAX_WORDS) if cols <= 32 * w
                 or w == PAIR_TABLE_MAX_WORDS)
    groups = -(-cols // (32 * words))
    rows = d * groups
    def slice_of(c):  # a CTA's sites of C slices, a multiple of 4
        return (-(-n // c) + 3) // 4 * 4

    fit = [c for c in (1, 2, 4, 8) if pair_table_smem(slice_of(c), words) <= PAIR_TABLE_SMEM]
    if fit:
        cluster = next((c for c in fit if c * rows >= sms), fit[-1])
        slice_ = share = slice_of(cluster)
        copies = 1
    else:  # past a cluster's shared memory
        cluster, slice_ = 1, 0
        copies = max(1, min(-(-sms // rows), n))
        copies = max(copies, min(-(-n // (PAIR_TABLE_THREADS * 64)), n))
        share = -(-n // copies)
    return PairTablePlan(words, groups, cluster, copies, slice_, share, PAIR_TABLE_THREADS,
                         pair_table_smem(slice_, words))


def pair_table_words(n_spins, n_neighbors, n_temps, cols, n_slots, plan):
    """int32 words of ``peapods_pair_overlap_table`` (host memory;
    ``csrc/pairs.cu`` ``make_pair_table``): the lattice, the ladders, the
    plan, and :func:`~.lattice.fast_divisor` of the slice."""
    m, s = fast_divisor(max(plan.slice, 1))
    return np.array([n_spins, n_neighbors, n_temps, cols, n_slots, plan.words, plan.groups,
                     plan.cluster, plan.copies, plan.slice, plan.share, plan.threads,
                     m, s, plan.smem],
                    dtype=np.int64).astype(np.uint32).view(np.int32)


def pair_overlap_table(spins, sid, qs_row, ql_row, *, lattice, n_replicas, tables,
                       plan=None):
    """:func:`pair_overlap` on a table lattice (:attr:`~.lattice.Lattice.
    table`: four dimensions or more, or more than six offsets): every
    pair's ``(qs, ql)`` into the rows ``qs_row`` / ``ql_row``, ``ql`` over
    the lattice's forward offsets read from ``tables`` (its ``(fwd, bwd)``
    on the spins' device, :func:`~.lattice.check_tables`).  The plain
    version for CPU tensors, the ``pair_overlap_table`` kernel for CUDA
    tensors, one launch on :func:`pair_table_plan`'s plan (or ``plan``)."""
    if _build.device_kind(spins) == "cpu":
        fwd = torch.from_numpy(lattice.fwd) if tables is None else tables[0]
        qs, ql = pair_overlap_table_plain(spins, sid, fwd, n_replicas)
        qs_row.copy_(qs)
        ql_row.copy_(ql)
        return
    dev = spins.device
    d, n_slots, n = spins.shape
    nb = lattice.n_neighbors
    n_temps = n_slots // n_replicas
    cols = (n_replicas // 2) * n_temps
    _expect(spins, "spins", torch.int8, (d, n_slots, lattice.n_spins), dev)
    _expect(sid, "sid", torch.int32, (d, n_slots), dev)
    fwd, _ = check_tables(tables, lattice, dev)
    for name, t in (("qs_row", qs_row), ("ql_row", ql_row)):
        if (t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (d, cols)
                or t.stride(1) != 1 or t.stride(0) != qs_row.stride(0)):
            raise ValueError(f"{name} must be an int32 [d, n_pairs T] row view")
    if not 1 <= d <= 65535:
        raise ValueError(f"pair_overlap_table takes 1 to 65535 realizations, got {d}")
    if n * nb >= 2 ** 31:
        raise ValueError(f"a table of {n} x {nb} entries is larger than int32 indexes")
    if fwd.data_ptr() % 16:
        raise ValueError("the forward table must be 16-byte aligned")
    if plan is None:
        sms = torch.cuda.get_device_properties(dev.index).multi_processor_count
        plan = pair_table_plan(n, cols, d, sms)
    elif (plan.smem > PAIR_TABLE_SMEM or (plan.slice and plan.cluster * plan.slice < n)
          or (plan.slice and plan.copies != 1)):
        raise ValueError(f"pair_overlap_table: the plan {plan} does not fit a CTA or the "
                         "lattice, or stages copies")
    words = pair_table_words(n, nb, n_temps, cols, n_slots, plan)
    part = counter = None
    if plan.copies > 1:  # unstaged: the last CTA's counters, then the CTAs' sums
        rows = d * plan.groups
        scratch = torch.zeros(rows * (1 + plan.copies * 64 * plan.words), dtype=torch.int32,
                              device=dev)
        counter, part = scratch[:rows], scratch[rows:]
    _build.check(_build.library().peapods_pair_overlap_table(
        spins.data_ptr(), sid.data_ptr(), fwd.data_ptr(), qs_row.data_ptr(),
        ql_row.data_ptr(), None if part is None else part.data_ptr(),
        None if counter is None else counter.data_ptr(), qs_row.stride(0), d,
        words.ctypes.data, torch.cuda.current_stream(dev).cuda_stream),
        "pair_overlap_table")
    LAUNCHES["pair_overlap_table"] += 1


# ------------------------------------------------------------ the chunk


def _pt_due(s, pt_interval):
    return pt_interval is not None and s % pt_interval == 0


def _draw(draws, t):
    if draws is None:
        return None
    return tuple(x[t] for x in draws) if isinstance(draws, tuple) else draws[t]


def _outputs(d, n, n_slots, n_cols, dev):
    return (torch.empty((d, n, n_slots), dtype=torch.float32, device=dev),
            torch.empty((d, n, n_slots), dtype=torch.int32, device=dev),
            torch.empty((d, n, n_cols), dtype=torch.int32, device=dev),
            torch.empty((d, n, n_cols), dtype=torch.int32, device=dev))


def pairs_chunk_plain(spins, jgrids, coup, temps, slot_temps, sid, ea, ec,
                      rtrips, tstate, sweep_words, draws, events, *, shape,
                      n_replicas, sweep_base, parity, gibbs, pt_interval,
                      pt_full, hot_slot, cold_slot, wolff):
    """Plain torch :func:`pairs_chunk`: the kernels' plain versions in the
    kernels' order, Philox site uniforms drawn a block of sweeps at a time
    through :func:`~.rng.colour_uniforms` and bond uniforms through
    :func:`~.rng.bond_uniforms` (the tests replace both with zeros, which
    is what the reference's interpret mode draws)."""
    n, d = sweep_words.shape[:2]
    n_slots = sid.shape[1]
    n_pairs = n_replicas // 2
    n_sites = spins.shape[-1]
    grid = spins.view(d, n_slots, *shape)
    e, m, qs, ql = _outputs(d, n, n_slots, n_pairs * (n_slots // n_replicas),
                            spins.device)
    sys_temps = torch.empty((d, n_slots), dtype=torch.float32, device=spins.device)
    uniforms = rng.blocked(lambda a, b: torch.stack(
        [rng.colour_uniforms(sweep_words[a:b], n_slots, c, shape) for c in (0, 1)],
        dim=1), 2 * d * n_slots * n_sites)
    at = {} if events is None else {t: k for k, t in enumerate(events.at)}
    pt = (ea, ec, rtrips, tstate, slot_temps)
    kw = dict(pt_full=pt_full, hot_slot=hot_slot, cold_slot=cold_slot,
              n_spins=n_sites, n_replicas=n_replicas)
    for t in range(n):
        mega.colour_pass_plain(grid, jgrids, sid, slot_temps, None, 0, gibbs=gibbs,
                               u=uniforms(t)[0])
        e_part, m_part = mega.colour_pass_plain(grid, jgrids, sid, slot_temps, None,
                                                1, gibbs=gibbs, u=uniforms(t)[1])
        qs[:, t], ql[:, t] = pair_overlap_plain(spins, sid, shape, n_replicas)
        do_pt = _pt_due(sweep_base + t, pt_interval)
        k = at.get(t)
        if k is None:
            parity = mega.pt_step_plain(e_part, m_part, e[:, t], m[:, t], sid, *pt,
                                        _draw(draws, t), sys_temps, do_pt=do_pt,
                                        parity=parity, **kw)
            continue
        mega.pt_step_plain(e_part, m_part, e[:, t], m[:, t], sid, *pt, None,
                           sys_temps, do_pt=False, parity=parity, **kw)
        want = events.wants(k)
        tasks, scal, probes, words = events.table(k)
        graphs = overlap.overlap_event_plain(
            spins, sid, tasks, coup, temps, scal, probes, words, kind=events.kinds[k],
            wolff=wolff, shape=shape, with_labels=want,
            with_masks=want and events.observe, observe=events.observe)
        if want:
            events.fold(k, graphs)
        if do_pt:
            e2, m2 = ((e_part, m_part) if events.observe
                      else overlap.energy_partials_plain(spins, coup, shape))
            parity = mega.pt_step_plain(e2, m2, None, None, sid, *pt,
                                        _draw(draws, t), sys_temps, do_pt=True,
                                        parity=parity, **kw)
    return e, m, qs, ql, parity


def pairs_chunk(spins, jgrids, coup, temps, slot_temps, sid, ea, ec, rtrips,
                tstate, sweep_words, draws, events, *, shape, n_replicas,
                sweep_base, parity, gibbs, pt_interval, pt_full, hot_slot,
                cold_slot, wolff):
    """Run ``n`` sweeps of the replica path on every realization.

    Args:
        spins: int8 ``[d, R T, n_spins]`` by system, updated in place.
        jgrids: f32 ``[d, 2 n_dims, *shape]`` pre-shifted coupling grids.
        coup: f32 ``[d, n_spins, n_dims]`` forward couplings.
        temps: f32 ``[T]``; slot_temps: f32 ``[R T]`` (``temps`` tiled).
        sid: int32 ``[d, R T]`` system at each slot, updated in place.
        ea, ec: int32 ``[d, T - 1]``; rtrips, tstate: int32 ``[d, R T]``.
        sweep_words: int32 ``[n, d, 2]`` per-sweep key words.
        draws: the chunk's PT draws (:func:`~.tempering.pt_draws_pairs` of
            its PT words, ``[n, d]`` leading; single-edge edges int32), or
            ``None`` without PT.
        events: the chunk's overlap moves (:class:`Events`) or ``None``.
        sweep_base: index of the chunk's first sweep within the sample()
            call; sweep ``s`` runs PT iff ``s % pt_interval == 0``.
        parity: full-ladder parity of the next PT event.
        wolff: the overlap moves' cluster mode.

    Returns:
        ``(e f32 [d, n, R T], m int32 [d, n, R T], qs int32 [d, n, P T],
        ql int32 [d, n, P T], parity)``: per sweep, each slot's energy per
        spin and magnetization sum and each pair's overlap sums (pair-major
        columns), taken before the sweep's move; and the next parity.
    """
    args = (spins, jgrids, coup, temps, slot_temps, sid, ea, ec, rtrips, tstate,
            sweep_words, draws, events)
    kw = dict(shape=tuple(shape), n_replicas=n_replicas, sweep_base=sweep_base,
              parity=parity, gibbs=gibbs, pt_interval=pt_interval,
              pt_full=pt_full, hot_slot=hot_slot, cold_slot=cold_slot,
              wolff=wolff)
    if _build.device_kind(spins) == "cpu":
        return pairs_chunk_plain(*args, **kw)
    shape = tuple(shape)
    dev = spins.device
    n, d = sweep_words.shape[:2]
    n_slots, n_sites = spins.shape[1:]
    R = n_replicas
    T = n_slots // R
    P = R // 2
    grid = spins.view(d, n_slots, *shape)
    dims5 = mega._check_sweep(grid, jgrids, sid, slot_temps)
    mega._check_pt(d, n_slots, dev, ea, ec, rtrips, tstate, R)
    _expect(sweep_words, "sweep_words", torch.int32, (n, d, 2), dev)
    _expect(coup, "coup", torch.float32, (d, n_sites, len(shape)), dev)
    _expect(temps, "temps", torch.float32, (T,), dev)
    if R < 2 or n_slots != R * T:
        raise ValueError(f"{n_slots} slots do not hold {R} >= 2 ladders")
    p_edge = p_u = None
    edge_bytes = u_bytes = 0  # one sweep's draws
    if draws is not None:
        if pt_full:
            _expect(draws, "draws", torch.float32, (n, d, R, 2, T - 1), dev)
            p_u, u_bytes = draws.data_ptr(), d * R * 2 * (T - 1) * 4
        else:
            _expect(draws[0], "edge draws", torch.int32, (n, d, R), dev)
            _expect(draws[1], "u draws", torch.float32, (n, d, R), dev)
            p_edge, p_u = draws[0].data_ptr(), draws[1].data_ptr()
            edge_bytes = u_bytes = d * R * 4
    elif pt_interval is not None:
        raise ValueError("a run with PT needs its draws")
    scratch = None
    if events is not None and events.at:
        # one scratch, and one labels buffer, for the largest task batch of
        # the chunk, held until the chunk returns: their memory must not be
        # handed out again while the launches that use them are queued
        ev_p, ev_bytes, ev_b = {}, {}, {}
        for g, tab in events.tables.items():
            e_g, b = tab[0].shape[0], d * T * (R // g)
            for name, tensor, tail in (("tasks", tab[0], (d, T, R // g, g)),
                                       ("scal", tab[1], (b, 6)),
                                       ("probes", tab[2], (b, 64)),
                                       ("words", tab[3], (b, 2))):
                _expect(tensor, f"event {name}", torch.int32, (e_g,) + tail, dev)
            ev_p[g] = [t.data_ptr() for t in tab]
            ev_bytes[g] = [t[0].numel() * 4 for t in tab]
            ev_b[g] = b
        for kind, g in zip(events.kinds, events.groups):
            overlap.task_group_size(kind, events.tables[g][0])
        b_max = max(ev_b.values())
        if b_max > 65535:
            raise ValueError("at most 65535 overlap tasks")
        cmr = "cmr" in events.kinds
        scratch_buf = overlap.Scratch(b_max, n_sites, dev, cmr and not events.observe)
        scratch = scratch_buf.ptrs()
        lab_buf = blue_buf = None
        if events.fold is not None and events.record:
            lab_buf = torch.empty((b_max, n_sites), dtype=torch.int32, device=dev)
            blue_buf = torch.empty_like(lab_buf) if cmr else None
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    e_part, m_part = mega._partials(lib, *dims5, dev)
    nb2 = lib.peapods_site_blocks(n_sites)
    e_part2 = torch.empty((d, n_slots, nb2), dtype=torch.float32, device=dev)
    m_part2 = torch.empty((d, n_slots, nb2), dtype=torch.int32, device=dev)
    e, m, qs, ql = _outputs(d, n, n_slots, P * T, dev)
    sys_temps = torch.empty((d, n_slots), dtype=torch.float32, device=dev)
    p_spins, p_jg, p_sid, p_st = (t.data_ptr() for t in (spins, jgrids, sid,
                                                         slot_temps))
    p_coup, p_temps = coup.data_ptr(), temps.data_ptr()
    p_ep, p_mp, p_ep2, p_mp2 = (t.data_ptr() for t in (e_part, m_part, e_part2,
                                                       m_part2))
    p_e, p_m, p_qs, p_ql = (t.data_ptr() for t in (e, m, qs, ql))
    p_pt = [t.data_ptr() for t in (ea, ec, rtrips, tstate)]
    p_sw, p_systemps = sweep_words.data_ptr(), sys_temps.data_ptr()
    at = {} if events is None else {t: k for k, t in enumerate(events.at)}
    row_bytes, col_bytes = n_slots * 4, P * T * 4
    pt_kw = dict(pt_full=pt_full, hot_slot=hot_slot, cold_slot=cold_slot,
                 n_replicas=R)
    plan = mega._colour_plan(dev, dims5)
    pw = pair_words(shape, R, n_slots, p_spins % 8)
    ew = overlap.energy_words(shape, d, n_slots, p_spins % 8,
                              fk.resident_threads(dev.index) // 4)
    for t in range(n):
        for colour, parts in ((0, (None, None)), (1, (p_ep, p_mp))):
            mega._launch_colour(lib, stream, dims5, p_spins, p_jg, p_sid, p_st,
                                p_sw + t * d * 8, *parts, colour, gibbs, plan)
        _launch_pair(lib, stream, p_spins, p_sid, p_qs + t * col_bytes,
                     p_ql + t * col_bytes, n * P * T, d, pw)
        do_pt = _pt_due(sweep_base + t, pt_interval)
        dr = ((p_edge + t * edge_bytes if p_edge is not None else None,
               p_u + t * u_bytes) if do_pt else (None, None))
        k = at.get(t)
        rows = (p_e + t * row_bytes, p_m + t * row_bytes, n * n_slots)
        if k is None:
            parity = mega._launch_pt(
                lib, stream, dev, d, n_slots, n_sites, p_ep, p_mp, e_part.shape[2],
                *rows, p_sid, *p_pt, p_st, *dr, p_systemps, do_pt=do_pt,
                parity=parity, **pt_kw)
            continue
        mega._launch_pt(lib, stream, dev, d, n_slots, n_sites, p_ep, p_mp,
                        e_part.shape[2], *rows, p_sid, *p_pt, p_st, None, None,
                        p_systemps, do_pt=False, parity=parity, **pt_kw)
        g, kind = events.groups[k], events.kinds[k]
        b = ev_b[g]
        p_tasks, p_scal, p_probes, p_words = (
            p + events.rows[k] * nb for p, nb in zip(ev_p[g], ev_bytes[g]))
        want = events.wants(k)
        graphs = None
        if want:
            graphs = overlap.MoveGraphs(
                None if kind == "cmr" else lab_buf[:b],
                blue_buf[:b] if kind == "cmr" else None,
                None)
        overlap.launch_event(
            lib, stream, (b, *_build.dims3(shape), T, R // g, n_slots), p_spins,
            p_sid, p_tasks, p_coup, p_temps, p_scal, p_probes, p_words, scratch,
            kind=kind, wolff=wolff, group=g,
            p_labels=None if graphs is None or graphs.labels is None
            else graphs.labels.data_ptr(),
            p_blue=None if graphs is None or graphs.blue is None
            else graphs.blue.data_ptr(), observe=events.observe)
        if want:
            if events.observe:
                graphs = graphs._replace(masks=fk.state_masks(
                    scratch_buf.state[:b], len(shape)))
            events.fold(k, graphs)
        if do_pt:
            if events.observe:
                parts = (p_ep, p_mp, e_part.shape[2])
            else:
                overlap.launch_energy(lib, stream, ew, p_spins, p_coup, p_ep2, p_mp2)
                parts = (p_ep2, p_mp2, nb2)
            parity = mega._launch_pt(
                lib, stream, dev, d, n_slots, n_sites, *parts, None, None,
                0, p_sid, *p_pt, p_st, *dr, p_systemps, do_pt=True,
                parity=parity, **pt_kw)
    return e, m, qs, ql, parity
