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

from dataclasses import dataclass

import torch

from . import _build, fk, mega, overlap, rng
from ._build import expect as _expect
from .lattice import Lattice
from .measure import overlap_dots

__all__ = [
    "LAUNCHES",
    "Events",
    "supports_megapair",
    "pair_overlap",
    "pair_overlap_plain",
    "pairs_chunk",
    "pairs_chunk_plain",
]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"pair_overlap": 0}


def supports_megapair(lattice, n_replicas) -> bool:
    """2D square or 3D cubic lattice with even extents and two replicas or
    more (the TPU's lane and row packing rules do not apply here)."""
    return isinstance(lattice, Lattice) and lattice.hypercubic and n_replicas >= 2


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


def pair_overlap_plain(spins, sid, shape, n_replicas):
    """``(qs, ql)`` int32 ``[d, P T]`` (pair-major) of spins ``[d, R T,
    n_spins]`` by system (see :func:`~.measure.overlap_dots`)."""
    qs, ql = overlap_dots(spins, sid, shape, n_replicas)
    return qs.flatten(1), ql.flatten(1)


def _launch_pair(lib, stream, p_spins, p_sid, p_qs, p_ql, out_stride, d,
                 n_pairs, n_temps, n_slots, shape):
    _build.check(lib.peapods_pair_overlap(
        p_spins, p_sid, p_qs, p_ql, out_stride, d, n_pairs, n_temps, n_slots,
        *_build.dims3(shape), stream), "pair_overlap")
    LAUNCHES["pair_overlap"] += 1


def pair_overlap(spins, sid, qs_row, ql_row, *, shape, n_replicas):
    """Write every pair's ``(qs, ql)`` into the rows ``qs_row`` / ``ql_row``
    (int32 ``[d, P T]`` views with unit stride along the columns): the plain
    version for CPU tensors, the ``pair_overlap`` kernel for CUDA
    tensors."""
    if _build.device_kind(spins) == "cpu":
        qs, ql = pair_overlap_plain(spins, sid, shape, n_replicas)
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
                 ql_row.data_ptr(), qs_row.stride(0), d, n_pairs,
                 n_slots // n_replicas, n_slots, shape)


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
    for t in range(n):
        for colour, parts in ((0, (None, None)), (1, (p_ep, p_mp))):
            mega._launch_colour(lib, stream, dims5, p_spins, p_jg, p_sid, p_st,
                                p_sw + t * d * 8, *parts, colour, gibbs)
        _launch_pair(lib, stream, p_spins, p_sid, p_qs + t * col_bytes,
                     p_ql + t * col_bytes, n * P * T, d, P, T, n_slots, shape)
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
                overlap.launch_energy(lib, stream, d, n_slots, *_build.dims3(shape),
                                      p_spins, p_coup, p_ep2, p_mp2)
                parts = (p_ep2, p_mp2, nb2)
            parity = mega._launch_pt(
                lib, stream, dev, d, n_slots, n_sites, *parts, None, None,
                0, p_sid, *p_pt, p_st, *dr, p_systemps, do_pt=True,
                parity=parity, **pt_kw)
    return e, m, qs, ql, parity
