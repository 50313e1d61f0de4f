"""The mega path: sweeps, measurement and parallel tempering of a chunk.

Counterpart of ``peapods_tpu/ops/pallas_mega.py`` (``supports_mega`` :64-69,
``mega_chunk`` :302-428).  The TPU runs a chunk as one Pallas call that
keeps every slot's spins in VMEM.  On the H100 a chunk is one launch of
``mega_resident`` (``csrc/mega_resident.cu``: each system's lattice held in
the shared memory of a thread-block cluster; at a PT event the clusters
that it concerns wait for each other's sums) wherever
:func:`resident_plan` finds it a layout that the card runs with every
cluster resident.  Other shapes run three launches a
sweep of the kernels in ``csrc/mega.cu`` on the current stream::

    colour_pass(colour 0) -> colour_pass(colour 1, partial e and m sums)
        -> pt_step (reduce the partials into the sweep's (e, m) rows in one
           fixed order, :func:`ordered_partial_sum`, then the PT event when
           the sweep is on the PT interval)

Both routes give the same numbers bit for bit, with no host
synchronisation inside a chunk.  State is updated in place: spins by
system ``[d, n_systems, H, W]`` and the slot -> system map ``sid`` (a PT
swap exchanges ``sid`` entries, never spin tiles), and the PT counters.
The replica path (:mod:`~peapods_tpu_torch.ops.megapair`) runs
``colour_pass`` and ``pt_step`` on 2D and 3D lattices with ``R`` ladders
per realization.

Each kernel has a plain torch version here (:func:`colour_pass_plain`,
:func:`pt_step_plain`, :func:`mega_chunk_plain`; :func:`resident_partition`
mirrors the resident kernel's partition of a system).  The dispatch
wrappers (:func:`colour_pass`, :func:`pt_step`, :func:`mega_chunk`) take
the plain version for tensors on the CPU, launch a kernel for CUDA
tensors, and raise for anything else; they never fall back.
:data:`LAUNCHES` counts the kernel launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build, rng
from ._build import device_kind as _device_kind
from ._build import expect as _expect
from .energy import per_spin
from .lattice import Lattice, fast_divisor
from .measure import per_slot_values, slot_temps_for_systems
from .rng import colour_uniforms
from .sweep import colour_mask, colour_update
from .tempering import pt_apply, pt_draws

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "supports_mega",
    "colour_pass",
    "colour_pass_plain",
    "colour_pass_partials",
    "ColourPlan",
    "colour_plan",
    "pt_step",
    "pt_step_plain",
    "pt_split",
    "ordered_partial_sum",
    "ResidentPlan",
    "resident_smem",
    "resident_plan",
    "resident_route",
    "resident_partition",
    "mega_chunk",
    "mega_chunk_launches",
    "mega_chunk_resident",
    "mega_chunk_plain",
]

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES = {"colour_pass": 0, "pt_step": 0, "mega_resident": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# pt_step's reduction: a CTA's share of a row is REDUCE_LANES lanes, and a
# row of more than REDUCE_LANES partials is split over up to MAX_SPLIT CTAs
# (csrc/mega.cu kThreads, kPtMaxSplit)
REDUCE_LANES = 256
MAX_SPLIT = 256

# the resident kernel (csrc/mega_resident.cu): the portable cluster sizes,
# tried in this order, its most threads a CTA, and the colour sites of a
# logical block, whose partial it writes (mega.cuh kThreads x
# kSitesPerThread, a block of colour_pass)
RESIDENT_CLUSTERS = (1, 2, 4, 8)
RESIDENT_MAX_THREADS = 1024
BLOCK_SITES = REDUCE_LANES * 4


# colour_pass (csrc/mega.cu kMaxPer, kThreads): a CTA takes up to
# COLOUR_MAX_PER slots of one realization, its groups of four colour sites
# a block of up to REDUCE_LANES threads
COLOUR_MAX_PER = 8


class ColourPlan(NamedTuple):
    """``colour_pass``'s layout: ``per`` slots of one realization a CTA,
    ``gp`` groups of a logical block a CTA (a power of two, 32 to 256; below
    256 the lattice has one block of at most ``gp`` groups), ``sub`` slot
    lanes (the CTA's threads are ``gp x sub``: thread ``t`` takes group ``t
    % gp`` of slots ``t // gp``, ``+ sub``, ...), and the kernel's host
    words ``(per, gp, m0, s0, m1, s1)``: :func:`~.lattice.fast_divisor` of
    the active sites' row length ``W / 2`` (2D), or of ``L1 L2 / 2`` and
    ``L2 / 2`` (3D)."""

    per: int
    gp: int
    sub: int
    words: np.ndarray


@functools.lru_cache(maxsize=None)
def colour_plan(dims, n_disorder: int, n_slots: int, threads: int) -> ColourPlan:
    """``colour_pass``'s layout for ``n_slots`` slots of ``n_disorder``
    realizations of ``dims = (L0, L1, L2)`` (``L2 = 1`` in 2D), from the
    shape and the least ``threads`` a launch keeps (a quarter of the card's
    resident threads, :func:`_colour_plan`): a lattice of more than 128
    groups a slot takes :func:`~.sweep.systems_per` slots a CTA, one block
    of 256 groups, each thread its slots in turn; a smaller one fills its
    CTAs with slots side by side, one slot a thread, as many as divide
    ``n_slots`` up to ``256 / gp``.  (tools/probe_colour_cc.py, NVIDIA H100
    80GB HBM3: config 5 0.01281 ms a pass with 2 slots a thread, the rule
    of half the resident threads, 0.01125 with 4; the flagship shape
    0.00850 with 1, 0.00685 with 2.)"""
    from .sweep import systems_per

    l0, l1, l2 = (int(x) for x in dims)
    groups = -(-(l0 * l1 * l2 // 2) // 4)
    if groups > REDUCE_LANES // 2:
        gp = REDUCE_LANES
        per = systems_per(groups, n_disorder, n_slots, threads)
    else:
        gp = max(32, 1 << (groups - 1).bit_length())
        per = max(p for p in range(1, min(COLOUR_MAX_PER, REDUCE_LANES // gp) + 1)
                  if n_slots % p == 0)
    divs = ((l1 * l2 // 2, l2 // 2) if l2 > 1 else (l1 // 2, 1))
    words = np.asarray([per, gp, *(x for dv in divs for x in fast_divisor(dv))],
                       np.int64).astype(np.uint32).view(np.int32)
    return ColourPlan(per, gp, min(REDUCE_LANES // gp, per), words)


def supports_mega(lattice, n_replicas) -> bool:
    """2D square lattice with even extents and one replica."""
    return isinstance(lattice, Lattice) and lattice.square and n_replicas == 1


# ------------------------------------------------------------ plain torch


def colour_pass_plain(spins, jgrids, sid, temps, words, colour, *, gibbs,
                      u=None):
    """One colour pass over every (realization, slot), in place.

    Args:
        spins: int8 ``[d, n_systems, *shape]`` by system (2D or 3D).
        jgrids: f32 ``[d, 2 n_dims, *shape]``.
        sid: int32 ``[d, n_slots]`` system at each slot.
        temps: f32 ``[n_slots]``.
        words: int32 ``[d, 2]`` the sweep's key words (unused when ``u`` is
            given).
        u: optional f32 ``[d, n_slots, *shape]`` injected uniforms.

    Returns:
        For colour 1, the partial sums ``(e_part f32 [d, n_systems, 1],
        m_part int32 [d, n_systems, 1])`` by system of ``s*h`` over the odd
        sites and of ``s``; ``None`` for colour 0.
    """
    d, n_slots, shape = spins.shape[0], sid.shape[1], tuple(spins.shape[2:])
    nd = len(shape)
    if u is None:
        u = colour_uniforms(words, n_slots, colour, shape)
    di = torch.arange(d, device=spins.device)[:, None]
    sys = sid.to(torch.int64)
    inv_half_t = (1.0 / (0.5 * temps)).reshape((1, n_slots) + (1,) * nd)
    s, field = colour_update(spins[di, sys].to(torch.float32), jgrids[:, None],
                             inv_half_t, u, colour, gibbs=gibbs, n_dims=nd)
    spins[di, sys] = s.to(torch.int8)
    if colour == 0:
        return None
    odd = colour_mask(shape, 1, spins.device)
    spatial = tuple(range(-nd, 0))
    e_part = torch.empty((d, n_slots, 1), dtype=torch.float32, device=spins.device)
    m_part = torch.empty((d, n_slots, 1), dtype=torch.int32, device=spins.device)
    e_part[di, sys, 0] = torch.where(odd, s * field, 0.0).sum(spatial)
    m_part[di, sys, 0] = s.to(torch.int32).sum(spatial, dtype=torch.int32)
    return e_part, m_part


def pt_split(n_blocks: int) -> int:
    """The CTAs of ``pt_step`` that share a row of ``n_blocks`` partials:
    one a ``REDUCE_LANES`` partials, up to ``MAX_SPLIT``.  The order of the
    row's sum depends on it, and so only on the row's length."""
    return max(1, min(MAX_SPLIT, -(-n_blocks // REDUCE_LANES)))


def ordered_partial_sum(x, n_split: int = 1):
    """The sum of the partials ``x [..., n]`` over the last axis in
    ``pt_step``'s order (``csrc/mega.cu`` ``share_sum``), bitwise on every
    device: ``P = REDUCE_LANES * n_split`` lanes, lane ``l`` adding ``x[l]``,
    ``x[l + P]``, ... from 0 in turn; each CTA's ``REDUCE_LANES`` lane sums
    paired as a tree (lane ``l`` with ``l + 128``, then ``l + 64``, ...,
    ``mega.cuh`` ``warp_tree``); and with ``n_split > 1`` the CTAs' sums
    added as a row of their own."""
    n = x.shape[-1]
    if n == 1 and n_split == 1:
        return x[..., 0] + 0.0  # the tree of one value and 255 zeros
    p = REDUCE_LANES * n_split
    k = -(-n // p)
    xs = torch.nn.functional.pad(x, (0, k * p - n)).reshape(*x.shape[:-1], k, p)
    acc = torch.zeros_like(xs[..., 0, :])
    for i in range(k):
        acc = acc + xs[..., i, :]
    v = acc.reshape(*x.shape[:-1], n_split, REDUCE_LANES)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    v = v[..., 0]
    return v[..., 0] if n_split == 1 else ordered_partial_sum(v)


def pt_step_plain(e_part, m_part, e_row, m_row, sid, ea, ec, rtrips, tstate,
                  temps, draws, sys_temps, *, do_pt, pt_full, parity, hot_slot,
                  cold_slot, n_spins, n_replicas=1) -> int:
    """Reduce a sweep's partials into its ``(e, m)`` rows and, when
    ``do_pt``, run the PT event (:func:`~.tempering.pt_apply`) on each of
    the ``n_replicas`` ladders of every realization, in place.

    Args:
        e_part, m_part: f32 / int32 ``[d, n_systems, blocks]`` partial sums
            by system (every path's kernels write them so).
        e_row, m_row: f32 / int32 ``[d, n_slots]``, written by slot (both
            ``None``: not written).
        temps: f32 ``[n_slots]`` by slot.
        draws: the event's PT draws, ``[d]`` leading: single edge ``(edge
            int, u f32)``, full ladder u f32 (the shapes of
            :func:`~.tempering.pt_apply`; the mega path's :func:`pt_draws`,
            the per-sweep path's jnp-form draws or the replica path's
            :func:`~.tempering.pt_draws_pairs`); unused, and may be
            ``None``, without PT.
        sys_temps: f32 ``[d, n_systems]`` each system's temperature,
            rewritten after a PT event.

    The energy rows add the partials in the kernel's order
    (:func:`ordered_partial_sum`), so they are bitwise the kernel's.

    Returns the parity of the next PT event."""
    split = pt_split(e_part.shape[-1])
    e_part, m_part = (per_slot_values(x, sid) for x in (e_part, m_part))
    es = per_spin(ordered_partial_sum(e_part, split), n_spins)
    if e_row is not None:
        e_row.copy_(es)
        m_row.copy_(m_part.sum(-1, dtype=torch.int32))
    if not do_pt:
        return parity
    if not pt_full:
        draws = (draws[0].to(torch.int64), draws[1])
    parity = pt_apply(es, sid, ea, ec, rtrips, tstate, temps, draws,
                      pt_full=pt_full, parity=parity, n_spins=n_spins,
                      hot_slot=hot_slot, cold_slot=cold_slot,
                      n_replicas=n_replicas)
    sys_temps.copy_(slot_temps_for_systems(sid, temps))
    return parity


def _philox_source(sweep_words, n_slots, shape):
    """``uniforms(t, colour)`` drawing Philox uniforms a block of sweeps at
    a time."""
    d = sweep_words.shape[1]
    get = rng.blocked(lambda a, b: torch.stack(
        [colour_uniforms(sweep_words[a:b], n_slots, c, shape) for c in (0, 1)],
        dim=1), 2 * d * n_slots * shape[0] * shape[1])
    return lambda t, colour: get(t)[colour]


def _pt_due(sweep_base, t, pt_interval) -> bool:
    return pt_interval is not None and (sweep_base + t) % pt_interval == 0


def mega_chunk_plain(spins, jgrids, temps, sid, ea, ec, rtrips, tstate,
                     sweep_words, pt_words, *, sweep_base, parity, gibbs,
                     pt_interval, pt_full, hot_slot, cold_slot, uniforms=None):
    """Plain torch :func:`mega_chunk`.  ``uniforms(t, colour)`` may inject
    f32 ``[d, n_slots, H, W]`` site uniforms for sweep ``t`` (the tests pass
    zeros, which is what the reference's interpret mode draws)."""
    n, d = sweep_words.shape[:2]
    n_slots = sid.shape[1]
    h, w = spins.shape[2:]
    if uniforms is None:
        uniforms = _philox_source(sweep_words, n_slots, (h, w))
    e = torch.empty((d, n, n_slots), dtype=torch.float32, device=spins.device)
    m = torch.empty((d, n, n_slots), dtype=torch.int32, device=spins.device)
    draws = (pt_draws(pt_words, n_slots - 1, pt_full=pt_full)
             if pt_interval is not None else None)
    sys_temps = slot_temps_for_systems(sid, temps)
    for t in range(n):
        colour_pass_plain(spins, jgrids, sid, temps, None, 0, gibbs=gibbs,
                          u=uniforms(t, 0))
        e_part, m_part = colour_pass_plain(spins, jgrids, sid, temps, None, 1,
                                           gibbs=gibbs, u=uniforms(t, 1))
        parity = pt_step_plain(
            e_part, m_part, e[:, t], m[:, t], sid, ea, ec, rtrips, tstate,
            temps, None if draws is None else _index(draws, t), sys_temps,
            do_pt=_pt_due(sweep_base, t, pt_interval), pt_full=pt_full,
            parity=parity, hot_slot=hot_slot, cold_slot=cold_slot,
            n_spins=h * w,
        )
    return e, m, parity


def _index(draws, t):
    return tuple(x[t] for x in draws) if isinstance(draws, tuple) else draws[t]


# ------------------------------------------------------------ resident layout


class ResidentPlan(NamedTuple):
    """How ``mega_resident`` lays out each system: a cluster of ``cluster``
    CTAs of ``threads`` threads, each holding ``rows`` lattice rows in
    ``smem`` bytes of shared memory."""

    cluster: int
    rows: int
    threads: int
    smem: int


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def resident_smem(h: int, w: int, cluster: int, n_slots: int) -> int:
    """Shared memory of one CTA of ``mega_resident`` (``layout`` in
    ``csrc/mega_resident.cu``): its rows' int8 spins with a halo row on
    either side, the down couplings of one row more and the right couplings
    of its rows (f32, by colour), a Philox block and an (e, m) per logical
    thread, the system's row of partials, the PT state and a sweep's PT
    draws."""
    rows, wh = h // cluster, w // 2
    return (_round16(_round16(w) + (rows + 1) * w) + _round16(8 * (rows + 1) * wh)
            + _round16(8 * rows * wh) + _round16(16 * (rows * wh // 4))
            + _round16(8 * (rows * wh // 4))
            + _round16(8 * (h * wh // BLOCK_SITES))
            + _round16(4 * (6 * n_slots + 4 * (n_slots - 1) + 1)))


def resident_plan(h, w, d, n_slots, smem_per_block, max_clusters):
    """The resident kernel's layout of ``d`` realizations of ``n_slots``
    ``[h, w]`` systems, or ``None``: then the chunk runs three launches a
    sweep.

    The smallest cluster of :data:`RESIDENT_CLUSTERS` whose CTAs hold whole
    logical blocks of both colours (``rows * w / 2`` a multiple of
    :data:`BLOCK_SITES`), in at most ``smem_per_block`` bytes each, and of
    which the card runs all ``d * n_slots`` at once: ``max_clusters(cluster,
    threads, smem)`` is the card's count (``cudaOccupancyMaxActiveClusters``).
    ``w`` must be a multiple of 8 (a thread's 4 sites in one 8-byte word), a
    system's row of partials one share of ``pt_step`` (:func:`pt_split`),
    the order the kernel adds it in, and the ladder at least one edge."""
    if w % 8 or n_slots < 2 or pt_split(h * w // 2 // BLOCK_SITES) != 1:
        return None
    for c in RESIDENT_CLUSTERS:
        rows = h // c
        if h % c or (rows * w // 2) % BLOCK_SITES:
            continue
        smem = resident_smem(h, w, c, n_slots)
        threads = min(RESIDENT_MAX_THREADS, rows * w // 8)
        if smem <= smem_per_block and d * n_slots <= max_clusters(c, threads, smem):
            return ResidentPlan(c, rows, threads, smem)
    return None


# device -> (the shared memory a block may opt in to, {(cluster, threads,
# smem): clusters resident at once}): the card's numbers resident_plan reads
_CARD = {}


def resident_route(dev, h, w, d, n_slots):
    """:func:`resident_plan` with the numbers of the card ``dev``."""
    lib = _build.library()
    if dev not in _CARD:
        with torch.cuda.device(dev):
            limit = lib.peapods_smem_per_block_optin()
        if limit < 0:
            raise RuntimeError("cudaDeviceGetAttribute failed")
        _CARD[dev] = (limit, {})
    limit, counts = _CARD[dev]

    def max_clusters(c, threads, smem):
        key = (c, threads, smem)
        if key not in counts:
            with torch.cuda.device(dev):
                got = lib.peapods_resident_max_clusters(*key)
            _build.check(-min(got, 0), "cudaOccupancyMaxActiveClusters")
            counts[key] = got
        return counts[key]

    return resident_plan(h, w, d, n_slots, limit, max_clusters)


def resident_partition(h, w, cluster, threads):
    """Plain mirror of how ``mega_resident`` splits one ``[h, w]`` system
    over a cluster of ``cluster`` CTAs of ``threads`` threads.

    Colour site ``i`` of colour ``c`` sits at row ``i // (w/2)``, column
    ``2 (i % (w/2)) + ((row + c) & 1)`` (``colour_pass``'s order).  Returns
    int64 tensors ``[h w / 2]`` by ``i``: ``rank`` (the CTA that holds the
    row), ``block`` (the partial of the system's row it adds into),
    ``group`` and ``word`` (the Philox counter's g and the word k it takes),
    ``thread`` and ``step`` (the thread that updates it, in which turn of
    that thread's loop), ``row``; and ``col`` ``[2, h w / 2]`` by colour."""
    wh, rows = w // 2, h // cluster
    per_row = wh // 4
    i = torch.arange(h * wh)
    row, j = i // wh, i % wh
    rank = row // rows
    local = (row - rank * rows) * per_row + j // 4
    return dict(
        rank=rank, block=rank * (rows * per_row // REDUCE_LANES) + local // REDUCE_LANES,
        group=rank * rows * per_row + local, word=j % 4, thread=local % threads,
        step=local // threads, row=row,
        col=torch.stack([2 * j + ((row + c) & 1) for c in (0, 1)]))


# ------------------------------------------------------------ CUDA kernels


def colour_pass_partials(spins, jgrids, sid, temps, words, *, gibbs, u=None):
    """A colour-1 pass as :func:`colour_pass_plain` (in place), returning
    the ``colour_pass`` kernel's partials ``(e_part f32, m_part int32)``
    ``[d, n_systems, colour_pass_blocks]`` by system in its order of adds:
    the pass's site terms (``s * field`` of each odd site, ``s`` of both
    sites of its pair along the fast axis) in the order of the colour's
    sites, four a thread, 256 threads a block
    (:func:`~.fk.block_partials_plain`)."""
    from .fk import block_partials_plain

    d, n_slots, shape = spins.shape[0], sid.shape[1], tuple(spins.shape[2:])
    nd = len(shape)
    if u is None:
        u = colour_uniforms(words, n_slots, 1, shape)
    di = torch.arange(d, device=spins.device)[:, None]
    sys = sid.to(torch.int64)
    inv_half_t = (1.0 / (0.5 * temps)).reshape((1, n_slots) + (1,) * nd)
    s, field = colour_update(spins[di, sys].to(torch.float32), jgrids[:, None],
                             inv_half_t, u, 1, gibbs=gibbs, n_dims=nd)
    spins[di, sys] = s.to(torch.int8)
    e = (s * field)[..., colour_mask(shape, 1, spins.device)]
    m = s.to(torch.int32).reshape(d, n_slots, -1, 2).sum(-1, dtype=torch.int32)
    ep, mp = block_partials_plain(e, 4), block_partials_plain(m, 4)
    e_part = torch.empty_like(ep)
    m_part = torch.empty_like(mp)
    e_part[di, sys] = ep
    m_part[di, sys] = mp
    return e_part, m_part


def _check_sweep(spins, jgrids, sid, temps):
    """Validate the colour pass's tensors; returns ``(d, n_slots, L0, L1,
    L2)`` (``L2 = 1`` for a 2D lattice)."""
    dev = spins.device
    d, n_sys, *shape = spins.shape
    n_slots = sid.shape[1]
    if len(shape) not in (2, 3):
        raise ValueError(f"spins must be [d, n_systems, *shape] of a 2D or 3D "
                         f"lattice, got {tuple(spins.shape)}")
    _expect(spins, "spins", torch.int8, (d, n_sys, *shape), dev)
    _expect(jgrids, "jgrids", torch.float32, (d, 2 * len(shape), *shape), dev)
    _expect(sid, "sid", torch.int32, (d, n_slots), dev)
    _expect(temps, "temps", torch.float32, (n_slots,), dev)
    if n_sys != n_slots:
        raise ValueError("every system sits at one slot: n_systems == n_slots")
    if d > 65535 or n_slots > 65535:
        raise ValueError("at most 65535 realizations and slots")
    return (d, n_slots, *_build.dims3(shape))


def _check_pt(d, n_slots, dev, ea, ec, rtrips, tstate, n_replicas=1):
    n_edges = max(n_slots // n_replicas - 1, 0)
    for name, t, shape in (("ea", ea, (d, n_edges)), ("ec", ec, (d, n_edges)),
                           ("rtrips", rtrips, (d, n_slots)),
                           ("tstate", tstate, (d, n_slots))):
        _expect(t, name, torch.int32, shape, dev)


def _partials(lib, d, n_slots, l0, l1, l2, dev):
    """The measuring pass's partial-sum rows, ``[d, n_slots, blocks]``."""
    nb = lib.peapods_colour_pass_blocks(l0 * l1 if l2 > 1 else l0,
                                        l2 if l2 > 1 else l1)
    return (torch.empty((d, n_slots, nb), dtype=torch.float32, device=dev),
            torch.empty((d, n_slots, nb), dtype=torch.int32, device=dev))


def _launch_colour(lib, stream, shape, spins, jgrids, sid, temps, words,
                   e_part, m_part, colour, gibbs, plan):
    """Launch ``colour_pass``; pointers are ints (``None`` for no partials);
    ``shape`` is ``(d, n_slots, L0, L1, L2)``, ``plan`` its
    :func:`colour_plan`."""
    _build.check(lib.peapods_colour_pass(
        spins, jgrids, sid, temps, words, e_part, m_part, *shape,
        colour, int(gibbs), plan.words.ctypes.data, stream,
    ), "colour_pass")
    LAUNCHES["colour_pass"] += 1


def _colour_plan(dev, shape):
    """:func:`colour_plan` of a launch on ``dev``, keeping a quarter of its
    resident threads; ``shape`` is ``(d, n_slots, L0, L1, L2)``."""
    from .fk import resident_threads

    return colour_plan(tuple(shape[2:]), shape[0], shape[1],
                       resident_threads(dev.index) // 4)


# device -> (ticket int32, part_e f32, part_m int32): the cross-CTA sums
# of pt_step, grown on demand.  The tickets start at zero and every launch
# leaves them zero; the port runs a device's launches on one stream.
_PT_SCRATCH = {}


def _pt_scratch(dev, d, n_slots, split):
    """Pointers ``(part_e, part_m, ticket)`` of a launch whose rows are split
    over ``split`` CTAs (``None`` each for one CTA a row)."""
    if split == 1:
        return None, None, None
    buf = _PT_SCRATCH.get(dev)
    n = d * n_slots * split
    if buf is None or buf[0].numel() < d or buf[1].numel() < n:
        if buf is not None:
            d, n = max(d, buf[0].numel()), max(n, buf[1].numel())
        buf = (torch.zeros(d, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
        _PT_SCRATCH[dev] = buf
    return buf[1].data_ptr(), buf[2].data_ptr(), buf[0].data_ptr()


def _launch_pt(lib, stream, dev, d, n_slots, n_spins, e_part, m_part, n_blocks,
               e_row, m_row, out_stride, sid, ea, ec, rtrips, tstate, temps,
               edge_draw, u_draw, sys_temps, *, do_pt, pt_full, parity,
               hot_slot, cold_slot, n_replicas=1) -> int:
    """Launch ``pt_step`` on ``dev``; pointers are ints (``None`` for draws
    that the event does not read, and for rows that are not written).
    Returns the next parity."""
    split = pt_split(n_blocks)
    _build.check(lib.peapods_pt_step(
        e_part, m_part, n_blocks, split, *_pt_scratch(dev, d, n_slots, split),
        e_row, m_row, out_stride, sid, ea, ec, rtrips, tstate, temps, edge_draw,
        u_draw, sys_temps, d, n_slots, n_replicas, n_spins, int(do_pt),
        int(pt_full), int(parity), hot_slot, cold_slot, stream,
    ), "pt_step")
    LAUNCHES["pt_step"] += 1
    return 1 - parity if (do_pt and pt_full) else parity


# ------------------------------------------------------------ dispatch


def colour_pass(spins, jgrids, sid, temps, words, colour, *, gibbs):
    """One colour pass (see :func:`colour_pass_plain`): the plain version
    for CPU tensors, the ``colour_pass`` kernel for CUDA tensors.  The
    kernel's partials have one entry per block of the pass."""
    if _device_kind(spins) == "cpu":
        return colour_pass_plain(spins, jgrids, sid, temps, words, colour,
                                 gibbs=gibbs)
    shape = _check_sweep(spins, jgrids, sid, temps)
    dev = spins.device
    _expect(words, "words", torch.int32, (shape[0], 2), dev)
    lib = _build.library()
    parts = _partials(lib, *shape, dev) if colour == 1 else (None, None)
    ptrs = [None if t is None else t.data_ptr() for t in parts]
    _launch_colour(lib, torch.cuda.current_stream(dev).cuda_stream, shape,
                   spins.data_ptr(), jgrids.data_ptr(), sid.data_ptr(),
                   temps.data_ptr(), words.data_ptr(), *ptrs, colour, gibbs,
                   _colour_plan(dev, shape))
    return parts if colour == 1 else None


def _draw_ptrs(draws, d, n_slots, pt_full, dev, n_replicas=1):
    """``(edge_draw, u_draw)`` pointers of one event's PT draws, ``[d, R,
    ...]`` (or ``[d, ...]`` with one ladder)."""
    if draws is None:
        return None, None
    lead = (d, n_replicas)
    if n_replicas == 1 and (draws.dim() == 3 if pt_full else draws[1].dim() == 1):
        lead = (d,)
    if pt_full:
        n_edges = max(n_slots // n_replicas - 1, 0)
        _expect(draws, "draws", torch.float32, lead + (2, n_edges), dev)
        return None, draws.data_ptr()
    edge, u = draws
    _expect(edge, "edge draws", torch.int32, lead, dev)
    _expect(u, "u draws", torch.float32, lead, dev)
    return edge.data_ptr(), u.data_ptr()


def pt_step(e_part, m_part, e_row, m_row, sid, ea, ec, rtrips, tstate, temps,
            draws, sys_temps, *, do_pt, pt_full, parity, hot_slot, cold_slot,
            n_spins, n_replicas=1) -> int:
    """Reduce a sweep's partials and run its PT event (see
    :func:`pt_step_plain`): plain for CPU tensors, the ``pt_step`` kernel
    for CUDA tensors.  ``e_row`` / ``m_row`` are ``[d, n_slots]`` views with
    unit stride along the slots and equal row strides (or both ``None``);
    single-edge draws are int32 edges and f32 uniforms."""
    kw = dict(do_pt=do_pt, pt_full=pt_full, parity=parity, hot_slot=hot_slot,
              cold_slot=cold_slot, n_replicas=n_replicas)
    if _device_kind(e_part) == "cpu":
        return pt_step_plain(e_part, m_part, e_row, m_row, sid, ea, ec, rtrips,
                             tstate, temps, draws, sys_temps, n_spins=n_spins,
                             **kw)
    dev = e_part.device
    d, n_slots, n_blocks = e_part.shape
    _expect(e_part, "e_part", torch.float32, (d, n_slots, n_blocks), dev)
    _expect(m_part, "m_part", torch.int32, (d, n_slots, n_blocks), dev)
    _expect(sid, "sid", torch.int32, (d, n_slots), dev)
    _expect(temps, "temps", torch.float32, (n_slots,), dev)
    _expect(sys_temps, "sys_temps", torch.float32, (d, n_slots), dev)
    if n_replicas < 1 or n_slots % n_replicas:
        raise ValueError(f"{n_slots} slots do not split into {n_replicas} ladders")
    if do_pt and draws is None:
        raise ValueError("a PT event needs its draws")
    edge_draw, u_draw = _draw_ptrs(draws, d, n_slots, pt_full, dev, n_replicas)
    _check_pt(d, n_slots, dev, ea, ec, rtrips, tstate, n_replicas)
    rows = (None, None, 0)
    if e_row is not None:
        for name, t, dtype in (("e_row", e_row, torch.float32),
                               ("m_row", m_row, torch.int32)):
            if (t.device != dev or t.dtype != dtype
                    or tuple(t.shape) != (d, n_slots) or t.stride(1) != 1
                    or t.stride(0) != e_row.stride(0)):
                raise ValueError(f"{name} must be a {dtype} [d, n_slots] row view")
        rows = (e_row.data_ptr(), m_row.data_ptr(), e_row.stride(0))
    return _launch_pt(
        _build.library(), torch.cuda.current_stream(dev).cuda_stream, dev,
        d, n_slots, n_spins, e_part.data_ptr(), m_part.data_ptr(),
        n_blocks, *rows, sid.data_ptr(), ea.data_ptr(), ec.data_ptr(),
        rtrips.data_ptr(), tstate.data_ptr(), temps.data_ptr(), edge_draw,
        u_draw, sys_temps.data_ptr(), **kw,
    )


def _check_chunk(spins, jgrids, temps, sid, ea, ec, rtrips, tstate, sweep_words,
                 pt_words):
    """Validate a chunk's tensors; returns ``(d, n_slots, H, W, n)``."""
    d, n_slots, h, w, l2 = _check_sweep(spins, jgrids, sid, temps)
    if l2 != 1:
        raise ValueError("the mega path runs 2D lattices")
    dev = spins.device
    n = sweep_words.shape[0]
    _check_pt(d, n_slots, dev, ea, ec, rtrips, tstate)
    _expect(sweep_words, "sweep_words", torch.int32, (n, d, 2), dev)
    _expect(pt_words, "pt_words", torch.int32, (n, d, 2), dev)
    return d, n_slots, h, w, n


def _chunk_draws(pt_words, n_slots, pt_interval, pt_full):
    """The chunk's PT draws, made from its words on the device in one go:
    ``(edges int32 [n, d] or None, u f32 [n, d] or [n, d, 2, n_edges])``,
    both ``None`` without PT; the kernels read them as the per-sweep path's
    jnp-form draws."""
    if pt_interval is None:
        return None, None
    draws = pt_draws(pt_words, n_slots - 1, pt_full=pt_full)
    if pt_full:
        return None, draws.contiguous()
    return draws[0].to(torch.int32).contiguous(), draws[1].contiguous()


def mega_chunk(spins, jgrids, temps, sid, ea, ec, rtrips, tstate, sweep_words,
               pt_words, *, sweep_base, parity, gibbs, pt_interval, pt_full,
               hot_slot, cold_slot):
    """Run ``n`` sweeps (+ fused measurement + PT) on every realization:
    the plain version for CPU tensors; for CUDA tensors one
    ``mega_resident`` launch where :func:`resident_route` finds a layout,
    else three launches a sweep (:func:`mega_chunk_launches`).

    Args:
        spins: int8 ``[d, n_systems, H, W]`` by system, updated in place.
        jgrids: f32 ``[d, 4, H, W]`` pre-shifted coupling grids
            (:func:`~.sweep.pack_coupling_grids`).
        temps: f32 ``[n_slots]``.
        sid: int32 ``[d, n_slots]`` system at each slot, updated in place.
        ea, ec: int32 ``[d, n_edges]`` PT edge attempts / acceptances.
        rtrips, tstate: int32 ``[d, n_systems]`` round trips / trip state.
        sweep_words, pt_words: int32 ``[n, d, 2]`` per-sweep key words.
        sweep_base: index of the chunk's first sweep within the sample()
            call; a sweep runs PT iff its index is a multiple of
            ``pt_interval`` (``None``: no PT).
        parity: full-ladder parity of the next PT event.

    Returns:
        ``(e f32 [d, n, n_slots], m int32 [d, n, n_slots], parity)``: per
        sweep, each slot's energy per spin and magnetization sum, and the
        parity of the next PT event.
    """
    args = (spins, jgrids, temps, sid, ea, ec, rtrips, tstate, sweep_words,
            pt_words)
    kw = dict(sweep_base=sweep_base, parity=parity, gibbs=gibbs,
              pt_interval=pt_interval, pt_full=pt_full, hot_slot=hot_slot,
              cold_slot=cold_slot)
    if _device_kind(spins) == "cpu":
        return mega_chunk_plain(*args, **kw)
    d, n_slots, h, w, _ = _check_chunk(*args)
    plan = resident_route(spins.device, h, w, d, n_slots)
    if plan is None:
        return mega_chunk_launches(*args, **kw)
    return mega_chunk_resident(*args, plan=plan, **kw)


def mega_chunk_launches(spins, jgrids, temps, sid, ea, ec, rtrips, tstate,
                        sweep_words, pt_words, *, sweep_base, parity, gibbs,
                        pt_interval, pt_full, hot_slot, cold_slot):
    """:func:`mega_chunk` on CUDA tensors as three launches a sweep
    (``colour_pass`` twice, ``pt_step``)."""
    d, n_slots, h, w, n = _check_chunk(spins, jgrids, temps, sid, ea, ec, rtrips,
                                       tstate, sweep_words, pt_words)
    shape = (d, n_slots, h, w, 1)
    dev = spins.device
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    e_part, m_part = _partials(lib, *shape, dev)
    e = torch.empty((d, n, n_slots), dtype=torch.float32, device=dev)
    m = torch.empty((d, n, n_slots), dtype=torch.int32, device=dev)
    edges, u = _chunk_draws(pt_words, n_slots, pt_interval, pt_full)
    p_edge = None if edges is None else edges.data_ptr()
    p_u = None if u is None else u.data_ptr()
    edge_bytes = d * 4  # one sweep's draws
    u_bytes = 0 if u is None else u[0].numel() * 4
    sys_temps = slot_temps_for_systems(sid, temps)  # written, not read here
    p_spins, p_jg, p_sid, p_temps = (t.data_ptr() for t in (spins, jgrids, sid, temps))
    p_ep, p_mp, p_e, p_m = (t.data_ptr() for t in (e_part, m_part, e, m))
    p_pt = [t.data_ptr() for t in (ea, ec, rtrips, tstate)]
    p_sw = sweep_words.data_ptr()
    word_bytes = d * 2 * 4  # one sweep's [d, 2] int32 words
    row_bytes = n_slots * 4  # one sweep's [n_slots] row of e or m
    plan = _colour_plan(dev, shape)
    for t in range(n):
        for colour, parts in ((0, (None, None)), (1, (p_ep, p_mp))):
            _launch_colour(lib, stream, shape, p_spins, p_jg, p_sid, p_temps,
                           p_sw + t * word_bytes, *parts, colour, gibbs, plan)
        do_pt = _pt_due(sweep_base, t, pt_interval)
        parity = _launch_pt(
            lib, stream, dev, d, n_slots, h * w, p_ep, p_mp, e_part.shape[2],
            p_e + t * row_bytes, p_m + t * row_bytes, n * n_slots, p_sid,
            *p_pt, p_temps,
            p_edge + t * edge_bytes if do_pt and p_edge is not None else None,
            p_u + t * u_bytes if do_pt else None, sys_temps.data_ptr(),
            do_pt=do_pt, pt_full=pt_full, parity=parity, hot_slot=hot_slot,
            cold_slot=cold_slot,
        )
    return e, m, parity


# device -> int64 scratch of the resident kernel: per PT event each system's
# tagged sum and the single-edge outcome of each realization, grown on
# demand; the kernel's entry point sets it before each launch
_RESIDENT_SCRATCH = {}


def _pt_events(n, sweep_base, pt_interval) -> int:
    return sum(_pt_due(sweep_base, t, pt_interval) for t in range(n))


def mega_chunk_resident(spins, jgrids, temps, sid, ea, ec, rtrips, tstate,
                        sweep_words, pt_words, *, sweep_base, parity, gibbs,
                        pt_interval, pt_full, hot_slot, cold_slot, plan=None):
    """:func:`mega_chunk` on CUDA tensors as one launch of
    ``mega_resident``, laid out by ``plan`` (:func:`resident_route`'s by
    default; a shape without a layout raises)."""
    d, n_slots, h, w, n = _check_chunk(spins, jgrids, temps, sid, ea, ec, rtrips,
                                       tstate, sweep_words, pt_words)
    dev = spins.device
    if plan is None:
        plan = resident_route(dev, h, w, d, n_slots)
    if plan is None:
        raise ValueError(f"no resident layout of {d} x {n_slots} systems of "
                         f"{h} x {w} on {dev}")
    if spins.data_ptr() % 16:
        raise ValueError("spins must be 16-byte aligned")
    events = _pt_events(n, sweep_base, pt_interval)
    scratch = _RESIDENT_SCRATCH.get(dev)
    if scratch is None or scratch.numel() < events * d * (n_slots + 1):
        scratch = torch.empty(max(1, events * d * (n_slots + 1)), dtype=torch.int64,
                              device=dev)
        _RESIDENT_SCRATCH[dev] = scratch
    e = torch.empty((d, n, n_slots), dtype=torch.float32, device=dev)
    m = torch.empty((d, n, n_slots), dtype=torch.int32, device=dev)
    edges, u = _chunk_draws(pt_words, n_slots, pt_interval, pt_full)
    _build.check(_build.library().peapods_mega_resident(
        spins.data_ptr(), jgrids.data_ptr(), temps.data_ptr(), sid.data_ptr(),
        ea.data_ptr(), ec.data_ptr(), rtrips.data_ptr(), tstate.data_ptr(),
        sweep_words.data_ptr(), None if edges is None else edges.data_ptr(),
        None if u is None else u.data_ptr(), e.data_ptr(), m.data_ptr(),
        scratch.data_ptr(), d, n_slots, h, w, n, sweep_base,
        pt_interval or 0, int(pt_full), int(parity), int(gibbs), hot_slot,
        cold_slot, plan.cluster, plan.threads, plan.smem,
        torch.cuda.current_stream(dev).cuda_stream,
    ), "mega_resident")
    LAUNCHES["mega_resident"] += 1
    return e, m, (parity + events) % 2 if pt_full else parity
