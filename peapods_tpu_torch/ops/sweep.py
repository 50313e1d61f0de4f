"""The checkerboard colour update of a 2D square or 3D cubic lattice, and
the stand-alone sweep of the per-sweep path.

Counterpart of ``_kernel_body`` / ``_kernel_body_2sub``
(``peapods_tpu/ops/pallas_sweep.py:164-291``) and of ``mc_sweep``
(``peapods_tpu/ops/sweep.py``): the CPU version of the update, and the
version the CUDA kernels are held against on the card.  Same math, in the
same order of f32 operations as the kernels:

    field = s_up*ju + s_down*jd + s_left*jl + s_right*jr
            [+ s_zm*jzm + s_zp*jzp in 3D, pallas_megapair._mp_body]
    x     = (-s * field) * (1 / (0.5 * T))
    Metropolis: flip iff u < (15/16) * exp(min(x, 0))
    Gibbs:      flip iff u < 1 / (1 + exp(-x))

The lazy factor ``1 - 1/16`` keeps the synchronous Metropolis chain
ergodic (see the docstring of ``peapods_tpu/ops/sweep.py``).

:func:`sweep_2d` is the port of ``pallas_sweep.sweep_2d`` (:728): one sweep
of every (realization, system) at each system's temperature, for runs with
a cluster phase, given the forward couplings ``[d, H W, 2]``.  On CUDA
tensors it launches ``csrc/sweep.cu`` twice (one launch per colour) and
counts them in :data:`LAUNCHES`; on CPU tensors it runs
:func:`sweep_2d_plain` on their pre-shifted grids
(:func:`pack_coupling_grids`), which draws the same Philox uniforms.
With ``measure=True`` its second pass also writes per-block (e, m)
partials of the swept spins: the counterpart of ``sweep_2d_fused``
(``pallas_sweep.py:892``, kernel ``_kernel_fused`` :313), the sweep plus
measurement of every sweep without an FK update, FK observe sweeps
included.  It is one kernel, not a second one.

:func:`sweep_nb` is the sweep of every other lattice (triangular, BCC, FCC,
3D cubic with one replica, any offset table): one pass per colour of the
lattice's greedy colouring, the port of ``pallas_sweep_tri``,
``pallas_sweep3d``, ``pallas_sweep_diag.sweep_diag`` and ``sweep_gen``,
which all compute ``mc_sweep`` (``peapods_tpu/ops/sweep.py:74-123``).  Its
plain version is :func:`mc_sweep` with the reference's order of adds
(``local_fields`` :53-71) and rules::

    Metropolis: flip iff u < (15/16) * exp(min(-s * field * (1 / (T/2)), 0))
    Gibbs:      flip iff -s * field >= (T/2) * ln(u / (1 - u))

On CUDA tensors it launches ``csrc/sweep_nb.cu`` once per colour.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build, rng
from .energy import per_spin
from .fk import block_partials_plain, resident_threads
from .lattice import check_tables, fast_divisor, neighbour_values

__all__ = [
    "METROPOLIS_LAZINESS",
    "LAUNCHES",
    "pack_coupling_grids",
    "local_field",
    "acceptance",
    "colour_mask",
    "colour_update",
    "sweep",
    "sweep_2d",
    "sweep_2d_plain",
    "sweep_2d_partials",
    "systems_per",
    "table_sweep_plan",
    "nb_local_fields",
    "mc_sweep",
    "sweep_nb",
    "sweep_nb_plain",
]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"sweep_2d": 0, "sweep_nb": 0, "sweep_nb_table": 0}

# Acceptance-probability scale 1-eps of the lazy synchronous Metropolis
# kernel (peapods_tpu/ops/sweep.py:50).
METROPOLIS_LAZINESS = 1.0 / 16.0
_KEEP = 1.0 - METROPOLIS_LAZINESS


def pack_coupling_grids(coup_fwd, shape):
    """``[..., 2 n_dims, *shape]`` pre-shifted coupling grids from forward
    couplings ``[..., n_spins, n_dims]``: per axis ``d``, the bond arriving
    from ``-d`` and the site's own forward bond (pallas_sweep.py:239-247,
    pallas_megapair.pack_coupling_grids_mp :146-164).  In 2D (ju, jd, jl,
    jr)::

        ju[i,j] = J0[i-1,j]   jd[i,j] = J0[i,j]
        jl[i,j] = J1[i,j-1]   jr[i,j] = J1[i,j]
    """
    shape = tuple(shape)
    nd = len(shape)
    lead = coup_fwd.shape[:-2]
    grids = []
    for d in range(nd):
        j = coup_fwd[..., d].reshape(*lead, *shape)
        grids += [torch.roll(j, 1, d - nd), j]
    return torch.stack(grids, dim=-nd - 1)


def local_field(s, jgrids, n_dims: int = 2):
    """f32 local field of every site: ``s`` f32 ``[..., *shape]``,
    ``jgrids`` ``[..., 2 n_dims, *shape]``; the terms are added in the
    order -x, +x, -y, +y[, -z, +z]."""
    field = None
    for d in range(n_dims):
        ax = d - n_dims
        for k, shift in ((2 * d, 1), (2 * d + 1, -1)):
            term = torch.roll(s, shift, ax) * jgrids.select(-n_dims - 1, k)
            field = term if field is None else field + term
    return field


def acceptance(x, *, gibbs: bool):
    """Flip probability for ``x = -s * field / (T/2)``."""
    if gibbs:
        return 1.0 / (1.0 + torch.exp(-x))
    return _KEEP * torch.exp(torch.clamp(x, max=0.0))


def colour_mask(shape, colour, device):
    """bool ``shape``: the sites of one checkerboard colour
    (``sum(coords) & 1 == colour``)."""
    par = torch.zeros((), dtype=torch.int64, device=device)
    for d, n in enumerate(shape):
        idx = torch.arange(n, device=device)
        par = par + idx.reshape((n,) + (1,) * (len(shape) - 1 - d))
    return (par & 1) == colour


def colour_update(s, jgrids, inv_half_t, u, colour: int, *, gibbs: bool,
                  n_dims: int = 2):
    """Update the sites of one colour of a full lattice.

    Args:
        s: f32 ``[..., *shape]`` spins (+-1).
        jgrids: ``[..., 2 n_dims, *shape]`` from :func:`pack_coupling_grids`.
        inv_half_t: f32 ``1 / (0.5 * T)``, broadcast against ``[...]``.
        u: f32 ``[..., *shape]`` uniforms; only the active colour's are read.
        colour: 0 updates the sites with even coordinate sum, 1 the odd ones.

    Returns:
        ``(s_new, field)``: the updated spins and the field they saw.
    """
    field = local_field(s, jgrids, n_dims)
    x = (-s * field) * inv_half_t
    flip = (u < acceptance(x, gibbs=gibbs)) & colour_mask(
        s.shape[-n_dims:], colour, s.device
    )
    return torch.where(flip, -s, s), field


def sweep(spins, jgrids, temps, uniforms, *, gibbs: bool):
    """Both colours of every system, with the fused measurement.

    Args:
        spins: int8 ``[..., H, W]``.
        jgrids: ``[..., 4, H, W]`` (broadcast against the systems).
        temps: f32 ``[...]`` temperature of each system.
        uniforms: f32 ``[..., 2, H, W]``, colour ``c``'s at ``[..., c]``
            (the layout of ``sweep_2d_injected``).

    Returns:
        ``(spins int8, e f32 [...], m int32 [...])``.  ``e`` is the positive
        forward-bond energy per spin, read off the odd pass for free: that
        pass's field is evaluated on the final even spins and every bond
        joins one even and one odd site (pallas_sweep.py:176-180).
    """
    s = spins.to(torch.float32)
    inv_half_t = (1.0 / (0.5 * temps))[..., None, None]
    s, _ = colour_update(s, jgrids, inv_half_t, uniforms[..., 0, :, :], 0,
                         gibbs=gibbs)
    s, field = colour_update(s, jgrids, inv_half_t, uniforms[..., 1, :, :], 1,
                             gibbs=gibbs)
    odd = colour_mask(s.shape[-2:], 1, s.device)
    e_tot = torch.where(odd, s * field, 0.0).sum((-2, -1))
    h, w = s.shape[-2:]
    m = s.to(torch.int32).sum((-2, -1), dtype=torch.int32)
    return s.to(torch.int8), per_spin(e_tot, h * w), m


def _sweep_2d_passes(spins, jgrids, sys_temps, words, gibbs, uniforms):
    """Both colour passes of every (realization, system), in place; returns
    the f32 spins after them and the colour-1 pass's field."""
    d, n_sys, h, w = spins.shape
    s = spins.to(torch.float32)
    inv_half_t = (1.0 / (0.5 * sys_temps))[..., None, None]
    for colour in (0, 1):
        u = (uniforms[:, :, colour] if uniforms is not None
             else rng.colour_uniforms(words, n_sys, colour, (h, w)))
        s, field = colour_update(s, jgrids[:, None], inv_half_t, u, colour,
                                 gibbs=gibbs)
    spins.copy_(s.to(torch.int8))
    return s, field


def sweep_2d_plain(spins, jgrids, sys_temps, words, *, gibbs, measure=False,
                   uniforms=None):
    """One sweep (colour 0, then colour 1) of every (realization, system),
    in place.

    Args:
        spins: int8 ``[d, S, H, W]`` by system.
        jgrids: f32 ``[d, 4, H, W]``.
        sys_temps: f32 ``[d, S]`` temperature of each system.
        words: int32 ``[d, 2]`` the sweep's key words (unused when
            ``uniforms`` is given): Philox key, counter ``(system, colour,
            site // 4, 0)``.
        uniforms: optional f32 ``[d, S, 2, H, W]`` injected uniforms (the
            layout of ``pallas_sweep.sweep_2d_injected``).
        measure: also return the post-sweep partial sums ``(e_part f32
            [d, S, 1], m_part int32 [d, S, 1])`` of ``s * field`` over the
            odd sites and of ``s``.

    Returns:
        The partials when ``measure``, else ``None``.
    """
    s, field = _sweep_2d_passes(spins, jgrids, sys_temps, words, gibbs, uniforms)
    if not measure:
        return None
    odd = colour_mask(spins.shape[-2:], 1, s.device)
    e_part = torch.where(odd, s * field, 0.0).sum((-2, -1))
    m_part = s.to(torch.int32).sum((-2, -1), dtype=torch.int32)
    return e_part[..., None], m_part[..., None]


def sweep_2d_partials(spins, jgrids, sys_temps, words, *, gibbs, uniforms=None):
    """One sweep as :func:`sweep_2d_plain` (in place), returning the
    ``sweep_2d`` kernel's partials ``(e_part f32, m_part int32)`` ``[d, S,
    colour_pass_blocks(H, W)]`` in its order of adds: the colour-1 pass's
    site terms (``s * field`` of each odd site, ``s`` of both sites of its
    column pair) in the order of the colour's sites, four a thread, 256
    threads a block (:func:`~.fk.block_partials_plain`)."""
    d, n_sys, h, w = spins.shape
    s, field = _sweep_2d_passes(spins, jgrids, sys_temps, words, gibbs, uniforms)
    e = (s * field)[..., colour_mask((h, w), 1, s.device)]
    m = spins.to(torch.int32).reshape(d, n_sys, h * w // 2, 2).sum(-1, dtype=torch.int32)
    return block_partials_plain(e, 4), block_partials_plain(m, 4)


# sweep_2d and sweep_nb (csrc/sweep.cu, csrc/sweep_nb.cu): a thread takes a
# group of four sites of `per` systems of one realization, which share its
# couplings; at most MAX_PER (the measuring launch's shared rows).  A launch
# keeps at least half the card's resident threads (tools/probe_sweep.py,
# NVIDIA H100 80GB HBM3: sweep_2d at the harness shape 0.0208 ms a pass
# with 2 systems a thread, 0.0185 with 4 (262,144 threads), 0.0180 with 8;
# sweep_nb at 32^3 x 16 0.0077 with 1, 0.0081 with 2 (65,536 threads)).
MAX_PER = 8


def systems_per(n_groups: int, n_disorder: int, n_systems: int, threads: int) -> int:
    """The systems a thread of ``sweep_2d`` / ``sweep_nb`` takes in turn:
    the largest divisor of ``n_systems`` up to :data:`MAX_PER` whose launch
    of ``n_groups`` groups a system still has ``threads`` threads (half the
    card's resident threads, :func:`~.fk.resident_threads`); 1 where none
    has."""
    groups = int(n_groups) * int(n_disorder)
    fits = [p for p in range(1, min(int(n_systems), MAX_PER) + 1)
            if n_systems % p == 0 and groups * (n_systems // p) >= threads]
    return max(fits, default=1)


def _per(spins, n_groups, d, n_sys):
    return systems_per(n_groups, d, n_sys, resident_threads(spins.device.index) // 2)


class TablePlan(NamedTuple):
    """``sweep_nb_table``'s launch of one colour: the systems a thread
    (``per``) and a CTA's threads."""

    per: int
    threads: int


# csrc/mega.cuh kThreads: the most threads a sweep_nb_table CTA takes
TABLE_THREADS = 256


@functools.lru_cache(maxsize=None)
def table_sweep_plan(count: int, n_disorder: int, n_systems: int, threads: int,
                     sms: int) -> TablePlan:
    """The table form's colour pass over ``count`` sites of the colour of
    ``n_disorder`` x ``n_systems`` systems, from the shape alone: a thread a
    site of :func:`systems_per` systems of one realization (``threads``: a
    quarter of the card's resident threads), CTAs of :data:`TABLE_THREADS`
    threads, halved down to a warp while the launch would hold fewer CTAs
    than the card's ``sms``.  (tools/probe_sweep.py, NVIDIA H100 80GB HBM3:
    16^4 x 16 0.0139, 0.0100, 0.0087, 0.0089 ms a pass at 1, 2, 4, 8
    systems a thread; 16^3 with 9 offsets x 384 0.0257, 0.0174, 0.0136,
    0.0129 at 1, 2, 4, 8; where a launch cannot fill the card, one.)"""
    per = systems_per(count, n_disorder, n_systems, threads)
    rows = int(n_disorder) * (int(n_systems) // per)
    block = TABLE_THREADS
    while block > 32 and -(-int(count) // block) * rows < sms:
        block //= 2
    return TablePlan(per, block)


def _table_plan(spins, count, d, n_sys):
    props = torch.cuda.get_device_properties(spins.device.index)
    return table_sweep_plan(count, d, n_sys, resident_threads(spins.device.index) // 4,
                            props.multi_processor_count)


def launch_sweep_2d(lib, stream, spins, coup, sys_temps, words, colour, gibbs, parts=None,
                    per=None):
    """One ``sweep_2d`` launch (one colour) on checked CUDA tensors (not
    counted); ``parts``: the measuring launch's ``(e_part, m_part)``;
    ``per``: the systems a thread (default :func:`systems_per`'s)."""
    d, n_sys, h, w = spins.shape
    div_m, div_s = fast_divisor(w // 2)
    per = per or _per(spins, -(-(h * w // 2) // 4), d, n_sys)
    ptrs = (None, None) if parts is None else tuple(t.data_ptr() for t in parts)
    _build.check(lib.peapods_sweep_2d(
        spins.data_ptr(), coup.data_ptr(), sys_temps.data_ptr(), words.data_ptr(), *ptrs,
        d, n_sys, h, w, colour, int(gibbs), per, int(div_m), div_s, stream), "sweep_2d")


def sweep_2d(spins, coup, sys_temps, words, *, gibbs, measure=False, uniforms=None):
    """One sweep of every (realization, system) (see
    :func:`sweep_2d_plain`), the couplings given as the forward bonds ``coup``
    f32 ``[d, H W, 2]``: the plain version (on :func:`pack_coupling_grids`
    of them) for CPU tensors, two launches of the ``sweep_2d`` kernel for
    CUDA tensors, whose partials have one entry per block of the pass
    (:func:`sweep_2d_partials`).  ``uniforms`` (CPU only) are the sweep's
    Philox uniforms drawn ahead by the caller."""
    d, n_sys, h, w = spins.shape
    if _build.device_kind(spins) == "cpu":
        return sweep_2d_plain(spins, pack_coupling_grids(coup, (h, w)), sys_temps, words,
                              gibbs=gibbs, measure=measure, uniforms=uniforms)
    if uniforms is not None:
        raise ValueError("the sweep_2d kernel draws its own uniforms")
    dev = spins.device
    _build.expect(spins, "spins", torch.int8, (d, n_sys, h, w), dev)
    _build.expect(coup, "coup", torch.float32, (d, h * w, 2), dev)
    _build.expect(sys_temps, "sys_temps", torch.float32, (d, n_sys), dev)
    _build.expect(words, "words", torch.int32, (d, 2), dev)
    if d > 65535 or n_sys > 65535:
        raise ValueError("at most 65535 realizations and systems")
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = None
    if measure:
        nb = lib.peapods_colour_pass_blocks(h, w)
        parts = (torch.empty((d, n_sys, nb), dtype=torch.float32, device=dev),
                 torch.empty((d, n_sys, nb), dtype=torch.int32, device=dev))
    for colour in (0, 1):
        launch_sweep_2d(lib, stream, spins, coup, sys_temps, words, colour, gibbs,
                        parts if colour == 1 else None)
        LAUNCHES["sweep_2d"] += 1
    return parts


# ------------------------------------------------- coloured lattices


def nb_local_fields(s, coup_fwd, coup_bwd, lattice):
    """f32 local field of every site (``local_fields``,
    peapods_tpu/ops/sweep.py:53-71): ``s`` f32 ``[..., n_spins]``, forward
    and backward couplings ``[..., n_spins, n_neighbors]`` (broadcast);
    ``h += s_fwd * J_fwd[d]``, then ``h += s_bwd * J_bwd[d]``, for each
    offset ``d`` in order, the lattice's self offsets left out (a flip
    cannot change a self-bond's energy; the reference adds it)."""
    h = torch.zeros_like(s)
    for d, off in enumerate(lattice.offsets):
        if lattice.self_bonds[d]:
            continue
        h = h + neighbour_values(s, lattice.shape, off) * coup_fwd[..., d]
        h = h + neighbour_values(s, lattice.shape, -off) * coup_bwd[..., d]
    return h


def mc_sweep(spins, coup_fwd, coup_bwd, colours, lattice, sys_temps, uniforms, *,
             gibbs):
    """One sweep of every system, each colour of ``colours`` in turn
    (``mc_sweep(uniforms=)``, peapods_tpu/ops/sweep.py:74-123): int8
    ``spins [..., n_spins]``, couplings ``[..., n_spins, n_neighbors]``
    (broadcast), the colour table uint8 ``[n_spins]``, ``sys_temps [...]``
    and uniforms ``[n_colors, ..., n_spins]``; returns the new spins."""
    for c in range(lattice.n_colors):
        s = spins.to(torch.float32)
        eng_change = -s * nb_local_fields(s, coup_fwd, coup_bwd, lattice)
        u = uniforms[c]
        if gibbs:
            half_t = (sys_temps * 0.5)[..., None]
            flip = eng_change >= half_t * torch.log(u / (1.0 - u))
        else:
            inv_half_t = (1.0 / (sys_temps * 0.5))[..., None]
            flip = u < _KEEP * torch.exp(torch.clamp(eng_change * inv_half_t, max=0.0))
        spins = torch.where(flip & (colours == c), -spins, spins)
    return spins


def sweep_nb_plain(spins, coup_fwd, coup_bwd, colours, sys_temps, words, lattice,
                   *, gibbs, uniforms=None):
    """One sweep (each colour in turn) of every (realization, system), in
    place.

    Args:
        spins: int8 ``[d, S, n_spins]`` by system.
        coup_fwd, coup_bwd: f32 ``[d, n_spins, n_neighbors]`` forward
            couplings and ``J[i - off_d, d]``.
        colours: uint8 ``[n_spins]`` the lattice's colouring.
        sys_temps: f32 ``[d, S]``.
        words: int32 ``[d, 2]`` the sweep's key words (unused when
            ``uniforms`` is given): Philox, counter ``(system, colour,
            site // 4, 0)`` (:func:`~.rng.site_uniforms`).
        uniforms: optional f32 ``[d, n_colors, S, n_spins]``.
    """
    n_sys, n = spins.shape[1:]
    u = (uniforms.transpose(0, 1) if uniforms is not None else torch.stack(
        [rng.site_uniforms(words, n_sys, c, n) for c in range(lattice.n_colors)]))
    spins.copy_(mc_sweep(spins, coup_fwd[:, None], coup_bwd[:, None], colours, lattice,
                         sys_temps, u, gibbs=gibbs))


def launch_sweep_nb(lib, stream, spins, coup_fwd, colours, sys_temps, words, lattice,
                    colour, gibbs, per=None, tables=None):
    """One ``sweep_nb`` launch (one colour) on checked CUDA tensors (not
    counted); ``per``: the systems a thread (default :func:`systems_per`'s).
    A table lattice (:attr:`~.lattice.Lattice.table`) takes the table form,
    ``sweep_nb_table``, a thread a site of the colour's list
    (:meth:`~.lattice.Lattice.device_colour_sites`), as
    :func:`table_sweep_plan` says, on its checked device ``tables``."""
    d, n_sys, n = spins.shape
    if lattice.table:
        fwd, bwd = tables
        starts = lattice.colour_sites[1]
        start, count = int(starts[colour]), int(starts[colour + 1] - starts[colour])
        plan = _table_plan(spins, count, d, n_sys)
        _build.check(lib.peapods_sweep_nb_table(
            spins.data_ptr(), coup_fwd.data_ptr(),
            lattice.device_colour_sites(spins.device).data_ptr(), sys_temps.data_ptr(),
            words.data_ptr(), fwd.data_ptr(), bwd.data_ptr(), n, lattice.n_neighbors,
            lattice.self_mask, d, n_sys, colour, start, count, int(gibbs), per or plan.per,
            plan.threads, stream), "sweep_nb_table")
        return
    per = per or _per(spins, -(-n // 4), d, n_sys)
    _build.check(lib.peapods_sweep_nb(
        spins.data_ptr(), coup_fwd.data_ptr(), colours.data_ptr(), sys_temps.data_ptr(),
        words.data_ptr(), lattice.sweep_words.ctypes.data, d, n_sys, colour, int(gibbs),
        per, stream), "sweep_nb")


def sweep_nb(spins, coup_fwd, coup_bwd, colours, sys_temps, words, lattice, *,
             gibbs, uniforms=None, tables=None):
    """One sweep of every (realization, system) on a coloured lattice (see
    :func:`sweep_nb_plain`): the plain version for CPU tensors, one launch
    of the ``sweep_nb`` kernel per colour for CUDA tensors (``sweep_nb_table``
    on a table lattice, reading the neighbours from its device ``tables``,
    :func:`~.lattice.check_tables`), which reads the backward couplings
    from ``coup_fwd`` at the neighbour (``coup_bwd`` is the plain
    version's).  ``uniforms`` (CPU only) are the sweep's Philox uniforms
    drawn ahead by the caller."""
    if _build.device_kind(spins) == "cpu":
        sweep_nb_plain(spins, coup_fwd, coup_bwd, colours, sys_temps, words,
                       lattice, gibbs=gibbs, uniforms=uniforms)
        return
    if uniforms is not None:
        raise ValueError("the sweep_nb kernel draws its own uniforms")
    dev = spins.device
    d, n_sys, n = spins.shape
    nb = lattice.n_neighbors
    _build.expect(spins, "spins", torch.int8, (d, n_sys, lattice.n_spins), dev)
    _build.expect(coup_fwd, "coup_fwd", torch.float32, (d, n, nb), dev)
    _build.expect(colours, "colours", torch.uint8, (n,), dev)
    _build.expect(sys_temps, "sys_temps", torch.float32, (d, n_sys), dev)
    _build.expect(words, "words", torch.int32, (d, 2), dev)
    if d > 65535 or n_sys > 65535:
        raise ValueError("at most 65535 realizations and systems")
    if lattice.table:
        check_tables(tables, lattice, dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = "sweep_nb_table" if lattice.table else "sweep_nb"
    for colour in range(lattice.n_colors):
        launch_sweep_nb(lib, stream, spins, coup_fwd, colours, sys_temps, words, lattice,
                        colour, gibbs, tables=tables)
        LAUNCHES[name] += 1
