"""The overlap moves (Houdayer(N), Joerg, CMR; Wolff or SW) and the
energy re-derivation after a move.

Counterpart of ``peapods_tpu/ops/overlap.py`` (the staged per-task moves)
and of ``peapods_tpu/ops/pallas_event.py`` ``overlap_event_batch`` (:463,
kernel ``_event_kernel`` :274) and ``houdn_event_batch`` (:989, kernel
``_houdn_kernel`` :901), which run a whole move per task.  A task groups
``g`` replicas ``tasks[d, t, j] = (r_0, .., r_{g-1})`` at temperature ``t``
of realization ``d`` (:func:`~peapods_tpu_torch.engine.seeds.overlap_tasks`;
``g = 2`` but for Houdayer(N)); its systems are read through ``sid`` (slot
``r T + t``), so the spins stay by system ``[d, n_systems, n_spins]`` and
are flipped in place.  Per task come six scalars and 64 Wolff probes
(:func:`~peapods_tpu_torch.engine.seeds.event_scalars`) and two key words
for the bond uniforms (Philox, counter ``(dir, site // 4, 0, 0)``; CMR's red
bonds ``(n_dirs + dir, ...)``, ``n_dirs`` the lattice's forward offsets:
:func:`~peapods_tpu_torch.ops.rng.bond_uniforms`).  A move runs on any
lattice of the port (:func:`geometry`): its bonds are one a forward offset,
the axes of the square and cubic lattices or the offsets of the triangular,
BCC, FCC lattices and offset tables.

:func:`overlap_event` launches the kernels of ``csrc/overlap.cu`` on CUDA
tensors (counted in :data:`LAUNCHES`), with the FK phase's labelling of
each lattice labelling the bond graphs (``fk_link`` on the square, cubic
and triangular lattices, counted in ``fk.LAUNCHES``; ``cc_link`` on the
others, counted in ``cc.LAUNCHES``), and runs
:func:`overlap_event_plain` on CPU tensors; :func:`energy_partials` re-derives the systems' energies
(by system, as block partials) for the PT step that follows a move.  The
move's rules, in the reference kernel's operation order (J/T = J / T in
f32):

* Houdayer(N): a site is active where the group's ``g`` spins sum to 0
  (for a pair, ``a b < 0``); bonds between neighbours that are both
  active.
* Joerg: ``inter = a a_fwd J/T``; bond iff ``inter > 0``, ``u < 1 -
  exp(-4 inter)`` and both ends active.
* Flips (Houdayer, Joerg): Wolff, the component of the first active probe
  (none: no flip); SW, each non-singleton component with
  ``salted_uniform(label, s0, s1) < 1/2``; in every replica of the group.
* CMR: ``r = exp(-2 |J/T|)``; blue bonds on edges satisfied in both
  replicas with ``u < 1 - r^2``; the blue flip (Wolff: the drawn seed's
  component; SW: the coin on non-singletons) in both replicas; on the
  flipped spins, grey = blue or (satisfied in one replica only and ``u' <
  1 - r``); grey flips of ``a`` iff ``k & 1`` and of ``b`` iff ``k & 2``,
  with ``k`` drawn per task (Wolff, on the seed's grey component) or ``k =
  floor(4 salted_uniform(grey label, s2, s3))`` (SW, on non-singletons).

Labels are each component's minimum site index.  The move's statistics
(cluster sizes, graph observations) are taken on its *stats graph*: the
move's bonds, CMR's blue ones (the reference's ``cmr_blue``).  On request
the move returns that graph's labels and bond masks (:class:`MoveGraphs`);
its observe form (``overlap_cluster_action="observe"``) labels the stats
graph and writes no spin.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build, cc, fk, rng
from .cluster import connected_components, find_seed, nonsingleton_mask
from .cluster import salted_uniform
from .energy import bond_sums, site_energies
from .lattice import MAX_OFFSETS, Lattice, check_tables, fast_divisor, neighbour_values
from .sweep import systems_per

__all__ = [
    "KINDS",
    "LAUNCHES",
    "MoveGraphs",
    "gather_tasks",
    "task_group_size",
    "overlap_event",
    "overlap_event_plain",
    "houdayer_plain",
    "houdn_plain",
    "houdn_states_plain",
    "table_states_plain",
    "finish_plain",
    "jorg_plain",
    "cmr_plain",
    "energy_partials",
    "energy_partials_plain",
    "energy_words",
    "OvTablePlan",
    "ov_table_plan",
    "TABLE_PLANNED",
    "table_ctas",
    "table_most",
    "table_pers",
    "table_waves",
]

KINDS = ("houdayer", "jorg", "cmr")

# kernel launches since the last reset, by kernel name
LAUNCHES = {"ov_bonds": 0, "ov_mid": 0, "ov_finish": 0, "houdn_bonds": 0,
            "houdn_finish": 0, "energy_partials": 0, "ov_bonds_table": 0,
            "ov_mid_table": 0, "ov_finish_table": 0, "houdn_bonds_table": 0,
            "houdn_finish_table": 0}


class MoveGraphs(NamedTuple):
    """What a move returns on request, per task ``[B, ...]``: ``labels``,
    the move's labels (CMR's grey ones; ``None`` for CMR's observe form,
    which builds no grey graph); ``blue``, CMR's blue labels (else
    ``None``); ``masks``, the stats graph's bond masks bool ``[B, n,
    n_dirs]``."""

    labels: torch.Tensor | None
    blue: torch.Tensor | None
    masks: torch.Tensor | None

    @property
    def stats(self):
        """The stats graph's labels: CMR's blue ones, else the move's."""
        return self.labels if self.blue is None else self.blue


# ------------------------------------------------------------ plain torch


def gather_tasks(spins, sid, tasks, n_temps: int):
    """``(sys int64 [d, T, G, g], x_0, .., x_{g-1})``: the ``g`` systems of
    every task and the spins of each member, int8 ``[B, n]``, tasks flat
    ``B = d T G`` in the order ``(d, t, j)``."""
    d = spins.shape[0]
    t = torch.arange(n_temps, device=spins.device)[None, :, None, None]
    slot = tasks.to(torch.int64) * n_temps + t  # [d, T, G, g]
    sys = sid.to(torch.int64).gather(1, slot.reshape(d, -1)).reshape(slot.shape)
    di = torch.arange(d, device=spins.device)[:, None, None]
    n = spins.shape[-1]
    return (sys,) + tuple(spins[di, sys[..., r]].reshape(-1, n)
                          for r in range(tasks.shape[-1]))


def _flip(x, mask):
    return torch.where(mask, -x, x)


def geometry(lattice):
    """``(shape, offsets)`` of a move's lattice: its extents and its int64
    forward offsets ``[n_dirs, n_dims]``.  Every function of this module
    takes the lattice as a :class:`~.lattice.Lattice` (any offsets: the
    triangular, BCC, FCC lattices, offset tables, odd extents; a 1D chain
    as its kernel shape ``[1, L]``, :attr:`~.lattice.Lattice.kernel_shape`)
    or as its extents (one forward bond per axis)."""
    if isinstance(lattice, Lattice):
        return lattice.kernel_shape, lattice.kernel_offsets
    shape = tuple(int(x) for x in lattice)
    return shape, np.eye(len(shape), dtype=np.int64)


def _fwd(x, lat, d):
    """``x [..., n]`` at every site's neighbour at forward offset ``d``."""
    shape, offsets = geometry(lat)
    return neighbour_values(x, shape, offsets[d])


def _n_dirs(lat):
    return len(geometry(lat)[1])


def _components(bonds, lat):
    return connected_components(bonds, *geometry(lat))


def _nonsingleton(bonds, lat):
    return nonsingleton_mask(bonds, *geometry(lat))


def _cluster_flip(labels, bonds, scal, probes, active, lat, *, wolff):
    """Which sites a Houdayer or Joerg move flips: the first active probe's
    component (Wolff) or the non-singletons whose coin falls below 1/2
    (SW)."""
    if wolff:
        seed = find_seed(probes, active)
        n = labels.shape[-1]
        root = labels.gather(-1, seed.clamp(max=n - 1)[:, None])
        return (labels == root) & (seed < n)[:, None]
    return (salted_uniform(labels, scal[:, 0:1], scal[:, 1:2]) < 0.5) \
        & _nonsingleton(bonds, lat)


def _houdn_bonds(x, lat):
    """``(active, bonds)`` of Houdayer(N) tasks ``x`` int8 ``[B, g, n]``:
    the sites whose ``g`` spins sum to 0 and the bonds between two active
    neighbours, bool ``[B, n]`` and ``[B, n, n_dirs]``."""
    active = x.to(torch.int32).sum(1) == 0
    return active, torch.stack([active & _fwd(active, lat, d)
                                for d in range(_n_dirs(lat))], dim=-1)


def _houdn(x, scal, probes, lat, *, wolff):
    active, bonds = _houdn_bonds(x, lat)
    labels = _components(bonds, lat)
    flip = _cluster_flip(labels, bonds, scal, probes, active, lat, wolff=wolff)
    return _flip(x, flip[:, None]), labels, bonds


def houdn_plain(x, scal, probes, shape, *, wolff):
    """Houdayer(N) on tasks of ``g`` replicas ``x`` int8 ``[B, g, n]`` on
    the lattice ``shape`` (:func:`geometry`): returns ``(x, labels)``,
    every member flipped on the chosen clusters."""
    x, labels, _ = _houdn(x, scal, probes, shape, wolff=wolff)
    return x, labels


def houdayer_plain(a, b, scal, probes, shape, *, wolff):
    """Houdayer on tasks ``a``, ``b`` int8 ``[B, n]``: returns ``(a, b,
    labels)``."""
    x, labels = houdn_plain(torch.stack([a, b], 1), scal, probes, shape, wolff=wolff)
    return x[:, 0], x[:, 1], labels


def _jorg(a, b, jt, scal, probes, lat, *, wolff, u):
    active = a.to(torch.int32) * b.to(torch.int32) < 0
    af = a.to(torch.float32)
    bonds = []
    for d in range(_n_dirs(lat)):
        inter = af * _fwd(af, lat, d) * jt[..., d]
        p = 1.0 - torch.exp(-4.0 * inter)
        bonds.append((inter > 0.0) & (u[..., d] < p) & active
                     & _fwd(active, lat, d))
    bonds = torch.stack(bonds, dim=-1)
    labels = _components(bonds, lat)
    flip = _cluster_flip(labels, bonds, scal, probes, active, lat, wolff=wolff)
    return _flip(a, flip), _flip(b, flip), labels, bonds


def jorg_plain(a, b, jt, scal, probes, shape, *, wolff, u):
    """Joerg on tasks ``a``, ``b`` int8 ``[B, n]`` on the lattice ``shape``
    (:func:`geometry`) with ``jt`` = J/T f32 ``[B, n, n_dirs]`` and bond
    uniforms ``u`` ``[B, n, n_dirs]``."""
    return _jorg(a, b, jt, scal, probes, shape, wolff=wolff, u=u)[:3]


def _sats(af, bf, jt, lat, d):
    return (af * _fwd(af, lat, d) * jt[..., d] > 0.0,
            bf * _fwd(bf, lat, d) * jt[..., d] > 0.0)


def _cmr(a, b, jt, scal, lat, *, wolff, u_blue, u_red):
    n_dirs = _n_dirs(lat)
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    r = torch.exp(-2.0 * jt.abs())
    blue = []
    for d in range(n_dirs):
        sa, sb = _sats(af, bf, jt, lat, d)
        blue.append(sa & sb & (u_blue[..., d] < 1.0 - r[..., d] * r[..., d]))
    blue = torch.stack(blue, dim=-1)
    blue_labels = _components(blue, lat)
    seed = scal[:, 4:5].to(torch.int64)
    if wolff:
        blue_flip = blue_labels == blue_labels.gather(-1, seed)
    else:
        blue_flip = (salted_uniform(blue_labels, scal[:, 0:1], scal[:, 1:2]) < 0.5) \
            & _nonsingleton(blue, lat)
    af, bf = _flip(af, blue_flip), _flip(bf, blue_flip)
    grey = []
    for d in range(n_dirs):
        sa, sb = _sats(af, bf, jt, lat, d)
        grey.append(blue[..., d] | ((sa != sb) & (u_red[..., d] < 1.0 - r[..., d])))
    grey = torch.stack(grey, dim=-1)
    labels = _components(grey, lat)
    if wolff:
        inside = labels == labels.gather(-1, seed)
        k = scal[:, 5:6]
    else:
        inside = _nonsingleton(grey, lat)
        k = (salted_uniform(labels, scal[:, 2:3], scal[:, 3:4]) * 4.0).to(torch.int32)
    a_new = _flip(af, inside & ((k & 1) != 0)).to(torch.int8)
    b_new = _flip(bf, inside & ((k & 2) != 0)).to(torch.int8)
    return a_new, b_new, labels, blue_labels, blue, grey, blue_flip


def cmr_plain(a, b, jt, scal, shape, *, wolff, u_blue, u_red):
    """CMR on tasks ``a``, ``b`` int8 ``[B, n]`` on the lattice ``shape``
    (:func:`geometry`): returns ``(a, b, grey labels, blue labels)``.
    ``u_blue`` / ``u_red``: f32 ``[B, n, n_dirs]``."""
    return _cmr(a, b, jt, scal, shape, wolff=wolff, u_blue=u_blue,
                u_red=u_red)[:4]


def _state_bytes(bonds, dtype=torch.uint8):
    """``[B, n]`` of ``dtype``, uint8 bytes or the table form's int32 words
    (bit 31 the sign): bit ``d`` where bond ``d`` of bool ``[B, n, n_dirs]``
    is active."""
    w = torch.tensor([1 << d for d in range(bonds.shape[-1])], dtype=torch.int64,
                     device=bonds.device)
    words = (bonds.to(torch.int64) * w).sum(-1)
    if dtype == torch.uint8:
        return words.to(torch.uint8)
    return ((words + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _pair_graphs(spins, sid, tasks, coup, temps, scal, probes, words, *, kind, wolff,
                 shape):
    """Joerg's or CMR's first graphs: ``(bonds, grey, flip, seeds)``, the
    first graph's bool ``[B, n, n_dirs]`` bonds (CMR: blue), CMR's grey bonds
    and blue flips bool ``[B, n]`` (``None`` for Joerg) and the seeds int32
    ``[B]`` (Joerg Wolff: the first active probe, ``n`` when none is, and
    for SW; CMR: the drawn seed)."""
    n_temps, n_groups = tasks.shape[1:3]
    n_dirs = _n_dirs(shape)
    n = spins.shape[-1]
    _, a, b = gather_tasks(spins, sid, tasks, n_temps)
    jt = task_jt(coup, temps, n_groups)
    u = rng.bond_uniforms(words, n, n_dirs)
    if kind == "jorg":
        bonds = _jorg(a, b, jt, scal, probes, shape, wolff=wolff, u=u)[3]
        active = a.to(torch.int32) * b.to(torch.int32) < 0
        seeds = (find_seed(probes, active) if wolff
                 else torch.full((a.shape[0],), n, device=a.device)).to(torch.int32)
        return bonds, None, None, seeds
    if kind != "cmr":
        raise ValueError(f"{kind!r} moves have no ov_bonds")
    *_, blue, grey, flip = _cmr(a, b, jt, scal, shape, wolff=wolff, u_blue=u,
                                u_red=rng.bond_uniforms(words, n, n_dirs, n_dirs))
    return blue, grey, flip, scal[:, 4].to(torch.int32).contiguous()


def bond_states_plain(spins, sid, tasks, coup, temps, scal, probes, words, *, kind,
                      wolff, shape):
    """Plain version of ``ov_bonds`` and ``ov_mid`` (Joerg and CMR): ``(state,
    state2, seeds)``, the first kernel's state bytes uint8 ``[B, n]`` (bit
    ``d``: bond ``d``; CMR's blue bonds), CMR's second uint8 ``[B, n]`` (bit
    ``d``: grey bond ``d``; bit 7: the blue flip; ``None`` for Joerg) and
    the seeds int32 ``[B]`` (Joerg Wolff: the first active probe, ``n`` when
    none is, and for SW; CMR: the drawn seed)."""
    bonds, grey, flip, seeds = _pair_graphs(spins, sid, tasks, coup, temps, scal, probes,
                                            words, kind=kind, wolff=wolff, shape=shape)
    if grey is None:
        return _state_bytes(bonds), None, seeds
    state2 = _state_bytes(grey) | (flip.to(torch.uint8) << 7)
    return _state_bytes(bonds), state2, seeds


def houdn_states_plain(spins, sid, tasks, probes, *, wolff, shape):
    """Plain version of ``houdn_bonds``: ``(state, seeds)``, the state bytes
    uint8 ``[B, n]`` (bit ``d``: bond ``d`` between two balanced sites,
    whose group's ``g`` spins sum to 0; the table form's int32 words on a
    table lattice) and the seeds int32 ``[B]`` (Wolff: the first balanced
    probe, ``n`` when none is, and for SW)."""
    _, *slots = gather_tasks(spins, sid, tasks, tasks.shape[1])
    active, bonds = _houdn_bonds(torch.stack(slots, 1), shape)
    n = spins.shape[-1]
    seeds = (find_seed(probes, active) if wolff
             else torch.full((active.shape[0],), n, device=spins.device))
    table = isinstance(shape, Lattice) and shape.table
    return _state_bytes(bonds, torch.int32 if table else torch.uint8), seeds.to(torch.int32)


def table_states_plain(spins, sid, tasks, coup, temps, scal, probes, words, *, kind,
                       wolff, lattice):
    """Plain version of the table form's first kernels (``houdn_bonds_table``,
    ``ov_bonds_table``, ``ov_mid_table``) on a table lattice: ``(state,
    state2, flip, seeds)``, the first graph's int32 words ``[B, n]`` (bit
    ``d``: the bond to ``fwd[i, d]``; CMR's blue bonds), CMR's grey words
    and blue flips uint8 ``[B, n]`` (``None`` but for CMR) and the seeds
    int32 ``[B]``."""
    if kind == "houdayer":
        state, seeds = houdn_states_plain(spins, sid, tasks, probes, wolff=wolff,
                                          shape=lattice)
        return state, None, None, seeds
    bonds, grey, flip, seeds = _pair_graphs(spins, sid, tasks, coup, temps, scal, probes,
                                            words, kind=kind, wolff=wolff, shape=lattice)
    grey = None if grey is None else _state_bytes(grey, torch.int32)
    return (_state_bytes(bonds, torch.int32), grey,
            None if flip is None else flip.to(torch.uint8), seeds)


def finish_plain(spins, sid, tasks, scal, seeds, state, parent, *, kind, wolff, shape,
                 flip=None):
    """Plain version of ``ov_finish`` and ``houdn_finish``: every task's
    flips, in place in ``spins``, from the kernels' own inputs.  ``state``
    uint8 ``[B, n]`` and ``parent`` int32 ``[B, n]`` (flat: each site's root)
    are the move's last graph: Houdayer's or Joerg's bonds, or CMR's state2
    bytes (bit 7: the blue flip) and grey parents; ``seeds`` int32 ``[B]``
    the first kernel's (``n``: no Wolff flip).  Wolff flips the seed's
    component, SW each non-singleton whose ``salted_uniform(root, s0, s1)
    < 1/2`` (Houdayer, Joerg: in every member) or whose ``k =
    floor(4 salted_uniform(root, s2, s3))`` is not 0 (CMR, after the blue
    flip: ``a`` where ``k & 1``, ``b`` where ``k & 2``; Wolff: the task's
    ``k``).  The table form's CMR keeps the blue flip apart, in ``flip``
    (uint8 ``[B, n]``; ``state`` then its int32 grey words).  Returns the
    labels (the parents)."""
    n_temps = tasks.shape[1]
    n = spins.shape[-1]
    sys, *slots = gather_tasks(spins, sid, tasks, n_temps)
    lab = parent.to(torch.int64)
    if wolff:
        sd = seeds.to(torch.int64)
        inside = (lab == lab.gather(-1, sd.clamp(max=n - 1)[:, None])) & (sd < n)[:, None]
    else:
        inside = _nonsingleton(fk.state_masks(state, _n_dirs(shape)), shape)
    if kind == "cmr":
        k = (scal[:, 5:6] if wolff
             else (salted_uniform(lab, scal[:, 2:3], scal[:, 3:4]) * 4.0).to(torch.int32))
        blue = ((state >> 7) if flip is None else flip).to(torch.bool)
        flips = [blue ^ (inside & ((k & 1) != 0)), blue ^ (inside & ((k & 2) != 0))]
    else:
        if not wolff:
            inside = inside & (salted_uniform(lab, scal[:, 0:1], scal[:, 1:2]) < 0.5)
        flips = [inside] * len(slots)
    di = torch.arange(spins.shape[0], device=spins.device)[:, None, None]
    for r, x in enumerate(slots):
        spins[di, sys[..., r]] = _flip(x, flips[r]).reshape(sys.shape[:3] + (n,))
    return parent


def task_jt(coup, temps, n_groups: int):
    """f32 ``[d T G, n, n_dirs]``: J / T of every task's bonds."""
    d, n, nd = coup.shape
    jt = coup[:, None] / temps[None, :, None, None]  # [d, T, n, nd]
    t = temps.shape[0]
    return jt[:, :, None].expand(d, t, n_groups, n, nd).reshape(-1, n, nd)


def task_group_size(kind, tasks):
    """The replicas of a task of ``tasks [..., g]``: 2 for every kind, any
    even ``g`` for Houdayer(N); raises otherwise."""
    g = tasks.shape[-1]
    if kind not in KINDS:
        raise ValueError(f"unknown overlap move kind {kind!r}")
    if g < 2 or g % 2 or (g > 2 and kind != "houdayer"):
        raise ValueError(f"a {kind} task cannot group {g} replicas")
    return g


def overlap_event_plain(spins, sid, tasks, coup, temps, scal, probes, words,
                        *, kind, wolff, shape, with_labels=False, with_masks=False,
                        observe=False):
    """One overlap move of every task, in place (see the module doc).

    Args:
        spins: int8 ``[d, n_systems, n]`` by system, updated in place
            unless ``observe``.
        sid: int32 ``[d, n_slots]``.
        tasks: int32 ``[d, T, G, g]`` replica groups (``g = 2`` but for
            Houdayer(N)).
        coup: f32 ``[d, n, n_dirs]`` forward couplings.
        temps: f32 ``[T]``.
        scal, probes, words: int32 ``[d T G, 6]``, ``[d T G, 64]``,
            ``[d T G, 2]``.
        observe: build the graphs and leave the spins alone.

    Returns:
        :class:`MoveGraphs` (the labels when ``with_labels``, the stats
        graph's masks when ``with_masks``), or ``None`` when neither is
        asked for.
    """
    n_temps, n_groups = tasks.shape[1:3]
    g = task_group_size(kind, tasks)
    n_dirs = _n_dirs(shape)
    n = spins.shape[-1]
    sys, *slots = gather_tasks(spins, sid, tasks, n_temps)
    blue = None
    if kind == "houdayer":
        x, labels, bonds = _houdn(torch.stack(slots, 1), scal, probes, shape,
                                  wolff=wolff)
        slots = x.unbind(1)
    else:
        jt = task_jt(coup, temps, n_groups)
        u = rng.bond_uniforms(words, n, n_dirs)
        if kind == "jorg":
            *slots, labels, bonds = _jorg(*slots, jt, scal, probes, shape,
                                          wolff=wolff, u=u)
        else:
            *slots, labels, blue, bonds, _, _ = _cmr(
                *slots, jt, scal, shape, wolff=wolff, u_blue=u,
                u_red=rng.bond_uniforms(words, n, n_dirs, n_dirs))
            if observe:
                labels = None  # the observe form labels the blue graph only
    if not observe:
        d = spins.shape[0]
        di = torch.arange(d, device=spins.device)[:, None, None]
        for r in range(g):
            spins[di, sys[..., r]] = slots[r].reshape(sys.shape[:3] + (n,))
    if not (with_labels or with_masks):
        return None
    return MoveGraphs(labels if with_labels else None, blue if with_labels else None,
                      bonds if with_masks else None)


def energy_partials_plain(spins, coup, shape, blocks=False):
    """``(e_part f32 [d, S, 1], m_part int32 [d, S, 1])``: each system's
    forward-bond energy sum and magnetization, by system; with ``blocks``
    the kernel's partials ``[d, S, site_blocks]``, one a block of 256 sites,
    added as the kernel adds them (:func:`~.energy.site_energies`, then
    :func:`~.fk.block_partials_plain` with a site a thread)."""
    if blocks:
        e = site_energies(spins, coup[:, None], shape)
        return fk.block_partials_plain(e), fk.block_partials_plain(spins.to(torch.int32))
    e = bond_sums(spins, coup[:, None], shape)
    m = spins.to(torch.int32).sum(-1, dtype=torch.int32)
    return e[..., None], m[..., None]


# ------------------------------------------------------------ CUDA kernels


class Scratch:
    """Device buffers of a move's kernels for ``n_tasks`` tasks of ``n``
    sites (allocated once per chunk).  The table form (``table``) keeps
    its bonds as an int32 word a site and CMR's blue flip as a byte a site
    of its own (``flip``), the sixth of its :meth:`ptrs`."""

    def __init__(self, n_tasks, n, device, cmr, table=False):
        u8 = dict(dtype=torch.uint8, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        st = i32 if table else u8
        self.table = table
        self.state = torch.empty((n_tasks, n), **st)
        self.parent = torch.empty((n_tasks, n), **i32)
        self.seeds = torch.empty((n_tasks,), **i32)
        self.state2 = torch.empty((n_tasks, n), **st) if cmr else None
        self.parent2 = torch.empty((n_tasks, n), **i32) if cmr else None
        self.flip = torch.empty((n_tasks, n), **u8) if cmr and table else None

    def ptrs(self):
        bufs = (self.state, self.parent, self.seeds, self.state2, self.parent2)
        if self.table:
            bufs += (self.flip,)
        return [None if t is None else t.data_ptr() for t in bufs]


# the overlap moves' kernels (csrc/overlap.cu ov_bonds, ov_mid, ov_finish,
# houdn_bonds, houdn_finish): a thread takes a group of four sites of `per` consecutive
# tasks of one realization, reading the group's couplings once and taking
# J / T once a temperature for them
OV_MAX_PER = 8
# houdn_bonds and houdn_finish stage a CTA's per g member slots (2 bytes
# each) in shared memory: the rule keeps them within the 48 KB a launch takes without
# opting in (one task of g > HOUDN_ROWS members opts in to more)
HOUDN_ROWS = 24576


@functools.lru_cache(maxsize=None)
def ov_per(n_sites: int, n_disorder: int, n_temps: int, n_pairs: int, threads: int,
           most: int = OV_MAX_PER) -> int:
    """The tasks a thread of the overlap moves' kernels takes in turn: the
    largest divisor of a realization's ``n_temps * n_pairs`` tasks up to
    ``most`` (:data:`OV_MAX_PER`; ``houdn_*``: ``HOUDN_ROWS // g``) that
    is a multiple or a divisor of ``n_pairs`` (so a thread's tasks of one
    temperature sit side by side) and whose launch still has ``threads``
    threads (its callers: a quarter of the card's resident threads,
    :func:`~.fk.resident_threads`; tools/probe_overlap.py, NVIDIA H100 80GB
    HBM3, config 5: 0.0149 ms an ``ov_bonds`` launch with 2 tasks a thread,
    0.0144 with 4, 0.0147 with 6); 1 where none has."""
    groups = -(-int(n_sites) // 4) * int(n_disorder)
    tg = int(n_temps) * int(n_pairs)
    fits = [p for p in range(1, min(tg, OV_MAX_PER, most) + 1)
            if tg % p == 0 and (p % n_pairs == 0 or n_pairs % p == 0)
            and groups * (tg // p) >= threads]
    return max(fits, default=1)


@functools.lru_cache(maxsize=None)
def ov_words(shape, n_disorder: int, n_temps: int, n_pairs: int, n_slots: int, per: int,
             offsets=None):
    """int32 host words of the overlap moves' kernels (``csrc/overlap.cu``
    ``OvWalk``): ``n, nd, lf, lb, la, T, G, S, per, d``, then
    :func:`~.lattice.fast_divisor` ``(m, s)`` of ``lf``, ``lb`` and ``G``,
    then the bond directions ``nb``, whether they are the axes (the
    kernels' own form for them), and :data:`~.lattice.MAX_OFFSETS` zero-
    padded steps ``ra, rb, rf, q, b`` of the forward ``offsets`` (a tuple
    of tuples; one per axis when ``None``).  The fast axis (the last,
    extent ``lf``) runs in lines over an inner slow axis of extent ``lb``
    (2D: ``L0``; 3D: ``L1``) and in 3D an outer one of extent ``la = L0`` (1
    in 2D): an offset's steps are its components along them, each taken
    into ``[0, extent)`` (``ra = 0`` in 2D), and ``rf`` as ``q`` 4-byte
    words and ``b`` bytes.  ``G`` groups (pairs but for Houdayer(N)) and
    ``T`` temperatures a realization, ``S`` slots, ``per`` tasks a thread
    (:func:`ov_per`)."""
    shape = tuple(int(x) for x in shape)
    nd = len(shape)
    lf, lb, la = shape[-1], shape[-2], shape[0] if nd == 3 else 1
    head = [math.prod(shape), nd, lf, lb, la, n_temps, n_pairs, n_slots, per, n_disorder]
    div = [v for x in (lf, lb, n_pairs) for v in fast_divisor(x)]
    eye = np.eye(nd, dtype=np.int64)
    off = eye if offsets is None else np.asarray(offsets, np.int64).reshape(-1, nd)
    axes = off.shape == eye.shape and bool((off == eye).all())
    steps = np.zeros((MAX_OFFSETS, 5), np.int64)
    for d, o in enumerate(off):
        ra = int(o[0]) % la if nd == 3 else 0
        rb, rf = int(o[-2]) % lb, int(o[-1]) % lf
        steps[d] = ra, rb, rf, rf // 4, rf % 4
    tail = [len(off), int(axes)] + steps.reshape(-1).tolist()
    return np.asarray(head + div + tail, np.int64).astype(np.uint32).view(np.int32)


def link_graphs(lib, stream, p_state, p_labels, n_graphs, shape, lattice=None,
                tables=None):
    """Label ``n_graphs`` bond graphs of a move (state bytes in, every
    label its component's minimum site index out) with the FK phase's
    labelling of the lattice: ``fk_link`` (``fk.launch_link``) on the
    square, cubic (``lattice`` ``None``: the axes of ``shape``) and
    triangular lattices with even extents, ``cc_link`` (``cc.launch``) on
    the others; on a table lattice (int32 state words) the staged FK
    path's table labelling (``cc_table_link``, ``cc.table_link_launches``)
    on the device ``tables``."""
    if lattice is not None and lattice.table:
        cc.launch(lib, stream, p_state, p_labels, lattice, n_graphs, tables)
    elif lattice is None or lattice.axes_form or lattice.triangular:
        fk.launch_link(lib, stream, p_state, p_labels, n_graphs, *_build.dims3(shape),
                       tri=lattice is not None and lattice.triangular)
    else:
        cc.launch(lib, stream, p_state, p_labels, lattice, n_graphs)


def launch_event(lib, stream, dims, p_spins, p_sid, p_tasks, p_coup, p_temps,
                 p_scal, p_probes, p_words, scratch, *, kind, wolff, group=2,
                 p_labels=None, p_blue=None, observe=False, per=0, lattice=None,
                 tables=None):
    """Launch one move's kernels on raw pointers: ``dims`` is ``(n_tasks,
    L0, L1, L2, T, G, S)``; ``scratch`` the :meth:`Scratch.ptrs`; ``group``
    the replicas of a task; ``per`` the tasks a thread of the ``houdn_*``
    and ``ov_*`` kernels takes (default :func:`ov_per`'s); ``lattice`` the
    :class:`~.lattice.Lattice` whose offsets are the bonds (``None``: the
    axes of ``dims``).  Houdayer, on groups of any even size, takes
    ``houdn_bonds``, the labelling (:func:`link_graphs`: ``fk_link``, or
    ``cc_link`` off the square, cubic and triangular lattices) and
    ``houdn_finish``; Joerg ``ov_bonds``, the labelling, ``ov_finish``; CMR
    ``ov_bonds``, the labelling (blue), ``ov_mid``, the labelling (grey),
    ``ov_finish``.  The labellings write straight into the caller's
    buffers, which the next kernel reads as its flat parents: Houdayer's
    and Joerg's graphs and CMR's grey one into ``p_labels``, CMR's blue one
    into ``p_blue`` (the scratch parents where a buffer is ``None``).  The
    observe form launches no finish (and no ``ov_mid``): the labelling
    labels the stats graph into ``p_labels`` (CMR: ``p_blue``, required
    then) and no spin is written.  On a table lattice (``tables``: its
    device ``(fwd, bwd)``; ``scratch`` a table :class:`Scratch`'s six
    pointers) :func:`launch_event_table` takes the move."""
    if tables is not None:
        launch_event_table(lib, stream, dims, p_spins, p_sid, p_tasks, p_coup, p_temps,
                           p_scal, p_probes, p_words, scratch, kind=kind, wolff=wolff,
                           group=group, p_labels=p_labels, p_blue=p_blue,
                           observe=observe, lattice=lattice, tables=tables, per=per)
        return
    n_tasks, l0, l1, l2, n_temps, n_groups, n_slots = dims
    st, par, seeds, st2, par2 = scratch
    stats = _stats_buffer(kind, observe, p_labels, p_blue)
    shape = (l0, l1) if l2 == 1 else (l0, l1, l2)
    n = l0 * l1 * l2
    d = n_tasks // (n_temps * n_groups)
    threads = fk.resident_threads(torch.cuda.current_device()) // 4
    houd = kind == "houdayer"
    _check_observe(kind, observe, group)
    per = per or ov_per(n, d, n_temps, n_groups, threads,
                        max(1, HOUDN_ROWS // group) if houd else OV_MAX_PER)
    table = () if lattice is None or lattice.axes_form else (
        tuple(map(tuple, lattice.kernel_offsets.tolist())),)
    words = ov_words(shape, d, n_temps, n_groups, n_slots, per, *table)
    k = KINDS.index(kind)
    if houd:
        _build.check(lib.peapods_houdn_bonds(
            p_spins, p_sid, p_tasks, p_probes, st, seeds, words.ctypes.data, group,
            int(wolff), stream), "houdn_bonds")
        LAUNCHES["houdn_bonds"] += 1
    else:
        _build.check(lib.peapods_ov_bonds(
            p_spins, p_sid, p_tasks, p_coup, p_temps, p_scal, p_probes, p_words,
            st, seeds, words.ctypes.data, k, int(wolff), stream), "ov_bonds")
        LAUNCHES["ov_bonds"] += 1
    # the first graph's flat parents: the stats graph's labels where the
    # caller asks for them
    first = par if stats is None else stats
    link_graphs(lib, stream, st, first, n_tasks, shape, lattice)
    if observe:
        return
    if houd:
        _build.check(lib.peapods_houdn_finish(
            p_spins, p_sid, p_tasks, p_scal, st, first, seeds, words.ctypes.data, group,
            int(wolff), stream), "houdn_finish")
        LAUNCHES["houdn_finish"] += 1
        return
    last_st, last = st, first
    if kind == "cmr":
        _build.check(lib.peapods_ov_mid(
            p_spins, p_sid, p_tasks, p_coup, p_temps, p_scal, p_words, st, first,
            st2, words.ctypes.data, int(wolff), stream), "ov_mid")
        LAUNCHES["ov_mid"] += 1
        last_st, last = st2, par2 if p_labels is None else p_labels
        link_graphs(lib, stream, st2, last, n_tasks, shape, lattice)
    _build.check(lib.peapods_ov_finish(
        p_spins, p_sid, p_tasks, p_scal, seeds, last_st, last, words.ctypes.data, k,
        int(wolff), stream), "ov_finish")
    LAUNCHES["ov_finish"] += 1


def _stats_buffer(kind, observe, p_labels, p_blue):
    """The buffer that a move's stats graph is labelled into (CMR's blue
    labels, else the labels), required by the observe form."""
    stats = p_blue if kind == "cmr" else p_labels
    if observe and stats is None:
        raise ValueError(f"the observe form of a {kind} move needs "
                         f"{'p_blue' if kind == 'cmr' else 'p_labels'}")
    return stats


def _check_observe(kind, observe, group):
    if kind == "houdayer" and observe and group > 2:
        raise ValueError("Houdayer(N > 2) moves have no observe form")


def ov_table_words(n: int, n_neighbors: int, n_disorder: int, n_temps: int,
                   n_groups: int, n_slots: int):
    """int32 host words of the table form's launches (``csrc/overlap.cu``
    ``OvTable``): ``n, nb, T, G, S, d``.  Its neighbours are the table's
    rows, so it takes no residue steps; a thread of the finishes takes a
    group of four sites of one task (the grid's y), of :data:`TABLE_PLANNED`
    a group of four sites of :func:`ov_table_plan`'s ``per`` tasks."""
    return np.asarray([n, n_neighbors, n_temps, n_groups, n_slots, n_disorder], np.int32)


# the table kernels that take ov_table_plan's launch, by their index in
# csrc/overlap.cu ov_table_instance
TABLE_PLANNED = ("ov_bonds_table", "ov_mid_table", "houdn_bonds_table")
# houdn_bonds_table stages a CTA's per g member rows (8 bytes each) in shared
# memory: its plan keeps them within the 48 KB a launch takes without
# opting in (one task of g > TABLE_ROWS members opts in to more)
TABLE_ROWS = 6144


class OvTablePlan(NamedTuple):
    """A planned table kernel's launch (:data:`TABLE_PLANNED`): the tasks a
    thread (``per``) and the grid ``(tasks / per, group blocks,
    n_disorder)``, its blocks of 256 groups of four sites striding past
    65535."""

    per: int
    grid: tuple


def table_waves(ctas: int, slots: int, per: int) -> int:
    """The cost :func:`ov_table_plan` weighs: a launch's waves (``ctas`` over
    the card's ``slots``, its SMs times the CTAs an SM holds) times a
    thread's work, its ``per`` tasks and one more for the rows and
    couplings it reads once."""
    return -(-int(ctas) // max(1, int(slots))) * (int(per) + 1)


def table_most(kernel: str, group: int = 2) -> int:
    """The most tasks a thread of ``kernel`` takes: :data:`OV_MAX_PER`, and
    for ``houdn_bonds_table`` as many as keep its staged member rows within
    :data:`TABLE_ROWS` (at least 1)."""
    if kernel == "houdn_bonds_table":
        return max(1, min(OV_MAX_PER, TABLE_ROWS // int(group)))
    return OV_MAX_PER


@functools.lru_cache(maxsize=None)
def ov_table_plan(n: int, n_disorder: int, n_temps: int, n_groups: int, sms: int,
                  ctas: int, most: int = OV_MAX_PER) -> OvTablePlan:
    """A planned table kernel's launch (:data:`TABLE_PLANNED`) from the shape
    and the card: a thread a group of four sites of ``per`` consecutive
    tasks of one realization, reading the group's table rows (and
    couplings) once for them: a divisor of a realization's tasks up to
    ``most`` (:func:`table_most`), a multiple or a divisor of its groups (a
    thread's tasks of one temperature side by side, as :func:`ov_per`'s),
    of the least :func:`table_waves` (``sms`` times ``ctas``, the CTAs an
    SM holds of the kernel, :func:`table_ctas`), the largest of a tie."""
    tg = int(n_temps) * int(n_groups)
    blocks = min(-(-(-(-int(n) // 4)) // 256), 65535)
    fits = [p for p in range(1, min(tg, OV_MAX_PER, int(most)) + 1)
            if tg % p == 0 and (p % n_groups == 0 or n_groups % p == 0)]
    per = min(fits, key=lambda p: (table_waves(blocks * n_disorder * (tg // p), sms * ctas, p),
                                   -p))
    return OvTablePlan(per, (tg // per, blocks, int(n_disorder)))


@functools.lru_cache(maxsize=None)
def table_ctas(index: int, kernel: str, n_neighbors: int, variant: int = 0,
               smem: int = 0) -> int:
    """The CTAs an SM of card ``index`` holds at once of ``kernel``'s
    (:data:`TABLE_PLANNED`) instance of ``n_neighbors`` offsets and
    ``variant`` (``ov_bonds_table``: the move kind's index in
    :data:`KINDS`; ``ov_mid_table``: 1 for Wolff; ``houdn_bonds_table``: 1
    past g = 254 members), with ``smem`` bytes of dynamic shared memory
    (``houdn_bonds_table``'s member rows)."""
    with torch.cuda.device(index):
        return _build.library().peapods_ov_table_ctas(TABLE_PLANNED.index(kernel),
                                                      n_neighbors, variant, smem)


def table_pers(n: int, n_neighbors: int, n_disorder: int, n_temps: int, n_groups: int,
               kind: str, wolff: bool, group: int = 2, index: int = None) -> dict:
    """Each planned kernel of a move's table form (``ov_bonds_table`` and,
    for CMR, ``ov_mid_table``; Houdayer ``houdn_bonds_table``) with its
    :func:`ov_table_plan` ``per`` on card ``index`` (the current one by
    default), the waves weighed on the kernel's own CTAs an SM."""
    index = torch.cuda.current_device() if index is None else index
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    if kind == "houdayer":  # past g = 254 the counts' 16-bit lanes
        todo = [("houdn_bonds_table", int(int(group) > 254))]
    else:
        todo = [("ov_bonds_table", KINDS.index(kind))]
        if kind == "cmr":
            todo.append(("ov_mid_table", int(wolff)))
    out = {}
    for kernel, variant in todo:
        most = table_most(kernel, group)
        smem = most * int(group) * 8 if kernel == "houdn_bonds_table" else 0
        out[kernel] = ov_table_plan(n, n_disorder, n_temps, n_groups, sms,
                                    table_ctas(index, kernel, n_neighbors, variant, smem),
                                    most).per
    return out


def launch_event_table(lib, stream, dims, p_spins, p_sid, p_tasks, p_coup, p_temps,
                       p_scal, p_probes, p_words, scratch, *, kind, wolff, group=2,
                       p_labels=None, p_blue=None, observe=False, lattice=None,
                       tables=None, per=0):
    """:func:`launch_event` on a table lattice (``lattice``, :attr:`~.lattice.
    Lattice.table`), its neighbours read from ``tables`` (its device
    ``(fwd, bwd)``): the same launches in their table form, ``*_table``,
    each bond graph an int32 word a site labelled by :func:`link_graphs`
    (``cc_table_link``, ``cc.table_link_launches``), CMR's blue
    flip a byte a site in the scratch's ``flip``.  ``dims`` is ``(n_tasks,
    n, 1, 1, T, G, S)`` (:func:`check_event`); ``per`` the tasks a thread
    of the move's planned kernels (default each one's :func:`table_pers`)."""
    n_tasks, _, _, _, n_temps, n_groups, n_slots = dims
    st, par, seeds, st2, par2, flip = scratch
    stats = _stats_buffer(kind, observe, p_labels, p_blue)
    _check_observe(kind, observe, group)
    n, nb = lattice.n_spins, lattice.n_neighbors
    d = n_tasks // (n_temps * n_groups)
    if tables[0].data_ptr() % 16:
        raise ValueError("the forward table must be 16-byte aligned")
    fwd, bwd = (t.data_ptr() for t in tables)
    words = ov_table_words(n, nb, d, n_temps, n_groups, n_slots)
    w = words.ctypes.data
    k = KINDS.index(kind)
    houd = kind == "houdayer"
    pers = {key: per for key in TABLE_PLANNED} if per else table_pers(
        n, nb, d, n_temps, n_groups, kind, wolff, group)
    if houd:
        _build.check(lib.peapods_houdn_bonds_table(
            p_spins, p_sid, p_tasks, p_probes, fwd, st, seeds, w, group, int(wolff),
            pers["houdn_bonds_table"], stream), "houdn_bonds_table")
        LAUNCHES["houdn_bonds_table"] += 1
    else:
        _build.check(lib.peapods_ov_bonds_table(
            p_spins, p_sid, p_tasks, p_coup, p_temps, p_scal, p_probes, p_words, fwd,
            st, seeds, w, k, int(wolff), pers["ov_bonds_table"], stream), "ov_bonds_table")
        LAUNCHES["ov_bonds_table"] += 1
    first = par if stats is None else stats
    link_graphs(lib, stream, st, first, n_tasks, None, lattice, tables)
    if observe:
        return
    if houd:
        _build.check(lib.peapods_houdn_finish_table(
            p_spins, p_sid, p_tasks, p_scal, st, first, seeds, bwd, w, group, int(wolff),
            stream), "houdn_finish_table")
        LAUNCHES["houdn_finish_table"] += 1
        return
    last_st, last = st, first
    if kind == "cmr":
        _build.check(lib.peapods_ov_mid_table(
            p_spins, p_sid, p_tasks, p_coup, p_temps, p_scal, p_words, fwd, bwd, st,
            first, st2, flip, w, int(wolff), pers["ov_mid_table"], stream), "ov_mid_table")
        LAUNCHES["ov_mid_table"] += 1
        last_st, last = st2, par2 if p_labels is None else p_labels
        link_graphs(lib, stream, st2, last, n_tasks, None, lattice, tables)
    _build.check(lib.peapods_ov_finish_table(
        p_spins, p_sid, p_tasks, p_scal, seeds, last_st, last, flip, bwd, w, k,
        int(wolff), stream), "ov_finish_table")
    LAUNCHES["ov_finish_table"] += 1


# energy_partials (csrc/overlap.cu): a warp takes a block of 256 sites of
# `per` systems of one realization, a lane eight sites
ENERGY_BLOCK = 256


@functools.lru_cache(maxsize=None)
def energy_words(shape, n_disorder: int, n_systems: int, align: int = 0,
                 threads: int = 0, per: int = 0):
    """int32 host words of ``energy_partials`` (``csrc/overlap.cu``
    ``EnergyWalk``): ``W, n, n / W, wpl, Lb, La, nd, per, S, nb, S / per,
    d, warps``, then :func:`~.lattice.fast_divisor` ``(m, s)`` of ``wpl``,
    ``Lb``, ``nb`` and ``S / per``.  A system is ``n / W`` words of ``W``
    bytes (``megapair.pair_word_bytes``, as ``pair_overlap``'s) in lines of
    ``wpl`` words along the fast axis, over an inner slow axis of extent
    ``Lb`` (2D: ``L0``; 3D: ``L1``) and in 3D an outer one of extent ``La =
    L0`` (0 in 2D); ``nb`` blocks of 256 sites a system, a warp a
    (realization, system set, block), ``per`` systems a set:
    ``sweep.systems_per`` of the launch's lanes (eight sites each) against
    ``threads`` (its callers: a quarter of the card's resident threads;
    tools/probe_measure.py, NVIDIA H100 80GB HBM3: config 5 0.0095 ms a
    launch with 1 system a warp, 0.0083 with 2, 0.0066 with 4; config 4
    0.0036 with 1, 0.0033 with 2; the 64^2 glass 0.0031 with 1, 0.0033 with
    2), unless ``per`` is given."""
    from .megapair import pair_word_bytes

    shape = tuple(int(x) for x in shape)
    nd = len(shape)
    n = math.prod(shape)
    w = pair_word_bytes(shape[-1], align)
    lb, la = (shape[0], 0) if nd == 2 else (shape[1], shape[0])
    nb = -(-n // ENERGY_BLOCK)
    per = per or systems_per(nb * 32, n_disorder, n_systems, threads)
    sets = n_systems // per
    head = [w, n, n // w, shape[-1] // w, lb, la, nd, per, n_systems, nb, sets,
            n_disorder, n_disorder * sets * nb]
    div = [fast_divisor(x) for x in (shape[-1] // w, lb, nb, sets)]
    words = np.asarray(head + [v for md in div for v in md], np.int64)
    return words.astype(np.uint32).view(np.int32)


def launch_energy(lib, stream, words, p_spins, p_coup, p_e, p_m):
    """Launch ``energy_partials`` on raw pointers (:func:`energy_words`)."""
    _build.check(lib.peapods_energy_partials(
        p_spins, p_coup, p_e, p_m, words.ctypes.data, stream), "energy_partials")
    LAUNCHES["energy_partials"] += 1


def check_event(spins, sid, tasks, coup, temps, scal, probes, words, shape, kind):
    """Validate a move's tensors (the kernels' layout) on the lattice
    ``shape`` (:func:`geometry`); returns the kernel dims ``(n_tasks, L0,
    L1, L2, T, G, S)`` (a table lattice's ``(n_tasks, n, 1, 1, T, G, S)``)
    and the group size."""
    dev = spins.device
    d, n_sys, n = spins.shape
    n_temps, n_groups = tasks.shape[1:3]
    g = task_group_size(kind, tasks)
    b = d * n_temps * n_groups
    table = isinstance(shape, Lattice) and shape.table
    shape, offsets = geometry(shape)
    nd = len(shape)
    ex = _build.expect
    ex(spins, "spins", torch.int8, (d, n_sys, n), dev)
    ex(sid, "sid", torch.int32, (d, n_sys), dev)
    ex(tasks, "tasks", torch.int32, (d, n_temps, n_groups, g), dev)
    ex(coup, "coup", torch.float32, (d, n, len(offsets)), dev)
    ex(temps, "temps", torch.float32, (n_temps,), dev)
    ex(scal, "scal", torch.int32, (b, 6), dev)
    ex(probes, "probes", torch.int32, (b, 64), dev)
    ex(words, "words", torch.int32, (b, 2), dev)
    if not (table or nd in (2, 3)) or n != math.prod(shape):
        raise ValueError(f"spins do not hold lattices of shape {shape}")
    if b > 65535 or n_sys > 65535 or d > 65535:
        raise ValueError("at most 65535 tasks, systems and realizations")
    if table:
        if n * len(offsets) >= 2 ** 31:
            raise ValueError(f"a table of {n} x {len(offsets)} entries is larger "
                             "than int32 indexes")
        return (b, n, 1, 1, n_temps, n_groups, n_sys), g
    return (b, *_build.dims3(shape), n_temps, n_groups, n_sys), g


def overlap_event(spins, sid, tasks, coup, temps, scal, probes, words, *, kind,
                  wolff, shape, with_labels=False, with_masks=False, observe=False,
                  tables=None):
    """One overlap move of every task (see :func:`overlap_event_plain`) on
    the lattice ``shape`` (:func:`geometry`): the plain version for CPU
    tensors, the ``houdn_*`` kernels (Houdayer) or the ``ov_*`` ones
    (Joerg, CMR) for CUDA tensors, their table forms ``*_table`` on a
    table lattice, which reads its neighbours from ``tables`` (its device
    ``(fwd, bwd)``, :func:`~.lattice.check_tables`; required there).  The
    masks are bits ``0 .. n_dirs - 1`` of the first kernel's state
    words."""
    kw = dict(kind=kind, wolff=wolff, shape=shape, with_labels=with_labels,
              with_masks=with_masks, observe=observe)
    args = (spins, sid, tasks, coup, temps, scal, probes, words)
    if _build.device_kind(spins) == "cpu":
        return overlap_event_plain(*args, **kw)
    dims, g = check_event(*args, shape, kind)
    dev = spins.device
    n = spins.shape[-1]
    cmr = kind == "cmr"
    table = isinstance(shape, Lattice) and shape.table
    if table:
        check_tables(tables, shape, dev)
    labels = blue = None
    if with_labels or observe:
        if not (observe and cmr):
            labels = torch.empty((dims[0], n), dtype=torch.int32, device=dev)
        if cmr:
            blue = torch.empty((dims[0], n), dtype=torch.int32, device=dev)
    scratch = Scratch(dims[0], n, dev, cmr and not observe, table)
    lattice = shape if isinstance(shape, Lattice) else None
    launch_event(_build.library(), torch.cuda.current_stream(dev).cuda_stream,
                 dims, *(t.data_ptr() for t in args), scratch.ptrs(), kind=kind,
                 wolff=wolff, group=g,
                 p_labels=None if labels is None else labels.data_ptr(),
                 p_blue=None if blue is None else blue.data_ptr(), observe=observe,
                 lattice=lattice, tables=tables if table else None)
    if not (with_labels or with_masks):
        return None
    return MoveGraphs(labels if with_labels else None, blue if with_labels else None,
                      fk.state_masks(scratch.state, coup.shape[-1]) if with_masks else None)


def energy_partials(spins, coup, shape, per=0):
    """Each system's energy and magnetization as partial sums ``(e_part
    f32, m_part int32)`` ``[d, S, blocks]`` by system (see
    :func:`energy_partials_plain`; on the card one partial per block of 256
    sites, bitwise ``energy_partials_plain(..., blocks=True)``).  ``per``:
    the systems a warp takes, in place of :func:`energy_words`' rule."""
    if _build.device_kind(spins) == "cpu":
        return energy_partials_plain(spins, coup, shape)
    dev = spins.device
    d, n_sys, n = spins.shape
    _build.expect(spins, "spins", torch.int8, (d, n_sys, n), dev)
    _build.expect(coup, "coup", torch.float32, (d, n, len(shape)), dev)
    if len(shape) not in (2, 3) or n != math.prod(shape):
        raise ValueError(f"spins do not hold lattices of shape {shape}")
    if coup.data_ptr() % 16:
        raise ValueError("coup must be 16-byte aligned")
    lib = _build.library()
    nb = lib.peapods_site_blocks(n)
    e_part = torch.empty((d, n_sys, nb), dtype=torch.float32, device=dev)
    m_part = torch.empty((d, n_sys, nb), dtype=torch.int32, device=dev)
    words = energy_words(tuple(shape), d, n_sys, spins.data_ptr() % 8,
                         fk.resident_threads(dev.index) // 4, per)
    launch_energy(lib, torch.cuda.current_stream(dev).cuda_stream, words,
                  spins.data_ptr(), coup.data_ptr(), e_part.data_ptr(), m_part.data_ptr())
    return e_part, m_part
