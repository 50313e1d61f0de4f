"""Parallel tempering of the mega and replica paths, in plain torch.

Counterpart of the PT step inside the megakernel
(``peapods_tpu/ops/pallas_mega.py:72-93`` and ``:153-270``), of the pairs
megakernel's PT on each replica's ladder and its jnp mirror
(``pallas_megapair._mp_kernel`` :621-657, ``pt_event_jnp`` :1314-1413), and
of ``init_trip_state`` (``peapods_tpu/ops/tempering.py:33-37``).  The swap rule
on edge ``(t, t+1)`` (tempering.rs:73-102), evaluated in this order in f32:

    delta = f32(n_spins) * (e[t+1] - e[t]) * (1/T_t - 1/T_{t+1})
    accept iff delta >= log(u)

A swap exchanges the two slots' ``system_ids`` entries and energies; spins
are never copied.  The scalar draws come from a murmur3-finalizer mix of the
sweep's two PT key words, bitwise the reference's ``_scalar_uniform`` /
``_scalar_randint``.  Schedules: a single random edge (edge salt 0, uniform
salt 1), or the full ladder in two parity passes with uniform salt
``2 * n_edges * i + e`` for pass ``i``, after which the parity flips.

With ``R`` replicas each realization has ``R`` ladders (slots ``r T ..
r T + T - 1``) that share the edge counters; the replica path draws with
the pairs megakernel's salts (:func:`pt_draws_pairs`): single edge, edge
``randint(salt r)`` and u ``uniform(salt R + r)`` for ladder ``r``; full
ladder, salt ``(i n_edges + e) R + r``.

Everything here runs on ``[d, ...]`` batches and updates the PT state
tensors in place, as the CUDA ``pt_step`` kernel does.  Edges of one
parity pass are disjoint, and the ladders hold different systems, so the
vectorized pass equals the kernel's edge-by-edge loop.
"""

from __future__ import annotations

import numpy as np
import torch

from .rng import MASK32, mul_lo32

__all__ = [
    "mix32",
    "scalar_uniform",
    "scalar_randint",
    "init_trip_state",
    "hot_cold_slots",
    "pt_draws",
    "pt_draws_pairs",
    "pt_apply",
]

_GOLDEN = 0x9E3779B9  # -1640531527 as int32
_INV24 = 1.0 / (1 << 24)


def _u32(x):
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mix32(x):
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = mul_lo32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul_lo32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def scalar_uniform(w0, w1, salt):
    """f32 uniform in [0, 1) from two key words and a draw index
    (int32 or int64 tensors or ints, broadcast)."""
    w0, w1, salt = _u32(w0), _u32(w1), _u32(salt)
    h = mix32(w0 ^ mix32((w1 + mul_lo32(salt, _GOLDEN)) & MASK32))
    return (h >> 8).to(torch.float32) * _INV24


def scalar_randint(w0, w1, salt, n: int):
    """int64 draw in ``[0, n)``."""
    w0, w1, salt = _u32(w0), _u32(w1), _u32(salt)
    h = mix32(w1 ^ mix32((w0 + mul_lo32(salt, _GOLDEN)) & MASK32))
    return (h >> 4) % n


def init_trip_state(system_ids, hot_slot: int):
    """int32 ``[d, n_systems]``: systems starting at the hot slot get trip
    state 1 (realization.rs:66-70).  ``system_ids``: ``[d, R, T]``."""
    d = system_ids.shape[0]
    n_systems = system_ids[0].numel()
    ts = torch.zeros((d, n_systems), dtype=torch.int32, device=system_ids.device)
    hot = system_ids[:, :, hot_slot].to(torch.int64)
    return ts.scatter_(1, hot, 1)


def hot_cold_slots(temps):
    """``(argmax, argmin)`` of the temperatures (loop.py:465-471)."""
    t = np.asarray(temps, np.float32)
    return int(np.argmax(t)), int(np.argmin(t))


def pt_draws(words, n_edges: int, *, pt_full: bool):
    """The PT step's scalar draws from int32 words ``[..., 2]``.

    Single edge: ``(edge int64 [...], u f32 [...])``.  Full ladder: u f32
    ``[..., 2, n_edges]`` with salt ``2 * n_edges * i + e`` at ``[..., i,
    e]`` (pass ``i``, edge ``e``).
    """
    w0, w1 = words[..., 0], words[..., 1]
    if not pt_full:
        return (scalar_randint(w0, w1, 0, n_edges),
                scalar_uniform(w0, w1, 1))
    e = torch.arange(n_edges, device=words.device)
    salts = torch.stack([e, 2 * n_edges + e])
    return scalar_uniform(w0[..., None, None], w1[..., None, None], salts)


def pt_draws_pairs(words, n_replicas: int, n_edges: int, *, pt_full: bool):
    """The replica path's PT draws from int32 words ``[..., 2]``, bitwise
    the pairs megakernel's (``pallas_megapair._mp_kernel`` :621-657).

    Single edge: ``(edge int64 [..., R], u f32 [..., R])``.  Full ladder:
    u f32 ``[..., R, 2, n_edges]`` with salt ``(i n_edges + e) R + r`` at
    ``[..., r, i, e]``.
    """
    w0, w1 = words[..., 0, None], words[..., 1, None]
    r = torch.arange(n_replicas, device=words.device)
    if not pt_full:
        return (scalar_randint(w0, w1, r, max(n_edges, 1)),
                scalar_uniform(w0, w1, n_replicas + r))
    i = torch.arange(2, device=words.device)[:, None]
    e = torch.arange(n_edges, device=words.device)
    salts = ((i * n_edges + e)[None] * n_replicas + r[:, None, None])
    return scalar_uniform(w0[..., None, None], w1[..., None, None], salts)


def _swap_pass(es, sid, ea, ec, rtrips, tstate, inv_t, edge, u, n_spins,
               hot_slot, cold_slot):
    """Try the edges ``edge`` (int64 ``[d, R, k]``, disjoint within each
    ladder) with uniforms ``u`` (f32 ``[d, R, k]``) on every realization's
    ``R`` ladders (``es``, ``sid``: ``[d, R, T]``), in place."""
    d = es.shape[0]
    e_l, e_r = es.gather(2, edge), es.gather(2, edge + 1)
    delta = (float(n_spins) * (e_r - e_l)) * (inv_t[edge] - inv_t[edge + 1])
    accept = delta >= torch.log(u)
    flat = edge.reshape(d, -1)
    ea.scatter_add_(1, flat, torch.ones_like(flat, dtype=ea.dtype))
    ec.scatter_add_(1, flat, accept.reshape(d, -1).to(ec.dtype))

    hot_old = sid[:, :, hot_slot].clone()
    cold_old = sid[:, :, cold_slot].clone()
    for x in (sid, es):
        left, right = x.gather(2, edge), x.gather(2, edge + 1)
        x.scatter_(2, edge, torch.where(accept, right, left))
        x.scatter_(2, edge + 1, torch.where(accept, left, right))

    # arrivals (tempering.py _record_arrivals): a system newly at the hot
    # slot closes a round trip if it came from the cold end (state 2); the
    # R ladders' systems are distinct
    hot = sid[:, :, hot_slot].to(torch.int64)
    arrived = hot != hot_old
    prev = tstate.gather(1, hot)
    rtrips.scatter_add_(1, hot, (arrived & (prev == 2)).to(rtrips.dtype))
    tstate.scatter_(1, hot, torch.where(arrived, 1, prev).to(tstate.dtype))
    cold = sid[:, :, cold_slot].to(torch.int64)
    arrived = cold != cold_old
    prev = tstate.gather(1, cold)
    tstate.scatter_(
        1, cold, torch.where(arrived & (prev == 1), 2, prev).to(tstate.dtype)
    )


def pt_apply(es, sid, ea, ec, rtrips, tstate, temps, draws, *, pt_full: bool,
             parity: int, n_spins: int, hot_slot: int, cold_slot: int,
             n_replicas: int = 1) -> int:
    """One PT event on each of the ``R`` ladders of every realization, in
    place.

    Args:
        es: f32 ``[d, R T]`` energy per spin of each slot (swapped along).
        sid: int32 ``[d, R T]`` system at each slot.
        ea, ec: int32 ``[d, n_edges]`` edge attempts / acceptances.
        rtrips, tstate: int32 ``[d, n_systems]`` round trips / trip state.
        temps: f32 ``[T]`` (or ``[R T]`` by slot: the ladders share them).
        draws: this event's draws, ``[d]`` leading: single edge ``(edge,
            u)`` each ``[d, R]`` (``[d]`` when R == 1), full ladder u
            ``[d, R, 2, n_edges]`` (``[d, 2, n_edges]`` when R == 1).
        parity: full-ladder parity of this event.

    Returns:
        The parity of the next event.
    """
    d = es.shape[0]
    n_temps = es.shape[1] // n_replicas
    n_edges = n_temps - 1
    inv_t = 1.0 / temps[:n_temps]
    es = es.view(d, n_replicas, n_temps)
    sid = sid.view(d, n_replicas, n_temps)
    args = (es, sid, ea, ec, rtrips, tstate, inv_t)
    if not pt_full:
        edge, u = draws
        _swap_pass(*args, edge.reshape(d, n_replicas, 1),
                   u.reshape(d, n_replicas, 1), n_spins, hot_slot, cold_slot)
        return parity
    draws = draws.reshape(d, n_replicas, 2, n_edges)
    for i, p in enumerate((parity, 1 - parity)):
        edge = torch.arange(p, n_edges, 2, device=es.device)
        if edge.numel():
            k = edge.expand(d, n_replicas, -1)
            _swap_pass(*args, k, draws[:, :, i, edge], n_spins, hot_slot,
                       cold_slot)
    return 1 - parity
