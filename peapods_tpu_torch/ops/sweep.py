"""The checkerboard colour update of a 2D square lattice, and the
stand-alone sweep of the per-sweep path.

Counterpart of ``_kernel_body`` / ``_kernel_body_2sub``
(``peapods_tpu/ops/pallas_sweep.py:164-291``) and of ``mc_sweep``
(``peapods_tpu/ops/sweep.py``): the CPU version of the update, and the
version the CUDA kernels are held against on the card.  Same math, in the
same order of f32 operations as the kernels:

    field = s_up*ju + s_down*jd + s_left*jl + s_right*jr
    x     = (-s * field) * (1 / (0.5 * T))
    Metropolis: flip iff u < (15/16) * exp(min(x, 0))
    Gibbs:      flip iff u < 1 / (1 + exp(-x))

The lazy factor ``1 - 1/16`` keeps the synchronous Metropolis chain
ergodic (see the docstring of ``peapods_tpu/ops/sweep.py``).

:func:`sweep_2d` is the port of ``pallas_sweep.sweep_2d`` (:728): one sweep
of every (realization, system) at each system's temperature, for runs with
a cluster phase.  On CUDA tensors it launches ``csrc/sweep.cu`` twice (one
launch per colour) and counts them in :data:`LAUNCHES`; on CPU tensors it
runs :func:`sweep_2d_plain`, which draws the same Philox uniforms.
"""

from __future__ import annotations

import torch

from . import _build, rng
from .energy import per_spin

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
]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"sweep_2d": 0}

# Acceptance-probability scale 1-eps of the lazy synchronous Metropolis
# kernel (peapods_tpu/ops/sweep.py:50).
METROPOLIS_LAZINESS = 1.0 / 16.0
_KEEP = 1.0 - METROPOLIS_LAZINESS


def pack_coupling_grids(coup_fwd, shape):
    """``[..., 4, H, W]`` pre-shifted coupling grids (ju, jd, jl, jr) from
    forward couplings ``[..., n_spins, 2]`` (pallas_sweep.py:239-247)::

        ju[i,j] = J0[i-1,j]   jd[i,j] = J0[i,j]
        jl[i,j] = J1[i,j-1]   jr[i,j] = J1[i,j]
    """
    h, w = shape
    lead = coup_fwd.shape[:-2]
    j0 = coup_fwd[..., 0].reshape(*lead, h, w)
    j1 = coup_fwd[..., 1].reshape(*lead, h, w)
    return torch.stack(
        [torch.roll(j0, 1, -2), j0, torch.roll(j1, 1, -1), j1], dim=-3
    )


def local_field(s, jgrids):
    """f32 local field of every site: ``s`` f32 ``[..., H, W]``, ``jgrids``
    ``[..., 4, H, W]``."""
    return (
        torch.roll(s, 1, -2) * jgrids[..., 0, :, :]
        + torch.roll(s, -1, -2) * jgrids[..., 1, :, :]
        + torch.roll(s, 1, -1) * jgrids[..., 2, :, :]
        + torch.roll(s, -1, -1) * jgrids[..., 3, :, :]
    )


def acceptance(x, *, gibbs: bool):
    """Flip probability for ``x = -s * field / (T/2)``."""
    if gibbs:
        return 1.0 / (1.0 + torch.exp(-x))
    return _KEEP * torch.exp(torch.clamp(x, max=0.0))


def colour_mask(shape, colour, device):
    """bool ``[H, W]``: the sites of one checkerboard colour."""
    h, w = shape
    r = torch.arange(h, device=device)[:, None]
    c = torch.arange(w, device=device)[None, :]
    return ((r + c) & 1) == colour


def colour_update(s, jgrids, inv_half_t, u, colour: int, *, gibbs: bool):
    """Update the sites of one colour of a full ``[H, W]`` lattice.

    Args:
        s: f32 ``[..., H, W]`` spins (+-1).
        jgrids: ``[..., 4, H, W]`` from :func:`pack_coupling_grids`.
        inv_half_t: f32 ``1 / (0.5 * T)``, broadcast against ``[...]``.
        u: f32 ``[..., H, W]`` uniforms; only the active colour's are read.
        colour: 0 updates the sites with even ``row + col``, 1 the odd ones.

    Returns:
        ``(s_new, field)``: the updated spins and the field they saw.
    """
    field = local_field(s, jgrids)
    x = (-s * field) * inv_half_t
    flip = (u < acceptance(x, gibbs=gibbs)) & colour_mask(
        s.shape[-2:], colour, s.device
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
    d, n_sys, h, w = spins.shape
    s = spins.to(torch.float32)
    inv_half_t = (1.0 / (0.5 * sys_temps))[..., None, None]
    for colour in (0, 1):
        u = (uniforms[:, :, colour] if uniforms is not None
             else rng.colour_uniforms(words, n_sys, colour, (h, w)))
        s, field = colour_update(s, jgrids[:, None], inv_half_t, u, colour,
                                 gibbs=gibbs)
    spins.copy_(s.to(torch.int8))
    if not measure:
        return None
    odd = colour_mask((h, w), 1, s.device)
    e_part = torch.where(odd, s * field, 0.0).sum((-2, -1))
    m_part = s.to(torch.int32).sum((-2, -1), dtype=torch.int32)
    return e_part[..., None], m_part[..., None]


def sweep_2d(spins, jgrids, sys_temps, words, *, gibbs, measure=False,
             uniforms=None):
    """One sweep of every (realization, system) (see
    :func:`sweep_2d_plain`): the plain version for CPU tensors, two launches
    of the ``sweep_2d`` kernel for CUDA tensors, whose partials have one
    entry per block of the pass.  ``uniforms`` (CPU only) are
    the sweep's Philox uniforms drawn ahead by the caller."""
    if _build.device_kind(spins) == "cpu":
        return sweep_2d_plain(spins, jgrids, sys_temps, words, gibbs=gibbs,
                              measure=measure, uniforms=uniforms)
    if uniforms is not None:
        raise ValueError("the sweep_2d kernel draws its own uniforms")
    dev = spins.device
    d, n_sys, h, w = spins.shape
    _build.expect(spins, "spins", torch.int8, (d, n_sys, h, w), dev)
    _build.expect(jgrids, "jgrids", torch.float32, (d, 4, h, w), dev)
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
        ptrs = ((None, None) if colour == 0 or parts is None
                else tuple(t.data_ptr() for t in parts))
        _build.check(lib.peapods_sweep_2d(
            spins.data_ptr(), jgrids.data_ptr(), sys_temps.data_ptr(),
            words.data_ptr(), *ptrs, d, n_sys, h, w, colour, int(gibbs),
            stream,
        ), "sweep_2d")
        LAUNCHES["sweep_2d"] += 1
    return parts
