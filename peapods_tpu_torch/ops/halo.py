"""The sweep and the measurement of a lattice split into row bands.

Counterpart of the reference's halo colour passes
``peapods_tpu/ops/pallas_sweep.py`` ``sweep_2d_halo_color`` (:408),
``sweep_2d_halo_color_packed`` (:605), ``pallas_sweep3d.sweep_3d_halo_color``
(:595) and ``pallas_sweep_diag.sweep_gen_halo_color`` (:727), which the
engine runs under its ``space`` mesh axis.  Each band of a
:class:`~.lattice.BandGeometry` holds its spins in a window ``[d, S,
n_window]``: its own rows and, on each side, ``halo`` rows copied from the
neighbouring bands by :func:`exchange` before every pass that reads them.

:func:`sweep_halo` runs one colour pass over a band.  Every site draws the
uniform that the unsharded per-sweep kernels draw for it (``sweep_2d`` on
the square lattice, ``sweep_nb`` on the others), so that the bands' passes
together are bitwise the unsharded pass; with ``measure=True`` the pass also
returns (e, m) partials (the last pass of a two-colour lattice, the
reference's fused measure).  :func:`measure_halo` measures a band, reading
its forward neighbours across the edge from the halo.  On CUDA tensors both
launch ``csrc/halo.cu`` (counted in :data:`LAUNCHES`); on CPU tensors they
run :func:`sweep_halo_plain` / :func:`measure_halo_plain`.

The couplings of a band are given per window site: ``coup_fwd[d, w, k] =
J[site(w), k]`` and ``coup_bwd[d, w, k] = J[site(w) - off_k, k]``
(:func:`band_couplings`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, rng
from .sweep import METROPOLIS_LAZINESS, acceptance

__all__ = ["LAUNCHES", "exchange", "backward_couplings", "band_couplings", "sweep_halo",
           "sweep_halo_plain", "pass_decisions", "measure_halo", "measure_halo_plain",
           "gather_band_spins"]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"sweep_halo": 0, "measure_halo": 0}

_KEEP = 1.0 - METROPOLIS_LAZINESS


def exchange(windows, bands) -> None:
    """Copy every band's edge rows into its neighbours' halos: window
    tensors ``[..., n_window]``, one per band, in band order (periodic).
    ``copy_`` orders each copy on the streams of both devices, so a copy
    between two cards waits for the band that wrote its rows; on one card
    the copies are ordered on its stream."""
    n = len(windows)
    b = bands[0]
    m, blk, hl = b.halo, b.block, b.hl
    if m == 0:
        return
    for k in range(n):
        windows[k][..., :m * blk].copy_(windows[k - 1][..., hl * blk:(hl + m) * blk])
        windows[k][..., (m + hl) * blk:].copy_(windows[(k + 1) % n][..., m * blk:2 * m * blk])


def backward_couplings(coup_nd, lattice):
    """f32 ``[d, n_spins, n_neighbors]``: ``J[i - off_k, k]`` of forward
    couplings ``[d, n_spins, n_neighbors]`` (numpy), a roll of each
    offset's grid."""
    d, n, nb = coup_nd.shape
    nd = lattice.n_dims
    grid = coup_nd.reshape(d, *lattice.shape, nb)
    return np.stack([np.roll(grid[..., k], tuple(int(o) for o in off), tuple(range(1, nd + 1)))
                     for k, off in enumerate(lattice.offsets)], -1).reshape(d, n, nb)


def band_couplings(coup_nd, band, device, coup_bwd_nd=None):
    """f32 ``(coup_fwd, coup_bwd)`` ``[d, n_window, n_neighbors]`` of a
    band's window sites from the forward couplings ``[d, n_spins,
    n_neighbors]`` (numpy) and, when given, their backward twins
    (:func:`backward_couplings`)."""
    if coup_bwd_nd is None:
        coup_bwd_nd = backward_couplings(coup_nd, band.lattice)
    sites = band.window_sites()
    return tuple(torch.as_tensor(np.ascontiguousarray(x[:, sites], np.float32),
                                 device=device) for x in (coup_nd, coup_bwd_nd))


def gather_band_spins(windows, bands):
    """The lattice's spins ``[..., n_spins]`` from the bands' windows, on
    the first band's device."""
    dev = windows[0].device
    return torch.cat([w[..., b.interior].to(dev) for w, b in zip(windows, bands)], -1)


def _grid(x, band):
    """``[..., n_window]`` as the window's grid ``[..., rows, L1(, L2)]``."""
    return x.reshape(*x.shape[:-1], *band.window_shape)


def _shift(g, off, band):
    """Interior sites' values at ``site + off`` of a window grid, flat
    ``[..., n_band]``: a roll of the window (its wrap along the rows only
    reaches halo rows, never read)."""
    nd = len(band.window_shape)
    y = torch.roll(g, tuple(-int(o) for o in off), tuple(range(-nd, 0)))
    return y.reshape(*y.shape[:-nd], -1)[..., band.interior]


def _colour_sites(band):
    """int64 global colour-site index of the band's square-lattice sites
    ``[hl, W]`` (both colours: a site's column pair shares one)."""
    w = band.lattice.shape[1]
    r = band.row0 + np.arange(band.hl)
    return torch.from_numpy(r[:, None] * (w // 2) + np.arange(w)[None, :] // 2)


def pass_decisions(spins, coup_fwd, coup_bwd, colours, sys_temps, words, band, colour,
                   *, gibbs, uniforms=None):
    """The decisions of a band's colour pass (see :func:`sweep_halo_plain`
    for the arguments), without applying them: ``(c, field, active, lhs,
    threshold, flip)``, each ``[d, S, n_band]`` but ``active`` bool
    ``[n_band]``.  ``flip`` compares ``lhs`` with ``threshold``: the uniform
    below the acceptance, or (Gibbs off the square lattice) the bond
    energy at or above ``T/2 log(u / (1 - u))``."""
    d, n_sys = spins.shape[:2]
    lat = band.lattice
    inner = band.interior
    s = spins.to(torch.float32)
    c = s[..., inner]
    jf, jb = coup_fwd[:, None, inner], coup_bwd[:, None, inner]
    g = _grid(s, band)
    if lat.square:
        w = lat.shape[1]
        m = band.halo
        up = g[..., m - 1:m - 1 + band.hl, :].reshape(d, n_sys, -1)
        dn = g[..., m + 1:m + 1 + band.hl, :].reshape(d, n_sys, -1)
        cg = c.reshape(d, n_sys, band.hl, w)
        lf = torch.roll(cg, 1, -1).reshape(d, n_sys, -1)
        rg = torch.roll(cg, -1, -1).reshape(d, n_sys, -1)
        field = up * jb[..., 0] + dn * jf[..., 0]
        field = field + lf * jb[..., 1]
        field = field + rg * jf[..., 1]
        if uniforms is None:
            cs = _colour_sites(band).reshape(-1)
            uniforms = rng.slot_uniforms_at(words, n_sys, colour, cs)
        x = (-c * field) * (1.0 / (0.5 * sys_temps))[..., None]
        lhs, thr = uniforms, acceptance(x, gibbs=gibbs)
        flip = lhs < thr
        r = torch.arange(band.hl, device=s.device)[:, None] + band.row0
        active = (((r + torch.arange(w, device=s.device)) & 1) == colour).reshape(-1)
    else:
        field = torch.zeros_like(c)
        for k, off in enumerate(lat.offsets):
            field = field + _shift(g, off, band) * jf[..., k]
            field = field + _shift(g, -off, band) * jb[..., k]
        if uniforms is None:
            uniforms = rng.slot_uniforms_at(words, n_sys, colour,
                                            torch.from_numpy(band.band_sites()))
        eng = -c * field
        if gibbs:
            half_t = (sys_temps * 0.5)[..., None]
            lhs, thr = eng, half_t * torch.log(uniforms / (1.0 - uniforms))
            flip = lhs >= thr
        else:
            inv_half_t = (1.0 / (sys_temps * 0.5))[..., None]
            lhs, thr = uniforms, _KEEP * torch.exp(torch.clamp(eng * inv_half_t, max=0.0))
            flip = lhs < thr
        active = colours[inner] == colour
    return c, field, active, lhs, thr, flip


def sweep_halo_plain(spins, coup_fwd, coup_bwd, colours, sys_temps, words, band,
                     colour, *, gibbs, measure=False, uniforms=None):
    """One colour pass over a band's sites, in place.

    Args:
        spins: int8 ``[d, S, n_window]`` the band's window (halos current).
        coup_fwd, coup_bwd: f32 ``[d, n_window, n_neighbors]``.
        colours: uint8 ``[n_window]`` the lattice's colouring at the window
            sites (unread on the square lattice, whose parity is global).
        sys_temps: f32 ``[d, S]``.
        words: int32 ``[d, 2]`` the sweep's key words (unused when
            ``uniforms`` is given).
        uniforms: optional f32 ``[d, S, n_band]`` the band's sites' uniforms.
        measure: also return ``(e_part f32 [d, S, 1], m_part int32 [d, S,
            1])``: s * field summed over the pass's sites and s over the
            band, after the pass.
    """
    c, field, active, _, _, flip = pass_decisions(
        spins, coup_fwd, coup_bwd, colours, sys_temps, words, band, colour, gibbs=gibbs,
        uniforms=uniforms)
    new = torch.where(flip & active, -c, c)
    spins[..., band.interior] = new.to(torch.int8)
    if not measure:
        return None
    e_part = torch.where(active, new * field, 0.0).sum(-1, keepdim=True)
    return e_part, new.to(torch.int32).sum(-1, keepdim=True, dtype=torch.int32)


def _check(spins, coup_fwd, band, sys_temps=None, words=None):
    dev = spins.device
    d, n_sys, nw = spins.shape
    nb = band.lattice.n_neighbors
    _build.expect(spins, "spins", torch.int8, (d, n_sys, band.n_window), dev)
    _build.expect(coup_fwd, "coup_fwd", torch.float32, (d, nw, nb), dev)
    if sys_temps is not None:
        _build.expect(sys_temps, "sys_temps", torch.float32, (d, n_sys), dev)
        _build.expect(words, "words", torch.int32, (d, 2), dev)
    if d > 65535 or n_sys > 65535:
        raise ValueError("at most 65535 realizations and systems")
    return d, n_sys, nw


def sweep_halo(spins, coup_fwd, coup_bwd, colours, sys_temps, words, band, colour,
               *, gibbs, measure=False, uniforms=None):
    """One colour pass over a band (see :func:`sweep_halo_plain`): the plain
    version for CPU tensors, the ``sweep_halo`` kernel for CUDA tensors,
    whose partials have one entry per block of 1024 (colour) sites of the
    band.  ``uniforms`` (CPU only) are injected uniforms."""
    kw = dict(gibbs=gibbs, measure=measure)
    if _build.device_kind(spins) == "cpu":
        return sweep_halo_plain(spins, coup_fwd, coup_bwd, colours, sys_temps, words,
                                band, colour, uniforms=uniforms, **kw)
    if uniforms is not None:
        raise ValueError("the sweep_halo kernel draws its own uniforms")
    d, n_sys, nw = _check(spins, coup_fwd, band, sys_temps, words)
    dev = spins.device
    _build.expect(coup_bwd, "coup_bwd", torch.float32, tuple(coup_fwd.shape), dev)
    _build.expect(colours, "colours", torch.uint8, (nw,), dev)
    square = band.lattice.square
    if measure and band.lattice.n_colors != 2:
        raise ValueError("the fused measure counts each bond once on a two-colour "
                         "lattice only")
    lib = _build.library()
    parts = (None, None)
    if measure:
        nb = lib.peapods_halo_blocks(band.words.ctypes.data, int(square))
        parts = (torch.empty((d, n_sys, nb), dtype=torch.float32, device=dev),
                 torch.empty((d, n_sys, nb), dtype=torch.int32, device=dev))
    _build.check(lib.peapods_sweep_halo(
        spins.data_ptr(), coup_fwd.data_ptr(), coup_bwd.data_ptr(), colours.data_ptr(),
        sys_temps.data_ptr(), words.data_ptr(),
        *(None if t is None else t.data_ptr() for t in parts),
        band.words.ctypes.data, d, n_sys, colour, int(gibbs), int(square),
        torch.cuda.current_stream(dev).cuda_stream), "sweep_halo")
    LAUNCHES["sweep_halo"] += 1
    return parts if measure else None


def measure_halo_plain(spins, coup_fwd, band):
    """Plain version of ``measure_halo``: ``(e_part f32 [d, S, 1], m_part
    int32 [d, S, 1])``, the forward-bond energy sum (the offsets' sums added
    in order, as ``energy.bond_sums``) and the magnetization of a band's
    sites, reading the halo (current) for the bonds across its edge."""
    inner = band.interior
    s = spins.to(torch.float32)
    g = _grid(s, band)
    c = s[..., inner]
    e = torch.zeros(s.shape[:-1], dtype=torch.float32, device=s.device)
    for k, off in enumerate(band.lattice.offsets):
        e = e + (c * _shift(g, off, band) * coup_fwd[:, None, inner, k]).sum(-1)
    m = spins[..., inner].to(torch.int32).sum(-1, dtype=torch.int32)
    return e[..., None], m[..., None]


def measure_halo(spins, coup_fwd, band):
    """The (e, m) partials of a band (see :func:`measure_halo_plain`): the
    plain version for CPU tensors, the ``measure_halo`` kernel for CUDA
    tensors, one partial per block of 1024 sites of the band."""
    if _build.device_kind(spins) == "cpu":
        return measure_halo_plain(spins, coup_fwd, band)
    d, n_sys, _ = _check(spins, coup_fwd, band)
    dev = spins.device
    lib = _build.library()
    nb = lib.peapods_halo_blocks(band.words.ctypes.data, 0)
    e_part = torch.empty((d, n_sys, nb), dtype=torch.float32, device=dev)
    m_part = torch.empty((d, n_sys, nb), dtype=torch.int32, device=dev)
    _build.check(lib.peapods_measure_halo(
        spins.data_ptr(), coup_fwd.data_ptr(), band.words.ctypes.data,
        e_part.data_ptr(), m_part.data_ptr(), d, n_sys,
        torch.cuda.current_stream(dev).cuda_stream), "measure_halo")
    LAUNCHES["measure_halo"] += 1
    return e_part, m_part
