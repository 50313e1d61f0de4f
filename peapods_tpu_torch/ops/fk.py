"""The FK cluster update (Swendsen-Wang or Wolff) of a flat graph batch.

Counterpart of ``peapods_tpu/ops/pallas_event.py`` ``fk_update_batch``
(:759, kernel ``_fk_kernel`` :621) and of the engine's staged chain
``fk_bond_activation -> connected_components -> coin / Wolff flips``
(``peapods_tpu/engine/loop.py:1883-1976``).  The graphs are the
(realization, system) pairs, flat and disorder-major: spins int8 ``[B, H,
W]`` by system (``B = d * S``), the forward couplings f32 ``[d, H*W, 2]``
of the realizations, one temperature and one row of scalars ``(salt0,
salt1, seed)`` (:func:`~peapods_tpu_torch.engine.seeds.fk_scalars`) and
two key words ``kb`` per graph.  The graphs are not packed into tiles.

:func:`fk_update` launches the three kernels of ``csrc/fk.cu`` on CUDA
tensors (counted in :data:`LAUNCHES`) and runs :func:`fk_update_plain` on
CPU tensors.  Both update the spins in place and return the same values:
bond uniforms from Philox keyed by ``kb`` (``rng.bond_uniforms``), labels
equal to each component's minimum site index, and per-graph partial sums
of the post-update energy and magnetization (one partial per kernel block;
one per graph in the plain version).
"""

from __future__ import annotations

import torch

from . import _build, rng
from .cluster import (
    cluster_coin_flip_mask,
    connected_components,
    fk_bond_activation,
    wolff_flip_mask,
)
from .energy import per_spin

__all__ = [
    "LAUNCHES",
    "fk_update",
    "fk_update_plain",
    "fk_bonds_plain",
    "fk_link_plain",
    "fk_finish_plain",
    "fk_energy_mag",
]

# kernel launches since the last reset, by kernel name
LAUNCHES = {"fk_bonds": 0, "fk_link": 0, "fk_finish": 0}


def _ptr(t):
    return None if t is None else t.data_ptr()


def fk_energy_mag(e_part, m_part, n_spins: int):
    """``(e f32 [B], m int32 [B])`` from partials ``[B, blocks]``, added in
    order: the energy per spin and the magnetization sum."""
    return per_spin(e_part.sum(-1), n_spins), m_part.sum(-1, dtype=torch.int32)


def fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms=None):
    """Plain version of ``fk_bonds``: bool ``[B, H*W, 2]`` FK bonds of
    every graph (arguments as in :func:`fk_update_plain`)."""
    b, h, w = spins.shape
    n = h * w
    d = j_fwd.shape[0]
    u = uniforms if uniforms is not None else rng.bond_uniforms(kb_words, n)
    bonds = fk_bond_activation(spins.reshape(d, b // d, n), j_fwd[:, None],
                               (h, w), temps.reshape(d, -1),
                               u.reshape(d, -1, n, 2))
    return bonds.reshape(b, n, 2)


def fk_link_plain(bonds, shape):
    """Plain version of ``fk_link``: int32 ``[B, H*W]`` labels, each
    component's minimum site index."""
    return connected_components(bonds, shape)


def fk_finish_plain(spins, labels, j_fwd, scalars, *, wolff, with_measure):
    """Plain version of ``fk_finish``: flip the clusters in place (SW coin
    or Wolff seed) and, when ``with_measure``, return the post-update
    partials ``(e_part f32 [B, 1], m_part int32 [B, 1])``."""
    b, h, w = spins.shape
    n = h * w
    d = j_fwd.shape[0]
    if wolff:
        flip = wolff_flip_mask(labels, scalars[:, 2])
    else:
        flip = cluster_coin_flip_mask(labels, scalars[:, :2])
    s = spins.reshape(b, n)
    new = torch.where(flip, -s, s)
    spins.copy_(new.reshape(b, h, w))
    if not with_measure:
        return None, None
    sf = new.to(torch.float32).reshape(d, b // d, h, w)
    e = torch.zeros_like(sf)
    for k in range(2):
        e = e + sf * torch.roll(sf, -1, dims=-2 + k) * j_fwd[:, None, :, k].reshape(
            d, 1, h, w)
    return (e.reshape(b, n).sum(-1, keepdim=True),
            new.to(torch.int32).sum(-1, keepdim=True, dtype=torch.int32))


def fk_update_plain(spins, j_fwd, temps, scalars, kb_words, *, wolff,
                    with_measure, with_labels, uniforms=None):
    """One FK update of every graph, in place, in plain torch: the three
    kernels' plain versions in turn.

    Args:
        spins: int8 ``[B, H, W]``, updated in place.
        j_fwd: f32 ``[d, H*W, 2]`` forward couplings; graph ``b`` reads
            realization ``b // (B // d)``.
        temps: f32 ``[B]``.
        scalars: int32 ``[B, 3]`` ``(salt0, salt1, seed)``.
        kb_words: int32 ``[B, 2]`` bond-draw key words (unused when
            ``uniforms`` is given).
        uniforms: optional f32 ``[B, H*W, 2]`` injected bond uniforms.

    Returns:
        ``(e_part f32 [B, 1], m_part int32 [B, 1])`` of the post-update
        spins when ``with_measure`` (else ``None, None``), and the int32
        ``[B, H, W]`` labels when ``with_labels`` (else ``None``).
    """
    b, h, w = spins.shape
    bonds = fk_bonds_plain(spins, j_fwd, temps, kb_words, uniforms)
    labels = fk_link_plain(bonds, (h, w))
    e_part, m_part = fk_finish_plain(spins, labels, j_fwd, scalars, wolff=wolff,
                                     with_measure=with_measure)
    return e_part, m_part, labels.reshape(b, h, w) if with_labels else None


def fk_update(spins, j_fwd, temps, scalars, kb_words, *, wolff, with_measure,
              with_labels, uniforms=None):
    """One FK update of every graph (see :func:`fk_update_plain`): the plain
    version for CPU tensors, the ``fk_bonds``, ``fk_link`` and
    ``fk_finish`` kernels for CUDA tensors.  The kernel partials have one
    entry per block of 256 sites.  ``uniforms`` (CPU only) are the bond
    uniforms of ``kb_words`` drawn ahead by the caller."""
    kw = dict(wolff=wolff, with_measure=with_measure, with_labels=with_labels)
    if _build.device_kind(spins) == "cpu":
        return fk_update_plain(spins, j_fwd, temps, scalars, kb_words,
                               uniforms=uniforms, **kw)
    if uniforms is not None:
        raise ValueError("the FK kernels draw their own uniforms")
    dev = spins.device
    b, h, w = spins.shape
    n = h * w
    d = j_fwd.shape[0]
    if d == 0 or b % d:
        raise ValueError(f"{b} graphs do not split over {d} realizations")
    _build.expect(spins, "spins", torch.int8, (b, h, w), dev)
    _build.expect(j_fwd, "j_fwd", torch.float32, (d, n, 2), dev)
    _build.expect(temps, "temps", torch.float32, (b,), dev)
    _build.expect(scalars, "scalars", torch.int32, (b, 3), dev)
    _build.expect(kb_words, "kb_words", torch.int32, (b, 2), dev)
    if b > 65535:
        raise ValueError("at most 65535 graphs per update")
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = torch.empty((b, n), dtype=torch.uint8, device=dev)
    parent = torch.empty((b, n), dtype=torch.int32, device=dev)
    labels = (torch.empty((b, h, w), dtype=torch.int32, device=dev)
              if with_labels else None)
    e_part = m_part = None
    if with_measure:
        nb = lib.peapods_fk_blocks(h, w)
        e_part = torch.empty((b, nb), dtype=torch.float32, device=dev)
        m_part = torch.empty((b, nb), dtype=torch.int32, device=dev)
    _build.check(lib.peapods_fk_bonds(
        spins.data_ptr(), j_fwd.data_ptr(), temps.data_ptr(),
        kb_words.data_ptr(), state.data_ptr(), parent.data_ptr(), b, b // d,
        h, w, stream), "fk_bonds")
    LAUNCHES["fk_bonds"] += 1
    _build.check(lib.peapods_fk_link(
        state.data_ptr(), parent.data_ptr(), b, h, w, stream), "fk_link")
    LAUNCHES["fk_link"] += 1
    _build.check(lib.peapods_fk_finish(
        spins.data_ptr(), state.data_ptr(), parent.data_ptr(), _ptr(labels),
        j_fwd.data_ptr(), scalars.data_ptr(), _ptr(e_part), _ptr(m_part), b, b // d,
        h, w, int(wolff), stream), "fk_finish")
    LAUNCHES["fk_finish"] += 1
    return e_part, m_part, labels
