"""Counter-based Philox4x32-10 in plain torch: the sweep's site uniforms.

The reference draws its acceptance uniforms from the TPU's hardware PRNG,
seeded per sweep with two 32-bit key words (``pltpu.prng_seed``,
``peapods_tpu/ops/pallas_mega.py:209``).  The port keeps those two words as
they are and uses them as the key of Philox4x32-10 (Salmon et al. 2011,
the Random123 variant); the counter is ``(slot, colour, site // 4, 0)``,
where ``site`` indexes the sites of the active colour in row-major order
(row ``r``, column ``2j + ((r + colour) & 1)`` is site ``r * W/2 + j``), and
site ``site`` takes output word ``site % 4``.  A uniform is the word's top
24 bits times ``2**-24``, as ``_hw_uniform`` makes it
(``peapods_tpu/ops/pallas_sweep.py:294-298``).

The per-sweep path's sweep uses the same draw with the system index in
place of the slot (``csrc/sweep.cu``); on the lattices without a
checkerboard it counts every site (:func:`site_uniforms`,
``csrc/sweep_nb.cu``).  The FK update and the overlap
moves draw their bond uniforms from Philox keyed by each graph's (task's)
two key words, counter ``(dir, site // 4, 0, 0)`` (:func:`bond_uniforms`,
``csrc/fk.cu``, ``csrc/overlap.cu``).

A row band of a lattice split over a ``space`` mesh draws the same bits
for its sites as the whole lattice does (:func:`slot_uniforms_at`,
:func:`bond_uniforms_at`: the draws at a list of global indices).

The CUDA kernels (``csrc/mega.cuh``) compute the same function in uint32;
this version works in int64 with 32-bit masks, and splits every 32x32-bit
product into 16-bit halves so that no intermediate leaves int64.
"""

from __future__ import annotations

import math

import torch

__all__ = ["MASK32", "mul_lo32", "mulhilo32", "philox4x32", "uniform24",
           "colour_uniforms", "site_uniforms", "bond_uniforms", "slot_uniforms_at",
           "bond_uniforms_at", "blocked"]

MASK32 = 0xFFFFFFFF
_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_INV24 = 1.0 / (1 << 24)


def mulhilo32(a, b: int):
    """``(hi, lo)`` 32-bit words of the 64-bit product of uint32 values
    ``a`` (int64 tensor) and ``b`` (int)."""
    p_lo = (a & 0xFFFF) * b  # < 2**48
    p_hi = (a >> 16) * b  # < 2**48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def mul_lo32(a, b: int):
    """Low 32 bits of ``a * b`` for uint32 values held in int64."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & MASK32


def philox4x32(k0, k1, c0, c1, c2, c3):
    """Philox4x32-10: uint32 values in int64 tensors (broadcast together);
    returns the four output words."""
    k0, k1, c0, c1, c2, c3 = torch.broadcast_tensors(k0, k1, c0, c1, c2, c3)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = mulhilo32(c0, _M0)
        hi1, lo1 = mulhilo32(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform24(word):
    """f32 uniform in [0, 1) from the top 24 bits of a uint32 word."""
    return (word >> 8).to(torch.float32) * _INV24


def colour_uniforms(words, n_slots: int, colour: int, shape):
    """Uniforms of one colour pass for every (sweep, realization, slot).

    ``words``: int32 ``[..., 2]`` sweep key words.  Returns f32
    ``[..., n_slots, *shape]`` full-lattice grids whose sites of colour
    ``colour`` hold that site's uniform (the other sites hold their
    partner's along the last axis and are never read).  The active sites
    are counted in row-major order, so a 3D ``[L0, L1, L2]`` lattice draws
    as the 2D ``[L0 L1, L2]`` one (``csrc/mega.cuh`` ``update_sites_3d``).
    """
    shape = tuple(shape)
    h, w = math.prod(shape[:-1]), shape[-1]
    wh = w // 2
    n_half = h * wh
    dev = words.device
    k = words.to(torch.int64) & MASK32
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1, 1)
    k1 = k[..., 1].reshape(*lead, 1, 1)
    slot = torch.arange(n_slots, device=dev, dtype=torch.int64)[:, None]
    grp = torch.arange((n_half + 3) // 4, device=dev, dtype=torch.int64)
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    out = philox4x32(k0, k1, slot, zero + colour, grp, zero)
    u = uniform24(torch.stack(out, dim=-1)).flatten(-2)[..., :n_half]
    # full-lattice site (..., col) reads active-colour site row * W/2 + col // 2
    u = u.reshape(*lead, n_slots, h, wh).repeat_interleave(2, dim=-1)
    return u.reshape(*lead, n_slots, *shape)


def site_uniforms(words, n_slots: int, colour: int, n_spins: int):
    """Uniforms of one colour pass of the per-sweep path on a coloured
    lattice (``csrc/sweep_nb.cu``): f32 ``[..., n_slots, n_spins]`` from
    int32 key words ``[..., 2]``.  Site ``i`` takes word ``i % 4`` of Philox
    keyed by the words, counter ``(slot, colour, i // 4, 0)``; only the
    sites of colour ``colour`` read theirs."""
    dev = words.device
    k = words.to(torch.int64) & MASK32
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1, 1)
    k1 = k[..., 1].reshape(*lead, 1, 1)
    slot = torch.arange(n_slots, device=dev, dtype=torch.int64)[:, None]
    grp = torch.arange((n_spins + 3) // 4, device=dev, dtype=torch.int64)
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    out = philox4x32(k0, k1, slot, zero + colour, grp, zero)
    return uniform24(torch.stack(out, dim=-1)).flatten(-2)[..., :n_spins]


def bond_uniforms(words, n_spins: int, n_dirs: int = 2, first: int = 0):
    """Uniforms of the cluster kernels' bond draws: f32 ``[..., n_spins,
    n_dirs]`` from int32 key words ``[..., 2]``.  Bond ``(site, dir)`` takes
    word ``site % 4`` of Philox keyed by the words, counter ``(first + dir,
    site // 4, 0, 0)``: the FK kernel's draw (``csrc/fk.cu``, ``first`` 0)
    and the overlap kernels' (``csrc/overlap.cu``: Joerg and CMR's blue
    bonds ``first`` 0, CMR's red bonds ``first = n_dirs``)."""
    dev = words.device
    k = words.to(torch.int64) & MASK32
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1, 1)
    k1 = k[..., 1].reshape(*lead, 1, 1)
    d = torch.arange(first, first + n_dirs, device=dev, dtype=torch.int64)[:, None]
    grp = torch.arange((n_spins + 3) // 4, device=dev, dtype=torch.int64)
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    out = philox4x32(k0, k1, d, grp, zero, zero)  # 4 x [..., n_dirs, groups]
    u = uniform24(torch.stack(out, dim=-1)).flatten(-2)[..., :n_spins]
    return u.transpose(-1, -2)


def _words_at(k, heads, idx):
    """Word ``idx % 4`` of Philox keyed by int64 key words ``k [..., 2]``,
    counter ``(*heads, idx // 4, ...)`` zero-padded to four words; every
    head and ``idx`` broadcast against ``k[..., 0]``."""
    zero = torch.zeros((), device=k.device, dtype=torch.int64)
    counter = [*heads, idx // 4] + [zero] * (3 - len(heads))
    out = torch.stack(philox4x32(k[..., 0], k[..., 1], *counter), dim=-1)
    return out.gather(-1, (idx % 4).expand(out.shape[:-1])[..., None])[..., 0]


def slot_uniforms_at(words, n_slots: int, colour: int, idx):
    """The uniforms of :func:`colour_uniforms` (``idx`` counts the active
    colour's sites) or :func:`site_uniforms` (``idx`` counts sites) at the
    global indices ``idx`` (int64 ``[n]``): f32 ``[..., n_slots, n]`` from
    key words ``[..., 2]``.  Index ``i`` takes word ``i % 4`` of Philox
    counter ``(slot, colour, i // 4, 0)``."""
    dev = words.device
    k = (words.to(torch.int64) & MASK32)[..., None, None, :]
    slot = torch.arange(n_slots, device=dev, dtype=torch.int64)[:, None]
    idx = idx.to(device=dev, dtype=torch.int64)
    return uniform24(_words_at(k, (slot, torch.full_like(slot, colour)), idx))


def bond_uniforms_at(words, idx, n_dirs: int):
    """The uniforms of :func:`bond_uniforms` (``first`` 0) at the global
    sites ``idx`` (int64 ``[n]``): f32 ``[..., n, n_dirs]`` from key words
    ``[..., 2]``."""
    dev = words.device
    k = (words.to(torch.int64) & MASK32)[..., None, None, :]
    d = torch.arange(n_dirs, device=dev, dtype=torch.int64)[:, None]
    idx = idx.to(device=dev, dtype=torch.int64)
    return uniform24(_words_at(k, (d,), idx)).transpose(-1, -2)


def blocked(draw, per_item: int):
    """``get(t)``: item ``t`` of ``draw(a, b)`` (items ``a .. b-1``,
    stacked), drawn a block of items at a time, a block holding at most
    2**22 elements.  The plain paths draw their Philox uniforms this way, in
    a few vectorised calls per chunk instead of one per sweep."""
    block = max(1, (1 << 22) // per_item)
    cache = {}

    def get(t):
        b = t // block
        if b not in cache:
            cache.clear()
            cache[b] = draw(b * block, (b + 1) * block)
        return cache[b][t - b * block]

    return get
