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
place of the slot (``csrc/sweep.cu``), and the FK update draws its bond
uniforms from Philox keyed by each graph's two ``kb`` words, counter
``(dir, site // 4, 0, 0)`` (:func:`bond_uniforms`, ``csrc/fk.cu``).

The CUDA kernels (``csrc/mega.cuh``) compute the same function in uint32;
this version works in int64 with 32-bit masks, and splits every 32x32-bit
product into 16-bit halves so that no intermediate leaves int64.
"""

from __future__ import annotations

import torch

__all__ = ["MASK32", "mul_lo32", "mulhilo32", "philox4x32", "uniform24",
           "colour_uniforms", "bond_uniforms", "blocked"]

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
    ``[..., n_slots, H, W]`` full-lattice grids whose sites of colour
    ``colour`` hold that site's uniform (the other sites hold their
    column partner's and are never read).
    """
    h, w = shape
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
    # full-lattice site (r, col) reads active-colour site r * W/2 + col // 2
    return u.reshape(*lead, n_slots, h, wh).repeat_interleave(2, dim=-1)


def bond_uniforms(words, n_spins: int):
    """Uniforms of the FK bond draws: f32 ``[..., n_spins, 2]`` from int32
    graph key words ``[..., 2]``.  Bond ``(site, dir)`` takes word
    ``site % 4`` of Philox keyed by the graph's words, counter ``(dir,
    site // 4, 0, 0)`` -- the CUDA FK kernel's draw (``csrc/fk.cu``)."""
    dev = words.device
    k = words.to(torch.int64) & MASK32
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1, 1)
    k1 = k[..., 1].reshape(*lead, 1, 1)
    d = torch.arange(2, device=dev, dtype=torch.int64)[:, None]
    grp = torch.arange((n_spins + 3) // 4, device=dev, dtype=torch.int64)
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    out = philox4x32(k0, k1, d, grp, zero, zero)  # 4 x [..., 2, groups]
    u = uniform24(torch.stack(out, dim=-1)).flatten(-2)[..., :n_spins]
    return u.transpose(-1, -2)


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
