"""Seed derivation and the threefry2x32 key words, in numpy.

Counterpart of ``peapods_tpu/engine/seeds.py`` and of the key handling in
``peapods_tpu/engine/loop.py`` (``_mega_chunk_runner.words``) and
``engine/simulation.py`` (initial spins).  The reference keeps its keys as
``jax.random`` threefry keys; here the same 64-bit key words are computed on
the host with a numpy threefry2x32, bitwise equal to ``jax.random`` with
``jax_threefry_partitionable=True``.  The host computes a whole chunk's
per-sweep words at once and uploads them in one copy.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "splitmix64",
    "realization_seed",
    "seed_material",
    "dynamics_seed",
    "threefry2x32",
    "PRNGKey",
    "fold_in",
    "key_data",
    "key_from_u64",
    "split",
    "random_bits",
    "randint",
    "uniform",
    "sweep_words",
    "fk_keys",
    "fk_scalars",
    "pt_draws_jnp",
    "initial_spins",
    "PH_SWEEP",
    "PH_FK",
    "PH_PT",
    "INIT_DOMAIN",
]

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
_M32 = 0xFFFFFFFF

# Phase salts folded into the per-sweep key (peapods_tpu/engine/loop.py:91)
PH_SWEEP = 1
PH_FK = 2
PH_PT = 4
# Domain of the initial-spin draw (peapods_tpu/engine/simulation.py:43)
INIT_DOMAIN = 0x5EED


def splitmix64(value: int) -> int:
    """splitmix64 mix function (reference src/lib.rs:22-28)."""
    v = np.uint64(value & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        v = (v + np.uint64(0x9E3779B97F4A7C15)) & _MASK
        z = v
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK
        z = z ^ (z >> np.uint64(31))
    return int(z)


def realization_seed(root: int, realization: int) -> int:
    """Per-disorder-realization seed (reference src/lib.rs:30-32)."""
    return splitmix64(root ^ splitmix64(realization))


def seed_material(seed):
    """(coupling SeedSequence, 64-bit dynamics seed) — spin_models.py:13-19."""
    if seed is not None and (not isinstance(seed, (int, np.integer)) or seed < 0):
        raise ValueError("seed must be a non-negative integer or None")
    root = np.random.SeedSequence(seed)
    coupling_seed, dyn_seed = root.spawn(2)
    dynamics = int(dyn_seed.generate_state(1, dtype=np.uint64)[0])
    return coupling_seed, dynamics


def dynamics_seed(seed) -> int:
    return seed_material(seed)[1]


# ------------------------------------------------------------ threefry2x32

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as ``jax.random``
    computes it.  All arguments are uint32 arrays (broadcast together);
    returns the two output words."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    k0, k1, x0, x1 = np.broadcast_arrays(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` key data for a seed below 2**32."""
    seed = int(seed)
    if not 0 <= seed < 1 << 32:
        raise ValueError("seed must lie in [0, 2**32)")
    return np.array([0, seed], np.uint32)


def key_data(key) -> np.ndarray:
    """The uint32 words of a key (keys are their own data here)."""
    return np.asarray(key, np.uint32)


def fold_in(key, data):
    """``jax.random.fold_in``: key ``[..., 2]`` and uint32 ``data``
    (broadcast) to new keys ``[..., 2]``."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(data).astype(np.int64).astype(np.uint32)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], np.uint32(0), data)
    return np.stack([y0, y1], axis=-1)


def key_from_u64(seed: int) -> np.ndarray:
    """Fold a full 64-bit seed into a threefry key (reference seeds.py:61-65)."""
    lo = seed & 0xFFFFFFFF
    hi = (seed >> 32) & 0xFFFFFFFF
    return fold_in(PRNGKey(lo), hi)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` under partitionable threefry: key ``[..., 2]`` to
    ``[..., num, 2]``, key ``i`` being ``threefry(key, (0, i))``."""
    key = np.asarray(key, np.uint32)
    i = np.arange(num, dtype=np.uint32)
    y0, y1 = threefry2x32(key[..., None, 0], key[..., None, 1], np.uint32(0), i)
    return np.stack([y0, y1], axis=-1)


def random_bits(key, shape=()) -> np.ndarray:
    """32-bit ``jax.random.bits`` under partitionable threefry: element ``i``
    (row-major) is ``y0 ^ y1`` of ``threefry(key, (0, i))``.  Key ``[..., 2]``
    gives uint32 ``[..., *shape]``."""
    key = np.asarray(key, np.uint32)
    shape = tuple(shape)
    i = np.arange(int(np.prod(shape)), dtype=np.uint32)
    y0, y1 = threefry2x32(key[..., None, 0], key[..., None, 1], np.uint32(0), i)
    return (y0 ^ y1).reshape(key.shape[:-1] + shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """int32 ``jax.random.randint(key, shape, minval, maxval)`` for bounds in
    the int32 range: two words of bits per value folded into the span with
    jax's uint32 arithmetic, wrap-around included (jax/_src/random.py
    ``_randint``)."""
    if not -(2**31) <= minval < maxval <= 2**31 - 1:
        raise ValueError("randint bounds must satisfy int32 min <= lo < hi <= max")
    k = split(key)
    hi = random_bits(k[..., 0, :], shape).astype(np.uint64)
    lo = random_bits(k[..., 1, :], shape).astype(np.uint64)
    span = np.uint64(maxval - minval)
    mult = (np.uint64(1 << 16) % span) ** 2 & np.uint64(_M32)
    mult = mult % span
    off = ((hi % span) * mult & np.uint64(_M32)) + lo % span
    off = (off & np.uint64(_M32)) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def uniform(key, shape=()) -> np.ndarray:
    """f32 ``jax.random.uniform(key, shape)``: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    return ((bits >> np.uint32(9)).astype(np.float32)
            * np.float32(2.0**-23))


def _counter_keys(base_keys, counter: int, n: int, phase: int) -> np.ndarray:
    """uint32 ``[n, d, 2]``: ``fold_in(fold_in(key, counter + t), phase)``."""
    keys = np.asarray(base_keys, np.uint32)  # [d, 2]
    ctr = (np.int64(counter) + np.arange(n, dtype=np.int64))[:, None]  # [n, 1]
    return fold_in(fold_in(keys[None], ctr), phase)


def sweep_words(base_keys, counter: int, n: int, phase: int) -> np.ndarray:
    """Per-(sweep, realization) key words of a chunk.

    ``fold_in(fold_in(key, counter + t), phase)`` for ``t < n``
    (peapods_tpu/engine/loop.py:2986-2998), as int32 ``[n, d, 2]`` — the two
    words the reference hands to ``prng_seed`` (sweep phase) or to its PT
    scalar mixer (PT phase).
    """
    return _counter_keys(base_keys, counter, n, phase).view(np.int32)


def fk_keys(base_keys, counters, n_systems: int):
    """The FK phase's per-graph keys for the sweeps at ``counters``.

    Per realization key ``k`` and system ``s``:
    ``kb, kf = split(split(fold_in(fold_in(k, ctr), PH_FK), S)[s])``
    (peapods_tpu/engine/loop.py:2009-2014).  Returns uint32 ``(kb, kf)``,
    each ``[len(counters), d * S, 2]`` in the flat disorder-major graph
    order.  ``kb`` keys the bond uniforms; ``kf`` feeds :func:`fk_scalars`.
    """
    keys = np.asarray(base_keys, np.uint32)
    ctr = np.asarray(counters, np.int64)[:, None]
    k = fold_in(fold_in(keys[None], ctr), PH_FK)  # [m, d, 2]
    pair = split(split(k, n_systems))  # [m, d, S, 2, 2]
    m = pair.shape[0]
    return (pair[..., 0, :].reshape(m, -1, 2),
            pair[..., 1, :].reshape(m, -1, 2))


def fk_scalars(kf, n_spins: int, *, wolff: bool) -> np.ndarray:
    """int32 ``[..., 3]`` per-graph ``(salt0, salt1, seed)`` from the ``kf``
    keys, bitwise ``pallas_event.fk_scalars`` (:555-575): the SW coin salts
    ``randint(kf, (2,), -2**31, 2**31 - 1)`` (``cluster.coin_salt``) or the
    Wolff seed ``randint(kf, (), 0, n_spins)``; the unused fields are 0."""
    kf = np.asarray(kf, np.uint32)
    out = np.zeros(kf.shape[:-1] + (3,), np.int32)
    if wolff:
        out[..., 2] = randint(kf, (), 0, n_spins)
    else:
        out[..., :2] = randint(kf, (2,), -(2**31), 2**31 - 1)
    return out


def pt_draws_jnp(base_keys, counter: int, n: int, n_edges: int, *,
                 pt_full: bool):
    """The jnp-form PT draws of ``n`` sweeps from ``counter`` on
    (peapods_tpu/ops/tempering.py:81-149), one replica per ladder.

    With ``k = fold_in(fold_in(key, ctr), PH_PT)``: single edge
    ``k_edge, k_u = split(k)``, ``edge = randint(k_edge, (1,), 0,
    n_edges)``, ``u = uniform(k_u, (1,))`` -> ``(edge int32 [n, d], u f32
    [n, d])``; full ladder ``u[i] = uniform(fold_in(k, i), (1, n_edges))``
    for the two parity passes ``i`` -> f32 ``[n, d, 2, n_edges]``.
    """
    k = _counter_keys(base_keys, counter, n, PH_PT)  # [n, d, 2]
    if pt_full:
        return np.stack(
            [uniform(fold_in(k, i), (n_edges,)) for i in (0, 1)], axis=-2
        )
    kk = split(k)
    return (randint(kk[..., 0, :], (), 0, n_edges),
            uniform(kk[..., 1, :], ()))


def initial_spins(base_keys, n_systems: int, n_spins: int) -> np.ndarray:
    """int8 ``[d, n_systems, n_spins]`` initial spins, bitwise
    ``where(bernoulli(fold_in(key, 0x5EED), 0.5, shape), 1, -1)``
    (peapods_tpu/engine/simulation.py:179-187).

    With partitionable threefry, element ``i`` draws
    ``bits = y0 ^ y1`` of ``threefry(key, (0, i))``; the float
    ``(bits >> 9) * 2**-23`` lies below 1/2 iff the top bit is clear.
    """
    keys = fold_in(np.asarray(base_keys, np.uint32), INIT_DOMAIN)  # [d, 2]
    idx = np.arange(n_systems * n_spins, dtype=np.uint32)
    y0, y1 = threefry2x32(
        keys[:, 0, None], keys[:, 1, None], np.uint32(0), idx[None, :]
    )
    below_half = ((y0 ^ y1) >> np.uint32(31)) == 0
    spins = np.where(below_half, np.int8(1), np.int8(-1))
    return spins.reshape(len(keys), n_systems, n_spins)
