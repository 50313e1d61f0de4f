"""Port seeds and RNG: bitwise against the reference's seeds and jax.random.

The port computes the reference's threefry key words in numpy
(peapods_tpu_torch/engine/seeds.py) and draws its site uniforms from
Philox4x32-10 (ops/rng.py).  Everything here must match bit for bit.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.engine import seeds as ref_seeds
from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import rng

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**63 + 12345,
         2**64 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_fanout_matches_reference(seed):
    assert seeds.splitmix64(seed) == ref_seeds.splitmix64(seed)
    for r in (0, 1, 7):
        assert seeds.realization_seed(seed, r) == ref_seeds.realization_seed(
            seed, r
        )
    if seed < 2**63:
        assert seeds.dynamics_seed(seed) == ref_seeds.dynamics_seed(seed)
        a, _ = seeds.seed_material(seed)
        b, _ = ref_seeds.seed_material(seed)
        np.testing.assert_array_equal(a.generate_state(4), b.generate_state(4))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_match_jax(seed):
    got = seeds.key_from_u64(seed)
    want = np.asarray(jax.random.key_data(ref_seeds.key_from_u64(seed)))
    np.testing.assert_array_equal(got, want)
    lo = seed & 0xFFFFFFFF
    np.testing.assert_array_equal(
        seeds.PRNGKey(lo), np.asarray(jax.random.key_data(jax.random.PRNGKey(lo)))
    )
    key = ref_seeds.key_from_u64(seed)
    for data in (0, 1, 0x5EED, 2**31 - 1, 2**32 - 1, np.int32(-3)):
        np.testing.assert_array_equal(
            seeds.fold_in(got, data),
            np.asarray(jax.random.key_data(jax.random.fold_in(key, data))),
        )


@pytest.mark.parametrize("phase", [seeds.PH_SWEEP, seeds.PH_PT])
def test_sweep_words_match_reference(phase):
    """fold_in(fold_in(key, counter + t), phase), bitcast to int32, as the
    reference's mega chunk runner builds them (engine/loop.py:2986-2998)."""
    keys = jnp.stack(
        [ref_seeds.key_from_u64(ref_seeds.realization_seed(9, r)) for r in range(3)]
    )
    ctr, n = 1000, 6

    def per_key(key):
        def per_t(t):
            k = jax.random.fold_in(jax.random.fold_in(key, ctr + t), phase)
            return jax.lax.bitcast_convert_type(
                jax.random.key_data(k).astype(jnp.uint32), jnp.int32
            )

        return jax.vmap(per_t)(jnp.arange(n, dtype=jnp.int32))

    want = np.asarray(jax.vmap(per_key)(keys))  # [d, n, 2]
    got = seeds.sweep_words(np.asarray(jax.random.key_data(keys)), ctr, n, phase)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want.transpose(1, 0, 2))


@pytest.mark.parametrize("shape,n_temps,n_dis", [((8, 8), 4, 1), ((4, 6), 3, 2)])
def test_initial_spins_and_reset_match_reference(shape, n_temps, n_dis):
    coup = np.ones((n_dis,) + shape + (2,), np.float32)
    temps = np.geomspace(1.8, 3.2, n_temps).astype(np.float32)
    ref = RefSimulation(list(shape), coup, temps, 1, None, 77, mesh=None)
    port = IsingSimulation(list(shape), coup, temps, 1, None, 77, device="cpu")
    np.testing.assert_array_equal(
        port.state["spins"].numpy(), np.asarray(ref.state["spins"])
    )
    np.testing.assert_array_equal(
        port.state["base_keys"], np.asarray(jax.random.key_data(ref.state["base_keys"]))
    )
    np.testing.assert_array_equal(
        port.state["pt_trip_state"].numpy(), np.asarray(ref.state["pt_trip_state"])
    )
    np.testing.assert_array_equal(port.get_spins(), ref.get_spins())
    port.sample(3, "metropolis")
    for s in (None, 5):
        ref.reset(s)
        port.reset(s)
        np.testing.assert_array_equal(
            port.state["spins"].numpy(), np.asarray(ref.state["spins"])
        )
        assert int(port.state["counter"]) == int(ref.state["counter"]) == 0


@pytest.mark.parametrize(
    "key,ctr,want",
    [
        ((0, 0), (0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 4,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(key, ctr, want):
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    got = rng.philox4x32(*map(t, key), *map(t, ctr))
    assert tuple(int(x) for x in got) == want


def test_colour_uniforms_layout():
    """Site (r, col) of colour c reads Philox word (r*W/2 + col//2) % 4 of
    counter (slot, c, (r*W/2 + col//2) // 4), top 24 bits."""
    h, w, n_slots = 4, 6, 3
    words = torch.tensor([[123456789, -987654321]], dtype=torch.int32)
    for colour in (0, 1):
        u = rng.colour_uniforms(words, n_slots, colour, (h, w))
        assert u.shape == (1, n_slots, h, w)
        for slot in range(n_slots):
            for r in range(h):
                col = (r + colour) % 2 + 2 * (r % 3 % (w // 2))
                i = r * (w // 2) + col // 2
                out = rng.philox4x32(
                    *(torch.tensor(v & 0xFFFFFFFF, dtype=torch.int64) for v in (
                        123456789, -987654321, slot, colour, i // 4, 0))
                )
                want = (int(out[i % 4]) >> 8) / float(1 << 24)
                assert float(u[0, slot, r, col]) == want


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np\n"
        "import peapods_tpu_torch as P\n"
        "m = P.Ising((4, 4), temperatures=np.array([2.0, 3.0]), seed=1, "
        "device='cpu')\n"
        "m.sample(8, pt_interval=1)\n"
        "m.sample(8, pt_interval=1, cluster_update_interval=1, "
        "cluster_mode='wolff', collect_cluster_stats=True)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', "
        "'peapods_tpu.')) or k == 'peapods_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------- the per-sweep path's keys


def _jkey(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**64 - 1])
def test_split_bits_uniform_randint_match_jax(seed):
    key = seeds.key_from_u64(seed)
    jk = _jkey(key)
    for num in (2, 3, 7):
        np.testing.assert_array_equal(
            seeds.split(key, num),
            np.asarray(jax.random.key_data(jax.random.split(jk, num))))
    for shape in ((), (1,), (5,), (2, 3)):
        np.testing.assert_array_equal(seeds.random_bits(key, shape),
                                      np.asarray(jax.random.bits(jk, shape)))
        np.testing.assert_array_equal(seeds.uniform(key, shape),
                                      np.asarray(jax.random.uniform(jk, shape)))
        # spans below, at and above 2**16 (the multiplier wraps in uint32),
        # and coin_salt's full int32 range
        for lo, hi in ((0, 1), (0, 7), (0, 65536), (0, 65537), (0, 2**20 + 3),
                       (-5, 3), (-(2**31), 2**31 - 1), (0, 2**31 - 1)):
            np.testing.assert_array_equal(
                seeds.randint(key, shape, lo, hi),
                np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32)),
                err_msg=f"{shape} [{lo}, {hi})")


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
def test_fk_keys_and_scalars_match_reference(wolff):
    """kb, kf = split(split(fold_in(fold_in(key, ctr), PH_FK), S)[s])
    (engine/loop.py:2009-2014) and pallas_event.fk_scalars from kf."""
    from peapods_tpu.ops import pallas_event

    d, n_sys, n_spins = 3, 4, 4096
    base = np.stack([seeds.key_from_u64(seeds.realization_seed(11, r))
                     for r in range(d)])
    ctrs = np.array([0, 7, 1000], np.int64)
    kb, kf = seeds.fk_keys(base, ctrs, n_sys)
    assert kb.shape == kf.shape == (len(ctrs), d * n_sys, 2)
    for i, ctr in enumerate(ctrs):
        for r in range(d):
            k = jax.random.fold_in(jax.random.fold_in(_jkey(base[r]), int(ctr)),
                                   seeds.PH_FK)
            pair = jax.vmap(jax.random.split)(jax.random.split(k, n_sys))
            want = np.asarray(jax.random.key_data(pair))  # [S, 2, 2]
            sl = slice(r * n_sys, (r + 1) * n_sys)
            np.testing.assert_array_equal(kb[i, sl], want[:, 0])
            np.testing.assert_array_equal(kf[i, sl], want[:, 1])
    got = seeds.fk_scalars(kf, n_spins, wolff=wolff)
    want = np.asarray(pallas_event.fk_scalars(
        wolff, _jkey(kf.reshape(-1, 2)), n_spins))
    np.testing.assert_array_equal(got.reshape(-1, 3), want)


@pytest.mark.parametrize("pt_full", [False, True], ids=["single", "full"])
def test_jnp_pt_draws_match_reference(pt_full):
    """The draws of ops/tempering.py pt_single_random_edge (:135-137) and
    pt_full_ladder (:103-104) with one replica, from
    k = fold_in(fold_in(key, ctr), PH_PT)."""
    d, n, n_edges, ctr = 2, 5, 6, 40
    base = np.stack([seeds.key_from_u64(seeds.realization_seed(3, r))
                     for r in range(d)])
    got = seeds.pt_draws_jnp(base, ctr, n, n_edges, pt_full=pt_full)
    for t in range(n):
        for r in range(d):
            k = jax.random.fold_in(jax.random.fold_in(_jkey(base[r]), ctr + t),
                                   seeds.PH_PT)
            if pt_full:
                for i in range(2):
                    u = jax.random.uniform(jax.random.fold_in(k, i), (1, n_edges))
                    np.testing.assert_array_equal(got[t, r, i], np.asarray(u)[0])
            else:
                k_edge, k_u = jax.random.split(k)
                edge = jax.random.randint(k_edge, (1,), 0, n_edges)
                u = jax.random.uniform(k_u, (1,), dtype=jnp.float32)
                assert got[0][t, r] == int(edge[0])
                assert got[1][t, r] == np.float32(u[0])


def test_bond_uniforms_layout():
    """Bond (site, dir) of a graph reads Philox word site % 4 of key = the
    graph's kb words, counter (dir, site // 4, 0, 0), top 24 bits."""
    words = torch.tensor([[5, -7], [123456789, 42]], dtype=torch.int32)
    n = 10
    u = rng.bond_uniforms(words, n)
    assert u.shape == (2, n, 2)
    for b in range(2):
        for site in range(n):
            for dd in range(2):
                out = rng.philox4x32(*(torch.tensor(v & 0xFFFFFFFF, dtype=torch.int64)
                                       for v in (int(words[b, 0]), int(words[b, 1]),
                                                 dd, site // 4, 0, 0)))
                want = (int(out[site % 4]) >> 8) / float(1 << 24)
                assert float(u[b, site, dd]) == want
