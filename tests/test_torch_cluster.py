"""The port's FK cluster update and per-sweep engine, bitwise against the
JAX package.

``fk_update_plain`` (peapods_tpu_torch/ops/fk.py) is fed the same per-bond
uniforms as the reference's staged chain (``fk_bond_activation(u=) ->
connected_components -> coin / Wolff flips``, the pattern of
tests/test_pallas_event.py) and as its fused kernel ``fk_update_batch(u=,
interpret=True)``; the flip scalars come from the same ``kf`` keys.  Spins,
labels and m must be equal; e agrees to rtol 2e-5, atol 1e-6, because the
TPU kernel adds its energies in another order.

The engine test runs the reference's per-sweep path in interpret mode,
where the sweep kernel and the FK kernel draw zero uniforms, against the
port's plain path with its uniform sources replaced by zeros: the whole
order sweep -> FK -> measure -> PT with the reference's keys, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.ops import cluster as cl
from peapods_tpu.ops import pallas_cc_batch as ccb
from peapods_tpu.ops import pallas_event as pe
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import cluster, fk
from peapods_tpu_torch.ops import rng as trng

torch.set_num_threads(1)


def _fused_reference(lat, spins, kf, temps, coup, u, wolff, n_rep):
    """The reference's fused FK kernel in interpret mode on a flat graph
    batch (graph b at realization b // n_rep): spins, e, m and labels with
    the Wolff marker rewritten as the engine does (loop.py:2107-2116)."""
    shape = tuple(lat.shape)
    n, nd = lat.n_spins, lat.n_neighbors
    b = spins.shape[0]
    kp, ks = ccb.cc_batch_factors(lat, b)
    tile = kp * ks
    l0, block = shape[0], n // shape[0]
    gscal = pe.fk_scalars(wolff, kf, n)
    gtemp = temps[:, None]
    pad = (-b) % tile
    if pad:
        zrow = lambda x: jnp.zeros((pad,) + x.shape[1:], x.dtype)  # noqa: E731
        spins, gscal, u = (jnp.concatenate([x, zrow(x)]) for x in (spins, gscal, u))
        gtemp = jnp.concatenate([gtemp, jnp.ones((pad, 1), jnp.float32)])
    g = (b + pad) // tile
    out, e, m, labels = pe.fk_update_batch(
        ccb._pack(spins, l0, block, kp, ks), gscal.reshape(g, tile, 3),
        gtemp.reshape(g, tile, 1), jnp.zeros((g, 1, 2), jnp.int32),
        pe.pack_fk_j(coup, n_rep, shape, kp, ks),
        jnp.stack([ccb._pack(u[..., k], l0, block, kp, ks) for k in range(nd)],
                  axis=1),
        wolff=wolff, shape=shape, kp=kp, ks=ks, interpret=True,
        with_measure=True, with_labels=True,
    )
    labels = np.asarray(ccb._unpack(labels, l0, block, kp, ks)[:b])
    if wolff:
        neg = labels == -1
        mn = np.where(neg, np.arange(n), n).min(-1, keepdims=True)
        labels = np.where(neg, mn, labels)
    return (np.asarray(ccb._unpack(out, l0, block, kp, ks)[:b]),
            np.asarray(e).reshape(-1)[:b], np.asarray(m).reshape(-1)[:b], labels)


@pytest.mark.parametrize("shape", [(8, 16), (16, 16)])
@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
def test_fk_update_plain_matches_reference(shape, wolff):
    h, w = shape
    lat = RefLattice([h, w])
    geom = GridOps.from_lattice(lat)
    n = lat.n_spins
    d, n_rep = 2, 3
    b = d * n_rep
    rng = np.random.default_rng(5 + h + 2 * wolff)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(b, n))
    coup = rng.normal(size=(d, n, 2)).astype(np.float32)
    temps = np.linspace(0.9, 2.4, b).astype(np.float32)
    u = rng.random((b, n, 2), dtype=np.float32)
    kf = jax.random.split(jax.random.key(17 + h), b)
    kf_words = np.asarray(jax.random.key_data(kf))

    def staged_one(s, cp, t, k, uu):
        active = cl.fk_bond_activation(s, cp, geom, t, k, u=uu)
        labels = cl.connected_components(active, geom)
        if wolff:
            flip = cl.wolff_flip_mask(labels, jax.random.randint(k, (), 0, n))
        else:
            flip = cl.cluster_coin_flip_mask(k, labels)
        return jnp.where(flip, -s, s), labels

    coup_g = jnp.asarray(np.repeat(coup, n_rep, axis=0))
    staged, staged_labels = jax.vmap(staged_one)(
        jnp.asarray(spins), coup_g, jnp.asarray(temps), kf, jnp.asarray(u))
    fused, e_ref, m_ref, fused_labels = _fused_reference(
        lat, jnp.asarray(spins), kf, jnp.asarray(temps), jnp.asarray(coup),
        jnp.asarray(u), wolff, n_rep)
    np.testing.assert_array_equal(np.asarray(staged), fused)
    np.testing.assert_array_equal(np.asarray(staged_labels), fused_labels)

    port = torch.from_numpy(spins.reshape(b, h, w).copy())
    e_part, m_part, labels = fk.fk_update_plain(
        port, torch.from_numpy(coup), torch.from_numpy(temps),
        torch.from_numpy(seeds.fk_scalars(kf_words, n, wolff=wolff)),
        None, wolff=wolff, with_measure=True, with_labels=True,
        uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(port.reshape(b, n).numpy(), fused)
    np.testing.assert_array_equal(labels.reshape(b, n).numpy(), fused_labels)
    e, m = fk.fk_energy_mag(e_part, m_part, n)
    np.testing.assert_array_equal(m.numpy(), m_ref)
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=2e-5, atol=1e-6)
    assert int(m_part.sum()) == int(port.to(torch.int32).sum())
    # the update did something: some clusters flipped, some bonds joined
    assert (port.reshape(b, n).numpy() != spins).any()
    assert (labels.reshape(b, n).numpy() != np.arange(n)).any()


def test_connected_components_against_union_find():
    """Min-site-index labels against a sequential union-find on random bond
    graphs from sparse to percolating."""
    h, w = 6, 10
    n = h * w
    rng = np.random.default_rng(9)
    for p in (0.1, 0.45, 0.9):
        active = rng.random((4, n, 2)) < p
        got = cluster.connected_components(torch.from_numpy(active), (h, w))
        for g in range(4):
            parent = list(range(n))

            def find(x):
                while parent[x] != x:
                    x = parent[x]
                return x

            for i in range(n):
                r, c = divmod(i, w)
                for k, j in enumerate((((r + 1) % h) * w + c, r * w + (c + 1) % w)):
                    if active[g, i, k]:
                        a, bb = find(i), find(j)
                        parent[max(a, bb)] = min(a, bb)
            want = [find(i) for i in range(n)]
            assert got[g].tolist() == want


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The reference's interpret mode draws zero uniforms in its sweep and FK
    kernels; the port's plain path gets zeros in their place."""
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "colour_uniforms",
        lambda words, n, c, shape: torch.zeros(words.shape[:-1] + (n, *shape)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n: torch.zeros(words.shape[:-1] + (n, 2)))


@pytest.mark.parametrize(
    "mode,interval,schedule",
    [("sw", 1, "single_random_edge"), ("wolff", 1, "single_random_edge"),
     ("sw", 2, "full_ladder")],
    ids=["sw", "wolff", "sw-interval2-full"],
)
def test_engine_matches_reference_under_zero_uniforms(zero_uniforms, mode,
                                                      interval, schedule):
    coup = np.ones((2, 8, 128, 2), np.float32)
    temps = np.array([2.0, 2.6], np.float32)
    kw = dict(cluster_update_interval=interval, cluster_mode=mode,
              pt_interval=1, pt_schedule=schedule, collect_cluster_stats=True,
              warmup_ratio=0.25)
    ref = RefSimulation([8, 128], coup, temps, 1, None, 5, mesh=None)
    r_ref = ref.sample(8, "metropolis", **kw)
    port = IsingSimulation([8, 128], coup, temps, 1, None, 5, device="cpu")
    r_port = port.sample(8, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts",
                "pt_edge_acceptances", "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(),
                                      np.asarray(ref.state[key]), err_msg=key)
    assert int(port.state["counter"]) == int(ref.state["counter"]) == 8
    np.testing.assert_array_equal(np.asarray(r_port["fk_csd"]),
                                  np.asarray(r_ref["fk_csd"]))
    for key in ("energies", "energies2", "mags", "mags2", "mags4"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=2e-5,
                                   err_msg=key)
    assert r_port["per_disorder"]["parallel_tempering"]["edge_acceptances"].sum() > 0
