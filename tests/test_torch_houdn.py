"""Houdayer(N > 2) and the overlap moves' cluster statistics in the port,
bitwise against the JAX package.

* ``overlap.houdn_plain``, the plain version of ``csrc/overlap.cu``'s
  ``houdn_bonds`` / ``houdn_finish``, against the reference's fused
  ``houdn_event_batch`` (interpret mode, labels with the Wolff marker
  rewritten as the engine does) and its staged ``ov.houdayer_task``, on
  groups of 4 and 6 replicas in 2D and 3D, Wolff and SW: spins of every
  member and labels bitwise.  The Wolff seed is the first of the 64 probes
  whose g spins sum to 0, which a pair-only test cannot tell from ``a !=
  b``.
* ``seeds.overlap_tasks(g=4)`` against the reference's task building
  (``_overlap_branch_slots`` and ``ov.build_tasks``): tasks and task keys.
* The engine with ``houd4`` (8^3, R = 4) and with ``cmr+houd4`` SW and
  ``collect_cluster_stats`` against the reference's engine in interpret
  mode, the port's uniform sources patched to zeros: states, ``overlap2``,
  ``overlap_csd`` and ``top_cluster_sizes`` bitwise (n_spins = 512: every
  sum is a multiple of 2**-18 well inside f32's mantissa, so the
  reference's f32 sums are exact too).
* Statistics: Houdayer(N > 2) accepts every move although it does not keep
  the energy summed over the group (a boundary bond between a balanced and
  an unbalanced site changes it), so it is not Boltzmann-exact and exact
  enumeration cannot hold it (the reference warns so).  A z-test holds the
  port's houd4 chain on a 4x4 +-J glass to the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu.engine.loop import _PH_OVERLAP
from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.ops import overlap as ov
from peapods_tpu.ops import pallas_cc_batch as ccb
from peapods_tpu.ops import pallas_event as pe
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch import Ising
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import overlap
from peapods_tpu_torch.ops import rng as trng

torch.set_num_threads(1)


def _groups(shape, n_tasks, g, seed):
    lat = RefLattice(list(shape))
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1, 1], np.int8), size=(n_tasks, g, lat.n_spins))
    return lat, x, jax.random.split(jax.random.key(seed), n_tasks)


def _fused_houdn(lat, x, tkeys, wolff):
    """The reference's fused Houdayer(N) event in interpret mode (the
    engine's ``_event_fused_houd``, loop.py:2444-2515)."""
    shape = tuple(lat.shape)
    n = lat.n_spins
    b, g = x.shape[:2]
    kp, ks = ccb.cc_batch_factors(lat, b)
    tile = kp * ks
    l0, block = shape[0], n // shape[0]
    gscal = pe.houdn_scalars(wolff, jnp.asarray(x), tkeys, n)
    slots = [jnp.asarray(x[:, i]) for i in range(g)]
    pad = (-b) % tile
    if pad:
        slots = [jnp.concatenate([s, jnp.zeros((pad, n), s.dtype)]) for s in slots]
        gscal = jnp.concatenate([gscal, jnp.zeros((pad, 6), jnp.int32).at[:, 4].set(n)])
    outs = pe.houdn_event_batch(
        tuple(ccb._pack(s, l0, block, kp, ks) for s in slots),
        gscal.reshape((b + pad) // tile, tile, 6), wolff=wolff, shape=shape, kp=kp,
        ks=ks, interpret=True, with_labels=True)
    out = [np.asarray(ccb._unpack(o, l0, block, kp, ks)[:b]) for o in outs]
    labels = out[g]
    if wolff:
        neg = labels == -1
        labels = np.where(neg, np.where(neg, np.arange(n), n).min(-1, keepdims=True),
                          labels)
    return np.stack(out[:g], 1), labels


def _port_houdn(lat, x, tkeys, wolff):
    scal, probes = seeds.event_scalars("houdayer", wolff,
                                       np.asarray(jax.random.key_data(tkeys)),
                                       lat.n_spins)
    got, labels = overlap.houdn_plain(torch.from_numpy(x), torch.from_numpy(scal),
                                      torch.from_numpy(probes), tuple(lat.shape),
                                      wolff=wolff)
    return got.numpy(), labels.numpy()


@pytest.mark.parametrize("g", [4, 6])
@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("shape", [(8, 16), (8, 8, 8)], ids=["2d", "3d"])
def test_houdn_plain_matches_fused_and_staged(shape, wolff, g):
    lat, x, tkeys = _groups(shape, 5, g, 60 + g + len(shape))
    want, want_labels = _fused_houdn(lat, x, tkeys, wolff)
    got, labels = _port_houdn(lat, x, tkeys, wolff)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels, want_labels)
    assert (got != x).any()
    geom = GridOps.from_lattice(lat)
    staged = jax.vmap(lambda ts, k: ov.houdayer_task(
        ts, k, geom, wolff=wolff, update=True, with_winding=False, with_stats=False))(
        jnp.asarray(x), tkeys)
    np.testing.assert_array_equal(got, np.asarray(staged.spins))
    np.testing.assert_array_equal(labels, np.asarray(staged.labels))


@pytest.mark.parametrize("g", [4, 6])
def test_houdn_wolff_seed_is_the_first_balanced_probe(g):
    """Groups where a pair of members differs on sites whose g spins do
    not sum to 0: the seed skips them, as the reference's does."""
    lat = RefLattice([8, 8, 8])
    n = lat.n_spins
    rng = np.random.default_rng(90 + g)
    x = np.ones((6, g, n), np.int8)
    x[:, 0] = rng.choice(np.array([-1, 1], np.int8), size=(6, n))  # a != b ...
    x[:, g // 2:, rng.random(n) < 0.1] *= -1  # ... balanced only here
    tkeys = jax.random.split(jax.random.key(5), 6)
    want, want_labels = _fused_houdn(lat, x, tkeys, True)
    got, labels = _port_houdn(lat, x, tkeys, True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels, want_labels)


def test_overlap_tasks_of_groups_match_jax():
    base = jax.random.split(jax.random.key(11), 2)
    n_rep, n_temps, g = 8, 3, 4
    ctrs = [20, 30]
    tasks, tkeys = seeds.overlap_tasks(np.asarray(jax.random.key_data(base)), ctrs,
                                       n_rep, n_temps, g)
    assert tasks.shape == (2, 2, n_temps, n_rep // g, g)
    sid = jnp.arange(n_rep * n_temps, dtype=jnp.int32).reshape(n_rep, n_temps)
    for i, c in enumerate(ctrs):
        for r in range(2):
            key = jax.random.fold_in(jax.random.fold_in(base[r], c), _PH_OVERLAP)
            k_shuffle, k_tasks = jax.random.split(key)
            perm = jax.vmap(lambda k: jax.random.permutation(k, n_rep))(
                jax.random.split(k_shuffle, n_temps))
            np.testing.assert_array_equal(
                tasks[i, r], np.asarray(perm).reshape(n_temps, n_rep // g, g))
            # ov.build_tasks shuffles the systems of each temperature the same
            # way: replica r at temperature t is system r T + t here
            built = ov.build_tasks(sid, k_shuffle, g)
            np.testing.assert_array_equal(
                np.asarray(built), tasks[i, r] * n_temps + np.arange(n_temps)[:, None, None])
            np.testing.assert_array_equal(
                tkeys[i, r], np.asarray(jax.random.key_data(
                    jax.random.split(k_tasks, n_temps * (n_rep // g)))))


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The reference's interpret mode draws zero site and bond uniforms; the
    port's plain path gets zeros in their place."""
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "colour_uniforms",
        lambda words, n, c, shape: torch.zeros(words.shape[:-1] + (n, *shape)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n, n_dirs=2, first=0: torch.zeros(words.shape[:-1] + (n, n_dirs)))


def _engines(shape, n_rep, kw, n_sweeps=8, seed=5):
    rng = np.random.default_rng(3)
    nd = len(shape)
    coup = rng.choice(np.float32([-1, 1]), size=(2,) + tuple(shape) + (nd,))
    temps = np.geomspace(0.9, 2.2, 3).astype(np.float32)
    ref = RefSimulation(list(shape), coup, temps, n_rep, None, seed, mesh=None)
    r_ref = ref.sample(n_sweeps, "metropolis", **kw)
    prog = next(iter(ref._programs.values()))
    assert prog.megapair and prog.event_kernel  # the kernels this port ports
    port = IsingSimulation(list(shape), coup, temps, n_rep, None, seed, device="cpu")
    r_port = port.sample(n_sweeps, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts", "pt_edge_acceptances",
                "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(),
                                      np.asarray(ref.state[key]), err_msg=key)
    for key in ("overlap", "overlap2", "mags2"):
        np.testing.assert_array_equal(r_port[key], r_ref[key], err_msg=key)
    return r_port, r_ref


@pytest.mark.parametrize("mode", ["wolff", "sw"])
def test_engine_houd4_matches_reference_under_zero_uniforms(zero_uniforms, mode):
    kw = dict(pt_interval=1, overlap_cluster_update_interval=2,
              overlap_cluster_build_mode="houd4", overlap_cluster_mode=mode,
              warmup_ratio=0.25)
    r_port, _ = _engines((8, 8, 8), 4, kw)
    assert "overlap_csd" not in r_port and "top_cluster_sizes" not in r_port


def _assert_stats(r_port, r_ref, n_modes):
    for key in ("overlap_csd", "top_cluster_sizes"):
        assert len(r_port[key]) == len(r_ref[key]) == n_modes, key
    for m in range(n_modes):
        for a, b in zip(r_port["overlap_csd"][m], r_ref["overlap_csd"][m]):
            assert a.dtype == b.dtype == np.uint64
            np.testing.assert_array_equal(a, b)
        a, b = r_port["top_cluster_sizes"][m], r_ref["top_cluster_sizes"][m]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("build,mode", [("cmr+houd4", "sw"), ("houdayer+houd4", "wolff")],
                         ids=["cmr+houd4-sw", "houdayer+houd4-wolff"])
def test_engine_collect_stats_matches_reference(zero_uniforms, build, mode):
    """Mixed group sizes in one chunk: each mode its own tables and its own
    rows of overlap_csd / top4; top_cluster_sizes divides by n_pairs for
    every mode, houd4 included, as the reference does."""
    kw = dict(pt_interval=1, overlap_cluster_update_interval=1,
              overlap_cluster_build_mode=build, overlap_cluster_mode=mode,
              collect_cluster_stats=True, warmup_ratio=0.25)
    r_port, r_ref = _engines((8, 8, 8), 4, kw)
    _assert_stats(r_port, r_ref, 2)
    # every site of every recorded move's graph lies in one cluster
    for m in range(2):
        csd = np.asarray(r_port["overlap_csd"][m]).astype(np.int64)
        assert int((np.arange(513) * csd).sum()) == 3 * 512 * 2 * 3 * (2 // (m + 1))


def test_collect_stats_leaves_the_trajectory_alone():
    def run(**kw):
        m = Ising((8, 8, 8), couplings="bimodal", temperatures=[1.0, 1.5, 2.2],
                  n_replicas=4, seed=9, device="cpu")
        r = m.sample(12, pt_interval=1, overlap_cluster_update_interval=3,
                     overlap_cluster_build_mode="cmr+houd4", overlap_cluster_mode="sw",
                     warmup_ratio=0, **kw)
        return m, r

    plain, r_plain = run()
    stats, r_stats = run(collect_cluster_stats=True)
    for key in ("spins", "system_ids"):
        assert torch.equal(plain._sim.state[key], stats._sim.state[key]), key
    np.testing.assert_array_equal(r_plain["overlap2"], r_stats["overlap2"])
    assert len(stats.top_cluster_sizes) == 2
    assert stats.top_cluster_sizes[1].shape == (3, 4)


@pytest.mark.parametrize("mode", ["wolff", "sw"])
def test_houd4_glass_statistics_match_the_jax_engine(mode):
    """Batch means of <E> and <q^2> per temperature from 8 consecutive
    sample() calls on each engine (the 4x4 +-J glass of the exact tests, R
    = 4, 3 temps, PT and houd4 every sweep): |z| < 4."""
    rng = np.random.default_rng(44)
    J = rng.choice([-1.0, 1.0], size=(4, 4, 2)).astype(np.float32)
    temps = np.array([0.8, 1.3, 2.0], np.float32)
    kw = dict(pt_interval=1, overlap_cluster_update_interval=1,
              overlap_cluster_build_mode="houd4", overlap_cluster_mode=mode,
              warmup_ratio=0)
    stats = {}
    for name, model in (
        ("jax", RefIsing((4, 4), couplings=J, temperatures=temps, n_replicas=4,
                         seed=21)),
        ("port", Ising((4, 4), couplings=J, temperatures=temps, n_replicas=4,
                       seed=22, device="cpu")),
    ):
        model.sample(200, **kw)  # burn-in
        e, q2 = [], []
        for _ in range(8):
            model.sample(250, **kw)
            e.append(model.energies_avg)
            q2.append(model.overlap2)
        stats[name] = (np.array(e), np.array(q2))
    for k, label in enumerate(("E", "q2")):
        a, b = stats["jax"][k], stats["port"][k]
        se = np.sqrt(a.var(0, ddof=1) / 8 + b.var(0, ddof=1) / 8)
        z = (a.mean(0) - b.mean(0)) / se
        assert (np.abs(z) < 4).all(), (label, z)
