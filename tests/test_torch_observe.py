"""FK observe and the staged FK path of the port, against the JAX package.

* Row 2: ``sweep_2d_plain(measure=True)`` against ``sweep_2d_fused`` in
  interpret mode (zero uniforms): spins, e and m bitwise (+-1 couplings).
* Rows 14 and 15: ``cluster.connected_components``, the function the CC
  kernels reproduce, and the ``cc.cc_labels`` wrapper against
  ``connected_components_batch`` (square, triangular, cubic, offset tables
  through ``cc_gen_offsets``) and ``connected_components_2d`` in interpret
  mode: labels bitwise at densities 0 to 1.
* Row 16: ``winding_flags`` against ``cl.winding_flags`` and
  ``winding_batch`` in interpret mode, and four hand cases: flags equal.
* ``graph_observation`` per graph against the reference's: bitwise.
* The engine under zero uniforms against the JAX engine in interpret mode
  (2D square SW observe with PT at 8x128, the narrowest width whose
  reference sweep is the Pallas kernel): spins and records bitwise, every
  ``cluster_observations["fk"]`` array (integers bitwise, fractions to
  rtol 1e-6: the reference sums them in f32) and ``fk_csd``.
* The results' schema, observe leaving the trajectory alone, the staged
  path bitwise under injected uniforms, exact enumeration, and a z-test
  against the JAX engine on BCC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.ops import cluster as cl
from peapods_tpu.ops import pallas_cc as pcc
from peapods_tpu.ops import pallas_cc_batch as ccb
from peapods_tpu.ops import pallas_sweep as ps
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch import Ising
from peapods_tpu_torch.engine import loop, seeds
from peapods_tpu_torch.engine.config import ClusterUpdate, SimConfig
from peapods_tpu_torch.engine.records import FK_OBS
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import cc, cluster, fk, winding
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops import sweep as tsweep
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
FK_KEYS = ("observation_count", "cluster_size_counts", "top_four_component_fractions",
           "active_bond_density", "large_component_count")
WINDING_KEYS = ("winding_x", "winding_y", "winding_either", "winding_both")


# ------------------------------------------------------------------ row 2


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
def test_sweep_2d_measure_matches_fused_reference(gibbs):
    """Row 2 is sweep_2d's measuring pass: 8x128, 2 realizations x 2
    systems, zero uniforms (temperatures low enough that some proposals are
    refused), three sweeps."""
    h, w, d, n_sys = 8, 128, 2, 2
    rng = np.random.default_rng(31 + gibbs)
    coup = rng.choice([-1.0, 1.0], size=(d, h * w, 2)).astype(np.float32)
    sys_temps = np.array([[0.02, 2.0], [1.5, 0.05]], np.float32)
    spins = rng.choice([-1, 1], size=(d, n_sys, h * w)).astype(np.int8)
    jg_ref = jnp.stack([ps.pack_coupling_grids(jnp.asarray(coup[r]), (h, w))
                        for r in range(d)])
    jg = tsweep.pack_coupling_grids(torch.from_numpy(coup), (h, w))
    np.testing.assert_array_equal(jg.numpy(), np.asarray(jg_ref))
    port = torch.from_numpy(spins.reshape(d, n_sys, h, w).copy())
    ref = jnp.asarray(spins)
    seeds_ref = jnp.zeros((d, 2 * n_sys), jnp.int32)
    zeros = torch.zeros((d, n_sys, 2, h, w))
    for step in range(3):
        ref, e_ref, m_ref = ps.sweep_2d_fused(
            ref, jg_ref, jnp.asarray(sys_temps), seeds_ref, shape=(h, w),
            gibbs=gibbs, interpret=True)
        e_part, m_part = tsweep.sweep_2d_plain(
            port, jg, torch.from_numpy(sys_temps), None, gibbs=gibbs, measure=True,
            uniforms=zeros)
        np.testing.assert_array_equal(port.reshape(d, n_sys, -1).numpy(),
                                      np.asarray(ref), err_msg=f"step {step}")
        np.testing.assert_array_equal(m_part.sum(-1).numpy(), np.asarray(m_ref))
        np.testing.assert_array_equal((e_part.sum(-1) / (h * w)).numpy(),
                                      np.asarray(e_ref))
    # not every proposal was taken: the cold systems kept some spins
    assert (port.reshape(d, n_sys, -1).numpy() == spins).any()


# ----------------------------------------------------------- rows 14, 15


def _ref_labels(lat, active):
    geom = GridOps.from_lattice(lat)
    return np.array(jax.vmap(lambda a: cl.connected_components(a, geom))(
        jnp.asarray(active)))


def _densities(b, n, nb, seed):
    rng = np.random.default_rng(seed)
    dens = np.linspace(0.0, 1.0, b)[:, None, None]
    return rng.random((b, n, nb)) < dens


@pytest.mark.parametrize("shape,offsets", [
    ((8, 128), None), ((8, 24), TRI), ((8, 8, 8), None),
], ids=["square-8x128", "tri-8x24", "cubic-8"])
def test_cc_matches_batch_kernel(shape, offsets):
    lat = RefLattice(list(shape), offsets)
    kp, ks = ccb.cc_batch_factors(lat, 8)
    b = ((8 + kp * ks - 1) // (kp * ks)) * (kp * ks)
    active = _densities(b, lat.n_spins, lat.n_neighbors, 41)
    want = np.asarray(ccb.connected_components_batch(
        jnp.asarray(active), shape=shape, kp=kp, ks=ks, interpret=True,
        tri=offsets is not None))
    np.testing.assert_array_equal(want, _ref_labels(lat, active))
    port_lat = Lattice(shape, offsets)
    got = cluster.connected_components(torch.from_numpy(active), shape,
                                       port_lat.offsets)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cc.cc_labels(torch.from_numpy(active),
                                               port_lat).numpy(), want)


@pytest.mark.parametrize("shape,offsets", [
    ((8, 16), NNN), ((8, 16), [[1, 2], [2, 1]]),
    ((8, 8, 8), [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]]),
], ids=["nnn", "knight", "3d-table"])
def test_cc_matches_batch_kernel_offset_tables(shape, offsets):
    lat = RefLattice(list(shape), offsets)
    offs = ccb.cc_gen_offsets(lat)
    assert offs is not None
    kp, ks = ccb.cc_batch_factors(lat, 8)
    b = ((8 + kp * ks - 1) // (kp * ks)) * (kp * ks)
    active = _densities(b, lat.n_spins, lat.n_neighbors, 43)
    want = np.asarray(ccb.connected_components_batch(
        jnp.asarray(active), shape=shape, kp=kp, ks=ks, interpret=True, offsets=offs))
    np.testing.assert_array_equal(want, _ref_labels(lat, active))
    got = cc.cc_labels(torch.from_numpy(active), Lattice(shape, offsets))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("geometry", ["bcc", "fcc"])
def test_cc_matches_reference_on_bcc_fcc(geometry):
    shape = (4, 4, 8)
    offsets = GEOMETRY_OFFSETS[geometry]
    lat = RefLattice(list(shape), offsets)
    active = _densities(6, lat.n_spins, lat.n_neighbors, 47)
    got = cc.cc_labels(torch.from_numpy(active), Lattice(shape, offsets))
    np.testing.assert_array_equal(got.numpy(), _ref_labels(lat, active))


def test_cc_matches_single_graph_kernel():
    """Row 15: one 2D square graph at a time."""
    shape = (8, 128)
    lat = RefLattice(list(shape))
    active = _densities(4, lat.n_spins, 2, 53)
    want = np.stack([np.asarray(pcc.connected_components_2d(
        jnp.asarray(a), shape=shape, interpret=True)) for a in active])
    np.testing.assert_array_equal(want, _ref_labels(lat, active))
    got = cc.cc_labels(torch.from_numpy(active), Lattice(shape))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ row 16


@pytest.mark.parametrize("shape", [(8, 8), (8, 128), (16, 16)])
def test_winding_matches_reference(shape):
    """Against winding_batch in interpret mode at each shape, and at 8x8
    against the jnp settle loop too (tests/test_cc_batch.py holds the two
    equal at all three shapes; the loop's XLA compile takes ~20 s at the
    larger ones)."""
    lat = RefLattice(list(shape))
    kp, ks = ccb.cc_batch_factors(lat, 12)
    b = ((12 + kp * ks - 1) // (kp * ks)) * (kp * ks)
    rng = np.random.default_rng(61 + shape[1])
    active = rng.random((b, lat.n_spins, 2)) < np.linspace(0.3, 0.75, b)[:, None, None]
    active[0] = False
    active[1] = True
    active[2] = False
    active[2, np.arange(shape[1]), 1] = True  # row 0 wraps along y
    labels = ccb.connected_components_batch(jnp.asarray(active), shape=shape, kp=kp,
                                            ks=ks, interpret=True)
    wx_k, wy_k = ccb.winding_batch(jnp.asarray(active), labels, shape=shape, kp=kp,
                                   ks=ks, interpret=True)
    if shape == (8, 8):
        geom = GridOps.from_lattice(lat)
        wx_j, wy_j = jax.jit(jax.vmap(lambda a, lab: cl.winding_flags(a, lab, geom)))(
            jnp.asarray(active), labels)
        np.testing.assert_array_equal(np.asarray(wx_k), np.asarray(wx_j))
        np.testing.assert_array_equal(np.asarray(wy_k), np.asarray(wy_j))
    a_t = torch.from_numpy(active)
    lab_t = torch.from_numpy(np.array(labels))
    for fn in (cluster.winding_flags, winding.winding_flags):
        wx, wy = fn(a_t, lab_t, shape)
        np.testing.assert_array_equal(wx.numpy(), np.asarray(wx_k))
        np.testing.assert_array_equal(wy.numpy(), np.asarray(wy_k))
    assert wx[1] and wy[1] and not wx[0] and not wy[0]
    assert not wx[2] and wy[2]
    assert 0 < int(wx.sum()) < b  # the densities straddle the transition


def _hand(active):
    lab = cluster.connected_components(torch.from_numpy(active[None]), (4, 4))
    wx, wy = winding.winding_flags(torch.from_numpy(active[None]), lab, (4, 4))
    return bool(wx[0]), bool(wy[0])


def test_winding_hand_cases():
    """tests/test_cluster.py:90-113: full lattice, one column ring, a path
    across the seam, the empty graph."""
    assert _hand(np.ones((16, 2), bool)) == (True, True)
    col = np.zeros((16, 2), bool)
    col[[0, 4, 8, 12], 0] = True
    assert _hand(col) == (True, False)
    seam = np.zeros((16, 2), bool)
    seam[[0, 4, 12], 0] = True
    assert _hand(seam) == (False, False)
    assert _hand(np.zeros((16, 2), bool)) == (False, False)


def test_winding_rejects_labels_of_other_masks():
    active = np.zeros((1, 16, 2), bool)
    labels = torch.zeros((1, 16), dtype=torch.int32)  # one component, no bonds
    with pytest.raises(ValueError, match="unsettled"):
        winding.winding_flags(torch.from_numpy(active), labels, (4, 4))


# ---------------------------------------------------- graph observations


def test_graph_observation_matches_reference():
    """Per graph against cl.graph_observation, the winding flags passed in
    from winding_batch as the reference's engine passes them."""
    shape = (8, 16)
    lat = RefLattice(list(shape))
    geom = GridOps.from_lattice(lat)
    kp, ks = ccb.cc_batch_factors(lat, 10)
    b = ((10 + kp * ks - 1) // (kp * ks)) * (kp * ks)
    active = _densities(b, lat.n_spins, 2, 71)
    active[3] = False  # n components of size 1
    labels = _ref_labels(lat, active)
    wx_k, wy_k = ccb.winding_batch(jnp.asarray(active), jnp.asarray(labels),
                                   shape=shape, kp=kp, ks=ks, interpret=True)
    ref = jax.jit(jax.vmap(lambda a, lab, wx, wy: cl.graph_observation(
        a, cl.component_counts(lab), lab, geom, True, winding_pre=(wx, wy))))(
            jnp.asarray(active), jnp.asarray(labels), wx_k, wy_k)
    lab_t = torch.from_numpy(labels)
    a_t = torch.from_numpy(active)
    got = cluster.graph_observation(a_t, cluster.component_counts(lab_t),
                                    cluster.winding_flags(a_t, lab_t, shape))
    np.testing.assert_array_equal(got.top4.numpy(), np.asarray(ref.top4))
    np.testing.assert_array_equal(got.active_bonds.numpy(), np.asarray(ref.active_bonds))
    np.testing.assert_array_equal(got.large_components.numpy(),
                                  np.asarray(ref.large_components))
    np.testing.assert_array_equal(got.winding_x.numpy(), np.asarray(ref.winding_x))
    np.testing.assert_array_equal(got.winding_y.numpy(), np.asarray(ref.winding_y))
    assert got.top4[3].tolist() == [1, 1, 1, 1]
    # fewer than four components pad with zeros
    one = cluster.graph_observation(torch.ones((1, 16, 2), dtype=torch.bool),
                                    cluster.component_counts(
                                        torch.zeros((1, 16), dtype=torch.int32)))
    assert one.top4.tolist() == [[16, 0, 0, 0]]
    assert one.large_components.tolist() == [1]


# ------------------------------------------------- the engine, bitwise


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
        lambda words, n, n_dirs=2: torch.zeros(words.shape[:-1] + (n, n_dirs)))


def _assert_fk_observations(r_port, r_ref, winding_keys):
    fk_p = r_port["per_disorder"]["cluster_observations"]["fk"]
    fk_r = r_ref["per_disorder"]["cluster_observations"]["fk"]
    assert set(fk_p) == set(fk_r) == set(FK_KEYS + (WINDING_KEYS if winding_keys else ()))
    for key in fk_r:
        assert fk_p[key].dtype == fk_r[key].dtype, key
        assert fk_p[key].shape == fk_r[key].shape, key
        if fk_r[key].dtype == np.uint64:
            np.testing.assert_array_equal(fk_p[key], fk_r[key], err_msg=key)
        else:
            np.testing.assert_allclose(fk_p[key], fk_r[key], rtol=1e-6, err_msg=key)
    np.testing.assert_array_equal(np.asarray(r_port["fk_csd"]), np.asarray(r_ref["fk_csd"]))


@pytest.mark.parametrize("shape,interval,schedule", [
    ((8, 128), 1, "single_random_edge"), ((8, 128), 2, "full_ladder"),
], ids=["8x128", "8x128-interval2-full"])
def test_engine_observe_matches_reference_under_zero_uniforms(zero_uniforms, shape,
                                                              interval, schedule):
    rng = np.random.default_rng(81)
    coup = rng.choice([-1.0, 1.0], size=(2,) + shape + (2,)).astype(np.float32)
    temps = np.array([1.2, 2.0, 2.6], np.float32)
    kw = dict(cluster_update_interval=interval, cluster_mode="sw",
              cluster_action="observe", pt_interval=1, pt_schedule=schedule,
              warmup_ratio=0.25)
    ref = RefSimulation(list(shape), coup, temps, 1, None, 5, mesh=None)
    r_ref = ref.sample(8, "metropolis", **kw)
    port = IsingSimulation(list(shape), coup, temps, 1, None, 5, device="cpu")
    r_port = port.sample(8, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts",
                "pt_edge_acceptances", "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(),
                                      np.asarray(ref.state[key]), err_msg=key)
    for key in ("energies", "energies2", "mags", "mags2", "mags4"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=2e-5, err_msg=key)
    _assert_fk_observations(r_port, r_ref, winding_keys=True)
    assert r_port["per_disorder"]["parallel_tempering"]["edge_acceptances"].sum() > 0


# --------------------------------------------------------------- schema


def test_observe_schema_on_canonical_lattice():
    """tests/test_results_schema.py:99-118: every key with the winding."""
    r = Ising((4, 4), temperatures=np.array([1.5]), seed=5, device="cpu").sample(
        2, cluster_update_interval=1, cluster_mode="sw", cluster_action="observe",
        warmup_ratio=0)
    fk_obs = r["per_disorder"]["cluster_observations"]["fk"]
    assert set(fk_obs) == set(FK_KEYS + WINDING_KEYS)
    assert fk_obs["active_bond_density"].dtype == np.float64
    assert (fk_obs["active_bond_density"] <= 1.0).all()
    assert fk_obs["observation_count"].tolist() == [[2]]
    assert len(r["fk_csd"]) == 1
    assert int((np.arange(17) * r["fk_csd"][0]).sum()) == 2 * 16


def test_observe_schema_without_winding_on_explicit_offsets():
    """tests/test_sampling_interfaces.py:69-91: explicit offsets are not the
    canonical lattice, so the winding keys are absent."""
    model = Ising((4, 4), temperatures=np.array([1.5, 2.5]), n_disorder=2,
                  neighbor_offsets=[[1, 0], [0, 1]], seed=5, device="cpu")
    assert not model._sim.lattice.canonical_square
    assert Lattice((4, 4)).canonical_square and not Lattice((4, 4, 4)).canonical_square
    result = model.sample(2, cluster_update_interval=1, cluster_mode="sw",
                          cluster_action="observe", warmup_ratio=0)
    fk_obs = result["per_disorder"]["cluster_observations"]["fk"]
    assert fk_obs["observation_count"].shape == (2, 2)
    assert fk_obs["observation_count"].dtype == np.uint64
    assert fk_obs["cluster_size_counts"].shape == (2, 2, 17)
    assert fk_obs["cluster_size_counts"].dtype == np.uint64
    assert fk_obs["top_four_component_fractions"].shape == (2, 2, 4)
    assert set(fk_obs) == set(FK_KEYS)


def test_observe_kind_skipped_unless_every_realization_observed():
    """A run whose FK sweeps all fall in the warmup observes nothing: the
    kind is absent (peapods_tpu/engine/results.py:298-302)."""
    model = Ising((4, 4), temperatures=[2.0], seed=5, device="cpu")
    r = model.sample(3, cluster_update_interval=4, cluster_action="observe",
                     warmup_ratio=0.5)
    assert "cluster_observations" not in r.get("per_disorder", {})
    with pytest.raises(ValueError, match="requires cluster_mode='sw'"):
        model.sample(2, cluster_update_interval=1, cluster_mode="wolff",
                     cluster_action="observe")


# ------------------------------------------------- observe mutates nothing


@pytest.mark.parametrize("shape,offsets", [((8, 16), TRI), ((8, 8), NNN)],
                         ids=["tri", "nnn"])
def test_observe_leaves_the_trajectory_alone(shape, offsets):
    def run(**kw):
        m = Ising(shape, couplings="bimodal", temperatures=[2.0, 3.5, 5.0],
                  neighbor_offsets=offsets, seed=13, device="cpu")
        r = m.sample(6, pt_interval=1, warmup_ratio=0, **kw)
        return m, r

    plain, r_plain = run()
    obs, r_obs = run(cluster_update_interval=2, cluster_mode="sw",
                     cluster_action="observe")
    for key in ("spins", "system_ids", "pt_edge_acceptances"):
        assert torch.equal(obs._sim.state[key], plain._sim.state[key]), key
    for key in ("energies", "mags2"):
        np.testing.assert_array_equal(r_obs[key], r_plain[key])
    assert r_obs["per_disorder"]["cluster_observations"]["fk"][
        "observation_count"].tolist() == [[3, 3, 3]]


def test_observe_leaves_the_square_per_sweep_path_alone():
    """On the square a run without a cluster phase takes the mega path, whose
    Philox counter differs: the invariant holds on the per-sweep runner."""
    temps = np.array([1.8, 2.3, 3.0], np.float32)
    coup = np.random.default_rng(3).choice([-1.0, 1.0], size=(8, 16, 2)).astype(
        np.float32)
    states = []
    for c in (None, ClusterUpdate(interval=1, mode="sw", action="observe",
                                  collect_stats=True)):
        sim = IsingSimulation([8, 16], coup, temps, 1, None, 17, device="cpu")
        cfg = SimConfig(n_sweeps=6, cluster_update=c, pt_interval=1)
        acc = loop.init_accumulators(sim.rt, cfg)
        loop.run_chunk_sweeps(sim.rt, cfg, sim.state, acc, 0, 6)
        states.append((sim.state, acc))
    (a, acc_a), (b, acc_b) = states
    for key in ("spins", "system_ids", "pt_edge_acceptances"):
        assert torch.equal(a[key], b[key]), key
    assert torch.equal(acc_a["rec_sums"], acc_b["rec_sums"])
    assert int(acc_b["fk_obs"][..., FK_OBS["count"]].sum()) == 6 * 3


# ----------------------------------------------------------- the staged path


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("shape,offsets", [
    ((4, 4, 8), GEOMETRY_OFFSETS["bcc"]), ((4, 4, 4), GEOMETRY_OFFSETS["fcc"]),
    ((8, 8), NNN),
], ids=["bcc", "fcc", "nnn"])
def test_staged_fk_matches_reference_chain(shape, offsets, wolff):
    """fk_bond_activation(u=) -> connected_components -> coin / Wolff flips
    of the reference against the port's staged plain path with the same
    uniforms and flip keys: bonds, labels and spins bitwise."""
    lat = RefLattice(list(shape), offsets)
    geom = GridOps.from_lattice(lat)
    n, nb = lat.n_spins, lat.n_neighbors
    d, n_rep = 2, 3
    b = d * n_rep
    rng = np.random.default_rng(91 + n + wolff)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(b, n))
    coup = rng.normal(size=(d, n, nb)).astype(np.float32)
    temps = np.linspace(2.0, 9.0, b).astype(np.float32)
    u = rng.random((b, n, nb), dtype=np.float32)
    kf = jax.random.split(jax.random.key(23 + n), b)

    def one(s, cp, t, k, uu):
        act = cl.fk_bond_activation(s, cp, geom, t, k, u=uu)
        lab = cl.connected_components(act, geom)
        if wolff:
            flip = cl.wolff_flip_mask(lab, jax.random.randint(k, (), 0, n))
        else:
            flip = cl.cluster_coin_flip_mask(k, lab)
        return jnp.where(flip, -s, s), lab, act

    ref_s, ref_lab, ref_act = jax.vmap(one)(
        jnp.asarray(spins), jnp.asarray(np.repeat(coup, n_rep, axis=0)),
        jnp.asarray(temps), kf, jnp.asarray(u))
    port_lat = Lattice(shape, offsets)
    port = torch.from_numpy(spins.reshape(b, *shape).copy())
    scal = torch.from_numpy(seeds.fk_scalars(np.asarray(jax.random.key_data(kf)), n,
                                             wolff=wolff))
    labels, masks = fk.fk_staged(port, torch.from_numpy(coup), torch.from_numpy(temps),
                                 scal, None, port_lat, wolff=wolff, with_masks=True,
                                 uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(ref_act))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_lab))
    np.testing.assert_array_equal(port.reshape(b, n).numpy(), np.asarray(ref_s))
    assert (port.reshape(b, n).numpy() != spins).any()
    # observe: the same graphs, the spins untouched
    again = torch.from_numpy(spins.reshape(b, *shape).copy())
    lab_o, masks_o = fk.fk_staged(again, torch.from_numpy(coup), torch.from_numpy(temps),
                                  None, None, port_lat, wolff=False, with_masks=True,
                                  uniforms=torch.from_numpy(u))
    assert torch.equal(lab_o, labels) and torch.equal(masks_o, masks)
    np.testing.assert_array_equal(again.reshape(b, n).numpy(), spins)


def _exact(shape, offsets, T):
    """Exact <E>/N and <m^2> of a ferromagnet by enumeration, bonds from the
    forward table."""
    lat = RefLattice(list(shape), offsets)
    n = lat.n_spins
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    bi = np.repeat(np.arange(n), lat.n_neighbors)
    E = (states[:, bi] * states[:, lat.fwd.reshape(-1)]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    w = np.exp((E - E.max()) / T)
    return (E * w).sum() / w.sum() / n, ((M / n) ** 2 * w).sum() / w.sum()


def test_staged_sw_exact_enumeration_nnn():
    """4x4 next-nearest-neighbour ferromagnet, SW every sweep through the
    staged path: 16 chains of 1500 sweeps against exact enumeration."""
    T = 5.0
    e_ex, m2_ex = _exact((4, 4), NNN, T)
    coup = np.ones((16, 4, 4, 4), np.float32)
    m = IsingSimulation([4, 4], coup, np.array([T], np.float32), 1, NNN, 11,
                        device="cpu")
    r = m.sample(1500, "metropolis", warmup_ratio=0.25, cluster_update_interval=1,
                 cluster_mode="sw")
    assert abs(r["energies"][0] - e_ex) < 0.05, (r["energies"][0], e_ex)
    assert abs(r["mags2"][0] - m2_ex) < 0.06, (r["mags2"][0], m2_ex)


def test_z_test_bcc_observe_against_jax_engine():
    """Batch means per temperature of <E> and of the active-bond density on a
    4x4x4 BCC magnet with SW observe every sweep and PT, 8 consecutive
    sample() calls on each engine: |z| < 4."""
    temps = np.array([5.0, 6.3, 8.0], np.float32)
    kw = dict(cluster_update_interval=1, cluster_mode="sw", cluster_action="observe",
              pt_interval=1, warmup_ratio=0)
    n_batches, n_sweeps = 8, 100
    stats = {}
    for name, model in (
        ("jax", RefIsing((4, 4, 4), geometry="bcc", temperatures=temps, seed=21)),
        ("port", Ising((4, 4, 4), geometry="bcc", temperatures=temps, seed=22,
                       device="cpu")),
    ):
        model.sample(50, pt_interval=1)  # burn-in
        e, dens = [], []
        for _ in range(n_batches):
            r = model.sample(n_sweeps, **kw)
            e.append(model.energies_avg)
            dens.append(r["per_disorder"]["cluster_observations"]["fk"][
                "active_bond_density"][0])
        stats[name] = (np.array(e), np.array(dens))
    for k, label in enumerate(("E", "bond density")):
        a, b = stats["jax"][k], stats["port"][k]
        se = np.sqrt(a.var(0, ddof=1) / n_batches + b.var(0, ddof=1) / n_batches)
        z = (a.mean(0) - b.mean(0)) / se
        assert (np.abs(z) < 4).all(), (label, z)
