"""The lattices of any dimension and extent: odd extents, extent 1, 1D
chains, 4D and up, and more than six offsets, against the JAX package.

* ``Lattice``'s tables and colouring bitwise the reference's ``Lattice``;
* ``sweep_nb_plain`` bitwise ``mc_sweep(uniforms=)`` where no offset is a
  self-bond, and the energies and magnetizations on every lattice; where
  one is (an axis of extent 1), the field leaves it out, the energy keeps
  it (the reference's field counts it: ROADMAP.md section 3);
* the engine bitwise the JAX engine when both draw zero uniforms (the
  reference's jnp path, which draws its sweep and FK uniforms from
  ``jax.random``, given zeros);
* exact enumeration on four lattices, the self-bond chain among them, which
  the reference's field gets wrong;
* ``tests/test_engine_edges.py``'s lattice cases on the port, and a 3^3
  replica glass with Houdayer and with Joerg + CMR against the JAX engine
  by a z-test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import peapods_tpu.engine.loop as ref_loop
from peapods_tpu import Ising as RefIsing
from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.ops import cluster as ref_cluster
from peapods_tpu.ops.energy import energies_and_mags as ref_energies_and_mags
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu.ops.sweep import mc_sweep as ref_mc_sweep
from peapods_tpu_torch import Ising, IsingSimulation
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops import sweep as tsweep
from peapods_tpu_torch.ops.energy import energies_and_mags, measure_nb_plain
from peapods_tpu_torch.ops.lattice import Lattice

torch.set_num_threads(1)

# ten offsets at 4 x 4: [2, 0] and [0, 2] give double bonds (fwd = bwd)
TEN = [[1, 0], [0, 1], [1, 1], [1, -1], [2, 0], [0, 2], [2, 1], [2, -1], [1, 2], [1, -2]]
# the cubic lattice's first three shells: 13 forward offsets, 26 neighbours
SHELLS3 = ([[1, 0, 0], [0, 1, 0], [0, 0, 1]]
           + [[1, s, 0] for s in (1, -1)] + [[1, 0, s] for s in (1, -1)]
           + [[0, 1, s] for s in (1, -1)]
           + [[1, a, b] for a in (1, -1) for b in (1, -1)])
LATTICES = [
    ("3x5", (3, 5), None),
    ("5x5", (5, 5), None),
    ("2x2", (2, 2), None),
    ("1x6", (1, 6), None),
    ("chain8", (8,), None),
    ("chain7", (7,), None),
    ("cubic3", (3, 3, 3), None),
    ("2x3x4x5", (2, 3, 4, 5), None),
    ("4d4", (4, 4, 4, 4), None),
    ("ten4x4", (4, 4), TEN),
    ("shells3", (3, 3, 3), SHELLS3),
]
IDS = [x[0] for x in LATTICES]


@pytest.mark.parametrize("name,shape,offsets", LATTICES, ids=IDS)
def test_tables_and_colours_match_reference(name, shape, offsets):
    ref, port = RefLattice(list(shape), offsets), Lattice(shape, offsets)
    for key in ("fwd", "bwd", "colors"):
        np.testing.assert_array_equal(getattr(port, key), getattr(ref, key), err_msg=key)
    assert port.n_colors == ref.n_colors
    assert port.table == (len(shape) > 3 or port.n_neighbors > 6)
    # the self offsets are those whose neighbour is the site itself
    selfs = (port.fwd == np.arange(port.n_spins)[:, None]).all(0)
    np.testing.assert_array_equal(port.self_bonds, selfs)
    if not port.table:  # the walk form's words: a 1D chain as [1, L]
        assert tuple(port.kernel_geometry[:3]) == (tuple(port.kernel_shape) + (1, 1))[:3]


def _setup(shape, offsets, n_sys, seed):
    ref = RefLattice(list(shape), offsets)
    port = Lattice(shape, offsets)
    nb = ref.n_neighbors
    rng = np.random.default_rng(seed)
    coup = rng.standard_normal((ref.n_spins, nb)).astype(np.float32)
    coup_bwd = coup[ref.bwd, np.arange(nb)[None, :]]
    spins = rng.choice([-1, 1], size=(n_sys, ref.n_spins)).astype(np.int8)
    return ref, port, rng, coup, coup_bwd, spins


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,offsets", LATTICES, ids=IDS)
def test_plain_sweep_matches_mc_sweep(name, shape, offsets, gibbs):
    """Where no offset is a self-bond the plain sweep is bitwise
    ``mc_sweep(uniforms=)``; where one is, the field is the tables' sum over
    the other bonds (the reference's includes ``2 J s_i``)."""
    n_sys = 3
    ref, port, rng, coup, coup_bwd, spins = _setup(shape, offsets, n_sys, 5 + len(name))
    temps = np.array([0.7, 2.5, 9.0], np.float32)
    colours = torch.from_numpy(port.colors.astype(np.uint8))
    if port.self_bonds.any():
        s = torch.from_numpy(spins).to(torch.float32)
        got = tsweep.nb_local_fields(s, torch.from_numpy(coup), torch.from_numpy(coup_bwd),
                                     port).numpy()
        keep = ~port.self_bonds
        sv = spins.astype(np.float64)
        want = ((sv[:, port.fwd] * coup)[..., keep].sum(-1)
                + (sv[:, port.bwd] * coup_bwd)[..., keep].sum(-1))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    geom = GridOps.from_lattice(ref)
    for step in range(2):
        u = rng.random((port.n_colors, n_sys, port.n_spins), dtype=np.float32)
        want = np.asarray(ref_mc_sweep(
            jnp.asarray(spins), jnp.asarray(coup), jnp.asarray(coup_bwd), geom,
            jnp.asarray(ref.color_masks()), jnp.asarray(temps), jax.random.PRNGKey(0),
            gibbs=gibbs, uniforms=jnp.asarray(u)))
        got = torch.from_numpy(spins.copy())[None]
        tsweep.sweep_nb_plain(
            got, torch.from_numpy(coup)[None], torch.from_numpy(coup_bwd)[None], colours,
            torch.from_numpy(temps)[None], None, port, gibbs=gibbs,
            uniforms=torch.from_numpy(u)[None])
        np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f"step {step}")
        spins = want


@pytest.mark.parametrize("name,shape,offsets", LATTICES, ids=IDS)
def test_energies_and_mags_match_reference(name, shape, offsets):
    """Self-bonds count in the energy, as the reference's; +-1 couplings,
    whose sums are exact in any order."""
    ref, port, rng, _, _, spins = _setup(shape, offsets, 4, 31)
    coup = rng.choice([-1.0, 1.0], size=(port.n_spins, port.n_neighbors)).astype(np.float32)
    e_ref, m_ref = ref_energies_and_mags(jnp.asarray(spins), jnp.asarray(coup),
                                         GridOps.from_lattice(ref))
    e, m = energies_and_mags(torch.from_numpy(spins), torch.from_numpy(coup), shape,
                             port.offsets)
    e_part, m_part = measure_nb_plain(torch.from_numpy(spins)[None],
                                      torch.from_numpy(coup)[None], port, blocks=True)
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal((e_part[0].sum(-1) / port.n_spins).numpy(),
                                  np.asarray(e_ref))
    np.testing.assert_array_equal(m_part[0].sum(-1).numpy(), np.asarray(m_ref))


@pytest.fixture
def zero_uniforms(monkeypatch):
    """Both engines draw zero uniforms: the port's sources, and the
    reference's jnp sweep and FK bonds (which would draw from
    ``jax.random``)."""
    monkeypatch.setattr(
        trng, "site_uniforms",
        lambda words, n, c, n_spins: torch.zeros(words.shape[:-1] + (n, n_spins)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n, n_dirs=2: torch.zeros(words.shape[:-1] + (n, n_dirs)))
    sweep, bonds = ref_loop.mc_sweep, ref_cluster.fk_bond_activation

    def zero_sweep(spins, coup, coup_bwd, geom, masks, temps, key, *, gibbs):
        u = jnp.zeros((masks.shape[0],) + spins.shape, jnp.float32)
        return sweep(spins, coup, coup_bwd, geom, masks, temps, key, gibbs=gibbs,
                     uniforms=u)

    def zero_bonds(spins, coup, geom, temp, key, **kw):
        return bonds(spins, coup, geom, temp, key,
                     u=jnp.zeros(spins.shape + (geom.n_neighbors,), jnp.float32), **kw)

    monkeypatch.setattr(ref_loop, "mc_sweep", zero_sweep)
    monkeypatch.setattr(ref_cluster, "fk_bond_activation", zero_bonds)


@pytest.mark.parametrize(
    "shape,n_temps,kw",
    [((5, 5), 4, dict(pt_interval=1)),
     ((3, 3, 3), 4, dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1,
                         collect_cluster_stats=True)),
     ((8,), 3, dict(cluster_update_interval=1, cluster_mode="wolff", pt_interval=1)),
     ((5, 7), 2, dict(cluster_update_interval=1, cluster_action="observe"))],
    ids=["5x5-pt", "cubic3-sw-pt", "chain8-wolff", "5x7-observe-winding"],
)
def test_engine_matches_reference_under_zero_uniforms(zero_uniforms, shape, n_temps, kw):
    nb = len(shape)
    rng = np.random.default_rng(8)
    coup = rng.choice([-1.0, 1.0], size=(2,) + shape + (nb,)).astype(np.float32)
    temps = np.geomspace(1.5, 4.4, n_temps).astype(np.float32)
    kw = dict(kw, warmup_ratio=0.25)
    ref = RefSimulation(list(shape), coup, temps, 1, None, 5, mesh=None)
    r_ref = ref.sample(8, "metropolis", **kw)
    port = IsingSimulation(list(shape), coup, temps, 1, None, 5, device="cpu")
    r_port = port.sample(8, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts", "pt_edge_acceptances",
                "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(), np.asarray(ref.state[key]),
                                      err_msg=key)
    if "fk_csd" in r_ref:
        np.testing.assert_array_equal(np.asarray(r_port["fk_csd"]),
                                      np.asarray(r_ref["fk_csd"]))
    for key in ("energies", "energies2", "mags", "mags2", "mags4"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=2e-5, atol=1e-7, err_msg=key)
    # FK observe on an odd canonical square: the observations, winding too
    ref_obs = r_ref.get("per_disorder", {}).get("cluster_observations", {})
    port_obs = r_port.get("per_disorder", {}).get("cluster_observations", {})
    assert sorted(port_obs) == sorted(ref_obs)
    for kind in ref_obs:
        assert sorted(port_obs[kind]) == sorted(ref_obs[kind]), kind
        for key in ref_obs[kind]:
            np.testing.assert_allclose(port_obs[kind][key], ref_obs[kind][key], rtol=1e-6,
                                       err_msg=f"{kind} {key}")


def _exact(shape, offsets, T):
    """Exact <E>/N and <m^2> of a ferromagnet by enumeration, bonds from
    the forward table: double bonds count twice, a self-bond adds its
    constant J."""
    lat = RefLattice(list(shape), offsets)
    n = lat.n_spins
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    bi = np.repeat(np.arange(n), lat.n_neighbors)
    E = (states[:, bi] * states[:, lat.fwd.reshape(-1)]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    w = np.exp((E - E.max()) / T)
    return (E * w).sum() / w.sum() / n, ((M / n) ** 2 * w).sum() / w.sum()


EXACT = [
    ("3x5-metropolis", (3, 5), None, 2.5, {}),
    ("1x6-metropolis", (1, 6), None, 2.0, {}),
    ("4d2-sw", (2, 2, 2, 2), None, 6.0, dict(cluster_update_interval=1, cluster_mode="sw")),
    ("ten4x4-metropolis", (4, 4), TEN, 30.0, {}),
]


@pytest.mark.parametrize("name,shape,offsets,T,kw", EXACT, ids=[x[0] for x in EXACT])
def test_exact_enumeration(name, shape, offsets, T, kw):
    """64 chains (realizations of one ferromagnet) of 200 sweeps: <e> within
    0.05 and <m^2> within 0.06 of exact enumeration.  The (1, 6) magnet's
    axis of extent 1 makes a self-bond a site: the reference's field adds
    2 J s_i to it and samples (1, 4) at T = 2 at <e> 1.898 against 1.536."""
    e_ex, m2_ex = _exact(shape, offsets, T)
    coup = np.ones((64,) + shape + (len(offsets or shape),), np.float32)
    m = IsingSimulation(list(shape), coup, np.array([T], np.float32), 1, offsets, 11,
                        device="cpu")
    r = m.sample(200, "metropolis", warmup_ratio=0.25, **kw)
    assert abs(r["energies"][0] - e_ex) < 0.05, (r["energies"][0], e_ex)
    assert abs(r["mags2"][0] - m2_ex) < 0.06, (r["mags2"][0], m2_ex)


def test_engine_edges_lattice_cases():
    """``tests/test_engine_edges.py``'s lattice cases on the port: a 1D chain,
    3^3 with SW, 5 x 5 with at least three colours."""
    Ising((8,), temperatures=np.array([1.0]), seed=1, device="cpu").sample(
        2, warmup_ratio=0)
    Ising((3, 3, 3), temperatures=np.array([3.0]), seed=1, device="cpu").sample(
        2, cluster_update_interval=1, warmup_ratio=0)
    m = Ising((5, 5), temperatures=np.array([2.0]), seed=2, device="cpu")
    assert m._sim.lattice.n_colors >= 3
    m.sample(2, warmup_ratio=0)


@pytest.mark.parametrize("build", ["houdayer", "jorg+cmr"])
def test_z_test_cubic3_glass_against_jax_engine(build):
    """Batch means of <E>, <m^2> and <q^2> per temperature from 10
    consecutive sample() calls of 25 sweeps on each engine (one 3^3 +-J glass, R = 2, the
    move (Wolff) every sweep and PT; the reference's jnp path): |z| < 4."""
    temps = np.array([1.2, 2.0, 3.5], np.float32)
    kw = dict(pt_interval=1, overlap_cluster_update_interval=1,
              overlap_cluster_build_mode=build, overlap_cluster_mode="wolff",
              warmup_ratio=0)
    J = np.random.default_rng(70).choice([-1.0, 1.0], size=(3, 3, 3, 3)).astype(np.float32)
    stats = {}
    for name, make in (("jax", RefIsing), ("port", Ising)):
        extra = {} if name == "jax" else dict(device="cpu")
        model = make((3, 3, 3), couplings=J, temperatures=temps, n_replicas=2,
                     seed=71 if name == "jax" else 72, **extra)
        model.sample(30, **kw)  # burn-in
        rows = []
        for _ in range(10):
            r = model.sample(25, **kw)
            rows.append((r["energies"], r["mags2"], r["overlap2"]))
        stats[name] = np.array(rows)  # [10, 3, T]
    for k, label in enumerate(("E", "m2", "q2")):
        a, b = stats["jax"][:, k], stats["port"][:, k]
        se = np.sqrt(a.var(0, ddof=1) / 10 + b.var(0, ddof=1) / 10)
        z = (a.mean(0) - b.mean(0)) / np.maximum(se, 1e-12)
        assert (np.abs(z) < 4).all(), (label, z)
