"""The port's per-sweep path on the coloured lattices, against the JAX
package.

The plain versions of ``csrc/sweep_nb.cu`` (``sweep_nb_plain``,
``measure_nb_plain``) and of the three-direction FK kernels are fed the
same numpy inputs and uniforms as

* ``mc_sweep(uniforms=)`` on every geometry (Metropolis and Gibbs; +-1
  couplings bitwise, gaussian couplings bitwise apart from counted ``exp``
  / ``log`` ulp ties, none expected at these sizes);
* the Pallas injected twins of rows 8, 10, 11 and 12 in interpret mode
  (+-1 couplings, where every field is an exact integer whatever the
  order of its adds);
* ``energies_and_mags`` (bitwise for +-1 couplings, within 1e-6 sum |J|
  for gaussian ones: the order of the f32 adds differs);
* ``fk_update_batch(u=, tri=True | 3D, interpret=True)``: spins, labels and
  m equal, e to rtol 2e-5 (the TPU kernel adds in another order).

The engine runs bitwise the JAX engine in interpret mode, where every
kernel draws zero uniforms, with the port's uniform sources patched to
zeros.  Then physics: exact enumeration on tiny lattices (the oracle and
tolerances of tests/test_exact_equilibrium.py), a z-test against the JAX
engine's jnp path, and the options the port does not run yet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from peapods_tpu import Ising as RefIsing
from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.ops import pallas_cc_batch as ccb
from peapods_tpu.ops import pallas_event as pe
from peapods_tpu.ops import pallas_sweep as ps
from peapods_tpu.ops import pallas_sweep3d as ps3
from peapods_tpu.ops import pallas_sweep_diag as psd
from peapods_tpu.ops import pallas_sweep_tri as pst
from peapods_tpu.ops.energy import energies_and_mags as ref_energies_and_mags
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu.ops.sweep import mc_sweep as ref_mc_sweep
from peapods_tpu_torch import Ising, IsingSimulation
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.ops import fk
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops import sweep as tsweep
from peapods_tpu_torch.ops.energy import energies_and_mags, measure_nb_plain
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
GEOMETRIES = [
    ("tri", (8, 16), TRI),
    ("bcc", (4, 4, 8), GEOMETRY_OFFSETS["bcc"]),
    ("fcc", (4, 4, 4), GEOMETRY_OFFSETS["fcc"]),
    ("cubic", (4, 4, 6), None),
    ("nnn", (8, 8), NNN),
    ("bcc-2", (2, 2, 4), GEOMETRY_OFFSETS["bcc"]),
    ("nnn-2", (2, 8), NNN),
]
GEO_IDS = [g[0] for g in GEOMETRIES]


def _setup(shape, offsets, n_sys, seed, couplings="pm"):
    """Both packages' lattices, +-1 or gaussian forward couplings and their
    backward twins, random spins."""
    ref = RefLattice(list(shape), offsets)
    port = Lattice(shape, offsets)
    nb = ref.n_neighbors
    rng = np.random.default_rng(seed)
    if couplings == "pm":
        coup = rng.choice([-1.0, 1.0], size=(ref.n_spins, nb)).astype(np.float32)
    else:
        coup = rng.standard_normal((ref.n_spins, nb)).astype(np.float32)
    coup_bwd = coup[ref.bwd, np.arange(nb)[None, :]]
    spins = rng.choice([-1, 1], size=(n_sys, ref.n_spins)).astype(np.int8)
    return ref, port, rng, coup, coup_bwd, spins


def _ties(port, spins, coup, coup_bwd, temps, u, gibbs):
    """bool [n_sys, n]: sites whose decision lies within 4 ulp of its
    threshold in some colour pass, on the port's own trajectory."""
    s8 = torch.from_numpy(spins)
    cf, cb = torch.from_numpy(coup), torch.from_numpy(coup_bwd)
    t = torch.from_numpy(temps)[:, None]
    masks = torch.from_numpy(port.color_masks())
    tie = torch.zeros(s8.shape, dtype=torch.bool)
    for c in range(port.n_colors):
        s = s8.to(torch.float32)
        eng = -s * tsweep.nb_local_fields(s, cf, cb, port)
        uc = torch.from_numpy(u[c])
        if gibbs:
            a, b = eng, (t * 0.5) * torch.log(uc / (1.0 - uc))
        else:
            a = uc
            b = tsweep.acceptance(eng * (1.0 / (t * 0.5)), gibbs=False)
        ulp = (torch.nextafter(b, torch.tensor(np.inf)) - b).abs()
        tie |= ((a - b).abs() <= 4 * ulp) & masks[c]
        flip = (a >= b) if gibbs else (a < b)
        s8 = torch.where(flip & masks[c], -s8, s8)
    return tie.numpy()


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,offsets", GEOMETRIES, ids=GEO_IDS)
def test_plain_sweep_matches_mc_sweep(name, shape, offsets, gibbs, couplings):
    n_sys = 3
    ref, port, rng, coup, coup_bwd, spins = _setup(shape, offsets, n_sys,
                                                   3 + len(name), couplings)
    temps = np.array([1.5, 3.6, 8.0], np.float32)
    geom = GridOps.from_lattice(ref)
    colours = torch.from_numpy(port.colors.astype(np.uint8))
    for step in range(3):
        u = rng.random((port.n_colors, n_sys, port.n_spins), dtype=np.float32)
        want = np.asarray(ref_mc_sweep(
            jnp.asarray(spins), jnp.asarray(coup), jnp.asarray(coup_bwd), geom,
            jnp.asarray(ref.color_masks()), jnp.asarray(temps),
            jax.random.PRNGKey(0), gibbs=gibbs, uniforms=jnp.asarray(u)))
        got = torch.from_numpy(spins.copy())[None]
        tsweep.sweep_nb_plain(
            got, torch.from_numpy(coup)[None], torch.from_numpy(coup_bwd)[None],
            colours, torch.from_numpy(temps)[None], None, port, gibbs=gibbs,
            uniforms=torch.from_numpy(u)[None])
        got = got[0].numpy()
        if couplings == "pm":
            np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        else:
            ties = _ties(port, spins, coup, coup_bwd, temps, u, gibbs)
            assert not ((got != want) & ~ties).any(), f"step {step}"
            assert ties.sum() == 0, f"step {step}: {ties.sum()} ulp ties"
        assert (got != spins).any()
        spins = want


def _pallas_twin(kind, ref, coup, spins, temps, u, gibbs):
    """The Pallas injected twin of a geometry in interpret mode."""
    shape = ref.shape
    n_sys = spins.shape[0]
    cj, sj, tj = jnp.asarray(coup), jnp.asarray(spins), jnp.asarray(temps)
    nc = u.shape[0]
    with pltpu.force_tpu_interpret_mode():
        if kind == "tri":
            jg = pst.pack_coupling_grids_tri(cj, shape)
            u_pl = jnp.swapaxes(jnp.asarray(u), 0, 1).reshape(n_sys, nc, *shape)
            return pst.sweep_tri_injected(sj, jg, tj, u_pl, shape=shape, gibbs=gibbs)
        if kind == "tri-packed":
            k = 128 // shape[1]
            jg = pst.pack_coupling_grids_tri_packed(cj, shape, k)
            u_pk = jnp.stack([ps.pack_spins(jnp.asarray(u[c]), shape, k)
                              for c in range(nc)], axis=1)
            return pst.sweep_tri_packed_injected(sj, jg, tj, u_pk, shape=shape,
                                                 k=k, gibbs=gibbs)
        if kind == "cubic":
            kp = 2  # two systems side by side (tests/test_pallas_sweep3d.py)
            jg = ps3.pack_coupling_grids_3d(cj, shape, kp)
            u_pk = jnp.stack([ps3.pack_rows_3d(jnp.asarray(u[c]), shape[0],
                                               shape[1] * shape[2], kp, 1)
                              for c in range(nc)], axis=1)
            return ps3.sweep_3d_injected(sj, jg, tj, u_pk, shape=shape, kp=kp,
                                         ks=1, gibbs=gibbs)
        if kind in ("bcc", "fcc"):
            kp = psd.pack_factor_diag(ref, n_sys)
            jg = psd.pack_coupling_grids_diag(cj, shape, kind, kp)
            u_pk = jnp.stack([ps3.pack_rows_3d(jnp.asarray(u[c]), shape[0],
                                               shape[1] * shape[2], kp, 1)
                              for c in range(nc)], axis=1)
            return psd.sweep_diag_injected(sj, jg, tj, u_pk, shape=shape,
                                           kind=kind, kp=kp, gibbs=gibbs)
        kp = psd.pack_factor_gen(ref, n_sys)
        meta = psd.gen_meta(ref)
        shape3, gen = meta[0], tuple(meta[1:])
        jg = psd.pack_coupling_grids_gen(cj, ref, kp)
        u_pk = jnp.stack([ps3.pack_rows_3d(jnp.asarray(u[c]), shape3[0],
                                           shape3[1] * shape3[2], kp, 1)
                          for c in range(nc)], axis=1)
        return psd.sweep_gen_injected(sj, jg, tj, u_pk, shape=shape3, gen=gen,
                                      kp=kp, gibbs=gibbs)


TWINS = [
    ("tri", (8, 8), TRI, 3),  # row 10, sweep_tri_injected
    ("tri-packed", (8, 16), TRI, 8),  # row 10, sweep_tri_packed_injected
    ("cubic", (8, 4, 4), None, 4),  # row 8, sweep_3d_injected
    ("bcc", (8, 4, 8), GEOMETRY_OFFSETS["bcc"], 4),  # row 11
    ("fcc", (8, 8, 4), GEOMETRY_OFFSETS["fcc"], 4),  # row 11
    ("gen", (8, 16), NNN, 8),  # row 12, sweep_gen_injected
]


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("kind,shape,offsets,n_sys", TWINS, ids=[t[0] for t in TWINS])
def test_plain_sweep_matches_pallas_twins(kind, shape, offsets, n_sys, gibbs):
    ref, port, rng, coup, coup_bwd, spins = _setup(shape, offsets, n_sys, 17)
    temps = np.linspace(1.5, 8.0, n_sys).astype(np.float32)
    colours = torch.from_numpy(port.colors.astype(np.uint8))
    got = torch.from_numpy(spins.copy())[None]
    for step in range(2):
        u = rng.random((port.n_colors, n_sys, port.n_spins), dtype=np.float32)
        want = np.asarray(_pallas_twin(kind, ref, coup, got[0].numpy(), temps, u,
                                       gibbs)).reshape(n_sys, -1)
        tsweep.sweep_nb_plain(
            got, torch.from_numpy(coup)[None], torch.from_numpy(coup_bwd)[None],
            colours, torch.from_numpy(temps)[None], None, port, gibbs=gibbs,
            uniforms=torch.from_numpy(u)[None])
        np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f"step {step}")


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("name,shape,offsets", GEOMETRIES, ids=GEO_IDS)
def test_energies_and_mags_match_reference(name, shape, offsets, couplings):
    ref, port, _, coup, _, spins = _setup(shape, offsets, 5, 29, couplings)
    e_ref, m_ref = ref_energies_and_mags(jnp.asarray(spins), jnp.asarray(coup),
                                         GridOps.from_lattice(ref))
    e, m = energies_and_mags(torch.from_numpy(spins), torch.from_numpy(coup),
                             shape, port.offsets)
    e_part, m_part = measure_nb_plain(torch.from_numpy(spins)[None],
                                      torch.from_numpy(coup)[None], port)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(m_part[0, :, 0].numpy(), np.asarray(m_ref))
    if couplings == "pm":  # integer sums: exact in any order
        np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
        np.testing.assert_array_equal((e_part[0, :, 0] / port.n_spins).numpy(),
                                      np.asarray(e_ref))
    else:
        tol = 1e-6 * np.abs(coup).sum() / port.n_spins
        np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=0, atol=tol)
        np.testing.assert_allclose((e_part[0, :, 0] / port.n_spins).numpy(),
                                   np.asarray(e_ref), rtol=0, atol=tol)


def _fused_fk(lat, spins, kf, temps, coup, u, wolff, n_rep):
    """The reference's fused FK kernel in interpret mode on a flat graph
    batch (graph b at realization b // n_rep), triangular (tri=True) or 3D:
    spins, e, m and labels with the Wolff marker rewritten as the engine
    does (loop.py:2107-2116)."""
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
        with_measure=True, with_labels=True, tri=len(shape) == 2 and nd == 3,
    )
    labels = np.asarray(ccb._unpack(labels, l0, block, kp, ks)[:b])
    if wolff:
        neg = labels == -1
        mn = np.where(neg, np.arange(n), n).min(-1, keepdims=True)
        labels = np.where(neg, mn, labels)
    return (np.asarray(ccb._unpack(out, l0, block, kp, ks)[:b]),
            np.asarray(e).reshape(-1)[:b], np.asarray(m).reshape(-1)[:b], labels)


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("shape,offsets", [((8, 16), TRI), ((8, 8, 8), None)],
                         ids=["tri-8x16", "cubic-8"])
def test_fk_plain_matches_fused_reference(shape, offsets, wolff):
    lat = RefLattice(list(shape), offsets)
    n, nd = lat.n_spins, lat.n_neighbors
    d, n_rep = 2, 3
    b = d * n_rep
    rng = np.random.default_rng(5 + n + 2 * wolff)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(b, n))
    coup = rng.normal(size=(d, n, nd)).astype(np.float32)
    temps = np.linspace(1.5, 5.0, b).astype(np.float32)
    u = rng.random((b, n, nd), dtype=np.float32)
    kf = jax.random.split(jax.random.key(17 + n), b)
    kf_words = np.asarray(jax.random.key_data(kf))
    fused, e_ref, m_ref, fused_labels = _fused_fk(
        lat, jnp.asarray(spins), kf, jnp.asarray(temps), jnp.asarray(coup),
        jnp.asarray(u), wolff, n_rep)

    port = torch.from_numpy(spins.reshape(b, *shape).copy())
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
    # the update did something: some clusters flipped, some bonds joined
    assert (port.reshape(b, n).numpy() != spins).any()
    assert (labels.reshape(b, n).numpy() != np.arange(n)).any()


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The reference's interpret mode draws zero uniforms in its sweep and FK
    kernels; the port's plain path gets zeros in their place."""
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "site_uniforms",
        lambda words, n, c, n_spins: torch.zeros(words.shape[:-1] + (n, n_spins)))
    monkeypatch.setattr(
        trng, "bond_uniforms",
        lambda words, n, n_dirs=2: torch.zeros(words.shape[:-1] + (n, n_dirs)))


@pytest.mark.parametrize(
    "shape,offsets,n_temps,kw",
    [((8, 16), TRI, 8, dict(cluster_update_interval=2, cluster_mode="wolff",
                            collect_cluster_stats=True)),
     ((8, 8, 8), None, 4, dict(cluster_update_interval=1, cluster_mode="sw",
                               pt_interval=1))],
    ids=["tri-wolff", "cubic-sw-pt"],
)
def test_engine_matches_reference_under_zero_uniforms(zero_uniforms, shape,
                                                      offsets, n_temps, kw):
    nb = len(offsets) if offsets else len(shape)
    rng = np.random.default_rng(8)
    coup = rng.choice([-1.0, 1.0], size=(2,) + shape + (nb,)).astype(np.float32)
    temps = np.geomspace(3.0, 4.4, n_temps).astype(np.float32)
    kw = dict(kw, warmup_ratio=0.25)
    ref = RefSimulation(list(shape), coup, temps, 1, offsets, 5, mesh=None)
    r_ref = ref.sample(8, "metropolis", **kw)
    port = IsingSimulation(list(shape), coup, temps, 1, offsets, 5, device="cpu")
    r_port = port.sample(8, "metropolis", **kw)
    for key in ("spins", "system_ids", "pt_edge_attempts",
                "pt_edge_acceptances", "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(),
                                      np.asarray(ref.state[key]), err_msg=key)
    assert int(port.state["counter"]) == int(ref.state["counter"]) == 8
    if "fk_csd" in r_ref:
        np.testing.assert_array_equal(np.asarray(r_port["fk_csd"]),
                                      np.asarray(r_ref["fk_csd"]))
    for key in ("energies", "energies2", "mags", "mags2", "mags4"):
        np.testing.assert_allclose(r_port[key], r_ref[key], rtol=2e-5,
                                   err_msg=key)


def _exact(shape, offsets, T):
    """Exact <E>/N and <m^2> of a ferromagnet by enumeration, bonds from
    the forward table (double bonds at extent 2 count twice)."""
    lat = RefLattice(list(shape), offsets)
    n = lat.n_spins
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    bi = np.repeat(np.arange(n), lat.n_neighbors)
    E = (states[:, bi] * states[:, lat.fwd.reshape(-1)]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    w = np.exp((E - E.max()) / T)
    return (E * w).sum() / w.sum() / n, ((M / n) ** 2 * w).sum() / w.sum()


EXACT = [
    ("tri-metropolis", (4, 4), TRI, 4.0, "metropolis", {}),
    ("tri-gibbs", (4, 4), TRI, 4.0, "gibbs", {}),
    ("tri-wolff", (4, 4), TRI, 4.0, "metropolis",
     dict(cluster_update_interval=1, cluster_mode="wolff")),
    ("bcc-metropolis", (2, 2, 4), GEOMETRY_OFFSETS["bcc"], 4.0, "metropolis", {}),
    ("fcc-metropolis", (2, 2, 4), GEOMETRY_OFFSETS["fcc"], 5.0, "metropolis", {}),
    ("nnn-metropolis", (2, 8), NNN, 5.0, "metropolis", {}),
    ("cubic-metropolis", (2, 2, 4), None, 4.5, "metropolis", {}),
    ("cubic-sw", (2, 2, 4), None, 4.5, "metropolis",
     dict(cluster_update_interval=1, cluster_mode="sw")),
]


@pytest.mark.parametrize("name,shape,offsets,T,mode,kw", EXACT,
                         ids=[x[0] for x in EXACT])
def test_exact_enumeration(name, shape, offsets, T, mode, kw):
    """16 independent chains (realizations of one ferromagnet) of 1500
    sweeps each: m^2 of the 2x2x4 FCC magnet decorrelates slowly under
    single-spin moves, and one chain of 4000 sweeps strays by up to 0.2."""
    e_ex, m2_ex = _exact(shape, offsets, T)
    coup = np.ones((16,) + shape + (len(offsets or shape),), np.float32)
    m = IsingSimulation(list(shape), coup, np.array([T], np.float32), 1, offsets,
                        11, device="cpu")
    r = m.sample(1500, mode, warmup_ratio=0.25, **kw)
    assert abs(r["energies"][0] - e_ex) < 0.05, (r["energies"][0], e_ex)
    assert abs(r["mags2"][0] - m2_ex) < 0.06, (r["mags2"][0], m2_ex)


def test_z_test_tri_wolff_against_jax_engine():
    """Batch means of <E> and <m^2> per temperature from 8 consecutive
    sample() calls on each engine (16x16 triangular around T_c = 4 / ln 3,
    Wolff every sweep, PT): |z| < 4."""
    temps = np.array([3.2, 3.5, 3.8, 4.2], np.float32)
    kw = dict(cluster_update_interval=1, cluster_mode="wolff", pt_interval=1,
              warmup_ratio=0)
    n_batches, n_sweeps = 8, 150
    stats = {}
    for name, model in (
        ("jax", RefIsing((16, 16), geometry="triangular", temperatures=temps,
                         seed=21)),
        ("port", Ising((16, 16), geometry="triangular", temperatures=temps,
                       seed=22, device="cpu")),
    ):
        model.sample(100, **kw)  # burn-in
        e, m2 = [], []
        for _ in range(n_batches):
            model.sample(n_sweeps, **kw)
            e.append(model.energies_avg)
            m2.append(model.mags2)
        stats[name] = (np.array(e), np.array(m2))
    for k, label in enumerate(("E", "m2")):
        a, b = stats["jax"][k], stats["port"][k]
        se = np.sqrt(a.var(0, ddof=1) / n_batches + b.var(0, ddof=1) / n_batches)
        z = (a.mean(0) - b.mean(0)) / se
        assert (np.abs(z) < 4).all(), (label, z)


def test_geometry_api_matches_reference():
    """geometry= / neighbor_offsets= as the reference takes them: the same
    couplings drawn, n_neighbors, and the reference's errors."""
    for kw in (dict(geometry="fcc"), dict(geometry="tri"),
               dict(neighbor_offsets=NNN)):
        shape = (4, 4, 4) if kw.get("geometry") == "fcc" else (4, 6)
        port = Ising(shape, couplings="gaussian", temperatures=[2.0, 3.0],
                     n_disorder=2, seed=9, device="cpu", **kw)
        ref = RefIsing(shape, couplings="gaussian", temperatures=[2.0, 3.0],
                       n_disorder=2, seed=9, **kw)
        assert port.n_neighbors == ref.n_neighbors
        np.testing.assert_array_equal(port.couplings, ref.couplings)
        r = port.sample(6, pt_interval=1)
        assert np.isfinite(r["energies"]).all()
        assert np.shape(port.heat_capacity) == (2,)
        assert np.isfinite(port.heat_capacity).all()
    with pytest.raises(ValueError, match="Cannot specify both"):
        Ising((4, 4), geometry="tri", neighbor_offsets=TRI, device="cpu")
    with pytest.raises(ValueError, match="Unknown geometry"):
        Ising((4, 4), geometry="hex", device="cpu")


@pytest.mark.parametrize("kwargs,sample,item", [
    (dict(lattice_shape=(4, 4), geometry="tri", n_replicas=2), None, None),
    # SW on BCC runs (the staged path), with replicas too
    (dict(lattice_shape=(4, 4, 4), geometry="bcc", n_replicas=2),
     dict(cluster_update_interval=1, cluster_mode="sw"), None),
    # odd extents run (item 4a), with replicas and the moves' table form
    (dict(lattice_shape=(4, 5), geometry="tri", n_replicas=2),
     dict(overlap_cluster_update_interval=1), None),
    # the overlap moves run on the triangular lattice (item 7d)
    (dict(lattice_shape=(4, 4), geometry="tri", n_replicas=2),
     dict(overlap_cluster_update_interval=1), None),
    # replicas past three dimensions or six offsets run, with the overlap
    # moves too, in the kernels' table form (item 4a); more than 32 offsets
    # still raise
    (dict(lattice_shape=(2, 2, 2, 2), n_replicas=2), None, None),
    (dict(lattice_shape=(3, 3, 3, 3), n_replicas=2),
     dict(overlap_cluster_update_interval=1, overlap_cluster_build_mode="houdayer+cmr",
          overlap_cluster_mode="sw", collect_cluster_stats=True), None),
    (dict(lattice_shape=(2, 2, 2, 2, 2), n_replicas=2),
     dict(overlap_cluster_update_interval=1, overlap_cluster_build_mode="jorg"), None),
    (dict(lattice_shape=(4, 4, 4), neighbor_offsets=[[1, 0, 0], [0, 1, 0], [0, 0, 1],
                                                     [1, 1, 0], [1, -1, 0], [1, 0, 1],
                                                     [1, 0, -1], [0, 1, 1], [0, 1, -1]],
          n_replicas=2),
     dict(overlap_cluster_update_interval=1, overlap_cluster_build_mode="cmr"), None),
    (dict(lattice_shape=(4, 4), neighbor_offsets=[[1, 0]] * 33), None, "4a"),
], ids=["replicas-tri", "sw-bcc", "odd-extents", "overlap-tri", "replicas-4d",
        "overlap-4d", "overlap-5d", "overlap-9offsets", "offsets-33"])
def test_out_of_slice_geometry_options_raise(kwargs, sample, item):
    """Options outside the slice raise, naming the ROADMAP item; replicas on
    the triangular and BCC lattices run (item 7a), with overlap moves too
    (item 7d), on odd extents, past three dimensions and past six offsets
    too (item 4a): the pair records over the lattice's offsets, finite,
    q_l a mean over n_spins * n_neighbors bonds; the moves' statistics
    where asked for."""
    if item is not None:
        match = f"ROADMAP.md, queue 1, item {item}"
        with pytest.raises(NotImplementedError, match=match):
            m = Ising(temperatures=[2.0, 3.0], seed=1, device="cpu", **kwargs)
            m.sample(4, **(sample or {}))
        return
    m = Ising(temperatures=[2.0, 3.0], couplings="ferro", seed=1, device="cpu", **kwargs)
    r = m.sample(4, warmup_ratio=0, pt_interval=1, **(sample or {}))
    assert np.asarray(r["overlap_histogram"]).sum() == 4 * 2  # sweeps x T
    for key in ("overlap2", "link_overlap", "link_overlap2", "energies"):
        assert np.isfinite(r[key]).all(), key
    # |q_l| <= 1: the link sums are divided by n_spins * n_neighbors bonds
    assert (np.abs(r["link_overlap"]) <= 1).all()
    assert ("fk_csd" in r) is False
    assert ("overlap_csd" in r) == bool((sample or {}).get("collect_cluster_stats"))
    assert np.isfinite(m.sg_binder).all()
