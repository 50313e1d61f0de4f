"""The port's space-sharded path (``IsingSimulation(mesh=make_mesh(k,
("space",), ...))``: the lattice split into row bands) on the CPU.

* At 4, 2 and 1 bands a run is bitwise the port's unsharded per-sweep run
  (``engine/loop.run_chunk_sweeps``, called in place of ``run_chunk``,
  which would take the mega path on the square lattice): spins, PT state,
  records and ``fk_csd``, with Metropolis (or Gibbs) and PT, SW with PT and
  cluster statistics, and Wolff, on the square, cubic, triangular and FCC
  (staged) lattices.  The couplings are +-1, so every energy sum is an
  integer and the records are bitwise whatever the order of the bands'
  partials.
* Under zero uniforms (the reference's interpret mode draws zeros; the
  port's band uniform sources are patched to zeros), the port in bands is
  bitwise the JAX engine on a virtual ``space`` mesh in interpret mode: the
  square lattice through its 2D halo kernel (``pallas-2d-halo``), the
  triangular lattice through its generic halo kernel
  (``pallas-gen-halo``).
* The options the slice leaves out raise, the indivisible extent raises
  the reference's ``ValueError``, ``get_spins`` / ``reset`` gather and
  scatter the bands, and a space-mesh run imports no jax.
"""

import contextlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from peapods_tpu.engine.simulation import IsingSimulation as RefSimulation
from peapods_tpu.parallel.mesh import make_mesh as ref_make_mesh
from peapods_tpu_torch.engine import loop, simulation
from peapods_tpu_torch.engine.simulation import IsingSimulation
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS
from peapods_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

TRI = GEOMETRY_OFFSETS["triangular"]
FCC = GEOMETRY_OFFSETS["fcc"]


def cpu_mesh(k, axes=("space",)):
    return make_mesh(k, axes, devices=["cpu"] * k)


@contextlib.contextmanager
def per_sweep_path():
    """Drive ``sample`` through ``run_chunk_sweeps`` (the unsharded
    per-sweep path) on every lattice."""
    old = simulation.run_chunk
    simulation.run_chunk = loop.run_chunk_sweeps
    try:
        yield
    finally:
        simulation.run_chunk = old


def _run(shape, offsets, coup, temps, mesh, mode, kw, n=6, seed=5):
    sim = IsingSimulation(list(shape), coup, temps, 1, offsets, seed, default_chunk=4,
                          mesh=mesh, device="cpu")
    with per_sweep_path() if mesh is None else contextlib.nullcontext():
        r = sim.sample(n, mode, **kw)
    return sim, r


LATTICES = [("square", (16, 16), None), ("cubic", (8, 8, 8), None),
            ("tri", (16, 16), TRI), ("fcc", (8, 8, 8), FCC)]
MODES = [
    ("metropolis-pt", "metropolis", dict(pt_interval=1, warmup_ratio=0)),
    ("gibbs-pt-full", "gibbs", dict(pt_interval=2, pt_schedule="full_ladder",
                                    warmup_ratio=0.5)),
    ("sw-pt-stats", "metropolis", dict(pt_interval=1, cluster_update_interval=1,
                                       cluster_mode="sw", collect_cluster_stats=True,
                                       warmup_ratio=0.25)),
    ("wolff", "metropolis", dict(cluster_update_interval=2, cluster_mode="wolff",
                                 collect_cluster_stats=True, warmup_ratio=0)),
]


@pytest.mark.parametrize("mname,mode,kw", MODES, ids=[m[0] for m in MODES])
@pytest.mark.parametrize("name,shape,offsets", LATTICES, ids=[g[0] for g in LATTICES])
def test_space_run_is_bitwise_the_unsharded_run(name, shape, offsets, mname, mode, kw):
    nb = len(offsets) if offsets else len(shape)
    rng = np.random.default_rng(3)
    coup = rng.choice([-1.0, 1.0], size=(2,) + shape + (nb,)).astype(np.float32)
    temps = np.geomspace(2.0, 3.2, 3).astype(np.float32) * (2.2 if len(shape) == 3 else 1)
    plain, r0 = _run(shape, offsets, coup, temps, None, mode, kw)
    for k in (4, 2, 1):
        sim, r = _run(shape, offsets, coup, temps, cpu_mesh(k), mode, kw)
        np.testing.assert_array_equal(sim.all_spins().numpy(), plain.state["spins"].numpy(),
                                      err_msg=f"{k} bands")
        for key in ("system_ids", "pt_edge_attempts", "pt_edge_acceptances",
                    "pt_round_trips", "pt_trip_state"):
            np.testing.assert_array_equal(sim.state[key].numpy(), plain.state[key].numpy(),
                                          err_msg=f"{k} bands: {key}")
        for key in ("energies", "energies2", "mags", "mags2", "mags4"):
            np.testing.assert_array_equal(r[key], r0[key], err_msg=f"{k} bands: {key}")
        if "fk_csd" in r0:
            np.testing.assert_array_equal(r["fk_csd"], r0["fk_csd"])
    assert (plain.state["spins"].numpy() != IsingSimulation(
        list(shape), coup, temps, 1, offsets, 5, device="cpu").state["spins"].numpy()).any()


def test_space_run_with_gaussian_couplings():
    """Gaussian couplings on the square lattice: spins and PT state bitwise;
    the plain versions sum each band's energy apart, so the records agree
    within 1e-6 sum |J| per spin (the kernels' partials are bitwise where
    the bands start on their block boundaries: tests/test_torch_cuda.py)."""
    shape = (64, 32)
    rng = np.random.default_rng(11)
    coup = rng.standard_normal(shape + (2,)).astype(np.float32)
    temps = np.geomspace(1.5, 3.0, 4).astype(np.float32)
    kw = dict(pt_interval=1, cluster_update_interval=2, cluster_mode="sw",
              warmup_ratio=0)
    plain, r0 = _run(shape, None, coup, temps, None, "metropolis", kw)
    sim, r = _run(shape, None, coup, temps, cpu_mesh(2), "metropolis", kw)
    np.testing.assert_array_equal(sim.all_spins().numpy(), plain.state["spins"].numpy())
    np.testing.assert_array_equal(sim.state["system_ids"].numpy(),
                                  plain.state["system_ids"].numpy())
    # the plain versions sum each band apart: agreement within 1e-6 sum |J|
    tol = 1e-6 * np.abs(coup).sum() / coup[..., 0].size
    np.testing.assert_allclose(r["energies"], r0["energies"], rtol=0, atol=tol)
    np.testing.assert_array_equal(r["mags"], r0["mags"])


# ------------------------------------------------- against the JAX engine


@pytest.fixture
def zero_uniforms(monkeypatch):
    """The reference's interpret mode draws zero uniforms; the port's band
    uniform sources give zeros."""
    monkeypatch.setenv("PEAPODS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(
        trng, "slot_uniforms_at",
        lambda words, n, c, idx: torch.zeros(words.shape[:-1] + (n, len(idx))))
    monkeypatch.setattr(
        trng, "bond_uniforms_at",
        lambda words, idx, n_dirs: torch.zeros(words.shape[:-1] + (len(idx), n_dirs)))


@pytest.mark.parametrize("shape,offsets,ns,plan", [
    ((32, 128), None, 4, "pallas-2d-halo"),
    ((16, 128), TRI, 2, "pallas-gen-halo"),
], ids=["square-4-bands", "tri-2-bands"])
def test_space_run_matches_the_jax_space_mesh_under_zero_uniforms(
        zero_uniforms, shape, offsets, ns, plan):
    nb = len(offsets) if offsets else len(shape)
    coup = np.ones(shape + (nb,), np.float32)
    temps = np.geomspace(1.8, 3.2, 3).astype(np.float32) * (1.4 if offsets else 1)
    kw = dict(pt_interval=1, warmup_ratio=0)
    ref = RefSimulation(list(shape), coup, temps, 1, offsets, 5, default_chunk=8,
                        mesh=ref_make_mesh(ns, ("space",)))
    r_ref = ref.sample(8, "metropolis", **kw)
    assert plan in next(iter(ref._programs.values())).describe_plan()
    port = IsingSimulation(list(shape), coup, temps, 1, offsets, 5, default_chunk=8,
                           mesh=cpu_mesh(ns), device="cpu")
    r_port = port.sample(8, "metropolis", **kw)
    np.testing.assert_array_equal(port.all_spins().numpy(), np.asarray(ref.state["spins"]))
    for key in ("system_ids", "pt_edge_attempts", "pt_edge_acceptances",
                "pt_round_trips", "pt_trip_state"):
        np.testing.assert_array_equal(port.state[key].numpy(), np.asarray(ref.state[key]),
                                      err_msg=key)
    for key in ("energies", "energies2", "mags", "mags2"):
        np.testing.assert_array_equal(r_port[key], np.asarray(r_ref[key]), err_msg=key)
    assert r_port["per_disorder"]["parallel_tempering"]["edge_acceptances"].sum() > 0


# ------------------------------------------------- the slice's edges


def test_space_mesh_rejects_indivisible_extent():
    coup = np.ones((6, 8, 2), np.float32)
    with pytest.raises(ValueError, match="space"):
        IsingSimulation([6, 8], coup, [2.0], 1, None, 1, mesh=cpu_mesh(4), device="cpu")


def test_space_mesh_refuses_what_the_slice_leaves_out():
    coup = np.ones((8, 8, 2), np.float32)
    for axes in (("disorder",), ("systems",), ("disorder", "space")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            IsingSimulation([8, 8], coup, [2.0], mesh=cpu_mesh(4, axes), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        IsingSimulation([8, 8], coup, [2.0], 2, mesh=cpu_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        IsingSimulation([8, 8], coup, [2.0], mesh=make_mesh(2, ("space",),
                                                            devices=["cuda:0"] * 2),
                        device="cpu")
    sim = IsingSimulation([8, 8], coup, [2.0, 2.5], mesh=cpu_mesh(2), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sim.sample(4, "metropolis", cluster_update_interval=1, cluster_action="observe")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sim.sample(4, "metropolis", snapshot_interval=2)
    far = IsingSimulation([8, 8], np.ones((8, 8, 2), np.float32), [2.0],
                          neighbor_offsets=[[2, 1], [0, 1]], mesh=cpu_mesh(2), device="cpu")
    far.sample(2, "metropolis")  # the sweep reaches two rows of halo
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        far.sample(2, "metropolis", cluster_update_interval=1)


def test_get_spins_and_reset_gather_and_scatter_the_bands():
    coup = np.ones((16, 8, 2), np.float32)
    plain = IsingSimulation([16, 8], coup, [2.0, 2.4], 1, None, 9, device="cpu")
    sim = IsingSimulation([16, 8], coup, [2.0, 2.4], 1, None, 9, mesh=cpu_mesh(4),
                          device="cpu")
    np.testing.assert_array_equal(sim.get_spins(), plain.get_spins())
    sim.sample(4, "metropolis", pt_interval=1)
    assert (sim.get_spins() != plain.get_spins()).any()
    sim.reset()
    plain.reset()
    np.testing.assert_array_equal(sim.get_spins(), plain.get_spins())
    sim.reset(3)
    plain.reset(3)
    np.testing.assert_array_equal(sim.all_spins().numpy(), plain.all_spins().numpy())
    w = sim.state["bands"][1]
    assert tuple(w.shape) == (1, 2, (4 + 2) * 8)
    # the halos are the neighbouring bands' edge rows
    full = plain.all_spins()[0].reshape(2, 16, 8)
    np.testing.assert_array_equal(w[0].reshape(2, 6, 8).numpy(), full[:, 3:9].numpy())


def test_initial_spins_on_a_device_are_the_numpy_draw():
    """The engine draws its initial spins with torch on its device; they are
    the numpy threefry draw (itself held to the reference's in
    tests/test_torch_seeds.py)."""
    from peapods_tpu_torch.engine import seeds

    keys = np.stack([seeds.key_from_u64(seeds.realization_seed(s, r))
                     for s, r in ((42, 0), (7, 3), (2**64 - 1, 1))])
    want = seeds.initial_spins(keys, 3, 20000)
    got = seeds.initial_spins(keys, 3, 20000, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_space_run_imports_no_jax():
    code = (
        "import sys, numpy as np\n"
        "from peapods_tpu_torch import IsingSimulation\n"
        "from peapods_tpu_torch.parallel.mesh import make_mesh\n"
        "mesh = make_mesh(2, ('space',), devices=['cpu', 'cpu'])\n"
        "sim = IsingSimulation([8, 8], np.ones((8, 8, 2), np.float32), [2.0, 2.5], 1, "
        "None, 1, mesh=mesh, device='cpu')\n"
        "sim.sample(4, 'metropolis', pt_interval=1, cluster_update_interval=1, "
        "cluster_mode='wolff', collect_cluster_stats=True)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', "
        "'peapods_tpu.')) or k == 'peapods_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
