"""Checkpoints of the port (``save_checkpoint`` / ``load_checkpoint``), on
the CPU.

* The twins of tests/test_checkpoint.py: a run saved, reloaded into a new
  model and continued is bitwise the uninterrupted run; a seed mismatch
  raises the reference's ``ValueError``.
* The file is the JAX engine's: one written by the JAX engine loads into
  the port as ``convert.from_reference`` of the JAX state, bitwise, and one
  written by the port loads into the JAX engine as ``to_reference`` of the
  port's state.
* A space-mesh simulation's file (the spins gathered from the bands) loads
  into an unsharded one, which continues bitwise, and back.
* A dynamics seed of 2^63 or more (about half of them) is written as
  ``uint64``, a smaller one as the JAX package's ``int64``; the port and
  the JAX engine both load the large one's file.
* ``tools/physics_torch.py --device cpu`` resolves ``from peapods_tpu
  import Ising`` to the port's class without importing jax.
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from peapods_tpu import Ising as RefIsing
from peapods_tpu_torch import Ising, IsingSimulation
from peapods_tpu_torch.engine import convert, loop, simulation
from peapods_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
KW = dict(lattice_shape=(4, 4), couplings="bimodal",
          temperatures=np.array([1.0, 2.0], dtype=np.float32), n_replicas=2, seed=19)


def test_checkpoint_roundtrip_continues_identically(tmp_path):
    a = Ising(**KW, device="cpu")
    a.sample(6, pt_interval=1, warmup_ratio=0)
    path = tmp_path / "state.npz"
    a.save_checkpoint(path)
    a.sample(6, pt_interval=1, warmup_ratio=0)
    final = a._sim.get_spins().copy()
    final_pt = a._sim.state["pt_edge_attempts"].clone()

    b = Ising(**KW, device="cpu")
    b.load_checkpoint(path)
    b.sample(6, pt_interval=1, warmup_ratio=0)
    np.testing.assert_array_equal(b._sim.get_spins(), final)
    np.testing.assert_array_equal(b._sim.state["pt_edge_attempts"].numpy(),
                                  final_pt.numpy())


def test_checkpoint_seed_mismatch_rejected(tmp_path):
    a = Ising((4, 4), temperatures=np.array([1.0]), seed=1, device="cpu")
    path = tmp_path / "s.npz"
    a.save_checkpoint(path)
    b = Ising((4, 4), temperatures=np.array([1.0]), seed=2, device="cpu")
    with pytest.raises(ValueError, match="constructor seed"):
        b.load_checkpoint(path)
    c = Ising((4, 6), temperatures=np.array([1.0]), seed=1, device="cpu")
    with pytest.raises(ValueError, match="checkpoint entry spins has shape"):
        c.load_checkpoint(path)


def _ref_state(model):
    st = model._sim.state
    out = {k: np.asarray(v) for k, v in st.items() if k != "base_keys"}
    out["base_keys"] = np.asarray(jax.random.key_data(st["base_keys"]))
    return out


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_files_cross_between_engines(tmp_path):
    """JAX file -> port, port file -> JAX: the states map one to one, and
    each engine's own reader reads the other's file."""
    ref = RefIsing(**KW)
    ref.sample(5, pt_interval=1, warmup_ratio=0)
    ref.save_checkpoint(tmp_path / "jax.npz")
    port = Ising(**KW, device="cpu")
    port.load_checkpoint(tmp_path / "jax.npz")
    want = convert.from_reference(_ref_state(ref), "cpu")
    for k, v in want.items():
        got = port._sim.state[k]
        if torch.is_tensor(v):
            assert torch.equal(got, v), k
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)
    ref_file, seed = convert.read_checkpoint(tmp_path / "jax.npz")
    assert seed == ref._sim.constructor_seed
    _same(ref_file, _ref_state(ref))

    port.sample(7, pt_interval=1, warmup_ratio=0)
    port.save_checkpoint(tmp_path / "port.npz")
    back = RefIsing(**KW)
    back.load_checkpoint(tmp_path / "port.npz")
    _same(_ref_state(back), convert.to_reference(port._sim.state))
    assert int(back._sim.state["counter"]) == 12


def _large_seed():
    """The first seed whose 64-bit dynamics seed is 2^63 or more."""
    from peapods_tpu_torch.engine.seeds import dynamics_seed

    return next(s for s in range(64) if dynamics_seed(s) >= 1 << 63)


def test_checkpoint_seed_past_int64(tmp_path):
    """Through ``Ising``: a dynamics seed >= 2^63 saves as uint64, and both
    engines load the file to the state the port saved; a small seed's file
    still holds an int64."""
    seed = _large_seed()
    kw = dict(KW, seed=seed)
    a = Ising(**kw, device="cpu")
    assert a._sim.constructor_seed >= 1 << 63
    a.sample(5, pt_interval=1, warmup_ratio=0)
    path = tmp_path / "large.npz"
    a.save_checkpoint(path)
    with np.load(path) as data:
        assert data["__constructor_seed"].dtype == np.uint64
        assert int(data["__constructor_seed"]) == a._sim.constructor_seed
    want = convert.to_reference(a._sim.state)
    b = Ising(**kw, device="cpu")
    b.load_checkpoint(path)
    _same(convert.to_reference(b._sim.state), want)
    ref = RefIsing(**kw)
    ref.load_checkpoint(path)
    _same(_ref_state(ref), want)

    small = Ising(**KW, device="cpu")
    assert small._sim.constructor_seed < 1 << 63
    small.save_checkpoint(tmp_path / "small.npz")
    with np.load(tmp_path / "small.npz") as data:
        assert data["__constructor_seed"].dtype == np.int64


@contextlib.contextmanager
def per_sweep_path():
    old = simulation.run_chunk
    simulation.run_chunk = loop.run_chunk_sweeps
    try:
        yield
    finally:
        simulation.run_chunk = old


def test_space_mesh_file_loads_unsharded(tmp_path):
    """Save on a 2-band space mesh, load into an unsharded simulation (the
    per-sweep path, bitwise the bands') and into a new 2-band one: both
    continue bitwise the uninterrupted space run."""
    coup = np.ones((8, 8, 2), np.float32)
    temps = np.geomspace(1.8, 3.2, 3).astype(np.float32)
    kw = dict(pt_interval=1, cluster_update_interval=2, warmup_ratio=0)

    def sim(mesh):
        m = None if not mesh else make_mesh(2, ("space",), devices=["cpu"] * 2)
        return IsingSimulation([8, 8], coup, temps, 1, None, 4, mesh=m, device="cpu")

    a = sim(True)
    a.sample(10, "metropolis", **kw)
    a.save_checkpoint(tmp_path / "space.npz")
    a.sample(10, "metropolis", **kw)
    want = convert.to_reference({**a.state, "spins": a.all_spins()})
    for mesh in (False, True):
        b = sim(mesh)
        b.load_checkpoint(tmp_path / "space.npz")
        with per_sweep_path() if not mesh else contextlib.nullcontext():
            b.sample(10, "metropolis", **kw)
        _same(convert.to_reference({**b.state, "spins": b.all_spins()}), want)


def test_physics_runner_resolves_the_port():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "physics_torch.py"), "--device", "cpu",
         "--which"], capture_output=True, text=True, check=True, cwd=ROOT, timeout=120)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"Ising": "peapods_tpu_torch.models.ising.Ising", "device": "cpu",
                   "cumulative_overlap_ratio": "peapods_tpu_torch.sweep",
                   "jax_imported": False, "reference_imported": False}
