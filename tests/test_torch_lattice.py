"""The port's lattices against the JAX package's.

``peapods_tpu_torch.ops.lattice.Lattice`` keeps its own numpy copy of the
reference's neighbour tables and greedy colouring
(``peapods_tpu/ops/lattice.py``): the per-sweep path's site schedule is the
colouring, so the tables and the colours must equal the reference's site
for site, for every geometry and at extent 2, where an offset wraps onto
the same neighbour twice.  Also: the coloured sweep's Philox draw, and the
square lattice's ``sweep_2d`` (row 4's function at 32 x 32) against
``mc_sweep(uniforms=)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import GEOMETRY_OFFSETS as REF_GEOMETRIES
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu.ops.sweep import mc_sweep
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops import sweep as tsweep
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

torch.set_num_threads(1)

NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
CASES = [
    ("square", (8, 16), None),
    ("square-2", (2, 6), None),
    ("cubic", (4, 6, 8), None),
    ("cubic-2", (2, 2, 4), None),
    ("tri", (8, 16), GEOMETRY_OFFSETS["triangular"]),
    ("tri-32", (32, 32), GEOMETRY_OFFSETS["tri"]),
    ("tri-2", (2, 4), GEOMETRY_OFFSETS["tri"]),
    ("bcc", (4, 4, 8), GEOMETRY_OFFSETS["bcc"]),
    ("bcc-2", (2, 2, 4), GEOMETRY_OFFSETS["bcc"]),
    ("fcc", (6, 4, 8), GEOMETRY_OFFSETS["fcc"]),
    ("fcc-2", (2, 2, 4), GEOMETRY_OFFSETS["fcc"]),
    ("nnn", (8, 8), NNN),
    ("nnn-2", (2, 8), NNN),
    ("stride2", (4, 8), [[2, 0], [0, 1]]),
    ("knight", (8, 16), [[1, 2], [2, 1]]),
    ("cubic-diag", (4, 4, 4), [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]]),
]


@pytest.mark.parametrize("name,shape,offsets", CASES, ids=[c[0] for c in CASES])
def test_lattice_matches_reference(name, shape, offsets):
    port = Lattice(shape, offsets)
    ref = RefLattice(list(shape), offsets)
    assert port.shape == ref.shape
    assert port.n_spins == ref.n_spins and port.n_neighbors == ref.n_neighbors
    np.testing.assert_array_equal(port.offsets, ref.offsets)
    np.testing.assert_array_equal(port.fwd, ref.fwd)
    np.testing.assert_array_equal(port.bwd, ref.bwd)
    np.testing.assert_array_equal(port.colors, ref.colors)
    assert port.n_colors == ref.n_colors
    np.testing.assert_array_equal(port.color_masks(), ref.color_masks())
    assert port.hypercubic == (offsets is None)
    # the colouring is proper: no bond joins two sites of one colour
    for tab in (port.fwd, port.bwd):
        nb = tab != np.arange(port.n_spins)[:, None]
        assert not (nb & (port.colors[tab] == port.colors[:, None])).any()


def test_named_geometries_are_the_reference_ones():
    assert GEOMETRY_OFFSETS == REF_GEOMETRIES


def test_lattice_outside_the_slice_raises():
    """Every dimension, extent >= 1 and up to 32 offsets builds (item 4a),
    past three dimensions or six offsets in the kernels' table form; 33
    offsets raise, naming the ROADMAP item; extents < 1 and an offset of
    the wrong length raise ValueError."""
    for shape in ((5, 4), (4, 4, 5), (4,), (2, 2, 2, 2)):
        assert Lattice(shape).table == (len(shape) > 3)
    assert Lattice((4, 4), [[1, 0]] * 7).table  # more offsets than the walk words
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1, item 4a"):
        Lattice((4, 4), [[1, 0]] * 33)
    with pytest.raises(ValueError, match="must be >= 1"):
        Lattice((4, 0))
    with pytest.raises(ValueError, match="offset 1 has length 3"):
        Lattice((4, 4), [[1, 0], [0, 1, 0]])


def test_site_uniforms_draw_each_sites_word():
    """Site i of colour c takes word i % 4 of Philox keyed by the sweep
    words, counter (slot, c, i // 4, 0), as csrc/sweep_nb.cu draws it."""
    words = torch.tensor([[7, -3], [123456, 99]], dtype=torch.int32)
    n_slots, n = 3, 10
    for colour in (0, 3):
        u = trng.site_uniforms(words, n_slots, colour, n)
        assert u.shape == (2, n_slots, n)
        for d in range(2):
            k = words[d].to(torch.int64) & trng.MASK32
            for slot in range(n_slots):
                for i in (0, 5, 9):
                    out = trng.philox4x32(
                        k[0], k[1], torch.tensor(slot), torch.tensor(colour),
                        torch.tensor(i // 4), torch.tensor(0))
                    assert u[d, slot, i] == trng.uniform24(out[i % 4])
        assert ((u >= 0) & (u < 1)).all()


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
def test_sweep_2d_plain_matches_mc_sweep_at_32(gibbs):
    """Row 4 (sweep_2d_packed, the TPU's sweep for W < 128) computes
    mc_sweep on the square lattice; the port runs that function through
    sweep_2d at any width: 32 x 32, 16 systems, +-1 couplings, bitwise."""
    h = w = 32
    n_sys = 16
    lat = RefLattice([h, w])
    geom = GridOps.from_lattice(lat)
    rng = np.random.default_rng(32 + gibbs)
    coup = rng.choice([-1.0, 1.0], size=(lat.n_spins, 2)).astype(np.float32)
    coup_j = jnp.asarray(coup)
    coup_bwd = jnp.asarray(coup[lat.bwd, np.arange(2)[None, :]])
    temps = rng.permutation(np.geomspace(1.5, 4.0, n_sys)).astype(np.float32)
    spins = rng.choice([-1, 1], size=(n_sys, lat.n_spins)).astype(np.int8)
    jg = tsweep.pack_coupling_grids(torch.from_numpy(coup)[None], (h, w))
    port = torch.from_numpy(spins.reshape(1, n_sys, h, w).copy())
    for step in range(3):
        u = rng.random((2, n_sys, lat.n_spins), dtype=np.float32)
        ref = np.asarray(mc_sweep(
            jnp.asarray(spins), coup_j, coup_bwd, geom,
            jnp.asarray(lat.color_masks()), jnp.asarray(temps),
            jax.random.PRNGKey(0), gibbs=gibbs, uniforms=jnp.asarray(u)))
        u_grid = np.swapaxes(u, 0, 1).reshape(1, n_sys, 2, h, w)
        tsweep.sweep_2d_plain(port, jg, torch.from_numpy(temps)[None], None,
                              gibbs=gibbs, uniforms=torch.from_numpy(u_grid))
        np.testing.assert_array_equal(port.reshape(n_sys, -1).numpy(), ref,
                                      err_msg=f"step {step}")
        spins = ref
