"""Port colour update: flip decisions against the reference's kernels.

The plain torch sweep (peapods_tpu_torch/ops/sweep.py) is driven with the
same injected uniforms as the reference's Pallas kernels (interpret mode)
and its jnp path ``mc_sweep(uniforms=)``, as tests/test_pallas_sweep.py
does.  Spins must agree bitwise; a mismatch is tolerated only at an
``exp`` ulp tie (|u - p| within 4 ulp of p), and none is expected at these
sizes.  The fused (e, m) must equal the recompute oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from peapods_tpu.ops import pallas_sweep as ps
from peapods_tpu.ops.energy import energies_and_mags as ref_energies_and_mags
from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu.ops.sweep import mc_sweep
from peapods_tpu_torch.ops import sweep as tsweep
from peapods_tpu_torch.ops.energy import energies_and_mags

torch.set_num_threads(1)

TEMPS = np.array([1.5, 2.269, 4.0], np.float32)


def _ulp_ties(spins, jg, temps, u, gibbs):
    """bool [n_sys, 2, H, W]: sites whose flip test |u - p| is within 4 ulp,
    per colour, evaluated on the port's own trajectory."""
    s = torch.as_tensor(spins).to(torch.float32)
    inv = (1.0 / (0.5 * torch.as_tensor(temps)))[:, None, None]
    ties = []
    for c in range(2):
        field = tsweep.local_field(s, jg)
        p = tsweep.acceptance((-s * field) * inv, gibbs=gibbs)
        uc = u[:, c]
        ulp = torch.nextafter(p, torch.tensor(np.inf)) - p
        ties.append((uc - p).abs() <= 4 * ulp)
        s, _ = tsweep.colour_update(s, jg, inv, uc, c, gibbs=gibbs)
    return torch.stack(ties, 1)


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("shape", [(8, 8), (8, 16)])
def test_sweep_matches_reference_kernels(shape, gibbs, couplings):
    h, w = shape
    n_sys = len(TEMPS)
    lat = RefLattice([h, w])
    geom = GridOps.from_lattice(lat)
    rng = np.random.default_rng(5 + w + 2 * gibbs)
    if couplings == "pm":
        coup = rng.choice([-1.0, 1.0], size=(lat.n_spins, 2)).astype(np.float32)
    else:
        coup = rng.standard_normal((lat.n_spins, 2)).astype(np.float32)
    coup_j = jnp.asarray(coup)
    coup_bwd = jnp.stack([geom.shift_bwd(coup_j[:, d], d) for d in range(2)], -1)
    jg_ref = ps.pack_coupling_grids(coup_j, (h, w))
    jg = tsweep.pack_coupling_grids(torch.from_numpy(coup), (h, w))
    np.testing.assert_array_equal(jg.numpy(), np.asarray(jg_ref))
    cm = jnp.asarray(lat.color_masks())
    temps_j = jnp.asarray(TEMPS)
    spins = rng.choice([-1, 1], size=(n_sys, lat.n_spins)).astype(np.int8)

    for step in range(3):
        u = rng.random((2, n_sys, lat.n_spins), dtype=np.float32)
        ref = np.asarray(mc_sweep(
            jnp.asarray(spins), coup_j, coup_bwd, geom, cm, temps_j,
            jax.random.PRNGKey(0), gibbs=gibbs, uniforms=jnp.asarray(u),
        ))
        u_grid = np.swapaxes(u, 0, 1).reshape(n_sys, 2, h, w)
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(ps.sweep_2d_injected(
                jnp.asarray(spins), jg_ref, temps_j, jnp.asarray(u_grid),
                shape=(h, w), gibbs=gibbs,
            ))
        np.testing.assert_array_equal(pallas, ref)
        if w % 16 == 0:
            u_sub = ps.pack_two_sub(jnp.asarray(u).reshape(2, n_sys, h, w))
            u_2sub = jnp.stack([u_sub[0, :, 0], u_sub[1, :, 1]], axis=1)
            two_sub = np.asarray(ps.sweep_2d_two_sub_injected(
                jnp.asarray(spins), jg_ref, temps_j, u_2sub, shape=(h, w),
                gibbs=gibbs, interpret=True,
            ))
            np.testing.assert_array_equal(two_sub, ref)

        u_t = torch.from_numpy(u_grid)
        got, e, m = tsweep.sweep(
            torch.from_numpy(spins.reshape(n_sys, h, w)), jg,
            torch.from_numpy(TEMPS), u_t, gibbs=gibbs,
        )
        got = got.reshape(n_sys, -1).numpy()
        mismatch = got != ref
        ties = _ulp_ties(spins.reshape(n_sys, h, w), jg, torch.from_numpy(TEMPS),
                         u_t, gibbs).any(1).reshape(n_sys, -1).numpy()
        assert not (mismatch & ~ties).any(), f"step {step}: non-tie mismatch"
        assert ties.sum() == 0, f"step {step}: {ties.sum()} ulp ties"

        # fused measurement against both recompute oracles
        e_ref, m_ref = ref_energies_and_mags(jnp.asarray(got), coup_j, geom)
        e_rc, m_rc = energies_and_mags(torch.from_numpy(got), torch.from_numpy(coup),
                                       (h, w))
        np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
        np.testing.assert_array_equal(m_rc.numpy(), np.asarray(m_ref))
        if couplings == "pm":  # integer sums: exact in f32
            np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))
            np.testing.assert_array_equal(e_rc.numpy(), np.asarray(e_ref))
        else:  # the order of the f32 sums differs
            np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=1e-5)
            np.testing.assert_allclose(e_rc.numpy(), np.asarray(e_ref), rtol=1e-5)
        spins = ref.copy()


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
def test_sweep_2d_plain_matches_injected_reference(gibbs):
    """The per-sweep path's sweep (port of pallas_sweep.sweep_2d) with
    injected uniforms against sweep_2d_injected in interpret mode: four
    systems, each at its own temperature, two realizations' couplings."""
    h, w, n_sys, d = 8, 128, 4, 2
    rng = np.random.default_rng(77 + gibbs)
    coup = rng.choice([-1.0, 1.0], size=(d, h * w, 2)).astype(np.float32)
    temps = rng.permutation(np.array([1.5, 2.0, 2.269, 3.5], np.float32))
    sys_temps = np.stack([temps, temps[::-1]])  # [d, S]
    spins = rng.choice([-1, 1], size=(d, n_sys, h, w)).astype(np.int8)
    jg = tsweep.pack_coupling_grids(torch.from_numpy(coup), (h, w))
    port = torch.from_numpy(spins.copy())
    for step in range(3):
        u = rng.random((d, n_sys, 2, h, w), dtype=np.float32)
        want = []
        for r in range(d):
            with pltpu.force_tpu_interpret_mode():
                want.append(np.asarray(ps.sweep_2d_injected(
                    jnp.asarray(port[r].numpy()),
                    ps.pack_coupling_grids(jnp.asarray(coup[r]), (h, w)),
                    jnp.asarray(sys_temps[r]), jnp.asarray(u[r]),
                    shape=(h, w), gibbs=gibbs,
                )).reshape(n_sys, h, w))
        e_part, m_part = tsweep.sweep_2d_plain(
            port, jg, torch.from_numpy(sys_temps), None, gibbs=gibbs,
            measure=True, uniforms=torch.from_numpy(u))
        np.testing.assert_array_equal(port.numpy(), np.stack(want),
                                      err_msg=f"step {step}")
        # the measuring pass's partials against the recompute oracle
        for r in range(d):
            e_rc, m_rc = energies_and_mags(port[r].reshape(n_sys, -1),
                                           torch.from_numpy(coup[r]), (h, w))
            np.testing.assert_array_equal(m_part[r, :, 0].numpy(), m_rc.numpy())
            np.testing.assert_array_equal((e_part[r, :, 0] / (h * w)).numpy(),
                                          e_rc.numpy())
