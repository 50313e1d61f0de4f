"""Port mega chunk: bitwise against the reference megakernel.

The reference's ``pallas_mega.mega_chunk`` runs here in interpret mode,
whose PRNG draws zeros (pallas_sweep.py:84-91); the port's plain
``mega_chunk_plain`` gets zero uniforms injected.  Every flip decision,
the fused (e, m), and the whole PT step (whose scalar draws come from the
real key words in both) must then agree bit for bit.  The reference keeps
spins by slot and swaps tiles; the port keeps them by system and swaps
``sid`` entries, so spins are compared through ``sid``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.ops import pallas_mega
from peapods_tpu.ops import pallas_sweep as ps
from peapods_tpu_torch.ops import mega, tempering
from peapods_tpu_torch.ops.sweep import pack_coupling_grids

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "shape,pt_full,n_inner,n_active,pt_interval,sweep_base",
    [
        ((8, 128), False, 4, 4, 1, 0),
        ((8, 128), True, 4, 4, 1, 0),
        ((8, 256), False, 4, 4, 1, 0),
        ((8, 256), True, 4, 3, 2, 5),
        ((8, 128), False, 4, 2, 1, 3),
    ],
    ids=["128-single", "128-full", "256-single", "256-full-partial",
         "128-single-partial"],
)
def test_plain_mega_chunk_matches_reference(shape, pt_full, n_inner, n_active,
                                            pt_interval, sweep_base):
    h, w = shape
    d, n_temps = 1, 3
    n_edges = n_temps - 1
    rng = np.random.default_rng(h * w + n_active + 7 * pt_full)
    temps = np.geomspace(1.8, 3.2, n_temps).astype(np.float32)
    hot, cold = tempering.hot_cold_slots(temps)
    coup = rng.choice([-1.0, 1.0], size=(d, h * w, 2)).astype(np.float32)
    spins_sys = rng.choice([-1, 1], size=(d, n_temps, h, w)).astype(np.int8)
    sid = np.stack([rng.permutation(n_temps) for _ in range(d)]).astype(np.int32)
    ea = rng.integers(0, 5, (d, n_edges)).astype(np.int32)
    ec = np.minimum(ea, rng.integers(0, 5, (d, n_edges))).astype(np.int32)
    rt = rng.integers(0, 3, (d, n_temps)).astype(np.int32)
    ts = rng.integers(0, 3, (d, n_temps)).astype(np.int32)
    parity = int(rng.integers(0, 2))
    words = rng.integers(-2**31, 2**31, (2, d, n_inner, 2)).astype(np.int32)

    spins_slot = np.take_along_axis(spins_sys, sid[:, :, None, None], axis=1)
    jg_ref = jnp.stack([ps.pack_coupling_grids(jnp.asarray(c), shape) for c in coup])
    out = pallas_mega.mega_chunk(
        jnp.asarray(spins_slot), jg_ref, jnp.asarray(temps)[None],
        jnp.asarray(words[0].reshape(d, -1)), jnp.asarray(words[1].reshape(d, -1)),
        jnp.asarray([[sweep_base, n_active]], jnp.int32), jnp.asarray(sid),
        jnp.asarray(ea), jnp.asarray(ec), jnp.asarray(rt), jnp.asarray(ts),
        jnp.full((d, 1), parity, jnp.int32),
        shape=shape, gibbs=False, n_inner=n_inner, n_temps=n_temps,
        pt_interval=pt_interval, pt_full=pt_full, hot_slot=hot,
        cold_slot=cold, interpret=True,
    )
    r_spins, r_e, r_m, r_sid, r_ea, r_ec, r_rt, r_ts, r_par = map(np.asarray, out)

    t = {k: torch.from_numpy(v.copy()) for k, v in dict(
        spins=spins_sys, sid=sid, ea=ea, ec=ec, rt=rt, ts=ts).items()}
    jg = pack_coupling_grids(torch.from_numpy(coup), shape)
    np.testing.assert_array_equal(jg.numpy(), np.asarray(jg_ref))
    sweep_w, pt_w = (torch.from_numpy(np.ascontiguousarray(
        x.transpose(1, 0, 2)[:n_active])) for x in words)
    zeros = torch.zeros((d, n_temps, h, w))
    e, m, new_parity = mega.mega_chunk_plain(
        t["spins"], jg, torch.from_numpy(temps), t["sid"], t["ea"], t["ec"],
        t["rt"], t["ts"], sweep_w, pt_w, sweep_base=sweep_base, parity=parity,
        gibbs=False, pt_interval=pt_interval, pt_full=pt_full, hot_slot=hot,
        cold_slot=cold, uniforms=lambda t_, c: zeros,
    )

    np.testing.assert_array_equal(e.numpy(), r_e[:, :n_active])
    np.testing.assert_array_equal(m.numpy(), r_m[:, :n_active])
    assert not r_e[:, n_active:].any() and not r_m[:, n_active:].any()
    np.testing.assert_array_equal(t["sid"].numpy(), r_sid)
    np.testing.assert_array_equal(t["ea"].numpy(), r_ea)
    np.testing.assert_array_equal(t["ec"].numpy(), r_ec)
    np.testing.assert_array_equal(t["rt"].numpy(), r_rt)
    np.testing.assert_array_equal(t["ts"].numpy(), r_ts)
    assert new_parity == int(r_par[0, 0])
    got_slot = np.take_along_axis(t["spins"].numpy(), r_sid[:, :, None, None], 1)
    np.testing.assert_array_equal(got_slot, r_spins)
    assert (r_ea.sum() - ea.sum()) > 0  # the chunk did attempt swaps


def test_scalar_draws_match_reference():
    rng = np.random.default_rng(11)
    n = 10_000
    w0 = rng.integers(-2**31, 2**31, n).astype(np.int32)
    w1 = rng.integers(-2**31, 2**31, n).astype(np.int32)
    w0[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    salts = np.arange(n, dtype=np.int32)
    tw0, tw1, ts = map(torch.from_numpy, (w0, w1, salts))
    jw0, jw1, js = map(jnp.asarray, (w0, w1, salts))
    np.testing.assert_array_equal(
        tempering.scalar_uniform(tw0, tw1, ts).numpy(),
        np.asarray(pallas_mega._scalar_uniform(jw0, jw1, js)),
    )
    for n_edges in (1, 3, 23):
        np.testing.assert_array_equal(
            tempering.scalar_randint(tw0, tw1, ts, n_edges).numpy(),
            np.asarray(pallas_mega._scalar_randint(jw0, jw1, js, n_edges)),
        )


def test_dispatch_and_gate():
    from peapods_tpu_torch.ops.lattice import Lattice

    assert mega.supports_mega(Lattice((4, 6)), 1)
    assert not mega.supports_mega(Lattice((4, 6)), 2)
    for bad in ((5, 4), (4, 4, 4), (4,)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Lattice(bad)
    # CPU tensors take the plain version and count no kernel launch
    mega.reset_launches()
    spins = torch.ones((1, 2, 4, 4), dtype=torch.int8)
    jg = torch.ones((1, 4, 4, 4))
    sid = torch.tensor([[1, 0]], dtype=torch.int32)
    temps = torch.tensor([2.0, 3.0])
    words = torch.zeros((1, 2), dtype=torch.int32)
    e_part, m_part = mega.colour_pass(spins, jg, sid, temps, words, 1, gibbs=False)
    assert e_part.shape == (1, 2, 1) and m_part.dtype == torch.int32
    assert mega.LAUNCHES == {"colour_pass": 0, "pt_step": 0}
    with pytest.raises(ValueError, match="not supported"):
        mega.colour_pass(spins.to("meta"), jg, sid, temps, words, 0, gibbs=False)
