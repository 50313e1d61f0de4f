"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  They cover the
mega path's kernels (colour_pass, pt_step) and the per-sweep path's
(sweep_2d and the three FK kernels).  On a machine
with a GPU (jax is not needed; ``--noconftest`` skips the JAX package's
test configuration):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Kernel and plain version run on the same CUDA tensors, so both use the
card's ``expf``: flip decisions, PT decisions and the PT bookkeeping must
agree bit for bit.  With +-J couplings every energy sum is an exact integer
in f32, so e is bitwise too; with gaussian couplings the kernel adds its
per-block partials in another order than ``torch.sum``, and e agrees to
rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch import Ising
from peapods_tpu_torch.ops import fk, mega, sweep
from peapods_tpu_torch.ops.sweep import pack_coupling_grids
from peapods_tpu_torch.ops.tempering import hot_cold_slots, init_trip_state

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _chunk_inputs(dev, seed, shape, d, n_temps, n, couplings):
    rng = np.random.default_rng(seed)
    h, w = shape
    if couplings == "pm":
        coup = rng.choice([-1.0, 1.0], size=(d, h * w, 2))
    else:
        coup = rng.standard_normal((d, h * w, 2))
    temps = np.geomspace(1.8, 3.2, n_temps).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps) for _ in range(d)]).astype(np.int32)
    hot, _ = hot_cold_slots(temps)
    sid_t = torch.from_numpy(sid).to(dev)
    n_edges = n_temps - 1
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(
        spins=torch.from_numpy(
            rng.choice([-1, 1], size=(d, n_temps, h, w)).astype(np.int8)).to(dev),
        jgrids=pack_coupling_grids(
            torch.from_numpy(coup.astype(np.float32)), shape).contiguous().to(dev),
        temps=torch.from_numpy(temps).to(dev),
        sid=sid_t,
        ea=torch.zeros((d, n_edges), **i32),
        ec=torch.zeros((d, n_edges), **i32),
        rtrips=torch.zeros((d, n_temps), **i32),
        tstate=init_trip_state(sid_t[:, None], hot),
        sweep_words=torch.from_numpy(
            rng.integers(-2**31, 2**31, (n, d, 2)).astype(np.int32)).to(dev),
        pt_words=torch.from_numpy(
            rng.integers(-2**31, 2**31, (n, d, 2)).astype(np.int32)).to(dev),
    )


@pytest.mark.parametrize(
    "shape,d,n_temps,gibbs,pt_full,pt_interval,sweep_base,couplings",
    [
        ((64, 64), 2, 5, False, False, 1, 0, "pm"),
        ((6, 10), 1, 3, True, True, 1, 0, "pm"),
        ((32, 128), 3, 6, False, True, 3, 5, "pm"),
        ((16, 48), 2, 4, True, False, 2, 1, "pm"),
        ((16, 16), 1, 4, False, False, None, 0, "gauss"),
    ],
    ids=["64-metropolis-single", "6x10-gibbs-full", "32x128-full-interval3",
         "16x48-gibbs-single-interval2", "16-gauss-no-pt"],
)
def test_mega_chunk_kernel_matches_plain(cuda, shape, d, n_temps, gibbs, pt_full,
                                         pt_interval, sweep_base, couplings):
    n = 24
    x = _chunk_inputs(cuda, 17 + d * n_temps, shape, d, n_temps, n, couplings)
    hot, cold = hot_cold_slots(x["temps"].cpu().numpy())
    kw = dict(sweep_base=sweep_base, parity=1, gibbs=gibbs,
              pt_interval=pt_interval, pt_full=pt_full, hot_slot=hot,
              cold_slot=cold)
    order = ("spins", "jgrids", "temps", "sid", "ea", "ec", "rtrips", "tstate",
             "sweep_words", "pt_words")
    k = {key: v.clone() for key, v in x.items()}
    p = {key: v.clone() for key, v in x.items()}
    mega.reset_launches()
    e_k, m_k, par_k = mega.mega_chunk(*(k[key] for key in order), **kw)
    torch.cuda.synchronize()
    assert mega.LAUNCHES == {"colour_pass": 2 * n, "pt_step": n}
    e_p, m_p, par_p = mega.mega_chunk_plain(*(p[key] for key in order), **kw)
    assert mega.LAUNCHES == {"colour_pass": 2 * n, "pt_step": n}

    for key in ("spins", "sid", "ea", "ec", "rtrips", "tstate"):
        assert torch.equal(k[key], p[key]), key
    assert par_k == par_p
    assert torch.equal(m_k, m_p)
    if couplings == "pm":
        assert torch.equal(e_k, e_p)
    else:
        torch.testing.assert_close(e_k, e_p, rtol=1e-5, atol=0)
    if pt_interval is not None:
        assert int(k["ea"].sum()) > 0


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _chunk_inputs(cuda, 3, (8, 8), 1, 3, 2, "pm")
    args = [x[k] for k in ("spins", "jgrids", "sid", "temps")]
    words = x["sweep_words"][0]
    bad = [
        (0, x["spins"].to(torch.int32)),  # dtype
        (1, x["jgrids"].transpose(-1, -2)),  # not contiguous
        (2, x["sid"].to(torch.int64)),  # dtype
        (3, x["temps"].cpu()),  # device
    ]
    mega.reset_launches()
    for i, t in bad:
        a = list(args)
        a[i] = t
        with pytest.raises(ValueError):
            mega.colour_pass(*a, words, 0, gibbs=False)
    assert mega.LAUNCHES == {"colour_pass": 0, "pt_step": 0}


def test_sample_on_card_is_deterministic_with_the_cpu_schema(cuda):
    kw = dict(pt_interval=1, pt_schedule="full_ladder")
    temps = np.geomspace(1.8, 3.2, 4).astype(np.float32)
    a = Ising((8, 16), temperatures=temps, seed=4, device="cuda")
    b = Ising((8, 16), temperatures=temps, seed=4, device="cuda")
    ra, rb = a.sample(64, **kw), b.sample(64, **kw)
    for key in ("mags", "mags2", "mags4", "energies", "energies2"):
        np.testing.assert_array_equal(ra[key], rb[key], err_msg=key)
        assert np.isfinite(ra[key]).all()
    assert torch.equal(a._sim.state["spins"], b._sim.state["spins"])
    c = Ising((8, 16), temperatures=temps, seed=4, device="cpu")
    rc = c.sample(64, **kw)

    def schema(r):
        if isinstance(r, dict):
            return {k: schema(v) for k, v in r.items()}
        return np.shape(r), np.asarray(r).dtype

    assert schema(ra) == schema(rc)
    assert a._sim.state["spins"].device.type == "cuda"


# --------------------------------------------- the per-sweep (cluster) path


def _graph_inputs(dev, seed, shape, d, n_sys, couplings="pm"):
    """Spins by system, couplings, per-system temperatures and key words of a
    flat FK graph batch (B = d * n_sys)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    b = d * n_sys
    if couplings == "pm":
        coup = rng.choice([-1.0, 1.0], size=(d, h * w, 2))
    else:
        coup = np.ones((d, h * w, 2))
    coup_t = torch.from_numpy(coup.astype(np.float32))
    temps = rng.uniform(1.5, 3.5, size=(d, n_sys)).astype(np.float32)
    kf = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
    return dict(
        spins=torch.from_numpy(
            rng.choice([-1, 1], size=(d, n_sys, h, w)).astype(np.int8)).to(dev),
        coup=coup_t.to(dev),
        jgrids=pack_coupling_grids(coup_t, shape).contiguous().to(dev),
        sys_temps=torch.from_numpy(temps).to(dev),
        words=torch.from_numpy(
            rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)).to(dev),
        kb=torch.from_numpy(
            rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)).to(dev),
        kf=kf,
    )


@pytest.mark.parametrize("shape,d,n_sys,gibbs", [
    ((256, 256), 1, 1, False), ((64, 64), 16, 8, False), ((64, 64), 16, 8, True),
], ids=["256-one-system", "64-128-systems", "64-128-systems-gibbs"])
def test_sweep_2d_kernel_matches_plain(cuda, shape, d, n_sys, gibbs):
    x = _graph_inputs(cuda, 3 + d, shape, d, n_sys)
    a, b = x["spins"].clone(), x["spins"].clone()
    sweep.LAUNCHES["sweep_2d"] = 0
    for step in range(4):
        pk = sweep.sweep_2d(a, x["jgrids"], x["sys_temps"], x["words"],
                            gibbs=gibbs, measure=step % 2 == 1)
        pp = sweep.sweep_2d_plain(b, x["jgrids"], x["sys_temps"], x["words"],
                                  gibbs=gibbs, measure=step % 2 == 1)
        torch.cuda.synchronize()
        assert torch.equal(a, b), step
        if pk is not None:
            assert torch.equal(pk[0].sum(-1), pp[0].sum(-1))
            assert torch.equal(pk[1].sum(-1), pp[1].sum(-1))
        x["words"] = x["words"] * 3 + 1
    assert sweep.LAUNCHES["sweep_2d"] == 8


@pytest.mark.parametrize("shape,d,n_sys,wolff", [
    ((256, 256), 1, 1, False), ((256, 256), 1, 1, True),
    ((64, 64), 16, 8, False), ((64, 64), 16, 8, True),
], ids=["256-sw", "256-wolff", "64-128-graphs-sw", "64-128-graphs-wolff"])
def test_fk_update_kernel_matches_plain(cuda, shape, d, n_sys, wolff):
    from peapods_tpu_torch.engine import seeds

    h, w = shape
    x = _graph_inputs(cuda, 11 + d + wolff, shape, d, n_sys, couplings="ferro")
    b = d * n_sys
    scal = torch.from_numpy(seeds.fk_scalars(x["kf"], h * w, wolff=wolff)).to(cuda)
    # near T_c, where one cluster spans the lattice
    temps = torch.full((b,), 2.269, device=cuda)
    ka, kp = x["spins"].view(b, h, w).clone(), x["spins"].view(b, h, w).clone()
    for k in fk.LAUNCHES:
        fk.LAUNCHES[k] = 0
    args = (x["coup"], temps, scal, x["kb"])
    kw = dict(wolff=wolff, with_measure=True, with_labels=True)
    ek, mk, lk = fk.fk_update(ka, *args, **kw)
    ep, mp, lp = fk.fk_update_plain(kp, *args, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {"fk_bonds": 1, "fk_link": 1, "fk_finish": 1}
    assert torch.equal(ka, kp)
    assert torch.equal(lk, lp)
    e_k, m_k = fk.fk_energy_mag(ek, mk, h * w)
    e_p, m_p = fk.fk_energy_mag(ep, mp, h * w)
    assert torch.equal(m_k, m_p)
    assert torch.equal(e_k, e_p)  # +-1 sums: exact in any order
    assert not torch.equal(ka, x["spins"].view(b, h, w))


def test_cluster_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = _graph_inputs(cuda, 5, (8, 8), 1, 2)
    with pytest.raises(ValueError):
        sweep.sweep_2d(x["spins"], x["jgrids"], x["sys_temps"].double(),
                       x["words"], gibbs=False)
    with pytest.raises(ValueError):
        fk.fk_update(x["spins"].view(2, 8, 8), x["coup"],
                     x["sys_temps"].view(-1), torch.zeros((2, 3), dtype=torch.int64,
                                                          device=cuda),
                     x["kb"], wolff=False, with_measure=True, with_labels=False)
    with pytest.raises(ValueError):  # the kernels draw their own uniforms
        sweep.sweep_2d(x["spins"], x["jgrids"], x["sys_temps"], x["words"],
                       gibbs=False, uniforms=torch.zeros(1, device=cuda))


@pytest.mark.parametrize("d,n_sys,n_blocks,pt_full", [
    (1, 1, 256, None), (128, 16, 16, False), (128, 16, 16, True),
    (1, 24, 64, False),
], ids=["config3-no-pt", "harness-single", "harness-full", "flagship-single"])
def test_pt_step_kernel_matches_plain(cuda, d, n_sys, n_blocks, pt_full):
    """The per-sweep path's and the mega path's pt_step shapes: partials by
    system, the reference's jnp-form draws, every output bitwise."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems

    rng = np.random.default_rng(d + n_sys)
    n_events = 32
    temps = torch.from_numpy(np.geomspace(1.5, 3.5, n_sys).astype(np.float32)).to(cuda)
    hot, cold = hot_cold_slots(temps.cpu().numpy())
    sid0 = torch.from_numpy(np.stack(
        [rng.permutation(n_sys) for _ in range(d)]).astype(np.int32)).to(cuda)
    # +-1 sums: integer partials, exact in any order
    e_part = torch.from_numpy(rng.integers(
        -24, 16, (d, n_sys, n_blocks)).astype(np.float32)).to(cuda)
    m_part = torch.from_numpy(rng.integers(
        -64, 64, (d, n_sys, n_blocks)).astype(np.int32)).to(cuda)
    do_pt = pt_full is not None
    draws = [None] * n_events
    if do_pt:
        keys = rng.integers(0, 2**32, (d, 2), dtype=np.uint64).astype(np.uint32)
        dr = seeds.pt_draws_jnp(keys, 5, n_events, n_sys - 1, pt_full=pt_full)
        draws = (list(torch.from_numpy(dr).to(cuda)) if pt_full else
                 list(zip(*(torch.from_numpy(a).to(cuda) for a in dr))))
    i32 = dict(dtype=torch.int32, device=cuda)
    out = []
    for fn in (mega.pt_step, mega.pt_step_plain):
        st = dict(sid=sid0.clone(), ea=torch.zeros((d, n_sys - 1), **i32),
                  ec=torch.zeros((d, n_sys - 1), **i32),
                  rt=torch.zeros((d, n_sys), **i32),
                  ts=init_trip_state(sid0[:, None], hot),
                  sys_temps=slot_temps_for_systems(sid0, temps),
                  e=torch.empty((d, n_events, n_sys), device=cuda),
                  m=torch.empty((d, n_events, n_sys), **i32), parity=1)
        for t in range(n_events):
            st["parity"] = fn(
                e_part, m_part, st["e"][:, t], st["m"][:, t], st["sid"], st["ea"],
                st["ec"], st["rt"], st["ts"], temps, draws[t], st["sys_temps"],
                do_pt=do_pt, pt_full=bool(pt_full), parity=st["parity"],
                hot_slot=hot, cold_slot=cold, n_spins=4096)
        out.append(st)
    torch.cuda.synchronize()
    k, p = out
    for key in ("sid", "ea", "ec", "rt", "ts", "sys_temps", "e", "m"):
        assert torch.equal(k[key], p[key]), key
    assert k["parity"] == p["parity"]
    if do_pt:
        assert 0 < int(k["ec"].sum()) < int(k["ea"].sum())


@pytest.mark.parametrize("mode", ["sw", "wolff"])
def test_cluster_sample_on_card_matches_the_cpu(cuda, mode):
    """The kernels on the card and the plain path on the CPU follow one
    trajectory (ferromagnet: every energy sum is an exact integer; a flip
    decision could differ only at an exp ulp tie, none expected here)."""
    kw = dict(cluster_update_interval=2, cluster_mode=mode, pt_interval=1,
              pt_schedule="full_ladder", collect_cluster_stats=True)
    temps = np.geomspace(1.8, 3.2, 3).astype(np.float32)
    a = Ising((8, 16), temperatures=temps, seed=4, n_disorder=2, device="cuda")
    c = Ising((8, 16), temperatures=temps, seed=4, n_disorder=2, device="cpu")
    ra, rc = a.sample(40, **kw), c.sample(40, **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    for key in ("mags", "mags2", "energies", "energies2"):
        np.testing.assert_array_equal(ra[key], rc[key], err_msg=key)
    np.testing.assert_array_equal(np.asarray(ra["fk_csd"]), np.asarray(rc["fk_csd"]))
