"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  They cover the
mega path's kernels (colour_pass, pt_step), the per-sweep path's
(sweep_2d and the three FK kernels) and the replica path's (colour_pass in
3D, pt_step on R ladders, pair_overlap, the ov_* overlap-move kernels and
energy_partials), the coloured lattices' (sweep_nb, measure_nb and the
FK kernels with three bond directions), FK observe's and the staged
path's (cc_link / cc_label, winding, fk_finish in observe form,
fk_bonds_nb and fk_finish reading labels) and Houdayer(N)'s (houdn_bonds,
houdn_finish) with the overlap moves' labels, masks and observe form.  On a machine
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
from peapods_tpu_torch.ops import _build, fk, mega, sweep
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
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fk_bonds": 1, **fk.link_launches(shape, b), "fk_finish": 1}
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


@pytest.mark.parametrize("d,n_sys,n_blocks,pt_full", [
    (1, 4, 65536, False), (1, 4, 65536, True), (128, 16, 16, False),
    (128, 16, 16, True), (2, 5, 700, False), (3, 7, 3, True),
], ids=["4096-bands-single", "4096-bands-full", "harness-single", "harness-full",
        "split-ragged", "short-odd"])
def test_pt_step_kernel_adds_gaussian_partials_in_the_plain_order(cuda, d, n_sys,
                                                                  n_blocks, pt_full):
    """Non-integer partials, whose sum depends on the order: the e rows and
    every PT output bitwise pt_step_plain, over 24 events in a row from one
    start state (at 65,536 and 700 partials a row is split over CTAs, and
    each launch finds the tickets the last one left at zero)."""
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems
    from peapods_tpu_torch.ops.tempering import pt_draws

    rng = np.random.default_rng(n_blocks + n_sys)
    n_events = 24
    temps = torch.from_numpy(np.geomspace(1.5, 3.5, n_sys).astype(np.float32)).to(cuda)
    hot, cold = hot_cold_slots(temps.cpu().numpy())
    sid0 = torch.from_numpy(np.stack(
        [rng.permutation(n_sys) for _ in range(d)]).astype(np.int32)).to(cuda)
    e_part = torch.from_numpy((rng.standard_normal((d, n_sys, n_blocks)) * 37).astype(
        np.float32)).to(cuda)
    m_part = torch.from_numpy(rng.integers(
        -64, 64, (d, n_sys, n_blocks)).astype(np.int32)).to(cuda)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (n_events, d, 2)).astype(
        np.int32)).to(cuda)
    dr = pt_draws(words, n_sys - 1, pt_full=pt_full)
    draws = list(dr) if pt_full else list(zip(dr[0].to(torch.int32), dr[1]))
    i32 = dict(dtype=torch.int32, device=cuda)
    mega.LAUNCHES["pt_step"] = 0
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
                do_pt=True, pt_full=pt_full, parity=st["parity"], hot_slot=hot,
                cold_slot=cold, n_spins=n_blocks * 256)
        out.append(st)
    torch.cuda.synchronize()
    assert mega.LAUNCHES["pt_step"] == n_events
    k, p = out
    for key in ("sid", "ea", "ec", "rt", "ts", "sys_temps", "e", "m"):
        assert torch.equal(k[key], p[key]), key
    assert k["parity"] == p["parity"]
    assert 0 < int(k["ec"].sum()) < int(k["ea"].sum())
    # the order is not torch.sum's: the rows would differ somewhere
    by_slot = e_part.gather(1, k["sid"].long()[..., None].expand(d, n_sys, n_blocks))
    if n_blocks == 65536:
        assert not torch.equal(by_slot.sum(-1), mega.ordered_partial_sum(
            by_slot, mega.pt_split(n_blocks)))


def _link_graphs(dev, shape, b, density, seed):
    """State bytes of ``b`` bond graphs of ``shape`` (bits above the bonds
    set at random, as fk_bonds' "s differs" bits) and their bool bonds: none,
    all, or each bond with probability ``density`` (None: an FK state near
    T_c, fk_bonds on random spins)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    tri = shape == (32, 32)
    n_dirs = 3 if (tri or len(shape) == 3) else 2
    if density is None:
        d = 1
        coup = torch.ones((d, n, n_dirs), device=dev)
        t_c = {2: 2.269, 3: 4.51}[len(shape)] if not tri else 3.64
        spins = torch.from_numpy(rng.choice([-1, 1], size=(b, *shape)).astype(
            np.int8)).to(dev)
        kb = torch.from_numpy(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)).to(dev)
        bonds = fk.fk_bonds_plain(spins, coup, torch.full((b,), t_c, device=dev), kb)
    else:
        bonds = torch.from_numpy(rng.random((b, n, n_dirs)) < density).to(dev)
    bits = torch.arange(n_dirs, device=dev, dtype=torch.uint8)
    state = (bonds.to(torch.uint8) << bits).sum(-1).to(torch.uint8)
    state |= torch.from_numpy(rng.integers(0, 8, (b, n)).astype(np.uint8)).to(dev) << 3
    return state, bonds, tri


LINK_SHAPES = [((64, 64), 2048), ((256, 256), 1), ((32, 32, 32), 4), ((32, 32), 8),
               ((8, 8, 8), 256)]


@pytest.mark.parametrize("density", [0.0, 1.0, None], ids=["none", "all", "t_c"])
@pytest.mark.parametrize("shape,b", LINK_SHAPES,
                         ids=["harness", "256", "cubic-32", "tri-32", "cubic-8-x256"])
def test_fk_link_forms_match_plain(cuda, shape, b, density):
    """The labelling in each form that takes the shape (the plan's; the
    tiled form with other tiles; the whole-graph form where a graph fits a
    CTA): every parent its component's minimum site, bitwise fk_link_plain,
    whatever the parents held before; the whole-graph form's in one launch,
    with parent[parent[i]] == parent[i] <= i."""
    state, bonds, tri = _link_graphs(cuda, shape, b, density, len(shape) + b)
    want = fk.fk_link_plain(bonds, shape)
    dims = _build.dims3(shape)
    n = int(np.prod(shape))
    plan = fk.link_plan(dims, b)
    plans = {"plan": plan}
    for sites in (4096, 512):
        tile = fk._link_tile(dims, sites)
        if tile != dims:
            plans[f"tiled-{sites}"] = fk.LinkPlan(tile, 1024, True)
    if n <= fk.LINK_TILE_SITES:
        plans["whole-512"] = fk.LinkPlan(dims, 512, False)
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    sites = torch.arange(n, device=cuda)
    for name, p in plans.items():
        parent = torch.full((b, n), -7, dtype=torch.int32, device=cuda)
        for k in fk.LAUNCHES:
            fk.LAUNCHES[k] = 0
        fk.launch_link(lib, stream, state.data_ptr(), parent.data_ptr(), b, *dims, tri,
                       plan=p)
        torch.cuda.synchronize()
        assert torch.equal(parent, want), name
        assert {k: v for k, v in fk.LAUNCHES.items() if v} == dict.fromkeys(
            ("fk_link", "fk_link_border", "fk_link_flatten") if p.tiled else ("fk_link",),
            1), name
        if not p.tiled:
            assert bool((parent.gather(1, parent.long()) == parent).all())
            assert bool((parent <= sites).all())


@pytest.mark.parametrize("shape,b", [((256, 256), 1), ((32, 32, 32), 4)],
                         ids=["256", "cubic-32"])
def test_fk_link_tiled_launches_match_their_plain_versions(cuda, shape, b):
    """The tiled form one launch at a time near T_c: the link's parents are
    each site's tile-component minimum (fk_link_tiles_plain); the border's
    lead to the labels; the flatten's are the labels."""
    state, bonds, tri = _link_graphs(cuda, shape, b, None, 3)
    dims = _build.dims3(shape)
    n = int(np.prod(shape))
    plan = fk.link_plan(dims, b)
    assert plan.tiled
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    parent = torch.full((b, n), -1, dtype=torch.int32, device=cuda)
    sp, pp = state.data_ptr(), parent.data_ptr()
    assert lib.peapods_fk_link(sp, pp, b, *dims, int(tri), *plan.tile, plan.threads,
                               stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(parent, fk.fk_link_tiles_plain(bonds, shape, plan.tile))
    assert lib.peapods_fk_link_border(sp, pp, b, *dims, int(tri), *plan.tile, stream) == 0
    torch.cuda.synchronize()
    crossed = parent.clone()
    labels = fk.fk_link_plain(bonds, shape)
    assert torch.equal(fk.fk_link_flatten_plain(crossed), labels)
    assert not torch.equal(crossed, labels)  # the flatten has work to do
    assert lib.peapods_fk_link_flatten(pp, b, n, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(parent, labels)


def test_fk_link_rejects_tiles_it_does_not_take(cuda):
    lib = _build.library()
    st = torch.zeros((1, 64 * 64), dtype=torch.uint8, device=cuda)
    par = torch.zeros((1, 64 * 64), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for tile, threads in (((128, 64, 1), 1024), ((64, 64, 4), 1024), ((32, 32, 1), 16),
                          ((64, 64, 1), 2048)):
        assert lib.peapods_fk_link(st.data_ptr(), par.data_ptr(), 1, 64, 64, 1, 0,
                                   *tile, threads, stream) != 0


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
def test_overlap_moves_through_the_tiled_labelling_match_plain(cuda, kind, monkeypatch):
    """The overlap moves find their clusters with find_root on the
    labelling's parents: with the tiled form forced on their 8^3 graphs
    (flattened parents) every move is still bitwise its plain version."""
    from peapods_tpu_torch.ops import overlap

    shape, d, n_rep, n_temps = (8, 8, 8), 2, 4, 6
    plan = fk.LinkPlan((4, 4, 8), 1024, True)
    monkeypatch.setattr(fk, "link_plan", lambda dims, b: plan)
    x = _pair_inputs(cuda, 17, shape, d, n_rep, n_temps)
    n = int(np.prod(shape))
    tab = _event_inputs(x, d, n_rep, n_temps, n, kind, False, 7)
    a, b = x["spins"].clone(), x["spins"].clone()
    for k in fk.LAUNCHES:
        fk.LAUNCHES[k] = 0
    kw = dict(kind=kind, wolff=False, shape=shape, with_labels=True)
    lk = overlap.overlap_event(a, x["sid"], tab[0], x["coup"], x["temps"], *tab[1:], **kw)
    lp = overlap.overlap_event_plain(b, x["sid"], tab[0], x["coup"], x["temps"],
                                     *tab[1:], **kw)
    torch.cuda.synchronize()
    links = 2 if kind == "cmr" else 1
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == dict.fromkeys(
        ("fk_link", "fk_link_border", "fk_link_flatten"), links)
    assert torch.equal(a, b)
    assert torch.equal(lk[0], lp[0])
    if kind == "cmr":
        assert torch.equal(lk[1], lp[1])


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


# --------------------------------------------- the replica path


def _pair_inputs(dev, seed, shape, d, n_rep, n_temps, couplings="pm"):
    """Spins by system, grids, couplings, temperatures and sid of a replica
    path batch (n_slots = n_rep * n_temps per realization)."""
    from peapods_tpu_torch.ops.tempering import init_trip_state as its

    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    nd = len(shape)
    s = n_rep * n_temps
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nd)) if couplings == "pm"
            else rng.standard_normal((d, n, nd))).astype(np.float32)
    coup_t = torch.from_numpy(coup)
    temps = np.geomspace(0.9, 2.2, n_temps).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(
        n_rep)[:, None] for _ in range(d)]).reshape(d, s).astype(np.int32)
    sid_t = torch.from_numpy(sid).to(dev)
    hot, _ = hot_cold_slots(temps)
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(
        spins=torch.from_numpy(rng.choice([-1, 1], size=(d, s, n)).astype(np.int8)).to(dev),
        coup=coup_t.to(dev),
        jgrids=pack_coupling_grids(coup_t, shape).contiguous().to(dev),
        temps=torch.from_numpy(temps).to(dev),
        slot_temps=torch.from_numpy(np.tile(temps, n_rep)).to(dev),
        sid=sid_t,
        ea=torch.zeros((d, n_temps - 1), **i32),
        ec=torch.zeros((d, n_temps - 1), **i32),
        rtrips=torch.zeros((d, s), **i32),
        tstate=its(sid_t.view(d, n_rep, n_temps), hot),
        rng=rng,
    )


@pytest.mark.parametrize("shape,d,n_rep,n_temps,gibbs,couplings", [
    ((8, 8, 8), 8, 4, 24, False, "pm"), ((16, 16, 16), 2, 4, 6, True, "pm"),
    ((8, 64), 2, 2, 3, False, "pm"), ((6, 4, 10), 1, 2, 3, False, "gauss"),
], ids=["8cube-config4", "16cube-gibbs", "2d-8x64", "6x4x10-gauss"])
def test_colour_pass_3d_kernel_matches_plain(cuda, shape, d, n_rep, n_temps, gibbs,
                                             couplings):
    x = _pair_inputs(cuda, 5, shape, d, n_rep, n_temps, couplings)
    s = n_rep * n_temps
    a = x["spins"].view(d, s, *shape).clone()
    b = a.clone()
    words = torch.from_numpy(x["rng"].integers(-2**31, 2**31, (d, 2)).astype(
        np.int32)).to(cuda)
    args = (x["jgrids"], x["sid"], x["slot_temps"])
    for colour in (0, 1, 0, 1):
        pk = mega.colour_pass(a, *args, words, colour, gibbs=gibbs)
        pp = mega.colour_pass_plain(b, *args, words, colour, gibbs=gibbs)
        torch.cuda.synchronize()
        assert torch.equal(a, b), colour
        if pk is not None:
            assert torch.equal(pk[1].sum(-1), pp[1].sum(-1))
            if couplings == "pm":
                assert torch.equal(pk[0].sum(-1), pp[0].sum(-1))
            else:  # partials added in another order
                torch.testing.assert_close(pk[0].sum(-1), pp[0].sum(-1),
                                           rtol=1e-5, atol=1e-4)
        words = words * 3 + 1
    assert not torch.equal(a, x["spins"].view(d, s, *shape))


@pytest.mark.parametrize("shape,d,n_rep,n_temps", [
    ((8, 8, 8), 8, 4, 24), ((16, 16, 16), 8, 4, 24), ((8, 64), 3, 3, 4),
], ids=["config4", "config5", "2d-odd-R"])
def test_pair_overlap_kernel_matches_plain(cuda, shape, d, n_rep, n_temps):
    from peapods_tpu_torch.ops import megapair

    x = _pair_inputs(cuda, 7, shape, d, n_rep, n_temps)
    cols = (n_rep // 2) * n_temps
    qs = torch.empty((d, 3, cols), dtype=torch.int32, device=cuda)
    ql = torch.empty_like(qs)
    megapair.LAUNCHES["pair_overlap"] = 0
    megapair.pair_overlap(x["spins"], x["sid"], qs[:, 1], ql[:, 1], shape=shape,
                          n_replicas=n_rep)
    torch.cuda.synchronize()
    assert megapair.LAUNCHES["pair_overlap"] == 1
    ps, pl = megapair.pair_overlap_plain(x["spins"], x["sid"], shape, n_rep)
    assert torch.equal(qs[:, 1], ps)
    assert torch.equal(ql[:, 1], pl)


@pytest.mark.parametrize("n_rep,pt_full", [(4, False), (4, True), (1, True)],
                         ids=["R4-single", "R4-full", "R1-full"])
def test_pt_step_ladders_kernel_matches_plain(cuda, n_rep, pt_full):
    """pt_step on R ladders with the replica path's draws: every output
    bitwise, over 48 events from one start state."""
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems
    from peapods_tpu_torch.ops.tempering import pt_draws_pairs

    d, n_temps, n_blocks = 8, 24, 4
    x = _pair_inputs(cuda, 11 + n_rep, (8, 8, 8), d, n_rep, n_temps)
    rng = x["rng"]
    s = n_rep * n_temps
    hot, cold = hot_cold_slots(x["temps"].cpu().numpy())
    e_part = torch.from_numpy(rng.integers(-300, 100, (d, s, n_blocks)).astype(
        np.float32)).to(cuda)
    m_part = torch.from_numpy(rng.integers(-64, 64, (d, s, n_blocks)).astype(
        np.int32)).to(cuda)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (48, d, 2)).astype(
        np.int32)).to(cuda)
    dr = pt_draws_pairs(words, n_rep, n_temps - 1, pt_full=pt_full)
    if not pt_full:
        dr = (dr[0].to(torch.int32), dr[1])
    # the spins' energies move with them: other partials at every event
    parts = [e_part.roll(t, 1) for t in range(48)]
    out = []
    for fn in (mega.pt_step, mega.pt_step_plain):
        st = {k: x[k].clone() for k in ("sid", "ea", "ec", "rtrips", "tstate")}
        st.update(sys_temps=slot_temps_for_systems(x["sid"], x["slot_temps"]),
                  e=torch.empty((d, 48, s), device=cuda),
                  m=torch.empty((d, 48, s), dtype=torch.int32, device=cuda),
                  parity=1)
        for t in range(48):
            draws = tuple(a[t] for a in dr) if not pt_full else dr[t]
            st["parity"] = fn(
                parts[t], m_part, st["e"][:, t], st["m"][:, t], st["sid"],
                st["ea"], st["ec"], st["rtrips"], st["tstate"], x["slot_temps"],
                draws, st["sys_temps"], do_pt=True, pt_full=pt_full,
                parity=st["parity"], hot_slot=hot, cold_slot=cold, n_spins=512,
                n_replicas=n_rep)
        out.append(st)
    torch.cuda.synchronize()
    k, p = out
    for key in ("sid", "ea", "ec", "rtrips", "tstate", "sys_temps", "e", "m"):
        assert torch.equal(k[key], p[key]), key
    assert k["parity"] == p["parity"]
    assert 0 < int(k["ec"].sum()) < int(k["ea"].sum())


def _event_inputs(x, d, n_rep, n_temps, n, kind, wolff, seed, g=2):
    from peapods_tpu_torch.engine import seeds

    keys = np.random.default_rng(seed).integers(0, 2**32, (d, 2), dtype=np.uint64)
    tasks, tkeys = seeds.overlap_tasks(keys.astype(np.uint32), [seed], n_rep, n_temps,
                                       g)
    scal, probes = seeds.event_scalars(kind, wolff, tkeys[0], n)
    dev = x["spins"].device
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (up(tasks[0]), up(scal.reshape(-1, 6)), up(probes.reshape(-1, 64)),
            up(tkeys[0].view(np.int32).reshape(-1, 2)))


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("shape,d,n_rep,n_temps", [
    ((8, 8, 8), 8, 4, 24), ((8, 64), 2, 2, 3),
], ids=["config4", "2d"])
def test_overlap_event_kernel_matches_plain(cuda, shape, d, n_rep, n_temps, kind,
                                            wolff):
    """One move of every task: spins and labels (CMR: grey and blue)
    bitwise; Houdayer (through the houdn_* kernels) keeps E_a + E_b of
    every task."""
    from peapods_tpu_torch.ops import fk, overlap
    from peapods_tpu_torch.ops.energy import bond_sums

    x = _pair_inputs(cuda, 13, shape, d, n_rep, n_temps)
    n = int(np.prod(shape))
    tab = _event_inputs(x, d, n_rep, n_temps, n, kind, wolff, 5)
    a, b = x["spins"].clone(), x["spins"].clone()
    for k in overlap.LAUNCHES:
        overlap.LAUNCHES[k] = 0
    fk.LAUNCHES["fk_link"] = 0
    kw = dict(kind=kind, wolff=wolff, shape=shape, with_labels=True)
    lk = overlap.overlap_event(a, x["sid"], tab[0], x["coup"], x["temps"], *tab[1:], **kw)
    lp = overlap.overlap_event_plain(b, x["sid"], tab[0], x["coup"], x["temps"],
                                     *tab[1:], **kw)
    torch.cuda.synchronize()
    finish = "houdn_finish" if kind == "houdayer" else "ov_finish"
    assert overlap.LAUNCHES[finish] == 1
    assert overlap.LAUNCHES["houdn_finish"] + overlap.LAUNCHES["ov_finish"] == 1
    assert fk.LAUNCHES["fk_link"] == (2 if kind == "cmr" else 1)  # CMR: blue, grey
    assert torch.equal(a, b)
    assert torch.equal(lk[0], lp[0])
    if kind == "cmr":
        assert torch.equal(lk[1], lp[1])
    assert not torch.equal(a, x["spins"])
    if kind == "houdayer":
        sys, _, _ = overlap.gather_tasks(x["spins"], x["sid"], tab[0], n_temps)
        di = torch.arange(d, device=cuda)[:, None, None]
        e0 = bond_sums(x["spins"], x["coup"][:, None], shape)
        e1 = bond_sums(a, x["coup"][:, None], shape)
        pair = lambda e: e[di, sys[..., 0]] + e[di, sys[..., 1]]  # noqa: E731
        assert torch.equal(pair(e0), pair(e1))


def test_energy_partials_kernel_matches_plain(cuda):
    from peapods_tpu_torch.ops import overlap

    for shape in ((8, 8, 8), (16, 16, 16), (8, 64)):
        x = _pair_inputs(cuda, 17, shape, 4, 4, 6)
        ek, mk = overlap.energy_partials(x["spins"], x["coup"], shape)
        ep, mp = overlap.energy_partials_plain(x["spins"], x["coup"], shape)
        assert torch.equal(ek.sum(-1), ep.sum(-1))  # +-1 sums: exact
        assert torch.equal(mk.sum(-1), mp.sum(-1))


@pytest.mark.parametrize("shape,build,wolff,pt_full", [
    ((8, 8, 8), "houdayer", True, False), ((8, 8, 8), "jorg+cmr", False, True),
    ((16, 16, 16), "jorg+cmr", True, True), ((8, 64), "cmr", False, False),
], ids=["8cube-houdayer", "8cube-jorg+cmr-sw-full", "16cube-jorg+cmr-full",
        "2d-cmr-sw"])
def test_replica_sample_on_card_matches_the_cpu(cuda, shape, build, wolff, pt_full):
    """The replica path's kernels on the card and its plain version on the
    CPU follow one trajectory (+-J: every energy sum is an exact integer; a
    decision could differ only at an exp ulp tie, none expected here)."""
    from peapods_tpu_torch.ops import megapair, overlap

    kw = dict(pt_interval=1, pt_schedule="full_ladder" if pt_full else
              "single_random_edge", overlap_cluster_update_interval=3,
              overlap_cluster_build_mode=build,
              overlap_cluster_mode="wolff" if wolff else "sw")
    temps = np.geomspace(0.9, 2.2, 4).astype(np.float32)
    a = Ising(shape, couplings="bimodal", temperatures=temps, n_replicas=4,
              n_disorder=2, seed=4, device="cuda")
    c = Ising(shape, couplings="bimodal", temperatures=temps, n_replicas=4,
              n_disorder=2, seed=4, device="cpu")
    megapair.LAUNCHES["pair_overlap"] = 0
    finish = "houdn_finish" if build == "houdayer" else "ov_finish"
    overlap.LAUNCHES[finish] = 0
    ra, rc = a.sample(24, **kw), c.sample(24, **kw)
    assert megapair.LAUNCHES["pair_overlap"] == 24
    assert overlap.LAUNCHES[finish] == 8
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    # float64 record sums, reduced in another order on each device
    for key in ("mags", "mags2", "energies", "energies2", "overlap", "overlap2",
                "link_overlap", "ql_at_q_sum"):
        np.testing.assert_allclose(ra[key], rc[key], rtol=1e-12, err_msg=key)
    np.testing.assert_array_equal(np.asarray(ra["overlap_histogram"]),
                                  np.asarray(rc["overlap_histogram"]))


# --------------------------------------------- the coloured lattices

NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
NB_SHAPES = [
    ("config2-tri", (32, 32), "triangular", 1, 8),
    ("cubic-32", (32, 32, 32), None, 1, 16),
    ("bcc-16", (16, 16, 16), "bcc", 1, 8),
    ("fcc-16", (16, 16, 16), "fcc", 1, 8),
    ("nnn-64", (64, 64), NNN, 1, 8),
    ("fcc-2x2x4", (2, 2, 4), "fcc", 2, 3),
    ("tri-6x10", (6, 10), "tri", 3, 5),
]


def _nb_inputs(dev, seed, shape, geometry, d, n_sys, couplings="pm"):
    """A coloured lattice's sweep inputs: couplings and their backward twins
    [d, n, n_nb], the colour table, spins [d, S, n], temperatures, words."""
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

    offsets = GEOMETRY_OFFSETS[geometry] if isinstance(geometry, str) else geometry
    lat = Lattice(shape, offsets)
    rng = np.random.default_rng(seed)
    n, nb = lat.n_spins, lat.n_neighbors
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nb)) if couplings == "pm"
            else rng.standard_normal((d, n, nb))).astype(np.float32)
    coup_bwd = coup[:, lat.bwd, np.arange(nb)[None, :]]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return lat, dict(
        spins=up(rng.choice([-1, 1], size=(d, n_sys, n)).astype(np.int8)),
        coup=up(coup), coup_bwd=up(coup_bwd),
        colours=up(lat.colors.astype(np.uint8)),
        sys_temps=up(rng.uniform(1.5, 9.0, (d, n_sys)).astype(np.float32)),
        words=up(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)))


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,geometry,d,n_sys", NB_SHAPES,
                         ids=[s[0] for s in NB_SHAPES])
def test_sweep_nb_and_measure_nb_kernels_match_plain(cuda, name, shape, geometry, d,
                                                     n_sys, gibbs):
    """Four sweeps, each colour a launch: spins bitwise; the (e, m) partial
    sums bitwise (+-1 couplings: exact integers in any order)."""
    from peapods_tpu_torch.ops import energy

    lat, x = _nb_inputs(cuda, 3 + d + n_sys, shape, geometry, d, n_sys)
    a, b = x["spins"].clone(), x["spins"].clone()
    args = (x["coup"], x["coup_bwd"], x["colours"], x["sys_temps"])
    sweep.LAUNCHES["sweep_nb"] = 0
    energy.LAUNCHES["measure_nb"] = 0
    for step in range(4):
        sweep.sweep_nb(a, *args, x["words"], lat, gibbs=gibbs)
        sweep.sweep_nb_plain(b, *args, x["words"], lat, gibbs=gibbs)
        ek, mk = energy.measure_nb(a, x["coup"], lat)
        ep, mp = energy.measure_nb_plain(b, x["coup"], lat)
        torch.cuda.synchronize()
        assert torch.equal(a, b), step
        assert torch.equal(ek.sum(-1), ep.sum(-1)), step
        assert torch.equal(mk.sum(-1), mp.sum(-1)), step
        x["words"] = x["words"] * 3 + 1
    assert sweep.LAUNCHES["sweep_nb"] == 4 * lat.n_colors
    assert energy.LAUNCHES["measure_nb"] == 4
    assert not torch.equal(a, x["spins"])


def test_sweep_nb_gaussian_couplings_match_plain(cuda):
    """Gaussian couplings on FCC: spins bitwise (the field adds its terms in
    the plain version's order), e to rtol 1e-5 (partials in another
    order)."""
    from peapods_tpu_torch.ops import energy

    lat, x = _nb_inputs(cuda, 9, (8, 8, 8), "fcc", 2, 4, couplings="gauss")
    a, b = x["spins"].clone(), x["spins"].clone()
    args = (x["coup"], x["coup_bwd"], x["colours"], x["sys_temps"], x["words"], lat)
    for gibbs in (False, True):
        sweep.sweep_nb(a, *args, gibbs=gibbs)
        sweep.sweep_nb_plain(b, *args, gibbs=gibbs)
    ek, mk = energy.measure_nb(a, x["coup"], lat)
    ep, mp = energy.measure_nb_plain(b, x["coup"], lat)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(mk.sum(-1), mp.sum(-1))
    torch.testing.assert_close(ek.sum(-1), ep.sum(-1), rtol=1e-5, atol=1e-4)


def test_sweep_nb_rejects_what_the_kernel_does_not_take(cuda):
    lat, x = _nb_inputs(cuda, 5, (8, 8), "tri", 1, 2)
    args = (x["coup"], x["coup_bwd"], x["colours"])
    with pytest.raises(ValueError):  # the kernel draws its own uniforms
        sweep.sweep_nb(x["spins"], *args, x["sys_temps"], x["words"], lat,
                       gibbs=False, uniforms=torch.zeros(1, device=cuda))
    with pytest.raises(ValueError):
        sweep.sweep_nb(x["spins"], *args, x["sys_temps"].double(), x["words"], lat,
                       gibbs=False)
    with pytest.raises(ValueError):
        sweep.sweep_nb(x["spins"], x["coup"][..., :2].contiguous(), *args[1:],
                       x["sys_temps"], x["words"], lat, gibbs=False)


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("shape,d,n_sys,temp", [
    ((32, 32), 1, 8, 3.64), ((8, 16), 2, 3, 3.64), ((32, 32, 32), 1, 4, 4.51),
    ((8, 8, 8), 2, 3, 4.51),
], ids=["config2-tri", "tri-8x16", "cubic-32", "cubic-8"])
def test_fk_update_three_directions_kernel_matches_plain(cuda, shape, d, n_sys, temp,
                                                         wolff):
    """The FK kernels with three bond directions (the triangular lattice's
    [1, -1], or z) near T_c: spins, labels, m and e bitwise (+-1)."""
    from peapods_tpu_torch.engine import seeds

    rng = np.random.default_rng(len(shape) + d + wolff)
    b, n = d * n_sys, int(np.prod(shape))
    coup = torch.from_numpy(rng.choice([-1.0, 1.0], size=(d, n, 3)).astype(
        np.float32)).to(cuda)
    kf = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
    scal = torch.from_numpy(seeds.fk_scalars(kf, n, wolff=wolff)).to(cuda)
    kb = torch.from_numpy(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)).to(cuda)
    temps = torch.full((b,), temp, device=cuda)
    s0 = torch.from_numpy(rng.choice([-1, 1], size=(b, *shape)).astype(np.int8)).to(cuda)
    ka, kp = s0.clone(), s0.clone()
    for k in fk.LAUNCHES:
        fk.LAUNCHES[k] = 0
    kw = dict(wolff=wolff, with_measure=True, with_labels=True)
    ek, mk, lk = fk.fk_update(ka, coup, temps, scal, kb, **kw)
    ep, mp, lp = fk.fk_update_plain(kp, coup, temps, scal, kb, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fk_bonds": 1, **fk.link_launches(shape, b), "fk_finish": 1}
    assert torch.equal(ka, kp)
    assert torch.equal(lk, lp)
    e_k, m_k = fk.fk_energy_mag(ek, mk, n)
    e_p, m_p = fk.fk_energy_mag(ep, mp, n)
    assert torch.equal(m_k, m_p)
    assert torch.equal(e_k, e_p)
    assert not torch.equal(ka, s0)


@pytest.mark.parametrize("shape,geometry,couplings,kw", [
    ((8, 16), "triangular", "bimodal",
     dict(cluster_update_interval=2, cluster_mode="wolff", pt_interval=1,
          collect_cluster_stats=True)),
    ((8, 8, 8), None, "bimodal",
     dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1,
          pt_schedule="full_ladder")),
    ((4, 4, 8), "fcc", "bimodal", dict(pt_interval=1, sweep_mode="gibbs")),
    ((8, 8), NNN, "ferro", dict(pt_interval=2)),
], ids=["tri-wolff", "cubic-sw-full", "fcc-gibbs", "nnn"])
def test_geometry_sample_on_card_matches_the_cpu(cuda, shape, geometry, couplings, kw):
    """The per-sweep path on a coloured lattice: the kernels on the card and
    the plain path on the CPU follow one trajectory (+-1 couplings: every
    energy sum is an exact integer)."""
    geo = dict(geometry=geometry) if isinstance(geometry, str) else dict(
        neighbor_offsets=geometry)
    temps = np.geomspace(3.0, 6.0, 3).astype(np.float32)
    a = Ising(shape, couplings=couplings, temperatures=temps, seed=4, n_disorder=2,
              device="cuda", **geo)
    c = Ising(shape, couplings=couplings, temperatures=temps, seed=4, n_disorder=2,
              device="cpu", **geo)
    ra, rc = a.sample(40, **kw), c.sample(40, **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    for key in ("mags", "mags2", "energies", "energies2"):
        np.testing.assert_allclose(ra[key], rc[key], rtol=1e-12, err_msg=key)
    if "fk_csd" in rc:
        np.testing.assert_array_equal(np.asarray(ra["fk_csd"]), np.asarray(rc["fk_csd"]))


# --------------------------------------------- FK observe and the staged path


STAGED = [("bcc-16", (16, 16, 16), "bcc", 1, 8, 6.3), ("fcc-8", (8, 8, 8), "fcc", 2, 4, 9.8),
          ("nnn-64", (64, 64), NNN, 1, 8, 5.3), ("nnn-2x8", (2, 8), NNN, 2, 3, 5.0),
          ("self-bond-2x8", (2, 8), [[1, 0], [0, 1], [2, 0]], 2, 3, 4.0)]


def _staged_inputs(dev, seed, shape, geometry, d, n_sys, temp):
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

    offsets = GEOMETRY_OFFSETS[geometry] if isinstance(geometry, str) else geometry
    lat = Lattice(shape, offsets)
    rng = np.random.default_rng(seed)
    b, n, nb = d * n_sys, lat.n_spins, lat.n_neighbors
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return lat, dict(
        spins=up(rng.choice([-1, 1], size=(b, *shape)).astype(np.int8)),
        coup=up(rng.choice([-1.0, 1.0], size=(d, n, nb)).astype(np.float32)),
        temps=up(rng.uniform(0.8 * temp, 1.2 * temp, b).astype(np.float32)),
        kf=rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32),
        kb=up(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)))


@pytest.mark.parametrize("name,shape,geometry,d,n_sys,temp", STAGED,
                         ids=[c[0] for c in STAGED])
def test_cc_labels_kernel_matches_plain(cuda, name, shape, geometry, d, n_sys, temp):
    """cc_link / cc_label on batches of random masks from empty to full:
    labels bitwise the min-label fixed point."""
    from peapods_tpu_torch.ops import cc

    lat, _ = _staged_inputs(cuda, 1, shape, geometry, d, n_sys, temp)
    b = 8
    rng = np.random.default_rng(len(shape) + lat.n_neighbors)
    dens = np.linspace(0.0, 1.0, b)[:, None, None]
    masks = torch.from_numpy(rng.random((b, lat.n_spins, lat.n_neighbors)) < dens).to(cuda)
    for k in cc.LAUNCHES:
        cc.LAUNCHES[k] = 0
    got = cc.cc_labels(masks, lat)
    want = cc.cc_labels_plain(masks, lat)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == {"cc_link": 1, "cc_label": 1}
    assert torch.equal(got, want)


def test_cc_labels_one_256_graph(cuda):
    """Row 15's shape: one 256^2 square graph at the bond-percolation
    threshold, where one cluster spans the lattice."""
    from peapods_tpu_torch.ops import cc
    from peapods_tpu_torch.ops.lattice import Lattice

    lat = Lattice((256, 256))
    g = torch.Generator(device=cuda).manual_seed(5)
    masks = torch.rand((1, lat.n_spins, 2), device=cuda, generator=g) < 0.5
    got = cc.cc_labels(masks, lat)
    want = cc.cc_labels_plain(masks, lat)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(torch.bincount(got.view(-1).long()).max()) > lat.n_spins // 10


@pytest.mark.parametrize("shape,b", [((64, 64), 2048), ((256, 256), 2), ((8, 8), 64)],
                         ids=["64-2048", "256", "8-64"])
def test_winding_kernel_matches_plain(cuda, shape, b):
    from peapods_tpu_torch.ops import cluster, winding

    n = shape[0] * shape[1]
    g = torch.Generator(device=cuda).manual_seed(b)
    dens = torch.linspace(0.3, 0.75, b, device=cuda)[:, None, None]
    masks = torch.rand((b, n, 2), device=cuda, generator=g) < dens
    masks[0] = False
    masks[-1] = True
    labels = cluster.connected_components(masks, shape)
    winding.LAUNCHES["winding"] = 0
    wx, wy = winding.winding_flags(masks, labels, shape)
    px, py = cluster.winding_flags(masks, labels, shape)
    torch.cuda.synchronize()
    assert winding.LAUNCHES["winding"] == 1
    assert torch.equal(wx, px) and torch.equal(wy, py)
    assert not wx[0] and wx[-1] and wy[-1]
    # labels of other masks: the kernel cannot settle them and says so
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    winding.winding_flags(torch.zeros_like(masks[:1]), torch.zeros_like(labels[:1]),
                          shape, errors=err)
    assert int(err) == 1
    with pytest.raises(ValueError, match="unsettled"):
        winding.winding_flags(torch.zeros_like(masks[:1]), torch.zeros_like(labels[:1]),
                              shape)


@pytest.mark.parametrize("shape,d,n_sys,n_dirs,temp", [
    ((256, 256), 1, 1, 2, 2.269), ((64, 64), 16, 8, 2, 2.269), ((32, 32), 1, 8, 3, 3.64),
    ((16, 16, 16), 1, 4, 3, 4.51),
], ids=["256", "64-128-graphs", "tri-32", "cubic-16"])
def test_fk_observe_kernel_matches_plain(cuda, shape, d, n_sys, n_dirs, temp):
    """fk_finish in observe form: the spins stay bitwise unchanged; labels
    and masks equal the plain version's."""
    rng = np.random.default_rng(d + n_dirs)
    b, n = d * n_sys, int(np.prod(shape))
    coup = torch.from_numpy(rng.choice([-1.0, 1.0], size=(d, n, n_dirs)).astype(
        np.float32)).to(cuda)
    kb = torch.from_numpy(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)).to(cuda)
    temps = torch.full((b,), temp, device=cuda)
    s0 = torch.from_numpy(rng.choice([-1, 1], size=(b, *shape)).astype(np.int8)).to(cuda)
    ka = s0.clone()
    for k in fk.LAUNCHES:
        fk.LAUNCHES[k] = 0
    lk, mk = fk.fk_observe(ka, coup, temps, kb)
    lp, mp = fk.fk_observe_plain(s0.clone(), coup, temps, kb)
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fk_bonds": 1, **fk.link_launches(shape, b), "fk_finish": 1}
    assert torch.equal(ka, s0)
    assert torch.equal(lk, lp)
    assert torch.equal(mk, mp)
    assert mk.any() and not mk.all()


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,geometry,d,n_sys,temp", STAGED,
                         ids=[c[0] for c in STAGED])
def test_fk_staged_kernels_match_plain(cuda, name, shape, geometry, d, n_sys, temp,
                                       wolff):
    """fk_bonds_nb, cc_link, cc_label and fk_finish reading the labels:
    masks, labels and spins bitwise the plain staged path; observe leaves
    the spins alone."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import cc

    lat, x = _staged_inputs(cuda, 7 + wolff, shape, geometry, d, n_sys, temp)
    scal = torch.from_numpy(seeds.fk_scalars(x["kf"], lat.n_spins, wolff=wolff)).to(cuda)
    a, p = x["spins"].clone(), x["spins"].clone()
    for table in (fk.LAUNCHES, cc.LAUNCHES):
        for k in table:
            table[k] = 0
    args = (x["coup"], x["temps"], scal, x["kb"], lat)
    lk, mk = fk.fk_staged(a, *args, wolff=wolff, with_masks=True)
    lp, mp = fk.fk_staged_plain(p, *args, wolff=wolff)
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {"fk_bonds_nb": 1,
                                                          "fk_finish": 1}
    assert cc.LAUNCHES == {"cc_link": 1, "cc_label": 1}
    assert torch.equal(mk, mp)
    assert torch.equal(lk, lp)
    assert torch.equal(a, p)
    assert not torch.equal(a, x["spins"])
    o = x["spins"].clone()
    lo, mo = fk.fk_staged(o, x["coup"], x["temps"], None, x["kb"], lat, wolff=False,
                          with_masks=True)
    torch.cuda.synchronize()
    assert torch.equal(o, x["spins"]) and torch.equal(lo, lk) and torch.equal(mo, mk)


def test_observe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from peapods_tpu_torch.ops import cc, winding
    from peapods_tpu_torch.ops.lattice import Lattice

    lat, x = _staged_inputs(cuda, 3, (4, 4, 4), "bcc", 1, 2, 6.0)
    masks = torch.zeros((2, 64, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):  # a CPU tensor with a CUDA partner
        fk.fk_staged(x["spins"], x["coup"].cpu(), x["temps"], None, x["kb"], lat,
                     wolff=False)
    with pytest.raises(ValueError):
        winding.winding_flags(masks[..., :2].contiguous(),
                              torch.zeros((2, 64), dtype=torch.int32), (8, 8))
    with pytest.raises(ValueError):  # masks of another lattice
        cc.cc_labels(masks[..., :3], lat)
    with pytest.raises(ValueError):  # winding is 2D
        winding.winding_flags(masks[..., :2], torch.zeros((2, 64), dtype=torch.int32,
                                                          device=cuda), (4, 4, 4))
    with pytest.raises(ValueError):  # the FK kernels draw their own uniforms
        fk.fk_observe(torch.ones((1, 8, 8), dtype=torch.int8, device=cuda),
                      torch.ones((1, 64, 2), device=cuda), torch.ones(1, device=cuda),
                      torch.zeros((1, 2), dtype=torch.int32, device=cuda),
                      uniforms=torch.zeros(1, device=cuda))
    assert not Lattice((4, 4), [[1, 0], [0, 1]]).canonical_square


@pytest.mark.parametrize("shape,geometry,kw", [
    ((16, 128), None, dict(cluster_update_interval=1, cluster_action="observe",
                           pt_interval=1)),
    ((8, 8, 8), "bcc", dict(cluster_update_interval=1, pt_interval=1,
                            collect_cluster_stats=True)),
    ((8, 8, 8), "fcc", dict(cluster_update_interval=2, cluster_mode="wolff",
                            pt_interval=1)),
    ((16, 16), NNN, dict(cluster_update_interval=2, cluster_action="observe",
                         pt_interval=1)),
], ids=["square-observe", "bcc-sw-stats", "fcc-wolff", "nnn-observe"])
def test_observe_and_staged_sample_on_card_match_the_cpu(cuda, shape, geometry, kw):
    """The kernels on the card and the plain path on the CPU follow one
    trajectory and give the same observations (+-1 couplings: every sum is
    an exact integer)."""
    geo = (dict(geometry=geometry) if isinstance(geometry, str)
           else dict(neighbor_offsets=geometry) if geometry is not None else {})
    temps = np.geomspace(2.0, 8.0, 3).astype(np.float32)
    a = Ising(shape, couplings="bimodal", temperatures=temps, seed=4, n_disorder=2,
              device="cuda", **geo)
    c = Ising(shape, couplings="bimodal", temperatures=temps, seed=4, n_disorder=2,
              device="cpu", **geo)
    ra, rc = a.sample(24, **kw), c.sample(24, **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    for key in ("mags", "mags2", "energies", "energies2"):
        np.testing.assert_allclose(ra[key], rc[key], rtol=1e-12, err_msg=key)
    assert ("fk_csd" in ra) == ("fk_csd" in rc)
    if "fk_csd" in rc:
        np.testing.assert_array_equal(np.asarray(ra["fk_csd"]), np.asarray(rc["fk_csd"]))
    if kw.get("cluster_action") == "observe":
        oa = ra["per_disorder"]["cluster_observations"]["fk"]
        oc = rc["per_disorder"]["cluster_observations"]["fk"]
        assert set(oa) == set(oc)
        for key in oc:
            np.testing.assert_array_equal(oa[key], oc[key], err_msg=key)


# ------------------------------------- Houdayer(N) and the moves' graphs


@pytest.mark.parametrize("g", [2, 4, 6])
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (8, 64)], ids=["8cube", "2d"])
def test_houdn_kernels_match_plain(cuda, shape, wolff, g):
    """houdn_bonds -> fk_link -> houdn_finish on groups of g = 2 (the pair
    move), 4 and 6 replicas: every member's spins and the labels bitwise
    the plain version."""
    from peapods_tpu_torch.ops import fk, overlap

    d, n_rep, n_temps = 4, 12, 6
    x = _pair_inputs(cuda, 23 + g, shape, d, n_rep, n_temps)
    n = int(np.prod(shape))
    tab = _event_inputs(x, d, n_rep, n_temps, n, "houdayer", wolff, 7, g=g)
    assert tuple(tab[0].shape) == (d, n_temps, n_rep // g, g)
    a, b = x["spins"].clone(), x["spins"].clone()
    for k in overlap.LAUNCHES:
        overlap.LAUNCHES[k] = 0
    fk.LAUNCHES["fk_link"] = 0
    kw = dict(kind="houdayer", wolff=wolff, shape=shape, with_labels=True)
    lk = overlap.overlap_event(a, x["sid"], tab[0], x["coup"], x["temps"], *tab[1:], **kw)
    lp = overlap.overlap_event_plain(b, x["sid"], tab[0], x["coup"], x["temps"],
                                     *tab[1:], **kw)
    torch.cuda.synchronize()
    assert overlap.LAUNCHES["houdn_bonds"] == overlap.LAUNCHES["houdn_finish"] == 1
    assert overlap.LAUNCHES["ov_bonds"] == overlap.LAUNCHES["ov_finish"] == 0
    assert fk.LAUNCHES["fk_link"] == 1
    assert torch.equal(a, b)
    assert torch.equal(lk.labels, lp.labels)
    assert not torch.equal(a, x["spins"])


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
@pytest.mark.parametrize("shape,d,n_rep,n_temps", [
    ((8, 8, 8), 8, 4, 24), ((8, 64), 2, 2, 3),
], ids=["config4", "2d"])
def test_overlap_event_graphs_and_observe_form_match_plain(cuda, shape, d, n_rep,
                                                           n_temps, kind):
    """Row 19's outputs (SW): the labels (CMR: grey and blue) and the stats
    graph's masks bitwise the plain version; the observe form writes no
    spin and returns the same stats graph."""
    from peapods_tpu_torch.ops import overlap

    x = _pair_inputs(cuda, 29, shape, d, n_rep, n_temps)
    n = int(np.prod(shape))
    tab = _event_inputs(x, d, n_rep, n_temps, n, kind, False, 9)
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    kw = dict(kind=kind, wolff=False, shape=shape, with_labels=True, with_masks=True)
    out = {}
    for observe in (False, True):
        a, b = x["spins"].clone(), x["spins"].clone()
        gk = overlap.overlap_event(a, *args, observe=observe, **kw)
        gp = overlap.overlap_event_plain(b, *args, observe=observe, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert torch.equal(a, x["spins"]) == observe
        for name in ("labels", "blue", "masks"):
            k, p = getattr(gk, name), getattr(gp, name)
            assert (k is None) == (p is None), name
            if k is not None:
                assert torch.equal(k, p), name
        out[observe] = gk
    assert torch.equal(out[True].stats, out[False].stats)
    assert torch.equal(out[True].masks, out[False].masks)
    assert out[True].masks.shape == (d * n_temps * (n_rep // 2), n, len(shape))


@pytest.mark.parametrize("shape,n_rep,kw", [
    ((8, 8, 8), 4, dict(overlap_cluster_build_mode="houd4")),
    ((8, 8, 8), 4, dict(overlap_cluster_build_mode="cmr+houd4",
                        overlap_cluster_mode="sw", collect_cluster_stats=True)),
    ((8, 8, 8), 4, dict(overlap_cluster_build_mode="houdayer+jorg+cmr",
                        overlap_cluster_mode="sw", overlap_cluster_action="observe")),
    ((16, 64), 2, dict(overlap_cluster_build_mode="houdayer+jorg+cmr",
                       overlap_cluster_mode="sw", overlap_cluster_action="observe")),
], ids=["houd4-wolff", "cmr+houd4-sw-stats", "8cube-observe", "2d-observe"])
def test_overlap_stats_sample_on_card_match_the_cpu(cuda, shape, n_rep, kw):
    """Houdayer(N), the moves' statistics and overlap observe: the kernels
    on the card and the plain path on the CPU follow one trajectory and
    give the same overlap_csd, top_cluster_sizes and observations (+-1
    couplings: every sum is an exact integer); observe leaves the card's
    run as it is without overlap moves."""
    from peapods_tpu_torch.ops import overlap

    kw = dict(kw, pt_interval=1, overlap_cluster_update_interval=2)
    temps = np.geomspace(0.9, 2.2, 4).astype(np.float32)

    def model(dev):
        return Ising(shape, couplings="bimodal", temperatures=temps, n_replicas=n_rep,
                     n_disorder=2, seed=6, device=dev)

    a, c = model("cuda"), model("cpu")
    for k in overlap.LAUNCHES:
        overlap.LAUNCHES[k] = 0
    ra, rc = a.sample(24, **kw), c.sample(24, **kw)
    houdn = "houd" in kw["overlap_cluster_build_mode"]  # houd4 and houdayer
    assert (overlap.LAUNCHES["houdn_finish"] > 0) == houdn
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    for key in ("overlap_csd", "top_cluster_sizes"):
        assert (key in ra) == (key in rc)
        for x, y in zip(ra.get(key, []), rc.get(key, [])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=key)
    oa = ra.get("per_disorder", {}).get("cluster_observations", {})
    oc = rc.get("per_disorder", {}).get("cluster_observations", {})
    assert list(oa) == list(oc)
    for name in oc:
        for key in oc[name]:
            np.testing.assert_array_equal(oa[name][key], oc[name][key],
                                          err_msg=f"{name} {key}")
    if kw.get("overlap_cluster_action") == "observe":
        plain = model("cuda")
        rp = plain.sample(24, pt_interval=1)
        for key in ("spins", "system_ids", "pt_edge_acceptances"):
            assert torch.equal(a._sim.state[key], plain._sim.state[key]), key
        np.testing.assert_array_equal(ra["energies"], rp["energies"])


# ------------------------------------------------- the space-sharded path


SPACE = [("square", (128, 32), None, 2),  # bands of 2048 sites: block-aligned
         ("square-odd", (24, 14), None, 3),  # band starts split Philox groups
         ("tri", (32, 32), "tri", 4), ("cubic", (16, 8, 8), None, 4),
         ("bcc", (8, 8, 8), "bcc", 2), ("fcc", (16, 8, 8), "fcc", 4),
         ("nnn", (16, 16), [[1, 0], [0, 1], [1, 1], [1, -1]], 4)]


def _space_inputs(dev, seed, shape, geometry, ns, d, n_sys, couplings="pm"):
    from peapods_tpu_torch.ops import halo
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, BandGeometry, Lattice

    offsets = GEOMETRY_OFFSETS[geometry] if isinstance(geometry, str) else geometry
    lat = Lattice(shape, offsets)
    geom = BandGeometry(lat, ns)
    rng = np.random.default_rng(seed)
    if couplings == "pm":
        coup = rng.choice([-1.0, 1.0], size=(d, lat.n_spins, lat.n_neighbors))
    else:
        coup = rng.standard_normal((d, lat.n_spins, lat.n_neighbors))
    coup = coup.astype(np.float32)
    spins = torch.from_numpy(rng.choice([-1, 1], size=(d, n_sys, lat.n_spins))
                             .astype(np.int8)).to(dev)
    bands = []
    for b in geom.bands:
        f, bw = halo.band_couplings(coup, b, dev)
        col = torch.from_numpy(lat.colors[b.window_sites()].astype(np.uint8)).to(dev)
        bands.append((b, f, bw, col))
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return lat, geom, coup, bands, spins, dict(
        sys_temps=up(rng.uniform(1.5, 6.0, (d, n_sys)).astype(np.float32)),
        words=up(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)))


def _windows_of(spins, geom):
    return [spins[..., torch.from_numpy(b.window_sites()).to(spins.device)].contiguous()
            for b in geom.bands]


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,geometry,ns", SPACE, ids=[s[0] for s in SPACE])
def test_sweep_halo_and_measure_halo_kernels_match_plain(cuda, name, shape, geometry,
                                                         ns, gibbs):
    """Three sweeps in bands, each colour a launch per band with the halos
    copied between: the kernel's windows bitwise the plain version's and
    the unsharded kernel's spins; (e, m) partial sums bitwise (+-1
    couplings)."""
    from peapods_tpu_torch.ops import energy, halo

    lat, geom, coup, bands, spins, x = _space_inputs(cuda, 5 + ns, shape, geometry, ns,
                                                     2, 3)
    wk, wp = _windows_of(spins, geom), _windows_of(spins, geom)
    whole = spins.clone()
    cf = torch.from_numpy(coup).to(cuda)
    cb = torch.stack([cf[:, torch.from_numpy(lat.bwd[:, k]).to(cuda), k]
                      for k in range(lat.n_neighbors)], -1).contiguous()
    colours = torch.from_numpy(lat.colors.astype(np.uint8)).to(cuda)
    jg = sweep.pack_coupling_grids(cf, shape).contiguous() if lat.square else None
    for k in halo.LAUNCHES:
        halo.LAUNCHES[k] = 0
    for step in range(3):
        for colour in range(lat.n_colors):
            last = colour == lat.n_colors - 1 and lat.hypercubic
            for w in (wk, wp):
                halo.exchange(w, geom.bands)
            pk = [halo.sweep_halo(w, f, bw, col, x["sys_temps"], x["words"], b, colour,
                                  gibbs=gibbs, measure=last)
                  for w, (b, f, bw, col) in zip(wk, bands)]
            pp = [halo.sweep_halo_plain(w, f, bw, col, x["sys_temps"], x["words"], b,
                                        colour, gibbs=gibbs, measure=last)
                  for w, (b, f, bw, col) in zip(wp, bands)]
        if lat.square:
            parts = sweep.sweep_2d(whole.view(2, 3, *shape), jg, x["sys_temps"],
                                   x["words"], gibbs=gibbs, measure=True)
        else:
            sweep.sweep_nb(whole, cf, cb, colours, x["sys_temps"], x["words"], lat,
                           gibbs=gibbs)
        for w in (wk, wp):
            halo.exchange(w, geom.bands)
        mk = [halo.measure_halo(w, f, b) for w, (b, f, _, _) in zip(wk, bands)]
        mp = [halo.measure_halo_plain(w, f, b) for w, (b, f, _, _) in zip(wp, bands)]
        torch.cuda.synchronize()
        for a, b in zip(wk, wp):
            assert torch.equal(a, b), step
        assert torch.equal(halo.gather_band_spins(wk, geom.bands), whole), step
        for k_parts, p_parts in ([(pk, pp)] if lat.hypercubic else []) + [(mk, mp)]:
            for i in (0, 1):
                assert torch.equal(torch.cat([p[i] for p in k_parts], -1).sum(-1),
                                   torch.cat([p[i] for p in p_parts], -1).sum(-1)), step
        if name == "square":  # block-aligned bands: the unsharded kernel's partials
            for i in (0, 1):
                assert torch.equal(torch.cat([p[i] for p in pk], -1), parts[i])
        x["words"] = x["words"] * 3 + 1
    assert halo.LAUNCHES["sweep_halo"] == 3 * lat.n_colors * ns
    assert halo.LAUNCHES["measure_halo"] == 3 * ns


def test_sweep_halo_gaussian_partials_are_the_unsharded_partials(cuda):
    """Gaussian couplings, bands of 2048 sites on the square lattice and of
    1024 on the cubic one: the bands' partials, concatenated, are the
    unsharded kernels' partials bit for bit."""
    from peapods_tpu_torch.ops import energy, halo

    for shape, ns in (((128, 32), 2), ((16, 8, 16), 2)):
        lat, geom, coup, bands, spins, x = _space_inputs(cuda, 3, shape, None, ns, 2, 3,
                                                         couplings="gauss")
        wk = _windows_of(spins, geom)
        whole = spins.clone()
        cf = torch.from_numpy(coup).to(cuda)
        for colour in (0, 1):
            halo.exchange(wk, geom.bands)
            pk = [halo.sweep_halo(w, f, bw, col, x["sys_temps"], x["words"], b, colour,
                                  gibbs=False, measure=colour == 1 and lat.square)
                  for w, (b, f, bw, col) in zip(wk, bands)]
        if lat.square:
            want = sweep.sweep_2d(whole.view(2, 3, *shape),
                                  sweep.pack_coupling_grids(cf, shape).contiguous(),
                                  x["sys_temps"], x["words"], gibbs=False, measure=True)
        else:
            cb = torch.stack([cf[:, torch.from_numpy(lat.bwd[:, k]).to(cuda), k]
                              for k in range(3)], -1).contiguous()
            sweep.sweep_nb(whole, cf, cb, torch.from_numpy(lat.colors.astype(np.uint8))
                           .to(cuda), x["sys_temps"], x["words"], lat, gibbs=False)
            want = energy.measure_nb(whole, cf, lat)
            halo.exchange(wk, geom.bands)
            pk = [halo.measure_halo(w, f, b) for w, (b, f, _, _) in zip(wk, bands)]
        torch.cuda.synchronize()
        assert torch.equal(halo.gather_band_spins(wk, geom.bands), whole)
        for i in (0, 1):
            assert torch.equal(torch.cat([p[i] for p in pk], -1), want[i]), shape


def _band_masks(lat, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [rng.random((lat.n_spins, lat.n_neighbors)) < p for p in (0.3, 0.55, 1.01)]))


def _band_buffers(masks, geom, dev):
    """Each band's ``BandCC`` with the state bytes of bond masks ``[G,
    n_spins, n_nb]``."""
    from peapods_tpu_torch.ops import cc_band

    bits = torch.arange(geom.lattice.n_neighbors, dtype=torch.uint8, device=dev)
    ccs = []
    for b in geom.bands:
        m = (masks.to(dev)[:, torch.from_numpy(b.window_sites()).to(dev)]
             & torch.from_numpy(cc_band.window_reach(b)).to(dev))
        cc = cc_band.BandCC.empty(masks.shape[0], b, dev)
        cc.state.copy_((m.to(torch.uint8) << bits).sum(-1, dtype=torch.uint8))
        ccs.append(cc)
    return ccs


@pytest.mark.parametrize("name,shape,geometry,ns", SPACE, ids=[s[0] for s in SPACE])
def test_band_cc_kernels_match_plain(cuda, name, shape, geometry, ns):
    """The banded labels of random bond masks at three densities (all bonds
    on: spanning clusters) bitwise the unsharded plain labels, each density
    in the same launches (five a band and the merge's two) and with no host
    synchronisation."""
    from peapods_tpu_torch.ops import cc_band
    from peapods_tpu_torch.ops.cluster import connected_components

    lat, geom, *_ = _space_inputs(cuda, 7, shape, geometry, ns, 1, 1)
    masks = _band_masks(lat, 13)
    want = connected_components(masks, shape, lat.offsets)
    per_band = ("cc_band_link", "cc_band_border", "cc_band_flatten", "cc_band_export",
                "cc_band_write")
    for i in range(3):
        ccs = _band_buffers(masks[i:i + 1], geom, cuda)
        for k in cc_band.LAUNCHES:
            cc_band.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cc_band.banded_labels(ccs, geom.bands)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = torch.cat([cc.labels[:, b.interior] for cc, b in zip(ccs, geom.bands)], -1)
        assert torch.equal(got.cpu(), want[i:i + 1]), i
        assert cc_band.LAUNCHES == {**dict.fromkeys(per_band, ns), "cc_band_merge": 1,
                                    "cc_band_resolve": 1}, i
        assert torch.equal(cc_band.band_cc_labels(masks[i:i + 1].to(cuda), geom).cpu(),
                           want[i:i + 1]), i


@pytest.mark.parametrize("name,shape,geometry,ns", SPACE, ids=[s[0] for s in SPACE])
def test_band_cc_each_kernel_matches_plain(cuda, name, shape, geometry, ns):
    """Each kernel of the banded labelling bitwise its plain version on the
    kernels' own inputs, at three bond densities: the link's three
    (parents, the roots' slots), the export (nodes, values), the merge and
    resolve (set minima), the write (every window site's label); the halo
    sites' labels are the unsharded labels of the sites they copy."""
    from peapods_tpu_torch.ops import cc_band
    from peapods_tpu_torch.ops.cluster import connected_components

    lat, geom, *_ = _space_inputs(cuda, 9, shape, geometry, ns, 1, 1)
    masks = _band_masks(lat, 19)
    want = connected_components(masks, shape, lat.offsets).to(cuda)
    ccs = _band_buffers(masks, geom, cuda)
    plain = [cc_band.BandCC(c.state.clone(), *(torch.empty_like(c.parent) for _ in range(3)))
             for c in ccs]
    for c, p, b in zip(ccs, plain, geom.bands):
        cc_band.link(c, b)
        cc_band.link_plain(p, b)
    torch.cuda.synchronize()
    for c, p in zip(ccs, plain):
        assert torch.equal(c.parent, p.parent)
        roots = c.parent.long()
        assert torch.equal(c.cmin.gather(1, roots), p.cmin.gather(1, roots))
    mb = cc_band.BandMerge.empty(3, geom.bands, cuda)
    for c, b in zip(ccs, geom.bands):
        cc_band.export(c, b, mb)
        rep, val = (torch.empty_like(mb.rep[0]) for _ in range(2))
        cc_band.export_plain(c, b, rep, val)
        torch.cuda.synchronize()
        assert torch.equal(mb.rep[b.k], rep)
        assert torch.equal(mb.val[b.k], val)
    check = cc_band.BandMerge(mb.rep.clone(), mb.val.clone(), torch.empty_like(mb.labels))
    cc_band.merge(mb)
    cc_band.merge_plain(check)
    torch.cuda.synchronize()
    assert torch.equal(mb.labels, check.labels)
    for c, p, b in zip(ccs, plain, geom.bands):
        cc_band.write(c, b, mb.labels[b.k])
        cc_band.write_plain(p, b, mb.labels[b.k])
        torch.cuda.synchronize()
        assert torch.equal(c.labels, p.labels)
        assert torch.equal(c.labels, want[:, torch.from_numpy(b.window_sites()).to(cuda)])


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,geometry,ns", SPACE, ids=[s[0] for s in SPACE])
def test_fk_band_kernels_match_plain(cuda, name, shape, geometry, ns, wolff):
    """fk_bonds_band, the banded labels and fk_finish_band near T_c: state
    bytes, labels, spins and the measured partials bitwise the plain
    versions' on the same CUDA tensors (+-1 couplings)."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import cc_band, halo

    lat, geom, coup, bands, spins, _ = _space_inputs(cuda, 11 + ns, shape, geometry, ns,
                                                     2, 2)
    g = 4
    rng = np.random.default_rng(17)
    kf = rng.integers(0, 2**32, (g, 2), dtype=np.uint64).astype(np.uint32)
    scal = torch.from_numpy(seeds.fk_scalars(kf, lat.n_spins, wolff=wolff)).to(cuda)
    kb = torch.from_numpy(rng.integers(-2**31, 2**31, (g, 2)).astype(np.int32)).to(cuda)
    temps = torch.full((g,), 2.3 * lat.n_neighbors / 2, device=cuda)
    measure = fk.fused_lattice(lat)
    out = {}
    for kind in ("kernel", "plain"):
        wins = [w.view(g, -1) for w in _windows_of(spins, geom)]
        ccs = [cc_band.BandCC.empty(g, b, cuda) for b in geom.bands]
        for w, cb, (b, f, _, _) in zip(wins, ccs, bands):
            (fk.fk_bonds_band if kind == "kernel" else fk.fk_bonds_band_plain)(
                w, f, temps, kb, cb, b)
        (cc_band.banded_labels if kind == "kernel" else cc_band.banded_labels_plain)(
            ccs, geom.bands)
        seed_lab = fk.wolff_seed_labels(ccs, geom.bands, scal[:, 2]) if wolff else None
        fin = fk.fk_finish_band if kind == "kernel" else fk.fk_finish_band_plain
        parts = [fin(w, cb, f, scal, seed_lab, b, wolff=wolff, measure=measure)
                 for w, cb, (b, f, _, _) in zip(wins, ccs, bands)]
        torch.cuda.synchronize()
        out[kind] = (torch.cat([cb.state for cb in ccs], -1),
                     torch.cat([cb.labels for cb in ccs], -1),
                     halo.gather_band_spins(wins, geom.bands),
                     [torch.cat([p[i] for p in parts], -1).sum(-1) for i in (0, 1)]
                     if measure else [])
    (sk, lk, xk, pk), (sp, lp, xp, pp) = out["kernel"], out["plain"]
    assert torch.equal(sk, sp)
    assert torch.equal(lk, lp)
    assert torch.equal(xk, xp)
    for a, b in zip(pk, pp):
        assert torch.equal(a, b)
    assert not torch.equal(xk, spins.view(g, -1))


# the redesigned band kernels' cases: a narrow square (a 256-site block spans
# four rows; in 4 bands each band's first colour site is off the 1024-site
# boundary), bands whose first site lies on no 256- or 1024-site boundary, 2
# and 4 bands, and an offset table that reaches two rows down and two
# columns back
FAR = [[1, 0], [0, 2], [1, -2], [2, -1]]
BAND_EDGE = [("narrow64", (64, 64), None, 4), ("narrow64-2", (64, 64), None, 2),
             ("cubic-odd", (12, 6, 10), None, 4), ("tri-odd", (20, 10), "tri", 4),
             ("far", (16, 12), FAR, 2), ("fcc", (16, 8, 8), "fcc", 4)]
# cases wide enough that a sweep_halo CTA loops over several systems, the last
# CTA over fewer, and an fk_finish_band CTA over several partial blocks (the
# last, off the square, over fewer): name, shape, geometry, bands, then the
# systems of each realization in the sweep_halo test and in the
# fk_finish_band test (two realizations each)
BAND_WIDE = [("sq-wide", (512, 512), None, 2, 25, 16),
             ("cubic-wide", (36, 20, 30), None, 4, 179, 96),
             ("tri-wide", (132, 250), "tri", 4, 149, 64),
             ("far-wide", (96, 250), FAR, 2, 130, 48)]
HALO_CASES = [c + (3,) for c in BAND_EDGE] + [c[:5] for c in BAND_WIDE]
FINISH_CASES = [c + (2,) for c in BAND_EDGE] + [c[:4] + c[5:] for c in BAND_WIDE]
WIDE = {c[0] for c in BAND_WIDE}


def _halo_systems_per_cta(band, square, d, n_sys):
    """The systems a sweep_halo CTA takes (csrc/halo.cu peapods_sweep_halo):
    as many as leave about 1056 CTAs a launch."""
    n = band.hl * band.lattice.shape[1] // 2 if square else band.n_band
    n_blk = -(-(-(-n // 4)) // 256)
    groups = min(n_sys, max(1, -(-1056 // (n_blk * d))))
    return -(-n_sys // groups)


def _finish_parts(band, g):
    """The partial blocks an fk_finish_band CTA takes (csrc/fk.cu
    finish_tile): halved from 32 while the launch has fewer than 1024
    CTAs."""
    n_blk = -(-band.n_band // 256)
    parts = 32
    while parts > 1 and -(-n_blk // parts) * g < 1024:
        parts //= 2
    return parts


def _tree_partials(terms, block, per_thread):
    """Partials of per-site terms ``[..., n]`` as the band kernels add them:
    blocks of ``block`` sites from the first, ``per_thread`` consecutive
    sites a thread added in order from 0, then the 256 threads' sums paired
    as a shared-memory tree (offsets 128 down to 1)."""
    n = terms.shape[-1]
    nblk = -(-n // block)
    x = torch.nn.functional.pad(terms, (0, nblk * block - n))
    x = x.reshape(*terms.shape[:-1], nblk, block // per_thread, per_thread)
    acc = torch.zeros_like(x[..., 0])
    for k in range(per_thread):
        acc = acc + x[..., k]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,geometry,ns,n_sys", HALO_CASES,
                         ids=[s[0] for s in HALO_CASES])
def test_sweep_halo_matches_plain_with_its_partials(cuda, name, shape, geometry, ns, n_sys,
                                                    gibbs):
    """Two sweeps in bands, gaussian couplings, every colour pass measuring
    and not (two-colour lattices): each band's window bitwise the plain
    version's, and every partial bitwise the per-block sum of the plain
    pass's site terms (e: s * field of the pass's sites; m: the band's
    spins), four consecutive (colour) sites a thread, 1024 a block; where a
    band is a whole number of blocks, the partials of the square lattice's
    second pass are the unsharded sweep_2d's.  The wide cases' CTAs each
    take several systems, the last CTA fewer."""
    from peapods_tpu_torch.ops import halo

    lat, geom, coup, bands, spins, x = _space_inputs(cuda, 21 + ns, shape, geometry, ns,
                                                     2, n_sys, couplings="gauss")
    if name in WIDE:
        per = [_halo_systems_per_cta(b, lat.square, 2, n_sys) for b in geom.bands]
        assert min(per) > 1 and all(n_sys % p for p in per), per
    wk, wp = _windows_of(spins, geom), _windows_of(spins, geom)
    whole = spins.clone()
    cf = torch.from_numpy(coup).to(cuda)
    for step in range(2):
        got, words = [], x["words"].clone()
        for colour in range(lat.n_colors):
            measure = lat.n_colors == 2 and (colour + step) % 2 == 1
            for w in (wk, wp):
                halo.exchange(w, geom.bands)
            for j, (b, f, bw, col) in enumerate(bands):
                args = (f, bw, col, x["sys_temps"], x["words"], b, colour)
                c, field, active, *_ = halo.pass_decisions(wp[j], *args, gibbs=gibbs)
                pk = halo.sweep_halo(wk[j], *args, gibbs=gibbs, measure=measure)
                halo.sweep_halo_plain(wp[j], *args, gibbs=gibbs)
                torch.cuda.synchronize()
                assert torch.equal(wk[j], wp[j]), (step, colour, j)
                if not measure:
                    assert pk is None
                    continue
                new = wp[j][..., b.interior].to(torch.float32)
                e = torch.where(active, new * field, 0.0)
                m = wp[j][..., b.interior].to(torch.int32)
                if lat.square:
                    e = e[..., active]
                    m = m.reshape(*m.shape[:-1], -1, 2).sum(-1, dtype=torch.int32)
                assert torch.equal(pk[0], _tree_partials(e, 1024, 4)), (step, colour, j)
                assert torch.equal(pk[1], _tree_partials(m, 1024, 4)), (step, colour, j)
                got.append(pk)
        x["words"] = x["words"] * 5 + 3
        aligned = all(b.n_band // 2 % 1024 == 0 for b in geom.bands)
        if lat.square and aligned and step == 0:
            want = sweep.sweep_2d(whole.view(2, n_sys, *shape),
                                  sweep.pack_coupling_grids(cf, shape).contiguous(),
                                  x["sys_temps"], words, gibbs=gibbs, measure=True)
            torch.cuda.synchronize()
            assert torch.equal(halo.gather_band_spins(wk, geom.bands), whole)
            for i in (0, 1):
                assert torch.equal(torch.cat([p[i] for p in got], -1), want[i])


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,geometry,ns,n_sys", FINISH_CASES,
                         ids=[s[0] for s in FINISH_CASES])
def test_fk_finish_band_matches_plain_with_its_partials(cuda, name, shape, geometry, ns,
                                                        n_sys, wolff):
    """fk_finish_band on the banded labels near T_c, gaussian couplings,
    measuring (square, triangular, cubic) and not: the spins bitwise the
    plain version's, and every partial bitwise the per-block sum of the
    plain update's site terms (e: s s_fwd J over the forward bonds in
    order; m: the new spin), one site a thread, 256 a block from each
    band's first site; where every band is a whole number of blocks, the
    bands' partials are the unsharded fk_update's.  The wide cases' CTAs
    each take several partial blocks."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import cc_band

    lat, geom, coup, bands, spins, _ = _space_inputs(cuda, 31 + ns, shape, geometry, ns,
                                                     2, n_sys, couplings="gauss")
    g = 2 * n_sys
    if name in WIDE:
        parts = [_finish_parts(b, g) for b in geom.bands]
        assert min(parts) > 1, parts
    rng = np.random.default_rng(23)
    kf = rng.integers(0, 2**32, (g, 2), dtype=np.uint64).astype(np.uint32)
    scal = torch.from_numpy(seeds.fk_scalars(kf, lat.n_spins, wolff=wolff)).to(cuda)
    kb = torch.from_numpy(rng.integers(-2**31, 2**31, (g, 2)).astype(np.int32)).to(cuda)
    temps = torch.full((g,), 2.3 * lat.n_neighbors / 2, device=cuda)
    wins = [w.view(g, -1) for w in _windows_of(spins, geom)]
    ccs = [cc_band.BandCC.empty(g, b, cuda) for b in geom.bands]
    for w, cb, (b, f, _, _) in zip(wins, ccs, bands):
        fk.fk_bonds_band(w, f, temps, kb, cb, b)
    cc_band.banded_labels(ccs, geom.bands)
    seed_lab = fk.wolff_seed_labels(ccs, geom.bands, scal[:, 2]) if wolff else None
    for measure in ([True, False] if fk.fused_lattice(lat) else [False]):
        got = []
        for w, cb, (b, f, _, _) in zip(wins, ccs, bands):
            wk, wp = w.clone(), w.clone()
            pk = fk.fk_finish_band(wk, cb, f, scal, seed_lab, b, wolff=wolff,
                                   measure=measure)
            fk.fk_finish_band_plain(wp, cb, f, scal, seed_lab, b, wolff=wolff,
                                    measure=measure)
            torch.cuda.synchronize()
            assert torch.equal(wk, wp), (measure, b.k)
            if not measure:
                assert pk == (None, None)
                continue
            flip = (cb.labels == seed_lab[:, None] if wolff
                    else fk.cluster_coin_flip_mask(cb.labels, scal[:, :2]))
            new = torch.where(flip, -w, w).to(torch.float32)
            j = fk._graph_couplings(f, g)[:, b.interior]
            e = torch.zeros_like(new[:, b.interior])
            for k, off in enumerate(lat.offsets):
                e = e + (new[:, b.interior] * fk._window_shift(new, off, b)[:, b.interior]
                         * j[..., k])
            assert torch.equal(pk[0], _tree_partials(e, 256, 1)), b.k
            m = wp[:, b.interior].to(torch.int32)
            assert torch.equal(pk[1], _tree_partials(m, 256, 1)), b.k
            got.append(pk)
        if measure and all(b.n_band % 256 == 0 for b in geom.bands):
            want = fk.fk_update(spins.view(g, *shape).clone(), torch.from_numpy(coup).to(cuda),
                                temps, scal, kb, wolff=wolff, with_measure=True,
                                with_labels=False)
            torch.cuda.synchronize()
            for i in (0, 1):
                assert torch.equal(torch.cat([p[i] for p in got], -1), want[i])


@pytest.mark.parametrize("shape,geometry,kw", [
    ((64, 64), None, dict(pt_interval=1, cluster_update_interval=1, cluster_mode="sw",
                          collect_cluster_stats=True)),
    ((16, 16, 16), None, dict(pt_interval=1, cluster_update_interval=2,
                              cluster_mode="wolff")),
    ((32, 32), "tri", dict(pt_interval=1)),
    ((16, 8, 8), "fcc", dict(pt_interval=1, cluster_update_interval=1,
                             cluster_mode="sw", collect_cluster_stats=True)),
], ids=["square-sw", "cubic-wolff", "tri-metropolis", "fcc-sw-staged"])
def test_space_sample_on_card_is_bitwise_the_unsharded_run(cuda, shape, geometry, kw):
    """A space mesh of four bands on the one card: bitwise the unsharded
    per-sweep run on the card (``run_chunk_sweeps``), spins, records and
    fk_csd."""
    from peapods_tpu_torch.engine import loop, simulation
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS
    from peapods_tpu_torch.parallel.mesh import make_mesh

    offsets = GEOMETRY_OFFSETS[geometry] if geometry else None
    nb = len(offsets) if offsets else len(shape)
    temps = np.geomspace(2.0, 3.0, 4).astype(np.float32) * (1 + (nb > 2))

    def run(mesh):
        sim = simulation.IsingSimulation(list(shape), np.ones(shape + (nb,), np.float32),
                                         temps, 1, offsets, 3, mesh=mesh)
        old = simulation.run_chunk
        if mesh is None:
            simulation.run_chunk = loop.run_chunk_sweeps
        try:
            r = sim.sample(24, "metropolis", warmup_ratio=0.25, **kw)
        finally:
            simulation.run_chunk = old
        return sim, r

    a, ra = run(make_mesh(4, ("space",), devices=[cuda] * 4))
    b, rb = run(None)
    assert torch.equal(a.all_spins(), b.state["spins"])
    assert torch.equal(a.state["system_ids"], b.state["system_ids"])
    for key in ("energies", "mags", "mags2"):
        np.testing.assert_array_equal(ra[key], rb[key])
    if "fk_csd" in rb:
        np.testing.assert_array_equal(ra["fk_csd"], rb["fk_csd"])
