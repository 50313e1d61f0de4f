"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  They cover the
mega path's kernels (colour_pass, pt_step), the per-sweep path's
(sweep_2d and the three FK kernels; fk_bonds and fk_bonds_band alone,
their state bytes) and the replica path's (colour_pass in
3D, pt_step on R ladders, pair_overlap, also over the offset tables of the
triangular, BCC, FCC and NNN lattices, the ov_* overlap-move kernels and
energy_partials; the per-sweep replica path's runs on the card against the
CPU), the coloured lattices' (sweep_nb, measure_nb and the
FK kernels with three bond directions; fk_finish alone with its partials
per block), FK observe's and the staged path's (cc_link, whole and tiled, the
winding kernels in both forms, one launch at a time and at 2048^2,
fk_bonds_staged and fk_finish reading labels) and Houdayer(N)'s (houdn_bonds,
houdn_finish) with the overlap moves' labels, masks and observe form;
houdn_bonds and the finishes (ov_finish, houdn_finish) each alone against
houdn_states_plain / finish_plain; on the table lattices (4D, 5D, odd
extents, self-bonds, 9 and 32 offsets) the moves' table forms
(ov_bonds_table, ov_mid_table, ov_finish_table, houdn_bonds_table,
houdn_finish_table) and pair_overlap_table, whole, alone and in the engine
against the CPU, the redesigned measure_nb_table and pair_overlap_table
at each systems-a-thread count and each cluster and copy form, and the
redesigned ov_bonds_table, ov_mid_table and houdn_bonds_table at each
tasks-a-thread count, whole and off their word alignment.  On a machine
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

import math

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
    # the route the shape rule picks: one resident launch, or three a sweep
    want = ({"colour_pass": 0, "pt_step": 0, "mega_resident": 1}
            if mega.resident_route(cuda, *shape, d, n_temps) is not None
            else {"colour_pass": 2 * n, "pt_step": n, "mega_resident": 0})
    assert mega.LAUNCHES == want
    e_p, m_p, par_p = mega.mega_chunk_plain(*(p[key] for key in order), **kw)
    assert mega.LAUNCHES == want

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
    assert mega.LAUNCHES == {"colour_pass": 0, "pt_step": 0, "mega_resident": 0}


CHUNK_ORDER = ("spins", "jgrids", "temps", "sid", "ea", "ec", "rtrips", "tstate",
               "sweep_words", "pt_words")
CHUNK_STATE = ("spins", "sid", "ea", "ec", "rtrips", "tstate")
TIE_ULPS = 4  # |u - p| within this many ulp of p: an exp rounding tie


def _pass_ties(x, sid, words, colour, gibbs):
    """Spins where ``colour_pass`` and ``colour_pass_plain`` part on one pass
    from ``x["spins"]``, all of which must be ulp ties; returns their count
    and the plain pass's spins."""
    from peapods_tpu_torch.ops.rng import colour_uniforms
    from peapods_tpu_torch.ops.sweep import acceptance, colour_mask, local_field

    d, n_slots = sid.shape
    shape = tuple(x["spins"].shape[2:])
    di = torch.arange(d, device=sid.device)[:, None]
    s = x["spins"][di, sid.long()].float()
    inv = (1.0 / (0.5 * x["temps"])).reshape(1, n_slots, 1, 1)
    p = acceptance((-s * local_field(s, x["jgrids"][:, None])) * inv, gibbs=gibbs)
    u = colour_uniforms(words, n_slots, colour, shape)
    ulp = torch.nextafter(p, torch.full_like(p, np.inf)) - p
    tie = ((u - p).abs() <= TIE_ULPS * ulp) & colour_mask(shape, colour, sid.device)
    a, b = x["spins"].clone(), x["spins"].clone()
    mega.colour_pass(a, x["jgrids"], sid, x["temps"], words, colour, gibbs=gibbs)
    mega.colour_pass_plain(b, x["jgrids"], sid, x["temps"], words, colour, gibbs=gibbs)
    diff = a[di, sid.long()] != b[di, sid.long()]
    assert not (diff & ~tie).any(), "spins differ away from ulp ties"
    return int((diff & tie).sum()), b


def _ulp_tie_sweep(x, kw, n):
    """The first sweep at which one-sweep resident and plain chunks from the
    plain chunk's state part, which must be on ulp ties of its colour
    passes: ``(sweep, ties)``."""
    s = {key: v.clone() for key, v in x.items()}
    for t in range(n):
        words = {key: s[key][t:t + 1] for key in ("sweep_words", "pt_words")}
        runs = []
        for fn in (mega.mega_chunk_resident, mega.mega_chunk_plain):
            r = {key: v.clone() for key, v in s.items()}
            r.update(words)
            par = fn(*(r[key] for key in CHUNK_ORDER), **dict(kw, sweep_base=kw["sweep_base"] + t))[2]
            runs.append((r, par))
        (a, _), (b, par) = runs
        if all(torch.equal(a[key], b[key]) for key in CHUNK_STATE):
            s.update({key: b[key] for key in CHUNK_STATE})
            kw = dict(kw, parity=par)
            continue
        ties, spins = _pass_ties(s, s["sid"], s["sweep_words"][t], 0, kw["gibbs"])
        more, _ = _pass_ties(dict(s, spins=spins), s["sid"], s["sweep_words"][t], 1,
                             kw["gibbs"])
        assert ties + more > 0, f"sweep {t} parts without an ulp tie"
        return t, ties + more
    raise AssertionError("the chunks part, but no single sweep does")


@pytest.mark.parametrize(
    "shape,d,n_temps,n,gibbs,pt_full,pt_interval,sweep_base,couplings",
    [
        ((64, 64), 2, 5, 24, False, False, 1, 0, "pm"),
        ((32, 128), 3, 6, 24, False, True, 3, 5, "pm"),
        ((256, 256), 1, 24, 256, False, False, 1, 0, "pm"),
        ((256, 256), 1, 24, 256, True, False, 1, 0, "pm"),
        ((256, 256), 1, 24, 256, False, True, 1, 0, "pm"),
        ((256, 256), 1, 24, 256, False, False, 3, 5, "pm"),
        ((256, 256), 1, 24, 256, False, False, None, 0, "gauss"),
    ],
    ids=["64-metropolis-single", "32x128-full-interval3", "256-flagship",
         "256-gibbs", "256-full-ladder", "256-interval3-base5", "256-gauss-no-pt"],
)
def test_resident_chunk_matches_launches_and_plain(cuda, shape, d, n_temps, n, gibbs,
                                                   pt_full, pt_interval, sweep_base,
                                                   couplings):
    """The resident chunk bitwise the three launches a sweep and the plain
    chunk: spins, e, m, sid, PT counters, trip state, parity (gaussian
    couplings: the plain e to rtol 1e-5; exp ulp ties against the plain
    chunk counted apart, the chunks not compared past one)."""
    x = _chunk_inputs(cuda, 29 + d * n_temps, shape, d, n_temps, n, couplings)
    hot, cold = hot_cold_slots(x["temps"].cpu().numpy())
    kw = dict(sweep_base=sweep_base, parity=1, gibbs=gibbs, pt_interval=pt_interval,
              pt_full=pt_full, hot_slot=hot, cold_slot=cold)
    assert mega.resident_route(cuda, *shape, d, n_temps) is not None
    runs = {}
    for route, fn in (("resident", mega.mega_chunk_resident),
                      ("launches", mega.mega_chunk_launches),
                      ("plain", mega.mega_chunk_plain)):
        r = {key: v.clone() for key, v in x.items()}
        mega.reset_launches()
        r["e"], r["m"], r["parity"] = fn(*(r[key] for key in CHUNK_ORDER), **kw)
        torch.cuda.synchronize()
        if route == "resident":
            assert mega.LAUNCHES == {"colour_pass": 0, "pt_step": 0, "mega_resident": 1}
        runs[route] = r
    res, three, plain = runs["resident"], runs["launches"], runs["plain"]
    for key in CHUNK_STATE + ("e", "m"):
        assert torch.equal(res[key], three[key]), key
    assert res["parity"] == three["parity"]
    if not torch.equal(res["spins"], plain["spins"]):
        t, ties = _ulp_tie_sweep(x, kw, n)
        assert ties <= 1e-5 * 2 * d * n_temps * shape[0] * shape[1] // 2
        print(f"resident and plain chunks part at sweep {t} on {ties} ulp ties")
        return
    for key in CHUNK_STATE + ("m",):
        assert torch.equal(res[key], plain[key]), key
    assert res["parity"] == plain["parity"]
    if couplings == "pm":
        assert torch.equal(res["e"], plain["e"])
    else:
        torch.testing.assert_close(res["e"], plain["e"], rtol=1e-5, atol=0)
    if pt_interval is not None:
        assert int(res["ea"].sum()) > 0


def test_resident_entry_refuses_what_it_cannot_run(cuda):
    """The entry point launches nothing for a layout other than the rule's:
    shared memory that is not the layout's, more clusters than the card
    holds at once, or a cluster whose rows split a logical block."""
    x = _chunk_inputs(cuda, 5, (256, 256), 2, 24, 2, "pm")
    hot, cold = hot_cold_slots(x["temps"].cpu().numpy())
    kw = dict(sweep_base=0, parity=0, gibbs=False, pt_interval=1, pt_full=False,
              hot_slot=hot, cold_slot=cold)
    assert mega.resident_route(cuda, 256, 256, 2, 24) is None  # 48 clusters of 4
    fits = mega.resident_route(cuda, 256, 256, 1, 24)
    one = {key: v if key == "temps" else (v[:, :1] if key.endswith("words") else v[:1])
           .contiguous() for key, v in x.items()}
    small = _chunk_inputs(cuda, 5, (16, 64), 1, 3, 2, "pm")  # 512 colour sites a row
    hot3, cold3 = hot_cold_slots(small["temps"].cpu().numpy())
    mega.reset_launches()
    for inputs, plan, kw_plan in (
            (x, fits, kw),  # two realizations: 48 clusters
            (one, fits._replace(smem=fits.smem + 16), kw),
            (small, mega.ResidentPlan(1, 16, 128, mega.resident_smem(16, 64, 1, 3)),
             dict(kw, hot_slot=hot3, cold_slot=cold3))):
        with pytest.raises(RuntimeError, match="mega_resident"):
            mega.mega_chunk_resident(*(inputs[key] for key in CHUNK_ORDER), plan=plan,
                                     **kw_plan)
    with pytest.raises(ValueError, match="no resident layout"):
        mega.mega_chunk_resident(*(x[key] for key in CHUNK_ORDER), **kw)
    assert mega.LAUNCHES["mega_resident"] == 0


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
        pk = sweep.sweep_2d(a, x["coup"], x["sys_temps"], x["words"],
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
        sweep.sweep_2d(x["spins"], x["coup"], x["sys_temps"].double(),
                       x["words"], gibbs=False)
    with pytest.raises(ValueError):
        fk.fk_update(x["spins"].view(2, 8, 8), x["coup"],
                     x["sys_temps"].view(-1), torch.zeros((2, 3), dtype=torch.int64,
                                                          device=cuda),
                     x["kb"], wolff=False, with_measure=True, with_labels=False)
    with pytest.raises(ValueError):  # the kernels draw their own uniforms
        sweep.sweep_2d(x["spins"], x["coup"], x["sys_temps"], x["words"],
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


COLOUR_SHAPES = [
    ((8, 8, 8), 8, 4, 24, False, "pm"), ((16, 16, 16), 2, 4, 6, True, "pm"),
    ((8, 64), 2, 2, 3, False, "pm"), ((6, 4, 10), 1, 2, 3, False, "gauss"),
    ((16, 16, 16), 8, 4, 24, False, "gauss"), ((32, 32), 1, 2, 16, False, "pm"),
    ((32, 32), 1, 2, 16, True, "gauss"), ((2, 2, 2), 2, 2, 3, False, "gauss"),
    ((2, 2, 16), 1, 4, 2, True, "pm"), ((4, 6, 8), 3, 2, 5, False, "gauss"),
    ((2, 8), 2, 3, 2, False, "gauss"), ((6, 10), 1, 2, 7, True, "gauss"),
    ((64, 48), 2, 2, 5, False, "gauss"), ((12, 8, 24), 1, 2, 9, True, "gauss"),
]


@pytest.mark.parametrize("shape,d,n_rep,n_temps,gibbs,couplings", COLOUR_SHAPES,
                         ids=["8cube-config4", "16cube-gibbs", "2d-8x64", "6x4x10-gauss",
                              "config5-gauss", "config1", "config1-gibbs-gauss",
                              "2cube", "2x2x16-gibbs", "4x6x8-gauss", "2x8-gauss",
                              "6x10-gibbs", "64x48-2-blocks", "12x8x24-gibbs"])
def test_colour_pass_3d_kernel_matches_plain(cuda, shape, d, n_rep, n_temps, gibbs,
                                             couplings):
    """colour_pass on 2D and 3D replica batches (vector and per-site
    paths, one and several slots a thread, CTAs filled with several slots
    at small lattices): spins bitwise colour_pass_plain on the same card,
    every partial bitwise the first design's order of adds
    (colour_pass_partials)."""
    x = _pair_inputs(cuda, 5, shape, d, n_rep, n_temps, couplings)
    s = n_rep * n_temps
    a = x["spins"].view(d, s, *shape).clone()
    b = a.clone()
    words = torch.from_numpy(x["rng"].integers(-2**31, 2**31, (d, 2)).astype(
        np.int32)).to(cuda)
    args = (x["jgrids"], x["sid"], x["slot_temps"])
    for colour in (0, 1, 0, 1):
        c = b.clone()
        pk = mega.colour_pass(a, *args, words, colour, gibbs=gibbs)
        pp = mega.colour_pass_plain(b, *args, words, colour, gibbs=gibbs)
        torch.cuda.synchronize()
        assert torch.equal(a, b), colour
        if pk is not None:
            pe, pm = mega.colour_pass_partials(c, *args, words, gibbs=gibbs)
            assert torch.equal(c, b)
            assert torch.equal(pk[0], pe) and torch.equal(pk[1], pm)
            assert torch.equal(pk[1].sum(-1), pp[1].sum(-1))
            if couplings == "pm":
                assert torch.equal(pk[0].sum(-1), pp[0].sum(-1))
            else:  # partials added in another order
                torch.testing.assert_close(pk[0].sum(-1), pp[0].sum(-1),
                                           rtol=1e-5, atol=1e-4)
        words = words * 3 + 1
    assert not torch.equal(a, x["spins"].view(d, s, *shape))


@pytest.mark.parametrize("shape,d,n_rep,n_temps", [
    ((8, 8, 8), 8, 4, 24), ((16, 16, 16), 8, 4, 24), ((32, 32), 1, 2, 16),
    ((4, 4, 10), 2, 3, 3),
], ids=["config4", "config5", "config1", "4x4x10-odd-slots"])
def test_colour_pass_layout_and_launches(cuda, shape, d, n_rep, n_temps):
    """colour_pass's plan at the replica configs: at 8^3 and 32^2 several
    slots fill each CTA (gp x sub = 256 threads where the slots divide so),
    at 16^3 a thread takes the rule's slots in turn; one launch a pass."""
    x = _pair_inputs(cuda, 9, shape, d, n_rep, n_temps)
    s = n_rep * n_temps
    dims = _build.dims3(shape)
    plan = mega._colour_plan(cuda, (d, s, *dims))
    groups = -(-int(np.prod(shape)) // 8)
    if groups <= 128:
        assert plan.gp >= groups and plan.gp * plan.sub <= 256 and plan.sub == plan.per
    if shape in ((8, 8, 8), (32, 32)):
        assert plan.gp * plan.sub == 256
    mega.reset_launches()
    a = x["spins"].view(d, s, *shape).clone()
    mega.colour_pass(a, x["jgrids"], x["sid"], x["slot_temps"],
                     torch.zeros((d, 2), dtype=torch.int32, device=cuda), 1, gibbs=False)
    torch.cuda.synchronize()
    assert mega.LAUNCHES == {"colour_pass": 1, "pt_step": 0, "mega_resident": 0}


@pytest.mark.parametrize("shape,d,n_rep,n_temps,shift", [
    ((8, 8, 8), 8, 4, 24, 0), ((16, 16, 16), 8, 4, 24, 0), ((32, 32), 8, 2, 16, 0),
    ((8, 64), 3, 3, 4, 0), ((2, 2), 2, 2, 3, 0), ((2, 8), 2, 6, 3, 0),
    ((8, 2), 1, 4, 5, 0), ((2, 2, 2), 3, 6, 2, 0), ((4, 6, 12), 2, 4, 3, 0),
    ((6, 2, 10), 2, 2, 4, 0), ((4, 4, 16), 2, 4, 3, 4), ((16, 16), 2, 6, 3, 2),
    ((64, 64, 64), 1, 2, 2, 0),
], ids=["config4", "config5", "config1", "2d-odd-R", "2x2", "2x8-R6", "8x2", "2x2x2-R6",
        "4x6x12-w4", "6x2x10-site", "4x4x16-shift4", "16x16-shift2-R6", "64^3"])
def test_pair_overlap_kernel_matches_plain(cuda, shape, d, n_rep, n_temps, shift):
    """qs, ql bitwise the plain version, written into strided row views:
    configs 4, 5 and 1, extents of 2 (the per-site path), fast extents of
    4-byte words, spins that start 4 or 2 bytes past an 8-byte boundary
    (4-byte and per-site words), R = 6, and a column of 1024 threads."""
    from peapods_tpu_torch.ops import megapair

    x = _pair_inputs(cuda, 7, shape, d, n_rep, n_temps)
    spins = x["spins"]
    if shift:
        buf = torch.empty(spins.numel() + 8, dtype=torch.int8, device=cuda)
        spins = buf[shift:shift + spins.numel()].view(spins.shape)
        spins.copy_(x["spins"])
        assert spins.data_ptr() % 8 == shift
    cols = (n_rep // 2) * n_temps
    qs = torch.full((d, 3, cols), -7, dtype=torch.int32, device=cuda)
    ql = torch.full_like(qs, -7)
    megapair.LAUNCHES["pair_overlap"] = 0
    megapair.pair_overlap(spins, x["sid"], qs[:, 1], ql[:, 1], shape=shape,
                          n_replicas=n_rep)
    torch.cuda.synchronize()
    assert megapair.LAUNCHES["pair_overlap"] == 1
    ps, pl = megapair.pair_overlap_plain(x["spins"], x["sid"], shape, n_rep)
    assert torch.equal(qs[:, 1], ps)
    assert torch.equal(ql[:, 1], pl)
    # the rows beside the one written are untouched
    assert bool((qs[:, 0::2] == -7).all()) and bool((ql[:, 0::2] == -7).all())


_TRI = [[1, 0], [0, 1], [1, -1]]
_NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
# pair_overlap over offset tables: the square and cubic lattices as their
# axes' tables, the triangular, BCC, FCC and NNN lattices at the smoke's
# shapes (binder_crossings.py's 32^2 and 10^3: 10 sites a line take the
# per-site path) and at widths of 8- and 4-byte words, tables with negative
# and long components and a self-bond, spins off the 8-byte boundary
PAIR_OFFSETS = [
    ("square-32", (32, 32), None, 0), ("cubic-10", (10, 10, 10), None, 0),
    ("tri-32", (32, 32), "triangular", 0), ("tri-8x12", (8, 12), "triangular", 0),
    ("tri-16-shift4", (16, 16), "triangular", 4), ("bcc-10", (10, 10, 10), "bcc", 0),
    ("bcc-8", (8, 8, 8), "bcc", 0), ("fcc-10", (10, 10, 10), "fcc", 0),
    ("fcc-4x4x16", (4, 4, 16), "fcc", 0), ("fcc-6x4x12-shift2", (6, 4, 12), "fcc", 2),
    ("nnn-16", (16, 16), _NNN, 0), ("nnn-6x10", (6, 10), _NNN, 0),
    ("table-8x8", (8, 8), [[-1, 2], [0, -3], [2, 1]], 0),
    ("table-4x6x8", (4, 6, 8), [[0, 0, -1], [2, 0, 3]], 0),
    ("self-bond-4x8", (4, 8), [[0, 8], [1, 0]], 0), ("fast5-8x4", (8, 4), [[1, 0], [0, 5]], 0),
]


@pytest.mark.parametrize("n_rep", [2, 4])
@pytest.mark.parametrize("name,shape,geometry,shift", PAIR_OFFSETS,
                         ids=[x[0] for x in PAIR_OFFSETS])
def test_pair_overlap_offsets_kernel_matches_plain(cuda, name, shape, geometry, shift,
                                                   n_rep):
    """qs, ql over the lattice's forward offsets bitwise the plain version,
    one launch into a strided row view: an offset's neighbour word is the
    word of the line its slower components reach, shifted by its fast
    component's bytes (a negative component wraps)."""
    from peapods_tpu_torch.ops import megapair
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS

    offsets = GEOMETRY_OFFSETS[geometry] if isinstance(geometry, str) else geometry
    d, n_temps = 2, 3
    x = _pair_inputs(cuda, 11, shape, d, n_rep, n_temps)
    spins = x["spins"]
    if shift:
        buf = torch.empty(spins.numel() + 8, dtype=torch.int8, device=cuda)
        spins = buf[shift:shift + spins.numel()].view(spins.shape)
        spins.copy_(x["spins"])
    cols = (n_rep // 2) * n_temps
    qs = torch.full((d, 3, cols), -7, dtype=torch.int32, device=cuda)
    ql = torch.full_like(qs, -7)
    megapair.LAUNCHES["pair_overlap"] = 0
    megapair.pair_overlap(spins, x["sid"], qs[:, 1], ql[:, 1], shape=shape,
                          n_replicas=n_rep, offsets=offsets)
    torch.cuda.synchronize()
    assert megapair.LAUNCHES["pair_overlap"] == 1
    ps, pl = megapair.pair_overlap_plain(x["spins"], x["sid"], shape, n_rep, offsets)
    assert torch.equal(qs[:, 1], ps)
    assert torch.equal(ql[:, 1], pl)
    assert bool((qs[:, 0::2] == -7).all()) and bool((ql[:, 0::2] == -7).all())


@pytest.mark.parametrize("shape,geometry,n_rep,kw", [
    ((16, 16), "triangular", 2, dict(cluster_update_interval=1, cluster_mode="sw",
                                     collect_cluster_stats=True)),
    ((8, 8, 8), "bcc", 2, dict(cluster_update_interval=1, cluster_mode="sw",
                               pt_schedule="full_ladder")),
    ((10, 10, 10), "fcc", 2, dict(cluster_update_interval=2, cluster_mode="wolff")),
    ((8, 8, 8), None, 4, dict(cluster_update_interval=1, cluster_mode="sw",
                              overlap_cluster_update_interval=2,
                              overlap_cluster_build_mode="cmr+houd4",
                              overlap_cluster_mode="sw", collect_cluster_stats=True,
                              snapshot_interval=2)),
    ((16, 16), None, 2, dict(overlap_cluster_update_interval=3,
                             overlap_cluster_build_mode="jorg+houdayer",
                             overlap_cluster_mode="wolff", snapshot_interval=6)),
], ids=["tri-sw-stats", "bcc-sw-full", "fcc-wolff", "cubic-sw-cmr+houd4-snapshots",
        "square-snapshots"])
def test_replica_sweeps_sample_on_card_matches_the_cpu(cuda, shape, geometry, n_rep, kw):
    """The per-sweep replica path (an FK phase, a lattice other than square
    or cubic, or snapshots): the kernels on the card and the plain path on
    the CPU follow one trajectory (+-1 couplings: every energy sum is an
    exact integer), with the same pair records, FK and overlap statistics
    and snapshots; one pair_overlap launch a sweep."""
    from peapods_tpu_torch.ops import megapair

    geo = {} if geometry is None else dict(geometry=geometry)
    temps = np.geomspace(1.0, 4.0, 4).astype(np.float32)

    def model(dev):
        return Ising(shape, couplings="bimodal", temperatures=temps, n_replicas=n_rep,
                     n_disorder=2, seed=8, device=dev, **geo)

    a, c = model("cuda"), model("cpu")
    kw = dict(kw, pt_interval=1)
    megapair.LAUNCHES["pair_overlap"] = 0
    ra = a.sample(24, **kw)
    assert megapair.LAUNCHES["pair_overlap"] == 24
    rc = c.sample(24, **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips",
                "pt_trip_state"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    for key in ("mags", "mags2", "energies", "energies2", "overlap", "overlap2",
                "link_overlap", "link_overlap2", "ql_at_q_sum"):
        np.testing.assert_allclose(ra[key], rc[key], rtol=1e-12, err_msg=key)
    np.testing.assert_array_equal(np.asarray(ra["overlap_histogram"]),
                                  np.asarray(rc["overlap_histogram"]))
    for key in ("fk_csd", "overlap_csd", "top_cluster_sizes"):
        assert (key in ra) == (key in rc), key
        if key in rc:
            np.testing.assert_array_equal(np.asarray(ra[key]), np.asarray(rc[key]),
                                          err_msg=key)
    sa, sc = ra.get("cluster_snapshots", []), rc.get("cluster_snapshots", [])
    assert len(sa) == len(sc) == (0 if "snapshot_interval" not in kw else
                                  len(range(6, 24, kw["snapshot_interval"])))
    for x, y in zip(sa, sc):
        assert sorted(x) == sorted(y)
        for key in y:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


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


# (shape, d, n_rep, n_temps, couplings, spins' offset past an 8-byte
# boundary): config 4, the 8 x 64 square, config 5's shape (16^3 gaussian)
# and 6^3 (a fast extent off the 4-byte word) with spins 4 bytes off
MOVE_SHAPES = [((8, 8, 8), 8, 4, 24, "pm", 0), ((8, 64), 2, 2, 3, "pm", 0),
               ((16, 16, 16), 8, 4, 24, "gauss", 0), ((6, 6, 6), 2, 4, 3, "gauss", 4)]
MOVE_IDS = ["config4", "2d", "config5", "6cube-plus4"]


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("shape,d,n_rep,n_temps,couplings,offset", MOVE_SHAPES, ids=MOVE_IDS)
def test_overlap_event_kernel_matches_plain(cuda, shape, d, n_rep, n_temps, couplings,
                                            offset, kind, wolff):
    """One move of every task: spins and labels (CMR: grey and blue)
    bitwise; Houdayer (through the houdn_* kernels) keeps E_a + E_b of
    every task."""
    from peapods_tpu_torch.ops import fk, overlap
    from peapods_tpu_torch.ops.energy import bond_sums

    x = _pair_inputs(cuda, 13, shape, d, n_rep, n_temps, couplings)
    x["spins"] = _offset_copy(x["spins"], offset)
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
        # summed in float64: +-J exactly, gaussian to ~1e-12
        cd = x["coup"].double()[:, None]
        e0 = bond_sums(x["spins"], cd, shape)
        e1 = bond_sums(a, cd, shape)
        pair = lambda e: e[di, sys[..., 0]] + e[di, sys[..., 1]]  # noqa: E731
        drift = float((pair(e1) - pair(e0)).abs().max())
        assert drift <= (1e-9 if couplings == "gauss" else 0.0)


@pytest.mark.parametrize("per", ["rule", "one", "most"])
@pytest.mark.parametrize("kind", ["jorg", "cmr"])
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("shape,d,n_rep,n_temps,couplings,offset",
                         MOVE_SHAPES + [((8, 64), 2, 2, 3, "gauss", 1)],
                         ids=MOVE_IDS + ["2d-plus1"])
def test_ov_bonds_and_mid_states_match_plain_bonds(cuda, shape, d, n_rep, n_temps,
                                                   couplings, offset, kind, wolff, per):
    """ov_bonds' state bytes and seeds and ov_mid's state2 bytes (the grey
    bonds and the blue flip) and blue labels, launched through
    ``launch_event`` on a ``Scratch``, bitwise ``bond_states_plain`` and
    the plain blue labels: the rule's tasks a thread, one, and the most a
    thread takes (the largest divisor of a realization's tasks up to
    OV_MAX_PER), the vector path and the per-site one (6^3; spins 1 byte
    off), a Joerg task with no active probe."""
    from peapods_tpu_torch.ops import _build, fk, overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    tg = n_temps * (n_rep // 2)
    per = {"rule": 0, "one": 1,
           "most": max(p for p in range(1, overlap.OV_MAX_PER + 1) if tg % p == 0)}[per]
    x = _pair_inputs(cuda, 31, shape, d, n_rep, n_temps, couplings)
    n = int(np.prod(shape))
    tab = _event_inputs(x, d, n_rep, n_temps, n, kind, wolff, 3)
    if kind == "jorg":  # task 0's pair equal: no probe is active
        sys, _, _ = overlap.gather_tasks(x["spins"], x["sid"], tab[0], n_temps)
        x["spins"][0, sys[0, 0, 0, 1]] = x["spins"][0, sys[0, 0, 0, 0]]
    spins = _offset_copy(x["spins"], offset)
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    st, st2, seeds = overlap.bond_states_plain(spins.clone(), *args, kind=kind, wolff=wolff,
                                               shape=shape)
    if kind == "jorg" and wolff:
        assert int(seeds[0]) == n
    dims, _ = overlap.check_event(spins, *args, shape, kind)
    tasks_n = dims[0]
    scratch = overlap.Scratch(tasks_n, n, cuda, kind == "cmr")
    blue = torch.full((tasks_n, n), -1, dtype=torch.int32, device=cuda)
    for k in overlap.LAUNCHES:
        overlap.LAUNCHES[k] = 0
    overlap.launch_event(_build.library(), torch.cuda.current_stream(cuda).cuda_stream,
                         dims, spins.data_ptr(), *(t.data_ptr() for t in args),
                         scratch.ptrs(), kind=kind, wolff=wolff,
                         p_blue=blue.data_ptr() if kind == "cmr" else None, per=per)
    torch.cuda.synchronize()
    assert overlap.LAUNCHES["ov_bonds"] == 1
    assert overlap.LAUNCHES["ov_mid"] == (kind == "cmr")
    assert torch.equal(scratch.state, st)
    assert torch.equal(scratch.seeds, seeds)
    if kind == "cmr":
        assert torch.equal(scratch.state2, st2)
        bonds = fk.state_masks(st, len(shape))
        assert torch.equal(blue, connected_components(bonds, shape).to(torch.int32))
        assert int((st2 >> 7).sum()) > 0


def test_energy_partials_kernel_matches_plain(cuda):
    from peapods_tpu_torch.ops import overlap

    for shape in ((8, 8, 8), (16, 16, 16), (8, 64)):
        x = _pair_inputs(cuda, 17, shape, 4, 4, 6)
        ek, mk = overlap.energy_partials(x["spins"], x["coup"], shape)
        ep, mp = overlap.energy_partials_plain(x["spins"], x["coup"], shape)
        assert torch.equal(ek.sum(-1), ep.sum(-1))  # +-1 sums: exact
        assert torch.equal(mk.sum(-1), mp.sum(-1))
        bp = overlap.energy_partials_plain(x["spins"], x["coup"], shape, blocks=True)
        assert torch.equal(ek, bp[0]) and torch.equal(mk, bp[1])


def _offset_copy(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past an
    8-byte boundary (the kernels' word widths follow the address)."""
    buf = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8, device=t.device)
    out = buf[offset:offset + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 8 == offset % 8
    return out


@pytest.mark.parametrize("offset", [0, 4, 2], ids=["aligned", "plus4", "plus2"])
@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 16, 16), (8, 64), (6, 10), (4, 6, 8)],
                         ids=["8cube", "16cube", "8x64", "6x10", "4x6x8"])
def test_energy_partials_partials_are_bitwise_block_plain(cuda, shape, couplings, offset):
    """Every partial bitwise ``energy_partials_plain(blocks=True)``: +-1 and
    gaussian couplings, spins aligned and 4 or 2 bytes past an 8-byte
    boundary (8-, 4-byte and per-site words), the rule's systems a warp and
    1, 2, 3, 4, 6 of them."""
    from peapods_tpu_torch.ops import overlap

    x = _pair_inputs(cuda, 23 + offset, shape, 3, 2, 6, couplings=couplings)
    spins = _offset_copy(x["spins"], offset)
    want = overlap.energy_partials_plain(spins, x["coup"], shape, blocks=True)
    overlap.LAUNCHES["energy_partials"] = 0
    for per in (0, 1, 2, 3, 4, 6):
        ek, mk = overlap.energy_partials(spins, x["coup"], shape, per=per)
        torch.cuda.synchronize()
        assert torch.equal(ek.view(torch.int32), want[0].view(torch.int32)), per
        assert torch.equal(mk, want[1]), per
    assert overlap.LAUNCHES["energy_partials"] == 6


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
        bp = energy.measure_nb_plain(b, x["coup"], lat, blocks=True)
        torch.cuda.synchronize()
        assert torch.equal(a, b), step
        assert torch.equal(ek.sum(-1), ep.sum(-1)), step
        assert torch.equal(mk.sum(-1), mp.sum(-1)), step
        assert torch.equal(ek, bp[0]) and torch.equal(mk, bp[1]), step
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
    bp = energy.measure_nb_plain(b, x["coup"], lat, blocks=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(mk.sum(-1), mp.sum(-1))
    torch.testing.assert_close(ek.sum(-1), ep.sum(-1), rtol=1e-5, atol=1e-4)
    assert torch.equal(ek.view(torch.int32), bp[0].view(torch.int32))
    assert torch.equal(mk, bp[1])


MEASURE_SHAPES = NB_SHAPES + [("cubic-8", (8, 8, 8), None, 2, 6),
                              ("cubic-16", (16, 16, 16), None, 1, 4),
                              ("square-8x64", (8, 64), None, 2, 4)]


@pytest.mark.parametrize("offset", [0, 4, 2], ids=["aligned", "plus4", "plus2"])
@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("name,shape,geometry,d,n_sys", MEASURE_SHAPES,
                         ids=[s[0] for s in MEASURE_SHAPES])
def test_measure_nb_partials_are_bitwise_block_plain(cuda, name, shape, geometry, d, n_sys,
                                                     couplings, offset):
    """Every partial bitwise ``measure_nb_plain(blocks=True)``: +-1 and
    gaussian couplings, spins aligned and 4 or 2 bytes past an 8-byte
    boundary, the rule's systems a thread and every count from 1 to 8 that
    divides the systems."""
    from peapods_tpu_torch.ops import energy

    lat, x = _nb_inputs(cuda, 31 + offset, shape, geometry, d, n_sys, couplings=couplings)
    spins = _offset_copy(x["spins"], offset)
    want = energy.measure_nb_plain(spins, x["coup"], lat, blocks=True)
    pers = [None] + [p for p in range(1, 9) if n_sys % p == 0]
    energy.LAUNCHES["measure_nb"] = 0
    for per in pers:
        ek, mk = energy.measure_nb(spins, x["coup"], lat, per=per)
        torch.cuda.synchronize()
        assert torch.equal(ek.view(torch.int32), want[0].view(torch.int32)), per
        assert torch.equal(mk, want[1]), per
    assert energy.LAUNCHES["measure_nb"] == len(pers)


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
# the staged bonds alone, beside those: the smoke's FCC 16^3 x 8, a
# 3-offset table, a negative axis-0 offset, an offset of length 2 along the
# fast axis, rows of 6 sites (the per-site path) and a batch whose threads
# loop over graphs
STAGED_BONDS = [*STAGED, ("fcc-16", (16, 16, 16), "fcc", 1, 8, 9.8),
                ("three-6x8x4", (6, 8, 4), [[1, 0, 0], [0, 1, 1], [1, -1, 2]], 2, 2, 3.0),
                ("neg0-8x12", (8, 12), [[-1, 2], [0, 1]], 1, 4, 2.5),
                ("len2-6x10", (6, 10), [[0, 2], [1, 0], [1, -2]], 2, 2, 3.5),
                ("fcc-6x4x6", (6, 4, 6), "fcc", 1, 3, 9.8),
                ("nnn-64x2048", (64, 64), NNN, 128, 16, 5.3)]


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


# the labelling on both sides of csrc/cc.cu kCcSites (8192 sites): whole
# graphs (8 of them: over clusters of CTAs, a last slab cut short too), and
# boxes that split a graph along one, two or three axes, with diagonal
# offsets, an offset of length 2, extents of 2 and a fast axis longer than
# a CTA
CC_SHAPES = [*((c[0], c[1], c[2]) for c in STAGED),
             ("fcc-32", (32, 32, 32), "fcc"), ("bcc-24x20x22", (24, 20, 22), "bcc"),
             ("nnn-128", (128, 128), NNN), ("tri-100x96", (100, 96), "triangular"),
             ("len2-96", (96, 96), [[2, 0], [0, 1], [1, -2]]),
             ("nnn-2x4096-whole", (2, 4096), NNN), ("nnn-2x4100", (2, 4100), NNN),
             ("fcc-2x2x4096", (2, 2, 4096), "fcc"), ("bcc-64x2x64-whole", (64, 2, 64), "bcc"),
             ("len2-3d-18x18x30", (18, 18, 30), [[0, 0, 1], [2, 1, 0], [0, -2, 1]]),
             ("nnn-18x30-ragged-slabs", (18, 30), NNN)]


@pytest.mark.parametrize("name,shape,geometry", CC_SHAPES, ids=[c[0] for c in CC_SHAPES])
def test_cc_labels_kernel_matches_plain(cuda, name, shape, geometry):
    """cc_link (and, where its boxes split a graph, cc_link_border and
    fk_link_flatten) on batches of random masks from empty to full: labels
    bitwise the min-label fixed point, in the launches cc.link_launches
    names."""
    from peapods_tpu_torch.ops import cc
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

    lat = Lattice(shape, GEOMETRY_OFFSETS[geometry] if isinstance(geometry, str)
                  else geometry)
    b = 8
    rng = np.random.default_rng(len(shape) + lat.n_neighbors)
    dens = np.linspace(0.0, 1.0, b)[:, None, None]
    masks = torch.from_numpy(rng.random((b, lat.n_spins, lat.n_neighbors)) < dens).to(cuda)
    for table in (cc.LAUNCHES, fk.LAUNCHES):
        for k in table:
            table[k] = 0
    got = cc.cc_labels(masks, lat)
    want = cc.cc_labels_plain(masks, lat)
    torch.cuda.synchronize()
    counts = {k: v for k, v in {**cc.LAUNCHES, **fk.LAUNCHES}.items() if v}
    assert counts == cc.link_launches(shape, b)
    assert (len(counts) > 1) == (lat.n_spins > 8192)
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


def _reset_winding():
    from peapods_tpu_torch.ops import winding

    for k in winding.LAUNCHES:
        winding.LAUNCHES[k] = 0


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
    _reset_winding()
    wx, wy = winding.winding_flags(masks, labels, shape)
    px, py = cluster.winding_flags(masks, labels, shape)
    torch.cuda.synchronize()
    assert {k: v for k, v in winding.LAUNCHES.items() if v} == winding.winding_launches(
        shape, b)
    assert torch.equal(wx, px) and torch.equal(wy, py)
    assert not wx[0] and wx[-1] and wy[-1]
    # labels of other masks: a component with no site labelled as itself
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    winding.winding_flags(torch.zeros_like(masks[:1]), torch.zeros_like(labels[:1]),
                          shape, errors=err)
    assert int(err) == 1
    with pytest.raises(ValueError, match="unsettled"):
        winding.winding_flags(torch.zeros_like(masks[:1]), torch.zeros_like(labels[:1]),
                              shape)


def test_winding_2048_graph_near_pc(cuda):
    """One 2048^2 graph at the bond-percolation threshold, more sites than
    the first design took (1,859,584): the tiled form, bitwise the plain
    version; and the error mark where one component's label names a site of
    another."""
    from peapods_tpu_torch.ops import cluster, winding

    shape, n = (2048, 2048), 2048 * 2048
    g = torch.Generator(device=cuda).manual_seed(2048)
    masks = torch.rand((1, n, 2), device=cuda, generator=g) < 0.5
    labels = cluster.connected_components(masks, shape)
    _reset_winding()
    wx, wy = winding.winding_flags(masks, labels, shape)
    px, py = cluster.winding_flags(masks, labels, shape)
    torch.cuda.synchronize()
    assert {k: v for k, v in winding.LAUNCHES.items() if v} == dict.fromkeys(
        winding.TILED, 1)
    assert torch.equal(wx, px) and torch.equal(wy, py)
    # relabel the largest component with another component's root: it holds
    # no site labelled as itself, the other holds two
    big = int(torch.bincount(labels[0].long()).argmax())
    other = int(labels[0, (labels[0] != big).nonzero()[0, 0]])
    bad = torch.where(labels == big, other, labels).to(torch.int32)
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    winding.winding_flags(masks, bad, shape, errors=err)
    assert int(err) == 1
    assert bool(winding.winding_check_plain(masks, bad, shape)[0])


def _hand_cases(l0, l1):
    """The hand cases: bool masks [n, 2] and their flags (wx, wy) on an
    l0 x l1 torus."""
    def grid():
        return np.zeros((l0, l1, 2), bool)

    full = np.ones((l0, l1, 2), bool)
    ring = grid()
    ring[:, 0, 0] = True  # column 0 closes along x
    seam = ring.copy()
    seam[l0 // 2, 0, 0] = False  # a path across the seam, no cycle
    stair = grid()
    # (k, k) -> (k, k+1) -> (k+1, k+1) until it closes: across the row seam
    # lcm / l0 times, the column seam lcm / l1 times
    for k in range(math.lcm(l0, l1)):
        stair[k % l0, k % l1, 1] = True
        stair[k % l0, (k + 1) % l1, 0] = True
    twice = grid()  # across the row seam down at column 0, back up at 1
    twice[l0 - 1, 0, 0] = twice[l0 - 1, 1, 0] = True
    twice[0, 0, 1] = twice[l0 - 1, 0, 1] = True
    row = grid()
    row[0, :, 1] = True  # row 0 closes along y
    cases = {"full": (full, (True, True)), "column-ring": (ring, (True, False)),
             "seam-path": (seam, (False, False)), "empty": (grid(), (False, False)),
             "twice-across-the-seam": (twice, (False, False)), "row-ring": (row, (False, True)),
             "staircase": (stair, (True, True))}
    return {k: (m.reshape(l0 * l1, 2), f) for k, (m, f) in cases.items()}


@pytest.mark.parametrize("shape", [(4, 4), (256, 256), (128, 512)],
                         ids=["4-whole", "256-tiled", "128x512-tiled"])
def test_winding_hand_cases(cuda, shape):
    from peapods_tpu_torch.ops import cluster, winding

    cases = _hand_cases(*shape)
    masks = torch.from_numpy(np.stack([m for m, _ in cases.values()])).to(cuda)
    labels = cluster.connected_components(masks, shape)
    wx, wy = winding.winding_flags(masks, labels, shape)
    px, py = cluster.winding_flags(masks, labels, shape)
    want = np.array([f for _, f in cases.values()])
    assert torch.equal(wx, px) and torch.equal(wy, py)
    np.testing.assert_array_equal(torch.stack([wx, wy], -1).cpu().numpy(), want)


@pytest.mark.parametrize("shape", [(2, 32767), (32767, 2), (5, 20000)],
                         ids=["2x32767", "32767x2", "5x20000"])
def test_winding_long_strips(cuda, shape):
    """Strips longer than the 16384-site rows of before, up to the largest
    extent (winding.MAX_EXTENT): the hand cases, whose staircase crosses
    one seam as often as the other extent has wrap bonds (the largest sheet
    offsets a graph can hold), give their flags; an extent beyond is
    refused."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from peapods_tpu_torch.ops import winding

    l0, l1 = shape
    n = l0 * l1
    cases = _hand_cases(l0, l1)
    sites = np.arange(n).reshape(l0, l1)
    ends = (np.roll(sites, -1, 0).reshape(-1), np.roll(sites, -1, 1).reshape(-1))
    labels = []
    for m, _ in cases.values():
        i = np.concatenate([sites.reshape(-1)[m[:, d]] for d in (0, 1)])
        j = np.concatenate([ends[d][m[:, d]] for d in (0, 1)])
        _, comp = connected_components(coo_matrix((np.ones(len(i)), (i, j)), (n, n)),
                                       directed=False)
        first = np.full(comp.max() + 1, n)
        np.minimum.at(first, comp, np.arange(n))
        labels.append(first[comp])
    masks = torch.from_numpy(np.stack([m for m, _ in cases.values()])).to(cuda)
    labels = torch.from_numpy(np.stack(labels).astype(np.int32)).to(cuda)
    _reset_winding()
    wx, wy = winding.winding_flags(masks, labels, shape)
    assert {k: v for k, v in winding.LAUNCHES.items() if v} == dict.fromkeys(
        winding.TILED, 1)
    want = np.array([f for _, f in cases.values()])
    np.testing.assert_array_equal(torch.stack([wx, wy], -1).cpu().numpy(), want)
    wide = (l0, winding.MAX_EXTENT + 1) if l0 < l1 else (winding.MAX_EXTENT + 1, l1)
    m = torch.zeros((1, wide[0] * wide[1], 2), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="extents"):
        winding.winding_flags(m, torch.zeros(m.shape[:2], dtype=torch.int32, device=cuda),
                              wide)


@pytest.mark.parametrize("shape,b,p", [((256, 256), 2, 0.5), ((256, 256), 3, 0.45),
                                       ((2048, 2048), 1, 0.5), ((96, 160), 8, 0.55)],
                         ids=["256", "256-sparse", "2048", "96x160"])
def test_winding_tiled_launches_match_their_plain_versions(cuda, shape, b, p):
    """The tiled form one launch at a time on the kernels' own inputs:
    winding_link's parents, each site's open component minimum in its box;
    winding_border's parents, which lead to the open labels; winding_wrap's
    flags from them; winding_check's error word, 0 on these labels."""
    from peapods_tpu_torch.ops import _build, cluster, fk, winding

    l0, l1 = shape
    n = l0 * l1
    g = torch.Generator(device=cuda).manual_seed(n + b)
    masks = torch.rand((b, n, 2), device=cuda, generator=g) < p
    labels = cluster.connected_components(masks, shape)
    plan = winding.winding_plan(shape, b)
    assert plan.tiled
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    parent = torch.full((b, n), -1, dtype=torch.int32, device=cuda)
    wsheet = torch.empty((b, n), dtype=torch.int64, device=cuda)
    cnt = torch.full((b, 3), 7, dtype=torch.int32, device=cuda)
    out = torch.empty(b, dtype=torch.uint8, device=cuda)
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    t0, t1, _ = plan.tile
    pm, pp, pw, pc = masks.data_ptr(), parent.data_ptr(), wsheet.data_ptr(), cnt.data_ptr()
    _build.check(lib.peapods_winding_link(pm, pp, pw, pc, b, l0, l1, t0, t1, plan.threads,
                                          stream), "winding_link")
    boxes = parent.clone()
    sites = torch.arange(n, device=cuda, dtype=torch.int64)
    assert torch.equal(boxes, winding.winding_link_plain(masks, shape, plan.tile))
    assert torch.equal(wsheet, (sites << 32).expand(b, n))
    assert not cnt.any()
    _build.check(lib.peapods_winding_border(pm, pp, b, l0, l1, t0, t1, stream),
                 "winding_border")
    open_labels = winding.winding_border_plain(masks, shape)
    assert torch.equal(fk.fk_link_flatten_plain(parent), open_labels)
    assert torch.equal(winding.winding_border_unions(boxes, masks, shape, plan.tile),
                       open_labels)
    _build.check(lib.peapods_winding_wrap(pm, pp, pw, out.data_ptr(), b, l0, l1, stream),
                 "winding_wrap")
    wx, wy = winding.winding_wrap_plain(masks, open_labels, shape)
    assert torch.equal((out & 1) != 0, wx) and torch.equal((out & 2) != 0, wy)
    px, py = cluster.winding_flags(masks, labels, shape)
    assert torch.equal(wx, px) and torch.equal(wy, py)
    _build.check(lib.peapods_winding_check(labels.data_ptr(), pp, pw, pc, err.data_ptr(), b,
                                           l0, l1, stream), "winding_check")
    torch.cuda.synchronize()
    assert int(err) == 0
    comps = (labels == sites).sum(-1, dtype=torch.int32)
    assert torch.equal(cnt[:, 0], comps) and torch.equal(cnt[:, 1], comps)


def test_observe_2048_runs_the_tiled_winding(cuda, monkeypatch):
    """cluster_action="observe" on a 2048^2 square (more sites than the
    first design took) through Ising.sample: every sweep's winding flags
    come from the tiled kernels, bitwise the plain version on the same
    masks and labels."""
    from peapods_tpu_torch.ops import cluster, winding

    seen = []
    kernel = winding.winding_flags

    def both(masks, labels, shape, errors=None):
        got = kernel(masks, labels, shape, errors=errors)
        seen.append((got, cluster.winding_flags(masks, labels, shape)))
        return got

    monkeypatch.setattr(winding, "winding_flags", both)
    model = Ising((2048, 2048), temperatures=np.array([2.269], np.float32), seed=5,
                  device=cuda)
    _reset_winding()
    model.sample(3, "metropolis", warmup_ratio=0.0, cluster_update_interval=1,
                 cluster_mode="sw", cluster_action="observe")
    torch.cuda.synchronize()
    assert {k: v for k, v in winding.LAUNCHES.items() if v} == dict.fromkeys(
        winding.TILED, 3)
    assert len(seen) == 3
    for (wx, wy), (px, py) in seen:
        assert torch.equal(wx, px) and torch.equal(wy, py)


def _finish_inputs(dev, seed, shape, d, n_sys, couplings, tri=False):
    """Spins, couplings, temperatures near each lattice's T_c and key words
    of ``d * n_sys`` graphs; the FK kernels' state bytes and labels (the
    labelling's parents) of one bond draw."""
    from peapods_tpu_torch.engine import seeds

    rng = np.random.default_rng(seed)
    b, n = d * n_sys, int(np.prod(shape))
    nd = 3 if (tri or len(shape) == 3) else 2
    coup = (rng.standard_normal((d, n, nd)) if couplings == "gauss"
            else np.ones((d, n, nd)))
    t_c = 3.64 if tri else 4.51 if len(shape) == 3 else 2.269
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    x = dict(spins=up(rng.choice([-1, 1], size=(b, *shape)).astype(np.int8)),
             j_fwd=up(coup.astype(np.float32)),
             temps=up(rng.uniform(0.9 * t_c, 1.1 * t_c, b).astype(np.float32)),
             kb=up(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)))
    kf = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
    x["scal"] = {w: up(seeds.fk_scalars(kf, n, wolff=w)) for w in (False, True)}
    x["state"], x["labels"] = fk._bonds_and_link(x["spins"], x["j_fwd"], x["temps"], x["kb"])
    return x


# (name, shape, realizations, systems, couplings, triangular): config 3, the
# harness, gaussian couplings, the triangular lattice, 32^3 x 16, a ragged
# cubic and square lattice, the unsharded 4096^2 x 4
FINISH_CASES = [
    ("256", (256, 256), 1, 1, "ferro", False),
    ("harness", (64, 64), 128, 16, "ferro", False),
    ("gauss-64", (64, 64), 2, 8, "gauss", False),
    ("tri-32", (32, 32), 2, 4, "gauss", True),
    ("cubic-32", (32, 32, 32), 1, 16, "gauss", False),
    ("cubic-8x6x10", (8, 6, 10), 3, 2, "ferro", False),
    ("6x10", (6, 10), 1, 3, "gauss", False),
    ("4096", (4096, 4096), 1, 4, "ferro", False),
]


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,d,n_sys,couplings,tri", FINISH_CASES,
                         ids=[c[0] for c in FINISH_CASES])
def test_fk_finish_matches_plain_with_its_partials(cuda, name, shape, d, n_sys, couplings,
                                                   tri, wolff):
    """fk_finish alone on the labelling's parents: the spins and every
    partial block's (e, m) bitwise fk_finish_plain's (the same sums in the
    same pairing); without measuring, the spins alone."""
    x = _finish_inputs(cuda, len(name) + wolff, shape, d, n_sys, couplings, tri)
    args = (x["j_fwd"], x["scal"][wolff])
    for measure in (True, False):
        a, p = x["spins"].clone(), x["spins"].clone()
        fk.LAUNCHES["fk_finish"] = 0
        ek, mk = fk.fk_finish(a, x["state"], x["labels"], *args, wolff=wolff,
                              with_measure=measure)
        ep, mp = fk.fk_finish_plain(p, x["labels"], *args, wolff=wolff,
                                    with_measure=measure, blocks=True)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["fk_finish"] == 1
        assert torch.equal(a, p)
        assert not torch.equal(a, x["spins"])
        if measure:
            assert ek.shape == ep.shape == (d * n_sys, -(-int(np.prod(shape)) // 256))
            assert torch.equal(ek, ep) and torch.equal(mk, mp)
        else:
            assert ek is None and mk is None


# fk_bonds alone: (name, shape, realizations, systems, couplings, triangular):
# config 3, the harness, gaussian couplings, the triangular lattice, 32^3 x
# 16, ragged rows of 6 and 10 sites (groups of four that straddle a row), a
# ragged box, the unsharded 4096^2 x 4
BONDS_CASES = [
    ("256", (256, 256), 1, 1, "ferro", False),
    ("harness", (64, 64), 128, 16, "ferro", False),
    ("gauss-64", (64, 64), 2, 8, "gauss", False),
    ("tri-32", (32, 32), 2, 4, "gauss", True),
    ("cubic-32", (32, 32, 32), 1, 16, "pm", False),
    ("6x6", (6, 6), 2, 3, "gauss", False),
    ("10x6-tri", (10, 6), 1, 4, "pm", True),
    ("6x10x4", (6, 10, 4), 2, 2, "gauss", False),
    ("4096", (4096, 4096), 1, 4, "ferro", False),
]


@pytest.mark.parametrize("temp", [0.05, 50.0], ids=["cold", "hot"])
@pytest.mark.parametrize("name,shape,d,n_sys,couplings,tri", BONDS_CASES,
                         ids=[c[0] for c in BONDS_CASES])
def test_fk_bonds_state_bytes_match_plain(cuda, name, shape, d, n_sys, couplings, tri, temp):
    """fk_bonds alone: every state byte (bond bits and "s differs" bits)
    bitwise fk_state_plain's, near T = 0 (every satisfied unit bond drawn)
    and at a large T, one launch; also with one graph a thread and a
    realization's graphs a thread, and on spins one byte off alignment (the
    per-site path everywhere)."""
    rng = np.random.default_rng(len(name) + int(temp))
    b, n = d * n_sys, int(np.prod(shape))
    nd = 3 if (tri or len(shape) == 3) else 2
    coup = {"gauss": rng.standard_normal((d, n, nd)), "ferro": np.ones((d, n, nd)),
            "pm": rng.choice([-1.0, 1.0], size=(d, n, nd))}[couplings]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    spins = up(rng.choice([-1, 1], size=(b, *shape)).astype(np.int8))
    j_fwd = up(coup.astype(np.float32))
    temps = up(rng.uniform(0.9 * temp, 1.1 * temp, b).astype(np.float32))
    kb = up(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32))
    want = fk.fk_state_plain(spins, j_fwd, temps, kb)
    fk.LAUNCHES["fk_bonds"] = 0
    got = fk.fk_bonds(spins, j_fwd, temps, kb)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fk_bonds"] == 1
    assert torch.equal(got, want)
    assert bool((want & ((1 << nd) - 1)).any()) and bool((want >> 3).any())
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    words = fk.bonds_words(shape, nd)
    for per in sorted({1, n_sys}):
        state = torch.full_like(got, 255)
        _build.check(lib.peapods_fk_bonds(spins.data_ptr(), j_fwd.data_ptr(), temps.data_ptr(),
                                          kb.data_ptr(), state.data_ptr(), words.ctypes.data,
                                          b, n_sys, per, stream), "fk_bonds")
        torch.cuda.synchronize()
        assert torch.equal(state, want), per
    if b * n < 2**24:
        off = torch.empty(b * n + 1, dtype=torch.int8, device=cuda)[1:].view(spins.shape)
        off.copy_(spins)
        assert torch.equal(fk.fk_bonds(off, j_fwd, temps, kb), want)


# fk_bonds_band alone: (name, shape, geometry, bands); windows whose rows
# are a multiple of 4 sites (the vector path) and are not (6-site rows, an
# 18-site window), 3D boxes whose fast rows of 10 and 6 sites straddle
# groups, the offset tables of up to six directions
BONDS_BAND_CASES = [
    ("square", (64, 64), None, 4), ("square-1024", (1024, 1024), None, 4),
    ("rows6", (12, 6), None, 3), ("tri6", (6, 6), "triangular", 6),
    ("cubic-8x6x10", (8, 6, 10), None, 4), ("cubic-4x6x6", (4, 6, 6), None, 2),
    ("fcc", (16, 16, 8), "fcc", 4), ("bcc", (8, 4, 8), "bcc", 2),
    ("tri", (16, 12), "triangular", 2),
]


@pytest.mark.parametrize("temp", [0.05, 50.0], ids=["cold", "hot"])
@pytest.mark.parametrize("name,shape,geometry,ns", BONDS_BAND_CASES,
                         ids=[c[0] for c in BONDS_BAND_CASES])
def test_fk_bonds_band_state_bytes_match_plain(cuda, name, shape, geometry, ns, temp):
    """fk_bonds_band alone on every band's window (random spins, gaussian and
    unit couplings): the state bytes bitwise fk_bonds_band_plain's, near T = 0
    and at a large T, with the launch's graphs a thread and one."""
    from types import SimpleNamespace

    from peapods_tpu_torch.ops import cc_band
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, BandGeometry, Lattice

    lat = Lattice(shape, GEOMETRY_OFFSETS[geometry] if geometry else None)
    rng = np.random.default_rng(len(name) + ns + int(temp))
    g, nb = 4, lat.n_neighbors
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for band in BandGeometry(lat, ns).bands:
        nw = band.n_window
        for couplings in ("gauss", "ferro"):
            j = (rng.standard_normal((1, nw, nb)) if couplings == "gauss"
                 else np.ones((1, nw, nb)))
            j_win = torch.from_numpy(j.astype(np.float32)).to(cuda)
            spins = torch.from_numpy(rng.choice([-1, 1], size=(g, nw)).astype(np.int8)).to(cuda)
            temps = torch.from_numpy(rng.uniform(0.9 * temp, 1.1 * temp, g).astype(
                np.float32)).to(cuda)
            kb = torch.from_numpy(rng.integers(-2**31, 2**31, (g, 2)).astype(np.int32)).to(cuda)
            want = SimpleNamespace(state=torch.empty((g, nw), dtype=torch.uint8, device=cuda))
            fk.fk_bonds_band_plain(spins, j_win, temps, kb, want, band)
            got = cc_band.BandCC.empty(g, band, cuda)
            got.state.fill_(255)
            fk.LAUNCHES["fk_bonds_band"] = 0
            fk.fk_bonds_band(spins, j_win, temps, kb, got, band)
            torch.cuda.synchronize()
            assert fk.LAUNCHES["fk_bonds_band"] == 1
            assert torch.equal(got.state, want.state), (band.k, couplings)
            state = torch.full_like(got.state, 255)
            _build.check(lib.peapods_fk_bonds_band(
                spins.data_ptr(), j_win.data_ptr(), temps.data_ptr(), kb.data_ptr(),
                state.data_ptr(), band.words.ctypes.data, g, g, 1, stream), "fk_bonds_band")
            torch.cuda.synchronize()
            assert torch.equal(state, want.state), (band.k, couplings, "one a thread")


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
def test_fk_finish_on_staged_labels_matches_plain(cuda, wolff):
    """fk_finish reading the CC labels of an offset table (BCC 16^3, no
    measurement): the spins bitwise the plain flips."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import cc

    lat, x = _staged_inputs(cuda, 21 + wolff, (16, 16, 16), "bcc", 2, 4, 6.3)
    scal = torch.from_numpy(seeds.fk_scalars(x["kf"], lat.n_spins, wolff=wolff)).to(cuda)
    bonds = fk.fk_bonds_plain(x["spins"], x["coup"], x["temps"], x["kb"],
                              offsets=lat.offsets)
    labels = cc.cc_labels(bonds, lat)
    a, p = x["spins"].clone(), x["spins"].clone()
    fk.fk_finish(a, None, labels, x["coup"], scal, wolff=wolff, with_measure=False)
    fk.fk_finish_plain(p, labels, x["coup"], scal, wolff=wolff, with_measure=False)
    torch.cuda.synchronize()
    assert torch.equal(a, p) and not torch.equal(a, x["spins"])


@pytest.mark.parametrize("shape,d,n_sys,n_dirs,temp", [
    ((256, 256), 1, 1, 2, 2.269), ((64, 64), 16, 8, 2, 2.269), ((32, 32), 1, 8, 3, 3.64),
    ((16, 16, 16), 1, 4, 3, 4.51),
], ids=["256", "64-128-graphs", "tri-32", "cubic-16"])
def test_fk_observe_kernel_matches_plain(cuda, shape, d, n_sys, n_dirs, temp):
    """FK observe: the spins stay bitwise unchanged; labels (the
    labelling's parents) and masks equal the plain version's."""
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
    # the labelling's parents, each its site's root, are the labels: no
    # flip launch
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fk_bonds": 1, **fk.link_launches(shape, b)}
    assert torch.equal(ka, s0)
    assert torch.equal(lk, lp)
    assert torch.equal(mk, mp)
    assert mk.any() and not mk.all()


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,geometry,d,n_sys,temp", STAGED_BONDS,
                         ids=[c[0] for c in STAGED_BONDS])
def test_fk_staged_kernels_match_plain(cuda, name, shape, geometry, d, n_sys, temp,
                                       wolff):
    """fk_bonds_staged, cc_link and fk_finish reading the labels:
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
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {"fk_bonds_staged": 1,
                                                          "fk_finish": 1}
    assert cc.LAUNCHES == {"cc_link": 1, "cc_link_border": 0, "cc_table_link": 0,
                           "cc_table_border": 0}
    assert torch.equal(mk, mp)
    assert torch.equal(lk, lp)
    assert torch.equal(a, p)
    assert not torch.equal(a, x["spins"])
    o = x["spins"].clone()
    lo, mo = fk.fk_staged(o, x["coup"], x["temps"], None, x["kb"], lat, wolff=False,
                          with_masks=True)
    torch.cuda.synchronize()
    assert torch.equal(o, x["spins"]) and torch.equal(lo, lk) and torch.equal(mo, mk)


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("name,shape,geometry,d,n_sys,temp", STAGED_BONDS,
                         ids=[c[0] for c in STAGED_BONDS])
def test_fk_bonds_staged_state_is_the_plain_bonds(cuda, name, shape, geometry, d, n_sys,
                                                  temp, couplings):
    """fk_bonds_staged's state bytes: bit k the bond along offset k, bitwise
    fk_bonds_plain(..., offsets), and no other bit."""
    lat, x = _staged_inputs(cuda, 11, shape, geometry, d, n_sys, temp)
    coup = x["coup"]
    if couplings == "gauss":
        rng = np.random.default_rng(5)
        coup = torch.from_numpy(rng.standard_normal(tuple(coup.shape)).astype(
            np.float32)).to(cuda)
    b = x["spins"].shape[0]
    state = torch.full((b, lat.n_spins), 0xAA, dtype=torch.uint8, device=cuda)
    fk.launch_staged_bonds(_build.library(), torch.cuda.current_stream(cuda).cuda_stream,
                           x["spins"], coup, x["temps"], x["kb"], state, lat)
    bonds = fk.fk_bonds_plain(x["spins"], coup, x["temps"], x["kb"], offsets=lat.offsets)
    torch.cuda.synchronize()
    bits = torch.arange(lat.n_neighbors, dtype=torch.uint8, device=cuda)
    want = (bonds.to(torch.uint8) << bits).sum(-1, dtype=torch.uint8)
    assert torch.equal(state, want)
    assert bonds.any() and not bonds.all()


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


def _move_per(plan, n_temps, n_groups, g):
    """The tasks a thread: the rule's (0), one, or the most a thread takes
    (the largest divisor of a realization's tasks the rule allows)."""
    from peapods_tpu_torch.ops import overlap

    most = min(overlap.OV_MAX_PER, max(1, overlap.HOUDN_ROWS // g))
    tg = n_temps * n_groups
    return {"rule": 0, "one": 1, "most": max(p for p in range(1, most + 1) if tg % p == 0)}[plan]


# (shape, d, replicas, temperatures, spins' offset past an 8-byte
# boundary): config 4, 2D, a fast extent off the word (6^3, 8 x 6), and
# the per-site path on spins 1 byte off
ALONE_SHAPES = [((8, 8, 8), 4, 12, 6, 0), ((8, 64), 2, 12, 3, 0), ((6, 6, 6), 2, 12, 3, 0),
                ((8, 6), 2, 12, 3, 0), ((4, 8, 8), 2, 12, 3, 1)]
ALONE_IDS = ["8cube", "2d", "6cube", "8x6", "4x8x8-plus1"]


@pytest.mark.parametrize("per", ["rule", "one", "most"])
@pytest.mark.parametrize("g", [2, 4, 6])
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("shape,d,n_rep,n_temps,offset", ALONE_SHAPES, ids=ALONE_IDS)
def test_houdn_bonds_alone_matches_plain(cuda, shape, d, n_rep, n_temps, offset, wolff, g,
                                         per):
    """houdn_bonds launched alone: its state bytes and seeds bitwise
    ``houdn_states_plain`` (groups of 2, 4, 6; the vector and per-site
    paths; every plan of tasks a thread); it writes no parent."""
    from peapods_tpu_torch.ops import overlap

    x = _pair_inputs(cuda, 41 + g, shape, d, n_rep, n_temps)
    n = int(np.prod(shape))
    tab = _event_inputs(x, d, n_rep, n_temps, n, "houdayer", wolff, 13, g=g)
    spins = _offset_copy(x["spins"], offset)
    st, sd = overlap.houdn_states_plain(spins, x["sid"], tab[0], tab[2], wolff=wolff,
                                        shape=shape)
    b = st.shape[0]
    state = torch.full((b, n), 0xAA, dtype=torch.uint8, device=cuda)
    seeds = torch.full((b,), -1, dtype=torch.int32, device=cuda)
    per = _move_per(per, n_temps, n_rep // g, g) or overlap.ov_per(
        n, d, n_temps, n_rep // g, fk.resident_threads(cuda.index) // 4,
        max(1, overlap.HOUDN_ROWS // g))
    words = overlap.ov_words(shape, d, n_temps, n_rep // g, n_rep * n_temps, per)
    _build.check(_build.library().peapods_houdn_bonds(
        spins.data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(), tab[2].data_ptr(),
        state.data_ptr(), seeds.data_ptr(), words.ctypes.data, g, int(wolff),
        torch.cuda.current_stream(cuda).cuda_stream), "houdn_bonds")
    torch.cuda.synchronize()
    assert torch.equal(state, st)
    assert torch.equal(seeds, sd)
    assert int(st.sum()) > 0 and (not wolff or int((sd < n).sum()) > 0)


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("g,d", [(256, 2), (24578, 1)], ids=["g256", "rows-past-48k"])
def test_houdn_bonds_large_groups_match_plain(cuda, g, d, wolff):
    """houdn_bonds on one group of g replicas at one temperature (4^3):
    g = 256 counts in 16-bit lanes (past g = 254), and g past HOUDN_ROWS
    stages more than 48 KB of member slots (the launch opts in to more
    shared memory).  Half the members are the other half negated on half
    the sites, so balanced sites and bonds are many; state bytes and seeds
    bitwise ``houdn_states_plain``."""
    from peapods_tpu_torch.ops import overlap

    shape = (4, 4, 4)
    n = 64
    assert g > 254 and (g == 256 or g > overlap.HOUDN_ROWS)
    x = _pair_inputs(cuda, 47, shape, d, g, 1)
    mask = torch.from_numpy(np.random.default_rng(5).random(n) < 0.5).to(cuda)
    half = x["spins"][:, g // 2:]
    half[:, :, mask] = -x["spins"][:, :g // 2][:, :, mask]
    tab = _event_inputs(x, d, g, 1, n, "houdayer", wolff, 19, g=g)
    st, sd = overlap.houdn_states_plain(x["spins"], x["sid"], tab[0], tab[2], wolff=wolff,
                                        shape=shape)
    state = torch.full((d, n), 0xAA, dtype=torch.uint8, device=cuda)
    seeds = torch.full((d,), -1, dtype=torch.int32, device=cuda)
    per = overlap.ov_per(n, d, 1, 1, fk.resident_threads(cuda.index) // 4,
                         max(1, overlap.HOUDN_ROWS // g))
    words = overlap.ov_words(shape, d, 1, 1, g, per)
    _build.check(_build.library().peapods_houdn_bonds(
        x["spins"].data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(), tab[2].data_ptr(),
        state.data_ptr(), seeds.data_ptr(), words.ctypes.data, g, int(wolff),
        torch.cuda.current_stream(cuda).cuda_stream), "houdn_bonds")
    torch.cuda.synchronize()
    assert torch.equal(state, st)
    assert torch.equal(seeds, sd)
    assert int(fk.state_masks(st, 3).sum()) > 0 and (not wolff or int((sd < n).sum()) == d)


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("g,d", [(256, 2), (24578, 1)], ids=["g256", "rows-past-48k"])
def test_houdn_move_large_groups_match_plain(cuda, g, d, wolff):
    """houdn_bonds -> fk_link -> houdn_finish on one group of g replicas at
    one temperature (4^3), as ``test_houdn_bonds_large_groups_match_plain``
    builds it: g = 256 and g past HOUDN_ROWS, where both kernels stage more
    than 48 KB of member slots (their launches opt in to more shared
    memory).  Every member's spins and the labels bitwise the plain move."""
    from peapods_tpu_torch.ops import overlap

    shape = (4, 4, 4)
    n = 64
    assert g > 254 and (g == 256 or g > overlap.HOUDN_ROWS)
    x = _pair_inputs(cuda, 53, shape, d, g, 1)
    mask = torch.from_numpy(np.random.default_rng(7).random(n) < 0.5).to(cuda)
    half = x["spins"][:, g // 2:]
    half[:, :, mask] = -x["spins"][:, :g // 2][:, :, mask]
    tab = _event_inputs(x, d, g, 1, n, "houdayer", wolff, 23, g=g)
    a, b = x["spins"].clone(), x["spins"].clone()
    for k in overlap.LAUNCHES:
        overlap.LAUNCHES[k] = 0
    kw = dict(kind="houdayer", wolff=wolff, shape=shape, with_labels=True)
    lk = overlap.overlap_event(a, x["sid"], tab[0], x["coup"], x["temps"], *tab[1:], **kw)
    lp = overlap.overlap_event_plain(b, x["sid"], tab[0], x["coup"], x["temps"], *tab[1:],
                                     **kw)
    torch.cuda.synchronize()
    assert overlap.LAUNCHES["houdn_bonds"] == overlap.LAUNCHES["houdn_finish"] == 1
    assert torch.equal(a, b)
    assert torch.equal(lk.labels, lp.labels)
    assert not torch.equal(a, x["spins"])


@pytest.mark.parametrize("per", ["rule", "one", "most"])
@pytest.mark.parametrize("kind,g", [("houdayer", 2), ("houdayer", 4), ("houdayer", 6),
                                    ("jorg", 2), ("cmr", 2)],
                         ids=["houdayer-g2", "houdayer", "houdayer-g6", "jorg", "cmr"])
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("shape,d,n_rep,n_temps,offset", ALONE_SHAPES, ids=ALONE_IDS)
def test_finish_alone_matches_finish_plain(cuda, shape, d, n_rep, n_temps, offset, wolff,
                                           kind, g, per):
    """ov_finish (Joerg, CMR) and houdn_finish (Houdayer, g = 2, 4, 6)
    launched alone on the plain version's state bytes, flat parents and
    seeds (CMR: state2 and the grey parents), every plan of tasks a thread:
    every spin bitwise ``finish_plain``, the parents left as they were; a
    Joerg task with no active probe (seed n) flips nothing."""
    from peapods_tpu_torch.ops import overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    x = _pair_inputs(cuda, 43, shape, d, n_rep, n_temps, "gauss")
    n = int(np.prod(shape))
    tab = _event_inputs(x, d, n_rep, n_temps, n, kind, wolff, 17, g=g)
    sys = overlap.gather_tasks(x["spins"], x["sid"], tab[0], n_temps)[0]
    if kind == "jorg":  # task 0's pair equal: no probe is active
        x["spins"][0, sys[0, 0, 0, 1]] = x["spins"][0, sys[0, 0, 0, 0]]
    spins = _offset_copy(x["spins"], offset)
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    if kind == "houdayer":
        st, sd = overlap.houdn_states_plain(spins, x["sid"], tab[0], tab[2], wolff=wolff,
                                            shape=shape)
    else:
        st, st2, sd = overlap.bond_states_plain(spins.clone(), *args, kind=kind, wolff=wolff,
                                                shape=shape)
        st = st if kind == "jorg" else st2
    par = connected_components(fk.state_masks(st, len(shape)), shape).to(torch.int32)
    a, b = _offset_copy(spins, offset), spins.clone()
    overlap.finish_plain(b, x["sid"], tab[0], tab[1], sd, st, par, kind=kind, wolff=wolff,
                         shape=shape)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    lib = _build.library()
    houd = kind == "houdayer"
    per = _move_per(per, n_temps, n_rep // g, g) or overlap.ov_per(
        n, d, n_temps, n_rep // g, fk.resident_threads(cuda.index) // 4,
        max(1, overlap.HOUDN_ROWS // g) if houd else overlap.OV_MAX_PER)
    words = overlap.ov_words(shape, d, n_temps, n_rep // g, n_rep * n_temps, per)
    kept = par.clone()
    if houd:
        _build.check(lib.peapods_houdn_finish(
            a.data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            st.data_ptr(), par.data_ptr(), sd.data_ptr(), words.ctypes.data, g, int(wolff),
            stream), "houdn_finish")
    else:
        _build.check(lib.peapods_ov_finish(
            a.data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            sd.data_ptr(), st.data_ptr(), par.data_ptr(), words.ctypes.data,
            overlap.KINDS.index(kind), int(wolff), stream), "ov_finish")
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert not torch.equal(a, spins)
    assert torch.equal(par, kept)
    if kind == "jorg" and wolff:
        assert int(sd[0]) == n
        assert torch.equal(a[0, sys[0, 0, 0]], spins[0, sys[0, 0, 0]])


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
@pytest.mark.parametrize("shape,d,n_rep,n_temps,couplings,offset", MOVE_SHAPES, ids=MOVE_IDS)
def test_overlap_event_graphs_and_observe_form_match_plain(cuda, shape, d, n_rep,
                                                           n_temps, couplings, offset,
                                                           kind):
    """Row 19's outputs (SW): the labels (CMR: grey and blue) and the stats
    graph's masks bitwise the plain version; the observe form writes no
    spin and returns the same stats graph."""
    from peapods_tpu_torch.ops import overlap

    x = _pair_inputs(cuda, 29, shape, d, n_rep, n_temps, couplings)
    x["spins"] = _offset_copy(x["spins"], offset)
    n = int(np.prod(shape))
    tab = _event_inputs(x, d, n_rep, n_temps, n, kind, False, 9)
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    kw = dict(kind=kind, wolff=False, shape=shape, with_labels=True, with_masks=True)
    out = {}
    for observe in (False, True):
        a, b = x["spins"].clone(), x["spins"].clone()
        for k in overlap.LAUNCHES:
            overlap.LAUNCHES[k] = 0
        gk = overlap.overlap_event(a, *args, observe=observe, **kw)
        gp = overlap.overlap_event_plain(b, *args, observe=observe, **kw)
        torch.cuda.synchronize()
        # the observe form launches no finish: fk_link labels the stats
        # graph into the labels buffer
        finish = overlap.LAUNCHES["houdn_finish"] + overlap.LAUNCHES["ov_finish"]
        assert finish == (0 if observe else 1)
        assert overlap.LAUNCHES["ov_mid"] == (kind == "cmr" and not observe)
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
    observe = kw.get("overlap_cluster_action") == "observe"
    assert (overlap.LAUNCHES["houdn_bonds"] > 0) == houdn
    # the observe form launches no finish
    assert (overlap.LAUNCHES["houdn_finish"] > 0) == (houdn and not observe)
    assert (overlap.LAUNCHES["ov_finish"] > 0) == (not observe and kw[
        "overlap_cluster_build_mode"] != "houd4")
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
            parts = sweep.sweep_2d(whole.view(2, 3, *shape), cf, x["sys_temps"],
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
            want = sweep.sweep_2d(whole.view(2, 3, *shape), cf, x["sys_temps"], x["words"],
                                  gibbs=False, measure=True)
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
    """The partial blocks an fk_finish_band CTA takes (ops/fk.py
    band_finish_tile): halved from 32 while the launch has fewer than
    fk.FINISH_CTAS CTAs, down to the tile that stages the farthest forward
    neighbour a tile can."""
    return fk.band_finish_tile(band, g)[0]


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
            want = sweep.sweep_2d(whole.view(2, n_sys, *shape), cf, x["sys_temps"], words,
                                  gibbs=gibbs, measure=True)
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


# ----------------------- sweep_2d and sweep_nb: every width, every per

# (name, shape, realizations, systems each): widths whose groups straddle
# rows (6, 10, 34: the per-site path), row 4's 32^2 x 16, config 3's 256^2,
# the harness and the unsharded 4096^2 x 4 (the vector path)
SWEEP_2D_SHAPES = [
    ("w6", (4, 6), 2, 3), ("w10", (6, 10), 1, 5), ("w34", (10, 34), 2, 3),
    ("row4-32", (32, 32), 1, 16), ("config3-256", (256, 256), 1, 8),
    ("harness-64", (64, 64), 128, 16), ("space-4096", (4096, 4096), 1, 4),
]


def _sweep_2d_inputs(dev, seed, shape, d, n_sys, couplings):
    rng = np.random.default_rng(seed)
    h, w = shape
    coup = (rng.choice([-1.0, 1.0], size=(d, h * w, 2)) if couplings == "pm"
            else rng.standard_normal((d, h * w, 2))).astype(np.float32)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    coup_t = up(coup)
    return dict(
        spins=up(rng.choice([-1, 1], size=(d, n_sys, h, w)).astype(np.int8)),
        coup=coup_t, jgrids=pack_coupling_grids(coup_t, shape).contiguous(),
        sys_temps=up(rng.uniform(1.5, 3.5, (d, n_sys)).astype(np.float32)),
        words=up(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)))


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,d,n_sys", SWEEP_2D_SHAPES,
                         ids=[s[0] for s in SWEEP_2D_SHAPES])
def test_sweep_2d_matches_plain_with_its_partials(cuda, name, shape, d, n_sys, gibbs,
                                                  couplings):
    """Two sweeps, the second measuring: spins bitwise sweep_2d_plain's,
    every partial bitwise sweep_2d_partials' (the kernel's order of adds,
    gaussian couplings too), and with +-1 couplings their sums bitwise
    sweep_2d_plain's."""
    x = _sweep_2d_inputs(cuda, 17 + n_sys, shape, d, n_sys, couplings)
    a, b, c = (x["spins"].clone() for _ in range(3))
    args = (x["sys_temps"], x["words"])
    sweep.sweep_2d(a, x["coup"], *args, gibbs=gibbs)
    sweep.sweep_2d_plain(b, x["jgrids"], *args, gibbs=gibbs)
    sweep.sweep_2d_plain(c, x["jgrids"], *args, gibbs=gibbs)
    pk = sweep.sweep_2d(a, x["coup"], *args, gibbs=gibbs, measure=True)
    pp = sweep.sweep_2d_plain(b, x["jgrids"], *args, gibbs=gibbs, measure=True)
    pe, pm = sweep.sweep_2d_partials(c, x["jgrids"], *args, gibbs=gibbs)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, x["spins"])
    assert pk[0].shape == pe.shape == (d, n_sys, mega_blocks(*shape))
    assert torch.equal(pk[0], pe) and torch.equal(pk[1], pm)
    assert torch.equal(pk[1].sum(-1), pp[1][..., 0])
    if couplings == "pm":
        assert torch.equal(pk[0].sum(-1), pp[0][..., 0])


def mega_blocks(h, w):
    return _build.library().peapods_colour_pass_blocks(h, w)


@pytest.mark.parametrize("name,shape,d,n_sys", [
    ("w6", (4, 6), 2, 4), ("w34", (10, 34), 1, 6), ("64", (64, 64), 2, 8),
], ids=["w6", "w34", "64"])
def test_sweep_2d_every_systems_per_is_bitwise(cuda, name, shape, d, n_sys):
    """Each count of systems a thread (every divisor of n_systems up to 8)
    gives the same spins and partials, measuring and not, Metropolis and
    Gibbs, gaussian couplings."""
    x = _sweep_2d_inputs(cuda, 29, shape, d, n_sys, "gauss")
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    nb = mega_blocks(*shape)
    runs = []
    for per in [p for p in range(1, 9) if n_sys % p == 0]:
        s = x["spins"].clone()
        parts = (torch.empty((d, n_sys, nb), dtype=torch.float32, device=cuda),
                 torch.empty((d, n_sys, nb), dtype=torch.int32, device=cuda))
        for gibbs in (False, True):
            for colour in (0, 1):
                sweep.launch_sweep_2d(lib, stream, s, x["coup"], x["sys_temps"], x["words"],
                                      colour, gibbs, parts if colour else None, per=per)
        torch.cuda.synchronize()
        runs.append((per, s, parts))
    c = x["spins"].clone()
    sweep.sweep_2d_plain(c, x["jgrids"], x["sys_temps"], x["words"], gibbs=False)
    pe, pm = sweep.sweep_2d_partials(c, x["jgrids"], x["sys_temps"], x["words"], gibbs=True)
    for per, s, (e, m) in runs:
        assert torch.equal(s, c), per
        assert torch.equal(e, pe) and torch.equal(m, pm), per


# the sweep_nb shapes beyond NB_SHAPES: fast axes of 6, 10 and 34 sites
NB_WIDTHS = [
    ("tri-4x6", (4, 6), "tri", 2, 3), ("nnn-6x10", (6, 10), NNN, 1, 5),
    ("tri-10x34", (10, 34), "tri", 2, 3), ("cubic-4x6x10", (4, 6, 10), None, 1, 4),
    ("bcc-6x6x34", (6, 6, 34), "bcc", 1, 2), ("fcc-4x10x6", (4, 10, 6), "fcc", 2, 2),
    ("far-8x6", (8, 6), [[3, 0], [1, 2], [9, -7]], 1, 3),
]


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("name,shape,geometry,d,n_sys", NB_SHAPES + NB_WIDTHS,
                         ids=[s[0] for s in NB_SHAPES + NB_WIDTHS])
def test_sweep_nb_every_lattice_and_per_is_bitwise_plain(cuda, name, shape, geometry, d,
                                                         n_sys, couplings):
    """Two sweeps, Metropolis then Gibbs, with the rule's systems a thread
    and each other divisor of n_systems up to 8: spins bitwise
    sweep_nb_plain's on every lattice (offsets past the extents too)."""
    lat, x = _nb_inputs(cuda, 41 + n_sys, shape, geometry, d, n_sys, couplings)
    b = x["spins"].clone()
    args = (x["coup"], x["coup_bwd"], x["colours"], x["sys_temps"], x["words"], lat)
    for gibbs in (False, True):
        sweep.sweep_nb_plain(b, *args, gibbs=gibbs)
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for per in [None] + [p for p in range(1, 9) if n_sys % p == 0]:
        a = x["spins"].clone()
        for gibbs in (False, True):
            for colour in range(lat.n_colors):
                sweep.launch_sweep_nb(lib, stream, a, x["coup"], x["colours"], x["sys_temps"],
                                      x["words"], lat, colour, gibbs, per=per)
        torch.cuda.synchronize()
        assert torch.equal(a, b), per
    assert not torch.equal(b, x["spins"])


# ------------------------------------------ the overlap moves on offset tables


# (name, shape, offsets, couplings, spins' offset past an 8-byte boundary):
# the triangular lattice (a fast extent of whole words, and 6: the per-site
# path), BCC, FCC, the NNN table and random 3-offset tables in 2D and 3D
# (negative, long and off-word components); the per-site path also on
# spins 2 bytes off
OV_LATTICES = [
    ("tri", (16, 16), "triangular", "pm", 0), ("tri-8x6", (8, 6), "triangular", "gauss", 0),
    ("bcc", (8, 8, 8), "bcc", "gauss", 0), ("fcc", (8, 8, 8), "fcc", "pm", 4),
    ("nnn", (16, 16), [[1, 0], [0, 1], [1, 1], [1, -1]], "gauss", 0),
    ("rand3", (8, 12), [[1, -3], [2, 5], [0, 7]], "gauss", 0),
    ("rand3-3d", (4, 6, 8), [[1, 0, -1], [0, 2, 3], [-1, 1, 5]], "pm", 2),
]
OV_LATTICE_IDS = [x[0] for x in OV_LATTICES]
OV_KINDS = [("houdayer", 2), ("houdayer", 4), ("jorg", 2), ("cmr", 2)]
OV_KIND_IDS = ["houdayer", "houd4", "jorg", "cmr"]


def _ov_lattice(shape, offsets):
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

    return Lattice(shape, GEOMETRY_OFFSETS[offsets] if isinstance(offsets, str) else offsets)


def _ov_inputs(dev, seed, lat, couplings, offset, d=2, n_rep=4, n_temps=3):
    """Spins by system (``offset`` bytes past an 8-byte boundary), forward
    couplings over the lattice's offsets, temperatures and sid."""
    rng = np.random.default_rng(seed)
    n, nb, s = lat.n_spins, lat.n_neighbors, n_rep * n_temps
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nb)) if couplings == "pm"
            else rng.standard_normal((d, n, nb))).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(
        n_rep)[:, None] for _ in range(d)]).reshape(d, s).astype(np.int32)
    spins = torch.from_numpy(rng.choice([-1, 1], size=(d, s, n)).astype(np.int8)).to(dev)
    return dict(spins=_offset_copy(spins, offset), coup=torch.from_numpy(coup).to(dev),
                temps=torch.from_numpy(np.geomspace(0.9, 2.2, n_temps).astype(
                    np.float32)).to(dev),
                sid=torch.from_numpy(sid).to(dev), d=d, n_rep=n_rep, n_temps=n_temps)


def _link_counts(lat, moves):
    """The labelling's launches of ``moves`` labellings on ``lat``: fk_link
    on the triangular lattice, cc_link on the others."""
    if lat.triangular:
        return {"fk_link": moves}, {}
    return {}, {"cc_link": moves}


def _reset_move_counts():
    from peapods_tpu_torch.ops import cc, overlap

    for counts in (overlap.LAUNCHES, fk.LAUNCHES, cc.LAUNCHES):
        for k in counts:
            counts[k] = 0


@pytest.mark.parametrize("kind,g", OV_KINDS, ids=OV_KIND_IDS)
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("name,shape,offsets,couplings,offset", OV_LATTICES,
                         ids=OV_LATTICE_IDS)
def test_overlap_moves_on_lattices_match_plain(cuda, name, shape, offsets, couplings,
                                               offset, wolff, kind, g):
    """One move of every task on a lattice given by its offsets, through the
    widened kernels and the lattice's labelling: every member's spins and
    the labels (CMR: grey and blue) bitwise the plain version's."""
    from peapods_tpu_torch.ops import cc, overlap

    lat = _ov_lattice(shape, offsets)
    x = _ov_inputs(cuda, 51, lat, couplings, offset)
    tab = _event_inputs(x, x["d"], x["n_rep"], x["n_temps"], lat.n_spins, kind, wolff,
                        19, g=g)
    a, b = x["spins"].clone(), x["spins"].clone()
    _reset_move_counts()
    kw = dict(kind=kind, wolff=wolff, shape=lat, with_labels=True)
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    lk = overlap.overlap_event(a, *args, **kw)
    lp = overlap.overlap_event_plain(b, *args, **kw)
    torch.cuda.synchronize()
    links = 2 if kind == "cmr" else 1
    want_fk, want_cc = _link_counts(lat, links)
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == want_fk
    assert {k: v for k, v in cc.LAUNCHES.items() if v} == want_cc
    assert overlap.LAUNCHES["houdn_finish" if kind == "houdayer" else "ov_finish"] == 1
    assert torch.equal(a, b)
    assert torch.equal(lk.labels, lp.labels)
    if kind == "cmr":
        assert torch.equal(lk.blue, lp.blue)
    assert not torch.equal(a, x["spins"])


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
@pytest.mark.parametrize("name,shape,offsets,couplings,offset", OV_LATTICES,
                         ids=OV_LATTICE_IDS)
def test_overlap_observe_on_lattices_matches_plain(cuda, name, shape, offsets, couplings,
                                                   offset, kind):
    """SW: the labels (CMR: grey and blue) and the stats graph's masks
    ``[B, n, n_neighbors]`` bitwise the plain version; the observe form
    (the first kernel and the labelling) writes no spin and returns the
    same stats graph."""
    from peapods_tpu_torch.ops import overlap

    lat = _ov_lattice(shape, offsets)
    x = _ov_inputs(cuda, 53, lat, couplings, offset)
    tab = _event_inputs(x, x["d"], x["n_rep"], x["n_temps"], lat.n_spins, kind, False, 23)
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    kw = dict(kind=kind, wolff=False, shape=lat, with_labels=True, with_masks=True)
    out = {}
    for observe in (False, True):
        a, b = x["spins"].clone(), x["spins"].clone()
        _reset_move_counts()
        gk = overlap.overlap_event(a, *args, observe=observe, **kw)
        gp = overlap.overlap_event_plain(b, *args, observe=observe, **kw)
        torch.cuda.synchronize()
        finish = overlap.LAUNCHES["houdn_finish"] + overlap.LAUNCHES["ov_finish"]
        assert finish == (0 if observe else 1)
        assert overlap.LAUNCHES["ov_mid"] == (kind == "cmr" and not observe)
        assert torch.equal(a, b)
        assert torch.equal(a, x["spins"]) == observe
        for field in ("labels", "blue", "masks"):
            k, p = getattr(gk, field), getattr(gp, field)
            assert (k is None) == (p is None), field
            if k is not None:
                assert torch.equal(k, p), field
        out[observe] = gk
    assert torch.equal(out[True].stats, out[False].stats)
    assert torch.equal(out[True].masks, out[False].masks)
    b_tasks = x["d"] * x["n_temps"] * (x["n_rep"] // 2)
    assert out[True].masks.shape == (b_tasks, lat.n_spins, lat.n_neighbors)


@pytest.mark.parametrize("kind,g", OV_KINDS, ids=OV_KIND_IDS)
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("name,shape,offsets,couplings,offset", OV_LATTICES,
                         ids=OV_LATTICE_IDS)
def test_widened_move_kernels_alone_match_plain(cuda, name, shape, offsets, couplings,
                                                offset, wolff, kind, g):
    """Each widened kernel on its own inputs: houdn_bonds' or ov_bonds' state
    bytes and seeds and ov_mid's state2 bytes (left in the scratch by a
    move) bitwise houdn_states_plain / bond_states_plain, and ov_finish or
    houdn_finish launched alone on the plain version's last graph, every
    spin bitwise finish_plain."""
    from peapods_tpu_torch.ops import overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    lat = _ov_lattice(shape, offsets)
    x = _ov_inputs(cuda, 57, lat, couplings, offset)
    d, n_rep, n_temps, n = x["d"], x["n_rep"], x["n_temps"], lat.n_spins
    tab = _event_inputs(x, d, n_rep, n_temps, n, kind, wolff, 29, g=g)
    spins = x["spins"]
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    houd = kind == "houdayer"
    if houd:
        st, sd = overlap.houdn_states_plain(spins, x["sid"], tab[0], tab[2], wolff=wolff,
                                            shape=lat)
        last = st
    else:
        st, st2, sd = overlap.bond_states_plain(spins.clone(), *args, kind=kind,
                                                wolff=wolff, shape=lat)
        last = st if kind == "jorg" else st2
    dims, _ = overlap.check_event(spins, *args, lat, kind)
    scratch = overlap.Scratch(dims[0], n, cuda, kind == "cmr")
    overlap.launch_event(_build.library(), torch.cuda.current_stream(cuda).cuda_stream,
                         dims, spins.clone().data_ptr(), *(t.data_ptr() for t in args),
                         scratch.ptrs(), kind=kind, wolff=wolff, group=g, lattice=lat)
    torch.cuda.synchronize()
    assert torch.equal(scratch.state, st)
    assert torch.equal(scratch.seeds, sd)
    if kind == "cmr":
        assert torch.equal(scratch.state2, st2)
    masks = fk.state_masks(last, lat.n_neighbors)
    par = connected_components(masks, lat.shape, lat.offsets).to(torch.int32)
    a, b = _offset_copy(spins, offset), spins.clone()
    overlap.finish_plain(b, x["sid"], tab[0], tab[1], sd, last, par, kind=kind,
                         wolff=wolff, shape=lat)
    per = overlap.ov_per(n, d, n_temps, n_rep // g, fk.resident_threads(cuda.index) // 4,
                         max(1, overlap.HOUDN_ROWS // g) if houd else overlap.OV_MAX_PER)
    words = overlap.ov_words(lat.shape, d, n_temps, n_rep // g, n_rep * n_temps, per,
                             tuple(map(tuple, lat.offsets.tolist())))
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    if houd:
        _build.check(lib.peapods_houdn_finish(
            a.data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            last.data_ptr(), par.data_ptr(), sd.data_ptr(), words.ctypes.data, g,
            int(wolff), stream), "houdn_finish")
    else:
        _build.check(lib.peapods_ov_finish(
            a.data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            sd.data_ptr(), last.data_ptr(), par.data_ptr(), words.ctypes.data,
            overlap.KINDS.index(kind), int(wolff), stream), "ov_finish")
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert not torch.equal(a, spins)


@pytest.mark.parametrize("shape,geometry,n_rep,kw", [
    ((16, 16), "triangular", 4, dict(overlap_cluster_build_mode="cmr+houd4",
                                     overlap_cluster_mode="sw", collect_cluster_stats=True,
                                     snapshot_interval=4)),
    ((8, 8, 8), "bcc", 2, dict(overlap_cluster_build_mode="jorg+cmr",
                               overlap_cluster_mode="wolff", pt_schedule="full_ladder")),
    ((8, 8, 8), "fcc", 2, dict(overlap_cluster_build_mode="houdayer+jorg+cmr",
                               overlap_cluster_mode="sw", overlap_cluster_action="observe")),
    ((16, 16), [[1, 0], [0, 1], [1, 1], [1, -1]], 2, dict(
        cluster_update_interval=1, cluster_mode="sw", overlap_cluster_build_mode="jorg+cmr",
        overlap_cluster_mode="sw", collect_cluster_stats=True)),
], ids=["tri-cmr+houd4-stats-snapshots", "bcc-jorg+cmr-wolff", "fcc-observe",
        "nnn-fk-jorg+cmr-stats"])
def test_overlap_moves_on_lattices_sample_on_card_match_the_cpu(cuda, shape, geometry,
                                                                n_rep, kw):
    """The per-sweep replica path with overlap moves off the square and
    cubic lattices: the kernels on the card and the plain path on the CPU
    follow one trajectory (+-1 couplings: every energy sum, measure_nb's
    after each update move too, is an exact integer), with the same
    records, statistics, observations and snapshots."""
    from peapods_tpu_torch.ops import overlap

    geo = (dict(geometry=geometry) if isinstance(geometry, str)
           else dict(neighbor_offsets=geometry))
    temps = np.geomspace(1.0, 4.0, 4).astype(np.float32)
    kw = dict(kw, pt_interval=1, overlap_cluster_update_interval=2)

    def model(dev):
        return Ising(shape, couplings="bimodal", temperatures=temps, n_replicas=n_rep,
                     n_disorder=2, seed=9, device=dev, **geo)

    a, c = model("cuda"), model("cpu")
    _reset_move_counts()
    ra = a.sample(24, **kw)
    assert overlap.LAUNCHES["ov_bonds"] > 0
    rc = c.sample(24, **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips",
                "pt_trip_state"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    for key in ("energies", "energies2", "mags2", "overlap2", "link_overlap"):
        np.testing.assert_allclose(ra[key], rc[key], rtol=1e-12, err_msg=key)
    np.testing.assert_array_equal(np.asarray(ra["overlap_histogram"]),
                                  np.asarray(rc["overlap_histogram"]))
    for key in ("overlap_csd", "top_cluster_sizes", "fk_csd"):
        assert (key in ra) == (key in rc), key
        for u, v in zip(ra.get(key, []), rc.get(key, [])):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=key)
    oa = ra.get("per_disorder", {}).get("cluster_observations", {})
    oc = rc.get("per_disorder", {}).get("cluster_observations", {})
    assert list(oa) == list(oc)
    for name in oc:
        for key in oc[name]:
            np.testing.assert_array_equal(oa[name][key], oc[name][key],
                                          err_msg=f"{name} {key}")
    sa, sc = ra.get("cluster_snapshots", []), rc.get("cluster_snapshots", [])
    assert len(sa) == len(sc)
    for u, v in zip(sa, sc):
        for key in v:
            np.testing.assert_array_equal(u[key], v[key], err_msg=key)


# ------------------------------------- any lattice (odd extents, 1D, 4D, many offsets)

# the cubic lattice's first three shells: 13 forward offsets
SHELLS3 = ([[1, 0, 0], [0, 1, 0], [0, 0, 1]]
           + [[1, s, 0] for s in (1, -1)] + [[1, 0, s] for s in (1, -1)]
           + [[0, 1, s] for s in (1, -1)]
           + [[1, a, b] for a in (1, -1) for b in (1, -1)])
TEN = [[1, 0], [0, 1], [1, 1], [1, -1], [2, 0], [0, 2], [2, 1], [2, -1], [1, 2], [1, -2]]
# odd extents and the tails of n % 4 != 0 (n = 7, 25, 27), extent 1 (a
# self-bond), 1D chains as [1, L], and the table form (4D, 13 and 10 offsets)
SHAPES_4A = [
    ("chain7", (7,), None, 2, 3),
    ("5x5", (5, 5), None, 2, 3),
    ("cubic3", (3, 3, 3), None, 1, 4),
    ("3x5", (3, 5), None, 1, 2),
    ("1x6-self", (1, 6), None, 2, 2),
    ("chain4096", (4096,), None, 1, 8),
    ("cubic9", (9, 9, 9), None, 2, 4),
    ("255sq", (255, 255), None, 1, 2),
    ("tri-5x7", (5, 7), "tri", 1, 3),
    ("4d4", (4, 4, 4, 4), None, 2, 3),
    ("4d-2x3x4x5", (2, 3, 4, 5), None, 1, 2),
    ("shells-16", (16, 16, 16), SHELLS3, 1, 2),
    ("ten-4x4", (4, 4), TEN, 2, 3),
    ("4d16", (16, 16, 16, 16), None, 1, 2),
]


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,geometry,d,n_sys", SHAPES_4A,
                         ids=[s[0] for s in SHAPES_4A])
def test_any_lattice_sweep_and_measure_match_plain(cuda, name, shape, geometry, d, n_sys,
                                                   gibbs):
    """sweep_nb and measure_nb (walk or table form) on the new lattices:
    four sweeps, spins bitwise the plain sweep (self-bonds out of the
    field), every partial bitwise ``measure_nb_plain(blocks=True)`` (+-1
    couplings), the launches of the lattice's form."""
    from peapods_tpu_torch.ops import energy

    lat, x = _nb_inputs(cuda, 41 + d + n_sys, shape, geometry, d, n_sys)
    tables = lat.device_tables(cuda) if lat.table else None
    a, b = x["spins"].clone(), x["spins"].clone()
    args = (x["coup"], x["coup_bwd"], x["colours"], x["sys_temps"])
    sn, mn = ("sweep_nb_table", "measure_nb_table") if lat.table else ("sweep_nb",
                                                                      "measure_nb")
    sweep.LAUNCHES[sn] = energy.LAUNCHES[mn] = 0
    for step in range(4):
        sweep.sweep_nb(a, *args, x["words"], lat, gibbs=gibbs, tables=tables)
        sweep.sweep_nb_plain(b, *args, x["words"], lat, gibbs=gibbs)
        ek, mk = energy.measure_nb(a, x["coup"], lat, tables=tables)
        bp = energy.measure_nb_plain(b, x["coup"], lat, blocks=True)
        torch.cuda.synchronize()
        assert torch.equal(a, b), step
        assert torch.equal(ek, bp[0]) and torch.equal(mk, bp[1]), step
        x["words"] = x["words"] * 3 + 1
    assert sweep.LAUNCHES[sn] == 4 * lat.n_colors
    assert energy.LAUNCHES[mn] == 4
    assert not torch.equal(a, x["spins"])


@pytest.mark.parametrize("n", [7, 25, 27, 1, 5])
def test_measure_nb_tail_gauss_bitwise_block_plain(cuda, n):
    """measure_nb's last group of n % 4 sites, gaussian couplings, the
    rule's and every systems-a-thread count: bitwise the plain partials."""
    from peapods_tpu_torch.ops import energy

    shape = {7: (7,), 25: (5, 5), 27: (3, 3, 3), 1: (1,), 5: (1, 5)}[n]
    lat, x = _nb_inputs(cuda, 13 + n, shape, None, 3, 4, couplings="gauss")
    want = energy.measure_nb_plain(x["spins"], x["coup"], lat, blocks=True)
    for per in (None, 1, 2, 4):
        ek, mk = energy.measure_nb(x["spins"], x["coup"], lat, per=per)
        torch.cuda.synchronize()
        assert torch.equal(ek.view(torch.int32), want[0].view(torch.int32)), per
        assert torch.equal(mk, want[1]), per


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,geometry,d,n_sys", SHAPES_4A,
                         ids=[s[0] for s in SHAPES_4A])
def test_any_lattice_staged_fk_matches_plain(cuda, name, shape, geometry, d, n_sys, wolff):
    """The staged FK path on the new lattices (walk form: fk_bonds_staged and
    cc_link; table form: fk_bonds_table and the table labelling,
    ``cc.table_link_launches``), then fk_finish from the labels: masks,
    labels and spins bitwise the plain staged path."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import cc

    geo = "triangular" if geometry == "tri" else geometry
    lat, x = _staged_inputs(cuda, 17 + wolff, shape, geo, d, n_sys, 3.0)
    scal = torch.from_numpy(seeds.fk_scalars(x["kf"], lat.n_spins, wolff=wolff)).to(cuda)
    a, p = x["spins"].clone(), x["spins"].clone()
    for table in (fk.LAUNCHES, cc.LAUNCHES):
        for k in table:
            table[k] = 0
    args = (x["coup"], x["temps"], scal, x["kb"], lat)
    tables = lat.device_tables(cuda) if lat.table else None
    lk, mk = fk.fk_staged(a, *args, wolff=wolff, with_masks=True, tables=tables)
    lp, mp = fk.fk_staged_plain(p, *args, wolff=wolff)
    torch.cuda.synchronize()
    if lat.table:
        links = cc.table_link_launches(lat.n_spins, lat.n_neighbors, d * n_sys)
        assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
            "fk_bonds_table": 1, "fk_finish": 1,
            **{k: v for k, v in links.items() if k.startswith("fk_")}}
        assert {k: v for k, v in cc.LAUNCHES.items() if v} == {
            k: v for k, v in links.items() if k.startswith("cc_")}
    else:
        assert fk.LAUNCHES["fk_bonds_staged"] == 1 and fk.LAUNCHES["fk_finish"] == 1
        assert cc.LAUNCHES["cc_link"] == 1
    assert torch.equal(mk, mp)
    assert torch.equal(lk, lp)
    assert torch.equal(a, p)
    assert not torch.equal(a, x["spins"])


def test_table_forms_agree_with_walk_forms_at_8cube(cuda):
    """On 8^3 cubic, which both forms take: sweep_nb and sweep_nb_table give
    the same spins (the same Philox words and counters), measure_nb_table
    the same partials, fk_bonds_table the same bonds as fk_bonds_staged,
    and the table labelling the same labels as cc_link; the table form
    refuses to run without its device tables."""
    import copy

    from peapods_tpu_torch.ops import cc, energy

    lat, x = _nb_inputs(cuda, 77, (8, 8, 8), None, 2, 4, couplings="gauss")
    tab = copy.copy(lat)
    tab.table = True
    tables = tab.device_tables(cuda)
    a, b = x["spins"].clone(), x["spins"].clone()
    args = (x["coup"], x["coup_bwd"], x["colours"], x["sys_temps"])
    with pytest.raises(ValueError, match="table form"):
        sweep.sweep_nb(b, *args, x["words"], tab, gibbs=False)
    for gibbs in (False, True, False):
        sweep.sweep_nb(a, *args, x["words"], lat, gibbs=gibbs)
        sweep.sweep_nb(b, *args, x["words"], tab, gibbs=gibbs, tables=tables)
        x["words"] = x["words"] * 5 + 3
    ew, mw = energy.measure_nb(a, x["coup"], lat)
    et, mt = energy.measure_nb(b, x["coup"], tab, tables=tables)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and not torch.equal(a, x["spins"])
    assert torch.equal(ew.view(torch.int32), et.view(torch.int32)) and torch.equal(mw, mt)
    _, y = _staged_inputs(cuda, 78, (8, 8, 8), None, 2, 4, 4.5)
    g = y["spins"].shape[0]
    lib, stream = _build.library(), torch.cuda.current_stream(cuda).cuda_stream
    sw = torch.empty((g, 512), dtype=torch.uint8, device=cuda)
    st = torch.empty((g, 512), dtype=torch.int32, device=cuda)
    fk.launch_staged_bonds(lib, stream, y["spins"], y["coup"], y["temps"], y["kb"], sw, lat)
    fk.launch_staged_bonds(lib, stream, y["spins"], y["coup"], y["temps"], y["kb"], st, tab,
                           tables)
    lw = torch.empty((g, 512), dtype=torch.int32, device=cuda)
    lt = torch.empty_like(lw)
    cc.launch(lib, stream, sw.data_ptr(), lw.data_ptr(), lat, g)
    cc.launch(lib, stream, st.data_ptr(), lt.data_ptr(), tab, g, tables)
    torch.cuda.synchronize()
    assert torch.equal(sw.to(torch.int32), st)
    assert torch.equal(lw, lt)
    assert (lw != torch.arange(512, device=cuda)).any()


@pytest.mark.parametrize("shape,geometry,n_rep,kw", [
    ((5, 5), None, 1, dict(pt_interval=1, cluster_update_interval=1,
                           collect_cluster_stats=True)),
    ((5, 7), None, 1, dict(pt_interval=1, cluster_update_interval=1,
                           cluster_action="observe")),
    ((8,), None, 1, dict(pt_interval=1, cluster_update_interval=1, cluster_mode="wolff")),
    ((4, 4, 4, 4), None, 1, dict(pt_interval=1, cluster_update_interval=1,
                                 collect_cluster_stats=True)),
    ((4, 4), TEN, 1, dict(pt_interval=1, cluster_update_interval=2,
                          cluster_action="observe")),
    ((3, 3, 3), None, 4, dict(pt_interval=1, overlap_cluster_update_interval=1,
                              overlap_cluster_build_mode="cmr+houd4",
                              collect_cluster_stats=True)),
    ((1, 6), None, 2, dict(pt_interval=1, overlap_cluster_update_interval=1,
                           overlap_cluster_build_mode="jorg+houdayer",
                           overlap_cluster_mode="sw")),
    ((7,), None, 2, dict(pt_interval=1, cluster_update_interval=2,
                         overlap_cluster_update_interval=2, snapshot_interval=4,
                         overlap_cluster_build_mode="houdayer")),
    ((5, 5), None, 2, dict(pt_interval=1, overlap_cluster_update_interval=1,
                           overlap_cluster_build_mode="houdayer+jorg+cmr",
                           overlap_cluster_mode="sw", overlap_cluster_action="observe")),
], ids=["5x5-sw-stats", "5x7-observe-winding", "chain8-wolff", "4d4-sw-stats",
        "ten-observe", "cubic3-cmr-houd4", "1x6-jorg-houdayer", "chain7-fk-snapshots",
        "5x5-overlap-observe"])
def test_any_lattice_sample_on_card_matches_the_cpu(cuda, shape, geometry, n_rep, kw):
    """The port through ``Ising.sample`` on the card and on the CPU, one
    trajectory: states, records, statistics, observations and snapshots
    equal (+-1 couplings: every sum an exact integer)."""
    geo = {} if geometry is None else dict(neighbor_offsets=geometry)
    temps = np.geomspace(1.5, 6.0, 3).astype(np.float32)

    def model(dev):
        return Ising(shape, couplings="bimodal", temperatures=temps, n_replicas=n_rep,
                     seed=6, n_disorder=2, device=dev, **geo)

    a, c = model("cuda"), model("cpu")
    ra, rc = a.sample(24, **kw), c.sample(24, **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    keys = ["energies", "energies2", "mags", "mags2"]
    if n_rep > 1:
        keys += ["overlap2", "link_overlap"]
    for key in keys:
        np.testing.assert_allclose(ra[key], rc[key], rtol=1e-12, err_msg=key)
    for key in ("fk_csd", "overlap_csd"):
        assert (key in ra) == (key in rc), key
        if key in rc:
            np.testing.assert_array_equal(np.asarray(ra[key]), np.asarray(rc[key]),
                                          err_msg=key)
    # the top-4 fractions: f64 sums of exact fractions, added in another order
    assert ("top_cluster_sizes" in ra) == ("top_cluster_sizes" in rc)
    if "top_cluster_sizes" in rc:
        np.testing.assert_allclose(np.asarray(ra["top_cluster_sizes"]),
                                   np.asarray(rc["top_cluster_sizes"]), rtol=1e-12)
    oa = ra.get("per_disorder", {}).get("cluster_observations", {})
    oc = rc.get("per_disorder", {}).get("cluster_observations", {})
    assert list(oa) == list(oc)
    for name in oc:
        for key in oc[name]:
            np.testing.assert_array_equal(oa[name][key], oc[name][key],
                                          err_msg=f"{name} {key}")
    sa, sc = ra.get("cluster_snapshots", []), rc.get("cluster_snapshots", [])
    assert len(sa) == len(sc)
    for u, v in zip(sa, sc):
        for key in v:
            np.testing.assert_array_equal(u[key], v[key], err_msg=key)


# ----------------------- replicas on the table lattices (4D and up, 7-32 offsets)

# the cubic lattice's axes and face diagonals: 9 forward offsets
NINE = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1],
        [0, 1, 1], [0, 1, -1]]
# 32 distinct forward offsets of an 8 x 8 square (every bit of a bond word)
THIRTY_TWO = [[a, b] for a in range(5) for b in range(-3, 5) if (a, b) > (0, 0)][:32]
# (name, shape, offsets, couplings, spins' offset past an 8-byte boundary):
# 4D with even and odd extents, an extent of 1 (self-bonds), 5D, 9 offsets
# and 32 offsets
TABLE_LATTICES = [
    ("4d4", (4, 4, 4, 4), None, "pm", 0), ("4d3-odd", (3, 3, 3, 3), None, "gauss", 3),
    ("4d-self", (1, 3, 3, 3), None, "pm", 0), ("5d3", (3, 3, 3, 3, 3), None, "gauss", 0),
    ("nine", (6, 6, 6), NINE, "pm", 0), ("off32", (8, 8), THIRTY_TWO, "gauss", 2),
]
TABLE_IDS = [x[0] for x in TABLE_LATTICES]
TABLE_MOVES = ("ov_bonds_table", "ov_mid_table", "ov_finish_table", "houdn_bonds_table",
               "houdn_finish_table")
WALK_MOVES = ("ov_bonds", "ov_mid", "ov_finish", "houdn_bonds", "houdn_finish")


def _table_lattice(shape, offsets):
    from peapods_tpu_torch.ops.lattice import Lattice

    lat = Lattice(shape, offsets)
    assert lat.table
    return lat


@pytest.mark.parametrize("kind,g", OV_KINDS, ids=OV_KIND_IDS)
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("name,shape,offsets,couplings,offset", TABLE_LATTICES,
                         ids=TABLE_IDS)
def test_table_moves_match_plain(cuda, name, shape, offsets, couplings, offset, wolff, kind,
                                 g):
    """One move of every task on a table lattice through the table forms and
    the table labelling (``cc.table_link_launches``: one cc_table_link at
    these shapes): every member's spins and the labels (CMR: grey and blue)
    bitwise the plain version's; no walk-form move kernel launched."""
    from peapods_tpu_torch.ops import cc, overlap

    lat = _table_lattice(shape, offsets)
    x = _ov_inputs(cuda, 61, lat, couplings, offset)
    tab = _event_inputs(x, x["d"], x["n_rep"], x["n_temps"], lat.n_spins, kind, wolff,
                        31, g=g)
    a, b = x["spins"].clone(), x["spins"].clone()
    _reset_move_counts()
    kw = dict(kind=kind, wolff=wolff, shape=lat, with_labels=True)
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    lk = overlap.overlap_event(a, *args, tables=lat.device_tables(cuda), **kw)
    lp = overlap.overlap_event_plain(b, *args, **kw)
    torch.cuda.synchronize()
    links = 2 if kind == "cmr" else 1
    assert {k: v for k, v in cc.LAUNCHES.items() if v} == {"cc_table_link": links}
    assert fk.LAUNCHES["fk_link_flatten"] == 0
    assert all(overlap.LAUNCHES[k] == 0 for k in WALK_MOVES)
    houd = kind == "houdayer"
    assert overlap.LAUNCHES["houdn_finish_table" if houd else "ov_finish_table"] == 1
    assert overlap.LAUNCHES["ov_mid_table"] == (kind == "cmr")
    assert torch.equal(a, b)
    assert torch.equal(lk.labels, lp.labels)
    if kind == "cmr":
        assert torch.equal(lk.blue, lp.blue)
    assert not torch.equal(a, x["spins"])


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
@pytest.mark.parametrize("name,shape,offsets,couplings,offset", TABLE_LATTICES,
                         ids=TABLE_IDS)
def test_table_observe_matches_plain(cuda, name, shape, offsets, couplings, offset, kind):
    """SW on a table lattice: the labels and the stats graph's masks ``[B, n,
    n_neighbors]`` bitwise the plain version; the observe form writes no
    spin, launches no finish and returns the same stats graph."""
    from peapods_tpu_torch.ops import overlap

    lat = _table_lattice(shape, offsets)
    tables = lat.device_tables(cuda)
    x = _ov_inputs(cuda, 63, lat, couplings, offset)
    tab = _event_inputs(x, x["d"], x["n_rep"], x["n_temps"], lat.n_spins, kind, False, 37)
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    kw = dict(kind=kind, wolff=False, shape=lat, with_labels=True, with_masks=True)
    out = {}
    for observe in (False, True):
        a, b = x["spins"].clone(), x["spins"].clone()
        _reset_move_counts()
        gk = overlap.overlap_event(a, *args, observe=observe, tables=tables, **kw)
        gp = overlap.overlap_event_plain(b, *args, observe=observe, **kw)
        torch.cuda.synchronize()
        finish = overlap.LAUNCHES["houdn_finish_table"] + overlap.LAUNCHES["ov_finish_table"]
        assert finish == (0 if observe else 1)
        assert overlap.LAUNCHES["ov_mid_table"] == (kind == "cmr" and not observe)
        assert torch.equal(a, b)
        assert torch.equal(a, x["spins"]) == observe
        for field in ("labels", "blue", "masks"):
            k, p = getattr(gk, field), getattr(gp, field)
            assert (k is None) == (p is None), field
            if k is not None:
                assert torch.equal(k, p), field
        out[observe] = gk
    assert torch.equal(out[True].stats, out[False].stats)
    assert torch.equal(out[True].masks, out[False].masks)


@pytest.mark.parametrize("kind,g", OV_KINDS, ids=OV_KIND_IDS)
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("name,shape,offsets,couplings,offset", TABLE_LATTICES,
                         ids=TABLE_IDS)
def test_table_move_kernels_alone_match_plain(cuda, name, shape, offsets, couplings, offset,
                                              wolff, kind, g):
    """Each table-form kernel on its own inputs: the first graph's words and
    the seeds (and ov_mid_table's grey words and blue flips) left in a table
    Scratch bitwise table_states_plain, and ov_finish_table or
    houdn_finish_table launched alone on the plain version's last graph and
    its labels, every spin bitwise finish_plain."""
    from peapods_tpu_torch.ops import overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    lat = _table_lattice(shape, offsets)
    fwd, bwd = tables = lat.device_tables(cuda)
    x = _ov_inputs(cuda, 67, lat, couplings, offset)
    d, n_rep, n_temps, n = x["d"], x["n_rep"], x["n_temps"], lat.n_spins
    tab = _event_inputs(x, d, n_rep, n_temps, n, kind, wolff, 41, g=g)
    spins = x["spins"]
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    st, st2, fl, sd = overlap.table_states_plain(spins.clone(), *args, kind=kind, wolff=wolff,
                                                 lattice=lat)
    last = st if st2 is None else st2
    dims, _ = overlap.check_event(spins, *args, lat, kind)
    scratch = overlap.Scratch(dims[0], n, cuda, kind == "cmr", table=True)
    overlap.launch_event(_build.library(), torch.cuda.current_stream(cuda).cuda_stream,
                         dims, spins.clone().data_ptr(), *(t.data_ptr() for t in args),
                         scratch.ptrs(), kind=kind, wolff=wolff, group=g, lattice=lat,
                         tables=tables)
    torch.cuda.synchronize()
    assert torch.equal(scratch.state, st)
    assert torch.equal(scratch.seeds, sd)
    if kind == "cmr":
        assert torch.equal(scratch.state2, st2)
        assert torch.equal(scratch.flip, fl)
    masks = fk.state_masks(last, lat.n_neighbors)
    par = connected_components(masks, lat.shape, lat.offsets).to(torch.int32)
    a, b = _offset_copy(spins, offset), spins.clone()
    overlap.finish_plain(b, x["sid"], tab[0], tab[1], sd, last, par, kind=kind,
                         wolff=wolff, shape=lat, flip=fl)
    words = overlap.ov_table_words(n, lat.n_neighbors, d, n_temps, n_rep // g,
                                   n_rep * n_temps)
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    if kind == "houdayer":
        _build.check(lib.peapods_houdn_finish_table(
            a.data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            last.data_ptr(), par.data_ptr(), sd.data_ptr(), bwd.data_ptr(),
            words.ctypes.data, g, int(wolff), stream), "houdn_finish_table")
    else:
        _build.check(lib.peapods_ov_finish_table(
            a.data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            sd.data_ptr(), last.data_ptr(), par.data_ptr(),
            None if fl is None else fl.data_ptr(), bwd.data_ptr(), words.ctypes.data,
            overlap.KINDS.index(kind), int(wolff), stream), "ov_finish_table")
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert not torch.equal(a, spins)


@pytest.mark.parametrize("n_rep,n_temps", [(2, 3), (4, 5), (6, 4)], ids=["r2", "r4", "r6"])
@pytest.mark.parametrize("name,shape,offsets,couplings,offset", TABLE_LATTICES,
                         ids=TABLE_IDS)
def test_pair_overlap_table_matches_plain(cuda, name, shape, offsets, couplings, offset,
                                          n_rep, n_temps):
    """pair_overlap_table into row views of a chunk's outputs (1 to 4 columns
    a CTA): qs and ql bitwise pair_overlap_table_plain and the lattice's
    overlap_dots; one launch."""
    from peapods_tpu_torch.ops import megapair
    from peapods_tpu_torch.ops.measure import overlap_dots

    lat = _table_lattice(shape, offsets)
    tables = lat.device_tables(cuda)
    x = _ov_inputs(cuda, 71, lat, couplings, offset, d=3, n_rep=n_rep, n_temps=n_temps)
    cols = (n_rep // 2) * n_temps
    rows = torch.full((2, 3, 5, cols), -7, dtype=torch.int32, device=cuda)
    megapair.LAUNCHES["pair_overlap_table"] = 0
    megapair.pair_overlap_table(x["spins"], x["sid"], rows[0][:, 2], rows[1][:, 2],
                                lattice=lat, n_replicas=n_rep, tables=tables)
    torch.cuda.synchronize()
    assert megapair.LAUNCHES["pair_overlap_table"] == 1
    qs, ql = megapair.pair_overlap_table_plain(x["spins"], x["sid"], tables[0], n_rep)
    assert torch.equal(rows[0][:, 2], qs)
    assert torch.equal(rows[1][:, 2], ql)
    rq, rl = overlap_dots(x["spins"], x["sid"], lat.shape, n_rep, lat.offsets)
    assert torch.equal(qs, rq.flatten(1))
    assert torch.equal(ql, rl.flatten(1))
    assert (rows[:, :, [0, 1, 3, 4]] == -7).all()


@pytest.mark.parametrize("shape,offsets,n_rep,kw", [
    ((4, 4, 4, 4), None, 2, dict(overlap_cluster_build_mode="houdayer+cmr",
                                 overlap_cluster_mode="sw", cluster_update_interval=2,
                                 cluster_mode="sw", collect_cluster_stats=True,
                                 pt_schedule="full_ladder")),
    ((4, 4, 4, 4), None, 4, dict(overlap_cluster_build_mode="jorg+houd4",
                                 overlap_cluster_mode="wolff", snapshot_interval=4)),
    ((3, 3, 3, 3, 3), None, 2, dict(overlap_cluster_build_mode="houdayer+jorg+cmr",
                                    overlap_cluster_mode="sw",
                                    overlap_cluster_action="observe")),
    ((6, 6, 6), NINE, 2, dict(overlap_cluster_build_mode="cmr", overlap_cluster_mode="sw",
                              collect_cluster_stats=True)),
], ids=["4d4-houdayer+cmr-fk-stats", "4d4-jorg+houd4-wolff-snapshots", "5d3-observe",
        "nine-cmr-stats"])
def test_table_replicas_sample_on_card_match_the_cpu(cuda, shape, offsets, n_rep, kw):
    """The per-sweep replica path on table lattices: the table forms on the
    card and the plain path on the CPU follow one trajectory (+-1
    couplings), with the same records, statistics, observations and
    snapshots; the card launched the table forms and no walk-form move or
    pair kernel."""
    from peapods_tpu_torch.ops import megapair, overlap

    geo = {} if offsets is None else dict(neighbor_offsets=offsets)
    temps = np.geomspace(1.0, 4.0, 4).astype(np.float32)
    kw = dict(kw, pt_interval=1, overlap_cluster_update_interval=2)

    def model(dev):
        return Ising(shape, couplings="bimodal", temperatures=temps, n_replicas=n_rep,
                     n_disorder=2, seed=9, device=dev, **geo)

    a, c = model("cuda"), model("cpu")
    _reset_move_counts()
    megapair.LAUNCHES["pair_overlap"] = megapair.LAUNCHES["pair_overlap_table"] = 0
    ra = a.sample(24, **kw)
    assert megapair.LAUNCHES["pair_overlap_table"] == 24
    assert megapair.LAUNCHES["pair_overlap"] == 0
    assert all(overlap.LAUNCHES[k] == 0 for k in WALK_MOVES)
    assert sum(overlap.LAUNCHES[k] for k in TABLE_MOVES) > 0
    rc = c.sample(24, **kw)
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips",
                "pt_trip_state"):
        assert torch.equal(a._sim.state[key].cpu(), c._sim.state[key]), key
    for key in ("energies", "energies2", "mags2", "overlap2", "link_overlap"):
        np.testing.assert_allclose(ra[key], rc[key], rtol=1e-12, err_msg=key)
    np.testing.assert_array_equal(np.asarray(ra["overlap_histogram"]),
                                  np.asarray(rc["overlap_histogram"]))
    for key in ("overlap_csd", "fk_csd"):
        assert (key in ra) == (key in rc), key
        if key in rc:
            np.testing.assert_array_equal(np.asarray(ra[key]), np.asarray(rc[key]),
                                          err_msg=key)
    assert ("top_cluster_sizes" in ra) == ("top_cluster_sizes" in rc)
    if "top_cluster_sizes" in rc:
        np.testing.assert_allclose(np.asarray(ra["top_cluster_sizes"]),
                                   np.asarray(rc["top_cluster_sizes"]), rtol=1e-12)
    oa = ra.get("per_disorder", {}).get("cluster_observations", {})
    oc = rc.get("per_disorder", {}).get("cluster_observations", {})
    assert list(oa) == list(oc)
    for name in oc:
        for key in oc[name]:
            np.testing.assert_array_equal(oa[name][key], oc[name][key],
                                          err_msg=f"{name} {key}")
    sa, sc = ra.get("cluster_snapshots", []), rc.get("cluster_snapshots", [])
    assert len(sa) == len(sc)
    for u, v in zip(sa, sc):
        for key in v:
            np.testing.assert_array_equal(u[key], v[key], err_msg=key)


def test_table_forms_refuse_without_tables(cuda):
    """On the card a table lattice's move and pair measurement need the
    device tables: without them they raise ValueError, and nothing runs the
    plain version in their place."""
    from peapods_tpu_torch.ops import megapair, overlap

    lat = _table_lattice((3, 3, 3, 3), None)
    x = _ov_inputs(cuda, 73, lat, "pm", 0)
    tab = _event_inputs(x, x["d"], x["n_rep"], x["n_temps"], lat.n_spins, "jorg", False, 43)
    a = x["spins"].clone()
    _reset_move_counts()
    with pytest.raises(ValueError, match="table form"):
        overlap.overlap_event(a, x["sid"], tab[0], x["coup"], x["temps"], *tab[1:],
                              kind="jorg", wolff=False, shape=lat)
    cols = (x["n_rep"] // 2) * x["n_temps"]
    rows = torch.empty((2, x["d"], cols), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="table form"):
        megapair.pair_overlap_table(a, x["sid"], rows[0], rows[1], lattice=lat,
                                    n_replicas=x["n_rep"], tables=None)
    assert torch.equal(a, x["spins"])
    assert not any(overlap.LAUNCHES.values())


# The table form's labelling and colour pass (csrc/cc.cu cc_table_link /
# cc_table_border, csrc/sweep_nb.cu sweep_nb_table) at the shapes of the
# runs: (name, shape, offsets, graphs or (realizations, systems), bond
# densities below and above percolation)
TABLE_LINK = [
    ("4d10x384", (10, 10, 10, 10), None, 384, (0.10, 0.30)),
    ("4d10x8", (10, 10, 10, 10), None, 8, (0.10, 0.30)),
    ("4d16x16", (16, 16, 16, 16), None, 16, (0.10, 0.30)),
    ("5d6x8", (6, 6, 6, 6, 6), None, 8, (0.08, 0.25)),
    ("4d9x4", (9, 9, 9, 9), None, 4, (0.10, 0.30)),
    ("4d-self", (1, 3, 3, 3), None, 2, (0.2, 0.6)),
    ("nine16x8", (16, 16, 16), NINE, 8, (0.05, 0.15)),
    ("shells16x8", (16, 16, 16), SHELLS3, 8, (0.03, 0.12)),
    ("off32x8", (8, 8), THIRTY_TWO, 8, (0.01, 0.06)),
]


def _table_link_run(cuda, lat, graphs, p, seed):
    """Random bonds at density ``p`` through ``cc.cc_labels`` (the table
    form) and the plain labels, with the launches counted."""
    from peapods_tpu_torch.ops import cc

    g = torch.Generator(device=cuda).manual_seed(seed)
    masks = torch.rand((graphs, lat.n_spins, lat.n_neighbors), device=cuda, generator=g) < p
    for table in (fk.LAUNCHES, cc.LAUNCHES):
        for k in table:
            table[k] = 0
    got = cc.cc_labels(masks, lat, tables=lat.device_tables(cuda))
    want = cc.cc_labels_plain(masks, lat)
    torch.cuda.synchronize()
    counts = {k: v for t in (fk.LAUNCHES, cc.LAUNCHES) for k, v in t.items() if v}
    return got, want, counts


@pytest.mark.parametrize("dense", [False, True], ids=["below", "above"])
@pytest.mark.parametrize("name,shape,offsets,graphs,ps", TABLE_LINK,
                         ids=[x[0] for x in TABLE_LINK])
def test_table_link_matches_plain(cuda, name, shape, offsets, graphs, ps, dense):
    """The table labelling on its plan's form (one CTA a graph, or a cluster
    of CTAs): labels bitwise ``cc_labels_plain``, one launch."""
    from peapods_tpu_torch.ops import cc
    from peapods_tpu_torch.ops.lattice import Lattice

    lat = Lattice(shape, offsets)
    got, want, counts = _table_link_run(cuda, lat, graphs, ps[dense], 91 + dense)
    assert torch.equal(got, want)
    assert counts == cc.table_link_launches(lat.n_spins, lat.n_neighbors, graphs)
    assert counts == {"cc_table_link": 1}
    assert (want != torch.arange(lat.n_spins, device=cuda)).any()


@pytest.mark.parametrize("form", ["one", "c2", "c4", "c8", "slab3", "slab37"])
@pytest.mark.parametrize("shape,offsets", [((6, 6, 6, 6), None), ((16, 16, 16), SHELLS3),
                                           ((8, 8), THIRTY_TWO)],
                         ids=["4d6", "shells16", "off32"])
def test_table_link_forced_forms(cuda, monkeypatch, shape, offsets, form):
    """Every form of the table labelling on one shape, the plan forced:
    one CTA, clusters of 2, 4 and 8 CTAs, small slabs with the border and
    the flatten; labels bitwise the plain version above percolation."""
    from peapods_tpu_torch.ops import cc
    from peapods_tpu_torch.ops.lattice import Lattice

    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    per = 4 + cc.table_state_bytes(nb)
    if form.startswith("slab"):  # a third of the graph, or 37 sites
        slab = -(-n // 3) if form == "slab3" else 37
        plan = cc.TableLinkPlan(1, slab, 64, True, slab * per)
    else:
        c = 1 if form == "one" else int(form[1:])
        slab = -(-n // c)
        plan = cc.TableLinkPlan(c, slab, min(1024, -(-slab // 32) * 32), False, slab * per)
    monkeypatch.setattr(cc, "table_link_plan", lambda *a: plan)
    p = {4: 0.3, 13: 0.12, 32: 0.06}[nb]
    got, want, counts = _table_link_run(cuda, lat, 3, p, 5)
    assert torch.equal(got, want)
    assert counts == ({"cc_table_link": 1, "cc_table_border": 1, "fk_link_flatten": 1}
                      if plan.slabs else {"cc_table_link": 1})


@pytest.mark.parametrize("shape,graphs", [((26, 26, 26, 22), 1), ((32, 32, 32, 32), 2)],
                         ids=["past-cluster", "4d32x2"])
def test_table_link_slabs_past_cluster(cuda, shape, graphs):
    """A graph past one cluster's shared memory (8 CTAs of 46,489 sites at
    4 offsets) takes the slab form: cc_table_link, cc_table_border,
    fk_link_flatten; labels bitwise the plain version above percolation."""
    from peapods_tpu_torch.ops import cc
    from peapods_tpu_torch.ops.lattice import Lattice

    lat = Lattice(shape)
    assert cc.table_link_plan(lat.n_spins, 4, graphs).slabs
    got, want, counts = _table_link_run(cuda, lat, graphs, 0.3, 17)
    assert torch.equal(got, want)
    assert counts == {"cc_table_link": 1, "cc_table_border": 1, "fk_link_flatten": 1}


TABLE_SWEEP = [
    ("4d10", (10, 10, 10, 10), None, 2, 24), ("4d16", (16, 16, 16, 16), None, 1, 16),
    ("5d6", (6, 6, 6, 6, 6), None, 2, 4), ("4d9", (9, 9, 9, 9), None, 1, 8),
    ("4d-self", (1, 3, 3, 3), None, 2, 3), ("nine16", (16, 16, 16), NINE, 1, 8),
    ("shells16", (16, 16, 16), SHELLS3, 1, 8), ("off32", (8, 8), THIRTY_TWO, 2, 6),
]


@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("name,shape,offsets,d,n_sys", TABLE_SWEEP,
                         ids=[x[0] for x in TABLE_SWEEP])
def test_table_sweep_matches_plain(cuda, name, shape, offsets, d, n_sys, gibbs):
    """sweep_nb_table at the plan's systems a thread and at 1 and every
    other divisor up to 8: two sweeps' spins bitwise ``sweep_nb_plain``."""
    lat, x = _nb_inputs(cuda, 53, shape, offsets, d, n_sys)
    assert lat.table
    tables = lat.device_tables(cuda)
    lib, stream = _build.library(), torch.cuda.current_stream(cuda).cuda_stream
    args = (x["coup"], x["coup_bwd"], x["colours"], x["sys_temps"])
    for per in [None] + [p for p in range(1, 9) if n_sys % p == 0]:
        a, b = x["spins"].clone(), x["spins"].clone()
        words = x["words"]
        for _ in range(2):
            for colour in range(lat.n_colors):
                sweep.launch_sweep_nb(lib, stream, a, x["coup"], x["colours"], x["sys_temps"],
                                      words, lat, colour, gibbs, per=per, tables=tables)
            sweep.sweep_nb_plain(b, *args, words, lat, gibbs=gibbs)
            words = words * 3 + 1
        torch.cuda.synchronize()
        assert torch.equal(a, b), per
        assert not torch.equal(a, x["spins"]), per


# The redesigned table measurement and pair overlaps (csrc/sweep_nb.cu
# measure_nb_table, csrc/pairs.cu pair_overlap_table) at the runs' shapes:
# (name, shape, offsets, realizations, systems)
TABLE_MEASURE = [
    ("glass4d", (10, 10, 10, 10), None, 16, 24), ("4d16", (16, 16, 16, 16), None, 1, 16),
    ("5d6", (6, 6, 6, 6, 6), None, 2, 4), ("4d9-tail", (9, 9, 9, 9), None, 1, 8),
    ("4d-self", (1, 3, 3, 3), None, 2, 3), ("nine16", (16, 16, 16), NINE, 8, 48),
    ("shells16", (16, 16, 16), SHELLS3, 1, 8), ("off32", (8, 8), THIRTY_TWO, 2, 6),
    ("ten7x9-tail", (7, 9), TEN[:7], 1, 5),
]


@pytest.mark.parametrize("name,shape,offsets,d,n_sys", TABLE_MEASURE,
                         ids=[x[0] for x in TABLE_MEASURE])
def test_table_measure_matches_plain(cuda, name, shape, offsets, d, n_sys):
    """measure_nb_table at the plan's systems a thread and at every other
    divisor up to 8, gaussian couplings: every partial bitwise
    ``measure_nb_plain(blocks=True)`` (e as int32 bits), one launch a call;
    also on spins that start off a 4-byte boundary."""
    from peapods_tpu_torch.ops import energy

    lat, x = _nb_inputs(cuda, 59, shape, offsets, d, n_sys, couplings="gauss")
    assert lat.table
    tables = lat.device_tables(cuda)
    want = energy.measure_nb_plain(x["spins"], x["coup"], lat, blocks=True)
    for per in [None] + [p for p in range(1, 9) if n_sys % p == 0]:
        energy.LAUNCHES["measure_nb_table"] = 0
        ek, mk = energy.measure_nb(x["spins"], x["coup"], lat, per=per, tables=tables)
        torch.cuda.synchronize()
        assert energy.LAUNCHES["measure_nb_table"] == 1
        assert torch.equal(ek.view(torch.int32), want[0].view(torch.int32)), per
        assert torch.equal(mk, want[1]), per
    off = _offset_copy(x["spins"], 1)
    ek, mk = energy.measure_nb(off, x["coup"], lat, tables=tables)
    torch.cuda.synchronize()
    assert torch.equal(ek.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(mk, want[1])


# (name, shape, offsets, realizations, replicas, temperatures)
PAIR_TABLE = [
    ("glass4d", (10, 10, 10, 10), None, 16, 2, 12), ("houd4", (10, 10, 10, 10), None, 16, 4, 12),
    ("nine16", (16, 16, 16), NINE, 8, 2, 24), ("4d16", (16, 16, 16, 16), None, 1, 2, 6),
    ("4d9-tail", (9, 9, 9, 9), None, 2, 2, 5), ("4d-self", (1, 3, 3, 3), None, 2, 2, 5),
    ("off32-cols20", (8, 8), THIRTY_TWO, 2, 2, 20), ("4d4-cols40", (4, 4, 4, 4), None, 2, 2, 40),
    ("4d4-cols80", (4, 4, 4, 4), None, 2, 4, 40), ("3^4-cols130", (3, 3, 3, 3), None, 2, 2, 130),
]
PAIR_TABLE_FORMS = [None, (1, 1), (2, 1), (4, 1), (8, 1), (1, 1, 64), "unstaged", (4, 2)]


def _pair_table_plan(n, cols, form):
    """A consistent pair_overlap_table plan: ``form`` (cluster, copies[,
    threads]; staged) or unstaged copies."""
    from peapods_tpu_torch.ops import megapair

    words = 1 if cols <= 32 else 2 if cols <= 64 else 4
    groups = -(-cols // (32 * words))
    threads = max(form[2] if form != "unstaged" and len(form) > 2 else 256, 64 * words)
    if form == "unstaged":
        cluster, copies, slice_, share = 1, 3, 0, -(-n // 3)
    else:
        cluster, copies = form[:2]
        slice_ = (-(-n // cluster) + 3) // 4 * 4
        share = -(-slice_ // copies)
    return megapair.PairTablePlan(words, groups, cluster, copies, slice_, share, threads,
                                  megapair.pair_table_smem(slice_, words))


@pytest.mark.parametrize("form", PAIR_TABLE_FORMS,
                         ids=["plan", "c1", "c2", "c4", "c8", "c1-t64", "unstaged",
                              "c4x2-refused"])
@pytest.mark.parametrize("name,shape,offsets,d,n_rep,n_temps", PAIR_TABLE,
                         ids=[x[0] for x in PAIR_TABLE])
def test_pair_table_forms_match_plain(cuda, name, shape, offsets, d, n_rep, n_temps, form):
    """pair_overlap_table on its plan and on forced forms (1 to 8 CTAs a
    cluster, 64 threads, no staging on three copies) into row views of a
    chunk's outputs: qs and ql bitwise pair_overlap_table_plain, one launch
    a call, twice in a row (the unstaged form's counters zeroed each call),
    also on spins that start off a 4-byte boundary; the glass's plan one
    cluster of 8 CTAs a realization; a staged form with copies, or one
    whose slices do not fit a CTA, refused."""
    from peapods_tpu_torch.ops import megapair

    lat = _table_lattice(shape, offsets)
    tables = lat.device_tables(cuda)
    cols = (n_rep // 2) * n_temps
    plan = None if form is None else _pair_table_plan(lat.n_spins, cols, form)
    if plan is not None and (plan.smem > 232448 or (plan.slice and plan.copies > 1)):
        x = _ov_inputs(cuda, 83, lat, "pm", 0, d=d, n_rep=n_rep, n_temps=n_temps)
        rows = torch.empty((2, d, cols), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="does not fit"):
            megapair.pair_overlap_table(x["spins"], x["sid"], rows[0], rows[1], lattice=lat,
                                        n_replicas=n_rep, tables=tables, plan=plan)
        return
    if form is None and name == "glass4d":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        p = megapair.pair_table_plan(lat.n_spins, cols, d, sms)
        assert (p.cluster, p.copies, p.groups) == (8, 1, 1)
    for offset in (0, 1):
        x = _ov_inputs(cuda, 83 + offset, lat, "pm", offset, d=d, n_rep=n_rep,
                       n_temps=n_temps)
        want = megapair.pair_overlap_table_plain(x["spins"], x["sid"], tables[0], n_rep)
        for _ in range(2):
            rows = torch.full((2, d, 3, cols), -7, dtype=torch.int32, device=cuda)
            megapair.LAUNCHES["pair_overlap_table"] = 0
            megapair.pair_overlap_table(x["spins"], x["sid"], rows[0][:, 1], rows[1][:, 1],
                                        lattice=lat, n_replicas=n_rep, tables=tables,
                                        plan=plan)
            torch.cuda.synchronize()
            assert megapair.LAUNCHES["pair_overlap_table"] == 1
            assert torch.equal(rows[0][:, 1], want[0]), offset
            assert torch.equal(rows[1][:, 1], want[1]), offset
            assert (rows[:, :, [0, 2]] == -7).all()


# The redesigned table bonds (csrc/fk.cu fk_bonds_table, csrc/overlap.cu
# ov_bonds_table) at the runs' shapes: (name, shape, offsets, realizations,
# graphs a realization, couplings)
TABLE_BONDS = [
    ("glass4d", (10, 10, 10, 10), None, 16, 24, "pm"),
    ("4d16", (16, 16, 16, 16), None, 1, 16, "pm"),
    ("shells16", (16, 16, 16), SHELLS3, 1, 8, "pm"),
    ("nine16", (16, 16, 16), NINE, 8, 48, "gauss"),
    ("4d9-tail", (9, 9, 9, 9), None, 1, 8, "gauss"),
    ("off32", (8, 8), THIRTY_TWO, 2, 6, "gauss"),
    ("4d-self", (1, 3, 3, 3), None, 2, 3, "pm"),
    ("ten7x9-tail", (7, 9), TEN[:7], 1, 5, "gauss"),
]


def _table_bonds_inputs(dev, seed, lat, d, s, couplings, offset):
    """Graphs' spins ``offset`` bytes past an 8-byte boundary, couplings,
    temperatures and key words."""
    rng = np.random.default_rng(seed)
    b, n, nb = d * s, lat.n_spins, lat.n_neighbors
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nb)) if couplings == "pm"
            else rng.standard_normal((d, n, nb))).astype(np.float32)
    spins = up(rng.choice([-1, 1], size=(b, *lat.shape)).astype(np.int8))
    return dict(spins=_offset_copy(spins, offset), coup=up(coup),
                temps=up(rng.uniform(0.8, 4.0, b).astype(np.float32)),
                kb=up(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)))


@pytest.mark.parametrize("name,shape,offsets,d,n_sys,couplings", TABLE_BONDS,
                         ids=[x[0] for x in TABLE_BONDS])
def test_table_bonds_forms_match_plain(cuda, name, shape, offsets, d, n_sys, couplings):
    """fk_bonds_table on its plan, at every other count of graphs a thread up
    to 8 and in forced split forms (2, 3 and 8 warps sharing a group's
    offsets, one graph a thread), on spins aligned and 1 byte off: every
    bond word bitwise ``fk_bonds_plain``'s bits, the words around the
    graphs untouched; the plan at the smoke's shapes: the glass 8 graphs a
    thread, 16^4 x 16 4, 16^3 with 13 offsets x 8 split over 5 warps."""
    from peapods_tpu_torch.ops import cc

    lat = _table_lattice(shape, offsets)
    tables = lat.device_tables(cuda)
    n, nb, b = lat.n_spins, lat.n_neighbors, d * n_sys
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = fk.table_bonds_plan(n, nb, d, n_sys, fk.resident_threads(cuda.index) // 8, sms)
    want_plan = {"glass4d": (8, 1), "4d16": (4, 1), "shells16": (1, 5)}.get(name)
    assert want_plan is None or (plan.per, plan.split) == want_plan
    forms = [None] + [fk.TableBondsPlan(p, 1, 256, None) for p in range(1, 9)
                      if n_sys % p == 0] + [
        fk.TableBondsPlan(1, k, 32 * k, None) for k in (2, 3, 8) if k <= nb]
    lib, stream = _build.library(), torch.cuda.current_stream(cuda).cuda_stream
    for offset in (0, 1):
        x = _table_bonds_inputs(cuda, 91 + offset, lat, d, n_sys, couplings, offset)
        want = cc.pack_masks(fk.fk_bonds_plain(x["spins"], x["coup"], x["temps"], x["kb"],
                                               offsets=lat.offsets), torch.int32)
        assert want.any()
        for form in forms:
            rows = torch.full((b + 2, n), -7, dtype=torch.int32, device=cuda)
            fk.launch_staged_bonds(lib, stream, x["spins"], x["coup"], x["temps"], x["kb"],
                                   rows[1:-1], lat, tables, plan=form)
            torch.cuda.synchronize()
            assert torch.equal(rows[1:-1], want), (offset, form)
            assert (rows[[0, -1]] == -7).all(), (offset, form)


# (name, shape, offsets, realizations, replicas, temperatures, couplings)
OV_TABLE_BONDS = [
    ("glass4d", (10, 10, 10, 10), None, 16, 2, 12, "pm"),
    ("nine16", (16, 16, 16), NINE, 8, 2, 24, "pm"),
    ("4d16", (16, 16, 16, 16), None, 1, 2, 6, "gauss"),
    ("shells16", (16, 16, 16), SHELLS3, 1, 4, 4, "pm"),
    ("4d9-tail", (9, 9, 9, 9), None, 2, 2, 5, "gauss"),
    ("off32", (8, 8), THIRTY_TWO, 2, 4, 3, "gauss"),
    ("4d-self", (1, 3, 3, 3), None, 2, 4, 3, "pm"),
    ("ten7x9-tail", (7, 9), TEN[:7], 1, 2, 5, "gauss"),
]


@pytest.mark.parametrize("kind", ["jorg", "cmr"])
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("name,shape,offsets,d,n_rep,n_temps,couplings", OV_TABLE_BONDS,
                         ids=[x[0] for x in OV_TABLE_BONDS])
def test_ov_bonds_table_forms_match_plain(cuda, name, shape, offsets, d, n_rep, n_temps,
                                          couplings, wolff, kind):
    """ov_bonds_table at the plan's tasks a thread and at every other count up
    to 8 that splits a realization's tasks with a thread's tasks of one
    temperature side by side (``overlap.ov_per``'s), on spins aligned and 1
    byte off: the first graph's words and the seeds bitwise
    ``table_states_plain``, one launch a move; the kernel's CTAs an SM
    queried."""
    from peapods_tpu_torch.ops import overlap

    lat = _table_lattice(shape, offsets)
    tables = lat.device_tables(cuda)
    n, g_pairs = lat.n_spins, n_rep // 2
    tg = n_temps * g_pairs
    ctas = overlap.table_ctas(cuda.index, "ov_bonds_table", lat.n_neighbors,
                              overlap.KINDS.index(kind))
    assert ctas >= 1
    pers = [0] + [p for p in range(1, 9)
                  if tg % p == 0 and (p % g_pairs == 0 or g_pairs % p == 0)]
    lib, stream = _build.library(), torch.cuda.current_stream(cuda).cuda_stream
    for offset in (0, 1):
        x = _ov_inputs(cuda, 97 + offset, lat, couplings, offset, d=d, n_rep=n_rep,
                       n_temps=n_temps)
        tab = _event_inputs(x, d, n_rep, n_temps, n, kind, wolff, 43 + offset)
        args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
        st, _, _, sd = overlap.table_states_plain(x["spins"].clone(), *args, kind=kind,
                                                  wolff=wolff, lattice=lat)
        assert st.any()
        dims, _ = overlap.check_event(x["spins"], *args, lat, kind)
        for per in pers:
            scratch = overlap.Scratch(dims[0], n, cuda, kind == "cmr", table=True)
            scratch.state.fill_(-7)
            scratch.seeds.fill_(-7)
            _reset_move_counts()
            overlap.launch_event(lib, stream, dims, x["spins"].clone().data_ptr(),
                                 *(t.data_ptr() for t in args), scratch.ptrs(), kind=kind,
                                 wolff=wolff, lattice=lat, tables=tables, per=per)
            torch.cuda.synchronize()
            assert overlap.LAUNCHES["ov_bonds_table"] == 1
            assert torch.equal(scratch.state, st), (offset, per)
            assert torch.equal(scratch.seeds, sd), (offset, per)


def _table_pers(n, g, tg, plan):
    """The plan's tasks a thread (0) and every other count up to ``most``
    that splits ``tg`` tasks with a thread's tasks of one temperature side
    by side; the plan's own count checked to be one of them."""
    pers = [p for p in range(1, 9) if tg % p == 0 and (p % g == 0 or g % p == 0)]
    assert plan in pers
    return [0] + pers


def _shifted(t, shift):
    """``t`` itself, or (shift) a copy starting one element past its own
    alignment: the kernels' word loads and stores off."""
    if not shift:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("name,shape,offsets,d,n_rep,n_temps,couplings", OV_TABLE_BONDS,
                         ids=[x[0] for x in OV_TABLE_BONDS])
def test_ov_mid_table_forms_match_plain(cuda, name, shape, offsets, d, n_rep, n_temps,
                                        couplings, wolff):
    """ov_mid_table at the plan's tasks a thread and at every other count up
    to 8, whole (spins and buffers aligned) and on spins 1 byte off with the
    blue words, parents, grey words and flips one element off their
    alignment (the byte and word path; the tails at 9^4 and 7 x 9 too): the
    grey words and flip bytes bitwise ``table_states_plain``'s on its blue
    words and their labels, one launch; the plan on the kernel's queried
    CTAs an SM."""
    from peapods_tpu_torch.ops import overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    lat = _table_lattice(shape, offsets)
    fwd, bwd = lat.device_tables(cuda)
    n, nb, g_pairs = lat.n_spins, lat.n_neighbors, n_rep // 2
    tg = n_temps * g_pairs
    plan = overlap.table_pers(n, nb, d, n_temps, g_pairs, "cmr", wolff, 2, cuda.index)
    assert overlap.table_ctas(cuda.index, "ov_mid_table", nb, int(wolff)) >= 1
    lib, stream = _build.library(), torch.cuda.current_stream(cuda).cuda_stream
    words = overlap.ov_table_words(n, nb, d, n_temps, g_pairs, n_rep * n_temps)
    for offset in (0, 1):
        x = _ov_inputs(cuda, 131 + offset, lat, couplings, offset, d=d, n_rep=n_rep,
                       n_temps=n_temps)
        tab = _event_inputs(x, d, n_rep, n_temps, n, "cmr", wolff, 53 + offset)
        st, st2, fl, _ = overlap.table_states_plain(
            x["spins"].clone(), x["sid"], tab[0], x["coup"], x["temps"], *tab[1:],
            kind="cmr", wolff=wolff, lattice=lat)
        assert st2.any() and fl.any()
        par = connected_components(fk.state_masks(st, nb), lat.shape,
                                   lat.offsets).to(torch.int32)
        blue, parent = _shifted(st, offset), _shifted(par, offset)
        for per in _table_pers(n, g_pairs, tg, plan["ov_mid_table"]):
            grey = _shifted(torch.full_like(st2, -7), offset)
            flip = _shifted(torch.full_like(fl, 7), offset)
            _reset_move_counts()
            _build.check(lib.peapods_ov_mid_table(
                x["spins"].data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(),
                x["coup"].data_ptr(), x["temps"].data_ptr(), tab[1].data_ptr(),
                tab[3].data_ptr(), fwd.data_ptr(), bwd.data_ptr(), blue.data_ptr(),
                parent.data_ptr(), grey.data_ptr(), flip.data_ptr(), words.ctypes.data,
                int(wolff), per or plan["ov_mid_table"], stream), "ov_mid_table")
            torch.cuda.synchronize()
            assert torch.equal(grey, st2), (offset, per)
            assert torch.equal(flip, fl), (offset, per)


# (name, shape, offsets, realizations, replicas, temperatures, group size):
# the glass's pair move and Wolff houd4, nine16, a tail, a self offset, 32
# offsets (the runtime count), 7 x 9 with 7 offsets, and g = 256 (16-bit
# lanes)
HOUDN_TABLE_BONDS = [
    ("glass4d", (10, 10, 10, 10), None, 16, 2, 12, 2),
    ("houd4", (10, 10, 10, 10), None, 16, 4, 12, 4),
    ("nine16", (16, 16, 16), NINE, 8, 2, 24, 2),
    ("4d9-tail", (9, 9, 9, 9), None, 2, 4, 5, 4),
    ("4d-self", (1, 3, 3, 3), None, 2, 4, 3, 2),
    ("off32", (8, 8), THIRTY_TWO, 2, 8, 3, 4),
    ("ten7x9-tail", (7, 9), TEN[:7], 1, 2, 5, 2),
    ("3^4-g256", (3, 3, 3, 3), None, 1, 256, 1, 256),
]


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("name,shape,offsets,d,n_rep,n_temps,g", HOUDN_TABLE_BONDS,
                         ids=[x[0] for x in HOUDN_TABLE_BONDS])
def test_houdn_bonds_table_forms_match_plain(cuda, name, shape, offsets, d, n_rep, n_temps,
                                             g, wolff):
    """houdn_bonds_table at the plan's tasks a thread and at every other count
    up to its cap, whole and on spins 1 byte off with the words one element
    off their alignment: the words and seeds bitwise ``table_states_plain``'s,
    one launch a move through ``launch_event``; the plan on the kernel's
    queried CTAs an SM."""
    from peapods_tpu_torch.ops import overlap

    lat = _table_lattice(shape, offsets)
    tables = lat.device_tables(cuda)
    fwd = tables[0]
    n, nb, groups = lat.n_spins, lat.n_neighbors, n_rep // g
    tg = n_temps * groups
    plan = overlap.table_pers(n, nb, d, n_temps, groups, "houdayer", wolff, g, cuda.index)
    lib, stream = _build.library(), torch.cuda.current_stream(cuda).cuda_stream
    words = overlap.ov_table_words(n, nb, d, n_temps, groups, n_rep * n_temps)
    pers = [p for p in _table_pers(n, groups, tg, plan["houdn_bonds_table"])
            if p <= overlap.table_most("houdn_bonds_table", g)]
    for offset in (0, 1):
        x = _ov_inputs(cuda, 151 + offset, lat, "pm", offset, d=d, n_rep=n_rep,
                       n_temps=n_temps)
        if g > 2:  # half the members of a site down where a coin falls: balanced sites
            half = torch.rand((d, 1, n), device=cuda) < 0.5
            parity = torch.where(torch.arange(n_rep * n_temps, device=cuda) % 2 == 0, 1, -1)
            x["spins"].copy_(torch.where(half, parity[None, :, None].to(torch.int8),
                                         x["spins"]))
        tab = _event_inputs(x, d, n_rep, n_temps, n, "houdayer", wolff, 61 + offset, g=g)
        args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
        st, _, _, sd = overlap.table_states_plain(x["spins"].clone(), *args, kind="houdayer",
                                                  wolff=wolff, lattice=lat)
        assert st.any()
        for per in pers:
            out = _shifted(torch.full_like(st, -7), offset)
            seeds = torch.full_like(sd, -7)
            _reset_move_counts()
            if offset == 0:  # the move's own launch
                dims, _ = overlap.check_event(x["spins"], *args, lat, "houdayer")
                scratch = overlap.Scratch(dims[0], n, cuda, False, table=True)
                moved = x["spins"].clone()  # the move's finish flips it
                overlap.launch_event(lib, stream, dims, moved.data_ptr(),
                                     *(t.data_ptr() for t in args), scratch.ptrs(),
                                     kind="houdayer", wolff=wolff, group=g, lattice=lat,
                                     tables=tables, per=per)
                out, seeds = scratch.state, scratch.seeds
            else:
                _build.check(lib.peapods_houdn_bonds_table(
                    x["spins"].data_ptr(), x["sid"].data_ptr(), tab[0].data_ptr(),
                    tab[2].data_ptr(), fwd.data_ptr(), out.data_ptr(), seeds.data_ptr(),
                    words.ctypes.data, g, int(wolff), per or plan["houdn_bonds_table"],
                    stream), "houdn_bonds_table")
            torch.cuda.synchronize()
            assert overlap.LAUNCHES["houdn_bonds_table"] == (offset == 0)
            assert torch.equal(out, st), (offset, per)
            assert torch.equal(seeds, sd), (offset, per)
