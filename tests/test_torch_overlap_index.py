"""A numpy model of ``ov_bonds``' and ``ov_mid``'s launches
(``csrc/overlap.cu``), held to the plain bonds and the JAX package.

The redesigned kernels take a group of four sites of ``per`` consecutive
tasks of one realization a thread (``ops/overlap.py`` ``ov_words``,
``ov_per``): the model walks the launch's grid and checks that every
(task, group) is taken once, rebuilds each group's neighbour words
(multiply-shift coordinates, one compare an axis: the fast axis' next word,
the same word of the next line and plane, and the backward ones) and each
site's neighbours on the per-site path against the lattice's modulo
neighbours, then draws the bonds as the kernels do: each bond's
satisfaction a sign flip of J/T on byte masks, Philox (counter ``(dir,
site // 4)``, CMR's grey ``(n_dims + dir, ...)``) only where a bond can be
active, each draw an integer compare with the bond's threshold taken once
a temperature.  Its state bytes (and CMR's state2 bytes: grey bonds,
the blue flip decided once a site from the flat parents) are held bitwise
to the plain bonds (``bond_states_plain``: ``_jorg``, ``_cmr``), and its
stats graph to the JAX package's fused event (interpret mode) fed the same
uniforms.  The seed ballot is the first active probe in probe order; the
unit thresholds equal the float compare for every 24-bit word at configs
4's and 5's and the 64^2 glass's temperatures.
"""

import jax
import numpy as np
import pytest
import torch

from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.ops import overlap
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.cluster import connected_components, find_seed, salted_uniform
from peapods_tpu_torch.ops.fk import state_masks

torch.set_num_threads(1)

KLOW = 0x01010101
THREADS = 256


def _walk(words):
    w = words.view(np.uint32).astype(np.int64)
    keys = ("n", "nd", "lf", "lb", "la", "T", "G", "S", "per", "d")
    g = dict(zip(keys, (int(x) for x in w[:10])))
    g["div"] = [(int(w[10 + 2 * k]), int(w[11 + 2 * k])) for k in range(3)]
    return g


def _fdiv(q, md):
    m, s = md
    q = np.asarray(q, np.int64)
    return q if m == 0 else ((q * m) >> 32) >> s


def launch_map(g, cap=65535):
    """``(b, grp, z)`` int64 arrays: the (task, group) pairs the launch's
    threads take and each one's realization (blockIdx.z).  blockIdx (x, y,
    z) = (task set, groups' block, realization); a thread takes tasks ``b0
    .. b0 + per - 1``, ``b0 = z T G + x per``, of the groups ``y 256 + t``,
    striding by the grid's blocks (at most ``cap``)."""
    n_grp = -(-g["n"] // 4)
    yb = min(-(-n_grp // THREADS), cap)
    sets = g["T"] * g["G"] // g["per"]
    z, x, y, t = np.meshgrid(np.arange(g["d"]), np.arange(sets), np.arange(yb),
                             np.arange(THREADS), indexing="ij")
    z = z.reshape(-1)
    b0 = z * g["T"] * g["G"] + x.reshape(-1) * g["per"]
    grp0 = (y * THREADS + t).reshape(-1)
    bs, gs, zs = [], [], []
    for m in range(-(-n_grp // (yb * THREADS))):
        grp = grp0 + m * yb * THREADS
        on = grp < n_grp
        for k in range(g["per"]):
            bs.append((b0 + k)[on])
            gs.append(grp[on])
            zs.append(z[on])
    return np.concatenate(bs), np.concatenate(gs), np.concatenate(zs)


def _covers_once(b, grp, z, n_tasks, n_grp):
    key = np.sort(b * n_grp + grp)
    return len(key) == n_tasks * n_grp and np.array_equal(key, np.arange(n_tasks * n_grp))


def site_at(g, i):
    """(pos, cb, ca) of sites ``i``: the kernels' multiply-shift coordinates."""
    line = _fdiv(i, g["div"][0])
    pos = i - line * g["lf"]
    ca = _fdiv(line, g["div"][1]) if g["nd"] == 3 else np.zeros_like(line)
    return pos, line - ca * g["lb"], ca


def site_step(g, i, d, back):
    """The kernels' neighbour of sites ``i`` along direction ``d`` (nd - 1
    the fast axis), one compare an axis."""
    pos, cb, ca = site_at(g, i)
    nd = g["nd"]
    if d == nd - 1:
        return (np.where(pos > 0, i - 1, i - 1 + g["lf"]) if back
                else np.where(pos + 1 < g["lf"], i + 1, i + 1 - g["lf"]))
    step, ext, at = ((g["lf"], g["lb"], cb) if d == nd - 2
                     else (g["lb"] * g["lf"], g["la"], ca))
    return (np.where(at > 0, i - step, i - step + ext * step) if back
            else np.where(at + 1 < ext, i + step, i + step - ext * step))


def group_words(g, grp):
    """The vector path's words of groups ``grp``: ``(k, fwd, bwd)``, the
    word and per direction the forward and backward neighbour words (the
    fast axis' next / previous word; the kernels shift a byte in)."""
    pos, cb, ca = site_at(g, 4 * grp)
    wpl = g["lf"] // 4
    plane = g["lb"] * wpl
    nw = g["n"] // 4
    nd = g["nd"]
    fwd, bwd = [None] * nd, [None] * nd
    fwd[nd - 1] = np.where(pos + 4 < g["lf"], grp + 1, grp + 1 - wpl)
    bwd[nd - 1] = np.where(pos > 0, grp - 1, grp - 1 + wpl)
    fwd[nd - 2] = np.where(cb + 1 < g["lb"], grp + wpl, grp + wpl - plane)
    bwd[nd - 2] = np.where(cb > 0, grp - wpl, grp - wpl + plane)
    if nd == 3:
        fwd[0] = np.where(ca + 1 < g["la"], grp + plane, grp + plane - nw)
        bwd[0] = np.where(ca > 0, grp - plane, grp - plane + nw)
    return grp, fwd, bwd


def word_sites(g, grp, d, back):
    """The sites whose bytes stand in byte q of a group's direction-``d``
    neighbour word ([groups, 4]) on the vector path."""
    _, fwd, bwd = group_words(g, grp)
    q = np.arange(4)
    if d == g["nd"] - 1:  # a byte shift with the next / previous word
        if back:
            return np.where(q == 0, 4 * bwd[d][:, None] + 3, 4 * grp[:, None] + q - 1)
        return np.where(q == 3, 4 * fwd[d][:, None], 4 * grp[:, None] + q + 1)
    return 4 * (bwd if back else fwd)[d][:, None] + q


def modulo_neighbours(shape, d, back):
    """Each site's neighbour along axis ``d`` by coordinates modulo the
    extents."""
    c = list(np.unravel_index(np.arange(int(np.prod(shape))), shape))
    c[d] = (c[d] + (-1 if back else 1)) % shape[d]
    return np.ravel_multi_index(c, shape)


def threshold24(p):
    """The kernels' unit-coupling threshold of a probability (f32)."""
    p = np.float32(p)
    return int(min(np.ceil(np.float64(p) * 2**24), 2**24)) if p > 0 else 0


def thresholds24(p):
    """:func:`threshold24` of every f32 probability of ``p`` (int64)."""
    t = torch.clamp(torch.ceil(p.double() * 2**24), max=2**24).to(torch.int64)
    return torch.where(p > 0, t, 0)


def bond_prob(which, jt):
    """f32 torch: the kernels' bond probabilities of J/T (``bond_prob``)."""
    a = jt.abs()
    if which == "jorg":
        return 1.0 - torch.exp(-4.0 * a)
    r = torch.exp(-2.0 * a)
    return 1.0 - r * r if which == "blue" else 1.0 - r


def _words(x):
    """uint32 words (int64) of int8 rows [..., 4 m] as bytes."""
    return torch.from_numpy(np.ascontiguousarray(x.numpy()).view(np.uint32).astype(np.int64))


def _differ(u, v):
    return ((u ^ v) >> 7) & KLOW


def model_states(spins, sid, tasks, coup, temps, scal, probes, keys, shape, kind, wolff,
                 per=0):
    """The model's ``(state, state2, seeds, decisions)``: the launches'
    outputs from the grid map, the neighbour words and the draws; decisions
    counts each site's blue-flip decisions."""
    d, _, n = spins.shape
    nd = len(shape)
    T, G = tasks.shape[1:3]
    per = per or overlap.ov_per(n, d, T, G, 1 << 30)
    g = _walk(overlap.ov_words(tuple(shape), d, T, G, spins.shape[1], per))
    B = d * T * G
    assert _covers_once(*launch_map(g), B, -(-n // 4))
    _, a, b = overlap.gather_tasks(spins, sid, tasks, T)
    pad = (-n) % 4
    ng = (n + pad) // 4
    i = np.arange(n)
    # each direction's neighbour bytes, byte q of a group word the neighbour
    # of site 4 grp + q (on either path: checked in the tests below)
    fwd = [torch.from_numpy(site_step(g, i, dd, False)) for dd in range(nd)]
    bwd = [torch.from_numpy(site_step(g, i, dd, True)) for dd in range(nd)]

    def words(x, idx=None):
        x = x if idx is None else x[:, idx]
        return _words(torch.nn.functional.pad(x, (0, pad)))

    t_of = (torch.arange(B) // G) % T
    d_of = torch.arange(B) // (T * G)
    jt = (coup[d_of] / temps[t_of][:, None, None])  # [B, n, nd]: J / T
    jt = torch.nn.functional.pad(jt, (0, 0, 0, pad)).reshape(B, ng, 4, nd)
    unit = torch.nn.functional.pad(coup[d_of].abs() == 1.0, (0, 0, 0, pad)).reshape(B, ng, 4, nd)
    shifts = torch.tensor([0, 8, 16, 24])
    pos = ((jt > 0).to(torch.int64) << shifts[None, None, :, None]).sum(2)  # [B, ng, nd]
    neg = ((jt < 0).to(torch.int64) << shifts[None, None, :, None]).sum(2)
    k = keys.to(torch.int64) & 0xFFFFFFFF
    grp = torch.arange(ng)

    def draw(cand, dd, which, first):
        # Philox only where a candidate is: the same words wherever drawn
        u = torch.stack(trng.philox4x32(k[:, 0:1], k[:, 1:2], torch.tensor(first + dd),
                                        grp[None], torch.tensor(0), torch.tensor(0)), -1)
        # each bond's threshold, taken once a temperature; a group of unit
        # couplings takes the task's one threshold
        thr_unit = torch.tensor([threshold24(bond_prob(which, 1.0 / temps[t:t + 1])[0].item())
                                 for t in range(T)])[t_of][:, None, None]
        thr = torch.where(unit.all(-1).all(-1)[..., None], thr_unit,
                          thresholds24(bond_prob(which, jt[..., dd])))
        on = (u >> 8) < thr
        c = ((cand[..., None] >> shifts) & 1).bool()
        return ((on & c).to(torch.int64) << shifts).sum(-1)

    def sat(dd, dw):
        return (dw & neg[..., dd]) | (~dw & pos[..., dd])

    aw, bw_ = words(a), words(b)
    st = torch.zeros((B, ng), dtype=torch.int64)
    for dd in range(nd):
        af, bf = words(a, fwd[dd]), words(b, fwd[dd])
        cand = sat(dd, _differ(aw, af))
        if kind == "jorg":
            cand = cand & _differ(aw, bw_) & _differ(af, bf)
        else:
            cand = cand & sat(dd, _differ(bw_, bf))
        st |= draw(cand, dd, "jorg" if kind == "jorg" else "blue", 0) << dd

    def to_bytes(w):
        return torch.from_numpy(w.numpy().astype(np.uint32).view(np.uint8).reshape(B, -1)[:, :n]
                                .copy())

    state = to_bytes(st)
    # the seed ballot: lanes l and 32 + l test probes l and 32 + l
    act = (a != b).numpy()
    pr = probes.numpy()
    hits = np.take_along_axis(act, pr, 1)
    lo = (hits[:, :32].astype(np.int64) << np.arange(32)).sum(1).tolist()
    hi = (hits[:, 32:].astype(np.int64) << np.arange(32)).sum(1).tolist()
    ffs = lambda m: (m & -m).bit_length() - 1  # noqa: E731
    if kind == "jorg":
        sd = ([int(pr[t, ffs(lo[t])]) if lo[t] else int(pr[t, 32 + ffs(hi[t])]) if hi[t]
               else n for t in range(B)] if wolff else [n] * B)
    else:
        sd = scal[:, 4].tolist()
    sd = torch.tensor(sd, dtype=torch.int32)
    if kind == "jorg":
        return state, None, sd, None
    # ov_mid: each site's blue flip decided once, from its flat parent
    lab = connected_components(state_masks(state, nd), shape)
    decisions = np.zeros((B, n), np.int64)
    decisions[:, :] += 1  # one load of the parent a (task, site)
    if wolff:
        flip = lab == lab.gather(1, scal[:, 4:5].to(torch.int64))
    else:
        coin = salted_uniform(lab, scal[:, 0:1], scal[:, 1:2]) < 0.5
        stt = state.to(torch.int64)
        any_ = ((stt & ((1 << nd) - 1)) != 0) | (lab != torch.arange(n))
        for dd in range(nd):  # the backward neighbours' bonds, where needed
            need = coin & ~any_
            any_ = any_ | (need & (((stt[:, bwd[dd]] >> dd) & 1) != 0))
        flip = coin & any_
    fl = words(flip.to(torch.int8))
    out = fl << 7
    for dd in range(nd):
        af, bf = words(a, fwd[dd]), words(b, fwd[dd])
        blue = (st >> dd) & KLOW
        cand = _differ(aw ^ af, bw_ ^ bf) & (pos[..., dd] | neg[..., dd]) & ~blue
        out |= (blue | draw(cand, dd, "grey", nd)) << dd
    return state, to_bytes(out), sd, decisions


def _inputs(shape, d, n_rep, n_temps, couplings, seed, kind, wolff, equal_pair=False):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    nd = len(shape)
    s = n_rep * n_temps
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nd)) if couplings == "pm"
            else rng.standard_normal((d, n, nd))).astype(np.float32)
    if couplings == "gauss":  # some unit couplings and zeros among them
        m = rng.random((d, n, nd))
        coup[m < 0.05] = 1.0
        coup[(m >= 0.05) & (m < 0.08)] = -1.0
        coup[(m >= 0.08) & (m < 0.1)] = 0.0
    temps = np.geomspace(0.8, 2.0, n_temps).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(n_rep)[:, None]
                    for _ in range(d)]).reshape(d, s).astype(np.int32)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(d, s, n))
    keys = rng.integers(0, 2**32, (d, 2), dtype=np.uint64).astype(np.uint32)
    tasks, tkeys = seeds.overlap_tasks(keys, [seed], n_rep, n_temps)
    if equal_pair:  # task 0's two replicas equal: no active probe
        t0 = tasks[0][0, 0, 0]
        spins[0, sid[0, t0[1] * n_temps]] = spins[0, sid[0, t0[0] * n_temps]]
    scal, probes = seeds.event_scalars(kind, wolff, tkeys[0], n)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return (t(spins), t(sid), t(tasks[0]), t(coup), t(temps), t(scal.reshape(-1, 6)),
            t(probes.reshape(-1, 64)), t(tkeys[0].view(np.int32).reshape(-1, 2)))


CASES = [((8, 8, 8), "pm"), ((16, 16, 16), "gauss"), ((8, 64), "gauss"), ((6, 6, 6), "gauss"),
         ((6, 6, 6), "pm")]


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 16, 16), (8, 64), (6, 6, 6), (4, 6, 8),
                                   (5, 7), (3, 5, 7)])
def test_neighbours_against_the_lattice(shape):
    """The per-site path's coordinates and neighbours (multiply-shift, one
    compare an axis) and, where the fast extent is a multiple of 4, the
    vector path's neighbour words (forward and backward) against the
    lattice's modulo neighbours; the host words' divisors."""
    n = int(np.prod(shape))
    nd = len(shape)
    g = _walk(overlap.ov_words(shape, 1, 2, 1, 4, 1))
    assert (g["n"], g["nd"], g["lf"], g["lb"]) == (n, nd, shape[-1], shape[-2])
    assert g["la"] == (shape[0] if nd == 3 else 1)
    i = np.arange(n)
    pos, cb, ca = site_at(g, i)
    c = np.unravel_index(i, shape)
    assert np.array_equal(pos, c[-1]) and np.array_equal(cb, c[-2])
    assert np.array_equal(ca, c[0] if nd == 3 else 0 * i)
    for dd in range(nd):
        for back in (False, True):
            assert np.array_equal(site_step(g, i, dd, back), modulo_neighbours(shape, dd, back))
    if shape[-1] % 4:
        return
    grp = np.arange(n // 4)
    for dd in range(nd):
        for back in (False, True):
            want = modulo_neighbours(shape, dd, back)[4 * grp[:, None] + np.arange(4)]
            assert np.array_equal(word_sites(g, grp, dd, back), want), (dd, back)


@pytest.mark.parametrize("n_temps,n_pairs,d", [(24, 2, 8), (8, 1, 4), (3, 2, 2), (5, 3, 1)])
@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 16, 16), (64, 64), (6, 6, 6)])
def test_launch_map_takes_every_task_and_group_once(shape, n_temps, n_pairs, d):
    """The grid (task sets, groups' blocks, realizations) takes every
    (task, group) once, a thread's tasks consecutive and of one
    realization, for the rule's tasks a thread and every divisor; the
    rule's tasks a thread sit side by side per temperature; blocks past the
    cap stride."""
    n = int(np.prod(shape))
    n_grp = -(-n // 4)
    tg = n_temps * n_pairs
    for threads in (1 << 12, 1 << 16, 1 << 30):
        per = overlap.ov_per(n, d, n_temps, n_pairs, threads)
        assert tg % per == 0 and (per % n_pairs == 0 or n_pairs % per == 0)
        assert 1 <= per <= overlap.OV_MAX_PER
        assert per == 1 or n_grp * d * (tg // per) >= threads
    for per in [p for p in range(1, min(tg, overlap.OV_MAX_PER) + 1) if tg % p == 0]:
        g = _walk(overlap.ov_words(shape, d, n_temps, n_pairs, n_temps * 2 * n_pairs, per))
        b, grp, z = launch_map(g)
        assert _covers_once(b, grp, z, d * tg, n_grp)
        assert np.array_equal(b // tg, z)  # a thread's tasks: of its realization
    g = _walk(overlap.ov_words(shape, d, n_temps, n_pairs, n_temps * 2 * n_pairs, 1))
    assert _covers_once(*launch_map(g, cap=1), d * tg, n_grp)


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("kind", ["jorg", "cmr"])
@pytest.mark.parametrize("shape,couplings", CASES, ids=["8cube-pm", "16cube-gauss",
                                                        "8x64-gauss", "6cube-gauss", "6cube-pm"])
def test_model_states_are_bitwise_the_plain_bonds(shape, couplings, kind, wolff):
    """The model's state bytes (Joerg's bonds, CMR's blue ones) and seeds,
    and CMR's state2 bytes (grey bonds, bit 7 the blue flip decided once a
    site), bitwise ``bond_states_plain`` (``_jorg``, ``_cmr``); a Joerg task
    with no active probe takes the seed n."""
    d, n_rep, n_temps = (1, 2, 2) if shape == (16, 16, 16) else (2, 4, 3)
    args = _inputs(shape, d, n_rep, n_temps, couplings, 7 + len(shape), kind, wolff,
                   equal_pair=kind == "jorg")
    st, st2, sd = overlap.bond_states_plain(*args, kind=kind, wolff=wolff, shape=shape)
    for per in (0, 1):
        ms, ms2, msd, dec = model_states(*args, shape, kind, wolff, per)
        assert torch.equal(ms, st)
        assert torch.equal(msd, sd)
        if kind == "jorg":
            if wolff:
                assert int(sd[0]) == int(np.prod(shape))
            continue
        assert torch.equal(ms2, st2)
        assert (dec == 1).all()
        assert int((st2 >> 7).sum()) > 0 and int(((st2 & 7) != (st & 7)).sum()) > 0


def test_grey_bonds_need_no_neighbour_flip():
    """The identity ov_mid stands on: flipping a and b together on any set
    of sites leaves sat_a != sat_b of every bond as it was (jt neither +-0
    nor NaN), so the grey bonds on the flipped spins are those on the
    unflipped ones."""
    rng = np.random.default_rng(3)
    shape = (8, 8, 8)
    n = 512
    a = torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), (16, n)))
    b = torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), (16, n)))
    jt = torch.from_numpy(rng.standard_normal((16, n, 3)).astype(np.float32))
    jt[:, :8] = 0.0
    jt[:, 8:16] = -0.0
    flip = torch.from_numpy(rng.random((16, n)) < 0.5)
    fa, fb = torch.where(flip, -a, a), torch.where(flip, -b, b)
    for dd in range(3):
        s0 = overlap._sats(a, b, jt, shape, dd)
        s1 = overlap._sats(fa, fb, jt, shape, dd)
        assert torch.equal(s0[0] != s0[1], s1[0] != s1[1])


@pytest.mark.parametrize("temps", [(0.9, 2.2, 24), (0.8, 2.0, 24), (0.8, 2.0, 8)],
                         ids=["config4", "config5", "glass64"])
def test_thresholds_equal_the_float_compare(temps):
    """For every 24-bit word x and each temperature, ``x < threshold24(p)``
    iff ``x 2^-24 < p``, p each move's bond probability (Joerg, CMR's blue
    and grey) at |J/T| = |1/T| and at 256 gaussian couplings' J/T, drawn
    as the kernels and the plain version draw it."""
    x = torch.arange(1 << 24, dtype=torch.int64)
    u = trng.uniform24(x << 8)
    # u rises strictly with x, so x < thr iff u < p for every word iff the
    # words with u < p (searchsorted's float compares) are the thr first
    assert bool((u[1:] > u[:-1]).all())
    T = torch.from_numpy(np.geomspace(*temps[:2], temps[2]).astype(np.float32))
    assert torch.equal(torch.tensor(1.0) / T, -(torch.tensor(-1.0) / T))
    J = torch.from_numpy(np.random.default_rng(temps[2]).standard_normal(256).astype(np.float32))
    jt = torch.cat([1.0 / T, (J[:, None] / T).reshape(-1)])
    for which in ("jorg", "blue", "grey"):
        p = bond_prob(which, jt)
        below = torch.searchsorted(u, p)  # the words with u < p, by the float compare
        assert below.tolist() == [threshold24(v) for v in p.tolist()], which


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("kind", ["jorg", "cmr"])
def test_model_stats_graph_matches_the_jax_event(kind, wolff):
    """The model's stats graph (Joerg's bonds, CMR's blue ones) labelled as
    fk_link labels it equals the labels of the JAX package's fused event
    (``overlap_event_batch``, interpret mode) fed the same Philox uniforms,
    on a flat batch of tasks at their own temperatures."""
    from peapods_tpu.ops.lattice import Lattice as RefLattice
    from test_torch_overlap import _fused

    shape, n_tasks = (8, 16), 4
    lat = RefLattice(list(shape))
    n, nd = lat.n_spins, lat.n_dims
    rng = np.random.default_rng(11 + wolff)
    a = rng.choice(np.array([-1, 1], np.int8), size=(n_tasks, n))
    b = rng.choice(np.array([-1, 1], np.int8), size=(n_tasks, n))
    coup = rng.normal(size=(n, nd)).astype(np.float32)
    temps = np.linspace(0.8, 1.6, n_tasks).astype(np.float32)
    tkeys = jax.random.split(jax.random.key(5 + wolff), n_tasks)
    kd = np.asarray(jax.random.key_data(tkeys)).astype(np.uint32)
    words = torch.from_numpy(kd.view(np.int32).reshape(-1, 2))
    u = [trng.bond_uniforms(words, n, nd, f).numpy() for f in (0, nd)]
    slots = [u[0][..., k] for k in range(nd)] + (
        [u[1][..., k] for k in range(nd)] if kind == "cmr" else [])
    _, _, rlab = _fused(lat, a, b, tkeys, kind, wolff, coup, temps, slots)
    # the flat batch as one realization: task t pairs slots t and T + t
    scal, probes = seeds.event_scalars(kind, wolff, kd, n)
    spins = torch.from_numpy(np.concatenate([a, b])[None])
    sid = torch.arange(2 * n_tasks, dtype=torch.int32)[None]
    tasks = torch.tensor([[[[0, 1]] for _ in range(n_tasks)]], dtype=torch.int32)
    st, _, _, _ = model_states(spins, sid, tasks, torch.from_numpy(coup)[None],
                               torch.from_numpy(temps), torch.from_numpy(scal.reshape(-1, 6)),
                               torch.from_numpy(probes.reshape(-1, 64)), words, shape, kind,
                               wolff)
    lab = connected_components(state_masks(st, nd), shape).numpy()
    np.testing.assert_array_equal(lab, rlab)


def test_seed_ballot_is_the_first_active_probe():
    """Two ballots of 32 lanes (probes l and 32 + l) and the first set bit
    of the first non-empty one give find_seed's first active probe in probe
    order, n where none is."""
    rng = np.random.default_rng(4)
    n = 512
    act = torch.from_numpy(rng.random((64, n)) < np.linspace(0.0, 0.2, 64)[:, None])
    act[0] = False
    probes = torch.from_numpy(rng.integers(0, n, (64, 64)).astype(np.int32))
    want = find_seed(probes, act)
    hits = act.gather(1, probes.long()).numpy()
    for t in range(64):
        lo = int((hits[t, :32].astype(np.int64) << np.arange(32)).sum())
        hi = int((hits[t, 32:].astype(np.int64) << np.arange(32)).sum())
        ffs = lambda m: (m & -m).bit_length() - 1  # noqa: E731
        got = (int(probes[t, ffs(lo)]) if lo else int(probes[t, 32 + ffs(hi)]) if hi else n)
        assert got == int(want[t])
    assert int(want[0]) == n
