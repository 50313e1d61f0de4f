"""The table form's bond kernels (``csrc/fk.cu`` ``fk_bonds_table``,
``csrc/overlap.cu`` ``ov_bonds_table``), their launch plans and sequential
models of their order, from the shape alone:

* ``fk.table_bonds_plan`` over the table plans' shapes (4D 10^4 and 16^4,
  5D 6^5, odd 9^4, extent-1 axes, 16^3 with 9, 13 and 32 offsets, 32^4)
  and 1 to 384 graphs: a thread a group of four sites of ``per`` graphs of
  one realization, or (a launch of one graph a thread too small for the
  card) a CTA of ``split`` warps sharing each group's offsets; every
  (graph, site, offset) drawn exactly once, the grid and a CTA's threads
  and shared memory within the card's limits;
* ``overlap.ov_table_plan`` over the same shapes, 1 to 384 tasks and 1, 2
  or 4 CTAs an SM: every (task, site) once, a thread's tasks of one
  temperature side by side, the least waves times a thread's work
  (``overlap.table_waves``);
* a model of ``fk_bonds_table`` (its CTAs, each thread's group and graphs,
  the offsets in one step at the unrolled counts or steps of four, the
  split form's warps or'ing their bits, each draw through ``ops/rng``'s
  Philox and the unit coupling's integer threshold) bitwise
  ``fk_bonds_plain`` at the plan's and every other ``per`` and forced
  split forms;
* a model of ``ov_bonds_table`` (the CTA's staged tasks, a unit coupling's
  J / T as +-1 / T and its draw against the staged threshold, Philox only
  where a bond of the group can be active, the seeds written once a task by
  the task's first block) bitwise ``overlap.table_states_plain``'s first
  graph and seeds, Joerg and CMR, Wolff and SW, at every ``per``.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch.engine import seeds as tseeds
from peapods_tpu_torch.ops import fk, overlap
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.lattice import Lattice
from test_torch_table_plans import CARD, LONG32, PLAN_SHAPES, SHELLS3, SMEM, SYSTEMS, UNROLLED

torch.set_num_threads(1)

# csrc/fk.cu kTableMaxPer, kTableMaxSplit; csrc/overlap.cu kMaxPer; a CTA's
# most threads and the grid's limits
MAX_PER, MAX_SPLIT, OV_MAX_PER = 8, 8, 8
GRID_X, GRID_YZ = 2**31 - 1, 65535
# the static shared memory of fk_bonds_table (TableGraphs, the split form's
# bits) and ov_bonds_table (TableTasks)
FK_SMEM = 4 * 4 * MAX_PER + 32 * 4 * 4
OV_SMEM = (8 + 8 + 4 * 5) * OV_MAX_PER
ONE = torch.ones((), dtype=torch.int64)


# ------------------------------------------------------ fk_bonds_table's plan

def offset_ranges(plan, nb):
    """Each warp's offsets ``[lo, hi)``: all of them, or the split form's
    shares of ``ceil(nb / split)``."""
    if plan.split == 1:
        return [(0, nb)]
    c = -(-nb // plan.split)
    return [(min(nb, w * c), min(nb, w * c + c)) for w in range(plan.split)]


@pytest.mark.parametrize("d,s", SYSTEMS, ids=[f"{d}x{s}" for d, s in SYSTEMS])
@pytest.mark.parametrize("name,n,nb", PLAN_SHAPES)
def test_table_bonds_plan(name, n, nb, d, s):
    """Graphs a thread a divisor of the graphs, at most 8, the largest whose
    launch keeps an eighth of the card's resident threads and a CTA an SM;
    the split form only where one graph a thread is fewer CTAs than SMs,
    one graph a thread, at most 8 warps and no warp without offsets; every
    (graph, site, offset) drawn once; the grid, a CTA's threads and its
    shared memory within the card's limits."""
    plan = fk.table_bonds_plan(n, nb, d, s, CARD["threads"], CARD["sms"])
    groups = -(-n // 4)
    blocks = -(-groups // 256)
    assert s % plan.per == 0 and 1 <= plan.per <= MAX_PER
    assert 1 <= plan.split <= min(MAX_SPLIT, nb)

    def ok(p):
        return (s % p == 0 and groups * d * (s // p) >= CARD["threads"]
                and blocks * d * (s // p) >= CARD["sms"])

    assert plan.per == 1 or ok(plan.per)
    assert not any(ok(p) for p in range(plan.per + 1, MAX_PER + 1))
    span = 32 if plan.split > 1 else 256
    if plan.split > 1:
        assert plan.per == 1 and blocks * d * s < CARD["sms"]
        assert plan.threads == 32 * plan.split
    else:
        assert plan.threads == 256
    assert plan.grid == (-(-groups // span), s // plan.per, d)
    assert plan.grid[0] <= GRID_X and max(plan.grid[1:]) <= GRID_YZ
    assert plan.threads <= 1024 and FK_SMEM <= SMEM
    # thread t of CTA (x, y, z): sites 4 (span x + t % 32 ..) + k < n, its
    # warp's offsets, graphs z s + y per + q
    sites = np.zeros(n, np.int64)
    i0 = 4 * np.arange(plan.grid[0] * span)
    live = (i0[:, None] + np.arange(4)[None]).reshape(-1)
    np.add.at(sites, live[live < n], 1)
    assert (sites == 1).all()
    offs = np.zeros(nb, np.int64)
    for lo, hi in offset_ranges(plan, nb):
        offs[lo:hi] += 1
        assert hi > lo  # no warp without offsets
    assert (offs == 1).all()
    graphs = np.zeros(d * s, np.int64)
    for z in range(d):
        for y in range(plan.grid[1]):
            graphs[z * s + y * plan.per:z * s + (y + 1) * plan.per] += 1
    assert (graphs == 1).all()


def test_table_bonds_plan_forms():
    """The smoke's runs: the 4D glass 8 graphs a thread (480 CTAs), 16^4 x 16
    4 (256), nine16 8 (192); 16^3 with 13 offsets x 8 one graph a thread
    would be 32 CTAs: 5 warps of 3 offsets over 32 groups, 256 CTAs."""
    plan = lambda *a: fk.table_bonds_plan(*a, CARD["threads"], CARD["sms"])  # noqa: E731
    assert plan(10 ** 4, 4, 16, 24) == (8, 1, 256, (10, 3, 16))
    assert plan(16 ** 4, 4, 1, 16) == (4, 1, 256, (64, 4, 1))
    assert plan(16 ** 3, 9, 8, 48) == (8, 1, 256, (4, 6, 8))
    assert plan(16 ** 3, 13, 1, 8) == (1, 5, 160, (32, 8, 1))


# the CTAs an SM holds of ov_bonds_table's instance (the wrapper queries
# them, ``overlap.table_ctas``): a few counts its plan is held at
CTAS = [1, 2, 4]


# ------------------------------------------------------- ov_bonds_table's plan

# (realizations, temperatures, groups) of the moves' plan grid
TASKS = [(1, 1, 1), (2, 3, 2), (1, 8, 1), (16, 12, 1), (16, 12, 2), (8, 24, 1), (1, 96, 4)]


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("d,t,g", TASKS, ids=[f"{d}x{t}x{g}" for d, t, g in TASKS])
@pytest.mark.parametrize("name,n,nb", PLAN_SHAPES)
def test_ov_table_plan(name, n, nb, d, t, g, ctas):
    """Tasks a thread a divisor of a realization's tasks, at most 8, a
    multiple or a divisor of its groups, of the least waves times a
    thread's work (the largest of a tie); the grid (task sets, group blocks
    up to 65535 striding over the rest, realizations) covering every (task,
    site) once, within the card's limits, and the CTA's staged tasks
    within its shared memory."""
    plan = overlap.ov_table_plan(n, d, t, g, CARD["sms"], ctas)
    tg = t * g
    assert tg % plan.per == 0 and 1 <= plan.per <= OV_MAX_PER
    assert plan.per % g == 0 or g % plan.per == 0
    groups = -(-n // 4)
    blocks = -(-groups // 256)
    assert plan.grid == (tg // plan.per, min(blocks, GRID_YZ), d)
    assert max(plan.grid) <= GRID_YZ and OV_SMEM <= SMEM
    cost = {p: overlap.table_waves(min(blocks, GRID_YZ) * d * (tg // p),
                                   CARD["sms"] * ctas, p)
            for p in range(1, OV_MAX_PER + 1) if tg % p == 0 and (p % g == 0 or g % p == 0)}
    assert cost[plan.per] == min(cost.values())
    assert not any(c == cost[plan.per] and p > plan.per for p, c in cost.items())
    tasks = np.zeros(d * tg, np.int64)
    for z in range(d):
        for x in range(plan.grid[0]):
            tasks[z * tg + x * plan.per:z * tg + (x + 1) * plan.per] += 1
    assert (tasks == 1).all()
    sites = np.zeros(n, np.int64)
    for y in range(plan.grid[1]):
        grp = np.arange(y * 256, groups, plan.grid[1] * 256)[:, None] + np.arange(256)[None]
        grp = grp[grp < groups].reshape(-1)
        i = (4 * grp[:, None] + np.arange(4)[None]).reshape(-1)
        np.add.at(sites, i[i < n], 1)
    assert (sites == 1).all()
    # a thread's tasks of one temperature side by side: its temperature
    # changes only between whole groups
    for x in range(plan.grid[0]):
        temps = [(x * plan.per + k) // g for k in range(plan.per)]
        assert temps == sorted(temps)


def test_ov_table_plan_forms():
    """The smoke's runs on an H100: the glass (the 4-offset kernels two CTAs
    an SM) 4 tasks a thread (480 CTAs, two waves; 6 would be 320, a wave and
    a fifth), nine16 (the 9-offset kernels one) 3 (128 CTAs, one wave)."""
    assert overlap.ov_table_plan(10 ** 4, 16, 12, 1, 132, 2) == (4, (3, 10, 16))
    assert overlap.ov_table_plan(16 ** 3, 8, 12, 1, 132, 1) == (3, (4, 4, 8))


# ------------------------------------------------------------- the models

def _philox(k0, k1, d, grp):
    """The four words of Philox keyed by ints ``k0, k1`` at counter ``(d,
    grp, 0, 0)`` for int64 ``grp [m]``: int64 ``[4, m]``."""
    zero = torch.zeros((), dtype=torch.int64)
    out = trng.philox4x32(torch.tensor(k0 & trng.MASK32), torch.tensor(k1 & trng.MASK32),
                          torch.tensor(d, dtype=torch.int64), grp, zero, zero)
    return torch.stack(out)


def _threshold24(p):
    """``csrc/overlap.cu`` ``threshold24`` (``csrc/fk.cu`` ``unit_threshold``
    of the unit bond's probability): the least 24-bit word not below ``p
    2^24``, int64."""
    x = torch.ceil(p.to(torch.float32) * 16777216.0).clamp(max=16777216.0)
    return torch.where(p > 0.0, x, torch.zeros_like(x)).to(torch.int64)


def model_table_bonds(spins, coup, temps, kb, fwd, plan):
    """``fk_bonds_table`` in torch, CTA after CTA: thread t of CTA (x, y, z)
    the group of four sites 4 (span x + t % 32 or t) for graphs z S + y per
    .. of the CTA's staged temperatures, unit thresholds and key words; the
    group's table rows and couplings read once; each warp's offsets (all,
    or the split form's share) in one step at the unrolled counts or steps
    of four; each bond's word (site & 3) of Philox at counter (d, group); a
    bond where s s_f J > 0 (J's sign, flipped where the spins differ) and,
    at |J| == 1, the integer compare with the unit threshold, else u < 1 -
    exp(-2 |J| / T); the warps' bits or'ed.  Returns the words int32 ``[B,
    n]`` and the (graph, site, offset) draws taken."""
    b_all, n = spins.shape
    d, _, nb = coup.shape
    s_per = b_all // d
    span = 32 if plan.split > 1 else 256
    step = nb if nb in UNROLLED and plan.split == 1 else 4
    gx, gy, gz = plan.grid
    words = torch.zeros((b_all, n), dtype=torch.int64)
    taken = torch.zeros((b_all, n, nb), dtype=torch.int64)
    for z in range(gz):
        for y in range(gy):
            b0 = z * s_per + y * plan.per
            staged = []
            for k in range(plan.per):
                t = temps[b0 + k]
                p1 = 1.0 - torch.exp(-2.0 * torch.tensor(1.0) / t)
                staged.append((t, _threshold24(p1), int(kb[b0 + k, 0]), int(kb[b0 + k, 1])))
            for x in range(gx):
                grp = torch.arange(x * span, (x + 1) * span, dtype=torch.int64)
                i = (4 * grp[:, None] + torch.arange(4)[None])  # [span, 4]
                on = i < n
                i = i.clamp(max=n - 1)
                f = fwd[i]  # the group's rows, read once: [span, 4, nb]
                jc = torch.where(on[..., None], coup[z][i], torch.zeros(()))
                for lo, hi in offset_ranges(plan, nb):
                    for k, (t, thr1, k0, k1) in enumerate(staged):
                        b = b0 + k
                        sf = spins[b].to(torch.float32)
                        bits = torch.zeros((span, 4), dtype=torch.int64)
                        for d0 in range(lo, hi, step):
                            for dd in range(d0, min(d0 + step, hi)):
                                u = _philox(k0, k1, dd, grp).T  # [span, 4]
                                j = jc[..., dd]
                                same = sf[i] == sf[f[..., dd]]
                                sat = torch.where(same, j > 0.0, j < 0.0)  # s s_f J > 0
                                p = 1.0 - torch.exp(-2.0 * j.abs() / t)
                                act = sat & torch.where(j.abs() == 1.0, (u >> 8) < thr1,
                                                        trng.uniform24(u) < p)
                                bits |= (act & on).to(torch.int64) << dd
                                taken[b].index_put_((i[on], torch.full_like(i[on], dd)),
                                                    ONE, accumulate=True)
                        words[b].index_put_((i[on],), bits[on] | words[b][i[on]])
    return ((words + 2**31) % 2**32 - 2**31).to(torch.int32), taken


def _fk_inputs(lat, d, s, couplings, seed):
    rng = np.random.default_rng(seed)
    n, nb = lat.n_spins, lat.n_neighbors
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nb)) if couplings == "pm"
            else rng.standard_normal((d, n, nb))).astype(np.float32)
    return (torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), (d * s, n))),
            torch.from_numpy(coup),
            torch.from_numpy(rng.uniform(0.8, 4.0, d * s).astype(np.float32)),
            torch.from_numpy(rng.integers(-2**31, 2**31, (d * s, 2)).astype(np.int32)))


def _pack(bonds):
    w = (bonds.to(torch.int64) << torch.arange(bonds.shape[-1])).sum(-1)
    return ((w + 2**31) % 2**32 - 2**31).to(torch.int32)


BOND_LATTICES = [
    ("4d4", (4, 4, 4, 4), None, 2, 6, "pm"), ("3^4-tail", (3, 3, 3, 3), None, 1, 4, "gauss"),
    ("1x3x3x3-self", (1, 3, 3, 3), None, 2, 2, "pm"), ("5d3", (3, 3, 3, 3, 3), None, 1, 2, "pm"),
    ("shells13", (4, 4, 4), SHELLS3, 1, 8, "pm"), ("nine9", (4, 4, 4), SHELLS3[:9], 2, 4, "gauss"),
    ("long32", (4, 4, 4), LONG32, 1, 2, "gauss"), ("ten7x9", (7, 9), None, 1, 3, "gauss"),
]
TEN7 = [[1, 0], [0, 1], [1, 1], [1, -1], [2, 0], [0, 2], [2, 1]]


def _lattice(name, shape, offsets):
    lat = Lattice(shape, TEN7 if name == "ten7x9" else offsets)  # 7 offsets: steps, a tail
    assert lat.table
    return lat


@pytest.mark.parametrize("name,shape,offsets,d,s,couplings", BOND_LATTICES,
                         ids=[x[0] for x in BOND_LATTICES])
def test_table_bonds_model(name, shape, offsets, d, s, couplings):
    """The model of the redesigned bonds, at the plan's form, every count of
    graphs a thread and split forms of 2, 3 and 8 warps, bitwise the bits of
    ``fk_bonds_plain(..., offsets)``; every (graph, site, offset) drawn once."""
    lat = _lattice(name, shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    spins, coup, temps, kb = _fk_inputs(lat, d, s, couplings, 2029)
    want = _pack(fk.fk_bonds_plain(spins.view(-1, *lat.shape), coup, temps, kb,
                                    offsets=lat.offsets))
    assert want.any()
    fwd = torch.from_numpy(lat.fwd.astype(np.int64))
    groups = -(-n // 4)
    forms = {fk.table_bonds_plan(n, nb, d, s, 64, 4)}
    forms |= {fk.TableBondsPlan(p, 1, 256, (-(-groups // 256), s // p, d))
              for p in range(1, MAX_PER + 1) if s % p == 0}
    forms |= {fk.TableBondsPlan(1, k, 32 * k, (-(-groups // 32), s, d))
              for k in (2, 3, 8) if k <= nb}
    for plan in sorted(forms):
        got, taken = model_table_bonds(spins, coup, temps, kb, fwd, plan)
        assert (taken == 1).all(), plan
        assert torch.equal(got, want), plan


def model_ov_bonds_table(spins, sid, tasks, coup, temps, scal, probes, keys, fwd, plan,
                         kind, wolff):
    """``ov_bonds_table`` in torch, CTA after CTA: CTA (x, y, z) stages tasks
    z T G + x per .. (their two systems' rows through sid, key words,
    temperature, 1 / T and the unit threshold); its threads take groups y
    256 + t, striding by the grid's y; for each task, each offset: a unit
    coupling's J / T is +-1 / T, other couplings divide; Joerg's candidates
    a a_f jt > 0, a != b and a_f != b_f, CMR's blue a a_f jt > 0 and b b_f
    jt > 0; Philox at counter (d, group) where a candidate of the group is,
    each bond its word's integer compare with the staged threshold (unit)
    or threshold24 of its probability.  The seeds by the tasks' first
    blocks (y = 0): Joerg Wolff's first probe with a != b (the two ballots'
    order), CMR's scal[b, 4], n for Joerg SW.  Returns (words int32 [B, n],
    seeds int32 [B], the (task, site) counts taken, the seeds' writes)."""
    d, _, n = spins.shape
    _, n_temps, n_groups, _ = tasks.shape
    nb = fwd.shape[1]
    tg = n_temps * n_groups
    b_all = d * tg
    flat = tasks.reshape(b_all, 2)
    step = nb if nb in UNROLLED else 4
    which = 1 if kind == "jorg" else 0
    gx, gy, gz = plan.grid
    groups = -(-n // 4)
    words = torch.zeros((b_all, n), dtype=torch.int64)
    seeds = torch.full((b_all,), -1, dtype=torch.int32)
    writes = torch.zeros(b_all, dtype=torch.int64)
    taken = torch.zeros((b_all, n), dtype=torch.int64)

    def prob(jt):
        if which:
            return 1.0 - torch.exp(-4.0 * jt.abs())
        r = torch.exp(-2.0 * jt.abs())
        return 1.0 - r * r

    for z in range(gz):
        for x in range(gx):
            staged = []
            for k in range(plan.per):
                w = x * plan.per + k
                b, t = z * tg + w, w // n_groups
                a_sys = spins[z, sid[z, flat[b, 0] * n_temps + t]]
                b_sys = spins[z, sid[z, flat[b, 1] * n_temps + t]]
                inv = 1.0 / temps[t]
                staged.append((b, a_sys, b_sys, temps[t], inv, _threshold24(prob(inv)),
                               int(keys[b, 0]), int(keys[b, 1])))
            for y in range(gy):
                if y == 0:  # the seeds, once a task
                    for b, a_sys, b_sys, *_ in staged:
                        writes[b] += 1
                        if kind == "jorg" and wolff:
                            hits = (a_sys[probes[b].long()] != b_sys[probes[b].long()])
                            first = [int(probes[b, j]) for j in range(64) if hits[j]]
                            seeds[b] = first[0] if first else n
                        else:
                            seeds[b] = int(scal[b, 4]) if kind == "cmr" else n
                grp = torch.arange(y * 256, groups, gy * 256)[:, None] + torch.arange(256)[None]
                grp = grp[grp < groups].reshape(-1)
                i = 4 * grp[:, None] + torch.arange(4)[None]
                on = i < n
                i = i.clamp(max=n - 1)
                f = fwd[i]
                jc = torch.where(on[..., None], coup[z][i], torch.zeros(()))
                for b, a_sys, b_sys, t, inv, thr, k0, k1 in staged:
                    a, bb = a_sys[i].to(torch.int32), b_sys[i].to(torch.int32)
                    bits = torch.zeros(i.shape, dtype=torch.int64)
                    for d0 in range(0, nb, step):
                        for dd in range(d0, min(d0 + step, nb)):
                            af = a_sys[f[..., dd]].to(torch.int32)
                            bf = b_sys[f[..., dd]].to(torch.int32)
                            j = jc[..., dd]
                            unit = j.abs() == 1.0
                            # a unit coupling: J / T = +-1 / T, its sign J's and 1 / T's,
                            # flipped where the spins differ; another: the float test
                            jp = unit & (((j > 0) & (inv > 0)) | ((j < 0) & (inv < 0)))
                            jn = unit & (((j < 0) & (inv > 0)) | ((j > 0) & (inv < 0)))
                            jt = torch.where(unit, torch.zeros(()), j / t)
                            sa = torch.where(unit, torch.where(a == af, jp, jn),
                                             (a * af).to(torch.float32) * jt > 0.0)
                            sb = torch.where(unit, torch.where(bb == bf, jp, jn),
                                             (bb * bf).to(torch.float32) * jt > 0.0)
                            if kind == "jorg":
                                cand = sa & (a != bb) & (af != bf)
                            else:
                                cand = sa & sb
                            cand &= on
                            drawn = cand.any(-1)  # a Philox block only where one is
                            u = _philox(k0, k1, dd, grp[drawn]).T
                            lim = torch.where(unit[drawn], thr, _threshold24(prob(jt[drawn])))
                            act = torch.zeros_like(cand)
                            act[drawn] = cand[drawn] & ((u >> 8) < lim)
                            bits |= act.to(torch.int64) << dd
                    words[b].index_put_((i[on],), bits[on])
                    taken[b].index_put_((i[on],), ONE, accumulate=True)
    return ((words + 2**31) % 2**32 - 2**31).to(torch.int32), seeds, taken, writes


def _ov_inputs(lat, d, n_rep, n_temps, kind, wolff, couplings, seed):
    """Spins by system, sid, the tasks and their scalars, probes and keys
    (``engine.seeds``), couplings and temperatures."""
    rng = np.random.default_rng(seed)
    n, nb, s = lat.n_spins, lat.n_neighbors, n_rep * n_temps
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nb)) if couplings == "pm"
            else rng.standard_normal((d, n, nb))).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(
        n_rep)[:, None] for _ in range(d)]).reshape(d, s).astype(np.int32)
    keys = rng.integers(0, 2**32, (d, 2), dtype=np.uint64).astype(np.uint32)
    tasks, tkeys = tseeds.overlap_tasks(keys, [seed], n_rep, n_temps, 2)
    scal, probes = tseeds.event_scalars(kind, wolff, tkeys[0], n)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (up(rng.choice(np.array([-1, 1], np.int8), (d, s, n))), up(sid), up(tasks[0]),
            up(coup), up(np.geomspace(0.9, 2.2, n_temps).astype(np.float32)),
            up(scal.reshape(-1, 6)), up(probes.reshape(-1, 64)),
            up(tkeys[0].view(np.int32).reshape(-1, 2)))


OV_LATTICES = [
    ("4d4", (4, 4, 4, 4), None, 2, 2, 6, "pm"),
    ("3^4-tail", (3, 3, 3, 3), None, 2, 4, 3, "gauss"),
    ("1x3x3x3-self", (1, 3, 3, 3), None, 2, 2, 3, "pm"),
    ("5d3", (3, 3, 3, 3, 3), None, 1, 2, 4, "pm"),
    ("shells13", (4, 4, 4), SHELLS3, 1, 4, 4, "pm"),
    ("nine9", (4, 4, 4), SHELLS3[:9], 2, 2, 3, "gauss"),
    ("long32", (4, 4, 4), LONG32, 1, 2, 3, "gauss"),
    ("ten7x9", (7, 9), None, 1, 2, 5, "gauss"),
]


@pytest.mark.parametrize("kind", ["jorg", "cmr"])
@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,offsets,d,n_rep,n_temps,couplings", OV_LATTICES,
                         ids=[x[0] for x in OV_LATTICES])
def test_ov_bonds_table_model(name, shape, offsets, d, n_rep, n_temps, couplings, wolff, kind):
    """The model of the redesigned move bonds, at every count of tasks a
    thread that splits a realization's tasks (``ov_per``'s rule), bitwise
    ``table_states_plain``'s first graph and seeds; every (task, site) once,
    every seed written once."""
    lat = _lattice(name, shape, offsets)
    n = lat.n_spins
    x = _ov_inputs(lat, d, n_rep, n_temps, kind, wolff, couplings, 2029 + wolff)
    spins, sid, tasks, coup, temps, scal, probes, keys = x
    st, _, _, sd = overlap.table_states_plain(spins.clone(), sid, tasks, coup, temps, scal,
                                              probes, keys, kind=kind, wolff=wolff, lattice=lat)
    assert st.any()
    fwd = torch.from_numpy(lat.fwd.astype(np.int64))
    g = n_rep // 2
    tg = n_temps * g
    blocks = -(-(-(-n // 4)) // 256)
    for per in [p for p in range(1, OV_MAX_PER + 1)
                if tg % p == 0 and (p % g == 0 or g % p == 0)]:
        plan = overlap.OvTablePlan(per, (tg // per, blocks, d))
        words, seeds, taken, writes = model_ov_bonds_table(
            spins, sid, tasks, coup, temps, scal, probes, keys, fwd, plan, kind, wolff)
        assert (taken == 1).all() and (writes == 1).all(), per
        assert torch.equal(words, st), per
        assert torch.equal(seeds, sd), per
