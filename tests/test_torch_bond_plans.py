"""The table form's bond kernels (``csrc/fk.cu`` ``fk_bonds_table``,
``csrc/overlap.cu`` ``ov_bonds_table``, ``ov_mid_table``,
``houdn_bonds_table``), their launch plans and sequential models of their
order, from the shape alone:

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
  graph and seeds, Joerg and CMR, Wolff and SW, at every ``per``;
* the planned kernels' caps (``overlap.table_most``: ``houdn_bonds_table``'s
  staged member rows) and ``overlap.table_pers`` (each move's planned
  kernels on their own CTAs an SM);
* a model of ``ov_mid_table`` (the CTA's staged tasks, salts and Wolff
  roots, the blue flips from the parents with the backward table walked
  only where an SW coin fell on a root with no bond, the grey candidates
  as ``byte_differ`` words, Philox at counter (nb + d, group) only where one
  is) bitwise ``table_states_plain``'s grey words and flip bytes, and of
  ``houdn_bonds_table`` (the CTA's staged member rows, per-byte sign counts
  against g / 2, 16-bit lanes past g = 254, the seeds once a task) bitwise
  its words and seeds, Wolff and SW, at every ``per``.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch.engine import seeds as tseeds
from peapods_tpu_torch.ops import fk, overlap
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.cluster import connected_components, salted_uniform
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
OV_SMEM = (8 + 8 + 4 * 8) * OV_MAX_PER
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
    """The smoke's runs on an H100: at the glass ov_bonds_table and SW
    ov_mid_table (the 4-offset kernels two CTAs an SM) 4 tasks a thread (480
    CTAs, two waves; 6 would be 320, a wave and a fifth), houdn_bonds_table
    (three CTAs an SM, the pair and Wolff houd4 alike) 6 (320 CTAs, one
    wave); at nine16 the 9-offset kernels (one CTA an SM) 3 (128 CTAs, one
    wave)."""
    assert overlap.ov_table_plan(10 ** 4, 16, 12, 1, 132, 2) == (4, (3, 10, 16))
    for g in (2, 4):
        most = overlap.table_most("houdn_bonds_table", g)
        assert overlap.ov_table_plan(10 ** 4, 16, 12, 1, 132, 3, most) == (6, (2, 10, 16))
    assert overlap.ov_table_plan(16 ** 3, 8, 12, 1, 132, 1) == (3, (4, 4, 8))


# (kernel, group size): the planned kernels' caps on a thread's tasks
MOSTS = [("ov_bonds_table", 2), ("ov_mid_table", 2), ("houdn_bonds_table", 2),
         ("houdn_bonds_table", 4), ("houdn_bonds_table", 256), ("houdn_bonds_table", 2048),
         ("houdn_bonds_table", 8192)]


@pytest.mark.parametrize("ctas", CTAS)
@pytest.mark.parametrize("kernel,g", MOSTS, ids=[f"{k}-g{g}" for k, g in MOSTS])
@pytest.mark.parametrize("d,t,groups", [(16, 12, 1), (1, 96, 1), (2, 3, 2)],
                         ids=["16x12x1", "1x96x1", "2x3x2"])
def test_planned_kernels_plan(kernel, g, d, t, groups, ctas):
    """Each planned kernel's tasks a thread under its cap
    (``overlap.table_most``: houdn_bonds_table's per g staged 8-byte member
    rows within 48 KB, or one task), the least waves of the divisors under
    the cap, and a launch the host entry takes (per <= 8 dividing T G, the
    rows within a CTA's shared memory)."""
    most = overlap.table_most(kernel, g)
    assert 1 <= most <= OV_MAX_PER
    plan = overlap.ov_table_plan(10 ** 4, d, t, groups, CARD["sms"], ctas, most)
    assert plan.per <= most and (t * groups) % plan.per == 0
    if kernel == "houdn_bonds_table":
        assert most == 1 or most * g * 8 <= 48 * 1024
        assert plan.per * g * 8 <= SMEM
    free = overlap.ov_table_plan(10 ** 4, d, t, groups, CARD["sms"], ctas)
    assert plan == free or free.per > most


def test_table_pers(monkeypatch):
    """``overlap.table_pers``: each move's planned kernels (Joerg
    ``ov_bonds_table``; CMR also ``ov_mid_table``, Wolff or SW; Houdayer
    ``houdn_bonds_table`` with its member rows' shared memory at its cap),
    each planned on its own CTAs an SM."""
    asked = []
    ctas = {"ov_bonds_table": 2, "ov_mid_table": 1, "houdn_bonds_table": 4}

    def fake_ctas(index, kernel, nb, variant=0, smem=0):
        asked.append((kernel, nb, variant, smem))
        return ctas[kernel]

    monkeypatch.setattr(overlap, "table_ctas", fake_ctas)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: type("P", (), {"multi_processor_count": CARD["sms"]}))
    plan = lambda k, g=1: overlap.ov_table_plan(  # noqa: E731
        10 ** 4, 16, 12, g, CARD["sms"], ctas[k], overlap.table_most(k, 2 * g)).per
    assert overlap.table_pers(10 ** 4, 4, 16, 12, 1, "jorg", True, index=0) == {
        "ov_bonds_table": plan("ov_bonds_table")}
    assert overlap.table_pers(10 ** 4, 4, 16, 12, 1, "cmr", False, index=0) == {
        "ov_bonds_table": plan("ov_bonds_table"), "ov_mid_table": plan("ov_mid_table")}
    assert overlap.table_pers(10 ** 4, 4, 16, 12, 1, "houdayer", True, 4, index=0) == {
        "houdn_bonds_table": overlap.ov_table_plan(10 ** 4, 16, 12, 1, CARD["sms"], 4).per}
    overlap.table_pers(10 ** 4, 4, 16, 12, 1, "cmr", True, index=0)
    assert asked == [("ov_bonds_table", 4, 1, 0), ("ov_bonds_table", 4, 2, 0),
                     ("ov_mid_table", 4, 0, 0), ("houdn_bonds_table", 4, 0, 8 * 4 * 8),
                     ("ov_bonds_table", 4, 2, 0), ("ov_mid_table", 4, 1, 0)]


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


def _ov_inputs(lat, d, n_rep, n_temps, kind, wolff, couplings, seed, g=2):
    """Spins by system, sid, the tasks of ``g`` replicas and their scalars,
    probes and keys (``engine.seeds``), couplings and temperatures."""
    rng = np.random.default_rng(seed)
    n, nb, s = lat.n_spins, lat.n_neighbors, n_rep * n_temps
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nb)) if couplings == "pm"
            else rng.standard_normal((d, n, nb))).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(
        n_rep)[:, None] for _ in range(d)]).reshape(d, s).astype(np.int32)
    keys = rng.integers(0, 2**32, (d, 2), dtype=np.uint64).astype(np.uint32)
    tasks, tkeys = tseeds.overlap_tasks(keys, [seed], n_rep, n_temps, g)
    scal, probes = tseeds.event_scalars(kind, wolff, tkeys[0], n)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    spins = rng.choice(np.array([-1, 1], np.int8), (d, s, n))
    if g > 2:  # half the members of each site down where a coin falls: balanced sites
        half = rng.random((d, 1, n)) < 0.5
        spins = np.where(half, np.where(np.arange(s)[None, :, None] % 2 == 0, 1, -1),
                         spins).astype(np.int8)
    return (up(spins), up(sid), up(tasks[0]),
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


# ------------------------------------- ov_mid_table's and houdn_bonds_table's

KBYTE = 0x01010101  # bit 0 of each byte of a word
LANE = 0x00010001  # bit 0 of each 16-bit lane
SHIFTS = torch.tensor([0, 8, 16, 24])


def _word(b):
    """int64 words of four bytes ``b [..., 4]`` (each 0 .. 255), byte q the
    group's site q."""
    return ((b & 0xFF) << SHIFTS).sum(-1)


def _bytes_of(w):
    """Bit 0 of each byte of int64 words ``w [...]`` as bool ``[..., 4]``."""
    return ((w[..., None] >> SHIFTS) & 1).bool()


def _byte_differ(u, v):
    """``table.cuh`` ``byte_differ``: bit 0 of byte q where the spin bytes q
    of u and v differ (bit 7 of their xor)."""
    return ((u ^ v) >> 7) & KBYTE


def _vcmpeq(c, h, lane_bits):
    """``__vcmpeq4`` (lanes of 8 bits) or ``__vcmpeq2`` (16) of counts ``c``
    against ``h`` in every lane, masked to each lane's bit 0."""
    out = torch.zeros_like(c)
    for lo in range(0, 32, lane_bits):
        lane = (c >> lo) & ((1 << lane_bits) - 1)
        out |= (lane == h).to(torch.int64) << lo
    return out


def _gather_word(sys_spins, idx):
    """The spin bytes of one system at sites ``idx [..., 4]`` as words."""
    return _word(sys_spins[idx].to(torch.int64))


def _group_sites(n, y, gy):
    """Block y's groups (striding by the grid's y), their four sites clamped
    below n, which are live, and the table rows' entries of a group as
    ``whole_rows`` / ``step_rows`` read them (a site past n: its group's
    first index)."""
    groups = -(-n // 4)
    grp = torch.arange(y * 256, groups, gy * 256)[:, None] + torch.arange(256)[None]
    grp = grp[grp < groups].reshape(-1)
    i = 4 * grp[:, None] + torch.arange(4)[None]
    on = i < n
    return grp, i.clamp(max=n - 1), on


def _grey_threshold(jt):
    return _threshold24(1.0 - torch.exp(-2.0 * jt.abs()))


def model_ov_mid_table(spins, sid, tasks, coup, temps, scal, keys, fwd, bwd, state, parent,
                       plan, wolff):
    """``ov_mid_table`` in torch, CTA after CTA: CTA (x, y, z) stages tasks z
    T G + x per .. (their two systems' rows, key words, T, 1 / T, the unit
    grey threshold, the SW salts and the Wolff seed's root, parent[b,
    seed]); its threads take groups y 256 + t, striding by the grid's y,
    whose table rows and coupling words (bit 0 J > 0, 1 J < 0, 2 |J| == 1)
    are read once.  For each task: the blue words and parents of the group;
    the blue flip (Wolff: parent == root; SW: the coin on the parent below
    1/2 and nonsingleton, the backward words read only for a root with no
    bond whose coin fell and only from its backward neighbours past it: the
    parents are least-site labels); then each offset's four sites as words: a unit
    coupling's candidate byte_differ(a ^ a_f, b ^ b_f) where 1 / T is
    neither 0 nor NaN and the bond is not blue, Philox at counter (nb + d,
    group) only where one is, each draw u >> 8 against the staged threshold;
    another coupling's the float tests sat_a != sat_b of J / T and
    threshold24(1 - exp(-2 |J / T|)).  Returns (grey words int32 [B, n],
    flips uint8 [B, n], the (task, site) counts taken, the sites whose
    backward table was walked)."""
    d, _, n = spins.shape
    _, n_temps, n_groups, _ = tasks.shape
    nb = fwd.shape[1]
    tg = n_temps * n_groups
    b_all = d * tg
    flat = tasks.reshape(b_all, 2)
    st_all = state.to(torch.int64) & 0xFFFFFFFF
    gx, gy, gz = plan.grid
    grey = torch.zeros((b_all, n), dtype=torch.int64)
    flips = torch.zeros((b_all, n), dtype=torch.uint8)
    taken = torch.zeros((b_all, n), dtype=torch.int64)
    walked = torch.zeros((b_all, n), dtype=torch.bool)
    for z in range(gz):
        for x in range(gx):
            staged = []
            for k in range(plan.per):
                w = x * plan.per + k
                b, t = z * tg + w, w // n_groups
                a_sys = spins[z, sid[z, flat[b, 0] * n_temps + t]].to(torch.int64)
                b_sys = spins[z, sid[z, flat[b, 1] * n_temps + t]].to(torch.int64)
                inv = 1.0 / temps[t]
                root = int(parent[b, int(scal[b, 4])]) if wolff else -1
                staged.append((b, a_sys, b_sys, temps[t], inv, _grey_threshold(inv),
                               int(keys[b, 0]), int(keys[b, 1]), scal[b, 0], scal[b, 1], root))
            for y in range(gy):
                grp, i, on = _group_sites(n, y, gy)
                i0 = (4 * grp)[:, None].expand_as(i)
                f = torch.where(on[..., None], fwd[i], i0[..., None])  # [m, 4, nb]
                jc = torch.where(on[..., None], coup[z][i], torch.zeros(()))
                pos = _word((jc > 0).to(torch.int64).permute(0, 2, 1))  # [m, nb]
                uni = _word((jc.abs() == 1.0).to(torch.int64).permute(0, 2, 1))
                live = _word(on.to(torch.int64))
                for b, a_sys, b_sys, t, inv, thr, k0, k1, s0, s1, root in staged:
                    st = torch.where(on, st_all[b][i], torch.zeros((), dtype=torch.int64))
                    lab = torch.where(on, parent[b][i].to(torch.int64), torch.full((), -1))
                    if wolff:
                        fl = on & (lab == root)
                    else:
                        coin = on & (salted_uniform(lab, s0, s1) < 0.5)
                        need = coin & (st == 0) & (lab == i)
                        # only backward neighbours past a root can bond to it
                        look = need & (bwd[i] > i[..., None]).any(-1)
                        back = torch.zeros_like(need)
                        for dd in range(nb):
                            j = bwd[i, dd]
                            back |= look & (j > i) & ((st_all[b][j] >> dd) & 1).bool()
                        walked[b].index_put_((i[look],), torch.ones((), dtype=torch.bool))
                        fl = coin & ((st != 0) | (lab != i) | back)
                    flips[b].index_put_((i[on],), fl[on].to(torch.uint8))
                    own = torch.where(on, 0, 0)  # absent bytes read 0
                    aw = _word(torch.where(on, a_sys[i] & 0xFF, own))
                    bw = _word(torch.where(on, b_sys[i] & 0xFF, own))
                    nz = KBYTE if (inv > 0 or inv < 0) else 0
                    words = st.clone()
                    for dd in range(nb):
                        an = _gather_word(a_sys, f[..., dd])
                        bn = _gather_word(b_sys, f[..., dd])
                        blue = _word((st >> dd) & 1)
                        opened = live & ~blue
                        cand = _byte_differ(aw ^ an, bw ^ bn) & uni[:, dd] & nz & opened
                        drawn = cand != 0  # a Philox block only where one is
                        on_w = torch.zeros_like(cand)
                        u = _philox(k0, k1, nb + dd, grp[drawn]).T  # [m', 4]
                        on_w[drawn] = _word(((u >> 8) < thr).to(torch.int64)) & cand[drawn]
                        other = ~uni[:, dd] & opened & KBYTE
                        if other.any():
                            jt = jc[..., dd] / t
                            af, bf = a_sys[f[..., dd]], b_sys[f[..., dd]]
                            sa = (a_sys[i] * af).to(torch.float32) * jt > 0.0
                            sb = (b_sys[i] * bf).to(torch.float32) * jt > 0.0
                            c2 = _bytes_of(other) & (sa != sb)
                            hit = c2.any(-1)
                            u2 = _philox(k0, k1, nb + dd, grp[hit]).T
                            bits = torch.zeros_like(c2)
                            bits[hit] = c2[hit] & ((u2 >> 8) < _grey_threshold(jt[hit]))
                            on_w |= _word(bits.to(torch.int64))
                        words |= ((on_w[:, None] >> SHIFTS) & 1) << dd
                    grey[b].index_put_((i[on],), words[on])
                    taken[b].index_put_((i[on],), ONE, accumulate=True)
                del pos
    return (((grey + 2**31) % 2**32 - 2**31).to(torch.int32), flips, taken, walked)


def model_houdn_bonds_table(spins, sid, tasks, probes, fwd, plan):
    """``houdn_bonds_table`` in torch, CTA after CTA: CTA (x, y, z) stages the
    g member rows of tasks z T G + x per ..; its threads take groups y 256
    + t (striding by the grid's y), whose table rows are read once.  For
    each task, each member's own word and each offset's neighbour word add
    their sign bits (bit 7 of each spin byte) into per-byte counts (16-bit
    lanes past g = 254), a site balanced where its count is g / 2
    (``__vcmpeq4`` / ``__vcmpeq2``); bond d = act & act_f[d] & live.  The
    seeds by the tasks' first blocks (y = 0): the first balanced probe in
    the two ballots' order, n when none is (Wolff only: ``seeds`` is None
    for SW, whose seed is n).  Returns (words int32 [B, n], seeds int32
    [B], the (task, site) counts taken, the seeds' writes)."""
    d, _, n = spins.shape
    _, n_temps, n_groups, gs = tasks.shape
    nb = fwd.shape[1]
    tg = n_temps * n_groups
    b_all = d * tg
    flat = tasks.reshape(b_all, gs)
    wide = gs > 254
    half = gs // 2
    gx, gy, gz = plan.grid
    words = torch.zeros((b_all, n), dtype=torch.int64)
    seeds = torch.full((b_all,), -1, dtype=torch.int32)
    writes = torch.zeros(b_all, dtype=torch.int64)
    taken = torch.zeros((b_all, n), dtype=torch.int64)

    def balanced(member_words):
        """Bit 0 of each byte where a column of words holds g / 2 signs."""
        if not wide:
            c = sum((w >> 7) & KBYTE for w in member_words)
            return _vcmpeq(c, half, 8) & KBYTE
        lo = sum((w >> 7) & LANE for w in member_words)
        hi = sum((w >> 15) & LANE for w in member_words)
        return (_vcmpeq(lo, half, 16) & LANE) | ((_vcmpeq(hi, half, 16) & LANE) << 8)

    for z in range(gz):
        for x in range(gx):
            staged = []
            for k in range(plan.per):
                w = x * plan.per + k
                b, t = z * tg + w, w // n_groups
                rows = [spins[z, sid[z, flat[b, r] * n_temps + t]].to(torch.int64)
                        for r in range(gs)]
                staged.append((b, rows))
            for y in range(gy):
                if y == 0 and probes is not None:
                    for b, rows in staged:
                        writes[b] += 1
                        pr = probes[b].long()
                        ok = sum(r[pr] for r in rows) == 0
                        first = [int(pr[j]) for j in range(64) if ok[j]]
                        seeds[b] = first[0] if first else n
                elif y == 0:
                    for b, _ in staged:
                        writes[b] += 1
                        seeds[b] = n
                grp, i, on = _group_sites(n, y, gy)
                i0 = (4 * grp)[:, None].expand_as(i)
                f = torch.where(on[..., None], fwd[i], i0[..., None])
                live = _word(on.to(torch.int64))
                for b, rows in staged:
                    act = balanced([_word(torch.where(on, r[i] & 0xFF, 0)) for r in rows]) & live
                    st = torch.zeros(i.shape, dtype=torch.int64)
                    for dd in range(nb):
                        bond = act & balanced([_gather_word(r, f[..., dd]) for r in rows])
                        st |= ((bond[:, None] >> SHIFTS) & 1) << dd
                    words[b].index_put_((i[on],), st[on])
                    taken[b].index_put_((i[on],), ONE, accumulate=True)
    return ((words + 2**31) % 2**32 - 2**31).to(torch.int32), seeds, taken, writes


def _plans(n, d, tg, g):
    """The plan at every count of tasks a thread up to 8 that splits a
    realization's ``tg`` tasks with a thread's tasks of one temperature side
    by side."""
    blocks = -(-(-(-n // 4)) // 256)
    return [overlap.OvTablePlan(p, (tg // p, blocks, d)) for p in range(1, OV_MAX_PER + 1)
            if tg % p == 0 and (p % g == 0 or g % p == 0)]


MID_LATTICES = [
    ("3^4-tail", (3, 3, 3, 3), None, 2, 2, 3, "pm"),
    ("4d4", (4, 4, 4, 4), None, 1, 2, 4, "gauss"),
    ("1x3x3x3-self", (1, 3, 3, 3), None, 2, 4, 3, "gauss"),
    ("nine9", (4, 4, 4), SHELLS3[:9], 2, 2, 3, "pm"),
]


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,offsets,d,n_rep,n_temps,couplings", MID_LATTICES,
                         ids=[x[0] for x in MID_LATTICES])
def test_ov_mid_table_model(name, shape, offsets, d, n_rep, n_temps, couplings, wolff):
    """The model of the redesigned grey pass, at every count of tasks a
    thread, on the plain version's blue words and their labels: the grey
    words and flip bytes bitwise ``table_states_plain``'s; every (task,
    site) once; the backward words read only where an SW coin fell on a
    root with no bond of its own and a backward neighbour past it."""
    lat = _lattice(name, shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    x = _ov_inputs(lat, d, n_rep, n_temps, "cmr", wolff, couplings, 3030 + wolff)
    spins, sid, tasks, coup, temps, scal, probes, keys = x
    st, st2, fl, _ = overlap.table_states_plain(spins.clone(), sid, tasks, coup, temps, scal,
                                                probes, keys, kind="cmr", wolff=wolff,
                                                lattice=lat)
    assert st2.any() and fl.any() and not fl.all()
    parent = connected_components(fk.state_masks(st, nb), lat.shape, lat.offsets)
    fwd, bwd = (torch.from_numpy(t.astype(np.int64)) for t in (lat.fwd, lat.bwd))
    for plan in _plans(n, d, n_temps * (n_rep // 2), n_rep // 2):
        grey, flips, taken, walked = model_ov_mid_table(
            spins, sid, tasks, coup, temps, scal, keys, fwd, bwd, st, parent, plan, wolff)
        assert (taken == 1).all(), plan.per
        assert torch.equal(grey, st2), plan.per
        assert torch.equal(flips, fl), plan.per
        past = (bwd > torch.arange(n)[:, None]).any(-1)
        lonely = (st == 0) & (parent == torch.arange(n)) & past
        assert not (walked & ~lonely).any(), plan.per
        assert wolff or walked.any()


HOUDN_LATTICES = [
    ("4d4-g2", (4, 4, 4, 4), None, 1, 2, 4, 2),
    ("3^4-tail-g4", (3, 3, 3, 3), None, 2, 4, 3, 4),
    ("1x3x3x3-self-g2", (1, 3, 3, 3), None, 2, 2, 3, 2),
    ("nine9-g4", (4, 4, 4), SHELLS3[:9], 1, 8, 2, 4),
    ("3^4-g256", (3, 3, 3, 3), None, 1, 256, 1, 256),
]


@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("name,shape,offsets,d,n_rep,n_temps,g", HOUDN_LATTICES,
                         ids=[x[0] for x in HOUDN_LATTICES])
def test_houdn_bonds_table_model(name, shape, offsets, d, n_rep, n_temps, g, wolff):
    """The model of the redesigned Houdayer(N) bonds, at every count of tasks
    a thread within the staged rows' cap (``overlap.table_most``), g = 2, 4
    and 256 (the 16-bit lanes): the words and seeds bitwise
    ``table_states_plain``'s; every (task, site) once, every seed written
    once."""
    lat = _lattice(name, shape, offsets)
    n = lat.n_spins
    x = _ov_inputs(lat, d, n_rep, n_temps, "houdayer", wolff, "pm", 4040 + wolff, g=g)
    spins, sid, tasks, coup, temps, scal, probes, keys = x
    st, _, _, sd = overlap.table_states_plain(spins.clone(), sid, tasks, coup, temps, scal,
                                              probes, keys, kind="houdayer", wolff=wolff,
                                              lattice=lat)
    assert st.any()
    fwd = torch.from_numpy(lat.fwd.astype(np.int64))
    n_groups = n_rep // g
    plans = _plans(n, d, n_temps * n_groups, n_groups)
    assert plans and all(p.per <= overlap.table_most("houdn_bonds_table", g) for p in plans)
    for plan in plans:
        words, seeds, taken, writes = model_houdn_bonds_table(
            spins, sid, tasks, probes if wolff else None, fwd, plan)
        assert (taken == 1).all() and (writes == 1).all(), plan.per
        assert torch.equal(words, st), plan.per
        assert torch.equal(seeds, sd), plan.per

