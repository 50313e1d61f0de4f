"""The launch mapping and index arithmetic of ``colour_pass``
(``csrc/mega.cu``, the replica path's and the mega path's three-launch
colour pass) on the CPU, as ``tests/test_torch_sweep_index.py`` models
``sweep_2d``'s.

* ``mega.colour_plan``: ``per`` slots of one realization a CTA, ``gp``
  groups of a logical block, ``sub`` slot lanes; a lattice of 128 groups a
  slot or fewer (config 4's 8^3, config 1's 32^2) fills its CTAs with
  slots side by side.  A numpy model of the launch: every (realization,
  slot, active site) is updated exactly once, each CTA's warps reduce each
  of its slots once.
* Each site's coordinates (the multiply-shift division of the plan's
  words, then a step a site), its neighbours in the field's order (the
  vector path's bytes of the 8-byte rows and the edge byte, or the
  per-site path's wraps) and its couplings (the forward planes of the
  pre-shifted grids, each backward bond read at the neighbour) are the
  modulo ones and ``pack_coupling_grids``'; each Philox counter and word
  is ``rng.colour_uniforms``'.
* The model's passes (the kernel's order of float operations) are bitwise
  ``colour_pass_plain``, and its partials (a thread's four sites in order,
  staged by slot, each row reduced by one warp over its ``gp`` threads)
  bitwise ``mega.colour_pass_partials``, the first design's
  ``block_partials`` order; 2D and 3D, extents 2 to 64.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops import _build, mega, rng, sweep

torch.set_num_threads(1)

THREADS = 256
# a quarter of the resident threads of the card the rule is modelled for
# (the H100: 132 SMs x 2048), the least a launch keeps
# (mega._colour_plan; fk.resident_threads reads them from the card)
QUARTER = 132 * 2048 // 4

SHAPES = [(2, 2), (2, 8), (4, 6), (6, 10), (8, 16), (32, 32), (64, 48), (2, 64),
          (2, 2, 2), (2, 2, 16), (4, 6, 8), (6, 4, 10), (8, 8, 8), (4, 4, 64), (16, 16, 16)]
IDS = ["x".join(map(str, s)) for s in SHAPES]


def _div(n, m, s):
    n = np.asarray(n, np.uint64)
    q = ((n * np.uint64(m)) >> np.uint64(32)) >> np.uint64(s)
    return (n if m == 0 else q).astype(np.int64)


def model_sites(shape, colour, plan):
    """The kernel's indices for one colour pass of a system: per group g
    and site k, the active index, the site, its neighbours in the field's
    order (3D x-, x+, y-, y+, z-, z+; 2D up, down, left, right), the
    indices of their couplings in the realization's flattened grids ``[2
    n_dims, n]`` (forward planes 1, 3, 5 only), and the partner of its pair
    along the fast axis (m's second term).  Sites past the last are marked
    in ``ok``."""
    L0, L1, L2 = _build.dims3(shape)
    k3 = L2 > 1
    W, R = (L2, L1) if k3 else (L1, L0)
    n = L0 * L1 * L2
    wh, n_half = W // 2, n // 2
    plane = L1 * L2 if k3 else 0
    words = plan.words.view(np.uint32).astype(np.int64)
    groups = -(-n_half // 4)
    g = np.arange(groups)
    i0 = 4 * g
    if k3:
        x0 = _div(i0, words[2], words[3])
        rem = i0 - x0 * (L1 * wh)
        r0 = _div(rem, words[4], words[5])
        j0 = rem - r0 * wh
    else:
        x0 = np.zeros_like(i0)
        r0 = _div(i0, words[2], words[3])
        j0 = i0 - r0 * wh
    k = np.arange(4)
    out = dict(g=g, i=i0[:, None] + k, ok=i0[:, None] + k < n_half)
    Ja, Jb, Jc = n, 3 * n, 5 * n
    if W % 8 == 0:
        a = ((x0 + r0 + colour) & 1)[:, None]
        c0 = (2 * j0)[:, None]
        x0, r0 = x0[:, None], r0[:, None]
        base = x0 * plane
        rw = base + r0 * W + c0
        mw = base + np.where(r0 == 0, R - 1, r0 - 1) * W + c0
        pw = base + np.where(r0 == R - 1, 0, r0 + 1) * W + c0
        xmw = np.where(x0 == 0, L0 - 1, x0 - 1) * plane + r0 * W + c0
        xpw = np.where(x0 == L0 - 1, 0, x0 + 1) * plane + r0 * W + c0
        edge = rw - c0 + np.where(a == 1, np.where(c0 + 8 == W, 0, c0 + 8),
                                  np.where(c0 == 0, W - 1, c0 - 1))
        c = a + 2 * k
        # bytes of xw: the row shifted by a, the edge byte last (a = 1)
        xw = lambda b: np.where(a == 1, np.where(b == 7, edge, rw + 1 + b), rw + b)  # noqa: E731
        left = np.where(k == 0, np.where(a == 1, rw, edge), xw(2 * k - 1))
        right = xw(2 * k + 1)
        before = np.where(k == 0, np.where(a == 1, rw, edge), rw + c - 1)
        if k3:
            nbr = [xmw + c, xpw + c, mw + c, pw + c, left, right]
            cp = [Ja + xmw + c, Ja + rw + c, Jb + mw + c, Jb + rw + c, Jc + before, Jc + rw + c]
        else:
            nbr = [mw + c, pw + c, left, right]
            cp = [Ja + mw + c, Ja + rw + c, Jb + before, Jb + rw + c]
        out.update(site=rw + c, nbr=nbr, coup=cp, partner=np.where(a == 1, left, right))
        return out
    cols = {key: [] for key in ("site", "partner", "nbr", "coup")}
    x, r, j = x0.copy(), r0.copy(), j0.copy()
    for _ in range(4):
        col = 2 * j + ((x + r + colour) & 1)
        pb = x * plane
        idx = pb + r * W + col
        up = pb + np.where(r == 0, R - 1, r - 1) * W + col
        dn = pb + np.where(r == R - 1, 0, r + 1) * W + col
        lf = np.where(col == 0, idx + W - 1, idx - 1)
        rg = np.where(col == W - 1, idx + 1 - W, idx + 1)
        if k3:
            xm = np.where(x == 0, L0 - 1, x - 1) * plane + r * W + col
            xp = np.where(x == L0 - 1, 0, x + 1) * plane + r * W + col
            nbr = [xm, xp, up, dn, lf, rg]
            cp = [Ja + xm, Ja + idx, Jb + up, Jb + idx, Jc + lf, Jc + idx]
        else:
            nbr = [up, dn, lf, rg]
            cp = [Ja + up, Ja + idx, Jb + lf, Jb + idx]
        cols["site"].append(idx)
        cols["partner"].append(idx ^ 1)
        cols["nbr"].append(nbr)
        cols["coup"].append(cp)
        j = j + 1
        r = np.where(j == wh, r + 1, r)
        j = np.where(j == wh, 0, j)
        x = np.where(r == R, x + 1, x)
        r = np.where(r == R, 0, r)
    ok = out["ok"]
    clip = lambda v: np.where(ok, v, 0)  # noqa: E731  past the last site: unread
    out.update(site=clip(np.stack(cols["site"], 1)),
               partner=clip(np.stack(cols["partner"], 1)),
               nbr=[clip(np.stack([c[t] for c in cols["nbr"]], 1)) for t in range(len(nbr))],
               coup=[clip(np.stack([c[t] for c in cols["coup"]], 1)) for t in range(len(cp))])
    return out


def _want_coords(shape, colour, i):
    """The colour's active site i in row-major order, and its neighbours
    by modulo, in the field's order."""
    L0, L1, L2 = _build.dims3(shape)
    k3 = L2 > 1
    W = L2 if k3 else L1
    wh = W // 2
    if k3:
        x, y, j = i // (L1 * wh), (i // wh) % L1, i % wh
        z = 2 * j + ((x + y + colour) & 1)
        at = lambda a, b, c: (a % L0 * L1 + b % L1) * L2 + c % L2  # noqa: E731
        return at(x, y, z), [at(x - 1, y, z), at(x + 1, y, z), at(x, y - 1, z),
                             at(x, y + 1, z), at(x, y, z - 1), at(x, y, z + 1)]
    r, j = i // wh, i % wh
    c = 2 * j + ((r + colour) & 1)
    at = lambda a, b: a % L0 * L1 + b % L1  # noqa: E731
    return at(r, c), [at(r - 1, c), at(r + 1, c), at(r, c - 1), at(r, c + 1)]


@pytest.mark.parametrize("colour", [0, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sites_neighbours_and_couplings_are_the_modulo_ones(shape, colour):
    n = int(np.prod(shape))
    plan = mega.colour_plan(_build.dims3(shape), 1, 4, QUARTER)
    m = model_sites(shape, colour, plan)
    ok = m["ok"]
    i = m["i"][ok]
    np.testing.assert_array_equal(np.sort(i), np.arange(n // 2))  # every site once
    site, nbr = _want_coords(shape, colour, i)
    np.testing.assert_array_equal(m["site"][ok], site)
    for t, want in enumerate(nbr):
        np.testing.assert_array_equal(m["nbr"][t][ok], want, err_msg=f"neighbour {t}")
    np.testing.assert_array_equal(m["partner"][ok], site ^ 1)
    # the couplings: each read of a forward plane is the pre-shifted grid's
    # value at the site
    nd = len(shape)
    coup = torch.from_numpy(np.random.default_rng(3).standard_normal((1, n, nd))
                            .astype(np.float32))
    jg = sweep.pack_coupling_grids(coup, shape)[0].reshape(2 * nd, n)
    flat = jg.reshape(-1)
    for t in range(2 * nd):
        got = flat[torch.from_numpy(m["coup"][t][ok])]
        assert torch.equal(got, jg[t][torch.from_numpy(site)]), t
        # only the forward planes are read
        assert ((m["coup"][t][ok] // n) % 2 == 1).all()


@pytest.mark.parametrize("shape,d,n_slots", [
    ((8, 8, 8), 8, 96), ((16, 16, 16), 8, 96), ((32, 32), 1, 32), ((256, 256), 1, 24),
    ((6, 4, 10), 1, 6), ((4, 4, 10), 2, 9), ((2, 2, 2), 2, 6), ((64, 48), 2, 10),
    ((64, 64), 128, 16),
])
def test_launch_updates_every_slot_and_site_once(shape, d, n_slots):
    """The grid (blocks, n_slots / per, d) of gp x sub threads: each
    (realization, slot, group) once, by the thread of its group in its
    slot's lane; each CTA's warps reduce each of its slots once; a lattice
    of 128 groups a slot or fewer fills its CTAs (where the slots divide
    so), a larger one takes full blocks of 256 groups."""
    dims = _build.dims3(shape)
    plan = mega.colour_plan(dims, d, n_slots, QUARTER)
    groups = -(-int(np.prod(shape)) // 8)
    blocks = _build_blocks(shape)
    assert n_slots % plan.per == 0 and 1 <= plan.per <= 8
    assert plan.sub == min(256 // plan.gp, plan.per) and plan.gp & (plan.gp - 1) == 0
    if groups > 128:
        assert plan.gp == 256 and blocks == -(-groups // 256)
    else:
        assert blocks == 1 and plan.gp == max(32, 1 << (groups - 1).bit_length())
    seen = np.zeros((d, n_slots, blocks * 256), np.int64)
    threads = plan.gp * plan.sub
    t = np.arange(threads)
    gl, lane_slot = t & (plan.gp - 1), t >> int(np.log2(plan.gp))
    for bx in range(blocks):
        for by in range(n_slots // plan.per):
            for q0 in range(plan.sub):
                for q in range(q0, plan.per, plan.sub):
                    sel = lane_slot == q0
                    np.add.at(seen, (slice(None), by * plan.per + q, bx * 256 + gl[sel]), 1)
            warps = -(-threads // 32)
            reduced = [q for w in range(warps) for q in range(w, plan.per, warps)]
            assert sorted(reduced) == list(range(plan.per))
    np.testing.assert_array_equal(seen[..., :groups], 1)
    assert (seen[..., groups:] <= 1).all()


def _build_blocks(shape):
    """``colour_pass_blocks`` of the shape (csrc/mega.cuh)."""
    L0, L1, L2 = _build.dims3(shape)
    h, w = (L0 * L1, L2) if L2 > 1 else (L0, L1)
    groups = -(-(h * (w // 2)) // 4)
    return -(-groups // 256)


@pytest.mark.parametrize("shape,d,n_slots", [((6, 10), 2, 3), ((8, 16), 1, 4),
                                             ((4, 6, 8), 2, 3), ((6, 4, 10), 1, 2)],
                         ids=["6x10", "8x16", "4x6x8", "6x4x10"])
def test_philox_counter_and_word_are_colour_uniforms(shape, d, n_slots):
    words = torch.from_numpy(np.random.default_rng(5).integers(
        -2**31, 2**31, (d, 2)).astype(np.int32))
    k = words.to(torch.int64) & rng.MASK32
    plan = mega.colour_plan(_build.dims3(shape), d, n_slots, QUARTER)
    for colour in (0, 1):
        want = rng.colour_uniforms(words, n_slots, colour, shape).reshape(d, n_slots, -1)
        m = model_sites(shape, colour, plan)
        ok = torch.from_numpy(m["ok"])
        g = torch.from_numpy(np.repeat(m["g"][:, None], 4, 1))[ok]
        site = torch.from_numpy(m["site"])[ok]
        word = torch.arange(4).expand(ok.shape)[ok]
        for dz in range(d):
            for slot in range(n_slots):
                out = rng.philox4x32(k[dz, 0], k[dz, 1], torch.tensor(slot),
                                     torch.tensor(colour), g, torch.tensor(0))
                u = rng.uniform24(torch.stack(out, -1).gather(-1, word[:, None])[:, 0])
                assert torch.equal(u, want[dz, slot, site])


def _flip_probability(x, gibbs):
    """mega.cuh ``flip_probability``, x = (-s field) / (T/2)."""
    if gibbs:
        return 1.0 / (1.0 + torch.exp(-x))
    return sweep._KEEP * torch.exp(torch.clamp(x, max=0.0))


def model_pass(spins, jgrids, sid, temps, words, colour, *, gibbs, plan):
    """One colour pass of the model (in place) in the kernel's order of
    float operations; for colour 1 the partials as its CTAs stage and
    reduce them: ``[d, n_systems, blocks]``."""
    d, n_slots, *shape = spins.shape
    shape = tuple(shape)
    nd = len(shape)
    m = model_sites(shape, colour, plan)
    ok = torch.from_numpy(m["ok"])
    idx = {key: torch.from_numpy(m[key]) for key in ("site", "partner")}
    nbr = [torch.from_numpy(v) for v in m["nbr"]]
    cp = [torch.from_numpy(v) for v in m["coup"]]
    n_grp = ok.shape[0]
    blocks = _build_blocks(shape)
    flat_j = jgrids.reshape(d, -1)
    s = spins.reshape(d, n_slots, -1)
    u = rng.colour_uniforms(words, n_slots, colour, shape).reshape(d, n_slots, -1)
    terms = torch.zeros((d, n_slots, blocks * THREADS, 4))
    mterms = torch.zeros((d, n_slots, blocks * THREADS, 4), dtype=torch.int32)
    for slot in range(n_slots):
        sys_ = sid[:, slot].long()
        di = torch.arange(d)
        old = s[di, sys_].to(torch.float32)  # [d, n]
        sn = [old[:, v] for v in nbr]
        jn = [flat_j[:, v] for v in cp]
        field = sn[0] * jn[0] + sn[1] * jn[1]
        for t in range(2, 2 * nd):
            field = field + sn[t] * jn[t]
        sv0 = old[:, idx["site"]]
        inv = (1.0 / (0.5 * temps[slot]))
        p = _flip_probability((-sv0 * field) * inv, gibbs)
        flip = (u[:, slot][:, idx["site"]] < p) & ok
        sv = torch.where(flip, -sv0, sv0)
        new = s[di, sys_].clone()
        new.scatter_(1, idx["site"][ok].expand(d, -1), sv[:, ok].to(torch.int8))
        s[di, sys_] = new
        terms[:, slot, :n_grp] = torch.where(ok, sv * field, 0.0)
        mterms[:, slot, :n_grp] = torch.where(
            ok, sv.to(torch.int32) + old[:, idx["partner"]].to(torch.int32), 0)
    if colour != 1:
        return None
    parts = []
    for t in (terms, mterms):
        acc = torch.zeros_like(t[..., 0])  # e_acc from 0, a site at a time
        for k in range(4):
            acc = acc + t[..., k]
        acc = acc.reshape(d, n_slots, blocks, THREADS)
        # the CTA's shared row of a slot: its gp groups, read as 0 beyond
        acc[..., plan.gp:] = 0
        lane = torch.arange(32)
        x = lambda o: acc[..., lane + o]  # noqa: E731
        v = ((x(0) + x(128)) + (x(64) + x(192))) + ((x(32) + x(160)) + (x(96) + x(224)))
        off = 16
        while off:
            v = v[..., :off] + v[..., off:2 * off]
            off //= 2
        by_slot = v[..., 0]
        out = torch.empty_like(by_slot)
        out[torch.arange(d)[:, None], sid.long()] = by_slot  # rows by system
        parts.append(out)
    return tuple(parts)


@pytest.mark.parametrize("couplings", ["pm", "gauss"])
@pytest.mark.parametrize("gibbs", [False, True], ids=["metropolis", "gibbs"])
@pytest.mark.parametrize("shape,d,n_rep,n_temps", [
    ((2, 2), 2, 2, 2), ((6, 10), 1, 2, 3), ((8, 16), 2, 2, 2), ((64, 48), 1, 2, 2),
    ((2, 2, 2), 1, 2, 3), ((4, 6, 8), 2, 2, 2), ((6, 4, 10), 1, 2, 3), ((8, 8, 8), 2, 2, 3),
    ((2, 2, 16), 1, 2, 2),
], ids=["2x2", "6x10", "8x16", "64x48", "2x2x2", "4x6x8", "6x4x10", "8x8x8", "2x2x16"])
def test_model_is_bitwise_plain(shape, d, n_rep, n_temps, gibbs, couplings):
    """Two passes of the model from random spins at shuffled slots: spins
    bitwise ``colour_pass_plain``, the measuring pass's partials bitwise
    ``colour_pass_partials`` (the first design's ``block_partials`` order),
    whose row sums are ``colour_pass_plain``'s m exactly (and e exactly on
    +-1 couplings)."""
    g = np.random.default_rng(7 + n_temps + len(shape))
    n, nd = int(np.prod(shape)), len(shape)
    s = n_rep * n_temps
    coup = torch.from_numpy((g.choice([-1.0, 1.0], (d, n, nd)) if couplings == "pm"
                             else g.standard_normal((d, n, nd))).astype(np.float32))
    jg = sweep.pack_coupling_grids(coup, shape).contiguous()
    spins = torch.from_numpy(g.choice([-1, 1], (d, s, *shape)).astype(np.int8))
    sid = torch.from_numpy(np.stack([g.permutation(s) for _ in range(d)]).astype(np.int32))
    temps = torch.from_numpy(g.uniform(0.6, 2.5, s).astype(np.float32))
    words = torch.from_numpy(g.integers(-2**31, 2**31, (d, 2)).astype(np.int32))
    plan = mega.colour_plan(_build.dims3(shape), d, s, QUARTER)
    a, b = spins.clone(), spins.clone()
    for colour in (0, 1):
        c = b.clone()
        got = model_pass(a, jg, sid, temps, words, colour, gibbs=gibbs, plan=plan)
        pp = mega.colour_pass_plain(b, jg, sid, temps, words, colour, gibbs=gibbs)
        assert torch.equal(a, b), colour
        if colour == 1:
            want = mega.colour_pass_partials(c, jg, sid, temps, words, gibbs=gibbs)
            assert torch.equal(c, b)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert torch.equal(want[1].sum(-1), pp[1][..., 0])
            if couplings == "pm":
                assert torch.equal(want[0].sum(-1), pp[0][..., 0])
        words = words * 3 + 1
    assert not torch.equal(a, spins)


@pytest.mark.parametrize("dims,d,n_slots,per,gp,sub", [
    ((8, 8, 8), 8, 96, 4, 64, 4),        # config 4: four slots fill each CTA
    ((16, 16, 16), 8, 96, 4, 256, 1),    # config 5: four slots a thread
    ((32, 32, 1), 1, 32, 2, 128, 2),     # config 1: two slots fill each CTA
    ((256, 256, 1), 1, 24, 2, 256, 1),   # the flagship shape (three launches)
    ((64, 64, 1), 128, 16, 8, 256, 1),
    ((4, 4, 10), 2, 9, 3, 32, 3),        # the slots divide no fuller CTA
    ((2, 2, 2), 1, 7, 7, 32, 7),
])
def test_colour_plan_rule(dims, d, n_slots, per, gp, sub):
    plan = mega.colour_plan(dims, d, n_slots, QUARTER)
    assert (plan.per, plan.gp, plan.sub) == (per, gp, sub)
    L0, L1, L2 = dims
    w = plan.words.view(np.uint32).astype(np.int64)
    assert list(w[:2]) == [per, gp]
    divs = (L1 * L2 // 2, L2 // 2) if L2 > 1 else (L1 // 2, 1)
    q = np.arange(L0 * L1 * L2 // 2)
    for k, dv in enumerate(divs):
        np.testing.assert_array_equal(_div(q, w[2 + 2 * k], w[3 + 2 * k]), q // dv)
