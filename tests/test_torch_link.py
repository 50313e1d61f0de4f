"""Host-side rules and index models of ``pt_step``'s reduction and of the
labelling ``fk_link`` (``csrc/mega.cu``, ``csrc/fk.cu``), on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
Here ``ops/mega.py`` ``ordered_partial_sum`` is held against a numpy
mirror of the kernel's lanes, tree and shuffles on ragged rows; the choice
of the labelling's form and tiles is checked per lattice; and a sequential
model of the three labelling passes, built from the kernels' own index
arithmetic (tile boxes, in-tile steps, the border's face walk), gives
labels bitwise ``fk_link_plain`` on small lattices cut into small tiles.
"""

import numpy as np
import pytest
import torch

from peapods_tpu_torch.ops import _build, fk, mega

torch.set_num_threads(1)


# ------------------------------------------------ pt_step's reduction order


def _kernel_order_sum(x, split):
    """numpy mirror of ``share_sum`` over one row ``x`` (f32): ``split``
    CTAs, a warp a share, lane ``l`` holding lanes ``l + 32 j``."""
    f32 = np.float32
    n, P = len(x), 256 * split

    def share(vals, m, first, stride):
        lane_vals = []
        for lane in range(32):
            a = [f32(0)] * 8
            o = first + lane
            while o < m:
                for j in range(8):
                    i = o + 32 * j
                    a[j] = f32(a[j] + (vals[i] if i < m else f32(0)))
                o += stride
            lane_vals.append(f32(f32(f32(a[0] + a[4]) + f32(a[2] + a[6]))
                                 + f32(f32(a[1] + a[5]) + f32(a[3] + a[7]))))
        off = 16
        while off:  # __shfl_down_sync: lanes past 31 keep their own value
            lane_vals = [f32(v + (lane_vals[k + off] if k + off < 32 else v))
                         for k, v in enumerate(lane_vals)]
            off //= 2
        return lane_vals[0]

    sums = [share(x, n, 256 * c, P) for c in range(split)]
    return sums[0] if split == 1 else share(np.array(sums, f32), split, 0, 256)


@pytest.mark.parametrize("n", [1, 2, 255, 257, 65536])
def test_ordered_partial_sum_is_the_kernels_order(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((3, n)) * 1e3).astype(np.float32)
    split = mega.pt_split(n)
    got = mega.ordered_partial_sum(torch.from_numpy(x), split)
    want = np.array([_kernel_order_sum(row, split) for row in x], np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the shortcut of one partial equals the full tree
    if n == 1:
        full = mega.ordered_partial_sum(torch.from_numpy(np.pad(x, ((0, 0), (0, 1)))), 1)
        np.testing.assert_array_equal(got.numpy(), full.numpy())


@pytest.mark.parametrize("n", [1, 2, 16, 31, 32])
def test_short_rows_thread_tree_is_the_kernels_order(n):
    """pt_step gives a row of at most 32 partials one thread, which pairs
    0 + x[l] (0 past the row) as the halving tree of 32 values: the
    warp's order."""
    rng = np.random.default_rng(100 + n)
    x = (rng.standard_normal((4, n)) * 1e3).astype(np.float32)
    x[0, 0] = -0.0
    v = np.zeros((4, 32), np.float32)
    v[:, :n] = np.float32(0) + x
    h = 16
    while h:
        v[:, :h] = v[:, :h] + v[:, h:2 * h]
        h //= 2
    got = mega.ordered_partial_sum(torch.from_numpy(x), mega.pt_split(n))
    np.testing.assert_array_equal(got.numpy(), v[:, 0])
    np.testing.assert_array_equal(got.numpy(), [_kernel_order_sum(r, 1) for r in x])


def test_pt_split_by_row_length():
    assert [mega.pt_split(n) for n in (1, 2, 32, 256, 257, 2048, 65536, 10 ** 6)] == [
        1, 1, 1, 1, 2, 8, 256, 256]


def test_pt_step_plain_adds_in_the_kernels_order():
    """The plain pt_step's rows are the ordered sums of each slot's
    system's partials (not torch.sum's order: they differ on these)."""
    rng = np.random.default_rng(3)
    d, s, nb = 2, 3, 700
    e = torch.from_numpy((rng.standard_normal((d, s, nb)) * 1e4).astype(np.float32))
    m = torch.from_numpy(rng.integers(-9, 9, (d, s, nb)).astype(np.int32))
    sid = torch.tensor([[2, 0, 1], [1, 2, 0]], dtype=torch.int32)
    e_row = torch.empty((d, s))
    m_row = torch.empty((d, s), dtype=torch.int32)
    i32 = dict(dtype=torch.int32)
    mega.pt_step_plain(e, m, e_row, m_row, sid, torch.zeros((d, s - 1), **i32),
                       torch.zeros((d, s - 1), **i32), torch.zeros((d, s), **i32),
                       torch.zeros((d, s), **i32), torch.ones(s), None,
                       torch.empty((d, s)), do_pt=False, pt_full=False, parity=0,
                       hot_slot=0, cold_slot=s - 1, n_spins=nb)
    by_slot = e.gather(1, sid.long()[..., None].expand(d, s, nb))
    want = np.array([[_kernel_order_sum(r, mega.pt_split(nb)) for r in row]
                     for row in by_slot.numpy()], np.float32) / np.float32(nb)
    np.testing.assert_array_equal(e_row.numpy(), want)
    assert torch.equal(m_row, m.gather(1, sid.long()[..., None].expand(d, s, nb)).sum(
        -1, dtype=torch.int32))


# ------------------------------------------------ fk_link's form and tiles


@pytest.mark.parametrize("shape,b,tile,threads,tiled", [
    ((64, 64), 2048, (64, 64, 1), 512, False),        # the harness
    ((256, 256), 1, (16, 32, 1), 1024, True),         # config 3, 256^2 observe
    ((32, 32, 32), 16, (4, 4, 32), 512, True),        # 32^3 x 16
    ((32, 32), 8, (32, 32, 1), 1024, False),          # config 2 (triangular)
    ((8, 8, 8), 256, (8, 8, 8), 1024, False),         # config 4's overlap graphs
    ((16, 16, 16), 384, (16, 16, 16), 1024, False),   # config 5's
    ((64, 64), 32, (64, 64, 1), 1024, False),         # the 64^2 overlap observe
    ((4096, 4096), 4, (64, 128, 1), 512, True),       # the unsharded 4096^2 run
    ((8, 1024), 4096, (8, 1024, 1), 1024, False),     # one row of threads a line
    ((4, 2048), 4, (4, 32, 1), 1024, True),           # rows too long for one CTA
])
def test_link_plan_per_lattice(shape, b, tile, threads, tiled):
    plan = fk.link_plan(_build.dims3(shape), b)
    assert plan == fk.LinkPlan(tile, threads, tiled)
    assert np.prod(plan.tile) <= fk.LINK_TILE_SITES
    fast = plan.tile[2] if len(shape) == 3 else plan.tile[1]
    assert fast <= fk.LINK_THREADS
    names = ["fk_link", "fk_link_border", "fk_link_flatten"] if tiled else ["fk_link"]
    assert fk.link_launches(shape, b) == dict.fromkeys(names, 1)


def test_link_flatten_plain_points_every_site_at_its_root():
    parent = torch.tensor([[0, 0, 1, 2, 2, 5, 5, 6]], dtype=torch.int32)
    assert fk.fk_link_flatten_plain(parent).tolist() == [[0, 0, 0, 0, 0, 5, 5, 5]]


def test_link_tiles_fill_the_card_or_reach_the_smallest_tile():
    for dims, b in (((256, 256, 1), 1), ((512, 512, 1), 2), ((32, 32, 32), 16),
                    ((24, 24, 24), 3), ((4096, 4096, 1), 4)):
        plan = fk.link_plan(dims, b)
        ctas = fk._n_tiles(dims, plan.tile) * b
        assert ctas >= fk.LINK_MIN_CTAS or np.prod(plan.tile) <= fk.LINK_MIN_TILE


# ------------------------------------------------ a model of the link kernels


class _Model:
    """The link kernels' index arithmetic (csrc/fk.cu link_box,
    link_coords, link_site_of, link_step, the border's faces), run
    sequentially."""

    def __init__(self, dims, tile, tri, threads=1024):
        self.L, self.t, self.tri, self.threads = dims, tile, tri, threads
        self.nt = [-(-a // b) for a, b in zip(dims, tile)]
        self.ndir = 3 if (tri or dims[2] > 1) else 2
        self.fast = 2 if dims[2] > 1 else 1

    def off(self, d, k):
        if self.tri and d == 2:
            return (1, -1, 0)[k]
        return int(k == d)

    def box(self, tile):
        i2 = tile % self.nt[2]
        tile //= self.nt[2]
        i = (tile // self.nt[1], tile % self.nt[1], i2)
        o = [i[k] * self.t[k] for k in range(3)]
        return o, [min(self.t[k], self.L[k] - o[k]) for k in range(3)]

    def coords(self, e, s, x):
        return (s // e[1], s % e[1], x) if self.fast == 2 else (s, x, 0)

    def site(self, o, c, d=-1):
        i = 0
        for k in range(3):
            x = (o[k] + c[k] + (self.off(d, k) if d >= 0 else 0)) % self.L[k]
            i = i * self.L[k] + x
        return i

    def step(self, e, c, d):
        loc = 0
        for k in range(3):
            x = c[k] + self.off(d, k)
            if self.nt[k] == 1:
                x %= e[k]
            if not 0 <= x < e[k]:
                return -1
            loc = loc * e[k] + x
        return loc

    def faces(self, e):
        f0 = e[1] * e[2] if self.nt[0] > 1 else 0
        f1 = e[0] * e[2] if self.nt[1] > 1 else 0
        f2 = e[0] * e[1] if self.nt[2] > 1 else 0
        f3 = e[0] if self.tri and self.nt[1] > 1 else 0
        for q in range(f0 + f1 + f2 + f3):
            r = q
            if r < f0:
                yield (e[0] - 1, r // e[2], r % e[2])
                continue
            r -= f0
            if r < f1:
                yield (r // e[2], e[1] - 1, r % e[2])
                continue
            r -= f1
            if r < f2:
                yield (r // e[1], r % e[1], e[2] - 1)
                continue
            yield (r - f2, 0, 0)

    def link(self, bonds, parent, tile, g0):
        """fk_link's CTA (tile, graph g0): the threads' layout (blockDim
        (t_fast, min(threads / t_fast, the tile's lines))), the ballot's
        runs, the unions in the box, one parent write a site."""
        o, e = self.box(tile)
        ef, bx = e[self.fast], self.t[self.fast]
        by = min(self.threads // bx, self.t[0] * (self.t[1] if self.fast == 2 else 1))
        lines = e[0] * (e[1] if self.fast == 2 else 1)
        n_g = 1
        per, n_slow = lines * ef, lines * n_g
        S = np.zeros(n_slow * ef, np.int64)
        for s in range(n_slow):
            k = s // lines
            for x in range(ef):
                i = self.site(o, self.coords(e, s - k * lines, x))
                S[s * ef + x] = sum(int(bonds[g0 + k, i, d]) << d for d in range(self.ndir))
        P = np.full(n_slow * ef, -1, np.int64)
        iters = -(-n_slow // by)
        lane_of = lambda y, x: (y * bx + x) % 32  # noqa: E731
        for it in range(iters):  # (1) the runs along the fast axis, warp by warp
            run = {}
            for y in range(by):
                for x in range(bx):
                    s = y + it * by
                    on = s < n_slow and x < ef
                    run[y * bx + x] = (on, on and bool((S[s * ef + x] >> self.fast) & 1)
                                       and x + 1 < ef, s * ef + x)
            for tid, (on, _, l) in run.items():
                if not on:
                    continue
                first = tid
                while first % 32 and run.get(first - 1, (0, False, 0))[1]:
                    first -= 1
                P[l] = l - (tid - first)

        def root(x):
            while P[x] != x:
                x = P[x]
            return x
        for it in range(iters):  # (2) the other bonds in the box
            for y in range(by):
                for x in range(min(bx, ef)):
                    s = y + it * by
                    if s >= n_slow:
                        continue
                    k, l = s // lines, s * ef + x
                    c = self.coords(e, s - k * lines, x)
                    for d in range(self.ndir):
                        if not (S[l] >> d) & 1:
                            continue
                        if d == self.fast and x + 1 < ef and lane_of(y, x) != 31:
                            continue
                        j = self.step(e, c, d)
                        if j >= 0:
                            a, b = root(l), root(k * per + j)
                            P[max(a, b)] = min(a, b)
        for s in range(n_slow):  # (3) the parents
            k = s // lines
            for x in range(ef):
                r = root(s * ef + x) - k * per
                parent[g0 + k, self.site(o, self.coords(e, s - k * lines, x))] = self.site(
                    o, self.coords(e, r // ef, r % ef))

    def link_all(self, bonds):
        """bool [B, n, ndir] bonds -> the link's parents [B, n]."""
        b, n = bonds.shape[:2]
        parent = np.full((b, n), -1, np.int64)
        for g0 in range(b):
            for tile in range(int(np.prod(self.nt))):
                self.link(bonds, parent, tile, g0)
        assert (parent >= 0).all(), "a site no CTA wrote"
        return parent

    def label(self, bonds):
        """bool [B, n, ndir] bonds -> int labels [B, n], the passes in turn."""
        b, n = bonds.shape[:2]
        parent = self.link_all(bonds)
        if all(nt == 1 for nt in self.nt):
            return parent
        for g in range(b):
            P = parent[g]

            def groot(x):
                while P[x] != x:
                    x = P[x]
                return x
            for tile in range(int(np.prod(self.nt))):  # fk_link_border
                o, e = self.box(tile)
                for c in self.faces(e):
                    i = self.site(o, c)
                    for d in range(self.ndir):
                        if bonds[g, i, d] and self.step(e, c, d) < 0:
                            a, b_ = groot(i), groot(self.site(o, c, d))
                            P[max(a, b_)] = min(a, b_)
            parent[g] = [groot(i) for i in range(n)]  # fk_link_flatten
        return parent


@pytest.mark.parametrize("shape,tile,tri", [
    ((12, 20), (4, 8, 1), False), ((12, 20), (12, 20, 1), False),
    ((10, 12), (4, 5, 1), True), ((9, 7), (9, 3, 1), True),
    ((8, 40), (3, 32, 1), False), ((6, 6, 8), (2, 4, 4), False),
    ((5, 6, 4), (5, 6, 4), False), ((4, 6, 6), (3, 6, 2), False),
    ((64, 48), (64, 48, 1), False), ((20, 48), (20, 48, 1), False),
])
@pytest.mark.parametrize("density", [0.0, 0.6, 1.0])
def test_link_model_labels_are_the_plain_labels(shape, tile, tri, density):
    """Every bond is united by the tile pass or the border pass, and every
    parent ends at its component's minimum site: whole graphs (one with
    more lines than a CTA has rows of threads), ragged tiles, tiles that
    span an axis, the triangular diagonal."""
    rng = np.random.default_rng(len(shape) + int(10 * density) + tri)
    dims = _build.dims3(shape)
    model = _Model(dims, tile, tri, threads=512 if shape == (20, 48) else 1024)
    b = 4
    bonds = rng.random((b, int(np.prod(shape)), model.ndir)) < density
    want = fk.fk_link_plain(torch.from_numpy(bonds), tuple(shape))
    got = model.label(bonds)
    np.testing.assert_array_equal(got, want.reshape(b, -1).numpy())
    # the link alone: each site's tile-component minimum, fk_link_tiles_plain
    tiles = fk.fk_link_tiles_plain(torch.from_numpy(bonds), tuple(shape), tile)
    np.testing.assert_array_equal(model.link_all(bonds), tiles.numpy())
    assert (got[np.arange(b)[:, None], got] == got).all()
    assert (got <= np.arange(got.shape[1])).all()
