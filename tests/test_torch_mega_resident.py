"""The mega path's resident kernel on the CPU: its partition, its couplings,
its shape rule, and the link-bond count of the replica results.

``csrc/mega_resident.cu`` runs only on the card (``tests/test_torch_cuda.py``
holds it bitwise against the three launches a sweep and the plain chunk).
Here ``ops/mega.py`` ``resident_partition`` -- the plain mirror of how the
kernel splits a system over a cluster of CTAs -- is held against
``colour_pass``'s mapping of colour sites to (block, group, word), a numpy
model of the kernel's staged couplings against the four pre-shifted grids,
and ``resident_plan`` against a model of a 132-SM card.
"""

import numpy as np
import pytest
import torch

from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu_torch.engine.records import link_bonds
from peapods_tpu_torch.ops import mega
from peapods_tpu_torch.ops.lattice import Lattice
from peapods_tpu_torch.ops.sweep import pack_coupling_grids

torch.set_num_threads(1)

H100_SMEM_BLOCK = 232_448  # bytes a block may opt in to
H100_SMEM_SM = 233_472  # bytes an SM holds (1 KB of it reserved per block)


def h100_clusters(cluster, threads, smem):
    """A model of cudaOccupancyMaxActiveClusters on a 132-SM card: CTAs an SM
    holds by shared memory and threads, then whole clusters."""
    per_sm = min(2048 // threads, H100_SMEM_SM // (smem + 1024))
    return 132 * per_sm // cluster


# (h, w, cluster, threads): the flagship's layout, and three others
PARTITIONS = [(256, 256, 4, 1024), (128, 256, 2, 1024), (64, 64, 1, 512),
              (512, 512, 8, 1024)]


@pytest.mark.parametrize("h,w,cluster,threads", PARTITIONS,
                         ids=[f"{h}x{w}-c{c}" for h, w, c, _ in PARTITIONS])
def test_partition_covers_each_site_once_as_colour_pass_does(h, w, cluster, threads):
    part = mega.resident_partition(h, w, cluster, threads)
    n_half = h * w // 2
    i = torch.arange(n_half)
    # colour_pass: thread g of block g // 256 owns colour sites 4g .. 4g + 3
    assert torch.equal(part["group"], i // 4)
    assert torch.equal(part["word"], i % 4)
    assert torch.equal(part["block"], i // 4 // mega.REDUCE_LANES)
    # a CTA holds whole rows, and whole logical blocks of each colour
    rows = h // cluster
    assert torch.equal(part["rank"], part["row"] // rows)
    per_block = torch.zeros(n_half // mega.BLOCK_SITES, cluster, dtype=torch.int64)
    per_block.index_put_((part["block"], part["rank"]), torch.ones(n_half, dtype=torch.int64),
                         accumulate=True)
    assert ((per_block > 0).sum(1) == 1).all()
    # every (CTA, thread, turn, word) updates one site of a colour
    key = ((part["rank"] * threads + part["thread"]) * (part["step"].max() + 1)
           + part["step"]) * 4 + part["word"]
    assert key.unique().numel() == n_half
    assert int(part["thread"].max()) < threads
    # the two colours' columns tile every row
    for c in (0, 1):
        col = part["col"][c]
        assert torch.equal((part["row"] + col) % 2, torch.full_like(col, c))
    sites = torch.cat([part["row"] * w + part["col"][c] for c in (0, 1)])
    assert torch.equal(sites.sort().values, torch.arange(h * w))


def staged_couplings(grids, rows, rank):
    """A model of what CTA ``rank`` of ``mega_resident`` stages from one
    system's pre-shifted grids (ju, jd, jl, jr) ``[4, h, w]``: the down
    couplings of rows ``r0 - 1 .. r0 + rows - 1`` and the right couplings of
    its rows, each by colour, ``[2, n, w / 2]``."""
    h, w = grids.shape[1:]
    r0 = rank * rows
    j = np.arange(w // 2)

    def by_colour(grid, first, n):
        r = (first + np.arange(n)) % h
        return np.stack([grid[r[:, None], 2 * j + ((r[:, None] + c) & 1)] for c in (0, 1)])

    return by_colour(grids[1], r0 - 1, rows + 1), by_colour(grids[3], r0, rows)


@pytest.mark.parametrize("h,w,cluster", [(64, 64, 4), (32, 128, 2), (16, 8, 8)])
def test_staged_couplings_give_the_four_grids(h, w, cluster):
    """The kernel's indices into its staged down / right couplings (up:
    the other colour's down row above, left: the other colour's right
    coupling one column back) read every site's ju, jd, jl, jr."""
    rng = np.random.default_rng(h + w + cluster)
    coup = torch.from_numpy(rng.standard_normal((h * w, 2)).astype(np.float32))
    grids = pack_coupling_grids(coup, (h, w)).numpy()
    rows, wh = h // cluster, w // 2
    for rank in range(cluster):
        down, right = staged_couplings(grids, rows, rank)
        for c in (0, 1):
            for rl in range(rows):
                r = rank * rows + rl
                p = (r + c) & 1
                col = 2 * np.arange(wh) + p
                j = np.arange(wh)
                np.testing.assert_array_equal(down[1 - c, rl, j], grids[0, r, col])
                np.testing.assert_array_equal(down[c, rl + 1, j], grids[1, r, col])
                np.testing.assert_array_equal(right[1 - c, rl, (j - 1 + p) % wh],
                                              grids[2, r, col])
                np.testing.assert_array_equal(right[c, rl, j], grids[3, r, col])


def test_rule_takes_the_flagship():
    plan = mega.resident_plan(256, 256, 1, 24, H100_SMEM_BLOCK, h100_clusters)
    assert plan == mega.ResidentPlan(4, 64, 1024, mega.resident_smem(256, 256, 4, 24))
    assert plan.smem <= H100_SMEM_BLOCK
    assert 1 * 24 * plan.cluster <= 132  # one CTA an SM


@pytest.mark.parametrize("h,w,d,n_slots", [
    (16, 48, 2, 4),  # 24 colour sites a row: a logical block straddles CTAs at any cluster
    (256, 264, 1, 24),  # 132 colour sites a row: the same
    (256, 256, 2, 24),  # 48 clusters of 4 (or of 8 at two CTAs an SM): over 132 SMs
    (512, 512, 1, 24),  # 32 KB of spins and 256 KB of couplings a CTA even in 8
    (6, 10, 1, 3),  # a thread's 4 sites in no 8-byte word
], ids=["straddle-48", "straddle-264", "too-many-clusters", "too-large", "w-not-8"])
def test_rule_refuses(h, w, d, n_slots):
    assert mega.resident_plan(h, w, d, n_slots, H100_SMEM_BLOCK, h100_clusters) is None


def test_rule_is_the_smallest_cluster_that_fits():
    """A lattice one CTA holds takes a cluster of one; rows whose colour
    sites are no whole blocks push the cluster up, the shared memory too."""
    assert mega.resident_plan(64, 64, 3, 24, H100_SMEM_BLOCK, h100_clusters).cluster == 1
    assert mega.resident_plan(128, 256, 1, 24, H100_SMEM_BLOCK, h100_clusters).cluster == 2
    assert mega.resident_plan(256, 512, 1, 8, H100_SMEM_BLOCK, h100_clusters).cluster == 8
    # a card that holds fewer clusters refuses what it cannot run at once
    assert mega.resident_plan(256, 256, 1, 24, H100_SMEM_BLOCK, lambda c, t, s: 23) is None


def test_mega_chunk_on_cpu_is_plain_and_launches_nothing():
    rng = np.random.default_rng(3)
    h, w, d, n_temps, n = 8, 16, 1, 3, 4
    spins = torch.from_numpy(rng.choice([-1, 1], size=(d, n_temps, h, w)).astype(np.int8))
    jg = pack_coupling_grids(torch.ones((d, h * w, 2)), (h, w))
    sid = torch.tensor([[2, 0, 1]], dtype=torch.int32)
    i32 = dict(dtype=torch.int32)
    args = [jg, torch.tensor([1.8, 2.3, 3.2]), sid, torch.zeros((d, 2), **i32),
            torch.zeros((d, 2), **i32), torch.zeros((d, 3), **i32), torch.zeros((d, 3), **i32),
            torch.from_numpy(rng.integers(-2**31, 2**31, (n, d, 2)).astype(np.int32)),
            torch.from_numpy(rng.integers(-2**31, 2**31, (n, d, 2)).astype(np.int32))]
    kw = dict(sweep_base=0, parity=0, gibbs=False, pt_interval=1, pt_full=True,
              hot_slot=2, cold_slot=0)
    a, b = spins.clone(), spins.clone()
    ca = [x.clone() for x in args]
    cb = [x.clone() for x in args]
    mega.reset_launches()
    out_a = mega.mega_chunk(a, *ca, **kw)
    out_b = mega.mega_chunk_plain(b, *cb, **kw)
    assert mega.LAUNCHES == {"colour_pass": 0, "pt_step": 0, "mega_resident": 0}
    assert torch.equal(a, b) and out_a[2] == out_b[2] == 0  # four full-ladder events
    for x, y in zip(out_a[:2] + tuple(ca), out_b[:2] + tuple(cb)):
        assert torch.equal(x, y)


def test_link_bonds_count_every_neighbour_offset():
    """q_l averages over n_spins x n_neighbors bonds, as the reference's
    measurement does: on the triangular lattice 3 a site, not n_dims = 2."""
    tri = [[1, 0], [0, 1], [1, -1]]
    lat = Lattice((4, 6), tri)
    assert (lat.n_dims, lat.n_neighbors) == (2, 3)
    ref = RefLattice((4, 6), tri)
    assert link_bonds(lat) == 24 * 3 == ref.n_spins * ref.n_neighbors
    assert link_bonds(Lattice((4, 4, 4))) == 64 * 3
