"""Replicas on the table lattices (four dimensions or more, or 7 to 32
offsets): the plain table forms of the overlap moves and of
``pair_overlap`` against the JAX package, and a numpy model of the table
forms' launches.

* The plain moves over a table lattice's offsets (``ops/overlap.py`` with a
  table ``Lattice``) bitwise the reference's staged functions
  (``houdayer_task``, ``jorg_bonds(u_bond=)``, ``cmr_blue_bonds(u_blue=)``,
  ``cmr_mid(u_red=)`` and the finishes on ``GridOps.from_lattice``) fed
  the same uniforms, on 3^4 (odd), 4^4, 2^5, (1, 3, 3, 3) (an axis of
  extent 1: self-bonds) and 4^3 with 9 offsets: every member's spins and
  the labels, bitwise.  The table form's split of CMR (grey words and the
  blue flip apart, ``table_states_plain``) composed with ``finish_plain``
  is the whole move.
* ``pair_overlap_table_plain`` against the reference's ``overlap_dots`` on
  the same lattices: q and q_l are integer sums, and must be exact (no
  tolerance, stricter than the 1e-6 relative that q_l may take).
* A numpy model of the launches of ``csrc/overlap.cu``'s ``*_table``
  kernels (``table_grid``: a thread a group of four sites of one task)
  and of ``csrc/pairs.cu``'s ``pair_overlap_table`` (``per`` columns a
  CTA, a thread striding over sites): every (task, site) and
  every (realization, column, site) taken once, each neighbour that the
  kernels read from the device tables the lattice's (the reference's
  ``Lattice.fwd`` and a modulo walk), and the model's disagreement counts
  bitwise ``pair_overlap_table_plain``.

The engine on these lattices: ``test_torch_overlap_tables_engine.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peapods_tpu.ops.geometry import GridOps
from peapods_tpu.ops.lattice import Lattice as RefLattice
from peapods_tpu.ops.measure import overlap_dots as ref_overlap_dots
from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.ops import fk, megapair, overlap
from peapods_tpu_torch.ops.cluster import connected_components
from peapods_tpu_torch.ops.lattice import Lattice
from test_torch_overlap_lattices import _batch, _port, _staged
from test_torch_table_plans import model_pair_table

torch.set_num_threads(1)

# the cubic lattice's axes and face diagonals: 9 forward offsets
NINE = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1],
        [0, 1, 1], [0, 1, -1]]
TABLES = [((3, 3, 3, 3), None), ((4, 4, 4, 4), None), ((2, 2, 2, 2, 2), None),
          ((1, 3, 3, 3), None), ((4, 4, 4), NINE)]
TABLE_IDS = ["3^4", "4^4", "2^5", "1x3^3-self", "nine"]


def _offsets(shape, offsets):
    return offsets if offsets is not None else np.eye(len(shape), dtype=int).tolist()


# each lattice with one of the moves (the reference's staged chain runs
# eagerly, a few seconds a case; Houdayer(4) on 4^4 below): every kind,
# both forms
STAGED = [((3, 3, 3, 3), None, "cmr", False), ((2, 2, 2, 2, 2), None, "jorg", True),
          ((1, 3, 3, 3), None, "houdayer", False), ((4, 4, 4), NINE, "cmr", True)]
STAGED_IDS = ["3^4-cmr-sw", "2^5-jorg-wolff", "1x3^3-self-houdayer-sw", "nine-cmr-wolff"]


@pytest.mark.parametrize("shape,offsets,kind,wolff", STAGED, ids=STAGED_IDS)
def test_plain_moves_match_staged_functions(shape, offsets, kind, wolff):
    """Spins and the move's last labels (CMR's grey ones) bitwise the
    reference's staged chain."""
    assert Lattice(shape, offsets).table
    offs = _offsets(shape, offsets)
    rlat, x, coup, temps, u, tkeys = _batch(shape, offs, 4, 80 + len(shape) + wolff)
    want, want_labels = _staged(rlat, x, tkeys, kind, wolff, coup, temps, u)
    got, labels, _ = _port(Lattice(shape, offsets), x, tkeys, kind, wolff, coup, temps, u)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels, want_labels)
    assert (got != x).any()


@pytest.mark.parametrize("shape,offsets,wolff", [((4, 4, 4, 4), None, True)],
                         ids=["4^4-wolff"])
def test_houd4_plain_matches_houdayer_task(shape, offsets, wolff):
    """Houdayer(4) tasks: every member's spins and the labels bitwise the
    reference's ``houdayer_task`` on groups of four."""
    offs = _offsets(shape, offsets)
    rlat, x, coup, temps, u, tkeys = _batch(shape, offs, 3, 90 + wolff, g=4)
    want, want_labels = _staged(rlat, x, tkeys, "houdayer", wolff, coup, temps, u)
    got, labels, _ = _port(Lattice(shape, offsets), x, tkeys, "houdayer", wolff, coup,
                           temps, u)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels, want_labels)


def _tables_inputs(lat, seed, kind, wolff, d=2, n_rep=4, n_temps=3, g=2):
    rng = np.random.default_rng(seed)
    n, nb, s = lat.n_spins, lat.n_neighbors, n_rep * n_temps
    spins = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(d, s, n)))
    sid = torch.from_numpy(np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32))
    coup = torch.from_numpy(rng.normal(size=(d, n, nb)).astype(np.float32))
    temps = torch.from_numpy(np.geomspace(0.8, 2.0, n_temps).astype(np.float32))
    keys = rng.integers(0, 2**32, (d, 2), dtype=np.uint64).astype(np.uint32)
    tasks, tkeys = seeds.overlap_tasks(keys, [seed], n_rep, n_temps, g)
    scal, probes = seeds.event_scalars(kind, wolff, tkeys[0], n)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (spins, sid, up(tasks[0]), coup, temps, up(scal.reshape(-1, 6)),
            up(probes.reshape(-1, 64)), up(tkeys[0].view(np.int32).reshape(-1, 2)))


@pytest.mark.parametrize("kind,g", [("houdayer", 2), ("houdayer", 4), ("jorg", 2),
                                    ("cmr", 2)], ids=["houdayer", "houd4", "jorg", "cmr"])
@pytest.mark.parametrize("wolff", [False, True], ids=["sw", "wolff"])
@pytest.mark.parametrize("shape,offsets", [TABLES[0], TABLES[3], TABLES[4]],
                         ids=["3^4", "1x3^3-self", "nine"])
def test_table_states_and_finish_compose_the_move(shape, offsets, wolff, kind, g):
    """The table form's stages in plain torch: ``table_states_plain``' first
    graph (int32 words), CMR's grey words and blue flips, labelled as
    cc_table_link labels them, then ``finish_plain(flip=)``: every member's
    spins and the labels bitwise ``overlap_event_plain``."""
    lat = Lattice(shape, offsets)
    spins, sid, tasks, coup, temps, scal, probes, words = _tables_inputs(lat, 5, kind, wolff,
                                                                         g=g)
    args = (sid, tasks, coup, temps, scal, probes, words)
    st, st2, flip, sd = overlap.table_states_plain(spins, *args, kind=kind, wolff=wolff,
                                                   lattice=lat)
    assert st.dtype == torch.int32 and (flip is None) == (kind != "cmr")
    last = st if st2 is None else st2
    par = connected_components(fk.state_masks(last, lat.n_neighbors), lat.shape,
                               lat.offsets).to(torch.int32)
    a, b = spins.clone(), spins.clone()
    overlap.finish_plain(a, sid, tasks, scal, sd, last, par, kind=kind, wolff=wolff,
                         shape=lat, flip=flip)
    graphs = overlap.overlap_event_plain(b, *args, kind=kind, wolff=wolff, shape=lat,
                                         with_labels=True)
    assert torch.equal(a, b)
    assert torch.equal(par, graphs.labels.to(torch.int32))
    assert not torch.equal(a, spins)


def test_table_words_hold_32_offsets():
    """A bond word of 32 offsets: bit 31 set is a negative int32, and the
    masks read it back."""
    bonds = torch.zeros((1, 3, 32), dtype=torch.bool)
    bonds[0, 0, 31] = bonds[0, 1, 0] = bonds[0, 2] = True
    w = overlap._state_bytes(bonds, torch.int32)
    assert w.tolist() == [[-2**31, 1, -1]]
    assert torch.equal(fk.state_masks(w, 32), bonds)


@pytest.mark.parametrize("shape,offsets,n_rep,n_temps",
                         [t + r for t, r in zip(TABLES, [(2, 3), (4, 2), (6, 5), (2, 4),
                                                         (4, 3)])],
                         ids=[f"{i}-r{r}" for i, r in zip(TABLE_IDS, (2, 4, 6, 2, 4))])
def test_pair_overlap_table_plain_matches_overlap_dots(shape, offsets, n_rep, n_temps):
    """qs and ql of every (realization, pair, temperature) bitwise the
    reference's ``overlap_dots`` (integers: exact); the engine's wrapper
    writes them into row views."""
    lat = Lattice(shape, offsets)
    rlat = RefLattice(list(shape), _offsets(shape, offsets))
    d, s = 2, n_rep * n_temps
    rng = np.random.default_rng(17 + n_rep)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(d, s, lat.n_spins))
    sid = np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)
    qs, ql = megapair.pair_overlap_table_plain(torch.from_numpy(spins),
                                               torch.from_numpy(sid),
                                               torch.from_numpy(lat.fwd), n_rep)
    geom = GridOps.from_lattice(rlat)
    for z in range(d):
        rq, rl = ref_overlap_dots(jnp.asarray(spins[z]),
                                  jnp.asarray(sid[z].reshape(n_rep, n_temps)), geom)
        np.testing.assert_array_equal(qs[z].numpy(), np.asarray(rq).reshape(-1))
        np.testing.assert_array_equal(ql[z].numpy(), np.asarray(rl).reshape(-1))
    rows = torch.full((2, d, 3, (n_rep // 2) * n_temps), -1, dtype=torch.int32)
    megapair.pair_overlap_table(torch.from_numpy(spins), torch.from_numpy(sid),
                                rows[0][:, 1], rows[1][:, 1], lattice=lat, n_replicas=n_rep,
                                tables=lat.device_tables("cpu"))
    assert torch.equal(rows[0][:, 1], qs) and torch.equal(rows[1][:, 1], ql)
    assert (rows[:, :, [0, 2]] == -1).all()


# ------------------------------------------------ the launches, modelled

# csrc/overlap.cu kThreads
THREADS = 256


def table_grid(n, n_tasks):
    """``csrc/overlap.cu`` ``table_grid``: x the blocks of THREADS groups of
    four sites, y the tasks."""
    return -(-(-(-n // 4)) // THREADS), n_tasks


def _modulo_fwd(shape, offsets, sign=1):
    """The neighbour at ``sign * offset`` of every site by a modulo walk of
    its coordinates."""
    coords = np.stack(np.unravel_index(np.arange(int(np.prod(shape))), shape), -1)
    off = np.asarray(_offsets(shape, offsets))
    c = (coords[:, None, :] + sign * off[None]) % np.asarray(shape)
    return np.ravel_multi_index(tuple(np.moveaxis(c, -1, 0)), shape)


@pytest.mark.parametrize("n_tasks", [1, 7, 384])
@pytest.mark.parametrize("shape,offsets", TABLES + [((6, 6, 6, 6), None), ((5,) * 5, None)],
                         ids=TABLE_IDS + ["6^4", "5^5"])
def test_table_launch_takes_every_task_site_once(shape, offsets, n_tasks):
    """``table_grid``'s CTAs (x the blocks of 256 groups of four sites, y the
    tasks; ov_finish_table and houdn_finish_table): each thread's group
    ``4 grp .. 4 grp + 3`` below n, every (task, site) once; the planned
    kernels' plan (``overlap.ov_table_plan``: x a realization's
    sets of ``per`` tasks, y the group blocks, z the realizations) every
    (task, site) once too; each neighbour the kernels read, ``fwd[i nb +
    d]`` / ``bwd[i nb + d]`` of the device tables, the reference's table and
    the modulo walk's."""
    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    gx, gy = table_grid(n, n_tasks)
    assert gy == n_tasks and gx <= 2**31 - 1
    bx, tx = np.meshgrid(np.arange(gx), np.arange(THREADS), indexing="ij")
    grp = (bx * THREADS + tx).reshape(-1)
    i0 = 4 * grp
    live = i0 < n
    sites = (i0[live, None] + np.arange(4)[None]).reshape(-1)
    sites = sites[sites < n]
    taken = np.sort(np.add.outer(np.arange(n_tasks) * n, sites).reshape(-1))
    np.testing.assert_array_equal(taken, np.arange(n_tasks * n))
    fwd, bwd = (t.numpy().reshape(-1) for t in lat.device_tables("cpu"))
    rlat = RefLattice(list(shape), _offsets(shape, offsets))
    e = (sites[:, None] * nb + np.arange(nb)[None]).reshape(-1)
    np.testing.assert_array_equal(fwd[e].reshape(-1, nb), np.asarray(rlat.fwd)[sites])
    np.testing.assert_array_equal(fwd[e].reshape(-1, nb), _modulo_fwd(shape, offsets)[sites])
    np.testing.assert_array_equal(bwd[e].reshape(-1, nb),
                                  _modulo_fwd(shape, offsets, -1)[sites])
    words = overlap.ov_table_words(n, nb, 2, 3, 4, 24)
    assert words.dtype == np.int32 and words.tolist() == [n, nb, 3, 4, 24, 2]
    d, n_temps, n_groups = {1: (1, 1, 1), 7: (1, 7, 1), 384: (16, 12, 2)}[n_tasks]
    plan = overlap.ov_table_plan(n, d, n_temps, n_groups, 132, 2)
    px, py, pz = plan.grid
    assert px * plan.per * pz == n_tasks and py == gx and pz == d
    task = (np.arange(pz)[:, None, None] * n_temps * n_groups
            + np.arange(px)[None, :, None] * plan.per + np.arange(plan.per)[None, None])
    taken = np.sort(np.add.outer(task.reshape(-1) * n, sites).reshape(-1))
    np.testing.assert_array_equal(taken, np.arange(n_tasks * n))


def _model_pair_table(spins, sid, fwd, n_rep):
    """The pair_overlap_table launch in numpy on the plan of 132 SMs
    (``megapair.pair_table_plan``; ``test_torch_table_plans.py``
    ``model_pair_table``: a cluster staging the realization's
    disagreement words).  Returns (qs, ql) and the (z, column, site) keys
    taken."""
    d, s, n = spins.shape
    cols = (n_rep // 2) * (s // n_rep)
    plan = megapair.pair_table_plan(n, cols, d, 132)
    qs, ql, counts = model_pair_table(spins, sid, fwd, n_rep, plan)
    taken = np.repeat(np.arange(d * cols * n), counts.reshape(-1))
    return qs, ql, taken


@pytest.mark.parametrize("shape,offsets,n_rep,n_temps",
                         [((3, 3, 3, 3), None, 2, 3), ((2, 2, 2, 2, 2), None, 4, 4),
                          ((4, 4, 4), NINE, 6, 1), ((3, 3, 3, 3), None, 2, 7)],
                         ids=["3^4-r2", "2^5-r4", "nine-r6", "3^4-r2-t7"])
def test_pair_table_launch_model_matches_plain(shape, offsets, n_rep, n_temps):
    """Every (realization, column, site) taken once, and the model's counts
    bitwise ``pair_overlap_table_plain`` (columns pair-major: p T + t, the
    pair's systems at slots 2p T + t and (2p + 1) T + t), which the test
    above holds to the reference's ``overlap_dots``."""
    lat = Lattice(shape, offsets)
    d, s = 2, n_rep * n_temps
    rng = np.random.default_rng(23 + n_rep + n_temps)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(d, s, lat.n_spins))
    sid = np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)
    qs, ql, taken = _model_pair_table(spins, sid, lat.fwd, n_rep)
    cols = (n_rep // 2) * n_temps
    np.testing.assert_array_equal(np.sort(taken), np.arange(d * cols * lat.n_spins))
    pq, pl = megapair.pair_overlap_table_plain(torch.from_numpy(spins), torch.from_numpy(sid),
                                               torch.from_numpy(lat.fwd), n_rep)
    np.testing.assert_array_equal(qs, pq.numpy())
    np.testing.assert_array_equal(ql, pl.numpy())
