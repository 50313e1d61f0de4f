"""A numpy model of ``houdn_bonds``', ``ov_finish``'s and
``houdn_finish``'s launches (``csrc/overlap.cu``), held to the plain
versions and the JAX package.

The kernels take ``ov_bonds``' walk (``ops/overlap.py`` ``ov_words``,
``ov_per``): a group of four sites of ``per`` consecutive tasks of one
realization a thread, every (task, group) once; ``houdn_*`` with ``per``
from the ``HOUDN_ROWS // g`` rule.

* ``houdn_bonds``: a CTA stages each task's ``g`` member slots once (the
  model's table against ``gather_tasks``); a thread counts each byte's
  negative members over the members' 4-byte words and their neighbour
  words (the vector path's words, or each site's neighbours where the fast
  extent is off the word), a site balanced where the count is ``g / 2``
  (``__vcmpeq4``, or 16-bit lanes past ``g = 254``), against ``_houdn``'s
  active mask; its state bytes and the seed ballot bitwise
  ``houdn_states_plain``.
* ``ov_finish``: each group's roots one load of the flat parents, Wolff's
  seed root once a task (none where Joerg's seed is ``n``), SW's coins and
  the word-wide nonsingleton test (the backward words only where a coin
  falls on a root with no forward bond), and each system's word flipped by
  ``xor f 0xFE``: bitwise ``finish_plain`` and ``overlap_event_plain``.
* ``houdn_finish``: the same flips in every one of the ``g`` members,
  read from the CTA's staged member slots (as ``houdn_bonds``' are),
  bitwise ``finish_plain`` and ``overlap_event_plain`` at g = 2, 4, 6;
  ``launch_event`` hands it ``fk_link``'s flat parents, the caller's
  labels where it asks for them, and no labels argument.
* The model's whole move (bonds, the labelling, the flips) against the JAX
  package's fused events (``houdn_event_batch``, ``overlap_event_batch``,
  interpret mode) fed the same uniforms: spins and the stats graph's
  labels.
"""

import jax
import numpy as np
import pytest
import torch

from peapods_tpu_torch.engine import seeds
from peapods_tpu_torch.ops import _build, fk, overlap
from peapods_tpu_torch.ops import rng as trng
from peapods_tpu_torch.ops.cluster import connected_components, salted_uniform
from peapods_tpu_torch.ops.fk import state_masks
from test_torch_overlap_index import (KLOW, _covers_once, _fdiv, _walk, _words, launch_map,
                                      model_states, site_step, word_sites)

torch.set_num_threads(1)

KLOW2 = 0x00010001


def _bytes_eq(c, h, lane_bits=8):
    """``__vcmpeq4`` (``lane_bits`` 8) or ``__vcmpeq2`` (16) of int64 words:
    each lane all ones where the lanes of ``c`` and ``h`` are equal."""
    mask = (1 << lane_bits) - 1
    out = torch.zeros_like(c)
    for sh in range(0, 32, lane_bits):
        out |= (((c >> sh) & mask) == ((h >> sh) & mask)).to(torch.int64) * (mask << sh)
    return out


def _inputs(shape, d, g, n_groups, n_temps, seed, kind="houdayer", wolff=True):
    """Random spins, slots and one move's tables of tasks of ``g``
    replicas (``n_groups`` a temperature)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    nd = len(shape)
    n_rep = g * n_groups
    s = n_rep * n_temps
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(n_rep)[:, None]
                    for _ in range(d)]).reshape(d, s).astype(np.int32)
    spins = rng.choice(np.array([-1, 1], np.int8), size=(d, s, n))
    coup = rng.standard_normal((d, n, nd)).astype(np.float32)
    temps = np.geomspace(0.8, 2.0, n_temps).astype(np.float32)
    keys = rng.integers(0, 2**32, (d, 2), dtype=np.uint64).astype(np.uint32)
    tasks, tkeys = seeds.overlap_tasks(keys, [seed], n_rep, n_temps, g)
    scal, probes = seeds.event_scalars(kind, wolff, tkeys[0], n)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return (t(spins), t(sid), t(tasks[0]), t(coup), t(temps), t(scal.reshape(-1, 6)),
            t(probes.reshape(-1, 64)), t(tkeys[0].view(np.int32).reshape(-1, 2)))


def neighbour_sites(g, nd):
    """Site of byte q of each group's direction-``d`` forward word
    ([groups, 4] per direction): the vector path's words where the fast
    extent holds whole words, else each site's own neighbour."""
    n = g["n"]
    ng = -(-n // 4)
    grp = np.arange(ng)
    if g["lf"] % 4 == 0:
        return [word_sites(g, grp, dd, False) for dd in range(nd)]
    i = np.minimum(4 * grp[:, None] + np.arange(4), n - 1)
    return [site_step(g, i, dd, False) for dd in range(nd)]


def cta_rows(g, sid, tasks, gs):
    """The member slots each CTA (z, x) stages: ``rows[z, x, k g + r]`` =
    ``sid[z, tasks[b g + r] T + t]``, t = w / G by multiply-shift."""
    d, T, G, per = g["d"], g["T"], g["G"], g["per"]
    flat = tasks.reshape(-1).numpy().astype(np.int64)
    sidn = sid.numpy().astype(np.int64)
    rows = np.zeros((d, T * G // per, per * gs), np.int64)
    for z in range(d):
        for x in range(T * G // per):
            for k in range(per):
                w = x * per + k
                t = int(_fdiv(w, g["div"][2]))
                b = z * T * G + w
                for r in range(gs):
                    rows[z, x, k * gs + r] = sidn[z, flat[b * gs + r] * T + t]
    return rows


def model_houdn(spins, sid, tasks, probes, shape, wolff, per=0, wide=False):
    """The model's ``(state, seeds, act)``: the launch's state bytes,
    seeds and each task's balanced sites, from the staged rows, the
    per-byte counts and the ballot."""
    d, S, n = spins.shape
    nd = len(shape)
    T, G, gs = tasks.shape[1:]
    per = per or overlap.ov_per(n, d, T, G, 1 << 30, max(1, overlap.HOUDN_ROWS // gs))
    g = _walk(overlap.ov_words(tuple(shape), d, T, G, S, per))
    B = d * T * G
    assert _covers_once(*launch_map(g), B, -(-n // 4))
    rows = cta_rows(g, sid, tasks, gs)  # [d, sets, per gs]
    mem = torch.from_numpy(rows.reshape(d, -1, gs))  # [d, T G, gs]: by task
    pad = (-n) % 4
    nb = neighbour_sites(g, nd)
    words = []  # each member's word and forward words: [B, gs, 1 + nd, groups]
    for b in range(B):
        z = b // (T * G)
        sp = torch.nn.functional.pad(spins[z, mem[z, b % (T * G)]], (0, pad))
        ws = [_words(sp)]
        for dd in range(nd):
            ws.append(_words(spins[z, mem[z, b % (T * G)]][:, torch.from_numpy(nb[dd]).reshape(-1)]))
        words.append(torch.stack(ws, 1))
    words = torch.stack(words)
    h = gs // 2
    if wide:  # 16-bit lanes: bytes 0 and 2, then 1 and 3
        lo = ((words >> 7) & KLOW2).sum(1)
        hi = ((words >> 15) & KLOW2).sum(1)
        act = (_bytes_eq(lo, torch.tensor(h * KLOW2), 16) & KLOW2) \
            | ((_bytes_eq(hi, torch.tensor(h * KLOW2), 16) & KLOW2) << 8)
    else:
        assert gs <= 254  # no byte of the counts overflows
        cnt = ((words >> 7) & KLOW).sum(1)  # [B, 1 + nd, groups]
        act = _bytes_eq(cnt, torch.tensor(h * KLOW)) & KLOW
    st = torch.zeros_like(act[:, 0])
    for dd in range(nd):
        st |= (act[:, 0] & act[:, 1 + dd]) << dd
    state = torch.from_numpy(st.numpy().astype(np.uint32).view(np.uint8).reshape(B, -1)[:, :n]
                             .copy())
    balanced = torch.from_numpy(act[:, 0].numpy().astype(np.uint32).view(np.uint8)
                                .reshape(B, -1)[:, :n].copy()) != 0
    # the seed ballot over the staged rows: lanes l and 32 + l
    sd = []
    for b in range(B):
        z = b // (T * G)
        pr = probes[b].numpy()
        tot = spins[z, mem[z, b % (T * G)]].to(torch.int32).numpy()[:, pr].sum(0)
        if not wolff:
            sd.append(n)
            continue
        lo = int(((tot[:32] == 0).astype(np.int64) << np.arange(32)).sum())
        hi = int(((tot[32:] == 0).astype(np.int64) << np.arange(32)).sum())
        ffs = lambda m: (m & -m).bit_length() - 1  # noqa: E731
        sd.append(int(pr[ffs(lo)]) if lo else int(pr[32 + ffs(hi)]) if hi else n)
    return state, torch.tensor(sd, dtype=torch.int32), balanced


def houdn_per(n, d, T, G, gs, threads=1):
    """``launch_event``'s tasks a thread of the ``houdn_*`` kernels:
    :func:`~overlap.ov_per` up to ``HOUDN_ROWS // g`` (at least 1), against
    ``threads`` (1: the most the rule allows)."""
    return overlap.ov_per(n, d, T, G, threads, max(1, overlap.HOUDN_ROWS // gs))


def model_finish(spins, sid, tasks, scal, seeds_, state, parent, shape, kind, wolff, per=0):
    """The model's flips, in place: each (task, group) of ``ov_finish``'s
    walk (or ``houdn_finish``'s, over every member: the CTA's staged
    member slots, ``per`` from :func:`houdn_per`) from the group's roots
    (one word of flat parents), its state word, the coins and the
    word-wide nonsingleton test, each system's word xor ``f 0xFE``.
    Returns how many (task, group)s loaded their backward words."""
    d, S, n = spins.shape
    nd = len(shape)
    T, G, gs = tasks.shape[1:]
    houd = kind == "houdayer"
    per = per or (houdn_per(n, d, T, G, gs) if houd else overlap.ov_per(n, d, T, G, 1 << 30))
    g = _walk(overlap.ov_words(tuple(shape), d, T, G, S, per))
    B = d * T * G
    b_of, grp_of, _ = launch_map(g)
    assert _covers_once(b_of, grp_of, None, B, -(-n // 4))
    sys, *_ = overlap.gather_tasks(spins, sid, tasks, T)
    sys = sys.reshape(B, gs)
    if houd:  # the members of each task as the CTA stages them
        assert per * gs <= max(overlap.HOUDN_ROWS, gs)
        rows = torch.from_numpy(cta_rows(g, sid, tasks, gs).reshape(B, gs))
        assert torch.equal(rows, sys)
        sys = rows
    pad = (-n) % 4
    ng = (n + pad) // 4
    lab = torch.nn.functional.pad(parent.to(torch.int64), (0, pad), value=-1).reshape(B, ng, 4)
    stw = _words(torch.nn.functional.pad(state.view(torch.int8), (0, pad)))  # [B, ng]
    sd = seeds_.to(torch.int64)
    # the CTA's entries: the seed root, none where the seed is n
    root = torch.where(sd < n, parent.to(torch.int64).gather(1, sd.clamp(max=n - 1)[:, None])[:, 0],
                       torch.tensor(-1))
    shifts = torch.tensor([0, 8, 16, 24])
    site = torch.arange(ng)[:, None] * 4 + torch.arange(4)
    valid = site < n

    def mask(bits):  # bool [B, ng, 4] -> bit 0 of byte q
        return ((bits & valid).to(torch.int64) << shifts).sum(-1)

    if wolff:
        inside = mask(lab == root[:, None, None])
        fa = fb = inside
        if kind == "cmr":
            k = scal[:, 5].to(torch.int64)[:, None]
            fa = torch.where((k & 1) != 0, inside, 0)
            fb = torch.where((k & 2) != 0, inside, 0)
        loads = 0
    else:
        s0, s1 = (scal[:, 0:1], scal[:, 1:2]) if kind != "cmr" else (scal[:, 2:3], scal[:, 3:4])
        u = salted_uniform(lab.reshape(B, -1), s0, s1).reshape(B, ng, 4)
        kq = torch.where(u < 0.5, 3, 0) if kind != "cmr" else (u * 4.0).to(torch.int64)
        ka, kb = mask((kq & 1) != 0), mask((kq & 2) != 0)
        any_ = mask(lab != site)
        for dd in range(nd):
            any_ = any_ | ((stw >> dd) & KLOW)
        need = (ka | kb) & ~any_ & KLOW
        i = np.arange(n)
        bwd = [site_step(g, i, dd, True) for dd in range(nd)]
        stt = state.to(torch.int64)
        for dd in range(nd):  # the backward neighbours' bonds towards the site
            bw = torch.nn.functional.pad((stt[:, torch.from_numpy(bwd[dd])] >> dd) & 1, (0, pad))
            any_ = any_ | torch.where(need != 0, mask(bw.reshape(B, ng, 4) != 0), 0)
        loads = int((need != 0).sum())
        fa, fb = ka & any_, kb & any_
    if kind == "cmr":
        blue = (stw >> 7) & KLOW
        fa, fb = fa ^ blue, fb ^ blue
    flips = [fa, fb] if kind == "cmr" else [fa] * gs
    for b in range(B):
        z = b // (T * G)
        for r in range(gs):
            row = torch.nn.functional.pad(spins[z, sys[b, r]], (0, pad))
            w = _words(row) ^ (flips[r][b] * 0xFE)
            new = torch.from_numpy(w.numpy().astype(np.uint32).view(np.int8)[:n].copy())
            spins[z, sys[b, r]] = new
    return loads


def _last_graph(args, shape, kind, wolff):
    """The plain inputs of the finish: ``(state, parent, seeds)`` of the
    move's last graph (Houdayer's, Joerg's bonds; CMR's state2 and grey
    graph)."""
    spins, sid, tasks, coup, temps, scal, probes, words = args
    if kind == "houdayer":
        st, sd = overlap.houdn_states_plain(spins, sid, tasks, probes, wolff=wolff, shape=shape)
    else:
        st, st2, sd = overlap.bond_states_plain(spins, sid, tasks, coup, temps, scal, probes,
                                                words, kind=kind, wolff=wolff, shape=shape)
        st = st if kind == "jorg" else st2
    par = connected_components(state_masks(st, len(shape)), shape).to(torch.int32)
    return st, par, sd


SHAPES = [(8, 8, 8), (4, 6, 8), (6, 6, 6), (8, 16), (5, 7)]
IDS = ["8cube", "4x6x8", "6cube-offword", "8x16", "5x7-offword"]


@pytest.mark.parametrize("per", [1, 2, 4])
@pytest.mark.parametrize("g", [2, 4, 6])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_houdn_model_is_bitwise_the_plain_bonds(shape, g, per):
    """Every (task, group) once, the CTA's staged member slots against
    ``gather_tasks``, the per-byte counts' balanced sites against
    ``_houdn``'s active mask (byte lanes and 16-bit lanes alike), and the
    state bytes and Wolff seeds bitwise ``houdn_states_plain``."""
    n_groups = 2 if g == 2 else 1
    d, T = 2, 4
    args = _inputs(shape, d, g, n_groups, T, 3 + g + per)
    spins, sid, tasks, _, _, _, probes, _ = args
    n = int(np.prod(shape))
    g_ = _walk(overlap.ov_words(shape, d, T, n_groups, spins.shape[1], per))
    rows = cta_rows(g_, sid, tasks, g)
    sys = overlap.gather_tasks(spins, sid, tasks, T)[0]
    assert np.array_equal(rows.reshape(d, T, n_groups, g), sys.numpy())
    st, sd = overlap.houdn_states_plain(spins, sid, tasks, probes, wolff=True, shape=shape)
    _, *slots = overlap.gather_tasks(spins, sid, tasks, T)
    active, _ = overlap._houdn_bonds(torch.stack(slots, 1), shape)
    for wide in (False, True):
        ms, msd, bal = model_houdn(spins, sid, tasks, probes, shape, True, per, wide)
        assert torch.equal(bal, active)
        assert torch.equal(ms, st)
        assert torch.equal(msd, sd)
    assert int(st.sum()) > 0 and int((sd < n).sum()) > 0
    ms, msd, _ = model_houdn(spins, sid, tasks, probes, shape, False, per)
    assert torch.equal(ms, st) and bool((msd == n).all())


def test_houdn_seed_is_n_where_no_probe_is_balanced():
    """A task whose members all agree has no balanced site: no bond, and
    the ballot gives the seed n (no flip)."""
    shape = (8, 8)
    args = _inputs(shape, 1, 4, 1, 2, 5)
    spins, sid, tasks, _, _, _, probes, _ = args
    sys = overlap.gather_tasks(spins, sid, tasks, 2)[0]
    for r in range(1, 4):
        spins[0, sys[0, 0, 0, r]] = spins[0, sys[0, 0, 0, 0]]
    st, sd = overlap.houdn_states_plain(spins, sid, tasks, probes, wolff=True, shape=shape)
    ms, msd, _ = model_houdn(spins, sid, tasks, probes, shape, True, 1)
    assert int(sd[0]) == 64 and int(st[0].sum()) == 0
    assert torch.equal(ms, st) and torch.equal(msd, sd)


def test_balanced_counts_do_not_overflow_a_byte():
    """Each byte of a member's ``(w >> 7) & 0x01010101`` is 0 or 1, so g <=
    254 members keep every byte's count below 256 and ``__vcmpeq4`` with
    ``g / 2`` in every byte tells the balanced bytes; a larger g counts in
    16-bit lanes."""
    rng = np.random.default_rng(0)
    for gs in (2, 6, 254, 256, 1000):
        x = rng.choice(np.array([-1, 1], np.int8), size=(gs, 64))
        for t in range(0, 32, 7):  # balanced columns
            x[:, t] = np.where(np.arange(gs) % 2 == 0, 1, -1)
        w = _words(torch.from_numpy(x))  # [gs, 16]
        want = torch.from_numpy((x.astype(np.int32).sum(0) == 0).reshape(16, 4))
        if gs <= 254:
            cnt = ((w >> 7) & KLOW).sum(0)
            act = _bytes_eq(cnt, torch.tensor((gs // 2) * KLOW)) & KLOW
        else:
            lo = ((w >> 7) & KLOW2).sum(0)
            hi = ((w >> 15) & KLOW2).sum(0)
            act = (_bytes_eq(lo, torch.tensor((gs // 2) * KLOW2), 16) & KLOW2) \
                | ((_bytes_eq(hi, torch.tensor((gs // 2) * KLOW2), 16) & KLOW2) << 8)
        got = ((act[:, None] >> torch.tensor([0, 8, 16, 24])) & 1) != 0
        assert torch.equal(got, want), gs


@pytest.mark.parametrize("per", [1, 2, 4])
@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_finish_model_is_bitwise_the_plain_move(shape, kind, wolff, per):
    """The model's flips (roots from the flat parents, the word-wide
    nonsingleton test, ``xor f 0xFE``) bitwise ``finish_plain`` on the
    kernel's own inputs, and both bitwise ``overlap_event_plain``'s move;
    ``finish_plain`` returns the parents as the labels."""
    g = 4 if kind == "houdayer" else 2
    d, T = 2, 4
    args = _inputs(shape, d, g, 2, T, 11 + per, kind, wolff)
    st, par, sd = _last_graph(args, shape, kind, wolff)
    spins, sid, tasks, coup, temps, scal, probes, words = args
    want = spins.clone()
    graphs = overlap.overlap_event_plain(want, sid, tasks, coup, temps, scal, probes, words,
                                         kind=kind, wolff=wolff, shape=shape, with_labels=True)
    plain = spins.clone()
    lab = overlap.finish_plain(plain, sid, tasks, scal, sd, st, par, kind=kind, wolff=wolff,
                               shape=shape)
    model = spins.clone()
    model_finish(model, sid, tasks, scal, sd, st, par, shape, kind, wolff, per)
    assert torch.equal(plain, want)
    assert torch.equal(model, want)
    assert not torch.equal(model, spins)
    assert torch.equal(lab.to(torch.int64), graphs.labels.to(torch.int64))


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("g", [2, 4, 6])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_houdn_finish_model_is_bitwise_the_plain_move(shape, g, wolff):
    """``houdn_finish``'s walk (``per`` from the ``HOUDN_ROWS // g`` rule,
    every (task, group) once, the CTA's staged member slots against
    ``gather_tasks``) flips every member's words from the flat parents:
    bitwise ``finish_plain`` on the kernel's own inputs and
    ``overlap_event_plain``'s whole move, whose labels are the parents."""
    n_groups = 2 if g == 2 else 1
    d, T = 2, 4
    args = _inputs(shape, d, g, n_groups, T, 7 + g + wolff, "houdayer", wolff)
    st, par, sd = _last_graph(args, shape, "houdayer", wolff)
    spins, sid, tasks, coup, temps, scal, probes, words = args
    n = int(np.prod(shape))
    per = houdn_per(n, d, T, n_groups, g)
    assert per == T * n_groups  # the rule's most: a realization's tasks in one CTA
    want = spins.clone()
    graphs = overlap.overlap_event_plain(want, sid, tasks, coup, temps, scal, probes, words,
                                         kind="houdayer", wolff=wolff, shape=shape,
                                         with_labels=True)
    plain = spins.clone()
    lab = overlap.finish_plain(plain, sid, tasks, scal, sd, st, par, kind="houdayer",
                               wolff=wolff, shape=shape)
    for p in (per, 1):
        model = spins.clone()
        model_finish(model, sid, tasks, scal, sd, st, par, shape, "houdayer", wolff, p)
        assert torch.equal(model, want)
    assert torch.equal(plain, want)
    assert not torch.equal(want, spins)
    assert torch.equal(lab.to(torch.int64), graphs.labels.to(torch.int64))


@pytest.mark.parametrize("g", [2, 4, 6, 3072, 3074, 6144, 24576, 24578])
def test_houdn_rule_keeps_the_staged_rows_within_48k(g):
    """The ``houdn_*`` kernels' tasks a thread: the largest divisor of a
    realization's tasks up to ``HOUDN_ROWS // g`` (2-byte member slots, so
    a CTA's rows stay within the 48 KB a launch takes without opting in),
    one task where a group alone is past it."""
    per = houdn_per(4 ** 3, 1, 8, 1, g)
    assert 1 <= per <= overlap.OV_MAX_PER and 8 % per == 0
    assert per * g * 2 <= 48 * 1024 or per == 1
    assert per == max(p for p in (1, 2, 4, 8) if p <= max(1, overlap.HOUDN_ROWS // g))


class _Recorder:
    """Stands in for the kernels' library: each entry point records its
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("observe,labels", [(False, True), (False, False), (True, True)],
                         ids=["update-labels", "update", "observe"])
def test_houdn_launches_hand_fk_link_the_callers_labels(monkeypatch, observe, labels, wolff):
    """``launch_event``'s Houdayer forms on a recording library: ``fk_link``
    labels ``houdn_bonds``' state bytes into the caller's labels (the
    scratch parents where it passes none), and ``houdn_finish`` reads those
    flat parents with the same walk words as ``houdn_bonds``, with no
    labels argument (its entry's signature); the observe form launches no
    finish."""
    monkeypatch.setattr(fk, "resident_threads", lambda index: 132 * 2048)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(fk, "LAUNCHES", dict.fromkeys(fk.LAUNCHES, 0))
    monkeypatch.setattr(overlap, "LAUNCHES", dict.fromkeys(overlap.LAUNCHES, 0))
    gs = 2 if observe else 4  # Houdayer(N > 2) has no observe form
    shape, d, T, G = (8, 8, 8), 8, 24, 4 // gs
    dims = (d * T * G, 8, 8, 8, T, G, gs * G * T)
    p_in = tuple(range(1, 9))  # spins, sid, tasks, coup, temps, scal, probes, keys
    st, par, seeds_ = 101, 102, 103
    p_labels = 55 if labels else None
    lib = _Recorder()
    overlap.launch_event(lib, 7, dims, *p_in, (st, par, seeds_, None, None), kind="houdayer",
                         wolff=wolff, group=gs, p_labels=p_labels, observe=observe)
    names = [name for name, _ in lib.calls]
    assert names == ["peapods_houdn_bonds", "peapods_fk_link"] + (
        [] if observe else ["peapods_houdn_finish"])
    per = overlap.ov_per(512, d, T, G, 132 * 2048 // 4, overlap.HOUDN_ROWS // gs)
    words = overlap.ov_words(shape, d, T, G, gs * G * T, per).ctypes.data
    bonds = lib.calls[0][1]
    assert bonds == (1, 2, 3, 7, st, seeds_, words, gs, int(wolff), 7)
    link = lib.calls[1][1]
    assert link[:2] == (st, p_labels or par)
    assert overlap.LAUNCHES["houdn_finish"] == (not observe)
    if observe:
        return
    fin = lib.calls[2][1]
    assert len(fin) == len(_build._SIGNATURES["peapods_houdn_finish"])
    assert fin == (1, 2, 3, 6, st, p_labels or par, seeds_, words, gs, int(wolff), 7)


def test_finish_reads_backward_words_only_where_a_coin_needs_them():
    """SW: the backward words are read only for the (task, group)s where a
    coin flips a root with no forward bond, not for all, and the flips
    stay bitwise ``finish_plain``'s."""
    shape = (8, 8, 8)
    args = _inputs(shape, 2, 2, 2, 4, 21, "jorg", False)
    st, par, sd = _last_graph(args, shape, "jorg", False)
    spins, sid, tasks, _, _, scal, _, _ = args
    a, b = spins.clone(), spins.clone()
    loads = model_finish(a, sid, tasks, scal, sd, st, par, shape, "jorg", False)
    overlap.finish_plain(b, sid, tasks, scal, sd, st, par, kind="jorg", wolff=False, shape=shape)
    assert torch.equal(a, b)
    groups = 2 * 4 * 2 * 128
    assert 0 < loads < groups


def test_joerg_wolff_with_no_active_probe_flips_nothing():
    """A Joerg task whose pair agrees has the seed n: its seed root is -1,
    which no site's flat parent equals, and the task flips nothing."""
    shape = (8, 8)
    args = _inputs(shape, 1, 2, 1, 2, 9, "jorg", True)
    spins, sid, tasks, coup, temps, scal, probes, words = args
    sys = overlap.gather_tasks(spins, sid, tasks, 2)[0]
    spins[0, sys[0, 0, 0, 1]] = spins[0, sys[0, 0, 0, 0]]
    st, par, sd = _last_graph(args, shape, "jorg", True)
    assert int(sd[0]) == 64
    a = spins.clone()
    model_finish(a, sid, tasks, scal, sd, st, par, shape, "jorg", True)
    assert torch.equal(a[0, sys[0, 0, 0]], spins[0, sys[0, 0, 0]])
    b = spins.clone()
    overlap.finish_plain(b, sid, tasks, scal, sd, st, par, kind="jorg", wolff=True, shape=shape)
    assert torch.equal(a, b)


def test_negating_a_spin_byte_is_xor_0xfe():
    """+1 = 0x01 and -1 = 0xff: a byte xor 0xFE is its negation, and a word
    xor f 0xFE (f: bit 0 of the flipped bytes) flips exactly those bytes."""
    rng = np.random.default_rng(1)
    x = rng.choice(np.array([-1, 1], np.int8), size=(64, 4))
    f = rng.random((64, 4)) < 0.5
    w = _words(torch.from_numpy(x))[:, 0]
    fw = torch.from_numpy((f.astype(np.int64) << np.array([0, 8, 16, 24])).sum(1))
    got = (w ^ (fw * 0xFE)).numpy().astype(np.uint32).view(np.int8).reshape(64, 4)
    np.testing.assert_array_equal(got, np.where(f, -x, x))


@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
def test_observe_form_without_its_labels_buffer_is_refused(kind):
    """The observe form labels the stats graph into the caller's buffer
    (CMR: ``p_blue``) and launches no finish: without that buffer
    ``launch_event`` refuses before any launch, where it would otherwise
    label into its scratch and hand back nothing."""
    dims = (4, 4, 4, 1, 2, 1, 4)
    other = dict(p_labels=1) if kind == "cmr" else dict(p_blue=1)
    with pytest.raises(ValueError, match="p_blue" if kind == "cmr" else "p_labels"):
        overlap.launch_event(None, None, dims, *([None] * 8), (None,) * 5, kind=kind,
                             wolff=False, observe=True, **other)


@pytest.mark.parametrize("wolff", [True, False], ids=["wolff", "sw"])
@pytest.mark.parametrize("kind", ["houdayer", "jorg", "cmr"])
def test_model_move_matches_the_jax_events(kind, wolff):
    """The model's whole move on a flat batch of tasks (one realization,
    task t at temperature t): its bonds (``houdn_bonds``' model, or
    ``ov_bonds``' and ``ov_mid``'s), the labelling, ``ov_finish``'s flips;
    its spins and stats graph's labels equal the JAX package's fused event
    (interpret mode) fed the same uniforms."""
    from peapods_tpu.ops.lattice import Lattice as RefLattice
    from test_torch_houdn import _fused_houdn
    from test_torch_overlap import _fused

    shape, n_tasks = (8, 16), 4
    lat = RefLattice(list(shape))
    n, nd = lat.n_spins, lat.n_dims
    gs = 4 if kind == "houdayer" else 2
    rng = np.random.default_rng(31 + wolff)
    x = rng.choice(np.array([-1, 1], np.int8), size=(n_tasks, gs, n))
    coup = rng.normal(size=(n, nd)).astype(np.float32)
    temps = np.linspace(0.8, 1.6, n_tasks).astype(np.float32)
    tkeys = jax.random.split(jax.random.key(9 + wolff), n_tasks)
    kd = np.asarray(jax.random.key_data(tkeys)).astype(np.uint32)
    words = torch.from_numpy(kd.view(np.int32).reshape(-1, 2))
    if kind == "houdayer":
        ref, rlab = _fused_houdn(lat, x, tkeys, wolff)
    else:
        u = [trng.bond_uniforms(words, n, nd, f).numpy() for f in (0, nd)]
        slots = [u[0][..., k] for k in range(nd)] + (
            [u[1][..., k] for k in range(nd)] if kind == "cmr" else [])
        ra, rb, rlab = _fused(lat, x[:, 0], x[:, 1], tkeys, kind, wolff, coup, temps, slots)
        ref = np.stack([ra, rb], 1)
    # the flat batch as one realization: member r of task t at slot r T + t
    scal, probes = seeds.event_scalars(kind, wolff, kd, n)
    scal, probes = torch.from_numpy(scal.reshape(-1, 6)), torch.from_numpy(probes.reshape(-1, 64))
    spins = torch.from_numpy(x.reshape(1, n_tasks * gs, n).copy())
    sid = torch.tensor([[t * gs + r for r in range(gs) for t in range(n_tasks)]], dtype=torch.int32)
    tasks = torch.arange(gs, dtype=torch.int32).expand(1, n_tasks, 1, gs).contiguous()
    cp, tp = torch.from_numpy(coup)[None], torch.from_numpy(temps)
    if kind == "houdayer":
        st, sd, _ = model_houdn(spins, sid, tasks, probes, shape, wolff, 1)
        last = st
        assert houdn_per(n, 1, n_tasks, 1, gs) == n_tasks  # one CTA: the whole batch
    else:
        st, st2, sd, _ = model_states(spins, sid, tasks, cp, tp, scal, probes, words, shape,
                                      kind, wolff)
        last = st if kind == "jorg" else st2
    stats = connected_components(state_masks(st, nd), shape)
    par = connected_components(state_masks(last, nd), shape).to(torch.int32)
    # houdn_finish: the rule's tasks a thread; ov_finish: one
    model_finish(spins, sid, tasks, scal, sd, last, par, shape, kind, wolff,
                 0 if kind == "houdayer" else 1)
    np.testing.assert_array_equal(spins.reshape(n_tasks, gs, n).numpy(), ref)
    np.testing.assert_array_equal(stats.numpy(), rlab)
