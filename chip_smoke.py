"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``peapods_tpu_torch`` from the sources in this
checkout (one nvcc per source, all at once) and drives the port's paths
through the user's entry points:

* the mega path: the flagship configuration (256x256, 24 temperatures, PT
  every sweep) through ``IsingSimulation.sample``, each of its kernels
  (``colour_pass``, ``pt_step``) held against its plain torch version
  (``pt_step`` also on gaussian partials at the 4096^2 bands' and config
  5's shapes, bitwise: its rows add in one fixed order);
* the per-sweep path with SW / Wolff cluster updates: config 3 (256x256 at
  T_c, SW every sweep) through ``Ising.sample`` twice from one seed, its
  Binder cumulant against the torus value, a Wolff run against it, SW with
  PT on the 64x64 x 16 temperatures x 128 realizations harness shape, 4x4
  exact enumeration, and each kernel (``sweep_2d``, ``fk_bonds``,
  ``fk_link``, ``fk_finish``, ``pt_step``) held against its plain version
  at both shapes, the labelling one launch at a time (``fk_link`` in its
  whole-graph form, or tiled with ``fk_link_border`` and
  ``fk_link_flatten``);
* the replica path: configs 4 (8^3 +-J glass, Houdayer every 10 sweeps,
  PT on a random edge) and 5 (16^3 gaussian glass, Joerg + CMR every 10
  sweeps, full-ladder PT), each 24 temperatures x 4 replicas x 8
  realizations, through ``Ising.sample`` twice from one seed; q and P(q) at
  config 4's hottest temperature; a 4x4 +-J glass against exact
  enumeration with each overlap move; and each kernel (``colour_pass`` in
  3D, ``pair_overlap``, ``pt_step`` on R ladders, ``houdn_bonds``,
  ``houdn_finish`` (Houdayer), ``ov_bonds``, ``ov_mid``, ``ov_finish``
  (Joerg, CMR), ``fk_link``, ``energy_partials``) held against its plain
  version at both configs' shapes;
* the per-sweep path on the coloured lattices: config 2 (32x32 triangular,
  8 temperatures, Wolff every 2 sweeps) at full width through
  ``Ising.sample`` twice from one seed, its Wolff <e> against Metropolis
  with PT; short runs of the 3D cubic (32^3, SW + PT), BCC and FCC (16^3,
  PT) and next-nearest-neighbour (64^2) paths; a 4x4 triangular magnet
  against exact enumeration; ``sweep_nb`` and ``measure_nb`` against their
  plain versions at each path's shape, the FK kernels with three bond
  directions at config 2 and 32^3, and ``sweep_2d`` at 32^2 x 16 (the TPU's
  narrow-lattice sweep);
* FK observe and the staged FK path: 256^2 SW observe at T_c through
  ``Ising.sample`` twice from one seed (the observations' invariants, the
  active-bond density against p x the satisfied-bond fraction, the rate),
  SW observe + PT on the harness shape (2048 graphs a sweep), SW + PT +
  cluster statistics on 16^3 BCC and FCC and SW observe + PT on the 64^2
  next-nearest-neighbour table through the staged path (bonds,
  ``cc_link`` / ``cc_label``, flips), NNN observe against the same run
  without the observer (bitwise), a 4x4 NNN magnet with staged SW against
  exact enumeration, and each new kernel (``winding``, ``cc_link``,
  ``cc_label``, ``fk_bonds_nb``, ``fk_finish`` in observe form and reading
  the CC labels) held against its plain version on those runs' states;
* Houdayer(N), the overlap moves' statistics and overlap observe: config 4
  with ``cmr+houd4`` SW and cluster statistics through ``Ising.sample``
  twice from one seed (checksums over spins, records, ``overlap_csd`` and
  ``top_cluster_sizes``; the histograms against the stats graphs; the
  rates and the host's share), config 4 with Wolff ``houd4``, a 4x4 +-J
  glass with R = 4 (houd4 on the card bitwise the plain path on the CPU;
  the pair-Houdayer control against exact enumeration, houd4's deviation
  from it measured), SW overlap observe at config 4's shape and on a 64^2
  square with winding (the observations' invariants, each run bitwise the
  run without overlap moves), and ``houdn_bonds`` / ``houdn_finish`` (g =
  4 and 6) and the pair moves' labels, masks and observe form held
  against their plain versions;
* the space-sharded path (a lattice split into row bands over a
  ``("space",)`` mesh that names the one card four times, through
  ``IsingSimulation.sample``): a 4096^2 ferromagnet at T_c with SW and PT
  every sweep in 4 bands, in 1 band and unsharded (three equal checksums,
  each run's rate); the flagship shape, a narrow 64^2 square, 128^3 cubic
  with SW + PT, 256^2 triangular with PT and 32^3 FCC with SW + PT + cluster
  statistics, each in 4 bands bitwise its unsharded per-sweep run; every
  band kernel (``sweep_halo``, ``measure_halo``, ``fk_bonds_band``, the
  banded labelling's ``cc_band_link`` / ``_border`` / ``_flatten`` /
  ``_export`` / ``_merge`` / ``_resolve`` / ``_write``, ``fk_finish_band``)
  held against its plain version on those runs' states; and the band
  kernels' device times (the labelling's per FK phase beside its bound),
  the halo copies' and the busy share over main-path windows, and their
  ptxas registers and spills; the unsharded 4096^2 run's labelling.

Each path's launch counts are zeroed just before its main run and read just
after.  Every phase prints lines; any failure raises and the script exits
non-zero.  The line before the last is a JSON record of the kernels; the
last line is::

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

Exits non-zero, printing no result, when torch sees no CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

L = 256
N_TEMPS = 24
FLAGSHIP_SWEEPS = 4096
SEED = 42
TIE_ULPS = 4  # |u - p| within this many ulp of p: an exp rounding tie
MAX_TIE_SHARE = 1e-5

T_C = float(2.0 / np.log(1.0 + np.sqrt(2.0)))
CONFIG3_SWEEPS = 4096
# the square-lattice torus Binder cumulant at T_c (Salas & Sokal 2000):
# 1 - <m^4> / (3 <m^2>^2) with <m^4> / <m^2>^2 = 1.1679
BINDER_TC = 0.6107
BINDER_TOL = 0.03
HARNESS = dict(shape=(64, 64), n_temps=16, n_disorder=128, sweeps=256)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside the
# tensor cores; a kernel's bound is the larger of its bytes and its f32
# operations over these
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12


def bound(n_bytes, flops):
    """``(bound_ms, bound_by)`` of a kernel that moves ``n_bytes`` (each
    input read once, each output written once) and does ``flops`` f32
    operations."""
    t_b, t_f = n_bytes / HBM_BYTES_S, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def add_kernel_time(acc, name, ev):
    """Add a profiler record to ``acc[name] = [device us, launches]`` (each
    instantiation of a template kernel is a record of its own)."""
    t = acc.setdefault(name, [0.0, 0])
    t[0] += ev.self_device_time_total
    t[1] += ev.count


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def state_checksum(sim, result) -> str:
    """Hash of final spins + PT permutation + counter + per-temp observables
    (the reference bench's state_checksum, bench.py:120-128)."""
    h = hashlib.sha256()
    h.update(sim.state["spins"].cpu().numpy().tobytes())
    h.update(sim.state["system_ids"].cpu().numpy().tobytes())
    h.update(np.asarray(sim.state["counter"], np.int32).tobytes())
    for key in ("mags", "mags2", "energies", "energies2"):
        h.update(np.asarray(result[key]).tobytes())
    return h.hexdigest()[:16]


def gpu_ms(fn, reps):
    """Device time of one ``fn()`` launch: the launches are queued behind a
    sleep kernel so that they run back to back, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)  # ~0.2 s: longer than queueing the launches
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps):
    """Host-clock time of one ``fn()`` call, ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def flagship_inputs(dev, rng):
    """Spins, couplings and words at the flagship shapes, +-J couplings."""
    from peapods_tpu_torch.ops.sweep import pack_coupling_grids

    d = 1
    coup = rng.choice([-1.0, 1.0], size=(d, L * L, 2)).astype(np.float32)
    return dict(
        spins=torch.from_numpy(
            rng.choice([-1, 1], size=(d, N_TEMPS, L, L)).astype(np.int8)).to(dev),
        jgrids=pack_coupling_grids(torch.from_numpy(coup), (L, L)).contiguous().to(dev),
        sid=torch.from_numpy(
            rng.permutation(N_TEMPS).astype(np.int32)[None]).to(dev),
        temps=torch.from_numpy(
            np.geomspace(1.8, 3.2, N_TEMPS).astype(np.float32)).to(dev),
        words=torch.from_numpy(
            rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)).to(dev),
    )


def check_colour_pass(dev, rng):
    """Kernel vs plain, one colour pass at a time.  Returns the record."""
    from peapods_tpu_torch.ops import mega
    from peapods_tpu_torch.ops.energy import energies_and_mags
    from peapods_tpu_torch.ops.rng import colour_uniforms
    from peapods_tpu_torch.ops.sweep import acceptance, colour_mask, local_field

    x = flagship_inputs(dev, rng)
    sys_idx = x["sid"][0].long()
    n_sites = 0
    ties_total = 0
    max_err = 0.0
    spins = x["spins"]
    for colour in (0, 1):
        a, b = spins.clone(), spins.clone()
        k_out = mega.colour_pass(a, x["jgrids"], x["sid"], x["temps"], x["words"],
                                 colour, gibbs=False)
        p_out = mega.colour_pass_plain(b, x["jgrids"], x["sid"], x["temps"],
                                       x["words"], colour, gibbs=False)
        torch.cuda.synchronize()
        # the tie test on the pass's input, slot order
        s = spins[0, sys_idx].float()
        field = local_field(s, x["jgrids"][0])
        inv = (1.0 / (0.5 * x["temps"]))[:, None, None]
        p = acceptance((-s * field) * inv, gibbs=False)
        u = colour_uniforms(x["words"], N_TEMPS, colour, (L, L))[0]
        ulp = torch.nextafter(p, torch.full_like(p, np.inf)) - p
        active = colour_mask((L, L), colour, dev)
        tie = ((u - p).abs() <= TIE_ULPS * ulp) & active
        diff = (a[0, sys_idx] != b[0, sys_idx])
        if (diff & ~tie).any():
            raise AssertionError(
                f"colour {colour}: {int((diff & ~tie).sum())} spins differ "
                "away from ulp ties")
        n_tie = int((diff & tie).sum())
        for site in (diff & tie).nonzero().tolist()[:20]:
            log("3 kernel-vs-plain", f"colour {colour} tie at slot/row/col {site}")
        ties_total += n_tie
        n_sites += N_TEMPS * L * L // 2
        if colour == 1:
            # partials by system
            e_k = k_out[0].double().sum(-1) / (L * L)
            m_k = k_out[1].sum(-1)
            e_p = p_out[0].double().sum(-1) / (L * L)
            m_p = p_out[1].sum(-1)
            # the kernel's fused (e, m) against a recompute on its own spins
            coup = x["jgrids"][0, [1, 3]].reshape(2, -1).T.contiguous()
            e_rc, m_rc = energies_and_mags(a[0].reshape(N_TEMPS, -1), coup, (L, L))
            if not torch.equal(e_k.float()[0], e_rc):
                raise AssertionError("kernel e differs from the recompute")
            if not torch.equal(m_k[0], m_rc):
                raise AssertionError("kernel m differs from the recompute")
            if n_tie == 0:
                if not torch.equal(e_k, e_p) or not torch.equal(m_k, m_p):
                    raise AssertionError("kernel (e, m) differ from plain")
            max_err = max(max_err, float((e_k - e_p).abs().max()))
        spins = b  # the next pass starts from the plain output
    if ties_total > MAX_TIE_SHARE * n_sites:
        raise AssertionError(f"{ties_total} ulp ties in {n_sites} sites")
    log("3 kernel-vs-plain",
        f"colour_pass ok: spins equal at {n_sites} sites but {ties_total} ulp "
        f"ties (|u-p| <= {TIE_ULPS} ulp), e bitwise vs recompute, m exact; "
        f"max |e_kernel - e_plain| = {max_err}")

    # times at the flagship shapes
    lib_args = (x["jgrids"], x["sid"], x["temps"], x["words"])
    k_spins, p_spins = x["spins"].clone(), x["spins"].clone()
    ms = gpu_ms(lambda: mega.colour_pass(k_spins, *lib_args, 1, gibbs=False), 200)
    plain_ms = wall_ms(
        lambda: mega.colour_pass_plain(p_spins, *lib_args, 1, gibbs=False), 10)
    # reads every spin and coupling grid, writes the active colour's spins;
    # ~20 f32 operations per active site
    n_sites = N_TEMPS * L * L
    bms, by = bound(n_sites + 4 * 4 * L * L + n_sites // 2, 20 * n_sites // 2)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, ties=ties_total,
                bound_ms=bms, bound_by=by, library_ms=None)


def pt_step_bound(d, n_slots, n_blocks, do_pt, pt_full):
    """``bound()`` of one ``pt_step`` launch: reads the partials, sid and
    the temperatures, writes the (e, m) rows; with PT also reads the draws
    and reads and writes the PT state, and writes the systems'
    temperatures."""
    n_edges = n_slots - 1
    n_bytes = 8 * d * n_slots * n_blocks + 4 * d * n_slots + 4 * n_slots \
        + 8 * d * n_slots
    flops = d * n_slots * (n_blocks + 1)
    if do_pt:
        n_draws = 2 * n_edges if pt_full else 2
        n_bytes += 4 * d * n_draws + 2 * 4 * d * (2 * n_edges + 2 * n_slots) \
            + 4 * d * n_slots + 4 * d * n_slots
        flops += 10 * d * (n_edges if pt_full else 1)
    return bound(n_bytes, flops)


def pt_step_events(e_part, m_part, sid0, temps, draws, *, do_pt, pt_full,
                   n_spins, label):
    """``pt_step`` and ``pt_step_plain`` side by side over the events of
    ``draws`` (one entry per event, ``None`` without PT), each from the same
    partials (by system) and start state: the (e, m) rows, ``sid``, the PT
    counters, the trip state, the systems' temperatures and the parity must
    be equal bitwise.  Returns ``(max |e_kernel - e_plain|, accepted,
    attempted)``."""
    from peapods_tpu_torch.ops import mega
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems
    from peapods_tpu_torch.ops.tempering import hot_cold_slots, init_trip_state

    dev = e_part.device
    d, n_slots = sid0.shape
    hot, cold = hot_cold_slots(temps.cpu().numpy())
    n_events = len(draws)
    i32 = dict(dtype=torch.int32, device=dev)
    states = []
    for _ in range(2):
        sid = sid0.clone()
        states.append(dict(
            sid=sid, ea=torch.zeros((d, n_slots - 1), **i32),
            ec=torch.zeros((d, n_slots - 1), **i32),
            rt=torch.zeros((d, n_slots), **i32),
            ts=init_trip_state(sid[:, None], hot),
            sys_temps=slot_temps_for_systems(sid, temps),
            e=torch.empty((d, n_events, n_slots), dtype=torch.float32, device=dev),
            m=torch.empty((d, n_events, n_slots), **i32),
            parity=0,
        ))
    for t in range(n_events):
        for st, fn in ((states[0], mega.pt_step), (states[1], mega.pt_step_plain)):
            st["parity"] = fn(
                e_part, m_part, st["e"][:, t], st["m"][:, t], st["sid"],
                st["ea"], st["ec"], st["rt"], st["ts"], temps, draws[t],
                st["sys_temps"], do_pt=do_pt, pt_full=pt_full,
                parity=st["parity"], hot_slot=hot, cold_slot=cold,
                n_spins=n_spins)
    torch.cuda.synchronize()
    k, p = states
    for key in ("sid", "ea", "ec", "rt", "ts", "sys_temps", "e", "m"):
        if not torch.equal(k[key], p[key]):
            raise AssertionError(f"pt_step ({label}): {key} differs")
    if k["parity"] != p["parity"]:
        raise AssertionError(f"pt_step ({label}): parity differs")
    if do_pt and int(k["ec"].sum()) == 0:
        raise AssertionError(f"pt_step ({label}) accepted no swap: weak check")
    return (float((k["e"] - p["e"]).abs().max()), int(k["ec"].sum()),
            int(k["ea"].sum()))


def pt_step_args(e_part, m_part, sid, temps, draws):
    """The positional arguments of one ``pt_step`` launch from a fresh PT
    state."""
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems

    d, n = sid.shape
    i32 = dict(dtype=torch.int32, device=sid.device)
    return (e_part, m_part, torch.empty((d, n), dtype=torch.float32, device=sid.device),
            torch.empty((d, n), **i32), sid.clone(), torch.zeros((d, n - 1), **i32),
            torch.zeros((d, n - 1), **i32), torch.zeros((d, n), **i32),
            torch.zeros((d, n), **i32), temps, draws,
            slot_temps_for_systems(sid, temps))


def check_pt_step(dev, rng):
    """Kernel vs plain PT step at the flagship shapes, both schedules, with
    the mega path's draws (the murmur mix of PT words)."""
    from peapods_tpu_torch.ops import mega
    from peapods_tpu_torch.ops.tempering import hot_cold_slots, pt_draws

    x = flagship_inputs(dev, rng)
    e_part, m_part = mega.colour_pass(x["spins"], x["jgrids"], x["sid"],
                                      x["temps"], x["words"], 1, gibbs=False)
    n_events = 64
    max_err = 0.0
    single = None
    for pt_full in (False, True):
        words = torch.from_numpy(
            rng.integers(-2**31, 2**31, (n_events, 1, 2)).astype(np.int32)).to(dev)
        dr = pt_draws(words, N_TEMPS - 1, pt_full=pt_full)
        draws = (list(dr) if pt_full
                 else list(zip(dr[0].to(torch.int32), dr[1])))
        if not pt_full:
            single = draws[0]
        label = "full_ladder" if pt_full else "single_random_edge"
        err, acc, att = pt_step_events(
            e_part, m_part, x["sid"], x["temps"], draws, do_pt=True,
            pt_full=pt_full, n_spins=L * L, label=f"flagship, {label}")
        max_err = max(max_err, err)
        log("3 kernel-vs-plain", f"pt_step ok (flagship, {label}): {n_events} "
            f"events bitwise, {acc} of {att} swaps accepted")

    # one single-edge event per launch, as the flagship runs
    hot, cold = hot_cold_slots(x["temps"].cpu().numpy())
    args = pt_step_args(e_part, m_part, x["sid"], x["temps"], single)
    kw = dict(do_pt=True, pt_full=False, parity=0, hot_slot=hot, cold_slot=cold,
              n_spins=L * L)
    ms = gpu_ms(lambda: mega.pt_step(*args, **kw), 200)
    plain_ms = wall_ms(lambda: mega.pt_step_plain(*args, **kw), 20)
    bms, by = pt_step_bound(1, N_TEMPS, e_part.shape[2], True, False)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def check_pt_step_rows(dev, rng):
    """``pt_step`` against its plain version on gaussian partials where a
    row's order matters most: 4096^2 in 4 bands (1 x 4 rows of 65,536
    partials, each split over CTAs; 64 events in a row, each finding the
    tickets the last one left at zero) and config 5's ladders (8 x 96 rows
    of 2, a thread a slot); every output bitwise.  Then the card time of
    ``e_part.sum(-1)`` and ``m_part.sum(-1)`` on the 4096^2 partials, the
    yardstick of the reduction."""
    from peapods_tpu_torch.ops import mega
    from peapods_tpu_torch.ops.tempering import pt_draws

    out = {}
    for label, (d, s, nb) in (("4096^2 in 4 bands", (1, SPACE_BIG["n_temps"], 65536)),
                              ("config 5", (SG_D, SG_R * SG_T, 2))):
        e_part = torch.from_numpy((rng.standard_normal((d, s, nb)) * 64).astype(
            np.float32)).to(dev)
        m_part = torch.from_numpy(rng.integers(-256, 256, (d, s, nb)).astype(
            np.int32)).to(dev)
        sid = torch.from_numpy(np.stack([rng.permutation(s) for _ in range(d)]).astype(
            np.int32)).to(dev)
        temps = torch.from_numpy(np.geomspace(2.0, 2.6, s).astype(np.float32)).to(dev)
        words = torch.from_numpy(rng.integers(-2**31, 2**31, (64, d, 2)).astype(
            np.int32)).to(dev)
        dr = pt_draws(words, s - 1, pt_full=False)
        draws = list(zip(dr[0].to(torch.int32), dr[1]))
        _, acc, att = pt_step_events(e_part, m_part, sid, temps, draws, do_pt=True,
                                     pt_full=False, n_spins=nb * 256,
                                     label=f"{label}, gaussian partials")
        split = mega.pt_split(nb)
        log("28 space", f"pt_step ok ({label}: {d} x {s} rows of {nb} gaussian partials, "
            f"{split} CTA(s) a row): 64 events in a row bitwise, {acc} of {att} swaps "
            "accepted")
        if nb == 65536:
            out = dict(split=split, sum_ms=gpu_ms(
                lambda: (e_part.sum(-1), m_part.sum(-1)), 200))
            log("28 space", f"the reduction's yardstick: e_part.sum(-1) and "
                f"m_part.sum(-1) on {d} x {s} x {nb} partials take {out['sum_ms']:.5f} "
                "ms of card time")
    return out


def exact_4x4(T):
    n = 16
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    idx = np.arange(16).reshape(4, 4)
    bi = np.repeat(idx.reshape(-1), 2)
    bj = np.stack([np.roll(idx, -1, 0), np.roll(idx, -1, 1)], -1).reshape(-1)
    E = (states[:, bi] * states[:, bj]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    w = np.exp(E / T - E.max() / T)
    return (E * w).sum() / w.sum() / n, ((M / n) ** 2 * w).sum() / w.sum()


def flagship(dev):
    """The flagship config through IsingSimulation.sample, twice."""
    from peapods_tpu_torch import Ising, IsingSimulation
    from peapods_tpu_torch.ops import mega

    temps = np.geomspace(1.8, 3.2, N_TEMPS).astype(np.float32)
    coup = np.ones((L, L, 2), np.float32)
    kw = dict(pt_interval=1, warmup_ratio=0.0)

    sim = IsingSimulation([L, L], coup, temps, 1, None, SEED, device=dev)
    mega.reset_launches()
    result = sim.sample(FLAGSHIP_SWEEPS, "metropolis", **kw)
    launches = dict(mega.LAUNCHES)
    check_a = state_checksum(sim, result)
    want = {"colour_pass": 2 * FLAGSHIP_SWEEPS, "pt_step": FLAGSHIP_SWEEPS}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    sim_b = IsingSimulation([L, L], coup, temps, 1, None, SEED, device=dev)
    result_b = sim_b.sample(FLAGSHIP_SWEEPS, "metropolis", **kw)
    check_b = state_checksum(sim_b, result_b)
    if check_a != check_b:
        raise AssertionError(f"checksums differ: {check_a} {check_b}")
    # steady-state rate: further calls on the warm simulation
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim_b.sample(FLAGSHIP_SWEEPS, "metropolis", **kw)
        torch.cuda.synchronize()
        rates.append(FLAGSHIP_SWEEPS / (time.perf_counter() - t0))

    e, m2 = result["energies"], result["mags2"]
    sid = sim.state["system_ids"].cpu().numpy().reshape(-1)
    pt = result["per_disorder"]["parallel_tempering"]
    checks = {
        "energies in (0, 2]": bool(((e > 0) & (e <= 2)).all()),
        "energies[0] > energies[-1]": bool(e[0] > e[-1]),
        "mags2[-1] < 0.05": bool(m2[-1] < 0.05),
        "mags2[0] > mags2[-1]": bool(m2[0] > m2[-1]),
        "edge_attempts.sum() == n": int(pt["edge_attempts"].sum()) == FLAGSHIP_SWEEPS,
        "system_ids is a permutation": sorted(sid.tolist()) == list(range(N_TEMPS)),
        "finite": bool(np.isfinite(e).all() and np.isfinite(m2).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"flagship sanity: {checks}")
    sweeps_s = float(np.median(rates))
    log("4 flagship",
        f"{FLAGSHIP_SWEEPS} sweeps, launches {launches}, checksum {check_a} == "
        f"{check_b}; sanity ok: {', '.join(checks)}")
    log("4 flagship",
        f"energies[0,-1] = {e[0]:.6f}, {e[-1]:.6f}; mags2[0,-1] = {m2[0]:.6f}, "
        f"{m2[-1]:.6f}; accepted swaps {int(pt['edge_acceptances'].sum())}")

    T = 2.3
    e_ex, m2_ex = exact_4x4(T)
    m4 = Ising((4, 4), temperatures=np.array([T], np.float32), seed=11, device=dev)
    m4.sample(8000, warmup_ratio=0.25)
    de, dm2 = abs(m4.energies_avg[0] - e_ex), abs(m4.mags2[0] - m2_ex)
    if not (de < 0.05 and dm2 < 0.06):
        raise AssertionError(f"4x4 exact: |dE| {de}, |dm2| {dm2}")
    log("4 physics", f"4x4 T=2.3 8000 sweeps on {dev}: <E> {m4.energies_avg[0]:.5f} "
        f"(exact {e_ex:.5f}), <m2> {m4.mags2[0]:.5f} (exact {m2_ex:.5f}) ok")
    return sweeps_s, rates, launches, sim


def kernel_share(sim, sweeps_s, n=512):
    """Device time per sweep of each kernel over a profiled window of ``n``
    sweeps, and the share of the unprofiled wall time it fills."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.sample(n, "metropolis", pt_interval=1, warmup_ratio=0.0)
        torch.cuda.synchronize()
    us = {"colour_pass": 0.0, "pt_step": 0.0}
    for ev in prof.key_averages():
        for name in us:
            if f"{name}_kernel" in ev.key:
                us[name] += ev.self_device_time_total / n
    if not all(us.values()):
        return "kernel device time not measured (the profiler saw no kernel)"
    per_sweep = sum(us.values())
    return (f"device us per sweep: colour_pass x2 {us['colour_pass']:.3f}, pt_step "
            f"{us['pt_step']:.3f}, sum {per_sweep:.3f} against {1e6 / sweeps_s:.3f} "
            f"us of wall time per sweep: the kernels fill "
            f"{per_sweep * sweeps_s / 1e6:.3f} of it")


def plain_path_rate(sim, n):
    """Sweeps/s of the plain torch mega path on the card, from the flagship
    simulation's state."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import mega

    rt, st = sim.rt, sim.state
    d = rt.n_disorder
    sw = torch.from_numpy(seeds.sweep_words(st["base_keys"], 0, n, seeds.PH_SWEEP)).to(rt.device)
    pw = torch.from_numpy(seeds.sweep_words(st["base_keys"], 0, n, seeds.PH_PT)).to(rt.device)
    args = [st["spins"].view(d, N_TEMPS, L, L).clone(), rt.jgrids, rt.temps,
            st["system_ids"].view(d, N_TEMPS).clone()] + [
        st[k].clone() for k in ("pt_edge_attempts", "pt_edge_acceptances",
                                "pt_round_trips", "pt_trip_state")]
    kw = dict(sweep_base=0, parity=0, gibbs=False, pt_interval=1, pt_full=False,
              hot_slot=rt.hot_slot, cold_slot=rt.cold_slot)
    mega.mega_chunk_plain(*args, sw[:2], pw[:2], **kw)  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mega.mega_chunk_plain(*args, sw, pw, **kw)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


# ------------------------------------------------ the per-sweep (cluster) path


def reset_cluster_counts():
    from peapods_tpu_torch.ops import cc, energy, fk, mega, sweep, winding

    for table in (sweep.LAUNCHES, fk.LAUNCHES, mega.LAUNCHES, energy.LAUNCHES,
                  cc.LAUNCHES, winding.LAUNCHES):
        for k in table:
            table[k] = 0


# the per-sweep path's FK kernels: the bonds, the labelling's launches (the
# border and the flatten where tiles split a graph), the flips
FK_KERNELS = ("fk_bonds", "fk_link", "fk_link_border", "fk_link_flatten", "fk_finish")


def link_want(shape, n_graphs, n):
    """The labelling's launches in ``n`` FK phases of ``n_graphs`` graphs of
    ``shape``: ``fk_link``, and where its tiles split a graph
    ``fk_link_border`` and ``fk_link_flatten``."""
    from peapods_tpu_torch.ops import fk

    return {k: n * v for k, v in fk.link_launches(shape, n_graphs).items()}


def cluster_counts():
    """The per-sweep path's launches since the last reset, the kernels that
    ran."""
    from peapods_tpu_torch.ops import cc, energy, fk, mega, sweep, winding

    counts = {**sweep.LAUNCHES, **fk.LAUNCHES, **energy.LAUNCHES, **cc.LAUNCHES,
              **winding.LAUNCHES, "pt_step": mega.LAUNCHES["pt_step"]}
    return {k: v for k, v in counts.items() if v}


def batch_mean_energy(model, kw, n_batches=16, n_sweeps=256):
    """Mean energy per spin and its standard error over batches of
    consecutive sample() calls."""
    e = []
    for _ in range(n_batches):
        model.sample(n_sweeps, "metropolis", **dict(kw, warmup_ratio=0.0))
        e.append(float(model.energies_avg[0]))
    e = np.array(e)
    return e.mean(), e.std(ddof=1) / np.sqrt(n_batches)


def warm_rate(model, n_sweeps, kw, calls=3):
    rates = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(n_sweeps, "metropolis", **dict(kw, warmup_ratio=0.0))
        torch.cuda.synchronize()
        rates.append(n_sweeps / (time.perf_counter() - t0))
    return float(np.median(rates)), rates


def config3(dev, card):
    """Config 3 through Ising.sample: launch counts, two equal checksums, the
    Binder cumulant at T_c, the rate, and a Wolff run against SW."""
    from peapods_tpu_torch import Ising

    temps = np.array([T_C], np.float32)
    kw = dict(cluster_update_interval=1, cluster_mode="sw", warmup_ratio=0.25)
    reset_cluster_counts()
    model = Ising((L, L), temperatures=temps, seed=3, device=dev)
    result = model.sample(CONFIG3_SWEEPS, "metropolis", **kw)
    torch.cuda.synchronize()
    launches = cluster_counts()
    n = CONFIG3_SWEEPS
    want = {"sweep_2d": 2 * n, "fk_bonds": n, **link_want((L, L), 1, n),
            "fk_finish": n, "pt_step": n}
    if launches != want:
        raise AssertionError(f"config 3 launch counts {launches}, expected {want}")
    check_a = state_checksum(model._sim, result)
    model_b = Ising((L, L), temperatures=temps, seed=3, device=dev)
    check_b = state_checksum(model_b._sim, model_b.sample(n, "metropolis", **kw))
    if check_a != check_b:
        raise AssertionError(f"config 3 checksums differ: {check_a} {check_b}")
    binder = float(model.binder_cumulant[0])
    e, m2 = float(model.energies_avg[0]), float(model.mags2[0])
    if not (np.isfinite(e) and np.isfinite(m2) and 1.2 < e < 1.6):
        raise AssertionError(f"config 3 moments: <e> {e}, <m2> {m2}")
    if abs(binder - BINDER_TC) > BINDER_TOL:
        raise AssertionError(f"config 3 Binder cumulant {binder}, expected "
                             f"{BINDER_TC} +- {BINDER_TOL}")
    log("6 config-3", f"{L}x{L} SW at T_c = {T_C:.6f}, {n} sweeps on {dev}: "
        f"launches {launches}; checksum {check_a} == {check_b}")
    log("6 config-3", f"<e> {e:.6f}, <m2> {m2:.6f}, Binder cumulant {binder:.5f} "
        f"(torus value {BINDER_TC}, tolerance {BINDER_TOL}) ok")
    sweeps_s, rates = warm_rate(model_b, n, kw)
    log("6 config-3", f"kernel path: {sweeps_s:.1f} sweeps/s = "
        f"{sweeps_s * L * L:.4e} flips/s (single-spin attempts) on {card} "
        f"(median of {', '.join(f'{r:.1f}' for r in rates)} sweeps/s)")

    # Wolff against SW: the mean energy from batch means
    e_sw, se_sw = batch_mean_energy(model, kw)
    kw_w = dict(kw, cluster_mode="wolff")
    wolff = Ising((L, L), temperatures=temps, seed=3, device=dev)
    wolff.sample(n, "metropolis", **kw_w)
    e_w, se_w = batch_mean_energy(wolff, kw_w)
    z = (e_sw - e_w) / np.hypot(se_sw, se_w)
    if not abs(z) < 4:
        raise AssertionError(f"Wolff <e> {e_w} +- {se_w} against SW {e_sw} +- "
                             f"{se_sw}: z = {z}")
    w_rate, _ = warm_rate(wolff, n, kw_w, calls=1)
    log("6 config-3", f"Wolff <e> {e_w:.6f} +- {se_w:.6f} against SW {e_sw:.6f} "
        f"+- {se_sw:.6f} (16 batches of 256 sweeps each): z = {z:.3f} ok; Wolff "
        f"path {w_rate:.1f} sweeps/s")
    return dict(launches=launches, sweeps_s=sweeps_s, model=model_b, kw=kw)


def harness(dev, card):
    """SW + PT on the 64^2 x 16 temperatures x 128 realizations harness
    shape, twice from one seed."""
    from peapods_tpu_torch import Ising

    h = HARNESS
    temps = np.geomspace(0.1, 10, h["n_temps"]).astype(np.float32)
    kw = dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1,
              warmup_ratio=0.25)
    checks, models = [], []
    for run in range(2):
        model = Ising(h["shape"], temperatures=temps, n_disorder=h["n_disorder"],
                      seed=3, device=dev)
        torch.cuda.synchronize()
        reset_cluster_counts()
        t0 = time.perf_counter()
        result = model.sample(h["sweeps"], "metropolis", **kw)
        torch.cuda.synchronize()
        rate = h["sweeps"] / (time.perf_counter() - t0)
        if run == 0:
            launches = cluster_counts()
        checks.append(state_checksum(model._sim, result))
        models.append(model)
    n = h["sweeps"]
    want = {"sweep_2d": 2 * n, "fk_bonds": n,
            **link_want(h["shape"], h["n_disorder"] * h["n_temps"], n), "fk_finish": n,
            "pt_step": n}
    if launches != want:
        raise AssertionError(f"harness launch counts {launches}, expected {want}")
    if checks[0] != checks[1]:
        raise AssertionError(f"harness checksums differ: {checks}")
    e = result["energies"]
    att = result["per_disorder"]["parallel_tempering"]["edge_attempts"]
    ok = (np.isfinite(e).all() and e[0] > e[-1]
          and int(att.sum()) == h["sweeps"] * h["n_disorder"])
    if not ok:
        raise AssertionError(f"harness sanity: energies {e}, attempts {att.sum()}")
    n_graphs = h["n_disorder"] * h["n_temps"]
    # the host's share: one chunk's FK keys and flip scalars (numpy threefry)
    from peapods_tpu_torch.engine import seeds

    t0 = time.perf_counter()
    _, kf = seeds.fk_keys(model._sim.state["base_keys"], np.arange(256), h["n_temps"])
    seeds.fk_scalars(kf, 64 * 64, wolff=False)
    keys_ms = (time.perf_counter() - t0) * 1e3 / 256
    log("7 harness", f"host: the FK keys and scalars of a 256-sweep chunk take "
        f"{keys_ms:.3f} ms per sweep ({n_graphs} graphs)")
    log("7 harness", f"64x64 x {h['n_temps']} temps x {h['n_disorder']} "
        f"realizations ({n_graphs} graphs), SW + PT every sweep, {h['sweeps']} "
        f"sweeps: checksum {checks[0]} == {checks[1]}; {rate:.1f} sweeps/s = "
        f"{rate * n_graphs * 64 * 64:.4e} flips/s on {card}; launches "
        f"{launches}; energies[0,-1] "
        f"{e[0]:.5f}, {e[-1]:.5f}; accepted swaps "
        f"{int(result['per_disorder']['parallel_tempering']['edge_acceptances'].sum())}")
    return dict(model=models[1], sweeps_s=rate, kw=kw, launches=launches)


def check_sweep_2d(dev, rng, card):
    """The sweep kernel against its plain version at 256^2 over 8 systems
    and at the harness shape (bitwise spins and partial sums); its plain
    version's time and its bound per launch at config 3 and at the harness
    shape."""
    from peapods_tpu_torch.ops import sweep
    from peapods_tpu_torch.ops.sweep import pack_coupling_grids

    def inputs(shape, d, n_sys):
        h, w = shape
        coup = rng.choice([-1.0, 1.0], size=(d, h * w, 2)).astype(np.float32)
        temps = np.stack([rng.permutation(np.geomspace(1.8, 3.2, n_sys))
                          for _ in range(d)]).astype(np.float32)
        return dict(
            spins=torch.from_numpy(
                rng.choice([-1, 1], size=(d, n_sys, h, w)).astype(np.int8)).to(dev),
            jgrids=pack_coupling_grids(torch.from_numpy(coup), shape).contiguous().to(dev),
            sys_temps=torch.from_numpy(temps).to(dev),
            words=torch.from_numpy(
                rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)).to(dev))

    max_err = 0.0
    for shape, d, n_sys in (((L, L), 1, 8), (HARNESS["shape"],
                                             HARNESS["n_disorder"],
                                             HARNESS["n_temps"])):
        x = inputs(shape, d, n_sys)
        a, b = x["spins"].clone(), x["spins"].clone()
        args = (x["jgrids"], x["sys_temps"], x["words"])
        for gibbs in (False, True):
            pk = sweep.sweep_2d(a, *args, gibbs=gibbs, measure=True)
            pp = sweep.sweep_2d_plain(b, *args, gibbs=gibbs, measure=True)
            torch.cuda.synchronize()
            n_diff = int((a != b).sum())
            e_err = float((pk[0].sum(-1) - pp[0].sum(-1)).abs().max())
            m_diff = int((pk[1].sum(-1) != pp[1].sum(-1)).sum())
            if n_diff or e_err or m_diff:
                raise AssertionError(f"sweep_2d (gibbs={gibbs}): {n_diff} spins, "
                                     f"{m_diff} m differ, max |de| {e_err}")
            max_err = max(max_err, e_err)
        log("8 kernel-vs-plain", f"sweep_2d ok: {shape[0]}x{shape[1]} x "
            f"{d * n_sys} systems, Metropolis and Gibbs: 0 of {2 * a.numel()} "
            "spins differ, (e, m) partial sums bitwise")

    times = {}
    for name, shape, d, n_sys in (("config3", (L, L), 1, 1),
                                  ("harness", HARNESS["shape"],
                                   HARNESS["n_disorder"], HARNESS["n_temps"])):
        y = inputs(shape, d, n_sys)
        yargs = (y["jgrids"], y["sys_temps"], y["words"])
        plain = wall_ms(lambda: sweep.sweep_2d_plain(
            y["spins"], *yargs, gibbs=False), 10) / 2
        n = d * n_sys * shape[0] * shape[1]
        bms, by = bound(n + d * 16 * shape[0] * shape[1] + n // 2, 20 * n // 2)
        times[name] = dict(plain_ms=plain, bound_ms=bms, bound_by=by)
    return dict(max_abs_err=max_err, library_ms=None, shapes=times)


def fk_inputs(model, dev, rng, wolff):
    """The FK kernels' inputs on a model's current state: its spins as a flat
    graph batch, couplings, the systems' temperatures, and fresh scalars and
    bond key words."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems

    sim = model._sim
    rt, st = sim.rt, sim.state
    b = rt.n_disorder * rt.n_systems
    kf = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
    return dict(
        spins=st["spins"].view(b, *rt.lattice.shape).clone(),
        j_fwd=rt.coup,
        temps=slot_temps_for_systems(st["system_ids"].view(rt.n_disorder, -1),
                                     rt.temps).view(-1).contiguous(),
        scalars=torch.from_numpy(seeds.fk_scalars(kf, rt.n_spins, wolff=wolff)).to(dev),
        kb_words=torch.from_numpy(
            rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)).to(dev))


def check_fk(models, dev, rng, card, phase="8 kernel-vs-plain"):
    """The FK kernels against their plain version on equilibrated states of
    the models (config 3: one 256^2 graph at T_c; the harness: 2048 64^2
    graphs; config 2: 8 triangular 32^2 graphs; 32^3 cubic x 16), SW and
    Wolff with labels: spins, labels, m and e must be equal.  Then the plain
    versions' times and the bounds at each shape."""
    from peapods_tpu_torch.ops import fk

    max_err = 0.0
    for name, model in models.items():
        for wolff in (False, True):
            x = fk_inputs(model, dev, rng, wolff)
            b, shape = x["spins"].shape[0], tuple(x["spins"].shape[1:])
            n = int(np.prod(shape))
            a, p = x["spins"], x["spins"].clone()
            args = (x["j_fwd"], x["temps"], x["scalars"], x["kb_words"])
            kw = dict(wolff=wolff, with_measure=True, with_labels=True)
            ek, mk, lk = fk.fk_update(a, *args, **kw)
            ep, mp, lp = fk.fk_update_plain(p, *args, **kw)
            torch.cuda.synchronize()
            e_k, m_k = fk.fk_energy_mag(ek, mk, n)
            e_p, m_p = fk.fk_energy_mag(ep, mp, n)
            bad = {"spins": int((a != p).sum()), "labels": int((lk != lp).sum()),
                   "m": int((m_k != m_p).sum()), "e": int((e_k != e_p).sum())}
            err = float((e_k - e_p).abs().max())
            n_clusters = int((lk.view(b, -1) == torch.arange(n, device=dev)).sum())
            largest = int(torch.bincount(lk.view(-1).long() + n * torch.arange(
                b, device=dev).repeat_interleave(n)).max())
            log(phase,
                f"fk {'wolff' if wolff else 'sw'} on {name} ({b} graph(s) of "
                f"{'x'.join(map(str, shape))}, {x['j_fwd'].shape[-1]} bond "
                f"directions): mismatches {bad}; {n_clusters} clusters, largest "
                f"{largest} sites; max |e_kernel - e_plain| = {err}")
            if any(bad.values()):
                raise AssertionError(f"fk kernels differ from plain: {bad}")
            max_err = max(max_err, err)

    times = {}
    for name, model in models.items():
        x = fk_inputs(model, dev, rng, False)
        b, shape = x["spins"].shape[0], tuple(x["spins"].shape[1:])
        n = int(np.prod(shape))
        d, n_dirs = x["j_fwd"].shape[0], x["j_fwd"].shape[-1]
        sp = x["spins"]
        # the plain version of each kernel, on the same state
        bd = fk.fk_bonds_plain(sp, x["j_fwd"], x["temps"], x["kb_words"])
        lab = fk.fk_link_plain(bd, shape)
        plain = {
            "fk_bonds": wall_ms(lambda: fk.fk_bonds_plain(
                sp, x["j_fwd"], x["temps"], x["kb_words"]), 3),
            "fk_finish": wall_ms(lambda: fk.fk_finish_plain(
                sp.clone(), lab, x["j_fwd"], x["scalars"], wolff=False,
                with_measure=True), 3),
        }
        cb = 4 * n_dirs * d * n  # the realizations' couplings
        t = {
            # spins, couplings, temps, kb in; state, parents out
            "fk_bonds": bound(b * n + cb + 12 * b + 5 * b * n, 8 * n_dirs * b * n),
            # spins, state, parents, couplings, scalars in; spins, partials out
            "fk_finish": bound(6 * b * n + cb + 12 * b + b * n
                               + 8 * b * ((n + 255) // 256), 2 * n_dirs * b * n),
        }
        for k, v in t.items():
            times.setdefault(k, {})[name] = dict(bound_ms=v[0], bound_by=v[1],
                                                 plain_ms=plain[k])
        for k, v in link_stages(x, dev, name, phase).items():
            times.setdefault(k, {})[name] = v
    return {k: dict(max_abs_err=max_err, library_ms=None, shapes=v)
            for k, v in times.items()}


def link_stages(x, dev, name, phase):
    """The labelling's launches one at a time on the FK bonds of ``x``'s
    graphs (``fk_bonds``' state bytes), each against its plain version:
    ``fk_link``'s parents (whole-graph form: the labels, flat, every parent
    at most its site; tiled form: each site's tile-component minimum), then
    ``fk_link_border``'s, which must lead to the labels (a forest that
    depends on the order of its unions), and ``fk_link_flatten``'s, the
    labels.  Returns each launch's plain time and bound, from this state's
    counts: every parent written once by the link; the border's face sites,
    the two tile roots of each bond that leaves a tile and a parent a hook;
    every parent read and the changed ones written by the flatten."""
    from peapods_tpu_torch.ops import _build, fk

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    b, shape = x["spins"].shape[0], tuple(x["spins"].shape[1:])
    n, n_dirs = int(np.prod(shape)), x["j_fwd"].shape[-1]
    tri = len(shape) == 2 and n_dirs == 3
    dims = _build.dims3(shape)
    state = torch.empty((b, n), dtype=torch.uint8, device=dev)
    parent = torch.empty((b, n), dtype=torch.int32, device=dev)
    _build.check(lib.peapods_fk_bonds(
        x["spins"].data_ptr(), x["j_fwd"].data_ptr(), x["temps"].data_ptr(),
        x["kb_words"].data_ptr(), state.data_ptr(), parent.data_ptr(), b,
        b // x["j_fwd"].shape[0], *dims, int(tri), stream), "fk_bonds")
    bonds = fk.state_masks(state, n_dirs)
    labels = fk.fk_link_plain(bonds, shape)
    sites = torch.arange(n, device=dev)
    n_comp = int((labels == sites).sum())
    plan = fk.link_plan(dims, b)
    parent.fill_(-1)  # the link writes every parent
    _build.check(lib.peapods_fk_link(state.data_ptr(), parent.data_ptr(), b, *dims,
                                     int(tri), *plan.tile, plan.threads, stream), "fk_link")
    linked = parent.clone()
    recs = {}
    if not plan.tiled:
        flat = bool(((linked.gather(1, linked.long()) == linked) & (linked <= sites)).all())
        bad = {"fk_link": int((linked != labels).sum()) + (not flat)}
        plain_link = lambda: fk.fk_link_plain(bonds, shape)  # noqa: E731
        form = "whole-graph form, parents flat"
    else:
        tiles = fk.fk_link_tiles_plain(bonds, shape, plan.tile)
        plain_link = lambda: fk.fk_link_tiles_plain(bonds, shape, plan.tile)  # noqa: E731
        _build.check(lib.peapods_fk_link_border(state.data_ptr(), parent.data_ptr(), b,
                                                *dims, int(tri), *plan.tile, stream),
                     "fk_link_border")
        crossed = parent.clone()
        _build.check(lib.peapods_fk_link_flatten(parent.data_ptr(), b, n, stream),
                     "fk_link_flatten")
        leads = fk.fk_link_flatten_plain(crossed)
        bad = {"fk_link": int((linked != tiles).sum()),
               "fk_link_border": int((leads != labels).sum()),
               "fk_link_flatten": int((parent != leads).sum())}
        keep = fk.tile_bonds(shape, n_dirs, plan.tile, dev)
        faces = b * int((~keep).any(-1).sum())
        crossing = int((bonds & ~keep).sum())
        hooks = int((linked == sites).sum()) - n_comp
        changed = int((crossed != labels).sum())
        recs["fk_link_border"] = dict(zip(("bound_ms", "bound_by"), bound(
            faces + 8 * crossing + 4 * hooks, 0)), plain_ms=wall_ms(
            lambda: fk.fk_link_plain(bonds, shape), 3),
            plain_is="the labels its parents lead to (fk_link_plain)")
        recs["fk_link_flatten"] = dict(zip(("bound_ms", "bound_by"), bound(
            4 * b * n + 4 * changed, 0)), plain_ms=wall_ms(
            lambda: fk.fk_link_flatten_plain(crossed), 3))
        form = (f"tiled form, tiles {plan.tile}: {faces} face sites, {crossing} bonds "
                f"leave a tile, {hooks} tile roots hooked, {changed} parents flattened")
    recs["fk_link"] = dict(zip(("bound_ms", "bound_by"), bound(5 * b * n, 0)),
                           plain_ms=wall_ms(plain_link, 3), form=form)
    torch.cuda.synchronize()
    log(phase, f"fk_link launches one at a time on {name} ({b} graph(s) of "
        f"{'x'.join(map(str, shape))}; {form}): mismatches {bad}; {n_comp} clusters")
    if any(bad.values()):
        raise AssertionError(f"the labelling's launches differ from plain on {name}: {bad}")
    return recs


def check_pt_step_per_sweep(models, dev, phase="8 kernel-vs-plain"):
    """``pt_step`` against its plain version at the per-sweep path's shapes:
    on each model's state, the FK kernels' partials by system and the
    reference's jnp-form draws of the model's keys (single edge and full
    ladder; config 3 has one temperature and so no PT event).  Then the
    plain version's time and the bound of the main path's launch."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import fk, mega
    from peapods_tpu_torch.ops.tempering import hot_cold_slots

    n_events = 64
    out = {}
    for name, model in models.items():
        sim = model._sim
        rt, state = sim.rt, sim.state
        d, n_sys = rt.n_disorder, rt.n_systems
        x = fk_inputs(model, dev, np.random.default_rng(7), False)
        e_part, m_part, _ = fk.fk_update(
            x["spins"], x["j_fwd"], x["temps"], x["scalars"], x["kb_words"],
            wolff=False, with_measure=True, with_labels=False)
        e_part, m_part = e_part.view(d, n_sys, -1), m_part.view(d, n_sys, -1)
        sid = state["system_ids"].view(d, n_sys)
        do_pt = n_sys >= 2
        max_err = 0.0
        single = None  # the first single-edge event's draws
        for pt_full in ((False, True) if do_pt else (False,)):
            draws = [None] * n_events
            if do_pt:
                dr = seeds.pt_draws_jnp(state["base_keys"], int(state["counter"]),
                                        n_events, n_sys - 1, pt_full=pt_full)
                dr = (torch.from_numpy(dr).to(dev) if pt_full
                      else tuple(torch.from_numpy(a).to(dev) for a in dr))
                draws = list(dr) if pt_full else list(zip(*dr))
            if not pt_full:
                single = draws[0]
            label = f"{name}, " + ("no PT" if not do_pt else
                                   "full_ladder" if pt_full else "single_random_edge")
            err, acc, att = pt_step_events(
                e_part, m_part, sid, rt.temps, draws, do_pt=do_pt,
                pt_full=pt_full, n_spins=rt.n_spins, label=label)
            max_err = max(max_err, err)
            log(phase, f"pt_step ok ({label}; {d} x {n_sys} slots, "
                f"{e_part.shape[2]} partials each): {n_events} events bitwise "
                f"(rows, sid, counters, trip state, system temperatures), {acc} "
                f"of {att} swaps accepted")
        # the plain version at the main path's launch: single edge on PT sweeps
        hot, cold = hot_cold_slots(rt.temps_np)
        args = pt_step_args(e_part, m_part, sid, rt.temps, single)
        kw = dict(do_pt=do_pt, pt_full=False, parity=0, hot_slot=hot,
                  cold_slot=cold, n_spins=rt.n_spins)
        plain = wall_ms(lambda: mega.pt_step_plain(*args, **kw), 20)
        bms, by = pt_step_bound(d, n_sys, e_part.shape[2], do_pt, False)
        out[name] = dict(max_abs_err=max_err, plain_ms=plain, bound_ms=bms,
                         bound_by=by)
    return out


def exact_4x4_cluster(dev):
    from peapods_tpu_torch import Ising

    T = 2.3
    e_ex, m2_ex = exact_4x4(T)
    for mode in ("sw", "wolff"):
        m4 = Ising((4, 4), temperatures=np.array([T], np.float32), seed=11,
                   device=dev)
        m4.sample(8000, warmup_ratio=0.25, cluster_update_interval=1,
                  cluster_mode=mode)
        de, dm2 = abs(m4.energies_avg[0] - e_ex), abs(m4.mags2[0] - m2_ex)
        if not (de < 0.05 and dm2 < 0.06):
            raise AssertionError(f"4x4 exact ({mode}): |dE| {de}, |dm2| {dm2}")
        log("9 physics", f"4x4 T=2.3 {mode} every sweep, 8000 sweeps on {dev}: "
            f"<E> {m4.energies_avg[0]:.5f} (exact {e_ex:.5f}), <m2> "
            f"{m4.mags2[0]:.5f} (exact {m2_ex:.5f}) ok")


def profile_window(model, kw, sweeps_s, n, names):
    """Device time of each kernel of the per-sweep path (``names``: those
    the run launches) over ``n`` sweeps of a model's main-path run, from the
    profiler's kernel records: per launch and per sweep, and the share of
    the unprofiled wall time per sweep that the device is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.sample(n, "metropolis", **dict(kw, warmup_ratio=0.0))
        torch.cuda.synchronize()
    acc, others = {}, {}
    for ev in prof.key_averages():
        if ev.self_device_time_total <= 0:
            continue
        hit = [k for k in names if f"{k}_kernel" in ev.key]
        if hit:
            add_kernel_time(acc, hit[0], ev)
        elif ev.device_type != DeviceType.CPU:  # a torch op's kernels, not the op
            others[ev.key] = others.get(ev.key, 0.0) + ev.self_device_time_total / n
    per_launch = {k: t / c for k, (t, c) in acc.items()}
    per_sweep = {k: t / n for k, (t, c) in acc.items()}
    missing = [k for k in names if k not in per_launch]
    if missing:
        raise AssertionError(f"the profiler saw no device time for {missing}")
    other = sum(others.values())
    busy = sum(per_sweep.values()) + other
    top = sorted(others.items(), key=lambda kv: -kv[1])[:3]
    line = ("device us per sweep: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_sweep.items())
        + f", other device work {other:.3f} (most: " + "; ".join(
            f"{k[:60]} {v:.3f}" for k, v in top)
        + f"), sum {busy:.3f} against "
        f"{1e6 / sweeps_s:.3f} us of wall time per sweep: the device is busy "
        f"{busy * sweeps_s / 1e6:.3f} of it")
    return per_launch, line


# ------------------------------------------------ the replica path


# configs 4 and 5 at full width (benchmarks/driver_configs.py:71-100)
SG_CONFIGS = {
    "config4": dict(shape=(8, 8, 8), couplings="bimodal", t=(0.9, 2.2), seed=4,
                    sweeps=2048, kw=dict(pt_interval=1,
                                         overlap_cluster_update_interval=10,
                                         overlap_cluster_build_mode="houdayer")),
    "config5": dict(shape=(16, 16, 16), couplings="gaussian", t=(0.8, 2.0), seed=5,
                    sweeps=512, kw=dict(pt_interval=1, pt_schedule="full_ladder",
                                        overlap_cluster_update_interval=10,
                                        overlap_cluster_build_mode="jorg+cmr")),
}
SG_R, SG_T, SG_D = 4, 24, 8
# |<q>| and the P(q) asymmetry at config 4's hottest temperature (2.2, far
# above T_g ~ 1.1 of the 3D +-J glass): q is centred on 0 with a width of
# ~1/sqrt(512), so after 2048 sweeps x 8 realizations x 2 pairs its mean
# is ~1e-3 and the mass on either side of 0 within a few per cent
Q_HOT_TOL = 0.02
PQ_ASYM_TOL = 0.05
# the 4x4 +-J glass against exact enumeration: standard errors of about
# 0.003 (e) and 0.008 (q^2) after 40000 sweeps
GLASS_SWEEPS = 40000
GLASS_E_TOL = 0.03
GLASS_Q2_TOL = 0.05
# the summed e of colour_pass and energy_partials on gaussian couplings: f32
# sums of the same terms (|terms| adding up to at most sum |J|) in another
# order, each order's error below ~(log2 n + 8) f32 epsilons of sum |J|
E_SUM_TOL = 1e-6  # of sum |J| of the system's realization
PAIR_KERNELS = ("colour_pass", "pair_overlap", "pt_step", "ov_bonds", "fk_link",
                "ov_mid", "ov_finish", "energy_partials", "houdn_bonds",
                "houdn_finish", "winding")


def move_kernels(build):
    """The overlap-move kernels that the moves of a build mode launch:
    ``houdn_bonds``, ``houdn_finish`` for Houdayer (any group size);
    ``ov_bonds``, ``ov_finish`` for Joerg and CMR, and ``ov_mid`` for CMR;
    ``fk_link`` for every move."""
    ks = {"fk_link"}
    for m in build.split("+"):
        ks |= ({"houdn_bonds", "houdn_finish"} if m.startswith("houd") else
               {"ov_bonds", "ov_finish"} | ({"ov_mid"} if m == "cmr" else set()))
    return tuple(k for k in PAIR_KERNELS if k in ks)


def houdn_bounds(b, n, g, d, s, *, wolff, labels, flipped, observe=False):
    """``{kernel: (bound_ms, bound_by)}`` of ``houdn_bonds`` and
    ``houdn_finish`` on ``b`` tasks of ``g`` members of ``n`` sites in one
    form: the bytes that form must move.  Both read the tasks and sid;
    ``houdn_bonds`` the group's spins, and in the Wolff form the 64 probes
    of a task and writes its seed; it writes a state byte and a parent a
    site.  ``houdn_finish`` reads the parents, the state bytes and two salts
    a task (SW) or the seed (Wolff), writes the labels when asked, and reads
    and writes the ``flipped`` spins that this run's data flips; in observe
    form it reads the parents and writes the labels only."""
    index = 4 * g * b + 4 * d * s
    bonds = g * b * n + index + 5 * b * n + (256 * b + 4 * b if wolff else 0)
    if observe:
        finish = 8 * b * n
    else:
        finish = (4 * b * n + index + 2 * flipped + (4 * b * n if labels else 0)
                  + (4 * b if wolff else b * n + 8 * b))
    return {"houdn_bonds": bound(bonds, 0), "houdn_finish": bound(finish, 0)}


def reset_pair_counts():
    from peapods_tpu_torch.ops import fk, mega, megapair, overlap, sweep, winding

    for table in (sweep.LAUNCHES, fk.LAUNCHES, mega.LAUNCHES, megapair.LAUNCHES,
                  overlap.LAUNCHES, winding.LAUNCHES):
        for k in table:
            table[k] = 0


def pair_counts():
    from peapods_tpu_torch.ops import fk, mega, megapair, overlap, winding

    # the overlap graphs (at most 8192 sites) take the whole-graph labelling:
    # a border or flatten launch would show here as an unexpected count
    return {**mega.LAUNCHES, **megapair.LAUNCHES, **overlap.LAUNCHES,
            "fk_link": fk.LAUNCHES["fk_link"], **winding.LAUNCHES,
            **{k: fk.LAUNCHES[k] for k in ("fk_link_border", "fk_link_flatten")
               if fk.LAUNCHES[k]}}


def sg_model(name, dev, seed=None):
    from peapods_tpu_torch import Ising

    c = SG_CONFIGS[name]
    return Ising(c["shape"], couplings=c["couplings"],
                 temperatures=np.geomspace(*c["t"], SG_T), n_replicas=SG_R,
                 n_disorder=SG_D, seed=c["seed"] if seed is None else seed,
                 device=dev)


def pair_checksum(sim, result) -> str:
    """Hash of spins, system_ids, counter, energies and overlaps."""
    h = hashlib.sha256()
    h.update(sim.state["spins"].cpu().numpy().tobytes())
    h.update(sim.state["system_ids"].cpu().numpy().tobytes())
    h.update(np.asarray(sim.state["counter"], np.int32).tobytes())
    for key in ("mags", "mags2", "energies", "energies2", "overlap", "overlap2",
                "link_overlap", "link_overlap2"):
        h.update(np.asarray(result[key]).tobytes())
    h.update(np.asarray(result["overlap_histogram"]).tobytes())
    return h.hexdigest()[:16]


def expected_pair_counts(name, n):
    """Launches of ``n`` sweeps from sweep 0: two colour passes, a pair
    measurement and a PT step per sweep; per move (every 10th sweep) its
    kernels (``houdn_bonds``, ``fk_link``, ``houdn_finish`` for Houdayer;
    ``ov_bonds``, ``fk_link``, ``ov_finish`` for Joerg and CMR, with
    ``ov_mid`` and a second ``fk_link`` for CMR: blue, then grey), the
    energy re-derivation and a second PT step."""
    c = SG_CONFIGS[name]
    interval = c["kw"]["overlap_cluster_update_interval"]
    modes = c["kw"]["overlap_cluster_build_mode"].split("+")
    moves = [modes[(s // interval) % len(modes)] for s in range(0, n, interval)]
    n_cmr = sum(k == "cmr" for k in moves)
    n_houd = sum(k.startswith("houd") for k in moves)
    e = len(moves)
    return {"colour_pass": 2 * n, "pt_step": n + e, "pair_overlap": n,
            "ov_bonds": e - n_houd, "fk_link": e + n_cmr, "ov_mid": n_cmr,
            "ov_finish": e - n_houd, "houdn_bonds": n_houd, "houdn_finish": n_houd,
            "energy_partials": e}


def sim_config(sim, kw):
    """The engine's SimConfig of a sample() call with these kwargs."""
    from peapods_tpu_torch.engine.config import (OverlapClusterConfig, SimConfig,
                                                 parse_overlap_modes)

    return SimConfig(
        n_sweeps=256, pt_interval=kw["pt_interval"],
        pt_schedule=kw.get("pt_schedule", "single_random_edge"),
        overlap_cluster=OverlapClusterConfig(
            interval=kw["overlap_cluster_update_interval"],
            modes=parse_overlap_modes(kw["overlap_cluster_build_mode"]),
            cluster_mode=kw.get("overlap_cluster_mode", "wolff")))


def sg_config(name, dev, card):
    """A spin-glass config through Ising.sample, twice from one seed: launch
    counts, two equal checksums, sanity, the rate (median of three warm
    calls)."""
    c = SG_CONFIGS[name]
    n = c["sweeps"]
    checks, models, results = [], [], []
    for run in range(2):
        model = sg_model(name, dev)
        torch.cuda.synchronize()
        reset_pair_counts()
        result = model.sample(n, "metropolis", **c["kw"])
        torch.cuda.synchronize()
        if run == 0:
            launches = {k: v for k, v in pair_counts().items() if v}
        checks.append(pair_checksum(model._sim, result))
        models.append(model)
        results.append(result)
    want = expected_pair_counts(name, n)
    if launches != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{name} launch counts {launches}, expected {want}")
    if checks[0] != checks[1]:
        raise AssertionError(f"{name} checksums differ: {checks}")
    r = results[0]
    e, q2, pt = r["energies"], r["overlap2"], r["per_disorder"]["parallel_tempering"]
    n_edges = SG_T - 1
    att_want = (n * SG_R * SG_D if "pt_schedule" not in c["kw"]
                else n * SG_R * SG_D * n_edges)
    sane = {
        "finite": bool(np.isfinite(e).all() and np.isfinite(q2).all()),
        "<e> falls with T": bool(e[0] > e[-1]),
        "<q^2> falls with T": bool(q2[0] > q2[-1]),
        "q^2 in [0, 1]": bool(((q2 >= 0) & (q2 <= 1)).all()),
        "edge attempts": int(pt["edge_attempts"].sum()) == att_want,
        "histogram counts": int(np.asarray(r["overlap_histogram"]).sum())
        == (n - int(np.floor(n * 0.25 + 0.5))) * SG_D * (SG_R // 2) * SG_T,
    }
    if not all(sane.values()):
        raise AssertionError(f"{name} sanity: {sane}")
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[1].sample(n, "metropolis", **dict(c["kw"], warmup_ratio=0.0))
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    sweeps_s = float(np.median(rates))
    n_sites = int(np.prod(c["shape"]))
    # the host's share: one 256-sweep chunk's overlap-move tables (numpy
    # threefry: permutations, task keys, scalars, Wolff probes)
    from peapods_tpu_torch.engine import loop

    sim = models[1]._sim
    cfg = sim_config(sim, c["kw"])
    t0 = time.perf_counter()
    loop._event_tables(sim.rt, cfg, sim.state["base_keys"], 0, 0, 256)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) * 1e6 / 256
    log(f"11 {name}", f"host: the overlap-move tables of a 256-sweep chunk take "
        f"{host_us:.1f} us per sweep against {1e6 / sweeps_s:.1f} us of wall time "
        "per sweep")
    log(f"11 {name}", f"{'x'.join(map(str, c['shape']))} {c['couplings']}, "
        f"{SG_T} temps x {SG_R} replicas x {SG_D} realizations, "
        f"{c['kw']['overlap_cluster_build_mode']} every 10 sweeps, {n} sweeps on "
        f"{dev}: launches {launches}; checksum {checks[0]} == {checks[1]}; sanity "
        f"ok: {', '.join(sane)}")
    log(f"11 {name}", f"<e>[0,-1] {e[0]:.5f}, {e[-1]:.5f}; <q^2>[0,-1] {q2[0]:.5f}, "
        f"{q2[-1]:.5f}; sg_binder[0] {float(models[0].sg_binder[0]):.4f}; accepted "
        f"swaps {int(pt['edge_acceptances'].sum())} of {int(pt['edge_attempts'].sum())}")
    log(f"11 {name}", f"kernel path: {sweeps_s:.1f} sweeps/s = "
        f"{sweeps_s * n_sites * SG_R * SG_T * SG_D:.4e} flips/s on {card} (median "
        f"of {', '.join(f'{x:.1f}' for x in rates)} sweeps/s)")
    return dict(model=models[1], result=r, sweeps_s=sweeps_s, launches=launches,
                kw=c["kw"], n_sites=n_sites, shape=c["shape"])


def hot_pq(run):
    """|<q>| and the P(q) asymmetry at config 4's hottest temperature."""
    r = run["result"]
    q = float(r["overlap"][-1])
    hist = np.asarray(r["overlap_histogram"][-1], np.float64)
    mid = (len(hist) - 1) // 2  # the bin of q = 0
    neg, pos = hist[:mid].sum(), hist[mid + 1:].sum()
    asym = abs(pos - neg) / hist.sum()
    tv = 0.5 * np.abs(hist - hist[::-1]).sum() / hist.sum()
    if not (abs(q) < Q_HOT_TOL and asym < PQ_ASYM_TOL):
        raise AssertionError(f"config 4 hottest T: <q> {q}, P(q) asymmetry {asym}")
    log("12 physics", f"config4 at T = 2.2: <q> {q:.5f} (tolerance {Q_HOT_TOL}); "
        f"P(q > 0) - P(q < 0) = {(pos - neg) / hist.sum():.5f} (tolerance "
        f"{PQ_ASYM_TOL}); total variation of P(q) against P(-q) {tv:.4f} ok")


def glass_4x4_exact(J, T):
    """Exact <e> per spin and <q^2> = sum_ij <s_i s_j>^2 / N^2 of a 4x4
    +-J glass (forward couplings J [16, 2])."""
    n = 16
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    idx = np.arange(16).reshape(4, 4)
    fwd = np.stack([np.roll(idx, -1, 0), np.roll(idx, -1, 1)], -1).reshape(n, 2)
    E = sum((states * states[:, fwd[:, k]] * J[:, k]).sum(1) for k in range(2))
    E = E.astype(np.float64)
    w = np.exp((E - E.max()) / T)
    w /= w.sum()
    corr = (states.T * w) @ states
    return (E * w).sum() / n, (corr**2).sum() / n**2


def glass_physics(dev):
    """A fixed 4x4 +-J glass with R = 2 and 3 temperatures, PT every sweep
    and each overlap move (Wolff; Joerg and CMR also SW), against exact
    enumeration."""
    from peapods_tpu_torch import Ising

    rng = np.random.default_rng(44)
    J = rng.choice([-1.0, 1.0], size=(4, 4, 2)).astype(np.float32)
    temps = np.array([0.8, 1.3, 2.0], np.float32)
    exact = [glass_4x4_exact(J.reshape(16, 2), float(t)) for t in temps]
    worst = (0.0, 0.0)
    for build, mode in (("houdayer", "wolff"), ("jorg", "wolff"), ("cmr", "wolff"),
                        ("jorg", "sw"), ("cmr", "sw")):
        m = Ising((4, 4), couplings=J, temperatures=temps, n_replicas=2, seed=7,
                  device=dev)
        m.sample(GLASS_SWEEPS, pt_interval=1, overlap_cluster_update_interval=1,
                 overlap_cluster_build_mode=build, overlap_cluster_mode=mode,
                 warmup_ratio=0.1)
        de = np.abs(m.energies_avg - [x[0] for x in exact])
        dq = np.abs(m.overlap2 - [x[1] for x in exact])
        if not ((de < GLASS_E_TOL).all() and (dq < GLASS_Q2_TOL).all()):
            raise AssertionError(f"4x4 glass ({build}, {mode}): |dE| {de}, |dq2| {dq}")
        worst = (max(worst[0], float(de.max())), max(worst[1], float(dq.max())))
        log("12 physics", f"4x4 +-J glass, R=2, T {temps.tolist()}, {build} ({mode}) "
            f"every sweep + PT, {GLASS_SWEEPS} sweeps on {dev}: <E> "
            f"{np.round(m.energies_avg, 4).tolist()} (exact "
            f"{[round(x[0], 4) for x in exact]}), <q^2> "
            f"{np.round(m.overlap2, 4).tolist()} (exact "
            f"{[round(x[1], 4) for x in exact]}) ok")
    log("12 physics", f"4x4 glass: largest |dE| {worst[0]:.4f} (tolerance "
        f"{GLASS_E_TOL}), largest |dq2| {worst[1]:.4f} (tolerance {GLASS_Q2_TOL})")


def pair_inputs(run, dev):
    """The replica path's kernel inputs on a config's current state."""
    sim = run["model"]._sim
    rt, st = sim.rt, sim.state
    d, s = rt.n_disorder, rt.n_systems
    return dict(rt=rt, spins=st["spins"], sid=st["system_ids"].view(d, s),
                grid=st["spins"].view(d, s, *rt.lattice.shape))


def colour_ties(x, words, colour, gibbs=False):
    """Active sites of a colour pass whose uniform lies within TIE_ULPS ulp
    of its acceptance on the pass's input, by slot: bool [d, S, *shape]."""
    from peapods_tpu_torch.ops.rng import colour_uniforms
    from peapods_tpu_torch.ops.sweep import acceptance, colour_mask, local_field

    rt = x["rt"]
    shape = rt.lattice.shape
    nd = len(shape)
    d, s = x["sid"].shape
    di = torch.arange(d, device=x["sid"].device)[:, None]
    sp = x["grid"][di, x["sid"].long()].float()
    field = local_field(sp, rt.jgrids[:, None], nd)
    inv = (1.0 / (0.5 * rt.slot_temps)).reshape((1, s) + (1,) * nd)
    p = acceptance((-sp * field) * inv, gibbs=gibbs)
    u = colour_uniforms(words, s, colour, shape)
    ulp = torch.nextafter(p, torch.full_like(p, np.inf)) - p
    return ((u - p).abs() <= TIE_ULPS * ulp) & colour_mask(shape, colour, sp.device)


def check_pair_kernels(runs, dev, rng):
    """Every replica-path kernel against its plain version on each config's
    equilibrated state (at its full width): colour_pass 3D (spins equal
    apart from counted ulp ties), pair_overlap (exact), pt_step on R ladders
    with both schedules (bitwise), each overlap mode x {Wolff, SW} (spins and
    labels bitwise; Houdayer keeps E_a + E_b of every task) and
    energy_partials.  Then the plain versions' times and the bounds."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import mega, megapair, overlap
    from peapods_tpu_torch.ops.energy import bond_sums
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems
    from peapods_tpu_torch.ops.tempering import init_trip_state, pt_draws_pairs

    out = {}
    for name, run in runs.items():
        x = pair_inputs(run, dev)
        rt = x["rt"]
        shape = rt.lattice.shape
        d, s = x["sid"].shape
        n = rt.n_spins
        rec = {}
        # the limit of |e_kernel - e_plain| per system (E_SUM_TOL)
        e_lim = E_SUM_TOL * rt.coup.double().abs().sum((1, 2))[:, None]
        # colour_pass
        words = torch.from_numpy(rng.integers(-2**31, 2**31, (d, 2)).astype(
            np.int32)).to(dev)
        ties, err, worst = 0, 0.0, 0.0
        for colour in (0, 1):
            tie = colour_ties(x, words, colour)
            a, b = x["grid"].clone(), x["grid"].clone()
            pk = mega.colour_pass(a, rt.jgrids, x["sid"], rt.slot_temps, words, colour,
                                  gibbs=False)
            pp = mega.colour_pass_plain(b, rt.jgrids, x["sid"], rt.slot_temps, words,
                                        colour, gibbs=False)
            torch.cuda.synchronize()
            di = torch.arange(d, device=dev)[:, None]
            diff = a[di, x["sid"].long()] != b[di, x["sid"].long()]
            if (diff & ~tie).any():
                raise AssertionError(f"{name} colour_pass: {int((diff & ~tie).sum())} "
                                     "spins differ away from ulp ties")
            ties += int((diff & tie).sum())
            if pk is not None:
                if not torch.equal(pk[1].sum(-1), pp[1].sum(-1)):
                    raise AssertionError(f"{name} colour_pass: m differs")
                de = (pk[0].double().sum(-1) - pp[0].double().sum(-1)).abs()
                err = float(de.max() / n)
                worst = float((de / e_lim).max())
                if (rt.lattice.shape == (8, 8, 8) and err) or worst > 1.0:
                    raise AssertionError(f"{name} colour_pass: e differs by {err} per "
                                         f"spin, {worst} of the limit")
        if ties > MAX_TIE_SHARE * d * s * n:
            raise AssertionError(f"{name}: {ties} ulp ties in {d * s * n} sites")
        rec["colour_pass"] = dict(max_abs_err=err, ties=ties)
        log("13 kernel-vs-plain", f"{name} colour_pass ok: {d * s * n} sites, 0 "
            f"differ but {ties} ulp ties; max |e_kernel - e_plain| per spin {err}, "
            f"{worst:.4f} of the limit {E_SUM_TOL} sum|J| per system (+-J: exact)")
        # pair_overlap
        cols = rt.n_pairs * rt.n_temps
        qs = torch.empty((d, cols), dtype=torch.int32, device=dev)
        ql = torch.empty_like(qs)
        megapair.pair_overlap(x["spins"], x["sid"], qs, ql, shape=shape,
                              n_replicas=rt.n_replicas)
        ps, pl = megapair.pair_overlap_plain(x["spins"], x["sid"], shape, rt.n_replicas)
        torch.cuda.synchronize()
        if not (torch.equal(qs, ps) and torch.equal(ql, pl)):
            raise AssertionError(f"{name} pair_overlap differs")
        rec["pair_overlap"] = dict(max_abs_err=0.0)
        log("13 kernel-vs-plain", f"{name} pair_overlap ok: {d * cols} (pair, "
            "temperature) sums exact")
        # pt_step on R ladders: the main path's partials, both schedules
        e_part, m_part = mega.colour_pass(x["grid"].clone(), rt.jgrids, x["sid"],
                                          rt.slot_temps, words, 1, gibbs=False)
        hot, cold = rt.hot_slot, rt.cold_slot
        for pt_full in (False, True):
            pw = torch.from_numpy(rng.integers(-2**31, 2**31, (64, d, 2)).astype(
                np.int32)).to(dev)
            dr = pt_draws_pairs(pw, rt.n_replicas, rt.n_temps - 1, pt_full=pt_full)
            if not pt_full:
                dr = (dr[0].to(torch.int32), dr[1])
            states = []
            for fn in (mega.pt_step, mega.pt_step_plain):
                sid = x["sid"].clone()
                i32 = dict(dtype=torch.int32, device=dev)
                st = dict(sid=sid, ea=torch.zeros((d, rt.n_temps - 1), **i32),
                          ec=torch.zeros((d, rt.n_temps - 1), **i32),
                          rt=torch.zeros((d, s), **i32),
                          ts=init_trip_state(sid.view(d, rt.n_replicas, -1), hot),
                          sys_temps=slot_temps_for_systems(sid, rt.slot_temps),
                          e=torch.empty((d, 64, s), device=dev),
                          m=torch.empty((d, 64, s), **i32), parity=0)
                for t in range(64):
                    st["parity"] = fn(
                        e_part.roll(t, 1), m_part, st["e"][:, t], st["m"][:, t],
                        st["sid"], st["ea"], st["ec"], st["rt"], st["ts"],
                        rt.slot_temps, dr[t] if pt_full else (dr[0][t], dr[1][t]),
                        st["sys_temps"], do_pt=True, pt_full=pt_full,
                        parity=st["parity"], hot_slot=hot, cold_slot=cold, n_spins=n,
                        n_replicas=rt.n_replicas)
                states.append(st)
            torch.cuda.synchronize()
            k, p = states
            for key in ("sid", "ea", "ec", "rt", "ts", "sys_temps", "e", "m"):
                if not torch.equal(k[key], p[key]):
                    raise AssertionError(f"{name} pt_step: {key} differs")
            if k["parity"] != p["parity"] or not int(k["ec"].sum()):
                raise AssertionError(f"{name} pt_step: parity or no swap")
            log("13 kernel-vs-plain", f"{name} pt_step ok ({'full_ladder' if pt_full else 'single_random_edge'}, "
                f"{d} x {rt.n_replicas} ladders of {rt.n_temps}): 64 events bitwise, "
                f"{int(k['ec'].sum())} of {int(k['ea'].sum())} swaps accepted")
        rec["pt_step"] = dict(max_abs_err=0.0)
        # the overlap moves
        moved = {}
        for kind in ("houdayer", "jorg", "cmr"):
            for wolff in (True, False):
                keys = rng.integers(0, 2**32, (d, 2), dtype=np.uint64).astype(np.uint32)
                tasks, tkeys = seeds.overlap_tasks(keys, [5], rt.n_replicas, rt.n_temps)
                scal, probes = seeds.event_scalars(kind, wolff, tkeys[0], n)
                up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
                tab = (up(tasks[0]), up(scal.reshape(-1, 6)), up(probes.reshape(-1, 64)),
                       up(tkeys[0].view(np.int32).reshape(-1, 2)))
                a, b = x["spins"].clone(), x["spins"].clone()
                kw = dict(kind=kind, wolff=wolff, shape=shape, with_labels=True)
                lk = overlap.overlap_event(a, x["sid"], tab[0], rt.coup, rt.temps,
                                           *tab[1:], **kw)
                lp = overlap.overlap_event_plain(b, x["sid"], tab[0], rt.coup, rt.temps,
                                                 *tab[1:], **kw)
                torch.cuda.synchronize()
                bad = {"spins": int((a != b).sum()), "labels": int((lk[0] != lp[0]).sum()),
                       "blue labels": 0 if lk[1] is None else int((lk[1] != lp[1]).sum())}
                flipped = int((a != x["spins"]).sum())
                n_clusters = int((lk[0] == torch.arange(n, device=dev)).sum())
                msg = (f"{name} {kind} ({'wolff' if wolff else 'sw'}): mismatches {bad}; "
                       f"{flipped} spins flipped, {n_clusters} clusters")
                if any(bad.values()):
                    raise AssertionError(msg)
                if kind == "houdayer":
                    sys, _, _ = overlap.gather_tasks(x["spins"], x["sid"], tab[0],
                                                     rt.n_temps)
                    di = torch.arange(d, device=dev)[:, None, None]
                    pair = lambda e: (e[di, sys[..., 0]].double()  # noqa: E731
                                      + e[di, sys[..., 1]].double())
                    # summed in float64: +-J exactly, gaussian to ~1e-12
                    cd = rt.coup.double()[:, None]
                    before = pair(bond_sums(x["spins"], cd, shape))
                    after = pair(bond_sums(a, cd, shape))
                    drift = float((after - before).abs().max())
                    tol = 0.0 if name == "config4" else 1e-9
                    if drift > tol:
                        raise AssertionError(f"{msg}; E_a + E_b moved by {drift}")
                    msg += f"; E_a + E_b of every task kept (max drift {drift}, tolerance {tol})"
                log("13 kernel-vs-plain", msg + " ok")
                moved[(kind, wolff)] = tab
        # energy_partials
        ek, mk = overlap.energy_partials(x["spins"], rt.coup, shape)
        ep, mp = overlap.energy_partials_plain(x["spins"], rt.coup, shape)
        torch.cuda.synchronize()
        de = (ek.double().sum(-1) - ep.double().sum(-1)).abs()
        e_err = float(de.max())
        worst = float((de / e_lim).max())
        if (not torch.equal(mk.sum(-1), mp.sum(-1)) or (name == "config4" and e_err)
                or worst > 1.0):
            raise AssertionError(f"{name} energy_partials differ ({e_err}, {worst} of "
                                 "the limit)")
        rec["energy_partials"] = dict(max_abs_err=e_err)
        log("13 kernel-vs-plain", f"{name} energy_partials ok: m exact, max |e_kernel - "
            f"e_plain| {e_err}, {worst:.4f} of the limit {E_SUM_TOL} sum|J| per system "
            "(+-J: exact; gaussian: f32 sums in another order)")
        for k in move_kernels(run["kw"]["overlap_cluster_build_mode"]):
            rec[k] = dict(max_abs_err=0.0)
        rec["_tables"] = moved
        out[name] = rec
    return out


def pair_times(runs, checks, dev):
    """Plain versions' times and the bounds of each replica-path kernel at
    each config's main-path shapes."""
    from peapods_tpu_torch.ops import mega, megapair, overlap

    for name, run in runs.items():
        x = pair_inputs(run, dev)
        rt = x["rt"]
        shape = rt.lattice.shape
        nd = len(shape)
        d, s = x["sid"].shape
        n = rt.n_spins
        rec = checks[name]
        words = torch.zeros((d, 2), dtype=torch.int32, device=dev)
        g = x["grid"].clone()
        args = (rt.jgrids, x["sid"], rt.slot_temps, words)
        rec["colour_pass"]["plain_ms"] = wall_ms(
            lambda: mega.colour_pass_plain(g, *args, 1, gibbs=False), 3)
        sp = x["spins"]
        rec["pair_overlap"]["plain_ms"] = wall_ms(
            lambda: megapair.pair_overlap_plain(sp, x["sid"], shape, rt.n_replicas), 5)
        e_part, m_part = mega.colour_pass(g, *args, 1, gibbs=False)
        i32 = dict(dtype=torch.int32, device=dev)
        pt_args = (e_part, m_part, torch.empty((d, s), device=dev),
                   torch.empty((d, s), **i32), x["sid"].clone(),
                   torch.zeros((d, rt.n_temps - 1), **i32),
                   torch.zeros((d, rt.n_temps - 1), **i32), torch.zeros((d, s), **i32),
                   torch.zeros((d, s), **i32), rt.slot_temps)
        full = "pt_schedule" in run["kw"]
        draws = (torch.full((d, rt.n_replicas, 2, rt.n_temps - 1), 0.5, device=dev)
                 if full else (torch.zeros((d, rt.n_replicas), **i32),
                               torch.full((d, rt.n_replicas), 0.5, device=dev)))
        kw = dict(do_pt=True, pt_full=full, parity=0, hot_slot=rt.hot_slot,
                  cold_slot=rt.cold_slot, n_spins=n, n_replicas=rt.n_replicas)
        rec["pt_step"]["plain_ms"] = wall_ms(lambda: mega.pt_step_plain(
            *pt_args, draws, torch.empty((d, s), device=dev), **kw), 10)
        rec["energy_partials"]["plain_ms"] = wall_ms(
            lambda: overlap.energy_partials_plain(sp, rt.coup, shape), 5)
        # the move's plain version is one function for all of its kernels:
        # its time, on the main path's kinds, stands beside each of them
        plain_move = {}
        build = run["kw"]["overlap_cluster_build_mode"]
        for kind in build.split("+"):
            tab = rec["_tables"][(kind, True)]
            plain_move[kind] = wall_ms(lambda: overlap.overlap_event_plain(
                sp.clone(), x["sid"], tab[0], rt.coup, rt.temps, *tab[1:], kind=kind,
                wolff=True, shape=shape), 3)
        for k in move_kernels(build):
            rec[k]["plain_ms"] = max(plain_move.values())
            rec[k]["plain_is"] = "the whole move: " + ", ".join(
                f"{kind} {ms:.4f} ms" for kind, ms in plain_move.items())
        # bounds: bytes each input read once and each output written once
        b_tasks = d * rt.n_temps * rt.n_pairs
        sys_bytes = d * s * n
        cb = 4 * nd * d * n
        bounds = {
            # spins, grids, sid, temps in; the active half written
            "colour_pass": (sys_bytes + 2 * nd * 4 * d * n + sys_bytes // 2,
                            (6 * nd + 8) * sys_bytes // 2),
            # the paired systems' spins in, two ints per (pair, T) out
            "pair_overlap": (2 * d * rt.n_pairs * rt.n_temps * n + 8 * b_tasks,
                             (2 + 2 * nd) * 2 * d * rt.n_pairs * rt.n_temps * n // 2),
            "pt_step": (8 * d * s * e_part.shape[2] + 16 * d * s, 10 * d * s),
            # both replicas' spins and couplings in; state bytes, parents out
            "ov_bonds": (2 * b_tasks * n + cb + 5 * b_tasks * n, 12 * nd * b_tasks * n),
            "fk_link": (5 * b_tasks * n, 0),
            "ov_mid": (5 * b_tasks * n + cb + 5 * b_tasks * n, 12 * nd * b_tasks * n),
            "ov_finish": (2 * b_tasks * n + 5 * b_tasks * n + 2 * b_tasks * n,
                          4 * b_tasks * n),
            "energy_partials": (sys_bytes + cb + 8 * d * s * ((n + 255) // 256),
                                3 * nd * sys_bytes),
        }
        for k, (nbytes, flops) in bounds.items():
            if k in rec:
                rec[k]["bound_ms"], rec[k]["bound_by"] = bound(nbytes, flops)
        if "houdn_bonds" in rec:
            # pair Houdayer in the config's Wolff form, no labels: the spins
            # that the check's move flips on this state
            tab = rec["_tables"][("houdayer", True)]
            moved_sp = sp.clone()
            overlap.overlap_event_plain(moved_sp, x["sid"], tab[0], rt.coup, rt.temps,
                                        *tab[1:], kind="houdayer", wolff=True,
                                        shape=shape)
            for k, v in houdn_bounds(b_tasks, n, 2, d, s, wolff=True, labels=False,
                                     flipped=int((moved_sp != sp).sum())).items():
                rec[k]["bound_ms"], rec[k]["bound_by"] = v
        rec.pop("_tables")


def pair_profile(run, n, card, name, phase="14 times"):
    """Device time per launch and per sweep of each replica-path kernel over
    a profiled window of ``n`` sweeps of the main path, and the busy share
    of the unprofiled wall time per sweep."""
    from torch.profiler import ProfilerActivity, profile

    model = run["model"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.sample(n, "metropolis", **dict(run["kw"], warmup_ratio=0.0))
        torch.cuda.synchronize()
    acc, other = {}, 0.0
    for ev in prof.key_averages():
        if ev.self_device_time_total <= 0:
            continue
        hit = [k for k in PAIR_KERNELS if f"{k}_kernel" in ev.key]
        if hit:
            add_kernel_time(acc, hit[0], ev)
        else:
            other += ev.self_device_time_total / n
    per_launch = {k: t / c for k, (t, c) in acc.items()}
    per_sweep = {k: t / n for k, (t, c) in acc.items()}
    missing = [k for k in run["launches"] if k not in per_launch]
    if missing:
        raise AssertionError(f"the profiler saw no device time for {missing}")
    busy = sum(per_sweep.values()) + other
    log(phase, f"{name} device us per sweep: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_sweep.items())
        + f", other device work {other:.3f}, sum {busy:.3f} against "
        f"{1e6 / run['sweeps_s']:.3f} us of wall time per sweep: the device is busy "
        f"{busy * run['sweeps_s'] / 1e6:.3f} of it (on {card})")
    return per_launch


# ------------------------------------------------ the coloured lattices


NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
# config 2 at full width (benchmarks/driver_configs.py:50-59): 8 systems of
# 32 x 32 triangular, Metropolis, Wolff every 2 sweeps, no PT
CONFIG2 = dict(shape=(32, 32), geometry="triangular", t=(3.0, 4.4), n_temps=8,
               seed=2, sweeps=8192,
               kw=dict(cluster_update_interval=2, cluster_mode="wolff"))
# the per-sweep path's other lattices, cut in depth (each TPU kernel the
# reference runs there): 3D cubic with one replica near T_c = 4.5115 (SW
# and PT every sweep), BCC (T_c ~ 6.35) and FCC (T_c ~ 9.79) with PT, and
# the next-nearest-neighbour square table (T_c ~ 5.26), Metropolis only
NB_PATHS = {
    "cubic32": dict(shape=(32, 32, 32), geometry=None, t=(4.0, 5.0), n_temps=16,
                    seed=6, sweeps=256, kw=dict(cluster_update_interval=1,
                                                cluster_mode="sw", pt_interval=1),
                    replaces="peapods_tpu/ops/pallas_sweep3d.py:306",
                    measure_replaces="peapods_tpu/ops/pallas_sweep3d.py:393"),
    "bcc16": dict(shape=(16, 16, 16), geometry="bcc", t=(5.5, 7.5), n_temps=8,
                  seed=7, sweeps=256, kw=dict(pt_interval=1),
                  replaces="peapods_tpu/ops/pallas_sweep_diag.py:445",
                  measure_replaces="peapods_tpu/ops/pallas_sweep_diag.py:470"),
    "fcc16": dict(shape=(16, 16, 16), geometry="fcc", t=(8.5, 11.0), n_temps=8,
                  seed=8, sweeps=256, kw=dict(pt_interval=1),
                  replaces="peapods_tpu/ops/pallas_sweep_diag.py:445",
                  measure_replaces="peapods_tpu/ops/pallas_sweep_diag.py:470"),
    "nnn64": dict(shape=(64, 64), geometry=NNN, t=(4.5, 6.0), n_temps=8, seed=9,
                  sweeps=256, kw={},
                  replaces="peapods_tpu/ops/pallas_sweep_diag.py:540",
                  measure_replaces="peapods_tpu/ops/pallas_sweep_diag.py:562"),
}
NB_SRC = "peapods_tpu_torch/csrc/sweep_nb.cu"
TRI_REPLACES = "peapods_tpu/ops/pallas_sweep_tri.py:338"  # sweep_tri_packed (W < 128)
TRI_MEASURE_REPLACES = "peapods_tpu/ops/pallas_sweep_tri.py:238"  # sweep_tri_fused


def nb_model(c, dev, seed=None):
    from peapods_tpu_torch import Ising

    geo = c["geometry"]
    kw = (dict(geometry=geo) if isinstance(geo, str)
          else dict(neighbor_offsets=geo) if geo is not None else {})
    return Ising(c["shape"], temperatures=np.geomspace(*c["t"], c["n_temps"]),
                 seed=c["seed"] if seed is None else seed, device=dev, **kw)


def nb_want(model, kw, n):
    """Launches of ``n`` sweeps from sweep 0 (all recorded) on a coloured
    lattice: a ``sweep_nb`` launch per colour; on cluster sweeps the FK
    kernels (square, triangular, cubic: their update measures) or the
    staged path's ``fk_bonds_nb``, ``cc_link``, ``cc_label`` and, to update,
    ``fk_finish`` (BCC, FCC, offset tables); ``measure_nb`` on every sweep
    the FK kernels did not measure; and one ``pt_step``."""
    from peapods_tpu_torch.ops.fk import fused_lattice

    lat = model._sim.rt.lattice
    k = kw.get("cluster_update_interval")
    n_fk = len(range(0, n, k)) if k else 0
    update = kw.get("cluster_action", "update") == "update"
    want = {"sweep_nb": lat.n_colors * n, "pt_step": n}
    if fused_lattice(lat):
        want.update({f: n_fk for f in ("fk_bonds", "fk_finish")})
        want.update(link_want(lat.shape, model._sim.rt.n_disorder * model._sim.rt.n_systems,
                              n_fk))
        want["measure_nb"] = n - n_fk if update else n
    else:
        want.update(fk_bonds_nb=n_fk, cc_link=n_fk, cc_label=n_fk,
                    fk_finish=n_fk if update else 0, measure_nb=n)
    return {key: v for key, v in want.items() if v}


def batch_means(model, kw, n_batches, n_sweeps):
    """Mean energy per spin at each temperature and its standard error over
    batches of consecutive sample() calls."""
    e = []
    for _ in range(n_batches):
        model.sample(n_sweeps, "metropolis", **dict(kw, warmup_ratio=0.0))
        e.append(np.asarray(model.energies_avg, np.float64))
    e = np.array(e)
    return e.mean(0), e.std(0, ddof=1) / np.sqrt(n_batches)


def config2(dev, card):
    """Config 2 through Ising.sample at full width: launch counts, two equal
    checksums, sanity, the rate (median of three warm calls), and Wolff's
    <e> per temperature against a Metropolis-only run (with PT) of the same
    model."""
    c = CONFIG2
    n, kw = c["sweeps"], dict(c["kw"], warmup_ratio=0.0)
    checks, models = [], []
    for run in range(2):
        model = nb_model(c, dev)
        torch.cuda.synchronize()
        reset_cluster_counts()
        result = model.sample(n, "metropolis", **kw)
        torch.cuda.synchronize()
        if run == 0:
            launches = cluster_counts()
            r0 = result
        checks.append(state_checksum(model._sim, result))
        models.append(model)
    want = nb_want(models[0], kw, n)
    if launches != want:
        raise AssertionError(f"config 2 launch counts {launches}, expected {want}")
    if checks[0] != checks[1]:
        raise AssertionError(f"config 2 checksums differ: {checks}")
    e, m2 = r0["energies"], r0["mags2"]
    sane = {"finite": bool(np.isfinite(e).all() and np.isfinite(m2).all()),
            "<e> falls with T": bool(e[0] > e[-1]),
            "<m2> falls with T": bool(m2[0] > m2[-1]),
            "<e> in (0, 3]": bool(((e > 0) & (e <= 3)).all())}
    if not all(sane.values()):
        raise AssertionError(f"config 2 sanity: {sane}")
    per_sweep = {k: v / n for k, v in launches.items()}
    shape = "x".join(map(str, c["shape"]))
    log("15 config-2", f"{shape} triangular, {c['n_temps']} temps geomspace{c['t']}, "
        f"Wolff every 2 sweeps, {n} sweeps on {dev}: launches {launches} "
        f"({per_sweep} per sweep); checksum {checks[0]} == {checks[1]}; sanity ok: "
        f"{', '.join(sane)}")
    log("15 config-2", f"<e> {np.round(e, 5).tolist()}; <m2> {np.round(m2, 5).tolist()}")
    sweeps_s, rates = warm_rate(models[1], n, c["kw"])
    log("15 config-2", f"kernel path: {sweeps_s:.1f} sweeps/s = "
        f"{sweeps_s * c['n_temps'] * np.prod(c['shape']):.4e} flips/s (single-spin "
        "attempts) on "
        f"{card} (median of {', '.join(f'{r:.1f}' for r in rates)} sweeps/s)")

    # Wolff against Metropolis with PT every sweep, batch means per T
    e_w, se_w = batch_means(models[0], c["kw"], 16, 512)
    metro = nb_model(c, dev)
    kw_m = dict(pt_interval=1)
    metro.sample(2048, "metropolis", **dict(kw_m, warmup_ratio=0.0))
    e_m, se_m = batch_means(metro, kw_m, 16, 1024)
    z = (e_w - e_m) / np.hypot(se_w, se_m)
    if not (np.abs(z) < 4).all():
        raise AssertionError(f"config 2 Wolff <e> {e_w} against Metropolis {e_m}: "
                             f"z = {z}")
    log("15 config-2", f"Wolff <e> against Metropolis + PT (16 batches of 512 / 1024 "
        f"sweeps) per T: |z| <= {np.abs(z).max():.3f} (limit 4) ok; Wolff "
        f"{np.round(e_w, 5).tolist()} +- {np.round(se_w, 5).tolist()}, Metropolis "
        f"{np.round(e_m, 5).tolist()} +- {np.round(se_m, 5).tolist()}")
    return dict(model=models[1], sweeps_s=sweeps_s, launches=launches, kw=c["kw"])


def nb_inputs(dev, rng, c, couplings):
    """A coloured lattice's sweep inputs at a path's shape (``c``: an entry of
    ``NB_CHECKS``): couplings and their backward twins [1, n, n_nb], the
    colour table, spins [1, S, n], temperatures in the path's range, and key
    words."""
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

    geometry, n_sys = c["geometry"], c["n_temps"]
    offsets = GEOMETRY_OFFSETS[geometry] if isinstance(geometry, str) else geometry
    lat = Lattice(c["shape"], offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    coup = (rng.choice([-1.0, 1.0], size=(1, n, nb)) if couplings == "pm"
            else rng.standard_normal((1, n, nb))).astype(np.float32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return lat, dict(
        spins=up(rng.choice([-1, 1], size=(1, n_sys, n)).astype(np.int8)),
        coup=up(coup), coup_bwd=up(coup[:, lat.bwd, np.arange(nb)[None, :]]),
        colours=up(lat.colors.astype(np.uint8)),
        sys_temps=up(rng.uniform(*c["t"], (1, n_sys)).astype(np.float32)),
        words=up(rng.integers(-2**31, 2**31, (1, 2)).astype(np.int32)))


def nb_pass_ties(lat, x, s, colour, gibbs):
    """Sites of one colour pass whose decision lies within TIE_ULPS ulp of
    its threshold on the pass's input: bool [1, S, n]."""
    from peapods_tpu_torch.ops.rng import site_uniforms
    from peapods_tpu_torch.ops.sweep import acceptance, nb_local_fields

    sf = s.float()
    eng = -sf * nb_local_fields(sf, x["coup"][:, None], x["coup_bwd"][:, None], lat)
    u = site_uniforms(x["words"], s.shape[1], colour, lat.n_spins)
    t = x["sys_temps"][..., None]
    if gibbs:
        a, b = eng, (t * 0.5) * torch.log(u / (1.0 - u))
    else:
        a, b = u, acceptance(eng * (1.0 / (t * 0.5)), gibbs=False)
    ulp = (torch.nextafter(b, torch.full_like(b, np.inf)) - b).abs()
    return ((a - b).abs() <= TIE_ULPS * ulp) & (x["colours"] == colour)


# the shapes at which sweep_nb and measure_nb are checked: each path's
NB_CHECKS = {"config2": CONFIG2, **NB_PATHS}


def check_nb_kernels(dev, rng):
    """sweep_nb and measure_nb against their plain versions at the main
    paths' shapes, +-1 and gaussian couplings, Metropolis and Gibbs: each
    colour pass alone (a colour table that hides the other colours), spins
    equal apart from counted ulp ties; (e, m) partial sums bitwise for +-1,
    within E_SUM_TOL sum |J| for gaussian couplings.  Then the per-launch
    times (CUDA events), the plain versions' times and the bounds."""
    from peapods_tpu_torch.ops import energy, sweep

    out = {}
    for name, c in NB_CHECKS.items():
        shape, n_sys = c["shape"], c["n_temps"]
        rec_s = dict(max_abs_err=0.0, ulp_ties=0, decisions=0)
        rec_m = dict(max_abs_err=0.0)
        for couplings in ("pm", "gauss"):
            lat, x = nb_inputs(dev, rng, c, couplings)
            n = lat.n_spins
            s = x["spins"]
            for gibbs in (False, True):
                for colour in range(lat.n_colors):
                    only = torch.where(x["colours"] == colour, x["colours"],
                                       torch.full_like(x["colours"], 255))
                    tie = nb_pass_ties(lat, x, s, colour, gibbs)
                    a, b = s.clone(), s.clone()
                    args = (x["coup"], x["coup_bwd"], only, x["sys_temps"], x["words"],
                            lat)
                    sweep.sweep_nb(a, *args, gibbs=gibbs)
                    sweep.sweep_nb_plain(b, *args, gibbs=gibbs)
                    torch.cuda.synchronize()
                    diff = a != b
                    if (diff & ~tie).any():
                        raise AssertionError(
                            f"sweep_nb on {name} ({couplings}, gibbs={gibbs}, colour "
                            f"{colour}): {int((diff & ~tie).sum())} spins differ away "
                            "from ulp ties")
                    rec_s["ulp_ties"] += int((diff & tie).sum())
                    rec_s["decisions"] += int((x["colours"] == colour).sum()) * n_sys
                    rec_s["max_abs_err"] = max(rec_s["max_abs_err"],
                                               float((a.float() - b.float()).abs().max()))
                    s = b  # the next pass starts from the plain output
                ek, mk = energy.measure_nb(s, x["coup"], lat)
                ep, mp = energy.measure_nb_plain(s, x["coup"], lat)
                torch.cuda.synchronize()
                if not torch.equal(mk.sum(-1), mp.sum(-1)):
                    raise AssertionError(f"measure_nb on {name}: m differs")
                de = (ek.double().sum(-1) - ep.double().sum(-1)).abs()
                lim = E_SUM_TOL * x["coup"].double().abs().sum()
                if (couplings == "pm" and float(de.max())) or float(de.max()) > lim:
                    raise AssertionError(f"measure_nb on {name} ({couplings}): e "
                                         f"differs by {float(de.max())} (limit {lim})")
                rec_m["max_abs_err"] = max(rec_m["max_abs_err"], float(de.max()) / n)
            if couplings == "pm":
                pm_inputs = (lat, x)
        if rec_s["ulp_ties"] > MAX_TIE_SHARE * rec_s["decisions"]:
            raise AssertionError(f"sweep_nb on {name}: {rec_s['ulp_ties']} ulp ties in "
                                 f"{rec_s['decisions']} decisions")
        log("17 kernel-vs-plain", f"sweep_nb ok on {name} ({'x'.join(map(str, shape))}"
            f" x {n_sys} systems, {lat.n_colors} colours, +-1 and gaussian, "
            f"Metropolis and Gibbs): {rec_s['decisions']} decisions, 0 differ but "
            f"{rec_s['ulp_ties']} ulp ties; measure_nb ok: m exact, e bitwise (+-1), max "
            f"|e_kernel - e_plain| per spin {rec_m['max_abs_err']} (gaussian, limit "
            f"{E_SUM_TOL} sum |J|)")
        # times at this shape: one colour per launch
        lat, x = pm_inputs
        nc, nb, n = lat.n_colors, lat.n_neighbors, lat.n_spins
        sp = x["spins"].clone()
        args = (x["coup"], x["coup_bwd"], x["colours"], x["sys_temps"], x["words"], lat)
        rec_s["ms"] = gpu_ms(lambda: sweep.sweep_nb(sp, *args, gibbs=False), 50) / nc
        rec_s["plain_ms"] = wall_ms(
            lambda: sweep.sweep_nb_plain(sp, *args, gibbs=False), 3) / nc
        rec_m["ms"] = gpu_ms(lambda: energy.measure_nb(sp, x["coup"], lat), 50)
        rec_m["plain_ms"] = wall_ms(lambda: energy.measure_nb_plain(sp, x["coup"], lat), 5)
        sys_sites = n_sys * n
        active = sys_sites // nc
        # a pass: every spin (the neighbours), the active sites' forward and
        # backward couplings, the colour table in; the active spins out;
        # 4 n_nb + ~20 f32 operations per active site
        rec_s["bound_ms"], rec_s["bound_by"] = bound(
            sys_sites + 8 * nb * n // nc + n + 4 * n_sys + 8 + active,
            (4 * nb + 20) * active)
        # spins and forward couplings in, the partials out; 3 n_nb per site
        n_blocks = ((n + 3) // 4 + 255) // 256
        rec_m["bound_ms"], rec_m["bound_by"] = bound(
            sys_sites + 4 * nb * n + 8 * n_sys * n_blocks, 3 * nb * sys_sites)
        out[name] = dict(sweep_nb=rec_s, measure_nb=rec_m)
    return out


def check_sweep_2d_row4(dev, rng, card):
    """Row 4 (sweep_2d_packed, the TPU's square sweep for W < 128) is the
    function of sweep_2d at any width: sweep_2d against its plain version at
    32 x 32 x 16 systems, its time there, and its launches per sweep on a
    32^2 Ising run with a cluster phase."""
    from peapods_tpu_torch import Ising
    from peapods_tpu_torch.ops import sweep
    from peapods_tpu_torch.ops.sweep import pack_coupling_grids

    h = w = 32
    n_sys = 16
    coup = rng.choice([-1.0, 1.0], size=(1, h * w, 2)).astype(np.float32)
    jg = pack_coupling_grids(torch.from_numpy(coup), (h, w)).contiguous().to(dev)
    temps = torch.from_numpy(np.geomspace(1.8, 3.2, n_sys).astype(np.float32)[None]).to(dev)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (1, 2)).astype(np.int32)).to(dev)
    s0 = torch.from_numpy(rng.choice([-1, 1], size=(1, n_sys, h, w)).astype(np.int8)).to(dev)
    a, b = s0.clone(), s0.clone()
    for gibbs in (False, True):
        for _ in range(2):
            pk = sweep.sweep_2d(a, jg, temps, words, gibbs=gibbs, measure=True)
            pp = sweep.sweep_2d_plain(b, jg, temps, words, gibbs=gibbs, measure=True)
            torch.cuda.synchronize()
            if not (torch.equal(a, b) and torch.equal(pk[0].sum(-1), pp[0].sum(-1))
                    and torch.equal(pk[1].sum(-1), pp[1].sum(-1))):
                raise AssertionError(f"sweep_2d at 32x32 x 16 (gibbs={gibbs}) differs")
            words = words * 3 + 1
    ms = gpu_ms(lambda: sweep.sweep_2d(a, jg, temps, words, gibbs=False), 100) / 2
    plain = wall_ms(lambda: sweep.sweep_2d_plain(b, jg, temps, words, gibbs=False), 10) / 2
    n = n_sys * h * w
    bms, by = bound(n + 16 * h * w + n // 2, 20 * n // 2)
    model = Ising((h, w), temperatures=np.geomspace(1.8, 3.2, n_sys), seed=4, device=dev)
    reset_cluster_counts()
    model.sample(256, "metropolis", cluster_update_interval=1, cluster_mode="wolff",
                 warmup_ratio=0.0)
    torch.cuda.synchronize()
    launches = cluster_counts()["sweep_2d"]
    if launches != 512:
        raise AssertionError(f"32^2 Wolff run: {launches} sweep_2d launches, expected 512")
    log("17 kernel-vs-plain", f"row 4: sweep_2d ok at 32x32 x {n_sys} systems "
        f"(Metropolis and Gibbs, 4 sweeps, spins and (e, m) bitwise); "
        f"{ms:.5f} ms a launch (bound {bms:.5f} ms by {by}, plain {plain:.4f} ms), "
        f"{launches / 256:.0f} launches a sweep on a 32^2 x 16 Wolff run, on {card}")
    return dict(shape="32x32 x 16 systems", replaces="peapods_tpu/ops/pallas_sweep.py:847",
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                launches=launches)


def exact_moments(lat, T):
    """Exact <E>/N and <m^2> of a ferromagnet on a small lattice by
    enumeration of its states, the bonds from the forward table."""
    n = lat.n_spins
    states = (((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1) * 2 - 1)
    bonds = np.repeat(np.arange(n), lat.n_neighbors)
    E = (states[:, bonds] * states[:, lat.fwd.reshape(-1)]).sum(1).astype(np.float64)
    M = states.sum(1).astype(np.float64)
    w = np.exp((E - E.max()) / T)
    return (E * w).sum() / w.sum() / n, ((M / n) ** 2 * w).sum() / w.sum()


def exact_tri_4x4(dev):
    """The 4x4 triangular ferromagnet against exact enumeration, Metropolis
    and Wolff every sweep (8 chains of 4000 sweeps each)."""
    from peapods_tpu_torch import Ising
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice

    T = 4.0
    e_ex, m2_ex = exact_moments(Lattice((4, 4), GEOMETRY_OFFSETS["triangular"]), T)
    for name, kw in (("metropolis", {}),
                     ("wolff", dict(cluster_update_interval=1, cluster_mode="wolff"))):
        m = Ising((4, 4), geometry="triangular", temperatures=np.array([T], np.float32),
                  n_disorder=8, seed=11, device=dev)
        m.sample(4000, warmup_ratio=0.25, **kw)
        de, dm2 = abs(m.energies_avg[0] - e_ex), abs(m.mags2[0] - m2_ex)
        if not (de < 0.05 and dm2 < 0.06):
            raise AssertionError(f"4x4 triangular exact ({name}): |dE| {de}, |dm2| {dm2}")
        log("18 physics", f"4x4 triangular T={T} {name}, 8 chains x 4000 sweeps on {dev}: "
            f"<E> {m.energies_avg[0]:.5f} (exact {e_ex:.5f}), <m2> {m.mags2[0]:.5f} "
            f"(exact {m2_ex:.5f}) ok (tolerances 0.05, 0.06)")


def nb_path(name, dev, card):
    """A second path on a coloured lattice through Ising.sample: launch
    counts (zeroed just before, read just after), sanity, a checksum, and
    the rate of a second, warm call."""
    c = NB_PATHS[name]
    n = c["sweeps"]
    kw = dict(c["kw"], warmup_ratio=0.0)
    model = nb_model(c, dev)
    torch.cuda.synchronize()
    reset_cluster_counts()
    result = model.sample(n, "metropolis", **kw)
    torch.cuda.synchronize()
    launches = cluster_counts()
    want = nb_want(model, kw, n)
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches}, expected {want}")
    e = result["energies"]
    if not (np.isfinite(e).all() and e[0] > e[-1]):
        raise AssertionError(f"{name} sanity: energies {e}")
    check = state_checksum(model._sim, result)
    sweeps_s, _ = warm_rate(model, n, c["kw"], calls=1)
    n_sites = int(np.prod(c["shape"]))
    log("16 paths", f"{name}: {'x'.join(map(str, c['shape']))} x {c['n_temps']} temps "
        f"geomspace{c['t']}, {c['kw'] or 'Metropolis'}, {n} sweeps on {dev}: launches "
        f"{launches}; checksum {check}; <e>[0,-1] {e[0]:.5f}, {e[-1]:.5f}; "
        f"{sweeps_s:.1f} sweeps/s = {sweeps_s * n_sites * c['n_temps']:.4e} flips/s "
        f"on {card}")
    return dict(model=model, launches=launches, sweeps_s=sweeps_s, checksum=check)


def coloured_paths(dev, card):
    """Phases 15-19: config 2 at full width, then the 3D cubic, BCC, FCC and
    next-nearest-neighbour paths, every kernel of them against its plain
    version, row 4's sweep_2d at 32^2, the 4x4 triangular exact check, and
    per-launch device times over main-path windows."""
    c2 = config2(dev, card)
    nb_runs = {name: nb_path(name, dev, card) for name in NB_PATHS}
    rng = np.random.default_rng(2027)
    nbk = check_nb_kernels(dev, rng)
    row4 = check_sweep_2d_row4(dev, rng, card)
    fk_models = {"config2": c2["model"], "cubic32": nb_runs["cubic32"]["model"]}
    fk_nb = check_fk(fk_models, dev, rng, card, phase="17 kernel-vs-plain")
    pt_nb = check_pt_step_per_sweep(fk_models, dev, phase="17 kernel-vs-plain")
    exact_tri_4x4(dev)
    # per-launch device times over main-path windows
    windows = {"config2": (c2, CONFIG2["kw"], 512),
               **{k: (v, NB_PATHS[k]["kw"], 32 if k == "cubic32" else 64)
                  for k, v in nb_runs.items()}}
    nb_us = {}
    for name, (run, kw, n_win) in windows.items():
        nb_us[name], line = profile_window(run["model"], kw, run["sweeps_s"], n_win,
                                           names=tuple(run["launches"]))
        log("19 times", f"{name} {line} (on {card})")
    for name, (run, _, _) in windows.items():
        parts = []
        for k, v in nb_us[name].items():
            # the bound and plain time of the kernel at this path's shape
            rec = (nbk[name].get(k) or fk_nb.get(k, {}).get("shapes", {}).get(name)
                   or (pt_nb.get(name) if k == "pt_step" else None))
            per_sweep = run["launches"][k] / run["launches"]["pt_step"]
            parts.append(f"{k} {v / 1e3:.5f} ms x {per_sweep:g} a sweep" + (
                f" (bound {rec['bound_ms']:.5f} ms by {rec['bound_by']}, plain "
                f"{rec['plain_ms']:.4f} ms)" if rec else ""))
        log("19 times", f"{name} per launch: " + "; ".join(parts) + f" on {card}")

    return dict(c2=c2, nb_runs=nb_runs, nbk=nbk, row4=row4, fk_models=fk_models,
                fk_nb=fk_nb, pt_nb=pt_nb, windows=windows, nb_us=nb_us)


def add_nb_records(kernels, nb):
    """Add the coloured lattices' numbers to the kernel records: sweep_nb and
    measure_nb (config 2, the other paths beside it), the FK kernels and
    pt_step at config 2 and 32^3, and sweep_2d at 32^2 (row 4)."""
    c2, nb_runs, nbk, fk_nb, pt_nb = (nb[k] for k in ("c2", "nb_runs", "nbk", "fk_nb",
                                                       "pt_nb"))
    windows, nb_us = nb["windows"], nb["nb_us"]
    fk_replaces = "peapods_tpu/ops/pallas_event.py:621"
    by_name = {kr["name"]: kr for kr in kernels}
    for k in FK_KERNELS:
        for name in nb["fk_models"]:
            if name not in fk_nb[k]["shapes"]:
                continue  # a launch of the tiled labelling, on a whole-graph path
            by_name[k][f"at_{name}"] = dict(
                fk_nb[k]["shapes"][name], max_abs_err=fk_nb[k]["max_abs_err"],
                ms=nb_us[name][k] / 1e3, launches=windows[name][0]["launches"][k],
                replaces=f"{fk_replaces} (tri=True)" if name == "config2" else fk_replaces)
    for name in nb["fk_models"]:
        by_name["pt_step"][f"at_{name}"] = dict(
            pt_nb[name], ms=nb_us[name]["pt_step"] / 1e3,
            launches=windows[name][0]["launches"]["pt_step"])
    by_name["sweep_2d"]["at_32x32"] = nb["row4"]
    for k, rep in (("sweep_nb", TRI_REPLACES), ("measure_nb", TRI_MEASURE_REPLACES)):
        rec = dict(nbk["config2"][k], ms_events=nbk["config2"][k]["ms"],
                   ms=nb_us["config2"][k] / 1e3)
        kr = dict(name=k, route="cuda", source=NB_SRC, replaces=rep,
                  launches=c2["launches"][k], library_ms=None, **rec)
        for name, run in nb_runs.items():
            at = dict(nbk[name][k], launches=run["launches"].get(k, 0),
                      replaces=NB_PATHS[name]["replaces" if k == "sweep_nb"
                                             else "measure_replaces"])
            if k in nb_us[name]:  # the profiled window's time; events otherwise
                at.update(ms_events=at["ms"], ms=nb_us[name][k] / 1e3)
            kr[f"at_{name}"] = at
        kernels.append(kr)


# ------------------------------------------------ FK observe and the staged path


# the main workload of FK observe: the fk arm of benchmarks/observe_ab.py:35-53,
# uncut (256^2 at T_c, Metropolis, SW observe every sweep)
OBSERVE_SWEEPS = 1024
OBSERVE_KW = dict(cluster_update_interval=1, cluster_mode="sw", cluster_action="observe")
# the harness shape with SW observe and PT every sweep: 2048 graphs a sweep
HARNESS_OBSERVE_SWEEPS = 32
# the staged FK path: the BCC and FCC paths of NB_PATHS with SW, PT and cluster
# statistics every sweep, and the next-nearest-neighbour table with SW
# observe every 2 sweeps and PT (no winding: an offset table is not the
# canonical lattice)
STAGED_PATHS = {
    "bcc16_sw": dict(NB_PATHS["bcc16"], kw=dict(
        cluster_update_interval=1, cluster_mode="sw", pt_interval=1,
        collect_cluster_stats=True)),
    "fcc16_sw": dict(NB_PATHS["fcc16"], kw=dict(
        cluster_update_interval=1, cluster_mode="sw", pt_interval=1,
        collect_cluster_stats=True)),
    "nnn64_observe": dict(NB_PATHS["nnn64"], kw=dict(OBSERVE_KW, cluster_update_interval=2,
                                                     pt_interval=1)),
}
FK_OBS_KEYS = ("observation_count", "cluster_size_counts", "top_four_component_fractions",
               "active_bond_density", "large_component_count")
WINDING_KEYS = ("winding_x", "winding_y", "winding_either", "winding_both")
CC_SRC = "peapods_tpu_torch/csrc/cc.cu"
CC_REPLACES = "peapods_tpu/ops/pallas_cc_batch.py:394"  # _cc_batch_kernel (row 14)
CC2D_REPLACES = "peapods_tpu/ops/pallas_cc.py:47"  # _cc_kernel (row 15)
WINDING_REPLACES = "peapods_tpu/ops/pallas_cc_batch.py:501"  # _winding_kernel (row 16)
FUSED_REPLACES = "peapods_tpu/ops/pallas_sweep.py:313"  # _kernel_fused (row 2)


def run_checksum(sim, result) -> str:
    """:func:`state_checksum` and every FK observation sum and cluster-size
    histogram of the result."""
    h = hashlib.sha256(state_checksum(sim, result).encode())
    fk = result.get("per_disorder", {}).get("cluster_observations", {}).get("fk", {})
    for key in sorted(fk):
        h.update(np.ascontiguousarray(fk[key]).tobytes())
    if "fk_csd" in result:
        h.update(np.ascontiguousarray(result["fk_csd"]).tobytes())
    return h.hexdigest()[:16]


def check_observations(result, sim, n_obs, winding):
    """The FK observations of a run: the reference's keys (the winding ones
    only on the canonical square) and dtypes, ``n_obs`` graphs a
    temperature and realization, every site in one cluster of each graph
    (sum_s s csd[s] = n_spins x observation_count, exact), fractions in [0,
    1] with the top four descending, and either >= max(x, y), both <=
    min(x, y).  Returns the observations."""
    fk = result["per_disorder"]["cluster_observations"]["fk"]
    keys = set(FK_OBS_KEYS) | (set(WINDING_KEYS) if winding else set())
    if set(fk) != keys:
        raise AssertionError(f"FK observation keys {sorted(fk)}, expected {sorted(keys)}")
    cnt, csd = fk["observation_count"], fk["cluster_size_counts"]
    if cnt.dtype != np.uint64 or csd.dtype != np.uint64 or not (cnt == n_obs).all():
        raise AssertionError(f"observation counts {cnt} ({cnt.dtype}), expected {n_obs}")
    n = sim.rt.n_spins
    sites = (csd.astype(np.float64) * np.arange(n + 1)).sum(-1)
    if not (sites == n * cnt.astype(np.float64)).all():
        raise AssertionError("the cluster sizes do not add up to the sites")
    top4 = fk["top_four_component_fractions"]
    fr = [top4, fk["active_bond_density"]] + [fk[k] for k in WINDING_KEYS if winding]
    if not all(f.dtype == np.float64 and (f >= 0).all() and (f <= 1).all() for f in fr):
        raise AssertionError("an FK fraction outside [0, 1]")
    if not ((np.diff(top4, axis=-1) <= 0).all() and (top4.sum(-1) <= 1 + 1e-12).all()):
        raise AssertionError(f"top-4 fractions {top4}")
    if winding:
        wx, wy = fk["winding_x"], fk["winding_y"]
        if not ((fk["winding_either"] >= np.maximum(wx, wy)).all()
                and (fk["winding_both"] <= np.minimum(wx, wy)).all()):
            raise AssertionError("winding either / both against x, y")
    return fk


def observe_main(dev, card):
    """Phase 20: the main workload, 256^2 SW observe at T_c, through
    Ising.sample twice from one seed: launch counts, two equal checksums
    (spins, records, every observation), the observations' invariants, the
    active-bond density against p x the satisfied-bond fraction (batch
    means), and the rate over three warm calls."""
    from peapods_tpu_torch import Ising

    temps = np.array([T_C], np.float32)
    n = OBSERVE_SWEEPS
    kw = dict(OBSERVE_KW, warmup_ratio=0.0)
    checks, models = [], []
    for run in range(2):
        model = Ising((L, L), temperatures=temps, seed=3, device=dev)
        torch.cuda.synchronize()
        reset_cluster_counts()
        result = model.sample(n, "metropolis", **kw)
        torch.cuda.synchronize()
        if run == 0:
            launches, r0 = cluster_counts(), result
        checks.append(run_checksum(model._sim, result))
        models.append(model)
    want = {"sweep_2d": 2 * n, "fk_bonds": n, **link_want((L, L), 1, n),
            "fk_finish": n, "winding": n, "pt_step": n}
    if launches != want:
        raise AssertionError(f"observe launch counts {launches}, expected {want}")
    if checks[0] != checks[1]:
        raise AssertionError(f"observe checksums differ: {checks}")
    fk = check_observations(r0, models[0]._sim, n, winding=True)
    log("20 observe", f"{L}x{L} SW observe at T_c = {T_C:.6f}, {n} sweeps on {dev}: "
        f"launches {launches}; checksum {checks[0]} == {checks[1]}; observations "
        f"ok: top-4 {np.round(fk['top_four_component_fractions'][0, 0], 5).tolist()}, "
        f"bond density {fk['active_bond_density'][0, 0]:.6f}, large "
        f"{fk['large_component_count'][0, 0]:.4f}, winding x / y / either / both "
        f"{[round(float(fk[k][0, 0]), 4) for k in WINDING_KEYS]}")
    # E[active bonds | spins] = p x satisfied bonds on every observed sweep,
    # and the sweep's e is measured on those spins: e per spin is the sum of
    # s_i s_j over its 2 bonds, so the satisfied fraction is (1 + e / 2) / 2
    p = 1.0 - np.exp(-2.0 / T_C)
    resid = []
    for _ in range(8):
        r = models[1].sample(256, "metropolis", **kw)
        dens = r["per_disorder"]["cluster_observations"]["fk"]["active_bond_density"]
        resid.append(dens[0, 0] - p * (1.0 + r["energies"][0] / 2.0) / 2.0)
    resid = np.array(resid)
    se = resid.std(ddof=1) / np.sqrt(len(resid))
    if not abs(resid.mean()) < 4 * se:
        raise AssertionError(f"bond density - p x satisfied fraction: {resid.mean()} "
                             f"+- {se}")
    log("20 observe", f"bond density - p x satisfied fraction (p = {p:.6f}), 8 batches "
        f"of 256 sweeps: {resid.mean():.3e} +- {se:.3e} (limit 4 standard errors) ok")
    sweeps_s, rates = warm_rate(models[1], n, OBSERVE_KW)
    log("20 observe", f"kernel path: {sweeps_s:.1f} sweeps/s = {sweeps_s * L * L:.4e} "
        f"flips/s (single-spin attempts) on {card} (median of "
        f"{', '.join(f'{r:.1f}' for r in rates)} sweeps/s)")
    return dict(model=models[1], launches=launches, sweeps_s=sweeps_s, kw=OBSERVE_KW,
                checksum=checks[0])


def observe_harness(dev, card):
    """Phase 21: SW observe with PT every sweep on the harness shape (2048
    graphs a sweep), twice from one seed: launch counts, equal checksums,
    the observations' invariants, the rate over three warm calls."""
    from peapods_tpu_torch import Ising

    h, n = HARNESS, HARNESS_OBSERVE_SWEEPS
    temps = np.geomspace(0.1, 10, h["n_temps"]).astype(np.float32)
    kw = dict(OBSERVE_KW, pt_interval=1)
    checks, models = [], []
    for run in range(2):
        model = Ising(h["shape"], temperatures=temps, n_disorder=h["n_disorder"],
                      seed=3, device=dev)
        torch.cuda.synchronize()
        reset_cluster_counts()
        result = model.sample(n, "metropolis", **dict(kw, warmup_ratio=0.0))
        torch.cuda.synchronize()
        if run == 0:
            launches, r0 = cluster_counts(), result
        checks.append(run_checksum(model._sim, result))
        models.append(model)
    want = {"sweep_2d": 2 * n, "fk_bonds": n,
            **link_want(h["shape"], h["n_disorder"] * h["n_temps"], n), "fk_finish": n,
            "winding": n, "pt_step": n}
    if launches != want:
        raise AssertionError(f"harness observe launch counts {launches}, expected {want}")
    if checks[0] != checks[1]:
        raise AssertionError(f"harness observe checksums differ: {checks}")
    fk = check_observations(r0, models[0]._sim, n, winding=True)
    wx = fk["winding_x"].mean(0)
    # at T = 10 the bond density (~0.09) is far below percolation (1/2)
    if wx[-1] != 0:
        raise AssertionError(f"harness observe winding_x by temperature {wx}")
    n_graphs = h["n_disorder"] * h["n_temps"]
    sweeps_s, rates = warm_rate(models[1], n, kw)
    log("21 observe-harness", f"64x64 x {h['n_temps']} temps x {h['n_disorder']} "
        f"realizations ({n_graphs} graphs), SW observe + PT every sweep, {n} sweeps: "
        f"launches {launches}; checksum {checks[0]} == {checks[1]}; winding_x by T "
        f"{np.round(wx, 4).tolist()}; "
        f"{sweeps_s:.1f} sweeps/s = {sweeps_s * n_graphs * 64 * 64:.4e} flips/s on "
        f"{card} (median of {', '.join(f'{r:.1f}' for r in rates)} sweeps/s)")
    return dict(model=models[1], launches=launches, sweeps_s=sweeps_s, kw=kw,
                checksum=checks[0])


def exact_nnn_4x4(dev):
    """The 4x4 next-nearest-neighbour ferromagnet against exact enumeration,
    SW every sweep through the staged path (8 chains of 4000 sweeps)."""
    from peapods_tpu_torch import Ising
    from peapods_tpu_torch.ops.lattice import Lattice

    T = 5.0
    e_ex, m2_ex = exact_moments(Lattice((4, 4), NNN), T)
    m = Ising((4, 4), neighbor_offsets=NNN, temperatures=np.array([T], np.float32),
              n_disorder=8, seed=12, device=dev)
    m.sample(4000, warmup_ratio=0.25, cluster_update_interval=1, cluster_mode="sw")
    de, dm2 = abs(m.energies_avg[0] - e_ex), abs(m.mags2[0] - m2_ex)
    if not (de < 0.05 and dm2 < 0.06):
        raise AssertionError(f"4x4 NNN exact (staged SW): |dE| {de}, |dm2| {dm2}")
    log("22 staged", f"4x4 NNN T={T} SW every sweep (staged path), 8 chains x 4000 "
        f"sweeps on {dev}: <E> {m.energies_avg[0]:.5f} (exact {e_ex:.5f}), <m2> "
        f"{m.mags2[0]:.5f} (exact {m2_ex:.5f}) ok (tolerances 0.05, 0.06)")


def staged_paths(dev, card):
    """Phase 22: the staged FK path through Ising.sample, each run twice from
    one seed (launch counts, equal checksums, sanity, the rate of a warm
    call); NNN observe against the same run without the observer, bitwise;
    the 4x4 NNN magnet against exact enumeration."""
    out = {}
    for name, c in STAGED_PATHS.items():
        n, kw = c["sweeps"], dict(c["kw"], warmup_ratio=0.0)
        checks, models = [], []
        for run in range(2):
            model = nb_model(c, dev)
            torch.cuda.synchronize()
            reset_cluster_counts()
            result = model.sample(n, "metropolis", **kw)
            torch.cuda.synchronize()
            if run == 0:
                launches, r0 = cluster_counts(), result
            checks.append(run_checksum(model._sim, result))
            models.append(model)
        want = nb_want(models[0], kw, n)
        if launches != want:
            raise AssertionError(f"{name} launch counts {launches}, expected {want}")
        if checks[0] != checks[1]:
            raise AssertionError(f"{name} checksums differ: {checks}")
        e = r0["energies"]
        if not (np.isfinite(e).all() and e[0] > e[-1]):
            raise AssertionError(f"{name} sanity: energies {e}")
        sim = models[0]._sim
        if c["kw"].get("cluster_action") == "observe":
            fk = check_observations(r0, sim, len(range(0, n, c["kw"][
                "cluster_update_interval"])), winding=False)
            dens = np.round(fk["active_bond_density"][0], 4).tolist()
            extra = f"bond density by T {dens}"
        else:
            csd = np.asarray(r0["fk_csd"], np.float64)
            if not ((csd * np.arange(csd.shape[-1])).sum(-1) == sim.rt.n_spins * n).all():
                raise AssertionError(f"{name}: fk_csd does not add up to the sites")
            extra = "fk_csd adds up to the sites"
        sweeps_s, _ = warm_rate(models[1], n, c["kw"], calls=1)
        n_sites = int(np.prod(c["shape"]))
        log("22 staged", f"{name}: {'x'.join(map(str, c['shape']))} x {c['n_temps']} "
            f"temps geomspace{c['t']}, {c['kw']}, {n} sweeps on {dev}: launches "
            f"{launches}; checksum {checks[0]} == {checks[1]}; <e>[0,-1] {e[0]:.5f}, "
            f"{e[-1]:.5f}; {extra}; {sweeps_s:.1f} sweeps/s = "
            f"{sweeps_s * n_sites * c['n_temps']:.4e} flips/s on {card}")
        out[name] = dict(model=models[1], launches=launches, sweeps_s=sweeps_s,
                         kw=c["kw"], checksum=checks[0], result=r0, sim=sim)

    # observe mutates nothing: the NNN run without the observer, same seed
    c = STAGED_PATHS["nnn64_observe"]
    kw = {k: v for k, v in c["kw"].items() if not k.startswith("cluster")}
    model = nb_model(c, dev)
    result = model.sample(c["sweeps"], "metropolis", **dict(kw, warmup_ratio=0.0))
    obs = out["nnn64_observe"]
    same = {key: bool(torch.equal(model._sim.state[key], obs["sim"].state[key]))
            for key in ("spins", "system_ids", "pt_edge_acceptances")}
    check_plain = state_checksum(model._sim, result)
    check_obs = state_checksum(obs["sim"], obs["result"])
    if not all(same.values()) or check_plain != check_obs:
        raise AssertionError(f"NNN observe changed the run: {same}, checksums "
                             f"{check_obs} (observe) {check_plain} (no observer)")
    log("22 staged", f"nnn64: observe every 2 sweeps + PT leaves the run bitwise as "
        f"without the observer (spins, system ids, PT counters; state checksum "
        f"{check_obs} == {check_plain})")
    exact_nnn_4x4(dev)
    return out


def kernel_ms(fn, reps, names):
    """Device ms a launch of each kernel ``names`` over ``reps`` calls of
    ``fn``, from the profiler's kernel records."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    acc = {}
    for ev in prof.key_averages():
        hit = [k for k in names if f"{k}_kernel" in ev.key]
        if hit and ev.self_device_time_total > 0:
            add_kernel_time(acc, hit[0], ev)
    out = {k: t / c / 1e3 for k, (t, c) in acc.items()}
    if set(out) != set(names):
        raise AssertionError(f"the profiler saw {sorted(out)}, expected {names}")
    return out


def staged_bounds(b, n, n_nb, d, n_comp):
    """The bounds of the staged path's launches on ``b`` graphs of ``n``
    sites, ``n_nb`` offsets, ``d`` realizations' couplings."""
    cb = 4 * n_nb * d * n
    return {
        # spins, couplings, temps, kb in; state, parents out
        "fk_bonds_nb": bound(b * n + cb + 12 * b + 5 * b * n, 8 * n_nb * b * n),
        # state and parents in; a parent written per union
        "cc_link": bound(5 * b * n + 4 * (b * n - n_comp), 0),
        # parents in, labels out
        "cc_label": bound(8 * b * n, 0),
        # spins, labels, scalars in; spins out
        "fk_finish": bound(2 * b * n + 4 * b * n + 12 * b, 0),
    }


def check_observe_kernels(obs, hobs, staged, dev, rng):
    """Phase 23: every new kernel against its plain version on the main
    paths' states: ``fk_finish`` in observe form (spins untouched, labels
    and masks equal), ``winding`` (flags equal) and ``cc_link`` /
    ``cc_label`` (labels bitwise) on the 256^2 graph at T_c (row 15's shape)
    and the harness's 2048 graphs; ``fk_bonds_nb``, ``cc_link``,
    ``cc_label`` and ``fk_finish`` reading the labels on the staged runs'
    states, SW and Wolff (masks, labels, spins bitwise), with the CC kernels
    alone on those masks.  Then the plain versions' times and the bounds at
    each shape."""
    from peapods_tpu_torch.ops import cc, cluster, fk, winding
    from peapods_tpu_torch.ops.lattice import Lattice

    times = {}
    for name, run in (("observe256", obs), ("harness_observe", hobs)):
        model = run["model"]
        x = fk_inputs(model, dev, rng, False)
        b, shape = x["spins"].shape[0], tuple(x["spins"].shape[1:])
        n = int(np.prod(shape))
        lat = Lattice(shape)
        s0 = x["spins"].clone()
        args = (x["j_fwd"], x["temps"], x["kb_words"])
        lk, mk = fk.fk_observe(x["spins"], *args)
        lp, mp = fk.fk_observe_plain(s0.clone(), *args)
        lp = lp.view(b, n)
        wk = winding.winding_flags(mk, lk.view(b, n), shape)
        wp = cluster.winding_flags(mp, lp, shape)
        ck = cc.cc_labels(mk, lat)
        torch.cuda.synchronize()
        bad = {"spins": int((x["spins"] != s0).sum()),
               "labels": int((lk.view(b, n) != lp).sum()), "masks": int((mk != mp).sum()),
               "winding": int((wk[0] != wp[0]).sum() + (wk[1] != wp[1]).sum()),
               "cc labels": int((ck != lp).sum())}
        if any(bad.values()):
            raise AssertionError(f"observe kernels on {name} differ from plain: {bad}")
        n_comp = int((lp == torch.arange(n, device=dev)).sum())
        log("23 kernel-vs-plain", f"fk_finish (observe form), winding, cc_link / "
            f"cc_label on {name} ({b} graph(s) of {'x'.join(map(str, shape))}): "
            f"mismatches {bad}; {n_comp} clusters, {int(mk.sum())} active bonds, "
            f"{int(wk[0].sum())} / {int(wk[1].sum())} graphs wind along x / y")
        plain = {
            "winding": wall_ms(lambda: cluster.winding_flags(mp, lp, shape), 2),
            "cc_link": wall_ms(lambda: cc.cc_labels_plain(mp, lat), 3),
            # the observe form's function: labels from the bonds
            "fk_finish": wall_ms(lambda: fk.fk_link_plain(mp, shape), 3),
        }
        plain["cc_label"] = plain["cc_link"]
        t = {
            # masks and labels in; one flag byte a graph out
            "winding": bound(6 * b * n + b, 0),
            "cc_link": bound(5 * b * n + 4 * (b * n - n_comp), 0),
            "cc_label": bound(8 * b * n, 0),
            # parents in, labels out
            "fk_finish": bound(8 * b * n, 0),
        }
        for k, v in t.items():
            times.setdefault(k, {})[name] = dict(bound_ms=v[0], bound_by=v[1],
                                                 plain_ms=plain[k])
        # the CC kernels on these graphs (row 15: one 256^2 graph), off the
        # main path: the profiler's device time a launch
        for k, v in kernel_ms(lambda: cc.cc_labels(mk, lat), 20,
                              ("cc_link", "cc_label")).items():
            times[k][name]["ms_off_path"] = v

    for name, run in staged.items():
        model = run["model"]
        lat = model._sim.rt.lattice
        n, n_nb = lat.n_spins, lat.n_neighbors
        for wolff in (False, True):
            x = fk_inputs(model, dev, rng, wolff)
            b = x["spins"].shape[0]
            a, p = x["spins"], x["spins"].clone()
            args = (x["j_fwd"], x["temps"], x["scalars"], x["kb_words"], lat)
            lk, mk = fk.fk_staged(a, *args, wolff=wolff, with_masks=True)
            lp, mp = fk.fk_staged_plain(p, *args, wolff=wolff)
            ck = cc.cc_labels(mk, lat)
            torch.cuda.synchronize()
            bad = {"masks": int((mk != mp).sum()), "labels": int((lk != lp).sum()),
                   "spins": int((a != p).sum()), "cc labels": int((ck != lp).sum())}
            if any(bad.values()):
                raise AssertionError(f"staged kernels on {name} differ from plain: {bad}")
            n_comp = int((lp == torch.arange(n, device=dev)).sum())
            log("23 kernel-vs-plain", f"fk_bonds_nb, cc_link / cc_label, fk_finish "
                f"{'wolff' if wolff else 'sw'} on {name} ({b} graphs of "
                f"{'x'.join(map(str, lat.shape))}, {n_nb} offsets): mismatches {bad}; "
                f"{n_comp} clusters, {int(mk.sum())} active bonds")
        sp = x["spins"]
        bd = fk.fk_bonds_plain(sp, x["j_fwd"], x["temps"], x["kb_words"],
                               offsets=lat.offsets)
        lab = cc.cc_labels_plain(bd, lat)
        plain = {
            "fk_bonds_nb": wall_ms(lambda: fk.fk_bonds_plain(
                sp, x["j_fwd"], x["temps"], x["kb_words"], offsets=lat.offsets), 3),
            "cc_link": wall_ms(lambda: cc.cc_labels_plain(bd, lat), 3),
            "fk_finish": wall_ms(lambda: fk.fk_finish_plain(
                sp.clone(), lab, x["j_fwd"], x["scalars"], wolff=False,
                with_measure=False), 3),
        }
        plain["cc_label"] = plain["cc_link"]
        n_comp = int((lab == torch.arange(n, device=dev)).sum())
        for k, v in staged_bounds(b, n, n_nb, x["j_fwd"].shape[0], n_comp).items():
            times.setdefault(k, {})[name] = dict(bound_ms=v[0], bound_by=v[1],
                                                 plain_ms=plain[k])
    return times


def observe_times(obs, hobs, staged, card):
    """Per-launch device times of every kernel over main-path windows of the
    observe and staged runs (profiler), with the busy share; returns
    ``{run: {kernel: us per launch}}``."""
    windows = {"observe256": (obs, 256), "harness_observe": (hobs, 16),
               **{k: (v, 64) for k, v in staged.items()}}
    us = {}
    for name, (run, n_win) in windows.items():
        us[name], line = profile_window(run["model"], run["kw"], run["sweeps_s"], n_win,
                                        names=tuple(run["launches"]))
        log("23 times", f"{name} {line} (on {card})")
    return us


def add_observe_records(kernels, obs, hobs, staged, times, us, card):
    """Add this section's numbers to the kernel records: ``cc_link``,
    ``cc_label`` (the BCC SW run's numbers; FCC, NNN, the 256^2 graph and
    the harness beside them), ``winding`` (the 256^2 observe run's; the
    harness beside them), ``fk_bonds_nb`` (BCC; FCC, NNN); the observe and
    staged runs' numbers beside the FK kernels', ``sweep_2d``'s (row 2) and
    the coloured lattices' kernels'."""
    runs = {"observe256": obs, "harness_observe": hobs, **staged}
    by_name = {kr["name"]: kr for kr in kernels}

    def at(k, name):
        rec = dict(times.get(k, {}).get(name, {}), launches=runs[name]["launches"].get(k, 0))
        if k in us[name]:
            rec["ms"] = us[name][k] / 1e3
            rec["launches_per_sweep"] = rec["launches"] / runs[name]["launches"]["pt_step"]
        return rec

    lines = []  # (main run, record)
    for k, src, main, rep in (("cc_link", CC_SRC, "bcc16_sw", CC_REPLACES),
                              ("cc_label", CC_SRC, "bcc16_sw", CC_REPLACES),
                              ("winding", "peapods_tpu_torch/csrc/winding.cu",
                               "observe256", WINDING_REPLACES),
                              ("fk_bonds_nb", "peapods_tpu_torch/csrc/fk.cu", "bcc16_sw",
                               "peapods_tpu/ops/pallas_event.py:621")):
        kr = dict(name=k, route="cuda", source=src, replaces=rep, max_abs_err=0.0,
                  library_ms=None, **at(k, main))
        for name in runs:
            if name != main and name in times.get(k, {}):
                kr[f"at_{name}"] = at(k, name)
        if k.startswith("cc_"):
            kr["at_observe256"]["replaces"] = CC2D_REPLACES
        if k == "fk_bonds_nb":
            kr["on_the_reference_path"] = ("peapods_tpu/ops/cluster.py:555 "
                                           "fk_bond_activation (jnp, staged path)")
        kernels.append(kr)
        lines.append((main, kr))
    for k in FK_KERNELS:
        for name in ("observe256", "harness_observe"):
            if k in runs[name]["launches"]:
                by_name[k][f"at_{name}"] = dict(at(k, name), max_abs_err=0.0)
    for name in staged:
        if "fk_finish" in runs[name]["launches"]:
            by_name["fk_finish"][f"at_{name}"] = dict(at("fk_finish", name),
                                                      max_abs_err=0.0)
        for k in ("sweep_nb", "measure_nb", "pt_step"):
            by_name[k][f"at_{name}"] = dict(launches=runs[name]["launches"][k],
                                            ms=us[name][k] / 1e3)
    # row 2: sweep_2d's measuring pass on every observe sweep (config 3's
    # shape: its plain time and bound are the 256^2 observe run's)
    sw = by_name["sweep_2d"]
    sw["covers"] = FUSED_REPLACES
    sw["at_observe256"] = dict(
        at("sweep_2d", "observe256"), replaces=FUSED_REPLACES,
        **{k: sw[k] for k in ("max_abs_err", "plain_ms", "bound_ms", "bound_by")})
    for main, kr in lines:
        shapes = {main: kr,
                  **{key[3:]: v for key, v in kr.items() if key.startswith("at_")}}
        log("23 times", f"{kr['name']} per launch: " + "; ".join(
            (f"{name} {v['ms']:.5f} ms x {v['launches_per_sweep']:g} a sweep"
             if "ms" in v else f"{name} {v['ms_off_path']:.5f} ms (off the path)")
            + f" (bound {v['bound_ms']:.6f} ms by {v['bound_by']}, plain "
            f"{v['plain_ms']:.4f} ms)" for name, v in shapes.items()) + f" on {card}")


# ------------------- Houdayer(N), the overlap moves' statistics and observe


# config 4 at full width with the spin-glass script's cmr_houd4 move list
# (benchmarks/driver_configs.py:71-83, tests/spin_glass_crossings.py:88-92):
# one CMR pair move and one Houdayer(4) move in turn every 10 sweeps
HOUDN_KW = dict(pt_interval=1, overlap_cluster_update_interval=10,
                overlap_cluster_build_mode="cmr+houd4", overlap_cluster_mode="sw",
                collect_cluster_stats=True)
HOUDN_WOLFF_KW = dict(pt_interval=1, overlap_cluster_update_interval=10,
                      overlap_cluster_build_mode="houd4")
OV_OBSERVE_KW = dict(pt_interval=1, overlap_cluster_update_interval=10,
                     overlap_cluster_build_mode="houdayer+jorg+cmr",
                     overlap_cluster_mode="sw", overlap_cluster_action="observe")
# the 2D square with winding: a 64^2 +-J glass, R = 2, 8 temperatures, 4
# realizations, observe every sweep (cut in depth to 256 sweeps)
OV_OBSERVE_2D = dict(shape=(64, 64), t=(0.8, 2.0), n_temps=8, n_replicas=2,
                     n_disorder=4, sweeps=256,
                     kw=dict(OV_OBSERVE_KW, overlap_cluster_update_interval=1))
# the 4x4 glass of glass_physics with R = 4: the pair-Houdayer control
# against exact enumeration; houd4's deviation from it is measured, since
# Houdayer(N > 2) does not keep the group's summed energy yet accepts every
# move (the reference warns that it breaks detailed balance), and its run
# on the card is held bitwise to the plain path on the CPU
HOUDN_GLASS_SWEEPS = 20000
HOUDN_BITWISE_SWEEPS = 1000
HOUDN_SRC = "peapods_tpu_torch/csrc/overlap.cu"
HOUDN_REPLACES = "peapods_tpu/ops/pallas_event.py:901"  # _houdn_kernel (row 20)
EV_REPLACES = "peapods_tpu/ops/pallas_event.py:274"  # _event_kernel (row 19)
OBS_NAMES = {"houdayer": "houdayer", "jorg": "jorg", "cmr": "cmr_blue"}


def move_counts(kw, n, warmup, observe=False, winding=False):
    """Launches of ``n`` sweeps of the replica path from sweep 0 with the
    moves of ``kw``: per sweep two colour passes, a pair measurement and a
    PT step; per move (every interval, only recorded sweeps when observing)
    a second PT step and the move's kernels: ``houdn_bonds``, ``fk_link``,
    ``houdn_finish`` for Houdayer (any group size); ``ov_bonds``,
    ``fk_link`` (twice for CMR), ``ov_mid`` (CMR), ``ov_finish`` for Joerg
    and CMR; ``energy_partials`` after an update; ``winding`` after an observed
    move on the canonical square.  The observe form builds no grey graph."""
    interval = kw["overlap_cluster_update_interval"]
    modes = kw["overlap_cluster_build_mode"].split("+")
    moves = [modes[(s // interval) % len(modes)] for s in range(0, n, interval)
             if not (observe and s < warmup)]
    houdn = sum(m.startswith("houd") for m in moves)
    pair = len(moves) - houdn
    n_cmr = 0 if observe else sum(m == "cmr" for m in moves)
    counts = {"colour_pass": 2 * n, "pt_step": n + len(moves), "pair_overlap": n,
              "ov_bonds": pair, "fk_link": len(moves) + n_cmr, "ov_mid": n_cmr,
              "ov_finish": pair, "houdn_bonds": houdn, "houdn_finish": houdn,
              "energy_partials": 0 if observe else len(moves),
              "winding": len(moves) if winding else 0}
    return {k: v for k, v in counts.items() if v}


def stats_checksum(sim, result) -> str:
    """:func:`pair_checksum`, the overlap moves' cluster-size histograms,
    top-4 sizes and graph observations."""
    h = hashlib.sha256(pair_checksum(sim, result).encode())
    for key in ("overlap_csd", "top_cluster_sizes"):
        for x in result.get(key, []):
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    obs = result.get("per_disorder", {}).get("cluster_observations", {})
    for name in sorted(obs):
        for key in sorted(obs[name]):
            h.update(np.ascontiguousarray(obs[name][key]).tobytes())
    return h.hexdigest()[:16]


def glass_run(dev, kw, n, shape=(8, 8, 8), t=(0.9, 2.2), n_temps=SG_T,
              n_replicas=SG_R, n_disorder=SG_D, seed=4):
    """A +-J glass (config 4's by default) through Ising.sample from its
    seed, its launches counted from zero just before the run and read just
    after: ``(model, result, launches)``."""
    from peapods_tpu_torch import Ising

    model = Ising(shape, couplings="bimodal", temperatures=np.geomspace(*t, n_temps),
                  n_replicas=n_replicas, n_disorder=n_disorder, seed=seed, device=dev)
    torch.cuda.synchronize()
    reset_pair_counts()
    result = model.sample(n, "metropolis", **kw)
    torch.cuda.synchronize()
    return model, result, {k: v for k, v in pair_counts().items() if v}


def twice(name, dev, kw, n, want, **glass):
    """:func:`glass_run` twice from one seed: the launch counts of the first
    against ``want`` and two equal checksums."""
    runs = [glass_run(dev, kw, n, **glass) for _ in range(2)]
    if runs[0][2] != want:
        raise AssertionError(f"{name} launch counts {runs[0][2]}, expected {want}")
    checks = [stats_checksum(m._sim, r) for m, r, _ in runs]
    if checks[0] != checks[1]:
        raise AssertionError(f"{name} checksums differ: {checks}")
    return runs, checks[0]


def mode_graphs(sim, kw, n, warmup):
    """The stats graphs of each mode's recorded moves over ``n`` sweeps."""
    from peapods_tpu_torch.engine.config import parse_overlap_modes

    rt = sim.rt
    interval = kw["overlap_cluster_update_interval"]
    modes = parse_overlap_modes(kw["overlap_cluster_build_mode"])
    return [sum(s >= warmup and (s // interval) % len(modes) == m
                for s in range(0, n, interval))
            * rt.n_disorder * rt.n_temps * (rt.n_replicas // mode.group_size)
            for m, mode in enumerate(modes)]


def check_mode_stats(result, sim, graphs):
    """Every site of every recorded move's stats graph in one cluster
    (sum_s s csd[s] = n_spins x graphs, per mode, exact) and the top-4
    sizes finite, in [0, 1] and descending."""
    n = sim.rt.n_spins
    for m, g in enumerate(graphs):
        csd = np.asarray(result["overlap_csd"][m])
        if csd.dtype != np.uint64 or csd.shape != (sim.rt.n_temps, n + 1):
            raise AssertionError(f"mode {m} overlap_csd {csd.dtype} {csd.shape}")
        sites = (csd.astype(np.float64) * np.arange(n + 1)).sum()
        if sites != n * g:
            raise AssertionError(f"mode {m}: {sites} sites in the histograms, "
                                 f"expected {n} x {g} graphs")
        top = result["top_cluster_sizes"][m]
        if not (top.shape == (sim.rt.n_temps, 4) and np.isfinite(top).all()
                and (top >= 0).all() and (top <= 1).all()
                and (np.diff(top, axis=-1) <= 0).all()):
            raise AssertionError(f"mode {m} top_cluster_sizes {top}")


def check_overlap_observations(result, sim, kw, n, warmup, winding):
    """Each observed kind's graph observations: the reference's keys (the
    winding ones only on the canonical square) and dtypes, the moves of the
    kind times the groups a temperature and realization, every site in one
    cluster, fractions in [0, 1] with the top four descending, either >=
    max(x, y) and both <= min(x, y)."""
    rt = sim.rt
    interval = kw["overlap_cluster_update_interval"]
    kinds = kw["overlap_cluster_build_mode"].split("+")
    obs = result["per_disorder"]["cluster_observations"]
    if list(obs) != [OBS_NAMES[k] for k in kinds]:
        raise AssertionError(f"observed kinds {list(obs)}")
    keys = set(FK_OBS_KEYS) | (set(WINDING_KEYS) if winding else set())
    for i, kind in enumerate(kinds):
        o = obs[OBS_NAMES[kind]]
        if set(o) != keys:
            raise AssertionError(f"{kind} observation keys {sorted(o)}")
        moves = sum(s >= warmup and (s // interval) % len(kinds) == i
                    for s in range(0, n, interval))
        cnt, csd = o["observation_count"], o["cluster_size_counts"]
        want = moves * (rt.n_replicas // 2)
        if cnt.dtype != np.uint64 or csd.dtype != np.uint64 or not (cnt == want).all():
            raise AssertionError(f"{kind} observation counts {cnt}, expected {want}")
        sites = (csd.astype(np.float64) * np.arange(rt.n_spins + 1)).sum(-1)
        if not (sites == rt.n_spins * cnt.astype(np.float64)).all():
            raise AssertionError(f"{kind}: the cluster sizes do not add up to the sites")
        top4 = o["top_four_component_fractions"]
        fr = [top4, o["active_bond_density"]] + [o[k] for k in WINDING_KEYS if winding]
        if not all(f.dtype == np.float64 and (f >= 0).all() and (f <= 1).all()
                   for f in fr):
            raise AssertionError(f"{kind}: a fraction outside [0, 1]")
        if not ((np.diff(top4, axis=-1) <= 0).all()
                and (top4.sum(-1) <= 1 + 1e-12).all()):
            raise AssertionError(f"{kind} top-4 fractions {top4}")
        if winding and not ((o["winding_either"] >= np.maximum(
                o["winding_x"], o["winding_y"])).all() and (o["winding_both"] <= np.minimum(
                o["winding_x"], o["winding_y"])).all()):
            raise AssertionError(f"{kind}: winding either / both against x, y")
    return obs


def houdn_main(dev, card):
    """Phase 24: config 4 with cmr+houd4 SW and the moves' statistics
    through Ising.sample twice from one seed: launch counts, two equal
    checksums (spins, records, overlap_csd, top_cluster_sizes), the
    histograms against the stats graphs, the rates and the host's share."""
    from peapods_tpu_torch.engine import loop

    n = SG_CONFIGS["config4"]["sweeps"]
    warmup = int(np.floor(n * 0.25 + 0.5))
    runs, check = twice("cmr+houd4", dev, HOUDN_KW, n, move_counts(HOUDN_KW, n, warmup))
    (m0, r0, launches), (m1, _, _) = runs
    graphs = mode_graphs(m0._sim, HOUDN_KW, n, warmup)
    check_mode_stats(r0, m0._sim, graphs)
    e, q2 = r0["energies"], r0["overlap2"]
    if not (np.isfinite(e).all() and e[0] > e[-1] and q2[0] > q2[-1]):
        raise AssertionError(f"cmr+houd4 sanity: <e> {e}, <q^2> {q2}")
    top = r0["top_cluster_sizes"]
    log("24 cmr+houd4", f"8x8x8 +-J, {SG_T} temps x {SG_R} replicas x {SG_D} "
        f"realizations, cmr+houd4 SW every 10 sweeps with cluster statistics, {n} "
        f"sweeps on {dev}: launches {launches}; checksum {check} == {check}; "
        f"sum_s s csd[s] = 512 x {graphs} graphs (cmr, houd4) ok; top_cluster_sizes "
        f"at T[0] cmr {np.round(top[0][0], 5).tolist()}, houd4 "
        f"{np.round(top[1][0], 5).tolist()}; <e>[0,-1] {e[0]:.5f}, {e[-1]:.5f}; "
        f"<q^2>[0,-1] {q2[0]:.5f}, {q2[-1]:.5f}")
    sweeps_s, rates = warm_rate(m1, n, HOUDN_KW)
    sim = m1._sim
    cfg = sim_config(sim, HOUDN_KW)
    t0 = time.perf_counter()
    loop._event_tables(sim.rt, cfg, sim.state["base_keys"], 0, 0, 256)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) * 1e6 / 256
    log("24 cmr+houd4", f"host: the overlap-move tables (a CMR and a houd4 table) of "
        f"a 256-sweep chunk take {host_us:.1f} us per sweep against "
        f"{1e6 / sweeps_s:.1f} us of wall time per sweep")
    log("24 cmr+houd4", f"kernel path: {sweeps_s:.1f} sweeps/s = "
        f"{sweeps_s * 512 * SG_R * SG_T * SG_D:.4e} flips/s (single-spin attempts) "
        f"on {card} (median of {', '.join(f'{r:.1f}' for r in rates)} sweeps/s)")
    return dict(model=m1, result=r0, sweeps_s=sweeps_s, launches=launches,
                kw=HOUDN_KW, checksum=check, host_us=host_us)


def houdn_wolff(dev, card):
    """Phase 25: config 4 with Houdayer(4) in its Wolff form, no statistics,
    twice from one seed (launch counts, equal checksums) and its rate."""
    n = SG_CONFIGS["config4"]["sweeps"]
    runs, check = twice("houd4", dev, HOUDN_WOLFF_KW, n,
                        move_counts(HOUDN_WOLFF_KW, n, 0))
    (m0, r0, launches), (m1, _, _) = runs
    if not np.isfinite(r0["energies"]).all() or "overlap_csd" in r0:
        raise AssertionError("houd4 Wolff: records or keys")
    sweeps_s, rates = warm_rate(m1, n, HOUDN_WOLFF_KW)
    log("25 houd4", f"8x8x8 +-J config 4 with houd4 (Wolff) every 10 sweeps, {n} "
        f"sweeps on {dev}: launches {launches}; checksum {check} == {check}; kernel "
        f"path {sweeps_s:.1f} sweeps/s = {sweeps_s * 512 * SG_R * SG_T * SG_D:.4e} "
        f"flips/s on {card} (median of {', '.join(f'{r:.1f}' for r in rates)})")
    return dict(model=m1, sweeps_s=sweeps_s, launches=launches, kw=HOUDN_WOLFF_KW,
                checksum=check)


def houdn_glass(dev):
    """Phase 25: the 4x4 +-J glass of glass_physics with R = 4 and PT and
    the move every sweep.  houd4 (Wolff, SW) on the card bitwise the plain
    path on the CPU over HOUDN_BITWISE_SWEEPS; over HOUDN_GLASS_SWEEPS the
    pair-Houdayer control against exact enumeration (GLASS tolerances) and
    houd4's deviation from it, measured."""
    from peapods_tpu_torch import Ising

    rng = np.random.default_rng(44)
    J = rng.choice([-1.0, 1.0], size=(4, 4, 2)).astype(np.float32)
    temps = np.array([0.8, 1.3, 2.0], np.float32)
    exact = [glass_4x4_exact(J.reshape(16, 2), float(t)) for t in temps]

    def run(device, n, build, mode):
        m = Ising((4, 4), couplings=J, temperatures=temps, n_replicas=4, seed=7,
                  device=device)
        r = m.sample(n, pt_interval=1, overlap_cluster_update_interval=1,
                     overlap_cluster_build_mode=build, overlap_cluster_mode=mode,
                     warmup_ratio=0.1)
        return m, r

    for mode in ("wolff", "sw"):
        (mk, rk), (mp, rp) = (run(d, HOUDN_BITWISE_SWEEPS, "houd4", mode)
                              for d in (dev, "cpu"))
        for key in ("spins", "system_ids", "pt_edge_acceptances"):
            if not torch.equal(mk._sim.state[key].cpu(), mp._sim.state[key]):
                raise AssertionError(f"4x4 houd4 ({mode}): {key} differs from the CPU")
        for key in ("energies", "overlap2"):
            np.testing.assert_allclose(rk[key], rp[key], rtol=1e-12, err_msg=key)
        log("25 physics", f"4x4 +-J glass, R=4, houd4 ({mode}) every sweep + PT, "
            f"{HOUDN_BITWISE_SWEEPS} sweeps: the card's run bitwise the plain path's "
            "on the CPU (spins, sid, PT counts) ok")
    for build, mode in (("houdayer", "wolff"), ("houd4", "wolff"), ("houd4", "sw")):
        m, _ = run(dev, HOUDN_GLASS_SWEEPS, build, mode)
        de = m.energies_avg - np.array([x[0] for x in exact])
        dq = m.overlap2 - np.array([x[1] for x in exact])
        exact_ok = (np.abs(de) < GLASS_E_TOL).all() and (np.abs(dq) < GLASS_Q2_TOL).all()
        if build == "houdayer" and not exact_ok:
            raise AssertionError(f"4x4 glass R=4 ({build}): dE {de}, dq2 {dq}")
        if not (np.isfinite(de).all() and ((m.overlap2 >= 0) & (m.overlap2 <= 1)).all()):
            raise AssertionError(f"4x4 glass R=4 ({build}, {mode}): records")
        verdict = ("within the tolerances" if exact_ok else
                   "outside the tolerances: Houdayer(N > 2) is not Boltzmann-exact")
        log("25 physics", f"4x4 +-J glass, R=4, T {temps.tolist()}, {build} ({mode}) "
            f"every sweep + PT, {HOUDN_GLASS_SWEEPS} sweeps on {dev}: <E> - exact "
            f"{np.round(de, 4).tolist()}, <q^2> - exact {np.round(dq, 4).tolist()} "
            f"({verdict} {GLASS_E_TOL} / {GLASS_Q2_TOL})")


def overlap_observe(dev, card):
    """Phase 26: overlap observe (houdayer+jorg+cmr SW) at config 4's shape
    (every 10 sweeps, 3D: no winding) and on the 64^2 square (every sweep,
    with winding), each twice from one seed (launch counts, equal
    checksums), the observations' invariants, each run bitwise the same run
    without overlap moves (spins, sid, PT counts, records) and its rate."""
    out = {}
    c2 = OV_OBSERVE_2D
    for name, kw, n, glass, winding in (
            ("observe3d", OV_OBSERVE_KW, SG_CONFIGS["config4"]["sweeps"], {}, False),
            ("observe2d", c2["kw"], c2["sweeps"],
             dict(shape=c2["shape"], t=c2["t"], n_temps=c2["n_temps"],
                  n_replicas=c2["n_replicas"], n_disorder=c2["n_disorder"], seed=26),
             True)):
        warmup = int(np.floor(n * 0.25 + 0.5))
        runs, check = twice(name, dev, kw, n, move_counts(kw, n, warmup, observe=True,
                                                          winding=winding), **glass)
        (m0, r0, launches), (m1, _, _) = runs
        obs = check_overlap_observations(r0, m0._sim, kw, n, warmup, winding)
        graphs = mode_graphs(m0._sim, kw, n, warmup)
        check_mode_stats(r0, m0._sim, graphs)
        plain, rp, _ = glass_run(dev, dict(pt_interval=1), n, **glass)
        for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
            if not torch.equal(m0._sim.state[key], plain._sim.state[key]):
                raise AssertionError(f"{name}: {key} differs from the run without moves")
        for key in ("energies", "energies2", "mags2", "overlap", "overlap2",
                    "link_overlap", "overlap_histogram"):
            if not np.array_equal(np.asarray(r0[key]), np.asarray(rp[key])):
                raise AssertionError(f"{name}: {key} differs from the run without moves")
        rt = m0._sim.rt
        shape = "x".join(map(str, rt.lattice.shape))
        log(f"26 {name}", f"{shape} +-J, {rt.n_temps} temps x {rt.n_replicas} replicas "
            f"x {rt.n_disorder} realizations, houdayer+jorg+cmr SW observe every "
            f"{kw['overlap_cluster_update_interval']} sweeps, {n} sweeps on {dev}: "
            f"launches {launches}; checksum {check} == {check}; observations ok; "
            "spins, sid, PT counts and records bitwise the run without overlap "
            f"moves; bond density at T[0] " + ", ".join(
                f"{k} {o['active_bond_density'][0, 0]:.5f}" for k, o in obs.items())
            + ("; winding either at T[-1] " + ", ".join(
                f"{k} {o['winding_either'][0, -1]:.4f}" for k, o in obs.items())
               if winding else ""))
        sweeps_s, rates = warm_rate(m1, n, kw)
        log(f"26 {name}", f"kernel path: {sweeps_s:.1f} sweeps/s = "
            f"{sweeps_s * rt.n_spins * rt.n_systems * rt.n_disorder:.4e} flips/s on "
            f"{card} (median of {', '.join(f'{r:.1f}' for r in rates)} sweeps/s)")
        out[name] = dict(model=m1, sweeps_s=sweeps_s, launches=launches, kw=kw,
                         checksum=check)
    return out


def move_tables(rng, d, n_replicas, n_temps, n, kind, wolff, g, dev):
    """One move's tables on the device: tasks of groups of ``g`` replicas,
    scalars, probes and key words, from random realization keys."""
    from peapods_tpu_torch.engine import seeds

    keys = rng.integers(0, 2**32, (d, 2), dtype=np.uint64).astype(np.uint32)
    tasks, tkeys = seeds.overlap_tasks(keys, [5], n_replicas, n_temps, g)
    scal, probes = seeds.event_scalars(kind, wolff, tkeys[0], n)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (up(tasks[0]), up(scal.reshape(-1, 6)), up(probes.reshape(-1, 64)),
            up(tkeys[0].view(np.int32).reshape(-1, 2)))


def check_houdn_kernels(main, wolff_run, obs, dev, rng):
    """Row 20 (houdn_bonds -> fk_link -> houdn_finish) in both forms with
    labels at g = 4 on config 4's equilibrated cmr+houd4 state and at g = 6
    on a 12-replica state stacked from it; row 19's labels (grey and blue
    for CMR), masks and observe form for each kind (SW) there; and on each
    overlap-observe run's own state (3D, and the 64^2 square with winding
    on the masks and labels) every kind's observe form: everything bitwise
    the plain versions.  Then the plain versions' times and the bounds of
    each form: ``{kernel: record}`` with ``at_<run>`` beside the main one."""
    from peapods_tpu_torch.ops import cluster, overlap, winding

    x = pair_inputs(main, dev)
    rt = x["rt"]
    shape = rt.lattice.shape
    d, s = x["sid"].shape
    n = rt.n_spins
    # a 12-replica state: the 4 replicas, then two copies from the
    # neighbouring realizations
    stacked = dict(spins=torch.cat([x["spins"], x["spins"].roll(1, 0),
                                    x["spins"].roll(2, 0)], 1).contiguous(),
                   sid=torch.cat([x["sid"], x["sid"].roll(1, 0) + s,
                                  x["sid"].roll(2, 0) + 2 * s], 1).contiguous())
    for g, st, n_rep in ((4, x, rt.n_replicas), (6, stacked, 3 * rt.n_replicas)):
        for wolff in (True, False):
            tab = move_tables(rng, d, n_rep, rt.n_temps, n, "houdayer", wolff, g, dev)
            a, b = st["spins"].clone(), st["spins"].clone()
            kw = dict(kind="houdayer", wolff=wolff, shape=shape, with_labels=True)
            gk = overlap.overlap_event(a, st["sid"], tab[0], rt.coup, rt.temps,
                                       *tab[1:], **kw)
            gp = overlap.overlap_event_plain(b, st["sid"], tab[0], rt.coup, rt.temps,
                                             *tab[1:], **kw)
            torch.cuda.synchronize()
            bad = {"spins": int((a != b).sum()),
                   "labels": int((gk.labels != gp.labels).sum())}
            flipped = int((a != st["spins"]).sum())
            msg = (f"row 20 houd{g} ({'wolff' if wolff else 'sw'}) on "
                   f"{d} x {rt.n_temps} x {n_rep // g} groups of {g}: mismatches {bad}; "
                   f"{flipped} spins flipped, "
                   f"{int((gk.labels == torch.arange(n, device=dev)).sum())} clusters")
            if any(bad.values()) or not flipped:
                raise AssertionError(msg)
            log("24 kernel-vs-plain", msg + " ok")
    for kind in ("houdayer", "jorg", "cmr"):
        tab = move_tables(rng, d, rt.n_replicas, rt.n_temps, n, kind, False, 2, dev)
        graphs = {}
        for observe in (False, True):
            a, b = x["spins"].clone(), x["spins"].clone()
            kw = dict(kind=kind, wolff=False, shape=shape, with_labels=True,
                      with_masks=True, observe=observe)
            gk = overlap.overlap_event(a, x["sid"], tab[0], rt.coup, rt.temps,
                                       *tab[1:], **kw)
            gp = overlap.overlap_event_plain(b, x["sid"], tab[0], rt.coup, rt.temps,
                                             *tab[1:], **kw)
            torch.cuda.synchronize()
            bad = graph_mismatches(a, b, gk, gp)
            if any(bad.values()) or torch.equal(a, x["spins"]) != observe:
                raise AssertionError(f"row 19 {kind} (sw, observe={observe}): {bad}")
            graphs[observe] = gk
        if not (torch.equal(graphs[True].stats, graphs[False].stats)
                and torch.equal(graphs[True].masks, graphs[False].masks)):
            raise AssertionError(f"row 19 {kind}: the observe form's graph differs")
        log("24 kernel-vs-plain", f"row 19 {kind} (sw) at config 4: labels"
            f"{' (grey and blue)' if kind == 'cmr' else ''}, the stats graph's masks "
            f"[{d * rt.n_temps * rt.n_pairs}, {n}, {len(shape)}] and the observe form "
            "(no spin written, the same stats graph) bitwise the plain version ok")

    def flips(st, tab, wolff):
        sp = st["spins"].clone()
        overlap.overlap_event_plain(sp, st["sid"], tab[0], rt.coup, rt.temps, *tab[1:],
                                    kind="houdayer", wolff=wolff, shape=shape)
        return int((sp != st["spins"]).sum())

    # the plain version's time (the whole move) and the bounds of each form
    # at its run's shape and state: cmr+houd4 SW with labels (the main
    # record), Wolff houd4 without labels (groups of 4: d T tasks)
    b, g = d * rt.n_temps * (rt.n_replicas // 4), 4
    out = {}
    for name, st, wolff, labels in (("main", x, False, True),
                                    ("houd4_wolff", pair_inputs(wolff_run, dev), True,
                                     False)):
        tab = move_tables(rng, d, rt.n_replicas, rt.n_temps, n, "houdayer", wolff, g, dev)
        plain_ms = wall_ms(lambda: overlap.overlap_event_plain(
            st["spins"].clone(), st["sid"], tab[0], rt.coup, rt.temps, *tab[1:],
            kind="houdayer", wolff=wolff, shape=shape, with_labels=labels), 3)
        for k, (bound_ms, bound_by) in houdn_bounds(
                b, n, g, d, s, wolff=wolff, labels=labels,
                flipped=flips(st, tab, wolff)).items():
            rec = dict(max_abs_err=0.0, bound_ms=bound_ms, bound_by=bound_by,
                       plain_ms=plain_ms, plain_is="the whole Houdayer(4) move"
                       + (", with labels" if labels else ""))
            if name == "main":
                out[k] = rec
            else:
                out[k][f"at_{name}"] = rec
    # every kind's observe form on each observe run's own state; on the
    # canonical square, winding on the stats graph's masks and labels
    for name, run in obs.items():
        y = pair_inputs(run, dev)
        rt_o = y["rt"]
        shape_o = rt_o.lattice.shape
        d_o, s_o = y["sid"].shape
        n_o = rt_o.n_spins
        b_o = d_o * rt_o.n_temps * rt_o.n_pairs
        wind = rt_o.lattice.canonical_square
        for kind in ("houdayer", "jorg", "cmr"):
            tab = move_tables(rng, d_o, rt_o.n_replicas, rt_o.n_temps, n_o, kind, False,
                              2, dev)
            a, b_sp = y["spins"].clone(), y["spins"].clone()
            args = (y["sid"], tab[0], rt_o.coup, rt_o.temps, *tab[1:])
            kw = dict(kind=kind, wolff=False, shape=shape_o, with_labels=True,
                      with_masks=True, observe=True)
            gk = overlap.overlap_event(a, *args, **kw)
            gp = overlap.overlap_event_plain(b_sp, *args, **kw)
            torch.cuda.synchronize()
            bad = graph_mismatches(a, b_sp, gk, gp)
            bad["spins written"] = int((a != y["spins"]).sum())
            extra = ""
            if wind:
                wk = winding.winding_flags(gk.masks, gk.stats, shape_o)
                wp = cluster.winding_flags(gp.masks, gp.stats, shape_o)
                torch.cuda.synchronize()
                bad["winding"] = int((wk[0] != wp[0]).sum() + (wk[1] != wp[1]).sum())
                extra = (f", winding: {int(wk[0].sum())} / {int(wk[1].sum())} graphs "
                         "wind along x / y")
            if any(bad.values()):
                raise AssertionError(f"row 19 {kind} observe on {name}: {bad}")
            log("26 kernel-vs-plain", f"{kind} observe form on {name}'s state ({b_o} "
                f"graphs of {'x'.join(map(str, shape_o))}): labels"
                f"{' (blue)' if kind == 'cmr' else ''}, masks"
                f"{' and winding flags' if wind else ''} bitwise the plain version, no "
                f"spin written: mismatches {bad}; "
                f"{int((gk.stats == torch.arange(n_o, device=dev)).sum())} clusters, "
                f"{int(gk.masks.sum())} active bonds{extra} ok")
            if kind != "houdayer":
                continue
            plain_ms = wall_ms(lambda: overlap.overlap_event_plain(
                y["spins"].clone(), *args, **kw), 3)
            for k, (bound_ms, bound_by) in houdn_bounds(
                    b_o, n_o, 2, d_o, s_o, wolff=False, labels=True, flipped=0,
                    observe=True).items():
                out[k][f"at_{name}"] = dict(
                    max_abs_err=0.0, bound_ms=bound_ms, bound_by=bound_by,
                    plain_ms=plain_ms, plain_is="the whole pair-Houdayer observe move")
            if wind:
                masks, labels = gp.masks, gp.stats
                out[f"winding_{name}"] = dict(
                    max_abs_err=0.0,
                    plain_ms=wall_ms(lambda: cluster.winding_flags(masks, labels,
                                                                   shape_o), 2),
                    **dict(zip(("bound_ms", "bound_by"), bound(6 * b_o * n_o + b_o, 0))))
    return out


def graph_mismatches(a, b, gk, gp):
    """Spins and the :class:`MoveGraphs` fields (labels, blue, masks) of a
    kernel move against its plain version: differing elements each (1 where
    one of them is missing)."""
    bad = {"spins": int((a != b).sum())}
    for f in ("labels", "blue", "masks"):
        k, p = getattr(gk, f), getattr(gp, f)
        bad[f] = (int((k != p).sum()) if k is not None and p is not None
                  else int((k is None) != (p is None)))
    return bad


def add_houdn_records(kernels, pk, main, wolff, obs, houdn, us, card):
    """The kernels line's records of row 20's kernels (phase 24's numbers;
    Wolff houd4's, config 4's pair Houdayer and the observe runs' beside
    them) and phase 24's / 26's numbers beside row 19's kernels and
    winding's."""
    per_sweep = lambda run, k: run["launches"].get(k, 0) / run["launches"]["pair_overlap"]  # noqa: E731

    def at(run, name, k):
        return dict(launches=run["launches"][k], ms=us[name][k] / 1e3,
                    launches_per_sweep=per_sweep(run, k))

    runs = (("houd4_wolff", wolff, "wolff"), ("observe3d", obs["observe3d"], "observe3d"),
            ("observe2d", obs["observe2d"], "observe2d"))
    for k in ("houdn_bonds", "houdn_finish"):
        kr = dict(name=k, route="cuda", source=HOUDN_SRC, replaces=HOUDN_REPLACES,
                  library_ms=None, **at(main, "main", k),
                  **{f: v for f, v in houdn[k].items() if not f.startswith("at_")})
        for name, run, key in runs:
            kr[f"at_{name}"] = dict(houdn[k][f"at_{name}"], **at(run, key, k))
        kr["at_config4"] = dict(pk["config4"][k], replaces=EV_REPLACES,
                                launches_per_sweep=pk["config4"][k]["launches"]
                                / SG_CONFIGS["config4"]["sweeps"])
        kernels.append(kr)
    def move_bounds(run):
        """Row 19's bounds per launch on a run's shapes, as config 5's (an
        observe form writes each task's labels where an update reads and
        writes its spins: the same bytes)."""
        rt = run["model"]._sim.rt
        n, nd = rt.n_spins, rt.lattice.n_dims
        b = rt.n_disorder * rt.n_temps * rt.n_pairs
        cb = 4 * nd * rt.n_disorder * n
        return {"ov_bonds": bound(2 * b * n + cb + 5 * b * n, 12 * nd * b * n),
                "fk_link": bound(5 * b * n, 0),
                "ov_mid": bound(5 * b * n + cb + 5 * b * n, 12 * nd * b * n),
                "ov_finish": bound(9 * b * n, 4 * b * n)}

    by_name = {kr["name"]: kr for kr in kernels}
    for k in ("ov_bonds", "fk_link", "ov_mid", "ov_finish"):
        for run, name in ((main, "main"), (obs["observe3d"], "observe3d"),
                          (obs["observe2d"], "observe2d")):
            if k in run["launches"]:
                by_name[k][f"at_{'cmr_houd4' if name == 'main' else name}"] = dict(
                    at(run, name, k), **dict(zip(("bound_ms", "bound_by"),
                                                 move_bounds(run)[k])))
    w = by_name["winding"]
    w["at_observe2d"] = dict(houdn["winding_observe2d"],
                             **at(obs["observe2d"], "observe2d", "winding"))
    for k in ("houdn_bonds", "houdn_finish"):
        kr = by_name[k]
        log("24 times", f"{k} per launch: cmr+houd4 (SW, labels) {kr['ms']:.5f} ms x "
            f"{kr['launches_per_sweep']:g} a sweep (bound {kr['bound_ms']:.6f} ms by "
            f"{kr['bound_by']}, plain {kr['plain_ms']:.4f} ms, the whole move); " + "; ".join(
                f"{name} {v['ms']:.5f} ms x {v['launches_per_sweep']:g} a sweep (bound "
                f"{v['bound_ms']:.6f} ms, plain {v['plain_ms']:.4f} ms)"
                for name, v in ((key[3:], kr[key]) for key in kr if key.startswith("at_")))
            + f" on {card}")
    v = w["at_observe2d"]
    log("26 times", f"winding per launch at observe2d: {v['ms']:.5f} ms x "
        f"{v['launches_per_sweep']:g} a sweep (bound {v['bound_ms']:.6f} ms by "
        f"{v['bound_by']}, plain {v['plain_ms']:.4f} ms) on {card}")


# ------------------------------------------------ the space-sharded path


HALO_SRC = "peapods_tpu_torch/csrc/halo.cu"
CC_BAND_SRC = "peapods_tpu_torch/csrc/cc_band.cu"
ROW5 = "peapods_tpu/ops/pallas_sweep.py:339"  # _kernel_color_halo
ROW6 = "peapods_tpu/ops/pallas_sweep.py:522"  # _kernel_color_halo_packed (W < 128)
ROW9 = "peapods_tpu/ops/pallas_sweep3d.py:514"  # _kernel_color_halo3d
ROW13 = "peapods_tpu/ops/pallas_sweep_diag.py:654"  # _kernel_gen_halo
ROW17 = "peapods_tpu/ops/pallas_cc_band.py:169"  # _band_kernel
SPACE_BANDS = 4
SPACE_SW = dict(pt_interval=1, cluster_update_interval=1, cluster_mode="sw")
# the slice's headline run: 256 times the flagship's sites at T_c, in bands
SPACE_BIG = dict(shape=(4096, 4096), offsets=None, t=(2.25, 2.29), n_temps=4,
                 sweeps=128, kw=SPACE_SW, replaces=ROW5)
# each in 4 bands on the card, bitwise its unsharded per-sweep run
SPACE_RUNS = {
    "flagship": dict(shape=(L, L), offsets=None, t=(1.8, 3.2), n_temps=N_TEMPS,
                     sweeps=512, kw=dict(pt_interval=1), replaces=ROW5),
    "narrow64": dict(shape=(64, 64), offsets=None, t=(1.8, 3.2), n_temps=16,
                     sweeps=256, kw=dict(pt_interval=1), replaces=ROW6),
    "cubic128": dict(shape=(128, 128, 128), offsets=None, t=(4.4, 4.6), n_temps=8,
                     sweeps=64, kw=SPACE_SW, replaces=ROW9),
    "tri256": dict(shape=(256, 256), offsets="triangular", t=(3.4, 3.9), n_temps=8,
                   sweeps=256, kw=dict(pt_interval=1), replaces=ROW13),
    "fcc32": dict(shape=(32, 32, 32), offsets="fcc", t=(8.5, 11.0), n_temps=8,
                  sweeps=128, kw=dict(SPACE_SW, collect_cluster_stats=True),
                  replaces=ROW13),
}
CC_BAND_KERNELS = ("cc_band_link", "cc_band_border", "cc_band_flatten", "cc_band_export",
                   "cc_band_merge", "cc_band_resolve", "cc_band_write")
SPACE_KERNELS = ("sweep_halo", "measure_halo", "fk_bonds_band", *CC_BAND_KERNELS,
                 "fk_finish_band", "pt_step")


# the unsharded per-sweep run's kernels at 4096^2
UNSHARDED_KERNELS = ("sweep_2d", *FK_KERNELS, "pt_step")


def log_unsharded_link(run, card):
    """The unsharded 4096^2 run's labelling over a main-path window: each
    launch's device time, and an FK phase's against its bound (the state
    bytes in and the labels out, 5 bytes a site)."""
    from peapods_tpu_torch.ops import fk

    c = SPACE_BIG
    prof = run["profile"]
    n_sites = int(np.prod(c["shape"])) * c["n_temps"]
    link = {k: prof["per_launch"][k] / 1e3 for k in FK_KERNELS
            if k.startswith("fk_link") and k in prof["per_launch"]}
    names = tuple(fk.link_launches(c["shape"], c["n_temps"]))
    if set(link) != set(names):
        raise AssertionError(f"unsharded 4096^2: the profiler saw {sorted(link)}, "
                             f"expected {names}")
    run["labelling"] = dict(ms=sum(link.values()), per_launch=link,
                            bound_ms=bound(5 * n_sites, 0)[0])
    log("28 space", f"unsharded 4096^2: the labelling {run['labelling']['ms']:.5f} ms an "
        f"FK phase (" + ", ".join(f"{k} {v:.5f}" for k, v in link.items())
        + f" ms a launch) against its bound {run['labelling']['bound_ms']:.5f} ms; "
        f"{prof['line']} (on {card})")


def reset_space_counts():
    from peapods_tpu_torch.ops import cc_band, halo

    reset_cluster_counts()
    for table in (halo.LAUNCHES, cc_band.LAUNCHES):
        for k in table:
            table[k] = 0


def space_counts():
    """Every per-sweep kernel's launches since the last reset, those that
    ran."""
    from peapods_tpu_torch.ops import cc_band, halo

    counts = {**cluster_counts(), **halo.LAUNCHES, **cc_band.LAUNCHES}
    return {k: v for k, v in counts.items() if v}


class per_sweep_path:
    """Drive ``sample`` through the unsharded per-sweep path
    (``run_chunk_sweeps``) on every lattice, the square's too, whose
    unsharded run would otherwise take the mega path."""

    def __enter__(self):
        from peapods_tpu_torch.engine import loop, simulation

        self.saved = simulation.run_chunk
        simulation.run_chunk = loop.run_chunk_sweeps

    def __exit__(self, *exc):
        from peapods_tpu_torch.engine import simulation

        simulation.run_chunk = self.saved


def space_sim(c, dev, bands):
    """A ferromagnet of a space run's configuration: ``bands`` row bands on
    the one card (a mesh naming it ``bands`` times), or unsharded (None)."""
    from peapods_tpu_torch.engine.simulation import IsingSimulation
    from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS
    from peapods_tpu_torch.parallel.mesh import make_mesh

    offsets = GEOMETRY_OFFSETS[c["offsets"]] if c["offsets"] else None
    nb = len(offsets) if offsets else len(c["shape"])
    temps = np.geomspace(*c["t"], c["n_temps"]).astype(np.float32)
    mesh = (None if bands is None
            else make_mesh(bands, ("space",), devices=[dev] * bands))
    return IsingSimulation(list(c["shape"]), np.ones(tuple(c["shape"]) + (nb,), np.float32),
                           temps, 1, offsets, SEED, mesh=mesh, device=dev)


def space_checksum(sim, result) -> str:
    """state_checksum over the spins gathered from the bands."""
    h = hashlib.sha256()
    h.update(sim.all_spins().cpu().numpy().tobytes())
    h.update(sim.state["system_ids"].cpu().numpy().tobytes())
    h.update(np.asarray(sim.state["counter"], np.int32).tobytes())
    for key in ("mags", "mags2", "energies", "energies2"):
        h.update(np.asarray(result[key]).tobytes())
    if "fk_csd" in result:
        h.update(np.asarray(result["fk_csd"]).tobytes())
    return h.hexdigest()[:16]


def space_want(sim, c, n, bands):
    """The launches a space run of ``n`` sweeps must count: every colour pass
    of every band; on FK sweeps the band forms and the banded labelling's
    fixed sequence (five launches a band, the merge's two); measure_halo
    where neither the last pass (square, cubic) nor an FK update (square,
    triangular, cubic) measures."""
    lat = sim.lattice
    k = c["kw"].get("cluster_update_interval")
    n_fk = len(range(0, n, k)) if k else 0
    fused = lat.hypercubic or lat.triangular
    n_meas = 0 if lat.hypercubic else (n - n_fk if fused else n)
    want = {"sweep_halo": n * lat.n_colors * bands, "pt_step": n,
            "measure_halo": n_meas * bands}
    if n_fk:
        want.update(dict.fromkeys(("fk_bonds_band", "cc_band_link", "cc_band_border",
                                   "cc_band_flatten", "cc_band_export", "cc_band_write",
                                   "fk_finish_band"), n_fk * bands),
                    cc_band_merge=n_fk, cc_band_resolve=n_fk)
    return {key: v for key, v in want.items() if v}


def space_run(name, c, dev, bands, card, n=None):
    """One run of a space configuration through IsingSimulation.sample: in
    ``bands`` bands (None: the unsharded per-sweep path), launch counts
    zeroed just before and read just after, a checksum, the rate."""
    n = n or c["sweeps"]
    t_setup = time.perf_counter()
    sim = space_sim(c, dev, bands)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t_setup
    reset_space_counts()
    t0 = time.perf_counter()
    if bands is None:
        with per_sweep_path():
            result = sim.sample(n, "metropolis", **dict(c["kw"], warmup_ratio=0.25))
    else:
        result = sim.sample(n, "metropolis", **dict(c["kw"], warmup_ratio=0.25))
    torch.cuda.synchronize()
    sweeps_s = n / (time.perf_counter() - t0)
    launches = space_counts()
    if bands is not None:
        want = space_want(sim, c, n, bands)
        if launches != want:
            raise AssertionError(f"{name} in {bands} bands: launches {launches}, "
                                 f"expected {want}")
    e = result["energies"]
    if not np.isfinite(e).all():
        raise AssertionError(f"{name}: energies {e}")
    n_sites = int(np.prod(c["shape"])) * c["n_temps"]
    label = ("unsharded per-sweep path" if bands is None
             else f"{bands} band{'s' if bands > 1 else ''} on one card")
    extra = ""
    if bands is not None and "cc_band_merge" in launches:
        extra = (f", {sum(launches[k] for k in CC_BAND_KERNELS) / launches['cc_band_merge']:g}"
                 " banded-CC launches an FK phase")
    log("28 space" if name == "4096" else "29 space",
        f"{name} ({'x'.join(map(str, c['shape']))}"
        f"{' ' + c['offsets'] if c['offsets'] else ''} x {c['n_temps']} temps geomspace"
        f"{c['t']}, {c['kw']}, {n} sweeps) {label}: set-up {t_setup:.2f} s, "
        f"{sweeps_s:.2f} sweeps/s = "
        f"{sweeps_s * n_sites:.4e} flips/s (first call, host clock) on {card}; launches "
        f"{launches}{extra}; checksum {space_checksum(sim, result)}")
    return dict(sim=sim, result=result, sweeps_s=sweeps_s, launches=launches,
                checksum=space_checksum(sim, result), n=n)


def space_profile(sim, kw, sweeps_s, n, names=None):
    """Per-launch device time and launches per sweep of each band kernel
    (or of ``names``) over ``n`` sweeps of a space run, the halo copies'
    device time per sweep, and the busy share of the unprofiled wall time
    per sweep."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.sample(n, "metropolis", **dict(kw, warmup_ratio=0.0))
        torch.cuda.synchronize()
    acc = {}
    copies = other = 0.0
    for ev in prof.key_averages():
        if ev.self_device_time_total <= 0:
            continue
        hit = [k for k in names or SPACE_KERNELS if f"{k}_kernel" in ev.key]
        if hit:
            add_kernel_time(acc, hit[0], ev)
        elif ev.device_type != DeviceType.CPU:
            if "copy" in ev.key.lower() or "memcpy" in ev.key.lower():
                copies += ev.self_device_time_total / n
            else:
                other += ev.self_device_time_total / n
    per_launch = {k: t / c for k, (t, c) in acc.items()}
    per_sweep = {k: t / n for k, (t, c) in acc.items()}
    counts = {k: c / n for k, (t, c) in acc.items()}
    busy = sum(per_sweep.values()) + copies + other
    cc_us = sum(per_sweep.get(k, 0.0) for k in CC_BAND_KERNELS)
    line = ("device us per sweep: " + ", ".join(f"{k} {v:.3f}" for k, v in per_sweep.items())
            + f", halo and gather copies {copies:.3f}, other device work {other:.3f}, sum "
            f"{busy:.3f} against {1e6 / sweeps_s:.3f} us of wall time per sweep: the "
            f"device is busy {busy * sweeps_s / 1e6:.3f} of it")
    return dict(per_launch=per_launch, per_sweep=counts, copies_us=copies, busy=busy,
                cc_us=cc_us, line=line)


def band_pass_ties(band, win, f, bw, col, temps, words, colour, gibbs):
    """Sites of a band's colour pass whose decision lies within TIE_ULPS ulp
    of its threshold on the pass's input: bool [d, S, n_band]."""
    from peapods_tpu_torch.ops import halo

    *_, active, lhs, thr, _ = halo.pass_decisions(win, f, bw, col, temps, words, band,
                                                  colour, gibbs=gibbs)
    ulp = (torch.nextafter(thr, torch.full_like(thr, np.inf)) - thr).abs()
    return ((lhs - thr).abs() <= TIE_ULPS * ulp) & active


def space_bounds(sim):
    """``(bound_ms, bound_by)`` per launch of each band kernel on band 0 of
    a space simulation (bytes: each input read once, each output written
    once; f32 operations; writes whose count depends on the data, such as
    the roots a union-find hangs, are not counted), and ``"labelling"``:
    the least a whole banded labelling could take, the state bytes in and
    the labels out on every band."""
    from peapods_tpu_torch.ops import cc_band

    sp, lat = sim.rt.space, sim.lattice
    b0 = sp.bands[0]
    n_bands, e = len(sp.bands), cc_band.n_slots(b0)
    g = n_sys = sim.rt.n_disorder * sim.rt.n_systems
    nb, nc, nw, nbd = lat.n_neighbors, lat.n_colors, b0.n_window, b0.n_band
    active = n_sys * nbd // nc
    n_blk = ((nbd + 3) // 4 + 255) // 256
    measure = lat.hypercubic or lat.triangular
    colours = 0 if lat.square else nw  # the square form reads its parity
    return {
        # the window's spins, the active sites' couplings, the colours in;
        # the active spins out; 4 n_nb + 20 operations an active site
        "sweep_halo": bound(n_sys * nw + 8 * nb * nbd // nc + colours + 4 * n_sys + 8
                            + active, (4 * nb + 20) * active),
        "measure_halo": bound(n_sys * nw + 4 * nb * nbd + 8 * n_sys * n_blk,
                              3 * nb * n_sys * nbd),
        # spins and couplings in; the state byte out
        "fk_bonds_band": bound(g * nw + 4 * nb * nw + 12 * g + g * nw, 8 * nb * g * nw),
        # the state bytes in, the parents out (and cmin at the tile roots)
        "cc_band_link": bound(5 * g * nw, 0),
        # the state bytes in (and the parents of the roots it hangs)
        "cc_band_border": bound(g * nw, 0),
        # the parents in (and the changed parents, the roots' slots out)
        "cc_band_flatten": bound(4 * g * nw, 0),
        # each slot's parent in, its node and value out
        "cc_band_export": bound(12 * g * e, 0),
        # every slot's merge parent in (and the roots' values)
        "cc_band_merge": bound(4 * g * e * n_bands, 0),
        # every slot's merge parent in, its set minimum out
        "cc_band_resolve": bound(8 * g * e * n_bands, 0),
        # the parents in, the labels out
        "cc_band_write": bound(8 * g * nw, 0),
        "labelling": bound(5 * g * nw * n_bands, 0),
        "fk_finish_band": bound(2 * g * nbd + g * nbd + 4 * g * nw + 4 * nb * nbd + 12 * g
                                + (8 * g * ((nbd + 255) // 256) if measure else 0),
                                30 * g * nbd),
    }


def band_cc_stages(name, kern, plain, bands, dev):
    """The banded labelling of the same state bytes, ``kern``'s by the
    kernels stage by stage and ``plain``'s by ``banded_labels_plain``: each
    kernel bitwise its plain version on the kernels' own inputs (the link's
    three: parents and the roots' slots; the export: nodes and values; the
    merge and resolve: the set minima; the write: every window site's
    label, halos included), and the two labellings equal.  Returns the
    merge's inputs with their set minima."""
    from peapods_tpu_torch.ops import cc_band

    def same(what, a, b):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} on {name} differs from its plain version")

    cc_band.banded_labels_plain(plain, bands)
    for x, b in zip(kern, bands):
        cc_band.link(x, b)
    mb = cc_band.BandMerge.empty(kern[0].state.shape[0], bands, dev)
    for x, b in zip(kern, bands):
        cc_band.export(x, b, mb)
    inputs = cc_band.BandMerge(mb.rep.clone(), mb.val.clone(), torch.empty_like(mb.labels))
    cc_band.merge(mb)
    for x, b in zip(kern, bands):
        cc_band.write(x, b, mb.labels[b.k])
    torch.cuda.synchronize()
    for x, y, b in zip(kern, plain, bands):
        same("cc_band_link / _border / _flatten (parents)", x.parent, y.parent)
        roots = x.parent.long()
        same("cc_band_flatten (the roots' slots)", x.cmin.gather(1, roots),
             y.cmin.gather(1, roots))
        rep, val = (torch.empty_like(inputs.rep[0]) for _ in range(2))
        cc_band.export_plain(x, b, rep, val)
        same("cc_band_export (nodes)", inputs.rep[b.k], rep)
        same("cc_band_export (values)", inputs.val[b.k], val)
    cc_band.merge_plain(inputs)
    same("cc_band_merge / _resolve", mb.labels, inputs.labels)
    for x, y, b in zip(kern, plain, bands):
        z = cc_band.BandCC(x.state, x.parent, torch.empty_like(x.labels), x.cmin)
        cc_band.write_plain(z, b, inputs.labels[b.k])
        same("cc_band_write", x.labels, z.labels)
        same("the banded labels", x.labels, y.labels)
    return inputs


def check_space_kernels(name, sim, dev, rng):
    """Each band kernel against its plain version on the card, on the state
    of a 4-band run: every colour pass of every band (Metropolis and Gibbs,
    exp ties counted), measure_halo, the FK band forms (SW and Wolff) and
    the banded labels; the plain versions' times and the bounds per launch
    on band 0 of this state."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import cc_band, fk, halo

    t_check = time.perf_counter()
    sp, lat = sim.rt.space, sim.lattice
    bands = sp.bands
    d, n_sys = 1, sim.rt.n_systems
    temps = sim.rt.temps[None].contiguous()
    recs = {k: dict(max_abs_err=0.0) for k in SPACE_KERNELS if k != "pt_step"}
    ties = decisions = 0
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (1, 2)).astype(np.int32)).to(dev)
    wins = [w.clone() for w in sim.state["bands"]]
    for gibbs in (False, True):
        for colour in range(lat.n_colors):
            halo.exchange(wins, bands)
            last = colour == lat.n_colors - 1 and lat.hypercubic
            for j, b in enumerate(bands):
                args = (sp.coup_fwd[j], sp.coup_bwd[j], sp.colours[j], temps, words, b,
                        colour)
                tie = band_pass_ties(b, wins[j], *args[:5], colour, gibbs)
                a, c = wins[j].clone(), wins[j].clone()
                pk = halo.sweep_halo(a, *args, gibbs=gibbs, measure=last)
                pp = halo.sweep_halo_plain(c, *args, gibbs=gibbs, measure=last)
                torch.cuda.synchronize()
                diff = (a != c)[..., b.interior]
                if (diff & ~tie).any():
                    raise AssertionError(f"sweep_halo on {name} band {j} colour "
                                         f"{colour} gibbs={gibbs}: "
                                         f"{int((diff & ~tie).sum())} spins differ "
                                         "away from ulp ties")
                ties += int((diff & tie).sum())
                decisions += n_sys * (b.n_band // 2 if lat.square else int(
                    (sp.colours[j][b.interior] == colour).sum()))
                if last and not torch.equal(pk[1].sum(-1), pp[1].sum(-1)):
                    raise AssertionError(f"sweep_halo on {name}: m differs")
                if last:
                    err = float((pk[0].double().sum(-1) - pp[0].double().sum(-1))
                                .abs().max())
                    if err:
                        raise AssertionError(f"sweep_halo on {name}: e differs by {err}")
                wins[j] = c
    if ties > MAX_TIE_SHARE * decisions:
        raise AssertionError(f"sweep_halo on {name}: {ties} ties in {decisions}")
    recs["sweep_halo"].update(ulp_ties=ties, decisions=decisions,
                              max_abs_err=2.0 if ties else 0.0)
    halo.exchange(wins, bands)
    for j, b in enumerate(bands):
        ek, mk = halo.measure_halo(wins[j], sp.coup_fwd[j], b)
        ep, mp = halo.measure_halo_plain(wins[j], sp.coup_fwd[j], b)
        torch.cuda.synchronize()
        if not (torch.equal(mk.sum(-1), mp.sum(-1))
                and torch.equal(ek.sum(-1), ep.sum(-1))):
            raise AssertionError(f"measure_halo on {name} band {j} differs")
    # the FK band forms and the banded labels at the run's temperatures
    g = d * n_sys
    gw = [w.view(g, -1) for w in wins]
    measure = fk.fused_lattice(lat)
    kb = torch.from_numpy(rng.integers(-2**31, 2**31, (g, 2)).astype(np.int32)).to(dev)
    # the bonds and labels do not depend on the update's kind: SW and Wolff
    # finish from the same ones
    ccs = {}
    for kind in ("kernel", "plain"):
        ws = [w.clone() for w in gw]
        ccs[kind] = [cc_band.BandCC.empty(g, b, dev) for b in bands]
        bonds = fk.fk_bonds_band if kind == "kernel" else fk.fk_bonds_band_plain
        for j, b in enumerate(bands):
            bonds(ws[j], sp.coup_fwd[j], temps.view(-1), kb, ccs[kind][j], b)
    torch.cuda.synchronize()
    # every window site's state byte (the halo rows' bonds too)
    if not all(torch.equal(x.state, y.state) for x, y in zip(ccs["kernel"], ccs["plain"])):
        raise AssertionError(f"fk_bonds_band on {name} differs from its plain version")
    merged = band_cc_stages(name, ccs["kernel"], ccs["plain"], bands, dev)
    lk = torch.cat([cb.labels[:, b.interior] for cb, b in zip(ccs["kernel"], bands)], -1)
    n_comp = int(sum(int(torch.unique(lk[i]).numel()) for i in range(g)))
    del lk
    for wolff in (False, True):
        kf = rng.integers(0, 2**32, (g, 2), dtype=np.uint64).astype(np.uint32)
        scal = torch.from_numpy(seeds.fk_scalars(kf, lat.n_spins, wolff=wolff)).to(dev)
        res = {}
        for kind in ("kernel", "plain"):
            ws = [w.clone() for w in gw]
            seed_lab = fk.wolff_seed_labels(ccs[kind], bands, scal[:, 2]) if wolff else None
            fin = fk.fk_finish_band if kind == "kernel" else fk.fk_finish_band_plain
            parts = [fin(ws[j], ccs[kind][j], sp.coup_fwd[j], scal, seed_lab, b, wolff=wolff,
                         measure=measure) for j, b in enumerate(bands)]
            torch.cuda.synchronize()
            res[kind] = (torch.cat([w[:, b.interior] for w, b in zip(ws, bands)], -1),
                         [torch.cat([p[i] for p in parts], -1).sum(-1) for i in (0, 1)]
                         if measure else [])
        (xk, pk), (xp, pp) = res["kernel"], res["plain"]
        if not torch.equal(xk, xp):
            raise AssertionError(f"fk_finish_band on {name} (wolff={wolff}) differs "
                                 "from its plain version")
        for a, b in zip(pk, pp):
            if not torch.equal(a, b):
                raise AssertionError(f"fk_finish_band partials on {name} differ")
    del ccs
    log("27 kernel-vs-plain", f"{name}: sweep_halo ok ({len(bands)} bands, "
        f"{lat.n_colors} colours, Metropolis and Gibbs: {decisions} decisions, 0 "
        f"differ but {ties} ulp ties); measure_halo ok (bitwise); fk_bonds_band, the "
        f"banded labels (each of cc_band_link / _border / _flatten, _export, _merge / "
        f"_resolve, _write on its inputs, every window site's label) and "
        f"fk_finish_band ok, SW and Wolff (state bytes, parents, slots, labels, "
        f"spins{' and partials' if measure else ''} bitwise; {n_comp} components in {g} "
        "graphs)")
    # plain times and bounds per launch on band 0 of this state (the
    # kernels' times come from the runs' profiled windows)
    bounds = space_bounds(sim)
    recs["labelling"] = dict(zip(("bound_ms", "bound_by"), bounds.pop("labelling")))
    for k, (bms, by) in bounds.items():
        recs[k].update(bound_ms=bms, bound_by=by)
    b0, w0 = bands[0], wins[0]
    args0 = (sp.coup_fwd[0], sp.coup_bwd[0], sp.colours[0], temps, words, b0, 0)
    w_a = w0.clone()
    recs["sweep_halo"]["plain_ms"] = wall_ms(
        lambda: halo.sweep_halo_plain(w_a, *args0, gibbs=False), 1)
    recs["measure_halo"]["plain_ms"] = wall_ms(
        lambda: halo.measure_halo_plain(w_a, sp.coup_fwd[0], b0), 1)
    cb0 = cc_band.BandCC.empty(g, b0, dev)
    g0 = w_a.view(g, -1)
    tv = temps.view(-1)
    recs["fk_bonds_band"]["plain_ms"] = wall_ms(
        lambda: fk.fk_bonds_band_plain(g0, sp.coup_fwd[0], tv, kb, cb0, b0), 1)
    # the plain link does the work of three kernels, the plain merge of two
    t = wall_ms(lambda: cc_band.link_plain(cb0, b0), 1)
    for k in ("cc_band_link", "cc_band_border", "cc_band_flatten"):
        recs[k]["plain_ms"] = t
    rep, val = (torch.empty_like(merged.rep[0]) for _ in range(2))
    recs["cc_band_export"]["plain_ms"] = wall_ms(
        lambda: cc_band.export_plain(cb0, b0, rep, val), 1)
    recs["cc_band_merge"]["plain_ms"] = recs["cc_band_resolve"]["plain_ms"] = wall_ms(
        lambda: cc_band.merge_plain(merged), 1)
    recs["cc_band_write"]["plain_ms"] = wall_ms(
        lambda: cc_band.write_plain(cb0, b0, merged.labels[0]), 1)
    sl = torch.zeros(g, dtype=torch.int32, device=dev)
    w_f = w_a.view(g, -1).clone()
    recs["fk_finish_band"]["plain_ms"] = wall_ms(lambda: fk.fk_finish_band_plain(
        w_f, cb0, sp.coup_fwd[0], scal, sl, b0, wolff=False, measure=measure), 1)
    log("27 kernel-vs-plain", f"{name}: the checks took {time.perf_counter() - t_check:.1f} s")
    return recs


def log_space_times(name, prof, check, card, kw):
    """The profile line of a 4-band run: each band kernel's device time per
    launch and launches per sweep against its bound and plain time; on FK
    runs the banded labelling's device time per FK phase against its bound
    (kept in ``check["labelling"]["ms"]``)."""
    per = "; ".join(
        f"{k} {prof['per_launch'][k] / 1e3:.5f} ms x {prof['per_sweep'][k]:g} a sweep"
        + (f" (bound {check[k]['bound_ms']:.7f} ms"
           + (f", plain {check[k]['plain_ms']:.5f} ms" if "plain_ms" in check[k] else "")
           + ")" if k in check else "")
        for k in prof["per_launch"])
    log("30 times", f"{name} in 4 bands: {prof['line']}; per launch: {per} on {card}")
    interval = kw.get("cluster_update_interval")
    if interval and prof["cc_us"]:
        lab = check["labelling"]
        lab["ms"] = prof["cc_us"] / 1e3 * interval
        log("28 space" if name == "4096" else "30 times",
            f"{name} in 4 bands: the banded labelling {lab['ms']:.5f} ms of device time an "
            f"FK phase against its bound {lab['bound_ms']:.5f} ms ({lab['bound_by']}: the "
            f"state bytes in, the labels out) on {card}")


def space_paths(dev, card, mega_sweeps_s):
    """Phases 27-30: the 4096^2 SW + PT run at T_c in 4 bands, 1 band and
    unsharded (equal checksums), the flagship shape, a narrow 64^2, 128^3,
    256^2 triangular and 32^3 FCC in 4 bands, each bitwise its unsharded
    per-sweep run, every band kernel against its plain version on each
    4-band run's state (the 4096^2 one's too), and the band kernels'
    device times over main-path windows."""
    from peapods_tpu_torch.ops import _build

    t_all = time.perf_counter()
    rng = np.random.default_rng(2030)
    big, checks = {}, {}
    for label, bands in (("4 bands", SPACE_BANDS), ("1 band", 1), ("unsharded", None)):
        run = space_run("4096", SPACE_BIG, dev, bands, card)
        if label == "4 bands":
            run["profile"] = space_profile(run["sim"], SPACE_BIG["kw"], run["sweeps_s"], 8)
            checks["4096"] = check_space_kernels("4096", run["sim"], dev, rng)
            # pt_step folds the fk_finish_band partials of every band
            blocks = len(run["sim"].rt.space.bands) * _build.library().peapods_fk_blocks(
                run["sim"].rt.space.bands[0].n_band)
            checks["4096"]["pt_step"] = dict(zip(("bound_ms", "bound_by"), pt_step_bound(
                1, SPACE_BIG["n_temps"], blocks, True, False)), partials=blocks,
                **check_pt_step_rows(dev, rng))
            log_space_times("4096", run["profile"], checks["4096"], card, SPACE_BIG["kw"])
            log("28 space", "ptxas, the banded labelling's kernels and the other band "
                "kernels: " + band_kernel_resources(_build.build_info["log"]))
        if label == "unsharded":
            with per_sweep_path():
                run["profile"] = space_profile(run["sim"], SPACE_BIG["kw"],
                                               run["sweeps_s"], 4, UNSHARDED_KERNELS)
            log_unsharded_link(run, card)
        run.pop("sim")
        big[label] = run
        torch.cuda.empty_cache()
    sums = {k: v["checksum"] for k, v in big.items()}
    if len(set(sums.values())) != 1:
        raise AssertionError(f"4096^2 checksums differ: {sums}")
    log("28 space", f"4096^2 SW + PT at T_c: checksums equal in 4 bands, 1 band and "
        f"unsharded ({sums['unsharded']}); 4 bands run at "
        f"{big['4 bands']['sweeps_s'] / big['unsharded']['sweeps_s']:.3f} of the "
        f"unsharded rate, 1 band at {big['1 band']['sweeps_s'] / big['unsharded']['sweeps_s']:.3f}")
    runs, plain = {}, {}
    for name, c in SPACE_RUNS.items():
        runs[name] = space_run(name, c, dev, SPACE_BANDS, card)
        plain[name] = space_run(name, c, dev, None, card)
        if runs[name]["checksum"] != plain[name]["checksum"]:
            raise AssertionError(f"{name}: 4 bands {runs[name]['checksum']}, unsharded "
                                 f"{plain[name]['checksum']}")
        extra = (f"; the mega path {mega_sweeps_s:.1f} sweeps/s (phase 4)"
                 if name == "flagship" else "")
        log("29 space", f"{name}: 4 bands bitwise the unsharded per-sweep run "
            f"({runs[name]['checksum']}); {runs[name]['sweeps_s']:.1f} against "
            f"{plain[name]['sweeps_s']:.1f} sweeps/s{extra} on {card}")
        plain[name].pop("sim")
    for name, run in runs.items():
        checks[name] = check_space_kernels(name, run["sim"], dev, rng)
    for name, run in runs.items():
        prof = space_profile(run["sim"], SPACE_RUNS[name]["kw"], run["sweeps_s"],
                             16 if name == "cubic128" else 32)
        run["profile"] = prof
        log_space_times(name, prof, checks[name], card, SPACE_RUNS[name]["kw"])
    for name in ("fcc32", "tri256"):
        chk = checks[name]["sweep_halo"]
        log("30 times", f"sweep_halo per launch at {name}: "
            f"{runs[name]['profile']['per_launch']['sweep_halo'] / 1e3:.5f} ms against its "
            f"bound {chk['bound_ms']:.7f} ms ({chk['bound_by']}) on {card}")
    log("30 times", f"phases 27-30 took {time.perf_counter() - t_all:.1f} s")
    return dict(big=big, runs=runs, plain=plain, checks=checks)


def add_space_records(kernels, sp):
    """The band kernels' records: launches, per-launch times, bounds and
    plain times of the run on whose path each kernel is (the 4096^2 run in
    4 bands; measure_halo: 256^2 triangular), each other run's numbers
    beside them; rows 6, 9 and 13 as sweep_halo records of their runs."""
    src = {"sweep_halo": HALO_SRC, "measure_halo": HALO_SRC,
           "fk_bonds_band": "peapods_tpu_torch/csrc/fk.cu",
           "fk_finish_band": "peapods_tpu_torch/csrc/fk.cu",
           **dict.fromkeys(CC_BAND_KERNELS, CC_BAND_SRC)}
    rep = {"sweep_halo": ROW5, "measure_halo": ROW13, "fk_bonds_band":
           "peapods_tpu/ops/pallas_event.py:621", "fk_finish_band":
           "peapods_tpu/ops/pallas_event.py:621", **dict.fromkeys(CC_BAND_KERNELS, ROW17)}
    big4 = sp["big"]["4 bands"]
    for k in src:
        main = "tri256" if k == "measure_halo" else "4096"
        main_run = sp["runs"]["tri256"] if main == "tri256" else big4
        check = sp["checks"][main][k]
        at = {}
        for name, run in sp["runs"].items():
            chk = sp["checks"][name][k]
            t = run["profile"]["per_launch"].get(k)
            at[f"at_{name}"] = dict(
                chk, launches=run["launches"].get(k, 0),
                ms=None if t is None else t / 1e3,
                replaces=SPACE_RUNS[name]["replaces"] if k == "sweep_halo" else rep[k])
        kernels.append(dict(
            name=k, route="cuda", source=src[k], replaces=rep[k],
            launches=main_run["launches"][k],
            max_abs_err=max(sp["checks"][n][k]["max_abs_err"] for n in sp["checks"]),
            ms=main_run["profile"]["per_launch"][k] / 1e3, plain_ms=check["plain_ms"],
            bound_ms=check["bound_ms"], bound_by=check["bound_by"], library_ms=None,
            run=main, **at))
    # the unsharded 4096^2 run's labelling, on the fk_link record
    unsharded = sp["big"]["unsharded"]
    fk_link = next(kr for kr in kernels if kr["name"] == "fk_link")
    fk_link["at_space4096_unsharded"] = dict(
        unsharded["labelling"], launches={k: unsharded["launches"][k]
                                          for k in unsharded["labelling"]["per_launch"]})
    # pt_step at 4096^2 in 4 bands, on the flagship's pt_step record
    pt = next(kr for kr in kernels if kr["name"] == "pt_step")
    pt["at_space4096"] = dict(sp["checks"]["4096"]["pt_step"],
                              ms=big4["profile"]["per_launch"]["pt_step"] / 1e3,
                              launches=big4["launches"]["pt_step"])
    # the whole banded labelling per FK phase, on the cc_band_link record
    link = next(kr for kr in kernels if kr["name"] == "cc_band_link")
    for name, chk in sp["checks"].items():
        if "ms" in chk["labelling"]:
            link[f"labelling_{name}"] = dict(fk_phase_ms=chk["labelling"]["ms"],
                                             bound_ms=chk["labelling"]["bound_ms"])
    for name in ("narrow64", "cubic128", "tri256"):
        chk = sp["checks"][name]["sweep_halo"]
        run = sp["runs"][name]
        kernels.append(dict(
            name="sweep_halo", route="cuda", source=HALO_SRC,
            replaces=SPACE_RUNS[name]["replaces"], launches=run["launches"]["sweep_halo"],
            max_abs_err=chk["max_abs_err"],
            ms=run["profile"]["per_launch"]["sweep_halo"] / 1e3, plain_ms=chk["plain_ms"],
            bound_ms=chk["bound_ms"], bound_by=chk["bound_by"], library_ms=None,
            run=name))


def ptxas_entries(text):
    """``(library, None, 0, 0, 0)`` for each library the ``ptxas -v`` log
    of the build names, then ``(None, kernel, registers, shared bytes,
    spill bytes)`` for each of its entry functions (spill stores and loads
    added)."""
    fn, spill = None, 0
    for ln in text.splitlines():
        if ln.endswith(".so:"):
            yield ln.rsplit("/", 1)[-1].split("_")[0], None, 0, 0, 0
        entry = re.search(r"Compiling entry function '([^']+)'", ln)
        if entry:
            fn, spill = entry.group(1), 0
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if spills:
            spill = int(spills.group(1)) + int(spills.group(2))
        used = re.search(r"Used (\d+) registers", ln)
        if used and fn:
            smem = re.search(r"(\d+) bytes smem", ln)
            yield (None, kernel_name(fn), int(used.group(1)),
                   int(smem.group(1)) if smem else 0, spill)
            fn = None


def kernel_registers(text) -> str:
    """``library: kernel registers, ...`` from the ``ptxas -v`` log of the
    build: each entry function's registers under its kernel's name."""
    out = []
    for lib, name, regs, *_ in ptxas_entries(text):
        out.append(("|" if out else "") + lib + ":" if name is None else f"{name} {regs}")
    return " ".join(out)


def band_kernel_resources(text) -> str:
    """``name registers, shared bytes, spill bytes`` of each banded-CC
    kernel, of ``fk_bonds_band``, ``fk_finish_band``, ``measure_halo`` and
    of ``sweep_halo`` (one entry for each of its forms: the square form and
    1 to 6 offsets) from the ``ptxas -v`` log of the build."""
    return "; ".join(f"{name} {regs} registers, {smem} B shared, {spill} B spilled"
                     for _, name, regs, smem, spill in ptxas_entries(text)
                     if name and (name.startswith("cc_band_")
                                  or name in ("fk_bonds_band", "fk_finish_band",
                                              "measure_halo", "sweep_halo")))


def kernel_name(mangled) -> str:
    """The ``<name>`` of a mangled ``..<length><name>_kernel..`` entry."""
    end = mangled.find("_kernel") + len("_kernel")
    for start in range(end - len("_kernel"), 0, -1):
        digits = re.search(r"\d+$", mangled[:start])
        if digits and any(int(digits.group(0)[i:]) == end - start
                          for i in range(len(digits.group(0)))):
            return mangled[start:end - len("_kernel")]
    return mangled


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from peapods_tpu_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    log("1 device", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    _build.library()
    log("2 build", f"built {len(_build.build_info['paths'])} libraries "
        f"({', '.join(_build.build_info['paths'])}) in {time.perf_counter() - t0:.2f} s; "
        f"ptxas registers by kernel: {kernel_registers(_build.build_info['log'])}")

    # the mega path
    rng = np.random.default_rng(2024)
    cp = check_colour_pass(dev, rng)
    pts = check_pt_step(dev, rng)

    sweeps_s, rates, launches, sim = flagship(dev)
    flips = sweeps_s * N_TEMPS * L * L
    log("4 flagship", f"kernel path: {sweeps_s:.1f} sweeps/s = {flips:.4e} flips/s "
        f"on {card} (median of {', '.join(f'{r:.1f}' for r in rates)} sweeps/s)")

    log("5 times", kernel_share(sim, sweeps_s))
    plain_s = plain_path_rate(sim, 16)
    log("5 times", f"plain torch path: {plain_s:.2f} sweeps/s = "
        f"{plain_s * N_TEMPS * L * L:.4e} flips/s; kernel path {sweeps_s:.1f} "
        f"sweeps/s ({sweeps_s / plain_s:.1f}x) on {card}")
    log("5 times", f"colour_pass {cp['ms']:.5f} ms (bound {cp['bound_ms']:.5f} ms, "
        f"plain {cp['plain_ms']:.4f} ms), pt_step {pts['ms']:.5f} ms (bound "
        f"{pts['bound_ms']:.5f} ms, plain {pts['plain_ms']:.4f} ms) per launch")

    # the per-sweep path with cluster updates
    c3 = config3(dev, card)
    hs = harness(dev, card)
    rng = np.random.default_rng(2025)
    ks = {"sweep_2d": check_sweep_2d(dev, rng, card),
          **check_fk({"config3": c3["model"], "harness": hs["model"]}, dev, rng,
                     card)}
    pt_ps = check_pt_step_per_sweep({"config3": c3["model"],
                                     "harness": hs["model"]}, dev)
    exact_4x4_cluster(dev)
    # per-launch device times over main-path windows; the sweep's launches
    # are one colour each
    for name, run, n in (("config3", c3, 512), ("harness", hs, 32)):
        us, line = profile_window(run["model"], run["kw"], run["sweeps_s"], n,
                                  names=tuple(run["launches"]))
        log("10 times", f"{name} {line}")
        here = {k: rec["shapes"][name] for k, rec in ks.items() if name in rec["shapes"]}
        for k, rec in here.items():
            rec["ms"] = us[k] / 1e3
        pt_ps[name].update(ms=us["pt_step"] / 1e3,
                           launches=run["launches"]["pt_step"])
        log("10 times", f"{name} per launch: " + "; ".join(
            f"{k} {rec['ms']:.5f} ms (bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']}, plain {rec['plain_ms']:.4f} ms)"
            for k, rec in here.items()) + f" on {card}")
        rec = pt_ps[name]
        log("10 times", f"{name} pt_step per launch: {rec['ms']:.5f} ms (bound "
            f"{rec['bound_ms']:.5f} ms by {rec['bound_by']}, plain "
            f"{rec['plain_ms']:.4f} ms) on {card}")
    for rec in ks.values():
        shapes = rec.pop("shapes")
        rec.update(shapes["config3"])
        if "harness" in shapes:
            rec["at_harness"] = shapes["harness"]

    # the replica path: configs 4 and 5
    runs = {name: sg_config(name, dev, card) for name in SG_CONFIGS}
    hot_pq(runs["config4"])
    glass_physics(dev)
    pk = check_pair_kernels(runs, dev, np.random.default_rng(2026))
    pair_times(runs, pk, dev)
    for name, run in runs.items():
        us = pair_profile(run, 200 if name == "config4" else 100, card, name)
        for k, rec in pk[name].items():
            rec["ms"] = us[k] / 1e3 if k in us else None
            rec["launches"] = run["launches"].get(k, 0)
        log("14 times", f"{name} per launch: " + "; ".join(
            f"{k} {rec['ms']:.5f} ms (bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']}, plain {rec['plain_ms']:.4f} ms)"
            for k, rec in pk[name].items() if rec["ms"] is not None) + f" on {card}")

    # the per-sweep path on the coloured lattices
    nb = coloured_paths(dev, card)

    # FK observe and the staged FK path
    obs = observe_main(dev, card)
    hobs = observe_harness(dev, card)
    staged = staged_paths(dev, card)
    ob_times = check_observe_kernels(obs, hobs, staged, dev, np.random.default_rng(2028))
    ob_us = observe_times(obs, hobs, staged, card)

    # Houdayer(N), the overlap moves' statistics and overlap observe
    hmain = houdn_main(dev, card)
    hwolff = houdn_wolff(dev, card)
    houdn_glass(dev)
    hobs_ov = overlap_observe(dev, card)
    houdn = check_houdn_kernels(hmain, hwolff, hobs_ov, dev, np.random.default_rng(2029))
    h_us = {"main": pair_profile(hmain, 200, card, "cmr+houd4", "24 times"),
            "wolff": pair_profile(hwolff, 200, card, "houd4 wolff", "25 times"),
            **{name: pair_profile(run, 200 if name == "observe3d" else 32, card, name,
                                  "26 times") for name, run in hobs_ov.items()}}

    # the space-sharded path: row bands on the one card
    space = space_paths(dev, card, sweeps_s)

    mega_src = "peapods_tpu_torch/csrc/mega.cu"
    mega_replaces = "peapods_tpu/ops/pallas_mega.py:96"
    fk_src = "peapods_tpu_torch/csrc/fk.cu"
    fk_replaces = "peapods_tpu/ops/pallas_event.py:621"
    mp_replaces = "peapods_tpu/ops/pallas_megapair.py:325"
    ev_replaces = EV_REPLACES
    kernels = [
        dict(name="colour_pass", route="cuda", source=mega_src,
             replaces=mega_replaces, launches=launches["colour_pass"], **cp),
        dict(name="pt_step", route="cuda", source=mega_src,
             replaces=mega_replaces, launches=launches["pt_step"], **pts,
             at_config3=pt_ps["config3"], at_harness=pt_ps["harness"]),
        dict(name="sweep_2d", route="cuda", source="peapods_tpu_torch/csrc/sweep.cu",
             replaces="peapods_tpu/ops/pallas_sweep.py:301",
             launches=c3["launches"]["sweep_2d"], **ks.pop("sweep_2d")),
    ] + [dict(name=k, route="cuda", source=fk_src, replaces=fk_replaces,
              launches=c3["launches"][k], **v) for k, v in ks.items()]
    # colour_pass and pt_step also carry the replica path (row 21), fk_link
    # the overlap moves (row 19)
    for kr in kernels:
        rep = {"colour_pass": mp_replaces, "pt_step": mp_replaces,
               "fk_link": ev_replaces}.get(kr["name"])
        for name in SG_CONFIGS if rep else ():
            kr[f"at_{name}"] = dict(pk[name][kr["name"]], replaces=rep)
    for k, src, rep in (("pair_overlap", "pairs.cu", mp_replaces),
                        ("ov_bonds", "overlap.cu", ev_replaces),
                        ("ov_mid", "overlap.cu", ev_replaces),
                        ("ov_finish", "overlap.cu", ev_replaces),
                        ("energy_partials", "overlap.cu", ev_replaces)):
        # the numbers of config 4's main path (config 5's for the ov_*
        # kernels, which only Joerg and CMR launch), and config 5's beside
        # them
        main = "config5" if k.startswith("ov_") else "config4"
        kr = dict(name=k, route="cuda", source=f"peapods_tpu_torch/csrc/{src}",
                  replaces=rep, library_ms=None, **pk[main][k])
        if main == "config4":
            kr["at_config5"] = pk["config5"][k]
        kernels.append(kr)
    add_nb_records(kernels, nb)
    add_observe_records(kernels, obs, hobs, staged, ob_times, ob_us, card)
    add_houdn_records(kernels, pk, hmain, hwolff, hobs_ov, houdn, h_us, card)
    add_space_records(kernels, space)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    record = {"kernels": [{**{k: kr[k] for k in keys},
                           **{k: v for k, v in kr.items() if k not in keys
                              and k != "ties"}} for kr in kernels]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
