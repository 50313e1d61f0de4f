"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``peapods_tpu_torch`` from the sources in this
checkout (one nvcc per source, all at once) and drives the port's paths
through the user's entry points:

* the mega path: the flagship configuration (256x256, 24 temperatures, PT
  every sweep) through ``IsingSimulation.sample``, one ``mega_resident``
  launch a chunk of 256 sweeps (the route ``ops/mega.py`` ``resident_route``
  picks, printed), its checksum the one of the three launches a sweep; a
  chunk of its state through the resident kernel, the three launches and
  the plain torch chunk, bitwise (ulp ties counted apart); both routes'
  device time a sweep and sweeps/s in the same run; ``colour_pass`` and
  ``pt_step`` (the three launches, and the other paths' kernels) held
  against their plain torch versions at the flagship's shapes (``pt_step``
  also on gaussian partials at the 4096^2 bands' and config 5's shapes,
  bitwise: its rows add in one fixed order);
* the per-sweep path with SW / Wolff cluster updates: config 3 (256x256 at
  T_c, SW every sweep) through ``Ising.sample`` twice from one seed, its
  Binder cumulant against the torus value, a Wolff run against it, SW with
  PT on the 64x64 x 16 temperatures x 128 realizations harness shape, 4x4
  exact enumeration, and each kernel (``sweep_2d``, ``fk_bonds``,
  ``fk_link``, ``fk_finish``, ``pt_step``) held against its plain version
  at both shapes (``sweep_2d``'s every partial bitwise
  ``sweep_2d_partials``', gaussian couplings too), the labelling one
  launch at a time (``fk_link`` in its
  whole-graph form, or tiled with ``fk_link_border`` and
  ``fk_link_flatten``), ``fk_bonds`` alone (every state byte bitwise) and
  ``fk_finish`` alone on the labelling's parents (spins and every partial
  block bitwise);
* the replica path: configs 4 (8^3 +-J glass, Houdayer every 10 sweeps,
  PT on a random edge) and 5 (16^3 gaussian glass, Joerg + CMR every 10
  sweeps, full-ladder PT), each 24 temperatures x 4 replicas x 8
  realizations, through ``Ising.sample`` twice from one seed; q and P(q) at
  config 4's hottest temperature; a 4x4 +-J glass against exact
  enumeration with each overlap move; and each kernel (``colour_pass`` in
  3D, ``pair_overlap``, ``pt_step`` on R ladders, ``houdn_bonds``,
  ``houdn_finish`` (Houdayer), ``ov_bonds``, ``ov_mid``, ``ov_finish``
  (Joerg, CMR), ``fk_link``, ``energy_partials``) held against its plain
  version at both configs' shapes (``houdn_bonds`` and the finishes also
  launched alone, against ``houdn_states_plain`` and ``finish_plain``);
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
  next-nearest-neighbour table through the staged path (bonds, the
  labelling ``cc_link``, flips), NNN observe against the same run
  without the observer (bitwise), a 4x4 NNN magnet with staged SW against
  exact enumeration, and each kernel (the winding flags: ``winding`` on
  the harness's graphs, and on the 256^2 graph the tiled form's
  ``winding_link``, ``_border``, ``_wrap``, ``_check`` one launch at a
  time; ``cc_link`` (whole graphs, over a cluster of CTAs a graph where
  the batch is small; on the 256^2 graph tiled, with ``cc_link_border``
  and ``fk_link_flatten``), ``fk_bonds_staged``,
  ``fk_finish`` reading the CC labels; FK observe's labels, the
  labelling's parents) held against its plain version on those runs'
  states;
* Houdayer(N), the overlap moves' statistics and overlap observe: config 4
  with ``cmr+houd4`` SW and cluster statistics through ``Ising.sample``
  twice from one seed (checksums over spins, records, ``overlap_csd`` and
  ``top_cluster_sizes``; the histograms against the stats graphs; the
  rates and the host's share), config 4 with Wolff ``houd4``, a 4x4 +-J
  glass with R = 4 (houd4 on the card bitwise the plain path on the CPU;
  the pair-Houdayer control against exact enumeration, houd4's deviation
  from it measured), SW overlap observe at config 4's shape and on a 64^2
  square with winding (the observations' invariants, each run bitwise the
  run without overlap moves; the observe form launches no finish, the
  labelling's parents handed on as the labels), and ``houdn_bonds`` /
  ``houdn_finish`` (g = 4 and 6; each also alone, with ``fk_link``'s
  labels between them) and the pair moves' labels, masks and observe form
  held against their plain versions;
* the space-sharded path (a lattice split into row bands over a
  ``("space",)`` mesh that names the one card four times, through
  ``IsingSimulation.sample``): a 4096^2 ferromagnet at T_c with SW and PT
  every sweep in 4 bands, in 1 band and unsharded (three equal checksums,
  each run's rate); the flagship shape, a narrow 64^2 square, 128^3 cubic
  with SW + PT, 256^2 triangular with PT and 32^3 FCC with SW + PT + cluster
  statistics, each in 4 bands bitwise its unsharded per-sweep run (the
  32^3 FCC one through the staged path's tiled labelling, held against
  its plain version on that run's state and timed); every
  band kernel (``sweep_halo``, ``measure_halo``, ``fk_bonds_band``, the
  banded labelling's ``cc_band_link`` / ``_border`` / ``_flatten`` /
  ``_export`` / ``_merge`` / ``_resolve`` / ``_write``, ``fk_finish_band``)
  held against its plain version on those runs' states; and the band
  kernels' device times (the labelling's per FK phase beside its bound),
  the halo copies' and the busy share over main-path windows, and their
  ptxas registers and spills; the unsharded 4096^2 run's labelling,
  ``fk_finish``, ``fk_bonds`` and ``sweep_2d`` (their times and bounds,
  each bitwise its plain version on the run's state);
* the per-sweep replica path: ``tests/binder_crossings.py``'s largest case
  on each lattice at full width (32^2 square and triangular x 32
  temperatures, 10^3 cubic, BCC and FCC x 24; R = 2, SW and PT every
  sweep; 256 sweeps) and config 4 with ``cmr+houd4`` SW every 10 sweeps,
  cluster statistics and ``snapshot_interval=10``, each through
  ``Ising.sample`` twice from one seed (launch counts, two equal
  checksums, sanity, the snapshots' entries), each run's device time a
  sweep and busy share over a profiled window, and ``pair_overlap`` over
  each lattice's offsets on the run's state against its plain version,
  its time a launch beside its bound;
* autocorrelation, the equilibration diagnostic, checkpoints and the
  physics scripts (phase 35): the flagship with
  ``autocorrelation_max_lag=1000`` and ``equilibration_diagnostic=True``
  (its launches and checksum unchanged, the taus and ``equil_*`` of the
  reference's shapes, the rate with the options on and off, the fold's
  device time a chunk), the ring and fft backends at config 5 and config
  3 (taus within 1e-10, each checksum that of the run without the
  options), a 64^2 run on the card bitwise the CPU's (taus and ``equil_*``
  within 1e-12, or the sweep where they part held to ulp ties), the
  flagship saved after 2048 sweeps and resumed bitwise the uninterrupted
  run (the file loading on the CPU too), and
  ``tests/autocorrelation_scaling.py`` and ``tests/overlap_histogram.py``
  through ``tools/physics_torch.py``, each passing its own assertions;
* any lattice (phase 36): odd extents, extent 1, 1D, 4D and up and more
  than six offsets at full width, each twice from one seed;
* the Python layer (phase 37): ``peapods-torch simulate`` on the flagship
  configuration through ``cli.main`` in this process (16 ``mega_resident``
  launches, 24 rows, the ``.npz`` bitwise ``Ising(...).sample(...)``),
  ``bench`` beside phase 4's rate, ``sweep --config`` on
  ``examples/sweep_config.toml`` at its own widths cut to 2000 sweeps
  (both labels' files with ``_model_npz_entries``' keys, finite, the FK
  histograms summing to n_spins x graphs, the 8^3 runs again bitwise),
  ``utils/profiling.py`` ``trace()`` around flagship and config-3 sweeps
  (the ``peapods/sweep`` and ``peapods/measure`` scopes and the kernels'
  names in the Chrome trace, launches and checksums as outside it), a
  flagship run interrupted from ``progress`` and resumed bitwise, and a
  checkpoint whose dynamics seed is 2^63 or more loaded on the card and
  on the CPU;
* replicas on the table lattices (phase 38): the 4D +-J Edwards-Anderson
  glass at full width (10^4 sites x 12 temperatures x 2 replicas x 16
  realizations, houdayer+cmr SW moves every sweep, SW every 2 sweeps with
  statistics, full-ladder PT), Joerg and Houdayer(4) at that shape and a
  16^3 glass with 9 offsets, each twice from one seed (launch counts: the
  table forms of ``pair_overlap`` and the five move kernels, no walk-form
  move or mega-path kernel; the histograms' sums; P(q) at the hottest
  temperature), each table form against its plain version on those runs'
  states and on 5D, odd-extent and 9-offset states (Wolff and SW, update
  and observe), a 4^4 glass on the card bitwise the CPU's, and each
  form's time a launch beside its bound.

Every profiled window reads the device through one helper,
``device_time``, which counts each kernel once by name and leaves out the
CPU events and the ``peapods/`` profiling scopes; its busy share is the
window's device time over the unprofiled wall time a sweep, printed beside
``busy_window``, the same time over the profiled window's own wall time.

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
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

L = 256
N_TEMPS = 24
FLAGSHIP_SWEEPS = 4096
# the flagship's state_checksum (bench.py:120-128), the same on either route of
# the mega path
FLAGSHIP_CHECKSUM = "cf44dd66b98cb934"
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


# the profiling scopes of utils/profiling.py phase_scope ("peapods/sweep",
# "peapods/measure"): their device-side annotations span the kernels inside
# them, so a window that counted them would count those kernels twice
SCOPE_PREFIX = "peapods/"


def device_time(events, names=()):
    """Device time by name of a profiled window's events
    (``prof.key_averages()``): ``(named, others)``, ``named[k] = [device
    us, launches]`` of each kernel of ``names`` (its ``<k>_kernel``
    instantiations added together), ``others[key]`` the device us of every
    other kernel or copy.  Every CPU event (a torch op's record, whose
    device time is its kernels') and every ``peapods/`` profiling scope is
    left out: what remains is each device activity once.  Every profiled
    window of this script reads the device through this function."""
    from torch.autograd import DeviceType

    named, others = {}, {}
    for ev in events:
        if (ev.self_device_time_total <= 0 or ev.device_type == DeviceType.CPU
                or ev.key.startswith(SCOPE_PREFIX)):
            continue
        hit = [k for k in names if f"{k}_kernel" in ev.key]
        if hit:
            add_kernel_time(named, hit[0], ev)
        else:
            others[ev.key] = others.get(ev.key, 0.0) + ev.self_device_time_total
    return named, others


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities),
    ending in a synchronize: ``(prof, wall seconds of the window)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def busy_words(per_sweep, window_us, sweeps_s):
    """A window's busy share: its device us a sweep over the unprofiled
    wall us a sweep (``1 / sweeps_s``, the phase's rate), whose complement
    is the run's idle share; beside it ``busy_window``, over the
    profiled window's own wall us a sweep, which the profiler stretches
    where the host holds the rate.  Returns ``(busy, words)``."""
    busy = per_sweep * sweeps_s / 1e6
    return busy, (f"sum {per_sweep:.3f} against {1e6 / sweeps_s:.3f} us of unprofiled wall "
                  f"time per sweep: the device is busy {busy:.3f} of it (busy_window "
                  f"{per_sweep / window_us:.3f} of the profiled window's {window_us:.3f} us "
                  f"a sweep)")


def kernel_times(prof, names, n, ran):
    """Split a profiled window of ``n`` sweeps: each kernel of ``names``'s
    device time a launch, its launches and device time a sweep, the launches
    the profiler missed, and the other device work, us a sweep by key.
    Launches a sweep come from the wrappers' counts over the window
    (``ran``): the profiler can miss the first sweep's launches of a long
    window (the unsharded 4096^2 run's sweep_2d, fk_bonds and labelling: 3
    sweeps of 4), so a sweep's device time is each launch's time times the
    launches made."""
    acc, others = device_time(prof.key_averages(), names)
    rest = {k: v / n for k, v in others.items()}
    per_launch = {k: t / c for k, (t, c) in acc.items()}
    counts = {k: (ran.get(k) or c) / n for k, (t, c) in acc.items()}
    per_sweep = {k: per_launch[k] * counts[k] for k in acc}
    missed = {k: f"{c} of {ran[k]}" for k, (t, c) in acc.items() if ran.get(k, c) != c}
    return per_launch, counts, per_sweep, missed, rest


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
    plan = mega.resident_route(dev, L, L, 1, N_TEMPS)
    if plan is None:
        raise AssertionError("the resident kernel's rule refuses the flagship")
    log("4 flagship", f"route: mega_resident, a cluster of {plan.cluster} CTAs a "
        f"system, {plan.rows} rows and {plan.threads} threads a CTA, {plan.smem} B of "
        f"shared memory; {N_TEMPS} clusters, a chunk of {sim.default_chunk} sweeps a "
        "launch")
    mega.reset_launches()
    result = sim.sample(FLAGSHIP_SWEEPS, "metropolis", **kw)
    launches = dict(mega.LAUNCHES)
    check_a = state_checksum(sim, result)
    want = {"colour_pass": 0, "pt_step": 0,
            "mega_resident": -(-FLAGSHIP_SWEEPS // sim.default_chunk)}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if check_a != FLAGSHIP_CHECKSUM:
        raise AssertionError(f"flagship checksum {check_a}, expected {FLAGSHIP_CHECKSUM} "
                             "(the three launches' a sweep)")

    sim_b = IsingSimulation([L, L], coup, temps, 1, None, SEED, device=dev)
    result_b = sim_b.sample(FLAGSHIP_SWEEPS, "metropolis", **kw)
    check_b = state_checksum(sim_b, result_b)
    if check_a != check_b:
        raise AssertionError(f"checksums differ: {check_a} {check_b}")
    rates = warm_rates(sim_b)  # steady state: further calls on the warm simulation

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


class three_launches:
    """Drive the mega path through its three launches a sweep
    (``mega_chunk_launches``) where the resident kernel's rule would take
    the chunk."""

    def __enter__(self):
        from peapods_tpu_torch.ops import mega

        self.saved = mega.resident_route
        mega.resident_route = lambda *args: None

    def __exit__(self, *exc):
        from peapods_tpu_torch.ops import mega

        mega.resident_route = self.saved


MEGA_KERNELS = ("mega_resident", "colour_pass", "pt_step")


def kernel_share(sim, sweeps_s, n=512):
    """Device time per sweep of each mega-path kernel (and of any other
    device work) over a profiled window of ``n`` flagship sweeps, and the
    share of the unprofiled wall time per sweep (``1 / sweeps_s``) that the
    device is busy (:func:`busy_words`).  Returns ``(us by kernel, busy share, line)``."""
    prof, wall = profiled(lambda: sim.sample(n, "metropolis", pt_interval=1,
                                             warmup_ratio=0.0))
    named, others = device_time(prof.key_averages(), MEGA_KERNELS)
    us = {k: t / n for k, (t, _) in named.items()}
    if others:
        us["other device work"] = sum(others.values()) / n
    if not any(k in us for k in MEGA_KERNELS):
        raise AssertionError("the profiler saw no mega-path kernel")
    busy, words = busy_words(sum(us.values()), wall * 1e6 / n, sweeps_s)
    return us, busy, ("device us per sweep: " + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
                      + f", {words}")


def warm_rates(sim, calls=3, **kw):
    """Sweeps/s of ``calls`` further flagship sample() calls (host clock),
    with the sample() options ``kw``."""
    rates = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.sample(FLAGSHIP_SWEEPS, "metropolis", pt_interval=1, warmup_ratio=0.0, **kw)
        torch.cuda.synchronize()
        rates.append(FLAGSHIP_SWEEPS / (time.perf_counter() - t0))
    return rates


def mega_routes(sim, resident_rates, card):
    """Phase 5: the flagship on both routes of the mega path in one run:
    sweeps/s (median of three warm 4096-sweep calls; the resident route's
    from phase 4) and device time a sweep by kernel (profiled 512-sweep
    windows in the order resident, three launches, three launches,
    resident)."""
    out = {"resident": dict(rates=list(resident_rates), profiles=[]),
           "launches": dict(rates=[], profiles=[])}
    with three_launches():
        out["launches"]["rates"] = warm_rates(sim)
    for route in ("resident", "launches", "launches", "resident"):
        rate = float(np.median(out[route]["rates"]))
        if route == "launches":
            with three_launches():
                out[route]["profiles"].append(kernel_share(sim, rate))
        else:
            out[route]["profiles"].append(kernel_share(sim, rate))
    for route, label in (("resident", "one mega_resident launch a chunk"),
                         ("launches", "three launches a sweep")):
        r = out[route]
        r["sweeps_s"] = float(np.median(r["rates"]))
        r["device_us"] = [sum(us.values()) for us, _, _ in r["profiles"]]
        r["busy"] = [b for _, b, _ in r["profiles"]]
        log("5 times", f"{label}: {r['sweeps_s']:.1f} sweeps/s (median of "
            f"{', '.join(f'{x:.1f}' for x in r['rates'])}); "
            + "; ".join(line for _, _, line in r["profiles"]) + f" on {card}")
    return out


# operations a colour-site update counts (csrc/mega_resident.cu, the
# function of mega.cuh update_sites): a quarter of a Philox4x32-10 block (10
# rounds of two 32-bit multiplies, each for its high and low word, four xors
# and two key additions: 100 integer operations for 4 sites), the 24-bit
# uniform (shift, conversion, scale: 3), the field (4 products, 3 sums), x
# (negation, product: 2), the acceptance (min, exp, scale: 3, the exp
# counted as one operation), the test and the flip (2); the measuring pass
# adds s h to e and s to m (4).  Integer operations count at the f32 rate.
SITE_OPS = 25 + 3 + 7 + 2 + 3 + 2
MEASURE_OPS = 4


def resident_bound(n_sweeps, d, n_slots, n_spins):
    """``bound()`` of one ``mega_resident`` launch of ``n_sweeps`` sweeps:
    bytes (the spins read and written once, the four f32 coupling grids
    read once, the (e, m) rows written) against the site updates'
    operations (SITE_OPS a site and colour, MEASURE_OPS a measured site)."""
    sites = d * n_slots * n_spins
    n_bytes = 2 * sites + 16 * d * n_spins + 8 * d * n_sweeps * n_slots
    ops = n_sweeps * (sites * SITE_OPS + sites // 2 * MEASURE_OPS)
    return bound(n_bytes, ops)


def chunk_tie(sim, state, sw, pw, kw):
    """After a resident chunk parted from the plain chunk: step both one
    sweep at a time from the plain chunk's state to the first sweep where
    they part, and hold that sweep's colour passes (``colour_pass`` against
    ``colour_pass_plain``, each on the same input) to ulp ties.  Raises if
    a site differs away from a tie; returns ``(sweep, ties)``."""
    from peapods_tpu_torch.ops import mega

    rt = sim.rt
    s = {k: v.clone() for k, v in state.items()}
    for t in range(sw.shape[0]):
        a, b = ({k: v.clone() for k, v in s.items()} for _ in range(2))
        step = dict(kw, sweep_base=t)
        for fn, x in ((mega.mega_chunk_resident, a), (mega.mega_chunk_plain, b)):
            x["e"], x["m"], x["parity"] = fn(
                x["spins"], rt.jgrids, rt.temps, x["sid"], x["ea"], x["ec"], x["rtrips"],
                x["tstate"], sw[t:t + 1], pw[t:t + 1], **step)
        torch.cuda.synchronize()
        if all(torch.equal(a[k], b[k]) for k in state):
            s = {k: b[k] for k in state}
            kw = dict(kw, parity=b["parity"])
            continue
        x = dict(rt=rt, sid=s["sid"], grid=s["spins"].clone())
        ties = 0
        for colour in (0, 1):
            tie = colour_ties(x, sw[t], colour, kw["gibbs"])
            ka, pb = x["grid"].clone(), x["grid"].clone()
            mega.colour_pass(ka, rt.jgrids, s["sid"], rt.slot_temps, sw[t], colour,
                             gibbs=kw["gibbs"])
            mega.colour_pass_plain(pb, rt.jgrids, s["sid"], rt.slot_temps, sw[t], colour,
                                   gibbs=kw["gibbs"])
            torch.cuda.synchronize()
            di = torch.arange(s["sid"].shape[0], device=pb.device)[:, None]
            diff = ka[di, s["sid"].long()] != pb[di, s["sid"].long()]
            if (diff & ~tie).any():
                raise AssertionError(f"sweep {t} colour {colour}: "
                                     f"{int((diff & ~tie).sum())} spins differ away "
                                     "from ulp ties")
            ties += int((diff & tie).sum())
            x["grid"] = pb
        if ties == 0:
            raise AssertionError(f"the chunks part at sweep {t} without an ulp tie")
        return t, ties
    raise AssertionError("the chunks part, but no single sweep does")


def check_resident_chunk(sim, card, reps=5):
    """Phase 4b: one chunk of the flagship (its state after phase 4, the
    words of its first chunk) through ``mega_chunk_resident``,
    ``mega_chunk_launches`` and ``mega_chunk_plain`` from the same state:
    spins, e, m, sid, the PT counters, the trip state and the parity bitwise
    (against the plain chunk up to a counted ulp tie, past which they are
    not compared); then the device time of a chunk on each kernel route
    (CUDA events, in the order resident, launches, launches, resident) and
    the plain chunk's time.  Returns the mega_resident record."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import mega

    rt, st = sim.rt, sim.state
    d, n = rt.n_disorder, sim.default_chunk
    sw, pw = (torch.from_numpy(seeds.sweep_words(st["base_keys"], 0, n, ph)).to(rt.device)
              for ph in (seeds.PH_SWEEP, seeds.PH_PT))
    state = dict(spins=st["spins"].view(d, N_TEMPS, L, L), sid=st["system_ids"].view(d, N_TEMPS),
                 ea=st["pt_edge_attempts"], ec=st["pt_edge_acceptances"],
                 rtrips=st["pt_round_trips"], tstate=st["pt_trip_state"])
    kw = dict(sweep_base=0, parity=0, gibbs=False, pt_interval=1, pt_full=False,
              hot_slot=rt.hot_slot, cold_slot=rt.cold_slot)
    fns = {"resident": mega.mega_chunk_resident, "launches": mega.mega_chunk_launches,
           "plain": mega.mega_chunk_plain}

    def run(route, x):
        return fns[route](x["spins"], rt.jgrids, rt.temps, x["sid"], x["ea"], x["ec"],
                          x["rtrips"], x["tstate"], sw, pw, **kw)

    runs, wall = {}, {}
    for route in fns:
        x = {k: v.clone() for k, v in state.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x["e"], x["m"], x["parity"] = run(route, x)
        torch.cuda.synchronize()
        wall[route] = (time.perf_counter() - t0) * 1e3
        runs[route] = x
    keys = ("spins", "sid", "ea", "ec", "rtrips", "tstate", "e", "m", "parity")

    def differ(a, b):
        return [k for k in keys if not (a[k] == b[k] if k == "parity" else torch.equal(a[k], b[k]))]

    res = runs["resident"]
    bad = differ(res, runs["launches"])
    if bad:
        raise AssertionError(f"the resident chunk differs from the three launches' in {bad}")
    bad = differ(res, runs["plain"])
    tie_at, ties = None, 0
    if bad:
        tie_at, ties = chunk_tie(sim, state, sw, pw, kw)
        log("4b chunk", f"the plain chunk parts from the kernels' at sweep {tie_at} on "
            f"{ties} ulp ties (in {bad}); not compared past it")
        if ties > MAX_TIE_SHARE * 2 * N_TEMPS * L * L // 2:
            raise AssertionError(f"{ties} ulp ties in one sweep")
    upto = n if tie_at is None else tie_at  # the e rows compared
    err = float((res["e"] - runs["plain"]["e"])[:, :upto].abs().max()) if upto else 0.0
    chunk = {"resident": [], "launches": []}
    for route in ("resident", "launches", "launches", "resident"):
        x = {k: v.clone() for k, v in state.items()}
        chunk[route].append(gpu_ms(lambda: run(route, x), reps))
    ms = float(np.mean(chunk["resident"]))
    bms, by = resident_bound(n, d, N_TEMPS, L * L)
    log("4b chunk", f"a {n}-sweep chunk of the flagship's state: mega_resident bitwise the "
        f"three launches' (spins, e, m, sid, PT counters, trip state, parity) and "
        + ("the plain chunk's" if tie_at is None else f"the plain chunk's to sweep {tie_at}")
        + f", {ties} ulp ties, {int(res['ec'].sum() - state['ec'].sum())} swaps accepted; "
        f"device ms a chunk: mega_resident {', '.join(f'{v:.4f}' for v in chunk['resident'])}, "
        f"three launches {', '.join(f'{v:.4f}' for v in chunk['launches'])}; plain "
        f"{wall['plain']:.1f} ms; bound {bms:.5f} ms ({by}) on {card}")
    return dict(max_abs_err=err, ties=ties, ms=ms, ms_per_sweep=ms / n,
                plain_ms=wall["plain"], plain_ms_per_sweep=wall["plain"] / n,
                bound_ms=bms, bound_ms_per_sweep=bms / n, bound_by=by, library_ms=None,
                sweeps_per_launch=n, three_launch_ms=float(np.mean(chunk["launches"])),
                chunk_ms=chunk)


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


def sweep_2d_bound(n, n_real):
    """A ``sweep_2d`` pass's bound on ``n`` sites of ``n_real`` sites' worth
    of realizations: every spin read, the active colour's four couplings a
    site (half the sites), the active spins written; 20 operations an
    active site."""
    return bound(n + 8 * n_real + n // 2, 10 * n)


def check_sweep_2d(dev, rng, card):
    """The sweep kernel against its plain versions at 256^2 over 8 systems
    and at the harness shape, +-1 couplings, and at the harness shape with
    gaussian couplings: spins bitwise ``sweep_2d_plain``'s, every partial
    bitwise ``sweep_2d_partials``' (the kernel's order of adds) and, with
    +-1 couplings, their sums bitwise ``sweep_2d_plain``'s; then its time a
    launch (CUDA events), its plain version's and its bound at config 3 and
    at the harness shape."""
    from peapods_tpu_torch.ops import sweep
    from peapods_tpu_torch.ops.sweep import pack_coupling_grids

    def inputs(shape, d, n_sys, couplings="pm"):
        h, w = shape
        coup = (rng.choice([-1.0, 1.0], size=(d, h * w, 2)) if couplings == "pm"
                else rng.standard_normal((d, h * w, 2))).astype(np.float32)
        temps = np.stack([rng.permutation(np.geomspace(1.8, 3.2, n_sys))
                          for _ in range(d)]).astype(np.float32)
        coup_t = torch.from_numpy(coup).to(dev)
        return dict(
            spins=torch.from_numpy(
                rng.choice([-1, 1], size=(d, n_sys, h, w)).astype(np.int8)).to(dev),
            coup=coup_t, jgrids=pack_coupling_grids(coup_t, shape).contiguous(),
            sys_temps=torch.from_numpy(temps).to(dev),
            words=torch.from_numpy(
                rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)).to(dev))

    max_err = 0.0
    harness = (HARNESS["shape"], HARNESS["n_disorder"], HARNESS["n_temps"])
    for (shape, d, n_sys), couplings in ((((L, L), 1, 8), "pm"), (harness, "pm"),
                                         (harness, "gauss")):
        x = inputs(shape, d, n_sys, couplings)
        a, b, c = (x["spins"].clone() for _ in range(3))
        args = (x["sys_temps"], x["words"])
        for gibbs in (False, True):
            pk = sweep.sweep_2d(a, x["coup"], *args, gibbs=gibbs, measure=True)
            pp = sweep.sweep_2d_plain(b, x["jgrids"], *args, gibbs=gibbs, measure=True)
            pe, pm = sweep.sweep_2d_partials(c, x["jgrids"], *args, gibbs=gibbs)
            torch.cuda.synchronize()
            n_diff = int((a != b).sum()) + int((a != c).sum())
            n_part = int((pk[0] != pe).sum()) + int((pk[1] != pm).sum())
            e_err = float((pk[0].double().sum(-1) - pp[0][..., 0].double()).abs().max())
            m_diff = int((pk[1].sum(-1) != pp[1][..., 0]).sum())
            if n_diff or n_part or m_diff or (couplings == "pm" and e_err):
                raise AssertionError(f"sweep_2d ({couplings}, gibbs={gibbs}): {n_diff} spins, "
                                     f"{n_part} partials, {m_diff} m sums differ, max |de| "
                                     f"{e_err}")
            max_err = max(max_err, float((pk[0] - pe).abs().max()))
        log("8 kernel-vs-plain", f"sweep_2d ok: {shape[0]}x{shape[1]} x "
            f"{d * n_sys} systems, {couplings}, Metropolis and Gibbs: 0 of {2 * a.numel()} "
            f"spins differ, all {2 * pk[0].numel()} (e, m) partials bitwise "
            f"sweep_2d_partials'" + (", their sums bitwise sweep_2d_plain's"
                                     if couplings == "pm" else
                                     f" (sums within {e_err:.3g} of torch.sum's)"))

    times = {}
    for name, shape, d, n_sys in (("config3", (L, L), 1, 1),
                                  ("harness", *harness)):
        y = inputs(shape, d, n_sys)
        yargs = (y["sys_temps"], y["words"])
        ms = gpu_ms(lambda: sweep.sweep_2d(y["spins"], y["coup"], *yargs, gibbs=False),
                    100) / 2
        plain = wall_ms(lambda: sweep.sweep_2d_plain(
            y["spins"], y["jgrids"], *yargs, gibbs=False), 10) / 2
        bms, by = sweep_2d_bound(d * n_sys * shape[0] * shape[1], d * shape[0] * shape[1])
        times[name] = dict(ms_events=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        log("8 kernel-vs-plain", f"sweep_2d at {name} ({shape[0]}x{shape[1]} x "
            f"{d * n_sys} systems): {ms:.5f} ms a pass (CUDA events; bound {bms:.5f} ms by "
            f"{by}, plain {plain:.4f} ms) on {card}")
    return dict(max_abs_err=max_err, library_ms=None, shapes=times)


def check_sweep_state(sim, dev, rng, name, phase):
    """``sweep_2d`` (both passes, measuring) on a simulation's state,
    Metropolis and Gibbs: the spins bitwise ``sweep_2d_plain``'s, every
    partial bitwise ``sweep_2d_partials``' and the (e, m) sums bitwise
    ``sweep_2d_plain``'s.  With +-1 couplings every energy term is an even
    integer and every sum stays within 2^25, so float32 adds them exactly in
    any order: the tolerance is 0.  Returns the max |de| and the plain
    version's time a pass (Metropolis)."""
    from peapods_tpu_torch.ops import sweep
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems

    rt, st = sim.rt, sim.state
    d, n_sys = rt.n_disorder, rt.n_systems
    spins = st["spins"].view(d, n_sys, *rt.lattice.shape)
    temps = slot_temps_for_systems(st["system_ids"].view(d, -1), rt.temps)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)).to(dev)
    max_err = 0.0
    for gibbs in (False, True):
        a, b = spins.clone(), spins.clone()
        pk = sweep.sweep_2d(a, rt.coup, temps, words, gibbs=gibbs, measure=True)
        pp = sweep.sweep_2d_plain(b, rt.jgrids, temps, words, gibbs=gibbs, measure=True)
        torch.cuda.synchronize()
        n_diff = int((a != b).sum())
        e_err = float((pk[0].sum(-1) - pp[0][..., 0]).abs().max())
        m_diff = int((pk[1].sum(-1) != pp[1][..., 0]).sum())
        del b, pp
        c = spins.clone()
        pe, pm = sweep.sweep_2d_partials(c, rt.jgrids, temps, words, gibbs=gibbs)
        torch.cuda.synchronize()
        n_part = int((pk[0] != pe).sum()) + int((pk[1] != pm).sum())
        n_diff += int((a != c).sum())
        log(phase, f"sweep_2d alone on {name} ({d * n_sys} systems, "
            f"{'Gibbs' if gibbs else 'Metropolis'}): {n_diff} of {a.numel()} spins "
            f"differ, {n_part} of {2 * pe.numel()} partials differ from sweep_2d_partials', "
            f"{m_diff} m sums differ, max |de| {e_err}; "
            f"{int((a != spins).sum())} spins flipped")
        if n_diff or e_err or m_diff or n_part:
            raise AssertionError(f"sweep_2d on {name} (gibbs={gibbs}) differs from plain")
        max_err = max(max_err, e_err)
        del a, c, pk, pe, pm
    b = spins.clone()
    plain = wall_ms(lambda: sweep.sweep_2d_plain(b, rt.jgrids, temps, words, gibbs=False),
                    2) / 2
    return max_err, plain


def fk_inputs(model, dev, rng, wolff):
    """The FK kernels' inputs on a model's (or a simulation's) current state:
    its spins as a flat graph batch, couplings, the systems' temperatures,
    and fresh scalars and bond key words."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems

    sim = getattr(model, "_sim", model)
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
            "fk_bonds": check_bonds(model, dev, rng, name, phase),
            "fk_finish": wall_ms(lambda: fk.fk_finish_plain(
                sp.clone(), lab, x["j_fwd"], x["scalars"], wolff=False,
                with_measure=True), 3),
        }
        cb = 4 * n_dirs * d * n  # the realizations' couplings
        t = {
            "fk_bonds": bonds_bound(b, n, n_dirs, d),
            # spins, state, parents, couplings, scalars in; spins, partials out
            "fk_finish": bound(6 * b * n + cb + 12 * b + b * n
                               + 8 * b * ((n + 255) // 256), 2 * n_dirs * b * n),
        }
        for k, v in t.items():
            times.setdefault(k, {})[name] = dict(bound_ms=v[0], bound_by=v[1],
                                                 plain_ms=plain[k])
        for k, v in link_stages(x, dev, name, phase).items():
            times.setdefault(k, {})[name] = v
        check_finish(model, dev, rng, name, phase)
    return {k: dict(max_abs_err=max_err, library_ms=None, shapes=v)
            for k, v in times.items()}


def bonds_bound(b, n, n_dirs, d):
    """``fk_bonds``' bound on ``b`` graphs of ``n`` sites over ``d``
    realizations: the spins, the realizations' couplings (each read once),
    the temperatures and key words in, the state bytes out; 8 operations a
    bond."""
    return bound(b * n + 4 * n_dirs * d * n + 12 * b + b * n, 8 * n_dirs * b * n)


def check_bonds(model, dev, rng, name, phase):
    """``fk_bonds`` alone on a model's state (or a simulation's): every
    state byte (bond bits and "s differs" bits) bitwise ``fk_state_plain``'s.
    Returns the plain version's time."""
    from peapods_tpu_torch.ops import fk

    x = fk_inputs(model, dev, rng, False)
    args = (x["spins"], x["j_fwd"], x["temps"], x["kb_words"])
    got = fk.fk_bonds(*args)
    want = fk.fk_state_plain(*args)
    torch.cuda.synchronize()
    (b, n), (d, _, n_dirs) = got.shape, x["j_fwd"].shape
    bad = int((got != want).sum())
    bonded = int((got & ((1 << n_dirs) - 1)).ne(0).sum())
    per = fk.bonds_per(n, b, b // d, fk.resident_threads(dev.index))
    log(phase, f"fk_bonds alone on {name} ({b} graph(s) of {n} sites, {n_dirs} bond "
        f"directions, {per} a thread): {bad} state bytes differ; "
        f"{bonded} sites with a bond")
    if bad:
        raise AssertionError(f"fk_bonds on {name} differs from fk_state_plain: {bad} bytes")
    return wall_ms(lambda: fk.fk_state_plain(*args), 2)


def check_finish(model, dev, rng, name, phase):
    """``fk_finish`` alone on the labelling's parents of a model's state (or
    a simulation's), SW and Wolff: the spins and every partial block's (e,
    m) bitwise ``fk_finish_plain``'s (the same terms in the same pairing).
    Returns the plain version's time (SW, measuring)."""
    from peapods_tpu_torch.ops import fk

    plain_ms = None
    for wolff in (False, True):
        x = fk_inputs(model, dev, rng, wolff)
        b, n = x["spins"].shape[0], x["spins"][0].numel()
        state, parent = fk._bonds_and_link(x["spins"], x["j_fwd"], x["temps"],
                                           x["kb_words"])
        args = (parent, x["j_fwd"], x["scalars"])
        a, p = x["spins"].clone(), x["spins"].clone()
        ek, mk = fk.fk_finish(a, state, *args, wolff=wolff, with_measure=True)
        ep, mp = fk.fk_finish_plain(p, *args, wolff=wolff, with_measure=True, blocks=True)
        torch.cuda.synchronize()
        bad = {"spins": int((a != p).sum()), "e partials": int((ek != ep).sum()),
               "m partials": int((mk != mp).sum())}
        log(phase, f"fk_finish alone {'wolff' if wolff else 'sw'} on {name} ({b} graph(s) "
            f"of {n} sites, {ek.shape[1]} partial blocks each): mismatches {bad}; "
            f"{int((a != x['spins']).sum())} spins flipped")
        if any(bad.values()):
            raise AssertionError(f"fk_finish on {name} differs from plain: {bad}")
        if not wolff:
            plain_ms = wall_ms(lambda: fk.fk_finish_plain(
                x["spins"].clone(), *args, wolff=False, with_measure=True, blocks=True), 2)
    return plain_ms


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
    fk.launch_bonds(lib, stream, x["spins"], x["j_fwd"], x["temps"], x["kb_words"], state)
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
    the unprofiled wall time per sweep that the device is busy
    (:func:`busy_words`)."""
    before = space_counts()
    prof, wall = profiled(lambda: model.sample(n, "metropolis", **dict(kw, warmup_ratio=0.0)))
    ran = {k: v - before.get(k, 0) for k, v in space_counts().items()}
    per_launch, _, per_sweep, missed, others = kernel_times(prof, names, n, ran)
    missing = [k for k in names if k not in per_launch]
    if missing:
        raise AssertionError(f"the profiler saw no device time for {missing}")
    other = sum(others.values())
    _, words = busy_words(sum(per_sweep.values()) + other, wall * 1e6 / n, sweeps_s)
    top = sorted(others.items(), key=lambda kv: -kv[1])[:3]
    line = ("device us per sweep: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_sweep.items())
        + f", other device work {other:.3f} (most: " + "; ".join(
            f"{k[:60]} {v:.3f}" for k, v in top)
        + f"), {words}; the profiler saw "
        + (f"{missed} launches" if missed else "every launch"))
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


def houdn_bounds(b, n, g, d, s, *, wolff, flipped):
    """``{kernel: (bound_ms, bound_by)}`` of ``houdn_bonds`` and
    ``houdn_finish`` on ``b`` tasks of ``g`` members of ``n`` sites in one
    form: the bytes that form must move.  Both read the tasks and sid;
    ``houdn_bonds`` the group's spins, and in the Wolff form the 64 probes
    of a task and writes its seed; it writes a state byte a site (the first
    design's bound also counted a parent written a site, 5 b n bytes in
    all: fk_link writes every parent).  ``houdn_finish`` reads the flat
    parents, the state bytes and two salts a task (SW) or the seed (Wolff),
    and reads and writes the ``flipped`` spins that this run's data flips;
    it writes no label (the first design's bound counted the labels it
    copied, 4 b n bytes more: fk_link labels into the caller's buffer).
    The observe form launches no finish."""
    index = 4 * g * b + 4 * d * s
    bonds = g * b * n + index + b * n + (256 * b + 4 * b if wolff else 0)
    finish = 4 * b * n + index + 2 * flipped + (4 * b if wolff else b * n + 8 * b)
    return {"houdn_bonds": bound(bonds, 0), "houdn_finish": bound(finish, 0)}


def ov_finish_bound(b, n, kind, wolff, flipped):
    """``(bound_ms, bound_by)`` of ``ov_finish`` on ``b`` tasks of ``n``
    sites: the bytes that form must move.  It reads the flat parents, the
    state bytes (CMR's blue flip is bit 7 of state2, SW's non-singletons
    their bonds; a Joerg Wolff flip needs only the parents), two salts a
    task (SW), CMR's k and the seed (Wolff), and reads and writes the
    ``flipped`` spins that this run's data flips (the first design's bound
    read and wrote both systems' spins at every site: 9 b n bytes)."""
    nbytes = (4 * b * n + (0 if kind == "jorg" and wolff else b * n) + 2 * flipped
              + (4 * b if wolff else 8 * b) + (4 * b if kind == "cmr" else 0))
    return bound(nbytes, 4 * b * n)


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
    labels bitwise; Houdayer keeps E_a + E_b of every task; Joerg's and
    CMR's state bytes, state2 bytes and seeds bitwise the plain bonds) and
    energy_partials.  Then the plain versions' times and the bounds."""
    from peapods_tpu_torch.engine import seeds
    from peapods_tpu_torch.ops import mega, megapair, overlap
    from peapods_tpu_torch.ops._build import dims3 as _dims3
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
        ties, err, worst, parts_checked = 0, 0.0, 0.0, 0
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
            if pk is not None and not (diff & tie).any():
                # every partial in the first design's order of adds
                c = x["grid"].clone()
                pe, pm = mega.colour_pass_partials(c, rt.jgrids, x["sid"], rt.slot_temps,
                                                   words, gibbs=False)
                if not (torch.equal(pk[0], pe) and torch.equal(pk[1], pm)):
                    raise AssertionError(
                        f"{name} colour_pass: {int((pk[0] != pe).sum())} e and "
                        f"{int((pk[1] != pm).sum())} m partials differ from "
                        "colour_pass_partials")
                parts_checked += pe.numel()
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
        plan = mega._colour_plan(dev, (d, s, *_dims3(shape)))
        log("13 kernel-vs-plain", f"{name} colour_pass ok ({plan.per} slots a CTA, "
            f"{plan.gp} x {plan.sub} threads): {d * s * n} sites, 0 "
            f"differ but {ties} ulp ties; {parts_checked} partials bitwise "
            f"colour_pass_partials (the first design's order of adds); max |e_kernel - "
            f"e_plain| per spin {err}, {worst:.4f} of the limit {E_SUM_TOL} sum|J| per "
            "system (+-J: exact)")
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
                if kind != "houdayer":
                    msg += "; " + check_bond_states(x, rt, tab, kind, wolff, dev)
                msg += "; " + move_alone(x["spins"], x["sid"], tab, rt.coup, rt.temps, shape,
                                         kind, wolff, dev)
                log("13 kernel-vs-plain", msg + " ok")
                moved[(kind, wolff)] = tab
        # energy_partials
        ek, mk = overlap.energy_partials(x["spins"], rt.coup, shape)
        ep, mp = overlap.energy_partials_plain(x["spins"], rt.coup, shape)
        bp = overlap.energy_partials_plain(x["spins"], rt.coup, shape, blocks=True)
        torch.cuda.synchronize()
        if not (torch.equal(ek.view(torch.int32), bp[0].view(torch.int32))
                and torch.equal(mk, bp[1])):
            raise AssertionError(f"{name} energy_partials: partials not bitwise the block "
                                 "plain version")
        de = (ek.double().sum(-1) - ep.double().sum(-1)).abs()
        e_err = float(de.max())
        worst = float((de / e_lim).max())
        if (not torch.equal(mk.sum(-1), mp.sum(-1)) or (name == "config4" and e_err)
                or worst > 1.0):
            raise AssertionError(f"{name} energy_partials differ ({e_err}, {worst} of "
                                 "the limit)")
        rec["energy_partials"] = dict(max_abs_err=e_err)
        log("13 kernel-vs-plain", f"{name} energy_partials ok: each of {ek.numel()} "
            "partials bitwise energy_partials_plain(blocks=True); m exact, max |e_kernel - "
            f"e_plain| {e_err}, {worst:.4f} of the limit {E_SUM_TOL} sum|J| per system "
            "(+-J: exact; gaussian: f32 sums in another order)")
        for k in move_kernels(run["kw"]["overlap_cluster_build_mode"]):
            rec[k] = dict(max_abs_err=0.0)
        rec["_tables"] = moved
        out[name] = rec
    return out


def check_bond_states(x, rt, tab, kind, wolff, dev):
    """ov_bonds' state bytes and seeds and (CMR) ov_mid's state2 bytes and
    blue labels, launched through ``launch_event`` on a ``Scratch``,
    bitwise the plain bonds (``overlap.bond_states_plain``) and the plain
    blue labelling; returns the log's words."""
    from peapods_tpu_torch.ops import _build, fk, overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    shape = rt.lattice.shape
    n = rt.n_spins
    sp = x["spins"].clone()
    args = (x["sid"], tab[0], rt.coup, rt.temps, *tab[1:])
    st, st2, sd = overlap.bond_states_plain(sp.clone(), *args, kind=kind, wolff=wolff,
                                            shape=shape)
    dims, _ = overlap.check_event(sp, *args, shape, kind)
    scratch = overlap.Scratch(dims[0], n, dev, kind == "cmr")
    blue = torch.full((dims[0], n), -1, dtype=torch.int32, device=dev)
    overlap.launch_event(_build.library(), torch.cuda.current_stream(dev).cuda_stream, dims,
                         sp.data_ptr(), *(t.data_ptr() for t in args), scratch.ptrs(),
                         kind=kind, wolff=wolff,
                         p_blue=blue.data_ptr() if kind == "cmr" else None)
    torch.cuda.synchronize()
    bad = {"state": int((scratch.state != st).sum()), "seeds": int((scratch.seeds != sd).sum())}
    if kind == "cmr":
        bad["state2"] = int((scratch.state2 != st2).sum())
        want = connected_components(fk.state_masks(st, len(shape)), shape).to(torch.int32)
        bad["blue labels"] = int((blue != want).sum())
    if any(bad.values()):
        raise AssertionError(f"{kind} ({'wolff' if wolff else 'sw'}) bond states: "
                             f"mismatches {bad}")
    bonds = int(fk.state_masks(scratch.state, len(shape)).sum())
    return ("state bytes" + (", state2 bytes, blue labels" if kind == "cmr" else "")
            + f" and seeds bitwise the plain bonds ({bonds} bonds)")


def move_alone(spins, sid, tab, coup, temps, shape, kind, wolff, dev):
    """The move's first and last kernels launched alone on a state and a
    move's tables: Houdayer's ``houdn_bonds`` (state bytes and seeds
    bitwise ``overlap.houdn_states_plain``; ``fk_link`` labels its state
    bytes into a labels buffer, bitwise the plain parents) and
    ``houdn_finish``, Joerg's and CMR's ``ov_finish``, each on the plain
    version's last graph (state bytes, flat parents, seeds; CMR: state2 and
    the grey parents), every spin bitwise ``overlap.finish_plain``; returns
    the log's words."""
    from peapods_tpu_torch.ops import _build, fk, overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    d, s, n = spins.shape
    n_temps, n_groups, g = tab[0].shape[1:]
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    threads = fk.resident_threads(dev.index) // 4
    houd = kind == "houdayer"
    per = overlap.ov_per(n, d, n_temps, n_groups, threads,
                         max(1, overlap.HOUDN_ROWS // g) if houd else overlap.OV_MAX_PER)
    words = overlap.ov_words(tuple(shape), d, n_temps, n_groups, s, per)
    args = (sid, tab[0], coup, temps, *tab[1:])
    bad = {}
    if houd:
        st, sd = overlap.houdn_states_plain(spins, sid, tab[0], tab[2], wolff=wolff,
                                            shape=shape)
        state = torch.full_like(st, 0xAA)
        seeds = torch.full_like(sd, -1)
        _build.check(lib.peapods_houdn_bonds(
            spins.data_ptr(), sid.data_ptr(), tab[0].data_ptr(), tab[2].data_ptr(),
            state.data_ptr(), seeds.data_ptr(), words.ctypes.data, g, int(wolff), stream),
            "houdn_bonds")
        torch.cuda.synchronize()
        bad = {"houdn_bonds state": int((state != st).sum()),
               "houdn_bonds seeds": int((seeds != sd).sum())}
    else:
        st, st2, sd = overlap.bond_states_plain(spins.clone(), *args, kind=kind, wolff=wolff,
                                                shape=shape)
        st = st if kind == "jorg" else st2
    par = connected_components(fk.state_masks(st, len(shape)), shape).to(torch.int32)
    a, b = spins.clone(), spins.clone()
    overlap.finish_plain(b, sid, tab[0], tab[1], sd, st, par, kind=kind, wolff=wolff,
                         shape=shape)
    if houd:
        # the labelling between them: fk_link's labels in the caller's
        # buffer, which houdn_finish reads as its flat parents
        labels = torch.full_like(par, -1)
        fk.launch_link(lib, stream, state.data_ptr(), labels.data_ptr(), st.shape[0],
                       *_build.dims3(shape))
        _build.check(lib.peapods_houdn_finish(
            a.data_ptr(), sid.data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(), st.data_ptr(),
            par.data_ptr(), sd.data_ptr(), words.ctypes.data, g, int(wolff), stream),
            "houdn_finish")
        torch.cuda.synchronize()
        bad["fk_link labels"] = int((labels != par).sum())
    else:
        _build.check(lib.peapods_ov_finish(
            a.data_ptr(), sid.data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(), sd.data_ptr(),
            st.data_ptr(), par.data_ptr(), words.ctypes.data, overlap.KINDS.index(kind),
            int(wolff), stream), "ov_finish")
        torch.cuda.synchronize()
    fin = "houdn_finish" if houd else "ov_finish"
    bad[f"{fin} spins"] = int((a != b).sum())
    if any(bad.values()):
        raise AssertionError(f"{kind} ({'wolff' if wolff else 'sw'}) alone: mismatches {bad}")
    return ((f"houdn_bonds alone: state bytes and seeds bitwise houdn_states_plain "
             f"({int(fk.state_masks(st, len(shape)).sum())} bonds); " if houd else "")
            + f"{fin} alone: {int((a != spins).sum())} spins flipped bitwise "
            f"finish_plain ({per} tasks a thread)")


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
            # both replicas' spins and the couplings in, the state bytes out
            # (the first design's bound also counted a parent written a
            # site: none is needed, as fk_link writes every parent)
            "ov_bonds": (3 * b_tasks * n + cb, 12 * nd * b_tasks * n),
            "fk_link": (5 * b_tasks * n, 0),
            # both spins, the state bytes and the flat parents in, state2 out
            # (the first design's also counted parent2 written and the state
            # bytes read twice)
            "ov_mid": (8 * b_tasks * n + cb, 12 * nd * b_tasks * n),
            "energy_partials": (sys_bytes + cb + 8 * d * s * ((n + 255) // 256),
                                3 * nd * sys_bytes),
        }
        for k, (nbytes, flops) in bounds.items():
            if k in rec:
                rec[k]["bound_ms"], rec[k]["bound_by"] = bound(nbytes, flops)
        if "ov_finish" in rec:
            # the build's kinds take turns: the mean of their bounds, each
            # with the spins that the check's move flips on this state
            fin = []
            for kind in build.split("+"):
                if kind.startswith("houd"):
                    continue
                tab = rec["_tables"][(kind, True)]
                moved_sp = sp.clone()
                overlap.overlap_event_plain(moved_sp, x["sid"], tab[0], rt.coup, rt.temps,
                                            *tab[1:], kind=kind, wolff=True, shape=shape)
                fin.append(ov_finish_bound(b_tasks, n, kind, True,
                                           int((moved_sp != sp).sum())))
            rec["ov_finish"]["bound_ms"] = sum(ms for ms, _ in fin) / len(fin)
            rec["ov_finish"]["bound_by"] = fin[0][1]
        if "houdn_bonds" in rec:
            # pair Houdayer in the config's Wolff form, no labels: the spins
            # that the check's move flips on this state
            tab = rec["_tables"][("houdayer", True)]
            moved_sp = sp.clone()
            overlap.overlap_event_plain(moved_sp, x["sid"], tab[0], rt.coup, rt.temps,
                                        *tab[1:], kind="houdayer", wolff=True,
                                        shape=shape)
            for k, v in houdn_bounds(b_tasks, n, 2, d, s, wolff=True,
                                     flipped=int((moved_sp != sp).sum())).items():
                rec[k]["bound_ms"], rec[k]["bound_by"] = v
        rec.pop("_tables")


def pair_profile(run, n, card, name, phase="14 times"):
    """Device time per launch and per sweep of each replica-path kernel over
    a profiled window of ``n`` sweeps of the main path, and the busy share
    of the unprofiled wall time per sweep (:func:`busy_words`)."""
    model = run["model"]
    prof, wall = profiled(lambda: model.sample(n, "metropolis",
                                               **dict(run["kw"], warmup_ratio=0.0)))
    acc, others = device_time(prof.key_averages(), PAIR_KERNELS)
    other = sum(others.values()) / n
    per_launch = {k: t / c for k, (t, c) in acc.items()}
    per_sweep = {k: t / n for k, (t, c) in acc.items()}
    missing = [k for k in run["launches"] if k not in per_launch]
    if missing:
        raise AssertionError(f"the profiler saw no device time for {missing}")
    _, words = busy_words(sum(per_sweep.values()) + other, wall * 1e6 / n, run["sweeps_s"])
    log(phase, f"{name} device us per sweep: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_sweep.items())
        + f", other device work {other:.3f}, {words} (on {card})")
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
    staged path's ``fk_bonds_staged``, the labelling (``cc.link_launches``) and,
    to update, ``fk_finish`` (BCC, FCC, offset tables); ``measure_nb`` on
    every sweep the FK kernels did not measure; and one ``pt_step``."""
    from peapods_tpu_torch.ops import cc
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
        want.update(fk_bonds_staged=n_fk, fk_finish=n_fk if update else 0, measure_nb=n,
                    **{k: n_fk * v for k, v in cc.link_launches(
                        lat.shape, model._sim.rt.n_disorder * model._sim.rt.n_systems).items()})
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
                bp = energy.measure_nb_plain(s, x["coup"], lat, blocks=True)
                torch.cuda.synchronize()
                if not torch.equal(mk.sum(-1), mp.sum(-1)):
                    raise AssertionError(f"measure_nb on {name}: m differs")
                if not (torch.equal(ek.view(torch.int32), bp[0].view(torch.int32))
                        and torch.equal(mk, bp[1])):
                    raise AssertionError(f"measure_nb on {name} ({couplings}): partials "
                                         "not bitwise the block plain version")
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
            f"{rec_s['ulp_ties']} ulp ties; measure_nb ok: every partial bitwise "
            "measure_nb_plain(blocks=True) (+-1 and gaussian), m exact, e bitwise (+-1), max "
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
        log("17 kernel-vs-plain", f"sweep_nb at {name}: {rec_s['ms']:.5f} ms a pass (CUDA "
            f"events; bound {rec_s['bound_ms']:.7f} ms by {rec_s['bound_by']}, plain "
            f"{rec_s['plain_ms']:.4f} ms); measure_nb {rec_m['ms']:.5f} ms (bound "
            f"{rec_m['bound_ms']:.7f} ms) on {card_line()}")
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
    coup = torch.from_numpy(rng.choice([-1.0, 1.0], size=(1, h * w, 2)).astype(np.float32)
                            ).to(dev)
    jg = pack_coupling_grids(coup, (h, w)).contiguous()
    temps = torch.from_numpy(np.geomspace(1.8, 3.2, n_sys).astype(np.float32)[None]).to(dev)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (1, 2)).astype(np.int32)).to(dev)
    s0 = torch.from_numpy(rng.choice([-1, 1], size=(1, n_sys, h, w)).astype(np.int8)).to(dev)
    a, b = s0.clone(), s0.clone()
    for gibbs in (False, True):
        for _ in range(2):
            pk = sweep.sweep_2d(a, coup, temps, words, gibbs=gibbs, measure=True)
            pp = sweep.sweep_2d_plain(b, jg, temps, words, gibbs=gibbs, measure=True)
            torch.cuda.synchronize()
            if not (torch.equal(a, b) and torch.equal(pk[0].sum(-1), pp[0].sum(-1))
                    and torch.equal(pk[1].sum(-1), pp[1].sum(-1))):
                raise AssertionError(f"sweep_2d at 32x32 x 16 (gibbs={gibbs}) differs")
            words = words * 3 + 1
    ms = gpu_ms(lambda: sweep.sweep_2d(a, coup, temps, words, gibbs=False), 100) / 2
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
WINDING_SRC = "peapods_tpu_torch/csrc/winding.cu"
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


def winding_want(shape, n_graphs, n):
    """The winding kernels' launches in ``n`` observed sweeps of ``n_graphs``
    graphs of ``shape``: ``winding``, or where the graph does not fit one
    CTA ``winding_link``, ``_border``, ``_wrap`` and ``_check``."""
    from peapods_tpu_torch.ops import winding

    return {k: n * v for k, v in winding.winding_launches(shape, n_graphs).items()}


def winding_stages(masks, labels, shape, dev):
    """The tiled winding's launches one at a time on a graph batch of the
    main path, each against its plain version on the kernels' own inputs:
    ``winding_link``'s parents (each site's open-component minimum in its
    box), ``winding_border``'s (they lead to the open labels),
    ``winding_wrap``'s flags from them, ``winding_check``'s error word (0)
    and counts (a claim for each component).  Returns each launch's plain
    time and bound from this state's counts: the masks in and the open
    labelling's parents out (link); the face sites' masks, the two box
    roots of each open bond that leaves a box (border); the wrap bonds'
    masks, the parents of each active one's two ends, the flags (wrap); the
    labels and parents in (check).  The bounds leave out W, the union-find
    of sheets that only this design keeps (its scratch); the function's
    own bound, the masks and labels in and a flag byte a graph out, is the
    four launches' together (``check_observe_kernels``)."""
    from peapods_tpu_torch.ops import _build, fk, winding

    b, n = labels.shape
    l0, l1 = shape
    plan = winding.winding_plan(shape, b)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    parent = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    wsheet = torch.empty((b, n), dtype=torch.int64, device=dev)
    cnt = torch.full((b, 3), 7, dtype=torch.int32, device=dev)
    out = torch.empty(b, dtype=torch.uint8, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    t0, t1, _ = plan.tile
    pm, pp, pw, pc = masks.data_ptr(), parent.data_ptr(), wsheet.data_ptr(), cnt.data_ptr()
    _build.check(lib.peapods_winding_link(pm, pp, pw, pc, b, l0, l1, t0, t1, plan.threads,
                                          stream), "winding_link")
    boxes = parent.clone()
    _build.check(lib.peapods_winding_border(pm, pp, b, l0, l1, t0, t1, stream),
                 "winding_border")
    crossed = parent.clone()
    _build.check(lib.peapods_winding_wrap(pm, pp, pw, out.data_ptr(), b, l0, l1, stream),
                 "winding_wrap")
    _build.check(lib.peapods_winding_check(labels.data_ptr(), pp, pw, pc, err.data_ptr(),
                                           b, l0, l1, stream), "winding_check")
    torch.cuda.synchronize()
    sites = torch.arange(n, device=dev)
    open_labels = winding.winding_border_plain(masks, shape)
    wx, wy = winding.winding_wrap_plain(masks, open_labels, shape)
    comps = (labels == sites).sum(-1, dtype=torch.int32)
    bad = {"winding_link": int((boxes != winding.winding_link_plain(
               masks, shape, plan.tile)).sum()),
           "winding_border": int((fk.fk_link_flatten_plain(crossed) != open_labels).sum()),
           "winding_wrap": int((((out & 1) != 0) != wx).sum() + (((out & 2) != 0) != wy).sum()),
           "winding_check": int(err) + int((cnt[:, 0] != comps).sum())
           + int((cnt[:, 1] != comps).sum())}
    opened = winding.open_masks(masks, shape)
    keep = fk.tile_bonds(shape, 2, plan.tile, dev)
    faces = b * int((~keep).any(-1).sum())
    crossing = int((opened & ~keep).sum())
    wrap = b * (l0 + l1)
    active = int(masks.sum()) - int(opened.sum())
    n_open = int((open_labels == sites).sum())
    plain = {
        "winding_link": wall_ms(lambda: winding.winding_link_plain(masks, shape, plan.tile), 2),
        "winding_border": wall_ms(lambda: winding.winding_border_plain(masks, shape), 2),
        "winding_wrap": wall_ms(lambda: winding.winding_wrap_plain(masks, open_labels,
                                                                   shape), 2),
        "winding_check": wall_ms(lambda: winding.winding_check_plain(masks, labels, shape), 2),
    }
    by = {"winding_link": 6 * b * n, "winding_border": 2 * faces + 8 * crossing,
          "winding_wrap": 2 * wrap + 8 * active + b, "winding_check": 8 * b * n}
    recs = {k: dict(zip(("bound_ms", "bound_by"), bound(by[k], 0)), plain_ms=plain[k])
            for k in by}
    return bad, recs, dict(faces=faces, crossing=crossing, active_wrap=active,
                           open_roots=n_open, tile=plan.tile)


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
            **winding_want((L, L), 1, n), "pt_step": n}
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
    b = h["n_disorder"] * h["n_temps"]
    want = {"sweep_2d": 2 * n, "fk_bonds": n, **link_want(h["shape"], b, n),
            **winding_want(h["shape"], b, n), "pt_step": n}
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


def kernel_ms(fn, reps, names, tries=3):
    """Device ms a launch of each kernel ``names`` over ``reps`` calls of
    ``fn``, from the profiler's kernel records; a window that lacks one of
    them (a window has been seen to record none while the wrappers counted
    every launch) is profiled again, up to ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        acc, _ = device_time(prof.key_averages(), names)
        out = {k: t / c / 1e3 for k, (t, c) in acc.items()}
        if set(out) == set(names):
            return out
    raise AssertionError(f"the profiler saw {sorted(out)}, expected {names}")


def staged_bounds(b, n, n_nb, d, n_comp):
    """The bounds of the staged path's launches on ``b`` graphs of ``n``
    sites, ``n_nb`` offsets, ``d`` realizations' couplings."""
    cb = 4 * n_nb * d * n
    return {
        # spins, couplings, temps, kb in; state bytes out
        "fk_bonds_staged": bound(b * n + cb + 12 * b + b * n, 8 * n_nb * b * n),
        # the labelling: state bytes in, labels out
        "cc_link": cc_bound(b, n),
        # spins, labels, scalars in; spins out
        "fk_finish": bound(2 * b * n + 4 * b * n + 12 * b, 0),
    }


def cc_bound(b, n):
    """The labelling's bound on ``b`` graphs of ``n`` sites, in either form:
    the state bytes in and the int32 labels out, 5 bytes a site."""
    return bound(5 * b * n, 0)


def check_observe_kernels(obs, hobs, staged, dev, rng):
    """Phase 23: every new kernel against its plain version on the main
    paths' states: ``fk_finish`` in observe form (spins untouched, labels
    and masks equal), ``winding`` (flags equal) and the labelling (labels
    bitwise ``connected_components``: on the 256^2 graph at T_c, row 15's
    shape, tiled, ``cc_link``, ``cc_link_border``, ``fk_link_flatten``; on
    the harness's 2048 graphs of 64^2 one ``cc_link`` launch);
    ``fk_bonds_staged``, ``cc_link`` and ``fk_finish`` reading the labels on
    the staged runs' states, SW and Wolff (masks, labels, spins bitwise),
    with the labelling alone on those masks.  Then the plain versions'
    times and the bounds at each shape (the labelling's: the function's,
    state bytes in, labels out)."""
    from peapods_tpu_torch.ops import _build, cc, cluster, fk, winding
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
        log("23 kernel-vs-plain", f"FK observe's labels (the labelling's parents), "
            f"winding, the CC labelling {cc.link_launches(shape, b)} on {name} ({b} graph(s) of "
            f"{'x'.join(map(str, shape))}): mismatches {bad}; {n_comp} clusters, "
            f"{int(mk.sum())} active bonds, {int(wk[0].sum())} / {int(wk[1].sum())} graphs "
            f"wind along x / y; winding launches {winding.winding_launches(shape, b)}")
        times.setdefault("cc_link", {})[name] = dict(
            zip(("bound_ms", "bound_by"), cc_bound(b, n)),
            plain_ms=wall_ms(lambda: cc.cc_labels_plain(mp, lat), 3),
            bound_is="the labelling's: state bytes in, labels out")
        if winding.winding_plan(shape, b).tiled:
            wbad, recs, counts = winding_stages(mk, lk.view(b, n), shape, dev)
            log("23 kernel-vs-plain", f"winding's tiled launches one at a time on {name} "
                f"(tiles {counts['tile']}: {counts['faces']} face sites, "
                f"{counts['crossing']} open bonds leave a box, {counts['active_wrap']} "
                f"active wrap bonds, {counts['open_roots']} open components): "
                f"mismatches {wbad}")
            if any(wbad.values()):
                raise AssertionError(f"winding's launches differ from plain on {name}: "
                                     f"{wbad}")
            for k, v in recs.items():
                times.setdefault(k, {})[name] = v
        # the function, in either form: masks and labels in; one flag byte a
        # graph out
        times.setdefault("winding", {})[name] = dict(
            zip(("bound_ms", "bound_by"), bound(6 * b * n + b, 0)),
            plain_ms=wall_ms(lambda: cluster.winding_flags(mp, lp, shape), 2))
        # the labelling on these graphs (row 15: one 256^2 graph, tiled),
        # off the main path: the profiler's device time a launch, and a call
        got = kernel_ms(lambda: cc.cc_labels(mk, lat), 20, tuple(cc.link_launches(shape, b)))
        times["cc_link"][name].update(ms_off_path=got["cc_link"],
                                      call_ms_off_path=sum(got.values()),
                                      per_launch_ms_off_path=got)

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
            log("23 kernel-vs-plain", f"fk_bonds_staged, cc_link, fk_finish "
                f"{'wolff' if wolff else 'sw'} on {name} ({b} graphs of "
                f"{'x'.join(map(str, lat.shape))}, {n_nb} offsets): mismatches {bad}; "
                f"{n_comp} clusters, {int(mk.sum())} active bonds")
        sp = x["spins"]
        bd = fk.fk_bonds_plain(sp, x["j_fwd"], x["temps"], x["kb_words"],
                               offsets=lat.offsets)
        # the staged bonds' state bytes alone: the bonds and no other bit
        st = torch.empty((b, n), dtype=torch.uint8, device=dev)
        fk.launch_staged_bonds(_build.library(), torch.cuda.current_stream(dev).cuda_stream,
                               sp, x["j_fwd"], x["temps"], x["kb_words"], st, lat)
        bits = torch.arange(n_nb, dtype=torch.uint8, device=dev)
        want = (bd.to(torch.uint8) << bits).sum(-1, dtype=torch.uint8)
        torch.cuda.synchronize()
        if not torch.equal(st, want):
            raise AssertionError(f"fk_bonds_staged's state bytes on {name}: "
                                 f"{int((st != want).sum())} differ from the plain bonds")
        log("23 kernel-vs-plain", f"fk_bonds_staged's state bytes on {name}: every byte "
            f"the plain bonds' bits 0 .. {n_nb - 1} and no other bit")
        lab = cc.cc_labels_plain(bd, lat)
        plain = {
            "fk_bonds_staged": wall_ms(lambda: fk.fk_bonds_plain(
                sp, x["j_fwd"], x["temps"], x["kb_words"], offsets=lat.offsets), 3),
            "cc_link": wall_ms(lambda: cc.cc_labels_plain(bd, lat), 3),
            "fk_finish": wall_ms(lambda: fk.fk_finish_plain(
                sp.clone(), lab, x["j_fwd"], x["scalars"], wolff=False,
                with_measure=False), 3),
        }
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
    """Add this section's numbers to the kernel records: ``cc_link`` (the
    BCC SW run's numbers; FCC, NNN, the 256^2 graph and the harness beside
    them; ``cc_link_border``'s record comes with the space path's tiled
    run, :func:`add_space_records`), the tiled winding's launches (the 256^2
    observe run's), ``winding`` (the harness observe's), ``fk_bonds_staged``
    (BCC; FCC, NNN); the observe and
    staged runs' numbers beside the FK kernels', ``sweep_2d``'s (row 2) and
    the coloured lattices' kernels'."""
    from peapods_tpu_torch.ops import winding

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
                              *((k, WINDING_SRC, "observe256", WINDING_REPLACES)
                                for k in winding.TILED),
                              ("winding", WINDING_SRC, "harness_observe", WINDING_REPLACES),
                              ("fk_bonds_staged", "peapods_tpu_torch/csrc/fk.cu", "bcc16_sw",
                               "peapods_tpu/ops/pallas_event.py:621")):
        kr = dict(name=k, route="cuda", source=src, replaces=rep, max_abs_err=0.0,
                  library_ms=None, **at(k, main))
        for name in runs:
            if name != main and name in times.get(k, {}):
                kr[f"at_{name}"] = at(k, name)
        if k == "cc_link":
            kr["at_observe256"]["replaces"] = CC2D_REPLACES
        if k == "fk_bonds_staged":
            kr["on_the_reference_path"] = ("peapods_tpu/ops/cluster.py:555 "
                                           "fk_bond_activation (jnp, staged path)")
        kernels.append(kr)
        lines.append((main, kr))
    # the winding flags as a function at 256^2 observe: the tiled form's
    # launches together against the function's bound (on the winding record)
    la, u = runs["observe256"]["launches"], us["observe256"]
    tiled = [k for k in winding.TILED if k in la]
    if tiled:
        calls = la[tiled[0]]
        rec = next(kr for kr in kernels if kr["name"] == "winding")
        rec["at_observe256"] = dict(
            times["winding"]["observe256"], max_abs_err=0.0,
            ms=sum(u[k] * la[k] for k in tiled) / calls / 1e3,
            launches_per_sweep=calls / la["pt_step"], launches={k: la[k] for k in tiled},
            per_launch_ms={k: u[k] / 1e3 for k in tiled},
            form="tiled: a call is one launch of each, the bound the function's")
        log("23 times", f"winding flags at observe256, a call of {len(tiled)} launches: "
            f"{rec['at_observe256']['ms']:.5f} ms against the function's bound "
            f"{rec['at_observe256']['bound_ms']:.6f} ms (masks and labels in, a flag byte "
            f"a graph out; the launches' own bounds leave out W) on {card}")
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
    move on the canonical square.  The observe form builds no grey graph and
    launches no ``ov_mid``, ``ov_finish`` or ``houdn_finish``: ``fk_link``
    labels the stats graph into the labels buffer."""
    interval = kw["overlap_cluster_update_interval"]
    modes = kw["overlap_cluster_build_mode"].split("+")
    moves = [modes[(s // interval) % len(modes)] for s in range(0, n, interval)
             if not (observe and s < warmup)]
    houdn = sum(m.startswith("houd") for m in moves)
    pair = len(moves) - houdn
    n_cmr = 0 if observe else sum(m == "cmr" for m in moves)
    fin = 0 if observe else 1  # the observe form launches no finish
    counts = {"colour_pass": 2 * n, "pt_step": n + len(moves), "pair_overlap": n,
              "ov_bonds": pair, "fk_link": len(moves) + n_cmr, "ov_mid": n_cmr,
              "ov_finish": fin * pair, "houdn_bonds": houdn, "houdn_finish": fin * houdn,
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
    on the masks and labels) every kind's observe form (its launches: the
    first kernel and the labelling, no finish): everything bitwise the
    plain versions, ``houdn_bonds`` and ``houdn_finish`` also alone
    (:func:`move_alone`).  Then the plain versions' times and the bounds of
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
            msg += "; " + move_alone(st["spins"], st["sid"], tab, rt.coup, rt.temps, shape,
                                     "houdayer", wolff, dev)
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
            if kind == "cmr" and not observe:
                cmr_flipped = int((a != x["spins"]).sum())
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
                b, n, g, d, s, wolff=wolff, flipped=flips(st, tab, wolff)).items():
            rec = dict(max_abs_err=0.0, bound_ms=bound_ms, bound_by=bound_by,
                       plain_ms=plain_ms, plain_is="the whole Houdayer(4) move"
                       + (", with labels" if labels else ""))
            if name == "main":
                out[k] = rec
            else:
                out[k][f"at_{name}"] = rec
    # ov_finish at the main run (cmr+houd4: CMR SW on config 4's state),
    # with the spins that the check's CMR move flipped
    out["ov_finish_cmr_houd4"] = ov_finish_bound(d * rt.n_temps * rt.n_pairs, n, "cmr",
                                                 False, cmr_flipped)
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
            for k in overlap.LAUNCHES:
                overlap.LAUNCHES[k] = 0
            gk = overlap.overlap_event(a, *args, **kw)
            gp = overlap.overlap_event_plain(b_sp, *args, **kw)
            torch.cuda.synchronize()
            bad = graph_mismatches(a, b_sp, gk, gp)
            bad["spins written"] = int((a != y["spins"]).sum())
            # the observe form: the first kernel and the labelling, no finish
            launched = {k: v for k, v in overlap.LAUNCHES.items() if v}
            bad["launches"] = int(launched != {
                "houdn_bonds" if kind == "houdayer" else "ov_bonds": 1})
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
                f"graphs of {'x'.join(map(str, shape_o))}; launches {launched}, the "
                f"labelling's parents handed on as the labels): labels"
                f"{' (blue)' if kind == 'cmr' else ''}, masks"
                f"{' and winding flags' if wind else ''} bitwise the plain version, no "
                f"spin written: mismatches {bad}; "
                f"{int((gk.stats == torch.arange(n_o, device=dev)).sum())} clusters, "
                f"{int(gk.masks.sum())} active bonds{extra} ok")
            if kind != "houdayer":
                continue
            log("26 kernel-vs-plain", f"houdayer on {name}'s state: " + move_alone(
                y["spins"], y["sid"], tab, rt_o.coup, rt_o.temps, shape_o, kind, False, dev)
                + " ok")
            plain_ms = wall_ms(lambda: overlap.overlap_event_plain(
                y["spins"].clone(), *args, **kw), 3)
            # the observe form launches houdn_bonds and the labelling only
            bound_ms, bound_by = houdn_bounds(b_o, n_o, 2, d_o, s_o, wolff=False,
                                              flipped=0)["houdn_bonds"]
            out["houdn_bonds"][f"at_{name}"] = dict(
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
            if k in run["launches"]:  # the observe runs launch no houdn_finish
                kr[f"at_{name}"] = dict(houdn[k][f"at_{name}"], **at(run, key, k))
        kr["at_config4"] = dict(pk["config4"][k], replaces=EV_REPLACES,
                                launches_per_sweep=pk["config4"][k]["launches"]
                                / SG_CONFIGS["config4"]["sweeps"])
        kernels.append(kr)
    def move_bounds(run):
        """Row 19's bounds per launch on a run's shapes, as config 5's (the
        observe runs launch ``ov_bonds`` and the labelling only;
        ``ov_finish``'s, on the main run, counts the spins that phase 24's
        CMR move flipped)."""
        rt = run["model"]._sim.rt
        n, nd = rt.n_spins, rt.lattice.n_dims
        b = rt.n_disorder * rt.n_temps * rt.n_pairs
        cb = 4 * nd * rt.n_disorder * n
        # ov_bonds: both spins and the couplings in, the state bytes out;
        # ov_mid: also the state bytes and the flat parents (the blue
        # labels, which fk_link wrote) in, state2 out; no parent written
        # (fk_link writes every parent; the first design's bound counted
        # one a site, and ov_mid's the blue labels written too)
        return {"ov_bonds": bound(3 * b * n + cb, 12 * nd * b * n),
                "fk_link": bound(5 * b * n, 0),
                "ov_mid": bound(8 * b * n + cb, 12 * nd * b * n),
                "ov_finish": houdn["ov_finish_cmr_houd4"]}

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


# ------------------------------------------------ the per-sweep replica path


# tests/binder_crossings.py's largest cases at full width (:78-120): a
# ferromagnet with R = 2, SW and PT every sweep, on each lattice's ladder
# around its T_c (utils.py:14-18), cut in depth to 256 sweeps
BINDER_SWEEPS = 256
BINDER_RUNS = {
    "square32": dict(shape=(32, 32), geometry=None, tc=T_C, half=0.3, n_temps=32),
    "tri32": dict(shape=(32, 32), geometry="triangular", tc=4.0 / np.log(3.0), half=0.4,
                  n_temps=32),
    "cubic10": dict(shape=(10, 10, 10), geometry=None, tc=4.511, half=0.4, n_temps=24),
    "bcc10": dict(shape=(10, 10, 10), geometry="bcc", tc=6.235, half=0.5, n_temps=24),
    "fcc10": dict(shape=(10, 10, 10), geometry="fcc", tc=9.792, half=0.6, n_temps=24),
}
BINDER_KW = dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1)
BINDER_SEED = 42
# config 4 at full width with cmr+houd4 SW every 10 sweeps, the moves'
# statistics and a snapshot at every move past warmup: the per-sweep
# replica path (snapshots turn the pairs megakernel off in the reference)
SNAP_KW = dict(HOUDN_KW, snapshot_interval=10)


def binder_model(c, dev):
    from peapods_tpu_torch import Ising

    temps = np.linspace(c["tc"] - c["half"], c["tc"] + c["half"],
                        c["n_temps"]).astype(np.float32)
    geo = {} if c["geometry"] is None else dict(geometry=c["geometry"])
    return Ising(c["shape"], temperatures=temps, n_replicas=2, seed=BINDER_SEED,
                 device=dev, **geo)


def reset_replica_sweep_counts():
    reset_cluster_counts()
    reset_pair_counts()


def replica_sweep_counts():
    """The per-sweep replica path's launches since the last reset, the
    kernels that ran."""
    from peapods_tpu_torch.ops import megapair, overlap

    return {**cluster_counts(), **{k: v for k, v in {**megapair.LAUNCHES,
                                                     **overlap.LAUNCHES}.items() if v}}


def replica_sweep_want(model, kw, n, warmup):
    """Launches of ``n`` sweeps from sweep 0 on the per-sweep replica path:
    the sweeps, FK phase and measurement of :func:`nb_want` (``sweep_2d``
    twice a sweep on the square lattice, whose SW update measures); a
    ``pair_overlap`` and a ``pt_step`` a sweep; per overlap move the
    kernels of :func:`move_counts` and a second ``pt_step``."""
    lat = model._sim.rt.lattice
    if lat.square:
        n_fk = len(range(0, n, kw["cluster_update_interval"]))
        want = {"sweep_2d": 2 * n, "fk_bonds": n_fk, "fk_finish": n_fk, "pt_step": n,
                **link_want(lat.shape, model._sim.rt.n_disorder * model._sim.rt.n_systems,
                            n_fk)}
    else:
        want = nb_want(model, kw, n)
    want["pair_overlap"] = n
    if "overlap_cluster_update_interval" in kw:
        moves = move_counts(kw, n, warmup)
        moves.pop("colour_pass")
        moves.pop("pair_overlap")
        want["pt_step"] = moves.pop("pt_step")
        for k, v in moves.items():
            want[k] = want.get(k, 0) + v
    return {k: v for k, v in want.items() if v}


def replica_sweep_checksum(sim, result) -> str:
    """:func:`stats_checksum`, the FK histograms and every snapshot."""
    h = hashlib.sha256(stats_checksum(sim, result).encode())
    for x in result.get("fk_csd", []):
        h.update(np.ascontiguousarray(x).tobytes())
    for snap in result.get("cluster_snapshots", []):
        for key in sorted(snap):
            h.update(np.ascontiguousarray(np.asarray(snap[key])).tobytes())
    return h.hexdigest()[:16]


def replica_sweep_run(name, make, kw, n, dev, card, phase):
    """A per-sweep replica run through Ising.sample twice from one seed: the
    launch counts of the first (zeroed just before, read just after)
    against the rule, two equal checksums, the rate of a warm call."""
    warmup = int(np.floor(n * 0.25 + 0.5))
    models, results, checks = [], [], []
    for run in range(2):
        model = make()
        torch.cuda.synchronize()
        reset_replica_sweep_counts()
        result = model.sample(n, "metropolis", **kw)
        torch.cuda.synchronize()
        if run == 0:
            launches = replica_sweep_counts()
        models.append(model)
        results.append(result)
        checks.append(replica_sweep_checksum(model._sim, result))
    want = replica_sweep_want(models[0], kw, n, warmup)
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches}, expected {want}")
    if checks[0] != checks[1]:
        raise AssertionError(f"{name} checksums differ: {checks}")
    r = results[0]
    rt = models[0]._sim.rt
    e, q2, ql = r["energies"], r["overlap2"], r["link_overlap"]
    sane = {
        "finite": bool(np.isfinite(e).all() and np.isfinite(q2).all()
                       and np.isfinite(ql).all()),
        "<e> falls with T": bool(e[0] > e[-1]),
        "<q^2> falls with T": bool(q2[0] > q2[-1]),
        "q^2 in [0, 1]": bool(((q2 >= 0) & (q2 <= 1)).all()),
        "|q_l| <= 1": bool((np.abs(ql) <= 1).all()),
        "histogram counts": int(np.asarray(r["overlap_histogram"]).sum())
        == (n - warmup) * rt.n_disorder * rt.n_pairs * rt.n_temps,
    }
    if not all(sane.values()):
        raise AssertionError(f"{name} sanity: {sane}")
    sweeps_s, rates = warm_rate(models[1], n, kw, calls=3)
    log(phase, f"{name}: {'x'.join(map(str, rt.lattice.shape))}, "
        f"{rt.lattice.n_neighbors} offsets, {rt.n_temps} temps x {rt.n_replicas} "
        f"replicas x {rt.n_disorder} realizations, {n} sweeps on {dev}: launches "
        f"{launches}; checksum {checks[0]} == {checks[1]}; sanity ok: {', '.join(sane)}; "
        f"<e>[0,-1] {e[0]:.5f}, {e[-1]:.5f}; <q^2>[0,-1] {q2[0]:.5f}, {q2[-1]:.5f}; "
        f"<q_l>[0,-1] {ql[0]:.5f}, {ql[-1]:.5f}; {sweeps_s:.1f} sweeps/s (median of "
        f"{', '.join(f'{x:.1f}' for x in rates)}) on {card}")
    return dict(model=models[1], result=r, launches=launches, sweeps_s=sweeps_s,
                checksum=checks[0], kw=kw, n=n)


def check_pair_overlap_on(run, dev, name, card, phase="33 kernel-vs-plain"):
    """pair_overlap on the run's final state against its plain version (qs,
    ql bitwise), its plain version's time and its bound: the paired systems'
    spins read once, two ints a column written."""
    from peapods_tpu_torch.ops import megapair

    sim = run["model"]._sim
    rt, lat = sim.rt, sim.rt.lattice
    d, s, n = rt.n_disorder, rt.n_systems, rt.n_spins
    spins = sim.state["spins"].view(d, s, n)
    sid = sim.state["system_ids"].view(d, s)
    offsets = lat.offsets
    cols = rt.n_pairs * rt.n_temps
    qs = torch.empty((d, cols), dtype=torch.int32, device=dev)
    ql = torch.empty_like(qs)
    megapair.pair_overlap(spins, sid, qs, ql, shape=lat.shape, n_replicas=rt.n_replicas,
                          offsets=offsets)
    ps, pl = megapair.pair_overlap_plain(spins, sid, lat.shape, rt.n_replicas, offsets)
    torch.cuda.synchronize()
    if not (torch.equal(qs, ps) and torch.equal(ql, pl)):
        raise AssertionError(f"{name} pair_overlap differs from its plain version")
    plain_ms = wall_ms(lambda: megapair.pair_overlap_plain(spins, sid, lat.shape,
                                                           rt.n_replicas, offsets), 5)
    b_ms, b_by = bound(2 * d * cols * n + 8 * d * cols,
                       (2 + 2 * lat.n_neighbors) * d * cols * n)
    log(phase, f"{name} pair_overlap ok: {d * cols} (pair, T) columns over "
        f"{lat.n_neighbors} offsets bitwise pair_overlap_plain on the run's state "
        f"(plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by}) on {card}")
    return dict(max_abs_err=0.0, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                launches=run["launches"]["pair_overlap"], replaces=PAIR_REPLACES)


PAIR_REPLACES = "peapods_tpu/ops/pallas_megapair.py:325"


def replica_sweeps(dev, card):
    """Phases 31-33: binder_crossings.py's largest case on each lattice
    (R = 2, SW and PT every sweep) and config 4 with cmr+houd4, statistics
    and snapshots, each through Ising.sample twice from one seed; then each
    run's device time a sweep and busy share over a profiled main-path
    window, and pair_overlap on each run's state against its plain version,
    its time a launch beside its bound."""
    from peapods_tpu_torch import Ising

    t0 = time.perf_counter()
    runs = {}
    for name, c in BINDER_RUNS.items():
        runs[name] = replica_sweep_run(
            name, lambda c=c: binder_model(c, dev), BINDER_KW, BINDER_SWEEPS, dev, card,
            "31 binder")
        r, m = runs[name]["result"], runs[name]["model"]
        temps = np.asarray(m.temperatures, np.float64)
        at_tc = float(np.interp(c["tc"], temps, m.binder_cumulant))
        if not -0.1 < at_tc < 2.0 / 3.0 + 0.05:
            raise AssertionError(f"{name} Binder cumulant at T_c {at_tc}")
        log("31 binder", f"{name}: Binder cumulant at T_c = {c['tc']:.4f} {at_tc:.4f} "
            f"({BINDER_SWEEPS} sweeps of one size: no crossing is judged here)")
    c4 = SG_CONFIGS["config4"]

    def config4():
        return Ising(c4["shape"], couplings=c4["couplings"],
                     temperatures=np.geomspace(*c4["t"], SG_T), n_replicas=SG_R,
                     n_disorder=SG_D, seed=c4["seed"], device=dev)

    n4 = c4["sweeps"]
    runs["config4_snapshots"] = snap = replica_sweep_run(
        "config4_snapshots", config4, SNAP_KW, n4, dev, card, "32 snapshots")
    r = snap["result"]
    warmup = int(np.floor(n4 * 0.25 + 0.5))
    snaps = r["cluster_snapshots"]
    want = list(range(-(-warmup // 10) * 10, n4, 10))
    if [x["sweep_id"] for x in snaps] != want:
        raise AssertionError(f"snapshot sweeps {[x['sweep_id'] for x in snaps][:5]}...")
    n = 512
    for x in snaps:
        cmr = x["mode_idx"] == 0
        ok = (x["cluster_ids"].shape == (SG_T, n) and x["spins"].shape == (SG_T, 2, n)
              and x["system_ids"].shape == (SG_T, 2) and ("blue_ids" in x) == cmr
              and x["cluster_ids"].dtype == np.uint32
              and x["system_ids"].dtype == np.uint64
              and (x["cluster_ids"] <= np.arange(n)).all())
        if not ok:
            raise AssertionError(f"snapshot at sweep {x['sweep_id']}: bad entry")
    check_mode_stats(r, snap["model"]._sim,
                     mode_graphs(snap["model"]._sim, SNAP_KW, n4, warmup))
    log("32 snapshots", f"config4 cmr+houd4 SW + stats + snapshot_interval=10: "
        f"{len(snaps)} snapshots (sweeps {want[0]}..{want[-1]}), each realization 0's "
        "first group at every temperature: labels (each its component's least "
        "site), CMR's blue labels, the pre-move spins and system ids; "
        "overlap_csd against the stats graphs ok")
    for name, run in runs.items():
        us, line = profile_window(run["model"], run["kw"], run["sweeps_s"],
                                  64 if name != "config4_snapshots" else 100,
                                  names=tuple(run["launches"]))
        run["us"] = us
        run["pair"] = check_pair_overlap_on(run, dev, name, card)
        run["pair"]["ms"] = us["pair_overlap"] / 1e3
        log("33 times", f"{name} {line} (on {card})")
        p = run["pair"]
        log("33 times", f"{name} pair_overlap {p['ms']:.5f} ms a launch (bound "
            f"{p['bound_ms']:.6f} ms by {p['bound_by']}, plain {p['plain_ms']:.4f} ms) "
            f"on {card}")
    log("33 times", f"phases 31-33 took {time.perf_counter() - t0:.1f} s")
    return runs


def add_replica_sweep_records(kernels, runs):
    """pair_overlap's numbers on each per-sweep replica run beside its
    main-path record."""
    kr = next(k for k in kernels if k["name"] == "pair_overlap")
    for name, run in runs.items():
        kr[f"at_{name}"] = run["pair"]


# ------------------------------------------------ the overlap moves off the axes


# Phase 34: the overlap moves on the triangular, BCC, FCC and NNN lattices
# at full width, each run named by the configuration it carries over:
# config 4's settings (SG_CONFIGS: +-J, R = 4, d = 8, 24 temperatures, PT
# every sweep) on a 64^2 triangular lattice (z = 6, as on the cubic one)
# with spin_glass_crossings.py's cmr+houd4 SW every 10 sweeps and its
# statistics; config 5's (16^3 gaussian, R = 4, d = 8, full-ladder PT,
# jorg+cmr every 10 sweeps) on BCC and FCC, its ladder
# scaled by sqrt(z / 6); and the 64^2 NNN table with overlap observe every
# sweep (as phase 26's 64^2 square, cut in depth to 256 sweeps)
NNN_TABLE = [[1, 0], [0, 1], [1, 1], [1, -1]]
OV_LATTICE_RUNS = {
    "tri64": dict(shape=(64, 64), geometry="triangular", couplings="bimodal",
                  t=(0.9, 2.2), n_temps=SG_T, n_replicas=SG_R, n_disorder=SG_D, seed=4,
                  sweeps=512, kw=HOUDN_KW),
    "bcc16": dict(shape=(16, 16, 16), geometry="bcc", couplings="gaussian",
                  t=tuple(x * math.sqrt(8 / 6) for x in (0.8, 2.0)), n_temps=SG_T,
                  n_replicas=SG_R, n_disorder=SG_D, seed=5, sweeps=512,
                  kw=SG_CONFIGS["config5"]["kw"]),
    "fcc16": dict(shape=(16, 16, 16), geometry="fcc", couplings="gaussian",
                  t=tuple(x * math.sqrt(12 / 6) for x in (0.8, 2.0)), n_temps=SG_T,
                  n_replicas=SG_R, n_disorder=SG_D, seed=5, sweeps=512,
                  kw=SG_CONFIGS["config5"]["kw"]),
    "nnn64": dict(shape=(64, 64), geometry=NNN_TABLE, couplings="bimodal", t=(0.8, 2.0),
                  n_temps=8, n_replicas=2, n_disorder=4, seed=6, sweeps=256,
                  kw=dict(OV_OBSERVE_KW, overlap_cluster_update_interval=1)),
}
# the short run held bitwise to the CPU's plain path: one realization, 12
# sweeps (two moves)
OV_LATTICE_CPU_SWEEPS = 12


def ov_lattice_model(c, dev, n_disorder=None):
    from peapods_tpu_torch import Ising

    geo = c["geometry"]
    kw = dict(geometry=geo) if isinstance(geo, str) else dict(neighbor_offsets=geo)
    return Ising(c["shape"], couplings=c["couplings"],
                 temperatures=np.geomspace(*c["t"], c["n_temps"]),
                 n_replicas=c["n_replicas"], n_disorder=n_disorder or c["n_disorder"],
                 seed=c["seed"], device=dev, **kw)


def ov_lattice_alone(x, rt, tab, kind, wolff, g, dev):
    """Each widened kernel of a move on its own inputs on a run's state:
    the first kernel's state bytes and seeds (and ov_mid's state2 bytes),
    left in the scratch by the move, bitwise houdn_states_plain /
    bond_states_plain; ov_finish or houdn_finish launched alone on the
    plain version's last graph, every spin bitwise finish_plain; returns
    the mismatches."""
    from peapods_tpu_torch.ops import _build, fk, overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    lat = rt.lattice
    spins, sid = x["spins"].view(x["sid"].shape + (-1,)), x["sid"]
    d, s, n = spins.shape
    args = (sid, tab[0], rt.coup, rt.temps, *tab[1:])
    houd = kind == "houdayer"
    if houd:
        st, sd = overlap.houdn_states_plain(spins, sid, tab[0], tab[2], wolff=wolff,
                                            shape=lat)
        last, st2 = st, None
    else:
        st, st2, sd = overlap.bond_states_plain(spins.clone(), *args, kind=kind,
                                                wolff=wolff, shape=lat)
        last = st if kind == "jorg" else st2
    dims, _ = overlap.check_event(spins, *args, lat, kind)
    scratch = overlap.Scratch(dims[0], n, dev, kind == "cmr")
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    overlap.launch_event(lib, stream, dims, spins.clone().data_ptr(),
                         *(t.data_ptr() for t in args), scratch.ptrs(), kind=kind,
                         wolff=wolff, group=g, lattice=lat)
    torch.cuda.synchronize()
    first = "houdn_bonds" if houd else "ov_bonds"
    bad = {f"{first} state": int((scratch.state != st).sum()),
           f"{first} seeds": int((scratch.seeds != sd).sum())}
    if kind == "cmr":
        bad["ov_mid state2"] = int((scratch.state2 != st2).sum())
    par = connected_components(fk.state_masks(last, lat.n_neighbors), lat.shape,
                               lat.offsets).to(torch.int32)
    a, b = spins.clone(), spins.clone()
    overlap.finish_plain(b, sid, tab[0], tab[1], sd, last, par, kind=kind, wolff=wolff,
                         shape=lat)
    per = overlap.ov_per(n, d, rt.n_temps, rt.n_replicas // g,
                         fk.resident_threads(dev.index) // 4,
                         max(1, overlap.HOUDN_ROWS // g) if houd else overlap.OV_MAX_PER)
    words = overlap.ov_words(lat.shape, d, rt.n_temps, rt.n_replicas // g, s, per,
                             tuple(map(tuple, lat.offsets.tolist())))
    if houd:
        _build.check(lib.peapods_houdn_finish(
            a.data_ptr(), sid.data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            last.data_ptr(), par.data_ptr(), sd.data_ptr(), words.ctypes.data, g,
            int(wolff), stream), "houdn_finish")
    else:
        _build.check(lib.peapods_ov_finish(
            a.data_ptr(), sid.data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            sd.data_ptr(), last.data_ptr(), par.data_ptr(), words.ctypes.data,
            overlap.KINDS.index(kind), int(wolff), stream), "ov_finish")
    torch.cuda.synchronize()
    bad["houdn_finish spins" if houd else "ov_finish spins"] = int((a != b).sum())
    return bad, int((b != spins).sum())


def ov_lattice_bounds(rt, kind, wolff, g, flipped):
    """Each widened kernel's bound on a run's shapes: ``ov_bonds`` reads
    both replicas' spins and the couplings over the lattice's offsets and
    writes a state byte a site; ``ov_mid`` also reads the state bytes and
    the flat parents; the finishes and Houdayer's kernels as on the axes
    (:func:`ov_finish_bound`, :func:`houdn_bounds`, with the spins this
    run's move flips); the labelling 5 bytes a site (:func:`cc_bound`)."""
    d, n, nb = rt.n_disorder, rt.n_spins, rt.lattice.n_neighbors
    b = d * rt.n_temps * (rt.n_replicas // g)
    cb = 4 * nb * d * n
    if kind == "houdayer":
        out = houdn_bounds(b, n, g, d, rt.n_systems, wolff=wolff, flipped=flipped)
    else:
        out = {"ov_bonds": bound(3 * b * n + cb, 12 * nb * b * n),
               "ov_finish": ov_finish_bound(b, n, kind, wolff, flipped)}
        if kind == "cmr":
            out["ov_mid"] = bound(8 * b * n + cb, 12 * nb * b * n)
    out["fk_link" if rt.lattice.triangular else "cc_link"] = cc_bound(b, n)
    return out


def ov_lattice_checks(name, run, dev, rng, card, phase="34 kernel-vs-plain"):
    """On a run's final state, each move its build mode holds (houd4 as g =
    4, the pair moves on pairs; the run's Wolff or SW form; observe forms
    for an observe run): the whole move through the kernels bitwise its
    plain version (spins, labels, CMR's blue labels, the stats graph's
    masks), each widened kernel alone (:func:`ov_lattice_alone`), the
    plain move's time and the kernels' bounds."""
    from peapods_tpu_torch.ops import overlap

    x = pair_inputs(run, dev)
    rt = x["rt"]
    lat = rt.lattice
    d, s = x["sid"].shape
    spins = x["spins"].view(d, s, -1)
    kw_run = run["kw"]
    wolff = kw_run.get("overlap_cluster_mode", "wolff") == "wolff"
    observe = kw_run.get("overlap_cluster_action") == "observe"
    out = {}
    for mode in kw_run["overlap_cluster_build_mode"].split("+"):
        kind, g = ("houdayer", int(mode[4:])) if mode.startswith("houd") and mode != "houdayer" \
            else (mode, 2)
        tab = move_tables(rng, d, rt.n_replicas, rt.n_temps, rt.n_spins, kind, wolff, g,
                          dev)
        args = (x["sid"], tab[0], rt.coup, rt.temps, *tab[1:])
        kw = dict(kind=kind, wolff=wolff, shape=lat, with_labels=True,
                  with_masks=g == 2, observe=observe and g == 2)
        a, b = spins.clone(), spins.clone()
        gk = overlap.overlap_event(a, *args, **kw)
        gp = overlap.overlap_event_plain(b, *args, **kw)
        torch.cuda.synchronize()
        bad = graph_mismatches(a, b, gk, gp)
        flipped = int((b != spins).sum())
        if observe:
            bad["spins written"] = flipped
        alone, flipped_alone = ov_lattice_alone(x, rt, tab, kind, wolff, g, dev)
        bad.update(alone)
        if any(bad.values()) or not flipped_alone:
            raise AssertionError(f"{name} {mode}: mismatches {bad}, {flipped_alone} "
                                 "spins flipped")
        plain_ms = wall_ms(lambda: overlap.overlap_event_plain(spins.clone(), *args, **kw), 2)
        bounds = ov_lattice_bounds(rt, kind, wolff, g, flipped_alone)
        for k, (b_ms, b_by) in bounds.items():
            out.setdefault(k, dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                                   plain_ms=plain_ms, plain_is=f"the whole {mode} move"))
        log(phase, f"{name} {mode} ({'wolff' if wolff else 'sw'}"
            f"{', observe' if kw['observe'] else ''}) on the run's state "
            f"({d * rt.n_temps * (rt.n_replicas // g)} tasks of {g} on "
            f"{'x'.join(map(str, lat.shape))}, {lat.n_neighbors} offsets): the move's "
            f"spins, labels{' (grey and blue)' if kind == 'cmr' else ''}"
            f"{', masks' if kw['with_masks'] else ''} and each widened kernel alone "
            f"bitwise the plain version: mismatches {bad}; {flipped_alone} spins flipped "
            f"by the update form; plain move {plain_ms:.3f} ms on {card} ok")
    return out


def ov_lattice_want(model, kw, n, warmup):
    """:func:`replica_sweep_want` off the axes: the labelling is fk_link on
    the triangular lattice and cc_link (:func:`~peapods_tpu_torch.ops.cc.
    link_launches`) on the others, and measure_nb re-derives the energies
    after each update move (energy_partials on the axes)."""
    from peapods_tpu_torch.ops import cc

    lat = model._sim.rt.lattice
    observe = kw.get("overlap_cluster_action") == "observe"
    want = replica_sweep_want(model, {k: v for k, v in kw.items()
                                      if not k.startswith("overlap_")}, n, warmup)
    moves = move_counts(kw, n, warmup, observe=observe)
    for k in ("colour_pass", "pair_overlap"):
        moves.pop(k)
    want["pt_step"] = moves.pop("pt_step")
    want["measure_nb"] = want.get("measure_nb", 0) + moves.pop("energy_partials", 0)
    links = moves.pop("fk_link")
    b = model._sim.rt.n_disorder * model._sim.rt.n_temps * model._sim.rt.n_pairs
    if lat.triangular:
        want["fk_link"] = want.get("fk_link", 0) + links
    else:
        for k, v in cc.link_launches(lat.shape, b).items():
            want[k] = want.get(k, 0) + links * v
    for k, v in moves.items():
        want[k] = want.get(k, 0) + v
    return {k: v for k, v in want.items() if v}


def ov_lattice_cpu(name, c, dev):
    """One realization of the run's configuration, OV_LATTICE_CPU_SWEEPS
    sweeps, on the card and on the CPU's plain path: spins, sid, PT state
    and the statistics bitwise, the records to rtol 1e-12.  Gaussian couplings are drawn +-J here: the
    card's expf and the CPU's exp may round a gaussian bond's probability
    apart, and a f32 energy sum of gaussian terms in another order; +-J
    keeps every sum an exact integer and a bond's probability one of a few
    values a temperature."""
    runs = []
    for device in (dev, "cpu"):
        m = ov_lattice_model(dict(c, couplings="bimodal"), device, n_disorder=1)
        runs.append((m, m.sample(OV_LATTICE_CPU_SWEEPS, "metropolis", **c["kw"])))
    (mk, rk), (mp, rp) = runs
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
        if not torch.equal(mk._sim.state[key].cpu(), mp._sim.state[key]):
            raise AssertionError(f"{name}: {key} differs from the CPU's")
    # the records' f64 folds add in another order on the card (atomics)
    for key in ("energies", "overlap2", "link_overlap"):
        np.testing.assert_allclose(rk[key], rp[key], rtol=1e-12, err_msg=f"{name} {key}")
    for key in ("overlap_csd", "top_cluster_sizes"):
        for u, v in zip(rk.get(key, []), rp.get(key, [])):
            if not np.array_equal(np.asarray(u), np.asarray(v)):
                raise AssertionError(f"{name}: {key} differs from the CPU's")
    return (f"{OV_LATTICE_CPU_SWEEPS} sweeps of one +-J realization on the card bitwise "
            "the CPU's plain path (spins, sid, PT counts, statistics; records to rtol "
            "1e-12)")


def ov_lattice_run(name, c, dev, card, phase="34 lattices"):
    """A run twice from one seed through Ising.sample (launch counts of the
    first against :func:`ov_lattice_want`, two equal checksums, sanity),
    the rate of warm calls."""
    n = c["sweeps"]
    kw = c["kw"]
    warmup = int(np.floor(n * 0.25 + 0.5))
    models, results, checks = [], [], []
    for run in range(2):
        model = ov_lattice_model(c, dev)
        torch.cuda.synchronize()
        reset_replica_sweep_counts()
        result = model.sample(n, "metropolis", **kw)
        torch.cuda.synchronize()
        if run == 0:
            launches = replica_sweep_counts()
        models.append(model)
        results.append(result)
        checks.append(replica_sweep_checksum(model._sim, result))
    want = ov_lattice_want(models[0], kw, n, warmup)
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches}, expected {want}")
    if checks[0] != checks[1]:
        raise AssertionError(f"{name} checksums differ: {checks}")
    r = results[0]
    rt = models[0]._sim.rt
    e, q2 = r["energies"], r["overlap2"]
    sane = {"finite": bool(np.isfinite(e).all() and np.isfinite(q2).all()),
            "<e> falls with T": bool(e[0] > e[-1]),
            "q^2 in [0, 1]": bool(((q2 >= 0) & (q2 <= 1)).all()),
            "statistics as asked": ("overlap_csd" in r) == bool(
                kw.get("collect_cluster_stats") or kw.get("overlap_cluster_action"))}
    if not all(sane.values()):
        raise AssertionError(f"{name} sanity: {sane}")
    sweeps_s, rates = warm_rate(models[1], n, kw, calls=3)
    log(phase, f"{name}: {'x'.join(map(str, rt.lattice.shape))}, "
        f"{rt.lattice.n_neighbors} offsets, {rt.n_temps} temps x {rt.n_replicas} replicas "
        f"x {rt.n_disorder} realizations, {kw['overlap_cluster_build_mode']} "
        f"{kw.get('overlap_cluster_mode', 'wolff')}"
        f"{' observe' if kw.get('overlap_cluster_action') == 'observe' else ''} every "
        f"{kw['overlap_cluster_update_interval']} sweeps, {n} sweeps on {dev}: launches "
        f"{launches}; checksum {checks[0]} == {checks[1]}; sanity ok: {', '.join(sane)}; "
        f"<e>[0,-1] {e[0]:.5f}, {e[-1]:.5f}; <q^2>[0,-1] {q2[0]:.5f}, {q2[-1]:.5f}; "
        f"{sweeps_s:.1f} sweeps/s (median of {', '.join(f'{x:.1f}' for x in rates)}) on "
        f"{card}")
    return dict(model=models[1], result=r, launches=launches, sweeps_s=sweeps_s,
                checksum=checks[0], kw=kw, n=n)


def ov_lattices(dev, card):
    """Phase 34: each run of OV_LATTICE_RUNS twice from one seed, a short
    run of one realization against the CPU, each move's kernels on the
    run's state against their plain versions, and a profiled main-path
    window: device us a sweep against wall us, each launch's time beside
    its bound."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(2034)
    runs = {}
    for name, c in OV_LATTICE_RUNS.items():
        run = runs[name] = ov_lattice_run(name, c, dev, card)
        log("34 lattices", f"{name}: " + ov_lattice_cpu(name, c, dev) + " ok")
        run["checks"] = ov_lattice_checks(name, run, dev, rng, card)
        us, line = profile_window(run["model"], run["kw"], run["sweeps_s"],
                                  64 if name == "nnn64" else 100,
                                  names=tuple(run["launches"]))
        run["us"] = us
        log("34 times", f"{name} {line} (on {card})")
        for k, rec in run["checks"].items():
            if k in us:
                rec.update(ms=us[k] / 1e3, launches=run["launches"][k])
        log("34 times", f"{name} per launch: " + "; ".join(
            f"{k} {rec['ms']:.5f} ms (bound {rec['bound_ms']:.6f} ms by "
            f"{rec['bound_by']}, plain move {rec['plain_ms']:.3f} ms)"
            for k, rec in run["checks"].items() if "ms" in rec) + f" on {card}")
    log("34 times", f"phase 34 took {time.perf_counter() - t0:.1f} s")
    return runs


def add_ov_lattice_records(kernels, runs):
    """Phase 34's numbers beside the move kernels' records (``at_<run>``)."""
    by_name = {kr["name"]: kr for kr in kernels}
    for name, run in runs.items():
        for k, rec in run["checks"].items():
            if k in by_name and "ms" in rec:
                by_name[k][f"at_{name}"] = dict(rec, replaces=HOUDN_REPLACES
                                                if k.startswith("houdn") else EV_REPLACES)


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
    # fk_finish: spins (read and written), state bytes and labels a site, the
    # realization's couplings once, the partials written
    b, n = c["n_temps"], int(np.prod(c["shape"]))
    fin = run["finish"]
    fin.update(ms=prof["per_launch"]["fk_finish"] / 1e3, launches=run["launches"]["fk_finish"],
               **dict(zip(("bound_ms", "bound_by"), bound(
                   7 * b * n + 4 * 2 * n + 12 * b + 8 * b * ((n + 255) // 256),
                   2 * 2 * b * n))))
    # fk_bonds and sweep_2d (a pass) at this shape: the next redesign's ranking
    bnd = run["bonds"]
    sw = run["sweep_2d"]
    bnd.update(ms=prof["per_launch"]["fk_bonds"] / 1e3, launches=run["launches"]["fk_bonds"],
               **dict(zip(("bound_ms", "bound_by"), bonds_bound(b, n, 2, 1))))
    sw.update(ms=prof["per_launch"]["sweep_2d"] / 1e3, launches=run["launches"]["sweep_2d"],
              **dict(zip(("bound_ms", "bound_by"), sweep_2d_bound(b * n, n))))
    log("28 space", f"unsharded 4096^2: fk_bonds {bnd['ms']:.5f} ms a launch x "
        f"{bnd['launches']} (bound {bnd['bound_ms']:.5f} ms by {bnd['bound_by']}, plain "
        f"{bnd['plain_ms']:.4f} ms); sweep_2d {sw['ms']:.5f} ms a pass x {sw['launches']} "
        f"(bound {sw['bound_ms']:.5f} ms by {sw['bound_by']}, plain {sw['plain_ms']:.4f} "
        f"ms) on {card}")
    log("28 space", f"unsharded 4096^2: the labelling {run['labelling']['ms']:.5f} ms an "
        f"FK phase (" + ", ".join(f"{k} {v:.5f}" for k, v in link.items())
        + f" ms a launch) against its bound {run['labelling']['bound_ms']:.5f} ms; "
        f"fk_finish {fin['ms']:.5f} ms a launch x {fin['launches']} (bound "
        f"{fin['bound_ms']:.5f} ms by {fin['bound_by']}, plain {fin['plain_ms']:.4f} ms); "
        f"{prof['line']} (on {card})")


def leaving_bonds(masks, lat, tile):
    """The active bonds of bool masks ``[B, n, n_nb]`` whose neighbour lies
    outside the site's box of ``tile`` sites (``csrc/cc.cu`` ``cc_step``):
    what ``cc_link_border`` unites."""
    dims = lat.shape + (1,) * (3 - len(lat.shape))
    c = torch.stack(torch.meshgrid(*(torch.arange(a, device=masks.device) for a in dims),
                                   indexing="ij"), -1).reshape(-1, 3)
    off = torch.zeros((lat.n_neighbors, 3), dtype=torch.int64, device=masks.device)
    off[:, :lat.n_dims] = torch.from_numpy(lat.offsets).to(masks.device)
    leave = torch.zeros((c.shape[0], lat.n_neighbors), dtype=torch.bool, device=masks.device)
    for k, (a, t) in enumerate(zip(dims, tile)):
        if t == a:
            continue
        x = c[:, k] % t
        e = torch.clamp(a - (c[:, k] - x), max=t)
        y = x[:, None] + off[None, :, k]
        leave |= (y < 0) | (y >= e[:, None])
    return int((masks & leave[None]).sum())


def check_cc_tiled(run, dev, rng, card):
    """Phase 29: the staged path's tiled labelling on the unsharded 32^3 FCC
    run: its launches in the run (cc.link_launches an FK phase), the labels
    bitwise ``connected_components`` on the run's FK graphs (SW bonds of its
    state), each launch's device time (profiler) against its own bytes, and
    the call's against the function's bound."""
    from peapods_tpu_torch.ops import cc, fk

    sim = run["sim"]
    lat = sim.rt.lattice
    b, n = sim.rt.n_disorder * sim.rt.n_systems, lat.n_spins
    n_fk = run["n"]  # SW every sweep
    names = tuple(cc.link_launches(lat.shape, b))
    want = {k: n_fk * v for k, v in cc.link_launches(lat.shape, b).items()}
    got = {k: run["launches"].get(k, 0) for k in want}
    if got != want or len(names) != 3:
        raise AssertionError(f"32^3 FCC unsharded: labelling launches {got}, expected {want}")
    x = fk_inputs(sim, dev, rng, False)
    masks = fk.fk_bonds_plain(x["spins"], x["j_fwd"], x["temps"], x["kb_words"],
                              offsets=lat.offsets)
    lk = cc.cc_labels(masks, lat)
    lp = cc.cc_labels_plain(masks, lat)
    torch.cuda.synchronize()
    bad = int((lk != lp).sum())
    if bad:
        raise AssertionError(f"32^3 FCC unsharded: {bad} labels differ from plain")
    ms = kernel_ms(lambda: cc.cc_labels(masks, lat), 20, names)
    plan = cc.link_plan(lat.shape + (1,) * (3 - lat.n_dims), b)
    crossing = leaving_bonds(masks, lat, plan.tile)
    bounds = {"cc_link": bound(5 * b * n, 0), "cc_link_border": bound(b * n + 8 * crossing, 0),
              "fk_link_flatten": bound(8 * b * n, 0)}
    plain_ms = wall_ms(lambda: cc.cc_labels_plain(masks, lat), 3)
    n_comp = int((lp == torch.arange(n, device=dev)).sum())
    out = dict(launches=got, per_launch_ms=ms, call_ms=sum(ms.values()),
               call_bound_ms=cc_bound(b, n)[0], plain_ms=plain_ms, tile=plan.tile,
               crossing=crossing, bounds={k: dict(zip(("bound_ms", "bound_by"), v))
                                          for k, v in bounds.items()})
    log("29 space", f"32^3 FCC unsharded: the staged labelling (tiles {plan.tile}, "
        f"{plan.threads} threads) {got} in the run; bitwise connected_components on its "
        f"{b} FK graphs ({n_comp} clusters, {int(masks.sum())} active bonds, {crossing} leave "
        f"their box); " + ", ".join(f"{k} {v:.5f} ms (bound {bounds[k][0]:.6f})"
                                   for k, v in ms.items())
        + f"; a call {out['call_ms']:.5f} ms against the function's bound "
        f"{out['call_bound_ms']:.6f} ms (state bytes in, labels out; plain {plain_ms:.4f} ms) "
        f"on {card}")
    return out


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
    per sweep (:func:`busy_words`)."""
    before = space_counts()
    prof, wall = profiled(lambda: sim.sample(n, "metropolis", **dict(kw, warmup_ratio=0.0)))
    ran = {k: v - before.get(k, 0) for k, v in space_counts().items()}
    per_launch, counts, per_sweep, missed, rest = kernel_times(
        prof, names or SPACE_KERNELS, n, ran)
    copies = other = 0.0
    for key, us in rest.items():
        if "copy" in key.lower() or "memcpy" in key.lower():
            copies += us
        else:
            other += us
    busy = sum(per_sweep.values()) + copies + other
    cc_us = sum(per_sweep.get(k, 0.0) for k in CC_BAND_KERNELS)
    _, words = busy_words(busy, wall * 1e6 / n, sweeps_s)
    line = ("device us per sweep: " + ", ".join(f"{k} {v:.3f}" for k, v in per_sweep.items())
            + f", halo and gather copies {copies:.3f}, other device work {other:.3f}, "
            f"{words}; the profiler saw " + (f"{missed} launches" if missed else "every launch"))
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
            run["finish"] = dict(max_abs_err=0.0, plain_ms=check_finish(
                run["sim"], dev, rng, "unsharded 4096^2", "28 space"))
            run["bonds"] = dict(max_abs_err=0.0, plain_ms=check_bonds(
                run["sim"], dev, rng, "unsharded 4096^2", "28 space"))
            run["sweep_2d"] = dict(zip(("max_abs_err", "plain_ms"), check_sweep_state(
                run["sim"], dev, rng, "unsharded 4096^2", "28 space")))
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
        if name == "fcc32":
            plain[name]["cc"] = check_cc_tiled(plain[name], dev, rng, card)
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
    for k, rec in (("fk_finish", "finish"), ("fk_bonds", "bonds"), ("sweep_2d", "sweep_2d")):
        next(kr for kr in kernels if kr["name"] == k)["at_space4096_unsharded"] = unsharded[rec]
    # the staged path's tiled labelling (the unsharded 32^3 FCC run): the
    # border's record, and the call and its flatten beside the others
    tc = sp["plain"]["fcc32"]["cc"]
    kernels.append(dict(
        name="cc_link_border", route="cuda", source=CC_SRC, replaces=CC_REPLACES,
        launches=tc["launches"]["cc_link_border"], max_abs_err=0.0,
        ms=tc["per_launch_ms"]["cc_link_border"], plain_ms=tc["plain_ms"],
        **tc["bounds"]["cc_link_border"], library_ms=None, run="fcc32 unsharded",
        plain_is="the whole labelling (cc_labels_plain)",
        bound_is="the state bytes and two box roots a bond that leaves its box",
        call=dict(ms=tc["call_ms"], bound_ms=tc["call_bound_ms"], tile=tc["tile"],
                  per_launch_ms=tc["per_launch_ms"], launches=tc["launches"])))
    cc_rec = next(kr for kr in kernels if kr["name"] == "cc_link")
    cc_rec["at_fcc32_unsharded"] = dict(
        launches=tc["launches"]["cc_link"], ms=tc["per_launch_ms"]["cc_link"],
        max_abs_err=0.0, plain_ms=tc["plain_ms"], **tc["bounds"]["cc_link"],
        form="tiled (the link of the boxes)")
    next(kr for kr in kernels if kr["name"] == "fk_link_flatten")["at_fcc32_unsharded_cc"] = dict(
        launches=tc["launches"]["fk_link_flatten"], ms=tc["per_launch_ms"]["fk_link_flatten"],
        max_abs_err=0.0, **tc["bounds"]["fk_link_flatten"],
        form="the staged labelling's last launch")
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


# ------------------------------- 4b / 4c: autocorrelation, checkpoints, physics

AC_KW = dict(autocorrelation_max_lag=1000, equilibration_diagnostic=True)
AC_TOL = 1e-10  # ring against fft
TWIN = dict(shape=(64, 64), n_temps=8, sweeps=512)  # the card against the CPU
TWIN_TOL = 1e-12
AC_CONFIG3_SWEEPS = 1024
PHYSICS_SCRIPTS = ("autocorrelation_scaling", "overlap_histogram")


def full_state(sim) -> dict:
    """The state in the reference's numpy form (spins gathered)."""
    from peapods_tpu_torch.engine import convert

    return convert.to_reference({**sim.state, "spins": sim.all_spins()})


def same_state(a: dict, b: dict) -> list:
    """The keys where two states in numpy form differ."""
    return [k for k in a if not np.array_equal(a[k], b[k])]


def series_gap(a, b) -> float:
    """The largest difference of two results' taus and equil_* values,
    relative to each value's size (at least 1)."""
    gap = 0.0
    for k in ("mags2_tau", "overlap2_tau", "equil_sweeps", "equil_energy_avg",
              "equil_link_overlap_avg"):
        if k not in a:
            continue
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        gap = max(gap, float((np.abs(x - y) / np.maximum(np.abs(y), 1.0)).max()))
    return gap


def fold_chunk_ms(sim, reps=20):
    """Device ms of one ``_fold_series`` of a 256-sweep flagship chunk (the
    ring with lag 1000 and the equilibration sums), without and with an
    equilibration checkpoint in the chunk (CUDA events)."""
    from peapods_tpu_torch.engine import loop
    from peapods_tpu_torch.engine.config import SimConfig

    rt, n = sim.rt, sim.default_chunk
    cfg = SimConfig(n_sweeps=FLAGSHIP_SWEEPS, **AC_KW)
    acc = loop.init_accumulators(rt, cfg)
    g = torch.Generator(device=rt.device).manual_seed(1)
    e = torch.rand((1, n, N_TEMPS), device=rt.device, generator=g) * 2
    m = torch.randint(-L * L, L * L, (1, n, N_TEMPS), device=rt.device,
                      generator=g, dtype=torch.int32)
    out = {}
    for label, s in (("no checkpoint", 1280), ("a checkpoint", 1920)):
        out[label] = gpu_ms(lambda: loop._fold_series(rt, {"warmup": 0}, acc, e, m, None,
                                                      s, n), reps)
    return out


def fold_host_ms(sim):
    """Host ms of the fold a chunk and of building the results (the taus)
    a call, over one flagship call with both options (host clock around
    ``loop._fold_series`` and ``simulation.finalize``)."""
    from peapods_tpu_torch.engine import loop, simulation

    spent = {"fold": [], "results": []}

    def timed(fn, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            spent[key].append(time.perf_counter() - t0)
            return out
        return run

    saved = loop._fold_series, simulation.finalize
    loop._fold_series = timed(saved[0], "fold")
    simulation.finalize = timed(saved[1], "results")
    try:
        sim.sample(FLAGSHIP_SWEEPS, "metropolis", pt_interval=1, warmup_ratio=0.0, **AC_KW)
    finally:
        loop._fold_series, simulation.finalize = saved
    return {k: 1e3 * float(np.mean(v)) for k, v in spent.items()}


def ac_flagship(dev, card):
    """Phase 35a: the flagship at full width with both 4b options on (one
    ``mega_resident`` launch a chunk, the flagship's checksum), the taus and
    ``equil_*`` of the reference's shapes, the rate with the options on and
    off in this run, and the fold's device time a chunk."""
    from peapods_tpu_torch import IsingSimulation
    from peapods_tpu_torch.ops import mega

    temps = np.geomspace(1.8, 3.2, N_TEMPS).astype(np.float32)
    coup = np.ones((L, L, 2), np.float32)
    sim = IsingSimulation([L, L], coup, temps, 1, None, SEED, device=dev)
    mega.reset_launches()
    result = sim.sample(FLAGSHIP_SWEEPS, "metropolis", pt_interval=1, warmup_ratio=0.0,
                        **AC_KW)
    launches = dict(mega.LAUNCHES)
    want = {"colour_pass": 0, "pt_step": 0,
            "mega_resident": -(-FLAGSHIP_SWEEPS // sim.default_chunk)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} with the 4b options, expected {want}")
    check = state_checksum(sim, result)
    if check != FLAGSHIP_CHECKSUM:
        raise AssertionError(f"flagship checksum {check} with the 4b options, expected "
                             f"{FLAGSHIP_CHECKSUM}")
    cks = [128 << k for k in range(32) if 128 << k < FLAGSHIP_SWEEPS] + [FLAGSHIP_SWEEPS]
    shapes = {"mags2_tau": (N_TEMPS,), "equil_sweeps": (len(cks),),
              "equil_energy_avg": (len(cks), N_TEMPS),
              "equil_link_overlap_avg": (len(cks), N_TEMPS)}
    for k, shape in shapes.items():
        x = result[k]
        if x.shape != shape or not np.isfinite(x).all():
            raise AssertionError(f"{k}: shape {x.shape} (want {shape}), finite "
                                 f"{np.isfinite(x).all()}")
    if "overlap2_tau" in result or result["equil_sweeps"].tolist() != cks:
        raise AssertionError(f"keys {sorted(result)}, checkpoints {result['equil_sweeps']}")
    if result["equil_sweeps"].dtype != np.uint64 or result["mags2_tau"].dtype != np.float64:
        raise AssertionError("the 4b keys' dtypes differ from the reference's")
    if (result["equil_link_overlap_avg"] != 0).any():
        raise AssertionError("q_l of a run without replica pairs is not 0")
    on, off = warm_rates(sim, **AC_KW), warm_rates(sim)
    on += warm_rates(sim, **AC_KW)
    off += warm_rates(sim)
    fold = fold_chunk_ms(sim)
    host = fold_host_ms(sim)
    tau = result["mags2_tau"]
    rate_on, rate_off = float(np.median(on)), float(np.median(off))
    log("35 4b flagship", f"{FLAGSHIP_SWEEPS} sweeps with autocorrelation_max_lag=1000 "
        f"(lag {min(1000, FLAGSHIP_SWEEPS // 4)}) and equilibration_diagnostic: launches "
        f"{launches}, checksum {check} == FLAGSHIP_CHECKSUM; mags2_tau[0, -1] = "
        f"{tau[0]:.4f}, {tau[-1]:.4f}; equil_sweeps {cks}; equil_energy_avg[-1, 0] = "
        f"{result['equil_energy_avg'][-1, 0]:.6f} (energies[0] {result['energies'][0]:.6f})")
    log("35 4b flagship", f"sweeps/s with the options {rate_on:.1f} (calls "
        f"{', '.join(f'{r:.1f}' for r in on)}), without {rate_off:.1f} (calls "
        f"{', '.join(f'{r:.1f}' for r in off)}): {rate_on / rate_off:.4f}; the fold's "
        f"device ms a 256-sweep chunk: {fold['no checkpoint']:.5f} (with an equilibration "
        f"checkpoint {fold['a checkpoint']:.5f}); host ms: the fold {host['fold']:.4f} a "
        f"chunk, the results (the taus of lag 1000) {host['results']:.4f} a call, on {card}")
    return dict(rate_on=rate_on, rate_off=rate_off, rates_on=on, rates_off=off,
                fold_ms=fold, host_ms=host, launches=launches, mags2_tau=tau.tolist())


def ac_backends(dev, card):
    """Phase 35b: ring against fft on one seed at config 5's shape (the
    replica path: ``overlap2_tau`` too) and on config 3 (the per-sweep SW
    path); each run's checksum equals the run without the options."""
    from peapods_tpu_torch import Ising

    out = {}
    c5 = SG_CONFIGS["config5"]
    cases = {
        "config5": (lambda: sg_model("config5", dev), dict(c5["kw"]), c5["sweeps"],
                    pair_checksum),
        "config3": (lambda: Ising((L, L), temperatures=np.array([T_C], np.float32), seed=3,
                                  device=dev),
                    dict(cluster_update_interval=1, cluster_mode="sw", warmup_ratio=0.25),
                    AC_CONFIG3_SWEEPS, state_checksum),
    }
    for name, (make, kw, n, checksum) in cases.items():
        runs, checks = {}, {}
        for backend in ("ring", "fft", None):
            model = make()
            opts = {} if backend is None else dict(AC_KW, autocorrelation_backend=backend)
            runs[backend] = model.sample(n, "metropolis", **kw, **opts)
            checks[backend] = checksum(model._sim, runs[backend])
        if len(set(checks.values())) != 1:
            raise AssertionError(f"{name}: checksums {checks} (ring, fft, off)")
        ring, fft = runs["ring"], runs["fft"]
        taus = [k for k in ("mags2_tau", "overlap2_tau") if k in ring]
        if taus != (["mags2_tau", "overlap2_tau"] if name == "config5" else ["mags2_tau"]):
            raise AssertionError(f"{name}: taus {taus}")
        gap = max(float(np.abs(ring[k] - fft[k]).max()) for k in taus)
        eq_same = all(np.array_equal(ring[k], fft[k]) for k in ring if k.startswith("equil"))
        if not gap <= AC_TOL or not eq_same:
            raise AssertionError(f"{name}: ring against fft {gap} (tol {AC_TOL}), equil "
                                 f"equal {eq_same}")
        out[name] = dict(gap=gap, checksum=checks[None],
                         **{k: ring[k].tolist() for k in taus})
        log("35 4b backends", f"{name} ({n} sweeps): ring and fft taus within {gap:.3e} "
            f"(tol {AC_TOL}), equil_* equal; checksum {checks[None]} with either backend "
            f"and without the options; " + ", ".join(
                f"{k}[0, -1] = {ring[k][0]:.4f}, {ring[k][-1]:.4f}" for k in taus))
    return out


def twin_tie(dev, make):
    """After the card's run parted from the CPU's: step fresh simulations on
    both one sweep at a time to the first sweep where they part, and hold
    its colour passes (the CPU's plain passes) to ulp ties.  Raises if a
    spin differs away from a tie; returns ``(sweep, ties)``."""
    from peapods_tpu_torch.engine import convert, loop, seeds
    from peapods_tpu_torch.engine.config import SimConfig
    from peapods_tpu_torch.ops import mega

    cpu = torch.device("cpu")
    on_card, on_cpu = make(dev), make(cpu)
    cfg = SimConfig(n_sweeps=TWIN["sweeps"], pt_interval=1)
    for t in range(TWIN["sweeps"]):
        before = full_state(on_cpu)
        for sim in (on_card, on_cpu):
            loop.run_chunk(sim.rt, cfg, sim.state, loop.init_accumulators(sim.rt, cfg),
                           t, 1)
        a, b = full_state(on_card), full_state(on_cpu)
        if not same_state(a, b):
            continue
        rt = on_cpu.rt
        st = convert.from_reference(before, cpu)
        d = rt.n_disorder
        sid = st["system_ids"].view(d, -1)
        words = torch.from_numpy(seeds.sweep_words(before["base_keys"], t, 1,
                                                   seeds.PH_SWEEP))[0]
        x = dict(rt=rt, sid=sid, grid=st["spins"].view(d, -1, *rt.lattice.shape).clone())
        tie = None
        for colour in (0, 1):
            here = colour_ties(x, words, colour)
            tie = here if tie is None else tie | here
            mega.colour_pass_plain(x["grid"], rt.jgrids, sid, rt.slot_temps, words,
                                   colour, gibbs=False)
        di = torch.arange(d)[:, None]
        card = torch.from_numpy(a["spins"]).view_as(x["grid"])[di, sid.long()]
        diff = card != x["grid"][di, sid.long()]
        if (diff & ~tie).any():
            raise AssertionError(f"the card parts from the CPU at sweep {t}: "
                                 f"{int((diff & ~tie).sum())} spins away from ulp ties")
        ties = int(diff.sum())
        if ties == 0:
            raise AssertionError(f"the card parts from the CPU at sweep {t} in "
                                 f"{same_state(a, b)} without an ulp tie")
        return t, ties
    raise AssertionError("the card's run parts from the CPU's, but no single sweep does")


def ac_twin(dev, card):
    """Phase 35c: a short run with both options on the card and on the CPU
    (the plain torch path), bitwise, its taus and equil_* then within
    TWIN_TOL; when the runs part, the sweep where they part is held to ulp
    ties (not compared past it)."""
    from peapods_tpu_torch import IsingSimulation

    temps = np.geomspace(1.8, 3.2, TWIN["n_temps"]).astype(np.float32)
    coup = np.random.default_rng(35).choice([-1.0, 1.0], (*TWIN["shape"], 2)).astype(
        np.float32)

    def make(x):
        return IsingSimulation(list(TWIN["shape"]), coup, temps, 1, None, SEED, device=x)

    kw = dict(pt_interval=1, warmup_ratio=0.25, **AC_KW)
    res, states, secs = {}, {}, {}
    for where, x in (("card", dev), ("cpu", torch.device("cpu"))):
        sim = make(x)
        t0 = time.perf_counter()
        res[where] = sim.sample(TWIN["sweeps"], "metropolis", **kw)
        secs[where] = time.perf_counter() - t0
        states[where] = full_state(sim)
    bad = same_state(states["card"], states["cpu"])
    if bad:
        t, ties = twin_tie(dev, make)
        log("35 4b twin", f"the card's run parts from the CPU's at sweep {t} on {ties} ulp "
            f"ties (in {bad}); taus not compared past it")
        return dict(bitwise=False, tie_sweep=t, ties=ties)
    gap = series_gap(res["card"], res["cpu"])
    if not gap <= TWIN_TOL:
        raise AssertionError(f"card against CPU: the taus and equil_* differ by {gap}")
    log("35 4b twin", f"{TWIN['shape'][0]}^2 x {TWIN['n_temps']} temperatures, "
        f"{TWIN['sweeps']} sweeps, both options: the card's state bitwise the CPU's (0 ulp "
        f"ties), its taus and equil_* within {gap:.3e} (tol {TWIN_TOL}); {secs['card']:.2f} "
        f"s on the card, {secs['cpu']:.2f} s on the CPU ({card})")
    return dict(bitwise=True, gap=gap, ties=0)


def ac_checkpoints(dev, card, tmp):
    """Phase 35d: the flagship saved after 2048 sweeps, loaded into a fresh
    simulation and run 2048 more, bitwise the uninterrupted 4096-sweep run;
    the card's file loads on the CPU."""
    from peapods_tpu_torch import IsingSimulation

    temps = np.geomspace(1.8, 3.2, N_TEMPS).astype(np.float32)
    coup = np.ones((L, L, 2), np.float32)
    kw = dict(pt_interval=1, warmup_ratio=0.0)

    def make(x=dev):
        return IsingSimulation([L, L], coup, temps, 1, None, SEED, device=x)

    whole = make()
    r = whole.sample(FLAGSHIP_SWEEPS, "metropolis", **kw)
    if state_checksum(whole, r) != FLAGSHIP_CHECKSUM:
        raise AssertionError("the uninterrupted flagship run's checksum")
    half = make()
    half.sample(FLAGSHIP_SWEEPS // 2, "metropolis", **kw)
    path = f"{tmp}/flagship.npz"
    t0 = time.perf_counter()
    half.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    on_cpu = make(torch.device("cpu"))
    on_cpu.load_checkpoint(path)
    bad = same_state(full_state(on_cpu), full_state(half))
    if bad:
        raise AssertionError(f"the card's checkpoint loads on the CPU with {bad} changed")
    resumed = make()
    t0 = time.perf_counter()
    resumed.load_checkpoint(path)
    load_s = time.perf_counter() - t0
    resumed.sample(FLAGSHIP_SWEEPS // 2, "metropolis", **kw)
    bad = same_state(full_state(resumed), full_state(whole))
    if bad:
        raise AssertionError(f"the resumed flagship differs from the uninterrupted run in "
                             f"{bad}")
    import os

    size = os.path.getsize(path)
    log("35 4c checkpoints", f"the flagship saved after {FLAGSHIP_SWEEPS // 2} sweeps "
        f"({size} B, {1e3 * save_s:.1f} ms), loaded into a fresh simulation "
        f"({1e3 * load_s:.1f} ms) and run {FLAGSHIP_SWEEPS // 2} more: bitwise the "
        f"uninterrupted {FLAGSHIP_SWEEPS}-sweep run; the file loads on the CPU bitwise "
        f"({card})")
    return dict(bytes=size, save_ms=1e3 * save_s, load_ms=1e3 * load_s)


def ac_physics(dev, card):
    """Phase 35e: ``tests/autocorrelation_scaling.py`` and
    ``tests/overlap_histogram.py`` with ``quick=True`` through
    ``tools/physics_torch.py`` on the card, each passing its own
    assertions; the tau ratio, the final Delta and the seconds."""
    import contextlib
    import importlib.util
    import io
    from pathlib import Path

    root = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("physics_torch",
                                                  root / "tools" / "physics_torch.py")
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    saved = {k: sys.modules.get(k) for k in ("peapods_tpu", "peapods_tpu.sweep")}
    runner.install(dev.type)
    out = {}
    try:
        for name in PHYSICS_SCRIPTS:
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    secs = runner.run_one(name)
            finally:
                text = buf.getvalue()
                for line in text.splitlines():
                    if line.strip() and not line.startswith("==="):
                        log("35 physics", f"{name}: {line.strip()}")
            found = re.search(r"ratio: ([0-9.]+)" if name == "autocorrelation_scaling"
                              else r"final Delta = (-?[0-9.]+)", text)
            out[name] = dict(seconds=secs, value=float(found.group(1)) if found else None)
            log("35 physics", f"{name} passed its own assertions in {secs:.1f} s: "
                + ("tau(64) / tau(32) = " if name == "autocorrelation_scaling"
                   else "final Delta = ") + f"{out[name]['value']} on {card}")
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return out


def ac_phase(dev, card):
    """Phase 35: 4b, 4c and the physics scripts on the card."""
    import tempfile

    out = {"flagship": ac_flagship(dev, card), "backends": ac_backends(dev, card),
           "twin": ac_twin(dev, card)}
    with tempfile.TemporaryDirectory() as tmp:
        out["checkpoints"] = ac_checkpoints(dev, card, tmp)
    out["physics"] = ac_physics(dev, card)
    return out


# ------------------------------------------------ any lattice (item 4a)


# Phase 36: the lattices that the walk words do not hold or that earlier
# slices refused, at the sizes their users run, each through Ising.sample
# twice from one seed: a 255^2 ferromagnet (an odd linear size of a
# finite-size scaling series) at the flagship's ladder with SW and PT every
# sweep and cluster statistics, and its observe form for the winding flags
# of an odd canonical square; configs 4 and 5 (SG_CONFIGS) at the odd sizes
# 9^3 and 15^3, which leave the replica megakernel for the per-sweep
# replica path; the (4096,) chain with Wolff, whose <e> is the infinite
# chain's tanh(1/T) a bond; the 4D magnet (its upper critical dimension) at
# 16^4 around T_c ~ 6.68 with SW and PT; and 16^3 with the 13 offsets of
# the cubic lattice's first three shells (26 neighbours) with SW and PT.
# Cut in depth only.
SHELLS3 = ([[1, 0, 0], [0, 1, 0], [0, 0, 1]]
           + [[1, s, 0] for s in (1, -1)] + [[1, 0, s] for s in (1, -1)]
           + [[0, 1, s] for s in (1, -1)]
           + [[1, a, b] for a in (1, -1) for b in (1, -1)])
ANY_SW = dict(pt_interval=1, cluster_update_interval=1, cluster_mode="sw")
ANY_RUNS = {
    "sq255": dict(shape=(255, 255), geometry=None, couplings="ferro", t=(1.8, 3.2),
                  n_temps=N_TEMPS, n_replicas=1, n_disorder=1, seed=36, sweeps=256,
                  kw=dict(ANY_SW, collect_cluster_stats=True)),
    "sq255obs": dict(shape=(255, 255), geometry=None, couplings="ferro", t=(1.8, 3.2),
                     n_temps=8, n_replicas=1, n_disorder=1, seed=36, sweeps=64,
                     kw=dict(ANY_SW, cluster_action="observe")),
    "chain4096": dict(shape=(4096,), geometry=None, couplings="ferro", t=(0.5, 4.0),
                      n_temps=8, n_replicas=1, n_disorder=1, seed=37, sweeps=512,
                      kw=dict(pt_interval=1, cluster_update_interval=1,
                              cluster_mode="wolff")),
    "4d16": dict(shape=(16, 16, 16, 16), geometry=None, couplings="ferro", t=(6.0, 7.4),
                 n_temps=16, n_replicas=1, n_disorder=1, seed=38, sweeps=128, kw=ANY_SW),
    "shells16": dict(shape=(16, 16, 16), geometry=SHELLS3, couplings="ferro",
                     t=(18.0, 26.0), n_temps=8, n_replicas=1, n_disorder=1, seed=39,
                     sweeps=128, kw=ANY_SW),
}
ANY_REPLICA_RUNS = {
    "config4-9": dict(SG_CONFIGS["config4"], shape=(9, 9, 9), geometry=None,
                      n_temps=SG_T, n_replicas=SG_R, n_disorder=SG_D, sweeps=512),
    "config5-15": dict(SG_CONFIGS["config5"], shape=(15, 15, 15), geometry=None,
                       n_temps=SG_T, n_replicas=SG_R, n_disorder=SG_D, sweeps=256),
}
# the chain's <e> against tanh(1/T): batches of this many sweeps
CHAIN_BATCHES, CHAIN_BATCH_SWEEPS = 8, 256
CHAIN_SE = 5.0
TABLE_KERNELS = ("sweep_nb_table", "measure_nb_table", "fk_bonds_table", "cc_table_link")
TABLE_REPLACES = {
    "sweep_nb_table": "peapods_tpu/ops/pallas_sweep_diag.py:540",  # sweep_gen
    "measure_nb_table": "peapods_tpu/ops/pallas_sweep_diag.py:562",  # sweep_gen_fused
    "fk_bonds_table": "peapods_tpu/ops/pallas_event.py:621",  # _fk_kernel (row 18)
    "cc_table_link": CC_REPLACES, "cc_table_border": CC_REPLACES}
TABLE_SRC = {"sweep_nb_table": NB_SRC, "measure_nb_table": NB_SRC,
             "fk_bonds_table": "peapods_tpu_torch/csrc/fk.cu", "cc_table_link": CC_SRC,
             "cc_table_border": CC_SRC}
# the table labelling's slab route: graphs past one cluster's shared memory
# (32^4 sites, 4 offsets), few of them, random bonds above percolation
SLAB_ROUTE = dict(shape=(32, 32, 32, 32), graphs=2, p=0.3)


def any_model(c, dev, **over):
    from peapods_tpu_torch import Ising

    c = dict(c, **over)
    geo = c["geometry"]
    kw = (dict(geometry=geo) if isinstance(geo, str)
          else dict(neighbor_offsets=geo) if geo is not None else {})
    return Ising(c["shape"], couplings=c["couplings"],
                 temperatures=np.geomspace(*c["t"], c["n_temps"]),
                 n_replicas=c["n_replicas"], n_disorder=c["n_disorder"], seed=c["seed"],
                 device=dev, **kw)


def any_want(model, kw, n, warmup):
    """Launches of ``n`` sweeps from sweep 0 of a one-replica run: a sweep
    launch per colour (the table form's past three dimensions or six
    offsets); on FK sweeps the staged path: the bonds, the labelling
    (``cc.link_launches`` of the kernel shape, ``cc.table_link_launches``
    of the table form's) and, to update,
    ``fk_finish``; observe runs skip the sweeps that record nothing; a
    measurement and a ``pt_step`` a sweep."""
    from peapods_tpu_torch.ops import cc

    rt = model._sim.rt
    lat = rt.lattice
    tab = lat.table
    fk_t = [s for s in range(0, n, kw["cluster_update_interval"])
            if not (kw.get("cluster_action") == "observe" and s < warmup)]
    want = {"sweep_nb_table" if tab else "sweep_nb": lat.n_colors * n,
            "measure_nb_table" if tab else "measure_nb": n, "pt_step": n,
            "fk_bonds_table" if tab else "fk_bonds_staged": len(fk_t)}
    if kw.get("cluster_action", "update") == "update":
        want["fk_finish"] = len(fk_t)
    graphs = rt.n_disorder * rt.n_systems
    links = (cc.table_link_launches(lat.n_spins, lat.n_neighbors, graphs) if tab
             else cc.link_launches(lat.kernel_shape, graphs))
    for k, v in links.items():
        want[k] = want.get(k, 0) + v * len(fk_t)
    if kw.get("cluster_action") == "observe" and lat.canonical_square:
        from peapods_tpu_torch.ops import winding

        for k, v in winding.winding_launches(lat.shape, rt.n_disorder * rt.n_systems).items():
            want[k] = want.get(k, 0) + v * len(fk_t)
    return {k: v for k, v in want.items() if v}


def any_checksum(sim, result) -> str:
    """:func:`state_checksum`, the FK histograms and observations."""
    h = hashlib.sha256(state_checksum(sim, result).encode())
    for x in result.get("fk_csd", []):
        h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    obs = result.get("per_disorder", {}).get("cluster_observations", {})
    for name in sorted(obs):
        for key in sorted(obs[name]):
            h.update(np.ascontiguousarray(obs[name][key]).tobytes())
    return h.hexdigest()[:16]


def any_cpu(name, c, dev, replicas=False):
    """A small run of the configuration (one realization, the ladder's two
    ends, 8 sweeps, +-J couplings where the run's are gaussian) on the card
    and on the CPU's plain path: states bitwise, records to rtol 1e-12,
    statistics and observations equal."""
    runs = []
    over = dict(n_disorder=1, n_temps=2,
                couplings="bimodal" if c["couplings"] == "gaussian" else c["couplings"])
    for device in (dev, "cpu"):
        m = any_model(c, device, **over)
        runs.append((m, m.sample(8, "metropolis", **c["kw"])))
    (mk, rk), (mp, rp) = runs
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips"):
        if not torch.equal(mk._sim.state[key].cpu(), mp._sim.state[key]):
            raise AssertionError(f"{name}: {key} differs from the CPU's")
    keys = ["energies", "energies2", "mags", "mags2"] + (
        ["overlap2", "link_overlap"] if replicas else [])
    for key in keys:
        np.testing.assert_allclose(rk[key], rp[key], rtol=1e-12, err_msg=f"{name} {key}")
    for key in ("fk_csd", "overlap_csd", "top_cluster_sizes"):
        for u, v in zip(rk.get(key, []), rp.get(key, [])):
            if not np.array_equal(np.asarray(u), np.asarray(v)):
                raise AssertionError(f"{name}: {key} differs from the CPU's")
    ok = {}
    obs_k = rk.get("per_disorder", {}).get("cluster_observations", {})
    obs_p = rp.get("per_disorder", {}).get("cluster_observations", {})
    for kind in obs_p:
        for key in obs_p[kind]:
            ok[key] = np.array_equal(obs_k[kind][key], obs_p[kind][key])
    if not all(ok.values()):
        raise AssertionError(f"{name}: observations differ from the CPU's: {ok}")
    return ("8 sweeps of one realization at the ladder's ends on the card bitwise the "
            "CPU's plain path (spins, sid, PT counts, statistics, observations; records "
            "to rtol 1e-12)")


def any_sanity(name, c, model, r):
    """Finite records, <e> falling with T; the chain's <e> within CHAIN_SE
    standard errors of tanh(1/T) (batch means of further calls); the
    observe run's observations (:func:`check_observations`) with the
    winding flags spanning at the coldest and not at the hottest T."""
    e = r["energies"]
    sane = {"finite": bool(np.isfinite(e).all() and np.isfinite(r["mags2"]).all()),
            "<e> falls with T": bool(e[0] > e[-1])}
    extra = ""
    if name == "chain4096":
        t = np.geomspace(*c["t"], c["n_temps"])
        mean, se = batch_means(model, c["kw"], CHAIN_BATCHES, CHAIN_BATCH_SWEEPS)
        z = (mean - np.tanh(1.0 / t)) / se
        sane[f"<e> within {CHAIN_SE} s.e. of tanh(1/T)"] = bool((np.abs(z) < CHAIN_SE).all())
        extra = ("; <e> - tanh(1/T) in standard errors " + ", ".join(f"{x:.2f}" for x in z)
                 + f" (<e> {', '.join(f'{x:.5f}' for x in mean)})")
    if c["kw"].get("cluster_action") == "observe":
        warmup = int(np.floor(c["sweeps"] * 0.25 + 0.5))
        fk = check_observations(r, model._sim, c["sweeps"] - warmup, True)
        wx = fk["winding_either"].mean(0)
        sane["winding at the coldest T, none at the hottest"] = bool(
            wx[0] > 0.9 and wx[-1] < 0.1)
        extra += "; winding_either by T " + ", ".join(f"{x:.3f}" for x in wx)
    if not all(sane.values()):
        raise AssertionError(f"{name} sanity: {sane}{extra}")
    return sane, extra


def any_run(name, c, dev, card):
    """A one-replica run twice from one seed through Ising.sample: launch
    counts of the first against :func:`any_want`, two equal checksums,
    :func:`any_sanity`, the rate of warm calls."""
    n, kw = c["sweeps"], c["kw"]
    warmup = int(np.floor(n * 0.25 + 0.5))
    models, results, checks = [], [], []
    for run in range(2):
        model = any_model(c, dev)
        torch.cuda.synchronize()
        reset_cluster_counts()
        result = model.sample(n, "metropolis", **kw)
        torch.cuda.synchronize()
        if run == 0:
            launches = cluster_counts()
        models.append(model)
        results.append(result)
        checks.append(any_checksum(model._sim, result))
    want = any_want(models[0], kw, n, warmup)
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches}, expected {want}")
    if checks[0] != checks[1]:
        raise AssertionError(f"{name} checksums differ: {checks}")
    sane, extra = any_sanity(name, c, models[0], results[0])
    lat = models[0]._sim.rt.lattice
    sweeps_s, rates = warm_rate(models[1], n, kw, calls=3)
    log("36 lattices", f"{name}: {'x'.join(map(str, lat.shape))}, {lat.n_neighbors} "
        f"offsets, {lat.n_colors} colours, {'table' if lat.table else 'walk'} form, "
        f"{c['n_temps']} temps, {kw}, {n} sweeps on {dev}: launches {launches}; checksum "
        f"{checks[0]} == {checks[1]}; sanity ok: {', '.join(sane)}{extra}; <e>[0,-1] "
        f"{results[0]['energies'][0]:.5f}, {results[0]['energies'][-1]:.5f}; "
        f"{sweeps_s:.1f} sweeps/s (median of {', '.join(f'{x:.1f}' for x in rates)}) "
        f"on {card}")
    return dict(model=models[1], result=results[0], launches=launches, sweeps_s=sweeps_s,
                checksum=checks[0], kw=kw, n=n)


def any_bounds(rt, n_fk_graphs):
    """Each form's bound on a run's shapes (bytes: each input read once,
    each output written once; operations: f32 adds and multiplies of the
    field or the energy, the bonds' Philox rounds left out): a colour
    pass reads every spin, its colour's sites' forward and backward
    couplings (and in the table form their rows of the two int32 tables)
    and the colour table, and writes its colour's spins (phase 17's
    yardstick for ``sweep_nb``); the measurement reads every spin, the
    couplings (and the forward table) and writes the partials; the bonds
    read every spin, the couplings (and the table) and write a state word a
    site; the table labelling reads the state words and the table and
    writes the labels."""
    d, s = rt.n_disorder, rt.n_systems
    lat = rt.lattice
    n, nb = lat.n_spins, lat.n_neighbors
    nc = lat.n_colors
    tab = 8 * n * nb if lat.table else 0
    b = n_fk_graphs
    blocks = -(-n // 1024)
    out = {
        "sweep": bound(d * s * n + 8 * d * nb * n // nc + tab // nc + n + d * s * n // nc,
                       4 * nb * d * s * n // nc),
        "measure": bound(d * s * n + 4 * d * n * nb + tab // 2 + 8 * d * s * blocks,
                         2 * nb * d * s * n),
        "bonds": bound(b * n + 4 * d * n * nb + tab // 2 + (4 if lat.table else 1) * b * n,
                       3 * nb * b * n),
    }
    if lat.table:
        out["cc_table_link"] = bound(8 * b * n + tab // 2, 0)
    else:
        out["cc_link"] = cc_bound(b, n)
    return out


def any_checks(name, run, dev, rng, card, phase="36 kernel-vs-plain"):
    """On a run's final state: a sweep (every colour) and the measurement
    through the lattice's form bitwise the plain versions (spins, every
    partial), the staged FK bonds' state bitwise ``fk_bonds_plain``'s bits
    and the labelling bitwise ``connected_components``' labels; each plain
    version's time and each form's bound."""
    from peapods_tpu_torch.ops import _build, cc, energy, fk, sweep
    from peapods_tpu_torch.ops.cluster import connected_components

    sim = run["model"]._sim
    rt = sim.rt
    lat = rt.lattice
    spins = sim.state["spins"]
    d, s, n = spins.shape
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)).to(dev)
    from peapods_tpu_torch.ops.measure import slot_temps_for_systems

    temps = slot_temps_for_systems(sim.state["system_ids"].view(d, s), rt.slot_temps)
    gibbs = False
    args = (rt.coup, rt.coup_bwd, rt.colours, temps, words, lat)
    a, b = spins.clone(), spins.clone()
    sweep.sweep_nb(a, *args, gibbs=gibbs, tables=rt.tables)
    sweep.sweep_nb_plain(b, *args, gibbs=gibbs)
    ek, mk = energy.measure_nb(a, rt.coup, lat, tables=rt.tables)
    ep, mp = energy.measure_nb_plain(b, rt.coup, lat, blocks=True)
    torch.cuda.synchronize()
    bad = {"sweep spins": int((a != b).sum()),
           "measure partials": int((ek.view(torch.int32) != ep.view(torch.int32)).sum()
                                   + (mk != mp).sum())}
    flipped = int((a != spins).sum())
    plain = {"sweep": wall_ms(lambda: sweep.sweep_nb_plain(spins.clone(), *args,
                                                           gibbs=gibbs), 2),
             "measure": wall_ms(lambda: energy.measure_nb_plain(spins, rt.coup, lat,
                                                                blocks=True), 2)}
    g = d * s
    graphs = spins.view(g, *lat.shape)
    kb = torch.from_numpy(rng.integers(-2**31, 2**31, (g, 2)).astype(np.int32)).to(dev)
    gt = temps.reshape(-1).contiguous()
    lib, stream = _build.library(), torch.cuda.current_stream(dev).cuda_stream
    state = torch.empty((g, n), dtype=torch.int32 if lat.table else torch.uint8,
                        device=dev)
    fk.launch_staged_bonds(lib, stream, graphs, rt.coup, gt, kb, state, lat, rt.tables)
    labels = torch.empty((g, n), dtype=torch.int32, device=dev)
    cc.launch(lib, stream, state.data_ptr(), labels.data_ptr(), lat, g, rt.tables)
    bonds = fk.fk_bonds_plain(graphs, rt.coup, gt, kb, offsets=lat.offsets)
    want_lab = connected_components(bonds, lat.shape, lat.offsets)
    torch.cuda.synchronize()
    bad["bonds state"] = int((state.to(torch.int64) != cc.pack_masks(
        bonds, state.dtype).to(torch.int64)).sum())
    bad["labels"] = int((labels != want_lab).sum())
    if any(bad.values()) or not flipped or not bonds.any():
        raise AssertionError(f"{name}: mismatches {bad}, {flipped} spins flipped")
    plain["bonds"] = wall_ms(lambda: fk.fk_bonds_plain(graphs, rt.coup, gt, kb,
                                                       offsets=lat.offsets), 2)
    plain["labelling"] = wall_ms(lambda: connected_components(bonds, lat.shape,
                                                              lat.offsets), 2)
    form = "walk form"
    if lat.table:
        plan = fk.table_bonds_plan(n, lat.n_neighbors, d, s, fk.resident_threads(dev.index) // 8,
                                   torch.cuda.get_device_properties(dev).multi_processor_count)
        form = (f"table form; fk_bonds_table {plan.per} graphs a thread"
                + (f", {plan.split} warps a group" if plan.split > 1 else "")
                + f", {plan.grid[0] * plan.grid[1] * plan.grid[2]} CTAs")
    log(phase, f"{name} on the run's state ({g} systems of "
        f"{'x'.join(map(str, lat.shape))}, {lat.n_neighbors} offsets, "
        f"{form}): a sweep ({flipped} spins flipped), "
        f"the measurement's partials, the staged bonds' state and the labelling bitwise "
        f"the plain versions: mismatches {bad}; plain sweep {plain['sweep']:.3f}, "
        f"measurement {plain['measure']:.3f}, bonds {plain['bonds']:.3f}, labelling "
        f"{plain['labelling']:.3f} ms on {card} ok")
    bounds = any_bounds(rt, g)
    names = (("sweep_nb_table", "sweep"), ("measure_nb_table", "measure"),
             ("fk_bonds_table", "bonds"), ("cc_table_link", "cc_table_link")
             ) if lat.table else (
             ("sweep_nb", "sweep"), ("measure_nb", "measure"), ("fk_bonds_staged", "bonds"),
             ("cc_link", "cc_link"))
    out = {}
    for k, part in names:
        b_ms, b_by = bounds[part]
        pk = {"sweep": "sweep", "measure": "measure", "bonds": "bonds"}.get(part,
                                                                           "labelling")
        out[k] = dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, plain_ms=plain[pk],
                      plain_is=f"the plain {pk} on the run's state")
    return out


def any_slab_route(dev, card):
    """The table labelling past one cluster's shared memory (SLAB_ROUTE):
    one labelling's launches counted from 0 (``cc_table_link``,
    ``cc_table_border``, ``fk_link_flatten``), the labels bitwise
    ``connected_components``', each launch's device time (profiler) beside
    its bound (bytes: the state words, the forward table once, the labels
    or parents; the border also reads the parents, the flatten reads and
    writes them) and the plain labelling's time."""
    from peapods_tpu_torch.ops import cc, fk
    from peapods_tpu_torch.ops.cluster import connected_components
    from peapods_tpu_torch.ops.lattice import Lattice

    c = SLAB_ROUTE
    lat = Lattice(c["shape"])
    b, n, nb = c["graphs"], lat.n_spins, lat.n_neighbors
    plan = cc.table_link_plan(n, nb, b)
    gen = torch.Generator(device=dev).manual_seed(2036)
    masks = torch.rand((b, n, nb), device=dev, generator=gen) < c["p"]
    tables = lat.device_tables(dev)
    for table in (cc.LAUNCHES, fk.LAUNCHES):
        for k in table:
            table[k] = 0
    labels = cc.cc_labels(masks, lat, tables=tables)
    torch.cuda.synchronize()
    launches = {k: v for table in (cc.LAUNCHES, fk.LAUNCHES) for k, v in table.items() if v}
    want = cc.table_link_launches(n, nb, b)
    if launches != want or not plan.slabs:
        raise AssertionError(f"slab route: launches {launches}, expected {want}")
    plain = connected_components(masks, lat.shape, lat.offsets)
    bad = int((labels != plain).sum())
    n_comp = int((plain == torch.arange(n, device=dev)).sum())
    if bad:
        raise AssertionError(f"slab route: {bad} labels differ from connected_components'")
    ms = kernel_ms(lambda: cc.cc_labels(masks, lat, tables=tables), 5, tuple(want))
    plain_ms = wall_ms(lambda: connected_components(masks, lat.shape, lat.offsets), 1)
    tab = 4 * n * nb
    bounds = {"cc_table_link": bound(8 * b * n + tab, 0),
              "cc_table_border": bound(8 * b * n + tab, 0),
              "fk_link_flatten": bound(8 * b * n, 0)}
    recs = {k: dict(launches=v, ms=ms[k], max_abs_err=0.0, plain_ms=plain_ms,
                    plain_is="connected_components of the graphs", **dict(zip(
                        ("bound_ms", "bound_by"), bounds[k])))
            for k, v in launches.items()}
    log("36 slab route", f"{b} graphs of {'x'.join(map(str, c['shape']))} ({n} sites, {nb} "
        f"offsets, bond density {c['p']}, {n_comp} clusters): slabs of {plan.slab} sites, "
        f"{plan.threads} threads; launches {launches}; labels bitwise connected_components'"
        f"; " + "; ".join(f"{k} {r['ms']:.5f} ms (bound {r['bound_ms']:.6f} ms)"
                          for k, r in recs.items())
        + f"; plain {plain_ms:.3f} ms on {card} ok")
    return recs


def any_phase(dev, card):
    """Phase 36: each run of ANY_RUNS twice from one seed (launches,
    checksums, sanity), a small run on the card against the CPU, each form's
    kernels on the run's state against their plain versions, and a profiled
    main-path window (device us a sweep by kernel, busy share, each new
    form's time beside its bound); the replica runs through phase 34's
    functions (the moves' kernels on the run's state too); the table
    labelling's slab route (:func:`any_slab_route`)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(2036)
    runs = {}
    for name, c in ANY_RUNS.items():
        run = runs[name] = any_run(name, c, dev, card)
        log("36 lattices", f"{name}: " + any_cpu(name, c, dev) + " ok")
        run["checks"] = any_checks(name, run, dev, rng, card)
    for name, c in ANY_REPLICA_RUNS.items():
        run = runs[name] = ov_lattice_run(name, c, dev, card, phase="36 lattices")
        log("36 lattices", f"{name}: " + any_cpu(name, c, dev, replicas=True) + " ok")
        run["checks"] = ov_lattice_checks(name, run, dev, rng, card,
                                          phase="36 kernel-vs-plain")
        for k, rec in any_checks(name, run, dev, rng, card).items():
            run["checks"].setdefault(k, rec)
    for name, run in runs.items():
        us, line = profile_window(run["model"], run["kw"], run["sweeps_s"],
                                  min(run["n"], 64), names=tuple(run["launches"]))
        run["us"] = us
        log("36 times", f"{name} {line} (on {card})")
        for k, rec in run["checks"].items():
            if k in us:
                rec.update(ms=us[k] / 1e3, launches=run["launches"].get(k, 0))
        log("36 times", f"{name} per launch: " + "; ".join(
            f"{k} {rec['ms']:.5f} ms (bound {rec['bound_ms']:.6f} ms by "
            f"{rec['bound_by']}, plain {rec['plain_ms']:.3f} ms)"
            for k, rec in run["checks"].items() if "ms" in rec) + f" on {card}")
    runs["slab_route"] = any_slab_route(dev, card)
    log("36 times", f"phase 36 took {time.perf_counter() - t0:.1f} s")
    return runs


def add_any_records(kernels, runs):
    """Phase 36's numbers: the table forms' records (the 4D run's main
    path, the 13-offset run's beside it), and the walk forms' numbers on
    the other runs beside their records (``at_<run>``); the slab route's
    ``cc_table_border`` a record of its own (its route's launches), its
    ``cc_table_link`` and ``fk_link_flatten`` beside theirs."""
    slab = runs.pop("slab_route")
    main = runs["4d16"]
    for k in TABLE_KERNELS:
        kr = dict(main["checks"][k], name=k, route="cuda", source=TABLE_SRC[k],
                  replaces=TABLE_REPLACES[k], launches=main["launches"].get(k, 0),
                  library_ms=None, at_shells16=runs["shells16"]["checks"][k])
        kernels.append(kr)
    by_name = {kr["name"]: kr for kr in kernels}
    kernels.append(dict(slab.pop("cc_table_border"), name="cc_table_border", route="cuda",
                        source=CC_SRC, replaces=TABLE_REPLACES["cc_table_border"],
                        library_ms=None, route_of=f"the slab route, {SLAB_ROUTE}"))
    for k, rec in slab.items():
        by_name[k]["at_slab_route"] = rec
    for name, run in runs.items():
        for k, rec in run["checks"].items():
            if k in by_name and "ms" in rec and k not in TABLE_KERNELS:
                by_name[k][f"at_{name}"] = rec


# ------------------------------------------------ replicas on the table lattices


# Phase 38: replicas, pair overlaps and the overlap moves on the lattices of
# the kernels' table form (four dimensions or more, or 7 to 32 offsets).
# 38a, the 4D +-J Edwards-Anderson glass at full width: the study of
# examples/sweep_config.toml (+-J, full-ladder PT, houdayer+cmr SW moves
# every sweep, SW every 2 sweeps with cluster statistics) carried to four
# dimensions, 10^4 sites x 12 temperatures across T_c ~ 2.0 x 2 replicas x
# 16 realizations (3.84 M spins), cut in depth only.  38b: Joerg and
# Houdayer(4) (R = 4, Wolff) at that shape, and a 3D +-J glass with nearest
# and next-nearest neighbours (16^3, the 9 forward offsets of the axes and
# the face diagonals, R = 2, CMR SW with statistics, its ladder scaled by
# sqrt(z / 6) from config 4's), cut in depth.  Each twice from one seed.
EA_KW = dict(pt_interval=1, pt_schedule="full_ladder", overlap_cluster_update_interval=1,
                overlap_cluster_build_mode="houdayer+cmr", overlap_cluster_mode="sw",
                cluster_update_interval=2, cluster_mode="sw", collect_cluster_stats=True)
EA_WOLFF_KW = dict(pt_interval=1, pt_schedule="full_ladder",
                   overlap_cluster_update_interval=1, overlap_cluster_mode="wolff",
                   collect_cluster_stats=True)
NINE_OFFSETS = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, -1, 0], [1, 0, 1],
                [1, 0, -1], [0, 1, 1], [0, 1, -1]]
EA_RUNS = {
    "glass4d": dict(shape=(10, 10, 10, 10), offsets=None,
                    temps=np.linspace(1.6, 2.4, 12), n_replicas=2, n_disorder=16, seed=38,
                    sweeps=1024, kw=EA_KW),
    "glass4d-jorg": dict(shape=(10, 10, 10, 10), offsets=None,
                         temps=np.linspace(1.6, 2.4, 12), n_replicas=2, n_disorder=16,
                         seed=39, sweeps=128,
                         kw=dict(EA_WOLFF_KW, overlap_cluster_build_mode="jorg")),
    "glass4d-houd4": dict(shape=(10, 10, 10, 10), offsets=None,
                          temps=np.linspace(1.6, 2.4, 12), n_replicas=4, n_disorder=16,
                          seed=40, sweeps=128,
                          kw=dict(EA_WOLFF_KW, overlap_cluster_build_mode="houd4")),
    "nine16": dict(shape=(16, 16, 16), offsets=NINE_OFFSETS,
                   temps=np.geomspace(0.9 * math.sqrt(3), 2.2 * math.sqrt(3), 12),
                   n_replicas=2, n_disorder=8, seed=41, sweeps=128,
                   kw=dict(pt_interval=1, pt_schedule="full_ladder",
                           overlap_cluster_update_interval=1,
                           overlap_cluster_build_mode="cmr", overlap_cluster_mode="sw",
                           collect_cluster_stats=True)),
}
# 38c's further states: 5D and an odd extent (random spins, R = 4, 3
# temperatures, 2 realizations), and the 4^4 glass on the card against the CPU
EA_STATES = {"5d6": (6, 6, 6, 6, 6), "odd9": (9, 9, 9, 9)}
EA_TWIN = dict(shape=(4, 4, 4, 4), n_replicas=2, n_disorder=2, sweeps=64)
# the sweeps of a warm call of the rate and of the profiled window: one
# length, since sample() copies its result histograms to the host once a
# call (46 MB at the 4D glass), which a shorter window would charge to
# fewer sweeps than the rate does
EA_RATE_SWEEPS = 128
# P(q > 0) - P(q < 0) at the hottest temperature, in standard errors over
# the realizations
PQ_SYM_SE = 4.0
EA_KERNELS = ("pair_overlap_table", "ov_bonds_table", "ov_mid_table", "ov_finish_table",
                 "houdn_bonds_table", "houdn_finish_table")
WALK_MOVE_KERNELS = ("ov_bonds", "ov_mid", "ov_finish", "houdn_bonds", "houdn_finish",
                     "pair_overlap", "energy_partials", "colour_pass", "mega_resident")
EA_SRC = {k: "peapods_tpu_torch/csrc/overlap.cu" for k in EA_KERNELS}
EA_SRC["pair_overlap_table"] = "peapods_tpu_torch/csrc/pairs.cu"


def ea_replaces(k):
    return (PAIR_REPLACES if k.startswith("pair") else HOUDN_REPLACES if k.startswith("houdn")
            else EV_REPLACES)


def ea_model(c, dev, **over):
    from peapods_tpu_torch import Ising

    c = dict(c, **over)
    geo = {} if c["offsets"] is None else dict(neighbor_offsets=c["offsets"])
    return Ising(c["shape"], couplings="bimodal", temperatures=c["temps"],
                 n_replicas=c["n_replicas"], n_disorder=c["n_disorder"], seed=c["seed"],
                 device=dev, **geo)


def ea_counts():
    """Every launch count since the last reset, by kernel (the mega path's
    too), the kernels that ran."""
    from peapods_tpu_torch.ops import mega, megapair, overlap

    return {**cluster_counts(), **{k: v for k, v in {**mega.LAUNCHES, **megapair.LAUNCHES,
                                                     **overlap.LAUNCHES}.items() if v}}


def ea_moves(kw, n):
    """The move kind and group size of each sweep of ``n`` from sweep 0."""
    modes = kw["overlap_cluster_build_mode"].split("+")
    out = []
    for s in range(0, n, kw["overlap_cluster_update_interval"]):
        m = modes[(s // kw["overlap_cluster_update_interval"]) % len(modes)]
        out.append(("houdayer", int(m[4:])) if m.startswith("houd") and m != "houdayer"
                   else (m, 2))
    return out


def ea_want(model, kw, n):
    """Launches of ``n`` sweeps from sweep 0 of a replica run on a table
    lattice: a ``sweep_nb_table`` a colour, ``measure_nb_table``,
    ``pair_overlap_table`` and ``pt_step`` a sweep; on FK sweeps the staged
    table path (``fk_bonds_table``, the table labelling, ``fk_finish``); per
    update move its table forms (Houdayer ``houdn_bonds_table``, a
    labelling, ``houdn_finish_table``; Joerg ``ov_bonds_table``, a
    labelling, ``ov_finish_table``; CMR ``ov_bonds_table``, two labellings,
    ``ov_mid_table``, ``ov_finish_table``), ``measure_nb_table`` again for
    the energies of PT and a second ``pt_step``; a labelling is
    ``cc.table_link_launches``' (one ``cc_table_link`` at these shapes)."""
    from peapods_tpu_torch.ops import cc

    lat = model._sim.rt.lattice
    want = {"sweep_nb_table": lat.n_colors * n, "measure_nb_table": n,
            "pair_overlap_table": n, "pt_step": n}
    links = 0
    if "cluster_update_interval" in kw:
        n_fk = len(range(0, n, kw["cluster_update_interval"]))
        want.update(fk_bonds_table=n_fk, fk_finish=n_fk)
        links += n_fk
    for kind, _ in ea_moves(kw, n):
        first, last = (("houdn_bonds_table", "houdn_finish_table") if kind == "houdayer"
                       else ("ov_bonds_table", "ov_finish_table"))
        for k in (first, last, "measure_nb_table", "pt_step"):
            want[k] = want.get(k, 0) + 1
        links += 2 if kind == "cmr" else 1
        if kind == "cmr":
            want["ov_mid_table"] = want.get("ov_mid_table", 0) + 1
    for k, v in cc.table_link_launches(lat.n_spins, lat.n_neighbors, 1).items():
        if links:
            want[k] = v * links
    return want


def ea_sanity(name, c, model, r, n):
    """Finite records, <e> falling with T, q^2 in [0, 1]; every cluster-size
    histogram sums (size x count) to n_spins x its graphs; on 38a the
    hottest temperature's P(q) symmetric within PQ_SYM_SE standard errors
    over the realizations."""
    rt = model._sim.rt
    e, q2 = r["energies"], r["overlap2"]
    sane = {"finite": bool(np.isfinite(e).all() and np.isfinite(q2).all()),
            "<e> falls with T": bool(e[0] > e[-1]),
            "q^2 in [0, 1]": bool(((q2 >= 0) & (q2 <= 1)).all())}
    warmup = int(np.floor(n * 0.25 + 0.5))
    kw = c["kw"]
    modes = kw["overlap_cluster_build_mode"].split("+")
    graphs = {m: 0 for m in range(len(modes))}
    for s, (_, g) in enumerate(ea_moves(kw, n)):
        if s >= warmup:
            graphs[s % len(modes)] += rt.n_disorder * (rt.n_replicas // g)
    sums = []
    for m, per_t in enumerate(r["overlap_csd"]):
        for h in per_t:
            h = np.asarray(h, np.float64)
            sums.append(float((np.arange(len(h)) * h).sum()) == rt.n_spins * graphs[m])
    sane["sum s csd[s] = n_spins x graphs (each move kind)"] = all(sums) and bool(sums)
    if "fk_csd" in r:
        n_fk = len([s for s in range(warmup, n) if s % kw["cluster_update_interval"] == 0])
        sane["sum s fk_csd[s] = n_spins x graphs"] = all(
            float((np.arange(len(h)) * np.asarray(h, np.float64)).sum())
            == rt.n_spins * n_fk * rt.n_disorder * rt.n_replicas for h in r["fk_csd"])
    extra = ""
    if name == "glass4d":
        hist = np.asarray(r["per_sample_overlap_histogram"], np.float64)[:, -1]
        mid = (hist.shape[-1] - 1) // 2
        asym = (hist[:, mid + 1:].sum(-1) - hist[:, :mid].sum(-1)) / hist.sum(-1)
        se = asym.std(ddof=1) / np.sqrt(len(asym))
        z = asym.mean() / se
        sane[f"P(q) symmetric at the hottest T within {PQ_SYM_SE} s.e."] = bool(
            abs(z) < PQ_SYM_SE)
        extra = (f"; at T = {c['temps'][-1]:.3f} P(q > 0) - P(q < 0) = {asym.mean():.5f} "
                 f"+- {se:.5f} over {len(asym)} realizations ({z:.2f} s.e.)")
    if not all(sane.values()):
        raise AssertionError(f"{name} sanity: {sane}{extra}")
    return sane, extra


def ea_run(name, c, dev, card):
    """A run twice from one seed through Ising.sample: launch counts of the
    first against :func:`ea_want` (every table form of its moves and
    ``pair_overlap_table`` launched, no walk-form move or pair kernel and
    no mega-path kernel), two equal checksums (spins, sid, records, pair
    records, the histograms, ``fk_csd``), :func:`ea_sanity`, the rate of
    warm calls."""
    from peapods_tpu_torch.ops import mega, megapair, overlap

    n, kw = c["sweeps"], c["kw"]
    models, results, checks = [], [], []
    for run in range(2):
        model = ea_model(c, dev)
        torch.cuda.synchronize()
        for table in (mega.LAUNCHES, megapair.LAUNCHES, overlap.LAUNCHES):
            for k in table:
                table[k] = 0
        reset_cluster_counts()
        t0 = time.perf_counter()
        result = model.sample(n, "metropolis", **kw)
        torch.cuda.synchronize()
        if run == 0:
            launches = ea_counts()
            first_s = time.perf_counter() - t0
        models.append(model)
        results.append(result)
        checks.append(replica_sweep_checksum(model._sim, result))
    want = ea_want(models[0], kw, n)
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches}, expected {want}")
    walk = {k: launches[k] for k in WALK_MOVE_KERNELS if k in launches}
    if walk:
        raise AssertionError(f"{name} launched walk-form or mega-path kernels: {walk}")
    if checks[0] != checks[1]:
        raise AssertionError(f"{name} checksums differ: {checks}")
    sane, extra = ea_sanity(name, c, models[0], results[0], n)
    rt = models[0]._sim.rt
    sweeps_s, rates = warm_rate(models[1], EA_RATE_SWEEPS, kw, calls=3)
    r = results[0]
    log("38 table replicas", f"{name}: {'x'.join(map(str, rt.lattice.shape))}, "
        f"{rt.lattice.n_neighbors} offsets, {rt.n_temps} temps x {rt.n_replicas} replicas x "
        f"{rt.n_disorder} realizations ({rt.n_disorder * rt.n_systems * rt.n_spins} spins), "
        f"{kw}, {n} sweeps on {dev} ({first_s:.1f} s): launches {launches}; checksum "
        f"{checks[0]} == {checks[1]}; sanity ok: {', '.join(sane)}{extra}; <e>[0,-1] "
        f"{r['energies'][0]:.5f}, {r['energies'][-1]:.5f}; <q^2>[0,-1] "
        f"{r['overlap2'][0]:.5f}, {r['overlap2'][-1]:.5f}; {sweeps_s:.1f} sweeps/s "
        f"(median of {', '.join(f'{x:.1f}' for x in rates)}) on {card}")
    return dict(model=models[1], result=r, launches=launches, sweeps_s=sweeps_s,
                checksum=checks[0], kw=kw, n=n)


def ea_bounds(lat, d, n_temps, g, n_groups, flipped, kind, wolff):
    """The bound of each table form of one move (bytes: each input the form
    needs read once, each output written once; operations: a few f32
    operations a bond of each task), on ``d`` realizations of ``n_temps``
    temperatures, tasks of ``g`` replicas in ``n_groups`` groups, and the
    spins the finish flips (``flipped``).  A bond graph is ``nb`` bits a
    site, ceil(nb / 8) bytes.  The bonds forms read the task's systems (the
    pair, or Houdayer's g members), the forward table (and the couplings
    but for Houdayer) and write the graph and the seeds; ``ov_mid_table``
    also reads the blue graph and the parents and writes the grey graph
    and a flip byte (the backward table left out: it is read only where an
    SW coin falls on a root with no forward bond).  A finish reads the
    parents and the spins it flips and writes those spins; SW also reads
    the graph (the non-singleton test), Wolff the seeds, CMR its flip
    bytes."""
    n, nb = lat.n_spins, lat.n_neighbors
    b = d * n_temps * n_groups
    w = -(-nb // 8)
    tab = 4 * n * nb
    cp = 4 * d * n * nb
    finish = (4 * b * n + 2 * flipped + (4 * b if wolff else w * b * n)
              + (b * n if kind == "cmr" else 0))
    if kind == "houdayer":
        return {"houdn_bonds_table": bound(g * b * n + tab + w * b * n + 4 * b, g * nb * b * n),
                "houdn_finish_table": bound(finish, 0)}
    out = {"ov_bonds_table": bound(2 * b * n + cp + tab + w * b * n + 4 * b, 3 * nb * b * n),
           "ov_finish_table": bound(finish, 0)}
    if kind == "cmr":
        out["ov_mid_table"] = bound(2 * b * n + cp + tab + (w + 4) * b * n + (w + 1) * b * n,
                                    3 * nb * b * n)
    return out


def ea_pair_bound(lat, d, cols):
    """``pair_overlap_table``'s bound: the two systems of every column and
    the forward table read once, two ints a column written; two f32
    operations a bond of a column."""
    n, nb = lat.n_spins, lat.n_neighbors
    return bound(2 * cols * d * n + 4 * n * nb + 8 * cols * d, 2 * nb * cols * d * n)


def ea_alone(lat, tables, x, tab, kind, wolff, g, dev):
    """Each table form of a move on its own inputs: the first graph's words
    and the seeds (and ov_mid_table's grey words and flip bytes), left in a
    table Scratch by the move's launches, bitwise table_states_plain;
    ov_finish_table or houdn_finish_table launched alone on the plain
    version's last graph and its labels, every spin bitwise finish_plain.
    Returns the mismatches and the spins the finish flipped."""
    from peapods_tpu_torch.ops import _build, fk, overlap
    from peapods_tpu_torch.ops.cluster import connected_components

    spins, sid, coup, temps = x["spins"], x["sid"], x["coup"], x["temps"]
    d, s, n = spins.shape
    args = (sid, tab[0], coup, temps, *tab[1:])
    st, st2, fl, sd = overlap.table_states_plain(spins.clone(), *args, kind=kind,
                                                 wolff=wolff, lattice=lat)
    last = st if st2 is None else st2
    dims, _ = overlap.check_event(spins, *args, lat, kind)
    scratch = overlap.Scratch(dims[0], n, dev, kind == "cmr", table=True)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    overlap.launch_event(lib, stream, dims, spins.clone().data_ptr(),
                         *(t.data_ptr() for t in args), scratch.ptrs(), kind=kind,
                         wolff=wolff, group=g, lattice=lat, tables=tables)
    torch.cuda.synchronize()
    houd = kind == "houdayer"
    first = "houdn_bonds_table" if houd else "ov_bonds_table"
    bad = {f"{first} words": int((scratch.state != st).sum()),
           f"{first} seeds": int((scratch.seeds != sd).sum())}
    if kind == "cmr":
        bad["ov_mid_table grey words"] = int((scratch.state2 != st2).sum())
        bad["ov_mid_table flips"] = int((scratch.flip != fl).sum())
    par = connected_components(fk.state_masks(last, lat.n_neighbors), lat.shape,
                               lat.offsets).to(torch.int32)
    a, b = spins.clone(), spins.clone()
    overlap.finish_plain(b, sid, tab[0], tab[1], sd, last, par, kind=kind, wolff=wolff,
                         shape=lat, flip=fl)
    words = overlap.ov_table_words(n, lat.n_neighbors, d, x["n_temps"],
                                   x["n_replicas"] // g, s)
    bwd = tables[1].data_ptr()
    if houd:
        _build.check(lib.peapods_houdn_finish_table(
            a.data_ptr(), sid.data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            last.data_ptr(), par.data_ptr(), sd.data_ptr(), bwd, words.ctypes.data, g,
            int(wolff), stream), "houdn_finish_table")
    else:
        _build.check(lib.peapods_ov_finish_table(
            a.data_ptr(), sid.data_ptr(), tab[0].data_ptr(), tab[1].data_ptr(),
            sd.data_ptr(), last.data_ptr(), par.data_ptr(),
            None if fl is None else fl.data_ptr(), bwd, words.ctypes.data,
            overlap.KINDS.index(kind), int(wolff), stream), "ov_finish_table")
    torch.cuda.synchronize()
    bad["houdn_finish_table spins" if houd else "ov_finish_table spins"] = int((a != b).sum())
    return bad, int((b != spins).sum())


def ea_moves_check(name, lat, tables, x, moves, dev, rng, card, observe=False):
    """On a state ``x`` (spins ``[d, S, n]`` by system, sid, couplings,
    temperatures): each move of ``moves`` (kind, g, wolff) through the table
    forms bitwise its plain version (spins, labels, CMR's blue labels, the
    stats graph's masks; with ``observe`` the SW pair moves' observe form
    too), each table form alone (:func:`ea_alone`), and
    ``pair_overlap_table`` bitwise its plain version; the plain versions'
    times and the kernels' bounds."""
    from peapods_tpu_torch.ops import fk, megapair, overlap

    spins, sid = x["spins"], x["sid"]
    d, s, n = spins.shape
    out = {}
    for kind, g, wolff in moves:
        tab = move_tables(rng, d, x["n_replicas"], x["n_temps"], n, kind, wolff, g, dev)
        args = (sid, tab[0], x["coup"], x["temps"], *tab[1:])
        forms = [False] + ([True] if observe and g == 2 and not wolff else [])
        for obs in forms:
            kw = dict(kind=kind, wolff=wolff, shape=lat, with_labels=True,
                      with_masks=g == 2, observe=obs)
            a, b = spins.clone(), spins.clone()
            gk = overlap.overlap_event(a, *args, tables=tables, **kw)
            gp = overlap.overlap_event_plain(b, *args, **kw)
            torch.cuda.synchronize()
            bad = graph_mismatches(a, b, gk, gp)
            if obs:
                bad["spins written"] = int((a != spins).sum())
            elif not (a != spins).any():
                bad["no spin flipped"] = 1
            if any(bad.values()):
                raise AssertionError(f"{name} {kind} (g {g}, {'wolff' if wolff else 'sw'}"
                                     f"{', observe' if obs else ''}): mismatches {bad}")
        alone, flipped = ea_alone(lat, tables, x, tab, kind, wolff, g, dev)
        if any(alone.values()) or not flipped:
            raise AssertionError(f"{name} {kind} alone: mismatches {alone}, {flipped} "
                                 "spins flipped")
        kw = dict(kind=kind, wolff=wolff, shape=lat)
        plain_ms = wall_ms(lambda: overlap.overlap_event_plain(spins.clone(), *args, **kw), 2)
        bounds = ea_bounds(lat, d, x["n_temps"], g, x["n_replicas"] // g, flipped, kind,
                           wolff)
        names = (("houdn_bonds_table", "houdn_finish_table") if kind == "houdayer" else
                 ("ov_bonds_table", "ov_mid_table", "ov_finish_table") if kind == "cmr"
                 else ("ov_bonds_table", "ov_finish_table"))
        for k in names:
            b_ms, b_by = bounds[k]
            out.setdefault(k, dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                                   plain_ms=plain_ms, plain_is=f"the whole {kind} move"))
        per = "".join(f"; {k} {p} tasks a thread" for k, p in overlap.table_pers(
            n, lat.n_neighbors, d, x["n_temps"], x["n_replicas"] // g, kind, wolff, g,
            dev.index).items())
        log("38 kernel-vs-plain", f"{name} {kind} (g {g}, {'wolff' if wolff else 'sw'}"
            f"{', and its observe form' if len(forms) > 1 else ''}; {d * x['n_temps'] * (x['n_replicas'] // g)} "
            f"tasks on {'x'.join(map(str, lat.shape))}, {lat.n_neighbors} offsets{per}): the "
            f"move's spins, labels and masks and each table form alone bitwise the plain "
            f"version: mismatches {alone}; {flipped} spins flipped; plain move "
            f"{plain_ms:.3f} ms on {card} ok")
    cols = (x["n_replicas"] // 2) * x["n_temps"]
    rows = torch.empty((2, d, cols), dtype=torch.int32, device=dev)
    megapair.pair_overlap_table(spins, sid, rows[0], rows[1], lattice=lat,
                                n_replicas=x["n_replicas"], tables=tables)
    qs, ql = megapair.pair_overlap_table_plain(spins, sid, tables[0], x["n_replicas"])
    torch.cuda.synchronize()
    bad = int((rows[0] != qs).sum() + (rows[1] != ql).sum())
    if bad:
        raise AssertionError(f"{name} pair_overlap_table: {bad} mismatches")
    plain_ms = wall_ms(lambda: megapair.pair_overlap_table_plain(spins, sid, tables[0],
                                                                 x["n_replicas"]), 3)
    b_ms, b_by = ea_pair_bound(lat, d, cols)
    out["pair_overlap_table"] = dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                                     plain_ms=plain_ms, plain_is="pair_overlap_table_plain")
    plan = megapair.pair_table_plan(n, cols, d, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    log("38 kernel-vs-plain", f"{name} pair_overlap_table ({d} x {cols} columns, "
        f"{lat.n_neighbors} offsets; {plan.cluster} CTAs a cluster x {plan.copies} copies x "
        f"{d * plan.groups} = {plan.cluster * plan.copies * d * plan.groups} CTAs): qs and ql "
        f"bitwise the plain version; plain {plain_ms:.3f} ms on {card} ok")
    return out


def ea_state(run):
    """A run's final state as :func:`ea_moves_check` takes it."""
    sim = run["model"]._sim
    rt = sim.rt
    d, s = rt.n_disorder, rt.n_systems
    return dict(spins=sim.state["spins"].view(d, s, -1), sid=sim.state["system_ids"].view(d, s),
                coup=rt.coup, temps=rt.temps, n_temps=rt.n_temps, n_replicas=rt.n_replicas)


def ea_random_state(lat, dev, rng, d=2, n_replicas=4, n_temps=3):
    """Random spins on ``lat`` (R = 4, 3 temperatures, 2 realizations, +-J
    couplings, a random sid)."""
    n, nb, s = lat.n_spins, lat.n_neighbors, n_replicas * n_temps
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(
        n_replicas)[:, None] for _ in range(d)]).reshape(d, s).astype(np.int32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(spins=up(rng.choice([-1, 1], size=(d, s, n)).astype(np.int8)),
                sid=up(sid),
                coup=up(rng.choice([-1.0, 1.0], size=(d, n, nb)).astype(np.float32)),
                temps=up(np.geomspace(0.9, 2.2, n_temps).astype(np.float32)),
                n_temps=n_temps, n_replicas=n_replicas)


def ea_twin(dev, card):
    """38c: a 4^4 +-J glass (R = 2, 2 realizations, 64 sweeps, 38a's moves
    and FK phase) on the card bitwise the same run on the CPU's plain
    path: spins, sid, PT counts, the histograms; records to rtol 1e-12."""
    c = dict(EA_RUNS["glass4d"], **EA_TWIN)
    runs = []
    for device in (dev, "cpu"):
        m = ea_model(c, device)
        runs.append((m, m.sample(c["sweeps"], "metropolis", **c["kw"])))
    (mk, rk), (mp, rp) = runs
    for key in ("spins", "system_ids", "pt_edge_acceptances", "pt_round_trips",
                "pt_trip_state"):
        if not torch.equal(mk._sim.state[key].cpu(), mp._sim.state[key]):
            raise AssertionError(f"glass 4^4: {key} differs from the CPU's")
    for key in ("energies", "energies2", "mags2", "overlap2", "link_overlap"):
        np.testing.assert_allclose(rk[key], rp[key], rtol=1e-12, err_msg=f"glass 4^4 {key}")
    for key in ("overlap_histogram", "overlap_csd", "fk_csd"):
        if not np.array_equal(np.asarray(rk[key]), np.asarray(rp[key])):
            raise AssertionError(f"glass 4^4: {key} differs from the CPU's")
    log("38 kernel-vs-plain", f"4^4 +-J glass, R = 2, 2 realizations, {c['sweeps']} sweeps "
        f"of {c['kw']['overlap_cluster_build_mode']} SW moves and SW every 2 sweeps: the "
        f"card bitwise the CPU's plain path (spins, sid, PT counts, histograms; records to "
        f"rtol 1e-12) on {card} ok")


def ea_phase(dev, card):
    """Phase 38: 38a and 38b (:func:`ea_run`), 38c each table form on the
    runs' states and on 5D and odd-extent states against its plain version,
    Wolff and SW, update and observe (:func:`ea_moves_check`), and the
    4^4 twin (:func:`ea_twin`); 38d a profiled main-path window of each
    run (device us a sweep against wall us, each form's time a launch
    beside its bound and its plain version's time)."""
    from peapods_tpu_torch.ops.lattice import Lattice

    t0 = time.perf_counter()
    rng = np.random.default_rng(2038)
    runs = {name: ea_run(name, c, dev, card) for name, c in EA_RUNS.items()}
    for name, run in runs.items():
        rt = run["model"]._sim.rt
        wolff = run["kw"]["overlap_cluster_mode"] == "wolff"
        moves = sorted(set((k, g, wolff) for k, g in ea_moves(run["kw"], 2)))
        run["checks"] = ea_moves_check(name, rt.lattice, rt.tables, ea_state(run),
                                          moves, dev, rng, card)
        for k, rec in any_checks(name, run, dev, rng, card, "38 kernel-vs-plain").items():
            run["checks"].setdefault(k, rec)
        run["checks"]["cc_table_link"].update(zip(("bound_ms", "bound_by"),
                                                  ea_link_bound(run)))
    every = [(k, g, w) for k, g in (("houdayer", 2), ("houdayer", 4), ("jorg", 2),
                                    ("cmr", 2)) for w in (False, True)]
    for name, shape in EA_STATES.items():
        lat = Lattice(shape)
        ea_moves_check(name, lat, lat.device_tables(dev), ea_random_state(lat, dev, rng),
                          every, dev, rng, card, observe=True)
    nine = Lattice((8, 8, 8), NINE_OFFSETS)
    ea_moves_check("nine8", nine, nine.device_tables(dev),
                      ea_random_state(nine, dev, rng), every, dev, rng, card, observe=True)
    ea_twin(dev, card)
    for name, run in runs.items():
        us, line = profile_window(run["model"], run["kw"], run["sweeps_s"], EA_RATE_SWEEPS,
                                  names=tuple(run["launches"]))
        run["us"] = us
        log("38 times", f"{name} {line} (on {card})")
        for k, rec in run["checks"].items():
            if k in us:
                rec.update(ms=us[k] / 1e3, launches=run["launches"].get(k, 0),
                           launches_a_sweep=run["launches"].get(k, 0) / run["n"])
        log("38 times", f"{name} per launch: " + "; ".join(
            f"{k} {rec['ms']:.5f} ms, {rec['launches_a_sweep']:.2f} a sweep (bound "
            f"{rec['bound_ms']:.6f} ms by {rec['bound_by']}, plain {rec['plain_ms']:.3f} ms)"
            for k, rec in run["checks"].items() if "ms" in rec) + f" on {card}")
    log("38 times", f"phase 38 took {time.perf_counter() - t0:.1f} s")
    return runs


def ea_link_bound(run):
    """``cc_table_link``'s bound a launch over a run's labellings, each
    reading its graphs' state words and the forward table once and writing
    their labels: the FK phase's (a graph a system) and each move's (a graph
    a task of g replicas; CMR labels twice), in the run's proportions."""
    rt, kw, n = run["model"]._sim.rt, run["kw"], run["n"]
    sites = rt.lattice.n_spins
    tab = 4 * sites * rt.lattice.n_neighbors
    graphs = []
    if "cluster_update_interval" in kw:
        n_fk = len(range(0, n, kw["cluster_update_interval"]))
        graphs += [rt.n_disorder * rt.n_systems] * n_fk
    for kind, g in ea_moves(kw, n):
        tasks = rt.n_disorder * rt.n_temps * (rt.n_replicas // g)
        graphs += [tasks] * (2 if kind == "cmr" else 1)
    return bound(sum(8 * b * sites + tab for b in graphs) / len(graphs), 0)


def add_ea_records(kernels, runs):
    """Phase 38's records: each table form at 38a's main path (Houdayer(4)'s
    at 38b's run, which alone launches it with g = 4: the pair move's
    numbers there), the other runs' numbers beside them (``at_<run>``); the
    sweep, measurement, bonds and labelling of the table form at 38a beside
    phase 36's records (``at_glass4d``)."""
    main = runs["glass4d"]
    by_name = {kr["name"]: kr for kr in kernels}
    for k in TABLE_KERNELS:
        if k in by_name and "ms" in main["checks"].get(k, {}):
            by_name[k]["at_glass4d"] = dict(main["checks"][k],
                                            launches=main["launches"].get(k, 0))
    for k in EA_KERNELS:
        rec = main["checks"][k]
        kr = dict(rec, name=k, route="cuda", source=EA_SRC[k], replaces=ea_replaces(k),
                  launches=main["launches"].get(k, 0), library_ms=None)
        for name, run in runs.items():
            if name != "glass4d" and k in run["checks"] and "ms" in run["checks"][k]:
                kr[f"at_{name}"] = run["checks"][k]
        kernels.append(kr)


# ------------------------------------------------ the Python layer (item 6)


# Phase 37: the user's entry points at full width.  37a and 37b run the CLI
# in this process on the flagship configuration (cli.py's argv; Ising's
# dynamics seed derives from --seed, so its checksum is not
# FLAGSHIP_CHECKSUM); 37c runs `peapods-torch sweep` on
# examples/sweep_config.toml at its own widths (8^3 and 10^3 +-J, 12
# temperatures, R = 2, 16 realizations, full-ladder PT, Houdayer and CMR SW
# every sweep, SW every 2 sweeps with statistics, fft autocorrelation to
# lag 1000, the equilibration diagnostic), cut in depth only: --n-sweeps
# PY_SWEEP_SWEEPS instead of 10000.
PY_SWEEP_SWEEPS = 2000
PY_TRACE_SWEEPS = {"flagship": 512, "config3": 64}
PY_TRACE_KERNELS = {"flagship": ("mega_resident",),
                    "config3": ("sweep_2d", "fk_bonds", "fk_link", "fk_finish", "pt_step")}
PY_INTERRUPT_SWEEPS = 512
# the kernels a run of the sweep study launches (3D cubic, R = 2: the
# per-sweep replica path with the fused FK kernels, Houdayer's and CMR's
# moves, energies re-derived for PT after a move)
PY_SWEEP_KERNELS = ("sweep_nb", "measure_nb", "fk_bonds", "fk_link", "fk_finish",
                    "pair_overlap", "pt_step", "houdn_bonds", "houdn_finish", "ov_bonds",
                    "ov_mid", "ov_finish", "energy_partials")


def reset_all_counts():
    reset_space_counts()
    reset_pair_counts()


def all_counts():
    """Every kernel's launches since the last reset, those that ran."""
    from peapods_tpu_torch.ops import mega, megapair, overlap

    counts = {**space_counts(), **mega.LAUNCHES, **megapair.LAUNCHES, **overlap.LAUNCHES}
    return {k: v for k, v in counts.items() if v}


def py_flagship():
    """The flagship's arguments on the command line."""
    return ["--shape", str(L), str(L), "--temp-min", "1.8", "--temp-max", "3.2",
            "--n-temps", str(N_TEMPS), "--pt-interval", "1", "--n-sweeps",
            str(FLAGSHIP_SWEEPS), "--seed", str(SEED)]


def cli_run(argv):
    """``peapods_tpu_torch.cli.main(argv)`` in this process: its printed
    text and seconds."""
    import contextlib
    import io

    from peapods_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue(), time.perf_counter() - t0


def py_simulate(dev, card, tmp):
    """Phase 37a: ``simulate`` on the flagship configuration with ``-o``:
    16 ``mega_resident`` launches, a table of 24 rows, and every array of
    the file bitwise ``Ising(...).sample(...)`` with the same arguments
    (exported by the CLI's own ``_export_payload``)."""
    from peapods_tpu_torch import Ising, cli

    path = f"{tmp}/simulate.npz"
    reset_all_counts()
    argv = py_flagship()
    text, secs = cli_run(["simulate", *argv, "-o", path])
    launches = all_counts()
    want = {"mega_resident": -(-FLAGSHIP_SWEEPS // 256)}
    if launches != want:
        raise AssertionError(f"simulate's launch counts {launches}, expected {want}")
    lines = text.splitlines()
    dash = next(i for i, ln in enumerate(lines) if ln.startswith("---"))
    rows = [ln for ln in lines[dash + 1:] if ln.strip() and not ln.startswith("Results")]
    if len(rows) != N_TEMPS or lines[-1] != f"Results saved to {path}":
        raise AssertionError(f"simulate printed {len(rows)} rows: {text[-400:]}")
    model = Ising((L, L), temperatures=cli._temperature_grid(1.8, 3.2, N_TEMPS, "log"),
                  seed=SEED, device=dev)
    result = model.sample(FLAGSHIP_SWEEPS, pt_interval=1)
    want = cli._export_payload(model, result)
    with np.load(path) as data:
        got = {k: data[k] for k in data.files}
    if sorted(got) != sorted(want):
        raise AssertionError(f"simulate's keys {sorted(got)}, Ising's {sorted(want)}")
    bad = [k for k in want if got[k].dtype != np.asarray(want[k]).dtype
           or got[k].tobytes() != np.asarray(want[k]).tobytes()]
    if bad:
        raise AssertionError(f"simulate's arrays {bad} differ from Ising.sample's")
    if not all(np.isfinite(v).all() for v in got.values() if v.dtype.kind == "f"):
        raise AssertionError("simulate wrote a value that is not finite")
    log("37a simulate", f"peapods-torch simulate {' '.join(argv)} -o FILE in "
        f"{secs:.2f} s: launches {launches}; {len(rows)} rows under `{lines[dash - 1].strip()}`; "
        f"{len(got)} arrays ({', '.join(sorted(got))}) bitwise Ising.sample's with the "
        f"same arguments ({card})")
    return dict(seconds=secs, launches=launches, rows=len(rows), arrays=len(got))


def py_bench(card, sweeps_s):
    """Phase 37b: ``bench`` on the flagship configuration: its line beside
    phase 4's rate (both host clocks in this process)."""
    reset_all_counts()
    text, _ = cli_run(["bench", *py_flagship()])
    launches = all_counts()
    if launches != {"mega_resident": -(-FLAGSHIP_SWEEPS // 256)}:
        raise AssertionError(f"bench's launch counts {launches}")
    found = re.search(r"Total: ([0-9.]+) s  \|  ([0-9.]+) ms/sweep", text)
    if found is None:
        raise AssertionError(f"bench printed no ms/sweep: {text}")
    secs, ms = float(found.group(1)), float(found.group(2))
    for line in text.strip().splitlines():
        log("37b bench", line)
    log("37b bench", f"the CLI's {secs:.3f} s for {FLAGSHIP_SWEEPS} sweeps ({ms:.3f} ms/sweep "
        f"as printed; one cold sample() call of a new model) beside phase 4's "
        f"{1e3 / sweeps_s:.4f} ms/sweep ({sweeps_s:.1f} sweeps/s, median of warm calls); "
        f"host clocks in one process, on {card}")
    return dict(seconds=secs, ms_per_sweep=ms, phase4_sweeps_s=sweeps_s)


def sweep_config_copy(tmp, out, save_plots):
    """examples/sweep_config.toml copied into ``tmp`` with its ``[output]
    dir`` set to ``out`` and ``save_plots`` to ``save_plots``."""
    from pathlib import Path

    text = (Path(__file__).resolve().parent / "examples" / "sweep_config.toml").read_text()
    for key, value in (("dir", f'"{out}"'), ("save_plots", str(save_plots).lower())):
        text, n = re.subn(rf"(?m)^{key} = .*$", f"{key} = {value}", text)
        if n != 1:
            raise AssertionError(f"sweep_config.toml has {n} lines for {key}")
    path = Path(tmp) / "sweep_config.toml"
    path.write_text(text)
    return path


def py_sweep(dev, card, tmp):
    """Phase 37c: ``peapods-torch sweep --config`` on the example study at
    its own widths, cut in depth: both labels' files with the keys of
    ``_model_npz_entries``, every value finite, each FK histogram summing to
    n_spins x its graphs, and the 8^3 runs again from the same seed bitwise
    equal."""
    import importlib.util

    from peapods_tpu_torch import cli, sweep

    plots = importlib.util.find_spec("matplotlib") is not None
    cfg = cli._load_sweep_config(sweep_config_copy(tmp, f"{tmp}/sweep", plots))
    runs = {}
    saved = cli.run_sweep

    def keep(*args, **kw):
        runs[kw["output_dir"]] = saved(*args, **kw)
        return runs[kw["output_dir"]]

    cli.run_sweep = keep
    try:
        reset_all_counts()
        text, secs = cli_run(["sweep", "--config", f"{tmp}/sweep_config.toml",
                              "--n-sweeps", str(PY_SWEEP_SWEEPS)])
        launches = all_counts()
        again, secs_again = cli_run(["sweep", "--config", f"{tmp}/sweep_config.toml",
                                     "--n-sweeps", str(PY_SWEEP_SWEEPS), "--sizes", "8,8,8",
                                     "--output-dir", f"{tmp}/again"])
    finally:
        cli.run_sweep = saved
    missing = [k for k in PY_SWEEP_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"the sweep launched none of {missing}: {launches}")
    results = runs[f"{tmp}/sweep"]
    labels = sorted(results)
    if labels != ["bimodal_cmr_sw", "bimodal_sw"]:
        raise AssertionError(f"the sweep's labels {labels}")
    n, warmup = PY_SWEEP_SWEEPS, int(np.floor(PY_SWEEP_SWEEPS * cfg["warmup_ratio"] + 0.5))
    fk_phases = len([s for s in range(warmup, n) if s % cfg["cluster_interval"] == 0])
    checks = []
    for label in labels:
        with np.load(f"{tmp}/sweep/sweep_{label}.npz") as data:
            got = {k: data[k] for k in data.files}
        with np.load(f"{tmp}/again/sweep_{label}.npz") as data:
            twice = {k: data[k] for k in data.files}
        want = {"temperatures"}
        for size, model in results[label].items():
            want |= set(sweep._model_npz_entries(size, model))
            graphs = fk_phases * cfg["n_replicas"] * cfg["n_disorder"]
            csd = np.stack(model.fk_csd)  # a uint64 histogram a temperature
            sums = (csd * np.arange(csd.shape[-1], dtype=np.uint64)).sum(-1)
            if csd.shape != (cfg["n_temps"], model.n_spins + 1) or (
                    sums != model.n_spins * graphs).any():
                raise AssertionError(f"{label} {size}: fk_csd {csd.shape}, sums "
                                     f"{sums.tolist()} (want {model.n_spins * graphs})")
        if set(got) != want:
            raise AssertionError(f"{label}: keys {sorted(got)}, _model_npz_entries "
                                 f"{sorted(want)}")
        bad = [k for k, v in got.items() if v.dtype.kind == "f" and not np.isfinite(v).all()]
        if bad:
            raise AssertionError(f"{label}: not finite in {bad}")
        same = sorted(twice) == sorted(k for k in got if not k.startswith("10x10x10_"))
        differ = [k for k in twice if got[k].tobytes() != twice[k].tobytes()
                  or got[k].dtype != twice[k].dtype]
        if not same or differ:
            raise AssertionError(f"{label}: the 8^3 run again differs in {differ} (keys "
                                 f"equal {same})")
        checks.append(f"{label}: {len(got)} keys, finite, 8^3 twice bitwise ({len(twice)} "
                      "arrays)")
    runs_s = [float(x) for x in re.findall(r"^  ([0-9.]+)s$", text, re.M)]
    for line in text.strip().splitlines():
        if line.strip():
            log("37c sweep", line)
    log("37c sweep", f"examples/sweep_config.toml at its widths, --n-sweeps {n} (the file "
        f"says 10000), save_plots {plots}: {secs:.1f} s, runs {runs_s} s; launches "
        f"{launches}; " + "; ".join(checks) + f"; sum_s s fk_csd[T, s] = n_spins x "
        f"{fk_phases} FK phases x R x d at every T; the 8^3 runs again in "
        f"{secs_again:.1f} s ({card})")
    return dict(seconds=secs, runs_s=runs_s, launches=launches, plots=plots,
                sweeps=n, again_s=secs_again)


def trace_names(log_dir):
    """The event names of the Chrome trace that ``trace`` wrote."""
    from pathlib import Path

    files = list(Path(log_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace wrote {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    return {e.get("name", "") for e in events}, files[0].stat().st_size


def py_trace(dev, card, tmp):
    """Phase 37d: ``trace()`` around flagship and config-3 sweeps: the
    Chrome trace holds ``peapods/sweep``, ``peapods/measure`` and the
    kernels' names; each run's launches and checksum are those of the same
    run outside ``trace()``."""
    import contextlib

    from peapods_tpu_torch import Ising, IsingSimulation
    from peapods_tpu_torch.utils.profiling import trace

    temps = np.geomspace(1.8, 3.2, N_TEMPS).astype(np.float32)
    coup = np.ones((L, L, 2), np.float32)
    paths = {
        "flagship": (lambda: IsingSimulation([L, L], coup, temps, 1, None, SEED, device=dev),
                     dict(pt_interval=1, warmup_ratio=0.0)),
        "config3": (lambda: Ising((L, L), temperatures=np.array([T_C], np.float32), seed=3,
                                  device=dev)._sim,
                    dict(cluster_update_interval=1, cluster_mode="sw", warmup_ratio=0.25)),
    }
    out = {}
    for name, (make, kw) in paths.items():
        n, kernels = PY_TRACE_SWEEPS[name], PY_TRACE_KERNELS[name]
        seen = {}
        for where in ("outside", "inside"):
            sim = make()
            reset_all_counts()
            log_dir = f"{tmp}/trace_{name}"
            with trace(log_dir) if where == "inside" else contextlib.nullcontext():
                result = sim.sample(n, "metropolis", **kw)
                torch.cuda.synchronize()
            seen[where] = (all_counts(), state_checksum(sim, result))
        if seen["inside"] != seen["outside"]:
            raise AssertionError(f"{name}: inside trace() {seen['inside']}, outside "
                                 f"{seen['outside']}")
        names, size = trace_names(log_dir)
        scopes = sorted(x for x in names if x.startswith("peapods/"))
        hits = {k: [x for x in names if f"{k}_kernel" in x][:1] for k in kernels}
        if scopes != ["peapods/measure", "peapods/sweep"] or not all(hits.values()):
            raise AssertionError(f"{name}: scopes {scopes}, kernels {hits}")
        out[name] = dict(sweeps=n, launches=seen["inside"][0], checksum=seen["inside"][1],
                         trace_bytes=size)
        log("37d trace", f"{name}, {n} sweeps inside trace(): the Chrome trace ({size} B) "
            f"holds {scopes} and {', '.join(k for k in kernels)}; launches "
            f"{seen['inside'][0]} and checksum {seen['inside'][1]} as outside trace() "
            f"({card})")
    return out


def py_interrupt(dev, card, tmp):
    """Phase 37e: Ctrl-C and the checkpoint seed on the card.  A flagship
    ``sample(512)`` whose ``progress`` raises ``KeyboardInterrupt`` after
    the first chunk, then ``sample(256)``: spins and system IDs bitwise
    ``sample(256)`` + ``sample(256)``.  ``Ising(seed=s).save_checkpoint``
    for an ``s`` whose dynamics seed is >= 2^63 (written as uint64),
    loaded on the card and on the CPU to the same state."""
    from peapods_tpu_torch import Ising, IsingSimulation
    from peapods_tpu_torch.engine.seeds import dynamics_seed

    temps = np.geomspace(1.8, 3.2, N_TEMPS).astype(np.float32)
    coup = np.ones((L, L, 2), np.float32)
    kw = dict(pt_interval=1, warmup_ratio=0.0)
    chunk = PY_INTERRUPT_SWEEPS // 2
    sim = IsingSimulation([L, L], coup, temps, 1, None, SEED, default_chunk=chunk,
                          device=dev)
    calls = []

    def boom(done, total):
        calls.append(done)
        raise KeyboardInterrupt

    try:
        sim.sample(PY_INTERRUPT_SWEEPS, "metropolis", progress=boom, **kw)
        raise AssertionError("the interrupt did not reach the caller")
    except KeyboardInterrupt:
        pass
    if calls != [chunk] or int(sim.state["counter"]) != chunk:
        raise AssertionError(f"interrupted after {calls}, counter {int(sim.state['counter'])}")
    sim.sample(chunk, "metropolis", **kw)
    whole = IsingSimulation([L, L], coup, temps, 1, None, SEED, default_chunk=chunk,
                            device=dev)
    whole.sample(chunk, "metropolis", **kw)
    whole.sample(chunk, "metropolis", **kw)
    bad = [k for k in ("spins", "system_ids") if not torch.equal(sim.state[k], whole.state[k])]
    if bad or int(sim.state["counter"]) != int(whole.state["counter"]):
        raise AssertionError(f"the resumed run differs in {bad}")

    seed = next(s for s in range(64) if dynamics_seed(s) >= 1 << 63)
    model = Ising((L, L), temperatures=temps, seed=seed, device=dev)
    model.sample(chunk, pt_interval=1)
    path = f"{tmp}/large_seed.npz"
    model.save_checkpoint(path)
    with np.load(path) as data:
        dtype = data["__constructor_seed"].dtype
        stored = int(data["__constructor_seed"])
    if dtype != np.uint64 or stored != model._sim.constructor_seed:
        raise AssertionError(f"the seed was written as {dtype} {stored}")
    states = {}
    for where, x in (("card", dev), ("cpu", torch.device("cpu"))):
        back = Ising((L, L), temperatures=temps, seed=seed, device=x)
        back.load_checkpoint(path)
        states[where] = full_state(back._sim)
    bad = same_state(states["card"], full_state(model._sim)) + same_state(
        states["cpu"], states["card"])
    if bad:
        raise AssertionError(f"the large seed's file loads with {bad} changed")
    log("37e interrupt", f"flagship sample({PY_INTERRUPT_SWEEPS}) interrupted from "
        f"progress after {calls[0]} sweeps, then sample({chunk}): spins and system_ids "
        f"bitwise sample({chunk}) + sample({chunk}); Ising(seed={seed}) (dynamics seed "
        f"{model._sim.constructor_seed} >= 2^63) saved as {dtype}, loaded on the card and "
        f"on the CPU to the same state ({card})")
    return dict(interrupted_at=calls[0], seed=seed, dynamics_seed=model._sim.constructor_seed)


def py_phase(dev, card, sweeps_s):
    """Phase 37: the Python layer's entry points on the card."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"simulate": py_simulate(dev, card, tmp), "bench": py_bench(card, sweeps_s),
               "sweep": py_sweep(dev, card, tmp), "trace": py_trace(dev, card, tmp),
               "interrupt": py_interrupt(dev, card, tmp)}
    out["seconds"] = time.perf_counter() - t0
    log("37 python layer", f"phase 37 in {out['seconds']:.1f} s ({card})")
    return out


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
    res = check_resident_chunk(sim, card)

    routes = mega_routes(sim, rates, card)
    plain_s = plain_path_rate(sim, 16)
    log("5 times", f"plain torch path: {plain_s:.2f} sweeps/s = "
        f"{plain_s * N_TEMPS * L * L:.4e} flips/s; kernel path {sweeps_s:.1f} "
        f"sweeps/s ({sweeps_s / plain_s:.1f}x) on {card}")
    log("5 times", f"mega_resident {res['ms']:.5f} ms a chunk of {res['sweeps_per_launch']} "
        f"sweeps, {1e3 * res['ms_per_sweep']:.3f} us a sweep (bound {res['bound_ms']:.5f} ms "
        f"by {res['bound_by']}, plain {res['plain_ms']:.1f} ms); off the flagship's "
        f"route at its shapes: colour_pass {cp['ms']:.5f} ms (bound {cp['bound_ms']:.5f} "
        f"ms, plain {cp['plain_ms']:.4f} ms), pt_step {pts['ms']:.5f} ms (bound "
        f"{pts['bound_ms']:.5f} ms, plain {pts['plain_ms']:.4f} ms) per launch on {card}")
    res.update(device_us_per_sweep=routes["resident"]["device_us"],
               busy=routes["resident"]["busy"], sweeps_s=routes["resident"]["sweeps_s"],
               three_launches=dict(device_us_per_sweep=routes["launches"]["device_us"],
                                   busy=routes["launches"]["busy"],
                                   sweeps_s=routes["launches"]["sweeps_s"]))

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

    # the per-sweep replica path: binder_crossings.py's lattices, snapshots
    rsweeps = replica_sweeps(dev, card)

    # the overlap moves on the triangular, BCC, FCC and NNN lattices
    ovl = ov_lattices(dev, card)

    # autocorrelation, the equilibration diagnostic, checkpoints and the
    # physics scripts
    ac = ac_phase(dev, card)

    # odd extents, extent 1, 1D, 4D and up, more than six offsets
    anyl = any_phase(dev, card)

    # the Python layer: the CLI, run_sweep, trace(), Ctrl-C
    py_phase(dev, card, sweeps_s)

    # replicas on the table lattices: the 4D glass
    ea = ea_phase(dev, card)

    mega_src = "peapods_tpu_torch/csrc/mega.cu"
    mega_replaces = "peapods_tpu/ops/pallas_mega.py:96"
    fk_src = "peapods_tpu_torch/csrc/fk.cu"
    fk_replaces = "peapods_tpu/ops/pallas_event.py:621"
    mp_replaces = "peapods_tpu/ops/pallas_megapair.py:325"
    ev_replaces = EV_REPLACES
    # colour_pass and pt_step left the flagship's route: their main-path
    # numbers are config 4's (the replica path) and config 3's (the
    # per-sweep path); their flagship-shape checks stand beside them
    kernels = [
        dict(name="mega_resident", route="cuda",
             source="peapods_tpu_torch/csrc/mega_resident.cu", replaces=mega_replaces,
             launches=launches["mega_resident"], **res),
        dict(name="colour_pass", route="cuda", source=mega_src, replaces=mp_replaces,
             **{"library_ms": None, **pk["config4"]["colour_pass"]},
             at_flagship_shape=dict(cp, launches=launches["colour_pass"])),
        dict(name="pt_step", route="cuda", source=mega_src, replaces=mega_replaces,
             **{"library_ms": None, **pt_ps["config3"]}, at_harness=pt_ps["harness"],
             at_flagship_shape=dict(pts, launches=launches["pt_step"])),
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
    add_replica_sweep_records(kernels, rsweeps)
    add_ov_lattice_records(kernels, ovl)
    add_any_records(kernels, anyl)
    add_ea_records(kernels, ea)
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
