"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``peapods_tpu_torch`` from the sources in this
checkout (one nvcc per source, all at once) and drives both of the port's
paths through the user's entry points:

* the mega path: the flagship configuration (256x256, 24 temperatures, PT
  every sweep) through ``IsingSimulation.sample``, each of its kernels
  (``colour_pass``, ``pt_step``) held against its plain torch version;
* the per-sweep path with SW / Wolff cluster updates: config 3 (256x256 at
  T_c, SW every sweep) through ``Ising.sample`` twice from one seed, its
  Binder cumulant against the torus value, a Wolff run against it, SW with
  PT on the 64x64 x 16 temperatures x 128 realizations harness shape, 4x4
  exact enumeration, and each kernel (``sweep_2d``, ``fk_bonds``,
  ``fk_link``, ``fk_finish``, ``pt_step``) held against its plain version
  at both shapes.

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
    from peapods_tpu_torch.ops import fk, mega, sweep

    for table in (sweep.LAUNCHES, fk.LAUNCHES, mega.LAUNCHES):
        for k in table:
            table[k] = 0


def cluster_counts():
    from peapods_tpu_torch.ops import fk, mega, sweep

    return {**sweep.LAUNCHES, **fk.LAUNCHES, "pt_step": mega.LAUNCHES["pt_step"]}


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
    want = {"sweep_2d": 2 * n, "fk_bonds": n, "fk_link": n, "fk_finish": n,
            "pt_step": n}
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
    want = {"sweep_2d": 2 * n, "fk_bonds": n, "fk_link": n, "fk_finish": n,
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
    h, w = rt.lattice.shape
    b = rt.n_disorder * rt.n_systems
    kf = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
    return dict(
        spins=st["spins"].view(b, h, w).clone(),
        j_fwd=rt.coup,
        temps=slot_temps_for_systems(st["system_ids"].view(rt.n_disorder, -1),
                                     rt.temps).view(-1).contiguous(),
        scalars=torch.from_numpy(seeds.fk_scalars(kf, h * w, wolff=wolff)).to(dev),
        kb_words=torch.from_numpy(
            rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)).to(dev))


def check_fk(models, dev, rng, card):
    """The FK kernels against their plain version on equilibrated states of
    config 3 (one 256^2 graph at T_c) and of the harness (2048 64^2 graphs),
    SW and Wolff with labels: spins, labels, m and e must be equal.  Then
    the plain versions' times and the bounds at both shapes."""
    from peapods_tpu_torch.ops import fk

    max_err = 0.0
    for name, model in models.items():
        for wolff in (False, True):
            x = fk_inputs(model, dev, rng, wolff)
            b, h, w = x["spins"].shape
            a, p = x["spins"], x["spins"].clone()
            args = (x["j_fwd"], x["temps"], x["scalars"], x["kb_words"])
            kw = dict(wolff=wolff, with_measure=True, with_labels=True)
            ek, mk, lk = fk.fk_update(a, *args, **kw)
            ep, mp, lp = fk.fk_update_plain(p, *args, **kw)
            torch.cuda.synchronize()
            e_k, m_k = fk.fk_energy_mag(ek, mk, h * w)
            e_p, m_p = fk.fk_energy_mag(ep, mp, h * w)
            bad = {"spins": int((a != p).sum()), "labels": int((lk != lp).sum()),
                   "m": int((m_k != m_p).sum()), "e": int((e_k != e_p).sum())}
            err = float((e_k - e_p).abs().max())
            n_clusters = int((lk.view(b, -1) == torch.arange(
                h * w, device=dev)).sum())
            largest = int(torch.bincount(lk.view(-1).long() + (h * w) * torch.arange(
                b, device=dev).repeat_interleave(h * w)).max())
            log("8 kernel-vs-plain",
                f"fk {'wolff' if wolff else 'sw'} on {name} ({b} graph(s) of "
                f"{h}x{w}): mismatches {bad}; {n_clusters} clusters, largest "
                f"{largest} sites; max |e_kernel - e_plain| = {err}")
            if any(bad.values()):
                raise AssertionError(f"fk kernels differ from plain: {bad}")
            max_err = max(max_err, err)

    times = {}
    for name, model in models.items():
        x = fk_inputs(model, dev, rng, False)
        b, h, w = x["spins"].shape
        n = h * w
        d = x["j_fwd"].shape[0]
        sp = x["spins"]
        # the plain version of each kernel, on the same state
        bd = fk.fk_bonds_plain(sp, x["j_fwd"], x["temps"], x["kb_words"])
        lab = fk.fk_link_plain(bd, (h, w))
        plain = {
            "fk_bonds": wall_ms(lambda: fk.fk_bonds_plain(
                sp, x["j_fwd"], x["temps"], x["kb_words"]), 3),
            "fk_link": wall_ms(lambda: fk.fk_link_plain(bd, (h, w)), 3),
            "fk_finish": wall_ms(lambda: fk.fk_finish_plain(
                sp.clone(), lab, x["j_fwd"], x["scalars"], wolff=False,
                with_measure=True), 3),
        }
        # the components a union-find must join on this state
        n_comp = int((lab == torch.arange(n, device=dev)).sum())
        cb = 8 * d * n  # the realizations' couplings
        t = {
            # spins, couplings, temps, kb in; state, parents out
            "fk_bonds": bound(b * n + cb + 12 * b + 5 * b * n, 16 * b * n),
            # state and parents in; a parent written per union
            "fk_link": bound(5 * b * n + 4 * (b * n - n_comp), 0),
            # spins, state, parents, couplings, scalars in; spins, partials out
            "fk_finish": bound(6 * b * n + cb + 12 * b + b * n
                               + 8 * b * ((n + 255) // 256), 4 * b * n),
        }
        for k, v in t.items():
            times.setdefault(k, {})[name] = dict(bound_ms=v[0], bound_by=v[1],
                                                 plain_ms=plain[k])
    return {k: dict(max_abs_err=max_err, library_ms=None, shapes=v)
            for k, v in times.items()}


def check_pt_step_per_sweep(models, dev):
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
            log("8 kernel-vs-plain", f"pt_step ok ({label}; {d} x {n_sys} slots, "
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


def profile_window(model, kw, sweeps_s, n):
    """Device time of each kernel of the per-sweep path over ``n`` sweeps of
    a model's main-path run, from the profiler's kernel records: per launch
    and per sweep, and the share of the unprofiled wall time per sweep that
    the device is busy."""
    from torch.profiler import ProfilerActivity, profile

    names = ("sweep_2d", "fk_bonds", "fk_link", "fk_finish", "pt_step")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.sample(n, "metropolis", **dict(kw, warmup_ratio=0.0))
        torch.cuda.synchronize()
    per_launch, per_sweep, other = {}, {}, 0.0
    for ev in prof.key_averages():
        if ev.self_device_time_total <= 0:
            continue
        hit = [k for k in names if f"{k}_kernel" in ev.key]
        if hit:
            per_launch[hit[0]] = ev.self_device_time_total / ev.count
            per_sweep[hit[0]] = ev.self_device_time_total / n
        else:
            other += ev.self_device_time_total / n
    missing = [k for k in names if k not in per_launch]
    if missing:
        raise AssertionError(f"the profiler saw no device time for {missing}")
    busy = sum(per_sweep.values()) + other
    line = ("device us per sweep: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_sweep.items())
        + f", other device work {other:.3f}, sum {busy:.3f} against "
        f"{1e6 / sweeps_s:.3f} us of wall time per sweep: the device is busy "
        f"{busy * sweeps_s / 1e6:.3f} of it")
    return per_launch, line


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
    regs = [ln.strip() for ln in _build.build_info["log"].splitlines()
            if "registers" in ln or ln.endswith(".so:")]
    log("2 build", f"built {len(_build.build_info['paths'])} libraries "
        f"({', '.join(_build.build_info['paths'])}) in {time.perf_counter() - t0:.2f} s; "
        f"ptxas: {' | '.join(regs)}")

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
        us, line = profile_window(run["model"], run["kw"], run["sweeps_s"], n)
        log("10 times", f"{name} {line}")
        for k, rec in ks.items():
            rec["shapes"][name]["ms"] = us[k] / 1e3
        pt_ps[name].update(ms=us["pt_step"] / 1e3,
                           launches=run["launches"]["pt_step"])
        log("10 times", f"{name} per launch: " + "; ".join(
            f"{k} {rec['shapes'][name]['ms']:.5f} ms (bound "
            f"{rec['shapes'][name]['bound_ms']:.5f} ms by "
            f"{rec['shapes'][name]['bound_by']}, plain "
            f"{rec['shapes'][name]['plain_ms']:.4f} ms)" for k, rec in ks.items())
            + f" on {card}")
        rec = pt_ps[name]
        log("10 times", f"{name} pt_step per launch: {rec['ms']:.5f} ms (bound "
            f"{rec['bound_ms']:.5f} ms by {rec['bound_by']}, plain "
            f"{rec['plain_ms']:.4f} ms) on {card}")
    for rec in ks.values():
        shapes = rec.pop("shapes")
        rec.update(shapes["config3"], at_harness=shapes["harness"])

    mega_src = "peapods_tpu_torch/csrc/mega.cu"
    mega_replaces = "peapods_tpu/ops/pallas_mega.py:96"
    fk_src = "peapods_tpu_torch/csrc/fk.cu"
    fk_replaces = "peapods_tpu/ops/pallas_event.py:621"
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
