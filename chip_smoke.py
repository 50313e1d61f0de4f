"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``peapods_tpu_torch`` from the sources in this
checkout, holds each kernel against its plain torch version on the card at
the flagship shapes (256x256, 24 temperatures), drives the flagship
configuration through ``IsingSimulation.sample`` and checks its output, then
times the kernel path against the plain torch path.  Every phase prints one
line; any failure raises and the script exits non-zero.  The line before the
last is a JSON record of the kernels; the last line is::

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
            e_k = k_out[0].double().sum(-1) / (L * L)
            m_k = k_out[1].sum(-1)
            e_p = p_out[0].double().sum(-1) / (L * L)
            m_p = p_out[1].sum(-1)
            # the kernel's fused (e, m) against a recompute on its own spins
            coup = x["jgrids"][0, [1, 3]].reshape(2, -1).T.contiguous()
            e_rc, m_rc = energies_and_mags(a[0].reshape(N_TEMPS, -1), coup, (L, L))
            if not torch.equal(e_k.float()[0], e_rc[sys_idx]):
                raise AssertionError("kernel e differs from the recompute")
            if not torch.equal(m_k[0], m_rc[sys_idx]):
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
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, ties=ties_total)


def check_pt_step(dev, rng):
    """Kernel vs plain PT step on the same partials, both schedules."""
    from peapods_tpu_torch.ops import mega
    from peapods_tpu_torch.ops.tempering import hot_cold_slots, init_trip_state

    x = flagship_inputs(dev, rng)
    hot, cold = hot_cold_slots(x["temps"].cpu().numpy())
    e_part, m_part = mega.colour_pass(x["spins"], x["jgrids"], x["sid"],
                                      x["temps"], x["words"], 1, gibbs=False)
    n_edges = N_TEMPS - 1
    n_events = 64
    i32 = dict(dtype=torch.int32, device=dev)
    max_err = 0.0
    for pt_full in (False, True):
        states = []
        for _ in range(2):
            sid = x["sid"].clone()
            states.append(dict(
                sid=sid, ea=torch.zeros((1, n_edges), **i32),
                ec=torch.zeros((1, n_edges), **i32),
                rt=torch.zeros((1, N_TEMPS), **i32),
                ts=init_trip_state(sid[:, None], hot),
                e=torch.empty((1, n_events, N_TEMPS), dtype=torch.float32, device=dev),
                m=torch.empty((1, n_events, N_TEMPS), **i32),
                parity=0,
            ))
        words = torch.from_numpy(
            rng.integers(-2**31, 2**31, (n_events, 1, 2)).astype(np.int32)).to(dev)
        for t in range(n_events):
            for st, fn in ((states[0], mega.pt_step), (states[1], mega.pt_step_plain)):
                st["parity"] = fn(
                    e_part, m_part, st["e"][:, t], st["m"][:, t], st["sid"],
                    st["ea"], st["ec"], st["rt"], st["ts"], x["temps"], words[t],
                    do_pt=True, pt_full=pt_full, parity=st["parity"],
                    hot_slot=hot, cold_slot=cold, n_spins=L * L)
        torch.cuda.synchronize()
        k, p = states
        for key in ("sid", "ea", "ec", "rt", "ts", "e", "m"):
            if not torch.equal(k[key], p[key]):
                raise AssertionError(f"pt_step (full={pt_full}): {key} differs")
        if k["parity"] != p["parity"]:
            raise AssertionError("pt_step parity differs")
        if int(k["ec"].sum()) == 0:
            raise AssertionError("pt_step accepted no swap: weak check")
        max_err = max(max_err, float((k["e"] - p["e"]).abs().max()))
        log("3 kernel-vs-plain",
            f"pt_step ok ({'full_ladder' if pt_full else 'single_random_edge'}): "
            f"{n_events} events bitwise, {int(k['ec'].sum())} of "
            f"{int(k['ea'].sum())} swaps accepted")

    st = states[0]
    args = (e_part, m_part, st["e"][:, 0], st["m"][:, 0], st["sid"], st["ea"],
            st["ec"], st["rt"], st["ts"], x["temps"], words[0])
    kw = dict(do_pt=True, pt_full=False, parity=0, hot_slot=hot, cold_slot=cold,
              n_spins=L * L)
    ms = gpu_ms(lambda: mega.pt_step(*args, **kw), 200)
    plain_ms = wall_ms(lambda: mega.pt_step_plain(*args, **kw), 20)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


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
            if "registers" in ln]
    log("2 build", f"built {_build.build_info['path']} in "
        f"{time.perf_counter() - t0:.2f} s; ptxas: {' | '.join(regs)}")

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
    log("5 times", f"colour_pass {cp['ms']:.5f} ms (plain {cp['plain_ms']:.4f} ms), "
        f"pt_step {pts['ms']:.5f} ms (plain {pts['plain_ms']:.4f} ms) per launch")

    src = "peapods_tpu_torch/csrc/mega.cu"
    replaces = "peapods_tpu/ops/pallas_mega.py:96"
    record = {"kernels": [
        {"name": "colour_pass", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches["colour_pass"],
         "max_abs_err": cp["max_abs_err"], "ms": cp["ms"],
         "plain_ms": cp["plain_ms"]},
        {"name": "pt_step", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches["pt_step"],
         "max_abs_err": pts["max_abs_err"], "ms": pts["ms"],
         "plain_ms": pts["plain_ms"]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
