"""Check and time the mega path's resident kernel (``csrc/mega_resident.cu``)
against the three launches a sweep (``csrc/mega.cu``) on one NVIDIA GPU.

    python3 tools/probe_resident.py [--out DIR] [--reps N] [--quick]
                                    [--variants V,...] [--calls]
                                    [--host-profile]

Builds the port's kernels (``ops/_build.py``), prints ``mega_resident``'s
``ptxas -v`` registers, shared memory and spills, and for each case (the
flagship's 256^2 x 24 slots and smaller shapes; lattice, realizations,
slots, sweeps, Metropolis or Gibbs, PT schedule and interval, couplings):

* the layout ``ops/mega.py`` ``resident_route`` picks (cluster, rows a CTA,
  threads, shared memory), or that it refuses the shape;
* one chunk through ``mega_chunk_resident``, ``mega_chunk_launches`` and
  ``mega_chunk_plain`` from the same state: spins, e, m, sid, the PT
  counters, the trip state and the parity bitwise (gaussian couplings: the
  plain e within rtol 1e-5);
* the device time of a chunk on each route (CUDA events over ``--reps``
  chunks queued behind a sleep kernel, resident and launches in turns),
  per sweep.

``--variants`` builds ``mega_resident.cu`` again with each named change of
:data:`VARIANTS` (most give wrong results: they take a part of the kernel
away to show what it costs) and times each variant's chunk beside this
design's, on the flagship's cases.

``--calls`` times warm flagship ``IsingSimulation.sample`` calls of 256 to
16,384 sweeps (host clock, median of three each) on each route and fits
wall time = per-call cost + sweeps x per-sweep cost: the host's share of
a call beside the device's share of a sweep.  ``--host-profile`` runs one
warm 4096-sweep call under ``cProfile`` and prints the host functions
that take the most time.

Prints one line per case with the card, writes them as JSON to
``--out/probe_resident.json``.  Needs a CUDA device and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_entries  # noqa: E402
from peapods_tpu_torch.ops import _build, mega  # noqa: E402
from peapods_tpu_torch.ops.sweep import pack_coupling_grids  # noqa: E402
from peapods_tpu_torch.ops.tempering import hot_cold_slots, init_trip_state  # noqa: E402

# (name, (H, W), d, slots, sweeps, gibbs, pt_full, pt_interval, sweep_base, couplings)
CASES = [
    ("flagship", (256, 256), 1, 24, 256, False, False, 1, 0, "pm"),
    ("flagship-gibbs-full", (256, 256), 1, 24, 256, True, True, 1, 0, "pm"),
    ("flagship-interval3", (256, 256), 1, 24, 256, False, False, 3, 5, "pm"),
    ("flagship-no-pt", (256, 256), 1, 24, 256, False, False, None, 0, "gauss"),
    ("64-d2", (64, 64), 2, 5, 24, False, False, 1, 0, "pm"),
    ("32x128-d3", (32, 128), 3, 6, 24, False, True, 3, 5, "pm"),
    ("128x256", (128, 256), 1, 24, 64, False, False, 1, 0, "pm"),
    ("256x512-d1-8", (256, 512), 1, 8, 64, False, False, 1, 0, "pm"),
    ("flagship-d2", (256, 256), 2, 24, 16, False, False, 1, 0, "pm"),
]
# (anchor, replacement) in csrc/mega_resident.cu of each variant: without
# the cluster barrier between the colours, without the site updates (the
# loop over a CTA's groups runs no turn), the draws without Philox,
# without the stores into the neighbours' halo rows, without PT events
VARIANTS = {
    "no-colour-sync": [("    cluster_arrive();  // colour 0 written before any CTA reads it\n"
                        "    draw_pass(draws, groups, g0, 1, slot, c0, c1);\n"
                        "    cluster_wait();\n",
                        "    draw_pass(draws, groups, g0, 1, slot, c0, c1);\n")],
    "no-pass": [("  for (int gl = threadIdx.x; gl < groups; gl += blockDim.x) {\n    const int j0",
                 "  for (int gl = threadIdx.x + groups; gl < groups; gl += blockDim.x) {\n"
                 "    const int j0")],
    "no-philox": [("    draws[gl] = philox4x32_10(k0, k1, static_cast<uint32_t>(slot),\n"
                   "                              static_cast<uint32_t>(colour), "
                   "static_cast<uint32_t>(g0 + gl),\n"
                   "                              0u);",
                   "    draws[gl] = make_uint4(k0 ^ gl, k1 + gl, slot + g0, colour);")],
    "no-push": [("      if (rl == 0) *reinterpret_cast<uint64_t*>(push_up + base) = wn;\n"
                 "      if (rl == R - 1) *reinterpret_cast<uint64_t*>(push_dn + base) = wn;\n",
                 "")],
    "no-pt": [("    const bool do_pt = a.pt_interval > 0 &&", "    const bool do_pt = false &&")],
    # 512 threads a CTA (4 groups a thread, up to 128 registers)
    "threads512": [("constexpr int kMaxThreads = 1024;", "constexpr int kMaxThreads = 512;")],
}
# the layout's most threads a CTA under a variant (ops/mega.py RESIDENT_MAX_THREADS)
VARIANT_THREADS = {"threads512": 512}
ORDER = ("spins", "jgrids", "temps", "sid", "ea", "ec", "rtrips", "tstate",
         "sweep_words", "pt_words")
STATE = ("spins", "sid", "ea", "ec", "rtrips", "tstate")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def inputs(dev, seed, shape, d, n_temps, n, couplings):
    rng = np.random.default_rng(seed)
    h, w = shape
    coup = (rng.choice([-1.0, 1.0], size=(d, h * w, 2)) if couplings == "pm"
            else rng.standard_normal((d, h * w, 2)))
    temps = np.geomspace(1.8, 3.2, n_temps).astype(np.float32)
    sid = torch.from_numpy(np.stack([rng.permutation(n_temps) for _ in range(d)])
                           .astype(np.int32)).to(dev)
    hot, _ = hot_cold_slots(temps)
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(
        spins=torch.from_numpy(rng.choice([-1, 1], size=(d, n_temps, h, w))
                               .astype(np.int8)).to(dev),
        jgrids=pack_coupling_grids(torch.from_numpy(coup.astype(np.float32)), shape)
        .contiguous().to(dev),
        temps=torch.from_numpy(temps).to(dev), sid=sid,
        ea=torch.zeros((d, n_temps - 1), **i32), ec=torch.zeros((d, n_temps - 1), **i32),
        rtrips=torch.zeros((d, n_temps), **i32), tstate=init_trip_state(sid[:, None], hot),
        sweep_words=torch.from_numpy(rng.integers(-2**31, 2**31, (n, d, 2))
                                     .astype(np.int32)).to(dev),
        pt_words=torch.from_numpy(rng.integers(-2**31, 2**31, (n, d, 2))
                                  .astype(np.int32)).to(dev))


def chunk_ms(fn, x, reps):
    """Device time of one chunk: ``reps`` chunks on copies of the state,
    queued behind a sleep kernel, between two CUDA events."""
    copies = [{k: v.clone() for k, v in x.items()} for _ in range(reps)]
    fn(copies[0])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for c in copies:
        fn(c)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def variant_library(name, out):
    """The port's kernel library with ``mega_resident.cu`` built again with
    variant ``name``'s changes (into ``out``)."""
    src = (_build.SOURCE_DIR / "mega_resident.cu").read_text()
    for anchor, repl in VARIANTS[name]:
        if anchor not in src:
            raise RuntimeError(f"variant {name}: anchor not found: {anchor!r}")
        src = src.replace(anchor, repl)
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"mega_resident_{name}.cu"
    cu.write_text(src)
    so = out / f"mega_resident_{name}.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SOURCE_DIR),
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    fns = vars(_build.library()).copy()
    for fn_name in ("peapods_smem_per_block_optin", "peapods_resident_max_clusters",
                    "peapods_mega_resident"):
        fn = getattr(lib, fn_name)
        fn.argtypes = _build._SIGNATURES[fn_name]
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return SimpleNamespace(**fns)


def sample_calls(dev, card):
    """The flagship's wall time per sample() call against its length, on
    the resident route and on the three launches a sweep."""
    import time

    from peapods_tpu_torch import IsingSimulation

    temps = np.geomspace(1.8, 3.2, 24).astype(np.float32)
    sim = IsingSimulation([256, 256], np.ones((256, 256, 2), np.float32), temps, 1, None,
                          42, device=dev)
    lengths = (256, 1024, 4096, 16384)
    out = {}
    for route in ("resident", "launches"):
        saved = mega.resident_route
        if route == "launches":
            mega.resident_route = lambda *args: None
        try:
            sim.sample(1024, "metropolis", pt_interval=1, warmup_ratio=0.0)  # warm
            ms = []
            for n in lengths:
                wall = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sim.sample(n, "metropolis", pt_interval=1, warmup_ratio=0.0)
                    torch.cuda.synchronize()
                    wall.append((time.perf_counter() - t0) * 1e3)
                ms.append(float(np.median(wall)))
        finally:
            mega.resident_route = saved
        per_sweep, per_call = np.polyfit(lengths, ms, 1)
        out[route] = dict(lengths=lengths, ms=ms, per_call_ms=float(per_call),
                          per_sweep_us=float(per_sweep) * 1e3)
        print(f"calls ({route}): " + ", ".join(f"{n} sweeps {t:.3f} ms" for n, t in
                                               zip(lengths, ms))
              + f"; fit {per_call:.3f} ms a call + {per_sweep * 1e3:.3f} us a sweep "
              f"({16384 / (ms[-1] / 1e3):.1f} sweeps/s at 16384) on {card}", flush=True)
    return out


def host_profile(dev):
    """The host's time in a warm 4096-sweep flagship call, by function
    (``cProfile``, cumulative), on the resident route."""
    import cProfile
    import io
    import pstats

    from peapods_tpu_torch import IsingSimulation

    temps = np.geomspace(1.8, 3.2, 24).astype(np.float32)
    sim = IsingSimulation([256, 256], np.ones((256, 256, 2), np.float32), temps, 1, None,
                          42, device=dev)
    sim.sample(1024, "metropolis", pt_interval=1, warmup_ratio=0.0)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    sim.sample(4096, "metropolis", pt_interval=1, warmup_ratio=0.0)
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(30)
    print(text.getvalue(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/probe")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--quick", action="store_true", help="the flagship case only")
    ap.add_argument("--variants", default="", help=f"of {', '.join(VARIANTS)}")
    ap.add_argument("--calls", action="store_true",
                    help="also time flagship sample() calls of several lengths")
    ap.add_argument("--host-profile", action="store_true",
                    help="also profile the host in a flagship sample() call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_resident: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    _build.library()
    for _, name, regs, smem, spill in ptxas_entries(_build.build_info["log"]):
        if name == "mega_resident":
            print(f"ptxas mega_resident: {regs} registers, {smem} B static shared, "
                  f"{spill} B spilled", flush=True)
    variants = {v: variant_library(v, Path(args.out) / "variants")
                for v in args.variants.split(",") if v}
    records, failed = [], []
    for (name, shape, d, n_temps, n, gibbs, pt_full, pt_interval, sweep_base,
         couplings) in CASES[:1] if args.quick else CASES:
        x = inputs(dev, 7 + d * n_temps, shape, d, n_temps, n, couplings)
        plan = mega.resident_route(dev, *shape, d, n_temps)
        rec = dict(case=name, shape=shape, d=d, slots=n_temps, sweeps=n,
                   plan=None if plan is None else plan._asdict(), card=card)
        if plan is None:
            print(f"{name}: no resident layout", flush=True)
            records.append(rec)
            continue
        hot, cold = hot_cold_slots(x["temps"].cpu().numpy())
        kw = dict(sweep_base=sweep_base, parity=1, gibbs=gibbs, pt_interval=pt_interval,
                  pt_full=pt_full, hot_slot=hot, cold_slot=cold)
        runs = {}
        for route, fn in (("resident", mega.mega_chunk_resident),
                          ("launches", mega.mega_chunk_launches),
                          ("plain", mega.mega_chunk_plain)):
            s = {k: v.clone() for k, v in x.items()}
            e, m, par = fn(*(s[k] for k in ORDER), **kw)
            torch.cuda.synchronize()
            runs[route] = dict(s, e=e, m=m, parity=par)
        diff = {}
        for other in ("launches", "plain"):
            bad = [k for k in STATE + ("m", "parity")
                   if not (torch.equal(runs["resident"][k], runs[other][k])
                           if k != "parity" else runs["resident"][k] == runs[other][k])]
            e_r, e_o = runs["resident"]["e"], runs[other]["e"]
            if other == "plain" and couplings == "gauss":
                if not torch.allclose(e_r, e_o, rtol=1e-5, atol=0):
                    bad.append("e")
            elif not torch.equal(e_r, e_o):
                bad.append("e")
            diff[other] = bad
        rec["mismatch"] = diff
        rec["accepted_swaps"] = int(runs["resident"]["ec"].sum())
        ms = {"resident": [], "launches": []}
        for route in ("resident", "launches", "launches", "resident"):
            fn = mega.mega_chunk_resident if route == "resident" else mega.mega_chunk_launches
            ms[route].append(chunk_ms(lambda s, fn=fn: fn(*(s[k] for k in ORDER), **kw),
                                      x, args.reps))
        if args.variants and name.startswith("flagship"):
            base = _build._lib
            for v in args.variants.split(","):
                _build._lib = variants[v]
                mega.RESIDENT_MAX_THREADS = VARIANT_THREADS.get(v, 1024)
                try:
                    vms = [chunk_ms(lambda s: mega.mega_chunk_resident(
                        *(s[k] for k in ORDER), **kw), x, args.reps) for _ in range(2)]
                finally:
                    _build._lib = base
                    mega.RESIDENT_MAX_THREADS = 1024
                ms[v] = vms
        rec["chunk_ms"] = ms
        rec["us_per_sweep"] = {k: 1e3 * float(np.mean(v)) / n for k, v in ms.items()}
        for v in variants:
            if v in ms:
                print(f"{name}: variant {v}: device us a sweep "
                      f"{1e3 * float(np.mean(ms[v])) / n:.3f}", flush=True)
        ok = not diff["launches"] and not diff["plain"]
        if not ok:
            failed.append(name)
        print(f"{name}: plan {tuple(plan)}; {'bitwise' if ok else 'MISMATCH'} "
              f"{diff}; {rec['accepted_swaps']} swaps accepted; device us a sweep: "
              f"resident {rec['us_per_sweep']['resident']:.3f} "
              f"({', '.join(f'{v:.4f}' for v in ms['resident'])} ms a chunk), launches "
              f"{rec['us_per_sweep']['launches']:.3f} "
              f"({', '.join(f'{v:.4f}' for v in ms['launches'])} ms) on {card}", flush=True)
        records.append(rec)
    if args.calls:
        records.append(dict(case="sample calls", **sample_calls(dev, card)))
    if args.host_profile:
        host_profile(dev)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe_resident.json").write_text(json.dumps(records, indent=1))
    if failed:
        print(f"mismatches: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
