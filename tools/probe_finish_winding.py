"""Time ``fk_finish`` (``csrc/fk.cu``) and the winding flags
(``csrc/winding.cu``) of two source trees side by side on one NVIDIA GPU,
on the same states, and count the breadth-first levels of the first
winding design.

    python3 tools/probe_finish_winding.py --src old=CSRC_DIR --src new=CSRC_DIR
                                          [--out DIR] [--rounds N] [--only KERNEL]
                                          [--forms] [--ctas N,...] [--host]

Each ``--src`` names a directory of the port's CUDA sources; the first
design (``fk_finish`` one site a thread, the winding settled breadth first
in one CTA a graph) is told from the second by its entry points, so give
the parent commit's sources (``git archive`` of it unpacked under a
directory ``.gitignore`` lists) and this checkout's.  The script builds
``fk.cu`` and ``winding.cu`` of every source with nvcc for sm_90a (all at
once, into ``--out``) and prints their ``ptxas -v`` registers.  The states
are short ``Ising`` runs of ``chip_smoke.py``'s shapes, drawn by this
checkout's kernels:

* ``fk_finish``: the FK bonds and labels of config 3 (256^2 at T_c), the
  harness (64^2 x 2048 graphs), 32^3 x 16, config 2 (32^2 triangular x 8)
  and the unsharded 4096^2 x 4 run's state; SW with the measurement, as
  the update runs it, and (``--forms``) Wolff, no measurement and the
  first design's observe form (the labels written).  Both designs' spins
  and partials are checked bitwise against ``fk_finish_plain`` (per block
  of 256 sites).  ``--ctas`` also times this checkout's design with each
  CTA count that ends the halving of a CTA's partial blocks
  (``ops/fk.py`` ``FINISH_CTAS``).
* the winding: the masks and labels of FK observe at 256^2 T_c (several
  sweeps), at the harness shape, of 32 graphs of 64^2 (the overlap
  observe's count), and of one 2048^2 graph near the bond-percolation
  threshold (the first design refuses it).  Each design's flags are checked
  against ``cluster.winding_flags``.  For the first design the breadth-first
  levels are counted (the rounds of the plain settle loop from the same
  roots) and its time is divided by them.

Times are device times of one call (CUDA events over warm calls queued
behind a sleep kernel), ``--rounds`` times in the order of the sources and
then reversed.  ``--host`` instead profiles the host (cProfile) over 256
sweeps of the 256^2 SW observe run at T_c on this checkout's kernels: the
wall time a sweep and the functions that take it.  Prints one line per measurement with the card, writes all
of them as JSON to ``--out/probe.json``.  Needs a CUDA device and nvcc;
imports nothing of JAX.
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

from chip_smoke import card_line, fk_inputs  # noqa: E402
from peapods_tpu_torch.ops import _build, cluster, fk, winding  # noqa: E402
from probe_pt_link import events_ms, registers  # noqa: E402

SOURCES = ("fk.cu", "winding.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
T_C = 2.0 / np.log(1.0 + np.sqrt(2.0))

# (name, Ising arguments, sweeps, sample() options): chip_smoke.py's shapes
FINISH_RUNS = (
    ("config3", dict(shape=(256, 256), temperatures=[T_C]), 512,
     dict(cluster_update_interval=1, cluster_mode="sw")),
    ("harness", dict(shape=(64, 64), temperatures=np.geomspace(0.1, 10, 16),
                     n_disorder=128), 64,
     dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1)),
    ("cubic32", dict(shape=(32, 32, 32), temperatures=np.geomspace(4.0, 5.0, 16)), 64,
     dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1)),
    ("config2", dict(shape=(32, 32), geometry="triangular",
                     temperatures=np.geomspace(3.0, 4.4, 8)), 512,
     dict(cluster_update_interval=2, cluster_mode="wolff")),
    ("space4096", dict(shape=(4096, 4096), temperatures=np.geomspace(2.25, 2.29, 4)), 32,
     dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1)),
)
# (name, Ising arguments, sweeps, graphs observed): the 256^2 observe run's
# state at T_c, observed `graphs` times; the harness observe's; 32 graphs of
# 64^2 at T_c (the 64^2 overlap observe's count)
WINDING_RUNS = (
    ("observe256", dict(shape=(256, 256), temperatures=[T_C]), 256, 8),
    ("harness_observe", dict(shape=(64, 64), temperatures=np.geomspace(0.1, 10, 16),
                             n_disorder=128), 32, 1),
    ("observe64x32", dict(shape=(64, 64), temperatures=[T_C], n_disorder=32), 256, 1),
)


def build(srcs, out):
    """``{label: {source: CDLL}}`` and ``{label: ptxas log}``."""
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for label, src in srcs.items():
        for name in SOURCES:
            lib = out / f"{label}_{Path(name).stem}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / name)]
            procs.append((label, name, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for label, name, lib, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label} {name}:\n{text}")
        libs.setdefault(label, {})[name] = ctypes.CDLL(str(lib))
        logs[label] = logs.get(label, "") + text
    return libs, logs


def bind(lib, name, args):
    """``lib``'s entry point ``name`` with its argument types."""
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = args, _I
    return fn


def is_first_design(libs):
    return not hasattr(libs["winding.cu"], "peapods_winding_wrap")


def model_state(name, args, sweeps, kw, dev):
    from peapods_tpu_torch import Ising

    args = dict(args)
    shape = args.pop("shape")
    temps = np.asarray(args.pop("temperatures"), np.float32)
    model = Ising(shape, temperatures=temps, seed=3, device=dev, **args)
    model.sample(sweeps, "metropolis", warmup_ratio=0.0, **kw)
    torch.cuda.synchronize()
    return model


def finish_launcher(libs, x, state, parent, wolff, measure, observe=False):
    """``(fn, outputs)``: one launch of a design's fk_finish on copies of
    ``x``'s spins; the outputs the launch writes (spins, partials)."""
    b, shape = x["spins"].shape[0], tuple(x["spins"].shape[1:])
    n, nd = x["spins"][0].numel(), x["j_fwd"].shape[-1]
    d = x["j_fwd"].shape[0]
    tri = len(shape) == 2 and nd == 3
    dev = x["spins"].device
    spins = x["spins"].clone()
    nb = (n + 255) // 256
    e = torch.empty((b, nb), dtype=torch.float32, device=dev) if measure else None
    m = torch.empty((b, nb), dtype=torch.int32, device=dev) if measure else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    scal = x["scalars_wolff"] if wolff else x["scalars"]
    if is_first_design(libs):
        fn = bind(libs["fk.cu"], "peapods_fk_finish", [_P] * 8 + [_I] * 8 + [_P])
        labels = torch.empty((b, n), dtype=torch.int32, device=dev) if observe else None
        args = (spins.data_ptr(), state.data_ptr(), parent.data_ptr(), ptr(labels),
                x["j_fwd"].data_ptr(), scal.data_ptr(), ptr(e), ptr(m), b, b // d,
                *_build.dims3(shape), int(tri), int(wolff), int(observe), stream)
    else:
        fn = bind(libs["fk.cu"], "peapods_fk_finish", [_P] * 8 + [_I] * 3 + [_P])
        words = fk.finish_words(_build.dims3(shape), nd if measure else 0, tri, b)
        args = (spins.data_ptr(), state.data_ptr(), parent.data_ptr(), x["j_fwd"].data_ptr(),
                scal.data_ptr(), ptr(e), ptr(m), words.ctypes.data, b, b // d, int(wolff),
                stream)
    return (lambda: _build.check(fn(*args), "fk_finish")), (spins, e, m)


def finish_bound(b, n, nd, d, measure):
    """The least bytes of one launch over 3.35 TB/s, ms: labels (4 B) and
    spins (1 B read, 1 written) a site; measuring, the state byte and the
    realizations' couplings (read once) and the partials written."""
    by = 6 * b * n + 12 * b
    if measure:
        by += b * n + 4 * nd * d * n + 8 * b * ((n + 255) // 256)
    return by / 3.35e12 * 1e3


def probe_ctas(x, state, parent, ctas, name, card, results):
    """``fk_finish`` (SW, measuring) of this checkout's library on one state
    with each CTA count in ``ctas`` as ``FINISH_CTAS``, bitwise plain."""
    b, n = x["spins"].shape[0], x["spins"][0].numel()
    p = x["spins"].clone()
    want = fk.fk_finish_plain(p, parent, x["j_fwd"], x["scalars"], wolff=False,
                              with_measure=True, blocks=True)
    kept = fk.FINISH_CTAS
    try:
        for target in ctas:
            fk.FINISH_CTAS = target
            fk.finish_tile.cache_clear()
            fk.finish_words.cache_clear()
            spins = x["spins"].clone()

            def launch():
                return fk.fk_finish(spins, state, parent, x["j_fwd"], x["scalars"], wolff=False,
                                    with_measure=True)
            got = launch()
            torch.cuda.synchronize()
            if not (torch.equal(spins, p) and all(map(torch.equal, got, want))):
                raise AssertionError(f"fk_finish at {name}, {target} CTAs, differs from plain")
            shape = tuple(x["spins"].shape[1:])
            parts = int(fk.finish_words(_build.dims3(shape), x["j_fwd"].shape[-1],
                                        len(shape) == 2 and x["j_fwd"].shape[-1] == 3, b)[5])
            ms = events_ms(launch, 50 if n * b < 2**24 else 10)
            results.append(dict(kind="fk_finish_ctas", state=name, ctas=target, parts=parts,
                                ms=ms))
            print(f"[fk_finish ctas] {name} ({b} x {n} sites) FINISH_CTAS {target}: {parts} "
                  f"partial blocks a CTA, {ms:.5f} ms a launch, bitwise plain on {card}",
                  flush=True)
    finally:
        fk.FINISH_CTAS = kept
        fk.finish_tile.cache_clear()
        fk.finish_words.cache_clear()


def probe_finish(libs, dev, card, rounds, forms, results, ctas=()):
    rng = np.random.default_rng(12)
    order = list(libs)
    for name, args, sweeps, kw in FINISH_RUNS:
        model = model_state(name, args, sweeps, kw, dev)
        x = fk_inputs(model, dev, rng, False)
        from peapods_tpu_torch.engine import seeds

        b, n = x["spins"].shape[0], x["spins"][0].numel()
        kf = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
        x["scalars_wolff"] = torch.from_numpy(seeds.fk_scalars(kf, n, wolff=True)).to(dev)
        state, parent = fk._bonds_and_link(x["spins"], x["j_fwd"], x["temps"], x["kb_words"])
        del model
        if ctas:
            probe_ctas(x, state, parent, ctas, name, card, results)
        cases = [("sw", False, True, False)]
        if forms:
            cases += [("wolff", True, True, False), ("sw-nomeasure", False, False, False),
                      ("observe-form", False, False, True)]
        for case, wolff, measure, observe in cases:
            want = None
            if not observe:
                p = x["spins"].clone()
                want = (p, *fk.fk_finish_plain(p, parent, x["j_fwd"],
                                               x["scalars_wolff"] if wolff else x["scalars"],
                                               wolff=wolff, with_measure=measure, blocks=True))
            for rnd in range(rounds):
                for label in (order if rnd % 2 == 0 else order[::-1]):
                    if observe and not is_first_design(libs[label]):
                        continue  # the parents are the labels: no launch
                    fn, outs = finish_launcher(libs[label], x, state, parent, wolff, measure,
                                               observe)
                    fn()
                    torch.cuda.synchronize()
                    ok = None
                    if want is not None:
                        ok = all(a is None and w is None or torch.equal(a, w)
                                 for a, w in zip(outs, want))
                        if not ok:
                            raise AssertionError(f"fk_finish {label} {name} {case} differs "
                                                 "from fk_finish_plain")
                    ms = events_ms(fn, 50 if n * b < 2**24 else 10)
                    bms = finish_bound(b, n, x["j_fwd"].shape[-1], x["j_fwd"].shape[0],
                                       measure)
                    results.append(dict(kind="fk_finish", source=label, state=name, case=case,
                                        round=rnd, ms=ms, bound_ms=bms, graphs=b, sites=n,
                                        bitwise_plain=ok))
                    print(f"[fk_finish] {label} {name} ({b} x {n} sites) {case}: {ms:.5f} ms a "
                          f"launch (bound {bms:.5f} ms, bytes)"
                          + (", spins and partials bitwise plain" if ok else "")
                          + f" round {rnd} on {card}", flush=True)
        del x, state, parent
        torch.cuda.empty_cache()


def winding_launcher(libs, masks, labels, shape):
    """``(fn, out, err)``: one call of a design's winding flags."""
    b = labels.shape[0]
    dev = masks.device
    out = torch.zeros(b, dtype=torch.uint8, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = libs["winding.cu"]
    if is_first_design(libs):
        fn = bind(lib, "peapods_winding", [_P] * 6 + [_I] * 3 + [_P])
        disp = torch.empty((b, labels.shape[1]), dtype=torch.int64, device=dev)
        queue = torch.empty((b, labels.shape[1]), dtype=torch.int32, device=dev)
        args = (masks.data_ptr(), labels.data_ptr(), disp.data_ptr(), queue.data_ptr(),
                out.data_ptr(), err.data_ptr(), b, *shape, stream)
        return (lambda: _build.check(fn(*args), "winding")), out, err
    ns = SimpleNamespace(**{k: bind(lib, k, v) for k, v in _build._SIGNATURES.items()
                            if k.startswith("peapods_winding")})

    def call():
        winding.launch_winding(ns, stream, masks, labels, out, err, shape)
    return call, out, err


def bfs_levels(masks, labels, shape):
    """int [B]: the rounds of the plain settle loop from the roots (labels
    == site) until every site of each graph is settled: the first design's
    breadth-first levels (it runs one more, which settles nothing)."""
    from peapods_tpu_torch.ops.lattice import neighbour_values

    n = labels.shape[1]
    settled = labels == torch.arange(n, device=labels.device)
    fwd = [masks[..., d] for d in range(2)]
    bwd = [neighbour_values(masks[..., d], shape, -np.eye(2, dtype=np.int64)[d])
           for d in range(2)]
    levels = torch.zeros(labels.shape[0], dtype=torch.int64, device=labels.device)
    while not bool(settled.all()):
        new = settled.clone()
        for d, off in enumerate(np.eye(2, dtype=np.int64)):
            new |= fwd[d] & neighbour_values(settled, shape, off)
            new |= bwd[d] & neighbour_values(settled, shape, -off)
        if torch.equal(new, settled):
            raise ValueError("unsettled sites")
        levels += (new != settled).any(-1)
        settled = new
    return levels


def winding_states(dev):
    """``(name, masks, labels, shape)`` of each state: FK observe's graphs
    (this checkout's kernels) of the runs, then one 2048^2 graph near
    p_c = 1/2."""
    kw = dict(cluster_update_interval=1, cluster_mode="sw")
    rng = np.random.default_rng(13)
    for name, args, sweeps, graphs in WINDING_RUNS:
        model = model_state(name, args, sweeps, kw, dev)
        for k in range(graphs):
            x = fk_inputs(model, dev, rng, False)
            labels, masks = fk.fk_observe(x["spins"], x["j_fwd"], x["temps"], x["kb_words"])
            b = labels.shape[0]
            yield f"{name}#{k}", masks, labels.view(b, -1), tuple(args["shape"])
            model.sample(1, "metropolis", warmup_ratio=0.0, **kw)
    g = torch.Generator(device=dev).manual_seed(2048)
    masks = torch.rand((1, 2048 * 2048, 2), device=dev, generator=g) < 0.5
    yield "random2048@0.5", masks, cluster.connected_components(masks, (2048, 2048)), (2048,
                                                                                     2048)


def probe_winding(libs, dev, card, rounds, results):
    order = list(libs)
    for name, masks, labels, shape in winding_states(dev):
        b, n = labels.shape
        px, py = cluster.winding_flags(masks, labels, shape)
        levels = bfs_levels(masks, labels, shape)
        bms = (6 * b * n + b) / 3.35e12 * 1e3
        for rnd in range(rounds):
            for label in (order if rnd % 2 == 0 else order[::-1]):
                first = is_first_design(libs[label])
                if first and n > 227 * 1024 * 8:
                    continue  # the first design refuses the graph
                fn, out, err = winding_launcher(libs[label], masks, labels, shape)
                fn()
                torch.cuda.synchronize()
                ok = (torch.equal((out & 1) != 0, px) and torch.equal((out & 2) != 0, py)
                      and int(err) == 0)
                if not ok:
                    raise AssertionError(f"winding {label} {name} differs from plain")
                ms = events_ms(fn, 20 if n * b < 2**24 else 5)
                rec = dict(kind="winding", source=label, state=name, round=rnd, ms=ms,
                           bound_ms=bms, graphs=b, sites=n, wx=int(px.sum()),
                           wy=int(py.sum()), bitwise_plain=ok)
                extra = ""
                if first:
                    rec["levels_max"] = int(levels.max())
                    rec["us_per_level"] = 1e3 * ms / (int(levels.max()) + 1)
                    extra = (f"; breadth-first levels {int(levels.max())} (mean over graphs "
                             f"{float(levels.float().mean()):.1f}), {rec['us_per_level']:.3f} "
                             "us a level")
                results.append(rec)
                print(f"[winding] {label} {name} ({b} x {n} sites, {rec['wx']} / {rec['wy']} "
                      f"wind along x / y): {ms:.5f} ms a call (bound {bms:.6f} ms, bytes)"
                      f"{extra}, flags bitwise plain round {rnd} on {card}", flush=True)


def probe_host(dev, card, results, n=256):
    """cProfile over ``n`` sweeps of the 256^2 SW observe run at T_c (warm):
    the wall time a sweep, and the functions with the most own time."""
    import cProfile
    import pstats
    import time

    kw = dict(cluster_update_interval=1, cluster_mode="sw", cluster_action="observe")
    model = model_state("observe256", dict(shape=(256, 256), temperatures=[T_C]), n, kw, dev)
    kw["warmup_ratio"] = 0.0
    t0 = time.perf_counter()
    model.sample(n, "metropolis", **kw)
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6 / n
    prof = cProfile.Profile()
    prof.enable()
    model.sample(n, "metropolis", **kw)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    total = stats.total_tt * 1e6 / n
    rows = sorted(((v[2] * 1e6 / n, v[3] * 1e6 / n, f"{k[0].rsplit('/', 1)[-1]}:{k[1]} {k[2]}")
                   for k, v in stats.stats.items()), reverse=True)
    print(f"[host] 256^2 SW observe: {plain_us:.1f} us of wall time a sweep unprofiled, "
          f"{total:.1f} profiled on {card}; own / cumulative us a sweep:", flush=True)
    for own, cum, name in rows[:25]:
        print(f"[host]   {own:8.2f} {cum:9.2f}  {name}", flush=True)
    results.append(dict(kind="host", wall_us=plain_us, profiled_us=total,
                        top=[dict(own_us=o, cum_us=c, fn=f) for o, c, f in rows[:40]]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_finish_winding"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--forms", action="store_true", help="also Wolff, no measurement and "
                    "the first design's observe form of fk_finish")
    ap.add_argument("--only", choices=("fk_finish", "winding"), help="probe one kernel")
    ap.add_argument("--ctas", default="", help="comma-separated CTA counts to time this "
                    "checkout's fk_finish with (FINISH_CTAS)")
    ap.add_argument("--host", action="store_true", help="profile the host of the 256^2 "
                    "observe run instead")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_finish_winding: torch sees no CUDA device", file=sys.stderr)
        return 1
    if a.host:
        results = []
        probe_host(torch.device("cuda", 0), card_line(), results)
        Path(a.out).mkdir(parents=True, exist_ok=True)
        (Path(a.out) / "host.json").write_text(json.dumps(results))
        return 0
    srcs = dict(s.split("=", 1) for s in a.src) or {"this": str(_build.SOURCE_DIR)}
    srcs = {k: Path(v).resolve() for k, v in srcs.items()}
    out = Path(a.out)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    libs, logs = build(srcs, out)
    for label, log in logs.items():
        regs = registers(log)
        print(f"[ptxas] {label}: " + "; ".join(
            f"{k} {regs[k]}" for k in sorted(regs) if k.startswith(("fk_finish", "winding"))),
            flush=True)
    results = [dict(kind="ptxas", source=k, registers=registers(v)) for k, v in logs.items()]
    if a.only != "winding":
        probe_finish(libs, dev, card, a.rounds, a.forms, results,
                     [int(c) for c in a.ctas.split(",") if c])
    if a.only != "fk_finish":
        probe_winding(libs, dev, card, a.rounds, results)
    (out / "probe.json").write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {out / 'probe.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
