"""Time ``pt_step`` (``csrc/mega.cu``) and the labelling ``fk_link``
(``csrc/fk.cu``) of one or two source trees on one NVIDIA GPU, and check
every form against its plain version.

    python3 tools/probe_pt_link.py [--src LABEL=CSRC_DIR ...] [--out DIR]
                                   [--rounds N] [--quick] [--real]
                                   [--variants V,...] [--only KERNEL]

Each ``--src`` names a directory of the port's CUDA sources (default: this
checkout's ``peapods_tpu_torch/csrc``); give the parent commit's sources
(``git archive`` of it unpacked under a directory ``.gitignore`` lists) and
this checkout's to compare two designs on one card.  The script builds
``mega.cu``, ``fk.cu`` and ``cc_band.cu`` of every source with nvcc for
sm_90a (all at once, into ``--out``), prints each kernel's ``ptxas -v``
registers, and then, ``--rounds`` times (default 2, the sources in order
and then reversed):

* ``pt_step`` on gaussian partials at the main paths' shapes (d,
  slots, partials a slot), a PT event on a random edge every launch:
  the time a launch (CUDA events over warm launches queued behind a sleep
  kernel) and, for this design's entry point, the (e, m) rows bitwise
  against ``ops/mega.py`` ``pt_step_plain`` (the same order); at 4096^2 in
  4 bands the card time of ``e_part.sum(-1)`` and ``m_part.sum(-1)`` too,
  the reduction's yardstick;
* the labelling on random bond graphs near the bond-percolation threshold
  of each lattice (a state byte's bits above the bonds set at random), at
  the main paths' shapes: this design's ``link_plan`` and other tile sizes
  (each launch of a form timed, the form's sum too), and a source's
  earlier one-launch ``fk_link`` (global-memory union-find, its parents
  reset to i before each launch; the reset's own time subtracted).  Each
  form's labels (pointer jumping over its parents) are checked bitwise
  against ``fk_link_plain`` where the graph is small and against the
  first form's otherwise; ``--quick`` times the plan's forms only.

Prints one line per measurement with the card, writes all of them as JSON
to ``--out/probe.json``.  Needs a CUDA device and nvcc; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import kernel_name  # noqa: E402
from peapods_tpu_torch.ops import _build, fk, mega  # noqa: E402

SOURCES = ("mega.cu", "fk.cu", "cc_band.cu")
# (file, anchor, replacement) in this design's sources of each variant of
# the link: no unions in the box (wrong labels), no pointing of a round's
# sites at their roots, no ballot runs (every fast-axis bond united)
# (file, anchor, replacement) of each variant of pt_step: the short rows'
# partials read 4 bytes a load, never 16
PT_VARIANTS = {
    "scalar": [("mega.cu", """      if ((n_blocks & 3) == 0 && ((reinterpret_cast<size_t>(e_part) |
                                   reinterpret_cast<size_t>(m_part)) & 15) == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const bool in = 4 * q < n_blocks;
          const float4 a = in ? reinterpret_cast<const float4*>(e_part + o)[q]
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const int4 c = in ? reinterpret_cast<const int4*>(m_part + o)[q]
                            : make_int4(0, 0, 0, 0);
          v[4 * q] = in ? 0.0f + a.x : 0.0f;
          v[4 * q + 1] = in ? 0.0f + a.y : 0.0f;
          v[4 * q + 2] = in ? 0.0f + a.z : 0.0f;
          v[4 * q + 3] = in ? 0.0f + a.w : 0.0f;
          w[4 * q] = c.x;
          w[4 * q + 1] = c.y;
          w[4 * q + 2] = c.z;
          w[4 * q + 3] = c.w;
        }
      } else {
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          v[l] = l < n_blocks ? 0.0f + e_part[o + l] : 0.0f;
          w[l] = l < n_blocks ? m_part[o + l] : 0;
        }
      }""", """#pragma unroll
      for (int l = 0; l < 32; ++l) {
        v[l] = l < n_blocks ? 0.0f + e_part[o + l] : 0.0f;
        w[l] = l < n_blocks ? m_part[o + l] : 0;
      }""")],
}


def name_of_pt_variant(label):
    v = label.split("-", 1)[1] if "-" in label else None
    return v if v in PT_VARIANTS else None


LINK_VARIANTS = {
    "nounite": [("fk.cu", "        if (j >= 0) tile_unite(P, l, j);\n", "        (void)j;\n")],
    "nocompress": [("fk.cu", "    if (on) P[l] = tile_root(P, l);\n", "")],
    "noballot": [("fk.cu", "    if (on) P[l] = l - (lane - first);", "    if (on) P[l] = l + 0 * first;"),
                 ("fk.cu", "        if (dir == g.fast && x + 1 < ef && lane != 31) continue;"
                  "  // a run of step (1)\n", "")],
}
CORRECT_VARIANTS = ("nocompress", "noballot")
_P, _I = ctypes.c_void_p, ctypes.c_int

# (name, d, slots, partials a slot): 4096^2 in 4 bands, the flagship, config
# 3 (fk_finish's partials), the harness, config 5's ladders, 128^3 in 4 bands
PT_SHAPES = (("space4096", 1, 4, 65536), ("flagship", 1, 24, 32),
             ("config3", 1, 1, 256), ("harness", 128, 16, 16),
             ("config5", 8, 96, 2), ("space128", 1, 8, 2048),
             ("flagship-nopt", 1, 24, 32), ("harness-nopt", 128, 16, 16))
# (name, shape, graphs, bond probabilities): the harness, config 3 (and the
# 256^2 observe run), 32^3 x 16, config 2 (triangular), config 4's and
# config 5's overlap graphs, the 64^2 overlap observe glass, the unsharded
# 4096^2 run; each at its lattice's bond-percolation threshold, the first
# two also sparser and denser (the harness's hot and cold systems)
LINK_SHAPES = (("harness", (64, 64), 2048, (0.5, 0.2, 0.95)),
               ("config3", (256, 256), 1, (0.5, 0.95)),
               ("cubic32", (32, 32, 32), 16, (0.2488,)),
               ("config2", (32, 32), 8, (0.3473,)), ("config4", (8, 8, 8), 256, (0.2488,)),
               ("config5", (16, 16, 16), 384, (0.2488,)),
               ("observe64", (64, 64), 32, (0.5,)), ("space4096", (4096, 4096), 4, (0.5,)))
TILE_SITES = (8192, 4096, 2048, 1024, 512)
# other boxes of the 3D tiled form, each with 512 and 1024 threads a CTA
EXTRA_TILES = {(32, 32, 32): ((2, 8, 32), (4, 8, 32), (8, 8, 32), (8, 8, 16), (8, 8, 8),
                              (16, 16, 8), (4, 16, 16))}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def build(srcs, out, variants=()):
    """``{label: {source: CDLL}}`` and ``{label: ptxas log}``; each variant
    of the link is this design's fk.cu of the last source patched, built as
    ``LABEL-VARIANT``."""
    out.mkdir(parents=True, exist_ok=True)
    jobs = [(label, name, src / name) for label, src in srcs.items() for name in SOURCES]
    last_label, last = list(srcs.items())[-1]
    for v in variants:
        patches = {**LINK_VARIANTS, **PT_VARIANTS}[v]
        source = patches[0][0] if patches[0][0].endswith(".cu") else "fk.cu"
        texts = {f.name: f.read_text() for f in [last / source, *last.glob("*.cuh")]}
        for name, anchor, repl in patches:
            if anchor not in texts[name]:
                raise RuntimeError(f"variant {v}: anchor not found in {name}: {anchor!r}")
            texts[name] = texts[name].replace(anchor, repl)
        vdir = out / f"src-{v}"
        vdir.mkdir(exist_ok=True)
        for name, text in texts.items():
            (vdir / name).write_text(text)
        jobs.append((f"{last_label}-{v}", source, vdir / source))
    procs = []
    for label, name, path in jobs:
        lib = out / f"{label}_{Path(name).stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)]
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


def registers(log):
    """``{kernel: "R registers, S B stack"}`` of a ptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            if "ILb1E" in m.group(1):
                name += "<whole>"
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out[name] = f"{m.group(1)} B stack"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
            name = None
    return out


def events_ms(fn, reps, reset=None):
    """Device time of one ``fn()``, queued behind a sleep kernel; with
    ``reset``, ``reset(); fn()`` less ``reset()`` alone."""
    def timed(body):
        body()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        a.record()
        for _ in range(reps):
            body()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    if reset is None:
        return timed(fn)
    return timed(lambda: (reset(), fn())) - timed(reset)


def pt_inputs(dev, rng, d, s, nb):
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(
        e=torch.from_numpy(rng.standard_normal((d, s, nb)).astype(np.float32) * 8).to(dev),
        m=torch.from_numpy(rng.integers(-256, 256, (d, s, nb)).astype(np.int32)).to(dev),
        sid=torch.from_numpy(np.stack([rng.permutation(s) for _ in range(d)]).astype(
            np.int32)).to(dev),
        temps=torch.from_numpy(np.geomspace(1.5, 3.5, s).astype(np.float32)).to(dev),
        ea=torch.zeros((d, max(s - 1, 0)), **i32), ec=torch.zeros((d, max(s - 1, 0)), **i32),
        rt=torch.zeros((d, s), **i32), ts=torch.zeros((d, s), **i32),
        edge=torch.from_numpy(rng.integers(0, max(s - 1, 1), d).astype(np.int32)).to(dev),
        u=torch.from_numpy(rng.random(d).astype(np.float32)).to(dev),
        sys_temps=torch.zeros((d, s), dtype=torch.float32, device=dev),
        e_row=torch.empty((d, s), dtype=torch.float32, device=dev),
        m_row=torch.empty((d, s), **i32))


def pt_launcher(lib, x, dev, nopt=False):
    """``fn()`` launching the source's pt_step once on ``x``."""
    d, s, nb = x["e"].shape
    fn = lib.peapods_pt_step
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = {k: v.data_ptr() for k, v in x.items()}
    do_pt = int(s > 1 and not nopt)
    tail = [p["e_row"], p["m_row"], s, p["sid"], p["ea"], p["ec"], p["rt"], p["ts"],
            p["temps"], p["edge"] if do_pt else None, p["u"] if do_pt else None,
            p["sys_temps"], d, s, 1, 4096, do_pt, 0, 0, 0, s - 1, stream]
    if lib._peapods_new:
        split = mega.pt_split(nb)
        scratch = mega._pt_scratch(dev, d, s, split)
        fn.argtypes = [_P, _P, _I, _I] + [_P] * 5 + [_I] + [_P] * 9 + [_I] * 9 + [_P]
        args = [p["e"], p["m"], nb, split, *scratch, *tail]
    else:
        fn.argtypes = [_P, _P, _I, _P, _P, _I] + [_P] * 9 + [_I] * 9 + [_P]
        args = [p["e"], p["m"], nb, *tail]
    fn.restype = _I

    def launch():
        code = fn(*args)
        if code:
            raise RuntimeError(f"pt_step: CUDA error {code}")
    return launch


def probe_pt(libs, dev, card, rounds, results):
    rng = np.random.default_rng(10)
    order = list(libs)
    for rnd in range(rounds):
        for label in (order if rnd % 2 == 0 else order[::-1]):
            if "mega.cu" not in libs[label]:
                continue
            lib = libs[label]["mega.cu"]
            if "-" in label and name_of_pt_variant(label) is None:
                continue
            for name, d, s, nb in PT_SHAPES:
                x = pt_inputs(dev, rng, d, s, nb)
                nopt = name.endswith("-nopt")
                launch = pt_launcher(lib, x, dev, nopt)
                ok = None
                if lib._peapods_new:
                    y = {k: v.clone() for k, v in x.items()}
                    launch()
                    mega.pt_step_plain(
                        y["e"], y["m"], y["e_row"], y["m_row"], y["sid"], y["ea"], y["ec"],
                        y["rt"], y["ts"], y["temps"], (y["edge"], y["u"]) if s > 1 else None,
                        y["sys_temps"], do_pt=s > 1 and not nopt, pt_full=False, parity=0,
                        hot_slot=0,
                        cold_slot=s - 1, n_spins=4096)
                    torch.cuda.synchronize()
                    ok = all(torch.equal(x[k], y[k]) for k in
                             ("e_row", "m_row", "sid", "ea", "ec", "rt", "ts", "sys_temps"))
                    if not ok:
                        raise AssertionError(f"pt_step ({label}, {name}) differs from plain")
                ms = events_ms(launch, 200)
                rec = dict(kind="pt_step", source=label, shape=name, d=d, slots=s,
                           partials=nb, split=mega.pt_split(nb) if lib._peapods_new else 1,
                           round=rnd, ms=ms, bitwise_plain=ok)
                if name == "space4096" and rnd == 0:
                    rec["sum_ms"] = events_ms(lambda: (x["e"].sum(-1), x["m"].sum(-1)), 200)
                results.append(rec)
                print(f"[pt_step] {label} {name} (d {d}, {s} slots, {nb} partials): "
                      f"{ms:.5f} ms a launch"
                      + (f", e/m .sum(-1) {rec['sum_ms']:.5f} ms" if "sum_ms" in rec else "")
                      + (", rows bitwise plain" if ok else "") + f" round {rnd} on {card}",
                      flush=True)


def random_state(dev, rng, shape, b, p, tri):
    n_dirs = 3 if (tri or len(shape) == 3) else 2
    n = int(np.prod(shape))
    bonds = (rng.random((b, n, n_dirs)) < p)
    st = (bonds * (1 << np.arange(n_dirs))).sum(-1).astype(np.uint8)
    st |= (rng.integers(0, 8, (b, n)) << 3).astype(np.uint8)  # the "differs" bits
    return torch.from_numpy(st).to(dev), torch.from_numpy(bonds).to(dev), n_dirs


# real FK graphs: (name, Ising arguments, sweeps, sample() options), the
# smoke's runs cut in sweeps: the harness (16 temperatures from 0.1 to 10,
# most of them ordered), config 3 at T_c, 32^3 x 16 near T_c, config 2, the
# unsharded 4096^2 run
REAL_RUNS = (
    ("real-harness", dict(shape=(64, 64), temperatures=np.geomspace(0.1, 10, 16),
                          n_disorder=128), 64,
     dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1)),
    ("real-config3", dict(shape=(256, 256), temperatures=[2.0 / np.log(1 + np.sqrt(2))]),
     512, dict(cluster_update_interval=1, cluster_mode="sw")),
    ("real-cubic32", dict(shape=(32, 32, 32), temperatures=np.geomspace(4.0, 5.0, 16)), 64,
     dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1)),
    ("real-config2", dict(shape=(32, 32), geometry="triangular",
                          temperatures=np.geomspace(3.0, 4.4, 8)), 512,
     dict(cluster_update_interval=2, cluster_mode="wolff")),
    ("real-space4096", dict(shape=(4096, 4096), temperatures=np.geomspace(2.25, 2.29, 4)),
     32, dict(cluster_update_interval=1, cluster_mode="sw", pt_interval=1)),
)


def real_states(dev, only=()):
    """``(name, shape, graphs, state bytes, tri)`` of each real run: its
    equilibrated spins' FK bonds drawn by this checkout's ``fk_bonds``."""
    from chip_smoke import fk_inputs
    from peapods_tpu_torch import Ising

    out = []
    for name, args, sweeps, kw in REAL_RUNS:
        if only and name.removeprefix("real-") not in only:
            continue
        args = dict(args)
        shape = args.pop("shape")
        temps = np.asarray(args.pop("temperatures"), np.float32)
        model = Ising(shape, temperatures=temps, seed=3, device=dev, **args)
        model.sample(sweeps, "metropolis", warmup_ratio=0.0, **kw)
        x = fk_inputs(model, dev, np.random.default_rng(5), False)
        b = x["spins"].shape[0]
        state = fk.fk_bonds(x["spins"], x["j_fwd"], x["temps"], x["kb_words"])
        tri = args.get("geometry") == "triangular"
        torch.cuda.synchronize()
        out.append((name, tuple(shape), b, state, tri))
    return out


def labels_of(parent):
    p = parent.long()
    while True:
        q = p.gather(1, p)
        if torch.equal(q, p):
            return p.to(torch.int32)
        p = q


def link_forms(shape, b, quick):
    """``{form: LinkPlan}`` to time at a shape: the plan, and the other tile
    sizes of the tiled form."""
    dims = _build.dims3(shape)
    plan = fk.link_plan(dims, b)
    forms = {"plan": plan}
    if quick:
        return forms
    other = fk.LINK_THREADS + fk.LINK_THREADS // 2 - plan.threads
    forms[f"t{other}"] = plan._replace(threads=other)
    for sites in TILE_SITES:
        tile = fk._link_tile(dims, sites)
        if tile != dims and tile != plan.tile:
            forms[f"tiled-{sites}"] = fk.LinkPlan(tile, fk._link_threads(dims, tile, b), True)
    for tile in EXTRA_TILES.get(dims, ()):
        for threads in (fk.LINK_THREADS // 2, fk.LINK_THREADS):
            forms[f"box-{'x'.join(map(str, tile))}-t{threads}"] = fk.LinkPlan(tile, threads, True)
    return forms


def graphs(libs, dev, real, only=()):
    """``(name, shape, graphs, state bytes, tri, plain labels or None)``:
    the real runs' graphs, then the random ones (those named in ``only``,
    if given)."""
    rng = np.random.default_rng(11)
    if real:
        for name, shape, b, state, tri in real_states(dev, only):
            yield name, shape, b, state, tri, None
    for name, shape, b, p in ((n, s, b, p) for n, s, b, ps in LINK_SHAPES for p in ps
                              if not only or n in only):
        tri = name.startswith("config2")
        state, bonds, _ = random_state(dev, rng, shape, b, p, tri)
        n = int(np.prod(shape))
        want = (fk.fk_link_plain(bonds, shape).reshape(b, n).to(torch.int32)
                if n * b <= 2 ** 24 else None)
        yield f"{name}@{p}", shape, b, state, tri, want


def probe_link(libs, dev, card, rounds, quick, real, results, only=()):
    order = list(libs)
    for name, shape, b, state, tri, want in graphs(libs, dev, real, only):
        n = int(np.prod(shape))
        dims = _build.dims3(shape)
        iota = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n).contiguous()
        for rnd in range(rounds):
            for label in (order if rnd % 2 == 0 else order[::-1]):
                if "fk.cu" not in libs[label]:
                    continue
                lib = libs[label]["fk.cu"]
                stream = torch.cuda.current_stream(dev).cuda_stream
                parent = torch.empty((b, n), dtype=torch.int32, device=dev)
                if not lib._peapods_new:
                    fn = lib.peapods_fk_link
                    fn.argtypes = [_P, _P] + [_I] * 5 + [_P]
                    fn.restype = _I
                    launch = lambda: fn(state.data_ptr(), parent.data_ptr(), b, *dims,  # noqa: E731
                                        int(tri), stream)
                    parent.copy_(iota)
                    launch()
                    got = labels_of(parent)
                    want = got if want is None else want
                    if not torch.equal(got, want):
                        raise AssertionError(f"{label} fk_link at {name} differs")
                    ms = events_ms(launch, 20, reset=lambda: parent.copy_(iota))
                    results.append(dict(kind="fk_link", source=label, shape=name,
                                        form="global", round=rnd, ms={"fk_link": ms}))
                    print(f"[fk_link] {label} {name} global: {ms:.5f} ms round {rnd} "
                          f"on {card}", flush=True)
                    continue
                variant = label.split("-", 1)[1] if "-" in label else None
                forms = link_forms(shape, b, quick or variant is not None)
                for form, plan in forms.items():
                    calls = _form_calls(lib, stream, state, parent, b, dims, tri, plan)
                    for call in calls.values():
                        call()
                    torch.cuda.synchronize()
                    if variant is None or variant in CORRECT_VARIANTS:
                        got = labels_of(parent)
                        if not torch.equal(got, parent):
                            raise AssertionError(f"{label} {form} at {name}: not flat")
                        want = got if want is None else want
                        if not torch.equal(got, want):
                            raise AssertionError(f"{label} {form} at {name} differs: "
                                                 f"{int((got != want).sum())} labels")
                    parts = _part_times(calls)
                    results.append(dict(kind="fk_link", source=label, shape=name,
                                        form=form, tile=plan.tile, threads=plan.threads,
                                        round=rnd, ms=parts))
                    print(f"[fk_link] {label} {name} {form} (tile {plan.tile}, "
                          f"{plan.threads} threads): " + ", ".join(
                              f"{k} {v:.5f}" for k, v in parts.items())
                          + f" ms; {'timing only' if variant and variant not in CORRECT_VARIANTS else 'labels bitwise'}"
                          f" round {rnd} on {card}", flush=True)


class _NewLib:
    """The entry points of this design's fk.cu under ``launch_link``'s names."""

    def __init__(self, lib):
        for name, args in (("peapods_fk_link", [_P, _P] + [_I] * 9 + [_P]),
                           ("peapods_fk_link_border", [_P, _P] + [_I] * 8 + [_P]),
                           ("peapods_fk_link_flatten", [_P] + [_I] * 2 + [_P])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _I
            setattr(self, name, fn)


def _form_calls(lib, stream, state, parent, b, dims, tri, plan):
    """``{kernel: fn}``: the launches of one labelling in a form, in order."""
    new = _NewLib(lib)
    sp, pp = state.data_ptr(), parent.data_ptr()

    def checked(name, *args):
        def call():
            code = getattr(new, f"peapods_{name}")(*args)
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")
        return call

    calls = {"fk_link": checked("fk_link", sp, pp, b, *dims, int(tri), *plan.tile,
                                plan.threads, stream)}
    if plan.tiled:
        calls["fk_link_border"] = checked("fk_link_border", sp, pp, b, *dims, int(tri),
                                          *plan.tile, stream)
        calls["fk_link_flatten"] = checked("fk_link_flatten", pp, b, int(np.prod(dims)),
                                           stream)
    return calls


def _part_times(calls):
    """Each launch of a form and their sum, ms: a launch timed after the
    ones before it, less their own time (the link rewrites every parent, so
    each repetition starts afresh)."""
    out, before = {}, []
    for name, call in calls.items():
        prev = list(before)
        reset = (lambda: [c() for c in prev]) if prev else None
        out[name] = events_ms(call, 20, reset=reset)
        before.append(call)
    out["sum"] = sum(out.values())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_pt_link"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--real", action="store_true", help="also the graphs of short "
                    "Ising runs (the smoke's shapes)")
    ap.add_argument("--only", choices=("pt_step", "fk_link"), help="probe one kernel")
    ap.add_argument("--shapes", default="", help="comma-separated names of the link's "
                    "graphs to probe (default: all)")
    ap.add_argument("--variants", default="", help="comma-separated: "
                    + ", ".join([*LINK_VARIANTS, *PT_VARIANTS]))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_pt_link: torch sees no CUDA device", file=sys.stderr)
        return 1
    srcs = dict(s.split("=", 1) for s in a.src) or {"this": str(_build.SOURCE_DIR)}
    srcs = {k: Path(v).resolve() for k, v in srcs.items()}
    out = Path(a.out)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    variants = [v for v in a.variants.split(",") if v]
    libs, logs = build(srcs, out, variants)
    for label, ls in libs.items():
        new = label != "parent" and ("fk.cu" not in ls
                                     or hasattr(ls["fk.cu"], "peapods_fk_link_border"))
        for lib in ls.values():
            lib._peapods_new = new
        regs = registers(logs[label])
        print(f"[ptxas] {label}: " + "; ".join(
            f"{k} {regs[k]}" for k in sorted(regs) if k.startswith(("pt_step", "fk_link",
                                                                     "cc_band_link"))),
              flush=True)
    results = [dict(kind="ptxas", source=k, registers=registers(v)) for k, v in logs.items()]
    if a.only != "fk_link":
        probe_pt(libs, dev, card, a.rounds, results)
    if a.only != "pt_step":
        probe_link(libs, dev, card, a.rounds, a.quick, a.real, results,
               [x for x in a.shapes.split(",") if x])
    (out / "probe.json").write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {out / 'probe.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
