"""Time the bond kernels of the Joerg and CMR overlap moves
(``csrc/overlap.cu`` ``ov_bonds``: Joerg's bonds or CMR's blue ones and
the Wolff seed; ``ov_mid``: CMR's blue flip and grey bonds) of two source
trees side by side on one NVIDIA GPU, with variants that cure one defect
of the first design or take one part of the redesign away, and count each
kernel's SASS integer-division sequences.

    python3 tools/probe_overlap.py --src old=CSRC_DIR --src new=CSRC_DIR
                                   [--out DIR] [--rounds N] [--variants a,b,...]
                                   [--shapes a,b,...] [--json PATH]

Each ``--src`` names a directory of the port's CUDA sources; the first
design (a thread a group of four sites of one task, ``fwd_site``'s runtime
divisions, byte loads, the couplings, J / T and exp again for every task
and bond, a serial Wolff seed, a parent written a site; ``ov_mid`` deciding
each blue flip 1 + nd times a site by ``find_root``, ``nonsingleton``'s
divisions and the coin, a parent2 written a site) is told from the
redesign by its source.  Give the parent commit's sources (``git archive``
of it unpacked under a directory ``.gitignore`` lists) and this
checkout's.  The script builds ``overlap.cu`` of every source as it is and
patched into each variant of its design, all with nvcc for sm_90a at once
(into ``--out``), and prints each kernel's ``ptxas -v`` registers and, from
``cuobjdump -sass``, its static instructions and integer-division sequences
(``I2F.U32.RP``).

Variants of the first design, one defect cured each:

* ``o-nodiv``: each forward neighbour at a clamped ``i + stride`` and
  ``nonsingleton``'s backward ones at ``i - stride``: no division (wrong
  values, the loads kept);
* ``o-noparent``: no ``parent`` / ``parent2`` written (bitwise);
* ``o-ballot``: Joerg's Wolff seed by one warp and two ballots, as
  ``houdn_bonds`` finds its own (bitwise).

Variants of the redesign, one part taken away each:

* ``n-div``: the sites' coordinates and the task's temperature by runtime
  divisions again;
* ``n-per1``: one task a thread;
* ``n-lazy``: each bond's probability (its exp) drawn only where the bond
  can be active, in a branch, for every task, and compared as a float
  (groups of unit couplings keep their threshold);
* ``n-pertask``: J / T and the probabilities taken for every task, not
  once a temperature;
* ``n-reflip``: ``ov_mid`` deciding each forward neighbour's blue flip
  again for every bond (one parent load and, SW, the coin) and testing
  sat_a != sat_b on the flipped spins, as the first design did;
* ``n-nodraw``: no Philox rounds, the counter words taken as the uniforms
  (wrong values): the draws' share of the time.

The states are random +-1 spins at the replica path's shapes: config 5
(16^3 gaussian, 8 realizations, R = 4, 24 temperatures: 384 tasks),
config 4's (8^3 +-J: the ``cmr+houd4`` runs' pair tasks) and the 64^2
glass of overlap observe (4 realizations, R = 2, 8 temperatures).  Each
kernel is timed per move kind and form: ``ov_bonds`` for Joerg and CMR,
Wolff and SW (the observe form launches the SW one), ``ov_mid`` Wolff,
SW, and SW writing the blue labels.  Every build and every variant that
keeps the function is held bitwise to the plain version
(``overlap.bond_states_plain``: the state bytes, state2 bytes and seeds;
the blue labels against the plain labelling).  Times are device times of
one launch (CUDA events over warm launches queued behind a sleep kernel),
``--rounds`` times with the builds in order and then reversed.  Prints one
line per measurement with the card, writes all of them as JSON to
``--json`` (default ``--out/probe.json``).  Needs a CUDA device, nvcc and
cuobjdump; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import HBM_BYTES_S, card_line  # noqa: E402
from peapods_tpu_torch.engine import seeds  # noqa: E402
from peapods_tpu_torch.ops import _build, fk, overlap  # noqa: E402
from peapods_tpu_torch.ops.cluster import connected_components  # noqa: E402
from probe_pt_link import events_ms  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = ("ov_bonds", "ov_mid")

O_NODIV = [
    ("      const int f = fwd_site(i, g, dir);\n      const int af = k.a[f];",
     "      const int f = min(i + g.stride[dir], n - 1);\n      const int af = k.a[f];"),
    ("    const bool fi = blue_flip(P, S, i, g, wolff, seed_root, s0, s1);",
     "    const bool fi = blue_flip_nodiv(P, S, i, g, wolff, seed_root, s0, s1, n);"),
    ("      const int f = fwd_site(i, g, dir);\n      const int sgn = fi != blue_flip(P, S, f, g, "
     "wolff, seed_root, s0, s1) ? -1 : 1;",
     "      const int f = min(i + g.stride[dir], n - 1);\n      const int sgn = fi != "
     "blue_flip_nodiv(P, S, f, g, wolff, seed_root, s0, s1, n) ? -1 : 1;"),
    ("__global__ void __launch_bounds__(kThreads)\nov_mid_kernel(",
     "__device__ __forceinline__ bool blue_flip_nodiv(int32_t* P, const uint8_t* S, int j,\n"
     "    const Dims& g, int wolff, int seed_root, uint32_t s0, uint32_t s1, int n) {\n"
     "  const int r = find_root(P, j);\n  if (wolff) return r == seed_root;\n"
     "  if (!(salted_uniform(static_cast<uint32_t>(r), s0, s1) < 0.5f)) return false;\n"
     "  if (S[j] & ((1u << g.ndir) - 1u)) return true;\n"
     "  for (int dir = 0; dir < g.ndir; ++dir)\n"
     "    if ((S[max(j - g.stride[dir], 0)] >> dir) & 1u) return true;\n  return false;\n}\n\n"
     "__global__ void __launch_bounds__(kThreads)\nov_mid_kernel("),
]
O_NOPARENT = [("    parent[base + i] = i;\n  }\n}\n\n// CMR's blue flip", "  }\n}\n\n// CMR's blue flip"),
              ("    parent2[base + i] = i;\n", "")]
O_BALLOT = [(
    "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n    int seed = n;  // none\n"
    "    if (kind == kCmr) {\n      seed = scal[6 * b + 4];\n    } else if (wolff) {  // Joerg\n"
    "      for (int p = 0; p < kProbes; ++p) {\n        const int s = probes[kProbes * b + p];\n"
    "        if (k.a[s] != k.b[s]) {\n          seed = s;\n          break;\n        }\n"
    "      }\n    }\n    seeds[b] = seed;\n  }\n",
    "  if (blockIdx.x == 0 && threadIdx.x < 32) {\n    int seed = n;  // none\n"
    "    if (kind == kCmr) {\n      seed = scal[6 * b + 4];\n    } else if (wolff) {  // Joerg\n"
    "      const int32_t* pr = probes + kProbes * b;\n      const int l = threadIdx.x;\n"
    "      const unsigned lo = __ballot_sync(0xffffffffu, k.a[pr[l]] != k.b[pr[l]]);\n"
    "      const unsigned hi = __ballot_sync(0xffffffffu, k.a[pr[32 + l]] != k.b[pr[32 + l]]);\n"
    "      if (lo != 0u)\n        seed = pr[__ffs(lo) - 1];\n      else if (hi != 0u)\n"
    "        seed = pr[32 + __ffs(hi) - 1];\n    }\n    if (threadIdx.x == 0) seeds[b] = seed;\n"
    "  }\n")]
N_DIV = [("  const int line = fast_div(i, g.m[0], g.s[0]);", "  const int line = i / g.lf;"),
         ("  c.ca = ND == 3 ? fast_div(line, g.m[1], g.s[1]) : 0;",
          "  c.ca = ND == 3 ? line / g.lb : 0;"),
         ("  const int t = fast_div(w, g.m[2], g.s[2]);", "  const int t = w / g.G;")]
N_LAZY = [("  uint32_t pos[ND];\n  uint32_t neg[ND];\n};",
           "  uint32_t pos[ND];\n  uint32_t neg[ND];\n  int which;\n  bool lazy;\n};"),
          ("  } else {\n#pragma unroll\n"
           "    for (int v = 0; v < 4 * ND; ++v) x.thr[v] = threshold24(bond_prob(which, x.jt[v]));\n  }\n",
           "  }\n  x.lazy = unit != (1u << (4 * ND)) - 1u;\n  x.which = which;\n"),
          ("    if ((uw[q] >> 8) < x.thr[q * ND + dir]) on |= 1u << (8 * q);",
           "    if (x.lazy ? ((cand >> (8 * q)) & 1u) &&\n"
           "                     uniform24(uw[q]) < bond_prob(x.which, x.jt[q * ND + dir])\n"
           "               : (uw[q] >> 8) < x.thr[q * ND + dir])\n"
           "      on |= 1u << (8 * q);")]
N_PERTASK = [("      if (t != tp) {\n        tp = t;\n        take_jt<ND>(jt, jc, __ldg(temps + t), unit, kKind",
              "      if (true) {\n        tp = t;\n        take_jt<ND>(jt, jc, __ldg(temps + t), unit, kKind"),
             ("      if (t != tp) {\n        tp = t;\n        take_jt<ND>(jt, jc, __ldg(temps + t), unit, kProbGrey",
              "      if (true) {\n        tp = t;\n        take_jt<ND>(jt, jc, __ldg(temps + t), unit, kProbGrey")]
N_NODRAW = [("  const uint4 r = philox4x32_10(k0, k1, static_cast<uint32_t>(first + dir),\n"
             "                                static_cast<uint32_t>(grp), 0u, 0u);",
             "  const uint4 r = make_uint4(k0 ^ grp, k1 + dir, k0 + first, k1 ^ grp);")]
N_REFLIP = [(
    "        const uint32_t cand = differ(a.w ^ a.f[d], b.w ^ b.f[d]) & (jt.pos[d] | jt.neg[d]) &\n"
    "                              ~blue;\n",
    "        uint32_t nf = 0;  // the forward neighbours' blue flips, decided again\n"
    "#pragma unroll\n        for (int q = 0; q < 4; ++q) {\n"
    "          const int j = site_step<ND>(g, site_at<ND>(g, x.i0 + q < g.n ? x.i0 + q : x.i0), "
    "d, false);\n          const int lj = __ldg(P + j);\n"
    "          const bool f = kWolff ? lj == sh.root[k]\n"
    "                                : salted_uniform(static_cast<uint32_t>(lj), sh.s0[k], "
    "sh.s1[k]) < 0.5f &&\n"
    "                                      (lj != j || (__ldg(S + j) & 7u) != 0);\n"
    "          if (f) nf |= 1u << (8 * q);\n        }\n"
    "        const uint32_t sg = (fl ^ nf) << 7;  // where the bond's sign flips\n"
    "        const uint32_t sa = satisfied<ND>(jt, d, differ(a.w ^ sg, a.f[d]));\n"
    "        const uint32_t sb = satisfied<ND>(jt, d, differ(b.w ^ sg, b.f[d]));\n"
    "        const uint32_t cand = (sa ^ sb) & ~blue;\n")]

# name: (design, source edits, tasks a thread or None, keeps the function)
VARIANTS = {
    "o-nodiv": ("first", O_NODIV, None, False),
    "o-noparent": ("first", O_NOPARENT, None, True),
    "o-ballot": ("first", O_BALLOT, None, True),
    "n-div": ("redesign", N_DIV, None, True),
    "n-per1": ("redesign", [], 1, True),
    "n-lazy": ("redesign", N_LAZY, None, True),
    "n-pertask": ("redesign", N_PERTASK, None, True),
    "n-reflip": ("redesign", N_REFLIP, None, True),
    "n-nodraw": ("redesign", N_NODRAW, None, False),
}

# (name, shape, realizations, replicas, temperatures, their range, couplings)
SHAPES = (("config5", (16, 16, 16), 8, 4, 24, (0.8, 2.0), "gauss"),
          ("config4", (8, 8, 8), 8, 4, 24, (0.9, 2.2), "pm"),
          ("glass64", (64, 64), 4, 2, 8, (0.8, 2.0), "pm"))
# (kernel, kind, wolff, blue labels): the forms timed
FORMS = (("ov_bonds", "jorg", True, False), ("ov_bonds", "jorg", False, False),
         ("ov_bonds", "cmr", True, False), ("ov_bonds", "cmr", False, False),
         ("ov_mid", "cmr", True, False), ("ov_mid", "cmr", False, False),
         ("ov_mid", "cmr", False, True))


def design(csrc: Path) -> str:
    return "redesign" if "OvWalk" in (csrc / "overlap.cu").read_text() else "first"


def builds(sources, out, variants):
    """``{(label, variant): (source path or None, design)}``: each source's
    base build and the variants of its design that edit the source (a
    host-plan variant shares its base's build); a variant whose anchors are
    not found stops the probe."""
    todo = {}
    for label, csrc in sources:
        own = design(csrc)
        text = (csrc / "overlap.cu").read_text()
        for variant in ("base", *variants):
            edits = []
            if variant != "base":
                aim, edits, _, _ = VARIANTS[variant]
                if aim != own:
                    continue
                gone = [old.splitlines()[0] for old, _ in edits if text.count(old) != 1]
                if gone:
                    raise SystemExit(f"probe_overlap: {variant} does not apply to {csrc}: "
                                     f"{gone}")
                if not edits:
                    todo[(label, variant)] = (None, own)
                    continue
            d = out / label / variant
            d.mkdir(parents=True, exist_ok=True)
            for h in csrc.glob("*.cuh"):
                shutil.copy(h, d / h.name)
            src = text
            for old, new in edits:
                src = src.replace(old, new)
            (d / "overlap.cu").write_text(src)
            todo[(label, variant)] = (d / "overlap.cu", own)
    return todo


def _kernel_name(fn):
    for k in KERNELS:
        if f"{k}_kernel" in fn:
            args = re.findall(r"Li(\d+)E|Lb([01])E", fn.split("_kernel", 1)[1])
            args = [a or b for a, b in args]
            return k + (f"<{', '.join(args)}>" if args else "")
    return None


def compile_all(todo):
    """One nvcc for each build, all at once: ``{key: (lib, ptxas log, sass)}``."""
    procs = []
    for key, (src, _) in todo.items():
        if src is None:
            continue
        so = src.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs.append((key, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = {}
    for key, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                              text=True, check=True).stdout
        out[key] = (ctypes.CDLL(str(so)), log, sass)
    return out


def kernel_counts(log: str, sass: str):
    """Registers and SASS counts of the two kernels (each template instance)."""
    regs, counts, name, spill = {}, {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
            spill = 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            regs[name] = f"{m.group(1)} registers, {spill} B spilled"
            name = None
    body, name = [], None

    def close():
        if name:
            ops = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*(@!?U?P\w+\s+)?", "", ln).split(" ")[0]
                   for ln in body if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
            ops = [o.rstrip(";") for o in ops if o and o.rstrip(";") != "NOP"]
            counts[name] = dict(instructions=len(ops),
                                int_div=sum(o.startswith(("I2F.U32.RP", "I2F.RP")) for o in ops),
                                mufu_ex2=sum(o.startswith("MUFU.EX2") for o in ops))

    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            name = _kernel_name(m.group(1))
            body = []
        else:
            body.append(ln)
    close()
    return regs, counts


def inputs(shape, d, n_rep, n_temps, t_range, couplings, dev, rng):
    n = int(np.prod(shape))
    nd = len(shape)
    s = n_rep * n_temps
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nd)) if couplings == "pm"
            else rng.standard_normal((d, n, nd))).astype(np.float32)
    temps = np.geomspace(*t_range, n_temps).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(n_rep)[:, None]
                    for _ in range(d)]).reshape(d, s).astype(np.int32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(shape=tuple(shape), d=d, n=n, n_rep=n_rep, n_temps=n_temps,
                spins=up(rng.choice(np.array([-1, 1], np.int8), size=(d, s, n))),
                coup=up(coup), temps=up(temps), sid=up(sid))


def tables(x, kind, wolff, rng, dev):
    keys = rng.integers(0, 2**32, (x["d"], 2), dtype=np.uint64).astype(np.uint32)
    tasks, tkeys = seeds.overlap_tasks(keys, [5], x["n_rep"], x["n_temps"])
    scal, probes = seeds.event_scalars(kind, wolff, tkeys[0], x["n"])
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (up(tasks[0]), up(scal.reshape(-1, 6)), up(probes.reshape(-1, 64)),
            up(tkeys[0].view(np.int32).reshape(-1, 2)))


def want(x, tab, kind, wolff):
    """The plain version: ``(state, state2, seeds, blue labels, parents)``
    (the parents: each site's root of the blue graph, as fk_link leaves
    them)."""
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    st, st2, sd = overlap.bond_states_plain(x["spins"].clone(), *args, kind=kind,
                                            wolff=wolff, shape=x["shape"])
    lab = connected_components(fk.state_masks(st, len(x["shape"])), x["shape"]).to(torch.int32)
    return st, st2, sd, lab


def launcher(lib, first, x, tab, kind, wolff, labels, kernel, plain, per):
    """``(fn, outputs)``: one launch of a build's kernel."""
    dev = x["spins"].device
    d, n, shape = x["d"], x["n"], x["shape"]
    b = tab[0].numel() // 2
    g = x["n_rep"] // 2
    s = x["n_rep"] * x["n_temps"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = (b, *_build.dims3(shape), x["n_temps"], g, s)
    head = [t.data_ptr() for t in (x["spins"], x["sid"], tab[0], x["coup"], x["temps"],
                                   tab[1])]
    k = overlap.KINDS.index(kind)
    u8 = dict(dtype=torch.uint8, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    if kernel == "ov_bonds":
        state = torch.empty((b, n), **u8)
        sd = torch.empty((b,), **i32)
        fn = lib.peapods_ov_bonds
        fn.restype = _I
        if first:
            par = torch.empty((b, n), **i32)
            fn.argtypes = [_P] * 11 + [_I] * 9 + [_P]
            args = (*head, tab[2].data_ptr(), tab[3].data_ptr(), state.data_ptr(),
                    par.data_ptr(), sd.data_ptr(), *dims, k, int(wolff), stream)
            state.keep = par  # the launch's scratch lives as long as its outputs
        else:
            fn.argtypes = [_P] * 11 + [_I] * 2 + [_P]
            words = overlap.ov_words(shape, d, x["n_temps"], g, s, per)
            args = (*head, tab[2].data_ptr(), tab[3].data_ptr(), state.data_ptr(),
                    sd.data_ptr(), words.ctypes.data, k, int(wolff), stream)
            state.words = words  # held with the outputs
        return (lambda: _build.check(fn(*args), "ov_bonds")), (state, sd)
    st, _, _, lab = plain
    parent = lab.clone()  # the first design's find_root may write it
    state2 = torch.empty((b, n), **u8)
    blue = torch.empty((b, n), **i32) if labels else None
    p_blue = None if blue is None else blue.data_ptr()
    fn = lib.peapods_ov_mid
    fn.restype = _I
    if first:
        sd = tab[1][:, 4].contiguous()
        par2 = torch.empty((b, n), **i32)
        fn.argtypes = [_P] * 13 + [_I] * 8 + [_P]
        args = (*head, tab[3].data_ptr(), st.data_ptr(), parent.data_ptr(), sd.data_ptr(),
                state2.data_ptr(), par2.data_ptr(), p_blue, *dims, int(wolff), stream)
        state2.keep = (sd, par2)  # the launch's scratch lives as long as its outputs
    else:
        fn.argtypes = [_P] * 12 + [_I] + [_P]
        words = overlap.ov_words(shape, d, x["n_temps"], g, s, per)
        args = (*head, tab[3].data_ptr(), st.data_ptr(), parent.data_ptr(),
                state2.data_ptr(), p_blue, words.ctypes.data, int(wolff), stream)
        state2.words = words
    state2.parent = parent
    return (lambda: _build.check(fn(*args), "ov_mid")), (state2, blue)


def bound_ms(x, kernel, labels):
    """``chip_smoke.py``'s bound: ``ov_bonds`` reads both replicas' spins
    and the couplings once and writes the state bytes; ``ov_mid`` also
    reads the state bytes and the flat parents and writes the state2 bytes
    (and the blue labels)."""
    b = x["d"] * x["n_temps"] * (x["n_rep"] // 2)
    n = x["n"]
    cb = 4 * len(x["shape"]) * x["d"] * n
    nbytes = (3 * b * n if kernel == "ov_bonds" else 8 * b * n + 4 * b * n * labels) + cb
    return nbytes / HBM_BYTES_S * 1e3


def probe(libs, todo, states, card, rounds, results, rng):
    for name, x in states():
        dev = x["spins"].device
        per0 = overlap.ov_per(x["n"], x["d"], x["n_temps"], x["n_rep"] // 2,
                              fk.resident_threads(dev.index) // 4)
        for kernel, kind, wolff, labels in FORMS:
            tab = tables(x, kind, wolff, rng, dev)
            plain = want(x, tab, kind, wolff)
            form = f"{kind} {'wolff' if wolff else 'sw'}{' labels' if labels else ''}"
            for rnd in range(rounds):
                keys = list(todo)
                for key in (keys if rnd % 2 == 0 else keys[::-1]):
                    label, variant = key
                    first = todo[key][1] == "first"
                    spec = VARIANTS.get(variant, (None, [], None, True))
                    lib = libs[key if todo[key][0] is not None else (label, "base")][0]
                    per = spec[2] or per0
                    if (x["n_temps"] * (x["n_rep"] // 2)) % per:
                        continue  # a host plan this state's tasks do not split into
                    fn, outs = launcher(lib, first, x, tab, kind, wolff, labels, kernel,
                                        plain, per)
                    fn()
                    torch.cuda.synchronize()
                    ok = None
                    if spec[3]:
                        if kernel == "ov_bonds":
                            ok = bool(torch.equal(outs[0], plain[0])
                                      and torch.equal(outs[1], plain[2]))
                        else:
                            ok = bool(torch.equal(outs[0], plain[1])
                                      and (outs[1] is None or torch.equal(outs[1], plain[3])))
                        if not ok:
                            raise AssertionError(f"{label} {variant} {kernel} {form} at {name} "
                                                 "differs from its plain version")
                    ms = events_ms(fn, 200)
                    rec = dict(kind=kernel, form=form, source=label, variant=variant,
                               state=name, round=rnd, ms=ms,
                               bound_ms=bound_ms(x, kernel, labels), bitwise_plain=ok,
                               per=None if first else per)
                    results.append(rec)
                    print(f"[{kernel}] {label} {variant} {name} {form}: {ms:.5f} ms a launch "
                          f"(bound {rec['bound_ms']:.7f} ms, bytes"
                          + ("" if first else f"; {per} tasks a thread") + ")"
                          + (", bitwise plain" if ok else "") + f" round {rnd} on {card}",
                          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_overlap"))
    ap.add_argument("--json", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all of each source's design)")
    ap.add_argument("--shapes", default="", help="comma-separated state names (default: all)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_overlap: torch sees no CUDA device", file=sys.stderr)
        return 1
    srcs = dict(s.split("=", 1) for s in a.src) or {"this": str(_build.SOURCE_DIR)}
    sources = [(k, Path(v).resolve()) for k, v in srcs.items()]
    out = Path(a.out)
    card = card_line()
    print(card, flush=True)
    todo = builds(sources, out, [v for v in a.variants.split(",") if v])
    libs = compile_all(todo)
    results = []
    for key, (_, log, sass) in libs.items():
        regs, counts = kernel_counts(log, sass)
        results.append(dict(kind="build", source=key[0], variant=key[1], registers=regs,
                            sass=counts))
        tag = f"{key[0]} {key[1]}"
        print(f"[ptxas] {tag}: " + "; ".join(f"{k} {v}" for k, v in regs.items()), flush=True)
        print(f"[sass] {tag}: integer divisions per kernel "
              + str({k: c["int_div"] for k, c in counts.items()}) + "; MUFU.EX2 "
              + str({k: c["mufu_ex2"] for k, c in counts.items()}) + "; instructions "
              + str({k: c["instructions"] for k, c in counts.items()}), flush=True)
    only = {s for s in a.shapes.split(",") if s}
    rng = np.random.default_rng(18)
    dev = torch.device("cuda", 0)

    def states():
        for name, shape, d, n_rep, n_temps, t_range, couplings in SHAPES:
            if not only or name in only:
                yield name, inputs(shape, d, n_rep, n_temps, t_range, couplings, dev, rng)

    probe(libs, todo, states, card, a.rounds, results, rng)
    path = Path(a.json) if a.json else out / "probe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
