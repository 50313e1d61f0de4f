"""Time the replica path's colour pass (``csrc/mega.cu`` ``colour_pass``)
and the staged path's labelling (``csrc/cc.cu``) of two source trees side
by side on one NVIDIA GPU, with variants that cure one defect of the first
design or take one part of the redesign away, and count each kernel's
registers, spills and SASS instructions.

    python3 tools/probe_colour_cc.py --src old=CSRC_DIR --src new=CSRC_DIR
                                     [--out DIR] [--json FILE] [--rounds N]
                                     [--variants a,b,...] [--shapes a,b,...] [--per] [--plans]

Each ``--src`` names a directory of the port's CUDA sources; the first
designs (``colour_pass``: a CTA a block of 256 groups of one slot through
``mega.cuh`` ``update_sites[_3d]``, the pre-shifted coupling grids read
again for every slot, two divisions a site, byte loads, a block-wide
partial tree; the labelling: ``cc_link``, a thread a site uniting in
global memory from parents set to ``parent[i] = i``, ``nb.cuh``'s
divisions, then ``cc_label`` finding every root again) are told from the
redesigns (a group of four sites of several slots of one realization a
thread, the forward couplings staged once, no division, 8-byte spin words,
slots side by side at small lattices; a CTA a box of the graph in shared
memory, one launch up to 8192 sites over a cluster of CTAs a graph, else
``cc_link_border`` and ``fk_link_flatten``) by their sources; so is the
table form's labelling (4D and up, 7 to 32 offsets: the first design
``cc_table_init``, ``cc_table_link`` a thread a site uniting in global
memory, ``fk_link_flatten``; the redesign a graph's union-find in shared
memory over a cluster of CTAs, one launch, slabs with ``cc_table_border``
and the flatten past one cluster).  Give the parent commit's sources
(``git archive`` of it unpacked under a directory ``.gitignore`` lists) and
this checkout's.  The script builds ``mega.cu``, ``cc.cu`` and ``fk.cu``
of every source as they are and patched into each variant of their
design, with nvcc for sm_90a, all at once (into ``--out``), and prints each
kernel's ``ptxas -v`` registers and spills and, from ``cuobjdump -sass``,
its static instructions and integer-division sequences (``I2F.U32.RP``).

Variants of the first designs, one defect cured each:

* ``o-once``: ``colour_pass`` with a realization's slots side by side in
  ``blockIdx.x`` (their couplings then come from L1 / L2);
* ``o-nodiv``: the divisions of ``update_sites[_3d]`` and ``nb.cuh``'s
  coordinates and wraps as shifts and masks (exact at the probe's
  power-of-two extents only);
* ``o-full``: ``colour_pass`` at one block a slot launched with only the
  threads that hold sites (full CTAs at 8^3 and 32^2);
* ``o-nolabel``: the labelling without ``cc_label`` (its parents are not
  all roots: no check).

Variants of the redesigns, one part taken away each:

* ``n-scalar``: ``colour_pass``'s per-site path everywhere (no 8-byte
  spin words);
* ``n-nofill``: no slots side by side (a CTA of 256 threads takes one slot
  lane, its threads the plan's slots in turn);
* ``n-noballot``: ``cc_link`` without the ballot's runs along the fast
  axis (every bond through ``tile_unite``);
* ``n-nounite``: ``cc_link`` with no union (wrong labels): the staging,
  the rounds' barriers and finds and the output alone;
* ``n-nocompress``: no round's sites pointed at their roots but the last's;
* ``n-nohalve``: ``tile_root`` without its path halving;
* ``n-nocross``: the whole-graph form without the unions between a
  cluster's slabs (wrong labels).

States: ``colour_pass`` at config 1 (32^2, 2 x 16 slots), config 4 (8^3 +-J,
4 x 24 slots, 8 realizations), config 5 (16^3 gaussian, the same) and the
flagship shape (256^2, 24 slots; the mega path's three launches), random
spins at shuffled slots; the labelling on BCC and FCC 16^3 x 8, NNN 64^2 x
8 and 2048 x 64^2, one 256^2 square graph (row 15) and FCC 32^3 x 8, random
bonds at densities above each lattice's bond-percolation threshold (the
clusters that bound a union-find); the table labelling at the 4D +-J
glass's shapes (10^4 x 384 graphs, the FK phase's, and x 192, the moves'),
16^4 x 16, 16^3 with 13 offsets x 8, 16^3 with 9 offsets x 192 and 32^4 x
2 (the slab route), the redesign, with ``--plans``, also in its other
plans (clusters of 1 to 8 CTAs at 256 to 1024 threads).  Every build and variant that keeps the
function is held bitwise to ``colour_pass_plain`` (spins; its partials to
``mega.colour_pass_partials``) or ``cc_labels_plain``.  ``--per`` also
times the redesigned colour pass with each count of slots a CTA,
``--plans`` the redesigned labelling in its other forms (clusters of 1
to 8 CTAs a graph, boxes of 512 to 4096 sites).  Times are
device times by CUDA events over warm launches queued behind a sleep
kernel: a colour pass (the mean of a sweep's two, and the measuring one
alone), and a labelling (every launch of one call; the first design's
parent reset, a copy of 4 B a site that fk_bonds_nb's writes stood for,
timed alone beside it).  ``--rounds`` times with the builds in order, then
reversed.  Prints one line per measurement with the card, writes all as
JSON to ``--json`` (default ``--out/probe.json``; the builds, which are
large, stay in ``--out``).  Needs a CUDA device, nvcc and cuobjdump;
imports nothing of JAX.
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

from chip_smoke import card_line  # noqa: E402
from peapods_tpu_torch.ops import _build, cc, fk, mega, sweep  # noqa: E402
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice, fast_divisor  # noqa: E402
from probe_bonds import widths  # noqa: E402
from probe_pt_link import events_ms  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
FILES = ("mega.cu", "cc.cu", "fk.cu")

# (file, anchor, replacement) edits of the first designs
O_ONCE = [
    ("mega.cu", "  const int slot = blockIdx.y;\n  const int d = blockIdx.z;\n",
     "  const int slot = blockIdx.x;\n  const int d = blockIdx.z;\n"),
    ("mega.cu", "  const int g = blockIdx.x * blockDim.x + threadIdx.x;\n  float e_acc",
     "  const int g = blockIdx.y * blockDim.x + threadIdx.x;\n  float e_acc"),
    ("mega.cu", "(static_cast<size_t>(d) * n_slots + sys) * gridDim.x + blockIdx.x);",
     "(static_cast<size_t>(d) * n_slots + sys) * gridDim.y + blockIdx.y);"),
    ("mega.cu", "  const dim3 grid(blocks, n_slots, n_disorder);",
     "  const dim3 grid(n_slots, blocks, n_disorder);"),
]
O_NODIV = [
    ("mega.cuh", "    const int r = i / wh;\n", "    const int r = i >> (31 - __clz(wh));\n"),
    ("mega.cuh", "    const int x = i / plane;\n", "    const int x = i >> (31 - __clz(plane));\n"),
    ("mega.cuh", "    const int y = rem / zh;\n", "    const int y = rem >> (31 - __clz(zh));\n"),
    ("nb.cuh", "  x %= L;\n  return x < 0 ? x + L : x;", "  return x & (L - 1);"),
    ("nb.cuh", "  for (int k = 0; k < 3; ++k) c[k] = (i / g.stride[k]) % g.L[k];",
     "  for (int k = 0; k < 3; ++k) c[k] = (i >> (31 - __clz(g.stride[k]))) & (g.L[k] - 1);"),
]
O_FULL = [
    ("mega.cu", "  colour_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(",
     "  colour_pass_kernel<<<grid, blocks > 1 ? kThreads : (L0 * L1 * L2 / 8 + 31) / 32 * 32, 0,"
     "\n                       static_cast<cudaStream_t>(stream)>>>("),
    ("mega.cuh", "  for (int off = kThreads / 2; off > 0; off >>= 1) {",
     "  for (int off = blockDim.x / 2; off > 0; off >>= 1) {"),
]
# ... and of the redesigns'
N_SCALAR = [("mega.cu", "  const bool vec = W % 8 == 0 &&", "  const bool vec = false && W % 8 == 0 &&")]
N_NOFILL = [("mega.cu", "  g.gp = plan[1];\n", "  g.gp = kThreads;\n")]
N_NOBALLOT = [("cc.cu", "  g.fast_d = w[10];\n", "  g.fast_d = -1;\n")]
N_NOUNITE = [("cc.cu", "        if (lead_pair(j >= 0 && ra != rb, ra, rb, lane)) tile_unite(P, ra, rb);",
              "        if (lead_pair(j >= 0 && ra != rb, ra, rb, lane) && j < -1) tile_unite(P, ra, rb);"),
             ("cc.cu", "      } else if (j >= 0) {\n        tile_unite(P, l, j);",
              "      } else if (j < -1) {\n        tile_unite(P, l, j);"),
             ("cc.cu", "      if (lead_pair(cross, ra, rb, lane)) slab_unite(sl, g, ra, rb);",
              "      if (lead_pair(cross, ra, rb, lane) && !cross) slab_unite(sl, g, ra, rb);")]
N_NOCOMPRESS = [("cc.cu", "    if (l < sites) P[l] = tile_root(P, l);\n",
                 "    if (l < sites && it + 1 == rounds) P[l] = tile_root(P, l);\n")]
N_NOHALVE = [("uf.cuh", "    V[x] = gp;\n", "")]
N_NOCROSS = [("cc.cu", "      if (lead_pair(cross, ra, rb, lane)) slab_unite(sl, g, ra, rb);",
              "      if (lead_pair(cross, ra, rb, lane) && !cross) slab_unite(sl, g, ra, rb);")]
# name: (design, edits, whether the variant keeps the function, kernels it
# applies to); o-nolabel is a way of timing the first labelling, no build
VARIANTS = {
    "o-once": ("first", O_ONCE, True, ("colour_pass",)),
    "o-nodiv": ("first", O_NODIV, True, ("colour_pass", "labelling")),
    "o-full": ("first", O_FULL, True, ("colour_pass",)),
    "o-nolabel": ("first", [], False, ("labelling",)),
    "n-scalar": ("redesign", N_SCALAR, True, ("colour_pass",)),
    "n-nofill": ("redesign", N_NOFILL, True, ("colour_pass",)),
    "n-noballot": ("redesign", N_NOBALLOT, True, ("labelling",)),
    "n-nounite": ("redesign", N_NOUNITE, False, ("labelling",)),
    "n-nocompress": ("redesign", N_NOCOMPRESS, True, ("labelling",)),
    "n-nohalve": ("redesign", N_NOHALVE, True, ("labelling",)),
    "n-nocross": ("redesign", N_NOCROSS, False, ("labelling",)),
}

# (name, shape, realizations, replicas, temperatures, couplings, T range)
COLOUR = (
    ("config1", (32, 32), 1, 2, 16, "pm", (1.8, 3.2)),
    ("config4", (8, 8, 8), 8, 4, 24, "pm", (0.9, 2.2)),
    ("config5", (16, 16, 16), 8, 4, 24, "gauss", (0.8, 2.0)),
    ("flagship", (256, 256), 1, 1, 24, "pm", (1.8, 3.2)),
)
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
# (name, shape, offsets, graphs, bond density: above the lattice's
# bond-percolation threshold, BCC 0.180, FCC 0.120, NNN 0.25, square 0.5)
LABELLING = (
    ("bcc16", (16, 16, 16), "bcc", 8, 0.25),
    ("fcc16", (16, 16, 16), "fcc", 8, 0.16),
    ("nnn64", (64, 64), NNN, 8, 0.32),
    ("nnn64x2048", (64, 64), NNN, 2048, 0.32),
    ("square256", (256, 256), None, 1, 0.52),
    ("fcc32", (32, 32, 32), "fcc", 8, 0.16),
)


# the table form's labelling (4D and up, 7 to 32 offsets): (name, shape,
# offsets, graphs, bond density above the lattice's bond-percolation
# threshold: 4D hypercubic 0.160, 16^3 with 9 / 13 offsets about 0.06 /
# 0.04; the 4D glass's FK graphs also at 0.5, about their density: a
# satisfied bond, 0.7-0.8 of them, active with 1 - exp(-2 / T), 0.57-0.71)
SHELLS3 = ([[1, 0, 0], [0, 1, 0], [0, 0, 1]]
           + [[1, s, 0] for s in (1, -1)] + [[1, 0, s] for s in (1, -1)]
           + [[0, 1, s] for s in (1, -1)]
           + [[1, a, b] for a in (1, -1) for b in (1, -1)])
TABLE_LABELLING = (
    ("glass4d", (10, 10, 10, 10), None, 384, 0.25),
    ("glass4d-dense", (10, 10, 10, 10), None, 384, 0.5),
    ("glass4d-moves", (10, 10, 10, 10), None, 192, 0.25),
    ("4d16", (16, 16, 16, 16), None, 16, 0.25),
    ("shells16", (16, 16, 16), SHELLS3, 8, 0.08),
    ("nine16", (16, 16, 16), SHELLS3[:9], 192, 0.10),
    ("4d32x2", (32, 32, 32, 32), None, 2, 0.25),
)


def design(csrc: Path) -> str:
    return "first" if "cc_label_kernel" in (csrc / "cc.cu").read_text() else "redesign"


def table_design(csrc: Path) -> str:
    """The table labelling's design of a source: the first (cc_table_init,
    a thread a site uniting in global memory, fk_link_flatten) or the
    redesign (a graph's union-find in shared memory)."""
    return "first" if "cc_table_init_kernel" in (csrc / "cc.cu").read_text() else "redesign"


def builds(sources, out, variants):
    """``{(label, variant): (directory, design, files)}``: each source's base
    (every file) and the variants of its design (the files they patch); a
    variant of its own design whose anchors are not found stops the probe."""
    todo = {}
    for label, csrc in sources:
        own = design(csrc)
        text0 = {p.name: p.read_text() for p in csrc.iterdir() if p.suffix in (".cu", ".cuh")}
        for variant in ("base", *variants):
            edits, files = [], FILES
            if variant != "base":
                aim, edits, _, kinds = VARIANTS[variant]
                if aim != own or not edits:
                    continue
                gone = [old.splitlines()[0] for f, old, _ in edits if text0[f].count(old) != 1]
                if gone:
                    raise SystemExit(f"probe_colour_cc: {variant} does not apply to {csrc}: "
                                     f"{gone}")
                files = tuple(f for f, want in (("mega.cu", "colour_pass"),
                                                ("cc.cu", "labelling")) if want in kinds)
            d = out / label / variant
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            text = dict(text0)
            for f, old, new in edits:
                text[f] = text[f].replace(old, new)
            for f, t in text.items():
                if f.endswith(".cuh") or f in files:
                    (d / f).write_text(t)
            todo[(label, variant)] = (d, own, files)
    return todo


def compile_all(todo):
    """One nvcc for each build and file, all at once: ``{(key, file): (lib,
    ptxas log, sass)}``."""
    procs = []
    for key, (d, _, files) in todo.items():
        for f in files:
            so = d / f.replace(".cu", ".so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / f)]
            procs.append(((key, f), so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
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


KERNELS = ("colour_pass_kernel", "cc_link_kernel", "cc_label_kernel", "cc_link_border_kernel",
           "cc_table_link_kernel", "cc_table_border_kernel")


def short(mangled: str) -> str:
    """``colour_pass_kernel<true, false, true>``-like names of the probed
    kernels' mangled names."""
    base = re.search("(" + "|".join(KERNELS) + ")", mangled)
    if not base:
        return ""
    tail = mangled.split(base.group(1), 1)[1]
    args = re.findall(r"Li(\d+)E|Lb(\d)E", tail)
    args = [a or ("true" if b == "1" else "false") for a, b in args]
    return base.group(1) + (f"<{', '.join(args)}>" if args else "")


def registers(log):
    """``{kernel: {registers, stack, spill}}`` of a ptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = short(m.group(1)) or None
            if name:
                out.setdefault(name, {})
        if not name:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            out[name].update(stack=int(m.group(1)), spill=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_counts(sass: str) -> dict:
    """Per probed kernel (each template instance): its static instructions,
    integer-division sequences and loads and stores by width."""
    out, name, body = {}, None, []

    def close():
        if name:
            ins = [ln for ln in body if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
            ops = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*(@!?U?P\w+\s+)?", "", ln).split(" ")[0]
                   for ln in ins]
            ops = [o.rstrip(";") for o in ops if o and o.rstrip(";") != "NOP"]
            out[name] = dict(
                instructions=len(ops),
                int_div=sum(o.startswith("I2F.U32.RP") or o.startswith("I2F.RP") for o in ops),
                ldg=widths(ops, "LDG"), stg=widths(ops, "STG"),
                atom=sum(o.startswith(("ATOM", "ATOMS", "RED")) for o in ops))

    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            name = short(m.group(1)) or None
            body = []
        else:
            body.append(ln)
    close()
    return out


# ------------------------------------------------------------- colour_pass


def colour_inputs(shape, d, n_rep, n_temps, coup, t, dev, rng):
    n, nd, s = int(np.prod(shape)), len(shape), n_rep * n_temps
    j = (rng.choice([-1.0, 1.0], (d, n, nd)) if coup == "pm"
         else rng.standard_normal((d, n, nd))).astype(np.float32)
    jt = torch.from_numpy(j)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(
        spins=up(rng.choice([-1, 1], (d, s, *shape)).astype(np.int8)),
        jgrids=sweep.pack_coupling_grids(jt, shape).contiguous().to(dev),
        sid=up(np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)),
        temps=up(np.tile(np.geomspace(*t, n_temps), n_rep).astype(np.float32)),
        words=up(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)),
        d=d, s=s, shape=shape)


def colour_fn(lib, first, x, spins, words, parts, plan):
    """A sweep's two colour passes of a build's colour_pass (the second
    measuring into ``parts``), or only the measuring one (``only1``)."""
    fn = lib.peapods_colour_pass
    fn.argtypes = [_P] * 7 + [_I] * 7 + ([_P] if first else [_P, _P])
    fn.restype = _I
    stream = torch.cuda.current_stream().cuda_stream
    dims = _build.dims3(x["shape"])
    tail = () if first else (plan.words.ctypes.data,)

    def run(colours=(0, 1)):
        for colour in colours:
            ptrs = (None, None) if colour == 0 else tuple(t.data_ptr() for t in parts)
            _build.check(fn(spins.data_ptr(), x["jgrids"].data_ptr(), x["sid"].data_ptr(),
                            x["temps"].data_ptr(), words.data_ptr(), *ptrs, x["d"], x["s"],
                            *dims, colour, 0, *tail, stream), "colour_pass")
    return run


def colour_bound(x):
    """A pass's bound (chip_smoke.py pair_times): every spin, the grids and
    the active spins written, or its f32 operations."""
    n, nd = int(np.prod(x["shape"])), len(x["shape"])
    sys_bytes = x["d"] * x["s"] * n
    nbytes = sys_bytes + 2 * nd * 4 * x["d"] * n + sys_bytes // 2
    flops = (6 * nd + 8) * sys_bytes // 2
    return max(nbytes / 3.35e12, flops / 67e12) * 1e3


def probe_colour(libs, todo, dev, card, rounds, pers, only, rng, results, record):
    keys = list(todo)
    for name, shape, d, n_rep, n_temps, coup, t in COLOUR:
        if only and name not in only:
            continue
        x = colour_inputs(shape, d, n_rep, n_temps, coup, t, dev, rng)
        dims = _build.dims3(shape)
        rule = mega._colour_plan(dev, (d, x["s"], *dims))
        nb = _build.library().peapods_colour_pass_blocks(
            dims[0] * dims[1] if dims[2] > 1 else dims[0], dims[2] if dims[2] > 1 else dims[1])
        words = [x["words"], x["words"] * 3 + 1]
        want = x["spins"].clone()
        mega.colour_pass_plain(want, x["jgrids"], x["sid"], x["temps"], words[0], 0,
                               gibbs=False)
        pe, pm = mega.colour_pass_partials(want, x["jgrids"], x["sid"], x["temps"], words[0],
                                           gibbs=False)
        bound = colour_bound(x)
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, variant = key
                if variant != "base" and "colour_pass" not in VARIANTS[variant][3]:
                    continue
                first = todo[key][1] == "first"
                keeps = variant == "base" or VARIANTS[variant][2]
                lib = libs[(key, "mega.cu")][0]
                plans = [rule]
                if pers and not first and variant == "base":
                    plans += [mega.ColourPlan(p, rule.gp, min(256 // rule.gp, p),
                                              np.concatenate([[p], rule.words[1:]])
                                              .astype(np.int32))
                              for p in range(1, 9) if x["s"] % p == 0 and p != rule.per]
                for plan in plans:
                    parts = (torch.empty((d, x["s"], nb), dtype=torch.float32, device=dev),
                             torch.empty((d, x["s"], nb), dtype=torch.int32, device=dev))
                    a = x["spins"].clone()
                    run = colour_fn(lib, first, x, a, words[0], parts, plan)
                    run()
                    torch.cuda.synchronize()
                    ok = None
                    if keeps:
                        ok = (torch.equal(a, want) and torch.equal(parts[0], pe)
                              and torch.equal(parts[1], pm))
                        if not ok:
                            raise AssertionError(
                                f"{label} {variant} colour_pass at {name} differs from its "
                                f"plain version: {int((a != want).sum())} spins, "
                                f"{int((parts[0] != pe).sum())} e partials")
                    reps = 200 if x["d"] * x["s"] * np.prod(shape) < 2**22 else 50
                    ms = events_ms(run, reps) / 2
                    mms = events_ms(lambda: run((1,)), reps)
                    rec = dict(kind="colour_pass", source=label, variant=variant, state=name,
                               round=rnd, per=None if first else plan.per,
                               gp=None if first else plan.gp, ms=ms, ms_measuring=mms,
                               bound_ms=bound, slots=d * x["s"], sites=int(np.prod(shape)),
                               bitwise_plain=ok)
                    record(rec, f"[colour_pass] {label} {variant} {name} ({d} x {x['s']} x "
                           f"{'x'.join(map(str, shape))}"
                           + ("" if first else f", {plan.per} slots a CTA, {plan.gp} x "
                              f"{plan.sub} threads") + f"): {ms:.5f} ms a pass, {mms:.5f} "
                           f"measuring (bound {bound:.5f} ms)"
                           + (", spins and partials bitwise plain" if ok else ""))
        del x, want
        torch.cuda.empty_cache()


# -------------------------------------------------------------- labelling


def label_fn(libs, key, first, lat, state, out, parent0, variant, plan=None):
    """One labelling call of a build: the first design's cc_link and
    cc_label from parents reset to their own index (the reset a copy), or
    the redesign's launches (``cc.link_plan``)."""
    base = (key[0], "base")
    stream = torch.cuda.current_stream().cuda_stream
    b = state.shape[0]
    lib = libs[(key, "cc.cu")][0] if (key, "cc.cu") in libs else libs[(base, "cc.cu")][0]
    if first:
        link, lab = lib.peapods_cc_link, lib.peapods_cc_label
        link.argtypes, link.restype = [_P] * 3 + [_I] + [_P], _I
        lab.argtypes, lab.restype = [_P] * 2 + [_I] * 2 + [_P], _I
        parent = parent0.clone()

        def run():
            parent.copy_(parent0)
            _build.check(link(state.data_ptr(), parent.data_ptr(),
                              lat.kernel_geometry.ctypes.data, b, stream), "cc_link")
            if variant != "o-nolabel":
                _build.check(lab(parent.data_ptr(), out.data_ptr(), lat.n_spins, b, stream),
                             "cc_label")
        return run, lambda: parent.copy_(parent0)
    link = lib.peapods_cc_link
    link.argtypes, link.restype = [_P] * 3 + [_I] * 2 + [_P], _I
    border = lib.peapods_cc_link_border
    border.argtypes, border.restype = [_P] * 3 + [_I] + [_P], _I
    flat = libs[(base, "fk.cu")][0].peapods_fk_link_flatten
    flat.argtypes, flat.restype = [_P] + [_I] * 2 + [_P], _I
    plan = plan or cc.link_plan(_build.dims3(lat.shape), b)
    words = cc.link_words(lat, plan.tile, plan.cluster)

    def run():
        _build.check(link(state.data_ptr(), out.data_ptr(), words.ctypes.data, b,
                          plan.threads, stream), "cc_link")
        if plan.tiled:
            _build.check(border(state.data_ptr(), out.data_ptr(), words.ctypes.data, b,
                                stream), "cc_link_border")
            _build.check(flat(out.data_ptr(), b, lat.n_spins, stream), "fk_link_flatten")
    return run, None


def other_plans(dims, b):
    """The redesign's forms besides the rule's, for ``--plans``: the whole
    graph over clusters of 1 to 8 CTAs, and boxes of 512 to 4096 sites
    (fk_link's tile shapes) at as many threads as a box has sites (at most
    1024)."""
    out = []
    n = int(np.prod(dims))
    if n <= cc.LINK_TILE_SITES:
        out += [cc.LinkPlan(tuple(dims), cc._threads(-(-n // c)), False, c)
                for c in (1, 2, 4, 8)]
    for sites in (512, 1024, 2048, 4096):
        tile = fk._link_tile(dims, sites)
        if tile != tuple(dims):
            out.append(cc.LinkPlan(tuple(tile), min(1024, -(-int(np.prod(tile)) // 32) * 32),
                                   True))
    rule = cc.link_plan(tuple(dims), b)
    return [p for p in dict.fromkeys(out) if p != rule]


def probe_labelling(libs, todo, dev, card, rounds, only, rng, results, record, variants,
                    plans=False):
    keys = list(todo)
    for name, shape, offsets, b, p in LABELLING:
        if only and name not in only:
            continue
        lat = Lattice(shape, GEOMETRY_OFFSETS[offsets] if isinstance(offsets, str)
                      else offsets)
        n = lat.n_spins
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        masks = torch.rand((b, n, lat.n_neighbors), device=dev, generator=g) < p
        state = cc.pack_masks(masks)
        want = cc.cc_labels_plain(masks, lat)
        parent0 = torch.arange(n, dtype=torch.int32, device=dev).repeat(b, 1)
        bound = 5 * b * n / 3.35e12 * 1e3
        n_comp = int((want == torch.arange(n, device=dev)).sum())
        reps = 200 if b * n < 2**20 else 20
        scratch = parent0.clone()
        reset_ms = events_ms(lambda: scratch.copy_(parent0), reps)
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, variant = key
                if variant != "base" and "labelling" not in VARIANTS[variant][3]:
                    continue
                first = todo[key][1] == "first"
                forms = [(variant, None)]
                if first and variant == "base" and "o-nolabel" in variants:
                    forms.append(("o-nolabel", None))
                if not first and variant == "base" and plans:
                    forms += [(variant, q) for q in other_plans(_build.dims3(shape), b)]
                for v, plan in forms:
                    out = torch.empty((b, n), dtype=torch.int32, device=dev)
                    run, reset = label_fn(libs, key, first, lat, state, out, parent0, v, plan)
                    run()
                    torch.cuda.synchronize()
                    keeps = v == "base" or VARIANTS[v][2]
                    ok = None
                    if keeps:
                        ok = torch.equal(out, want)
                        if not ok:
                            raise AssertionError(f"{label} {v} labelling at {name} differs "
                                                 f"from its plain version: "
                                                 f"{int((out != want).sum())} labels")
                    ms = events_ms(run, reps)
                    rec = dict(kind="labelling", source=label, variant=v, state=name,
                               round=rnd, ms=ms, reset_ms=reset_ms if first else None,
                               launches=(("cc_link",) if v == "o-nolabel" else
                                         ("cc_link", "cc_label")) if first
                               else ("cc_link", "cc_link_border", "fk_link_flatten")
                               if (plan.tiled if plan else cc.link_plan(
                                   _build.dims3(shape), b).tiled) else ("cc_link",),
                               tile=None if first else (plan or cc.link_plan(
                                   _build.dims3(shape), b)).tile,
                               cluster=None if first else (plan or cc.link_plan(
                                   _build.dims3(shape), b)).cluster,
                               threads=None if first else (plan or cc.link_plan(
                                   _build.dims3(shape), b)).threads,
                               bound_ms=bound, graphs=b, sites=n, clusters=n_comp,
                               density=p, bitwise_plain=ok)
                    record(rec, f"[labelling] {label} {v} {name} ({b} x "
                           f"{'x'.join(map(str, shape))}, {lat.n_neighbors} offsets, p {p}, "
                           f"{n_comp} clusters; {' + '.join(rec['launches'])}"
                           + ("" if first else f", boxes {rec['tile']}, {rec['threads']} "
                              f"threads, clusters of {rec['cluster']}") + f"): {ms:.5f} ms a "
                           "call" + (f" (the parents' reset {reset_ms:.5f} ms of it)"
                                     if first else "")
                           + f" (bound {bound:.6f} ms)" + (", labels bitwise plain" if ok else ""))
        del masks, state, want, parent0
        torch.cuda.empty_cache()



def table_label_fn(libs, key, first, lat, state, out, fwd, plan=None):
    """One table labelling call of a build: the first design's
    cc_table_init, cc_table_link and fk_link_flatten, or the redesign's
    launches (``cc.table_link_plan``'s, or ``plan``)."""
    base = (key[0], "base")
    stream = torch.cuda.current_stream().cuda_stream
    b, n = state.shape
    nb = lat.n_neighbors
    lib = libs[(base, "cc.cu")][0]
    flat = libs[(base, "fk.cu")][0].peapods_fk_link_flatten
    flat.argtypes, flat.restype = [_P] + [_I] * 2 + [_P], _I
    if first:
        init, link = lib.peapods_cc_table_init, lib.peapods_cc_table_link
        init.argtypes, init.restype = [_P] + [_I] * 2 + [_P], _I
        link.argtypes, link.restype = [_P] * 3 + [_I] * 3 + [_P], _I

        def run():
            _build.check(init(out.data_ptr(), n, b, stream), "cc_table_init")
            _build.check(link(state.data_ptr(), out.data_ptr(), fwd.data_ptr(), n, nb, b,
                              stream), "cc_table_link")
            _build.check(flat(out.data_ptr(), b, n, stream), "fk_link_flatten")
        return run, ("cc_table_init", "cc_table_link", "fk_link_flatten")
    link, border = lib.peapods_cc_table_link, lib.peapods_cc_table_border
    for fn in (link, border):
        fn.argtypes, fn.restype = [_P] * 4 + [_I] + [_P], _I
    plan = plan or cc.table_link_plan(n, nb, b)
    m, s = fast_divisor(plan.slab)
    words = np.asarray([n, nb, plan.cluster, plan.slab, m, s, int(plan.slabs), plan.threads],
                       np.int64).astype(np.uint32).view(np.int32)

    def run():
        _build.check(link(state.data_ptr(), out.data_ptr(), fwd.data_ptr(), words.ctypes.data,
                          b, stream), "cc_table_link")
        if plan.slabs:
            _build.check(border(state.data_ptr(), out.data_ptr(), fwd.data_ptr(),
                                words.ctypes.data, b, stream), "cc_table_border")
            _build.check(flat(out.data_ptr(), b, n, stream), "fk_link_flatten")
    return run, (("cc_table_link", "cc_table_border", "fk_link_flatten") if plan.slabs
                 else ("cc_table_link",))


def table_plans(n, nb, b):
    """The redesign's other whole-graph plans for ``--plans``: clusters of 1
    to 8 CTAs that fit, at 256, 512 and 1024 threads."""
    rule = cc.table_link_plan(n, nb, b)
    if rule.slabs:
        return []
    per = 4 + cc.table_state_bytes(nb)
    out = []
    for c in (1, 2, 4, 8):
        slab = -(-n // c)
        if slab * per > cc.TABLE_SMEM:
            continue
        for threads in (256, 512, 1024):
            threads = min(threads, -(-slab // 32) * 32)
            out.append(cc.TableLinkPlan(c, slab, threads, False, slab * per))
    return [q for q in dict.fromkeys(out) if q != rule]


def probe_table_labelling(libs, todo, dev, card, rounds, only, rng, results, record,
                          plans=False):
    """The table labelling of every source at TABLE_LABELLING's shapes: labels
    bitwise ``cc_labels_plain``; the redesign, with ``plans``, also in its
    other plans."""
    keys = [k for k in todo if k[1] == "base"]
    for name, shape, offsets, b, p in TABLE_LABELLING:
        if only and name not in only:
            continue
        lat = Lattice(shape, offsets)
        n, nb = lat.n_spins, lat.n_neighbors
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
        masks = torch.rand((b, n, nb), device=dev, generator=g) < p
        state = cc.pack_masks(masks, torch.int32)
        want = cc.cc_labels_plain(masks, lat)
        fwd = torch.from_numpy(lat.fwd).to(dev)
        n_comp = int((want == torch.arange(n, device=dev)).sum())
        bound = (8 * b * n + 4 * n * nb) / 3.35e12 * 1e3
        reps = 20 if b * n < 2**22 else 5
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                first = table_design(todo[key][0]) == "first"
                forms = [("base", None)]
                if not first and plans:
                    forms += [("plan", q) for q in table_plans(n, nb, b)]
                for v, plan in forms:
                    out = torch.empty((b, n), dtype=torch.int32, device=dev)
                    run, launches = table_label_fn(libs, key, first, lat, state, out, fwd, plan)
                    run()
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        raise AssertionError(f"{key[0]} {v} table labelling at {name} differs "
                                             f"from its plain version: "
                                             f"{int((out != want).sum())} labels")
                    ms = events_ms(run, reps)
                    q = None if first else (plan or cc.table_link_plan(n, nb, b))
                    rec = dict(kind="table_labelling", source=key[0], variant=v, state=name,
                               round=rnd, ms=ms, launches=launches, bound_ms=bound, graphs=b,
                               sites=n, offsets=nb, clusters=n_comp, density=p,
                               plan=None if q is None else q._asdict(), bitwise_plain=True)
                    record(rec, f"[table labelling] {key[0]} {v} {name} ({b} x "
                           f"{'x'.join(map(str, shape))}, {nb} offsets, p {p}, {n_comp} "
                           f"clusters; {' + '.join(launches)}"
                           + ("" if q is None else f", clusters of {q.cluster}, slabs of "
                              f"{q.slab}, {q.threads} threads")
                           + f"): {ms:.5f} ms a call (bound {bound:.6f} ms), labels bitwise "
                           "plain")
        del masks, state, want, fwd
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_colour_cc"),
                    help="the builds' directory")
    ap.add_argument("--json", default=None,
                    help="where the measurements go (default: --out/probe.json)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all of each source's design)")
    ap.add_argument("--shapes", default="", help="comma-separated state names (default: all)")
    ap.add_argument("--per", action="store_true", help="also time the redesigned colour "
                    "pass with each count of slots a CTA")
    ap.add_argument("--plans", action="store_true", help="also time the redesigned "
                    "labelling in its other forms (the whole graph at 512 threads, boxes "
                    "of 512 to 4096 sites)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_colour_cc: torch sees no CUDA device", file=sys.stderr)
        return 1
    srcs = dict(s.split("=", 1) for s in a.src) or {"this": str(_build.SOURCE_DIR)}
    sources = [(k, Path(v).resolve()) for k, v in srcs.items()]
    out = Path(a.out)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    variants = [v for v in a.variants.split(",") if v]
    todo = builds(sources, out, variants)
    libs = compile_all(todo)
    results = []
    for (key, f), (_, log, sass) in libs.items():
        regs = registers(log)
        counts = sass_counts(sass)
        results.append(dict(kind="build", source=key[0], variant=key[1], file=f,
                            registers=regs, sass=counts))
        for k, c in counts.items():
            r = regs.get(k, {})
            print(f"[sass] {key[0]} {key[1]} {k}: {r.get('registers')} registers, "
                  f"{r.get('stack')} B stack, {r.get('spill')} B spill stores; "
                  f"{c['instructions']} instructions, integer divisions {c['int_div']}, "
                  f"atomics {c['atom']}; loads {c['ldg']}, stores {c['stg']}", flush=True)

    def record(rec, line):
        results.append(rec)
        print(line + f" round {rec['round']} on {card}", flush=True)

    only = {s for s in a.shapes.split(",") if s}
    rng = np.random.default_rng(15)
    probe_colour(libs, todo, dev, card, a.rounds, a.per, only, rng, results, record)
    probe_labelling(libs, todo, dev, card, a.rounds, only, rng, results, record, variants,
                    a.plans)
    probe_table_labelling(libs, todo, dev, card, a.rounds, only, rng, results, record,
                          a.plans)
    dest = Path(a.json) if a.json else out / "probe.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
