"""Time the FK bond draws (``csrc/fk.cu`` ``fk_bonds``, ``fk_bonds_band`` and
the staged path's bonds) of two source trees side by side on one NVIDIA
GPU, with variants that take one part of a design away or cure one defect
of the first design, and count each kernel's SASS instructions.

    python3 tools/probe_bonds.py --src old=CSRC_DIR --src new=CSRC_DIR
                                 [--out DIR] [--rounds N] [--variants a,b,...]
                                 [--shapes a,b,...] [--per]

Each ``--src`` names a directory of the port's CUDA sources; the first
design (one site group a thread of one graph, ``fwd_site``'s divisions,
byte memory, the parents written) is told from the redesign (``bonds_body``:
a group of four sites of several graphs of one realization a thread,
division-free neighbours, 32-bit memory, no parents) by its source.  Give
the parent commit's sources (``git archive`` of it unpacked under a
directory ``.gitignore`` lists) and this checkout's.  The script builds
``fk.cu`` of every source as it is and patched into each variant of its
design, all with nvcc for sm_90a at once (into ``--out``), and prints each
kernel's ``ptxas -v`` registers and, from ``cuobjdump -sass``, its static
SASS instructions, the bonds its straight-line body draws (four sites'
directions), its integer-division sequences (``I2F.U32.RP``), ``MUFU.EX2``,
``IMAD.WIDE`` and its loads and stores by width.

Variants of the first design, one defect cured each (timing: the cured
defect's share of the time):

* ``o-noparent``: no ``parent[i] = i`` store;
* ``o-once``: the graphs of a launch side by side in ``blockIdx.x`` (those
  of a realization then read its couplings from L2);
* ``o-noindex``: each neighbour at its unwrapped index (clamped to the
  graph) and a band site's global index its window index: no division
  (wrong at the edges);
* ``o-vector``: a group's four spins one 32-bit load and its four state
  bytes one 32-bit store.

The staged path's bonds (the lattices of an offset table) are told apart
the same way: the first design is a kernel of its own
(``peapods_fk_bonds_nb``: a thread a group of four sites of one graph,
``nb.cuh``'s runtime divisions and modulos, the couplings read again for
each graph, the exp drawn for every bond, byte memory), the redesign
``fk_bonds_staged``, ``bonds_body`` on the table's whole lattice.  Its
variants of the first design, one defect cured each:

* ``s-o-nodiv``: each neighbour at the site's index plus the offset's
  (clamped to the graph): no division (wrong at the edges);
* ``s-o-once``: the graphs of a launch side by side in ``blockIdx.x``;
* ``s-o-unit``: the integer threshold of a unit bond in place of its exp;

and of the redesign, ``n-nospread``: its launches of one graph a thread
without the spread (each thread draws every direction of its group; the
redesign gives each direction a warp of its own, ``bonds_body``'s
``kSpread``).

Variants of the redesign, one part taken away each (also on the staged
bonds where the source's staged path is the redesign):

* ``n-eager``: the ``exp`` and the division drawn for every bond (no
  ``inter > 0`` gate, no integer comparison at ``inter == 1``);
* ``n-scalar``: the per-site path everywhere (no 32-bit loads and stores);
* ``n-nophilox``: Philox replaced by a mix of its counter (wrong bonds);
* ``n-lb1``: the launches whose threads loop over graphs on the kernel
  built for one block an SM (no 64-register bound).

The states are random +-1 spins with unit couplings (the main paths'
ferromagnets) at the smoke's shapes and temperatures near T_c, and the
harness with gaussian couplings (every bond through the ``exp``):
config 3 (256^2), the harness (64^2 x 2048 graphs, 16 a realization),
config 2 (32^2 triangular x 8), 32^3 x 16, the unsharded 4096^2 x 4 (one
realization), and band 0 of 4096^2 x 4, 128^3 x 8 and 32^3 FCC x 8 in 4
bands; the staged shapes BCC and FCC 16^3 x 8 and the next-nearest-neighbour
table at 64^2 x 8 (the smoke's staged runs).  Every base build and every
variant that keeps the function is held bitwise to ``fk_state_plain`` /
``fk_bonds_band_plain`` (the staged bonds: the bits of ``fk_bonds_plain``
along the table's offsets).  ``--per`` also
times the redesign with each count of graphs a thread (a realization's,
one, and ``ops/fk.py`` ``bonds_per``'s).  Times are device times of one
launch (CUDA events over warm launches queued behind a sleep kernel),
``--rounds`` times with the builds in order and then reversed.  Prints one
line per measurement with the card, writes all of them as JSON to
``--out/probe.json``.  Needs a CUDA device, nvcc and cuobjdump; imports
nothing of JAX.

``--table`` times the table form ``fk_bonds_table`` (the lattices past
three dimensions or six offsets; the first design, a group of four sites of
one graph a thread with a runtime loop over the offsets, told from the
redesign, a group of ``per`` graphs of one realization a thread or the split
form's warps sharing a group's offsets, by its source) at the table runs'
shapes: the 4D +-J glass (10^4, 16 realizations x 24 graphs), 16^4 x 16
and 16^3 with 13 offsets x 8 (unit couplings), each build's bond words
bitwise ``fk_bonds_plain``'s bits, with its variants:

* ``t-nophilox`` (both designs): Philox replaced by a cheap mix of its
  counter and keys (wrong bonds): the share of the time the draws take;
* ``t-skip`` (the redesign): no Philox block where none of the group's
  four bonds along an offset has s s_f J > 0 (the function kept);
* ``t-lb1`` (the redesign): the 4-offset kernel without its four CTAs an
  SM (no 64-register bound);
* ``t-inline`` (the redesign): the couplings other than +-1 decided
  inline, not in the out-of-line ``other_bonds``;

with ``--per`` the redesign also at every count of graphs a thread and in
the split form of 2, 4, 5 and 8 warps at one graph a thread.  It prints the
table kernels' ptxas registers and spill bytes.
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
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import bound, card_line  # noqa: E402
from peapods_tpu_torch.ops import _build, cc, fk  # noqa: E402
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, BandGeometry, Lattice  # noqa: E402
from probe_pt_link import events_ms, registers  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int

# (anchor, replacement) edits of the first design's fk.cu
O_NOPARENT = [
    ("    state[base + i] = st;\n    parent[base + i] = i;\n  }\n}\n\n// fk_bonds on a lattice",
     "    state[base + i] = st;\n  }\n}\n\n// fk_bonds on a lattice"),
]
O_ONCE = [
    ("                const Dims dims, int n_systems) {\n  const int b = blockIdx.y;\n"
     "  const int n = dims.n[0] * dims.n[1] * dims.n[2];\n  const int nd = dims.ndir;\n"
     "  const int g = blockIdx.x * blockDim.x + threadIdx.x;",
     "                const Dims dims, int n_systems) {\n  const int b = blockIdx.x;\n"
     "  const int n = dims.n[0] * dims.n[1] * dims.n[2];\n  const int nd = dims.ndir;\n"
     "  const int g = blockIdx.y * blockDim.x + threadIdx.x;"),
    ("  fk_bonds_kernel<<<site_grid(L0 * L1 * L2, kSitesPerThread, n_graphs), kThreads, 0,",
     "  fk_bonds_kernel<<<dim3(n_graphs, site_grid(L0 * L1 * L2, kSitesPerThread, 1).x),"
     " kThreads, 0,"),
    ("                     uint8_t* __restrict__ state, const BandWalk geo, int n_systems) {\n"
     "  const int b = blockIdx.y;\n  const int nw = geo.w.L[0] * geo.block;\n"
     "  const int nd = geo.w.n_nb;\n  const int g = blockIdx.x * blockDim.x + threadIdx.x;",
     "                     uint8_t* __restrict__ state, const BandWalk geo, int n_systems) {\n"
     "  const int b = blockIdx.x;\n  const int nw = geo.w.L[0] * geo.block;\n"
     "  const int nd = geo.w.n_nb;\n  const int g = blockIdx.y * blockDim.x + threadIdx.x;"),
    ("  fk_bonds_band_kernel<<<site_grid(geo.w.L[0] * geo.block, kSitesPerThread, n_graphs),",
     "  fk_bonds_band_kernel<<<dim3(n_graphs, site_grid(geo.w.L[0] * geo.block, "
     "kSitesPerThread, 1).x),"),
]
O_NOINDEX = [
    ("      const float sf = static_cast<float>(s[fwd_site(i, dims, dir)]);\n"
     "      const float inter = si * sf * J[static_cast<size_t>(i) * nd + dir];",
     "      const float sf = static_cast<float>(s[min(i + (dir == 0 ? dims.stride[0] : dir == 1"
     " ? dims.stride[1] : dims.stride[2]), n - 1)]);\n"
     "      const float inter = si * sf * J[static_cast<size_t>(i) * nd + dir];"),
    ("    const int gid = window_global(geo, w);", "    const int gid = w;"),
]
O_VECTOR = [
    ("#pragma unroll\n  for (int k = 0; k < kSitesPerThread; ++k) {\n"
     "    const int i = kSitesPerThread * g + k;\n    if (i >= n) break;\n"
     "    const float si = static_cast<float>(s[i]);\n    uint8_t st = 0;",
     "  const uint32_t sw = reinterpret_cast<const uint32_t*>(s)[g];\n  uint32_t st4 = 0;\n"
     "#pragma unroll\n  for (int k = 0; k < kSitesPerThread; ++k) {\n"
     "    const int i = kSitesPerThread * g + k;\n"
     "    const float si = static_cast<float>(static_cast<int8_t>(sw >> (8 * k)));\n"
     "    uint32_t st = 0;"),
    ("    state[base + i] = st;\n    parent[base + i] = i;\n  }\n}\n\n// fk_bonds on a lattice",
     "    st4 |= st << (8 * k);\n    parent[base + i] = i;\n  }\n"
     "  reinterpret_cast<uint32_t*>(state + base)[g] = st4;\n}\n\n// fk_bonds on a lattice"),
    ("  uint4 r[kMaxOffsets];\n  int grp = -1;\n#pragma unroll\n"
     "  for (int k = 0; k < kSitesPerThread; ++k) {\n    const int w = kSitesPerThread * g + k;\n"
     "    if (w >= nw) break;",
     "  uint4 r[kMaxOffsets];\n  int grp = -1;\n"
     "  const uint32_t sw = reinterpret_cast<const uint32_t*>(s)[g];\n  uint32_t st4 = 0;\n"
     "#pragma unroll\n  for (int k = 0; k < kSitesPerThread; ++k) {\n"
     "    const int w = kSitesPerThread * g + k;"),
    ("    const float si = static_cast<float>(s[w]);\n    uint8_t st = 0;\n#pragma unroll\n"
     "    for (int dir = 0; dir < kMaxOffsets; ++dir) {",
     "    const float si = static_cast<float>(static_cast<int8_t>(sw >> (8 * k)));\n"
     "    uint32_t st = 0;\n#pragma unroll\n    for (int dir = 0; dir < kMaxOffsets; ++dir) {"),
    ("    state[base + w] = st;\n  }\n}",
     "    st4 |= st << (8 * k);\n  }\n  reinterpret_cast<uint32_t*>(state + base)[g] = st4;\n}"),
]
# ... and of the redesign's
N_EAGER = [
    ("  if (inter == 1.0f) return (u >> 8) < thr1;\n  if (!(inter > 0.0f)) return false;\n"
     "  return uniform24(u) < 1.0f - expf(-2.0f * inter / T);",
     "  const float p = 1.0f - expf(-2.0f * inter / T);\n"
     "  return inter > 0.0f && uniform24(u) < p + 0.0f * static_cast<float>(thr1);"),
]
N_LB1 = [("  const bool loop = per > 1;", "  const bool loop = per < 1;")]
N_SCALAR = [("  const int vec = n % 4 == 0 &&", "  const int vec = 0 * (n % 4) &&")]
N_NOPHILOX = [
    ("const uint4 u = philox4x32_10(k0, k1, static_cast<uint32_t>(d), ctr, 0u, 0u);",
     "const uint4 u = make_uint4(k0 ^ ctr, k1 + ctr, ctr * 0x9E3779B9u ^ d, k0 + k1);"),
]
# ... of the staged path's first design
S_O_NODIV = [
    ("    coords(geo, i, c);\n", "    c[0] = c[1] = c[2] = 0;\n"),
    ("      const float sf = static_cast<float>(s[neighbour(geo, c, dir, 1)]);",
     "      const float sf = static_cast<float>(s[min(max(i + geo.off[dir][0] * geo.stride[0]"
     " + geo.off[dir][1] * geo.stride[1] + geo.off[dir][2], 0), n - 1)]);"),
]
S_O_ONCE = [
    ("  const int b = blockIdx.y;\n  const int n = geo.L[0] * geo.L[1] * geo.L[2];\n"
     "  const int nd = geo.n_nb;\n  const int g = blockIdx.x * blockDim.x + threadIdx.x;",
     "  const int b = blockIdx.x;\n  const int n = geo.L[0] * geo.L[1] * geo.L[2];\n"
     "  const int nd = geo.n_nb;\n  const int g = blockIdx.y * blockDim.x + threadIdx.x;"),
    ("  fk_bonds_nb_kernel<<<site_grid(geo.L[0] * geo.L[1] * geo.L[2], kSitesPerThread,\n"
     "                                 n_graphs),",
     "  fk_bonds_nb_kernel<<<dim3(n_graphs, site_grid(geo.L[0] * geo.L[1] * geo.L[2],"
     " kSitesPerThread, 1).x),"),
]
S_O_UNIT = [
    ("  const float T = temps[b];\n  const uint32_t k0 = static_cast<uint32_t>(kb[2 * b]);\n"
     "  const uint32_t k1 = static_cast<uint32_t>(kb[2 * b + 1]);\n"
     "  uint32_t w[kMaxOffsets][4];",
     "  const float T = temps[b];\n  const uint32_t thr1 = unit_threshold(T);\n"
     "  const uint32_t k0 = static_cast<uint32_t>(kb[2 * b]);\n"
     "  const uint32_t k1 = static_cast<uint32_t>(kb[2 * b + 1]);\n"
     "  uint32_t w[kMaxOffsets][4];"),
    ("      const float p = 1.0f - expf(-2.0f * inter / T);\n"
     "      if (inter > 0.0f && uniform24(w[dir][k]) < p) st |= 1u << dir;",
     "      if (bond_active(inter, w[dir][k], T, thr1)) st |= 1u << dir;"),
]
# ... and the redesign's staged form without its spread: one graph a thread
# draws every direction of its group, 256 threads a CTA
N_NOSPREAD = [("  const bool spread = kStaged && per == 1;", "  const bool spread = false;")]
# ... and of the table form (fk_bonds_table): its draws replaced (both
# designs; the anchor is the same line in each), the draws skipped where no
# bond of the group can be active, the 4-offset kernel without its minimum
# of CTAs an SM (the redesign's)
_T_DRAW = ("    const uint4 u = philox4x32_10(k0, k1, static_cast<uint32_t>(d), "
           "static_cast<uint32_t>(g),\n                                  0u, 0u);")
T_NOPHILOX = [(_T_DRAW, "    const uint4 u = make_uint4(k0 ^ static_cast<uint32_t>(g), k1 + "
               "static_cast<uint32_t>(g),\n        static_cast<uint32_t>(g) * 0x9E3779B9u ^ "
               "static_cast<uint32_t>(d), k0 + k1 + static_cast<uint32_t>(d));")]
T_SKIP = [(_T_DRAW, "    if (!sat) continue;\n" + _T_DRAW)]
T_LB1 = [("__launch_bounds__(kThreads, NB == 4 ? 4 : 1)\nfk_bonds_table_kernel(",
          "__launch_bounds__(kThreads)\nfk_bonds_table_kernel(")]
T_INLINE = [("__device__ __noinline__ uint32_t other_bonds(",
             "__device__ __forceinline__ uint32_t other_bonds(")]
# name: (design, edits, whether the variant keeps the function, the bonds
# it is timed on: "all" but the staged and table ones', "staged" only,
# "table" only, or "any" but the table's)
VARIANTS = {
    "o-noparent": ("first", O_NOPARENT, True, "all"),
    "o-once": ("first", O_ONCE, True, "all"),
    "o-noindex": ("first", O_NOINDEX, False, "all"),
    "o-vector": ("first", O_VECTOR, True, "all"),
    "s-o-nodiv": ("staged-first", S_O_NODIV, False, "staged"),
    "s-o-once": ("staged-first", S_O_ONCE, True, "staged"),
    "s-o-unit": ("staged-first", S_O_UNIT, True, "staged"),
    "n-eager": ("redesign", N_EAGER, True, "any"),
    "n-scalar": ("redesign", N_SCALAR, True, "any"),
    "n-nophilox": ("redesign", N_NOPHILOX, False, "any"),
    "n-lb1": ("redesign", N_LB1, True, "any"),
    "n-nospread": ("redesign", N_NOSPREAD, True, "staged"),
    "t-nophilox": ("table-any", T_NOPHILOX, False, "table"),
    "t-skip": ("table-redesign", T_SKIP, True, "table"),
    "t-lb1": ("table-redesign", T_LB1, True, "table"),
    "t-inline": ("table-redesign", T_INLINE, True, "table"),
}

T_SQ = 2.0 / np.log(1.0 + np.sqrt(2.0))
# (name, shape, geometry, realizations, systems each, temperature, couplings)
UNSHARDED = (
    ("config3", (256, 256), None, 1, 1, T_SQ, "unit"),
    ("harness", (64, 64), None, 128, 16, T_SQ, "unit"),
    ("harness-gauss", (64, 64), None, 128, 16, 1.0, "gauss"),
    ("config2", (32, 32), "triangular", 1, 8, 3.64, "unit"),
    ("cubic32", (32, 32, 32), None, 1, 16, 4.51, "unit"),
    ("space4096", (4096, 4096), None, 1, 4, T_SQ, "unit"),
)
# the staged runs' graphs: (name, shape, offsets, systems, temperature)
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
STAGED = (
    ("bcc16", (16, 16, 16), GEOMETRY_OFFSETS["bcc"], 8, 6.3),
    ("fcc16", (16, 16, 16), GEOMETRY_OFFSETS["fcc"], 8, 9.8),
    ("nnn64", (64, 64), NNN, 8, 5.3),
)
SHELLS3 = ([[1, 0, 0], [0, 1, 0], [0, 0, 1]]
           + [[1, s, 0] for s in (1, -1)] + [[1, 0, s] for s in (1, -1)]
           + [[0, 1, s] for s in (1, -1)]
           + [[1, a, b] for a in (1, -1) for b in (1, -1)])
# the table runs' graphs (fk_bonds_table): (name, shape, offsets,
# realizations, graphs each, temperature, couplings)
TABLE = (
    ("glass4d", (10, 10, 10, 10), None, 16, 24, 2.0, "pm"),
    ("4d16", (16, 16, 16, 16), None, 1, 16, 6.68, "unit"),
    ("shells16", (16, 16, 16), SHELLS3, 1, 8, 18.0, "unit"),
)
# band 0 of each in 4 bands: (name, shape, geometry, systems, temperature)
BANDS = (
    ("band4096", (4096, 4096), None, 4, T_SQ),
    ("band128", (128, 128, 128), None, 8, 4.51),
    ("bandfcc32", (32, 32, 32), "fcc", 8, 9.79),
)


def design(csrc: Path) -> str:
    return "redesign" if "bonds_body" in (csrc / "fk.cu").read_text() else "first"


def staged_design(csrc: Path) -> str:
    """The design of the staged path's bonds: the first (a kernel of its
    own) or the redesign (``bonds_body``'s whole-lattice form)."""
    return ("staged-first" if "peapods_fk_bonds_nb" in (csrc / "fk.cu").read_text()
            else "redesign")


def table_design(csrc: Path) -> str:
    """The design of the table form's bonds: the first (a graph a thread) or
    the redesign (``per`` graphs a thread, the CTA's staged graphs)."""
    return ("table-redesign" if "TableGraphs" in (csrc / "fk.cu").read_text()
            else "table-first")


def builds(sources, out, variants):
    """``{(label, variant): (fk.cu path, design, staged design, table
    design)}``: each source's base and the variants of its designs; a
    variant of its own design whose anchors are not found stops the
    probe."""
    todo = {}
    for label, csrc in sources:
        own = design(csrc)
        text = (csrc / "fk.cu").read_text()
        for variant in ("base", *variants):
            if variant != "base":
                aim, edits, _, timed = VARIANTS[variant]
                if aim not in (own, staged_design(csrc), table_design(csrc), "table-any") or (
                        timed == "staged" and aim != staged_design(csrc)):
                    continue
                gone = [old.splitlines()[0] for old, _ in edits if text.count(old) != 1]
                if gone:
                    raise SystemExit(f"probe_bonds: {variant} does not apply to {csrc}: {gone}")
            d = out / label / variant
            d.mkdir(parents=True, exist_ok=True)
            for h in csrc.glob("*.cuh"):
                shutil.copy(h, d / h.name)
            src = text
            for old, new in ([] if variant == "base" else VARIANTS[variant][1]):
                src = src.replace(old, new)
            (d / "fk.cu").write_text(src)
            todo[(label, variant)] = (d / "fk.cu", own, staged_design(csrc), table_design(csrc))
    return todo


def compile_all(todo):
    """One nvcc for each build, all at once: ``{key: (lib, ptxas log, sass)}``."""
    procs = []
    for key, (src, *_) in todo.items():
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


def widths(ops, kind):
    """Counts of the ``kind`` (LDG, STG) instructions by width: 8-bit, 32,
    64 and 128."""
    out = dict.fromkeys(("8", "32", "64", "128"), 0)
    for o in ops:
        if o.startswith(kind):
            parts = o.split(".")
            w = next((p for p in ("128", "64") if p in parts), None)
            w = w or ("8" if {"U8", "S8"} & set(parts) else "32")
            out[w] += 1
    return out


def sass_counts(sass: str) -> dict:
    """Per bond kernel (each template instance): its static instructions and
    those of a few kinds, from ``cuobjdump -sass``."""
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
                ex2=sum(o.startswith("MUFU.EX2") for o in ops),
                imad_wide=sum(o.startswith("IMAD.WIDE.U32") for o in ops),
                ldg=widths(ops, "LDG"), stg=widths(ops, "STG"),
                calls=sum(o.startswith("CALL") for o in ops))

    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            fn = m.group(1)
            name = None
            kind = next((k for k in ("fk_bonds_band", "fk_bonds_staged", "fk_bonds_table",
                                     "fk_bonds_nb", "fk_bonds") if f"{k}_kernel" in fn), None)
            if kind:
                args = [f"{'true' if v == '1' else 'false'}" if t == "b" else v
                        for t, v in re.findall(r"L([ib])(\d+)E", fn.split("_kernel", 1)[1])]
                name = kind + (f"<{', '.join(args)}>" if args else "")
            body = []
        else:
            body.append(ln)
    close()
    return out


def unsharded_inputs(shape, geometry, d, s, temp, coup, dev, rng):
    lat = Lattice(shape, GEOMETRY_OFFSETS[geometry] if geometry else None)
    b, n, nd = d * s, lat.n_spins, lat.n_neighbors
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    j = (np.ones((d, n, nd), np.float32) if coup == "unit"
         else rng.standard_normal((d, n, nd)).astype(np.float32))
    return dict(spins=up(rng.choice([-1, 1], size=(b, *shape)).astype(np.int8)), j=up(j),
                temps=torch.full((b,), temp, dtype=torch.float32, device=dev),
                kb=up(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)),
                b=b, n=n, nd=nd, s=s, shape=tuple(shape), tri=geometry == "triangular")


def band_inputs(shape, geometry, s, temp, dev, rng):
    lat = Lattice(shape, GEOMETRY_OFFSETS[geometry] if geometry else None)
    band = BandGeometry(lat, 4).bands[0]
    nw, nb = band.n_window, lat.n_neighbors
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(spins=up(rng.choice([-1, 1], size=(s, nw)).astype(np.int8)),
                j=torch.ones((1, nw, nb), dtype=torch.float32, device=dev),
                temps=torch.full((s,), temp, dtype=torch.float32, device=dev),
                kb=up(rng.integers(-2**31, 2**31, (s, 2)).astype(np.int32)),
                band=band, b=s, n=nw, nd=nb, s=s)


def staged_inputs(shape, offsets, s, temp, dev, rng):
    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(spins=up(rng.choice([-1, 1], size=(s, *shape)).astype(np.int8)),
                j=torch.ones((1, n, nb), dtype=torch.float32, device=dev),
                temps=torch.full((s,), temp, dtype=torch.float32, device=dev),
                kb=up(rng.integers(-2**31, 2**31, (s, 2)).astype(np.int32)),
                lat=lat, b=s, n=n, nd=nb, s=s)


def launcher(lib, first, x, form, per):
    """``(fn, state)``: one launch of a build's fk_bonds, fk_bonds_band or
    staged bonds (``form``; ``first``: the build's design of that form is
    the first)."""
    dev = x["spins"].device
    b, n = x["b"], x["n"]
    band = form == "band"
    state = torch.zeros((b, n), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (x["spins"].data_ptr(), x["j"].data_ptr(), x["temps"].data_ptr(),
            x["kb"].data_ptr(), state.data_ptr())
    if form == "staged":
        if first:
            fn = lib.peapods_fk_bonds_nb
            fn.argtypes = [_P] * 6 + [_I] * 2 + [_P]
            args = (*head, x["lat"].kernel_geometry.ctypes.data, b, x["s"], stream)
        else:
            fn = lib.peapods_fk_bonds_staged
            fn.argtypes = [_P] * 6 + [_I] * 3 + [_P]
            args = (*head, x["lat"].sweep_words.ctypes.data, b, x["s"], per, stream)
    elif band:
        fn = lib.peapods_fk_bonds_band
        fn.argtypes = [_P] * 6 + [_I] * (2 if first else 3) + [_P]
        args = (*head, x["band"].words.ctypes.data, b, x["s"], *(() if first else (per,)),
                stream)
    elif first:
        fn = lib.peapods_fk_bonds
        fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        parent = torch.empty((b, n), dtype=torch.int32, device=dev)
        state.parent = parent  # held with the state
        args = (*head, parent.data_ptr(), b, x["s"], *_build.dims3(x["shape"]), int(x["tri"]),
                stream)
    else:
        fn = lib.peapods_fk_bonds
        fn.argtypes = [_P] * 6 + [_I] * 3 + [_P]
        args = (*head, fk.bonds_words(x["shape"], x["nd"]).ctypes.data, b, x["s"], per, stream)
    fn.restype = _I
    return (lambda: _build.check(fn(*args), "fk_bonds")), state


def plain_state(x, form):
    if form == "staged":
        bonds = fk.fk_bonds_plain(x["spins"], x["j"], x["temps"], x["kb"],
                                  offsets=x["lat"].offsets)
        bits = torch.arange(x["nd"], dtype=torch.uint8, device=bonds.device)
        return (bonds.to(torch.uint8) << bits).sum(-1, dtype=torch.uint8)
    if form == "band":
        buf = SimpleNamespace(state=torch.empty((x["b"], x["n"]), dtype=torch.uint8,
                                                device=x["spins"].device))
        fk.fk_bonds_band_plain(x["spins"], x["j"], x["temps"], x["kb"], buf, x["band"])
        return buf.state
    return fk.fk_state_plain(x["spins"], x["j"], x["temps"], x["kb"])


def bound_ms(x):
    """The function's bytes over 3.35 TB/s: spins in, the realizations'
    couplings once, temperatures and keys, the state bytes out."""
    d = x["b"] // x["s"]
    return (2 * x["b"] * x["n"] + 4 * x["nd"] * d * x["n"] + 12 * x["b"]) / 3.35e12 * 1e3


def probe(libs, todo, states, dev, card, rounds, pers, results):
    keys = list(libs)
    for name, x, form in states():
        want = plain_state(x, form)
        reps = 50 if x["b"] * x["n"] < 2**24 else 10
        rule = fk.bonds_per(x["n"], x["b"], x["s"], fk.resident_threads(dev.index))
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, variant = key
                staged = form == "staged"
                first = todo[key][2 if staged else 1] != "redesign"
                spec = VARIANTS.get(variant)
                if spec and (spec[3] in ("table", "all" if staged else "staged")
                             or (staged and spec[0] == "redesign" and first)):
                    continue  # not this form's variant, or not of its design here
                keeps = variant == "base" or spec[2]
                for per in ([rule] if first or not pers or variant != "base"
                            else sorted({rule, x["s"], 1})):
                    fn, state = launcher(libs[key][0], first, x, form, per)
                    fn()
                    torch.cuda.synchronize()
                    ok = bool(torch.equal(state, want)) if keeps else None
                    if keeps and not ok:
                        raise AssertionError(f"{label} {variant} at {name} (per {per}) "
                                             f"differs from its plain version: "
                                             f"{int((state != want).sum())} bytes")
                    ms = events_ms(fn, reps)
                    kind = {"band": "fk_bonds_band", "staged": "staged"}.get(form, "fk_bonds")
                    rec = dict(kind=kind, source=label,
                               variant=variant, state=name, round=rnd, per=None if first else per,
                               ms=ms, bound_ms=bound_ms(x), graphs=x["b"], sites=x["n"],
                               bitwise_plain=ok)
                    results.append(rec)
                    print(f"[{rec['kind']}] {label} {variant} {name} ({x['b']} x {x['n']} sites"
                          + ("" if first else f", {per} a thread") + f"): {ms:.5f} ms a launch "
                          f"(bound {rec['bound_ms']:.5f} ms, bytes)"
                          + (", state bytes bitwise plain" if ok else "")
                          + f" round {rnd} on {card}", flush=True)
                    del state
        del x, want
        torch.cuda.empty_cache()


def table_inputs(shape, offsets, d, s, temp, coup, dev, rng):
    lat = Lattice(shape, offsets)
    assert lat.table
    b, n, nb = d * s, lat.n_spins, lat.n_neighbors
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    j = (np.ones((d, n, nb), np.float32) if coup == "unit"
         else rng.choice([-1.0, 1.0], size=(d, n, nb)).astype(np.float32))
    return dict(spins=up(rng.choice([-1, 1], size=(b, *shape)).astype(np.int8)), j=up(j),
                temps=torch.full((b,), temp, dtype=torch.float32, device=dev),
                kb=up(rng.integers(-2**31, 2**31, (b, 2)).astype(np.int32)),
                fwd=lat.device_tables(dev)[0], lat=lat, b=b, n=n, nb=nb, s=s, d=d)


def table_launcher(lib, first, x, plan):
    """``(fn, state)``: one launch of a build's fk_bonds_table (the
    redesign on ``plan``'s graphs a thread and split)."""
    dev = x["spins"].device
    state = torch.zeros((x["b"], x["n"]), dtype=torch.int32, device=dev)
    fn = lib.peapods_fk_bonds_table
    fn.restype = _I
    head = (x["spins"].data_ptr(), x["j"].data_ptr(), x["temps"].data_ptr(),
            x["kb"].data_ptr(), state.data_ptr(), x["fwd"].data_ptr(), x["n"], x["nb"],
            x["b"], x["s"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if first:
        fn.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        args = (*head, stream)
    else:
        fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        args = (*head, plan.per, plan.split, stream)
    return (lambda: _build.check(fn(*args), "fk_bonds_table")), state


def table_registers(log: str, kernel: str = "fk_bonds_table") -> dict:
    """``{kernel<args>: "R registers, S B spilled"}`` of a kernel's template
    instances in a ``ptxas -v`` log (spill stores and loads added)."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            name = None
            if f"{kernel}_kernel" in fn:
                args = re.findall(r"Li(\d+)E|Lb([01])E", fn.split("_kernel", 1)[1])
                name = kernel + f"<{', '.join(a or b for a, b in args)}>"
            spill = 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} registers, {spill} B spilled"
            name = None
    return out


def table_bound(x):
    """``chip_smoke.py`` ``any_bounds``' bonds on a table lattice: every
    spin, the couplings and the forward table read once, a word a site
    written; three f32 operations a bond (the Philox rounds left out)."""
    b, n, nb, d = x["b"], x["n"], x["nb"], x["d"]
    return bound(b * n + 4 * d * n * nb + 4 * n * nb + 4 * b * n, 3 * nb * b * n)


def probe_table(libs, todo, dev, card, rounds, pers, only, rng, results):
    """fk_bonds_table of every source's base build and its table variants at
    TABLE: bond words bitwise ``fk_bonds_plain``'s bits; with ``pers`` the
    redesign at every count of graphs a thread and split form."""
    keys = [k for k in todo if k[1] == "base" or VARIANTS[k[1]][3] == "table"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, shape, offsets, d, s, temp, coup in TABLE:
        if only and name not in only:
            continue
        x = table_inputs(shape, offsets, d, s, temp, coup, dev, rng)
        n, nb = x["n"], x["nb"]
        want = cc.pack_masks(fk.fk_bonds_plain(x["spins"], x["j"], x["temps"], x["kb"],
                                               offsets=x["lat"].offsets), torch.int32)
        b_ms, b_by = table_bound(x)
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, variant = key
                first = todo[key][3] == "table-first"
                keeps = variant == "base" or VARIANTS[variant][2]
                rule = None if first else fk.table_bonds_plan(
                    n, nb, d, s, fk.resident_threads(dev.index) // 8, sms)
                forms = [rule]
                if pers and not first:
                    forms += [fk.TableBondsPlan(p, 1, 256, None) for p in range(1, 9)
                              if s % p == 0 and (p, 1) != rule[:2]]
                    forms += [fk.TableBondsPlan(1, k, 32 * k, None) for k in (2, 4, 5, 8)
                              if k <= nb and (1, k) != rule[:2]]
                for plan in ([None] if first else forms if variant == "base" else [rule]):
                    fn, state = table_launcher(libs[key][0], first, x, plan)
                    fn()
                    torch.cuda.synchronize()
                    ok = bool(torch.equal(state, want)) if keeps else None
                    if keeps and not ok:
                        raise AssertionError(f"{label} {variant} fk_bonds_table at {name} "
                                             f"({plan}) differs from its plain version: "
                                             f"{int((state != want).sum())} words")
                    ms = events_ms(fn, 50)
                    form = ("the first design" if first else
                            f"{plan.per} graphs a thread" + (f", {plan.split} warps a group"
                                                             if plan.split > 1 else ""))
                    results.append(dict(kind="fk_bonds_table", source=label, variant=variant,
                                        state=name, round=rnd, per=None if first else plan.per,
                                        split=None if first else plan.split,
                                        rule=not first and plan == rule, ms=ms, bound_ms=b_ms,
                                        bound_by=b_by, graphs=x["b"], sites=n, offsets=nb,
                                        bitwise_plain=ok,
                                        design="first" if first else "redesign"))
                    print(f"[fk_bonds_table] {label} {variant} {name} ({x['b']} x {n} sites, "
                          f"{nb} offsets, {form}): {ms:.5f} ms a launch (bound {b_ms:.6f} ms, "
                          f"{b_by})" + (", words bitwise plain" if ok else "")
                          + f" round {rnd} on {card}", flush=True)
                    del state
        del x, want
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_bonds"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all of each source's design)")
    ap.add_argument("--shapes", default="", help="comma-separated state names (default: all)")
    ap.add_argument("--per", action="store_true", help="also time the redesign with each "
                    "count of graphs a thread")
    ap.add_argument("--table", action="store_true",
                    help="also time the table form fk_bonds_table at the table runs' shapes")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_bonds: torch sees no CUDA device", file=sys.stderr)
        return 1
    srcs = dict(s.split("=", 1) for s in a.src) or {"this": str(_build.SOURCE_DIR)}
    sources = [(k, Path(v).resolve()) for k, v in srcs.items()]
    out = Path(a.out)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    todo = builds(sources, out, [v for v in a.variants.split(",") if v])
    libs = compile_all(todo)
    results = []
    for key, (_, log, sass) in libs.items():
        regs = {k: v for k, v in registers(log).items() if k.startswith("fk_bonds")}
        counts = sass_counts(sass)
        results.append(dict(kind="build", source=key[0], variant=key[1], registers=regs,
                            sass=counts))
        print(f"[ptxas] {key[0]} {key[1]}: " + "; ".join(f"{k} {v}" for k, v in regs.items()),
              flush=True)
        tregs = table_registers(libs[key][1])
        results[-1]["table_registers"] = tregs
        print(f"[ptxas] {key[0]} {key[1]} table: "
              + "; ".join(f"{k} {v}" for k, v in tregs.items()), flush=True)
        for k, c in counts.items():
            nb = int(k.split("<")[1].split(",")[0].rstrip(">")) if k.endswith(">") else None
            per_bond = "" if not nb else f", {c['instructions'] / (4 * nb):.1f} a bond"
            print(f"[sass] {key[0]} {key[1]} {k}: {c['instructions']} instructions{per_bond}; "
                  f"integer divisions {c['int_div']}, MUFU.EX2 {c['ex2']}, IMAD.WIDE.U32 "
                  f"{c['imad_wide']}, calls {c['calls']}; loads {c['ldg']}, stores {c['stg']}",
                  flush=True)
    only = {s for s in a.shapes.split(",") if s}
    rng = np.random.default_rng(13)

    def states():
        for name, shape, geometry, d, s, temp, coup in UNSHARDED:
            if not only or name in only:
                yield (name, unsharded_inputs(shape, geometry, d, s, temp, coup, dev, rng),
                       "fused")
        for name, shape, geometry, s, temp in BANDS:
            if not only or name in only:
                yield name, band_inputs(shape, geometry, s, temp, dev, rng), "band"
        for name, shape, offsets, s, temp in STAGED:
            if not only or name in only:
                yield name, staged_inputs(shape, offsets, s, temp, dev, rng), "staged"

    probe(libs, todo, states, dev, card, a.rounds, a.per, results)
    if a.table:
        probe_table(libs, todo, dev, card, a.rounds, a.per, only, rng, results)
    (out / "probe.json").write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {out / 'probe.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
