"""Time the per-sweep colour passes (``csrc/sweep.cu`` ``sweep_2d``,
``csrc/sweep_nb.cu`` ``sweep_nb``) of two source trees side by side on one
NVIDIA GPU, with variants that cure one defect of the first design or take
one part of the redesign away, and count each kernel's SASS instructions.

    python3 tools/probe_sweep.py --src old=CSRC_DIR --src new=CSRC_DIR
                                 [--out DIR] [--rounds N] [--variants a,b,...]
                                 [--shapes a,b,...] [--per]

Each ``--src`` names a directory of the port's CUDA sources; the first
design (``sweep_2d``: a CTA a block of one system through ``mega.cuh``
``update_sites``, the four pre-shifted coupling planes, a division a site,
byte loads; ``sweep_nb``: a thread a group of one system, ``nb.cuh``'s
divisions and modulos, a runtime loop over the offsets, a second coupling
array) is told from the redesign (a group of four sites of several systems
of one realization a thread, the forward couplings read once, no division;
``sweep_2d`` with 8-byte spin loads, ``sweep_nb`` templated on its
geometry) by its source.  Give the parent commit's sources (``git
archive`` of it unpacked under a directory ``.gitignore`` lists) and this
checkout's.  The script builds ``sweep.cu`` and ``sweep_nb.cu`` of every
source as they are and patched into each variant of their design, all with
nvcc for sm_90a at once (into ``--out``), and prints each kernel's ``ptxas
-v`` registers and spills and, from ``cuobjdump -sass``, its static SASS
instructions, integer-division sequences (``I2F.U32.RP``), ``MUFU.EX2``
and loads and stores by width.

Variants of the first design, one defect cured each:

* ``o-once``: the systems of a realization side by side in ``blockIdx.x``
  (their couplings then come from L2);
* ``o-nodiv``: the row a shift (``sweep_2d``) and the coordinates and wraps
  shifts and masks (``sweep_nb``): exact at the probe's power-of-two
  extents only;
* ``o-coup``: ``sweep_2d`` reads the forward couplings (``[H W, 2]``) in
  place of the four planes;
* ``o-onecoup``: ``sweep_nb`` reads the backward couplings from the forward
  array at the neighbour.

Variants of the redesign, one part taken away each:

* ``n-scalar``: the per-site path everywhere (no 8-byte spin loads);
* ``n-lb2``, ``n-lb3``: ``sweep_2d`` built for two or three CTAs an SM
  (up to 128 or 80 registers) in place of four (64);
* ``n-nophilox``: Philox replaced by a mix of its counter (wrong spins);
* ``n-runtime``: ``sweep_nb`` built for six offsets with a runtime count;
* ``n-quarter``: ``sweep_nb`` launched over a quarter of its groups (wrong
  spins): what a grid of only the active groups could save at most.

States: random +-1 spins with unit couplings at the smoke's temperatures:
``sweep_2d`` at config 3 (256^2), the harness (64^2 x 2048 systems, 16 a
realization; also gaussian), row 4 (32^2 x 16) and the unsharded 4096^2 x 4;
``sweep_nb`` at config 2 (32^2 triangular x 8), 32^3 x 16, BCC and FCC
16^3 x 8, the NNN table at 64^2 x 8 and 128^3 x 8 (the space path's
unsharded run, where the rule takes 8 systems a thread); the table form
``sweep_nb_table`` (the first design told by its source: a thread a group
of four sites of one system, a runtime loop over the offsets; the redesign
a thread a site of the colour's list of several systems) at the 4D +-J
glass (10^4, 16 x 24 systems), 16^4 x 16, 16^3 with 13 offsets x 8 and 16^3
with 9 offsets x 8 x 48, +-1 couplings.  Every base build and every
variant that keeps the function is held bitwise to ``sweep_2d_plain`` (and
its partials to ``sweep_2d_partials``) or ``sweep_nb_plain``.  ``--per``
also times the redesign with each count of systems a thread (the rule's,
``ops/sweep.py`` ``systems_per`` of half the card's resident threads, one,
and every divisor up to 8).  Times are device times of one pass (a sweep's two
or more launches over its colours, CUDA events over warm launches queued
behind a sleep kernel, divided by the colours), and of ``sweep_2d``'s
measuring pass; ``--rounds`` times with the builds in order and then
reversed.  Prints one line per measurement with the card, writes all of
them as JSON to ``--out/probe.json``.  Needs a CUDA device, nvcc and
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

from chip_smoke import card_line  # noqa: E402
from peapods_tpu_torch.ops import _build, fk, sweep  # noqa: E402
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice, fast_divisor  # noqa: E402
from probe_bonds import widths  # noqa: E402
from probe_pt_link import events_ms  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int

# (file, anchor, replacement) edits of the first design
O_ONCE = [
    ("sweep.cu", "  const int sys = blockIdx.y;\n", "  const int sys = blockIdx.x;\n"),
    ("sweep.cu", "  const int g = blockIdx.x * blockDim.x + threadIdx.x;\n",
     "  const int g = blockIdx.y * blockDim.x + threadIdx.x;\n"),
    ("sweep.cu", "  block_partials(e_acc, m_acc, e_part, m_part, row * gridDim.x + blockIdx.x);",
     "  block_partials(e_acc, m_acc, e_part, m_part, row * gridDim.y + blockIdx.y);"),
    ("sweep.cu", "  const dim3 grid(colour_pass_blocks(H, W), n_systems, n_disorder);",
     "  const dim3 grid(n_systems, colour_pass_blocks(H, W), n_disorder);"),
    ("sweep_nb.cu", "  const int sys = blockIdx.y;\n  const int dz = blockIdx.z;\n"
     "  const int g4 = blockIdx.x * blockDim.x + threadIdx.x;",
     "  const int sys = blockIdx.x;\n  const int dz = blockIdx.z;\n"
     "  const int g4 = blockIdx.y * blockDim.x + threadIdx.x;"),
    ("sweep_nb.cu", "  const dim3 grid(peapods_nb_blocks(n), n_systems, n_disorder);\n"
     "  sweep_nb_kernel<<<",
     "  const dim3 grid(n_systems, peapods_nb_blocks(n), n_disorder);\n  sweep_nb_kernel<<<"),
]
O_NODIV = [
    ("mega.cuh", "    const int r = i / wh;\n", "    const int r = i >> (31 - __clz(wh));\n"),
    ("nb.cuh", "  x %= L;\n  return x < 0 ? x + L : x;", "  return x & (L - 1);"),
    ("nb.cuh", "  for (int k = 0; k < 3; ++k) c[k] = (i / g.stride[k]) % g.L[k];",
     "  for (int k = 0; k < 3; ++k) c[k] = (i >> (31 - __clz(g.stride[k]))) & (g.L[k] - 1);"),
]
O_COUP = [
    ("mega.cuh",
     "    float field = static_cast<float>(s[static_cast<size_t>(up) * W + col]) * ju[idx] +\n"
     "                  static_cast<float>(s[static_cast<size_t>(dn) * W + col]) * jd[idx];\n"
     "    field = field + static_cast<float>(s[static_cast<size_t>(r) * W + lf]) * jl[idx];\n"
     "    field = field + static_cast<float>(s[static_cast<size_t>(r) * W + rg]) * jr[idx];",
     "    float field = static_cast<float>(s[static_cast<size_t>(up) * W + col]) *\n"
     "                      jg[2 * (static_cast<size_t>(up) * W + col)] +\n"
     "                  static_cast<float>(s[static_cast<size_t>(dn) * W + col]) * jg[2 * idx];\n"
     "    field = field + static_cast<float>(s[static_cast<size_t>(r) * W + lf]) *\n"
     "                        jg[2 * (static_cast<size_t>(r) * W + lf) + 1];\n"
     "    field = field + static_cast<float>(s[static_cast<size_t>(r) * W + rg]) * jg[2 * idx + 1];"),
    ("sweep.cu", "jgrids + static_cast<size_t>(d) * 4 * hw", "jgrids + static_cast<size_t>(d) * 2 * hw"),
]
O_ONECOUP = [
    ("sweep_nb.cu",
     "      field = field + static_cast<float>(s[neighbour(g, c, d, -1)]) * jb[b];",
     "      const int nbk = neighbour(g, c, d, -1);\n"
     "      field = field + static_cast<float>(s[nbk]) * jf[static_cast<size_t>(nbk) * g.n_nb + d];"),
]
# ... and of the redesign's
N_SCALAR = [("sweep.cu", "  const int vec = W % 8 == 0 &&", "  const int vec = 0 * (W % 8) &&")]
N_LB2 = [("sweep.cu", "constexpr int kSweepBlocks = 4;", "constexpr int kSweepBlocks = 2;")]
N_LB3 = [("sweep.cu", "constexpr int kSweepBlocks = 4;", "constexpr int kSweepBlocks = 3;")]
N_NOPHILOX = [
    ("sweep.cu", "        const uint4 r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),\n"
     "                                       static_cast<uint32_t>(colour), static_cast<uint32_t>(g),\n"
     "                                       0u);\n        const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};\n"
     "        const uint64_t w =",
     "        const uint4 r4 = make_uint4(k0 ^ g, k1 + sys, g * 0x9E3779B9u ^ colour, k0 + k1);\n"
     "        const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};\n        const uint64_t w ="),
    ("sweep_nb.cu", "    const uint4 r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),\n"
     "                                   static_cast<uint32_t>(colour), static_cast<uint32_t>(g), 0u);",
     "    const uint4 r4 = make_uint4(k0 ^ g, k1 + sys, g * 0x9E3779B9u ^ colour, k0 + k1);"),
]
N_RUNTIME = [
    ("sweep_nb.cu", "#pragma unroll\n      for (int d = 0; d < NB; ++d) {\n"
     "        const int f = nb_site<k3>(geo, r, c1, c2, d, false);",
     "#pragma unroll\n      for (int d = 0; d < NB; ++d) {\n        if (d >= geo.w.n_nb) break;\n"
     "        const int f = nb_site<k3>(geo, r, c1, c2, d, false);"),
    ("sweep_nb.cu", "        jn[2 * d] = __ldg(J + static_cast<size_t>(i) * NB + d);\n"
     "        jn[2 * d + 1] = __ldg(J + static_cast<size_t>(b) * NB + d);",
     "        jn[2 * d] = __ldg(J + static_cast<size_t>(i) * geo.w.n_nb + d);\n"
     "        jn[2 * d + 1] = __ldg(J + static_cast<size_t>(b) * geo.w.n_nb + d);"),
    ("sweep_nb.cu", "  const float* J = coup + static_cast<size_t>(dz) * n * NB;",
     "  const float* J = coup + static_cast<size_t>(dz) * n * geo.w.n_nb;"),
    ("sweep_nb.cu", "      for (int e = 0; e < 2 * NB; ++e) field = field + static_cast<float>(sn[e]) * jn[e];",
     "      for (int e = 0; e < 2 * NB; ++e)\n"
     "        if (e < 2 * geo.w.n_nb) field = field + static_cast<float>(sn[e]) * jn[e];"),
    ("sweep_nb.cu", "  switch (nb) {", "  switch (nb > 0 ? 6 : nb) {"),
]
N_QUARTER = [
    ("sweep_nb.cu", "  const dim3 grid(peapods_nb_blocks(static_cast<int>(n)), n_systems / per, n_disorder);",
     "  const dim3 grid((peapods_nb_blocks(static_cast<int>(n)) + 3) / 4, n_systems / per,"
     " n_disorder);"),
]
# name: (design, edits, whether the variant keeps the function, kernels it applies to)
VARIANTS = {
    "o-once": ("first", O_ONCE, True, ("sweep_2d", "sweep_nb")),
    "o-nodiv": ("first", O_NODIV, True, ("sweep_2d", "sweep_nb")),
    "o-coup": ("first", O_COUP, True, ("sweep_2d",)),
    "o-onecoup": ("first", O_ONECOUP, True, ("sweep_nb",)),
    "n-scalar": ("redesign", N_SCALAR, True, ("sweep_2d",)),
    "n-lb2": ("redesign", N_LB2, True, ("sweep_2d",)),
    "n-lb3": ("redesign", N_LB3, True, ("sweep_2d",)),
    "n-nophilox": ("redesign", N_NOPHILOX, False, ("sweep_2d", "sweep_nb")),
    "n-runtime": ("redesign", N_RUNTIME, True, ("sweep_nb",)),
    "n-quarter": ("redesign", N_QUARTER, False, ("sweep_nb",)),
}

T_SQ = 2.0 / np.log(1.0 + np.sqrt(2.0))
NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
# (name, shape, realizations, systems each, couplings)
SQUARE = (
    ("config3", (256, 256), 1, 1, "unit"),
    ("harness", (64, 64), 128, 16, "unit"),
    ("harness-gauss", (64, 64), 128, 16, "gauss"),
    ("row4", (32, 32), 1, 16, "unit"),
    ("space4096", (4096, 4096), 1, 4, "unit"),
)
# (name, shape, offsets, systems, temperature range)
COLOURED = (
    ("config2", (32, 32), "triangular", 8, (3.0, 4.5)),
    ("cubic32", (32, 32, 32), None, 16, (4.0, 5.0)),
    ("bcc16", (16, 16, 16), "bcc", 8, (5.5, 7.5)),
    ("fcc16", (16, 16, 16), "fcc", 8, (8.5, 11.0)),
    ("nnn64", (64, 64), NNN, 8, (4.0, 6.0)),
    ("cubic128", (128, 128, 128), None, 8, (4.4, 4.6)),
)


# the table form (4D and up, 7 to 32 offsets): (name, shape, offsets,
# realizations, systems each, temperature range), the smoke's runs
SHELLS3 = ([[1, 0, 0], [0, 1, 0], [0, 0, 1]]
           + [[1, s, 0] for s in (1, -1)] + [[1, 0, s] for s in (1, -1)]
           + [[0, 1, s] for s in (1, -1)]
           + [[1, a, b] for a in (1, -1) for b in (1, -1)])
TABLE = (
    ("glass4d", (10, 10, 10, 10), None, 16, 24, (1.6, 2.4)),
    ("4d16", (16, 16, 16, 16), None, 1, 16, (6.0, 7.4)),
    ("shells16", (16, 16, 16), SHELLS3, 1, 8, (9.0, 12.0)),
    ("nine16", (16, 16, 16), SHELLS3[:9], 8, 48, (1.5, 3.8)),
)


def design(csrc: Path) -> str:
    return "first" if "update_sites(" in (csrc / "sweep.cu").read_text() else "redesign"


def table_design(csrc: Path) -> str:
    """sweep_nb_table's design of a source: the first (a thread a group of
    one system, a runtime loop over the offsets) or the redesign (a thread a
    site of the colour's list of up to eight systems)."""
    return "redesign" if "table_terms" in (csrc / "sweep_nb.cu").read_text() else "first"


def builds(sources, out, variants):
    """``{(label, variant): (directory, design)}``: each source's base and the
    variants of its design; a variant of its own design whose anchors are
    not found stops the probe."""
    todo = {}
    for label, csrc in sources:
        own = design(csrc)
        files = {p.name: p.read_text() for p in csrc.iterdir() if p.suffix in (".cu", ".cuh")}
        for variant in ("base", *variants):
            edits = []
            if variant != "base":
                aim, edits, _, _ = VARIANTS[variant]
                if aim != own:
                    continue
                gone = [old.splitlines()[0] for f, old, _ in edits if files[f].count(old) != 1]
                if gone:
                    raise SystemExit(f"probe_sweep: {variant} does not apply to {csrc}: {gone}")
            d = out / label / variant
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            text = dict(files)
            for f, old, new in edits:
                text[f] = text[f].replace(old, new)
            for f, t in text.items():
                if f.endswith(".cuh") or f in ("sweep.cu", "sweep_nb.cu"):
                    (d / f).write_text(t)
            todo[(label, variant)] = (d, own)
    return todo


def compile_all(todo):
    """One nvcc for each build and file, all at once: ``{(key, file): (lib,
    ptxas log, sass)}``."""
    procs = []
    for key, (d, _) in todo.items():
        for f in ("sweep.cu", "sweep_nb.cu"):
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


def short(mangled: str) -> str:
    """``sweep_2d_kernel<true>``-like names of the mangled sweep kernels."""
    base = re.search(r"(sweep_2d_kernel|sweep_nb_table_kernel|sweep_nb_kernel|measure_nb_kernel)",
                     mangled)
    if not base:
        return ""
    tail = mangled.split(base.group(1), 1)[1]
    args = re.findall(r"Li(\d+)E|Lb(\d)E", tail)
    args = [a or ("true" if b == "1" else "false") for a, b in args]
    return base.group(1) + (f"<{', '.join(args)}>" if args else "")


def registers(log):
    """``{kernel: "R registers, S B stack, P B spill stores"}`` of a ptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m and short(m.group(1)):
            name = short(m.group(1))
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
    """Per sweep kernel (each template instance): its static instructions and
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
                ldg=widths(ops, "LDG"), stg=widths(ops, "STG"),
                calls=sum(o.startswith("CALL") for o in ops))

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


def square_inputs(shape, d, s, coup, dev, rng):
    h, w = shape
    j = (np.ones((d, h * w, 2), np.float32) if coup == "unit"
         else rng.standard_normal((d, h * w, 2)).astype(np.float32))
    jt = torch.from_numpy(j).to(dev)
    return dict(spins=torch.from_numpy(rng.choice([-1, 1], (d, s, h, w)).astype(np.int8)).to(dev),
                coup=jt, jgrids=sweep.pack_coupling_grids(jt, shape).contiguous(),
                temps=torch.full((d, s), T_SQ, dtype=torch.float32, device=dev),
                words=torch.from_numpy(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32))
                .to(dev), d=d, s=s, shape=shape)


def coloured_inputs(shape, offsets, s, t, dev, rng):
    lat = Lattice(shape, GEOMETRY_OFFSETS[offsets] if isinstance(offsets, str) else offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    coup = np.ones((1, n, nb), np.float32)
    return dict(lat=lat, spins=up(rng.choice([-1, 1], (1, s, n)).astype(np.int8)),
                coup=up(coup), coup_bwd=up(coup[:, lat.bwd, np.arange(nb)[None]]),
                colours=up(lat.colors.astype(np.uint8)),
                temps=up(rng.uniform(*t, (1, s)).astype(np.float32)),
                words=up(rng.integers(-2**31, 2**31, (1, 2)).astype(np.int32)), d=1, s=s)


def sweep_2d_fn(lib, first, variant, x, spins, per, parts=None):
    """One sweep (both colours) of a build's sweep_2d; ``parts``: the second
    pass measures into them."""
    fn = lib.peapods_sweep_2d
    fn.argtypes = [_P] * 6 + [_I] * (6 if first else 9) + [_P]
    fn.restype = _I
    h, w = x["shape"]
    stream = torch.cuda.current_stream().cuda_stream
    j = x["coup"] if (not first or variant == "o-coup") else x["jgrids"]
    m, s = fast_divisor(w // 2)

    def run():
        for colour in (0, 1):
            ptrs = ((None, None) if parts is None or colour == 0
                    else tuple(t.data_ptr() for t in parts))
            tail = () if first else (per, int(m), s)
            _build.check(fn(spins.data_ptr(), j.data_ptr(), x["temps"].data_ptr(),
                            x["words"].data_ptr(), *ptrs, x["d"], x["s"], h, w, colour, 0,
                            *tail, stream), "sweep_2d")
    return run


def sweep_nb_fn(lib, first, x, spins, per):
    """One sweep (each colour) of a build's sweep_nb."""
    fn = lib.peapods_sweep_nb
    lat = x["lat"]
    stream = torch.cuda.current_stream().cuda_stream
    fn.restype = _I
    if first:
        fn.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        head = (x["coup"].data_ptr(), x["coup_bwd"].data_ptr(), x["colours"].data_ptr(),
                x["temps"].data_ptr(), x["words"].data_ptr(), lat.kernel_geometry.ctypes.data)
    else:
        fn.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        head = (x["coup"].data_ptr(), x["colours"].data_ptr(), x["temps"].data_ptr(),
                x["words"].data_ptr(), lat.sweep_words.ctypes.data)

    def run():
        for colour in range(lat.n_colors):
            tail = (colour, 0) if first else (colour, 0, per)
            _build.check(fn(spins.data_ptr(), *head, x["d"], x["s"], *tail, stream), "sweep_nb")
    return run


def probe(libs, todo, dev, card, rounds, pers, only, rng, results):
    keys = list(todo)
    threads = fk.resident_threads(dev.index) // 2  # the wrappers' rule (ops/sweep.py _per)

    def record(rec, line):
        results.append(rec)
        print(line + f" round {rec['round']} on {card}", flush=True)

    for name, shape, d, s, coup in SQUARE:
        if only and name not in only:
            continue
        x = square_inputs(shape, d, s, coup, dev, rng)
        h, w = shape
        want = x["spins"].clone()
        sweep.sweep_2d_plain(want, x["jgrids"], x["temps"], x["words"], gibbs=False)
        wantp = x["spins"].clone()
        pe, pm = sweep.sweep_2d_partials(wantp, x["jgrids"], x["temps"], x["words"],
                                         gibbs=False)
        nb = _build.library().peapods_colour_pass_blocks(h, w)
        rule = sweep.systems_per(-(-(h * w // 2) // 4), d, s, threads)
        bound = sweep_bound_2d(x)
        reps = 50 if d * s * h * w < 2**24 else 10
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, variant = key
                if variant != "base" and "sweep_2d" not in VARIANTS[variant][3]:
                    continue
                first = todo[key][1] == "first"
                keeps = variant == "base" or VARIANTS[variant][2]
                lib = libs[(key, "sweep.cu")][0]
                for per in ([rule] if first or not pers or variant != "base"
                            else sorted({rule, 1, *[p for p in range(2, 9) if s % p == 0]})):
                    a = x["spins"].clone()
                    parts = (torch.empty((d, s, nb), dtype=torch.float32, device=dev),
                             torch.empty((d, s, nb), dtype=torch.int32, device=dev))
                    sweep_2d_fn(lib, first, variant, x, a, per, parts)()
                    torch.cuda.synchronize()
                    ok = None
                    if keeps:
                        ok = (torch.equal(a, wantp) and torch.equal(parts[0], pe)
                              and torch.equal(parts[1], pm))
                        if not ok:
                            raise AssertionError(
                                f"{label} {variant} sweep_2d at {name} (per {per}) differs from "
                                f"its plain version: {int((a != wantp).sum())} spins, "
                                f"{int((parts[0] != pe).sum())} e partials")
                    ms = events_ms(sweep_2d_fn(lib, first, variant, x, a, per), reps) / 2
                    mms = events_ms(sweep_2d_fn(lib, first, variant, x, a, per, parts), reps) / 2
                    rec = dict(kind="sweep_2d", source=label, variant=variant, state=name,
                               round=rnd, per=None if first else per, ms=ms, ms_measuring=mms,
                               bound_ms=bound, systems=d * s, sites=h * w, bitwise_plain=ok)
                    record(rec, f"[sweep_2d] {label} {variant} {name} ({d * s} x {h}x{w}"
                           + ("" if first else f", {per} a thread") + f"): {ms:.5f} ms a pass, "
                           f"{mms:.5f} measuring (bound {bound:.5f} ms, bytes)"
                           + (", spins and partials bitwise plain" if ok else ""))
        del x, want, wantp
        torch.cuda.empty_cache()

    for name, shape, offsets, s, t in COLOURED:
        if only and name not in only:
            continue
        x = coloured_inputs(shape, offsets, s, t, dev, rng)
        lat = x["lat"]
        want = x["spins"].clone()
        sweep.sweep_nb_plain(want, x["coup"], x["coup_bwd"], x["colours"], x["temps"],
                             x["words"], lat, gibbs=False)
        rule = sweep.systems_per(-(-lat.n_spins // 4), 1, s, threads)
        bound = sweep_bound_nb(x)
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, variant = key
                if variant != "base" and "sweep_nb" not in VARIANTS[variant][3]:
                    continue
                first = todo[key][1] == "first"
                keeps = variant == "base" or VARIANTS[variant][2]
                lib = libs[(key, "sweep_nb.cu")][0]
                for per in ([rule] if first or not pers or variant != "base"
                            else sorted({rule, 1, *[p for p in range(2, 9) if s % p == 0]})):
                    a = x["spins"].clone()
                    sweep_nb_fn(lib, first, x, a, per)()
                    torch.cuda.synchronize()
                    ok = None
                    if keeps:
                        ok = torch.equal(a, want)
                        if not ok:
                            raise AssertionError(
                                f"{label} {variant} sweep_nb at {name} (per {per}) differs from "
                                f"its plain version: {int((a != want).sum())} spins")
                    ms = events_ms(sweep_nb_fn(lib, first, x, a, per), 50) / lat.n_colors
                    rec = dict(kind="sweep_nb", source=label, variant=variant, state=name,
                               round=rnd, per=None if first else per, ms=ms, bound_ms=bound,
                               systems=s, sites=lat.n_spins, colours=lat.n_colors,
                               bitwise_plain=ok)
                    record(rec, f"[sweep_nb] {label} {variant} {name} ({s} x {lat.n_spins}, "
                           f"{lat.n_colors} colours" + ("" if first else f", {per} a thread")
                           + f"): {ms:.5f} ms a pass (bound {bound:.7f} ms, bytes)"
                           + (", spins bitwise plain" if ok else ""))
        del x, want
        torch.cuda.empty_cache()


def table_inputs(shape, offsets, d, s, t, dev, rng):
    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    coup = rng.choice([-1.0, 1.0], (d, n, nb)).astype(np.float32)
    return dict(lat=lat, spins=up(rng.choice([-1, 1], (d, s, n)).astype(np.int8)),
                coup=up(coup), coup_bwd=up(coup[:, lat.bwd, np.arange(nb)[None]]),
                colours=up(lat.colors.astype(np.uint8)),
                temps=up(rng.uniform(*t, (d, s)).astype(np.float32)),
                words=up(rng.integers(-2**31, 2**31, (d, 2)).astype(np.int32)),
                fwd=up(lat.fwd), bwd=up(lat.bwd), sites=up(lat.colour_sites[0]), d=d, s=s)


def sweep_table_fn(lib, first, x, spins, per):
    """One sweep (each colour) of a build's sweep_nb_table: the first
    design's grid of groups of one system, or the redesign's lists at
    ``per`` systems a thread (``ops/sweep.py`` ``table_sweep_plan``'s
    threads)."""
    fn = lib.peapods_sweep_nb_table
    lat = x["lat"]
    n, nb = lat.n_spins, lat.n_neighbors
    stream = torch.cuda.current_stream().cuda_stream
    fn.restype = _I
    fn.argtypes = [_P] * 7 + [_I] * (7 if first else 11) + [_P]
    starts = lat.colour_sites[1]
    dev = spins.device
    props = torch.cuda.get_device_properties(dev)
    threads = fk.resident_threads(dev.index) // 4  # the wrappers' rule (ops/sweep.py)

    def run():
        for c in range(lat.n_colors):
            if first:
                _build.check(fn(spins.data_ptr(), x["coup"].data_ptr(), x["colours"].data_ptr(),
                                x["temps"].data_ptr(), x["words"].data_ptr(),
                                x["fwd"].data_ptr(), x["bwd"].data_ptr(), n, nb, lat.self_mask,
                                x["d"], x["s"], c, 0, stream), "sweep_nb_table")
                continue
            count = int(starts[c + 1] - starts[c])
            plan = sweep.table_sweep_plan(count, x["d"], x["s"], threads,
                                          props.multi_processor_count)
            _build.check(fn(spins.data_ptr(), x["coup"].data_ptr(), x["sites"].data_ptr(),
                            x["temps"].data_ptr(), x["words"].data_ptr(), x["fwd"].data_ptr(),
                            x["bwd"].data_ptr(), n, nb, lat.self_mask, x["d"], x["s"], c,
                            int(starts[c]), count, 0, per or plan.per, plan.threads, stream),
                         "sweep_nb_table")
    return run


def probe_table(libs, todo, dev, card, rounds, pers, only, rng, results):
    """sweep_nb_table of every source at TABLE's shapes: spins bitwise
    ``sweep_nb_plain``; the redesign at each count of systems a thread with
    ``pers``."""
    keys = [k for k in todo if k[1] == "base"]
    for name, shape, offsets, d, s, t in TABLE:
        if only and name not in only:
            continue
        x = table_inputs(shape, offsets, d, s, t, dev, rng)
        lat = x["lat"]
        want = x["spins"].clone()
        sweep.sweep_nb_plain(want, x["coup"], x["coup_bwd"], x["colours"], x["temps"],
                             x["words"], lat, gibbs=False)
        n, nb, nc = lat.n_spins, lat.n_neighbors, lat.n_colors
        bound = (d * s * n + 8 * d * nb * n // nc + 8 * n * nb // nc + n
                 + d * s * n // nc) / 3.35e12 * 1e3
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                first = table_design(todo[key][0]) == "first"
                lib = libs[(key, "sweep_nb.cu")][0]
                for per in ([None] if first or not pers
                            else [None] + [p for p in range(1, 9) if s % p == 0]):
                    a = x["spins"].clone()
                    sweep_table_fn(lib, first, x, a, per)()
                    torch.cuda.synchronize()
                    if not torch.equal(a, want):
                        raise AssertionError(f"{key[0]} sweep_nb_table at {name} (per {per}) "
                                             f"differs from its plain version: "
                                             f"{int((a != want).sum())} spins")
                    ms = events_ms(sweep_table_fn(lib, first, x, a, per), 20) / nc
                    rec = dict(kind="sweep_nb_table", source=key[0], variant="base",
                               state=name, round=rnd, per=per, ms=ms, bound_ms=bound,
                               systems=d * s, sites=n, colours=nc, bitwise_plain=True,
                               design="first" if first else "redesign")
                    results.append(rec)
                    print(f"[sweep_nb_table] {key[0]} {name} ({d} x {s} x {n}, {nb} offsets, "
                          f"{nc} colours, " + ("the first design" if first else
                                               f"{per or 'the rule'}'s systems a thread")
                          + f"): {ms:.5f} ms a pass (bound {bound:.7f} ms, bytes), spins "
                          f"bitwise plain round {rnd} on {card}", flush=True)
        del x, want
        torch.cuda.empty_cache()


def sweep_bound_2d(x):
    """A pass's bytes over 3.35 TB/s: every spin, the realizations'
    couplings once, the active spins written (chip_smoke.py sweep_2d_bound)."""
    h, w = x["shape"]
    n = x["d"] * x["s"] * h * w
    return (n + 8 * x["d"] * h * w + n // 2) / 3.35e12 * 1e3


def sweep_bound_nb(x):
    """A pass's bytes over 3.35 TB/s (chip_smoke.py check_nb_kernels): every
    spin, the active sites' forward and backward couplings and the colour
    table in, the active spins out."""
    lat = x["lat"]
    n, nc, nb, s = lat.n_spins, lat.n_colors, lat.n_neighbors, x["s"]
    return (s * n + 8 * nb * n // nc + n + 4 * s + 8 + s * n // nc) / 3.35e12 * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_sweep"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all of each source's design)")
    ap.add_argument("--shapes", default="", help="comma-separated state names (default: all)")
    ap.add_argument("--per", action="store_true", help="also time the redesign with each "
                    "count of systems a thread")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_sweep: torch sees no CUDA device", file=sys.stderr)
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
    for (key, f), (_, log, sass) in libs.items():
        regs = registers(log)
        counts = sass_counts(sass)
        results.append(dict(kind="build", source=key[0], variant=key[1], file=f,
                            registers=regs, sass=counts))
        for k, c in counts.items():
            if k.startswith("measure_nb"):
                continue
            r = regs.get(k, {})
            print(f"[sass] {key[0]} {key[1]} {k}: {r.get('registers')} registers, "
                  f"{r.get('stack')} B stack, {r.get('spill')} B spill stores; "
                  f"{c['instructions']} instructions, integer divisions {c['int_div']}, "
                  f"MUFU.EX2 {c['ex2']}, calls {c['calls']}; loads {c['ldg']}, stores "
                  f"{c['stg']}", flush=True)
    only = {s for s in a.shapes.split(",") if s}
    rng = np.random.default_rng(14)
    probe(libs, todo, dev, card, a.rounds, a.per, only, rng, results)
    probe_table(libs, todo, dev, card, a.rounds, a.per, only, rng, results)
    (out / "probe.json").write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {out / 'probe.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
