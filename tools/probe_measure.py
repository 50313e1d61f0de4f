"""Time the two measurement kernels (``csrc/sweep_nb.cu`` ``measure_nb``,
the per-sweep path's (e, m) partials on the coloured lattices, and
``csrc/overlap.cu`` ``energy_partials``, the replica path's energies after
a move) of two source trees side by side on one NVIDIA GPU, with variants
that cure one defect of the first design or take one part of the redesign
away, and count each kernel's SASS integer-division sequences.

    python3 tools/probe_measure.py --src old=CSRC_DIR --src new=CSRC_DIR
                                   [--out DIR] [--rounds N] [--variants a,b,...]
                                   [--shapes a,b,...] [--json PATH]

Each ``--src`` names a directory of the port's CUDA sources; the first
designs (``measure_nb``: a thread a group of one system, ``nb.cuh``'s
coordinates and neighbours by runtime division, a runtime loop over the
offsets; ``energy_partials``: a thread a site, ``fwd_site``'s divisions,
byte loads; both read the couplings again for every system and pair a
block's partial over eight barriers) are told from the redesigns by their
source.  Give the parent commit's sources (``git archive`` of it unpacked
under a directory ``.gitignore`` lists) and this checkout's.  The script
builds ``sweep_nb.cu`` and ``overlap.cu`` of every source as they are and
patched into each variant of their design, all with nvcc for sm_90a at once
(into ``--out``), and prints each kernel's ``ptxas -v`` registers and, from
``cuobjdump -sass``, its static instructions and integer-division sequences
(``I2F.U32.RP``).

Variants of the first designs, one defect cured each (``m-``: measure_nb,
``e-``: energy_partials):

* ``m-o-nodiv``, ``e-o-nodiv``: each neighbour at a clamped ``i + d + 1``
  (``i + stride``): no division (wrong values, the loads kept);
* ``m-o-warp``, ``e-o-warp``: the block's partial paired by one warp
  (``warp_tree``) in place of the eight-barrier tree (bitwise).

Variants of the redesigns, one part taken away each:

* ``m-n-div``: coordinates and neighbours by runtime divisions and
  modulos again (``/``, ``wrap``);
* ``m-n-mul``, ``e-n-mul``: each bond's term as the product of the spins
  and J in floats in place of J's sign flipped (bitwise the same);
* ``m-n-per1``, ``m-n-per2``: one or two systems a thread;
* ``e-n-div``: the warp's and words' indices by runtime divisions;
* ``e-n-words4``, ``e-n-bytes``: 4-byte words and the per-site path at
  every shape (the spins' alignment as if 4 or 1);
* ``e-n-per1``, ``e-n-per2``, ``e-n-per4``, ``e-n-per8``: systems a warp
  other than the rule's;
* ``e-n-lb4``: the kernel built for four CTAs an SM (at most 64
  registers);
* ``t-lb0``: ``measure_nb_table`` with no minimum of CTAs an SM (the
  redesign asks four at 4 offsets, one elsewhere); ``t-unroll2``: its loop
  over the systems unrolled twice.

The states are random +-1 spins and gaussian couplings at the main paths'
shapes: ``measure_nb`` at BCC and FCC 16^3 x 8 and NNN 64^2 x 8 (the staged
paths), config 2 (32^2 triangular x 8) and 32^3 x 16; ``energy_partials``
at configs 5 and 4 (16^3 and 8^3, 96 systems, 8 realizations) and the 64^2
glass of overlap observe (16 systems, 4 realizations); the table form
``measure_nb_table`` (the first design, a thread a group of one system
and a runtime loop over the offsets, told from the redesign, a group of
``per`` systems a thread with the group's table rows and couplings read
once, by its source) at the table runs' shapes: the 4D glass (10^4, 16
realizations x 24 systems), 16^4 x 16, nine16 (16^3 with 9 offsets, 8 x
48; nine16x24 8 x 24) and 16^3 with 13 offsets x 8 (``--per``: the
redesign also at every other count of systems a thread; ``--bits``:
``tools/measure_bits.cu``, the sign-bit form, a cluster of CTAs a
realization staging one sign word a site, at the shapes of at most 32
systems a realization).  Every build and
every variant that keeps the function is held bitwise to the block plain
version (``measure_nb_plain`` / ``energy_partials_plain(blocks=True)``).
Times are device times of one launch (CUDA events over warm launches
queued behind a sleep kernel), ``--rounds`` times with the builds in order
and then reversed.  Prints one line per measurement with the card, writes
all of them as JSON to ``--json`` (default ``--out/probe.json``).  Needs a
CUDA device, nvcc and cuobjdump; imports nothing of JAX.
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
from peapods_tpu_torch.ops import _build, energy, overlap  # noqa: E402
from peapods_tpu_torch.ops.fk import resident_threads  # noqa: E402
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, Lattice  # noqa: E402
from probe_pt_link import events_ms  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
FILES = {"measure_nb": "sweep_nb.cu", "energy_partials": "overlap.cu"}

_OLD_TREE = "  block_partials(e_acc, m_acc, e_part, m_part, "
_WARP = ("  {\n    __shared__ float se_[kThreads];\n    __shared__ int sm_[kThreads];\n"
         "    se_[threadIdx.x] = e_acc;\n    sm_[threadIdx.x] = m_acc;\n    __syncthreads();\n"
         "    if (threadIdx.x < 32) {\n      const float et = warp_tree(se_, threadIdx.x);\n"
         "      const int mt = warp_tree(sm_, threadIdx.x);\n      if (threadIdx.x == 0) {\n"
         "        e_part[{o}] = et;\n        m_part[{o}] = mt;\n      }\n    }\n  }\n")
M_O_NODIV = [("    int c[3];\n    coords(g, i, c);\n", ""),
             ("s[neighbour(g, c, d, 1)]", "s[min(i + d + 1, n - 1)]")]
M_O_WARP = [(_OLD_TREE + "row * gridDim.x + blockIdx.x);\n",
             _WARP.replace("{o}", "row * gridDim.x + blockIdx.x"))]
E_O_NODIV = [("s[fwd_site(i, g, dir)]", "s[min(i + g.stride[dir], n - 1)]")]
E_O_WARP = [(_OLD_TREE.rstrip() + "\n                 (static_cast<size_t>(d) * n_slots + sys) "
             "* gridDim.x + blockIdx.x);\n",
             _WARP.replace("{o}", "(static_cast<size_t>(d) * n_slots + sys) * gridDim.x + "
                           "blockIdx.x"))]
M_N_DIV = [
    ("    int r = band_coords(geo, i0, c1, c2);\n",
     "    int r = i0 / geo.block;\n    c1 = (i0 - r * geo.block) / geo.w.L[2];\n"
     "    c2 = i0 - r * geo.block - c1 * geo.w.L[2];\n"),
    ("      for (int d = 0; d < NB; ++d) nbr[k][d] = nb_site<k3>(geo, r, c1, c2, d, false);\n",
     "      for (int d = 0; d < NB; ++d)\n        nbr[k][d] = (wrap(r + geo.w.off[d][0], "
     "geo.w.L[0]) * geo.w.L[1] +\n                     wrap(c1 + geo.w.off[d][1], geo.w.L[1])) "
     "* geo.w.L[2] +\n                    (k3 ? wrap(c2 + geo.w.off[d][2], geo.w.L[2]) : 0);\n")]
M_N_MUL = [("e = e + bond_term(sv[k], sn[k][d], jc[k * NB + d]);",
            "e = e + static_cast<float>(sv[k]) * static_cast<float>(sn[k][d]) * jc[k * NB + d];")]
E_N_MUL = [("        if (k3) x = x + bond_term(xa, b, jc[ND * site]);\n"
            "        x = x + bond_term(xb, b, jc[ND * site + ND - 2]);\n"
            "        x = x + bond_term(xf, b, jc[ND * site + ND - 1]);\n",
            "        const float si = spin_at(w0, b);\n"
            "        if (k3) x = x + si * spin_at(w[3][j], b) * jc[ND * site];\n"
            "        x = x + si * spin_at(w[2][j], b) * jc[ND * site + ND - 2];\n"
            "        x = x + si * spin_at(w0 ^ xf, b) * jc[ND * site + ND - 1];\n")]
E_N_LB4 = [("__launch_bounds__(kThreads)\nenergy_partials_kernel(",
            "__launch_bounds__(kThreads, 4)\nenergy_partials_kernel(")]
E_N_DIV = [("  const int rest = fast_div(gw, g.m[2], g.s[2]);", "  const int rest = gw / g.nb;"),
           ("  const int dz = fast_div(rest, g.m[3], g.s[3]);", "  const int dz = rest / g.sets;"),
           ("    const int line = fast_div(k, g.m[0], g.s[0]);", "    const int line = k / g.wpl;"),
           ("      ca = fast_div(line, g.m[1], g.s[1]);", "      ca = line / g.Lb;")]

# ... and of the table redesign (measure_nb_table, "t-" variants: built only
# for a source whose table form is the redesign)
T_LB0 = [("__launch_bounds__(kThreads, NB == 4 && !kTail ? 4 : 1)\nmeasure_nb_table_kernel(",
          "__launch_bounds__(kThreads)\nmeasure_nb_table_kernel(")]
T_UNROLL2 = [("    for (int q = 0; q < per; ++q) {\n      float acc = 0.0f;\n      int m = 0;\n"
              "      if (has) {\n        const int8_t* s = s0",
              "#pragma unroll 2\n    for (int q = 0; q < per; ++q) {\n      float acc = 0.0f;\n"
              "      int m = 0;\n      if (has) {\n        const int8_t* s = s0")]

# name: (kernel, design, source edits, host plan or None, keeps the function);
# a host plan is measure_nb's per or energy_partials' (align, per)
VARIANTS = {
    "m-o-nodiv": ("measure_nb", "first", M_O_NODIV, None, False),
    "m-o-warp": ("measure_nb", "first", M_O_WARP, None, True),
    "m-n-div": ("measure_nb", "redesign", M_N_DIV, None, True),
    "m-n-mul": ("measure_nb", "redesign", M_N_MUL, None, True),
    "m-n-per1": ("measure_nb", "redesign", [], 1, True),
    "m-n-per2": ("measure_nb", "redesign", [], 2, True),
    "e-o-nodiv": ("energy_partials", "first", E_O_NODIV, None, False),
    "e-o-warp": ("energy_partials", "first", E_O_WARP, None, True),
    "e-n-div": ("energy_partials", "redesign", E_N_DIV, None, True),
    "e-n-mul": ("energy_partials", "redesign", E_N_MUL, None, True),
    "e-n-words4": ("energy_partials", "redesign", [], (4, 0), True),
    "e-n-bytes": ("energy_partials", "redesign", [], (1, 0), True),
    "e-n-per1": ("energy_partials", "redesign", [], (0, 1), True),
    "e-n-per2": ("energy_partials", "redesign", [], (0, 2), True),
    "e-n-per4": ("energy_partials", "redesign", [], (0, 4), True),
    "e-n-per8": ("energy_partials", "redesign", [], (0, 8), True),
    "e-n-lb4": ("energy_partials", "redesign", E_N_LB4, None, True),
    "t-lb0": ("measure_nb", "redesign", T_LB0, None, True),
    "t-unroll2": ("measure_nb", "redesign", T_UNROLL2, None, True),
}

NNN = [[1, 0], [0, 1], [1, 1], [1, -1]]
# (name, kernel, shape, offsets, realizations, systems)
SHAPES = (("bcc16", "measure_nb", (16, 16, 16), "bcc", 1, 8),
          ("fcc16", "measure_nb", (16, 16, 16), "fcc", 1, 8),
          ("nnn64", "measure_nb", (64, 64), NNN, 1, 8),
          ("config2", "measure_nb", (32, 32), "triangular", 1, 8),
          ("cubic32", "measure_nb", (32, 32, 32), None, 1, 16),
          ("config5", "energy_partials", (16, 16, 16), None, 8, 96),
          ("config4", "energy_partials", (8, 8, 8), None, 8, 96),
          ("glass64", "energy_partials", (64, 64), None, 4, 16))


def design(csrc: Path, kernel: str) -> str:
    text = (csrc / FILES[kernel]).read_text()
    mark = "bond_term(" if kernel == "measure_nb" else "EnergyWalk"
    return "redesign" if mark in text else "first"


def builds(sources, out, variants):
    """``{(label, kernel, variant): (source path or None, design)}``: each
    source's base builds of both kernels' files and the variants of their
    designs that edit a source (a host-plan variant shares its base's
    build); a variant whose anchors are not found stops the probe."""
    todo = {}
    for label, csrc in sources:
        for kernel, fname in FILES.items():
            own = design(csrc, kernel)
            text = (csrc / fname).read_text()
            for variant in ("base", *variants):
                edits = []
                if variant != "base":
                    kern, aim, edits, _, _ = VARIANTS[variant]
                    if kern != kernel or aim != own:
                        continue
                    if variant.startswith("t-") and table_design(csrc) != "redesign":
                        continue
                    gone = [old.splitlines()[0] for old, _ in edits if text.count(old) != 1]
                    if gone:
                        raise SystemExit(f"probe_measure: {variant} does not apply to "
                                         f"{csrc}: {gone}")
                    if not edits:
                        todo[(label, kernel, variant)] = (None, own)
                        continue
                d = out / label / kernel / variant
                d.mkdir(parents=True, exist_ok=True)
                for h in csrc.glob("*.cuh"):
                    shutil.copy(h, d / h.name)
                src = text
                for old, new in edits:
                    src = src.replace(old, new)
                (d / fname).write_text(src)
                todo[(label, kernel, variant)] = (d / fname, own)
    return todo


def _kernel_name(fn):
    for k in ("measure_nb_table", *FILES):
        if f"{k}_kernel" in fn:
            args = re.findall(r"Li(\d+)E|Lb([01])E", fn.split("_kernel", 1)[1])
            args = [a or b for a, b in args]
            return k + (f"<{', '.join(args)}>" if args else "")
    return None


def registers(log: str) -> dict:
    """``{kernel<args>: "R registers, S B spilled"}`` of the measurement
    kernels in a ``ptxas -v`` log."""
    out, name, spill = {}, None, 0
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
            out[name] = f"{m.group(1)} registers, {spill} B spilled"
            name = None
    return out


def sass_counts(sass: str) -> dict:
    """Per measurement kernel (each template instance): its static
    instructions and integer-division sequences (``I2F.U32.RP``), from
    ``cuobjdump -sass``."""
    out, name, body = {}, None, []

    def close():
        if name:
            ops = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*(@!?U?P\w+\s+)?", "", ln).split(" ")[0]
                   for ln in body if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
            ops = [o.rstrip(";") for o in ops if o and o.rstrip(";") != "NOP"]
            out[name] = dict(instructions=len(ops),
                             int_div=sum(o.startswith(("I2F.U32.RP", "I2F.RP")) for o in ops))

    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            name = _kernel_name(m.group(1))
            body = []
        else:
            body.append(ln)
    close()
    return out


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


def inputs(kernel, shape, geometry, d, n_sys, dev, rng):
    offsets = GEOMETRY_OFFSETS[geometry] if isinstance(geometry, str) else geometry
    lat = Lattice(shape, offsets)
    n, nb = lat.n_spins, lat.n_neighbors
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(kernel=kernel, lat=lat, shape=tuple(shape), d=d, s=n_sys, n=n, nb=nb,
                spins=up(rng.choice(np.array([-1, 1], np.int8), size=(d, n_sys, n))),
                coup=up(rng.standard_normal((d, n, nb)).astype(np.float32)))


def launcher(lib, first, x, plan):
    """``(fn, e_part, m_part)``: one launch of a build's kernel."""
    dev = x["spins"].device
    d, s, n = x["d"], x["s"], x["n"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x["kernel"] == "measure_nb":
        nb = -(-(-(-n // 4)) // 256)
        e = torch.empty((d, s, nb), dtype=torch.float32, device=dev)
        m = torch.empty((d, s, nb), dtype=torch.int32, device=dev)
        fn = lib.peapods_measure_nb
        fn.restype = _I
        lat = x["lat"]
        head = (x["spins"].data_ptr(), x["coup"].data_ptr())
        if first:
            fn.argtypes = [_P] * 5 + [_I] * 2 + [_P]
            args = (*head, lat.kernel_geometry.ctypes.data, e.data_ptr(), m.data_ptr(), d, s,
                    stream)
        else:
            fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
            per = plan or energy.measure_per(n, d, s, resident_threads(dev.index) // 8)
            args = (*head, lat.sweep_words.ctypes.data, e.data_ptr(), m.data_ptr(), d, s, per,
                    stream)
    else:
        nb = -(-n // 256)
        e = torch.empty((d, s, nb), dtype=torch.float32, device=dev)
        m = torch.empty((d, s, nb), dtype=torch.int32, device=dev)
        fn = lib.peapods_energy_partials
        fn.restype = _I
        head = (x["spins"].data_ptr(), x["coup"].data_ptr(), e.data_ptr(), m.data_ptr())
        if first:
            fn.argtypes = [_P] * 4 + [_I] * 5 + [_P]
            args = (*head, d, s, *_build.dims3(x["shape"]), stream)
        else:
            fn.argtypes = [_P] * 6
            align, per = plan or (0, 0)
            words = overlap.energy_words(x["shape"], d, s, align or x["spins"].data_ptr() % 8,
                                         resident_threads(dev.index) // 4, per)
            e.words = words  # held with the partials
            args = (*head, words.ctypes.data, stream)
    return (lambda: _build.check(fn(*args), x["kernel"])), e, m


def plain_blocks(x):
    if x["kernel"] == "measure_nb":
        return energy.measure_nb_plain(x["spins"], x["coup"], x["lat"], blocks=True)
    return overlap.energy_partials_plain(x["spins"], x["coup"], x["shape"], blocks=True)


SHELLS3 = ([[1, 0, 0], [0, 1, 0], [0, 0, 1]]
           + [[1, s, 0] for s in (1, -1)] + [[1, 0, s] for s in (1, -1)]
           + [[0, 1, s] for s in (1, -1)]
           + [[1, a, b] for a in (1, -1) for b in (1, -1)])
# the table form's states: (name, shape, offsets, realizations, systems)
TABLE_SHAPES = (("glass4d", (10, 10, 10, 10), None, 16, 24),
                ("4d16", (16, 16, 16, 16), None, 1, 16),
                ("nine16", (16, 16, 16), SHELLS3[:9], 8, 48),
                ("nine16x24", (16, 16, 16), SHELLS3[:9], 8, 24),
                ("shells16", (16, 16, 16), SHELLS3, 1, 8))
BITS_SRC = ROOT / "tools" / "measure_bits.cu"  # the sign-bit form (--bits)


def table_design(csrc: Path) -> str:
    """measure_nb_table's design of a source: the first (a system a
    thread) or the redesign (``per`` systems a thread)."""
    return "redesign" if "group_terms" in (csrc / "sweep_nb.cu").read_text() else "first"


def table_launcher(lib, first, x, per=None):
    """``(fn, e_part, m_part, per)``: one launch of a build's
    measure_nb_table, the redesign at ``per`` systems a thread (default
    ``energy.table_measure_plan``'s)."""
    dev = x["spins"].device
    d, s, n, nb = x["d"], x["s"], x["n"], x["nb"]
    blocks = -(-(-(-n // 4)) // 256)
    e = torch.empty((d, s, blocks), dtype=torch.float32, device=dev)
    m = torch.empty((d, s, blocks), dtype=torch.int32, device=dev)
    fn = lib.peapods_measure_nb_table
    fn.restype = _I
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (x["spins"].data_ptr(), x["coup"].data_ptr(), x["fwd"].data_ptr(), e.data_ptr(),
            m.data_ptr(), n, nb, d, s)
    if first:
        fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        args = (*head, stream)
    else:
        fn.argtypes = [_P] * 5 + [_I] * 5 + [_P]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        per = per or energy.table_measure_plan(n, d, s, resident_threads(dev.index) // 8,
                                               sms).per
        args = (*head, per, stream)
    return (lambda: _build.check(fn(*args), "measure_nb_table")), e, m, per


def table_bound_ms(x):
    """``chip_smoke.py`` ``any_bounds``' measurement: every spin, the
    couplings and the forward table once, the partials written."""
    d, s, n, nb = x["d"], x["s"], x["n"], x["nb"]
    blocks = -(-n // 1024)
    return (d * s * n + 4 * d * n * nb + 4 * n * nb + 8 * d * s * blocks) / HBM_BYTES_S * 1e3


def build_bits(csrc: Path, out: Path):
    """``tools/measure_bits.cu`` built against the sources ``csrc``: ``(lib,
    ptxas log)``."""
    out.mkdir(parents=True, exist_ok=True)
    so = out / "measure_bits.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                           str(BITS_SRC)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {BITS_SRC}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so)), proc.stdout + proc.stderr


def bits_launcher(lib, x):
    """``(fn, e_part, m_part, (C, slice))``: one launch of the sign-bit form,
    a cluster of up to 8 CTAs a realization."""
    from peapods_tpu_torch.ops.lattice import fast_divisor

    dev = x["spins"].device
    d, s, n, nb = x["d"], x["s"], x["n"], x["nb"]
    blocks = -(-(-(-n // 4)) // 256)
    c = min(8, blocks)
    slice_ = (-(-n // c) + 3) // 4 * 4
    m, sh = fast_divisor(slice_)
    e = torch.empty((d, s, blocks), dtype=torch.float32, device=dev)
    mp = torch.empty((d, s, blocks), dtype=torch.int32, device=dev)
    fn = lib.peapods_measure_bits
    fn.restype = _I
    fn.argtypes = [_P] * 5 + [_I] * 8 + [_P]
    args = (x["spins"].data_ptr(), x["coup"].data_ptr(), x["fwd"].data_ptr(), e.data_ptr(),
            mp.data_ptr(), n, nb, d, s, c, slice_, m, sh,
            torch.cuda.current_stream(dev).cuda_stream)
    return (lambda: _build.check(fn(*args), "measure_bits")), e, mp, (c, slice_)


def probe_table(libs, todo, dev, card, rounds, pers, only, rng, results, bits=None):
    """measure_nb_table of every source's base build at TABLE_SHAPES:
    partials bitwise ``measure_nb_plain(blocks=True)`` (gaussian
    couplings); with ``pers`` the redesign at every count of systems a
    thread."""
    keys = [k for k in todo if k[1] == "measure_nb" and (k[2] == "base"
                                                        or k[2].startswith("t-"))]
    for name, shape, offsets, d, s in TABLE_SHAPES:
        if only and name not in only:
            continue
        x = inputs("measure_nb", shape, offsets, d, s, dev, rng)
        x["fwd"] = x["lat"].device_tables(dev)[0]
        want = energy.measure_nb_plain(x["spins"], x["coup"], x["lat"], blocks=True)
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                first = table_design(todo[key][0].parent) == "first"
                lib = libs[key][0]
                for per in ([None] if first or not pers or key[2] != "base"
                            else [None] + [p for p in range(1, 9) if s % p == 0]):
                    fn, e, m, used = table_launcher(lib, first, x, per)
                    fn()
                    torch.cuda.synchronize()
                    if not (torch.equal(e.view(torch.int32), want[0].view(torch.int32))
                            and torch.equal(m, want[1])):
                        raise AssertionError(f"{key[0]} measure_nb_table at {name} (per "
                                             f"{used}) differs from its block plain version")
                    ms = events_ms(fn, 200)
                    results.append(dict(kind="measure_nb_table", source=key[0], variant=key[2],
                                        state=name, round=rnd, per=used, forced=per is not None,
                                        ms=ms, bound_ms=table_bound_ms(x), bitwise_plain=True,
                                        design="first" if first else "redesign"))
                    print(f"[measure_nb_table] {key[0]} {key[2]} {name} ({d} x {s} x {x['n']}, "
                          f"{x['nb']} offsets, " + ("the first design" if first else
                                                    f"{used} systems a thread")
                          + f"): {ms:.5f} ms a launch (bound {table_bound_ms(x):.7f} ms, "
                          f"bytes), partials bitwise block plain round {rnd} on {card}",
                          flush=True)
            if bits is not None and s <= 32 and x["nb"] in (4, 9, 13):
                fn, e, m, form = bits_launcher(bits, x)
                fn()
                torch.cuda.synchronize()
                ok = bool(torch.equal(e.view(torch.int32), want[0].view(torch.int32))
                          and torch.equal(m, want[1]))
                if not ok:
                    raise AssertionError(f"the sign-bit form at {name} differs from the block "
                                         "plain version")
                ms = events_ms(fn, 200)
                results.append(dict(kind="measure_nb_table", source="bits", variant="bits",
                                    state=name, round=rnd, cluster=form[0], slice=form[1],
                                    ms=ms, bound_ms=table_bound_ms(x), bitwise_plain=True,
                                    design="sign bits"))
                print(f"[measure_nb_table] bits {name} ({d} x {s} x {x['n']}, {x['nb']} offsets, "
                      f"the sign-bit form, {form[0]} CTAs a cluster): {ms:.5f} ms a launch "
                      f"(bound {table_bound_ms(x):.7f} ms, bytes), partials bitwise block plain "
                      f"round {rnd} on {card}", flush=True)
        del x, want
        torch.cuda.empty_cache()


def bound_ms(x):
    """``chip_smoke.py``'s bound: every spin and the realization's couplings
    read once, the partials written, over the card's memory rate."""
    d, s, n = x["d"], x["s"], x["n"]
    blocks = -(-n // (1024 if x["kernel"] == "measure_nb" else 256))
    return (d * s * n + 4 * x["nb"] * n * d + 8 * d * s * blocks) / HBM_BYTES_S * 1e3


def probe(libs, todo, states, card, rounds, results):
    for name, x in states():
        want = plain_blocks(x)
        keys = [k for k in todo if k[1] == x["kernel"]]
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, kernel, variant = key
                first = todo[key][1] == "first"
                spec = VARIANTS.get(variant, (None, None, [], None, True))
                lib = libs[key if todo[key][0] is not None else (label, kernel, "base")][0]
                fn, e, m = launcher(lib, first, x, spec[3])
                fn()
                torch.cuda.synchronize()
                ok = None
                if spec[4]:
                    ok = bool(torch.equal(e.view(torch.int32), want[0].view(torch.int32))
                              and torch.equal(m, want[1]))
                    if not ok:
                        raise AssertionError(f"{label} {kernel} {variant} at {name} differs "
                                             "from its block plain version")
                ms = events_ms(fn, 200)
                rec = dict(kind=kernel, source=label, variant=variant, state=name, round=rnd,
                           ms=ms, bound_ms=bound_ms(x), bitwise_plain=ok)
                if not first and kernel == "energy_partials":
                    rec["words"] = [int(v) for v in e.words[:13]]
                results.append(rec)
                print(f"[{kernel}] {label} {variant} {name}: {ms:.5f} ms a launch (bound "
                      f"{rec['bound_ms']:.7f} ms, bytes)"
                      + (", partials bitwise block plain" if ok else "")
                      + f" round {rnd} on {card}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_measure"))
    ap.add_argument("--json", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all of each source's designs)")
    ap.add_argument("--shapes", default="", help="comma-separated state names (default: all)")
    ap.add_argument("--per", action="store_true",
                    help="also time the table redesign at every count of systems a thread")
    ap.add_argument("--bits", action="store_true",
                    help="also build and time tools/measure_bits.cu, the sign-bit form, "
                    "against the last --src's headers")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_measure: torch sees no CUDA device", file=sys.stderr)
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
        regs = registers(log)
        counts = sass_counts(sass)
        results.append(dict(kind="build", source=key[0], file=FILES[key[1]], variant=key[2],
                            registers=regs, sass=counts))
        tag = f"{key[0]} {key[1]} {key[2]}"
        print(f"[ptxas] {tag}: " + "; ".join(f"{k} {v}" for k, v in regs.items()), flush=True)
        divs = {k: c["int_div"] for k, c in counts.items() if k.startswith(key[1])}
        print(f"[sass] {tag}: integer divisions per kernel {divs}; instructions "
              + str({k: c["instructions"] for k, c in counts.items()
                     if k.startswith(key[1])}), flush=True)
    only = {s for s in a.shapes.split(",") if s}
    rng = np.random.default_rng(17)

    def states():
        for name, kernel, shape, geometry, d, n_sys in SHAPES:
            if not only or name in only:
                yield name, inputs(kernel, shape, geometry, d, n_sys, dev, rng)

    probe(libs, todo, states, card, a.rounds, results)
    bits = None
    if a.bits:
        bits, log = build_bits(sources[-1][1], out / "bits")
        regs = registers(log.replace("measure_bits_kernel", "measure_nb_table_kernel"))
        results.append(dict(kind="build", source="bits", file=BITS_SRC.name, variant="bits",
                            registers=regs))
        print("[ptxas] bits: " + "; ".join(f"{k} {v}" for k, v in regs.items()), flush=True)
    probe_table(libs, todo, dev, card, a.rounds, a.per, only, rng, results, bits)
    path = Path(a.json) if a.json else out / "probe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
