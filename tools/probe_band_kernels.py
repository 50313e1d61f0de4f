"""Time the space path's band kernels (``csrc/fk.cu`` ``fk_bonds_band``,
``fk_finish_band``; ``csrc/halo.cu`` ``sweep_halo``, ``measure_halo``;
``csrc/cc_band.cu`` ``cc_band_link``) and variants of the two redesigned
ones on one NVIDIA GPU, to find what sets their time.

    python3 tools/probe_band_kernels.py [--src LABEL=CSRC_DIR ...] [--out DIR]
                                        [--rounds N]

Each ``--src`` names a directory of the port's CUDA sources (default: this
checkout's ``peapods_tpu_torch/csrc``); give the parent commit's sources
(``git archive`` of it unpacked under a directory ``.gitignore`` lists) and
this checkout's to compare two designs on one card (``fk_finish_band`` is
called with its tile from the host, ``ops/fk.py`` ``band_finish_tile``, as
this checkout's entry point takes it).  For every source the
script builds ``fk.cu``, ``halo.cu`` and ``cc_band.cu`` as they are
("base") and ``fk.cu`` / ``halo.cu`` patched into the variants of the
source's design (the first design of ``fk_finish_band`` and ``sweep_halo``,
or their redesign with the template ``sweep_halo_kernel<NB>``), each with
nvcc for sm_90a (all builds at once, into ``--out``).  A variant of the
other design is skipped with a line that says so; a variant of the
source's own design whose anchors are not found stops the script.  It then
times each kernel's entry point with CUDA events over warm launches on
random inputs (the link's bonds near the percolation threshold) at band 0
of the space runs' shapes (4096^2 x 4 systems and 128^3 x 8 systems in 4
bands; the base builds also at 256^2 triangular and 32^3 FCC x 8 systems),
``--rounds`` times (default 2), the builds in order and then reversed.

Variants of the first design:

* ``noindex``: the window coordinates and the periodic wraps of the
  neighbour indices (runtime ``/`` and ``%``) replaced by straight index
  arithmetic (wrong at the row ends, the same memory traffic);
* ``onecoin`` (fk_finish_band): each neighbour's SW coin replaced by a bit
  of its label (the label still loaded);
* ``nopart``: the block's shared-memory tree of partials replaced by a
  store that the compiler cannot drop;
* ``nocoup`` (sweep_halo): the couplings read as 1 (no coupling traffic);
* ``noindex+onecoin``, ``noindex+nopart``.

Variants of the redesigned sweep_halo: the Philox draw replaced by a mix
of its counter (``r-nophilox``), ``expf`` by a polynomial (``r-noexp``),
the couplings by constants (``r-nocoup``), the spin stores skipped
(``r-nostore``), the offset form's neighbours read from the site's own row
with no coordinates (``r-nonb``), the offset form's work at the pass's
sites skipped, their spins still read (``r-skip``), one system a CTA
(``r-per1``) and every system in one CTA (``r-perall``) in place of as many
as leave about 1056 CTAs a launch.

The variants but ``r-per1`` and ``r-perall`` compute wrong results on
purpose: they only show what each part of the kernel costs.  Prints one
line per (source, variant, kernel, shape, round) with the time a launch and
the card, and each kernel's ``ptxas -v`` registers, stack frame and
spills; writes the same as JSON to ``--out/probe.json``.  Needs a CUDA
device and nvcc; imports nothing of JAX.
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

from peapods_tpu_torch.ops import _build, cc_band, fk  # noqa: E402
from peapods_tpu_torch.ops.lattice import GEOMETRY_OFFSETS, BandGeometry, Lattice  # noqa: E402

# (kernel source, anchor, replacement) of each variant on the first design
FK_NOINDEX = [
    ("fk.cu", "      coords(geo.w, w, c);\n      float e = 0.0f;", "      float e = 0.0f;"),
    ("fk.cu", "        const int j = window_neighbour(geo, c, dir, 1);\n        const bool ff",
     "        const int j = w + geo.w.off[dir][0] * geo.w.stride[0] +\n"
     "                      geo.w.off[dir][1] * geo.w.stride[1] + geo.w.off[dir][2];\n"
     "        const bool ff"),
]
FK_ONECOIN = [
    ("fk.cu", "const bool ff = flips(labels[base + j], wolff, seed_label, s0, s1);",
     "const bool ff = (labels[base + j] & 1) != 0;"),
]
FK_NOPART = [
    ("fk.cu", "  if (!measure) return;  // uniform across the launch\n"
     "  block_partials(e_acc, m_acc, e_part, m_part,\n"
     "                 static_cast<size_t>(b) * gridDim.x + blockIdx.x);\n}\n\n"
     "inline dim3 site_grid",
     "  if (!measure) return;  // uniform across the launch\n"
     "  if (e_acc == 1234.5f && m_acc == 77) {\n"
     "    e_part[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = e_acc;\n"
     "    m_part[static_cast<size_t>(b) * gridDim.x + blockIdx.x] = m_acc;\n  }\n}\n\n"
     "inline dim3 site_grid"),
]
HALO_NOINDEX = [
    ("halo.cu", "      const int r = i / wh;", "      const int r = i >> 11;  // W = 4096"),
    ("halo.cu", "        int c[3];\n        coords(g.w, w, c);\n        float field = 0.0f;",
     "        float field = 0.0f;"),
    ("halo.cu", "field + static_cast<float>(s[window_neighbour(g, c, d, 1)])",
     "field + static_cast<float>(s[w + g.w.off[d][0] * g.w.stride[0] +\n"
     "                                              g.w.off[d][1] * g.w.stride[1] + "
     "g.w.off[d][2]])"),
    ("halo.cu", "s[window_neighbour(g, c, d, -1)]",
     "s[w - g.w.off[d][0] * g.w.stride[0] - g.w.off[d][1] * g.w.stride[1] - g.w.off[d][2]]"),
]
HALO_NOCOUP = [
    ("halo.cu", "const float* jf = coup_fwd + static_cast<size_t>(dz) * nw * nb;\n"
     "  const float* jb = coup_bwd + static_cast<size_t>(dz) * nw * nb;\n"
     "  const float T = sys_temps[row];",
     "  struct One { __device__ float operator[](size_t) const { return 1.0f; } };\n"
     "  const One jf{}, jb{};\n  const float T = sys_temps[row];"),
]
HALO_NOPART = [
    ("halo.cu", "  if (!measure) return;  // uniform across the launch\n"
     "  block_partials(e_acc, m_acc, e_part, m_part, row * gridDim.x + blockIdx.x);\n}\n\n"
     "__global__ void __launch_bounds__(kThreads)\nmeasure_halo_kernel",
     "  if (!measure) return;  // uniform across the launch\n"
     "  if (e_acc == 1234.5f && m_acc == 77) {\n"
     "    e_part[row * gridDim.x + blockIdx.x] = e_acc;\n"
     "    m_part[row * gridDim.x + blockIdx.x] = m_acc;\n  }\n}\n\n"
     "__global__ void __launch_bounds__(kThreads)\nmeasure_halo_kernel"),
]
# the same questions of the redesign (csrc/halo.cu sweep_halo_kernel<NB>)
R_NOPHILOX = [
    ("halo.cu", "          r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),\n"
     "                             static_cast<uint32_t>(colour), static_cast<uint32_t>(grp), 0u);",
     "          r4 = make_uint4(k0 ^ grp, k1 + grp, sys, colour);"),
    ("halo.cu", "            r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),\n"
     "                               static_cast<uint32_t>(colour), static_cast<uint32_t>(grp),\n"
     "                               0u);",
     "            r4 = make_uint4(k0 ^ grp, k1 + grp, sys, colour);"),
]
R_NOEXP = [
    ("halo.cu", "const float p = gibbs ? 1.0f / (1.0f + expf(-x)) : kKeep * expf(fminf(x, 0.0f));",
     "const float p = gibbs ? 1.0f / (1.0f + x * x) : kKeep * fminf(x + 1.0f, 1.0f);"),
    ("halo.cu", ": u < kKeep * expf(fminf(eng * inv_half_t, 0.0f));",
     ": u < kKeep * fminf(eng * inv_half_t + 1.0f, 1.0f);"),
]
R_NOCOUP = [
    ("halo.cu", "      const float2 b = bwd[idx];\n      const float2 f = fwd[idx];",
     "      const float2 b = make_float2(1.0f, -1.0f);\n"
     "      const float2 f = make_float2(-1.0f, 1.0f);"),
    ("halo.cu", "*\n                                jf[b];", "*\n                                1.0f;"),
    ("halo.cu", "*\n                                jb[b];", "*\n                                -1.0f;"),
]
R_NOSTORE = [
    ("halo.cu", "          sv = -sv;\n          s[idx] = static_cast<int8_t>(sv);",
     "          sv = -sv;\n          if (T < 0.0f) s[idx] = static_cast<int8_t>(sv);"),
    ("halo.cu", "            sv = -sv;\n            s[w] = static_cast<int8_t>(sv);",
     "            sv = -sv;\n            if (T < 0.0f) s[w] = static_cast<int8_t>(sv);"),
]
# sweep_halo's systems a CTA: one (r-per1), every one (r-perall)
R_PER1 = [("halo.cu", "  const int groups = min(n_systems, max(1, want));",
           "  const int groups = n_systems + 0 * want;")]
R_PERALL = [("halo.cu", "  const int groups = min(n_systems, max(1, want));",
             "  const int groups = 1 + 0 * want;")]
# the offset form's neighbours read from the site's own row (no gather)
R_NONB = [
    ("halo.cu", "field = field + static_cast<float>("
     "s[band_neighbour(g, w, c1, c2, d, false)])",
     "field = field + static_cast<float>(s[w + 1 + d])"),
    ("halo.cu", "field = field + static_cast<float>("
     "s[band_neighbour(g, w, c1, c2, d, true)])",
     "field = field + static_cast<float>(s[w - 1 - d])"),
]
# the offset form's work at a site of the pass's colour skipped (its spin
# still loaded for m): what the loop, the colour bytes and the partials cost
R_SKIP = [
    ("halo.cu", "        if ((act >> k) & 1u) {", "        if (((act >> k) & 1u) && T < 0.0f) {"),
]
# name: (design whose sources it patches, kernels it changes, edits); the
# first design's variants apply to a halo.cu without sweep_halo_kernel<NB>
VARIANTS = {
    "noindex": ("first", ("fk", "halo"), FK_NOINDEX + HALO_NOINDEX),
    "onecoin": ("first", ("fk",), FK_ONECOIN),
    "nopart": ("first", ("fk", "halo"), FK_NOPART + HALO_NOPART),
    "nocoup": ("first", ("halo",), HALO_NOCOUP),
    "noindex+onecoin": ("first", ("fk",), FK_NOINDEX + FK_ONECOIN),
    "noindex+nopart": ("first", ("fk", "halo"),
                       FK_NOINDEX + FK_NOPART + HALO_NOINDEX + HALO_NOPART),
    "r-nophilox": ("redesign", ("halo",), R_NOPHILOX),
    "r-noexp": ("redesign", ("halo",), R_NOEXP),
    "r-nocoup": ("redesign", ("halo",), R_NOCOUP),
    "r-nostore": ("redesign", ("halo",), R_NOSTORE),
    "r-nonb": ("redesign", ("halo",), R_NONB),
    "r-per1": ("redesign", ("halo",), R_PER1),
    "r-perall": ("redesign", ("halo",), R_PERALL),
    "r-skip": ("redesign", ("halo",), R_SKIP),
}

# band 0 of each shape in 4 bands: (name, shape, geometry, systems)
SHAPES = [("4096sq", (4096, 4096), None, 4), ("128cubic", (128, 128, 128), None, 8),
          ("256tri", (256, 256), "triangular", 8), ("32fcc", (32, 32, 32), "fcc", 8)]
# each source's unpatched build also times these (csrc/cc_band.cu)
BASE_ONLY = ("cc_band.cu",)


def missing(src: str, edits) -> list[str]:
    """The first line of each anchor of ``edits`` that ``src`` does not hold
    exactly once."""
    return [old.strip().splitlines()[0] for _, old, _ in edits if src.count(old) != 1]


def patch(src: str, edits) -> str:
    for _, old, new in edits:
        src = src.replace(old, new)
    return src


def design(csrc: Path) -> str:
    """``redesign`` where the source's halo.cu holds the template sweep_halo_kernel<NB>,
    else ``first``."""
    return "redesign" if "template <int NB>" in (csrc / "halo.cu").read_text() else "first"


def builds(sources, out):
    """``{(label, variant): (dir, [source files])}`` of every build to make.
    A variant of the other design is skipped with a line that says so; a
    variant of the source's own design whose anchors are missing stops the
    probe (its edits no longer match the kernel they measure)."""
    todo = {}
    for label, csrc in sources:
        own = design(csrc)
        for variant, (aim, _, edits) in [("base", (own, (), []))] + list(VARIANTS.items()):
            if aim != own:
                print(f"[probe] skip {label} {variant}: a variant of the {aim} design, "
                      f"and {csrc} holds the {own} one", flush=True)
                continue
            files = {}
            for name in ("fk.cu", "halo.cu") + (BASE_ONLY if variant == "base" else ()):
                text = (csrc / name).read_text()
                mine = [e for e in edits if e[0] == name]
                gone = missing(text, mine)
                if gone:
                    raise SystemExit(f"probe_band_kernels: variant {variant} does not apply "
                                     f"to {csrc / name}; anchors not found: {gone}")
                if mine or variant == "base":
                    files[name] = patch(text, mine)
            d = out / label / variant
            d.mkdir(parents=True, exist_ok=True)
            for h in csrc.glob("*.cuh"):
                shutil.copy(h, d / h.name)
            for name, text in files.items():
                (d / name).write_text(text)
            todo[(label, variant)] = (d, sorted(files))
    return todo


def compile_all(todo):
    """One nvcc per source, all at once: ``{(label, variant): {stem: (lib,
    log)}}``."""
    procs = []
    for key, (d, names) in todo.items():
        for name in names:
            so = d / (Path(name).stem + ".so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / name)]
            procs.append((key, d, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, d, name, so, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key} {name}:\n{text}")
        lib = ctypes.CDLL(str(so))
        for fn, args in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
        # fk_bonds_band takes the graphs a thread (fk.bonds_per) since its
        # redesign; the earlier design's entry point does not
        lib.bonds_per = "int n_systems, int per, void* stream" in (d / name).read_text()
        if name == "fk.cu" and not lib.bonds_per:
            lib.peapods_fk_bonds_band.argtypes = args = [ctypes.c_void_p] * 6 + [
                ctypes.c_int] * 2 + [ctypes.c_void_p]
        libs.setdefault(key, {})[Path(name).stem] = (lib, text)
    return libs


KERNELS = ("fk_bonds_band", "fk_finish_band", "sweep_halo", "measure_halo", "cc_band_link")


def ptxas(text):
    """``kernel: registers, stack, spills`` of each band kernel in a log."""
    out, fn, frame = [], None, "frame not reported"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = next((k for k in KERNELS if k + "_kernel" in m.group(1)), None)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m:
            frame = (f"{m.group(1)} B stack frame, {m.group(2)}/{m.group(3)} B spill "
                     "stores/loads")
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out.append(f"{fn} {m.group(1)} registers, {frame}")
            fn = None
    return out


def inputs(shape, geometry, n_sys, dev, rng):
    offsets = GEOMETRY_OFFSETS[geometry] if geometry else None
    lat = Lattice(shape, offsets)
    band = BandGeometry(lat, 4).bands[0]
    nw, nb = band.n_window, lat.n_neighbors
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    sites = band.window_sites()
    # bonds of the link near the lattice's percolation threshold: 1/2 on the
    # square and triangular lattices, 1/4 in 3D
    p = 0.5 if len(shape) == 2 else 0.25
    bonds = (rng.random((n_sys, nw, min(nb, 3))) < p).astype(np.uint8)
    bonds = (bonds << np.arange(bonds.shape[-1], dtype=np.uint8)).sum(-1, dtype=np.uint8)
    return dict(
        lat=lat, band=band,
        spins=up(rng.choice([-1, 1], size=(1, n_sys, nw)).astype(np.int8)),
        coup=up(rng.choice([-1.0, 1.0], size=(1, nw, nb)).astype(np.float32)),
        coup_b=up(rng.choice([-1.0, 1.0], size=(1, nw, nb)).astype(np.float32)),
        colours=up(lat.colors[sites].astype(np.uint8)),
        temps=up(np.full((1, n_sys), 2.27 * nb / 2, np.float32)),
        words=up(rng.integers(-2**31, 2**31, (1, 2)).astype(np.int32)),
        labels=up(rng.integers(0, lat.n_spins, (n_sys, nw)).astype(np.int32)),
        state=up(rng.integers(0, 64, (n_sys, nw)).astype(np.uint8)),
        scal=up(rng.integers(-2**31, 2**31, (n_sys, 3)).astype(np.int32)),
        kb=up(rng.integers(-2**31, 2**31, (n_sys, 2)).astype(np.int32)),
        bonds=up(bonds),
        out_state=torch.empty((n_sys, nw), dtype=torch.uint8, device=dev),
        cc=cc_band.BandCC.empty(n_sys, band, dev),
    )


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def launches(kl, variant, x, dev):
    """``[(kernel, extra row fields, launch)]`` of a build at one shape."""
    band, lat = x["band"], x["lat"]
    words = band.words.ctypes.data
    n_sys = x["spins"].shape[1]
    square = int(lat.square)
    fused = lat.hypercubic or lat.triangular
    stream = torch.cuda.current_stream(dev).cuda_stream
    touches = VARIANTS[variant][1] if variant != "base" else ("fk", "halo")
    out = []
    if "halo" in kl and "halo" in touches:
        lib = kl["halo"][0]
        nblk = lib.peapods_halo_blocks(words, square)
        e = torch.empty((1, n_sys, nblk), dtype=torch.float32, device=dev)
        m = torch.empty((1, n_sys, nblk), dtype=torch.int32, device=dev)
        for colour, meas in ((0, False), (lat.n_colors - 1, lat.n_colors == 2)):
            parts = (e.data_ptr(), m.data_ptr()) if meas else (None, None)

            def go(colour=colour, parts=parts, lib=lib):
                _build.check(lib.peapods_sweep_halo(
                    x["spins"].data_ptr(), x["coup"].data_ptr(), x["coup_b"].data_ptr(),
                    x["colours"].data_ptr(), x["temps"].data_ptr(), x["words"].data_ptr(),
                    *parts, words, 1, n_sys, colour, 0, square, stream), "sweep_halo")
            out.append(("sweep_halo", dict(colour=colour, measure=meas), go))
        if variant == "base":
            mb = lib.peapods_halo_blocks(words, 0)
            me = torch.empty((1, n_sys, mb), dtype=torch.float32, device=dev)
            mm = torch.empty((1, n_sys, mb), dtype=torch.int32, device=dev)

            def go(lib=lib):
                _build.check(lib.peapods_measure_halo(
                    x["spins"].data_ptr(), x["coup"].data_ptr(), words, me.data_ptr(),
                    mm.data_ptr(), 1, n_sys, stream), "measure_halo")
            out.append(("measure_halo", dict(measure=True), go))
    if "fk" in kl and "fk" in touches:
        lib = kl["fk"][0]
        if variant == "base":
            def go(lib=lib):
                threads = fk.resident_threads(dev.index)
                per = ((fk.bonds_per(band.n_window, n_sys, n_sys, threads),)
                       if lib.bonds_per else ())
                _build.check(lib.peapods_fk_bonds_band(
                    x["spins"].data_ptr(), x["coup"].data_ptr(), x["temps"].data_ptr(),
                    x["kb"].data_ptr(), x["out_state"].data_ptr(), words, n_sys, n_sys,
                    *per, stream), "fk_bonds_band")
            out.append(("fk_bonds_band", {}, go))
        if fused:
            nblk = lib.peapods_fk_blocks(band.n_band)
            e = torch.empty((n_sys, nblk), dtype=torch.float32, device=dev)
            m = torch.empty((n_sys, nblk), dtype=torch.int32, device=dev)
            for meas in (True, False):
                parts = (e.data_ptr(), m.data_ptr()) if meas else (None, None)

                def go(parts=parts, lib=lib):
                    _build.check(lib.peapods_fk_finish_band(
                        x["spins"].data_ptr(), x["state"].data_ptr(), x["labels"].data_ptr(),
                        x["coup"].data_ptr(), x["scal"].data_ptr(), None, *parts, words,
                        n_sys, n_sys, 0, *fk.band_finish_tile(band, n_sys), stream),
                        "fk_finish_band")
                out.append(("fk_finish_band", dict(measure=meas), go))
    if "cc_band" in kl:
        lib, cc = kl["cc_band"][0], x["cc"]

        def go(lib=lib, cc=cc):
            _build.check(lib.peapods_cc_band_link(
                x["bonds"].data_ptr(), cc.parent.data_ptr(), cc.cmin.data_ptr(), words,
                n_sys, stream), "cc_band_link")
        out.append(("cc_band_link", {}, go))
    return out


def run(libs, dev, card, rounds):
    """Every build's launches at each shape, timed ``rounds`` times, the
    builds in order and then in reverse (a, b, b, a), so that a drift of
    the card's clock falls on both sides."""
    rng = np.random.default_rng(5)
    rows = []
    keys = list(libs)
    for name, shape, geometry, n_sys in SHAPES:
        x = inputs(shape, geometry, n_sys, dev, rng)
        for r in range(rounds):
            for label, variant in (keys if r % 2 == 0 else keys[::-1]):
                if variant != "base" and name not in ("4096sq", "128cubic"):
                    continue
                for kernel, extra, go in launches(libs[(label, variant)], variant, x, dev):
                    rows.append(dict(src=label, variant=variant, kernel=kernel, shape=name,
                                     round=r, **extra, ms=time_ms(go)))
        del x
        torch.cuda.empty_cache()
    for r in rows:
        print(f"[probe] {r['src']} {r['variant']:>16} {r['kernel']:>14} {r['shape']:>8} "
              + (f"colour {r['colour']} " if "colour" in r else "")
              + (f"measure={int(r['measure'])} " if "measure" in r else "")
              + f"round {r['round']}: {r['ms']:.5f} ms a launch on {card}", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="LABEL=DIR of CUDA sources (default: this checkout's)")
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_band_kernels"))
    ap.add_argument("--rounds", type=int, default=2,
                    help="times each launch is timed, the builds' order reversed each round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_band_kernels: torch sees no CUDA device", file=sys.stderr)
        return 1
    sources = [(s.split("=", 1)[0], Path(s.split("=", 1)[1]).resolve())
               for s in args.src] or [("head", _build.SOURCE_DIR)]
    out = Path(args.out)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = compile_all(builds(sources, out))
    regs = {}
    for (label, variant), kl in libs.items():
        for stem, (_, text) in kl.items():
            (out / label / variant / f"{stem}.ptxas.log").write_text(text)
            regs[f"{label} {variant} {stem}.cu"] = ptxas(text)
            print(f"[ptxas] {label} {variant} {stem}.cu: "
                  + "; ".join(regs[f"{label} {variant} {stem}.cu"]), flush=True)
    rows = run(libs, torch.device("cuda", 0), card, args.rounds)
    (out / "probe.json").write_text(json.dumps(dict(card=card, ptxas=regs, rows=rows),
                                               indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
