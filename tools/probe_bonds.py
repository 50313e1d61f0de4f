"""Time the FK bond draws (``csrc/fk.cu`` ``fk_bonds``, ``fk_bonds_band``) of
two source trees side by side on one NVIDIA GPU, with variants that take
one part of a design away or cure one defect of the first design, and count
each kernel's SASS instructions.

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

Variants of the redesign, one part taken away each:

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
bands.  Every base build and every variant that keeps the function is held
bitwise to ``fk_state_plain`` / ``fk_bonds_band_plain``.  ``--per`` also
times the redesign with each count of graphs a thread (a realization's,
one, and ``ops/fk.py`` ``bonds_per``'s).  Times are device times of one
launch (CUDA events over warm launches queued behind a sleep kernel),
``--rounds`` times with the builds in order and then reversed.  Prints one
line per measurement with the card, writes all of them as JSON to
``--out/probe.json``.  Needs a CUDA device, nvcc and cuobjdump; imports
nothing of JAX.
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

from chip_smoke import card_line  # noqa: E402
from peapods_tpu_torch.ops import _build, fk  # noqa: E402
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
    ("          const uint4 u = philox4x32_10(k0, k1, static_cast<uint32_t>(d), ctr, 0u, 0u);",
     "          const uint4 u = make_uint4(k0 ^ ctr, k1 + ctr, ctr * 0x9E3779B9u ^ d, k0 + k1);"),
]
# name: (design, edits, whether the variant keeps the function)
VARIANTS = {
    "o-noparent": ("first", O_NOPARENT, True),
    "o-once": ("first", O_ONCE, True),
    "o-noindex": ("first", O_NOINDEX, False),
    "o-vector": ("first", O_VECTOR, True),
    "n-eager": ("redesign", N_EAGER, True),
    "n-scalar": ("redesign", N_SCALAR, True),
    "n-nophilox": ("redesign", N_NOPHILOX, False),
    "n-lb1": ("redesign", N_LB1, True),
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
# band 0 of each in 4 bands: (name, shape, geometry, systems, temperature)
BANDS = (
    ("band4096", (4096, 4096), None, 4, T_SQ),
    ("band128", (128, 128, 128), None, 8, 4.51),
    ("bandfcc32", (32, 32, 32), "fcc", 8, 9.79),
)


def design(csrc: Path) -> str:
    return "redesign" if "bonds_body" in (csrc / "fk.cu").read_text() else "first"


def builds(sources, out, variants):
    """``{(label, variant): (fk.cu path, design)}``: each source's base and
    the variants of its design; a variant of its own design whose anchors
    are not found stops the probe."""
    todo = {}
    for label, csrc in sources:
        own = design(csrc)
        text = (csrc / "fk.cu").read_text()
        for variant in ("base", *variants):
            if variant != "base":
                aim, edits, _ = VARIANTS[variant]
                if aim != own:
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
            todo[(label, variant)] = (d / "fk.cu", own)
    return todo


def compile_all(todo):
    """One nvcc for each build, all at once: ``{key: (lib, ptxas log, sass)}``."""
    procs = []
    for key, (src, _) in todo.items():
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
            if "fk_bonds_kernel" in fn or "fk_bonds_band_kernel" in fn:
                args = re.findall(r"Li(\d+)E", fn.split("_kernel", 1)[1])
                name = ("fk_bonds_band" if "band" in fn else "fk_bonds") + (
                    f"<{', '.join(args)}>" if args else "")
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


def launcher(lib, first, x, band, per):
    """``(fn, state)``: one launch of a build's fk_bonds (or fk_bonds_band)."""
    dev = x["spins"].device
    b, n = x["b"], x["n"]
    state = torch.empty((b, n), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (x["spins"].data_ptr(), x["j"].data_ptr(), x["temps"].data_ptr(),
            x["kb"].data_ptr(), state.data_ptr())
    if band:
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


def plain_state(x, band):
    if band:
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
    for name, x, band in states():
        want = plain_state(x, band)
        reps = 50 if x["b"] * x["n"] < 2**24 else 10
        rule = fk.bonds_per(x["n"], x["b"], x["s"], fk.resident_threads(dev.index))
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, variant = key
                first = todo[key][1] == "first"
                keeps = variant == "base" or VARIANTS[variant][2]
                for per in ([rule] if first or not pers or variant != "base"
                            else sorted({rule, x["s"], 1})):
                    fn, state = launcher(libs[key][0], first, x, band, per)
                    fn()
                    torch.cuda.synchronize()
                    ok = bool(torch.equal(state, want)) if keeps else None
                    if keeps and not ok:
                        raise AssertionError(f"{label} {variant} at {name} (per {per}) "
                                             f"differs from its plain version: "
                                             f"{int((state != want).sum())} bytes")
                    ms = events_ms(fn, reps)
                    rec = dict(kind="fk_bonds_band" if band else "fk_bonds", source=label,
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
        regs = {k: v for k, v in registers(log).items() if k.startswith("fk_bonds")
                and not k.startswith("fk_bonds_nb")}
        counts = sass_counts(sass)
        results.append(dict(kind="build", source=key[0], variant=key[1], registers=regs,
                            sass=counts))
        print(f"[ptxas] {key[0]} {key[1]}: " + "; ".join(f"{k} {v}" for k, v in regs.items()),
              flush=True)
        for k, c in counts.items():
            nb = int(k.split("<")[1].split(",")[0].rstrip(">")) if k.endswith(">") else None
            per_bond = "" if nb is None else f", {c['instructions'] / (4 * nb):.1f} a bond"
            print(f"[sass] {key[0]} {key[1]} {k}: {c['instructions']} instructions{per_bond}; "
                  f"integer divisions {c['int_div']}, MUFU.EX2 {c['ex2']}, IMAD.WIDE.U32 "
                  f"{c['imad_wide']}, calls {c['calls']}; loads {c['ldg']}, stores {c['stg']}",
                  flush=True)
    only = {s for s in a.shapes.split(",") if s}
    rng = np.random.default_rng(13)

    def states():
        for name, shape, geometry, d, s, temp, coup in UNSHARDED:
            if not only or name in only:
                yield name, unsharded_inputs(shape, geometry, d, s, temp, coup, dev, rng), False
        for name, shape, geometry, s, temp in BANDS:
            if not only or name in only:
                yield name, band_inputs(shape, geometry, s, temp, dev, rng), True

    probe(libs, todo, states, dev, card, a.rounds, a.per, results)
    (out / "probe.json").write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {out / 'probe.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
