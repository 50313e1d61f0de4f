"""Time the replica path's pair measurement (``csrc/pairs.cu``
``pair_overlap``) of two source trees side by side on one NVIDIA GPU, with
variants that cure one defect of the first design or take one part of the
redesign away, and count each kernel's SASS integer-division sequences.

    python3 tools/probe_pairs.py --src old=CSRC_DIR --src new=CSRC_DIR
                                 [--out DIR] [--rounds N] [--variants a,b,...]
                                 [--shapes a,b,...] [--json PATH]

Each ``--src`` names a directory of the port's CUDA sources; the first
design (a CTA of 256 threads a column, ``fwd_site``'s runtime divisions,
byte loads, a shared-memory tree) is told from the redesign (disagreement
bits in 8- or 4-byte words, popcounts, division-free neighbour words, warp
sums) by its source.  Give the parent commit's sources (``git archive`` of
it unpacked under a directory ``.gitignore`` lists) and this checkout's.
The script builds ``pairs.cu`` of every source as it is and patched into
each variant of its design, all with nvcc for sm_90a at once (into
``--out``), and prints each kernel's ``ptxas -v`` registers and, from
``cuobjdump -sass``, its static instructions and integer-division
sequences (``I2F.U32.RP``).

Variants of the first design, one defect cured each:

* ``o-nodiv``: each forward neighbour at ``i + stride`` clamped to the
  lattice: no division (wrong at the edges);
* ``o-warp``: the CTA's sums by warp shuffles and one warp over the warps'
  partials in place of the nine-barrier shared tree;
* ``o-full``: ``o-warp`` on a CTA of one warp a column (the launch filled
  with columns at 8^3).

Variants of the redesign, one part taken away each:

* ``n-div``: the line, plane and pair indices by runtime divisions in place
  of the multiply-shift;
* ``n-bytes``: the per-site path (1-byte words) at every shape;
* ``n-words4``: the fewest threads a column that take four words each (a
  warp at 8^3 and 32^2, four at 16^3) in place of one word each;
* ``n-tpc32``: one warp a column at every shape.

The states are random +-1 spins and random ``sid`` permutations at the
replica configs' shapes: config 4 (8^3, R = 4, 24 temperatures, 8
realizations), config 5 (16^3, the same) and config 1 (32^2, R = 2, 16
temperatures, one realization; ``benchmarks/driver_configs.py:39-47``).
The table form ``pair_overlap_table`` (the first design, up to four
columns a CTA of 512 threads, told from the redesign, clusters staging
each site's disagreement words, by its source) runs at the table runs'
shapes of ``chip_smoke.py`` phase 38: the 4D glass (10^4, R = 2, 12
temperatures, 16 realizations), Wolff ``houd4`` (R = 4) and nine16 (16^3
with 9 offsets, R = 2, 24 temperatures, 8 realizations); ``--table-forms``
also times the redesign on clusters of 1 to 8 CTAs, each with the
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``, from
a query the probe adds to its own builds).  Variants of the
table redesign (built only for a source that holds it): ``t-nostage``
(no word staged: the counts and the cluster's waits alone; wrong values),
``t-nocount`` (no site counted: the staging and the waits; wrong values),
``t-t256`` (CTAs of 256 threads), ``t-empty`` (neither: the launch's
skeleton), ``t-local`` (each neighbour's word from the CTA's own shared
memory, not its owner's: wrong values), ``t-noattr`` (no opt-in to more
than 48 KB of shared memory where the launch needs less), ``t-clock``
(each leader's phases timed by ``%globaltimer`` in its first columns'
qs: wrong values), ``t-noload`` and ``t-nostore`` (``t-clock`` with the
staging's spin loads, or its shared-memory stores, taken away).
Every build and every variant that keeps the function is held bitwise to
``megapair.pair_overlap_plain``.  A redesign's source from before the
offset tables (no ``PairOffset``) gets the words of the axes alone, so the
parent's and this tree's builds run on the same states.  Times are device times of one launch
(CUDA events over warm launches queued behind a sleep kernel),
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
from peapods_tpu_torch.ops import _build, megapair  # noqa: E402
from peapods_tpu_torch.ops.lattice import Lattice  # noqa: E402
from probe_pt_link import events_ms  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int

# (anchor, replacement) edits of the first design's pairs.cu
O_NODIV = [("      const int f = fwd_site(i, g, dir);",
            "      const int f = min(i + g.stride[dir], n - 1);")]
O_WARP = [(
    "  __shared__ int sq[kThreads];\n  __shared__ int sl[kThreads];\n"
    "  sq[threadIdx.x] = qs;\n  sl[threadIdx.x] = ql;\n  __syncthreads();\n"
    "  for (int off = kThreads / 2; off > 0; off >>= 1) {\n"
    "    if (threadIdx.x < off) {\n      sq[threadIdx.x] += sq[threadIdx.x + off];\n"
    "      sl[threadIdx.x] += sl[threadIdx.x + off];\n    }\n    __syncthreads();\n  }\n"
    "  if (threadIdx.x == 0) {\n"
    "    qs_out[static_cast<size_t>(d) * out_stride + col] = sq[0];\n"
    "    ql_out[static_cast<size_t>(d) * out_stride + col] = sl[0];\n  }",
    "  qs = __reduce_add_sync(0xffffffffu, qs);\n  ql = __reduce_add_sync(0xffffffffu, ql);\n"
    "  __shared__ int sq[kThreads / 32];\n  __shared__ int sl[kThreads / 32];\n"
    "  if ((threadIdx.x & 31) == 0) {\n    sq[threadIdx.x >> 5] = qs;\n"
    "    sl[threadIdx.x >> 5] = ql;\n  }\n  __syncthreads();\n"
    "  if (threadIdx.x < 32) {\n    const bool on = threadIdx.x < (blockDim.x >> 5);\n"
    "    qs = __reduce_add_sync(0xffffffffu, on ? sq[threadIdx.x] : 0);\n"
    "    ql = __reduce_add_sync(0xffffffffu, on ? sl[threadIdx.x] : 0);\n  }\n"
    "  if (threadIdx.x == 0) {\n"
    "    qs_out[static_cast<size_t>(d) * out_stride + col] = qs;\n"
    "    ql_out[static_cast<size_t>(d) * out_stride + col] = ql;\n  }")]
O_FULL = O_WARP + [(
    "  pair_overlap_kernel<<<dim3(n_pairs * n_temps, n_disorder), kThreads, 0,",
    "  pair_overlap_kernel<<<dim3(n_pairs * n_temps, n_disorder), 32, 0,")]
# ... and of the redesign's
N_DIV = [("  const int line = fast_div(k, g.m[0], g.s[0]);", "  const int line = k / g.wpl;"),
         ("    ca = fast_div(line, g.m[1], g.s[1]);", "    ca = line / g.Lb;"),
         ("    const int p = fast_div(col, g.m[2], g.s[2]);", "    const int p = col / g.T;")]


def _tpc(tpc=None, words_a_thread=None):
    """Words with ``tpc`` threads a column (or the fewest, from 32, that take
    at most ``words_a_thread`` words each) and CTAs of max(128, tpc)."""
    def edit(w):
        w = w.copy()
        t = tpc
        if t is None:
            t = 32
            while t * words_a_thread < int(w[2]) and t < 1024:
                t *= 2
        w[10], w[11], w[12] = t, t.bit_length() - 1, max(128, t)
        return w
    return edit


# ... and of the table redesign (pair_overlap_table; built only for a source
# whose table form is the redesign)
T_NOSTAGE = [("    for (int i0 = lo + 4 * tid; i0 < hi; i0 += 4 * nthr) {",
              "    for (int i0 = hi; i0 < hi; i0 += 4 * nthr) {")]
T_NOCOUNT = [("  for (int base = c_lo; base < c_hi; base += nthr * per_round) {  // uniform",
              "  for (int base = c_hi; base < c_hi; base += nthr * per_round) {  // uniform")]
T_LOCAL = [("      const uint32_t* p = cluster.map_shared_rank(sh.words, owner) + (f[j] - owner * g.slice) * kW;",
            "      const uint32_t* p = sh.words + (f[j] - owner * g.slice) * kW;")]
_STAMP = "{ unsigned long long x_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(x_)); tt_[{k}] = x_; }\n"
T_CLOCK = [
    ("  const PairSmem<kW> sh(smem_raw, kStaged ? g.slice : 0);\n",
     "  const PairSmem<kW> sh(smem_raw, kStaged ? g.slice : 0);\n  unsigned long long tt_[6];\n"
     + _STAMP.replace("{k}", "5")),
    ("  for (int c = tid; c < kPairTableWarps * 64 * kW; c += nthr) sh.wsum[c] = 0;\n"
     "  __syncthreads();\n",
     "  for (int c = tid; c < kPairTableWarps * 64 * kW; c += nthr) sh.wsum[c] = 0;\n"
     "  __syncthreads();\n" + _STAMP.replace("{k}", "0")),
    ("  cluster.sync();  // every slice's words written\n",
     _STAMP.replace("{k}", "1") + "  cluster.sync();  // every slice's words written\n"
     + _STAMP.replace("{k}", "2")),
    ("    flush_counts<kW>(cl, ws + 32 * kW);\n  }\n",
     "    flush_counts<kW>(cl, ws + 32 * kW);\n  }\n" + _STAMP.replace("{k}", "3")),
    ("  cluster.sync();  // every CTA's sums in its shared memory, no word read any more\n",
     "  cluster.sync();  // every CTA's sums in its shared memory, no word read any more\n"
     + _STAMP.replace("{k}", "4")),
    ("      qs_out[o] = g.n - 2 * v;",
     "        { unsigned long long e_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(e_));\n"
     "          const unsigned long long s_[6] = {tt_[5], tt_[0], tt_[1], tt_[2], tt_[3], tt_[4]};\n"
     "          qs_out[o] = c < 5 ? static_cast<int>(s_[c + 1] - s_[c]) : c == 5 ? "
     "static_cast<int>(e_ - tt_[4]) : 0; }"),
]
T_NOLOAD = [("        x[k] = c0 + k < cn ? spin_xor<kVec>(spins + ra[c] + i0, spins + rb[c] + i0, cnt) &",
             "        x[k] = c0 + k < cn ? static_cast<uint32_t>(ra[c] ^ rb[c] ^ i0) &")]
T_NOSTORE = [("      if (s < cnt) out[s * kW + u] = w[s];",
              "      if (s < cnt && w[s] == 0x9e3779b9u) out[0] = 1;")]
T_NOATTR = [("  bool& ok = allowed[staged][g.words >> 1];\n  if (!ok) {",
             "  bool& ok = allowed[staged][g.words >> 1];\n  if (!ok && g.smem > 48 * 1024) {")]

# name: (design, source edits, edit of the host words or "bytes", keeps the function)
VARIANTS = {
    "o-nodiv": ("first", O_NODIV, None, False),
    "o-warp": ("first", O_WARP, None, True),
    "o-full": ("first", O_FULL, None, True),
    "n-div": ("redesign", N_DIV, None, True),
    "n-bytes": ("redesign", [], "bytes", True),
    "n-words4": ("redesign", [], _tpc(words_a_thread=4), True),
    "n-tpc32": ("redesign", [], _tpc(32), True),
    "t-nostage": ("table", T_NOSTAGE, None, False),
    "t-nocount": ("table", T_NOCOUNT, None, False),
    "t-t256": ("table", [], 256, True),
    "t-empty": ("table", T_NOSTAGE + T_NOCOUNT, None, False),
    "t-local": ("table", T_LOCAL, None, False),
    "t-noattr": ("table", T_NOATTR, None, True),
    "t-clock": ("table", T_CLOCK, None, False),
    "t-noload": ("table", T_CLOCK + T_NOLOAD, None, False),
    "t-nostore": ("table", T_CLOCK + T_NOSTORE, None, False),
}

# (name, shape, realizations, replicas, temperatures)
SHAPES = (("config4", (8, 8, 8), 8, 4, 24), ("config5", (16, 16, 16), 8, 4, 24),
          ("config1", (32, 32), 1, 2, 16))


# the table form's states: (name, shape, offsets, realizations, replicas,
# temperatures)
NINE = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1],
        [0, 1, 1], [0, 1, -1]]
TABLE_SHAPES = (("glass4d", (10, 10, 10, 10), None, 16, 2, 12),
                ("houd4", (10, 10, 10, 10), None, 16, 4, 12),
                ("nine16", (16, 16, 16), NINE, 8, 2, 24))
# forced forms of the redesign's plan (--table-forms): CTAs a cluster
TABLE_FORMS = (8, 4, 2, 1)
# the clusters of a table redesign's launch that the card holds at once,
# added to the probe's builds of pairs.cu (negative: a CUDA error)
OCCUPANCY = '''
extern "C" int probe_pair_table_max_clusters(int words, int staged, int threads, int smem,
                                             int C) {
  const PairTableKernel kernel = pair_table_kernel(words, staged != 0);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPairTableSmem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
'''


def design(csrc: Path) -> str:
    return "redesign" if "pair_link_bits" in (csrc / "pairs.cu").read_text() else "first"


def table_design(csrc: Path) -> str:
    """pair_overlap_table's design of a source: the first (columns a CTA)
    or the redesign (clusters staging disagreement words)."""
    return "redesign" if "PairSmem" in (csrc / "pairs.cu").read_text() else "first"


def axes_words(pairs_cu: Path) -> bool:
    """Whether a redesign's source reads the words of the axes alone (before
    the offset tables: the 13 head words and the three divisors, 19 in
    all)."""
    return "PairOffset" not in pairs_cu.read_text()


def builds(sources, out, variants):
    """``{(label, variant): (pairs.cu path, design)}``: each source's base
    and the variants of its design that edit the source (a variant of the
    host words shares its base's build); a variant whose anchors are not
    found stops the probe."""
    todo = {}
    for label, csrc in sources:
        own = design(csrc)
        text = (csrc / "pairs.cu").read_text()
        for variant in ("base", *variants):
            if variant != "base":
                aim, edits, _, _ = VARIANTS[variant]
                if aim == "table":
                    if table_design(csrc) != "redesign":
                        continue
                elif aim != own:
                    continue
                gone = [old.splitlines()[0] for old, _ in edits if text.count(old) != 1]
                if gone:
                    raise SystemExit(f"probe_pairs: {variant} does not apply to {csrc}: {gone}")
                if not edits:
                    todo[(label, variant)] = (None, own)
                    continue
            d = out / label / variant
            d.mkdir(parents=True, exist_ok=True)
            for h in csrc.glob("*.cuh"):
                shutil.copy(h, d / h.name)
            src = text
            for old, new in ([] if variant == "base" else VARIANTS[variant][1]):
                src = src.replace(old, new)
            if table_design(csrc) == "redesign":
                src += OCCUPANCY
            (d / "pairs.cu").write_text(src)
            todo[(label, variant)] = (d / "pairs.cu", own)
    return todo


def _kernel_name(fn):
    """``pair_overlap<args>`` or ``pair_overlap_table<args>`` of a mangled
    kernel name, else None."""
    for k in ("pair_overlap_table", "pair_overlap"):
        if f"{k}_kernel" in fn:
            args = [a or b for a, b in re.findall(r"Li(\d+)E|Lb([01])E",
                                                  fn.split("_kernel", 1)[1])]
            return k + (f"<{', '.join(args)}>" if args else "")
    return None


def registers(log: str) -> dict:
    """``{kernel<W>: "R registers, S B spilled"}`` of the pair kernels in a
    ``ptxas -v`` log."""
    out, name = {}, None
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
    """Per pair kernel (each template instance): its static instructions and
    integer-division sequences (``I2F.U32.RP``), from ``cuobjdump -sass``."""
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


def inputs(shape, d, n_rep, n_temps, dev, rng):
    n = int(np.prod(shape))
    s = n_rep * n_temps
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(spins=up(rng.choice(np.array([-1, 1], np.int8), size=(d, s, n))),
                sid=up(np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)),
                shape=tuple(shape), d=d, n_rep=n_rep, n_temps=n_temps, n=n, s=s)


def launcher(lib, first, x, words_edit, axes=False):
    """``(fn, qs, ql)``: one launch of a build's pair_overlap into the rows
    ``qs`` / ``ql`` (int32 ``[d, P T]``); ``axes``: the build reads the
    words of the axes alone (:func:`axes_words`)."""
    dev = x["spins"].device
    d, P, T = x["d"], x["n_rep"] // 2, x["n_temps"]
    qs = torch.empty((d, P * T), dtype=torch.int32, device=dev)
    ql = torch.empty_like(qs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (x["spins"].data_ptr(), x["sid"].data_ptr(), qs.data_ptr(), ql.data_ptr(), P * T)
    fn = lib.peapods_pair_overlap
    fn.restype = _I
    if first:
        fn.argtypes = [_P] * 4 + [_I] * 8 + [_P]
        args = (*head, d, P, T, x["s"], *_build.dims3(x["shape"]), stream)
    else:
        fn.argtypes = [_P] * 4 + [_I] * 2 + [_P] * 2
        words = megapair.pair_words(x["shape"], x["n_rep"], x["s"],
                                    1 if words_edit == "bytes" else 0)
        if callable(words_edit):
            words = words_edit(words)
        if axes:
            words = np.concatenate([words[:13], words[15:21]])
        qs.words = words  # held with the rows
        args = (*head, d, words.ctypes.data, stream)
    return (lambda: _build.check(fn(*args), "pair_overlap")), qs, ql


def bound_ms(x):
    """``chip_smoke.py``'s bound: the paired systems' spins in, two ints a
    column out, over the card's memory rate."""
    cols = x["d"] * (x["n_rep"] // 2) * x["n_temps"]
    return (2 * cols * x["n"] + 8 * cols) / HBM_BYTES_S * 1e3


def probe(libs, todo, states, card, rounds, results):
    keys = [k for k in todo if VARIANTS.get(k[1], ("",))[0] != "table"]
    for name, x in states():
        ps, pl = megapair.pair_overlap_plain(x["spins"], x["sid"], x["shape"], x["n_rep"])
        reps = 200
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                label, variant = key
                first = todo[key][1] == "first"
                spec = VARIANTS.get(variant, (None, [], None, True))
                lib = libs[key if todo[key][0] is not None else (label, "base")][0]
                src = todo[key][0] or todo[(label, "base")][0]
                fn, qs, ql = launcher(lib, first, x, spec[2],
                                      axes=not first and axes_words(src))
                fn()
                torch.cuda.synchronize()
                ok = bool(torch.equal(qs, ps) and torch.equal(ql, pl)) if spec[3] else None
                if spec[3] and not ok:
                    raise AssertionError(f"{label} {variant} at {name} differs from its plain "
                                         "version")
                ms = events_ms(fn, reps)
                rec = dict(kind="pair_overlap", source=label, variant=variant, state=name,
                           round=rnd, ms=ms, bound_ms=bound_ms(x), bitwise_plain=ok,
                           words=None if first else [int(v) for v in getattr(qs, "words")[:13]])
                results.append(rec)
                print(f"[pair_overlap] {label} {variant} {name}: {ms:.5f} ms a launch (bound "
                      f"{rec['bound_ms']:.6f} ms, bytes)"
                      + (", qs / ql bitwise plain" if ok else "") + f" round {rnd} on {card}",
                      flush=True)


def table_inputs(shape, offsets, d, n_rep, n_temps, dev, rng):
    lat = Lattice(shape, offsets)
    s = n_rep * n_temps
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(lat=lat, spins=up(rng.choice(np.array([-1, 1], np.int8), (d, s, lat.n_spins))),
                sid=up(np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int32)),
                fwd=lat.device_tables(dev)[0], d=d, n_rep=n_rep, n_temps=n_temps, s=s)


def forced_plan(n, cols, cluster):
    words = 1 if cols <= 32 else 2 if cols <= 64 else 4
    slice_ = (-(-n // cluster) + 3) // 4 * 4
    return megapair.PairTablePlan(words, -(-cols // (32 * words)), cluster, 1, slice_, slice_,
                                  256, megapair.pair_table_smem(slice_, words))


def table_launcher(lib, first, x, plan=None):
    """``(fn, qs, ql, plan)``: one launch of a build's pair_overlap_table:
    the first design at its columns a CTA (the largest divisor up to 4),
    the redesign on ``plan`` (default ``megapair.pair_table_plan``'s)."""
    dev = x["spins"].device
    lat, d = x["lat"], x["d"]
    n, nb, T, s = lat.n_spins, lat.n_neighbors, x["n_temps"], x["s"]
    cols = (x["n_rep"] // 2) * T
    qs = torch.empty((d, cols), dtype=torch.int32, device=dev)
    ql = torch.empty_like(qs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.peapods_pair_overlap_table
    fn.restype = _I
    head = (x["spins"].data_ptr(), x["sid"].data_ptr(), x["fwd"].data_ptr(), qs.data_ptr(),
            ql.data_ptr())
    if first:
        fn.argtypes = [_P] * 5 + [_I] * 8 + [_P]
        per = max(k for k in range(1, 5) if cols % k == 0)
        args = (*head, cols, n, nb, d, T, cols, s, per, stream)
    else:
        fn.argtypes = [_P] * 7 + [_I] * 2 + [_P] * 2
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = plan or megapair.pair_table_plan(n, cols, d, sms)
        words = megapair.pair_table_words(n, nb, T, cols, s, plan)
        rows = d * plan.groups  # the unstaged form's counters and sums
        scratch = torch.zeros(rows * (1 + plan.copies * 64 * plan.words), dtype=torch.int32,
                              device=dev)
        qs.held = (words, scratch)
        args = (*head, scratch[rows:].data_ptr(), scratch.data_ptr(), cols, d,
                words.ctypes.data, stream)
    return (lambda: _build.check(fn(*args), "pair_overlap_table")), qs, ql, plan


def table_bound_ms(x):
    """``chip_smoke.py`` ``ea_pair_bound``: the two systems of every column
    and the forward table read once, two ints a column written."""
    lat = x["lat"]
    cols = x["d"] * (x["n_rep"] // 2) * x["n_temps"]
    return (2 * cols * lat.n_spins + 4 * lat.n_spins * lat.n_neighbors
            + 8 * cols) / HBM_BYTES_S * 1e3


def probe_table(libs, todo, dev, card, rounds, forms, only, rng, results):
    """pair_overlap_table of every source's base build at TABLE_SHAPES: qs
    and ql bitwise ``pair_overlap_table_plain``; with ``forms`` the
    redesign also on TABLE_FORMS' clusters."""
    keys = [k for k in todo if k[1] == "base" or VARIANTS[k[1]][0] == "table"]
    for name, shape, offsets, d, n_rep, n_temps in TABLE_SHAPES:
        if only and name not in only:
            continue
        x = table_inputs(shape, offsets, d, n_rep, n_temps, dev, rng)
        cols = (n_rep // 2) * n_temps
        ps, pl = megapair.pair_overlap_table_plain(x["spins"], x["sid"], x["fwd"], n_rep)
        for rnd in range(rounds):
            for key in (keys if rnd % 2 == 0 else keys[::-1]):
                src = todo[key][0] or todo[(key[0], "base")][0]
                first = table_design(src.parent) == "first"
                spec = VARIANTS.get(key[1], (None, [], None, True))
                lib = libs[key if todo[key][0] is not None else (key[0], "base")][0]
                plans = [None] + ([] if first or not forms else
                                  [forced_plan(x["lat"].n_spins, cols, c)
                                   for c in TABLE_FORMS])
                for plan in plans:
                    if spec[2] and plan is None:  # the variant's threads a CTA
                        base = megapair.pair_table_plan(x["lat"].n_spins, cols, d, 132)
                        plan = base._replace(threads=spec[2])
                    fn, qs, ql, used = table_launcher(lib, first, x, plan)
                    fits = None if first else lib.probe_pair_table_max_clusters(
                        used.words, int(used.slice > 0), used.threads, used.smem, used.cluster)
                    try:
                        fn()
                        torch.cuda.synchronize()
                    except RuntimeError as err:  # a refused launch: reported, the rest run
                        print(f"[pair_overlap_table] {key[0]} {name} ({used}) failed: {err}",
                              flush=True)
                        results.append(dict(kind="pair_overlap_table", source=key[0],
                                            state=name, plan=None if used is None
                                            else list(used), error=str(err)))
                        continue
                    ok = bool(torch.equal(qs, ps) and torch.equal(ql, pl))
                    if spec[3] and not ok:
                        raise AssertionError(f"{key[0]} pair_overlap_table at {name} "
                                             f"({used}) differs from its plain version")
                    ms = events_ms(fn, 200)
                    if key[1] in ("t-clock", "t-noload", "t-nostore"):  # phases, ns
                        fn()
                        torch.cuda.synchronize()
                        st = qs[:, :6].double()
                        print(f"[pair_overlap_table] {key[0]} {key[1]} {name} {used}: phases "
                              "(ns: set-up, staging, wait, counting, wait, sums) mean "
                              f"{[round(v, 1) for v in st.mean(0).tolist()]}, max "
                              f"{st.max(0).values.tolist()}", flush=True)
                    form = ("the first design" if first else
                            f"{used.cluster} CTAs a cluster x {used.copies} copies x "
                            f"{used.groups} column groups, "
                            f"{used.threads} threads, {fits} clusters resident"
                            + ("" if plan is None else " (forced)"))
                    results.append(dict(kind="pair_overlap_table", source=key[0],
                                        variant=key[1], state=name, round=rnd, ms=ms,
                                        bound_ms=table_bound_ms(x), bitwise_plain=ok,
                                        design="first" if first else "redesign",
                                        plan=None if first else list(used),
                                        forced=plan is not None))
                    print(f"[pair_overlap_table] {key[0]} {key[1]} {name} ({d} x {cols} "
                          f"columns, {x['lat'].n_neighbors} offsets, {form}): {ms:.5f} ms a "
                          f"launch (bound {table_bound_ms(x):.6f} ms, bytes)"
                          + (", qs / ql bitwise plain" if ok else "") + f" round {rnd} on "
                          f"{card}", flush=True)
        del x
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_pairs"))
    ap.add_argument("--json", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all of each source's design)")
    ap.add_argument("--shapes", default="", help="comma-separated state names (default: all)")
    ap.add_argument("--table-forms", action="store_true",
                    help="also time the table redesign on clusters of 1 to 8 CTAs")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_pairs: torch sees no CUDA device", file=sys.stderr)
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
        results.append(dict(kind="build", source=key[0], variant=key[1], registers=regs,
                            sass=counts))
        print(f"[ptxas] {key[0]} {key[1]}: " + "; ".join(f"{k} {v}" for k, v in regs.items()),
              flush=True)
        for k, c in counts.items():
            print(f"[sass] {key[0]} {key[1]} {k}: {c['instructions']} instructions, "
                  f"integer divisions {c['int_div']}", flush=True)
    only = {s for s in a.shapes.split(",") if s}
    rng = np.random.default_rng(16)

    def states():
        for name, shape, d, n_rep, n_temps in SHAPES:
            if not only or name in only:
                yield name, inputs(shape, d, n_rep, n_temps, dev, rng)

    probe(libs, todo, states, card, a.rounds, results)
    probe_table(libs, todo, dev, card, a.rounds, a.table_forms, only, rng, results)
    path = Path(a.json) if a.json else out / "probe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
