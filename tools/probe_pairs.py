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


# name: (design, source edits, edit of the host words or "bytes", keeps the function)
VARIANTS = {
    "o-nodiv": ("first", O_NODIV, None, False),
    "o-warp": ("first", O_WARP, None, True),
    "o-full": ("first", O_FULL, None, True),
    "n-div": ("redesign", N_DIV, None, True),
    "n-bytes": ("redesign", [], "bytes", True),
    "n-words4": ("redesign", [], _tpc(words_a_thread=4), True),
    "n-tpc32": ("redesign", [], _tpc(32), True),
}

# (name, shape, realizations, replicas, temperatures)
SHAPES = (("config4", (8, 8, 8), 8, 4, 24), ("config5", (16, 16, 16), 8, 4, 24),
          ("config1", (32, 32), 1, 2, 16))


def design(csrc: Path) -> str:
    return "redesign" if "pair_link_bits" in (csrc / "pairs.cu").read_text() else "first"


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
                if aim != own:
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
            (d / "pairs.cu").write_text(src)
            todo[(label, variant)] = (d / "pairs.cu", own)
    return todo


def registers(log: str) -> dict:
    """``{kernel<W>: "R registers, S B spilled"}`` of the pair kernels in a
    ``ptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            args = re.findall(r"Li(\d+)E", fn.split("_kernel", 1)[-1])
            name = ("pair_overlap" + (f"<{', '.join(args)}>" if args else "")
                    if "pair_overlap_kernel" in fn else None)
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
            fn = m.group(1)
            name = None
            if "pair_overlap_kernel" in fn:
                args = re.findall(r"Li(\d+)E", fn.split("_kernel", 1)[1])
                name = "pair_overlap" + (f"<{', '.join(args)}>" if args else "")
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
    keys = list(todo)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_pairs"))
    ap.add_argument("--json", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all of each source's design)")
    ap.add_argument("--shapes", default="", help="comma-separated state names (default: all)")
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
    path = Path(a.json) if a.json else out / "probe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
