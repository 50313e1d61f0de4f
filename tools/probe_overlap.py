"""Time the kernels of the overlap moves (``csrc/overlap.cu``:
``ov_bonds``, Joerg's bonds or CMR's blue ones and the Wolff seed;
``ov_mid``, CMR's blue flip and grey bonds; ``houdn_bonds``, Houdayer(N)'s
state bytes and seed; ``ov_finish``, the Joerg / CMR flips from the
labelling's flat parents; ``houdn_finish``, Houdayer(N)'s flips) of two
source trees side by side on one NVIDIA GPU, with variants that cure one defect of a first design or take one part
of a redesign away, and count each kernel's SASS integer-division
sequences.

    python3 tools/probe_overlap.py --src old=CSRC_DIR --src new=CSRC_DIR
                                   [--out DIR] [--rounds N] [--variants a,b,...]
                                   [--shapes a,b,...] [--kernels a,b,...] [--json PATH]

Each ``--src`` names a directory of the port's CUDA sources; each kernel's
design is told by the source.  The bond kernels' first design (before
``OvWalk``): a thread a group of four sites of one task, ``fwd_site``'s
runtime divisions, byte loads, the couplings, J / T and exp again for
every task and bond, a serial Wolff seed, a parent written a site;
``ov_mid`` deciding each blue flip 1 + nd times a site by ``find_root``,
``nonsingleton``'s divisions and the coin, a parent2 written a site.  The
next two's first design (before ``houdn_rows``): ``houdn_bonds`` a thread
four sites of one task, (1 + nd) g chains of tasks -> sid -> spin loads a
site, ``fwd_site``'s divisions, a parent written a site; ``ov_finish`` a
thread a site, ``task_of``'s divisions, ``find_root`` on flat parents,
``nonsingleton``'s divisions, byte spins.  ``houdn_finish``'s first
design (before its ``OvWalk`` form): a thread a site of one task, the
task's realization and temperature by division, ``find_root`` on flat
parents (Wolff: on the seed in every thread), ``nonsingleton``'s
divisions, a tasks -> sid -> spins chain a member and a site with byte
loads and stores, and a copy of the roots into the labels where asked
for (the update form with labels: ``cmr+houd4``).  Give the parent commit's
sources (``git archive`` of it unpacked under a directory ``.gitignore``
lists) and this checkout's.  The script builds ``overlap.cu`` of every
source as it is and patched into each variant that applies to it, all with
nvcc for sm_90a at once (into ``--out``), and prints each kernel's
``ptxas -v`` registers and, from ``cuobjdump -sass``, its static
instructions and integer-division sequences (``I2F.U32.RP``).

Variants of the bond kernels' first design, one defect cured each:

* ``o-nodiv``: each forward neighbour at a clamped ``i + stride`` and
  ``nonsingleton``'s backward ones at ``i - stride``: no division (wrong
  values, the loads kept);
* ``o-noparent``: no ``parent`` / ``parent2`` written (bitwise);
* ``o-ballot``: Joerg's Wolff seed by one warp and two ballots, as
  ``houdn_bonds`` finds its own (bitwise).

Variants of the redesigns, one part taken away each (a variant applies to
a source where every kernel it changes is redesigned):

* ``n-div`` (all five): the sites' coordinates and the tasks' temperature
  by runtime divisions again;
* ``n-per1`` (all five): one task a thread;
* ``n-lazy`` (``ov_bonds``, ``ov_mid``): each bond's probability (its exp)
  drawn only where the bond can be active, in a branch, for every task,
  and compared as a float (groups of unit couplings keep their
  threshold);
* ``n-pertask`` (``ov_bonds``, ``ov_mid``): J / T and the probabilities
  taken for every task, not once a temperature;
* ``n-reflip`` (``ov_mid``): deciding each forward neighbour's blue flip
  again for every bond (one parent load and, SW, the coin) and testing
  sat_a != sat_b on the flipped spins, as the first design did;
* ``n-nodraw`` (``ov_bonds``, ``ov_mid``): no Philox rounds, the counter
  words taken as the uniforms (wrong values): the draws' share of the
  time;
* ``n-findroot`` (``ov_finish``, ``houdn_finish``): each site's root by
  ``find_root`` (a second dependent load for every site that is not a
  root) in place of the one load of its flat parent;
* ``n-bytes`` (``houdn_bonds``, ``ov_finish``): the per-site path (byte
  loads and stores, each site's neighbours from its coordinates);
* ``n-parent`` (``houdn_bonds``): a parent written a site again;
* ``n-serial`` (``houdn_finish``): each member's word loaded and stored
  before the next member's load;
* ``n-entries`` (``houdn_finish``): the salts or the seed's root loaded by
  the CTA's first threads, after their tasks -> sid chains.

The states are random +-1 spins at the replica path's shapes: config 5
(16^3 gaussian, 8 realizations, R = 4, 24 temperatures: 384 pair tasks),
config 4's (8^3 +-J) and the 64^2 glass of overlap observe (4
realizations, R = 2, 8 temperatures).  ``ov_bonds`` is timed on each for
Joerg and CMR, Wolff and SW (the observe form launches the SW one),
``ov_mid`` Wolff, SW, and SW writing the blue labels (sources whose
``ov_mid`` reads the blue labels as its parents, as the labelling writes
them, skip that form); ``houdn_bonds``, ``ov_finish`` and
``houdn_finish`` in the forms that the main paths launch
(``FINISH_FORMS``; ``houdn_finish`` also at config 5's 16^3 ladder: g =
4 SW and Wolff and the pair, g = 2; its first design copies the labels
in the SW g = 4 form, as ``cmr+houd4`` asks).  Every build and every
variant that keeps the function is held bitwise to the plain version
(``overlap.bond_states_plain``: the state bytes, state2 bytes and seeds;
the blue labels against the plain labelling;
``overlap.houdn_states_plain``: the state bytes and seeds;
``overlap.finish_plain``: every spin, on the plain version's last graph,
and the first ``houdn_finish``'s labels the parents).
The bounds are ``chip_smoke.py``'s, on each state (``ov_finish``'s
counting the spins that the plain move flips).  Times are device times of
one launch (CUDA events over warm launches queued behind a sleep kernel),
``--rounds`` times with the builds in order and then reversed.  Prints one
line per measurement with the card, writes all of them as JSON to
``--json`` (default ``--out/probe.json``).  Needs a CUDA device, nvcc and
cuobjdump; imports nothing of JAX.

``--table`` times the table forms ``ov_bonds_table``, ``ov_mid_table``
and ``houdn_bonds_table`` (4D and up, or 7 to 32 offsets; a first design,
a group of four sites of one task a thread, the task's systems found again
by every thread, byte gathers, J / T and the bond's exp again for every
task and bond, told from a redesign, a group of ``per`` tasks a thread with
the CTA's tasks staged, by its source) at the 4D +-J glass (10^4, 16
realizations x 12 temperatures x 2 replicas: ``ov_bonds_table`` CMR SW and
Joerg Wolff, ``ov_mid_table`` CMR SW on the plain blue words and their
labels, ``houdn_bonds_table`` the pair SW), Wolff Houdayer(4) at that shape
(R = 4) and nine16 (16^3 with 9 offsets, 8 x 12 x 2, CMR SW), on random
states, every output bitwise ``overlap.table_states_plain``'s, with the
variants ``t-o-nophilox`` / ``t-n-nophilox`` (``ov_bonds_table``'s Philox
replaced by a cheap mix of its counter and keys in the first design / the
redesign; wrong bonds: the share of the time the draws take), ``t-n-exp``
(the redesign taking every coupling as one other than +-1: J / T divided
and the exp drawn for every candidate, no staged unit threshold),
``t-n-lb3`` (the 4-offset kernels asked for three CTAs an SM),
``t-n-inline`` (the couplings other than +-1 decided inline),
``t-n-mid-nophilox`` (``ov_mid_table``'s grey draws so replaced),
``t-n-mid-nowalk`` (its SW backward words skipped; wrong flips),
``t-n-mid-inline`` (its backward words read inline) and ``t-n-runs`` (both
other redesigns reading a run of four consecutive neighbours as aligned
words), each variant on the plan of its own CTAs an SM; with ``--per`` each
redesign at every count of tasks a thread.  It prints the table kernels'
ptxas registers and spill bytes.
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

from chip_smoke import bound, card_line, ea_bounds, houdn_bounds, ov_finish_bound  # noqa: E402,E501
from peapods_tpu_torch.engine import seeds  # noqa: E402
from peapods_tpu_torch.ops import _build, fk, overlap  # noqa: E402
from peapods_tpu_torch.ops.cluster import connected_components  # noqa: E402
from peapods_tpu_torch.ops.lattice import Lattice  # noqa: E402
from probe_pt_link import events_ms  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = ("ov_bonds", "ov_mid", "houdn_bonds", "ov_finish", "houdn_finish")
BONDS = ("ov_bonds", "ov_mid")
# a kernel's design: redesigned where its source holds the marker
MARKER = {"ov_bonds": "OvWalk", "ov_mid": "OvWalk", "houdn_bonds": "houdn_rows",
          "ov_finish": "houdn_rows", "houdn_finish": "houdn_finish_kernel<2",
          "ov_bonds_table": "TableTasks", "ov_mid_table": "grey_bonds",
          "houdn_bonds_table": "sign_counts"}
TABLE = "ov_bonds_table"
TABLES = ("ov_bonds_table", "ov_mid_table", "houdn_bonds_table")

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
         ("  const int t = fast_div(w, g.m[2], g.s[2]);", "  const int t = w / g.G;"),
         ("    const int t = fast_div(blockIdx.x * g.per + k, g.m[2], g.s[2]);",
          "    const int t = (blockIdx.x * g.per + k) / g.G;")]
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

N_FINDROOT = [(
    "      const uint32_t st = load_roots<ND, kVec>(S, parent + base, x, lab);\n",
    "      const uint32_t st = load_roots<ND, kVec>(S, parent + base, x, lab);\n"
    "#pragma unroll\n      for (int q = 0; q < 4; ++q)\n"
    "        if (q < x.cnt) lab[q] = find_root(const_cast<int32_t*>(parent + base), x.i0 + q);\n"),
    ("      const uint32_t st = load_roots<ND, kVec>(state + base, parent + base, x, lab);\n",
     "      const uint32_t st = load_roots<ND, kVec>(state + base, parent + base, x, lab);\n"
     "#pragma unroll\n      for (int q = 0; q < 4; ++q)\n"
     "        if (q < x.cnt) lab[q] = find_root(const_cast<int32_t*>(parent + base), x.i0 + q);\n")]
N_BYTES = [("  const bool vec = g.lf % 4 == 0 && aligned(spins, 4) && aligned(state, 4) &&\n"
            "                   aligned(parent, 16);",
            "  const bool vec = false;"),
           ("  const bool vec = g.lf % 4 == 0 && aligned(spins, 4) && aligned(state, 4);\n"
            "  using Kernel = void (*)(const int8_t*, const int32_t*, const int32_t*, const int32_t*,\n"
            "                          uint8_t*, int32_t*, const OvWalk, int, int);",
            "  const bool vec = false;\n"
            "  using Kernel = void (*)(const int8_t*, const int32_t*, const int32_t*, const int32_t*,\n"
            "                          uint8_t*, int32_t*, const OvWalk, int, int);")]
N_PARENT = [
    ("                   uint8_t* __restrict__ state, int32_t* __restrict__ seeds, const OvWalk g,\n"
     "                   int gs, int wolff) {",
     "                   uint8_t* __restrict__ state, int32_t* __restrict__ seeds, const OvWalk g,\n"
     "                   int gs, int wolff, int32_t* __restrict__ parent) {"),
    ("      for (int d = 0; d < ND; ++d) st |= (act[0] & act[1 + d]) << d;\n",
     "      for (int d = 0; d < ND; ++d) st |= (act[0] & act[1 + d]) << d;\n"
     "      int32_t* pout = parent + static_cast<size_t>(b0 + k) * g.n;\n"
     "#pragma unroll\n      for (int q = 0; q < 4; ++q)\n"
     "        if (q < x.cnt) pout[x.i0 + q] = x.i0 + q;\n"),
    ("                        const void* probes, void* state, void* seeds, const int* words,\n"
     "                        int g_size, int wolff, void* stream) {",
     "                        const void* probes, void* state, void* seeds, const int* words,\n"
     "                        int g_size, int wolff, void* stream, void* parent) {"),
    ("                          uint8_t*, int32_t*, const OvWalk, int, int);\n"
     "  const Kernel kernel = g.nd == 3",
     "                          uint8_t*, int32_t*, const OvWalk, int, int, int32_t*);\n"
     "  const Kernel kernel = g.nd == 3"),
    ("      static_cast<uint8_t*>(state), static_cast<int32_t*>(seeds), g, g_size, wolff);",
     "      static_cast<uint8_t*>(state), static_cast<int32_t*>(seeds), g, g_size, wolff,\n"
     "      static_cast<int32_t*>(parent));")]
N_SERIAL = [("constexpr int kFlipBatch = 8;", "constexpr int kFlipBatch = 1;")]
N_ENTRIES = [("  const int e = kThreads - 1 - threadIdx.x;", "  const int e = threadIdx.x;")]

# ... and of ov_bonds_table's two designs: Philox replaced (wrong bonds), and
# the redesign's J / T and exp for every candidate
T_O_NOPHILOX = [("    const uint4 r = philox4x32_10(k0, k1, static_cast<uint32_t>(d), "
                 "static_cast<uint32_t>(grp),\n                                  0u, 0u);",
                 "    const uint4 r = make_uint4(k0 ^ static_cast<uint32_t>(grp), k1 + "
                 "static_cast<uint32_t>(grp), static_cast<uint32_t>(grp) * 0x9E3779B9u ^ "
                 "static_cast<uint32_t>(d), k0 + k1 + static_cast<uint32_t>(d));")]
T_N_NOPHILOX = [("      const uint4 r = philox4x32_10(sh.k0[k], sh.k1[k], static_cast<uint32_t>(d),\n"
                 "                                    static_cast<uint32_t>(grp), 0u, 0u);",
                 "      const uint32_t gw = static_cast<uint32_t>(grp);\n"
                 "      const uint4 r = make_uint4(sh.k0[k] ^ gw, sh.k1[k] + gw, gw * 0x9E3779B9u ^ "
                 "static_cast<uint32_t>(d), sh.k0[k] + sh.k1[k] + static_cast<uint32_t>(d));")]
T_N_INLINE = [("__device__ __noinline__ uint32_t other_pair_bonds(",
               "__device__ __forceinline__ uint32_t other_pair_bonds(")]
T_N_EXP = [("    const uint32_t uni = (m[j] >> 2) & kByteBits;\n    const uint32_t jp",
            "    const uint32_t uni = 0u * m[j];\n    const uint32_t jp")]
# ... and of ov_mid_table's redesign: the grey draws' Philox replaced (wrong
# bonds): the share of the time the draws take
T_N_MID_NOPHILOX = [("      const uint4 r = philox4x32_10(sh.k0[k], sh.k1[k], "
                     "static_cast<uint32_t>(nb + d),\n"
                     "                                    static_cast<uint32_t>(grp), 0u, 0u);",
                     "      const uint32_t gw = static_cast<uint32_t>(grp);\n"
                     "      const uint4 r = make_uint4(sh.k0[k] ^ gw, sh.k1[k] + gw, gw * "
                     "0x9E3779B9u ^ static_cast<uint32_t>(d), sh.k0[k] + sh.k1[k] + "
                     "static_cast<uint32_t>(d));")]
T_N_LB3 = [("template <int kKind, int NB>\n__global__ void __launch_bounds__(kThreads)\n"
            "ov_bonds_table_kernel(", "template <int kKind, int NB>\n__global__ void "
            "__launch_bounds__(kThreads, NB == 4 ? 3 : 1)\nov_bonds_table_kernel(")]
# ... and the SW blue flips' backward neighbours skipped (wrong flips): their share
T_N_MID_NOWALK = [("    const uint32_t look = need & past;", "    const uint32_t look = 0u;")]
# ... both redesigns reading a run of four consecutive neighbours (every
# axis offset but where a group meets the wrap) as the one or two aligned
# words that hold it, funnel-shifted, the other neighbours a byte at a time
GATHER_RUNS = """// The neighbour words as gather_words reads them, but a run of four
// consecutive neighbours from its aligned words.
template <int K>
__device__ __forceinline__ void gather_runs(uint32_t (&w)[K], const int8_t* __restrict__ s,
                                            const int (&f)[4][K]) {
  uint8_t b[4][K];
  bool run[K];
  uint32_t lo[K], hi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    run[j] = f[1][j] == f[0][j] + 1 && f[2][j] == f[0][j] + 2 && f[3][j] == f[0][j] + 3;
    const uintptr_t a = reinterpret_cast<uintptr_t>(s + f[0][j]);
    const uint32_t* p = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    lo[j] = run[j] ? __ldg(p) : 0u;
    hi[j] = run[j] && (a & 3) ? __ldg(p + 1) : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q][j] = run[j] ? 0 : static_cast<uint8_t>(__ldg(s + f[q][j]));
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    w[j] = run[j] ? __funnelshift_r(lo[j], hi[j], 8 * static_cast<uint32_t>(
                                                      reinterpret_cast<uintptr_t>(s + f[0][j]) & 3))
                  : b[0][j] | static_cast<uint32_t>(b[1][j]) << 8 |
                        static_cast<uint32_t>(b[2][j]) << 16 | static_cast<uint32_t>(b[3][j]) << 24;
}

"""
T_N_RUNS = [("// The group's blue words st[q] (bit d: the blue bond to fwd[i0 + q, d]) and",
             GATHER_RUNS + "// The group's blue words st[q] (bit d: the blue bond to fwd[i0 + q, d]) and"),
            ("  gather_words<K>(an, A, f);\n  gather_words<K>(bn, B, f);\n"
             "  const float inv = sh.inv[k];\n  const uint32_t nz",
             "  gather_runs<K>(an, A, f);\n  gather_runs<K>(bn, B, f);\n"
             "  const float inv = sh.inv[k];\n  const uint32_t nz"),
            ("    gather_words<K>(w0, s0, f);\n    gather_words<K>(w1, s1, f);",
             "    gather_runs<K>(w0, s0, f);\n    gather_runs<K>(w1, s1, f);")]
# ... and ov_mid_table's backward words read inline
T_N_MID_INLINE = [("__device__ __noinline__ uint32_t back_words(",
                   "__device__ __forceinline__ uint32_t back_words(")]
# name: (design, source edits, tasks a thread or None, keeps the function,
# the kernels it changes)
VARIANTS = {
    "o-nodiv": ("first", O_NODIV, None, False, BONDS),
    "o-noparent": ("first", O_NOPARENT, None, True, BONDS),
    "o-ballot": ("first", O_BALLOT, None, True, BONDS),
    "n-div": ("redesign", N_DIV, None, True, KERNELS),
    "n-per1": ("redesign", [], 1, True, KERNELS),
    "n-lazy": ("redesign", N_LAZY, None, True, BONDS),
    "n-pertask": ("redesign", N_PERTASK, None, True, BONDS),
    "n-reflip": ("redesign", N_REFLIP, None, True, ("ov_mid",)),
    "n-nodraw": ("redesign", N_NODRAW, None, False, BONDS),
    "n-findroot": ("redesign", N_FINDROOT, None, True, ("ov_finish", "houdn_finish")),
    "n-bytes": ("redesign", N_BYTES, None, True, ("houdn_bonds", "ov_finish")),
    "n-parent": ("redesign", N_PARENT, None, True, ("houdn_bonds",)),
    "n-serial": ("redesign", N_SERIAL, None, True, ("houdn_finish",)),
    "n-entries": ("redesign", N_ENTRIES, None, True, ("houdn_finish",)),
    "t-o-nophilox": ("first", T_O_NOPHILOX, None, False, (TABLE,)),
    "t-n-nophilox": ("redesign", T_N_NOPHILOX, None, False, (TABLE,)),
    "t-n-exp": ("redesign", T_N_EXP, None, True, (TABLE,)),
    "t-n-lb3": ("redesign", T_N_LB3, None, True, (TABLE,)),
    "t-n-inline": ("redesign", T_N_INLINE, None, True, (TABLE,)),
    "t-n-mid-nophilox": ("redesign", T_N_MID_NOPHILOX, None, False, ("ov_mid_table",)),
    "t-n-mid-nowalk": ("redesign", T_N_MID_NOWALK, None, False, ("ov_mid_table",)),
    "t-n-runs": ("redesign", T_N_RUNS, None, True, ("ov_mid_table", "houdn_bonds_table")),
    "t-n-mid-inline": ("redesign", T_N_MID_INLINE, None, True, ("ov_mid_table",)),
}

# (name, shape, realizations, replicas, temperatures, their range, couplings)
SHAPES = (("config5", (16, 16, 16), 8, 4, 24, (0.8, 2.0), "gauss"),
          ("config4", (8, 8, 8), 8, 4, 24, (0.9, 2.2), "pm"),
          ("glass64", (64, 64), 4, 2, 8, (0.8, 2.0), "pm"))
# (kernel, kind, wolff, blue labels): the bond kernels' forms, on every state
BOND_FORMS = (("ov_bonds", "jorg", True, False), ("ov_bonds", "jorg", False, False),
              ("ov_bonds", "cmr", True, False), ("ov_bonds", "cmr", False, False),
              ("ov_mid", "cmr", True, False), ("ov_mid", "cmr", False, False),
              ("ov_mid", "cmr", False, True))
# (state, kernel, kind, wolff, group size, labels): the other three's
# forms, each on the state of a main path that launches it (houdn_finish
# also on config 5's: the 16^3 ladder); labels: the first houdn_finish
# copies the labels (cmr+houd4's form)
FINISH_FORMS = (("config5", "ov_finish", "jorg", True, 2, False),
                ("config5", "ov_finish", "jorg", False, 2, False),
                ("config5", "ov_finish", "cmr", True, 2, False),
                ("config5", "ov_finish", "cmr", False, 2, False),
                ("config5", "houdn_finish", "houdayer", True, 2, False),
                ("config5", "houdn_finish", "houdayer", True, 4, False),
                ("config5", "houdn_finish", "houdayer", False, 4, True),
                ("config4", "houdn_bonds", "houdayer", True, 2, False),
                ("config4", "houdn_bonds", "houdayer", True, 4, False),
                ("config4", "houdn_bonds", "houdayer", False, 4, False),
                ("config4", "houdn_finish", "houdayer", True, 2, False),
                ("config4", "houdn_finish", "houdayer", True, 4, False),
                ("config4", "houdn_finish", "houdayer", False, 4, True),
                ("config4", "ov_finish", "cmr", False, 2, False),
                ("glass64", "houdn_bonds", "houdayer", False, 2, False))


def forms(state):
    """``(kernel, kind, wolff, group size, labels)`` timed on a state
    (labels: ov_mid's blue labels, the first houdn_finish's labels)."""
    return ([(k, kind, wolff, 2, labels) for k, kind, wolff, labels in BOND_FORMS]
            + [(k, kind, wolff, g, labels) for name, k, kind, wolff, g, labels in FINISH_FORMS
               if name == state])


def designs(text: str) -> dict:
    return {k: "redesign" if MARKER[k] in text else "first" for k in (*KERNELS, *TABLES)}


def builds(sources, out, variants):
    """``{(label, variant): (source path or None, each kernel's design,
    whether ov_mid writes blue labels)}``: each source's base build and the
    variants that apply to it (a host-plan variant shares its base's
    build); a variant whose anchors are not found stops the probe."""
    todo = {}
    for label, csrc in sources:
        text = (csrc / "overlap.cu").read_text()
        own = designs(text)
        labelled = "blue_labels" in text
        for variant in ("base", *variants):
            edits = []
            if variant != "base":
                aim, edits, _, _, changed = VARIANTS[variant]
                if any(own[k] != aim for k in changed):
                    continue
                gone = [old.splitlines()[0] for old, _ in edits if text.count(old) != 1]
                if gone:
                    raise SystemExit(f"probe_overlap: {variant} does not apply to {csrc}: "
                                     f"{gone}")
                if not edits:
                    todo[(label, variant)] = (None, own, labelled)
                    continue
            d = out / label / variant
            d.mkdir(parents=True, exist_ok=True)
            for h in csrc.glob("*.cuh"):
                shutil.copy(h, d / h.name)
            src = text
            for old, new in edits:
                src = src.replace(old, new)
            (d / "overlap.cu").write_text(src)
            todo[(label, variant)] = (d / "overlap.cu", own, labelled)
    return todo


def _kernel_name(fn, kernels=KERNELS):
    for k in kernels:
        if f"{k}_kernel" in fn:
            args = re.findall(r"Li(\d+)E|Lb([01])E", fn.split("_kernel", 1)[1])
            args = [a or b for a, b in args]
            return k + (f"<{', '.join(args)}>" if args else "")
    return None


def compile_all(todo):
    """One nvcc for each build, all at once: ``{key: (lib, ptxas log, sass)}``."""
    procs = []
    for key, (src, *_) in todo.items():
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


def kernel_counts(log: str, sass: str, kernels=KERNELS):
    """Registers and SASS counts of ``kernels`` (each template instance)."""
    regs, counts, name, spill = {}, {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _kernel_name(m.group(1), kernels)
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
            name = _kernel_name(m.group(1), kernels)
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


def tables(x, kind, wolff, g, rng, dev):
    keys = rng.integers(0, 2**32, (x["d"], 2), dtype=np.uint64).astype(np.uint32)
    tasks, tkeys = seeds.overlap_tasks(keys, [5], x["n_rep"], x["n_temps"], g)
    scal, probes = seeds.event_scalars(kind, wolff, tkeys[0], x["n"])
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (up(tasks[0]), up(scal.reshape(-1, 6)), up(probes.reshape(-1, 64)),
            up(tkeys[0].view(np.int32).reshape(-1, 2)))


def want(x, tab, kernel, kind, wolff):
    """The plain version: the bond kernels' ``(state, state2, seeds, blue
    labels)`` (the blue labels: each site's root of the blue graph, as
    fk_link leaves them); ``houdn_bonds``' ``(state, seeds)``; the
    finishes' inputs ``(state, parent, seeds)`` (the move's last graph)
    and their spins."""
    shape = x["shape"]
    if kernel == "houdn_bonds":
        return overlap.houdn_states_plain(x["spins"], x["sid"], tab[0], tab[2], wolff=wolff,
                                          shape=shape)
    if kernel == "houdn_finish":
        st, sd = overlap.houdn_states_plain(x["spins"], x["sid"], tab[0], tab[2], wolff=wolff,
                                            shape=shape)
        par = connected_components(fk.state_masks(st, len(shape)), shape).to(torch.int32)
        sp = x["spins"].clone()
        overlap.finish_plain(sp, x["sid"], tab[0], tab[1], sd, st, par, kind=kind,
                             wolff=wolff, shape=shape)
        return st, par, sd, sp
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    st, st2, sd = overlap.bond_states_plain(x["spins"].clone(), *args, kind=kind, wolff=wolff,
                                            shape=shape)
    if kernel in BONDS:
        lab = connected_components(fk.state_masks(st, len(shape)), shape).to(torch.int32)
        return st, st2, sd, lab
    st = st if kind == "jorg" else st2
    par = connected_components(fk.state_masks(st, len(shape)), shape).to(torch.int32)
    sp = x["spins"].clone()
    overlap.finish_plain(sp, x["sid"], tab[0], tab[1], sd, st, par, kind=kind, wolff=wolff,
                         shape=shape)
    return st, par, sd, sp


def bond_launcher(lib, first, x, tab, kind, wolff, labels, kernel, plain, per, labelled=True):
    """``(fn, outputs)``: one launch of a build's bond kernel
    (``labelled``: the build's ``ov_mid`` takes a blue-labels pointer)."""
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
        # since the labels' hand-over ov_mid writes no blue labels: its
        # parents are the blue labels (the labels form is not launched)
        blue_out = [p_blue] if labelled else []
        fn.argtypes = [_P] * (11 + len(blue_out)) + [_I] + [_P]
        words = overlap.ov_words(shape, d, x["n_temps"], g, s, per)
        args = (*head, tab[3].data_ptr(), st.data_ptr(), parent.data_ptr(),
                state2.data_ptr(), *blue_out, words.ctypes.data, int(wolff), stream)
        state2.words = words
    state2.parent = parent
    return (lambda: _build.check(fn(*args), "ov_mid")), (state2, blue)


def finish_launcher(lib, first, variant, x, tab, kernel, kind, wolff, g, plain, per,
                    labels=False):
    """``(fn, check)``: one launch of a build's ``houdn_bonds``,
    ``ov_finish`` or ``houdn_finish`` (``labels``: the first design copies
    the labels), and a function that runs it once on fresh outputs and says
    whether they are the plain version's."""
    dev = x["spins"].device
    d, n, shape = x["d"], x["n"], x["shape"]
    b = tab[0].numel() // g
    G = x["n_rep"] // g
    s = x["n_rep"] * x["n_temps"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = (b, *_build.dims3(shape), x["n_temps"], G, s)
    words = overlap.ov_words(shape, d, x["n_temps"], G, s, per)
    u8 = dict(dtype=torch.uint8, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    if kernel == "houdn_bonds":
        state = torch.empty((b, n), **u8)
        sd = torch.empty((b,), **i32)
        par = torch.empty((b, n), **i32)
        fn = lib.peapods_houdn_bonds
        fn.restype = _I
        head = [t.data_ptr() for t in (x["spins"], x["sid"], tab[0], tab[2])]
        if first:
            fn.argtypes = [_P] * 7 + [_I] * 9 + [_P]
            args = (*head, state.data_ptr(), par.data_ptr(), sd.data_ptr(), *dims, g,
                    int(wolff), stream)
        else:
            extra = [par.data_ptr()] if variant == "n-parent" else []
            fn.argtypes = [_P] * 7 + [_I] * 2 + [_P] * (1 + len(extra))
            args = (*head, state.data_ptr(), sd.data_ptr(), words.ctypes.data, g, int(wolff),
                    stream, *extra)

        def run():
            return _build.check(fn(*args), "houdn_bonds")

        def check():
            state.fill_(0xAA)
            sd.fill_(-1)
            run()
            torch.cuda.synchronize()
            return bool(torch.equal(state, plain[0]) and torch.equal(sd, plain[1]))

        return run, check
    st, par, sd, sp = plain
    spins = x["spins"].clone()
    if kernel == "houdn_finish":
        fn = lib.peapods_houdn_finish
        fn.restype = _I
        head = [t.data_ptr() for t in (spins, x["sid"], tab[0], tab[1])]
        lab = torch.full_like(par, -1) if first and labels else None
        if first:
            fn.argtypes = [_P] * 8 + [_I] * 10 + [_P]
            pp = par.clone()  # find_root may halve paths: flat parents are left as they are
            args = (*head, st.data_ptr(), pp.data_ptr(), sd.data_ptr(),
                    None if lab is None else lab.data_ptr(), *dims, g, int(wolff), 0, stream)
        else:
            fn.argtypes = [_P] * 8 + [_I] * 2 + [_P]
            args = (*head, st.data_ptr(), par.data_ptr(), sd.data_ptr(), words.ctypes.data, g,
                    int(wolff), stream)

        def run():
            return _build.check(fn(*args), "houdn_finish")

        def check():
            spins.copy_(x["spins"])
            run()
            torch.cuda.synchronize()
            return bool(torch.equal(spins, sp) and (lab is None or torch.equal(lab, par)))

        return run, check
    k = overlap.KINDS.index(kind)
    fn = lib.peapods_ov_finish
    fn.restype = _I
    head = [t.data_ptr() for t in (spins, x["sid"], tab[0], tab[1])]
    if first:
        fn.argtypes = [_P] * 10 + [_I] * 10 + [_P]
        pp = par.clone()  # find_root may halve paths: flat parents are left as they are
        args = (*head, st.data_ptr(), pp.data_ptr(), sd.data_ptr(), st.data_ptr(),
                pp.data_ptr(), None, *dims, k, int(wolff), 0, stream)
    else:
        fn.argtypes = [_P] * 8 + [_I] * 2 + [_P]
        args = (*head, sd.data_ptr(), st.data_ptr(), par.data_ptr(), words.ctypes.data, k,
                int(wolff), stream)

    def run():
        return _build.check(fn(*args), "ov_finish")

    def check():
        spins.copy_(x["spins"])
        run()
        torch.cuda.synchronize()
        return bool(torch.equal(spins, sp))

    return run, check


def bound_of(x, kernel, kind, wolff, g, labels, plain):
    """``chip_smoke.py``'s ``(bound_ms, bound_by)`` on this state:
    ``ov_bonds`` reads both spins and the couplings once and writes the
    state bytes; ``ov_mid`` also reads the state bytes and the flat parents
    and writes the state2 bytes (and the blue labels, in sources that write
    them); ``houdn_bonds``, ``houdn_finish`` and ``ov_finish`` as
    ``houdn_bounds`` and ``ov_finish_bound`` count them (the finishes the
    spins that the plain move flips)."""
    d, n = x["d"], x["n"]
    b = d * x["n_temps"] * (x["n_rep"] // g)
    nd = len(x["shape"])
    cb = 4 * nd * d * n
    if kernel == "ov_bonds":
        return bound(3 * b * n + cb, 12 * nd * b * n)
    if kernel == "ov_mid":
        return bound(8 * b * n + 4 * b * n * labels + cb, 12 * nd * b * n)
    if kernel == "houdn_bonds":
        return houdn_bounds(b, n, g, d, x["n_rep"] * x["n_temps"], wolff=wolff,
                            flipped=0)["houdn_bonds"]
    flipped = int((plain[3] != x["spins"]).sum())
    if kernel == "houdn_finish":
        return houdn_bounds(b, n, g, d, x["n_rep"] * x["n_temps"], wolff=wolff,
                            flipped=flipped)["houdn_finish"]
    return ov_finish_bound(b, n, kind, wolff, flipped)


def probe(libs, todo, states, card, rounds, results, rng, kernels):
    for name, x in states():
        dev = x["spins"].device
        threads = fk.resident_threads(dev.index) // 4
        for kernel, kind, wolff, g, labels in forms(name):
            if kernel not in kernels:
                continue
            G = x["n_rep"] // g
            per0 = overlap.ov_per(x["n"], x["d"], x["n_temps"], G, threads,
                                  max(1, overlap.HOUDN_ROWS // g)
                                  if kernel.startswith("houdn_") else overlap.OV_MAX_PER)
            tab = tables(x, kind, wolff, g, rng, dev)
            plain = want(x, tab, kernel, kind, wolff)
            bnd = bound_of(x, kernel, kind, wolff, g, labels, plain)
            form = (f"{kind}{g if kind == 'houdayer' else ''} {'wolff' if wolff else 'sw'}"
                    f"{' labels' if labels else ''}")
            for rnd in range(rounds):
                keys = list(todo)
                for key in (keys if rnd % 2 == 0 else keys[::-1]):
                    label, variant = key
                    first = todo[key][1][kernel] == "first"
                    spec = VARIANTS.get(variant, (None, [], None, True, KERNELS))
                    if kernel not in spec[4]:
                        continue
                    if kernel == "ov_mid" and labels and not todo[key][2]:
                        continue  # this build's ov_mid writes no blue labels
                    lib = libs[key if todo[key][0] is not None else (label, "base")][0]
                    per = spec[2] or per0
                    if (x["n_temps"] * G) % per:
                        continue  # a host plan this state's tasks do not split into
                    if kernel in BONDS:
                        fn, outs = bond_launcher(lib, first, x, tab, kind, wolff, labels,
                                                 kernel, plain, per, todo[key][2])

                        def check(fn=fn, outs=outs):
                            fn()
                            torch.cuda.synchronize()
                            if kernel == "ov_bonds":
                                return bool(torch.equal(outs[0], plain[0])
                                            and torch.equal(outs[1], plain[2]))
                            return bool(torch.equal(outs[0], plain[1])
                                        and (outs[1] is None or torch.equal(outs[1], plain[3])))
                    else:
                        fn, check = finish_launcher(lib, first, variant, x, tab, kernel, kind,
                                                    wolff, g, plain, per, labels)
                    ok = None
                    if spec[3]:
                        ok = check()
                        if not ok:
                            raise AssertionError(f"{label} {variant} {kernel} {form} at "
                                                 f"{name} differs from its plain version")
                    else:
                        fn()
                    ms = events_ms(fn, 200)
                    rec = dict(kind=kernel, form=form, source=label, variant=variant,
                               state=name, round=rnd, ms=ms, bound_ms=bnd[0],
                               bound_by=bnd[1], bitwise_plain=ok, per=None if first else per)
                    results.append(rec)
                    print(f"[{kernel}] {label} {variant} {name} {form}: {ms:.5f} ms a launch "
                          f"(bound {bnd[0]:.7f} ms, {bnd[1]}"
                          + ("" if first else f"; {per} tasks a thread") + ")"
                          + (", bitwise plain" if ok else "") + f" round {rnd} on {card}",
                          flush=True)


# the table form's states: (name, shape, offsets, realizations, replicas,
# temperatures, their range, couplings) and the forms timed on each
# (kernel, kind, wolff, group size): the smoke's glass (CMR SW and Joerg
# Wolff, the pair Houdayer SW), Wolff houd4 at its shape (R = 4) and nine16
NINE = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1],
        [0, 1, 1], [0, 1, -1]]
TABLE_STATES = (("glass4d", (10, 10, 10, 10), None, 16, 2, 12, (1.6, 2.4), "pm",
                 (("ov_bonds_table", "cmr", False, 2), ("ov_bonds_table", "jorg", True, 2),
                  ("ov_mid_table", "cmr", False, 2), ("houdn_bonds_table", "houdayer", False, 2))),
                ("houd4", (10, 10, 10, 10), None, 16, 4, 12, (1.6, 2.4), "pm",
                 (("houdn_bonds_table", "houdayer", True, 4),)),
                ("nine16", (16, 16, 16), NINE, 8, 2, 12, (2.5, 4.5), "pm",
                 (("ov_bonds_table", "cmr", False, 2), ("ov_mid_table", "cmr", False, 2))))


def table_inputs(shape, offsets, d, n_rep, n_temps, t_range, couplings, dev, rng):
    lat = Lattice(shape, offsets)
    assert lat.table
    n, nb, s = lat.n_spins, lat.n_neighbors, n_rep * n_temps
    coup = (rng.choice([-1.0, 1.0], size=(d, n, nb)) if couplings == "pm"
            else rng.standard_normal((d, n, nb))).astype(np.float32)
    sid = np.stack([rng.permutation(n_temps)[None] + n_temps * rng.permutation(n_rep)[:, None]
                    for _ in range(d)]).reshape(d, s).astype(np.int32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    fwd, bwd = lat.device_tables(dev)
    return dict(lat=lat, shape=tuple(shape), d=d, n=n, nb=nb, n_rep=n_rep, n_temps=n_temps,
                spins=up(rng.choice(np.array([-1, 1], np.int8), size=(d, s, n))),
                coup=up(coup), temps=up(np.geomspace(*t_range, n_temps).astype(np.float32)),
                sid=up(sid), fwd=fwd, bwd=bwd)


def table_plain(x, tab, kernel, kind, wolff, g):
    """The plain version's outputs of a table kernel: ``(outputs, inputs)``,
    ov_bonds_table's words and seeds, ov_mid_table's grey words and flips
    on the plain blue words and their labels, houdn_bonds_table's words and
    seeds."""
    args = (x["sid"], tab[0], x["coup"], x["temps"], *tab[1:])
    st, st2, fl, sd = overlap.table_states_plain(x["spins"].clone(), *args, kind=kind,
                                                 wolff=wolff, lattice=x["lat"])
    if kernel != "ov_mid_table":
        return (st, sd), ()
    par = connected_components(fk.state_masks(st, x["nb"]), x["lat"].shape,
                               x["lat"].offsets).to(torch.int32)
    return (st2, fl), (st, par)


def table_plan_per(lib, first, x, kernel, kind, wolff, g):
    """The plan's tasks a thread of a build's redesigned kernel, on its own
    CTAs an SM (0 for a first design); a build before the query took the
    kernel asks ``peapods_ov_bonds_table_ctas``."""
    if first:
        return 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    most = overlap.table_most(kernel, g)
    smem = most * g * 8 if kernel == "houdn_bonds_table" else 0
    variant = (overlap.KINDS.index(kind) if kernel == "ov_bonds_table" else int(wolff)
               if kernel == "ov_mid_table" else int(g > 254))
    try:
        query = lib.peapods_ov_table_ctas
        query.restype, query.argtypes = _I, [_I] * 4
        ctas = query(overlap.TABLE_PLANNED.index(kernel), x["nb"], variant, smem)
    except AttributeError:
        query = lib.peapods_ov_bonds_table_ctas
        query.restype, query.argtypes = _I, [_I, _I]
        ctas = query(x["nb"], variant)
    return overlap.ov_table_plan(x["n"], x["d"], x["n_temps"], x["n_rep"] // g, sms, ctas,
                                 most).per


def table_launcher(lib, first, x, tab, kernel, kind, wolff, g, per, inputs):
    """``(fn, outputs)``: one launch of a build's table kernel (a redesign at
    ``per`` tasks a thread) on fresh outputs."""
    dev = x["spins"].device
    b = tab[0].numel() // g
    n = x["n"]
    words = overlap.ov_table_words(n, x["nb"], x["d"], x["n_temps"], x["n_rep"] // g,
                                   x["n_rep"] * x["n_temps"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = torch.zeros((b, n), dtype=torch.int32, device=dev)
    fn = getattr(lib, f"peapods_{kernel}")
    fn.restype = _I
    tail = [] if first else [per]
    if kernel == "ov_bonds_table":
        sd = torch.full((b,), -1, dtype=torch.int32, device=dev)
        head = [t.data_ptr() for t in (x["spins"], x["sid"], tab[0], x["coup"], x["temps"],
                                       tab[1], tab[2], tab[3], x["fwd"], state, sd)]
        fn.argtypes = [_P] * 12 + [_I] * (2 + len(tail)) + [_P]
        args = (*head, words.ctypes.data, overlap.KINDS.index(kind), int(wolff), *tail, stream)
        outs = (state, sd)
    elif kernel == "ov_mid_table":
        flip = torch.zeros((b, n), dtype=torch.uint8, device=dev)
        head = [t.data_ptr() for t in (x["spins"], x["sid"], tab[0], x["coup"], x["temps"],
                                       tab[1], tab[3], x["fwd"], x["bwd"], *inputs, state, flip)]
        fn.argtypes = [_P] * 14 + [_I] * (1 + len(tail)) + [_P]
        args = (*head, words.ctypes.data, int(wolff), *tail, stream)
        outs = (state, flip)
    else:
        sd = torch.full((b,), -1, dtype=torch.int32, device=dev)
        head = [t.data_ptr() for t in (x["spins"], x["sid"], tab[0], tab[2], x["fwd"], state,
                                       sd)]
        fn.argtypes = [_P] * 8 + [_I] * (2 + len(tail)) + [_P]
        args = (*head, words.ctypes.data, g, int(wolff), *tail, stream)
        outs = (state, sd)
    state.words = words  # held with the outputs
    return (lambda: _build.check(fn(*args), kernel)), outs


def probe_table(libs, todo, card, rounds, pers, only, rng, results):
    """The table kernels (TABLES) of every source's base build and their
    table variants at TABLE_STATES, each launch's outputs bitwise the plain
    version's (``table_plain``); with ``pers`` each redesign at every count
    of tasks a thread."""
    for name, shape, offsets, d, n_rep, n_temps, t_range, couplings, forms in TABLE_STATES:
        if only and name not in only:
            continue
        dev = torch.device("cuda", 0)
        x = table_inputs(shape, offsets, d, n_rep, n_temps, t_range, couplings, dev, rng)
        n = x["n"]
        for kernel, kind, wolff, g in forms:
            keys = [k for k in todo if k[1] == "base" or kernel in VARIANTS[k[1]][4]]
            groups = n_rep // g
            tg = n_temps * groups
            fits = [p for p in range(1, overlap.table_most(kernel, g) + 1)
                    if tg % p == 0 and (p % groups == 0 or groups % p == 0)]
            tab = tables(x, kind, wolff, g, rng, dev)
            want_out, inputs = table_plain(x, tab, kernel, kind, wolff, g)
            b_ms, b_by = ea_bounds(x["lat"], d, n_temps, g, groups, 0, kind, wolff)[kernel]
            form = f"{kind}{g if kind == 'houdayer' else ''} {'wolff' if wolff else 'sw'}"
            for rnd in range(rounds):
                for key in (keys if rnd % 2 == 0 else keys[::-1]):
                    label, variant = key
                    first = todo[key][1][kernel] == "first"
                    spec = VARIANTS.get(variant, (None, [], None, True, ()))
                    lib = libs[key if todo[key][0] is not None else (label, "base")][0]
                    rule = table_plan_per(lib, first, x, kernel, kind, wolff, g)
                    every = [rule] + ([p for p in fits if p != rule]
                                      if pers and variant == "base" else [])
                    for per in ([0] if first else every):
                        fn, outs = table_launcher(lib, first, x, tab, kernel, kind, wolff, g,
                                                  per, inputs)
                        fn()
                        torch.cuda.synchronize()
                        ok = None
                        if spec[3]:
                            ok = all(bool(torch.equal(o, w)) for o, w in zip(outs, want_out))
                            if not ok:
                                raise AssertionError(f"{label} {variant} {kernel} {form} at "
                                                     f"{name} (per {per}) differs from its "
                                                     "plain version")
                        ms = events_ms(fn, 100)
                        results.append(dict(kind=kernel, form=form, source=label,
                                            variant=variant, state=name, round=rnd, ms=ms,
                                            bound_ms=b_ms, bound_by=b_by, bitwise_plain=ok,
                                            per=None if first else per,
                                            rule=not first and per == rule,
                                            design="first" if first else "redesign"))
                        print(f"[{kernel}] {label} {variant} {name} {form} ({d * tg} tasks x "
                              f"{n} sites, {x['nb']} offsets, "
                              + ("the first design" if first else f"{per} tasks a thread")
                              + f"): {ms:.5f} ms a launch (bound {b_ms:.6f} ms, {b_by})"
                              + (", bitwise plain" if ok else "") + f" round {rnd} on {card}",
                              flush=True)
        del x
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--out", default=str(ROOT / "build" / "probe_overlap"))
    ap.add_argument("--json", default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all that apply to each source)")
    ap.add_argument("--shapes", default="", help="comma-separated state names (default: all)")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to time (default: all five)")
    ap.add_argument("--table", action="store_true",
                    help="also time the table forms ov_bonds_table, ov_mid_table and "
                         "houdn_bonds_table at the table runs' shapes")
    ap.add_argument("--per", action="store_true",
                    help="with --table: the redesign at every count of tasks a thread")
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
        regs, counts = kernel_counts(log, sass, (*KERNELS, *TABLES))
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

    probe(libs, todo, states, card, a.rounds, results, rng,
          {k for k in a.kernels.split(",") if k})
    if a.table:
        probe_table(libs, todo, card, a.rounds, a.per, only, rng, results)
    path = Path(a.json) if a.json else out / "probe.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card, results=results)))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
