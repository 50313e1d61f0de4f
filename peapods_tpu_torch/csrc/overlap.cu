// Hopper kernels of the overlap moves (Houdayer(N), Joerg, CMR, each in
// Wolff or SW form) and of the energy re-derivation after a move.
//
// Replaces the TPU's fused overlap events peapods_tpu/ops/pallas_event.py:542
// overlap_event_batch (kernel _event_kernel :274, with the CC fixed point
// pallas_cc_batch.cc_fixed_point and the coin _salted_uniform_i32) and :989
// houdn_event_batch (kernel _houdn_kernel :901).  A task b = (d T + t) G + j
// groups the g replicas tasks[b g .. b g + g - 1] at temperature t of
// realization d (g = 2 for Joerg and CMR); its systems are found through
// sid (slot r T + t), so the spins stay by system ([d, n_slots, n] int8)
// and are flipped in place.  n is a 2D [L0, L1] (L2 = 1) or 3D [L0, L1, L2]
// lattice whose bonds are one a forward offset: the axes (the square and
// cubic lattices, in the axes' own form) or a table of up to six offsets
// (the triangular lattice, the reference's tri=True, BCC, FCC and any
// offset table; the table's form, template instance kTable); J/T is
// computed per bond as J / T in f32, as the reference's pack_event_jt
// does.  Four dimensions or more, or 7 to 32 offsets, take the kernels'
// neighbour-table form (*_table_kernel, "the table form" below), whose
// neighbours are the lattice's int32 tables.  The launches of one move, on
// the caller's stream:
//
// Houdayer(N) on groups of any even g, the pair move (g = 2) included:
//
//   houdn_bonds   the state byte of every site (bit d: forward bond d) and
//                 the Wolff seed, no parent (fk_link writes every parent):
//                 a site is active where the group's g spins sum to 0 (for
//                 a pair, a != b), a bond joins two active neighbours.  The
//                 Wolff seed is the first of the task's 64 probes that is
//                 active (n when none is, and the move is then a no-op; n
//                 for SW).
//   fk_link       (csrc/fk.cu, shared with the FK update) the labelling:
//                 every parent left at its component's minimum site index
//                 (flat), in the caller's labels buffer where labels are
//                 asked for; on the lattices other than the square, cubic
//                 and triangular ones the staged FK path's cc_link
//                 (csrc/cc.cu), which leaves the same labels.
//   houdn_finish  the flips of the seed's component (Wolff) or of each
//                 non-singleton component with salted_uniform(root, s0, s1)
//                 < 1/2 (SW) in all g systems, from fk_link's flat parents.
//                 It writes no label.  The observe form
//                 (overlap_cluster_action="observe", pairs only) launches no
//                 finish: fk_link's flat parents are the labels.

// Joerg and CMR on pairs:
//
//   ov_bonds   the state byte of every site (bit d: forward bond d) and
//              the Wolff seed, no parent (fk_link writes every parent):
//                Joerg     a a_fwd J/T > 0 && u < 1 - exp(-4 a a_fwd J/T)
//                          && active_i && active_fwd       (active: a b < 0)
//                CMR blue  a a_fwd J/T > 0 && b b_fwd J/T > 0 && u < 1 - r^2,
//                          r = exp(-2 |J/T|)
//              in the reference's operation order, u from Philox4x32-10
//              keyed by the task's two key words, counter (dir, site / 4, 0,
//              0); the seed Joerg's first probe with a != b (Wolff; n for
//              SW), or CMR's drawn seed.
//   fk_link    as above.
//   ov_mid     CMR only: the blue flip of each site (Wolff: the seed's blue
//              component; SW: salted_uniform(root, s0, s1) < 1/2 on
//              non-singletons), from the flat parents fk_link leaves, and
//              the grey bonds on the flipped spins, blue || (sat_a != sat_b
//              && u < 1 - r) with u from counter (n_dirs + dir, site / 4, 0,
//              0), n_dirs the lattice's forward offsets (on the triangular
//              lattice 3, not its 2 axes: the red draws never reuse a blue
//              one), into a second state byte (bit 7: the blue flip); a
//              second fk_link labels the grey graph into parent2.  The
//              flipped spins are never written here: the blue flip flips a
//              and b together, so sat_a != sat_b is the same before and
//              after it.
//   ov_finish  the flips of both systems from the flat parents of the
//              move's last graph (Joerg's; CMR's grey one, the blue flip
//              being bit 7 of state2): Joerg as houdn_finish; CMR, the blue
//              flip and then the grey flip of a (k & 1) and of b (k & 2), k
//              drawn per task (Wolff) or k = floor(4 salted_uniform(grey
//              root, s2, s3)) (SW).  It writes no label: fk_link labels
//              each graph into the caller's buffer (Joerg's and the grey
//              one into the labels, CMR's blue one into the blue labels,
//              which ov_mid then reads as its parents).  The observe form
//              launches no ov_mid and no ov_finish: fk_link labels the
//              stats graph (CMR: the blue one) into the caller's buffer.
//
// In every observe form the bond masks are bits 0 .. n_dirs-1 of the first
// kernel's state bytes (six offsets at most: bit 7 stays the blue flip's).
//
// The table's form steps each offset by its residues (OvOffset, found by
// the host: ops/overlap.py ov_words), as pair_overlap does (csrc/pairs.cu):
// a neighbour word is the word of the line that the offset's slower
// components reach, q words on, funnel-shifted by b bytes with the next
// one; a backward one the same q words back; a negative component a
// forward wrap; lines that hold no whole 4-byte word, or unaligned
// pointers, take the per-site path.  No runtime division: multiply-shift
// and one compare a component.  Its couplings are read one float at a
// time (nb a site), its arrays sized for six offsets.
//
//   energy_partials  per (realization, system) block partials of the
//              forward-bond energy sum_d s s_fwd J and of m, which pt_step
//              adds up: the energies of PT after a move (the reference's
//              re-derivation, peapods_tpu/engine/loop.py:3602-3612 through
//              peapods_tpu/ops/energy.py energies).
//
// What bounds it on the H100: a move touches per site the g int8 spins,
// a few coupling floats, a state byte and an int32 parent, a few times:
// under 10 MB per launch at 16^3 x 384 tasks.  Integer work a site and the
// launch count (2 to 5 launches a move, plus energy_partials) bound it,
// not bytes.
//
// houdn_bonds reads the group's g spins and writes a state byte a site:
// 0.00021 ms at 3.35 TB/s at config 4 (8^3, 384 pair tasks); ov_finish
// reads the flat parents and the state bytes and reads and writes only
// the spins that flip: 0.0030 ms at config 5; houdn_finish the same for
// Houdayer's g members.  Their first designs (houdn_bonds a thread four
// sites of one task, (1 + nd) g chains of tasks -> sid -> spin loads a
// site, runtime divisions for each neighbour, a dead parent written a
// site; ov_finish and houdn_finish a thread a site, runtime divisions for
// the task's temperature and realization and for the backward neighbours
// of the singleton test, find_root on flat parents, byte spins, and
// houdn_finish a tasks -> sid -> spins chain a member and a site and a
// copy of the roots into the labels) took 0.01036 and 0.02191 ms there
// (NVIDIA H100 80GB HBM3, 700 W), and now 0.00361 and 0.00475 ms.  All
// three take ov_bonds' walk, a group of four sites of `per` tasks a thread
// with each task's rows (houdn_*: its g member rows, in dynamic shared
// memory), salts and seed root staged once a CTA: houdn_bonds counts each
// byte's negative members over the g members' 4-byte words and their
// division-free neighbour words (__vcmpeq4 against g / 2); the finishes
// read each group's roots by one int4 load, test nonsingleton word-wide
// (the backward words only where a coin falls on a root with no forward
// bond) and flip each system's word by one xor (tools/probe_overlap.py
// times both designs).
//
// ov_bonds reads both replicas' spins and the couplings once and writes a
// state byte a site: 5.1 MB at config 5 (16^3, 384 tasks), 0.0015 ms at
// 3.35 TB/s; ov_mid also reads the state bytes and the flat parents: 13.0
// MB, 0.0039 ms.  Their first designs (a thread a group of one task,
// fwd_site's runtime divisions, byte loads, the couplings, J / T and exp
// again for every task and bond, a serial Wolff seed, dead parent writes;
// ov_mid deciding each blue flip 1 + nd times a site by find_root,
// nonsingleton's divisions and the coin) took 0.0334 and 0.0527 ms there
// (NVIDIA H100 80GB HBM3, 700 W).  Now a thread takes a group of four
// sites of `per` tasks of one realization (ov_words): division-free
// neighbour words, 4-byte spin words, the couplings read once, J / T and
// the exps once a temperature (none on +-J), each draw one integer
// compare, Philox only where a bond can be active,
// one 4-byte store; ov_mid decides each blue flip once, from one parent
// load (tools/probe_overlap.py times both designs).
//
// energy_partials reads every system's spins and each realization's
// couplings once: 3.5 MB at config 5 (16^3, 96 systems, 8 realizations),
// 0.00109 ms at 3.35 TB/s.  Its first design (a thread a site, two runtime
// divisions a forward neighbour, byte loads, the couplings read again by
// every system, eight barriers a partial) took 0.0449 ms there,
// issue-bound.  Now a warp takes a 256-site block of `per` systems of one
// realization (ops/overlap.py energy_words), a lane eight sites: their
// couplings read once by 16-byte loads, their spins as 8- or 4-byte words,
// each neighbour the same word of the next line or plane or the word
// shifted by a byte, found by multiply-shift, each bond's term a sign flip
// of J, and the block's values paired by the warp: 0.0066 ms (CUDA events;
// NVIDIA H100 80GB HBM3, 700 W; tools/probe_measure.py times both designs).
// Byte words took 0.0142, one system a warp 0.0095, float products 0.0075;
// loading the next system's words while summing one gained nothing.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mega.cuh"
#include "table.cuh"
#include "uf.cuh"

using namespace peapods;

namespace {

// the move kinds of ov_bonds / ov_finish (Houdayer takes the houdn_*
// kernels)
constexpr int kJorg = 1;
constexpr int kCmr = 2;
constexpr int kProbes = 64;

// The kernels' forms, their template parameter ND: 2 and 3 take the bonds
// of the square and cubic lattices, one a forward step along each axis, in
// the axes' own form; kTable takes any table of up to kMaxDirs forward
// offsets (the triangular, BCC and FCC lattices, offset tables), each
// stepped by its residues (OvOffset).  pair_overlap's first general form
// (csrc/pairs.cu), run on the axes, made that launch 24-25% slower at
// configs 4 and 5: so the axes keep their form, and the table's is a
// template instance of its own.
constexpr int kTable = 0;
constexpr int kMaxDirs = 6;

// The bond directions a form's arrays hold: the axes', or kMaxDirs, of
// which the walk's nb are the table's.
template <int ND>
struct Form {
  static constexpr int kDirs = ND == kTable ? kMaxDirs : ND;
};

// An offset's steps (ops/overlap.py ov_words): its outer slow component
// mod la (0 in 2D), its inner slow component mod lb, its fast component
// mod lf (rf), and rf as q 4-byte words and b bytes.  A negative component
// is a forward wrap: the triangular lattice's [1, -1] steps rb = 1, rf =
// lf - 1.
struct OvOffset {
  int ra;
  int rb;
  int rf;
  int q;
  int b;
};

// The overlap moves' launch (ops/overlap.py ov_words): a periodic
// lattice of n sites, 2D [L0, L1] or 3D [L0, L1, L2], its fast axis (the
// last, extent lf) in lines over an inner slow axis of extent lb (2D: L0;
// 3D: L1) and, in 3D, an outer one of extent la (L0; 1 in 2D); tasks b =
// (d T + t) G + j of T temperatures and G groups (pairs but for
// Houdayer(N)), S slots a realization, `per` tasks a thread;
// multiply-shift divisions (m, s) of lf, lb and G; nb bond directions,
// whether they are the axes (axes: nb = nd), and each one's steps.
struct OvWalk {
  int n;
  int nd;
  int lf;
  int lb;
  int la;
  int T;
  int G;
  int S;
  int per;
  int d;
  uint32_t m[3];
  int s[3];
  int nb;
  int axes;
  OvOffset off[kMaxDirs];
};

inline OvWalk make_ov_walk(const int* w) {
  OvWalk g;
  g.n = w[0];
  g.nd = w[1];
  g.lf = w[2];
  g.lb = w[3];
  g.la = w[4];
  g.T = w[5];
  g.G = w[6];
  g.S = w[7];
  g.per = w[8];
  g.d = w[9];
  for (int k = 0; k < 3; ++k) {
    g.m[k] = static_cast<uint32_t>(w[10 + 2 * k]);
    g.s[k] = w[11 + 2 * k];
  }
  g.nb = w[16];
  g.axes = w[17];
  for (int d = 0; d < kMaxDirs; ++d) {
    const int* o = w + 18 + 5 * d;
    g.off[d] = OvOffset{o[0], o[1], o[2], o[3], o[4]};
  }
  return g;
}

// The walk's bond directions: the axes' (known at compile time) or the
// table's nb.
template <int ND>
__device__ __forceinline__ int dirs(const OvWalk& g) {
  return ND == kTable ? g.nb : ND;
}

constexpr int kMaxPer = 8;                // the most tasks a thread takes
constexpr uint32_t kLow = 0x01010101u;    // bit 0 of each byte of a word

// The entries of a CTA's tasks, in shared memory: each task's two systems
// (the spins' row offsets), its temperature index, its key words, the unit
// coupling's threshold at its temperature, (ov_mid, ov_finish) its SW
// salts and the Wolff seed's root and (ov_finish) CMR's drawn k.
struct OvTasks {
  long long ra[kMaxPer];
  long long rb[kMaxPer];
  int t[kMaxPer];
  uint32_t k0[kMaxPer];
  uint32_t k1[kMaxPer];
  uint32_t thr[kMaxPer];
  uint32_t s0[kMaxPer];
  uint32_t s1[kMaxPer];
  int root[kMaxPer];
  int k[kMaxPer];
};

// The bond probabilities at J/T = jt, in the first design's operation
// order: Joerg 1 - exp(-4 inter) with inter = |jt| wherever the bond can be
// active (inter > 0 is jt's sign flipped where the spins differ); CMR blue
// 1 - r^2 and grey 1 - r, r = exp(-2 |jt|).
enum { kProbJorg = 0, kProbBlue = 1, kProbGrey = 2 };

__device__ __forceinline__ float bond_prob(int which, float jt) {
  if (which == kProbJorg) return 1.0f - expf(-4.0f * fabsf(jt));
  const float r = expf(-2.0f * fabsf(jt));
  return which == kProbBlue ? 1.0f - r * r : 1.0f - r;
}

// The least 24-bit word x with uniform24 of it (x 2^-24, exact) not below
// p: x 2^-24 < p iff x < ceil(p 2^24), the product exact (a power of two);
// 0 where p is not above 0 (or NaN), 2^24 where it is 1.  So a bond's draw
// uniform24(u) < p is the integer compare u >> 8 < threshold24(p).  A unit
// coupling (|J| = 1) has |J/T| = |1/T| bitwise: its threshold is
// threshold24(bond_prob(which, 1 / T)), once a task.
__device__ __forceinline__ uint32_t threshold24(float p) {
  return p > 0.0f ? static_cast<uint32_t>(fminf(ceilf(p * 16777216.0f), 16777216.0f)) : 0u;
}

// Task k of the CTA (blockIdx.z the realization, blockIdx.x its set of
// `per` consecutive tasks): its index b, t = w / G by multiply-shift and
// its two systems' row offsets through sid.
__device__ __forceinline__ int task_rows(OvTasks& sh, const OvWalk& g,
                                         const int32_t* __restrict__ sid,
                                         const int32_t* __restrict__ tasks, int k) {
  const int w = blockIdx.x * g.per + k;  // the task's index in its realization
  const int b = blockIdx.z * g.T * g.G + w;
  const int t = fast_div(w, g.m[2], g.s[2]);
  const long long row = static_cast<long long>(blockIdx.z) * g.S;
  const int32_t* sd = sid + row;
  sh.ra[k] = (row + sd[tasks[2 * b] * g.T + t]) * g.n;
  sh.rb[k] = (row + sd[tasks[2 * b + 1] * g.T + t]) * g.n;
  sh.t[k] = t;
  return b;
}

// Thread k < per fills task k's entry: its rows, its key words and the
// unit coupling's threshold.
__device__ __forceinline__ void load_tasks(OvTasks& sh, const OvWalk& g,
                                           const int32_t* __restrict__ sid,
                                           const int32_t* __restrict__ tasks,
                                           const float* __restrict__ temps,
                                           const int32_t* __restrict__ keys, int which) {
  const int k = threadIdx.x;
  if (k >= g.per) return;
  const int b = task_rows(sh, g, sid, tasks, k);
  sh.k0[k] = static_cast<uint32_t>(keys[2 * b]);
  sh.k1[k] = static_cast<uint32_t>(keys[2 * b + 1]);
  sh.thr[k] = threshold24(bond_prob(which, 1.0f / temps[sh.t[k]]));
}

// The coordinates of site i: its position along the fast axis, its line's
// along the inner slow axis (cb) and, in 3D, the outer one (ca), by
// multiply-shift.
struct SiteAt {
  int i;
  int pos;
  int cb;
  int ca;
};

template <int ND>
__device__ __forceinline__ SiteAt site_at(const OvWalk& g, int i) {
  SiteAt c;
  c.i = i;
  const int line = fast_div(i, g.m[0], g.s[0]);
  c.pos = i - line * g.lf;
  c.ca = ND != 2 ? fast_div(line, g.m[1], g.s[1]) : 0;  // 2D tables: la = 1
  c.cb = line - c.ca * g.lb;
  return c;
}

// The forward (back = false) or backward neighbour of a site along bond
// direction dir (ND - 1 the fast axis, ND - 2 the inner slow one, 0 in 3D
// the outer one; kTable: offset dir's residues): one compare an axis.
template <int ND>
__device__ __forceinline__ int site_step(const OvWalk& g, const SiteAt& c, int dir, bool back) {
  if constexpr (ND == kTable) {
    const OvOffset& o = g.off[dir];
    int pos, cb, ca;
    if (back) {
      pos = c.pos - o.rf;
      cb = c.cb - o.rb;
      ca = c.ca - o.ra;
      if (pos < 0) pos += g.lf;
      if (cb < 0) cb += g.lb;
      if (ca < 0) ca += g.la;
    } else {
      pos = c.pos + o.rf;
      cb = c.cb + o.rb;
      ca = c.ca + o.ra;
      if (pos >= g.lf) pos -= g.lf;
      if (cb >= g.lb) cb -= g.lb;
      if (ca >= g.la) ca -= g.la;
    }
    return (ca * g.lb + cb) * g.lf + pos;
  }
  if (dir == ND - 1) {
    if (back) return c.pos > 0 ? c.i - 1 : c.i - 1 + g.lf;
    return c.pos + 1 < g.lf ? c.i + 1 : c.i + 1 - g.lf;
  }
  const int step = dir == ND - 2 ? g.lf : g.lb * g.lf;
  const int ext = dir == ND - 2 ? g.lb : g.la;
  const int at = dir == ND - 2 ? c.cb : c.ca;
  if (back) return at > 0 ? c.i - step : c.i - step + ext * step;
  return at + 1 < ext ? c.i + step : c.i + step - ext * step;
}

// A group of four sites i0 .. i0+3 (the Philox counter's site / 4): where
// `kVec`, its words (4-byte word k = i0 / 4 of a row) and each direction's
// forward and backward neighbour words, found once: the fast axis' next
// (previous) word, wrapping at the line's end (start), the same word of
// the next (previous) line and plane; in the table's form each offset's
// forward words, the word of the line its slower components reach q words
// on (w1) and the one after it (w2), wrapping in the line, whose bytes b..
// and ..b are the neighbours (the backward words are found where they are
// read: nonsingleton_words); else each site's neighbours.
template <int ND, bool kVec>
struct Group {
  int i0;
  int cnt;   // the group's sites below n
  int k;     // its word
  int kf;    // the fast axis' next word, the inner and outer axes' words
  int kb;
  int ka;
  int pf;    // the same backwards
  int pb;
  int pa;
  int w1[ND == kTable ? kMaxDirs : 1];
  int w2[ND == kTable ? kMaxDirs : 1];
  SiteAt c[kVec ? 1 : 4];
};

template <int ND, bool kVec>
__device__ __forceinline__ Group<ND, kVec> group_at(const OvWalk& g, int grp) {
  Group<ND, kVec> x;
  x.i0 = 4 * grp;
  x.cnt = min(4, g.n - x.i0);
  if constexpr (kVec && ND == kTable) {
    const SiteAt c = site_at<ND>(g, x.i0);
    const int wpl = g.lf >> 2;
    const int pw = c.pos >> 2;
    x.k = grp;
#pragma unroll
    for (int d = 0; d < kMaxDirs; ++d) {
      if (d >= g.nb) break;
      const OvOffset& o = g.off[d];
      int cb = c.cb + o.rb;
      int ca = c.ca + o.ra;
      int p1 = pw + o.q;
      if (cb >= g.lb) cb -= g.lb;
      if (ca >= g.la) ca -= g.la;
      if (p1 >= wpl) p1 -= wpl;
      const int row = (ca * g.lb + cb) * wpl;
      x.w1[d] = row + p1;
      x.w2[d] = row + (p1 + 1 < wpl ? p1 + 1 : 0);
    }
    x.c[0] = c;
  } else if constexpr (kVec) {
    const SiteAt c = site_at<ND>(g, x.i0);
    const int wpl = g.lf >> 2;
    const int plane = g.lb * wpl;
    const int nw = g.n >> 2;
    x.k = grp;
    x.kf = c.pos + 4 < g.lf ? grp + 1 : grp + 1 - wpl;
    x.pf = c.pos > 0 ? grp - 1 : grp - 1 + wpl;
    x.kb = c.cb + 1 < g.lb ? grp + wpl : grp + wpl - plane;
    x.pb = c.cb > 0 ? grp - wpl : grp - wpl + plane;
    x.ka = ND == 3 ? (c.ca + 1 < g.la ? grp + plane : grp + plane - nw) : 0;
    x.pa = ND == 3 ? (c.ca > 0 ? grp - plane : grp - plane + nw) : 0;
    x.c[0] = c;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) x.c[q] = site_at<ND>(g, q < x.cnt ? x.i0 + q : x.i0);
  }
  return x;
}

// A system's words at the group: byte q of w is site i0 + q, byte q of
// f[dir] its forward neighbour along dir (bytes past n: 0; a table's
// directions past nb: unset).
template <int ND>
struct Words {
  uint32_t w;
  uint32_t f[Form<ND>::kDirs];
};

template <int ND, bool kVec>
__device__ __forceinline__ Words<ND> load_words(const int8_t* __restrict__ s,
                                                const Group<ND, kVec>& x, const OvWalk& g) {
  constexpr int D = Form<ND>::kDirs;
  Words<ND> o;
  if constexpr (kVec && ND == kTable) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(s);
    o.w = __ldg(p + x.k);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d >= g.nb) break;
      const uint32_t lo = __ldg(p + x.w1[d]);
      const int b = g.off[d].b;
      o.f[d] = b ? __funnelshift_r(lo, __ldg(p + x.w2[d]), 8 * b) : lo;
    }
  } else if constexpr (kVec) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(s);
    o.w = __ldg(p + x.k);
    o.f[ND - 1] = __funnelshift_r(o.w, __ldg(p + x.kf), 8);
    o.f[ND - 2] = __ldg(p + x.kb);
    if (ND == 3) o.f[0] = __ldg(p + x.ka);
  } else {
    o.w = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) o.f[d] = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= x.cnt) break;
      o.w |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(s + x.c[q].i))) << (8 * q);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (ND == kTable && d >= g.nb) break;
        o.f[d] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      __ldg(s + site_step<ND>(g, x.c[q], d, false)))) << (8 * q);
      }
    }
  }
  return o;
}

// Bit 0 of byte q: whether the bytes q of u and v differ in sign (spins
// are +1 = 0x01 and -1 = 0xff).
__device__ __forceinline__ uint32_t differ(uint32_t u, uint32_t v) {
  return ((u ^ v) >> 7) & kLow;
}

// The group's couplings (4 nd floats, contiguous in [d, n, nd]), read once
// for the thread's tasks: nd float4 loads where kVec; which are of unit
// magnitude (bit q nd + dir).  The table's form reads its 4 nb floats one
// at a time into jc[q kMaxDirs + dir] (0 past nb), its index known at
// compile time.
template <int ND, bool kVec>
__device__ __forceinline__ uint32_t load_couplings(const float* __restrict__ J, int i0, int cnt,
                                                   int nb, float (&jc)[4 * Form<ND>::kDirs]) {
  constexpr int D = Form<ND>::kDirs;
  if constexpr (ND == kTable) {
#pragma unroll
    for (int v = 0; v < 4 * D; ++v)
      jc[v] = v % D < nb && v / D < cnt ? __ldg(J + static_cast<size_t>(i0 + v / D) * nb + v % D)
                                        : 0.0f;
  } else if constexpr (kVec) {
    const float4* p = reinterpret_cast<const float4*>(J + static_cast<size_t>(i0) * ND);
#pragma unroll
    for (int u = 0; u < ND; ++u) {
      const float4 v = __ldg(p + u);
      jc[4 * u] = v.x;
      jc[4 * u + 1] = v.y;
      jc[4 * u + 2] = v.z;
      jc[4 * u + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < 4 * ND; ++v)
      jc[v] = v / ND < cnt ? __ldg(J + static_cast<size_t>(i0) * ND + v) : 0.0f;
  }
  uint32_t unit = 0;
#pragma unroll
  for (int v = 0; v < 4 * D; ++v)
    if (fabsf(jc[v]) == 1.0f) unit |= 1u << v;
  return unit;
}

// The bits of load_couplings' unit word that hold a bond: all 4 nd, or the
// table's first nb of each site's kMaxDirs.
template <int ND>
__device__ __forceinline__ uint32_t bond_bits(int nb) {
  if constexpr (ND == kTable) {
    const uint32_t m = (1u << nb) - 1u;
    return m | m << kMaxDirs | m << (2 * kMaxDirs) | m << (3 * kMaxDirs);
  }
  return (1u << (4 * ND)) - 1u;
}

// J/T of a (realization, temperature), taken once for the thread's tasks
// at that temperature: jt = J / T (the first design's f32 division), its
// sign as byte masks (pos, neg: bit 0 of byte q where jt of site q is > 0,
// < 0), and each bond's draw as a 24-bit threshold (threshold24 of its
// probability; a group whose 4 nd couplings are all unit, as on +-J, takes
// the task's one threshold and draws no exp).  The probabilities are drawn
// here, whether their bonds can be active or not: drawn lazily, where a
// bond can be active, the branches and registers cost more than the exps
// they skip on gaussian couplings (tools/probe_overlap.py n-lazy).
template <int ND>
struct JT {
  float jt[4 * Form<ND>::kDirs];
  uint32_t thr[4 * Form<ND>::kDirs];
  uint32_t pos[Form<ND>::kDirs];
  uint32_t neg[Form<ND>::kDirs];
};

// (bits: bond_bits, the table's entries with a bond; no exp for the rest)
template <int ND>
__device__ __forceinline__ void take_jt(JT<ND>& x, const float (&jc)[4 * Form<ND>::kDirs],
                                        float T, uint32_t unit, uint32_t bits, int which,
                                        uint32_t thr_unit) {
  constexpr int D = Form<ND>::kDirs;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x.pos[d] = 0;
    x.neg[d] = 0;
  }
#pragma unroll
  for (int v = 0; v < 4 * D; ++v) {
    x.jt[v] = jc[v] / T;
    if (x.jt[v] > 0.0f) x.pos[v % D] |= 1u << (8 * (v / D));
    if (x.jt[v] < 0.0f) x.neg[v % D] |= 1u << (8 * (v / D));
  }
  if (unit == bits) {
#pragma unroll
    for (int v = 0; v < 4 * D; ++v) x.thr[v] = thr_unit;
  } else {
#pragma unroll
    for (int v = 0; v < 4 * D; ++v)
      x.thr[v] = ND == kTable && !((bits >> v) & 1u) ? 0u
                                                      : threshold24(bond_prob(which, x.jt[v]));
  }
}

// The satisfied bonds (bit 0 of byte q) of direction dir where the spins
// differ as dd: (s s_f) jt > 0 is jt's sign flipped where they differ.
template <int ND>
__device__ __forceinline__ uint32_t satisfied(const JT<ND>& x, int dir, uint32_t dd) {
  return (dd & x.neg[dir]) | (~dd & x.pos[dir]);
}

// The bonds of direction dir among the candidates cand (bit 0 of byte q):
// the uniform of site q is word q of Philox keyed by (k0, k1), counter
// (first + dir, group, 0, 0), drawn only where a candidate is, and its
// bond u >> 8 < the bond's threshold.
template <int ND>
__device__ __forceinline__ uint32_t draw(const JT<ND>& x, uint32_t cand, int dir, uint32_t k0,
                                         uint32_t k1, int first, int grp) {
  if (!cand) return 0;
  const uint4 r = philox4x32_10(k0, k1, static_cast<uint32_t>(first + dir),
                                static_cast<uint32_t>(grp), 0u, 0u);
  const uint32_t uw[4] = {r.x, r.y, r.z, r.w};
  uint32_t on = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if ((uw[q] >> 8) < x.thr[q * Form<ND>::kDirs + dir]) on |= 1u << (8 * q);
  return on & cand;
}

// Joerg's and CMR's bonds (csrc/overlap.cu's first design drew them a
// thread a group of one task, fwd_site's runtime divisions for each
// neighbour, byte loads, the couplings, J / T and exp again for every task
// and bond, a serial Wolff seed and a dead parent written a site).  A
// thread takes the group of four sites 4 grp .. 4 grp + 3 (blockIdx.y the
// groups' block of kThreads, strided) of `per` consecutive tasks of one
// realization (blockIdx.z; blockIdx.x the set): the group's coordinates
// and neighbour words found once, its couplings read once, J / T and the
// bond probabilities taken once a temperature, and for each task its
// systems' words, each bond's satisfaction a sign flip of jt, and a Philox
// block only where a bond can be active (Joerg: satisfied in a, both ends
// active; CMR blue: satisfied in both), each draw one integer compare with
// the bond's threshold; the state bytes one 4-byte store.  The seeds:
// Joerg Wolff's first active probe by one warp and two ballots a task,
// CMR's drawn one, n for Joerg SW.  Where !kVec (a fast extent not a multiple of 4, or unaligned
// pointers) each site's neighbours come from its coordinates and the words
// are gathered a byte at a time.
template <int ND, int kKind, bool kVec>
__global__ void __launch_bounds__(kThreads)
ov_bonds_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                const int32_t* __restrict__ tasks, const float* __restrict__ coup,
                const float* __restrict__ temps, const int32_t* __restrict__ scal,
                const int32_t* __restrict__ probes, const int32_t* __restrict__ keys,
                uint8_t* __restrict__ state, int32_t* __restrict__ seeds, const OvWalk g,
                int wolff) {
  __shared__ OvTasks sh;
  load_tasks(sh, g, sid, tasks, temps, keys, kKind == kJorg ? kProbJorg : kProbBlue);
  __syncthreads();
  const int b0 = blockIdx.z * g.T * g.G + blockIdx.x * g.per;
  if (blockIdx.y == 0) {
    if (kKind == kJorg && wolff) {
      if (threadIdx.x < 32) {
        // the first warp tests a task's 64 probes at once, lane l probes
        // l and 32 + l; the seed is the first active one in probe order
        const int l = threadIdx.x;
        for (int k = 0; k < g.per; ++k) {
          const int32_t* pr = probes + kProbes * (b0 + k);
          const int8_t* A = spins + sh.ra[k];
          const int8_t* B = spins + sh.rb[k];
          const int p0 = pr[l];
          const int p1 = pr[32 + l];
          const unsigned lo = __ballot_sync(0xffffffffu, A[p0] != B[p0]);
          const unsigned hi = __ballot_sync(0xffffffffu, A[p1] != B[p1]);
          if (l == 0)
            seeds[b0 + k] = lo ? pr[__ffs(lo) - 1] : hi ? pr[32 + __ffs(hi) - 1] : g.n;
        }
      }
    } else if (threadIdx.x < g.per) {
      const int b = b0 + threadIdx.x;
      seeds[b] = kKind == kCmr ? scal[6 * b + 4] : g.n;
    }
  }
  constexpr int D = Form<ND>::kDirs;
  const int nb = dirs<ND>(g);
  const uint32_t bits = bond_bits<ND>(nb);
  const int n_grp = (g.n + 3) >> 2;
  const float* J = coup + static_cast<size_t>(blockIdx.z) * g.n * nb;
  for (int grp = blockIdx.y * kThreads + threadIdx.x; grp < n_grp;
       grp += gridDim.y * kThreads) {
    const Group<ND, kVec> x = group_at<ND, kVec>(g, grp);
    float jc[4 * D];
    const uint32_t unit = load_couplings<ND, kVec>(J, x.i0, x.cnt, nb, jc);
    JT<ND> jt;
    int tp = -1;
    for (int k = 0; k < g.per; ++k) {
      const int t = sh.t[k];
      if (t != tp) {
        tp = t;
        take_jt<ND>(jt, jc, __ldg(temps + t), unit, bits,
                    kKind == kJorg ? kProbJorg : kProbBlue, sh.thr[k]);
      }
      const Words<ND> a = load_words<ND, kVec>(spins + sh.ra[k], x, g);
      const Words<ND> b = load_words<ND, kVec>(spins + sh.rb[k], x, g);
      const uint32_t act = differ(a.w, b.w);  // Joerg: a != b
      uint32_t st = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (ND == kTable && d >= nb) break;
        uint32_t cand = satisfied<ND>(jt, d, differ(a.w, a.f[d]));
        if (kKind == kJorg)
          cand &= act & differ(a.f[d], b.f[d]);
        else
          cand &= satisfied<ND>(jt, d, differ(b.w, b.f[d]));
        st |= draw<ND>(jt, cand, d, sh.k0[k], sh.k1[k], 0, grp) << d;
      }
      uint8_t* out = state + static_cast<size_t>(b0 + k) * g.n;
      if (kVec) {
        reinterpret_cast<uint32_t*>(out)[grp] = st;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < x.cnt) out[x.i0 + q] = static_cast<uint8_t>(st >> (8 * q));
      }
    }
  }
}

// A group's state-byte word and its sites' flat parents (fk_link leaves
// each parent at its root): one 4-byte and one 16-byte load where kVec;
// sites past n hold state 0 and parent -1.
template <int ND, bool kVec>
__device__ __forceinline__ uint32_t load_roots(const uint8_t* __restrict__ S,
                                               const int32_t* __restrict__ P,
                                               const Group<ND, kVec>& x, int (&lab)[4]) {
  uint32_t st = 0;
  if (kVec) {
    st = __ldg(reinterpret_cast<const uint32_t*>(S) + x.k);
    const int4 p = __ldg(reinterpret_cast<const int4*>(P) + x.k);
    lab[0] = p.x;
    lab[1] = p.y;
    lab[2] = p.z;
    lab[3] = p.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lab[q] = q < x.cnt ? __ldg(P + x.i0 + q) : -1;
      if (q < x.cnt) st |= static_cast<uint32_t>(__ldg(S + x.i0 + q)) << (8 * q);
    }
  }
  return st;
}

// Bit 0 of byte q where site q's root is r.
__device__ __forceinline__ uint32_t same_root(const int (&lab)[4], int r) {
  uint32_t f = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (lab[q] == r) f |= 1u << (8 * q);
  return f;
}

// Bit 0 of byte q where the coin of site q's root lab[q] falls below 1/2
// (salted_uniform(root, s0, s1), SW), for the group's cnt sites.
__device__ __forceinline__ uint32_t half_coins(const int (&lab)[4], int cnt, uint32_t s0,
                                               uint32_t s1) {
  uint32_t coin = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= cnt) break;
    if (salted_uniform(static_cast<uint32_t>(lab[q]), s0, s1) < 0.5f) coin |= 1u << (8 * q);
  }
  return coin;
}

// Bit 0 of byte q where site q has a bond (bits 0 .. ND-1 of the state
// bytes S; st the group's word, lab its roots): its own forward bonds, a
// root other than itself, or else a backward neighbour's forward bond
// towards it.  The backward words (the fast axis' previous word shifted a
// byte in, the same word of the previous line and plane) are read only
// where `need` (bit 0 of byte q) asks about a root with no forward bond.
template <int ND, bool kVec>
__device__ __forceinline__ uint32_t nonsingleton_words(const uint8_t* __restrict__ S,
                                                       uint32_t st, const int (&lab)[4],
                                                       uint32_t need, const Group<ND, kVec>& x,
                                                       const OvWalk& g) {
  uint32_t root = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= x.cnt) break;
    if (lab[q] == x.i0 + q) root |= 1u << (8 * q);
  }
  constexpr int D = Form<ND>::kDirs;
  uint32_t any = ~root & kLow;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (ND == kTable && d >= g.nb) break;
    any |= (st >> d) & kLow;
  }
  if (need & ~any) {
    uint32_t bw[D];
    if constexpr (kVec && ND == kTable) {
      // offset d's backward neighbours: the line its slower components
      // reach backwards, q words back (P), bytes ..b of word P - 1 and b..
      // of word P, wrapping in the line
      const uint32_t* sw = reinterpret_cast<const uint32_t*>(S);
      const SiteAt& c = x.c[0];
      const int wpl = g.lf >> 2;
      const int pw = c.pos >> 2;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d >= g.nb) break;
        const OvOffset& o = g.off[d];
        int cb = c.cb - o.rb;
        int ca = c.ca - o.ra;
        int p = pw - o.q;
        if (cb < 0) cb += g.lb;
        if (ca < 0) ca += g.la;
        if (p < 0) p += wpl;
        const int row = (ca * g.lb + cb) * wpl;
        const uint32_t hi = __ldg(sw + row + p);
        bw[d] = o.b ? __funnelshift_l(__ldg(sw + row + (p > 0 ? p - 1 : wpl - 1)), hi, 8 * o.b)
                    : hi;
      }
    } else if constexpr (kVec) {
      const uint32_t* sw = reinterpret_cast<const uint32_t*>(S);
      bw[ND - 1] = __funnelshift_l(__ldg(sw + x.pf), st, 8);
      bw[ND - 2] = __ldg(sw + x.pb);
      if (ND == 3) bw[0] = __ldg(sw + x.pa);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (ND == kTable && d >= g.nb) break;
        bw[d] = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < x.cnt)
            bw[d] |= static_cast<uint32_t>(__ldg(S + site_step<ND>(g, x.c[q], d, true)))
                     << (8 * q);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (ND == kTable && d >= g.nb) break;
      any |= (bw[d] >> d) & kLow;
    }
  }
  return any;
}

// CMR's grey bonds after the blue flip (the first design decided each blue
// flip 1 + nd times a site, by find_root and, in SW, a salted coin and
// nonsingleton's backward neighbours found by division, wrote a dead
// parent2, and drew exp, J / T and the spins as ov_bonds' first design
// did).  The flip of a blue cluster flips both replicas, so s s_f of a
// bond changes sign in a and b together: a bond is satisfied in one
// replica only (sat_a != sat_b) after the flip iff it was before, iff a_i
// a_f != b_i b_f and jt is neither +-0 nor NaN.  So the grey bonds need no
// neighbour's flip, and each site's blue flip is decided once, for bit 7
// of its own state2 byte: Wolff, its flat parent (fk_link leaves each
// parent at its root) against the seed's, which one thread loads a task;
// SW, the salted coin on that root and nonsingleton (a site whose root is
// another site has a bond; a root's own bonds, then its backward
// neighbours' state bytes, read as words only where the coin falls below
// 1/2 on a root with no forward bond: nonsingleton_words).  The parents
// are the blue labels themselves where the caller asks for them (fk_link
// labels into its buffer).  The mapping, the couplings, J / T, the words and the
// draws are ov_bonds' (counter n_dirs + dir), a grey bond the blue one or
// (sat_a != sat_b and u < 1 - r); one 4-byte store of the state2 bytes.
template <int ND, bool kWolff, bool kVec>
__global__ void __launch_bounds__(kThreads)
ov_mid_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
              const int32_t* __restrict__ tasks, const float* __restrict__ coup,
              const float* __restrict__ temps, const int32_t* __restrict__ scal,
              const int32_t* __restrict__ keys, const uint8_t* __restrict__ state,
              const int32_t* __restrict__ parent, uint8_t* __restrict__ state2,
              const OvWalk g) {
  __shared__ OvTasks sh;
  load_tasks(sh, g, sid, tasks, temps, keys, kProbGrey);
  if (threadIdx.x < g.per) {
    const int b = blockIdx.z * g.T * g.G + blockIdx.x * g.per + threadIdx.x;
    sh.s0[threadIdx.x] = static_cast<uint32_t>(scal[6 * b]);
    sh.s1[threadIdx.x] = static_cast<uint32_t>(scal[6 * b + 1]);
    if (kWolff)
      sh.root[threadIdx.x] = __ldg(parent + static_cast<size_t>(b) * g.n + scal[6 * b + 4]);
  }
  __syncthreads();
  constexpr int D = Form<ND>::kDirs;
  const int nb = dirs<ND>(g);
  const uint32_t bits = bond_bits<ND>(nb);
  const int b0 = blockIdx.z * g.T * g.G + blockIdx.x * g.per;
  const int n_grp = (g.n + 3) >> 2;
  const float* J = coup + static_cast<size_t>(blockIdx.z) * g.n * nb;
  for (int grp = blockIdx.y * kThreads + threadIdx.x; grp < n_grp;
       grp += gridDim.y * kThreads) {
    const Group<ND, kVec> x = group_at<ND, kVec>(g, grp);
    float jc[4 * D];
    const uint32_t unit = load_couplings<ND, kVec>(J, x.i0, x.cnt, nb, jc);
    JT<ND> jt;
    int tp = -1;
    for (int k = 0; k < g.per; ++k) {
      const int t = sh.t[k];
      if (t != tp) {
        tp = t;
        take_jt<ND>(jt, jc, __ldg(temps + t), unit, bits, kProbGrey, sh.thr[k]);
      }
      const size_t base = static_cast<size_t>(b0 + k) * g.n;
      const uint8_t* S = state + base;
      const int32_t* P = parent + base;
      // the blue bonds and roots of the group's sites
      int lab[4];
      const uint32_t st = load_roots<ND, kVec>(S, P, x, lab);
      uint32_t fl = 0;  // bit 0 of byte q: site q's blue flip
      if (kWolff) {
        fl = same_root(lab, sh.root[k]);
      } else {
        const uint32_t coin = half_coins(lab, x.cnt, sh.s0[k], sh.s1[k]);
        fl = coin & nonsingleton_words<ND, kVec>(S, st, lab, coin, x, g);
      }
      const Words<ND> a = load_words<ND, kVec>(spins + sh.ra[k], x, g);
      const Words<ND> b = load_words<ND, kVec>(spins + sh.rb[k], x, g);
      uint32_t out = fl << 7;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (ND == kTable && d >= nb) break;
        const uint32_t blue = (st >> d) & kLow;
        const uint32_t cand = differ(a.w ^ a.f[d], b.w ^ b.f[d]) & (jt.pos[d] | jt.neg[d]) &
                              ~blue;
        out |= (blue | draw<ND>(jt, cand, d, sh.k0[k], sh.k1[k], nb, grp)) << d;
      }
      uint8_t* o = state2 + base;
      if (kVec) {
        reinterpret_cast<uint32_t*>(o)[grp] = out;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < x.cnt) o[x.i0 + q] = static_cast<uint8_t>(out >> (8 * q));
      }
    }
  }
}

// The flips of a Joerg or CMR move (the first design: a thread a site,
// task_of's runtime divisions and tasks -> sid loads in every thread,
// find_root on parents fk_link has already flattened, for Wolff also on
// the seed in every thread, nonsingleton's backward neighbours found by
// division, byte loads and stores of the spins, and in observe form a
// launch that only copied the parents into the labels).  ov_bonds' walk: a
// thread takes the group of four sites 4 grp .. 4 grp + 3 of `per`
// consecutive tasks of one realization, each task's two rows, its salts
// (Joerg s0, s1; CMR s2, s3), CMR's k and the Wolff seed's root (one load
// of parent[b n + seed] a task, none where Joerg's seed is n: no flip)
// staged once a CTA.  state / parent are Joerg's bonds and fk_link's flat
// parents of them, or CMR's state2 bytes (bit 7: the blue flip) and the
// grey graph's flat parents: each group's roots one int4 load; Wolff flips
// the seed's component, SW each non-singleton (nonsingleton_words) whose
// coin falls below 1/2 (Joerg) or whose k = floor(4 salted_uniform(root,
// s2, s3)) is not 0 (CMR).  Each system's word is one 4-byte load and one
// store: a +-1 byte negated is the byte xor 0xFE, so the word xor f 0xFE
// (f: bit 0 of byte q where site q flips) flips it with no carry across
// bytes; CMR's a flips blue ^ (in & k & 1), b blue ^ (in & k & 2).  Each
// system belongs to one task of a move, so no two threads write one word.
// Where !kVec (a fast extent not a multiple of 4, or unaligned pointers)
// the per-site path gathers bytes, as ov_bonds'.
template <int ND, int kKind, bool kWolff, bool kVec>
__global__ void __launch_bounds__(kThreads)
ov_finish_kernel(int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                 const int32_t* __restrict__ tasks, const int32_t* __restrict__ scal,
                 const int32_t* __restrict__ seeds, const uint8_t* __restrict__ state,
                 const int32_t* __restrict__ parent, const OvWalk g) {
  __shared__ OvTasks sh;
  if (threadIdx.x < g.per) {
    const int k = threadIdx.x;
    const int b = task_rows(sh, g, sid, tasks, k);
    const int32_t* sc = scal + 6 * b;
    sh.s0[k] = static_cast<uint32_t>(sc[kKind == kJorg ? 0 : 2]);
    sh.s1[k] = static_cast<uint32_t>(sc[kKind == kJorg ? 1 : 3]);
    sh.k[k] = sc[5];
    if (kWolff) {
      const int seed = seeds[b];
      sh.root[k] = seed < g.n ? __ldg(parent + static_cast<size_t>(b) * g.n + seed) : -1;
    }
  }
  __syncthreads();
  const int b0 = blockIdx.z * g.T * g.G + blockIdx.x * g.per;
  const int n_grp = (g.n + 3) >> 2;
  for (int grp = blockIdx.y * kThreads + threadIdx.x; grp < n_grp;
       grp += gridDim.y * kThreads) {
    const Group<ND, kVec> x = group_at<ND, kVec>(g, grp);
    for (int k = 0; k < g.per; ++k) {
      const size_t base = static_cast<size_t>(b0 + k) * g.n;
      const uint8_t* S = state + base;
      int lab[4];
      const uint32_t st = load_roots<ND, kVec>(S, parent + base, x, lab);
      uint32_t fa, fb;  // bit 0 of byte q: site q flips in a, in b
      if (kWolff) {
        const uint32_t in = same_root(lab, sh.root[k]);
        fa = kKind == kJorg || (sh.k[k] & 1) ? in : 0u;
        fb = kKind == kJorg || (sh.k[k] & 2) ? in : 0u;
      } else {
        uint32_t ka = 0, kb = 0;  // the coin's flips of a and b
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= x.cnt) break;
          const float u = salted_uniform(static_cast<uint32_t>(lab[q]), sh.s0[k], sh.s1[k]);
          const int kq = kKind == kJorg ? (u < 0.5f ? 3 : 0) : static_cast<int>(u * 4.0f);
          ka |= static_cast<uint32_t>(kq & 1) << (8 * q);
          kb |= static_cast<uint32_t>((kq >> 1) & 1) << (8 * q);
        }
        const uint32_t in = nonsingleton_words<ND, kVec>(S, st, lab, ka | kb, x, g);
        fa = ka & in;
        fb = kb & in;
      }
      if (kKind == kCmr) {
        const uint32_t blue = (st >> 7) & kLow;
        fa ^= blue;
        fb ^= blue;
      }
      int8_t* A = spins + sh.ra[k];
      int8_t* B = spins + sh.rb[k];
      if (kVec) {
        uint32_t* aw = reinterpret_cast<uint32_t*>(A) + grp;
        uint32_t* bw = reinterpret_cast<uint32_t*>(B) + grp;
        if (fa) *aw ^= fa * 0xFEu;
        if (fb) *bw ^= fb * 0xFEu;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= x.cnt) break;
          A[x.i0 + q] ^= static_cast<int8_t>(((fa >> (8 * q)) & 1u) * 0xFEu);
          B[x.i0 + q] ^= static_cast<int8_t>(((fb >> (8 * q)) & 1u) * 0xFEu);
        }
      }
    }
  }
}

// The CTA's member slots, staged once in shared memory by houdn_bonds and
// houdn_finish: rows[k gs + r] = sid[z S + tasks[(b0 + k) gs + r] T + t],
// member r of the CTA's task k (b0 its first task, z = blockIdx.z its
// realization), t = w / G by multiply-shift.
__device__ __forceinline__ void stage_members(uint16_t* rows, const int32_t* __restrict__ sid,
                                              const int32_t* __restrict__ tasks, int gs,
                                              const OvWalk& g) {
  const int b0 = blockIdx.z * g.T * g.G + blockIdx.x * g.per;
  const long long row0 = static_cast<long long>(blockIdx.z) * g.S;
  for (int k = 0; k < g.per; ++k) {
    const int t = fast_div(blockIdx.x * g.per + k, g.m[2], g.s[2]);
    const int32_t* tk = tasks + static_cast<size_t>(b0 + k) * gs;
    for (int r = threadIdx.x; r < gs; r += kThreads)
      rows[k * gs + r] = static_cast<uint16_t>(__ldg(sid + row0 + __ldg(tk + r) * g.T + t));
  }
}

// Bit 0 of byte q of act[0] where site i0 + q of the group is balanced
// (its g members' spins sum to 0: g / 2 of them are -1, whose bytes have
// bit 7 set), of act[1 + d] where its forward neighbour along d is.  Each
// member's words (load_words) add their sign bits into per-byte counts,
// compared with g / 2 by __vcmpeq4: no byte overflows while g <= 254; a
// larger g counts in 16-bit lanes (bytes 0 and 2, then 1 and 3).  rows:
// the task's g member slots of realization z (row0 = z S).
template <int ND, bool kVec>
__device__ __forceinline__ void balanced_words(const int8_t* __restrict__ spins, long long row0,
                                               const uint16_t* rows, int gs,
                                               const Group<ND, kVec>& x, const OvWalk& g,
                                               uint32_t (&act)[Form<ND>::kDirs + 1]) {
  constexpr int D = Form<ND>::kDirs;
  const int nb = dirs<ND>(g);
  if (gs <= 254) {
    uint32_t c[D + 1] = {};
    for (int r = 0; r < gs; ++r) {
      const Words<ND> m = load_words<ND, kVec>(spins + (row0 + rows[r]) * g.n, x, g);
      c[0] += (m.w >> 7) & kLow;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (ND == kTable && d >= nb) break;
        c[1 + d] += (m.f[d] >> 7) & kLow;
      }
    }
    const uint32_t h = static_cast<uint32_t>(gs >> 1) * kLow;
#pragma unroll
    for (int j = 0; j <= D; ++j) act[j] = __vcmpeq4(c[j], h) & kLow;
  } else {
    constexpr uint32_t kLow2 = 0x00010001u;
    uint32_t lo[D + 1] = {}, hi[D + 1] = {};
    for (int r = 0; r < gs; ++r) {
      const Words<ND> m = load_words<ND, kVec>(spins + (row0 + rows[r]) * g.n, x, g);
      lo[0] += (m.w >> 7) & kLow2;
      hi[0] += (m.w >> 15) & kLow2;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (ND == kTable && d >= nb) break;
        lo[1 + d] += (m.f[d] >> 7) & kLow2;
        hi[1 + d] += (m.f[d] >> 15) & kLow2;
      }
    }
    const uint32_t h = static_cast<uint32_t>(gs >> 1) * kLow2;
#pragma unroll
    for (int j = 0; j <= D; ++j)
      act[j] = (__vcmpeq2(lo[j], h) & kLow2) | ((__vcmpeq2(hi[j], h) & kLow2) << 8);
  }
}

// Houdayer(N)'s bonds (the first design: a thread four sites of one task,
// each site's 1 + nd balance tests a chain of tasks -> sid -> spin loads
// per member, fwd_site's two runtime divisions a neighbour, a dead parent
// written a site).  ov_bonds' walk (blockIdx.z the realization, x its set
// of `per` consecutive tasks of G groups, y the groups' block, strided):
// the CTA stages each task's g member slots in dynamic shared memory once
// (stage_members: per g entries), and a thread takes the
// group of four sites 4 grp .. 4 grp + 3 of each task: balanced_words over
// the members' 4-byte words and division-free neighbour words, bond d =
// act & act_f[d], the state bytes one 4-byte store; no parent (fk_link
// writes every parent).  The Wolff seed: the first warp of the groups'
// first block takes each task in turn, lane l testing probes l and 32 + l
// over the staged rows, two ballots choosing the first balanced probe in
// probe order (n when none is, and for SW).  Where !kVec each site's
// neighbours come from its coordinates and the words are gathered a byte
// at a time.
template <int ND, bool kVec>
__global__ void __launch_bounds__(kThreads)
houdn_bonds_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                   const int32_t* __restrict__ tasks, const int32_t* __restrict__ probes,
                   uint8_t* __restrict__ state, int32_t* __restrict__ seeds, const OvWalk g,
                   int gs, int wolff) {
  extern __shared__ uint16_t houdn_rows[];
  stage_members(houdn_rows, sid, tasks, gs, g);
  __syncthreads();
  const int b0 = blockIdx.z * g.T * g.G + blockIdx.x * g.per;
  const long long row0 = static_cast<long long>(blockIdx.z) * g.S;
  if (blockIdx.y == 0) {
    if (wolff) {
      if (threadIdx.x < 32) {
        const int l = threadIdx.x;
        for (int k = 0; k < g.per; ++k) {
          const int32_t* pr = probes + kProbes * (b0 + k);
          const int p0 = __ldg(pr + l);
          const int p1 = __ldg(pr + 32 + l);
          int s0 = 0, s1 = 0;
          for (int r = 0; r < gs; ++r) {
            const int8_t* m = spins + (row0 + houdn_rows[k * gs + r]) * g.n;
            s0 += __ldg(m + p0);
            s1 += __ldg(m + p1);
          }
          const unsigned lo = __ballot_sync(0xffffffffu, s0 == 0);
          const unsigned hi = __ballot_sync(0xffffffffu, s1 == 0);
          if (l == 0)
            seeds[b0 + k] = lo ? pr[__ffs(lo) - 1] : hi ? pr[32 + __ffs(hi) - 1] : g.n;
        }
      }
    } else if (threadIdx.x < g.per) {
      seeds[b0 + threadIdx.x] = g.n;
    }
  }
  const int n_grp = (g.n + 3) >> 2;
  for (int grp = blockIdx.y * kThreads + threadIdx.x; grp < n_grp;
       grp += gridDim.y * kThreads) {
    const Group<ND, kVec> x = group_at<ND, kVec>(g, grp);
    for (int k = 0; k < g.per; ++k) {
      uint32_t act[Form<ND>::kDirs + 1];
      balanced_words<ND, kVec>(spins, row0, houdn_rows + k * gs, gs, x, g, act);
      uint32_t st = 0;
#pragma unroll
      for (int d = 0; d < Form<ND>::kDirs; ++d) {
        if (ND == kTable && d >= g.nb) break;
        st |= (act[0] & act[1 + d]) << d;
      }
      uint8_t* out = state + static_cast<size_t>(b0 + k) * g.n;
      if (kVec) {
        reinterpret_cast<uint32_t*>(out)[grp] = st;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < x.cnt) out[x.i0 + q] = static_cast<uint8_t>(st >> (8 * q));
      }
    }
  }
}

// Houdayer(N)'s flips (the first design: a thread a site of one task,
// runtime divisions for the task's realization and temperature and for
// the backward neighbours of the singleton test, find_root on parents
// fk_link has already flattened, for Wolff also on the seed in every
// thread, a tasks -> sid -> spins chain a member and a site with byte
// loads and stores, and a copy of the roots into the labels).  ov_finish's
// walk with houdn_bonds' staged rows: the CTA stages each task's g member
// slots (stage_members) and, from its last threads, its SW salts s0, s1
// or its Wolff seed's root (one load of parent[b n + seed] a task, -1
// where the seed is n: no flip); a thread takes the group of four sites
// 4 grp .. 4 grp + 3 of each of its tasks.  state / parent are
// houdn_bonds' bonds and fk_link's flat parents of them (the caller's
// labels where it asks for them): each group's roots one int4 load;
// Wolff flips the seed's component, SW each non-singleton
// (nonsingleton_words) whose coin falls below 1/2.  Each member's word is one 4-byte load and one store, xor f
// 0xFE, none where no site of the group flips; up to kFlipBatch members'
// loads are issued before their stores (distinct systems), so the g
// members cost about one load's latency, not g.  Each system belongs to
// one task of a move, so no two threads write one word.  Where !kVec the
// per-site path gathers bytes, as ov_finish's.
constexpr int kFlipBatch = 8;  // the members' words houdn_finish loads at once

template <int ND, bool kWolff, bool kVec>
__global__ void __launch_bounds__(kThreads)
houdn_finish_kernel(int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                    const int32_t* __restrict__ tasks, const int32_t* __restrict__ scal,
                    const uint8_t* __restrict__ state, const int32_t* __restrict__ parent,
                    const int32_t* __restrict__ seeds, const OvWalk g, int gs) {
  extern __shared__ uint16_t houdn_rows[];
  __shared__ OvTasks sh;
  stage_members(houdn_rows, sid, tasks, gs, g);
  const int b0 = blockIdx.z * g.T * g.G + blockIdx.x * g.per;
  // the task entries from the CTA's last threads, beside the first ones'
  // tasks -> sid chains
  const int e = kThreads - 1 - threadIdx.x;
  if (e < g.per) {
    const int b = b0 + e;
    if (kWolff) {
      const int seed = seeds[b];
      sh.root[e] = seed < g.n ? __ldg(parent + static_cast<size_t>(b) * g.n + seed) : -1;
    } else {
      sh.s0[e] = static_cast<uint32_t>(scal[6 * b]);
      sh.s1[e] = static_cast<uint32_t>(scal[6 * b + 1]);
    }
  }
  __syncthreads();
  const long long row0 = static_cast<long long>(blockIdx.z) * g.S;
  const int n_grp = (g.n + 3) >> 2;
  for (int grp = blockIdx.y * kThreads + threadIdx.x; grp < n_grp;
       grp += gridDim.y * kThreads) {
    const Group<ND, kVec> x = group_at<ND, kVec>(g, grp);
    for (int k = 0; k < g.per; ++k) {
      const size_t base = static_cast<size_t>(b0 + k) * g.n;
      int lab[4];
      const uint32_t st = load_roots<ND, kVec>(state + base, parent + base, x, lab);
      uint32_t f;  // bit 0 of byte q: site q flips in every member
      if (kWolff) {
        f = same_root(lab, sh.root[k]);
      } else {
        const uint32_t coin = half_coins(lab, x.cnt, sh.s0[k], sh.s1[k]);
        f = coin & nonsingleton_words<ND, kVec>(state + base, st, lab, coin, x, g);
      }
      if (!f) continue;
      const uint16_t* rows = houdn_rows + k * gs;
      if (kVec) {
        // up to kFlipBatch members' words loaded before any is stored:
        // the members are distinct systems
        for (int r0 = 0; r0 < gs; r0 += kFlipBatch) {
          uint32_t* w[kFlipBatch];
          uint32_t v[kFlipBatch];
#pragma unroll
          for (int j = 0; j < kFlipBatch; ++j) {
            if (r0 + j >= gs) break;
            w[j] = reinterpret_cast<uint32_t*>(spins + (row0 + rows[r0 + j]) * g.n) + grp;
            v[j] = *w[j];
          }
#pragma unroll
          for (int j = 0; j < kFlipBatch; ++j) {
            if (r0 + j >= gs) break;
            *w[j] = v[j] ^ f * 0xFEu;
          }
        }
      } else {
        for (int r = 0; r < gs; ++r) {
          int8_t* s = spins + (row0 + rows[r]) * g.n;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= x.cnt) break;
            s[x.i0 + q] ^= static_cast<int8_t>(((f >> (8 * q)) & 1u) * 0xFEu);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ the table form
//
// The five move kernels on the lattices that OvWalk's words do not hold:
// four dimensions or more, or 7 to 32 forward offsets (ops/lattice.py
// Lattice.table; the 4D +-J glass).  The reference runs its jnp moves there
// (peapods_tpu/ops/overlap.py houdayer_task, jorg_bonds, cmr_blue_bonds,
// cmr_mid and the finishes on GridOps), since its Pallas events hold three
// extents (pallas_event.py:491-496): these kernels are the counterparts of
// pallas_event.py:463 overlap_event_batch and :989 houdn_event_batch on those
// lattices, and compute what the jnp moves compute.  Each site's neighbours
// are read from the lattice's int32 tables fwd / bwd [n, nb] (device memory,
// ops/lattice.py Lattice.device_tables).  A bond graph is a uint32 word a
// site, bit d the bond to fwd[i, d]: the form that cc.cu's cc_table_init /
// cc_table_link and fk.cu's fk_link_flatten label (ops/overlap.py
// launch_event_table).  CMR's blue flip, which finds no free bit in a word
// of 32 offsets, is a byte a site of its own (flip).  The rules, the draws
// and their counters are the walk form's: Philox keyed by the task's two
// words, counter (first + d, site / 4, 0, 0) with CMR's red bonds from
// first = nb, each draw the integer compare with threshold24 of the bond's
// probability, drawn only where a bond can be active.  A self offset (fwd[i,
// d] = i, an extent of 1) is a bond like any other, as the reference's roll
// over an extent of 1 makes it.
//
// The launches.  ov_bonds_table, ov_mid_table and houdn_bonds_table take
// ov_bonds' walk on the tables (ops/overlap.py ov_table_plan and
// table_pers, modelled in tests/test_torch_bond_plans.py; below): a thread
// takes the group of four sites 4 grp .. 4 grp + 3 for `per` tasks of one
// realization whose entries the CTA stages once, and reads the group's
// table rows (and couplings) once for them; each plan weighs waves on its
// kernel's own CTAs an SM.  ov_finish_table and houdn_finish_table are
// first designs (table_grid, modelled in tests/test_torch_overlap_tables.py):
// a thread takes the group of one task (blockIdx.x the blocks of kThreads
// groups, blockIdx.y the task), finds its task's systems through tasks and
// sid, and reads its sites' words, parents and spins a site at a time.  The
// three redesigns had that first design too, with each neighbour's spin
// bytes, table entries and couplings read one at a time, and J / T and the
// bond's probability taken again for every task.  At the 4D +-J glass (192
// tasks of 10^4 sites; tools/probe_overlap.py --table, CUDA events, NVIDIA
// H100 80GB HBM3, 700 W), first design -> redesign, ms a launch:
// ov_bonds_table CMR SW 0.0446 -> 0.0230, Joerg Wolff 0.0465 -> 0.0235;
// ov_mid_table CMR SW 0.0574 -> 0.0336, at 16^3 with 9 offsets (96 tasks)
// 0.0270 -> 0.0180; houdn_bonds_table the pair SW 0.0246 -> 0.0121, Wolff
// Houdayer(4) (R = 4) 0.0303 -> 0.0179.  Of ov_bonds_table's 0.0230 the
// draws take 0.0058 (t-n-nophilox); of ov_mid_table's 0.0336 the grey
// draws 0.0048 (t-n-mid-nophilox) and the SW backward words 0.0048
// (t-n-mid-nowalk), with 128 registers at 4 offsets against 104 without
// them.  Reading runs of four consecutive neighbours as aligned words
// (t-n-runs) made both 30-50% slower.  The walk form's kTable instance, six
// offsets unrolled, reached 251 registers: the tables have instances of
// their own.
//
// What bounds it on the H100: bytes.  ov_bonds_table reads its task's two
// systems (2 n bytes), the couplings and the forward table (8 n nb bytes a
// realization) and writes a word a site (4 n bytes a task); ov_mid_table
// adds the blue words, parents and the backward table; the finishes read
// the last graph's words and parents and the spins they flip
// (chip_smoke.py phase 38 computes each launch's bound from its shapes).

// The table form's launch words (ops/overlap.py ov_table_words): n sites,
// nb forward offsets, tasks b = (z T + t) G + j of T temperatures and G
// groups (pairs but for Houdayer(N)), S slots a realization, d
// realizations.
struct OvTable {
  int n;
  int nb;
  int T;
  int G;
  int S;
  int d;
};

inline OvTable make_ov_table(const int* w) {
  return OvTable{w[0], w[1], w[2], w[3], w[4], w[5]};
}

inline bool ov_table_ok(const OvTable& g) {
  return g.n >= 1 && g.nb >= 1 && g.nb <= 32 &&
         static_cast<long long>(g.n) * g.nb < (1LL << 31) && g.T >= 1 && g.G >= 1 &&
         g.S >= 1 && g.d >= 1 && static_cast<long long>(g.d) * g.T * g.G <= 65535;
}

// x the blocks of kThreads groups of four sites, y the tasks.
inline dim3 table_grid(const OvTable& g) {
  const int groups = (g.n + 3) / 4;
  return dim3((groups + kThreads - 1) / kThreads, g.d * g.T * g.G);
}

// The planned table kernels (ov_bonds_table, ov_mid_table,
// houdn_bonds_table; ops/overlap.py ov_table_plan): `per` tasks a thread, a
// divisor of a realization's T G up to kMaxPer; x a realization's sets of
// per tasks, y the blocks of kThreads groups (up to 65535, striding over
// the rest), z the realizations.
inline bool table_plan_ok(const OvTable& g, int per) {
  return ov_table_ok(g) && per >= 1 && per <= kMaxPer && (g.T * g.G) % per == 0;
}

inline dim3 table_plan_grid(const OvTable& g, int per) {
  const int blocks = ((g.n + 3) / 4 + kThreads - 1) / kThreads;
  return dim3(g.T * g.G / per, blocks < 65535 ? blocks : 65535, g.d);
}

// Task blockIdx.y: its index b, realization z and temperature t.
struct TableTask {
  int b;
  int z;
  int t;
};

__device__ __forceinline__ TableTask table_task(const OvTable& g) {
  TableTask k;
  k.b = blockIdx.y;
  const int tg = g.T * g.G;
  k.z = k.b / tg;
  k.t = (k.b - k.z * tg) / g.G;
  return k;
}

// The row offset (z S + system) n of member r of task k (of gs members).
__device__ __forceinline__ long long table_row(const OvTable& g, const TableTask& k,
                                               const int32_t* __restrict__ sid,
                                               const int32_t* __restrict__ tasks, int gs,
                                               int r) {
  const long long s0 = static_cast<long long>(k.z) * g.S;
  const int rep = __ldg(tasks + static_cast<size_t>(k.b) * gs + r);
  return (s0 + __ldg(sid + s0 + rep * g.T + k.t)) * g.n;
}

// Whether site i (flat parent lab) lies in a cluster of two sites or more,
// as ops/cluster.py nonsingleton_mask decides: its own bonds (st), a root
// other than itself, or else a backward neighbour's bond d towards it (bit
// d of S[bwd[i, d]]).
__device__ __forceinline__ bool table_nonsingleton(const uint32_t* __restrict__ S,
                                                   const int32_t* __restrict__ bwd, int i,
                                                   int lab, uint32_t st, int nb) {
  if (st || lab != i) return true;
  const int32_t* row = bwd + static_cast<size_t>(i) * nb;
  for (int d = 0; d < nb; ++d)
    if ((__ldg(S + __ldg(row + d)) >> d) & 1u) return true;
  return false;
}

// Joerg's and CMR's blue bonds (ov_bonds' rules) and the seeds: Joerg
// Wolff's first probe with a != b (the first warp of the task's first
// block, two ballots), CMR's drawn one, n for Joerg SW.  A thread takes the
// group of four sites 4 grp .. 4 grp + 3 (blockIdx.y the groups' block of
// kThreads, strided) for `per` consecutive tasks of one realization
// (blockIdx.z; blockIdx.x the set; ops/overlap.py ov_table_plan, ov_per's
// rule), whose two systems' rows, key words, temperature, 1 / T (a unit
// coupling's |J / T|) and unit threshold the CTA stages in shared memory
// once.  It reads the group's 4 nb table entries and couplings once for its
// tasks (table.cuh), and for each task its systems' own spins (32-bit
// loads where vec & 1) and every neighbour's spin of a step in both systems
// before the step's first decision.  A unit coupling's J / T is +-1 / T
// and its draw the integer compare with the staged threshold; only other
// couplings divide and draw the exp.  Philox is drawn only where a bond of
// the group can be active; the four words are one 16-byte store (vec & 2).
// NB: the offsets unrolled (4, 5, 8, 9, 13), or 0: steps of four offsets,
// each task's own words and bond words kept in registers across the steps.
struct TableTasks {
  long long ra[kMaxPer];
  long long rb[kMaxPer];
  uint32_t k0[kMaxPer];
  uint32_t k1[kMaxPer];
  float T[kMaxPer];
  float inv[kMaxPer];
  uint32_t thr[kMaxPer];
  uint32_t s0[kMaxPer];  // ov_mid_table: the SW salts and the Wolff seed's root
  uint32_t s1[kMaxPer];
  int root[kMaxPer];
};

// Thread k < per stages task b0 + k (temperature (x per + k) / G of
// realization z = blockIdx.z): its two systems' row offsets, key words,
// T, 1 / T and the unit coupling's threshold of bond probability `which`.
__device__ __forceinline__ void stage_pair_tasks(TableTasks& sh, const int32_t* __restrict__ sid,
                                                 const int32_t* __restrict__ tasks,
                                                 const float* __restrict__ temps,
                                                 const int32_t* __restrict__ keys,
                                                 const OvTable& g, int per, int which) {
  if (threadIdx.x >= per) return;
  const int k = threadIdx.x;
  const int z = blockIdx.z;
  const int b = z * g.T * g.G + blockIdx.x * per + k;
  const int t = (blockIdx.x * per + k) / g.G;
  const long long row = static_cast<long long>(z) * g.S;
  sh.ra[k] = (row + __ldg(sid + row + __ldg(tasks + 2 * b) * g.T + t)) * g.n;
  sh.rb[k] = (row + __ldg(sid + row + __ldg(tasks + 2 * b + 1) * g.T + t)) * g.n;
  sh.k0[k] = static_cast<uint32_t>(__ldg(keys + 2 * b));
  sh.k1[k] = static_cast<uint32_t>(__ldg(keys + 2 * b + 1));
  const float T = __ldg(temps + t);
  sh.T[k] = T;
  sh.inv[k] = 1.0f / T;
  sh.thr[k] = threshold24(bond_prob(which, 1.0f / T));
}

// The bonds along offset d of the group's sites `other`, whose couplings are
// not +-1 (cg the group's couplings, rows of nb), of bond probability
// `which` (Joerg: a a_f jt > 0, a != b and a_f != b_f; CMR blue: a a_f jt
// > 0 and b b_f jt > 0; grey: the two tests differ): J / T divided and the
// first design's float tests, its Philox block at counter (first + d, grp)
// (the unit sites' own, drawn again) only where one of them is a
// candidate, and threshold24 of each candidate's probability.  Bit 0 of
// byte q: site q's bond.  Out of line: inlined, its division and exp took
// registers from every site's path.
template <int which>
__device__ __noinline__ uint32_t other_pair_bonds(uint32_t other, uint32_t aw, uint32_t bw,
                                                  uint32_t an, uint32_t bn,
                                                  const float* __restrict__ cg, int nb, int d,
                                                  int first, float T, uint32_t k0, uint32_t k1,
                                                  int grp) {
  float jt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  uint32_t cand = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!((other >> (8 * q)) & 1u)) continue;
    jt[q] = __ldg(cg + q * nb + d) / T;
    const int a = byte_of(aw, q), b = byte_of(bw, q);
    const int af = byte_of(an, q), bf = byte_of(bn, q);
    const bool sa = static_cast<float>(a * af) * jt[q] > 0.0f;
    const bool sb = static_cast<float>(b * bf) * jt[q] > 0.0f;
    if (which == kProbJorg ? sa && a != b && af != bf
                           : which == kProbBlue ? sa && sb : sa != sb)
      cand |= 1u << (8 * q);
  }
  if (!cand) return 0u;
  const uint4 r = philox4x32_10(k0, k1, static_cast<uint32_t>(first + d),
                                static_cast<uint32_t>(grp), 0u, 0u);
  const uint32_t uw[4] = {r.x, r.y, r.z, r.w};
  uint32_t on = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if ((cand >> (8 * q)) & 1u && (uw[q] >> 8) < threshold24(bond_prob(which, jt[q])))
      on |= 1u << (8 * q);
  return on;
}

// The blue (CMR) or Joerg bonds of offsets d0 .. d0+K-1 below hi of the
// group's sites `live` in one task k (systems A and B, own words aw and
// bw; the step's entries f and coupling words m, the couplings cg), or'ed
// into st: both systems' neighbour spins gathered first, then each
// offset's candidates four sites at once, and a Philox block where one
// is.  A unit coupling's J / T is +-1 / T: its a a_f J / T > 0 is its sign
// (J's and 1 / T's, both staged) flipped where the spins differ, and its
// draw the integer compare with the staged threshold; another coupling
// takes other_pair_bonds.
template <int kKind, int K>
__device__ __forceinline__ void pair_bonds(uint32_t (&st)[4], const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ B, uint32_t aw,
                                           uint32_t bw, const int (&f)[4][K],
                                           const uint32_t (&m)[K], const float* __restrict__ cg,
                                           int nb, int d0, int hi, uint32_t live, int grp,
                                           const TableTasks& sh, int k) {
  uint32_t an[K], bn[K];
  gather_words<K>(an, A, f);
  gather_words<K>(bn, B, f);
  const float inv = sh.inv[k];
  const uint32_t up = inv > 0.0f ? ~0u : 0u;  // 1 / T > 0: J / T has J's sign
  const uint32_t down = inv < 0.0f ? ~0u : 0u;
  const uint32_t act = byte_differ(aw, bw);  // Joerg: a != b
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int d = d0 + j;
    if (d >= hi) break;
    const uint32_t pos = m[j] & kByteBits;
    const uint32_t neg = (m[j] >> 1) & kByteBits;
    const uint32_t uni = (m[j] >> 2) & kByteBits;
    const uint32_t jp = ((pos & up) | (neg & down)) & uni;  // J / T > 0
    const uint32_t jn = ((neg & up) | (pos & down)) & uni;  // J / T < 0
    const uint32_t da = byte_differ(aw, an[j]);
    uint32_t cand = (da & jn) | (~da & jp);
    if (kKind == kJorg) {
      cand &= act & byte_differ(an[j], bn[j]);
    } else {
      const uint32_t db = byte_differ(bw, bn[j]);
      cand &= (db & jn) | (~db & jp);
    }
    cand &= live;
    uint32_t on = 0;
    if (cand) {
      const uint4 r = philox4x32_10(sh.k0[k], sh.k1[k], static_cast<uint32_t>(d),
                                    static_cast<uint32_t>(grp), 0u, 0u);
      const uint32_t uw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((uw[q] >> 8) < sh.thr[k]) on |= 1u << (8 * q);
      on &= cand;
    }
    const uint32_t other = ~uni & live;
    if (other)
      on |= other_pair_bonds<kKind == kJorg ? kProbJorg : kProbBlue>(
          other, aw, bw, an[j], bn[j], cg, nb, d, 0, sh.T[k], sh.k0[k], sh.k1[k], grp);
#pragma unroll
    for (int q = 0; q < 4; ++q) st[q] |= ((on >> (8 * q)) & 1u) << d;
  }
}

template <int kKind, int NB>
__global__ void __launch_bounds__(kThreads)
ov_bonds_table_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                      const int32_t* __restrict__ tasks, const float* __restrict__ coup,
                      const float* __restrict__ temps, const int32_t* __restrict__ scal,
                      const int32_t* __restrict__ probes, const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ fwd, uint32_t* __restrict__ state,
                      int32_t* __restrict__ seeds, const OvTable g, int per, int wolff,
                      int vec) {
  __shared__ TableTasks sh;
  const int z = blockIdx.z;
  const int b0 = z * g.T * g.G + blockIdx.x * per;
  stage_pair_tasks(sh, sid, tasks, temps, keys, g, per, kKind == kJorg ? kProbJorg : kProbBlue);
  __syncthreads();
  if (blockIdx.y == 0) {
    if (kKind == kJorg && wolff) {
      if (threadIdx.x < 32) {
        // the first warp tests a task's 64 probes at once, lane l probes l
        // and 32 + l; the seed is the first active one in probe order
        const int l = threadIdx.x;
        for (int k = 0; k < per; ++k) {
          const int32_t* pr = probes + kProbes * (b0 + k);
          const int8_t* A = spins + sh.ra[k];
          const int8_t* B = spins + sh.rb[k];
          const int p0 = __ldg(pr + l);
          const int p1 = __ldg(pr + 32 + l);
          const unsigned lo = __ballot_sync(0xffffffffu, __ldg(A + p0) != __ldg(B + p0));
          const unsigned hi = __ballot_sync(0xffffffffu, __ldg(A + p1) != __ldg(B + p1));
          if (l == 0)
            seeds[b0 + k] = lo ? pr[__ffs(lo) - 1] : hi ? pr[32 + __ffs(hi) - 1] : g.n;
        }
      }
    } else if (threadIdx.x < per) {
      const int b = b0 + threadIdx.x;
      seeds[b] = kKind == kCmr ? scal[6 * b + 4] : g.n;
    }
  }
  const int n_grp = (g.n + 3) >> 2;
  for (int grp = blockIdx.y * kThreads + threadIdx.x; grp < n_grp;
       grp += gridDim.y * kThreads) {
    const int i0 = 4 * grp;
    const int cnt = min(4, g.n - i0);
    const float* cg = coup + (static_cast<size_t>(z) * g.n + i0) * g.nb;
    const int32_t* rg = fwd + static_cast<size_t>(i0) * g.nb;
    const bool c16 = reinterpret_cast<uintptr_t>(cg) % 16 == 0;
    const uint32_t live = live_bytes(cnt);
    if constexpr (NB > 0) {
      int f[4][NB];
      uint32_t m[NB];
      whole_rows<NB>(f, m, rg, cg, i0, cnt, c16);
      for (int k = 0; k < per; ++k) {
        const int8_t* A = spins + sh.ra[k];
        const int8_t* B = spins + sh.rb[k];
        uint32_t st[4] = {0u, 0u, 0u, 0u};
        pair_bonds<kKind, NB>(st, A, B, own_spins(A, i0, cnt, vec & 1),
                              own_spins(B, i0, cnt, vec & 1), f, m, cg, g.nb, 0, NB, live, grp,
                              sh, k);
        store_words(state + static_cast<size_t>(b0 + k) * g.n, i0, cnt, st, vec & 2);
      }
    } else {
      uint32_t st[kMaxPer][4];
      uint32_t aw[kMaxPer], bw[kMaxPer];
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0u;
        aw[k] = bw[k] = 0u;
        if (k < per) {
          aw[k] = own_spins(spins + sh.ra[k], i0, cnt, vec & 1);
          bw[k] = own_spins(spins + sh.rb[k], i0, cnt, vec & 1);
        }
      }
      for (int d0 = 0; d0 < g.nb; d0 += 4) {
        int f[4][4];
        uint32_t m[4];
        step_rows(f, m, rg, cg, g.nb, d0, g.nb, i0, cnt,
                  g.nb % 4 == 0 && d0 + 4 <= g.nb && cnt == 4 && c16);
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          if (k >= per) break;
          pair_bonds<kKind, 4>(st[k], spins + sh.ra[k], spins + sh.rb[k], aw[k], bw[k], f, m,
                               cg, g.nb, d0, g.nb, live, grp, sh, k);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        if (k >= per) break;
        store_words(state + static_cast<size_t>(b0 + k) * g.n, i0, cnt, st[k], vec & 2);
      }
    }
  }
}

// The group's blue words st[q] (bit d: the blue bond to fwd[i0 + q, d]) and
// flat parents lab[q] of one task: one 16-byte load each where vec (n % 4
// == 0, the rows 16-byte aligned); a site past n holds no bond and parent
// -1.
__device__ __forceinline__ void table_roots(uint32_t (&st)[4], int (&lab)[4],
                                            const uint32_t* __restrict__ S,
                                            const int32_t* __restrict__ P, int i0, int cnt,
                                            int vec) {
  if (vec) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(S + i0));
    const int4 p = __ldg(reinterpret_cast<const int4*>(P + i0));
    st[0] = w.x;
    st[1] = w.y;
    st[2] = w.z;
    st[3] = w.w;
    lab[0] = p.x;
    lab[1] = p.y;
    lab[2] = p.z;
    lab[3] = p.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      st[q] = q < cnt ? __ldg(S + i0 + q) : 0u;
      lab[q] = q < cnt ? __ldg(P + i0 + q) : -1;
    }
  }
}

// Bit 0 of byte q where a backward neighbour past site i0 + q of the sites
// `look` has its bond towards it (bk: the group's backward rows in the
// thread's slice of shared memory, entry (q K + j) kThreads), every word
// loaded before the first test.  Out of line: rarely called, its loads
// keep no registers from the grey words' path.
template <int K>
__device__ __noinline__ uint32_t back_words(uint32_t look, const uint32_t* __restrict__ S,
                                            const int* bk, int i0) {
  uint32_t w[4][K];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int b = (look >> (8 * q)) & 1u ? bk[(q * K + j) * kThreads] : 0;
      w[q][j] = b > i0 + q ? __ldg(S + b) : 0u;
    }
  uint32_t back = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < K; ++j) back |= ((w[q][j] >> j) & 1u) << (8 * q);
  return back;
}

// Bit 0 of byte q where site i0 + q of one task flips with its blue cluster
// (ov_mid's rule): Wolff, its flat parent is the seed's root; SW, the coin
// on its root falls below 1/2 and it lies in a cluster of two sites or more
// (table_nonsingleton): `own` (its own bonds or a root other than itself),
// or else a backward neighbour's bond towards it, read only for a root with
// no bond of its own whose coin fell, and only from a backward neighbour
// past it (the parents are the labellings': each site's root is its
// component's least site, so a root's bonded neighbours all lie past it).
// Where K > 0 only the sites of `past` (stage_back's) read their backward
// words (back_words); else the backward table is walked site by site.
template <bool kWolff, int K>
__device__ __forceinline__ uint32_t blue_flips(uint32_t own, const int (&lab)[4],
                                               const uint32_t* __restrict__ S,
                                               const int32_t* __restrict__ bwd, const int* bk,
                                               uint32_t past, int i0, int cnt, int nb,
                                               const TableTasks& sh, int k) {
  if (kWolff) return same_root(lab, sh.root[k]);
  const uint32_t coin = half_coins(lab, cnt, sh.s0[k], sh.s1[k]);
  const uint32_t need = coin & ~own;
  uint32_t back = 0;
  if constexpr (K > 0) {
    const uint32_t look = need & past;
    if (look) back = back_words<K>(look, S, bk, i0);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (((need >> (8 * q)) & 1u) && table_nonsingleton(S, bwd, i0 + q, i0 + q, 0u, nb))
        back |= 1u << (8 * q);
  }
  return coin & (own | back);
}

// The group's K backward rows into the thread's slice of shared memory
// (entry q K + j at (q K + j) kThreads past bk: no two threads of a warp on
// one bank), read once for its tasks' SW blue flips; returns bit 0 of byte q
// where site i0 + q has a backward neighbour past it.
template <int K>
__device__ __forceinline__ uint32_t stage_back(int* bk, const int32_t* __restrict__ bwd, int i0,
                                               int cnt) {
  int b[4][K];
  uint32_t none[K];  // no couplings: unread
  whole_rows<K, false>(b, none, bwd + static_cast<size_t>(i0) * K, nullptr, i0, cnt, false);
  uint32_t past = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bk[(q * K + j) * kThreads] = b[q][j];
      if (b[q][j] > i0 + q) past |= 1u << (8 * q);
    }
  return past;
}

// The dynamic shared memory of ov_mid_table's instance of nb offsets: SW's
// backward rows of every thread's group where the offsets are unrolled.
inline size_t mid_smem(int nb, int wolff) {
  const bool unrolled = nb == 4 || nb == 5 || nb == 8 || nb == 9 || nb == 13;
  return !wolff && unrolled ? static_cast<size_t>(kThreads) * 4 * nb * sizeof(int) : 0;
}

// Bit 0 of byte q where site i0 + q has a blue bond of its own or a root
// other than itself (the group's blue words st and parents lab).
__device__ __forceinline__ uint32_t own_bonds(const uint32_t (&st)[4], const int (&lab)[4],
                                              int i0) {
  uint32_t own = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (st[q] || lab[q] != i0 + q) own |= 1u << (8 * q);
  return own;
}

// The group's four flip bytes into a task's row: one 4-byte store where vec.
__device__ __forceinline__ void store_flips(uint8_t* __restrict__ out, int i0, int cnt,
                                            uint32_t fl, int vec) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(out + i0) = fl;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt) out[i0 + q] = static_cast<uint8_t>(fl >> (8 * q));
  }
}

// CMR's grey bonds of offsets d0 .. d0+K-1 below hi of the group's sites
// `live` in one task k, or'ed into st (the blue words: a blue bond is a grey
// one and draws nothing): both systems' neighbour spins gathered first,
// then each offset's four sites at once.  sat_a != sat_b is a a_f != b b_f
// (the two spin bytes' differences differ) where J / T is neither 0 nor
// NaN: a unit coupling's J / T is +-1 / T, nonzero where 1 / T is; its
// draw, counter (nb + d, grp), the integer compare with the staged grey
// threshold; another coupling takes other_pair_bonds.
template <int K>
__device__ __forceinline__ void grey_bonds(uint32_t (&st)[4], const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ B, uint32_t aw,
                                           uint32_t bw, const int (&f)[4][K],
                                           const uint32_t (&m)[K], const float* __restrict__ cg,
                                           int nb, int d0, int hi, uint32_t live, int grp,
                                           const TableTasks& sh, int k) {
  uint32_t an[K], bn[K];
  gather_words<K>(an, A, f);
  gather_words<K>(bn, B, f);
  const float inv = sh.inv[k];
  const uint32_t nz = inv > 0.0f || inv < 0.0f ? kByteBits : 0u;  // 1 / T neither 0 nor NaN
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int d = d0 + j;
    if (d >= hi) break;
    uint32_t blue = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) blue |= ((st[q] >> d) & 1u) << (8 * q);
    const uint32_t uni = (m[j] >> 2) & kByteBits;
    const uint32_t open = live & ~blue;
    const uint32_t cand = byte_differ(aw ^ an[j], bw ^ bn[j]) & uni & nz & open;
    uint32_t on = 0;
    if (cand) {
      const uint4 r = philox4x32_10(sh.k0[k], sh.k1[k], static_cast<uint32_t>(nb + d),
                                    static_cast<uint32_t>(grp), 0u, 0u);
      const uint32_t uw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((uw[q] >> 8) < sh.thr[k]) on |= 1u << (8 * q);
      on &= cand;
    }
    const uint32_t other = ~uni & open;
    if (other)
      on |= other_pair_bonds<kProbGrey>(other, aw, bw, an[j], bn[j], cg, nb, d, nb, sh.T[k],
                                        sh.k0[k], sh.k1[k], grp);
#pragma unroll
    for (int q = 0; q < 4; ++q) st[q] |= ((on >> (8 * q)) & 1u) << d;
  }
}

// CMR's blue flip and grey bonds (ov_mid's rules; the first design took four
// sites of one task a thread, found its task's systems, salts, keys and T
// again in every thread, read its rows and couplings one entry and its
// neighbours' spins one byte at a time, walked the backward table before
// the coin, divided J / T and drew the exp for every bond and task, and
// stored a site at a time).  ov_bonds_table's walk: a thread takes the
// group of four sites 4 grp .. 4 grp + 3 (blockIdx.y the groups' block,
// strided) for `per` consecutive tasks of one realization (blockIdx.z;
// blockIdx.x the set; ops/overlap.py ov_table_plan), whose two rows, key
// words, T, 1 / T, unit grey threshold, SW salts and Wolff seed's root (one
// load of parent[b n + seed] a task) the CTA stages once.  It reads the
// group's table rows and couplings once for its tasks (table.cuh), and for
// each task its blue words and flat parents (16-byte loads where vec & 2),
// decides the grey words (grey_bonds) into one 16-byte store, then the four
// blue flips (blue_flips) into one 4-byte store of the flip bytes: every
// load of the grey words issued before a store or the backward rows.  SW
// stages the group's backward rows once in dynamic shared memory
// (stage_back, mid_smem), and reads a backward neighbour's word only past a
// root whose coin fell: `parent` must hold least-site roots, as the
// labellings write them.  The
// flipped spins are never read: the blue flip flips a and b together, so
// sat_a != sat_b is the same before and after it (for J / T neither 0 nor
// NaN; both false else).  NB: the offsets unrolled (4, 5, 8, 9, 13), or 0:
// steps of four offsets, each task's own words and grey words kept in
// registers across the steps.
template <bool kWolff, int NB>
__global__ void __launch_bounds__(kThreads)
ov_mid_table_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                    const int32_t* __restrict__ tasks, const float* __restrict__ coup,
                    const float* __restrict__ temps, const int32_t* __restrict__ scal,
                    const int32_t* __restrict__ keys, const int32_t* __restrict__ fwd,
                    const int32_t* __restrict__ bwd, const uint32_t* __restrict__ state,
                    const int32_t* __restrict__ parent, uint32_t* __restrict__ state2,
                    uint8_t* __restrict__ flip, const OvTable g, int per, int vec) {
  __shared__ TableTasks sh;
  extern __shared__ int mid_back[];  // SW, NB > 0: each thread's group's backward rows
  const int z = blockIdx.z;
  const int b0 = z * g.T * g.G + blockIdx.x * per;
  stage_pair_tasks(sh, sid, tasks, temps, keys, g, per, kProbGrey);
  if (threadIdx.x < per) {
    const int k = threadIdx.x;
    const int32_t* sc = scal + 6 * (b0 + k);
    sh.s0[k] = static_cast<uint32_t>(__ldg(sc));
    sh.s1[k] = static_cast<uint32_t>(__ldg(sc + 1));
    if (kWolff) sh.root[k] = __ldg(parent + static_cast<size_t>(b0 + k) * g.n + __ldg(sc + 4));
  }
  __syncthreads();
  const int n_grp = (g.n + 3) >> 2;
  for (int grp = blockIdx.y * kThreads + threadIdx.x; grp < n_grp;
       grp += gridDim.y * kThreads) {
    const int i0 = 4 * grp;
    const int cnt = min(4, g.n - i0);
    const float* cg = coup + (static_cast<size_t>(z) * g.n + i0) * g.nb;
    const int32_t* rg = fwd + static_cast<size_t>(i0) * g.nb;
    const bool c16 = reinterpret_cast<uintptr_t>(cg) % 16 == 0;
    const uint32_t live = live_bytes(cnt);
    if constexpr (NB > 0) {
      int f[4][NB];
      uint32_t m[NB];
      whole_rows<NB>(f, m, rg, cg, i0, cnt, c16);
      int* bk = mid_back + threadIdx.x;
      const uint32_t past = kWolff ? 0u : stage_back<NB>(bk, bwd, i0, cnt);
      for (int k = 0; k < per; ++k) {
        const size_t base = static_cast<size_t>(b0 + k) * g.n;
        uint32_t st[4];
        int lab[4];
        table_roots(st, lab, state + base, parent + base, i0, cnt, vec & 2);
        const uint32_t own = own_bonds(st, lab, i0);
        const int8_t* A = spins + sh.ra[k];
        const int8_t* B = spins + sh.rb[k];
        grey_bonds<NB>(st, A, B, own_spins(A, i0, cnt, vec & 1), own_spins(B, i0, cnt, vec & 1),
                       f, m, cg, g.nb, 0, NB, live, grp, sh, k);
        store_words(state2 + base, i0, cnt, st, vec & 2);
        store_flips(flip + base, i0, cnt,
                    blue_flips<kWolff, NB>(own, lab, state + base, bwd, bk, past, i0, cnt, g.nb,
                                           sh, k),
                    vec & 2);
      }
    } else {
      uint32_t st[kMaxPer][4];
      uint32_t aw[kMaxPer], bw[kMaxPer];
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0u;
        aw[k] = bw[k] = 0u;
        if (k < per) {
          const size_t base = static_cast<size_t>(b0 + k) * g.n;
          int lab[4];
          table_roots(st[k], lab, state + base, parent + base, i0, cnt, vec & 2);
          store_flips(flip + base, i0, cnt,
                      blue_flips<kWolff, 0>(own_bonds(st[k], lab, i0), lab, state + base, bwd,
                                            nullptr, 0u, i0, cnt, g.nb, sh, k),
                      vec & 2);
          aw[k] = own_spins(spins + sh.ra[k], i0, cnt, vec & 1);
          bw[k] = own_spins(spins + sh.rb[k], i0, cnt, vec & 1);
        }
      }
      for (int d0 = 0; d0 < g.nb; d0 += 4) {
        int f[4][4];
        uint32_t m[4];
        step_rows(f, m, rg, cg, g.nb, d0, g.nb, i0, cnt,
                  g.nb % 4 == 0 && d0 + 4 <= g.nb && cnt == 4 && c16);
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          if (k >= per) break;
          grey_bonds<4>(st[k], spins + sh.ra[k], spins + sh.rb[k], aw[k], bw[k], f, m, cg, g.nb,
                        d0, g.nb, live, grp, sh, k);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        if (k >= per) break;
        store_words(state2 + static_cast<size_t>(b0 + k) * g.n, i0, cnt, st[k], vec & 2);
      }
    }
  }
}

// The flips of a Joerg or CMR move (ov_finish's rules) from the flat parents
// of its last graph (Joerg's bonds; CMR's grey words, the blue flip in
// flip): Wolff the seed's component (none where Joerg's seed is n), SW each
// non-singleton whose coin falls below 1/2 (Joerg) or whose k =
// floor(4 salted_uniform(root, s2, s3)) is not 0 (CMR: a where k & 1, b where
// k & 2, after the blue flip; Wolff: the task's k).  A thread flips only its
// own sites, and reads no spin of another: no two threads write one byte.
template <int kKind, bool kWolff>
__global__ void __launch_bounds__(kThreads)
ov_finish_table_kernel(int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                       const int32_t* __restrict__ tasks, const int32_t* __restrict__ scal,
                       const int32_t* __restrict__ seeds, const uint32_t* __restrict__ state,
                       const int32_t* __restrict__ parent, const uint8_t* __restrict__ flip,
                       const int32_t* __restrict__ bwd, const OvTable g) {
  const TableTask k = table_task(g);
  const int grp = blockIdx.x * kThreads + threadIdx.x;
  const int i0 = 4 * grp;
  if (i0 >= g.n) return;
  const int cnt = min(4, g.n - i0);
  int8_t* A = spins + table_row(g, k, sid, tasks, 2, 0);
  int8_t* B = spins + table_row(g, k, sid, tasks, 2, 1);
  const size_t base = static_cast<size_t>(k.b) * g.n;
  const uint32_t* S = state + base;
  const int32_t* P = parent + base;
  const int32_t* sc = scal + 6 * k.b;
  const uint32_t s0 = static_cast<uint32_t>(__ldg(sc + (kKind == kJorg ? 0 : 2)));
  const uint32_t s1 = static_cast<uint32_t>(__ldg(sc + (kKind == kJorg ? 1 : 3)));
  const int kk = __ldg(sc + 5);
  int root = -1;
  if (kWolff) {
    const int seed = __ldg(seeds + k.b);
    root = seed < g.n ? __ldg(P + seed) : -1;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= cnt) break;
    const int i = i0 + q;
    const int lab = __ldg(P + i);
    bool fa, fb;
    if (kWolff) {
      const bool in = lab == root;
      fa = in && (kKind == kJorg || (kk & 1));
      fb = in && (kKind == kJorg || (kk & 2));
    } else {
      const float u = salted_uniform(static_cast<uint32_t>(lab), s0, s1);
      const int kq = kKind == kJorg ? (u < 0.5f ? 3 : 0) : static_cast<int>(u * 4.0f);
      const bool in = kq != 0 && table_nonsingleton(S, bwd, i, lab, __ldg(S + i), g.nb);
      fa = in && (kq & 1);
      fb = in && (kq & 2);
    }
    if (kKind == kCmr && __ldg(flip + base + i)) {
      fa = !fa;
      fb = !fb;
    }
    if (fa) A[i] = static_cast<int8_t>(-A[i]);
    if (fb) B[i] = static_cast<int8_t>(-B[i]);
  }
}

// Per-byte counts of -1 spins (bit 7 of a spin byte) over a task's members:
// bytes q of lo where g <= 254 (no byte overflows); past it 16-bit lanes,
// bytes 0 and 2 in lo, 1 and 3 in hi (houdn_bonds' balanced_words).
template <bool kWide>
__device__ __forceinline__ void add_signs(uint32_t& lo, uint32_t& hi, uint32_t w) {
  if (kWide) {
    lo += (w >> 7) & 0x00010001u;
    hi += (w >> 15) & 0x00010001u;
  } else {
    lo += (w >> 7) & kByteBits;
  }
}

// Bit 0 of byte q where the counts hold g / 2 (h): __vcmpeq4, or the 16-bit
// lanes' __vcmpeq2.
template <bool kWide>
__device__ __forceinline__ uint32_t half_signs(uint32_t lo, uint32_t hi, uint32_t h) {
  if (kWide)
    return (__vcmpeq2(lo, h * 0x00010001u) & 0x00010001u) |
           ((__vcmpeq2(hi, h * 0x00010001u) & 0x00010001u) << 8);
  return __vcmpeq4(lo, h * kByteBits) & kByteBits;
}

// Per-byte sign counts (add_signs) over a task's g members of the group's
// neighbour words along K offsets (lo[j], hi[j]: table.cuh gather_words
// through the rows f) and, where kOwn, of its own words (lo[K], hi[K]:
// own_spins), two members at a time (g is even) so that their loads are
// in flight together.
template <int K, bool kOwn, bool kWide>
__device__ __forceinline__ void sign_counts(uint32_t (&lo)[K + 1], uint32_t (&hi)[K + 1],
                                            const int8_t* __restrict__ spins,
                                            const long long* rows, int gs, const int (&f)[4][K],
                                            int i0, int cnt, int vec) {
#pragma unroll
  for (int j = 0; j <= K; ++j) lo[j] = hi[j] = 0u;
  for (int r = 0; r < gs; r += 2) {
    const int8_t* s0 = spins + rows[r];
    const int8_t* s1 = spins + rows[r + 1];
    uint32_t w0[K], w1[K];
    gather_words<K>(w0, s0, f);
    gather_words<K>(w1, s1, f);
    if (kOwn) {
      const uint32_t o0 = own_spins(s0, i0, cnt, vec);
      const uint32_t o1 = own_spins(s1, i0, cnt, vec);
      add_signs<kWide>(lo[K], hi[K], o0);
      add_signs<kWide>(lo[K], hi[K], o1);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      add_signs<kWide>(lo[j], hi[j], w0[j]);
      add_signs<kWide>(lo[j], hi[j], w1[j]);
    }
  }
}

// Bond d of offsets d0 .. d0+K-1 below top, or'ed into st: act0 (the
// group's balanced sites, bit 0 of byte q) and the neighbour along d
// balanced.
template <int K, bool kWide>
__device__ __forceinline__ void houdn_words(uint32_t (&st)[4], uint32_t act0,
                                            const uint32_t (&lo)[K + 1],
                                            const uint32_t (&hi)[K + 1], int gs, int d0,
                                            int top) {
  const uint32_t h = static_cast<uint32_t>(gs >> 1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int d = d0 + j;
    if (d >= top) break;
    const uint32_t on = act0 & half_signs<kWide>(lo[j], hi[j], h);
#pragma unroll
    for (int q = 0; q < 4; ++q) st[q] |= ((on >> (8 * q)) & 1u) << d;
  }
}

// Houdayer(N)'s bonds (houdn_bonds' rules: bond d joins two balanced sites
// i and fwd[i, d], whose g members' spins sum to 0; the first design took
// four sites of one task a thread, summed a site's g member bytes for
// itself and again for each of its nb neighbours, loaded a table entry
// before each neighbour's bytes and stored a word a site).  ov_bonds_table's
// walk: a thread takes the group of four sites 4 grp .. 4 grp + 3
// (blockIdx.y the groups' block, strided) for `per` consecutive tasks of one
// realization (blockIdx.z; blockIdx.x the set; ops/overlap.py
// ov_table_plan), whose per g member rows the CTA stages in dynamic shared
// memory once.  It reads the group's table rows once for its tasks
// (table.cuh, rows alone), and for each task counts its members' sign bits
// a word at a time, two members' loads together: own words one 32-bit load
// where vec & 1, each offset's neighbour words gathered (sign_counts); the
// four words one 16-byte store (vec & 2).  The Wolff seeds: warp k of the
// groups' first block takes task k (per <= the CTA's 8 warps), lane l
// testing probes l and 32 + l, two ballots choosing the first balanced
// probe in probe order (n when none is, and for SW).  NB: the offsets
// unrolled, or 0: steps of four offsets, each task's balanced sites and
// words kept in registers across the steps; kWide: g > 254, the counts'
// 16-bit lanes.
static_assert(kMaxPer <= kThreads / 32, "houdn_bonds_table: a warp a task's Wolff seed");

template <int NB, bool kWide>
__global__ void __launch_bounds__(kThreads)
houdn_bonds_table_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                         const int32_t* __restrict__ tasks, const int32_t* __restrict__ probes,
                         const int32_t* __restrict__ fwd, uint32_t* __restrict__ state,
                         int32_t* __restrict__ seeds, const OvTable g, int gs, int wolff,
                         int per, int vec) {
  extern __shared__ long long table_rows[];  // [per gs]: member r of task k at k gs + r
  const int z = blockIdx.z;
  const int b0 = z * g.T * g.G + blockIdx.x * per;
  const long long row0 = static_cast<long long>(z) * g.S;
  for (int e = threadIdx.x; e < per * gs; e += kThreads) {
    const int k = e / gs;
    const int t = (blockIdx.x * per + k) / g.G;
    const int rep = __ldg(tasks + static_cast<size_t>(b0) * gs + e);
    table_rows[e] = (row0 + __ldg(sid + row0 + rep * g.T + t)) * g.n;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    const int w = threadIdx.x >> 5;
    if (wolff) {
      if (w < per) {  // warp w: task w's probes, lane l probes l and 32 + l
        const int l = threadIdx.x & 31;
        const long long* rows = table_rows + w * gs;
        const int32_t* pr = probes + kProbes * (b0 + w);
        const int p0 = __ldg(pr + l);
        const int p1 = __ldg(pr + 32 + l);
        int s0 = 0, s1 = 0;
#pragma unroll 4
        for (int r = 0; r < gs; ++r) {
          const int8_t* m = spins + rows[r];
          s0 += __ldg(m + p0);
          s1 += __ldg(m + p1);
        }
        const unsigned lo = __ballot_sync(0xffffffffu, s0 == 0);
        const unsigned hi = __ballot_sync(0xffffffffu, s1 == 0);
        if (l == 0) seeds[b0 + w] = lo ? pr[__ffs(lo) - 1] : hi ? pr[32 + __ffs(hi) - 1] : g.n;
      }
    } else if (threadIdx.x < per) {
      seeds[b0 + threadIdx.x] = g.n;
    }
  }
  const int n_grp = (g.n + 3) >> 2;
  for (int grp = blockIdx.y * kThreads + threadIdx.x; grp < n_grp;
       grp += gridDim.y * kThreads) {
    const int i0 = 4 * grp;
    const int cnt = min(4, g.n - i0);
    const int32_t* rg = fwd + static_cast<size_t>(i0) * g.nb;
    const uint32_t live = live_bytes(cnt);
    if constexpr (NB > 0) {
      int f[4][NB];
      uint32_t m[NB];  // no couplings: unread
      whole_rows<NB, false>(f, m, rg, nullptr, i0, cnt, false);
      for (int k = 0; k < per; ++k) {
        uint32_t lo[NB + 1], hi[NB + 1];
        sign_counts<NB, true, kWide>(lo, hi, spins, table_rows + k * gs, gs, f, i0, cnt,
                                     vec & 1);
        const uint32_t act0 = half_signs<kWide>(lo[NB], hi[NB], static_cast<uint32_t>(gs >> 1)) &
                              live;
        uint32_t st[4] = {0u, 0u, 0u, 0u};
        houdn_words<NB, kWide>(st, act0, lo, hi, gs, 0, NB);
        store_words(state + static_cast<size_t>(b0 + k) * g.n, i0, cnt, st, vec & 2);
      }
    } else {
      uint32_t st[kMaxPer][4];
      uint32_t act0[kMaxPer];
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0u;
        act0[k] = 0u;
      }
      for (int d0 = 0; d0 < g.nb; d0 += 4) {
        int f[4][4];
        uint32_t m[4];
        step_rows<false>(f, m, rg, nullptr, g.nb, d0, g.nb, i0, cnt,
                         g.nb % 4 == 0 && d0 + 4 <= g.nb && cnt == 4);
#pragma unroll
        for (int k = 0; k < kMaxPer; ++k) {
          if (k >= per) break;
          uint32_t lo[5], hi[5];
          if (d0 == 0) {  // the first step also counts the group's own words
            sign_counts<4, true, kWide>(lo, hi, spins, table_rows + k * gs, gs, f, i0, cnt,
                                        vec & 1);
            act0[k] = half_signs<kWide>(lo[4], hi[4], static_cast<uint32_t>(gs >> 1)) & live;
          } else if (act0[k]) {
            sign_counts<4, false, kWide>(lo, hi, spins, table_rows + k * gs, gs, f, i0, cnt,
                                         vec & 1);
          }
          if (act0[k]) houdn_words<4, kWide>(st[k], act0[k], lo, hi, gs, d0, g.nb);
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k) {
        if (k >= per) break;
        store_words(state + static_cast<size_t>(b0 + k) * g.n, i0, cnt, st[k], vec & 2);
      }
    }
  }
}

// Call f with the instance of kKernel (0 ov_bonds_table, 1 ov_mid_table, 2
// houdn_bonds_table) of nb offsets (unrolled: 4, 5, 8, 9, 13; else the
// runtime count) and `variant` (ov_bonds_table: the move kind;
// ov_mid_table: Wolff where nonzero; houdn_bonds_table: g > 254, the
// counts' 16-bit lanes).
template <int kKernel, typename F>
void ov_table_instance(int nb, int variant, F&& f) {
  auto pick = [&](auto nb_c) {
    constexpr int NB = decltype(nb_c)::value;
    if constexpr (kKernel == 0) {
      if (variant == kJorg)
        f(ov_bonds_table_kernel<kJorg, NB>);
      else
        f(ov_bonds_table_kernel<kCmr, NB>);
    } else if constexpr (kKernel == 1) {
      if (variant)
        f(ov_mid_table_kernel<true, NB>);
      else
        f(ov_mid_table_kernel<false, NB>);
    } else {
      if (variant)
        f(houdn_bonds_table_kernel<NB, true>);
      else
        f(houdn_bonds_table_kernel<NB, false>);
    }
  };
  switch (nb) {
    case 4: pick(std::integral_constant<int, 4>{}); break;
    case 5: pick(std::integral_constant<int, 5>{}); break;
    case 8: pick(std::integral_constant<int, 8>{}); break;
    case 9: pick(std::integral_constant<int, 9>{}); break;
    case 13: pick(std::integral_constant<int, 13>{}); break;
    default: pick(std::integral_constant<int, 0>{}); break;
  }
}

// Houdayer(N)'s flips (houdn_finish's rules) in all g members: Wolff the
// seed's component (none where the seed is n), SW each non-singleton whose
// coin falls below 1/2.  A thread flips only its own sites.
template <bool kWolff>
__global__ void __launch_bounds__(kThreads)
houdn_finish_table_kernel(int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                          const int32_t* __restrict__ tasks, const int32_t* __restrict__ scal,
                          const uint32_t* __restrict__ state, const int32_t* __restrict__ parent,
                          const int32_t* __restrict__ seeds, const int32_t* __restrict__ bwd,
                          const OvTable g, int gs) {
  extern __shared__ long long table_rows[];
  const TableTask k = table_task(g);
  for (int r = threadIdx.x; r < gs; r += kThreads)
    table_rows[r] = table_row(g, k, sid, tasks, gs, r);
  __syncthreads();
  const int grp = blockIdx.x * kThreads + threadIdx.x;
  const int i0 = 4 * grp;
  if (i0 >= g.n) return;
  const int cnt = min(4, g.n - i0);
  const size_t base = static_cast<size_t>(k.b) * g.n;
  const uint32_t* S = state + base;
  const int32_t* P = parent + base;
  const uint32_t s0 = static_cast<uint32_t>(__ldg(scal + 6 * k.b));
  const uint32_t s1 = static_cast<uint32_t>(__ldg(scal + 6 * k.b + 1));
  int root = -1;
  if (kWolff) {
    const int seed = __ldg(seeds + k.b);
    root = seed < g.n ? __ldg(P + seed) : -1;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= cnt) break;
    const int i = i0 + q;
    const int lab = __ldg(P + i);
    const bool f = kWolff ? lab == root
                          : salted_uniform(static_cast<uint32_t>(lab), s0, s1) < 0.5f &&
                                table_nonsingleton(S, bwd, i, lab, __ldg(S + i), g.nb);
    if (!f) continue;
    for (int r = 0; r < gs; ++r) {
      int8_t* s = spins + table_rows[r] + i;
      *s = static_cast<int8_t>(-*s);
    }
  }
}

// The dynamic shared memory of the Houdayer(N) table kernels (gs member
// rows), opted in past the 48 KB a launch takes without.
template <typename Kernel>
inline cudaError_t table_rows_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// energy_partials' launch (ops/overlap.py energy_words): a system is n / W
// words of W bytes (8 or 4 where the fast extent holds whole words and the
// spins are aligned to them, else 1: the per-site path), in lines of wpl
// words along the fast axis; the lines run over an inner slow axis of
// extent Lb (2D: L0; 3D: L1) and, in 3D, an outer one of extent La (L0).
// A warp takes one 256-site block (nb a system) of `per` systems of one
// realization, `sets` = S / per such system sets a realization: warp w is
// block w % nb of set (w / nb) % sets of realization w / (nb sets), as
// multiply-shift divisions (m, s) of wpl, Lb, nb and sets.
struct EnergyWalk {
  int W;
  int n;
  int nw;
  int wpl;
  int Lb;
  int La;
  int nd;
  int per;
  int S;
  int nb;
  int sets;
  int d;
  int warps;
  uint32_t m[4];
  int s[4];
};

inline EnergyWalk make_energy_walk(const int* w) {
  EnergyWalk g;
  g.W = w[0];
  g.n = w[1];
  g.nw = w[2];
  g.wpl = w[3];
  g.Lb = w[4];
  g.La = w[5];
  g.nd = w[6];
  g.per = w[7];
  g.S = w[8];
  g.nb = w[9];
  g.sets = w[10];
  g.d = w[11];
  g.warps = w[12];
  for (int k = 0; k < 4; ++k) {
    g.m[k] = static_cast<uint32_t>(w[13 + 2 * k]);
    g.s[k] = w[14 + 2 * k];
  }
  return g;
}

template <int W>
struct SpinWord;
template <>
struct SpinWord<8> {
  typedef unsigned long long T;
};
template <>
struct SpinWord<4> {
  typedef unsigned int T;
};
template <>
struct SpinWord<1> {
  typedef unsigned char T;
};

// Word k of a system's spins, as the low W bytes of a 64-bit word.
template <int W>
__device__ __forceinline__ unsigned long long spin_word(const int8_t* s, int k) {
  typedef typename SpinWord<W>::T T;
  return static_cast<unsigned long long>(__ldg(reinterpret_cast<const T*>(s) + k));
}

// Byte b's term (s s_j) J of a bond whose spins' bytes are XORed into x
// (b known at compile time, an unrolled loop): J with its sign flipped
// where they differ (the sign bit of byte b), bitwise the product in
// floats for spins in {-1, +1}.
__device__ __forceinline__ float bond_term(unsigned long long x, int b, float J) {
  const uint32_t flip = static_cast<uint32_t>(x >> (8 * b + 7)) << 31;
  return __uint_as_float(__float_as_uint(J) ^ flip);
}

// The (e, m) partials of every (realization, system, 256-site block), one
// warp a block of `per` systems of one realization (EnergyWalk).  Lane l
// takes the block's sites 8 l .. 8 l + 7 (8 / W words).  Its forward
// couplings (8 nd floats, contiguous in [d, n, nd]) are read once for its
// systems, by 16-byte loads; each word's neighbour words (the line's next
// word, wrapping at its end; the same word of the next line and, in 3D,
// plane) are found once, by multiply-shift divisions and one compare an
// axis.  Per system the lane loads its words and their neighbour words
// before any add; the fast-axis neighbour of byte q is byte q + 1 of the
// word, or byte 0 of the next word.  A site's e is 0 + (s s_a) J[i, a]
// over the axes in order (the first design's thread a site), each term J's
// sign flipped where the two spins differ; the warp stages the block's 256
// values in shared memory and pairs them as warp_tree does (the first
// design's block_partials order), so the e partials are bitwise the first
// design's (ops/overlap.py energy_partials_plain(blocks=True)); m, an
// integer, is W - 2 popc of each word's sign bits, added over the warp.
// Sites past n (a padded last block) hold 0, as the first design's idle
// threads did.  n is a multiple of 4: the engine measures here only on the
// square and cubic checkerboards (even extents); a lattice with an odd
// extent measures with sweep_nb.cu's measure_nb.
template <int W, bool k3>
__global__ void __launch_bounds__(kThreads)
energy_partials_kernel(const int8_t* __restrict__ spins, const float* __restrict__ coup,
                       float* __restrict__ e_part, int32_t* __restrict__ m_part,
                       const EnergyWalk g) {
  constexpr int ND = k3 ? 3 : 2;
  constexpr int kWords = 8 / W;
  constexpr unsigned long long kSigns = 0x8080808080808080ull >> (64 - 8 * W);
  __shared__ __align__(16) float se[kThreads / 32][kThreads];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int gw = blockIdx.x * (kThreads / 32) + wid;
  if (gw >= g.warps) return;  // the whole warp: no barrier follows across warps
  const int rest = fast_div(gw, g.m[2], g.s[2]);
  const int blk = gw - rest * g.nb;
  const int dz = fast_div(rest, g.m[3], g.s[3]);
  const int set = rest - dz * g.sets;
  const int i0 = blk * kThreads + 8 * lane;
  const int cnt = g.n - i0;  // a multiple of 4: the lane's sites are 8, 4 or none
  float jc[8 * ND];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (4 * h < cnt) {
      const float4* p =
          reinterpret_cast<const float4*>(coup + (static_cast<size_t>(dz) * g.n + i0 + 4 * h) * ND);
#pragma unroll
      for (int u = 0; u < ND; ++u) {
        const float4 x = __ldg(p + u);
        jc[4 * ND * h + 4 * u] = x.x;
        jc[4 * ND * h + 4 * u + 1] = x.y;
        jc[4 * ND * h + 4 * u + 2] = x.z;
        jc[4 * ND * h + 4 * u + 3] = x.w;
      }
    }
  }
  // each word's neighbour words: the fast axis' next, the inner slow
  // axis' (kb) and the outer one's (ka, 3D)
  int kf[kWords], kb[kWords], ka[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int k = i0 / W + j;
    const int line = fast_div(k, g.m[0], g.s[0]);
    const int pos = k - line * g.wpl;
    kf[j] = pos + 1 < g.wpl ? k + 1 : k + 1 - g.wpl;
    int cb = line;
    int ca = 0;
    if (k3) {
      ca = fast_div(line, g.m[1], g.s[1]);
      cb = line - ca * g.Lb;
    }
    kb[j] = cb + 1 < g.Lb ? k + g.wpl : k + g.wpl - g.Lb * g.wpl;
    const int plane = g.Lb * g.wpl;
    ka[j] = k3 ? (ca + 1 < g.La ? k + plane : k + plane - g.nw) : 0;
  }
  float* xe = se[wid];
  for (int q = 0; q < g.per; ++q) {
    const size_t row = static_cast<size_t>(dz) * g.S + set * g.per + q;
    const int8_t* s = spins + row * g.n;
    // the lane's own words, and the fast, inner and outer neighbour words
    unsigned long long w[4][kWords] = {};
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      if (j * W < cnt) {
        w[0][j] = spin_word<W>(s, i0 / W + j);
        w[1][j] = spin_word<W>(s, kf[j]);
        w[2][j] = spin_word<W>(s, kb[j]);
        w[3][j] = k3 ? spin_word<W>(s, ka[j]) : 0;
      }
    }
    float e[8];
    int m = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const bool on = j * W < cnt;
      const unsigned long long w0 = w[0][j];
      const unsigned long long xf = w0 ^ ((w0 >> 8) | (w[1][j] << (8 * (W - 1))));
      const unsigned long long xb = w0 ^ w[2][j];
      const unsigned long long xa = w0 ^ w[3][j];
      if (on) m += W - 2 * __popcll(w0 & kSigns);
#pragma unroll
      for (int b = 0; b < W; ++b) {
        const int site = j * W + b;
        float x = 0.0f;
        if (k3) x = x + bond_term(xa, b, jc[ND * site]);
        x = x + bond_term(xb, b, jc[ND * site + ND - 2]);
        x = x + bond_term(xf, b, jc[ND * site + ND - 1]);
        e[site] = on ? x : 0.0f;
      }
    }
    reinterpret_cast<float4*>(xe + 8 * lane)[0] = make_float4(e[0], e[1], e[2], e[3]);
    reinterpret_cast<float4*>(xe + 8 * lane)[1] = make_float4(e[4], e[5], e[6], e[7]);
    __syncwarp();
    const float et = warp_tree(xe, lane);
    m = __reduce_add_sync(0xffffffffu, m);
    if (lane == 0) {
      e_part[row * g.nb + blk] = et;
      m_part[row * g.nb + blk] = m;
    }
    __syncwarp();  // the values are read before the next system writes them
  }
}

// The overlap moves' launch (ov_bonds, ov_mid, ov_finish, houdn_bonds,
// houdn_finish):
// x the realization's task sets, y the groups' blocks (at most 65535, a
// thread striding over the rest), z the realization.
inline dim3 ov_grid(const OvWalk& g) {
  const int blocks = ((g.n + 3) / 4 + kThreads - 1) / kThreads;
  return dim3(g.T * g.G / g.per, blocks < 65535 ? blocks : 65535, g.d);
}

inline bool ov_walk_ok(const OvWalk& g) {
  if (!(g.n >= 1 && (g.nd == 2 || g.nd == 3) && g.lf >= 1 && g.lb >= 1 && g.la >= 1 &&
        (g.nd == 3 || g.la == 1) &&
        static_cast<long long>(g.lf) * g.lb * g.la == g.n && g.n <= (1 << 30) &&
        g.T >= 1 && g.G >= 1 && g.S >= 1 && g.d >= 1 && g.per >= 1 && g.per <= kMaxPer &&
        (g.T * g.G) % g.per == 0 && static_cast<long long>(g.d) * g.T * g.G <= 65535 &&
        g.nb >= 1 && g.nb <= kMaxDirs && (g.axes == 0 || g.axes == 1) &&
        (!g.axes || g.nb == g.nd)))
    return false;
  for (int d = 0; d < g.nb; ++d) {
    const OvOffset& o = g.off[d];
    if (o.ra < 0 || o.ra >= g.la || o.rb < 0 || o.rb >= g.lb || o.rf < 0 || o.rf >= g.lf ||
        o.q != o.rf >> 2 || o.b != (o.rf & 3))
      return false;
  }
  return true;
}

// The kernels' form of a walk: 0 the 2D axes, 1 the 3D axes, 2 a table.
inline int ov_form(const OvWalk& g) { return g.axes ? g.nd - 2 : 2; }

inline bool aligned(const void* p, unsigned a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

}  // namespace

extern "C" {

// Blocks per system of energy_partials: the length of its partial rows.
int peapods_site_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Shared arguments: spins int8 [d, n_slots, n], sid int32 [d, n_slots],
// tasks int32 [d, n_temps, n_pairs, 2] (replica indices), coup f32 [d, n,
// nd], temps f32 [n_temps], scal int32 [n_tasks, 6] (s0, s1, s2, s3, seed,
// k), probes int32 [n_tasks, 64], keys (the bond draws' key words) int32
// [n_tasks, 2]; scratch state / state2 uint8 [n_tasks, n], parent / parent2
// int32 [n_tasks, n], seeds int32 [n_tasks].  kind: 1 Joerg, 2 CMR
// (Houdayer: peapods_houdn_*).  words: ops/overlap.py ov_words (host
// memory).  ov_bonds writes the state bytes (bit d: bond d) and the seeds,
// no parent: fk_link writes every parent.
int peapods_ov_bonds(const void* spins, const void* sid, const void* tasks,
                     const void* coup, const void* temps, const void* scal,
                     const void* probes, const void* keys, void* state, void* seeds,
                     const int* words, int kind, int wolff, void* stream) {
  const OvWalk g = make_ov_walk(words);
  if ((kind != kJorg && kind != kCmr) || !ov_walk_ok(g))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = g.lf % 4 == 0 && aligned(spins, 4) && aligned(state, 4) && aligned(coup, 16);
  using Kernel = void (*)(const int8_t*, const int32_t*, const int32_t*, const float*,
                          const float*, const int32_t*, const int32_t*, const int32_t*,
                          uint8_t*, int32_t*, const OvWalk, int);
  // [form][kind == CMR][vec]
  static const Kernel kernels[3][2][2] = {
      {{ov_bonds_kernel<2, kJorg, false>, ov_bonds_kernel<2, kJorg, true>},
       {ov_bonds_kernel<2, kCmr, false>, ov_bonds_kernel<2, kCmr, true>}},
      {{ov_bonds_kernel<3, kJorg, false>, ov_bonds_kernel<3, kJorg, true>},
       {ov_bonds_kernel<3, kCmr, false>, ov_bonds_kernel<3, kCmr, true>}},
      {{ov_bonds_kernel<kTable, kJorg, false>, ov_bonds_kernel<kTable, kJorg, true>},
       {ov_bonds_kernel<kTable, kCmr, false>, ov_bonds_kernel<kTable, kCmr, true>}}};
  const Kernel kernel = kernels[ov_form(g)][kind == kCmr][vec];
  kernel<<<ov_grid(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(coup),
      static_cast<const float*>(temps), static_cast<const int32_t*>(scal),
      static_cast<const int32_t*>(probes), static_cast<const int32_t*>(keys),
      static_cast<uint8_t*>(state), static_cast<int32_t*>(seeds), g, wolff);
  return static_cast<int>(cudaGetLastError());
}

// state: ov_bonds' state bytes; parent: fk_link's parents of its graph
// (each its root; the caller's blue labels where it asks for them); state2
// uint8 [n_tasks, n] out.  The Wolff seed is scal's (CMR's drawn one).
int peapods_ov_mid(const void* spins, const void* sid, const void* tasks, const void* coup,
                   const void* temps, const void* scal, const void* keys, const void* state,
                   const void* parent, void* state2, const int* words, int wolff,
                   void* stream) {
  const OvWalk g = make_ov_walk(words);
  if (!ov_walk_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = g.lf % 4 == 0 && aligned(spins, 4) && aligned(state, 4) &&
                   aligned(coup, 16) && aligned(parent, 16) && aligned(state2, 4);
  using Kernel = void (*)(const int8_t*, const int32_t*, const int32_t*, const float*,
                          const float*, const int32_t*, const int32_t*, const uint8_t*,
                          const int32_t*, uint8_t*, const OvWalk);
  // [form][wolff][vec]
  static const Kernel kernels[3][2][2] = {
      {{ov_mid_kernel<2, false, false>, ov_mid_kernel<2, false, true>},
       {ov_mid_kernel<2, true, false>, ov_mid_kernel<2, true, true>}},
      {{ov_mid_kernel<3, false, false>, ov_mid_kernel<3, false, true>},
       {ov_mid_kernel<3, true, false>, ov_mid_kernel<3, true, true>}},
      {{ov_mid_kernel<kTable, false, false>, ov_mid_kernel<kTable, false, true>},
       {ov_mid_kernel<kTable, true, false>, ov_mid_kernel<kTable, true, true>}}};
  const Kernel kernel = kernels[ov_form(g)][wolff != 0][vec];
  kernel<<<ov_grid(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(coup),
      static_cast<const float*>(temps), static_cast<const int32_t*>(scal),
      static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(state),
      static_cast<const int32_t*>(parent), static_cast<uint8_t*>(state2), g);
  return static_cast<int>(cudaGetLastError());
}

// The flips of a Joerg (kind 1) or CMR (kind 2) move: seeds int32
// [n_tasks] (ov_bonds'); state / parent: Joerg's state bytes and fk_link's
// flat parents of their graph, or CMR's state2 bytes and the grey graph's
// flat parents (the caller's labels where it asks for them).
int peapods_ov_finish(void* spins, const void* sid, const void* tasks, const void* scal,
                      const void* seeds, const void* state, const void* parent,
                      const int* words, int kind, int wolff, void* stream) {
  const OvWalk g = make_ov_walk(words);
  if ((kind != kJorg && kind != kCmr) || !ov_walk_ok(g))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = g.lf % 4 == 0 && aligned(spins, 4) && aligned(state, 4) &&
                   aligned(parent, 16);
  using Kernel = void (*)(int8_t*, const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, const uint8_t*, const int32_t*, const OvWalk);
  // [form][kind == CMR][wolff][vec]
  static const Kernel kernels[3][2][2][2] = {
      {{{ov_finish_kernel<2, kJorg, false, false>, ov_finish_kernel<2, kJorg, false, true>},
        {ov_finish_kernel<2, kJorg, true, false>, ov_finish_kernel<2, kJorg, true, true>}},
       {{ov_finish_kernel<2, kCmr, false, false>, ov_finish_kernel<2, kCmr, false, true>},
        {ov_finish_kernel<2, kCmr, true, false>, ov_finish_kernel<2, kCmr, true, true>}}},
      {{{ov_finish_kernel<3, kJorg, false, false>, ov_finish_kernel<3, kJorg, false, true>},
        {ov_finish_kernel<3, kJorg, true, false>, ov_finish_kernel<3, kJorg, true, true>}},
       {{ov_finish_kernel<3, kCmr, false, false>, ov_finish_kernel<3, kCmr, false, true>},
        {ov_finish_kernel<3, kCmr, true, false>, ov_finish_kernel<3, kCmr, true, true>}}},
      {{{ov_finish_kernel<kTable, kJorg, false, false>, ov_finish_kernel<kTable, kJorg, false, true>},
        {ov_finish_kernel<kTable, kJorg, true, false>, ov_finish_kernel<kTable, kJorg, true, true>}},
       {{ov_finish_kernel<kTable, kCmr, false, false>, ov_finish_kernel<kTable, kCmr, false, true>},
        {ov_finish_kernel<kTable, kCmr, true, false>, ov_finish_kernel<kTable, kCmr, true, true>}}}};
  const Kernel kernel = kernels[ov_form(g)][kind == kCmr][wolff != 0][vec];
  kernel<<<ov_grid(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(scal),
      static_cast<const int32_t*>(seeds), static_cast<const uint8_t*>(state),
      static_cast<const int32_t*>(parent), g);
  return static_cast<int>(cudaGetLastError());
}

// Houdayer(N), g_size even (2: the pair move): tasks int32 [d, n_temps,
// n_groups, g_size] (replica indices), probes int32 [n_tasks, 64], scal
// int32 [n_tasks, 6] (s0, s1 the SW salts); scratch as for the pair moves.
// houdn_bonds writes the state bytes and the seeds, no parent (words:
// ops/overlap.py ov_words with G = n_groups; a CTA's per g_size member
// slots, each below S <= 65536, staged as 2-byte entries).
int peapods_houdn_bonds(const void* spins, const void* sid, const void* tasks,
                        const void* probes, void* state, void* seeds, const int* words,
                        int g_size, int wolff, void* stream) {
  const OvWalk g = make_ov_walk(words);
  const size_t smem = static_cast<size_t>(g.per) * g_size * sizeof(uint16_t);
  if (!ov_walk_ok(g) || g_size < 2 || g_size % 2 || g.S > 65536 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = g.lf % 4 == 0 && aligned(spins, 4) && aligned(state, 4);
  using Kernel = void (*)(const int8_t*, const int32_t*, const int32_t*, const int32_t*,
                          uint8_t*, int32_t*, const OvWalk, int, int);
  // [form][vec]
  static const Kernel kernels[3][2] = {
      {houdn_bonds_kernel<2, false>, houdn_bonds_kernel<2, true>},
      {houdn_bonds_kernel<3, false>, houdn_bonds_kernel<3, true>},
      {houdn_bonds_kernel<kTable, false>, houdn_bonds_kernel<kTable, true>}};
  const Kernel kernel = kernels[ov_form(g)][vec];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ov_grid(g), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(probes),
      static_cast<uint8_t*>(state), static_cast<int32_t*>(seeds), g, g_size, wolff);
  return static_cast<int>(cudaGetLastError());
}

// The flips of a Houdayer(N) move: seeds int32 [n_tasks] (houdn_bonds');
// state / parent: houdn_bonds' state bytes and fk_link's flat parents of
// their graph (the caller's labels where it asks for them); words and the
// staged member slots as houdn_bonds' (with the CTA's task entries in
// static shared memory beside them).
int peapods_houdn_finish(void* spins, const void* sid, const void* tasks, const void* scal,
                         const void* state, const void* parent, const void* seeds,
                         const int* words, int g_size, int wolff, void* stream) {
  const OvWalk g = make_ov_walk(words);
  const size_t smem = static_cast<size_t>(g.per) * g_size * sizeof(uint16_t);
  if (!ov_walk_ok(g) || g_size < 2 || g_size % 2 || g.S > 65536 ||
      smem + sizeof(OvTasks) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = g.lf % 4 == 0 && aligned(spins, 4) && aligned(parent, 16) &&
                   aligned(state, 4);
  using Kernel = void (*)(int8_t*, const int32_t*, const int32_t*, const int32_t*,
                          const uint8_t*, const int32_t*, const int32_t*, const OvWalk, int);
  // [form][wolff][vec]
  static const Kernel kernels[3][2][2] = {
      {{houdn_finish_kernel<2, false, false>, houdn_finish_kernel<2, false, true>},
       {houdn_finish_kernel<2, true, false>, houdn_finish_kernel<2, true, true>}},
      {{houdn_finish_kernel<3, false, false>, houdn_finish_kernel<3, false, true>},
       {houdn_finish_kernel<3, true, false>, houdn_finish_kernel<3, true, true>}},
      {{houdn_finish_kernel<kTable, false, false>, houdn_finish_kernel<kTable, false, true>},
       {houdn_finish_kernel<kTable, true, false>, houdn_finish_kernel<kTable, true, true>}}};
  const Kernel kernel = kernels[ov_form(g)][wolff != 0][vec];
  if (smem + sizeof(OvTasks) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ov_grid(g), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(scal),
      static_cast<const uint8_t*>(state), static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(seeds), g, g_size);
  return static_cast<int>(cudaGetLastError());
}

// The table form (ops/overlap.py launch_event_table): the same arguments as
// the walk form's entry points, with fwd / bwd the lattice's int32 tables
// [n, nb] (device memory), state / state2 uint32 [n_tasks, n] (bit d: the
// bond to fwd[i, d]), flip uint8 [n_tasks, n] (CMR's blue flip), words
// ops/overlap.py ov_table_words (host memory); per the tasks a thread of
// the planned kernels (ops/overlap.py table_pers); ov_mid_table's parent
// the blue graph's least-site roots.
int peapods_ov_bonds_table(const void* spins, const void* sid, const void* tasks,
                           const void* coup, const void* temps, const void* scal,
                           const void* probes, const void* keys, const void* fwd, void* state,
                           void* seeds, const int* words, int kind, int wolff, int per,
                           void* stream) {
  const OvTable g = make_ov_table(words);
  if ((kind != kJorg && kind != kCmr) || !table_plan_ok(g, per) || !aligned(fwd, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (g.n % 4 == 0 && aligned(spins, 4)) | (g.n % 4 == 0 && aligned(state, 16)) << 1;
  ov_table_instance<0>(g.nb, kind, [&](auto kernel) {
    kernel<<<table_plan_grid(g, per), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
        static_cast<const int32_t*>(tasks), static_cast<const float*>(coup),
        static_cast<const float*>(temps), static_cast<const int32_t*>(scal),
        static_cast<const int32_t*>(probes), static_cast<const int32_t*>(keys),
        static_cast<const int32_t*>(fwd), static_cast<uint32_t*>(state),
        static_cast<int32_t*>(seeds), g, per, wolff, vec);
  });
  return static_cast<int>(cudaGetLastError());
}

// The CTAs an SM hold at once of a planned table kernel's instance (kernel
// 0 ov_bonds_table of move kind `variant`, 1 ov_mid_table Wolff where
// `variant`, 2 houdn_bonds_table with g > 254 where `variant`; nb offsets;
// smem bytes of dynamic shared memory, houdn_bonds_table's member rows) for
// ops/overlap.py
// ov_table_plan's waves; 0 for a kernel or kind it does not know.
int peapods_ov_table_ctas(int kernel, int nb, int variant, int smem) {
  if (kernel < 0 || kernel > 2 || (kernel == 0 && variant != kJorg && variant != kCmr) ||
      smem < 0 || smem > 232448)
    return 0;
  int ctas = 0;
  const size_t bytes = kernel == 1 ? mid_smem(nb, variant) : static_cast<size_t>(smem);
  const auto query = [&](auto k) {
    if (table_rows_smem(k, bytes) == cudaSuccess)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, k, kThreads, bytes);
  };
  if (kernel == 0)
    ov_table_instance<0>(nb, variant, query);
  else if (kernel == 1)
    ov_table_instance<1>(nb, variant, query);
  else
    ov_table_instance<2>(nb, variant, query);
  return ctas;
}

int peapods_ov_mid_table(const void* spins, const void* sid, const void* tasks, const void* coup,
                         const void* temps, const void* scal, const void* keys, const void* fwd,
                         const void* bwd, const void* state, const void* parent, void* state2,
                         void* flip, const int* words, int wolff, int per, void* stream) {
  const OvTable g = make_ov_table(words);
  if (!table_plan_ok(g, per) || !aligned(fwd, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (g.n % 4 == 0 && aligned(spins, 4)) |
                  (g.n % 4 == 0 && aligned(state, 16) && aligned(state2, 16) &&
                   aligned(parent, 16) && aligned(flip, 4))
                      << 1;
  const size_t smem = mid_smem(g.nb, wolff);
  cudaError_t e = cudaSuccess;
  ov_table_instance<1>(g.nb, wolff, [&](auto kernel) {
    e = table_rows_smem(kernel, smem);
    if (e == cudaSuccess)
      kernel<<<table_plan_grid(g, per), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
          static_cast<const int32_t*>(tasks), static_cast<const float*>(coup),
          static_cast<const float*>(temps), static_cast<const int32_t*>(scal),
          static_cast<const int32_t*>(keys), static_cast<const int32_t*>(fwd),
          static_cast<const int32_t*>(bwd), static_cast<const uint32_t*>(state),
          static_cast<const int32_t*>(parent), static_cast<uint32_t*>(state2),
          static_cast<uint8_t*>(flip), g, per, vec);
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// flip: ov_mid_table's (CMR), NULL for Joerg.
int peapods_ov_finish_table(void* spins, const void* sid, const void* tasks, const void* scal,
                            const void* seeds, const void* state, const void* parent,
                            const void* flip, const void* bwd, const int* words, int kind,
                            int wolff, void* stream) {
  const OvTable g = make_ov_table(words);
  if ((kind != kJorg && kind != kCmr) || !ov_table_ok(g) || (kind == kCmr && !flip))
    return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = void (*)(int8_t*, const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, const uint32_t*, const int32_t*, const uint8_t*,
                          const int32_t*, const OvTable);
  // [kind == CMR][wolff]
  static const Kernel kernels[2][2] = {
      {ov_finish_table_kernel<kJorg, false>, ov_finish_table_kernel<kJorg, true>},
      {ov_finish_table_kernel<kCmr, false>, ov_finish_table_kernel<kCmr, true>}};
  const Kernel kernel = kernels[kind == kCmr][wolff != 0];
  kernel<<<table_grid(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(scal),
      static_cast<const int32_t*>(seeds), static_cast<const uint32_t*>(state),
      static_cast<const int32_t*>(parent), static_cast<const uint8_t*>(flip),
      static_cast<const int32_t*>(bwd), g);
  return static_cast<int>(cudaGetLastError());
}

// Houdayer(N), g_size even: the CTA's per tasks' member rows staged as
// 8-byte entries.
int peapods_houdn_bonds_table(const void* spins, const void* sid, const void* tasks,
                              const void* probes, const void* fwd, void* state, void* seeds,
                              const int* words, int g_size, int wolff, int per, void* stream) {
  const OvTable g = make_ov_table(words);
  const size_t smem = static_cast<size_t>(per) * g_size * sizeof(long long);
  if (!table_plan_ok(g, per) || g_size < 2 || g_size % 2 || smem > 232448 || !aligned(fwd, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (g.n % 4 == 0 && aligned(spins, 4)) | (g.n % 4 == 0 && aligned(state, 16)) << 1;
  cudaError_t e = cudaSuccess;
  ov_table_instance<2>(g.nb, g_size > 254, [&](auto kernel) {
    e = table_rows_smem(kernel, smem);
    if (e == cudaSuccess)
      kernel<<<table_plan_grid(g, per), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
          static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(probes),
          static_cast<const int32_t*>(fwd), static_cast<uint32_t*>(state),
          static_cast<int32_t*>(seeds), g, g_size, wolff, per, vec);
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int peapods_houdn_finish_table(void* spins, const void* sid, const void* tasks, const void* scal,
                               const void* state, const void* parent, const void* seeds,
                               const void* bwd, const int* words, int g_size, int wolff,
                               void* stream) {
  const OvTable g = make_ov_table(words);
  const size_t smem = static_cast<size_t>(g_size) * sizeof(long long);
  if (!ov_table_ok(g) || g_size < 2 || g_size % 2 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = wolff ? houdn_finish_table_kernel<true> : houdn_finish_table_kernel<false>;
  const cudaError_t e = table_rows_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<table_grid(g), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(scal),
      static_cast<const uint32_t*>(state), static_cast<const int32_t*>(parent),
      static_cast<const int32_t*>(seeds), static_cast<const int32_t*>(bwd), g, g_size);
  return static_cast<int>(cudaGetLastError());
}

// e_part f32 / m_part int32 [d, S, peapods_site_blocks(n)] by system; spins
// int8 [d, S, n] (aligned to W bytes), coup f32 [d, n, nd] (16-byte
// aligned); words: ops/overlap.py energy_words (host memory).
int peapods_energy_partials(const void* spins, const void* coup, void* e_part, void* m_part,
                            const int* words, void* stream) {
  const EnergyWalk g = make_energy_walk(words);
  if ((g.W != 1 && g.W != 4 && g.W != 8) || g.n < 4 || g.n % 4 || g.nw * g.W != g.n ||
      g.wpl < 1 || g.Lb < 1 || g.La < 0 || g.wpl * g.Lb * (g.La ? g.La : 1) != g.nw ||
      g.nd != (g.La ? 3 : 2) || g.per < 1 || g.S < 1 || g.S % g.per ||
      g.sets * g.per != g.S || g.nb != peapods_site_blocks(g.n) || g.d < 1 ||
      static_cast<long long>(g.d) * g.sets * g.nb != g.warps ||
      reinterpret_cast<uintptr_t>(spins) % g.W != 0 || reinterpret_cast<uintptr_t>(coup) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kWarps = kThreads / 32;
  const unsigned grid = static_cast<unsigned>((g.warps + kWarps - 1) / kWarps);
  const bool k3 = g.La > 0;
  const auto kernel = k3 ? (g.W == 8   ? energy_partials_kernel<8, true>
                            : g.W == 4 ? energy_partials_kernel<4, true>
                                       : energy_partials_kernel<1, true>)
                         : (g.W == 8   ? energy_partials_kernel<8, false>
                            : g.W == 4 ? energy_partials_kernel<4, false>
                                       : energy_partials_kernel<1, false>);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(coup),
      static_cast<float*>(e_part), static_cast<int32_t*>(m_part), g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
