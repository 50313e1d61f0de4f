// Hopper kernel of the replica path's pair measurement: the spin overlap q
// and the link overlap q_l of every replica pair at every temperature.
//
// Replaces the pair measurement of the TPU pairs megakernel
// peapods_tpu/ops/pallas_megapair.py:_mp_kernel (:599-619; the reference's
// OverlapAccum.collect, statistics/overlap.rs:251-333), which sums products
// of resident partner regions of its slot tiles, and the per-sweep path's
// overlap_dots (peapods_tpu/ops/measure.py:36-53) on every lattice.  Here
// spins stay by system: column (p T + t) of realization d reads the systems
// at slots (2p) T + t and (2p + 1) T + t through sid, and sums over the
// lattice
//   qs = sum_i a_i b_i,   ql = sum_i q_i sum_o q_{i+o}
// with q_i = a_i b_i and o over the lattice's forward offsets (the axes on
// the square and cubic lattices; the triangular, BCC, FCC or any offset
// table), into the sweep's rows qs_out / ql_out [d, n_pairs T] (row stride
// out_stride).  It runs after the sweep's measurement and before pt_step,
// so it reads the sweep's final spins through the sid that the sweep ran
// with; it cannot ride in the odd pass itself, since a partner system is
// being updated by other blocks.  Four dimensions or more, or 7 to 32
// offsets, take pair_overlap_table (below), which reads the neighbours
// from the lattice's int32 table.
//
// The sums as disagreement bits: with spins in {-1, +1} and delta_i =
// [a_i != b_i], q_i = 1 - 2 delta_i and q_i q_j = 1 - 2 (delta_i XOR
// delta_j), so
//   qs = n - 2 sum_i delta_i,
//   ql = n_nb n - 2 sum over forward bonds (i, j) of (delta_i XOR delta_j),
// integer counts, exact in any order: bitwise ops/measure.py overlap_dots.
// A thread takes W-byte words of the two systems along the fast axis
// (W = 8 or 4 where the fast extent holds whole words; W = 1, a site at a
// time, where it does not): the sign bits of a ^ b are the word's delta
// bits (every spin byte is 0x01 or 0xff) and __popc counts them.  An
// offset's neighbour bits (pair_link_bits) are the word of the line that
// its slower components reach, shifted by its fast component's bytes: with
// the fast component f taken mod the fast extent as (q words, b bytes), the
// neighbours of word pos are bytes b.. of word pos + q and bytes ..b of
// word pos + q + 1 of that line, funnel-shifted together (b = 0: one
// word; the line's own word at q = 0 is the word itself).  A negative
// component wraps, as the triangular lattice's [1, -1] does: -1 is
// (wpl - 1 words, W - 1 bytes).  The line and the words step with one
// compare an axis from residues that the host reduced (ops/megapair.py
// pair_words), the line's coordinates come from multiply-shift divisions:
// no runtime division.  A table's offsets are a template parameter, so
// every offset's words are loaded before any is used.  Where the steps are
// the axes' (the square and cubic lattices), a form of their own takes
// them: the fast axis' (0 words, 1 byte) shifts the word itself with the
// line's next word, each slower axis reads the same word of the next line
// or plane, as before the tables, in fewer instructions than the general
// steps.
//
// The launch: a column's threads (tpc, a power of two from 32 to 1024, the
// fewest that take one word each: 64 at 8^3, 128 at 32^2, 512 at 16^3;
// ops/megapair.py pair_words) stride over its words; a CTA of max(128,
// tpc) threads holds 128 / tpc columns side by side.  Each warp adds its counts with __reduce_add_sync, and
// where a column has several warps their counts meet in shared memory
// behind one barrier and one warp adds them.
//
// What bounds it on the H100: the function reads the two systems of every
// column, 2 n bytes, and writes 8 bytes: 0.79 MB at config 4 (8^3 x 384
// columns), 6.3 MB at config 5 (16^3), 0.1 to 2 us at 3.35 TB/s (and
// mostly from L2: the colour pass has just written them).  The first
// design (a CTA of 256 threads a column, two runtime divisions a step and
// six steps a site in 3D, byte loads, each q recomputed nd + 1 times, a
// shared-memory tree of nine barriers) took 0.0147 ms at 16^3, 0.0043 at
// 8^3 and 0.0040 at config 1's 32^2, its divisions half of it at 16^3;
// the word design takes 0.0036, 0.0026 and 0.0024 (tools/probe_pairs.py,
// NVIDIA H100 80GB HBM3, 700 W), the launch and one chain of dependent
// loads (sid, then the words).  Bytes a word count: 1-byte words doubled it
// at 16^3, and so did one warp a column there.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

using namespace peapods;
namespace cg = cooperative_groups;

namespace {

constexpr int kPairMaxThreads = 1024;
constexpr int kPairMaxOffsets = 6;

// An offset's steps (ops/megapair.py pair_words): its outer slow component
// mod La (3D; 0 in 2D), its inner slow component mod Lb, and its fast
// component mod the fast extent as q words and b bytes.
struct PairOffset {
  int ra;
  int rb;
  int q;
  int b;
};

// The launch's geometry and plan (ops/megapair.py pair_words): a lattice of
// n sites in lines of wpl words along the fast axis; the lines run over an
// inner slow axis of extent Lb (2D: L0; 3D: L1) and, in 3D, an outer one of
// extent La (L0; 0 in 2D).  n / W words a system, tpc threads a column
// (2^lt), CTAs of `block` threads, n_nb forward offsets (axes: they step
// as the lattice's axes do); line = k / wpl, the outer coordinate = line /
// Lb and p = column / T as umulhi(q, m) >> s (fast_div).
struct PairWalk {
  int W;
  int n;
  int nw;
  int wpl;
  int Lb;
  int La;
  int nd;
  int T;
  int cols;
  int n_slots;
  int tpc;
  int lt;
  int block;
  int n_nb;
  int axes;
  uint32_t m[3];
  int s[3];
  PairOffset off[kPairMaxOffsets];
};

inline PairWalk make_pair_walk(const int* w) {
  PairWalk g;
  g.W = w[0];
  g.n = w[1];
  g.nw = w[2];
  g.wpl = w[3];
  g.Lb = w[4];
  g.La = w[5];
  g.nd = w[6];
  g.T = w[7];
  g.cols = w[8];
  g.n_slots = w[9];
  g.tpc = w[10];
  g.lt = w[11];
  g.block = w[12];
  g.n_nb = w[13];
  g.axes = w[14];
  for (int k = 0; k < 3; ++k) {
    g.m[k] = static_cast<uint32_t>(w[15 + 2 * k]);
    g.s[k] = w[16 + 2 * k];
  }
  for (int d = 0; d < kPairMaxOffsets; ++d) {
    g.off[d].ra = w[21 + 4 * d];
    g.off[d].rb = w[22 + 4 * d];
    g.off[d].q = w[23 + 4 * d];
    g.off[d].b = w[24 + 4 * d];
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

// The delta bits of word k of systems a and b: bit 8q + 7 set where site q
// of the word differs (the spins' sign bits).
template <int W>
__device__ __forceinline__ unsigned long long delta_bits(const int8_t* a, const int8_t* b,
                                                         int k) {
  typedef typename SpinWord<W>::T T;
  const T x = __ldg(reinterpret_cast<const T*>(a) + k) ^ __ldg(reinterpret_cast<const T*>(b) + k);
  return static_cast<unsigned long long>(x) & (0x8080808080808080ull >> (64 - 8 * W));
}

// sum over the forward bonds of word k's sites of (delta_i XOR delta_j),
// with m0 the word's delta bits: for each of the NB offsets, the word of
// the line its slower components reach, shifted by its fast component's
// bytes.  AXES: the offsets step as the lattice's axes (NB = nd), the fast
// axis the word shifted by a byte with the line's next word shifted in,
// each slower axis the same word of the next line or plane, one compare
// each.  Run on the axes, the table's general steps made the launch 4-22%
// slower at configs 1, 4 and 5 with every load issued first, 11-26% one
// offset after another (tools/probe_pairs.py, NVIDIA H100 80GB HBM3,
// 700 W): their instructions, not the loads' latency, cost it.  The
// lattice's neighbour step, in one place.
template <int W, int NB, bool AXES>
__device__ __forceinline__ int pair_link_bits(const int8_t* a, const int8_t* b, int k,
                                              unsigned long long m0, const PairWalk& g) {
  const int line = fast_div(k, g.m[0], g.s[0]);
  const int pos = k - line * g.wpl;
  const unsigned long long full = 0xffffffffffffffffull >> (64 - 8 * W);
  int cb = line;
  int ca = 0;
  if (g.La) {
    ca = fast_div(line, g.m[1], g.s[1]);
    cb = line - ca * g.Lb;
  }
  if constexpr (AXES) {
    const unsigned long long mf =
        delta_bits<W>(a, b, pos + 1 < g.wpl ? k + 1 : k + 1 - g.wpl);
    int x = __popcll(m0 ^ (((m0 >> 8) | (mf << (8 * (W - 1)))) & full));
    x += __popcll(m0 ^ delta_bits<W>(a, b, cb + 1 < g.Lb ? k + g.wpl
                                                            : k + g.wpl - g.Lb * g.wpl));
    if (NB == 3) {
      const int plane = g.Lb * g.wpl;
      x += __popcll(m0 ^ delta_bits<W>(a, b, ca + 1 < g.La ? k + plane : k + plane - g.nw));
    }
    return x;
  }
  unsigned long long w1[NB];
  unsigned long long w2[NB];
#pragma unroll
  for (int d = 0; d < NB; ++d) {
    const PairOffset o = g.off[d];
    int nb = cb + o.rb;
    if (nb >= g.Lb) nb -= g.Lb;
    if (g.La) {
      int na = ca + o.ra;
      if (na >= g.La) na -= g.La;
      nb += na * g.Lb;
    }
    const int row = nb * g.wpl;
    int p1 = pos + o.q;
    if (p1 >= g.wpl) p1 -= g.wpl;
    w1[d] = (o.ra | o.rb | o.q) == 0 ? m0 : delta_bits<W>(a, b, row + p1);
    w2[d] = W > 1 && o.b ? delta_bits<W>(a, b, row + (p1 + 1 < g.wpl ? p1 + 1 : 0)) : 0;
  }
  int x = 0;
#pragma unroll
  for (int d = 0; d < NB; ++d) {
    const int sh = g.off[d].b;
    const unsigned long long nbits =
        W > 1 && sh ? ((w1[d] >> (8 * sh)) | (w2[d] << (8 * (W - sh)))) & full : w1[d];
    x += __popcll(m0 ^ nbits);
  }
  return x;
}

// Column blockIdx.x * (block / tpc) + threadIdx.x / tpc of realization
// blockIdx.y: its threads' words, each warp's counts added by
// __reduce_add_sync, a column's warps' sums by its first warp.
template <int W, int NB, bool AXES>
__global__ void __launch_bounds__(kPairMaxThreads)
pair_overlap_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                    int32_t* __restrict__ qs_out, int32_t* __restrict__ ql_out,
                    int out_stride, const PairWalk g) {
  __shared__ int part[2][kPairMaxThreads / 32];
  const int d = blockIdx.y;
  const int x = threadIdx.x & (g.tpc - 1);  // the thread's place in its column
  const int col = blockIdx.x * (g.block >> g.lt) + (threadIdx.x >> g.lt);
  int nq = 0;
  int nx = 0;
  if (col < g.cols) {
    const int p = fast_div(col, g.m[2], g.s[2]);
    const int sa = col + p * g.T;  // slot (2p) T + t; its partner's is sa + T
    const int32_t* sd = sid + static_cast<size_t>(d) * g.n_slots;
    const int8_t* a = spins + (static_cast<size_t>(d) * g.n_slots + sd[sa]) * g.n;
    const int8_t* b = spins + (static_cast<size_t>(d) * g.n_slots + sd[sa + g.T]) * g.n;
    for (int k = x; k < g.nw; k += g.tpc) {
      const unsigned long long m0 = delta_bits<W>(a, b, k);
      nq += __popcll(m0);
      nx += pair_link_bits<W, NB, AXES>(a, b, k, m0, g);
    }
  }
  nq = __reduce_add_sync(0xffffffffu, nq);
  nx = __reduce_add_sync(0xffffffffu, nx);
  if (g.tpc > 32) {  // uniform across the launch
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      part[0][threadIdx.x >> 5] = nq;
      part[1][threadIdx.x >> 5] = nx;
    }
    __syncthreads();
    if (x < 32) {  // the column's first warp adds its warps' sums
      const int w0 = threadIdx.x >> 5;
      const bool on = lane < (g.tpc >> 5);
      nq = __reduce_add_sync(0xffffffffu, on ? part[0][w0 + lane] : 0);
      nx = __reduce_add_sync(0xffffffffu, on ? part[1][w0 + lane] : 0);
    }
  }
  if (x == 0 && col < g.cols) {
    qs_out[static_cast<size_t>(d) * out_stride + col] = g.n - 2 * nq;
    ql_out[static_cast<size_t>(d) * out_stride + col] = NB * g.n - 2 * nx;
  }
}

typedef void (*PairKernel)(const int8_t*, const int32_t*, int32_t*, int32_t*, int,
                           const PairWalk);

// The instance of W-byte words for the walk's offsets: the axes' form, or
// the table's for n_nb offsets (1 to kPairMaxOffsets).
template <int W>
PairKernel pair_kernel(const PairWalk& g) {
  if (g.axes) {
    return g.nd == 3 ? pair_overlap_kernel<W, 3, true> : pair_overlap_kernel<W, 2, true>;
  }
  switch (g.n_nb) {
    case 1: return pair_overlap_kernel<W, 1, false>;
    case 2: return pair_overlap_kernel<W, 2, false>;
    case 3: return pair_overlap_kernel<W, 3, false>;
    case 4: return pair_overlap_kernel<W, 4, false>;
    case 5: return pair_overlap_kernel<W, 5, false>;
    default: return pair_overlap_kernel<W, 6, false>;
  }
}

// pair_overlap's table form (ops/megapair.py pair_overlap_table): the
// lattices that PairWalk's words do not hold, four dimensions or more, or
// 7 to 32 forward offsets (ops/lattice.py Lattice.table), where the
// reference measures its pairs with overlap_dots' jnp form
// (peapods_tpu/ops/measure.py:36 on GridOps) in place of _mp_kernel's
// partner regions.  Each site's forward neighbours are read from the
// lattice's int32 table fwd [n, nb] (device memory), and the sums are the
// walk form's disagreement counts: qs = n - 2 sum_i delta_i and ql = nb n -
// 2 sum over bonds (i, fwd[i, d]) of (delta_i XOR delta_f), integers, so
// bitwise overlap_dots in any order (a self offset's bond, fwd[i, d] = i,
// counts q_i q_i = 1, as the reference's roll over an extent of 1 does).
//
// The launch (ops/megapair.py pair_table_plan): grid (C copies, d, groups)
// in thread-block clusters of C CTAs along x, one copy where staged.  A
// column group holds up to 32 kW columns, and a site's disagreement bits
// of the group are kW 32-bit words, bit c of word u the column 32 u + c.
// (1) CTA rank r of a cluster stages the words of its slice of the
// realization's sites, [r slice, (r + 1) slice), in its shared memory,
// made from the own spins of the group's systems, four sites a 4-byte load
// where n % 4 == 0.  (2) The cluster waits; the CTA counts the sites of
// its slice, four sites a thread at once: a site's
// table row is read once for every column of the group, and each bond's
// word is one load from the shared memory of the neighbour's slice owner
// (distributed shared memory, the owner by a multiply-shift division) and
// one xor.  The columns' counts are bytes of 8 kW counter words (byte b of
// word m of word u: the column 32 u + 8 b + m, x >> m & 0x01010101 added
// for every bond), flushed before a byte can overflow into each warp's
// per-column sums (two 16-bit lanes a word, __reduce_add_sync), which the
// CTA adds.  (3) The cluster's leader adds its CTAs' sums through
// distributed shared memory and writes qs and ql.  Past a cluster's shared
// memory (unstaged: no slices) each word is made from the spins where it
// is needed, and copy j of one-CTA clusters counts the lattice's share
// [j share, (j + 1) share); every CTA stores its sums in the scratch
// `part`, and the last CTA to finish (a counter a realization and group,
// 0 at the launch) adds them and writes.
//
// What bounds it on the H100: bytes, the two systems of every column (2 n
// bytes) and the table (4 n nb bytes) read once; at the 4D glass (10^4
// sites, 4 forward offsets, 12 columns, 16 realizations) 4.0 MB, 0.0012
// ms.  The first design (a CTA of 512 threads `per` <= 4 columns of one
// realization, 48 CTAs on the 132 SMs at the glass, each site's table row
// read again by every column set, every neighbour 2 per byte gathers from
// device memory) took 0.0366 ms at the glass, 0.0367 at Wolff houd4 (24
// columns) and 0.0266 at 16^3 with 9 offsets x 24 columns x 8; this one
// 0.0113, 0.0134 and 0.0095 (tools/probe_pairs.py, NVIDIA H100 80GB HBM3,
// 700 W), one cluster of 8 CTAs a realization (128 CTAs at the glass).
// Its own phases (%globaltimer stamps, the probe's t-clock) were at the
// glass about 0.6 us of set-up, 2.7 of staging (most of it the spin
// loads), 2.4 of counting and 1.4 of cluster waits, beside about 3 us of
// the launch itself.  Copies of the cluster that gave the launch a CTA an
// SM ran 5-18% slower: each stages every word again, and the copies hand
// their sums over through device memory; so a staged launch takes one.
constexpr int kPairTableSmem = 232448;  // the H100's most shared memory a CTA
constexpr int kPairTableThreads = 256;  // a CTA's threads at most
constexpr int kPairTableWarps = kPairTableThreads / 32;
constexpr int kStageBatch = 16;  // columns whose spin loads a thread issues together
constexpr int kSitesAhead = 4;   // sites a thread counts together (staged)

// The launch's words (ops/megapair.py pair_table_words, host memory): the
// lattice, the ladders and the plan.
struct PairTable {
  int n;        // sites
  int nb;       // forward offsets
  int T;        // temperatures
  int cols;     // columns of a realization, n_pairs T
  int S;        // slots of a realization
  int words;    // kW
  int groups;   // column groups of 32 kW
  int C;        // CTAs a cluster
  int copies;   // clusters a realization and group
  int slice;    // sites a CTA stages (0: unstaged)
  int share;    // sites a CTA counts of its slice (unstaged: of the lattice)
  int threads;  // a CTA's
  uint32_t m;   // fast_divisor of slice
  int s;
  int smem;     // dynamic shared memory a CTA
};

inline PairTable make_pair_table(const int* w) {
  PairTable g;
  g.n = w[0];
  g.nb = w[1];
  g.T = w[2];
  g.cols = w[3];
  g.S = w[4];
  g.words = w[5];
  g.groups = w[6];
  g.C = w[7];
  g.copies = w[8];
  g.slice = w[9];
  g.share = w[10];
  g.threads = w[11];
  g.m = static_cast<uint32_t>(w[12]);
  g.s = w[13];
  g.smem = w[14];
  return g;
}

// Dynamic shared memory: the slice's words [slice][kW], then the group's
// systems' row offsets, each warp's per-column sums of delta (qs) and of
// the bonds' xors (ql), the CTA's, and the last-copy flag
// (ops/megapair.py pair_table_smem).
template <int kW>
struct PairSmem {
  uint32_t* words;
  long long* ra;
  long long* rb;
  int* wsum;  // [kPairTableWarps][2][32 kW]
  int* tot;   // [2][32 kW]: qs counts, then ql counts
  int* flag;
  __device__ PairSmem(unsigned char* base, int slice) {
    words = reinterpret_cast<uint32_t*>(base);
    ra = reinterpret_cast<long long*>(base + static_cast<size_t>(slice) * 4 * kW);
    rb = ra + 32 * kW;
    wsum = reinterpret_cast<int*>(rb + 32 * kW);
    tot = wsum + kPairTableWarps * 64 * kW;
    flag = tot + 64 * kW;
  }
};

// The disagreement words of site j made from the spins: bit c of word u
// set where column 32 u + c's two systems (rows ra, rb) differ there (the
// unstaged form).
template <int kW>
__device__ __forceinline__ void site_words(uint32_t (&w)[kW], const int8_t* __restrict__ spins,
                                           const long long* ra, const long long* rb, int ncols,
                                           size_t j) {
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    w[u] = 0;
    const int cn = min(32, ncols - 32 * u);
    for (int c = 0; c < cn; ++c)
      w[u] |= static_cast<uint32_t>(__ldg(spins + ra[32 * u + c] + j) !=
                                    __ldg(spins + rb[32 * u + c] + j)) << c;
  }
}

// The xor of two systems' spins at sites i0 .. i0 + 3 (one byte a site,
// each a sign bit where they differ): two 4-byte loads (kVec), or cnt
// byte pairs.
template <bool kVec>
__device__ __forceinline__ uint32_t spin_xor(const int8_t* __restrict__ a,
                                             const int8_t* __restrict__ b, int cnt) {
  if (kVec)
    return __ldg(reinterpret_cast<const uint32_t*>(a)) ^
           __ldg(reinterpret_cast<const uint32_t*>(b));
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < cnt)
      x |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(a + k) ^ __ldg(b + k))) << (8 * k);
  return x;
}

// The disagreement words of the group's sites i0 .. i0 + cnt - 1 into out
// ([site][kW]), from the ncols columns' rows ra / rb.  For each batch of
// 16 columns every spin load is issued before the first is used; the
// xors' sign bits of 8 columns are gathered into one word by a shift each
// (byte s: site s's bits of the 8 columns, column c0 + o at bit o), whose
// bytes are merged into the sites' words.
template <int kW, bool kVec>
__device__ __forceinline__ void stage_group(uint32_t* out, const int8_t* __restrict__ spins,
                                            const long long* ra, const long long* rb,
                                            int ncols, int i0, int cnt) {
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    const int cn = min(32, ncols - 32 * u);
    for (int c0 = 0; c0 < cn; c0 += kStageBatch) {
      uint32_t x[kStageBatch];
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const int c = 32 * u + c0 + k;
        x[k] = c0 + k < cn ? spin_xor<kVec>(spins + ra[c] + i0, spins + rb[c] + i0, cnt) &
                                 0x80808080u
                           : 0u;
      }
      uint32_t za = 0, zb = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        za |= x[k] >> (7 - k);
        zb |= x[8 + k] >> (7 - k);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        w[s] |= (((za >> (8 * s)) & 0xFFu) | (((zb >> (8 * s)) & 0xFFu) << 8)) << c0;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s < cnt) out[s * kW + u] = w[s];
  }
}

// Adds a warp's column counters (8 kW words, byte b of word m of word u
// the column 32 u + 8 b + m) into the warp's sums ws [32 kW] and clears
// them: each word's bytes as two pairs of 16-bit lanes (a warp's 32 x 255
// fits one), every word's warp sum (__reduce_add_sync) issued before the
// first is used, then lane l adds column 32 u + l; no shared atomics.
template <int kW>
__device__ __forceinline__ void flush_counts(uint32_t (&cnt)[kW][8], int* ws) {
  const int lane = threadIdx.x & 31;
  const int lm = lane & 7;
  const int lb = lane >> 3;
#pragma unroll
  for (int u = 0; u < kW; ++u) {
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      lo[m] = __reduce_add_sync(0xffffffffu, cnt[u][m] & 0x00FF00FFu);
      hi[m] = __reduce_add_sync(0xffffffffu, (cnt[u][m] >> 8) & 0x00FF00FFu);
      cnt[u][m] = 0;
    }
    uint32_t v = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (m == lm) v = (lb & 1) ? hi[m] : lo[m];
    ws[32 * u + lane] += static_cast<int>((lb & 2) ? v >> 16 : v & 0xFFFFu);
  }
}

// The table entries of offsets d0 .. d0 + 3 of site i (i past nb): one
// 16-byte load where nb % 4 == 0.
__device__ __forceinline__ void row_step(int (&f)[4], const int32_t* __restrict__ fwd, int i,
                                         int nb, int d0, bool rows4) {
  const int32_t* row = fwd + static_cast<size_t>(i) * nb + d0;
  if (rows4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = d0 + j < nb ? __ldg(row + j) : i;
  }
}

// The bonds' xors of offsets d0 .. d0 + 3 below nb added to the column
// counters: byte b of word m of word u counts the column 32 u + 8 b + m.
template <int kW>
__device__ __forceinline__ void add_bonds(uint32_t (&cl)[kW][8], const uint32_t (&own)[kW],
                                          const uint32_t (&nw)[4][kW], int nb, int d0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (d0 + j >= nb) break;
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      const uint32_t x = own[u] ^ nw[j][u];
#pragma unroll
      for (int m = 0; m < 8; ++m) cl[u][m] += (x >> m) & 0x01010101u;
    }
  }
}

// The disagreement words of the four sites f: each one load from the
// shared memory of the site's slice owner in the cluster (the owner by the
// slice's multiply-shift division), or (unstaged) made from the spins.
template <int kW, bool kStaged>
__device__ __forceinline__ void neighbour_words(uint32_t (&nw)[4][kW], const int (&f)[4],
                                                const cg::cluster_group& cluster,
                                                const PairSmem<kW>& sh, const PairTable& g,
                                                const int8_t* __restrict__ spins, int ncols) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kStaged) {
      const int owner = fast_div(f[j], g.m, g.s);
      const uint32_t* p = cluster.map_shared_rank(sh.words, owner) + (f[j] - owner * g.slice) * kW;
#pragma unroll
      for (int u = 0; u < kW; ++u) nw[j][u] = p[u];
    } else {
      site_words<kW>(nw[j], spins, sh.ra, sh.rb, ncols, f[j]);
    }
  }
}

template <int kW, bool kStaged>
__global__ void __launch_bounds__(kPairTableThreads)
pair_overlap_table_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                          const int32_t* __restrict__ fwd, int32_t* __restrict__ qs_out,
                          int32_t* __restrict__ ql_out, int* __restrict__ part,
                          int* __restrict__ counter, int out_stride, const PairTable g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const PairSmem<kW> sh(smem_raw, kStaged ? g.slice : 0);
  const int z = blockIdx.y;
  const int grp = blockIdx.z;
  const int rank = static_cast<int>(cluster.block_rank());
  const int copy = blockIdx.x;  // unstaged: clusters of one CTA
  const int col0 = grp * 32 * kW;
  const int ncols = min(32 * kW, g.cols - col0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  if (tid < ncols) {  // the column's two systems, pair-major: p T + t
    const int c = col0 + tid;
    const int p = c / g.T;
    const int t = c - p * g.T;
    const long long s0 = static_cast<long long>(z) * g.S;
    sh.ra[tid] = (s0 + __ldg(sid + s0 + 2 * p * g.T + t)) * g.n;
    sh.rb[tid] = (s0 + __ldg(sid + s0 + (2 * p + 1) * g.T + t)) * g.n;
  }
  for (int c = tid; c < kPairTableWarps * 64 * kW; c += nthr) sh.wsum[c] = 0;
  __syncthreads();
  // (1) the slice's words
  int lo = 0, hi = g.n;
  if constexpr (kStaged) {
    lo = min(g.n, rank * g.slice);
    hi = min(g.n, lo + g.slice);
    // 4-byte spin loads (lo is a multiple of 4)
    const bool vec = (g.n & 3) == 0 && (reinterpret_cast<uintptr_t>(spins) & 3) == 0;
    for (int i0 = lo + 4 * tid; i0 < hi; i0 += 4 * nthr) {
      uint32_t* out = sh.words + static_cast<size_t>(i0 - lo) * kW;
      if (vec) {
        stage_group<kW, true>(out, spins, sh.ra, sh.rb, ncols, i0, 4);
      } else {
        stage_group<kW, false>(out, spins, sh.ra, sh.rb, ncols, i0, min(4, hi - i0));
      }
    }
  }
  cluster.sync();  // every slice's words written
  // (2) the counts of the slice (unstaged: of the copy's share)
  const int c_lo = kStaged ? lo : min(g.n, copy * g.share);
  const int c_hi = kStaged ? hi : min(g.n, c_lo + g.share);
  const int per_round = max(1, 255 / g.nb);  // sites a thread before a byte could overflow
  uint32_t cq[kW][8], cl[kW][8];
#pragma unroll
  for (int u = 0; u < kW; ++u)
#pragma unroll
    for (int m = 0; m < 8; ++m) cq[u][m] = cl[u][m] = 0;
  const bool rows4 = (g.nb & 3) == 0;
  // sites a thread counts together (one unstaged: its words are gathers)
  constexpr int kAhead = kStaged ? kSitesAhead : 1;
  for (int base = c_lo; base < c_hi; base += nthr * per_round) {  // uniform
    for (int k0 = 0; k0 < per_round; k0 += kAhead) {
      const int first = base + k0 * nthr + tid;
      if (first >= c_hi) break;
      // kAhead sites' own words, first table entries and neighbour
      // words, every load issued before the first count
      bool on[kAhead];
      uint32_t own[kAhead][kW];
      int f[kAhead][4];
      uint32_t nw[kAhead][4][kW];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int i = base + (k0 + q) * nthr + tid;
        on[q] = k0 + q < per_round && i < c_hi;
        const int s = on[q] ? i : first;
        if constexpr (kStaged) {
#pragma unroll
          for (int u = 0; u < kW; ++u) own[q][u] = sh.words[(s - lo) * kW + u];
        } else {
          site_words<kW>(own[q], spins, sh.ra, sh.rb, ncols, s);
        }
        row_step(f[q], fwd, s, g.nb, 0, rows4);
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
        neighbour_words<kW, kStaged>(nw[q], f[q], cluster, sh, g, spins, ncols);
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        if (!on[q]) continue;
#pragma unroll
        for (int u = 0; u < kW; ++u)
#pragma unroll
          for (int m = 0; m < 8; ++m) cq[u][m] += (own[q][u] >> m) & 0x01010101u;
        add_bonds<kW>(cl, own[q], nw[q], g.nb, 0);
        const int i = base + (k0 + q) * nthr + tid;
        for (int d0 = 4; d0 < g.nb; d0 += 4) {  // the offsets past the first four
          int fr[4];
          row_step(fr, fwd, i, g.nb, d0, rows4);
          uint32_t nr[4][kW];
          neighbour_words<kW, kStaged>(nr, fr, cluster, sh, g, spins, ncols);
          add_bonds<kW>(cl, own[q], nr, g.nb, d0);
        }
      }
    }
    int* ws = sh.wsum + (tid >> 5) * 64 * kW;
    flush_counts<kW>(cq, ws);
    flush_counts<kW>(cl, ws + 32 * kW);
  }
  __syncthreads();
  for (int c = tid; c < 64 * kW; c += nthr) {  // the CTA's sums, warp after warp
    int v = 0;
    for (int w = 0; w < (nthr >> 5); ++w) v += sh.wsum[w * 64 * kW + c];
    sh.tot[c] = v;
  }
  cluster.sync();  // every CTA's sums in its shared memory, no word read any more
  // (3) the realization's sums: t < ncols the qs count of column t, 32 kW
  // <= t < 32 kW + ncols the ql count
  const int t = tid;
  const bool mine = t < 64 * kW && (t & (32 * kW - 1)) < ncols;
  int v = 0;
  bool write = false;
  if (g.copies == 1) {  // the leader adds its cluster's sums
    if (rank == 0 && mine) {
      int part_r[8];  // every rank's load issued before the adds
#pragma unroll
      for (int r = 0; r < 8; ++r) part_r[r] = r < g.C ? cluster.map_shared_rank(sh.tot, r)[t] : 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) v += part_r[r];
      write = true;
    }
  } else {  // unstaged: every CTA's sums to the scratch; the last CTA adds them
    const int ctas = g.copies;
    const size_t row = static_cast<size_t>(z) * g.groups + grp;
    int* slot = part + row * ctas * 64 * kW;
    if (mine) slot[blockIdx.x * 64 * kW + t] = sh.tot[t];
    __threadfence();
    __syncthreads();
    if (tid == 0) *sh.flag = atomicAdd(counter + row, 1) == ctas - 1;
    __syncthreads();
    if (*sh.flag) {
      __threadfence();
      if (mine)
        for (int j = 0; j < ctas; ++j) v += __ldcg(slot + j * 64 * kW + t);
      write = mine;
    }
  }
  if (write) {
    const int c = t & (32 * kW - 1);
    const size_t o = static_cast<size_t>(z) * out_stride + col0 + c;
    if (t < 32 * kW) {
      qs_out[o] = g.n - 2 * v;
    } else {
      ql_out[o] = g.nb * g.n - 2 * v;
    }
  }
  if (g.copies == 1) cluster.sync();  // no CTA leaves while its leader reads its sums
}

typedef void (*PairTableKernel)(const int8_t*, const int32_t*, const int32_t*, int32_t*,
                                int32_t*, int*, int*, int, const PairTable);

PairTableKernel pair_table_kernel(int words, bool staged) {
  if (staged) {
    return words == 1   ? pair_overlap_table_kernel<1, true>
           : words == 2 ? pair_overlap_table_kernel<2, true>
                        : pair_overlap_table_kernel<4, true>;
  }
  return words == 1   ? pair_overlap_table_kernel<1, false>
         : words == 2 ? pair_overlap_table_kernel<2, false>
                      : pair_overlap_table_kernel<4, false>;
}

}  // namespace

extern "C" {

// spins int8 [d, n_slots, n] by system, sid int32 [d, n_slots] (slot r T +
// t); writes qs / ql of pair p at temperature t to [d, p T + t] of rows
// with stride out_stride, ql over the words' forward offsets.  words:
// ops/megapair.py pair_words (host memory); spins aligned to W bytes.
int peapods_pair_overlap(const void* spins, const void* sid, void* qs_out, void* ql_out,
                         int out_stride, int n_disorder, const int* words, void* stream) {
  const PairWalk g = make_pair_walk(words);
  const int cpc = g.tpc > 0 ? g.block / g.tpc : 0;  // columns a CTA
  if ((g.W != 1 && g.W != 4 && g.W != 8) || g.n < 1 || g.nw * g.W != g.n || g.wpl < 1 ||
      g.Lb < 1 || g.La < 0 || g.wpl * g.Lb * (g.La ? g.La : 1) != g.nw ||
      g.nd != (g.La ? 3 : 2) || g.n_nb < 1 || g.n_nb > kPairMaxOffsets ||
      (g.axes != 0 && (g.axes != 1 || g.n_nb != g.nd)) ||
      g.tpc < 32 || g.tpc > kPairMaxThreads || (1 << g.lt) != g.tpc ||
      g.block != (g.tpc > 128 ? g.tpc : 128) || cpc < 1 || g.cols < 1 || n_disorder < 1 ||
      n_disorder > 65535 || out_stride < g.cols ||
      reinterpret_cast<uintptr_t>(spins) % g.W != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < g.n_nb; ++d) {
    const PairOffset& o = g.off[d];
    if (o.ra < 0 || o.ra >= (g.La ? g.La : 1) || o.rb < 0 || o.rb >= g.Lb || o.q < 0 ||
        o.q >= g.wpl || o.b < 0 || o.b >= g.W)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((g.cols + cpc - 1) / cpc, n_disorder);
  const auto kernel = g.W == 8 ? pair_kernel<8>(g) : g.W == 4 ? pair_kernel<4>(g) : pair_kernel<1>(g);
  kernel<<<grid, g.block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<int32_t*>(qs_out), static_cast<int32_t*>(ql_out), out_stride, g);
  return static_cast<int>(cudaGetLastError());
}

// The table form: fwd int32 [n, nb] (device memory, 16-byte aligned);
// words: ops/megapair.py pair_table_words (host memory); part int32 [d,
// groups, copies, 64 kW] scratch and counter int32 [d groups] of zeros,
// where the plan has several copies (unstaged only); out rows as
// peapods_pair_overlap's.
int peapods_pair_overlap_table(const void* spins, const void* sid, const void* fwd,
                               void* qs_out, void* ql_out, void* part, void* counter,
                               int out_stride, int d, const int* words, void* stream) {
  const PairTable g = make_pair_table(words);
  const bool staged = g.slice > 0;
  const int span = staged ? g.slice : g.n;
  if (g.n < 1 || g.nb < 1 || g.nb > 32 || static_cast<long long>(g.n) * g.nb >= (1LL << 31) ||
      d < 1 || d > 65535 || g.T < 1 || g.cols < 1 || g.cols % g.T ||
      2 * (g.cols / g.T) * g.T > g.S || out_stride < g.cols ||
      (g.words != 1 && g.words != 2 && g.words != 4) ||
      g.groups != (g.cols + 32 * g.words - 1) / (32 * g.words) || g.groups > 65535 ||
      (g.C != 1 && g.C != 2 && g.C != 4 && g.C != 8) || (!staged && g.C != 1) ||
      (staged && (g.slice % 4 || static_cast<long long>(g.slice) * g.C < g.n ||
                  g.copies != 1)) ||
      g.copies < 1 || g.share < 1 || static_cast<long long>(g.share) * g.copies < span ||
      static_cast<long long>(g.C) * g.copies > (1LL << 31) - 1 || g.threads < 64 ||
      g.threads > kPairTableThreads || g.threads % 32 || g.threads < 2 * 32 * g.words ||
      g.smem > kPairTableSmem || reinterpret_cast<uintptr_t>(fwd) % 16 ||
      (g.copies > 1 && (part == nullptr || counter == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PairTableKernel kernel = pair_table_kernel(g.words, staged);
  // above 48 KB of dynamic shared memory a kernel must opt in, once
  static bool allowed[2][3] = {};
  bool& ok = allowed[staged][g.words >> 1];
  if (!ok) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPairTableSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ok = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.C * g.copies, d, g.groups);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(fwd), static_cast<int32_t*>(qs_out),
      static_cast<int32_t*>(ql_out), static_cast<int*>(part), static_cast<int*>(counter),
      out_stride, g);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
