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

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

using namespace peapods;

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
// counts q_i q_i = 1, as the reference's roll over an extent of 1 does).  A
// CTA of kPairTableThreads threads takes `per` columns of one realization
// (blockIdx.x the column set, blockIdx.y the realization), their rows
// staged once in shared memory; a thread takes a site at a time, strided,
// its table row read once for the CTA's columns, whose counts it keeps in
// registers; each warp adds its counts (__reduce_add_sync), one warp adds
// the warps' and writes qs and ql of each column, converted once.  A first
// design: each neighbour's spins are byte loads, and the table is read
// again by every column set.
//
// What bounds it on the H100: bytes, the two systems of every column (2 n
// bytes) and the table (4 n nb bytes, read once a column set); at the 4D
// glass (10^4 sites, 4 forward offsets, 12 columns, 16 realizations) about
// 4.0 MB with the table counted once (chip_smoke.py phase 38).
constexpr int kPairTableThreads = 512;
constexpr int kPairTableMaxPer = 4;

__global__ void __launch_bounds__(kPairTableThreads)
pair_overlap_table_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                          const int32_t* __restrict__ fwd, int32_t* __restrict__ qs_out,
                          int32_t* __restrict__ ql_out, int out_stride, int n, int nb, int T,
                          int S, int per) {
  constexpr int kWarps = kPairTableThreads / 32;
  __shared__ long long ra[kPairTableMaxPer];
  __shared__ long long rb[kPairTableMaxPer];
  __shared__ int red[kWarps][2 * kPairTableMaxPer];
  const int z = blockIdx.y;
  const int c0 = blockIdx.x * per;
  if (threadIdx.x < per) {
    const int c = c0 + threadIdx.x;
    const int p = c / T;
    const int t = c - p * T;
    const long long s0 = static_cast<long long>(z) * S;
    ra[threadIdx.x] = (s0 + __ldg(sid + s0 + 2 * p * T + t)) * n;
    rb[threadIdx.x] = (s0 + __ldg(sid + s0 + (2 * p + 1) * T + t)) * n;
  }
  __syncthreads();
  int dq[kPairTableMaxPer] = {};
  int dl[kPairTableMaxPer] = {};
  for (int i = threadIdx.x; i < n; i += kPairTableThreads) {
    int di[kPairTableMaxPer];
#pragma unroll
    for (int k = 0; k < kPairTableMaxPer; ++k) {
      if (k >= per) break;
      di[k] = __ldg(spins + ra[k] + i) != __ldg(spins + rb[k] + i);
      dq[k] += di[k];
    }
    const int32_t* row = fwd + static_cast<size_t>(i) * nb;
    for (int d = 0; d < nb; ++d) {
      const int f = __ldg(row + d);
#pragma unroll
      for (int k = 0; k < kPairTableMaxPer; ++k) {
        if (k >= per) break;
        dl[k] += di[k] ^ (__ldg(spins + ra[k] + f) != __ldg(spins + rb[k] + f));
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kPairTableMaxPer; ++k) {
    if (k >= per) break;
    const int q = __reduce_add_sync(0xffffffffu, dq[k]);
    const int l = __reduce_add_sync(0xffffffffu, dl[k]);
    if (lane == 0) {
      red[wid][2 * k] = q;
      red[wid][2 * k + 1] = l;
    }
  }
  __syncthreads();
  if (wid != 0) return;
  for (int k = 0; k < per; ++k) {
    const int q = __reduce_add_sync(0xffffffffu, lane < kWarps ? red[lane][2 * k] : 0);
    const int l = __reduce_add_sync(0xffffffffu, lane < kWarps ? red[lane][2 * k + 1] : 0);
    if (lane == 0) {
      const size_t o = static_cast<size_t>(z) * out_stride + c0 + k;
      qs_out[o] = n - 2 * q;
      ql_out[o] = nb * n - 2 * l;
    }
  }
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

// The table form: fwd int32 [n, nb] (device memory); cols = n_pairs T
// columns a realization, `per` of them a CTA (ops/megapair.py
// pair_table_per); out rows as peapods_pair_overlap's.
int peapods_pair_overlap_table(const void* spins, const void* sid, const void* fwd, void* qs_out,
                               void* ql_out, int out_stride, int n, int nb, int d, int T,
                               int cols, int S, int per, void* stream) {
  if (n < 1 || nb < 1 || nb > 32 || static_cast<long long>(n) * nb >= (1LL << 31) || d < 1 ||
      d > 65535 || T < 1 || cols < 1 || cols % T || 2 * (cols / T) * T > S || per < 1 ||
      per > kPairTableMaxPer || cols % per || out_stride < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  pair_overlap_table_kernel<<<dim3(cols / per, d), kPairTableThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(fwd), static_cast<int32_t*>(qs_out),
      static_cast<int32_t*>(ql_out), out_stride, n, nb, T, S, per);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
