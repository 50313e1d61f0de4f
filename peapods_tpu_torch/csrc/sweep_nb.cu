// Hopper kernels of the per-sweep path on coloured lattices: the triangular,
// BCC, FCC and cubic lattices, odd extents, 1D chains and any offset table,
// by their neighbour offsets and the lattice's greedy colouring.  Two forms:
// the walk form (up to six forward offsets in 1D, 2D or 3D; a 1D chain as
// [1, L]) finds neighbours from residues, the table form (4D and up, or 7
// to 32 offsets: sweep_nb_table, measure_nb_table) reads them from the
// lattice's int32 fwd / bwd tables [n, n_nb] in device memory.
//
// Replaces the TPU's
//   peapods_tpu/ops/pallas_sweep_tri.py:203/238/338 sweep_tri[_fused|_packed]
//     (body _kernel_body_tri :122, injected twins :378, :419),
//   peapods_tpu/ops/pallas_sweep3d.py:306/393 sweep_3d[_fused]
//     (kernels :280/:363, injected :458),
//   peapods_tpu/ops/pallas_sweep_diag.py:445/470 sweep_diag[_fused] (BCC /
//     FCC, injected :488) and :540/:562 sweep_gen[_fused] (any offset table
//     with a periodic colouring, injected :579).
// All four compute one function, mc_sweep (peapods_tpu/ops/sweep.py:74-123):
// a masked pass per colour of the greedy colouring; only the TPU's lane and
// sublane packing and its pre-shifted coupling grids differ between them.
// Here one kernel reads the neighbours from the offsets, as the Rust
// reference's flat neighbour tables do (spin-sim/src/mcmc/sweep.rs:51-97).
//
//   sweep_nb    one colour of every (realization, system) at the system's
//               temperature.  Thread g owns sites 4g .. 4g+3 (full-lattice
//               row-major index) of `per` systems of one realization
//               (ops/sweep.py systems_per), draws one Philox4x32-10 block a
//               system keyed by the sweep's two words, counter (system,
//               colour, g, 0), and updates the sites of the active colour:
//               site i takes word i % 4 (ops/rng.site_uniforms).  The field
//               adds, for each offset d in order, s(i + off_d) J[i, d] and
//               then s(i - off_d) J[i - off_d, d] (the backward bond read
//               from the forward couplings at the neighbour: the engine's
//               coup_bwd, bitwise), from 0, as local_fields (ops/sweep.py:
//               53-71) does; the rules are the reference's: Metropolis u <
//               (15/16) exp(min(-s h / (T/2), 0)), Gibbs -s h >= (T/2) ln(u
//               / (1 - u)).  A colour is an independent set, so no active
//               site reads a site that the pass writes.  A self offset (0
//               modulo every extent, as along an axis of extent 1) adds
//               nothing: a flip cannot change a self-bond's energy, which
//               the reference's field counts (ROADMAP.md section 3).  The
//               walk form knows one from its words (the reduced axis-0
//               component and both residues 0), the table form from a bit
//               mask of the host's; neither compares site indices.
//   measure_nb  per-block partials [d, n_systems, blocks] of e = sum_{i,d}
//               (s_i s(i + off_d)) J[i, d] and m = sum_i s_i, in a fixed
//               order with no float atomics; pt_step adds them in order.
//               It runs on sweeps that measure without an FK update: with
//               four colours or more a bond joins colours of several kinds,
//               so the energy cannot ride in the last pass as it does on the
//               checkerboard.  Self-bonds count here, as in the reference's
//               energy.  A lattice of n % 4 != 0 sites ends in a group of
//               fewer sites, whose absent sites add 0 (the plain version's
//               padding).
//
// Both kernels are templated on the number of offsets and the dimension
// (sweep_nb also on whether the lattice has a self offset, measure_nb on
// whether n % 4 != 0, so the lattices without either run code with no
// such test), and find their neighbours with no runtime division (the
// H100 has no integer divide instruction: a `/` or `%` by a runtime value
// is a sequence of about twenty): one multiply-shift division for a
// group's first site, a step for the next, and each axis of a neighbour
// wrapped by a residue and one compare (band.cuh, the whole lattice as a
// window without halo).
// Built with -fmad=false and no fast math, so the field, the acceptance and
// the (+-1) energies round exactly as the plain torch versions
// (ops/sweep.py, ops/energy.py).
//
// What bounds it on the H100: per active site, the int8 spin, 2 n_nb int8
// neighbours, 8 n_nb bytes of couplings (forward and backward, from one
// array) are read and one byte written; each pass reads the colour table.
// At config 2 (8 systems of 32 x 32, 4 colours) a pass moves about 40 KB: a
// few ns at HBM rate, so the launch is latency-bound (4 blocks of 256
// threads), and its time is one thread's chain of dependent steps.  The
// first design (a thread a group of one system, coordinates and wraps by
// runtime divisions and modulos, 6 + 12 n_nb a site, a runtime loop over
// the offsets whose loads waited for each other, a second coupling array)
// took 0.0129 ms a pass at FCC 16^3 x 8 and 0.0220 ms at 32^3 x 16; this
// one 0.0055 and 0.0077 (NVIDIA H100 80GB HBM3, 700 W; tools/probe_sweep.py
// times both designs).  The old design's divisions were most of its time
// (0.0062 and 0.0120 without them).  The template pays: a runtime count of
// offsets costs 3-36%; a grid of only the groups that hold the pass's
// colour would save at most 4% at FCC (a quarter of the grid: 0.0053), so
// the grid covers every group and the others return after one colour load.
//
// What bounds measure_nb: it reads every spin and the realization's forward
// couplings once and writes 8 bytes a block of 1024 sites: 0.00003-0.00004
// ms at the staged shapes (16^3 x 8 systems, 64^2 x 8), where the launch
// and one thread's chain of loads are its time.  The first design (a thread
// a group of one system, three runtime divisions and modulos for a site's
// coordinates and one a neighbour's axis, a runtime loop over the offsets,
// the couplings read again by every system, eight barriers a block's
// partial) took 0.0066-0.0078 ms a launch there and 0.0130 at 32^3 x 16.
// Now the neighbours come from residues, every load is issued before the
// adds, a bond's term is a sign flip of J, one warp pairs each partial, and
// where the launch is large a thread takes `per` systems and reads its
// couplings once (ops/energy.py measure_per): 0.0031-0.0039 and 0.0042 ms
// (CUDA events; NVIDIA H100 80GB HBM3, 700 W; tools/probe_measure.py times
// both designs).  Its divisions back cost 20-31% at the staged shapes.
// Spreading a group's sites over two or four lanes to fill the card, a
// group's own spins as one 4-byte load, and float products in place of the
// sign flips were each within 5% (the launch's chain, not its thread count
// or its instructions, is the time).
//
// The table form of sweep_nb (sweep_nb_table) replaces the same TPU kernels
// on the lattices past three dimensions or six offsets, sweep_gen above all
// (pallas_sweep_diag.py:540).  What bounds it: a pass reads every spin, its
// colour's sites' rows of the two int32 tables and both couplings, and
// writes its colour's spins: at the 4D +-J glass (16 realizations x 24
// systems of 10^4 sites, 4 offsets, 2 colours) about 8.5 MB, 0.0025 ms.
// The first design (a thread a group of four sites of one system, so every
// system read the tables and couplings again, 24 systems sharing each
// realization's couplings and all 384 the tables; a runtime loop over the
// offsets, each index load waiting for the last spin load; the group's
// sites of other colours idle) took about 0.090 ms a pass there, 0.0233 ms
// at 16^4 x 16 and 0.0092 ms at 16^3 with 13 offsets x 8 (NVIDIA H100 80GB
// HBM3, 700 W; chip_smoke.py phases 36 and 38).  This one takes a site of
// the pass's colour from the lattice's per-colour list (no idle thread; a
// Philox block a site and system, where the first design's group shared
// one between its sites of the colour) for up to eight systems of one
// realization, reads the site's table rows and couplings once for them,
// issues every load of a step of offsets before the adds (all of them at
// the unrolled counts 4, 5, 6, 9, 13), and shrinks its CTAs while a launch
// would hold fewer CTAs than the card has SMs (ops/sweep.py
// table_sweep_plan).
//
// The table form of measure_nb (measure_nb_table) replaces
// pallas_sweep_diag.py:562 sweep_gen_fused's measurement (and :306/:393's
// on the lattices past three dimensions or six offsets).  What bounds it:
// bytes, every spin, the realizations' couplings and the forward table
// read once and the partials written: 6.6 MB, 0.0020 ms at the 4D glass.
// The first design (a thread a group of four sites of one system, so each
// of a realization's 24 systems read its couplings and table rows again; a
// runtime loop over the offsets, each term two dependent loads) took
// 0.0716 ms a launch there, 0.0233 at 16^4 x 16, 0.0776 at 16^3 with 9
// offsets x 8 x 48 and 0.0091 at 16^3 with 13 offsets x 8 (NVIDIA H100
// 80GB HBM3, 700 W; tools/probe_measure.py).  This one carries
// measure_nb's design over: a thread takes a group of four sites for
// `per` systems of one realization (ops/energy.py table_measure_plan),
// reads the group's 16 nb contiguous bytes of table rows and of couplings
// once by 16-byte loads, issues every spin gather of a system before its
// first add (the unrolled counts 4, 5, 8, 9, 13; other counts in steps of
// four offsets, each system's four site sums in registers), and at four
// offsets asks ptxas for four CTAs an SM, so the glass's 480 CTAs run in
// one wave: 0.0131 ms at the glass (6.7x its bound), 0.0062 at 16^4, 0.0132
// at 16^3 with 9 offsets and 0.0050 with 13 (the probe, same card; a
// thread's chain of a system's gathers after its table rows is the time).
// The sign-bit form (one sign word a site of every system, staged by a
// cluster) was bitwise too but slower at every shape, 0.0257 ms at the
// glass.
// The order of adds is the first design's: bitwise.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "band.cuh"
#include "mega.cuh"

using namespace peapods;

namespace {

constexpr int kMaxPer = 8;  // systems a thread of measure_nb: its shared rows
constexpr int kMaxTableOffsets = 32;  // the table form's offsets: a bit each

// Whether forward offset d joins each site to itself: 0 modulo every extent
// (the host reduced its axis-0 component into [0, L0); both residues 0).
// In a kernel d must be known at compile time.
__host__ __device__ __forceinline__ bool self_offset(const BandWalk& g, int d) {
  return g.w.off[d][0] == 0 && g.res[d][0] == 0 && g.res[d][1] == 0;
}

// The neighbour of the site at (r, c1, c2) at +off_d (back = false) or
// -off_d on the whole periodic lattice, with no division: the host reduces
// off_d[0] into [0, L0) (ops/lattice.py Lattice.sweep_words), band.cuh's
// residues step axes 1 and 2; each axis wraps with one compare.  d must be
// known at compile time (an unrolled loop).
template <bool k3>
__device__ __forceinline__ int nb_site(const BandWalk& g, int r, int c1, int c2, int d,
                                       bool back) {
  const int L0 = g.w.L[0];
  int n0 = back ? r - g.w.off[d][0] : r + g.w.off[d][0];
  if (back && n0 < 0) n0 += L0;
  if (!back && n0 >= L0) n0 -= L0;
  int n1 = c1 + g.res[d][back ? 2 : 0];
  if (n1 >= g.w.L[1]) n1 -= g.w.L[1];
  if (!k3) return n0 * g.w.L[1] + n1;
  int n2 = c2 + g.res[d][back ? 3 : 1];
  if (n2 >= g.w.L[2]) n2 -= g.w.L[2];
  return (n0 * g.w.L[1] + n1) * g.w.L[2] + n2;
}

// One colour pass of sites 4g .. 4g+3 (thread g; blockIdx.x its block of
// kThreads groups) of systems blockIdx.y per .. + per - 1 of realization
// blockIdx.z, on a lattice of NB forward offsets, 3D or (k3 false) 2D.  The
// group's colours are one 32-bit load; a group with no site of the colour
// returns.  Its first site's coordinates are one multiply-shift division
// (band_coords), the next sites' a step each.  Per system: one Philox block,
// then for each active site every neighbour spin and coupling load (the
// backward coupling J[i - off_d, d] read from the forward couplings at the
// neighbour) before the field's adds, and the flips stored after the
// group's four decisions, so that no load waits for a store.  kSelf: the
// lattice has a self offset (the host finds it in the words), whose loads
// and adds each site skips; without one the kernel holds no such test.
template <int NB, bool k3, bool kSelf>
__global__ void __launch_bounds__(kThreads)
sweep_nb_kernel(int8_t* __restrict__ spins, const float* __restrict__ coup,
                const uint8_t* __restrict__ colours, const float* __restrict__ sys_temps,
                const int32_t* __restrict__ words, const BandWalk geo, int n_systems, int per,
                int colour, int gibbs) {
  const int n = geo.w.L[0] * geo.block;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int i0 = kSitesPerThread * g;
  if (i0 >= n) return;
  unsigned act = 0;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(colours) & 3) == 0) {
    const uint32_t cw = __ldg(reinterpret_cast<const uint32_t*>(colours) + g);
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k)
      act |= static_cast<unsigned>(((cw >> (8 * k)) & 0xFFu) == static_cast<uint32_t>(colour)) << k;
  } else {
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k)
      act |= static_cast<unsigned>(i0 + k < n && __ldg(colours + i0 + k) == colour) << k;
  }
  if (!act) return;
  int c1_0, c2_0;
  const int r_0 = band_coords(geo, i0, c1_0, c2_0);
  const int dz = blockIdx.z;
  const uint32_t k0 = static_cast<uint32_t>(words[2 * dz]);
  const uint32_t k1 = static_cast<uint32_t>(words[2 * dz + 1]);
  const float* J = coup + static_cast<size_t>(dz) * n * NB;
  for (int q = 0; q < per; ++q) {
    const int sys = blockIdx.y * per + q;
    const size_t row = static_cast<size_t>(dz) * n_systems + sys;
    int8_t* s = spins + row * n;
    const float T = sys_temps[row];
    const float half_t = T * 0.5f;
    const float inv_half_t = 1.0f / (T * 0.5f);
    const uint4 r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),
                                   static_cast<uint32_t>(colour), static_cast<uint32_t>(g), 0u);
    const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};
    unsigned flips = 0;
    float sv[kSitesPerThread];
    int r = r_0, c1 = c1_0, c2 = c2_0;
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      if (k) {  // the next site's coordinates
        if (!k3 || ++c2 == geo.w.L[2]) {
          c2 = 0;
          if (++c1 == geo.w.L[1]) {
            c1 = 0;
            ++r;
          }
        }
      }
      sv[k] = 0.0f;
      if (!((act >> k) & 1u)) continue;
      const int i = i0 + k;
      int8_t sn[2 * NB];
      float jn[2 * NB];
#pragma unroll
      for (int d = 0; d < NB; ++d) {
        if (kSelf && self_offset(geo, d)) continue;  // uniform: no load, no add
        const int f = nb_site<k3>(geo, r, c1, c2, d, false);
        const int b = nb_site<k3>(geo, r, c1, c2, d, true);
        sn[2 * d] = s[f];
        sn[2 * d + 1] = s[b];
        jn[2 * d] = __ldg(J + static_cast<size_t>(i) * NB + d);
        jn[2 * d + 1] = __ldg(J + static_cast<size_t>(b) * NB + d);
      }
      sv[k] = static_cast<float>(s[i]);
      float field = 0.0f;
#pragma unroll
      for (int e = 0; e < 2 * NB; ++e)
        if (!kSelf || !self_offset(geo, e >> 1))
          field = field + static_cast<float>(sn[e]) * jn[e];
      const float eng = -sv[k] * field;
      const float u = uniform24(w4[k]);
      bool flip;
      if (gibbs) {
        flip = eng >= half_t * logf(u / (1.0f - u));
      } else {
        flip = u < kKeep * expf(fminf(eng * inv_half_t, 0.0f));
      }
      flips |= static_cast<unsigned>(flip) << k;
    }
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k)
      if ((flips >> k) & 1u) s[i0 + k] = static_cast<int8_t>(-sv[k]);
  }
}

// (s_i s_j) J for spins s_i, s_j in {-1, +1}: J with its sign flipped
// where the spins differ (their sign bits), bitwise the product in floats.
__device__ __forceinline__ float bond_term(int8_t si, int8_t sj, float J) {
  const uint32_t flip = (static_cast<uint32_t>(static_cast<uint8_t>(si ^ sj)) >> 7) << 31;
  return __uint_as_float(__float_as_uint(J) ^ flip);
}

// The (e, m) partials of block blockIdx.x (groups of four sites 4 (256
// blockIdx.x + t), thread t) of systems blockIdx.y per .. + per - 1 of
// realization blockIdx.z, on a lattice of NB forward offsets, 3D or (k3
// false) 2D.  A thread's forward couplings (its four sites' NB each,
// contiguous in [d, n, NB]) are read once for its systems, by vector
// loads; its first site's coordinates are one multiply-shift division
// (band_coords), the next sites' a step each, and the forward neighbours
// residues and one compare an axis (nb_site), found once for all systems.
// Per system every spin load is issued before the first add.  A site's e
// is 0 + (s s_fwd) J[i, d] in offset order (bond_term), the group's four
// values added in order from 0, as the first design's thread added them;
// each system's 256 group sums are staged in shared memory and paired by
// one warp (warp_tree, the first design's block_partials order), so the
// partials are bitwise the first design's (ops/energy.py
// measure_nb_plain(blocks=True)).  kTail: n % 4 != 0, so the last group
// holds fewer sites (the absent ones add 0, the plain version's padding)
// and a realization's couplings past the first lose their 16-byte
// alignment (such groups read them one at a time); without a tail the
// kernel holds no such test.
template <int NB, bool k3, bool kTail>
__global__ void __launch_bounds__(kThreads)
measure_nb_kernel(const int8_t* __restrict__ spins, const float* __restrict__ coup,
                  const BandWalk geo, float* __restrict__ e_part,
                  int32_t* __restrict__ m_part, int n_systems, int per) {
  __shared__ float se[kMaxPer][kThreads];
  __shared__ int sm[kMaxPer][kThreads];
  const int n = geo.w.L[0] * geo.block;
  const int i0 = kSitesPerThread * (blockIdx.x * kThreads + threadIdx.x);
  const bool has = i0 < n;
  // the group's sites: 4, or fewer in the last group of a tail
  const int cnt = !has ? 0 : kTail ? min(kSitesPerThread, n - i0) : kSitesPerThread;
  const int dz = blockIdx.z;
  const int sys0 = blockIdx.y * per;
  float jc[kSitesPerThread * NB];
  int nbr[kSitesPerThread][NB];
  if (has) {
    const float* cg = coup + (static_cast<size_t>(dz) * n + i0) * NB;
    if (!kTail || (cnt == kSitesPerThread && reinterpret_cast<uintptr_t>(cg) % 16 == 0)) {
      // a whole group's 4 NB couplings, 16-byte aligned: every group
      // without a tail and, with one, every whole group of realization 0
      // (the couplings are aligned and i0 is a multiple of 4)
      const float4* cp = reinterpret_cast<const float4*>(cg);
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const float4 x = __ldg(cp + u);
        jc[4 * u] = x.x;
        jc[4 * u + 1] = x.y;
        jc[4 * u + 2] = x.z;
        jc[4 * u + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kSitesPerThread * NB; ++u)
        jc[u] = u < cnt * NB ? __ldg(cg + u) : 0.0f;
    }
    int c1, c2;
    int r = band_coords(geo, i0, c1, c2);
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      if (k) {  // the next site's coordinates
        if (!k3 || ++c2 == geo.w.L[2]) {
          c2 = 0;
          if (++c1 == geo.w.L[1]) {
            c1 = 0;
            ++r;
          }
        }
      }
#pragma unroll
      for (int d = 0; d < NB; ++d)
        nbr[k][d] = !kTail || k < cnt ? nb_site<k3>(geo, r, c1, c2, d, false) : i0;
    }
  }
  for (int q = 0; q < per; ++q) {
    const int8_t* s = spins + (static_cast<size_t>(dz) * n_systems + sys0 + q) * n;
    float acc = 0.0f;
    int m = 0;
    if (has) {
      int8_t sv[kSitesPerThread];
      int8_t sn[kSitesPerThread][NB];
#pragma unroll
      for (int k = 0; k < kSitesPerThread; ++k) {
        sv[k] = !kTail || k < cnt ? __ldg(s + i0 + k) : int8_t{0};
#pragma unroll
        for (int d = 0; d < NB; ++d) sn[k][d] = __ldg(s + nbr[k][d]);
      }
#pragma unroll
      for (int k = 0; k < kSitesPerThread; ++k) {
        if (kTail && k >= cnt) break;  // an absent site adds 0
        float e = 0.0f;
#pragma unroll
        for (int d = 0; d < NB; ++d) e = e + bond_term(sv[k], sn[k][d], jc[k * NB + d]);
        acc += e;
        m += sv[k];
      }
    }
    se[q][threadIdx.x] = acc;
    sm[q][threadIdx.x] = m;
  }
  __syncthreads();
  // warp v pairs systems v, v + 8, ... of the CTA
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < per; q += kThreads >> 5) {
    const float et = warp_tree(se[q], lane);
    const int mt = warp_tree(sm[q], lane);
    if (lane == 0) {
      const size_t o =
          (static_cast<size_t>(dz) * n_systems + sys0 + q) * gridDim.x + blockIdx.x;
      e_part[o] = et;
      m_part[o] = mt;
    }
  }
}

// The table form of sweep_nb (4D and up, or 7 to 32 offsets): one colour
// pass.  Thread t takes site i = sites[t], the t-th site of the pass's
// colour (ops/lattice.Lattice.colour_sites: the sites sorted by colour,
// made once a lattice and kept on the device, so that no thread holds no
// site of the colour), of systems blockIdx.y per .. + per - 1 of
// realization blockIdx.z (ops/sweep.py table_sweep_plan).  It reads site
// i's rows of the int32 tables fwd / bwd [n, n_nb] and both couplings of
// each offset (J[i, d] and J[bwd[i, d], d]) once for its systems, every
// index and coupling load of a step of offsets issued before the spin
// loads that need them, and accumulates each system's field in a register,
// offsets outermost so that each field adds, for each offset d in order,
// s[fwd[i, d]] J[i, d] and then s[bwd[i, d]] J[bwd[i, d], d], from 0, the
// offsets of self_mask left out.  Per system the walk form's Philox block
// (counter (system, colour, i / 4, 0), word i % 4) and rules, so a lattice
// that both forms take gives the same spins.  NB: the offsets, unrolled
// (the common counts), or 0: a runtime count in steps of four.
constexpr int kTablePer = 8;  // systems a thread of sweep_nb_table at most

// The field terms of offsets d0 .. d0 + K - 1 below nb and outside
// self_mask, for systems 0 .. per - 1 of s0 (n sites apart).
template <int K>
__device__ __forceinline__ void table_terms(float (&h)[kTablePer], const int8_t* s0, size_t n,
                                            int per, const int32_t* __restrict__ fi,
                                            const int32_t* __restrict__ bi,
                                            const float* __restrict__ J, int i, int nb, int d0,
                                            uint32_t self_mask) {
  int f[K], b[K];
  float jf[K], jb[K];
  bool on[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    on[k] = d < nb && !((self_mask >> d) & 1u);
    f[k] = on[k] ? __ldg(fi + d) : 0;
    b[k] = on[k] ? __ldg(bi + d) : 0;
    jf[k] = on[k] ? __ldg(J + static_cast<size_t>(i) * nb + d) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    jb[k] = on[k] ? __ldg(J + static_cast<size_t>(b[k]) * nb + d0 + k) : 0.0f;
#pragma unroll
  for (int q = 0; q < kTablePer; ++q) {
    if (q >= per) break;
    const int8_t* s = s0 + q * n;
    int8_t sf[K], sb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sf[k] = on[k] ? s[f[k]] : int8_t{0};
      sb[k] = on[k] ? s[b[k]] : int8_t{0};
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!on[k]) continue;
      h[q] = h[q] + static_cast<float>(sf[k]) * jf[k];
      h[q] = h[q] + static_cast<float>(sb[k]) * jb[k];
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
sweep_nb_table_kernel(int8_t* __restrict__ spins, const float* __restrict__ coup,
                      const int32_t* __restrict__ sites, int count,
                      const float* __restrict__ sys_temps, const int32_t* __restrict__ words,
                      const int32_t* __restrict__ fwd, const int32_t* __restrict__ bwd, int n,
                      int nb, uint32_t self_mask, int n_systems, int per, int colour, int gibbs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const int i = __ldg(sites + t);
  const int dz = blockIdx.z;
  const int sys0 = blockIdx.y * per;
  int8_t* s0 = spins + (static_cast<size_t>(dz) * n_systems + sys0) * n;
  const float* J = coup + static_cast<size_t>(dz) * n * nb;
  const int32_t* fi = fwd + static_cast<size_t>(i) * nb;
  const int32_t* bi = bwd + static_cast<size_t>(i) * nb;
  float h[kTablePer];
#pragma unroll
  for (int q = 0; q < kTablePer; ++q) h[q] = 0.0f;
  if constexpr (NB > 0) {
    table_terms<NB>(h, s0, n, per, fi, bi, J, i, NB, 0, self_mask);
  } else {
    for (int d0 = 0; d0 < nb; d0 += 4)
      table_terms<4>(h, s0, n, per, fi, bi, J, i, nb, d0, self_mask);
  }
  const uint32_t k0 = static_cast<uint32_t>(words[2 * dz]);
  const uint32_t k1 = static_cast<uint32_t>(words[2 * dz + 1]);
  const int w = i & 3;
#pragma unroll
  for (int q = 0; q < kTablePer; ++q) {
    if (q >= per) break;
    const int sys = sys0 + q;
    const float T = sys_temps[static_cast<size_t>(dz) * n_systems + sys];
    const float half_t = T * 0.5f;
    const float inv_half_t = 1.0f / (T * 0.5f);
    const uint4 r4 =
        philox4x32_10(k0, k1, static_cast<uint32_t>(sys), static_cast<uint32_t>(colour),
                      static_cast<uint32_t>(i >> 2), 0u);
    const uint32_t word = w == 0 ? r4.x : w == 1 ? r4.y : w == 2 ? r4.z : r4.w;
    int8_t* s = s0 + static_cast<size_t>(q) * n;
    const float sv = static_cast<float>(s[i]);
    const float eng = -sv * h[q];
    const float u = uniform24(word);
    bool flip;
    if (gibbs) {
      flip = eng >= half_t * logf(u / (1.0f - u));
    } else {
      flip = u < kKeep * expf(fminf(eng * inv_half_t, 0.0f));
    }
    if (flip) s[i] = static_cast<int8_t>(-sv);
  }
}

// The table form of measure_nb: the (e, m) partials of block blockIdx.x
// (groups of four sites 4 (256 blockIdx.x + t), thread t) of systems
// blockIdx.y per .. + per - 1 of realization blockIdx.z (ops/energy.py
// table_measure_plan), in the walk form's order: a site's e is 0 + (s
// s[fwd[i, d]]) J[i, d] over the offsets in order (self-bonds included, as
// the reference's energy), the group's values added from 0, each system's
// 256 group sums paired by one warp (warp_tree).  The group's rows of the
// int32 table and its couplings (16 nb contiguous bytes each) are read
// once for its systems, by 16-byte loads where the group is whole and
// aligned; every spin gather of a system (or, at the counts not unrolled,
// of a step of four offsets) is issued before the first add.  NB: the
// offsets, unrolled (the common counts), or 0: a runtime count in steps of
// four, each system's four site sums kept in registers across the steps.
// kTail: n % 4 != 0, as measure_nb_kernel's.

// A group's own spins in one system: one 4-byte load, or (kTail) its
// first cnt bytes, the absent ones 0.
template <bool kTail>
__device__ __forceinline__ uint32_t group_spins(const int8_t* __restrict__ s, int i0, int cnt) {
  if (!kTail) return __ldg(reinterpret_cast<const uint32_t*>(s + i0));
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k)
    if (k < cnt) w |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(s + i0 + k))) << (8 * k);
  return w;
}

// The terms of offsets d0 .. d0 + K - 1 (those below nb) of the group's
// first cnt sites in one system s, whose own spins are the bytes of own:
// every neighbour's spin gathered first, then each site's e[k] adds its
// terms in offset order.
template <int K>
__device__ __forceinline__ void group_terms(float (&e)[kSitesPerThread], uint32_t own,
                                            const int8_t* __restrict__ s,
                                            const int (&f)[kSitesPerThread][K],
                                            const float (&jc)[kSitesPerThread][K], int nb,
                                            int d0, int cnt) {
  int8_t sn[kSitesPerThread][K];
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k)
#pragma unroll
    for (int j = 0; j < K; ++j) sn[k][j] = __ldg(s + f[k][j]);
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    if (k >= cnt) break;  // an absent site adds 0
    const int8_t si = static_cast<int8_t>(own >> (8 * k));
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (d0 + j < nb) e[k] = e[k] + bond_term(si, sn[k][j], jc[k][j]);
  }
}

// The sum of the group's own spins (the absent ones are 0).
__device__ __forceinline__ int group_mag(uint32_t own) {
  return static_cast<int8_t>(own) + static_cast<int8_t>(own >> 8) +
         static_cast<int8_t>(own >> 16) + static_cast<int8_t>(own >> 24);
}

// At 4 offsets and no tail four CTAs an SM (64 registers, no spill: the
// glass's 480 CTAs in one wave); elsewhere one, which ptxas schedules
// with more loads in flight than with no minimum.
template <int NB, bool kTail>
__global__ void __launch_bounds__(kThreads, NB == 4 && !kTail ? 4 : 1)
measure_nb_table_kernel(const int8_t* __restrict__ spins, const float* __restrict__ coup,
                        const int32_t* __restrict__ fwd, int n, int nb,
                        float* __restrict__ e_part, int32_t* __restrict__ m_part,
                        int n_systems, int per) {
  __shared__ float se[kMaxPer][kThreads];
  __shared__ int sm[kMaxPer][kThreads];
  const int i0 = kSitesPerThread * (blockIdx.x * kThreads + threadIdx.x);
  const bool has = i0 < n;
  // the group's sites: 4, or fewer in the last group of a tail
  const int cnt = !has ? 0 : kTail ? min(kSitesPerThread, n - i0) : kSitesPerThread;
  const int dz = blockIdx.z;
  const int sys0 = blockIdx.y * per;
  const int8_t* s0 = spins + (static_cast<size_t>(dz) * n_systems + sys0) * n;
  const float* cg = coup + (static_cast<size_t>(dz) * n + (has ? i0 : 0)) * nb;
  const int32_t* rg = fwd + static_cast<size_t>(has ? i0 : 0) * nb;
  if constexpr (NB > 0) {
    int f[kSitesPerThread][NB];
    float jc[kSitesPerThread][NB];
    if (has) {
      if (!kTail || cnt == kSitesPerThread) {
        // the group's 4 NB table entries: i0 NB is a multiple of 4, so
        // 16-byte aligned
        const int4* rp = reinterpret_cast<const int4*>(rg);
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const int4 x = __ldg(rp + u);
          f[(4 * u) / NB][(4 * u) % NB] = x.x;
          f[(4 * u + 1) / NB][(4 * u + 1) % NB] = x.y;
          f[(4 * u + 2) / NB][(4 * u + 2) % NB] = x.z;
          f[(4 * u + 3) / NB][(4 * u + 3) % NB] = x.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k)
#pragma unroll
          for (int j = 0; j < NB; ++j) f[k][j] = k < cnt ? __ldg(rg + k * NB + j) : i0;
      }
      if (!kTail || (cnt == kSitesPerThread && reinterpret_cast<uintptr_t>(cg) % 16 == 0)) {
        // a whole group's couplings, 16-byte aligned: every group without a
        // tail and, with one, the whole groups of aligned realizations
        const float4* cp = reinterpret_cast<const float4*>(cg);
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          const float4 x = __ldg(cp + u);
          jc[(4 * u) / NB][(4 * u) % NB] = x.x;
          jc[(4 * u + 1) / NB][(4 * u + 1) % NB] = x.y;
          jc[(4 * u + 2) / NB][(4 * u + 2) % NB] = x.z;
          jc[(4 * u + 3) / NB][(4 * u + 3) % NB] = x.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k)
#pragma unroll
          for (int j = 0; j < NB; ++j) jc[k][j] = k < cnt ? __ldg(cg + k * NB + j) : 0.0f;
      }
    }
    for (int q = 0; q < per; ++q) {
      float acc = 0.0f;
      int m = 0;
      if (has) {
        const int8_t* s = s0 + static_cast<size_t>(q) * n;
        const uint32_t own = group_spins<kTail>(s, i0, cnt);
        float e[kSitesPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
        group_terms<NB>(e, own, s, f, jc, NB, 0, cnt);
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k)
          if (k < cnt) acc += e[k];
        m = group_mag(own);
      }
      se[q][threadIdx.x] = acc;
      sm[q][threadIdx.x] = m;
    }
  } else {
    float e[kMaxPer][kSitesPerThread];
    uint32_t own[kMaxPer];
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q) {
#pragma unroll
      for (int k = 0; k < kSitesPerThread; ++k) e[q][k] = 0.0f;
      own[q] = 0;
    }
    if (has) {
#pragma unroll
      for (int q = 0; q < kMaxPer; ++q) {
        if (q >= per) break;
        own[q] = group_spins<kTail>(s0 + static_cast<size_t>(q) * n, i0, cnt);
      }
      for (int d0 = 0; d0 < nb; d0 += 4) {
        int f[kSitesPerThread][4];
        float jc[kSitesPerThread][4];
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool on = k < cnt && d0 + j < nb;
            f[k][j] = on ? __ldg(rg + k * nb + d0 + j) : i0;
            jc[k][j] = on ? __ldg(cg + k * nb + d0 + j) : 0.0f;
          }
#pragma unroll
        for (int q = 0; q < kMaxPer; ++q) {
          if (q >= per) break;
          group_terms<4>(e[q], own[q], s0 + static_cast<size_t>(q) * n, f, jc, nb, d0, cnt);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxPer; ++q) {
      if (q >= per) break;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kSitesPerThread; ++k)
        if (k < cnt) acc += e[q][k];
      se[q][threadIdx.x] = acc;
      sm[q][threadIdx.x] = group_mag(own[q]);
    }
  }
  __syncthreads();
  // warp v pairs systems v, v + 8, ... of the CTA
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < per; q += kThreads >> 5) {
    const float et = warp_tree(se[q], lane);
    const int mt = warp_tree(sm[q], lane);
    if (lane == 0) {
      const size_t o =
          (static_cast<size_t>(dz) * n_systems + sys0 + q) * gridDim.x + blockIdx.x;
      e_part[o] = et;
      m_part[o] = mt;
    }
  }
}

}  // namespace

extern "C" {

// Blocks per system of sweep_nb and measure_nb: the partial-sum row length.
int peapods_nb_blocks(int n) {
  const int groups = (n + kSitesPerThread - 1) / kSitesPerThread;
  return (groups + kThreads - 1) / kThreads;
}

// One colour pass of every (realization, system).  spins int8 [d, n_systems,
// n]; coup f32 [d, n, n_nb] (forward couplings); colours uint8 [n];
// sys_temps f32 [d, n_systems]; words int32 [d, 2]; walk: the lattice as a
// band.cuh BandWalk (ops/lattice.py Lattice.sweep_words, host memory); per
// the systems a thread (a divisor of n_systems: ops/sweep.py systems_per).
int peapods_sweep_nb(void* spins, const void* coup, const void* colours, const void* sys_temps,
                     const void* words, const int* walk, int n_disorder, int n_systems,
                     int colour, int gibbs, int per, void* stream) {
  const BandWalk g = make_band_walk(walk);
  const long long n = static_cast<long long>(g.w.L[0]) * g.block;
  const int nb = g.w.n_nb;
  if (n_disorder < 1 || n_disorder > 65535 || n_systems < 1 || per < 1 || n_systems % per ||
      n_systems / per > 65535 || nb < 1 || nb > kMaxOffsets || n < 1 || n > (1LL << 31) - 4 ||
      g.hl != g.w.L[0] || g.halo != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(peapods_nb_blocks(static_cast<int>(n)), n_systems / per, n_disorder);
  const bool k3 = g.w.L[2] > 1;
  bool self = false;
  for (int d = 0; d < nb; ++d) self = self || self_offset(g, d);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int8_t*>(spins), static_cast<const float*>(coup),
        static_cast<const uint8_t*>(colours), static_cast<const float*>(sys_temps),
        static_cast<const int32_t*>(words), g, n_systems, per, colour, gibbs);
  };
  auto pick = [&](auto nb_c) {
    constexpr int NB = decltype(nb_c)::value;
    if (k3) {
      self ? go(sweep_nb_kernel<NB, true, true>) : go(sweep_nb_kernel<NB, true, false>);
    } else {
      self ? go(sweep_nb_kernel<NB, false, true>) : go(sweep_nb_kernel<NB, false, false>);
    }
  };
  switch (nb) {
    case 1: pick(std::integral_constant<int, 1>{}); break;
    case 2: pick(std::integral_constant<int, 2>{}); break;
    case 3: pick(std::integral_constant<int, 3>{}); break;
    case 4: pick(std::integral_constant<int, 4>{}); break;
    case 5: pick(std::integral_constant<int, 5>{}); break;
    default: pick(std::integral_constant<int, 6>{}); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// e_part f32 / m_part int32 [d, n_systems, peapods_nb_blocks(n)].  spins
// int8 [d, n_systems, n] (any n >= 1); coup f32 [d, n, n_nb] (forward
// couplings, 16-byte aligned); walk: as peapods_sweep_nb's; per the
// systems a thread (a divisor of n_systems, at most kMaxPer; ops/energy.py
// measure_per).
int peapods_measure_nb(const void* spins, const void* coup, const int* walk, void* e_part,
                       void* m_part, int n_disorder, int n_systems, int per, void* stream) {
  const BandWalk g = make_band_walk(walk);
  const long long n = static_cast<long long>(g.w.L[0]) * g.block;
  const int nb = g.w.n_nb;
  if (n_disorder < 1 || n_disorder > 65535 || n_systems < 1 || per < 1 || per > kMaxPer ||
      n_systems % per || n_systems / per > 65535 || nb < 1 || nb > kMaxOffsets || n < 1 ||
      n > (1LL << 31) - 4 || g.hl != g.w.L[0] || g.halo != 0 ||
      reinterpret_cast<uintptr_t>(coup) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(peapods_nb_blocks(static_cast<int>(n)), n_systems / per, n_disorder);
  const bool k3 = g.w.L[2] > 1;
  const bool tail = n % 4 != 0;
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(spins), static_cast<const float*>(coup), g,
        static_cast<float*>(e_part), static_cast<int32_t*>(m_part), n_systems, per);
  };
  auto pick = [&](auto nb_c) {
    constexpr int NB = decltype(nb_c)::value;
    if (k3) {
      tail ? go(measure_nb_kernel<NB, true, true>) : go(measure_nb_kernel<NB, true, false>);
    } else {
      tail ? go(measure_nb_kernel<NB, false, true>) : go(measure_nb_kernel<NB, false, false>);
    }
  };
  switch (nb) {
    case 1: pick(std::integral_constant<int, 1>{}); break;
    case 2: pick(std::integral_constant<int, 2>{}); break;
    case 3: pick(std::integral_constant<int, 3>{}); break;
    case 4: pick(std::integral_constant<int, 4>{}); break;
    case 5: pick(std::integral_constant<int, 5>{}); break;
    default: pick(std::integral_constant<int, 6>{}); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The table form (ops/lattice.Lattice.table).  One colour pass of every
// (realization, system): spins int8 [d, n_systems, n]; coup f32 [d, n,
// n_nb]; sites int32 [n], the sites sorted by colour, the pass's colour's
// count of them from start; sys_temps f32 [d, n_systems]; words int32 [d,
// 2]; fwd, bwd int32 [n, n_nb] (device memory); self_mask: bit d for a self
// offset d; per: the systems a thread (a divisor of n_systems, at most
// kTablePer); threads: a CTA's (32 to kThreads, a multiple of 32).
int peapods_sweep_nb_table(void* spins, const void* coup, const void* sites,
                           const void* sys_temps, const void* words, const void* fwd,
                           const void* bwd, int n, int nb, int self_mask, int n_disorder,
                           int n_systems, int colour, int start, int count, int gibbs, int per,
                           int threads, void* stream) {
  if (n_disorder < 1 || n_disorder > 65535 || n_systems < 1 || per < 1 || per > kTablePer ||
      n_systems % per || n_systems / per > 65535 || nb < 1 || nb > kMaxTableOffsets || n < 1 ||
      n > (1 << 30) || start < 0 || count < 1 || start + count > n || threads < 32 ||
      threads > kThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((count + threads - 1) / threads, n_systems / per, n_disorder);
  auto go = [&](auto kernel) {
    kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int8_t*>(spins), static_cast<const float*>(coup),
        static_cast<const int32_t*>(sites) + start, count, static_cast<const float*>(sys_temps),
        static_cast<const int32_t*>(words), static_cast<const int32_t*>(fwd),
        static_cast<const int32_t*>(bwd), n, nb, static_cast<uint32_t>(self_mask), n_systems,
        per, colour, gibbs);
  };
  switch (nb) {
    case 4: go(sweep_nb_table_kernel<4>); break;
    case 5: go(sweep_nb_table_kernel<5>); break;
    case 6: go(sweep_nb_table_kernel<6>); break;
    case 9: go(sweep_nb_table_kernel<9>); break;
    case 13: go(sweep_nb_table_kernel<13>); break;
    default: go(sweep_nb_table_kernel<0>); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// e_part f32 / m_part int32 [d, n_systems, peapods_nb_blocks(n)] of spins
// int8 [d, n_systems, n] with couplings f32 [d, n, n_nb] (16-byte aligned)
// on the table fwd int32 [n, n_nb] (device memory, 16-byte aligned); per
// the systems a thread (a divisor of n_systems, at most kMaxPer;
// ops/energy.py table_measure_plan).
int peapods_measure_nb_table(const void* spins, const void* coup, const void* fwd,
                             void* e_part, void* m_part, int n, int nb, int n_disorder,
                             int n_systems, int per, void* stream) {
  if (n_disorder < 1 || n_disorder > 65535 || n_systems < 1 || per < 1 || per > kMaxPer ||
      n_systems % per || n_systems / per > 65535 || nb < 1 || nb > kMaxTableOffsets ||
      n < 1 || n > (1 << 30) || reinterpret_cast<uintptr_t>(coup) % 16 ||
      reinterpret_cast<uintptr_t>(fwd) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(peapods_nb_blocks(n), n_systems / per, n_disorder);
  // the byte path where a system's row is not 4-byte aligned
  const bool tail = n % 4 != 0 || reinterpret_cast<uintptr_t>(spins) % 4 != 0;
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(spins), static_cast<const float*>(coup),
        static_cast<const int32_t*>(fwd), n, nb, static_cast<float*>(e_part),
        static_cast<int32_t*>(m_part), n_systems, per);
  };
  auto pick = [&](auto nb_c) {
    constexpr int NB = decltype(nb_c)::value;
    tail ? go(measure_nb_table_kernel<NB, true>) : go(measure_nb_table_kernel<NB, false>);
  };
  switch (nb) {
    case 4: pick(std::integral_constant<int, 4>{}); break;
    case 5: pick(std::integral_constant<int, 5>{}); break;
    case 8: pick(std::integral_constant<int, 8>{}); break;
    case 9: pick(std::integral_constant<int, 9>{}); break;
    // 13 offsets with a tail spilled 120 B unrolled: steps of four there
    case 13: tail ? pick(std::integral_constant<int, 0>{})
                  : go(measure_nb_table_kernel<13, false>); break;
    default: pick(std::integral_constant<int, 0>{}); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
