// Hopper kernels of the FK cluster update (Swendsen-Wang or Wolff) over a
// flat batch of graphs: bond draws, union-find labelling, cluster flips and
// the post-update measurement, in three launches on the caller's stream.
//
// Replaces the TPU's fused FK kernel peapods_tpu/ops/pallas_event.py:759
// fk_update_batch (kernel _fk_kernel :621, with the CC fixed point
// pallas_cc_batch.cc_fixed_point :188-320 and the coin _salted_uniform_i32
// :260).  The graphs are the (realization, system) pairs, flat and
// disorder-major: spins int8 [B, n] by system, couplings f32 [d, n, ndir]
// shared by the B / d systems of a realization.  A graph is a 2D square
// lattice (forward bonds down, right), the triangular lattice (also
// [1, -1], the reference's tri=True) or a 3D cubic one (+x, +y, +z).
//
//   fk_bonds   inter = s * s_fwd * J and bond = inter > 0 && u < 1 -
//              exp(-2 * inter / T) per forward bond (the reference's
//              operation order, so an injected-uniform comparison is
//              bitwise), u word (site & 3) of Philox4x32-10 keyed by the
//              graph's kb words, counter (dir, site // 4, 0, 0).  Writes a
//              state byte a site (bit d: bond d active; bit 3 + d: s !=
//              s_fwd) and nothing else.  A thread takes a group of four
//              sites of several graphs of one realization (bonds_body,
//              shared with fk_bonds_staged and fk_bonds_band).
//   fk_link    the labelling, in shared memory (ops/fk.py link_plan picks
//              the form from the shape).  Whole-graph form, a graph of at
//              most kLinkSites sites: a CTA stages its state bytes, hangs
//              each run of fast-axis bonds inside a warp under its first
//              site (a ballot), unites the other bonds with a union-find in
//              shared memory (uf.cuh tile_unite: the smaller root wins), a
//              round of lines at a time with the round's sites then pointed
//              at their roots, and writes every parent once, as its root:
//              each component's minimum site index, the reference's
//              min-label fixed point, bitwise, in one launch.  Tiled form,
//              a larger graph: the same in boxes of up to kLinkSites sites
//              (each site's parent its box component's minimum), then
//              fk_link_border unites the bonds that leave a box, as pairs
//              of box roots in global memory (uf.cuh unite, atomicCAS), and
//              fk_link_flatten points every parent at its root.  Either way
//              every parent is written, and ends as its site's label.  The
//              overlap moves (csrc/overlap.cu) label their bond graphs with
//              it too.
//   fk_finish  the flips from each site's root, read with one load: fk_link
//              leaves every parent at its root (so the parents are the
//              labels, and the update and observe forms hand them on as
//              such), the staged path's CC kernels write their labels.  SW
//              flips iff salted_uniform(label, salt0, salt1) < 1/2, Wolff
//              iff label == the seed's label.  When measuring, the
//              post-update energy s * s_fwd * J of the site's forward bonds
//              comes from the state byte and the neighbours' flip decisions
//              (no neighbour spin is read while spins are rewritten), and
//              each block of 256 sites writes one (e, m) partial per graph
//              ([B, blocks]); pt_step adds them in a fixed order.
//
// The staged path (the reference's fk_bond_activation -> _cc_many -> coin
// or Wolff flips, peapods_tpu/engine/loop.py:1883-1976) serves the lattices
// given by an offset table (BCC, FCC, custom offsets): fk_bonds_staged
// draws the bonds along each forward offset with fk_bonds' body and Philox
// counter on the whole lattice of the table (1 to 6 offsets, the words of
// ops/lattice.Lattice.sweep_words), cc.cu's labelling (cc_link; tiled,
// cc_link_border and fk_link_flatten) labels the graphs from the state
// bytes alone, and fk_finish reads each site's root from those labels and
// flips; the measurement is then sweep_nb.cu's measure_nb, so the state
// byte holds the bonds alone, up to six.  Its first design (one kernel of
// its own) found each site's coordinates and neighbours with nb.cuh's
// runtime divisions and modulos (18 a site at FCC), read the couplings
// again for each graph, drew the exp for every bond and loaded and stored
// bytes: 0.0139 ms at FCC 16^3 x 8, where fk_bonds_staged takes 0.0041
// (tools/probe_bonds.py, NVIDIA H100 80GB HBM3, 700 W); the divisions were
// a third of it, the unit bonds' exp an eighth.
//
// The band forms serve a lattice split into row bands over a "space" mesh
// (band.cuh: each band's rows and a halo of its neighbours' edge rows, the
// window):
//
//   fk_bonds_band   fk_bonds / fk_bonds_staged over every window site whose
//                   forward neighbour lies in the window: the band's own
//                   bonds, those that cross its edges, and the halo rows'
//                   bonds into the band, each drawn with the unsharded
//                   kernels' Philox counter (dir, global site / 4, 0, 0).
//                   With three directions or fewer it also writes the
//                   "s differs" bits.  The state bytes are all that
//                   cc_band.cu's labelling reads.  fk_bonds' body, on the
//                   window's geometry (up to six offsets).
//   fk_finish_band  the flips of the band's sites from the global labels
//                   (cc_band.cu): the SW coin on the label, or Wolff's
//                   label == the seed's label, which the engine reads from
//                   the band that holds the seed; optionally the post-update
//                   partials of fk_finish, the forward neighbours' flips
//                   read from the halo labels.
//
// What bounds fk_bonds, fk_bonds_staged and fk_bonds_band on the H100, and
// their design: the function reads each spin and each realization's
// couplings once and writes a state byte a site, 268 MB at the unsharded
// 4096^2 x 4 (0.080 ms at 3.35 TB/s) and 67 MB a band of it in 4 bands
// (0.020 ms).  The first design,
// one group of four sites of one graph a thread, moved about 940 MB there
// in 0.837 ms (0.200 a band; tools/probe_bonds.py, NVIDIA H100 80GB HBM3,
// 700 W): fwd_site's two runtime divisions a bond (57 division sequences
// in its SASS; the card has no divide instruction) cost 0.170 ms, the dead
// parent writes 0.053, the couplings that every graph read again 0.020,
// byte-wide memory 0.018.  Now a thread finds its group's coordinates once
// (band.cuh's multiply-shift), its neighbours with residues and one
// compare an axis, loads its 4 n_dirs couplings once as float4s and draws
// `per` graphs of the realization with them (ops/fk.py bonds_per: the
// realization's graphs, fewer where a launch would hold fewer threads than
// the card holds resident, fk.resident_threads: 132 x 2048 on the H100; the
// rest side by side, reading the couplings from L2), a
// group's spins, neighbours and state bytes in 32-bit words where it lies
// in one row of the fast axis, and no parents: 0.300 ms at 4096^2 x 4,
// 0.085 a band.  What is left is arithmetic and its latency: ten Philox
// rounds a direction and a group (23% of the time, n-nophilox), the
// comparisons of 4 n_dirs bonds; a unit bond (a ferromagnet's, a +-J
// glass's) compares its uniform's word with an integer threshold, and only
// other couplings draw the exp and the division (33% more time without
// that, n-eager).
//
// What bounds fk_finish_band on the H100, and its design: when measuring it
// reads per site the int32 label, the state byte, the spin and 4 n_dirs B
// of couplings and writes the spin: 45 us at 4096^2 x 4 graphs in 4 bands
// (3.35 TB/s).  Its first design, one site a thread, ran 0.923 ms there and
// 0.305 ms at 128^3 x 8 (NVIDIA H100 80GB HBM3, 700 W): integer work, not
// bytes.  Each site worked out its coordinates and neighbours with about
// ten runtime divisions (the card has no divide instruction) and drew its
// SW coin 1 + n_dirs times, its own and once for each backward neighbour;
// the block tree of partials took eight barriers a 256 sites.  Now a CTA
// takes up to 32 partial blocks: it decides each of its sites' flips once
// into shared memory (with the flips of the sites its forward neighbours
// reach within one tile, so that at 4096^2 a coin is drawn 1.5 times a site
// and only the +x neighbour of a cubic lattice, a plane away, is drawn
// again), finds neighbours with band.cuh's multiply-shift division and
// residues, and reduces each block's 256 terms with one warp (warp_tree, the
// tree's pairing), eight blocks at a time: 0.154 ms and 0.050 ms.
//
// fk_finish is built as fk_finish_band is: a CTA takes up to 32 partial
// blocks (ops/fk.py finish_words), decides each flip once into shared
// memory (its sites' and those of the sites its forward neighbours reach
// within its range), finds the neighbours with a multiply-shift division
// and one compare an axis (the geometry a template: no runtime branch on
// the lattice), and reduces each block's 256 terms with one warp.  The
// graphs of a tile run side by side (blockIdx.x the graph), so that all but
// the first read the realization's couplings from L2.  Its first design,
// one site a thread, walked the union-find for the site and each forward
// neighbour, drew the SW coin 1 + n_dirs times a site, took two runtime
// divisions a step and eight barriers a block: 1.321 ms at the unsharded
// 4096^2 x 4 and 0.161 ms at the harness, now 0.461 and 0.057 (bounds
// 0.181, 0.019; NVIDIA H100 80GB HBM3, 700 W, tools/probe_finish_winding.py).
// What is left is integer work (a coin's hash, the neighbours' indices) and,
// at small graphs, the latency of each CTA's chain of loads and barriers.
//
// What bounds the update on the H100: each launch touches a few bytes per
// site -- the int8 spins, 8 or 12 B of couplings, the state byte and the
// int32 label.
// At config 3 (one 256^2 graph) that is well under 1 MB per launch (under
// 1 us at 3.35 TB/s): the launches are bound by latency.  At 64^2 x 2048
// graphs a labelling's least bytes are the state bytes in and the parents
// out, 42 MB (12.5 us).  What holds the labelling back is its unions: the
// first design, one thread a site uniting in global memory, followed long
// chains of dependent parent loads and atomics near T_c and in ordered
// systems, 1.04 ms at the harness and 5.06 ms at 4096^2 x 4 (NVIDIA H100
// 80GB HBM3, 700 W).  In shared memory the chains cost tens of cycles a
// step instead of hundreds, a warp's runs along the fast axis need no
// atomics, and each round's compression keeps the next round's finds
// short: 0.187 ms at the harness, 2.62 ms at 4096^2.  A CTA's unions run
// one after another in each thread, so the time follows the sites a
// thread unites: 512 or 1024 threads a CTA (more where a launch has few
// CTAs), boxes that shrink until a launch has 1024 CTAs.  Small 3D graphs
// gain least (32^3 x 16: 0.060 ms against 0.062): half of a box's sites
// lie on a face, and the border's global unions cost as much as the link.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "band.cuh"
#include "mega.cuh"
#include "nb.cuh"
#include "table.cuh"
#include "uf.cuh"

using namespace peapods;

namespace {

constexpr int kMaxDirs = 3;

// The four spin bytes s[j .. j+3] as one word (little-endian: byte q is
// site j + q), s 4-byte aligned: one load, or two and a funnel shift.
__device__ __forceinline__ uint32_t load4(const int8_t* s, int j) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s) + (j >> 2);
  const int r = j & 3;
  const uint32_t lo = __ldg(w);
  return r ? __funnelshift_r(lo, __ldg(w + 1), 8 * r) : lo;
}

__device__ __forceinline__ float byte_spin(uint32_t w, int q) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * q)));
}

// The FK bond of a forward bond whose product s * s_fwd * J is inter, drawn
// by the uniform word u: inter > 0 && uniform24(u) < 1 - exp(-2 inter / T),
// the reference's operation order (an injected-uniform comparison is
// bitwise).  At inter == 1 (a ferromagnet's or a +-J glass's satisfied
// bond) the comparison is u >> 8 < thr1 (unit_threshold, once a graph), so
// the exp and the division are drawn only for other couplings.
__device__ __forceinline__ bool bond_active(float inter, uint32_t u, float T, uint32_t thr1) {
  if (inter == 1.0f) return (u >> 8) < thr1;
  if (!(inter > 0.0f)) return false;
  return uniform24(u) < 1.0f - expf(-2.0f * inter / T);
}

// The least 24-bit word x with uniform24 of it (x 2^-24, exact) not below
// p1 = 1 - exp(-2 / T), the bond probability at inter == 1: x 2^-24 < p1
// iff x < ceil(p1 2^24), the product exact (a power of two); 0 where p1 is
// not above 0 (or NaN), 2^24 where it is 1.
__device__ __forceinline__ uint32_t unit_threshold(float T) {
  const float p1 = 1.0f - expf(-2.0f * 1.0f / T);
  return p1 > 0.0f ? static_cast<uint32_t>(fminf(ceilf(p1 * 16777216.0f), 16777216.0f)) : 0u;
}

// fk_bonds and fk_bonds_staged (kBand false: the whole periodic lattice,
// ops/fk.py bonds_words, ops/lattice.Lattice.sweep_words) and fk_bonds_band
// (kBand: a band's window, whose bonds that leave it are none;
// ops/lattice.Band.words), on a lattice of kNb forward offsets: the state
// byte of every site, bit d for an active bond d and, where kDiffers (three
// directions or fewer, and not the staged path), bit 3 + d where s !=
// s_fwd.  A thread takes the group of window sites 4g .. 4g+3 of `per`
// graphs of one realization (blockIdx.z; blockIdx.x the realization's
// graphs `per` at a time, side by side; blockIdx.y the group's block of
// kThreads, strided): the group's coordinates (band.cuh's multiply-shift,
// once), its neighbours (residues and one compare an axis) and its 4 kNb
// couplings are found once and used for each graph.  Each bond's uniform
// is word (site & 3) of Philox keyed by the graph's kb words, counter (d,
// global site / 4, 0, 0): the same draws in either form.  Where `vec` (the
// graphs' rows and the pointers aligned, and a band's rows a multiple of 4
// sites) and the group lies in one row of the fast axis, its spins are one
// 32-bit load, each direction's four neighbours one or two (load4; bytes
// where the fast axis wraps inside the group), its couplings kNb float4
// loads, its state one 32-bit store; else each site takes the per-site
// path.
//
// kSpread (the staged form's launches of one graph a thread, too small to
// fill the card: 8 graphs of 16^3 are 32 CTAs): a CTA is kNb warps that
// take the same 32 groups, warp d drawing direction d alone (a warp-uniform
// choice: no divergence), and the warps' bits of each group's four state
// bytes meet in shared memory, where warp 0 ors and stores them; per must
// be 1.  BCC 16^3 x 8 0.0047 -> 0.0035 ms, FCC 0.0057 -> 0.0041, NNN 64^2 x
// 8 0.0047 -> 0.0035 (tools/probe_bonds.py, NVIDIA H100 80GB HBM3, 700 W).
template <int kNb, bool kBand, bool kDiffers = (kNb <= kMaxDirs), bool kSpread = false>
__device__ __forceinline__ void bonds_body(const int8_t* __restrict__ spins,
                                           const float* __restrict__ j_fwd,
                                           const float* __restrict__ temps,
                                           const int32_t* __restrict__ kb,
                                           uint8_t* __restrict__ state, const BandWalk& geo,
                                           int n_systems, int per, int vec) {
  __shared__ uint32_t spread_bits[kSpread ? kNb : 1][32];
  const int rows = geo.w.L[0];
  const int n = rows * geo.block;  // sites of a graph (a band's window)
  const int n_grp = (n + 3) >> 2;
  const bool three = geo.w.L[2] > 1;
  const int lf = three ? geo.w.L[2] : geo.w.L[1];  // the fast axis
  const int b0 = blockIdx.z * n_systems + blockIdx.x * per;
  const float* J = j_fwd + static_cast<size_t>(blockIdx.z) * n * kNb;
  const int lane = kSpread ? static_cast<int>(threadIdx.x & 31) : static_cast<int>(threadIdx.x);
  const int dsel = kSpread ? static_cast<int>(threadIdx.x >> 5) : 0;  // kSpread: the warp's direction
  const int span = kSpread ? 32 : kThreads;  // the groups a CTA takes at a time
  // (kSpread: every warp of the CTA runs the same iterations, for its barriers)
  for (int g = blockIdx.y * span + lane; (kSpread ? g - lane : g) < n_grp;
       g += gridDim.y * span) {
    const int w0 = 4 * g;
    bool whole = false;  // the vector path
    uint32_t bits = 0;   // kSpread: this warp's bits of the group's four state bytes
    if (!kSpread || g < n_grp) {
      int c1, c2;
      const int r = band_coords(geo, w0, c1, c2);
      int gr = r;  // the group's global row
      if (kBand) {
        gr = geo.row0 - geo.halo + r;
        gr = gr < 0 ? gr + geo.L0 : gr >= geo.L0 ? gr - geo.L0 : gr;
      }
      const int f0 = three ? c2 : c1;
      float jc[4 * kNb];
      if (vec && w0 + 4 <= n) {
#pragma unroll
        for (int v = 0; v < kNb; ++v) {
          const float4 x =
              __ldg(reinterpret_cast<const float4*>(J + static_cast<size_t>(w0) * kNb) + v);
          jc[4 * v] = x.x;
          jc[4 * v + 1] = x.y;
          jc[4 * v + 2] = x.z;
          jc[4 * v + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int v = 0; v < 4 * kNb; ++v)
          jc[v] = w0 + v / kNb < n ? __ldg(J + static_cast<size_t>(w0) * kNb + v) : 0.0f;
      }
      whole = vec && f0 + 3 < lf;
      if (whole) {
        // one row of the fast axis: direction d's four neighbours start at
        // j[d] and run along the fast axis, wrapping after split[d] of them
        const uint32_t ctr = static_cast<uint32_t>((gr * geo.block + (w0 - r * geo.block)) >> 2);
        int j[kNb], split[kNb];
        bool on[kNb];
#pragma unroll
        for (int d = 0; d < kNb; ++d) {
          const int to = r + geo.w.off[d][0];
          on[d] = (!kBand || (to >= 0 && to < rows)) && (!kSpread || d == dsel);
          j[d] = band_neighbour(geo, w0, c1, c2, d, false);
          if (!kBand) j[d] += to >= rows ? -n : to < 0 ? n : 0;
          const int t = f0 + (three ? geo.res[d][1] : geo.res[d][0]);
          split[d] = lf - (t >= lf ? t - lf : t);
        }
        for (int k = 0; k < per; ++k) {
          const int b = b0 + k;
          const int8_t* s = spins + static_cast<size_t>(b) * n;
          const uint32_t sw = __ldg(reinterpret_cast<const uint32_t*>(s) + g);
          const float T = temps[b];
          const uint32_t thr1 = unit_threshold(T);
          const uint32_t k0 = static_cast<uint32_t>(kb[2 * b]);
          const uint32_t k1 = static_cast<uint32_t>(kb[2 * b + 1]);
          uint32_t st = 0;
#pragma unroll
          for (int d = 0; d < kNb; ++d) {
            if (!on[d]) continue;
            uint32_t nw;
            if (split[d] >= 4) {
              nw = load4(s, j[d]);
            } else {
              nw = 0;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                nw |= static_cast<uint32_t>(static_cast<uint8_t>(
                          s[j[d] + q - (q >= split[d] ? lf : 0)])) << (8 * q);
            }
            const uint4 u = philox4x32_10(k0, k1, static_cast<uint32_t>(d), ctr, 0u, 0u);
            const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (bond_active(byte_spin(sw, q) * byte_spin(nw, q) * jc[q * kNb + d], uw[q], T,
                              thr1))
                st |= 1u << (8 * q + d);
            if (kDiffers) st |= (__vcmpne4(sw, nw) & 0x01010101u) << (3 + d);
          }
          if (kSpread)
            bits = st;
          else
            reinterpret_cast<uint32_t*>(state + static_cast<size_t>(b) * n)[g] = st;
        }
      } else {
        // the per-site path: a group that crosses a row of the fast axis (or
        // a window row), or unaligned graphs
        for (int k = 0; k < per; ++k) {
          const int b = b0 + k;
          const int8_t* s = spins + static_cast<size_t>(b) * n;
          uint8_t* out = state + static_cast<size_t>(b) * n;
          const float T = temps[b];
          const uint32_t thr1 = unit_threshold(T);
          const uint32_t k0 = static_cast<uint32_t>(kb[2 * b]);
          const uint32_t k1 = static_cast<uint32_t>(kb[2 * b + 1]);
          int rr = r, gg = gr, e1 = c1, e2 = c2;
          uint4 u[kNb];
          int cur = -1;  // the Philox block of u
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int w = w0 + q;
            if (w >= n) break;
            if (q) {  // the next site's coordinates
              if (++e2 == geo.w.L[2]) {
                e2 = 0;
                if (++e1 == geo.w.L[1]) {
                  e1 = 0;
                  ++rr;
                  gg = gg + 1 == geo.L0 ? 0 : gg + 1;
                }
              }
            }
            const int gid = kBand ? gg * geo.block + e1 * geo.w.L[2] + e2 : w;
            if ((gid >> 2) != cur) {
              cur = gid >> 2;
#pragma unroll
              for (int d = 0; d < kNb; ++d)
                if (!kSpread || d == dsel)
                  u[d] = philox4x32_10(k0, k1, static_cast<uint32_t>(d),
                                       static_cast<uint32_t>(cur), 0u, 0u);
            }
            const float si = static_cast<float>(s[w]);
            uint8_t st = 0;
#pragma unroll
            for (int d = 0; d < kNb; ++d) {
              if (kSpread && d != dsel) continue;
              const int to = rr + geo.w.off[d][0];
              if (kBand && (to < 0 || to >= rows)) continue;  // the bond leaves the window: none
              int jn = band_neighbour(geo, w, e1, e2, d, false);
              if (!kBand) jn += to >= rows ? -n : to < 0 ? n : 0;
              const float sf = static_cast<float>(s[jn]);
              if (bond_active(si * sf * jc[q * kNb + d], philox_word(u[d], gid), T, thr1))
                st |= 1u << d;
              if (kDiffers && si != sf) st |= 8u << d;
            }
            if (kSpread)
              bits |= static_cast<uint32_t>(st) << (8 * q);
            else
              out[w] = st;
          }
        }
      }
    }
    if (kSpread) {  // warp 0 ors the warps' bits and stores the group's bytes
      spread_bits[dsel][lane] = bits;
      __syncthreads();
      if (dsel == 0 && g < n_grp) {
#pragma unroll
        for (int d = 1; d < kNb; ++d) bits |= spread_bits[d][lane];
        uint8_t* out = state + static_cast<size_t>(b0) * n;
        if (whole) {
          reinterpret_cast<uint32_t*>(out)[g] = bits;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (w0 + q < n) out[w0 + q] = static_cast<uint8_t>(bits >> (8 * q));
        }
      }
      __syncthreads();  // before the next groups' bits
    }
  }
}

// The three forms' kernels (their own names, for the profiler), one body;
// kBlocks the blocks an SM they are built for (launch_bonds: 4, at most 64
// registers, where the threads loop over several graphs).
template <int kNb, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
fk_bonds_kernel(const int8_t* __restrict__ spins, const float* __restrict__ j_fwd,
                const float* __restrict__ temps, const int32_t* __restrict__ kb,
                uint8_t* __restrict__ state, const BandWalk geo, int n_systems, int per,
                int vec) {
  bonds_body<kNb, false>(spins, j_fwd, temps, kb, state, geo, n_systems, per, vec);
}

// The staged path's bonds (the lattices of an offset table: BCC, FCC,
// custom offsets), whose state bytes hold the bonds alone: cc.cu's
// labelling reads nothing else, and the path measures after the flips
// (sweep_nb.cu measure_nb).
template <int kNb, int kBlocks, bool kSpread>
__global__ void __launch_bounds__(kThreads, kBlocks)
fk_bonds_staged_kernel(const int8_t* __restrict__ spins, const float* __restrict__ j_fwd,
                       const float* __restrict__ temps, const int32_t* __restrict__ kb,
                       uint8_t* __restrict__ state, const BandWalk geo, int n_systems, int per,
                       int vec) {
  bonds_body<kNb, false, false, kSpread>(spins, j_fwd, temps, kb, state, geo, n_systems, per,
                                         vec);
}

// The table form of fk_bonds_staged (4D and up, or 7 to 32 offsets;
// ops/lattice.Lattice.table): the bonds of each site as one 32-bit word,
// bit d the bond to fwd[i, d] (the int32 table [n, n_nb] in device memory).
// The draws are the walk form's, counter for counter: word (site & 3) of
// Philox keyed by the graph's kb words, counter (d, site / 4, 0, 0); a
// self-bond is drawn as any other (it joins nothing).
//
// A thread takes the group of sites 4g .. 4g+3 for `per` graphs of one
// realization (blockIdx.z; graphs z S + blockIdx.y per .., ops/fk.py
// table_bonds_plan), whose temperatures, unit thresholds and key words the
// CTA stages in shared memory once.  It reads the group's 4 nb table
// entries and couplings once for its graphs (table.cuh: 16-byte loads where
// the group is whole; each offset's couplings kept as one word of sign and
// unit bits, a coupling other than +-1 read again where its bond can be
// active), and for each graph its own spins (one 32-bit load where vec &
// 1) and every neighbour's spin of a step before the step's first draw,
// decides the four sites of an offset at once, and stores the group's four
// words with one 16-byte store (vec & 2).  NB: the offsets unrolled (4, 5, 8, 9, 13: one step), or 0, a
// runtime count in steps of four offsets with each graph's words kept in
// registers across the steps.  kSplit (a launch of one graph a thread too
// small to fill the card: 16^3 with 13 offsets x 8 graphs is 32 CTAs of
// 256): a CTA is `split` warps over the same 32 groups of one graph, warp w
// drawing its share of the offsets (the steps of [w c, w c + c), c =
// ceil(nb / split)); their bits meet in shared memory and warp 0 stores.
//
// The first design (a group of four sites of one graph a thread: each of a
// realization's graphs read its couplings and table rows again, 4-byte
// words at a time, each term a table load and then a spin load, a runtime
// loop over the offsets) took 0.0720 ms a launch at the 4D +-J glass (384
// graphs of 10^4 sites, 4 offsets; 11x its bound), 0.0275 at 16^4 x 16 and
// 0.0136 at 16^3 with 13 offsets x 8; this one 0.0306 (8 graphs a
// thread), 0.0109 (4) and 0.0058 (5 warps a group) (tools/probe_bonds.py
// --table, CUDA events, NVIDIA H100 80GB HBM3, 700 W).  The draws are
// what is left: 0.0136 ms of the glass's 0.0306 (Philox replaced by a few
// integer operations, t-nophilox), at 4 offsets with four CTAs an SM.
// Skipping a group's Philox block where none of its four bonds can be
// active gained nothing (a warp skips only where all 32 groups do), and
// deciding the couplings other than +-1 inline cost 2-3% at 4 offsets.
constexpr int kTableMaxPer = 8;    // graphs a thread of fk_bonds_table at most
constexpr int kTableMaxSplit = 8;  // warps that share a group's offsets at most

// The CTA's graphs: each one's temperature, unit threshold and key words.
struct TableGraphs {
  float T[kTableMaxPer];
  uint32_t thr[kTableMaxPer];
  uint32_t k0[kTableMaxPer];
  uint32_t k1[kTableMaxPer];
};

// The bonds of the group's sites `sat` along offset d whose couplings are
// not +-1 (s s_f J > 0 already): bond_active's draw at inter = |J| (cg the
// group's couplings, rows of nb; uw the offset's Philox words).  Bit 0 of
// byte q: site q's bond.  Out of line: inlined, its exp took registers
// from every site's path.
__device__ __noinline__ uint32_t other_bonds(uint32_t sat, uint32_t u0, uint32_t u1,
                                             uint32_t u2, uint32_t u3,
                                             const float* __restrict__ cg, int nb, int d,
                                             float T) {
  const uint32_t uw[4] = {u0, u1, u2, u3};
  uint32_t on = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if ((sat >> (8 * q)) & 1u &&
        uniform24(uw[q]) < 1.0f - expf(-2.0f * fabsf(__ldg(cg + q * nb + d)) / T))
      on |= 1u << (8 * q);
  return on;
}

// The bonds of offsets d0 .. d0+K-1 below hi of the group's sites `live`
// in one graph s (own spins sw; the step's entries f and coupling words
// m, the couplings cg), or'ed into st: every neighbour's spin gathered
// first, then each offset's Philox block and its four decisions.  A bond
// can be active where s s_f J > 0 (sat: J's sign flipped where the spins
// differ); at |J| == 1 that product is 1 and the draw the integer compare
// with thr1, bond_active's; other couplings take other_bonds.
template <int K>
__device__ __forceinline__ void group_bonds(uint32_t (&st)[4], uint32_t sw,
                                            const int8_t* __restrict__ s, const int (&f)[4][K],
                                            const uint32_t (&m)[K], const float* __restrict__ cg,
                                            int nb, int d0, int hi, uint32_t live, int g, float T,
                                            uint32_t thr1, uint32_t k0, uint32_t k1) {
  uint32_t nw[K];
  gather_words<K>(nw, s, f);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int d = d0 + j;
    if (d >= hi) break;
    const uint32_t dd = byte_differ(sw, nw[j]);
    const uint32_t sat = ((dd & (m[j] >> 1)) | (~dd & m[j])) & live;
    const uint32_t uni = (m[j] >> 2) & kByteBits;
    const uint4 u = philox4x32_10(k0, k1, static_cast<uint32_t>(d), static_cast<uint32_t>(g),
                                  0u, 0u);
    const uint32_t uw[4] = {u.x, u.y, u.z, u.w};
    uint32_t on = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((uw[q] >> 8) < thr1) on |= 1u << (8 * q);
    on &= sat & uni;
    if (sat & ~uni) on |= other_bonds(sat & ~uni, u.x, u.y, u.z, u.w, cg, nb, d, T);
#pragma unroll
    for (int q = 0; q < 4; ++q) st[q] |= ((on >> (8 * q)) & 1u) << d;
  }
}

// At 4 offsets four CTAs an SM (the 4D glass's 480 CTAs in one wave);
// elsewhere one, ptxas free to keep a step's gathers in flight.
template <int NB, bool kSplit>
__global__ void __launch_bounds__(kThreads, NB == 4 ? 4 : 1)
fk_bonds_table_kernel(const int8_t* __restrict__ spins, const float* __restrict__ j_fwd,
                      const float* __restrict__ temps, const int32_t* __restrict__ kb,
                      uint32_t* __restrict__ state, const int32_t* __restrict__ fwd, int n,
                      int nb, int n_systems, int per, int split, int vec) {
  __shared__ TableGraphs sh;
  __shared__ uint32_t sbits[kSplit ? 32 : 1][4];
  const int z = blockIdx.z;
  const int b0 = z * n_systems + blockIdx.y * per;
  if (threadIdx.x < per) {
    const int k = threadIdx.x;
    const float T = temps[b0 + k];
    sh.T[k] = T;
    sh.thr[k] = unit_threshold(T);
    sh.k0[k] = static_cast<uint32_t>(kb[2 * (b0 + k)]);
    sh.k1[k] = static_cast<uint32_t>(kb[2 * (b0 + k) + 1]);
  }
  if (kSplit)
    for (int i = threadIdx.x; i < 128; i += blockDim.x) sbits[i >> 2][i & 3] = 0u;
  __syncthreads();
  const int lane = kSplit ? static_cast<int>(threadIdx.x & 31) : static_cast<int>(threadIdx.x);
  const int g = blockIdx.x * (kSplit ? 32 : kThreads) + lane;
  const int i0 = 4 * g;
  const int cnt = i0 < n ? min(4, n - i0) : 0;
  const float* cg = j_fwd + (static_cast<size_t>(z) * n + (cnt ? i0 : 0)) * nb;
  const int32_t* rg = fwd + static_cast<size_t>(cnt ? i0 : 0) * nb;
  const bool c16 = reinterpret_cast<uintptr_t>(cg) % 16 == 0;
  const uint32_t live = live_bytes(cnt);
  const int8_t* s0 = spins + static_cast<size_t>(b0) * n;
  uint32_t* out0 = state + static_cast<size_t>(b0) * n;
  if constexpr (NB > 0 && !kSplit) {
    if (!cnt) return;
    int f[4][NB];
    uint32_t m[NB];
    whole_rows<NB>(f, m, rg, cg, i0, cnt, c16);
    for (int k = 0; k < per; ++k) {
      const int8_t* s = s0 + static_cast<size_t>(k) * n;
      uint32_t st[4] = {0u, 0u, 0u, 0u};
      group_bonds<NB>(st, own_spins(s, i0, cnt, vec & 1), s, f, m, cg, nb, 0, NB, live, g,
                      sh.T[k], sh.thr[k], sh.k0[k], sh.k1[k]);
      store_words(out0 + static_cast<size_t>(k) * n, i0, cnt, st, vec & 2);
    }
  } else {
    constexpr int P = kSplit ? 1 : kTableMaxPer;
    int lo = 0, hi = nb;
    if (kSplit) {
      const int c = (nb + split - 1) / split;
      lo = min(nb, static_cast<int>(threadIdx.x >> 5) * c);
      hi = min(nb, lo + c);
    }
    uint32_t st[P][4];
    uint32_t sw[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0u;
      sw[k] = 0u;
      if (k < per && cnt) sw[k] = own_spins(s0 + static_cast<size_t>(k) * n, i0, cnt, vec & 1);
    }
    if (cnt) {
      for (int d0 = lo; d0 < hi; d0 += 4) {
        int f[4][4];
        uint32_t m[4];
        step_rows(f, m, rg, cg, nb, d0, hi, i0, cnt,
                  nb % 4 == 0 && d0 % 4 == 0 && d0 + 4 <= hi && cnt == 4 && c16);
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (k >= per) break;
          group_bonds<4>(st[k], sw[k], s0 + static_cast<size_t>(k) * n, f, m, cg, nb, d0, hi,
                         live, g, sh.T[k], sh.thr[k], sh.k0[k], sh.k1[k]);
        }
      }
    }
    if (kSplit) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (st[0][q]) atomicOr(&sbits[lane][q], st[0][q]);
      __syncthreads();
      if (threadIdx.x < 32 && cnt) {
        const uint32_t w[4] = {sbits[lane][0], sbits[lane][1], sbits[lane][2], sbits[lane][3]};
        store_words(out0, i0, cnt, w, vec & 2);
      }
    } else if (cnt) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (k >= per) break;
        store_words(out0 + static_cast<size_t>(k) * n, i0, cnt, st[k], vec & 2);
      }
    }
  }
}

template <int kNb, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
fk_bonds_band_kernel(const int8_t* __restrict__ spins, const float* __restrict__ j_win,
                     const float* __restrict__ temps, const int32_t* __restrict__ kb,
                     uint8_t* __restrict__ state, const BandWalk geo, int n_systems, int per,
                     int vec) {
  bonds_body<kNb, true>(spins, j_win, temps, kb, state, geo, n_systems, per, vec);
}

// fk_link's tiles (ops/fk.py link_plan): boxes of t[0] x t[1] x t[2] sites
// of an [L0, L1, L2] lattice (L2 = 1 in 2D), nt[k] of them along axis k; a
// tile that spans an axis (nt[k] == 1) holds the bonds that wrap around
// it.  A CTA takes a tile of one graph, its threads along the fast axis (2
// in 3D, 1 in 2D), whose bond direction has the same number.
struct LinkTiles {
  int L[3];
  int t[3];
  int nt[3];
  int ndir;
  int tri;
  int fast;
};

constexpr int kLinkThreads = 1024;
constexpr int kLinkSites = 8192;  // a tile's parents and state bytes: 40 KB of shared memory

inline LinkTiles make_link_tiles(int L0, int L1, int L2, int tri, int t0, int t1, int t2) {
  LinkTiles g;
  const int L[3] = {L0, L1, L2};
  const int t[3] = {t0, t1, t2};
  for (int k = 0; k < 3; ++k) {
    g.L[k] = L[k];
    g.t[k] = t[k];
    g.nt[k] = (L[k] + t[k] - 1) / t[k];
  }
  g.tri = tri;
  g.ndir = tri ? 3 : L2 > 1 ? 3 : 2;
  g.fast = L2 > 1 ? 2 : 1;
  return g;
}

inline bool link_tiles_ok(const LinkTiles& g, int n_graphs) {
  if (n_graphs < 1 || n_graphs > 65535) return false;
  long long sites = 1;
  for (int k = 0; k < 3; ++k) {
    if (g.L[k] < 1 || g.t[k] < 1 || g.t[k] > g.L[k]) return false;
    sites *= g.t[k];
  }
  return sites <= kLinkSites && g.t[g.fast] <= kLinkThreads;
}

inline int link_tile_count(const LinkTiles& g) { return g.nt[0] * g.nt[1] * g.nt[2]; }

// Component k of bond direction dir's forward offset: +1 along axis dir, or
// the triangular lattice's [1, -1].
__device__ __forceinline__ int link_off(const LinkTiles& g, int dir, int k) {
  if (g.tri && dir == 2) return k == 0 ? 1 : k == 1 ? -1 : 0;
  return k == dir ? 1 : 0;
}

struct LinkBox {
  int o[3];
  int e[3];
};

__device__ __forceinline__ LinkBox link_box(const LinkTiles& g, int tile) {
  LinkBox b;
  const int i2 = tile % g.nt[2];
  tile /= g.nt[2];
  const int i1 = tile % g.nt[1];
  const int i0 = tile / g.nt[1];
  const int i[3] = {i0, i1, i2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b.o[k] = i[k] * g.t[k];
    b.e[k] = min(g.t[k], g.L[k] - b.o[k]);
  }
  return b;
}

// Box coordinates of the site at line s (of one graph's lines in the box)
// and fast coordinate x.
__device__ __forceinline__ void link_coords(const LinkTiles& g, const LinkBox& b, int s,
                                            int x, int c[3]) {
  if (g.fast == 2) {
    c[0] = s / b.e[1];
    c[1] = s - c[0] * b.e[1];
    c[2] = x;
  } else {
    c[0] = s;
    c[1] = x;
    c[2] = 0;
  }
}

// The site index in its graph of box coordinates c (+ direction dir's
// offset when dir >= 0), periodic.
__device__ __forceinline__ int link_site_of(const LinkTiles& g, const LinkBox& b,
                                            const int c[3], int dir) {
  int i = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int x = b.o[k] + c[k] + (dir >= 0 ? link_off(g, dir, k) : 0);
    x = x < 0 ? x + g.L[k] : x >= g.L[k] ? x - g.L[k] : x;
    i = i * g.L[k] + x;
  }
  return i;
}

// The box index of the neighbour of c along bond direction dir, or -1 where
// the bond leaves the box (an axis the box spans wraps inside it).
__device__ __forceinline__ int link_step(const LinkTiles& g, const LinkBox& b,
                                         const int c[3], int dir) {
  int l = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int x = c[k] + link_off(g, dir, k);
    if (g.nt[k] == 1) x = x < 0 ? x + b.e[k] : x >= b.e[k] ? x - b.e[k] : x;
    if (x < 0 || x >= b.e[k]) return -1;
    l = l * b.e[k] + x;
  }
  return l;
}

// A CTA labels one tile of a graph in shared memory: (1) the state bytes'
// bonds into S, then each run of fast-axis bonds inside a warp hung under
// its first site (a ballot, no atomics); (2) the other bonds inside the
// box united (tile_unite: the smaller root wins, and box order is site
// order), a round of lines at a time, each round ending with its sites
// pointed at their roots (so that the next round's finds stay short); (3)
// every site's parent written once, as its box root's site index.  Where the box is the whole graph (kWhole) that is the component's
// minimum site, the final label, and a site's box index is its site index.
// (No array is indexed at run time: that would put it in local memory.)
template <bool kWhole>
__global__ void __launch_bounds__(kLinkThreads)
fk_link_kernel(const uint8_t* __restrict__ state, int32_t* __restrict__ parent,
               const LinkTiles g) {
  __shared__ int P[kLinkSites];
  __shared__ uint8_t S[kLinkSites];
  const unsigned lanes = __activemask();
  const size_t n = static_cast<size_t>(g.L[0]) * g.L[1] * g.L[2];
  const LinkBox b = link_box(g, blockIdx.x);
  const bool three = g.fast == 2;
  const int ef = three ? b.e[2] : b.e[1];
  const int n_slow = b.e[0] * (three ? b.e[1] : 1);  // the box's lines
  const int x = threadIdx.x;
  const int iters = (n_slow + blockDim.y - 1) / blockDim.y;
  const int lane = (threadIdx.y * blockDim.x + x) & 31;
  const unsigned mask = (1u << g.ndir) - 1u;
  const uint8_t* st0 = state + blockIdx.y * n;
  int32_t* par0 = parent + blockIdx.y * n;
  if (x < ef) {
#pragma unroll 4
    for (int s = threadIdx.y; s < n_slow; s += blockDim.y) {
      int c[3];
      link_coords(g, b, s, x, c);
      S[s * ef + x] = st0[kWhole ? s * ef + x : link_site_of(g, b, c, -1)] & mask;
    }
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int l = (threadIdx.y + it * blockDim.y) * ef + x;
    const bool on = l < n_slow * ef && x < ef;
    const bool run = on && ((S[l] >> g.fast) & 1u) && x + 1 < ef;
    const unsigned starts = ~(__ballot_sync(lanes, run) << 1);
    const int first = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
    if (on) P[l] = l - (lane - first);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {  // a round of unions, then its sites' finds
    const int s = threadIdx.y + it * blockDim.y;
    const int l = s * ef + x;
    const bool on = s < n_slow && x < ef;
    const unsigned st = on ? S[l] : 0u;
    if (st) {
      int c[3];
      link_coords(g, b, s, x, c);
#pragma unroll
      for (int dir = 0; dir < 3; ++dir) {
        if (dir == g.ndir) break;
        if (!((st >> dir) & 1u)) continue;
        if (dir == g.fast && x + 1 < ef && lane != 31) continue;  // a run of step (1)
        const int j = link_step(g, b, c, dir);
        if (j >= 0) tile_unite(P, l, j);
      }
    }
    __syncthreads();
    if (on) P[l] = tile_root(P, l);
    __syncthreads();
  }
  for (int it = 0; it < iters; ++it) {
    const int s = threadIdx.y + it * blockDim.y;
    if (s >= n_slow || x >= ef) continue;
    const int l = s * ef + x;
    const int r = tile_root(P, l);
    if (kWhole) {
      par0[l] = r;
      continue;
    }
    const int sr = r / ef;
    int c[3], cr[3];
    link_coords(g, b, s, x, c);
    link_coords(g, b, sr, r - sr * ef, cr);
    par0[link_site_of(g, b, c, -1)] = link_site_of(g, b, cr, -1);
  }
}

// The tiled form's bonds that leave their tile, united in global memory
// (uf.cuh unite: the larger root hung under the smaller with atomicCAS):
// a CTA walks its tile's faces, the last layer along each axis the tiles
// split (and on the triangular lattice the first column, whose [1, -1]
// bonds leave backwards along axis 1).
__global__ void __launch_bounds__(kThreads)
fk_link_border_kernel(const uint8_t* __restrict__ state, int32_t* parent,
                      const LinkTiles g) {
  const size_t n = static_cast<size_t>(g.L[0]) * g.L[1] * g.L[2];
  const uint8_t* st = state + blockIdx.y * n;
  int32_t* P = parent + blockIdx.y * n;
  const LinkBox b = link_box(g, blockIdx.x);
  const int e0 = b.e[0], e1 = b.e[1], e2 = b.e[2];
  const int f0 = g.nt[0] > 1 ? e1 * e2 : 0;
  const int f1 = g.nt[1] > 1 ? e0 * e2 : 0;
  const int f2 = g.nt[2] > 1 ? e0 * e1 : 0;
  const int f3 = g.tri && g.nt[1] > 1 ? e0 : 0;
  const unsigned mask = (1u << g.ndir) - 1u;
  const int lane = threadIdx.x & 31;
  const int n_face = f0 + f1 + f2 + f3;
  for (int q0 = 0; q0 < n_face; q0 += blockDim.x) {  // uniform: the warps shuffle
    const int q = q0 + threadIdx.x;
    int c[3];
    int r = q < n_face ? q : 0;
    if (r < f0) {
      c[0] = e0 - 1;
      c[1] = r / e2;
      c[2] = r - c[1] * e2;
    } else if ((r -= f0) < f1) {
      c[0] = r / e2;
      c[1] = e1 - 1;
      c[2] = r - c[0] * e2;
    } else if ((r -= f1) < f2) {
      c[0] = r / e1;
      c[1] = r - c[0] * e1;
      c[2] = e2 - 1;
    } else {
      c[0] = r - f2;
      c[1] = 0;
      c[2] = 0;
    }
    const int i = link_site_of(g, b, c, -1);
    const unsigned bonds = q < n_face ? st[i] & mask : 0u;
#pragma unroll
    for (int dir = 0; dir < 3; ++dir) {
      if (dir == g.ndir) break;
      const bool cross = (bonds >> dir) & 1u && link_step(g, b, c, dir) < 0;
      const int j = cross ? link_site_of(g, b, c, dir) : 0;
      // the two ends' tile roots (the link wrote them), skipped where the
      // previous lane unites the same pair
      const int ra = cross ? __ldcg(P + i) : -1;
      const int rb = cross ? __ldcg(P + j) : -1;
      const int pa = __shfl_up_sync(0xffffffffu, ra, 1);
      const int pb = __shfl_up_sync(0xffffffffu, rb, 1);
      if (cross && !(lane > 0 && pa == ra && pb == rb)) unite(P, ra, rb);
    }
  }
}

// The tiled form's last pass (fk_link's, and cc.cu's labelling of offset
// tables): every parent becomes its root.  A thread
// writes its own site only, and only the root, so a parent read here is
// always an ancestor (find_root's halving could store a grandparent over a
// root that another thread has just written).
__global__ void __launch_bounds__(kThreads)
fk_link_flatten_kernel(int32_t* parent, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t* P = parent + static_cast<size_t>(blockIdx.y) * n;
  const int p = __ldcg(P + i);
  int r = p;
  for (int q; (q = __ldcg(P + r)) != r;) r = q;
  if (r != p) P[i] = r;
}

__device__ __forceinline__ bool flips(int root, int wolff, int seed_root,
                                      uint32_t s0, uint32_t s1) {
  return wolff ? root == seed_root
               : salted_uniform(static_cast<uint32_t>(root), s0, s1) < 0.5f;
}

// The work of one fk_finish or fk_finish_band CTA: `parts` consecutive
// partial blocks of kThreads sites, and the flips it stages in shared
// memory, `ext` sites from its first (its own and, when measuring, those
// that its sites' forward neighbours reach within one tile).  Both forms
// take it from the host (ops/fk.py finish_tile).
struct FinishTile {
  int parts;
  int ext;
};

constexpr int kMaxFinishParts = 32;
constexpr int kPartWarps = kThreads / 32;

// fk_finish's geometry (ops/fk.py finish_words): a periodic [L0, L1, L2]
// lattice (L2 = 1 in 2D), its bond directions (the triangular lattice's
// third is [1, -1]), the CTA's tile and n / (L1 L2), n / L2 as umulhi(n, m)
// >> s (band.cuh's multiply-shift; m = 0 for a divisor of 1).
struct FinishWalk {
  int L[3];
  int ndir;
  int tri;
  FinishTile ft;
  uint32_t div_m[2];
  int div_s[2];
};

inline FinishWalk make_finish_walk(const int* w) {
  FinishWalk g;
  for (int k = 0; k < 3; ++k) g.L[k] = w[k];
  g.ndir = w[3];
  g.tri = w[4];
  g.ft = FinishTile{w[5], w[6]};
  for (int k = 0; k < 2; ++k) {
    g.div_m[k] = static_cast<uint32_t>(w[7 + 2 * k]);
    g.div_s[k] = w[8 + 2 * k];
  }
  return g;
}

__device__ __forceinline__ int finish_div(const FinishWalk& g, int k, int n) {
  return g.div_m[k]
             ? static_cast<int>(__umulhi(static_cast<uint32_t>(n), g.div_m[k]) >>
                                g.div_s[k])
             : n;
}

// The post-update energy of site i's forward bonds on a lattice of kNd bond
// directions (kTri: the triangular lattice's third, [1, -1]; else a third
// is a 3D lattice's axis 2): the neighbours by one compare an axis (row r
// by the multiply-shift division, no other division), each bond's product
// s * s_fwd from the "s differs" bit of the state byte sb and the two flip
// decisions, the neighbour's from the staged flags where it lies in the
// CTA's staged range [i0, i0 + n_flag), else drawn again from its label.
template <int kNd, bool kTri>
__device__ __forceinline__ float finish_energy(const FinishWalk& g, int i, uint8_t sb, bool fl,
                                               int i0, int n_flag, const uint8_t* flag,
                                               const float* J, const int32_t* lab,
                                               int wolff, int seed_label, uint32_t s0,
                                               uint32_t s1) {
  constexpr bool k3d = kNd == 3 && !kTri;
  const int block = g.L[1] * g.L[2];
  const int r = finish_div(g, 0, i);
  int c1 = i - r * block;
  int c2 = 0;
  if (k3d) {
    const int p = c1;
    c1 = finish_div(g, 1, p);
    c2 = p - c1 * g.L[2];
  }
  int j[kNd];
  float jv[kNd];
  j[0] = r + 1 == g.L[0] ? i + block - g.L[0] * block : i + block;
  j[1] = c1 + 1 == g.L[1] ? i + g.L[2] - block : i + g.L[2];
  if (kNd == 3)
    j[2] = kTri ? (c1 == 0 ? j[0] + g.L[1] - 1 : j[0] - 1) : (c2 + 1 == g.L[2] ? i + 1 - g.L[2]
                                                                                : i + 1);
  if (kNd == 2) {
    const float2 v = reinterpret_cast<const float2*>(J)[i];
    jv[0] = v.x;
    jv[1] = v.y;
  } else {
#pragma unroll
    for (int d = 0; d < kNd; ++d) jv[d] = J[static_cast<size_t>(i) * kNd + d];
  }
  float e = 0.0f;
#pragma unroll
  for (int d = 0; d < kNd; ++d) {
    const unsigned lj = static_cast<unsigned>(j[d] - i0);
    const bool ff = lj < static_cast<unsigned>(n_flag) ? (flag[lj] & 1u) != 0
                                                      : flips(lab[j[d]], wolff, seed_label, s0, s1);
    const float prod = (((sb >> (3 + d)) & 1u) != 0) != (fl != ff) ? -1.0f : 1.0f;
    e = e + prod * jv[d];
  }
  return e;
}

// Phase 1: every site of the CTA's range flips (its label's coin, or
// Wolff's label == the seed's label), each decision made once from one load
// of the label and kept in shared memory with the new spin, and the next
// `ext - tile` sites' decisions beside them.  Phase 2 (measuring): each
// site's forward bonds after the update (finish_energy), one site a thread
// for each partial block, eight blocks at a time, each block's 256 (e, m)
// terms then reduced by one warp in block_partials' pairing.  The geometry
// is a template (kNd, kTri): each lattice's neighbours and couplings
// without runtime branches.
template <int kNd, bool kTri>
__global__ void __launch_bounds__(kThreads)
fk_finish_kernel(int8_t* __restrict__ spins, const uint8_t* __restrict__ state,
                 const int32_t* __restrict__ labels, const float* __restrict__ j_fwd,
                 const int32_t* __restrict__ scalars, float* __restrict__ e_part,
                 int32_t* __restrict__ m_part, const FinishWalk g, int n_systems,
                 int wolff) {
  extern __shared__ uint8_t flag[];  // bit 0: the site flips; bit 1: its new spin is +1
  __shared__ float se[kPartWarps][kThreads];
  __shared__ int sm[kPartWarps][kThreads];
  const int b = blockIdx.x;  // the graphs of a tile run together: their couplings are shared
  const int n = g.L[0] * g.L[1] * g.L[2];
  const int n_blk = (n + kThreads - 1) / kThreads;
  const bool measure = e_part != nullptr;
  const size_t base = static_cast<size_t>(b) * n;
  const int q0 = blockIdx.y * g.ft.parts;  // the CTA's first partial block
  const int i0 = q0 * kThreads;            // its first site
  const int n_own = min(g.ft.parts * kThreads, n - i0);
  const int n_flag = measure ? min(g.ft.ext, n - i0) : n_own;
  const uint32_t s0 = static_cast<uint32_t>(scalars[3 * b]);
  const uint32_t s1 = static_cast<uint32_t>(scalars[3 * b + 1]);
  const int32_t* lab = labels + base;
  const int seed_label = wolff ? lab[scalars[3 * b + 2]] : -1;
  int8_t* s = spins + base;
#pragma unroll 4
  for (int k = threadIdx.x; k < n_flag; k += kThreads) {
    const bool fl = flips(lab[i0 + k], wolff, seed_label, s0, s1);
    uint8_t f = fl ? 1u : 0u;
    if (k < n_own) {
      const int8_t sv = s[i0 + k];
      const int8_t sn = fl ? static_cast<int8_t>(-sv) : sv;
      s[i0 + k] = sn;
      f |= sn > 0 ? 2u : 0u;
    }
    if (measure) flag[k] = f;
  }
  if (!measure) return;  // uniform across the launch
  __syncthreads();
  const uint8_t* st = state + base;
  const float* J = j_fwd + static_cast<size_t>(b / n_systems) * n * kNd;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int parts = min(g.ft.parts, n_blk - q0);
  for (int c = 0; c < parts; c += kPartWarps) {
#pragma unroll
    for (int k = 0; k < kPartWarps; ++k) {
      const int i = (q0 + c + k) * kThreads + threadIdx.x;
      float e = 0.0f;
      int m = 0;
      if (c + k < parts && i < n) {
        const uint8_t f = flag[i - i0];
        e = finish_energy<kNd, kTri>(g, i, st[i], (f & 1u) != 0, i0, n_flag, flag, J, lab,
                                     wolff, seed_label, s0, s1);
        m = (f & 2u) ? 1 : -1;
      }
      se[k][threadIdx.x] = e;
      sm[k][threadIdx.x] = m;
    }
    __syncthreads();
    if (c + warp < parts) {
      const float et = warp_tree(se[warp], lane);
      const int mt = warp_tree(sm[warp], lane);
      if (lane == 0) {
        const size_t o = static_cast<size_t>(b) * n_blk + q0 + c + warp;
        e_part[o] = et;
        m_part[o] = mt;
      }
    }
    if (c + kPartWarps < parts) __syncthreads();  // before the next chunk's terms
  }
}

// A launch's tile (ops/fk.py finish_tile, the rule of both forms) as the
// kernels take it: 1 to kMaxFinishParts blocks, its flags at most two tiles.
inline bool finish_tile_ok(const FinishTile& ft) {
  return ft.parts >= 1 && ft.parts <= kMaxFinishParts && ft.ext >= ft.parts * kThreads &&
         ft.ext <= 2 * ft.parts * kThreads;
}

// Phase 1: every site of the CTA's range flips (its label's coin, or
// Wolff's label == the seed's label), each decision made once and kept in
// shared memory with the new spin, and the next `ext - tile` sites'
// decisions (halo rows too: their labels are their owners') beside them.
// Phase 2 (measuring): each site's forward bonds after the update from the
// state byte and the two decisions, read from shared memory where the
// neighbour lies in the staged range (the others' coins recomputed from
// their labels); one site a thread for each partial block, the block's 256
// (e, m) terms reduced by one warp in block_partials' pairing.
__global__ void __launch_bounds__(kThreads)
fk_finish_band_kernel(int8_t* __restrict__ spins, const uint8_t* __restrict__ state,
                      const int32_t* __restrict__ labels,
                      const float* __restrict__ j_win,
                      const int32_t* __restrict__ scalars,
                      const int32_t* __restrict__ seed_labels,
                      float* __restrict__ e_part, int32_t* __restrict__ m_part,
                      const BandWalk geo, int n_systems, int wolff, const FinishTile ft) {
  extern __shared__ uint8_t flag[];  // bit 0: the site flips; bit 1: its new spin is +1
  __shared__ float se[kPartWarps][kThreads];
  __shared__ int sm[kPartWarps][kThreads];
  const int b = blockIdx.y;
  const int nw = geo.w.L[0] * geo.block;
  const int nd = geo.w.n_nb;
  const int n_band = geo.hl * geo.block;
  const int n_blk = (n_band + kThreads - 1) / kThreads;
  const bool measure = e_part != nullptr;
  const size_t base = static_cast<size_t>(b) * nw;
  const int q0 = blockIdx.x * ft.parts;  // the CTA's first partial block
  const int i0 = q0 * kThreads;          // its first interior site
  const int n_own = min(ft.parts * kThreads, n_band - i0);
  const int lo = geo.halo * geo.block + i0;  // the window site of flag[0]
  const int n_flag = measure ? min(ft.ext, nw - lo) : n_own;
  const uint32_t s0 = static_cast<uint32_t>(scalars[3 * b]);
  const uint32_t s1 = static_cast<uint32_t>(scalars[3 * b + 1]);
  const int seed_label = wolff ? seed_labels[b] : -1;
  int8_t* s = spins + base;
  const int32_t* lab = labels + base;
  for (int k = threadIdx.x; k < n_flag; k += kThreads) {
    const bool fl = flips(lab[lo + k], wolff, seed_label, s0, s1);
    uint8_t f = fl ? 1u : 0u;
    if (k < n_own) {
      const int8_t sv = s[lo + k];
      const int8_t sn = fl ? static_cast<int8_t>(-sv) : sv;
      s[lo + k] = sn;
      f |= sn > 0 ? 2u : 0u;
    }
    if (measure) flag[k] = f;
  }
  if (!measure) return;  // uniform across the launch
  __syncthreads();
  const uint8_t* st = state + base;
  const float* J = j_win + static_cast<size_t>(b / n_systems) * nw * nd;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int parts = min(ft.parts, n_blk - q0);
  for (int c = 0; c < parts; c += kPartWarps) {
    for (int k = 0; k < kPartWarps && c + k < parts; ++k) {
      const int i = (q0 + c + k) * kThreads + threadIdx.x;
      float e = 0.0f;
      int m = 0;
      if (i < n_band) {
        const int w = lo + (i - i0);
        const uint8_t f = flag[i - i0];
        const bool fl = (f & 1u) != 0;
        const uint8_t sb = st[w];
        int c1, c2;
        band_coords(geo, i, c1, c2);
#pragma unroll
        for (int dir = 0; dir < kMaxDirs; ++dir) {
          if (dir == nd) break;
          const int j = band_neighbour(geo, w, c1, c2, dir, false);
          const unsigned lj = static_cast<unsigned>(j - lo);
          const bool ff = lj < static_cast<unsigned>(n_flag)
                              ? (flag[lj] & 1u) != 0
                              : flips(lab[j], wolff, seed_label, s0, s1);
          const float prod = (((sb >> (3 + dir)) & 1u) != 0) != (fl != ff) ? -1.0f : 1.0f;
          e = e + prod * J[static_cast<size_t>(w) * nd + dir];
        }
        m = (f & 2u) ? 1 : -1;
      }
      se[k][threadIdx.x] = e;
      sm[k][threadIdx.x] = m;
    }
    __syncthreads();
    if (c + warp < parts) {
      const float et = warp_tree(se[warp], lane);
      const int mt = warp_tree(sm[warp], lane);
      if (lane == 0) {
        const size_t o = static_cast<size_t>(b) * n_blk + q0 + c + warp;
        e_part[o] = et;
        m_part[o] = mt;
      }
    }
    __syncthreads();
  }
}

inline dim3 site_grid(int n, int per_thread, int n_graphs) {
  const int groups = (n + per_thread - 1) / per_thread;
  return dim3((groups + kThreads - 1) / kThreads, n_graphs);
}

// The bond kernels' forms: fk_bonds (the square, triangular and cubic
// lattices: 2 or 3 directions), fk_bonds_staged (an offset table's whole
// lattice) and fk_bonds_band (a band's window), the last two of 1 to 6.
enum BondsForm { kFusedForm, kStagedForm, kBandForm };

// The bond kernels' launch: blockIdx.x a realization's graphs `per` at a
// time, y the groups' blocks (at most 65535, a thread striding over the
// rest), z the realization; refused unless per divides n_systems and
// n_systems n_graphs.  The vector path where every graph's row of sites (a
// band's window row too) and the pointers are aligned.  Where the threads
// loop over graphs (per > 1: a launch of at least fk.bonds_per's threads)
// on three directions or fewer, the kernel built for four blocks an SM:
// 0.300 ms against 0.342 at 4096^2 x 4, 0.085 against 0.093 in its 4-band
// window; one graph a thread (32^3 x 16: 0.0091 against 0.0077 ms) and six
// directions (FCC, 0.0118 against 0.0065) lose to its spills
// (tools/probe_bonds.py, NVIDIA H100 80GB HBM3, 700 W).
template <BondsForm kForm>
int launch_bonds(const void* spins, const void* j_fwd, const void* temps, const void* kb,
                 void* state, const int* words, int n_graphs, int n_systems, int per,
                 void* stream) {
  constexpr bool kBand = kForm == kBandForm;
  const BandWalk geo = make_band_walk(words);
  const int nb = geo.w.n_nb;
  const long long n = static_cast<long long>(geo.w.L[0]) * geo.block;
  if (n_graphs < 1 || n_graphs > 65535 || n_systems < 1 || n_graphs % n_systems || per < 1 ||
      n_systems % per || nb < 1 ||
      (kForm == kFusedForm ? nb != 2 && nb != 3 : nb > kMaxOffsets) || n < 1 ||
      n > (1LL << 31) - 4)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool kStaged = kForm == kStagedForm;
  // the staged form's launches of one graph a thread: kNb warps a CTA, one
  // direction each, 32 groups a CTA (bonds_body's kSpread)
  const bool spread = kStaged && per == 1;
  const long long span = spread ? 32 : kThreads;  // the groups a CTA takes at a time
  const long long blocks = ((n + 3) / 4 + span - 1) / span;
  const dim3 grid(n_systems / per, static_cast<unsigned>(blocks < 65535 ? blocks : 65535),
                  n_graphs / n_systems);
  const auto at = [](const void* p, unsigned a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const int vec = n % 4 == 0 && (!kBand || geo.block % 4 == 0) && at(spins, 4) &&
                  at(state, 4) && at(j_fwd, 16);
  using Kernel = void (*)(const int8_t*, const float*, const float*, const int32_t*,
                          uint8_t*, const BandWalk, int, int, int);
  const bool loop = per > 1;
  Kernel kernel;
  if (kStaged) {
    switch (nb) {
      case 1:
        kernel = spread ? fk_bonds_staged_kernel<1, 1, true> : fk_bonds_staged_kernel<1, 1, false>;
        break;
      case 2:  // not spread: per > 1, the threads loop over graphs
        kernel = spread ? fk_bonds_staged_kernel<2, 1, true> : fk_bonds_staged_kernel<2, 4, false>;
        break;
      case 3:
        kernel = spread ? fk_bonds_staged_kernel<3, 1, true> : fk_bonds_staged_kernel<3, 4, false>;
        break;
      case 4:
        kernel = spread ? fk_bonds_staged_kernel<4, 1, true> : fk_bonds_staged_kernel<4, 1, false>;
        break;
      case 5:
        kernel = spread ? fk_bonds_staged_kernel<5, 1, true> : fk_bonds_staged_kernel<5, 1, false>;
        break;
      default:
        kernel = spread ? fk_bonds_staged_kernel<6, 1, true> : fk_bonds_staged_kernel<6, 1, false>;
    }
  } else if (nb == 2) {
    kernel = kBand ? (loop ? fk_bonds_band_kernel<2, 4> : fk_bonds_band_kernel<2, 1>)
                   : (loop ? fk_bonds_kernel<2, 4> : fk_bonds_kernel<2, 1>);
  } else if (nb == 3) {
    kernel = kBand ? (loop ? fk_bonds_band_kernel<3, 4> : fk_bonds_band_kernel<3, 1>)
                   : (loop ? fk_bonds_kernel<3, 4> : fk_bonds_kernel<3, 1>);
  } else {
    kernel = nb == 1 ? fk_bonds_band_kernel<1, 1>
                     : nb == 4 ? fk_bonds_band_kernel<4, 1>
                               : nb == 5 ? fk_bonds_band_kernel<5, 1> : fk_bonds_band_kernel<6, 1>;
  }
  kernel<<<grid, spread ? 32 * nb : kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(j_fwd),
      static_cast<const float*>(temps), static_cast<const int32_t*>(kb),
      static_cast<uint8_t*>(state), geo, n_systems, per, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks per graph of fk_finish: the length of the partial-sum rows.
int peapods_fk_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Graphs of a periodic 2D or 3D lattice of 2 or 3 bond directions (square,
// triangular, cubic; words: ops/fk.py bonds_words, host memory).  spins int8
// [n_graphs, n]; j_fwd f32 [n_graphs / n_systems, n, ndir]; state uint8
// [n_graphs, n]; per: the graphs of a realization a thread takes
// (ops/fk.py bonds_per).
int peapods_fk_bonds(const void* spins, const void* j_fwd, const void* temps,
                     const void* kb, void* state, const int* words, int n_graphs,
                     int n_systems, int per, void* stream) {
  return launch_bonds<kFusedForm>(spins, j_fwd, temps, kb, state, words, n_graphs, n_systems,
                                  per, stream);
}

// Graphs of a lattice given by its offset table, 1 to 6 offsets (the staged
// path; words: ops/lattice.Lattice.sweep_words, host memory); arguments as
// peapods_fk_bonds's.  The state bytes hold the bonds alone.
int peapods_fk_bonds_staged(const void* spins, const void* j_fwd, const void* temps,
                            const void* kb, void* state, const int* words, int n_graphs,
                            int n_systems, int per, void* stream) {
  return launch_bonds<kStagedForm>(spins, j_fwd, temps, kb, state, words, n_graphs, n_systems,
                                   per, stream);
}

// The table form of peapods_fk_bonds_staged: spins int8 [n_graphs, n];
// j_fwd f32 [n_graphs / n_systems, n, nb]; state int32 [n_graphs, n], bit d
// the bond along offset d (nb <= 32); fwd int32 [n, nb] (device memory,
// 16-byte aligned).  per: the graphs of a realization a thread takes (a
// divisor of n_systems, at most kTableMaxPer); split: the warps that share
// a group's offsets (1: none; else per must be 1); ops/fk.py
// table_bonds_plan.
int peapods_fk_bonds_table(const void* spins, const void* j_fwd, const void* temps,
                           const void* kb, void* state, const void* fwd, int n, int nb,
                           int n_graphs, int n_systems, int per, int split, void* stream) {
  if (n_graphs < 1 || n_graphs > 65535 || n_systems < 1 || n_graphs % n_systems || nb < 1 ||
      nb > 32 || n < 1 || n > (1 << 30) || per < 1 || per > kTableMaxPer || n_systems % per ||
      split < 1 || split > kTableMaxSplit || (split > 1 && per != 1) ||
      reinterpret_cast<uintptr_t>(fwd) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int span = split > 1 ? 32 : kThreads;  // the groups a CTA takes
  const dim3 grid(((n + 3) / 4 + span - 1) / span, n_systems / per, n_graphs / n_systems);
  const int vec = (n % 4 == 0 && reinterpret_cast<uintptr_t>(spins) % 4 == 0) |
                  (n % 4 == 0 && reinterpret_cast<uintptr_t>(state) % 16 == 0) << 1;
  auto go = [&](auto kernel) {
    kernel<<<grid, split > 1 ? 32 * split : kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(spins), static_cast<const float*>(j_fwd),
        static_cast<const float*>(temps), static_cast<const int32_t*>(kb),
        static_cast<uint32_t*>(state), static_cast<const int32_t*>(fwd), n, nb, n_systems, per,
        split, vec);
  };
  if (split > 1) {
    go(fk_bonds_table_kernel<0, true>);
  } else {
    switch (nb) {
      case 4: go(fk_bonds_table_kernel<4, false>); break;
      case 5: go(fk_bonds_table_kernel<5, false>); break;
      case 8: go(fk_bonds_table_kernel<8, false>); break;
      case 9: go(fk_bonds_table_kernel<9, false>); break;
      case 13: go(fk_bonds_table_kernel<13, false>); break;
      default: go(fk_bonds_table_kernel<0, false>); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// state: uint8 [n_graphs, n] whose bits 0 .. ndir-1 are the forward bonds;
// parent: int32 [n_graphs, n], every entry written.  Tiles of t0 x t1 x t2
// sites, CTAs of up to `threads` threads (ops/fk.py link_plan).  When the
// tiles split the graph,
// fk_link_border and then fk_link_flatten complete the labelling.
int peapods_fk_link(const void* state, void* parent, int n_graphs, int L0, int L1,
                    int L2, int tri, int t0, int t1, int t2, int threads, void* stream) {
  const LinkTiles g = make_link_tiles(L0, L1, L2, tri, t0, t1, t2);
  if (!link_tiles_ok(g, n_graphs) || threads < g.t[g.fast] || threads > kLinkThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(link_tile_count(g), n_graphs);
  const int lines = g.t[0] * (g.fast == 2 ? g.t[1] : 1);
  const int rows = threads / g.t[g.fast];
  const dim3 block(g.t[g.fast], rows < lines ? rows : lines);
  const auto st = static_cast<const uint8_t*>(state);
  const auto par = static_cast<int32_t*>(parent);
  if (link_tile_count(g) == 1)
    fk_link_kernel<true><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(st, par, g);
  else
    fk_link_kernel<false><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(st, par, g);
  return static_cast<int>(cudaGetLastError());
}

int peapods_fk_link_border(const void* state, void* parent, int n_graphs, int L0,
                           int L1, int L2, int tri, int t0, int t1, int t2,
                           void* stream) {
  const LinkTiles g = make_link_tiles(L0, L1, L2, tri, t0, t1, t2);
  if (!link_tiles_ok(g, n_graphs)) return static_cast<int>(cudaErrorInvalidValue);
  fk_link_border_kernel<<<dim3(link_tile_count(g), n_graphs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent), g);
  return static_cast<int>(cudaGetLastError());
}

int peapods_fk_link_flatten(void* parent, int n_graphs, int n, void* stream) {
  fk_link_flatten_kernel<<<site_grid(n, 1, n_graphs), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(parent), n);
  return static_cast<int>(cudaGetLastError());
}

// words: ops/fk.py finish_words (host memory).  labels: int32 [n_graphs,
// n], each site's root (fk_link's parents, or the staged path's CC labels);
// e_part / m_part: [n_graphs, peapods_fk_blocks(n)], or both null (no
// measurement; the state bytes are then not read).
int peapods_fk_finish(void* spins, const void* state, const void* labels,
                      const void* j_fwd, const void* scalars, void* e_part, void* m_part,
                      const int* words, int n_graphs, int n_systems, int wolff,
                      void* stream) {
  const FinishWalk g = make_finish_walk(words);
  const int n_blk = (g.L[0] * g.L[1] * g.L[2] + kThreads - 1) / kThreads;
  if (!finish_tile_ok(g.ft) || (e_part != nullptr && g.ndir != 2 && g.ndir != 3) ||
      n_graphs < 1 || n_graphs > 65535 || (n_blk + g.ft.parts - 1) / g.ft.parts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_graphs, (n_blk + g.ft.parts - 1) / g.ft.parts);
  // no measurement: any geometry (the second phase does not run)
  const auto kernel = g.ndir == 3 ? (g.tri ? fk_finish_kernel<3, true> : fk_finish_kernel<3, false>)
                                  : fk_finish_kernel<2, false>;
  kernel<<<grid, kThreads, e_part != nullptr ? g.ft.ext : 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const uint8_t*>(state),
      static_cast<const int32_t*>(labels), static_cast<const float*>(j_fwd),
      static_cast<const int32_t*>(scalars), static_cast<float*>(e_part),
      static_cast<int32_t*>(m_part), g, n_systems, wolff);
  return static_cast<int>(cudaGetLastError());
}

// Band forms (band.cuh; geom: ops/lattice.Band.words).  spins int8
// [n_graphs, n_window]; j_win f32 [n_graphs / n_systems, n_window, n_nb];
// state uint8 [n_graphs, n_window].
int peapods_fk_bonds_band(const void* spins, const void* j_win, const void* temps,
                          const void* kb, void* state, const int* geom, int n_graphs,
                          int n_systems, int per, void* stream) {
  return launch_bonds<kBandForm>(spins, j_win, temps, kb, state, geom, n_graphs, n_systems,
                                 per, stream);
}

// seed_labels int32 [n_graphs] (Wolff; else null); e_part / m_part [n_graphs,
// peapods_fk_blocks(hl * L1 * L2)] or both null (no measurement; the state
// bytes must hold the "s differs" bits when measuring).  parts, ext: a
// CTA's tile (ops/fk.py band_finish_tile).
int peapods_fk_finish_band(void* spins, const void* state, const void* labels,
                           const void* j_win, const void* scalars,
                           const void* seed_labels, void* e_part, void* m_part,
                           const int* geom, int n_graphs, int n_systems, int wolff,
                           int parts, int ext, void* stream) {
  const BandWalk geo = make_band_walk(geom);
  const FinishTile ft{parts, ext};
  const int n_blk = (geo.hl * geo.block + kThreads - 1) / kThreads;
  if (!finish_tile_ok(ft) || n_graphs < 1 || n_graphs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_blk + ft.parts - 1) / ft.parts, n_graphs);
  fk_finish_band_kernel<<<grid, kThreads, e_part != nullptr ? ft.ext : 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const uint8_t*>(state),
      static_cast<const int32_t*>(labels), static_cast<const float*>(j_win),
      static_cast<const int32_t*>(scalars), static_cast<const int32_t*>(seed_labels),
      static_cast<float*>(e_part), static_cast<int32_t*>(m_part), geo, n_systems, wolff,
      ft);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
