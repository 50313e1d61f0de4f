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
//   fk_bonds   thread g owns sites 4g .. 4g+3: inter = s * s_fwd * J and
//              bond = inter > 0 && u < 1 - exp(-2 * inter / T) per forward
//              bond (the reference's operation order, so an injected-uniform
//              comparison is bitwise), u from Philox4x32-10 keyed by the
//              graph's kb words, counter (dir, site // 4, 0, 0).  Writes a
//              state byte (bit d: bond d active; bit 3 + d: s != s_fwd) and
//              parent[i] = i.
//   fk_link    one thread per site unites the two ends of each active bond
//              of the graph (uf.cuh: find with path halving, then
//              the larger root hung under the smaller with atomicCAS), so
//              that when the launch ends each component is one tree whose
//              root is its minimum site index, whatever order the threads
//              ran in: the reference's min-label fixed point, bitwise.
//              The overlap moves (csrc/overlap.cu) label their bond graphs
//              with it too.
//   fk_finish  one thread per site: label = find(i), optionally written
//              to a labels array (the parent array keeps being halved by
//              other threads' finds, so it is not the output); SW flips iff
//              salted_uniform(label, salt0, salt1) < 1/2, Wolff iff label ==
//              find(seed) (found on the device).  When measuring, the
//              post-update energy s * s_fwd * J of the site's forward
//              bonds comes from the state byte and the neighbours' flip
//              decisions (no neighbour spin is read while spins are
//              rewritten), and the block writes one (e, m) partial per graph
//              ([B, blocks]); pt_step adds them in a fixed order.  In
//              observe form (cluster_action="observe") it writes the labels
//              and nothing else: the spins stay as they are.
//
// The staged path (the reference's fk_bond_activation -> _cc_many -> coin
// or Wolff flips, peapods_tpu/engine/loop.py:1883-1976) serves the lattices
// given by an offset table (BCC, FCC, custom offsets): fk_bonds_nb draws
// the bonds along each forward offset (nb.cuh) with fk_bonds' Philox
// counter, cc.cu's cc_link / cc_label label the graphs, and fk_finish,
// given no parent array, reads each site's root from those labels and
// flips; the measurement is then sweep_nb.cu's measure_nb, so the state
// byte needs no "s differs" bits and holds up to six bonds.
//
// The band forms serve a lattice split into row bands over a "space" mesh
// (band.cuh: each band's rows and a halo of its neighbours' edge rows, the
// window):
//
//   fk_bonds_band   fk_bonds / fk_bonds_nb over every window site whose
//                   forward neighbour lies in the window: the band's own
//                   bonds, those that cross its edges, and the halo rows'
//                   bonds into the band, each drawn with the unsharded
//                   kernels' Philox counter (dir, global site / 4, 0, 0).
//                   With three directions or fewer it also writes the
//                   "s differs" bits.  The state bytes are all that
//                   cc_band.cu's labelling reads.
//   fk_finish_band  the flips of the band's sites from the global labels
//                   (cc_band.cu): the SW coin on the label, or Wolff's
//                   label == the seed's label, which the engine reads from
//                   the band that holds the seed; optionally the post-update
//                   partials of fk_finish, the forward neighbours' flips
//                   read from the halo labels.
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
// What bounds it on the H100: each launch touches a few bytes per site --
// the int8 spins, 8 or 12 B of couplings, the state byte and the int32
// parent.
// At config 3 (one 256^2 graph) that is well under 1 MB per launch (under
// 1 us at 3.35 TB/s): the launches are bound by latency and by the chains of
// dependent parent loads and atomics near T_c, where one cluster spans the
// lattice.  At 64^2 x 2048 graphs the int32 parents alone are 33.5 MB,
// read and written several times, so the kernels are bandwidth-bound at
// tens of microseconds.  Path halving keeps the chains short; holding a
// graph in shared memory with block-local union-find is later work (ROADMAP
// queue 3).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "band.cuh"
#include "mega.cuh"
#include "nb.cuh"
#include "uf.cuh"

using namespace peapods;

namespace {

constexpr int kMaxDirs = 3;

__global__ void __launch_bounds__(kThreads)
fk_bonds_kernel(const int8_t* __restrict__ spins, const float* __restrict__ j_fwd,
                const float* __restrict__ temps, const int32_t* __restrict__ kb,
                uint8_t* __restrict__ state, int32_t* __restrict__ parent,
                const Dims dims, int n_systems) {
  const int b = blockIdx.y;
  const int n = dims.n[0] * dims.n[1] * dims.n[2];
  const int nd = dims.ndir;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (kSitesPerThread * g >= n) return;
  const size_t base = static_cast<size_t>(b) * n;
  const int8_t* s = spins + base;
  const float* J = j_fwd + static_cast<size_t>(b / n_systems) * n * nd;
  const float T = temps[b];
  const uint32_t k0 = static_cast<uint32_t>(kb[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(kb[2 * b + 1]);
  uint32_t w[kMaxDirs][4];
  for (int dir = 0; dir < nd; ++dir) {
    const uint4 r = philox4x32_10(k0, k1, static_cast<uint32_t>(dir),
                                  static_cast<uint32_t>(g), 0u, 0u);
    w[dir][0] = r.x;
    w[dir][1] = r.y;
    w[dir][2] = r.z;
    w[dir][3] = r.w;
  }
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int i = kSitesPerThread * g + k;
    if (i >= n) break;
    const float si = static_cast<float>(s[i]);
    uint8_t st = 0;
    for (int dir = 0; dir < nd; ++dir) {
      const float sf = static_cast<float>(s[fwd_site(i, dims, dir)]);
      const float inter = si * sf * J[static_cast<size_t>(i) * nd + dir];
      const float p = 1.0f - expf(-2.0f * inter / T);
      if (inter > 0.0f && uniform24(w[dir][k]) < p) st |= 1u << dir;
      if (si != sf) st |= 8u << dir;
    }
    state[base + i] = st;
    parent[base + i] = i;
  }
}

// fk_bonds on a lattice given by its offset table (the staged path): the
// bond draws of fk_bonds along each forward offset, bit d of the state byte
// set when bond d is active (no "s differs" bits: the staged path measures
// after the flips), parent[i] = i for cc.cu's cc_link.
__global__ void __launch_bounds__(kThreads)
fk_bonds_nb_kernel(const int8_t* __restrict__ spins, const float* __restrict__ j_fwd,
                   const float* __restrict__ temps, const int32_t* __restrict__ kb,
                   uint8_t* __restrict__ state, int32_t* __restrict__ parent,
                   const NbGeom geo, int n_systems) {
  const int b = blockIdx.y;
  const int n = geo.L[0] * geo.L[1] * geo.L[2];
  const int nd = geo.n_nb;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (kSitesPerThread * g >= n) return;
  const size_t base = static_cast<size_t>(b) * n;
  const int8_t* s = spins + base;
  const float* J = j_fwd + static_cast<size_t>(b / n_systems) * n * nd;
  const float T = temps[b];
  const uint32_t k0 = static_cast<uint32_t>(kb[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(kb[2 * b + 1]);
  uint32_t w[kMaxOffsets][4];
  for (int dir = 0; dir < nd; ++dir) {
    const uint4 r = philox4x32_10(k0, k1, static_cast<uint32_t>(dir),
                                  static_cast<uint32_t>(g), 0u, 0u);
    w[dir][0] = r.x;
    w[dir][1] = r.y;
    w[dir][2] = r.z;
    w[dir][3] = r.w;
  }
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int i = kSitesPerThread * g + k;
    if (i >= n) break;
    int c[3];
    coords(geo, i, c);
    const float si = static_cast<float>(s[i]);
    uint8_t st = 0;
    for (int dir = 0; dir < nd; ++dir) {
      const float sf = static_cast<float>(s[neighbour(geo, c, dir, 1)]);
      const float inter = si * sf * J[static_cast<size_t>(i) * nd + dir];
      const float p = 1.0f - expf(-2.0f * inter / T);
      if (inter > 0.0f && uniform24(w[dir][k]) < p) st |= 1u << dir;
    }
    state[base + i] = st;
    parent[base + i] = i;
  }
}

__global__ void __launch_bounds__(kThreads)
fk_link_kernel(const uint8_t* __restrict__ state, int32_t* parent, const Dims dims) {
  const int b = blockIdx.y;
  const int n = dims.n[0] * dims.n[1] * dims.n[2];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t st = state[static_cast<size_t>(b) * n + i];
  if (!(st & ((1u << dims.ndir) - 1u))) return;
  link_site(parent + static_cast<size_t>(b) * n, st, i, dims);
}

__device__ __forceinline__ bool flips(int root, int wolff, int seed_root,
                                      uint32_t s0, uint32_t s1) {
  return wolff ? root == seed_root
               : salted_uniform(static_cast<uint32_t>(root), s0, s1) < 0.5f;
}

__global__ void __launch_bounds__(kThreads)
fk_finish_kernel(int8_t* __restrict__ spins, const uint8_t* __restrict__ state,
                 int32_t* parent, int32_t* labels, const float* __restrict__ j_fwd,
                 const int32_t* __restrict__ scalars, float* __restrict__ e_part,
                 int32_t* __restrict__ m_part, const Dims dims, int n_systems,
                 int wolff, int observe) {
  const int b = blockIdx.y;
  const int n = dims.n[0] * dims.n[1] * dims.n[2];
  const int nd = dims.ndir;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool measure = e_part != nullptr;
  float e_acc = 0.0f;
  int m_acc = 0;
  if (i < n) {
    const size_t base = static_cast<size_t>(b) * n;
    int32_t* P = parent == nullptr ? nullptr : parent + base;
    // the root of site j: from the union-find, or (parent null, the staged
    // path) from the labels of the CC kernels
    auto root = [&](int j) { return P ? find_root(P, j) : labels[base + j]; };
    const int r = root(i);
    if (P && labels != nullptr) labels[base + i] = r;
    if (observe) return;  // labels only: no flip, no measurement
    const uint32_t s0 = static_cast<uint32_t>(scalars[3 * b]);
    const uint32_t s1 = static_cast<uint32_t>(scalars[3 * b + 1]);
    const int seed_root = wolff ? root(scalars[3 * b + 2]) : -1;
    const bool fl = flips(r, wolff, seed_root, s0, s1);
    const int8_t sn = fl ? static_cast<int8_t>(-spins[base + i]) : spins[base + i];
    spins[base + i] = sn;
    if (measure) {
      const uint8_t st = state[base + i];
      const float* J = j_fwd + (static_cast<size_t>(b / n_systems) * n + i) * nd;
      // s * s_fwd after the update, from "s differed" and the two flips
      float e = 0.0f;
      for (int dir = 0; dir < nd; ++dir) {
        const bool ff = flips(root(fwd_site(i, dims, dir)), wolff, seed_root, s0, s1);
        const float prod = (((st >> (3 + dir)) & 1u) != 0) != (fl != ff) ? -1.0f : 1.0f;
        e = e + prod * J[dir];
      }
      e_acc = e;
      m_acc = sn;
    }
  }
  if (!measure) return;  // uniform across the block
  block_partials(e_acc, m_acc, e_part, m_part,
                 static_cast<size_t>(b) * gridDim.x + blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
fk_bonds_band_kernel(const int8_t* __restrict__ spins, const float* __restrict__ j_win,
                     const float* __restrict__ temps, const int32_t* __restrict__ kb,
                     uint8_t* __restrict__ state, const BandWalk geo, int n_systems) {
  const int b = blockIdx.y;
  const int nw = geo.w.L[0] * geo.block;
  const int nd = geo.w.n_nb;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (kSitesPerThread * g >= nw) return;
  const size_t base = static_cast<size_t>(b) * nw;
  const int8_t* s = spins + base;
  const float* J = j_win + static_cast<size_t>(b / n_systems) * nw * nd;
  const float T = temps[b];
  const uint32_t k0 = static_cast<uint32_t>(kb[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(kb[2 * b + 1]);
  uint4 r[kMaxOffsets];
  int grp = -1;
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int w = kSitesPerThread * g + k;
    if (w >= nw) break;
    const int gid = window_global(geo, w);
    if ((gid >> 2) != grp) {
      grp = gid >> 2;
#pragma unroll
      for (int dir = 0; dir < kMaxOffsets; ++dir) {
        if (dir == nd) break;
        r[dir] = philox4x32_10(k0, k1, static_cast<uint32_t>(dir),
                               static_cast<uint32_t>(grp), 0u, 0u);
      }
    }
    int c1, c2;
    const int row = band_coords(geo, w, c1, c2);
    const float si = static_cast<float>(s[w]);
    uint8_t st = 0;
#pragma unroll
    for (int dir = 0; dir < kMaxOffsets; ++dir) {
      if (dir == nd) break;
      const int to = row + geo.w.off[dir][0];  // the bond leaves the window: none
      if (to < 0 || to >= geo.w.L[0]) continue;
      const int j = band_neighbour(geo, w, c1, c2, dir, false);
      const float sf = static_cast<float>(s[j]);
      const float inter = si * sf * J[static_cast<size_t>(w) * nd + dir];
      const float p = 1.0f - expf(-2.0f * inter / T);
      if (inter > 0.0f && uniform24(philox_word(r[dir], gid)) < p) st |= 1u << dir;
      if (nd <= kMaxDirs && si != sf) st |= 8u << dir;
    }
    state[base + w] = st;
  }
}

// fk_finish_band's work of one CTA: `parts` consecutive partial blocks of
// kThreads sites, and the flips it stages in shared memory, `ext` sites
// from its first (its own and, when measuring, those that its sites' forward
// neighbours reach within one tile).
struct FinishTile {
  int parts;
  int ext;
};

constexpr int kMaxFinishParts = 32;
constexpr int kFinishCtas = 1024;  // about one wave of the H100's resident CTAs
constexpr int kPartWarps = kThreads / 32;

inline FinishTile finish_tile(const BandGeom& g, int n_graphs) {
  const int n_blk = (g.hl * g.block + kThreads - 1) / kThreads;
  FinishTile ft{kMaxFinishParts, 0};
  while (ft.parts > 1 &&
         static_cast<long long>((n_blk + ft.parts - 1) / ft.parts) * n_graphs < kFinishCtas)
    ft.parts >>= 1;
  const int tile = ft.parts * kThreads;
  int reach = 0;
  for (int d = 0; d < g.w.n_nb; ++d) {
    const int f = g.w.off[d][0] * g.block + g.w.off[d][1] * g.w.L[2] + g.w.off[d][2];
    if (f <= tile && f > reach) reach = f;
  }
  ft.ext = tile + reach;
  return ft;
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

}  // namespace

extern "C" {

// Blocks per graph of fk_finish: the length of the partial-sum rows.
int peapods_fk_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Graphs of [L0, L1, L2] sites (L2 = 1 in 2D); tri: the triangular lattice.
// spins int8 [n_graphs, n]; j_fwd f32 [n_graphs / n_systems, n, ndir].
int peapods_fk_bonds(const void* spins, const void* j_fwd, const void* temps,
                     const void* kb, void* state, void* parent, int n_graphs,
                     int n_systems, int L0, int L1, int L2, int tri, void* stream) {
  const Dims dims = make_dims(L0, L1, L2, tri != 0);
  fk_bonds_kernel<<<site_grid(L0 * L1 * L2, kSitesPerThread, n_graphs), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(j_fwd),
      static_cast<const float*>(temps), static_cast<const int32_t*>(kb),
      static_cast<uint8_t*>(state), static_cast<int32_t*>(parent), dims, n_systems);
  return static_cast<int>(cudaGetLastError());
}

// state: uint8 [n_graphs, n] whose bits 0 .. ndir-1 are the forward bonds;
// parent: int32 [n_graphs, n], parent[i] = i.
int peapods_fk_link(const void* state, void* parent, int n_graphs, int L0, int L1,
                    int L2, int tri, void* stream) {
  fk_link_kernel<<<site_grid(L0 * L1 * L2, 1, n_graphs), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent),
      make_dims(L0, L1, L2, tri != 0));
  return static_cast<int>(cudaGetLastError());
}

// Graphs of an offset table (geom: ops/lattice.Lattice.kernel_geometry);
// state: uint8 [n_graphs, n]; parent: int32 [n_graphs, n].
int peapods_fk_bonds_nb(const void* spins, const void* j_fwd, const void* temps,
                        const void* kb, void* state, void* parent, const int* geom,
                        int n_graphs, int n_systems, void* stream) {
  const NbGeom geo = make_geom(geom);
  fk_bonds_nb_kernel<<<site_grid(geo.L[0] * geo.L[1] * geo.L[2], kSitesPerThread,
                                 n_graphs),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(j_fwd),
      static_cast<const float*>(temps), static_cast<const int32_t*>(kb),
      static_cast<uint8_t*>(state), static_cast<int32_t*>(parent), geo, n_systems);
  return static_cast<int>(cudaGetLastError());
}

// labels: int32 [n_graphs, n] or null; e_part / m_part: [n_graphs,
// peapods_fk_blocks(n)], or both null.  parent null: the roots are read from
// labels (the staged path's CC output), which are not written.  observe:
// write the labels only, leaving the spins and the partials alone.
int peapods_fk_finish(void* spins, const void* state, void* parent, void* labels,
                      const void* j_fwd, const void* scalars, void* e_part,
                      void* m_part, int n_graphs, int n_systems, int L0, int L1,
                      int L2, int tri, int wolff, int observe, void* stream) {
  fk_finish_kernel<<<site_grid(L0 * L1 * L2, 1, n_graphs), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const uint8_t*>(state),
      static_cast<int32_t*>(parent), static_cast<int32_t*>(labels),
      static_cast<const float*>(j_fwd), static_cast<const int32_t*>(scalars),
      static_cast<float*>(e_part), static_cast<int32_t*>(m_part),
      make_dims(L0, L1, L2, tri != 0), n_systems, wolff, observe);
  return static_cast<int>(cudaGetLastError());
}

// Band forms (band.cuh; geom: ops/lattice.Band.words).  spins int8
// [n_graphs, n_window]; j_win f32 [n_graphs / n_systems, n_window, n_nb];
// state uint8 [n_graphs, n_window].
int peapods_fk_bonds_band(const void* spins, const void* j_win, const void* temps,
                          const void* kb, void* state, const int* geom, int n_graphs,
                          int n_systems, void* stream) {
  const BandWalk geo = make_band_walk(geom);
  fk_bonds_band_kernel<<<site_grid(geo.w.L[0] * geo.block, kSitesPerThread, n_graphs),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(j_win),
      static_cast<const float*>(temps), static_cast<const int32_t*>(kb),
      static_cast<uint8_t*>(state), geo, n_systems);
  return static_cast<int>(cudaGetLastError());
}

// seed_labels int32 [n_graphs] (Wolff; else null); e_part / m_part [n_graphs,
// peapods_fk_blocks(hl * L1 * L2)] or both null (no measurement; the state
// bytes must hold the "s differs" bits when measuring).
int peapods_fk_finish_band(void* spins, const void* state, const void* labels,
                           const void* j_win, const void* scalars,
                           const void* seed_labels, void* e_part, void* m_part,
                           const int* geom, int n_graphs, int n_systems, int wolff,
                           void* stream) {
  const BandWalk geo = make_band_walk(geom);
  const FinishTile ft = finish_tile(geo, n_graphs);
  const int n_blk = (geo.hl * geo.block + kThreads - 1) / kThreads;
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
