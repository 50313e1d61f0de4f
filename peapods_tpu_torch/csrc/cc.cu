// Hopper kernels of the connected components of a batch of bond graphs on
// any lattice given by its forward offsets (up to six, 2D or 3D, the walk
// form; or, the table form, 4D and up or 7 to 32 offsets, by the lattice's
// int32 forward table): every site gets the minimum site index of its
// component, on the caller's stream.
//
// Replaces the TPU's
//   peapods_tpu/ops/pallas_cc_batch.py:428 connected_components_batch
//     (kernel _cc_batch_kernel :394, the fixed point cc_fixed_point :188 and,
//     for offset tables, pallas_cc_band._generic_fixed_point :140 through
//     cc_gen_offsets :332), and
//   peapods_tpu/ops/pallas_cc.py:66 connected_components_2d (kernel
//     _cc_kernel :47: the same function for one 2D square graph).
// Both compute the min-label fixed point of peapods_tpu/ops/cluster.py:113.
// The TPU's tile packing, log-doubling ladders and scan bodies only served
// its label propagation; here a union-find gives the same labels.
//
// The labelling is fk.cu's fk_link carried over to offset tables, in two
// forms that ops/cc.py link_plan picks from the shape alone:
//
//   cc_link          whole-graph form, a graph of at most kCcSites sites, in
//                    one launch: a thread-block cluster of C CTAs a graph (C
//                    = 1 to 8, more while the launch holds few CTAs), each
//                    CTA a slab of consecutive sites in shared memory.  A
//                    CTA stages its slab's state bytes, hangs each run of
//                    fast-axis unit bonds inside a warp under its first site
//                    (a ballot; only where an offset is the fast axis' unit
//                    step, as NNN's [0, 1]), unites the slab's other bonds
//                    with uf.cuh's tile_unite (the smaller root wins), a
//                    round of sites at a time with the round's sites then
//                    pointed at their roots; then the bonds between slabs
//                    are united the same way in distributed shared memory,
//                    and every site's label written once, its root: the
//                    component's minimum site index, bitwise the
//                    reference's min-label fixed point.  Over a cluster of
//                    several CTAs, the warp's lanes that join the same pair
//                    of roots leave it to one lane (__match_any_sync): bonds
//                    of one cluster often reach one root.  Tiled form, a larger graph: the
//                    same in boxes of t0 x t1 x t2 sites, one a CTA (a box
//                    that spans an axis holds the bonds that wrap around
//                    it), each site's parent written as its box component's
//                    minimum site;
//   cc_link_border   (tiled form) a CTA a box unites, as pairs of box roots
//                    in global memory (uf.cuh unite: the larger root hung
//                    under the smaller with atomicCAS), every active bond
//                    whose neighbour at its offset lies outside the box:
//                    diagonal offsets cross edges and corners, and an
//                    offset may reach past the next box;
//   fk_link_flatten  (tiled form; fk.cu's, geometry-free) every parent
//                    pointed at its root: the labels.
//
// Neighbours come from box coordinates and one compare an axis: a site's
// coordinates are two multiply-shift divisions of its index (band.cuh's
// scheme; the host's fast_divisor), an axis the box spans wraps by the
// offset's residue (off mod L, from the host), any other axis adds the
// offset and leaves the box where the sum falls outside it.  No runtime
// division or modulo runs in a kernel.  The kernels are templated on the
// number of offsets and the dimension (d known at compile time: no index
// into the geometry at run time, which would put it in local memory).
//
// What bounds it on the H100: the function reads a state byte a site and
// writes an int32 label a site, 5 B a site: 164 KB at BCC / FCC 16^3 x 8
// graphs (0.049 us at 3.35 TB/s), 42 MB at 2048 graphs of 64^2.  The first
// design (a thread a site uniting in global memory with atomicCAS from
// parents that fk_bonds_nb wrote as parent[i] = i, nb.cuh's runtime
// divisions and modulos a site and offset, then a second launch finding
// every root again) ran 0.038-0.055 ms at BCC, FCC and NNN 64^2 x 8 and
// 2.0 ms at 2048 x 64^2 NNN (NVIDIA H100 80GB HBM3, 700 W; random bonds
// above the percolation threshold, tools/probe_colour_cc.py).  What holds
// this one is the chains of dependent finds behind each union, not bytes:
// one CTA a 16^3 graph took 0.050-0.063 ms (the unions 80% of it), a
// cluster of 8 CTAs 0.032-0.033, where the bonds between slabs, through
// distributed shared memory, are 40% of the time (n-nocross); the warp's
// pair leader took 0.038 to 0.033, and slowed one CTA a graph (2048 graphs
// of 64^2: 0.525 to 0.644), which unites without it.  PERF.md holds the
// times.
//
// The table form (cc_table_link; past one cluster's shared memory also
// cc_table_border and fk_link_flatten) replaces the same TPU kernel
// through cc_gen_offsets :332.  What bounds it on the H100: it reads a
// 4-byte state word a site and the forward table once (4 nb bytes a site,
// shared by every graph) and writes a label a site: at the 4D +-J glass
// (384 graphs of 10^4 sites, 4 offsets) 30.9 MB, 0.0092 ms at 3.35 TB/s.
// The first design (cc_table_init setting parent[i] = i, cc_table_link a
// thread a site uniting in global memory with atomicCAS, every find a
// chain of dependent L2 loads, then fk_link_flatten: three launches and
// three passes over 4 B a site) took 0.79 ms a labelling on average there,
// 0.0729 ms (its link alone) at 16^4 x 16 graphs and 0.0349 ms at 16^3
// with 13 offsets x 8 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phases
// 36 and 38).  This one carries cc_link's design over: a graph's
// union-find in shared memory (one CTA a graph at 10^4 sites; a cluster of
// up to 8 CTAs while the launch holds few CTAs, or where the graph needs
// it), one launch, every label written once; as in cc_link, what remains
// is the chains of dependent finds in shared memory and, over a cluster,
// the unions in distributed shared memory.  PERF.md holds the times.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"
#include "nb.cuh"
#include "uf.cuh"

using namespace peapods;

namespace cg = cooperative_groups;

namespace {

constexpr int kCcThreads = 1024;   // the most threads a link CTA takes
constexpr int kCcSites = 8192;     // a box's parents and state bytes: 40 KB of shared memory
constexpr int kCcDivisors = 5;     // t1 t2, t2, nt1 nt2, nt2, the slab's sites
constexpr int kCcMaxCluster = 8;   // CTAs a graph of the whole-graph form (portable)

// The lattice, its boxes and the division-free steps (ops/cc.py link_words):
// extents [L0, L1, L2] (L2 = 1 in 2D), a box's extents t (t = L: the whole
// graph, one box), the boxes along each axis, the offsets and their
// residues off mod L in [0, L), the offset that is the fast axis' unit step
// (or -1), (m, s) with q / divisor = umulhi(q, m) >> s (m = 0 for 1), and
// the whole-graph form's cluster: C CTAs a graph, each a slab of bs
// consecutive sites.
struct CcWalk {
  int L[3];
  int t[3];
  int nt[3];
  int n_nb;
  int fast_d;
  int off[kMaxOffsets][3];
  int res[kMaxOffsets][3];
  uint32_t div_m[kCcDivisors];
  int div_s[kCcDivisors];
  int C;
  int bs;
};

inline CcWalk make_cc_walk(const int* w) {
  CcWalk g;
  for (int k = 0; k < 3; ++k) {
    g.L[k] = w[k];
    g.t[k] = w[3 + k];
    g.nt[k] = w[6 + k];
  }
  g.n_nb = w[9];
  g.fast_d = w[10];
  for (int d = 0; d < kMaxOffsets; ++d)
    for (int k = 0; k < 3; ++k) {
      g.off[d][k] = w[11 + 3 * d + k];
      g.res[d][k] = w[11 + 3 * kMaxOffsets + 3 * d + k];
    }
  for (int k = 0; k < kCcDivisors; ++k) {
    g.div_m[k] = static_cast<uint32_t>(w[11 + 6 * kMaxOffsets + 2 * k]);
    g.div_s[k] = w[12 + 6 * kMaxOffsets + 2 * k];
  }
  g.C = w[11 + 6 * kMaxOffsets + 2 * kCcDivisors];
  g.bs = w[12 + 6 * kMaxOffsets + 2 * kCcDivisors];
  return g;
}

__device__ __forceinline__ int cc_div(const CcWalk& g, int k, int q) {
  return g.div_m[k]
             ? static_cast<int>(__umulhi(static_cast<uint32_t>(q), g.div_m[k]) >> g.div_s[k])
             : q;
}

// A box: its origin and its extents inside the lattice (a last box along an
// axis may be cut short); its sites are indexed (x0 t1 + x1) t2 + x2 over
// the full t0 x t1 x t2, so that index order is site order.
struct CcBox {
  int o[3];
  int e[3];
};

template <bool kWhole>
__device__ __forceinline__ CcBox cc_box(const CcWalk& g, int bx) {
  CcBox b;
  if (kWhole) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b.o[k] = 0;
      b.e[k] = g.L[k];
    }
    return b;
  }
  const int i0 = cc_div(g, 2, bx);
  const int r = bx - i0 * g.nt[1] * g.nt[2];
  const int i1 = cc_div(g, 3, r);
  const int i[3] = {i0, i1, r - i1 * g.nt[2]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b.o[k] = i[k] * g.t[k];
    b.e[k] = min(g.t[k], g.L[k] - b.o[k]);
  }
  return b;
}

// Box coordinates of box index l.
template <bool k3>
__device__ __forceinline__ void cc_coords(const CcWalk& g, int l, int x[3]) {
  x[0] = cc_div(g, 0, l);
  const int r = l - x[0] * g.t[1] * g.t[2];
  if (k3) {
    x[1] = cc_div(g, 1, r);
    x[2] = r - x[1] * g.t[2];
  } else {
    x[1] = r;
    x[2] = 0;
  }
}

template <bool k3>
__device__ __forceinline__ bool cc_inside(const CcBox& b, const int x[3]) {
  return x[0] < b.e[0] && x[1] < b.e[1] && (!k3 || x[2] < b.e[2]);
}

// The site index in its graph of box coordinates x.
template <bool k3>
__device__ __forceinline__ int cc_site(const CcWalk& g, const CcBox& b, const int x[3]) {
  const int i = (b.o[0] + x[0]) * g.L[1] + b.o[1] + x[1];
  return k3 ? i * g.L[2] + b.o[2] + x[2] : i;
}

// The box index of the neighbour of x at offset d, or -1 where it lies
// outside the box.  An axis the box spans wraps by the residue; on another
// the offset is added, and the neighbour (o + x + off, in [o, o + e)) needs
// no wrap.  d must be known at compile time.
template <bool k3, bool kWhole>
__device__ __forceinline__ int cc_step(const CcWalk& g, const CcBox& b, const int x[3],
                                       int d) {
  int y[3];
#pragma unroll
  for (int k = 0; k < (k3 ? 3 : 2); ++k) {
    if (kWhole || g.nt[k] == 1) {
      int v = x[k] + g.res[d][k];
      if (v >= g.L[k]) v -= g.L[k];
      y[k] = v;
    } else {
      const int v = x[k] + g.off[d][k];
      if (v < 0 || v >= b.e[k]) return -1;
      y[k] = v;
    }
  }
  const int l = y[0] * g.t[1] + y[1];
  return k3 ? l * g.t[2] + y[2] : l;
}

// The site index of the neighbour of box coordinates x at offset d, each
// axis wrapped on its own.
template <bool k3>
__device__ __forceinline__ int cc_neighbour(const CcWalk& g, const CcBox& b, const int x[3],
                                            int d) {
  int y[3];
#pragma unroll
  for (int k = 0; k < (k3 ? 3 : 2); ++k) {
    int v = b.o[k] + x[k] + g.res[d][k];
    if (v >= g.L[k]) v -= g.L[k];
    y[k] = v;
  }
  const int i = y[0] * g.L[1] + y[1];
  return k3 ? i * g.L[2] + y[2] : i;
}

// Whether this lane unites the pair of roots (ra, rb) (want): the lowest of
// the warp's lanes that want the same pair, so that one atomic, not one a
// lane, hangs a root that many bonds reach.  Every lane of the warp calls
// it.
__device__ __forceinline__ bool lead_pair(bool want, int ra, int rb, int lane) {
  const unsigned long long key =
      want ? (static_cast<unsigned long long>(static_cast<unsigned>(min(ra, rb))) << 32) |
                 static_cast<unsigned>(max(ra, rb))
           : ~0ull;
  const unsigned same = __match_any_sync(0xffffffffu, key);
  return want && __ffs(same) - 1 == lane;
}

// The whole-graph form's union-find across a cluster: a parent is a site
// index of the graph, held by the CTA whose slab holds that site (slab q =
// slab_of(g, v): sites q bs .. q bs + bs - 1), in its shared memory or, for
// another CTA's slab, in distributed shared memory.  G: the walk's words
// (CcWalk) or the table form's (CcTable).
struct Slabs {
  cg::cluster_group cluster;
  int* P;  // this CTA's parents, indexed by site - lo
  int me;
};

__device__ __forceinline__ int slab_of(const CcWalk& g, int v) { return cc_div(g, 4, v); }

template <typename G>
__device__ __forceinline__ volatile int* slab_slot(Slabs& sl, const G& g, int v) {
  const int q = slab_of(g, v);
  int* base = q == sl.me ? sl.P : sl.cluster.map_shared_rank(sl.P, q);
  return base + (v - q * g.bs);
}

// Root of v, halving the path on the way (only non-roots are written, so a
// root's atomicMin, local or remote, never races a halving).
template <typename G>
__device__ __forceinline__ int slab_root(Slabs& sl, const G& g, int v) {
  while (true) {
    volatile int* pv = slab_slot(sl, g, v);
    const int p = *pv;
    if (p == v) return v;
    const int gp = *slab_slot(sl, g, p);
    if (gp == p) return p;
    *pv = gp;
    v = gp;
  }
}

// tile_unite over the cluster: the larger root takes the smaller as its
// parent (atomicMin on its slot, local or remote); where it was hung
// elsewhere meanwhile, its old parent is joined next.
template <typename G>
__device__ __forceinline__ void slab_unite(Slabs& sl, const G& g, int a, int b) {
  while (true) {
    a = slab_root(sl, g, a);
    b = slab_root(sl, g, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(const_cast<int*>(slab_slot(sl, g, a)), b);
    if (old == a) return;
    a = old;
  }
}

// A CTA labels one box of a graph in shared memory: (1) the state bytes
// into S, then each run of fast-axis unit bonds inside a warp hung under
// its first site (a ballot, no atomics); (2) the other bonds inside the box
// united (tile_unite: the smaller root wins, and box order is site order),
// a round of blockDim.x sites at a time, each round ending with its sites
// pointed at their roots (so that the next round's finds stay short); (3)
// every site's output written once.  Tiled form: its box root, as a site
// index.  Whole-graph form (kWhole): the box is the graph, cut into the
// cluster's C slabs of consecutive sites, a slab a CTA (C = 1: the graph
// in one CTA); after (2) inside each slab, every parent becomes its slab
// root's site index, the cluster waits, (2b) each bond that leaves its
// slab is united across the cluster in distributed shared memory
// (slab_unite), the cluster waits, and (3) each site's root, the
// component's minimum site, is its label.  kCluster: the form over a
// cluster (C > 1), a kernel of its own so that one CTA a graph carries none
// of its code.  (No array is indexed at run time: that would put it in
// local memory.)
template <int NB, bool k3, bool kWhole, bool kCluster>
__global__ void __launch_bounds__(kCcThreads)
cc_link_kernel(const uint8_t* __restrict__ state, int32_t* __restrict__ out, const CcWalk g,
               int rounds) {
  __shared__ int P[kCcSites];
  __shared__ uint8_t S[kCcSites];
  const int n = g.L[0] * g.L[1] * g.L[2];
  const uint8_t* st = state + static_cast<size_t>(blockIdx.y) * n;
  int32_t* o = out + static_cast<size_t>(blockIdx.y) * n;
  const CcBox b = cc_box<kWhole>(g, blockIdx.x);
  // kWhole: this CTA's slab lo .. lo + sites - 1; else its box, box-indexed
  const int lo = kWhole ? static_cast<int>(blockIdx.x) * g.bs : 0;
  const int sites = kWhole ? max(0, min(g.bs, n - lo)) : g.t[0] * g.t[1] * g.t[2];
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const unsigned mask = (1u << NB) - 1u;
  const int fa = k3 ? 2 : 1;  // the fast axis
  for (int it = 0; it < rounds; ++it) {
    const int l = it * T + threadIdx.x;
    if (l >= sites) break;
    unsigned s = 0;
    if (kWhole) {
      s = st[lo + l];
    } else {
      int x[3];
      cc_coords<k3>(g, l, x);
      if (cc_inside<k3>(b, x)) s = st[cc_site<k3>(g, b, x)];
    }
    S[l] = static_cast<uint8_t>(s & mask);
  }
  __syncthreads();
  for (int it = 0; it < rounds; ++it) {
    const int l = it * T + threadIdx.x;
    const bool on = l < sites;
    if (g.fast_d < 0) {  // uniform
      if (on) P[l] = l;
      continue;
    }
    bool run = false;
    if (on && ((S[l] >> g.fast_d) & 1u)) {
      int x[3];
      cc_coords<k3>(g, lo + l, x);
      run = x[fa] + 1 < b.e[fa] && (!kWhole || l + 1 < sites);
    }
    const unsigned starts = ~(__ballot_sync(0xffffffffu, run) << 1);
    const int first = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
    if (on) P[l] = l - (lane - first);
  }
  __syncthreads();
  for (int it = 0; it < rounds; ++it) {  // a round of unions, then its sites' finds
    const int l = it * T + threadIdx.x;
    const unsigned s = l < sites ? S[l] : 0u;
    int x[3] = {0, 0, 0};
    if (s) cc_coords<k3>(g, lo + l, x);
#pragma unroll
    for (int d = 0; d < NB; ++d) {  // uniform: the lanes match their pairs
      int j = -1;
      if (((s >> d) & 1u) &&
          !(d == g.fast_d && x[fa] + 1 < b.e[fa] && lane != 31 && (!kWhole || l + 1 < sites))) {
        j = cc_step<k3, kWhole>(g, b, x, d);  // (else: a run)
        if (kWhole) j = static_cast<unsigned>(j - lo) < static_cast<unsigned>(sites) ? j - lo : -1;
      }
      if (kCluster) {  // a cluster's slabs: each pair once a warp
        int ra = 0, rb = 0;
        if (j >= 0) {
          ra = tile_root(P, l);
          rb = tile_root(P, j);
        }
        if (lead_pair(j >= 0 && ra != rb, ra, rb, lane)) tile_unite(P, ra, rb);
      } else if (j >= 0) {
        tile_unite(P, l, j);
      }
    }
    __syncthreads();
    if (l < sites) P[l] = tile_root(P, l);
    __syncthreads();
  }
  if (!kWhole) {
    for (int it = 0; it < rounds; ++it) {
      const int l = it * T + threadIdx.x;
      if (l >= sites) break;
      const int r = tile_root(P, l);
      int x[3], xr[3];
      cc_coords<k3>(g, l, x);
      if (!cc_inside<k3>(b, x)) continue;
      cc_coords<k3>(g, r, xr);
      o[cc_site<k3>(g, b, x)] = cc_site<k3>(g, b, xr);
    }
    return;
  }
  // kWhole: every parent its slab root's site index
  constexpr int kPer = kCcSites / kCcThreads;  // a thread's sites at most (the host's rule)
  int rt[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int l = k * T + threadIdx.x;
    if (l < sites) rt[k] = lo + tile_root(P, l);
  }
  if (!kCluster) {  // the slab is the graph
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int l = k * T + threadIdx.x;
      if (l < sites) o[l] = rt[k];
    }
    return;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int l = k * T + threadIdx.x;
    if (l < sites) P[l] = rt[k];
  }
  Slabs sl{cg::this_cluster(), P, static_cast<int>(blockIdx.x)};
  sl.cluster.sync();  // every slab's parents are site indices
  for (int it = 0; it < rounds; ++it) {  // (2b) the bonds between slabs
    const int l = it * T + threadIdx.x;
    const unsigned s = l < sites ? S[l] : 0u;
    int x[3] = {0, 0, 0};
    if (s) cc_coords<k3>(g, lo + l, x);
#pragma unroll
    for (int d = 0; d < NB; ++d) {  // uniform: the lanes match their pairs
      bool cross = false;
      int ra = 0, rb = 0;
      if ((s >> d) & 1u) {
        const int j = cc_step<k3, true>(g, b, x, d);
        if (static_cast<unsigned>(j - lo) >= static_cast<unsigned>(sites)) {
          ra = slab_root(sl, g, lo + l);
          rb = slab_root(sl, g, j);
          cross = ra != rb;
        }
      }
      if (lead_pair(cross, ra, rb, lane)) slab_unite(sl, g, ra, rb);
    }
  }
  sl.cluster.sync();  // every union done
  for (int it = 0; it < rounds; ++it) {
    const int l = it * T + threadIdx.x;
    if (l >= sites) break;
    int v = lo + l;  // its root, read only
    for (int p; (p = *slab_slot(sl, g, v)) != v;) v = p;
    o[lo + l] = v;
  }
  sl.cluster.sync();  // no CTA leaves while another reads its shared memory
}

// The tiled form's bonds that leave their box, united in global memory
// (uf.cuh unite) as pairs of the two ends' box roots, which cc_link wrote,
// each pair once a warp (lead_pair).  A CTA walks every
// site of its box (a neighbour at a long offset may leave it from any
// layer).
template <int NB, bool k3>
__global__ void __launch_bounds__(kThreads)
cc_link_border_kernel(const uint8_t* __restrict__ state, int32_t* parent, const CcWalk g) {
  const size_t n = static_cast<size_t>(g.L[0]) * g.L[1] * g.L[2];
  const uint8_t* st = state + blockIdx.y * n;
  int32_t* P = parent + blockIdx.y * n;
  const CcBox b = cc_box<false>(g, blockIdx.x);
  const int sites = g.t[0] * g.t[1] * g.t[2];
  const int lane = threadIdx.x & 31;
  const unsigned mask = (1u << NB) - 1u;
  for (int q0 = 0; q0 < sites; q0 += blockDim.x) {  // uniform: the warps shuffle
    const int l = q0 + threadIdx.x;
    int x[3];
    cc_coords<k3>(g, l, x);
    const bool in = l < sites && cc_inside<k3>(b, x);
    const int i = in ? cc_site<k3>(g, b, x) : 0;
    const unsigned s = in ? st[i] & mask : 0u;
#pragma unroll
    for (int d = 0; d < NB; ++d) {
      const bool cross = ((s >> d) & 1u) && cc_step<k3, false>(g, b, x, d) < 0;
      const int j = cross ? cc_neighbour<k3>(g, b, x, d) : 0;
      const int ra = cross ? __ldcg(P + i) : 0;
      const int rb = cross ? __ldcg(P + j) : 0;
      if (lead_pair(cross && ra != rb, ra, rb, lane)) unite(P, ra, rb);
    }
  }
}

using LinkKernel = void (*)(const uint8_t*, int32_t*, const CcWalk, int);
using BorderKernel = void (*)(const uint8_t*, int32_t*, const CcWalk);

template <bool k3, bool kWhole, bool kCluster>
LinkKernel link_kernel(int nb) {
  switch (nb) {
    case 1: return cc_link_kernel<1, k3, kWhole, kCluster>;
    case 2: return cc_link_kernel<2, k3, kWhole, kCluster>;
    case 3: return cc_link_kernel<3, k3, kWhole, kCluster>;
    case 4: return cc_link_kernel<4, k3, kWhole, kCluster>;
    case 5: return cc_link_kernel<5, k3, kWhole, kCluster>;
    default: return cc_link_kernel<6, k3, kWhole, kCluster>;
  }
}

// The form's kernel: tiled, the whole graph in one CTA, or over a cluster.
template <bool k3>
LinkKernel form_kernel(bool whole, bool cluster, int nb) {
  return !whole ? link_kernel<k3, false, false>(nb)
                : cluster ? link_kernel<k3, true, true>(nb) : link_kernel<k3, true, false>(nb);
}

template <bool k3>
BorderKernel border_kernel(int nb) {
  switch (nb) {
    case 1: return cc_link_border_kernel<1, k3>;
    case 2: return cc_link_border_kernel<2, k3>;
    case 3: return cc_link_border_kernel<3, k3>;
    case 4: return cc_link_border_kernel<4, k3>;
    case 5: return cc_link_border_kernel<5, k3>;
    default: return cc_link_border_kernel<6, k3>;
  }
}

// The table form (4D and up, or 7 to 32 offsets; ops/lattice.Lattice.
// table): cc_link's whole-graph design over the bonds of the int32 forward
// table fwd [n, nb] (shared by every graph, so it stays in L2).  A CTA
// takes a slab of bs consecutive sites; its parents and its state words
// (a byte a site up to 8 offsets, two up to 16, else four: the bits of the
// graph's int32 words, read once) live in dynamic shared memory.  (1) The
// state staged, every parent its own site; (2) the slab's bonds united
// with uf.cuh's tile_unite (the smaller root wins), a round of blockDim.x
// sites at a time, each round's sites then pointed at their roots.  (No
// ballot hangs runs along the fast axis, as cc_link's does: on the table
// it cost 2-4%, tools/probe_colour_cc.py.)  Then by form (ops/cc.py
// table_link_plan):
//   kOne      the slab is the graph: every label written once, its root;
//   kCluster  the graph over a thread-block cluster of C <= 8 CTAs: every
//             parent made its slab root's site index (written as ~root, so
//             that no walk meets a half-made tree, then decoded), the
//             cluster waits, each bond that leaves its slab is united in
//             distributed shared memory (slab_unite, a warp's pairs
//             of roots each once: lead_pair), the cluster waits, and every
//             label is written once, its root;
//   kSlab     a graph past one cluster's shared memory, in slabs of one
//             CTA each: every site's parent written as its slab root's
//             site index; cc_table_border then unites the bonds that leave
//             a slab in global memory (uf.cuh unite), and fk.cu's
//             fk_link_flatten points every parent at its root.
// Self-bonds unite a site with itself (nothing).  Each label is its
// component's minimum site index, bitwise the min-label fixed point.
enum TableForm { kOne = 0, kCluster = 1, kSlab = 2 };

constexpr int kTableThreads = 1024;  // the most threads a table CTA takes
constexpr int kTableSmem = 232448;   // the most dynamic shared memory a CTA takes (227 KB)

// ops/cc.py table_link_words: the sites, the offsets, the CTAs a graph's
// cluster (1 on the slab form), a slab's sites, fast_divisor (m, s) of
// bs, whether the slabs split the graph (kSlab) and a CTA's threads.
struct CcTable {
  int n;
  int nb;
  int C;
  int bs;
  uint32_t div_m;
  int div_s;
  int slabs;
  int threads;
};

inline CcTable make_cc_table(const int* w) {
  return CcTable{w[0], w[1], w[2], w[3], static_cast<uint32_t>(w[4]), w[5], w[6], w[7]};
}

// Bytes a slab site takes in shared memory: its parent and its state bits.
inline int table_state_bytes(int nb) { return nb <= 8 ? 1 : nb <= 16 ? 2 : 4; }
inline long long table_smem(const CcTable& g) {
  return static_cast<long long>(g.bs) * (4 + table_state_bytes(g.nb));
}

// The slab of site v: v / bs by multiply-shift (Slabs' slab_of).
__device__ __forceinline__ int slab_of(const CcTable& g, int v) {
  return g.div_m ? static_cast<int>(__umulhi(static_cast<uint32_t>(v), g.div_m) >> g.div_s) : v;
}

// One slab of graph blockIdx.y (slab blockIdx.x: sites lo .. lo + sites -
// 1), S the shared state type, kForm the form (above).  No array is
// indexed at run time.
template <typename S, int kForm>
__global__ void __launch_bounds__(kTableThreads)
cc_table_link_kernel(const uint32_t* __restrict__ state, int32_t* __restrict__ out,
                     const int32_t* __restrict__ fwd, const CcTable g, int rounds) {
  extern __shared__ int smem[];
  int* P = smem;
  S* St = reinterpret_cast<S*>(smem + g.bs);
  const int n = g.n;
  const int nb = g.nb;
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const uint32_t* st = state + base;
  int32_t* o = out + base;
  const int lo = static_cast<int>(blockIdx.x) * g.bs;
  const int sites = max(0, min(g.bs, n - lo));
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const uint32_t mask = nb == 32 ? 0xffffffffu : (1u << nb) - 1u;
  for (int it = 0; it < rounds; ++it) {  // (1)
    const int l = it * T + threadIdx.x;
    if (l >= sites) break;
    St[l] = static_cast<S>(__ldg(st + lo + l) & mask);
    P[l] = l;
  }
  __syncthreads();
  for (int it = 0; it < rounds; ++it) {  // (2) a round of unions, then its sites' finds
    const int l = it * T + threadIdx.x;
    if (l < sites) {
      const int32_t* fi = fwd + static_cast<size_t>(lo + l) * nb;
      for (uint32_t s = St[l]; s; s &= s - 1u) {
        const unsigned r = static_cast<unsigned>(__ldg(fi + __ffs(s) - 1) - lo);
        if (r < static_cast<unsigned>(sites)) tile_unite(P, l, static_cast<int>(r));
      }
    }
    __syncthreads();
    if (l < sites) P[l] = tile_root(P, l);  // the round's finds
    __syncthreads();
  }
  if (kForm != kCluster) {  // the graph's labels, or (kSlab) its slab roots as parents
    for (int it = 0; it < rounds; ++it) {
      const int l = it * T + threadIdx.x;
      if (l >= sites) break;
      int v = l;  // its root, read only
      for (int p; (p = P[v]) != v;) v = p;
      o[lo + l] = lo + v;
    }
    return;
  }
  // kCluster: every parent its slab root's site index, as ~root while the
  // walks run (a walk that meets one has its root), then decoded
  volatile int* V = P;
  for (int it = 0; it < rounds; ++it) {
    const int l = it * T + threadIdx.x;
    if (l >= sites) break;
    int v = l, root;
    while (true) {
      const int p = V[v];
      if (p < 0) {
        root = ~p;
        break;
      }
      if (p == v) {
        root = lo + v;
        break;
      }
      v = p;
    }
    V[l] = ~root;
  }
  __syncthreads();
  for (int it = 0; it < rounds; ++it) {
    const int l = it * T + threadIdx.x;
    if (l < sites) P[l] = ~P[l];
  }
  Slabs sl{cg::this_cluster(), P, static_cast<int>(blockIdx.x)};
  sl.cluster.sync();  // every slab's parents are site indices
  for (int it = 0; it < rounds; ++it) {  // (2b) the bonds between slabs; uniform
    const int l = it * T + threadIdx.x;
    const uint32_t s = l < sites ? static_cast<uint32_t>(St[l]) : 0u;
    const int i = lo + l;
    for (unsigned any = __reduce_or_sync(0xffffffffu, s); any; any &= any - 1u) {
      const int d = __ffs(any) - 1;
      bool cross = false;
      int ri = 0, rj = 0;
      if ((s >> d) & 1u) {
        const int j = __ldg(fwd + static_cast<size_t>(i) * nb + d);
        if (static_cast<unsigned>(j - lo) >= static_cast<unsigned>(sites)) {
          ri = slab_root(sl, g, i);
          rj = slab_root(sl, g, j);
          cross = ri != rj;
        }
      }
      if (lead_pair(cross, ri, rj, lane)) slab_unite(sl, g, ri, rj);
    }
  }
  sl.cluster.sync();  // every union done
  for (int it = 0; it < rounds; ++it) {
    const int l = it * T + threadIdx.x;
    if (l >= sites) break;
    int v = lo + l;  // its root, read only
    for (int p; (p = *slab_slot(sl, g, v)) != v;) v = p;
    o[lo + l] = v;
  }
  sl.cluster.sync();  // no CTA leaves while another reads its shared memory
}

// The slab form's bonds that leave their slab, united in global memory
// (uf.cuh unite) as pairs of the two ends' slab roots, which
// cc_table_link wrote: a thread a site.
__global__ void __launch_bounds__(kThreads)
cc_table_border_kernel(const uint32_t* __restrict__ state, int32_t* parent,
                       const int32_t* __restrict__ fwd, const CcTable g) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= g.n) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * g.n;
  int32_t* P = parent + base;
  uint32_t s = state[base + i] & (g.nb == 32 ? 0xffffffffu : (1u << g.nb) - 1u);
  if (!s) return;
  const int q = slab_of(g, i);
  const int32_t* fi = fwd + static_cast<size_t>(i) * g.nb;
  for (; s; s &= s - 1u) {
    const int j = __ldg(fi + __ffs(s) - 1);
    if (slab_of(g, j) != q) unite(P, __ldcg(P + i), __ldcg(P + j));
  }
}

using TableKernel = void (*)(const uint32_t*, int32_t*, const int32_t*, const CcTable, int);

template <typename S>
TableKernel table_kernel(int form) {
  return form == kOne ? cc_table_link_kernel<S, kOne>
                      : form == kCluster ? cc_table_link_kernel<S, kCluster>
                                         : cc_table_link_kernel<S, kSlab>;
}

bool table_ok(const CcTable& g, int n_graphs) {
  if (n_graphs < 1 || n_graphs > 65535 || g.n < 1 || g.n > (1 << 30) || g.nb < 1 ||
      g.nb > 32 || g.C < 1 || g.C > kCcMaxCluster || g.bs < 1 || g.threads < 32 ||
      g.threads > kTableThreads || g.threads % 32 || table_smem(g) > kTableSmem)
    return false;
  const long long cover = static_cast<long long>(g.C) * g.bs;
  // the whole-graph forms: C slabs cover the graph; the slab form: no cluster
  return g.slabs ? g.C == 1 && g.bs < g.n : cover >= g.n && cover - g.bs < g.n;
}

bool walk_ok(const CcWalk& g, int n_graphs) {
  if (n_graphs < 1 || n_graphs > 65535 || g.n_nb < 1 || g.n_nb > kMaxOffsets ||
      g.fast_d >= g.n_nb || g.C < 1 || g.C > kCcMaxCluster || g.bs < 1)
    return false;
  long long box = 1, n = 1;
  for (int k = 0; k < 3; ++k) {
    if (g.L[k] < 1 || g.t[k] < 1 || g.t[k] > g.L[k] ||
        g.nt[k] != (g.L[k] + g.t[k] - 1) / g.t[k])
      return false;
    box *= g.t[k];
    n *= g.L[k];
  }
  // whole-graph form: C slabs of bs sites cover the graph; tiled: no cluster
  const bool whole = box == n;
  if (whole ? static_cast<long long>(g.C) * g.bs < n || g.bs > kCcSites
            : g.C != 1 || box > kCcSites)
    return false;
  return n < (1LL << 31);
}

inline int box_count(const CcWalk& g) { return g.nt[0] * g.nt[1] * g.nt[2]; }

}  // namespace

extern "C" {

// state: uint8 [n_graphs, n], bit d set when the bond to the neighbour at
// forward offset d is active; out: int32 [n_graphs, n], every entry
// written: the labels where one box is the whole graph, else each site's
// box root, which cc_link_border and fk_link_flatten complete; words:
// ops/cc.py link_words (host memory); threads: a CTA's, a multiple of 32.
int peapods_cc_link(const void* state, void* out, const int* words, int n_graphs, int threads,
                    void* stream) {
  const CcWalk g = make_cc_walk(words);
  const bool whole = box_count(g) == 1;
  const int sites = whole ? g.bs : g.t[0] * g.t[1] * g.t[2];
  if (!walk_ok(g, n_graphs) || threads < 32 || threads > kCcThreads || threads % 32 ||
      static_cast<long long>(threads) * (kCcSites / kCcThreads) < sites)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool cluster = whole && g.C > 1;
  const LinkKernel kernel = g.L[2] > 1 ? form_kernel<true>(whole, cluster, g.n_nb)
                                       : form_kernel<false>(whole, cluster, g.n_nb);
  const auto st = static_cast<const uint8_t*>(state);
  const auto o = static_cast<int32_t*>(out);
  const int rounds = (sites + threads - 1) / threads;  // a CTA's rounds of sites
  if (!cluster) {
    kernel<<<dim3(box_count(g), n_graphs), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        st, o, g, rounds);
    return static_cast<int>(cudaGetLastError());
  }
  // the whole-graph form over a cluster of C CTAs a graph, one a slab
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.C, n_graphs, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, st, o, g, rounds);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int peapods_cc_link_border(const void* state, void* parent, const int* words, int n_graphs,
                           void* stream) {
  const CcWalk g = make_cc_walk(words);
  if (!walk_ok(g, n_graphs) || box_count(g) == 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const BorderKernel kernel = g.L[2] > 1 ? border_kernel<true>(g.n_nb)
                                         : border_kernel<false>(g.n_nb);
  kernel<<<dim3(box_count(g), n_graphs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent), g);
  return static_cast<int>(cudaGetLastError());
}

// The table form: state int32 [n_graphs, n], bit d the bond along offset d
// (nb <= 32); out int32 [n_graphs, n], every entry written: the labels,
// or on the slab form (words[6]) each site's slab root, which
// peapods_cc_table_border and fk.cu's fk_link_flatten complete; fwd int32
// [n, nb] (device memory); words: ops/cc.py table_link_words (host memory).
int peapods_cc_table_link(const void* state, void* out, const void* fwd, const int* words,
                          int n_graphs, void* stream) {
  const CcTable g = make_cc_table(words);
  if (!table_ok(g, n_graphs)) return static_cast<int>(cudaErrorInvalidValue);
  const int form = g.slabs ? kSlab : g.C > 1 ? kCluster : kOne;
  const int sb = table_state_bytes(g.nb);
  const TableKernel kernel = sb == 1   ? table_kernel<uint8_t>(form)
                             : sb == 2 ? table_kernel<uint16_t>(form)
                                       : table_kernel<uint32_t>(form);
  // above 48 KB of dynamic shared memory a kernel must opt in, once
  static bool allowed[3][3] = {};
  bool& ok = allowed[sb >> 1][form];
  if (!ok) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ok = true;
  }
  const int smem = static_cast<int>(table_smem(g));
  const int rounds = (g.bs + g.threads - 1) / g.threads;
  const auto st = static_cast<const uint32_t*>(state);
  const auto o = static_cast<int32_t*>(out);
  const auto f = static_cast<const int32_t*>(fwd);
  const int blocks = g.slabs ? (g.n + g.bs - 1) / g.bs : g.C;
  if (form != kCluster) {
    kernel<<<dim3(blocks, n_graphs), g.threads, smem, static_cast<cudaStream_t>(stream)>>>(
        st, o, f, g, rounds);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.C, n_graphs, 1);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, st, o, f, g, rounds);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The slab form's bonds between slabs, on the parents peapods_cc_table_link
// wrote (same words).
int peapods_cc_table_border(const void* state, void* parent, const void* fwd, const int* words,
                            int n_graphs, void* stream) {
  const CcTable g = make_cc_table(words);
  if (!table_ok(g, n_graphs) || !g.slabs) return static_cast<int>(cudaErrorInvalidValue);
  cc_table_border_kernel<<<dim3((g.n + kThreads - 1) / kThreads, n_graphs), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(state), static_cast<int32_t*>(parent),
      static_cast<const int32_t*>(fwd), g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
