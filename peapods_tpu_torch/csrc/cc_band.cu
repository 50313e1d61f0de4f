// Hopper kernels of the band-local connected components: the FK bond graphs
// of a lattice split into row bands over a "space" mesh, labelled band by
// band so that every site gets its component's minimum global site index,
// bitwise the unsharded labelling (fk_link, cc_link / cc_label).
//
// Replaces the TPU's peapods_tpu/ops/pallas_cc_band.py:198 band_cc_batch
// (kernel _band_kernel :169: the min-label fixed point of one band with its
// two halo label rows, inside the outer loop of
// peapods_tpu/ops/cluster.py:194 connected_components_banded).  The TPU
// propagated labels because its gathers were slow; here a union-find over
// the band's window (band.cuh) gives the components, and the labels are the
// minimum over each component of its sites' current labels.
//
// Each band keeps, per graph and window site (the band's rows and a halo of
// the neighbouring bands' edge rows, band.cuh): the bond bits of the state
// byte (fk.cu fk_bonds_band writes them for every window site whose
// forward neighbour lies in the window, so every bond that touches the
// band is there), a union-find parent, the site's current label (global
// site indices; fk_bonds_band starts each at its own index) and cmin, a
// per-root minimum (started at the site's own index).
//
//   cc_band_link   once per FK phase: unite each window site with its
//                  forward neighbours along its bonds.  The larger root is
//                  hung under the smaller by the order of (global index,
//                  window index), so every component's root is its site of
//                  smallest global index, whose cmin is its own index: the
//                  minimum of the component's starting labels.
//   cc_band_min    from the second round on: each halo site lowers
//                  cmin[root] to its label, freshly copied from the band
//                  that owns the site (a read first, an atomicMin only when
//                  it would lower it).  The band's own sites carry cmin
//                  already, and labels only fall, so cmin is never reset.
//   cc_band_write  every round: each interior site takes cmin[root]; a site
//                  whose label falls sets the band's flag to the round's
//                  number.
//
// The engine (ops/cc_band.py banded_labels) runs rounds until a round
// changes no band, copying the bands' edge label rows into the neighbours'
// halos between rounds.  Every label is the global index of a site joined to
// the labelled one by real bonds, so none falls below its component's
// minimum; when no round changes a label, both ends of every bond that
// crosses a band edge carry the same label (each band holds the bond), so
// each component carries one label, its minimum site's own.  The first
// round needs no copy and no cc_band_min: every label starts at its site's
// own index, the neighbours' halo rows too.
//
// What bounds it on the H100: the link reads each window site's state byte
// and writes its parent, with chains of dependent loads and CAS retries
// inside a spanning cluster; a round reads each band site's parent chain,
// cmin and label (12 bytes a site once the trees are compressed) and the
// halo rows' labels.  At a 4096^2 band of 1024 rows x 4 graphs a round's
// bytes take about 60 us at 3.35 TB/s, and a spanning cluster near T_c
// needs about one round per band edge it crosses, more where it snakes,
// plus one that changes nothing.  (A first design let every window site
// atomicMin its root each round: near T_c millions of atomics on the root
// of the spanning cluster, the largest share of a 4096^2 sweep.)

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "band.cuh"

using namespace peapods;

namespace {

constexpr int kBandThreads = 256;

// The order of a window site: (global index, window index), so that a halo
// row that repeats the band's own rows (one band) never ties.
__device__ __forceinline__ long long band_key(const BandGeom& g, int w) {
  return static_cast<long long>(window_global(g, w)) * (g.w.L[0] * g.block) + w;
}

// Root of x, halving the path on the way (parents follow band_key, not the
// window index, so the root is the node that is its own parent).
__device__ __forceinline__ int band_root(int32_t* P, int x) {
  int prev = x;
  int cur = __ldcg(P + x);
  if (cur == x) return x;
  int next;
  while ((next = __ldcg(P + cur)) != cur) {
    P[prev] = next;
    prev = cur;
    cur = next;
  }
  return cur;
}

// Hang the root of larger band_key under the smaller with atomicCAS,
// retrying from the new parent when another thread got there first.
__device__ __forceinline__ void band_unite(int32_t* P, const BandGeom& g, int a, int b) {
  a = band_root(P, a);
  b = band_root(P, b);
  while (a != b) {
    if (band_key(g, a) < band_key(g, b)) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(P + a, a, b);
    if (old == a) return;
    a = band_root(P, old);
  }
}

__global__ void __launch_bounds__(kBandThreads)
cc_band_link_kernel(const uint8_t* __restrict__ state, int32_t* parent, const BandGeom g) {
  const int b = blockIdx.y;
  const int nw = g.w.L[0] * g.block;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw) return;
  const size_t base = static_cast<size_t>(b) * nw;
  const uint8_t st = state[base + w] & ((1u << g.w.n_nb) - 1u);
  if (!st) return;
  int c[3];
  coords(g.w, w, c);
  for (int d = 0; d < g.w.n_nb; ++d) {
    if (!((st >> d) & 1u)) continue;
    const int j = window_neighbour(g, c, d, 1);
    if (j >= 0) band_unite(parent + base, g, w, j);
  }
}

__global__ void __launch_bounds__(kBandThreads)
cc_band_min_kernel(int32_t* parent, const int32_t* __restrict__ labels,
                   int32_t* cmin, const BandGeom g) {
  const int b = blockIdx.y;
  const int nw = g.w.L[0] * g.block;
  const int edge = g.halo * g.block;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * edge) return;
  const int w = i < edge ? i : i + g.hl * g.block;  // the top, then the bottom halo
  const size_t base = static_cast<size_t>(b) * nw;
  const int lab = labels[base + w];
  int32_t* c = cmin + base + band_root(parent + base, w);
  if (lab < __ldcg(c)) atomicMin(c, lab);
}

__global__ void __launch_bounds__(kBandThreads)
cc_band_write_kernel(int32_t* parent, int32_t* __restrict__ labels,
                     const int32_t* cmin, int32_t* flag, int round,
                     const BandGeom g) {
  const int b = blockIdx.y;
  const int nw = g.w.L[0] * g.block;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.hl * g.block) return;
  const size_t base = static_cast<size_t>(b) * nw;
  const int w = g.halo * g.block + i;
  const int lab = __ldcg(cmin + base + band_root(parent + base, w));
  if (lab < labels[base + w]) {
    labels[base + w] = lab;
    *flag = round;
  }
}

inline dim3 band_grid(int n, int n_graphs) {
  return dim3((n + kBandThreads - 1) / kBandThreads, n_graphs);
}

}  // namespace

extern "C" {

// state: uint8 [n_graphs, n_window] (bits 0 .. n_nb-1: bonds); parent:
// int32 [n_graphs, n_window], parent[w] = w; geom: ops/lattice.Band.words.
int peapods_cc_band_link(const void* state, void* parent, const int* geom,
                         int n_graphs, void* stream) {
  const BandGeom g = make_band_geom(geom);
  cc_band_link_kernel<<<band_grid(g.w.L[0] * g.block, n_graphs), kBandThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent), g);
  return static_cast<int>(cudaGetLastError());
}

// labels, cmin: int32 [n_graphs, n_window]; reads the halo sites' labels.
int peapods_cc_band_min(void* parent, const void* labels, void* cmin, const int* geom,
                        int n_graphs, void* stream) {
  const BandGeom g = make_band_geom(geom);
  cc_band_min_kernel<<<band_grid(2 * g.halo * g.block, n_graphs), kBandThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(parent), static_cast<const int32_t*>(labels),
      static_cast<int32_t*>(cmin), g);
  return static_cast<int>(cudaGetLastError());
}

// flag: int32 [1], set to round when an interior label falls.
int peapods_cc_band_write(void* parent, void* labels, const void* cmin, void* flag,
                          const int* geom, int round, int n_graphs, void* stream) {
  const BandGeom g = make_band_geom(geom);
  cc_band_write_kernel<<<band_grid(g.hl * g.block, n_graphs), kBandThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(parent), static_cast<int32_t*>(labels),
      static_cast<const int32_t*>(cmin), static_cast<int32_t*>(flag), round, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
