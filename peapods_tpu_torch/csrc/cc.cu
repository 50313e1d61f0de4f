// Hopper kernels of the connected components of a batch of bond graphs on
// any lattice given by its forward offsets (up to six): every site gets the
// minimum site index of its component, in two launches on the caller's
// stream.
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
//   cc_link   one thread per site of every graph unites the site with its
//             neighbour at each forward offset whose bond bit is set in the
//             site's state byte (uf.cuh: find with path halving, the larger
//             root hung under the smaller with atomicCAS), so that when the
//             launch ends each component is one tree whose root is its
//             minimum site index, whatever order the threads ran in.  The
//             parents start as parent[i] = i, written by whoever wrote the
//             state bytes (fk.cu's fk_bonds_nb, or the wrapper ops/cc.py):
//             a thread of this launch may read any site's parent, so none
//             may still be unset.  A self-bond is a no-op union.
//   cc_label  one thread per site: labels[i] = find_root(i), written to a
//             separate array (the parents are still being halved by other
//             threads' finds, so they are not the output).
//
// What bounds it on the H100: the state byte and the int32 parent of each
// site, a parent written per union and the labels written once.  At 16^3 x
// 8 BCC graphs (32,768 sites, 4 offsets) that is well under 1 MB, less than
// a microsecond at 3.35 TB/s: the launches are bound by latency and by the
// chains of dependent parent loads and CAS retries inside a spanning
// cluster, as fk_link is at config 3.  A block-local union-find in shared
// memory for many small graphs is later work (ROADMAP queue 3).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "nb.cuh"
#include "uf.cuh"

using namespace peapods;

namespace {

constexpr int kCcThreads = 256;

__global__ void __launch_bounds__(kCcThreads)
cc_link_kernel(const uint8_t* __restrict__ state, int32_t* parent, const NbGeom g,
               int n) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t st = state[static_cast<size_t>(b) * n + i] & ((1u << g.n_nb) - 1u);
  if (!st) return;
  link_site_nb(parent + static_cast<size_t>(b) * n, st, i, g);
}

__global__ void __launch_bounds__(kCcThreads)
cc_label_kernel(int32_t* parent, int32_t* __restrict__ labels, int n) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t base = static_cast<size_t>(b) * n;
  labels[base + i] = find_root(parent + base, i);
}

inline dim3 cc_grid(int n, int n_graphs) {
  return dim3((n + kCcThreads - 1) / kCcThreads, n_graphs);
}

}  // namespace

extern "C" {

// state: uint8 [n_graphs, n], bit d set when the bond to the neighbour at
// forward offset d is active; parent: int32 [n_graphs, n] with parent[i] = i;
// geom: the lattice's geometry words (nb.cuh make_geom).
int peapods_cc_link(const void* state, void* parent, const int* geom, int n_graphs,
                    void* stream) {
  const NbGeom g = make_geom(geom);
  const int n = g.L[0] * g.L[1] * g.L[2];
  cc_link_kernel<<<cc_grid(n, n_graphs), kCcThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent), g, n);
  return static_cast<int>(cudaGetLastError());
}

// labels: int32 [n_graphs, n], each site's component's minimum site index.
int peapods_cc_label(void* parent, void* labels, int n, int n_graphs, void* stream) {
  cc_label_kernel<<<cc_grid(n, n_graphs), kCcThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(parent), static_cast<int32_t*>(labels), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
