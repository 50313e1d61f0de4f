// Hopper kernel of the replica path's pair measurement: the spin overlap q
// and the link overlap q_l of every replica pair at every temperature.
//
// Replaces the pair measurement of the TPU pairs megakernel
// peapods_tpu/ops/pallas_megapair.py:_mp_kernel (:599-619; the reference's
// OverlapAccum.collect, statistics/overlap.rs:251-333), which sums products
// of resident partner regions of its slot tiles.  Here spins stay by system:
// block (p T + t, d) reads the systems at slots (2p) T + t and (2p + 1) T + t
// of realization d through sid, and sums over the lattice
//   qs = sum_i a_i b_i,   ql = sum_i q_i (q_{i+x} + q_{i+y} [+ q_{i+z}])
// with q_i = a_i b_i, in int32 (exact in any order), into the sweep's rows
// qs_out / ql_out [d, n_pairs T] (row stride out_stride).  It runs after the
// measuring colour pass and before pt_step, so it reads the sweep's final
// spins through the sid that the sweep ran with; it cannot ride in the odd
// pass itself, since a partner system is being updated by other blocks.
//
// What bounds it on the H100: each block reads its two systems' spins (8^3:
// 1 KB, 16^3: 8 KB) and the forward neighbours' (mostly cached): 768 KB to
// 6.3 MB per launch at configs 4 and 5, microseconds at HBM rate, so launch
// latency dominates at 8^3.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"
#include "uf.cuh"

using namespace peapods;

namespace {

__global__ void __launch_bounds__(kThreads)
pair_overlap_kernel(const int8_t* __restrict__ spins, const int32_t* __restrict__ sid,
                    int32_t* __restrict__ qs_out, int32_t* __restrict__ ql_out,
                    int out_stride, int L0, int L1, int L2, int n_temps,
                    int n_slots) {
  const Dims g = make_dims(L0, L1, L2);
  const int n = L0 * L1 * L2;
  const int col = blockIdx.x;  // p T + t
  const int d = blockIdx.y;
  const int p = col / n_temps;
  const int t = col - p * n_temps;
  const int32_t* sd = sid + static_cast<size_t>(d) * n_slots;
  const int8_t* a = spins + (static_cast<size_t>(d) * n_slots + sd[2 * p * n_temps + t]) * n;
  const int8_t* b =
      spins + (static_cast<size_t>(d) * n_slots + sd[(2 * p + 1) * n_temps + t]) * n;
  int qs = 0;
  int ql = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int q = a[i] * b[i];
    int nbr = 0;
    for (int dir = 0; dir < g.nd; ++dir) {
      const int f = fwd_site(i, g, dir);
      nbr += a[f] * b[f];
    }
    qs += q;
    ql += q * nbr;
  }
  __shared__ int sq[kThreads];
  __shared__ int sl[kThreads];
  sq[threadIdx.x] = qs;
  sl[threadIdx.x] = ql;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      sq[threadIdx.x] += sq[threadIdx.x + off];
      sl[threadIdx.x] += sl[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    qs_out[static_cast<size_t>(d) * out_stride + col] = sq[0];
    ql_out[static_cast<size_t>(d) * out_stride + col] = sl[0];
  }
}

}  // namespace

extern "C" {

// spins int8 [d, n_slots, n] by system, sid int32 [d, n_slots] (slot r T +
// t); writes qs / ql of pair p at temperature t to [d, p T + t] of rows
// with stride out_stride.  2D lattices pass L2 = 1.
int peapods_pair_overlap(const void* spins, const void* sid, void* qs_out,
                         void* ql_out, int out_stride, int n_disorder, int n_pairs,
                         int n_temps, int n_slots, int L0, int L1, int L2,
                         void* stream) {
  pair_overlap_kernel<<<dim3(n_pairs * n_temps, n_disorder), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<int32_t*>(qs_out), static_cast<int32_t*>(ql_out), out_stride, L0,
      L1, L2, n_temps, n_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
