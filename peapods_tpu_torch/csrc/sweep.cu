// Hopper kernel of the per-sweep path: one checkerboard colour of every
// (realization, system), at each system's own temperature.
//
// Replaces the TPU's stand-alone sweep peapods_tpu/ops/pallas_sweep.py:728
// sweep_2d (kernel _kernel :301, body _kernel_body :250, uniforms
// _hw_uniform :294; and its injected twin sweep_2d_injected :982, whose
// uniforms the plain version takes).  It runs where a cluster phase sits
// between the sweep and the measurement.  One sweep is two launches on the
// caller's stream: colour 0, then colour 1.
//
// * Spins are stored by system ([d, n_systems, H, W] int8) and block
//   (x, system, d) updates that system at sys_temps[d, system].
// * Random numbers: Philox4x32-10 keyed by the sweep's two key words
//   fold_in(fold_in(key_d, counter), PH_SWEEP), counter (system, colour,
//   site // 4, 0).  The reference seeds its hardware PRNG with
//   (kd0, kd1 + system) (make_seeds :67-81); the system index sits in the
//   counter here instead, which gives each system its own stream the same
//   way.  ops/rng.colour_uniforms draws the same bits on the host side.
// * The site update is mega.cuh's update_sites, shared with colour_pass.
//   A colour-1 launch given e_part / m_part also writes per-block partial
//   sums of the post-sweep energy and magnetization ([d, n_systems,
//   blocks]); the engine measures that way on sweeps without a cluster
//   update, and pt_step reduces the partials in a fixed order.
//
// What bounds it on the H100: per active site, the int8 spin, four int8
// neighbours and 16 B of couplings read, one byte written.  At config 3
// (one 256^2 system) a pass moves about 0.6 MB: a few hundred nanoseconds
// at HBM rate, so one launch is latency-bound (16 blocks on 132 SMs).  At
// 64^2 x 2048 systems (128 realizations) a pass reads 8 MB of spins and
// 4 MB of couplings and writes up to 4 MB: about 5 us at 3.35 TB/s, where
// 2048 x 4 blocks fill the card.  The simple design keeps the colour pass
// of the mega path; a lattice held in shared memory is later work
// (ROADMAP queue 3).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

using namespace peapods;

namespace {

__global__ void __launch_bounds__(kThreads)
sweep_2d_kernel(int8_t* __restrict__ spins, const float* __restrict__ jgrids,
                const float* __restrict__ sys_temps,
                const int32_t* __restrict__ words, float* __restrict__ e_part,
                int32_t* __restrict__ m_part, int H, int W, int n_systems,
                int colour, int gibbs) {
  const int sys = blockIdx.y;
  const int d = blockIdx.z;
  const size_t hw = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(d) * n_systems + sys;
  const bool measure = e_part != nullptr;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  float e_acc = 0.0f;
  int m_acc = 0;
  if (kSitesPerThread * g < H * (W >> 1)) {
    const uint4 r4 = philox4x32_10(static_cast<uint32_t>(words[2 * d]),
                                   static_cast<uint32_t>(words[2 * d + 1]),
                                   static_cast<uint32_t>(sys),
                                   static_cast<uint32_t>(colour),
                                   static_cast<uint32_t>(g), 0u);
    update_sites(spins + row * hw, jgrids + static_cast<size_t>(d) * 4 * hw, H, W,
                 colour, 1.0f / (0.5f * sys_temps[row]), gibbs, r4, g, measure,
                 e_acc, m_acc);
  }
  if (!measure) return;  // uniform across the block
  block_partials(e_acc, m_acc, e_part, m_part, row * gridDim.x + blockIdx.x);
}

}  // namespace

extern "C" {

// One colour pass over every (realization, system).  e_part / m_part are
// [d, n_systems, colour_pass_blocks(H, W)] (both null: no measurement).
int peapods_sweep_2d(void* spins, const void* jgrids, const void* sys_temps,
                     const void* words, void* e_part, void* m_part, int n_disorder,
                     int n_systems, int H, int W, int colour, int gibbs,
                     void* stream) {
  const dim3 grid(colour_pass_blocks(H, W), n_systems, n_disorder);
  sweep_2d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const float*>(jgrids),
      static_cast<const float*>(sys_temps), static_cast<const int32_t*>(words),
      static_cast<float*>(e_part), static_cast<int32_t*>(m_part), H, W, n_systems,
      colour, gibbs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
