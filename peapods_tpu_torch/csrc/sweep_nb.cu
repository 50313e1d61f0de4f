// Hopper kernels of the per-sweep path on coloured lattices: the triangular,
// BCC, FCC and 3D cubic lattices and any offset table (up to six forward
// offsets), by their neighbour offsets and the lattice's greedy colouring.
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
//               row-major index), draws one Philox4x32-10 block keyed by the
//               sweep's two words, counter (system, colour, g, 0), and
//               updates the sites of the active colour: site i takes word
//               i % 4 (ops/rng.site_uniforms).  The field adds, for each
//               offset d in order, s(i + off_d) J[i, d] and then
//               s(i - off_d) J_bwd[i, d] (J_bwd[i, d] = J[i - off_d, d]),
//               from 0, as local_fields (ops/sweep.py:53-71) does; the
//               rules are the reference's: Metropolis u < (15/16) exp(min(
//               -s h / (T/2), 0)), Gibbs -s h >= (T/2) ln(u / (1 - u)).
//               A colour is an independent set, so no active site reads a
//               site that the pass writes (a self-bond reads the site's own
//               value before the write).
//   measure_nb  per-block partials [d, n_systems, blocks] of e = sum_{i,d}
//               (s_i s(i + off_d)) J[i, d] and m = sum_i s_i, in a fixed
//               order with no float atomics; pt_step adds them in order.
//               It runs on sweeps that measure without an FK update: with
//               four colours or more a bond joins colours of several kinds,
//               so the energy cannot ride in the last pass as it does on the
//               checkerboard.
//
// Neighbours come from the coordinates of the row-major index and the
// offsets (kernel arguments, nb.cuh), each axis wrapped on its own
// (rem_euclid); a 2D lattice is [L0, L1, 1].  Built with -fmad=false and no fast math, so
// the field, the acceptance and the (+-1) energies round exactly as the
// plain torch versions (ops/sweep.py, ops/energy.py).
//
// What bounds it on the H100: per active site, the int8 spin, 2 n_nb int8
// neighbours, 8 n_nb bytes of couplings (forward and backward) and a colour
// byte are read and one byte written; each pass reads the colour table of
// every site.  At config 2 (8 systems of 32 x 32, 4 colours) a pass moves
// about 40 KB: a few ns at HBM rate, so the launch is latency-bound (4
// blocks of 256 threads for 8 x 1024 sites).  At 32^3 x 16 systems a pass
// reads 0.5 MB of spins and 1.5 MB of couplings.  The simple design reads
// every neighbour from global memory (L1 / L2 hits); a lattice held in
// shared memory and one launch for all colours are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"
#include "nb.cuh"

using namespace peapods;

namespace {

__global__ void __launch_bounds__(kThreads)
sweep_nb_kernel(int8_t* __restrict__ spins, const float* __restrict__ coup_fwd,
                const float* __restrict__ coup_bwd,
                const uint8_t* __restrict__ colours,
                const float* __restrict__ sys_temps,
                const int32_t* __restrict__ words, const NbGeom g, int n,
                int n_systems, int colour, int gibbs) {
  const int sys = blockIdx.y;
  const int dz = blockIdx.z;
  const int g4 = blockIdx.x * blockDim.x + threadIdx.x;
  const int i0 = kSitesPerThread * g4;
  if (i0 >= n) return;
  bool any = false;
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k)
    any |= i0 + k < n && colours[i0 + k] == colour;
  if (!any) return;
  const size_t row = static_cast<size_t>(dz) * n_systems + sys;
  int8_t* s = spins + row * n;
  const size_t jo = static_cast<size_t>(dz) * n * g.n_nb;
  const float* jf = coup_fwd + jo;
  const float* jb = coup_bwd + jo;
  const float T = sys_temps[row];
  const float half_t = T * 0.5f;
  const float inv_half_t = 1.0f / (T * 0.5f);
  const uint4 r4 = philox4x32_10(static_cast<uint32_t>(words[2 * dz]),
                                 static_cast<uint32_t>(words[2 * dz + 1]),
                                 static_cast<uint32_t>(sys),
                                 static_cast<uint32_t>(colour),
                                 static_cast<uint32_t>(g4), 0u);
  const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int i = i0 + k;
    if (i >= n || colours[i] != colour) continue;
    int c[3];
    coords(g, i, c);
    float field = 0.0f;
    for (int d = 0; d < g.n_nb; ++d) {
      const size_t b = static_cast<size_t>(i) * g.n_nb + d;
      field = field + static_cast<float>(s[neighbour(g, c, d, 1)]) * jf[b];
      field = field + static_cast<float>(s[neighbour(g, c, d, -1)]) * jb[b];
    }
    const float sv = static_cast<float>(s[i]);
    const float eng = -sv * field;
    const float u = uniform24(w4[k]);
    const bool flip = gibbs ? eng >= half_t * logf(u / (1.0f - u))
                            : u < kKeep * expf(fminf(eng * inv_half_t, 0.0f));
    if (flip) s[i] = static_cast<int8_t>(-sv);
  }
}

__global__ void __launch_bounds__(kThreads)
measure_nb_kernel(const int8_t* __restrict__ spins, const float* __restrict__ coup_fwd,
                  const NbGeom g, float* __restrict__ e_part,
                  int32_t* __restrict__ m_part, int n, int n_systems) {
  const int sys = blockIdx.y;
  const int dz = blockIdx.z;
  const int i0 = kSitesPerThread * (blockIdx.x * blockDim.x + threadIdx.x);
  const size_t row = static_cast<size_t>(dz) * n_systems + sys;
  const int8_t* s = spins + row * n;
  const float* jf = coup_fwd + static_cast<size_t>(dz) * n * g.n_nb;
  float e_acc = 0.0f;
  int m_acc = 0;
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int i = i0 + k;
    if (i >= n) break;
    int c[3];
    coords(g, i, c);
    const float sv = static_cast<float>(s[i]);
    float e = 0.0f;
    for (int d = 0; d < g.n_nb; ++d)
      e = e + sv * static_cast<float>(s[neighbour(g, c, d, 1)]) *
                  jf[static_cast<size_t>(i) * g.n_nb + d];
    e_acc += e;
    m_acc += s[i];
  }
  block_partials(e_acc, m_acc, e_part, m_part, row * gridDim.x + blockIdx.x);
}

}  // namespace

extern "C" {

// Blocks per system of sweep_nb and measure_nb: the partial-sum row length.
int peapods_nb_blocks(int n) {
  const int groups = (n + kSitesPerThread - 1) / kSitesPerThread;
  return (groups + kThreads - 1) / kThreads;
}

// One colour pass of every (realization, system).  spins int8 [d, n_systems,
// n]; coup_fwd / coup_bwd f32 [d, n, n_nb]; colours uint8 [n]; sys_temps f32
// [d, n_systems]; words int32 [d, 2].
int peapods_sweep_nb(void* spins, const void* coup_fwd, const void* coup_bwd,
                     const void* colours, const void* sys_temps, const void* words,
                     const int* geom, int n_disorder, int n_systems, int colour,
                     int gibbs, void* stream) {
  const NbGeom g = make_geom(geom);
  const int n = g.L[0] * g.L[1] * g.L[2];
  const dim3 grid(peapods_nb_blocks(n), n_systems, n_disorder);
  sweep_nb_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const float*>(coup_fwd),
      static_cast<const float*>(coup_bwd), static_cast<const uint8_t*>(colours),
      static_cast<const float*>(sys_temps), static_cast<const int32_t*>(words), g, n,
      n_systems, colour, gibbs);
  return static_cast<int>(cudaGetLastError());
}

// e_part f32 / m_part int32 [d, n_systems, peapods_nb_blocks(n)].
int peapods_measure_nb(const void* spins, const void* coup_fwd, const int* geom,
                       void* e_part, void* m_part, int n_disorder, int n_systems,
                       void* stream) {
  const NbGeom g = make_geom(geom);
  const int n = g.L[0] * g.L[1] * g.L[2];
  const dim3 grid(peapods_nb_blocks(n), n_systems, n_disorder);
  measure_nb_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(coup_fwd), g,
      static_cast<float*>(e_part), static_cast<int32_t*>(m_part), n, n_systems);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
