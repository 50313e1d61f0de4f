// Hopper kernels of the mega path: the checkerboard colour pass and the
// per-sweep parallel-tempering step.
//
// Replaces the TPU megakernel peapods_tpu/ops/pallas_mega.py:_mega_kernel
// (with its colour update pallas_sweep.py:_kernel_body / _kernel_body_2sub
// and the hardware-PRNG uniform _hw_uniform).  What is ported is what that
// kernel computes, not its VMEM layout: one sweep of a realization is
//   colour_pass(colour 0), colour_pass(colour 1, measuring), pt_step
// -- three launches on the caller's stream, no host synchronisation.
//
// * Spins stay stored by system ([d, n_systems, H, W] int8); the slot a
//   block works on reads its system from sid[d, slot], so a PT swap
//   exchanges two sid entries and never moves a spin tile.
// * Thread g of a colour pass owns the active-colour sites 4g .. 4g+3
//   (site i sits at row i / (W/2), column 2 (i % (W/2)) + ((row + colour) & 1))
//   and draws their four uniforms from one Philox4x32-10 call with key =
//   the sweep's two key words and counter = (slot, colour, g, 0).  No
//   thread sits on the inactive parity.
// * The measuring pass also sums s*h over the odd sites (their field is read
//   on the final even spins, so every bond is counted once: the energy for
//   free, pallas_sweep.py:176-180) and s over both sites of each column
//   pair.  Each block writes one partial per (realization, system), the
//   layout of the per-sweep path's kernels too; pt_step adds each slot's
//   system's partials in a fixed order.  No float atomics: e is the same
//   from run to run.
// * pt_step reads its draws from tensors in one form for both paths: the
//   mega path's murmur draws of its PT words and the per-sweep path's
//   jnp-form draws are both computed per chunk outside the kernel.
// * Compiled with -fmad=false and without --use_fast_math, with expf, logf
//   and the sigmoid as 1 / (1 + expf(-x)), in the operation order of the
//   plain torch version (ops/sweep.py, ops/tempering.py).
//
// What bounds it on the H100: each colour pass reads, per active site, the
// int8 spin and its four int8 neighbours and four f32 coupling grids (16 B
// of couplings per site; one realization's grids are 1 MB at 256^2 and stay
// in the 50 MB L2), and writes the int8 spin -- a few MB per pass at
// 256^2 x 24 slots, a few microseconds at L2 bandwidth.  At that size the
// launch latency of 3 launches per sweep is of the same order.  Later PRs
// lift the two bounds: a lattice resident in shared memory (64 KB per 256^2
// int8 system fits in the 227 KB a block may use, so one block could run
// many sweeps of one slot between PT steps), and a CUDA graph or a
// persistent cooperative kernel with a grid-wide barrier per sweep in
// place of 3 launches per sweep.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

using namespace peapods;

namespace {

__global__ void __launch_bounds__(kThreads)
colour_pass_kernel(int8_t* __restrict__ spins, const float* __restrict__ jgrids,
                   const int32_t* __restrict__ sid,
                   const float* __restrict__ temps,
                   const int32_t* __restrict__ words, float* __restrict__ e_part,
                   int32_t* __restrict__ m_part, int H, int W, int n_slots,
                   int colour, int gibbs) {
  const int slot = blockIdx.y;
  const int d = blockIdx.z;
  const size_t hw = static_cast<size_t>(H) * W;
  const int sys = sid[d * n_slots + slot];
  const bool measure = e_part != nullptr;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  float e_acc = 0.0f;
  int m_acc = 0;
  if (kSitesPerThread * g < H * (W >> 1)) {
    const uint4 r4 = philox4x32_10(static_cast<uint32_t>(words[2 * d]),
                                   static_cast<uint32_t>(words[2 * d + 1]),
                                   static_cast<uint32_t>(slot),
                                   static_cast<uint32_t>(colour),
                                   static_cast<uint32_t>(g), 0u);
    update_sites(spins + (static_cast<size_t>(d) * n_slots + sys) * hw,
                 jgrids + static_cast<size_t>(d) * 4 * hw, H, W, colour,
                 1.0f / (0.5f * temps[slot]), gibbs, r4, g, measure, e_acc, m_acc);
  }
  if (!measure) return;  // uniform across the block
  block_partials(e_acc, m_acc, e_part, m_part,
                 (static_cast<size_t>(d) * n_slots + sys) * gridDim.x + blockIdx.x);
}

struct PtState {
  float* es;  // [n_slots] energies per spin of the slots (shared memory)
  int32_t* sid;
  int32_t* ea;
  int32_t* ec;
  int32_t* rtrips;
  int32_t* tstate;
  const float* temps;
  int n_spins;
  int hot;
  int cold;
};

// Metropolis swap attempt on ladder edge e (tempering.rs:73-102).
__device__ void try_edge(PtState& st, int e, float u) {
  const float delta = (static_cast<float>(st.n_spins) * (st.es[e + 1] - st.es[e])) *
                      (1.0f / st.temps[e] - 1.0f / st.temps[e + 1]);
  st.ea[e] += 1;
  if (!(delta >= logf(u))) return;
  st.ec[e] += 1;
  const float el = st.es[e];
  st.es[e] = st.es[e + 1];
  st.es[e + 1] = el;
  const int32_t sl = st.sid[e];
  st.sid[e] = st.sid[e + 1];
  st.sid[e + 1] = sl;
  // arrivals: only the hot and cold slots matter, and a swap touches them
  // iff e borders them
  if (e == st.hot || e + 1 == st.hot) {
    const int sys = st.sid[st.hot];
    if (st.tstate[sys] == 2) st.rtrips[sys] += 1;
    st.tstate[sys] = 1;
  }
  if (e == st.cold || e + 1 == st.cold) {
    const int sys = st.sid[st.cold];
    if (st.tstate[sys] == 1) st.tstate[sys] = 2;
  }
}

__global__ void pt_step_kernel(const float* __restrict__ e_part,
                               const int32_t* __restrict__ m_part, int n_blocks,
                               float* __restrict__ e_out, int32_t* __restrict__ m_out,
                               int out_stride, int32_t* sid, int32_t* ea, int32_t* ec,
                               int32_t* rtrips, int32_t* tstate,
                               const float* __restrict__ temps,
                               const int32_t* __restrict__ edge_draw,
                               const float* __restrict__ u_draw,
                               float* __restrict__ sys_temps, int n_slots,
                               int n_spins, int do_pt, int pt_full, int parity,
                               int hot, int cold) {
  extern __shared__ float es[];
  const int d = blockIdx.x;
  for (int slot = threadIdx.x; slot < n_slots; slot += blockDim.x) {
    const size_t base =
        (static_cast<size_t>(d) * n_slots + sid[d * n_slots + slot]) * n_blocks;
    float acc = 0.0f;
    int macc = 0;
    for (int b = 0; b < n_blocks; ++b) {
      acc += e_part[base + b];
      macc += m_part[base + b];
    }
    const float e = acc / static_cast<float>(n_spins);
    es[slot] = e;
    e_out[static_cast<size_t>(d) * out_stride + slot] = e;
    m_out[static_cast<size_t>(d) * out_stride + slot] = macc;
  }
  __syncthreads();
  if (!do_pt) return;

  if (threadIdx.x == 0) {
    const int n_edges = n_slots - 1;
    PtState st{es, sid + d * n_slots, ea + d * n_edges, ec + d * n_edges,
               rtrips + d * n_slots, tstate + d * n_slots, temps, n_spins, hot, cold};
    if (pt_full) {
      for (int i = 0; i < 2; ++i) {
        const int p = i == 0 ? parity : 1 - parity;
        for (int e = p; e < n_edges; e += 2)
          try_edge(st, e, u_draw[(static_cast<size_t>(d) * 2 + i) * n_edges + e]);
      }
    } else {
      try_edge(st, edge_draw[d], u_draw[d]);
    }
  }
  // the systems' temperatures after the swaps, for the next sweep
  __syncthreads();
  for (int slot = threadIdx.x; slot < n_slots; slot += blockDim.x)
    sys_temps[d * n_slots + sid[d * n_slots + slot]] = temps[slot];
}

}  // namespace

extern "C" {

// Blocks per (realization, slot) of a colour pass: the length of the
// partial-sum rows the caller allocates.
int peapods_colour_pass_blocks(int H, int W) { return colour_pass_blocks(H, W); }

// One colour pass over every (realization, slot).  e_part / m_part are
// [d, n_slots, blocks] (both null for a pass that does not measure).
int peapods_colour_pass(void* spins, const void* jgrids, const void* sid,
                        const void* temps, const void* words, void* e_part,
                        void* m_part, int n_disorder, int n_slots, int H, int W,
                        int colour, int gibbs, void* stream) {
  const dim3 grid(colour_pass_blocks(H, W), n_slots, n_disorder);
  colour_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const float*>(jgrids),
      static_cast<const int32_t*>(sid), static_cast<const float*>(temps),
      static_cast<const int32_t*>(words), static_cast<float*>(e_part),
      static_cast<int32_t*>(m_part), H, W, n_slots, colour, gibbs);
  return static_cast<int>(cudaGetLastError());
}

// Reduce one sweep's partials ([d, n_systems, n_blocks], by system: read
// through sid) into its (e, m) rows by slot and run the PT event (when
// do_pt) on every realization's ladder, with the draws u_draw (f32 [d]
// single edge, [d, 2, n_edges] full ladder) and edge_draw (int32 [d]); a PT
// event then rewrites each system's temperature sys_temps ([d, n_systems]).
int peapods_pt_step(const void* e_part, const void* m_part, int n_blocks,
                    void* e_out, void* m_out, int out_stride, void* sid, void* ea,
                    void* ec, void* rtrips, void* tstate, const void* temps,
                    const void* edge_draw, const void* u_draw, void* sys_temps,
                    int n_disorder, int n_slots, int n_spins, int do_pt, int pt_full,
                    int parity, int hot, int cold, void* stream) {
  pt_step_kernel<<<n_disorder, 32, n_slots * sizeof(float),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e_part), static_cast<const int32_t*>(m_part), n_blocks,
      static_cast<float*>(e_out), static_cast<int32_t*>(m_out), out_stride,
      static_cast<int32_t*>(sid), static_cast<int32_t*>(ea), static_cast<int32_t*>(ec),
      static_cast<int32_t*>(rtrips), static_cast<int32_t*>(tstate),
      static_cast<const float*>(temps), static_cast<const int32_t*>(edge_draw), static_cast<const float*>(u_draw),
      static_cast<float*>(sys_temps), n_slots, n_spins, do_pt, pt_full,
      parity, hot, cold);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
