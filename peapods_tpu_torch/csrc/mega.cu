// Hopper kernels of the mega path and of the replica path: the
// checkerboard colour pass and the per-sweep parallel-tempering step.
//
// Replaces the TPU megakernel peapods_tpu/ops/pallas_mega.py:_mega_kernel
// (with its colour update pallas_sweep.py:_kernel_body / _kernel_body_2sub
// and the hardware-PRNG uniform _hw_uniform) and, with pairs.cu's
// pair_overlap, the pairs megakernel pallas_megapair.py:_mp_kernel (its 3D
// body _mp_body and its PT on each replica's ladder).  What is ported is
// what those kernels compute, not their VMEM layout: one sweep of a
// realization is
//   colour_pass(colour 0), colour_pass(colour 1, measuring), pt_step
// -- three launches on the caller's stream (four with pair_overlap), no
// host synchronisation.
//
// * Spins stay stored by system ([d, n_systems, n] int8); the slot a block
//   works on reads its system from sid[d, slot], so a PT swap exchanges two
//   sid entries and never moves a spin tile.  Slot r T + t is replica r at
//   temperature t; temps are given by slot.
// * A 3D [L0, L1, L2] lattice (even extents) has the colours (x + y + z) & 1
//   and six coupling grids; its site update is update_sites_3d (mega.cuh),
//   the same Philox counter (slot, colour, site / 4) over the active sites
//   in row-major order.
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
//   system's partials in one fixed order, set by the row's length alone
//   (share_sum; ops/mega.py ordered_partial_sum is the same order in
//   torch).  No float atomics: e is the same from run to run.
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
//
// What bounds pt_step: it reads each slot's row of partials (8 B a partial)
// and a few bytes of PT state -- 2 MB at 4096^2 in 4 bands (4 rows of
// 65,536 partials; 0.63 us at 3.35 TB/s), a few KB at the flagship, where
// its launch's latency is the bound.  Its first design gave a realization
// one CTA and each slot one thread, which added the row in a chain of
// dependent loads and adds: 1.55 ms at 4096^2, four threads of the card
// streaming 2 MB.  Now a warp sums a row (8 loads in flight a lane, the
// lanes paired as warp_tree pairs them), a row longer than kThreads
// partials is split over up to kPtMaxSplit CTAs whose last, found by a
// ticket, adds their sums and runs PT (still one launch), and a row of at
// most 32 partials takes one thread and 16-byte loads: 0.0057 ms at 4096^2,
// 0.0036 ms at the flagship (0.0044 before; NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

using namespace peapods;

namespace {

constexpr int kPtMaxSplit = 256;  // CTAs that share a row of pt_step

__global__ void __launch_bounds__(kThreads)
colour_pass_kernel(int8_t* __restrict__ spins, const float* __restrict__ jgrids,
                   const int32_t* __restrict__ sid,
                   const float* __restrict__ temps,
                   const int32_t* __restrict__ words, float* __restrict__ e_part,
                   int32_t* __restrict__ m_part, int L0, int L1, int L2, int n_slots,
                   int colour, int gibbs) {
  const int slot = blockIdx.y;
  const int d = blockIdx.z;
  const bool three_d = L2 > 1;
  const size_t n = static_cast<size_t>(L0) * L1 * L2;
  const int sys = sid[d * n_slots + slot];
  const bool measure = e_part != nullptr;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  float e_acc = 0.0f;
  int m_acc = 0;
  if (kSitesPerThread * g < static_cast<int>(n >> 1)) {
    const uint4 r4 = philox4x32_10(static_cast<uint32_t>(words[2 * d]),
                                   static_cast<uint32_t>(words[2 * d + 1]),
                                   static_cast<uint32_t>(slot),
                                   static_cast<uint32_t>(colour),
                                   static_cast<uint32_t>(g), 0u);
    int8_t* s = spins + (static_cast<size_t>(d) * n_slots + sys) * n;
    const float inv_half_t = 1.0f / (0.5f * temps[slot]);
    if (three_d)
      update_sites_3d(s, jgrids + static_cast<size_t>(d) * 6 * n, L0, L1, L2,
                      colour, inv_half_t, gibbs, r4, g, measure, e_acc, m_acc);
    else
      update_sites(s, jgrids + static_cast<size_t>(d) * 4 * n, L0, L1, colour,
                   inv_half_t, gibbs, r4, g, measure, e_acc, m_acc);
  }
  if (!measure) return;  // uniform across the block
  block_partials(e_acc, m_acc, e_part, m_part,
                 (static_cast<size_t>(d) * n_slots + sys) * gridDim.x + blockIdx.x);
}

struct PtState {
  float* es;  // [n_temps] energies per spin of the ladder's slots (shared memory)
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
  atomicAdd(st.ea + e, 1);  // the ladders of a realization share the counters
  if (!(delta >= logf(u))) return;
  atomicAdd(st.ec + e, 1);
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

// One CTA's share of a row of n partials (`first` = the share's first
// lane, P = kThreads x the CTAs of a row): the warp's lane l holds the sums
// of lanes first + l + 32 j (j < 8), each lane adding its values first +
// lane, + P, + 2P, ... from 0 in turn (a lane past the row adds 0, which is
// exact); the 256 lane sums are then paired as warp_tree pairs them, and
// lane 0 returns the share's sum.  Coherent: the values were written by
// other CTAs of this launch (read through L2).  ops/mega.py
// ordered_partial_sum is this order in torch.
template <bool kCoherent>
__device__ __forceinline__ void share_sum(const float* __restrict__ e,
                                          const int32_t* __restrict__ m, int n,
                                          int first, int P, int lane, float& e_sum,
                                          int& m_sum) {
  float a[8];
  int b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = 0.0f;
    b[j] = 0;
  }
  for (int o = first + lane; o < n; o += P) {
    float x[8];
    int y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // every load issued before any add
      const int i = o + 32 * j;
      x[j] = i < n ? (kCoherent ? __ldcg(e + i) : e[i]) : 0.0f;
      y[j] = i < n ? (kCoherent ? __ldcg(m + i) : m[i]) : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] += x[j];
      b[j] += y[j];
    }
  }
  float s = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]));
  int t = ((b[0] + b[4]) + (b[2] + b[6])) + ((b[1] + b[5]) + (b[3] + b[7]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    t += __shfl_down_sync(0xffffffffu, t, off);
  }
  e_sum = s;
  m_sum = t;
}

// One level of a halving tree in registers: v[l] += v[l + H] for l < H.
template <int H>
__device__ __forceinline__ void halve(float* v, int* w) {
#pragma unroll
  for (int l = 0; l < H; ++l) {
    v[l] += v[l + H];
    w[l] += w[l + H];
  }
}

// Grid (split, d): CTA c of realization d sums its share (lanes c kThreads
// .. c kThreads + 255 of the split kThreads lanes) of every slot's row, a
// warp a slot.  With one CTA a realization (split 1) that is the row's sum;
// else each CTA writes its shares' sums to part_e / part_m [d, n_slots,
// split] and takes a ticket, and the realization's last CTA adds the split
// sums as a row of its own (share_sum again), resets the ticket for the next
// launch and runs the PT event.  kShort: rows of at most 32 partials
// (split 1), a thread a slot and no more threads than slots: lanes past the
// row hold 0 and lane l's sum is 0 + x[l], so share_sum's pairing is the
// halving tree of these 32 values, here in registers (no chain of shuffles
// a slot), read 16 bytes a load where a row is a multiple of 4 long.
template <bool kShort>
__global__ void __launch_bounds__(kThreads)
pt_step_kernel(const float* __restrict__ e_part, const int32_t* __restrict__ m_part,
               int n_blocks, int split, float* part_e, int32_t* part_m,
               int32_t* ticket, float* __restrict__ e_out, int32_t* __restrict__ m_out,
               int out_stride, int32_t* sid, int32_t* ea, int32_t* ec, int32_t* rtrips,
               int32_t* tstate, const float* __restrict__ temps,
               const int32_t* __restrict__ edge_draw, const float* __restrict__ u_draw,
               float* __restrict__ sys_temps, int n_slots, int n_replicas, int n_spins,
               int do_pt, int pt_full, int parity, int hot, int cold) {
  extern __shared__ float es[];
  __shared__ bool last;
  const int d = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  // the slot's energy per spin and magnetization, once its row is summed
  auto finish = [&](int slot, float e_sum, int m_sum) {
    const float e = e_sum / static_cast<float>(n_spins);
    es[slot] = e;
    if (e_out != nullptr) {
      e_out[static_cast<size_t>(d) * out_stride + slot] = e;
      m_out[static_cast<size_t>(d) * out_stride + slot] = m_sum;
    }
  };
  // the row of the slot's system
  auto row = [&](int slot) {
    return (static_cast<size_t>(d) * n_slots + sid[d * n_slots + slot]) * n_blocks;
  };
  if (kShort) {
    for (int slot = threadIdx.x; slot < n_slots; slot += blockDim.x) {
      const size_t o = row(slot);
      float v[32];
      int w[32];
      if ((n_blocks & 3) == 0 && ((reinterpret_cast<size_t>(e_part) |
                                   reinterpret_cast<size_t>(m_part)) & 15) == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const bool in = 4 * q < n_blocks;
          const float4 a = in ? reinterpret_cast<const float4*>(e_part + o)[q]
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const int4 c = in ? reinterpret_cast<const int4*>(m_part + o)[q]
                            : make_int4(0, 0, 0, 0);
          v[4 * q] = in ? 0.0f + a.x : 0.0f;
          v[4 * q + 1] = in ? 0.0f + a.y : 0.0f;
          v[4 * q + 2] = in ? 0.0f + a.z : 0.0f;
          v[4 * q + 3] = in ? 0.0f + a.w : 0.0f;
          w[4 * q] = c.x;
          w[4 * q + 1] = c.y;
          w[4 * q + 2] = c.z;
          w[4 * q + 3] = c.w;
        }
      } else {
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          v[l] = l < n_blocks ? 0.0f + e_part[o + l] : 0.0f;
          w[l] = l < n_blocks ? m_part[o + l] : 0;
        }
      }
      halve<16>(v, w);
      halve<8>(v, w);
      halve<4>(v, w);
      halve<2>(v, w);
      halve<1>(v, w);
      finish(slot, v[0], w[0]);
    }
  } else {
    for (int slot = warp; slot < n_slots; slot += kWarps) {
      const size_t o = row(slot);
      float e_sum;
      int m_sum;
      share_sum<false>(e_part + o, m_part + o, n_blocks, blockIdx.x * kThreads,
                       split * kThreads, lane, e_sum, m_sum);
      if (lane != 0) continue;
      if (split == 1) {
        finish(slot, e_sum, m_sum);
      } else {
        const size_t q = (static_cast<size_t>(d) * n_slots + slot) * split + blockIdx.x;
        part_e[q] = e_sum;
        part_m[q] = m_sum;
      }
    }
    if (split > 1) {
      __threadfence();  // the shares' sums reach L2 before the ticket
      __syncthreads();
      if (threadIdx.x == 0) last = atomicAdd(ticket + d, 1) == split - 1;
      __syncthreads();
      if (!last) return;
      for (int slot = warp; slot < n_slots; slot += kWarps) {
        const size_t o = (static_cast<size_t>(d) * n_slots + slot) * split;
        float e_sum;
        int m_sum;
        share_sum<true>(part_e + o, part_m + o, split, 0, kThreads, lane, e_sum, m_sum);
        if (lane == 0) finish(slot, e_sum, m_sum);
      }
      if (threadIdx.x == 0) ticket[d] = 0;
    }
  }
  __syncthreads();
  if (!do_pt) return;

  // one thread per replica ladder (slots r T .. r T + T - 1)
  const int n_temps = n_slots / n_replicas;
  const int n_edges = n_temps - 1;
  for (int r = threadIdx.x; r < n_replicas; r += blockDim.x) {
    const int o = r * n_temps;
    PtState st{es + o, sid + d * n_slots + o, ea + d * n_edges, ec + d * n_edges,
               rtrips + d * n_slots, tstate + d * n_slots, temps + o, n_spins, hot,
               cold};
    const size_t dr = static_cast<size_t>(d) * n_replicas + r;
    if (pt_full) {
      for (int i = 0; i < 2; ++i) {
        const int p = i == 0 ? parity : 1 - parity;
        for (int e = p; e < n_edges; e += 2)
          try_edge(st, e, u_draw[(dr * 2 + i) * n_edges + e]);
      }
    } else {
      try_edge(st, edge_draw[dr], u_draw[dr]);
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

// One colour pass over every (realization, slot) of a 2D [L0, L1] (L2 = 1)
// or 3D [L0, L1, L2] lattice, jgrids [d, 4 or 6, n].  e_part / m_part are
// [d, n_slots, blocks] (both null for a pass that does not measure).
int peapods_colour_pass(void* spins, const void* jgrids, const void* sid,
                        const void* temps, const void* words, void* e_part,
                        void* m_part, int n_disorder, int n_slots, int L0, int L1,
                        int L2, int colour, int gibbs, void* stream) {
  // a 3D lattice's active sites are those of an [L0 L1, L2] grid
  const int blocks = L2 > 1 ? colour_pass_blocks(L0 * L1, L2) : colour_pass_blocks(L0, L1);
  const dim3 grid(blocks, n_slots, n_disorder);
  colour_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const float*>(jgrids),
      static_cast<const int32_t*>(sid), static_cast<const float*>(temps),
      static_cast<const int32_t*>(words), static_cast<float*>(e_part),
      static_cast<int32_t*>(m_part), L0, L1, L2, n_slots, colour, gibbs);
  return static_cast<int>(cudaGetLastError());
}

// Reduce one sweep's partials ([d, n_systems, n_blocks], by system: read
// through sid) into its (e, m) rows by slot (skipped when e_out is null)
// and run the PT event (when do_pt) on each of the n_replicas ladders of
// every realization (slots r T .. r T + T - 1, temps [n_slots] by slot),
// with the draws u_draw (f32 [d, R] single edge, [d, R, 2, n_edges] full
// ladder) and edge_draw (int32 [d, R]); a PT event then rewrites each
// system's temperature sys_temps ([d, n_systems]).  split: the CTAs that
// share a row (1 to kPtMaxSplit; ops/mega.py pt_split); with split > 1,
// part_e / part_m hold [d, n_slots, split] values and ticket [d] zeros,
// which the kernel leaves zero.
int peapods_pt_step(const void* e_part, const void* m_part, int n_blocks, int split,
                    void* part_e, void* part_m, void* ticket, void* e_out, void* m_out,
                    int out_stride, void* sid, void* ea, void* ec, void* rtrips,
                    void* tstate, const void* temps, const void* edge_draw,
                    const void* u_draw, void* sys_temps, int n_disorder, int n_slots,
                    int n_replicas, int n_spins, int do_pt, int pt_full, int parity,
                    int hot, int cold, void* stream) {
  if (split < 1 || split > kPtMaxSplit || (n_blocks <= 32 && split != 1) ||
      (split > 1 && (part_e == nullptr || part_m == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool short_rows = n_blocks <= 32;  // split 1
  const int slots32 = (n_slots + 31) / 32 * 32;
  const int threads = short_rows && slots32 < kThreads ? slots32 : kThreads;
  auto kernel = short_rows ? pt_step_kernel<true> : pt_step_kernel<false>;
  kernel<<<dim3(split, n_disorder), threads, n_slots * sizeof(float),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e_part), static_cast<const int32_t*>(m_part), n_blocks,
      split, static_cast<float*>(part_e), static_cast<int32_t*>(part_m),
      static_cast<int32_t*>(ticket), static_cast<float*>(e_out),
      static_cast<int32_t*>(m_out), out_stride, static_cast<int32_t*>(sid),
      static_cast<int32_t*>(ea), static_cast<int32_t*>(ec), static_cast<int32_t*>(rtrips),
      static_cast<int32_t*>(tstate), static_cast<const float*>(temps),
      static_cast<const int32_t*>(edge_draw), static_cast<const float*>(u_draw),
      static_cast<float*>(sys_temps), n_slots, n_replicas, n_spins, do_pt, pt_full,
      parity, hot, cold);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
