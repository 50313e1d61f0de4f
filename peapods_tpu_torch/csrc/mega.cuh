// Device helpers of the port's kernels: Philox4x32-10, the 24-bit uniform,
// the checkerboard flip probabilities, a multiply-shift division and the
// block partial sums.  Each is bitwise its plain torch version (ops/rng.py,
// ops/sweep.py); the tests and chip_smoke.py hold them against each other.
#pragma once

#include <cstddef>
#include <cstdint>

namespace peapods {

constexpr int kThreads = 256;        // threads per colour-pass block
constexpr int kSitesPerThread = 4;   // one Philox block of 4 words
constexpr float kKeep = 0.9375f;     // 1 - METROPOLIS_LAZINESS (1/16)
constexpr float kInv24 = 1.0f / 16777216.0f;

__device__ __forceinline__ uint4 philox4x32_10(uint32_t k0, uint32_t k1,
                                               uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float uniform24(uint32_t w) {
  return static_cast<float>(w >> 8) * kInv24;
}

// Metropolis and Gibbs flip probabilities of the checkerboard passes
// (colour_pass, sweep_2d, mega_resident), x = (-s field) / (T/2):
// Metropolis (15/16) exp(min(x, 0)), Gibbs 1 / (1 + exp(-x)), in the
// operation order of the plain torch version (ops/sweep.py acceptance).
__device__ __forceinline__ float flip_probability(float x, int gibbs) {
  return gibbs ? 1.0f / (1.0f + expf(-x)) : kKeep * expf(fminf(x, 0.0f));
}

// q / divisor for 0 <= q < 2^31 (m, s: ops/lattice.py fast_divisor; m = 0
// for a divisor of 1): a multiply and a shift, no division.
__device__ __forceinline__ int fast_div(int q, uint32_t m, int s) {
  return m ? static_cast<int>(__umulhi(static_cast<uint32_t>(q), m) >> s) : q;
}

// Byte k of w as a spin.
__device__ __forceinline__ float spin_at(uint64_t w, int k) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
}

// Tree sum of the block's kThreads (e, m) values into e_part[o] / m_part[o]
// by thread 0, in a fixed order: no float atomics, so a sum repeats exactly.
__device__ __forceinline__ void block_partials(float e_acc, int m_acc,
                                               float* e_part, int32_t* m_part,
                                               size_t o) {
  __shared__ float se[kThreads];
  __shared__ int sm[kThreads];
  se[threadIdx.x] = e_acc;
  sm[threadIdx.x] = m_acc;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      se[threadIdx.x] += se[threadIdx.x + off];
      sm[threadIdx.x] += sm[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    e_part[o] = se[0];
    m_part[o] = sm[0];
  }
}

// The sum of kThreads values x[0 .. kThreads) in shared memory, paired as
// block_partials pairs them: the first three tree levels (offsets 128, 64,
// 32) read by the lanes of one warp, the last five as shuffles; lane 0
// holds it.  One warp reduces a block's partial while the others go on.
template <typename T>
__device__ __forceinline__ T warp_tree(const T* x, int lane) {
  static_assert(kThreads == 256, "three shared levels, then a warp");
  T v = ((x[lane] + x[lane + 128]) + (x[lane + 64] + x[lane + 192])) +
        ((x[lane + 32] + x[lane + 160]) + (x[lane + 96] + x[lane + 224]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// warp_tree of x[0 .. n) followed by kThreads - n zeros, which are not
// read: the same adds (0 is added exactly), for a block whose threads past
// n hold no sites.
template <typename T>
__device__ __forceinline__ T warp_tree_prefix(const T* x, int lane, int n) {
  const auto at = [&](int i) { return i < n ? x[i] : T(0); };
  T v = ((at(lane) + at(lane + 128)) + (at(lane + 64) + at(lane + 192))) +
        ((at(lane + 32) + at(lane + 160)) + (at(lane + 96) + at(lane + 224)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The parallel-tempering event and the ordered sum of a row of partials,
// shared by mega.cu's pt_step and mega_resident.cu's chunk kernel.

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

// An accepted swap on ladder edge e: the two slots exchange their energies
// and systems, and the round-trip state of the systems that arrive at the
// hot or the cold slot moves on.
__device__ inline void swap_edge(PtState& st, int e) {
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

// Metropolis swap attempt on ladder edge e (tempering.rs:73-102).
__device__ inline void try_edge(PtState& st, int e, float u) {
  const float delta = (static_cast<float>(st.n_spins) * (st.es[e + 1] - st.es[e])) *
                      (1.0f / st.temps[e] - 1.0f / st.temps[e + 1]);
  atomicAdd(st.ea + e, 1);  // the ladders of a realization share the counters
  if (!(delta >= logf(u))) return;
  atomicAdd(st.ec + e, 1);
  swap_edge(st, e);
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

// Blocks per system of a colour pass: the length of its partial-sum rows.
__host__ __device__ inline int colour_pass_blocks(int H, int W) {
  const int n_half = H * (W / 2);
  const int groups = (n_half + kSitesPerThread - 1) / kSitesPerThread;
  return (groups + kThreads - 1) / kThreads;
}

}  // namespace peapods
