// Device helpers of the port's kernels: Philox4x32-10, the 24-bit uniform,
// and the checkerboard site update with its block partial sums.  Each is
// bitwise its plain torch version (ops/rng.py, ops/sweep.py); the tests and
// chip_smoke.py hold them against each other.
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

// The checkerboard update of one thread's active-colour sites 4g .. 4g+3 of
// one [H, W] system s with coupling grids jg ([4, H, W]: ju, jd, jl, jr);
// site i of the colour sits at row i / (W/2), column 2 (i % (W/2)) +
// ((row + colour) & 1), and takes word i % 4 of r4.  When measuring, adds
// s*field of the (odd) sites and s of both sites of each column pair to
// e_acc / m_acc.  Shared by mega.cu's colour_pass and sweep.cu's sweep_2d.
__device__ __forceinline__ void update_sites(int8_t* s, const float* jg, int H,
                                             int W, int colour, float inv_half_t,
                                             int gibbs, uint4 r4, int g,
                                             bool measure, float& e_acc,
                                             int& m_acc) {
  const int wh = W >> 1;
  const int n_half = H * wh;
  const size_t hw = static_cast<size_t>(H) * W;
  const float* ju = jg;
  const float* jd = ju + hw;
  const float* jl = jd + hw;
  const float* jr = jl + hw;
  const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int i = kSitesPerThread * g + k;
    if (i >= n_half) break;
    const int r = i / wh;
    const int col = 2 * (i - r * wh) + ((r + colour) & 1);
    const int up = r == 0 ? H - 1 : r - 1;
    const int dn = r == H - 1 ? 0 : r + 1;
    const int lf = col == 0 ? W - 1 : col - 1;
    const int rg = col == W - 1 ? 0 : col + 1;
    const size_t idx = static_cast<size_t>(r) * W + col;
    float field = static_cast<float>(s[static_cast<size_t>(up) * W + col]) * ju[idx] +
                  static_cast<float>(s[static_cast<size_t>(dn) * W + col]) * jd[idx];
    field = field + static_cast<float>(s[static_cast<size_t>(r) * W + lf]) * jl[idx];
    field = field + static_cast<float>(s[static_cast<size_t>(r) * W + rg]) * jr[idx];
    float sv = static_cast<float>(s[idx]);
    const float x = (-sv * field) * inv_half_t;
    const float p = gibbs ? 1.0f / (1.0f + expf(-x))
                          : kKeep * expf(fminf(x, 0.0f));
    if (uniform24(w4[k]) < p) {
      sv = -sv;
      s[idx] = static_cast<int8_t>(sv);
    }
    if (measure) {
      e_acc += sv * field;
      m_acc += static_cast<int>(sv) + static_cast<int>(s[idx ^ 1]);
    }
  }
}

// The 3D cubic counterpart of update_sites: system s is [L0, L1, L2] (all
// even) with coupling grids jg ([6, n]: the bond arriving from x-1, the own
// x bond, then the same for y and z).  Site i of the colour sits at x = i /
// (L1 L2/2), y = (i / (L2/2)) % L1, z = 2 (i % (L2/2)) + ((x + y + colour) &
// 1), and takes word i % 4 of r4.  The field adds the six terms in the order
// x-, x+, y-, y+, z-, z+ (pallas_megapair._mp_body).  z pairs (2k, 2k+1) are
// index pairs (idx, idx ^ 1), so m adds both sites of each as in 2D.
__device__ __forceinline__ void update_sites_3d(int8_t* s, const float* jg, int L0,
                                                int L1, int L2, int colour,
                                                float inv_half_t, int gibbs, uint4 r4,
                                                int g, bool measure, float& e_acc,
                                                int& m_acc) {
  const int zh = L2 >> 1;
  const int plane = L1 * zh;
  const int n_half = L0 * plane;
  const size_t n = static_cast<size_t>(L0) * L1 * L2;
  const size_t sx = static_cast<size_t>(L1) * L2;
  const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int i = kSitesPerThread * g + k;
    if (i >= n_half) break;
    const int x = i / plane;
    const int rem = i - x * plane;
    const int y = rem / zh;
    const int z = 2 * (rem - y * zh) + ((x + y + colour) & 1);
    const size_t row = static_cast<size_t>(x) * sx + static_cast<size_t>(y) * L2;
    const size_t idx = row + z;
    const size_t xm = (x == 0 ? L0 - 1 : x - 1) * sx + static_cast<size_t>(y) * L2 + z;
    const size_t xp = (x == L0 - 1 ? 0 : x + 1) * sx + static_cast<size_t>(y) * L2 + z;
    const size_t ym = static_cast<size_t>(x) * sx +
                      static_cast<size_t>(y == 0 ? L1 - 1 : y - 1) * L2 + z;
    const size_t yp = static_cast<size_t>(x) * sx +
                      static_cast<size_t>(y == L1 - 1 ? 0 : y + 1) * L2 + z;
    const size_t zm = row + (z == 0 ? L2 - 1 : z - 1);
    const size_t zp = row + (z == L2 - 1 ? 0 : z + 1);
    float field = static_cast<float>(s[xm]) * jg[idx] +
                  static_cast<float>(s[xp]) * jg[n + idx];
    field = field + static_cast<float>(s[ym]) * jg[2 * n + idx];
    field = field + static_cast<float>(s[yp]) * jg[3 * n + idx];
    field = field + static_cast<float>(s[zm]) * jg[4 * n + idx];
    field = field + static_cast<float>(s[zp]) * jg[5 * n + idx];
    float sv = static_cast<float>(s[idx]);
    const float xv = (-sv * field) * inv_half_t;
    const float p = gibbs ? 1.0f / (1.0f + expf(-xv))
                          : kKeep * expf(fminf(xv, 0.0f));
    if (uniform24(w4[k]) < p) {
      sv = -sv;
      s[idx] = static_cast<int8_t>(sv);
    }
    if (measure) {
      e_acc += sv * field;
      m_acc += static_cast<int>(sv) + static_cast<int>(s[idx ^ 1]);
    }
  }
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
