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

// Blocks per system of a colour pass: the length of its partial-sum rows.
__host__ __device__ inline int colour_pass_blocks(int H, int W) {
  const int n_half = H * (W / 2);
  const int groups = (n_half + kSitesPerThread - 1) / kSitesPerThread;
  return (groups + kThreads - 1) / kThreads;
}

}  // namespace peapods
