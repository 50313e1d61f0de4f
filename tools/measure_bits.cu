// The sign-bit form of measure_nb_table, an alternative that
// tools/probe_measure.py (--bits) builds and times beside the port's
// per-system form (peapods_tpu_torch/csrc/sweep_nb.cu measure_nb_table);
// the port does not launch it.
//
// Same function and order of adds: the (e, m) partials [d, S, blocks] of
// blocks of 1024 sites (256 groups of four), a site's e 0 + (s s_fwd) J
// over the offsets in order, a group's four values added from 0, each
// block's 256 group sums paired by one warp (warp_tree), so bitwise
// ops/energy.py measure_nb_plain(blocks=True).  A thread-block cluster of C
// CTAs takes one realization: CTA r stages the sign words of its slice of
// sites, [r slice, (r + 1) slice), in shared memory, one 32-bit word a site
// with bit q the sign of system q (S <= 32 systems); the cluster waits;
// CTA r then takes blocks r, r + C, ..., a thread a group of four sites for
// every system: the group's table rows and couplings once, each neighbour's
// sign word one load from its owner's shared memory, and every system's
// term the coupling with its sign flipped by one bit of the xor of two
// words.  Build: nvcc as ops/_build.py NVCC_FLAGS, -I the port's csrc.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mega.cuh"

using namespace peapods;
namespace cg = cooperative_groups;

namespace {

constexpr int kBitsMaxSys = 32;
constexpr int kBitsSmem = 232448;

// A site's sign word, from the shared memory of its slice's owner.
__device__ __forceinline__ uint32_t sign_word(const cg::cluster_group& cluster, uint32_t* words,
                                              int j, int slice, uint32_t m, int s) {
  const int owner = fast_div(j, m, s);
  return cluster.map_shared_rank(words, owner)[j - owner * slice];
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
measure_bits_kernel(const int8_t* __restrict__ spins, const float* __restrict__ coup,
                    const int32_t* __restrict__ fwd, int n, int S, int blocks, int slice,
                    uint32_t m_div, int s_div, float* __restrict__ e_part,
                    int32_t* __restrict__ m_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int words_bytes = ((slice * 4 + 15) / 16) * 16;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem_raw);
  float* se = reinterpret_cast<float*>(smem_raw + words_bytes);  // [S][kThreads]
  int* sm = reinterpret_cast<int*>(se + S * kThreads);          // [S][kThreads]
  const int z = blockIdx.y;
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lo = min(n, rank * slice);
  const int hi = min(n, lo + slice);
  const int8_t* s0 = spins + static_cast<size_t>(z) * S * n;
  // (1) the slice's sign words, 8 systems' loads issued together
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(spins) & 3) == 0;
  for (int i0 = lo + 4 * tid; i0 < hi; i0 += 4 * kThreads) {
    const int cnt = min(4, hi - i0);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int q0 = 0; q0 < S; q0 += 8) {
      uint32_t x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int8_t* a = s0 + static_cast<size_t>(q0 + k) * n + i0;
        uint32_t v = 0;
        if (q0 + k < S) {
          if (vec) {
            v = __ldg(reinterpret_cast<const uint32_t*>(a));
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (b < cnt) v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(a + b))) << (8 * b);
          }
        }
        x[k] = v & 0x80808080u;
      }
      uint32_t z8 = 0;  // byte b: site b's signs of systems q0 .. q0 + 7
#pragma unroll
      for (int k = 0; k < 8; ++k) z8 |= x[k] >> (7 - k);
#pragma unroll
      for (int b = 0; b < 4; ++b) w[b] |= ((z8 >> (8 * b)) & 0xFFu) << q0;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (b < cnt) words[i0 - lo + b] = w[b];
  }
  cluster.sync();
  // (2) the CTA's blocks, every system
  for (int blk = rank; blk < blocks; blk += C) {
    const int i0 = 4 * (blk * kThreads + tid);
    const int cnt = max(0, min(4, n - i0));
    float acc[kBitsMaxSys];
#pragma unroll
    for (int q = 0; q < kBitsMaxSys; ++q) acc[q] = 0.0f;
    uint32_t own[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= cnt) break;
      const int i = i0 + k;
      int f[NB];
      float jc[NB];
#pragma unroll
      for (int dd = 0; dd < NB; ++dd) {
        f[dd] = __ldg(fwd + static_cast<size_t>(i) * NB + dd);
        jc[dd] = __ldg(coup + (static_cast<size_t>(z) * n + i) * NB + dd);
      }
      own[k] = sign_word(cluster, words, i, slice, m_div, s_div);
      uint32_t x[NB];
#pragma unroll
      for (int dd = 0; dd < NB; ++dd)
        x[dd] = own[k] ^ sign_word(cluster, words, f[dd], slice, m_div, s_div);
#pragma unroll
      for (int q = 0; q < kBitsMaxSys; ++q) {
        if (q >= S) break;
        float e = 0.0f;
#pragma unroll
        for (int dd = 0; dd < NB; ++dd)
          e = e + __uint_as_float(__float_as_uint(jc[dd]) ^ (((x[dd] >> q) & 1u) << 31));
        acc[q] += e;
      }
    }
#pragma unroll
    for (int q = 0; q < kBitsMaxSys; ++q) {
      if (q >= S) break;
      int m = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < cnt) m += 1 - 2 * static_cast<int>((own[k] >> q) & 1u);
      se[q * kThreads + tid] = acc[q];
      sm[q * kThreads + tid] = m;
    }
    __syncthreads();
    const int lane = tid & 31;
    for (int q = tid >> 5; q < S; q += kThreads >> 5) {
      const float et = warp_tree(se + q * kThreads, lane);
      const int mt = warp_tree(sm + q * kThreads, lane);
      if (lane == 0) {
        const size_t o = (static_cast<size_t>(z) * S + q) * blocks + blk;
        e_part[o] = et;
        m_part[o] = mt;
      }
    }
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while another reads its words
}

}  // namespace

extern "C" {

// e_part f32 / m_part int32 [d, S, blocks] of spins int8 [d, S, n] (S <= 32)
// with couplings f32 [d, n, nb] on the table fwd int32 [n, nb]; C CTAs a
// cluster (1 to 8), slice a multiple of 4 with C slice >= n, (m, s) the
// slice's fast divisor (ops/lattice.py fast_divisor).
int peapods_measure_bits(const void* spins, const void* coup, const void* fwd, void* e_part,
                         void* m_part, int n, int nb, int d, int S, int C, int slice, int m,
                         int s, void* stream) {
  const int blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const int words_bytes = ((slice * 4 + 15) / 16) * 16;
  const int smem = words_bytes + 2 * S * kThreads * 4;
  if (n < 1 || d < 1 || d > 65535 || S < 1 || S > kBitsMaxSys || C < 1 || C > 8 ||
      slice % 4 || static_cast<long long>(C) * slice < n || smem > kBitsSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kernel) -> cudaError_t {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBitsSmem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, d, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int8_t*>(spins),
                             static_cast<const float*>(coup), static_cast<const int32_t*>(fwd), n,
                             S, blocks, slice, static_cast<uint32_t>(m), s,
                             static_cast<float*>(e_part), static_cast<int32_t*>(m_part));
    return err != cudaSuccess ? err : cudaGetLastError();
  };
  switch (nb) {
    case 4: return static_cast<int>(go(measure_bits_kernel<4>));
    case 9: return static_cast<int>(go(measure_bits_kernel<9>));
    case 13: return static_cast<int>(go(measure_bits_kernel<13>));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
