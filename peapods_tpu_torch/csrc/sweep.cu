// Hopper kernel of the per-sweep path: one checkerboard colour of every
// (realization, system), at each system's own temperature.
//
// Replaces the TPU's stand-alone sweep peapods_tpu/ops/pallas_sweep.py:728
// sweep_2d (kernel _kernel :301, body _kernel_body :250, uniforms
// _hw_uniform :294; and its injected twin sweep_2d_injected :982, whose
// uniforms the plain version takes), the fused sweep and measurement :892
// sweep_2d_fused (kernel _kernel_fused :313) and the lane-packed form :847
// sweep_2d_packed.  It runs where a cluster phase sits between the sweep and
// the measurement.  One sweep is two launches on the caller's stream:
// colour 0, then colour 1.
//
// * Spins are stored by system ([d, n_systems, H, W] int8); the couplings
//   are the forward bonds ([d, H W, 2] f32: J0 down, J1 right), shared by
//   the systems of a realization.  A site's up and left bonds are its up
//   and left neighbours' forward bonds: bitwise the pre-shifted grids of
//   ops/sweep.py pack_coupling_grids (ju = roll(J0), jl = roll(J1)).
// * Active site i of the colour (row i / (W/2), column 2 (i % (W/2)) +
//   ((row + colour) & 1)) takes word i % 4 of Philox4x32-10 keyed by the
//   sweep's two words, counter (system, colour, i / 4, 0).  The reference
//   seeds its hardware PRNG with (kd0, kd1 + system) (make_seeds :67-81);
//   the system index sits in the counter here instead, which gives each
//   system its own stream the same way.  ops/rng.colour_uniforms draws the
//   same bits on the host side.
// * The field adds s_up ju + s_dn jd, then s_l jl, then s_r jr, and the
//   rules are mega.cuh flip_probability's (Metropolis u < (15/16) exp(min(x,
//   0)), Gibbs u < 1 / (1 + exp(-x)), x = (-s field) / (T/2)): the spins are
//   bitwise colour_pass's and the plain version's.  A colour-1 launch given
//   e_part / m_part also writes per-block partial sums of the post-sweep
//   energy (s field of the pass's sites) and magnetization (both sites of
//   each column pair) ([d, n_systems, colour_pass_blocks(H, W)]): a
//   thread's four sites added in order, the 256 threads of a block paired
//   as block_partials pairs them (ops/sweep.py sweep_2d_partials); pt_step
//   adds the partials in a fixed order.
//
// The design.  A thread takes a group of four active sites (one Philox
// block) of `per` systems of one realization (ops/sweep.py systems_per:
// up to 8, while the launch keeps half the card's resident threads), and
// reads the group's couplings once for those systems, into shared memory
// (16 B a site), where each system reads them again.  Its row is a
// multiply-shift division of the site index (the host's fast_divisor of
// W/2; no integer division on the device).  Where W % 8 == 0 (and the
// tensors are aligned) a group is eight columns of one row: its spins are
// one 8-byte load of each of rows r - 1, r, r + 1 and one edge byte, its
// couplings four 16-byte loads of the row's forward bonds and four words
// of the row above, and its flips one 8-byte store; any other width takes
// the per-site path with the same counters.  The measuring launch stages
// each system's thread sums in shared memory and reduces each with one
// warp (warp_tree, block_partials' pairing).  Built for four CTAs an SM
// (64 registers).
//
// What bounds it on the H100: per pass every spin read (the neighbours),
// the realization's couplings once (8 B a site) and the active spins
// written: 235 MB at 4096^2 x 4 systems, 0.070 ms at 3.35 TB/s.  The first
// design (a CTA a block of one system, a division a site, the
// four pre-shifted planes read again by every system, byte loads) took
// 0.443 ms a pass there; this one 0.131 (NVIDIA H100 80GB HBM3, 700 W;
// tools/probe_sweep.py times both designs).  Its first form held the
// couplings in registers (136 of them, one CTA an SM) and took 0.344: the
// card needs many resident warps to hide the loads.  Four CTAs an SM beat
// two or three (0.186, 0.145 ms), the 8-byte spin loads save 27% (the
// per-site path everywhere: 0.180), Philox is 8% (0.120 without it).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

using namespace peapods;

namespace {

constexpr int kMaxPer = 8;  // systems a thread: the measuring launch's shared rows
constexpr int kSweepBlocks = 4;  // CTAs an SM the kernel is built for (64 registers)

// One colour pass of group g (blockIdx.x * kThreads + lane: active sites
// 4g .. 4g+3) of systems blockIdx.y per .. + per - 1 of realization
// blockIdx.z.  The group's couplings (ju, jd, jl, jr of each site) are
// staged once in shared memory and read there for each system; registers
// then hold one system's spins at a time (kSweepBlocks CTAs an SM).  The
// vector path (vec: W % 8 == 0, aligned tensors) reads eight columns of
// rows r - 1, r, r + 1 as 8-byte words and writes the row's word once;
// the per-site path steps from site to site, across rows.
template <bool kMeasure>
__global__ void __launch_bounds__(kThreads, kSweepBlocks)
sweep_2d_kernel(int8_t* __restrict__ spins, const float* __restrict__ coup,
                const float* __restrict__ sys_temps, const int32_t* __restrict__ words,
                float* __restrict__ e_part, int32_t* __restrict__ m_part, int H, int W,
                uint32_t div_m, int div_s, int n_systems, int per, int colour, int gibbs,
                int vec) {
  __shared__ float4 cj[kSitesPerThread][kThreads];
  __shared__ float se[kMeasure ? kMaxPer : 1][kThreads];
  __shared__ int sm[kMeasure ? kMaxPer : 1][kThreads];
  const int dz = blockIdx.z;
  const int sys0 = blockIdx.y * per;
  const int wh = W >> 1;
  const int n_half = H * wh;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int i0 = kSitesPerThread * g;
  const size_t hw = static_cast<size_t>(H) * W;
  const float* J = coup + static_cast<size_t>(dz) * hw * 2;  // [hw, 2]
  if (i0 < n_half) {
    const int r0 = fast_div(i0, div_m, div_s);
    const int j0 = i0 - r0 * wh;  // the first site's column pair
    const uint32_t k0 = static_cast<uint32_t>(words[2 * dz]);
    const uint32_t k1 = static_cast<uint32_t>(words[2 * dz + 1]);
    if (vec) {
      // eight columns c0 .. c0 + 7 of row r0; the active ones at a + 2k
      const int c0 = 2 * j0;
      const int a = (r0 + colour) & 1;
      const int rw = r0 * W + c0;
      const int uw = (r0 == 0 ? H - 1 : r0 - 1) * W + c0;
      const int dw = (r0 == H - 1 ? 0 : r0 + 1) * W + c0;
      // the edge column: left of c0 (a = 0) or right of c0 + 7 (a = 1)
      const int edge = r0 * W + (a ? (c0 + 8 == W ? 0 : c0 + 8) : (c0 == 0 ? W - 1 : c0 - 1));
      {
        float e[16];  // (J0, J1) of columns c0 .. c0 + 7
        const float4* f = reinterpret_cast<const float4*>(J + 2 * rw);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 x = __ldg(f + v);
          e[4 * v] = x.x;
          e[4 * v + 1] = x.y;
          e[4 * v + 2] = x.z;
          e[4 * v + 3] = x.w;
        }
        const float jl0 = a ? e[1] : __ldg(J + 2 * edge + 1);  // J1 left of c0 (a = 0)
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k)
          cj[k][threadIdx.x] = make_float4(__ldg(J + 2 * (uw + a + 2 * k)),
                                           a ? e[4 * k + 2] : e[4 * k],
                                           k == 0 ? jl0 : (a ? e[4 * k + 1] : e[4 * k - 1]),
                                           a ? e[4 * k + 3] : e[4 * k + 1]);
      }
      for (int q = 0; q < per; ++q) {
        const int sys = sys0 + q;
        const size_t row = static_cast<size_t>(dz) * n_systems + sys;
        int8_t* s = spins + row * hw;
        const uint2 wr = *reinterpret_cast<const uint2*>(s + rw);
        const uint2 wu = *reinterpret_cast<const uint2*>(s + uw);
        const uint2 wd = *reinterpret_cast<const uint2*>(s + dw);
        const uint64_t eb = static_cast<uint8_t>(s[edge]);
        const float inv_half_t = 1.0f / (0.5f * sys_temps[row]);
        const uint4 r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),
                                       static_cast<uint32_t>(colour), static_cast<uint32_t>(g),
                                       0u);
        const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};
        const uint64_t w = (static_cast<uint64_t>(wr.y) << 32) | wr.x;
        // shifted so that active site k is byte 2k, its right neighbour
        // byte 2k + 1 and (k > 0) its left neighbour byte 2k - 1
        const uint64_t x = a ? (w >> 8) | (eb << 56) : w;
        const uint64_t xu = ((static_cast<uint64_t>(wu.y) << 32) | wu.x) >> (8 * a);
        const uint64_t xd = ((static_cast<uint64_t>(wd.y) << 32) | wd.x) >> (8 * a);
        const float left0 = a ? spin_at(w, 0) : static_cast<float>(static_cast<int8_t>(eb));
        uint64_t out = w;  // the row's eight bytes after the pass
        float e_acc = 0.0f;
        int m_acc = 0;
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k) {
          const float4 j = cj[k][threadIdx.x];
          const float sl = k == 0 ? left0 : spin_at(x, 2 * k - 1);
          const float sr = spin_at(x, 2 * k + 1);
          float field = spin_at(xu, 2 * k) * j.x + spin_at(xd, 2 * k) * j.y;
          field = field + sl * j.z;
          field = field + sr * j.w;
          float sv = spin_at(x, 2 * k);
          if (uniform24(w4[k]) < flip_probability((-sv * field) * inv_half_t, gibbs)) {
            sv = -sv;
            const int sh = 8 * (a + 2 * k);
            out = (out & ~(0xFFull << sh)) |
                  (static_cast<uint64_t>(static_cast<uint8_t>(static_cast<int8_t>(sv))) << sh);
          }
          if (kMeasure) {
            e_acc += sv * field;
            m_acc += static_cast<int>(sv) + static_cast<int>(a ? sl : sr);
          }
        }
        if (out != w)
          *reinterpret_cast<uint2*>(s + rw) =
              make_uint2(static_cast<uint32_t>(out), static_cast<uint32_t>(out >> 32));
        if (kMeasure) {
          se[q][threadIdx.x] = e_acc;
          sm[q][threadIdx.x] = m_acc;
        }
      }
    } else {
      // the per-site path: a group may straddle rows
      {
        int r = r0, j = j0;
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k) {
          if (i0 + k < n_half) {
            const int col = 2 * j + ((r + colour) & 1);
            const int idx = r * W + col;
            const int lf = col == 0 ? idx + W - 1 : idx - 1;
            cj[k][threadIdx.x] =
                make_float4(__ldg(J + 2 * ((r == 0 ? H - 1 : r - 1) * W + col)),
                            __ldg(J + 2 * idx), __ldg(J + 2 * lf + 1), __ldg(J + 2 * idx + 1));
          }
          if (++j == wh) {
            j = 0;
            ++r;
          }
        }
      }
      for (int q = 0; q < per; ++q) {
        const int sys = sys0 + q;
        const size_t row = static_cast<size_t>(dz) * n_systems + sys;
        int8_t* s = spins + row * hw;
        const float inv_half_t = 1.0f / (0.5f * sys_temps[row]);
        const uint4 r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),
                                       static_cast<uint32_t>(colour), static_cast<uint32_t>(g),
                                       0u);
        const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};
        float e_acc = 0.0f;
        int m_acc = 0;
        int r = r0, j = j0;
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k) {
          if (i0 + k >= n_half) break;
          const int col = 2 * j + ((r + colour) & 1);
          const int idx = r * W + col;
          const float4 jc = cj[k][threadIdx.x];
          float field = static_cast<float>(s[(r == 0 ? H - 1 : r - 1) * W + col]) * jc.x +
                        static_cast<float>(s[(r == H - 1 ? 0 : r + 1) * W + col]) * jc.y;
          field = field + static_cast<float>(s[col == 0 ? idx + W - 1 : idx - 1]) * jc.z;
          field = field + static_cast<float>(s[col == W - 1 ? idx + 1 - W : idx + 1]) * jc.w;
          float sv = static_cast<float>(s[idx]);
          if (uniform24(w4[k]) < flip_probability((-sv * field) * inv_half_t, gibbs)) {
            sv = -sv;
            s[idx] = static_cast<int8_t>(sv);
          }
          if (kMeasure) {
            e_acc += sv * field;
            m_acc += static_cast<int>(sv) + static_cast<int>(s[idx ^ 1]);
          }
          if (++j == wh) {
            j = 0;
            ++r;
          }
        }
        if (kMeasure) {
          se[q][threadIdx.x] = e_acc;
          sm[q][threadIdx.x] = m_acc;
        }
      }
    }
  } else if (kMeasure) {
    for (int q = 0; q < per; ++q) {
      se[q][threadIdx.x] = 0.0f;
      sm[q][threadIdx.x] = 0;
    }
  }
  if (!kMeasure) return;
  __syncthreads();
  // warp v reduces systems v, v + 8, ... of the CTA
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < per; q += kThreads / 32) {
    const float et = warp_tree(se[q], lane);
    const int mt = warp_tree(sm[q], lane);
    if (lane == 0) {
      const size_t o = (static_cast<size_t>(dz) * n_systems + sys0 + q) * gridDim.x + blockIdx.x;
      e_part[o] = et;
      m_part[o] = mt;
    }
  }
}

}  // namespace

extern "C" {

// One colour pass over every (realization, system).  spins int8 [d,
// n_systems, H, W]; coup f32 [d, H W, 2] (forward bonds); sys_temps f32 [d,
// n_systems]; words int32 [d, 2]; e_part / m_part [d, n_systems,
// colour_pass_blocks(H, W)] (both null: no measurement); (div_m, div_s)
// ops/lattice.py fast_divisor(W / 2); per the systems a thread (a divisor
// of n_systems, at most 8: ops/sweep.py systems_per).
int peapods_sweep_2d(void* spins, const void* coup, const void* sys_temps, const void* words,
                     void* e_part, void* m_part, int n_disorder, int n_systems, int H, int W,
                     int colour, int gibbs, int per, int div_m, int div_s, void* stream) {
  if (n_disorder < 1 || n_disorder > 65535 || n_systems < 1 || per < 1 || per > kMaxPer ||
      n_systems % per || n_systems / per > 65535 || H < 2 || W < 2 || W % 2 ||
      static_cast<long long>(H) * W > (1LL << 31) - 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto at = [](const void* p, unsigned a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const int vec = W % 8 == 0 && at(spins, 8) && at(coup, 16);
  const dim3 grid(colour_pass_blocks(H, W), n_systems / per, n_disorder);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto m = static_cast<uint32_t>(div_m);
  if (e_part)
    sweep_2d_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<int8_t*>(spins), static_cast<const float*>(coup),
        static_cast<const float*>(sys_temps), static_cast<const int32_t*>(words),
        static_cast<float*>(e_part), static_cast<int32_t*>(m_part), H, W, m, div_s,
        n_systems, per, colour, gibbs, vec);
  else
    sweep_2d_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<int8_t*>(spins), static_cast<const float*>(coup),
        static_cast<const float*>(sys_temps), static_cast<const int32_t*>(words), nullptr,
        nullptr, H, W, m, div_s, n_systems, per, colour, gibbs, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
