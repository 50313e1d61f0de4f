// Hopper kernels of the space-sharded sweep: one colour pass, and the (e, m)
// measurement, of every (realization, system) over one row band of a
// lattice split along its leading axis, reading the band's neighbours from
// a window that holds its rows and a halo of the neighbouring bands' edge
// rows on each side (band.cuh).  The halos are copied in before each pass
// by the engine (engine/loop.py run_chunk_space).
//
// Replaces the TPU's
//   peapods_tpu/ops/pallas_sweep.py:408 sweep_2d_halo_color (kernel
//     _kernel_color_halo :339; injected twin :471),
//   peapods_tpu/ops/pallas_sweep.py:605 sweep_2d_halo_color_packed (kernel
//     :522, twin :666: k narrow systems side by side in the 128 lanes),
//   peapods_tpu/ops/pallas_sweep3d.py:595 sweep_3d_halo_color (kernel
//     _kernel_color_halo3d :514, twin :663; plane slabs, halo_pack_3d :495),
//   peapods_tpu/ops/pallas_sweep_diag.py:727 sweep_gen_halo_color (kernel
//     _kernel_gen_halo :654, twin :773; any offset table with its greedy
//     colouring over a band extended by m = max |offset[0]| rows).
// The TPU needed four kernels for its lane packing, its sublane tiles and
// its pre-shifted coupling grids; here one kernel reads every neighbour
// from the window and the offsets.  Lane packing, the 8-row band gate and
// the per-shard seed XOR of the TPU are not carried over.
//
//   sweep_halo    one colour of the band.  Each site draws exactly the
//                 uniform that the unsharded per-sweep kernels draw for it,
//                 so that a run in bands is bitwise the run without them:
//                 * square (the 2D square lattice): sweep.cu's sweep_2d.
//                   Colour site i of the band (row r, column 2 j + ((row0 +
//                   r + colour) & 1), i = r W/2 + j) is global colour site
//                   row0 W/2 + i, which takes word (its index) % 4 of
//                   Philox keyed by the sweep's words, counter (system,
//                   colour, index / 4, 0); the field adds up, down, left,
//                   right in mega.cu colour_pass's order, and the parity
//                   is (global row + column) & 1.
//                 * otherwise (triangular, cubic, BCC, FCC, offset tables):
//                   sweep_nb.cu's sweep_nb.  Site i of the band is global
//                   site row0 L1 L2 + i, counter (system, colour, site / 4,
//                   0), the colour read from the lattice's colour table at
//                   that site; the field adds s(i + off_d) J[i, d], then
//                   s(i - off_d) J_bwd[i, d], for each offset in order.
//                 A thread owns four consecutive (colour) sites of the band
//                 and draws the Philox block of each group of four that
//                 they touch, so a band start that splits a group costs a
//                 second draw, never another uniform.  Given e_part /
//                 m_part, a pass also writes per-block partials: e sums
//                 s * field over the pass's sites and m sums every site of
//                 the band after the pass.  On a two-colour lattice (square,
//                 cubic) the colour-1 pass's field is that of the final
//                 colour-0 neighbours, halos included, so e counts each bond
//                 once (the reference's fused measure, pallas_sweep.py:
//                 353-360, 395-399).
//   measure_halo  per-block partials of e = sum_{i, d} s_i s(i + off_d)
//                 J[i, d] (measure_nb's order) and m of the band, reading
//                 forward neighbours across the band's edge from the halo.
//                 It measures the lattices of more than two colours, and
//                 the spins after an FK update of the staged path.
//
// Blocks of 256 threads cover 1024 (colour) sites of the band, counted from
// its first, as the unsharded kernels count them from the lattice's first:
// where a band starts on such a block boundary (a multiple of 2048 sites on
// the square lattice, of 1024 on the others) the band's partials are the
// unsharded kernel's partials of those sites, and the engine's in-order sum
// of every band's partials is bitwise the unsharded sum.
//
// Couplings are given per window site: coup_fwd[d, w, k] = J[site(w), k]
// and coup_bwd[d, w, k] = J[site(w) - off_k, k] (square: ju = coup_bwd[., 0],
// jd = coup_fwd[., 0], jl = coup_bwd[., 1], jr = coup_fwd[., 1], the values of
// the pre-shifted grids).  Built with -fmad=false and no fast math, so the
// arithmetic rounds as the plain versions' (ops/halo.py) does.
//
// What bounds it on the H100: per updated site, the int8 spin, its
// 2 n_nb int8 neighbours and 8 n_nb bytes of couplings read, one byte
// written (plus a colour byte on the coloured lattices).  At 4096^2 x 4
// systems in 4 bands a square pass over one band reads 16.8 MB of spins and
// 33.6 MB of couplings: 18 us at 3.35 TB/s; at 128^3 x 8, 4 us.  The first
// design (a CTA a block of one system, the neighbours found with runtime
// divisions, 6 + 4 n_nb a site) ran 0.112 ms and 0.277 ms there, 0.058 ms
// at 32^3 FCC (NVIDIA H100 80GB HBM3, 700 W): the divisions, and at 4096^2
// the couplings read again for every system (67 MB of sectors a system, more
// than the L2 holds).  Now a CTA takes one block of several systems (as many
// as leave about 1056 CTAs a launch), reads the square form's couplings once
// into shared memory and holds them over its systems, finds neighbours with
// band.cuh's multiply-shift division and residues, keeps its sites' loop
// rolled (40-58 registers: many resident warps hide the loads' latency) and
// reduces each system's partial with one warp: 0.063 ms, 0.030 ms and
// 0.0053 ms (tools/probe_band_kernels.py times both designs).  Loading a
// thread's three rows of eight spins as words was no faster; holding the
// couplings in registers (the sites unrolled, 114-168 registers) was
// slower, and so was a slab of the window in shared memory with the next
// system's copied in ahead (cp.async): its range check on every neighbour
// and two barriers a system cost more than the loads it hid.  The halo
// copies folded into the kernel are later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "band.cuh"
#include "mega.cuh"

using namespace peapods;

namespace {

constexpr int kHaloCtas = 1056;  // eight resident CTAs on each of the H100's 132 SMs

// One colour pass of systems sys0 .. sys1 - 1 of realization blockIdx.z over
// block blockIdx.x of 1024 (colour) sites of the band, four consecutive
// sites a thread.  NB = 0: the square form; else the offset form with NB
// offsets.  A thread works out its first site's coordinates once (one
// multiply-shift division) and steps to the next.  The square form holds
// its sites' couplings in shared memory over the systems, so that the
// couplings, shared by the systems of a realization, are read once a CTA.
// The sites are not unrolled: few registers, many resident warps.  Per
// system the CTA writes one partial, reduced by one warp in
// block_partials' pairing from a double-buffered shared row (one barrier a
// system).
template <int NB>
__global__ void __launch_bounds__(kThreads)
sweep_halo_kernel(int8_t* __restrict__ spins, const float* __restrict__ coup_fwd,
                  const float* __restrict__ coup_bwd,
                  const uint8_t* __restrict__ colours,
                  const float* __restrict__ sys_temps,
                  const int32_t* __restrict__ words, float* __restrict__ e_part,
                  int32_t* __restrict__ m_part, const BandWalk g, int n_systems,
                  int sys_per_cta, int colour, int gibbs) {
  __shared__ float se[2][kThreads];
  __shared__ int sm[2][kThreads];
  // the square form's couplings up, down, left, right of each site
  __shared__ float4 cj[NB == 0 ? kSitesPerThread : 1][kThreads];
  const int dz = blockIdx.z;
  const int nw = g.w.L[0] * g.block;
  const uint32_t k0 = static_cast<uint32_t>(words[2 * dz]);
  const uint32_t k1 = static_cast<uint32_t>(words[2 * dz + 1]);
  const bool measure = e_part != nullptr;
  const int i0 = kSitesPerThread * (blockIdx.x * kThreads + threadIdx.x);
  const int sys0 = blockIdx.y * sys_per_cta;
  const int sys1 = min(sys0 + sys_per_cta, n_systems);
  const int lane = threadIdx.x & 31;
  const int W = g.w.L[1];
  const int wh = W >> 1;
  const int n_sites = NB == 0 ? g.hl * wh : g.hl * g.block;
  const int n_mine = max(0, min(kSitesPerThread, n_sites - i0));
  const int gbase = NB == 0 ? g.row0 * wh : g.row0 * g.block;
  // the first site: the square form's colour row and column pair, the
  // offset form's coordinates and the mask of its sites of this colour
  int r0 = 0, jc0 = 0, c1_0 = 0, c2_0 = 0;
  unsigned act = 0;
  if constexpr (NB == 0) {
    r0 = band_div(g, kDivHalfRow, i0);
    jc0 = i0 - r0 * wh;
    const float2* fwd = reinterpret_cast<const float2*>(coup_fwd) + static_cast<size_t>(dz) * nw;
    const float2* bwd = reinterpret_cast<const float2*>(coup_bwd) + static_cast<size_t>(dz) * nw;
    int r = r0, jc = jc0;
    for (int k = 0; k < n_mine; ++k) {
      const int idx = (g.halo + r) * W + 2 * jc + ((g.row0 + r + colour) & 1);
      const float2 b = bwd[idx];
      const float2 f = fwd[idx];
      cj[k][threadIdx.x] = make_float4(b.x, f.x, b.y, f.y);
      if (++jc == wh) {
        jc = 0;
        ++r;
      }
    }
  } else {
    if (n_mine > 0) band_coords(g, i0, c1_0, c2_0);
    const int w0 = g.halo * g.block + i0;
    for (int k = 0; k < n_mine; ++k)
      if (colours[w0 + k] == colour) act |= 1u << k;
  }
  const float* jf = coup_fwd + static_cast<size_t>(dz) * nw * NB;  // the offset form's
  const float* jb = coup_bwd + static_cast<size_t>(dz) * nw * NB;
  for (int sys = sys0; sys < sys1; ++sys) {
    const size_t row = static_cast<size_t>(dz) * n_systems + sys;
    int8_t* s = spins + row * nw;
    const float T = sys_temps[row];
    float e_acc = 0.0f;
    int m_acc = 0;
    uint4 r4 = make_uint4(0u, 0u, 0u, 0u);
    int grp = -1;
    if constexpr (NB == 0) {
      const float inv_half_t = 1.0f / (0.5f * T);
      int r = r0, jc = jc0;
#pragma unroll 1
      for (int k = 0; k < n_mine; ++k) {
        const int gid = gbase + i0 + k;
        if ((gid >> 2) != grp) {
          grp = gid >> 2;
          r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),
                             static_cast<uint32_t>(colour), static_cast<uint32_t>(grp), 0u);
        }
        const int col = 2 * jc + ((g.row0 + r + colour) & 1);
        const int idx = (g.halo + r) * W + col;
        const int lf = col == 0 ? idx + W - 1 : idx - 1;
        const int rg = col == W - 1 ? idx - W + 1 : idx + 1;
        const float4 j = cj[k][threadIdx.x];
        float field = static_cast<float>(s[idx - W]) * j.x + static_cast<float>(s[idx + W]) * j.y;
        field = field + static_cast<float>(s[lf]) * j.z;
        field = field + static_cast<float>(s[rg]) * j.w;
        float sv = static_cast<float>(s[idx]);
        const float x = (-sv * field) * inv_half_t;
        const float p = gibbs ? 1.0f / (1.0f + expf(-x)) : kKeep * expf(fminf(x, 0.0f));
        if (uniform24(philox_word(r4, gid)) < p) {
          sv = -sv;
          s[idx] = static_cast<int8_t>(sv);
        }
        if (measure) {
          e_acc += sv * field;
          m_acc += static_cast<int>(sv) + static_cast<int>(s[idx ^ 1]);
        }
        if (++jc == wh) {
          jc = 0;
          ++r;
        }
      }
    } else {
      const float half_t = T * 0.5f;
      const float inv_half_t = 1.0f / (T * 0.5f);
      int c1 = c1_0, c2 = c2_0;
#pragma unroll 1
      for (int k = 0; k < n_mine; ++k) {
        const int w = g.halo * g.block + i0 + k;
        if ((act >> k) & 1u) {
          const int gid = gbase + i0 + k;
          if ((gid >> 2) != grp) {
            grp = gid >> 2;
            r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(sys),
                               static_cast<uint32_t>(colour), static_cast<uint32_t>(grp),
                               0u);
          }
          float field = 0.0f;
#pragma unroll
          for (int d = 0; d < NB; ++d) {
            const size_t b = static_cast<size_t>(w) * NB + d;
            field = field + static_cast<float>(s[band_neighbour(g, w, c1, c2, d, false)]) *
                                jf[b];
            field = field + static_cast<float>(s[band_neighbour(g, w, c1, c2, d, true)]) *
                                jb[b];
          }
          float sv = static_cast<float>(s[w]);
          const float eng = -sv * field;
          const float u = uniform24(philox_word(r4, gid));
          const bool flip = gibbs ? eng >= half_t * logf(u / (1.0f - u))
                                  : u < kKeep * expf(fminf(eng * inv_half_t, 0.0f));
          if (flip) {
            sv = -sv;
            s[w] = static_cast<int8_t>(sv);
          }
          if (measure) {
            e_acc += sv * field;
            m_acc += static_cast<int>(sv);
          }
        } else if (measure) {
          m_acc += s[w];
        }
        band_next(g, c1, c2);
      }
    }
    if (measure) {  // uniform across the launch
      const int buf = (sys - sys0) & 1;
      se[buf][threadIdx.x] = e_acc;
      sm[buf][threadIdx.x] = m_acc;
      __syncthreads();
      if (threadIdx.x < 32) {
        const float et = warp_tree(se[buf], lane);
        const int mt = warp_tree(sm[buf], lane);
        if (lane == 0) {
          e_part[row * gridDim.x + blockIdx.x] = et;
          m_part[row * gridDim.x + blockIdx.x] = mt;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
measure_halo_kernel(const int8_t* __restrict__ spins,
                    const float* __restrict__ coup_fwd, const BandWalk g,
                    float* __restrict__ e_part, int32_t* __restrict__ m_part,
                    int n_systems) {
  const int sys = blockIdx.y;
  const int dz = blockIdx.z;
  const int nw = g.w.L[0] * g.block;
  const int nb = g.w.n_nb;
  const int n_band = g.hl * g.block;
  const size_t row = static_cast<size_t>(dz) * n_systems + sys;
  const int8_t* s = spins + row * nw;
  const float* jf = coup_fwd + static_cast<size_t>(dz) * nw * nb;
  const int i0 = kSitesPerThread * (blockIdx.x * blockDim.x + threadIdx.x);
  float e_acc = 0.0f;
  int m_acc = 0;
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int i = i0 + k;
    if (i >= n_band) break;
    const int w = g.halo * g.block + i;
    int c1, c2;
    band_coords(g, w, c1, c2);
    const float sv = static_cast<float>(s[w]);
    float e = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxOffsets; ++d) {
      if (d == nb) break;
      e = e + sv * static_cast<float>(s[band_neighbour(g, w, c1, c2, d, false)]) *
                  jf[static_cast<size_t>(w) * nb + d];
    }
    e_acc += e;
    m_acc += s[w];
  }
  block_partials(e_acc, m_acc, e_part, m_part, row * gridDim.x + blockIdx.x);
}

inline int halo_blocks(const BandGeom& g, bool square) {
  const int n = square ? g.hl * (g.w.L[1] >> 1) : g.hl * g.block;
  const int groups = (n + kSitesPerThread - 1) / kSitesPerThread;
  return (groups + kThreads - 1) / kThreads;
}

}  // namespace

extern "C" {

// Blocks per system of a sweep_halo pass (square: the colour sites, else
// the sites of the band) and of measure_halo (square = 0): the partials'
// row length.
int peapods_halo_blocks(const int* geom, int square) {
  return halo_blocks(make_band_geom(geom), square != 0);
}

// One colour pass of every (realization, system) over a band.  spins int8
// [d, n_systems, n_window]; coup_fwd / coup_bwd f32 [d, n_window, n_nb];
// colours uint8 [n_window] (unread on the square lattice); sys_temps f32
// [d, n_systems]; words int32 [d, 2]; e_part f32 / m_part int32 [d,
// n_systems, peapods_halo_blocks(geom, square)] or both null.
int peapods_sweep_halo(void* spins, const void* coup_fwd, const void* coup_bwd,
                       const void* colours, const void* sys_temps, const void* words,
                       void* e_part, void* m_part, const int* geom, int n_disorder,
                       int n_systems, int colour, int gibbs, int square,
                       void* stream) {
  const BandWalk g = make_band_walk(geom);
  const int n_blk = halo_blocks(g, square != 0);
  // systems a CTA: as many as leave about kHaloCtas CTAs a launch
  const int want = (kHaloCtas + n_blk * n_disorder - 1) / (n_blk * n_disorder);
  const int groups = min(n_systems, max(1, want));
  const int per = (n_systems + groups - 1) / groups;
  const dim3 grid(n_blk, (n_systems + per - 1) / per, n_disorder);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<int8_t*>(spins), static_cast<const float*>(coup_fwd),
        static_cast<const float*>(coup_bwd), static_cast<const uint8_t*>(colours),
        static_cast<const float*>(sys_temps), static_cast<const int32_t*>(words),
        static_cast<float*>(e_part), static_cast<int32_t*>(m_part), g, n_systems, per,
        colour, gibbs);
  };
  switch (square ? 0 : g.w.n_nb) {
    case 0: go(sweep_halo_kernel<0>); break;
    case 1: go(sweep_halo_kernel<1>); break;
    case 2: go(sweep_halo_kernel<2>); break;
    case 3: go(sweep_halo_kernel<3>); break;
    case 4: go(sweep_halo_kernel<4>); break;
    case 5: go(sweep_halo_kernel<5>); break;
    default: go(sweep_halo_kernel<6>); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// e_part f32 / m_part int32 [d, n_systems, peapods_halo_blocks(geom, 0)].
int peapods_measure_halo(const void* spins, const void* coup_fwd, const int* geom,
                         void* e_part, void* m_part, int n_disorder, int n_systems,
                         void* stream) {
  const BandWalk g = make_band_walk(geom);
  const dim3 grid(halo_blocks(g, false), n_systems, n_disorder);
  measure_halo_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(coup_fwd), g,
      static_cast<float*>(e_part), static_cast<int32_t*>(m_part), n_systems);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
