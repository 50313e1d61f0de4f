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
//   and three forward coupling planes; the field adds the six terms in the
//   order x-, x+, y-, y+, z-, z+ (pallas_megapair._mp_body), a 2D one's
//   up, down, left, right, each from 0 as ops/sweep.py local_field does.
// * Group g of a colour pass is the active-colour sites 4g .. 4g+3 in
//   row-major order (2D: row i / (W/2), column 2 (i % (W/2)) + ((row +
//   colour) & 1); 3D the same along z), and draws their four uniforms from
//   one Philox4x32-10 call with key = the sweep's two key words and counter
//   = (slot, colour, g, 0).  No thread sits on the inactive parity.
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
// What bounds colour_pass on the H100, and its design: a pass reads every
// spin (the neighbours), each realization's forward couplings once and
// writes the active spins: 0.00164 ms at config 5 (16^3, 96 slots, 8
// realizations), 0.00021 at config 4 (8^3) (3.35 TB/s).  Its first design
// gave a CTA a block of 256 groups of one slot, read the realization's six
// pre-shifted coupling grids again for every slot (24 B a site in 3D),
// divided twice a site, loaded spins a byte at a time, reduced its
// partials through a block-wide tree with a barrier a level and, at 8^3
// (64 groups a slot), left three quarters of every CTA idle: 0.0190 and
// 0.0067 ms a pass (NVIDIA H100 80GB HBM3, 700 W).  Now a thread takes a
// group of `per` slots of one realization (ops/mega.py colour_plan), the
// group's couplings staged once in shared memory from the forward planes,
// its coordinates by a multiply-shift division, its spins 8-byte words
// where the fast axis is a multiple of 8, one warp a slot's partial in
// block_partials' pairing, and a lattice of 128 groups a slot or fewer has
// several slots side by side in a CTA (tools/probe_colour_cc.py times both
// designs).  mega_resident.cu lifts the launch's bound for the mega path:
// a whole chunk in one launch, each lattice held in a cluster's shared
// memory.  colour_pass carries the replica path and the mega path's shapes
// that its rule (ops/mega.py resident_plan) refuses.
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

constexpr int kMaxPer = 8;       // slots a CTA: the measuring launch's shared rows
constexpr int kColourBlocks = 4;  // CTAs an SM colour_pass is built for (64 registers)

// colour_pass's layout (ops/mega.py colour_plan): a CTA takes `per` slots of
// one realization and gp groups (a power of two, 32 to kThreads) of one
// logical block of kThreads groups, its threads gp x sub: thread t takes
// group t % gp of slots t / gp, + sub, ... (sub = min(kThreads / gp, per)).
// A lattice of fewer than kThreads / 2 groups a slot thus fills its CTAs
// with several slots side by side.  The division-free steps: (m, s) of the
// active sites' row length, W / 2 (2D), or of L1 L2 / 2 and L2 / 2 (3D).
struct ColourWalk {
  int L[3];
  int per;
  int gp;
  int gshift;  // log2(gp)
  int sub;
  uint32_t div_m[2];
  int div_s[2];
};

// One colour pass of group g (active sites 4g .. 4g+3: row-major order of
// the colour's sites, as ops/rng.colour_uniforms numbers them) of slots
// blockIdx.y per .. + per - 1 of realization blockIdx.z, on a 2D [H, W]
// (k3 false) or 3D [L0, L1, L2] lattice.  The group's couplings are read
// once, from the forward planes of jgrids (2D J0 = jd, J1 = jr; 3D Jx, Jy,
// Jz: planes 1, 3, 5), each backward bond as the neighbour's forward one
// (bitwise the pre-shifted planes, ops/sweep.py pack_coupling_grids), into
// shared memory, where each of the CTA's slots reads them.  The vector path
// (vec: L_fast % 8 == 0, aligned tensors) takes eight columns of one row:
// its spins one 8-byte word of each neighbouring row and one edge byte, its
// couplings 16-byte loads, its flips one 8-byte store; any other width
// takes the per-site path, a step from site to site.  The measuring launch
// stages each slot's thread sums in shared memory and reduces each with one
// warp in block_partials' pairing.  One kernel each for 2D and 3D, for the
// measuring pass and not, and for each path (no register spent on the
// other).
template <bool k3, bool kMeasure, bool kVec>
__global__ void __launch_bounds__(kThreads, kColourBlocks)
colour_pass_kernel(int8_t* __restrict__ spins, const float* __restrict__ jgrids,
                   const int32_t* __restrict__ sid, const float* __restrict__ temps,
                   const int32_t* __restrict__ words, float* __restrict__ e_part,
                   int32_t* __restrict__ m_part, const ColourWalk g, int n_slots,
                   int colour, int gibbs) {
  // per site: 2D (ju, jd, jl, jr); 3D (x-, x+, y-, y+) and cz (z-, z+)
  __shared__ float4 cj[kSitesPerThread][kThreads];
  __shared__ float2 cz[k3 ? kSitesPerThread : 1][k3 ? kThreads : 1];
  __shared__ float se[kMeasure ? kMaxPer : 1][kThreads];
  __shared__ int sm[kMeasure ? kMaxPer : 1][kThreads];
  const int dz = blockIdx.z;
  const int slot0 = blockIdx.y * g.per;
  const int gl = threadIdx.x & (g.gp - 1);
  const int lane_slot = threadIdx.x >> g.gshift;
  const int L0 = g.L[0], L1 = g.L[1], L2 = g.L[2];
  const int W = k3 ? L2 : L1;  // the fast axis
  const int n = L0 * L1 * L2;
  const int n_half = n >> 1;
  const int wh = W >> 1;
  const int grp = blockIdx.x * kThreads + gl;
  const int i0 = kSitesPerThread * grp;
  const bool has = i0 < n_half;
  const float* J = jgrids + static_cast<size_t>(dz) * (k3 ? 6 : 4) * n;
  const float* Ja = J + n;                   // J0 (2D), Jx (3D)
  const float* Jb = J + 3 * static_cast<size_t>(n);  // J1 (2D), Jy (3D)
  const float* Jc = J + 5 * static_cast<size_t>(n);  // Jz (3D)
  // the group's first site: row r0 (2D) or (x0, y0) (3D), column pair j0
  int x0 = 0, r0 = 0, j0 = 0;
  if (has) {
    if (k3) {
      x0 = fast_div(i0, g.div_m[0], g.div_s[0]);
      const int rem = i0 - x0 * (L1 * wh);
      r0 = fast_div(rem, g.div_m[1], g.div_s[1]);
      j0 = rem - r0 * wh;
    } else {
      r0 = fast_div(i0, g.div_m[0], g.div_s[0]);
      j0 = i0 - r0 * wh;
    }
  }
  // the rows a (3D: the row (x0, r0) along z; 2D: row r0) and its neighbours
  const int R = k3 ? L1 : L0;  // rows a plane (3D) or the lattice (2D)
  const int rm = r0 == 0 ? R - 1 : r0 - 1;
  const int rp = r0 == R - 1 ? 0 : r0 + 1;
  const int xm = x0 == 0 ? L0 - 1 : x0 - 1;
  const int xp = x0 == L0 - 1 ? 0 : x0 + 1;
  const int a = ((k3 ? x0 : 0) + r0 + colour) & 1;
  const int c0 = 2 * j0;
  const int plane = k3 ? L1 * L2 : 0;
  const int rw = (k3 ? x0 * plane : 0) + r0 * W + c0;  // the group's row word
  const int mw = (k3 ? x0 * plane : 0) + rm * W + c0;  // row r0 - 1
  const int pw = (k3 ? x0 * plane : 0) + rp * W + c0;  // row r0 + 1
  const int xmw = xm * plane + r0 * W + c0;            // 3D: plane x0 - 1
  const int xpw = xp * plane + r0 * W + c0;            // 3D: plane x0 + 1
  // the edge column: left of c0 (a = 0) or right of c0 + 7 (a = 1)
  const int edge = rw - c0 + (a ? (c0 + 8 == W ? 0 : c0 + 8) : (c0 == 0 ? W - 1 : c0 - 1));
  if (lane_slot == 0 && has) {
    if (kVec) {
      // plane by plane, eight columns of a row: column a + 2k (active site
      // k) and the one before it, picked with compile-time indices (k
      // unrolled; a runtime index would put the row in local memory) and
      // stored to the site's float4 / float2 component by component
      float* cjf = &cj[0][0].x;
      float* czf = &cz[0][0].x;
      const auto stage = [&](const float* p, float* dst, int stride, int comp, int prev,
                             float first) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
        const float r[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k) {
          const float own = a ? r[2 * k + 1] : r[2 * k];
          const float before = k == 0 ? first : (a ? r[2 * k] : r[k > 0 ? 2 * k - 1 : 0]);
          dst[(k * kThreads + gl) * stride + comp] = prev ? before : own;
        }
      };
      if (k3) {
        stage(Ja + xmw, cjf, 4, 0, 0, 0.0f);  // Jx of plane x - 1
        stage(Ja + rw, cjf, 4, 1, 0, 0.0f);   // Jx, own
        stage(Jb + mw, cjf, 4, 2, 0, 0.0f);   // Jy of row y - 1
        stage(Jb + rw, cjf, 4, 3, 0, 0.0f);   // Jy, own
        const float zl0 = a ? Jc[rw] : __ldg(Jc + edge);
        stage(Jc + rw, czf, 2, 0, 1, zl0);    // Jz of the column before
        stage(Jc + rw, czf, 2, 1, 0, 0.0f);   // Jz, own
      } else {
        stage(Ja + mw, cjf, 4, 0, 0, 0.0f);   // J0 of row r - 1 (ju)
        stage(Ja + rw, cjf, 4, 1, 0, 0.0f);   // J0, own (jd)
        const float jl0 = a ? Jb[rw] : __ldg(Jb + edge);
        stage(Jb + rw, cjf, 4, 2, 1, jl0);    // J1 of the column before (jl)
        stage(Jb + rw, cjf, 4, 3, 0, 0.0f);   // J1, own (jr)
      }
    } else {
      int x = x0, r = r0, j = j0;
#pragma unroll
      for (int k = 0; k < kSitesPerThread; ++k) {
        if (i0 + k < n_half) {
          const int base = (k3 ? x * plane : 0) + r * W;
          const int col = 2 * j + (((k3 ? x : 0) + r + colour) & 1);
          const int idx = base + col;
          const int up = (k3 ? x * plane : 0) + (r == 0 ? R - 1 : r - 1) * W + col;
          const int lf = col == 0 ? idx + W - 1 : idx - 1;
          if (k3) {
            const int bx = (x == 0 ? L0 - 1 : x - 1) * plane + r * W + col;
            cj[k][gl] = make_float4(__ldg(Ja + bx), __ldg(Ja + idx), __ldg(Jb + up),
                                    __ldg(Jb + idx));
            cz[k][gl] = make_float2(__ldg(Jc + lf), __ldg(Jc + idx));
          } else {
            cj[k][gl] = make_float4(__ldg(Ja + up), __ldg(Ja + idx), __ldg(Jb + lf),
                                    __ldg(Jb + idx));
          }
        }
        if (++j == wh) {
          j = 0;
          if (++r == R) {
            r = 0;
            ++x;
          }
        }
      }
    }
  }
  if (g.sub > 1) __syncthreads();  // uniform: the staged couplings serve every slot lane
  const uint32_t k0 = static_cast<uint32_t>(words[2 * dz]);
  const uint32_t k1 = static_cast<uint32_t>(words[2 * dz + 1]);
  for (int q = lane_slot; q < g.per; q += g.sub) {
    const int slot = slot0 + q;
    const int sys = sid[dz * n_slots + slot];
    float e_acc = 0.0f;
    int m_acc = 0;
    if (has) {
      int8_t* s = spins + (static_cast<size_t>(dz) * n_slots + sys) * n;
      const float inv_half_t = 1.0f / (0.5f * temps[slot]);
      const uint4 r4 = philox4x32_10(k0, k1, static_cast<uint32_t>(slot),
                                     static_cast<uint32_t>(colour), static_cast<uint32_t>(grp),
                                     0u);
      const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};
      if (kVec) {
        const auto word = [&](int at) {
          const uint2 v = *reinterpret_cast<const uint2*>(s + at);
          return (static_cast<uint64_t>(v.y) << 32) | v.x;
        };
        const uint64_t w = word(rw);
        const uint64_t eb = static_cast<uint8_t>(s[edge]);
        // shifted so that active site k is byte 2k, its +1 neighbour along
        // the row byte 2k + 1 and (k > 0) its -1 neighbour byte 2k - 1
        const uint64_t xw = a ? (w >> 8) | (eb << 56) : w;
        const uint64_t wm = word(mw) >> (8 * a);
        const uint64_t wp = word(pw) >> (8 * a);
        const uint64_t wxm = k3 ? word(xmw) >> (8 * a) : 0;
        const uint64_t wxp = k3 ? word(xpw) >> (8 * a) : 0;
        const float left0 = a ? spin_at(w, 0) : static_cast<float>(static_cast<int8_t>(eb));
        uint64_t out = w;  // the row's eight bytes after the pass
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k) {
          const float4 jc = cj[k][gl];
          const float sl = k == 0 ? left0 : spin_at(xw, 2 * k - 1);
          const float sr = spin_at(xw, 2 * k + 1);
          float field;
          if (k3) {
            const float2 jz = cz[k][gl];
            field = spin_at(wxm, 2 * k) * jc.x + spin_at(wxp, 2 * k) * jc.y;
            field = field + spin_at(wm, 2 * k) * jc.z;
            field = field + spin_at(wp, 2 * k) * jc.w;
            field = field + sl * jz.x;
            field = field + sr * jz.y;
          } else {
            field = spin_at(wm, 2 * k) * jc.x + spin_at(wp, 2 * k) * jc.y;
            field = field + sl * jc.z;
            field = field + sr * jc.w;
          }
          float sv = spin_at(xw, 2 * k);
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
      } else {
        int x = x0, r = r0, j = j0;
#pragma unroll
        for (int k = 0; k < kSitesPerThread; ++k) {
          if (i0 + k >= n_half) break;
          const int pb = k3 ? x * plane : 0;
          const int col = 2 * j + (((k3 ? x : 0) + r + colour) & 1);
          const int idx = pb + r * W + col;
          const float4 jc = cj[k][gl];
          const float sm1 = static_cast<float>(s[pb + (r == 0 ? R - 1 : r - 1) * W + col]);
          const float sp1 = static_cast<float>(s[pb + (r == R - 1 ? 0 : r + 1) * W + col]);
          const float sl = static_cast<float>(s[col == 0 ? idx + W - 1 : idx - 1]);
          const float sr = static_cast<float>(s[col == W - 1 ? idx + 1 - W : idx + 1]);
          float field;
          if (k3) {
            const float2 jz = cz[k][gl];
            const int rc = r * W + col;
            field = static_cast<float>(s[(x == 0 ? L0 - 1 : x - 1) * plane + rc]) * jc.x +
                    static_cast<float>(s[(x == L0 - 1 ? 0 : x + 1) * plane + rc]) * jc.y;
            field = field + sm1 * jc.z;
            field = field + sp1 * jc.w;
            field = field + sl * jz.x;
            field = field + sr * jz.y;
          } else {
            field = sm1 * jc.x + sp1 * jc.y;
            field = field + sl * jc.z;
            field = field + sr * jc.w;
          }
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
            if (++r == R) {
              r = 0;
              ++x;
            }
          }
        }
      }
    }
    if (kMeasure) {
      se[q][gl] = e_acc;
      sm[q][gl] = m_acc;
    }
  }
  if (!kMeasure) return;
  __syncthreads();
  // warp v reduces slots v, v + warps, ... of the CTA: its gp groups, the
  // logical block's other threads 0
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < g.per; q += blockDim.x >> 5) {
    const float et = warp_tree_prefix(se[q], lane, g.gp);
    const int mt = warp_tree_prefix(sm[q], lane, g.gp);
    if (lane == 0) {
      const int sys = sid[dz * n_slots + slot0 + q];
      const size_t o = (static_cast<size_t>(dz) * n_slots + sys) * gridDim.x + blockIdx.x;
      e_part[o] = et;
      m_part[o] = mt;
    }
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
// or 3D [L0, L1, L2] lattice (even extents), jgrids [d, 4 or 6, n] (only
// the forward planes 1, 3, 5 are read: the grids of
// ops/sweep.py pack_coupling_grids).  e_part / m_part are [d, n_slots,
// blocks] (both null for a pass that does not measure).  plan: host words
// per, gp, then (m, s) of W / 2 (2D) or of L1 L2 / 2 and L2 / 2 (3D)
// (ops/mega.py colour_plan).
int peapods_colour_pass(void* spins, const void* jgrids, const void* sid,
                        const void* temps, const void* words, void* e_part,
                        void* m_part, int n_disorder, int n_slots, int L0, int L1,
                        int L2, int colour, int gibbs, const int* plan, void* stream) {
  ColourWalk g;
  g.L[0] = L0;
  g.L[1] = L1;
  g.L[2] = L2;
  g.per = plan[0];
  g.gp = plan[1];
  g.gshift = 0;
  while ((1 << g.gshift) < g.gp) ++g.gshift;
  g.sub = kThreads / g.gp < g.per ? kThreads / g.gp : g.per;
  for (int k = 0; k < 2; ++k) {
    g.div_m[k] = static_cast<uint32_t>(plan[2 + 2 * k]);
    g.div_s[k] = plan[3 + 2 * k];
  }
  const bool k3 = L2 > 1;
  const int W = k3 ? L2 : L1;
  const long long n = static_cast<long long>(L0) * L1 * L2;
  // a 3D lattice's active sites are those of an [L0 L1, L2] grid
  const int blocks = k3 ? colour_pass_blocks(L0 * L1, L2) : colour_pass_blocks(L0, L1);
  const int groups = static_cast<int>((n / 2 + kSitesPerThread - 1) / kSitesPerThread);
  if (n_disorder < 1 || n_disorder > 65535 || n_slots < 1 || g.per < 1 || g.per > kMaxPer ||
      n_slots % g.per || n_slots / g.per > 65535 || g.gp < 32 || g.gp > kThreads ||
      (1 << g.gshift) != g.gp || (g.gp < kThreads && groups > g.gp) || L0 < 2 || L1 < 2 ||
      L0 % 2 || L1 % 2 || (k3 && L2 % 2) || n > (1LL << 31) - 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto at = [](const void* p, unsigned al) {
    return reinterpret_cast<uintptr_t>(p) % al == 0;
  };
  const bool vec = W % 8 == 0 && at(spins, 8) && at(jgrids, 16);
  const dim3 grid(blocks, n_slots / g.per, n_disorder);
  const int threads = g.gp * g.sub;
  using Kernel = void (*)(int8_t*, const float*, const int32_t*, const float*, const int32_t*,
                          float*, int32_t*, const ColourWalk, int, int, int);
  const Kernel kernels[2][2][2] = {
      {{colour_pass_kernel<false, false, false>, colour_pass_kernel<false, false, true>},
       {colour_pass_kernel<false, true, false>, colour_pass_kernel<false, true, true>}},
      {{colour_pass_kernel<true, false, false>, colour_pass_kernel<true, false, true>},
       {colour_pass_kernel<true, true, false>, colour_pass_kernel<true, true, true>}}};
  kernels[k3][e_part != nullptr][vec]<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const float*>(jgrids),
      static_cast<const int32_t*>(sid), static_cast<const float*>(temps),
      static_cast<const int32_t*>(words), static_cast<float*>(e_part),
      static_cast<int32_t*>(m_part), g, n_slots, colour, gibbs);
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
