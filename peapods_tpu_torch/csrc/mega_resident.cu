// Hopper kernel of the mega path: a whole chunk of sweeps -- both colour
// passes, the measurement and the parallel-tempering event of every sweep
// -- in one launch, each system's lattice held in the shared memory of a
// thread-block cluster for the whole chunk.
//
// Replaces the TPU megakernel peapods_tpu/ops/pallas_mega.py:_mega_kernel
// (:96, entry mega_chunk :302), which runs n_inner sweeps, measurement and
// PT in one call with every slot's spins in VMEM.  mega.cu computes the
// same chunk in three launches a sweep (colour_pass twice, pt_step); this
// kernel gives the same numbers bit for bit:
//
// * Uniforms: Philox4x32-10 keyed by the sweep's words, counter (slot,
//   colour, g, 0), word k for colour site 4 g + k (colour_pass's).
// * Arithmetic: mega.cu colour_pass's field (up, down, left, right in that
//   order; s J as J with its sign flipped, which is exact), expf and
//   sigmoid forms; -fmad=false.
// * Partials: one per logical block of kThreads x 4 colour sites, the sum of
//   kThreads per-logical-thread sums (4 sites in k order) paired as
//   block_partials pairs them (warp_tree); a system's row of partials adds
//   in pt_step's order (share_sum) and PT runs through try_edge (mega.cuh).
//
// Layout: cluster x of the grid is system x % n_systems of realization
// x / n_systems; its C CTAs hold H / C rows each (rank q: rows q R .. q R +
// R - 1), so that a CTA's colour sites are whole logical blocks (the rule
// ops/mega.py resident_plan checks).  A CTA's shared memory holds its rows'
// int8 spins with a halo row on either side, the down and right couplings
// of its rows split by colour (jgrids are pre-shifted: up[r][c] =
// down[r-1][c], left[r][c] = right[r][c-1], so two grids give all four
// values and fit beside the spins), a pass's Philox blocks and one (e, m)
// sum per logical thread and, in rank 0, the system's row of partials.  A
// thread updates 4 colour sites from three 8-byte words (the rows above,
// below and its own) and one edge byte, their couplings from 16-byte
// loads; a changed word of a CTA's first or last row is also stored into
// the halo of the CTA above or below (distributed shared memory), so every
// load of a pass is local.
//
// A sweep: colour 0; cluster barrier; colour 1 measuring; each CTA's block
// partials into rank 0's row (distributed shared memory); cluster barrier;
// rank 0 sums the row and writes the slot's (e, m).  Between the two halves
// of each barrier (arrive, wait) a thread draws the Philox blocks of its
// next pass, which hides the wait for the cluster's slowest CTA.  A PT
// event needs no barrier across the grid: rank 0 of every cluster
// publishes its system's sum as a 64-bit word tagged with the event's
// index, and every CTA runs the event itself on its own copy of the PT
// state, with the same sums, draws and order, so the copies stay equal.  A
// full-ladder event waits for every system's sum.  A single-edge event
// concerns only the two clusters at its edge: they first apply the
// outcomes of the events they missed (published, tagged, by those events'
// clusters), wait for each other's sum, run try_edge and publish the
// outcome; the other clusters go on without waiting.  The realization's
// first CTA applies every outcome and writes the PT state back.
//
// All clusters must be resident at once, or a wait never ends: the launch
// is cooperative, the entry point refuses a grid larger than
// cudaOccupancyMaxActiveClusters allows, and the wrapper's rule never asks
// for one.
//
// What bounds it on the H100: not bytes (a chunk reads and writes each
// spin and coupling once), but operations: about 42 a colour site (a
// quarter of a Philox block, one expf, the field, the test), 786,432 sites
// a pass at the flagship, 0.26 ms a chunk of 256 sweeps at 67e12 a second
// (chip_smoke.py resident_bound).  Its passes run on 96 of the 132 SMs
// (24 systems x 4 CTAs, one CTA an SM) with two cluster barriers a sweep.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

namespace cg = cooperative_groups;
using namespace peapods;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBlockSites = kThreads * kSitesPerThread;  // colour sites a logical block

struct Layout {  // byte offsets into a CTA's dynamic shared memory
  int sp, jd, jr, draws, part, row, pt, total;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// spins: the row above, the rows, the row below [R + 2, W] int8 (the rows
// 16-byte aligned) | down couplings [2][R + 1][W / 2] (row -1 first) |
// right couplings [2][R][W / 2] | a pass's Philox blocks, one per logical
// thread | e, m per logical thread | the row's (e, m) | PT state: es,
// sums, temps [n_slots] f32, sid, rtrips, tstate [n_slots], ea, ec
// [n_slots - 1] | the sweep's PT draws: edge, u [2 (n_slots - 1)]
__host__ __device__ inline Layout layout(int H, int W, int C, int n_slots) {
  const int R = H / C, wh = W / 2;
  Layout l;
  l.sp = round16(W);
  l.jd = round16(l.sp + (R + 1) * W);
  l.jr = l.jd + round16(8 * (R + 1) * wh);
  l.draws = l.jr + round16(8 * R * wh);
  l.part = l.draws + round16(16 * (R * wh / kSitesPerThread));
  l.row = l.part + round16(8 * (R * wh / kSitesPerThread));
  l.pt = l.row + round16(8 * (H * wh / kBlockSites));
  l.total = l.pt + round16(4 * (6 * n_slots + 4 * (n_slots - 1) + 1));
  return l;
}

struct Args {
  int8_t* spins;             // [d, n_slots, H, W] by system
  const float* jgrids;       // [d, 4, H, W] pre-shifted (ju, jd, jl, jr)
  const float* temps;        // [n_slots]
  int32_t* sid;              // [d, n_slots]
  int32_t* ea;               // [d, n_slots - 1]
  int32_t* ec;               // [d, n_slots - 1]
  int32_t* rtrips;           // [d, n_slots]
  int32_t* tstate;           // [d, n_slots]
  const int32_t* words;      // [n, d, 2]
  const int32_t* edge_draw;  // [n, d] (single edge)
  const float* u_draw;       // [n, d] single edge, [n, d, 2, n_slots - 1] full
  float* e_out;              // [d, n, n_slots]
  int32_t* m_out;            // [d, n, n_slots]
  uint64_t* sums;            // [n_events, d, n_slots] the systems' tagged sums
  uint64_t* flags;           // [n_events, d] tagged single-edge outcomes; both all
                             // ones before the launch
  int n_disorder, n_slots, H, W, n, sweep_base, pt_interval, pt_full, parity,
      gibbs, hot, cold;
};

// A system's sum at a PT event (f32 bits), or a single-edge event's outcome
// (1: accepted), in the low word of a 64-bit word whose high word is the
// event's index: written and read whole.
__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

// 4 bytes from global to shared memory without a register (cp.async); the
// thread waits for its copies with copies_wait.
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" : :
               "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" : : : "memory");
}

__device__ __forceinline__ void copies_wait() { asm volatile("cp.async.wait_all;" : : : "memory"); }

// The two halves of cluster.sync(): work between them overlaps the wait
// for the cluster's slowest CTA.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" : : : "memory");
}

// The Philox blocks of one colour pass of the CTA's groups, stored by the
// thread that will use them (counter (slot, colour, g, 0), g = r0 W / 8 +
// gl): drawn while the thread waits at a cluster barrier.
__device__ __forceinline__ void draw_pass(uint4* draws, int groups, int g0, int colour,
                                          int slot, uint32_t k0, uint32_t k1) {
  for (int gl = threadIdx.x; gl < groups; gl += blockDim.x)
    draws[gl] = philox4x32_10(k0, k1, static_cast<uint32_t>(slot),
                              static_cast<uint32_t>(colour), static_cast<uint32_t>(g0 + gl),
                              0u);
}

// The sign bit of spin byte b (+1 or -1) of w, at bit 31: s x f is f with
// that bit flipped, exactly, so no spin is converted to float.
__device__ __forceinline__ uint32_t sign_of(uint64_t w, int b) {
  const uint32_t h = static_cast<uint32_t>(b >= 4 ? w >> 32 : w);
  return (h << (24 - 8 * (b & 3))) & 0x80000000u;
}

__device__ __forceinline__ float times(float f, uint32_t sign) {
  return __uint_as_float(__float_as_uint(f) ^ sign);
}

// The update of one thread's 4 colour sites, bytes 2k + P of the 8-byte
// words wo (own row), wu, wd (the rows above and below); edge: the sign of
// the neighbour outside the word (left of site 0 for P = 0, right of site 3
// for P = 1); cu, cd, cr, cl: the up, down, right and left couplings.  The
// arithmetic of mega.cu colour_pass (s x J as a sign flip, exact).
// Returns the updated own word and adds s h of the sites to e_acc.
template <bool kMeasure, int P>
__device__ __forceinline__ uint64_t sites4(uint64_t wo, uint64_t wu, uint64_t wd,
                                           uint32_t edge, float4 cu, float4 cd, float4 cr,
                                           const float* cl, uint4 r4, float inv_half_t,
                                           int gibbs, float& e_acc) {
  const float ju[4] = {cu.x, cu.y, cu.z, cu.w};
  const float jdn[4] = {cd.x, cd.y, cd.z, cd.w};
  const float jrt[4] = {cr.x, cr.y, cr.z, cr.w};
  const uint32_t w4[4] = {r4.x, r4.y, r4.z, r4.w};
  uint64_t wn = wo;
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int b = 2 * k + P;  // the site's byte in the words
    const uint32_t s_l = b == 0 ? edge : sign_of(wo, b == 0 ? 0 : b - 1);
    const uint32_t s_r = b == 7 ? edge : sign_of(wo, b == 7 ? 7 : b + 1);
    float field = times(ju[k], sign_of(wu, b)) + times(jdn[k], sign_of(wd, b));
    field = field + times(cl[k], s_l);
    field = field + times(jrt[k], s_r);
    uint32_t sv = sign_of(wo, b);
    const float x = times(field, sv ^ 0x80000000u) * inv_half_t;  // (-s h) / (T / 2)
    const float pr = gibbs ? 1.0f / (1.0f + expf(-x)) : kKeep * expf(fminf(x, 0.0f));
    if (uniform24(w4[k]) < pr) {
      sv ^= 0x80000000u;
      wn ^= static_cast<uint64_t>(0xfe) << (8 * b);  // 0x01 <-> 0xff
    }
    if (kMeasure) e_acc += times(field, sv);
  }
  return wn;
}

// One colour pass over the CTA's rows: logical thread gl (the CTA's gl-th
// group of 4 colour sites, group g = r0 W / 8 + gl of the system, its
// Philox block draws[gl]) is run by thread gl % blockDim.x.  Row rl's colour sites start at column p = (r0 +
// rl + colour) & 1; group j0 / 4 of the row holds columns 2 j0 + p + 2k,
// inside the 8-byte word at column 2 j0.  The rows above and below the
// CTA's are its halo rows; a changed word of its first (last) row is also
// stored into the halo of the CTA above (below), push_up (push_dn), which
// the next cluster barrier makes visible.
template <bool kMeasure>
__device__ __forceinline__ void pass(int8_t* sp, const float* jd, const float* jr,
                                     int8_t* push_up, int8_t* push_dn, int R, int W,
                                     int r0, int colour, const uint4* draws,
                                     float inv_half_t, int gibbs, float* part_e,
                                     int* part_m) {
  const int wh = W >> 1;
  const int per_row = wh / kSitesPerThread;
  const int groups = R * per_row;
  int rl = threadIdx.x / per_row, jq = threadIdx.x - rl * per_row;
  const int drl = blockDim.x / per_row, djq = blockDim.x - drl * per_row;
  for (int gl = threadIdx.x; gl < groups; gl += blockDim.x) {
    const int j0 = kSitesPerThread * jq;
    const int p = (r0 + rl + colour) & 1;
    const int base = 2 * j0;
    const uint4 r4 = draws[gl];
    int8_t* own = sp + rl * W + base;
    const uint64_t wo = *reinterpret_cast<const uint64_t*>(own);
    const uint64_t wu = *reinterpret_cast<const uint64_t*>(own - W);
    const uint64_t wd = *reinterpret_cast<const uint64_t*>(own + W);
    const uint32_t edge = (static_cast<uint32_t>(static_cast<uint8_t>(
                               p ? sp[rl * W + (base + 8 == W ? 0 : base + 8)]
                                 : sp[rl * W + (base == 0 ? W - 1 : base - 1)])) &
                           0x80u) << 24;
    const float4 cu = *reinterpret_cast<const float4*>(jd + ((1 - colour) * (R + 1) + rl) * wh + j0);
    const float4 cd = *reinterpret_cast<const float4*>(jd + (colour * (R + 1) + rl + 1) * wh + j0);
    const float4 cr = *reinterpret_cast<const float4*>(jr + (colour * R + rl) * wh + j0);
    const float* lrow = jr + ((1 - colour) * R + rl) * wh;
    const float4 l4 = *reinterpret_cast<const float4*>(lrow + j0);
    float e_acc = 0.0f;
    uint64_t wn;
    if (p) {
      const float cl[4] = {l4.x, l4.y, l4.z, l4.w};
      wn = sites4<kMeasure, 1>(wo, wu, wd, edge, cu, cd, cr, cl, r4, inv_half_t, gibbs,
                               e_acc);
    } else {  // the left bond of column 2 j belongs to column 2 j - 1
      const float cl[4] = {lrow[j0 == 0 ? wh - 1 : j0 - 1], l4.x, l4.y, l4.z};
      wn = sites4<kMeasure, 0>(wo, wu, wd, edge, cu, cd, cr, cl, r4, inv_half_t, gibbs,
                               e_acc);
    }
    if (wn != wo) {
      *reinterpret_cast<uint64_t*>(own) = wn;
      if (rl == 0) *reinterpret_cast<uint64_t*>(push_up + base) = wn;
      if (rl == R - 1) *reinterpret_cast<uint64_t*>(push_dn + base) = wn;
    }
    if (kMeasure) {  // s of the 8 sites of the word: 8 - 2 (its -1 bytes)
      part_e[gl] = e_acc;
      part_m[gl] = 8 - 2 * (__popc(static_cast<uint32_t>(wn) & 0x80808080u) +
                            __popc(static_cast<uint32_t>(wn >> 32) & 0x80808080u));
    }
    rl += drl;
    jq += djq;
    if (jq >= per_row) {
      jq -= per_row;
      ++rl;
    }
  }
}

// Applies single-edge events done .. upto - 1 to the PT state st of this
// CTA from their outcomes, which the events' two clusters publish (warp 0,
// all lanes; a lane reads an event's outcome and edge, lane 0 applies them
// in order).
__device__ __forceinline__ void catch_up(const Args& a, PtState& st, int d, int first_pt,
                                         int lane, int& done, int upto) {
  while (done < upto) {
    const int j = done + lane;
    uint32_t acc = 0;
    int e = 0;
    if (j < upto) {
      const uint64_t* fp = a.flags + static_cast<size_t>(j) * a.n_disorder + d;
      uint64_t f = ld_acquire(fp);
      while (static_cast<int>(f >> 32) != j) f = ld_acquire(fp);
      acc = static_cast<uint32_t>(f);
      e = a.edge_draw[static_cast<size_t>(first_pt + j * a.pt_interval) * a.n_disorder + d];
    }
    const int m = min(32, upto - done);
    for (int i = 0; i < m; ++i) {
      const uint32_t ai = __shfl_sync(0xffffffffu, acc, i);
      const int ei = __shfl_sync(0xffffffffu, e, i);
      if (lane == 0) {
        st.ea[ei] += 1;
        if (ai) {
          st.ec[ei] += 1;
          swap_edge(st, ei);
        }
      }
    }
    __syncwarp();
    done += m;
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1) mega_resident_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / C;
  const int d = cl / a.n_slots;
  const int sys = cl - d * a.n_slots;
  const int H = a.H, W = a.W, wh = W >> 1;
  const int R = H / C, r0 = rank * R;
  const int n_slots = a.n_slots, n_edges = n_slots - 1;
  const int n_spins = H * W;
  const int groups = R * wh / kSitesPerThread;
  const int nblk = groups / kThreads;  // logical blocks a CTA
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(H, W, C, n_slots);
  int8_t* sp = reinterpret_cast<int8_t*>(smem + lay.sp);
  float* jd = reinterpret_cast<float*>(smem + lay.jd);
  float* jr = reinterpret_cast<float*>(smem + lay.jr);
  uint4* draws = reinterpret_cast<uint4*>(smem + lay.draws);
  float* part_e = reinterpret_cast<float*>(smem + lay.part);
  int* part_m = reinterpret_cast<int*>(part_e + groups);
  float* row_e = reinterpret_cast<float*>(smem + lay.row);
  int* row_m = reinterpret_cast<int*>(row_e + C * nblk);
  float* es = reinterpret_cast<float*>(smem + lay.pt);
  float* sums = es + n_slots;
  float* stemp = sums + n_slots;
  int32_t* ssid = reinterpret_cast<int32_t*>(stemp + n_slots);
  int32_t* srt = ssid + n_slots;
  int32_t* sts = srt + n_slots;
  int32_t* sea = sts + n_slots;
  int32_t* sec = sea + n_edges;
  int32_t* sedge = sec + n_edges;
  float* su = reinterpret_cast<float*>(sedge + 1);

  // stage the rows' spins, their couplings by colour and the PT state
  const size_t sys_off = (static_cast<size_t>(d) * n_slots + sys) * n_spins;
  int4* gsp = reinterpret_cast<int4*>(a.spins + sys_off + static_cast<size_t>(r0) * W);
  for (int i = threadIdx.x; i < R * W / 16; i += blockDim.x)
    reinterpret_cast<int4*>(sp)[i] = gsp[i];
  for (int i = threadIdx.x; i < W / 4; i += blockDim.x) {  // the halo rows
    const int h = i < W / 8 ? (r0 + H - 1) % H : (r0 + R) % H;
    const int o = i < W / 8 ? i : i - W / 8;
    reinterpret_cast<uint64_t*>(i < W / 8 ? sp - W : sp + R * W)[o] =
        reinterpret_cast<const uint64_t*>(a.spins + sys_off + static_cast<size_t>(h) * W)[o];
  }
  const float* gjd = a.jgrids + (static_cast<size_t>(d) * 4 + 1) * n_spins;
  const float* gjr = a.jgrids + (static_cast<size_t>(d) * 4 + 3) * n_spins;
  for (int i = threadIdx.x; i < 2 * (R + 1) * wh; i += blockDim.x) {
    const int c = i / ((R + 1) * wh);
    const int q = (i - c * (R + 1) * wh) / wh;
    const int j = i - (c * (R + 1) + q) * wh;
    const int r = (r0 - 1 + q + H) % H;
    jd[i] = gjd[static_cast<size_t>(r) * W + 2 * j + ((r + c) & 1)];
  }
  for (int i = threadIdx.x; i < 2 * R * wh; i += blockDim.x) {
    const int c = i / (R * wh);
    const int q = (i - c * R * wh) / wh;
    const int j = i - (c * R + q) * wh;
    const int r = r0 + q;
    jr[i] = gjr[static_cast<size_t>(r) * W + 2 * j + ((r + c) & 1)];
  }
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
    stemp[s] = a.temps[s];
    ssid[s] = a.sid[d * n_slots + s];
    srt[s] = a.rtrips[d * n_slots + s];
    sts[s] = a.tstate[d * n_slots + s];
    if (s < n_edges) {
      sea[s] = a.ea[d * n_edges + s];
      sec[s] = a.ec[d * n_edges + s];
    }
  }
  __syncthreads();
  int slot = 0;
  for (int s = 0; s < n_slots; ++s)
    if (ssid[s] == sys) slot = s;
  // the halo rows this CTA's first and last rows are (the lattice wraps)
  int8_t* push_up = cluster.map_shared_rank(sp + R * W, (rank + C - 1) % C);
  int8_t* push_dn = cluster.map_shared_rank(sp - W, (rank + 1) % C);
  float* row_e0 = cluster.map_shared_rank(row_e, 0);
  int* row_m0 = cluster.map_shared_rank(row_m, 0);
  cluster.sync();  // every CTA staged before any writes another's halo

  PtState st{es, ssid, sea, sec, srt, sts, stemp, n_spins, a.hot, a.cold};
  const int first_pt = a.pt_interval > 0
                           ? (a.pt_interval - a.sweep_base % a.pt_interval) % a.pt_interval
                           : a.n;
  int parity = a.parity;
  int events = 0;  // PT events so far
  int done = 0;    // single-edge events applied to this CTA's PT state (warp 0)
  const int32_t* wp = a.words + 2 * d;
  uint32_t k0 = static_cast<uint32_t>(wp[0]), k1 = static_cast<uint32_t>(wp[1]);
  const int g0 = r0 * (wh / kSitesPerThread);
  draw_pass(draws, groups, g0, 0, slot, k0, k1);
  for (int t = 0; t < a.n; ++t) {
    const uint32_t c0 = k0, c1 = k1;
    if (t + 1 < a.n) {  // the next sweep's words, loaded while this one runs
      wp += 2 * a.n_disorder;
      k0 = static_cast<uint32_t>(wp[0]);
      k1 = static_cast<uint32_t>(wp[1]);
    }
    const bool do_pt = a.pt_interval > 0 && (a.sweep_base + t) % a.pt_interval == 0;
    if (do_pt && warp == 0) {  // the sweep's PT draws, fetched while the colours run
      const size_t o = static_cast<size_t>(t) * a.n_disorder + d;
      if (a.pt_full) {
        for (int i = lane; i < 2 * n_edges; i += 32) copy4_async(su + i, a.u_draw + 2 * n_edges * o + i);
      } else if (lane == 0) {
        copy4_async(sedge, a.edge_draw + o);
        copy4_async(su, a.u_draw + o);
      }
      copies_commit();
    }
    const float inv_half_t = 1.0f / (0.5f * stemp[slot]);
    pass<false>(sp, jd, jr, push_up, push_dn, R, W, r0, 0, draws, inv_half_t, a.gibbs,
                part_e, part_m);
    cluster_arrive();  // colour 0 written before any CTA reads it
    draw_pass(draws, groups, g0, 1, slot, c0, c1);
    cluster_wait();
    pass<true>(sp, jd, jr, push_up, push_dn, R, W, r0, 1, draws, inv_half_t, a.gibbs,
               part_e, part_m);
    if (do_pt && warp == 0) copies_wait();  // long arrived: the colours ran meanwhile
    __syncthreads();
    for (int b = warp; b < nblk; b += n_warps) {
      const float e = warp_tree(part_e + b * kThreads, lane);
      const int m = warp_tree(part_m + b * kThreads, lane);
      if (lane == 0) {
        row_e0[rank * nblk + b] = e;
        row_m0[rank * nblk + b] = m;
      }
    }
    // a CTA whose slot no PT event can move draws the next sweep's colour 0
    // while the cluster catches up; the others after the event
    const int e_pt = *sedge;
    const bool moves = do_pt && (a.pt_full || slot == e_pt || slot == e_pt + 1);
    cluster_arrive();  // the row complete in rank 0, colour 1 written
    if (!moves && t + 1 < a.n) draw_pass(draws, groups, g0, 0, slot, k0, k1);
    cluster_wait();
    const int event = events;
    uint64_t* ev = a.sums + (static_cast<size_t>(event) * a.n_disorder + d) * n_slots;
    if (rank == 0 && warp == 0) {
      float e_sum;
      int m_sum;
      share_sum<false>(row_e, row_m, C * nblk, 0, kThreads, lane, e_sum, m_sum);
      if (lane == 0) {
        const size_t o = (static_cast<size_t>(d) * a.n + t) * n_slots + slot;
        a.e_out[o] = e_sum / static_cast<float>(n_spins);
        a.m_out[o] = m_sum;
        if (do_pt)
          st_relaxed(ev + sys, static_cast<uint64_t>(event) << 32 | __float_as_uint(e_sum));
      }
      __syncwarp();
    }
    if (!do_pt) continue;
    ++events;
    // the event (pt_step's), run by warp 0 of every CTA on its own copy of
    // the PT state: a full-ladder event waits for every system's sum; a
    // single-edge event concerns only the two clusters at its edge, which
    // first apply the outcomes of the events they missed
    if (!moves) continue;
    if (warp == 0) {
      if (a.pt_full) {
        for (int s = lane; s < n_slots; s += 32) {
          uint64_t v = ld_acquire(ev + s);
          while (static_cast<int>(v >> 32) != event) v = ld_acquire(ev + s);
          sums[s] = __uint_as_float(static_cast<uint32_t>(v));
        }
        __syncwarp();
        for (int s = lane; s < n_slots; s += 32)
          es[s] = sums[ssid[s]] / static_cast<float>(n_spins);
        __syncwarp();
        // the edges of one parity touch disjoint slots (and the hot and
        // the cold slot's systems apart): a lane each, then the other parity
        for (int i = 0; i < 2; ++i) {
          const int p = i == 0 ? parity : 1 - parity;
          for (int e = p + 2 * lane; e < n_edges; e += 64) try_edge(st, e, su[i * n_edges + e]);
          __syncwarp();
        }
      } else {
        catch_up(a, st, d, first_pt, lane, done, event);
        if (lane < 2) {
          const uint64_t* wv = ev + ssid[e_pt + lane];
          uint64_t v = ld_acquire(wv);
          while (static_cast<int>(v >> 32) != event) v = ld_acquire(wv);
          es[e_pt + lane] = __uint_as_float(static_cast<uint32_t>(v)) / static_cast<float>(n_spins);
        }
        __syncwarp();
        if (lane == 0) {
          const int before = sec[e_pt];
          try_edge(st, e_pt, *su);
          st_relaxed(a.flags + static_cast<size_t>(event) * a.n_disorder + d,
                     static_cast<uint64_t>(event) << 32 | (sec[e_pt] != before ? 1u : 0u));
        }
        __syncwarp();
        done = event + 1;
      }
    }
    if (a.pt_full) parity = 1 - parity;
    __syncthreads();
    for (int s = 0; s < n_slots; ++s)
      if (ssid[s] == sys) slot = s;
    if (t + 1 < a.n) draw_pass(draws, groups, g0, 0, slot, k0, k1);
  }

  for (int i = threadIdx.x; i < R * W / 16; i += blockDim.x)
    gsp[i] = reinterpret_cast<const int4*>(sp)[i];
  if (events > 0 && sys == 0 && rank == 0) {  // the realization's PT state
    if (!a.pt_full && warp == 0) catch_up(a, st, d, first_pt, lane, done, events);
    __syncthreads();
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
      a.sid[d * n_slots + s] = ssid[s];
      a.rtrips[d * n_slots + s] = srt[s];
      a.tstate[d * n_slots + s] = sts[s];
      if (s < n_edges) {
        a.ea[d * n_edges + s] = sea[s];
        a.ec[d * n_edges + s] = sec[s];
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may write its shared memory
}

// PT events of a chunk of n sweeps from sweep_base (none for pt_interval 0).
int pt_events(int n, int sweep_base, int pt_interval) {
  if (pt_interval <= 0) return 0;
  const int first = (pt_interval - sweep_base % pt_interval) % pt_interval;
  return first < n ? (n - 1 - first) / pt_interval + 1 : 0;
}

// A cooperative launch of n_clusters clusters of C CTAs (attrs: room for
// the two attributes).
cudaLaunchConfig_t launch_config(int n_clusters, int C, int threads, int smem,
                                 cudaStream_t stream, cudaLaunchAttribute* attrs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace

extern "C" {

// Shared memory a block of the current device may opt in to.
int peapods_smem_per_block_optin(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return v;
}

// Clusters of C CTAs of `threads` threads and `smem` bytes that the current
// device runs at once (cudaOccupancyMaxActiveClusters); -(CUDA error) on
// failure.
int peapods_resident_max_clusters(int C, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      mega_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg = launch_config(1, C, threads, smem, nullptr, attrs);
  cfg.numAttrs = 1;  // the cluster shape alone
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, mega_resident_kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// n sweeps of every (realization, system) of a 2D [H, W] lattice in one
// cooperative launch of d n_slots clusters of C CTAs (threads and smem as
// ops/mega.py resident_plan chose them).  Refuses a shape whose logical
// blocks would straddle two CTAs, shared memory that differs from the
// layout's, and a grid whose clusters cannot all be resident.  scratch
// holds E d (n_slots + 1) 64-bit words, E the chunk's PT events (set to all
// ones here: the sums, then the outcomes); the shared memory is the layout's
// (ops/mega.py resident_smem is the same sum).
int peapods_mega_resident(void* spins, const void* jgrids, const void* temps, void* sid,
                          void* ea, void* ec, void* rtrips, void* tstate,
                          const void* words, const void* edge_draw, const void* u_draw,
                          void* e_out, void* m_out, void* scratch, int n_disorder,
                          int n_slots, int H, int W, int n, int sweep_base,
                          int pt_interval, int pt_full, int parity, int gibbs, int hot,
                          int cold, int C, int threads, int smem, void* stream) {
  if (C < 1 || H % C != 0 || W % 8 != 0 || (H / C) * (W / 2) % kBlockSites != 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || n_slots < 2 ||
      smem != layout(H, W, C, n_slots).total)
    return static_cast<int>(cudaErrorInvalidValue);
  const int have = peapods_resident_max_clusters(C, threads, smem);
  if (have < 0) return -have;
  if (have < n_disorder * n_slots) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n_sums =
      static_cast<size_t>(pt_events(n, sweep_base, pt_interval)) * n_disorder *
      n_slots;
  const size_t n_words = n_sums + n_sums / n_slots;
  uint64_t* words64 = static_cast<uint64_t*>(scratch);
  if (n_words > 0) {
    const cudaError_t err = cudaMemsetAsync(scratch, 0xff, sizeof(uint64_t) * n_words, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a{static_cast<int8_t*>(spins), static_cast<const float*>(jgrids),
         static_cast<const float*>(temps), static_cast<int32_t*>(sid),
         static_cast<int32_t*>(ea), static_cast<int32_t*>(ec),
         static_cast<int32_t*>(rtrips), static_cast<int32_t*>(tstate),
         static_cast<const int32_t*>(words), static_cast<const int32_t*>(edge_draw),
         static_cast<const float*>(u_draw), static_cast<float*>(e_out),
         static_cast<int32_t*>(m_out), words64, words64 + n_sums, n_disorder, n_slots,
         H, W, n, sweep_base, pt_interval, pt_full, parity, gibbs, hot, cold};
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg =
      launch_config(n_disorder * n_slots, C, threads, smem, st, attrs);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, mega_resident_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
