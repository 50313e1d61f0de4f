// Hopper kernels of FK observe's winding flags: per 2D square bond graph of
// a batch, does any component wrap the torus along axis 0 (x) / axis 1 (y).
//
// Replaces the TPU's peapods_tpu/ops/pallas_cc_batch.py:572 winding_batch
// (kernel _winding_kernel :501); its plain version is the jnp settle loop
// cluster.winding_flags (peapods_tpu/ops/cluster.py:612, the port's
// ops/cluster.winding_flags).
//
// The flags are read from the wrap bonds of the open graph.  The open graph
// is the bond graph less its wrap bonds (row L0-1 to row 0 along axis 0,
// column L1-1 to column 0 along axis 1): a subgraph of the plane grid, so
// none of its cycles winds, and inside one of its components a site's
// unwrapped displacement is its coordinates.  Contract each open component
// to a node: an active wrap bond joins two nodes and moves the sheet by
// (1, 0) or (0, 1).  A component winds along axis a iff a cycle of this
// small graph has a net shift along a, that is iff a spanning-forest
// potential of sheets disagrees with an edge's shift along a: the chord
// test of pallas_cc_batch.py:505-516 on at most L0 + L1 edges in place of
// L0 L1 sites.  The sheets live in a union-find with offsets, W: a 64-bit
// word per open root, its parent and the sheet offset to it along each axis
// (16 bits each, mod 2^16).  A potential difference is a sum of shifts along
// a path of the spanning forest, each wrap bond at most once, so along axis
// 0 it counts at most the L1 bonds that wrap axis 0, along axis 1 at most
// the L0 that wrap axis 1; with L0, L1 < 2^15 (kMaxExtent) a chord's
// disagreement is under 2^15 in size and exact mod 2^16, and L0 L1 < 2^30
// keeps the site indices in an int.  An edge hangs the
// larger root under the smaller with atomicCAS, with the offset that makes
// the two ends' sheets differ by its shift; an edge whose ends already share
// a root is a chord, and flags each axis along which its sheets disagree.
// The open graph is labelled with fk.cu fk_link's union-find in shared
// memory (uf.cuh tile_root / tile_unite; runs of axis-1 bonds inside a warp
// hung by ballot), in the boxes of ops/fk.py link_plan.
//
//   winding         a graph of at most kLinkSites sites (link_plan's whole-
//                   graph form: the harness's and the overlap observe's
//                   64^2), one CTA a graph, all in shared memory: the open
//                   graph, its wrap edges in W, the error check.
//   winding_link    the tiled form's boxes: the open bonds inside each box
//                   united, every parent written as its box root (global
//                   site index), W set to one node a site.
//   winding_border  the open bonds that leave a box (not the wrap bonds),
//                   united in global memory (uf.cuh unite); the open graph's
//                   roots are then its components' minimum sites.
//   winding_wrap    one CTA a graph: each active wrap bond's two ends' open
//                   roots (uf.cuh find_root), united in W in global memory;
//                   the flags.  Only the wrap bonds' ends need a root, so the
//                   open labels are never flattened.
//   winding_check   the error check over every site (below).
//
// The error check: the plain version settles from the sites labelled as
// themselves and raises when a component holds none (the labels do not
// belong to the masks).  The kernels set the error word iff a component of
// the bond graph holds no site whose label is itself: the whole form marks
// the W root of each such site and looks for an unmarked W root among the
// open roots; winding_check counts the components (open roots that are W
// roots) and the W roots it claims from those sites (a bit of the root's
// word), and the last CTA of a graph compares the two counts.
//
// What bounds it on the H100: the masks and labels are read and one byte a
// graph is written (at 64^2 x 2048 graphs 50 MB, 15 us at 3.35 TB/s; one
// 256^2 graph 0.39 MB, 0.12 us).  The first design settled the
// displacements breadth first in one CTA a graph, a barrier and a few
// dependent loads a level; near T_c a spanning cluster of 256^2 is hundreds
// of levels deep: 0.847 ms on one of 132 SMs (NVIDIA H100 80GB HBM3, 700 W),
// and it refused a graph over 1,859,584 sites (its settled bitmap filled a
// CTA's shared memory).  Now the depth that counts is the contracted
// graph's, and the work is the labelling's: fk_link's boxes and unions.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"
#include "uf.cuh"

using namespace peapods;

namespace {

constexpr int kLinkThreads = 1024;
constexpr int kLinkSites = 8192;   // fk.cu's: a box's parents, state bytes and W
constexpr int kMaxExtent = 32767;  // L0, L1 < 2^15: the offsets mod 2^16 stay exact
constexpr int kCheckSites = 1024;  // sites a winding_check CTA counts

using u64 = unsigned long long;

// W's word of a node: its parent and the sheet offset to it along axes 0
// and 1, each mod 2^16.
__host__ __device__ __forceinline__ u64 wword(int parent, unsigned ox, unsigned oy) {
  return (static_cast<u64>(static_cast<uint32_t>(parent)) << 32) |
         ((static_cast<u64>(ox) & 0xffffu) << 16) | (static_cast<u64>(oy) & 0xffffu);
}

__device__ __forceinline__ int wparent(u64 w) { return static_cast<int>(w >> 32); }

// A word of W in shared memory (kShared) or global memory (loads bypass
// L1, as uf.cuh's find_root does: another thread's CAS lands in L2).
template <bool kShared>
__device__ __forceinline__ u64 wload(const u64* W, int x) {
  if (kShared) return *reinterpret_cast<const volatile u64*>(W + x);
  return __ldcg(W + x);
}

// The W root of node x and x's sheet offset to it (ox, oy, mod 2^16),
// halving the path on the way (a halved word still points at an ancestor
// with its offset to it; only non-roots are written, so no root's CAS
// races a halving).
template <bool kShared>
__device__ __forceinline__ int wfind(u64* W, int x, unsigned& ox, unsigned& oy) {
  ox = oy = 0u;
  while (true) {
    const u64 w = wload<kShared>(W, x);
    const int p = wparent(w);
    if (p == x) return x;
    unsigned ax = static_cast<unsigned>(w >> 16), ay = static_cast<unsigned>(w);
    const u64 wp = wload<kShared>(W, p);
    const int gp = wparent(wp);
    if (gp == p) {
      ox += ax;
      oy += ay;
      return p;
    }
    ax += static_cast<unsigned>(wp >> 16);
    ay += static_cast<unsigned>(wp);
    W[x] = wword(gp, ax, ay);
    ox += ax;
    oy += ay;
    x = gp;
  }
}

// An active wrap bond from node a to node b that moves the sheet by (sx,
// sy): hang the larger of the two roots under the smaller so that sheet(b)
// - sheet(a) = s, or, where they share a root, return the axes along which
// the chord disagrees (bit 0: x, bit 1: y).
template <bool kShared>
__device__ __forceinline__ unsigned wunite(u64* W, int a, int b, unsigned sx, unsigned sy) {
  while (true) {
    unsigned ax, ay, bx, by;
    const int ra = wfind<kShared>(W, a, ax, ay);
    const int rb = wfind<kShared>(W, b, bx, by);
    const unsigned dx = bx - ax - sx, dy = by - ay - sy;
    if (ra == rb) return ((dx & 0xffffu) != 0u ? 1u : 0u) | ((dy & 0xffffu) != 0u ? 2u : 0u);
    // sheet(ra) = sheet(rb) + d, or sheet(rb) = sheet(ra) - d
    const bool hang_a = ra > rb;
    const int x = hang_a ? ra : rb;
    const u64 root = wword(x, 0u, 0u);
    const u64 to = hang_a ? wword(rb, dx, dy) : wword(ra, 0u - dx, 0u - dy);
    if (atomicCAS(W + x, root, to) == root) return 0u;
  }
}

// Wrap bond k of an [L0, L1] graph: k < L1 is (L0-1, k) -> (0, k) along
// axis 0, else (k - L1, L1-1) -> (k - L1, 0) along axis 1.
__device__ __forceinline__ void wrap_bond(int k, int L0, int L1, int& u, int& v, int& axis) {
  if (k < L1) {
    u = (L0 - 1) * L1 + k;
    v = k;
    axis = 0;
  } else {
    u = (k - L1) * L1 + L1 - 1;
    v = u - (L1 - 1);
    axis = 1;
  }
}

// The masks of a site as one 16-bit load: byte 0 the bond to (r+1, c),
// byte 1 the bond to (r, c+1) (bool, 0 or 1).
__device__ __forceinline__ unsigned mask_bits(const uint16_t* M, int i) {
  const unsigned v = M[i];
  return (v & 1u) | ((v >> 7) & 2u);
}

// The union-find of an open box in shared memory, fk_link's steps (1)-(2):
// S holds each box site's open bonds (bit 0 down, bit 1 right), lines of
// `ef` sites, the threads along the line.  Each run of right bonds inside a
// warp is hung under its first site (a ballot), the other bonds united a
// round of lines at a time, each round's sites then pointed at their roots.
__device__ __forceinline__ void link_box(int* P, const uint8_t* S, int n_lines, int ef) {
  const unsigned lanes = __activemask();
  const int x = threadIdx.x;
  const int lane = (threadIdx.y * blockDim.x + x) & 31;
  const int iters = (n_lines + blockDim.y - 1) / blockDim.y;
  for (int it = 0; it < iters; ++it) {
    const int s = threadIdx.y + it * blockDim.y;
    const int l = s * ef + x;
    const bool on = s < n_lines && x < ef;
    const bool run = on && (S[l] & 2u);
    const unsigned starts = ~(__ballot_sync(lanes, run) << 1);
    const int first = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
    if (on) P[l] = l - (lane - first);
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    const int s = threadIdx.y + it * blockDim.y;
    const int l = s * ef + x;
    const bool on = s < n_lines && x < ef;
    const unsigned st = on ? S[l] : 0u;
    if (st & 1u) tile_unite(P, l, l + ef);
    if ((st & 2u) && lane == 31) tile_unite(P, l, l + 1);  // a run that leaves the warp
    __syncthreads();
    if (on) P[l] = tile_root(P, l);
    __syncthreads();
  }
}

// The whole form: one CTA a graph of L0 x L1 <= kLinkSites sites, L1
// threads along its rows.  Shared memory: W (8 B a site), the parents P (4
// B), the bond bits S (1 B: bits 0, 1 the open bonds down and right, bits
// 2, 3 the wrap bonds, bit 4 "labelled as itself") and the marks M (1 B).
__global__ void __launch_bounds__(kLinkThreads)
winding_kernel(const uint16_t* __restrict__ masks, const int32_t* __restrict__ labels,
               uint8_t* __restrict__ out, int* err, int L0, int L1) {
  extern __shared__ u64 smem[];
  const int n = L0 * L1;
  u64* W = smem;
  int* P = reinterpret_cast<int*>(W + n);
  uint8_t* S = reinterpret_cast<uint8_t*>(P + n);
  uint8_t* Mk = S + n;
  const size_t g = blockIdx.x;
  const uint16_t* M = masks + g * n;
  const int32_t* lab = labels + g * n;
  const int x = threadIdx.x;
  const int tid = threadIdx.y * blockDim.x + x;
  const int nt = blockDim.x * blockDim.y;
  for (int s = threadIdx.y; s < L0; s += blockDim.y) {
    const int l = s * L1 + x;
    const unsigned bits = mask_bits(M, l);
    unsigned st = 0u;
    if (bits & 1u) st |= s + 1 < L0 ? 1u : 4u;
    if (bits & 2u) st |= x + 1 < L1 ? 2u : 8u;
    if (lab[l] == l) st |= 16u;
    S[l] = static_cast<uint8_t>(st);
    W[l] = wword(l, 0u, 0u);
    Mk[l] = 0;
  }
  __syncthreads();
  link_box(P, S, L0, L1);
  unsigned viol = 0u;
  for (int k = tid; k < L0 + L1; k += nt) {
    int u, v, axis;
    wrap_bond(k, L0, L1, u, v, axis);
    if (S[u] & (4u << axis))
      viol |= wunite<true>(W, tile_root(P, u), tile_root(P, v), axis == 0, axis == 1);
  }
  __syncthreads();
  for (int l = tid; l < n; l += nt) {
    if (S[l] & 16u) {
      unsigned ox, oy;
      Mk[wfind<true>(W, tile_root(P, l), ox, oy)] = 1;
    }
  }
  __syncthreads();
  int bad = 0;
  for (int l = tid; l < n; l += nt)
    bad |= P[l] == l && wparent(W[l]) == l && !Mk[l];
  const int vx = __syncthreads_or(viol & 1u);
  const int vy = __syncthreads_or(viol & 2u);
  bad = __syncthreads_or(bad);
  if (tid == 0) {
    out[g] = static_cast<uint8_t>((vx ? 1 : 0) | (vy ? 2 : 0));
    if (bad) atomicOr(err, 1);
  }
}

// A box of the tiled form: tile (t0, t1) of an [L0, L1] graph, nt1 boxes a
// row of boxes.
struct WindBox {
  int o0, o1, e0, e1;
};

__device__ __forceinline__ WindBox wind_box(int L0, int L1, int t0, int t1) {
  const int nt1 = (L1 + t1 - 1) / t1;
  const int i0 = blockIdx.x / nt1;
  WindBox b;
  b.o0 = i0 * t0;
  b.o1 = (blockIdx.x - i0 * nt1) * t1;
  b.e0 = min(t0, L0 - b.o0);
  b.e1 = min(t1, L1 - b.o1);
  return b;
}

// winding_link: a CTA a box of one graph, t1 threads along its rows.  cnt:
// int32 [B, 3], zeroed here for winding_check.
__global__ void __launch_bounds__(kLinkThreads)
winding_link_kernel(const uint16_t* __restrict__ masks, int32_t* __restrict__ parent,
                    u64* __restrict__ wsheet, int* __restrict__ cnt, int L0, int L1,
                    int t0, int t1) {
  __shared__ int P[kLinkSites];
  __shared__ uint8_t S[kLinkSites];
  const size_t n = static_cast<size_t>(L0) * L1;
  const WindBox b = wind_box(L0, L1, t0, t1);
  const uint16_t* M = masks + blockIdx.y * n;
  int32_t* par = parent + blockIdx.y * n;
  u64* W = wsheet + blockIdx.y * n;
  const int x = threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.y == 0 && x == 0)
    cnt[3 * blockIdx.y] = cnt[3 * blockIdx.y + 1] = cnt[3 * blockIdx.y + 2] = 0;
  if (x < b.e1) {
    for (int s = threadIdx.y; s < b.e0; s += blockDim.y) {
      const int i = (b.o0 + s) * L1 + b.o1 + x;
      const unsigned bits = mask_bits(M, i);
      S[s * b.e1 + x] = static_cast<uint8_t>(((bits & 1u) && s + 1 < b.e0 ? 1u : 0u) |
                                             ((bits & 2u) && x + 1 < b.e1 ? 2u : 0u));
      W[i] = wword(i, 0u, 0u);
    }
  }
  __syncthreads();
  link_box(P, S, b.e0, b.e1);
  if (x >= b.e1) return;
  for (int s = threadIdx.y; s < b.e0; s += blockDim.y) {
    const int r = tile_root(P, s * b.e1 + x);
    const int sr = r / b.e1;
    par[(b.o0 + s) * L1 + b.o1 + x] = (b.o0 + sr) * L1 + b.o1 + (r - sr * b.e1);
  }
}

// winding_border: the open bonds that leave a box, united as pairs of box
// roots in global memory (uf.cuh unite): the box's last row (down bonds)
// and last column (right bonds), except where they are the graph's last
// row or column, whose bonds wrap.
__global__ void __launch_bounds__(kThreads)
winding_border_kernel(const uint16_t* __restrict__ masks, int32_t* parent, int L0, int L1,
                      int t0, int t1) {
  const size_t n = static_cast<size_t>(L0) * L1;
  const uint16_t* M = masks + blockIdx.y * n;
  int32_t* P = parent + blockIdx.y * n;
  const WindBox b = wind_box(L0, L1, t0, t1);
  const int f0 = b.o0 + b.e0 < L0 ? b.e1 : 0;
  const int f1 = b.o1 + b.e1 < L1 ? b.e0 : 0;
  const int lane = threadIdx.x & 31;
  for (int q0 = 0; q0 < f0 + f1; q0 += blockDim.x) {  // uniform: the warps shuffle
    const int q = q0 + threadIdx.x;
    const bool down = q < f0;
    const int i = down ? (b.o0 + b.e0 - 1) * L1 + b.o1 + q
                       : (b.o0 + q - f0) * L1 + b.o1 + b.e1 - 1;
    const bool cross = q < f0 + f1 && (mask_bits(M, i) & (down ? 1u : 2u));
    const int j = down ? i + L1 : i + 1;
    // the two ends' box roots (the link wrote them), skipped where the
    // previous lane unites the same pair
    const int ra = cross ? __ldcg(P + i) : -1;
    const int rb = cross ? __ldcg(P + j) : -1;
    const int pa = __shfl_up_sync(0xffffffffu, ra, 1);
    const int pb = __shfl_up_sync(0xffffffffu, rb, 1);
    if (cross && !(lane > 0 && pa == ra && pb == rb)) unite(P, ra, rb);
  }
}

// winding_wrap: one CTA a graph; the flags.
__global__ void __launch_bounds__(kLinkThreads)
winding_wrap_kernel(const uint16_t* __restrict__ masks, int32_t* parent,
                    u64* wsheet, uint8_t* __restrict__ out, int L0, int L1) {
  const size_t n = static_cast<size_t>(L0) * L1;
  const uint16_t* M = masks + blockIdx.x * n;
  int32_t* P = parent + blockIdx.x * n;
  u64* W = wsheet + blockIdx.x * n;
  unsigned viol = 0u;
  for (int k = threadIdx.x; k < L0 + L1; k += blockDim.x) {
    int u, v, axis;
    wrap_bond(k, L0, L1, u, v, axis);
    if (mask_bits(M, u) & (1u << axis))
      viol |= wunite<false>(W, find_root(P, u), find_root(P, v), axis == 0, axis == 1);
  }
  const int vx = __syncthreads_or(viol & 1u);
  const int vy = __syncthreads_or(viol & 2u);
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<uint8_t>((vx ? 1 : 0) | (vy ? 2 : 0));
}

// winding_check: kCheckSites sites a CTA.  Counts the components among
// them (open roots that are W roots) and claims the W root of each site
// labelled as itself (bit 0 of the root's word, which no find reads);
// cnt[3 g] += components, cnt[3 g + 1] += first claims, and the graph's
// last CTA (a ticket in cnt[3 g + 2]) sets the error word if a component
// was never claimed.
__global__ void __launch_bounds__(kThreads)
winding_check_kernel(const int32_t* __restrict__ labels, int32_t* parent, u64* wsheet,
                     int* cnt, int* err, int n) {
  __shared__ int s_roots, s_claims;
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const int32_t* lab = labels + base;
  int32_t* P = parent + base;
  u64* W = wsheet + base;
  int* c = cnt + 3 * blockIdx.y;
  if (threadIdx.x == 0) s_roots = s_claims = 0;
  __syncthreads();
  const int i0 = blockIdx.x * kCheckSites;
  const int i1 = min(i0 + kCheckSites, n);
  int roots = 0, claims = 0;
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    if (__ldcg(P + i) == i && wparent(__ldcg(W + i)) == i) ++roots;
    if (lab[i] == i) {
      int f = find_root(P, i);
      for (int p; (p = wparent(__ldcg(W + f))) != f;) f = p;
      claims += (atomicOr(W + f, 1ull) & 1ull) ? 0 : 1;
    }
  }
  roots = __reduce_add_sync(0xffffffffu, roots);
  claims = __reduce_add_sync(0xffffffffu, claims);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_roots, roots);
    atomicAdd(&s_claims, claims);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(c, s_roots);
    atomicAdd(c + 1, s_claims);
    __threadfence();
    if (atomicAdd(c + 2, 1) == static_cast<int>(gridDim.x) - 1 &&
        atomicAdd(c + 1, 0) != atomicAdd(c, 0))
      atomicOr(err, 1);
  }
}

bool extents_ok(int L0, int L1, int n_graphs) {
  return L0 >= 2 && L1 >= 2 && L0 <= kMaxExtent && L1 <= kMaxExtent && n_graphs >= 1 &&
         n_graphs <= 65535;
}

}  // namespace

extern "C" {

// masks: bool [n_graphs, L0 L1, 2] (bond to (r+1, c), bond to (r, c+1));
// labels: int32 [n_graphs, L0 L1]; out: uint8 [n_graphs] (bit 0: x, bit 1:
// y); err: one int, set to 1 when a graph's labels do not belong to its
// masks.  The whole form: L0 L1 <= 8192 and L1 <= 1024, CTAs of `threads`
// threads (ops/fk.py link_plan; a multiple of L1).
int peapods_winding(const void* masks, const void* labels, void* out, void* err,
                    int n_graphs, int L0, int L1, int threads, void* stream) {
  const int n = L0 * L1;
  if (!extents_ok(L0, L1, n_graphs) || n > kLinkSites || L1 > kLinkThreads ||
      threads < L1 || threads > kLinkThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t kSiteBytes = sizeof(u64) + sizeof(int) + 2;  // W, P, S, M
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(winding_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kLinkSites * kSiteBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int rows = threads / L1;
  winding_kernel<<<n_graphs, dim3(L1, rows < L0 ? rows : L0), n * kSiteBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(masks), static_cast<const int32_t*>(labels),
      static_cast<uint8_t*>(out), static_cast<int*>(err), L0, L1);
  return static_cast<int>(cudaGetLastError());
}

// The tiled form, in boxes of t0 x t1 sites (t0 t1 <= 8192, t1 <= 1024):
// parent int32 [n_graphs, n], wsheet int64 [n_graphs, n] and cnt int32
// [n_graphs, 3] scratch, written before they are read.
int peapods_winding_link(const void* masks, void* parent, void* wsheet, void* cnt,
                         int n_graphs, int L0, int L1, int t0, int t1, int threads,
                         void* stream) {
  if (!extents_ok(L0, L1, n_graphs) || t0 < 1 || t1 < 1 || t0 > L0 || t1 > L1 ||
      t0 * t1 > kLinkSites || t1 > kLinkThreads || threads < t1 || threads > kLinkThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((L0 + t0 - 1) / t0) * ((L1 + t1 - 1) / t1);
  const int rows = threads / t1;
  winding_link_kernel<<<dim3(tiles, n_graphs), dim3(t1, rows < t0 ? rows : t0), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(masks), static_cast<int32_t*>(parent),
      static_cast<u64*>(wsheet), static_cast<int*>(cnt), L0, L1, t0, t1);
  return static_cast<int>(cudaGetLastError());
}

int peapods_winding_border(const void* masks, void* parent, int n_graphs, int L0, int L1,
                           int t0, int t1, void* stream) {
  if (!extents_ok(L0, L1, n_graphs) || t0 < 1 || t1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((L0 + t0 - 1) / t0) * ((L1 + t1 - 1) / t1);
  winding_border_kernel<<<dim3(tiles, n_graphs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(masks), static_cast<int32_t*>(parent), L0, L1, t0, t1);
  return static_cast<int>(cudaGetLastError());
}

int peapods_winding_wrap(const void* masks, void* parent, void* wsheet, void* out,
                         int n_graphs, int L0, int L1, void* stream) {
  if (!extents_ok(L0, L1, n_graphs)) return static_cast<int>(cudaErrorInvalidValue);
  int threads = (L0 + L1 + 31) / 32 * 32;
  threads = threads > kLinkThreads ? kLinkThreads : threads;
  winding_wrap_kernel<<<n_graphs, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(masks), static_cast<int32_t*>(parent),
      static_cast<u64*>(wsheet), static_cast<uint8_t*>(out), L0, L1);
  return static_cast<int>(cudaGetLastError());
}

int peapods_winding_check(const void* labels, void* parent, void* wsheet, void* cnt,
                          void* err, int n_graphs, int L0, int L1, void* stream) {
  if (!extents_ok(L0, L1, n_graphs)) return static_cast<int>(cudaErrorInvalidValue);
  const int n = L0 * L1;
  winding_check_kernel<<<dim3((n + kCheckSites - 1) / kCheckSites, n_graphs), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<int32_t*>(parent),
      static_cast<u64*>(wsheet), static_cast<int*>(cnt), static_cast<int*>(err), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
