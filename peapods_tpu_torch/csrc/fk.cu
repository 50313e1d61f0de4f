// Hopper kernels of the FK cluster update (Swendsen-Wang or Wolff) over a
// flat batch of graphs: bond draws, union-find labelling, cluster flips and
// the post-update measurement, in three launches on the caller's stream.
//
// Replaces the TPU's fused FK kernel peapods_tpu/ops/pallas_event.py:759
// fk_update_batch (kernel _fk_kernel :621, with the CC fixed point
// pallas_cc_batch.cc_fixed_point :188-320 and the coin _salted_uniform_i32
// :260).  The graphs are the (realization, system) pairs, flat and
// disorder-major: spins int8 [B, H*W] by system, couplings f32 [d, H*W, 2]
// (forward bonds down, right) shared by the B / d systems of a realization.
//
//   fk_bonds   thread g owns sites 4g .. 4g+3: inter = s * s_fwd * J and
//              bond = inter > 0 && u < 1 - exp(-2 * inter / T) per forward
//              bond (the reference's operation order, so an injected-uniform
//              comparison is bitwise), u from Philox4x32-10 keyed by the
//              graph's kb words, counter (dir, site // 4, 0, 0).  Writes a
//              state byte (bit d: bond d active; bit 2 + d: s != s_fwd) and
//              parent[i] = i.
//   fk_link    one thread per site unites the two ends of each active bond:
//              find with path halving, then hang the larger root under the
//              smaller with atomicCAS, retrying from the new parent when
//              another thread got there first (Komura 2015; Playne & Hawick
//              2018; the ECL-CC hooking of Jaiganesh & Burtscher 2018).
//              Parents only ever point to a smaller index, so when the
//              launch ends each component is one tree whose root is its
//              minimum site index, whatever order the threads ran in: the
//              reference's min-label fixed point, bitwise.
//   fk_finish  one thread per site: label = find(i), optionally written
//              to a labels array (the parent array keeps being halved by
//              other threads' finds, so it is not the output); SW flips iff
//              salted_uniform(label, salt0, salt1) < 1/2, Wolff iff label ==
//              find(seed) (found on the device).  When measuring, the
//              post-update energy s * s_fwd * J of the site's two forward
//              bonds comes from the state byte and the neighbours' flip
//              decisions (no neighbour spin is read while spins are
//              rewritten), and the block writes one (e, m) partial per graph
//              ([B, blocks]); pt_step adds them in a fixed order.
//
// What bounds it on the H100: each launch touches a few bytes per site --
// the int8 spins, 8 B of couplings, the state byte and the int32 parent.
// At config 3 (one 256^2 graph) that is well under 1 MB per launch (under
// 1 us at 3.35 TB/s): the launches are bound by latency and by the chains of
// dependent parent loads and atomics near T_c, where one cluster spans the
// lattice.  At 64^2 x 2048 graphs the int32 parents alone are 33.5 MB,
// read and written several times, so the kernels are bandwidth-bound at
// tens of microseconds.  Path halving keeps the chains short; holding a
// graph in shared memory with block-local union-find is later work (ROADMAP
// queue 3).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"

using namespace peapods;

namespace {

// forward neighbour of site i along dir (0 down, 1 right), periodic
__device__ __forceinline__ int fwd_site(int i, int H, int W, int dir) {
  const int r = i / W;
  const int c = i - r * W;
  if (dir == 0) return r == H - 1 ? c : i + W;
  return c == W - 1 ? i - c : i + 1;
}

// murmur-style hash of (label, salt) to a 24-bit uniform (ops/cluster.py)
__device__ __forceinline__ float salted_uniform(uint32_t x, uint32_t s0,
                                                uint32_t s1) {
  x ^= s0;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x = x ^ (x >> 16) ^ s1;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return uniform24(x);
}

// Root of x, halving the path on the way.  Loads bypass L1 (__ldcg), which
// is not coherent across SMs; a stale parent is still an ancestor or a
// former root, and the caller's atomicCAS catches the latter.
__device__ __forceinline__ int find_root(int32_t* P, int x) {
  int cur = __ldcg(P + x);
  if (cur == x) return x;
  int prev = x;
  int next;
  while (cur > (next = __ldcg(P + cur))) {
    P[prev] = next;
    prev = cur;
    cur = next;
  }
  return cur;
}

__device__ __forceinline__ void unite(int32_t* P, int a, int b) {
  a = find_root(P, a);
  b = find_root(P, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(P + a, a, b);
    if (old == a) return;
    a = find_root(P, old);
  }
}

__global__ void __launch_bounds__(kThreads)
fk_bonds_kernel(const int8_t* __restrict__ spins, const float* __restrict__ j_fwd,
                const float* __restrict__ temps, const int32_t* __restrict__ kb,
                uint8_t* __restrict__ state, int32_t* __restrict__ parent, int H,
                int W, int n_systems) {
  const int b = blockIdx.y;
  const int n = H * W;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (kSitesPerThread * g >= n) return;
  const size_t base = static_cast<size_t>(b) * n;
  const int8_t* s = spins + base;
  const float2* J = reinterpret_cast<const float2*>(j_fwd) +
                    static_cast<size_t>(b / n_systems) * n;
  const float T = temps[b];
  const uint32_t k0 = static_cast<uint32_t>(kb[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(kb[2 * b + 1]);
  const uint4 ra = philox4x32_10(k0, k1, 0u, static_cast<uint32_t>(g), 0u, 0u);
  const uint4 rb = philox4x32_10(k0, k1, 1u, static_cast<uint32_t>(g), 0u, 0u);
  const uint32_t w[2][4] = {{ra.x, ra.y, ra.z, ra.w}, {rb.x, rb.y, rb.z, rb.w}};
#pragma unroll
  for (int k = 0; k < kSitesPerThread; ++k) {
    const int i = kSitesPerThread * g + k;
    if (i >= n) break;
    const float si = static_cast<float>(s[i]);
    const float2 j = J[i];
    uint8_t st = 0;
#pragma unroll
    for (int dir = 0; dir < 2; ++dir) {
      const float sf = static_cast<float>(s[fwd_site(i, H, W, dir)]);
      const float inter = si * sf * (dir == 0 ? j.x : j.y);
      const float p = 1.0f - expf(-2.0f * inter / T);
      if (inter > 0.0f && uniform24(w[dir][k]) < p) st |= 1u << dir;
      if (si != sf) st |= 4u << dir;
    }
    state[base + i] = st;
    parent[base + i] = i;
  }
}

__global__ void __launch_bounds__(kThreads)
fk_link_kernel(const uint8_t* __restrict__ state, int32_t* parent, int H, int W) {
  const int b = blockIdx.y;
  const int n = H * W;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t st = state[static_cast<size_t>(b) * n + i];
  if (!(st & 3u)) return;
  int32_t* P = parent + static_cast<size_t>(b) * n;
  if (st & 1u) unite(P, i, fwd_site(i, H, W, 0));
  if (st & 2u) unite(P, i, fwd_site(i, H, W, 1));
}

__device__ __forceinline__ bool flips(int root, int wolff, int seed_root,
                                      uint32_t s0, uint32_t s1) {
  return wolff ? root == seed_root
               : salted_uniform(static_cast<uint32_t>(root), s0, s1) < 0.5f;
}

__global__ void __launch_bounds__(kThreads)
fk_finish_kernel(int8_t* __restrict__ spins, const uint8_t* __restrict__ state,
                 int32_t* parent, int32_t* __restrict__ labels,
                 const float* __restrict__ j_fwd,
                 const int32_t* __restrict__ scalars, float* __restrict__ e_part,
                 int32_t* __restrict__ m_part, int H, int W, int n_systems,
                 int wolff) {
  const int b = blockIdx.y;
  const int n = H * W;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool measure = e_part != nullptr;
  float e_acc = 0.0f;
  int m_acc = 0;
  if (i < n) {
    const size_t base = static_cast<size_t>(b) * n;
    int32_t* P = parent + base;
    const uint32_t s0 = static_cast<uint32_t>(scalars[3 * b]);
    const uint32_t s1 = static_cast<uint32_t>(scalars[3 * b + 1]);
    const int seed_root = wolff ? find_root(P, scalars[3 * b + 2]) : -1;
    const int r = find_root(P, i);
    if (labels != nullptr) labels[base + i] = r;
    const bool fl = flips(r, wolff, seed_root, s0, s1);
    const int8_t sn = fl ? static_cast<int8_t>(-spins[base + i]) : spins[base + i];
    spins[base + i] = sn;
    if (measure) {
      const uint8_t st = state[base + i];
      const float2 j = reinterpret_cast<const float2*>(j_fwd)[
          static_cast<size_t>(b / n_systems) * n + i];
      float prod[2];
#pragma unroll
      for (int dir = 0; dir < 2; ++dir) {
        const bool ff = flips(find_root(P, fwd_site(i, H, W, dir)), wolff,
                              seed_root, s0, s1);
        prod[dir] = (((st >> (2 + dir)) & 1u) != 0) != (fl != ff) ? -1.0f : 1.0f;
      }
      float e = prod[0] * j.x;
      e = e + prod[1] * j.y;
      e_acc = e;
      m_acc = sn;
    }
  }
  if (!measure) return;  // uniform across the block
  block_partials(e_acc, m_acc, e_part, m_part,
                 static_cast<size_t>(b) * gridDim.x + blockIdx.x);
}

inline dim3 site_grid(int n, int per_thread, int n_graphs) {
  const int groups = (n + per_thread - 1) / per_thread;
  return dim3((groups + kThreads - 1) / kThreads, n_graphs);
}

}  // namespace

extern "C" {

// Blocks per graph of fk_finish: the length of the partial-sum rows.
int peapods_fk_blocks(int H, int W) { return (H * W + kThreads - 1) / kThreads; }

int peapods_fk_bonds(const void* spins, const void* j_fwd, const void* temps,
                     const void* kb, void* state, void* parent, int n_graphs,
                     int n_systems, int H, int W, void* stream) {
  fk_bonds_kernel<<<site_grid(H * W, kSitesPerThread, n_graphs), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(j_fwd),
      static_cast<const float*>(temps), static_cast<const int32_t*>(kb),
      static_cast<uint8_t*>(state), static_cast<int32_t*>(parent), H, W, n_systems);
  return static_cast<int>(cudaGetLastError());
}

int peapods_fk_link(const void* state, void* parent, int n_graphs, int H, int W,
                    void* stream) {
  fk_link_kernel<<<site_grid(H * W, 1, n_graphs), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent), H, W);
  return static_cast<int>(cudaGetLastError());
}

// labels: int32 [n_graphs, H*W] or null; e_part / m_part: [n_graphs,
// peapods_fk_blocks(H, W)], or both null.
int peapods_fk_finish(void* spins, const void* state, void* parent, void* labels,
                      const void* j_fwd, const void* scalars, void* e_part,
                      void* m_part, int n_graphs, int n_systems, int H, int W,
                      int wolff, void* stream) {
  fk_finish_kernel<<<site_grid(H * W, 1, n_graphs), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const uint8_t*>(state),
      static_cast<int32_t*>(parent), static_cast<int32_t*>(labels),
      static_cast<const float*>(j_fwd), static_cast<const int32_t*>(scalars),
      static_cast<float*>(e_part),
      static_cast<int32_t*>(m_part), H, W, n_systems, wolff);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
