// Hopper kernel of FK observe's winding flags: per 2D square bond graph of
// a batch, does any component wrap the torus along axis 0 (x) / axis 1 (y).
//
// Replaces the TPU's peapods_tpu/ops/pallas_cc_batch.py:572 winding_batch
// (kernel _winding_kernel :501); its plain version is the jnp settle loop
// cluster.winding_flags (peapods_tpu/ops/cluster.py:612, the port's
// ops/cluster.winding_flags).
//
//   winding   one block per graph.  From each component's root (label ==
//             site) an unwrapped displacement potential (d0, d1) is
//             settled along the active bonds, breadth first: the roots
//             start the queue, and each level's sites settle their
//             unsettled neighbours across active bonds (d = d_f +- off),
//             claiming each with an atomicOr on a settled bitmap in shared
//             memory, so that a site settles once and is queued once; a
//             barrier separates the levels.  The work is one visit a site,
//             the rounds the depth of the breadth-first trees.  Then an
//             active bond (i, i+off) with d[i+off] - d[i] != off flags its
//             axes.  The flags do not depend on which tree settles a site:
//             a spanning-tree potential violates a chord iff the chord's
//             cycle winds (pallas_cc_batch.py:505-516).  If the queue ends
//             short of n sites, the labels do not belong to the masks: the
//             kernel sets the error word, which the wrapper raises on.  The
//             graph's flags are bits 0 (x) and 1 (y) of its output byte.
//
// What bounds it on the H100: the masks and labels are read and one byte a
// graph is written (at 64^2 x 2048 graphs 50 MB, 15 us at 3.35 TB/s).  The
// levels are the cost at 256^2: one block owns the graph, and near T_c the
// breadth-first depth of a spanning cluster is hundreds of levels, each a
// barrier and a few dependent loads.  Several blocks per graph is later
// work (ROADMAP queue 3).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWindMaxThreads = 1024;

__device__ __forceinline__ unsigned long long pack(uint32_t d0, uint32_t d1) {
  return (static_cast<unsigned long long>(d0) << 32) | d1;
}

__device__ __forceinline__ uint32_t hi(unsigned long long w) {
  return static_cast<uint32_t>(w >> 32);
}

__device__ __forceinline__ uint32_t lo(unsigned long long w) {
  return static_cast<uint32_t>(w);
}

// Settle site j from f across an active bond (d_j = d_f + (s0, s1)) unless
// it is settled already, and queue it.
__device__ __forceinline__ void visit(uint32_t* settled, int* tail, int32_t* Q,
                                      unsigned long long* D, int j,
                                      unsigned long long wf, int s0, int s1) {
  const uint32_t bit = 1u << (j & 31);
  if (settled[j >> 5] & bit) return;
  if (atomicOr(&settled[j >> 5], bit) & bit) return;
  D[j] = pack(hi(wf) + s0, lo(wf) + s1);
  Q[atomicAdd(tail, 1)] = j;
}

// masks: uint8 [B, n, 2] (bond to (r+1, c), bond to (r, c+1)); labels:
// int32 [B, n]; disp: [B, n], queue: [B, n] scratch; out: uint8 [B].
__global__ void __launch_bounds__(kWindMaxThreads)
winding_kernel(const uint8_t* __restrict__ masks, const int32_t* __restrict__ labels,
               unsigned long long* disp, int32_t* queue, uint8_t* __restrict__ out,
               int* err, int L0, int L1) {
  extern __shared__ uint32_t settled[];
  __shared__ int tail;
  const int n = L0 * L1;
  const int n_words = (n + 31) / 32;
  const size_t b = blockIdx.x;
  const uint8_t* M = masks + b * n * 2;
  const int32_t* lab = labels + b * n;
  unsigned long long* D = disp + b * n;
  int32_t* Q = queue + b * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  if (tid == 0) tail = 0;
  __syncthreads();
  // the roots start settled at displacement 0, and start the queue
  for (int wd = warp; wd < n_words; wd += n_warps) {
    const int i = wd * 32 + lane;
    const bool root = i < n && lab[i] == i;
    const uint32_t bits = __ballot_sync(0xffffffffu, root);
    int base = 0;
    if (lane == 0) {
      settled[wd] = bits;
      base = atomicAdd(&tail, __popc(bits));
    }
    base = __shfl_sync(0xffffffffu, base, 0);
    if (root) {
      D[i] = 0ull;
      Q[base + __popc(bits & ((1u << lane) - 1u))] = i;
    }
  }
  __syncthreads();

  // one breadth-first level a round; the reference's neighbour order (axis
  // 0 forward, backward; axis 1 forward, backward)
  int begin = 0;
  int end = tail;
  while (begin < end) {
    for (int k = begin + tid; k < end; k += blockDim.x) {
      const int f = Q[k];
      const unsigned long long wf = D[f];
      const int r = f / L1, c = f - r * L1;
      const int dn = (r + 1 == L0 ? 0 : r + 1) * L1 + c;  // (r+1, c)
      const int up = (r == 0 ? L0 - 1 : r - 1) * L1 + c;  // (r-1, c)
      const int rt = r * L1 + (c + 1 == L1 ? 0 : c + 1);  // (r, c+1)
      const int lf = r * L1 + (c == 0 ? L1 - 1 : c - 1);  // (r, c-1)
      if (__ldg(M + 2 * f)) visit(settled, &tail, Q, D, dn, wf, 1, 0);
      if (__ldg(M + 2 * up)) visit(settled, &tail, Q, D, up, wf, -1, 0);
      if (__ldg(M + 2 * f + 1)) visit(settled, &tail, Q, D, rt, wf, 0, 1);
      if (__ldg(M + 2 * lf + 1)) visit(settled, &tail, Q, D, lf, wf, 0, -1);
    }
    __syncthreads();
    begin = end;
    end = tail;
    __syncthreads();  // every thread has read tail before the next level adds
  }
  if (end != n) {  // sites left unsettled: the labels do not belong to the masks
    if (tid == 0) atomicOr(err, 1);
    return;
  }

  int vx = 0, vy = 0;
  for (int i = tid; i < n; i += blockDim.x) {
    const int r = i / L1, c = i - r * L1;
    const unsigned long long wi = D[i];
    if (__ldg(M + 2 * i)) {
      const unsigned long long wj = D[(r + 1 == L0 ? 0 : r + 1) * L1 + c];
      vx |= hi(wj) - hi(wi) - 1u != 0u;
      vy |= lo(wj) - lo(wi) != 0u;
    }
    if (__ldg(M + 2 * i + 1)) {
      const unsigned long long wj = D[r * L1 + (c + 1 == L1 ? 0 : c + 1)];
      vx |= hi(wj) - hi(wi) != 0u;
      vy |= lo(wj) - lo(wi) - 1u != 0u;
    }
  }
  vx = __syncthreads_or(vx);
  vy = __syncthreads_or(vy);
  if (tid == 0) out[b] = static_cast<uint8_t>(vx | (vy << 1));
}

}  // namespace

extern "C" {

// The largest graph one block takes: its settled bitmap fills at most the
// 227 KB of shared memory a block may use.
int peapods_winding_max_sites() { return 227 * 1024 * 8; }

// One block per graph of an [L0, L1] square lattice, a thread per 16 sites
// (32 to 1024); disp: [n_graphs, n] 64-bit and queue: [n_graphs, n] int32
// scratch; out: uint8 [n_graphs] (bit 0: x, bit 1: y); err: one int that a
// graph whose labels do not belong to its masks sets to 1.
int peapods_winding(const void* masks, const void* labels, void* disp, void* queue,
                    void* out, void* err, int n_graphs, int L0, int L1, void* stream) {
  const int n = L0 * L1;
  int threads = (n / 16 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > kWindMaxThreads ? kWindMaxThreads : threads;
  const size_t smem = static_cast<size_t>((n + 31) / 32) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        winding_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  winding_kernel<<<n_graphs, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(masks), static_cast<const int32_t*>(labels),
      static_cast<unsigned long long*>(disp), static_cast<int32_t*>(queue),
      static_cast<uint8_t*>(out), static_cast<int*>(err), L0, L1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
