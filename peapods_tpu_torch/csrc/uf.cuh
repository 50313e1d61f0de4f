// Device helpers shared by the cluster kernels (fk.cu, overlap.cu, cc.cu,
// cc_band.cu): the periodic neighbours of a 2D or 3D lattice (and of the
// triangular lattice's third bond direction), the salted per-cluster coin,
// the union-find in global memory whose roots are each component's minimum
// site index (find_root, unite; linked along any offset table, nb.cuh, or
// between tile roots, fk.cu's border), and the union-find of a tile in
// shared memory (tile_root, tile_unite).
#pragma once

#include <cstddef>
#include <cstdint>

#include "mega.cuh"
#include "nb.cuh"

namespace peapods {

// Extents and strides of a row-major periodic lattice: 2D is [L0, L1]
// (pass L2 = 1), 3D is [L0, L1, L2].  Bond direction d < nd is +1 along
// axis d; the triangular lattice (tri, 2D) adds direction 2, offset
// [1, -1], each axis wrapped on its own (pallas_cc_batch.dir_shifts).
struct Dims {
  int nd;    // axes
  int ndir;  // bond directions: nd, or 3 on the triangular lattice
  bool tri;
  int n[3];
  int stride[3];
};

__host__ __device__ inline Dims make_dims(int L0, int L1, int L2, bool tri = false) {
  Dims g;
  g.nd = L2 > 1 ? 3 : 2;
  g.tri = tri;
  g.ndir = tri ? 3 : g.nd;
  g.n[0] = L0;
  g.n[1] = L1;
  g.n[2] = L2;
  g.stride[0] = L1 * L2;
  g.stride[1] = L2;
  g.stride[2] = 1;
  return g;
}

// One step forward / backward along axis a, periodic.
__device__ __forceinline__ int step_fwd(int i, const Dims& g, int a) {
  const int s = g.stride[a];
  const int L = g.n[a];
  return (i / s) % L == L - 1 ? i - (L - 1) * s : i + s;
}

__device__ __forceinline__ int step_bwd(int i, const Dims& g, int a) {
  const int s = g.stride[a];
  const int L = g.n[a];
  return (i / s) % L == 0 ? i + (L - 1) * s : i - s;
}

__device__ __forceinline__ int fwd_site(int i, const Dims& g, int dir) {
  if (g.tri && dir == 2) return step_bwd(step_fwd(i, g, 0), g, 1);  // (i+1, j-1)
  return step_fwd(i, g, dir);
}

__device__ __forceinline__ int bwd_site(int i, const Dims& g, int dir) {
  if (g.tri && dir == 2) return step_fwd(step_bwd(i, g, 0), g, 1);  // (i-1, j+1)
  return step_bwd(i, g, dir);
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

// Hang the larger root under the smaller with atomicCAS, retrying from the
// new parent when another thread got there first (Komura 2015; Playne &
// Hawick 2018; the ECL-CC hooking of Jaiganesh & Burtscher 2018).  Parents
// only ever point to a smaller index, so once every union is done each
// component is one tree whose root is its minimum site index, whatever
// order the threads ran in: the reference's min-label fixed point.
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

// Root of x in the tile's shared parents, halving the path on the way
// (only non-roots are written, so a root's CAS never races a halving).
__device__ __forceinline__ int tile_root(int* P, int x) {
  volatile int* V = P;
  while (true) {
    const int p = V[x];
    if (p == x) return x;
    const int gp = V[p];
    if (gp == p) return p;
    V[x] = gp;
    x = gp;
  }
}

// Join the trees of x and y in the tile's shared parents: the larger root
// takes the smaller as its parent (atomicMin); where the larger was hung
// elsewhere meanwhile, its old parent is joined next.  A tile's site order
// is its sites' global order (cc_band.cu: band_key's; fk.cu: the site
// index's), so each tile component's root is its smallest site.
__device__ __forceinline__ void tile_unite(int* P, int x, int y) {
  while (true) {
    x = tile_root(P, x);
    y = tile_root(P, y);
    if (x == y) return;
    if (x < y) {
      const int t = x;
      x = y;
      y = t;
    }
    const int old = atomicMin(P + x, y);
    if (old == x) return;
    x = old;
  }
}

// Unite site i with its neighbours at the forward offsets of an offset
// table along the bonds set in bits 0 .. n_nb-1 of its state byte (cc.cu);
// a self-bond (an offset that wraps onto the site) unites i with itself,
// a no-op.
__device__ __forceinline__ void link_site_nb(int32_t* P, uint8_t st, int i,
                                             const NbGeom& g) {
  int c[3];
  coords(g, i, c);
  for (int d = 0; d < g.n_nb; ++d)
    if ((st >> d) & 1u) unite(P, i, neighbour(g, c, d, 1));
}

// Whether site i has a bond (bits 0 .. ndir-1 of the state bytes): its own
// forward bonds or its backward neighbours' forward bonds towards it.
__device__ __forceinline__ bool nonsingleton(const uint8_t* state, int i,
                                             const Dims& g) {
  if (state[i] & ((1u << g.ndir) - 1u)) return true;
  for (int dir = 0; dir < g.ndir; ++dir)
    if ((state[bwd_site(i, g, dir)] >> dir) & 1u) return true;
  return false;
}

}  // namespace peapods
