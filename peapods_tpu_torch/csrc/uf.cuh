// Device helpers shared by the cluster kernels (fk.cu, overlap.cu, cc.cu,
// cc_band.cu, winding.cu): the salted per-cluster coin, the union-find in
// global memory whose roots are each component's minimum site index
// (find_root, unite: between tile or box roots, fk.cu's and cc.cu's
// borders), and the union-find of a tile in shared memory (tile_root,
// tile_unite).
#pragma once

#include <cstddef>
#include <cstdint>

#include "mega.cuh"
#include "nb.cuh"

namespace peapods {

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
// is its sites' global order (cc_band.cu: band_key's; fk.cu, cc.cu: the
// site index's), so each tile component's root is its smallest site.
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

}  // namespace peapods
