// The geometry of a lattice given by its forward offsets (up to six):
// extents, row-major strides and the offsets, a 2D lattice as [L0, L1, 1].
// The band kernels hold it as their window (band.cuh, whose BandWalk the
// division-free kernels of sweep_nb.cu, fk.cu and halo.cu take: residues
// and multiply-shift divisors in place of coordinates by division); cc.cu
// takes its offset count.  wrap, a rem_euclid by a runtime modulo, serves
// cc_band.cu's steps off a tile and band.cuh's window_global.
#pragma once

#include <cstdint>

namespace peapods {

constexpr int kMaxOffsets = 6;

// Extents, strides and forward offsets of a lattice ([L0, L1, 1] in 2D).
struct NbGeom {
  int L[3];
  int stride[3];
  int n_nb;
  int off[kMaxOffsets][3];
};

__device__ __forceinline__ int wrap(int x, int L) {
  x %= L;
  return x < 0 ? x + L : x;
}

// geom: L0, L1, L2, n_nb, then kMaxOffsets x 3 offsets (host memory; the
// words of ops/lattice.Lattice.kernel_geometry).
inline NbGeom make_geom(const int* geom) {
  NbGeom g;
  for (int k = 0; k < 3; ++k) g.L[k] = geom[k];
  g.stride[2] = 1;
  g.stride[1] = g.L[2];
  g.stride[0] = g.L[1] * g.L[2];
  g.n_nb = geom[3];
  for (int d = 0; d < kMaxOffsets; ++d)
    for (int k = 0; k < 3; ++k) g.off[d][k] = geom[4 + 3 * d + k];
  return g;
}

}  // namespace peapods
