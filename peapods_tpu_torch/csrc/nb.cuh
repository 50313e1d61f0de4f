// The geometry of a lattice given by its forward offsets (up to six), shared
// by the coloured sweep's measurement (sweep_nb.cu measure_nb, the one
// kernel left that finds coordinates and neighbours with coords / neighbour:
// runtime divisions and modulos) and the band kernels (band.cuh, whose
// BandWalk the division-free kernels of sweep_nb.cu, fk.cu and halo.cu
// take); cc.cu takes its offset count: extents, row-major strides and the
// offsets, each axis wrapped on its own (rem_euclid); a 2D lattice is
// [L0, L1, 1].
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

// The site at coordinates c + sign * off_d.
__device__ __forceinline__ int neighbour(const NbGeom& g, const int c[3], int d,
                                         int sign) {
  int j = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) j += wrap(c[k] + sign * g.off[d][k], g.L[k]) * g.stride[k];
  return j;
}

__device__ __forceinline__ void coords(const NbGeom& g, int i, int c[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = (i / g.stride[k]) % g.L[k];
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
