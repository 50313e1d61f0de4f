// The geometry of one row band of a lattice split over a "space" mesh
// (ops/lattice.Band), shared by the halo sweep (halo.cu), the band-local
// connected components (cc_band.cu) and the FK band forms (fk.cu).
//
// A band owns rows row0 .. row0 + hl - 1 of the lattice's leading axis and
// is held in a window of hl + 2 halo rows: window row r is global row
// (row0 - halo + r) mod L0, so its first and last halo rows are copies of
// the neighbouring bands' edge rows.  The window is the NbGeom of
// [hl + 2 halo, L1, L2] (nb.cuh), periodic along axes 1 and 2 and not along
// axis 0: an interior site's neighbours at |offset[0]| <= halo all lie in
// the window.
#pragma once

#include <cstdint>

#include "nb.cuh"

namespace peapods {

struct BandGeom {
  NbGeom w;   // the window, L[0] = hl + 2 halo
  int L0;     // the lattice's extent along axis 0
  int row0;   // global row of the first interior row
  int halo;   // halo rows on each side
  int hl;     // interior rows
  int block;  // sites per row, L1 L2
};

// words: the window's NbGeom words (make_geom), then L0, row0, halo, hl
// (host memory; ops/lattice.Band.words).
inline BandGeom make_band_geom(const int* words) {
  BandGeom g;
  g.w = make_geom(words);
  const int* tail = words + 4 + 3 * kMaxOffsets;
  g.L0 = tail[0];
  g.row0 = tail[1];
  g.halo = tail[2];
  g.hl = tail[3];
  g.block = g.w.L[1] * g.w.L[2];
  return g;
}

// The window site at coordinates c + sign * off_d, axes 1 and 2 periodic;
// -1 when the step leaves the window along axis 0.
__device__ __forceinline__ int window_neighbour(const BandGeom& g, const int c[3],
                                                int d, int sign) {
  const int r = c[0] + sign * g.w.off[d][0];
  if (r < 0 || r >= g.w.L[0]) return -1;
  return r * g.w.stride[0] + wrap(c[1] + sign * g.w.off[d][1], g.w.L[1]) * g.w.stride[1] +
         wrap(c[2] + sign * g.w.off[d][2], g.w.L[2]);
}

// The lattice's site index of window site w.
__device__ __forceinline__ int window_global(const BandGeom& g, int w) {
  const int r = w / g.block;
  return wrap(g.row0 - g.halo + r, g.L0) * g.block + (w - r * g.block);
}

// Word (i & 3) of a Philox block.
__device__ __forceinline__ uint32_t philox_word(const uint4& r, int i) {
  switch (i & 3) {
    case 0: return r.x;
    case 1: return r.y;
    case 2: return r.z;
    default: return r.w;
  }
}

}  // namespace peapods
