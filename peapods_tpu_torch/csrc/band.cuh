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
//
// The band kernels of fk.cu and halo.cu find coordinates and neighbours
// with no runtime division (the H100 has no integer divide instruction: a
// `/` or `%` by a runtime value is a sequence of about twenty):
// band_coords divides by a multiplier and a shift (CUTLASS's FastDivmod,
// cutlass/fast_math.h), band_neighbour steps each periodic axis by the
// residue off mod L with one compare, exact for any offset.  The host
// computes both into the band's words (ops/lattice.Band.words), read into
// a BandWalk: a BandGeom followed by them, the one parameter those kernels
// take.  They are not fields of BandGeom: cc_band.cu's kernels, which take
// a BandGeom and need neither, used 40 registers in place of 32 and ran
// 9-13% longer with the larger parameter; and fk_finish_band took 40
// registers in place of 32, and ran 4-5% longer, given them as a second
// parameter (tools/probe_band_kernels.py, NVIDIA H100 80GB HBM3).
#pragma once

#include <cstdint>

#include "nb.cuh"

namespace peapods {

// The divisors of band_coords and the square form's colour rows.
enum { kDivBlock = 0, kDivL2 = 1, kDivHalfRow = 2, kDivisors = 3 };

struct BandGeom {
  NbGeom w;   // the window, L[0] = hl + 2 halo
  int L0;     // the lattice's extent along axis 0
  int row0;   // global row of the first interior row
  int halo;   // halo rows on each side
  int hl;     // interior rows
  int block;  // sites per row, L1 L2
};

// words: the window's NbGeom words (make_geom), then L0, row0, halo, hl,
// then make_band_walk's (host memory; ops/lattice.Band.words).
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

// The geometry and its division-free steps, in one parameter.
struct BandWalk : BandGeom {
  // per offset d: off[d][1] mod L1, off[d][2] mod L2, -off[d][1] mod L1,
  // -off[d][2] mod L2 (each in [0, L))
  int res[kMaxOffsets][4];
  // n / L1 L2, n / L2, n / (L1 / 2) as umulhi(n, m) >> s for 0 <= n < 2^31;
  // m = 0 for a divisor of 1
  uint32_t div_m[kDivisors];
  int div_s[kDivisors];
};

// words: as make_band_geom's; the residues, then (m, s) of each divisor.
inline BandWalk make_band_walk(const int* words) {
  BandWalk g;
  static_cast<BandGeom&>(g) = make_band_geom(words);
  const int* res = words + 4 + 3 * kMaxOffsets + 4;
  for (int d = 0; d < kMaxOffsets; ++d)
    for (int k = 0; k < 4; ++k) g.res[d][k] = res[4 * d + k];
  const int* div = res + 4 * kMaxOffsets;
  for (int k = 0; k < kDivisors; ++k) {
    g.div_m[k] = static_cast<uint32_t>(div[2 * k]);
    g.div_s[k] = div[2 * k + 1];
  }
  return g;
}

// n / divisor k of the band, for 0 <= n < 2^31.
__device__ __forceinline__ int band_div(const BandWalk& g, int k, int n) {
  return g.div_m[k]
             ? static_cast<int>(__umulhi(static_cast<uint32_t>(n), g.div_m[k]) >>
                                g.div_s[k])
             : n;
}

// Coordinates (c1, c2) along axes 1 and 2 of window or interior site i;
// returns its row, i / L1 L2.
__device__ __forceinline__ int band_coords(const BandWalk& g, int i, int& c1, int& c2) {
  const int r = band_div(g, kDivBlock, i);
  const int p = i - r * g.block;
  c1 = band_div(g, kDivL2, p);
  c2 = p - c1 * g.w.L[2];
  return r;
}

// (c1, c2) of the next site in index order.
__device__ __forceinline__ void band_next(const BandGeom& g, int& c1, int& c2) {
  if (++c2 == g.w.L[2]) {
    c2 = 0;
    if (++c1 == g.w.L[1]) c1 = 0;
  }
}

// The window index of the neighbour of window site w (coordinates c1, c2
// along axes 1, 2) at +off_d (back = false) or -off_d, axes 1 and 2
// periodic; the caller keeps it in the window (|off_d[0]| <= halo from an
// interior site).  d must be known at compile time (an unrolled loop): a
// runtime index into the geometry puts it in local memory.
__device__ __forceinline__ int band_neighbour(const BandWalk& g, int w, int c1, int c2, int d,
                                              bool back) {
  int n1 = c1 + g.res[d][back ? 2 : 0];
  if (n1 >= g.w.L[1]) n1 -= g.w.L[1];
  int n2 = c2 + g.res[d][back ? 3 : 1];
  if (n2 >= g.w.L[2]) n2 -= g.w.L[2];
  return w + (back ? -g.w.off[d][0] : g.w.off[d][0]) * g.block + (n1 - c1) * g.w.L[2] +
         (n2 - c2);
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
