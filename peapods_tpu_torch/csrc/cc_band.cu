// Hopper kernels of the band-local connected components: the FK bond graphs
// of a lattice split into row bands over a "space" mesh, labelled band by
// band so that every window site (the halo sites too) gets its component's
// minimum global site index, bitwise the unsharded labelling (fk_link,
// cc_link / cc_label).
//
// Replaces the TPU's peapods_tpu/ops/pallas_cc_band.py:198 band_cc_batch
// (kernel _band_kernel :169: the min-label fixed point of one band with its
// two halo label rows, inside the outer loop of
// peapods_tpu/ops/cluster.py:194 connected_components_banded).  The TPU
// propagated labels in rounds, with a label exchange between bands after
// each; here each window is labelled by a union-find and the bands meet once,
// in a union-find over their boundary rows (the block-based union-find of
// Playne and Hawick and of Allegretti, Bolelli and Grana, cut to a band).
//
// Each band keeps, per graph and window site (the band's rows and a halo of
// the neighbouring bands' edge rows, band.cuh): the bond bits of the state
// byte (fk.cu fk_bonds_band writes them for every window site whose forward
// neighbour lies in the window, so every bond that touches the band is
// there), a union-find parent, the site's label and cmin, a slot per root.
// A band's boundary slots are its sites of the top halo, top edge, bottom
// edge and bottom halo rows, in that order: E = 4 halo L1 L2 a graph.  One
// FK phase is a fixed sequence:
//
//   cc_band_link     per band: a block owns a tile of the window (whole
//                    L2 lines in 3D, 128-wide row pieces in 2D, the top
//                    halo, the band's rows and the bottom halo tiled
//                    apart; up to 8192 sites, fewer where a small window
//                    would leave SMs idle).  It stages the tile's state
//                    bytes in shared memory, hangs each run of fast-axis
//                    bonds inside a warp under its first site (a ballot),
//                    unites the other bonds inside the tile with a
//                    union-find in shared memory, and writes each site's
//                    parent: its tile component's smallest site, which in
//                    such a tile is the smallest (global index, window
//                    index), band_key.  It sets cmin = no slot at the tile
//                    roots.
//   cc_band_border   per band: the bonds that cross a tile edge (read from
//                    the tiles' shells), united as pairs of tile roots in
//                    global memory with atomicCAS, the root of larger
//                    band_key hung under the smaller, so every window
//                    component's root is its site of smallest band_key:
//                    its minimum global index.
//   cc_band_flatten  per band: every parent becomes its root; each boundary
//                    site lowers cmin[root] to its slot (atomicMin, only
//                    when it would lower it), so cmin[root] is the
//                    component's smallest slot, its representative.
//   cc_band_export   per band: each slot's representative, as a node of
//                    the merge (band E + slot), and its root's global
//                    index, into the merge buffers [n_bands, G, E] on the
//                    mesh's first device.
//   cc_band_merge    once, on the first device: a union-find over the
//                    n_bands E nodes of each graph, which start hung under
//                    their representatives (the slots of one root), joining
//                    each halo slot with the slot of the same global site
//                    in the band that owns it (one band owns its own
//                    halos); the root of smaller (global index, node) wins.
//   cc_band_resolve  once: each node takes its set root's global index, the
//                    set's minimum.
//   cc_band_write    per band: every window site takes its root's set
//                    minimum, or, where the root has no slot, the root's
//                    own global index: a window component with no boundary
//                    site has no bond that leaves the band (a bond that
//                    crosses a band edge joins an edge row to a halo row,
//                    and both lie in the window), so it is a whole
//                    component.
//
// Every window component's root is its minimum global site, so a set's
// minimum over its roots is the minimum of every global component that
// meets the boundary rows; the halo sites take the same values as the sites
// they copy.  The launches do not depend on the data: 5 a band and 2, no
// host sync and no label exchange between bands.
//
// What bounds it on the H100: the least bytes of a labelling are the state
// byte in and the label out, 5 bytes a window site (0.100 ms for a 4096^2
// lattice in 4 bands of 4 graphs at 3.35 TB/s).  The sequence moves about
// 22 (the link reads the state bytes and writes the parents, the border
// pass reads the state bytes again, the flatten reads and writes the
// parents, the write reads the parents and writes the labels), but what
// holds it back is the union-find inside the tiles: near T_c most of the
// link's time is its unions in shared memory (dependent loads, atomics and
// the divergence of a warp's finds), not its bytes.  The chains of a
// spanning cluster stay in shared memory; only a few percent of the bonds
// cross a tile edge.  An earlier design linked every bond in global memory and
// ran min-label rounds until no band's labels fell: about 9 rounds an FK
// phase at 4096^2 in 4 bands, each a launch pair a band, a label exchange
// and a host sync.  (Tried and dropped, each slower at 4096^2: band_key
// computed in every union, runtime-indexed offsets, which put the geometry
// in local memory, deduplicating a warp's unions, skipping the rungs of
// ladders, and uniting rows level by level.)

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "band.cuh"

using namespace peapods;

namespace {

constexpr int kBandThreads = 256;
constexpr int kTileThreads = 512;
constexpr int kTileSites = 8192;  // parents and state bytes: 40 KB of shared memory
constexpr int kMinBlocks = 1024;
constexpr int kNoSlot = INT_MAX;

// The tiles of a band's window: extents t along each axis; axis 0 is tiled
// apart in the top halo, the band's rows and the bottom halo (n0h, n0b,
// n0h tiles), so that no tile holds a row whose global row wraps or repeats
// and a tile's site order is band_key's.  A block's threads run along the
// fast axis (2 in 3D, 1 in 2D); d_fast is the offset that steps +1 along it
// (-1: none); reach[k] is the offsets' largest step along axis k, so only
// sites within it of a tile's face have bonds that leave the tile.
struct Tile {
  int t[3];
  int n1, n2, n0h, n0b;
  int fast, d_fast;
  int reach[3];
};

// Tiles of `sites` sites at most: whole L2 lines up to 128 sites; then 128
// sites along axis 1 in 2D, a square of lines in 3D; then as many rows as
// fit.
inline Tile make_tile(const BandGeom& g, int sites) {
  const int* L = g.w.L;
  Tile t;
  t.t[2] = L[2] < 128 ? L[2] : 128;
  const int rem = sites / t.t[2] > 0 ? sites / t.t[2] : 1;
  int w1 = 128;
  if (L[2] > 1)
    for (w1 = 1; (2 * w1) * (2 * w1) <= rem;) w1 *= 2;
  t.t[1] = L[1] < w1 ? L[1] : w1;
  t.t[0] = L[0] < rem / t.t[1] ? L[0] : rem / t.t[1] > 0 ? rem / t.t[1] : 1;
  t.n1 = (L[1] + t.t[1] - 1) / t.t[1];
  t.n2 = (L[2] + t.t[2] - 1) / t.t[2];
  t.n0h = (g.halo + t.t[0] - 1) / t.t[0];
  t.n0b = (g.hl + t.t[0] - 1) / t.t[0];
  t.fast = L[2] > 1 ? 2 : 1;
  t.d_fast = -1;
  for (int k = 0; k < 3; ++k) t.reach[k] = 0;
  for (int d = g.w.n_nb - 1; d >= 0; --d) {
    bool unit = true;
    for (int k = 0; k < 3; ++k) {
      const int o = g.w.off[d][k];
      unit = unit && o == (k == t.fast);
      t.reach[k] = o > t.reach[k] ? o : -o > t.reach[k] ? -o : t.reach[k];
    }
    if (unit) t.d_fast = d;
  }
  return t;
}

inline int n_tiles(const Tile& t) { return (2 * t.n0h + t.n0b) * t.n1 * t.n2; }

// The largest tiles that still give the card about kMinBlocks blocks (a
// small window in large tiles leaves most SMs idle), down to 512 sites.
inline Tile band_tiles(const BandGeom& g, int n_graphs) {
  int sites = kTileSites;
  Tile t = make_tile(g, sites);
  while (sites > 512 && static_cast<long long>(n_tiles(t)) * n_graphs < kMinBlocks)
    t = make_tile(g, sites /= 2);
  return t;
}

inline dim3 tile_grid(const Tile& t, int n_graphs) { return dim3(n_tiles(t), n_graphs); }

inline dim3 tile_block(const Tile& t) {
  return dim3(t.t[t.fast], kTileThreads / t.t[t.fast]);
}

// One tile: its origin and extents in the window.
struct TileBox {
  int o[3];
  int e[3];
};

__device__ __forceinline__ TileBox tile_box(const BandGeom& g, const Tile& t, int tile) {
  TileBox b;
  const int i2 = tile % t.n2;
  tile /= t.n2;
  const int i1 = tile % t.n1;
  int i0 = tile / t.n1;
  b.o[2] = i2 * t.t[2];
  b.e[2] = min(t.t[2], g.w.L[2] - b.o[2]);
  b.o[1] = i1 * t.t[1];
  b.e[1] = min(t.t[1], g.w.L[1] - b.o[1]);
  int start = 0, len = g.halo;  // the top halo, the band's rows, the bottom halo
  if (i0 >= t.n0h) {
    i0 -= t.n0h;
    start = g.halo;
    len = g.hl;
    if (i0 >= t.n0b) {
      i0 -= t.n0b;
      start = g.halo + g.hl;
      len = g.halo;
    }
  }
  b.o[0] = start + i0 * t.t[0];
  b.e[0] = min(t.t[0], start + len - b.o[0]);
  return b;
}

// Tile coordinates of the site at slow index s and fast coordinate x (the
// tile's site s * e_fast + x).
__device__ __forceinline__ void tile_coords(const Tile& t, const TileBox& b, int s, int x,
                                            int c[3]) {
  if (t.fast == 2) {
    c[0] = s / b.e[1];
    c[1] = s - c[0] * b.e[1];
    c[2] = x;
  } else {
    c[0] = s;
    c[1] = x;
    c[2] = 0;
  }
}

// The tile's site at tile coordinates c + off_d, or -1 outside the tile;
// axes 1 and 2 wrap inside a tile that spans them.
__device__ __forceinline__ int tile_step(const BandGeom& g, const TileBox& b, const int c[3],
                                         int d) {
  int l = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int x = c[k] + g.w.off[d][k];
    if (k > 0 && b.e[k] == g.w.L[k] && (x < 0 || x >= b.e[k])) x = wrap(x, b.e[k]);
    if (x < 0 || x >= b.e[k]) return -1;
    l = l * b.e[k] + x;
  }
  return l;
}

// Window index of the site at tile coordinates c (+ off_d when d >= 0;
// axes 1 and 2 periodic).
__device__ __forceinline__ int box_window(const BandGeom& g, const TileBox& b, const int c[3],
                                          int d) {
  int w = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int x = b.o[k] + c[k] + (d >= 0 ? g.w.off[d][k] : 0);
    if (k > 0 && (x < 0 || x >= g.w.L[k])) x = wrap(x, g.w.L[k]);
    w += x * g.w.stride[k];
  }
  return w;
}

// The order of a window site: (global index, window index), so that a halo
// row that repeats the band's own rows (one band) never ties.
__device__ __forceinline__ long long band_key(const BandGeom& g, int w) {
  return static_cast<long long>(window_global(g, w)) * (g.w.L[0] * g.block) + w;
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
// elsewhere meanwhile, its old parent is joined next.  In a tile the site
// order is band_key's.
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

// Root of x in a band's global parents, halving the path on the way
// (parents follow band_key, not the window index, so the root is the node
// that is its own parent).
__device__ __forceinline__ int band_root(int32_t* P, int x) {
  int prev = x;
  int cur = __ldcg(P + x);
  if (cur == x) return x;
  int next;
  while ((next = __ldcg(P + cur)) != cur) {
    P[prev] = next;
    prev = cur;
    cur = next;
  }
  return cur;
}

// Hang the root of larger band_key under the smaller with atomicCAS,
// retrying from the new parent when another thread got there first.
__device__ __forceinline__ void band_unite(int32_t* P, const BandGeom& g, int a, int b) {
  a = band_root(P, a);
  b = band_root(P, b);
  while (a != b) {
    if (band_key(g, a) < band_key(g, b)) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(P + a, a, b);
    if (old == a) return;
    a = band_root(P, old);
  }
}

// The boundary slot of window site w (the top halo and top edge rows, then
// the bottom edge and bottom halo rows), or -1.  Where a band is thinner
// than two halos a row is both a top and a bottom edge: the top slot, the
// smaller, is the one returned.
__device__ __forceinline__ int edge_slot(const BandGeom& g, int w) {
  const int top = 2 * g.halo * g.block;
  if (w < top) return w;
  const int lo = g.hl * g.block;
  return w >= lo ? w - lo + top : -1;
}

__device__ __forceinline__ int slot_window(const BandGeom& g, int s) {
  const int top = 2 * g.halo * g.block;
  return s < top ? s : s - top + g.hl * g.block;
}

// The tile's state bytes into S, every load issued before any is used.
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ state, uint8_t* S,
                                          const BandGeom& g, const Tile& t, const TileBox& b,
                                          int n_slow, int ef) {
  const unsigned mask = (1u << g.w.n_nb) - 1u;
  if (threadIdx.x >= ef) return;
#pragma unroll 4
  for (int s = threadIdx.y; s < n_slow; s += blockDim.y) {
    int c[3];
    tile_coords(t, b, s, threadIdx.x, c);
    S[s * ef + threadIdx.x] = state[box_window(g, b, c, -1)] & mask;
  }
}

// A block labels one tile: (1) its state bytes into shared memory, then
// each run of fast-axis bonds inside a warp hung under its first site (a
// ballot, no atomics); (2) the other bonds inside the tile united; (3)
// each site's parent is its tile root's window index, and each tile root's
// cmin is reset.
// (The loops over the offsets are unrolled so that no array is indexed at
// run time: such an index puts the geometry in local memory.)
__global__ void __launch_bounds__(kTileThreads)
cc_band_link_kernel(const uint8_t* __restrict__ state, int32_t* __restrict__ parent,
                    int32_t* __restrict__ cmin, const BandGeom g, const Tile t) {
  __shared__ int P[kTileSites];
  __shared__ uint8_t S[kTileSites];
  const unsigned lanes = __activemask();
  const size_t base = static_cast<size_t>(blockIdx.y) * g.w.L[0] * g.block;
  const TileBox b = tile_box(g, t, blockIdx.x);
  const int ef = t.fast == 2 ? b.e[2] : b.e[1];
  const int x = threadIdx.x;
  const int n_slow = b.e[0] * (t.fast == 2 ? b.e[1] : 1);
  const int iters = (n_slow + blockDim.y - 1) / blockDim.y;
  const int lane = (threadIdx.y * blockDim.x + x) & 31;
  load_tile(state + base, S, g, t, b, n_slow, ef);
  __syncthreads();
  for (int k = 0; k < iters; ++k) {
    const int l = (threadIdx.y + k * blockDim.y) * ef + x;
    const bool on = l < n_slow * ef && x < ef;
    const bool run = on && t.d_fast >= 0 && ((S[l] >> t.d_fast) & 1u) && x + 1 < ef;
    const unsigned starts = ~(__ballot_sync(lanes, run) << 1);
    const int first = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
    if (on) P[l] = l - (lane - first);
  }
  __syncthreads();
  for (int k = 0; k < iters; ++k) {
    const int s = threadIdx.y + k * blockDim.y;
    if (s >= n_slow || x >= ef) continue;
    const int l = s * ef + x;
    const unsigned st = S[l];
    if (!st) continue;
    int c[3];
    tile_coords(t, b, s, x, c);
#pragma unroll
    for (int d = 0; d < kMaxOffsets; ++d) {
      if (d == g.w.n_nb) break;
      if (!((st >> d) & 1u)) continue;
      if (d == t.d_fast && x + 1 < ef && lane != 31) continue;  // a run of step (1)
      const int j = tile_step(g, b, c, d);
      if (j >= 0) tile_unite(P, l, j);
    }
  }
  __syncthreads();
  for (int k = 0; k < iters; ++k) {
    const int s = threadIdx.y + k * blockDim.y;
    if (s >= n_slow || x >= ef) continue;
    const int l = s * ef + x;
    const int r = tile_root(P, l);
    int c[3], cr[3];
    tile_coords(t, b, s, x, c);
    const int sr = r / ef;
    tile_coords(t, b, sr, r - sr * ef, cr);
    const int w = box_window(g, b, c, -1);
    parent[base + w] = box_window(g, b, cr, -1);
    if (r == l) cmin[base + w] = kNoSlot;
  }
}

// The bonds that leave their tile, united in global memory: only the sites
// within reach of a face that the tile does not wrap across, and each bond
// as the pair of its ends' tile roots, skipped where the previous lane
// unites the same pair.
__global__ void __launch_bounds__(kTileThreads)
cc_band_border_kernel(const uint8_t* __restrict__ state, int32_t* parent, const BandGeom g,
                      const Tile t) {
  __shared__ uint8_t S[kTileSites];
  const unsigned lanes = __activemask();
  const size_t base = static_cast<size_t>(blockIdx.y) * g.w.L[0] * g.block;
  int32_t* P = parent + base;
  const TileBox b = tile_box(g, t, blockIdx.x);
  const int ef = t.fast == 2 ? b.e[2] : b.e[1];
  const int x = threadIdx.x;
  const int n_slow = b.e[0] * (t.fast == 2 ? b.e[1] : 1);
  const int iters = (n_slow + blockDim.y - 1) / blockDim.y;
  const int lane = (threadIdx.y * blockDim.x + x) & 31;
  load_tile(state + base, S, g, t, b, n_slow, ef);
  __syncthreads();
  for (int k = 0; k < iters; ++k) {
    const int s = threadIdx.y + k * blockDim.y;
    const unsigned st = s < n_slow && x < ef ? S[s * ef + x] : 0u;
    int c[3];
    tile_coords(t, b, s, x, c);
    bool shell = false;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      shell = shell || ((a == 0 || b.e[a] < g.w.L[a]) &&
                        (c[a] < t.reach[a] || c[a] >= b.e[a] - t.reach[a]));
    if (!__any_sync(lanes, st && shell)) continue;
    const int w = box_window(g, b, c, -1);
#pragma unroll
    for (int d = 0; d < kMaxOffsets; ++d) {
      if (d == g.w.n_nb) break;
      const bool cross = st && shell && ((st >> d) & 1u) && tile_step(g, b, c, d) < 0;
      const int ra = cross ? __ldcg(P + w) : -1;
      const int rb = cross ? __ldcg(P + box_window(g, b, c, d)) : -1;
      const int pa = __shfl_up_sync(lanes, ra, 1);
      const int pb = __shfl_up_sync(lanes, rb, 1);
      if (cross && ra != rb && !(lane > 0 && pa == ra && pb == rb)) band_unite(P, g, ra, rb);
    }
  }
}

__global__ void __launch_bounds__(kBandThreads)
cc_band_flatten_kernel(int32_t* parent, int32_t* cmin, const BandGeom g) {
  const int nw = g.w.L[0] * g.block;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * nw;
  int32_t* P = parent + base;
  const int p = __ldcg(P + w);
  int r = p;
  int next;
  while ((next = __ldcg(P + r)) != r) r = next;
  if (r != p) P[w] = r;
  const int s = edge_slot(g, w);
  if (s >= 0 && s < __ldcg(cmin + base + r)) atomicMin(cmin + base + r, s);
}

__global__ void __launch_bounds__(kBandThreads)
cc_band_export_kernel(const int32_t* __restrict__ parent, const int32_t* __restrict__ cmin,
                      int32_t* __restrict__ rep, int32_t* __restrict__ val,
                      const BandGeom g, int band) {
  const int e = 4 * g.halo * g.block;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= e) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * g.w.L[0] * g.block;
  const int r = parent[base + slot_window(g, s)];
  const size_t at = static_cast<size_t>(blockIdx.y) * e + s;
  rep[at] = band * e + cmin[base + r];
  val[at] = window_global(g, r);
}

// The merge's nodes of one graph: node x = band E + slot lies at
// [band, graph, slot] of the [n_bands, G, E] buffers.
struct Merge {
  int e;
  int n_graphs;
  int n_bands;
  int graph;

  __device__ __forceinline__ size_t at(int x) const {
    const int k = x / e;
    return (static_cast<size_t>(k) * n_graphs + graph) * e + (x - k * e);
  }
};

__device__ __forceinline__ int merge_root(int32_t* P, const Merge& m, int x) {
  while (true) {
    const int p = __ldcg(P + m.at(x));
    if (p == x) return x;
    const int gp = __ldcg(P + m.at(p));
    if (gp == p) return p;
    P[m.at(x)] = gp;
    x = gp;
  }
}

__device__ __forceinline__ long long merge_key(const int32_t* val, const Merge& m, int x) {
  return static_cast<long long>(val[m.at(x)]) * (m.n_bands * m.e) + x;
}

__global__ void __launch_bounds__(kBandThreads)
cc_band_merge_kernel(int32_t* rep, const int32_t* __restrict__ val, int e, int n_bands) {
  const Merge m{e, static_cast<int>(gridDim.y), n_bands, static_cast<int>(blockIdx.y)};
  const int hb = e / 4;  // halo rows x block
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * hb * n_bands) return;
  const int k = i / (2 * hb);
  const int j = i - k * 2 * hb;
  // a top halo slot and the previous band's bottom edge slot, or a bottom
  // halo slot and the next band's top edge slot
  int x = j < hb ? k * e + j : k * e + 2 * hb + j;
  int y = j < hb ? (k + n_bands - 1) % n_bands * e + 2 * hb + j
                 : (k + 1) % n_bands * e + j;
  x = merge_root(rep, m, x);
  y = merge_root(rep, m, y);
  while (x != y) {
    if (merge_key(val, m, x) < merge_key(val, m, y)) {
      const int t = x;
      x = y;
      y = t;
    }
    const int old = atomicCAS(rep + m.at(x), x, y);
    if (old == x) return;
    x = merge_root(rep, m, old);
    y = merge_root(rep, m, y);
  }
}

__global__ void __launch_bounds__(kBandThreads)
cc_band_resolve_kernel(int32_t* rep, const int32_t* __restrict__ val,
                       int32_t* __restrict__ labels, int e, int n_bands) {
  const Merge m{e, static_cast<int>(gridDim.y), n_bands, static_cast<int>(blockIdx.y)};
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n_bands * e) return;
  labels[m.at(x)] = val[m.at(merge_root(rep, m, x))];
}

__global__ void __launch_bounds__(kBandThreads)
cc_band_write_kernel(const int32_t* __restrict__ parent, const int32_t* __restrict__ cmin,
                     const int32_t* __restrict__ sets, int32_t* __restrict__ labels,
                     const BandGeom g) {
  const int nw = g.w.L[0] * g.block;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * nw;
  const int r = parent[base + w];
  const int s = cmin[base + r];
  labels[base + w] = s == kNoSlot
                         ? window_global(g, r)
                         : sets[static_cast<size_t>(blockIdx.y) * 4 * g.halo * g.block + s];
}

inline dim3 band_grid(int n, int n_graphs) {
  return dim3((n + kBandThreads - 1) / kBandThreads, n_graphs);
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

extern "C" {

// state: uint8 [n_graphs, n_window] (bits 0 .. n_nb-1: bonds); parent,
// cmin: int32 [n_graphs, n_window]; geom: ops/lattice.Band.words.
int peapods_cc_band_link(const void* state, void* parent, void* cmin, const int* geom,
                         int n_graphs, void* stream) {
  const BandGeom g = make_band_geom(geom);
  const Tile t = band_tiles(g, n_graphs);
  cc_band_link_kernel<<<tile_grid(t, n_graphs), tile_block(t), 0, as_stream(stream)>>>(
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent),
      static_cast<int32_t*>(cmin), g, t);
  return static_cast<int>(cudaGetLastError());
}

int peapods_cc_band_border(const void* state, void* parent, const int* geom, int n_graphs,
                           void* stream) {
  const BandGeom g = make_band_geom(geom);
  const Tile t = band_tiles(g, n_graphs);
  cc_band_border_kernel<<<tile_grid(t, n_graphs), tile_block(t), 0, as_stream(stream)>>>(
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent), g, t);
  return static_cast<int>(cudaGetLastError());
}

int peapods_cc_band_flatten(void* parent, void* cmin, const int* geom, int n_graphs,
                            void* stream) {
  const BandGeom g = make_band_geom(geom);
  cc_band_flatten_kernel<<<band_grid(g.w.L[0] * g.block, n_graphs), kBandThreads, 0,
                           as_stream(stream)>>>(static_cast<int32_t*>(parent),
                                                static_cast<int32_t*>(cmin), g);
  return static_cast<int>(cudaGetLastError());
}

// rep, val: int32 [n_graphs, E] (E = 4 halo L1 L2), band k's slice of the
// merge buffers.
int peapods_cc_band_export(const void* parent, const void* cmin, void* rep, void* val,
                           const int* geom, int band, int n_graphs, void* stream) {
  const BandGeom g = make_band_geom(geom);
  cc_band_export_kernel<<<band_grid(4 * g.halo * g.block, n_graphs), kBandThreads, 0,
                          as_stream(stream)>>>(
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(cmin),
      static_cast<int32_t*>(rep), static_cast<int32_t*>(val), g, band);
  return static_cast<int>(cudaGetLastError());
}

// rep, val, labels: int32 [n_bands, n_graphs, E]; rep is the merge's
// parent array (its values are spent).
int peapods_cc_band_merge(void* rep, const void* val, int e, int n_bands, int n_graphs,
                          void* stream) {
  cc_band_merge_kernel<<<band_grid(e / 2 * n_bands, n_graphs), kBandThreads, 0,
                         as_stream(stream)>>>(static_cast<int32_t*>(rep),
                                              static_cast<const int32_t*>(val), e, n_bands);
  return static_cast<int>(cudaGetLastError());
}

int peapods_cc_band_resolve(void* rep, const void* val, void* labels, int e, int n_bands,
                            int n_graphs, void* stream) {
  cc_band_resolve_kernel<<<band_grid(e * n_bands, n_graphs), kBandThreads, 0,
                           as_stream(stream)>>>(static_cast<int32_t*>(rep),
                                                static_cast<const int32_t*>(val),
                                                static_cast<int32_t*>(labels), e, n_bands);
  return static_cast<int>(cudaGetLastError());
}

// sets: int32 [n_graphs, E], band k's slice of the resolved labels.
int peapods_cc_band_write(const void* parent, const void* cmin, const void* sets,
                          void* labels, const int* geom, int n_graphs, void* stream) {
  const BandGeom g = make_band_geom(geom);
  cc_band_write_kernel<<<band_grid(g.w.L[0] * g.block, n_graphs), kBandThreads, 0,
                         as_stream(stream)>>>(
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(cmin),
      static_cast<const int32_t*>(sets), static_cast<int32_t*>(labels), g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
