// Hopper kernels of the overlap moves (Houdayer(N), Joerg, CMR, each in
// Wolff or SW form) and of the energy re-derivation after a move.
//
// Replaces the TPU's fused overlap events peapods_tpu/ops/pallas_event.py:542
// overlap_event_batch (kernel _event_kernel :274, with the CC fixed point
// pallas_cc_batch.cc_fixed_point and the coin _salted_uniform_i32) and :989
// houdn_event_batch (kernel _houdn_kernel :901).  A task b = (d T + t) G + j
// groups the g replicas tasks[b g .. b g + g - 1] at temperature t of
// realization d (g = 2 for Joerg and CMR); its systems are found through
// sid (slot r T + t), so the spins stay by system ([d, n_slots, n] int8)
// and are flipped in place.  n is a 2D [L0, L1] (L2 = 1) or 3D [L0, L1, L2]
// lattice; J/T is computed per bond as J / T in f32, as the reference's
// pack_event_jt does.  The launches of one move, on the caller's stream:
//
// Houdayer(N) on groups of any even g, the pair move (g = 2) included:
//
//   houdn_bonds   thread j owns sites 4j .. 4j+3 of a task and writes, per
//                 site, a state byte (bit d: forward bond d) and parent[i] =
//                 i: a site is active where the group's g spins sum to 0
//                 (for a pair, a != b), a bond joins two active neighbours.
//                 The first warp of the task's first block picks the Wolff
//                 seed: the first of the task's 64 probes that is active
//                 (n when none is, and the move is then a no-op), each lane
//                 testing two probes, a ballot choosing.
//   fk_link       (csrc/fk.cu, shared with the FK update) one thread per
//                 site: union-find over the bonds (uf.cuh), the roots being
//                 each component's minimum site index.
//   houdn_finish  one thread per site flips the seed's component (Wolff) or
//                 each non-singleton component with salted_uniform(root, s0,
//                 s1) < 1/2 (SW) in all g systems; optionally writes the
//                 labels.  In observe form (overlap_cluster_action=
//                 "observe", pairs only) it writes the labels and no spin.
//
// Joerg and CMR on pairs:
//
//   ov_bonds   as houdn_bonds, with the bonds
//                Joerg     a a_fwd J/T > 0 && u < 1 - exp(-4 a a_fwd J/T)
//                          && active_i && active_fwd       (active: a b < 0)
//                CMR blue  a a_fwd J/T > 0 && b b_fwd J/T > 0 && u < 1 - r^2,
//                          r = exp(-2 |J/T|)
//              in the reference's operation order, u from Philox4x32-10
//              keyed by the task's two key words, counter (dir, site / 4, 0,
//              0), and the Wolff seed: Joerg's first probe with a != b, or
//              CMR's drawn seed.
//   fk_link    as above.
//   ov_mid     CMR only: the blue flip of each site (Wolff: the seed's blue
//              component; SW: salted_uniform(root, s0, s1) < 1/2 on
//              non-singletons), then the grey bonds on the flipped spins,
//              blue || (sat_a != sat_b && u < 1 - r) with u from counter
//              (n_dims + dir, site / 4, 0, 0), into a second state byte
//              (bit 7: the blue flip) and parent array; a second fk_link
//              labels the grey graph.  The flipped spins are never written
//              here: a neighbour's flip comes from its blue root.
//   ov_finish  one thread per site flips its spin in both systems: Joerg as
//              houdn_finish; CMR, the blue flip and then the grey flip of a
//              (k & 1) and of b (k & 2), k drawn per task (Wolff) or k =
//              floor(4 salted_uniform(grey root, s2, s3)) (SW).  Optionally
//              writes the labels (the grey ones for CMR).  In observe form
//              it writes the labels of ov_bonds' graph (CMR: the blue one,
//              with no ov_mid before it) and no spin.
//
// In every observe form the bond masks are bits 0 .. nd-1 of the first
// kernel's state bytes.
//
//   energy_partials  per (realization, system) block partials of the
//              forward-bond energy sum_d s s_fwd J and of m, which pt_step
//              adds up: the energies of PT after a move (the reference's
//              re-derivation, peapods_tpu/engine/loop.py:3602-3612 through
//              peapods_tpu/ops/energy.py energies).
//
// What bounds it on the H100: a move touches per site the g int8 spins,
// a few coupling floats, a state byte and an int32 parent, a few times:
// under 10 MB per launch at 16^3 x 384 tasks.  The chains of dependent
// parent loads in find and the launch count (3 to 5 launches a move, plus
// energy_partials) bound it, as for the FK kernels.
//
// energy_partials reads every system's spins and each realization's
// couplings once: 3.5 MB at config 5 (16^3, 96 systems, 8 realizations),
// 0.00109 ms at 3.35 TB/s.  Its first design (a thread a site, two runtime
// divisions a forward neighbour, byte loads, the couplings read again by
// every system, eight barriers a partial) took 0.0449 ms there,
// issue-bound.  Now a warp takes a 256-site block of `per` systems of one
// realization (ops/overlap.py energy_words), a lane eight sites: their
// couplings read once by 16-byte loads, their spins as 8- or 4-byte words,
// each neighbour the same word of the next line or plane or the word
// shifted by a byte, found by multiply-shift, each bond's term a sign flip
// of J, and the block's values paired by the warp: 0.0066 ms (CUDA events;
// NVIDIA H100 80GB HBM3, 700 W; tools/probe_measure.py times both designs).
// Byte words took 0.0142, one system a warp 0.0095, float products 0.0075;
// loading the next system's words while summing one gained nothing.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mega.cuh"
#include "uf.cuh"

using namespace peapods;

namespace {

// the move kinds of ov_bonds / ov_finish (Houdayer takes the houdn_*
// kernels)
constexpr int kJorg = 1;
constexpr int kCmr = 2;
constexpr int kProbes = 64;

struct Task {
  int d;
  int t;
  int8_t* a;
  int8_t* b;
};

__device__ __forceinline__ Task task_of(int8_t* spins, const int32_t* sid,
                                        const int32_t* tasks, int b, int n,
                                        int n_temps, int n_pairs, int n_slots) {
  Task k;
  k.d = b / (n_temps * n_pairs);
  k.t = (b / n_pairs) % n_temps;
  const int32_t* sd = sid + static_cast<size_t>(k.d) * n_slots;
  const size_t row = static_cast<size_t>(k.d) * n_slots;
  k.a = spins + (row + sd[tasks[2 * b] * n_temps + k.t]) * n;
  k.b = spins + (row + sd[tasks[2 * b + 1] * n_temps + k.t]) * n;
  return k;
}

__device__ __forceinline__ void philox_words(const int32_t* words, int b, int first,
                                             int nd, int g, uint32_t (&w)[3][4]) {
  const uint32_t k0 = static_cast<uint32_t>(words[2 * b]);
  const uint32_t k1 = static_cast<uint32_t>(words[2 * b + 1]);
  for (int dir = 0; dir < nd; ++dir) {
    const uint4 r = philox4x32_10(k0, k1, static_cast<uint32_t>(first + dir),
                                  static_cast<uint32_t>(g), 0u, 0u);
    w[dir][0] = r.x;
    w[dir][1] = r.y;
    w[dir][2] = r.z;
    w[dir][3] = r.w;
  }
}

__global__ void __launch_bounds__(kThreads)
ov_bonds_kernel(int8_t* spins, const int32_t* __restrict__ sid,
                const int32_t* __restrict__ tasks, const float* __restrict__ coup,
                const float* __restrict__ temps, const int32_t* __restrict__ scal,
                const int32_t* __restrict__ probes, const int32_t* __restrict__ words,
                uint8_t* __restrict__ state, int32_t* __restrict__ parent,
                int32_t* __restrict__ seeds, int L0, int L1, int L2, int n_temps,
                int n_pairs, int n_slots, int kind, int wolff) {
  const Dims g = make_dims(L0, L1, L2);
  const int n = L0 * L1 * L2;
  const int b = blockIdx.y;
  const Task k = task_of(spins, sid, tasks, b, n, n_temps, n_pairs, n_slots);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int seed = n;  // none
    if (kind == kCmr) {
      seed = scal[6 * b + 4];
    } else if (wolff) {  // Joerg
      for (int p = 0; p < kProbes; ++p) {
        const int s = probes[kProbes * b + p];
        if (k.a[s] != k.b[s]) {
          seed = s;
          break;
        }
      }
    }
    seeds[b] = seed;
  }
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (kSitesPerThread * gi >= n) return;
  const float T = temps[k.t];
  const float* J = coup + static_cast<size_t>(k.d) * n * g.nd;
  uint32_t w[3][4];
  philox_words(words, b, 0, g.nd, gi, w);
  const size_t base = static_cast<size_t>(b) * n;
#pragma unroll
  for (int q = 0; q < kSitesPerThread; ++q) {
    const int i = kSitesPerThread * gi + q;
    if (i >= n) break;
    const int ai = k.a[i];
    const int bi = k.b[i];
    uint8_t st = 0;
    for (int dir = 0; dir < g.nd; ++dir) {
      const int f = fwd_site(i, g, dir);
      const int af = k.a[f];
      const int bf = k.b[f];
      const float jt = J[static_cast<size_t>(i) * g.nd + dir] / T;
      const float u = uniform24(w[dir][q]);
      bool bond;
      if (kind == kJorg) {
        const float inter = static_cast<float>(ai * af) * jt;
        const float p = 1.0f - expf(-4.0f * inter);
        bond = inter > 0.0f && u < p && ai * bi < 0 && af * bf < 0;
      } else {
        const float r = expf(-2.0f * fabsf(jt));
        bond = static_cast<float>(ai * af) * jt > 0.0f &&
               static_cast<float>(bi * bf) * jt > 0.0f && u < 1.0f - r * r;
      }
      if (bond) st |= 1u << dir;
    }
    state[base + i] = st;
    parent[base + i] = i;
  }
}

// CMR's blue flip of site j (Wolff: the seed's blue component; SW: the
// cluster coin on non-singletons)
__device__ __forceinline__ bool blue_flip(int32_t* P, const uint8_t* S, int j,
                                          const Dims& g, int wolff, int seed_root,
                                          uint32_t s0, uint32_t s1) {
  const int r = find_root(P, j);
  return wolff ? r == seed_root
               : salted_uniform(static_cast<uint32_t>(r), s0, s1) < 0.5f &&
                     nonsingleton(S, j, g);
}

__global__ void __launch_bounds__(kThreads)
ov_mid_kernel(int8_t* spins, const int32_t* __restrict__ sid,
              const int32_t* __restrict__ tasks, const float* __restrict__ coup,
              const float* __restrict__ temps, const int32_t* __restrict__ scal,
              const int32_t* __restrict__ words, const uint8_t* __restrict__ state,
              int32_t* parent, const int32_t* __restrict__ seeds,
              uint8_t* __restrict__ state2, int32_t* __restrict__ parent2,
              int32_t* __restrict__ blue_labels, int L0, int L1, int L2, int n_temps,
              int n_pairs, int n_slots, int wolff) {
  const Dims g = make_dims(L0, L1, L2);
  const int n = L0 * L1 * L2;
  const int b = blockIdx.y;
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  if (kSitesPerThread * gi >= n) return;
  const Task k = task_of(spins, sid, tasks, b, n, n_temps, n_pairs, n_slots);
  const size_t base = static_cast<size_t>(b) * n;
  int32_t* P = parent + base;
  const uint8_t* S = state + base;
  const int seed_root = wolff ? find_root(P, seeds[b]) : -1;
  const uint32_t s0 = static_cast<uint32_t>(scal[6 * b]);
  const uint32_t s1 = static_cast<uint32_t>(scal[6 * b + 1]);
  const float T = temps[k.t];
  const float* J = coup + static_cast<size_t>(k.d) * n * g.nd;
  uint32_t w[3][4];
  philox_words(words, b, g.nd, g.nd, gi, w);
#pragma unroll
  for (int q = 0; q < kSitesPerThread; ++q) {
    const int i = kSitesPerThread * gi + q;
    if (i >= n) break;
    const bool fi = blue_flip(P, S, i, g, wolff, seed_root, s0, s1);
    const uint8_t st = S[i];
    uint8_t out = fi ? 0x80u : 0u;
    for (int dir = 0; dir < g.nd; ++dir) {
      const int f = fwd_site(i, g, dir);
      const int sgn = fi != blue_flip(P, S, f, g, wolff, seed_root, s0, s1) ? -1 : 1;
      const float jt = J[static_cast<size_t>(i) * g.nd + dir] / T;
      const float r = expf(-2.0f * fabsf(jt));
      const bool sat_a = static_cast<float>(k.a[i] * k.a[f] * sgn) * jt > 0.0f;
      const bool sat_b = static_cast<float>(k.b[i] * k.b[f] * sgn) * jt > 0.0f;
      const bool red = sat_a != sat_b && uniform24(w[dir][q]) < 1.0f - r;
      if (((st >> dir) & 1u) || red) out |= 1u << dir;
    }
    state2[base + i] = out;
    parent2[base + i] = i;
    if (blue_labels != nullptr) blue_labels[base + i] = find_root(P, i);
  }
}

__global__ void __launch_bounds__(kThreads)
ov_finish_kernel(int8_t* spins, const int32_t* __restrict__ sid,
                 const int32_t* __restrict__ tasks, const int32_t* __restrict__ scal,
                 const uint8_t* __restrict__ state, int32_t* parent,
                 const int32_t* __restrict__ seeds, const uint8_t* __restrict__ state2,
                 int32_t* parent2, int32_t* __restrict__ labels, int L0, int L1,
                 int L2, int n_temps, int n_pairs, int n_slots, int kind, int wolff,
                 int observe) {
  const Dims g = make_dims(L0, L1, L2);
  const int n = L0 * L1 * L2;
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t base = static_cast<size_t>(b) * n;
  if (observe) {
    labels[base + i] = find_root(parent + base, i);
    return;
  }
  const Task k = task_of(spins, sid, tasks, b, n, n_temps, n_pairs, n_slots);
  const int seed = seeds[b];
  const int* sc = scal + 6 * b;
  int ai = k.a[i];
  int bi = k.b[i];
  bool fa;
  bool fb;
  int root;
  if (kind == kJorg) {
    int32_t* P = parent + base;
    root = find_root(P, i);
    bool fl;
    if (wolff)
      fl = seed < n && root == find_root(P, seed);
    else
      fl = salted_uniform(static_cast<uint32_t>(root), static_cast<uint32_t>(sc[0]),
                          static_cast<uint32_t>(sc[1])) < 0.5f &&
           nonsingleton(state + base, i, g);
    fa = fl;
    fb = fl;
  } else {
    if (state2[base + i] & 0x80u) {
      ai = -ai;
      bi = -bi;
    }
    int32_t* P = parent2 + base;
    root = find_root(P, i);
    int kq;
    bool in;
    if (wolff) {
      in = root == find_root(P, seed);
      kq = sc[5];
    } else {
      in = nonsingleton(state2 + base, i, g);
      kq = static_cast<int>(salted_uniform(static_cast<uint32_t>(root),
                                           static_cast<uint32_t>(sc[2]),
                                           static_cast<uint32_t>(sc[3])) *
                            4.0f);
    }
    fa = in && (kq & 1);
    fb = in && (kq & 2);
  }
  if (labels != nullptr) labels[base + i] = root;
  k.a[i] = static_cast<int8_t>(fa ? -ai : ai);
  k.b[i] = static_cast<int8_t>(fb ? -bi : bi);
}

// The spins of member r of task b (d, t): the system at slot tasks[b g + r]
// T + t of realization d.
__device__ __forceinline__ int8_t* member(int8_t* spins, const int32_t* sd,
                                          const int32_t* tk, int r, int t, int n,
                                          int n_temps, size_t row) {
  return spins + (row + sd[tk[r] * n_temps + t]) * n;
}

__device__ __forceinline__ bool balanced(int8_t* spins, const int32_t* sd,
                                         const int32_t* tk, int g_size, int t, int i,
                                         int n, int n_temps, size_t row) {
  int sum = 0;
  for (int r = 0; r < g_size; ++r)
    sum += member(spins, sd, tk, r, t, n, n_temps, row)[i];
  return sum == 0;
}

__global__ void __launch_bounds__(kThreads)
houdn_bonds_kernel(int8_t* spins, const int32_t* __restrict__ sid,
                   const int32_t* __restrict__ tasks, const int32_t* __restrict__ probes,
                   uint8_t* __restrict__ state, int32_t* __restrict__ parent,
                   int32_t* __restrict__ seeds, int L0, int L1, int L2, int n_temps,
                   int n_groups, int n_slots, int g_size, int wolff) {
  const Dims g = make_dims(L0, L1, L2);
  const int n = L0 * L1 * L2;
  const int b = blockIdx.y;
  const int d = b / (n_temps * n_groups);
  const int t = (b / n_groups) % n_temps;
  const size_t row = static_cast<size_t>(d) * n_slots;
  const int32_t* sd = sid + row;
  const int32_t* tk = tasks + static_cast<size_t>(b) * g_size;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // the first warp tests the 64 probes at once, lane l probes l and
    // 32 + l; the seed is the first active one in probe order
    int seed = n;  // none
    if (wolff) {
      const int32_t* pr = probes + kProbes * b;
      const int l = threadIdx.x;
      const unsigned lo = __ballot_sync(
          0xffffffffu, balanced(spins, sd, tk, g_size, t, pr[l], n, n_temps, row));
      const unsigned hi = __ballot_sync(
          0xffffffffu, balanced(spins, sd, tk, g_size, t, pr[32 + l], n, n_temps, row));
      if (lo != 0u)
        seed = pr[__ffs(lo) - 1];
      else if (hi != 0u)
        seed = pr[32 + __ffs(hi) - 1];
    }
    if (threadIdx.x == 0) seeds[b] = seed;
  }
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t base = static_cast<size_t>(b) * n;
#pragma unroll
  for (int q = 0; q < kSitesPerThread; ++q) {
    const int i = kSitesPerThread * gi + q;
    if (i >= n) break;
    uint8_t st = 0;
    if (balanced(spins, sd, tk, g_size, t, i, n, n_temps, row)) {
      for (int dir = 0; dir < g.nd; ++dir)
        if (balanced(spins, sd, tk, g_size, t, fwd_site(i, g, dir), n, n_temps, row))
          st |= 1u << dir;
    }
    state[base + i] = st;
    parent[base + i] = i;
  }
}

__global__ void __launch_bounds__(kThreads)
houdn_finish_kernel(int8_t* spins, const int32_t* __restrict__ sid,
                    const int32_t* __restrict__ tasks, const int32_t* __restrict__ scal,
                    const uint8_t* __restrict__ state, int32_t* parent,
                    const int32_t* __restrict__ seeds, int32_t* __restrict__ labels,
                    int L0, int L1, int L2, int n_temps, int n_groups, int n_slots,
                    int g_size, int wolff, int observe) {
  const Dims g = make_dims(L0, L1, L2);
  const int n = L0 * L1 * L2;
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d = b / (n_temps * n_groups);
  const int t = (b / n_groups) % n_temps;
  const size_t row = static_cast<size_t>(d) * n_slots;
  const size_t base = static_cast<size_t>(b) * n;
  int32_t* P = parent + base;
  const int root = find_root(P, i);
  if (observe) {
    labels[base + i] = root;
    return;
  }
  const int seed = seeds[b];
  const bool flip =
      wolff ? seed < n && root == find_root(P, seed)
            : salted_uniform(static_cast<uint32_t>(root),
                             static_cast<uint32_t>(scal[6 * b]),
                             static_cast<uint32_t>(scal[6 * b + 1])) < 0.5f &&
                  nonsingleton(state + base, i, g);
  if (labels != nullptr) labels[base + i] = root;
  if (!flip) return;
  const int32_t* tk = tasks + static_cast<size_t>(b) * g_size;
  for (int r = 0; r < g_size; ++r) {
    int8_t* s = member(spins, sid + row, tk, r, t, n, n_temps, row);
    s[i] = static_cast<int8_t>(-s[i]);
  }
}

// energy_partials' launch (ops/overlap.py energy_words): a system is n / W
// words of W bytes (8 or 4 where the fast extent holds whole words and the
// spins are aligned to them, else 1: the per-site path), in lines of wpl
// words along the fast axis; the lines run over an inner slow axis of
// extent Lb (2D: L0; 3D: L1) and, in 3D, an outer one of extent La (L0).
// A warp takes one 256-site block (nb a system) of `per` systems of one
// realization, `sets` = S / per such system sets a realization: warp w is
// block w % nb of set (w / nb) % sets of realization w / (nb sets), as
// multiply-shift divisions (m, s) of wpl, Lb, nb and sets.
struct EnergyWalk {
  int W;
  int n;
  int nw;
  int wpl;
  int Lb;
  int La;
  int nd;
  int per;
  int S;
  int nb;
  int sets;
  int d;
  int warps;
  uint32_t m[4];
  int s[4];
};

inline EnergyWalk make_energy_walk(const int* w) {
  EnergyWalk g;
  g.W = w[0];
  g.n = w[1];
  g.nw = w[2];
  g.wpl = w[3];
  g.Lb = w[4];
  g.La = w[5];
  g.nd = w[6];
  g.per = w[7];
  g.S = w[8];
  g.nb = w[9];
  g.sets = w[10];
  g.d = w[11];
  g.warps = w[12];
  for (int k = 0; k < 4; ++k) {
    g.m[k] = static_cast<uint32_t>(w[13 + 2 * k]);
    g.s[k] = w[14 + 2 * k];
  }
  return g;
}

template <int W>
struct SpinWord;
template <>
struct SpinWord<8> {
  typedef unsigned long long T;
};
template <>
struct SpinWord<4> {
  typedef unsigned int T;
};
template <>
struct SpinWord<1> {
  typedef unsigned char T;
};

// Word k of a system's spins, as the low W bytes of a 64-bit word.
template <int W>
__device__ __forceinline__ unsigned long long spin_word(const int8_t* s, int k) {
  typedef typename SpinWord<W>::T T;
  return static_cast<unsigned long long>(__ldg(reinterpret_cast<const T*>(s) + k));
}

// Byte b's term (s s_j) J of a bond whose spins' bytes are XORed into x
// (b known at compile time, an unrolled loop): J with its sign flipped
// where they differ (the sign bit of byte b), bitwise the product in
// floats for spins in {-1, +1}.
__device__ __forceinline__ float bond_term(unsigned long long x, int b, float J) {
  const uint32_t flip = static_cast<uint32_t>(x >> (8 * b + 7)) << 31;
  return __uint_as_float(__float_as_uint(J) ^ flip);
}

// The (e, m) partials of every (realization, system, 256-site block), one
// warp a block of `per` systems of one realization (EnergyWalk).  Lane l
// takes the block's sites 8 l .. 8 l + 7 (8 / W words).  Its forward
// couplings (8 nd floats, contiguous in [d, n, nd]) are read once for its
// systems, by 16-byte loads; each word's neighbour words (the line's next
// word, wrapping at its end; the same word of the next line and, in 3D,
// plane) are found once, by multiply-shift divisions and one compare an
// axis.  Per system the lane loads its words and their neighbour words
// before any add; the fast-axis neighbour of byte q is byte q + 1 of the
// word, or byte 0 of the next word.  A site's e is 0 + (s s_a) J[i, a]
// over the axes in order (the first design's thread a site), each term J's
// sign flipped where the two spins differ; the warp stages the block's 256
// values in shared memory and pairs them as warp_tree does (the first
// design's block_partials order), so the e partials are bitwise the first
// design's (ops/overlap.py energy_partials_plain(blocks=True)); m, an
// integer, is W - 2 popc of each word's sign bits, added over the warp.
// Sites past n (a padded last block) hold 0, as the first design's idle
// threads did.
template <int W, bool k3>
__global__ void __launch_bounds__(kThreads)
energy_partials_kernel(const int8_t* __restrict__ spins, const float* __restrict__ coup,
                       float* __restrict__ e_part, int32_t* __restrict__ m_part,
                       const EnergyWalk g) {
  constexpr int ND = k3 ? 3 : 2;
  constexpr int kWords = 8 / W;
  constexpr unsigned long long kSigns = 0x8080808080808080ull >> (64 - 8 * W);
  __shared__ __align__(16) float se[kThreads / 32][kThreads];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int gw = blockIdx.x * (kThreads / 32) + wid;
  if (gw >= g.warps) return;  // the whole warp: no barrier follows across warps
  const int rest = fast_div(gw, g.m[2], g.s[2]);
  const int blk = gw - rest * g.nb;
  const int dz = fast_div(rest, g.m[3], g.s[3]);
  const int set = rest - dz * g.sets;
  const int i0 = blk * kThreads + 8 * lane;
  const int cnt = g.n - i0;  // a multiple of 4: the lane's sites are 8, 4 or none
  float jc[8 * ND];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (4 * h < cnt) {
      const float4* p =
          reinterpret_cast<const float4*>(coup + (static_cast<size_t>(dz) * g.n + i0 + 4 * h) * ND);
#pragma unroll
      for (int u = 0; u < ND; ++u) {
        const float4 x = __ldg(p + u);
        jc[4 * ND * h + 4 * u] = x.x;
        jc[4 * ND * h + 4 * u + 1] = x.y;
        jc[4 * ND * h + 4 * u + 2] = x.z;
        jc[4 * ND * h + 4 * u + 3] = x.w;
      }
    }
  }
  // each word's neighbour words: the fast axis' next, the inner slow
  // axis' (kb) and the outer one's (ka, 3D)
  int kf[kWords], kb[kWords], ka[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int k = i0 / W + j;
    const int line = fast_div(k, g.m[0], g.s[0]);
    const int pos = k - line * g.wpl;
    kf[j] = pos + 1 < g.wpl ? k + 1 : k + 1 - g.wpl;
    int cb = line;
    int ca = 0;
    if (k3) {
      ca = fast_div(line, g.m[1], g.s[1]);
      cb = line - ca * g.Lb;
    }
    kb[j] = cb + 1 < g.Lb ? k + g.wpl : k + g.wpl - g.Lb * g.wpl;
    const int plane = g.Lb * g.wpl;
    ka[j] = k3 ? (ca + 1 < g.La ? k + plane : k + plane - g.nw) : 0;
  }
  float* xe = se[wid];
  for (int q = 0; q < g.per; ++q) {
    const size_t row = static_cast<size_t>(dz) * g.S + set * g.per + q;
    const int8_t* s = spins + row * g.n;
    // the lane's own words, and the fast, inner and outer neighbour words
    unsigned long long w[4][kWords] = {};
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      if (j * W < cnt) {
        w[0][j] = spin_word<W>(s, i0 / W + j);
        w[1][j] = spin_word<W>(s, kf[j]);
        w[2][j] = spin_word<W>(s, kb[j]);
        w[3][j] = k3 ? spin_word<W>(s, ka[j]) : 0;
      }
    }
    float e[8];
    int m = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const bool on = j * W < cnt;
      const unsigned long long w0 = w[0][j];
      const unsigned long long xf = w0 ^ ((w0 >> 8) | (w[1][j] << (8 * (W - 1))));
      const unsigned long long xb = w0 ^ w[2][j];
      const unsigned long long xa = w0 ^ w[3][j];
      if (on) m += W - 2 * __popcll(w0 & kSigns);
#pragma unroll
      for (int b = 0; b < W; ++b) {
        const int site = j * W + b;
        float x = 0.0f;
        if (k3) x = x + bond_term(xa, b, jc[ND * site]);
        x = x + bond_term(xb, b, jc[ND * site + ND - 2]);
        x = x + bond_term(xf, b, jc[ND * site + ND - 1]);
        e[site] = on ? x : 0.0f;
      }
    }
    reinterpret_cast<float4*>(xe + 8 * lane)[0] = make_float4(e[0], e[1], e[2], e[3]);
    reinterpret_cast<float4*>(xe + 8 * lane)[1] = make_float4(e[4], e[5], e[6], e[7]);
    __syncwarp();
    const float et = warp_tree(xe, lane);
    m = __reduce_add_sync(0xffffffffu, m);
    if (lane == 0) {
      e_part[row * g.nb + blk] = et;
      m_part[row * g.nb + blk] = m;
    }
    __syncwarp();  // the values are read before the next system writes them
  }
}

inline dim3 site_grid(int n, int per_thread, int rows) {
  const int groups = (n + per_thread - 1) / per_thread;
  return dim3((groups + kThreads - 1) / kThreads, rows);
}

}  // namespace

extern "C" {

// Blocks per system of energy_partials: the length of its partial rows.
int peapods_site_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Shared arguments: spins int8 [d, n_slots, n], sid int32 [d, n_slots],
// tasks int32 [d, n_temps, n_pairs, 2] (replica indices), coup f32 [d, n,
// nd], temps f32 [n_temps], scal int32 [n_tasks, 6] (s0, s1, s2, s3, seed,
// k), probes int32 [n_tasks, 64], words int32 [n_tasks, 2]; scratch state /
// state2 uint8 [n_tasks, n], parent / parent2 int32 [n_tasks, n], seeds
// int32 [n_tasks].  kind: 1 Joerg, 2 CMR (Houdayer: peapods_houdn_*).
int peapods_ov_bonds(void* spins, const void* sid, const void* tasks,
                     const void* coup, const void* temps, const void* scal,
                     const void* probes, const void* words, void* state, void* parent,
                     void* seeds, int n_tasks, int L0, int L1, int L2, int n_temps,
                     int n_pairs, int n_slots, int kind, int wolff, void* stream) {
  if (kind != kJorg && kind != kCmr) return static_cast<int>(cudaErrorInvalidValue);
  ov_bonds_kernel<<<site_grid(L0 * L1 * L2, kSitesPerThread, n_tasks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(coup),
      static_cast<const float*>(temps), static_cast<const int32_t*>(scal),
      static_cast<const int32_t*>(probes), static_cast<const int32_t*>(words),
      static_cast<uint8_t*>(state), static_cast<int32_t*>(parent),
      static_cast<int32_t*>(seeds), L0, L1, L2, n_temps, n_pairs, n_slots, kind,
      wolff);
  return static_cast<int>(cudaGetLastError());
}

// blue_labels: int32 [n_tasks, n] or null.
int peapods_ov_mid(void* spins, const void* sid, const void* tasks, const void* coup,
                   const void* temps, const void* scal, const void* words,
                   const void* state, void* parent, const void* seeds, void* state2,
                   void* parent2, void* blue_labels, int n_tasks, int L0, int L1,
                   int L2, int n_temps, int n_pairs, int n_slots, int wolff,
                   void* stream) {
  ov_mid_kernel<<<site_grid(L0 * L1 * L2, kSitesPerThread, n_tasks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const float*>(coup),
      static_cast<const float*>(temps), static_cast<const int32_t*>(scal),
      static_cast<const int32_t*>(words), static_cast<const uint8_t*>(state),
      static_cast<int32_t*>(parent), static_cast<const int32_t*>(seeds),
      static_cast<uint8_t*>(state2), static_cast<int32_t*>(parent2),
      static_cast<int32_t*>(blue_labels), L0, L1, L2, n_temps, n_pairs, n_slots,
      wolff);
  return static_cast<int>(cudaGetLastError());
}

// labels: int32 [n_tasks, n] or null (the grey labels for CMR); observe:
// write the labels of ov_bonds' graph (required then) and no spin.
int peapods_ov_finish(void* spins, const void* sid, const void* tasks,
                      const void* scal, const void* state, void* parent,
                      const void* seeds, const void* state2, void* parent2,
                      void* labels, int n_tasks, int L0, int L1, int L2, int n_temps,
                      int n_pairs, int n_slots, int kind, int wolff, int observe,
                      void* stream) {
  if ((observe && labels == nullptr) || (kind != kJorg && kind != kCmr))
    return static_cast<int>(cudaErrorInvalidValue);
  ov_finish_kernel<<<site_grid(L0 * L1 * L2, 1, n_tasks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(scal),
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent),
      static_cast<const int32_t*>(seeds), static_cast<const uint8_t*>(state2),
      static_cast<int32_t*>(parent2), static_cast<int32_t*>(labels), L0, L1, L2,
      n_temps, n_pairs, n_slots, kind, wolff, observe);
  return static_cast<int>(cudaGetLastError());
}

// Houdayer(N), g_size even (2: the pair move): tasks int32 [d, n_temps,
// n_groups, g_size] (replica indices), probes int32 [n_tasks, 64], scal
// int32 [n_tasks, 6] (s0, s1 the SW salts); scratch as for the pair moves;
// labels int32 [n_tasks, n] or null; observe: write the labels (required
// then) and no spin.
int peapods_houdn_bonds(void* spins, const void* sid, const void* tasks,
                        const void* probes, void* state, void* parent, void* seeds,
                        int n_tasks, int L0, int L1, int L2, int n_temps, int n_groups,
                        int n_slots, int g_size, int wolff, void* stream) {
  houdn_bonds_kernel<<<site_grid(L0 * L1 * L2, kSitesPerThread, n_tasks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(probes),
      static_cast<uint8_t*>(state), static_cast<int32_t*>(parent),
      static_cast<int32_t*>(seeds), L0, L1, L2, n_temps, n_groups, n_slots, g_size,
      wolff);
  return static_cast<int>(cudaGetLastError());
}

int peapods_houdn_finish(void* spins, const void* sid, const void* tasks,
                         const void* scal, const void* state, void* parent,
                         const void* seeds, void* labels, int n_tasks, int L0, int L1,
                         int L2, int n_temps, int n_groups, int n_slots, int g_size,
                         int wolff, int observe, void* stream) {
  if (observe && labels == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  houdn_finish_kernel<<<site_grid(L0 * L1 * L2, 1, n_tasks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(spins), static_cast<const int32_t*>(sid),
      static_cast<const int32_t*>(tasks), static_cast<const int32_t*>(scal),
      static_cast<const uint8_t*>(state), static_cast<int32_t*>(parent),
      static_cast<const int32_t*>(seeds), static_cast<int32_t*>(labels), L0, L1, L2,
      n_temps, n_groups, n_slots, g_size, wolff, observe);
  return static_cast<int>(cudaGetLastError());
}

// e_part f32 / m_part int32 [d, S, peapods_site_blocks(n)] by system; spins
// int8 [d, S, n] (aligned to W bytes), coup f32 [d, n, nd] (16-byte
// aligned); words: ops/overlap.py energy_words (host memory).
int peapods_energy_partials(const void* spins, const void* coup, void* e_part, void* m_part,
                            const int* words, void* stream) {
  const EnergyWalk g = make_energy_walk(words);
  if ((g.W != 1 && g.W != 4 && g.W != 8) || g.n < 4 || g.n % 4 || g.nw * g.W != g.n ||
      g.wpl < 1 || g.Lb < 1 || g.La < 0 || g.wpl * g.Lb * (g.La ? g.La : 1) != g.nw ||
      g.nd != (g.La ? 3 : 2) || g.per < 1 || g.S < 1 || g.S % g.per ||
      g.sets * g.per != g.S || g.nb != peapods_site_blocks(g.n) || g.d < 1 ||
      static_cast<long long>(g.d) * g.sets * g.nb != g.warps ||
      reinterpret_cast<uintptr_t>(spins) % g.W != 0 || reinterpret_cast<uintptr_t>(coup) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kWarps = kThreads / 32;
  const unsigned grid = static_cast<unsigned>((g.warps + kWarps - 1) / kWarps);
  const bool k3 = g.La > 0;
  const auto kernel = k3 ? (g.W == 8   ? energy_partials_kernel<8, true>
                            : g.W == 4 ? energy_partials_kernel<4, true>
                                       : energy_partials_kernel<1, true>)
                         : (g.W == 8   ? energy_partials_kernel<8, false>
                            : g.W == 4 ? energy_partials_kernel<4, false>
                                       : energy_partials_kernel<1, false>);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins), static_cast<const float*>(coup),
      static_cast<float*>(e_part), static_cast<int32_t*>(m_part), g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
