// The table form's group reads, shared by the bond kernels of fk.cu
// (fk_bonds_table) and overlap.cu (ov_bonds_table, ov_mid_table,
// houdn_bonds_table): a thread takes the group of four sites i0 .. i0+3
// (the Philox counter's site / 4) for several graphs or tasks of one
// realization, and reads the group's rows of the int32 forward table fwd
// [n, nb] and of the realization's couplings [n, nb] once for all of them
// (kCoup; Houdayer's bonds read the rows alone).  A whole group's rows are 16 nb contiguous
// bytes: 16-byte loads where the table (and the couplings) are 16-byte
// aligned, which the hosts check for the table.  A site past n (the last
// group of n % 4 != 0 sites) reads its own index and a coupling of 0, so
// that a gather through it stays in bounds and it holds no bond.
//
// The kernels keep a group's couplings as one word an offset, byte q the
// coupling of site i0 + q: bit 0 J > 0, bit 1 J < 0, bit 2 |J| == 1
// (coupling_bits), and work on four sites at once: a spin is the byte
// 0x01 or 0xff, so two spins differ where the xor of their bytes has bit
// 7 (byte_differ).  Only a coupling other than +-1 is read again, as a
// float, where a bond along it can be active.
#pragma once

#include <cstddef>
#include <cstdint>

namespace peapods {

constexpr uint32_t kByteBits = 0x01010101u;  // bit 0 of each byte of a word

// A coupling's bits: 1 where J > 0, 2 where J < 0, 4 where |J| == 1 (0
// for 0 and NaN).
__device__ __forceinline__ uint32_t coupling_bits(float J) {
  return static_cast<uint32_t>(J > 0.0f) | static_cast<uint32_t>(J < 0.0f) << 1 |
         static_cast<uint32_t>(fabsf(J) == 1.0f) << 2;
}

// Bit 0 of byte q where the spins of bytes q of u and v differ.
__device__ __forceinline__ uint32_t byte_differ(uint32_t u, uint32_t v) {
  return ((u ^ v) >> 7) & kByteBits;
}

// Bit 0 of the group's first cnt bytes.
__device__ __forceinline__ uint32_t live_bytes(int cnt) {
  return cnt >= 4 ? kByteBits : kByteBits & ((1u << (8 * cnt)) - 1u);
}

// The group's 4 NB table entries f[k][d] (site i0 + k, offset d) and, where
// kCoup, each offset's coupling word m[d] (else m is left alone and cg not
// read): NB 16-byte loads each where the group is whole (the couplings
// also where c16, their address 16-byte aligned), else one word at a time.
template <int NB, bool kCoup = true>
__device__ __forceinline__ void whole_rows(int (&f)[4][NB], uint32_t (&m)[NB],
                                           const int32_t* __restrict__ rg,
                                           const float* __restrict__ cg, int i0, int cnt,
                                           bool c16) {
  if (cnt == 4) {
    const int4* rp = reinterpret_cast<const int4*>(rg);
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int4 x = __ldg(rp + u);
      f[(4 * u) / NB][(4 * u) % NB] = x.x;
      f[(4 * u + 1) / NB][(4 * u + 1) % NB] = x.y;
      f[(4 * u + 2) / NB][(4 * u + 2) % NB] = x.z;
      f[(4 * u + 3) / NB][(4 * u + 3) % NB] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < NB; ++j) f[k][j] = k < cnt ? __ldg(rg + k * NB + j) : i0;
  }
  if (!kCoup) return;
#pragma unroll
  for (int j = 0; j < NB; ++j) m[j] = 0u;
  if (cnt == 4 && c16) {
    const float4* cp = reinterpret_cast<const float4*>(cg);
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const float4 x = __ldg(cp + u);
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        m[(4 * u + c) % NB] |= coupling_bits(v[c]) << (8 * ((4 * u + c) / NB));
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (k < cnt) m[j] |= coupling_bits(__ldg(cg + k * NB + j)) << (8 * k);
  }
}

// A step of the runtime offset count: the entries and (kCoup) coupling
// words of offsets d0 .. d0+3 below hi, rows of nb entries, one 16-byte load
// a site and array where v16 (nb and d0 multiples of 4, four offsets below
// hi, a whole group, the couplings aligned); an offset past hi reads the
// site's own index and holds no coupling.
template <bool kCoup = true>
__device__ __forceinline__ void step_rows(int (&f)[4][4], uint32_t (&m)[4],
                                          const int32_t* __restrict__ rg,
                                          const float* __restrict__ cg, int nb, int d0, int hi,
                                          int i0, int cnt, bool v16) {
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (v16) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(rg + k * nb + d0));
      f[k][0] = x.x;
      f[k][1] = x.y;
      f[k][2] = x.z;
      f[k][3] = x.w;
      if (kCoup) {
        const float4 y = __ldg(reinterpret_cast<const float4*>(cg + k * nb + d0));
        m[0] |= coupling_bits(y.x) << (8 * k);
        m[1] |= coupling_bits(y.y) << (8 * k);
        m[2] |= coupling_bits(y.z) << (8 * k);
        m[3] |= coupling_bits(y.w) << (8 * k);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool on = k < cnt && d0 + j < hi;
        f[k][j] = on ? __ldg(rg + k * nb + d0 + j) : i0;
        if (kCoup && on) m[j] |= coupling_bits(__ldg(cg + k * nb + d0 + j)) << (8 * k);
      }
    }
  }
}

// The spins of system s at the group's K neighbours of each offset, as
// one word an offset (byte q: site i0 + q's neighbour), every load issued
// before the first use.
template <int K>
__device__ __forceinline__ void gather_words(uint32_t (&w)[K], const int8_t* __restrict__ s,
                                             const int (&f)[4][K]) {
  uint8_t b[4][K];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < K; ++j) b[q][j] = static_cast<uint8_t>(__ldg(s + f[q][j]));
#pragma unroll
  for (int j = 0; j < K; ++j)
    w[j] = b[0][j] | static_cast<uint32_t>(b[1][j]) << 8 | static_cast<uint32_t>(b[2][j]) << 16 |
           static_cast<uint32_t>(b[3][j]) << 24;
}

// The group's own spins in one system s (byte q: site i0 + q): one 32-bit
// load where vec (n % 4 == 0 and the spins 4-byte aligned), else its first
// cnt bytes, the absent ones 0.
__device__ __forceinline__ uint32_t own_spins(const int8_t* __restrict__ s, int i0, int cnt,
                                              int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(s + i0));
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < cnt) w |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(s + i0 + q))) << (8 * q);
  return w;
}

// The spin of byte q of a group's word, as an int.
__device__ __forceinline__ int byte_of(uint32_t w, int q) {
  return static_cast<int8_t>(w >> (8 * q));
}

// The group's four bond words into a graph's row out: one 16-byte store
// where vec (n % 4 == 0 and the words 16-byte aligned), else its cnt words.
__device__ __forceinline__ void store_words(uint32_t* __restrict__ out, int i0, int cnt,
                                            const uint32_t (&st)[4], int vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(st[0], st[1], st[2], st[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < cnt) out[i0 + q] = st[q];
  }
}

}  // namespace peapods
