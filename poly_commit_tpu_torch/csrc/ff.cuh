// Field arithmetic on registers for the port's kernels (K1, K2a, K2b, K2c
// and K4): one product, one add and one sub, each a PTX carry chain.
//
// An element is NW 32-bit words (NW = 12 for the 381/377-bit Fq, 8 for the
// 254/255-bit fields), little-endian, in Montgomery form with
// R = 2^(32 NW) = 2^(16 L): the same representation as the Python side's
// L = 2 NW 16-bit limbs. Values are kept lazily in [0, 2p). Tensors in
// device memory are (L, N) int32 with limb row l holding N contiguous
// elements, so thread i's loads of row l coalesce across a warp.
//
// The field constants arrive by value in the kernel parameters (one
// source serves every field spec).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct FieldConsts {
  uint32_t p[12];     // modulus
  uint32_t twop[12];  // 2p
  uint32_t one[12];   // R mod p (Montgomery one)
  uint32_t inv;       // -p^-1 mod 2^32
  uint32_t post;      // 1 when 4p > R: one more subtraction after a product
};

template <int NW>
struct Fe {
  uint32_t w[NW];
};

// Load element i from an (2 NW, n) int32 tensor of 16-bit limbs.
template <int NW>
__device__ __forceinline__ void fe_load(Fe<NW>& r, const int32_t* base, int64_t n, int64_t i) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint32_t lo = (uint32_t)base[(2 * k) * n + i];
    uint32_t hi = (uint32_t)base[(2 * k + 1) * n + i];
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
}

// Load element i from NW rows of packed 32-bit words starting at row0.
template <int NW>
__device__ __forceinline__ void fe_load_packed(Fe<NW>& r, const int32_t* base, int64_t n, int64_t i,
                                               int row0) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = (uint32_t)base[(int64_t)(row0 + k) * n + i];
}

template <int NW>
__device__ __forceinline__ void fe_store(int32_t* base, int64_t n, int64_t i, const Fe<NW>& a) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    base[(2 * k) * n + i] = (int32_t)(a.w[k] & 0xFFFFu);
    base[(2 * k + 1) * n + i] = (int32_t)(a.w[k] >> 16);
  }
}

// Carry chains in PTX: add.cc / addc / sub.cc / subc / mad.lo.cc / madc.hi.cc
// keep the carry in the condition code between instructions, where 64-bit
// C++ forms every word sum in a register pair and adds its top word back.
// Each chain is a run of asm volatile statements with nothing of its own in
// between, so the compiler keeps their order and the carry they pass on.

// r = a - b over NW words; returns the borrow (0/1).
template <int NW>
__device__ __forceinline__ uint32_t words_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t borrow;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int k = 1; k < NW; ++k)
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r[k]) : "r"(a[k]), "r"(b[k]));
  asm volatile("subc.u32 %0, 0, 0;" : "=r"(borrow));
  return borrow & 1u;
}

// r = a + b over NW words; returns the carry (0/1).
template <int NW>
__device__ __forceinline__ uint32_t words_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t carry;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r[0]) : "r"(a[0]), "r"(b[0]));
#pragma unroll
  for (int k = 1; k < NW; ++k)
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r[k]) : "r"(a[k]), "r"(b[k]));
  asm volatile("addc.u32 %0, 0, 0;" : "=r"(carry));
  return carry;
}

// v + top*R (< 4p) minus 2p when it is >= 2p, so the result is < 2p.
template <int NW>
__device__ __forceinline__ void reduce_2p(uint32_t* v, uint32_t top, const FieldConsts& c) {
  uint32_t d[NW];
  uint32_t borrow = words_sub<NW>(d, v, c.twop);
  if (top || !borrow) {
#pragma unroll
    for (int k = 0; k < NW; ++k) v[k] = d[k];
  }
}

// t[0 .. NW+1] += a b for one word b, in two chains: the even words of a
// (lo(a_2k b) into t_2k, hi into t_2k+1), then the odd words (lo(a_2k+1 b)
// into t_2k+1, hi into t_2k+2), each ending in the top words' carries.
// t's value stays below 2^(32 (NW + 2)) in fe_mul, so nothing is lost.
template <int NW>
__device__ __forceinline__ void mad_row(uint32_t* t, const uint32_t* a, uint32_t b) {
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(a[0]), "r"(b));
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(a[0]), "r"(b));
#pragma unroll
  for (int k = 2; k < NW; k += 2) {
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[k]) : "r"(a[k]), "r"(b));
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[k + 1]) : "r"(a[k]), "r"(b));
  }
  asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[NW]));
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[NW + 1]));
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(a[1]), "r"(b));
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[2]) : "r"(a[1]), "r"(b));
#pragma unroll
  for (int k = 3; k < NW; k += 2) {
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[k]) : "r"(a[k]), "r"(b));
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[k + 1]) : "r"(a[k]), "r"(b));
  }
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[NW + 1]));
}

// CIOS Montgomery product a b R^-1 mod p for a, b < 2p; result < 2p. Row i
// adds a b_i, then m p with m = t_0 (-p^-1) mod 2^32, and drops the zero low
// word: word by word m gives the one M < R with a b + M p = 0 mod R, so the
// result is the integer (a b + M p) / R of every CIOS, the plain version's.
template <int NW>
__device__ __forceinline__ void fe_mul(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b,
                                       const FieldConsts& c) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    mad_row<NW>(t, a.w, b.w[i]);
    mad_row<NW>(t, c.p, t[0] * c.inv);
#pragma unroll
    for (int k = 0; k <= NW; ++k) t[k] = t[k + 1];
    t[NW + 1] = 0;
  }
  // t < (4p^2 + R p) / R: below 2p when R >= 4p, below 3p otherwise
  if (c.post) reduce_2p<NW>(t, t[NW], c);
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[k];
}

template <int NW>
__device__ __forceinline__ void fe_sqr(Fe<NW>& r, const Fe<NW>& a, const FieldConsts& c) {
  fe_mul<NW>(r, a, a, c);
}

// (a + b) mod p, inputs < 2p, output < 2p.
template <int NW>
__device__ __forceinline__ void fe_add(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b,
                                       const FieldConsts& c) {
  uint32_t s[NW];
  uint32_t carry = words_add<NW>(s, a.w, b.w);
  reduce_2p<NW>(s, carry, c);
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = s[k];
}

// (a - b) mod p, inputs < 2p, output < 2p: a - b, plus 2p on a borrow.
template <int NW>
__device__ __forceinline__ void fe_sub(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b,
                                       const FieldConsts& c) {
  uint32_t d[NW];
  uint32_t borrow = words_sub<NW>(d, a.w, b.w);
  if (borrow) words_add<NW>(d, d, c.twop);
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = d[k];
}

// value == 0 mod p for values < 2p: all words zero or equal to p.
template <int NW>
__device__ __forceinline__ bool fe_is_zero(const Fe<NW>& a, const FieldConsts& c) {
  bool z = true, e = true;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    z = z && (a.w[k] == 0u);
    e = e && (a.w[k] == c.p[k]);
  }
  return z || e;
}

template <int NW>
__device__ __forceinline__ void fe_set_one(Fe<NW>& r, const FieldConsts& c) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = c.one[k];
}

template <int NW>
__device__ __forceinline__ void fe_set_zero(Fe<NW>& r) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = 0u;
}
