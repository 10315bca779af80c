// The Poseidon sponge of core/transcript.py on the host: its permutation
// (width 3, alpha = 17, 8 full and 31 partial rounds) and its duplex absorb,
// over any prime field whose modulus fits four 64-bit words with the top
// word below 2^63 - 1 (every Fr a sponge of the port uses). Plain C++17, no
// CUDA: built by the host compiler (device.py) and called through ctypes.
//
// An element crosses the interface canonical, as 4 little-endian words.
// Inside a call the state is held in Montgomery form (R = 2^256); the
// constants arrive in it. A product is a CIOS Montgomery multiplication on
// unsigned __int128 without the carry word: with the modulus' top word below
// 2^63 - 1 the running sum stays in four words, and one conditional
// subtraction leaves the result below p. The word loops carry an unroll
// pragma: -O3 alone left them rolled, at about twice the time a permutation.
// The three S-boxes of a full round run in lockstep.
//
// The constants, as PoseidonSponge packs them (uint64 words):
//   p[4] | pinv = -p^-1 mod 2^64 | r2[4] = R^2 mod p
//   | ark[39][3][4] (Montgomery) | mds[3][3][4] (Montgomery)
#include <cstdint>

namespace {

typedef unsigned __int128 u128;

constexpr int kWidth = 3;
constexpr int kRate = 2;
constexpr int kCapacity = 1;
constexpr int kFull = 8;
constexpr int kPartial = 31;
constexpr int kRounds = kFull + kPartial;

struct Fe {
  uint64_t w[4];
};

struct Params {
  uint64_t p[4];
  uint64_t pinv;
  uint64_t r2[4];
  Fe ark[kRounds][kWidth];
  Fe mds[kWidth][kWidth];
};

static_assert(sizeof(Params) == (4 + 1 + 4 + 4 * kRounds * kWidth + 4 * kWidth * kWidth) * 8,
              "Params is the packed word layout");

// r = t - p if t >= p, else t (t < 2p)
inline void reduce_once(Fe& r, const uint64_t t[4], const uint64_t p[4]) {
  uint64_t d[4];
  uint64_t borrow = 0;
  #pragma GCC unroll 4
  for (int j = 0; j < 4; ++j) {
    u128 x = (u128)t[j] - p[j] - borrow;
    d[j] = (uint64_t)x;
    borrow = (uint64_t)(x >> 64) & 1;
  }
  const uint64_t keep = 0 - borrow;  // all ones where t < p
  #pragma GCC unroll 4
  for (int j = 0; j < 4; ++j) r.w[j] = (t[j] & keep) | (d[j] & ~keep);
}

inline void add(Fe& r, const Fe& a, const Fe& b, const Params& c) {
  uint64_t t[4];
  uint64_t carry = 0;  // a + b < 2p < 2^256: no carry out of the top word
  #pragma GCC unroll 4
  for (int j = 0; j < 4; ++j) {
    u128 x = (u128)a.w[j] + b.w[j] + carry;
    t[j] = (uint64_t)x;
    carry = (uint64_t)(x >> 64);
  }
  reduce_once(r, t, c.p);
}

// r = a b R^-1 mod p (CIOS, no carry word)
inline void mul(Fe& r, const Fe& a, const Fe& b, const Params& c) {
  uint64_t t[4] = {0, 0, 0, 0};
  #pragma GCC unroll 4
  for (int i = 0; i < 4; ++i) {
    u128 x = (u128)a.w[0] * b.w[i] + t[0];
    uint64_t ca = (uint64_t)(x >> 64);
    t[0] = (uint64_t)x;
    const uint64_t m = t[0] * c.pinv;
    u128 y = (u128)m * c.p[0] + t[0];
    uint64_t cm = (uint64_t)(y >> 64);
    #pragma GCC unroll 4
    for (int j = 1; j < 4; ++j) {
      x = (u128)a.w[j] * b.w[i] + t[j] + ca;
      ca = (uint64_t)(x >> 64);
      y = (u128)m * c.p[j] + (uint64_t)x + cm;
      cm = (uint64_t)(y >> 64);
      t[j - 1] = (uint64_t)y;
    }
    t[3] = ca + cm;
  }
  reduce_once(r, t, c.p);
}

inline void sbox(Fe& x, const Params& c) {  // x^17
  Fe x2, x4, x8, x16;
  mul(x2, x, x, c);
  mul(x4, x2, x2, c);
  mul(x8, x4, x4, c);
  mul(x16, x8, x8, c);
  mul(x, x16, x, c);
}

// x^17 for the three elements of a full round, in lockstep: three
// independent chains of products for the core to overlap
inline void sbox3(Fe s[kWidth], const Params& c) {
  Fe x2[kWidth], x4[kWidth], x8[kWidth], x16[kWidth];
  for (int i = 0; i < kWidth; ++i) mul(x2[i], s[i], s[i], c);
  for (int i = 0; i < kWidth; ++i) mul(x4[i], x2[i], x2[i], c);
  for (int i = 0; i < kWidth; ++i) mul(x8[i], x4[i], x4[i], c);
  for (int i = 0; i < kWidth; ++i) mul(x16[i], x8[i], x8[i], c);
  for (int i = 0; i < kWidth; ++i) mul(s[i], x16[i], s[i], c);
}

void permute(Fe s[kWidth], const Params& c) {
  for (int r = 0; r < kRounds; ++r) {
    for (int i = 0; i < kWidth; ++i) add(s[i], s[i], c.ark[r][i], c);
    if (r < kFull / 2 || r >= kFull / 2 + kPartial) {
      sbox3(s, c);
    } else {
      sbox(s[0], c);
    }
    Fe out[kWidth];
    for (int i = 0; i < kWidth; ++i) {
      Fe prod;
      mul(out[i], c.mds[i][0], s[0], c);
      #pragma GCC unroll 4
      for (int j = 1; j < kWidth; ++j) {
        mul(prod, c.mds[i][j], s[j], c);
        add(out[i], out[i], prod, c);
      }
    }
    for (int i = 0; i < kWidth; ++i) s[i] = out[i];
  }
}

inline void to_mont(Fe& r, const uint64_t* canonical, const Params& c) {
  Fe x, r2;
  #pragma GCC unroll 4
  for (int j = 0; j < 4; ++j) x.w[j] = canonical[j], r2.w[j] = c.r2[j];
  mul(r, x, r2, c);
}

inline void from_mont(uint64_t* canonical, const Fe& x, const Params& c) {
  const Fe one = {{1, 0, 0, 0}};
  Fe r;
  mul(r, x, one, c);
  #pragma GCC unroll 4
  for (int j = 0; j < 4; ++j) canonical[j] = r.w[j];
}

void load_state(Fe s[kWidth], const uint64_t* state, const Params& c) {
  for (int i = 0; i < kWidth; ++i) to_mont(s[i], state + 4 * i, c);
}

void store_state(uint64_t* state, const Fe s[kWidth], const Params& c) {
  for (int i = 0; i < kWidth; ++i) from_mont(state + 4 * i, s[i], c);
}

}  // namespace

// Absorbs n canonical elements into the canonical state at rate position
// *pos, as PoseidonSponge._absorb's loop: permute when the rate is full,
// then add the element into the next rate slot. Updates the state and *pos
// and returns the number of permutations run.
extern "C" int64_t pc_poseidon_absorb(const uint64_t* params, uint64_t* state, int64_t* pos,
                                      const uint64_t* elems, int64_t n) {
  const Params& c = *reinterpret_cast<const Params*>(params);
  Fe s[kWidth];
  load_state(s, state, c);
  int64_t at = *pos, perms = 0;
  for (int64_t k = 0; k < n; ++k) {
    if (at == kRate) {
      permute(s, c);
      ++perms;
      at = 0;
    }
    Fe e;
    to_mont(e, elems + 4 * k, c);
    add(s[kCapacity + at], s[kCapacity + at], e, c);
    ++at;
  }
  store_state(state, s, c);
  *pos = at;
  return perms;
}

// Runs k permutations on the canonical state; returns k.
extern "C" int64_t pc_poseidon_permute(const uint64_t* params, uint64_t* state, int64_t k) {
  const Params& c = *reinterpret_cast<const Params*>(params);
  Fe s[kWidth];
  load_state(s, state, c);
  for (int64_t i = 0; i < k; ++i) permute(s, c);
  store_state(state, s, c);
  return k;
}
