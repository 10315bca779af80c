// Jacobian formulas on y^2 = x^3 + b (a = 0), generic over the coordinate
// field: F::LANES threads per point, every temporary in registers. K2a
// (ec_g1.cu) instantiates them over Fq (one thread a point), K2c (ec_g2.cu)
// over Fq2 (a pair of lanes a point, one per component). They replace
// the Weierstrass entries of poly_commit_tpu/core/ec_lf.py::_ec_fn
// (madd-2007-bl, its distinct and packed variants, add-2007-bl made complete
// by edge cases, dbl-2009-l) and compute what its formulas compute, with a
// branch per thread where the Pallas kernel computes both sides and selects.
//
// A field policy F gives the element type F::E, its arithmetic (mul, sqr,
// add, sub, is_zero, set_one, set_zero: the same operation sequence as the
// port's plain versions, so results agree bit for bit), F::WORDS packed
// 32-bit rows per coordinate, F::LANES threads per point, and load/store
// (and, for the scan's point-major table, load_point: Fp only).
// With more than one lane per point, F::is_zero gives every lane of the
// point the same answer, so the lanes of a point take the same branch of
// the complete formulas (lanes of different points may not).
#pragma once

#include <cstring>

#include "ff.cuh"

struct EcArgs {
  const int32_t* in[6];
  int32_t* out[3];
};

enum Which { MADD = 0, MADD_DISTINCT = 1, MADD_PACKED = 2, MADD_DISTINCT_PACKED = 3, ADD = 4, DOUBLE = 5 };

// The constants a product reads (p, 2p, -p^-1, the post-reduce flag), by
// value into a call and back into a FieldConsts inside it.
template <int NW>
struct MulConsts {
  Fe<NW> p, twop;
  uint32_t inv, post;
};

template <int NW>
__device__ __forceinline__ MulConsts<NW> mul_consts(const FieldConsts& c) {
  MulConsts<NW> m;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    m.p.w[k] = c.p[k];
    m.twop.w[k] = c.twop[k];
  }
  m.inv = c.inv;
  m.post = c.post;
  return m;
}

template <int NW>
__device__ __forceinline__ FieldConsts field_consts(const MulConsts<NW>& m) {
  FieldConsts c;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    c.p[k] = m.p.w[k];
    c.twop[k] = m.twop.w[k];
  }
  c.inv = m.inv;
  c.post = m.post;
  return c;
}

// ff.cuh's product as one function call (__noinline__): the unrolled
// product is ~600 instructions at NW = 12, and inlined at each of a
// formula's 11-16 sites it outgrows the instruction cache; the call keeps
// one copy of it a build (K2a and K2c).
template <int NW>
__device__ __noinline__ Fe<NW> mul_call(Fe<NW> a, Fe<NW> b, MulConsts<NW> m) {
  Fe<NW> r;
  fe_mul<NW>(r, a, b, field_consts<NW>(m));
  return r;
}

template <int NW>
__device__ __forceinline__ void base_mul(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b,
                                         const FieldConsts& c) {
  r = mul_call<NW>(a, b, mul_consts<NW>(c));
}

// The prime field itself: Fe<NW> with ff.cuh's arithmetic, the product
// through base_mul.
template <int NW>
struct Fp {
  using E = Fe<NW>;
  static constexpr int WORDS = NW;
  static constexpr int LANES = 1;
  static __device__ __forceinline__ void mul(E& r, const E& a, const E& b, const FieldConsts& c) {
    base_mul<NW>(r, a, b, c);
  }
  static __device__ __forceinline__ void sqr(E& r, const E& a, const FieldConsts& c) { base_mul<NW>(r, a, a, c); }
  static __device__ __forceinline__ void add(E& r, const E& a, const E& b, const FieldConsts& c) {
    fe_add<NW>(r, a, b, c);
  }
  static __device__ __forceinline__ void sub(E& r, const E& a, const E& b, const FieldConsts& c) {
    fe_sub<NW>(r, a, b, c);
  }
  static __device__ __forceinline__ bool is_zero(const E& a, const FieldConsts& c) { return fe_is_zero<NW>(a, c); }
  static __device__ __forceinline__ void set_one(E& r, const FieldConsts& c) { fe_set_one<NW>(r, c); }
  static __device__ __forceinline__ void set_zero(E& r) { fe_set_zero<NW>(r); }
  static __device__ __forceinline__ void load(E& r, const int32_t* base, int64_t n, int64_t i) {
    fe_load<NW>(r, base, n, i);
  }
  static __device__ __forceinline__ void load_packed(E& r, const int32_t* base, int64_t n, int64_t i, int row0) {
    fe_load_packed<NW>(r, base, n, i, row0);
  }
  // x and y of row j of a point-major (n, 2 NW) word table: 16-byte loads,
  // 2 NW words of one point in 2 NW / 8 32-byte sectors
  static __device__ __forceinline__ void load_point(E& x, E& y, const int32_t* table, int64_t j) {
    const uint4* row = reinterpret_cast<const uint4*>(table + j * 2 * NW);
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const uint4 u = __ldg(row + q), v = __ldg(row + NW / 4 + q);
      x.w[4 * q] = u.x, x.w[4 * q + 1] = u.y, x.w[4 * q + 2] = u.z, x.w[4 * q + 3] = u.w;
      y.w[4 * q] = v.x, y.w[4 * q + 1] = v.y, y.w[4 * q + 2] = v.z, y.w[4 * q + 3] = v.w;
    }
  }
  static __device__ __forceinline__ void store(int32_t* base, int64_t n, int64_t i, const E& a) {
    fe_store<NW>(base, n, i, a);
  }
};

template <class F>
struct Pt {
  typename F::E x, y, z;
};

// dbl-2009-l (a = 0): 2M + 5S.
template <class F>
__device__ __forceinline__ void pt_double(Pt<F>& o, const Pt<F>& p, const FieldConsts& c) {
  typename F::E a, b, cc, d, e, f, t;
  F::sqr(a, p.x, c);
  F::sqr(b, p.y, c);
  F::sqr(cc, b, c);
  F::add(t, p.x, b, c);
  F::sqr(d, t, c);
  F::sub(d, d, a, c);
  F::sub(d, d, cc, c);
  F::add(d, d, d, c);
  F::add(e, a, a, c);
  F::add(e, e, a, c);
  F::sqr(f, e, c);
  typename F::E x3, y3, z3;
  F::add(t, d, d, c);
  F::sub(x3, f, t, c);
  F::sub(t, d, x3, c);
  F::mul(y3, e, t, c);
  F::add(cc, cc, cc, c);
  F::add(cc, cc, cc, c);
  F::add(cc, cc, cc, c);
  F::sub(y3, y3, cc, c);
  F::mul(z3, p.y, p.z, c);
  F::add(z3, z3, z3, c);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

template <class F>
__device__ __forceinline__ void pt_infinity(Pt<F>& o, const FieldConsts& c) {
  F::set_zero(o.x);
  F::set_one(o.y, c);
  F::set_zero(o.z);
}

// madd-2007-bl: Jacobian p + affine (x2, y2), 7M + 4S. With complete set,
// p == q doubles and p == -q gives infinity; p at infinity gives q.
template <class F, bool COMPLETE>
__device__ __forceinline__ void pt_madd(Pt<F>& o, const Pt<F>& p, const typename F::E& x2,
                                        const typename F::E& y2, const FieldConsts& c) {
  if (F::is_zero(p.z, c)) {
    o.x = x2;
    o.y = y2;
    F::set_one(o.z, c);
    return;
  }
  typename F::E z1z1, u2, s2, h, hh, i, j, r, v, t;
  F::sqr(z1z1, p.z, c);
  F::mul(u2, x2, z1z1, c);
  F::mul(s2, y2, p.z, c);
  F::mul(s2, s2, z1z1, c);
  F::sub(h, u2, p.x, c);
  F::sub(r, s2, p.y, c);
  if (COMPLETE && F::is_zero(h, c)) {
    if (F::is_zero(r, c)) pt_double<F>(o, p, c);
    else pt_infinity<F>(o, c);
    return;
  }
  F::sqr(hh, h, c);
  F::add(i, hh, hh, c);
  F::add(i, i, i, c);
  F::mul(j, h, i, c);
  F::add(r, r, r, c);
  F::mul(v, p.x, i, c);
  typename F::E x3, y3, z3;
  F::sqr(x3, r, c);
  F::sub(x3, x3, j, c);
  F::add(t, v, v, c);
  F::sub(x3, x3, t, c);
  F::sub(t, v, x3, c);
  F::mul(y3, r, t, c);
  F::mul(t, p.y, j, c);
  F::add(t, t, t, c);
  F::sub(y3, y3, t, c);
  F::add(t, p.z, h, c);
  F::sqr(z3, t, c);
  F::sub(z3, z3, z1z1, c);
  F::sub(z3, z3, hh, c);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

// add-2007-bl: Jacobian p + q, 11M + 5S, complete.
template <class F>
__device__ __forceinline__ void pt_add(Pt<F>& o, const Pt<F>& p, const Pt<F>& q, const FieldConsts& c) {
  if (F::is_zero(p.z, c)) {
    o = q;
    return;
  }
  if (F::is_zero(q.z, c)) {
    o = p;
    return;
  }
  typename F::E z1z1, z2z2, u1, u2, s1, s2, h, i, j, r, v, t;
  F::sqr(z1z1, p.z, c);
  F::sqr(z2z2, q.z, c);
  F::mul(u1, p.x, z2z2, c);
  F::mul(u2, q.x, z1z1, c);
  F::mul(s1, p.y, q.z, c);
  F::mul(s1, s1, z2z2, c);
  F::mul(s2, q.y, p.z, c);
  F::mul(s2, s2, z1z1, c);
  F::sub(h, u2, u1, c);
  F::sub(r, s2, s1, c);
  if (F::is_zero(h, c)) {
    if (F::is_zero(r, c)) pt_double<F>(o, p, c);
    else pt_infinity<F>(o, c);
    return;
  }
  F::add(t, h, h, c);
  F::sqr(i, t, c);
  F::mul(j, h, i, c);
  F::add(r, r, r, c);
  F::mul(v, u1, i, c);
  typename F::E x3, y3, z3;
  F::sqr(x3, r, c);
  F::sub(x3, x3, j, c);
  F::add(t, v, v, c);
  F::sub(x3, x3, t, c);
  F::sub(t, v, x3, c);
  F::mul(y3, r, t, c);
  F::mul(t, s1, j, c);
  F::add(t, t, t, c);
  F::sub(y3, y3, t, c);
  F::add(t, p.z, q.z, c);
  F::sqr(z3, t, c);
  F::sub(z3, z3, z1z1, c);
  F::sub(z3, z3, z2z2, c);
  F::mul(z3, z3, h, c);
  o.x = x3;
  o.y = y3;
  o.z = z3;
}

template <class F>
__device__ __forceinline__ void load_pt(Pt<F>& p, const int32_t* const* in, int64_t n, int64_t i) {
  F::load(p.x, in[0], n, i);
  F::load(p.y, in[1], n, i);
  F::load(p.z, in[2], n, i);
}

constexpr int EC_BLOCK = 128;

// Point i = thread / F::LANES. Threads past the last point do not return:
// they compute point n - 1 again and store nothing, so every lane stays
// alive for the exchanges inside F's arithmetic.
template <class F, int WHICH>
__global__ void __launch_bounds__(EC_BLOCK) k_ec(EcArgs a, int64_t n, FieldConsts c) {
  int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / F::LANES;
  const bool live = i < n;
  if (!live) i = n - 1;
  Pt<F> p, o;
  load_pt<F>(p, a.in, n, i);
  if (WHICH == DOUBLE) {
    pt_double<F>(o, p, c);
  } else if (WHICH == ADD) {
    Pt<F> q;
    load_pt<F>(q, a.in + 3, n, i);
    pt_add<F>(o, p, q, c);
  } else {
    typename F::E x2, y2;
    if (WHICH == MADD_PACKED || WHICH == MADD_DISTINCT_PACKED) {
      F::load_packed(x2, a.in[3], n, i, 0);
      F::load_packed(y2, a.in[3], n, i, F::WORDS);
    } else {
      F::load(x2, a.in[3], n, i);
      F::load(y2, a.in[4], n, i);
    }
    constexpr bool complete = (WHICH == MADD || WHICH == MADD_PACKED);
    pt_madd<F, complete>(o, p, x2, y2, c);
  }
  if (!live) return;
  F::store(a.out[0], n, i, o.x);
  F::store(a.out[1], n, i, o.y);
  F::store(a.out[2], n, i, o.z);
}

// Launches formula ``which`` over n points; -1 for an unknown formula.
template <class F>
int ec_launch(int which, const EcArgs& a, int64_t n, const FieldConsts& c, cudaStream_t s) {
  dim3 grid((unsigned)((n * F::LANES + EC_BLOCK - 1) / EC_BLOCK));
  switch (which) {
    case MADD: k_ec<F, MADD><<<grid, EC_BLOCK, 0, s>>>(a, n, c); break;
    case MADD_DISTINCT: k_ec<F, MADD_DISTINCT><<<grid, EC_BLOCK, 0, s>>>(a, n, c); break;
    case MADD_PACKED: k_ec<F, MADD_PACKED><<<grid, EC_BLOCK, 0, s>>>(a, n, c); break;
    case MADD_DISTINCT_PACKED: k_ec<F, MADD_DISTINCT_PACKED><<<grid, EC_BLOCK, 0, s>>>(a, n, c); break;
    case ADD: k_ec<F, ADD><<<grid, EC_BLOCK, 0, s>>>(a, n, c); break;
    case DOUBLE: k_ec<F, DOUBLE><<<grid, EC_BLOCK, 0, s>>>(a, n, c); break;
    default: return -1;
  }
  return 0;
}

// The MSM's within-lane scan, one thread a lane (F::LANES == 1): from
// infinity, step s adds the affine point at row idx[s][i] of the
// point-major table where keep[s][i] (the mixed add, complete or distinct),
// and writes the running sum as prefix s. The sum stays in registers over
// every step; a step whose keep is false only copies. Prefixes are
// (3, rows, steps, lanes) limbs, so the stores of one step coalesce across
// lanes, as do the reads of idx and keep.
struct ScanArgs {
  const int32_t* table;  // (points, 2 F::WORDS) packed words, x's then y's
  const int32_t* idx;    // (steps, lanes) rows of the table
  const uint8_t* keep;   // (steps, lanes)
  int32_t* prefixes;     // (3, 2 F::WORDS, steps, lanes) 16-bit limbs
};

template <class F, bool COMPLETE>
__global__ void __launch_bounds__(EC_BLOCK) k_scan(ScanArgs a, int64_t lanes, int steps, FieldConsts c) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < lanes;
  if (!live) i = lanes - 1;
  const int64_t row = (int64_t)steps * lanes;  // one limb row of one coordinate
  const int64_t coord = 2 * F::WORDS * row;
  Pt<F> acc;
  pt_infinity<F>(acc, c);
  for (int s = 0; s < steps; ++s) {
    const int64_t at = (int64_t)s * lanes + i;
    if (a.keep[at]) {
      typename F::E x2, y2;
      F::load_point(x2, y2, a.table, a.idx[at]);
      Pt<F> o;
      pt_madd<F, COMPLETE>(o, acc, x2, y2, c);
      acc = o;
    }
    if (live) {
      int32_t* out = a.prefixes + (int64_t)s * lanes;
      F::store(out, row, i, acc.x);
      F::store(out + coord, row, i, acc.y);
      F::store(out + 2 * coord, row, i, acc.z);
    }
  }
}

template <class F>
void scan_launch(bool complete, const ScanArgs& a, int64_t lanes, int steps, const FieldConsts& c,
                 cudaStream_t s) {
  dim3 grid((unsigned)((lanes + EC_BLOCK - 1) / EC_BLOCK));
  if (complete) k_scan<F, true><<<grid, EC_BLOCK, 0, s>>>(a, lanes, steps, c);
  else k_scan<F, false><<<grid, EC_BLOCK, 0, s>>>(a, lanes, steps, c);
}

// The host side of every pc_*_op entry: the pointer arrays and the constants.
inline void ec_args(EcArgs& a, FieldConsts& c, void* const* ins, void* const* outs, const uint32_t* consts) {
  for (int k = 0; k < 6; ++k) a.in[k] = (const int32_t*)ins[k];
  for (int k = 0; k < 3; ++k) a.out[k] = (int32_t*)outs[k];
  std::memcpy(&c, consts, sizeof(c));
}
