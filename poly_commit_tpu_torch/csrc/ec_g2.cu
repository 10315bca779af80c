// K2c: the G2 Jacobian formulas over Fq2 = Fq[u]/(u^2 - nr), one thread per
// point, every temporary in registers. Replaces the g2_* entries of
// poly_commit_tpu/core/ec_lf.py::_ec_fn: ec_jac.cuh's formulas (the same as
// K2a's) over the field policy Fp2 below, which mirrors ec_lf.py::_fx_quad.
//
// A coordinate is a (2L, N) int32 tensor, c0's L limb rows then c1's; the
// packed affine input is (2L, N) 32-bit words: x's c0 and c1 words, then
// y's. The non-residue enters as nr = -K with K small (1 for BLS12-381 and
// BN254, 5 for BLS12-377), an addition chain. Carries never cross from c0
// to c1: every operation is per component.
//
// What bounds it on the card: a madd reads 4 and writes 3 coordinates of
// twice K2a's size and does 3 base products for each Fq2 product, ~33 base
// products (~20,000 IMADs at L = 24) per point: bound by integer
// multiplies, as K2a is. An Fq2 point holds 72 words at NW = 12, so the
// formulas' temporaries exceed the 255 registers a thread may hold and ptxas
// spills to local memory; the first version accepts that (the build log
// records the counts). The base product keeps its outer loop rolled
// (``mul_rolled``): with every loop unrolled, as K1 and K2a have it, the
// three builds of this file took 510 s of nvcc on the GPU machine, most of
// the time budget of a run that builds at first use.
#include "ec_jac.cuh"

// ff.cuh's CIOS product with the outer loop rolled: word i of b is taken
// from the front of a copy that shifts down one word per round, so no
// register array is indexed by a variable. The same arithmetic as fe_mul.
template <int NW>
__device__ __forceinline__ void mul_rolled(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b,
                                           const FieldConsts& c) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int k = 0; k < NW + 2; ++k) t[k] = 0;
  Fe<NW> bb = b;
#pragma unroll 1
  for (int i = 0; i < NW; ++i) {
    uint32_t bi = bb.w[0];
#pragma unroll
    for (int k = 0; k + 1 < NW; ++k) bb.w[k] = bb.w[k + 1];
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.w[j] * bi + carry;
      t[j] = (uint32_t)s;
      carry = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + carry;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * c.inv;
    s = (uint64_t)t[0] + (uint64_t)m * c.p[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * c.p[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = s >> 32;
    }
    s = (uint64_t)t[NW] + carry;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  if (c.post) reduce_2p<NW>(t, t[NW], c);
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = t[k];
}

template <int NW, int K>
struct Fp2 {
  struct E {
    Fe<NW> c0, c1;
  };
  static constexpr int WORDS = 2 * NW;

  // K t by the addition chain of ec_lf.py::_fx_quad's ``small``.
  static __device__ __forceinline__ void small(Fe<NW>& r, const Fe<NW>& t, const FieldConsts& c) {
    Fe<NW> cur = t;
    bool have = false;
#pragma unroll
    for (int kk = K; kk; kk >>= 1) {
      if (kk & 1) {
        if (have) fe_add<NW>(r, r, cur, c);
        else r = cur;
        have = true;
      }
      if (kk >> 1) fe_add<NW>(cur, cur, cur, c);
    }
  }

  // Karatsuba: 3 base products; c0 = a0 b0 - K a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1.
  static __device__ __forceinline__ void mul(E& r, const E& a, const E& b, const FieldConsts& c) {
    Fe<NW> t0, t1, s, u, v;
    mul_rolled<NW>(t0, a.c0, b.c0, c);
    mul_rolled<NW>(t1, a.c1, b.c1, c);
    fe_add<NW>(u, a.c0, a.c1, c);
    fe_add<NW>(v, b.c0, b.c1, c);
    mul_rolled<NW>(s, u, v, c);
    small(u, t1, c);
    fe_sub<NW>(r.c0, t0, u, c);
    fe_sub<NW>(s, s, t0, c);
    fe_sub<NW>(r.c1, s, t1, c);
  }

  static __device__ __forceinline__ void sqr(E& r, const E& a, const FieldConsts& c) {
    Fe<NW> r0, t, u;
    if (K == 1) {  // (a0 + a1)(a0 - a1)
      fe_add<NW>(t, a.c0, a.c1, c);
      fe_sub<NW>(u, a.c0, a.c1, c);
      mul_rolled<NW>(r0, t, u, c);
    } else {
      mul_rolled<NW>(t, a.c0, a.c0, c);
      mul_rolled<NW>(u, a.c1, a.c1, c);
      small(r0, u, c);
      fe_sub<NW>(r0, t, r0, c);
    }
    mul_rolled<NW>(t, a.c0, a.c1, c);
    r.c0 = r0;
    fe_add<NW>(r.c1, t, t, c);
  }

  static __device__ __forceinline__ void add(E& r, const E& a, const E& b, const FieldConsts& c) {
    fe_add<NW>(r.c0, a.c0, b.c0, c);
    fe_add<NW>(r.c1, a.c1, b.c1, c);
  }
  static __device__ __forceinline__ void sub(E& r, const E& a, const E& b, const FieldConsts& c) {
    fe_sub<NW>(r.c0, a.c0, b.c0, c);
    fe_sub<NW>(r.c1, a.c1, b.c1, c);
  }
  static __device__ __forceinline__ bool is_zero(const E& a, const FieldConsts& c) {
    return fe_is_zero<NW>(a.c0, c) && fe_is_zero<NW>(a.c1, c);
  }
  static __device__ __forceinline__ void set_one(E& r, const FieldConsts& c) {
    fe_set_one<NW>(r.c0, c);
    fe_set_zero<NW>(r.c1);
  }
  static __device__ __forceinline__ void set_zero(E& r) {
    fe_set_zero<NW>(r.c0);
    fe_set_zero<NW>(r.c1);
  }
  static __device__ __forceinline__ void load(E& r, const int32_t* base, int64_t n, int64_t i) {
    fe_load<NW>(r.c0, base, n, i);
    fe_load<NW>(r.c1, base + (int64_t)(2 * NW) * n, n, i);
  }
  static __device__ __forceinline__ void load_packed(E& r, const int32_t* base, int64_t n, int64_t i, int row0) {
    fe_load_packed<NW>(r.c0, base, n, i, row0);
    fe_load_packed<NW>(r.c1, base, n, i, row0 + NW);
  }
  static __device__ __forceinline__ void store(int32_t* base, int64_t n, int64_t i, const E& a) {
    fe_store<NW>(base, n, i, a.c0);
    fe_store<NW>(base + (int64_t)(2 * NW) * n, n, i, a.c1);
  }
};

// which: 0 madd, 1 madd_distinct, 2 madd_packed, 3 madd_distinct_packed,
// 4 add, 5 double (as pc_ec_op); nw the base field's words, k = -nr.
// Returns cudaGetLastError() after the launch (or -1 for bad arguments).
extern "C" int pc_ec_g2_op(int which, int nw, int k, void* const* ins, void* const* outs, long long n,
                           const uint32_t* consts, void* stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  EcArgs a;
  FieldConsts c;
  ec_args(a, c, ins, outs, consts);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (nw == 12 && k == 1) rc = ec_launch<Fp2<12, 1>>(which, a, n, c, s);
  else if (nw == 12 && k == 5) rc = ec_launch<Fp2<12, 5>>(which, a, n, c, s);
  else if (nw == 8 && k == 1) rc = ec_launch<Fp2<8, 1>>(which, a, n, c, s);
  else return -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
