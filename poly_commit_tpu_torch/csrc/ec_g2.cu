// K2c: the G2 Jacobian formulas over Fq2 = Fq[u]/(u^2 - nr), a pair of
// adjacent lanes per point, every temporary in registers. Replaces the g2_*
// entries of poly_commit_tpu/core/ec_lf.py::_ec_fn: ec_jac.cuh's formulas
// (the same as K2a's) over the field policy Fp2Pair below, which runs
// ec_lf.py::_fx_quad's operation sequence split over the two lanes.
//
// A coordinate is a (2L, N) int32 tensor, c0's L limb rows then c1's; the
// packed affine input is (2L, N) 32-bit words: x's c0 and c1 words, then
// y's. The non-residue enters as nr = -K with K small (1 for BLS12-381 and
// BN254, 5 for BLS12-377), an addition chain. Carries never cross from c0
// to c1: every operation is per component.
//
// The split: lane 0 of a pair holds the c0 component of every Fq2 value,
// lane 1 holds c1, so a lane's point is 36 words at NW = 12 where a thread
// of the first version held 72 and spilled. Addition and subtraction are
// per lane. A product keeps Fp2::mul's Karatsuba sequence: each lane forms
// its own t = a_j b_j and s = (a0 + a1)(b0 + b1), the lanes trade t, and
// lane 0 finishes c0 = t0 - K t1, lane 1 c1 = s - t0 - t1: four base
// products a pair in place of three, with two dependent products a lane in
// place of three. Every base operation is the one the plain version runs,
// so the results are bit for bit the plain version's. Lane j loads and
// stores component j's rows: a warp's access is two contiguous runs of 16
// points, one per component, the same sectors as one run of 32.
//
// What bounds it on the card: a madd reads 4 and writes 3 coordinates of
// twice K2a's size and does 3 base products for each Fq2 product (the JAX
// kernel's work; this design does 4), ~33 base products (~20,000 IMADs at
// L = 24) per point: bound by integer multiplies, as K2a is.
//
// The base product is ec_jac.cuh's base_mul: ff.cuh's CIOS with every loop
// unrolled, as one function call (__noinline__). Inlined at each of a
// formula's ~30 sites, the unrolled formulas outgrow the instruction cache;
// the call keeps one copy of the product a build.
#include "ec_jac.cuh"

template <int NW>
__device__ __forceinline__ void fe_select(Fe<NW>& r, bool first, const Fe<NW>& a, const Fe<NW>& b) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = first ? a.w[k] : b.w[k];
}

template <int NW, int K>
struct Fp2Pair {
  using E = Fe<NW>;  // this lane's component of an Fq2 value
  static constexpr int WORDS = 2 * NW;
  static constexpr int LANES = 2;

  // The component this lane holds (blocks are a whole number of warps).
  static __device__ __forceinline__ bool odd() { return threadIdx.x & 1u; }
  // The pair's two lanes: pairs of one warp may be on different branches.
  static __device__ __forceinline__ unsigned pair_mask() { return 3u << (threadIdx.x & 30u); }

  // The other lane's component of a.
  static __device__ __forceinline__ void other(E& r, const E& a) {
    const unsigned m = pair_mask();
#pragma unroll
    for (int k = 0; k < NW; ++k) r.w[k] = __shfl_xor_sync(m, a.w[k], 1);
  }

  // K t by the addition chain of ec_lf.py::_fx_quad's ``small``.
  static __device__ __forceinline__ void small(E& r, const E& t, const FieldConsts& c) {
    E cur = t;
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

  // Karatsuba: c0 = a0 b0 - K a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1.
  // a0 + a1 is the same word sum on both lanes, whichever operand is first.
  static __device__ __forceinline__ void mul(E& r, const E& a, const E& b, const FieldConsts& c) {
    E x, u, v, t, s;
    other(x, a);
    fe_add<NW>(u, a, x, c);
    other(x, b);
    fe_add<NW>(v, b, x, c);
    base_mul<NW>(t, a, b, c);  // t0 on lane 0, t1 on lane 1
    base_mul<NW>(s, u, v, c);
    other(x, t);
    small(u, x, c);          // lane 0: K t1
    fe_sub<NW>(s, s, x, c);  // lane 1: s - t0
    const bool o = odd();
    fe_select<NW>(u, o, t, u);
    fe_select<NW>(s, o, s, t);
    fe_sub<NW>(r, s, u, c);  // lane 0: t0 - K t1; lane 1: (s - t0) - t1
  }

  // nr = -1: c0 = (a0 + a1)(a0 - a1) on lane 0, c1 = 2 a0 a1 on lane 1, one
  // product a lane. Otherwise c0 = a0^2 - K a1^2, c1 = 2 a0 a1.
  static __device__ __forceinline__ void sqr(E& r, const E& a, const FieldConsts& c) {
    E x, u, v, t;
    const bool o = odd();
    other(x, a);
    if (K == 1) {
      fe_add<NW>(u, a, x, c);
      fe_sub<NW>(v, a, x, c);
      fe_select<NW>(u, o, x, u);  // lane 1: a0
      fe_select<NW>(v, o, a, v);  // lane 1: a1
      base_mul<NW>(t, u, v, c);
      fe_add<NW>(u, t, t, c);
      fe_select<NW>(r, o, u, t);
    } else {
      base_mul<NW>(u, a, a, c);  // a_j^2
      other(v, u);
      small(v, v, c);
      fe_sub<NW>(v, u, v, c);    // lane 0: a0^2 - K a1^2
      fe_select<NW>(u, o, x, a);  // a0 on both lanes
      fe_select<NW>(x, o, a, x);  // a1 on both lanes
      base_mul<NW>(t, u, x, c);
      fe_add<NW>(u, t, t, c);
      fe_select<NW>(r, o, u, v);
    }
  }

  static __device__ __forceinline__ void add(E& r, const E& a, const E& b, const FieldConsts& c) {
    fe_add<NW>(r, a, b, c);
  }
  static __device__ __forceinline__ void sub(E& r, const E& a, const E& b, const FieldConsts& c) {
    fe_sub<NW>(r, a, b, c);
  }
  // Both components zero: the same answer on both lanes.
  static __device__ __forceinline__ bool is_zero(const E& a, const FieldConsts& c) {
    return __all_sync(pair_mask(), fe_is_zero<NW>(a, c));
  }
  static __device__ __forceinline__ void set_one(E& r, const FieldConsts& c) {
    const bool o = odd();
#pragma unroll
    for (int k = 0; k < NW; ++k) r.w[k] = o ? 0u : c.one[k];
  }
  static __device__ __forceinline__ void set_zero(E& r) { fe_set_zero<NW>(r); }
  static __device__ __forceinline__ void load(E& r, const int32_t* base, int64_t n, int64_t i) {
    fe_load<NW>(r, base + (odd() ? (int64_t)(2 * NW) * n : 0), n, i);
  }
  static __device__ __forceinline__ void load_packed(E& r, const int32_t* base, int64_t n, int64_t i,
                                                     int row0) {
    fe_load_packed<NW>(r, base, n, i, row0 + (odd() ? NW : 0));
  }
  static __device__ __forceinline__ void store(int32_t* base, int64_t n, int64_t i, const E& a) {
    fe_store<NW>(base + (odd() ? (int64_t)(2 * NW) * n : 0), n, i, a);
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
  if (nw == 12 && k == 1) rc = ec_launch<Fp2Pair<12, 1>>(which, a, n, c, s);
  else if (nw == 12 && k == 5) rc = ec_launch<Fp2Pair<12, 5>>(which, a, n, c, s);
  else if (nw == 8 && k == 1) rc = ec_launch<Fp2Pair<8, 1>>(which, a, n, c, s);
  else return -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
