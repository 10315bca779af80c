// K2a: G1 Jacobian formulas, one thread per point, every temporary in
// registers. Replaces the G1 entries of poly_commit_tpu/core/ec_lf.py::_ec_fn
// (madd-2007-bl, its distinct and packed variants, add-2007-bl made complete
// by edge cases, dbl-2009-l); the formulas are ec_jac.cuh's over ff.cuh's
// field, so one source serves the BLS12-381, BLS12-377 (NW = 12) and BN254
// (NW = 8) Fq.
//
// Points are (x, y, z) with each coordinate an (L, N) int32 tensor of 16-bit
// limbs; z == 0 mod p is infinity, written as (0, R mod p, 0). The packed
// affine input is one (L, N) tensor whose rows 0..NW-1 are the 32-bit words
// of x and rows NW..2NW-1 those of y.
#include "ec_jac.cuh"

// which: 0 madd, 1 madd_distinct, 2 madd_packed, 3 madd_distinct_packed,
// 4 add, 5 double. ins/outs: host arrays of device pointers (6 and 3).
// Returns cudaGetLastError() after the launch (or -1 for bad arguments).
extern "C" int pc_ec_op(int which, int nw, void* const* ins, void* const* outs, long long n,
                        const uint32_t* consts, void* stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  EcArgs a;
  FieldConsts c;
  ec_args(a, c, ins, outs, consts);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (nw == 12) rc = ec_launch<Fp<12>>(which, a, n, c, s);
  else if (nw == 8) rc = ec_launch<Fp<8>>(which, a, n, c, s);
  else return -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
