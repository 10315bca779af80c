// K2a: G1 Jacobian formulas, one thread per point, every temporary in
// registers, each product one call of ff.cuh's carry-chain product. Replaces the G1 entries of poly_commit_tpu/core/ec_lf.py::_ec_fn
// (madd-2007-bl, its distinct and packed variants, add-2007-bl made complete
// by edge cases, dbl-2009-l); the formulas are ec_jac.cuh's over ff.cuh's
// field, so one source serves the BLS12-381, BLS12-377 (NW = 12) and BN254
// (NW = 8) Fq.
//
// Points are (x, y, z) with each coordinate an (L, N) int32 tensor of 16-bit
// limbs; z == 0 mod p is infinity, written as (0, R mod p, 0). The packed
// affine input is one (L, N) tensor whose rows 0..NW-1 are the 32-bit words
// of x and rows NW..2NW-1 those of y.
//
// pc_ec_scan is the MSM's within-lane scan (msm_gpu.py's _msm_body; the
// JAX package's lax.scan at poly_commit_tpu/core/msm_tpu.py:506, one K2a
// madd a step) in one launch: a lane's running sum stays in a thread's
// registers over all its steps, its points come from a point-major table
// (one point's 2 NW words in 2 NW / 8 32-byte sectors, where the limbs-first
// table gave 2 NW sectors), and each step's prefix is stored once. Its
// bound: 11 products a kept step (IMADs), against the prefixes written
// (3 coordinates a step): bound by integer multiplies.
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

// The within-lane scan: table (points, 2 nw) words, idx and keep
// (steps, lanes), prefixes (3, 2 nw, steps, lanes); complete selects the
// complete madd, else the distinct one. Returns cudaGetLastError() after
// the launch (or -1 for bad arguments).
extern "C" int pc_ec_scan(int nw, int complete, const void* table, const void* idx, const void* keep,
                          void* prefixes, long long lanes, int steps, const uint32_t* consts,
                          void* stream) {
  if (lanes < 0 || steps < 0 || ((uintptr_t)table & 15)) return -1;
  if (lanes == 0 || steps == 0) return 0;
  ScanArgs a{(const int32_t*)table, (const int32_t*)idx, (const uint8_t*)keep, (int32_t*)prefixes};
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(c));
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 12) scan_launch<Fp<12>>(complete != 0, a, lanes, steps, c, s);
  else if (nw == 8) scan_launch<Fp<8>>(complete != 0, a, lanes, steps, c, s);
  else return -1;
  return (int)cudaGetLastError();
}
