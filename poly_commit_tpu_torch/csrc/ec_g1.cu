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
//
// pc_ec_fold is the MSM's window fold (msm_gpu.py's fold_device; the JAX
// package's _combine_sw_device and _fold_device at
// poly_commit_tpu/core/msm_tpu.py:622 and :638, one K2a launch an
// operation) in one launch. A row's threads form its windows' S_w = 2^c
// G_last - (G_last + sum G) (c doublings and two complete adds, the windows
// side by side) in shared memory; then one thread folds the row by Horner,
// acc = 2^c acc + S_w from the top window down. Its bound: the latency of
// c W dependent doublings (c in the combine, c (W - 1) in the chain), a
// few thousand products one after the other. More threads cannot shorten
// a row: 2^(c (W - 1)) S_(W-1) takes that many doublings in sequence. Rows
// fold side by side, so a launch takes as long as one row only while its
// blocks are all resident at once: where a thread a window would not fit
// the card (Hyrax's 2,048 rows of 32 windows), each thread combines 2 or 4
// windows in turn, c or 3c doublings more a row where a second wave of
// blocks would cost c W.
#include "ec_jac.cuh"

constexpr int FOLD_BLOCK = 64;        // threads a block of the fold
constexpr int FOLD_MAX_WINDOWS = 64;  // 256-bit scalars at c >= 4
constexpr int FOLD_MAX_SPREAD = 4;    // windows a thread of the fold combines, at most

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

// in: G_last (x, y, z) then sum G (x, y, z), each (L, rows windows) with a
// row's windows side by side; out: (x, y, z), each (L, rows). A row has
// per_row = windows / spread threads (powers of two), thread j combining
// windows j, j + per_row, ...; a block holds FOLD_BLOCK / per_row rows,
// their S_w in dynamic shared memory.
template <class F>
__global__ void __launch_bounds__(FOLD_BLOCK) k_fold(EcArgs a, int64_t rows, int windows, int per_row,
                                                     int c, FieldConsts fc) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  const int r = threadIdx.x / per_row;
  const int j = threadIdx.x % per_row;
  const int64_t row = (int64_t)blockIdx.x * (FOLD_BLOCK / per_row) + r;
  const bool live = row < rows;
  Pt<F>* s_w = reinterpret_cast<Pt<F>*>(fold_smem) + r * windows;
  const int64_t n = rows * windows;
  for (int w = j; live && w < windows; w += per_row) {
    const int64_t i = row * windows + w;
    Pt<F> last, sum, t, o;
    load_pt<F>(last, a.in, n, i);
    load_pt<F>(sum, a.in + 3, n, i);
    pt_add<F>(t, last, sum, fc);  // -(G_last + sum G): y -> 0 - y
    typename F::E zero;
    F::set_zero(zero);
    F::sub(t.y, zero, t.y, fc);
    for (int k = 0; k < c; ++k) {
      pt_double<F>(o, last, fc);
      last = o;
    }
    pt_add<F>(s_w[w], last, t, fc);
  }
  __syncthreads();
  if (!live || j != 0) return;
  Pt<F> acc = s_w[windows - 1], o;
  for (int v = windows - 2; v >= 0; --v) {
    for (int k = 0; k < c; ++k) {
      pt_double<F>(o, acc, fc);
      acc = o;
    }
    pt_add<F>(o, acc, s_w[v], fc);
    acc = o;
  }
  F::store(a.out[0], rows, row, acc.x);
  F::store(a.out[1], rows, row, acc.y);
  F::store(a.out[2], rows, row, acc.z);
}

// The launch shape from the input and the card: the fewest windows a
// thread (spread, a power of two up to FOLD_MAX_SPREAD) for which every
// block of the grid is resident at once, by the card's SMs and the
// kernel's occupancy at that block's shared memory.
template <class F>
int fold_launch(const EcArgs& a, int64_t rows, int windows, int c, const FieldConsts& fc,
                cudaStream_t s) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int per_row, rows_per_block;
  size_t smem;
  int64_t blocks;
  for (int spread = 1;; spread *= 2) {
    per_row = windows / spread;
    rows_per_block = FOLD_BLOCK / per_row;
    smem = (size_t)rows_per_block * windows * sizeof(Pt<F>);
    blocks = (rows + rows_per_block - 1) / rows_per_block;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_fold<F>, FOLD_BLOCK, smem);
    if (e != cudaSuccess) return (int)e;
    if (blocks <= (int64_t)per_sm * sms || spread >= FOLD_MAX_SPREAD || per_row == 1) break;
  }
  k_fold<F><<<(unsigned)blocks, FOLD_BLOCK, smem, s>>>(a, rows, windows, per_row, c, fc);
  return 0;
}

// The window fold of rows MSMs, windows (a power of two) of c bits: ins
// G_last and sum G (6 device pointers, (L, rows windows)), outs (3, (L,
// rows)). Returns
// cudaGetLastError() after the launch (or -1 for bad arguments).
extern "C" int pc_ec_fold(int nw, void* const* ins, void* const* outs, long long rows, int windows,
                          int c, const uint32_t* consts, void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || windows < 1 || windows > FOLD_MAX_WINDOWS ||
      (windows & (windows - 1)) || c < 1)
    return -1;
  if (rows == 0) return 0;
  EcArgs a;
  FieldConsts fc;
  ec_args(a, fc, ins, outs, consts);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (nw == 12) rc = fold_launch<Fp<12>>(a, rows, windows, c, fc, s);
  else if (nw == 8) rc = fold_launch<Fp<8>>(a, rows, windows, c, fc, s);
  else return -1;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
