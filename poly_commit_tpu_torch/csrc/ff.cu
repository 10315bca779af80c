// K1: elementwise Montgomery multiply, add and subtract over (L, N) limbs,
// and the power a^e by square and multiply in one launch (pc_ff_pow).
// Replaces poly_commit_tpu/core/ff.py::_pallas_fn (the power: the lax.scan
// of mont_mul in poly_commit_tpu/core/msm_tpu.py::_ff_inv). One thread per
// element; see ff.cuh for the representation and core/ff.py for the bound.
#include <cstring>

#include "ff.cuh"

namespace {

template <int NW, int OP>
__global__ void __launch_bounds__(256) k_ff(const int32_t* __restrict__ a,
                                            const int32_t* __restrict__ b,
                                            int32_t* __restrict__ out, int64_t n,
                                            FieldConsts c) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x, y, r;
  fe_load<NW>(x, a, n, i);
  fe_load<NW>(y, b, n, i);
  if (OP == 0) {
    fe_mul<NW>(r, x, y, c);
  } else if (OP == 1) {
    fe_add<NW>(r, x, y, c);
  } else {
    fe_sub<NW>(r, x, y, c);
  }
  fe_store<NW>(out, n, i, r);
}

template <int NW>
void launch(int op, const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
            const FieldConsts& c, cudaStream_t s) {
  dim3 grid((unsigned)((n + 255) / 256));
  if (op == 0) k_ff<NW, 0><<<grid, 256, 0, s>>>(a, b, out, n, c);
  else if (op == 1) k_ff<NW, 1><<<grid, 256, 0, s>>>(a, b, out, n, c);
  else k_ff<NW, 2><<<grid, 256, 0, s>>>(a, b, out, n, c);
}

constexpr int kExpWords = 12;
constexpr int kPowThreads = 64;  // small blocks: a few thousand columns still reach many SMs

struct Exponent {
  uint32_t w[kExpWords];  // little-endian 32-bit words
  int bits;               // bit length
};

// out = a^e: square and multiply, MSB first, from R mod p, the whole chain
// in registers (the Fermat inversion of a product-tree root in one launch in
// place of one launch a product). The products are those of the plain loop,
// so the lazy limbs agree exactly. One column is one dependent chain: at
// M = 1 the launch is bound by the latency of ~1.5 log2 e products.
template <int NW>
__global__ void __launch_bounds__(kPowThreads) k_ff_pow(const int32_t* __restrict__ a,
                                                        int32_t* __restrict__ out, int64_t n,
                                                        FieldConsts c, Exponent e) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x, acc;
  fe_load<NW>(x, a, n, i);
  fe_set_one<NW>(acc, c);
#pragma unroll 1
  for (int b = e.bits - 1; b >= 0; --b) {
    fe_sqr<NW>(acc, acc, c);
    if ((e.w[b >> 5] >> (b & 31)) & 1u) fe_mul<NW>(acc, acc, x, c);
  }
  fe_store<NW>(out, n, i, acc);
}

}  // namespace

// op: 0 mul, 1 add, 2 sub; nw: 32-bit words per element (8 or 12).
// Returns cudaGetLastError() after the launch (or -1 for bad arguments).
extern "C" int pc_ff_op(int op, int nw, const void* a, const void* b, void* out, long long n,
                        const uint32_t* consts, void* stream) {
  if (op < 0 || op > 2 || n < 0) return -1;
  if (n == 0) return 0;
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(c));
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pa = (const int32_t*)a;
  const int32_t* pb = (const int32_t*)b;
  int32_t* po = (int32_t*)out;
  if (nw == 12) launch<12>(op, pa, pb, po, n, c, s);
  else if (nw == 8) launch<8>(op, pa, pb, po, n, c, s);
  else return -1;
  return (int)cudaGetLastError();
}

// out = a^e over (2 nw, n) limbs; exp holds 12 little-endian 32-bit words of
// e and bits its bit length. Returns cudaGetLastError() after the launch (or
// -1 for bad arguments).
extern "C" int pc_ff_pow(int nw, const void* a, void* out, long long n, const uint32_t* exp,
                         int bits, const uint32_t* consts, void* stream) {
  if (n < 0 || bits < 0 || bits > 32 * kExpWords) return -1;
  if (n == 0) return 0;
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(c));
  Exponent e;
  std::memcpy(e.w, exp, sizeof(e.w));
  e.bits = bits;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((n + kPowThreads - 1) / kPowThreads));
  const int32_t* pa = (const int32_t*)a;
  int32_t* po = (int32_t*)out;
  if (nw == 12) k_ff_pow<12><<<grid, kPowThreads, 0, s>>>(pa, po, n, c, e);
  else if (nw == 8) k_ff_pow<8><<<grid, kPowThreads, 0, s>>>(pa, po, n, c, e);
  else return -1;
  return (int)cudaGetLastError();
}
