// K1: elementwise Montgomery multiply, add and subtract over (L, N) limbs;
// the power a^e by square and multiply in one launch (pc_ff_pow); the
// product tree of a batched inversion (pc_ff_batch_inv); and a field sum
// (pc_ff_sum). Replaces poly_commit_tpu/core/ff.py::_pallas_fn (the power:
// the lax.scan of mont_mul in poly_commit_tpu/core/msm_tpu.py::_ff_inv; the
// tree and the sum: loops of K1 launches). See ff.cuh for the
// representation and core/ff.py for the bounds.
//
// Elementwise design. One thread per element: it reads the element's limb
// rows with 4-byte loads (a warp's 32 loads of a row coalesce into 128
// bytes), runs the product or sum in registers and writes the limbs back.
// Four adjacent columns a thread with 16-byte loads and stores measured no
// faster at 2^20 columns and slower at 2^10 (each thread's four products
// in a row), where most launches of the paths are (PERF.md).
#include <cstring>

#include "ff.cuh"

namespace {

constexpr int kThreads = 256;

template <int NW, int OP>
__global__ void __launch_bounds__(kThreads) k_ff(const int32_t* __restrict__ a,
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
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  if (op == 0) k_ff<NW, 0><<<grid, kThreads, 0, s>>>(a, b, out, n, c);
  else if (op == 1) k_ff<NW, 1><<<grid, kThreads, 0, s>>>(a, b, out, n, c);
  else k_ff<NW, 2><<<grid, kThreads, 0, s>>>(a, b, out, n, c);
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

// Batched inversion. A block owns 2^log_b adjacent columns of one level
// (2^kTreeLogLeaves at most: 2^20 columns take two levels) and builds their
// product tree in shared memory, heap order (node i's children 2i and
// 2i + 1, leaf j at node 2^log_b + j), word-major as K4's blocks (word k of
// node i at sm[k 2^(log_b+1) + i]). A column at or past n, or a zero
// column, acts as one. Up (DOWN false): the block writes its root to column
// blockIdx.x of dst. Down (DOWN true): the block builds the same tree
// again, puts the inverse of its root (column blockIdx.x of inv_roots) at
// node 1, and walks down with inv(child) = inv(parent) * sibling; leaf j's
// inverse goes to column base + j of dst, a zero column's to zero. Building
// the tree again costs one product a column and saves writing and reading
// the tree's inner nodes. The levels of a tree are serial (a product and a
// barrier each), so a launch is bound by their latency until the columns
// fill the card; 2^10 leaves of 12 words take 96 KiB, two blocks an SM.
constexpr int kTreeLogLeaves = 10;

template <int NW>
__device__ __forceinline__ void sm_get(Fe<NW>& r, const uint32_t* sm, int stride, int i) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = sm[k * stride + i];
}

template <int NW>
__device__ __forceinline__ void sm_put(uint32_t* sm, int stride, int i, const Fe<NW>& a) {
#pragma unroll
  for (int k = 0; k < NW; ++k) sm[k * stride + i] = a.w[k];
}

template <int NW, bool DOWN>
__global__ void __launch_bounds__(kThreads) k_tree(const int32_t* __restrict__ src, int64_t n,
                                                   const int32_t* __restrict__ inv_roots,
                                                   int32_t* __restrict__ dst, int log_b,
                                                   FieldConsts c) {
  extern __shared__ uint32_t sm[];
  const int B = 1 << log_b;
  const int S = 2 * B;
  const int64_t base = (int64_t)blockIdx.x << log_b;
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    Fe<NW> x;
    fe_set_one<NW>(x, c);
    if (base + j < n) {
      Fe<NW> v;
      fe_load<NW>(v, src, n, base + j);
      if (!fe_is_zero<NW>(v, c)) x = v;
    }
    sm_put<NW>(sm, S, B + j, x);
  }
  __syncthreads();
  for (int lo = B >> 1; lo >= 1; lo >>= 1) {  // nodes [lo, 2 lo)
    for (int i = lo + threadIdx.x; i < 2 * lo; i += blockDim.x) {
      Fe<NW> l, r;
      sm_get<NW>(l, sm, S, 2 * i);
      sm_get<NW>(r, sm, S, 2 * i + 1);
      fe_mul<NW>(l, l, r, c);
      sm_put<NW>(sm, S, i, l);
    }
    __syncthreads();
  }
  if (!DOWN) {
    if (threadIdx.x == 0) {
      Fe<NW> r;
      sm_get<NW>(r, sm, S, 1);
      fe_store<NW>(dst, gridDim.x, blockIdx.x, r);
    }
    return;
  }
  if (threadIdx.x == 0) {
    Fe<NW> r;
    fe_load<NW>(r, inv_roots, gridDim.x, blockIdx.x);
    sm_put<NW>(sm, S, 1, r);
  }
  __syncthreads();
  for (int lo = 1; lo < B; lo <<= 1) {  // parents [lo, 2 lo), children [2 lo, 4 lo)
    for (int i = lo + threadIdx.x; i < 2 * lo; i += blockDim.x) {
      Fe<NW> p, l, r, t;
      sm_get<NW>(p, sm, S, i);
      sm_get<NW>(l, sm, S, 2 * i);
      sm_get<NW>(r, sm, S, 2 * i + 1);
      fe_mul<NW>(t, p, r, c);
      sm_put<NW>(sm, S, 2 * i, t);
      fe_mul<NW>(t, p, l, c);
      sm_put<NW>(sm, S, 2 * i + 1, t);
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < B && base + j < n; j += blockDim.x) {
    Fe<NW> v, r;
    fe_load<NW>(v, src, n, base + j);
    if (fe_is_zero<NW>(v, c)) fe_set_zero<NW>(r);
    else sm_get<NW>(r, sm, S, B + j);
    fe_store<NW>(dst, n, base + j, r);
  }
}

template <int NW>
int launch_tree(bool down, const int32_t* src, int64_t n, const int32_t* inv_roots, int32_t* dst,
                int log_b, const FieldConsts& c, cudaStream_t s) {
  const int smem = (2 << log_b) * NW * (int)sizeof(uint32_t);
  const unsigned grid = (unsigned)((n + (1LL << log_b) - 1) >> log_b);
  const int threads = (1 << log_b) < kThreads ? ((1 << log_b) < 32 ? 32 : (1 << log_b)) : kThreads;
  auto kernel = down ? k_tree<NW, true> : k_tree<NW, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, s>>>(src, n, inv_roots, dst, log_b, c);
  return (int)cudaGetLastError();
}

// Field sum: each thread adds a strided share of the columns in registers,
// then the block adds its threads' sums in shared memory (a halving tree)
// and writes one partial to column blockIdx.x of dst. The wrapper runs one
// block (the sum), or a grid and then one block over its partials. Bound
// by bytes at large N; at the paths' sizes by the latency of the block
// tree's log2(kThreads) adds.
template <int NW>
__global__ void __launch_bounds__(kThreads) k_sum(const int32_t* __restrict__ src, int64_t n,
                                                  int32_t* __restrict__ dst, FieldConsts c) {
  __shared__ uint32_t sm[NW * kThreads];
  Fe<NW> acc;
  fe_set_zero<NW>(acc);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    Fe<NW> x;
    fe_load<NW>(x, src, n, i);
    fe_add<NW>(acc, acc, x, c);
  }
  sm_put<NW>(sm, kThreads, threadIdx.x, acc);
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      Fe<NW> x, y;
      sm_get<NW>(x, sm, kThreads, threadIdx.x);
      sm_get<NW>(y, sm, kThreads, threadIdx.x + h);
      fe_add<NW>(x, x, y, c);
      sm_put<NW>(sm, kThreads, threadIdx.x, x);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    Fe<NW> r;
    sm_get<NW>(r, sm, kThreads, 0);
    fe_store<NW>(dst, gridDim.x, blockIdx.x, r);
  }
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

// One level of a batched inversion over (2 nw, n) limbs (see k_tree): up
// (down 0) writes the roots of its ceil(n / 2^log_b) blocks to dst; down
// (down 1) reads their inverses from inv_roots and writes the n inverses
// to dst. Returns cudaGetLastError() after the launch (or -1 for bad
// arguments).
extern "C" int pc_ff_batch_inv(int nw, int down, const void* src, long long n,
                               const void* inv_roots, void* dst, int log_b,
                               const uint32_t* consts, void* stream) {
  if (n <= 0 || log_b < 0 || log_b > kTreeLogLeaves || (down && !inv_roots)) return -1;
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(c));
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ps = (const int32_t*)src;
  const int32_t* pr = (const int32_t*)inv_roots;
  int32_t* pd = (int32_t*)dst;
  if (nw == 12) return launch_tree<12>(down != 0, ps, n, pr, pd, log_b, c, s);
  if (nw == 8) return launch_tree<8>(down != 0, ps, n, pr, pd, log_b, c, s);
  return -1;
}

// Field sums of the n columns of (2 nw, n) limbs: blocks blocks, each
// writing its partial sum to its column of the (2 nw, blocks) dst.
// Returns cudaGetLastError() after the launch (or -1 for bad arguments).
extern "C" int pc_ff_sum(int nw, const void* src, long long n, void* dst, int blocks,
                         const uint32_t* consts, void* stream) {
  if (n < 0 || blocks < 1) return -1;
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(c));
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ps = (const int32_t*)src;
  int32_t* pd = (int32_t*)dst;
  if (nw == 12) k_sum<12><<<blocks, kThreads, 0, s>>>(ps, n, pd, c);
  else if (nw == 8) k_sum<8><<<blocks, kThreads, 0, s>>>(ps, n, pd, c);
  else return -1;
  return (int)cudaGetLastError();
}
