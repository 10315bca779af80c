// K4a, K4b, K4c: radix-2 decimation-in-time NTT stages over (L, N) Fr limbs.
//
// Replaces the three Pallas kernels of poly_commit_tpu/core/ntt_lf.py:
//   K4a pc_ntt_butterfly  <- _butterfly_fn    (one stage on split halves)
//   K4b pc_ntt_fused      <- _fused_stages_fn (the first log2(B) stages of
//                                             every B-element block, fused)
//   K4c pc_ntt_stage      <- _big_stage_fn    (one stage with half >= B)
// The input is bit-reversed per transform (plain torch, core/ntt_lf.py), so
// stage s pairs i with i + 2^s inside runs of 2^(s+1) and the pair
// (i, i + half) takes twiddle tw_s[i mod half], the stage's distinct prefix.
// Each butterfly is one Montgomery product and an add and a subtract
// (ff.cuh), with every value lazily in [0, 2p) as in the JAX kernels. Only
// 8-word fields (BN254 Fr, BLS12-381/377 Fr) take an NTT; the post-reduce
// of the tighter fields is chosen at run time from the constants.
//
// What bounds them on this card: a K4a or K4c butterfly moves 5 (K4a) or 4
// elements plus a twiddle (K4c) of 64 bytes (int32 per 16-bit limb) and does
// 4*8^2 + 8 = 264 IMADs, ~1 IMAD per byte, below the card's IMAD/bandwidth
// ratio (~5): bound by bytes. K4b reads and writes each element once for
// log2(B) stages, so it is bound by IMADs.
//
// K4b design. A thread block owns B = 2^log_block contiguous elements and
// keeps them in shared memory as packed 32-bit words, word-major
// (word k of element e at sm[k B + e]), so a warp reading consecutive
// elements hits 32 consecutive banks; an element-major layout (32 bytes per
// element) would put a warp's 32 reads of one word on 4 banks. Between
// stages only __syncthreads(). The stage twiddles come from one packed
// (8, B-1) word table, stage s at offset 2^s - 1; they are read through L2,
// where the 64 KiB table stays. B = 2^11 (64 KiB of shared memory) lets
// three blocks share an SM, so one block's barrier wait is covered by the
// others; 2^12 would hold one block per SM and save one K4c pass of a
// 2^15-point transform. Small strides (half < 32) still give 2-way bank
// conflicts; left for a later performance change.
#include <cstring>

#include "ff.cuh"

namespace {

constexpr int NW = 8;
constexpr int THREADS = 256;

// (u, w) <- (u + w t, u - w t); inputs < 2p, outputs < 2p.
__device__ __forceinline__ void butterfly(Fe<NW>& u, Fe<NW>& w, const Fe<NW>& t,
                                          const FieldConsts& c) {
  Fe<NW> v;
  fe_mul<NW>(v, w, t, c);
  fe_sub<NW>(w, u, v, c);
  fe_add<NW>(u, u, v, c);
}

// K4a: pair i of (u, w, tw), each (2 NW, n); one thread per pair.
__global__ void __launch_bounds__(THREADS) k_butterfly(const int32_t* __restrict__ u,
                                                       const int32_t* __restrict__ w,
                                                       const int32_t* __restrict__ tw,
                                                       int32_t* __restrict__ lo,
                                                       int32_t* __restrict__ hi, int64_t n,
                                                       FieldConsts c) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x, y, t;
  fe_load<NW>(x, u, n, i);
  fe_load<NW>(y, w, n, i);
  fe_load<NW>(t, tw, n, i);
  butterfly(x, y, t, c);
  fe_store<NW>(lo, n, i, x);
  fe_store<NW>(hi, n, i, y);
}

// K4c: one stage of half = 2^log_half over (2 NW, total); thread k takes the
// pair (i, i + half), i = (k / half) 2 half + k mod half, and twiddle
// tw[k mod half] of the (2 NW, half) stage table.
__global__ void __launch_bounds__(THREADS) k_stage(const int32_t* __restrict__ a,
                                                   const int32_t* __restrict__ tw,
                                                   int32_t* __restrict__ out, int64_t total,
                                                   int log_half, FieldConsts c) {
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total / 2) return;
  const int64_t half = (int64_t)1 << log_half;
  const int64_t j = k & (half - 1);
  const int64_t i = ((k >> log_half) << (log_half + 1)) | j;
  Fe<NW> x, y, t;
  fe_load<NW>(x, a, total, i);
  fe_load<NW>(y, a, total, i + half);
  fe_load<NW>(t, tw, half, j);
  butterfly(x, y, t, c);
  fe_store<NW>(out, total, i, x);
  fe_store<NW>(out, total, i + half, y);
}

// K4b: stages 0 .. n_stages-1 of the block of 2^log_block elements that
// starts at blockIdx.x 2^log_block; tw is the packed (NW, tw_n) word table.
__global__ void __launch_bounds__(THREADS) k_fused(const int32_t* __restrict__ a,
                                                   const int32_t* __restrict__ tw,
                                                   int32_t* __restrict__ out, int64_t total,
                                                   int log_block, int n_stages, int64_t tw_n,
                                                   FieldConsts c) {
  extern __shared__ uint32_t sm[];
  const int B = 1 << log_block;
  const int64_t base = (int64_t)blockIdx.x << log_block;
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t lo = (uint32_t)a[(int64_t)(2 * k) * total + base + e];
      uint32_t hi = (uint32_t)a[(int64_t)(2 * k + 1) * total + base + e];
      sm[k * B + e] = (lo & 0xFFFFu) | (hi << 16);
    }
  }
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int half = 1 << s;
    for (int k = threadIdx.x; k < B / 2; k += blockDim.x) {
      const int j = k & (half - 1);
      const int i = ((k >> s) << (s + 1)) | j;
      Fe<NW> x, y, t;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        x.w[q] = sm[q * B + i];
        y.w[q] = sm[q * B + i + half];
      }
      fe_load_packed<NW>(t, tw, tw_n, half - 1 + j, 0);
      butterfly(x, y, t, c);
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        sm[q * B + i] = x.w[q];
        sm[q * B + i + half] = y.w[q];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < B; e += blockDim.x) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t v = sm[k * B + e];
      out[(int64_t)(2 * k) * total + base + e] = (int32_t)(v & 0xFFFFu);
      out[(int64_t)(2 * k + 1) * total + base + e] = (int32_t)(v >> 16);
    }
  }
}

FieldConsts load_consts(const uint32_t* consts) {
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(c));
  return c;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// Each entry returns cudaGetLastError() after its launch, or -1 for bad
// arguments. Tensors are (16, *) int32 limbs of an 8-word field.
extern "C" int pc_ntt_butterfly(const void* u, const void* w, const void* tw, void* lo, void* hi,
                                long long n, const uint32_t* consts, void* stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  k_butterfly<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)u, (const int32_t*)w, (const int32_t*)tw, (int32_t*)lo, (int32_t*)hi, n,
      load_consts(consts));
  return (int)cudaGetLastError();
}

extern "C" int pc_ntt_stage(const void* a, const void* tw, void* out, long long total,
                            int log_half, const uint32_t* consts, void* stream) {
  if (log_half < 0 || log_half > 40 || total <= 0 || total % (2LL << log_half)) return -1;
  k_stage<<<blocks_for(total / 2), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)tw, (int32_t*)out, total, log_half, load_consts(consts));
  return (int)cudaGetLastError();
}

extern "C" int pc_ntt_fused(const void* a, const void* tw, void* out, long long total,
                            int log_block, int n_stages, long long tw_n, const uint32_t* consts,
                            void* stream) {
  if (log_block < 1 || log_block > 12 || n_stages < 1 || n_stages > log_block || total <= 0 ||
      total % (1LL << log_block) || tw_n != (1LL << n_stages) - 1)
    return -1;
  const int smem = (1 << log_block) * NW * (int)sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(k_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k_fused<<<(unsigned)(total >> log_block), THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)tw, (int32_t*)out, total, log_block, n_stages, tw_n,
      load_consts(consts));
  return (int)cudaGetLastError();
}
