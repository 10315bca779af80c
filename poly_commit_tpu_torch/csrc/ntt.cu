// K4a, K4b, K4c: radix-2 decimation-in-time NTT stages over (L, N) Fr limbs.
//
// Replaces the three Pallas kernels of poly_commit_tpu/core/ntt_lf.py:
//   K4a pc_ntt_small      <- _butterfly_fn    (every stage of a transform
//                                             under 1024 elements in one
//                                             launch; pc_ntt_butterfly is
//                                             the one stage on split halves
//                                             of the JAX function)
//   K4b pc_ntt_fused      <- _fused_stages_fn (the first log2(B) stages of
//                                             every B-element block, fused)
//   K4c pc_ntt_stages     <- _big_stage_fn    (stages with half >= B, up to
//                                             MAX_STAGES of them a launch)
// The input is bit-reversed per transform (plain torch, core/ntt_lf.py), so
// stage s pairs i with i + 2^s inside runs of 2^(s+1) and the pair
// (i, i + half) takes twiddle tw_s[i mod half], the stage's distinct prefix.
// Each butterfly is one Montgomery product and an add and a subtract
// (ff.cuh), with every value lazily in [0, 2p) as in the JAX kernels. Only
// 8-word fields (BN254 Fr, BLS12-381/377 Fr) take an NTT; the post-reduce
// of the tighter fields is chosen at run time from the constants.
//
// What bounds them on this card: a one-stage butterfly moves 5 elements of
// 64 bytes (int32 per 16-bit limb) and does 4*8^2 + 8 = 264 IMADs, ~1 IMAD
// per byte, below the card's IMAD/bandwidth ratio (~5): bound by bytes; K4a's
// one-launch transform of at most 1023 elements is bound by the latency of
// its log2 n stages (a product and a barrier each). K4b
// reads and writes each element once for log2(B) stages and K4c once for
// its r stages, so both are bound by IMADs (K4c from r = 3 at 2 bytes a
// limb).
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
//
// K4a design. Below 1024 elements in all, a transform is latency: a 2^9
// transform was 9 one-stage launches of 256 pairs each, with the host's
// reshapes between them. pc_ntt_small puts the whole (16, total) array in
// one block's shared memory (32 KiB at most, word-major as K4b's) and runs
// all log2 n stages with __syncthreads() between them; rows never pair
// across each other, so the stage index alone fixes every pair. Stage s
// reads its (16, 2^s) twiddles, the tensors _by_stage takes, through L2.
// The butterflies are K4a's, so the result equals the stage chain's bit for
// bit.
//
// K4c design. One stage a launch reads and writes every element once (0.83
// of the int32 layout's byte bound at 2^23 elements), so the lever is the
// count of passes: stages s0 .. s0+r-1 (r <= MAX_STAGES) run in one launch.
// Index i = hi 2^(s0+r) + j 2^s0 + lo (lo < 2^s0, j < 2^r): those stages
// pair j with j + 2^t and never touch hi or lo. A block owns C = min(32,
// 2^s0) adjacent lo (so each limb row is read in 128-byte runs) times the
// 2^r values of j, unpacked to words in shared memory, word-major as K4b's
// (word q of (j, lo) at sm[q C 2^r + j C + lo]); it runs the r stages with
// __syncthreads() between them and writes back. Stage s0+t takes twiddle
// tw_{s0+t}[(j mod 2^t) 2^s0 + lo], contiguous across lo. At r = 6 a block
// holds 32 x 64 elements (64 KiB), so three blocks share an SM; a 2^22
// transform takes its 11 stages past the block in 2 launches instead of 11.
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

constexpr int SMALL_MAX_TOTAL = 1024;  // K4a: elements a launch
constexpr int SMALL_MAX_STAGES = 9;    // log2 of the longest transform under SMALL_MAX_TOTAL

// The twiddle tables of a K4a launch: stage s's (2 NW, 2^s) limbs.
struct SmallTw {
  const int32_t* tw[SMALL_MAX_STAGES];
};

// K4a: stages 0 .. log_n-1 of every 2^log_n-element row of (2 NW, total).
__global__ void __launch_bounds__(THREADS) k_small(const int32_t* __restrict__ a, SmallTw tws,
                                                   int32_t* __restrict__ out, int total,
                                                   int log_n, FieldConsts c) {
  __shared__ uint32_t sm[NW * SMALL_MAX_TOTAL];
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t lo = (uint32_t)a[(2 * k) * total + e];
      uint32_t hi = (uint32_t)a[(2 * k + 1) * total + e];
      sm[k * total + e] = (lo & 0xFFFFu) | (hi << 16);
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < SMALL_MAX_STAGES; ++s) {  // unrolled: tws.tw[s] by a constant index
    if (s >= log_n) continue;
    const int half = 1 << s;
    for (int k = threadIdx.x; k < total / 2; k += blockDim.x) {
      const int j = k & (half - 1);
      const int i = ((k >> s) << (s + 1)) | j;
      Fe<NW> x, y, t;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        x.w[q] = sm[q * total + i];
        y.w[q] = sm[q * total + i + half];
      }
      fe_load<NW>(t, tws.tw[s], half, j);
      butterfly(x, y, t, c);
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        sm[q * total + i] = x.w[q];
        sm[q * total + i + half] = y.w[q];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t v = sm[k * total + e];
      out[(2 * k) * total + e] = (int32_t)(v & 0xFFFFu);
      out[(2 * k + 1) * total + e] = (int32_t)(v >> 16);
    }
  }
}

constexpr int MAX_STAGES = 6;  // K4c stages a launch
constexpr int LOG_C = 5;       // K4c lo values a block (at most)

// The twiddle tables of a K4c launch: stage s0+t's (2 NW, 2^(s0+t)) limbs.
struct StageTw {
  const int32_t* tw[MAX_STAGES];
};

// K4c: stages s0 .. s0+n_stages-1 of (2 NW, total), C = 2^log_c lo values
// by 2^n_stages values of j a block (see the design note above).
__global__ void __launch_bounds__(THREADS) k_stages(const int32_t* __restrict__ a, StageTw tws,
                                                    int32_t* __restrict__ out, int64_t total,
                                                    int s0, int n_stages, int log_c,
                                                    FieldConsts c) {
  extern __shared__ uint32_t sm[];
  const int C = 1 << log_c;
  const int E = C << n_stages;  // elements of the block
  const int64_t groups = (int64_t)1 << (s0 - log_c);  // lo groups per hi
  const int64_t hi = blockIdx.x / groups;
  const int64_t lo0 = (blockIdx.x % groups) << log_c;
  const int64_t base = (hi << (s0 + n_stages)) + lo0;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int64_t at = base + ((int64_t)(e >> log_c) << s0) + (e & (C - 1));
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t lo = (uint32_t)a[(int64_t)(2 * k) * total + at];
      uint32_t hi16 = (uint32_t)a[(int64_t)(2 * k + 1) * total + at];
      sm[k * E + e] = (lo & 0xFFFFu) | (hi16 << 16);
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < MAX_STAGES; ++t) {  // unrolled: tws.tw[t] by a constant index
    if (t >= n_stages) continue;
    const int64_t tw_n = (int64_t)1 << (s0 + t);
    for (int k = threadIdx.x; k < E / 2; k += blockDim.x) {
      const int lo = k & (C - 1);
      const int jj = k >> log_c;
      const int j = ((jj >> t) << (t + 1)) | (jj & ((1 << t) - 1));
      const int x_at = j * C + lo, y_at = x_at + (C << t);
      Fe<NW> x, y, w;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        x.w[q] = sm[q * E + x_at];
        y.w[q] = sm[q * E + y_at];
      }
      fe_load<NW>(w, tws.tw[t], tw_n, ((int64_t)(j & ((1 << t) - 1)) << s0) + lo0 + lo);
      butterfly(x, y, w, c);
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        sm[q * E + x_at] = x.w[q];
        sm[q * E + y_at] = y.w[q];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int64_t at = base + ((int64_t)(e >> log_c) << s0) + (e & (C - 1));
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      uint32_t v = sm[k * E + e];
      out[(int64_t)(2 * k) * total + at] = (int32_t)(v & 0xFFFFu);
      out[(int64_t)(2 * k + 1) * total + at] = (int32_t)(v >> 16);
    }
  }
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

// tw: host array of log_n device pointers, stage s's (16, 2^s); total a
// multiple of 2^log_n and at most SMALL_MAX_TOTAL.
extern "C" int pc_ntt_small(const void* a, void* const* tw, void* out, int total, int log_n,
                            const uint32_t* consts, void* stream) {
  if (log_n < 1 || log_n > SMALL_MAX_STAGES || total < 2 || total > SMALL_MAX_TOTAL ||
      total % (1 << log_n))
    return -1;
  SmallTw tws{};
  for (int s = 0; s < log_n; ++s) tws.tw[s] = (const int32_t*)tw[s];
  const int threads = total / 2 < THREADS ? (total / 2 < 32 ? 32 : total / 2) : THREADS;
  k_small<<<1, threads, 0, (cudaStream_t)stream>>>((const int32_t*)a, tws, (int32_t*)out, total,
                                                   log_n, load_consts(consts));
  return (int)cudaGetLastError();
}

// tw: host array of n_stages device pointers, stage s0+t's (16, 2^(s0+t)).
extern "C" int pc_ntt_stages(const void* a, void* const* tw, void* out, long long total, int s0,
                             int n_stages, const uint32_t* consts, void* stream) {
  if (s0 < 0 || s0 > 40 || n_stages < 1 || n_stages > MAX_STAGES || total <= 0 ||
      total % (1LL << (s0 + n_stages)))
    return -1;
  StageTw tws{};
  for (int t = 0; t < n_stages; ++t) tws.tw[t] = (const int32_t*)tw[t];
  const int log_c = s0 < LOG_C ? s0 : LOG_C;
  const int E = 1 << (log_c + n_stages);
  const int smem = E * NW * (int)sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(k_stages, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = E / 2 < THREADS ? (E / 2 < 32 ? 32 : E / 2) : THREADS;
  k_stages<<<(unsigned)(total / E), threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a, tws, (int32_t*)out, total, s0, n_stages, log_c, load_consts(consts));
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
