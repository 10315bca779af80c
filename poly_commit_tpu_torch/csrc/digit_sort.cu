// K3: stable LSD radix sort of (W, N) window digits, the MSM's bucket grouping.
// Replaces poly_commit_tpu/core/sort_tpu.py::_pallas_pass (a blocked bitonic
// network in VMEM). Keys lie in [0, bins); the sentinel is bins - 1.
//
// What bounds it: it moves bytes and does no arithmetic to speak of. The
// design keeps each key's traffic to one read per pass plus one write of key
// and index, and keeps contention out of global memory (onesweep-style):
//   1. k_upsweep reads every key once and builds, in shared memory, the
//      per-window histogram of every pass's digit (a pass takes at most 9
//      bits: 17-bit keys take 9 + 8, keys of up to 9 bits one pass); each
//      block adds its bins to global memory once. It also counts keys
//      outside [0, bins) into one device word.
//   2. k_scan turns each (pass, window) histogram into exclusive offsets.
//   3. k_pass, once a pass: a block ranks a tile of 4096 keys in shared
//      memory (warp-level matching of equal digits, one ballot a digit bit,
//      and warp-private counters, so the rank follows the input order),
//      takes each digit's offset among
//      the window's earlier tiles by a chained scan with decoupled look-back,
//      orders the tile locally by digit and writes key and index out in
//      contiguous runs.
//   4. k_run_ends writes i + 1 at each key's last sorted position, and
//      k_fill max-scans the bins, so incl[w, b] counts the keys <= b (the
//      carry into each 1024 bins is read off the last pass's offsets).
// Every pass is stable, so equal keys keep their input order: the order is
// torch.sort(keys, stable=True)'s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // k_upsweep and k_pass blocks
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // keys a thread ranks in a pass
constexpr int kTile = kThreads * kItems;   // keys a pass block sorts
constexpr int kMaxBits = 9;                // digit bits of one pass
constexpr int kMaxBins = 1 << kMaxBits;
constexpr int kMaxPasses = 2;
constexpr int kUpTile = 1 << 14;  // keys an upsweep block histograms
constexpr int kUpBatch = 8;       // keys a thread loads before it counts them
constexpr int kFillThreads = 1024;
static_assert(kFillThreads % kMaxBins == 0, "k_fill's first bins are last-pass digit boundaries");
constexpr uint32_t kFlagAggregate = 1u << 30;  // the tile's own count is published
constexpr uint32_t kFlagPrefix = 2u << 30;     // the count of this and all earlier tiles
constexpr uint32_t kCountMask = (1u << 30) - 1;

struct Plan {
  int passes;
  int shift[kMaxPasses];
  int bits[kMaxPasses];
};

__device__ __forceinline__ uint32_t digit_of(int32_t key, int shift, int bits) {
  return ((uint32_t)key >> shift) & ((1u << bits) - 1u);
}

// The lanes whose key's digit equals d, among the lanes that hold a key
// (valid): one ballot per digit bit.
__device__ __forceinline__ uint32_t match_digit(uint32_t d, bool valid, int bits) {
  uint32_t peers = __ballot_sync(0xFFFFFFFFu, valid);
  for (int b = 0; b < bits; ++b) {
    const bool set = (d >> b) & 1u;
    const uint32_t vote = __ballot_sync(0xFFFFFFFFu, set);
    peers &= set ? vote : ~vote;
  }
  return peers;
}

// Exclusive prefix sum of one value per thread over a block of T threads;
// warp_sums holds T / 32 words of shared memory. Ends with a barrier.
template <int T>
__device__ __forceinline__ int32_t block_excl_sum(int32_t v, int32_t* warp_sums) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int32_t s = lane < T / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int32_t y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < T / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  int32_t before = wid ? warp_sums[wid - 1] : 0;
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads) k_upsweep(const int32_t* __restrict__ keys,
                                                      int32_t* __restrict__ hist,
                                                      int32_t* __restrict__ bad, int64_t n,
                                                      int w_count, int bins, Plan plan) {
  __shared__ int32_t sh[kMaxPasses * kMaxBins];
  for (int i = threadIdx.x; i < kMaxPasses * kMaxBins; i += kThreads) sh[i] = 0;
  __syncthreads();
  const int w = blockIdx.y;
  const int32_t* row = keys + (int64_t)w * n;
  const int64_t start = (int64_t)blockIdx.x * kUpTile;
  const int64_t end = min(start + (int64_t)kUpTile, n);
  int nbad = 0;
  for (int64_t i0 = start + threadIdx.x; i0 < end; i0 += (int64_t)kThreads * kUpBatch) {
    int32_t k[kUpBatch];
#pragma unroll
    for (int u = 0; u < kUpBatch; ++u) {
      const int64_t i = i0 + (int64_t)u * kThreads;
      k[u] = i < end ? row[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUpBatch; ++u) {
      if (i0 + (int64_t)u * kThreads >= end) break;
      nbad += (k[u] < 0) | (k[u] >= bins);
      for (int p = 0; p < plan.passes; ++p)
        atomicAdd(&sh[p * kMaxBins + digit_of(k[u], plan.shift[p], plan.bits[p])], 1);
    }
  }
  if (nbad) atomicAdd(bad, nbad);
  __syncthreads();
  for (int p = 0; p < plan.passes; ++p) {
    for (int b = threadIdx.x; b < (1 << plan.bits[p]); b += kThreads) {
      const int32_t c = sh[p * kMaxBins + b];
      if (c) atomicAdd(&hist[((int64_t)p * w_count + w) * kMaxBins + b], c);
    }
  }
}

// One block per (window, pass): hist row -> exclusive offsets, in place.
__global__ void __launch_bounds__(kMaxBins) k_scan(int32_t* __restrict__ hist, int w_count) {
  __shared__ int32_t warp_sums[kMaxBins / 32];
  int32_t* row = hist + ((int64_t)blockIdx.y * w_count + blockIdx.x) * kMaxBins;
  const int32_t v = row[threadIdx.x];
  row[threadIdx.x] = block_excl_sum<kMaxBins>(v, warp_sums);
}

// One pass over 4096-key tiles; blocks take tiles in launch order from
// *tile_counter, so a tile only waits on tiles whose blocks already run.
// Consecutive blocks take the same tile of successive windows, so the
// blocks in flight hold few tiles of any one window and a look-back walks
// back over few unfinished tiles. Three blocks fit an SM (registers).
// vals_in == nullptr: the values are the keys' own indices (first pass).
// status (W, tiles, 2^bits) is zero on entry.
__global__ void __launch_bounds__(kThreads, 3) k_pass(
    const int32_t* __restrict__ keys_in, const int32_t* __restrict__ vals_in,
    int32_t* __restrict__ keys_out, int32_t* __restrict__ vals_out,
    const int32_t* __restrict__ excl, uint32_t* status, int32_t* tile_counter, int64_t n,
    int w_count, int tiles, int shift, int bits) {
  // warp counters (kWarps x kMaxBins), later the locally sorted tile (keys, values)
  __shared__ int32_t smem[2 * kTile];
  __shared__ int32_t s_local[kMaxBins];  // the digit's first slot in the sorted tile
  __shared__ int32_t s_base[kMaxBins];   // global position of sorted slot 0 for the digit
  __shared__ int32_t warp_sums[kWarps];
  __shared__ int s_id;
  static_assert(kWarps * kMaxBins <= 2 * kTile, "warp counters fit in the tile buffer");

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int nb = 1 << bits;
  if (tid == 0) s_id = atomicAdd(tile_counter, 1);
  for (int i = tid; i < kWarps * kMaxBins; i += kThreads) smem[i] = 0;
  __syncthreads();
  const int w = s_id % w_count, tile = s_id / w_count;
  const int64_t row = (int64_t)w * n;
  const int64_t t0 = (int64_t)tile * kTile;
  const int valid = (int)min((int64_t)kTile, n - t0);

  // warp-striped: item j of lane l in warp wp sits at wp * 512 + j * 32 + l,
  // so ranking items j = 0, 1, ... lane by lane follows the input order
  const int pos0 = wp * (32 * kItems) + lane;  // item j sits at pos0 + 32 j
  int32_t key[kItems], val[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int pos = pos0 + j * 32;
    const bool ok = pos < valid;
    key[j] = ok ? keys_in[row + t0 + pos] : 0;
    val[j] = ok ? (vals_in ? vals_in[row + t0 + pos] : (int32_t)(t0 + pos)) : 0;
  }
  int32_t* counters = smem + wp * kMaxBins;
  const uint32_t lower_lanes = (1u << lane) - 1u;
  int32_t rank[kItems];  // the rank among the warp's equal digits, later the slot in the tile
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool ok = pos0 + j * 32 < valid;
    const uint32_t d = digit_of(key[j], shift, bits);
    const uint32_t peers = match_digit(d, ok, bits);
    const int32_t before = ok ? counters[d] : 0;
    __syncwarp();
    rank[j] = before + __popc(peers & lower_lanes);
    if (ok && !(peers & lower_lanes)) counters[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // per digit: warp counters -> exclusive over warps; the tile's count
  int32_t cnt[2] = {0, 0};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int d = 2 * tid + q;
    if (d < nb) {
      int32_t sum = 0;
      for (int k = 0; k < kWarps; ++k) {
        const int32_t c = smem[k * kMaxBins + d];
        smem[k * kMaxBins + d] = sum;
        sum += c;
      }
      cnt[q] = sum;
    }
  }
  // digit offsets inside the tile (each thread owns digits 2 tid, 2 tid + 1)
  const int32_t e = block_excl_sum<kThreads>(cnt[0] + cnt[1], warp_sums);

  // decoupled look-back over the window's earlier tiles, per digit
  uint32_t* mine = status + ((int64_t)w * tiles + tile) * nb;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int d = 2 * tid + q;
    if (d < nb) *(volatile uint32_t*)&mine[d] = (tile ? kFlagAggregate : kFlagPrefix) | (uint32_t)cnt[q];
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int d = 2 * tid + q;
    if (d >= nb) continue;
    int32_t prefix = 0;
    if (tile) {
      for (int t = tile - 1;; --t) {
        const volatile uint32_t* cell = status + ((int64_t)w * tiles + t) * nb + d;
        uint32_t v;
        do {
          v = *cell;
        } while (!(v & ~kCountMask));
        prefix += (int32_t)(v & kCountMask);
        if ((v & ~kCountMask) == kFlagPrefix) break;
      }
      *(volatile uint32_t*)&mine[d] = kFlagPrefix | (uint32_t)(prefix + cnt[q]);
    }
    const int32_t local = q ? e + cnt[0] : e;
    s_local[d] = local;
    s_base[d] = excl[w * kMaxBins + d] + prefix - local;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = digit_of(key[j], shift, bits);
    rank[j] += s_local[d] + smem[wp * kMaxBins + d];
  }
  __syncthreads();  // the counters are read: the buffer becomes the tile
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (pos0 + j * 32 < valid) {
      smem[rank[j]] = key[j];
      smem[kTile + rank[j]] = val[j];
    }
  }
  __syncthreads();
  for (int s = tid; s < valid; s += kThreads) {
    const int32_t k = smem[s];
    const int64_t g = row + s_base[digit_of(k, shift, bits)] + s;
    keys_out[g] = k;
    vals_out[g] = smem[kTile + s];
  }
}

// incl (zero on entry) gets i + 1 at the bin of each key's last position;
// blockIdx.y is the window.
__global__ void k_run_ends(const int32_t* __restrict__ sorted, int32_t* __restrict__ incl,
                           int n, int bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* row = sorted + (int64_t)blockIdx.y * n;
  const int32_t k = row[i];
  if (k < 0 || k >= bins) return;
  if (i == n - 1 || row[i + 1] != k) incl[(int64_t)blockIdx.y * bins + k] = i + 1;
}

// Inclusive max-scan of each window's bins, 1024 bins a block. The carry
// into a block, the count of keys below its first bin b0, is the last
// pass's exclusive offset of digit b0 >> shift: b0 is a multiple of 2^shift,
// so a key is below b0 exactly when its last digit is below b0's.
__global__ void __launch_bounds__(kFillThreads) k_fill(const int32_t* __restrict__ excl_last,
                                                       int shift, int32_t* __restrict__ incl,
                                                       int bins) {
  __shared__ int32_t warp_max[kFillThreads / 32];
  const int w = blockIdx.y;
  const int b0 = blockIdx.x * kFillThreads, b = b0 + threadIdx.x;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int32_t carry = excl_last[w * kMaxBins + (b0 >> shift)];
  int32_t* row = incl + (int64_t)w * bins;
  int32_t x = b < bins ? row[b] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) warp_max[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int32_t s = warp_max[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s = max(s, y);
    }
    warp_max[lane] = s;
  }
  __syncthreads();
  x = max(x, max(carry, wid ? warp_max[wid - 1] : 0));
  if (b < bins) row[b] = x;
}

// The passes' digits, from the bottom bit up; they must cover keys < bins.
bool make_plan(int passes, const int* bits, int bins, Plan& plan) {
  if (passes < 1 || passes > kMaxPasses) return false;
  plan.passes = passes;
  int shift = 0;
  for (int p = 0; p < kMaxPasses; ++p) {
    plan.shift[p] = shift;
    plan.bits[p] = p < passes ? bits[p] : 0;
    if (p < passes && (bits[p] < 1 || bits[p] > kMaxBits)) return false;
    shift += plan.bits[p];
  }
  return bins >= 1 && (int64_t)bins <= ((int64_t)1 << shift);
}

struct Layout {  // int32 words of scratch, in order; word 0 counts bad keys
  int64_t hist, counters, status[kMaxPasses], tmp_keys, tmp_vals, zeroed, total;
};

Layout layout(const Plan& plan, int w, int64_t n) {
  Layout l{};
  const int64_t tiles = (n + kTile - 1) / kTile;
  int64_t at = 1;
  l.hist = at;
  at += (int64_t)plan.passes * w * kMaxBins;
  l.counters = at;
  at += kMaxPasses;
  for (int p = 0; p < plan.passes; ++p) {
    l.status[p] = at;
    at += (int64_t)w * tiles << plan.bits[p];
  }
  l.zeroed = at;
  l.tmp_keys = at;
  l.tmp_vals = at + (plan.passes > 1 ? (int64_t)w * n : 0);
  l.total = l.tmp_vals + (plan.passes > 1 ? (int64_t)w * n : 0);
  return l;
}

}  // namespace

// int32 words of scratch pc_digit_sort needs (or -1 for a bad plan).
extern "C" long long pc_digit_sort_scratch(int w, long long n, int bins, int passes,
                                           const int* bits) {
  Plan plan;
  if (w < 0 || n < 0 || !make_plan(passes, bits, bins, plan)) return -1;
  return layout(plan, w, n).total;
}

// keys (w, n) int32, expected in [0, bins); outputs order, sorted (w, n) and
// incl (w, bins) int32. scratch holds pc_digit_sort_scratch(...) int32
// words; word 0 gets the number of keys outside [0, bins). The passes take
// bits[0], bits[1], ... digit bits from the bottom up and must cover the
// keys' bits. Returns cudaGetLastError() after the launches (or -1 for bad
// arguments).
extern "C" int pc_digit_sort(const void* keys, void* order, void* sorted, void* incl,
                             void* scratch, int w, long long n, int bins, int passes,
                             const int* bits, void* stream) {
  Plan plan;
  if (w < 0 || n < 0 || n > (long long)kCountMask || w > 65535 ||
      !make_plan(passes, bits, bins, plan))
    return -1;
  if (w == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Layout l = layout(plan, w, n);
  int32_t* base = (int32_t*)scratch;
  const int tiles = (int)((n + kTile - 1) / kTile);
  cudaMemsetAsync(base, 0, (size_t)l.zeroed * sizeof(int32_t), s);
  cudaMemsetAsync(incl, 0, (size_t)w * bins * sizeof(int32_t), s);
  k_upsweep<<<dim3((unsigned)((n + kUpTile - 1) / kUpTile), w), kThreads, 0, s>>>(
      (const int32_t*)keys, base + l.hist, base, n, w, bins, plan);
  k_scan<<<dim3(w, plan.passes), kMaxBins, 0, s>>>(base + l.hist, w);
  const int32_t* in_keys = (const int32_t*)keys;
  const int32_t* in_vals = nullptr;
  for (int p = 0; p < plan.passes; ++p) {
    const bool last = p == plan.passes - 1;
    int32_t* out_keys = last ? (int32_t*)sorted : base + l.tmp_keys;
    int32_t* out_vals = last ? (int32_t*)order : base + l.tmp_vals;
    k_pass<<<(unsigned)(w * tiles), kThreads, 0, s>>>(
        in_keys, in_vals, out_keys, out_vals, base + l.hist + (int64_t)p * w * kMaxBins,
        (uint32_t*)(base + l.status[p]), base + l.counters + p, n, w, tiles, plan.shift[p],
        plan.bits[p]);
    in_keys = out_keys;
    in_vals = out_vals;
  }
  k_run_ends<<<dim3((unsigned)((n + 255) / 256), w), 256, 0, s>>>((const int32_t*)sorted,
                                                                 (int32_t*)incl, (int)n, bins);
  const int last = plan.passes - 1;
  k_fill<<<dim3((bins + kFillThreads - 1) / kFillThreads, w), kFillThreads, 0, s>>>(
      base + l.hist + (int64_t)last * w * kMaxBins, plan.shift[last], (int32_t*)incl, bins);
  return (int)cudaGetLastError();
}
