// pc_blake2s_columns: the Blake2s-256 digest of every column of a linear
// code's encoded matrix, in one launch (utils/merkle.py blake2s_columns,
// behind pcs/linear_codes/engine.py column_leaves on a CUDA tensor).
//
// Replaces no TPU kernel. The JAX package hashes the columns on the host
// (poly_commit_tpu/pcs/linear_codes/engine.py _col_hash, hashlib), and so
// did the port: it transposed the matrix on the device, took it out of
// Montgomery form, copied every column's 32 n_rows serialized bytes to the
// host and ran hashlib.blake2s once a column. Here the bytes never leave
// the card; only the n_ext 32-byte digests do.
//
// Input: ext_mat (n_rows, n_ext, 16) int32, element-major (each element's
// 16 little-endian 16-bit limbs, 64 bytes, contiguous), an 8-word field in
// Montgomery form, lazily below 2p. Column c's message is fields_to_bytes
// of its n_rows canonical values: 32 bytes each, little endian, which are
// the canonical value's 8 little-endian 32-bit words, and so 8 Blake2s
// message words as they stand. Two elements fill one 64-byte block; when
// n_rows is odd the last block is half zero padding. Blake2s-256 unkeyed:
// parameter word 0x01010020, the byte count in t, the final flag on the
// last block only (a message of a whole number of blocks ends on its last
// full block; no rows hash as one empty block).
//
// Design: one thread a column, neighbouring threads on neighbouring
// columns, so a warp's reads of one row are 32 x 64 contiguous bytes and
// coalesce; the matrix is read in place, with no transposed copy. Each
// element: its limb pairs packed to 8 words (as fe_load_packed does), one
// fe_mul by 1 (out of Montgomery form: the result is at most p) and one
// conditional subtraction of p. The next block's limbs are loaded before
// the current block is compressed, so the loads overlap the arithmetic.
//
// What bounds it on this card: operations. At Ligero's 256 x 32,768:
// 32,768 x 128 compressions x 960 instructions (10 rounds x 8 G x 12: two
// three-input adds, two adds, four xors, four rotates) = 4.03 G, and
// 8,388,608 products by 1 x 264 IMADs = 2.21 G, together ~0.37 ms at
// 16.7 T 32-bit operations a second; the 537 MB read takes 0.16 ms at
// 3.35 TB/s. 32,768 threads fill ~12 % of the card's thread slots, so the
// four independent G functions of each half round, not other warps, keep
// the pipelines busy.
#include <cstring>

#include "ff.cuh"

namespace {

constexpr int NW = 8;
constexpr int THREADS = 128;
constexpr int LIMB_VECS = 4;  // int4 loads an element (16 int32 limbs)

#define BLAKE2S_IV                                                                 \
  {                                                                                \
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu, \
        0x1F83D9ABu, 0x5BE0CD19u                                                   \
  }

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d, uint32_t x,
                                  uint32_t y) {
  a = a + b + x;
  d = rotr(d ^ a, 16);
  c = c + d;
  b = rotr(b ^ c, 12);
  a = a + b + y;
  d = rotr(d ^ a, 8);
  c = c + d;
  b = rotr(b ^ c, 7);
}

// One round; the message schedule (sigma) as template arguments, so every
// message word is a register and none is indexed at run time.
template <int S0, int S1, int S2, int S3, int S4, int S5, int S6, int S7, int S8, int S9,
          int S10, int S11, int S12, int S13, int S14, int S15>
__device__ __forceinline__ void blake_round(uint32_t (&v)[16], const uint32_t (&m)[16]) {
  g(v[0], v[4], v[8], v[12], m[S0], m[S1]);
  g(v[1], v[5], v[9], v[13], m[S2], m[S3]);
  g(v[2], v[6], v[10], v[14], m[S4], m[S5]);
  g(v[3], v[7], v[11], v[15], m[S6], m[S7]);
  g(v[0], v[5], v[10], v[15], m[S8], m[S9]);
  g(v[1], v[6], v[11], v[12], m[S10], m[S11]);
  g(v[2], v[7], v[8], v[13], m[S12], m[S13]);
  g(v[3], v[4], v[9], v[14], m[S14], m[S15]);
}

// The compression of block m into h; t is the byte count so far, this
// block's included.
__device__ __forceinline__ void compress(uint32_t (&h)[8], const uint32_t (&m)[16], uint64_t t,
                                         bool last) {
  const uint32_t iv[8] = BLAKE2S_IV;
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[8 + i] = iv[i];
  }
  v[12] ^= (uint32_t)t;
  v[13] ^= (uint32_t)(t >> 32);
  if (last) v[14] = ~v[14];
  blake_round<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15>(v, m);
  blake_round<14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3>(v, m);
  blake_round<11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4>(v, m);
  blake_round<7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8>(v, m);
  blake_round<9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13>(v, m);
  blake_round<2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9>(v, m);
  blake_round<12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11>(v, m);
  blake_round<13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10>(v, m);
  blake_round<6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5>(v, m);
  blake_round<10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0>(v, m);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// The limbs of rows 2 b and 2 b + 1 of column col (zeros past n_rows).
__device__ __forceinline__ void load_block(int4 (&raw)[2 * LIMB_VECS],
                                           const int4* __restrict__ mat, int64_t n_ext,
                                           int64_t col, int b, int n_rows) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = 2 * b + e;
    const int4* p = mat + ((int64_t)row * n_ext + col) * LIMB_VECS;
#pragma unroll
    for (int q = 0; q < LIMB_VECS; ++q)
      raw[e * LIMB_VECS + q] = row < n_rows ? p[q] : make_int4(0, 0, 0, 0);
  }
}

// Message words w[0..7] of one element: its canonical value's 8 words
// (zero limbs, the padding past n_rows, give zero words).
__device__ __forceinline__ void element_words(uint32_t* w, const int4* raw, const FieldConsts& c) {
  Fe<NW> x, one;
#pragma unroll
  for (int q = 0; q < LIMB_VECS; ++q) {  // limb pairs into words, as fe_load_packed
    x.w[2 * q] = __byte_perm((uint32_t)raw[q].x, (uint32_t)raw[q].y, 0x5410);
    x.w[2 * q + 1] = __byte_perm((uint32_t)raw[q].z, (uint32_t)raw[q].w, 0x5410);
  }
  fe_set_zero<NW>(one);
  one.w[0] = 1u;
  fe_mul<NW>(x, x, one, c);  // x R^-1: at most p for x < 2p
  const uint32_t borrow = words_sub<NW>(w, x.w, c.p);
  if (borrow) {
#pragma unroll
    for (int k = 0; k < NW; ++k) w[k] = x.w[k];
  }
}

__global__ void __launch_bounds__(THREADS) k_columns(const int4* __restrict__ mat,
                                                     uint32_t* __restrict__ out, int n_rows,
                                                     int64_t n_ext, FieldConsts c) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_ext) return;
  uint32_t h[8] = BLAKE2S_IV;
  h[0] ^= 0x01010020u;  // digest 32 bytes, no key, fanout 1, depth 1
  const int blocks = n_rows > 0 ? (n_rows + 1) / 2 : 1;
  const uint64_t total = 32ull * (uint64_t)n_rows;
  int4 cur[2 * LIMB_VECS];
  load_block(cur, mat, n_ext, col, 0, n_rows);
  for (int b = 0; b < blocks; ++b) {
    const bool last = b + 1 == blocks;
    int4 next[2 * LIMB_VECS];  // zeros after the last block
    load_block(next, mat, n_ext, col, b + 1, n_rows);
    uint32_t m[16];
    element_words(m, cur, c);
    element_words(m + 8, cur + LIMB_VECS, c);
    compress(h, m, last ? total : 64ull * (uint64_t)(b + 1), last);
#pragma unroll
    for (int q = 0; q < 2 * LIMB_VECS; ++q) cur[q] = next[q];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[col * 8 + i] = h[i];
}

}  // namespace

// mat: (n_rows, n_ext, 16) int32 limbs of an 8-word field, contiguous and
// 16-byte aligned; out: (n_ext, 8) 32-bit digest words, little endian.
// Returns cudaGetLastError() after the launch, or -1 for bad arguments.
extern "C" int pc_blake2s_columns(const void* mat, void* out, int n_rows, long long n_ext,
                                  const uint32_t* consts, void* stream) {
  if (n_rows < 0 || n_ext < 0 || ((uintptr_t)mat & 15u)) return -1;
  if (n_ext == 0) return 0;
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(c));
  const unsigned grid = (unsigned)((n_ext + THREADS - 1) / THREADS);
  k_columns<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const int4*)mat, (uint32_t*)out, n_rows,
                                                        n_ext, c);
  return (int)cudaGetLastError();
}
