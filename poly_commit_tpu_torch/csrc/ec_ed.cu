// K2b: extended twisted Edwards formulas (a = -1, add-2008-hwcd-3) on
// JubJub, LANES adjacent lanes per point, every temporary in registers.
// Replaces the ed_* entries of poly_commit_tpu/core/ec_lf.py::_ec_fn
// (ed_madd, its packed form, ed_add, and ed_double as ed_add(p, p)), and,
// in one launch, the per-bit chain of them that a scalar multiplication by
// one shared scalar runs (poly_commit_tpu/core/curve.py::scalar_mul, a
// lax.scan over the bits).
//
// Points are (x, y, z, t) with x = X/Z, y = Y/Z, T = XY/Z; each coordinate
// an (L, N) = (16, N) int32 tensor of Fr-381 limbs in Montgomery form, lazy
// in [0, 2p); the identity is (0, 1, 1, 0). The unified addition is complete
// on the prime-order subgroup, so there are no branches at all. Fr-381 has
// 4p > R = 2^256, so every product takes ff.cuh's post-reduce branch (the
// ``post`` flag of the constants). The constant 2d arrives in Montgomery
// form beside the field constants.
//
// The lane split: add-2008-hwcd-3's nine products stand in three levels of
// independent products: A = (y1 - x1)(y2 - x2), B = (y1 + x1)(y2 + x2),
// z1 z2 and t1 2d; then C = (t1 2d) t2; then X3 = EF, Y3 = GH, Z3 = FG,
// T3 = EH. Lane l of a point computes the products l, l + LANES, ... of each
// level, the same instruction stream on every lane with its operands chosen
// by select, and the lanes of a point exchange the level's results by
// __shfl_sync. With four lanes a lane's dependent depth is 3 products in
// place of 9. Every product has the plain version's operands in the plain
// version's order, so the results are bit for bit the plain version's. Lane
// l loads and stores the coordinates l, l + LANES, ...: a warp's access is
// LANES contiguous runs, the same sectors as one. The scalar multiplication
// runs four lanes a point (SMUL_LANES): its folds below 2^13 points are one
// dependent chain, shorter at four lanes than at one or two. The element
// formulas run one lane a point (ED_LANES): at the MSM's 2^16 points, more
// lanes gained nothing on the card.
//
// pc_ec_ed_smul runs k P for one scalar k shared by every point: the
// point is loaded once, the MSB-first double-and-add runs in registers
// (the unified addition for the doubling too, as ed_double, so each step
// is limb for limb the chain of launches it replaces), and the result is
// stored once. The bits arrive by value; the loop is uniform over the warp.
//
// What bounds it on the card: ed_madd reads 6 and writes 4 coordinates
// (320 bytes at 2 bytes a limb) and does 9 products of 264 IMADs (2,376):
// bound by integer multiplies. ed_smul does (bits + set bits) formulas per
// point on one read and one write: bound by integer multiplies, and below
// ~2^15 points by the latency of its dependent chain, which the lane split
// shortens.
#include <cstring>

#include "ff.cuh"

namespace {

constexpr int NW = 8;
constexpr int ED_LANES = 1;    // lanes a point of the element formulas
constexpr int SMUL_LANES = 4;  // lanes a point of the scalar multiplication
constexpr int BLOCK = 128;
using E = Fe<NW>;

struct EdArgs {
  const int32_t* in[8];
  int32_t* out[4];
};

struct Scalar {
  uint32_t w[8];  // k, little-endian words
};

enum EdWhich { ED_MADD = 0, ED_MADD_PACKED = 1, ED_ADD = 2, ED_DOUBLE = 3 };

template <int LANES>
__device__ __forceinline__ int lane() { return threadIdx.x & (LANES - 1); }

// r = v[j] for a j known only at run time.
__device__ __forceinline__ void pick4(E& r, int j, const E& v0, const E& v1, const E& v2, const E& v3) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    uint32_t a = j & 1 ? v1.w[k] : v0.w[k];
    uint32_t b = j & 1 ? v3.w[k] : v2.w[k];
    r.w[k] = j & 2 ? b : a;
  }
}

// Items 0..M-1 of a point, item j held in slot j / LANES of lane j % LANES:
// every lane of the point gets all M.
template <int LANES, int M>
__device__ __forceinline__ void gather(E (&all)[M], const E (&mine)[(M + LANES - 1) / LANES]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (LANES == 1) {
      all[j] = mine[j];
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k)
        all[j].w[k] = __shfl_sync(0xffffffffu, mine[j / LANES].w[k], j % LANES, LANES);
    }
  }
}

// ptrs[j] for a j known only at run time, without indexing the kernel's
// parameters by a variable.
template <int M, class P>
__device__ __forceinline__ P pick_ptr(P const* ptrs, int j) {
  P r = ptrs[0];
#pragma unroll
  for (int m = 1; m < M; ++m)
    if (j == m) r = ptrs[m];
  return r;
}

// Coordinates of a point from row arrays: lane l loads items l, l + LANES, ...
// (``packed``: two items, x and y, from the packed words of one tensor).
template <int LANES, int M>
__device__ __forceinline__ void load_items(E (&all)[M], const int32_t* const* in, int64_t n, int64_t i,
                                           bool packed) {
  E mine[(M + LANES - 1) / LANES];
#pragma unroll
  for (int s = 0; s < (M + LANES - 1) / LANES; ++s) {
    const int j = lane<LANES>() + s * LANES;
    fe_set_zero<NW>(mine[s]);
    if (j < M) {
      if (packed) fe_load_packed<NW>(mine[s], in[0], n, i, j * NW);
      else fe_load<NW>(mine[s], pick_ptr<M>(in, j), n, i);
    }
  }
  gather<LANES, M>(all, mine);
}

// add-2008-hwcd-3 on one point's lanes; p and q whole on every lane (q[2]
// unread when MIXED, which is z2 = 1: d = 2 z1). Lane l returns coordinates
// l, l + LANES, ... of p + q in out.
template <int LANES, bool MIXED>
__device__ __forceinline__ void ed_add_lanes(E (&out)[4 / LANES], const E (&p)[4], const E (&q)[4],
                                             const E& k2d, const FieldConsts& c) {
  constexpr int S = 4 / LANES;
  const int l = lane<LANES>();
  E v[S];
  {
    E d1, s1, d2, s2;
    fe_sub<NW>(d1, p[1], p[0], c);
    fe_add<NW>(s1, p[1], p[0], c);
    fe_sub<NW>(d2, q[1], q[0], c);
    fe_add<NW>(s2, q[1], q[0], c);
    // level 1: A, B, z1 z2, t1 2d
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = l + s * LANES;
      E x, y;
      pick4(x, j, d1, s1, p[2], p[3]);
      pick4(y, j, d2, s2, q[2], k2d);
      if (!(MIXED && LANES == 1 && s == 2)) fe_mul<NW>(v[s], x, y, c);
    }
  }
  // level 2: C = (t1 2d) t2 in the slot of product 3; d = 2 z1 z2 in that
  // of product 2
  {
    E cc, dd;
    fe_mul<NW>(cc, v[3 / LANES], q[3], c);
    if (MIXED) fe_add<NW>(dd, p[2], p[2], c);
    else fe_add<NW>(dd, v[2 / LANES], v[2 / LANES], c);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = l + s * LANES;
      if (j == 2) v[s] = dd;
      if (j == 3) v[s] = cc;
    }
  }
  E abdc[4];
  gather<LANES, 4>(abdc, v);
  E e, f, g, h;
  fe_sub<NW>(e, abdc[1], abdc[0], c);
  fe_sub<NW>(f, abdc[2], abdc[3], c);
  fe_add<NW>(g, abdc[2], abdc[3], c);
  fe_add<NW>(h, abdc[1], abdc[0], c);
  // level 3: X3 = E F, Y3 = G H, Z3 = F G, T3 = E H
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = l + s * LANES;
    E x, y;
    pick4(x, j, e, g, f, e);
    pick4(y, j, f, h, g, h);
    fe_mul<NW>(out[s], x, y, c);
  }
}

template <int LANES>
__device__ __forceinline__ void store_own(int32_t* const* out, int64_t n, int64_t i,
                                          const E (&mine)[4 / LANES]) {
#pragma unroll
  for (int s = 0; s < 4 / LANES; ++s)
    fe_store<NW>(pick_ptr<4>(out, lane<LANES>() + s * LANES), n, i, mine[s]);
}

// Point i = thread / LANES. Threads past the last point compute point
// n - 1 again and store nothing: every lane stays in the shuffles.
template <int WHICH>
__global__ void __launch_bounds__(BLOCK) k_ed(EdArgs a, int64_t n, FieldConsts c, E k2d) {
  constexpr int LANES = ED_LANES;
  int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const bool live = i < n;
  if (!live) i = n - 1;
  E p[4], q[4], o[4 / LANES];
  load_items<LANES, 4>(p, a.in, n, i, false);
  if (WHICH == ED_ADD || WHICH == ED_DOUBLE) {
    if (WHICH == ED_ADD) load_items<LANES, 4>(q, a.in + 4, n, i, false);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (WHICH == ED_DOUBLE) q[k] = p[k];
    ed_add_lanes<LANES, false>(o, p, q, k2d, c);
  } else {
    E xy[2];
    load_items<LANES, 2>(xy, a.in + 4, n, i, WHICH == ED_MADD_PACKED);
    q[0] = xy[0];
    q[1] = xy[1];
    fe_set_zero<NW>(q[2]);
    fe_mul<NW>(q[3], xy[0], xy[1], c);
    ed_add_lanes<LANES, true>(o, p, q, k2d, c);
  }
  if (live) store_own<LANES>(a.out, n, i, o);
}

// k P, MSB first over nbits bits of k: for each bit acc = acc + acc, then
// acc = acc + P where the bit is set; acc starts at the identity. One
// formula a step, its second operand acc or P.
__global__ void __launch_bounds__(BLOCK) k_ed_smul(EdArgs a, int64_t n, FieldConsts c, E k2d, Scalar k,
                                                   int nbits) {
  constexpr int LANES = SMUL_LANES;
  int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / LANES;
  const bool live = i < n;
  if (!live) i = n - 1;
  E base[4], acc[4], q[4], o[4 / LANES];
  load_items<LANES, 4>(base, a.in, n, i, false);
  fe_set_zero<NW>(acc[0]);
  fe_set_one<NW>(acc[1], c);
  fe_set_one<NW>(acc[2], c);
  fe_set_zero<NW>(acc[3]);
  int b = nbits - 1;
  bool doubling = true;
  while (b >= 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int w = 0; w < NW; ++w) q[j].w[w] = doubling ? acc[j].w[w] : base[j].w[w];
    ed_add_lanes<LANES, false>(o, acc, q, k2d, c);
    gather<LANES, 4>(acc, o);
    uint32_t word = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w)
      if (w == (b >> 5)) word = k.w[w];
    if (doubling && ((word >> (b & 31)) & 1u)) {
      doubling = false;
    } else {
      doubling = true;
      --b;
    }
  }
  // this lane's coordinates of acc (k = 0 runs no step)
#pragma unroll
  for (int s = 0; s < 4 / LANES; ++s) pick4(o[s], lane<LANES>() + s * LANES, acc[0], acc[1], acc[2], acc[3]);
  if (live) store_own<LANES>(a.out, n, i, o);
}

void ed_args(EdArgs& a, FieldConsts& c, E& kd, void* const* ins, void* const* outs,
             const uint32_t* consts, const uint32_t* k2d) {
  for (int k = 0; k < 8; ++k) a.in[k] = (const int32_t*)ins[k];
  for (int k = 0; k < 4; ++k) a.out[k] = (int32_t*)outs[k];
  std::memcpy(&c, consts, sizeof(c));
  std::memcpy(kd.w, k2d, sizeof(kd.w));
}

dim3 ed_grid(long long n, int lanes) { return dim3((unsigned)((n * lanes + BLOCK - 1) / BLOCK)); }

}  // namespace

// which: 0 ed_madd, 1 ed_madd_packed, 2 ed_add, 3 ed_double. ins/outs: host
// arrays of device pointers (8 and 4); k2d: 2d in Montgomery form, 8 words.
// Returns cudaGetLastError() after the launch (or -1 for bad arguments).
extern "C" int pc_ec_ed_op(int which, void* const* ins, void* const* outs, long long n,
                           const uint32_t* consts, const uint32_t* k2d, void* stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  EdArgs a;
  FieldConsts c;
  E kd;
  ed_args(a, c, kd, ins, outs, consts, k2d);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid = ed_grid(n, ED_LANES);
  switch (which) {
    case ED_MADD: k_ed<ED_MADD><<<grid, BLOCK, 0, s>>>(a, n, c, kd); break;
    case ED_MADD_PACKED: k_ed<ED_MADD_PACKED><<<grid, BLOCK, 0, s>>>(a, n, c, kd); break;
    case ED_ADD: k_ed<ED_ADD><<<grid, BLOCK, 0, s>>>(a, n, c, kd); break;
    case ED_DOUBLE: k_ed<ED_DOUBLE><<<grid, BLOCK, 0, s>>>(a, n, c, kd); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// k P for the 4 coordinate tensors of P (ins) into outs; k as 8 words,
// little-endian, of which the low nbits (0..256) are walked MSB first.
// Returns cudaGetLastError() after the launch (or -1 for bad arguments).
extern "C" int pc_ec_ed_smul(void* const* ins, void* const* outs, long long n, const uint32_t* consts,
                             const uint32_t* k2d, const uint32_t* kwords, int nbits, void* stream) {
  if (n < 0 || nbits < 0 || nbits > 256) return -1;
  if (n == 0) return 0;
  EdArgs a;
  FieldConsts c;
  E kd;
  void* in8[8] = {ins[0], ins[1], ins[2], ins[3], nullptr, nullptr, nullptr, nullptr};
  ed_args(a, c, kd, in8, outs, consts, k2d);
  Scalar k;
  std::memcpy(k.w, kwords, sizeof(k.w));
  k_ed_smul<<<ed_grid(n, SMUL_LANES), BLOCK, 0, (cudaStream_t)stream>>>(a, n, c, kd, k, nbits);
  return (int)cudaGetLastError();
}
