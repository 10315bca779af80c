// K2b: extended twisted Edwards formulas (a = -1, add-2008-hwcd-3) on
// JubJub, one thread per point, every temporary in registers. Replaces the
// ed_* entries of poly_commit_tpu/core/ec_lf.py::_ec_fn (ed_madd, its packed
// form, ed_add, and ed_double as ed_add(p, p)).
//
// Points are (x, y, z, t) with x = X/Z, y = Y/Z, T = XY/Z; each coordinate
// an (L, N) = (16, N) int32 tensor of Fr-381 limbs in Montgomery form, lazy
// in [0, 2p); the identity is (0, 1, 1, 0). The unified addition is complete
// on the prime-order subgroup, so there are no branches at all. Fr-381 has
// 4p > R = 2^256, so every product takes ff.cuh's post-reduce branch (the
// ``post`` flag of the constants). The constant 2d arrives in Montgomery
// form beside the field constants.
//
// What bounds it on the card: ed_madd reads 6 and writes 4 coordinates
// (640 bytes as int32 limbs) and does 9 products of 264 IMADs (2,376): 3.7
// IMADs per byte, under the card's ratio of about 5 (16.7 T IMAD/s against
// 3.35 TB/s), so at this layout the bytes bound it, by a small margin. The
// design reads and writes each coordinate once and keeps the ~10 temporaries
// of 8 words in registers.
#include <cstring>

#include "ff.cuh"

namespace {

constexpr int NW = 8;
using E = Fe<NW>;

struct EdArgs {
  const int32_t* in[8];
  int32_t* out[4];
};

struct EdPt {
  E x, y, z, t;
};

enum EdWhich { ED_MADD = 0, ED_MADD_PACKED = 1, ED_ADD = 2, ED_DOUBLE = 3 };

// add-2008-hwcd-3; z2 null means z2 = 1 (the mixed add: d = 2 z1).
__device__ __forceinline__ void ed_add(EdPt& o, const EdPt& p, const E& x2, const E& y2, const E* z2,
                                       const E& t2, const E& k2d, const FieldConsts& c) {
  E a, b, cc, d, e, f, g, h, u;
  fe_sub<NW>(u, p.y, p.x, c);
  fe_sub<NW>(a, y2, x2, c);
  fe_mul<NW>(a, u, a, c);
  fe_add<NW>(u, p.y, p.x, c);
  fe_add<NW>(b, y2, x2, c);
  fe_mul<NW>(b, u, b, c);
  fe_mul<NW>(cc, p.t, k2d, c);
  fe_mul<NW>(cc, cc, t2, c);
  if (z2) {
    fe_mul<NW>(u, p.z, *z2, c);
    fe_add<NW>(d, u, u, c);
  } else {
    fe_add<NW>(d, p.z, p.z, c);
  }
  fe_sub<NW>(e, b, a, c);
  fe_sub<NW>(f, d, cc, c);
  fe_add<NW>(g, d, cc, c);
  fe_add<NW>(h, b, a, c);
  fe_mul<NW>(o.x, e, f, c);
  fe_mul<NW>(o.y, g, h, c);
  fe_mul<NW>(o.z, f, g, c);
  fe_mul<NW>(o.t, e, h, c);
}

__device__ __forceinline__ void load_ed(EdPt& p, const int32_t* const* in, int64_t n, int64_t i) {
  fe_load<NW>(p.x, in[0], n, i);
  fe_load<NW>(p.y, in[1], n, i);
  fe_load<NW>(p.z, in[2], n, i);
  fe_load<NW>(p.t, in[3], n, i);
}

template <int WHICH>
__global__ void __launch_bounds__(128) k_ed(EdArgs a, int64_t n, FieldConsts c, E k2d) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EdPt p, o;
  load_ed(p, a.in, n, i);
  if (WHICH == ED_ADD || WHICH == ED_DOUBLE) {
    EdPt q;
    if (WHICH == ED_ADD) load_ed(q, a.in + 4, n, i);
    else q = p;
    ed_add(o, p, q.x, q.y, &q.z, q.t, k2d, c);
  } else {
    E x2, y2, t2;
    if (WHICH == ED_MADD_PACKED) {
      fe_load_packed<NW>(x2, a.in[4], n, i, 0);
      fe_load_packed<NW>(y2, a.in[4], n, i, NW);
    } else {
      fe_load<NW>(x2, a.in[4], n, i);
      fe_load<NW>(y2, a.in[5], n, i);
    }
    fe_mul<NW>(t2, x2, y2, c);
    ed_add(o, p, x2, y2, nullptr, t2, k2d, c);
  }
  fe_store<NW>(a.out[0], n, i, o.x);
  fe_store<NW>(a.out[1], n, i, o.y);
  fe_store<NW>(a.out[2], n, i, o.z);
  fe_store<NW>(a.out[3], n, i, o.t);
}

}  // namespace

// which: 0 ed_madd, 1 ed_madd_packed, 2 ed_add, 3 ed_double. ins/outs: host
// arrays of device pointers (8 and 4); k2d: 2d in Montgomery form, 8 words.
// Returns cudaGetLastError() after the launch (or -1 for bad arguments).
extern "C" int pc_ec_ed_op(int which, void* const* ins, void* const* outs, long long n,
                           const uint32_t* consts, const uint32_t* k2d, void* stream) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  EdArgs a;
  for (int k = 0; k < 8; ++k) a.in[k] = (const int32_t*)ins[k];
  for (int k = 0; k < 4; ++k) a.out[k] = (int32_t*)outs[k];
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(c));
  E kd;
  std::memcpy(kd.w, k2d, sizeof(kd.w));
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)((n + 127) / 128));
  switch (which) {
    case ED_MADD: k_ed<ED_MADD><<<grid, 128, 0, s>>>(a, n, c, kd); break;
    case ED_MADD_PACKED: k_ed<ED_MADD_PACKED><<<grid, 128, 0, s>>>(a, n, c, kd); break;
    case ED_ADD: k_ed<ED_ADD><<<grid, 128, 0, s>>>(a, n, c, kd); break;
    case ED_DOUBLE: k_ed<ED_DOUBLE><<<grid, 128, 0, s>>>(a, n, c, kd); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
