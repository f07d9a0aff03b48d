// 3xTF32 products on Hopper's tensor cores: mma.sync m16n8k8 TF32 with
// float32 accumulation, three passes per product so that a float32 chain
// keeps float32 accuracy (~1e-6 relative).
//
// An operand x is split as hi = x truncated to TF32 (10 mantissa bits, one
// integer op) and lo = x - hi (exact), which the tensor core reads truncated
// to TF32 too; the product is hi*hi + hi*lo + lo*hi, the small terms first.
// One pass would keep about three decimal digits
// (tests/test_torch_match_tf32.py, tests/test_torch_sa_tf32.py).
//
// Fragments of m16n8k8 .tf32 (PTX ISA), lane = 4 g + t:
//   A (16 x 8, row): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
//                    a[3] (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   D (16 x 8):      d[0] (g, 2t), d[1] (g, 2t + 1), d[2] (g + 8, 2t),
//                    d[3] (g + 8, 2t + 1)
#pragma once

#include <stdint.h>

namespace tf32 {

// hi = x truncated to TF32, lo = x - hi (exact); the mma reads lo truncated.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split once, for every n-tile it meets.
struct AFrag { uint32_t hi[4], lo[4]; };

__device__ __forceinline__ AFrag split_a(const float (&a)[4]) {
  AFrag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], f.hi[i], f.lo[i]);
  return f;
}

// A B fragment split once, for every m-tile it meets.
struct BFrag { uint32_t hi[2], lo[2]; };

__device__ __forceinline__ BFrag split_b(float b0, float b1) {
  BFrag f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

// d += a b in three passes, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, const BFrag& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

}  // namespace tf32
