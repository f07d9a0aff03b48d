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

// ---- wgmma (csrc/match_rows_wg.cuh) ---------------------------------------------
//
// wgmma m64nNk8 .tf32 with float32 accumulation: B (and A where it comes
// from shared memory) through a descriptor of the K-major 128-byte-swizzle
// layout (csrc/bf16_mma.cuh): rows of 32 floats, a k-step 32 bytes. The
// register A fragment of warp w (rows 16 w .. 16 w + 15) is the m16n8k8 one
// above; the accumulator that of wgmma at bf16. The tensor core reads each
// operand truncated to TF32.

template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  static constexpr int NT = 8;
  // d += A (64 x 8, registers) @ B (8 x 64, descriptor)
  static __device__ __forceinline__ void rs(float (&d)[NT][4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  // d += A (64 x 8, descriptor) @ B (8 x 64, descriptor)
  static __device__ __forceinline__ void ss(float (&d)[NT][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static constexpr int NT = 16;
  // d += A (64 x 8, descriptor) @ B (8 x 128, descriptor)
  static __device__ __forceinline__ void ss(float (&d)[NT][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The A fragments of k-step s from the 8-column n-tile s of an accumulator:
// a[0] = (g, 2t), a[1] = (g + 8, 2t), a[2] = (g, 2t + 1), a[3] = (g + 8,
// 2t + 1). They sit at the fragment's k positions t and t + 4, so every B
// operand a chain feeds this way holds its K in the order K_PERM gives
// within each 8-group (the wrapper lays the weights out so).
__device__ __forceinline__ void a_from_acc(const float (&n)[4], float (&a)[4]) {
  a[0] = n[0];
  a[1] = n[2];
  a[2] = n[1];
  a[3] = n[3];
}

// Position within an 8-group of K of real column r (0 .. 7) under that order.
__host__ __device__ __forceinline__ int k_pos(int r) { return (r >> 1) + 4 * (r & 1); }

}  // namespace tf32
