// Eval-mode SA stage of the point backbone: gather + edge MLP + max over K,
// on Hopper's tensor cores with float32 accuracy (3xTF32).
//
// Replaces the TPU kernel point_cloud_reid_tpu/ops/pallas/sa_stage.py
// (fused_sa_convmax, _kernel). Per crop b and centre s it computes
//
//   h1[k] = relu((A[b, idx[b,s,k]] + Ct[b,s]) * s1 + t1)
//   h2[k] = relu((h1[k] @ w2) * s2 + t2)
//   h3[k] = relu((h2[k] @ w3) * s3 + t3)
//   out[b,s] = max_k h3[k]
//
// with BN folded into the (C,) affines by the wrapper. The TPU kernel's
// one-hot gather matmul and k-major row layout are Mosaic workarounds;
// here a block reads its neighbour rows straight from A.
//
// Products: the two C x C products run as mma.sync m16n8k8 TF32 in three
// passes (tf32_mma.cuh: hi truncated, hi*hi + hi*lo + lo*hi, float32
// accumulation), which keeps the stage within a few 1e-6 of the float32
// plain version; one pass would read ~2e-4 (tests/test_torch_sa_tf32.py).
// The gather, the affines, ReLU and the max stay float32 on the CUDA cores.
//
// Row tiles. The rows (b, s, k) are one list of R = B S K rows, and a block
// of W warps owns M consecutive rows of it. The block
//  1. gathers its M rows of A, adds the centre term, applies BN1 + ReLU into
//     buffer 1 (M x (C + 4) floats: the padding keeps the ldmatrix loads of
//     the A fragments free of bank conflicts); barrier;
//  2. conv2: each warp computes its own columns of h1 @ w2 for all M rows
//     in registers, then the affine + ReLU into buffer 2; barrier;
//  3. conv3 the same from buffer 2 into buffer 1, which is free; barrier;
//  4. takes the max over each centre's rows of buffer 1 and stores it.
// In 2 and 3 a warp owns NT n-tiles (8 NT columns) and reads their B
// fragments straight from device memory (L2 hits: w2 and w3 are shared by
// every block), PF k-steps ahead in registers, and splits each weight
// element into hi and lo once: no other warp of the block reads it, so each
// weight is read and split once per block of M rows. Each warp loads its A
// fragments from shared memory with ldmatrix and splits them itself.
// M is set per C by registers and shared memory: 4 MT NT accumulators a
// thread (MT = M / 16) with the whole thread under 128 registers, so that
// an SM holds 16 warps (two 8-warp blocks, or one 16-warp block where C
// gives 16 column chunks), and the two buffers within that SM's share:
//   C = 128 (SA1): 8 warps, NT 2, M 64 (2 centres at K = 32), 68 KB, two
//                  blocks a SM;
//   C = 256 (SA2): 8 warps, NT 4, M 48 (1 centre at K = 48), 100 KB, two
//                  blocks a SM;
//   C = 512 (SA3): 16 warps, NT 4, M 48 (1 centre), 198 KB, one block;
// From 928 channels two buffers hold only one 16-row m-tile (132 KB at
// C = 1024; past 1,792 not even that: 262,656 bytes at 2048), every 16-row
// block re-reads both weights from L2, and the wide layout takes the stage
// (csrc/sa_wide_wg.cuh at policy Tf32, entry pcr_sa_convmax_wide, from
// WIDE_FROM = 928 to 8192, run at the next multiple of 64): a persistent
// grid whose weight stages each serve 128 rows through a shared-memory
// ring, h1 and h2 in a device scratch streamed back as A stages, every
// product on wgmma in three TF32 passes, conv3 fused with the max; about 2x
// faster than the 16-row tiles at 928-1,792 and 3.1x faster than their
// first version past 1,792, the h1-from-gather layout (PERF.md section 6).
// Weight reads per call at B = 128: 1.07 / 4.3 / 8.6 GB for SA1/2/3, from
// L2 (the SIMT kernel before this one read 4.3 / 12.9 / 25.8 GB). Larger
// tiles with one 8-warp block a SM (M = 128 / 96 / 48, up to 236
// registers) read half as much and were 1.4x / 1.1x slower at SA1 / SA2:
// with one block a SM nothing overlaps its gather and its barriers.
// The row tiles take any C that is a multiple of 32, 32 to 896 (from
// WIDE_FROM their entry refuses; kernels/sa_stage pads any other width to
// the next multiple of 32): NT is 1, 2 or 4,
// the largest that still gives every warp a chunk of columns (C = 32: two
// row groups of 4 warps, each reading the weights); where the chunks do not
// divide among the warps, some warps take one more.
// The max: every h3 is a ReLU output >= 0, so 0 is the identity and the
// float order is the order of the bits as integers. Where M is a multiple
// of K every centre lies whole in one block and its max is stored plainly;
// otherwise (K = 48 at M = 32, or K = 12 at M = 128) a block's edge
// centres are partial and go out by atomicMax on the bits into an `out`
// that the entry point zero-fills first. The max is exact, so the result
// does not depend on the order.
//
// What bounds it on the H100: the products, 4 R C^2 operations, three TF32
// passes each, on the tensor cores: at 495 TFLOP/s 0.208 / 0.625 / 1.249
// ms for SA1/2/3 at B = 128; the bytes (A, Ct, idx, out, weights once),
// ~36 MB, take 0.011 ms. Measured (H100 80GB HBM3, 700 W), SA3 runs its
// tensor work at 196-204 TFLOP/s in three layouts (one 8-warp block of 8
// n-tiles, one 16-warp block of 4) and SA2 at 197: 2.4-2.5x their bound,
// which reads as the rate at which mma.sync issues three-pass TF32 products
// on this card; wgmma, with B in shared memory, is the way past it. SA1
// (C = 128) reaches 144 TFLOP/s: its gather and max are a larger share.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sa_wide_wg.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 8;      // warps a block; 16 where there are 16 column chunks
constexpr int PF = 4;         // k-steps a warp's B fragments are loaded ahead
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may take
constexpr int MAX_C = sawide::MAX_C;   // widest stage (kernels/sa_stage.MAX_C)

struct Args {
  const float* A;     // (B, N, C)
  const float* Ct;    // (B, S, C)
  const int* idx;     // (B, S, K): row r of the list is idx[r]
  const float* w2;    // (C, C) (in, out)
  const float* w3;
  const float* s1; const float* t1; const float* s2; const float* t2;
  const float* s3; const float* t3;
  float* out;         // (B, S, C)
  int N, S, K, C, R;  // R = B S K rows
  int mt, groups, chunks;   // m-tiles per row group, row groups, column chunks
};

// The most m-tiles a warp carries for NT n-tiles (4 MT NT accumulators), so
// that a thread stays within 128 registers.
constexpr int max_mt(int nt) { return nt == 1 ? 8 : nt == 2 ? 4 : 3; }

// The A fragments of a product from a row buffer in shared memory (src,
// rows padded to C + 4): ldmatrix .x4, lanes 0-7 / 8-15 / 16-23 / 24-31
// giving the rows of the four 8 x 4 float blocks a[0] (rows 0-7, cols 0-3),
// a[1] (8-15, 0-3), a[2] (0-7, 4-7), a[3] (8-15, 4-7); lane 4g + t
// receives (g, t) of each.
struct SmemA {
  const float* src;
  int LD;
  struct At {
    uint32_t base;
    int LD;
    // m-tile i, k-step kk
    __device__ __forceinline__ void frag(int i, int kk, float (&av)[4]) const {
      uint32_t r[4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                   : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                   : "r"(base + (uint32_t)(i * 16 * LD + kk * 8) * 4u));
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = __uint_as_float(r[q]);
    }
  };
  // the fragments of the job whose rows start at row0
  __device__ __forceinline__ At at(int row0) const {
    const int lane = threadIdx.x & 31;
    return At{(uint32_t)__cvta_generic_to_shared(src + (row0 + (lane & 15)) * LD + (lane >> 4) * 4),
              LD};
  }
};

// A product's output into a row buffer (rows padded to C + 4).
struct BufOut {
  float* dst;
  int LD;
  __device__ __forceinline__ void put(int row, int col, float2 v) const {
    *reinterpret_cast<float2*>(dst + row * LD + col) = v;
  }
};

// out(r, c) = relu((A @ w)[r][c] * sc[c] + sh[c]) for the block's rows, a
// warp per (row group, column chunk) job: the A fragments from the row
// buffer `asrc`, the results to the row buffer `out`.
template <int NT, int MT, int W>
__device__ __forceinline__ void conv_layer(const SmemA& asrc, const BufOut& out,
                                           const float* __restrict__ w,
                                           const float* __restrict__ sc,
                                           const float* __restrict__ sh,
                                           const Args& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = p.C, ksteps = C / 8, mt = p.mt;
  for (int job = warp; job < p.groups * p.chunks; job += W) {
    const int row0 = (job / p.chunks) * mt * 16;
    const int col0 = (job % p.chunks) * NT * 8;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    // B fragment of k-step kk, n-tile j: w[8 kk + t][col0 + 8 j + g] and
    // w[8 kk + t + 4][...], loaded PF k-steps ahead (ksteps = C / 8 is a
    // multiple of PF)
    const float* wp = w + (size_t)t * C + col0 + g;
    float bn[PF][NT][2];
#pragma unroll
    for (int q = 0; q < PF; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bn[q][j][0] = __ldg(wp + (size_t)q * 8 * C + 8 * j);
        bn[q][j][1] = __ldg(wp + (size_t)q * 8 * C + 4 * C + 8 * j);
      }
    const auto a = asrc.at(row0);
    for (int k0 = 0; k0 < ksteps; k0 += PF) {
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        const int kk = k0 + q;
        tf32::BFrag bf[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) bf[j] = tf32::split_b(bn[q][j][0], bn[q][j][1]);
        if (kk + PF < ksteps) {
          const float* wn = wp + (size_t)(kk + PF) * 8 * C;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bn[q][j][0] = __ldg(wn + 8 * j);
            bn[q][j][1] = __ldg(wn + 4 * C + 8 * j);
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < mt) {
            float av[4];
            a.frag(i, kk, av);
            const tf32::AFrag af = tf32::split_a(av);
#pragma unroll
            for (int j = 0; j < NT; ++j) tf32::mma3(acc[i][j], af, bf[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(sc + col);
      const float2 h = *reinterpret_cast<const float2*>(sh + col);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mt) {
          const int row = row0 + 16 * i + g;
          out.put(row, col, make_float2(fmaxf(acc[i][j][0] * s.x + h.x, 0.f),
                                        fmaxf(acc[i][j][1] * s.y + h.y, 0.f)));
          out.put(row + 8, col, make_float2(fmaxf(acc[i][j][2] * s.x + h.x, 0.f),
                                            fmaxf(acc[i][j][3] * s.y + h.y, 0.f)));
        }
      }
    }
  }
}

// Registers held to 128 a thread: two 8-warp blocks or one 16-warp block a SM.
template <int NT, int MT, int W>
__global__ void __launch_bounds__(32 * W, 16 / W) sa_convmax_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, LD = C + 4, M = p.groups * p.mt * 16;
  float* buf1 = smem;
  float* buf2 = smem + M * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * M;
  const int rows = min(M, p.R - r0);

  // 1. gather + centre term + BN1 + relu -> buf1; padded rows are 0
  const float4* s1 = reinterpret_cast<const float4*>(p.s1);
  const float4* t1 = reinterpret_cast<const float4*>(p.t1);
  // lane j of a warp holds the source offsets of row warp + W j, so the
  // rows' loads do not wait on each other's index
  const int per = M / W;
  long long src = -1, ctr = 0;
  if (lane < per && warp + W * lane < rows) {
    const int row = r0 + warp + W * lane, centre = row / p.K;
    src = ((long long)(centre / p.S) * p.N + __ldg(p.idx + row)) * C;
    ctr = (long long)centre * C;
  }
#pragma unroll 4
  for (int j = 0; j < per; ++j) {
    const long long sj = __shfl_sync(0xffffffffu, src, j);
    const long long cj = __shfl_sync(0xffffffffu, ctr, j);
    float4* dst = reinterpret_cast<float4*>(buf1 + (warp + W * j) * LD);
    const float4* a = reinterpret_cast<const float4*>(p.A + sj);
    const float4* ct = reinterpret_cast<const float4*>(p.Ct + cj);
    for (int c = lane; c < C / 4; c += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (sj >= 0) {
        const float4 x = __ldg(a + c), y = __ldg(ct + c), s = __ldg(s1 + c),
                     h = __ldg(t1 + c);
        v = make_float4(fmaxf((x.x + y.x) * s.x + h.x, 0.f),
                        fmaxf((x.y + y.y) * s.y + h.y, 0.f),
                        fmaxf((x.z + y.z) * s.z + h.z, 0.f),
                        fmaxf((x.w + y.w) * s.w + h.w, 0.f));
      }
      dst[c] = v;
    }
  }
  __syncthreads();
  // 2, 3. the two convs, each warp its own columns
  conv_layer<NT, MT, W>(SmemA{buf1, LD}, BufOut{buf2, LD}, p.w2, p.s2, p.t2, p);
  __syncthreads();
  conv_layer<NT, MT, W>(SmemA{buf2, LD}, BufOut{buf1, LD}, p.w3, p.s3, p.t3, p);
  __syncthreads();

  // 4. max over each centre's rows in this block
  const int first = r0 / p.K, centres = (r0 + rows - 1) / p.K - first + 1;
  for (int e = threadIdx.x; e < centres * C; e += 32 * W) {
    const int centre = first + e / C, c = e % C;
    const int lo = max(centre * p.K, r0), hi = min((centre + 1) * p.K, r0 + rows);
    float m = 0.f;
    for (int r = lo - r0; r < hi - r0; ++r) m = fmaxf(m, buf1[r * LD + c]);
    float* o = p.out + (size_t)centre * C + c;
    if (lo == centre * p.K && hi == (centre + 1) * p.K)
      *o = m;
    else
      atomicMax(reinterpret_cast<int*>(o), __float_as_int(m));
  }
}

template <int NT, int W>
int launch(const Args& p, size_t smem, int blocks, cudaStream_t stream) {
  constexpr int MT = max_mt(NT);
  cudaError_t err = cudaFuncSetAttribute(
      sa_convmax_kernel<NT, MT, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_convmax_kernel<NT, MT, W><<<blocks, 32 * W, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The row tiles of width C: NT the largest of 1, 2, 4 that leaves at least
// 8 column chunks, 16 warps where there are 16 chunks, MT the most m-tiles
// whose two buffers fit a block's shared memory.
struct Tiles {
  int nt, chunks, warps, groups, mt;
  int M() const { return groups * mt * 16; }
  size_t smem(int C) const { return (size_t)2 * M() * (C + 4) * sizeof(float); }
};

Tiles tiles(int C) {
  const int ntiles = C / 8;
  Tiles tl{1, 0, 0, 0, 0};
  for (int d = 2; d <= 4; d *= 2)
    if (ntiles % d == 0 && ntiles / d >= WARPS) tl.nt = d;
  tl.chunks = ntiles / tl.nt;
  tl.warps = tl.chunks >= 2 * WARPS ? 2 * WARPS : WARPS;
  tl.groups = tl.chunks < tl.warps ? tl.warps / tl.chunks : 1;
  tl.mt = max_mt(tl.nt);
  while (tl.mt > 1 && tl.smem(C) > SMEM_LIMIT) --tl.mt;
  return tl;
}

// The plan: the row tiles below WIDE_FROM channels, the wide layout
// (csrc/sa_wide_wg.cuh) from it (kernels/sa_stage.F32_WIDE_FROM).
constexpr int WIDE_FROM = 928;
enum Layout { TWO_BUFFERS = 0, WIDE = 1 };
enum PlanField { LAYOUT, PLAN_WARPS, NT, TILE_ROWS, SMEM, WHOLE, RING_STAGES, SCRATCH, FIELDS };

// Fills plan[FIELDS] for width C and K neighbours; 0, or
// cudaErrorInvalidValue for a shape neither layout takes.
int make_plan(int C, int K, long long* plan) {
  if (C < 32 || C > MAX_C || C % 32 != 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (C >= WIDE_FROM) {
    long long wgs;
    sawide::plan<sawide::Tf32>(C, plan[TILE_ROWS], wgs, plan[RING_STAGES], plan[SMEM],
                               plan[SCRATCH]);
    plan[LAYOUT] = WIDE;
    plan[PLAN_WARPS] = sawide::THREADS / 32;
    plan[NT] = 16;                     // n-tiles of a warp's 128-column chunk
    plan[WHOLE] = 1;                   // a centre's rows lie in one warp
    return 0;
  }
  const Tiles tl = tiles(C);
  plan[LAYOUT] = TWO_BUFFERS;
  plan[PLAN_WARPS] = tl.warps;
  plan[NT] = tl.nt;
  plan[TILE_ROWS] = tl.M();
  plan[SMEM] = (long long)tl.smem(C);
  plan[WHOLE] = tl.M() % K == 0;
  plan[RING_STAGES] = 0;
  plan[SCRATCH] = 0;
  return 0;
}

}  // namespace

// The float32 kernel's launch plan for width C and K neighbours, 8 values:
// layout (0 two buffers, 1 wide), warps a block, n-tiles of a warp's column
// chunk, rows a tile (a weight read serves them at once), shared bytes a
// block, whether every centre lies whole in a tile, ring slots (wide), the
// scratch bytes a block (wide). Returns 0, or cudaErrorInvalidValue.
extern "C" int pcr_sa_f32_layout(int C, int K, long long* plan) {
  return make_plan(C, K, plan);
}

// The row tiles (two buffers of M rows), C a multiple of 32 below WIDE_FROM
// (from it the wide layout's entry below).
extern "C" int pcr_sa_convmax(const void* A, const void* Ct, const void* idx,
                              const void* w2, const void* w3, const void* s1,
                              const void* t1, const void* s2, const void* t2,
                              const void* s3, const void* t3, void* out,
                              int B, int N, int S, int K, int C, void* stream) {
  const long long R = (long long)B * S * K;
  if (C < 32 || C >= WIDE_FROM || C % 32 != 0 || K < 1 || R >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Tiles tl = tiles(C);
  const size_t smem = tl.smem(C);
  if (R == 0) return (int)cudaSuccess;
  Args p{(const float*)A, (const float*)Ct, (const int*)idx, (const float*)w2,
         (const float*)w3, (const float*)s1, (const float*)t1, (const float*)s2,
         (const float*)t2, (const float*)s3, (const float*)t3, (float*)out,
         N, S, K, C, (int)R, tl.mt, tl.groups, tl.chunks};
  const int M = tl.M();
  cudaStream_t st = (cudaStream_t)stream;
  if (M % K != 0) {     // partial centres: atomicMax into zeros
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)R / K * C * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)((R + M - 1) / M);
  if (tl.warps == 2 * WARPS) return launch<4, 2 * WARPS>(p, smem, blocks, st);
  switch (tl.nt) {
    case 1: return launch<1, WARPS>(p, smem, blocks, st);
    case 2: return launch<2, WARPS>(p, smem, blocks, st);
    default: return launch<4, WARPS>(p, smem, blocks, st);
  }
}

// The wide layout (csrc/sa_wide_wg.cuh): C a multiple of 64 up to 8192; w2,
// w3 the wrapper's stage copies (kernels/sa_stage.wide_stage_weights);
// `blocks` persistent blocks, each with `stride` bytes of `scratch` (at
// least the plan's scratch bytes).
extern "C" int pcr_sa_convmax_wide(const void* A, const void* Ct, const void* idx,
                                   const void* w2, const void* w3, const void* s1,
                                   const void* t1, const void* s2, const void* t2,
                                   const void* s3, const void* t3, void* out, void* scratch,
                                   int B, int N, int S, int K, int C, int blocks,
                                   long long stride, void* stream) {
  const long long R = (long long)B * S * K;
  if (R >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const sawide::Args<sawide::Tf32> a{
      (const float*)A, (const float*)Ct, (const int*)idx, (const unsigned char*)w2,
      (const unsigned char*)w3, (const float*)s1, (const float*)t1, (const float*)s2,
      (const float*)t2, (const float*)s3, (const float*)t3, (float*)out,
      (unsigned char*)scratch, stride, N, S, K, C, (int)R};
  return sawide::launch(a, blocks, (cudaStream_t)stream);
}
