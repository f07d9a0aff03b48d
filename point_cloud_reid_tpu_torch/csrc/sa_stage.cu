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
//   C = 1024:      16 warps, NT 4, M 16, 132 KB; each warp takes two column
//                  chunks in turn;
//   C = 1,056 ... 1,792: the same at M 16, up to 230 KB.
// Past 1,792 channels two buffers of one 16-row m-tile no longer fit (at
// C = 2048: 2 x 16 x 2,052 x 4 = 262,656 bytes against 232,448), and the
// h1-from-gather layout takes the stage (sa_convmax_gather_kernel, any
// multiple of 32 up to 2048): 16 warps, NT 4, M 16; conv2 forms its A
// fragments straight from the gather (BN1 + ReLU of A[idx] + Ct is
// elementwise: each lane reads its rows g, g + 8 at columns 8 kk + t, + 4
// through L1 / L2, every warp the whole 16 rows) into the h2 buffer, 16 x
// (C + 4) floats; conv3's 16 x 32 columns of a job go into the warp's strip
// (16 warps x 16 x 32 floats, 32 KB), from which each lane takes its
// column's max over each centre's rows. 131,328 + 32,768 = 164,096 bytes
// at C = 2048. The gather is read once a warp instead of once a block:
// 16 x the A / Ct bytes of the block's rows, from L1 / L2. Measured on the
// H100 (PERF.md section 6): the mul16 model's SA3 at B = 128 takes
// 5.6x its bound, slower than the plain version: every 16-row block reads
// both weights, 32 MB at C = 2048, from L2.
// Weight reads per call at B = 128: 1.07 / 4.3 / 8.6 GB for SA1/2/3, from
// L2 (the SIMT kernel before this one read 4.3 / 12.9 / 25.8 GB). Larger
// tiles with one 8-warp block a SM (M = 128 / 96 / 48, up to 236
// registers) read half as much and were 1.4x / 1.1x slower at SA1 / SA2:
// with one block a SM nothing overlaps its gather and its barriers.
// Any C that is a multiple of 32, 32 to 2048, is taken (kernels/sa_stage
// pads any other width, up to 2048, to the next one): NT is 1, 2 or 4,
// the largest that still gives every warp a chunk of columns (C = 32: two
// row groups of 4 warps, each reading the weights); where the chunks do not
// divide among the warps, some warps take one more.
// The max: every h3 is a ReLU output >= 0, so 0 is the identity and the
// float order is the order of the bits as integers. Where M is a multiple
// of K every centre lies whole in one block and its max is stored plainly;
// otherwise (C >= 1024 at K = 48, or K = 12 at M = 128) a block's edge
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

#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 8;      // warps a block; 16 where there are 16 column chunks
constexpr int PF = 4;         // k-steps a warp's B fragments are loaded ahead
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may take
constexpr int MAX_C = 2048;             // widest stage (kernels/sa_stage.MAX_C)

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

// conv2's A fragments formed straight from the gather (the h1-from-gather
// layout: one m-tile of 16 rows a block): h1 = relu((A[src] + Ct[ctr]) s1
// + t1) at rows g and g + 8 (src < 0: a row past R, h1 = 0), columns
// 8 kk + t and 8 kk + t + 4.
struct GatherA {
  const float* A;
  const float* Ct;
  const float* s1;
  const float* t1;
  long long src[2], ctr[2];
  __device__ __forceinline__ const GatherA& at(int) const { return *this; }
  __device__ __forceinline__ float h1(int r, int c, float s, float h) const {
    return src[r] < 0 ? 0.f : fmaxf((__ldg(A + src[r] + c) + __ldg(Ct + ctr[r] + c)) * s + h, 0.f);
  }
  __device__ __forceinline__ void frag(int, int kk, float (&av)[4]) const {
    const int c0 = 8 * kk + (threadIdx.x & 3), c1 = c0 + 4;
    const float sa = __ldg(s1 + c0), ha = __ldg(t1 + c0), sb = __ldg(s1 + c1), hb = __ldg(t1 + c1);
    av[0] = h1(0, c0, sa, ha);
    av[1] = h1(1, c0, sa, ha);
    av[2] = h1(0, c1, sb, hb);
    av[3] = h1(1, c1, sb, hb);
  }
};

// A product's output into a row buffer (rows padded to C + 4).
struct BufOut {
  float* dst;
  int LD;
  __device__ __forceinline__ void put(int row, int col, float2 v) const {
    *reinterpret_cast<float2*>(dst + row * LD + col) = v;
  }
  __device__ __forceinline__ void done(int) const {}
};

constexpr int STRIP = 32;   // columns of a warp's conv3 strip (NT = 4)

// conv3's output of the h1-from-gather layout: a job's 16 x 32 columns into
// the warp's strip, then each lane's column's max over the rows of each
// centre in the block: stored where the centre lies whole in the block,
// else an atomicMax on the bits into the zero-filled `out` (values >= 0).
struct MaxOut {
  float* strip;
  float* out;
  int r0, rows, K, C;
  __device__ __forceinline__ void put(int row, int col, float2 v) const {
    *reinterpret_cast<float2*>(strip + row * STRIP + (col & (STRIP - 1))) = v;
  }
  __device__ __forceinline__ void emit(int centre, int c, float m) const {
    float* o = out + (size_t)centre * C + c;
    if (centre * K >= r0 && (centre + 1) * K <= r0 + rows)
      *o = m;
    else
      atomicMax(reinterpret_cast<int*>(o), __float_as_int(m));
  }
  __device__ __forceinline__ void done(int col0) const {
    __syncwarp();
    const int lane = threadIdx.x & 31, c = col0 + lane;
    int centre = r0 / K;
    float m = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int ce = (r0 + r) / K;
      if (ce != centre) {
        emit(centre, c, m);
        centre = ce;
        m = 0.f;
      }
      m = fmaxf(m, strip[r * STRIP + lane]);
    }
    emit(centre, c, m);
    __syncwarp();
  }
};

// out(r, c) = relu((A @ w)[r][c] * sc[c] + sh[c]) for the block's rows, a
// warp per (row group, column chunk) job: the A fragments from `asrc` (a
// row buffer, or the gather), the results to `out` (a row buffer, or the
// strip and the max).
template <int NT, int MT, int W, class ASrc, class Out>
__device__ __forceinline__ void conv_layer(const ASrc& asrc, const Out& out,
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
    out.done(col0);
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

// The h1-from-gather layout (C past 1,792, where two buffers of one m-tile
// do not fit): a block of W warps owns 16 rows; conv2's A fragments come
// straight from the gather into the h2 buffer, conv3's columns go through
// each warp's strip into the max.
template <int NT, int W>
__global__ void __launch_bounds__(32 * W, 16 / W) sa_convmax_gather_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, LD = C + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * 16;
  const int rows = min(16, p.R - r0);
  GatherA ga{p.A, p.Ct, p.s1, p.t1, {-1, -1}, {0, 0}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + (lane >> 2) + 8 * h;
    if (row < p.R) {
      const int centre = row / p.K;
      ga.src[h] = ((long long)(centre / p.S) * p.N + __ldg(p.idx + row)) * C;
      ga.ctr[h] = (long long)centre * C;
    }
  }
  conv_layer<NT, 1, W>(ga, BufOut{smem, LD}, p.w2, p.s2, p.t2, p);
  __syncthreads();
  conv_layer<NT, 1, W>(SmemA{smem, LD},
                       MaxOut{smem + 16 * LD + warp * 16 * STRIP, p.out, r0, rows, p.K, C},
                       p.w3, p.s3, p.t3, p);
}

template <int NT, int W>
int launch_gather(const Args& p, size_t smem, int blocks, cudaStream_t stream) {
  static_assert(NT * 8 == STRIP, "a warp's strip is one column chunk");
  cudaError_t err = cudaFuncSetAttribute(
      sa_convmax_gather_kernel<NT, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_convmax_gather_kernel<NT, W><<<blocks, 32 * W, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcr_sa_convmax(const void* A, const void* Ct, const void* idx,
                              const void* w2, const void* w3, const void* s1,
                              const void* t1, const void* s2, const void* t2,
                              const void* s3, const void* t3, void* out,
                              int B, int N, int S, int K, int C, void* stream) {
  const long long R = (long long)B * S * K;
  if (C < 32 || C > MAX_C || C % 32 != 0 || K < 1 || R >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  // NT: the largest of 1, 2, 4 that leaves at least 8 column chunks
  const int ntiles = C / 8;
  int nt = 1;
  for (int d = 2; d <= 4; d *= 2)
    if (ntiles % d == 0 && ntiles / d >= WARPS) nt = d;
  Args p{(const float*)A, (const float*)Ct, (const int*)idx, (const float*)w2,
         (const float*)w3, (const float*)s1, (const float*)t1, (const float*)s2,
         (const float*)t2, (const float*)s3, (const float*)t3, (float*)out,
         N, S, K, C, (int)R, 0, 0, 0};
  p.chunks = ntiles / nt;
  const int warps = p.chunks >= 2 * WARPS ? 2 * WARPS : WARPS;
  p.groups = p.chunks < warps ? warps / p.chunks : 1;
  p.mt = max_mt(nt);
  while (p.mt > 1 && (size_t)2 * p.groups * p.mt * 16 * (C + 4) * sizeof(float) > SMEM_LIMIT)
    --p.mt;
  // two buffers of even one m-tile too large (C > 1,792): the h1-from-gather layout
  const bool gather = (size_t)2 * 16 * (C + 4) * sizeof(float) > SMEM_LIMIT;
  const int M = p.groups * p.mt * 16;
  const size_t smem = gather ? (size_t)16 * (C + 4) * sizeof(float) + (size_t)warps * 16 * STRIP * sizeof(float)
                             : (size_t)2 * M * (C + 4) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (M % K != 0) {     // partial centres: atomicMax into zeros
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)R / K * C * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)((R + M - 1) / M);
  if (gather) return launch_gather<4, 2 * WARPS>(p, smem, blocks, st);
  if (warps == 2 * WARPS) return launch<4, 2 * WARPS>(p, smem, blocks, st);
  switch (nt) {
    case 1: return launch<1, WARPS>(p, smem, blocks, st);
    case 2: return launch<2, WARPS>(p, smem, blocks, st);
    default: return launch<4, WARPS>(p, smem, blocks, st);
  }
}
