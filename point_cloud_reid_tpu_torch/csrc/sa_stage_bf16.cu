// Eval-mode SA stage of the point backbone at bf16: gather + edge MLP + max
// over K, on Hopper's bf16 tensor cores.
//
// Replaces the bf16 instance of the TPU kernel
// point_cloud_reid_tpu/ops/pallas/sa_stage.py (fused_sa_convmax under a
// bf16 model): A, Ct and the output in bf16; w2, w3 and the affines arrive
// float32 and the kernel's dot casts both operands of each product to bf16
// and accumulates in float32. Per crop b and centre s
//
//   h1[k] = relu((A[b, idx[b,s,k]] + Ct[b,s]) * s1 + t1)       float32
//   h2[k] = relu((bf16(h1[k]) @ bf16(w2)) * s2 + t2)           float32 acc.
//   h3[k] = relu((bf16(h2[k]) @ bf16(w3)) * s3 + t3)
//   out[b,s] = bf16(max_k h3[k])
//
// The wrapper hands the weights over once converted, bf16 in (out, in)
// layout (kernels/sa_stage.py caches them per weight tensor).
//
// Design: the float32 kernel's (csrc/sa_stage.cu) row tiles, with one
// mma.sync m16n8k16 bf16 pass per product in place of three TF32 passes.
// A block of W warps owns M consecutive rows (b, s, k) of the R = B S K
// rows. It
//  1. gathers its rows of A, adds Ct, applies BN1 + ReLU in float32 and
//     stores them rounded to bf16 (the product's operand, where JAX rounds)
//     into buffer 1 (M x (C + 8) bf16: the padding keeps the ldmatrix loads
//     free of bank conflicts); barrier;
//  2. conv2: each warp computes its columns of h1 @ w2 for all M rows in
//     registers (A fragments by ldmatrix from buffer 1, B fragments straight
//     from device memory, PF k-steps ahead: L2 hits, w2 is shared by every
//     block), then the affine + ReLU, rounded to bf16 into buffer 2;
//  3. conv3 the same from buffer 2 into buffer 1;
//  4. the max over each centre's rows of buffer 1. Rounding is monotone, so
//     the max of the rounded h3 is the rounded max. Where M is a multiple of
//     K every centre lies in one block; otherwise a block's edge centres go
//     out by a compare-and-swap max on the bf16 bits into a zero-filled
//     `out` (every value is >= 0, and -0 reads as the least).
// M per C as in the float32 kernel (4 MT NT accumulators a thread, two 8-warp
// blocks or one 16-warp block a SM); the buffers take half its bytes.
//
// What bounds it on the H100: 4 R C^2 operations in one bf16 pass at
// 989 TFLOP/s (0.035 / 0.104 / 0.208 ms for SA1/2/3 at B = 128), against
// ~18 MB of bytes (0.005 ms). A simple kernel: wgmma with the weights in
// shared memory is the way past mma.sync's issue rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;      // warps a block; 16 where there are 16 column chunks
constexpr int PF = 2;         // k-steps a warp's B fragments are loaded ahead
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may take

struct Args {
  const bf16* A;      // (B, N, C)
  const bf16* Ct;     // (B, S, C)
  const int* idx;     // (B, S, K): row r of the list is idx[r]
  const bf16* w2;     // (C, C) (out, in)
  const bf16* w3;
  const float* s1; const float* t1; const float* s2; const float* t2;
  const float* s3; const float* t3;
  bf16* out;          // (B, S, C)
  int N, S, K, C, R;  // R = B S K rows
  int mt, groups, chunks;   // m-tiles per row group, row groups, column chunks
};

constexpr int max_mt(int nt) { return nt == 1 ? 8 : nt == 2 ? 4 : 3; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dst[r][c] = bf16(relu((src @ w)[r][c] * sc[c] + sh[c])) for the block's
// rows, a warp per (row group, column chunk) job; src and dst are bf16 rows
// padded to C + 8.
template <int NT, int MT, int W>
__device__ __forceinline__ void conv_layer(const bf16* src, bf16* dst,
                                           const bf16* __restrict__ w,
                                           const float* __restrict__ sc,
                                           const float* __restrict__ sh,
                                           const Args& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = p.C, LD = C + 8, ksteps = C / 16, mt = p.mt;
  for (int job = warp; job < p.groups * p.chunks; job += W) {
    const int row0 = (job / p.chunks) * mt * 16;
    const int col0 = (job % p.chunks) * NT * 8;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    // B fragment of k-step kk, n-tile j: the bf16 pairs w[n][16 kk + 2t, +1]
    // and w[n][16 kk + 2t + 8, +9] with n = col0 + 8 j + g (w is (out, in))
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(w + (size_t)(col0 + g) * C) + t;
    uint32_t bn[PF][NT][2];
#pragma unroll
    for (int q = 0; q < PF; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bn[q][j][0] = __ldg(wp + (size_t)j * 4 * C + q * 8);
        bn[q][j][1] = __ldg(wp + (size_t)j * 4 * C + q * 8 + 4);
      }
    // ldmatrix .x4: lanes 0-15 give rows 0-15 at column 16 kk, lanes 16-31
    // the same rows at 16 kk + 8: the four 8 x 8 blocks a0 (rows 0-7, cols
    // 0-7), a1 (8-15, 0-7), a2 (0-7, 8-15), a3 (8-15, 8-15)
    const uint32_t abase = (uint32_t)__cvta_generic_to_shared(
        src + (row0 + (lane & 15)) * LD + (lane >> 4) * 8);
    for (int k0 = 0; k0 < ksteps; k0 += PF) {
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        const int kk = k0 + q;
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) { b[j][0] = bn[q][j][0]; b[j][1] = bn[q][j][1]; }
        if (kk + PF < ksteps) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bn[q][j][0] = __ldg(wp + (size_t)j * 4 * C + (kk + PF) * 8);
            bn[q][j][1] = __ldg(wp + (size_t)j * 4 * C + (kk + PF) * 8 + 4);
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < mt) {
            uint32_t a[4];
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                         : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                         : "r"(abase + (uint32_t)(i * 16 * LD + kk * 16) * 2u));
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
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
          bf16* d = dst + (row0 + 16 * i + g) * LD + col;
          *reinterpret_cast<uint32_t*>(d) = pack_bf16(
              fmaxf(acc[i][j][0] * s.x + h.x, 0.f), fmaxf(acc[i][j][1] * s.y + h.y, 0.f));
          *reinterpret_cast<uint32_t*>(d + 8 * LD) = pack_bf16(
              fmaxf(acc[i][j][2] * s.x + h.x, 0.f), fmaxf(acc[i][j][3] * s.y + h.y, 0.f));
        }
      }
    }
  }
}

// max into a bf16 of `out` shared with other blocks: a compare-and-swap on
// its 32-bit word. The values are >= 0, whose bits order as signed shorts
// (-0, 0x8000, the least).
__device__ __forceinline__ void atomic_max_bf16(bf16* addr, bf16 value) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(addr);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~(uintptr_t)3);
  const int shift = (a & 2) ? 16 : 0;
  const unsigned short v = __bfloat16_as_ushort(value);
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    if ((short)((assumed >> shift) & 0xffffu) >= (short)v) return;
    old = atomicCAS(word, assumed,
                    (assumed & ~(0xffffu << shift)) | ((unsigned int)v << shift));
  } while (old != assumed);
}

template <int NT, int MT, int W>
__global__ void __launch_bounds__(32 * W, 16 / W) sa_convmax_bf16_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int C = p.C, LD = C + 8, M = p.groups * p.mt * 16;
  bf16* buf1 = smem;
  bf16* buf2 = smem + M * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * M;
  const int rows = min(M, p.R - r0);

  // 1. gather + centre term + BN1 + relu -> buf1 (bf16); padded rows are 0.
  // Lane j of a warp holds the source offsets of row warp + W j.
  const float4* s1 = reinterpret_cast<const float4*>(p.s1);
  const float4* t1 = reinterpret_cast<const float4*>(p.t1);
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
    uint2* dst = reinterpret_cast<uint2*>(buf1 + (warp + W * j) * LD);
    const uint2* a = reinterpret_cast<const uint2*>(p.A + sj);
    const uint2* ct = reinterpret_cast<const uint2*>(p.Ct + cj);
    for (int c = lane; c < C / 4; c += 32) {
      uint2 v = make_uint2(0u, 0u);
      if (sj >= 0) {
        const uint2 xa = __ldg(a + c), xc = __ldg(ct + c);
        const float4 s = __ldg(s1 + c), h = __ldg(t1 + c);
        const float2 a01 = unpack_bf16(xa.x), a23 = unpack_bf16(xa.y);
        const float2 c01 = unpack_bf16(xc.x), c23 = unpack_bf16(xc.y);
        v.x = pack_bf16(fmaxf((a01.x + c01.x) * s.x + h.x, 0.f),
                        fmaxf((a01.y + c01.y) * s.y + h.y, 0.f));
        v.y = pack_bf16(fmaxf((a23.x + c23.x) * s.z + h.z, 0.f),
                        fmaxf((a23.y + c23.y) * s.w + h.w, 0.f));
      }
      dst[c] = v;
    }
  }
  __syncthreads();
  // 2, 3. the two convs, each warp its own columns
  conv_layer<NT, MT, W>(buf1, buf2, p.w2, p.s2, p.t2, p);
  __syncthreads();
  conv_layer<NT, MT, W>(buf2, buf1, p.w3, p.s3, p.t3, p);
  __syncthreads();

  // 4. max over each centre's rows in this block
  const int first = r0 / p.K, centres = (r0 + rows - 1) / p.K - first + 1;
  for (int e = threadIdx.x; e < centres * C; e += 32 * W) {
    const int centre = first + e / C, c = e % C;
    const int lo = max(centre * p.K, r0), hi = min((centre + 1) * p.K, r0 + rows);
    float m = 0.f;
    for (int r = lo - r0; r < hi - r0; ++r) m = fmaxf(m, __bfloat162float(buf1[r * LD + c]));
    bf16* o = p.out + (size_t)centre * C + c;
    if (lo == centre * p.K && hi == (centre + 1) * p.K)
      *o = __float2bfloat16_rn(m);
    else
      atomic_max_bf16(o, __float2bfloat16_rn(m));
  }
}

template <int NT, int W>
int launch(const Args& p, size_t smem, int blocks, cudaStream_t stream) {
  constexpr int MT = max_mt(NT);
  cudaError_t err = cudaFuncSetAttribute(
      sa_convmax_bf16_kernel<NT, MT, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_convmax_bf16_kernel<NT, MT, W><<<blocks, 32 * W, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// A, Ct, out bf16; w2, w3 bf16 (C, C) in (out, in) layout; the affines
// float32. The same shapes as pcr_sa_convmax: C a multiple of 32, 32 to 1024.
extern "C" int pcr_sa_convmax_bf16(const void* A, const void* Ct, const void* idx,
                                   const void* w2, const void* w3, const void* s1,
                                   const void* t1, const void* s2, const void* t2,
                                   const void* s3, const void* t3, void* out,
                                   int B, int N, int S, int K, int C, void* stream) {
  const long long R = (long long)B * S * K;
  if (C < 32 || C > 1024 || C % 32 != 0 || K < 1 || R >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const int ntiles = C / 8;
  int nt = 1;
  for (int d = 2; d <= 4; d *= 2)
    if (ntiles % d == 0 && ntiles / d >= WARPS) nt = d;
  Args p{(const bf16*)A, (const bf16*)Ct, (const int*)idx, (const bf16*)w2,
         (const bf16*)w3, (const float*)s1, (const float*)t1, (const float*)s2,
         (const float*)t2, (const float*)s3, (const float*)t3, (bf16*)out,
         N, S, K, C, (int)R, 0, 0, 0};
  p.chunks = ntiles / nt;
  const int warps = p.chunks >= 2 * WARPS ? 2 * WARPS : WARPS;
  p.groups = p.chunks < warps ? warps / p.chunks : 1;
  p.mt = max_mt(nt);
  while (p.mt > 1 && (size_t)2 * p.groups * p.mt * 16 * (C + 8) * sizeof(bf16) > SMEM_LIMIT)
    --p.mt;
  const int M = p.groups * p.mt * 16;
  const size_t smem = (size_t)2 * M * (C + 8) * sizeof(bf16);
  cudaStream_t st = (cudaStream_t)stream;
  if (M % K != 0) {     // partial centres: a max into zeros
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)R / K * C * sizeof(bf16), st);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)((R + M - 1) / M);
  if (warps == 2 * WARPS) return launch<4, 2 * WARPS>(p, smem, blocks, st);
  switch (nt) {
    case 1: return launch<1, WARPS>(p, smem, blocks, st);
    case 2: return launch<2, WARPS>(p, smem, blocks, st);
    default: return launch<4, WARPS>(p, smem, blocks, st);
  }
}
