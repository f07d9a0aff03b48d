// k nearest neighbours over C channels, in stable-argsort order (ties:
// lower index first), written as int64: tier C of kernels/knn.py.
//
// Replaces the TPU kernel point_cloud_reid_tpu/ops/pallas/knn.py:51
// (knn_pallas, _knn_kernel) at any channel count, the shape of DGCNN's
// feature-space kNN (C = 64 and 128, N = 2048, k = 20, every cloud's points
// their own queries). Per cloud b and query s it computes
//
//   d[n] = (|q|^2 - 2 q.p[n]) + |p[n]|^2          (square_distance's order)
//   out[b, s, r] = the r-th smallest (d[n], n), lexicographically, r < k
//
// The TPU kernel keeps an (S, N) distance block in VMEM and unrolls k
// arg-min passes over it; the plain version (kernels/knn.knn_reference)
// writes the (B, S, N) distances to device memory and sorts them, 8.6 GB
// of distances and 17 GB of int64 indices at 512 clouds of 2048 points.
// Here no distance leaves the SM. A block of 8 warps takes 64 queries of
// one cloud; the cloud's points stream through shared memory in tiles of
// 64 (cp.async, double-buffered), each thread a 4 x 4 register tile of
// (query, point) inner products, channel after channel as FMAs over
// float4 reads of both operands (rows padded to an odd number of 16-byte
// groups, so neither read conflicts). The tile's distances go to shared
// memory as uint32 keys that order as the floats do, and each warp merges
// its 8 queries' 64 candidates into their running top-k: a query's list,
// sorted by (key, index), sits one entry a lane (two past 32). The first
// tile's candidates are sorted into the empty lists by a bitonic network;
// after it the k-th entry is the threshold, ballots find the few
// candidates under it for all 8 queries at once, and each is inserted by a
// ballot of the lanes below it and a shift up. Since (key, index) is a
// total order, duplicated points come out lower index first, as a stable
// sort gives them. k <= 64.
//
// Norms: each point's |p|^2 is four partial sums (channel groups 4g..4g+3
// with g = r mod 4, r the thread's part) added ((s0 + s1) + (s2 + s3)), the
// same for every point and query, so equal points get equal distances.
// Widths past a two-blocks-an-SM stage stream 64 channels a stage (queries
// too); the inner products and partial sums carry across stages.
//
// bf16 inputs take knn_feature_space's roundings at bf16: the inner
// product accumulated in float32 and rounded to bf16, each square rounded
// to bf16 and their sum in float32 rounded once, then (s2 - 2 inner) and
// + d2 each rounded to bf16, as torch's bf16 square_distance does (cuBLAS
// and the reductions accumulate in float32). On inputs where every float32
// sum is exact, the indices equal the plain bf16 path's with its products
// summed in float32, as JAX sums them: that is cuBLAS with
// torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction off.
// PyTorch's default (on) lets cuBLAS reduce in bf16, which is not matched.
//
// Rounding: every sum is written with the round-to-nearest intrinsics in a
// fixed order, so the compiler contracts nothing.
//
// What bounds it on the H100: the FMAs. At (512 clouds, 2048 queries, 2048
// points, C = 64) the function needs 2 B S N C = 275 GFLOP, 4.1 ms at 67
// TFLOP/s, against 0.27 GB of input and 0.17 GB of int64 output (0.13 ms).
// A thread's 64 FMAs per four channels cost eight 16-byte shared loads;
// the selection adds about 15 instructions a query a tile and one
// insertion (about 20, a chain of dependent shuffles and ballots) for each
// candidate that beats the k-th, about k ln(N / 64) of them a query past
// the first tile on random inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;          // queries a block, points a tile
constexpr int THREADS = 256;
constexpr int KEY_STRIDE = 80;    // words a key row: rows ty, ty+1 16 banks
constexpr int MAX_K = 64;
constexpr unsigned FULL = 0xffffffffu;
typedef unsigned long long u64;

// a uint32 that orders as the float distance does (finite inputs)
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned u = __float_as_uint(__fadd_rn(d, 0.f));   // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 shfl64(u64 v, int src) {
  const unsigned lo = __shfl_sync(FULL, (unsigned)v, src);
  const unsigned hi = __shfl_sync(FULL, (unsigned)(v >> 32), src);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 shfl_up64(u64 v) {
  const unsigned lo = __shfl_up_sync(FULL, (unsigned)v, 1);
  const unsigned hi = __shfl_up_sync(FULL, (unsigned)(v >> 32), 1);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The element types: four consecutive channels as floats, a square and a
// rounding as the dtype's plain path computes them, a 4-element cp.async.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static __device__ __forceinline__ void load4(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float sq(float x) {
    return __fmul_rn(x, x);
  }
  static __device__ __forceinline__ void copy4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float* v) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float sq(float x) {
    return round(__fmul_rn(x, x));
  }
  static __device__ __forceinline__ void copy4(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src));
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
};

// elements of a staged row: the width rounded up to an odd number of
// 4-element groups (16 / 8 bytes), so rows tx and tx + 1 fall on different
// banks for the 16-byte (8-byte) reads of a quarter (half) warp
__host__ __device__ __forceinline__ int row_stride(int width) {
  return 4 * (((width + 3) / 4) | 1);
}

// Rows [row0, row0 + rows) of a (., C) matrix, channels [c0, c0 + cw), into
// dst (rows of `stride` elements), as cp.async groups of 4 channels when C
// is a multiple of 4 (VEC), else element by element with the tail of the
// last group zeroed. Issued by the whole block.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0,
                                           int rows, int C, int c0, int cw,
                                           int stride) {
  const int g = (cw + 3) / 4;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < rows * g; i += THREADS) {
      const int r = i / g, u = i - r * g;
      Elem<T>::copy4(dst + r * stride + 4 * u,
                     src + (size_t)(row0 + r) * C + c0 + 4 * u);
    }
  } else {
    const int w4 = 4 * g;
    for (int i = threadIdx.x; i < rows * w4; i += THREADS) {
      const int r = i / w4, c = i - r * w4;
      dst[r * stride + c] = c < cw ? src[(size_t)(row0 + r) * C + c0 + c]
                                   : Elem<T>::zero();
    }
  }
}

// this thread's partial sum of squares of row `row` (groups r, r + 4, ...
// of the g staged groups), added to s
template <typename T>
__device__ __forceinline__ float norm_part(const T* rowp, int r, int g,
                                           float s) {
  for (int u = r; u < g; u += 4) {
    float v[4];
    Elem<T>::load4(rowp + 4 * u, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) s = __fadd_rn(s, Elem<T>::sq(v[c]));
  }
  return s;
}

// the four parts of a row's norm (4 neighbouring lanes) as ((s0 + s1) +
// (s2 + s3)), on all four lanes, rounded as the dtype's sum is
template <typename T>
__device__ __forceinline__ float norm_total(float s) {
  s = __fadd_rn(s, __shfl_xor_sync(FULL, s, 1));
  s = __fadd_rn(s, __shfl_xor_sync(FULL, s, 2));
  return Elem<T>::round(s);
}

__device__ __forceinline__ u64 shfl_xor64(u64 v, int mask) {
  const unsigned lo = __shfl_xor_sync(FULL, (unsigned)v, mask);
  const unsigned hi = __shfl_xor_sync(FULL, (unsigned)(v >> 32), mask);
  return ((u64)hi << 32) | lo;
}

// 64 values, x0 at index lane and x1 at lane + 32, sorted ascending across
// the warp by a bitonic network (21 compare-exchange steps; the one of
// stride 32 within the lane)
__device__ __forceinline__ void bitonic64(u64& x0, u64& x1, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {
        const u64 lo = x0 < x1 ? x0 : x1, hi = x0 < x1 ? x1 : x0;
        x0 = lo;
        x1 = hi;
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        u64& x = h ? x1 : x0;
        const int i = lane + 32 * h;
        const u64 y = shfl_xor64(x, stride);
        const bool keep_min = ((i & size) == 0) == ((i & stride) == 0);
        x = keep_min ? (x < y ? x : y) : (x < y ? y : x);
      }
    }
  }
}

// a query's k smallest (key << 32 | index) so far, sorted, an entry a lane
// (entries 32..63 in e1 when TWO)
template <bool TWO>
struct TopK {
  u64 e0, e1;

  __device__ __forceinline__ void init() { e0 = e1 = ~0ull; }

  // entry j, on every lane
  __device__ __forceinline__ u64 entry(int j) const {
    return shfl64((TWO && j >= 32) ? e1 : e0, j & 31);
  }

  __device__ __forceinline__ void insert(u64 v, int lane) {
    int pos = __popc(__ballot_sync(FULL, e0 < v));
    if (TWO) pos += __popc(__ballot_sync(FULL, e1 < v));
    const u64 up0 = shfl_up64(e0);
    if (TWO) {
      u64 up1 = shfl_up64(e1);
      const u64 carry = shfl64(e0, 31);
      if (lane == 0) up1 = carry;
      e1 = lane + 32 == pos ? v : (lane + 32 > pos ? up1 : e1);
    }
    e0 = lane == pos ? v : (lane > pos ? up0 : e0);
  }
};

template <typename T, bool MULTI, bool TWO, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
knn_channels_kernel(const T* __restrict__ q, const T* __restrict__ db,
                    long long* __restrict__ out, int S, int N, int C, int k,
                    int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem);       // [64][80]
  float* pn = reinterpret_cast<float*>(keys + ROWS * KEY_STRIDE);
  float* qn = pn + ROWS;
  T* tiles = reinterpret_cast<T*>(qn + ROWS);
  const int stride = row_stride(width);
  const int tile_elems = ROWS * stride;
  // one-stage widths: the queries resident, two point buffers after them;
  // past that each stage holds its points then its queries' channels
  T* q_res = tiles;
  auto p_buf = [&](int i) {
    return MULTI ? tiles + 2 * i * tile_elems : tiles + (1 + i) * tile_elems;
  };
  auto q_buf = [&](int i) {
    return MULTI ? tiles + (2 * i + 1) * tile_elems : q_res;
  };

  const int q_blocks = (S + ROWS - 1) / ROWS;
  const int b = blockIdx.x / q_blocks;
  const int s0 = (blockIdx.x - b * q_blocks) * ROWS;
  const int q_rows = min(ROWS, S - s0);
  const T* qb = q + (size_t)b * S * C;
  const T* dbb = db + (size_t)b * N * C;
  const int chunks = MULTI ? (C + width - 1) / width : 1;
  const int tiles_n = (N + ROWS - 1) / ROWS;
  const int steps = tiles_n * chunks;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;       // the register tile's rows
  const int nrow = tid >> 2, part = tid & 3;    // a norm's row and part

  auto issue = [&](int st) {
    const int t = st / chunks, h = st - t * chunks;
    const int c0 = h * width, cw = min(width, C - c0);
    const int buf = st & 1;
    stage_rows<T, VEC>(p_buf(buf), dbb, t * ROWS, min(ROWS, N - t * ROWS), C,
                       c0, cw, stride);
    if (MULTI)
      stage_rows<T, VEC>(q_buf(buf), qb, s0, q_rows, C, c0, cw, stride);
  };

  if (!MULTI) stage_rows<T, VEC>(q_res, qb, s0, q_rows, C, 0, C, stride);
  issue(0);
  cp_async_commit();

  TopK<TWO> lists[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) lists[m].init();

  float acc[4][4];
  float pn_part = 0.f, qn_part = 0.f;
  for (int st = 0; st < steps; ++st) {
    const int t = st / chunks, h = st - t * chunks;
    const int cw = min(width, C - h * width), g = (cw + 3) / 4;
    cp_async_wait_all();
    __syncthreads();                 // stage st landed; step st - 1 is done
    if (st + 1 < steps) issue(st + 1);
    cp_async_commit();

    const T* P = p_buf(st & 1);
    const T* Q = q_buf(st & 1);
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      pn_part = 0.f;
    }
#pragma unroll 2
    for (int u = 0; u < g; ++u) {
      float qv[4][4], pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Elem<T>::load4(Q + (ty + 16 * i) * stride + 4 * u, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Elem<T>::load4(P + (tx + 16 * j) * stride + 4 * u, pv[j]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __fmaf_rn(qv[i][c], pv[j][c], acc[i][j]);
    }
    pn_part = norm_part(P + nrow * stride, part, g, pn_part);
    if (t == 0) qn_part = norm_part(Q + nrow * stride, part, g, qn_part);
    if (h + 1 < chunks) continue;

    // the tile's distances, as keys
    const float pn_row = norm_total<T>(pn_part);
    if (part == 0) pn[nrow] = pn_row;
    if (t == 0) {
      const float qn_row = norm_total<T>(qn_part);
      if (part == 0) qn[nrow] = qn_row;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qa = qn[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float inner = Elem<T>::round(acc[i][j]);
        const float d = Elem<T>::round(__fadd_rn(
            Elem<T>::round(__fsub_rn(qa, __fmul_rn(2.f, inner))),
            pn[tx + 16 * j]));
        keys[(ty + 16 * i) * KEY_STRIDE + tx + 16 * j] = order_key(d);
      }
    }
    __syncthreads();

    // each warp merges the tile into its 8 queries' lists
    const int base = t * ROWS;
    auto cand = [&](int row, int half) -> u64 {
      const int p = lane + 32 * half;
      return base + p < N
          ? ((u64)keys[row * KEY_STRIDE + p] << 32) | (unsigned)(base + p)
          : ~0ull;
    };
    if (t == 0) {
      // the empty lists take the first tile's 64 candidates, sorted
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int row = warp * 8 + m;
        if (row >= q_rows) continue;
        u64 x0 = cand(row, 0), x1 = cand(row, 1);
        bitonic64(x0, x1, lane);
        lists[m].e0 = x0;
        lists[m].e1 = x1;
      }
    } else {
      // the 8 queries' candidates under their k-th entries, all at once;
      // then each is inserted in turn
      unsigned mask[8][2];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int row = warp * 8 + m;
        const u64 thr = lists[m].entry(k - 1);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mask[m][half] = __ballot_sync(
              FULL, row < q_rows && cand(row, half) < thr);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int row = warp * 8 + m;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned bits = mask[m][half];
          if (!bits) continue;
          const u64 c = cand(row, half);
          u64 thr = lists[m].entry(k - 1);
          while (bits) {
            const int src = __ffs(bits) - 1;
            bits &= bits - 1;
            const u64 v = shfl64(c, src);
            if (v < thr) {
              lists[m].insert(v, lane);
              thr = lists[m].entry(k - 1);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int row = warp * 8 + m;
    if (row >= q_rows) continue;
    long long* o = out + ((size_t)b * S + s0 + row) * k;
    if (lane < k) o[lane] = (long long)(unsigned)lists[m].e0;
    if (TWO && lane + 32 < k) o[lane + 32] = (long long)(unsigned)lists[m].e1;
  }
}

// dynamic shared bytes of a launch: the keys, the two norm rows, and the
// staged rows (three tiles at one stage, four past it)
size_t channels_smem(int C, int width, size_t esize) {
  const int tiles = width < C ? 4 : 3;
  return (size_t)ROWS * KEY_STRIDE * 4 + 2 * ROWS * 4
         + (size_t)tiles * ROWS * row_stride(width) * esize;
}

template <typename T, bool MULTI, bool TWO, bool VEC>
cudaError_t launch_channels(const void* q, const void* db, void* out, int B,
                            int S, int N, int C, int k, int width,
                            size_t smem, cudaStream_t stream) {
  auto kern = knn_channels_kernel<T, MULTI, TWO, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)((S + ROWS - 1) / ROWS) * B;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)db, (long long*)out, S, N, C, k, width);
  return cudaGetLastError();
}

template <typename T, bool MULTI, bool TWO>
cudaError_t launch_aligned(bool vec, const void* q, const void* db, void* out,
                           int B, int S, int N, int C, int k, int width,
                           size_t smem, cudaStream_t stream) {
  return vec ? launch_channels<T, MULTI, TWO, true>(q, db, out, B, S, N, C, k,
                                                    width, smem, stream)
             : launch_channels<T, MULTI, TWO, false>(q, db, out, B, S, N, C,
                                                     k, width, smem, stream);
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* db, void* out, int B,
                         int S, int N, int C, int k, int width, size_t smem,
                         cudaStream_t stream) {
  const size_t align = 4 * sizeof(T);
  const bool vec = C % 4 == 0 && (size_t)q % align == 0
                   && (size_t)db % align == 0;
  const bool multi = width < C, two = k > 32;
  if (multi)
    return two ? launch_aligned<T, true, true>(vec, q, db, out, B, S, N, C, k,
                                               width, smem, stream)
               : launch_aligned<T, true, false>(vec, q, db, out, B, S, N, C,
                                                k, width, smem, stream);
  return two ? launch_aligned<T, false, true>(vec, q, db, out, B, S, N, C, k,
                                              width, smem, stream)
             : launch_aligned<T, false, false>(vec, q, db, out, B, S, N, C, k,
                                               width, smem, stream);
}

}  // namespace

constexpr size_t MAX_SMEM = 232448;

// q (B, S, C), db (B, N, C) contiguous, float32 or (bf16 != 0) bf16 ->
// out (B, S, k) int64 contiguous. `width` is the channels a stage: C (one
// stage, the queries resident), or a multiple of 16 below C; `smem` the
// dynamic shared bytes kernels/knn.plan computed, checked against this
// file's count. A shape or plan it does not take is refused with
// cudaErrorInvalidValue.
extern "C" int pcr_knn_channels(const void* q, const void* db, void* out,
                                int B, int S, int N, int C, int k, int width,
                                int smem, int bf16, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || k <= 0 || k > N || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (width <= 0 || width > C || (width < C && width % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t esize = bf16 ? 2 : 4;
  const size_t bytes = channels_smem(C, width, esize);
  if ((size_t)smem != bytes || bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_typed<__nv_bfloat16>(q, db, out, B, S, N, C, k, width,
                                            bytes, st);
  return (int)launch_typed<float>(q, db, out, B, S, N, C, k, width, bytes, st);
}
