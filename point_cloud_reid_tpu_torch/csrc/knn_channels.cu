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
// arg-min passes over it (its inner products on the matrix unit); the plain
// version (kernels/knn.knn_reference) writes the (B, S, N) distances to
// device memory and sorts them. Here no distance leaves the SM. A block of
// 8 warps takes 64 queries of one cloud; the cloud's points stream through
// shared memory in tiles of 64 (cp.async, two buffers); each tile's 64 x 64
// distances go to shared memory as uint32 keys that order as the floats
// do, and each warp folds its 8 queries' 64 candidates into their top-k.
//
// What bounds it on the H100 (PERF.md section 6, row 6 C). The first
// version (FFMA products, each candidate under the k-th inserted by its
// own dependent chain of ballots and shuffles) took 18.90 ms at (512
// clouds, S = N = 2048, C = 64, k = 20), ~11.4 of them in the selection
// whatever C was; this one takes 18.08 at float32 and 13.80 at bf16 (21.14
// before), no less at float32 C = 128, and ~5 % more at float32 k <= 8
// (tools/ab_train_kernels.py --knn, in turns). What bounds it now is the
// selection's latency: a merge is ~21 dependent shuffle steps, each warp
// folds its 8 queries every tile, and the block's warps meet at three
// barriers a tile, so a warp's merges hold its block; products and
// selection overlap only across the two blocks of an SM. The products'
// floor is 275 GFLOP: 4.1 ms on FFMA, 0.28 ms at one bf16 pass. What each
// part of the design does:
//
// 1. Selection in batches. A query's list, sorted by (key << 32 | index),
//    sits one entry a lane (two past k = 32), its k-th key copied into a
//    register. The first tile's 64 candidates are sorted into the empty
//    lists by one bitonic network for the warp's 8 queries at once. Later,
//    a candidate costs one compare against the register copy: the warp
//    first loads and votes for all 8 queries (two ballots each), then
//    appends each query's candidates under its k-th key to its pending
//    buffer in shared memory (PENDING entries) at the ballots' prefix
//    counts. Before a tile's candidates would overflow a buffer, it is
//    sorted (32 a warp) and merged into the list (the list against the
//    batch reversed, min, a bitonic merge: the smallest k of both, sorted),
//    which renews the k-th key; a tile of more than PENDING (early tiles at
//    k past 32) is sorted (64 a warp) and merged straight in. The merges
//    run out of line (merge_batch): inlined for each of 8 queries the
//    kernel's code outgrew the instruction cache (bf16 20.1 against 13.5
//    ms). Merging by ranks instead (each entry's place counted from shared
//    memory, no chain of shuffles) measured slower (bf16 16.1 against
//    13.9 ms). A candidate equal to the k-th key has a larger index than every
//    listed entry (tiles ascend), so a strict key compare is exact; (key,
//    index) is a total order, so duplicated points come out lower index
//    first, as a stable sort gives them, and a merge needs no stable sort.
// 2. bf16 products on the tensor cores: mma.sync m16n8k16 bf16 -> float32,
//    a warp 16 queries x 32 points. Products of bf16 are exact; the sums
//    are float32. Then the bf16 roundings of the inner product, of the
//    squares and of the two adds, as knn_feature_space's bf16 path takes
//    them (below).
// 3. float32 products stay on FFMA, in the first version's order, so the
//    float32 indices equal the first version's on every input. Three TF32
//    passes as a filter (a candidate passing when its approximate distance
//    less a proven error bound lies under the k-th key, then scored again
//    in FFMA order) measured slower, 21.73 against 17.96 ms: its scan and
//    re-scores, an extra pass a tile on the selection's side, cost more
//    than the products save (PERF.md section 6 keeps its bound and times).
// 4. Products and selection overlap across blocks: the layout keeps two
//    blocks (16 warps) an SM. Warps specialised within a block (producer
//    warps appending candidates with shared atomics, selector warps
//    merging, named barriers between) were built and measured slower: one
//    block an SM of 8 + 8 warps left the products too few warps (bf16
//    23.2 ms), 16 + 16 warps at 64 registers 15.9 ms.
//
// Registers and shared bytes (ptxas, sm_90a; chip_smoke.py phase 19 prints
// them): __launch_bounds__(256, 2), at most 128 registers a thread. Shared
// bytes a block: the keys (64 x 72 words, 18,432), two norm rows (512),
// the pending buffers and their counts (64 x (32 x 8 + 4), 16,640), then
// the staged rows: 87,808 at C = 64 float32 and at C = 128 bf16, 105,216
// at C = 128 float32 (64-channel stages).
//
// Norms: each point's |p|^2 is four partial sums (channel groups 4g..4g+3
// with g = r mod 4, r the thread's part) added ((s0 + s1) + (s2 + s3)), the
// same for every point and query, so equal points get equal distances.
// Widths past a two-blocks-an-SM stage stream 64 channels a stage (queries
// too); the inner products and partial sums carry across stages. Staged
// rows are zero-padded to the k-step (8 float32, 16 bf16) and are an odd
// number of 16-byte groups long (bf16: of 16-byte pairs), so neither the
// fragment reads nor the FFMA tiles' float4 reads conflict.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int ROWS = 64;          // queries a block, points a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QUERIES = ROWS / WARPS;   // a warp's queries in the selection
constexpr int KEY_STRIDE = 72;    // words a key row: fragment stores 2-way free
constexpr int MAX_K = 64;
constexpr int PENDING = 32;       // a query's pending candidates
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

__device__ __forceinline__ u64 shfl_xor64(u64 v, int mask) {
  const unsigned lo = __shfl_xor_sync(FULL, (unsigned)v, mask);
  const unsigned hi = __shfl_xor_sync(FULL, (unsigned)(v >> 32), mask);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 min64(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 max64(u64 a, u64 b) { return a < b ? b : a; }

// one compare-exchange of a bitonic network with the lane `stride` away
__device__ __forceinline__ u64 exchange(u64 x, int stride, bool keep_min) {
  const u64 y = shfl_xor64(x, stride);
  return keep_min ? min64(x, y) : max64(x, y);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The element types: four consecutive channels as floats, a square and a
// rounding as the dtype's plain path computes them, a 4-element cp.async,
// the k-step of the products on the tensor cores.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int KSTEP = 8;
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
  static constexpr int KSTEP = 16;
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

// elements of a staged row: the width padded to the k-step (8 float32, 16
// bf16), then to an odd number of 16-byte groups (bf16: of 16-byte pairs),
// so 8 rows at the same column fall on 8 different 4-bank groups
__host__ __device__ __forceinline__ int row_stride(int width, int esize) {
  if (esize == 4) return 4 * ((((width + 7) / 8 * 8) / 4) | 1);
  return 8 * ((((width + 15) / 16 * 16) / 8) | 1);
}

// Rows [row0, row0 + rows) of a (., C) matrix, channels [c0, c0 + cw), into
// dst (rows of `stride` elements), as cp.async groups of 4 channels when C
// is a multiple of 4 (VEC), else element by element; columns past cw are
// zeroed to the k-step. Issued by the whole block.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0,
                                           int rows, int C, int c0, int cw,
                                           int stride) {
  constexpr int KS = Elem<T>::KSTEP;
  const int g = (cw + 3) / 4, kw = (cw + KS - 1) / KS * KS;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < rows * g; i += THREADS) {
      const int r = i / g, u = i - r * g;
      Elem<T>::copy4(dst + r * stride + 4 * u,
                     src + (size_t)(row0 + r) * C + c0 + 4 * u);
    }
    const int z = kw - 4 * g;
    if (z > 0)
      for (int i = threadIdx.x; i < rows * z; i += THREADS) {
        const int r = i / z;
        dst[r * stride + 4 * g + i - r * z] = Elem<T>::zero();
      }
  } else {
    for (int i = threadIdx.x; i < rows * kw; i += THREADS) {
      const int r = i / kw, c = i - r * kw;
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

// ---- the selection networks ------------------------------------------------

// 64 values, x0 at index lane and x1 at lane + 32, sorted ascending across
// the warp by a bitonic network (21 compare-exchange steps; the one of
// stride 32 within the lane)
__device__ __forceinline__ void sort64(u64& x0, u64& x1, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {
        const u64 lo = min64(x0, x1), hi = max64(x0, x1);
        x0 = lo;
        x1 = hi;
        continue;
      }
      const bool low = (lane & stride) == 0;
      x0 = exchange(x0, stride, ((lane & size) == 0) == low);
      x1 = exchange(x1, stride, (((lane + 32) & size) == 0) == low);
    }
  }
}

// the same network over a warp's QUERIES queries at once, step by step, so
// their 2 QUERIES chains of shuffles overlap (the first tile, where every
// query sorts its 64 candidates)
__device__ __forceinline__ void sort64_all(u64 (&x0)[QUERIES],
                                           u64 (&x1)[QUERIES], int lane) {
#pragma unroll 1
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool low = (lane & stride) == 0;
      const bool keep0 = ((lane & size) == 0) == low;
      const bool keep1 = (((lane + 32) & size) == 0) == low;
#pragma unroll
      for (int m = 0; m < QUERIES; ++m) {
        if (stride == 32) {
          const u64 lo = min64(x0[m], x1[m]), hi = max64(x0[m], x1[m]);
          x0[m] = lo;
          x1[m] = hi;
        } else {
          x0[m] = exchange(x0[m], stride, keep0);
          x1[m] = exchange(x1[m], stride, keep1);
        }
      }
    }
  }
}

// 32 values, one a lane, sorted ascending (15 steps)
__device__ __forceinline__ u64 sort32(u64 x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      x = exchange(x, stride, ((lane & size) == 0) == ((lane & stride) == 0));
  return x;
}

struct Entries {
  u64 e0, e1;
};

// A sorted list (e0 at index lane, e1 at lane + 32) merged with a batch
// (x0, x1 likewise, ~0 past it), sorted here (64 values when `wide`, else
// the 32 in x0): the list against the batch reversed, the smaller of each
// pair (a bitonic sequence holding the smallest 32 / 64 of both), then a
// bitonic merge. Out of line: a warp calls it for each of its 8 queries,
// and inlined 8 times the networks made the kernel's code too large for
// the instruction cache (PERF.md section 6).
template <bool TWO>
__device__ __noinline__ Entries merge_batch(Entries L, u64 x0, u64 x1,
                                            bool wide) {
  const int lane = threadIdx.x & 31, src = 31 - lane;
  if (wide)
    sort64(x0, x1, lane);
  else
    x0 = sort32(x0, lane);
  if (TWO) {
    L.e0 = min64(L.e0, shfl64(x1, src));
    L.e1 = min64(L.e1, shfl64(x0, src));
    const u64 lo = min64(L.e0, L.e1), hi = max64(L.e0, L.e1);
    L.e0 = lo;
    L.e1 = hi;
  } else {
    L.e0 = min64(L.e0, shfl64(x0, src));
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    L.e0 = exchange(L.e0, stride, (lane & stride) == 0);
    if (TWO) L.e1 = exchange(L.e1, stride, (lane & stride) == 0);
  }
  return L;
}

// a query's k smallest (key << 32 | index) so far, sorted, an entry a lane
// (entries 32..63 in e1 when TWO); thr, the k-th entry's key on every lane.
// Its pending buffer and that buffer's count lie in shared memory.
template <bool TWO>
struct TopK {
  Entries L;
  unsigned thr;

  __device__ __forceinline__ void set_thr(int k) {
    thr = __shfl_sync(FULL, (unsigned)((TWO ? L.e1 : L.e0) >> 32),
                      (k - 1) & 31);
  }

  // the pending buffer's cnt entries into the list
  __device__ __forceinline__ void flush(const u64* pend, int cnt, int lane,
                                        int k) {
    __syncwarp();
    L = merge_batch<TWO>(L, lane < cnt ? pend[lane] : ~0ull, ~0ull, false);
    set_thr(k);
    __syncwarp();
  }

  // the slow path of a tile's fold: n candidates (p0 / p1 of c0 / c1)
  // would overflow the pending buffer's cnt entries: the buffer merged
  // first, then more than PENDING of them merged straight into the list;
  // returns the buffer's new count (the candidates left to append are
  // marked in p0 / p1, their number in n)
  __device__ __forceinline__ int make_room(u64* pend, int cnt, u64 c0,
                                           u64 c1, bool& p0, bool& p1,
                                           int& n, int lane, int k) {
    if (cnt) {
      flush(pend, cnt, lane, k);
      p0 = p0 && (unsigned)(c0 >> 32) < thr;
      p1 = p1 && (unsigned)(c1 >> 32) < thr;
      n = __popc(__ballot_sync(FULL, p0)) + __popc(__ballot_sync(FULL, p1));
    }
    if (n > PENDING) {
      L = merge_batch<TWO>(L, p0 ? c0 : ~0ull, p1 ? c1 : ~0ull, true);
      set_thr(k);
      p0 = p1 = false;
      n = 0;
    }
    return 0;
  }
};

// A warp folds one tile into its QUERIES queries' lists (key rows from
// `keys`, indices from base): first every query's compares and ballots, so
// the loads and votes of the 8 queries overlap; then each query's
// candidates under its k-th key are appended to its pending buffer (by the
// ballots' prefix counts), the buffer merged first where they would
// overflow it.
template <bool TWO>
__device__ __forceinline__ void fold_tile(TopK<TWO> (&lists)[QUERIES],
                                          const unsigned* keys, u64* pend,
                                          int* counts, int row0, int q_rows,
                                          int base, int N, int lane, int k) {
  unsigned b0[QUERIES], b1[QUERIES];
  uint2 kv[QUERIES];
  const int i0 = base + 2 * lane;
#pragma unroll
  for (int m = 0; m < QUERIES; ++m) {
    const int row = min(row0 + m, q_rows - 1);
    kv[m] = *reinterpret_cast<const uint2*>(keys + row * KEY_STRIDE
                                            + 2 * lane);
    b0[m] = __ballot_sync(FULL, i0 < N && kv[m].x < lists[m].thr
                                    && row0 + m < q_rows);
    b1[m] = __ballot_sync(FULL, i0 + 1 < N && kv[m].y < lists[m].thr
                                    && row0 + m < q_rows);
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int m = 0; m < QUERIES; ++m) {
    int n = __popc(b0[m]) + __popc(b1[m]);
    if (n == 0) continue;
    const int row = row0 + m;
    u64* prow = pend + row * PENDING;
    const u64 c0 = ((u64)kv[m].x << 32) | (unsigned)i0;
    const u64 c1 = ((u64)kv[m].y << 32) | (unsigned)(i0 + 1);
    bool p0 = (b0[m] >> lane) & 1, p1 = (b1[m] >> lane) & 1;
    int cnt = counts[row];
    if (cnt + n > PENDING) {
      cnt = lists[m].make_room(prow, cnt, c0, c1, p0, p1, n, lane, k);
      if (n == 0) {
        if (lane == 0) counts[row] = 0;
        continue;
      }
      b0[m] = __ballot_sync(FULL, p0);
      b1[m] = __ballot_sync(FULL, p1);
    }
    const int s = cnt + __popc(b0[m] & below) + __popc(b1[m] & below);
    if (p0) prow[s] = c0;
    if (p1) prow[s + (p0 ? 1 : 0)] = c1;
    if (lane == 0) counts[row] = cnt + n;
  }
  __syncwarp();
}

__device__ __forceinline__ unsigned ffma_key(float dot, float qa, float pc) {
  return order_key(__fadd_rn(__fsub_rn(qa, __fmul_rn(2.f, dot)), pc));
}

// ---- the kernel ------------------------------------------------------------

template <typename T, bool MULTI, bool TWO, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
knn_channels_kernel(const T* __restrict__ q, const T* __restrict__ db,
                    long long* __restrict__ out, int S, int N, int C, int k,
                    int width) {
  constexpr bool BF16 = sizeof(T) == 2;   // products on mma.sync, else FFMA
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem);       // [64][72]
  float* pn = reinterpret_cast<float*>(keys + ROWS * KEY_STRIDE);
  float* qn = pn + ROWS;
  u64* pend = reinterpret_cast<u64*>(qn + ROWS);             // [64][32]
  int* counts = reinterpret_cast<int*>(pend + ROWS * PENDING);  // [64]
  T* tiles = reinterpret_cast<T*>(counts + ROWS);
  const int stride = row_stride(width, (int)sizeof(T));
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
  const int ty = tid >> 4, tx = tid & 15;       // FFMA: the register tile
  const int fg = lane >> 2, ft = lane & 3;      // mma: the fragment's lane
  const int m_row = 16 * (warp >> 1), n_col = 32 * (warp & 1);
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
  if (tid < ROWS) counts[tid] = 0;     // read after the first barrier

  TopK<TWO> lists[QUERIES];

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
    if constexpr (BF16) {
      // a warp's 16 queries x 32 points: four m16n8k16 tiles a k-step
      const int ksteps = (cw + 15) / 16;
      const __nv_bfloat16* qa = Q + (m_row + fg) * stride + 2 * ft;
      const __nv_bfloat16* pb = P + (n_col + fg) * stride + 2 * ft;
      for (int kk = 0; kk < ksteps; ++kk) {
        const int c = 16 * kk;
        const uint32_t a[4] = {
            bf16mma::ld32(qa + c), bf16mma::ld32(qa + 8 * stride + c),
            bf16mma::ld32(qa + c + 8), bf16mma::ld32(qa + 8 * stride + c + 8)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* pj = pb + 8 * j * stride + c;
          bf16mma::mma(acc[j], a, bf16mma::ld32(pj), bf16mma::ld32(pj + 8));
        }
      }
    } else {
      // a 4 x 4 tile of (query ty + 16 i, point tx + 16 j) a thread
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
    if constexpr (!BF16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qa = qn[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          keys[(ty + 16 * i) * KEY_STRIDE + tx + 16 * j] =
              ffma_key(acc[i][j], qa, pn[tx + 16 * j]);
      }
    } else {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m_row + fg + 8 * hh;
        const float qa = qn[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n_col + 8 * j + 2 * ft;
          unsigned kv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float inner = Elem<T>::round(acc[j][2 * hh + e]);
            kv[e] = order_key(Elem<T>::round(__fadd_rn(
                Elem<T>::round(__fsub_rn(qa, __fmul_rn(2.f, inner))),
                pn[col + e])));
          }
          *reinterpret_cast<uint2*>(keys + row * KEY_STRIDE + col) =
              make_uint2(kv[0], kv[1]);
        }
      }
    }
    __syncthreads();

    const int base = t * ROWS;
    if (t == 0) {
      // the empty lists take the first tile's candidates, sorted: the
      // warp's 8 queries through one network at once
      u64 x0[QUERIES], x1[QUERIES];
#pragma unroll
      for (int m = 0; m < QUERIES; ++m) {
        const int row = min(warp * QUERIES + m, q_rows - 1);
        const uint2 kv = *reinterpret_cast<const uint2*>(
            keys + row * KEY_STRIDE + 2 * lane);
        x0[m] = 2 * lane < N ? ((u64)kv.x << 32) | (unsigned)(2 * lane)
                             : ~0ull;
        x1[m] = 2 * lane + 1 < N
                    ? ((u64)kv.y << 32) | (unsigned)(2 * lane + 1)
                    : ~0ull;
      }
      sort64_all(x0, x1, lane);
#pragma unroll
      for (int m = 0; m < QUERIES; ++m) {
        lists[m].L.e0 = x0[m];
        lists[m].L.e1 = x1[m];
        lists[m].set_thr(k);
      }
      continue;
    }
    fold_tile<TWO>(lists, keys, pend, counts, warp * QUERIES, q_rows, base,
                   N, lane, k);
  }

#pragma unroll
  for (int m = 0; m < QUERIES; ++m) {
    const int row = warp * QUERIES + m;
    if (row >= q_rows) continue;
    const int cnt = counts[row];
    if (cnt) lists[m].flush(pend + row * PENDING, cnt, lane, k);
    long long* o = out + ((size_t)b * S + s0 + row) * k;
    if (lane < k) o[lane] = (long long)(unsigned)lists[m].L.e0;
    if (TWO && lane + 32 < k) o[lane + 32] = (long long)(unsigned)lists[m].L.e1;
  }
}

// dynamic shared bytes of a launch: the keys, the two norm rows, the
// pending buffers and their counts, and the staged rows (three tiles at
// one stage, four past it)
size_t channels_smem(int C, int width, size_t esize) {
  const int tiles = width < C ? 4 : 3;
  return (size_t)ROWS * KEY_STRIDE * 4 + 2 * ROWS * 4
         + (size_t)ROWS * (PENDING * 8 + 4)
         + (size_t)tiles * ROWS * row_stride(width, (int)esize) * esize;
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

template <typename T, bool MULTI>
cudaError_t launch_routed(bool vec, bool two, const void* q, const void* db,
                          void* out, int B, int S, int N, int C, int k,
                          int width, size_t smem, cudaStream_t stream) {
  if (two)
    return vec ? launch_channels<T, MULTI, true, true>(
                     q, db, out, B, S, N, C, k, width, smem, stream)
               : launch_channels<T, MULTI, true, false>(
                     q, db, out, B, S, N, C, k, width, smem, stream);
  return vec ? launch_channels<T, MULTI, false, true>(
                   q, db, out, B, S, N, C, k, width, smem, stream)
             : launch_channels<T, MULTI, false, false>(
                   q, db, out, B, S, N, C, k, width, smem, stream);
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* db, void* out, int B,
                         int S, int N, int C, int k, int width, size_t smem,
                         cudaStream_t stream) {
  const size_t align = 4 * sizeof(T);
  const bool vec = C % 4 == 0 && (size_t)q % align == 0
                   && (size_t)db % align == 0;
  const bool two = k > 32;
  return width < C ? launch_routed<T, true>(vec, two, q, db, out, B, S, N, C,
                                            k, width, smem, stream)
                   : launch_routed<T, false>(vec, two, q, db, out, B, S, N, C,
                                             k, width, smem, stream);
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
