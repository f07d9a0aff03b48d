// k nearest neighbours of each query among its crop's points, in
// stable-argsort order (ties: lower index first), written as int64.
//
// Replaces the TPU kernel point_cloud_reid_tpu/ops/pallas/knn.py:51
// (knn_pallas, _knn_kernel). Per crop b and query s it computes
//
//   d[n] = |q|^2 - 2 q.db[n] + |db[n]|^2          (the expanded form)
//   out[b, s, r] = the r-th smallest (d[n], n), lexicographically, r < k
//
// The TPU kernel keeps an (S, N) distance block in VMEM and unrolls k
// full-block argmin passes over it. Here a query row is one warp: lane l
// holds points l, l + 32, ... (PL of them, N <= 32 PL <= 128), turns each
// distance into a uint32 key that orders as the float does (-0 made +0,
// then the sign bit flipped for positives and every bit for negatives),
// and sorts its PL (key, index) pairs once in registers. A round of the
// selection is then two warp reductions (redux.sync): the least head key,
// and the least index among the lanes whose head holds that key. The lane
// that owns the winner pops its head. Ordering (key, index) is
// first-occurrence, so duplicated points (crops are resampled with
// replacement) come out lower index first, exactly as a stable argsort
// gives them. Inputs must be finite and k <= N. That is tier R (registers),
// N <= 128.
//
// Beyond 128 points (the point-count ablations train at up to 2048) a
// lane's sorted keys no longer fit in registers, and k (up to 48) is too
// many slots for a per-lane top-k list. Tiers S (shared) and G (global)
// keep no keys at all: lane l owns the contiguous slice [l L, (l + 1) L) of
// the points, L = ceil(N / 32), and holds only the head of its slice, the
// least (key, index) it has not yet given up. A round is the same two
// redux.sync over the heads; the winner's slice is known from its index
// (w / L), and the whole warp then rescans that slice, L / 32 points a
// lane, for its least (key, index) after the winner's, followed by two more
// redux.sync: since a slice gives up its points in (key, index) order, the
// points after the last one given up are exactly the ones left, so nothing
// is marked and nothing but the heads is stored. Tier S stages the crop's
// points in shared memory as in tier R (16 bytes a point: N <= 14,528);
// tier G reads them from device memory (L2) on every scan, for any N. Both
// compute each distance with the same intrinsics in the same order as tier
// R, so every tier orders near-ties alike. kernels/knn.py's plan(N, k)
// picks the tier; pcr_knn_plan launches the plan it is given.
//
// Rounding: every sum is written with the round-to-nearest intrinsics in a
// fixed order (products, then x + y + z; the inner product as an FMA
// chain), so the compiler can contract nothing and near-ties are ordered
// the same way in every build.
//
// What bounds it on the H100: neither bytes nor arithmetic. A (512, 128,
// 128, 32) call reads 1.5 MB and writes 16.8 MB of int64 (5.5 us at 3.35
// TB/s) and runs 2 M warp-wide selection rounds, each a dependent chain of
// two reductions and a few selects: the SM's instruction rate on those
// rounds bounds it, not their latency (two queries a warp, interleaved,
// measured slower). The design cuts a round from the earlier 5-step butterfly (10 shuffles, 10
// compare-selects, a scan of the lane's slots and a clear) to that chain,
// runs the rounds in unrolled runs of 16 (no loop or store bookkeeping a
// round), keeps the lane's sorted indices a byte a slot in one register (a
// pop shifts the keys and that register), and writes the int64 indices
// itself, 16 of a row at a time and coalesced, so no cast pass follows. The
// crop's points are staged once per block in shared memory as (x, y, z,
// |p|^2), one 16-byte load a point, and shared by the block's query rows.
// Tiers S and G are bound the same way, by their rounds, each of which
// rescans L points: at (512, 128, 2048, 32) the function needs 0.016 ms of
// operations (8 flops a distance) against 30 rescans of 64 points a query.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int WARPS = 8;   // query rows per block
constexpr unsigned FULL = 0xffffffffu;

// a uint32 that orders as the float distance does (finite inputs)
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned u = __float_as_uint(__fadd_rn(d, 0.f));   // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int A, int B>
__device__ __forceinline__ void sort2(unsigned* key, unsigned* idx) {
  const bool swap = key[A] > key[B] || (key[A] == key[B] && idx[A] > idx[B]);
  const unsigned ka = key[A], ia = idx[A];
  key[A] = swap ? key[B] : ka;
  idx[A] = swap ? idx[B] : ia;
  key[B] = swap ? ka : key[B];
  idx[B] = swap ? ia : idx[B];
}

// One selection round over the warp's heads: the least head key, then the
// least index among the heads holding it (some head is a point while
// rounds < N, so the winner is never 0xff); the lane that owns it pops its
// head. The lane's sorted indices sit packed a byte a slot in `idx`, so a
// pop is a shift of the keys and one of `idx`. Returns the winner's index on
// every lane.
template <int PL>
__device__ __forceinline__ unsigned select_round(unsigned* key,
                                                 unsigned& idx) {
  const unsigned m = __reduce_min_sync(FULL, key[0]);
  const unsigned head = idx & 0xffu;
  const unsigned w = __reduce_min_sync(FULL, key[0] == m ? head : 0xffu);
  if (head == w) {            // an index belongs to one lane only
#pragma unroll
    for (int i = 0; i + 1 < PL; ++i) key[i] = key[i + 1];
    key[PL - 1] = UINT_MAX;
    idx = (idx >> 8) | 0xff000000u;
  }
  return w;
}

template <int PL>          // points per lane: N <= 32 * PL
__global__ void __launch_bounds__(WARPS * 32)
knn_kernel(const float* __restrict__ q, const float* __restrict__ db,
           long long* __restrict__ out, int S, int N, int k) {
  extern __shared__ float4 pts[];    // [N] (x, y, z, |p|^2)
  const int row_blocks = (S + WARPS - 1) / WARPS;
  const int b = blockIdx.x / row_blocks;
  const float* dbb = db + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float x = dbb[3 * j], y = dbb[3 * j + 1], z = dbb[3 * j + 2];
    pts[j] = make_float4(x, y, z,
                         __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                   __fmul_rn(z, z)));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = (blockIdx.x % row_blocks) * WARPS + warp;
  if (s >= S) return;
  const float* qp = q + ((size_t)b * S + s) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float qn = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                             __fmul_rn(qz, qz));
  unsigned key[PL], idx[PL];
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int j = lane + 32 * i;
    if (j < N) {
      const float4 p = pts[j];
      const float inner = __fmaf_rn(qz, p.z,
                                    __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
      key[i] = order_key(__fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, inner)),
                                   p.w));
      idx[i] = j;
    } else {                  // past N: after every point
      key[i] = UINT_MAX;
      idx[i] = UINT_MAX;
    }
  }
  // the lane's slots in (key, index) order: a sorting network
  if constexpr (PL == 2) {
    sort2<0, 1>(key, idx);
  } else {
    sort2<0, 1>(key, idx); sort2<2, 3>(key, idx);
    sort2<0, 2>(key, idx); sort2<1, 3>(key, idx);
    sort2<1, 2>(key, idx);
  }

  unsigned packed = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < PL; ++i)
    packed = (packed & ~(0xffu << (8 * i))) | ((idx[i] & 0xffu) << (8 * i));

  // rounds in unrolled runs of 16: lane c keeps the c-th winner of a run,
  // and the run's 16 winners go out as one 128-byte store
  long long* o = out + ((size_t)b * S + s) * k;
  int r = 0;
  for (; r + 16 <= k; r += 16) {
    unsigned keep = 0;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const unsigned w = select_round<PL>(key, packed);
      if (lane == c) keep = w;
    }
    if (lane < 16) o[r + lane] = keep;
  }
  if (r < k) {
    unsigned keep = 0;
    for (int c = 0; r + c < k; ++c) {
      const unsigned w = select_round<PL>(key, packed);
      if (lane == c) keep = w;
    }
    if (r + lane < k) o[r + lane] = keep;
  }
}

template <int PL>
cudaError_t launch(const float* q, const float* db, long long* out, int B,
                   int S, int N, int k, cudaStream_t stream) {
  const int grid = ((S + WARPS - 1) / WARPS) * B;
  const size_t smem = (size_t)N * sizeof(float4);
  knn_kernel<PL><<<grid, WARPS * 32, smem, stream>>>(q, db, out, S, N, k);
  return cudaGetLastError();
}


// ---- tiers S and G: a head a lane, rescans of the winner's slice -------------

constexpr int SCAN_WARPS = 16;   // query rows a block in tiers S and G

// the distance key of point j, as tier R computes it
template <bool SHARED>
__device__ __forceinline__ unsigned point_key(const float4* pts,
                                              const float* dbb, int j,
                                              float qx, float qy, float qz,
                                              float qn) {
  float4 p;
  if constexpr (SHARED) {
    p = pts[j];
  } else {
    const float x = dbb[3 * j], y = dbb[3 * j + 1], z = dbb[3 * j + 2];
    p = make_float4(x, y, z,
                    __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                              __fmul_rn(z, z)));
  }
  const float inner = __fmaf_rn(qz, p.z,
                                __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
  return order_key(__fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, inner)), p.w));
}

// The least (key, index) of points [lo, hi) after (lk, li), over the warp,
// on every lane; (UINT_MAX, UINT_MAX) when none is left. Each lane scans
// its points in increasing index, so equal keys keep the lower index.
template <bool SHARED>
__device__ __forceinline__ void least_after(const float4* pts,
                                            const float* dbb, int lo, int hi,
                                            unsigned lk, unsigned li,
                                            float qx, float qy, float qz,
                                            float qn, unsigned& mk,
                                            unsigned& mi) {
  const int lane = threadIdx.x & 31;
  unsigned bk = UINT_MAX, bi = UINT_MAX;
  for (int j = lo + lane; j < hi; j += 32) {
    const unsigned kj = point_key<SHARED>(pts, dbb, j, qx, qy, qz, qn);
    const bool after = kj > lk || (kj == lk && (unsigned)j > li);
    if (after && kj < bk) {
      bk = kj;
      bi = j;
    }
  }
  mk = __reduce_min_sync(FULL, bk);
  mi = __reduce_min_sync(FULL, bk == mk ? bi : UINT_MAX);
}

template <bool SHARED>
__global__ void __launch_bounds__(SCAN_WARPS * 32)
knn_scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
                long long* __restrict__ out, int S, int N, int k) {
  extern __shared__ float4 pts[];    // tier S: [N] (x, y, z, |p|^2)
  const int warps = blockDim.x >> 5;
  const int row_blocks = (S + warps - 1) / warps;
  const int b = blockIdx.x / row_blocks;
  const float* dbb = db + (size_t)b * N * 3;
  if constexpr (SHARED) {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const float x = dbb[3 * j], y = dbb[3 * j + 1], z = dbb[3 * j + 2];
      pts[j] = make_float4(x, y, z,
                           __fadd_rn(__fadd_rn(__fmul_rn(x, x),
                                               __fmul_rn(y, y)),
                                     __fmul_rn(z, z)));
    }
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = (blockIdx.x % row_blocks) * warps + warp;
  if (s >= S) return;
  const float* qp = q + ((size_t)b * S + s) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float qn = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                             __fmul_rn(qz, qz));
  const int L = (N + 31) / 32;         // lane l's slice: [l L, (l + 1) L)

  // every lane's head: its slice's least (key, index); a finite distance's
  // key is at least 0x00800000, so every point comes after (0, 0)
  unsigned hk = UINT_MAX, hi = UINT_MAX;
  for (int sl = 0; sl < 32; ++sl) {
    unsigned mk, mi;
    least_after<SHARED>(pts, dbb, sl * L, min(N, (sl + 1) * L), 0u, 0u, qx,
                        qy, qz, qn, mk, mi);
    if (lane == sl) {
      hk = mk;
      hi = mi;
    }
  }

  long long* o = out + ((size_t)b * S + s) * k;
  unsigned keep = 0;
  for (int r = 0; r < k; ++r) {
    const unsigned m = __reduce_min_sync(FULL, hk);
    const unsigned w = __reduce_min_sync(FULL, hk == m ? hi : UINT_MAX);
    const int owner = (int)w / L;
    unsigned mk, mi;
    least_after<SHARED>(pts, dbb, owner * L, min(N, (owner + 1) * L), m, w,
                        qx, qy, qz, qn, mk, mi);
    if (lane == owner) {
      hk = mk;
      hi = mi;
    }
    // lane c keeps the c-th winner of a run of 16, stored as one 128 bytes
    if (lane == (r & 15)) keep = w;
    if ((r & 15) == 15 || r + 1 == k) {
      const int r0 = r & ~15;
      if (r0 + lane <= r && lane < 16) o[r0 + lane] = keep;
    }
  }
}

template <bool SHARED>
cudaError_t launch_scan(const float* q, const float* db, long long* out,
                        int B, int S, int N, int k, int warps, size_t smem,
                        cudaStream_t stream) {
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_scan_kernel<SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = ((S + warps - 1) / warps) * B;
  knn_scan_kernel<SHARED><<<grid, warps * 32, smem, stream>>>(q, db, out, S,
                                                              N, k);
  return cudaGetLastError();
}

}  // namespace

// Tiers, as kernels/knn.py numbers them, and the most dynamic shared
// memory a block may take on sm_90.
constexpr int TIER_R = 0, TIER_S = 1, TIER_G = 2;
constexpr size_t MAX_SMEM = 232448;

// q (B, S, 3), db (B, N, 3) float32 contiguous -> out (B, S, k) int64
// contiguous, launched as the plan (tier, points a lane, warps a block,
// dynamic shared bytes) says: tier R takes points 2 or 4 (N <= 32 points)
// and 8 warps; tier S 16 N bytes; tier G none. A plan that does not fit
// the shape is refused with cudaErrorInvalidValue.
extern "C" int pcr_knn_plan(const void* q, const void* db, void* out, int B,
                            int S, int N, int k, int tier, int points,
                            int warps, int smem, void* stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > N) return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* df = (const float*)db;
  long long* of = (long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tier) {
    case TIER_R:
      if (warps != WARPS || smem != N * (int)sizeof(float4) || N > 32 * points)
        return (int)cudaErrorInvalidValue;
      if (points == 2) return (int)launch<2>(qf, df, of, B, S, N, k, st);
      if (points == 4) return (int)launch<4>(qf, df, of, B, S, N, k, st);
      return (int)cudaErrorInvalidValue;
    case TIER_S:
      if (warps < 1 || warps > SCAN_WARPS || smem != N * (int)sizeof(float4)
          || (size_t)smem > MAX_SMEM)
        return (int)cudaErrorInvalidValue;
      return (int)launch_scan<true>(qf, df, of, B, S, N, k, warps, smem, st);
    case TIER_G:
      if (warps < 1 || warps > SCAN_WARPS || smem != 0)
        return (int)cudaErrorInvalidValue;
      return (int)launch_scan<false>(qf, df, of, B, S, N, k, warps, 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The entry point of earlier versions, N <= 128 (tier R); tools/ab_train_
// kernels.py times older builds through it.
extern "C" int pcr_knn_i64(const void* q, const void* db, void* out, int B,
                           int S, int N, int k, void* stream) {
  if (N > 128) return (int)cudaErrorInvalidValue;
  return pcr_knn_plan(q, db, out, B, S, N, k, TIER_R, N <= 64 ? 2 : 4, WARPS,
                      N * (int)sizeof(float4), stream);
}
