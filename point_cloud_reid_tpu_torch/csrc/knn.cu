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
// gives them. Inputs must be finite and k <= N <= 128.
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

}  // namespace

// q (B, S, 3), db (B, N <= 128, 3) float32 contiguous -> out (B, S, k)
// int64 contiguous.
extern "C" int pcr_knn_i64(const void* q, const void* db, void* out, int B,
                           int S, int N, int k, void* stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > N || N > 128)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* df = (const float*)db;
  long long* of = (long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 64) return (int)launch<2>(qf, df, of, B, S, N, k, st);
  return (int)launch<4>(qf, df, of, B, S, N, k, st);
}
