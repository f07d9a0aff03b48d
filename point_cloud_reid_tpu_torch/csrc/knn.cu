// k nearest neighbours of each query among its crop's points, in
// stable-argsort order (ties: lower index first).
//
// Replaces the TPU kernel point_cloud_reid_tpu/ops/pallas/knn.py (knn_pallas,
// _knn_kernel). Per crop b and query s it computes
//
//   d[n] = |q|^2 - 2 q.db[n] + |db[n]|^2          (the expanded form)
//   out[b, s, r] = the r-th smallest (d[n], n), lexicographically, r < k
//
// The TPU kernel keeps an (S, N) distance block in VMEM and unrolls k
// full-block argmin passes over it. Here a query row is one warp: lane l
// holds the distances of points l, l + 32, ... in registers, a round is a
// local scan plus a 5-step shuffle arg-min on the pair (distance, index),
// and the winning lane overwrites its slot with +inf. Ordering the pair
// lexicographically is first-occurrence, so duplicated points (crops are
// resampled with replacement) come out lower index first, exactly as a
// stable argsort gives them. Inputs must be finite and k <= N <= 128: the
// SA stages search crops of 64 and 128 points, which is 2 and 4 registers a
// lane; a larger N needs another instantiation below.
//
// Rounding: every sum is written with the round-to-nearest intrinsics in a
// fixed order (products, then x + y + z; the inner product as an FMA
// chain), so the compiler can contract nothing and near-ties are ordered
// the same way in every build.
//
// What bounds it on the H100: neither bytes nor arithmetic. A (512, 128,
// 128, 32) call reads 1.5 MB and writes 8 MB (2.9 us at 3.35 TB/s) and does
// 2 M warp-level arg-min rounds; it is bound by shuffle latency. The crop's
// points are staged once per block in shared memory (N x 4 floats), rows of
// a block share them, and the k winners of a row are written 32 at a time,
// coalesced.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int WARPS = 8;   // query rows per block

template <int PL>          // points per lane: N <= 32 * PL
__global__ void __launch_bounds__(WARPS * 32)
knn_kernel(const float* __restrict__ q, const float* __restrict__ db,
           int* __restrict__ out, int S, int N, int k) {
  extern __shared__ float sm[];
  float* pts = sm;            // [N][3]
  float* dn = sm + 3 * N;     // [N] |db|^2
  const int row_blocks = (S + WARPS - 1) / WARPS;
  const int b = blockIdx.x / row_blocks;
  const float* dbb = db + (size_t)b * N * 3;
  for (int e = threadIdx.x; e < 3 * N; e += blockDim.x) pts[e] = dbb[e];
  __syncthreads();
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float x = pts[3 * j], y = pts[3 * j + 1], z = pts[3 * j + 2];
    dn[j] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                      __fmul_rn(z, z));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = (blockIdx.x % row_blocks) * WARPS + warp;
  if (s >= S) return;
  const float* qp = q + ((size_t)b * S + s) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float qn = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                             __fmul_rn(qz, qz));
  float d[PL];
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int j = lane + 32 * i;
    if (j < N) {
      const float inner = __fmaf_rn(
          qz, pts[3 * j + 2],
          __fmaf_rn(qy, pts[3 * j + 1], __fmul_rn(qx, pts[3 * j])));
      d[i] = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, inner)), dn[j]);
    } else {
      d[i] = CUDART_INF_F;
    }
  }

  int* o = out + ((size_t)b * S + s) * k;
  int keep = 0;
  for (int r = 0; r < k; ++r) {
    // this lane's best: ascending i is ascending index, strict < keeps the
    // first occurrence
    float bd = d[0];
    int bi = 0;
#pragma unroll
    for (int i = 1; i < PL; ++i)
      if (d[i] < bd) { bd = d[i]; bi = i; }
    const int bj = lane + 32 * bi;
    float wd = bd;
    int wj = bj;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, wd, off);
      const int oj = __shfl_xor_sync(0xffffffffu, wj, off);
      if (od < wd || (od == wd && oj < wj)) { wd = od; wj = oj; }
    }
    if (wj == bj) {           // an index belongs to one lane only
#pragma unroll
      for (int i = 0; i < PL; ++i)
        if (i == bi) d[i] = CUDART_INF_F;
    }
    if (lane == (r & 31)) keep = wj;
    if ((r & 31) == 31 || r == k - 1) {
      const int base = r & ~31;
      if (base + lane <= r) o[base + lane] = keep;
    }
  }
}

template <int PL>
cudaError_t launch(const float* q, const float* db, int* out, int B, int S,
                   int N, int k, cudaStream_t stream) {
  const int grid = ((S + WARPS - 1) / WARPS) * B;
  const size_t smem = (size_t)4 * N * sizeof(float);
  knn_kernel<PL><<<grid, WARPS * 32, smem, stream>>>(q, db, out, S, N, k);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, 3), db (B, N <= 128, 3) float32 contiguous -> out (B, S, k) int32.
extern "C" int pcr_knn(const void* q, const void* db, void* out, int B, int S,
                       int N, int k, void* stream) {
  if (B <= 0 || S <= 0 || k <= 0 || k > N || N > 128)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* df = (const float*)db;
  int* of = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 64) return (int)launch<2>(qf, df, of, B, S, N, k, st);
  return (int)launch<4>(qf, df, of, B, S, N, k, st);
}
