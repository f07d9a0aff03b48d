// Multi-head linear attention, forward: one block per (batch, head).
//
// Replaces the TPU kernel point_cloud_reid_tpu/ops/pallas/linear_attention.py
// (linear_attention_pallas, _lin_attn_kernel). For q (B, L, H, D),
// k (B, S, H, D), v (B, S, H, V) it computes, per (b, h),
//
//   Q' = elu(q) + 1,  K' = elu(k) + 1
//   KV = K'^T (v / S)            (D, V)
//   Ksum = sum_s K'              (D,)
//   out = (Q' KV) / (Q' . Ksum + eps) * S        (L, V)
//
// with the 1/S value pre-scale and the final * S kept in that order (they
// change rounding, and checkpoints were trained with them). Both products
// are computed here, in shared memory; nothing but the output goes back to
// device memory. The gradient is not a kernel: the TPU package recomputes
// it through its plain composite, and so does the wrapper.
//
// What bounds it on the H100: bytes. At the flagship's cross stages (B=256,
// L=S=128, H=2, D=V=32) a call reads 3 x 8.4 MB and writes 8.4 MB (10 us at
// 3.35 TB/s) against 0.27 GFLOP (4 us at 67 TFLOP/s float32). The design
// therefore reads q, k, v exactly once, straight from their (B, L, H, D)
// strides (no transposed copies as on the TPU), in 128-byte rows.
//
// Layout: rows are processed in chunks of RC. Phase 1 streams K' and v / S
// chunks through shared memory and accumulates KV and Ksum, each entry owned
// by one thread. Phase 2 streams Q' chunks, computes the normaliser per row,
// then one thread per output element takes the D-long product. The K'/Q'
// tile is padded to D + 1 floats a row so that the per-row dot products do
// not collide on one bank.

#include <cuda_runtime.h>

namespace {

constexpr int RC = 32;         // rows per chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float elu1(float x) {
  return x > 0.f ? x + 1.f : expm1f(x) + 1.f;
}

__global__ void __launch_bounds__(THREADS)
lin_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                int L, int S, int H, int D, int V,
                long long qb, long long ql, long long qh,
                long long kb, long long ks, long long kh,
                long long vb, long long vs, long long vh, float eps) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* rows = sm;               // [RC][DP]  K' chunk, then Q' chunk
  float* vals = rows + RC * DP;   // [RC][V]   v / S chunk
  float* kv = vals + RC * V;      // [D][V]
  float* ksum = kv + D * V;       // [D]
  float* z = ksum + D;            // [RC]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const float* qp = q + b * qb + h * qh;
  const float* kp = k + b * kb + h * kh;
  const float* vp = v + b * vb + h * vh;
  const float len = (float)S;

  for (int e = tid; e < D * V; e += THREADS) kv[e] = 0.f;
  for (int d = tid; d < D; d += THREADS) ksum[d] = 0.f;

  for (int s0 = 0; s0 < S; s0 += RC) {
    const int rc = min(RC, S - s0);
    __syncthreads();              // the previous chunk's readers are done
    for (int e = tid; e < rc * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      rows[r * DP + d] = elu1(kp[(s0 + r) * ks + d]);
    }
    for (int e = tid; e < rc * V; e += THREADS) {
      const int r = e / V, c = e - r * V;
      vals[e] = __fdiv_rn(vp[(s0 + r) * vs + c], len);
    }
    __syncthreads();
    for (int e = tid; e < D * V; e += THREADS) {
      const int d = e / V, c = e - d * V;
      float a = 0.f;
      for (int r = 0; r < rc; ++r) a = fmaf(rows[r * DP + d], vals[r * V + c], a);
      kv[e] += a;
    }
    for (int d = tid; d < D; d += THREADS) {
      float a = 0.f;
      for (int r = 0; r < rc; ++r) a += rows[r * DP + d];
      ksum[d] += a;
    }
  }

  for (int l0 = 0; l0 < L; l0 += RC) {
    const int rc = min(RC, L - l0);
    __syncthreads();              // kv / ksum complete; previous readers done
    for (int e = tid; e < rc * D; e += THREADS) {
      const int r = e / D, d = e - r * D;
      rows[r * DP + d] = elu1(qp[(l0 + r) * ql + d]);
    }
    __syncthreads();
    for (int r = tid; r < rc; r += THREADS) {
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(rows[r * DP + d], ksum[d], a);
      z[r] = 1.f / (a + eps);
    }
    __syncthreads();
    for (int e = tid; e < rc * V; e += THREADS) {
      const int r = e / V, c = e - r * V;
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(rows[r * DP + d], kv[d * V + c], a);
      out[(((size_t)b * L + l0 + r) * H + h) * V + c] = a * z[r] * len;
    }
  }
}

}  // namespace

// q (B, L, H, D), k (B, S, H, D), v (B, S, H, V): float32, unit stride on
// the last axis, the other strides (in elements) as given; out (B, L, H, V)
// contiguous float32.
extern "C" int pcr_linear_attention(
    const void* q, const void* k, const void* v, void* out, int B, int L,
    int S, int H, int D, int V, long long qb, long long ql, long long qh,
    long long kb, long long ks, long long kh, long long vb, long long vs,
    long long vh, float eps, void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || H <= 0 || D <= 0 || V <= 0 || D > 128 ||
      V > 128)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(RC * (D + 1) + RC * V + D * V + D + RC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lin_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lin_attn_kernel<<<B * H, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, L, S, H,
      D, V, qb, ql, qh, kb, ks, kh, vb, vs, vh, eps);
  return (int)cudaGetLastError();
}
