// Multi-head linear attention, forward: one block per (batch, head).
//
// Replaces the TPU kernel point_cloud_reid_tpu/ops/pallas/linear_attention.py:107
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
// are computed here, in shared memory and registers; nothing but the output
// goes back to device memory. The gradient is not a kernel: the TPU package
// recomputes it through its plain composite, and so does the wrapper.
//
// What bounds it on the H100: bytes. At the flagship's cross stages (B=256,
// L=S=128, H=2, D=V=32) a call reads 3 x 8.4 MB and writes 8.4 MB (10 us at
// 3.35 TB/s) against 0.27 GFLOP (4 us at 67 TFLOP/s float32). The design
// keeps the loads in flight and the arithmetic off the critical path:
//
// - Rows stream in chunks of RC (64, or 32 when D and V are wide) through a
//   ring of NSTAGE shared-memory stages filled by cp.async, NSTAGE - 1
//   chunks ahead of the one being computed: the K / v chunks, then the q
//   chunks, as one sequence, straight from their (B, L, H, D) strides (no
//   transposed copies as on the TPU). Each thread applies elu + 1 (or the
//   1/S scale) in place to the elements it copied, so one barrier a chunk
//   publishes the chunk and frees the stage computed before it.
// - Phase 1 (KV, Ksum): each thread owns a 4 x 4 tile of KV in registers and
//   one of G row groups (rows g, g + G, ...; G a power of two, 256 / tiles
//   at most 32), fed by two 16-byte shared loads a row for 16 FMAs; the
//   threads of a tile's column block 0 add the K' rows into Ksum. The G
//   partial tiles meet by warp shuffles once, after the last chunk.
// - Phase 2 (out): each thread owns 2 rows x 4 columns of a chunk's output
//   and the two rows' normalisers, seven 16-byte loads (two q' quads, the
//   Ksum quad, four KV quads) for 40 FMAs, and stores 16 bytes a row.
//
// Rows need unit stride on the last axis; the 16-byte copies also need D, V,
// every stride and the base pointers in multiples of 4 floats, otherwise the
// copies go 4 bytes at a time. D, V <= 128.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSTAGE = 3;

// elu(x) + 1, as the TPU kernel writes it: exp(x) below 0
__device__ __forceinline__ float elu1(float x) {
  return x > 0.f ? x + 1.f : expf(x);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int L, S, H, D, V;
  long long qb, ql, qh, kb, ks, kh, vb, vs, vh;
  float eps;
  int rc;        // rows per chunk
  int groups;    // phase-1 row groups G, a power of two <= 32
};

// A thread's place in a chunk of `units` 16-byte (VEC4) or 4-byte units a
// row: rows r0, r0 + step, ... at unit column c; threads past the last
// whole row of units copy nothing.
struct Slot {
  int r0, c, step;
};

__device__ __forceinline__ Slot slot_of(int units) {
  const int step = THREADS / units, r0 = threadIdx.x / units;
  return {r0 < step ? r0 : INT_MAX, threadIdx.x - r0 * units, step};
}

// Copy `rows` rows (source rows `ld` apart) into a stage with rows `dp`
// apart; after the wait, transform_rows rewrites the same elements in
// place: each thread touches only what it copied.
template <bool VEC4>
__device__ __forceinline__ void copy_rows(float* dst, int dp, const float* src,
                                          long long ld, int rows, Slot sl) {
  const int c = VEC4 ? 4 * sl.c : sl.c;
  for (int r = sl.r0; r < rows; r += sl.step) {
    if (VEC4)
      cp_async16(dst + r * dp + c, src + r * ld + c);
    else
      cp_async4(dst + r * dp + c, src + r * ld + c);
  }
}

template <bool VEC4, bool ELU>
__device__ __forceinline__ void transform_rows(float* dst, int dp, int rows,
                                               Slot sl, float len) {
  for (int r = sl.r0; r < rows; r += sl.step) {
    if (VEC4) {
      float4* p = reinterpret_cast<float4*>(dst + r * dp + 4 * sl.c);
      float4 x = *p;
      if (ELU) {
        x.x = elu1(x.x); x.y = elu1(x.y); x.z = elu1(x.z); x.w = elu1(x.w);
      } else {
        x.x = __fdiv_rn(x.x, len); x.y = __fdiv_rn(x.y, len);
        x.z = __fdiv_rn(x.z, len); x.w = __fdiv_rn(x.w, len);
      }
      *p = x;
    } else {
      float* p = dst + r * dp + sl.c;
      *p = ELU ? elu1(*p) : __fdiv_rn(*p, len);
    }
  }
}

// The item-th chunk of the sequence (K / v chunks, then q chunks) into its
// stage: K' (or q') at the stage's start, v after RC rows of DP.
template <bool VEC4>
__device__ __forceinline__ void fetch(const Params& p, float* ring, int item,
                                      int nk, const float* qp, const float* kp,
                                      const float* vp, int dp, int vpad,
                                      Slot sd, Slot sv) {
  float* st = ring + (item % NSTAGE) * p.rc * (dp + vpad);
  if (item < nk) {
    const int r0 = item * p.rc, rows = min(p.rc, p.S - r0);
    copy_rows<VEC4>(st, dp, kp + r0 * p.ks, p.ks, rows, sd);
    copy_rows<VEC4>(st + p.rc * dp, vpad, vp + r0 * p.vs, p.vs, rows, sv);
  } else {
    const int r0 = (item - nk) * p.rc, rows = min(p.rc, p.L - r0);
    copy_rows<VEC4>(st, dp, qp + r0 * p.ql, p.ql, rows, sd);
  }
}

#define FMA4x4(acc, a, b)                                                   \
  acc[0] = fmaf(a.x, b.x, acc[0]); acc[1] = fmaf(a.x, b.y, acc[1]);         \
  acc[2] = fmaf(a.x, b.z, acc[2]); acc[3] = fmaf(a.x, b.w, acc[3]);         \
  acc[4] = fmaf(a.y, b.x, acc[4]); acc[5] = fmaf(a.y, b.y, acc[5]);         \
  acc[6] = fmaf(a.y, b.z, acc[6]); acc[7] = fmaf(a.y, b.w, acc[7]);         \
  acc[8] = fmaf(a.z, b.x, acc[8]); acc[9] = fmaf(a.z, b.y, acc[9]);         \
  acc[10] = fmaf(a.z, b.z, acc[10]); acc[11] = fmaf(a.z, b.w, acc[11]);     \
  acc[12] = fmaf(a.w, b.x, acc[12]); acc[13] = fmaf(a.w, b.y, acc[13]);     \
  acc[14] = fmaf(a.w, b.z, acc[14]); acc[15] = fmaf(a.w, b.w, acc[15]);

// U: tiles (phase 1) and output units (phase 2) a thread owns, 1, 2 or 4
template <int U, bool VEC4>
__global__ void __launch_bounds__(THREADS, U == 1 ? 4 : 1)
lin_attn_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  const int D4 = (p.D + 3) >> 2, V4 = (p.V + 3) >> 2;
  const int dp = 4 * D4, vpad = 4 * V4;
  float* ring = sm;                                  // [NSTAGE][RC][dp + vpad]
  float* kv = ring + NSTAGE * p.rc * (dp + vpad);    // [dp][vpad]
  float* ksum = kv + dp * vpad;                      // [dp]
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float* qp = p.q + b * p.qb + h * p.qh;
  const float* kp = p.k + b * p.kb + h * p.kh;
  const float* vp = p.v + b * p.vb + h * p.vh;
  const float len = (float)p.S;
  const int nk = (p.S + p.rc - 1) / p.rc;
  const int items = nk + (p.L + p.rc - 1) / p.rc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Slot sd = slot_of(VEC4 ? D4 : p.D), sv = slot_of(VEC4 ? V4 : p.V);

  // the padding columns of K' and q' (D not a multiple of 4) stay zero
  for (int e = threadIdx.x; e < NSTAGE * p.rc * (dp - p.D); e += THREADS) {
    const int r = e / (dp - p.D);
    ring[(r / p.rc) * p.rc * (dp + vpad) + (r % p.rc) * dp + p.D
         + e % (dp - p.D)] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < items) fetch<VEC4>(p, ring, s, nk, qp, kp, vp, dp, vpad, sd, sv);
    cp_commit();
  }

  // ---- phase 1: KV and Ksum over the K / v chunks ----
  const int G = p.groups, tpw = 32 / G, g = lane / tpw;
  int dt[U], vt[U];
  bool own[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int tile = (u * WARPS + warp) * tpw + lane % tpw;
    own[u] = tile < D4 * V4;
    dt[u] = own[u] ? tile / V4 : 0;
    vt[u] = own[u] ? tile % V4 : 1;
  }
  float acc[U][16], kacc[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[u][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) kacc[u][e] = 0.f;
  }
  for (int it = 0; it < nk; ++it) {
    float* st = ring + (it % NSTAGE) * p.rc * (dp + vpad);
    const int rows = min(p.rc, p.S - it * p.rc);
    cp_wait<NSTAGE - 2>();
    transform_rows<VEC4, true>(st, dp, rows, sd, len);
    transform_rows<VEC4, false>(st + p.rc * dp, vpad, rows, sv, len);
    __syncthreads();     // chunk it is ready; chunk it - 1's stage is free
    if (it + NSTAGE - 1 < items)
      fetch<VEC4>(p, ring, it + NSTAGE - 1, nk, qp, kp, vp, dp, vpad, sd,
                  sv);
    cp_commit();
    const float* kt = st;
    const float* vt_ = st + p.rc * dp;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!own[u]) continue;
      for (int r = g; r < rows; r += G) {
        const float4 a = *reinterpret_cast<const float4*>(kt + r * dp + 4 * dt[u]);
        const float4 c = *reinterpret_cast<const float4*>(vt_ + r * vpad + 4 * vt[u]);
        FMA4x4(acc[u], a, c)
        if (vt[u] == 0) {
          kacc[u][0] += a.x; kacc[u][1] += a.y;
          kacc[u][2] += a.z; kacc[u][3] += a.w;
        }
      }
    }
  }
  // the G row groups' partial tiles meet: lanes tpw, 2 tpw, ... apart
#pragma unroll
  for (int u = 0; u < U; ++u) {
    for (int off = tpw; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        acc[u][e] += __shfl_xor_sync(0xffffffffu, acc[u][e], off);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        kacc[u][e] += __shfl_xor_sync(0xffffffffu, kacc[u][e], off);
    }
    if (own[u] && g == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(kv + (4 * dt[u] + i) * vpad + 4 * vt[u]) =
            make_float4(acc[u][4 * i], acc[u][4 * i + 1], acc[u][4 * i + 2],
                        acc[u][4 * i + 3]);
      }
      if (vt[u] == 0)
        *reinterpret_cast<float4*>(ksum + 4 * dt[u]) =
            make_float4(kacc[u][0], kacc[u][1], kacc[u][2], kacc[u][3]);
    }
  }

  // ---- phase 2: the output over the q chunks (KV and Ksum are published by
  // the first chunk's barrier) ----
  for (int it = nk; it < items; ++it) {
    float* st = ring + (it % NSTAGE) * p.rc * (dp + vpad);
    const int l0 = (it - nk) * p.rc, rows = min(p.rc, p.L - l0);
    cp_wait<NSTAGE - 2>();
    transform_rows<VEC4, true>(st, dp, rows, sd, len);
    __syncthreads();
    if (it + NSTAGE - 1 < items)
      fetch<VEC4>(p, ring, it + NSTAGE - 1, nk, qp, kp, vp, dp, vpad, sd,
                  sv);
    cp_commit();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int unit = u * THREADS + threadIdx.x;
      const int r0 = 2 * (unit / V4), c0 = 4 * (unit % V4);
      if (r0 >= rows) continue;
      float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
      float z0 = 0.f, z1 = 0.f;
      const float* q0 = st + r0 * dp;
      const float* q1 = q0 + dp;     // row r0 + 1 < RC (RC even); unused
                                     // past `rows`
      for (int d = 0; d < dp; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(q0 + d);
        const float4 x1 = *reinterpret_cast<const float4*>(q1 + d);
        const float4 s = *reinterpret_cast<const float4*>(ksum + d);
        const float xs0[4] = {x0.x, x0.y, x0.z, x0.w};
        const float xs1[4] = {x1.x, x1.y, x1.z, x1.w};
        const float ss[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(kv + (d + i) * vpad + c0);
          a0[0] = fmaf(xs0[i], w.x, a0[0]); a0[1] = fmaf(xs0[i], w.y, a0[1]);
          a0[2] = fmaf(xs0[i], w.z, a0[2]); a0[3] = fmaf(xs0[i], w.w, a0[3]);
          a1[0] = fmaf(xs1[i], w.x, a1[0]); a1[1] = fmaf(xs1[i], w.y, a1[1]);
          a1[2] = fmaf(xs1[i], w.z, a1[2]); a1[3] = fmaf(xs1[i], w.w, a1[3]);
          z0 = fmaf(xs0[i], ss[i], z0);
          z1 = fmaf(xs1[i], ss[i], z1);
        }
      }
      const float n0 = 1.f / (z0 + p.eps), n1 = 1.f / (z1 + p.eps);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (r0 + j >= rows) break;
        const float* a = j ? a1 : a0;
        const float n = j ? n1 : n0;
        float* o = p.out + (((size_t)b * p.L + l0 + r0 + j) * p.H + h) * p.V + c0;
        if (VEC4) {
          *reinterpret_cast<float4*>(o) = make_float4(
              a[0] * n * len, a[1] * n * len, a[2] * n * len, a[3] * n * len);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < p.V) o[c] = a[c] * n * len;
        }
      }
    }
  }
}

template <int U, bool VEC4>
cudaError_t launch(const Params& p, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lin_attn_kernel<U, VEC4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  lin_attn_kernel<U, VEC4><<<B * p.H, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int U>
cudaError_t launch_vec(const Params& p, int B, size_t smem, bool vec4,
                       cudaStream_t stream) {
  return vec4 ? launch<U, true>(p, B, smem, stream)
              : launch<U, false>(p, B, smem, stream);
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
  Params p{(const float*)q, (const float*)k, (const float*)v, (float*)out,
           L, S, H, D, V, qb, ql, qh, kb, ks, kh, vb, vs, vh, eps, 64, 1};
  const int D4 = (D + 3) / 4, V4 = (V + 3) / 4, tiles = D4 * V4;
  // the ring, KV and Ksum; 32-row chunks past 160 KB, which 64 rows of the
  // widest D, V (260 KB) would pass beyond the 227 KB a block may have
  auto smem_of = [&](int rc) {
    return (size_t)(NSTAGE * rc * 4 * (D4 + V4) + 16 * D4 * V4 + 4 * D4) *
           sizeof(float);
  };
  if (smem_of(p.rc) > 160 * 1024) p.rc = 32;
  while (p.groups * 2 <= 32 && p.groups * 2 * tiles <= THREADS) p.groups *= 2;
  // tiles a thread owns in phase 1, output units in phase 2
  const int u1 = (tiles * p.groups + THREADS - 1) / THREADS;
  const int u2 = (p.rc / 2 * V4 + THREADS - 1) / THREADS;
  const int u = u1 > u2 ? u1 : u2;
  bool vec4 = D % 4 == 0 && V % 4 == 0;
  for (long long s : {qb, ql, qh, kb, ks, kh, vb, vs, vh}) vec4 = vec4 && s % 4 == 0;
  for (const void* ptr : {q, k, v}) vec4 = vec4 && (uintptr_t)ptr % 16 == 0;
  const size_t smem = smem_of(p.rc);
  cudaStream_t st = (cudaStream_t)stream;
  if (u == 1) return (int)launch_vec<1>(p, B, smem, vec4, st);
  if (u == 2) return (int)launch_vec<2>(p, B, smem, vec4, st);
  return (int)launch_vec<4>(p, B, smem, vec4, st);
}
