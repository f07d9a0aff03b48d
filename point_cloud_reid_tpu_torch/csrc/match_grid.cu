// Fused per-pair match chain of the flagship ReID head, grid or pair list.
//
// Replaces the TPU kernels point_cloud_reid_tpu/ops/pallas/match_grid.py
// fused_match_grid (pair_mode=False) and fused_match_pairs (pair_mode=True),
// both built on its _kernel. One block scores one (track, det) pair:
//
//   stage 1, both directions, from the hoisted per-object factors:
//     msg  = per head (q . KV) / (q . ksum + eps)        [KV | Z] = kvz
//     o_a  = search + LN2(relu(a1 + LN1(msg @ merge) @ fc1[C:]) @ fc2)
//   stage 2, both directions, full cross linear attention:
//     q = elu1(o_search @ Wq); k = elu1(o_templ @ Wk); v = o_templ @ Wv + pv
//     msg = per head (q . k^T v) / (q . sum k + eps), then the same FFN tail
//     with fc1[:C] applied to o_search in the block
//   point-cat pooling: max and mean over the 2N rows of both outputs.
//
// grid mode: block p scores track p / nd x det p % nd, out (nt, nd, 2C);
// pair mode: block p scores t_idx[p] x d_idx[p], out (P, 2C), reading the
// per-object factors directly (no pre-gathered per-pair copies).
// The 1/N value pre-scale and the xN rescale cancel and are both dropped.
// The TPU kernel's branch-free elu and (n, 1, C) layouts are Mosaic
// workarounds and are dropped.
//
// The image head (CrossLinAttn, match_grid.py pallas_image_grid_logits and
// pallas_image_pair_logits: the same _kernel with with_pos=False, n_true=S)
// is a second instantiation of the same kernel, POS=false: no pv term in
// stage 2 and no pv pointer among its arguments. The TPU kernel zero-pads
// the S=198 (197) tokens to a multiple of Mosaic's 8-row sublane tile and
// masks the pad rows out of the stage-2 template keys and the pooling
// (_pad_tokens, n_true, live3). Nothing here needs that: the block loops
// over the true S rows (the tail tile handles rows < R, the 4-row register
// groups are guarded), and the pooled mean divides by 2S. The padding and
// the mask are dropped. At S=198, C=64 the R=64 layout below would need
// 259.8 KB, so the image instantiation streams R=32-row tiles (211.8 KB).
//
// What bounds it on the H100: about 42 MFLOP per pair at N=128, C=64 (a
// 128 x 128 grid is ~0.69 TFLOP), on the float32 CUDA cores. Stage 2 needs
// each direction's whole template side for its k^T v summary, so both
// stage-1 outputs (2 x N x C floats, 64 KB at N=128, C=64) stay in shared
// memory for the life of the block; everything row-local (merge, LN, the
// 2C-wide FFN) streams through R=64-row scratch tiles. The stage weights
// (about 300 KB together) do not fit beside them, so each product first
// copies its own weight matrix (16-32 KB) into a shared buffer and every
// row group of the tile reads it there, not through L1/L2 (measured on the
// H100: 15 % faster than reading the weights through the read-only cache).
// A thread owns a 4-row x 2-column register tile. Nothing per pair touches
// device memory except the 2C pooled outputs. Shared memory at N=128,
// C=64, R=64: ~225 KB (dynamic, above the 48 KB default): one 512-thread block
// per SM. The message contractions of both stages are products with a
// [KV | Z] matrix (block-diagonal per head, zeros included), so they run on
// the same register-tiled product as the projections and the FFN.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int R_POINT = 64;   // rows per streamed tile, point head (N=128)
constexpr int R_IMAGE = 32;   // the same for the image head (S=198 fits)
constexpr size_t SMEM_LIMIT = 227 * 1024;   // dynamic shared memory a block may take
constexpr int TR = 4;         // rows per thread in a dense product
constexpr int TC = 2;         // columns per thread in a dense product
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;

struct Side {         // per-object factors of one side, image head
  const float* h;     // (n, N, C)
  const float* q;     // (n, N, C)   elu+1 stage-1 queries
  const float* kvz;   // (n, C, 2C)  [KV | diag(ksum) @ head mask]
  const float* a1;    // (n, N, 2C)  h @ stage1.fc1[:C]
};

struct SidePos : Side {   // point head: the same plus the position term
  const float* pv;    // (n, N, C)   stage-2 pos-MLP @ v_proj
};

template <bool POS> struct SideOf { using type = Side; };
template <> struct SideOf<true> { using type = SidePos; };

struct Tail {         // merge -> LN -> FFN -> LN weights of one stage
  const float* merge; const float* ln1s; const float* ln1b;
  const float* fc1; const float* fc2; const float* ln2s; const float* ln2b;
};

struct Weights {
  Tail s1, s2;
  const float* q2;    // (C, C)
  const float* kv2;   // (C, 2C) = [Wk | Wv]
};

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r][co] (+)= sum_ci in[r][ci] * W[ci][co], r < rows, co < Cout.
// A W in device memory is first staged into the shared buffer at the start
// of the layout (SMEM_W: W is in shared memory already). Each thread owns a
// TR x TC register tile. Per four input channels it reads TR float4
// activations (warp broadcasts: consecutive threads take consecutive column
// pairs of the same rows, for Cout >= 64) and four float2 weights, which
// feed 4*TR*TC FMAs. Cin, Cout and the leading dimensions are multiples of
// 4. Called by the whole block (it synchronises).
template <bool ACC, bool SMEM_W = false>
__device__ void dense(const float* in, int ldi, int Cin,
                      const float* __restrict__ W, int ldw, int Cout,
                      float* out, int ldo, int rows) {
  extern __shared__ __align__(16) float smem[];
  if (!SMEM_W) {   // stage W (Cin x Cout <= C x 2C) into shared memory
    float* Wsm = smem;   // the first 2C*C floats of the kernel's layout
    __syncthreads();
    for (int e = 4 * threadIdx.x; e < Cin * Cout; e += 4 * blockDim.x) {
      const int ci = e / Cout, co = e - ci * Cout;
      *reinterpret_cast<float4*>(Wsm + e) =
          __ldg(reinterpret_cast<const float4*>(W + (size_t)ci * ldw + co));
    }
    __syncthreads();
    W = Wsm;
    ldw = Cout;
  }
  const int cgroups = Cout / TC;
  const int groups = ((rows + TR - 1) / TR) * cgroups;
  for (int e = threadIdx.x; e < groups; e += blockDim.x) {
    const int co = (e % cgroups) * TC, r0 = (e / cgroups) * TR;
    float acc[TR][TC];
#pragma unroll
    for (int q = 0; q < TR; ++q) { acc[q][0] = 0.f; acc[q][1] = 0.f; }
    for (int ci = 0; ci < Cin; ci += 4) {
      float a[TR][4];
#pragma unroll
      for (int q = 0; q < TR; ++q) {
        const float4 v = r0 + q < rows
            ? *reinterpret_cast<const float4*>(in + (r0 + q) * ldi + ci)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        a[q][0] = v.x; a[q][1] = v.y; a[q][2] = v.z; a[q][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2* wp = reinterpret_cast<const float2*>(W + (size_t)(ci + j) * ldw + co);
        const float2 w = *wp;
#pragma unroll
        for (int q = 0; q < TR; ++q) {
          acc[q][0] = fmaf(a[q][j], w.x, acc[q][0]);
          acc[q][1] = fmaf(a[q][j], w.y, acc[q][1]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < TR; ++q) {
      if (r0 + q < rows) {
        float* o = out + (r0 + q) * ldo + co;
        o[0] = ACC ? o[0] + acc[q][0] : acc[q][0];
        o[1] = ACC ? o[1] + acc[q][1] : acc[q][1];
      }
    }
  }
}

// LayerNorm over the C columns of each row, one warp per row, in place.
__device__ void layer_norm_rows(float* x, int C, int rows,
                                const float* __restrict__ s,
                                const float* __restrict__ b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  for (int r = warp; r < rows; r += nw) {
    float* row = x + r * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += row[c];
    const float mu = warp_sum(sum) / C;
    float var = 0.f;
    for (int c = lane; c < C; c += 32) { const float d = row[c] - mu; var += d * d; }
    const float inv = rsqrtf(warp_sum(var) / C + LN_EPS);
    for (int c = lane; c < C; c += 32) row[c] = (row[c] - mu) * inv * __ldg(s + c) + __ldg(b + c);
  }
}

struct Scratch { float *X, *M, *Hd, *Y, *Q; };

// Y = search + LN2(relu(a + LN1(X @ merge) @ fc1[C:]) @ fc2) for `rows` rows,
// where a = a1 (precomputed) or search @ fc1[:C] when a1 is null.
__device__ void ffn_tail(const float* search, const float* a1, const Tail& w,
                         const Scratch& s, int rows, int C) {
  const int C2 = 2 * C;
  dense<false>(s.X, C, C, w.merge, C, C, s.M, C, rows);
  __syncthreads();
  layer_norm_rows(s.M, C, rows, w.ln1s, w.ln1b);
  __syncthreads();
  dense<false>(s.M, C, C, w.fc1 + (size_t)C * C2, C2, C2, s.Hd, C2, rows);
  if (a1 == nullptr)   // same thread -> element mapping: no barrier needed
    dense<true>(search, C, C, w.fc1, C2, C2, s.Hd, C2, rows);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * C2; e += blockDim.x) {
    const float v = s.Hd[e] + (a1 ? __ldg(a1 + e) : 0.f);
    s.Hd[e] = fmaxf(v, 0.f);
  }
  __syncthreads();
  dense<false>(s.Hd, C2, C2, w.fc2, C, C, s.Y, C, rows);
  __syncthreads();
  layer_norm_rows(s.Y, C, rows, w.ln2s, w.ln2b);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) s.Y[e] += search[e];
  __syncthreads();
}

// [message | normalizer] -> X = message / (normalizer + eps), in place of
// the (rows, 2C) product in s.Hd.
__device__ void split_norm(const Scratch& s, int rows, int C) {
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
    const int r = e / C, c = e - r * C;
    s.X[e] = s.Hd[r * 2 * C + c] / (s.Hd[r * 2 * C + C + c] + EPS);
  }
}

// Stage 1, one direction: search side (h, q, a1) against the template's kvz.
// q @ [KV | Z] gives each head's message and its normalizer in one product
// (KV is block-diagonal per head, Z = diag(ksum) @ head mask).
template <int R>
__device__ void stage1(const float* hS, const float* qS, const float* aS,
                       const float* __restrict__ kvzT, const Tail& w,
                       float* O, const Scratch& s, int N, int C) {
  for (int n0 = 0; n0 < N; n0 += R) {
    const int rows = min(R, N - n0);
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x)
      s.Q[e] = __ldg(qS + (size_t)n0 * C + e);
    __syncthreads();
    dense<false>(s.Q, C, C, kvzT, 2 * C, 2 * C, s.Hd, 2 * C, rows);
    __syncthreads();
    split_norm(s, rows, C);
    __syncthreads();
    ffn_tail(hS + (size_t)n0 * C, aS + (size_t)n0 * 2 * C, w, s, rows, C);
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x) O[n0 * C + e] = s.Y[e];
    __syncthreads();
  }
}

// Stage 2, one direction: full cross linear attention of search rows OS
// against template rows OT (both in shared memory), pooled into mx / sm.
// The template side is summarised into KVZ = [KV | Z] ([C][2C], shared),
// KV[c'][c] = sum_n k[n][c'] v[n][c] within a head, Z[c'][c] = sum_n k[n][c']
// within a head, so that the search side is one product as in stage 1.
// pvT is the template side's position term (POS) or unused (null).
template <int R, bool POS>
__device__ void stage2(const float* OS, const float* OT,
                       const float* __restrict__ pvT, const Weights& w,
                       float* KVZ, float* KS, float* mx, float* sm,
                       const Scratch& s, int N, int C, int D) {
  const int C2 = 2 * C;
  for (int e = threadIdx.x; e < C * C2; e += blockDim.x) KVZ[e] = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) KS[c] = 0.f;
  __syncthreads();
  for (int n0 = 0; n0 < N; n0 += R) {
    const int rows = min(R, N - n0);
    dense<false>(OT + n0 * C, C, C, w.kv2, C2, C2, s.Hd, C2, rows);
    __syncthreads();
    if constexpr (POS) {
      for (int e = threadIdx.x; e < rows * C2; e += blockDim.x) {
        const int r = e / C2, j = e - r * C2;
        s.Hd[e] = j < C ? elu1(s.Hd[e])
                        : s.Hd[e] + __ldg(pvT + (size_t)(n0 + r) * C + (j - C));
      }
    } else {            // k = elu1(.), v as it is
      for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
        const int r = e / C, j = e - r * C;
        s.Hd[r * C2 + j] = elu1(s.Hd[r * C2 + j]);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < C * D; e += blockDim.x) {
      const int kc = e / D, vc = (kc / D) * D + (e - kc * D);
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc = fmaf(s.Hd[r * C2 + kc], s.Hd[r * C2 + C + vc], acc);
      KVZ[kc * C2 + vc] += acc;
    }
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) acc += s.Hd[r * C2 + c];
      KS[c] += acc;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < C * D; e += blockDim.x) {
    const int kc = e / D, zc = (kc / D) * D + (e - kc * D);
    KVZ[kc * C2 + C + zc] = KS[kc];
  }
  __syncthreads();
  for (int n0 = 0; n0 < N; n0 += R) {
    const int rows = min(R, N - n0);
    dense<false>(OS + n0 * C, C, C, w.q2, C, C, s.Q, C, rows);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x) s.Q[e] = elu1(s.Q[e]);
    __syncthreads();
    dense<false, true>(s.Q, C, C, KVZ, C2, C2, s.Hd, C2, rows);
    __syncthreads();
    split_norm(s, rows, C);
    __syncthreads();
    ffn_tail(OS + n0 * C, nullptr, w.s2, s, rows, C);
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float m = mx[c], a = sm[c];
      for (int r = 0; r < rows; ++r) {
        const float v = s.Y[r * C + c];
        m = fmaxf(m, v);
        a += v;
      }
      mx[c] = m;
      sm[c] = a;
    }
    __syncthreads();
  }
}

inline size_t smem_floats(int N, int C, int R) {
  return (size_t)2 * N * C + (size_t)2 * C * C + 3 * (size_t)C + (size_t)6 * R * C
         + (size_t)2 * C * C;   // staged weights, up to C x 2C
}

template <int R, bool POS>
__global__ void __launch_bounds__(THREADS)
match_pooled_kernel(typename SideOf<POS>::type T, typename SideOf<POS>::type Dt,
                    Weights w, const int* __restrict__ t_idx,
                    const int* __restrict__ d_idx, float* __restrict__ out,
                    int nt, int nd, int N, int C, int H) {
  extern __shared__ __align__(16) float smem[];
  const int D = C / H;
  float* O1 = smem + 2 * C * C;        // [N][C] stage-1 output, track side (after staged weights)
  float* O2 = O1 + N * C;              // [N][C] stage-1 output, det side
  float* KVZ = O2 + N * C;             // [C][2C] stage-2 [KV | Z]
  float* KS = KVZ + 2 * C * C;         // [C]
  float* mx = KS + C;                  // [C]
  float* sm = mx + C;                  // [C]
  Scratch s;
  s.X = sm + C;                        // [R][C]
  s.M = s.X + R * C;                   // [R][C]
  s.Hd = s.M + R * C;                  // [R][2C]
  s.Y = s.Hd + 2 * R * C;              // [R][C]
  s.Q = s.Y + R * C;                   // [R][C]

  const int p = blockIdx.x;
  int ti, dj;
  if (t_idx != nullptr) {              // pair list, range-checked by the wrapper;
                                       // the clamp only bounds the reads
    ti = min(max(t_idx[p], 0), nt - 1);
    dj = min(max(d_idx[p], 0), nd - 1);
  } else {
    ti = p / nd;
    dj = p - ti * nd;
  }
  const size_t nc = (size_t)N * C;
  const float* ht = T.h + ti * nc;
  const float* qt = T.q + ti * nc;
  const float* kvzt = T.kvz + (size_t)ti * 2 * C * C;
  const float* at = T.a1 + ti * 2 * nc;
  const float* hd = Dt.h + dj * nc;
  const float* qd = Dt.q + dj * nc;
  const float* kvzd = Dt.kvz + (size_t)dj * 2 * C * C;
  const float* ad = Dt.a1 + dj * 2 * nc;
  const float* pvt = nullptr;
  const float* pvd = nullptr;
  if constexpr (POS) {
    pvt = T.pv + ti * nc;
    pvd = Dt.pv + dj * nc;
  }

  stage1<R>(ht, qt, at, kvzd, w.s1, O1, s, N, C);   // track -> det
  stage1<R>(hd, qd, ad, kvzt, w.s1, O2, s, N, C);   // det -> track
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    mx[c] = -__int_as_float(0x7f800000);  // -inf
    sm[c] = 0.f;
  }
  __syncthreads();
  stage2<R, POS>(O1, O2, pvd, w, KVZ, KS, mx, sm, s, N, C, D);
  stage2<R, POS>(O2, O1, pvt, w, KVZ, KS, mx, sm, s, N, C, D);

  float* o = out + (size_t)p * 2 * C;
  const float inv = 1.f / (2.f * N);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    o[c] = mx[c];
    o[C + c] = sm[c] * inv;
  }
}

Weights make_weights(const void* const* p) {
  auto tail = [](const void* const* q) {
    return Tail{(const float*)q[0], (const float*)q[1], (const float*)q[2],
                (const float*)q[3], (const float*)q[4], (const float*)q[5],
                (const float*)q[6]};
  };
  Weights w;
  w.s1 = tail(p);
  w.q2 = (const float*)p[7];
  w.kv2 = (const float*)p[8];
  w.s2 = tail(p + 9);
  return w;
}

// Refuses (cudaErrorInvalidValue) a shape whose layout does not fit the
// block's shared memory; the wrapper raises.
template <int R, bool POS>
int launch(typename SideOf<POS>::type T, typename SideOf<POS>::type Dt,
           const Weights& w, const void* t_idx, const void* d_idx, void* out,
           int nt, int nd, int P, int N, int C, int H, void* stream) {
  if (H <= 0 || C % H != 0 || C % 4 != 0 || P <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, C, R) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      match_pooled_kernel<R, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  match_pooled_kernel<R, POS><<<P, THREADS, smem, (cudaStream_t)stream>>>(
      T, Dt, w, (const int*)t_idx, (const int*)d_idx, (float*)out, nt, nd, N, C, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Point head: 5 factors a side (h, q, kvz, a1, pv), then the 16 weights in
// the order s1 {merge, ln1s, ln1b, fc1, fc2, ln2s, ln2b}, q2, kv2, s2 {...}.
extern "C" int pcr_match_pooled(
    const void* ht, const void* qt, const void* kvzt, const void* at, const void* pvt,
    const void* hd, const void* qd, const void* kvzd, const void* ad, const void* pvd,
    const void* merge1, const void* ln1s1, const void* ln1b1, const void* fc1_1,
    const void* fc2_1, const void* ln2s1, const void* ln2b1, const void* q2,
    const void* kv2, const void* merge2, const void* ln1s2, const void* ln1b2,
    const void* fc1_2, const void* fc2_2, const void* ln2s2, const void* ln2b2,
    const void* t_idx, const void* d_idx, void* out,
    int nt, int nd, int P, int N, int C, int H, void* stream) {
  SidePos T, Dt;
  T.h = (const float*)ht; T.q = (const float*)qt; T.kvz = (const float*)kvzt;
  T.a1 = (const float*)at; T.pv = (const float*)pvt;
  Dt.h = (const float*)hd; Dt.q = (const float*)qd; Dt.kvz = (const float*)kvzd;
  Dt.a1 = (const float*)ad; Dt.pv = (const float*)pvd;
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  return launch<R_POINT, true>(T, Dt, make_weights(ws), t_idx, d_idx, out,
                               nt, nd, P, N, C, H, stream);
}

// Image head: 4 factors a side (h, q, kvz, a1), no position term; N is the
// true token count S. The same weights in the same order.
extern "C" int pcr_match_pooled_image(
    const void* ht, const void* qt, const void* kvzt, const void* at,
    const void* hd, const void* qd, const void* kvzd, const void* ad,
    const void* merge1, const void* ln1s1, const void* ln1b1, const void* fc1_1,
    const void* fc2_1, const void* ln2s1, const void* ln2b1, const void* q2,
    const void* kv2, const void* merge2, const void* ln1s2, const void* ln1b2,
    const void* fc1_2, const void* fc2_2, const void* ln2s2, const void* ln2b2,
    const void* t_idx, const void* d_idx, void* out,
    int nt, int nd, int P, int N, int C, int H, void* stream) {
  Side T, Dt;
  T.h = (const float*)ht; T.q = (const float*)qt; T.kvz = (const float*)kvzt;
  T.a1 = (const float*)at;
  Dt.h = (const float*)hd; Dt.q = (const float*)qd; Dt.kvz = (const float*)kvzd;
  Dt.a1 = (const float*)ad;
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  return launch<R_IMAGE, false>(T, Dt, make_weights(ws), t_idx, d_idx, out,
                                nt, nd, P, N, C, H, stream);
}
