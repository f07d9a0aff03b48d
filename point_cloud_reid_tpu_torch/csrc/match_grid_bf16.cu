// Fused per-pair match chain at bf16, grid or pair list, on Hopper's bf16
// tensor cores: the cluster tier of the match chain for a bf16 model.
//
// Replaces the bf16 instances of the TPU kernels
// point_cloud_reid_tpu/ops/pallas/match_grid.py fused_match_grid,
// fused_match_pairs and the image head's pallas_image_grid_logits /
// pallas_image_pair_logits (_kernel under a bf16 model). There the per-object
// factors (h, q, kvz, a1, pv) and the pooled output are bf16, the weights
// float32, and every product casts both operands to bf16 and accumulates in
// float32 (_make_dot, bdot); the rest of the chain is float32. This kernel
// rounds at the same places and nowhere else:
//
//   stage 1, both directions (from the hoisted per-object factors):
//     mz  = q @ bf16([KV | Z] of the other object)          float32
//     msg = mz[:C] / (mz[C:] + eps)
//     o_a = h + LN2(relu(a1 + LN1(bf16(msg) @ bf16(merge)) @ bf16(fc1[C:]))
//                    @ bf16(fc2))                           float32
//   stage 2, both directions (full cross linear attention):
//     q = elu1(bf16(o_search) @ bf16(Wq)); [k | v] = bf16(o_templ) @ bf16(Wkv)
//     k = elu1(k); v = v + pv
//     KV = (bf16(k)^T @ bf16(v)) * head mask; ksum = sum k (float32)
//     msg = (bf16(q) @ bf16(KV)) / (bf16(q * ksum) @ head mask + eps)
//     then the stage-1 tail with fc1[:C] applied to bf16(o_search)
//   point-cat pooling: max and mean over the 2N rows, out in bf16.
//
// Design: the float32 kernel's (csrc/match_grid.cu): a cluster of two blocks
// a pair, block 0 the track side and block 1 the det side; each computes its
// side's stage-1 output O (float32, in its shared memory), summarises it as
// the template of the other block's stage-2 direction and writes [KV | ksum]
// into the peer's shared memory, then runs its own stage-2 rows and pools
// them; block 1 sends its pooled max and sum to block 0. Grid and pair mode
// run the same per-pair code, so a pair's result is its grid cell's bit for
// bit. Without POS (the image head) there is no position term and N is the
// true token count.
// What changes at bf16: every product is one mma.sync m16n8k16 bf16 pass.
// The m16n8k16 A fragment of a 16-column k-step is exactly the accumulator
// fragment of two 8-column n-tiles, so one product's output becomes the next
// one's operand by packing register pairs (no shuffles). Every B operand is
// stored in shared memory as (n, k) rows of bf16 (the weights' own (out,
// in) layout, which the wrapper hands over once converted), padded by 8, so
// that a fragment is two 32-bit loads free of bank conflicts. The k | v rows
// of the summary are stored transposed (channel-major) for the same reason.
// The stage-2 normaliser's head mask is generated in registers.
//
// Layout, bytes per block, C = 64, Np = N rounded up to 16:
//   Wq (C x (C + 8) bf16)                         9,216
//   then one of: stage 1's [KV | Z], merge, fc1[C:], fc2  63,488
//                the kv projection and the 128-row k | v chunk  53,248
//                stage 2's merge, fc1, fc2          61,440
//   own O (Np x (C + 8) float32)                  36,864 at N = 128
//   the peer's KV (C x (C + 8) bf16) and ksum      9,472
//   pooling (8 warps x 2C + 2C float32)            4,608
// 123,648 bytes at N = 128, 146,688 at S = 197 / 198: N up to 496 fits at
// C = 64. C = 128 does not fit a block (the float32 kernel's rows tier,
// csrc/match_rows.cu, has no bf16 form yet).
//
// What bounds it on the H100: 80 N C^2 operations a pair in one bf16 pass at
// 989 TFLOP/s (0.69 ms for the 128 x 128 grid at N = 128, C = 64).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 128;                  // rows of the k|v summary chunk
constexpr size_t SMEM_LIMIT = 232448;       // dynamic shared memory a block may take
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;

struct Side {         // per-object factors of one side, bf16
  const bf16* h;      // (n, N, C)
  const bf16* q;      // (n, N, C)   elu+1 stage-1 queries
  const bf16* kvz;    // (n, 2C, C)  [KV | diag(ksum) @ head mask], transposed
  const bf16* a1;     // (n, N, 2C)  h @ stage1.fc1[:C]
  const bf16* pv;     // (n, N, C)   stage-2 pos-MLP @ v_proj (point head), or null
};

struct Tail {         // merge -> LN -> FFN -> LN weights of one stage
  const bf16* merge;  // (C, C)   (out, in)
  const float* ln1s; const float* ln1b;
  const bf16* fc1;    // (2C, 2C)
  const bf16* fc2;    // (C, 2C)
  const float* ln2s; const float* ln2b;
};

struct Weights {
  Tail s1, s2;
  const bf16* q2;     // (C, C)
  const bf16* kv2;    // (2C, C) = [Wk | Wv] in (out, in) layout
};

// Shared-memory layout for channel count C, in bf16 elements (weights) and
// bytes (the regions). A B operand of k-extent K is stored as (n, K + 8).
template <int C> struct Layout {
  static constexpr int LD1 = C + 8, LD2 = 2 * C + 8, LDK = CHUNK + 8;
  static constexpr int Q2 = 0, REST = C * LD1;          // Wq, then one phase's
  // stage 1
  static constexpr int KVZ1 = REST, MERGE1 = KVZ1 + 2 * C * LD1,
                       FC1B1 = MERGE1 + C * LD1, FC2_1 = FC1B1 + 2 * C * LD1,
                       END1 = FC2_1 + C * LD2;
  // the summary
  static constexpr int KV2 = REST, CHUNKT = KV2 + 2 * C * LD1,
                       END_S = CHUNKT + 2 * C * LDK;
  // stage 2
  static constexpr int MERGE2 = REST, FC1_2 = MERGE2 + C * LD1,
                       FC2_2 = FC1_2 + 2 * C * LD2, END2 = FC2_2 + C * LD2;
  static constexpr int WELEMS = END1 > END_S ? (END1 > END2 ? END1 : END2)
                                             : (END_S > END2 ? END_S : END2);
  static constexpr size_t W_BYTES = (size_t)WELEMS * 2;
  static constexpr size_t KV_BYTES = (size_t)C * LD1 * 2;
  static constexpr size_t TAIL_BYTES = (size_t)(C + WARPS * 2 * C + 2 * C) * 4;
  static size_t bytes(int N) {
    const int Np = (N + 15) / 16 * 16;
    return W_BYTES + (size_t)Np * LD1 * 4 + KV_BYTES + TAIL_BYTES;
  }
};

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += A (16 x 16 NK) @ B (16 NK x 8 NN) for one warp. B is stored in
// shared memory as (n, k) rows of leading dimension ld, from column kofs;
// getA(kk, a) fills the bf16 A fragment of k-step kk: a[0] (row g, cols 2t,
// 2t + 1), a[1] (g + 8, 2t..), a[2] (g, 2t + 8..), a[3] (g + 8, 2t + 8..),
// g = lane / 4, t = lane % 4 (PTX m16n8k16 .bf16).
template <int NK, int NN, class GetA>
__device__ __forceinline__ void warp_gemm(float (&acc)[NN][4], GetA getA, const bf16* B,
                                          int ld, int kofs, int ncol0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t a[4];
    getA(kk, a);
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const bf16* b = B + (ncol0 + j * 8 + g) * ld + kofs + kk * 16 + 2 * t;
      mma_bf16(acc[j], a, ld32(b), ld32(b + 8));
    }
  }
}

template <int NN>
__device__ __forceinline__ void zero(float (&acc)[NN][4]) {
#pragma unroll
  for (int j = 0; j < NN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// The A fragment of k-step kk from a warp's accumulator (16 rows x 8 NN
// columns in n-tiles of 8): n-tiles 2 kk and 2 kk + 1, rounded to bf16.
template <int NN>
__device__ __forceinline__ void a_from_acc(const float (&acc)[NN][4], int kk,
                                           uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// LayerNorm of the 16 rows of a C-wide accumulator, in registers: a row's
// columns lie in one quad, so two xor-shuffles finish each sum.
template <int NT>
__device__ __forceinline__ void layer_norm_acc(float (&acc)[NT][4],
                                               const float* __restrict__ s,
                                               const float* __restrict__ b) {
  constexpr float invC = 1.f / (8 * NT);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {   // rows g and g + 8
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) sum += acc[j][2 * half] + acc[j][2 * half + 1];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mu = sum * invC;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float d0 = acc[j][2 * half] - mu, d1 = acc[j][2 * half + 1] - mu;
      var += d0 * d0 + d1 * d1;
    }
    var += __shfl_xor_sync(0xffffffffu, var, 1);
    var += __shfl_xor_sync(0xffffffffu, var, 2);
    const float inv = rsqrtf(var * invC + LN_EPS);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(s + c));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(b + c));
      acc[j][2 * half] = (acc[j][2 * half] - mu) * inv * sc.x + bi.x;
      acc[j][2 * half + 1] = (acc[j][2 * half + 1] - mu) * inv * sc.y + bi.y;
    }
  }
}

// ---- staging ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy `rows` x `cols` bf16 (leading dimension lds in device memory) to rows
// of leading dimension ldd in shared memory, 16 bytes a copy, whole block.
__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* __restrict__ src,
                                      int rows, int cols, int lds) {
  const int per = cols / 8;
  for (int e = threadIdx.x; e < rows * per; e += THREADS) {
    const int r = e / per, c = (e - r * per) * 8;
    cp_async16(dst + r * ldd + c, src + (size_t)r * lds + c);
  }
}

// ---- one warp's 16-row slab -------------------------------------------------------

// y = LN2(relu(hid + LN1(msg @ merge) @ fc1[kofs:kofs + C]) @ fc2) for a
// slab, where hid arrives holding the search half of the FFN's first layer.
template <int C>
__device__ __forceinline__ void ffn_tail(const float (&msg)[C / 8][4],
                                         float (&hid)[C / 4][4], const Tail& w,
                                         const bf16* merge, const bf16* fc1, int ld_fc1,
                                         int kofs, const bf16* fc2, float (&y)[C / 8][4]) {
  constexpr int NT = C / 8, KS = C / 16;
  float m[NT][4];
  zero(m);
  warp_gemm<KS, NT>(m, [&](int kk, uint32_t (&a)[4]) { a_from_acc(msg, kk, a); },
                    merge, C + 8, 0, 0);
  layer_norm_acc(m, w.ln1s, w.ln1b);
  warp_gemm<KS, 2 * NT>(hid, [&](int kk, uint32_t (&a)[4]) { a_from_acc(m, kk, a); },
                        fc1, ld_fc1, kofs, 0);
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) hid[j][i] = fmaxf(hid[j][i], 0.f);
  zero(y);
  warp_gemm<2 * KS, NT>(y, [&](int kk, uint32_t (&a)[4]) { a_from_acc(hid, kk, a); },
                        fc2, 2 * C + 8, 0, 0);
  layer_norm_acc(y, w.ln2s, w.ln2b);
}

// A fragment from float32 rows in shared memory (leading dimension ld),
// rows g and g + 8 of the slab at p, rounded to bf16.
struct RowsA {
  const float* p; int ld;
  __device__ __forceinline__ void operator()(int kk, uint32_t (&a)[4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* r = p + g * ld + kk * 16 + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(r);
    const float2 x1 = *reinterpret_cast<const float2*>(r + 8 * ld);
    const float2 x2 = *reinterpret_cast<const float2*>(r + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(r + 8 * ld + 8);
    a[0] = pack_bf16(x0.x, x0.y);
    a[1] = pack_bf16(x1.x, x1.y);
    a[2] = pack_bf16(x2.x, x2.y);
    a[3] = pack_bf16(x3.x, x3.y);
  }
};

// ---- the kernel ---------------------------------------------------------------------

template <int C, bool POS>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
match_pooled_bf16_kernel(Side T, Side Dt, Weights w, const int* __restrict__ t_idx,
                         const int* __restrict__ d_idx, bf16* __restrict__ out,
                         int nt, int nd, int N, int H) {
  using L = Layout<C>;
  constexpr int NT = C / 8, KS = C / 16;
  constexpr int LD1 = L::LD1, LD2 = L::LD2, LDK = L::LDK, LDO = C + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Np = (N + 15) / 16 * 16;
  const int slabs = Np / 16;
  const int D = C / H;

  bf16* Wr = reinterpret_cast<bf16*>(smem);                          // weights
  float* O = reinterpret_cast<float*>(smem + L::W_BYTES);            // [Np][C + 8]
  bf16* KVT = reinterpret_cast<bf16*>(O + Np * LDO);                 // [C][C + 8] peer's KV^T
  float* ksp = reinterpret_cast<float*>(smem + L::W_BYTES + (size_t)Np * LDO * 4 + L::KV_BYTES);
  float* part = ksp + C;                                             // [WARPS][2C]
  float* pool = part + WARPS * 2 * C;                                // [2C] the peer's max | sum
  bf16* chunk = Wr + L::CHUNKT;                                      // [2C][CHUNK + 8] k | v, transposed

  const int p = blockIdx.x >> 1;
  int ti, dj;
  if (t_idx != nullptr) {              // pair list, range-checked by the wrapper;
                                       // the clamp only bounds the reads
    ti = min(max(t_idx[p], 0), nt - 1);
    dj = min(max(d_idx[p], 0), nd - 1);
  } else {
    ti = p / nd;
    dj = p - ti * nd;
  }
  // own side X (block 0: the track, block 1: the det) and the other side Y
  const Side X = rank == 0 ? T : Dt;
  const int xi = rank == 0 ? ti : dj, yi = rank == 0 ? dj : ti;
  const size_t nc = (size_t)N * C;
  const bf16* hX = X.h + xi * nc;
  const bf16* qX = X.q + xi * nc;
  const bf16* aX = X.a1 + xi * 2 * nc;
  const bf16* kvzY = (rank == 0 ? Dt.kvz : T.kvz) + (size_t)yi * 2 * C * C;

  // stage 1's weights and Wq
  stage(Wr + L::Q2, LD1, w.q2, C, C, C);
  stage(Wr + L::KVZ1, LD1, kvzY, 2 * C, C, C);
  stage(Wr + L::MERGE1, LD1, w.s1.merge, C, C, C);
  stage(Wr + L::FC1B1, LD1, w.s1.fc1 + C, 2 * C, C, 2 * C);
  stage(Wr + L::FC2_1, LD2, w.s1.fc2, C, 2 * C, 2 * C);
  cp_commit();
  // the peer must have started before its shared memory is written
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cp_wait<0>();
  __syncthreads();

  // ---- stage 1: O = h + LN2(relu(a1 + LN1(split_norm(q @ kvzY) @ merge) @ fc1[C:]) @ fc2)
  for (int s = warp; s < slabs; s += WARPS) {
    const int r0 = s * 16 + g, r1 = r0 + 8;
    const bool v0 = r0 < N, v1 = r1 < N;
    float mz[2 * NT][4];
    zero(mz);
    warp_gemm<KS, 2 * NT>(mz, [&](int kk, uint32_t (&a)[4]) {
      const int c = kk * 16 + 2 * t;
      a[0] = v0 ? ldg32(qX + (size_t)r0 * C + c) : 0u;
      a[1] = v1 ? ldg32(qX + (size_t)r1 * C + c) : 0u;
      a[2] = v0 ? ldg32(qX + (size_t)r0 * C + c + 8) : 0u;
      a[3] = v1 ? ldg32(qX + (size_t)r1 * C + c + 8) : 0u;
    }, Wr + L::KVZ1, LD1, 0, 0);
    float msg[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) msg[j][i] = mz[j][i] / (mz[NT + j][i] + EPS);
    float hid[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 x0 = v0 ? unpack_bf16(ldg32(aX + (size_t)r0 * 2 * C + c))
                           : make_float2(0.f, 0.f);
      const float2 x1 = v1 ? unpack_bf16(ldg32(aX + (size_t)r1 * 2 * C + c))
                           : make_float2(0.f, 0.f);
      hid[j][0] = x0.x; hid[j][1] = x0.y; hid[j][2] = x1.x; hid[j][3] = x1.y;
    }
    float y[NT][4];
    ffn_tail<C>(msg, hid, w.s1, Wr + L::MERGE1, Wr + L::FC1B1, LD1, 0, Wr + L::FC2_1, y);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;
      float2 o0 = make_float2(0.f, 0.f), o1 = make_float2(0.f, 0.f);
      if (v0) {
        const float2 h = unpack_bf16(ldg32(hX + (size_t)r0 * C + c));
        o0 = make_float2(h.x + y[j][0], h.y + y[j][1]);
      }
      if (v1) {
        const float2 h = unpack_bf16(ldg32(hX + (size_t)r1 * C + c));
        o1 = make_float2(h.x + y[j][2], h.y + y[j][3]);
      }
      *reinterpret_cast<float2*>(O + r0 * LDO + c) = o0;
      *reinterpret_cast<float2*>(O + r1 * LDO + c) = o1;
    }
  }
  __syncthreads();                             // O complete, stage-1 weights free
  stage(Wr + L::KV2, LD1, w.kv2, 2 * C, C, C);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // ---- the template summary of the peer's direction: k = elu1(O Wk),
  // v = O Wv + pv, KV = bf16(k)^T bf16(v) and ksum, in chunks of 128 rows
  constexpr int MT = C / 16;                   // 16-row tiles of KV's C rows
  constexpr int TPW = (MT * NT + WARPS - 1) / WARPS;
  const bf16* pvX = POS ? X.pv + xi * nc : nullptr;
  float kv[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i) kv[i][0] = kv[i][1] = kv[i][2] = kv[i][3] = 0.f;
  float kp[NT][2];                             // this thread's part of sum k
#pragma unroll
  for (int j = 0; j < NT; ++j) kp[j][0] = kp[j][1] = 0.f;
  for (int cb = 0; cb < Np; cb += CHUNK) {
    const int s = cb / 16 + warp;
    if (s < slabs) {
      const int r0 = s * 16 + g, r1 = r0 + 8;
      const bool v0 = r0 < N, v1 = r1 < N;
      float kvr[2 * NT][4];
      zero(kvr);
      warp_gemm<KS, 2 * NT>(kvr, RowsA{O + s * 16 * LDO, LDO}, Wr + L::KV2, LD1, 0, 0);
      const int rr = warp * 16 + g;            // the slab's rows in the chunk
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        const int c = j * 8 + 2 * t;
        float2 e0, e1;
        if (j < NT) {
          e0 = make_float2(elu1(kvr[j][0]), elu1(kvr[j][1]));
          e1 = make_float2(elu1(kvr[j][2]), elu1(kvr[j][3]));
        } else {
          e0 = make_float2(kvr[j][0], kvr[j][1]);
          e1 = make_float2(kvr[j][2], kvr[j][3]);
          if constexpr (POS) {
            const int cv = c - C;
            if (v0) {
              const float2 q = unpack_bf16(ldg32(pvX + (size_t)r0 * C + cv));
              e0.x += q.x; e0.y += q.y;
            }
            if (v1) {
              const float2 q = unpack_bf16(ldg32(pvX + (size_t)r1 * C + cv));
              e1.x += q.x; e1.y += q.y;
            }
          }
        }
        if (!v0) e0 = make_float2(0.f, 0.f);   // rows past N add nothing
        if (!v1) e1 = make_float2(0.f, 0.f);
        if (j < NT) {
          kp[j][0] += e0.x + e1.x;
          kp[j][1] += e0.y + e1.y;
        }
        chunk[c * LDK + rr] = __float2bfloat16_rn(e0.x);
        chunk[(c + 1) * LDK + rr] = __float2bfloat16_rn(e0.y);
        chunk[c * LDK + rr + 8] = __float2bfloat16_rn(e1.x);
        chunk[(c + 1) * LDK + rr + 8] = __float2bfloat16_rn(e1.y);
      }
    }
    __syncthreads();
    // KV tiles of this warp: A (m, r) = k[r][m] = chunk[m][r], B (r, n) =
    // v[r][n] = chunk[C + n][r]
    const int rows = min(CHUNK, Np - cb);
    for (int k0 = 0; k0 < rows; k0 += 16) {
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int tau = warp + WARPS * i;
        if (tau < MT * NT) {
          const int mi = tau / NT, nj = tau - mi * NT;
          const bf16* ka = chunk + (mi * 16 + g) * LDK + k0 + 2 * t;
          const bf16* vb = chunk + (C + nj * 8 + g) * LDK + k0 + 2 * t;
          const uint32_t a[4] = {ld32(ka), ld32(ka + 8 * LDK), ld32(ka + 8),
                                 ld32(ka + 8 * LDK + 8)};
          mma_bf16(kv[i], a, ld32(vb), ld32(vb + 8));
        }
      }
    }
    __syncthreads();
  }
  // sum k: over the warp's row groups, then over the warps
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) kp[j][e] += __shfl_xor_sync(0xffffffffu, kp[j][e], o);
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      part[warp * C + j * 8 + 2 * t] = kp[j][0];
      part[warp * C + j * 8 + 2 * t + 1] = kp[j][1];
    }
  }
  __syncthreads();

  // KV^T (masked per head, rounded to bf16) and ksum into the peer's shared
  // memory
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  bf16* peer_kv = cluster.map_shared_rank(KVT, rank ^ 1);
  float* peer_ks = cluster.map_shared_rank(ksp, rank ^ 1);
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tau = warp + WARPS * i;
    if (tau < MT * NT) {
      const int mi = tau / NT, nj = tau - mi * NT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cr = mi * 16 + g + 8 * (e >> 1), cc = nj * 8 + 2 * t + (e & 1);
        peer_kv[cc * LD1 + cr] = __float2bfloat16_rn(cr / D == cc / D ? kv[i][e] : 0.f);
      }
    }
  }
  if (threadIdx.x < C) {
    float sum = 0.f;
    for (int v = 0; v < WARPS; ++v) sum += part[v * C + threadIdx.x];
    peer_ks[threadIdx.x] = sum;
  }
  __syncthreads();                             // part and the chunk are read
  // stage 2's tail weights, over the chunk and the kv projection
  stage(Wr + L::MERGE2, LD1, w.s2.merge, C, C, C);
  stage(Wr + L::FC1_2, LD2, w.s2.fc1, 2 * C, 2 * C, 2 * C);
  stage(Wr + L::FC2_2, LD2, w.s2.fc2, C, 2 * C, 2 * C);
  cp_commit();
  cluster.sync();                              // the peer's summary has landed
  cp_wait<0>();
  __syncthreads();

  // ---- stage 2: own O searches the peer's summary, then pooling
  float pm[NT][2], ps[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    pm[j][0] = pm[j][1] = -__int_as_float(0x7f800000);
    ps[j][0] = ps[j][1] = 0.f;
  }
  for (int s = warp; s < slabs; s += WARPS) {
    const int r0 = s * 16 + g, r1 = r0 + 8;
    const bool v0 = r0 < N, v1 = r1 < N;
    const RowsA rowsO{O + s * 16 * LDO, LDO};
    float q[NT][4];
    zero(q);
    warp_gemm<KS, NT>(q, rowsO, Wr + L::Q2, LD1, 0, 0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) q[j][i] = elu1(q[j][i]);
    float msg[NT][4];
    {
      float mm[NT][4], zz[NT][4];
      zero(mm);
      zero(zz);
      warp_gemm<KS, NT>(mm, [&](int kk, uint32_t (&a)[4]) { a_from_acc(q, kk, a); },
                        KVT, LD1, 0, 0);
      // the normaliser: bf16(q * ksum) @ head mask, the mask's B fragment
      // made in registers (1.0 in bf16 is 0x3f80)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
        const uint32_t a[4] = {
            pack_bf16(q[2 * kk][0] * ksp[c0], q[2 * kk][1] * ksp[c0 + 1]),
            pack_bf16(q[2 * kk][2] * ksp[c0], q[2 * kk][3] * ksp[c0 + 1]),
            pack_bf16(q[2 * kk + 1][0] * ksp[c1], q[2 * kk + 1][1] * ksp[c1 + 1]),
            pack_bf16(q[2 * kk + 1][2] * ksp[c1], q[2 * kk + 1][3] * ksp[c1 + 1])};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int hn = (j * 8 + g) / D;
          const uint32_t b0 = (c0 / D == hn ? 0x3f80u : 0u) | ((c0 + 1) / D == hn ? 0x3f800000u : 0u);
          const uint32_t b1 = (c1 / D == hn ? 0x3f80u : 0u) | ((c1 + 1) / D == hn ? 0x3f800000u : 0u);
          mma_bf16(zz[j], a, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) msg[j][i] = mm[j][i] / (zz[j][i] + EPS);
    }
    float hid[2 * NT][4];
    zero(hid);
    warp_gemm<KS, 2 * NT>(hid, rowsO, Wr + L::FC1_2, LD2, 0, 0);
    float y[NT][4];
    ffn_tail<C>(msg, hid, w.s2, Wr + L::MERGE2, Wr + L::FC1_2, LD2, C, Wr + L::FC2_2, y);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 o0 = *reinterpret_cast<const float2*>(O + r0 * LDO + c);
      const float2 o1 = *reinterpret_cast<const float2*>(O + r1 * LDO + c);
      const float a0 = o0.x + y[j][0], a1 = o0.y + y[j][1];
      const float b0 = o1.x + y[j][2], b1 = o1.y + y[j][3];
      const float ninf = -__int_as_float(0x7f800000);
      pm[j][0] = fmaxf(pm[j][0], fmaxf(v0 ? a0 : ninf, v1 ? b0 : ninf));
      pm[j][1] = fmaxf(pm[j][1], fmaxf(v0 ? a1 : ninf, v1 ? b1 : ninf));
      ps[j][0] += (v0 ? a0 : 0.f) + (v1 ? b0 : 0.f);
      ps[j][1] += (v0 ? a1 : 0.f) + (v1 ? b1 : 0.f);
    }
  }
  // reduce over the 8 row groups g of the warp, then over the warps
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        pm[j][e] = fmaxf(pm[j][e], __shfl_xor_sync(0xffffffffu, pm[j][e], o));
        ps[j][e] += __shfl_xor_sync(0xffffffffu, ps[j][e], o);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;
      part[warp * 2 * C + c] = pm[j][0];
      part[warp * 2 * C + c + 1] = pm[j][1];
      part[warp * 2 * C + C + c] = ps[j][0];
      part[warp * 2 * C + C + c + 1] = ps[j][1];
    }
  }
  __syncthreads();
  float mx = 0.f, sm = 0.f;
  if (threadIdx.x < C) {
    mx = part[threadIdx.x];
    sm = part[C + threadIdx.x];
    for (int v = 1; v < WARPS; ++v) {
      mx = fmaxf(mx, part[v * 2 * C + threadIdx.x]);
      sm += part[v * 2 * C + C + threadIdx.x];
    }
    if (rank == 1) {
      float* dst = cluster.map_shared_rank(pool, 0);
      dst[threadIdx.x] = mx;
      dst[C + threadIdx.x] = sm;
    }
  }
  cluster.sync();                              // the det side's pooling has landed
  if (rank == 0 && threadIdx.x < C) {
    bf16* o = out + (size_t)p * 2 * C;
    o[threadIdx.x] = __float2bfloat16_rn(fmaxf(mx, pool[threadIdx.x]));
    o[C + threadIdx.x] = __float2bfloat16_rn((sm + pool[C + threadIdx.x]) * (1.f / (2.f * N)));
  }
}

Weights make_weights(const void* const* p) {
  auto tail = [](const void* const* q) {
    return Tail{(const bf16*)q[0], (const float*)q[1], (const float*)q[2],
                (const bf16*)q[3], (const bf16*)q[4], (const float*)q[5],
                (const float*)q[6]};
  };
  Weights w;
  w.s1 = tail(p);
  w.q2 = (const bf16*)p[7];
  w.kv2 = (const bf16*)p[8];
  w.s2 = tail(p + 9);
  return w;
}

Side make_side(const void* h, const void* q, const void* kvz, const void* a1,
               const void* pv) {
  return Side{(const bf16*)h, (const bf16*)q, (const bf16*)kvz, (const bf16*)a1,
              (const bf16*)pv};
}

// Bytes of shared memory the layout takes for (N, C), or 0 when the kernel
// has no instantiation for C.
size_t smem_bytes(int N, int C) {
  switch (C) {
    case 16: return Layout<16>::bytes(N);
    case 64: return Layout<64>::bytes(N);
    default: return 0;
  }
}

// 0: the kernel takes the shape; 1: no instantiation for C (16, 64) or H
// does not divide C or N < 1; 2: the layout exceeds a block's shared memory.
int layout_status(int N, int C, int H) {
  if (N < 1 || H < 1 || C % H != 0 || smem_bytes(N, C) == 0) return 1;
  return smem_bytes(N, C) > SMEM_LIMIT ? 2 : 0;
}

template <int C, bool POS>
int launch_c(const Side& T, const Side& Dt, const Weights& w, const int* t_idx,
             const int* d_idx, bf16* out, int nt, int nd, int P, int N, int H,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(N, C);
  cudaError_t err = cudaFuncSetAttribute(
      match_pooled_bf16_kernel<C, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  match_pooled_bf16_kernel<C, POS><<<2 * P, THREADS, smem, stream>>>(
      T, Dt, w, t_idx, d_idx, out, nt, nd, N, H);
  return (int)cudaGetLastError();
}

template <bool POS>
int launch(const Side& T, const Side& Dt, const void* const* ws, const void* t_idx,
           const void* d_idx, void* out, int nt, int nd, int P, int N, int C, int H,
           void* stream) {
  if (P <= 0 || layout_status(N, C, H) != 0) return (int)cudaErrorInvalidValue;
  const Weights w = make_weights(ws);
  const int* ti = (const int*)t_idx;
  const int* di = (const int*)d_idx;
  bf16* o = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 16: return launch_c<16, POS>(T, Dt, w, ti, di, o, nt, nd, P, N, H, s);
    default: return launch_c<64, POS>(T, Dt, w, ti, di, o, nt, nd, P, N, H, s);
  }
}

}  // namespace

// The layout check of the bf16 cluster tier: writes the bytes of shared
// memory the shape needs and the most a block may take, and returns
// layout_status.
extern "C" int pcr_match_pooled_bf16_layout(int N, int C, int H, long long* bytes,
                                            long long* limit) {
  *bytes = (long long)smem_bytes(N, C);
  *limit = (long long)SMEM_LIMIT;
  return layout_status(N, C, H);
}

// Point head at bf16: 5 bf16 factors a side (h, q, kvz transposed to (n, 2C,
// C), a1, pv), then the 16 weights in pcr_match_pooled's order, the matrices
// bf16 in (out, in) layout (kv2: [Wk | Wv] as (2C, C)), the LayerNorm
// vectors float32; out (P, 2C) bf16.
extern "C" int pcr_match_pooled_bf16(
    const void* ht, const void* qt, const void* kvzt, const void* at, const void* pvt,
    const void* hd, const void* qd, const void* kvzd, const void* ad, const void* pvd,
    const void* merge1, const void* ln1s1, const void* ln1b1, const void* fc1_1,
    const void* fc2_1, const void* ln2s1, const void* ln2b1, const void* q2,
    const void* kv2, const void* merge2, const void* ln1s2, const void* ln1b2,
    const void* fc1_2, const void* fc2_2, const void* ln2s2, const void* ln2b2,
    const void* t_idx, const void* d_idx, void* out,
    int nt, int nd, int P, int N, int C, int H, void* stream) {
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  return launch<true>(make_side(ht, qt, kvzt, at, pvt), make_side(hd, qd, kvzd, ad, pvd),
                      ws, t_idx, d_idx, out, nt, nd, P, N, C, H, stream);
}

// Image head at bf16: 4 factors a side (h, q, kvz transposed, a1), no
// position term; N is the true token count S.
extern "C" int pcr_match_pooled_image_bf16(
    const void* ht, const void* qt, const void* kvzt, const void* at,
    const void* hd, const void* qd, const void* kvzd, const void* ad,
    const void* merge1, const void* ln1s1, const void* ln1b1, const void* fc1_1,
    const void* fc2_1, const void* ln2s1, const void* ln2b1, const void* q2,
    const void* kv2, const void* merge2, const void* ln1s2, const void* ln1b2,
    const void* fc1_2, const void* fc2_2, const void* ln2s2, const void* ln2b2,
    const void* t_idx, const void* d_idx, void* out,
    int nt, int nd, int P, int N, int C, int H, void* stream) {
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  return launch<false>(make_side(ht, qt, kvzt, at, nullptr),
                       make_side(hd, qd, kvzd, ad, nullptr), ws, t_idx, d_idx, out,
                       nt, nd, P, N, C, H, stream);
}
