// Fused per-pair match chain at bf16, grid or pair list, on Hopper's
// warpgroup tensor-core products (wgmma): the cluster tier of the match
// chain for a bf16 model.
//
// Replaces the bf16 instances of the TPU kernels
// point_cloud_reid_tpu/ops/pallas/match_grid.py fused_match_grid (:250),
// fused_match_pairs (:355) and the image head's pallas_image_grid_logits
// (:686) / pallas_image_pair_logits (:514) (_kernel under a bf16 model).
// There the per-object factors (h, q, kvz, a1, pv) and the pooled output are
// bf16, the weights float32, and every product casts both operands to bf16
// and accumulates in float32 (_make_dot, bdot); the rest of the chain is
// float32. This kernel rounds at the same places and nowhere else:
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
// What bounds it on the H100: 80 N C^2 operations a pair in one bf16 pass
// at 989 TFLOP/s (0.69 ms for the 128 x 128 grid at N = 128, C = 64; the
// image grid at S = 197 pads its rows to 16 and its products to 64-row
// tiles, which the bound does not count). Its first version (PR 12: one
// two-block cluster a pair on mma.sync, 8.8 ms for that grid) restaged ~134
// KB of weights for every pair, read its A operands from L2 inside the
// k-loops, ran one block of 8 warps an SM and issued m16n8k16 products from
// registers with B by 32-bit shared loads.
//
// Design:
//  - a persistent two-block cluster (block 0 the track side, block 1 the
//    det side) walks the pairs p = cluster, cluster + clusters, ...; as many
//    clusters as the card holds at once. The cluster is kept: a side's
//    stage-1 output O (float32) beside the resident weights leaves no room
//    for the other side's, so one block cannot hold a pair;
//  - all 15 C^2 bf16 weights (122,880 bytes at C = 64; stage 1 keeps only
//    the fc1[C:] half) and the stage-2 normaliser's head mask are staged
//    once a block, in the K-major 128-byte-swizzle layout wgmma reads
//    (csrc/bf16_mma.cuh), and stay for the block's lifetime;
//  - the next pair's [KV | Z] of the other side (2C x C bf16) is copied by
//    cp.async into a buffer that the summary's staging shares, once the
//    summary is done, so the copy overlaps stage 2 (one buffer, not a
//    two-stage ring: stage 1 alone reads it, and a second 16 KB does not
//    fit beside the resident weights at S = 198); the next pair's q (the
//    first product's A) is loaded into registers at the end of a pair, so
//    its latency overlaps the pooling and the cluster barrier; a1, h and pv
//    are loaded at the start of a row tile, ahead of the products that
//    wait on them (more prefetched registers spill: 255 is the most a
//    thread has);
//  - every product is wgmma m64nNk16 (N = C or 2C, float32 accumulators).
//    Two warpgroups a block take 64-row tiles of the side in turn (one
//    each at N = 128; two each at S = 197 / 198, the last tile padded).
//    A comes from registers: the previous product's accumulator packed to
//    bf16, or O's rows read from shared memory; B from the resident
//    weights. Products that do not wait on each other share a commit group
//    (q @ KV and the normaliser; merge and the search half of fc1);
//  - the template summary: each warpgroup projects its tile's [k | v],
//    stores bf16(k) and bf16(v) channel-major with stmatrix's transposing
//    store (K-major for KV = k^T v: the tile's rows are the contraction;
//    so every product reads one descriptor form) and adds k^T v with both
//    operands from shared memory; the two warpgroups' sums meet in shared
//    memory, the head mask is applied in registers, and KV^T (K-major, the
//    B operand of q @ KV, staged by stmatrix) goes to the peer block's
//    shared memory 16 bytes a store, with sum k;
//  - LayerNorm, elu+1, split-norm, ReLU and the max + mean pooling stay
//    float32 on the CUDA cores, on the accumulator fragments (a row's
//    columns lie in one quad); the divisions are __fdividef and elu+1's
//    exponential __expf (a few float32 ulps, far inside a bf16 ulp).
// Measured on the H100 (PERF.md section 6): about 2.3x PR 12's kernel and
// 5.3x its bound. A phase profile (clock64) reads it latency-bound: two
// warpgroups an SM, each a chain of dependent products and epilogues with
// block and cluster barriers between the phases, at 252-255 registers a
// thread, so nothing more can be prefetched or kept in flight.
// Grid and pair mode run the same per-pair code, and no sum depends on the
// cluster or order a pair is scored in, so a pair's result is its grid
// cell's bit for bit. Without POS (the image head) there is no position term
// and N is the true token count. Other widths up to 64 run in the padded
// layout as in csrc/match_grid.cu (PAD, csrc/match_grid_bf16_pad.cu).
//
// Layout, bytes a block, C = 64, Np = N rounded up to 16:
//   1,024 alignment, weights 122,880, mask 8,192, the peer's KV^T 8,192,
//   the [KV | Z] buffer / the summary's staging / the KV sum 32,768,
//   own O (Np x C float32, columns XOR-swizzled) 32,768 at N = 128,
//   sum k, partials and the peer's pooling 4,864:
// 210,688 bytes at N = 128, 231,168 at S = 197 / 198: N up to 208 fits at
// C = 64. Larger point-head shapes go to the rows tier
// (csrc/match_rows_bf16.cu).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bf16mma;

constexpr int THREADS = 256;                // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;                    // rows of a warpgroup's tile
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

// Bytes of a K-major operand of R rows and K columns (panels of 64).
constexpr int op_bytes(int R, int K) { return R * 128 * ((K + 63) / 64); }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared-memory layout for channel count C, byte offsets from the
// 1024-aligned base; every operand region is a multiple of 1024 bytes.
template <int C> struct Layout {
  static constexpr int MERGE1 = 0;
  static constexpr int FC1B1 = MERGE1 + op_bytes(C, C);          // fc1[C:]: (2C, C)
  static constexpr int FC2_1 = FC1B1 + op_bytes(2 * C, C);        // (C, 2C)
  static constexpr int Q2 = FC2_1 + op_bytes(C, 2 * C);
  static constexpr int KV2 = Q2 + op_bytes(C, C);                 // (2C, C)
  static constexpr int MERGE2 = KV2 + op_bytes(2 * C, C);
  static constexpr int FC1_2 = MERGE2 + op_bytes(C, C);           // (2C, 2C)
  static constexpr int FC2_2 = FC1_2 + op_bytes(2 * C, 2 * C);
  static constexpr int MASK = FC2_2 + op_bytes(C, 2 * C);         // (C, C)
  static constexpr int KVT = MASK + op_bytes(C, C);               // the peer's KV^T
  // the summary's staging a warpgroup: k^T (64 rows: wgmma's M, C of them
  // valid) and v^T (C rows), K = the tile's 64 rows
  static constexpr int KT_BYTES = op_bytes(TILE, TILE);
  static constexpr int STAGE_BYTES = KT_BYTES + op_bytes(C, TILE);
  static constexpr int RING = KVT + op_bytes(C, C);
  static constexpr int RING_BYTES =
      cmax(cmax(op_bytes(2 * C, C), 2 * STAGE_BYTES), 128 * (C / 2) * 4 + op_bytes(C, C));
  // KV^T staged for the copy to the peer, after the KV sum in the ring
  static constexpr int KV_SUM_BYTES = 128 * (C / 2) * 4;
  static constexpr int KVT_OUT = RING + KV_SUM_BYTES;
  static_assert(KV_SUM_BYTES + op_bytes(C, C) <= RING_BYTES, "KV^T staging");
  static constexpr int O = RING + RING_BYTES;
  // after O: sum k of the peer (C), partials (8 warps x 2C), the peer's
  // pooling (2C), float32
  static constexpr int SMALL = (C + WARPS * 2 * C + 2 * C) * 4;
  static size_t bytes(int N) {
    const int Np = (N + 15) / 16 * 16;
    return 1024 + (size_t)O + (size_t)Np * C * 4 + SMALL;
  }
};

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : __expf(x); }

// Column index of O's element (r, c) in its row: 8-float groups XOR r % (C / 8),
// so the A-fragment reads of 8 rows meet no bank twice.
template <int C>
__device__ __forceinline__ int ocol(int r, int c) {
  return c ^ ((r & (C / 8 - 1)) << 3);
}

// LayerNorm of the rows of a C-wide accumulator (rows g and g + 8 of the
// warp), in registers: a row's columns lie in one quad. PAD (the padded
// layout): the statistics over the true ct columns (the padded ones hold
// zeros: the sum needs no mask, the deviations do).
template <bool PAD, int NT>
__device__ __forceinline__ void layer_norm_acc(float (&acc)[NT][4],
                                               const float* __restrict__ s,
                                               const float* __restrict__ b, int ct) {
  const float invC = PAD ? 1.f / ct : 1.f / (8 * NT);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) sum += acc[j][2 * half] + acc[j][2 * half + 1];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mu = sum * invC;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d0 = acc[j][2 * half] - mu, d1 = acc[j][2 * half + 1] - mu;
      if (PAD) {
        d0 = j * 8 + 2 * t < ct ? d0 : 0.f;
        d1 = j * 8 + 2 * t + 1 < ct ? d1 : 0.f;
      }
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

// Copy a rows x K bf16 matrix (row stride ld, from column koff) into a
// K-major 128-byte-swizzle region, 16 bytes a cp.async, whole block.
__device__ __forceinline__ void stage_sw(uint32_t dst, const bf16* __restrict__ src, int rows,
                                         int K, int ld, int koff) {
  const int per = K / 8;
  for (int e = threadIdx.x; e < rows * per; e += THREADS) {
    const int r = e / per, c = e - r * per;
    cp_async16(dst + sw128(r, c * 8, rows), src + (size_t)r * ld + koff + c * 8);
  }
}

// acc += A @ B for a warpgroup: KS k-steps of the A fragments `a`, B the
// K-major operand of R rows at `base`, columns from k0.
template <int N, int KS>
__device__ __forceinline__ void issue(float (&acc)[N / 8][4], const uint32_t (&a)[KS][4],
                                      uint32_t base, int R, int k0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) Wgmma<N>::rs(acc, a[kk], desc_at(base, R, 0, k0 + 16 * kk));
}

template <int N>
__device__ __forceinline__ void finish(float (&acc)[N / 8][4]) {
  wg_commit();
  wg_wait<0>();
  wg_pin(acc);
}

// The A fragments of bf16(O) for a warp's rows r (g) and r + 8, or zeros
// past the rows O holds.
template <int C>
__device__ __forceinline__ void o_frags(const float* O, int r, bool held,
                                        uint32_t (&a)[C / 16][4]) {
  const int t = threadIdx.x & 3;
  if (!held) r &= 7;                           // a row O holds; zeros below
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(O + r * C + ocol<C>(r, c));
    const float2 x1 = *reinterpret_cast<const float2*>(O + (r + 8) * C + ocol<C>(r + 8, c));
    const float2 x2 = *reinterpret_cast<const float2*>(O + r * C + ocol<C>(r, c + 8));
    const float2 x3 = *reinterpret_cast<const float2*>(O + (r + 8) * C + ocol<C>(r + 8, c + 8));
    a[kk][0] = held ? pack_bf16(x0.x, x0.y) : 0u;
    a[kk][1] = held ? pack_bf16(x1.x, x1.y) : 0u;
    a[kk][2] = held ? pack_bf16(x2.x, x2.y) : 0u;
    a[kk][3] = held ? pack_bf16(x3.x, x3.y) : 0u;
  }
}

// A 32-bit load of row r (clamped into the N rows, read as 0 when `valid`
// is false): unconditional, so that no wgmma operand is defined on a
// divergent path.
__device__ __forceinline__ uint32_t row_ld(const bf16* p, int r, int ld, int N, int c,
                                           bool valid) {
  const uint32_t x = ldg32(p + (size_t)min(r, N - 1) * ld + c);
  return valid ? x : 0u;
}

// The A fragments of q for a warp's rows r0 (16-row slab + g) and r0 + 8.
template <int C>
__device__ __forceinline__ void load_q(uint32_t (&aq)[C / 16][4], const bf16* qX, int r0,
                                       int N) {
  const int t = threadIdx.x & 3, r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    aq[kk][0] = row_ld(qX, r0, C, N, c, r0 < N);
    aq[kk][1] = row_ld(qX, r1, C, N, c, r1 < N);
    aq[kk][2] = row_ld(qX, r0, C, N, c + 8, r0 < N);
    aq[kk][3] = row_ld(qX, r1, C, N, c + 8, r1 < N);
  }
}

// A (N, W) bf16 matrix's elements of a warp's rows r0, r0 + 8 by 8-column
// n-tile, as bf16 pairs: the layout of an accumulator.
template <int W>
__device__ __forceinline__ void load_rows(uint32_t (&x)[W / 8][2], const bf16* p, int r0,
                                          int N) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    x[j][0] = row_ld(p, r0, W, N, j * 8 + 2 * t, r0 < N);
    x[j][1] = row_ld(p, r0 + 8, W, N, j * 8 + 2 * t, r0 + 8 < N);
  }
}

// ---- the kernel ---------------------------------------------------------------------

// PAD: the padded layout (kernels/match_grid.pad_side), as in
// csrc/match_grid.cu: the true channels are the first ct of C in H heads of
// ct / H, the wrapper zeroes the lanes past ct, the kernel masks elu+1 of a
// padded stage-2 q or k lane and the LayerNorm statistics.
template <int C, bool POS, bool PAD>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
match_pooled_bf16_kernel(Side T, Side Dt, Weights w, const int* __restrict__ t_idx,
                         const int* __restrict__ d_idx, bf16* __restrict__ out,
                         int nt, int nd, int P, int N, int H, int ct) {
  using L = Layout<C>;
  constexpr int NT = C / 8, KS = C / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // warpgroup and warp within it, broadcast so that the compiler sees them
  // uniform across a warp (a wgmma's operands are then never defined on a
  // divergent path)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wq = __shfl_sync(0xffffffffu, warp & 3, 0);
  const int Np = (N + 15) / 16 * 16, ntiles = (N + TILE - 1) / TILE;
  const int D = (PAD ? ct : C) / H;
  const size_t nc = (size_t)N * C;

  float* O = reinterpret_cast<float*>(smem + L::O);                 // [Np][C]
  float* ksp = O + (size_t)Np * C;                                  // [C] the peer's sum k
  float* part = ksp + C;                                            // [WARPS][2C]
  float* pool = part + WARPS * 2 * C;                               // [2C] the peer's max | sum
  float* scratch = reinterpret_cast<float*>(smem + L::RING);        // the KV sum
  const uint32_t ring = sb + L::RING;
  const uint32_t kt_buf = ring + wg * L::STAGE_BYTES, vt_buf = kt_buf + L::KT_BYTES;

  // the weights, once
  stage_sw(sb + L::MERGE1, w.s1.merge, C, C, C, 0);
  stage_sw(sb + L::FC1B1, w.s1.fc1, 2 * C, C, 2 * C, C);
  stage_sw(sb + L::FC2_1, w.s1.fc2, C, 2 * C, 2 * C, 0);
  stage_sw(sb + L::Q2, w.q2, C, C, C, 0);
  stage_sw(sb + L::KV2, w.kv2, 2 * C, C, C, 0);
  stage_sw(sb + L::MERGE2, w.s2.merge, C, C, C, 0);
  stage_sw(sb + L::FC1_2, w.s2.fc1, 2 * C, 2 * C, 2 * C, 0);
  stage_sw(sb + L::FC2_2, w.s2.fc2, C, 2 * C, 2 * C, 0);
  // the head mask (symmetric): 1.0 in bf16 is 0x3f80
  for (int e = tid; e < C * C; e += THREADS) {
    const int n = e / C, k = e - n * C;
    *reinterpret_cast<uint16_t*>(smem + L::MASK + sw128(n, k, C)) =
        n / D == k / D ? (uint16_t)0x3f80u : (uint16_t)0u;
  }

  const int cid = blockIdx.x >> 1, ncl = gridDim.x >> 1;
  auto pair_of = [&](int p, int& ti, int& dj) {
    if (t_idx != nullptr) {            // pair list, range-checked by the wrapper;
                                       // the clamp only bounds the reads
      ti = min(max(t_idx[p], 0), nt - 1);
      dj = min(max(d_idx[p], 0), nd - 1);
    } else {
      ti = p / nd;
      dj = p - ti * nd;
    }
  };
  // [KV | Z] of the other side of pair p, into the ring
  auto fetch_kvz = [&](int p) {
    int ti, dj;
    pair_of(p, ti, dj);
    const bf16* src = rank == 0 ? Dt.kvz + (size_t)dj * 2 * C * C : T.kvz + (size_t)ti * 2 * C * C;
    stage_sw(ring, src, 2 * C, C, C, 0);
  };
  // own side's object of pair p
  auto own = [&](int p) {
    int ti, dj;
    pair_of(p, ti, dj);
    return rank == 0 ? ti : dj;
  };
  const Side X = rank == 0 ? T : Dt;           // own side
  // the head mask of this thread's KV accumulator elements, one bit each
  uint32_t kv_heads = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wq * 16 + g + 8 * (i >> 1), n = j * 8 + 2 * t + (i & 1);
      kv_heads |= (m / D == n / D ? 1u : 0u) << (j * 4 + i);
    }
  // q of the first pair's first tile of this warpgroup
  uint32_t pre_q[KS][4];
  if (cid < P) {
    load_q<C>(pre_q, X.q + own(cid) * nc, wg * TILE + wq * 16 + g, N);
    fetch_kvz(cid);
  }
  cp_commit();
  cluster.sync();                              // the peer has started

  for (int p = cid; p < P; p += ncl) {
    const int xi = own(p);
    const bf16* hX = X.h + xi * nc;
    const bf16* qX = X.q + xi * nc;
    const bf16* aX = X.a1 + xi * 2 * nc;
    const bf16* pvX = POS ? X.pv + xi * nc : nullptr;
    cp_wait<0>();                              // [KV | Z] (and, first, the weights)
    fence_async_shared();
    __syncthreads();

    // ---- stage 1: O = h + LN2(relu(a1 + LN1(split_norm(q @ kvzY) @ merge) @ fc1[C:]) @ fc2)
    for (int tile = wg; tile < ntiles; tile += 2) {
      const int r0 = tile * TILE + wq * 16 + g, r1 = r0 + 8;
      const bool v0 = r0 < N, v1 = r1 < N;
      const bool held = tile * TILE + wq * 16 < Np;
      if (tile != wg) load_q<C>(pre_q, qX, r0, N);   // the first tile's came ahead
      uint32_t a1r[2 * NT][2], hr[NT][2];            // used after two products
      load_rows<2 * C>(a1r, aX, r0, N);
      load_rows<C>(hr, hX, r0, N);
      float mz[2 * NT][4];
      zero(mz);
      wg_fence();
      issue<2 * C, KS>(mz, pre_q, ring, 2 * C, 0);
      finish<2 * C>(mz);
      float msg[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) msg[j][i] = __fdividef(mz[j][i], mz[NT + j][i] + EPS);
      uint32_t am[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) a_from_acc(msg, kk, am[kk]);
      float m[NT][4];
      zero(m);
      wg_fence();
      issue<C, KS>(m, am, sb + L::MERGE1, C, 0);
      finish<C>(m);
      layer_norm_acc<PAD>(m, w.s1.ln1s, w.s1.ln1b, ct);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) a_from_acc(m, kk, am[kk]);
      float hid[2 * NT][4];                    // a1, then + bf16(m) @ fc1[C:]
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        const float2 x0 = unpack_bf16(a1r[j][0]), x1 = unpack_bf16(a1r[j][1]);
        hid[j][0] = x0.x; hid[j][1] = x0.y; hid[j][2] = x1.x; hid[j][3] = x1.y;
      }
      wg_fence();
      issue<2 * C, KS>(hid, am, sb + L::FC1B1, 2 * C, 0);
      finish<2 * C>(hid);
      uint32_t ah[2 * KS][4];
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) hid[j][i] = fmaxf(hid[j][i], 0.f);
#pragma unroll
      for (int kk = 0; kk < 2 * KS; ++kk) a_from_acc(hid, kk, ah[kk]);
      float y[NT][4];
      zero(y);
      wg_fence();
      issue<C, 2 * KS>(y, ah, sb + L::FC2_1, C, 0);
      finish<C>(y);
      layer_norm_acc<PAD>(y, w.s1.ln2s, w.s1.ln2b, ct);
      if (held) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = j * 8 + 2 * t;
          const float2 h0 = unpack_bf16(hr[j][0]), h1 = unpack_bf16(hr[j][1]);
          // rows past N hold zeros, which nothing reads as data
          *reinterpret_cast<float2*>(O + r0 * C + ocol<C>(r0, c)) =
              v0 ? make_float2(h0.x + y[j][0], h0.y + y[j][1]) : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(O + r1 * C + ocol<C>(r1, c)) =
              v1 ? make_float2(h1.x + y[j][2], h1.y + y[j][3]) : make_float2(0.f, 0.f);
        }
      }
    }
    __syncthreads();                           // O complete, [KV | Z] read out

    // ---- the template summary of the peer's direction: k = elu1(O Wk),
    // v = O Wv + pv, KV = bf16(k)^T bf16(v) and sum k
    float kv[NT][4];
    zero(kv);
    float kp[NT][2];                           // this thread's part of sum k
#pragma unroll
    for (int j = 0; j < NT; ++j) kp[j][0] = kp[j][1] = 0.f;
    for (int tile = wg; tile < ntiles; tile += 2) {
      const int r0 = tile * TILE + wq * 16 + g, r1 = r0 + 8;
      const bool v0 = r0 < N, v1 = r1 < N;
      const bool held = tile * TILE + wq * 16 < Np;
      uint32_t ao[KS][4];
      o_frags<C>(O, r0, held, ao);
      uint32_t pq[NT][2];
      if (POS) load_rows<C>(pq, pvX, r0, N);
      float kvr[2 * NT][4];
      uint32_t pk[2 * NT][2];                  // bf16(k) | bf16(v), packed
      zero(kvr);
      wg_fence();
      issue<2 * C, KS>(kvr, ao, sb + L::KV2, 2 * C, 0);
      finish<2 * C>(kvr);
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        float e[4];
        if (j < NT) {
#pragma unroll
          for (int i = 0; i < 4; ++i)   // a padded k lane is 0
            e[i] = PAD && j * 8 + 2 * t + (i & 1) >= ct ? 0.f : elu1(kvr[j][i]);
        } else {
          e[0] = kvr[j][0]; e[1] = kvr[j][1]; e[2] = kvr[j][2]; e[3] = kvr[j][3];
          if (POS) {
            const float2 q0 = unpack_bf16(pq[j - NT][0]), q1 = unpack_bf16(pq[j - NT][1]);
            e[0] += q0.x; e[1] += q0.y; e[2] += q1.x; e[3] += q1.y;
          }
        }
        if (!v0) e[0] = e[1] = 0.f;            // rows past N add nothing
        if (!v1) e[2] = e[3] = 0.f;
        if (j < NT) {
          kp[j][0] += e[0] + e[2];
          kp[j][1] += e[1] + e[3];
        }
        pk[j][0] = pack_bf16(e[0], e[1]);
        pk[j][1] = pack_bf16(e[2], e[3]);
      }
      // channel-major (row = channel, k = the tile's row): the fragments'
      // 8 x 8 blocks stored transposed, four a stmatrix; lane l gives the
      // row address of row l % 8 of block l / 8
#pragma unroll
      for (int j = 0; j < 2 * NT; j += 2) {
        const int m = lane >> 3;
        const int c = (j < NT ? j : j - NT) * 8 + 8 * (m >> 1) + (lane & 7);
        const uint32_t buf = j < NT ? kt_buf : vt_buf;
        stmatrix_x4_trans(buf + c * 128 + (((2 * wq + (m & 1)) ^ (c & 7)) << 4), pk[j][0],
                          pk[j][1], pk[j + 1][0], pk[j + 1][1]);
      }
      fence_async_shared();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        Wgmma<C>::ss(kv, desc_at(kt_buf, TILE, 0, 16 * kk), desc_at(vt_buf, C, 0, 16 * kk));
      finish<C>(kv);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");   // staging free
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
    __syncthreads();                           // both warpgroups' staging read out
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) scratch[(j * 4 + i) * 128 + tid - 128] = kv[j][i];
    }
    __syncthreads();
    // KV^T (masked per head, rounded to bf16) and sum k into the peer's
    // shared memory (free: the last cluster barrier followed its stage 2)
    unsigned char* peer = cluster.map_shared_rank(smem, rank ^ 1);
    if (wg == 0) {
      // KV^T staged locally (K-major, as the peer's KVT): the accumulator's
      // 8 x 8 blocks stored transposed, then copied 16 bytes a thread
      uint32_t pk[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = kv[j][i] + scratch[(j * 4 + i) * 128 + tid];
          v[i] = (kv_heads >> (j * 4 + i)) & 1u ? v[i] : 0.f;
        }
        pk[j][0] = pack_bf16(v[0], v[1]);
        pk[j][1] = pack_bf16(v[2], v[3]);
      }
      if (wq * 16 < C) {                       // the warp holds rows of KV
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          const int mb = lane >> 3, n = j * 8 + 8 * (mb >> 1) + (lane & 7);
          stmatrix_x4_trans(sb + L::KVT_OUT + n * 128 + (((2 * wq + (mb & 1)) ^ (n & 7)) << 4),
                            pk[j][0], pk[j][1], pk[j + 1][0], pk[j + 1][1]);
        }
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      for (int e = tid; e < C * 8; e += 128)
        reinterpret_cast<uint4*>(peer + L::KVT)[e] =
            reinterpret_cast<const uint4*>(smem + L::KVT_OUT)[e];
    }
    if (tid < C) {
      float sum = 0.f;
      for (int v = 0; v < WARPS; ++v) sum += part[v * C + tid];
      reinterpret_cast<float*>(peer + ((unsigned char*)ksp - smem))[tid] = sum;
    }
    fence_async_cluster();
    __syncthreads();                           // the scratch and part are read out
    if (p + ncl < P) fetch_kvz(p + ncl);       // the next pair's, during stage 2
    cp_commit();
    cluster.sync();                            // the peer's KV^T and sum k have landed
    fence_async_shared();

    // ---- stage 2: own O searches the peer's summary, then pooling
    float pm[NT][2], ps[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pm[j][0] = pm[j][1] = -__int_as_float(0x7f800000);
      ps[j][0] = ps[j][1] = 0.f;
    }
    for (int tile = wg; tile < ntiles; tile += 2) {
      const int r0 = tile * TILE + wq * 16 + g, r1 = r0 + 8;
      const bool v0 = r0 < N, v1 = r1 < N;
      const bool held = tile * TILE + wq * 16 < Np;
      uint32_t ao[KS][4];
      o_frags<C>(O, r0, held, ao);
      float q[NT][4];
      zero(q);
      wg_fence();
      issue<C, KS>(q, ao, sb + L::Q2, C, 0);
      finish<C>(q);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          q[j][i] = PAD && j * 8 + 2 * t + (i & 1) >= ct ? 0.f : elu1(q[j][i]);
      uint32_t aq[KS][4], az[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        a_from_acc(q, kk, aq[kk]);
        const int c0 = 2 * kk, c1 = 2 * kk + 1;   // n-tiles of the k-step
        const float2 k0 = *reinterpret_cast<const float2*>(ksp + c0 * 8 + 2 * t);
        const float2 k1 = *reinterpret_cast<const float2*>(ksp + c1 * 8 + 2 * t);
        az[kk][0] = pack_bf16(q[c0][0] * k0.x, q[c0][1] * k0.y);
        az[kk][1] = pack_bf16(q[c0][2] * k0.x, q[c0][3] * k0.y);
        az[kk][2] = pack_bf16(q[c1][0] * k1.x, q[c1][1] * k1.y);
        az[kk][3] = pack_bf16(q[c1][2] * k1.x, q[c1][3] * k1.y);
      }
      float mm[NT][4], zz[NT][4];
      zero(mm);
      zero(zz);
      wg_fence();
      issue<C, KS>(mm, aq, sb + L::KVT, C, 0);
      issue<C, KS>(zz, az, sb + L::MASK, C, 0);
      wg_commit();
      wg_wait<0>();
      wg_pin(mm);
      wg_pin(zz);
      float msg[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) msg[j][i] = __fdividef(mm[j][i], zz[j][i] + EPS);
      uint32_t am[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) a_from_acc(msg, kk, am[kk]);
      float m[NT][4], hid[2 * NT][4];
      zero(m);
      zero(hid);
      wg_fence();
      issue<C, KS>(m, am, sb + L::MERGE2, C, 0);
      issue<2 * C, KS>(hid, ao, sb + L::FC1_2, 2 * C, 0);          // fc1[:C] on bf16(O)
      wg_commit();
      wg_wait<0>();
      wg_pin(m);
      wg_pin(hid);
      layer_norm_acc<PAD>(m, w.s2.ln1s, w.s2.ln1b, ct);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) a_from_acc(m, kk, am[kk]);
      wg_fence();
      issue<2 * C, KS>(hid, am, sb + L::FC1_2, 2 * C, C);          // fc1[C:] on bf16(m)
      finish<2 * C>(hid);
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) hid[j][i] = fmaxf(hid[j][i], 0.f);
      uint32_t ah[2 * KS][4];
#pragma unroll
      for (int kk = 0; kk < 2 * KS; ++kk) a_from_acc(hid, kk, ah[kk]);
      float y[NT][4];
      zero(y);
      wg_fence();
      issue<C, 2 * KS>(y, ah, sb + L::FC2_2, C, 0);
      finish<C>(y);
      layer_norm_acc<PAD>(y, w.s2.ln2s, w.s2.ln2b, ct);
      if (held) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = j * 8 + 2 * t;
          const float2 o0 = *reinterpret_cast<const float2*>(O + r0 * C + ocol<C>(r0, c));
          const float2 o1 = *reinterpret_cast<const float2*>(O + r1 * C + ocol<C>(r1, c));
          const float a0 = o0.x + y[j][0], a1 = o0.y + y[j][1];
          const float b0 = o1.x + y[j][2], b1 = o1.y + y[j][3];
          const float ninf = -__int_as_float(0x7f800000);
          pm[j][0] = fmaxf(pm[j][0], fmaxf(v0 ? a0 : ninf, v1 ? b0 : ninf));
          pm[j][1] = fmaxf(pm[j][1], fmaxf(v0 ? a1 : ninf, v1 ? b1 : ninf));
          ps[j][0] += (v0 ? a0 : 0.f) + (v1 ? b0 : 0.f);
          ps[j][1] += (v0 ? a1 : 0.f) + (v1 ? b1 : 0.f);
        }
      }
    }
    if (p + ncl < P)                           // q of the next pair's first tile, ahead
      load_q<C>(pre_q, X.q + own(p + ncl) * nc, wg * TILE + wq * 16 + g, N);
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
    if (tid < C) {
      mx = part[tid];
      sm = part[C + tid];
      for (int v = 1; v < WARPS; ++v) {
        mx = fmaxf(mx, part[v * 2 * C + tid]);
        sm += part[v * 2 * C + C + tid];
      }
      if (rank == 1) {
        float* dst = cluster.map_shared_rank(pool, 0);
        dst[tid] = mx;
        dst[C + tid] = sm;
      }
    }
    cluster.sync();                            // the det side's pooling has landed
    if (rank == 0 && tid < C) {
      bf16* o = out + (size_t)p * 2 * C;
      o[tid] = __float2bfloat16_rn(fmaxf(mx, pool[tid]));
      o[C + tid] = __float2bfloat16_rn((sm + pool[C + tid]) * (1.f / (2.f * N)));
    }
  }
  cp_wait<0>();
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

template <int C, bool POS, bool PAD>
int launch_c(const Side& T, const Side& Dt, const Weights& w, const int* t_idx,
             const int* d_idx, bf16* out, int nt, int nd, int P, int N, int H, int ct,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(N, C);
  auto kernel = match_pooled_bf16_kernel<C, POS, PAD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // as many clusters as the card holds at once, at most one a pair
  int clusters = 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * P, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  clusters = clusters < P ? clusters : P;
  kernel<<<2 * clusters, THREADS, smem, stream>>>(T, Dt, w, t_idx, d_idx, out, nt, nd, P, N, H,
                                                  ct);
  return (int)cudaGetLastError();
}

// PAD: ct true channels of the layout's C (16 or 64) in H heads.
template <bool POS, bool PAD>
int launch(const Side& T, const Side& Dt, const void* const* ws, const void* t_idx,
           const void* d_idx, void* out, int nt, int nd, int P, int N, int C, int H, int ct,
           void* stream) {
  const bool ok = PAD ? layout_status(N, C, 1) == 0 && H >= 1 && ct >= 1 && ct <= C &&
                            ct % H == 0
                      : layout_status(N, C, H) == 0;
  if (P <= 0 || !ok) return (int)cudaErrorInvalidValue;
  const Weights w = make_weights(ws);
  const int* ti = (const int*)t_idx;
  const int* di = (const int*)d_idx;
  bf16* o = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 16: return launch_c<16, POS, PAD>(T, Dt, w, ti, di, o, nt, nd, P, N, H, ct, s);
    default: return launch_c<64, POS, PAD>(T, Dt, w, ti, di, o, nt, nd, P, N, H, ct, s);
  }
}

}  // namespace

#ifndef MATCH_GRID_PAD_UNIT

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
  return launch<true, false>(make_side(ht, qt, kvzt, at, pvt),
                             make_side(hd, qd, kvzd, ad, pvd), ws, t_idx, d_idx, out, nt, nd, P,
                             N, C, H, C, stream);
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
  return launch<false, false>(make_side(ht, qt, kvzt, at, nullptr),
                              make_side(hd, qd, kvzd, ad, nullptr), ws, t_idx, d_idx, out, nt,
                              nd, P, N, C, H, C, stream);
}

#else   // MATCH_GRID_PAD_UNIT: the padded instantiations (csrc/match_grid_bf16_pad.cu)

// The padded layout (kernels/match_grid.pad_side) of both heads at bf16:
// the same arguments, C the layout's width (16 or 64) and ct the true
// channels after H.
extern "C" int pcr_match_pooled_pad_bf16(
    const void* ht, const void* qt, const void* kvzt, const void* at, const void* pvt,
    const void* hd, const void* qd, const void* kvzd, const void* ad, const void* pvd,
    const void* merge1, const void* ln1s1, const void* ln1b1, const void* fc1_1,
    const void* fc2_1, const void* ln2s1, const void* ln2b1, const void* q2,
    const void* kv2, const void* merge2, const void* ln1s2, const void* ln1b2,
    const void* fc1_2, const void* fc2_2, const void* ln2s2, const void* ln2b2,
    const void* t_idx, const void* d_idx, void* out,
    int nt, int nd, int P, int N, int C, int H, int ct, void* stream) {
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  return launch<true, true>(make_side(ht, qt, kvzt, at, pvt), make_side(hd, qd, kvzd, ad, pvd),
                            ws, t_idx, d_idx, out, nt, nd, P, N, C, H, ct, stream);
}

extern "C" int pcr_match_pooled_image_pad_bf16(
    const void* ht, const void* qt, const void* kvzt, const void* at,
    const void* hd, const void* qd, const void* kvzd, const void* ad,
    const void* merge1, const void* ln1s1, const void* ln1b1, const void* fc1_1,
    const void* fc2_1, const void* ln2s1, const void* ln2b1, const void* q2,
    const void* kv2, const void* merge2, const void* ln1s2, const void* ln1b2,
    const void* fc1_2, const void* fc2_2, const void* ln2s2, const void* ln2b2,
    const void* t_idx, const void* d_idx, void* out,
    int nt, int nd, int P, int N, int C, int H, int ct, void* stream) {
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  return launch<false, true>(make_side(ht, qt, kvzt, at, nullptr),
                             make_side(hd, qd, kvzd, ad, nullptr), ws, t_idx, d_idx, out, nt,
                             nd, P, N, C, H, ct, stream);
}

#endif  // MATCH_GRID_PAD_UNIT
