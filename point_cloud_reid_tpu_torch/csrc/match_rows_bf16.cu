// Fused per-pair match chain at bf16, tier ROWS: a bf16 point head at the
// widths and row counts the bf16 cluster tier (csrc/match_grid_bf16.cu)
// does not hold in shared memory. It replaces the bf16 instances of
// point_cloud_reid_tpu/ops/pallas/match_grid.py fused_match_grid (:250) and
// fused_match_pairs (:355) for C = 128 (the 1.5M and 7M models, any N) and
// for C = 64 past the bf16 cluster tier's 208 rows (the point-count
// ablations served at their crop size). kernels/match_grid.plan(N, C, H,
// dtype=torch.bfloat16) picks the tier. It rounds where JAX's bf16 kernel
// (_make_dot) rounds and nowhere else (csrc/match_grid_bf16.cu lists the
// places).
//
// What bounds it on the H100: 80 N C^2 operations a pair in one bf16 pass
// at 989 TFLOP/s (2.78 ms for a 128 x 128 grid at C = 128, N = 128; 0.35 ms
// for 512 pairs at C = 64, N = 2048).
//
// Tier "rows" (C = 64, 128): csrc/match_rows_wg.cuh with policy Bf16, every
// product one wgmma m64n64k16 pass. What held its first version
// (below) back and what the new structure does, in the header's four points:
// four warps an SM -> two consumer warpgroups (a side each) and a producer;
// two block barriers a 64 x 64 weight tile serving 64 rows -> a ring of
// 8 KB cp.async.bulk stages with mbarriers, each serving 128 rows; bf16
// fragments re-formed from float32 strips and a float32 C x C summary ->
// A from the last accumulator in registers, the summary's diagonal band
// rounded once into bf16 stages; LayerNorm row by row from shared memory ->
// in registers on the accumulators.
//
// Tier "rows_mma" (C = 16, which no registered leaf reaches here: the bf16
// cluster tier holds 2,848 rows at C = 16): the first version, kept. The
// float32 rows tier's structure (csrc/match_rows.cu) with every product one
// mma.sync m16n8k16 bf16 pass: a block scores one pair at a time, both
// directions in turn; each block owns a slot of a device scratch with the
// pair's two stage-1 outputs; 4 warps carry 16-row slabs through the chain
// in float32 strips of shared memory; a product stages one weight through a
// cp.async double buffer of 64 x 64 tiles shared by the block's warps. It
// is bound by the block barriers of each tile and the mma.sync issue of 4
// warps a block, not by the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "match_rows_wg.cuh"

namespace {

using namespace bf16mma;

constexpr int RW = 4;                         // warps a block
constexpr int THREADS = 32 * RW;
constexpr int HMAX = 8;                       // most heads
constexpr int KT = 64;                        // columns of K a weight tile
constexpr int WT = 64;                        // output columns a weight tile
constexpr int LDT = KT + 8;                   // padded row of a weight tile, bf16
constexpr size_t SMEM_LIMIT = 232448;         // dynamic shared memory a block may take
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;

struct Side {         // per-object factors of one side, bf16
  const bf16* h;      // (n, N, C)
  const bf16* q;      // (n, N, C)   elu+1 stage-1 queries
  const bf16* kvz;    // (n, 2C, C)  [KV | Z], transposed
  const bf16* a1;     // (n, N, 2C)  h @ stage1.fc1[:C]
  const bf16* pv;     // (n, N, C)   stage-2 pos-MLP @ v_proj
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
  const bf16* kv2;    // (2C, C) = [Wk | Wv]
};

// Shared-memory layout for channel count C: per warp the float32 strips A
// (16 x 2C), B and Cs (16 x C), rows padded by 8 (the float2 A-fragment
// reads of a half-warp meet no bank twice); then the summary KV (C x C
// float32, rows padded by 8), ksum, the stage-2 denominators (16 rows x
// HMAX heads a warp), the pooling partials (2C a warp), all in floats; then
// the two bf16 weight tiles (WT x LDT each).
template <int C> struct Layout {
  static constexpr int LDA = 2 * C + 8;
  static constexpr int LDB = C + 8;
  static constexpr int STRIP = 16 * (LDA + 2 * LDB);
  static constexpr int LDKV = C + 8;
  static constexpr int KV = RW * STRIP;
  static constexpr int KS = KV + C * LDKV;
  static constexpr int DEN = KS + C;
  static constexpr int PART = DEN + RW * 16 * HMAX;
  static constexpr int TILES = PART + RW * 2 * C;          // in floats
  static constexpr size_t BYTES = (size_t)TILES * 4 + 2 * WT * LDT * 2;
};

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

// acc[j] += bf16(A) (16 x K, a float32 strip, leading dimension lda) @ B
// (K x 8 NN: bf16 (n, k) rows of leading dimension ldb) for columns 8 j.
template <int K, int NN>
__device__ __forceinline__ void mm(float (&acc)[NN][4], const float* A, int lda, const bf16* B,
                                   int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < K / 16; ++kk) {
    const float* r = A + g * lda + kk * 16 + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(r);
    const float2 x1 = *reinterpret_cast<const float2*>(r + 8 * lda);
    const float2 x2 = *reinterpret_cast<const float2*>(r + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(r + 8 * lda + 8);
    const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                           pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const bf16* b = B + (j * 8 + g) * ldb + kk * 16 + 2 * t;
      mma(acc[j], a, ld32(b), ld32(b + 8));
    }
  }
}

template <int NN, class Epi>
__device__ __forceinline__ void epilogue(const float (&acc)[NN][4], int n0, Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) epi(g + 8 * (e >> 1), n0 + 8 * j + 2 * t + (e & 1), acc[j][e]);
}

// One factor of a product: a warp's strip A (16 x K) and a weight B in
// device memory, bf16 (n, k) rows of leading dimension ldb from column kofs.
struct Seg { const float* A; int lda; const bf16* B; int ldb; int kofs; };

// out = epi(A1 @ B1 [+ A2 @ B2]) for the COLS columns of every warp's slab,
// the weights staged through the block's double-buffered tiles (WT output
// columns x KT of K, cp.async). The whole block calls it; a warp that is not
// `active` stages its share of the tiles and computes nothing.
template <int K, int COLS, class Epi>
__device__ __forceinline__ void product_tiled(bf16* tiles, bool active, const Seg& s0,
                                              const Seg* s1, Epi epi) {
  constexpr int NN = COLS / 8 < WT / 8 ? COLS / 8 : WT / 8;
  constexpr int W = 8 * NN;                    // columns a run
  constexpr int R = K < KT ? K : KT;           // columns of K a tile
  constexpr int TPS = K / R;                   // tiles a factor
  const int ntiles = s1 != nullptr ? 2 * TPS : TPS;
  for (int n0 = 0; n0 < COLS; n0 += W) {
    auto issue = [&](int it) {
      const Seg& sg = it < TPS ? s0 : *s1;
      const bf16* src = sg.B + (size_t)n0 * sg.ldb + sg.kofs + (it % TPS) * R;
      const uint32_t dst = smem_addr(tiles + (it & 1) * WT * LDT);
      for (int e = threadIdx.x; e < W * (R / 8); e += THREADS) {
        const int n = e / (R / 8), c = 8 * (e - n * (R / 8));
        cp_async16(dst + (n * LDT + c) * 2, src + (size_t)n * sg.ldb + c);
      }
      cp_commit();
    };
    float acc[NN][4];
    zero(acc);
    issue(0);
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) {
        issue(it + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();                         // tile it has landed for every warp
      if (active) {
        const Seg& sg = it < TPS ? s0 : *s1;
        mm<R, NN>(acc, sg.A + (it % TPS) * R, sg.lda, tiles + (it & 1) * WT * LDT, LDT);
      }
      __syncthreads();                         // tile it is read: its buffer is free
    }
    if (active) epilogue<NN>(acc, n0, epi);
  }
}

// LayerNorm of the 16 rows of a strip (C columns), in place.
template <int C>
__device__ __forceinline__ void layer_norm_rows(float* S, int ld, const float* __restrict__ sc,
                                                const float* __restrict__ bi) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < 16; ++r) {
    float* row = S + r * ld;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += row[c];
    const float mu = warp_sum(sum) * (1.f / C);
    float var = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mu;
      var += d * d;
    }
    const float inv = rsqrtf(warp_sum(var) * (1.f / C) + LN_EPS);
    for (int c = lane; c < C; c += 32) row[c] = (row[c] - mu) * inv * __ldg(sc + c) + __ldg(bi + c);
  }
  __syncwarp();
}

// Copy rows r0 .. r0 + 15 of an (N, C) matrix (bf16 or float32) into a
// strip; rows past N read as 0.
template <int C, class T>
__device__ __forceinline__ void load_rows(float* S, int ld, const T* src, int r0, int N) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * C; e += 32) {
    const int r = e / C, c = e - r * C;
    float v = 0.f;
    if (r0 + r < N) {
      if constexpr (sizeof(T) == 2) v = bf(src + (size_t)(r0 + r) * C + c);
      else v = src[(size_t)(r0 + r) * C + c];
    }
    S[r * ld + c] = v;
  }
  __syncwarp();
}

// Stage 1 of side X against the other side's [KV | Z]: O = h + LN2(relu(a1
// + LN1(split_norm(q @ kvzY) @ merge) @ fc1[C:]) @ fc2), this warp's row
// slabs into O (Np x C float32; rows past N hold finite values that nothing
// reads). The whole block.
template <int C>
__device__ void stage1(float* smem, bf16* tiles, const bf16* hX, const bf16* qX,
                       const bf16* aX, const bf16* kvzY, const Tail& w, float* O, int N,
                       int slabs) {
  using L = Layout<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* SA = smem + warp * L::STRIP;
  float* SB = SA + 16 * L::LDA;
  float* SC = SB + 16 * L::LDB;
  for (int base = 0; base < slabs; base += RW) {
    const int s = base + warp, r0 = 16 * s;
    const bool active = s < slabs;
    if (active) load_rows<C>(SB, L::LDB, qX, r0, N);
    product_tiled<C, 2 * C>(tiles, active, Seg{SB, L::LDB, kvzY, C, 0}, nullptr,
                            [&](int r, int c, float v) { SA[r * L::LDA + c] = v; });
    if (active) {
      __syncwarp();
      for (int e = lane; e < 16 * C; e += 32) {
        const int r = e / C, c = e - r * C;
        SC[r * L::LDB + c] = SA[r * L::LDA + c] / (SA[r * L::LDA + C + c] + EPS);
      }
      __syncwarp();
    }
    product_tiled<C, C>(tiles, active, Seg{SC, L::LDB, w.merge, C, 0}, nullptr,
                        [&](int r, int c, float v) { SB[r * L::LDB + c] = v; });
    if (active) {
      __syncwarp();
      layer_norm_rows<C>(SB, L::LDB, w.ln1s, w.ln1b);
    }
    product_tiled<C, 2 * C>(tiles, active, Seg{SB, L::LDB, w.fc1, 2 * C, C}, nullptr,
                            [&](int r, int c, float v) {
                              const float a = r0 + r < N ? bf(aX + (size_t)(r0 + r) * 2 * C + c) : 0.f;
                              SA[r * L::LDA + c] = fmaxf(v + a, 0.f);
                            });
    if (active) __syncwarp();
    product_tiled<2 * C, C>(tiles, active, Seg{SA, L::LDA, w.fc2, 2 * C, 0}, nullptr,
                            [&](int r, int c, float v) { SC[r * L::LDB + c] = v; });
    if (active) {
      __syncwarp();
      layer_norm_rows<C>(SC, L::LDB, w.ln2s, w.ln2b);
      for (int e = lane; e < 16 * C; e += 32) {
        const int r = e / C, c = e - r * C;
        const float h = r0 + r < N ? bf(hX + (size_t)(r0 + r) * C + c) : 0.f;
        O[(size_t)(r0 + r) * C + c] = h + SC[r * L::LDB + c];
      }
      __syncwarp();
    }
  }
}

// The template summary of side X for the other direction's stage 2: k =
// elu1(O Wk), v = O Wv + pv, KV = bf16(k)^T bf16(v) on the heads' diagonal
// blocks (C x C float32, zero elsewhere) and ksum = sum k, over the N rows,
// into shared memory. The whole block.
template <int C>
__device__ void summary(float* smem, bf16* tiles, const float* O, const bf16* pvX,
                        const Weights& w, int N, int slabs, int D) {
  using L = Layout<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* SA = smem + warp * L::STRIP;
  float* SB = SA + 16 * L::LDA;
  float* KV = smem + L::KV;
  float* ks = smem + L::KS;
  for (int e = threadIdx.x; e < C * L::LDKV; e += THREADS) KV[e] = 0.f;
  if (threadIdx.x < C) ks[threadIdx.x] = 0.f;
  constexpr int MT = C / 16, NT = C / 8;
  for (int cb = 0; cb < slabs; cb += RW) {
    const int s = cb + warp, r0 = 16 * s;
    const bool active = s < slabs;
    if (active) load_rows<C>(SB, L::LDB, O, r0, N);
    product_tiled<C, 2 * C>(tiles, active, Seg{SB, L::LDB, w.kv2, C, 0}, nullptr,
                            [&](int r, int c, float v) {
                              if (c < C) {
                                v = elu1(v);
                              } else if (r0 + r < N) {
                                v += bf(pvX + (size_t)(r0 + r) * C + c - C);
                              }
                              SA[r * L::LDA + c] = r0 + r < N ? v : 0.f;   // rows past N add nothing
                            });
    if (!active)
      for (int e = lane; e < 16 * L::LDA; e += 32) SA[e] = 0.f;
    __syncthreads();                                   // the chunk's 64 rows of k | v
    // KV tiles (16 channels x 8 channels) that meet a head's diagonal block:
    // A (m, row) = k[row][m], B (row, n) = v[row][n], over the chunk's rows
    for (int tau = warp; tau < MT * NT; tau += RW) {
      const int mi = tau / NT, nj = tau - mi * NT;
      const int m_lo = 16 * mi / D, m_hi = (16 * mi + 15) / D;
      const int n_lo = 8 * nj / D, n_hi = (8 * nj + 7) / D;
      if (max(m_lo, n_lo) > min(m_hi, n_hi)) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k0 = 0; k0 < 16 * RW; k0 += 16) {
        // rows k0 + 2t, + 1 (a[0], a[1], b0) and k0 + 2t + 8, + 9 (a[2], a[3], b1)
        const float* r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = k0 + 2 * t + (i & 1) + 8 * (i >> 1);
          r[i] = smem + (rr >> 4) * L::STRIP + (rr & 15) * L::LDA;
        }
        const int m0 = 16 * mi + g, n = C + 8 * nj + g;
        const uint32_t a[4] = {pack_bf16(r[0][m0], r[1][m0]), pack_bf16(r[0][m0 + 8], r[1][m0 + 8]),
                               pack_bf16(r[2][m0], r[3][m0]), pack_bf16(r[2][m0 + 8], r[3][m0 + 8])};
        mma(acc, a, pack_bf16(r[0][n], r[1][n]), pack_bf16(r[2][n], r[3][n]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cr = 16 * mi + g + 8 * (e >> 1), cc = 8 * nj + 2 * t + (e & 1);
        if (cr / D == cc / D) KV[cr * L::LDKV + cc] += acc[e];
      }
    }
    if (threadIdx.x < C) {
      float sum = ks[threadIdx.x];
      for (int r = 0; r < 16 * RW; ++r)
        sum += smem[(r >> 4) * L::STRIP + (r & 15) * L::LDA + threadIdx.x];
      ks[threadIdx.x] = sum;
    }
    __syncthreads();                                   // the strips are free again
  }
}

// out[r][c] = epi(bf16(A) (16 x C strip) @ bf16(KV) (C x C float32 in shared
// memory, rows padded)) for a warp's slab, columns in runs of 64.
template <int C, class Epi>
__device__ __forceinline__ void product_kv(const float* A, int lda, const float* KV, Epi epi) {
  using L = Layout<C>;
  constexpr int NN = C / 8 < 8 ? C / 8 : 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int n0 = 0; n0 < C; n0 += 8 * NN) {
    float acc[NN][4];
    zero(acc);
#pragma unroll 2
    for (int kk = 0; kk < C / 16; ++kk) {
      const float* r = A + g * lda + kk * 16 + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(r);
      const float2 x1 = *reinterpret_cast<const float2*>(r + 8 * lda);
      const float2 x2 = *reinterpret_cast<const float2*>(r + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(r + 8 * lda + 8);
      const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                             pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
      const float* b = KV + (kk * 16 + 2 * t) * L::LDKV + n0 + g;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const float* bj = b + 8 * j;
        mma(acc[j], a, pack_bf16(bj[0], bj[L::LDKV]), pack_bf16(bj[8 * L::LDKV], bj[9 * L::LDKV]));
      }
    }
    epilogue<NN>(acc, n0, epi);
  }
}

// Stage 2 of the direction whose search side is O, against the summary in
// shared memory, then this warp's part of the pooling: pm / ps hold the
// maxima and sums of columns lane + 32 i over the rows it scored. The whole
// block.
template <int C>
__device__ void stage2(float* smem, bf16* tiles, const float* O, const Weights& w, int N,
                       int slabs, int H, int D, float (&pm)[(C + 31) / 32],
                       float (&ps)[(C + 31) / 32]) {
  using L = Layout<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* SA = smem + warp * L::STRIP;
  float* SB = SA + 16 * L::LDA;
  float* SC = SB + 16 * L::LDB;
  const float* KV = smem + L::KV;
  const float* ks = smem + L::KS;
  float* den = smem + L::DEN + warp * 16 * HMAX;
  for (int base = 0; base < slabs; base += RW) {
    const int s = base + warp, r0 = 16 * s;
    const bool active = s < slabs;
    if (active) load_rows<C>(SB, L::LDB, O, r0, N);
    product_tiled<C, C>(tiles, active, Seg{SB, L::LDB, w.q2, C, 0}, nullptr,
                        [&](int r, int c, float v) { SC[r * L::LDB + c] = elu1(v); });
    if (active) {
      __syncwarp();
      // the normaliser: bf16(q * ksum) summed over each head in float32
      if (lane < 16) {
        for (int hh = 0; hh < H; ++hh) {
          float d = 0.f;
          for (int c = hh * D; c < (hh + 1) * D; ++c) d += round_bf16(SC[lane * L::LDB + c] * ks[c]);
          den[lane * HMAX + hh] = d;
        }
      }
      __syncwarp();
      product_kv<C>(SC, L::LDB, KV, [&](int r, int c, float v) {
        SA[r * L::LDA + c] = v / (den[r * HMAX + c / D] + EPS);
      });
      __syncwarp();
    }
    product_tiled<C, C>(tiles, active, Seg{SA, L::LDA, w.s2.merge, C, 0}, nullptr,
                        [&](int r, int c, float v) { SC[r * L::LDB + c] = v; });
    if (active) {
      __syncwarp();
      layer_norm_rows<C>(SC, L::LDB, w.s2.ln1s, w.s2.ln1b);
    }
    const Seg fc1b{SC, L::LDB, w.s2.fc1, 2 * C, C};
    product_tiled<C, 2 * C>(tiles, active, Seg{SB, L::LDB, w.s2.fc1, 2 * C, 0}, &fc1b,
                            [&](int r, int c, float v) { SA[r * L::LDA + c] = fmaxf(v, 0.f); });
    if (active) __syncwarp();
    product_tiled<2 * C, C>(tiles, active, Seg{SA, L::LDA, w.s2.fc2, 2 * C, 0}, nullptr,
                            [&](int r, int c, float v) { SC[r * L::LDB + c] = v; });
    if (active) {
      __syncwarp();
      layer_norm_rows<C>(SC, L::LDB, w.s2.ln2s, w.s2.ln2b);
#pragma unroll
      for (int i = 0; i < (C + 31) / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < C) {
          for (int r = 0; r < 16 && r0 + r < N; ++r) {
            const float v = SB[r * L::LDB + c] + SC[r * L::LDB + c];
            pm[i] = fmaxf(pm[i], v);
            ps[i] += v;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
match_rows_bf16_kernel(Side T, Side Dt, Weights w, const int* __restrict__ t_idx,
                       const int* __restrict__ d_idx, bf16* __restrict__ out,
                       float* __restrict__ scratch, int nt, int nd, int P, int N, int H) {
  using L = Layout<C>;
  constexpr int CPL = (C + 31) / 32;           // pooled columns a lane
  extern __shared__ __align__(16) float smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem + L::TILES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Np = (N + 15) / 16 * 16, slabs = Np / 16;
  const int D = C / H;
  float* part = smem + L::PART;
  float* O0 = scratch + (size_t)blockIdx.x * 2 * Np * C;   // the track side's stage-1 output
  float* O1 = O0 + (size_t)Np * C;                          // the det side's
  const size_t nc = (size_t)N * C;

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    int ti, dj;
    if (t_idx != nullptr) {          // pair list, range-checked by the wrapper;
                                     // the clamp only bounds the reads
      ti = min(max(t_idx[p], 0), nt - 1);
      dj = min(max(d_idx[p], 0), nd - 1);
    } else {
      ti = p / nd;
      dj = p - ti * nd;
    }
    stage1<C>(smem, tiles, T.h + ti * nc, T.q + ti * nc, T.a1 + ti * 2 * nc,
              Dt.kvz + (size_t)dj * 2 * C * C, w.s1, O0, N, slabs);
    stage1<C>(smem, tiles, Dt.h + dj * nc, Dt.q + dj * nc, Dt.a1 + dj * 2 * nc,
              T.kvz + (size_t)ti * 2 * C * C, w.s1, O1, N, slabs);
    float pm[CPL], ps[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      pm[i] = -__int_as_float(0x7f800000);
      ps[i] = 0.f;
    }
    // track -> det: the det side's O1 (with its pv) is the template
    summary<C>(smem, tiles, O1, Dt.pv + dj * nc, w, N, slabs, D);
    stage2<C>(smem, tiles, O0, w, N, slabs, H, D, pm, ps);
    __syncthreads();                             // the summary is read out
    summary<C>(smem, tiles, O0, T.pv + ti * nc, w, N, slabs, D);
    stage2<C>(smem, tiles, O1, w, N, slabs, H, D, pm, ps);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < C) {
        part[warp * 2 * C + c] = pm[i];
        part[warp * 2 * C + C + c] = ps[i];
      }
    }
    __syncthreads();
    if (threadIdx.x < C) {
      float mx = part[threadIdx.x], sm = part[C + threadIdx.x];
      for (int v = 1; v < RW; ++v) {
        mx = fmaxf(mx, part[v * 2 * C + threadIdx.x]);
        sm += part[v * 2 * C + C + threadIdx.x];
      }
      bf16* o = out + (size_t)p * 2 * C;
      o[threadIdx.x] = __float2bfloat16_rn(mx);
      o[C + threadIdx.x] = __float2bfloat16_rn(sm * (1.f / (2.f * N)));
    }
    __syncthreads();                             // part and the summary are free
  }
}

// Bytes of shared memory for C, or 0 when the tier has no instantiation.
size_t smem_bytes(int C) { return C == 16 ? Layout<16>::BYTES : 0; }

// 0: the tier takes the shape; 1: no instantiation for C (16), or
// H does not divide C, or more than HMAX heads, or N < 1.
int layout_status(int N, int C, int H) {
  if (N < 1 || H < 1 || H > HMAX || C % H != 0 || smem_bytes(C) == 0) return 1;
  return smem_bytes(C) > SMEM_LIMIT ? 2 : 0;
}

template <int C>
int launch_c(const Side& T, const Side& Dt, const Weights& w, const int* t_idx, const int* d_idx,
             bf16* out, float* scratch, int nt, int nd, int P, int N, int H, int blocks,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      match_rows_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  match_rows_bf16_kernel<C><<<blocks, THREADS, smem, stream>>>(T, Dt, w, t_idx, d_idx, out,
                                                              scratch, nt, nd, P, N, H);
  return (int)cudaGetLastError();
}

Tail make_tail(const void* const* q) {
  return Tail{(const bf16*)q[0], (const float*)q[1], (const float*)q[2], (const bf16*)q[3],
              (const bf16*)q[4], (const float*)q[5], (const float*)q[6]};
}

Side make_side(const void* h, const void* q, const void* kvz, const void* a1, const void* pv) {
  return Side{(const bf16*)h, (const bf16*)q, (const bf16*)kvz, (const bf16*)a1,
              (const bf16*)pv};
}

}  // namespace

// The layout check of tier rows_mma: writes the bytes of shared memory the shape
// needs and the most a block may take, and returns layout_status.
extern "C" int pcr_match_rows_bf16_layout(int N, int C, int H, long long* bytes,
                                          long long* limit) {
  *bytes = (long long)smem_bytes(C);
  *limit = (long long)SMEM_LIMIT;
  return layout_status(N, C, H);
}

// Tier rows_mma, point head at bf16: 5 bf16 factors a side (h, q, kvz transposed to (n,
// 2C, C), a1, pv), the 16 weights in pcr_match_pooled's order (the matrices
// bf16 in (out, in) layout, the LayerNorm vectors float32), the pair lists
// (null in grid mode), the output (P, 2C) bf16, and a float32 scratch of
// blocks x 2 x Np x C; `blocks` blocks walk over the P pairs.
extern "C" int pcr_match_rows_bf16(
    const void* ht, const void* qt, const void* kvzt, const void* at, const void* pvt,
    const void* hd, const void* qd, const void* kvzd, const void* ad, const void* pvd,
    const void* merge1, const void* ln1s1, const void* ln1b1, const void* fc1_1,
    const void* fc2_1, const void* ln2s1, const void* ln2b1, const void* q2,
    const void* kv2, const void* merge2, const void* ln1s2, const void* ln1b2,
    const void* fc1_2, const void* fc2_2, const void* ln2s2, const void* ln2b2,
    const void* t_idx, const void* d_idx, void* out, void* scratch,
    int nt, int nd, int P, int N, int C, int H, int blocks, void* stream) {
  if (P <= 0 || blocks <= 0 || layout_status(N, C, H) != 0) return (int)cudaErrorInvalidValue;
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  Weights w;
  w.s1 = make_tail(ws);
  w.q2 = (const bf16*)ws[7];
  w.kv2 = (const bf16*)ws[8];
  w.s2 = make_tail(ws + 9);
  const Side T = make_side(ht, qt, kvzt, at, pvt), Dt = make_side(hd, qd, kvzd, ad, pvd);
  const int* ti = (const int*)t_idx;
  const int* di = (const int*)d_idx;
  bf16* o = (bf16*)out;
  float* sc = (float*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  return launch_c<16>(T, Dt, w, ti, di, o, sc, nt, nd, P, N, H, blocks, s);
}

ROWS_WG_ENTRIES(rowswg::Bf16, _bf16)
