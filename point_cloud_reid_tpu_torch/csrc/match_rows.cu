// Fused per-pair match chain, tier ROWS: the point head at the widths and
// row counts that the cluster tier of csrc/match_grid.cu does not hold in
// shared memory. The same function as that kernel, grid or pair list:
//
//   stage 1, both directions, from the hoisted per-object factors:
//     msg  = per head (q . KV) / (q . ksum + eps)        [KV | Z] = kvz
//     o_a  = search + LN2(relu(a1 + LN1(msg @ merge) @ fc1[C:]) @ fc2)
//   stage 2, both directions, full cross linear attention:
//     q = elu1(o_search @ Wq); k = elu1(o_templ @ Wk); v = o_templ @ Wv + pv
//     msg = per head (q . k^T v) / (q . sum k + eps), then the same FFN tail
//     with fc1[:C] applied to o_search
//   point-cat pooling: max and mean over the 2N rows of both outputs.
//
// It replaces the same TPU kernels, point_cloud_reid_tpu/ops/pallas/
// match_grid.py fused_match_grid (:250) and fused_match_pairs (:355), for
// C = 128 (the 1.5M and 7M models, any N) and for C = 64 past the cluster
// tier's 224 rows (a model served on crops of N points scores N rows a
// side: the point-count ablations serve up to 2048). kernels/match_grid.py's
// plan(N, C, H) picks the tier.
//
// What bounds it on the H100: 80 N C^2 flops a pair, three TF32 passes
// each, against 495 TFLOP/s (16.7 ms for a 128 x 128 grid at C = 128,
// N = 128; 2.0 ms for 512 pairs at C = 64, N = 2048).
//
// Tier "rows" (C = 64, 128): csrc/match_rows_wg.cuh with policy Tf32, every
// product three wgmma m64n64k8 TF32 passes (hi*hi + hi*lo + lo*hi): A split
// in registers once a k-panel as csrc/tf32_mma.cuh splits, B's hi and lo
// halves from the stage (the wrapper splits the weights once, the kernel its
// own KV). What held its first version (below) back and what the
// new structure does, in the header's four points: four warps an SM -> two
// consumer warpgroups (a side each) and a producer; two block barriers a
// 32 x 64 weight tile serving 64 rows -> a ring of 16 KB cp.async.bulk
// stages (hi and lo) with mbarriers, each serving 128 rows; every fragment
// split anew and B packed from a float32 C x C summary -> A split once a
// panel in registers, the summary's diagonal band split once into stages;
// LayerNorm row by row from shared memory -> in registers on the
// accumulators.
//
// Tier "rows_mma" (C = 16, which no registered leaf reaches here: the
// cluster tier holds 2,048 rows at C = 16): the first version, kept.
// The cluster tier stages 8 C^2 floats of weights and a side's stage-1
// output O (N x (C + 4)) in one block's shared memory; here nothing that
// grows with N or with C^2 beyond one C x C summary stays in shared memory:
//  - a block scores one pair at a time, both directions in turn, and walks
//    over the pairs (p = block, block + grid, ...); each block owns a slot
//    of a device scratch that holds the pair's two stage-1 outputs
//    (2 x Np x C floats, Np = N rounded up to 16), so the scratch is
//    blocks x 2 Np C floats however many pairs there are;
//  - the weights stay in device memory, where every block finds them in L2
//    (17 C^2 floats, 1.1 MB at C = 128); a product stages one weight in
//    tiles of 32 rows x 64 columns through a cp.async double buffer that
//    the block's 4 warps share, so each tile crosses from L2 once a block
//    for 4 slabs, not once a warp;
//  - each of the 4 warps carries 16-row slabs through the row-local chain
//    in three strips of shared memory (16 x 2C and twice 16 x C), one
//    product at a time, columns in runs of 64, so a thread holds 32
//    accumulators at any C; the warps walk their slabs in lockstep (a warp
//    without a slab in a round still stages its share of the tiles);
//  - the template summary of a direction is k^T v over every row: the warps
//    project 64 rows at a time into their strips, then add the chunk's
//    k^T v into a C x C summary in shared memory, only the 16 x 8 tiles
//    that meet a head's diagonal block (half of them at 2 heads), and the
//    chunk's column sums of k into ksum. The stage-2 denominator is the
//    dot product of a row's q with ksum over each head, not a product with
//    the head mask.
// Grid and pair mode run the same per-pair code, and a pair's result does
// not depend on the block or slot that scores it, so a pair is equal bit
// for bit to its grid cell. The summation orders differ from the cluster
// tier's and the plain version's, within MATCH_TOL.
//
// Products: mma.sync m16n8k8 TF32, three passes (tf32_mma.cuh), as in the
// cluster tier. LayerNorm, elu+1, split-norm, ReLU and pooling stay float32
// on the CUDA cores.
//
// With 4 warps a block and one or two blocks an SM, the block barriers of
// each tile and the split of every fragment bound it, not the tensor cores
// (122.5 ms for the 7M model's grid, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_rows_wg.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int RW = 4;                         // warps a block
constexpr int THREADS = 32 * RW;
constexpr int HMAX = 8;                       // most heads
constexpr int KT = 32;                        // rows of a weight tile
constexpr int LDT = 72;                       // padded row of a weight tile (64 columns)
constexpr size_t SMEM_LIMIT = 232448;         // dynamic shared memory a block may take
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;

struct Side {         // per-object factors of one side
  const float* h;     // (n, N, C)
  const float* q;     // (n, N, C)   elu+1 stage-1 queries
  const float* kvz;   // (n, C, 2C)  [KV | diag(ksum) @ head mask]
  const float* a1;    // (n, N, 2C)  h @ stage1.fc1[:C]
  const float* pv;    // (n, N, C)   stage-2 pos-MLP @ v_proj
};

struct Tail {         // merge -> LN -> FFN -> LN weights of one stage
  const float* merge; const float* ln1s; const float* ln1b;
  const float* fc1; const float* fc2; const float* ln2s; const float* ln2b;
};

struct Weights {
  Tail s1, s2;
  const float* q2;    // (C, C)
  const float* kv2;   // (C, 2C) = [Wk | Wv]
};

// Shared-memory layout for channel count C, in floats: per warp the strips
// A (16 x 2C), B and Cs (16 x C), rows padded by 4 (A fragments free of
// bank conflicts); then the summary KV (C x C, rows padded by 8: B
// fragments free of bank conflicts), ksum, the stage-2 denominators (16
// rows x HMAX heads a warp), the pooling partials (2C a warp) and the two
// weight tiles (KT x LDT each).
template <int C> struct Layout {
  static constexpr int LDA = 2 * C + 4;
  static constexpr int LDB = C + 4;
  static constexpr int STRIP = 16 * (LDA + 2 * LDB);
  static constexpr int LDKV = C + 8;
  static constexpr int KV = RW * STRIP;
  static constexpr int KS = KV + C * LDKV;
  static constexpr int DEN = KS + C;
  static constexpr int PART = DEN + RW * 16 * HMAX;
  static constexpr int TILES = PART + RW * 2 * C;
  static constexpr int FLOATS = TILES + 2 * KT * LDT;
};

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[j] += A (16 x K, a strip: row-major, leading dimension lda) @ B (K
// rows in shared memory, leading dimension ldb) for columns n0 + 8 j ...
template <int K, int NN>
__device__ __forceinline__ void mm(float (&acc)[NN][4], const float* A, int lda,
                                   const float* B, int ldb, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < K / 8; ++kk) {
    const float* r = A + g * lda + kk * 8 + t;
    const float a[4] = {r[0], r[8 * lda], r[4], r[8 * lda + 4]};
    const tf32::AFrag f = tf32::split_a(a);
    const float* b = B + (size_t)(kk * 8 + t) * ldb + n0 + g;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      tf32::mma3(acc[j], f, tf32::split_b(b[8 * j], b[4 * ldb + 8 * j]));
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <int NN, class Epi>
__device__ __forceinline__ void epilogue(const float (&acc)[NN][4], int n0, Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) epi(g + 8 * (e >> 1), n0 + 8 * j + 2 * t + (e & 1), acc[j][e]);
}

// out = epi(A @ B) for the COLS columns of a warp's slab, B (K x COLS) in
// shared memory; epi(row, col, value) stores one element (rows 0..15).
template <int K, int COLS, class Epi>
__device__ __forceinline__ void product(const float* A, int lda, const float* B, int ldb, Epi epi) {
  constexpr int NN = COLS / 8 < 8 ? COLS / 8 : 8;
  for (int n0 = 0; n0 < COLS; n0 += 8 * NN) {
    float acc[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    mm<K, NN>(acc, A, lda, B, ldb, n0);
    epilogue<NN>(acc, n0, epi);
  }
}

// One factor of a product: a warp's strip A (16 x K) and a weight B (K
// rows, leading dimension ldb) in device memory.
struct Seg { const float* A; int lda; const float* B; int ldb; };

// out = epi(A1 @ B1 [+ A2 @ B2]) for the COLS columns of every warp's slab,
// the weights staged through the block's double-buffered tiles (KT rows x
// 64 columns, cp.async). The whole block calls it; a warp that is not
// `active` stages its share of the tiles and computes nothing. The sums
// run over k in the order of product().
template <int K, int COLS, class Epi>
__device__ __forceinline__ void product_tiled(float* tiles, bool active, const Seg& s0,
                                              const Seg* s1, Epi epi) {
  constexpr int NN = COLS / 8 < 8 ? COLS / 8 : 8;
  constexpr int W = 8 * NN;                    // columns a run
  constexpr int R = K < KT ? K : KT;           // rows a tile
  constexpr int TPS = K / R;                   // tiles a factor
  const int ntiles = s1 != nullptr ? 2 * TPS : TPS;
  for (int n0 = 0; n0 < COLS; n0 += W) {
    auto issue = [&](int it) {
      const Seg& sg = it < TPS ? s0 : *s1;
      const float* src = sg.B + (size_t)(it % TPS) * R * sg.ldb + n0;
      float* dst = tiles + (it & 1) * KT * LDT;
      for (int e = threadIdx.x; e < R * W / 4; e += THREADS) {
        const int r = e / (W / 4), c = 4 * (e - r * (W / 4));
        cp_async16(dst + r * LDT + c, src + (size_t)r * sg.ldb + c);
      }
      cp_commit();
    };
    float acc[NN][4];
#pragma unroll
    for (int j = 0; j < NN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
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
        mm<R, NN>(acc, sg.A + (it % TPS) * R, sg.lda, tiles + (it & 1) * KT * LDT, LDT, 0);
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

// Copy rows r0 .. r0 + 15 of an (N, C) matrix into a strip; rows past N
// read as 0.
template <int C>
__device__ __forceinline__ void load_rows(float* S, int ld, const float* src, int r0, int N) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * C; e += 32) {
    const int r = e / C, c = e - r * C;
    S[r * ld + c] = r0 + r < N ? src[(size_t)(r0 + r) * C + c] : 0.f;
  }
  __syncwarp();
}

// Stage 1 of side X against the other side's [KV | Z]: O = h + LN2(relu(a1
// + LN1(split_norm(q @ kvzY) @ merge) @ fc1[C:]) @ fc2), this warp's row
// slabs into O (Np x C; rows past N hold finite values that nothing reads).
// The whole block.
template <int C>
__device__ void stage1(float* smem, const float* hX, const float* qX, const float* aX,
                       const float* kvzY, const Tail& w, float* O, int N, int slabs) {
  using L = Layout<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* SA = smem + warp * L::STRIP;
  float* SB = SA + 16 * L::LDA;
  float* SC = SB + 16 * L::LDB;
  float* tiles = smem + L::TILES;
  for (int base = 0; base < slabs; base += RW) {
    const int s = base + warp, r0 = 16 * s;
    const bool active = s < slabs;
    if (active) load_rows<C>(SB, L::LDB, qX, r0, N);
    product_tiled<C, 2 * C>(tiles, active, Seg{SB, L::LDB, kvzY, 2 * C}, nullptr,
                            [&](int r, int c, float v) { SA[r * L::LDA + c] = v; });
    if (active) {
      __syncwarp();
      for (int e = lane; e < 16 * C; e += 32) {
        const int r = e / C, c = e - r * C;
        SC[r * L::LDB + c] = SA[r * L::LDA + c] / (SA[r * L::LDA + C + c] + EPS);
      }
      __syncwarp();
    }
    product_tiled<C, C>(tiles, active, Seg{SC, L::LDB, w.merge, C}, nullptr,
                        [&](int r, int c, float v) { SB[r * L::LDB + c] = v; });
    if (active) {
      __syncwarp();
      layer_norm_rows<C>(SB, L::LDB, w.ln1s, w.ln1b);
    }
    product_tiled<C, 2 * C>(tiles, active, Seg{SB, L::LDB, w.fc1 + (size_t)C * 2 * C, 2 * C},
                            nullptr, [&](int r, int c, float v) {
                              const float a = r0 + r < N ? __ldg(aX + (size_t)(r0 + r) * 2 * C + c) : 0.f;
                              SA[r * L::LDA + c] = fmaxf(v + a, 0.f);
                            });
    if (active) __syncwarp();
    product_tiled<2 * C, C>(tiles, active, Seg{SA, L::LDA, w.fc2, C}, nullptr,
                            [&](int r, int c, float v) { SC[r * L::LDB + c] = v; });
    if (active) {
      __syncwarp();
      layer_norm_rows<C>(SC, L::LDB, w.ln2s, w.ln2b);
      for (int e = lane; e < 16 * C; e += 32) {
        const int r = e / C, c = e - r * C;
        const float h = r0 + r < N ? __ldg(hX + (size_t)(r0 + r) * C + c) : 0.f;
        O[(size_t)(r0 + r) * C + c] = h + SC[r * L::LDB + c];
      }
      __syncwarp();
    }
  }
}

// The template summary of side X for the other direction's stage 2: k =
// elu1(O Wk), v = O Wv + pv, KV = k^T v on the heads' diagonal blocks (C x
// C, zero elsewhere) and ksum = sum k, over the N rows, into shared memory.
// The whole block; the warps keep the slabs they had in stage 1.
template <int C, bool POS>
__device__ void summary(float* smem, const float* O, const float* pvX, const Weights& w,
                        int N, int slabs, int D) {
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
    product_tiled<C, 2 * C>(smem + L::TILES, active, Seg{SB, L::LDB, w.kv2, 2 * C}, nullptr,
                            [&](int r, int c, float v) {
                              if (c < C) {
                                v = elu1(v);
                              } else if (POS && r0 + r < N) {
                                v += __ldg(pvX + (size_t)(r0 + r) * C + c - C);
                              }
                              SA[r * L::LDA + c] = r0 + r < N ? v : 0.f;   // rows past N add nothing
                            });
    if (!active)
      for (int e = lane; e < 16 * L::LDA; e += 32) SA[e] = 0.f;
    __syncthreads();                                   // the chunk's 64 rows of k | v
    // KV tiles (16 channels x 8 channels) that meet a head's diagonal block:
    // A = k^T (A(m, n) = k[n][m]), B = v, over the chunk's rows n
    for (int tau = warp; tau < MT * NT; tau += RW) {
      const int mi = tau / NT, nj = tau - mi * NT;
      const int m_lo = 16 * mi / D, m_hi = (16 * mi + 15) / D;
      const int n_lo = 8 * nj / D, n_hi = (8 * nj + 7) / D;
      if (max(m_lo, n_lo) > min(m_hi, n_hi)) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int k0 = 0; k0 < 16 * RW; k0 += 8) {
        const int ra = k0 + t, rb = ra + 4;
        const float* ka = smem + (ra >> 4) * L::STRIP + (ra & 15) * L::LDA;
        const float* kb = smem + (rb >> 4) * L::STRIP + (rb & 15) * L::LDA;
        const float a[4] = {ka[16 * mi + g], ka[16 * mi + g + 8], kb[16 * mi + g],
                            kb[16 * mi + g + 8]};
        tf32::mma3(acc, tf32::split_a(a), tf32::split_b(ka[C + 8 * nj + g], kb[C + 8 * nj + g]));
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

// Stage 2 of the direction whose search side is O, against the summary in
// shared memory, then this warp's part of the pooling: pm / ps hold the
// maxima and sums of columns lane + 32 i over the rows it scored. The whole
// block.
template <int C>
__device__ void stage2(float* smem, const float* O, const Weights& w, int N, int slabs, int H,
                       int D, float (&pm)[(C + 31) / 32], float (&ps)[(C + 31) / 32]) {
  using L = Layout<C>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* SA = smem + warp * L::STRIP;
  float* SB = SA + 16 * L::LDA;
  float* SC = SB + 16 * L::LDB;
  const float* KV = smem + L::KV;
  const float* ks = smem + L::KS;
  float* den = smem + L::DEN + warp * 16 * HMAX;
  float* tiles = smem + L::TILES;
  for (int base = 0; base < slabs; base += RW) {
    const int s = base + warp, r0 = 16 * s;
    const bool active = s < slabs;
    if (active) load_rows<C>(SB, L::LDB, O, r0, N);
    product_tiled<C, C>(tiles, active, Seg{SB, L::LDB, w.q2, C}, nullptr,
                        [&](int r, int c, float v) { SC[r * L::LDB + c] = elu1(v); });
    if (active) {
      __syncwarp();
      if (lane < 16) {
        for (int hh = 0; hh < H; ++hh) {
          float d = 0.f;
          for (int c = hh * D; c < (hh + 1) * D; ++c) d += SC[lane * L::LDB + c] * ks[c];
          den[lane * HMAX + hh] = d;
        }
      }
      __syncwarp();
      product<C, C>(SC, L::LDB, KV, L::LDKV, [&](int r, int c, float v) {
        SA[r * L::LDA + c] = v / (den[r * HMAX + c / D] + EPS);
      });
      __syncwarp();
    }
    product_tiled<C, C>(tiles, active, Seg{SA, L::LDA, w.s2.merge, C}, nullptr,
                        [&](int r, int c, float v) { SC[r * L::LDB + c] = v; });
    if (active) {
      __syncwarp();
      layer_norm_rows<C>(SC, L::LDB, w.s2.ln1s, w.s2.ln1b);
    }
    const Seg fc1b{SC, L::LDB, w.s2.fc1 + (size_t)C * 2 * C, 2 * C};
    product_tiled<C, 2 * C>(tiles, active, Seg{SB, L::LDB, w.s2.fc1, 2 * C}, &fc1b,
                            [&](int r, int c, float v) { SA[r * L::LDA + c] = fmaxf(v, 0.f); });
    if (active) __syncwarp();
    product_tiled<2 * C, C>(tiles, active, Seg{SA, L::LDA, w.s2.fc2, C}, nullptr,
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

template <int C, bool POS>
__global__ void __launch_bounds__(THREADS)
match_rows_kernel(Side T, Side Dt, Weights w, const int* __restrict__ t_idx,
                  const int* __restrict__ d_idx, float* __restrict__ out,
                  float* __restrict__ scratch, int nt, int nd, int P, int N, int H) {
  using L = Layout<C>;
  constexpr int CPL = (C + 31) / 32;           // pooled columns a lane
  extern __shared__ __align__(16) float smem[];
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
    stage1<C>(smem, T.h + ti * nc, T.q + ti * nc, T.a1 + ti * 2 * nc,
              Dt.kvz + (size_t)dj * 2 * C * C, w.s1, O0, N, slabs);
    stage1<C>(smem, Dt.h + dj * nc, Dt.q + dj * nc, Dt.a1 + dj * 2 * nc,
              T.kvz + (size_t)ti * 2 * C * C, w.s1, O1, N, slabs);
    float pm[CPL], ps[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      pm[i] = -__int_as_float(0x7f800000);
      ps[i] = 0.f;
    }
    // track -> det: the det side's O1 (with its pv) is the template
    summary<C, POS>(smem, O1, POS ? Dt.pv + dj * nc : nullptr, w, N, slabs, D);
    stage2<C>(smem, O0, w, N, slabs, H, D, pm, ps);
    __syncthreads();                             // the summary is read out
    summary<C, POS>(smem, O0, POS ? T.pv + ti * nc : nullptr, w, N, slabs, D);
    stage2<C>(smem, O1, w, N, slabs, H, D, pm, ps);
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
      float* o = out + (size_t)p * 2 * C;
      o[threadIdx.x] = mx;
      o[C + threadIdx.x] = sm * (1.f / (2.f * N));
    }
    __syncthreads();                             // part and the summary are free
  }
}

// Bytes of shared memory for C, or 0 when the tier has no instantiation.
size_t smem_bytes(int C) { return C == 16 ? Layout<16>::FLOATS * sizeof(float) : 0; }

// 0: the tier takes the shape; 1: no instantiation for C (16), or
// H does not divide C, or more than HMAX heads, or N < 1.
int layout_status(int N, int C, int H) {
  if (N < 1 || H < 1 || H > HMAX || C % H != 0 || smem_bytes(C) == 0) return 1;
  return smem_bytes(C) > SMEM_LIMIT ? 2 : 0;
}

template <int C>
int launch_c(const Side& T, const Side& Dt, const Weights& w, const int* t_idx, const int* d_idx,
             float* out, float* scratch, int nt, int nd, int P, int N, int H, int blocks,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      match_rows_kernel<C, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  match_rows_kernel<C, true><<<blocks, THREADS, smem, stream>>>(T, Dt, w, t_idx, d_idx, out,
                                                                 scratch, nt, nd, P, N, H);
  return (int)cudaGetLastError();
}

Tail make_tail(const void* const* q) {
  return Tail{(const float*)q[0], (const float*)q[1], (const float*)q[2], (const float*)q[3],
              (const float*)q[4], (const float*)q[5], (const float*)q[6]};
}

Side make_side(const void* h, const void* q, const void* kvz, const void* a1, const void* pv) {
  return Side{(const float*)h, (const float*)q, (const float*)kvz, (const float*)a1,
              (const float*)pv};
}

}  // namespace

// The layout check of tier rows_mma: writes the bytes of shared memory the shape
// needs and the most a block may take, and returns layout_status.
extern "C" int pcr_match_rows_layout(int N, int C, int H, long long* bytes, long long* limit) {
  *bytes = (long long)smem_bytes(C);
  *limit = (long long)SMEM_LIMIT;
  return layout_status(N, C, H);
}

// Tier rows_mma, point head: 5 factors a side (h, q, kvz, a1, pv), the 16 weights in
// pcr_match_pooled's order, the pair lists (null in grid mode), the output,
// and a scratch of blocks x 2 x Np x C floats; `blocks` blocks walk over
// the P pairs.
extern "C" int pcr_match_rows(
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
  w.q2 = (const float*)ws[7];
  w.kv2 = (const float*)ws[8];
  w.s2 = make_tail(ws + 9);
  const Side T = make_side(ht, qt, kvzt, at, pvt), Dt = make_side(hd, qd, kvzd, ad, pvd);
  const int* ti = (const int*)t_idx;
  const int* di = (const int*)d_idx;
  float* o = (float*)out;
  float* sc = (float*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  return launch_c<16>(T, Dt, w, ti, di, o, sc, nt, nd, P, N, H, blocks, s);
}

ROWS_WG_ENTRIES(rowswg::Tf32, )
