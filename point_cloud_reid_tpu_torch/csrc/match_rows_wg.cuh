// The match chain's rows tier on Hopper's warpgroup products (wgmma), shared
// by its two dtypes: csrc/match_rows.cu instantiates it for a float32 model
// (policy Tf32: every product three TF32 passes, hi*hi + hi*lo + lo*hi, as
// csrc/tf32_mma.cuh splits), csrc/match_rows_bf16.cu for a bf16 model
// (policy Bf16: one bf16 pass, rounding where JAX's bf16 kernel rounds; the
// places are listed in csrc/match_grid_bf16.cu).
//
// It replaces point_cloud_reid_tpu/ops/pallas/match_grid.py
// fused_match_grid (:250) and fused_match_pairs (:355) for the point head at
// C = 64 and 128 wherever the cluster tier (csrc/match_grid{,_bf16}.cu) does
// not hold the shape: C = 128 (the 1.5M and 7M models) at any N, and C = 64
// past the cluster layout's rows (the point-count ablations served at their
// crop size, N up to 2048). kernels/match_grid.plan picks the tier; C = 16
// stays on the first version (tier "rows_mma" in those files).
// Every other width up to 128, heads of any width (up to HMAX = 16 heads;
// the exact instantiations take heads of 8 channels or more), and the
// image head (no position term: pv null) run through the PAD instantiations
// (csrc/match_rows_pad.cu, csrc/match_rows_pad_bf16.cu) in the padded
// layout of kernels/match_grid.pad_side at C = 64 or 128: the true a.ct
// channels first in a.H heads of a.D, zeros past them; one KV band of all C
// columns (KVN = C: a head may cross a 64-column band); the head of a
// column read as (c hm) >> 21 (head_of), the normaliser a head at a time;
// elu+1 of a padded stage-2 q or k lane masked to 0, the LayerNorm
// statistics over a.ct. The exact widths' instantiations are unchanged.
// Widths from 129 to 1024 (point and image head, exact or padded, up to
// WIDE_HMAX = 32 heads) run through the same PAD entry points on the wide
// kernel (rows_wide_kernel, below, at the next multiple of 128): the
// chain's C-wide rows in the device scratch in the operand stage layout,
// streamed through the ring as A stages of products that read both
// operands from shared memory, its outputs in 128-column groups, the
// summary's k and v once a tile and KV over the heads' diagonal
// units only.
//
// What bounds it on the H100: 80 N C^2 operations a pair; three TF32
// passes at 495 TFLOP/s (16.7 ms for the 7M model's 128 x 128 grid at
// N = 128) or one bf16 pass at 989 (2.8 ms). Each stage (64 rows of a
// weight x one 128-byte k-panel, 8 KB bf16 / 16 KB TF32 hi and lo) feeds
// 2 x 64 rows, so the weights also cross from L2 once per 128 rows: 15 C^2
// values a pass.
//
// What held the first version (tier rows_mma) back, and what this one does:
//  1. Four warps an SM (a 229-232 KB layout of float32 strips), each chain
//     of dependent mma.sync products with nothing to hide it. Here two
//     consumer warpgroups (one a side of the pair) carry 64-row m-tiles
//     through the chain in registers; nothing of the chain's rows stays in
//     shared memory, which holds the weight ring and the summary staging.
//  2. Two block barriers for every 64-column weight tile, each serving only
//     4 warps' 64 rows. Here the weights come through a ring of stages, one
//     cp.async.bulk a stage from a stage copy the wrapper lays out once
//     (kernels/match_grid.rows_stage_weights), filled by one producer thread
//     that gives its registers to the consumers (setmaxnreg); full / empty
//     mbarriers and no block barrier. A stage serves both warpgroups: one
//     m-tile of each side, 128 rows, so at N <= 64 a pair's rows of both
//     sides. (256 rows a stage at N = 128 would need a warpgroup to hold two
//     m-tiles' C-wide chain, 256 registers of accumulators at C = 128, or a
//     cluster with multicast stages; not done here.)
//  3. Operands re-formed at every fragment, B from a float32 C x C summary.
//     Here every product is wgmma m64n64 with A from registers (the last
//     product's accumulator, rounded to bf16 or split hi / lo at TF32 a
//     k-panel at a time; at bf16 two panels in flight) and B from the stage;
//     the message products read a side's summary as stages too, only its
//     heads' diagonal band, rounded or split once where it is written (the
//     other side's [KV | Z] by the wrapper for stage 1, the kernel's own KV
//     in the device scratch for stage 2).
//  4. LayerNorm row by row from shared memory. Here LayerNorm, elu+1,
//     split-norm, ReLU and the pooling run on the accumulators in registers,
//     a row's columns in one quad (shuffles over the quad).
//
// Per pair, both warpgroups in step (warpgroup w: side w; m-tile i of each
// side in turn):
//   stage 1:  q . KV of the other side (message stages) / (q . ksum per head,
//             in registers), merge, LN1, [fc1[C:] chunk + a1, ReLU, fc2] a
//             64-column hidden chunk at a time, LN2, O = h + y into the
//             device scratch (float32);
//   summary:  [k | v] = O [Wk | Wv] in 64-column chunks, elu+1 / + pv,
//             staged channel-major (bf16: stmatrix's transposing store; TF32:
//             hi and lo, 32 rows a summary tile, the m-tile's other 32 rows
//             fed zeros) and KV += k^T v (both operands from shared memory)
//             over the heads' diagonal band (64 or, at 128-channel heads,
//             128 columns an m-tile of channels); KV then goes to the scratch
//             as the other side's message stages, sum k to shared memory;
//   stage 2:  q = elu1(O Wq), a = O fc1[:C] (into the scratch), the message
//             of the other side's KV, the stage-1 tail, and the max / sum
//             pooling of O + y into per-warp partials.
// What bounds it now (PERF.md section 6, the rows tier): issuing each panel's
// chain of dependent products. A clock64() phase profile of a copy reads
// ~2,100 (bf16) / ~2,700 (TF32) cycles a stage against ~730 / ~830 with
// the products taken out, and little time waiting on stages or on wgmma
// groups. ptxas compiles the whole kernel to the launch's 168
// registers (setmaxnreg moves only the runtime split), so the C = 128
// chain spills and, at TF32, ptxas serialises the wgmmas.
// The per-pair code does not depend on the block or the pairs beside it, so
// a pair equals its grid cell bit for bit. The TF32 A fragments of k-step s
// are n-tile s of an accumulator, which puts its columns 2t, 2t + 1 at the
// fragment's k positions t, t + 4: every TF32 B operand holds its K in that
// order within each 8-group (tf32::k_pos), as the wrapper's stage copy and
// the kernel's KV stages lay it out.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace rowswg {

using bf16mma::bf16;
using bf16mma::desc_sw128;
using bf16mma::smem_addr;

constexpr int WGS = 2;                      // consumer warpgroups: one a side
constexpr int CWARPS = 4 * WGS;             // consumer warps
constexpr int THREADS = 128 * (WGS + 1);    // + the producer warpgroup
constexpr int TILE = 64;                    // rows of an m-tile
constexpr int HMAX = 16;                    // most heads (the normalisers' rows)
constexpr int RING_MAX = 16;                // most stages in the ring
constexpr size_t SMEM_LIMIT = 232448;       // dynamic shared memory a block may take
// registers a thread after setmaxnreg: 128 x (2 x 232 + 40) <= 65,536. (ptxas
// compiles the whole kernel to the launch's 168 all the same: what does not
// fit spills, and at TF32 it serialises the wgmmas, PERF.md.)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

template <int NT>
__device__ __forceinline__ void pin_u32(uint32_t (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(x[j][i])::"memory");
}

__device__ __forceinline__ void finish() {
  bf16mma::wg_commit();
  bf16mma::wg_wait<0>();
}

// ---- the two policies -------------------------------------------------------------

// One bf16 pass a product (a bf16 model).
struct Bf16 {
  typedef bf16 T;                       // factors and pooled output
  static constexpr int PK = 64;         // K columns a stage: one 128-byte panel
  static constexpr int SB = 8192;       // bytes a stage: 64 rows x 128
  static constexpr int SUM_ROWS = 64;   // rows a summary tile (128 bytes of K)
  static constexpr int ARRAYS = 2;      // summary staging: k^T, v^T
  static constexpr int VT = 1;          // v^T's array

  static __device__ __forceinline__ float2 ld2(const T* p) {
    return bf16mma::unpack_bf16(bf16mma::ldg32(p));
  }
  static __device__ __forceinline__ float round(float x) { return bf16mma::round_bf16(x); }
  static __device__ __forceinline__ void store(T* p, float x) { *p = __float2bfloat16_rn(x); }

  // The A fragments of a k-panel (4 k-steps), kept until its wgmmas are done.
  struct Frag {
    uint32_t a[4][4];
    __device__ __forceinline__ void pin() { pin_u32(a); }
  };
  static constexpr int DEPTH = 2;       // k-panels in flight a product

  // d[8 rb ..] += A's k-panel p (an accumulator-layout source, rounded to
  // bf16 into fresh fragments as JAX rounds a product's operand: n-tiles
  // 8 p .. 8 p + 7) @ stage st[rb] (64 output columns) for each rb < NB;
  // issued, not committed.
  template <int NB, int NTA, int NTD>
  static __device__ __forceinline__ void issue(float (&d)[NTD][4], const float (&a)[NTA][4], int p,
                                               const uint32_t (&st)[NB], Frag& f) {
#pragma unroll
    for (int s = 0; s < 4; ++s) bf16mma::a_from_acc(a, 4 * p + s, f.a[s]);
    bf16mma::wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int rb = 0; rb < NB; ++rb)   // the blocks' chains interleaved
        bf16mma::Wgmma<64>::rs(*reinterpret_cast<float(*)[8][4]>(&d[8 * rb][0]), f.a[s],
                               desc_sw128(st[rb] + 32 * s));
  }

  // kv += k^T (64 channels at kt) @ v (KVN channels at vt) over the summary
  // tile's rows (K). lo: the offset of the hi / lo arrays (unused).
  template <int KVN>
  static __device__ __forceinline__ void summary(float (&kv)[KVN / 8][4], uint32_t kt, uint32_t vt,
                                                 uint32_t) {
    bf16mma::wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      bf16mma::Wgmma<KVN>::ss(kv, desc_sw128(kt + 32 * s), desc_sw128(vt + 32 * s));
    finish();
    bf16mma::wg_pin(kv);
  }

  // A 64-row x 64-channel chunk of k or v (channels ch0 ..) into a staging
  // array, channel-major (the tile's rows are K): the fragments' 8 x 8
  // blocks stored transposed, four a stmatrix.
  static __device__ __forceinline__ void stage_chunk(unsigned char* arr, int, int ch0,
                                                     const float (&e)[8][4], int wq, int lane) {
    uint32_t pk[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pk[j][0] = bf16mma::pack_bf16(e[j][0], e[j][1]);
      pk[j][1] = bf16mma::pack_bf16(e[j][2], e[j][3]);
    }
    const uint32_t base = smem_addr(arr);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int m = lane >> 3, c = ch0 + 8 * j + 8 * (m >> 1) + (lane & 7);
      bf16mma::stmatrix_x4_trans(base + c * 128 + (((2 * wq + (m & 1)) ^ (c & 7)) << 4), pk[j][0],
                                 pk[j][1], pk[j + 1][0], pk[j + 1][1]);
    }
  }

  // Element (row, k position pos) of a B stage at `stage`: x rounded to bf16.
  static __device__ __forceinline__ void put_b(unsigned char* stage, int row, int pos, float x) {
    *reinterpret_cast<bf16*>(stage + row * 128 + (((pos >> 3) ^ (row & 7)) << 4) + (pos & 7) * 2) =
        __float2bfloat16_rn(x);
  }

  // ---- the wide kernel's operands, K in its natural order (A from shared
  // memory too) ----
  // Element (row, k) of a stage, k < PK: x rounded to bf16.
  static __device__ __forceinline__ void put_n(unsigned char* stage, int row, int k, float x) {
    put_b(stage, row, k, x);
  }
  // A 128-column group of the warp's rows (m-tile rows rl, rl + 8) into an
  // A buffer, columns c0 ..: n-tiles 2k, 2k + 1 of a row are one 32-byte
  // sector (the swizzle keeps the pair of 16-byte units together), so the
  // lanes of rows g and g ^ 1 trade a value (shfl.xor 4) and each store
  // writes whole sectors of 4 rows.
  static __device__ __forceinline__ void put_group(unsigned char* buf, int rl, int c0,
                                                   const float (&y)[16][4]) {
    const int t = threadIdx.x & 3, odd = (threadIdx.x >> 2) & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rl + 8 * h;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t v0 = bf16mma::pack_bf16(y[2 * k][2 * h], y[2 * k][2 * h + 1]);
        const uint32_t v1 = bf16mma::pack_bf16(y[2 * k + 1][2 * h], y[2 * k + 1][2 * h + 1]);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const int c = c0 + 8 * (2 * k + odd) + 2 * t;   // this lane's n-tile of the pair
        unsigned char* st = buf + (size_t)(c >> 6) * SB;
        const int ra = row - odd, rb = row + 1 - odd;      // the pair's rows
        *reinterpret_cast<uint32_t*>(st + ra * 128 + ((((c & 63) >> 3) ^ (ra & 7)) << 4) +
                                     (c & 7) * 2) = odd ? got : v0;
        *reinterpret_cast<uint32_t*>(st + rb * 128 + ((((c & 63) >> 3) ^ (rb & 7)) << 4) +
                                     (c & 7) * 2) = odd ? v1 : got;
      }
    }
  }
  // d[8 rb ..] += A stage a @ B stage b[rb], rb = 0, 1 (both from shared
  // memory); issued, not committed.
  static __device__ __forceinline__ void issue_ss(float (&d)[16][4], uint32_t a, uint32_t b0,
                                                  uint32_t b1) {
    bf16mma::wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      bf16mma::Wgmma<64>::ss(*reinterpret_cast<float(*)[8][4]>(&d[0][0]), desc_sw128(a + 32 * s),
                             desc_sw128(b0 + 32 * s));
      bf16mma::Wgmma<64>::ss(*reinterpret_cast<float(*)[8][4]>(&d[8][0]), desc_sw128(a + 32 * s),
                             desc_sw128(b1 + 32 * s));
    }
  }
};

// Three TF32 passes a product (a float32 model).
struct Tf32 {
  typedef float T;
  static constexpr int PK = 32;         // K columns a stage: one 128-byte panel
  static constexpr int SB = 16384;      // bytes a stage: hi (64 rows x 128), then lo
  static constexpr int HALF = 8192;
  static constexpr int SUM_ROWS = 32;   // rows a summary tile (128 bytes of K)
  static constexpr int ARRAYS = 4;      // summary staging: k^T, its lo, v^T, its lo
  static constexpr int VT = 2;

  static __device__ __forceinline__ float2 ld2(const T* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(T* p, float x) { *p = x; }

  struct Frag {
    uint32_t hi[4][4], lo[4][4];
    __device__ __forceinline__ void pin() {
      pin_u32(hi);
      pin_u32(lo);
    }
  };
  // k-panels in flight a product: two panels' split A would add 32
  // registers where ptxas already serialises for want of them
  static constexpr int DEPTH = 1;

  // As Bf16::issue with k-panels of 32 (n-tiles 4 p .. 4 p + 3), A split
  // once a panel, three passes the small terms first.
  template <int NB, int NTA, int NTD>
  static __device__ __forceinline__ void issue(float (&d)[NTD][4], const float (&a)[NTA][4], int p,
                                               const uint32_t (&st)[NB], Frag& f) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float x[4];
      tf32::a_from_acc(a[4 * p + s], x);
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32::split_tf32(x[i], f.hi[s][i], f.lo[s][i]);
    }
    bf16mma::wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) {   // the blocks' chains interleaved
        float(&dd)[8][4] = *reinterpret_cast<float(*)[8][4]>(&d[8 * rb][0]);
        const uint64_t bh = desc_sw128(st[rb] + 32 * s), bl = desc_sw128(st[rb] + HALF + 32 * s);
        tf32::Wgmma<64>::rs(dd, f.lo[s], bh);
        tf32::Wgmma<64>::rs(dd, f.hi[s], bl);
        tf32::Wgmma<64>::rs(dd, f.hi[s], bh);
      }
  }

  template <int KVN>
  static __device__ __forceinline__ void summary(float (&kv)[KVN / 8][4], uint32_t kt, uint32_t vt,
                                                 uint32_t lo) {
    bf16mma::wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      tf32::Wgmma<KVN>::ss(kv, desc_sw128(kt + lo + 32 * s), desc_sw128(vt + 32 * s));
      tf32::Wgmma<KVN>::ss(kv, desc_sw128(kt + 32 * s), desc_sw128(vt + lo + 32 * s));
      tf32::Wgmma<KVN>::ss(kv, desc_sw128(kt + 32 * s), desc_sw128(vt + 32 * s));
    }
    finish();
    bf16mma::wg_pin(kv);
  }

  // The summary tile's 32 rows (warps 0 and 1 of the m-tile) of a chunk
  // into a staging array (hi, then its lo array `lo` bytes on),
  // channel-major.
  static __device__ __forceinline__ void stage_chunk(unsigned char* arr, int lo, int ch0,
                                                     const float (&e)[8][4], int wq, int lane) {
    if (wq >= 2) return;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * wq + g + 8 * (i >> 1), c = ch0 + 8 * j + 2 * t + (i & 1);
        uint32_t h, l;
        tf32::split_tf32(e[j][i], h, l);
        unsigned char* q = arr + c * 128 + (((r >> 2) ^ (c & 7)) << 4) + (r & 3) * 4;
        *reinterpret_cast<uint32_t*>(q) = h;
        *reinterpret_cast<uint32_t*>(q + lo) = l;
      }
  }

  // Element (row, real k index pos within the stage) of a B stage: hi and
  // lo at its k position.
  static __device__ __forceinline__ void put_b(unsigned char* stage, int row, int pos, float x) {
    const int pp = (pos & ~7) | tf32::k_pos(pos & 7);
    unsigned char* q = stage + row * 128 + (((pp >> 2) ^ (row & 7)) << 4) + (pp & 3) * 4;
    uint32_t h, l;
    tf32::split_tf32(x, h, l);
    *reinterpret_cast<uint32_t*>(q) = h;
    *reinterpret_cast<uint32_t*>(q + HALF) = l;
  }

  // ---- the wide kernel's operands, K in its natural order ----
  static __device__ __forceinline__ void put_n(unsigned char* stage, int row, int k, float x) {
    unsigned char* q = stage + row * 128 + (((k >> 2) ^ (row & 7)) << 4) + (k & 3) * 4;
    uint32_t h, l;
    tf32::split_tf32(x, h, l);
    *reinterpret_cast<uint32_t*>(q) = h;
    *reinterpret_cast<uint32_t*>(q + HALF) = l;
  }
  static __device__ __forceinline__ void put_a(unsigned char* stage, int row, int k, float x0,
                                               float x1) {
    unsigned char* q = stage + row * 128 + (((k >> 2) ^ (row & 7)) << 4) + (k & 3) * 4;
    uint32_t h0, l0, h1, l1;
    tf32::split_tf32(x0, h0, l0);
    tf32::split_tf32(x1, h1, l1);
    *reinterpret_cast<uint2*>(q) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(q + HALF) = make_uint2(l0, l1);
  }
  // A 128-column group of the warp's rows into an A buffer: a quad's hi
  // (and lo) of an n-tile row is one whole 32-byte sector already.
  static __device__ __forceinline__ void put_group(unsigned char* buf, int rl, int c0,
                                                   const float (&y)[16][4]) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      unsigned char* st = buf + (size_t)(c / PK) * SB;
      put_a(st, rl, c % PK, y[j][0], y[j][1]);
      put_a(st, rl + 8, c % PK, y[j][2], y[j][3]);
    }
  }
  // Three passes a k-step, the small terms first: A.lo B.hi, A.hi B.lo,
  // A.hi B.hi.
  static __device__ __forceinline__ void issue_ss(float (&d)[16][4], uint32_t a, uint32_t b0,
                                                  uint32_t b1) {
    bf16mma::wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        float(&dd)[8][4] = *reinterpret_cast<float(*)[8][4]>(&d[8 * rb][0]);
        const uint32_t b = rb ? b1 : b0;
        tf32::Wgmma<64>::ss(dd, desc_sw128(a + HALF + 32 * s), desc_sw128(b + 32 * s));
        tf32::Wgmma<64>::ss(dd, desc_sw128(a + 32 * s), desc_sw128(b + HALF + 32 * s));
        tf32::Wgmma<64>::ss(dd, desc_sw128(a + 32 * s), desc_sw128(b + 32 * s));
      }
  }
};

// ---- the layout ---------------------------------------------------------------------

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Width C, heads of D channels: KVN = 64 where D <= 64, else 128 (a head's
// diagonal block takes an m-tile's whole band; C in the padded layout); HD
// normaliser entries a row: 8 for a launch of at most 8 heads, else HMAX
// (the padded layout always). Byte offsets from the 1024-aligned base of
// shared memory.
template <class M, int C, int KVN, int HD = HMAX>
struct Cfg {
  static constexpr int HEADS = HD;
  static constexpr int NB = C / 64;             // 64-column blocks of a C-wide output
  static constexpr int NTC = C / 8;             // n-tiles of C columns
  static constexpr int CH2 = 2 * C / 64;        // 64-column chunks of a 2C-wide output
  static constexpr int PPC = C / M::PK;         // k-panels over C
  static constexpr int PPH = 64 / M::PK;        // k-panels over 64
  static constexpr int BP = KVN / M::PK;        // k-panels of a message chunk's band
  static constexpr int KVST = NB * BP;          // message stages of a side's KV
  // weight stages a tile, in the order the consumers take them
  static constexpr int S1W = NB * PPH * NB + CH2 * (PPC + PPH * NB);   // merge, fc1[C:] + fc2
  static constexpr int SSW = CH2 * PPC;                                // [Wk | Wv]
  static constexpr int S2W = PPC * NB + CH2 * PPC + S1W;               // Wq, fc1[:C], the tail
  static constexpr int WSTAGES = S1W + SSW + S2W;
  static constexpr int STG = (M::ARRAYS / 2) * 2 * C * 128;           // staging a warpgroup
  static constexpr int FIXED = 2 * STG + 4 * (2 * C + CWARPS * C + CWARPS * 2 * C + WGS * TILE * HD);
  static constexpr int RING =
      cmin(RING_MAX, (int)((SMEM_LIMIT - 1024 - FIXED - 8 * (2 * RING_MAX + 1)) / M::SB));
  static constexpr int STG_OFF = RING * M::SB;
  static constexpr int KS_OFF = STG_OFF + 2 * STG;          // sum k of each side [2][C]
  static constexpr int KSP_OFF = KS_OFF + 4 * 2 * C;        // sum k partials [8 warps][C]
  static constexpr int PART_OFF = KSP_OFF + 4 * CWARPS * C; // pooling partials [8][2C]
  static constexpr int DEN_OFF = PART_OFF + 4 * CWARPS * 2 * C;   // [2][64 rows][HD]
  static constexpr int BAR_OFF = DEN_OFF + 4 * WGS * TILE * HD;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 * RING + 1);
  static_assert(RING >= 4 && BYTES <= (int)SMEM_LIMIT, "shared memory");
};

// The device scratch of a block: both sides' KV as message stages, the
// stage-2 a = O fc1[:C] of an m-tile a side, both sides' O (Np rows).
template <class M, int C, int KVN>
__host__ __device__ constexpr long long scratch_bytes(int N) {
  return 2LL * Cfg<M, C, KVN>::KVST * M::SB + 2LL * TILE * 2 * C * 4 +
         2LL * ((N + TILE - 1) / TILE) * TILE * C * 4;
}

template <class M>
struct Side {
  const typename M::T* h;     // (n, N, C)
  const typename M::T* q;     // (n, N, C)   elu+1 stage-1 queries
  const typename M::T* a1;    // (n, N, 2C)  h @ stage1.fc1[:C]
  const typename M::T* pv;    // (n, N, C)   stage-2 pos-MLP @ v_proj
  const unsigned char* kvs;   // (n, KVST stages) KV of [KV | Z] as message stages
  const float* ks;            // (n, C)      the diagonal of Z: sum k
};

struct Ln { const float *s1, *b1, *s2, *b2; };   // LN1, LN2 of one stage

template <class M>
struct Args {
  Side<M> side[2];            // track, det
  const unsigned char* w;     // the weight stages (WSTAGES x SB bytes)
  Ln ln[2];                   // stage 1, stage 2
  const int* t_idx;           // pair lists, or null (grid)
  const int* d_idx;
  typename M::T* out;         // (P, 2C)
  unsigned char* scratch;     // blocks x scratch_stride bytes
  long long scratch_stride;
  int nt, nd, P, N, H;
  // the padded layout (PAD): ct true channels of C in H heads of D, and
  // hm = ceil(2^21 / D), so that c / D = (c hm) >> 21 for every column c
  // below 1024 (exact while C D < 2^21)
  int ct, D, hm;
  int C;                      // the layout's width (the wide kernel's, at run time)
};

// ---- helpers on the accumulators -------------------------------------------------

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

// The head of column c in the padded layout (H heads of D channels from
// column 0; a padded column's is taken as the last head's: every factor of
// a padded column is 0, so its head changes nothing).
__device__ __forceinline__ int head_of(int c, int hm, int H) {
  return min((int)(((unsigned)c * (unsigned)hm) >> 21), H - 1);
}

// LayerNorm of the rows of a C-wide accumulator (rows g and g + 8 of the
// warp), in registers: a row's columns lie in one quad. PAD: the statistics
// over the true ct columns (the padded ones hold zeros: the sum needs no
// mask, the deviations do).
template <bool PAD, int NT>
__device__ __forceinline__ void layer_norm(float (&x)[NT][4], const float* __restrict__ s,
                                           const float* __restrict__ b, int ct) {
  const float inv_c = PAD ? 1.f / ct : 1.f / (8 * NT);
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) sum += x[j][2 * half] + x[j][2 * half + 1];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mu = sum * inv_c;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d0 = x[j][2 * half] - mu, d1 = x[j][2 * half + 1] - mu;
      if (PAD) {
        d0 = 8 * j + 2 * t < ct ? d0 : 0.f;
        d1 = 8 * j + 2 * t + 1 < ct ? d1 : 0.f;
      }
      var += d0 * d0 + d1 * d1;
    }
    var += __shfl_xor_sync(0xffffffffu, var, 1);
    var += __shfl_xor_sync(0xffffffffu, var, 2);
    const float inv = rsqrtf(var * inv_c + LN_EPS);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(s + c));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(b + c));
      x[j][2 * half] = (x[j][2 * half] - mu) * inv * sc.x + bi.x;
      x[j][2 * half + 1] = (x[j][2 * half + 1] - mu) * inv * sc.y + bi.y;
    }
  }
}

// Rows r0 and r0 + 8 of an (N, ld) factor, columns c0 .. c0 + 8 NT, in the
// accumulator layout; rows past N read as 0 (the load is unconditional,
// from a row clamped into the N rows, so no operand of a wgmma is formed on
// a divergent path).
template <class M, int NT>
__device__ __forceinline__ void load_rows(float (&x)[NT][4], const typename M::T* p, int ld,
                                          int c0, int r0, int N) {
  const int t = threadIdx.x & 3, r1 = r0 + 8;
  const typename M::T* p0 = p + (size_t)min(r0, N - 1) * ld + c0 + 2 * t;
  const typename M::T* p1 = p + (size_t)min(r1, N - 1) * ld + c0 + 2 * t;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 a = M::ld2(p0 + 8 * j), b = M::ld2(p1 + 8 * j);
    x[j][0] = r0 < N ? a.x : 0.f;
    x[j][1] = r0 < N ? a.y : 0.f;
    x[j][2] = r1 < N ? b.x : 0.f;
    x[j][3] = r1 < N ? b.y : 0.f;
  }
}

// Rows r and r + 8 of a float32 scratch matrix (row stride ld) in the
// accumulator layout (held: the rows are this tile's; else zeros), read
// through L2 (other threads of the warpgroup may have written them).
template <int NT>
__device__ __forceinline__ void load_scratch(float (&x)[NT][4], const float* p, int ld, int r,
                                             bool held) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 a = __ldcg(reinterpret_cast<const float2*>(p + (size_t)r * ld + 8 * j + 2 * t));
    const float2 b =
        __ldcg(reinterpret_cast<const float2*>(p + (size_t)(r + 8) * ld + 8 * j + 2 * t));
    x[j][0] = held ? a.x : 0.f;
    x[j][1] = held ? a.y : 0.f;
    x[j][2] = held ? b.x : 0.f;
    x[j][3] = held ? b.y : 0.f;
  }
}

template <int NT>
__device__ __forceinline__ void store_scratch(float* p, int ld, int r, const float (&x)[NT][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(p + (size_t)r * ld + 8 * j + 2 * t) = make_float2(x[j][0], x[j][1]);
    *reinterpret_cast<float2*>(p + (size_t)(r + 8) * ld + 8 * j + 2 * t) =
        make_float2(x[j][2], x[j][3]);
  }
}

// The message normaliser of the warp's rows (local rows rl, rl + 8 of the
// m-tile): per head (of 2^dsh channels), the sum over its channels of
// R(q . ks) (R: the bf16 rounding of JAX's q * ksum operand in stage 2,
// none in stage 1); den[row][head] = 1 / (that + eps), HD entries a row.
// PAD: H heads of any width (head_of), a head at a time over the thread's
// columns.
template <class M, bool PAD, int HD, int NT>
__device__ __forceinline__ void normaliser(float* den, const float (&q)[NT][4], const float* ks,
                                           int dsh, bool rnd, int rl, int hm, int H) {
  const int t = threadIdx.x & 3;
  if constexpr (PAD) {
#pragma unroll 1
    for (int hh = 0; hh < H; ++hh) {
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float k = ks[c];
          const float u0 = rnd ? M::round(q[j][e] * k) : q[j][e] * k;
          const float u1 = rnd ? M::round(q[j][2 + e] * k) : q[j][2 + e] * k;
          const bool in = head_of(c, hm, H) == hh;
          p0 += in ? u0 : 0.f;
          p1 += in ? u1 : 0.f;
        }
      p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
      p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
      if (t == 0) {
        den[rl * HD + hh] = 1.f / (p0 + EPS);
        den[(rl + 8) * HD + hh] = 1.f / (p1 + EPS);
      }
    }
    __syncwarp();
    return;
  }
  if (t == 0)
#pragma unroll
    for (int hh = 0; hh < HD; ++hh) den[rl * HD + hh] = den[(rl + 8) * HD + hh] = 0.f;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float k0 = ks[8 * j + 2 * t], k1 = ks[8 * j + 2 * t + 1];
    const float q0 = q[j][0], q1 = q[j][1], q2 = q[j][2], q3 = q[j][3];
    float p0 = rnd ? M::round(q0 * k0) + M::round(q1 * k1) : q0 * k0 + q1 * k1;
    float p1 = rnd ? M::round(q2 * k0) + M::round(q3 * k1) : q2 * k0 + q3 * k1;
    p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
    p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    if (t == 0) {
      den[rl * HD + (8 * j >> dsh)] += p0;
      den[(rl + 8) * HD + (8 * j >> dsh)] += p1;
    }
  }
  if (t == 0)
#pragma unroll
    for (int hh = 0; hh < HD; ++hh) {
      den[rl * HD + hh] = 1.f / (den[rl * HD + hh] + EPS);
      den[(rl + 8) * HD + hh] = 1.f / (den[(rl + 8) * HD + hh] + EPS);
    }
  __syncwarp();
}

// ---- the ring ----------------------------------------------------------------------

// A consumer warpgroup's place in the ring (both take every stage in order).
template <int RING, int SB>
struct Ring {
  static constexpr int SLOTS = RING;
  uint32_t base, full, empty;
  int pos;
  __device__ __forceinline__ int acquire() {
    const int slot = pos % RING;
    bf16mma::mbar_wait(full + 8 * slot, (uint32_t)((pos / RING) & 1));
    ++pos;
    return slot;
  }
  __device__ __forceinline__ uint32_t addr(int slot) const { return base + slot * SB; }
  // this warp has read the stage (or skips it): one arrival a warp
  __device__ __forceinline__ void release(int slot) const {
    if ((threadIdx.x & 31) == 0) bf16mma::mbar_arrive(empty + 8 * slot);
  }
};

// d += A's k-panels 0 .. NP - 1 @ their stages, NB stages (64 output
// columns each) a panel, issue_panel(p, st, f) issuing panel p's wgmmas on
// stages st with fragments f; up to M::DEPTH panels in flight (a panel's
// stages are released once its wgmmas are done).
template <class M, int NB, int NP, int RING, int NTD, class Issue>
__device__ __forceinline__ void product_panels(Ring<RING, M::SB>& ring, float (&d)[NTD][4],
                                               Issue issue_panel) {
  constexpr int DEPTH = NP > 1 ? M::DEPTH : 1;
  typename M::Frag f[DEPTH];
  int slot[DEPTH][NB];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int b = p % DEPTH;
    uint32_t st[NB];
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) {
      slot[b][rb] = ring.acquire();
      st[rb] = ring.addr(slot[b][rb]);
    }
    issue_panel(p, st, f[b]);
    bf16mma::wg_commit();
    if (DEPTH == 1 || p > 0) {
      const int q = DEPTH == 1 ? b : b ^ 1;   // the panel now done
      if (DEPTH == 1) bf16mma::wg_wait<0>(); else bf16mma::wg_wait<1>();
      f[q].pin();
#pragma unroll
      for (int rb = 0; rb < NB; ++rb) ring.release(slot[q][rb]);
    }
  }
  if (DEPTH > 1) {
    constexpr int q = (NP - 1) % DEPTH;
    bf16mma::wg_wait<0>();
    f[q].pin();
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) ring.release(slot[q][rb]);
  }
  bf16mma::wg_pin(d);
}

// d += A's k-panels p0 .. p0 + NP - 1 (an accumulator in registers) @ their
// stages, NB stages a panel.
template <class M, int NB, int NP, int RING, int NTA, int NTD>
__device__ __forceinline__ void product(Ring<RING, M::SB>& ring, float (&d)[NTD][4],
                                        const float (&a)[NTA][4], int p0) {
  product_panels<M, NB, NP>(ring, d, [&](int p, const uint32_t (&st)[NB], typename M::Frag& f) {
    M::template issue<NB>(d, a, p0 + p, st, f);
  });
}

// Stages that belong to the other warpgroup: taken and released unread.
template <int N, int RING, int SB>
__device__ __forceinline__ void skip(Ring<RING, SB>& ring) {
#pragma unroll
  for (int b = 0; b < N; ++b) ring.release(ring.acquire());
}

// The message of the warpgroup's rows and the merge product: for each
// 64-column chunk j, mz = q . KV (the message stages: warpgroup 0's, then
// warpgroup 1's; each warpgroup takes both and reads its own), times the
// row's 1 / (den + eps) of the column's head, then mg += msg_j @
// merge[:, chunk j].
template <class M, class G, bool PAD, int RING>
__device__ __forceinline__ void message(Ring<RING, M::SB>& ring, float (&mg)[G::NTC][4],
                                        const float (&q)[G::NTC][4], const float* den, int dsh,
                                        int wg, int rl, int hm, int H) {
#pragma unroll
  for (int j = 0; j < G::NB; ++j) {
    constexpr int BP = G::BP;
    const int klo = BP * M::PK == 64 ? 64 * j : 0;   // the chunk's band of K
    float mz[8][4];
    zero(mz);
#pragma unroll
    for (int x = 0; x < WGS; ++x) {
      if (x == wg)
        product<M, 1, BP, RING, G::NTC>(ring, mz, q, klo / M::PK);
      else
        skip<BP>(ring);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if constexpr (PAD) {   // the two columns' heads may differ
        const int c = 64 * j + 8 * jj + 2 * (threadIdx.x & 3);
        const int h0 = head_of(c, hm, H), h1 = head_of(c + 1, hm, H);
        mz[jj][0] *= den[rl * G::HEADS + h0];
        mz[jj][1] *= den[rl * G::HEADS + h1];
        mz[jj][2] *= den[(rl + 8) * G::HEADS + h0];
        mz[jj][3] *= den[(rl + 8) * G::HEADS + h1];
        continue;
      }
      const int hh = (64 * j + 8 * jj) >> dsh;
      const float d0 = den[rl * G::HEADS + hh], d1 = den[(rl + 8) * G::HEADS + hh];
      mz[jj][0] *= d0;
      mz[jj][1] *= d0;
      mz[jj][2] *= d1;
      mz[jj][3] *= d1;
    }
    product<M, G::NB, G::PPH, RING, 8>(ring, mg, mz, 0);
  }
}

// y += relu(init + m @ fc1b[:, chunk h]) @ fc2[chunk h, :] a 64-column hidden
// chunk h at a time; init(h, hid) loads the chunk's first term.
template <class M, class G, int RING, class Init>
__device__ __forceinline__ void ffn(Ring<RING, M::SB>& ring, float (&y)[G::NTC][4],
                                    const float (&m)[G::NTC][4], Init init) {
#pragma unroll 1
  for (int h = 0; h < G::CH2; ++h) {
    float hid[8][4];
    init(h, hid);
    product<M, 1, G::PPC, RING, G::NTC>(ring, hid, m, 0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) hid[j][i] = fmaxf(hid[j][i], 0.f);
    product<M, G::NB, G::PPH, RING, 8>(ring, y, hid, 0);
  }
}

template <class M>
__device__ __forceinline__ void pair_of(const Args<M>& a, int p, int& ti, int& dj) {
  if (a.t_idx != nullptr) {   // pair list, range-checked by the wrapper; the clamp only bounds the reads
    ti = min(max(a.t_idx[p], 0), a.nt - 1);
    dj = min(max(a.d_idx[p], 0), a.nd - 1);
  } else {
    ti = p / a.nd;
    dj = p - ti * a.nd;
  }
}

// ---- the kernel ----------------------------------------------------------------------

// PAD: the padded layout (kernels/match_grid.pad_side), and the image head
// (pv null): the true channels are the first a.ct of C, in a.H heads of
// a.D each (any width; KVN = C: a head's block may cross a 64-column band);
// the wrapper zeroes every factor, weight and LayerNorm lane past a.ct and
// the kernel masks elu+1 of a padded stage-2 q or k lane and the LayerNorm
// statistics.
template <class M, int C, int KVN, bool PAD, int HD>
__global__ void __launch_bounds__(THREADS, 1) rows_wg_kernel(const Args<M> a) {
  using G = Cfg<M, C, KVN, HD>;
  using T = typename M::T;
  constexpr int SB = M::SB, NTC = G::NTC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(smem);
  const uint32_t full = sb + G::BAR_OFF, empty = full + 8 * G::RING, kvready = empty + 8 * G::RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = a.N, ntiles = (N + TILE - 1) / TILE, nsum = (N + M::SUM_ROWS - 1) / M::SUM_ROWS;
  const int Np = ntiles * TILE;
  unsigned char* scr = a.scratch + (size_t)blockIdx.x * a.scratch_stride;
  unsigned char* kvscr = scr;                                       // [2][KVST stages]
  float* a2scr = reinterpret_cast<float*>(scr + 2 * G::KVST * SB);  // [2][64][2C]
  float* oscr = a2scr + 2 * TILE * 2 * C;                           // [2][Np][C]

  if (threadIdx.x == 0) {
    for (int i = 0; i < G::RING; ++i) {
      bf16mma::mbar_init(full + 8 * i, 1);
      bf16mma::mbar_init(empty + 8 * i, CWARPS);
    }
    bf16mma::mbar_init(kvready, CWARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CWARPS) {
    // ---- the producer: one thread loads each pair's stages in the order
    // the consumers take them, a bulk copy a stage, as far ahead as the
    // ring's free stages allow
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 128 * WGS) return;
    int it = 0;
    auto emit = [&](const unsigned char* src) {
      const int slot = it % G::RING;
      if (it >= G::RING) bf16mma::mbar_wait(empty + 8 * slot, (uint32_t)(((it / G::RING) - 1) & 1));
      bf16mma::mbar_expect_tx(full + 8 * slot, SB);
      bf16mma::bulk_load(sb + slot * SB, src, SB, full + 8 * slot);
      ++it;
    };
    // a stage-1 / stage-2 tile: message stages of each warpgroup and the
    // merge stages a chunk, then the hidden chunks' fc1 and fc2 stages
    auto tail = [&](const unsigned char*& w, const unsigned char* const (&kv)[2]) {
      for (int j = 0; j < G::NB; ++j) {
        for (int x = 0; x < WGS; ++x)
          for (int b = 0; b < G::BP; ++b) emit(kv[x] + (size_t)(j * G::BP + b) * SB);
        for (int s = 0; s < G::PPH * G::NB; ++s, w += SB) emit(w);
      }
      for (int s = 0; s < G::CH2 * (G::PPC + G::PPH * G::NB); ++s, w += SB) emit(w);
    };
    int round = 0;
    for (int p = blockIdx.x; p < a.P; p += gridDim.x, ++round) {
      int ti, dj;
      pair_of(a, p, ti, dj);
      // warpgroup 0 (the track side) reads the det side's summary, 1 the track's
      const unsigned char* const kin[2] = {a.side[1].kvs + (size_t)dj * G::KVST * SB,
                                           a.side[0].kvs + (size_t)ti * G::KVST * SB};
      for (int tile = 0; tile < ntiles; ++tile) {
        const unsigned char* w = a.w;
        tail(w, kin);
      }
      for (int st = 0; st < nsum; ++st) {
        const unsigned char* w = a.w + (size_t)G::S1W * SB;
        for (int s = 0; s < G::SSW; ++s, w += SB) emit(w);
      }
      const unsigned char* const kout[2] = {kvscr + (size_t)G::KVST * SB, kvscr};
      for (int tile = 0; tile < ntiles; ++tile) {
        const unsigned char* w = a.w + (size_t)(G::S1W + G::SSW) * SB;
        for (int s = 0; s < G::PPC * G::NB + G::CH2 * G::PPC; ++s, w += SB) emit(w);
        // both sides' KV are in the scratch (Wq and fc1[:C] went ahead)
        if (tile == 0) bf16mma::mbar_wait(kvready, (uint32_t)(round & 1));
        tail(w, kout);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: side wg of each pair
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int wq = __shfl_sync(0xffffffffu, warp & 3, 0);
  const int g = lane >> 2, t = lane & 3, rl = 16 * wq + g;   // the thread's rows in an m-tile
  const int dsh = __ffs(C / a.H) - 1;   // heads of 2^dsh channels
  Ring<G::RING, SB> ring{sb, full, empty, 0};
  unsigned char* stg = smem + G::STG_OFF + wg * G::STG;
  const uint32_t stg_a = smem_addr(stg);
  float* ks_sm = reinterpret_cast<float*>(smem + G::KS_OFF);
  float* ksp = reinterpret_cast<float*>(smem + G::KSP_OFF) + warp * C;
  float* part = reinterpret_cast<float*>(smem + G::PART_OFF) + warp * 2 * C;
  float* den = reinterpret_cast<float*>(smem + G::DEN_OFF) + wg * TILE * HD;
  float* O = oscr + (size_t)wg * Np * C;
  float* A2 = a2scr + wg * TILE * 2 * C;
  const Side<M> X = wg ? a.side[1] : a.side[0];
  const Side<M> Y = wg ? a.side[0] : a.side[1];
  const size_t nc = (size_t)N * C;
  const uint32_t wg_bar = 1 + wg;
  auto bar_wg = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory"); };
  auto bar_both = [&]() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); };

  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    int ti, dj;
    pair_of(a, p, ti, dj);
    const int own = wg ? dj : ti, oth = wg ? ti : dj;
    const T* hX = X.h + own * nc;
    const T* qX = X.q + own * nc;
    const T* aX = X.a1 + own * 2 * nc;
    const T* pvX = PAD && X.pv == nullptr ? nullptr : X.pv + own * nc;
    for (int c = lane; c < C; c += 32) {
      part[c] = -__int_as_float(0x7f800000);
      part[C + c] = 0.f;
      ksp[c] = 0.f;
    }
    __syncwarp();

    // ---- stage 1: O = h + LN2(relu(a1 + LN1(msg @ merge) @ fc1[C:]) @ fc2)
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = tile * TILE + rl;
      float mg[NTC][4];
      {
        float q[NTC][4];
        load_rows<M>(q, qX, C, 0, r0, N);
        normaliser<M, PAD, HD>(den, q, Y.ks + (size_t)oth * C, dsh, false, rl, a.hm, a.H);
        zero(mg);
        message<M, G, PAD>(ring, mg, q, den, dsh, wg, rl, a.hm, a.H);
      }
      layer_norm<PAD>(mg, a.ln[0].s1, a.ln[0].b1, a.ct);
      float y[NTC][4];
      zero(y);
      ffn<M, G>(ring, y, mg, [&](int h, float (&hid)[8][4]) {
        load_rows<M>(hid, aX, 2 * C, 64 * h, r0, N);
      });
      layer_norm<PAD>(y, a.ln[0].s2, a.ln[0].b2, a.ct);
      float hr[NTC][4];
      load_rows<M>(hr, hX, C, 0, r0, N);
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) y[j][i] += hr[j][i];
      store_scratch(O, C, r0, y);   // rows past N hold finite values nothing pools
    }
    bar_wg();                       // O is written (a TF32 summary tile reads other warps' rows)

    // ---- the summary of this side for the other's stage 2: [k | v] = O
    // [Wk | Wv], k = elu1, v += pv; KV += bf16 / TF32 (k)^T v on the heads'
    // band, sum k
    {
      float kv[G::NB][KVN / 8][4];
#pragma unroll
      for (int mi = 0; mi < G::NB; ++mi) zero(kv[mi]);
#pragma unroll 1
      for (int st = 0; st < nsum; ++st) {
        const bool held = rl < M::SUM_ROWS;   // the thread's rows are in the summary tile
        const int r0 = st * M::SUM_ROWS + rl;
        const bool v0 = held && r0 < N, v1 = held && r0 + 8 < N;
        float o[NTC][4];
        load_scratch(o, O, C, held ? r0 : 0, held);
#pragma unroll
        for (int i = 0; i < G::CH2; ++i) {
          float e[8][4];
          zero(e);
          product<M, 1, G::PPC, G::RING, NTC>(ring, e, o, 0);
          const bool is_k = i < G::NB;
          float pv[8][4];
          if (is_k || (PAD && X.pv == nullptr)) {   // the image head: no position term
            zero(pv);
          } else {
            load_rows<M>(pv, pvX, C, 64 * (i - G::NB), r0, N);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float x = is_k ? elu1(e[j][k]) : e[j][k] + pv[j][k];
              if (PAD && is_k && 64 * i + 8 * j + 2 * t + (k & 1) >= a.ct) x = 0.f;   // a padded k lane
              e[j][k] = (k < 2 ? v0 : v1) ? x : 0.f;   // rows past N add nothing
            }
          if (is_k) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float s0 = e[j][0] + e[j][2], s1 = e[j][1] + e[j][3];
#pragma unroll
              for (int off = 4; off < 32; off <<= 1) {
                s0 += __shfl_xor_sync(0xffffffffu, s0, off);
                s1 += __shfl_xor_sync(0xffffffffu, s1, off);
              }
              if (g == 0) {
                const int c = 64 * i + 8 * j + 2 * t;
                ksp[c] += s0;
                ksp[c + 1] += s1;
              }
            }
          }
          M::stage_chunk(stg + (is_k ? 0 : M::VT * C * 128), C * 128, 64 * (is_k ? i : i - G::NB),
                         e, wq, lane);
        }
        bf16mma::fence_async_shared();
        bar_wg();                   // the summary tile's k^T and v^T are staged
#pragma unroll
        for (int mi = 0; mi < G::NB; ++mi) {
          const int vlo = KVN == 64 ? 64 * mi : 0;
          M::template summary<KVN>(kv[mi], stg_a + 64 * mi * 128,
                                   stg_a + M::VT * C * 128 + vlo * 128, C * 128);
        }
        bar_wg();                   // the staging is free again
      }
      // KV (the heads' diagonal blocks) as the other side's message stages
      unsigned char* kvo = kvscr + (size_t)wg * G::KVST * SB;
#pragma unroll
      for (int mi = 0; mi < G::NB; ++mi) {
        const int vlo = KVN == 64 ? 64 * mi : 0;
#pragma unroll
        for (int j = 0; j < KVN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = 64 * mi + rl + 8 * (i >> 1), n = vlo + 8 * j + 2 * t + (i & 1);
            const int jj = n >> 6, klo = KVN == 64 ? 64 * jj : 0, kk = m - klo;
            const bool same =
                PAD ? head_of(m, a.hm, a.H) == head_of(n, a.hm, a.H) : (m >> dsh) == (n >> dsh);
            M::put_b(kvo + (size_t)(jj * G::BP + kk / M::PK) * SB, n & 63, kk % M::PK,
                     same ? kv[mi][j][i] : 0.f);
          }
      }
    }
    asm volatile("fence.proxy.async.global;\n" ::: "memory");   // for the producer's bulk copies
    __syncwarp();
    if (lane == 0) bf16mma::mbar_arrive(kvready);
    bar_wg();                       // the warps' sum k partials are complete
    for (int c = threadIdx.x & 127; c < C; c += 128) {
      const float* k4 = reinterpret_cast<const float*>(smem + G::KSP_OFF) + 4 * wg * C;
      ks_sm[wg * C + c] = ((k4[c] + k4[C + c]) + k4[2 * C + c]) + k4[3 * C + c];
    }
    bar_both();                     // both sides' sum k

    // ---- stage 2: O searches the other side's summary, then the pooling
    const float* ksY = ks_sm + (1 - wg) * C;
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = tile * TILE + rl;
      const bool v0 = r0 < N, v1 = r0 + 8 < N;
      float q[NTC][4];
      {
        float o[NTC][4];
        load_scratch(o, O, C, r0, true);
        zero(q);
        product<M, G::NB, G::PPC, G::RING, NTC>(ring, q, o, 0);
        // a = O fc1[:C], a 64-column chunk at a time, into the scratch
#pragma unroll 1
        for (int h = 0; h < G::CH2; ++h) {
          float e[8][4];
          zero(e);
          product<M, 1, G::PPC, G::RING, NTC>(ring, e, o, 0);
          store_scratch(A2 + 64 * h, 2 * C, rl, e);
        }
      }
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          q[j][i] = PAD && 8 * j + 2 * t + (i & 1) >= a.ct ? 0.f : elu1(q[j][i]);
      normaliser<M, PAD, HD>(den, q, ksY, dsh, true, rl, a.hm, a.H);
      float mg[NTC][4];
      zero(mg);
      message<M, G, PAD>(ring, mg, q, den, dsh, wg, rl, a.hm, a.H);
      layer_norm<PAD>(mg, a.ln[1].s1, a.ln[1].b1, a.ct);
      float y[NTC][4];
      zero(y);
      ffn<M, G>(ring, y, mg, [&](int h, float (&hid)[8][4]) {
        load_scratch(hid, A2 + 64 * h, 2 * C, rl, true);
      });
      layer_norm<PAD>(y, a.ln[1].s2, a.ln[1].b2, a.ct);
      // pooling of O + y over the valid rows: the warp's 16 rows, then its
      // running max / sum (lanes with g = 0 own two columns an n-tile)
#pragma unroll
      for (int j = 0; j < NTC; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 o0 = __ldcg(reinterpret_cast<const float2*>(O + (size_t)r0 * C + c));
        const float2 o1 = __ldcg(reinterpret_cast<const float2*>(O + (size_t)(r0 + 8) * C + c));
        const float ninf = -__int_as_float(0x7f800000);
        const float a0 = o0.x + y[j][0], a1 = o0.y + y[j][1];
        const float b0 = o1.x + y[j][2], b1 = o1.y + y[j][3];
        float m0 = fmaxf(v0 ? a0 : ninf, v1 ? b0 : ninf), m1 = fmaxf(v0 ? a1 : ninf, v1 ? b1 : ninf);
        float s0 = (v0 ? a0 : 0.f) + (v1 ? b0 : 0.f), s1 = (v0 ? a1 : 0.f) + (v1 ? b1 : 0.f);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (g == 0) {
          part[c] = fmaxf(part[c], m0);
          part[c + 1] = fmaxf(part[c + 1], m1);
          part[C + c] += s0;
          part[C + c + 1] += s1;
        }
      }
    }
    bar_both();                     // every warp's pooling partials
    if (threadIdx.x < C) {
      const float* pb = reinterpret_cast<const float*>(smem + G::PART_OFF);
      float mx = pb[threadIdx.x], sm = pb[C + threadIdx.x];
      for (int w = 1; w < CWARPS; ++w) {
        mx = fmaxf(mx, pb[w * 2 * C + threadIdx.x]);
        sm += pb[w * 2 * C + C + threadIdx.x];
      }
      T* o = a.out + (size_t)p * 2 * C;
      M::store(o + threadIdx.x, mx);
      M::store(o + C + threadIdx.x, sm * (1.f / (2.f * N)));
    }
    bar_both();                     // the partials and sum k are free
  }
}

// ---- the wide kernel: C a multiple of 128 from 256 to 1024, in column groups --------
//
// A 64-row m-tile of a C-wide accumulator takes C / 2 registers a thread:
// 128 at C = 256, where the chain above holds two of them at once against
// the launch's 168. So past 128 channels the chain's C-wide rows live in the
// device scratch, every C-wide output is made in 128-column groups (two
// 64-column blocks, 64 registers), and every product takes BOTH operands
// from shared memory (wgmma ss): the epilogue that makes a row an operand
// writes it to the scratch in the stage layout (a 64-row x 128-byte k-panel
// a stage: bf16, or TF32 hi then lo; K in its natural order), and the
// producer streams those A stages through the ring beside the weights, so
// the ring's depth hides their latency as it hides the weights'. A panel's
// stages in the ring: the A stage of warpgroup 0, of warpgroup 1, then its
// B stages, two shared weight blocks, or two a warpgroup (the KV message
// stages, the summary's v^T); each warpgroup reads its own and releases the
// other's at once. The producer issues an A stage only after its rows are
// written: the consumers' warps arrive on one mbarrier (aready) after
// fence.proxy.async.global at each event of a pair, and the producer waits
// each event, in the consumers' order, right before the first stage that
// needs it:
//   stage 1, a tile at a time:  q (the factor) into QS, and the normaliser
//       from it in registers [event]; the message, a 128-column group at a
//       time over its heads' band of K only, x 1 / den, into MSG [event];
//       merge in groups, LN1 into MID [event]; the FFN's hidden groups
//       relu(a1 + MID fc1[C:]) into HID [event]; fc2 in groups, LN2, + h
//       into O (float32, for the pooling) and OS (its stages);
//   [event: O] the summary: [k | v] = OS [Wk | Wv] once a tile, 2C columns
//       in groups (elu+1, + pv), written transposed (channels x rows) into
//       KT, VT [event]; KV = k^T v over units of a 64-channel k block x a
//       128-channel v group, only the units that meet a head's diagonal
//       band, both operands streamed (KT, VT) over the rows' k-panels, put
//       as the other side's message stages [event: KV]; sum k;
//   stage 2, a tile at a time:  q = elu1(OS Wq) in groups into QS (the
//       normaliser from it in registers) [event]; the tail as in stage 1,
//       a hidden group's a = OS fc1[:C] accumulated with MID fc1[C:] (no
//       buffer for a), and the pooling of O + y.
// LayerNorm: each group's count, mean and sum of squared deviations in
// registers as the group is made, merged by Chan's formula over the true ct
// columns; the raw groups but the last parked (float32) and read once to
// normalise. The heads are always read as head_of (any H <= WIDE_HMAX of
// any width) and the statistics over a.ct (C at the exact width): the
// padded layout's code serves the exact widths too, at ct = C. The weight
// stages come in the order of kernels/match_grid.weight_blocks at C > 128.
// The width C is the launch's (a.C): one instantiation a dtype serves every
// multiple of 128 from 384 to WIDE_MAX_C, and one C = 256 (rows_wide_kernel's
// CC); the shared memory is sized for WIDE_MAX_C and WIDE_HMAX heads, so it
// is the same at every width.
// Sum k and the pooling (max and sum over a side's rows) go through a
// warpgroup's staging of one 128-column group (4 warps x 128 columns x
// [max, sum]): each warp's lanes put the warp's 16 rows' reduction there,
// then thread i of the warpgroup adds the 4 warps' in warp order into
// column i of the group (sum k into shared memory, the pooling into the
// warpgroup's row of the device scratch, 2C floats), so the order of every
// sum is fixed and a pair equals its grid cell bit for bit. (The first
// layout kept a row a warp, 8 x 2C floats, 64 KB at C = 1024: four ring
// stages at TF32.)
// Shared memory at every width: the ring (12 TF32 / 24 bf16 stages), the
// staging of the two warpgroups, sum k of each side, the normalisers of 64
// rows x 32 heads a side: 230,600 bytes TF32, 230,792 bf16 (WideCfg). What
// bounds it: the same 80 N C^2 operations a pair; each ss product reads A
// and B from shared memory (4 KB a k-step of m64n64, the tensor core's 32
// cycles at 128 bytes a cycle).

constexpr int WIDE_RING_MAX = 32;           // most stages in the wide kernel's ring
constexpr int WIDE_MAX_C = 1024;            // widest layout (kernels/match_grid.MAX_C)
constexpr int WIDE_HMAX = 32;               // most heads on the wide kernel

template <class M>
struct WideCfg {
  static constexpr int SB = M::SB, PK = M::PK;
  static constexpr int STG = 4 * 128 * 2;       // a warpgroup's staging: [4 warps][128][max, sum]
  // the staging of both warpgroups, sum k of each side, the normalisers
  static constexpr int FIXED = 4 * (WGS * STG + 2 * WIDE_MAX_C + WGS * TILE * WIDE_HMAX);
  static constexpr int RING =
      cmin(WIDE_RING_MAX, (int)((SMEM_LIMIT - 1024 - FIXED - 8 * (2 * WIDE_RING_MAX + 1)) / SB));
  static constexpr int STG_OFF = RING * SB;                     // [2][STG] floats
  static constexpr int KS_OFF = STG_OFF + 4 * WGS * STG;        // sum k of each side [2][C]
  static constexpr int DEN_OFF = KS_OFF + 4 * 2 * WIDE_MAX_C;   // [2][64 rows][WIDE_HMAX]
  static constexpr int BAR_OFF = DEN_OFF + 4 * WGS * TILE * WIDE_HMAX;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 * RING + 1);
  // a product holds a panel's stages (4 shared, 6 per side) while it
  // takes the next panel's: the ring must hold two panels
  static_assert(RING >= 12 && BYTES <= (int)SMEM_LIMIT, "shared memory");
  // at width C: k-panels over C, message stages of a side's KV (one band
  // of all C columns), weight stages of a stage-1 tile (merge, fc1[C:],
  // fc2: two 64-column blocks a panel) and of a summary tile ([Wk | Wv])
  static __host__ __device__ constexpr int ppc(int C) { return C / PK; }
  static __host__ __device__ constexpr int kvst(int C) { return C / 64 * ppc(C); }
  static __host__ __device__ constexpr int s1w(int C) { return 2 * ppc(C) * 5 * (C / 128); }
  static __host__ __device__ constexpr int ssw(int C) { return 2 * ppc(C) * 2 * (C / 128); }
};

// The device scratch of a block: both sides' KV as message stages, then a
// side's buffers for each side: OS (O's stages, ntiles x PPC), KT and VT
// (k^T and v^T: NB channel blocks x Np / PK row panels each), QS, MSG (PPC
// stages), HID (2 PPC), O (Np x C float32), the parked groups (64 x (C -
// 128) float32) and the pooling row ([max | sum], 2C float32).
template <class M>
struct WideScratch {
  using G = WideCfg<M>;
  static __host__ __device__ constexpr long long side_bytes(int N, int C) {
    return (long long)G::SB * G::ppc(C) * (3 * ((N + TILE - 1) / TILE) + 4) +
           4LL * (((N + TILE - 1) / TILE) * TILE * C + TILE * (C - 128) + 2 * C);
  }
  static __host__ __device__ constexpr long long bytes(int N, int C) {
    return 2LL * G::kvst(C) * G::SB + 2 * side_bytes(N, C);
  }
  unsigned char *kv[2], *os[2], *kt[2], *vt[2], *qs[2], *msg[2], *hid[2];
  float *of[2], *park[2], *pool[2];
  int nrp;   // row panels of KT and VT (Np / PK)
  __device__ WideScratch(unsigned char* base, int N, int C) {
    const int ntiles = (N + TILE - 1) / TILE, Np = ntiles * TILE, PPC = G::ppc(C);
    nrp = Np / G::PK;
    unsigned char* p = base;
    for (int s = 0; s < 2; ++s, p += (size_t)G::kvst(C) * G::SB) kv[s] = p;
    for (int s = 0; s < 2; ++s) {
      os[s] = p;
      kt[s] = os[s] + (size_t)ntiles * PPC * G::SB;
      vt[s] = kt[s] + (size_t)ntiles * PPC * G::SB;   // NB x nrp stages
      qs[s] = vt[s] + (size_t)ntiles * PPC * G::SB;
      msg[s] = qs[s] + (size_t)PPC * G::SB;
      hid[s] = msg[s] + (size_t)PPC * G::SB;
      of[s] = reinterpret_cast<float*>(hid[s] + (size_t)2 * PPC * G::SB);
      park[s] = of[s] + (size_t)Np * C;
      pool[s] = park[s] + (size_t)TILE * (C - 128);
      p = reinterpret_cast<unsigned char*>(pool[s] + 2 * C);
    }
  }
};

// An mbarrier wait that traps (a launch failure the wrapper reports) once it
// has spun for 2^34 cycles, seconds past any wait of a working pair, so
// that a fault in the wide kernel's hand-offs cannot hang the card.
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 4095) == 0) {
      if (t0 == 0) t0 = clock64();
      else if (clock64() - t0 > (1LL << 34)) __trap();
    }
  }
}

// The wide kernel's place in the ring (Ring, its waits bounded).
template <int RING, int SB>
struct WideRing : Ring<RING, SB> {
  __device__ __forceinline__ int acquire() {
    const int slot = this->pos % RING;
    wait_or_trap(this->full + 8 * slot, (uint32_t)((this->pos / RING) & 1));
    ++this->pos;
    return slot;
  }
};

// The k-panels [p0, p0 + np) of the heads' band of the 128-column group vh:
// the channels of the heads that meet the group's true columns (none past
// ct).
template <int PK>
__device__ __forceinline__ void band(int vh, int ct, int D, int hm, int H, int& p0, int& np) {
  const int c0 = 128 * vh;
  if (c0 >= ct) {
    p0 = np = 0;
    return;
  }
  const int klo = head_of(c0, hm, H) * D;
  const int khi = min(ct, (head_of(min(c0 + 127, ct - 1), hm, H) + 1) * D);
  p0 = klo / PK;
  np = (khi + PK - 1) / PK - p0;
}

// Whether the summary's unit (64-channel k block mi, 128-channel v group
// vh) meets a head's diagonal band.
__device__ __forceinline__ bool unit_on(int mi, int vh, int ct, int hm, int H) {
  if (64 * mi >= ct || 128 * vh >= ct) return false;
  const int ma = head_of(64 * mi, hm, H), mb = head_of(min(64 * mi + 63, ct - 1), hm, H);
  const int va = head_of(128 * vh, hm, H), vb = head_of(min(128 * vh + 127, ct - 1), hm, H);
  return ma <= vb && va <= mb;
}

// d (two 64-column blocks) += own A @ own B over np panels of the ring,
// each panel's stages A of warpgroup 0, A of warpgroup 1, then two shared B
// stages (SHARED) or two of warpgroup 0 and two of 1. Two panels in flight
// where the ring holds three panels' stages (a warpgroup keeps a panel's
// own stages until its products are done, while the next panel's arrive
// and the one after is loaded), else one.
template <class M, bool SHARED, class R>
__device__ __forceinline__ void product_ss(R& ring, float (&d)[16][4], int np, int wg) {
  constexpr bool DEEP = R::SLOTS >= 3 * (SHARED ? 4 : 6);
  int prev0 = 0, prev1 = 0, prev2 = 0;
#pragma unroll 1
  for (int p = 0; p < np; ++p) {
    const int s0 = ring.acquire(), s1 = ring.acquire();
    const int a = wg ? s1 : s0;
    ring.release(wg ? s0 : s1);
    int b0, b1;
    if (SHARED) {
      b0 = ring.acquire();
      b1 = ring.acquire();
    } else {
      const int x0 = ring.acquire(), x1 = ring.acquire(), y0 = ring.acquire(), y1 = ring.acquire();
      b0 = wg ? y0 : x0;
      b1 = wg ? y1 : x1;
      ring.release(wg ? x0 : y0);
      ring.release(wg ? x1 : y1);
    }
    M::issue_ss(d, ring.addr(a), ring.addr(b0), ring.addr(b1));
    bf16mma::wg_commit();
    if (!DEEP) {
      bf16mma::wg_wait<0>();
      ring.release(a);
      ring.release(b0);
      ring.release(b1);
      continue;
    }
    if (p > 0) {
      bf16mma::wg_wait<1>();
      ring.release(prev0);
      ring.release(prev1);
      ring.release(prev2);
    }
    prev0 = a;
    prev1 = b0;
    prev2 = b1;
  }
  bf16mma::wg_wait<0>();
  if (DEEP && np > 0) {
    ring.release(prev0);
    ring.release(prev1);
    ring.release(prev2);
  }
  bf16mma::wg_pin(d);
}

// The same group transposed (channel c0 + c a stage row, the m-tile's row
// r0 + r its k) into a buffer of NB channel blocks x nrp row panels (KT, VT).
template <class M>
__device__ __forceinline__ void put_cols(unsigned char* buf, int nrp, int r0, int c0,
                                         const float (&y)[16][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 8 * j + 2 * t + (i & 1), r = r0 + 8 * (i >> 1);
      M::put_n(buf + (size_t)((c >> 6) * nrp + r / M::PK) * M::SB, c & 63, r % M::PK, y[j][i]);
    }
}

// The normaliser's sums of the warp's rows over a 128-column group (from c0)
// in registers: den[row][head] += R(q . ks) over the group's columns of each
// head (R as normaliser's).
template <class M>
__device__ __forceinline__ void den_add(float* den, const float (&x)[16][4], int c0, const float* ks,
                                        bool rnd, int rl, int hm, int H) {
  const int t = threadIdx.x & 3;
  float k[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    k[j][0] = ks[c0 + 8 * j + 2 * t];
    k[j][1] = ks[c0 + 8 * j + 2 * t + 1];
  }
  const int ha = head_of(c0, hm, H), hb = head_of(c0 + 127, hm, H);
#pragma unroll 1
  for (int hh = ha; hh <= hb; ++hh) {
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = head_of(c0 + 8 * j + 2 * t + e, hm, H) == hh;
        const float u0 = rnd ? M::round(x[j][e] * k[j][e]) : x[j][e] * k[j][e];
        const float u1 = rnd ? M::round(x[j][2 + e] * k[j][e]) : x[j][2 + e] * k[j][e];
        p0 += in ? u0 : 0.f;
        p1 += in ? u1 : 0.f;
      }
    p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
    p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    if (t == 0) {
      den[rl * WIDE_HMAX + hh] += p0;
      den[(rl + 8) * WIDE_HMAX + hh] += p1;
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void den_zero(float* den, int rl, int H) {
  if ((threadIdx.x & 3) == 0)
#pragma unroll 1
    for (int hh = 0; hh < H; ++hh) den[rl * WIDE_HMAX + hh] = den[(rl + 8) * WIDE_HMAX + hh] = 0.f;
  __syncwarp();
}

__device__ __forceinline__ void den_invert(float* den, int rl, int H) {
  if ((threadIdx.x & 3) == 0)
#pragma unroll 1
    for (int hh = 0; hh < H; ++hh) {
      den[rl * WIDE_HMAX + hh] = 1.f / (den[rl * WIDE_HMAX + hh] + EPS);
      den[(rl + 8) * WIDE_HMAX + hh] = 1.f / (den[(rl + 8) * WIDE_HMAX + hh] + EPS);
    }
  __syncwarp();
}

// A LayerNorm's running statistics of the warp's two rows (h = 0: row rl,
// 1: rl + 8): count, mean and sum of squared deviations over the true
// columns seen so far.
struct LnStats {
  float n = 0.f, mean[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
  // merge the 128-column group from c0 (columns past ct masked), by Chan's
  // formula
  __device__ __forceinline__ void add(const float (&y)[16][4], int c0, int ct) {
    const int t = threadIdx.x & 3;
    const float nb = (float)max(0, min(128, ct - c0));
    if (nb == 0.f) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        s += (c < ct ? y[j][2 * h] : 0.f) + (c + 1 < ct ? y[j][2 * h + 1] : 0.f);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float mb = s / nb;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        const float d0 = c < ct ? y[j][2 * h] - mb : 0.f, d1 = c + 1 < ct ? y[j][2 * h + 1] - mb : 0.f;
        q += d0 * d0 + d1 * d1;
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      const float nn = n + nb, delta = mb - mean[h];
      mean[h] += delta * (nb / nn);
      m2[h] += q + delta * delta * (n * nb / nn);
    }
    n += nb;
  }
  // normalise the group from c0 in place: (y - mean) / sqrt(m2 / n + eps) * s + b
  __device__ __forceinline__ void apply(float (&y)[16][4], int c0, const float* __restrict__ s,
                                        const float* __restrict__ b) const {
    const int t = threadIdx.x & 3;
    const float inv0 = rsqrtf(m2[0] / n + LN_EPS), inv1 = rsqrtf(m2[1] / n + LN_EPS);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(s + c));
      const float2 bi = __ldg(reinterpret_cast<const float2*>(b + c));
      y[j][0] = (y[j][0] - mean[0]) * inv0 * sc.x + bi.x;
      y[j][1] = (y[j][1] - mean[0]) * inv0 * sc.y + bi.y;
      y[j][2] = (y[j][2] - mean[1]) * inv1 * sc.x + bi.x;
      y[j][3] = (y[j][3] - mean[1]) * inv1 * sc.y + bi.y;
    }
  }
};

// dst = LN(A @ W) of a C-wide output in nh groups (each group's product
// over np panels of the ring, shared B), fin(group, y) given each
// normalised group (the last first); the groups but the last parked raw in
// `park` (64 x (C - 128)), read once to normalise.
template <class M, class R, class Fin>
__device__ __forceinline__ void halves_ln(R& ring, int nh, int np, int wg, float* park, int rl,
                                          const float* s, const float* b, int ct, Fin fin) {
  float y[16][4];
  LnStats st;
  const int ld = 128 * (nh - 1);
#pragma unroll 1
  for (int hf = 0; hf < nh; ++hf) {
    zero(y);
    product_ss<M, true>(ring, y, np, wg);
    st.add(y, 128 * hf, ct);
    if (hf < nh - 1) store_scratch(park + 128 * hf, ld, rl, y);
  }
  st.apply(y, 128 * (nh - 1), s, b);
  fin(nh - 1, y);
#pragma unroll 1
  for (int hf = 0; hf < nh - 1; ++hf) {
    load_scratch(y, park + 128 * hf, ld, rl, true);
    st.apply(y, 128 * hf, s, b);
    fin(hf, y);
  }
}

// The consumers' side of an event: this warp's writes of the scratch are
// done (and visible to the producer's bulk copies).
__device__ __forceinline__ void written(uint32_t aready) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bf16mma::mbar_arrive(aready);
}

// CC: the width at compile time, or 0: the launch's (a.C). The kernel is
// the same code either way; at run time ptxas keeps the values that follow
// from C in registers and spills (TF32: 1,428 bytes stored, against none
// at CC = 256), which costs the C = 256 grid ~5 % on the H100 (PERF.md
// section 6), so C = 256 keeps an instantiation of its own and every other
// width takes CC = 0.
template <class M, int CC>
__global__ void __launch_bounds__(THREADS, 1) rows_wide_kernel(const Args<M> a) {
  using G = WideCfg<M>;
  using T = typename M::T;
  constexpr int SB = M::SB, PK = M::PK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(smem);
  const uint32_t full = sb + G::BAR_OFF, empty = full + 8 * G::RING, aready = empty + 8 * G::RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = CC > 0 ? CC : a.C, NB = C / 64, NH = C / 128, PPC = G::ppc(C);
  const int N = a.N, ntiles = (N + TILE - 1) / TILE;
  const int H = a.H, D = a.D, hm = a.hm, ct = a.ct;
  const WideScratch<M> S(a.scratch + (size_t)blockIdx.x * a.scratch_stride, N, C);
  const int nrows = (N + PK - 1) / PK;   // row panels the summary's units take

  if (threadIdx.x == 0) {
    for (int i = 0; i < G::RING; ++i) {
      bf16mma::mbar_init(full + 8 * i, 1);
      bf16mma::mbar_init(empty + 8 * i, CWARPS);
    }
    bf16mma::mbar_init(aready, CWARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CWARPS) {
    // ---- the producer: the consumers' stage order, an event's wait before
    // the first stage that needs it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 128 * WGS) return;
    int it = 0, ev = 0;
    auto emit = [&](const unsigned char* src) {
      const int slot = it % G::RING;
      if (it >= G::RING) wait_or_trap(empty + 8 * slot, (uint32_t)(((it / G::RING) - 1) & 1));
      bf16mma::mbar_expect_tx(full + 8 * slot, SB);
      bf16mma::bulk_load(sb + slot * SB, src, SB, full + 8 * slot);
      ++it;
    };
    auto event = [&]() {
      wait_or_trap(aready, (uint32_t)(ev & 1));
      ++ev;
    };
    // a product of np panels from p0 of the sides' A buffers, its weight
    // blocks (two a panel) from w onwards
    auto prod_w = [&](unsigned char* const (&A)[2], int np, const unsigned char*& w) {
      for (int p = 0; p < np; ++p, w += 2 * SB) {
        emit(A[0] + (size_t)p * SB);
        emit(A[1] + (size_t)p * SB);
        emit(w);
        emit(w + SB);
      }
    };
    // the message of each group over its band, B the KV message stages of
    // chunks 2 vh, 2 vh + 1 each warpgroup reads
    auto message = [&](unsigned char* const (&A)[2], const unsigned char* const (&kv)[2]) {
      for (int vh = 0; vh < NH; ++vh) {
        int p0, np;
        band<PK>(vh, ct, D, hm, H, p0, np);
        for (int p = p0; p < p0 + np; ++p) {
          emit(A[0] + (size_t)p * SB);
          emit(A[1] + (size_t)p * SB);
          for (int x = 0; x < WGS; ++x) {
            emit(kv[x] + (size_t)((2 * vh) * PPC + p) * SB);
            emit(kv[x] + (size_t)((2 * vh + 1) * PPC + p) * SB);
          }
        }
      }
    };
    // merge, LN1, the hidden groups, fc2 (each after the event of its A);
    // in stage 2 (os: the tile's O stages) a hidden group's O fc1[:C]
    // panels before its MID fc1[C:] ones, the first group's ahead of MID
    auto tail = [&](const unsigned char*& w, unsigned char* const (*os)[2]) {
      event();                                          // MSG
      for (int hf = 0; hf < NH; ++hf) prod_w(S.msg, PPC, w);
      for (int g = 0; g < 2 * NH; ++g) {
        if (os != nullptr) prod_w(*os, PPC, w);
        if (g == 0) event();                            // MID
        prod_w(S.qs, PPC, w);
      }
      event();                                          // HID
      for (int hf = 0; hf < NH; ++hf) prod_w(S.hid, 2 * PPC, w);
    };
    const size_t kvst = (size_t)G::kvst(C) * SB;
    for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
      int ti, dj;
      pair_of(a, p, ti, dj);
      // warpgroup 0 (the track side) reads the det side's summary, 1 the track's
      const unsigned char* const kin[2] = {a.side[1].kvs + (size_t)dj * kvst,
                                           a.side[0].kvs + (size_t)ti * kvst};
      const unsigned char* const kout[2] = {S.kv[1], S.kv[0]};
      for (int tile = 0; tile < ntiles; ++tile) {
        const unsigned char* w = a.w;
        event();                                        // QS
        message(S.qs, kin);
        tail(w, nullptr);
      }
      event();                                          // O
      for (int tile = 0; tile < ntiles; ++tile) {
        const unsigned char* w = a.w + (size_t)G::s1w(C) * SB;
        unsigned char* const os[2] = {S.os[0] + (size_t)tile * PPC * SB,
                                      S.os[1] + (size_t)tile * PPC * SB};
        for (int g = 0; g < 2 * NH; ++g) prod_w(os, PPC, w);
      }
      event();                                          // KT, VT
      for (int mi = 0; mi < NB; ++mi)
        for (int vh = 0; vh < NH; ++vh) {
          if (!unit_on(mi, vh, ct, hm, H)) continue;
          for (int r = 0; r < nrows; ++r) {
            emit(S.kt[0] + (size_t)(mi * S.nrp + r) * SB);
            emit(S.kt[1] + (size_t)(mi * S.nrp + r) * SB);
            for (int x = 0; x < WGS; ++x) {
              emit(S.vt[x] + (size_t)((2 * vh) * S.nrp + r) * SB);
              emit(S.vt[x] + (size_t)((2 * vh + 1) * S.nrp + r) * SB);
            }
          }
        }
      event();                                          // KV
      for (int tile = 0; tile < ntiles; ++tile) {
        const unsigned char* w = a.w + (size_t)(G::s1w(C) + G::ssw(C)) * SB;
        unsigned char* const os[2] = {S.os[0] + (size_t)tile * PPC * SB,
                                      S.os[1] + (size_t)tile * PPC * SB};
        for (int g = 0; g < NH; ++g) prod_w(os, PPC, w);   // Wq
        event();                                        // QS (q)
        message(S.qs, kout);
        tail(w, &os);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: side wg of each pair
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int wq = __shfl_sync(0xffffffffu, warp & 3, 0);
  const int g = lane >> 2, t = lane & 3, rl = 16 * wq + g;   // the thread's rows in an m-tile
  const int col = threadIdx.x & 127;     // the group's column this thread adds the warps' sums of
  WideRing<G::RING, SB> ring{{sb, full, empty, 0}};
  float* ks_sm = reinterpret_cast<float*>(smem + G::KS_OFF);
  float* stg = reinterpret_cast<float*>(smem + G::STG_OFF) + wg * G::STG;   // [4][128][2]
  float* den = reinterpret_cast<float*>(smem + G::DEN_OFF) + wg * TILE * WIDE_HMAX;
  unsigned char* OS = S.os[wg];
  unsigned char* QS = S.qs[wg];
  unsigned char* MSG = S.msg[wg];
  unsigned char* HID = S.hid[wg];
  float* O = S.of[wg];
  float* PARK = S.park[wg];
  float* POOL = S.pool[wg];
  const Side<M> X = wg ? a.side[1] : a.side[0];
  const Side<M> Y = wg ? a.side[0] : a.side[1];
  const size_t nc = (size_t)N * C;
  auto bar_wg = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };
  auto bar_both = [&]() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); };

  // the message of the rows (their normaliser in den) into MSG, a group at
  // a time over its heads' band
  auto message = [&]() {
#pragma unroll 1
    for (int vh = 0; vh < NH; ++vh) {
      int p0, np;
      band<PK>(vh, ct, D, hm, H, p0, np);
      float mz[16][4];
      zero(mz);
      product_ss<M, false>(ring, mz, np, wg);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 128 * vh + 8 * j + 2 * t;
        const int h0 = head_of(c, hm, H), h1 = head_of(c + 1, hm, H);
        mz[j][0] *= den[rl * WIDE_HMAX + h0];
        mz[j][1] *= den[rl * WIDE_HMAX + h1];
        mz[j][2] *= den[(rl + 8) * WIDE_HMAX + h0];
        mz[j][3] *= den[(rl + 8) * WIDE_HMAX + h1];
      }
      M::put_group(MSG, rl, 128 * vh, mz);
    }
    written(aready);
  };
  // merge, LN1 into QS (as MID), the hidden groups relu(init + MID fc1[C:])
  // into HID, fc2, LN2, handed to fin by group
  auto tail = [&](const Ln& ln, auto init, auto fin) {
    halves_ln<M>(ring, NH, PPC, wg, PARK, rl, ln.s1, ln.b1, ct,
                 [&](int hf, float (&y)[16][4]) { M::put_group(QS, rl, 128 * hf, y); });
    written(aready);
#pragma unroll 1
    for (int gh = 0; gh < 2 * NH; ++gh) {
      float hid[16][4];
      init(gh, hid);
      product_ss<M, true>(ring, hid, PPC, wg);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) hid[j][i] = fmaxf(hid[j][i], 0.f);
      M::put_group(HID, rl, 128 * gh, hid);
    }
    written(aready);
    halves_ln<M>(ring, NH, 2 * PPC, wg, PARK, rl, ln.s2, ln.b2, ct, fin);
  };

  for (int p = blockIdx.x; p < a.P; p += gridDim.x) {
    int ti, dj;
    pair_of(a, p, ti, dj);
    const int own = wg ? dj : ti, oth = wg ? ti : dj;
    const T* hX = X.h + own * nc;
    const T* qX = X.q + own * nc;
    const T* aX = X.a1 + own * 2 * nc;
    const T* pvX = X.pv == nullptr ? nullptr : X.pv + own * nc;
    const float* ksX = Y.ks + (size_t)oth * C;
    // (the other side read this side's sum k of the last pair before its
    // closing barrier)
    for (int c = col; c < C; c += 128) ks_sm[wg * C + c] = 0.f;

    // ---- stage 1: O = h + LN2(relu(a1 + LN1(msg @ merge) @ fc1[C:]) @ fc2)
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = tile * TILE + rl;
      den_zero(den, rl, H);
#pragma unroll 1
      for (int hf = 0; hf < NH; ++hf) {
        float q[16][4];
        load_rows<M>(q, qX, C, 128 * hf, r0, N);
        den_add<M>(den, q, 128 * hf, ksX, false, rl, hm, H);
        M::put_group(QS, rl, 128 * hf, q);
      }
      den_invert(den, rl, H);
      written(aready);
      message();
      tail(a.ln[0],
           [&](int gh, float (&hid)[16][4]) { load_rows<M>(hid, aX, 2 * C, 128 * gh, r0, N); },
           [&](int hf, float (&y)[16][4]) {
#pragma unroll
             for (int j = 0; j < 16; ++j) {
               float hr[1][4];
               load_rows<M>(hr, hX, C, 128 * hf + 8 * j, r0, N);
#pragma unroll
               for (int i = 0; i < 4; ++i) y[j][i] += hr[0][i];
             }
             store_scratch(O + (size_t)tile * TILE * C + 128 * hf, C, rl, y);
             M::put_group(OS + (size_t)tile * PPC * SB, rl, 128 * hf, y);
           });
    }
    written(aready);                // O

    // ---- the summary: [k | v] = O [Wk | Wv] once a tile, transposed into
    // KT, VT; KV over the units on the heads' diagonal, as the other side's
    // message stages; sum k, a tile's 4 warps added in warp order
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = tile * TILE + rl;
      const bool v0 = r0 < N, v1 = r0 + 8 < N;
#pragma unroll 1
      for (int gk = 0; gk < 2 * NH; ++gk) {
        const bool is_k = gk < NH;
        const int c0 = 128 * (is_k ? gk : gk - NH);
        float e[16][4];
        zero(e);
        product_ss<M, true>(ring, e, PPC, wg);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float pv[1][4] = {{0.f, 0.f, 0.f, 0.f}};
          if (!is_k && pvX != nullptr) load_rows<M>(pv, pvX, C, c0 + 8 * j, r0, N);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float x = is_k ? elu1(e[j][i]) : e[j][i] + pv[0][i];
            if (is_k && c0 + 8 * j + 2 * t + (i & 1) >= ct) x = 0.f;   // a padded k lane
            e[j][i] = (i < 2 ? v0 : v1) ? x : 0.f;   // rows past N add nothing
          }
        }
        if (is_k) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            float s0 = e[j][0] + e[j][2], s1 = e[j][1] + e[j][3];
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, off);
              s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            }
            if (g == 0)
              *reinterpret_cast<float4*>(stg + (wq * 128 + 8 * j + 2 * t) * 2) =
                  make_float4(0.f, s0, 0.f, s1);
          }
          bar_wg();                 // the 4 warps' sums of the group
          {
            const float2* s4 = reinterpret_cast<const float2*>(stg) + col;
            ks_sm[wg * C + c0 + col] += ((s4[0].y + s4[128].y) + s4[256].y) + s4[384].y;
          }
          bar_wg();                 // the staging is free
        }
        put_cols<M>(is_k ? S.kt[wg] : S.vt[wg], S.nrp, r0, c0, e);
      }
    }
    written(aready);                // KT, VT
    {
      unsigned char* kvo = S.kv[wg];
#pragma unroll 1
      for (int mi = 0; mi < NB; ++mi)
#pragma unroll 1
        for (int vh = 0; vh < NH; ++vh) {
          if (!unit_on(mi, vh, ct, hm, H)) continue;
          float kv[16][4];
          zero(kv);
          product_ss<M, false>(ring, kv, nrows, wg);
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int m = 64 * mi + rl + 8 * (i >> 1), n = 128 * vh + 8 * j + 2 * t + (i & 1);
              const bool same = head_of(m, hm, H) == head_of(n, hm, H);
              M::put_n(kvo + (size_t)((n >> 6) * PPC + m / PK) * SB, n & 63, m % PK,
                       same ? kv[j][i] : 0.f);
            }
        }
    }
    written(aready);                // KV
    bar_both();                     // both sides' sum k
    for (int c = col; c < C; c += 128) {
      POOL[c] = -__int_as_float(0x7f800000);
      POOL[C + c] = 0.f;
    }

    // ---- stage 2: O searches the other side's summary, then the pooling
    const float* ksY = ks_sm + (1 - wg) * C;
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = tile * TILE + rl;
      const bool v0 = r0 < N, v1 = r0 + 8 < N;
      float* Ot = O + (size_t)tile * TILE * C;
      // q = elu1(O Wq) in groups into QS, its normaliser in registers
      den_zero(den, rl, H);
#pragma unroll 1
      for (int gq = 0; gq < NH; ++gq) {
        float e[16][4];
        zero(e);
        product_ss<M, true>(ring, e, PPC, wg);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            e[j][i] = 128 * gq + 8 * j + 2 * t + (i & 1) >= ct ? 0.f : elu1(e[j][i]);
        den_add<M>(den, e, 128 * gq, ksY, true, rl, hm, H);
        M::put_group(QS, rl, 128 * gq, e);
      }
      den_invert(den, rl, H);
      written(aready);
      message();
      tail(a.ln[1],
           [&](int, float (&hid)[16][4]) {   // a = O fc1[:C] of the group first
             zero(hid);
             product_ss<M, true>(ring, hid, PPC, wg);
           },
           [&](int hf, float (&y)[16][4]) {   // the pooling of O + y over the valid rows
#pragma unroll
             for (int j = 0; j < 16; ++j) {
               const int c = 128 * hf + 8 * j + 2 * t;
               const float2 o0 = __ldcg(reinterpret_cast<const float2*>(Ot + (size_t)rl * C + c));
               const float2 o1 =
                   __ldcg(reinterpret_cast<const float2*>(Ot + (size_t)(rl + 8) * C + c));
               const float ninf = -__int_as_float(0x7f800000);
               const float a0 = o0.x + y[j][0], a1 = o0.y + y[j][1];
               const float b0 = o1.x + y[j][2], b1 = o1.y + y[j][3];
               float m0 = fmaxf(v0 ? a0 : ninf, v1 ? b0 : ninf);
               float m1 = fmaxf(v0 ? a1 : ninf, v1 ? b1 : ninf);
               float s0 = (v0 ? a0 : 0.f) + (v1 ? b0 : 0.f), s1 = (v0 ? a1 : 0.f) + (v1 ? b1 : 0.f);
#pragma unroll
               for (int off = 4; off < 32; off <<= 1) {
                 m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
                 m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
                 s0 += __shfl_xor_sync(0xffffffffu, s0, off);
                 s1 += __shfl_xor_sync(0xffffffffu, s1, off);
               }
               if (g == 0)
                 *reinterpret_cast<float4*>(stg + (wq * 128 + 8 * j + 2 * t) * 2) =
                     make_float4(m0, s0, m1, s1);
             }
             bar_wg();              // the 4 warps' maxima and sums of the group
             {
               const float2* s4 = reinterpret_cast<const float2*>(stg) + col;
               const float2 w0 = s4[0], w1 = s4[128], w2 = s4[256], w3 = s4[384];
               const int c = 128 * hf + col;
               POOL[c] = fmaxf(POOL[c], fmaxf(fmaxf(w0.x, w1.x), fmaxf(w2.x, w3.x)));
               POOL[C + c] += ((w0.y + w1.y) + w2.y) + w3.y;
             }
             bar_wg();              // the staging is free
           });
    }
    bar_both();                     // both warpgroups' pooling rows
    for (int c = threadIdx.x; c < C; c += 128 * WGS) {
      const float* p0 = S.pool[0];
      const float* p1 = S.pool[1];
      T* o = a.out + (size_t)p * 2 * C;
      M::store(o + c, fmaxf(__ldcg(p0 + c), __ldcg(p1 + c)));
      M::store(o + C + c, (__ldcg(p0 + C + c) + __ldcg(p1 + C + c)) * (1.f / (2.f * N)));
    }
    bar_both();                     // the pooling rows and sum k are free
  }
}

template <class M>
int launch_wide(const Args<M>& a, int blocks, cudaStream_t stream) {
  using G = WideCfg<M>;
  auto kernel = a.C == 256 ? rows_wide_kernel<M, 256> : rows_wide_kernel<M, 0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, G::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- host side -------------------------------------------------------------------------

// 0: the tier takes the shape; 1: C is not 64, 128 or a multiple of 128
// from 256 to WIDE_MAX_C, H does not divide C or is above HMAX (WIDE_HMAX
// on the wide kernel), or N < 1; 2: the layout exceeds a block's shared
// memory. C > 128 is the wide kernel's (the padded entry point's only).
template <class M>
size_t smem_bytes(int C, int H) {
  if (C > 128) return C % 128 == 0 && C <= WIDE_MAX_C ? WideCfg<M>::BYTES : 0;
  switch (C) {
    case 64: return H <= 8 ? Cfg<M, 64, 64, 8>::BYTES : Cfg<M, 64, 64, HMAX>::BYTES;
    case 128: return H <= 8 ? Cfg<M, 128, 64, 8>::BYTES : Cfg<M, 128, 64, HMAX>::BYTES;
    default: return 0;
  }
}

template <class M>
int layout_status(int N, int C, int H) {
  if (N < 1 || H < 1 || H > (C > 128 ? WIDE_HMAX : HMAX) || C % H != 0 ||
      smem_bytes<M>(C, H) == 0)
    return 1;
  return smem_bytes<M>(C, H) > SMEM_LIMIT ? 2 : 0;
}

template <class M>
long long scratch_need(int N, int C, int H) {
  if (C > 128) return WideScratch<M>::bytes(N, C);
  if (C == 64) return scratch_bytes<M, 64, 64>(N);
  return C / H > 64 ? scratch_bytes<M, 128, 128>(N) : scratch_bytes<M, 128, 64>(N);
}

template <class M, int C, int KVN, bool PAD, int HD>
int launch_c(const Args<M>& a, int blocks, cudaStream_t stream) {
  using G = Cfg<M, C, KVN, HD>;
  auto kernel = rows_wg_kernel<M, C, KVN, PAD, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, G::BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class M>
int launch(const Args<M>& a, int C, int blocks, cudaStream_t stream) {
  // heads of fewer than 8 channels, and the wide kernel, take the padded entry
  if (a.P <= 0 || blocks <= 0 || layout_status<M>(a.N, C, a.H) != 0 || C > 128 ||
      C / a.H < 8 || a.scratch_stride < scratch_need<M>(a.N, C, a.H))
    return (int)cudaErrorInvalidValue;
  // (heads of 8 channels or more: at most 8 heads but at C = 128 in 64-column bands)
  if (C == 64) return launch_c<M, 64, 64, false, 8>(a, blocks, stream);
  if (C / a.H > 64) return launch_c<M, 128, 128, false, 8>(a, blocks, stream);
  if (a.H <= 8) return launch_c<M, 128, 64, false, 8>(a, blocks, stream);
  return launch_c<M, 128, 64, false, HMAX>(a, blocks, stream);
}

// The padded layout (and the image head, pv null, heads of fewer than 8
// channels, and the wide kernel at any width): a.ct true channels of C (64,
// 128, or a multiple of 128 up to WIDE_MAX_C) in a.H heads (up to HMAX; up
// to WIDE_HMAX past 128 channels); the layout and the scratch are those of
// one head (KVN = C).
template <class M>
int launch_pad(const Args<M>& a, int C, int blocks, cudaStream_t stream) {
  const int hmax = C > 128 ? WIDE_HMAX : HMAX;
  if (a.P <= 0 || blocks <= 0 || layout_status<M>(a.N, C, hmax) != 0 || a.H < 1 ||
      a.H > hmax || a.ct < 1 || a.ct > C || a.ct % a.H != 0 ||
      a.scratch_stride < scratch_need<M>(a.N, C, 1))
    return (int)cudaErrorInvalidValue;
  if (C == 64) return launch_c<M, 64, 64, true, HMAX>(a, blocks, stream);
  if (C > 128) return launch_wide<M>(a, blocks, stream);
  return launch_c<M, 128, 128, true, HMAX>(a, blocks, stream);
}

template <class M>
Args<M> make_args(const void* const* sides, const void* w, const void* const* ln,
                  const void* t_idx, const void* d_idx, void* out, void* scratch,
                  long long stride, int nt, int nd, int P, int N, int H, int ct, int C) {
  typedef const typename M::T* TP;
  Args<M> a;
  for (int s = 0; s < 2; ++s) {
    const void* const* q = sides + 6 * s;
    a.side[s] = Side<M>{(TP)q[0], (TP)q[1], (TP)q[2], (TP)q[3], (const unsigned char*)q[4],
                        (const float*)q[5]};
  }
  a.w = (const unsigned char*)w;
  for (int s = 0; s < 2; ++s)
    a.ln[s] = Ln{(const float*)ln[4 * s], (const float*)ln[4 * s + 1],
                 (const float*)ln[4 * s + 2], (const float*)ln[4 * s + 3]};
  a.t_idx = (const int*)t_idx;
  a.d_idx = (const int*)d_idx;
  a.out = (typename M::T*)out;
  a.scratch = (unsigned char*)scratch;
  a.scratch_stride = stride;
  a.nt = nt;
  a.nd = nd;
  a.P = P;
  a.N = N;
  a.H = H;
  a.ct = ct;
  a.D = H >= 1 && ct % H == 0 ? ct / H : 1;
  a.hm = ((1 << 21) + a.D - 1) / a.D;
  a.C = C;
  return a;
}

}  // namespace rowswg

// The entry points of one instantiation, ROWS_WG_ENTRIES(policy, suffix)
// in a .cu file (suffix _bf16 or nothing):
//   pcr_match_rows_wg<suffix>_layout(N, C, H, *bytes, *limit): the layout
//     check, returning rowswg::layout_status;
//   pcr_match_rows_wg<suffix>(12 side pointers: h, q, a1, pv, KV message
//     stages, sum k of the track side, then the det side's; the weight
//     stages; 8 LayerNorm vectors (ln1 scale, bias, ln2 scale, bias of
//     stage 1, then stage 2); t_idx, d_idx (null in grid mode), out,
//     scratch; nt, nd, P, N, C, H, blocks; the scratch bytes a block;
//     stream).
#define ROWS_WG_CAT2(a, b) a##b
#define ROWS_WG_CAT(a, b) ROWS_WG_CAT2(a, b)
#define ROWS_WG_ENTRIES(POLICY, SUFFIX)                                                           \
  extern "C" int ROWS_WG_CAT(ROWS_WG_CAT(pcr_match_rows_wg, SUFFIX), _layout)(                   \
      int N, int C, int H, long long* bytes, long long* limit) {                                  \
    *bytes = (long long)rowswg::smem_bytes<POLICY>(C, H);                                            \
    *limit = (long long)rowswg::SMEM_LIMIT;                                                       \
    return rowswg::layout_status<POLICY>(N, C, H);                                                \
  }                                                                                               \
  extern "C" int ROWS_WG_CAT(pcr_match_rows_wg, SUFFIX)(                                          \
      const void* ht, const void* qt, const void* at, const void* pvt, const void* kvst,          \
      const void* kst, const void* hd, const void* qd, const void* ad, const void* pvd,          \
      const void* kvsd, const void* ksd, const void* w, const void* ln1s1, const void* ln1b1,     \
      const void* ln2s1, const void* ln2b1, const void* ln1s2, const void* ln1b2,                \
      const void* ln2s2, const void* ln2b2, const void* t_idx, const void* d_idx, void* out,     \
      void* scratch, int nt, int nd, int P, int N, int C, int H, int blocks,                      \
      long long scratch_stride, void* stream) {                                                   \
    const void* sides[12] = {ht, qt, at, pvt, kvst, kst, hd, qd, ad, pvd, kvsd, ksd};             \
    const void* ln[8] = {ln1s1, ln1b1, ln2s1, ln2b1, ln1s2, ln1b2, ln2s2, ln2b2};                 \
    return rowswg::launch<POLICY>(                                                                \
        rowswg::make_args<POLICY>(sides, w, ln, t_idx, d_idx, out, scratch, scratch_stride, nt,   \
                                  nd, P, N, H, C, C),                                             \
        C, blocks, (cudaStream_t)stream);                                                         \
  }

// The padded layout's entry point (ROWS_WG_PAD_ENTRIES(policy, suffix), in
// a .cu file of its own): pcr_match_rows_wg_pad<suffix>, the arguments of
// pcr_match_rows_wg<suffix> with the true channels ct after H and C the
// layout's width (64, 128, or a multiple of 128 to WIDE_MAX_C); the pv
// pointers null for the image head. Its layout check is
// pcr_match_rows_wg<suffix>_layout(N, C, HMAX, ...) (past 128 channels
// WIDE_HMAX): the padded layout's normalisers hold HMAX heads, the wide
// kernel's WIDE_HMAX.
#define ROWS_WG_PAD_ENTRIES(POLICY, SUFFIX)                                                       \
  extern "C" int ROWS_WG_CAT(pcr_match_rows_wg_pad, SUFFIX)(                                      \
      const void* ht, const void* qt, const void* at, const void* pvt, const void* kvst,          \
      const void* kst, const void* hd, const void* qd, const void* ad, const void* pvd,          \
      const void* kvsd, const void* ksd, const void* w, const void* ln1s1, const void* ln1b1,     \
      const void* ln2s1, const void* ln2b1, const void* ln1s2, const void* ln1b2,                \
      const void* ln2s2, const void* ln2b2, const void* t_idx, const void* d_idx, void* out,     \
      void* scratch, int nt, int nd, int P, int N, int C, int H, int ct, int blocks,              \
      long long scratch_stride, void* stream) {                                                   \
    const void* sides[12] = {ht, qt, at, pvt, kvst, kst, hd, qd, ad, pvd, kvsd, ksd};             \
    const void* ln[8] = {ln1s1, ln1b1, ln2s1, ln2b1, ln1s2, ln1b2, ln2s2, ln2b2};                 \
    return rowswg::launch_pad<POLICY>(                                                            \
        rowswg::make_args<POLICY>(sides, w, ln, t_idx, d_idx, out, scratch, scratch_stride, nt,   \
                                  nd, P, N, H, ct, C),                                            \
        C, blocks, (cudaStream_t)stream);                                                         \
  }
