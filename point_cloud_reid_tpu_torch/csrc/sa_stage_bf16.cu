// Eval-mode SA stage of the point backbone at bf16: gather + edge MLP + max
// over K, on Hopper's warpgroup tensor-core products (wgmma).
//
// Replaces the bf16 instance of the TPU kernel
// point_cloud_reid_tpu/ops/pallas/sa_stage.py (fused_sa_convmax under a
// bf16 model): A, Ct and the output in bf16; w2, w3 and the affines arrive
// float32 and the kernel's dot casts both operands of each product to bf16
// and accumulates in float32. Per crop b and centre s
//
//   h1[k] = relu((A[b, idx[b,s,k]] + Ct[b,s]) * s1 + t1)       float32
//   h2[k] = relu((bf16(h1[k]) @ bf16(w2)) * s2 + t2)           float32 acc.
//   h3[k] = relu((bf16(h2[k]) @ bf16(w3)) * s3 + t3)
//   out[b,s] = bf16(max_k h3[k])
//
// The wrapper hands the weights over once converted to bf16 (utils/cache.py
// keeps the copy per weight tensor): for the wgmma tier in its stage
// layout (kernels/sa_stage.stage_weights), for the mma_sync tier in (out,
// in) layout, for the wide tier in its stage copy
// (kernels/sa_stage.wide_stage_weights).
//
// What bounds it on the H100: 4 R C^2 operations (R = B S K rows) in one
// bf16 pass at 989 TFLOP/s (0.035 / 0.104 / 0.208 ms for the flagship's
// SA1/2/3 at B = 128; 0.139 / 0.417 / 0.834 at the 7M model's widths),
// against ~18 MB of bytes (0.005 ms). Its first version (the
// mma_sync tier below) gave each block 48-64 rows and had every warp read
// its B fragments of both weights from L2: 4 C^2 bytes for every 48-64
// rows, on mma.sync, with block barriers between gather, convs and max.
//
// The wgmma tier (C = 32, 64, 128, 256, 512, 1024):
//  - rows in centre groups: a group is 4 centres; its 64-row m-tile i holds
//    neighbours 16 i .. 16 i + 15 of each centre, warp w of the warpgroup
//    the rows of centre w (wgmma gives warp w rows 16 w .. 16 w + 15). A
//    centre's K rows take ceil(K / 16) m-tiles; slots past K repeat
//    neighbour K - 1 (a max is blind to a repeat), centres past B S repeat
//    the last centre and are not stored. So every centre lies whole in one
//    warp at any K, and no zero-fill or atomic max is needed;
//  - a persistent grid of blocks of NWG consumer warpgroups (3 at C <= 128,
//    2 above) and a producer warpgroup that gives its registers to them
//    (setmaxnreg: 232 or 152 a consumer thread, 40 a producer thread).
//    Warpgroup wg of block b takes groups (b + j grid) NWG + wg, one m-tile
//    after the other. At C = 1024 an m-tile's h1 takes 128 KB and h2 does
//    not fit in registers: both warpgroups take the same m-tile, each half
//    of every product's output columns;
//  - the weights come into shared memory through a ring of 4-16 KB stages
//    (tiles of NC output rows x 64 or 128 input columns, K-major with the
//    128-byte swizzle of csrc/bf16_mma.cuh), one cp.async.bulk a stage from
//    the wrapper's stage copy, issued by one producer lane as far ahead as
//    free stages allow; a stage's arrival is its mbarrier's transaction
//    count (the async proxy both writes and reads it: no fence), its
//    release an mbarrier each consumer warp arrives on once its wgmma has
//    read the stage. Every stage serves all m-tiles of the block at once
//    (128 rows at C = 256 / 512, 64 at 1024). Where w2 and w3 fit (C <=
//    128: 64 KB) they are loaded once and stay for the block's lifetime:
//    every row the block takes;
//  - h1: each warpgroup gathers its m-tile (A rows + Ct, BN1, ReLU, bf16),
//    16 bytes a thread-store into its K-major swizzled buffer, fences the
//    async proxy and meets its warps at a named barrier; while one
//    warpgroup gathers, the others' products run;
//  - conv2: wgmma m64nNk16 with A (h1) and B (w2 stage) from shared memory,
//    NC2 columns at a time; the affine + ReLU in registers packs each chunk
//    straight into the A fragments of conv3 (an m64 accumulator's n-tiles
//    2 kk, 2 kk + 1 are k-step kk's register A fragment), so h2 stays in
//    registers (C / 4 a thread). At C = 1024 each warpgroup's half (128
//    registers) goes, once both have read h1, into the h1 buffer, from
//    which conv3 reads its A operand;
//  - conv3 fused with the max: wgmma with A from those registers (or that
//    buffer), NC3 columns at a time; the epilogue applies s3 / t3 to each
//    accumulator, takes the max of a thread's two rows, then a
//    reduce-scatter over the fragment's 8 row lanes (7 NT / 4 shuffles)
//    leaves each lane the max of its own n-tiles, which it folds into the
//    warp's running max of its centre (C floats in shared memory, each
//    element read and written by one owning lane only). After a group's
//    last m-tile the owning lanes write bf16(max(0, running max)) once a
//    centre.
// Measured on the H100 (PERF.md section 6): about 2x the one-pass bound at
// C = 256 ... 1024 and 3x at C = 128, against the first version's 8.7x.
//
// The mma_sync tier (the first version, kept for C = 96, 160, ..., 992: the
// multiples of 32 up to 1024 the wgmma tier does not take; none of the
// registered leaves reaches it, the `mul6` width's SA stages at 192, 384
// and 768 do): the float32 kernel's (csrc/sa_stage.cu)
// row tiles with one mma.sync m16n8k16 bf16 pass per product. A block of W
// warps owns M consecutive rows: it gathers them into buffer 1, runs conv2
// into buffer 2 and conv3 back into buffer 1 (B fragments straight from L2)
// and takes each centre's max; where M is not a multiple of K a block's
// edge centres go out by a compare-and-swap max on the bf16 bits into a
// zero-filled `out`.
//
// The wide tier (every multiple of 32 past 1024, run at the next multiple
// of 64; the `mul16` width's SA3 at 2048): csrc/sa_wide_wg.cuh at policy
// Bf16, entry pcr_sa_convmax_wide_bf16. Past 1024 channels the wgmma tier
// would need h2 (C / 4 registers a thread over a 64-row m-tile) split
// across more warpgroups than a block holds; there each weight stage
// serves two warpgroups' m-tiles (128 rows) through a ring of 16 KB slots,
// h1 and h2 (bf16) lie in a device scratch streamed back as A stages, both
// operands of every wgmma come from shared memory, and conv3 is fused with
// the max. The mma_sync tier served these widths in its first version
// (16-row tiles, each reading both weights from L2: 58.9 ms for the mul16
// model's SA3 at 17.7x its bound, PERF.md section 6).
//
// pcr_sa_bf16_layout returns the launch plan the kernel takes for (C, K);
// kernels/sa_stage.plan_bf16 reckons the same, and the wrapper checks that
// the two agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "sa_wide_wg.cuh"

namespace {

using namespace bf16mma;

constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may take

struct Args {
  const bf16* A;      // (B, N, C)
  const bf16* Ct;     // (B, S, C)
  const int* idx;     // (B, S, K): row r of the list is idx[r]
  const bf16* w2;     // (C, C) (out, in)
  const bf16* w3;
  const float* s1; const float* t1; const float* s2; const float* t2;
  const float* s3; const float* t3;
  bf16* out;          // (B, S, C)
  int N, S, K, C, R;  // R = B S K rows
};

// ---- the wgmma tier -------------------------------------------------------------

// The launch plan of width C; byte offsets from the 1024-aligned base.
template <int C> struct Cfg {
  static constexpr int NWG = C <= 128 ? 3 : 2;        // consumer warpgroups
  // C = 1024: the two warpgroups share one m-tile, each half its columns
  // (h2 goes back to the h1 buffer, which conv2 no longer needs)
  static constexpr bool SPLIT = C == 1024;
  static constexpr int GPR = SPLIT ? 1 : NWG;         // groups a block takes at once
  static constexpr int NBUF = SPLIT ? 1 : NWG;        // h1 buffers, running-max sets
  static constexpr int CW = SPLIT ? C / 2 : C;        // columns a warpgroup computes
  static constexpr int THREADS = 128 * (NWG + 1);     // + the producer warpgroup
  // registers a thread after setmaxnreg: 65,536 a block (ptxas allocates
  // the launch by whole warpgroups, 168 / 128 a thread)
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = NWG == 2 ? 232 : 152;
  static_assert(128 * (NWG * CONSUMER_REGS + PRODUCER_REGS) <= 65536, "registers");
  static constexpr int NC2 = C < 128 ? C : 128;       // conv2's columns a chunk
  static constexpr int NC3 = C == 512 ? 64 : NC2;     // conv3's (h2 holds C / 4 registers)
  static constexpr int P = (C + 63) / 64;             // 64-wide k-panels
  static constexpr int KP2 = 1;                       // k-panels a stage
  static constexpr int KP3 = C == 512 ? 2 : 1;
  static constexpr int SB = NC2 * KP2 * 128;          // bytes a stage
  static_assert(SB == NC3 * KP3 * 128, "one stage size");
  static_assert(P % KP3 == 0, "whole panels a stage");
  static constexpr int SPC2 = P / KP2, SPC3 = P / KP3;     // stages a column chunk
  static constexpr int T2 = (C / NC2) * SPC2;              // stages an m-tile
  static constexpr int T = T2 + (C / NC3) * SPC3;
  static constexpr int KSS2 = 4 * KP2 < C / 16 ? 4 * KP2 : C / 16;   // k-steps a stage
  static constexpr int KSS3 = 4 * KP3 < C / 16 ? 4 * KP3 : C / 16;
  static constexpr int NT3 = NC3 / 8;                 // conv3's n-tiles a chunk
  static constexpr int OWN = NT3 >= 8 ? NT3 / 8 : 1;  // of which a lane owns
  static constexpr int H1B = 64 * P * 128;            // an m-tile's h1
  static constexpr int MAXB = 4 * C * 4;              // its 4 running maxima
  static constexpr int FIT = (int)((SMEM_LIMIT - 1024 - NBUF * (H1B + MAXB) - 256) / SB);
  static constexpr bool RESIDENT = FIT >= T;          // both weights stay
  static constexpr int RING = RESIDENT ? T : FIT;
  static constexpr int H1_OFF = RING * SB;
  static constexpr int MAX_OFF = H1_OFF + NBUF * H1B;
  static constexpr int BAR_OFF = MAX_OFF + NBUF * MAXB;
  static constexpr int BYTES = 1024 + BAR_OFF + 16 * RING;
  static_assert(RING >= 2 && BYTES <= (int)SMEM_LIMIT, "shared memory");
};

// Column of a lane's i-th n-tile of the running max in conv3's chunk c
// (after reduce_scatter: lane g owns n-tiles g OWN ..; where a chunk has
// fewer than 8, lane g < NT3 owns n-tile g), or -1.
template <int C>
__device__ __forceinline__ int owned_col(int c, int i, int g, int t) {
  using G = Cfg<C>;
  if (G::NT3 >= 8) return c * G::NC3 + 8 * (g * G::OWN + i) + 2 * t;
  return g < G::NT3 ? c * G::NC3 + 8 * g + 2 * t : -1;
}

// The warps that share an m-tile's buffer meet: a warpgroup's (barrier
// 1 + wg), or both warpgroups' where they split one m-tile (barrier 1).
template <int C>
__device__ __forceinline__ void tile_bar(int wg) {
  if (Cfg<C>::SPLIT)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ float shfl_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// One step of the max's reduce-scatter over the row lanes: lanes with `hi`
// keep the upper H n-tiles of v[0 .. 2H), the others the lower, each the
// max of its own and its partner's (lane ^ mask).
template <int H, int NT>
__device__ __forceinline__ void keep_half(float (&v)[NT][2], int mask, bool hi) {
#pragma unroll
  for (int i = 0; i < H; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float send = hi ? v[i][e] : v[i + H][e];
      const float keep = hi ? v[i + H][e] : v[i][e];
      v[i][e] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, mask));
    }
}

// The max over a warp's 16 rows of NT n-tiles (v[j]: a thread's max of its
// rows g and g + 8 at columns 8 j + 2 t, + 1): lane g is left the maxima of
// n-tiles g NT / 8 .. (g + 1) NT / 8 - 1 in v[0 .. NT / 8), in 7 NT / 4
// shuffles against 6 NT for an all-reduce.
template <int NT>
__device__ __forceinline__ void reduce_scatter(float (&v)[NT][2], int g) {
  static_assert(NT % 8 == 0, "eight row lanes");
  keep_half<NT / 2>(v, 16, (g >> 2) & 1);
  keep_half<NT / 4>(v, 8, (g >> 1) & 1);
  keep_half<NT / 8>(v, 4, g & 1);
}

// Ring position j of an m-tile's sequence: SB contiguous bytes of the
// weights' stage copy, which the wrapper lays out once
// (kernels/sa_stage.stage_weights): NR output rows x KP k-panels, K-major
// with the 128-byte swizzle, as the stage lies in shared memory; conv2's
// T2 stages, then conv3's, each chunk by chunk. Where two warpgroups split
// an m-tile, positions alternate between them (warpgroup j % 2 takes its
// half's stage j / 2).
template <int C>
__device__ __forceinline__ const unsigned char* stage_src(int j, const Args& p) {
  using G = Cfg<C>;
  int s = j;
  if (G::SPLIT) {
    const int h = j & 1, i = j >> 1;
    s = i < G::T2 / 2 ? h * (G::T2 / 2) + i : G::T2 + h * ((G::T - G::T2) / 2) + i - G::T2 / 2;
  }
  return s < G::T2 ? reinterpret_cast<const unsigned char*>(p.w2) + (size_t)s * G::SB
                   : reinterpret_cast<const unsigned char*>(p.w3) + (size_t)(s - G::T2) * G::SB;
}

// A consumer warpgroup's place in the ring: its next position (positions
// step by 2 where two warpgroups split an m-tile).
struct Ring {
  uint32_t base, full, empty;   // stage 0, its full and empty barriers
  long long pos;
};

template <int C>
__device__ __forceinline__ uint32_t ring_acquire(const Ring& r, int& slot) {
  slot = (int)(r.pos % Cfg<C>::RING);
  mbar_wait(r.full + 8 * slot, (uint32_t)((r.pos / Cfg<C>::RING) & 1));
  return r.base + slot * Cfg<C>::SB;
}

// The stage `slot` has been read by this warp's wgmma: one arrival a warp.
template <int C>
__device__ __forceinline__ void ring_release(const Ring& r, int slot) {
  if (!Cfg<C>::RESIDENT && (threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * slot);
}

template <int C>
__device__ __forceinline__ void ring_advance(Ring& r) {
  r.pos += Cfg<C>::SPLIT ? 2 : 1;
}

// h1 of m-tile `mt` of group `grp` into the buffer at `h1` (64 rows,
// K-major, 128-byte swizzle): thread `wt` of the THR that share the m-tile
// takes the 8 channels of unit u of rows r0, r0 + RPI, ..., with the loads
// of up to 8 rows in flight at once (against 4: 3-11 % off each stage).
template <int C>
__device__ __forceinline__ void gather(unsigned char* h1, int grp, int mt, int BS, int wt,
                                       const Args& p) {
  constexpr int THR = Cfg<C>::SPLIT ? 256 : 128;
  constexpr int U = C / 8, RPI = THR / U, ITERS = 64 / RPI, UNR = ITERS < 8 ? ITERS : 8;
  const int u = wt % U, r0 = wt / U;
  const float4* s1 = reinterpret_cast<const float4*>(p.s1) + 2 * u;
  const float4* t1 = reinterpret_cast<const float4*>(p.t1) + 2 * u;
  const float4 sa = __ldg(s1), sb = __ldg(s1 + 1), ta = __ldg(t1), tb = __ldg(t1 + 1);
  const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  const float sh[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
  for (int j0 = 0; j0 < ITERS; j0 += UNR) {
    uint4 a[UNR], c[UNR];
#pragma unroll
    for (int q = 0; q < UNR; ++q) {
      const int r = r0 + (j0 + q) * RPI;
      const int centre = min(grp * 4 + (r >> 4), BS - 1);
      const int k = min(mt * 16 + (r & 15), p.K - 1);
      const int row = centre * p.K + k;
      const size_t src = ((size_t)(centre / p.S) * p.N + __ldg(p.idx + row)) * C + 8 * u;
      a[q] = __ldg(reinterpret_cast<const uint4*>(p.A + src));
      c[q] = __ldg(reinterpret_cast<const uint4*>(p.Ct + (size_t)centre * C + 8 * u));
    }
#pragma unroll
    for (int q = 0; q < UNR; ++q) {
      const int r = r0 + (j0 + q) * RPI;
      const uint32_t av[4] = {a[q].x, a[q].y, a[q].z, a[q].w};
      const uint32_t cv[4] = {c[q].x, c[q].y, c[q].z, c[q].w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = unpack_bf16(av[e]), y = unpack_bf16(cv[e]);
        o[e] = pack_bf16(fmaxf((x.x + y.x) * sc[2 * e] + sh[2 * e], 0.f),
                         fmaxf((x.y + y.y) * sc[2 * e + 1] + sh[2 * e + 1], 0.f));
      }
      *reinterpret_cast<uint4*>(h1 + sw128(r, 8 * u, 64)) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(Cfg<C>::THREADS, 1) sa_wgmma_kernel(const Args p) {
  using G = Cfg<C>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(smem);
  const uint32_t full = sb + G::BAR_OFF, empty = full + 8 * G::RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int BS = p.R / p.K;                       // centres
  const int q = (p.K + 15) / 16;                  // m-tiles a group
  const int groups = (BS + 3) / 4, supers = (groups + G::GPR - 1) / G::GPR;

  if (threadIdx.x == 0) {
    for (int i = 0; i < G::RING; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, G::SPLIT ? 4 : 4 * G::NWG);   // the warps a stage serves
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * G::NWG) {
    // ---- the producer warpgroup: one lane loads the m-tiles' stage
    // sequence in ring order, a bulk copy a stage, as far ahead as the
    // ring's free stages allow
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::PRODUCER_REGS));
    if (threadIdx.x != 128 * G::NWG) return;
    const long long rounds = (supers - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const long long total = G::RESIDENT ? G::T : rounds * q * G::T;
    int slot = 0;
    uint32_t phase = 0;
    for (long long it = 0; it < total; ++it) {
      if (!G::RESIDENT && it >= G::RING) mbar_wait(empty + 8 * slot, phase ^ 1u);
      mbar_expect_tx(full + 8 * slot, G::SB);
      bulk_load(sb + slot * G::SB, stage_src<C>((int)(it % G::T), p), G::SB, full + 8 * slot);
      if (++slot == G::RING) {
        slot = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  // ---- a consumer warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::CONSUMER_REGS));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int wq = __shfl_sync(0xffffffffu, warp & 3, 0);
  const int wt = G::SPLIT ? threadIdx.x : threadIdx.x & 127, g = lane >> 2, t = lane & 3;
  const int buf = G::SPLIT ? 0 : wg;
  const int cb = G::SPLIT ? wg * G::CW : 0;      // the warpgroup's first column
  unsigned char* h1 = smem + G::H1_OFF + buf * G::H1B;
  const uint32_t h1b = smem_addr(h1);
  float* runmax = reinterpret_cast<float*>(smem + G::MAX_OFF + buf * G::MAXB) + wq * C + cb;
  Ring ring{sb, full, empty, G::SPLIT ? wg : 0};

  for (int sg = blockIdx.x; sg < supers; sg += gridDim.x) {
    const int grp = G::SPLIT ? sg : sg * G::NWG + wg;
    if (G::RESIDENT && grp >= groups) break;      // streaming: a dummy keeps the ring's pace
    const int centre = grp * 4 + wq;
    // the lanes' own columns of the running max
    for (int c = 0; c < G::CW / G::NC3; ++c)
#pragma unroll
      for (int i = 0; i < G::OWN; ++i) {
        const int col = owned_col<C>(c, i, g, t);
        if (col >= 0) *reinterpret_cast<float2*>(runmax + col) = make_float2(0.f, 0.f);
      }

    for (int mt = 0; mt < q; ++mt) {
      if (G::RESIDENT) ring.pos = 0;
      // h1: the warps' last reads of the buffer (conv2, or conv3 where h2
      // is there) are done
      tile_bar<C>(wg);
      gather<C>(h1, grp, mt, BS, wt, p);
      fence_async_shared();
      tile_bar<C>(wg);

      // conv2: h2 = relu((h1 @ w2) s2 + t2) of the warpgroup's columns,
      // packed as conv3's A fragments
      uint32_t h2[G::CW / 16][4];
#pragma unroll
      for (int c = 0; c < G::CW / G::NC2; ++c) {
        float acc[G::NC2 / 8][4];
        zero(acc);
        wg_fence();
        int prev = -1, slot;
        for (int s = 0; s < G::SPC2; ++s) {
          const uint32_t st = ring_acquire<C>(ring, slot);
#pragma unroll
          for (int kk = 0; kk < G::KSS2; ++kk)
            Wgmma<G::NC2>::ss(acc, desc_at(h1b, 64, 0, s * 64 * G::KP2 + 16 * kk),
                              desc_at(st, G::NC2, 0, 16 * kk));
          wg_commit();
          if (prev >= 0) {
            wg_wait<1>();
            ring_release<C>(ring, prev);
          }
          prev = slot;
          ring_advance<C>(ring);
        }
        wg_wait<0>();
        wg_pin(acc);
        ring_release<C>(ring, prev);
#pragma unroll
        for (int kk = 0; kk < G::NC2 / 16; ++kk) {
          const int col = cb + c * G::NC2 + 16 * kk + 2 * t;
          const float2 s0 = __ldg(reinterpret_cast<const float2*>(p.s2 + col));
          const float2 h0 = __ldg(reinterpret_cast<const float2*>(p.t2 + col));
          const float2 s8 = __ldg(reinterpret_cast<const float2*>(p.s2 + col + 8));
          const float2 h8 = __ldg(reinterpret_cast<const float2*>(p.t2 + col + 8));
          const float(&x)[4] = acc[2 * kk];
          const float(&y)[4] = acc[2 * kk + 1];
          uint32_t(&a)[4] = h2[c * (G::NC2 / 16) + kk];
          a[0] = pack_bf16(fmaxf(x[0] * s0.x + h0.x, 0.f), fmaxf(x[1] * s0.y + h0.y, 0.f));
          a[1] = pack_bf16(fmaxf(x[2] * s0.x + h0.x, 0.f), fmaxf(x[3] * s0.y + h0.y, 0.f));
          a[2] = pack_bf16(fmaxf(y[0] * s8.x + h8.x, 0.f), fmaxf(y[1] * s8.y + h8.y, 0.f));
          a[3] = pack_bf16(fmaxf(y[2] * s8.x + h8.x, 0.f), fmaxf(y[3] * s8.y + h8.y, 0.f));
        }
      }

      if constexpr (G::SPLIT) {
        // h2 of both halves into the h1 buffer (K-major, swizzled) once
        // both warpgroups' conv2 have read h1: conv3's A operand
        tile_bar<C>(wg);
        const int r = 16 * wq + g;
#pragma unroll
        for (int kk = 0; kk < G::CW / 16; ++kk) {
          const int k = cb + 16 * kk + 2 * t;
          *reinterpret_cast<uint32_t*>(h1 + sw128(r, k, 64)) = h2[kk][0];
          *reinterpret_cast<uint32_t*>(h1 + sw128(r + 8, k, 64)) = h2[kk][1];
          *reinterpret_cast<uint32_t*>(h1 + sw128(r, k + 8, 64)) = h2[kk][2];
          *reinterpret_cast<uint32_t*>(h1 + sw128(r + 8, k + 8, 64)) = h2[kk][3];
        }
        fence_async_shared();
        tile_bar<C>(wg);
      }

      // conv3 + the max over the centre's rows of this m-tile
      for (int c = 0; c < G::CW / G::NC3; ++c) {
        float acc[G::NC3 / 8][4];
        zero(acc);
        wg_fence();
        int prev = -1, slot;
        if constexpr (G::SPLIT) {     // A (h2) from shared memory
          for (int s = 0; s < G::SPC3; ++s) {
            const uint32_t st = ring_acquire<C>(ring, slot);
#pragma unroll
            for (int kk = 0; kk < G::KSS3; ++kk)
              Wgmma<G::NC3>::ss(acc, desc_at(h1b, 64, 0, s * 64 * G::KP3 + 16 * kk),
                                desc_at(st, G::NC3, 0, 16 * kk));
            wg_commit();
            if (prev >= 0) {
              wg_wait<1>();
              ring_release<C>(ring, prev);
            }
            prev = slot;
            ring_advance<C>(ring);
          }
        } else {                      // A (h2) from registers
#pragma unroll
          for (int s = 0; s < G::SPC3; ++s) {
            const uint32_t st = ring_acquire<C>(ring, slot);
#pragma unroll
            for (int kk = 0; kk < G::KSS3; ++kk)
              Wgmma<G::NC3>::rs(acc, h2[s * 4 * G::KP3 + kk], desc_at(st, G::NC3, 0, 16 * kk));
            wg_commit();
            if (prev >= 0) {
              wg_wait<1>();
              ring_release<C>(ring, prev);
            }
            prev = slot;
            ring_advance<C>(ring);
          }
        }
        wg_wait<0>();
        wg_pin(acc);
        ring_release<C>(ring, prev);
        float v[G::NT3][2];
#pragma unroll
        for (int j = 0; j < G::NT3; ++j) {
          const int col = cb + c * G::NC3 + 8 * j + 2 * t;
          const float2 s = __ldg(reinterpret_cast<const float2*>(p.s3 + col));
          const float2 h = __ldg(reinterpret_cast<const float2*>(p.t3 + col));
          v[j][0] = fmaxf(acc[j][0] * s.x + h.x, acc[j][2] * s.x + h.x);
          v[j][1] = fmaxf(acc[j][1] * s.y + h.y, acc[j][3] * s.y + h.y);
        }
        if constexpr (G::NT3 >= 8) {
          reduce_scatter<G::NT3>(v, g);
        } else {        // C = 32: an all-reduce, lane g < NT3 keeps n-tile g
#pragma unroll
          for (int j = 0; j < G::NT3; ++j) {
            v[j][0] = shfl_max(v[j][0]);
            v[j][1] = shfl_max(v[j][1]);
            if (j == g) v[0][0] = v[j][0], v[0][1] = v[j][1];
          }
        }
#pragma unroll
        for (int i = 0; i < G::OWN; ++i) {
          const int col = owned_col<C>(c, i, g, t);
          if (col >= 0) {
            float2* m = reinterpret_cast<float2*>(runmax + col);
            const float2 o = *m;
            *m = make_float2(fmaxf(o.x, v[i][0]), fmaxf(o.y, v[i][1]));
          }
        }
      }
    }
    if (centre < BS)
      for (int c = 0; c < G::CW / G::NC3; ++c)
#pragma unroll
        for (int i = 0; i < G::OWN; ++i) {
          const int col = owned_col<C>(c, i, g, t);
          if (col >= 0) {
            const float2 m = *reinterpret_cast<const float2*>(runmax + col);
            *reinterpret_cast<uint32_t*>(p.out + (size_t)centre * C + cb + col) =
                pack_bf16(m.x, m.y);
          }
        }
  }
}

template <int C>
int launch_wgmma(const Args& p, cudaStream_t stream) {
  using G = Cfg<C>;
  auto kernel = sa_wgmma_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::THREADS, G::BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = (p.R / p.K + 3) / 4, supers = (groups + G::GPR - 1) / G::GPR;
  const int blocks = supers < sms * per_sm ? supers : sms * per_sm;
  kernel<<<blocks, G::THREADS, G::BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- the mma_sync tier (the first version) -------------------------------------

namespace mma_sync_tier {

constexpr int WARPS = 8;      // warps a block; 16 where there are 16 column chunks
constexpr int PF = 2;         // k-steps a warp's B fragments are loaded ahead

struct Tiles {
  int mt, groups, chunks;     // m-tiles per row group, row groups, column chunks
  int nt, warps;              // n-tiles a warp's chunk, warps a block
  __host__ __device__ int M() const { return groups * mt * 16; }
  size_t smem(int C) const { return (size_t)2 * M() * (C + 8) * sizeof(bf16); }
};

constexpr int max_mt(int nt) { return nt == 1 ? 8 : nt == 2 ? 4 : 3; }

// M per C as in the float32 kernel (4 MT NT accumulators a thread, two
// 8-warp blocks or one 16-warp block a SM); the buffers take half its bytes,
// which fit a block at every width the tier takes (192,000 at C = 992).
Tiles tiles(int C) {
  const int ntiles = C / 8;
  int nt = 1;
  for (int d = 2; d <= 4; d *= 2)
    if (ntiles % d == 0 && ntiles / d >= WARPS) nt = d;
  Tiles tl{};
  tl.nt = nt;
  tl.chunks = ntiles / nt;
  tl.warps = tl.chunks >= 2 * WARPS ? 2 * WARPS : WARPS;
  tl.groups = tl.chunks < tl.warps ? tl.warps / tl.chunks : 1;
  tl.mt = max_mt(nt);
  return tl;
}

// dst[r][c] = bf16(relu((src @ w)[r][c] * sc[c] + sh[c])) for the block's
// rows, a warp per (row group, column chunk) job; src and dst are bf16 rows
// padded to C + 8.
template <int NT, int MT, int W>
__device__ __forceinline__ void conv_layer(const bf16* src, bf16* dst,
                                           const bf16* __restrict__ w,
                                           const float* __restrict__ sc,
                                           const float* __restrict__ sh,
                                           const Args& p, const Tiles& tl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int C = p.C, LD = C + 8, ksteps = C / 16, mt = tl.mt;
  for (int job = warp; job < tl.groups * tl.chunks; job += W) {
    const int row0 = (job / tl.chunks) * mt * 16;
    const int col0 = (job % tl.chunks) * NT * 8;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    // B fragment of k-step kk, n-tile j: the bf16 pairs w[n][16 kk + 2t, +1]
    // and w[n][16 kk + 2t + 8, +9] with n = col0 + 8 j + g (w is (out, in))
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(w + (size_t)(col0 + g) * C) + t;
    uint32_t bn[PF][NT][2];
#pragma unroll
    for (int q = 0; q < PF; ++q)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bn[q][j][0] = __ldg(wp + (size_t)j * 4 * C + q * 8);
        bn[q][j][1] = __ldg(wp + (size_t)j * 4 * C + q * 8 + 4);
      }
    // ldmatrix .x4: lanes 0-15 give rows 0-15 at column 16 kk, lanes 16-31
    // the same rows at 16 kk + 8: the four 8 x 8 blocks a0 (rows 0-7, cols
    // 0-7), a1 (8-15, 0-7), a2 (0-7, 8-15), a3 (8-15, 8-15)
    const uint32_t abase = (uint32_t)__cvta_generic_to_shared(
        src + (row0 + (lane & 15)) * LD + (lane >> 4) * 8);
    for (int k0 = 0; k0 < ksteps; k0 += PF) {
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        const int kk = k0 + q;
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) { b[j][0] = bn[q][j][0]; b[j][1] = bn[q][j][1]; }
        if (kk + PF < ksteps) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bn[q][j][0] = __ldg(wp + (size_t)j * 4 * C + (kk + PF) * 8);
            bn[q][j][1] = __ldg(wp + (size_t)j * 4 * C + (kk + PF) * 8 + 4);
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < mt) {
            uint32_t a[4];
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
                         : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                         : "r"(abase + (uint32_t)(i * 16 * LD + kk * 16) * 2u));
#pragma unroll
            for (int j = 0; j < NT; ++j) mma(acc[i][j], a, b[j][0], b[j][1]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      const float2 s = *reinterpret_cast<const float2*>(sc + col);
      const float2 h = *reinterpret_cast<const float2*>(sh + col);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mt) {
          bf16* d = dst + (row0 + 16 * i + g) * LD + col;
          *reinterpret_cast<uint32_t*>(d) = pack_bf16(
              fmaxf(acc[i][j][0] * s.x + h.x, 0.f), fmaxf(acc[i][j][1] * s.y + h.y, 0.f));
          *reinterpret_cast<uint32_t*>(d + 8 * LD) = pack_bf16(
              fmaxf(acc[i][j][2] * s.x + h.x, 0.f), fmaxf(acc[i][j][3] * s.y + h.y, 0.f));
        }
      }
    }
  }
}

// max into a bf16 of `out` shared with other blocks: a compare-and-swap on
// its 32-bit word. The values are >= 0, whose bits order as signed shorts
// (-0, 0x8000, the least).
__device__ __forceinline__ void atomic_max_bf16(bf16* addr, bf16 value) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(addr);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~(uintptr_t)3);
  const int shift = (a & 2) ? 16 : 0;
  const unsigned short v = __bfloat16_as_ushort(value);
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    if ((short)((assumed >> shift) & 0xffffu) >= (short)v) return;
    old = atomicCAS(word, assumed,
                    (assumed & ~(0xffffu << shift)) | ((unsigned int)v << shift));
  } while (old != assumed);
}

template <int NT, int MT, int W>
__global__ void __launch_bounds__(32 * W, 16 / W) sa_convmax_bf16_kernel(const Args p,
                                                                         const Tiles tl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int C = p.C, LD = C + 8, M = tl.M();
  bf16* buf1 = smem;
  bf16* buf2 = smem + M * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * M;
  const int rows = min(M, p.R - r0);

  // 1. gather + centre term + BN1 + relu -> buf1 (bf16); padded rows are 0.
  // Lane j of a warp holds the source offsets of row warp + W j.
  const float4* s1 = reinterpret_cast<const float4*>(p.s1);
  const float4* t1 = reinterpret_cast<const float4*>(p.t1);
  const int per = M / W;
  long long src = -1, ctr = 0;
  if (lane < per && warp + W * lane < rows) {
    const int row = r0 + warp + W * lane, centre = row / p.K;
    src = ((long long)(centre / p.S) * p.N + __ldg(p.idx + row)) * C;
    ctr = (long long)centre * C;
  }
#pragma unroll 4
  for (int j = 0; j < per; ++j) {
    const long long sj = __shfl_sync(0xffffffffu, src, j);
    const long long cj = __shfl_sync(0xffffffffu, ctr, j);
    uint2* dst = reinterpret_cast<uint2*>(buf1 + (warp + W * j) * LD);
    const uint2* a = reinterpret_cast<const uint2*>(p.A + sj);
    const uint2* ct = reinterpret_cast<const uint2*>(p.Ct + cj);
    for (int c = lane; c < C / 4; c += 32) {
      uint2 v = make_uint2(0u, 0u);
      if (sj >= 0) {
        const uint2 xa = __ldg(a + c), xc = __ldg(ct + c);
        const float4 s = __ldg(s1 + c), h = __ldg(t1 + c);
        const float2 a01 = unpack_bf16(xa.x), a23 = unpack_bf16(xa.y);
        const float2 c01 = unpack_bf16(xc.x), c23 = unpack_bf16(xc.y);
        v.x = pack_bf16(fmaxf((a01.x + c01.x) * s.x + h.x, 0.f),
                        fmaxf((a01.y + c01.y) * s.y + h.y, 0.f));
        v.y = pack_bf16(fmaxf((a23.x + c23.x) * s.z + h.z, 0.f),
                        fmaxf((a23.y + c23.y) * s.w + h.w, 0.f));
      }
      dst[c] = v;
    }
  }
  __syncthreads();
  // 2, 3. the two convs, each warp its own columns
  conv_layer<NT, MT, W>(buf1, buf2, p.w2, p.s2, p.t2, p, tl);
  __syncthreads();
  conv_layer<NT, MT, W>(buf2, buf1, p.w3, p.s3, p.t3, p, tl);
  __syncthreads();

  // 4. max over each centre's rows in this block
  const int first = r0 / p.K, centres = (r0 + rows - 1) / p.K - first + 1;
  for (int e = threadIdx.x; e < centres * C; e += 32 * W) {
    const int centre = first + e / C, c = e % C;
    const int lo = max(centre * p.K, r0), hi = min((centre + 1) * p.K, r0 + rows);
    float m = 0.f;
    for (int r = lo - r0; r < hi - r0; ++r) m = fmaxf(m, __bfloat162float(buf1[r * LD + c]));
    bf16* o = p.out + (size_t)centre * C + c;
    if (lo == centre * p.K && hi == (centre + 1) * p.K)
      *o = __float2bfloat16_rn(m);
    else
      atomic_max_bf16(o, __float2bfloat16_rn(m));
  }
}

template <int NT, int W>
int launch(const Args& p, const Tiles& tl, int blocks, cudaStream_t stream) {
  constexpr int MT = max_mt(NT);
  const size_t smem = tl.smem(p.C);
  cudaError_t err = cudaFuncSetAttribute(
      sa_convmax_bf16_kernel<NT, MT, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sa_convmax_bf16_kernel<NT, MT, W><<<blocks, 32 * W, smem, stream>>>(p, tl);
  return (int)cudaGetLastError();
}

int run(const Args& p, cudaStream_t st) {
  const Tiles tl = tiles(p.C);
  const int M = tl.M();
  if (M % p.K != 0) {     // partial centres: a max into zeros
    cudaError_t err = cudaMemsetAsync(p.out, 0, (size_t)p.R / p.K * p.C * sizeof(bf16), st);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (int)(((long long)p.R + M - 1) / M);
  if (tl.warps == 2 * WARPS) return launch<4, 2 * WARPS>(p, tl, blocks, st);
  switch (tl.nt) {
    case 1: return launch<1, WARPS>(p, tl, blocks, st);
    case 2: return launch<2, WARPS>(p, tl, blocks, st);
    default: return launch<4, WARPS>(p, tl, blocks, st);
  }
}

}  // namespace mma_sync_tier

// ---- the plan -------------------------------------------------------------------

enum Tier { WGMMA = 0, MMA_SYNC = 1, WIDE = 2 };
enum PlanField { TIER, TILE_ROWS, WARPGROUPS, CLUSTER, RING_STAGES, SMEM, WHOLE, SCRATCH, FIELDS };

template <int C>
void wgmma_plan(long long* plan) {
  using G = Cfg<C>;
  plan[TIER] = WGMMA;
  plan[TILE_ROWS] = 64 * G::GPR;     // rows each weight stage serves at once
  plan[WARPGROUPS] = G::NWG;
  plan[CLUSTER] = 1;
  plan[RING_STAGES] = G::RING;
  plan[SMEM] = G::BYTES;
  plan[WHOLE] = 1;                   // a centre's rows lie in one warp
  plan[SCRATCH] = 0;
}

// Fills plan[FIELDS] for width C and K neighbours; 0, or
// cudaErrorInvalidValue for a shape no tier takes.
int make_plan(int C, int K, long long* plan) {
  if (C < 32 || C > sawide::MAX_C || C % 32 != 0 || K < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 32: wgmma_plan<32>(plan); return 0;
    case 64: wgmma_plan<64>(plan); return 0;
    case 128: wgmma_plan<128>(plan); return 0;
    case 256: wgmma_plan<256>(plan); return 0;
    case 512: wgmma_plan<512>(plan); return 0;
    case 1024: wgmma_plan<1024>(plan); return 0;
    default: break;
  }
  plan[CLUSTER] = 1;
  if (C > 1024) {
    plan[TIER] = WIDE;
    sawide::plan<sawide::Bf16>(C, plan[TILE_ROWS], plan[WARPGROUPS], plan[RING_STAGES],
                               plan[SMEM], plan[SCRATCH]);
    plan[WHOLE] = 1;
    return 0;
  }
  const mma_sync_tier::Tiles tl = mma_sync_tier::tiles(C);
  plan[TIER] = MMA_SYNC;
  plan[TILE_ROWS] = tl.M();
  plan[WARPGROUPS] = 0;
  plan[RING_STAGES] = 0;
  plan[SMEM] = (long long)tl.smem(C);
  plan[WHOLE] = tl.M() % K == 0;
  plan[SCRATCH] = 0;
  return 0;
}

}  // namespace

// The launch plan for width C and K neighbours, 8 values: tier (0 wgmma,
// 1 mma_sync, 2 wide), rows a tile (a weight stage serves them at once),
// consumer warpgroups, cluster size, ring stages, shared bytes a block,
// whether every centre lies whole in a tile, the scratch bytes a block
// (wide). Returns 0, or cudaErrorInvalidValue.
extern "C" int pcr_sa_bf16_layout(int C, int K, long long* plan) {
  return make_plan(C, K, plan);
}

// A, Ct, out bf16; w2, w3 bf16 (C, C): the wgmma tier's stage copies
// (kernels/sa_stage.stage_weights), the mma_sync tier's (out, in) layout;
// the affines float32. C a multiple of 32 up to 1024 (past it the wide
// tier's entry below).
extern "C" int pcr_sa_convmax_bf16(const void* A, const void* Ct, const void* idx,
                                   const void* w2, const void* w3, const void* s1,
                                   const void* t1, const void* s2, const void* t2,
                                   const void* s3, const void* t3, void* out,
                                   int B, int N, int S, int K, int C, void* stream) {
  const long long R = (long long)B * S * K;
  long long plan[FIELDS];
  if (make_plan(C, K, plan) != 0 || plan[TIER] == WIDE || R >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const Args p{(const bf16*)A, (const bf16*)Ct, (const int*)idx, (const bf16*)w2,
               (const bf16*)w3, (const float*)s1, (const float*)t1, (const float*)s2,
               (const float*)t2, (const float*)s3, (const float*)t3, (bf16*)out,
               N, S, K, C, (int)R};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 32: return launch_wgmma<32>(p, st);
    case 64: return launch_wgmma<64>(p, st);
    case 128: return launch_wgmma<128>(p, st);
    case 256: return launch_wgmma<256>(p, st);
    case 512: return launch_wgmma<512>(p, st);
    case 1024: return launch_wgmma<1024>(p, st);
    default: return mma_sync_tier::run(p, st);
  }
}

// The wide tier (csrc/sa_wide_wg.cuh): C a multiple of 64 up to 8192; w2,
// w3 the wrapper's stage copies (kernels/sa_stage.wide_stage_weights);
// `blocks` persistent blocks, each with `stride` bytes of `scratch` (at
// least the plan's scratch bytes).
extern "C" int pcr_sa_convmax_wide_bf16(const void* A, const void* Ct, const void* idx,
                                        const void* w2, const void* w3, const void* s1,
                                        const void* t1, const void* s2, const void* t2,
                                        const void* s3, const void* t3, void* out,
                                        void* scratch, int B, int N, int S, int K, int C,
                                        int blocks, long long stride, void* stream) {
  const long long R = (long long)B * S * K;
  if (R >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const sawide::Args<sawide::Bf16> a{
      (const bf16*)A, (const bf16*)Ct, (const int*)idx, (const unsigned char*)w2,
      (const unsigned char*)w3, (const float*)s1, (const float*)t1, (const float*)s2,
      (const float*)t2, (const float*)s3, (const float*)t3, (bf16*)out,
      (unsigned char*)scratch, stride, N, S, K, C, (int)R};
  return sawide::launch(a, blocks, (cudaStream_t)stream);
}
