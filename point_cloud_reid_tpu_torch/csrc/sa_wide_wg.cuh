// The eval SA stage past the row tiles' widths on Hopper's warpgroup
// products (wgmma), shared by its two dtypes: csrc/sa_stage.cu instantiates
// it for a float32 model (policy Tf32: every product three TF32 passes,
// hi*hi + hi*lo + lo*hi, as csrc/tf32_mma.cuh splits), csrc/sa_stage_bf16.cu
// for a bf16 model (policy Bf16: one bf16 pass, bf16 h1 and h2, float32
// accumulation). Per crop b and centre s it computes what
// kernels/sa_stage.sa_convmax_reference does:
//
//   h1[k] = relu((A[b, idx[b,s,k]] + Ct[b,s]) * s1 + t1)
//   h2[k] = relu((h1[k] @ w2) * s2 + t2)
//   h3[k] = relu((h2[k] @ w3) * s3 + t3)
//   out[b,s] = max_k h3[k]
//
// It replaces point_cloud_reid_tpu/ops/pallas/sa_stage.py fused_sa_convmax
// (:78) at the widths kernels/sa_stage.plan_f32 and plan_bf16 give it (C a
// multiple of 64 up to 8192; the wrapper pads a multiple of 32 to the next
// one with zero lanes, which are exact).
//
// What bounds it on the H100: 4 R C^2 operations (R = B S K rows), three
// TF32 passes at 495 TFLOP/s or one bf16 pass at 989 (the mul16 model's SA3
// at C = 2048, B = 128: 20.0 / 3.3 ms). What held the 16-row tiles back
// (csrc/sa_stage.cu's h1-from-gather layout, csrc/sa_stage_bf16.cu's
// mma_sync tier): every block of 16 rows read both C x C weights from L2
// (~400 / 200 GB a call at C = 2048), on mma.sync. Here:
//  - rows in centre groups (as the bf16 wgmma tier): a group is 4 centres;
//    its 64-row m-tile i holds neighbours 16 i .. 16 i + 15 of each centre,
//    warp w of the warpgroup the rows of centre w. Slots past K repeat
//    neighbour K - 1 (a max is blind to a repeat), centres past B S repeat
//    the last centre and are not stored. So a centre lies whole in one warp
//    at any K, and no zero-fill or atomic max is needed;
//  - a persistent grid of blocks of two consumer warpgroups, each a group
//    of its own (one m-tile after the other), and a producer warpgroup that
//    gives its registers to them (setmaxnreg); every weight stage serves
//    both warpgroups' m-tiles, 128 rows (against 16);
//  - h1 and h2 of an m-tile (64 x C: 512 KB float32 at C = 2048) do not fit
//    a block's shared memory. Each warpgroup writes them once into its part
//    of a device scratch, in the A-stage layout (64 rows x one 128-byte
//    k-panel a stage, K-major, the 128-byte swizzle of csrc/bf16_mma.cuh):
//    h1 from the gather (A rows + Ct, BN1, ReLU), h2 from conv2's epilogue.
//    The producer streams them back as A stages through the same ring as
//    the weights' B stages, after the consumers' event (each warp's
//    fence.proxy.async.global, then an arrival on one mbarrier);
//  - the ring: 14 slots of 16 KB, one cp.async.bulk stage a slot (or both
//    warpgroups' 8 KB A stages in one), full / empty mbarriers, waits that
//    trap after 2^34 cycles. An output chunk is 128 columns (64 at the end
//    of a width 64 past a multiple of 128); a chunk's k-panel takes the A
//    slot, then its B slots (Tf32: one 64-row block a slot, hi then lo;
//    Bf16: both 64-row blocks in one slot, one 128-row operand), in the
//    order of the wrapper's stage copy (kernels/sa_stage.wide_stage_weights);
//  - products on wgmma m64n64/128: at bf16 both operands from shared memory
//    (two panels in flight); at TF32 A (float32 in the stage) loaded into
//    registers and split hi / lo there, so the A stages and the scratch
//    hold 4 bytes a value, B (hi, lo) from shared memory, three passes the
//    small terms first, one panel in flight, each 4 panels' products summed
//    apart and added into the accumulator on the CUDA cores (product);
//  - conv3 fused with the max: each chunk's epilogue applies s3 / t3, takes
//    the max of a thread's two rows, reduce-scatters over the fragment's 8
//    row lanes and folds each lane's columns into its centre's running max
//    (the warpgroup's scratch, 4 x C floats, each element read and written
//    by its owning lane only); after a group's last m-tile the owning lanes
//    store max(0, running max) once a centre.
// Shared memory: 1024 (alignment) + 14 x 16,384 + the barriers = 230,632
// bytes at any C; the scratch a block: 2 x (2 C / PK x 8,192 + 16 C) bytes
// (PK: 32 TF32 / 64 bf16 k a stage), 2,162,688 / 1,114,112 at C = 2048,
// 4,325,376 / 2,228,224 at 4096, 8,650,752 / 4,456,448 at 8192 (1.14 GB
// over 132 blocks at float32). Every offset that can pass 2^31 at 8192
// channels is 64-bit: the gather's row offsets (B N C), the stage copies
// (2 C^2 x 4 bytes a weight at TF32, 512 MB) and the scratch (the block
// index times its stride); R = B S K < 2^31 is the wrapper's bound.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace sawide {

using bf16mma::bf16;
using bf16mma::desc_sw128;
using bf16mma::smem_addr;

constexpr int WGS = 2;                      // consumer warpgroups
constexpr int CWARPS = 4 * WGS;             // consumer warps
constexpr int THREADS = 128 * (WGS + 1);    // + the producer warpgroup
constexpr int TILE = 64;                    // rows of an m-tile
constexpr int AB = 8192;                    // bytes of an A stage (64 rows x 128)
constexpr int SLOT = 16384;                 // bytes of a ring slot
constexpr int RING = 14;                    // slots
constexpr int BAR_OFF = RING * SLOT;        // full, empty, aready
constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 * RING + 1);
constexpr int MAX_C = 8192;                 // widest stage (kernels/sa_stage.MAX_C)
constexpr size_t SMEM_LIMIT = 232448;
static_assert(BYTES <= (int)SMEM_LIMIT, "shared memory");
// registers a thread after setmaxnreg: 128 x (2 x 232 + 40) <= 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// ---- the two policies -------------------------------------------------------------

// Three TF32 passes a product (a float32 model).
struct Tf32 {
  typedef float T;
  static constexpr int PK = 32;         // K columns a stage (128 bytes)
  static constexpr int UNIT = 4;        // values a 16-byte unit
  static constexpr int BLOCK = 16384;   // bytes of a 64-row B stage: hi, then lo
  static constexpr bool SLOT_A_BLOCK = true;   // one B block a slot

  // d[8 rb ..] += the warp's rows of A stage `a` (float32, K natural) @ B
  // stage b[rb] (64 output columns) for rb < nb: A's fragments loaded and
  // split into registers, three passes a k-step; issued, not committed.
  // The registers of A stay live until the caller waits for the group.
  struct Frag {
    uint32_t hi[4][4], lo[4][4];
    // keeps the registers live up to here (wgmma reads them until its wait)
    __device__ __forceinline__ void pin() {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(hi[s][i]), "+r"(lo[s][i])::"memory");
    }
  };
  static constexpr int DEPTH = 1;       // panels in flight: a panel's A takes 32 registers
  static constexpr int PROMOTE = 4;     // panels summed on the tensor cores before d
  static __device__ __forceinline__ void panel(float (&d)[16][4], uint32_t a, uint32_t b0,
                                               uint32_t b1, int nb, Frag& f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint32_t r0 = a + (uint32_t)(16 * ((threadIdx.x >> 5) & 3) + g) * 128 + 4 * t;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t u0 = (uint32_t)(((2 * s) ^ g) << 4), u1 = (uint32_t)(((2 * s + 1) ^ g) << 4);
      float x[4];
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[0]) : "r"(r0 + u0));
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[1]) : "r"(r0 + 1024 + u0));
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[2]) : "r"(r0 + u1));
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x[3]) : "r"(r0 + 1024 + u1));
#pragma unroll
      for (int i = 0; i < 4; ++i) tf32::split_tf32(x[i], f.hi[s][i], f.lo[s][i]);
    }
    bf16mma::wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        if (rb < nb) {
          float(&dd)[8][4] = *reinterpret_cast<float(*)[8][4]>(&d[8 * rb][0]);
          const uint32_t b = rb ? b1 : b0;
          const uint64_t bh = desc_sw128(b + 32 * s), bl = desc_sw128(b + 8192 + 32 * s);
          tf32::Wgmma<64>::rs(dd, f.lo[s], bh);
          tf32::Wgmma<64>::rs(dd, f.hi[s], bl);
          tf32::Wgmma<64>::rs(dd, f.hi[s], bh);
        }
      }
  }

  // A unit's centre term and BN1 (4 channels from c), then h1 of a row's
  // unit as a 16-byte A-stage unit
  struct Coef {
    float4 y, s, h;
  };
  static __device__ __forceinline__ Coef coef(const T* Ct, const float* s1, const float* t1,
                                              int c) {
    return Coef{__ldg(reinterpret_cast<const float4*>(Ct + c)),
                __ldg(reinterpret_cast<const float4*>(s1 + c)),
                __ldg(reinterpret_cast<const float4*>(t1 + c))};
  }
  static __device__ __forceinline__ uint4 h1_unit(const T* A, const Coef& k) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(A));
    return make_uint4(__float_as_uint(fmaxf((x.x + k.y.x) * k.s.x + k.h.x, 0.f)),
                      __float_as_uint(fmaxf((x.y + k.y.y) * k.s.y + k.h.y, 0.f)),
                      __float_as_uint(fmaxf((x.z + k.y.z) * k.s.z + k.h.z, 0.f)),
                      __float_as_uint(fmaxf((x.w + k.y.w) * k.s.w + k.h.w, 0.f)));
  }
  // element (row, col) pair (col even) of an A stage buffer of PK-wide panels
  static __device__ __forceinline__ void put_pair(unsigned char* buf, int row, int col, float x,
                                                  float y) {
    unsigned char* st = buf + (size_t)(col / PK) * AB;
    const int k = col % PK;
    *reinterpret_cast<float2*>(st + row * 128 + ((((k >> 2) ^ (row & 7))) << 4) + (k & 3) * 4) =
        make_float2(x, y);
  }
  static __device__ __forceinline__ void store_out(T* out, float2 m) {
    *reinterpret_cast<float2*>(out) = m;
  }
};

// One bf16 pass a product (a bf16 model).
struct Bf16 {
  typedef bf16 T;
  static constexpr int PK = 64;
  static constexpr int UNIT = 8;
  static constexpr int BLOCK = 8192;    // bytes of a 64-row B stage
  static constexpr bool SLOT_A_BLOCK = false;  // a chunk's blocks share one slot

  struct Frag {
    __device__ __forceinline__ void pin() {}
  };
  static constexpr int DEPTH = 2;
  static constexpr int PROMOTE = 0;     // bf16 rounding of h1, h2 dominates
  // d += A stage `a` @ the slot's 64 nb output columns (one 128-row operand
  // at nb = 2), both from shared memory; issued, not committed.
  static __device__ __forceinline__ void panel(float (&d)[16][4], uint32_t a, uint32_t b0,
                                               uint32_t, int nb, Frag&) {
    bf16mma::wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (nb == 2)
        bf16mma::Wgmma<128>::ss(d, desc_sw128(a + 32 * s), desc_sw128(b0 + 32 * s));
      else
        bf16mma::Wgmma<64>::ss(*reinterpret_cast<float(*)[8][4]>(&d[0][0]),
                               desc_sw128(a + 32 * s), desc_sw128(b0 + 32 * s));
    }
  }

  struct Coef {
    float y[8], s[8], h[8];
  };
  static __device__ __forceinline__ Coef coef(const T* Ct, const float* s1, const float* t1,
                                              int c) {
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(Ct + c));
    const float4 sa = __ldg(reinterpret_cast<const float4*>(s1 + c));
    const float4 sb = __ldg(reinterpret_cast<const float4*>(s1 + c + 4));
    const float4 ta = __ldg(reinterpret_cast<const float4*>(t1 + c));
    const float4 tb = __ldg(reinterpret_cast<const float4*>(t1 + c + 4));
    const uint32_t yv[4] = {y.x, y.y, y.z, y.w};
    Coef k{{}, {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w},
           {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 q = bf16mma::unpack_bf16(yv[e]);
      k.y[2 * e] = q.x;
      k.y[2 * e + 1] = q.y;
    }
    return k;
  }
  static __device__ __forceinline__ uint4 h1_unit(const T* A, const Coef& k) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(A));
    const uint32_t xv[4] = {x.x, x.y, x.z, x.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 p = bf16mma::unpack_bf16(xv[e]);
      o[e] = bf16mma::pack_bf16(fmaxf((p.x + k.y[2 * e]) * k.s[2 * e] + k.h[2 * e], 0.f),
                                fmaxf((p.y + k.y[2 * e + 1]) * k.s[2 * e + 1] + k.h[2 * e + 1], 0.f));
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
  static __device__ __forceinline__ void put_pair(unsigned char* buf, int row, int col, float x,
                                                  float y) {
    unsigned char* st = buf + (size_t)(col / PK) * AB;
    const int k = col % PK;
    *reinterpret_cast<uint32_t*>(st + row * 128 + (((k >> 3) ^ (row & 7)) << 4) + (k & 7) * 2) =
        bf16mma::pack_bf16(x, y);
  }
  static __device__ __forceinline__ void store_out(T* out, float2 m) {
    *reinterpret_cast<uint32_t*>(out) = bf16mma::pack_bf16(m.x, m.y);
  }
};

// ---- the layout --------------------------------------------------------------------

// The scratch of one consumer warpgroup: h1 and h2 (C / PK A stages each),
// then the running maxima of its 4 centres (4 x C floats).
template <class M>
__host__ __device__ constexpr long long wg_bytes(int C) {
  return 2LL * (C / M::PK) * AB + 16LL * C;
}
template <class M>
__host__ __device__ constexpr long long scratch_bytes(int C) {
  return WGS * wg_bytes<M>(C);
}

template <class M>
struct Args {
  typedef typename M::T T;
  const T* A;                  // (B, N, C)
  const T* Ct;                 // (B, S, C)
  const int* idx;              // (B, S, K): row r of the list is idx[r]
  const unsigned char* w2;     // the stage copies (wide_stage_weights)
  const unsigned char* w3;
  const float *s1, *t1, *s2, *t2, *s3, *t3;
  T* out;                      // (B, S, C)
  unsigned char* scratch;      // gridDim.x x stride bytes
  long long stride;
  int N, S, K, C, R;           // R = B S K rows
};

// An mbarrier wait that traps (a launch failure the wrapper reports) once it
// has spun for 2^34 cycles, seconds past any wait of a working stage, so
// that a fault in the hand-offs cannot hang the card.
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

// A consumer warpgroup's place in the ring (both take every slot in order).
struct Ring {
  uint32_t base, full, empty;
  int pos;
  __device__ __forceinline__ int acquire() {
    const int slot = pos % RING;
    wait_or_trap(full + 8 * slot, (uint32_t)((pos / RING) & 1));
    ++pos;
    return slot;
  }
  __device__ __forceinline__ uint32_t addr(int slot) const { return base + slot * SLOT; }
  // this warp has read the slot: one arrival a warp
  __device__ __forceinline__ void release(int slot) const {
    if ((threadIdx.x & 31) == 0) bf16mma::mbar_arrive(empty + 8 * slot);
  }
};

// B slots a k-panel of a chunk of nb 64-column blocks
template <class M>
__device__ __forceinline__ int b_slots(int nb) {
  return M::SLOT_A_BLOCK ? nb : 1;
}

// d = the warpgroup's m-tile (its A stages, the slots' halves wg) @ the
// chunk's B stages over np k-panels; up to M::DEPTH panels in flight, a
// panel's slots released once its wgmmas are done. Where M::PROMOTE (TF32)
// the products of each PROMOTE panels go into a fresh accumulator that is
// then added into d on the CUDA cores, rounding to nearest: the tensor
// core's float32 accumulation drops the low bits of each addend, a bias
// that grows with the terms summed into one accumulator (2.8e-5 of max(1,
// |plain|) over the whole K at C = 2048, 2.7e-6 promoted every 4 panels,
// PERF.md section 6).
template <class M>
__device__ __forceinline__ void product(Ring& ring, float (&d)[16][4], int np, int nb, int wg) {
  constexpr int DEPTH = M::DEPTH;
  typename M::Frag f[DEPTH];
  int held[DEPTH][3];
  float part[16][4];
  const int ns = 1 + b_slots<M>(nb);
#pragma unroll 1
  for (int p = 0; p < np; ++p) {
    const int k = p % DEPTH;
    int sl[3];
    sl[0] = ring.acquire();
    sl[1] = ring.acquire();
    sl[2] = ns > 2 ? ring.acquire() : -1;
    const uint32_t a = ring.addr(sl[0]) + wg * AB, b0 = ring.addr(sl[1]),
                   b1 = ns > 2 ? ring.addr(sl[2]) : 0u;
    if constexpr (M::PROMOTE > 0) {     // one panel in flight
      if (p % M::PROMOTE == 0)
#pragma unroll
        for (int i = 0; i < 16; ++i) part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
      M::panel(part, a, b0, b1, nb, f[k]);
      bf16mma::wg_commit();
      bf16mma::wg_wait<0>();
      f[k].pin();
      bf16mma::wg_pin(part);
      for (int i = 0; i < ns; ++i) ring.release(sl[i]);
      if (p % M::PROMOTE == M::PROMOTE - 1 || p == np - 1)
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[i][e] += part[i][e];
      continue;
    }
    M::panel(d, a, b0, b1, nb, f[k]);
    bf16mma::wg_commit();
    if (p > 0) {
      bf16mma::wg_wait<1>();
      const int o = (p - 1) % DEPTH;
      for (int i = 0; i < ns; ++i) ring.release(held[o][i]);
    }
    for (int i = 0; i < 3; ++i) held[k][i] = sl[i];
  }
  if constexpr (M::PROMOTE > 0) return;
  bf16mma::wg_wait<0>();
  if (np > 0)
    for (int i = 0; i < ns; ++i) ring.release(held[(np - 1) % DEPTH][i]);
  bf16mma::wg_pin(d);
}

// h1 of the warp's 16 rows of m-tile mt (centre `centre`, slots 16 mt .. of
// its neighbours, repeating neighbour K - 1) into the warpgroup's h1
// stages: lane j < 16 takes row j's source offset, then each lane a
// 16-byte unit of every row at a time.
template <class M>
__device__ __forceinline__ void gather(unsigned char* h1, int centre, int mt, const Args<M>& a,
                                       int wq, int lane) {
  const int C = a.C;
  long long src = 0;
  if (lane < 16) {
    const int row = centre * a.K + min(mt * 16 + lane, a.K - 1);
    src = ((long long)(centre / a.S) * a.N + __ldg(a.idx + row)) * C;
  }
  long long rs[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) rs[j] = __shfl_sync(0xffffffffu, src, j);
  const typename M::T* ct = a.Ct + (long long)centre * C;
  const int U = C / M::UNIT;
  for (int u = lane; u < U; u += 32) {
    unsigned char* st = h1 + (size_t)(u >> 3) * AB;
    const typename M::Coef k = M::coef(ct, a.s1, a.t1, u * M::UNIT);
#pragma unroll 8
    for (int j = 0; j < 16; ++j) {
      const int r = 16 * wq + j;
      *reinterpret_cast<uint4*>(st + r * 128 + (((u & 7) ^ (r & 7)) << 4)) =
          M::h1_unit(a.A + rs[j] + u * M::UNIT, k);
    }
  }
}

// The consumers' side of an event: this warp's writes of the scratch are
// done (and visible to the producer's bulk copies).
__device__ __forceinline__ void written(uint32_t aready) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bf16mma::mbar_arrive(aready);
}

__device__ __forceinline__ float2 fmax2(float2 a, float2 b) {
  return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
}

// One step of the max's reduce-scatter over the row lanes: lanes with `hi`
// keep the upper H n-tiles of v[0 .. 2H), the others the lower, each the
// max of its own and its partner's (lane ^ mask).
template <int H>
__device__ __forceinline__ void keep_half(float (&v)[16][2], int mask, bool hi) {
#pragma unroll
  for (int i = 0; i < H; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float send = hi ? v[i][e] : v[i + H][e];
      const float keep = hi ? v[i + H][e] : v[i][e];
      v[i][e] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, mask));
    }
}

template <class M>
__global__ void __launch_bounds__(THREADS, 1) sa_wide_kernel(const Args<M> a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(smem);
  const uint32_t full = sb + BAR_OFF, empty = full + 8 * RING, aready = empty + 8 * RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = a.C, PPC = C / M::PK, NCH = (C + 127) / 128;
  const int BS = a.R / a.K;                     // centres
  const int q = (a.K + 15) / 16;                // m-tiles a group
  const int supers = ((BS + 3) / 4 + 1) / 2;    // pairs of groups
  unsigned char* scr = a.scratch + (size_t)blockIdx.x * a.stride;
  const long long wgb = wg_bytes<M>(C);

  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      bf16mma::mbar_init(full + 8 * i, 1);
      bf16mma::mbar_init(empty + 8 * i, CWARPS);
    }
    bf16mma::mbar_init(aready, CWARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CWARPS) {
    // ---- the producer: for each m-tile of the pair of groups, after the
    // event of its h1 conv2's stages, after that of its h2 conv3's; a
    // k-panel of a chunk: the A slot (both warpgroups' stages), its B slots
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 128 * WGS) return;
    int it = 0, ev = 0;
    auto arm = [&](int bytes) -> uint32_t {
      const int s = it % RING;
      if (it >= RING) wait_or_trap(empty + 8 * s, (uint32_t)(((it / RING) - 1) & 1));
      bf16mma::mbar_expect_tx(full + 8 * s, bytes);
      ++it;
      return (uint32_t)s;
    };
    for (int sup = blockIdx.x; sup < supers; sup += gridDim.x)
      for (int mt = 0; mt < q; ++mt)
        for (int conv = 0; conv < 2; ++conv) {
          wait_or_trap(aready, (uint32_t)(ev & 1));
          ++ev;
          const unsigned char* h0 = scr + (size_t)conv * PPC * AB;
          const unsigned char* w = conv ? a.w3 : a.w2;
          for (int j = 0; j < NCH; ++j) {
            const int nb = min(2, C / 64 - 2 * j);
            for (int p = 0; p < PPC; ++p) {
              uint32_t s = arm(2 * AB);
              bf16mma::bulk_load(sb + s * SLOT, h0 + (size_t)p * AB, AB, full + 8 * s);
              bf16mma::bulk_load(sb + s * SLOT + AB, h0 + wgb + (size_t)p * AB, AB, full + 8 * s);
              const unsigned char* wb = w + ((size_t)j * PPC * 2 + (size_t)p * nb) * M::BLOCK;
              if (M::SLOT_A_BLOCK) {
                for (int b = 0; b < nb; ++b) {
                  s = arm(M::BLOCK);
                  bf16mma::bulk_load(sb + s * SLOT, wb + (size_t)b * M::BLOCK, M::BLOCK,
                                     full + 8 * s);
                }
              } else {
                s = arm(nb * M::BLOCK);
                bf16mma::bulk_load(sb + s * SLOT, wb, nb * M::BLOCK, full + 8 * s);
              }
            }
          }
        }
    return;
  }

  // ---- a consumer warpgroup: group 2 sup + wg of each pair
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int wq = __shfl_sync(0xffffffffu, warp & 3, 0);
  const int g = lane >> 2, t = lane & 3, rl = 16 * wq + g;
  unsigned char* h1 = scr + (size_t)wg * wgb;
  unsigned char* h2 = h1 + (size_t)PPC * AB;
  float* rm = reinterpret_cast<float*>(h2 + (size_t)PPC * AB) + wq * C;
  Ring ring{sb, full, empty, 0};

  for (int sup = blockIdx.x; sup < supers; sup += gridDim.x) {
    const int own = (2 * sup + wg) * 4 + wq;    // the warp's centre (stored where < BS)
    const int centre = min(own, BS - 1);
    for (int mt = 0; mt < q; ++mt) {
      gather<M>(h1, centre, mt, a, wq, lane);
      written(aready);

      // conv2: h2 = relu((h1 @ w2) s2 + t2), a 128-column chunk at a time
      for (int j = 0; j < NCH; ++j) {
        const int nb = min(2, C / 64 - 2 * j);
        float acc[16][4];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        product<M>(ring, acc, PPC, nb, wg);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          if (jj < 8 * nb) {
            const int col = 128 * j + 8 * jj + 2 * t;
            const float2 s = __ldg(reinterpret_cast<const float2*>(a.s2 + col));
            const float2 h = __ldg(reinterpret_cast<const float2*>(a.t2 + col));
            M::put_pair(h2, rl, col, fmaxf(acc[jj][0] * s.x + h.x, 0.f),
                        fmaxf(acc[jj][1] * s.y + h.y, 0.f));
            M::put_pair(h2, rl + 8, col, fmaxf(acc[jj][2] * s.x + h.x, 0.f),
                        fmaxf(acc[jj][3] * s.y + h.y, 0.f));
          }
        }
      }
      written(aready);

      // conv3 + the max over the centre's rows of this m-tile
      for (int j = 0; j < NCH; ++j) {
        const int nb = min(2, C / 64 - 2 * j);
        float acc[16][4];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        product<M>(ring, acc, PPC, nb, wg);
        float v[16][2];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          v[jj][0] = v[jj][1] = 0.f;
          if (jj < 8 * nb) {
            const int col = 128 * j + 8 * jj + 2 * t;
            const float2 s = __ldg(reinterpret_cast<const float2*>(a.s3 + col));
            const float2 h = __ldg(reinterpret_cast<const float2*>(a.t3 + col));
            v[jj][0] = fmaxf(acc[jj][0] * s.x + h.x, acc[jj][2] * s.x + h.x);
            v[jj][1] = fmaxf(acc[jj][1] * s.y + h.y, acc[jj][3] * s.y + h.y);
          }
        }
        // lane g keeps n-tiles 2 g, 2 g + 1 in v[0], v[1]
        keep_half<8>(v, 16, (g >> 2) & 1);
        keep_half<4>(v, 8, (g >> 1) & 1);
        keep_half<2>(v, 4, g & 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (2 * g + i < 8 * nb) {
            const int col = 128 * j + 8 * (2 * g + i) + 2 * t;
            float2 m = make_float2(fmaxf(v[i][0], 0.f), fmaxf(v[i][1], 0.f));
            if (mt > 0) m = fmax2(m, *reinterpret_cast<const float2*>(rm + col));
            if (mt < q - 1)
              *reinterpret_cast<float2*>(rm + col) = m;
            else if (own < BS)
              M::store_out(a.out + (size_t)own * C + col, m);
          }
        }
      }
    }
  }
}

template <class M>
int launch(const Args<M>& a, int blocks, cudaStream_t stream) {
  if (a.C < 64 || a.C > MAX_C || a.C % 64 != 0 || a.K < 1 || blocks < 1 ||
      a.stride < scratch_bytes<M>(a.C))
    return (int)cudaErrorInvalidValue;
  if (a.R == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(sa_wide_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  sa_wide_kernel<M><<<blocks, THREADS, BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// The plan's values of the wide layout at width C (a multiple of 32; the
// kernel runs it at the next multiple of 64): rows a weight stage serves,
// consumer warpgroups, ring slots, shared bytes, the scratch bytes a block.
template <class M>
void plan(int C, long long& rows, long long& wgs, long long& ring, long long& smem,
          long long& scratch) {
  rows = 2 * TILE;
  wgs = WGS;
  ring = RING;
  smem = BYTES;
  scratch = scratch_bytes<M>((C + 63) / 64 * 64);
}

}  // namespace sawide
