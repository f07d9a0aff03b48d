// Fused per-pair match chain of the flagship ReID head, grid or pair list,
// on Hopper's tensor cores with float32 accuracy (3xTF32).
//
// Replaces the TPU kernels point_cloud_reid_tpu/ops/pallas/match_grid.py
// fused_match_grid (pair_mode=False), fused_match_pairs (pair_mode=True) and
// the image head's pallas_image_grid_logits / pallas_image_pair_logits (the
// same _kernel with with_pos=False, n_true=S), all built on its _kernel:
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
// grid mode: cluster p scores track p / nd x det p % nd, out (nt, nd, 2C);
// pair mode: cluster p scores t_idx[p] x d_idx[p], out (P, 2C), reading the
// per-object factors directly. Both modes run the same per-pair code, so a
// pair's result is the same bit for bit in either. The point head (POS) adds
// the position term pv to the stage-2 values; the image head has none and
// runs over the true token count S (the TPU kernel's 8-row token padding and
// its mask are Mosaic workarounds and are dropped). The 1/N value pre-scale
// and the xN rescale cancel and are both dropped.
//
// Design. A pair is a cluster of two blocks (__cluster_dims__(2,1,1)):
// block 0 owns the track side, block 1 the det side.
//  1. Stage 1: each block computes its own side's output O (N x C) into its
//     own shared memory: block 0 track->det (O1), block 1 det->track (O2),
//     reading the other object's kvz from device memory. The two directions
//     run at once on two SMs.
//  2. Each block summarises its own O as the template of the OTHER block's
//     stage-2 direction: k = elu1(O Wk), v = O Wv + pv (own side), [KV | Z]
//     with KV = k^T v and Z = sum k, masked per head, and writes it into the
//     peer's shared memory (distributed shared memory); a cluster barrier.
//  3. Each block runs its own stage-2 search chain over its N rows and pools
//     them; block 1 sends its C maxima and C sums to block 0, which writes
//     the 2C outputs.
// Neither block holds both O1 and O2, so S=197/198 image tokens fit the
// same layout as the point head's N=128: one tiling, POS the only switch
// besides the channel count C (64, the released heads' width, and 16, the
// tiny test models': the register tiles are sized at compile time).
// Any other width up to 64 runs at the next of the two in the padded layout
// (kernels/match_grid.pad_side: the true ct channels first, zeros in every
// factor, weight and LayerNorm lane past them): the PAD instantiations,
// compiled in csrc/match_grid_pad.cu, take ct and mask what zeros alone get
// wrong, elu+1 of a padded stage-2 q or k lane (1, not 0: it would add to
// q . sum k and to k^T v) and the LayerNorm statistics (over ct). The heads
// keep ct / H channels each, so the head masks read D = ct / H; a padded
// lane's message is 0 / (0 + eps) = 0.
//
// Products: mma.sync m16n8k8 TF32 with f32 accumulation, three passes per
// product (a = hi + lo with hi = a truncated to TF32's 10 mantissa bits and
// lo = a - hi, read as TF32 by the tensor core: hi*hi + hi*lo + lo*hi),
// which keeps the float32 chain within ~1e-6 relative of the plain version
// (one pass would keep three digits, which the two LayerNorm stacks turn
// into ~3e-4 errors: tests/test_torch_match_tf32.py shows both on the
// CPU). hi is truncated, not rounded: the split runs on both operands of
// every mma and is, with the mma, what the kernel spends its issue slots
// on; truncating takes one integer op, rounding two (cvt.rna.tf32.f32 was
// slower still), and the error against the plain version stays where it
// was (PERF.md). Every product of the chain goes through it: the stage-1
// message q @ [KV | Z], merge, fc1, fc2, the stage-2 q / kv projections,
// the template summary k^T v and the stage-2 message. LayerNorm, elu+1,
// split-norm, ReLU and pooling stay float32 on the CUDA cores.
// Each warp owns 16-row slabs of the block's rows and carries a slab through
// the whole row-local chain in registers: in the m16n8k8 accumulator a row's
// columns lie in one quad of four lanes, so LayerNorm is a two-step quad
// shuffle, and split-norm pairs column c with C + c, held by the same
// thread. One product's accumulator becomes the next product's A fragment
// by eight quad shuffles per 8-column step, not through shared memory (a
// per-warp 16 x 2C strip would cost 8.4 KB a warp, which the S=198 layout
// cannot spare). Matching the mma's k slots to the accumulator's column
// pairs instead (no shuffles, two-column A loads) was measured 3 % slower:
// ptxas then took 255 registers and spilled. Weights are read as B
// fragments from shared memory and split in registers, so their low halves
// cost no shared memory.
// Weights are staged with cp.async into shared memory in three groups
// (stage 1 + Wq; the kv projection; the stage-2 tail), each staged once per
// block and used by every row before it is replaced; the stage-2 group is
// issued before the cluster barrier and lands while the block waits there.
// B-operand matrices are stored unpadded with an XOR swizzle of 8-column
// groups so that a B fragment load is free of bank conflicts; the row-major
// activations (O) are padded to C + 4 floats.
// The only block barriers are the ones the data needs: weights have landed,
// O is complete, the summary chunk is complete, the pooling is final.
//
// Layout, floats per block, C=64 (bytes in brackets), Np = N rounded up to 16:
//   weights          8 C^2           32768 (128 KB): stage 1 kvz 2C^2 +
//                    merge C^2 + fc1[C:] 2C^2 + fc2 2C^2 + Wq C^2; then the
//                    kv projection 2C^2 beside a 128-row k|v chunk
//                    (128 x (2C + 8)); then stage 2's Wq, merge C^2, fc1 4C^2,
//                    fc2 2C^2
//   own O            Np (C + 4)      8704 at N=128 (34.0 KB), 14144 at S=198
//                                    (55.3 KB)
//   peer's [KV | Z]  2 C^2           8192 (32 KB)
//   pooling          8 warps x 2C + C + 2C   1216 (4.75 KB)
// 203,520 bytes at N=128 and 225,280 at S=197/198, of the 232,448 a block may
// take: one block per SM, 8 warps. N up to 224 fits at C=64.
//
// What bounds it on the H100: about 80 N C^2 flops a pair (42 MFLOP at
// N=128, C=64), three TF32 passes each, so 126 MFLOP of tensor-core work a
// pair against 495 TFLOP/s (4.2 ms for a 128 x 128 grid); the kernel takes
// 4.4x that. Each B element a warp reads is split again by every warp that
// reads it (two integer/float ops beside its load, for three mma), and
// the measured gains all came from cutting those ops (cvt.rna -> integer
// rounding -18 %, rounding -> truncation -12 %), while halving the loads
// (paired rows, one 8-byte load) or reordering the mma did nothing: the
// kernel is bound by issuing the split and the mma on 8 warps a SM, not by
// the tensor cores or memory. wgmma would lift that, but its B operand must
// sit in shared memory as separate hi and lo matrices, which doubles the
// weight budget that this layout already takes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 128;                  // rows of the k|v summary chunk
constexpr size_t SMEM_LIMIT = 232448;       // dynamic shared memory a block may take
constexpr float EPS = 1e-6f;
constexpr float LN_EPS = 1e-5f;

struct Side {         // per-object factors of one side, image head
  const float* h;     // (n, N, C)
  const float* q;     // (n, N, C)   elu+1 stage-1 queries
  const float* kvz;   // (n, C, 2C)  [KV | diag(ksum) @ head mask]
  const float* a1;    // (n, N, 2C)  h @ stage1.fc1[:C]
  const float* pv;    // (n, N, C)   stage-2 pos-MLP @ v_proj (point head), or null
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

// Shared-memory layout of the kernel for channel count C and N rows, in
// floats. The k|v chunk sits inside the weight region (between Wq and the
// kv projection) where it fits, else after it.
template <int C> struct Layout {
  static constexpr int C2 = C * C;
  static constexpr int LDO = C + 4;                    // padded row of O
  static constexpr int LDKV = 2 * C + 8;               // padded row of the k|v chunk
  static constexpr int CHUNK_FLOATS = CHUNK * LDKV;
  static constexpr bool CHUNK_INSIDE = C2 + CHUNK_FLOATS <= 6 * C2;
  static constexpr int CHUNK_AT = CHUNK_INSIDE ? C2 : 8 * C2;
  static constexpr int WFLOATS = CHUNK_INSIDE ? 8 * C2 : 8 * C2 + CHUNK_FLOATS;
  // offsets in the weight region
  static constexpr int Q2 = 0, KVZ1 = C2, MERGE1 = 3 * C2, FC1B1 = 4 * C2,
                       FC2_1 = 6 * C2;                 // stage 1 (+ Wq)
  static constexpr int KV2 = 6 * C2;                   // summary
  static constexpr int MERGE2 = C2, FC1_2 = 2 * C2, FC2_2 = 6 * C2;  // stage 2
  static size_t floats(int N) {
    const int Np = (N + 15) / 16 * 16;
    return (size_t)WFLOATS + (size_t)Np * LDO + 2 * C2 + WARPS * 2 * C + C + 2 * C;
  }
};

__device__ __forceinline__ float elu1(float x) { return x > 0.f ? x + 1.f : expf(x); }

// ---- 3xTF32 tensor-core products ------------------------------------------------

// hi = x truncated to TF32, lo = x - hi (exact); the mma reads lo truncated.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three passes, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4], float b0,
                                     float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The same with the A fragment already split (reused across n-tiles).
struct AFrag { uint32_t hi[4], lo[4]; };

__device__ __forceinline__ AFrag split_a(const float (&a)[4]) {
  AFrag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], f.hi[i], f.lo[i]);
  return f;
}

__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

// A B-operand matrix of COLS columns lives unpadded in shared memory with its
// 8-column groups XOR-swizzled by row, so that the 32 lanes of a B fragment
// load (rows k0 + t, columns 8j + g) hit 32 banks. Groups of 4 columns stay
// contiguous (16-byte copies).
template <int COLS>
__device__ __forceinline__ int swz(int k, int n) {
  static_assert(COLS % 16 == 0, "B matrices have a multiple of 16 columns");
  if constexpr (COLS % 32 == 0) return k * COLS + (n ^ ((k & 3) << 3));
  else return k * COLS + (n ^ (((k >> 1) & 1) << 3));
}

// acc[j] += A (16 x 8NK) @ B (8NK x 8NN) for one warp, B swizzled in shared
// memory with COLS columns from row `krow`. getA(kk, a) fills the A fragment
// of k-step kk: a[0] (row g, col t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4), where g = lane / 4, t = lane % 4 (PTX m16n8k8 .tf32).
template <int NK, int NN, int COLS, class GetA>
__device__ __forceinline__ void warp_gemm(float (&acc)[NN][4], GetA getA,
                                          const float* B, int krow, int ncol0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    float a[4];
    getA(kk, a);
    const AFrag f = split_a(a);
    const int k0 = krow + kk * 8 + t;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const int n = ncol0 + j * 8 + g;
      mma3(acc[j], f, B[swz<COLS>(k0, n)], B[swz<COLS>(k0 + 4, n)]);
    }
  }
}

template <int NN>
__device__ __forceinline__ void zero(float (&acc)[NN][4]) {
#pragma unroll
  for (int j = 0; j < NN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// The A fragment of k-step kk from a warp's accumulator `acc` (16 rows x
// 8NN columns, C-fragment layout: lane (g, t) holds columns 2t, 2t+1 of rows
// g and g + 8 of each 8-column tile): column t of the tile is held by lane
// (g, t / 2), column t + 4 by lane (g, 2 + t / 2).
template <int NN>
__device__ __forceinline__ void a_from_acc(const float (&acc)[NN][4], int kk, float (&a)[4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int s0 = (lane & ~3) | (t >> 1), s1 = s0 + 2;
  const bool odd = t & 1;
  float x0 = __shfl_sync(0xffffffffu, acc[kk][0], s0);
  float x1 = __shfl_sync(0xffffffffu, acc[kk][1], s0);
  float y0 = __shfl_sync(0xffffffffu, acc[kk][2], s0);
  float y1 = __shfl_sync(0xffffffffu, acc[kk][3], s0);
  a[0] = odd ? x1 : x0;
  a[1] = odd ? y1 : y0;
  x0 = __shfl_sync(0xffffffffu, acc[kk][0], s1);
  x1 = __shfl_sync(0xffffffffu, acc[kk][1], s1);
  y0 = __shfl_sync(0xffffffffu, acc[kk][2], s1);
  y1 = __shfl_sync(0xffffffffu, acc[kk][3], s1);
  a[2] = odd ? x1 : x0;
  a[3] = odd ? y1 : y0;
}

// LayerNorm of the 16 rows of a C-wide accumulator, in registers: a row's
// columns lie in one quad, so two xor-shuffles finish each sum. PAD (the
// padded layout): the statistics over the true ct columns; the padded
// columns hold zeros, so the sum needs no mask, the deviations do.
template <bool PAD, int NT>
__device__ __forceinline__ void layer_norm_acc(float (&acc)[NT][4],
                                               const float* __restrict__ s,
                                               const float* __restrict__ b, int ct) {
  const float invC = PAD ? 1.f / ct : 1.f / (8 * NT);
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

// ---- staging ------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy `rows` x COLS floats (row-major, leading dimension ld in device
// memory) into the swizzled B layout at dst, 16 bytes a copy, whole block.
template <int COLS>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int rows,
                                      int ld) {
  for (int e = 4 * threadIdx.x; e < rows * COLS; e += 4 * THREADS) {
    const int k = e / COLS, n = e - k * COLS;
    cp_async16(dst + swz<COLS>(k, n), src + (size_t)k * ld + n);
  }
}

// ---- one warp's 16-row slab -------------------------------------------------------

// y = LN2(relu(hid + LN1(msg @ merge) @ fc1[krow:krow+C]) @ fc2) for a slab,
// where hid arrives holding the search half of the FFN's first layer (a1 or
// search @ fc1[:C]). merge, fc1 and fc2 are swizzled in shared memory.
template <int C, bool PAD>
__device__ __forceinline__ void ffn_tail(const float (&msg)[C / 8][4],
                                         float (&hid)[C / 4][4], const Tail& w,
                                         const float* merge, const float* fc1, int krow,
                                         const float* fc2, float (&y)[C / 8][4], int ct) {
  constexpr int NT = C / 8;
  float m[NT][4];
  zero(m);
  warp_gemm<NT, NT, C>(m, [&](int kk, float (&a)[4]) { a_from_acc(msg, kk, a); },
                       merge, 0, 0);
  layer_norm_acc<PAD>(m, w.ln1s, w.ln1b, ct);
  warp_gemm<NT, 2 * NT, 2 * C>(hid, [&](int kk, float (&a)[4]) { a_from_acc(m, kk, a); },
                               fc1, krow, 0);
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) hid[j][i] = fmaxf(hid[j][i], 0.f);
  zero(y);
  warp_gemm<2 * NT, NT, C>(y, [&](int kk, float (&a)[4]) { a_from_acc(hid, kk, a); },
                           fc2, 0, 0);
  layer_norm_acc<PAD>(y, w.ln2s, w.ln2b, ct);
}

// msg[j] = mz[j] / (mz[NT + j] + eps): column c and C + c sit in the same
// thread at the same fragment position.
template <int NT>
__device__ __forceinline__ void split_norm(const float (&mz)[2 * NT][4], float (&msg)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) msg[j][i] = mz[j][i] / (mz[NT + j][i] + EPS);
}

// A fragment from row-major rows in shared memory (leading dimension ld),
// rows r0 = slab row g, r0 + 8.
struct RowsA {
  const float* p; int ld;
  __device__ __forceinline__ void operator()(int kk, float (&a)[4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* r = p + g * ld + kk * 8 + t;
    a[0] = r[0]; a[1] = r[8 * ld]; a[2] = r[4]; a[3] = r[8 * ld + 4];
  }
};

// ---- the kernel ---------------------------------------------------------------------

// PAD: the padded layout (kernels/match_grid.pad_side): the true channels
// are the first ct of C, in H heads of ct / H; the wrapper zeroes every
// factor, weight and LayerNorm lane past ct, and the kernel masks what zeros
// alone get wrong: elu+1 of a padded stage-2 q or k lane and the LayerNorm
// statistics. Without PAD, ct is C.
template <int C, bool POS, bool PAD>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
match_pooled_kernel(Side T, Side Dt, Weights w, const int* __restrict__ t_idx,
                    const int* __restrict__ d_idx, float* __restrict__ out,
                    int nt, int nd, int N, int H, int ct) {
  using L = Layout<C>;
  constexpr int NT = C / 8;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int Np = (N + 15) / 16 * 16;
  const int slabs = Np / 16;
  const int D = (PAD ? ct : C) / H;

  float* Wr = smem;                            // weight region
  float* O = smem + L::WFLOATS;                // [Np][C + 4] own stage-1 output
  float* KVZp = O + Np * L::LDO;               // [C][2C] swizzled, written by the peer
  float* part = KVZp + 2 * L::C2;              // [WARPS][2C] pooling partials
  float* ks = part + WARPS * 2 * C;            // [C] sum of k
  float* pool = ks + C;                        // [2C] the peer's pooled max | sum
  float* chunk = Wr + L::CHUNK_AT;             // [CHUNK][2C + 8] k | v rows

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
  const float* hX = X.h + xi * nc;
  const float* qX = X.q + xi * nc;
  const float* aX = X.a1 + xi * 2 * nc;
  const float* kvzY = (rank == 0 ? Dt.kvz : T.kvz) + (size_t)yi * 2 * L::C2;

  // stage 1's weights and Wq
  stage<C>(Wr + L::Q2, w.q2, C, C);
  stage<2 * C>(Wr + L::KVZ1, kvzY, C, 2 * C);
  stage<C>(Wr + L::MERGE1, w.s1.merge, C, C);
  stage<2 * C>(Wr + L::FC1B1, w.s1.fc1 + (size_t)C * 2 * C, C, 2 * C);
  stage<C>(Wr + L::FC2_1, w.s1.fc2, 2 * C, C);
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
    warp_gemm<NT, 2 * NT, 2 * C>(mz, [&](int kk, float (&a)[4]) {
      const int c = kk * 8 + t;
      a[0] = v0 ? __ldg(qX + (size_t)r0 * C + c) : 0.f;
      a[1] = v1 ? __ldg(qX + (size_t)r1 * C + c) : 0.f;
      a[2] = v0 ? __ldg(qX + (size_t)r0 * C + c + 4) : 0.f;
      a[3] = v1 ? __ldg(qX + (size_t)r1 * C + c + 4) : 0.f;
    }, Wr + L::KVZ1, 0, 0);
    float msg[NT][4];
    split_norm<NT>(mz, msg);
    float hid[2 * NT][4];
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 x0 = v0 ? __ldg(reinterpret_cast<const float2*>(aX + (size_t)r0 * 2 * C + c))
                           : make_float2(0.f, 0.f);
      const float2 x1 = v1 ? __ldg(reinterpret_cast<const float2*>(aX + (size_t)r1 * 2 * C + c))
                           : make_float2(0.f, 0.f);
      hid[j][0] = x0.x; hid[j][1] = x0.y; hid[j][2] = x1.x; hid[j][3] = x1.y;
    }
    float y[NT][4];
    ffn_tail<C, PAD>(msg, hid, w.s1, Wr + L::MERGE1, Wr + L::FC1B1, 0, Wr + L::FC2_1, y, ct);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;
      float2 o0 = make_float2(0.f, 0.f), o1 = make_float2(0.f, 0.f);
      if (v0) {
        const float2 h = __ldg(reinterpret_cast<const float2*>(hX + (size_t)r0 * C + c));
        o0 = make_float2(h.x + y[j][0], h.y + y[j][1]);
      }
      if (v1) {
        const float2 h = __ldg(reinterpret_cast<const float2*>(hX + (size_t)r1 * C + c));
        o1 = make_float2(h.x + y[j][2], h.y + y[j][3]);
      }
      *reinterpret_cast<float2*>(O + r0 * L::LDO + c) = o0;
      *reinterpret_cast<float2*>(O + r1 * L::LDO + c) = o1;
    }
  }
  __syncthreads();                             // O complete, stage-1 weights free
  stage<2 * C>(Wr + L::KV2, w.kv2, C, 2 * C);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // ---- the template summary of the peer's direction: k = elu1(O Wk),
  // v = O Wv + pv, KV = k^T v and ksum, in chunks of 128 rows
  constexpr int MT = C / 16;                   // 16-row tiles of KV's C rows
  constexpr int TPW = (MT * NT + WARPS - 1) / WARPS;
  const float* pvX = POS ? X.pv + xi * nc : nullptr;
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
      warp_gemm<NT, 2 * NT, 2 * C>(kvr, RowsA{O + s * 16 * L::LDO, L::LDO}, Wr + L::KV2, 0, 0);
      float* b0 = chunk + (warp * 16 + g) * L::LDKV;
      float* b1 = b0 + 8 * L::LDKV;
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j) {
        const int c = j * 8 + 2 * t;
        float2 e0, e1;
        if (j < NT) {
          e0 = make_float2(elu1(kvr[j][0]), elu1(kvr[j][1]));
          e1 = make_float2(elu1(kvr[j][2]), elu1(kvr[j][3]));
          if (PAD && c >= ct) e0.x = e1.x = 0.f;   // a padded k lane
          if (PAD && c + 1 >= ct) e0.y = e1.y = 0.f;
        } else {
          e0 = make_float2(kvr[j][0], kvr[j][1]);
          e1 = make_float2(kvr[j][2], kvr[j][3]);
          if constexpr (POS) {
            const int cv = c - C;
            if (v0) {
              const float2 q = __ldg(reinterpret_cast<const float2*>(pvX + (size_t)r0 * C + cv));
              e0.x += q.x; e0.y += q.y;
            }
            if (v1) {
              const float2 q = __ldg(reinterpret_cast<const float2*>(pvX + (size_t)r1 * C + cv));
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
        *reinterpret_cast<float2*>(b0 + c) = e0;
        *reinterpret_cast<float2*>(b1 + c) = e1;
      }
    }
    __syncthreads();
    // KV tiles of this warp, interleaved: k^T as A ((m, n) = k[n][m]), v as
    // B ((n, c) = v[n][c])
    const int rows = min(CHUNK, Np - cb);
    for (int k0 = 0; k0 < rows; k0 += 8) {
      const int ra = (k0 + t) * L::LDKV, rb = ra + 4 * L::LDKV;
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int tau = warp + WARPS * i;
        if (tau < MT * NT) {
          const int mi = tau / NT, nj = tau - mi * NT;
          const float* kc = chunk + mi * 16 + g;
          const float* vc = chunk + C + nj * 8 + g;
          const float a[4] = {kc[ra], kc[ra + 8], kc[rb], kc[rb + 8]};
          mma3(kv[i], a, vc[ra], vc[rb]);
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

  // [KV | Z] into the peer's shared memory, masked per head, swizzled as a
  // B operand of 2C columns
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  float* peer = cluster.map_shared_rank(KVZp, rank ^ 1);
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int tau = warp + WARPS * i;
    if (tau < MT * NT) {
      const int mi = tau / NT, nj = tau - mi * NT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cr = mi * 16 + g + 8 * (e >> 1), cc = nj * 8 + 2 * t + (e & 1);
        peer[swz<2 * C>(cr, cc)] = cr / D == cc / D ? kv[i][e] : 0.f;
      }
    }
  }
  if (threadIdx.x < C) {
    float sum = 0.f;
    for (int v = 0; v < WARPS; ++v) sum += part[v * C + threadIdx.x];
    ks[threadIdx.x] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < L::C2; e += THREADS) {
    const int cr = e / C, cc = e - cr * C;
    peer[swz<2 * C>(cr, C + cc)] = cr / D == cc / D ? ks[cr] : 0.f;
  }
  // stage 2's tail weights, over the chunk and the kv projection
  stage<C>(Wr + L::MERGE2, w.s2.merge, C, C);
  stage<2 * C>(Wr + L::FC1_2, w.s2.fc1, 2 * C, 2 * C);
  stage<C>(Wr + L::FC2_2, w.s2.fc2, 2 * C, C);
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
    const RowsA rowsO{O + s * 16 * L::LDO, L::LDO};
    float q[NT][4];
    zero(q);
    warp_gemm<NT, NT, C>(q, rowsO, Wr + L::Q2, 0, 0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[j][i] = PAD && j * 8 + 2 * t + (i & 1) >= ct ? 0.f : elu1(q[j][i]);
    float mz[2 * NT][4];
    zero(mz);
    warp_gemm<NT, 2 * NT, 2 * C>(mz, [&](int kk, float (&a)[4]) { a_from_acc(q, kk, a); },
                                 KVZp, 0, 0);
    float msg[NT][4];
    split_norm<NT>(mz, msg);
    float hid[2 * NT][4];
    zero(hid);
    warp_gemm<NT, 2 * NT, 2 * C>(hid, rowsO, Wr + L::FC1_2, 0, 0);
    float y[NT][4];
    ffn_tail<C, PAD>(msg, hid, w.s2, Wr + L::MERGE2, Wr + L::FC1_2, C, Wr + L::FC2_2, y, ct);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 o0 = *reinterpret_cast<const float2*>(O + r0 * L::LDO + c);
      const float2 o1 = *reinterpret_cast<const float2*>(O + r1 * L::LDO + c);
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
    float* o = out + (size_t)p * 2 * C;
    o[threadIdx.x] = fmaxf(mx, pool[threadIdx.x]);
    o[C + threadIdx.x] = (sm + pool[C + threadIdx.x]) * (1.f / (2.f * N));
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

Side make_side(const void* h, const void* q, const void* kvz, const void* a1,
               const void* pv) {
  return Side{(const float*)h, (const float*)q, (const float*)kvz, (const float*)a1,
              (const float*)pv};
}

// Bytes of shared memory the kernel's layout takes for (N, C), or 0 when
// the kernel has no instantiation for C.
size_t smem_bytes(int N, int C) {
  switch (C) {
    case 16: return Layout<16>::floats(N) * sizeof(float);
    case 64: return Layout<64>::floats(N) * sizeof(float);
    default: return 0;
  }
}

// 0: the kernel takes the shape; 1: no instantiation for C (16, 64) or
// H does not divide C or N < 1; 2: the layout exceeds the shared memory a
// block may take.
int layout_status(int N, int C, int H) {
  if (N < 1 || H < 1 || C % H != 0 || smem_bytes(N, C) == 0) return 1;
  return smem_bytes(N, C) > SMEM_LIMIT ? 2 : 0;
}

template <int C, bool POS, bool PAD>
int launch_c(const Side& T, const Side& Dt, const Weights& w, const int* t_idx,
             const int* d_idx, float* out, int nt, int nd, int P, int N, int H, int ct,
             cudaStream_t stream) {
  const size_t smem = smem_bytes(N, C);
  cudaError_t err = cudaFuncSetAttribute(
      match_pooled_kernel<C, POS, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  match_pooled_kernel<C, POS, PAD><<<2 * P, THREADS, smem, stream>>>(
      T, Dt, w, t_idx, d_idx, out, nt, nd, N, H, ct);
  return (int)cudaGetLastError();
}

// Refuses (cudaErrorInvalidValue) a shape the kernel does not take; the
// wrapper raises. PAD: ct true channels of the C (16 or 64) the layout
// has, in H heads (the layout does not depend on the heads).
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
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 16: return launch_c<16, POS, PAD>(T, Dt, w, ti, di, o, nt, nd, P, N, H, ct, s);
    default: return launch_c<64, POS, PAD>(T, Dt, w, ti, di, o, nt, nd, P, N, H, ct, s);
  }
}

}  // namespace

#ifndef MATCH_GRID_PAD_UNIT

// The layout check the wrappers make before a launch: writes the bytes of
// shared memory the shape needs and the most a block may take, and returns
// layout_status (0: fits, 1: no instantiation for C or a bad H / N, 2: does
// not fit).
extern "C" int pcr_match_pooled_layout(int N, int C, int H, long long* bytes,
                                       long long* limit) {
  *bytes = (long long)smem_bytes(N, C);
  *limit = (long long)SMEM_LIMIT;
  return layout_status(N, C, H);
}

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
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  return launch<true, false>(make_side(ht, qt, kvzt, at, pvt),
                             make_side(hd, qd, kvzd, ad, pvd), ws, t_idx, d_idx, out, nt, nd, P,
                             N, C, H, C, stream);
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
  const void* ws[16] = {merge1, ln1s1, ln1b1, fc1_1, fc2_1, ln2s1, ln2b1, q2, kv2,
                        merge2, ln1s2, ln1b2, fc1_2, fc2_2, ln2s2, ln2b2};
  return launch<false, false>(make_side(ht, qt, kvzt, at, nullptr),
                              make_side(hd, qd, kvzd, ad, nullptr), ws, t_idx, d_idx, out, nt,
                              nd, P, N, C, H, C, stream);
}

#else   // MATCH_GRID_PAD_UNIT: the padded instantiations (csrc/match_grid_pad.cu)

// The padded layout (kernels/match_grid.pad_side) of both heads: the same
// arguments, C the layout's width (16 or 64) and ct the true channels after
// H.
extern "C" int pcr_match_pooled_pad(
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

extern "C" int pcr_match_pooled_image_pad(
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
