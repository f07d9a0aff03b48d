// Farthest point sampling: npoint sequential rounds per cloud, each a
// running min squared distance and a first-occurrence arg-max.
//
// Replaces the TPU kernel point_cloud_reid_tpu/ops/pallas/fps.py:58
// (fps_pallas, _fps_kernel). Per cloud b, from far = start[b]:
//
//   for i < npoint: out[b, i] = far
//                   dist[n] = min(dist[n], |xyz[n] - xyz[far]|^2)   (1e10 at first)
//                   far = the first n with the largest dist[n]
//
// The TPU kernel keeps the (1, N) distance row in VMEM scratch and gathers
// the centroid and writes the output with vector selects, because Mosaic has
// neither a dynamic lane store nor a dynamic slice.
//
// What bounds it on the H100: never bytes (a (128, 128, 3) call reads 197
// KB). The npoint rounds are a dependent chain. At the SA shapes (a warp a
// cloud, one to four warps a SM) a round's latency bounds it: 0.14-0.17 us
// in tier W (measured; the first kernel's two shuffle butterflies and
// barrier took 0.44-0.61). With many points a round, the instructions it
// issues, about 13 a point (tier BLOCK, 512 clouds of 2048 points: 0.80 us
// a round); at 20,000 points (tier L2, one SM a cloud) the coordinates'
// reads through L1 and L2, 4.1 us a round.
//
// The round. Every distance is finite and >= +0 (a sum of rounded squares;
// -0 cannot arise), so its float bits read as a uint32 order as the float
// does. A thread first reduces its own points in ascending index, keeping
// the first of equal maxima; a warp then takes two redux.sync: the largest
// key, and the least index among the lanes holding it. A slot without a
// point keeps distance +0 and an index >= N, so it loses to every point,
// also to a live point at distance +0 (npoint above the number of distinct
// points, as in clouds resampled with replacement).
//
// Tiers (kernels/fps.py `plan` picks one from N and passes it here):
//   WARP    a warp a cloud, several clouds a block, no block barrier: point
//           n in lane n % 32, slot n / 32, with its x, y, z and running
//           distance in registers. The lane's pre-reduce carries the best
//           point's coordinates, and the next centroid comes from the
//           winning lane by three shuffles. N <= 32 P, P = 1 to 32
//           (plan's default stops at N = 512, where tier BLOCK catches up).
//   BLOCK   a block a cloud, P = 8 points a thread strided over the block,
//           in registers; the cloud staged once in shared memory for the
//           centroid read. Warp winners go to a double-buffered slot, one
//           __syncthreads, then every warp reduces the slots with the same
//           two redux.sync, so every thread has the next centroid without a
//           second barrier. N <= 8 * 1024.
//   L2      the same round with any number of points a thread: the
//   SCRATCH coordinates read each round from the input, which L1 and L2
//           serve, the running distances in shared memory (L2, N <=
//           57,984) or in a (B, N) scratch the wrapper allocates (SCRATCH).
//           No upper limit on N. (Coordinates kept in shared memory as well
//           timed no faster at 12,000 points.)
//
// Any other channel count C (fps_pallas takes (B, N, C); entry point
// pcr_fps_channels): the distance is the sum over the C channels of the
// squared differences, left to right, and the same rounds, in two kernels
// that read the coordinates by channel loop; C = 3 keeps the kernels above:
//   WARP    (fps_warp_c) a warp a cloud, `clouds` clouds a block, each
//           cloud's N x C coordinates staged in shared memory (4 N C bytes
//           a cloud), P distances a lane in registers; N <= 32 P.
//   BLOCK   (fps_stream_c) a block a cloud, the coordinates staged in
//   L2      shared memory (BLOCK) or read from the input (L2, SCRATCH), the
//   SCRATCH running distances in shared memory (BLOCK, L2) or in the
//           scratch (SCRATCH).
//
// Rounding: the squared distance is dx*dx + dy*dy + dz*dz, left to right,
// written with the round-to-nearest intrinsics so that nothing is
// contracted into an FMA; the plain PyTorch version writes out the same
// order, so the indices are equal, not merely close. The start indices are
// read as int32 or int64 as given, and the kernel writes int64, so a call is
// one launch.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;   // an index that never wins
constexpr float FAR = 1e10f;             // every distance before round 1
constexpr int BLOCK_P = 8;               // points a thread in tier BLOCK
constexpr int SLOTS = 2 * 32;            // warp winners, two buffers
constexpr int SLOT_BYTES = SLOTS * 2 * (int)sizeof(unsigned);
constexpr int MAX_SMEM = 232448;         // 227 KB, a block's most on sm_90

enum Tier { WARP = 0, BLOCK = 1, L2 = 2, SCRATCH = 3 };

__device__ __forceinline__ float sqdist(float x, float y, float z, float cx,
                                        float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy),
              dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// the warp's best (key, index): the largest key, then the least index
// holding it; the key comes back in `key`
__device__ __forceinline__ unsigned warp_best(unsigned& key, unsigned idx) {
  const unsigned m = __reduce_max_sync(FULL, key);
  const unsigned w = __reduce_min_sync(FULL, key == m ? idx : NONE);
  key = m;
  return w;
}

__device__ __forceinline__ int first_index(const void* start, int start64,
                                           int b, int N) {
  const long long s = start64 ? static_cast<const long long*>(start)[b]
                              : static_cast<const int*>(start)[b];
  return s < 0 ? 0 : s >= N ? N - 1 : (int)s;   // bounds the reads only
}

// Tier WARP: one warp a cloud, P points a lane (point n = lane + 32 s)
template <int P>
__global__ void __launch_bounds__(128)
fps_warp(const float* __restrict__ xyz, const void* __restrict__ start,
         int start64, long long* __restrict__ out, int B, int N,
         int npoint) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;                      // the whole warp leaves
  const float* cloud = xyz + (size_t)b * N * 3;
  float x[P], y[P], z[P], d[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int n = lane + 32 * s;
    const bool live = n < N;
    x[s] = live ? cloud[3 * n] : 0.f;
    y[s] = live ? cloud[3 * n + 1] : 0.f;
    z[s] = live ? cloud[3 * n + 2] : 0.f;
    d[s] = live ? FAR : 0.f;               // a slot without a point: +0
  }
  unsigned far = first_index(start, start64, b, N);
  float cx = cloud[3 * far], cy = cloud[3 * far + 1], cz = cloud[3 * far + 2];
  long long* o = out + (size_t)b * npoint;
  for (int i = 0;; ++i) {
    if (lane == 0) o[i] = far;
    if (i == npoint - 1) break;
#pragma unroll
    for (int s = 0; s < P; ++s)
      d[s] = fminf(d[s], sqdist(x[s], y[s], z[s], cx, cy, cz));
    // the lane's best slot and its coordinates, as a tree over adjacent
    // slots that keeps the lower one on a tie: the first occurrence
    constexpr int H = P > 1 ? P / 2 : 1;
    float bd[H], bx[H], by[H], bz[H];
    unsigned bs[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int s = P > 1 ? 2 * h : 0, t = P > 1 ? s + 1 : 0;
      const bool r = d[t] > d[s];
      bd[h] = r ? d[t] : d[s];
      bx[h] = r ? x[t] : x[s];
      by[h] = r ? y[t] : y[s];
      bz[h] = r ? z[t] : z[s];
      bs[h] = r ? t : s;
    }
#pragma unroll
    for (int w = 1; w < H; w *= 2) {
#pragma unroll
      for (int h = 0; h + w < H; h += 2 * w) {
        const bool r = bd[h + w] > bd[h];
        bd[h] = r ? bd[h + w] : bd[h];
        bx[h] = r ? bx[h + w] : bx[h];
        by[h] = r ? by[h + w] : by[h];
        bz[h] = r ? bz[h + w] : bz[h];
        bs[h] = r ? bs[h + w] : bs[h];
      }
    }
    unsigned key = __float_as_uint(bd[0]);
    far = warp_best(key, lane + 32 * bs[0]);
    const int src = far & 31;
    cx = __shfl_sync(FULL, bx[0], src);
    cy = __shfl_sync(FULL, by[0], src);
    cz = __shfl_sync(FULL, bz[0], src);
  }
}

// The block's winner from every warp's (key, index): warp winners into
// slots[buf], one barrier, then every warp reduces the slots itself.
__device__ __forceinline__ unsigned block_best(unsigned key, unsigned idx,
                                               unsigned* slots, int buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  idx = warp_best(key, idx);
  unsigned* sk = slots + buf * 32;
  unsigned* si = slots + SLOTS + buf * 32;
  if (lane == 0) { sk[warp] = key; si[warp] = idx; }
  __syncthreads();
  key = lane < nwarps ? sk[lane] : 0u;
  idx = lane < nwarps ? si[lane] : NONE;
  return warp_best(key, idx);
}

// Tier BLOCK: one block a cloud, BLOCK_P points a thread in registers
// (point n = tid + blockDim.x * s), the cloud staged in shared memory
__global__ void __launch_bounds__(1024)
fps_block(const float* __restrict__ xyz, const void* __restrict__ start,
          int start64, long long* __restrict__ out, int N, int npoint) {
  extern __shared__ unsigned smem[];
  unsigned* slots = smem;                                  // [2][2][32]
  float* pts = reinterpret_cast<float*>(smem + 2 * SLOTS);  // [N][3]
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const float* cloud = xyz + (size_t)b * N * 3;
  for (int e = tid; e < 3 * N; e += T) pts[e] = cloud[e];
  __syncthreads();
  float x[BLOCK_P], y[BLOCK_P], z[BLOCK_P], d[BLOCK_P];
#pragma unroll
  for (int s = 0; s < BLOCK_P; ++s) {
    const int n = tid + T * s;
    const bool live = n < N;
    x[s] = live ? pts[3 * n] : 0.f;
    y[s] = live ? pts[3 * n + 1] : 0.f;
    z[s] = live ? pts[3 * n + 2] : 0.f;
    d[s] = live ? FAR : 0.f;
  }
  unsigned far = first_index(start, start64, b, N);
  long long* o = out + (size_t)b * npoint;
  for (int i = 0;; ++i) {
    if (tid == 0) o[i] = far;
    if (i == npoint - 1) break;
    const float cx = pts[3 * far], cy = pts[3 * far + 1],
                cz = pts[3 * far + 2];
    float best = -1.f;
    unsigned bi = NONE;
#pragma unroll
    for (int s = 0; s < BLOCK_P; ++s) {    // ascending n: strict > keeps
      d[s] = fminf(d[s], sqdist(x[s], y[s], z[s], cx, cy, cz));  // the first
      const bool r = d[s] > best;
      best = r ? d[s] : best;
      bi = r ? (unsigned)(tid + T * s) : bi;
    }
    far = block_best(__float_as_uint(best), bi, slots, i & 1);
  }
}

// Tiers L2 and SCRATCH: one block a cloud, any number of points a thread,
// the coordinates read each round from the input and the running distances
// read and written in shared memory (L2) or in the scratch (SCRATCH)
__global__ void __launch_bounds__(1024)
fps_stream(const float* __restrict__ xyz, const void* __restrict__ start,
           int start64, long long* __restrict__ out,
           float* __restrict__ scratch, int N, int npoint, int tier) {
  extern __shared__ unsigned smem[];
  unsigned* slots = smem;
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const float* cloud = xyz + (size_t)b * N * 3;
  float* D = tier == SCRATCH ? scratch + (size_t)b * N
                             : reinterpret_cast<float*>(smem + 2 * SLOTS);
  for (int n = tid; n < N; n += T) D[n] = FAR;
  __syncthreads();
  unsigned far = first_index(start, start64, b, N);
  long long* o = out + (size_t)b * npoint;
  for (int i = 0;; ++i) {
    if (tid == 0) o[i] = far;
    if (i == npoint - 1) break;
    const float cx = cloud[3 * far], cy = cloud[3 * far + 1],
                cz = cloud[3 * far + 2];
    float best = -1.f;
    unsigned bi = NONE;
    for (int n = tid; n < N; n += T) {
      const float dn = fminf(D[n], sqdist(cloud[3 * n], cloud[3 * n + 1],
                                          cloud[3 * n + 2], cx, cy, cz));
      D[n] = dn;
      const bool r = dn > best;
      best = r ? dn : best;
      bi = r ? (unsigned)n : bi;
    }
    // a thread without a point gives key 0 and index NONE
    far = block_best(bi == NONE ? 0u : __float_as_uint(best), bi, slots,
                     i & 1);
  }
}

// ---- any channel count C ----------------------------------------------

// sum over c < C of (p[c] - q[c])^2, left to right, round to nearest
__device__ __forceinline__ float sqdist_c(const float* p, const float* q,
                                          int C) {
  float d = 0.f;                           // +0 + x = x for every x >= +0
  for (int c = 0; c < C; ++c) {
    const float e = __fsub_rn(p[c], q[c]);
    d = __fadd_rn(d, __fmul_rn(e, e));
  }
  return d;
}

// Tier WARP at C channels: one warp a cloud, its points staged in shared
// memory, P distances a lane (point n = lane + 32 s)
template <int P>
__global__ void __launch_bounds__(128)
fps_warp_c(const float* __restrict__ xyz, const void* __restrict__ start,
           int start64, long long* __restrict__ out, int B, int N, int C,
           int npoint) {
  extern __shared__ float staged[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;                      // the whole warp leaves
  const float* cloud = xyz + (size_t)b * N * C;
  float* pts = staged + (size_t)w * N * C;
  for (int e = lane; e < N * C; e += 32) pts[e] = cloud[e];
  __syncwarp();
  float d[P];
#pragma unroll
  for (int s = 0; s < P; ++s) d[s] = lane + 32 * s < N ? FAR : 0.f;
  unsigned far = first_index(start, start64, b, N);
  long long* o = out + (size_t)b * npoint;
  for (int i = 0;; ++i) {
    if (lane == 0) o[i] = far;
    if (i == npoint - 1) break;
    const float* cen = pts + (size_t)far * C;
    float best = -1.f;
    unsigned bi = NONE;
#pragma unroll
    for (int s = 0; s < P; ++s) {          // ascending n: strict > keeps
      const int n = lane + 32 * s;         // the first
      if (n < N) d[s] = fminf(d[s], sqdist_c(pts + (size_t)n * C, cen, C));
      const bool r = d[s] > best;
      best = r ? d[s] : best;
      bi = r ? (unsigned)n : bi;
    }
    unsigned key = __float_as_uint(best);
    far = warp_best(key, bi);
  }
}

// Tiers BLOCK, L2 and SCRATCH at C channels: one block a cloud, the
// coordinates staged in shared memory after the distances (BLOCK) or read
// each round from the input (L2, SCRATCH), the running distances in shared
// memory (BLOCK, L2) or in the scratch (SCRATCH)
__global__ void __launch_bounds__(1024)
fps_stream_c(const float* __restrict__ xyz, const void* __restrict__ start,
             int start64, long long* __restrict__ out,
             float* __restrict__ scratch, int N, int C, int npoint,
             int tier) {
  extern __shared__ unsigned smem[];
  unsigned* slots = smem;
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const float* cloud = xyz + (size_t)b * N * C;
  float* D = tier == SCRATCH ? scratch + (size_t)b * N
                             : reinterpret_cast<float*>(smem + 2 * SLOTS);
  const float* pts = cloud;
  if (tier == BLOCK) {
    float* st = reinterpret_cast<float*>(smem + 2 * SLOTS) + N;
    for (int e = tid; e < N * C; e += T) st[e] = cloud[e];
    pts = st;
  }
  for (int n = tid; n < N; n += T) D[n] = FAR;
  __syncthreads();
  unsigned far = first_index(start, start64, b, N);
  long long* o = out + (size_t)b * npoint;
  for (int i = 0;; ++i) {
    if (tid == 0) o[i] = far;
    if (i == npoint - 1) break;
    const float* cen = pts + (size_t)far * C;
    float best = -1.f;
    unsigned bi = NONE;
    for (int n = tid; n < N; n += T) {
      const float dn = fminf(D[n], sqdist_c(pts + (size_t)n * C, cen, C));
      D[n] = dn;
      const bool r = dn > best;
      best = r ? dn : best;
      bi = r ? (unsigned)n : bi;
    }
    far = block_best(bi == NONE ? 0u : __float_as_uint(best), bi, slots,
                     i & 1);
  }
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB it must
// be asked for); remembered per kernel, so asked once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

template <int P>
cudaError_t launch_warp(const float* xyz, const void* start, int start64,
                        long long* out, int B, int N, int npoint, int clouds,
                        cudaStream_t stream) {
  const int grid = (B + clouds - 1) / clouds;
  fps_warp<P><<<grid, 32 * clouds, 0, stream>>>(xyz, start, start64, out, B,
                                                N, npoint);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) float32 contiguous, start (B,) int32 (start64 = 0) or int64
// (start64 = 1) in [0, N), scratch (B, N) float32 for tier SCRATCH (else
// unused) -> out (B, npoint <= N) int64. The launch plan (tier, points a
// lane or thread, threads a block, clouds a block, dynamic shared bytes) is
// kernels/fps.py plan(N)'s; a plan the kernel cannot run is refused.
extern "C" int pcr_fps_plan(const void* xyz, const void* start, void* out,
                            void* scratch, int B, int N, int npoint,
                            int start64, int tier, int points, int threads,
                            int clouds, int smem, void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N || threads <= 0
      || threads > 1024 || threads % 32 || smem < 0 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  long long* o = (long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (tier == WARP) {
    if (threads != 32 * clouds || clouds > 4 || smem != 0
        || (long long)32 * points < N)
      return (int)cudaErrorInvalidValue;
    switch (points) {
      case 1: return (int)launch_warp<1>(x, start, start64, o, B, N, npoint,
                                         clouds, st);
      case 2: return (int)launch_warp<2>(x, start, start64, o, B, N, npoint,
                                         clouds, st);
      case 4: return (int)launch_warp<4>(x, start, start64, o, B, N, npoint,
                                         clouds, st);
      case 8: return (int)launch_warp<8>(x, start, start64, o, B, N, npoint,
                                         clouds, st);
      case 16: return (int)launch_warp<16>(x, start, start64, o, B, N,
                                           npoint, clouds, st);
      case 32: return (int)launch_warp<32>(x, start, start64, o, B, N,
                                           npoint, clouds, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (clouds != 1) return (int)cudaErrorInvalidValue;
  if (tier == BLOCK) {
    static int granted = 48 * 1024;
    if (points != BLOCK_P || (long long)threads * BLOCK_P < N
        || smem < SLOT_BYTES + 12 * N)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(fps_block, smem, granted);
    if (err != cudaSuccess) return (int)err;
    fps_block<<<B, threads, smem, st>>>(x, start, start64, o, N, npoint);
    return (int)cudaGetLastError();
  }
  const long long need = tier == L2 ? SLOT_BYTES + 4LL * N : SLOT_BYTES;
  if ((tier != L2 && tier != SCRATCH) || smem < need
      || (tier == SCRATCH && scratch == nullptr)
      || (long long)threads * points < N)
    return (int)cudaErrorInvalidValue;
  static int granted = 48 * 1024;
  const cudaError_t err = allow_smem(fps_stream, smem, granted);
  if (err != cudaSuccess) return (int)err;
  fps_stream<<<B, threads, smem, st>>>(x, start, start64, o, (float*)scratch,
                                       N, npoint, tier);
  return (int)cudaGetLastError();
}

// The same for xyz (B, N, C) float32 contiguous at any C >= 1 (C = 3 too,
// though the wrapper sends it to pcr_fps_plan), with kernels/fps.py
// plan(N, C)'s launch: tier WARP stages `clouds` clouds of 4 N C bytes,
// BLOCK 2 KB of winners (SLOT_BYTES), N distances and the N C coordinates,
// L2 the winners and the distances, SCRATCH the winners.
extern "C" int pcr_fps_channels(const void* xyz, const void* start, void* out,
                                void* scratch, int B, int N, int C,
                                int npoint, int start64, int tier,
                                int points, int threads, int clouds,
                                int smem, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || npoint <= 0 || npoint > N
      || threads <= 0 || threads > 1024 || threads % 32 || smem < 0
      || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  long long* o = (long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const long long cloud_bytes = 4LL * N * C;
  if (tier == WARP) {
    if (threads != 32 * clouds || clouds < 1 || clouds > 4
        || smem < clouds * cloud_bytes || (long long)32 * points < N)
      return (int)cudaErrorInvalidValue;
    const int grid = (B + clouds - 1) / clouds;
#define PCR_FPS_WARP_C(PP)                                                   \
  case PP: {                                                                 \
    static int granted = 48 * 1024;                                          \
    const cudaError_t err = allow_smem(fps_warp_c<PP>, smem, granted);       \
    if (err != cudaSuccess) return (int)err;                                 \
    fps_warp_c<PP><<<grid, threads, smem, st>>>(x, start, start64, o, B, N,  \
                                                C, npoint);                  \
    return (int)cudaGetLastError();                                          \
  }
    switch (points) {
      PCR_FPS_WARP_C(1)
      PCR_FPS_WARP_C(2)
      PCR_FPS_WARP_C(4)
      PCR_FPS_WARP_C(8)
      PCR_FPS_WARP_C(16)
      default: return (int)cudaErrorInvalidValue;
    }
#undef PCR_FPS_WARP_C
  }
  const long long need = tier == BLOCK ? SLOT_BYTES + 4LL * N + cloud_bytes
                         : tier == L2  ? SLOT_BYTES + 4LL * N
                                       : SLOT_BYTES;
  if ((tier != BLOCK && tier != L2 && tier != SCRATCH) || clouds != 1
      || smem < need || (tier == SCRATCH && scratch == nullptr)
      || (long long)threads * points < N)
    return (int)cudaErrorInvalidValue;
  static int granted = 48 * 1024;
  const cudaError_t err = allow_smem(fps_stream_c, smem, granted);
  if (err != cudaSuccess) return (int)err;
  fps_stream_c<<<B, threads, smem, st>>>(x, start, start64, o,
                                         (float*)scratch, N, C, npoint, tier);
  return (int)cudaGetLastError();
}
