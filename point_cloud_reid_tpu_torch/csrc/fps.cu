// Farthest point sampling: npoint sequential rounds per cloud, each a
// running min squared distance and a first-occurrence arg-max.
//
// Replaces the TPU kernel point_cloud_reid_tpu/ops/pallas/fps.py (fps_pallas,
// _fps_kernel). Per cloud b, from far = start[b]:
//
//   for i < npoint: out[b, i] = far
//                   dist[n] = min(dist[n], |xyz[n] - xyz[far]|^2)   (1e10 at first)
//                   far = the first n with the largest dist[n]
//
// The TPU kernel keeps the (1, N) distance row in VMEM scratch and gathers
// the centroid and writes the output with vector selects, because Mosaic has
// neither a dynamic lane store nor a dynamic slice. Here one block owns one
// cloud and one thread one point: its coordinates and its running distance
// stay in registers for all npoint rounds, the cloud is also staged once in
// shared memory so every thread can read the round's centroid (a broadcast
// read), and the output is a plain store. A round is the distance update,
// a 5-step shuffle arg-max per warp on the pair (distance, index) -- larger
// distance first, then smaller index, which is first occurrence -- one
// barrier, and the same reduction over the warps' winners, done by every warp
// so that every thread has the next centroid without a second barrier (the
// winners' slots alternate between two buffers from round to round).
//
// Rounding: the squared distance is dx*dx + dy*dy + dz*dz, left to right,
// written with the round-to-nearest intrinsics so that nothing is
// contracted into an FMA; the plain PyTorch version writes out the same
// order, so the indices are equal, not merely close.
//
// What bounds it on the H100: neither bytes nor arithmetic. A (128, 128, 3)
// call reads 197 KB and writes 64 KB; its time is npoint rounds of shuffle
// and barrier latency, a fixed cost per round whatever N <= 1024. One block
// a cloud fills the card from B = 132 clouds on. N <= 1024 (one point a
// thread); a larger cloud is refused.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 1024;

// (distance, index): a beats b when it is larger, or equal at a lower index
__device__ __forceinline__ void take_better(float& d, int& j, float od, int oj) {
  if (od > d || (od == d && oj < j)) { d = od; j = oj; }
}

__device__ __forceinline__ void warp_argmax(float& d, int& j) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oj = __shfl_xor_sync(0xffffffffu, j, off);
    take_better(d, j, od, oj);
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           const int* __restrict__ start,
                           int* __restrict__ out, int N, int npoint) {
  extern __shared__ float sm[];
  float* pts = sm;                                   // [N][3]
  float* win_d = sm + 3 * N;                         // [2][32]
  int* win_j = reinterpret_cast<int*>(win_d + 64);   // [2][32]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const float* cloud = xyz + (size_t)b * N * 3;
  for (int e = tid; e < 3 * N; e += blockDim.x) pts[e] = cloud[e];
  __syncthreads();
  const bool live = tid < N;
  const float x = live ? pts[3 * tid] : 0.f;
  const float y = live ? pts[3 * tid + 1] : 0.f;
  const float z = live ? pts[3 * tid + 2] : 0.f;
  float dist = live ? 1e10f : -1.f;    // a thread without a point never wins
  int far = min(max(start[b], 0), N - 1);   // the clamp only bounds the reads
  int* o = out + (size_t)b * npoint;
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) o[i] = far;
    if (i == npoint - 1) break;
    const float cx = pts[3 * far], cy = pts[3 * far + 1], cz = pts[3 * far + 2];
    if (live) {
      const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy),
                  dz = __fsub_rn(z, cz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist = fminf(dist, d);
    }
    float wd = dist;
    int wj = tid;
    warp_argmax(wd, wj);
    const int buf = (i & 1) * 32;
    if (lane == 0) { win_d[buf + warp] = wd; win_j[buf + warp] = wj; }
    __syncthreads();
    wd = lane < nwarps ? win_d[buf + lane] : -1.f;
    wj = lane < nwarps ? win_j[buf + lane] : N;
    warp_argmax(wd, wj);
    far = wj;
  }
}

}  // namespace

// xyz (B, N <= 1024, 3) float32 contiguous, start (B,) int32 in [0, N) ->
// out (B, npoint <= N) int32.
extern "C" int pcr_fps(const void* xyz, const void* start, void* out, int B,
                       int N, int npoint, void* stream) {
  if (B <= 0 || N <= 0 || N > MAX_N || npoint <= 0 || npoint > N)
    return (int)cudaErrorInvalidValue;
  const int threads = ((N + 31) / 32) * 32;
  const size_t smem = (size_t)3 * N * sizeof(float) + 64 * sizeof(float)
                      + 64 * sizeof(int);
  fps_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const int*)start, (int*)out, N, npoint);
  return (int)cudaGetLastError();
}
