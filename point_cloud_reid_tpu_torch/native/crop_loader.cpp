// Native crop-store batch loader.
//
// A copy of point_cloud_reid_tpu/native/crop_loader.cpp (the same entry
// points, the same splitmix64 streams, so both packages read the same batch
// from the same files and seeds). Where the reference leans on torch
// DataLoader worker *processes* (mmdet3d/datasets/object_loader_base.py:
// 247-301 reads pts_xyz.bin / img_crop.bin per item in Python), this library
// performs the per-item disk read + resample-with-replacement + fixed-shape
// batch assembly in a C++ thread pool, handing back one contiguous float32
// batch. native/__init__.py builds it with g++ and binds it with ctypes; it
// has no fallback (native/plain.py is the tests' numpy copy of the stream).
//
// Determinism: resampling uses splitmix64 streams seeded per item by the
// caller, so a (seed, epoch, index) triple fully determines the batch —
// mirroring the framework's counter-based sampler RNG
// (data/samplers.py::_sample_rng). Fewer than `min_points` (3) points loads
// as zeros, matching subsamplePC (datasets/utils.py:606-621).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    if (n == 0) return 0;
    __uint128_t m = (__uint128_t)next() * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (-n) % n;
      while (l < t) {
        m = (__uint128_t)next() * n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { loop(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
      }
      job();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

ThreadPool* pool = nullptr;
std::mutex pool_mu;

ThreadPool& get_pool(int nthreads) {
  std::lock_guard<std::mutex> lk(pool_mu);
  if (!pool) pool = new ThreadPool(nthreads > 0 ? nthreads : 4);
  return *pool;
}

// read a whole binary file; returns bytes read or -1
long read_file(const char* path, std::vector<char>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(sz);
  long got = (long)std::fread(buf.data(), 1, sz, f);
  std::fclose(f);
  return got == sz ? sz : -1;
}

// load one crop file and resample-with-replacement into out (k x 3)
int load_one(const char* path, float* out, int k, uint64_t seed,
             int min_points) {
  std::vector<char> buf;
  long sz = read_file(path, buf);
  std::memset(out, 0, sizeof(float) * k * 3);
  if (sz < 0) return -1;  // missing file -> zeros (soft failure)
  long n = sz / (3 * (long)sizeof(float));
  if (n < min_points) return (int)n;  // too few points -> zeros
  const float* pts = reinterpret_cast<const float*>(buf.data());
  SplitMix64 rng(seed);
  for (int i = 0; i < k; ++i) {
    uint64_t j = rng.bounded((uint64_t)n);
    std::memcpy(out + i * 3, pts + j * 3, 3 * sizeof(float));
  }
  return (int)n;
}

}  // namespace

extern "C" {

// Load a batch of point crops in parallel.
//   paths:  array of B null-terminated file paths
//   seeds:  B per-item RNG seeds
//   out:    (B, k, 3) float32 buffer
//   counts: (B,) int32 raw point counts (-1 = missing file)
// Returns 0 on success.
//
// Work is submitted in chunks, not per item: per-job queue traffic (lock +
// notify) measured ~1-2 us each, which at 4096-crop batches was a multi-ms
// tax before any byte was read.
static void run_point_batch(const std::function<const char*(int)>& path_of,
                            int batch, int k, const uint64_t* seeds,
                            float* out, int32_t* counts, int min_points,
                            int nthreads) {
  ThreadPool& tp = get_pool(nthreads);
  const int chunk = 64;
  const int njobs = (batch + chunk - 1) / chunk;
  std::atomic<int> done{0};
  std::mutex mu;
  std::condition_variable cv;
  for (int j = 0; j < njobs; ++j) {
    tp.submit([&, j] {
      const int lo = j * chunk;
      const int hi = lo + chunk < batch ? lo + chunk : batch;
      for (int b = lo; b < hi; ++b)
        counts[b] = load_one(path_of(b), out + (long)b * k * 3, k, seeds[b],
                             min_points);
      if (done.fetch_add(1) + 1 == njobs) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == njobs; });
}

int pcr_load_point_batch(const char** paths, int batch, int k,
                         const uint64_t* seeds, float* out, int32_t* counts,
                         int min_points, int nthreads) {
  run_point_batch([paths](int b) { return paths[b]; }, batch, k, seeds, out,
                  counts, min_points, nthreads);
  return 0;
}

// Strided variant: `paths` is one contiguous (batch x stride) char buffer of
// NUL-terminated strings — what a numpy fixed-width bytes array holds after a
// fancy-index gather. Lets Python hand over a whole batch of paths without
// building B per-item objects (the char** marshalling was ~30 ms per
// 4096-crop batch).
int pcr_load_point_batch_strided(const char* paths, long stride, int batch,
                                 int k, const uint64_t* seeds, float* out,
                                 int32_t* counts, int min_points,
                                 int nthreads) {
  run_point_batch([paths, stride](int b) { return paths + b * stride; },
                  batch, k, seeds, out, counts, min_points, nthreads);
  return 0;
}

// Load raw float32 blobs (e.g. img_crop.bin) in parallel, each exactly
// `elems` floats; short/missing files load as zeros and report -1.
int pcr_load_blob_batch(const char** paths, int batch, long elems,
                        float* out, int32_t* ok, int nthreads) {
  ThreadPool& tp = get_pool(nthreads);
  const int chunk = 16;  // blobs are big (e.g. 588 KB image crops)
  const int njobs = (batch + chunk - 1) / chunk;
  std::atomic<int> done{0};
  std::mutex mu;
  std::condition_variable cv;
  for (int j = 0; j < njobs; ++j) {
    tp.submit([&, j] {
      const int lo = j * chunk;
      const int hi = lo + chunk < batch ? lo + chunk : batch;
      std::vector<char> buf;
      for (int b = lo; b < hi; ++b) {
        float* dst = out + (long)b * elems;
        long sz = read_file(paths[b], buf);
        if (sz == elems * (long)sizeof(float)) {
          std::memcpy(dst, buf.data(), sz);
          ok[b] = 1;
        } else {
          std::memset(dst, 0, elems * sizeof(float));
          ok[b] = -1;
        }
      }
      if (done.fetch_add(1) + 1 == njobs) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == njobs; });
  return 0;
}

int pcr_version() { return 2; }  // 2: strided point batch + chunked jobs

}  // extern "C"
