// Host stand-ins for the CUDA runtime and device intrinsics that the GHS
// interval kernel (src/repro_torch/kernels/csrc/ghs_superstep.cu) uses, so
// that g++ compiles it and runs it on host threads: one std::thread a CUDA
// thread, __syncthreads, grid syncs and __syncwarp as barriers, and the
// warp votes and shuffles as collectives of the warp's 32 threads.  A lane
// that reads a word another lane wrote without a __syncwarp between them
// races here as on the card, and a warp whose lanes diverge at a
// collective waits until BARRIER_TIMEOUT_S, then the process exits with
// code 3.  Used by tests/test_torch_ghs_host_threads.py.
#pragma once
#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline

constexpr int BARRIER_TIMEOUT_S = 60;

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3v {
  unsigned x = 0, y = 0, z = 0;
};

struct Barrier {
  explicit Barrier(int n_) : n(n_) {}
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lock(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
      return;
    }
    if (!cv.wait_for(lock, std::chrono::seconds(BARRIER_TIMEOUT_S),
                     [&] { return gen != g; })) {
      std::fprintf(stderr, "host threads: a barrier of %d waited %d s with "
                           "%d arrived\n", n, BARRIER_TIMEOUT_S, count);
      std::_Exit(3);
    }
  }
  int n, count = 0;
  long gen = 0;
  std::mutex m;
  std::condition_variable cv;
};

// A block's barriers, its warps' exchange rows and its shared memory.
struct HostBlock {
  std::unique_ptr<Barrier> block;
  std::vector<std::unique_ptr<Barrier>> warps;
  std::vector<std::array<int64_t, 32>> lanes;
  std::vector<int32_t> smem;
  int32_t sums[2];
};

extern thread_local uint3v threadIdx, blockIdx;
extern thread_local dim3 blockDim, gridDim;
extern thread_local HostBlock* host_block;
extern thread_local Barrier* host_grid;

inline void __syncthreads() { host_block->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  host_block->warps[threadIdx.x / 32]->arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, bool p) {
  auto& row = host_block->lanes[threadIdx.x / 32];
  row[threadIdx.x % 32] = p;
  __syncwarp();
  unsigned r = 0;
  for (int k = 0; k < 32; ++k) r |= (row[k] ? 1u : 0u) << k;
  __syncwarp();
  return r;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  auto& row = host_block->lanes[threadIdx.x / 32];
  int64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  row[threadIdx.x % 32] = bits;
  __syncwarp();
  const int64_t got = row[src & 31];
  __syncwarp();
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline int atomicMax(int* a, int v) {
  std::atomic_ref<int> word(*a);
  int old = word.load();
  while (old < v && !word.compare_exchange_weak(old, v)) {
  }
  return old;
}

typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrCooperativeLaunch = 95
};
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 1;
  return 0;
}
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, const void*, int, size_t) {
  *n = 64;
  return 0;
}
cudaError_t cudaLaunchCooperativeKernel(const void*, dim3, dim3, void**,
                                        size_t, cudaStream_t);
