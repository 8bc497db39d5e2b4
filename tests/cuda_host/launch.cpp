// Compiles a kernel source (KERNEL_SOURCE, its shared-memory declarations
// rewritten to host_block's) with tests/cuda_host/cuda_runtime.h and runs
// a cooperative launch as grid.x * block.x host threads.
#include "cuda_runtime.h"

#include <thread>

thread_local uint3v threadIdx, blockIdx;
thread_local dim3 blockDim, gridDim;
thread_local HostBlock* host_block;
thread_local Barrier* host_grid;

#include KERNEL_SOURCE

cudaError_t cudaLaunchCooperativeKernel(const void* f, dim3 grid, dim3 block,
                                        void** args, size_t smem,
                                        cudaStream_t) {
  const auto kernel = reinterpret_cast<void (*)(const Shard)>(f);
  const Shard arg = *static_cast<const Shard*>(args[0]);
  const int B = grid.x, T = block.x;
  if (T % 32 != 0) return cudaErrorInvalidValue;
  Barrier all(B * T);
  std::vector<HostBlock> blocks(B);
  for (auto& b : blocks) {
    b.block.reset(new Barrier(T));
    for (int w = 0; w < T / 32; ++w) b.warps.emplace_back(new Barrier(32));
    b.lanes.resize(T / 32);
    b.smem.assign(smem / sizeof(int32_t) + 1, 0);
  }
  std::vector<std::thread> threads;
  for (int bi = 0; bi < B; ++bi)
    for (int t = 0; t < T; ++t)
      threads.emplace_back([&, bi, t] {
        threadIdx.x = t;
        blockIdx.x = bi;
        blockDim = block;
        gridDim = grid;
        host_block = &blocks[bi];
        host_grid = &all;
        kernel(arg);
      });
  for (auto& th : threads) th.join();
  return cudaSuccess;
}
