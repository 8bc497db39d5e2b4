// Pointer-doubling shortcut + fragment relabel, for sm_90a.
//
// Replaces the Pallas TPU kernel
// kernels/spmv_minplus/spmv_minplus.py::pointer_jump (_jump_kernel):
// num_steps doublings p <- p[p] over a hook forest (hook_min guarantees
// parent[i] <= i), then out[i] = p[comp[i]], every gather clipped to
// [0, n - 1] as the Pallas kernel's take(mode="clip") does.
//
// Bound: bytes.  The function reads parent and comp once and writes out
// once (12 bytes per label at n = len(comp)); each doubling step here also
// reads and writes the n labels again.
//
// Design.  The Pallas kernel holds the whole label array in VMEM and runs
// every step inside one launch.  One H100 block's 227 KB of shared memory
// holds about 56K int32 labels, far below the 2^20 labels of the main
// path, so the labels stay in device memory (and L2: 4 MB at n = 2^20) and
// each step is its own launch — the launch boundary is the grid-wide
// barrier a step needs.  Steps ping-pong between two scratch buffers; the
// first reads parent and the relabel reads the last.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int clip(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(THREADS)
jump_step(const int* __restrict__ src, int* __restrict__ dst, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) dst[i] = src[clip(src[i], n)];
}

__global__ void __launch_bounds__(THREADS)
relabel(const int* __restrict__ p, const int* __restrict__ comp,
        int* __restrict__ out, int n, int m) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < m) out[i] = p[clip(comp[i], n)];
}

}  // namespace

extern "C" {

// parent: n labels; comp, out: m labels; scratch: 2 * n labels.
int pointer_jump(const int* parent, const int* comp, int* out, int* scratch,
                 int n, int m, int num_steps, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (n + THREADS - 1) / THREADS;
  const int* src = parent;
  int* bufs[2] = {scratch, scratch + n};
  for (int k = 0; k < num_steps; ++k) {
    int* dst = bufs[k & 1];
    jump_step<<<nblocks, THREADS, 0, st>>>(src, dst, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  relabel<<<(m + THREADS - 1) / THREADS, THREADS, 0, st>>>(src, comp, out, n, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
