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
// reads and writes the n labels again, in L2 (4 MB at n = 2^20).
//
// Design.  The Pallas kernel holds the labels in VMEM and runs every step
// inside one launch.  One H100 block's shared memory holds about 56K int32
// labels, far below the 2^20 of the main path, so the labels stay in
// device memory and L2, and one cooperative launch (every block resident
// at once) runs every step: a grid-stride pass from one scratch buffer to
// the other, then a grid barrier (cooperative_groups).
//
// Exit at the fixed point.  If p[clip(p[j])] == p[j] for every j, every
// later step returns p again, whatever the input (a hook forest or not), so
// the loop leaves at the first step that changes no label and the result
// is that of all num_steps steps, bit for bit.  A block that changed a
// label in step k sets flags[k % 3]; after the barrier each block reads it.
// flags[(k + 1) % 3] is cleared during step k: its readers (step k - 2)
// passed barrier k - 1 before, its writers (step k + 1) start after
// barrier k.  The launch clears the other two before it ends, so every
// launch finds the flags at 0 (one set would only cost a step).
//
// The scratch buffers are written inside the launch, so they are read with
// ld.global.cg (L2, coherent across SMs), never through the read-only .nc
// path, which may keep a stale line.  comp is never written: __ldg.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// One block of 1024 threads an SM, 4 labels in flight a thread: on an
// H100 the fastest of 256-1024 threads, 1-4 blocks an SM and 4 or 8
// labels, on every input timed (PERF.md section 6); there a grid barrier
// of 132 blocks costs about 1.1 us, of 264 about 1.4, a launch about 2.2.
constexpr int THREADS = 1024;
constexpr int BLOCKS_PER_SM = 1;  // at most
constexpr int UNROLL = 4;         // labels a thread keeps in flight

__device__ __forceinline__ int clip(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// dst[i] = src[clip(idx[i])] for this thread's i = first + u * stride < m,
// UNROLL at a time: every load of a batch issued before its first store,
// so a thread's chain of L2 round trips is two a batch.  Whether a label
// changed (dst[i] != idx[i]).  kWritten: idx is written inside the launch
// (.cg), else read-only (.nc).  Indices are unsigned: n, m < 2^31.
template <bool kWritten>
__device__ __forceinline__ bool gather_pass(const int* idx, const int* src,
                                            int* dst, int n, unsigned m,
                                            unsigned first, unsigned stride) {
  bool changed = false;
  for (unsigned j = first; j < m; j += UNROLL * stride) {
    int a[UNROLL], b[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned i = j + u * stride;
      a[u] = i < m ? (kWritten ? __ldcg(idx + i) : __ldg(idx + i)) : 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (j + u * stride < m) b[u] = __ldcg(src + clip(a[u], n));
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j + u * stride < m) {
        dst[j + u * stride] = b[u];
        changed |= a[u] != b[u];
      }
    }
  }
  return changed;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
jump_kernel(const int* parent, const int* __restrict__ comp, int* out,
            int* buf0, int* buf1, int* flags, int n, int m, int num_steps) {
  cg::grid_group grid = cg::this_grid();
  const unsigned stride = gridDim.x * THREADS;
  const unsigned first = blockIdx.x * THREADS + threadIdx.x;
  const int* src = parent;
  int k = 0;
  for (;; ++k) {
    int* dst = (k & 1) ? buf1 : buf0;
    if (first == 0) flags[(k + 1) % 3] = 0;
    // One doubling step: dst[j] = src[clip(src[j])].
    const bool changed = gather_pass<true>(src, src, dst, n, n, first,
                                           stride);
    if (__syncthreads_or(changed) && threadIdx.x == 0) flags[k % 3] = 1;
    grid.sync();
    src = dst;
    // One load of the flag a block, handed to its threads by the barrier.
    const bool more = __syncthreads_or(threadIdx.x == 0 &&
                                       __ldcg(flags + k % 3) != 0);
    if (!more || k + 1 == num_steps) break;
  }
  if (first == 0) {
    flags[k % 3] = 0;           // every block has read it, or leaves anyway
    flags[(k + 2) % 3] = 0;     // read before barrier k
  }
  gather_pass<false>(comp, src, out, n, m, first, stride);   // the relabel
}

}  // namespace

extern "C" {

// The kernel's largest cooperative grid on card `device`: the blocks it
// holds at once, at most BLOCKS_PER_SM an SM (0 if it cannot launch
// cooperatively), and the threads a block.
int pointer_jump_grid(int device, int* blocks, int* threads) {
  int sms = 0, coop = 0, per_sm = 0, current = 0;
  *blocks = 0;
  *threads = THREADS;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jump_kernel,
                                                        THREADS, 0);
  cudaSetDevice(current);
  if (err == cudaSuccess && coop)
    *blocks = sms * (per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM);
  return (int)err;
}

// parent: n labels; comp, out: m labels; scratch: 2 * n labels; flags: 3
// words at 0, left at 0; max_blocks: at most pointer_jump_grid's blocks.
int pointer_jump(const int* parent, const int* comp, int* out, int* scratch,
                 int* flags, int n, int m, int num_steps, int max_blocks,
                 void* stream) {
  if (n <= 0 || m <= 0) return 0;
  if (num_steps <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  const long long want = ((long long)(n > m ? n : m) + THREADS - 1) / THREADS;
  const int blocks = (int)(want < max_blocks ? want : max_blocks);
  int* buf0 = scratch;
  int* buf1 = scratch + n;
  void* args[] = {&parent, &comp, &out, &buf0, &buf1, &flags,
                  &n, &m, &num_steps};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)jump_kernel, dim3(blocks), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
