// Mamba selective scan (S6) with the final state, for sm_90a.
//
// Replaces the Pallas TPU kernel kernels/mamba_scan/mamba_scan.py::
// selective_scan (_scan_kernel): per batch, channel d and state index n,
// from h_0 = 0,
//   h_t[d,n] = exp(dt_t[d]·A[d,n])·h_{t-1}[d,n] + (dt_t[d]·x_t[d])·B_t[n],
//   y_t[d]   = Σ_n C_t[n]·h_t[d,n] + D[d]·x_t[d],
// x, dt (B, T, dim) and b, c (B, T, N) in bf16 or float32, a (dim, N) and
// d (dim,) float32, every operation in float32, y in x's type.  Beside the
// Pallas kernel it writes the final state h_T (B, dim, N) float32, which
// prefill hands to decode, and it takes any T and any dim (the Pallas
// kernel asserts T % chunk == 0 and keeps all dim channels in one block).
//
// Bound: bytes.  x, dt and y are read or written once (dim values a step),
// b and c once (N values a step), a, d and the state once: 811 MB at the
// served shapes (B 8, T 1024, dim 8192, N 16, float32), 0.242 ms at 3.35
// TB/s, against 5·B·T·dim·N = 5.4e9 float32 operations (0.080 ms at 67
// TFLOP/s) and 1.07e9 exps on the special-function units.
//
// Design.  The TPU keeps the whole (dim, N) state in one VMEM block while
// time chunks stream through its in-order grid; at dim 8192 that is 512 KB,
// past a block's shared memory.  Channels are independent, so here one
// thread owns one (batch, channel): its N states and its row of a sit in
// registers, and y needs no reduction across threads.  A block covers BLOCK
// channels of one batch and runs the whole time loop.  Each chunk of CHUNK
// steps is staged in shared memory first: x and dt with loads coalesced
// over the block's channels, all issued before any is used, and b and c,
// which every thread of the block reads as broadcasts.  Every operation is
// the one of the plain version (kernels/mamba_scan/ref.py) in its order:
// dt·a, expf (not __expf), dt·x, decay·h + dtx·b, h·c, the sum over n as
// the same halving tree, then + d·x, each rounded on its own (the _rn
// intrinsics keep the compiler from fusing them).  So the kernel and the
// plain version agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;      // channels per block, one thread each
constexpr int CHUNK = 32;       // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Levels h = H, H/2, ..., 1 of the halving tree: p[m] += p[m + h], m < h.
template <int H, int M>
__device__ __forceinline__ void halving_tree(float (&p)[M]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int m = 0; m < H; ++m) p[m] = __fadd_rn(p[m], p[m + H]);
    halving_tree<H / 2>(p);
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(BLOCK)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ b, const T* __restrict__ c,
            const float* __restrict__ a, const float* __restrict__ d,
            T* __restrict__ y, float* __restrict__ state, int t_len,
            int dim) {
  __shared__ float xs[CHUNK][BLOCK], dts[CHUNK][BLOCK];
  __shared__ float bs[CHUNK * N], cs[CHUNK * N];

  const int tid = threadIdx.x;
  const int ch = blockIdx.x * BLOCK + tid;
  const bool valid = ch < dim;
  const long long xbase = (long long)blockIdx.y * t_len * dim + ch;
  const long long nbase = (long long)blockIdx.y * t_len * N;
  float h[N], av[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = 0.f;
    av[n] = valid ? a[(long long)ch * N + n] : 0.f;
  }
  const float dv = valid ? d[ch] : 0.f;

  for (int t0 = 0; t0 < t_len; t0 += CHUNK) {
    const int steps = min(CHUNK, t_len - t0);
    if (valid) {
      for (int i = 0; i < steps; ++i) {
        const long long off = xbase + (long long)(t0 + i) * dim;
        xs[i][tid] = to_f32(x[off]);
        dts[i][tid] = to_f32(dt[off]);
      }
    }
    for (int e = tid; e < steps * N; e += BLOCK) {
      const long long off = nbase + (long long)t0 * N + e;
      bs[e] = to_f32(b[off]);
      cs[e] = to_f32(c[off]);
    }
    __syncthreads();
    if (valid) {
      for (int i = 0; i < steps; ++i) {
        const float xv = xs[i][tid], dtv = dts[i][tid];
        const float dtx = __fmul_rn(dtv, xv);
        const float* bt = bs + i * N;
        const float* ct = cs + i * N;
        float p[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float decay = expf(__fmul_rn(dtv, av[n]));
          h[n] = __fadd_rn(__fmul_rn(decay, h[n]), __fmul_rn(dtx, bt[n]));
          p[n] = __fmul_rn(h[n], ct[n]);
        }
        halving_tree<N / 2>(p);
        store(y + xbase + (long long)(t0 + i) * dim,
              __fadd_rn(p[0], __fmul_rn(dv, xv)));
      }
    }
    __syncthreads();
  }

  if (valid) {
    float* sp = state + ((long long)blockIdx.y * dim + ch) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) sp[n] = h[n];
  }
}

template <int N, typename T>
int launch(const void* x, const void* dt, const void* b, const void* c,
           const float* a, const float* d, void* y, float* state, int bsz,
           int t, int dim, cudaStream_t stream) {
  const dim3 grid((dim + BLOCK - 1) / BLOCK, bsz);
  scan_kernel<N, T><<<grid, BLOCK, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(b), static_cast<const T*>(c), a, d,
      static_cast<T*>(y), state, t, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* b, const void* c,
             const float* a, const float* d, void* y, float* state, int bsz,
             int t, int dim, int n, cudaStream_t stream) {
  switch (n) {
    case 8: return launch<8, T>(x, dt, b, c, a, d, y, state, bsz, t, dim,
                                stream);
    case 16: return launch<16, T>(x, dt, b, c, a, d, y, state, bsz, t, dim,
                                  stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// State sizes this source is built for: 8 (the smoke config) and 16
// (Jamba).  The wrapper raises on any other.
int selective_scan_supports(int n) { return n == 8 || n == 16; }

// x, dt, y: (bsz, t, dim); b, c: (bsz, t, n), one type: bf16 = 0 for
// float32, 1 for bfloat16.  a: (dim, n) and d: (dim,) float32.  state:
// (bsz, dim, n) float32, written whole.  All contiguous.
int selective_scan_fwd(const void* x, const void* dt, const void* b,
                       const void* c, const void* a, const void* d, void* y,
                       void* state, int bf16, int bsz, int t, int dim, int n,
                       void* stream) {
  if (bsz <= 0 || dim <= 0) return 0;
  if (t < 0 || bsz > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(d);
  float* sp = static_cast<float*>(state);
  return bf16 ? dispatch<__nv_bfloat16>(x, dt, b, c, af, df, y, sp, bsz, t,
                                        dim, n, st)
              : dispatch<float>(x, dt, b, c, af, df, y, sp, bsz, t, dim, n,
                                st);
}

}  // extern "C"
