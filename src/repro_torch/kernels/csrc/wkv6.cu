// RWKV-6 WKV recurrence with data-dependent decay, for sm_90a.
//
// Replaces the Pallas TPU kernel kernels/rwkv6/rwkv6.py::wkv6
// (_wkv6_kernel): per batch·head, with key/value dim D and S_0 = 0,
//   out_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t),
//   S_t   = diag(w_t) S_{t-1} + k_tᵀ v_t,
// r, k, v, w (BH, T, D) and u (BH, D) in bf16 or float32, every operation
// in float32, out in r's type.  Beside the Pallas kernel it also writes the
// final state S_T (BH, D, D) float32, which prefill hands to decode, and it
// takes any T (the Pallas kernel asserts T % chunk == 0).
//
// Bound: operations.  The least work is 5 float32 operations per (t, i, j):
// r_i·S_ij into out_j (a multiply-add), k_i·v_j, and w_i·S_ij + k_i v_j (a
// multiply-add); 5·BH·T·D² at 67 TFLOP/s, against 10 (bf16) or 20 (float32)
// bytes per (t, i) of r, k, v, w and out over the memory rate: the operations
// take about 1.6 times the bytes' time at D = 64 in bf16.
//
// Design.  The TPU keeps S in VMEM scratch while time chunks stream through
// the in-order grid.  Here one block owns one batch·head and runs the whole
// time loop, S in registers: thread (j, ri), ri < R, holds the column S[:, j]
// at rows i = ri, ri + R, ri + 2R, ...  The r, k, v and w rows of CHUNK
// steps are staged in shared memory as float32 (coalesced loads), each step
// reads them as broadcasts, and the chunk's outputs are gathered in shared
// memory and written out coalesced.  Every operation is the one of the
// plain version (kernels/rwkv6/ref.py) in its order: k_i·v_j, u_i·kv,
// S_ij + ukv, times r_i, w_i·S_ij + kv, each rounded on its own (the
// _rn intrinsics keep the compiler from fusing them), and the sum over i as
// the same halving tree -- its levels h >= R inside a thread, the last
// log2(R) by shuffles across the R threads of a column.  So the kernel and
// the plain version agree bit for bit.  That costs about 7 operations per
// (t, i, j) against the least 5; the fused form out_j = Σ r_i S_ij + v_j Σ
// r_i u_i k_i, with a tolerance instead of equality, is for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int R = 4;            // threads per column of S
constexpr int CHUNK = 32;       // time steps staged in shared memory at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Levels h = H, H/2, ..., 1 of the halving tree over a thread's rows:
// p[m] += p[m + h] for m < h.
template <int H, int M>
__device__ __forceinline__ void local_tree(float (&p)[M]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int m = 0; m < H; ++m) p[m] = __fadd_rn(p[m], p[m + H]);
    local_tree<H / 2>(p);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(D * R)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, T* __restrict__ out,
            float* __restrict__ state, int t_len) {
  constexpr int THREADS = D * R;
  constexpr int M = D / R;                    // rows of S per thread
  __shared__ float rs[CHUNK * D], ks[CHUNK * D], vs[CHUNK * D],
      ws[CHUNK * D], os[CHUNK * D];

  const int bh = blockIdx.x;
  const int j = threadIdx.x / R, ri = threadIdx.x % R;
  const long long base = (long long)bh * t_len * D;
  float s[M], uu[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    s[m] = 0.f;
    uu[m] = to_f32(u[(long long)bh * D + ri + R * m]);
  }

  for (int t0 = 0; t0 < t_len; t0 += CHUNK) {
    const int n = min(CHUNK, t_len - t0);
    const long long off = base + (long long)t0 * D;
    for (int x = threadIdx.x; x < n * D; x += THREADS) {
      rs[x] = to_f32(r[off + x]);
      ks[x] = to_f32(k[off + x]);
      vs[x] = to_f32(v[off + x]);
      ws[x] = to_f32(w[off + x]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float* rt = rs + tt * D;
      const float* kt = ks + tt * D;
      const float* wt = ws + tt * D;
      const float vj = vs[tt * D + j];
      float p[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = ri + R * m;
        const float kv = __fmul_rn(kt[i], vj);
        p[m] = __fmul_rn(__fadd_rn(s[m], __fmul_rn(uu[m], kv)), rt[i]);
        s[m] = __fadd_rn(__fmul_rn(wt[i], s[m]), kv);
      }
      // Halving tree over i: level h pairs row i with row i + h.  For
      // h >= R both rows are this thread's (local m and m + h / R).
      local_tree<M / 2>(p);
      // For h < R, row ri pairs with row ri + h: the thread ri ^ h.
      float o = p[0];
#pragma unroll
      for (int h = R / 2; h >= 1; h /= 2)
        o = __fadd_rn(o, __shfl_xor_sync(FULL, o, h));
      if (ri == 0) os[tt * D + j] = o;
    }
    __syncthreads();
    for (int x = threadIdx.x; x < n * D; x += THREADS)
      store(out + off + x, os[x]);
  }

  float* sb = state + (long long)bh * D * D;
#pragma unroll
  for (int m = 0; m < M; ++m) sb[(ri + R * m) * D + j] = s[m];
}

template <int D, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, float* state, int bh, int t,
           cudaStream_t stream) {
  wkv6_kernel<D, T><<<bh, D * R, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<T*>(out), state, t);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, float* state, int bh, int t, int d,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, T>(r, k, v, w, u, out, state, bh, t, stream);
    case 64: return launch<64, T>(r, k, v, w, u, out, state, bh, t, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Head dims this source is built for: 16 (the smoke config) and 64
// (RWKV6-3B).  The wrapper raises on any other.
int wkv6_supports(int d) { return d == 16 || d == 64; }

// r, k, v, w, out: (bh, t, d); u: (bh, d); all contiguous, one type: bf16 =
// 0 for float32, 1 for bfloat16.  state: (bh, d, d) float32, written whole.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* out, void* state, int bf16, int bh, int t,
             int d, void* stream) {
  if (bh <= 0) return 0;
  if (t < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(state);
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, w, u, out, sp, bh, t, d, st)
              : dispatch<float>(r, k, v, w, u, out, sp, bh, t, d, st);
}

}  // extern "C"
