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
// Bound.  x, dt and y are read or written once (dim values a step), b and
// c once (N values a step), a, d and the state once: 811 MB at the served
// shapes (B 8, T 1024, dim 8192, N 16, float32), 0.242 ms at 3.35 TB/s.
// The work is 1.07e9 (b, t, d, n) elements, each with one exp on the
// special-function units (16 a clock an SM: 0.26 ms at 1.98 GHz) and 5
// float32 operations that cannot be fused (0.16 ms at 128 a clock an SM).
// Held to the plain version's rounding (below), each element costs about 15
// issued instructions (the accurate expf alone is 8 of them, about 0.3 ms
// here), so this design's floor is the issue rate: about 0.5 ms at the
// served shapes.
//
// Rounding.  Every operation is the one of the plain version
// (kernels/mamba_scan/ref.py) in its order: dt·a, expf (not __expf), dt·x,
// decay·h + dtx·b, h·c, the sum over n as ref.halving_sum's tree, then
// + d·x, each rounded on its own (the _rn intrinsics keep the compiler from
// fusing them).  So the kernel and the plain version agree bit for bit.
//
// Design.  The TPU keeps the whole (dim, N) state in one VMEM block while
// time chunks stream through its in-order grid; at dim 8192 that is 512 KB,
// past a block's shared memory.  Channels are independent, so here one
// thread owns one (batch, channel): its N states and its row of a sit in
// registers, and y needs no reduction across threads.  A block covers
// THREADS channels of one batch and runs the whole time loop: 512 blocks at
// the served shapes, one wave of about 16 warps an SM, each thread with up
// to 128 registers, which a chunk's unrolled steps use to overlap one
// step's exps with the last one's updates.  Each chunk of CHUNK steps of x,
// dt, b and c is copied raw into shared memory by cp.async (16-byte pieces,
// a fixed slot map a thread) while the chunk before it is computed, double
// buffered; a thread waits only at the chunk edge, and the blocks, all
// alike, no longer wait for the memory together.  Where dim or a pointer
// does not allow 16-byte pieces, the next chunk is loaded element by
// element instead, at the same point.  A step's b and c are read as 16-byte
// broadcasts (every thread reads the same address; bf16 ones are widened to
// float32 once a chunk, by the whole block), and a whole chunk's steps are
// unrolled into one straight run.  (Two lanes a channel, N/2 states each
// and one shuffle in the tree, doubles the warps but halves the registers,
// and ran no faster.  Nor did an expf whose last scaling is an integer add
// to the exponent field, one instruction shorter and exact where the
// result is a normal float: a chunk then needs a guard on max |dt·a| and
// a second, expf, path, which cost more than the instruction saved.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 128;   // channels a block, one thread each
constexpr int CHUNK = 8;       // time steps staged at once
// Blocks an SM at the served shapes (dim / THREADS · B of them over 132
// SMs): up to 128 registers a thread.
constexpr int MIN_BLOCKS = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Q consecutive elements of shared memory as float32, as one load.
template <int Q>
__device__ __forceinline__ void load_q(const float* p, float (&f)[Q]) {
  if constexpr (Q == 8) {
    const float4 u = reinterpret_cast<const float4*>(p)[0];
    const float4 v = reinterpret_cast<const float4*>(p)[1];
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
  } else if constexpr (Q == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  } else {
    static_assert(Q == 2, "Q: 2, 4 or 8");
    const float2 u = *reinterpret_cast<const float2*>(p);
    f[0] = u.x; f[1] = u.y;
  }
}

// 16 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
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

// One chunk's raw inputs: x and dt for the block's channels, b and c.
template <int N, typename T>
struct Stage {
  T x[CHUNK][THREADS], dt[CHUNK][THREADS];
  T b[CHUNK][N], c[CHUNK][N];
};

template <int N, typename T>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);        // elements a piece
  static constexpr int ROW = THREADS / VEC;         // pieces a row of x
  static constexpr int XP = 2 * CHUNK * ROW;        // pieces of x and dt
  static constexpr int NP = CHUNK * N / VEC;        // pieces of b (of c)
  static_assert(THREADS % VEC == 0 && N % VEC == 0 && XP % THREADS == 0 &&
                    2 * NP <= THREADS,
                "staging: whole pieces, a fixed number a thread");
};

// Copy chunk rows [t0, t0 + steps) of x, dt, b and c into st.  ``vec``:
// 16-byte pieces by cp.async (dim a multiple of VEC and every pointer
// 16-byte aligned); otherwise element by element.
template <int N, typename T>
__device__ __forceinline__ void stage_chunk(
    Stage<N, T>& st, const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ b, const T* __restrict__ c, long long xrow0,
    long long nrow0, int t0, int steps, int ch0, int dim, bool vec) {
  using S = Shape<N, T>;
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int j = 0; j < S::XP / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int arr = e / (CHUNK * S::ROW);
      const int row = (e / S::ROW) % CHUNK;
      const int col = (e % S::ROW) * S::VEC;
      if (row < steps && ch0 + col < dim) {
        const long long off = xrow0 + (long long)(t0 + row) * dim + ch0 + col;
        if (arr == 0) cp_async16(&st.x[row][col], x + off);
        else cp_async16(&st.dt[row][col], dt + off);
      }
    }
    if (tid < 2 * S::NP) {
      const int e = tid % S::NP;
      const int row = e * S::VEC / N;
      if (row < steps) {
        const long long off = nrow0 + (long long)t0 * N + e * S::VEC;
        if (tid < S::NP) cp_async16(&st.b[0][0] + e * S::VEC, b + off);
        else cp_async16(&st.c[0][0] + e * S::VEC, c + off);
      }
    }
  } else {
    for (int e = tid; e < CHUNK * THREADS; e += THREADS) {
      const int row = e / THREADS, col = e % THREADS;
      if (row < steps && ch0 + col < dim) {
        const long long off = xrow0 + (long long)(t0 + row) * dim + ch0 + col;
        st.x[row][col] = x[off];
        st.dt[row][col] = dt[off];
      }
    }
    for (int e = tid; e < steps * N; e += THREADS) {
      const long long off = nrow0 + (long long)t0 * N + e;
      (&st.b[0][0])[e] = b[off];
      (&st.c[0][0])[e] = c[off];
    }
  }
}

// A chunk's b and c as float32, for bf16 inputs (float32 ones are read
// where they were staged).
template <int N>
struct Widened {
  float b[CHUNK][N], c[CHUNK][N];
};

// One step of one channel: its N states, the tree, and y at yt (stored
// for a valid channel).  The step's b and c (bt, ct: N float32 each) come
// as two halves, the n < N/2 and the n >= N/2, which the tree's first
// level adds pairwise.
template <int N, typename T>
__device__ __forceinline__ void scan_step(
    const Stage<N, T>& st, int i, const float* bt, const float* ct,
    bool valid, float (&h)[N], const float (&av)[N], float dv, T* yt) {
  constexpr int H = N / 2;
  const float xv = to_f32(st.x[i][threadIdx.x]);
  const float dtv = to_f32(st.dt[i][threadIdx.x]);
  const float dtx = __fmul_rn(dtv, xv);
  float b_lo[H], b_hi[H], c_lo[H], c_hi[H];
  load_q<H>(bt, b_lo);
  load_q<H>(bt + H, b_hi);
  load_q<H>(ct, c_lo);
  load_q<H>(ct + H, c_hi);
  float p[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float bn = n < H ? b_lo[n] : b_hi[n - H];
    const float cn = n < H ? c_lo[n] : c_hi[n - H];
    const float decay = expf(__fmul_rn(dtv, av[n]));
    h[n] = __fadd_rn(__fmul_rn(decay, h[n]), __fmul_rn(dtx, bn));
    p[n] = __fmul_rn(h[n], cn);
  }
  halving_tree<H>(p);
  if (valid) store(yt, __fadd_rn(p[0], __fmul_rn(dv, xv)));
}

template <int N, typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ b, const T* __restrict__ c,
            const float* __restrict__ a, const float* __restrict__ d,
            T* __restrict__ y, float* __restrict__ state, int t_len,
            int dim, bool vec) {
  constexpr bool WIDEN = !std::is_same<T, float>::value;
  __shared__ __align__(16) Stage<N, T> stage[2];

  const int ch0 = blockIdx.x * THREADS;
  const int ch = ch0 + threadIdx.x;
  const bool valid = ch < dim;
  const long long xrow0 = (long long)blockIdx.y * t_len * dim;
  const long long nrow0 = (long long)blockIdx.y * t_len * N;
  float h[N], av[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = 0.f;
    av[n] = valid ? a[(long long)ch * N + n] : 0.f;
  }
  const float dv = valid ? d[ch] : 0.f;
  T* yp = y + xrow0 + ch;

  const int nchunks = (t_len + CHUNK - 1) / CHUNK;
  if (nchunks > 0) {
    stage_chunk<N, T>(stage[0], x, dt, b, c, xrow0, nrow0, 0,
                      min(CHUNK, t_len), ch0, dim, vec);
    cp_async_commit();
  }
  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * CHUNK;
    if (ci + 1 < nchunks) {
      stage_chunk<N, T>(stage[(ci + 1) & 1], x, dt, b, c, xrow0, nrow0,
                        t0 + CHUNK, min(CHUNK, t_len - t0 - CHUNK), ch0, dim,
                        vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<N, T>& st = stage[ci & 1];
    const int steps = min(CHUNK, t_len - t0);
    const float* bt = reinterpret_cast<const float*>(&st.b[0][0]);
    const float* ct = reinterpret_cast<const float*>(&st.c[0][0]);
    if constexpr (WIDEN) {
      __shared__ __align__(16) Widened<N> wide;
      for (int e = threadIdx.x; e < steps * N; e += THREADS) {
        (&wide.b[0][0])[e] = to_f32((&st.b[0][0])[e]);
        (&wide.c[0][0])[e] = to_f32((&st.c[0][0])[e]);
      }
      __syncthreads();
      bt = &wide.b[0][0];
      ct = &wide.c[0][0];
    }
    T* yt = yp + (long long)t0 * dim;
    if (steps == CHUNK) {
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
        scan_step<N, T>(st, i, bt + i * N, ct + i * N, valid, h, av, dv,
                        yt + (long long)i * dim);
    } else {
      for (int i = 0; i < steps; ++i)
        scan_step<N, T>(st, i, bt + i * N, ct + i * N, valid, h, av, dv,
                        yt + (long long)i * dim);
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
  using S = Shape<N, T>;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = dim % S::VEC == 0 && aligned(x) && aligned(dt) &&
                   aligned(b) && aligned(c);
  const dim3 grid((dim + THREADS - 1) / THREADS, bsz);
  scan_kernel<N, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(b), static_cast<const T*>(c), a, d,
      static_cast<T*>(y), state, t, dim, vec);
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
