// Causal or full GQA attention forward with an online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel
// kernels/flash_attention/flash_attention.py::flash_attention (_fa_kernel):
// q (B, Hq, S, D), k and v (B, Hkv, S, D), kv head = q head / (Hq / Hkv);
// o = softmax(q k^T * scale, causal mask -1e30) v, in q's type.  q, k and v
// are read as float32 and every product, exponential and sum is float32,
// as the Pallas kernel casts its tiles to f32 before the dots.
//
// Bound: the larger of the bytes (q, k, v and o, each once) over the memory
// rate and the 2·S²·D operations per (b, q head), causal half skipped, over
// the bf16 tensor-core rate.  In bf16 that is S/4 operations per byte per
// head: at S = 1024 the two times are within 15 % of each other.  This
// kernel does its products on the float32 cores (67 TFLOP/s), not the
// tensor cores, so it is far from either: `wgmma` on bf16 tiles, and TMA
// loads, are for a later change.
//
// Design.  The TPU grid runs its KV axis in order and carries (m, l, acc)
// in VMEM scratch across grid steps.  Here one block owns one
// (b, q head, 64-row query tile) and loops over the 64-key tiles itself,
// with the statistics in registers.  256 threads form a 16 x 16 grid: each
// thread owns 4 query rows (ty) and, for the scores, 4 keys (tx); for the
// output, ceil(D/16) neighbouring columns, the last threads' columns past D
// left idle when 16 does not divide D (D = 24: 2 columns each for tx < 12).
// A row's max and sum are reduced over the 16 tx threads of its half-warp
// with shuffles.  Q and K tiles sit in shared memory transposed, so a
// thread's 4 rows and 4 keys at one depth are one 16-byte load each; the
// probabilities go through shared memory, transposed, to the P·V product.  Tiles above the diagonal are skipped:
// every row has seen key 0 in the first tile, so a skipped tile would add
// exp(-1e30 - m) = 0.  Any S is taken: keys past S in the last tile get
// probability 0, and rows past S are not written.  Late query tiles, which
// have the most key tiles under the causal mask, are launched first.  Every
// head dim that is a multiple of 8 up to MAX_D has an instance; loads and
// stores of q, k, v and o are one element each, so D need not be a
// multiple of the 16-byte vector.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int PAD = 4;          // row padding that keeps float4 alignment
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_D = 128;      // head dims 8, 16, ..., MAX_D are built

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * (BQ + PAD) + (size_t)D * (BK + PAD) +
                          (size_t)BK * (D + PAD) + (size_t)BK * (BQ + PAD));
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
             int s, float scale, int causal) {
  constexpr int CPT = (D + 15) / 16;          // output columns per thread
  constexpr int LQ = BQ + PAD, LK = BK + PAD, LV = D + PAD;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                           // [D][LQ]  Q tile, transposed
  float* kt = qt + D * LQ;                    // [D][LK]  K tile, transposed
  float* vt = kt + D * LK;                    // [BK][LV] V tile
  float* pt = vt + BK * LV;                   // [BK][LQ] P tile, transposed

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long seq = (long long)s * D;
  const T* qb = q + ((long long)b * hq + h) * seq;
  const T* kb = k + ((long long)b * hkv + hk) * seq;
  const T* vb = v + ((long long)b * hkv + hk) * seq;
  T* ob = o + ((long long)b * hq + h) * seq;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = tx * CPT;                    // this thread's first column

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qt[c * LQ + r] = q0 + r < s ? to_f32(qb[(long long)(q0 + r) * D + c]) : 0.f;
  }
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(s, q0 + BQ) : s;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();        // the last tile's reads of kt, vt and pt are done
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < s;
      const long long off = (long long)(k0 + r) * D + c;
      kt[c * LK + r] = in ? to_f32(kb[off]) : 0.f;
      vt[r * LV + c] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LQ + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kt + d * LK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        ok[j] = kpos < s && (!causal || kpos <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        sum += p;
        pt[(tx * 4 + j) * LQ + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + j * LQ + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[CPT];
      const float* vr = vt + j * LV + c0;
      if constexpr (D % 16 == 0 && CPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CPT; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr + c);
          vv[c] = t.x; vv[c + 1] = t.y; vv[c + 2] = t.z; vv[c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = c0 + c < D ? vr[c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (c0 + c < D) store(ob + (long long)row * D + c0 + c, acc[i][c] / den);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s, scale,
      causal);
  return (int)cudaGetLastError();
}

// Instances for D = 8, 16, ..., MAX_D: the launch for head dim d.
template <typename T, int D = 8>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int s, int d, float scale, int causal,
             cudaStream_t stream) {
  if (d == D)
    return launch<D, T>(q, k, v, o, b, hq, hkv, s, scale, causal, stream);
  if constexpr (D < MAX_D)
    return dispatch<T, D + 8>(q, k, v, o, b, hq, hkv, s, d, scale, causal,
                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Head dims this source is built for, a multiple of 8 up to MAX_D (the
// wrapper raises on any other).
int flash_attention_supports(int d) {
  return d >= 8 && d <= MAX_D && d % 8 == 0;
}

// q, o: (b, hq, s, d); k, v: (b, hkv, s, d); all contiguous, one type:
// bf16 = 0 for float32, 1 for bfloat16.  hq must be a multiple of hkv.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bf16, int b, int hq, int hkv, int s, int d,
                        float scale, int causal, void* stream) {
  if (b <= 0 || s <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, d, scale,
                                        causal, st)
              : dispatch<float>(q, k, v, o, b, hq, hkv, s, d, scale, causal,
                                st);
}

}  // extern "C"
