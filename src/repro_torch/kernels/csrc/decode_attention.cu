// Single-token GQA attention over a KV cache (flash decode), for sm_90a.
//
// Replaces the Pallas TPU kernel
// kernels/decode_attention/decode_attention.py::decode_attention
// (_decode_kernel): q (B, Hq, D) one token, k and v (B, Hkv, S, D) the
// cache, length (B,) int32; cache positions >= length[b] get the logit
// -1e30, so o = softmax(q k^T * scale) v over the first length[b]
// positions, in q's type.  All arithmetic is float32, as in the Pallas
// kernel.  A row with length <= 0 has every logit at -1e30, so every
// p = exp(0) = 1 and its output is the mean of V over all S positions:
// this kernel gives that row every position with the logit 0.
//
// Bound: bytes.  The K and V rows up to length[b] are read once, and q and
// o once; the 4·D operations per (q head, position) are nothing beside
// that.
//
// Design.  The TPU grid streams 512-position KV tiles in order and carries
// (m, l, acc) in VMEM scratch, with the G query heads of one KV head packed
// as a (G, D) tile so that each KV tile is read once per group.  Here one
// block owns one (b, kv head) and up to 8 of its query heads (a larger
// group takes more blocks), and never reads past length[b].  Each of its 8
// warps walks its own 32-position chunks with its own online softmax:
// lane i scores position i of the chunk for every head from one 16-byte
// load at a time of the K row, the warp reduces max and sum with shuffles,
// and then the warp reads the chunk's V rows whole (each lane ceil(D/32)
// neighbouring columns, the last lanes idle when 32 does not divide D) and
// accumulates P·V.  At the end the 8 warps' (m, l, acc) are
// merged through shared memory.  One block per (b, kv head) leaves most of
// the card idle at small batch; splitting the positions across blocks
// (split-K) is for a later change.  Every head dim that is a multiple of 8
// up to 128 has an instance: a K row is then a whole number of 16-byte
// loads in bf16 and in float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int GB = 8;           // query heads per block
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

// 16 bytes of a row as float32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length,
              T* __restrict__ o, int hq, int hkv, int s, float scale) {
  constexpr int E = 16 / sizeof(T);             // elements per 16-byte load
  constexpr int DPL = (D + 31) / 32;            // P·V columns per lane
  __shared__ __align__(16) float qs[GB][D];
  __shared__ float ms[WARPS][GB], ls[WARPS][GB];
  __shared__ float accs[WARPS][GB][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = hq / hkv;
  const int h0 = hk * group + blockIdx.z * GB;  // first query head here
  const int ng = min(GB, group - (int)blockIdx.z * GB);
  const long long seq = (long long)s * D;
  const T* kb = k + ((long long)b * hkv + hk) * seq;
  const T* vb = v + ((long long)b * hkv + hk) * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = lane * DPL;                    // this lane's first column

  for (int i = threadIdx.x; i < ng * D; i += THREADS)
    qs[i / D][i % D] = to_f32(q[((long long)b * hq + h0) * D + i]);
  __syncthreads();

  const int len = length[b];
  const bool uniform = len <= 0;
  const int n = uniform ? s : min(len, s);

  float m[GB], l[GB], acc[GB][DPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[g][c] = 0.f;
  }

  for (int base = warp * 32; base < n; base += WARPS * 32) {
    const int pos = base + lane;
    const bool ok = pos < n;
    float sc[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) sc[g] = 0.f;
    if (ok && !uniform) {
      const T* kr = kb + (long long)pos * D;
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += E) {
        float kv[E];
        load16(kr + d0, kv);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < ng) {
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(&qs[g][d0 + e]);
              sc[g] = fmaf(qq.x, kv[e], sc[g]);
              sc[g] = fmaf(qq.y, kv[e + 1], sc[g]);
              sc[g] = fmaf(qq.z, kv[e + 2], sc[g]);
              sc[g] = fmaf(qq.w, kv[e + 3], sc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) sc[g] *= scale;
    }

    float p[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      p[g] = 0.f;
      if (g >= ng) continue;
      float mx = ok ? sc[g] : NEG_INF;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      p[g] = ok ? expf(sc[g] - m_new) : 0.f;
      float sum = p[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[g][c] *= alpha;
    }

    const int cnt = min(32, n - base);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const T* vr = vb + (long long)(base + j) * D + c0;
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[c] = c0 + c < D ? to_f32(vr[c]) : 0.f;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < ng) {
          const float pj = __shfl_sync(FULL, p[g], j);
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[g][c] = fmaf(pj, vv[c], acc[g][c]);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g >= ng) continue;
    if (lane == 0) {
      ms[warp][g] = m[g];
      ls[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (c0 + c < D) accs[warp][g][c0 + c] = acc[g][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ms[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(ms[w][g] - mx);
      den += ls[w][g] * f;
      num += accs[w][g][d] * f;
    }
    store(o + ((long long)b * hq + h0) * D + i, num / fmaxf(den, 1e-30f));
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, int b, int hq, int hkv, int s, float scale,
           cudaStream_t stream) {
  const int group = hq / hkv;
  const dim3 grid(hkv, b, (group + GB - 1) / GB);
  decode_kernel<D, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(o), hq, hkv, s,
      scale);
  return (int)cudaGetLastError();
}

// Instances for D = 8, 16, ..., MAX_D: the launch for head dim d.
template <typename T, int D = 8>
int dispatch(const void* q, const void* k, const void* v, const int* length,
             void* o, int b, int hq, int hkv, int s, int d, float scale,
             cudaStream_t stream) {
  if (d == D)
    return launch<D, T>(q, k, v, length, o, b, hq, hkv, s, scale, stream);
  if constexpr (D < MAX_D)
    return dispatch<T, D + 8>(q, k, v, length, o, b, hq, hkv, s, d, scale,
                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Head dims this source is built for, a multiple of 8 up to MAX_D (the
// wrapper raises on any other).
int decode_attention_supports(int d) {
  return d >= 8 && d <= MAX_D && d % 8 == 0;
}

// q, o: (b, hq, d); k, v: (b, hkv, s, d); length: int32 (b,); all
// contiguous and 16-byte aligned, one type: bf16 = 0 for float32, 1 for
// bfloat16.  hq must be a multiple of hkv.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const int* length, void* o, int bf16, int b, int hq,
                         int hkv, int s, int d, float scale, void* stream) {
  if (b <= 0 || hq <= 0) return 0;
  if (s <= 0 || hkv <= 0 || hq % hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, length, o, b, hq, hkv, s, d,
                                        scale, st)
              : dispatch<float>(q, k, v, length, o, b, hq, hkv, s, d, scale,
                                st);
}

}  // extern "C"
