// Single-token GQA attention over a KV cache as split-K flash decoding, for
// sm_90a.
//
// Replaces the Pallas TPU kernel
// kernels/decode_attention/decode_attention.py::decode_attention
// (_decode_kernel): q (B, Hq, D) one token, k and v (B, Hkv, S, D) the
// cache, length (B,) int32; cache positions >= length[b] get the logit
// -1e30, so o = softmax(q k^T * scale) v over the first n = min(length[b],
// S) positions, in q's type.  All arithmetic is float32, as in the Pallas
// kernel.  A row with length <= 0 has every logit at -1e30, so every
// p = exp(0) = 1 and its output is the mean of V over all S positions:
// this kernel gives that row every position with the logit 0.
//
// Bound: bytes.  The K and V rows up to n are read once, and q and o once
// (4·Hkv·n·D bytes in bf16 for a row of the batch); the 4·D float32
// operations per (q head, position) take less time than those bytes at
// every served shape (at Qwen2.5-14B's, 2.5 µs of the 67 TFLOP/s float32
// rate against 5 µs of the 3.35 TB/s memory rate), so they stay on the
// ordinary cores, and every sum is float32.
//
// Split plan.  The TPU grid walks the KV axis in order for each (b, kv
// head) and carries (m, l, acc) in VMEM scratch.  Here the positions are
// cut into `chunks` chunks of `chunk` rows, a multiple of the 32-row tile,
// and one block owns one chunk of one (b, kv head, head tile): grid
// (chunks, Hkv · tiles, B), the group of query heads of a KV head cut into
// tiles = ceil(group / 8) tiles of hpt = ceil(group / tiles) heads.  The
// wrapper's split_plan chooses the chunk from the shapes and the SM count
// alone, never from `length`, which stays on the device: a block whose
// chunk starts at or past n copies nothing and writes an empty partial.
//
// A block.  One warp for each of its query heads.  The block stages the
// chunk's K and V rows through shared memory, one 32-row tile at a time,
// double-buffered: 16-byte cp.async copies by all its threads, coalesced
// over whole rows (a row of D elements is a whole number of 16-byte pieces
// in bf16 and in float32), the next tile in flight while this one is
// computed; rows at or past the chunk's end or n are zero-filled and never
// read.  One barrier a tile.  Rows in shared memory are padded to an odd
// number of 16-byte pieces, so the 8 rows that 8 lanes read in one 16-byte
// load fall in distinct banks.  In each warp, lane i scores row i of the
// tile against its head's q (float32 in shared memory, read as
// broadcasts; each 16-byte piece of the row summed on its own, the pieces
// added as a balanced tree); the warp keeps the online softmax (m, l) of
// its head, reduces the tile's max and sum with shuffles, and accumulates
// P·V from the V rows in shared memory, each lane ceil(D/32) neighbouring
// columns, p by shuffle.  Every K and V row is read from device memory once
// for the whole group of query heads.
//
// Combine.  Each warp writes its head's partial for the chunk (m, l and
// acc of D floats) to a float32 workspace of B·Hq·chunks·(D + 2) floats
// that the wrapper allocates; then the block takes its turn on the counter
// of its (b, kv head, head tile): a barrier, then one thread's
// __threadfence() and atomicAdd (the pattern of a grid-wide barrier).
// The block that finds chunks - 1 there is the last: it resets the
// counter to 0 for the next launch, and each of its warps reads its head's
// partials from L2 (__ldcg) and writes, in q's type,
//   o = Σ_c acc_c·e^(m_c - m) / max(Σ_c l_c·e^(m_c - m), 1e-30),
// m = max_c m_c.  An empty partial has m = -1e30 and l = acc = 0, so it
// adds e^(-1e30 - m)·0 = 0; chunk 0 always holds row 0, so m is never
// -1e30 and no difference of two infinities arises.  The counters (int32,
// one per (b, kv head, head tile)) are allocated zeroed by the wrapper,
// one array per device and stream, and every launch that completes leaves
// them at 0.
//
// Every head dim that is a multiple of 8 up to 128 has an instance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GB = 8;           // query heads a block at most, a warp each
constexpr int TILE = 32;        // cache rows a tile: one a lane
constexpr int STAGES = 2;       // tiles a block has in shared memory
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_D = 128;      // head dims 8, 16, ..., MAX_D are built

// Shared memory of the instance for head dim D and type T: STAGES stages
// of a K tile and a V tile, in rows of LD elements (D padded to an odd
// number of 16-byte pieces), then q as float32, D for each of the block's
// heads.
template <int D, typename T>
struct Smem {
  static constexpr int E = 16 / sizeof(T);       // elements a piece
  static constexpr int PIECES = D / E;           // pieces a row
  static constexpr int LD = (PIECES | 1) * E;
  static constexpr int TILE_ELEMS = TILE * LD;
  static constexpr size_t RING_BYTES = sizeof(T) * STAGES * 2 * TILE_ELEMS;
  static size_t bytes(int heads) {
    return RING_BYTES + sizeof(float) * heads * D;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 16-byte piece of shared memory as float32.
__device__ __forceinline__ void piece(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void piece(const __nv_bfloat16* p, float* out) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// q·k over N pieces of E elements from k's row kr and q's qh (float32 in
// shared memory): each piece summed on its own, a chain of fmaf from 0 in
// the order of its elements, and the pieces added as a balanced tree, the
// first N/2 pieces' sum plus the other's.  The tree keeps a score's error
// near that of one rounding at its size, where the pieces added in order
// gave large scores an error that grew with their count (fault F2).
template <int N, int E, typename T>
__device__ __forceinline__ float score(const T* kr, const float* qh) {
  if constexpr (N == 1) {
    float kv[E];
    piece(kr, kv);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 qq = *reinterpret_cast<const float4*>(qh + e);
      part = fmaf(qq.x, kv[e], part);
      part = fmaf(qq.y, kv[e + 1], part);
      part = fmaf(qq.z, kv[e + 2], part);
      part = fmaf(qq.w, kv[e + 3], part);
    }
    return part;
  } else {
    constexpr int H = N / 2;
    return score<H, E>(kr, qh) + score<N - H, E>(kr + H * E, qh + H * E);
  }
}

// A lane's N neighbouring columns c0 .. c0 + N - 1 of a shared-memory row,
// as float32; columns at or past D read as 0.  Where N elements make 4, 8
// or 16 bytes (N·c0 is then aligned, and c0 < D means every column is
// below D), one load.
template <int N, int D, typename T>
__device__ __forceinline__ void cols(const T* row, int c0, float* out) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES == 4 || BYTES == 8 || BYTES == 16) {
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] = 0.f;
    if (c0 >= D) return;
    if constexpr (sizeof(T) == 4) {
      if constexpr (N == 1) {
        out[0] = row[c0];
      } else if constexpr (N == 2) {
        const float2 t = *reinterpret_cast<const float2*>(row + c0);
        out[0] = t.x; out[1] = t.y;
      } else {
        piece(row + c0, out);
      }
    } else {
      if constexpr (N == 2) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + c0));
        out[0] = f.x; out[1] = f.y;
      } else if constexpr (N == 4) {
        const uint2 t = *reinterpret_cast<const uint2*>(row + c0);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
        const float2 f0 = __bfloat1622float2(h[0]);
        const float2 f1 = __bfloat1622float2(h[1]);
        out[0] = f0.x; out[1] = f0.y; out[2] = f1.x; out[3] = f1.y;
      } else {
        piece(row + c0, out);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c)
      out[c] = c0 + c < D ? to_f32(row[c0 + c]) : 0.f;
  }
}

// The K and V rows r0 .. r0 + TILE - 1 of one sequence (rows of D
// elements) into one stage, 16 bytes a thread at a time over whole rows,
// as one group of copies; rows at or past hi are zero-filled and not read,
// and a tile that starts at or past hi copies nothing.
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* stage, const T* kseq,
                                          const T* vseq, int r0, int hi) {
  using L = Smem<D, T>;
  const int first = r0 < hi ? (int)threadIdx.x : TILE * L::PIECES;
  for (int i = first; i < TILE * L::PIECES; i += blockDim.x) {
    const int r = i / L::PIECES, c = (i % L::PIECES) * L::E;
    const bool in = r0 + r < hi;
    const long long at = (long long)(in ? r0 + r : 0) * D + c;
    cp_async16(smem_addr(stage + r * L::LD + c), kseq + at, in);
    cp_async16(smem_addr(stage + L::TILE_ELEMS + r * L::LD + c), vseq + at,
               in);
  }
  cp_async_commit();
}

template <int D, typename T>
__global__ void __launch_bounds__(32 * GB)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length,
              T* __restrict__ o, float* __restrict__ work,
              int* __restrict__ counters, int hq, int hkv, int s, int chunk,
              int hpt, float scale) {
  using L = Smem<D, T>;
  constexpr int DPL = (D + 31) / 32;            // P·V columns a lane
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);         // stage i at 2·i tiles
  float* qs = reinterpret_cast<float*>(smem + L::RING_BYTES);
  __shared__ int last;

  const int chunks = gridDim.x, c = blockIdx.x, b = blockIdx.z;
  const int group = hq / hkv;
  const int tiles = (group + hpt - 1) / hpt;    // head tiles a KV head
  const int hk = blockIdx.y / tiles, ht = blockIdx.y % tiles;
  const int h0 = hk * group + ht * hpt;         // first query head here
  const int ng = min(hpt, group - ht * hpt);
  const long long seq = (long long)s * D;
  const T* kb = k + ((long long)b * hkv + hk) * seq;
  const T* vb = v + ((long long)b * hkv + hk) * seq;
  const long long head0 = (long long)b * hq + h0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool active = warp < ng;                // owns query head h0 + warp
  const int c0 = lane * DPL;                    // this lane's first column
  const float* qh = qs + warp * D;

  const int len = length[b];
  const bool uniform = len <= 0;
  const int n = uniform ? s : min(len, s);
  const int lo = c * chunk, hi = min(lo + chunk, n);

  // The first STAGES - 1 tiles in flight, then q.
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    load_tile<D>(ring + i * 2 * L::TILE_ELEMS, kb, vb, lo + i * TILE, hi);
  if (lo < hi)
    for (int i = threadIdx.x; i < ng * D; i += blockDim.x)
      qs[i] = to_f32(q[head0 * D + i]);

  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int r0 = lo, st = 0; r0 < hi; r0 += TILE, st = (st + 1) % STAGES) {
    cp_async_wait<STAGES - 2>();                // this tile has landed
    __syncthreads();                            // ... and the last one is done
    load_tile<D>(ring + (st + STAGES - 1) % STAGES * 2 * L::TILE_ELEMS, kb,
                 vb, r0 + (STAGES - 1) * TILE, hi);
    if (!active) continue;
    const T* kt = ring + st * 2 * L::TILE_ELEMS;
    const T* vt = kt + L::TILE_ELEMS;

    // Lane i scores row r0 + i.
    const bool ok = r0 + lane < hi;
    const float sc =
        uniform ? 0.f : score<L::PIECES, L::E>(kt + lane * L::LD, qh) * scale;

    float mx = ok ? sc : NEG_INF;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(sc - m_new) : 0.f;
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;

    // Rows past hi are zero in shared memory and have p = 0.
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      float vv[DPL];
      cols<DPL, D>(vt + r * L::LD, c0, vv);
      const float pr = __shfl_sync(FULL, p, r);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] = fmaf(pr, vv[j], acc[j]);
    }
  }

  // This chunk's partial for each of the block's heads.
  const long long slots = (long long)gridDim.z * hq * chunks;
  float* wacc = work;                           // (B, Hq, chunks, D)
  float* wml = work + slots * D;                // (B, Hq, chunks, 2)
  if (active) {
    const long long slot = (head0 + warp) * chunks + c;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (c0 + j < D) wacc[slot * D + c0 + j] = acc[j];
    if (lane == 0) {
      wml[2 * slot] = m;
      wml[2 * slot + 1] = l;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();                            // the partials before the count
    int* count = counters + blockIdx.z * gridDim.y + blockIdx.y;
    last = atomicAdd(count, 1) == chunks - 1;
    if (last) *count = 0;
  }
  __syncthreads();
  if (!last || !active) return;
  __threadfence();

  // The last block of its (b, kv head, head tile): each warp combines the
  // chunks of its head.  Lane j reads the (m, l) of chunks j, j + 32, ...
  // (an absent chunk reads as the empty partial); the acc rows are read 8
  // chunks at a time.
  const long long s0 = (head0 + warp) * chunks;
  const float2* ml2 = reinterpret_cast<const float2*>(wml) + s0;
  const float2 none = make_float2(NEG_INF, 0.f);
  const float2 ml0 = lane < chunks ? __ldcg(ml2 + lane) : none;
  float mc = ml0.x;
  for (int j = lane + 32; j < chunks; j += 32)
    mc = fmaxf(mc, __ldcg(ml2 + j).x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off));
  float den = 0.f, num[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) num[j] = 0.f;
  for (int j0 = 0; j0 < chunks; j0 += 32) {
    const float2 ml =
        j0 == 0 ? ml0 : (j0 + lane < chunks ? __ldcg(ml2 + j0 + lane) : none);
    const float f = expf(ml.x - mc);
    den = fmaf(ml.y, f, den);
    const int cnt = min(32, chunks - j0);
#pragma unroll 8
    for (int jj = 0; jj < cnt; ++jj) {
      const float fj = __shfl_sync(FULL, f, jj);
      const float* a = wacc + (s0 + j0 + jj) * D + c0;
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        if (c0 + j < D) num[j] = fmaf(fj, __ldcg(a + j), num[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(FULL, den, off);
  T* orow = o + (head0 + warp) * D;
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    if (c0 + j < D) store(orow + c0 + j, num[j] / fmaxf(den, 1e-30f));
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, float* work, int* counters, int b, int hq, int hkv,
           int s, int chunk, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const int tiles = (group + GB - 1) / GB;
  const int hpt = (group + tiles - 1) / tiles;  // heads a block, <= GB
  if ((long long)hkv * tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((s + chunk - 1) / chunk, hkv * tiles, b);
  auto kernel = decode_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<D, T>::bytes(GB));
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 32 * hpt, Smem<D, T>::bytes(hpt), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(o), work, counters,
      hq, hkv, s, chunk, hpt, scale);
  return (int)cudaGetLastError();
}

// Instances for D = 8, 16, ..., MAX_D: the launch for head dim d.
template <typename T, int D = 8>
int dispatch(const void* q, const void* k, const void* v, const int* length,
             void* o, float* work, int* counters, int b, int hq, int hkv,
             int s, int d, int chunk, float scale, cudaStream_t stream) {
  if (d == D)
    return launch<D, T>(q, k, v, length, o, work, counters, b, hq, hkv, s,
                        chunk, scale, stream);
  if constexpr (D < MAX_D)
    return dispatch<T, D + 8>(q, k, v, length, o, work, counters, b, hq, hkv,
                              s, d, chunk, scale, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D = 8>
int smem_of(int d, int bf16, int heads) {
  if (d == D)
    return (int)(bf16 ? Smem<D, __nv_bfloat16>::bytes(heads)
                      : Smem<D, float>::bytes(heads));
  if constexpr (D < MAX_D) return smem_of<D + 8>(d, bf16, heads);
  return 0;
}

}  // namespace

extern "C" {

// Head dims this source is built for, a multiple of 8 up to MAX_D (the
// wrapper raises on any other).
int decode_attention_supports(int d) {
  return d >= 8 && d <= MAX_D && d % 8 == 0;
}

// Dynamic shared memory a block of `heads` query heads takes in the
// instance for head dim d (bf16 = 1 for bfloat16, 0 for float32); 0 if not
// built.
int decode_attention_smem_bytes(int d, int bf16, int heads) {
  return smem_of(d, bf16, heads);
}

// q, o: (b, hq, d); k, v: (b, hkv, s, d); length: int32 (b,); all
// contiguous and 16-byte aligned, one type: bf16 = 0 for float32, 1 for
// bfloat16.  hq must be a multiple of hkv.  chunk: cache rows a block, a
// positive multiple of 32 (the wrapper's split_plan); work: float32,
// b·hq·ceil(s / chunk)·(d + 2) of them; counters: int32, at least
// b·hkv·ceil(hq / hkv / 8) of them, all 0, and left at 0.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const int* length, void* o, int bf16, int b, int hq,
                         int hkv, int s, int d, float scale, void* stream,
                         float* work, int* counters, int chunk) {
  if (b <= 0 || hq <= 0) return 0;
  if (s <= 0 || hkv <= 0 || hq % hkv != 0 || chunk <= 0 || chunk % TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, length, o, work, counters,
                                        b, hq, hkv, s, d, chunk, scale, st)
              : dispatch<float>(q, k, v, length, o, work, counters, b, hq,
                                hkv, s, d, chunk, scale, st);
}

}  // extern "C"
