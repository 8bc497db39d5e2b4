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
// Rounding.  Every operation is the one of the plain version
// (kernels/rwkv6/ref.py) in its order: k_i·v_j, u_i·kv, S_ij + ukv, times
// r_i, w_i·S_ij + kv, each rounded on its own (the _rn intrinsics keep the
// compiler from fusing them), and the sum over i as the same halving tree.
// So the kernel and the plain version agree bit for bit.  That costs 7
// float32 instructions per (t, i, j), each of them issued on its own (the
// H100 has no paired float32 instruction), against the least 5: at the
// card's float32 rate that is the floor of this design.
//
// Design.  The TPU keeps S in VMEM scratch while time chunks stream through
// the in-order grid.  Here S lives in registers and each block runs the
// whole time loop for one batch·head and a slab of JB of its D columns (the
// columns of S are independent; more, smaller blocks spread evenly over the
// SMs).  The block's threads form R = D / M residue groups of L = JB / C
// lanes: group ri holds rows i = ri, ri + R, ri + 2R, ... (M of them), and
// its lane l columns l·C .. l·C + C - 1 of the slab.  A step's r, k and w
// are staged in shared memory as float32, permuted so that a residue's M
// rows are contiguous: each step a group reads its rows as float4, every
// lane of it the same address (a broadcast), 3·M/4 loads serving M·C
// elements.  The chunk of CHUNK steps after this one is copied raw
// (16-byte cp.async, coalesced) while this one is computed, and converted
// when its turn comes: the copies never wait on the memory, which the
// blocks, all alike, would otherwise wait on together.  A whole chunk's
// steps are unrolled into one straight run, which the compiler schedules
// across steps.  The sum over i is ref.halving_sum's tree: its level h
// pairs row i with row i + h, so the levels h >= R fall inside a thread
// (the first, h = D/2, folded in while the rows are computed); each thread
// writes the node it ends with for every step and column to shared memory,
// and after the chunk the last log2(R) levels, across the residue groups,
// are taken there, four outputs a thread read as float4, which then go out
// coalesced.  No shuffles.  Every tree is unrolled by template recursion:
// a tree loop the compiler leaves rolled puts its nodes in local memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The tiling of each head dim: M rows and C columns of S a thread holds,
// JB columns a block owns, CHUNK time steps staged (and unrolled) at once.
template <int D> struct Tile;
template <> struct Tile<16> {
  static constexpr int M = 4, C = 1, JB = 16, CHUNK = 32;
};
template <> struct Tile<64> {
  static constexpr int M = 8, C = 2, JB = 32, CHUNK = 8;
};

template <int D, typename T>
struct Shape {
  static constexpr int M = Tile<D>::M, C = Tile<D>::C;
  static constexpr int JB = Tile<D>::JB, CHUNK = Tile<D>::CHUNK;
  static constexpr int R = D / M;               // row residues
  static constexpr int L = JB / C;              // lanes a residue
  static constexpr int THREADS = R * L;
  static constexpr int SLABS = D / JB;          // blocks a batch·head
  static constexpr int VEC = 16 / sizeof(T);    // elements a 16-byte load
  static constexpr int RV = D / VEC, VPS = 3 * RV + JB / VEC;
  static constexpr int VP = VPS <= 8 ? 8 : VPS <= 16 ? 16 : VPS <= 32 ? 32
                                                      : 64;  // slots a step
  static constexpr int SPT = THREADS / VP;      // steps a pass of the block
  static constexpr int NLOAD = CHUNK / SPT;     // loads a thread a chunk
  // r, k, w and v a chunk, and a residue's nodes a chunk, in floats, each
  // padded by 8 so that neighbouring ones start in other banks
  static constexpr int AS = CHUNK * D + 8, NS = CHUNK * JB + 8;
  static constexpr int SMEM = 16 * CHUNK * VP + 4 * (3 * AS + CHUNK * JB) +
                              4 * R * NS;
  static_assert(M % 4 == 0 && D % M == 0 && (R & (R - 1)) == 0 && R <= 32,
                "M: a multiple of 4 dividing D, D / M a power of 2 <= 32");
  static_assert(C == 1 || C == 2 || C == 4, "C: 1, 2 or 4");
  static_assert(D % JB == 0 && JB % C == 0 && JB % VEC == 0,
                "JB: divides D, whole columns a lane, whole 16-byte loads");
  static_assert((32 % L == 0 || L % 32 == 0) && THREADS % 32 == 0,
                "a residue's lanes: a part of a warp or whole warps");
  static_assert(VPS <= VP && THREADS % VP == 0 && CHUNK % SPT == 0,
                "staging: whole passes of the block");
  static_assert(SMEM <= 48 * 1024, "static shared memory");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive outputs.
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const uint32_t*>(&lo),
      *reinterpret_cast<const uint32_t*>(&hi));
}

// The elements of a 16-byte load as float32 (bf16 widens exactly).
__device__ __forceinline__ void unpack(uint4 x, const float*, float (&f)[4]) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(uint4 x, const __nv_bfloat16*,
                                       float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// 16 bytes from global to shared memory, asynchronously.  The "memory"
// clobbers keep these in program order with the loads and stores around
// them: a thread reads its raw slots before it copies the next chunk over
// them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// C consecutive floats of shared memory, as one load.
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[C]) {
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = p[0];
  }
}

// Levels h = H, H/2, ..., 1 of the halving tree over a thread's partial
// sums: p[m] += p[m + h] for m < h, each column on its own.
template <int H, int N, int C>
__device__ __forceinline__ void local_tree(float (&p)[N][C]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int m = 0; m < H; ++m)
#pragma unroll
      for (int c = 0; c < C; ++c) p[m][c] = __fadd_rn(p[m][c], p[m + H][c]);
    local_tree<H / 2>(p);
  }
}

// One time step of a thread's M rows × C columns of S: rt, rt + as and
// rt + 2·as hold r, k and w of its rows as float32, vt v of its columns.
// Writes the thread's node of the halving tree for each column to nd.
template <int M, int C>
__device__ __forceinline__ void step(const float* rt, int as, const float* vt,
                                     const float (&uu)[M], float (&s)[M][C],
                                     float* nd) {
  const float* kt = rt + as;
  const float* wt = kt + as;
  float vj[C];
  load_cols<C>(vt, vj);
  // p[m] holds row ri + R·m's term; rows m >= M/2 are added to row
  // m - M/2's as they come: the tree's first level, h = D/2.
  float p[M / 2][C];
#pragma unroll
  for (int q = 0; q < M / 4; ++q) {
    const float4 r4 = *reinterpret_cast<const float4*>(rt + 4 * q);
    const float4 k4 = *reinterpret_cast<const float4*>(kt + 4 * q);
    const float4 w4 = *reinterpret_cast<const float4*>(wt + 4 * q);
    const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
    const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
    const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 4 * q + e;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float kv = __fmul_rn(kk[e], vj[c]);
        const float x =
            __fmul_rn(__fadd_rn(s[m][c], __fmul_rn(uu[m], kv)), rr[e]);
        s[m][c] = __fadd_rn(__fmul_rn(ww[e], s[m][c]), kv);
        if (m < M / 2)
          p[m][c] = x;
        else
          p[m - M / 2][c] = __fadd_rn(p[m - M / 2][c], x);
      }
    }
  }
  // Levels D/4 .. R inside the thread: node ri of the tree.
  local_tree<M / 4>(p);
#pragma unroll
  for (int c = 0; c < C; ++c) nd[c] = p[0][c];
}

template <int D, typename T>
__global__ void __launch_bounds__(Shape<D, T>::THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, T* __restrict__ out,
            float* __restrict__ state, int t_len) {
  using S = Shape<D, T>;
  constexpr int M = S::M, C = S::C, JB = S::JB, CHUNK = S::CHUNK, R = S::R;
  constexpr int VEC = S::VEC, RV = S::RV, VP = S::VP, SPT = S::SPT;
  constexpr int NLOAD = S::NLOAD, THREADS = S::THREADS;
  // raw: the chunk's 16-byte slots as copied, [step][slot]; stage: r, k,
  // w as float32, [array][step][residue][row of the residue], then v,
  // [step][column of the slab]; the warps' tree nodes: [residue][step]
  // [column]
  constexpr int AS = S::AS, NS = S::NS;
  __shared__ __align__(16) uint4 raw[CHUNK * VP];
  __shared__ __align__(16) float stage[3 * AS + CHUNK * JB];
  __shared__ __align__(16) float node[R * NS];
  float* vs = stage + 3 * AS;

  const int bh = blockIdx.x / S::SLABS, j0 = (blockIdx.x % S::SLABS) * JB;
  const int ri = threadIdx.x / S::L, lane = threadIdx.x % S::L;
  const long long base = (long long)bh * t_len * D;
  float s[M][C], uu[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uu[m] = to_f32(u[(long long)bh * D + ri + R * m]);
#pragma unroll
    for (int c = 0; c < C; ++c) s[m][c] = 0.f;
  }

  // Staging.  A step is VP 16-byte slots: 3·RV of r, k and w, then v's
  // slab, then idle ones.  Thread x copies slot x % VP of the steps
  // x / VP + SPT·q of each chunk into raw by cp.async, the next chunk's
  // while this one is computed, and then converts the same slots into
  // stage: its source row, its places and its permutation stay the same
  // from chunk to chunk, and raw needs no barrier.
  const int slot = threadIdx.x % VP, tt0 = threadIdx.x / VP;
  const bool loads = slot < S::VPS, is_v = slot >= 3 * RV;
  const int a = slot / RV, e0 = is_v ? (slot - 3 * RV) * VEC
                                     : (slot % RV) * VEC;
  const T* src = (is_v ? v + j0 : a == 0 ? r : a == 1 ? k : w) + base + e0;
  float* dst = is_v ? vs + e0 : stage + a * AS;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < NLOAD; ++q) {
      const int tt = tt0 + q * SPT;
      if (loads && t0 + tt < t_len)
        cp_async16(raw + tt * VP + slot, src + (long long)(t0 + tt) * D);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch(0);

  for (int t0 = 0; t0 < t_len; t0 += CHUNK) {
    const int n = min(CHUNK, t_len - t0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < NLOAD; ++q) {
      const int tt = tt0 + q * SPT;
      if (!loads || tt >= n) continue;
      float f[VEC];
      unpack(raw[tt * VP + slot], src, f);
      if (is_v) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[tt * JB + e] = f[e];
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dst[tt * D + ((e0 + e) % R) * M + (e0 + e) / R] = f[e];
      }
    }
    if (t0 + CHUNK < t_len) fetch(t0 + CHUNK);
    __syncthreads();
    // A whole chunk's steps unrolled, a last short one's one at a time.
    if (n == CHUNK) {
#pragma unroll
      for (int tt = 0; tt < CHUNK; ++tt)
        step<M, C>(stage + tt * D + ri * M, AS, vs + tt * JB + lane * C,
                      uu, s, node + ri * NS + tt * JB + lane * C);
    } else {
#pragma unroll 1
      for (int tt = 0; tt < n; ++tt)
        step<M, C>(stage + tt * D + ri * M, AS, vs + tt * JB + lane * C,
                      uu, s, node + ri * NS + tt * JB + lane * C);
    }
    __syncthreads();
    // Levels R/2 .. 1 across the residue groups, 4 columns a thread: node
    // i adds node i + h, i < h.
    for (int x = 4 * threadIdx.x; x < n * JB; x += 4 * THREADS) {
      float nd[R][4];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float4 z = *reinterpret_cast<const float4*>(node + q * NS + x);
        nd[q][0] = z.x; nd[q][1] = z.y; nd[q][2] = z.z; nd[q][3] = z.w;
      }
      local_tree<R / 2>(nd);
      store4(out + base + (long long)(t0 + x / JB) * D + j0 + x % JB, nd[0]);
    }
  }

  {
    float* sb = state + (long long)bh * D * D + j0 + lane * C;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < C; ++c) sb[(ri + R * m) * D + c] = s[m][c];
  }
}

template <int D, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* out, float* state, int bh, int t,
           cudaStream_t stream) {
  using S = Shape<D, T>;
  wkv6_kernel<D, T><<<bh * S::SLABS, S::THREADS, 0, stream>>>(
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

// r, k, v, w, out: (bh, t, d); u: (bh, d); all contiguous and 16-byte
// aligned, one type: bf16 = 0 for float32, 1 for bfloat16.  state: (bh, d,
// d) float32, written whole.
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
