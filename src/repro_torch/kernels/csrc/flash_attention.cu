// Causal or full GQA attention forward with an online softmax, for sm_90a.
//
// Replaces the Pallas TPU kernel
// kernels/flash_attention/flash_attention.py::flash_attention (_fa_kernel):
// q (B, Hq, S, D), k and v (B, Hkv, S_kv, D), kv head = q head / (Hq / Hkv);
// o = softmax(q k^T * scale, causal mask) v, in q's type.  S_kv = S under
// the causal mask; without it the keys have a length of their own, as the
// decoder's queries over the encoder's frames in cross-attention.
//
// Bound: the larger of the bytes (q, k, v and o, each once) over the memory
// rate and the 2·S²·D operations per (b, q head), causal half skipped, over
// the bf16 tensor-core rate (2·S·S_kv·D without the mask).  In bf16 that is S/4 operations per byte per
// head: at S = 1024 the two times are within 15 % of each other, so the
// products have to run on the tensor cores to come near either.
//
// Two instances, by type:
// - bfloat16, the type every model is served in: flash_kernel_tc, both
//   products on the tensor cores (below).
// - float32, which only the parity runs and tests use: flash_kernel_f32,
//   every product, exponential and sum in float32 on the SIMT cores, as the
//   Pallas kernel casts its tiles to f32 before the dots.  It stays within
//   1e-4 · max(1, max|o|) of the plain version, which a bf16 split of
//   float32 inputs could not promise.
//
// The bf16 instance.  One block of 4 warps owns one (b, q head, 64-row
// query tile); each warp owns 16 query rows and loops over the 64-key
// tiles with its rows' softmax statistics in registers.  Both products are
// mma.sync.aligned.m16n8k16 on bf16 with float32 accumulators: S = Q·Kᵀ
// with Q's fragments loaded once (ldmatrix) and kept in registers and K's
// by ldmatrix; O += P·V with V's fragments by ldmatrix.trans.  K and V
// tiles stay bf16 in shared memory, double-buffered: cp.async (16-byte
// chunks; a row of D bf16 is a multiple of 16 bytes) brings tile j + 1
// while tile j is computed, and fills rows past S with zeros.  Rows are
// padded by 8 elements to an odd number of 16-byte chunks, so the 8 rows
// that one ldmatrix reads fall in 8 distinct groups of banks.  The depth of
// Q·Kᵀ is D rounded up to a multiple of 16 (24 -> 32, 40 -> 48, ...): the
// padding columns of Q and K are zeroed in shared memory, never read from
// device memory.  P·V's n-dimension is D itself, in steps of 8; columns
// past D are never stored.
//
// Online softmax: the float32 scores are multiplied by scale·log2(e) before
// the max, and p = 2^(s - m) by ex2.approx.ftz (relative error about
// 2^-22; a p below 2^-126 is flushed to 0 and adds nothing to a sum that
// holds a 1).  A row's max is reduced over the 4 threads
// of its quad with shuffles; each thread keeps its share of the row's sum,
// reduced once at the end, and o = acc / max(l, 1e-30).  Query and key
// tiles are aligned, so under the causal mask only a row block's last key
// tile crosses the diagonal; the masks (causal, keys past S: probability
// 0) are applied on the last tile only.  Tiles above the diagonal are
// skipped: every row has seen key 0 in the first tile, so a skipped tile
// would add exp(-inf) = 0.  Rows past S are not written.  Late query tiles,
// which have the most key tiles under the causal mask, are launched first.
//
// Scores.  Each product of bf16 q and k is exact in float32, but the tensor
// cores' float32 accumulation truncates its additions, aligned to the
// largest addend, so an accumulator carried across k-steps would give a
// score an error that grows with the running sum.  Each k-step of 16
// products goes into a fresh accumulator instead, and the partial sums are
// added on the ordinary cores, rounded to nearest: a score's error then
// follows the size of one k-step's products.  At scores of a few hundred
// (q scaled by 50) that keeps near-zero outputs within the 1e-5 floor of
// the tolerance below, where one carried accumulator did not.
//
// Why P enters as two bf16 halves.  P is float32.  Fed to the tensor cores
// as one bf16 value, p would carry a relative error of up to 2^-8 (bf16
// keeps 8 significant bits), and an output that cancels to
// near zero would be off by up to 2^-8 · Σ p|v|: far past the
// 2^-6·|o| + 1e-5 that each bf16 output is held to against the plain
// version (on random inputs at S = 256 about one output in twenty falls
// outside).  So p_hi = bf16(p), p_lo = bf16(p - p_hi) (the difference is
// exact in float32), and O += P_hi·V + P_lo·V, both on the tensor cores into
// one float32 accumulator: p keeps about 16 bits, a relative error of at
// most 2^-16, so the output's error from P is at most 2^-16 · Σ p|v|
// <= 1.5e-5 · max|v|, and near 2^-16 · (Σ p²v²)^½, below 1e-6 at S = 1024,
// since the roundings of different p fall either way.  The cost is one
// more m16n8k16 for each one of P·V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_D = 128;      // head dims 8, 16, ..., MAX_D are built

// ---- float32: the SIMT kernel ----------------------------------------------
//
// 256 threads form a 16 x 16 grid: each thread owns 4 query rows (ty) and,
// for the scores, 4 keys (tx); for the output, ceil(D/16) neighbouring
// columns, the last threads' columns past D left idle when 16 does not
// divide D (D = 24: 2 columns each for tx < 12).  A row's max and sum are
// reduced over the 16 tx threads of its half-warp with shuffles.  Q and K
// tiles sit in shared memory transposed, so a thread's 4 rows and 4 keys at
// one depth are one 16-byte load each; the probabilities go through shared
// memory, transposed, to the P·V product.  Any S and S_kv are taken: keys
// past S_kv in the last tile get probability 0.  Loads and stores are one element each.

constexpr int BQ = 64;          // query rows per block (both instances)
constexpr int BK = 64;          // keys per tile (both instances)
constexpr int THREADS = 256;    // 16 x 16
constexpr int PAD = 4;          // row padding that keeps float4 alignment

template <int D>
constexpr size_t smem_f32() {
  return sizeof(float) * ((size_t)D * (BQ + PAD) + (size_t)D * (BK + PAD) +
                          (size_t)BK * (D + PAD) + (size_t)BK * (BQ + PAD));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int hkv, int s, int s_kv, float scale, int causal) {
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
  const long long seq = (long long)s * D, kseq = (long long)s_kv * D;
  const float* qb = q + ((long long)b * hq + h) * seq;
  const float* kb = k + ((long long)b * hkv + hk) * kseq;
  const float* vb = v + ((long long)b * hkv + hk) * kseq;
  float* ob = o + ((long long)b * hq + h) * seq;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int c0 = tx * CPT;                    // this thread's first column

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qt[c * LQ + r] = q0 + r < s ? qb[(long long)(q0 + r) * D + c] : 0.f;
  }
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(s, q0 + BQ) : s_kv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();        // the last tile's reads of kt, vt and pt are done
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < s_kv;
      const long long off = (long long)(k0 + r) * D + c;
      kt[c * LK + r] = in ? kb[off] : 0.f;
      vt[r * LV + c] = in ? vb[off] : 0.f;
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
        ok[j] = kpos < s_kv && (!causal || kpos <= qpos);
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
      if (c0 + c < D) ob[(long long)row * D + c0 + c] = acc[i][c] / den;
  }
}

// ---- bfloat16: the tensor-core kernel --------------------------------------

constexpr int TC_WARPS = 4;                   // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int NT_S = BK / 8;                  // n-tiles of 8 keys in Q·Kᵀ
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;   // depth of Q·Kᵀ
  static constexpr int LD = DP + 8;               // row stride, elements
  static constexpr int KSTEPS = DP / 16;
  static constexpr int NT_O = D / 8;              // n-tiles of P·V
  static constexpr int CHUNKS = D / 8;            // 16-byte chunks a row
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * LD * (BQ + 4 * BK);
};

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, results below 2^-126 flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// p (two neighbouring columns) as bf16 halves: hi = bf16(p), lo = bf16(p-hi)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// Copy rows r0 .. r0 + rows - 1 of a sequence `seq` of s rows of D bf16
// into shared memory rows of stride LD; rows at or past s are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* seq, int r0,
                                          int rows, int s) {
  using T = Tile<D>;
  for (int i = threadIdx.x; i < rows * T::CHUNKS; i += TC_THREADS) {
    const int r = i / T::CHUNKS, c = (i % T::CHUNKS) * 8;
    const bool in = r0 + r < s;
    const __nv_bfloat16* g = seq + (long long)(in ? r0 + r : 0) * D + c;
    cp_async16(smem_addr(dst + r * T::LD + c), g, in);
  }
}

// One key tile for one warp: scores, online softmax, P·V.  MASK applies the
// causal mask and the mask of keys past S_kv (a row block's last tile only).
template <int D, bool MASK>
__device__ __forceinline__ void tc_tile(
    const uint32_t (&qf)[Tile<D>::KSTEPS][4], const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, float (&acc)[Tile<D>::NT_O][4], float (&m)[2],
    float (&l)[2], int k0, int row0, int s_kv, int causal, float sl2) {
  using T = Tile<D>;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // S = Q·Kᵀ: 16 rows x 64 keys, 8 n-tiles of 8 keys.  One ldmatrix.x4
  // brings the B fragments of two n-tiles at one k-step.  The first
  // k-step writes the scores; each later one sums into a fresh
  // accumulator, added to the scores in round-to-nearest.
  float sc[NT_S][4];
#pragma unroll
  for (int n = 0; n < NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk) {
    float part[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    float (&c)[NT_S][4] = kk == 0 ? sc : part;
#pragma unroll
    for (int np = 0; np < NT_S / 2; ++np) {
      const int key = np * 16 + (lane % 8) + (lane / 16) * 8;
      const int col = kk * 16 + ((lane / 8) % 2) * 8;
      uint32_t b[4];
      ldmatrix_x4(b, smem_addr(ks + key * T::LD + col));
      mma_bf16(c[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(c[2 * np + 1], qf[kk], b[2], b[3]);
    }
    if (kk > 0) {
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += part[n][e];
    }
  }

  // Online softmax over this thread's two rows (g and g + 8), 16 keys each.
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[n][e] * sl2;
      if constexpr (MASK) {
        const int key = k0 + n * 8 + 2 * t + (e % 2);
        const int row = row0 + g + (e / 2) * 8;
        if (key >= s_kv || (causal && key > row)) x = NEG_INF;
      }
      sc[n][e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT_S; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(sc[n][e] - m[e / 2]);
      if constexpr (MASK) p = sc[n][e] == NEG_INF ? 0.f : p;
      sc[n][e] = p;
      sum[e / 2] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int n = 0; n < T::NT_O; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }

  // O += P_hi·V + P_lo·V.  The accumulators of n-tiles 2j and 2j + 1 are,
  // element for element, the A fragment of k-step j (keys 16j..16j+15).
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    uint32_t hi[4], lo[4];
    split_bf16(sc[2 * j][0], sc[2 * j][1], hi[0], lo[0]);
    split_bf16(sc[2 * j][2], sc[2 * j][3], hi[1], lo[1]);
    split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], hi[2], lo[2]);
    split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], hi[3], lo[3]);
    const int key = j * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int np = 0; np < T::NT_O / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_addr(vs + key * T::LD + np * 16 +
                                     (lane / 16) * 8));
      mma_bf16(acc[2 * np], hi, b[0], b[1]);
      mma_bf16(acc[2 * np], lo, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
    }
    if constexpr (T::NT_O % 2 == 1) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, smem_addr(vs + key * T::LD + (T::NT_O - 1) * 8));
      mma_bf16(acc[T::NT_O - 1], hi, b[0], b[1]);
      mma_bf16(acc[T::NT_O - 1], lo, b[0], b[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_kernel_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int hq, int hkv, int s,
                int s_kv, float scale, int causal) {
  using T = Tile<D>;
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  __nv_bfloat16* qs = tc_smem;                      // [BQ][LD]
  __nv_bfloat16* ks = qs + BQ * T::LD;              // [2][BK][LD]
  __nv_bfloat16* vs = ks + 2 * BK * T::LD;          // [2][BK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long seq = (long long)s * D, kseq = (long long)s_kv * D;
  const __nv_bfloat16* qb = q + ((long long)b * hq + h) * seq;
  const __nv_bfloat16* kb = k + ((long long)b * hkv + hk) * kseq;
  const __nv_bfloat16* vb = v + ((long long)b * hkv + hk) * kseq;
  __nv_bfloat16* ob = o + ((long long)b * hq + h) * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * 16;

  // The depth padding of Q and of both K buffers is zero; cp.async never
  // writes those columns.
  if constexpr (T::DP > D) {
    constexpr int PADC = T::DP - D;
    for (int i = threadIdx.x; i < (BQ + 2 * BK) * PADC; i += TC_THREADS)
      qs[(i / PADC) * T::LD + D + i % PADC] = __float2bfloat16(0.f);
  }

  const int kv_end = causal ? min(s, q0 + BQ) : s_kv;
  const int tiles = (kv_end + BK - 1) / BK;
  load_tile<D>(qs, qb, q0, BQ, s);
  cp_async_commit();
  load_tile<D>(ks, kb, 0, BK, s_kv);
  load_tile<D>(vs, vb, 0, BK, s_kv);
  cp_async_commit();
  cp_async_wait<1>();             // Q is in shared memory
  __syncthreads();
  uint32_t qf[T::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < T::KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + lane % 16) * T::LD +
                                  kk * 16 + (lane / 16) * 8));

  float acc[T::NT_O][4];
#pragma unroll
  for (int n = 0; n < T::NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * LOG2E;
  const bool mask_last = causal || kv_end % BK != 0;

  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      const int nb = (j + 1) % 2, k1 = (j + 1) * BK;
      load_tile<D>(ks + nb * BK * T::LD, kb, k1, BK, s_kv);
      load_tile<D>(vs + nb * BK * T::LD, vb, k1, BK, s_kv);
    }
    cp_async_commit();
    cp_async_wait<1>();           // tile j is in shared memory
    __syncthreads();
    const __nv_bfloat16* kt = ks + (j % 2) * BK * T::LD;
    const __nv_bfloat16* vt = vs + (j % 2) * BK * T::LD;
    if (j == tiles - 1 && mask_last)
      tc_tile<D, true>(qf, kt, vt, acc, m, l, j * BK, row0, s_kv, causal,
                       sl2);
    else
      tc_tile<D, false>(qf, kt, vt, acc, m, l, j * BK, row0, s_kv, causal,
                        sl2);
    __syncthreads();              // buffer j % 2 is free for tile j + 2
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const int row = row0 + g + r * 8;
    if (row >= s) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + (long long)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < T::NT_O; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

// ---- launch and dispatch ---------------------------------------------------

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s, int s_kv, float scale, int causal,
           cudaStream_t stream) {
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = Tile<D>::SMEM;
    auto kernel = flash_kernel_tc<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        hq, hkv, s, s_kv, scale, causal);
  } else {
    constexpr size_t smem = smem_f32<D>();
    auto kernel = flash_kernel_f32<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, s,
        s_kv, scale, causal);
  }
  return (int)cudaGetLastError();
}

// Instances for D = 8, 16, ..., MAX_D: the launch for head dim d.
template <typename T, int D = 8>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hkv, int s, int s_kv, int d, float scale, int causal,
             cudaStream_t stream) {
  if (d == D)
    return launch<D, T>(q, k, v, o, b, hq, hkv, s, s_kv, scale, causal,
                        stream);
  if constexpr (D < MAX_D)
    return dispatch<T, D + 8>(q, k, v, o, b, hq, hkv, s, s_kv, d, scale,
                              causal, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D = 8>
int smem_of(int d, int bf16) {
  if (d == D) return (int)(bf16 ? Tile<D>::SMEM : smem_f32<D>());
  if constexpr (D < MAX_D) return smem_of<D + 8>(d, bf16);
  return 0;
}

}  // namespace

extern "C" {

// Head dims this source is built for, a multiple of 8 up to MAX_D (the
// wrapper raises on any other).
int flash_attention_supports(int d) {
  return d >= 8 && d <= MAX_D && d % 8 == 0;
}

// Dynamic shared memory a block of the instance for head dim d takes
// (bf16 = 1: the tensor-core kernel; 0: the float32 one); 0 if not built.
int flash_attention_smem_bytes(int d, int bf16) { return smem_of(d, bf16); }

// q, o: (b, hq, s, d); k, v: (b, hkv, s_kv, d); all contiguous, one type:
// bf16 = 0 for float32, 1 for bfloat16.  hq must be a multiple of hkv, and
// s_kv equal to s under the causal mask.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bf16, int b, int hq, int hkv, int s, int s_kv,
                        int d, float scale, int causal, void* stream) {
  if (b <= 0 || s <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || s_kv < 0 || (causal && s_kv != s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, s_kv, d,
                                        scale, causal, st)
              : dispatch<float>(q, k, v, o, b, hq, hkv, s, s_kv, d, scale,
                                causal, st);
}

}  // extern "C"
