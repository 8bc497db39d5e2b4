// Segmented min-scans over sorted segments, for sm_90a.
//
// Replaces three Pallas TPU kernels of the JAX package:
//   * kernels/segment_min/segment_min.py::segmented_min2_scan (_scan2_kernel)
//     — pair-lex over (hi, lo) uint32 lanes, here one int64 word;
//   * kernels/spmv_minplus/spmv_minplus.py::masked_minplus_scan
//     (_minplus_kernel) — the same scan with the Borůvka liveness mask
//     applied as the lanes are loaded (MASKED = true);
//   * kernels/segment_min/segment_min.py::segmented_min_scan (_scan_kernel)
//     — the single-lane uint32 scan, here one int32 word (V = int).
//
// Inputs: seg int32 (M,) sorted ascending, the values (M,), and for the
// masked scan oth int32 (M,).  Output (M,) of the value type: the
// inclusive segmented min of the values along each run of equal seg; the
// run ends hold each segment's min.  A value is the reference's unsigned
// word stored with its top bit flipped — the packed (hi, lo) uint32 pair as
// one int64, or a single uint32 lane as one int32 — so signed comparison
// of the stored words is exactly the reference's unsigned order, and INF
// (all ones) is INT64_MAX or INT32_MAX.  Masked lanes (seg == oth, or
// key == INF) join as INF.
//
// Bound: bytes.  Each lane reads 12 bytes (16 masked) and writes 8 for the
// 64-bit scans; the 32-bit scan reads 8 bytes and writes 4.  The work is a
// few integer compares per lane, far below what the card can issue in the
// time its memory takes to move the bytes.
//
// Design.  The Pallas kernels carry the running (seg, min) from one tile
// to the next in SMEM, which relies on the TPU grid running its tiles in
// order.  CUDA blocks run in no order, so the scan has three passes:
//   1. tile_scan: each block loads a tile of TILE lanes coalesced into
//      shared memory, scans it (thread-serial over ITEMS lanes, then a warp
//      shuffle scan and a scan over the warps' totals), writes the tile's
//      local scan, and records the tile's last (seg, min), its first seg
//      and the length of its first run;
//   2. carry_scan: one block scans the tiles' last (seg, min) pairs in
//      chunks of 1024 and writes each tile's carry-in, the inclusive scan
//      value just before the tile;
//   3. tile_fixup: each block folds its carry-in into its first run, the
//      only lanes a carry can reach when segments are sorted.
// The combine "keep the earlier run's min if it has the same seg" is
// associative on sorted segments, so every grouping of the work gives the
// same words as the sequential scan, bit for bit.  The three passes are
// templates over the value type: the 32-bit scan is the same design on
// 4-byte words, not the 64-bit scan on widened data.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int CARRY_THREADS = 1024;
constexpr int SENTINEL_SEG = -2;   // identity run; never a real segment
constexpr unsigned FULL = 0xFFFFFFFFu;

// One element per 8 lanes of padding keeps the thread-serial reads of
// shared memory (stride ITEMS) free of bank conflicts.
__device__ __forceinline__ int pidx(int j) { return j + (j >> 3); }
constexpr int TILE_PADDED = TILE + TILE / 8;

// The identity of min for each stored value type (flipped all ones).
template <typename V> struct Inf;
template <> struct Inf<long long> {
  static constexpr long long value = 0x7FFFFFFFFFFFFFFFLL;
};
template <> struct Inf<int> {
  static constexpr int value = 0x7FFFFFFF;
};

template <typename V>
struct RunT {
  V val;
  int seg;
};

// a precedes b: b keeps its seg, and takes a's min when a is the same run.
template <typename V>
__device__ __forceinline__ RunT<V> pick(RunT<V> a, RunT<V> b) {
  if (a.seg == b.seg && a.val < b.val) b.val = a.val;
  return b;
}

template <typename V>
__device__ __forceinline__ RunT<V> warp_inclusive(RunT<V> r, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    RunT<V> o;
    o.seg = __shfl_up_sync(FULL, r.seg, off);
    o.val = __shfl_up_sync(FULL, r.val, off);
    if (lane >= off) r = pick(o, r);
  }
  return r;
}

// Block-wide scan of one Run per thread.  Returns the combination of all
// earlier threads' runs (thread 0 gets the identity, an INF run) and sets
// *total to the block's inclusive run.
template <int NT, typename V>
__device__ RunT<V> block_exclusive(RunT<V> agg, RunT<V>* warp_runs,
                                   RunT<V>* total) {
  using Run = RunT<V>;
  constexpr V INF = Inf<V>::value;
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // a previous call may still read warp_runs
  Run inc = warp_inclusive(agg, lane);
  if (lane == 31) warp_runs[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Run w = lane < NW ? warp_runs[lane] : Run{INF, SENTINEL_SEG};
    w = warp_inclusive(w, lane);
    if (lane < NW) warp_runs[lane] = w;
  }
  __syncthreads();
  Run prev;
  prev.seg = __shfl_up_sync(FULL, inc.seg, 1);
  prev.val = __shfl_up_sync(FULL, inc.val, 1);
  Run excl{INF, SENTINEL_SEG};
  if (warp > 0) {
    excl = lane > 0 ? pick(warp_runs[warp - 1], prev) : warp_runs[warp - 1];
  } else if (lane > 0) {
    excl = prev;
  }
  *total = warp_runs[NW - 1];
  return excl;
}

template <typename V, bool MASKED>
__global__ void __launch_bounds__(THREADS)
tile_scan(const int* __restrict__ seg, const int* __restrict__ oth,
          const V* __restrict__ key, V* __restrict__ out,
          int* __restrict__ tile_meta, V* __restrict__ tile_last_val,
          long long n, int ntiles) {
  using Run = RunT<V>;
  constexpr V INF = Inf<V>::value;
  __shared__ int s_seg[TILE_PADDED];
  __shared__ V s_val[TILE_PADDED];
  __shared__ Run warp_runs[THREADS / 32];
  __shared__ int first_len;

  const int b = blockIdx.x;
  const long long base = (long long)b * TILE;
  const int valid = (int)min((long long)TILE, n - base);
  if (threadIdx.x == 0) first_len = valid;
  for (int j = threadIdx.x; j < TILE; j += THREADS) {
    int s = SENTINEL_SEG;   // lanes past the end follow every real lane,
    V v = INF;              // so the causal scan never carries them back
    if (j < valid) {
      s = seg[base + j];
      v = key[base + j];
      if (MASKED && oth[base + j] == s) v = INF;
    }
    s_seg[pidx(j)] = s;
    s_val[pidx(j)] = v;
  }
  __syncthreads();

  const int t0 = threadIdx.x * ITEMS;
  int s[ITEMS];
  V v[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    s[i] = s_seg[pidx(t0 + i)];
    v[i] = s_val[pidx(t0 + i)];
  }
#pragma unroll
  for (int i = 1; i < ITEMS; ++i)
    if (s[i] == s[i - 1] && v[i - 1] < v[i]) v[i] = v[i - 1];
  const int first = s_seg[0];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (t0 + i < valid && s[i] != first) {
      atomicMin(&first_len, t0 + i);
      break;
    }
  }

  Run total;
  const Run excl =
      block_exclusive<THREADS, V>(Run{v[ITEMS - 1], s[ITEMS - 1]}, warp_runs,
                                  &total);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (s[i] == excl.seg && excl.val < v[i]) v[i] = excl.val;

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) s_val[pidx(t0 + i)] = v[i];
  __syncthreads();
  for (int j = threadIdx.x; j < valid; j += THREADS) out[base + j] = s_val[pidx(j)];
  if (threadIdx.x == 0) {
    tile_meta[b] = s_seg[pidx(valid - 1)];           // last seg
    tile_meta[ntiles + b] = first;                    // first seg
    tile_meta[2 * ntiles + b] = first_len;            // first run length
    tile_last_val[b] = s_val[pidx(valid - 1)];        // last local min
  }
}

template <typename V>
__global__ void __launch_bounds__(CARRY_THREADS)
carry_scan(int* __restrict__ tile_meta, V* __restrict__ tile_last_val,
           int ntiles) {
  // Reads the tiles' last (seg, min) and overwrites them in place with
  // each tile's carry-in (the scan value just before the tile).
  using Run = RunT<V>;
  constexpr V INF = Inf<V>::value;
  __shared__ Run warp_runs[CARRY_THREADS / 32];
  Run run{INF, SENTINEL_SEG};
  for (int c0 = 0; c0 < ntiles; c0 += CARRY_THREADS) {
    const int b = c0 + threadIdx.x;
    Run agg{INF, SENTINEL_SEG};
    if (b < ntiles) agg = Run{tile_last_val[b], tile_meta[b]};
    Run total;
    const Run excl =
        block_exclusive<CARRY_THREADS, V>(agg, warp_runs, &total);
    const Run carry = threadIdx.x == 0 ? run : pick(run, excl);
    if (b < ntiles) {
      tile_meta[b] = carry.seg;
      tile_last_val[b] = carry.val;
    }
    run = pick(run, total);   // used only while every lane of the chunk is real
  }
}

template <typename V>
__global__ void __launch_bounds__(THREADS)
tile_fixup(const int* __restrict__ tile_meta, const V* __restrict__ carry_val,
           V* __restrict__ out, int ntiles) {
  const int b = blockIdx.x;
  const int cseg = tile_meta[b];
  if (cseg != tile_meta[ntiles + b]) return;
  const V cv = carry_val[b];
  const int len = tile_meta[2 * ntiles + b];
  const long long base = (long long)b * TILE;
  for (int j = threadIdx.x; j < len; j += THREADS)
    if (cv < out[base + j]) out[base + j] = cv;
}

// Launch the three passes on one stream; returns the first CUDA error.
template <typename V, bool MASKED>
int launch(const int* seg, const int* oth, const V* key, V* out,
           int* tile_meta, V* tile_last_val, long long n, cudaStream_t st) {
  const int ntiles = (int)((n + TILE - 1) / TILE);
  tile_scan<V, MASKED><<<ntiles, THREADS, 0, st>>>(seg, oth, key, out,
                                                   tile_meta, tile_last_val,
                                                   n, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ntiles > 1) {
    carry_scan<V><<<1, CARRY_THREADS, 0, st>>>(tile_meta, tile_last_val,
                                               ntiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_fixup<V><<<ntiles, THREADS, 0, st>>>(tile_meta, tile_last_val, out,
                                              ntiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int segscan_tile_size() { return TILE; }

// tile_meta: int32 scratch of 3 * ntiles; tile_last_val: int64 scratch of
// ntiles, with ntiles = ceil(n / TILE).  oth may be null (unmasked scan).
int segscan_min(const int* seg, const int* oth, const long long* key,
                long long* out, int* tile_meta, long long* tile_last_val,
                long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (oth != nullptr)
    return launch<long long, true>(seg, oth, key, out, tile_meta,
                                   tile_last_val, n, st);
  return launch<long long, false>(seg, oth, key, out, tile_meta,
                                  tile_last_val, n, st);
}

// The single-lane scan over flipped int32 words.  tile_meta: int32 scratch
// of 3 * ntiles; tile_last_val: int32 scratch of ntiles.
int segscan_min32(const int* seg, const int* val, int* out, int* tile_meta,
                  int* tile_last_val, long long n, void* stream) {
  if (n <= 0) return 0;
  return launch<int, false>(seg, nullptr, val, out, tile_meta, tile_last_val,
                            n, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
