// Batched linear-probe edge-hash lookup, for sm_90a.
//
// Replaces the Pallas TPU kernel
// kernels/edge_hash/edge_hash.py::hash_lookup (_lookup_kernel): each query
// (q_lv, q_u) is mixed into its home slot exactly as ghs_state.hash_slot
// does — uint32 wraparound products with HASH_K1 and HASH_K2, xor, then
// % tsize on the unsigned word — and probes idx, idx + 1, ... modulo tsize
// for at most max_probes slots.  It stops at a hit (the slot's (lv, u)
// equals the query; out = the slot's h_pos) or at an empty slot
// (h_pos < 0; out = -1), and out = -1 when the probes run out.
//
// Bound: bytes.  Each query reads 8 bytes and writes 4.  Each probe reads
// h_pos and h_lv at its slot, and h_u only where h_lv matches the query;
// consecutive probes of a chain mostly stay inside one 32-byte sector, and
// the queries together touch most sectors of the table.  So the least a
// lookup must read is each needed sector once (edge_hash/ref.probe_traffic
// counts them), far below what this kernel reads: it shares nothing
// between queries, so it reads a sector per array per chain at a random
// address.  The compares are nothing beside that.
//
// Design.  The Pallas kernel holds the whole table in VMEM as one block
// and runs a fixed fori_loop of max_probes probes in lock-step over a block
// of 512 queries, freezing lanes that are done.  The table of a one-process
// rmat-20 deployment has about 133M slots (1.6 GB), far above a block's
// 227 KB of shared memory and the 50 MB L2, so here the table stays in
// device memory and every probe is a random read.  One thread per query
// with its own early exit gives the same words as the lock-step loop (a
// frozen lane's word never changes), needs no padding of the queries to a
// block multiple, and makes only the probes each query needs.  The three
// arrays keep the reference's layout; interleaving them into one 12-byte
// record would cut a chain's reads to about one sector, and ordering the
// queries by home slot would let them share sectors.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned HASH_K1 = 2654435761u;
constexpr unsigned HASH_K2 = 2246822519u;

__global__ void __launch_bounds__(THREADS)
lookup_kernel(const int* __restrict__ h_lv, const int* __restrict__ h_u,
              const int* __restrict__ h_pos, const int* __restrict__ q_lv,
              const int* __restrict__ q_u, int* __restrict__ out,
              long long q, unsigned tsize, int max_probes) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= q) return;
  const int a = q_lv[i];
  const int b = q_u[i];
  const unsigned mixed = ((unsigned)a * HASH_K1) ^ ((unsigned)b * HASH_K2);
  unsigned idx = mixed % tsize;
  int pos = -1;
  for (int p = 0; p < max_probes; ++p) {
    const int kpos = __ldg(h_pos + idx);
    if (__ldg(h_lv + idx) == a && __ldg(h_u + idx) == b) {
      pos = kpos;
      break;
    }
    if (kpos < 0) break;
    idx = idx + 1 == tsize ? 0u : idx + 1;
  }
  out[i] = pos;
}

}  // namespace

extern "C" {

// Table: three int32 arrays of tsize slots; queries: two int32 arrays of q
// lanes; out: int32 (q,).  tsize must be in [1, 2^31).
int edge_hash_lookup(const int* h_lv, const int* h_u, const int* h_pos,
                     const int* q_lv, const int* q_u, int* out, long long q,
                     long long tsize, int max_probes, void* stream) {
  if (q <= 0) return 0;
  if (tsize <= 0 || tsize > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const long long blocks = (q + THREADS - 1) / THREADS;
  lookup_kernel<<<(unsigned)blocks, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      h_lv, h_u, h_pos, q_lv, q_u, out, q, (unsigned)tsize, max_probes);
  return (int)cudaGetLastError();
}

}  // extern "C"
