// Batched linear-probe edge-hash lookup over a table of 16-byte records,
// for sm_90a.
//
// Replaces the Pallas TPU kernel
// kernels/edge_hash/edge_hash.py::hash_lookup (_lookup_kernel): each query
// (q_lv, q_u) is mixed into its home slot exactly as ghs_state.hash_slot
// does — uint32 wraparound products with HASH_K1 and HASH_K2, xor, then
// % tsize on the unsigned word — and probes idx, idx + 1, ... modulo tsize
// for at most max_probes slots.  It stops at a hit (the slot's (lv, u)
// equals the query; out = the slot's pos) or at an empty slot (pos < 0;
// out = -1), and out = -1 when the probes run out.
//
// Layout.  The reference keeps the table as three int32 arrays (h_lv, h_u,
// h_pos).  Here slot s is one 16-byte record (lv, u, pos, 0) at byte 16·s
// of one array (pack_kernel builds it from the three arrays once, when the
// table goes to the card; edge_hash/ref.pack is its plain version).  A
// record never straddles a 32-byte memory sector and two records share
// each sector, so a probe is one 128-bit load of one sector, whose three
// compares all act on that load, and the next probe of a chain often stays
// inside the same sector.  With
// the three arrays a probe read two random sectors (h_pos and h_lv), and a
// third (h_u) after the compare of h_lv.
//
// Bound: bytes.  Each query reads 8 bytes and writes 4, and the probes
// read table sectors at random addresses.  The least a lookup must read is
// each needed sector once (edge_hash/ref.probe_traffic counts them for
// both layouts); one thread a query shares no sector with another, so it
// reads about one sector a chain, at the card's rate for random sectors,
// well below its streaming rate.  Ordering the queries by home slot would
// let them share sectors, at the cost of a sort of the queries.  The
// compares are nothing beside the reads.
//
// Design.  The Pallas kernel holds the whole table in VMEM as one block
// and runs a fixed fori_loop of max_probes probes in lock-step over a block
// of 512 queries, freezing lanes that are done.  The table of a one-process
// rmat-20 deployment has about 133M slots (2.1 GB as records), far above a
// block's 227 KB of shared memory and the 50 MB L2, so here the table stays
// in device memory and every probe is a random read.  One thread per query
// with its own early exit gives the same words as the lock-step loop (a
// frozen lane's word never changes), needs no padding of the queries to a
// block multiple, and makes only the probes each query needs.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned HASH_K1 = 2654435761u;
constexpr unsigned HASH_K2 = 2246822519u;

__global__ void __launch_bounds__(THREADS)
records_kernel(const int4* __restrict__ table, const int* __restrict__ q_lv,
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
    const int4 r = __ldg(table + idx);  // ld.global.nc.v4: one sector
    if (r.x == a && r.y == b) {
      pos = r.z;
      break;
    }
    if (r.z < 0) break;
    idx = idx + 1 == tsize ? 0u : idx + 1;
  }
  out[i] = pos;
}

// The three arrays as records: a copy at the memory rate (each thread
// reads one word of each array, coalesced, and writes one record).
__global__ void __launch_bounds__(THREADS)
pack_kernel(const int* __restrict__ lv, const int* __restrict__ u,
            const int* __restrict__ pos, int4* __restrict__ records,
            long long tsize) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < tsize) records[i] = make_int4(lv[i], u[i], pos[i], 0);
}

}  // namespace

extern "C" {

// records (tsize, 4) int32, 16-byte aligned, from three int32 arrays of
// tsize slots: (lv, u, pos, 0) a slot.
int edge_hash_pack_records(const int* lv, const int* u, const int* pos,
                           void* records, long long tsize, void* stream) {
  if (tsize <= 0) return 0;
  if (reinterpret_cast<unsigned long long>(records) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (tsize + THREADS - 1) / THREADS;
  pack_kernel<<<(unsigned)blocks, THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      lv, u, pos, static_cast<int4*>(records), tsize);
  return (int)cudaGetLastError();
}

// Table: tsize records of four int32 (lv, u, pos, 0), 16-byte aligned;
// queries: two int32 arrays of q lanes; out: int32 (q,).  tsize must be in
// [1, 2^31).
int edge_hash_lookup_records(const void* records, const int* q_lv,
                             const int* q_u, int* out, long long q,
                             long long tsize, int max_probes, void* stream) {
  if (q <= 0) return 0;
  if (tsize <= 0 || tsize > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<unsigned long long>(records) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (q + THREADS - 1) / THREADS;
  records_kernel<<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(records), q_lv, q_u, out, q, (unsigned)tsize,
      max_probes);
  return (int)cudaGetLastError();
}

}  // extern "C"
