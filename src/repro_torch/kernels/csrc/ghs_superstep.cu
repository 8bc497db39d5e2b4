// The superstep loop of the paper-faithful GHS engine, for sm_90a: one
// launch runs up to n_steps supersteps of S shards, one block a shard.
//
// Replaces no Pallas kernel.  The JAX package runs this loop on the device
// as nested lax.while_loops over scalar state (core/ghs_message.py:
// interval_core at 591-607, process_main at 409-428, process_test_q at
// 430-446, the hash probe at 163-182, test_proc's cursor scan at
// 243-265, the all_to_all and psum of the superstep at 497-526), one
// shard a device under shard_map; torch has no device loop, and an eager
// loop would cost tens of launches and host branches a message.  This
// kernel is that loop: it reads and writes the same state arrays
// (core/ghs_state.ShardState stacked over the shards, the uint32 words as
// int32 bits) and follows the same control flow, write for write.
// kernels/ghs_superstep/ref.py is its plain version, line for line.
//
// One superstep.  Warp 0 of block s runs shard s's own part: ingest its
// inbox, source shard 0 first (an early-exit probe resolves each
// message's edge, the pre-pass of edge_hash.ops.resolve_batch), pop the
// main queue under a budget fixed at entry, drain the Test queue up to its
// tail at entry on every check-th superstep (C1), and take up to xcap
// messages off each of its S outgoing rings.  A grid barrier; then the
// exchange, the reference's all_to_all inside the launch: block d's
// threads copy what every shard s took off its ring for d into inbox
// block s of shard d, in the order s = 0..S-1, zeros past it.  Each
// block's thread 0 publishes its shard's activity (messages still held)
// and error word; a second barrier; every block sums the S of each (the
// reference's psum), so all agree on the silent streak and on the exit.
// Thread 0 of each block writes its shard's histories at the global step.
// The launch reads step0 and silent0 from scal_in and block 0 writes
// [step0 + steps_run, silent, error sum] to scal_out, as interval_core
// returns them, so a launch from a silent state runs nothing and the next
// interval can be queued from the previous one's unfetched outputs.
//
// One launch, S co-resident blocks: it is cooperative (the barriers are
// cooperative_groups grid syncs, as K3's in pointer_jump.cu), and the
// entry refuses an S the card cannot hold at once (the occupancy API); it
// never splits the launch.  With one shard the barriers are block syncs.
//
// Bound: latency.  GHS is sequential by design: each message's handler
// reads what the previous ones wrote, so a shard's messages run one at a
// time, in the reference's order, and the time is the chain of each
// message's dependent loads and instructions, of the slowest shard a
// superstep, plus two grid barriers a superstep.  The bytes an interval
// touches are few.  On the H100 a message of rmat-16's first interval
// takes about 1.4 us: a round trip for its burst (at HBM latency once the
// state outgrows L2) and some 2,200 cycles of one warp's dependent
// instructions (1.25 us a message at rmat-12, whose state fits L2; PERF.md
// section 6).  The design takes what it can off that chain:
// - One warp runs a shard's loop.  Its 32 lanes follow one warp-uniform
//   control flow and hold the same scalars (queue heads and tails,
//   counters, the error word in registers for the launch; the S ring heads
//   and tails in shared memory, which only lane 0 touches in the loop).
//   Lane 0 does each store the sequential loop does, except that a
//   message's words are stored one a lane; a lane reads a word another
//   lane wrote, or writes a word other lanes read, only across a
//   __syncwarp.
// - The adjacency scans are warp-wide: test_proc's search for the first
//   Basic edge and h_initiate's walk over the Branch edges read SCAN
//   consecutive edge states (and their neighbours) a step and pick edges
//   by __ballot_sync, in ascending position, so a hub's long prefix of
//   rejected edges costs a step per SCAN words, not a load per word.  The
//   linear lookup ablation and the hash probe take 32 positions or slots
//   a step the same way; the ingest pre-pass probes 32 messages at once.
// - The dispatched vertex's ten words, its edge's state and static words
//   and the first scan window are loaded in one burst after the previous
//   message's writes; the handler works on registers and writes back the
//   words that changed.
// - Every handler ends in one tail (test_proc, report_proc, change_core,
//   then the one message it sends last), so each of those, and the loop
//   over both queues, is one copy of code: an instance is a fifth to a
//   third of the instructions it was with a copy in every handler.
//   Queue slots advance without a division, and the divisions by launch
//   constants (the hash table's size, the shard block, S, the ring size)
//   are multiply-highs (FastDiv).
// - The lookahead: while message i is handled, message i+1 is resolved to
//   its edge and its burst's lines are prefetched (a hint: nothing is read
//   into a register before message i's writes), message i+2's lookup (32
//   hash slots and its adjacency bounds) is in flight, and message i+3's
//   words and queue position.  Only a message already queued is looked
//   ahead at (a queued slot is rewritten only by a push that overflows the
//   queue, which stops the loop); what the loop does not reach is dropped.
// The lookup method, the lane count and relaxed_test_queue are template
// parameters.  Data written inside the launch by another block (the rings
// and the exchange scratch) is read with ld.global.cg, never through the
// read-only path.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// The argument struct; kernels/ghs_superstep/ghs_superstep.py::_Args
// mirrors it (one pointer a ShardState field, in its order, each to the
// stacked (S, ...) tensor; the scalar vectors; the exchange scratch; the
// sizes).  Outside the anonymous namespace: the C entries take it, and
// must keep external linkage.
struct Shard {
  int32_t* sn; uint32_t* ln; uint32_t* fnw; uint32_t* fne;
  int32_t* find_count; int32_t* in_branch; int32_t* best_edge;
  uint32_t* best_w; uint32_t* best_e; int32_t* test_edge;
  const int32_t* indptr; const int32_t* nbr; const int32_t* ceid;
  const uint32_t* ewb; const uint32_t* etb; const int32_t* byid;
  int32_t* se;
  const int32_t* h_lv; const int32_t* h_u; const int32_t* h_pos;
  uint32_t* mq; int32_t* mq_pos; int32_t* mq_head; int32_t* mq_tail;
  uint32_t* tq; int32_t* tq_pos; int32_t* tq_head; int32_t* tq_tail;
  uint32_t* og; int32_t* og_head; int32_t* og_tail;
  uint32_t* inbox; int32_t* in_cnt;
  int32_t* err; int32_t* halted; int32_t* n_processed; int32_t* n_productive;
  int32_t* n_sent_remote; int32_t* n_sent_local;
  int32_t* hist_act; int32_t* hist_sent;
  const int32_t* scal_in; int32_t* scal_out;
  // Exchange scratch: 2 S^2 words (each (source, destination) pair's ring
  // head and count this superstep), then 4 S (two superstep-parity halves
  // of each shard's activity and error word).
  int32_t* xchg;
  int block, qcap, ocap, xcap, tsize, hcap, n_steps, check, empty_needed,
      eb, num_shards;

  // Shard s's part of every stacked field, messages of `lanes` words.
  __device__ Shard at(int s, int lanes) const {
    Shard t = *this;
    const size_t S = (size_t)num_shards, nb = (size_t)block;
    const size_t e = (size_t)eb * s, h = (size_t)tsize * s;
    const size_t q = (size_t)qcap * s, L = (size_t)lanes;
    t.sn = sn + s * nb; t.ln = ln + s * nb; t.fnw = fnw + s * nb;
    t.fne = fne + s * nb; t.find_count = find_count + s * nb;
    t.in_branch = in_branch + s * nb; t.best_edge = best_edge + s * nb;
    t.best_w = best_w + s * nb; t.best_e = best_e + s * nb;
    t.test_edge = test_edge + s * nb;
    t.indptr = indptr + s * (nb + 1);
    t.nbr = nbr + e; t.ceid = ceid + e; t.ewb = ewb + e; t.etb = etb + e;
    t.byid = byid + e; t.se = se + e;
    t.h_lv = h_lv + h; t.h_u = h_u + h; t.h_pos = h_pos + h;
    t.mq = mq + q * L; t.mq_pos = mq_pos + q;
    t.tq = tq + q * L; t.tq_pos = tq_pos + q;
    t.mq_head = mq_head + s; t.mq_tail = mq_tail + s;
    t.tq_head = tq_head + s; t.tq_tail = tq_tail + s;
    t.og = og + s * S * (size_t)ocap * L;
    t.og_head = og_head + s * S; t.og_tail = og_tail + s * S;
    t.inbox = inbox + s * S * (size_t)xcap * L;
    t.in_cnt = in_cnt + s * S;
    t.err = err + s; t.halted = halted + s;
    t.n_processed = n_processed + s; t.n_productive = n_productive + s;
    t.n_sent_remote = n_sent_remote + s; t.n_sent_local = n_sent_local + s;
    t.hist_act = hist_act + (size_t)s * hcap;
    t.hist_sent = hist_sent + (size_t)s * hcap;
    return t;
  }
};

namespace {

constexpr int CONNECT = 0, INITIATE = 1, TEST = 2, ACCEPT = 3, REJECT = 4,
              REPORT = 5, CHANGE_CORE = 6;
constexpr int FIND = 1, FOUND = 2;
constexpr int BASIC = 0, BRANCH = 1, REJECTED = 2;
constexpr int ERR_QUEUE_OVERFLOW = 1, ERR_HASH_MISS = 2, ERR_LOGIC = 4;
constexpr int POS_UNRESOLVED = -2;
constexpr uint32_t INF = 0xFFFFFFFFu;
constexpr uint32_t HASH_K1 = 2654435761u;
constexpr uint32_t HASH_K2 = 2246822519u;
constexpr int METHOD_HASH = 0, METHOD_LINEAR = 1, METHOD_BINARY = 2;
constexpr int PROBES = 64;   // the ingest pre-pass's probe cap (min tsize)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SCAN_K = 4;             // words a lane reads in a scan step
constexpr int SCAN = 32 * SCAN_K;     // adjacency words a scan step
constexpr int32_t OUTSIDE = -1;       // a scan word past the window's end

template <int LANES>
struct Msg {
  uint32_t w[LANES];
};

__device__ __forceinline__ int floordiv(int a, int b) {   // b > 0, as jnp's
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Unsigned 32-bit division by a divisor fixed for the launch: a
// multiply-high and two shifts (Granlund and Montgomery's round-up
// method, exact for every 32-bit dividend) in place of the division
// sequence on the loop's chain.
struct FastDiv {
  uint32_t d, m;
  int l;
  __device__ explicit FastDiv(uint32_t divisor) : d(divisor) {
    l = d > 1 ? 32 - __clz((int)(d - 1)) : 0;
    m = (uint32_t)((1ull << 32) * ((1ull << l) - d) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t x) const {
    if (d == 1) return x;
    const uint32_t t = __umulhi(m, x);
    return (t + ((x - t) >> 1)) >> (l - 1);
  }
  __device__ __forceinline__ uint32_t mod(uint32_t x) const {
    return x - div(x) * d;
  }
};

// Shared memory of a block: its shard's S ring heads and tails, and the
// inbox rows of each source block that may hold a nonzero word.
struct Smem {
  int32_t* og_h;
  int32_t* og_t;
  int32_t* rows;
};

// The ten words of a vertex, in ShardState order.
struct Vtx {
  int32_t sn; uint32_t ln, fnw, fne; int32_t find_count, in_branch, best_edge;
  uint32_t best_w, best_e; int32_t test_edge;
};

// SCAN consecutive adjacency positions from a base, SCAN_K a lane (lane l
// holds base + 32 k + l): their edge states (OUTSIDE past the window's
// end) and neighbours.
struct Win {
  int32_t se[SCAN_K];
  int32_t nb[SCAN_K];
};

template <int METHOD, int LANES, bool RELAXED>
struct Loop {
  const Shard& s;       // this block's shard
  const int my;         // its index
  const int S;
  const int32_t v0;     // its first global vertex id
  const int lane;
  int32_t* og_h;        // shared: ring heads and tails, one a destination
  int32_t* og_t;
  int32_t mq_head, mq_tail, tq_head, tq_tail;
  int32_t mq_hs, mq_ts, tq_hs, tq_ts;   // their slots (index mod qcap)
  int32_t err, halted, n_processed, n_productive, n_sent_remote,
      n_sent_local;
  const FastDiv by_tsize, by_block, by_shards, by_ocap;
  const int32_t* const hint_base;       // this lane's array for hint()

  // A queued message's words and position lane, loaded ahead; idx is its
  // queue index, -1 for none.
  struct Ahead {
    Msg<LANES> raw;
    int32_t pre, idx;
  };
  // A message resolved to its edge p (0 on a miss) in its receiver lv's
  // adjacency window [a, b).
  struct Ready {
    Msg<LANES> raw;
    int32_t lv, u, p, a, b;
    bool miss;
  };
  // A lookup in flight: this lane's hash slot of the first window, and the
  // receiver's adjacency bounds.
  struct Lookup {
    int32_t hl, hu, hp, a, b;
    uint32_t home;
  };
  // The dispatched message and what its handler reads, in registers.
  struct Cur {
    Ready c;
    Vtx v;                      // the vertex words, updated in place
    int32_t sp;                 // se[p] at dispatch
    int32_t nbr_p;
    uint32_t ewb_p, etb_p;
    Win w0;                     // [a, a + SCAN), kept equal to se
  };
  // The one message a handler sends last: none, a fresh one, or the
  // dispatched one postponed (back to a local queue).
  enum { OUT_NONE, OUT_SEND, OUT_POSTPONE };
  // What a handler leaves to its tail, in this order: test_proc (which may
  // leave report_proc), report_proc, change_core.
  enum { THEN_TEST = 1, THEN_REPORT = 2, THEN_CORE = 4 };

  __device__ Loop(const Shard& shard, int me, const Smem& sm)
      : s(shard), my(me), S(shard.num_shards), v0(shard.block * me),
        lane(threadIdx.x & 31), og_h(sm.og_h), og_t(sm.og_t),
        mq_head(*shard.mq_head), mq_tail(*shard.mq_tail),
        tq_head(*shard.tq_head), tq_tail(*shard.tq_tail),
        mq_hs(mq_head % shard.qcap), mq_ts(mq_tail % shard.qcap),
        tq_hs(tq_head % shard.qcap), tq_ts(tq_tail % shard.qcap),
        err(*shard.err), halted(*shard.halted),
        n_processed(*shard.n_processed), n_productive(*shard.n_productive),
        n_sent_remote(*shard.n_sent_remote),
        n_sent_local(*shard.n_sent_local), by_tsize(shard.tsize),
        by_block(shard.block), by_shards(shard.num_shards),
        by_ocap(shard.ocap), hint_base(hint_array(shard, lane)) {}

  __device__ void store() const {
    *s.mq_head = mq_head; *s.mq_tail = mq_tail;
    *s.tq_head = tq_head; *s.tq_tail = tq_tail;
    for (int d = 0; d < S; ++d) {
      s.og_head[d] = og_h[d];
      s.og_tail[d] = og_t[d];
    }
    *s.err = err; *s.halted = halted;
    *s.n_processed = n_processed; *s.n_productive = n_productive;
    *s.n_sent_remote = n_sent_remote; *s.n_sent_local = n_sent_local;
  }

  __device__ __forceinline__ int32_t next_slot(int32_t slot) const {
    return slot + 1 == s.qcap ? 0 : slot + 1;
  }

  // --- messages ------------------------------------------------------------
  __device__ __forceinline__ static Msg<LANES> encode(
      uint32_t mtype, uint32_t level, uint32_t state, uint32_t src,
      uint32_t dst, uint32_t fw, uint32_t fe) {
    Msg<LANES> m;
    if constexpr (LANES == 5) {
      m.w[0] = mtype | (state << 3) | (level << 4);
      m.w[1] = src; m.w[2] = dst; m.w[3] = fw; m.w[4] = fe;
    } else {
      m.w[0] = mtype; m.w[1] = level; m.w[2] = state; m.w[3] = src;
      m.w[4] = dst; m.w[5] = fw; m.w[6] = fe; m.w[7] = 0;
    }
    return m;
  }

  __device__ __forceinline__ static Msg<LANES> load_msg(const uint32_t* row) {
    Msg<LANES> m;
#pragma unroll
    for (int k = 0; k < LANES; ++k) m.w[k] = row[k];
    return m;
  }

  // Every lane holds m; lane k stores word k.
  __device__ __forceinline__ void store_msg(uint32_t* row,
                                            const Msg<LANES>& m) const {
    uint32_t x = m.w[0];
#pragma unroll
    for (int k = 1; k < LANES; ++k)
      if (lane == k) x = m.w[k];
    if (lane < LANES) row[lane] = x;
  }

  __device__ __forceinline__ static uint32_t mtype_of(const Msg<LANES>& m) {
    return LANES == 5 ? m.w[0] & 7 : m.w[0];
  }
  __device__ __forceinline__ static uint32_t src_of(const Msg<LANES>& m) {
    return LANES == 5 ? m.w[1] : m.w[3];
  }
  __device__ __forceinline__ static uint32_t dst_of(const Msg<LANES>& m) {
    return LANES == 5 ? m.w[2] : m.w[4];
  }

  // Queue m for dst (an int32): the local main or Test queue, or the
  // outgoing ring of its shard.  A full ring's slot is overwritten and its
  // tail still advances; the overflow flag is set after the write.
  __device__ __forceinline__ void push(const Msg<LANES>& m, int32_t dst,
                                       bool is_test, int32_t pos) {
    const long long rel = (long long)dst - v0;
    if (rel >= 0 && rel < s.block) {             // floordiv(dst, block) == my
      ++n_sent_local;
      const int32_t slot = is_test ? tq_ts : mq_ts;
      store_msg((is_test ? s.tq : s.mq) + (size_t)slot * LANES, m);
      if (lane == 0) (is_test ? s.tq_pos : s.mq_pos)[slot] = pos;
      if (is_test) {
        ++tq_tail;
        tq_ts = next_slot(tq_ts);
      } else {
        ++mq_tail;
        mq_ts = next_slot(mq_ts);
      }
    } else {
      // Ring row ds: a negative row from -S wraps, any other outside
      // [0, S) is dropped; the tail of row ds mod S advances either way.
      // Only that row's fill can have grown.  Lane 0 keeps the tails.
      const int ds =
          dst >= 0 ? (int)by_block.div(dst) : floordiv(dst, s.block);
      const int r =
          ds >= 0 ? (int)by_shards.mod(ds) : ds - floordiv(ds, S) * S;
      int32_t t = 0;
      if (lane == 0) t = og_t[r];
      t = __shfl_sync(FULL, t, 0);
      if (ds >= -S && ds < S)
        store_msg(s.og + ((size_t)r * s.ocap + by_ocap.mod(t)) * LANES, m);
      if (lane == 0) og_t[r] = t + 1;
      ++n_sent_remote;
      if (t + 1 - og_h[r] > s.ocap) err |= ERR_QUEUE_OVERFLOW;
    }
    if (mq_tail - mq_head > s.qcap || tq_tail - tq_head > s.qcap)
      err |= ERR_QUEUE_OVERFLOW;
  }

  // An edge state written by lane 0 (after every lane's loads of it: the
  // burst's fence, or change_core's).  A lane loads it again only after a
  // __syncwarp: test_proc's, before a window past the first, or the next
  // message's.
  __device__ __forceinline__ void set_se(int32_t q, int32_t val) {
    if (lane == 0) s.se[q] = val;
  }

  // --- edge lookup (C2 and the ablations) ---------------------------------
  __device__ __forceinline__ uint32_t home(int32_t lv, int32_t u) const {
    return by_tsize.mod(((uint32_t)lv * HASH_K1) ^ ((uint32_t)u * HASH_K2));
  }

  // The reference's probe walks from the home slot until a hit or an empty
  // slot, at most tsize slots; the answer is that slot's hit.  Lane j
  // reads the slot j steps on, 32 steps at a time: the first lane that
  // stops decides.  `done` steps are taken; (hl, hu, hp) is this lane's
  // slot of that window.
  __device__ __forceinline__ bool probe_window(int32_t lv, int32_t u,
                                               uint32_t done, int32_t hl,
                                               int32_t hu, int32_t hp,
                                               int32_t& out) const {
    const bool valid = done + lane < (uint32_t)s.tsize;
    const bool hit = valid && hl == lv && hu == u;
    const unsigned stop = __ballot_sync(FULL, valid && (hit || hp < 0));
    if (stop == 0) return false;
    out = __shfl_sync(FULL, hit ? hp : -1, __ffs(stop) - 1);
    return true;
  }

  // The slot `steps` < tsize on from h < tsize.
  __device__ __forceinline__ uint32_t slot_at(uint32_t h, uint32_t steps)
      const {
    const uint32_t x = h + steps;
    return x >= (uint32_t)s.tsize ? x - (uint32_t)s.tsize : x;
  }

  __device__ __forceinline__ int32_t probe_rest(int32_t lv, int32_t u,
                                                uint32_t h, uint32_t done)
      const {
    const uint32_t tsize = (uint32_t)s.tsize;
    int32_t p = -1;
    for (; done < tsize; done += 32) {
      int32_t hl = -1, hu = -1, hp = 0;
      if (done + lane < tsize) {
        const uint32_t slot = slot_at(h, done + lane);
        hl = __ldg(s.h_lv + slot); hu = __ldg(s.h_u + slot);
        hp = __ldg(s.h_pos + slot);
      }
      if (probe_window(lv, u, done, hl, hu, hp, p)) return p;
    }
    return -1;
  }

  // The first position in [a, b) whose neighbour is u, SCAN a step.
  __device__ __forceinline__ int32_t linear_find(int a, int b,
                                                 int32_t u) const {
    for (int base = a; base < b; base += SCAN) {
      int32_t x[SCAN_K];
#pragma unroll
      for (int k = 0; k < SCAN_K; ++k) {
        const int q = base + 32 * k + lane;
        x[k] = q < b ? __ldg(s.nbr + q) : 0;
      }
#pragma unroll
      for (int k = 0; k < SCAN_K; ++k) {
        const int q = base + 32 * k + lane;
        const unsigned m = __ballot_sync(FULL, q < b && x[k] == u);
        if (m) return base + 32 * k + __ffs(m) - 1;
      }
    }
    return -1;
  }

  __device__ __forceinline__ int32_t binary_find(int a, int b,
                                                 int32_t u) const {
    int lo = a, hi = b;
    while (lo < hi) {
      const int mid = (int)(((long long)lo + hi) >> 1);
      if (__ldg(s.nbr + __ldg(s.byid + mid)) < u) lo = mid + 1;
      else hi = mid;
    }
    if (lo < b) {
      const int q = __ldg(s.byid + lo);
      if (__ldg(s.nbr + q) == u) return q;
    }
    return -1;
  }

  // The ingest pre-pass for one lane's message (edge_hash.ops.
  // resolve_batch at max_probes = min(tsize, 64)).
  __device__ __forceinline__ int32_t probe(int32_t lv, int32_t u) const {
    uint32_t h = home(lv, u);
    const uint32_t tsize = (uint32_t)s.tsize;
    const uint32_t cap = tsize < PROBES ? tsize : PROBES;
    for (uint32_t t = 0; t < cap; ++t) {
      const int32_t a = __ldg(s.h_lv + h), b = __ldg(s.h_u + h),
                    p = __ldg(s.h_pos + h);
      if (a == lv && b == u) return p;
      if (p < 0) return -1;
      h = h + 1 == tsize ? 0 : h + 1;
    }
    return -1;
  }

  // --- the lookahead ------------------------------------------------------
  __device__ __forceinline__ Ahead fetch(const uint32_t* q,
                                         const int32_t* qpos, int32_t idx,
                                         int32_t slot) const {
    Ahead x;
    x.raw = load_msg(q + (size_t)slot * LANES);
    x.pre = qpos[slot];
    x.idx = idx;
    return x;
  }

  __device__ __forceinline__ static Ahead none() {
    Ahead x{};
    x.idx = -1;
    return x;
  }

  // Issue the loads of x's lookup: its receiver's adjacency bounds and,
  // with the edge hash and no position yet, the first 32 slots of its
  // probe.
  __device__ __forceinline__ Lookup start(const Ahead& x) const {
    const int32_t lv = (int32_t)dst_of(x.raw) - v0;
    const int32_t u = (int32_t)src_of(x.raw);
    Lookup k;
    k.a = __ldg(s.indptr + lv);
    k.b = __ldg(s.indptr + lv + 1);
    k.hl = -1; k.hu = -1; k.hp = 0; k.home = 0;
    if (METHOD == METHOD_HASH && x.pre < 0) {
      k.home = home(lv, u);
      if ((uint32_t)lane < (uint32_t)s.tsize) {
        const uint32_t slot = slot_at(k.home, lane);
        k.hl = __ldg(s.h_lv + slot); k.hu = __ldg(s.h_u + slot);
        k.hp = __ldg(s.h_pos + slot);
      }
    }
    return k;
  }

  // A prefetch hint (it reads nothing into a register) for each line of
  // r's burst: lane k < 10 the vertex word k of r.lv, lanes 10-13 se, nbr,
  // ewb and etb at r.p, lanes 16-23 the first window's se and nbr lines.
  __device__ __forceinline__ void hint(const Ready& r) const {
#ifdef __CUDA_ARCH__
    const int t = kind(r.raw);
    const bool scans = t == INITIATE || t == TEST || t == REJECT;
    const int32_t w = r.a + 32 * (lane & 3);
    const int32_t i = lane < 10 ? r.lv : lane < 14 ? r.p
                    : scans && w < r.b ? w : -1;
    if (hint_base != nullptr && i >= 0)
      asm volatile("prefetch.global.L1 [%0];" :: "l"(hint_base + i));
#endif
  }

  // This lane's array for hint().
  __device__ static const int32_t* hint_array(const Shard& s, int lane) {
    switch (lane) {
      case 0: return s.sn;
      case 1: return (const int32_t*)s.ln;
      case 2: return (const int32_t*)s.fnw;
      case 3: return (const int32_t*)s.fne;
      case 4: return s.find_count;
      case 5: return s.in_branch;
      case 6: return s.best_edge;
      case 7: return (const int32_t*)s.best_w;
      case 8: return (const int32_t*)s.best_e;
      case 9: return s.test_edge;
      case 10: return s.se;
      case 11: return s.nbr;
      case 12: return (const int32_t*)s.ewb;
      case 13: return (const int32_t*)s.etb;
      case 16: case 17: case 18: case 19: return s.se;
      case 20: case 21: case 22: case 23: return s.nbr;
      default: return nullptr;
    }
  }

  __device__ __forceinline__ Ready finish(const Ahead& x,
                                          const Lookup& k) const {
    Ready r;
    r.raw = x.raw;
    r.lv = (int32_t)dst_of(x.raw) - v0;
    r.u = (int32_t)src_of(x.raw);
    r.a = k.a;
    r.b = k.b;
    int32_t p = x.pre;
    if (p < 0) {
      if constexpr (METHOD == METHOD_HASH) {
        if (!probe_window(r.lv, r.u, 0, k.hl, k.hu, k.hp, p))
          p = probe_rest(r.lv, r.u, k.home, 32);
      } else if constexpr (METHOD == METHOD_LINEAR) {
        p = linear_find(k.a, k.b, r.u);
      } else {
        p = binary_find(k.a, k.b, r.u);
      }
    }
    r.miss = p < 0;
    r.p = p < 0 ? 0 : p;
    return r;
  }

  // --- scans --------------------------------------------------------------
  __device__ __forceinline__ Win load_win(int base, int b) const {
    Win w;
#pragma unroll
    for (int k = 0; k < SCAN_K; ++k) {
      const int q = base + 32 * k + lane;
      w.se[k] = q < b ? s.se[q] : OUTSIDE;
      w.nb[k] = q < b ? __ldg(s.nbr + q) : 0;
    }
    return w;
  }

  // The first edge of w (from base) in state `state`: sets q, nb once.
  __device__ __forceinline__ void first_in(const Win& w, int base,
                                           int32_t state, int32_t& q,
                                           int32_t& nb) const {
#pragma unroll
    for (int k = 0; k < SCAN_K; ++k) {
      const unsigned m = __ballot_sync(FULL, w.se[k] == state);
      if (q < 0 && m) {
        const int j = __ffs(m) - 1;
        q = base + 32 * k + j;
        nb = __shfl_sync(FULL, w.nb[k], j);
      }
    }
  }

  __device__ __forceinline__ void patch(Win& w, int base, int32_t q,
                                        int32_t val) const {
#pragma unroll
    for (int k = 0; k < SCAN_K; ++k)
      if (base + 32 * k + lane == q) w.se[k] = val;
  }

  template <class T>
  __device__ __forceinline__ static T pick(const T (&x)[SCAN_K], int k) {
    T r = x[0];
#pragma unroll
    for (int i = 1; i < SCAN_K; ++i)
      if (k == i) r = x[i];
    return r;
  }

  // h_initiate's walk: an Initiate to each Branch edge other than p, in
  // ascending position, from one send site.  Sends never write se, so a
  // window stays valid while its sends run.
  __device__ __forceinline__ void initiate_walk(Cur& m, uint32_t level,
                                                uint32_t state_bit,
                                                uint32_t fw, uint32_t fe) {
    const int a = m.c.a, b = m.c.b;
    for (int base = a; base < b; base += SCAN) {
      Win w;
      if (base == a) w = m.w0;
      else w = load_win(base, b);
      unsigned masks[SCAN_K];
#pragma unroll
      for (int k = 0; k < SCAN_K; ++k)
        masks[k] = __ballot_sync(
            FULL, w.se[k] == BRANCH && base + 32 * k + lane != m.c.p);
#pragma unroll 1
      for (int k = 0; k < SCAN_K; ++k) {
        unsigned mask = pick(masks, k);
        const int32_t nb = pick(w.nb, k);
        while (mask) {
          const int32_t dst = __shfl_sync(FULL, nb, __ffs(mask) - 1);
          mask &= mask - 1;
          push(encode(INITIATE, level, state_bit, (uint32_t)(v0 + m.c.lv),
                      (uint32_t)dst, fw, fe),
               dst, false, POS_UNRESOLVED);
          if (state_bit == 1) m.v.find_count += 1;
        }
      }
    }
  }

  // --- dispatch and the queues --------------------------------------------
  __device__ __forceinline__ static int kind(const Msg<LANES>& raw) {
    const int32_t t = (int32_t)mtype_of(raw);
    return t < 0 ? 0 : t > 6 ? 6 : t;
  }

  // The burst: every word of c's vertex and edge the handler may read, and
  // the first scan window of a message that may scan, loaded together.
  __device__ __forceinline__ Cur load(const Ready& c) const {
    Cur m;
    m.c = c;
    const int32_t lv = c.lv, p = c.p;
    m.v.sn = s.sn[lv]; m.v.ln = s.ln[lv]; m.v.fnw = s.fnw[lv];
    m.v.fne = s.fne[lv]; m.v.find_count = s.find_count[lv];
    m.v.in_branch = s.in_branch[lv]; m.v.best_edge = s.best_edge[lv];
    m.v.best_w = s.best_w[lv]; m.v.best_e = s.best_e[lv];
    m.v.test_edge = s.test_edge[lv];
    m.sp = s.se[p];
    m.nbr_p = __ldg(s.nbr + p);
    m.ewb_p = __ldg(s.ewb + p);
    m.etb_p = __ldg(s.etb + p);
    const int t = kind(c.raw);
    const bool scans = t == INITIATE || t == TEST || t == REJECT;
    m.w0 = load_win(c.a, scans ? c.b : c.a);
    return m;
  }

  __device__ __forceinline__ void write_back(const Cur& m, const Vtx& o)
      const {
    if (lane != 0) return;
    const Vtx& v = m.v;
    const int32_t lv = m.c.lv;
    if (v.sn != o.sn) s.sn[lv] = v.sn;
    if (v.ln != o.ln) s.ln[lv] = v.ln;
    if (v.fnw != o.fnw) s.fnw[lv] = v.fnw;
    if (v.fne != o.fne) s.fne[lv] = v.fne;
    if (v.find_count != o.find_count) s.find_count[lv] = v.find_count;
    if (v.in_branch != o.in_branch) s.in_branch[lv] = v.in_branch;
    if (v.best_edge != o.best_edge) s.best_edge[lv] = v.best_edge;
    if (v.best_w != o.best_w) s.best_w[lv] = v.best_w;
    if (v.best_e != o.best_e) s.best_e[lv] = v.best_e;
    if (v.test_edge != o.test_edge) s.test_edge[lv] = v.test_edge;
  }

  // One message: its handler (GHS's responses to Connect, Initiate, Test,
  // Accept, Reject, Report and Change-core), then its tail, in order:
  // test_proc (GHS (4)), report_proc (GHS (8)), change_core (GHS (10)),
  // the last message out.  Every handler ends in these, so each is one
  // copy of code; all but h_initiate's walk send at most one message, the
  // last thing they do.
  __device__ __forceinline__ void dispatch(Cur& m) {
    const Msg<LANES>& raw = m.c.raw;
    uint32_t level, state_bit, fw, fe;
    if constexpr (LANES == 5) {
      const uint32_t hdr = raw.w[0];
      level = hdr >> 4; state_bit = (hdr >> 3) & 1;
      fw = raw.w[3]; fe = raw.w[4];
    } else {
      level = raw.w[1]; state_bit = raw.w[2]; fw = raw.w[5]; fe = raw.w[6];
    }
    Vtx& v = m.v;
    const Vtx o = v;
    const int32_t lv = m.c.lv, u = m.c.u, p = m.c.p, me = v0 + lv;
    // The in_branch's neighbour, for a report: a load on the vertex words,
    // issued before the tail needs it.
    const int32_t ib_nbr = __ldg(s.nbr + (o.in_branch >= 0 ? o.in_branch : 0));
    if (m.c.miss) err |= ERR_HASH_MISS;
    int out = OUT_NONE, then = 0;
    bool productive = true, to_test = false;
    uint32_t o_type = 0, o_level = 0, o_state = 0, o_fw = 0, o_fe = 0;
    int32_t o_dst = 0;
    switch (kind(raw)) {
      case CONNECT:
        if (level < v.ln) {                             // absorb
          set_se(p, BRANCH);
          const bool im_find = v.sn == FIND;
          out = OUT_SEND; o_type = INITIATE; o_level = v.ln;
          o_state = im_find ? 1 : 0; o_dst = u; o_fw = v.fnw; o_fe = v.fne;
          if (im_find) v.find_count += 1;
        } else if (m.sp != BASIC) {                     // merge
          out = OUT_SEND; o_type = INITIATE; o_level = v.ln + 1;
          o_state = 1; o_dst = u; o_fw = m.ewb_p; o_fe = m.etb_p;
        } else {                                        // postpone
          out = OUT_POSTPONE;
          productive = false;
        }
        break;
      case INITIATE:
        v.ln = level;
        v.fnw = fw;
        v.fne = fe;
        v.sn = state_bit == 1 ? FIND : FOUND;
        v.in_branch = p;
        v.best_edge = -1;
        v.best_w = INF;
        v.best_e = INF;
        initiate_walk(m, level, state_bit, fw, fe);
        if (state_bit == 1) then = THEN_TEST;
        break;
      case TEST:
        if (level > v.ln) {                             // postpone
          out = OUT_POSTPONE;
          to_test = RELAXED;
          productive = false;
        } else if (fw != v.fnw || fe != v.fne) {
          out = OUT_SEND; o_type = ACCEPT; o_dst = u;
        } else {
          if (m.sp == BASIC) {
            set_se(p, REJECTED);
            patch(m.w0, m.c.a, p, REJECTED);
          }
          if (v.test_edge == p) {
            then = THEN_TEST;
          } else {
            out = OUT_SEND; o_type = REJECT; o_dst = u;
          }
        }
        break;
      case ACCEPT: {
        v.test_edge = -1;
        const uint32_t w = m.ewb_p, e = m.etb_p;
        if (w < v.best_w || (w == v.best_w && e < v.best_e)) {
          v.best_edge = p;
          v.best_w = w;
          v.best_e = e;
        }
        then = THEN_REPORT;
        break;
      }
      case REJECT:
        if (m.sp == BASIC) {
          set_se(p, REJECTED);
          patch(m.w0, m.c.a, p, REJECTED);
        }
        then = THEN_TEST;
        break;
      case REPORT:
        if (p != v.in_branch) {                         // non-core child
          v.find_count -= 1;
          if (fw < v.best_w || (fw == v.best_w && fe < v.best_e)) {
            v.best_edge = p;
            v.best_w = fw;
            v.best_e = fe;
          }
          then = THEN_REPORT;
        } else if (v.sn == FIND) {                      // postpone
          out = OUT_POSTPONE;
          productive = false;
        } else if (v.best_w < fw || (v.best_w == fw && v.best_e < fe)) {
          then = THEN_CORE;
        } else if (fw == INF && fe == INF && v.best_w == INF &&
                   v.best_e == INF) {
          ++halted;
        }
        break;
      default: then = THEN_CORE; break;                 // Change-core
    }
    if (then & THEN_TEST) {                             // GHS (4)
      const int a = m.c.a, b = m.c.b;
      int32_t q = -1, nb = 0;
      first_in(m.w0, a, BASIC, q, nb);
      for (int base = a + SCAN; q < 0 && base < b; base += SCAN) {
        __syncwarp();           // the handler's edge state store
        first_in(load_win(base, b), base, BASIC, q, nb);
      }
      v.test_edge = q;
      if (q >= 0) {
        out = OUT_SEND; o_type = TEST; o_level = v.ln; o_dst = nb;
        o_fw = v.fnw; o_fe = v.fne;
      } else {
        then |= THEN_REPORT;
      }
    }
    if ((then & THEN_REPORT) && v.find_count == 0 && v.test_edge == -1 &&
        v.in_branch >= 0) {                             // GHS (8)
      v.sn = FOUND;
      out = OUT_SEND; o_type = REPORT; o_level = v.ln;
      o_dst = v.in_branch == p ? m.nbr_p : ib_nbr;
      o_fw = v.best_w; o_fe = v.best_e;
    }
    if (then & THEN_CORE) {                             // GHS (10)
      const int32_t be = v.best_edge;
      if (be < 0) {
        err |= ERR_LOGIC;
      } else {
        const int32_t state = s.se[be], nb = __ldg(s.nbr + be);
        __syncwarp();           // every lane has read se[be]
        out = OUT_SEND; o_dst = nb;
        if (state == BRANCH) {
          o_type = CHANGE_CORE;
        } else {
          o_type = CONNECT; o_level = v.ln;
          set_se(be, BRANCH);
        }
      }
    }
    if (out == OUT_SEND)
      push(encode(o_type, o_level, o_state, (uint32_t)me, (uint32_t)o_dst,
                  o_fw, o_fe),
           o_dst, RELAXED && o_type == TEST, POS_UNRESOLVED);
    else if (out == OUT_POSTPONE)
      push(raw, me, to_test, p);
    write_back(m, o);
    ++n_processed;
    n_productive += productive ? 1 : 0;
  }

  // Pop the main queue (tq false: while it holds messages, under `bound`
  // pops, with no error) or the Test queue (tq true: up to the index
  // `bound`, with no error), a message at a time, three messages of
  // lookahead on the static data and the queued words.
  __device__ __forceinline__ void drain(bool tq, int32_t bound) {
    const uint32_t* q = tq ? s.tq : s.mq;
    const int32_t* qpos = tq ? s.tq_pos : s.mq_pos;
    Ready rc{};                          // the message at head, resolved
    int32_t rc_idx = -1;
    Ahead nx = none(), nn = none();      // head + 1 (lookup in flight), + 2
    Lookup look{};
    for (int32_t n = 0;; ++n) {
      const int32_t idx = tq ? tq_head : mq_head;
      const int32_t tail = tq ? tq_tail : mq_tail;
      if (!(tq ? idx < bound : idx < tail && n < bound) || err != 0) break;
      __syncwarp();                      // the last message's stores
      const int32_t slot = tq ? tq_hs : mq_hs;
      Ready c;
      if (rc_idx == idx) {
        c = rc;
      } else {                           // not queued when looked ahead
        const Ahead x = fetch(q, qpos, idx, slot);
        c = finish(x, start(x));
      }
      const int32_t next = next_slot(slot), next2 = next_slot(next);
      if (tq) {
        ++tq_head;
        tq_hs = next;
      } else {
        ++mq_head;
        mq_hs = next;
      }
      Cur m = load(c);
      __syncwarp();                      // every lane's loads before a store
      // The lookahead while m is handled: message idx + 1 resolved to its
      // edge and its burst's lines prefetched (a hint), idx + 2's lookup
      // issued, idx + 3's words loaded.  It reads static words, and queued
      // slots that only an overflowing push (which stops the loop)
      // rewrites.
      const int32_t upto = tq && bound < tail ? bound : tail;
      rc_idx = -1;
      if (nx.idx == idx + 1) {
        rc = finish(nx, look);
        rc_idx = nx.idx;
        hint(rc);
      }
      if (nn.idx == idx + 2) nx = nn;
      else if (idx + 2 < upto) nx = fetch(q, qpos, idx + 2, next2);
      else nx = none();
      if (nx.idx >= 0) look = start(nx);
      nn = idx + 3 < upto ? fetch(q, qpos, idx + 3, next_slot(next2))
                          : none();
      dispatch(m);
    }
  }

  // The inbox into the queues, source shard 0 first, each block in row
  // order: up to 32 messages at once (no more than qcap, so a batch never
  // writes one queue slot twice), each lane probing and storing its own.
  __device__ __forceinline__ void ingest() {
    const int width = s.qcap < 32 ? s.qcap : 32;
    const unsigned below = (1u << lane) - 1;
    for (int src_shard = 0; src_shard < S; ++src_shard) {
      int cnt = s.in_cnt[src_shard];
      cnt = cnt < 0 ? 0 : cnt > s.xcap ? s.xcap : cnt;
      const uint32_t* block_rows =
          s.inbox + (size_t)src_shard * s.xcap * LANES;
      for (int c0 = 0; c0 < cnt; c0 += width) {
        const int c = c0 + lane;
        const bool valid = lane < width && c < cnt;
        Msg<LANES> raw{};
        int32_t pre = POS_UNRESOLVED;
        bool is_test = false;
        if (valid) {
          raw = load_msg(block_rows + (size_t)c * LANES);
          is_test = RELAXED && mtype_of(raw) == TEST;
          if constexpr (METHOD == METHOD_HASH) {
            const int32_t p = probe((int32_t)dst_of(raw) - v0,
                                    (int32_t)src_of(raw));
            if (p >= 0) pre = p;
          }
        }
        const unsigned tests = __ballot_sync(FULL, valid && is_test);
        const unsigned mains = __ballot_sync(FULL, valid && !is_test);
        if (valid) {
          if (is_test) {
            const int slot = (tq_tail + __popc(tests & below)) % s.qcap;
#pragma unroll
            for (int k = 0; k < LANES; ++k)
              s.tq[(size_t)slot * LANES + k] = raw.w[k];
            s.tq_pos[slot] = pre;
          } else {
            const int slot = (mq_tail + __popc(mains & below)) % s.qcap;
#pragma unroll
            for (int k = 0; k < LANES; ++k)
              s.mq[(size_t)slot * LANES + k] = raw.w[k];
            s.mq_pos[slot] = pre;
          }
        }
        tq_tail += __popc(tests);
        mq_tail += __popc(mains);
      }
      __syncwarp();                      // every lane has read the count
      if (lane == 0) s.in_cnt[src_shard] = 0;
    }
    mq_ts = mq_tail % s.qcap;
    tq_ts = tq_tail % s.qcap;
    if (mq_tail - mq_head > s.qcap || tq_tail - tq_head > s.qcap)
      err |= ERR_QUEUE_OVERFLOW;
    __syncwarp();
  }

  // The shard's part of a superstep before the exchange, on warp 0: up to
  // xcap messages off each outgoing ring, their ring head and count
  // published in the scratch row of this source shard.  The main queue
  // is popped under a budget fixed at entry, then (C1) the Test queue up
  // to its tail at entry, by one loop.
  __device__ __forceinline__ void own_part(bool do_test, int32_t* xhead,
                                           int32_t* xcount) {
    ingest();
    const int passes = RELAXED && do_test ? 2 : 1;
#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass)
      drain(pass == 1, pass == 1 ? tq_tail : 2 * (mq_tail - mq_head) + 64);
    __syncwarp();
    for (int d = lane; d < S; d += 32) {
      const int avail = og_t[d] - og_h[d];
      const int k = avail < s.xcap ? avail : s.xcap;
      xhead[d] = og_h[d];
      xcount[d] = k;
      og_h[d] += k;
    }
    __syncwarp();
  }

  // Messages the shard still holds after the exchange (its received
  // counts are `received`).
  __device__ __forceinline__ int32_t activity(int32_t received) const {
    int32_t a = (mq_tail - mq_head) + (tq_tail - tq_head) + received;
    for (int d = 0; d < S; ++d) a += og_t[d] - og_h[d];
    return a;
  }
};

// The exchange into shard d (this block), on all the block's threads: its
// inbox block s takes the count xcount[s][d] of messages from shard s's
// ring for d at head xhead[s][d], zeros past them up to the rows that may
// hold words, which become the counts.  Returns the messages received
// (the same on every thread).
template <int LANES>
__device__ int exchange_into(const Shard& all, const Shard& me, int d,
                             const int32_t* xhead, const int32_t* xcount,
                             int32_t* rows) {
  const int S = all.num_shards;
  int received = 0;
  for (int src = 0; src < S; ++src) {
    const int k = __ldcg(xcount + src * S + d);
    const int head = __ldcg(xhead + src * S + d);
    const int upto = k > rows[src] ? k : rows[src];
    const uint32_t* ring = all.og + ((size_t)src * S + d) * all.ocap * LANES;
    uint32_t* out = me.inbox + (size_t)src * all.xcap * LANES;
    for (int i = threadIdx.x; i < upto * LANES; i += blockDim.x) {
      const int c = i / LANES, w = i - c * LANES;
      out[i] = c < k ? __ldcg(ring + (size_t)((head + c) % all.ocap) *
                                          LANES + w)
                     : 0u;
    }
    received += k;
    __syncthreads();              // every thread has read rows[src]
    if (threadIdx.x == 0) {
      rows[src] = k;
      me.in_cnt[src] = k;
    }
  }
  return received;
}

__device__ __forceinline__ void barrier(cg::grid_group& grid) {
  if (gridDim.x > 1) grid.sync();
  else __syncthreads();
}

template <int METHOD, int LANES, bool RELAXED>
__global__ void ghs_interval(const Shard all) {
  cg::grid_group grid = cg::this_grid();
  const int my = blockIdx.x, S = all.num_shards;
  const Shard me = all.at(my, LANES);
  extern __shared__ int32_t smem[];
  const Smem sm{smem, smem + S, smem + 2 * S};
  __shared__ int32_t sums[2];   // the superstep's activity and error sums
  int32_t* xhead = all.xchg;                 // [source][destination]
  int32_t* xcount = all.xchg + S * S;
  int32_t* xact = all.xchg + 2 * S * S;      // [parity][shard]
  int32_t* xerr = xact + 2 * S;

  // The inbox rows of each source block that may hold a nonzero word,
  // found by the whole block; the ring heads and tails into shared memory.
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    sm.rows[i] = 0;
    sm.og_h[i] = me.og_head[i];
    sm.og_t[i] = me.og_tail[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * all.xcap * LANES; i += blockDim.x)
    if (me.inbox[i] != 0) {
      const int row = i / LANES;
      atomicMax(&sm.rows[row / all.xcap], row % all.xcap + 1);
    }
  __syncthreads();

  Loop<METHOD, LANES, RELAXED> loop(me, my, sm);
  const int32_t step0 = all.scal_in[0];
  int32_t i = 0, silent = all.scal_in[1], err = 0;
  while (i < all.n_steps && silent < all.empty_needed && err == 0) {
    const int32_t gstep = step0 + i;
    if (threadIdx.x < 32)
      loop.own_part(gstep % all.check == all.check - 1, xhead + my * S,
                    xcount + my * S);
    barrier(grid);
    const int received = exchange_into<LANES>(all, me, my, xhead, xcount,
                                              sm.rows);
    const int parity = gstep & 1;
    if (threadIdx.x == 0) {
      xact[parity * S + my] = loop.activity(received);
      xerr[parity * S + my] = loop.err;
    }
    barrier(grid);
    if (threadIdx.x == 0) {
      int32_t act = 0, e = 0;
      for (int d = 0; d < S; ++d) {
        act += __ldcg(xact + parity * S + d);
        e += __ldcg(xerr + parity * S + d);
      }
      sums[0] = act;
      sums[1] = e;
      if (gstep >= 0 && gstep < all.hcap) {
        me.hist_act[gstep] = act;
        me.hist_sent[gstep] = loop.n_sent_remote;
      }
    }
    __syncthreads();
    silent = sums[0] == 0 ? silent + 1 : 0;
    err = sums[1];
    ++i;
    __syncthreads();              // sums is rewritten next superstep
  }
  if (threadIdx.x == 0) {
    loop.store();
    if (my == 0) {
      all.scal_out[0] = step0 + i;
      all.scal_out[1] = silent;
      all.scal_out[2] = err;
    }
  }
}

template <int METHOD, int LANES, bool RELAXED>
const void* instance() {
  return (const void*)ghs_interval<METHOD, LANES, RELAXED>;
}

template <int METHOD>
const void* by_relaxed_lanes(int lanes, int relaxed) {
  if (lanes == 5)
    return relaxed ? instance<METHOD, 5, true>() : instance<METHOD, 5, false>();
  if (lanes == 8)
    return relaxed ? instance<METHOD, 8, true>() : instance<METHOD, 8, false>();
  return nullptr;
}

const void* kernel_of(int method, int lanes, int relaxed) {
  switch (method) {
    case METHOD_HASH: return by_relaxed_lanes<METHOD_HASH>(lanes, relaxed);
    case METHOD_LINEAR:
      return by_relaxed_lanes<METHOD_LINEAR>(lanes, relaxed);
    case METHOD_BINARY:
      return by_relaxed_lanes<METHOD_BINARY>(lanes, relaxed);
    default: return nullptr;
  }
}

size_t smem_bytes(int num_shards) { return 3 * sizeof(int32_t) * num_shards; }

}  // namespace

extern "C" {

// Blocks of `threads` threads the instance can hold at once on card
// `device` for S = num_shards (its dynamic shared memory), in one
// cooperative grid; 0 if the card cannot launch cooperatively.
int ghs_superstep_capacity(int method, int lanes, int relaxed, int threads,
                           int num_shards, int device, int* blocks) {
  *blocks = 0;
  const void* k = kernel_of(method, lanes, relaxed);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int sms = 0, coop = 0, per_sm = 0, current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k, threads, smem_bytes(num_shards));
  cudaSetDevice(current);
  if (err == cudaSuccess && coop) *blocks = sms * per_sm;
  return (int)err;
}

// One cooperative launch of s->num_shards blocks of `threads` threads;
// the caller has checked the grid against ghs_superstep_capacity.
int ghs_superstep_interval(const Shard* s, int method, int lanes, int relaxed,
                           int threads, void* stream) {
  const void* k = kernel_of(method, lanes, relaxed);
  if (k == nullptr || s->num_shards < 1) return (int)cudaErrorInvalidValue;
  Shard arg = *s;
  void* args[] = {&arg};
  return (int)cudaLaunchCooperativeKernel(
      k, dim3(s->num_shards), dim3(threads), args,
      smem_bytes(s->num_shards), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
