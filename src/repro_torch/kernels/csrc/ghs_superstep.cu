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
// One superstep.  Thread 0 of block s runs shard s's own part: ingest its
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
// reads what the previous ones wrote, so one thread runs a shard's loop
// and every step is a dependent load (the message, its edge's hash slots,
// the vertex's state, the edge states).  The bytes an interval touches are
// few; the time is the chain of load latencies, of the slowest shard a
// superstep, plus two grid barriers a superstep.  The design keeps what it
// can off that chain: the queue heads and tails, the counters and the
// error word live in registers (the S ring heads and tails in shared
// memory) for the launch; the three hash words of a slot are loaded
// together; the static arrays are read through the read-only path; the
// exchange runs on all the block's threads and rewrites only the inbox
// rows that may hold words (found by the block once at entry).  The
// lookup method, the lane count and relaxed_test_queue are template
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

template <int LANES>
struct Msg {
  uint32_t w[LANES];
};

__device__ __forceinline__ int floordiv(int a, int b) {   // b > 0, as jnp's
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Shared memory of a block: its shard's S ring heads and tails, and the
// inbox rows of each source block that may hold a nonzero word.
struct Smem {
  int32_t* og_h;
  int32_t* og_t;
  int32_t* rows;
};

template <int METHOD, int LANES, bool RELAXED>
struct Loop {
  const Shard& s;       // this block's shard
  const int my;         // its index
  const int S;
  const int32_t v0;     // its first global vertex id
  int32_t* og_h;        // shared: ring heads and tails, one a destination
  int32_t* og_t;
  int32_t mq_head, mq_tail, tq_head, tq_tail;
  int32_t err, halted, n_processed, n_productive, n_sent_remote,
      n_sent_local;

  __device__ Loop(const Shard& shard, int me, const Smem& sm)
      : s(shard), my(me), S(shard.num_shards), v0(shard.block * me),
        og_h(sm.og_h), og_t(sm.og_t), mq_head(*shard.mq_head),
        mq_tail(*shard.mq_tail), tq_head(*shard.tq_head),
        tq_tail(*shard.tq_tail), err(*shard.err), halted(*shard.halted),
        n_processed(*shard.n_processed), n_productive(*shard.n_productive),
        n_sent_remote(*shard.n_sent_remote),
        n_sent_local(*shard.n_sent_local) {}

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

  __device__ __forceinline__ static void store_msg(uint32_t* row,
                                                   const Msg<LANES>& m) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) row[k] = m.w[k];
  }

  // Queue m for dst (an int32): the local main or Test queue, or the
  // outgoing ring of its shard.  A full ring's slot is overwritten and its
  // tail still advances; the overflow flag is set after the write.
  __device__ __forceinline__ void push(const Msg<LANES>& m, int32_t dst,
                                       bool is_test, int32_t pos) {
    const int ds = floordiv(dst, s.block);
    if (ds == my) {
      ++n_sent_local;
      if (is_test) {
        const int slot = tq_tail % s.qcap;
        store_msg(s.tq + (size_t)slot * LANES, m);
        s.tq_pos[slot] = pos;
        ++tq_tail;
      } else {
        const int slot = mq_tail % s.qcap;
        store_msg(s.mq + (size_t)slot * LANES, m);
        s.mq_pos[slot] = pos;
        ++mq_tail;
      }
    } else {
      // Ring row ds: a negative row from -S wraps, any other outside
      // [0, S) is dropped; the tail of row ds mod S advances either way.
      // Only that row's fill can have grown.
      const int r = ds - floordiv(ds, S) * S;
      if (ds >= -S && ds < S)
        store_msg(s.og + ((size_t)r * s.ocap + og_t[r] % s.ocap) * LANES,
                  m);
      ++og_t[r];
      ++n_sent_remote;
      if (og_t[r] - og_h[r] > s.ocap) err |= ERR_QUEUE_OVERFLOW;
    }
    if (mq_tail - mq_head > s.qcap || tq_tail - tq_head > s.qcap)
      err |= ERR_QUEUE_OVERFLOW;
  }

  __device__ __forceinline__ void send(int mtype, uint32_t level,
                                       uint32_t state, int32_t src,
                                       int32_t dst, uint32_t fw,
                                       uint32_t fe) {
    push(encode(mtype, level, state, (uint32_t)src, (uint32_t)dst, fw, fe),
         dst, RELAXED && mtype == TEST, POS_UNRESOLVED);
  }

  // --- edge lookup (C2 and the ablations) ---------------------------------
  __device__ __forceinline__ uint32_t home(int32_t lv, int32_t u) const {
    return (((uint32_t)lv * HASH_K1) ^ ((uint32_t)u * HASH_K2)) %
           (uint32_t)s.tsize;
  }

  __device__ __forceinline__ int32_t lookup(int32_t lv, int32_t u) const {
    if constexpr (METHOD == METHOD_HASH) {
      // The reference walks until a hit or an empty slot, at most tsize
      // slots, then rechecks the hit at the slot it stopped on: the
      // answer is that slot's hit.
      uint32_t h = home(lv, u);
      const uint32_t tsize = (uint32_t)s.tsize;
      for (uint32_t steps = 0; steps < tsize; ++steps) {
        const int32_t a = __ldg(s.h_lv + h), b = __ldg(s.h_u + h),
                      p = __ldg(s.h_pos + h);
        const bool hit = a == lv && b == u;
        if (hit) return p;
        if (p < 0) return -1;
        h = h + 1 == tsize ? 0 : h + 1;
      }
      return -1;
    } else if constexpr (METHOD == METHOD_LINEAR) {
      const int a = __ldg(s.indptr + lv), b = __ldg(s.indptr + lv + 1);
      for (int q = a; q < b; ++q)
        if (__ldg(s.nbr + q) == u) return q;
      return -1;
    } else {
      const int a = __ldg(s.indptr + lv), b = __ldg(s.indptr + lv + 1);
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
  }

  // The ingest pre-pass for one lane (edge_hash.ops.resolve_batch at
  // max_probes = min(tsize, 64)).
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

  // --- GHS procedures -----------------------------------------------------
  __device__ __forceinline__ void report_proc(int32_t lv) {   // GHS (8)
    const int32_t ib = s.in_branch[lv];
    if (s.find_count[lv] == 0 && s.test_edge[lv] == -1 && ib >= 0) {
      s.sn[lv] = FOUND;
      send(REPORT, s.ln[lv], 0, v0 + lv, __ldg(s.nbr + ib), s.best_w[lv],
           s.best_e[lv]);
    }
  }

  __device__ __forceinline__ void change_core(int32_t lv) {    // GHS (10)
    const int32_t be = s.best_edge[lv];
    if (be < 0) {
      err |= ERR_LOGIC;
      return;
    }
    if (s.se[be] == BRANCH) {
      send(CHANGE_CORE, 0, 0, v0 + lv, __ldg(s.nbr + be), 0, 0);
    } else {
      send(CONNECT, s.ln[lv], 0, v0 + lv, __ldg(s.nbr + be), 0, 0);
      s.se[be] = BRANCH;
    }
  }

  __device__ __forceinline__ void test_proc(int32_t lv) {      // GHS (4)
    const int a = __ldg(s.indptr + lv), b = __ldg(s.indptr + lv + 1);
    int q = a;
    while (q < b && s.se[q] != BASIC) ++q;
    if (q < b) {
      s.test_edge[lv] = q;
      send(TEST, s.ln[lv], 0, v0 + lv, __ldg(s.nbr + q), s.fnw[lv],
           s.fne[lv]);
    } else {
      s.test_edge[lv] = -1;
      report_proc(lv);
    }
  }

  // --- handlers: return whether the message was productive ---------------
  __device__ __forceinline__ bool h_connect(int32_t u, int32_t lv, int32_t p,
                                            uint32_t level,
                                            const Msg<LANES>& raw) {
    const uint32_t ln = s.ln[lv];
    if (level < ln) {                                   // absorb
      s.se[p] = BRANCH;
      const bool im_find = s.sn[lv] == FIND;
      send(INITIATE, ln, im_find ? 1 : 0, v0 + lv, u, s.fnw[lv], s.fne[lv]);
      if (im_find) s.find_count[lv] += 1;
      return true;
    }
    if (s.se[p] != BASIC) {                             // merge
      send(INITIATE, ln + 1, 1, v0 + lv, u, __ldg(s.ewb + p),
           __ldg(s.etb + p));
      return true;
    }
    push(raw, v0 + lv, false, p);                       // postpone
    return false;
  }

  __device__ __forceinline__ bool h_initiate(int32_t lv, int32_t p,
                                             uint32_t level,
                                             uint32_t state_bit, uint32_t fw,
                                             uint32_t fe) {
    s.ln[lv] = level;
    s.fnw[lv] = fw;
    s.fne[lv] = fe;
    s.sn[lv] = state_bit == 1 ? FIND : FOUND;
    s.in_branch[lv] = p;
    s.best_edge[lv] = -1;
    s.best_w[lv] = INF;
    s.best_e[lv] = INF;
    const int a = __ldg(s.indptr + lv), b = __ldg(s.indptr + lv + 1);
    for (int q = a; q < b; ++q) {
      if (s.se[q] == BRANCH && q != p) {
        send(INITIATE, level, state_bit, v0 + lv, __ldg(s.nbr + q), fw, fe);
        if (state_bit == 1) s.find_count[lv] += 1;
      }
    }
    if (state_bit == 1) test_proc(lv);
    return true;
  }

  __device__ __forceinline__ bool h_test(int32_t u, int32_t lv, int32_t p,
                                         uint32_t level, uint32_t fw,
                                         uint32_t fe, const Msg<LANES>& raw) {
    if (level > s.ln[lv]) {                             // postpone
      push(raw, v0 + lv, RELAXED, p);
      return false;
    }
    if (fw != s.fnw[lv] || fe != s.fne[lv]) {
      send(ACCEPT, 0, 0, v0 + lv, u, 0, 0);
      return true;
    }
    if (s.se[p] == BASIC) s.se[p] = REJECTED;
    if (s.test_edge[lv] == p) test_proc(lv);
    else send(REJECT, 0, 0, v0 + lv, u, 0, 0);
    return true;
  }

  __device__ __forceinline__ bool h_accept(int32_t lv, int32_t p) {
    s.test_edge[lv] = -1;
    const uint32_t w = __ldg(s.ewb + p), e = __ldg(s.etb + p);
    const uint32_t bw = s.best_w[lv], be = s.best_e[lv];
    if (w < bw || (w == bw && e < be)) {
      s.best_edge[lv] = p;
      s.best_w[lv] = w;
      s.best_e[lv] = e;
    }
    report_proc(lv);
    return true;
  }

  __device__ __forceinline__ bool h_reject(int32_t lv, int32_t p) {
    if (s.se[p] == BASIC) s.se[p] = REJECTED;
    test_proc(lv);
    return true;
  }

  __device__ __forceinline__ bool h_report(int32_t lv, int32_t p, uint32_t fw,
                                           uint32_t fe,
                                           const Msg<LANES>& raw) {
    if (p != s.in_branch[lv]) {                         // non-core child
      s.find_count[lv] -= 1;
      const uint32_t bw = s.best_w[lv], be = s.best_e[lv];
      if (fw < bw || (fw == bw && fe < be)) {
        s.best_edge[lv] = p;
        s.best_w[lv] = fw;
        s.best_e[lv] = fe;
      }
      report_proc(lv);
      return true;
    }
    if (s.sn[lv] == FIND) {                             // postpone
      push(raw, v0 + lv, false, p);
      return false;
    }
    const uint32_t bw = s.best_w[lv], be = s.best_e[lv];
    if (bw < fw || (bw == fw && be < fe)) change_core(lv);
    else if (fw == INF && fe == INF && bw == INF && be == INF) ++halted;
    return true;
  }

  // --- dispatch and the queues --------------------------------------------
  __device__ __forceinline__ void dispatch(const Msg<LANES>& raw,
                                           int32_t pre) {
    uint32_t mtype, level, state_bit, src, dst, fw, fe;
    if constexpr (LANES == 5) {
      const uint32_t hdr = raw.w[0];
      mtype = hdr & 7; level = hdr >> 4; state_bit = (hdr >> 3) & 1;
      src = raw.w[1]; dst = raw.w[2]; fw = raw.w[3]; fe = raw.w[4];
    } else {
      mtype = raw.w[0]; level = raw.w[1]; state_bit = raw.w[2];
      src = raw.w[3]; dst = raw.w[4]; fw = raw.w[5]; fe = raw.w[6];
    }
    const int32_t lv = (int32_t)dst - v0, u = (int32_t)src;
    int32_t p = pre >= 0 ? pre : lookup(lv, u);
    if (p < 0) {
      err |= ERR_HASH_MISS;
      p = 0;
    }
    const int32_t t = (int32_t)mtype;
    bool productive;
    switch (t < 0 ? 0 : t > 6 ? 6 : t) {
      case CONNECT: productive = h_connect(u, lv, p, level, raw); break;
      case INITIATE:
        productive = h_initiate(lv, p, level, state_bit, fw, fe);
        break;
      case TEST: productive = h_test(u, lv, p, level, fw, fe, raw); break;
      case ACCEPT: productive = h_accept(lv, p); break;
      case REJECT: productive = h_reject(lv, p); break;
      case REPORT: productive = h_report(lv, p, fw, fe, raw); break;
      default: change_core(lv); productive = true; break;
    }
    ++n_processed;
    n_productive += productive ? 1 : 0;
  }

  __device__ __forceinline__ void process_main() {
    // Budget fixed at entry: the queue snapshot plus slack.
    const int32_t budget = 2 * (mq_tail - mq_head) + 64;
    for (int32_t n = 0; mq_head < mq_tail && n < budget && err == 0; ++n) {
      const int slot = mq_head % s.qcap;
      const Msg<LANES> raw = load_msg(s.mq + (size_t)slot * LANES);
      const int32_t pre = s.mq_pos[slot];
      ++mq_head;
      dispatch(raw, pre);
    }
  }

  __device__ __forceinline__ void process_test_q() {
    const int32_t snapshot = tq_tail;
    while (tq_head < snapshot && err == 0) {
      const int slot = tq_head % s.qcap;
      const Msg<LANES> raw = load_msg(s.tq + (size_t)slot * LANES);
      const int32_t pre = s.tq_pos[slot];
      ++tq_head;
      dispatch(raw, pre);
    }
  }

  // The inbox into the queues, source shard 0 first, each block in row
  // order.
  __device__ __forceinline__ void ingest() {
    for (int src_shard = 0; src_shard < S; ++src_shard) {
      int cnt = s.in_cnt[src_shard];
      cnt = cnt < 0 ? 0 : cnt > s.xcap ? s.xcap : cnt;
      const uint32_t* block_rows =
          s.inbox + (size_t)src_shard * s.xcap * LANES;
      for (int c = 0; c < cnt; ++c) ingest_one(
          load_msg(block_rows + (size_t)c * LANES));
      s.in_cnt[src_shard] = 0;
    }
    if (mq_tail - mq_head > s.qcap || tq_tail - tq_head > s.qcap)
      err |= ERR_QUEUE_OVERFLOW;
  }

  __device__ __forceinline__ void ingest_one(const Msg<LANES>& raw) {
      const uint32_t mtype = LANES == 5 ? raw.w[0] & 7 : raw.w[0];
      const uint32_t src = LANES == 5 ? raw.w[1] : raw.w[3];
      const uint32_t dst = LANES == 5 ? raw.w[2] : raw.w[4];
      int32_t pre = POS_UNRESOLVED;
      if constexpr (METHOD == METHOD_HASH) {
        const int32_t p = probe((int32_t)dst - v0, (int32_t)src);
        if (p >= 0) pre = p;
      }
      if (RELAXED && mtype == TEST) {
        const int slot = tq_tail % s.qcap;
        store_msg(s.tq + (size_t)slot * LANES, raw);
        s.tq_pos[slot] = pre;
        ++tq_tail;
      } else {
        const int slot = mq_tail % s.qcap;
        store_msg(s.mq + (size_t)slot * LANES, raw);
        s.mq_pos[slot] = pre;
        ++mq_tail;
      }
  }

  // The shard's part of a superstep before the exchange: up to xcap
  // messages off each outgoing ring, their ring head and count published
  // in the scratch row of this source shard.
  __device__ __forceinline__ void own_part(bool do_test, int32_t* xhead,
                                           int32_t* xcount) {
    ingest();
    process_main();
    if (RELAXED && do_test) process_test_q();
    for (int d = 0; d < S; ++d) {
      const int avail = og_t[d] - og_h[d];
      const int k = avail < s.xcap ? avail : s.xcap;
      xhead[d] = og_h[d];
      xcount[d] = k;
      og_h[d] += k;
    }
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
    if (threadIdx.x == 0)
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
