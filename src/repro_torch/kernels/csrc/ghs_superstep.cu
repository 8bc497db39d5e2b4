// The superstep loop of the paper-faithful GHS engine, for sm_90a: one
// launch runs up to n_steps supersteps of one shard.
//
// Replaces no Pallas kernel.  The JAX package runs this loop on the device
// as nested lax.while_loops over scalar state (core/ghs_message.py:
// interval_core at 591-607, process_main at 409-428, process_test_q at
// 430-446, the hash probe at 163-182, test_proc's cursor scan at
// 243-265); torch has no device loop, and an eager loop would cost tens of
// launches and host branches a message.  This kernel is that loop: it
// reads and writes the same state arrays (core/ghs_state.ShardState, the
// uint32 words as int32 bits) and follows the same control flow, write for
// write.  kernels/ghs_superstep/ref.py is its plain version, line for line.
//
// One superstep: ingest the inbox (an early-exit probe resolves each
// message's edge, the pre-pass of edge_hash.ops.resolve_batch), pop the
// main queue under a budget fixed at entry, drain the Test queue up to its
// tail at entry on every check-th superstep (C1), flush the outgoing ring
// into the inbox (a one-shard exchange), count the activity, update the
// silent streak and write the histories at the global step.  The launch
// reads step0 and silent0 from scal_in and writes [step0 + steps_run,
// silent, err] to scal_out, as interval_core returns them, so a launch from
// a silent state runs nothing and the next interval can be queued from the
// previous one's unfetched outputs.
//
// Bound: latency.  GHS is sequential by design: each message's handler
// reads what the previous ones wrote, so one thread runs the shard's loop
// and every step is a dependent load (the message, its edge's hash slots,
// the vertex's state, the edge states).  The bytes an interval touches are
// few; the time is the chain of load latencies.  The design keeps what it
// can off that chain: the queue heads and tails, the counters and the
// error word live in registers for the launch; the three hash words of a
// slot are loaded together; the static arrays are read through the
// read-only path; a flush rewrites only the inbox rows that may hold words
// (the block's threads find them once at entry, then all but thread 0
// leave).  The lookup method, the lane count and relaxed_test_queue are
// template parameters.
#include <cstdint>
#include <cuda_runtime.h>

// The argument struct; kernels/ghs_superstep/ghs_superstep.py::_Args
// mirrors it (one pointer a ShardState field, in its order).  Outside the
// anonymous namespace: the C entry takes it, and must keep external
// linkage.
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
  int block, qcap, ocap, xcap, tsize, hcap, n_steps, check, empty_needed;
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

template <int METHOD, int LANES, bool RELAXED>
struct Loop {
  const Shard& s;
  int32_t mq_head, mq_tail, tq_head, tq_tail, og_h, og_t;
  int32_t err, halted, n_processed, n_productive, n_sent_remote,
      n_sent_local;
  int inbox_rows;   // inbox rows that may hold a nonzero word

  __device__ explicit Loop(const Shard& shard, int rows)
      : s(shard), mq_head(*shard.mq_head), mq_tail(*shard.mq_tail),
        tq_head(*shard.tq_head), tq_tail(*shard.tq_tail),
        og_h(shard.og_head[0]), og_t(shard.og_tail[0]), err(*shard.err),
        halted(*shard.halted), n_processed(*shard.n_processed),
        n_productive(*shard.n_productive),
        n_sent_remote(*shard.n_sent_remote),
        n_sent_local(*shard.n_sent_local), inbox_rows(rows) {}

  __device__ void store() const {
    *s.mq_head = mq_head; *s.mq_tail = mq_tail;
    *s.tq_head = tq_head; *s.tq_tail = tq_tail;
    s.og_head[0] = og_h; s.og_tail[0] = og_t;
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
  // outgoing ring.  A full ring's slot is overwritten and its tail still
  // advances; the overflow flag is set after the write.
  __device__ __forceinline__ void push(const Msg<LANES>& m, int32_t dst,
                                       bool is_test, int32_t pos) {
    const int ds = floordiv(dst, s.block);
    if (ds == 0) {
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
      // Row ds of a one-row ring: -1 wraps to row 0, any other row is out
      // of range and dropped; the tail of row ds mod 1 = 0 advances.
      if (ds == -1) store_msg(s.og + (size_t)(og_t % s.ocap) * LANES, m);
      ++og_t;
      ++n_sent_remote;
    }
    if (mq_tail - mq_head > s.qcap || tq_tail - tq_head > s.qcap ||
        og_t - og_h > s.ocap)
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
      send(REPORT, s.ln[lv], 0, lv, __ldg(s.nbr + ib), s.best_w[lv],
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
      send(CHANGE_CORE, 0, 0, lv, __ldg(s.nbr + be), 0, 0);
    } else {
      send(CONNECT, s.ln[lv], 0, lv, __ldg(s.nbr + be), 0, 0);
      s.se[be] = BRANCH;
    }
  }

  __device__ __forceinline__ void test_proc(int32_t lv) {      // GHS (4)
    const int a = __ldg(s.indptr + lv), b = __ldg(s.indptr + lv + 1);
    int q = a;
    while (q < b && s.se[q] != BASIC) ++q;
    if (q < b) {
      s.test_edge[lv] = q;
      send(TEST, s.ln[lv], 0, lv, __ldg(s.nbr + q), s.fnw[lv], s.fne[lv]);
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
      send(INITIATE, ln, im_find ? 1 : 0, lv, u, s.fnw[lv], s.fne[lv]);
      if (im_find) s.find_count[lv] += 1;
      return true;
    }
    if (s.se[p] != BASIC) {                             // merge
      send(INITIATE, ln + 1, 1, lv, u, __ldg(s.ewb + p), __ldg(s.etb + p));
      return true;
    }
    push(raw, lv, false, p);                            // postpone
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
        send(INITIATE, level, state_bit, lv, __ldg(s.nbr + q), fw, fe);
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
      push(raw, lv, RELAXED, p);
      return false;
    }
    if (fw != s.fnw[lv] || fe != s.fne[lv]) {
      send(ACCEPT, 0, 0, lv, u, 0, 0);
      return true;
    }
    if (s.se[p] == BASIC) s.se[p] = REJECTED;
    if (s.test_edge[lv] == p) test_proc(lv);
    else send(REJECT, 0, 0, lv, u, 0, 0);
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
      push(raw, lv, false, p);
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
    const int32_t lv = (int32_t)dst, u = (int32_t)src;
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

  __device__ __forceinline__ void ingest() {
    int cnt = s.in_cnt[0];
    cnt = cnt < 0 ? 0 : cnt > s.xcap ? s.xcap : cnt;
    for (int c = 0; c < cnt; ++c) {
      const Msg<LANES> raw = load_msg(s.inbox + (size_t)c * LANES);
      const uint32_t mtype = LANES == 5 ? raw.w[0] & 7 : raw.w[0];
      const uint32_t src = LANES == 5 ? raw.w[1] : raw.w[3];
      const uint32_t dst = LANES == 5 ? raw.w[2] : raw.w[4];
      int32_t pre = POS_UNRESOLVED;
      if constexpr (METHOD == METHOD_HASH) {
        const int32_t p = probe((int32_t)dst, (int32_t)src);
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
    if (mq_tail - mq_head > s.qcap || tq_tail - tq_head > s.qcap)
      err |= ERR_QUEUE_OVERFLOW;
    s.in_cnt[0] = 0;
  }

  // Up to xcap outgoing messages into the inbox (a one-shard exchange),
  // zeros past them; only rows that may hold words are rewritten.
  __device__ __forceinline__ void flush() {
    const int avail = og_t - og_h;
    const int k = avail < s.xcap ? avail : s.xcap;
    const int rows = k > inbox_rows ? k : inbox_rows;
    for (int c = 0; c < rows; ++c) {
      uint32_t* row = s.inbox + (size_t)c * LANES;
      if (c < k) {
        store_msg(row, load_msg(s.og + (size_t)((og_h + c) % s.ocap) *
                                           LANES));
      } else {
#pragma unroll
        for (int w = 0; w < LANES; ++w) row[w] = 0;
      }
    }
    inbox_rows = k > 0 ? k : 0;
    og_h += k;
    s.in_cnt[0] = k;
  }

  __device__ __forceinline__ int32_t superstep(bool do_test, int32_t gstep) {
    ingest();
    process_main();
    if (RELAXED && do_test) process_test_q();
    flush();
    const int32_t activity = (mq_tail - mq_head) + (tq_tail - tq_head) +
                             (og_t - og_h) + s.in_cnt[0];
    if (gstep >= 0 && gstep < s.hcap) {
      s.hist_act[gstep] = activity;
      s.hist_sent[gstep] = n_sent_remote;
    }
    return activity;
  }
};

template <int METHOD, int LANES, bool RELAXED>
__global__ void ghs_interval(const Shard s) {
  // The inbox rows that may hold a nonzero word, found by the whole block.
  __shared__ int rows;
  if (threadIdx.x == 0) rows = 0;
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < s.xcap * LANES; i += blockDim.x)
    if (s.inbox[i] != 0) mine = i / LANES + 1;
  if (mine) atomicMax(&rows, mine);
  __syncthreads();
  if (threadIdx.x != 0) return;

  Loop<METHOD, LANES, RELAXED> loop(s, rows);
  const int32_t step0 = s.scal_in[0];
  int32_t i = 0, silent = s.scal_in[1], err = 0;
  while (i < s.n_steps && silent < s.empty_needed && err == 0) {
    const int32_t gstep = step0 + i;
    const int32_t act = loop.superstep(gstep % s.check == s.check - 1, gstep);
    silent = act == 0 ? silent + 1 : 0;
    err = loop.err;
    ++i;
  }
  loop.store();
  s.scal_out[0] = step0 + i;
  s.scal_out[1] = silent;
  s.scal_out[2] = err;
}

template <int METHOD, int LANES, bool RELAXED>
int launch(const Shard& s, int threads, cudaStream_t stream) {
  ghs_interval<METHOD, LANES, RELAXED><<<1, threads, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

template <int METHOD, int LANES>
int by_relaxed(const Shard& s, int relaxed, int threads,
               cudaStream_t stream) {
  return relaxed ? launch<METHOD, LANES, true>(s, threads, stream)
                 : launch<METHOD, LANES, false>(s, threads, stream);
}

template <int METHOD>
int by_lanes(const Shard& s, int lanes, int relaxed, int threads,
             cudaStream_t stream) {
  if (lanes == 5) return by_relaxed<METHOD, 5>(s, relaxed, threads, stream);
  if (lanes == 8) return by_relaxed<METHOD, 8>(s, relaxed, threads, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ghs_superstep_interval(const Shard* s, int method, int lanes,
                                      int relaxed, int threads,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (method) {
    case METHOD_HASH:
      return by_lanes<METHOD_HASH>(*s, lanes, relaxed, threads, st);
    case METHOD_LINEAR:
      return by_lanes<METHOD_LINEAR>(*s, lanes, relaxed, threads, st);
    case METHOD_BINARY:
      return by_lanes<METHOD_BINARY>(*s, lanes, relaxed, threads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
