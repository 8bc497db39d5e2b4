"""Plain version of the GHS interval kernel: the superstep loop of S shards
in Python, over numpy views of the state's CPU tensors.

It runs what ``csrc/ghs_superstep.cu`` runs, in the same order: up to
``n_steps`` supersteps, each of them every shard's own part in shard order
(ingest, the main-queue pass, the Test-queue drain on every ``check``-th
superstep, flush), then the exchange (shard d's inbox row block s takes
what shard s flushed for d, as the reference's ``all_to_all`` orders it),
then the activity and error sums over the shards (the reference's
``psum``), the silent streak and the history writes; the loop stops early
on an error sum or once the streak reaches ``empty_needed``.  Both follow the JAX package's masked
``make_superstep`` / ``interval_core`` write for write, as plain sequential
code: a send whose predicate is false writes nothing, and the queue check
after a real push sees everything the reference's unconditional check
sees (the rings only fill through pushes and ingest, and the flag stays
set).  The state is updated in place; scalars ride in Python ints for the
interval and are stored back at its end.

Indexing a torch tensor one element at a time costs microseconds, so the
loop reads and writes numpy views (the uint32 words as uint32 views of
the int32 tensors).  The state carries the shard axis first
(:func:`repro_torch.core.ghs_state.upload_stacked`); a state without it is
one shard.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ghs_state import (
    ACCEPT, BASIC, BRANCH, CHANGE_CORE, CONNECT, FIND, FOUND, HASH_K1,
    HASH_K2, INITIATE, POS_UNRESOLVED, REJECT, REJECTED, REPORT, TEST,
    WORD_FIELDS, GHSTopology, ShardState)
from repro_torch.core.params import GHSParams
from repro_torch.kernels.edge_hash import ops as edge_ops

ERR_QUEUE_OVERFLOW = 1
ERR_HASH_MISS = 2
ERR_LOGIC = 4

METHODS = ("hash", "linear", "binary")

_M32 = 0xFFFFFFFF
_INF = 0xFFFFFFFF
_K1, _K2 = int(HASH_K1), int(HASH_K2)
_PROBES = 64            # the ingest pre-pass's probe cap (min with tsize)


def _s32(x: int) -> int:
    """A uint32 word as the int32 it casts to."""
    return x - (1 << 32) if x >= (1 << 31) else x


@dataclasses.dataclass(frozen=True)
class Config:
    """What one shard's superstep loop needs besides its state."""

    block: int
    qcap: int
    ocap: int
    xcap: int
    tsize: int
    lanes: int
    method: str           # "hash", "linear" or "binary"
    relaxed: bool         # separate Test queue (C1)
    check: int            # Test-queue drain every check-th superstep
    empty_needed: int     # silent checks in a row that end the run


def config(topo: GHSTopology, params: GHSParams) -> Config:
    """The loop's settings: the lookup method as ``make_superstep`` picks
    it (``hash_table_factor < 0`` without hashing selects binary search)."""
    method = "hash" if params.use_hashing else "linear"
    if not params.use_hashing and params.hash_table_factor < 0:
        method = "binary"
    return Config(block=topo.block, qcap=topo.qcap, ocap=topo.ocap,
                  xcap=topo.xcap, tsize=topo.tsize, lanes=topo.lanes,
                  method=method, relaxed=bool(params.relaxed_test_queue),
                  check=max(params.check_frequency, 1),
                  empty_needed=max(params.empty_iter_cnt_to_break, 1))


_SCALARS = ("mq_head", "mq_tail", "tq_head", "tq_tail", "err", "halted",
            "n_processed", "n_productive", "n_sent_remote", "n_sent_local")


def stacked(state: ShardState) -> ShardState:
    """``state`` with the leading shard axis: as it is, or (one shard
    without it) every field as a view with an axis of one."""
    if state.sn.dim() == 2:
        return state
    return ShardState(*[t.unsqueeze(0) for t in state])


class _Shard:
    """The loop over shard ``my`` of a stacked state: its arrays as numpy
    views, its scalars as Python ints between :meth:`load` and
    :meth:`store`."""

    def __init__(self, state: ShardState, my: int, cfg: Config):
        self.cfg = cfg
        self.my = my
        self.S = state.sn.shape[0]
        self.v0 = cfg.block * my               # first global vertex id
        self.a = {}
        for f in ShardState._fields:
            arr = getattr(state, f).numpy()
            arr = arr.view(np.uint32) if f in WORD_FIELDS else arr
            self.a[f] = arr[my:my + 1].reshape(arr.shape[1:])
        for f in ShardState._fields:
            if f not in _SCALARS:
                setattr(self, f, self.a[f])
        self.compressed = cfg.lanes == 5
        self.hcap = self.hist_act.shape[0]

    def load(self):
        for f in _SCALARS:
            setattr(self, "v_" + f, int(self.a[f]))
        self.og_h = [int(x) for x in self.og_head]
        self.og_t = [int(x) for x in self.og_tail]

    def store(self):
        for f in _SCALARS:
            self.a[f][()] = getattr(self, "v_" + f)
        self.og_head[:] = self.og_h
        self.og_tail[:] = self.og_t

    # --- messages -----------------------------------------------------------
    def encode(self, mtype, level, state, src, dst, fw, fe):
        if self.compressed:
            return ((mtype | (state << 3) | (level << 4)) & _M32, src & _M32,
                    dst & _M32, fw & _M32, fe & _M32)
        return (mtype & _M32, level & _M32, state & _M32, src & _M32,
                dst & _M32, fw & _M32, fe & _M32, 0)

    def push(self, msg, dst: int, is_test: bool, pos: int):
        """Queue ``msg`` for ``dst`` (an int32 value): local main or Test
        queue, or the outgoing ring of its shard.  A full ring's slot is
        overwritten and its tail still advances; the overflow flag is set
        after the write."""
        cfg = self.cfg
        ds = dst // cfg.block                  # floor division, as jnp's
        if ds == self.my:
            self.v_n_sent_local += 1
            if is_test:
                slot = self.v_tq_tail % cfg.qcap
                self.tq[slot] = msg
                self.tq_pos[slot] = pos
                self.v_tq_tail += 1
            else:
                slot = self.v_mq_tail % cfg.qcap
                self.mq[slot] = msg
                self.mq_pos[slot] = pos
                self.v_mq_tail += 1
        else:
            # Ring row ds: a negative row from -S wraps (a negative index),
            # any other outside [0, S) is dropped; the tail of row ds % S
            # advances either way.  Only that row's fill can have grown.
            r = ds % self.S
            if -self.S <= ds < self.S:
                self.og[r, self.og_t[r] % cfg.ocap] = msg
            self.og_t[r] += 1
            self.v_n_sent_remote += 1
            if self.og_t[r] - self.og_h[r] > cfg.ocap:
                self.v_err |= ERR_QUEUE_OVERFLOW
        if (self.v_mq_tail - self.v_mq_head > cfg.qcap
                or self.v_tq_tail - self.v_tq_head > cfg.qcap):
            self.v_err |= ERR_QUEUE_OVERFLOW

    def send(self, mtype, level, state, src, dst, fw, fe):
        msg = self.encode(mtype, level, state, src, dst, fw, fe)
        self.push(msg, dst, self.cfg.relaxed and mtype == TEST,
                  int(POS_UNRESOLVED))

    # --- edge lookup (C2 and the ablations) ---------------------------------
    def lookup(self, lv: int, u: int) -> int:
        cfg = self.cfg
        if cfg.method == "hash":
            tsize = cfg.tsize
            h = ((((lv & _M32) * _K1) & _M32) ^ (((u & _M32) * _K2) & _M32)) \
                % tsize
            steps = 0
            while steps < tsize:
                hit = self.h_lv[h] == lv and self.h_u[h] == u
                empty = self.h_pos[h] < 0
                h = (h + 1) % tsize
                steps += 1
                if hit or empty:
                    break
            h = (h - 1) % tsize
            if self.h_lv[h] == lv and self.h_u[h] == u:
                return int(self.h_pos[h])
            return -1
        a, b = int(self.indptr[lv]), int(self.indptr[lv + 1])
        if cfg.method == "linear":
            for q in range(a, b):
                if self.nbr[q] == u:
                    return q
            return -1
        lo, hi = a, b
        while lo < hi:
            mid = (lo + hi) // 2
            if self.nbr[self.byid[mid]] < u:
                lo = mid + 1
            else:
                hi = mid
        if lo < b and self.nbr[self.byid[lo]] == u:
            return int(self.byid[lo])
        return -1

    # --- GHS procedures -----------------------------------------------------
    def report_proc(self, lv: int):
        """GHS (8): if find_count == 0 and test_edge == nil, report up
        in_branch."""
        ib = int(self.in_branch[lv])
        if self.find_count[lv] == 0 and self.test_edge[lv] == -1 and ib >= 0:
            self.sn[lv] = FOUND
            self.send(REPORT, int(self.ln[lv]), 0, self.v0 + lv,
                      int(self.nbr[ib]),
                      int(self.best_w[lv]), int(self.best_e[lv]))

    def change_core(self, lv: int):
        """GHS (10)."""
        be = int(self.best_edge[lv])
        if be < 0:
            self.v_err |= ERR_LOGIC
            return
        vme = self.v0 + lv
        if self.se[be] == BRANCH:
            self.send(CHANGE_CORE, 0, 0, vme, int(self.nbr[be]), 0, 0)
        else:
            self.send(CONNECT, int(self.ln[lv]), 0, vme, int(self.nbr[be]),
                      0, 0)
            self.se[be] = BRANCH

    def test_proc(self, lv: int):
        """GHS (4): probe the lightest Basic edge, or report."""
        a, b = int(self.indptr[lv]), int(self.indptr[lv + 1])
        q = a
        while q < b and self.se[q] != BASIC:
            q += 1
        if q < b:
            self.test_edge[lv] = q
            self.send(TEST, int(self.ln[lv]), 0, self.v0 + lv,
                      int(self.nbr[q]),
                      int(self.fnw[lv]), int(self.fne[lv]))
        else:
            self.test_edge[lv] = -1
            self.report_proc(lv)

    # --- handlers: (u, lv, p, level, state_bit, fw, fe, raw) -> productive --
    def h_connect(self, u, lv, p, level, state_bit, fw, fe, raw):
        ln = int(self.ln[lv])
        if level < ln:                                   # absorb
            self.se[p] = BRANCH
            im_find = self.sn[lv] == FIND
            self.send(INITIATE, ln, 1 if im_find else 0, self.v0 + lv, u,
                      int(self.fnw[lv]), int(self.fne[lv]))
            if im_find:
                self.find_count[lv] += 1
            return True
        if self.se[p] != BASIC:                          # merge
            self.send(INITIATE, ln + 1, 1, self.v0 + lv, u, int(self.ewb[p]),
                      int(self.etb[p]))
            return True
        self.push(raw, self.v0 + lv, False, p)           # postpone
        return False

    def h_initiate(self, u, lv, p, level, state_bit, fw, fe, raw):
        self.ln[lv] = level
        self.fnw[lv] = fw
        self.fne[lv] = fe
        self.sn[lv] = FIND if state_bit == 1 else FOUND
        self.in_branch[lv] = p
        self.best_edge[lv] = -1
        self.best_w[lv] = _INF
        self.best_e[lv] = _INF
        for q in range(int(self.indptr[lv]), int(self.indptr[lv + 1])):
            if self.se[q] == BRANCH and q != p:
                self.send(INITIATE, level, state_bit, self.v0 + lv,
                          int(self.nbr[q]), fw, fe)
                if state_bit == 1:
                    self.find_count[lv] += 1
        if state_bit == 1:
            self.test_proc(lv)
        return True

    def h_test(self, u, lv, p, level, state_bit, fw, fe, raw):
        if level > int(self.ln[lv]):                     # postpone
            self.push(raw, self.v0 + lv, self.cfg.relaxed, p)
            return False
        if fw != self.fnw[lv] or fe != self.fne[lv]:
            self.send(ACCEPT, 0, 0, self.v0 + lv, u, 0, 0)
            return True
        if self.se[p] == BASIC:
            self.se[p] = REJECTED
        if self.test_edge[lv] == p:
            self.test_proc(lv)
        else:
            self.send(REJECT, 0, 0, self.v0 + lv, u, 0, 0)
        return True

    def h_accept(self, u, lv, p, level, state_bit, fw, fe, raw):
        self.test_edge[lv] = -1
        w, e = int(self.ewb[p]), int(self.etb[p])
        bw, be = int(self.best_w[lv]), int(self.best_e[lv])
        if w < bw or (w == bw and e < be):
            self.best_edge[lv] = p
            self.best_w[lv] = w
            self.best_e[lv] = e
        self.report_proc(lv)
        return True

    def h_reject(self, u, lv, p, level, state_bit, fw, fe, raw):
        if self.se[p] == BASIC:
            self.se[p] = REJECTED
        self.test_proc(lv)
        return True

    def h_report(self, u, lv, p, level, state_bit, fw, fe, raw):
        if p != self.in_branch[lv]:                      # non-core child
            self.find_count[lv] -= 1
            bw, be = int(self.best_w[lv]), int(self.best_e[lv])
            if fw < bw or (fw == bw and fe < be):
                self.best_edge[lv] = p
                self.best_w[lv] = fw
                self.best_e[lv] = fe
            self.report_proc(lv)
            return True
        if self.sn[lv] == FIND:                          # postpone
            self.push(raw, self.v0 + lv, False, p)
            return False
        bw, be = int(self.best_w[lv]), int(self.best_e[lv])
        if bw < fw or (bw == fw and be < fe):            # my side smaller
            self.change_core(lv)
        elif fw == _INF and fe == _INF and bw == _INF and be == _INF:
            self.v_halted += 1
        return True

    def h_changecore(self, u, lv, p, level, state_bit, fw, fe, raw):
        self.change_core(lv)
        return True

    # --- dispatch and the queues --------------------------------------------
    def dispatch(self, raw, pre: int):
        if self.compressed:
            hdr = raw[0]
            mtype, level, state_bit = hdr & 7, hdr >> 4, (hdr >> 3) & 1
            src, dst, fw, fe = raw[1], raw[2], raw[3], raw[4]
        else:
            mtype, level, state_bit, src, dst, fw, fe = raw[:7]
        lv, u = _s32(dst) - self.v0, _s32(src)
        p = pre if pre >= 0 else self.lookup(lv, u)
        if p < 0:
            self.v_err |= ERR_HASH_MISS
            p = 0
        handler = self.handlers[min(max(_s32(mtype), 0), 6)]
        productive = handler(self, u, lv, p, level, state_bit, fw, fe, raw)
        self.v_n_processed += 1
        self.v_n_productive += int(productive)

    handlers = (h_connect, h_initiate, h_test, h_accept, h_reject, h_report,
                h_changecore)

    def process_main(self):
        # Budget fixed at entry: the queue snapshot plus slack, so fresh
        # local messages advance several hops while postponed ones cannot
        # spin forever.
        budget = 2 * (self.v_mq_tail - self.v_mq_head) + 64
        n = 0
        while (self.v_mq_head < self.v_mq_tail and n < budget
               and self.v_err == 0):
            slot = self.v_mq_head % self.cfg.qcap
            raw = tuple(int(x) for x in self.mq[slot])
            pre = int(self.mq_pos[slot])
            self.v_mq_head += 1
            self.dispatch(raw, pre)
            n += 1

    def process_test_q(self):
        snapshot = self.v_tq_tail
        while self.v_tq_head < snapshot and self.v_err == 0:
            slot = self.v_tq_head % self.cfg.qcap
            raw = tuple(int(x) for x in self.tq[slot])
            pre = int(self.tq_pos[slot])
            self.v_tq_head += 1
            self.dispatch(raw, pre)

    def ingest(self):
        """The inbox into the queues, source shard 0 first, each block in
        row order."""
        cfg = self.cfg
        rows = np.concatenate([
            self.inbox[s, :min(max(int(self.in_cnt[s]), 0), cfg.xcap)]
            for s in range(self.S)])
        cnt = rows.shape[0]
        if cnt:
            mtypes = rows[:, 0] & 7 if self.compressed else rows[:, 0]
            srcs, dsts = ((rows[:, 1], rows[:, 2]) if self.compressed
                          else (rows[:, 3], rows[:, 4]))
            pre = np.full(cnt, POS_UNRESOLVED, np.int32)
            if cfg.method == "hash":
                qlv = dsts.view(np.int32) - np.int32(self.v0)
                got = edge_ops.resolve_batch(
                    *(torch.from_numpy(t) for t in (
                        self.h_lv, self.h_u, self.h_pos, qlv,
                        srcs.view(np.int32))),
                    torch.ones(cnt, dtype=torch.bool),
                    max_probes=min(cfg.tsize, _PROBES)).numpy()
                pre = np.where(got >= 0, got, pre)
            for c in range(cnt):
                raw = tuple(int(x) for x in rows[c])
                if cfg.relaxed and mtypes[c] == TEST:
                    slot = self.v_tq_tail % cfg.qcap
                    self.tq[slot] = raw
                    self.tq_pos[slot] = pre[c]
                    self.v_tq_tail += 1
                else:
                    slot = self.v_mq_tail % cfg.qcap
                    self.mq[slot] = raw
                    self.mq_pos[slot] = pre[c]
                    self.v_mq_tail += 1
        if (self.v_mq_tail - self.v_mq_head > cfg.qcap
                or self.v_tq_tail - self.v_tq_head > cfg.qcap):
            self.v_err |= ERR_QUEUE_OVERFLOW
        self.in_cnt[:] = 0

    def flush(self) -> list:
        """Take up to ``xcap`` messages off each outgoing ring; returns one
        ``(ring head before, count)`` a destination shard."""
        out = []
        for d in range(self.S):
            k = min(self.og_t[d] - self.og_h[d], self.cfg.xcap)
            out.append((self.og_h[d], k))
            self.og_h[d] += k
        return out

    def own_part(self, do_test: bool) -> list:
        """The shard's part of a superstep before the exchange."""
        self.ingest()
        self.process_main()
        if self.cfg.relaxed and do_test:
            self.process_test_q()
        return self.flush()

    def activity(self) -> int:
        """Messages the shard still holds after the exchange."""
        return ((self.v_mq_tail - self.v_mq_head)
                + (self.v_tq_tail - self.v_tq_head)
                + sum(t - h for t, h in zip(self.og_t, self.og_h))
                + int(self.in_cnt.sum()))


def _exchange(shards: list, flushed: list, cfg: Config) -> None:
    """The reference's ``all_to_all``: shard d's inbox block s holds the
    messages shard s took off its ring for d, zeros past them."""
    for d, dest in enumerate(shards):
        for s, src in enumerate(shards):
            head, k = flushed[s][d]
            dest.inbox[s] = 0
            for c in range(k):
                dest.inbox[s, c] = src.og[d, (head + c) % cfg.ocap]
            dest.in_cnt[s] = k


def run_interval(state: ShardState, step0: int, silent0: int, n_steps: int,
                 cfg: Config) -> list:
    """Up to ``n_steps`` supersteps of a CPU state (its shards on the
    leading axis), in place.  Returns ``[step0 + steps_run, silent_streak,
    err]``, the reference's ``interval_core`` vector, with the activity
    and the error words summed over the shards: the loop stops once the
    silent streak reaches ``cfg.empty_needed`` (so a call from a silent
    state runs nothing) or after a superstep whose error sum is not 0."""
    state = stacked(state)
    shards = [_Shard(state, s, cfg) for s in range(state.sn.shape[0])]
    for sh in shards:
        sh.load()
    i, silent, err = 0, silent0, 0
    while i < n_steps and silent < cfg.empty_needed and err == 0:
        gstep = step0 + i
        do_test = gstep % cfg.check == cfg.check - 1
        flushed = [sh.own_part(do_test) for sh in shards]
        _exchange(shards, flushed, cfg)
        act = sum(sh.activity() for sh in shards)
        err = sum(sh.v_err for sh in shards)
        if 0 <= gstep < shards[0].hcap:
            for sh in shards:
                sh.hist_act[gstep] = act
                sh.hist_sent[gstep] = sh.v_n_sent_remote
        silent = silent + 1 if act == 0 else 0
        i += 1
    for sh in shards:
        sh.store()
    return [step0 + i, silent, err]


def interval(state: ShardState, scal: torch.Tensor, n_steps: int,
             cfg: Config) -> torch.Tensor:
    """The plain version of the kernel's entry: ``scal`` holds ``[step0,
    silent0, ...]``; returns the new int32 vector of three."""
    step0, silent0 = (int(v) for v in scal[:2].tolist())
    return torch.tensor(run_interval(state, step0, silent0, n_steps, cfg),
                        dtype=torch.int32)
