"""Plain version of the GHS interval kernel: the superstep loop of one shard
in Python, over numpy views of the state's CPU tensors.

It runs what ``csrc/ghs_superstep.cu`` runs, in the same order: up to
``n_steps`` supersteps (ingest, the main-queue pass, the Test-queue drain
on every ``check``-th superstep, flush, the activity count, the silent
streak and the history writes), stopping early on an error flag or once
the streak reaches ``empty_needed``.  Both follow the JAX package's masked
``make_superstep`` / ``interval_core`` write for write, as plain sequential
code: a send whose predicate is false writes nothing, and the queue check
after a real push sees everything the reference's unconditional check
sees (the rings only fill through pushes and ingest, and the flag stays
set).  The state is updated in place; scalars ride in Python ints for the
interval and are stored back at its end.

Indexing a torch tensor one element at a time costs microseconds, so the
loop reads and writes numpy views (the uint32 words as uint32 views of
the int32 tensors).  One shard only: the exchange of a multi-shard run is
not ported.
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


class _Shard:
    """The loop over one shard's state: arrays as numpy views, scalars as
    Python ints between :meth:`load` and :meth:`store`."""

    def __init__(self, state: ShardState, cfg: Config):
        self.cfg = cfg
        self.a = {}
        for f in ShardState._fields:
            arr = getattr(state, f).numpy()
            self.a[f] = arr.view(np.uint32) if f in WORD_FIELDS else arr
        for f in ShardState._fields:
            if f not in _SCALARS:
                setattr(self, f, self.a[f])
        if self.og.shape[0] != 1:
            raise NotImplementedError("the superstep loop runs one shard")
        self.compressed = cfg.lanes == 5
        self.hcap = self.hist_act.shape[0]

    def load(self):
        for f in _SCALARS:
            setattr(self, "v_" + f, int(self.a[f]))
        self.og_h = int(self.og_head[0])
        self.og_t = int(self.og_tail[0])

    def store(self):
        for f in _SCALARS:
            self.a[f][()] = getattr(self, "v_" + f)
        self.og_head[0] = self.og_h
        self.og_tail[0] = self.og_t

    # --- messages -----------------------------------------------------------
    def encode(self, mtype, level, state, src, dst, fw, fe):
        if self.compressed:
            return ((mtype | (state << 3) | (level << 4)) & _M32, src & _M32,
                    dst & _M32, fw & _M32, fe & _M32)
        return (mtype & _M32, level & _M32, state & _M32, src & _M32,
                dst & _M32, fw & _M32, fe & _M32, 0)

    def push(self, msg, dst: int, is_test: bool, pos: int):
        """Queue ``msg`` for ``dst`` (an int32 value): local main or Test
        queue, or the outgoing ring.  A full ring's slot is overwritten and
        its tail still advances; the overflow flag is set after the write."""
        cfg = self.cfg
        ds = dst // cfg.block                  # floor division, as jnp's
        if ds == 0:
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
            # Row ds of a one-row ring: -1 wraps to row 0 (a negative
            # index), any other is out of range and the write is dropped;
            # the tail of row ds % 1 = 0 advances either way.
            if ds == -1:
                self.og[0, self.og_t % cfg.ocap] = msg
            self.og_t += 1
            self.v_n_sent_remote += 1
        if (self.v_mq_tail - self.v_mq_head > cfg.qcap
                or self.v_tq_tail - self.v_tq_head > cfg.qcap
                or self.og_t - self.og_h > cfg.ocap):
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
            self.send(REPORT, int(self.ln[lv]), 0, lv, int(self.nbr[ib]),
                      int(self.best_w[lv]), int(self.best_e[lv]))

    def change_core(self, lv: int):
        """GHS (10)."""
        be = int(self.best_edge[lv])
        if be < 0:
            self.v_err |= ERR_LOGIC
            return
        if self.se[be] == BRANCH:
            self.send(CHANGE_CORE, 0, 0, lv, int(self.nbr[be]), 0, 0)
        else:
            self.send(CONNECT, int(self.ln[lv]), 0, lv, int(self.nbr[be]),
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
            self.send(TEST, int(self.ln[lv]), 0, lv, int(self.nbr[q]),
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
            self.send(INITIATE, ln, 1 if im_find else 0, lv, u,
                      int(self.fnw[lv]), int(self.fne[lv]))
            if im_find:
                self.find_count[lv] += 1
            return True
        if self.se[p] != BASIC:                          # merge
            self.send(INITIATE, ln + 1, 1, lv, u, int(self.ewb[p]),
                      int(self.etb[p]))
            return True
        self.push(raw, lv, False, p)                     # postpone
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
                self.send(INITIATE, level, state_bit, lv, int(self.nbr[q]),
                          fw, fe)
                if state_bit == 1:
                    self.find_count[lv] += 1
        if state_bit == 1:
            self.test_proc(lv)
        return True

    def h_test(self, u, lv, p, level, state_bit, fw, fe, raw):
        if level > int(self.ln[lv]):                     # postpone
            self.push(raw, lv, self.cfg.relaxed, p)
            return False
        if fw != self.fnw[lv] or fe != self.fne[lv]:
            self.send(ACCEPT, 0, 0, lv, u, 0, 0)
            return True
        if self.se[p] == BASIC:
            self.se[p] = REJECTED
        if self.test_edge[lv] == p:
            self.test_proc(lv)
        else:
            self.send(REJECT, 0, 0, lv, u, 0, 0)
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
            self.push(raw, lv, False, p)
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
        lv, u = _s32(dst), _s32(src)
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
        cfg = self.cfg
        cnt = min(max(int(self.in_cnt[0]), 0), cfg.xcap)
        if cnt:
            rows = self.inbox[0, :cnt]
            mtypes = rows[:, 0] & 7 if self.compressed else rows[:, 0]
            srcs, dsts = ((rows[:, 1], rows[:, 2]) if self.compressed
                          else (rows[:, 3], rows[:, 4]))
            pre = np.full(cnt, POS_UNRESOLVED, np.int32)
            if cfg.method == "hash":
                got = edge_ops.resolve_batch(
                    *(torch.from_numpy(t) for t in (
                        self.h_lv, self.h_u, self.h_pos,
                        dsts.view(np.int32), srcs.view(np.int32))),
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
        self.in_cnt[0] = 0

    def flush(self):
        """Move up to ``xcap`` outgoing messages into the inbox (a one-shard
        exchange), zeros past them."""
        cfg = self.cfg
        k = min(self.og_t - self.og_h, cfg.xcap)
        self.inbox[0] = 0
        for c in range(k):
            self.inbox[0, c] = self.og[0, (self.og_h + c) % cfg.ocap]
        self.og_h += k
        self.in_cnt[0] = k

    def superstep(self, do_test: bool, gstep: int) -> int:
        self.ingest()
        self.process_main()
        if self.cfg.relaxed and do_test:
            self.process_test_q()
        self.flush()
        activity = ((self.v_mq_tail - self.v_mq_head)
                    + (self.v_tq_tail - self.v_tq_head)
                    + (self.og_t - self.og_h) + int(self.in_cnt[0]))
        if 0 <= gstep < self.hcap:
            self.hist_act[gstep] = activity
            self.hist_sent[gstep] = self.v_n_sent_remote
        return activity


def run_interval(state: ShardState, step0: int, silent0: int, n_steps: int,
                 cfg: Config) -> list:
    """Up to ``n_steps`` supersteps of one shard's CPU state, in place.
    Returns ``[step0 + steps_run, silent_streak, err]``, the reference's
    ``interval_core`` vector: the loop stops once the silent streak
    reaches ``cfg.empty_needed`` (so a call from a silent state runs
    nothing) or after a superstep that left an error flag."""
    sh = _Shard(state, cfg)
    sh.load()
    i, silent, err = 0, silent0, 0
    while i < n_steps and silent < cfg.empty_needed and err == 0:
        gstep = step0 + i
        act = sh.superstep(gstep % cfg.check == cfg.check - 1, gstep)
        silent = silent + 1 if act == 0 else 0
        err = sh.v_err
        i += 1
    sh.store()
    return [step0 + i, silent, err]


def interval(state: ShardState, scal: torch.Tensor, n_steps: int,
             cfg: Config) -> torch.Tensor:
    """The plain version of the kernel's entry: ``scal`` holds ``[step0,
    silent0, ...]``; returns the new int32 vector of three."""
    step0, silent0 = (int(v) for v in scal[:2].tolist())
    return torch.tensor(run_interval(state, step0, silent0, n_steps, cfg),
                        dtype=torch.int32)
