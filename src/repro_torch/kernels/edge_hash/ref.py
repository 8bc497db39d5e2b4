"""Oracle for the edge-hash lookup kernel: the early-exit lock-step probe.

Every query lane probes the table in lock-step; a lane freezes at a hit
(the slot's ``(lv, u)`` equals the query) or at an empty slot
(``h_pos < 0``), and the loop ends once every lane is frozen or after
``max_probes`` probes.  A lane still unresolved then returns -1.

The kernel reads the table as records: :func:`pack` lays the three arrays
out as one ``(T, 4)`` int32 tensor of ``(lv, u, pos, 0)``, 16 bytes a slot,
and :func:`unpack` gives the arrays back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.ghs_state import _build_hash_table, hash_slot

RECORD_WORDS = 4                 # int32 words of one slot's record


def pack(h_lv, h_u, h_pos) -> torch.Tensor:
    """The table as records: ``(T, 4)`` int32 rows ``(lv, u, pos, 0)``,
    contiguous, on the arrays' device (a fresh allocation, so 16-byte
    aligned)."""
    return torch.stack([h_lv, h_u, h_pos, torch.zeros_like(h_pos)], dim=1)


def unpack(records: torch.Tensor):
    """The three arrays ``(h_lv, h_u, h_pos)`` of a table of records."""
    return tuple(records[:, k].contiguous() for k in range(3))


def _probe(h_lv, h_u, h_pos, q_lv, q_u, done0, max_probes, visit=None):
    """``(pos, probes)``: the lookup result and the probes each lane made
    (table slots it read) before it froze or gave up.  ``visit(idx,
    active, lv_match)``, when given, sees every probe step: the slots, the
    lanes that read them, and where the slot's ``lv`` equals the query's
    (only there does the kernel read ``h_u``)."""
    tsize = h_lv.shape[0]
    idx = hash_slot(q_lv, q_u, tsize).to(torch.int64)
    done = (torch.zeros(q_lv.shape, dtype=torch.bool, device=q_lv.device)
            if done0 is None else done0.clone())
    pos = torch.full(q_lv.shape, -1, dtype=torch.int32, device=q_lv.device)
    probes = torch.zeros(q_lv.shape, dtype=torch.int32, device=q_lv.device)
    for _ in range(max_probes):
        if bool(done.all()):
            break
        lv_match = h_lv[idx] == q_lv
        hit = lv_match & (h_u[idx] == q_u)
        empty = h_pos[idx] < 0
        if visit is not None:
            visit(idx, ~done, lv_match)
        probes += (~done).to(torch.int32)
        pos = torch.where(~done & hit, h_pos[idx], pos)
        done = done | hit | empty
        idx = torch.where(done, idx, (idx + 1) % tsize)
    return pos, probes


def probe(h_lv, h_u, h_pos, q_lv, q_u, *, done0: Optional[torch.Tensor] = None,
          max_probes: int = 64) -> torch.Tensor:
    """Linear-probe all query lanes in lock-step; -1 where unresolved.

    ``done0`` marks lanes that should not probe at all (they return -1).
    """
    return _probe(h_lv, h_u, h_pos, q_lv, q_u, done0, max_probes)[0]


def probe_counts(h_lv, h_u, h_pos, q_lv, q_u, *,
                 max_probes: int = 64) -> torch.Tensor:
    """Probes each query makes: 1-based index of its hit or empty slot, or
    ``max_probes`` when it runs out (int32 per query)."""
    return _probe(h_lv, h_u, h_pos, q_lv, q_u, None, max_probes)[1]


SECTOR_WORDS = 8                 # int32 words in one 32-byte memory sector
SECTOR_RECORDS = SECTOR_WORDS // RECORD_WORDS   # records in one sector


def probe_traffic(h_lv, h_u, h_pos, q_lv, q_u, *,
                  max_probes: int = 64) -> dict:
    """The table reads a lookup needs, in 32-byte sectors, in each layout.

    Three arrays: every probe reads ``h_pos`` and ``h_lv`` at its slot;
    ``h_u`` only where ``h_lv`` matches the query.  Records: every probe
    reads its slot's record.  Two counts of each:

    * ``chain_*``: per query, a sector counted once while consecutive
      probes of its chain stay inside it (the traffic of a lookup that
      shares nothing between queries);
    * ``union_*``: distinct sectors over all queries (each table word read
      once at most: the least any lookup must read).

    ``lv`` and ``u`` count sectors of one array (``lv`` stands for
    ``h_pos`` and ``h_lv``, which are read at the same slots); ``rec``
    counts sectors of the records.  Also ``probes`` (the total) and
    ``u_reads`` (probes that read ``h_u``).  Sectors are ``slot //
    SECTOR_WORDS`` of an array and ``slot // SECTOR_RECORDS`` of the
    records: each array starts on a sector boundary.
    """
    dev = q_lv.device
    per_sector = {"lv": SECTOR_WORDS, "u": SECTOR_WORDS,
                  "rec": SECTOR_RECORDS}
    last = {k: torch.full(q_lv.shape, -1, dtype=torch.int64, device=dev)
            for k in per_sector}
    seen = {k: torch.zeros((h_lv.shape[0] + w - 1) // w, dtype=torch.bool,
                           device=dev) for k, w in per_sector.items()}
    tot = {k: torch.zeros((), dtype=torch.int64, device=dev)
           for k in ("probes", "u_reads", "chain_lv", "chain_u",
                     "chain_rec")}

    def visit(idx, active, lv_match):
        for k, reads in (("lv", active), ("u", active & lv_match),
                         ("rec", active)):
            sec = idx // per_sector[k]
            tot[f"chain_{k}"] += (reads & (sec != last[k])).sum()
            last[k] = torch.where(reads, sec, last[k])
            seen[k][sec[reads]] = True
        tot["probes"] += active.sum()
        tot["u_reads"] += (active & lv_match).sum()

    _probe(h_lv, h_u, h_pos, q_lv, q_u, None, max_probes, visit)
    out = {k: int(v) for k, v in tot.items()}
    out.update({f"union_{k}": int(v.sum()) for k, v in seen.items()})
    return out


def colliding_pairs(length: int, tsize: int, home: int):
    """``length`` distinct ``(lv, u)`` pairs (numpy int32, ``lv = 5``) that
    all hash to slot ``home`` of a ``tsize``-slot table: built into a
    table, they form one probe chain of that length, wrapping past the end
    when ``home`` is late.  Fewer when ``400 * tsize`` senders hold fewer."""
    u = np.arange(1, 400 * tsize, dtype=np.int32)
    lv = np.full(u.shape, 5, np.int32)
    sel = hash_slot(lv, u, tsize) == home
    return lv[sel][:length], u[sel][:length]


def edge_cases(seed: int):
    """The lookup's edge cases: ``[(name, (h_lv, h_u, h_pos, q_lv, q_u))]``,
    numpy int32 (entry i at position i): a chain longer than 64 probes, one
    that wraps past the end of the table, a table of 64 slots, and queries
    of -1 (the empty slot's words) among hits and misses."""
    rng = np.random.default_rng(seed)

    def case(name, lv, u, tsize, q_lv, q_u):
        table = _build_hash_table(lv, u, np.arange(lv.size, dtype=np.int32),
                                  tsize)
        return name, (*table, np.asarray(q_lv, np.int32),
                      np.asarray(q_u, np.int32))

    lv, u = colliding_pairs(100, 1021, 17)
    out = [case("chain longer than max_probes", lv, u, 1021,
                np.concatenate([lv, [5]]), np.concatenate([u, [0]]))]
    lv, u = colliding_pairs(100, 1021, 1000)
    out.append(case("wrap-around at the end of the table", lv, u, 1021,
                    np.concatenate([lv, [5]]), np.concatenate([u, [0]])))
    lv = rng.integers(0, 50, 40).astype(np.int32)
    u = rng.permutation(1000)[:40].astype(np.int32)
    out.append(case("table of 64 slots", lv, u, 64,
                    np.concatenate([lv, lv + 1]), np.concatenate([u, u])))
    lv = rng.integers(0, 1 << 16, 5000).astype(np.int32)
    u = rng.permutation(1 << 20)[:5000].astype(np.int32)
    q = np.array([-1, -1, 0, 7], np.int32)
    out.append(case("queries of -1", lv, u, int(5000 * 4.23) | 1,
                    np.concatenate([lv, q]), np.concatenate([u, q[::-1]])))
    return out


def hash_lookup(h_lv, h_u, h_pos, q_lv, q_u, max_probes: int = 64):
    return probe(h_lv, h_u, h_pos, q_lv, q_u, max_probes=max_probes)
