"""Oracle for the edge-hash lookup kernel: the early-exit lock-step probe.

Every query lane probes the table in lock-step; a lane freezes at a hit
(the slot's ``(lv, u)`` equals the query) or at an empty slot
(``h_pos < 0``), and the loop ends once every lane is frozen or after
``max_probes`` probes.  A lane still unresolved then returns -1.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.ghs_state import hash_slot


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


def probe_traffic(h_lv, h_u, h_pos, q_lv, q_u, *,
                  max_probes: int = 64) -> dict:
    """The table reads a lookup needs, in 32-byte sectors of each array.

    Every probe reads ``h_pos`` and ``h_lv`` at its slot; ``h_u`` only
    where ``h_lv`` matches the query.  Two counts:

    * ``chain_*``: per query, a sector counted once while consecutive
      probes of its chain stay inside it (the traffic of a lookup that
      shares nothing between queries);
    * ``union_*``: distinct sectors over all queries (each table word read
      once at most: the least any lookup must read).

    Each is a count of sectors of one array (``lv`` stands for ``h_pos``
    and ``h_lv``, which are read at the same slots).  Also ``probes`` (the
    total) and ``u_reads`` (probes that read ``h_u``).  Sectors are
    ``slot // SECTOR_WORDS``: each array starts on a sector boundary.
    """
    dev = q_lv.device
    nsec = (h_lv.shape[0] + SECTOR_WORDS - 1) // SECTOR_WORDS
    last = {k: torch.full(q_lv.shape, -1, dtype=torch.int64, device=dev)
            for k in ("lv", "u")}
    seen = {k: torch.zeros(nsec, dtype=torch.bool, device=dev)
            for k in ("lv", "u")}
    tot = {k: torch.zeros((), dtype=torch.int64, device=dev)
           for k in ("probes", "u_reads", "chain_lv", "chain_u")}

    def visit(idx, active, lv_match):
        sec = idx // SECTOR_WORDS
        for k, reads in (("lv", active), ("u", active & lv_match)):
            tot[f"chain_{k}"] += (reads & (sec != last[k])).sum()
            last[k] = torch.where(reads, sec, last[k])
            seen[k][sec[reads]] = True
        tot["probes"] += active.sum()
        tot["u_reads"] += (active & lv_match).sum()

    _probe(h_lv, h_u, h_pos, q_lv, q_u, None, max_probes, visit)
    out = {k: int(v) for k, v in tot.items()}
    out.update(union_lv=int(seen["lv"].sum()), union_u=int(seen["u"].sum()))
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


def hash_lookup(h_lv, h_u, h_pos, q_lv, q_u, max_probes: int = 64):
    return probe(h_lv, h_u, h_pos, q_lv, q_u, max_probes=max_probes)
