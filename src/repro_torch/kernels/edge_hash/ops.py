"""Edge-hash ops: build the table on the host, pack it into records on the
device once, look queries up there.  ``resolve_batch`` (the GHS
superstep's pre-pass) comes with the GHS engine (ROADMAP queue 1, item
12)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.core.ghs_state import _build_hash_table
from repro_torch.kernels.edge_hash import ref
from repro_torch.kernels.edge_hash.edge_hash import (
    hash_lookup_records, pack_records)


def build_table(lv: np.ndarray, u: np.ndarray, pos: np.ndarray, tsize: int):
    """Host-side vectorized linear-probe insertion (init time, paper §3.3);
    returns numpy int32 arrays ``(h_lv, h_u, h_pos)``."""
    return _build_hash_table(lv.astype(np.int32), u.astype(np.int32),
                             pos.astype(np.int32), tsize)


def _put(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int32, device=dev).contiguous()


def pack_table(table, device=None) -> torch.Tensor:
    """The three arrays of ``build_table`` as one ``(T, 4)`` int32 tensor of
    records ``(lv, u, pos, 0)`` on ``device`` (CUDA by default, raising
    when there is no card; ``"cpu"`` for the plain path): the layout the
    kernel reads, made once when the table goes to the card."""
    dev = runtime.resolve_device(device)
    return pack_records(*(_put(t, dev) for t in table))


def lookup(table, q_lv, q_u, *, use_pallas: bool = True,
           device=None) -> torch.Tensor:
    """Look each ``(q_lv, q_u)`` up in ``table``; int32 positions, -1 for a
    miss.  ``table`` is the three arrays of ``build_table``, packed here,
    or a table ``pack_table`` packed once.  Arrays are moved to ``device``
    (CUDA by default, raising when there is no card; ``"cpu"`` for the
    plain path).  ``use_pallas=True`` runs the hand-written kernel,
    otherwise the early-exit probe oracle.
    """
    dev = runtime.resolve_device(device)
    records = (_put(table, dev) if isinstance(table, torch.Tensor)
               else pack_table(table, dev))
    q_lv, q_u = _put(q_lv, dev), _put(q_u, dev)
    if use_pallas:
        return hash_lookup_records(records, q_lv, q_u)
    return ref.hash_lookup(*ref.unpack(records), q_lv, q_u)
