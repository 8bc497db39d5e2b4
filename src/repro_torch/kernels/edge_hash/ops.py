"""Edge-hash ops: build the table on the host, look queries up on the
device.  ``resolve_batch`` (the GHS superstep's pre-pass) comes with the
GHS engine (ROADMAP queue 1, item 12)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import runtime
from repro_torch.core.ghs_state import _build_hash_table
from repro_torch.kernels.edge_hash import ref
from repro_torch.kernels.edge_hash.edge_hash import hash_lookup


def build_table(lv: np.ndarray, u: np.ndarray, pos: np.ndarray, tsize: int):
    """Host-side vectorized linear-probe insertion (init time, paper §3.3);
    returns numpy int32 arrays ``(h_lv, h_u, h_pos)``."""
    return _build_hash_table(lv.astype(np.int32), u.astype(np.int32),
                             pos.astype(np.int32), tsize)


def lookup(table, q_lv, q_u, *, use_pallas: bool = True,
           device=None) -> torch.Tensor:
    """Look each ``(q_lv, q_u)`` up in ``table``; int32 positions, -1 for a
    miss.  Arrays are moved to ``device`` (CUDA by default, raising when
    there is no card; ``"cpu"`` for the plain path).  ``use_pallas=True``
    runs the hand-written kernel, otherwise the early-exit probe oracle.
    """
    dev = runtime.resolve_device(device)

    def put(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev).contiguous()

    h_lv, h_u, h_pos = (put(t) for t in table)
    q_lv, q_u = put(q_lv), put(q_u)
    if use_pallas:
        return hash_lookup(h_lv, h_u, h_pos, q_lv, q_u)
    return ref.hash_lookup(h_lv, h_u, h_pos, q_lv, q_u)
