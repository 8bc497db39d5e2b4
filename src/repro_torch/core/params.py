"""Algorithm parameters — field names and defaults of the JAX package's
``GHSParams``, so one set of settings can be handed to both packages."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GHSParams:
    """Tunables of the MST engines (paper §3.6 names and defaults).

    The port's Borůvka engine reads ``check_frequency`` (rounds per
    interval between host readbacks and compactions), ``compaction``,
    ``partitioner``, ``round_loop``, ``collective``, ``interval_pipeline``,
    ``round_kernel`` and ``use_pallas``:

    * ``round_loop="host"`` — the legacy host loop; it ignores
      ``round_kernel`` and ``interval_pipeline``, and with
      ``use_pallas=True`` its elections run the hand-written CUDA 32-bit
      segmented min-scan (the port of ``segmented_min_scan``).

    * ``round_kernel="xla"`` — per-edge round body; with ``use_pallas=True``
      its election runs the hand-written CUDA segmented pair-lex min-scan
      (the port of ``segmented_min2_scan``), otherwise a scatter-min.
    * ``round_kernel="pallas"`` — fused masked min-plus round body; with
      ``use_pallas=True`` the election and the shortcut run the
      hand-written CUDA kernels (ports of ``masked_minplus_scan`` and
      ``pointer_jump``), otherwise the scatter-free sort lowering (or the
      scatter lowering when the sort key does not fit 64 bits).

    The name ``use_pallas`` is kept so that settings carry over: in the
    port it selects the hand-written CUDA kernels.  On CPU tensors the
    kernels' plain PyTorch versions run in their place.  All settings give
    bit-identical forests.  The remaining fields belong to engines not yet
    ported and are carried unchanged.
    """

    max_msg_size: int = 4096
    sending_frequency: int = 1
    check_frequency: int = 5
    empty_iter_cnt_to_break: int = 1
    hash_table_factor: float = 5 * 11 / 13
    queue_capacity: int = 0
    use_hashing: bool = True
    relaxed_test_queue: bool = True
    compress_messages: bool = True
    compaction: str = "pow2"          # 'none' | 'pow2' lazy edge compaction
    use_pallas: bool = False          # hand-written CUDA kernels (see above)
    partitioner: str = "block"        # 'block' | 'hashed' | 'balanced'
    round_loop: str = "device"        # 'device' | 'host' (legacy loop)
    collective: str = "pmin"          # 'pmin' | 'compressed' (not yet)
    interval_pipeline: int = 1        # 1 double-buffers intervals, 0 not
    round_kernel: str = "xla"         # 'xla' | 'pallas' round body
    batch_bucket: str = "pow2"
    batch_max_vertices: int = 0
    batch_max_edges: int = 0
    batch_check_frequency: int = 1
    filter_sample_rate: float = 0.15
    filter_levels: int = 16
    filter_threshold: int = 0
    update_levels: int = 0
    serve_lanes: int = 8
    serve_max_wait_ms: float = 50.0
    serve_max_queue: int = 64


DEFAULT_PARAMS = GHSParams()
