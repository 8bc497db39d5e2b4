"""The GHS interval kernel: one launch runs up to ``n_steps`` supersteps of
the S shards of the paper-faithful GHS engine, one block a shard.

No Pallas kernel precedes it.  The JAX package runs the superstep loop on
the device as nested ``lax.while_loop``s over scalar state
(``core/ghs_message.py``: ``interval_core`` at line 591, ``process_main``,
``process_test_q``, the hash probe and ``test_proc``'s cursor scan); torch
has no device loop, so ``csrc/ghs_superstep.cu`` is that loop's
counterpart.  GHS is sequential by design (one message at a time, each
handler reading what the last one wrote): the launch is a chain of
dependent loads, bound by their latency and not by the bytes it touches.
One warp runs each shard's loop to shorten that chain: its lanes scan an
adjacency window of 128 edge states a step by ballot (test_proc's first
Basic edge, h_initiate's Branch edges) and probe 32 hash slots a step;
the handled vertex's words are loaded in one burst into registers; the
next message's hash slots and adjacency bounds, and the one after's
words, are loaded while a message is handled.  Each block of
``THREADS`` threads first finds how many inbox rows may hold words; then
its warp 0 runs its shard's part of each superstep, and after a grid
barrier the whole block moves what every shard sent it into its inbox
(the reference's ``all_to_all``); a second barrier, and every block
sums the shards' activity and error words (the reference's ``psum``).
The launch is cooperative: all S blocks must be resident at once, which
:func:`interval` checks with the occupancy API, raising for an S that
does not fit.  The lookup method, the lane count and
``relaxed_test_queue`` are template parameters, one instance each.

:func:`interval` launches the kernel on CUDA tensors (built on first use,
counted in ``kernels.LAUNCHES["ghs_superstep"]``) and runs the plain
version ``ref.interval`` on CPU tensors.  The state (stacked over the
shards, or one shard without the axis) is updated in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.ghs_state import ShardState
from repro_torch.kernels.ghs_superstep import ref
from repro_torch.kernels.ghs_superstep.ref import Config
from repro_torch.launch import flops

THREADS = 256           # threads of a shard's block (inbox scan, exchange)
_SIZES = ("block", "qcap", "ocap", "xcap", "tsize", "hcap", "n_steps",
          "check", "empty_needed", "eb", "num_shards")


class _Args(ctypes.Structure):
    """The kernel's argument struct (``struct Shard`` in the source): one
    pointer a state field in ``ShardState`` order, the two scalar vectors,
    the exchange scratch, then the sizes."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ShardState._fields]
                + [("scal_in", ctypes.c_void_p), ("scal_out", ctypes.c_void_p),
                   ("xchg", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in _SIZES])


def _lib():
    from repro_torch.kernels import build
    lib = build.load("ghs_superstep")
    lib.ghs_superstep_interval.argtypes = [
        ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.ghs_superstep_interval.restype = ctypes.c_int
    lib.ghs_superstep_capacity.argtypes = [
        ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    lib.ghs_superstep_capacity.restype = ctypes.c_int
    return lib


_CAPACITY: dict = {}


def capacity(cfg: Config, num_shards: int, device: torch.device) -> int:
    """Blocks of the kernel instance for ``cfg`` the card holds at once in
    one cooperative grid, with ``num_shards`` shards' shared memory."""
    from repro_torch.kernels import build
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (cfg.method, cfg.lanes, cfg.relaxed, num_shards, index)
    if key not in _CAPACITY:
        blocks = ctypes.c_int(0)
        build.check(_lib().ghs_superstep_capacity(
            ref.METHODS.index(cfg.method), cfg.lanes, int(cfg.relaxed),
            THREADS, num_shards, index, ctypes.byref(blocks)),
            "ghs_superstep capacity")
        _CAPACITY[key] = blocks.value
    return _CAPACITY[key]


def _check(state: ShardState, scal: torch.Tensor, cfg: Config) -> None:
    dev = scal.device
    for f in ShardState._fields + ("scal",):
        t = scal if f == "scal" else getattr(state, f)
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"ghs_superstep: {f} must be contiguous int32 "
                             f"on {dev}")
    if scal.shape != (3,):
        raise ValueError("ghs_superstep: the scalar vector has 3 words")
    S = state.sn.shape[0]
    if (state.mq.shape != (S, cfg.qcap, cfg.lanes)
            or state.og.shape != (S, S, cfg.ocap, cfg.lanes)
            or state.inbox.shape != (S, S, cfg.xcap, cfg.lanes)
            or state.in_cnt.shape != (S, S)
            or state.h_lv.shape != (S, cfg.tsize)
            or state.indptr.shape != (S, cfg.block + 1)
            or state.nbr.dim() != 2 or state.hist_act.dim() != 2):
        raise ValueError("ghs_superstep: state shapes differ from the config")


@flops.kernel("ghs_superstep")
def interval(state: ShardState, scal: torch.Tensor, n_steps: int,
             cfg: Config) -> torch.Tensor:
    """Run up to ``n_steps`` supersteps of ``state`` in place, from
    ``scal = [step0, silent0, ...]`` (int32, on the state's device).
    ``state`` carries its S shards on the leading axis
    (``ghs_state.upload_stacked``); a state without the axis is one shard.
    Returns a new vector ``[step0 + steps_run, silent_streak, err]`` (the
    error words summed over the shards) on the same device; the launch is
    queued, not waited for.  A call from a silent state (streak at
    ``cfg.empty_needed``) runs nothing.  CUDA tensors launch the kernel,
    one cooperative launch of S blocks (an S the card cannot hold at once
    raises), CPU tensors run the plain version, any other device raises."""
    state = ref.stacked(state)
    _check(state, scal, cfg)
    dev = scal.device
    if dev.type == "cpu":
        return ref.interval(state, scal, n_steps, cfg)
    if dev.type != "cuda":
        raise RuntimeError(f"ghs_superstep: no kernel for {dev}")
    from repro_torch.kernels import build
    S = state.sn.shape[0]
    fits = capacity(cfg, S, dev)
    if S > fits:
        raise RuntimeError(
            f"ghs_superstep: {S} shards need {S} co-resident blocks of "
            f"{THREADS} threads; this card holds {fits} in one cooperative "
            f"grid")
    out = torch.empty(3, dtype=torch.int32, device=dev)
    xchg = torch.empty(2 * S * S + 4 * S, dtype=torch.int32, device=dev)
    args = _Args(*[getattr(state, f).data_ptr() for f in ShardState._fields],
                 scal.data_ptr(), out.data_ptr(), xchg.data_ptr(),
                 cfg.block, cfg.qcap, cfg.ocap, cfg.xcap, cfg.tsize,
                 state.hist_act.shape[1], int(n_steps), cfg.check,
                 cfg.empty_needed, state.nbr.shape[1], S)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().ghs_superstep_interval(
        ctypes.byref(args), ref.METHODS.index(cfg.method), cfg.lanes,
        int(cfg.relaxed), THREADS, stream)
    build.check(err, "ghs_superstep")
    kernels.LAUNCHES["ghs_superstep"] += 1
    return out
