"""The GHS interval kernel: one launch runs up to ``n_steps`` supersteps of
one shard of the paper-faithful GHS engine.

No Pallas kernel precedes it.  The JAX package runs the superstep loop on
the device as nested ``lax.while_loop``s over scalar state
(``core/ghs_message.py``: ``interval_core`` at line 591, ``process_main``,
``process_test_q``, the hash probe and ``test_proc``'s cursor scan); torch
has no device loop, so ``csrc/ghs_superstep.cu`` is that loop's
counterpart.  GHS is sequential by design (one message at a time, each
handler reading what the last one wrote), so one thread runs the shard's
loop: the launch is a chain of dependent loads, bound by their latency
and not by the bytes it touches.  A block of ``THREADS`` threads first
finds how many inbox rows may hold words (so a flush rewrites only those);
then thread 0 runs the interval.  The lookup method, the lane count and
``relaxed_test_queue`` are template parameters, one instance each.

:func:`interval` launches the kernel on CUDA tensors (built on first use,
counted in ``kernels.LAUNCHES["ghs_superstep"]``) and runs the plain
version ``ref.interval`` on CPU tensors.  The state is updated in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.ghs_state import ShardState
from repro_torch.kernels.ghs_superstep import ref
from repro_torch.kernels.ghs_superstep.ref import Config

THREADS = 256           # threads of the launch's one block (the inbox scan)
_SIZES = ("block", "qcap", "ocap", "xcap", "tsize", "hcap", "n_steps",
          "check", "empty_needed")


class _Args(ctypes.Structure):
    """The kernel's argument struct (``struct Shard`` in the source): one
    pointer a state field in ``ShardState`` order, the two scalar vectors,
    then the sizes."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ShardState._fields]
                + [("scal_in", ctypes.c_void_p), ("scal_out", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in _SIZES])


def _lib():
    from repro_torch.kernels import build
    lib = build.load("ghs_superstep")
    lib.ghs_superstep_interval.argtypes = [
        ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.ghs_superstep_interval.restype = ctypes.c_int
    return lib


def _check(state: ShardState, scal: torch.Tensor, cfg: Config) -> None:
    dev = scal.device
    for f in ShardState._fields + ("scal",):
        t = scal if f == "scal" else getattr(state, f)
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"ghs_superstep: {f} must be contiguous int32 "
                             f"on {dev}")
    if scal.shape != (3,):
        raise ValueError("ghs_superstep: the scalar vector has 3 words")
    if state.og.shape[0] != 1:
        raise NotImplementedError("ghs_superstep: one shard only")
    if (state.mq.shape != (cfg.qcap, cfg.lanes)
            or state.og.shape != (1, cfg.ocap, cfg.lanes)
            or state.inbox.shape != (1, cfg.xcap, cfg.lanes)
            or state.h_lv.shape != (cfg.tsize,)
            or state.indptr.shape != (cfg.block + 1,)):
        raise ValueError("ghs_superstep: state shapes differ from the config")


def interval(state: ShardState, scal: torch.Tensor, n_steps: int,
             cfg: Config) -> torch.Tensor:
    """Run up to ``n_steps`` supersteps of ``state`` in place, from
    ``scal = [step0, silent0, ...]`` (int32, on the state's device).
    Returns a new vector ``[step0 + steps_run, silent_streak, err]`` on the
    same device; the launch is queued, not waited for.  A call from a
    silent state (streak at ``cfg.empty_needed``) runs nothing.  CUDA
    tensors launch the kernel, CPU tensors run the plain version, any
    other device raises."""
    _check(state, scal, cfg)
    dev = scal.device
    if dev.type == "cpu":
        return ref.interval(state, scal, n_steps, cfg)
    if dev.type != "cuda":
        raise RuntimeError(f"ghs_superstep: no kernel for {dev}")
    from repro_torch.kernels import build
    out = torch.empty(3, dtype=torch.int32, device=dev)
    args = _Args(*[getattr(state, f).data_ptr() for f in ShardState._fields],
                 scal.data_ptr(), out.data_ptr(),
                 cfg.block, cfg.qcap, cfg.ocap, cfg.xcap, cfg.tsize,
                 state.hist_act.shape[0], int(n_steps), cfg.check,
                 cfg.empty_needed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().ghs_superstep_interval(
        ctypes.byref(args), ref.METHODS.index(cfg.method), cfg.lanes,
        int(cfg.relaxed), THREADS, stream)
    build.check(err, "ghs_superstep")
    kernels.LAUNCHES["ghs_superstep"] += 1
    return out
