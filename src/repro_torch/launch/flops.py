"""Op-level FLOP and byte counter, the counterpart of the JAX package's
jaxpr counter (``repro/launch/flops.py``), and the charges of the port's
hand-written kernels.

:class:`CostCounter` is a ``TorchDispatchMode``: while it is active, every
aten op that runs is charged by the JAX counter's rules
(``repro/launch/flops.py:18-125``), restated for aten:

* **products** (:data:`PRODUCTS`: ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``convolution``, ``_grouped_mm``) cost 2·(output elements)·K FLOPs, and
  the same again in ``matmul_flops``.  A grouped product costs 2·rows·D·F
  over all its groups, which is what the JAX counter means for
  ``ragged_dot`` (``flops.py:112-117``);
* **data movement** (:data:`MOVES`, the counterparts of
  ``ELEMENTWISE_FREE``: copies and casts, ``cat``, ``index``, ``gather``,
  the scatters, ``index_put_``, ``constant_pad_nd``, ``flip``, and the
  factories) costs its bytes only;
* **views** (:data:`VIEWS`, and any op whose schema returns an alias of an
  input) cost nothing.  Eager PyTorch moves no memory for a view, where
  the JAX counter charges a jaxpr ``reshape`` or ``transpose`` its bytes;
* **every other op** costs one FLOP an output element.

An op's bytes are its tensor inputs plus its tensor outputs (an in-place
op that returns nothing: the tensors it writes), fusion-naive, an upper
bound on device traffic, as in the JAX counter.

The JAX counter traces abstractly; eager PyTorch runs the function, so
:func:`cost_of` counts what runs, at the sizes it is given.  There is no
``while_bodies``: every Python loop of the port (the label loop's host
reads among them, ROADMAP hazard H13) is counted for the trips it
actually runs.  The counter sees an autograd backward too, also on the
card, where the engine runs it on a thread of its own, and the recompute
of ``torch.utils.checkpoint``: the dispatch mode is thread-local state
that the engine carries to its threads.  A recompute is counted as far
as it runs: PyTorch stops it at the last tensor the backward needs.

**Kernel charges.**  A kernel launched through ``ctypes`` runs no aten op
that the mode could see (ROADMAP hazard H19), while its plain version on
the CPU runs many.  So each kernel entry is wrapped by :func:`kernel`,
which charges the call by one rule, :func:`kernel_cost`, through
:func:`charge`, whatever device it runs on, and hides the aten ops inside
the call from the counter: the plain version's on the CPU, the
``empty_like`` and the like on the card.  The rule:

* bytes: the call's tensor inputs and outputs, each once;
* FLOPs: its output elements plus its matmul FLOPs;
* matmul FLOPs: the dot FLOPs that the JAX counter finds in the Pallas
  function's JAX reference (``repro/kernels/<k>/ref.py``) at the same
  shapes: 4·B·Hq·S·S_kv·D for ``flash_attention`` (the masked half
  included: the reference computes it), 4·B·Hq·S·D for
  ``decode_attention`` over the whole cache, and 0 for the others (the
  references of ``wkv6`` and ``selective_scan`` multiply elementwise and
  sum; the MST kernels compare).

The rule is the work the function defines, not the least work (the
kernels' bounds in ``PERF.md`` are that).  It understates the GHS interval
kernel, whose messages are a loop over a state updated in place; its
metric stays ns a message.  With no counter active a kernel entry costs
one check of the thread's dispatch-mode stack.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)

PRODUCTS = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution",
                      "_grouped_mm"})

MOVES = frozenset({
    # copies and casts (convert_element_type, copy)
    "_to_copy", "copy_", "copy", "clone", "_copy_from",
    "_copy_from_and_resize", "lift_fresh_copy", "_local_scalar_dense",
    # concatenate, pad, rev
    "cat", "constant_pad_nd", "flip", "roll",
    # gather and scatter
    "index", "index_select", "gather", "embedding", "take",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_put", "index_put_", "_index_put_impl_",
    "index_add", "index_add_", "index_copy", "index_copy_",
    "slice_scatter", "select_scatter", "masked_scatter",
    "embedding_dense_backward",
    # factories (iota, broadcast of a constant)
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
    "ones_like", "new_ones", "full", "full_like", "new_full", "arange",
    "scalar_tensor", "zero_", "fill_", "fill",
})

VIEWS = frozenset({"view", "_unsafe_view", "as_strided", "t", "transpose",
                   "permute", "expand", "squeeze", "unsqueeze", "slice",
                   "select", "alias", "detach", "_reshape_alias"})

_KINDS: dict = {}          # op overload -> "product" | "move" | "view" | "op"
_mode_depth = torch._C._len_torch_dispatch_stack    # this thread's modes


def _kind(func) -> str:
    kind = _KINDS.get(func)
    if kind is None:
        name = func.overloadpacket.__name__
        if name in PRODUCTS:
            kind = "product"
        elif name in MOVES:
            kind = "move"
        elif name in VIEWS or func.is_view:
            kind = "view"
        else:
            kind = "op"
        _KINDS[func] = kind
    return kind


def _tensors(tree) -> list:
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _product_flops(name: str, args, out) -> int:
    """2·(output elements)·K for the aten products of :data:`PRODUCTS`."""
    if name == "mm" or name == "bmm":
        return 2 * out.numel() * args[0].shape[-1]
    if name == "addmm" or name == "baddbmm":
        return 2 * out.numel() * args[1].shape[-1]
    if name == "_grouped_mm":
        a, b = args[0], args[1]
        if a.ndim == 2 and b.ndim == 2:      # groups along K: (M, K) (K, N)
            return 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return 2 * out.numel() * a.shape[-1]
    if name == "convolution":
        x, w, transposed = args[0], args[1], args[6]
        if transposed:        # each input element meets (out/groups)·kernel
            return 2 * x.numel() * math.prod(w.shape[1:])
        return 2 * out.numel() * math.prod(w.shape[1:])
    raise KeyError(name)


class CostCounter(TorchDispatchMode):
    """Counts the aten ops that run while it is active, and the kernel
    charges made meanwhile (:func:`charge`).  ``flops``, ``bytes`` and
    ``matmul_flops`` include the kernels'; ``kernels`` maps a kernel's
    name to ``dict(calls=, flops=, bytes=, matmul_flops=)``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.matmul_flops = 0
        self.kernels: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _kind(func)
        if kind == "view":
            return out
        outs = _tensors(out)
        if not outs:            # an in-place op that returns nothing
            outs = [a for a, s in zip(_pytree.tree_leaves(args),
                                      _written(func, args))
                    if s and isinstance(a, torch.Tensor)]
        self.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        if kind == "product":
            f = _product_flops(func.overloadpacket.__name__, args, out)
            self.flops += f
            self.matmul_flops += f
        elif kind == "op":
            self.flops += sum(t.numel() for t in outs)
        return out

    def add_kernel(self, name: str, flops: int, nbytes: int,
                   matmul_flops: int) -> None:
        entry = self.kernels.setdefault(
            name, dict(calls=0, flops=0, bytes=0, matmul_flops=0))
        entry["calls"] += 1
        entry["flops"] += flops
        entry["bytes"] += nbytes
        entry["matmul_flops"] += matmul_flops
        self.flops += flops
        self.bytes += nbytes
        self.matmul_flops += matmul_flops

    def result(self) -> dict:
        return dict(flops=self.flops, bytes=self.bytes,
                    matmul_flops=self.matmul_flops,
                    kernels={k: dict(v) for k, v in
                             sorted(self.kernels.items())})


def _written(func, args) -> list:
    """For each leaf of ``args``, whether the op's schema writes it."""
    flags = []
    for arg, value in zip(func._schema.arguments, args):
        w = arg.alias_info is not None and arg.alias_info.is_write
        flags += [w] * len(_pytree.tree_leaves(value))
    return flags


def active() -> Optional[CostCounter]:
    """The innermost active :class:`CostCounter` of this thread, if any."""
    if not _mode_depth():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def charge(name: str, *, flops: int, bytes: int, matmul_flops: int) -> None:
    """Record one call of kernel ``name`` and its work on the active
    counter; nothing when none is active."""
    counter = active()
    if counter is not None:
        counter.add_kernel(name, flops, bytes, matmul_flops)


def kernel_cost(args, out, matmul_flops: int = 0) -> dict:
    """The one rule every kernel is charged by: bytes of its tensor inputs
    and outputs, each once; FLOPs of its output elements plus its matmul
    FLOPs."""
    ins = {id(t): t for t in _tensors(args)}
    outs = {id(t): t for t in _tensors(out)}
    nbytes = _nbytes(ins.values()) + _nbytes(
        t for i, t in outs.items() if i not in ins)
    elements = sum(t.numel() for t in outs.values())
    return dict(flops=elements + matmul_flops, bytes=nbytes,
                matmul_flops=matmul_flops)


def kernel(name: str, matmul_flops: Optional[Callable] = None):
    """Wrap a kernel entry: with a counter active, run the call with every
    dispatch mode set aside (the counter sees none of its aten ops), then
    :func:`charge` it by :func:`kernel_cost`; ``matmul_flops(*args,
    **kwargs)`` gives its matmul FLOPs (0 if not given).  With none
    active, call through."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if not _mode_depth() or active() is None:
                return fn(*args, **kwargs)
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            mm = matmul_flops(*args, **kwargs) if matmul_flops else 0
            charge(name, **kernel_cost((args, kwargs), out, mm))
            return out
        return entry
    return wrap


def attention_matmul_flops(q, k, v, *args, **kwargs) -> int:
    """The two products of ``flash_attention/ref.py`` (q (B, Hq, S, D), k
    (B, Hkv, S_kv, D)) and of ``decode_attention/ref.py`` (q (B, Hq, D), k
    (B, Hkv, S, D)): 2·2·(q's elements)·(k's length)."""
    return 4 * q.numel() * k.shape[2]


def cost_of(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; returns
    ``dict(flops=, bytes=, matmul_flops=, kernels={name: dict(calls=,
    flops=, bytes=, matmul_flops=)})``."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()
