"""Backend pinning, the counterpart of the JAX package's ``platform.py``.

A run that lands on another device than it meant, or that multiplies
float32 on the tensor cores in TF32, gives numbers that cannot be compared
with another run's.  This module is the one home for that pinning:

* :func:`set_platform` -- ``"cpu"`` hides every card from the process
  (``CUDA_VISIBLE_DEVICES=""``), so an entry point that defaults to the
  card raises instead of running somewhere else; ``"gpu"`` requires a card
  (no fallback) and pins float32 products without TF32, for matmuls and
  cuDNN (ROADMAP hazard H8).
* :func:`set_debug_nan` -- autograd's anomaly mode.
* :func:`pin` -- both, in that order, and a record of what was pinned.

Like the reference's helpers, :func:`set_platform` raises when it is
called too late to take effect: after CUDA has initialized.

No counterpart, by design:

* ``force_host_device_count`` -- the fake process group of the dry run,
  ``launch/mesh.fake_world``, takes its place;
* ``set_x64`` -- the port carries 64-bit words explicitly, as int64 with
  the sign bit flipped (hazard H2), so there is no global width to set;
* ``latency_hiding_flags`` -- XLA flags; their counterpart is NCCL overlap
  across cards (ROADMAP queue 1, item 13b).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

PLATFORMS = ("cpu", "gpu")


def _require_uninitialized(what: str) -> None:
    if torch.cuda.is_initialized():
        raise RuntimeError(
            f"{what} must be set before CUDA initializes; call "
            f"repro_torch.platform helpers at process start")


def set_platform(platform: str = "cpu") -> None:
    """Pin the process to ``"cpu"`` or ``"gpu"``; any other name raises
    ``ValueError``, a call after CUDA has initialized ``RuntimeError``."""
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; options: "
                         f"{PLATFORMS}")
    _require_uninitialized("the platform")
    if platform == "cpu":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        if torch.cuda.is_available():     # CUDA counted the cards before
            raise RuntimeError(
                "the platform must be set before CUDA counts the devices")
        return
    if not torch.cuda.is_available():
        raise RuntimeError("platform 'gpu': no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def set_debug_nan(enable: bool = True) -> None:
    """Autograd's anomaly mode: a backward function that returns a NaN
    raises, naming the forward op that made it.  The reference's
    ``jax_debug_nans`` also stops at a NaN made in a forward; this catches
    one made in a backward only."""
    torch.autograd.set_detect_anomaly(enable)


def pin(platform: Optional[str] = None,
        debug_nan: Optional[bool] = None) -> dict:
    """Apply the requested pins (the platform first) and return what holds
    now: the device name and count, the torch and CUDA versions, the TF32
    flags and anomaly mode."""
    if platform is not None:
        set_platform(platform)
    if debug_nan is not None:
        set_debug_nan(debug_nan)
    on_card = platform == "gpu" or (platform is None
                                    and torch.cuda.is_available())
    return dict(
        platform="gpu" if on_card else "cpu",
        device=torch.cuda.get_device_name(0) if on_card else "cpu",
        count=torch.cuda.device_count() if on_card else 0,
        torch=torch.__version__, cuda=torch.version.cuda,
        tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                  cudnn=torch.backends.cudnn.allow_tf32),
        debug_nan=torch.is_anomaly_enabled())
