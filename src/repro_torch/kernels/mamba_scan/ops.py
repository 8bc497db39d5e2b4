"""Selective-scan dispatch: the entry points the Mamba mixer calls.

The JAX package's ``selective_scan`` runs its jnp scan unless
``use_pallas`` picks the Pallas kernel, and takes the scan whenever the
final state is asked for; no model path passes ``use_pallas`` (ROADMAP
hazard H9).  The port has no such flag: on the card the stateless and the
stateful scan both run the kernel, on the CPU the plain version.
``selective_scan_step``, one decode token, is plain tensor code on both, as
in the JAX package.
"""
from __future__ import annotations

from repro_torch.kernels.mamba_scan import ref
from repro_torch.kernels.mamba_scan.mamba_scan import \
    selective_scan as _selective_scan


def selective_scan(x, dt, b, c, a, d, *, return_state: bool = False):
    """x, dt (B, T, dim); b, c (B, T, N); a (dim, N); d (dim,).  The kernel
    on a CUDA tensor, the plain version on a CPU tensor, and any other
    device raises."""
    return _selective_scan(x, dt, b, c, a, d, return_state=return_state)


selective_scan_step = ref.selective_scan_step
