"""WKV6 dispatch: the entry points the RWKV6 model calls.

The JAX package's ``wkv6`` runs its jnp scan unless ``use_pallas`` picks
the Pallas kernel, and takes the scan whenever the final state is asked
for; no model path passes ``use_pallas`` (ROADMAP hazard H9).  The port
has no such flag: on the card the stateless and the stateful forward both
run the kernel, on the CPU the plain version.  ``wkv6_step``, one decode
token, is plain tensor code on both, as in the JAX package.
"""
from __future__ import annotations

from repro_torch.kernels.rwkv6 import ref
from repro_torch.kernels.rwkv6.wkv6 import wkv6 as _wkv6


def wkv6(r, k, v, w, u, *, return_state: bool = False):
    """r, k, v, w (BH, T, D); u (BH, D).  The kernel on a CUDA tensor, the
    plain version on a CPU tensor, and any other device raises."""
    return _wkv6(r, k, v, w, u, return_state=return_state)


wkv6_step = ref.wkv6_step
