"""PyTorch + CUDA port of the distributed MST system (``src/repro``).

It imports ``torch`` and numpy only.  Entry point:
:func:`repro_torch.core.mst_api.minimum_spanning_forest`.  The hand-written
Hopper kernels live in :mod:`repro_torch.kernels`.
"""
