"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
the launch counts that show a run went through the kernels.

Each kernel wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel on a CUDA tensor, and nowhere else; on a CPU tensor it
runs the plain version and counts nothing.  On a ``meta`` tensor (the dry
run, ``launch/dryrun.py``) the model kernels K6-K9 return empty outputs
and count nothing; the others raise.  Each entry is also wrapped by
``launch/flops.kernel``, which charges the call's work under the same name
to an active ``CostCounter``, on either device.
"""
from __future__ import annotations

# name -> (source in the repo, the Pallas function it replaces; for
# ghs_superstep, which replaces no Pallas kernel, the reference's device
# loop)
KERNELS = {
    "segmented_min2_scan": (
        "src/repro_torch/kernels/csrc/segscan.cu",
        "src/repro/kernels/segment_min/segment_min.py:101"),
    "masked_minplus_scan": (
        "src/repro_torch/kernels/csrc/segscan.cu",
        "src/repro/kernels/spmv_minplus/spmv_minplus.py:96"),
    "pointer_jump": (
        "src/repro_torch/kernels/csrc/pointer_jump.cu",
        "src/repro/kernels/spmv_minplus/spmv_minplus.py:153"),
    "segmented_min_scan": (
        "src/repro_torch/kernels/csrc/segscan.cu",
        "src/repro/kernels/segment_min/segment_min.py:136"),
    "hash_lookup": (
        "src/repro_torch/kernels/csrc/edge_hash.cu",
        "src/repro/kernels/edge_hash/edge_hash.py:58"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:65"),
    "decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:58"),
    "wkv6": (
        "src/repro_torch/kernels/csrc/wkv6.cu",
        "src/repro/kernels/rwkv6/rwkv6.py:51"),
    "selective_scan": (
        "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "src/repro/kernels/mamba_scan/mamba_scan.py:52"),
    "ghs_superstep": (
        "src/repro_torch/kernels/csrc/ghs_superstep.cu",
        "src/repro/core/ghs_message.py:591"),
}

LAUNCHES = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
