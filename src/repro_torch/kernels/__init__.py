"""Hand-written Hopper kernels, one package per reference Pallas kernel,
and ``adamw/`` (the fused AdamW of LM training; no Pallas kernel).

Each ``kernels/<name>/`` holds ``ref.py`` (the plain torch version: the CPU
path and the test oracle), ``ops.py`` (the wrapper: plain version for CPU
tensors, the kernel for CUDA tensors, never a fallback) and ``kernel.py``
(the GPU launch, with its CUDA C++ or Triton source beside it). Kernels are
built at first use, never at import, into ``build/torch_kernels/``.
"""


def launch_counters() -> dict:
    """``{kernel name: wrapper}``: each wrapper adds one to its
    ``launches`` where it launches its kernel on the card, and nowhere
    else (``nm_spmm_fused`` counts on ``nm_spmm`` too). Importing the
    wrappers builds nothing."""
    from .adamw.kernel import adamw_norm_cuda, adamw_update_cuda
    from .flash_attn.kernel import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                    flash_fwd_cuda)
    from .lif.kernel import lif_cuda
    from .nm_spmm.kernel import nm_spmm_cuda, nm_spmm_fused_cuda
    from .wu_outer.kernel import wu_outer_cuda, wu_outer_slots_cuda
    return {"nm_spmm": nm_spmm_cuda, "nm_spmm_fused": nm_spmm_fused_cuda,
            "lif": lif_cuda, "wu_outer": wu_outer_cuda,
            "wu_outer_slots": wu_outer_slots_cuda,
            "flash_fwd": flash_fwd_cuda, "flash_bwd_dkv": flash_bwd_dkv_cuda,
            "flash_bwd_dq": flash_bwd_dq_cuda,
            "adamw_norm": adamw_norm_cuda, "adamw_update": adamw_update_cuda}


def launch_counts() -> dict:
    """``{kernel name: launches}`` in this process so far."""
    return {n: f.launches for n, f in launch_counters().items()}
