"""Public gated sparse-WU ops (``repro.kernels.wu_outer.ops``).

``wu_outer`` (batch-summed, the training shape) dispatches by the tensor's
device: a CPU tensor runs the plain torch version in ``ref.py``; a CUDA
tensor launches the hand-written kernel (``kernel.wu_outer_cuda``) or
raises. There is no fallback between them. ``wu_outer_slots`` has no
kernel in the reference (it is jnp only there), so it is plain torch on
every device.
"""
from __future__ import annotations

import torch

from . import ref


def wu_outer(pre: torch.Tensor, mod: torch.Tensor, idx: torch.Tensor,
             scale, *, bk: int, bo: int) -> torch.Tensor:
    """``ΔW_compact = scale · gather(pre)ᵀ @ mod``, compact layout only.

    ``scale`` (lr × gate) is cast to ``pre``'s dtype, as the reference casts
    it; a device tensor stays on the device. Ragged batches are masked
    inside the CUDA kernel, so nothing is padded here.
    """
    scale = torch.as_tensor(scale, dtype=pre.dtype, device=pre.device)
    if pre.is_cuda:
        from .kernel import wu_outer_cuda
        return wu_outer_cuda(pre, mod, idx, scale, bk=bk, bo=bo)
    return ref.wu_outer(pre, mod, idx, scale, bk, bo)


def wu_outer_slots(pre: torch.Tensor, mod: torch.Tensor, idx: torch.Tensor,
                   scale, *, bk: int, bo: int) -> torch.Tensor:
    """Per-slot compact WU: each slot keeps its own ``[J, T, bk, bo]`` update."""
    scale = torch.as_tensor(scale, dtype=pre.dtype, device=pre.device)
    return ref.wu_outer_slots(pre, mod, idx, scale, bk, bo)
