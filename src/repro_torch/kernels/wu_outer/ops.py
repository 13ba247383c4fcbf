"""Public gated sparse-WU ops (``repro.kernels.wu_outer.ops``).

Dispatch is by the tensor's device: a CPU tensor runs the plain torch
version in ``ref.py``; a CUDA tensor launches the hand-written kernel
(``kernel.wu_outer_cuda``, ``kernel.wu_outer_slots_cuda``) or raises. There
is no fallback between them.

- :func:`wu_outer` returns the batch-summed ``dw`` (the reference's op);
  :func:`wu_outer_apply` returns ``wc + dw`` from the same launch (the
  training path's update).
- :func:`wu_outer_slots` is the per-slot update out of place, the
  reference's jnp op: plain torch on every device, and the oracle.
  :func:`wu_outer_slots_update` adds it into the deltas in place (the
  serving path), bit for bit as ``delta + wu_outer_slots(...)``.
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


def wu_outer_apply(wc: torch.Tensor, pre: torch.Tensor, mod: torch.Tensor,
                   idx: torch.Tensor, scale, *, bk: int, bo: int) -> torch.Tensor:
    """``wc + wu_outer(pre, mod, idx, scale)`` in a fresh tensor: on the
    card one launch, the add fused in and rounded as the plain add rounds
    it; a closed gate (``scale = 0``) gives ``wc`` unchanged."""
    scale = torch.as_tensor(scale, dtype=pre.dtype, device=pre.device)
    if pre.is_cuda:
        from .kernel import wu_outer_cuda
        return wu_outer_cuda(pre, mod, idx, scale, bk=bk, bo=bo, wc=wc)
    return wc + ref.wu_outer(pre, mod, idx, scale, bk, bo)


def wu_outer_slots(pre: torch.Tensor, mod: torch.Tensor, idx: torch.Tensor,
                   scale, *, bk: int, bo: int) -> torch.Tensor:
    """Per-slot compact WU: each slot keeps its own ``[J, T, bk, bo]`` update."""
    scale = torch.as_tensor(scale, dtype=pre.dtype, device=pre.device)
    return ref.wu_outer_slots(pre, mod, idx, scale, bk, bo)


def wu_outer_slots_update(delta: torch.Tensor, pre: torch.Tensor,
                          mod: torch.Tensor, idx: torch.Tensor, scale, *,
                          bk: int, bo: int) -> torch.Tensor:
    """``delta += wu_outer_slots(pre, mod, idx, scale)`` in place; returns
    ``delta`` (``[S, J, T, bk, bo]``, its slots may lie apart: one layer of
    slot-leading ``[S, L, ...]`` deltas). On the card one launch that skips
    the slots whose scale is 0; the result equals the plain add bit for bit
    (up to the sign of a zero on a closed slot)."""
    scale = torch.as_tensor(scale, dtype=pre.dtype, device=pre.device)
    if delta.is_cuda:
        from .kernel import wu_outer_slots_cuda
        return wu_outer_slots_cuda(delta, pre, mod, idx, scale, bk=bk, bo=bo)
    return delta.add_(ref.wu_outer_slots(pre, mod, idx, scale, bk, bo))
