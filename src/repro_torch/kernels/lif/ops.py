"""Public fused-LIF op (``repro.kernels.lif.ops``): the Triton kernel for
CUDA tensors, the plain torch version for CPU tensors, never a fallback."""
from __future__ import annotations

import torch

from . import ref


def lif_step(v: torch.Tensor, tr: torch.Tensor, current: torch.Tensor, *,
             alpha: float, beta: float, theta: float):
    """Fused LIF update ``(v, tr, I) -> (v', tr', s)`` on ``[B, N]``."""
    if v.is_cuda:
        from .kernel import lif_cuda
        return lif_cuda(v, tr, current, alpha=alpha, beta=beta, theta=theta)
    return ref.lif_step(v, tr, current, alpha=alpha, beta=beta, theta=theta)
