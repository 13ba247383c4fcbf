"""Plain torch version of the fused LIF + trace update (``repro.kernels.lif.ref``)."""
from __future__ import annotations

import torch


def lif_step(v: torch.Tensor, tr: torch.Tensor, current: torch.Tensor, *,
             alpha: float, beta: float, theta: float):
    """(v, tr, I) -> (v', tr', s): leaky integrate, fire, soft reset, trace."""
    v = alpha * v + current
    s = (v >= theta).to(v.dtype)
    v = v - s * theta
    tr = beta * tr + s
    return v, tr, s
