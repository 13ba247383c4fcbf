"""Plain torch version of the gated three-factor sparse weight update
(``repro.kernels.wu_outer.ref``).

``dw_compact[j, t] = scale · pre[:, idx[j,t]]ᵀ @ mod[:, j·bo:(j+1)·bo]``:
the outer-product update exists only for kept blocks. ``scale`` folds the
learning rate and the IA/SS gate (0 when gated off).
"""
from __future__ import annotations

import torch


def wu_outer(pre: torch.Tensor, mod: torch.Tensor, idx: torch.Tensor,
             scale: torch.Tensor, bk: int, bo: int) -> torch.Tensor:
    """Batch-summed compact update ``[J, T, bk, bo]`` (the training shape)."""
    b, k = pre.shape
    j, t = idx.shape
    pg = pre.reshape(b, k // bk, bk)[:, idx, :]                # [B, J, T, bk]
    return scale * torch.einsum("bjtk,bjo->jtko", pg, mod.reshape(b, j, bo))


def wu_outer_slots(pre: torch.Tensor, mod: torch.Tensor, idx: torch.Tensor,
                   scale: torch.Tensor, bk: int, bo: int) -> torch.Tensor:
    """Per-slot compact update ``[S, J, T, bk, bo]``; ``scale [S]`` is the
    per-slot gate×lr.

    The association ``(scale · pre) · mod`` is the reference's exactly: it
    is what makes the compact update bitwise equal to the dense-delta rule
    at every kept coordinate.
    """
    s, k = pre.shape
    j, t = idx.shape
    pg = pre.reshape(s, k // bk, bk)[:, idx, :]                # [S, J, T, bk]
    modt = mod.reshape(s, j, bo)
    return ((scale[:, None, None, None] * pg)[..., None]
            * modt[:, :, None, None, :])
