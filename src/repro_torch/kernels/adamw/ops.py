"""AdamW's two passes over a parameter tree, by device: a CPU tensor runs
the plain torch version in ``ref.py``; a CUDA tensor launches the fused
kernels (``kernel.adamw_norm_cuda``, ``kernel.adamw_update_cuda``) or
raises. There is no fallback between them.

- :func:`sq_sums`: the gradients' sums of squares, the replicated blocks'
  and the model-split ones' apart (``optim/optimizer.global_norm``).
- :func:`update`: the update of every leaf in place, bit for bit the plain
  one on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import ref


def sq_sums(blocks: Sequence[torch.Tensor], split: Sequence[bool]
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(Σ squares of the blocks not ``split``, Σ of those ``split``): f32
    0-d tensors, None where there are no such blocks. On the card one
    launch, the same bits on every run."""
    if blocks and blocks[0].is_cuda:
        from .kernel import adamw_norm_cuda
        out = adamw_norm_cuda(blocks, split)
        return (None if all(split) else out[0],
                out[1] if any(split) else None)
    return ref.sq_sums(blocks, split)


def update(leaves: Sequence[tuple], clip: torch.Tensor, cfg, lr: float,
           bc1: float, bc2: float) -> None:
    """AdamW of every ``(g, p, m, v, scale)`` in place (``scale`` None or
    the leaf's gate scale). On the card one launch for the whole tree."""
    if leaves and leaves[0][1].is_cuda:
        from .kernel import adamw_update_cuda
        adamw_update_cuda(leaves, clip, cfg, lr, bc1, bc2)
        return
    for g, p, m, v, s in leaves:
        ref.update(g, p, m, v, s, clip, cfg, lr, bc1, bc2)
