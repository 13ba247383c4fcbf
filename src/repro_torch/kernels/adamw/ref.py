"""Plain torch AdamW of one leaf, and the gradients' sums of squares: the
CPU path of ``optim/optimizer.adamw_update`` and the oracle of the fused
kernels (``repro.optim.optimizer.adamw_update``, jnp in the reference).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# On this path a leaf above this many elements is updated a leading slice
# at a time, so that its f32 temporaries stay a slab large (Mamba2-2.7B's
# stacked in_proj would take 6.9 GB each). The kernel on the card keeps no
# temporaries and takes every leaf whole.
ADAMW_SLAB = 1 << 26


def sq_sums(blocks: Sequence[torch.Tensor], split: Sequence[bool]
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(sum of squares of the blocks not ``split``, of those ``split``): f32
    0-d tensors, None where there are no such blocks."""
    sq = [b.float().square().sum() for b, sp in zip(blocks, split) if not sp]
    part = [b.float().square().sum() for b, sp in zip(blocks, split) if sp]
    return (torch.stack(sq).sum() if sq else None,
            torch.stack(part).sum() if part else None)


def update(g, p, m, v, s, clip, cfg, lr: float, bc1: float, bc2: float
           ) -> None:
    """AdamW on one leaf (or a view of one) in place: ``p``, ``m``, ``v``;
    ``s`` None or the gate scale, broadcastable to ``p``."""
    if p.numel() > ADAMW_SLAB and p.dim() > 1:
        # slabs of the leading axis of at most ADAMW_SLAB elements (a
        # single row is split again): the update is elementwise, so the
        # result is the same bit for bit
        s = None if s is None else torch.broadcast_to(s, p.shape)
        rows = ADAMW_SLAB // (p.numel() // p.shape[0])
        for i in range(0, p.shape[0], max(rows, 1)):
            ix = slice(i, i + rows) if rows > 1 else i
            update(g[ix], p[ix], m[ix], v[ix], None if s is None else s[ix],
                   clip, cfg, lr, bc1, bc2)
        return
    g = g.float() * clip
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    step_ = lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    step_ = step_ + lr * cfg.weight_decay * p.float()
    if s is not None:
        step_ = step_ * s
    p.copy_((p.float() - step_).to(p.dtype))
