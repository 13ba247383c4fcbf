"""AdamW and its schedule (``repro.optim.optimizer``), over the dict trees of
``models/transformer.py``.

Integer and boolean leaves (sparsity masks ``umask``, kept-row tables
``rows``) are structural, not trainable: they get no moments (an int8
scalar stands in, as in the reference) and no update; their gradients are
``None``.

The step counter is a host int, so the learning-rate schedule is computed
on the host (in float32, as the reference computes it on the device) and
nothing is read back from the card. The reference returns new params and
moments; ``adamw_update`` writes params, ``m`` and ``v`` in place (it saves
a second copy of the f32 moments, 14 GB at Qwen2-VL-2B) and returns them.

The two passes run through ``kernels/adamw``: on CPU tensors the plain
torch update (``ref.py``, a leaf above ``ADAMW_SLAB`` elements a slab at a
time); on the card two fused launches for the whole tree, the norm's and
the update's, the update bit for bit the plain one given the same clip
(the norm sums in another order, the same on every run).

Parameters placed as ``DTensor`` s (tensor parallelism, ``launch/spmd``):
each moment is a ``DTensor`` in its parameter's placements (ZeRO-1's block
also split over the DP axes), the update runs on the local blocks in
place, and ``global_norm`` sums every block's squares once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.adamw import ops as adamw_ops


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def trainable(leaf: torch.Tensor) -> bool:
    return leaf.is_floating_point()


class AdamWState(NamedTuple):
    step: int          # host int
    m: Any
    v: Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _local(x):
    """A ``DTensor``'s local block (the tensor itself otherwise)."""
    return x.to_local() if hasattr(x, "to_local") else x


def adamw_init(params, zero1=None) -> AdamWState:
    """Zero moments; with ``zero1`` (``adamw_update``'s tree) a split
    leaf's moments are its block only. A ``DTensor`` parameter's moments
    are ``DTensor`` s of its placements and local shape (ZeRO-1: the block
    along ``zero1``'s dim also split over the mesh's DP axes)."""
    def zeros(p, z=None):
        if trainable(p):
            shape = list(_local(p).shape)
            if z is not None:
                shape[z[0]] //= z[2]
            m = torch.zeros(shape, dtype=torch.float32, device=p.device)
            return _placed_moment(m, p, z) if hasattr(p, "to_local") else m
        return torch.zeros((), dtype=torch.int8, device=p.device)
    if zero1 is None:
        zero1 = tree_map(lambda _: None, params)
    return AdamWState(step=0, m=tree_map(zeros, params, zero1),
                      v=tree_map(zeros, params, zero1))


def _placed_moment(m, p, z):
    from torch.distributed.tensor import DTensor, Shard
    names = p.device_mesh.mesh_dim_names
    pls = [Shard(z[0]) if z is not None and n in ("pod", "data") else pl
           for n, pl in zip(names, p.placements)]
    return DTensor.from_local(m, p.device_mesh, pls, run_check=False)


def cosine_schedule(cfg: AdamWConfig, step: int) -> float:
    """Learning rate at host-int ``step``, in float32 as the reference."""
    f = np.float32
    s = f(step)
    warm = min(f(1.0), (s + f(1)) / f(max(1, cfg.warmup_steps)))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(1, cfg.total_steps - cfg.warmup_steps)), f(0), f(1))
    cos = f(0.5) * (f(1) + np.cos(f(math.pi) * prog, dtype=np.float32))
    return float(f(cfg.lr) * warm * (f(cfg.min_lr_frac)
                                     + (f(1) - f(cfg.min_lr_frac)) * cos))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the summed squares of every float leaf (``None`` skipped).
    A ``DTensor`` leaf split over the model axis adds its local block's
    squares, all-reduced over that axis once; a replicated one counts
    once, as a plain leaf."""
    import torch.distributed as dist
    from ..launch.spmd import model_dim
    blocks, split, group = [], [], None
    for l in tree_leaves(tree):
        if l is None or not trainable(l):
            continue
        blocks.append(_local(l))
        split.append(model_dim(l) is not None)
        if split[-1]:
            group = l.device_mesh.get_group("model")
    total, part = adamw_ops.sq_sums(blocks, split)
    if part is not None:
        dist.all_reduce(part, group=group)
        total = part if total is None else total + part
    return torch.sqrt(total)


def adamw_update(grads, params, state: AdamWState, cfg: AdamWConfig,
                 update_scale=None, zero1=None
                 ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step. ``update_scale``: optional tree of per-leaf scales
    (the activity-dependent gate: 0 skips a layer's update, the chip's
    gated WU applied to the optimizer; a masked weight's scale also carries
    its mask). Updates ``params``, ``m`` and ``v`` in place.

    ``zero1``: optional tree of ``(dim, index, parts)`` or None per leaf
    (ZeRO-1, ``launch/train``): that leaf's ``m`` and ``v`` hold only block
    ``index`` of ``parts`` along ``dim``, and only that block of the
    parameter is updated (the caller gathers the rest). The update is
    elementwise and the clip reads the whole gradient, so each block comes
    out as the whole-leaf update's, bit for bit."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cosine_schedule(cfg, state.step)
    t = np.float32(state.step + 1)
    bc1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
    leaves = []

    def view(g, p, m, v, s, z=None):
        """The leaf's ``(g, p, m, v, scale)`` as updated here: a
        ``DTensor``'s local block, a ZeRO-1 block."""
        if not trainable(p):
            return
        if hasattr(p, "to_local"):          # a DTensor: its local block
            from ..launch.spmd import local_block
            s = None if s is None else local_block(s, p)
            g, p, m, v = _local(g), _local(p), _local(m), _local(v)
        if z is not None:
            d, i, n = z
            w = p.shape[d] // n
            if s is not None:
                s = torch.broadcast_to(s, p.shape).narrow(d, i * w, w)
            g, p = g.narrow(d, i * w, w), p.narrow(d, i * w, w)
        leaves.append((g, p, m, v, s))

    scale = update_scale if update_scale is not None \
        else tree_map(lambda _: None, params)
    zero1 = zero1 if zero1 is not None else tree_map(lambda _: None, params)
    with torch.no_grad():
        tree_map(view, grads, params, state.m, state.v, scale, zero1)
        adamw_ops.update(leaves, clip, cfg, lr, bc1, bc2)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(state.step + 1, state.m, state.v), metrics
