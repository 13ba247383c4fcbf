"""SPMD context (``repro.launch.spmd``): opt-in mesh-aware choices that the
model code reads.

The model functions are mesh-agnostic by default (the tests run them on one
device). The launcher activates an :class:`SpmdCtx`, and the code reads it
where the reference does:

* ``seq_shard``    — sequence-parallel layer boundaries (Megatron SP):
  :func:`constrain_seq` at every block boundary of ``transformer.forward``
  puts the residual stream's sequence dim on the TP axis;
* ``shardmap_moe`` — data-shard-local MoE dispatch (``models/moe``);
* ``loss_chunk``   — sequence-chunked cross entropy (``launch/train``);
* ``flash_attn``   — the flash route, where a caller names no ``attn``
  (``models/transformer``, ``launch/train``).

Used as::

    with spmd.activate(mesh, seq_shard=True, flash_attn=True):
        params, opt, sparse, m = step(params, opt, sparse, batch)

Eager torch has no sharding constraint to hand a compiler. Given a
``DTensor``, :func:`constrain_seq` redistributes it to the reference's
placement; a plain tensor on a mesh whose model axis is above 1 would need
the tensor-parallel step of ``ROADMAP.md`` Queue 1 item 10d, and is
refused. On a model axis of 1 the constraint places nothing and returns
its input.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Tuple

import torch

from .mesh import axis_sizes, dp_axes as mesh_dp_axes


@dataclasses.dataclass
class SpmdCtx:
    mesh: Any
    dp_axes: Tuple[str, ...]
    tp_axis: str = "model"
    seq_shard: bool = False
    shardmap_moe: bool = False
    loss_chunk: int = 0            # 0 = off; else tokens per chunk
    flash_attn: bool = False       # route attention through the flash kernels

    def mesh_size(self) -> int:
        n = 1
        for v in axis_sizes(self.mesh).values():
            n *= v
        return n


_state = threading.local()


def current() -> Optional[SpmdCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def activate(mesh, *, seq_shard: bool = False, shardmap_moe: bool = False,
             loss_chunk: int = 0, flash_attn: bool = False):
    ctx = SpmdCtx(mesh=mesh, dp_axes=mesh_dp_axes(mesh), seq_shard=seq_shard,
                  shardmap_moe=shardmap_moe, loss_chunk=loss_chunk,
                  flash_attn=flash_attn)
    prev = current()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def dp_size(ctx: SpmdCtx) -> int:
    sizes = axis_sizes(ctx.mesh)
    n = 1
    for a in ctx.dp_axes:
        n *= sizes[a]
    return n


def seq_spec(ctx: SpmdCtx, batch: int):
    """The reference's placement of the residual stream ``[B, S, D]``:
    ``P(dp, "model", None)``, with the DP axes on B only where there are
    more than one DP shard and they divide it."""
    from .sharding import P
    n = dp_size(ctx)
    dp = ctx.dp_axes if (batch % n == 0 and n > 1) else None
    return P(dp, ctx.tp_axis, None)


def constrain_seq(h: torch.Tensor) -> torch.Tensor:
    """Residual stream ``[B, S, D]`` -> sequence-sharded on the TP axis.
    ``h`` itself without a context, without ``seq_shard``, or when the TP
    axis does not divide ``S``."""
    ctx = current()
    if ctx is None or not ctx.seq_shard:
        return h
    b, s, _ = h.shape
    tp = axis_sizes(ctx.mesh)[ctx.tp_axis]
    if s % tp:
        return h
    from torch.distributed.tensor import DTensor
    if isinstance(h, DTensor):
        from .sharding import placements
        return h.redistribute(ctx.mesh, placements(seq_spec(ctx, b),
                                                   ctx.mesh))
    if tp > 1:
        raise NotImplementedError(
            f"a sequence-parallel boundary on a model axis of {tp} needs the "
            "step to run tensor-parallel over DTensors (ROADMAP.md Queue 1 "
            "item 10d)")
    return h
