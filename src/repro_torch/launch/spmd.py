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

The shard-mapped MoE (``models/moe``) runs its body on each rank as
``shard_map`` runs it on each device, and reads the mesh through
:func:`dp_groups` / :func:`dp_rank` (the DP axes), :func:`model_group` /
:func:`model_rank` / :func:`model_size` (the model axis). Its collectives
carry the gradients as JAX transposes them under ``shard_map``:

* :func:`psum_model` — the sum over ``model`` of partial results; its
  backward is the identity, since the cotangent of a result replicated
  over ``model`` is already whole on every rank
  (``torch.distributed.nn.functional.all_reduce`` would all-reduce it
  again, and every weight gradient would come out ``model`` times too
  large);
* :func:`grad_psum_model` — the identity on a value replicated over
  ``model`` that enters a partial computation; its backward sums the
  partial cotangents over ``model`` (how ``shard_map`` transposes an
  input that its ``in_specs`` replicate);
* :func:`pmean_dp` — the mean over the DP axes; its backward is the
  identity, because each rank's loss is its own and the DP step averages
  the ranks' gradients (``launch/train.DataParallel.mean_grads``), which
  then equal the gradient of the reference's mean.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, List, Optional, Sequence, Tuple

import torch

from .mesh import AbstractMesh, axis_sizes, dp_axes as mesh_dp_axes


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


# ---------------------------------------------------------------------------
# the mesh's process groups, and collectives with shard_map's gradients
# ---------------------------------------------------------------------------

def dp_groups(mesh) -> List[Any]:
    """The process groups of the mesh's DP axes, ``data`` first, then
    ``pod``; none on an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return []
    return [mesh.get_group(a) for a in reversed(mesh_dp_axes(mesh))]


def dp_rank(mesh) -> int:
    """This rank's index over the DP axes, ``pod`` major; 0 on an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return 0
    sizes, r = axis_sizes(mesh), 0
    for a in mesh_dp_axes(mesh):
        r = r * sizes[a] + mesh.get_local_rank(a)
    return r


def model_size(mesh, axis: str = "model") -> int:
    return axis_sizes(mesh).get(axis, 1)


def model_group(mesh, axis: str = "model"):
    """The process group of the model axis (None on an
    :class:`AbstractMesh`)."""
    return None if isinstance(mesh, AbstractMesh) else mesh.get_group(axis)


def model_rank(mesh, axis: str = "model") -> int:
    """This rank's index on the model axis."""
    return 0 if isinstance(mesh, AbstractMesh) else mesh.get_local_rank(axis)


def _all_reduce(x: torch.Tensor, groups: Sequence[Any]) -> torch.Tensor:
    import torch.distributed as dist
    y = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(y, group=g)
    return y


class _ReduceIdentityGrad(torch.autograd.Function):
    """Forward: the sum over ``groups`` (divided by ``div``); backward: the
    identity."""

    @staticmethod
    def forward(ctx, x, groups, div):
        y = _all_reduce(x, groups)
        return y if div == 1 else y.div_(div)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _IdentityReduceGrad(torch.autograd.Function):
    """Forward: the identity; backward: the sum over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


def psum_model(x: torch.Tensor, ctx: SpmdCtx) -> torch.Tensor:
    """``jax.lax.psum(x, tp)`` under ``shard_map``: the sum over the model
    axis, the cotangent passed through unchanged."""
    return _ReduceIdentityGrad.apply(x, [model_group(ctx.mesh, ctx.tp_axis)],
                                     1)


def grad_psum_model(x: torch.Tensor, ctx: SpmdCtx) -> torch.Tensor:
    """``x`` (replicated over the model axis) as it enters a computation
    whose cotangents are partial on each model rank: its gradient is their
    sum over the axis."""
    return _IdentityReduceGrad.apply(x, [model_group(ctx.mesh, ctx.tp_axis)])


def pmean_dp(x: torch.Tensor, ctx: SpmdCtx) -> torch.Tensor:
    """``jax.lax.pmean(x, dp)``: the mean over the DP axes, the gradient
    this rank's own (module docstring)."""
    return _ReduceIdentityGrad.apply(x, dp_groups(ctx.mesh), dp_size(ctx))
