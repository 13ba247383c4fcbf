"""Placed tensors: a ``DTensor`` gathered whole, and a whole tensor placed,
by eager collectives and local slices only.

The port's model code, checkpoints and elastic re-placement all move
tensors between a ``DTensor``'s blocks and the whole tensor. They do it
here, with the eager ``all_gather`` (which gloo runs on CUDA tensors)
rather than ``DTensor.full_tensor`` or ``Shard -> Replicate``, which take
the functional collective that gloo does not run on CUDA tensors.
"""
from __future__ import annotations

from typing import Any

import torch


def gather_blocks(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' blocks of ``x`` along ``dim``, in rank order
    (eager ``all_gather`` over ``group``)."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def block(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``size`` equal blocks of ``x`` along ``dim``
    (a view)."""
    w = x.shape[dim] // size
    return x.narrow(dim, rank * w, w)


def full_tensor(x) -> torch.Tensor:
    """A ``DTensor``'s whole tensor on every rank of its mesh (every rank
    calls this): its blocks gathered over each mesh dim that shards it, the
    last mesh dim first, so a dim split over two mesh dims comes back
    first-dim major. Only even ``Shard`` and ``Replicate`` placements
    gather."""
    mesh, out = x.device_mesh, x.to_local()
    for i in reversed(range(mesh.ndim)):
        pl, n = x.placements[i], mesh.size(i)
        if pl.is_replicate():
            continue
        if not pl.is_shard() or x.shape[pl.dim] % n:
            raise ValueError(f"{x.placements} on {tuple(x.shape)}: only "
                             "even Shard and Replicate placements gather")
        if n > 1:
            out = gather_blocks(out, pl.dim, mesh.get_group(i), n)
    return out


def place(x: torch.Tensor, mesh, pls) -> Any:
    """A whole tensor, the same on every rank, as a ``DTensor`` on ``mesh``
    with placements ``pls``: each rank keeps its own block, with no
    communication; dims that a placement splits must divide."""
    from torch.distributed.tensor import DTensor, Shard
    local = x
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if local.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(x.shape)} does not "
                                 f"split {n} ways")
            local = block(local, pl.dim, mesh.get_local_rank(i), n)
    return DTensor.from_local(local.clone(memory_format=torch.contiguous_format),
                              mesh, pls, run_check=False)


def place_like(x: torch.Tensor, like) -> Any:
    """A whole tensor, the same on every rank, placed as the ``DTensor``
    ``like`` is (this rank's block kept, no communication)."""
    return place(x, like.device_mesh, tuple(like.placements))
