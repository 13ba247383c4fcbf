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
placement; a plain tensor on a mesh whose model axis is above 1 means that
the caller placed nothing, and is refused. On a model axis of 1 the
constraint places nothing and returns its input. The tensor-parallel
forward does not call it: its stream is a local block whose
sequence-parallel boundaries are :class:`TensorParallel`'s collectives.

Tensor parallelism (every family at a model axis above 1): with
parameters placed as ``DTensor`` s by ``launch.sharding.tree_shardings``,
``models/transformer`` runs each rank's shard of the model as
``local_map`` runs a function, through :class:`TensorParallel` (the
Megatron collectives: :meth:`TensorParallel.enter` and
:meth:`TensorParallel.leave`, under ``seq_shard`` the sequence-parallel
pair); the residual stream keeps one layout through the forward (whole,
or this rank's block of the sequence), and the logits come back
vocab-parallel (or, where the rules put the head's rows on the model axis,
summed whole: :meth:`TensorParallel.all_sum`). Where the model axis cuts
inside a query head, ``wq``'s column blocks are gathered whole
(:meth:`TensorParallel.enter_cols`) and each rank runs the heads its rows
of ``wo`` touch (``models/layers.head_cut``). The Mamba2 mixer
(``models/mamba2``) adds a gather of column blocks
(:meth:`TensorParallel.enter_cols`), an ``all_to_all`` between two
layouts of ``d_inner`` (:meth:`TensorParallel.all_to_all`) and
a sum over the model axis whose consumers are partial on every rank
(:meth:`TensorParallel.psum`, the gated norm's sum of squares); the MoE
layer (``models/moe``) runs its experts on this rank's block.

The MoE layer over a mesh (``models/moe``) runs its body on each rank as
``shard_map`` runs it on each device, and reads the mesh through
:func:`dp_groups` / :func:`dp_rank` (the DP axes), :func:`model_group` /
:func:`model_rank` / :func:`model_size` (the model axis). Its collectives
carry the gradients as JAX transposes them under ``shard_map``:

* :func:`sum_over` — the sum over ``model`` of partial results; its
  backward is the identity, since the cotangent of a result replicated
  over ``model`` is already whole on every rank
  (``torch.distributed.nn.functional.all_reduce`` would all-reduce it
  again, and every weight gradient would come out ``model`` times too
  large);
* :func:`grad_sum_over` — the identity on a value replicated over
  ``model`` that enters a partial computation; its backward sums the
  partial cotangents over ``model`` (how ``shard_map`` transposes an
  input that its ``in_specs`` replicate);
* :func:`mean_over` — the mean over the DP axes; its backward is the
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

from ..placed import block as _block, gather_blocks as _gather, place
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
            f"a sequence-parallel boundary on a model axis of {tp} over a "
            "plain tensor: the caller placed nothing; place the parameters "
            "by launch.sharding.tree_shardings (launch.train.place_params), "
            "and the model runs tensor-parallel over them")
    return h


# ---------------------------------------------------------------------------
# the mesh's process groups, and collectives with shard_map's gradients
# ---------------------------------------------------------------------------

def dp_groups(mesh) -> List[Any]:
    """The process groups of the mesh's DP axes above 1, ``data`` first,
    then ``pod`` (a collective over one rank changes nothing); none on an
    :class:`AbstractMesh` or with no mesh."""
    if mesh is None or isinstance(mesh, AbstractMesh):
        return []
    sizes = axis_sizes(mesh)
    return [mesh.get_group(a) for a in reversed(mesh_dp_axes(mesh))
            if sizes[a] > 1]


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


def gather_group(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``x`` over ``group`` along ``dim``, in rank order
    (eager ``all_gather``, no gradient)."""
    import torch.distributed as dist
    return _gather(x, dim, group, dist.get_world_size(group))


def sum_over(x: torch.Tensor, groups: Sequence[Any]) -> torch.Tensor:
    """The sum over ``groups``, the cotangent passed through
    (the module docstring)."""
    return _ReduceIdentityGrad.apply(x, list(groups), 1)


def mean_over(x: torch.Tensor, groups: Sequence[Any], n: int) -> torch.Tensor:
    """The mean over ``groups`` (``n`` ranks in all), the gradient this
    rank's own (the module docstring)."""
    return _ReduceIdentityGrad.apply(x, list(groups), n) if groups else x


def grad_sum_over(x: torch.Tensor, groups: Sequence[Any]) -> torch.Tensor:
    """The identity, the partial cotangents summed over ``groups``
    (the module docstring)."""
    return _IdentityReduceGrad.apply(x, list(groups))


# ---------------------------------------------------------------------------
# tensor parallelism over placed parameters
# ---------------------------------------------------------------------------

class _GatherSliceGrad(torch.autograd.Function):
    """Forward: the blocks gathered along ``dim``; backward: this rank's
    block of the cotangent (the consumer is replicated, so every rank's
    cotangent is whole)."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _gather(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.tp.rank, ctx.tp.size).contiguous(), \
            None, None


class _GatherReduceScatterGrad(torch.autograd.Function):
    """Forward: the blocks gathered along ``dim``; backward: the partial
    cotangents summed over the model axis, this rank's block kept (the
    consumer is a column-parallel product: Megatron SP's entry)."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _gather(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        s = _all_reduce(g, [ctx.tp.group])
        return _block(s, ctx.dim, ctx.tp.rank, ctx.tp.size).contiguous(), \
            None, None


class _ReduceScatterGatherGrad(torch.autograd.Function):
    """Forward: the partial results summed over the model axis and this
    rank's block along ``dim`` kept (``Partial -> Shard(dim)`` as an
    ``all_reduce`` and a slice: gloo has no ``reduce_scatter`` on CUDA);
    backward: the blocks of the cotangent gathered."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        s = _all_reduce(x, [tp.group])
        return _block(s, dim, tp.rank, tp.size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.tp.group, ctx.tp.size), None, None


class _SliceGatherGrad(torch.autograd.Function):
    """Forward: this rank's block along ``dim`` (``Replicate ->
    Shard(dim)``); backward: the blocks of the cotangent gathered."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _block(x, dim, tp.rank, tp.size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.tp.group, ctx.tp.size), None, None


def _all_to_all(x: torch.Tensor, split: int, cat: int, group,
                size: int) -> torch.Tensor:
    """``x``'s ``size`` blocks along ``split`` sent one to each rank, and
    the blocks received concatenated along ``cat`` in rank order (one eager
    ``all_to_all_single``)."""
    import torch.distributed as dist
    send = torch.stack(x.chunk(size, split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=cat)


class _AllToAll(torch.autograd.Function):
    """Forward: blocks along ``split`` exchanged and concatenated along
    ``cat``; backward: the inverse exchange (``cat`` and ``split``
    swapped)."""

    @staticmethod
    def forward(ctx, x, split, cat, tp):
        ctx.split, ctx.cat, ctx.tp = split, cat, tp
        return _all_to_all(x, split, cat, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.cat, ctx.split, ctx.tp.group,
                           ctx.tp.size), None, None, None


class _SumSumGrad(torch.autograd.Function):
    """Forward: the sum over ``groups``; backward: the sum of the
    cotangents over ``groups`` (``psum`` of a device-varying value, whose
    consumer on every rank is partial)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


@dataclasses.dataclass(eq=False)
class TensorParallel:
    """The model axis of a step whose parameters are ``DTensor`` s placed by
    ``launch.sharding.tree_shardings``: its process group, this rank's
    index and the axis size, and ``seq``, whether the residual stream holds
    this rank's block of the sequence (Megatron SP, ``seq_shard``).

    The model's body runs each rank's shard as ``local_map`` runs a
    function: the parameters enter as their local blocks
    (:func:`local_tree`), and the Megatron collectives stand where the
    reference's placements would put them: :meth:`enter` before a
    column-parallel product, :meth:`leave` after a row-parallel one,
    :meth:`enter_cols` where a column block cuts inside a head (``wq``
    under a head cut, K/V, the Mamba2 mixer's ``in_proj``: the blocks
    gathered whole), :meth:`all_sum` after the head's row-parallel
    product, :meth:`gather` / :meth:`split` of the stream under SP,
    :meth:`all_to_all` and :meth:`psum` in the mixer, and
    :meth:`all_gather` / :meth:`all_reduce` without autograd (the
    vocab-parallel loss and argmax, decode). All are eager
    ``all_reduce``, ``all_gather`` or ``all_to_all_single`` calls over the
    model group, which gloo runs on CUDA tensors; ``reduce_scatter`` is
    an ``all_reduce`` and a slice (:func:`count_collectives` counts them
    as what they issue)."""
    mesh: Any
    group: Any
    rank: int
    size: int
    seq: bool = False
    tp_axis: str = "model"

    def placements(self, model_placement=None) -> tuple:
        """Replicate on every mesh axis but the model axis, which takes
        ``model_placement`` (Replicate when None)."""
        from torch.distributed.tensor import Replicate
        return tuple(model_placement if (n == self.tp_axis and model_placement
                                         is not None) else Replicate()
                     for n in self.mesh.mesh_dim_names)

    def wrap(self, local: torch.Tensor, model_placement=None):
        """A local block (or a replicated value) as a ``DTensor``."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh,
                                  self.placements(model_placement),
                                  run_check=False)

    # -- the stream's entry into and exit from a tensor-parallel region ----
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The stream as the replicated input of column-parallel products:
        gathered along the sequence under SP; the cotangents, partial on
        each rank, summed."""
        if self.size == 1:
            return x
        if self.seq:
            return _GatherReduceScatterGrad.apply(x, 1, self)
        return _IdentityReduceGrad.apply(x, [self.group])

    def all_sum(self, y: torch.Tensor) -> torch.Tensor:
        """Partial sums summed whole on every rank (an ``all_reduce``),
        the cotangent, whole on every rank, passed through (a row-parallel
        head's logits)."""
        return y if self.size == 1 else \
            _ReduceIdentityGrad.apply(y, [self.group], 1)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sum back into the stream:
        summed (all-reduced, or reduce-scattered along the sequence under
        SP)."""
        if self.size == 1:
            return y
        if self.seq:
            return _ReduceScatterGatherGrad.apply(y, 1, self)
        return _ReduceIdentityGrad.apply(y, [self.group], 1)

    def enter_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Column blocks of an activation gathered whole for products that
        each rank runs on its own share (a K/V projection split inside a
        head, a compact row table): the partial cotangents summed."""
        return x if self.size == 1 else \
            _GatherReduceScatterGrad.apply(x, x.dim() - 1, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Blocks along ``dim`` gathered for a replicated consumer."""
        return x if self.size == 1 else _GatherSliceGrad.apply(x, dim, self)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """A replicated value's block along ``dim``."""
        return x if self.size == 1 else _SliceGatherGrad.apply(x, dim, self)

    def grad_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated parameter used on partial data (a norm on the
        sequence block under SP): its gradient summed."""
        return x if self.size == 1 else \
            _IdentityReduceGrad.apply(x, [self.group])

    def all_to_all(self, x: torch.Tensor, split: int, cat: int
                   ) -> torch.Tensor:
        """``x``'s blocks along ``split``, one to each rank, received
        along ``cat`` (the Mamba2 mixer's ``P`` blocks of every head <->
        whole heads of this rank's block); the gradient goes back the
        same way."""
        return x if self.size == 1 else _AllToAll.apply(x, split, cat, self)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model axis of partial values (each rank's share
        of a sum of squares), whose every rank's consumer is partial: the
        cotangents summed too."""
        return x if self.size == 1 else _SumSumGrad.apply(x, [self.group])

    # -- collectives without autograd (statistics, serving) ----------------
    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x if self.size == 1 else _gather(x, dim, self.group, self.size)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        import torch.distributed as dist
        if self.size == 1:
            return x
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return y

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of equal-sized blocks' means (a statistic
        of the sequence-sharded stream)."""
        return x if self.size == 1 else self.all_reduce(x).div_(self.size)

    def local_kv_heads(self, n_heads: int, n_kv: int) -> Tuple[int, int]:
        """``(first, count)``: the KV heads that this rank's block of the
        query heads reads (query heads are contiguous per KV head, so a
        block of whole groups, or a block inside one group)."""
        hl = n_heads // self.size
        g = n_heads // n_kv
        if hl % g and g % hl:
            raise ValueError(f"{n_heads} query heads over {n_kv} KV heads "
                             f"split {self.size} ways cut a GQA group "
                             "unevenly")
        first = self.rank * hl // g
        return first, max(1, hl // g)


_tp_state = threading.local()


def active_tp() -> Optional[TensorParallel]:
    """The tensor-parallel state of the model body that is running."""
    return getattr(_tp_state, "tp", None)


@contextlib.contextmanager
def use_tp(tp: Optional[TensorParallel]):
    prev = active_tp()
    _tp_state.tp = tp
    try:
        yield tp
    finally:
        _tp_state.tp = prev


@contextlib.contextmanager
def use_dp(mesh):
    """The data-parallel step's mesh, for the model body that it runs (an
    MoE layer dispatches over its DP axes: :func:`dispatch_mesh`)."""
    prev = getattr(_tp_state, "dp", None)
    _tp_state.dp = mesh
    try:
        yield mesh
    finally:
        _tp_state.dp = prev


def dispatch_mesh():
    """The ``DeviceMesh`` whose DP axes an MoE layer dispatches the global
    batch over: the placed parameters' mesh, else the data-parallel step's
    (:func:`use_dp`), else the active context's; None with none of them,
    or on an :class:`AbstractMesh` (no process group)."""
    tp = active_tp()
    mesh = tp.mesh if tp is not None else getattr(_tp_state, "dp", None)
    if mesh is None and current() is not None:
        mesh = current().mesh
    return mesh if hasattr(mesh, "get_group") else None


@dataclasses.dataclass(frozen=True)
class Scope:
    """The thread-local SPMD state of a running model body (the context,
    the tensor-parallel state, the DP step's mesh), carried into a
    recomputed block: under remat the backward may run it on another
    thread."""
    ctx: Optional[SpmdCtx]
    tp: Optional[TensorParallel]
    dp: Any


def scope() -> Scope:
    return Scope(current(), active_tp(), getattr(_tp_state, "dp", None))


@contextlib.contextmanager
def entered(sc: Scope):
    prev = scope()
    _state.ctx, _tp_state.tp, _tp_state.dp = sc.ctx, sc.tp, sc.dp
    try:
        yield sc
    finally:
        _state.ctx, _tp_state.tp, _tp_state.dp = prev.ctx, prev.tp, prev.dp


def _first_dtensor(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        for v in tree.values():
            d = _first_dtensor(v)
            if d is not None:
                return d
        return None
    if isinstance(tree, (list, tuple)):
        return next((d for d in map(_first_dtensor, tree) if d is not None),
                    None)
    return tree if isinstance(tree, DTensor) else None


def tensor_parallel(params, seq_len: Optional[int] = None
                    ) -> Optional[TensorParallel]:
    """The :class:`TensorParallel` of a parameter tree placed as
    ``DTensor`` s (None for plain tensors). ``seq``: the active context's
    ``seq_shard``, where the model axis divides ``seq_len``."""
    d = _first_dtensor(params)
    if d is None:
        return None
    mesh = d.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        raise ValueError(f"parameters placed on a mesh of axes {names}: the "
                         "LM rules place on an LM mesh (launch.mesh)")
    size = axis_sizes(mesh)["model"]
    ctx = current()
    seq = bool(ctx is not None and ctx.seq_shard and size > 1
               and seq_len is not None and seq_len % size == 0)
    return TensorParallel(mesh=mesh, group=mesh.get_group("model"),
                          rank=mesh.get_local_rank("model"), size=size,
                          seq=seq)


def local_tree(tree):
    """Every ``DTensor`` leaf as its local block (``to_local``: its
    gradient comes back as a ``DTensor`` in the leaf's own placements);
    lists (a stacked leaf tracked a layer at a time) element-wise."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [local_tree(v) for v in tree]
    return tree.to_local() if isinstance(tree, DTensor) else tree


def model_dim(x) -> Optional[int]:
    """The tensor dim a ``DTensor`` splits over the model axis, else None."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return None
    names = x.device_mesh.mesh_dim_names or ()
    for n, pl in zip(names, x.placements):
        if n == "model" and isinstance(pl, Shard):
            return pl.dim
    return None


def place_local(x: torch.Tensor, sharding) -> Any:
    """A whole tensor, the same on every rank, placed by a
    ``launch.sharding.NamedSharding`` on a ``DeviceMesh`` with no
    communication: each rank keeps its own block (``DTensor.from_local``);
    dims that a spec splits must divide."""
    from .sharding import placements
    return place(x, sharding.mesh, placements(sharding.spec, sharding.mesh))


def vocab_argmax(local: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``argmax`` over vocab-sharded logits (this rank's block of the last
    dim): each rank's max and its global index gathered, the largest value
    winning and the lowest index among equal ones, as ``torch.argmax``;
    the same token on every rank."""
    v = local.shape[-1]
    i = local.argmax(-1, keepdim=True)
    vals = tp.all_gather(local.gather(-1, i).float(), -1)
    idx = tp.all_gather(i + tp.rank * v, -1)
    best = vals.amax(-1, keepdim=True)
    return torch.where(vals == best, idx,
                       torch.iinfo(idx.dtype).max).amin(-1)


def local_block(x: torch.Tensor, like) -> torch.Tensor:
    """A scale broadcastable to ``DTensor`` ``like`` -> its block on this
    rank (the dims ``like`` splits over the model axis, where ``x`` is not
    broadcast along them)."""
    d = model_dim(like)
    if d is None:
        return x
    x = x.reshape((1,) * (like.dim() - x.dim()) + tuple(x.shape))
    if x.shape[d] == 1:
        return x
    n = axis_sizes(like.device_mesh)["model"]
    return _block(x, d, like.device_mesh.get_local_rank("model"), n)


# ---------------------------------------------------------------------------
# counting the collectives a step issues
# ---------------------------------------------------------------------------

# the collectives the port issues (``torch.distributed`` eager calls; a
# barrier moves no bytes: ``checkpoint.save`` of a placed tree waits in one)
COUNTED = ("all_reduce", "all_gather", "all_to_all_single", "barrier")
# every other collective, refused while a counter is active: in
# ``torch.distributed`` and in its functional API (DTensor's redistribute)
_REFUSED = ("all_gather_coalesced", "all_gather_into_tensor",
            "all_gather_object", "all_gather_single", "all_reduce_coalesced",
            "all_to_all", "batch_isend_irecv", "broadcast",
            "broadcast_object_list", "gather", "gather_object", "irecv",
            "isend", "monitored_barrier", "recv", "recv_object_list",
            "reduce", "reduce_scatter", "reduce_scatter_single",
            "reduce_scatter_tensor", "scatter", "scatter_object_list", "send",
            "send_object_list")
_REFUSED_FUNCTIONAL = (
    "all_gather_into_tensor_coalesced", "all_gather_single",
    "all_gather_single_autograd", "all_gather_tensor",
    "all_gather_tensor_autograd", "all_gather_tensor_inplace", "all_reduce",
    "all_reduce_coalesced", "all_reduce_inplace", "all_to_all_inplace",
    "all_to_all_single", "all_to_all_single_autograd", "broadcast",
    "permute_tensor", "reduce_scatter_tensor",
    "reduce_scatter_tensor_autograd", "reduce_scatter_tensor_coalesced",
    "reduce_scatter_tensor_inplace")


class CollectiveCounter:
    """The collectives counted by :func:`count_collectives`, by op
    (:data:`COUNTED`): calls,
    ``payload_bytes`` (the result buffer, as the reference's HLO parse
    reads it: the all-reduced tensor, the ``G`` gathered blocks, the
    received tensor) and ``wire_bytes``, one device's bytes on the wire by
    the reference's ring model (``repro.launch.dryrun.parse_collectives``)
    over the ``G`` ranks of the group that the call names: all-gather
    ``(G − 1)/G`` · result, all-reduce ``2(G − 1)/G`` · payload,
    all-to-all ``(G − 1)/G`` · payload. ``inputs[op]``: the elements and
    bytes of the tensors handed in (the gathered block, the sent tensor);
    ``calls``: ``(op, payload bytes, G)`` of each call, in order. A
    ``barrier`` counts its calls and moves no bytes."""

    def __init__(self):
        self.per_op = {op: {"count": 0, "payload_bytes": 0.0,
                            "wire_bytes": 0.0} for op in COUNTED}
        self.inputs = {op: {"elems": 0, "bytes": 0} for op in COUNTED}
        self.calls: List[Tuple[str, int, int]] = []

    def add(self, op: str, x: torch.Tensor, payload: int, g: int) -> None:
        wire = {"all_reduce": 2.0 * (g - 1) / g}.get(op, (g - 1) / g)
        d = self.per_op[op]
        d["count"] += 1
        d["payload_bytes"] += payload
        d["wire_bytes"] += wire * payload
        self.inputs[op]["elems"] += x.numel()
        self.inputs[op]["bytes"] += x.numel() * x.element_size()
        self.calls.append((op, payload, g))

    def record(self) -> dict:
        """The reference's ``collectives`` keys: ``per_op`` (ops called at
        least once), ``payload_bytes``, ``wire_bytes_per_device``."""
        per_op = {op: dict(d) for op, d in self.per_op.items() if d["count"]}
        return {"per_op": per_op,
                "payload_bytes": sum(d["payload_bytes"]
                                     for d in per_op.values()),
                "wire_bytes_per_device": sum(d["wire_bytes"]
                                             for d in per_op.values())}


_counters: List[CollectiveCounter] = []
_saved: List[Tuple[Any, str, Any]] = []


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _counted(name: str, orig):
    import inspect
    import torch.distributed as dist
    sig = inspect.signature(orig)

    def call(*a, **k):
        args = sig.bind(*a, **k).arguments
        g = dist.get_world_size(args.get("group"))
        if name == "all_reduce":
            x = args["tensor"]
            payload = _nbytes(x)
        elif name == "all_gather":
            x = args["tensor"]
            payload = sum(_nbytes(p) for p in args["tensor_list"])
        elif name == "all_to_all_single":
            x = args["input"]
            payload = _nbytes(args["output"])
        else:                                       # barrier
            x, payload = torch.empty(0), 0
        for c in _counters:
            c.add(name, x, payload, g)
        return orig(*a, **k)
    return call


def _refused(name: str):
    def call(*a, **k):
        raise RuntimeError(f"collective {name} issued while collectives are "
                           "counted (spmd.count_collectives counts "
                           f"{', '.join(COUNTED)} only)")
    return call


def _patch() -> None:
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d
    import torch.distributed._functional_collectives as funcol
    for mod in (dist, c10d):
        for name in COUNTED:
            _saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, _counted(name, getattr(mod, name)))
        for name in _REFUSED:
            if hasattr(mod, name):
                _saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, _refused(name))
    for name in _REFUSED_FUNCTIONAL:
        if hasattr(funcol, name):
            _saved.append((funcol, name, getattr(funcol, name)))
            setattr(funcol, name, _refused("functional " + name))


def _unpatch() -> None:
    while _saved:
        mod, name, orig = _saved.pop()
        setattr(mod, name, orig)


@contextlib.contextmanager
def count_collectives():
    """Count every collective that this process issues inside (the eager
    ``torch.distributed`` calls of :data:`COUNTED`, whichever module of
    the port issues them) into a :class:`CollectiveCounter`; any other
    collective of ``torch.distributed`` or its functional API raises
    ``RuntimeError`` instead of slipping past uncounted. Counters nest:
    each active one counts every call."""
    counter = CollectiveCounter()
    if not _counters:
        _patch()
    _counters.append(counter)
    try:
        yield counter
    finally:
        _counters.remove(counter)
        if not _counters:
            _unpatch()
