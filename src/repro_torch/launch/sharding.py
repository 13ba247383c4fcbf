"""Slot-axis sharding of the serving grid (``repro.launch.sharding``, its
serving section).

The SNN serving chunk step is per-slot separable: every per-stream
quantity is one slot-leading tensor (``StreamState`` leaves, the compact
``[S, L, J, T, bk, bo]`` deltas or the dense ``[S, L, Kmax, N]`` baseline,
the ``[S]`` adapt mask) or carries the slot axis second (the
``[C, S, n_in]`` event and ``[C, S]`` valid buffers, the ``[C, S, n_out]``
logits). Sharding is therefore one rule applied twice: "slots" on the slot
axis, everything else replicated, and the frozen base params replicate.

Where the reference places a ``jax.Array`` with a ``NamedSharding``, the
port holds the pieces itself:

* :class:`SlotSharded` — one tensor split along its slot axis into equal
  contiguous blocks, block ``i`` on ``mesh.devices[i]`` in its own memory
  (never a view of a neighbour's lanes): ``full()`` gathers it, indexing a
  slot reads or writes that lane in its shard;
* :class:`Replicated` — one tree copied to every mesh entry;
* :class:`NamedSharding` (``mesh`` + :class:`PartitionSpec`) with
  :func:`device_put`, the counterpart of ``jax.device_put``.

Both containers are ``torch.utils._pytree`` nodes whose children are the
per-entry pieces, so a tree walk over a sharded result sees each entry's
tensors at the per-shard slot count.

The logical-axis LM rules (the reference's, MaxText-style): Megatron
tensor parallelism on "model", data parallelism on ("pod", "data").
Embeddings and the head put vocab or ``d_model`` on "model"; attention QKV
are column-parallel and O row-parallel; the MLP up column-, down
row-parallel; MoE experts on "model" (EP) or their hidden dim on "model"
(TP inside experts), as the config says; the Mamba2 projections column /
row-parallel with the conv and norm channels on "model"; kept-row tables
and norms replicate. A rule is matched on the leaf's path suffix and
right-aligned to its rank, so the leading ``[L]`` of stacked subtrees
(``layers``, ``local_heads``) and an expert axis replicate. The first
alternative that divides wins; otherwise the spec is demoted to its first
alternative with each non-dividing axis dropped, and a warning is logged
(the reference's text, under this module's logger). ``spec_for`` needs
only the mesh's axis sizes, so the rules run on a
``launch.mesh.AbstractMesh`` with no process group; with a ``DeviceMesh``
a :class:`NamedSharding` places a tensor as a ``DTensor``
(:func:`placements`, :func:`device_put`). ZeRO-1's moment rule
(:func:`opt_state_shardings`) also names the dim that the DP step of
``launch/train`` splits its moments on.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import operator
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from .mesh import SLOT_AXIS, AbstractMesh, SlotMesh, axis_sizes, dp_axes

log = logging.getLogger(__name__)


class PartitionSpec(tuple):
    """Which mesh axis each tensor dim is split over (``None``: not split),
    as ``jax.sharding.PartitionSpec``; ``PartitionSpec()`` replicates. A
    leaf of the spec trees below, never walked into."""

    def __new__(cls, *parts):
        # a one-axis tuple names that axis, as JAX normalises it
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def slot_devices(mesh: SlotMesh) -> int:
    return mesh.shape[SLOT_AXIS]


def round_up_slots(n_slots: int, mesh: SlotMesh) -> int:
    """Smallest multiple of the mesh's slot-device count >= ``n_slots``."""
    d = slot_devices(mesh)
    return -(-n_slots // d) * d


def tier_slot_allocation(counts, mesh: SlotMesh) -> list:
    """Device-aware slot widths for a (multi-tier) grid: each tier's
    requested slot count padded to a multiple of the slot-mesh size (every
    entry owns an equal shard of every tier) and floored at two slots per
    entry, the reference's rule: below that a matmul over one row takes
    another summation order on the CPU (a gemv), which costs bit-identity
    with the 1-device fleet."""
    floor = 2 * slot_devices(mesh)
    return [max(round_up_slots(int(n), mesh), floor) for n in counts]


def check_slot_divisible(n_slots: int, mesh: SlotMesh) -> None:
    d = slot_devices(mesh)
    if n_slots % d != 0:
        raise ValueError(
            f"n_slots={n_slots} not divisible by the {d}-device slot mesh; "
            f"use round_up_slots ({round_up_slots(n_slots, mesh)})")


def slot_spec(slot_dim: int = 0) -> PartitionSpec:
    """Partition the ``slot_dim``-th axis over "slots", rest replicated."""
    return P(*((None,) * slot_dim), SLOT_AXIS)


def spec_slot_dim(spec: PartitionSpec, mesh=None):
    """The dim ``spec`` splits over "slots"; None for a replicated spec,
    and on an LM mesh (``mesh`` neither None nor a :class:`SlotMesh`),
    which has no slot axis and places by its own axes
    (:class:`NamedSharding` on a ``DeviceMesh``). On a slot mesh
    (``mesh`` a :class:`SlotMesh` or None) any other axis is refused: a
    slot mesh has no model or data axis."""
    if mesh is not None and not isinstance(mesh, SlotMesh):
        return None
    other = [a for a in spec if a not in (None, SLOT_AXIS)]
    if other:
        raise ValueError(
            f"spec {spec!r} names mesh axes {other}: a slot mesh places by "
            "the slot axis only; place a tree by model and data axes on an "
            "LM mesh (launch.mesh.make_host_mesh)")
    return spec.index(SLOT_AXIS) if SLOT_AXIS in spec else None


# ---------------------------------------------------------------------------
# the logical-axis LM rules
# ---------------------------------------------------------------------------

def _rules(cfg: ModelConfig) -> Sequence[Tuple[str, Any]]:
    """(path regex, right-aligned partition tuple, or a list of them to
    try in order). First match wins."""
    _has_rules(cfg)
    if cfg.moe_shard_experts:      # EP: experts on model
        moe_mat = ("model", None, None)
    else:                          # TP inside experts
        moe_up = (None, None, "model")
        moe_dn = (None, "model", None)
    r: list = [
        # alternatives: the first fully divisible one wins. The embedding
        # prefers d_model on "model": a vocab-sharded table turns the token
        # gather into an all-gather of the whole table
        (r"embed/tok$", [(None, "model"), ("model", None)]),
        (r"embed/frontend_proj$", (None, "model")),
        (r"lm_head$", [(None, "model"), ("model", None)]),
        (r"(wq|wk|wv)/w$", (None, "model")),
        (r"(wq|wk|wv)/rows$", (None,)),
        (r"wo/w$", ("model", None)),
        (r"moe/router$", (None, None)),
    ]
    if cfg.family == "moe":
        if cfg.moe_shard_experts:
            r += [(r"moe/(w1|w3|w2)/w$", moe_mat)]
        else:
            r += [(r"moe/(w1|w3)/w$", moe_up), (r"moe/w2/w$", moe_dn)]
    r += [
        (r"(w1|w3)/w$", (None, "model")),
        (r"w2/w$", ("model", None)),
        (r"rows$", (None,)),
        (r"umask$", (None, None)),
        (r"mixer/in_proj/w$", (None, "model")),
        (r"mixer/out_proj/w$", ("model", None)),
        (r"mixer/conv_w$", (None, "model")),
        (r"mixer/conv_b$", ("model",)),
        (r"mixer/norm_g$", ("model",)),
        (r"mixer/(a_log|d_skip|dt_bias)$", (None,)),
        (r"local_heads/p$", (None, "model")),
        (r"(norm1|norm2|final_norm|norm_g)$", (None,)),
    ]
    return r


def _has_rules(cfg: ModelConfig) -> None:
    if cfg.family == "mixed":
        raise NotImplementedError("the mixed family has no sharding rules: "
                                  "it serves on one device")


def _path_str(path) -> str:
    """A leaf's path as the reference writes it: dict keys and sequence
    indices as they are, a NamedTuple field as ``.name``."""
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts, NamedTuples (a field's key is
    ``.name``), tuples and lists, rebuilt in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + ("." + f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _ndim(leaf) -> int:
    return len(leaf.shape) if hasattr(leaf, "shape") else 0


def spec_for(path_str: str, shape: Tuple[int, ...], cfg: ModelConfig,
             mesh) -> PartitionSpec:
    """The leaf's spec by the first rule whose pattern its path matches,
    right-aligned to its rank; the first alternative whose axes all divide
    their dims wins, else the first with the non-dividing axes dropped
    (logged as a demotion). Reads only the mesh's axis sizes."""
    sizes = axis_sizes(mesh)
    shape = tuple(int(d) for d in shape)
    base: Optional[Any] = None
    for pat, spec in _rules(cfg):
        if re.search(pat, path_str):
            base = spec
            break
    candidates = base if isinstance(base, list) \
        else [base if base is not None else ()]

    def fit(b) -> Tuple[PartitionSpec, bool]:
        # right-align: leading stacked dims (layers L, experts E, ...)
        # replicate
        full = (None,) * (len(shape) - len(b)) + tuple(b)
        full = full[-len(shape):] if shape else ()
        fixed, clean = [], True
        for dim, ax in zip(shape, full):
            if ax is None:
                fixed.append(None)
            elif dim % sizes[ax] == 0:
                fixed.append(ax)
            else:
                fixed.append(None)
                clean = False
        return P(*fixed), clean

    first = None
    for cand in candidates:
        p, clean = fit(cand)
        if first is None:
            first = p
        if clean:
            return p
    log.warning("demoted sharding for %s %s -> %s", path_str, shape, first)
    return first


def tree_shardings(tree: Any, cfg: ModelConfig, mesh) -> Any:
    """A tree of tensors (``meta`` ones too) -> a :class:`NamedSharding`
    tree of the same structure; scalars and host values replicate."""
    def one(path, leaf):
        if _ndim(leaf) == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, spec_for(_path_str(path), leaf.shape,
                                            cfg, mesh))
    return tree_map_with_path(one, tree)


def _dp_total(mesh) -> Tuple[Tuple[str, ...], int]:
    axes = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    return axes, math.prod(sizes[a] for a in axes)


def opt_state_shardings(opt_tree: Any, params_tree: Any, cfg: ModelConfig,
                        mesh) -> Any:
    """ZeRO-1: each moment leaf also splits one spare dim over the DP axes
    (the first dim its parameter's spec leaves whole that the DP size
    divides); params stay DP-replicated. A leaf with no such dim stays
    as its parameter is."""
    axes, total = _dp_total(mesh)

    def one(path, leaf):
        if _ndim(leaf) == 0:
            return NamedSharding(mesh, P())
        base = spec_for(_path_str(path), leaf.shape, cfg, mesh)
        if total <= 1:
            return NamedSharding(mesh, base)
        spec = list(base) + [None] * (len(leaf.shape) - len(base))
        for i, (dim, ax) in enumerate(zip(leaf.shape, spec)):
            if ax is None and dim % total == 0 and dim >= total:
                spec[i] = axes if len(axes) > 1 else axes[0]
                break
        return NamedSharding(mesh, P(*spec))
    return tree_map_with_path(one, opt_tree)


def dp_split_dim(spec: PartitionSpec, mesh) -> Optional[int]:
    """The dim that ``spec`` splits over the mesh's DP axes (ZeRO-1's
    moment dim), or None."""
    axes = dp_axes(mesh)
    want = axes if len(axes) > 1 else (axes[0] if axes else None)
    for i, ax in enumerate(spec):
        if want is not None and ax == want:
            return i
    return None


def batch_spec(mesh, global_batch: int, extra_dims: int = 1) -> PartitionSpec:
    """``[B, ...]``: batch on the DP axes when they divide it, replicated
    otherwise."""
    axes, total = _dp_total(mesh)
    if axes and global_batch % total == 0:
        return P(axes, *([None] * extra_dims))
    return P(*([None] * (extra_dims + 1)))


def batch_shardings(batch: Any, mesh) -> Any:
    def one(_, leaf):
        nd = _ndim(leaf)
        if nd == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, batch_spec(mesh, leaf.shape[0], nd - 1))
    return tree_map_with_path(one, batch)


def cache_shardings(cache: Any, cfg: ModelConfig, mesh) -> Any:
    """KV and SSM caches ``[L, B, ...]``: B on the DP axes; KV caches put
    the sequence dim on "model" (else ``dh``), the SSM state its head dim
    ``P``, the conv window its channels."""
    _has_rules(cfg)
    tp = axis_sizes(mesh)["model"]

    def one(path, leaf):
        ps = _path_str(path)
        nd = _ndim(leaf)
        if nd == 0:
            return NamedSharding(mesh, P())
        shape = tuple(leaf.shape)
        dp = batch_spec(mesh, shape[1], 0) if nd > 1 else P(None)
        dpax = dp[0] if len(dp) else None
        spec: list = [None] * nd
        spec[1] = dpax
        model_dim = None
        if re.search(r"(^|/)(k|v|shared_k|shared_v)$", ps):
            # [L, B, C, KV, dh]: prefer C (sequence); fall back to dh
            model_dim = 2 if shape[2] % tp == 0 else nd - 1
        elif ps.endswith("ssm"):
            model_dim = nd - 2          # P (head dim), N stays whole
        elif ps.endswith("conv"):
            model_dim = nd - 1          # channels
        if model_dim is not None and shape[model_dim] % tp == 0:
            spec[model_dim] = "model"
        return NamedSharding(mesh, P(*spec))
    return tree_map_with_path(one, cache)


def logits_sharding(mesh, global_batch: int, cfg: ModelConfig,
                    with_seq: bool = True) -> "NamedSharding":
    bspec = batch_spec(mesh, global_batch, 0)
    dpax = bspec[0] if len(bspec) else None
    vocab_ok = cfg.vocab % axis_sizes(mesh)["model"] == 0
    dims = (dpax, None, "model" if vocab_ok else None) if with_seq \
        else (dpax, "model" if vocab_ok else None)
    return NamedSharding(mesh, P(*dims))


def replicated(mesh) -> "NamedSharding":
    return NamedSharding(mesh, P())


def placements(spec: PartitionSpec, mesh) -> tuple:
    """``spec`` as DTensor placements, one a mesh dim: ``Shard(d)`` where
    tensor dim ``d`` is split over that mesh axis (a tuple of axes on one
    dim, such as ``("pod", "data")``, gives a ``Shard`` on each, in mesh
    order: the first axis major, as the reference splits), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec!r} splits dims {dims} over "
                             f"mesh axis {name!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_shape(spec: PartitionSpec, shape: Sequence[int], mesh
                ) -> Tuple[int, ...]:
    """One device's block of a ``shape`` tensor under ``spec``
    (``NamedSharding.shard_shape``): each dim divided by the sizes of the
    axes it is split over, which must divide it."""
    sizes = axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        n = math.prod(sizes[a] for a in
                      (ax if isinstance(ax, tuple) else (ax,))
                      if a is not None)
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways ({spec!r})")
        out.append(dim // n)
    return tuple(out)


# ---------------------------------------------------------------------------
# the placed containers
# ---------------------------------------------------------------------------

def _own_copy(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


class SlotSharded:
    """One tensor sharded over a slot mesh: ``shards[i]``, on
    ``mesh.devices[i]``, holds slots ``[i·w, (i+1)·w)`` of the slot axis
    ``slot_dim`` (``w = width``). Indexing a slot (slot-leading tensors
    only) reads or writes that lane in its shard, in place."""

    __slots__ = ("shards", "mesh", "slot_dim")

    def __init__(self, shards: Sequence[torch.Tensor], mesh: SlotMesh,
                 slot_dim: int = 0):
        shards = tuple(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a {mesh.size}-entry "
                             "slot mesh")
        first = shards[0]
        for s in shards[1:]:
            if s.shape != first.shape or s.dtype != first.dtype:
                raise ValueError(
                    f"unequal shards {tuple(first.shape)}/{first.dtype} and "
                    f"{tuple(s.shape)}/{s.dtype}")
        self.shards, self.mesh, self.slot_dim = shards, mesh, slot_dim

    # -- what a tensor would say ---------------------------------------------
    @property
    def width(self) -> int:
        """Slots per shard."""
        return self.shards[0].shape[self.slot_dim]

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.slot_dim] *= len(self.shards)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The first entry's device: where :meth:`full` gathers."""
        return self.shards[0].device

    def dim(self) -> int:
        return self.shards[0].dim()

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.shards)

    @property
    def spec(self) -> PartitionSpec:
        return slot_spec(self.slot_dim)

    def __repr__(self) -> str:
        return (f"SlotSharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec!r}, devices={list(self.mesh.devices)})")

    # -- lanes ---------------------------------------------------------------
    def locate(self, slot: int) -> Tuple[int, int]:
        """Global slot -> (shard, slot within it)."""
        n = self.width * len(self.shards)
        if not 0 <= slot < n:
            raise IndexError(f"slot {slot} out of range for {n} slots")
        return divmod(int(slot), self.width)

    def lane(self, slot: int) -> torch.Tensor:
        """A view of lane ``slot`` in its shard (the slot axis dropped)."""
        i, j = self.locate(slot)
        return self.shards[i].select(self.slot_dim, j)

    def __getitem__(self, slot: int) -> torch.Tensor:
        try:
            slot = operator.index(slot)
        except TypeError:
            slot = None
        if self.slot_dim != 0 or slot is None:
            raise TypeError("a SlotSharded is indexed by one slot of a "
                            "slot-leading tensor; use lane() or full()")
        return self.lane(slot)

    def __setitem__(self, slot: int, value) -> None:
        self[slot].copy_(value)

    def full(self) -> torch.Tensor:
        """The whole tensor, gathered in slot order on the first entry's
        device (a copy)."""
        dev = self.device
        return torch.cat([s.to(dev) for s in self.shards], dim=self.slot_dim)


class Replicated:
    """One tree copied to every entry of a mesh: ``replicas[i]`` on
    ``mesh.devices[i]``, each its own memory, whether or not devices
    repeat."""

    __slots__ = ("replicas", "mesh")

    def __init__(self, replicas: Sequence[Any], mesh: SlotMesh):
        replicas = tuple(replicas)
        if len(replicas) != mesh.size:
            raise ValueError(f"{len(replicas)} replicas for a "
                             f"{mesh.size}-entry mesh")
        self.replicas, self.mesh = replicas, mesh

    def full(self) -> Any:
        """The first entry's replica."""
        return self.replicas[0]


def _register():
    def keyed(children):
        return [(pytree.SequenceKey(i), c) for i, c in enumerate(children)]

    pytree.register_pytree_node(
        SlotSharded, lambda x: (list(x.shards), (x.mesh, x.slot_dim)),
        lambda shards, ctx: SlotSharded(shards, *ctx),
        flatten_with_keys_fn=lambda x: (keyed(x.shards),
                                        (x.mesh, x.slot_dim)))
    pytree.register_pytree_node(
        Replicated, lambda x: (list(x.replicas), x.mesh),
        lambda reps, mesh: Replicated(reps, mesh),
        flatten_with_keys_fn=lambda x: (keyed(x.replicas), x.mesh))


_register()


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _map_tensors(fn: Callable, *trees) -> Any:
    """``fn(*leaves)`` over the tensor (and placed-container) leaves of
    trees of one structure (NamedTuples, tuples, lists, dicts, None),
    rebuilt in that structure."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, (torch.Tensor, SlotSharded, Replicated)):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: _map_tensors(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_map_tensors(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(_map_tensors(fn, *xs) for xs in zip(*trees))
    return t


def gather(tree: Any) -> Any:
    """Every placed leaf back to one tensor on the first entry's device:
    :meth:`SlotSharded.full`, a :class:`Replicated`'s first replica."""
    def one(x):
        return x.full() if isinstance(x, (SlotSharded, Replicated)) else x
    return _map_tensors(one, tree)


def map_shards(fn: Callable[[torch.Tensor], torch.Tensor],
               x: SlotSharded) -> SlotSharded:
    """``fn`` on every shard, on its own device; ``fn`` must keep the slot
    axis where it was."""
    return SlotSharded([fn(s) for s in x.shards], x.mesh, x.slot_dim)


def replicate(tree: Any, mesh: SlotMesh) -> Replicated:
    """``tree`` (gathered first if placed) copied to every entry."""
    tree = gather(tree)
    return Replicated([_map_tensors(lambda t: _own_copy(t, dev), tree)
                       for dev in mesh.devices], mesh)


def shard(x, mesh: SlotMesh, slot_dim: int = 0) -> SlotSharded:
    """One tensor split over ``mesh`` along ``slot_dim``, each block copied
    to its entry's device. A :class:`SlotSharded` already placed so is
    returned as it is; one placed otherwise is gathered and re-split."""
    if isinstance(x, SlotSharded):
        if x.mesh == mesh and x.slot_dim == slot_dim:
            return x
        x = x.full()
    check_slot_divisible(x.shape[slot_dim], mesh)
    w = x.shape[slot_dim] // mesh.size
    return SlotSharded([_own_copy(x.narrow(slot_dim, i * w, w), dev)
                        for i, dev in enumerate(mesh.devices)],
                       mesh, slot_dim)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where :func:`device_put` puts a leaf. On a
    :class:`SlotMesh` a :class:`SlotSharded` or :class:`Replicated`; on a
    ``DeviceMesh`` a ``DTensor`` (``distribute_tensor`` by
    :func:`placements`); on a 1-device ``AbstractMesh`` the tensor on its
    device."""
    mesh: Any
    spec: PartitionSpec

    def place(self, x):
        if isinstance(self.mesh, SlotMesh):
            d = spec_slot_dim(self.spec)
            return replicate(x, self.mesh) if d is None \
                else shard(x, self.mesh, d)
        if isinstance(self.mesh, AbstractMesh):
            if self.mesh.size() != 1 or self.mesh.device is None:
                raise ValueError(f"an abstract mesh of {self.mesh.shape} "
                                 "places no tensor")
            return x.to(self.mesh.device)
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, self.mesh,
                                 placements(self.spec, self.mesh))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return shard_shape(self.spec, shape, self.mesh)


def slot_sharding(mesh: SlotMesh, slot_dim: int = 0) -> NamedSharding:
    return NamedSharding(mesh, slot_spec(slot_dim))


def stream_shardings(tree: Any, mesh: SlotMesh) -> Any:
    """Slot-leading shardings for StreamState / delta trees (every leaf has
    the slot axis first: the lane-surgery layout invariant)."""
    return _map_tensors(lambda _: slot_sharding(mesh), tree)


def device_put(tree: Any, shardings: Any) -> Any:
    """Place every leaf of ``tree`` by the matching leaf of ``shardings``
    (a tree of the same structure, or one :class:`NamedSharding` for
    all)."""
    if isinstance(shardings, NamedSharding):
        return _map_tensors(shardings.place, tree)
    return _map_tensors(lambda x, sh: sh.place(x), tree, shardings)


# ---------------------------------------------------------------------------
# the chunk step's specs, and running a step once per shard
# ---------------------------------------------------------------------------

def chunk_step_specs(want_factors: bool = True) -> Tuple[Tuple, Tuple]:
    """The sharded chunk step's specs for ``fn(params, deltas, state,
    events, valid, adapt_mask) -> (deltas, state, metrics)``, in prefix
    form: ``P()`` replicates the whole params tree, one slot-leading spec
    covers every StreamState leaf; ``ChunkMetrics`` has one spec a field
    because ``logits`` / ``window_end`` carry the slot axis second. With
    ``want_factors`` the DSST factors leave each shard per slot
    (``[S, L, ·]``); the step's slot reduction comes after, outside the
    shards (``serving/adapt.make_chunk_fn``)."""
    from ..core.snn import ChunkMetrics
    s0, s1 = slot_spec(0), slot_spec(1)
    fac = s0 if want_factors else None
    metrics = ChunkMetrics(
        logits=s1, window_end=s1, sop_forward=s0, sop_wu=s0,
        sop_wu_offered=s0, gate_opened=s0, gate_offered=s0,
        local_loss=s0, steps=s0, pre_mag=fac, post_mag=fac)
    in_specs = (P(), s0, s0, s1, s1, s0)
    out_specs = (s0, s0, metrics)
    return in_specs, out_specs


def _zip_specs(fn: Callable, specs, *trees) -> Any:
    """``fn(spec, *subtrees)`` at every spec leaf of a prefix spec tree."""
    if specs is None or isinstance(specs, PartitionSpec):
        return fn(specs, *trees)
    if hasattr(specs, "_fields"):
        return type(specs)(*(_zip_specs(fn, s, *xs)
                             for s, xs in zip(specs, zip(*trees))))
    return type(specs)(_zip_specs(fn, s, *xs)
                       for s, xs in zip(specs, zip(*trees)))


def place_args(args: Tuple, specs: Tuple, mesh: SlotMesh) -> Tuple:
    """Place a call's arguments by their prefix specs; what is already
    placed on ``mesh`` as its spec says is passed through uncopied."""
    def one(spec, sub):
        d = spec_slot_dim(spec)
        if d is None:
            return sub if isinstance(sub, Replicated) and sub.mesh == mesh \
                else replicate(sub, mesh)
        return _map_tensors(lambda t: shard(t, mesh, d), sub)
    return _zip_specs(one, specs, args)


def shard_at(tree: Any, i: int) -> Any:
    """Entry ``i``'s piece of every placed leaf."""
    def one(x):
        if isinstance(x, SlotSharded):
            return x.shards[i]
        if isinstance(x, Replicated):
            return x.replicas[i]
        return x
    return _map_tensors(one, tree)


def stack_shards(outs: List[Any], specs: Any, mesh: SlotMesh) -> Any:
    """Per-entry results (one tree each, in mesh order) -> one result whose
    leaves are :class:`SlotSharded` along their spec's slot axis."""
    def one(spec, *subs):
        if spec is None:
            return None
        d = spec_slot_dim(spec)
        return _map_tensors(lambda *xs: SlotSharded(xs, mesh, d), *subs)
    return _zip_specs(one, specs, *outs)
