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

The logical-axis LM rules (``spec_for``, ``tree_shardings``, the batch,
cache and logits rules) are not ported yet (``ROADMAP.md`` Queue 1 item
10b).
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable, List, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from .mesh import SLOT_AXIS, SlotMesh


class PartitionSpec(tuple):
    """Which mesh axis each tensor dim is split over (``None``: not split),
    as ``jax.sharding.PartitionSpec``; ``PartitionSpec()`` replicates. A
    leaf of the spec trees below, never walked into."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

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


def spec_slot_dim(spec: PartitionSpec):
    """The dim ``spec`` splits over "slots"; None for a replicated spec.
    Any other mesh axis is an LM mesh's, which the port does not have."""
    other = [a for a in spec if a not in (None, SLOT_AXIS)]
    if other:
        raise NotImplementedError(
            f"spec {spec!r} names mesh axes {other}: only the serving slot "
            "axis is ported (the LM mesh is ROADMAP.md Queue 1 item 10b)")
    return spec.index(SLOT_AXIS) if SLOT_AXIS in spec else None


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
    """A mesh and a spec: where :func:`device_put` puts a leaf."""
    mesh: SlotMesh
    spec: PartitionSpec

    def place(self, x):
        d = spec_slot_dim(self.spec)
        return replicate(x, self.mesh) if d is None \
            else shard(x, self.mesh, d)


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
