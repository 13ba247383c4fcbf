"""Per-stream online OSSL adaptation under serving load (``repro.serving.adapt``).

A frozen shared base plus ONE stacked per-stream delta tensor, compact
``[n_slots, n_layers, J, T, bk, bo]`` (the default) or dense
``[n_slots, n_layers, Kmax, N]`` (the A/B baseline); each slot's effective
weights are
``w_base + delta[slot]``, and the per-stream gates inside ``run_chunk``
decide when a stream's delta absorbs an update. This module owns the step
around ``run_chunk``: per-stream adapt on/off (a frozen lane keeps its delta
across the step), delta hygiene (decay and clip on live lanes only), and the
order-fixed slot reduction of the DSST factors, slot sharding over a
``("slots",)`` mesh (each entry advances only its own slots, with no
communication), and folding a lane's delta into the shared base
(:func:`merge_lane_into_base`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..core import engine
from ..core import topology as topology_lib
from ..core.snn import ChunkMetrics, SNNConfig, StreamState, run_chunk
from ..launch import sharding
from ..launch.mesh import SlotMesh


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    enabled: bool = True
    delta_decay: float = 1.0     # per-chunk multiplicative decay (1.0 = off)
    delta_clip: float = 0.5      # hard |delta| bound (0 = off)
    lr_scale: float = 1.0        # scales cfg.lr for the serving path


_CHUNK_FNS_BUILT = 0


def chunk_fns_built() -> int:
    """How many chunk fns :func:`make_chunk_fn` has built in this process:
    the port's counterpart of a trace, read by the ``compile_count``
    contract (``analysis.dispatch_contracts.compile_events``)."""
    return _CHUNK_FNS_BUILT


def make_chunk_fn(cfg: SNNConfig, adapt: AdaptConfig | None = None,
                  want_factors: bool = True, mesh: Optional[SlotMesh] = None):
    """Build the slot-grid step.

    Returns ``fn(params, deltas, state, events, valid, adapt_mask)`` ->
    ``(deltas, state, metrics)``: ``events [C, S, n_in]`` f32, ``valid
    [C, S]`` bool and ``adapt_mask [S]`` bool, on the params' device. The
    step returns fresh tensors and writes none of its inputs.

    ``want_factors`` (fixed at build time) controls the DSST activity
    factors: when True, the engine accumulates per-slot ``pre_mag``/
    ``post_mag`` and this step slot-reduces them on the device with the
    order-fixed ``engine.ordered_slot_sum``, so metrics carry ``[L, Kmax]``
    / ``[L, N]``; when False they are never computed.

    With ``mesh`` (a ``("slots",)`` mesh, ``launch.mesh.make_serving_mesh``)
    it is the port's ``shard_map``: ``S`` must divide by the mesh's entry
    count (``launch.sharding.check_slot_divisible``); the arguments are
    placed by ``launch.sharding.chunk_step_specs`` (params replicated, one
    replica an entry; the per-stream tensors split along their slot axis,
    each entry's block its own copy; inputs already placed so pass
    through), and the step above runs once per entry, on that entry's
    device and slots, with no communication between entries. Results come
    back as ``launch.sharding.SlotSharded`` leaves; only then are the
    per-slot DSST factors slot-reduced, over the slots in global order on
    the first entry's device, so the factors, like everything else, equal
    the 1-device step's bit for bit.
    """
    global _CHUNK_FNS_BUILT
    _CHUNK_FNS_BUILT += 1
    adapt = adapt or AdaptConfig()
    scfg = cfg if adapt.lr_scale == 1.0 else dataclasses.replace(
        cfg, lr=cfg.lr * adapt.lr_scale)

    def step(params, deltas, state: StreamState, events, valid, adapt_mask
             ) -> Tuple[torch.Tensor, StreamState, ChunkMetrics]:
        new_deltas, new_state, metrics = run_chunk(
            params, deltas, state, events, valid, scfg, learn=adapt.enabled,
            want_factors=want_factors)
        d = new_deltas
        if adapt.delta_decay < 1.0:
            d = d * adapt.delta_decay
        if adapt.delta_clip > 0.0:
            d = torch.clamp(d, -adapt.delta_clip, adapt.delta_clip)
        # decay/clip only touch lanes that processed valid timesteps this
        # chunk; frozen AND idle lanes keep their old delta bit-exactly
        live = adapt_mask & valid.any(0)                          # [S]
        out = torch.where(live.reshape((-1,) + (1,) * (d.dim() - 1)), d,
                          deltas)
        # a frozen lane is neither billed nor offered weight updates
        metrics = metrics._replace(
            sop_wu=metrics.sop_wu * adapt_mask,
            sop_wu_offered=metrics.sop_wu_offered * adapt_mask,
            gate_opened=metrics.gate_opened * adapt_mask[:, None],
            gate_offered=metrics.gate_offered * adapt_mask[:, None])
        return out, new_state, metrics

    def reduce_factors(metrics: ChunkMetrics) -> ChunkMetrics:
        if not want_factors:
            return metrics
        return metrics._replace(
            pre_mag=engine.ordered_slot_sum(sharding.gather(metrics.pre_mag)),
            post_mag=engine.ordered_slot_sum(
                sharding.gather(metrics.post_mag)))

    if mesh is None:
        @torch.no_grad()
        def chunk_fn(params, deltas, state: StreamState, events, valid,
                     adapt_mask):
            deltas, state, metrics = step(params, deltas, state, events,
                                          valid, adapt_mask)
            return deltas, state, reduce_factors(metrics)
    else:
        in_specs, out_specs = sharding.chunk_step_specs(want_factors)

        @torch.no_grad()
        def chunk_fn(params, deltas, state: StreamState, events, valid,
                     adapt_mask):
            sharding.check_slot_divisible(events.shape[1], mesh)
            _refuse_dense_base_on_cuda(params)
            args = sharding.place_args(
                (params, deltas, state, events, valid, adapt_mask), in_specs,
                mesh)
            outs = [step(*sharding.shard_at(args, i))
                    for i in range(mesh.size)]
            deltas, state, metrics = sharding.stack_shards(outs, out_specs,
                                                           mesh)
            return deltas, state, reduce_factors(metrics)

    chunk_fn.want_factors = want_factors
    chunk_fn.mesh = mesh
    return chunk_fn


def _refuse_dense_base_on_cuda(params) -> None:
    """A slot mesh on the card serves the compact base only. The ``"ref"``
    backend's dense layout takes its base current as the GEMM ``pre @ w``
    (``engine.fwd_current``), and cuBLAS picks its summation order by the
    row count, so a slot would round otherwise at another shard width and
    the sharded fleet would drift from the 1-device one."""
    rep = params.full() if isinstance(params, sharding.Replicated) else params
    w = rep.get("w") if isinstance(rep, dict) else None
    if isinstance(w, torch.Tensor) and w.device.type == "cuda":
        raise ValueError(
            "a slot mesh on CUDA serves the compact base (backend "
            "'kernels'); the 'ref' backend's dense base GEMM pre @ w "
            "rounds by the shard's row count there")


def delta_norms(deltas: torch.Tensor) -> torch.Tensor:
    """Per-slot L2 norm of the adaptation, summed over layers. ``[S]``.
    Either layout: compact storage holds only kept coordinates and dense
    deltas are zero off the mask, so both report the same norms. Slot-
    sharded deltas give their norms shard by shard, gathered in slot
    order."""
    if isinstance(deltas, sharding.SlotSharded):
        return sharding.map_shards(delta_norms, deltas).full()
    sq = (deltas * deltas).sum(dim=tuple(range(2, deltas.dim())))
    return torch.sqrt(sq).sum(1)


def merge_lane_into_base(params: Dict[str, Any], deltas: torch.Tensor,
                         slot: int, cfg: SNNConfig,
                         weight: float = 1.0) -> Dict[str, Any]:
    """Fold stream ``slot``'s delta into the dense training params' base
    weights, mask-free: a compact lane scatters its kept blocks into the
    base (``engine.densify_deltas`` over the mask's kept-block ids), a dense
    ``[L, Kmax, N]`` lane is zero off the mask by the topology invariant, so
    a plain add keeps the base's sparsity bit for bit. Only ``hidden/w`` is
    rebuilt; every other key rides through. ``deltas`` may be slot-sharded:
    the lane is read from its shard."""
    lane = deltas[slot].to(params["hidden"]["w"].device)
    if lane.dim() == 5:              # compact [L, J, T, bk, bo]
        idx = topology_lib.stacked_kept_ids(params["hidden"]["mask"], cfg)
        lane = engine.densify_deltas(lane[None], idx, cfg)[0]
    w = params["hidden"]["w"] + weight * lane
    return {**params, "hidden": {**params["hidden"], "w": w}}
