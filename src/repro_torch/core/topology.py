"""The layer-stacked N:M topology lifecycle, shared by training and serving
(``repro.core.topology``).

``Topology`` is the stacked unit mask (plus its compact kept-unit index
view, the chip's index SRAM). :func:`topology_epoch` is ONE stacked
prune/regrow epoch over every hidden layer; ``snn.run_sample`` runs it at
the end of every DSST period. Masks are padded with False rows up to the
stack width; all topology math slices each layer back to its true
``(KB, J)``, so padded rows are never pruned into or regrown from. Survivors
keep their weights and deltas bit-exactly (``torch.where``, not a multiply).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from .dsst import prune_regrow, prune_regrow_factored, scheduled_k_apply
from .sparsity import (NMSpec, check_unit_mask, compact_indices,
                       expand_unit_mask, unit_scores)


class Topology(NamedTuple):
    """Stacked N:M connectivity: ``unit_mask`` bool ``[L, KBmax, J]`` (the
    layout of ``params["hidden"]["mask"]``) and ``idx`` int32
    ``[L, G, n, J]`` kept-unit ids per group, for uniform layer geometry
    only (None otherwise)."""
    unit_mask: torch.Tensor
    idx: Optional[torch.Tensor]


class TopologyStats(NamedTuple):
    """Per-layer epoch telemetry: int32 ``[L]`` pruned/regrown, f32 ``[L]``
    mask-change fraction."""
    pruned: torch.Tensor
    regrown: torch.Tensor
    mask_change: torch.Tensor

    @property
    def total_pruned(self) -> torch.Tensor:
        return self.pruned.sum()

    @property
    def total_regrown(self) -> torch.Tensor:
        return self.regrown.sum()


def specs(cfg) -> Tuple[NMSpec, ...]:
    """Per-layer N:M specs (one per hidden layer, in stack order)."""
    return tuple(cfg.spec(f) for f in cfg.layer_fanins)


def uniform_geometry(cfg) -> bool:
    return len(set(cfg.layer_fanins)) == 1


def _k_max(cfg) -> int:
    return max(cfg.layer_fanins)


def _pad_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.shape[0] == k:
        return x
    return torch.cat([x, x.new_zeros((k - x.shape[0],) + tuple(x.shape[1:]))])


def layer_mask(mask_stacked: torch.Tensor, l: int, cfg) -> torch.Tensor:
    """Layer ``l``'s true ``[KB, J]`` unit mask out of the padded stack."""
    kb, j = cfg.spec(cfg.layer_fanins[l]).unit_counts(cfg.layer_fanins[l],
                                                      cfg.n_hidden)
    return mask_stacked[l, :kb, :j]


def from_mask(mask_stacked: torch.Tensor, cfg) -> Topology:
    """Wrap a stacked padded mask, with the compact index view when the
    layer geometry is uniform."""
    idx = None
    if uniform_geometry(cfg):
        spec = cfg.spec(cfg.layer_fanins[0])
        idx = torch.stack([compact_indices(m, spec) for m in mask_stacked])
    return Topology(unit_mask=mask_stacked, idx=idx)


def from_params(params: Dict[str, Any], cfg) -> Topology:
    return from_mask(params["hidden"]["mask"], cfg)


def install(topo: Topology, params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` with the topology's mask installed; every other key at
    both nesting levels rides through."""
    return {**params, "hidden": {**params["hidden"], "mask": topo.unit_mask}}


def check(mask_or_topo: Union[Topology, torch.Tensor], cfg) -> bool:
    """Host-side invariant check: every layer keeps exactly n units per
    (group, out-tile) and padded rows stay all-False. Reads the mask back
    to the host."""
    mask = mask_or_topo.unit_mask if isinstance(mask_or_topo, Topology) \
        else mask_or_topo
    mask = mask.cpu()
    if uniform_geometry(cfg):        # no padding: one stacked check
        return bool(check_unit_mask(mask, cfg.spec(cfg.layer_fanins[0])))
    for l, fan_in in enumerate(cfg.layer_fanins):
        spec = cfg.spec(fan_in)
        kb, j = spec.unit_counts(fan_in, cfg.n_hidden)
        if not bool(check_unit_mask(mask[l, :kb, :j], spec)):
            return False
        if bool(mask[l, kb:].any()):
            return False
    return True


def dense_masks(mask_stacked: torch.Tensor, cfg,
                dtype=torch.float32) -> torch.Tensor:
    """Stacked unit masks ``[L, KBmax, J]`` -> dense ``[L, Kmax, N]`` (zero
    rows where a layer's fan-in is below the stack width)."""
    k_max = _k_max(cfg)
    cols = []
    for l, fan_in in enumerate(cfg.layer_fanins):
        spec = cfg.spec(fan_in)
        kb, j = spec.unit_counts(fan_in, cfg.n_hidden)
        d = expand_unit_mask(mask_stacked[l, :kb, :j], spec, fan_in,
                             cfg.n_hidden)
        cols.append(_pad_rows(d.to(dtype), k_max))
    return torch.stack(cols)


# ---------------------------------------------------------------------------
# stacked prune/regrow (the layer axis is a leading batch dim of dsst's ops)
# ---------------------------------------------------------------------------

def prune_regrow_stacked(unit_mask, weight_score, grad_score, spec: NMSpec,
                         k: int) -> Tuple[torch.Tensor, TopologyStats]:
    """Dense-oracle DSST event for a ``[L, KB, J]`` mask stack sharing one
    spec."""
    new_mask, st = prune_regrow(unit_mask, weight_score, grad_score, spec, k)
    return new_mask, TopologyStats(st.pruned, st.regrown, st.mask_change)


def prune_regrow_factored_stacked(unit_mask, weight_score, pre_score,
                                  post_score, spec: NMSpec, k: int
                                  ) -> Tuple[torch.Tensor, TopologyStats]:
    """Factored DSST event for a mask stack: ``pre_score [L, KB]``,
    ``post_score [L, J]``."""
    new_mask, st = prune_regrow_factored(unit_mask, weight_score, pre_score,
                                         post_score, spec, k)
    return new_mask, TopologyStats(st.pruned, st.regrown, st.mask_change)


# ---------------------------------------------------------------------------
# delta / weight remapping across a mask change
# ---------------------------------------------------------------------------

def survivors_dense(old_mask: torch.Tensor, new_mask: torch.Tensor, cfg,
                    dtype=torch.bool) -> torch.Tensor:
    """Dense ``[L, Kmax, N]`` mask of connections present in BOTH masks."""
    return dense_masks(old_mask & new_mask, cfg, dtype=dtype)


def stacked_kept_ids(mask_stacked: torch.Tensor, cfg) -> torch.Tensor:
    """Stacked kept-block ids ``[L, J, T]`` int32, ascending per out tile:
    the convention of ``nm_spmm.ops.make_compact``, so ids derived here
    address compact tensors built there. Uniform geometry only."""
    if not uniform_geometry(cfg):
        raise ValueError("stacked kept ids require uniform layer fan-in "
                         f"(got {tuple(cfg.layer_fanins)})")
    spec = cfg.spec(cfg.layer_fanins[0])
    kb, _ = spec.unit_counts(cfg.layer_fanins[0], cfg.n_hidden)
    t = (kb // spec.m) * spec.n
    idx = torch.argsort((~mask_stacked).to(torch.int8), dim=1,
                        stable=True)[:, :t, :]
    return idx.transpose(1, 2).to(torch.int32).contiguous()


def project_deltas_compact(deltas_c: torch.Tensor, old_ids: torch.Tensor,
                           new_ids: torch.Tensor) -> torch.Tensor:
    """Remap compact per-stream deltas ``[S, L, J, T, bk, bo]`` from the old
    topology's kept-block ids to the new one's (both ``[L, J, T]``): a pure
    gather, so survivors keep their bits and regrown blocks start at zero."""
    eq = new_ids[..., :, None] == old_ids[..., None, :]       # [L, J, T, T]
    hit = eq.any(-1)                                          # [L, J, T]
    pos = eq.to(torch.uint8).argmax(-1)                       # first hit
    gathered = torch.take_along_dim(
        deltas_c, pos[None, :, :, :, None, None], dim=3)
    return torch.where(hit[None, :, :, :, None, None], gathered,
                       torch.zeros((), dtype=deltas_c.dtype,
                                   device=deltas_c.device))


def project_deltas(deltas: torch.Tensor, old_mask: torch.Tensor,
                   new_mask: torch.Tensor, cfg) -> torch.Tensor:
    """Remap the per-stream deltas across a mask change: survivors keep
    their bits, pruned and regrown coordinates go to zero. Compact
    ``[S, L, J, T, bk, bo]`` deltas remap by a kept-block-id gather (no
    dense tensor is built); dense ``[S, L, Kmax, N]`` ones by a
    ``torch.where`` against the dense survivor mask (not a multiply)."""
    if deltas.dim() == 6:
        return project_deltas_compact(deltas, stacked_kept_ids(old_mask, cfg),
                                      stacked_kept_ids(new_mask, cfg))
    surv = survivors_dense(old_mask, new_mask, cfg)           # [L, Kmax, N]
    return torch.where(surv[None], deltas,
                       torch.zeros((), dtype=deltas.dtype,
                                   device=deltas.device))


def remap_weights(w_stacked: torch.Tensor, old_mask: torch.Tensor,
                  new_mask: torch.Tensor, cfg) -> torch.Tensor:
    """Stacked form of ``dsst.apply_dsst_to_weights``: survivors keep their
    values bit-exactly; pruned and regrown entries are zeroed."""
    surv = survivors_dense(old_mask, new_mask, cfg)
    return torch.where(surv, w_stacked,
                       torch.zeros((), dtype=w_stacked.dtype,
                                   device=w_stacked.device))


def weight_unit_scores(w_stacked: torch.Tensor, cfg) -> torch.Tensor:
    """``|w|`` summarised to unit granularity per layer: ``[L, KBmax, J]``
    (padded rows score 0; they are structurally unprunable anyway)."""
    k_max = _k_max(cfg)
    cols = []
    for l, fan_in in enumerate(cfg.layer_fanins):
        spec = cfg.spec(fan_in)
        s = unit_scores(w_stacked[l, :fan_in, :], spec, fan_in, cfg.n_hidden)
        cols.append(_pad_rows(s, k_max))
    return torch.stack(cols)


# ---------------------------------------------------------------------------
# THE shared epoch (train == serve)
# ---------------------------------------------------------------------------

def topology_epoch(params: Dict[str, Any], pre: torch.Tensor,
                   post: torch.Tensor, cfg, step: int
                   ) -> Tuple[Dict[str, Any], TopologyStats]:
    """One stacked DSST prune/regrow epoch over every hidden layer.

    ``pre``: unit-granular ``[L, KBmax]`` pre-synaptic activity factors
    (padded rows ignored), ``post``: ``[L, J]`` post factors (the stacked
    ``DSSTAccumulator`` contents). ``step`` (a host int) picks the recycled
    count ``k`` from ``cfg.dsst``'s decay schedule.

    Returns ``(new_params, stats)``: the evolved mask installed, weights
    remapped (survivors bit-exact, recycled zeroed), every other leaf as it
    was.
    """
    mask = params["hidden"]["mask"]
    w = params["hidden"]["w"]
    wscore = weight_unit_scores(w, cfg)

    if uniform_geometry(cfg):
        spec = cfg.spec(cfg.layer_fanins[0])
        new_mask, stats = scheduled_k_apply(
            step, cfg.dsst, spec,
            lambda k: prune_regrow_factored_stacked(mask, wscore, pre, post,
                                                    spec, k))
    else:
        new_masks, per_layer = [], []
        for l, fan_in in enumerate(cfg.layer_fanins):
            spec = cfg.spec(fan_in)
            kb, j = spec.unit_counts(fan_in, cfg.n_hidden)
            nm, st = scheduled_k_apply(
                step, cfg.dsst, spec,
                lambda k, l=l, spec=spec, kb=kb, j=j: prune_regrow_factored(
                    mask[l, :kb, :j], wscore[l, :kb, :j], pre[l, :kb],
                    post[l, :j], spec, k))
            new_masks.append(_pad_rows(nm, mask.shape[1]))
            per_layer.append(st)
        new_mask = torch.stack(new_masks)
        stats = TopologyStats(
            pruned=torch.stack([s.pruned for s in per_layer]),
            regrown=torch.stack([s.regrown for s in per_layer]),
            mask_change=torch.stack([s.mask_change for s in per_layer]))

    new_w = remap_weights(w, mask, new_mask, cfg)
    return {**params, "hidden": {**params["hidden"], "mask": new_mask,
                                 "w": new_w}}, stats
