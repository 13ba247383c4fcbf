"""Dynamic Structured Sparse Training (DSST), ``repro.core.dsst``.

Sparse-to-sparse training: the network starts at uniform N:M sparsity and,
every ``period`` samples, prunes the ``k`` smallest-magnitude active units
of each N:M group and regrows ``k`` inactive ones with the largest gradient
magnitude, so every group keeps exactly ``n`` units.

:func:`prune_regrow_factored` is the paper's neuron-level sort: the
gradient of ``y = x @ w`` factors as ``|g_ij| = |pre_i|·|post_j|``, so the
regrow ranking inside a group is the ranking of ``|pre|``, sorted once per
group and shared by every output column.

Ties: ``jax.lax.top_k`` gives the lower index first and orders ``+0.0``
above ``-0.0``; ``torch.topk`` fixes no order for ties. :func:`_top_k_ids`
therefore sorts a total-order integer key with a stable descending sort and
takes the first ``k``. The sample counter is a host int in the port, so the
epoch and its ``k`` are decided on the host (:func:`scheduled_k_apply`).
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Callable, NamedTuple, Tuple

import torch

from .sparsity import NMSpec, expand_unit_mask, unit_scores


@dataclasses.dataclass(frozen=True)
class DSSTConfig:
    period: int = 100          # WU cycles between connectivity updates
    prune_frac: float = 0.3    # fraction of each group's n connections recycled
    start_step: int = 0        # no connectivity updates before this
    stop_step: int = 10**9     # freeze connectivity after this
    frac_decay: float = 1.0    # multiplicative decay of prune_frac per event

    def k_for_event(self, spec: NMSpec, event: int) -> int:
        """Number of connections recycled per group at the ``event``-th
        connectivity update (``frac_decay`` applied per event)."""
        frac = self.prune_frac * (self.frac_decay ** max(0, event))
        k = int(round(spec.n * frac))
        return max(0, min(k, spec.n - 1))

    def k_per_group(self, spec: NMSpec, step: int = 0) -> int:
        """Connections recycled per group at sample ``step`` (a host int)."""
        events = max(0, int(step) - self.start_step) // max(1, self.period)
        return self.k_for_event(spec, events)

    def k_levels(self, spec: NMSpec, max_events: int = 100_000
                 ) -> Tuple[Tuple[int, int], ...]:
        """The decay schedule as ``(first_event, k)`` levels: ``k(event)`` is
        monotone, so the schedule collapses to at most ``spec.n`` levels."""
        levels = [(0, self.k_for_event(spec, 0))]
        if self.frac_decay == 1.0:
            return tuple(levels)
        for e in range(1, max_events):
            k = self.k_for_event(spec, e)
            if k != levels[-1][1]:
                levels.append((e, k))
            if k == 0 or (self.frac_decay > 1.0 and k >= spec.n - 1):
                break
        return tuple(levels)

    def is_update_step(self, step: int) -> bool:
        """Whether sample ``step`` (a host int) ends with a DSST epoch."""
        step = int(step)
        return (self.start_step <= step < self.stop_step
                and step % self.period == self.period - 1)


class DSSTStats(NamedTuple):
    """Per-event telemetry (per leading index for a stacked mask)."""
    pruned: torch.Tensor       # int32: connections recycled this event
    regrown: torch.Tensor      # int32
    mask_change: torch.Tensor  # f32: fraction of units whose state flipped


_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor ordered as ``jax.lax.top_k`` orders the floats
    ``x``: IEEE order, with ``-0.0`` below ``+0.0``."""
    i = x.contiguous().view(_INT_VIEW[x.dtype])
    return torch.where(i < 0, i ^ torch.iinfo(i.dtype).max, i)


def _top_k_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last dim, in
    ``jax.lax.top_k``'s order: descending, the lower index first on a tie."""
    order = torch.sort(_total_order_key(x), dim=-1, descending=True,
                       stable=True).indices
    return order[..., :k]


def prune_regrow(unit_mask: torch.Tensor, weight_score: torch.Tensor,
                 grad_score: torch.Tensor, spec: NMSpec, k: int
                 ) -> Tuple[torch.Tensor, DSSTStats]:
    """One DSST event with a dense regrow oracle; keeps exactly n per group.

    ``unit_mask`` bool ``[..., KB, J]`` (leading dims, such as a layer
    stack, share ``spec``); scores of the same shape. Prune: of the n active
    units of each (group, out tile), keep the ``n - k`` with the largest
    weight score. Regrow: of the inactive ones, add the ``k`` with the
    largest grad score. Stats are per leading index.
    """
    *lead, kb, j = unit_mask.shape
    if k == 0:
        z = torch.zeros(lead, dtype=torch.int32, device=unit_mask.device)
        return unit_mask, DSSTStats(z, z, torch.zeros(lead,
                                                      device=unit_mask.device))
    if k >= spec.n:
        raise ValueError(f"k={k} must be < n={spec.n}")
    g = kb // spec.m

    def grouped(x):                             # [..., G, J, m]
        return x.reshape(*lead, g, spec.m, j).transpose(-1, -2)

    gm_mask = grouped(unit_mask)
    neg_inf = torch.tensor(-torch.inf, dtype=weight_score.dtype,
                           device=weight_score.device)
    keep_idx = _top_k_ids(torch.where(gm_mask, grouped(weight_score),
                                      neg_inf), spec.n - k)
    grow_idx = _top_k_ids(torch.where(gm_mask, neg_inf.to(grad_score.dtype),
                                      grouped(grad_score)), k)
    new_idx = torch.cat([keep_idx, grow_idx], dim=-1)             # [..., G, J, n]
    new_gm = torch.zeros_like(gm_mask).scatter_(-1, new_idx, True)
    new_mask = new_gm.transpose(-1, -2).reshape(unit_mask.shape)

    dims = (-2, -1)
    flips = (new_mask != unit_mask).sum(dims)
    stats = DSSTStats(
        pruned=(unit_mask & ~new_mask).sum(dims).to(torch.int32),
        regrown=(~unit_mask & new_mask).sum(dims).to(torch.int32),
        mask_change=flips / (kb * j))
    return new_mask, stats


def factored_group_order(pre_score: torch.Tensor, spec: NMSpec) -> torch.Tensor:
    """Rank units inside each group by ``|pre|`` once, shared by all out
    columns: int32 ``[..., G, m]`` in descending score order.

    A stable argsort of ``-score``, as the reference's: its sort compares
    ``-0.0`` equal to ``+0.0`` (unlike its ``top_k``), and so does torch's.
    """
    *lead, kb = pre_score.shape
    grouped = pre_score.reshape(*lead, kb // spec.m, spec.m)
    return torch.argsort(-grouped, dim=-1, stable=True).to(torch.int32)


def prune_regrow_factored(unit_mask: torch.Tensor, weight_score: torch.Tensor,
                          pre_score: torch.Tensor, post_score: torch.Tensor,
                          spec: NMSpec, k: int
                          ) -> Tuple[torch.Tensor, DSSTStats]:
    """DSST event with the factorized gradient ``|g_ij| = |pre_i|·|post_j|``:
    ``|post_j|`` is constant along a group, so the regrow choice is "the
    first k inactive units in the shared per-group ``|pre|`` order".
    ``pre_score [..., KB]``; ``post_score`` does not change the order."""
    del post_score
    order = factored_group_order(pre_score, spec).long()            # [..., G, m]
    *lead, g, m = order.shape
    j = unit_mask.shape[-1]
    # rank of each unit inside its group (0 = largest |pre|)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(m, device=order.device).expand_as(order))
    shared = (m - rank).to(weight_score.dtype)                      # [..., G, m]
    grad_score = shared.reshape(*lead, g * m, 1).expand(*lead, g * m, j)
    return prune_regrow(unit_mask, weight_score, grad_score, spec, k)


class DSSTAccumulator(NamedTuple):
    """Running ``|pre|`` / ``|post|`` factors between connectivity updates,
    a decaying sum: O(K + O) state per layer instead of O(K·O)."""
    pre: torch.Tensor    # [KB]
    post: torch.Tensor   # [J]

    @staticmethod
    def init(kb: int, j: int, dtype=torch.float32,
             device="cuda") -> "DSSTAccumulator":
        return DSSTAccumulator(torch.zeros((kb,), dtype=dtype, device=device),
                               torch.zeros((j,), dtype=dtype, device=device))

    def update(self, pre_mag: torch.Tensor, post_mag: torch.Tensor,
               decay: float = 0.9) -> "DSSTAccumulator":
        return DSSTAccumulator(self.pre * decay + pre_mag,
                               self.post * decay + post_mag)


def dense_grad_unit_score(grad: torch.Tensor, spec: NMSpec) -> torch.Tensor:
    """``|grad|`` summarised to unit granularity: the RigL oracle key."""
    return unit_scores(grad, spec, *grad.shape, reduce="abs_sum")


def apply_dsst_to_weights(w: torch.Tensor, old_mask: torch.Tensor,
                          new_mask: torch.Tensor, spec: NMSpec) -> torch.Tensor:
    """Zero regrown connections (they restart from 0, as on-chip) and keep
    surviving values; pruned values are dropped."""
    k, o = w.shape
    survived = expand_unit_mask(old_mask & new_mask, spec, k, o)
    return w * survived.to(w.dtype)


def scheduled_k_apply(step: int, cfg: DSSTConfig, spec: NMSpec,
                      fn: Callable[[int], object]):
    """Run ``fn(k)`` with ``k`` from ``cfg``'s decay schedule at sample
    ``step``. ``step`` is a host int: the port keeps the sample counter on
    the host, so ``k`` is known without reading the device (the reference's
    traced-step ``lax.switch`` over :meth:`DSSTConfig.k_levels` picks the
    same level)."""
    if isinstance(step, torch.Tensor):
        raise TypeError("step must be a host int, not a tensor")
    return fn(cfg.k_per_group(spec, operator.index(step)))


def maybe_dsst(step: int, cfg: DSSTConfig, spec: NMSpec, w: torch.Tensor,
               unit_mask: torch.Tensor, acc: DSSTAccumulator):
    """One layer's DSST event when sample ``step`` (a host int) ends a
    period, else the identity. Returns ``(w, unit_mask, acc, did_update)``:
    after an event the weights are remapped, the mask evolved with the
    factored regrow and the accumulator fresh; ``did_update`` is a host
    bool."""
    if not cfg.is_update_step(step):
        return w, unit_mask, acc, False
    wscore = unit_scores(w, spec, *w.shape, reduce="abs_sum")
    new_mask, _ = scheduled_k_apply(
        step, cfg, spec,
        lambda k: prune_regrow_factored(unit_mask, wscore, acc.pre, acc.post,
                                        spec, k))
    new_w = apply_dsst_to_weights(w, unit_mask, new_mask, spec)
    fresh = DSSTAccumulator.init(acc.pre.shape[0], acc.post.shape[0],
                                 acc.pre.dtype, device=acc.pre.device)
    return new_w, new_mask, fresh, True
