"""Live DSST topology evolution under serving traffic
(``repro.serving.topology_service``).

The fleet's connectivity keeps evolving from live activity while OSSL and
the gated weight update run on the same traffic, without draining a
session. The cycle, driven by ``StreamScheduler.maybe_evolve_topology``:

1. **accumulate**: every retired grid step carries the DSST factors
   (summed ``|pre trace|`` and ``|OSSL modulator|``, valid-masked per slot
   inside the chunk, slot-reduced on the card by the order-fixed
   ``engine.ordered_slot_sum``: ``[L, Kmax]`` / ``[L, N]``).
   :meth:`TopologyService.observe` folds them into one decaying accumulator
   per layer, stacked: small numpy arrays on the host, O(L·(K + N));
2. **fold**: the hot streams' lanes (largest delta norms among the active
   adaptive slots) merge into the shared base with ``merge_weight`` and
   their lane delta is scaled down by the same factor, so a fully merged
   lane's effective weights keep their bits;
3. **evolve**: one stacked prune/regrow epoch through
   ``topology.topology_epoch``, the code path the training step runs, with
   ``k`` from the ``DSSTConfig`` schedule at the service's epoch index;
4. **remap and swap**: surviving weights and deltas keep their bits,
   recycled coordinates restart at zero (``topology.project_deltas``);
   every tensor keeps its shape, dtype and device, so the scheduler swaps
   them between grid steps and the chunk step is never rebuilt. The
   exactly-n-per-group invariant is checked after every epoch.

A slot-sharded fleet (``launch.sharding.SlotSharded`` deltas) runs the same
epoch: each lane's norm is read from its shard, a hot lane folds into the
base from its shard, and every shard is remapped on its own device, so the
deltas come back sharded as they went in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import topology as topology_lib
from ..core.snn import ChunkMetrics, SNNConfig
from ..launch import sharding
from .adapt import delta_norms, merge_lane_into_base


@dataclasses.dataclass(frozen=True)
class TopologyServiceConfig:
    epoch_every: int = 100       # grid steps between prune/regrow epochs
    accum_decay: float = 0.9     # per-grid-step decay of the pre/post factors
    min_observed_steps: float = 1.0   # valid timesteps required before an epoch
    merge_top: int = 0           # hot streams folded into the base per epoch
    merge_weight: float = 1.0    # fraction of a hot lane's delta promoted
    merge_min_norm: float = 1e-6  # lanes below this delta norm never merge


@dataclasses.dataclass(frozen=True)
class TopologyEpochEvent:
    """What one live prune/regrow epoch did (telemetry record)."""
    epoch: int                   # 0-based epoch index
    grid_step: int               # scheduler step the swap landed after
    pruned: int                  # connections recycled (sum over layers)
    regrown: int
    mask_change: float           # mean fraction of units flipped per layer
    merged_slots: Tuple[int, ...]  # hot lanes folded into the base first


def _per_shard(fn, deltas):
    """``fn`` on a delta tensor, or on every shard of a slot-sharded one."""
    if isinstance(deltas, sharding.SlotSharded):
        return sharding.map_shards(fn, deltas)
    return fn(deltas)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TopologyService:
    """Accumulates live DSST factors and evolves one fleet's topology. The
    accumulators are host numpy buffers fed from already-fetched chunk
    metrics; the epoch runs as torch ops on the fleet's device."""

    def __init__(self, cfg: SNNConfig,
                 service: Optional[TopologyServiceConfig] = None):
        self.cfg = cfg
        self.service = service or TopologyServiceConfig()
        counts = [cfg.spec(f).unit_counts(f, cfg.n_hidden)
                  for f in cfg.layer_fanins]
        self._kbs = [kb for kb, _ in counts]
        self._js = [j for _, j in counts]
        self.epoch_idx = 0
        self.observed_steps = 0.0
        self._last_epoch_step = 0
        self.events: List[TopologyEpochEvent] = []
        self._reset_accumulators()

    def _reset_accumulators(self) -> None:
        # both factors are kept, as the chip writes both back; the factored
        # regrow ranks a group by |pre| alone, |post| rides along
        L = self.cfg.n_layers
        self.pre = np.zeros((L, max(self._kbs)), np.float32)
        self.post = np.zeros((L, max(self._js)), np.float32)
        self.observed_steps = 0.0

    # -- 1. accumulate --------------------------------------------------------
    def observe(self, metrics: ChunkMetrics) -> None:
        """Fold one grid step's chunk metrics into the decaying factors:
        slot-reduced ``[L, Kmax]`` / ``[L, N]`` factors from a chunk fn with
        ``want_factors=True``, or raw per-slot ``[S, L, ·]`` ones straight
        out of ``snn.run_chunk`` (summed over slots here, in numpy's order).
        Torch tensors are read back to the host."""
        if metrics.pre_mag is None:
            raise ValueError(
                "chunk metrics carry no DSST factors (want_factors=False); "
                "a live topology service needs a factor-bearing chunk fn")
        pre = _host(metrics.pre_mag).astype(np.float32, copy=False)
        post = _host(metrics.post_mag).astype(np.float32, copy=False)
        if pre.ndim == 3:                      # [S, L, ·]: raw run_chunk form
            pre, post = pre.sum(0), post.sum(0)
        d = self.service.accum_decay
        self.pre *= d
        self.post *= d
        for l, fan_in in enumerate(self.cfg.layer_fanins):
            kb, j = self._kbs[l], self._js[l]
            self.pre[l, :kb] += pre[l, :fan_in].reshape(kb, -1).sum(-1)
            self.post[l, :j] += post[l].reshape(j, -1).sum(-1)
        self.observed_steps += float(_host(metrics.steps).sum())

    @property
    def virtual_step(self) -> int:
        """The step the next epoch presents to the DSST schedule: the epoch
        index mapped onto the config's period, so ``frac_decay``,
        ``start_step`` and ``stop_step`` mean what they mean in training."""
        dcfg = self.cfg.dsst
        return dcfg.start_step + self.epoch_idx * max(1, dcfg.period)

    @property
    def frozen(self) -> bool:
        """True when connectivity must not evolve: DSST off, the dense
        baseline, or past ``stop_step``."""
        return (not self.cfg.dsst_enabled or self.cfg.dense
                or self.virtual_step >= self.cfg.dsst.stop_step)

    def due(self, grid_step: int) -> bool:
        """True when an epoch should run after ``grid_step``: not frozen,
        the cadence elapsed, and enough valid traffic observed (an idle
        fleet never churns its topology on all-zero scores)."""
        if self.frozen:
            return False
        if grid_step - self._last_epoch_step < self.service.epoch_every:
            return False
        return self.observed_steps >= self.service.min_observed_steps

    # -- 2. fold hot streams --------------------------------------------------
    def _fold_hot_streams(self, params: Dict[str, Any], deltas: torch.Tensor,
                          merge_slots: Sequence[int]
                          ) -> Tuple[Dict[str, Any], torch.Tensor,
                                     Tuple[int, ...]]:
        svc = self.service
        if svc.merge_top <= 0 or not merge_slots:
            return params, deltas, ()
        norms = _host(delta_norms(deltas))
        eligible = [s for s in merge_slots if norms[s] > svc.merge_min_norm]
        hot = tuple(sorted(eligible, key=lambda s: -norms[s])[:svc.merge_top])
        if not hot:
            return params, deltas, ()
        deltas = _per_shard(torch.clone, deltas)
        for slot in hot:
            params = merge_lane_into_base(params, deltas, slot, self.cfg,
                                          weight=svc.merge_weight)
            if svc.merge_weight >= 1.0:
                deltas[slot].zero_()   # exact: the lane's effective weights
            else:                      # keep their bits
                deltas[slot].mul_(1.0 - svc.merge_weight)
        return params, deltas, hot

    # -- 3 & 4. evolve + remap ------------------------------------------------
    def evolve(self, params: Dict[str, Any], deltas: torch.Tensor,
               merge_slots: Sequence[int] = (), grid_step: int = 0
               ) -> Tuple[Dict[str, Any], torch.Tensor, TopologyEpochEvent]:
        """One live topology epoch: ``(params', deltas', event)`` of the
        inputs' shapes, dtypes and devices (slot-sharded deltas stay so);
        nothing passed in is written."""
        if self.frozen:
            raise ValueError(
                "topology is frozen (dsst disabled, dense baseline, or past "
                f"stop_step={self.cfg.dsst.stop_step}); refusing to evolve")
        params, deltas, merged = self._fold_hot_streams(params, deltas,
                                                        merge_slots)
        old_mask = params["hidden"]["mask"]
        dev = old_mask.device
        new_params, stats = topology_lib.topology_epoch(
            params, torch.from_numpy(self.pre).to(dev),
            torch.from_numpy(self.post).to(dev), self.cfg,
            step=self.virtual_step)
        new_mask = new_params["hidden"]["mask"]
        new_deltas = _per_shard(
            lambda d: topology_lib.project_deltas(
                d, old_mask.to(d.device), new_mask.to(d.device), self.cfg),
            deltas)
        if not topology_lib.check(new_mask, self.cfg):
            raise AssertionError("topology epoch violated the "
                                 "exactly-n-per-group invariant")
        event = TopologyEpochEvent(
            epoch=self.epoch_idx, grid_step=int(grid_step),
            pruned=int(stats.total_pruned), regrown=int(stats.total_regrown),
            mask_change=float(stats.mask_change.mean()),
            merged_slots=merged)
        self.events.append(event)
        self.epoch_idx += 1
        self._last_epoch_step = int(grid_step)
        self._reset_accumulators()
        return new_params, new_deltas, event
