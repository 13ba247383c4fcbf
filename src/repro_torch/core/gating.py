"""Activity-dependent weight-update gating (``repro.core.gating``).

A layer's update fires only when the input activity (IA) exceeds a global
threshold and the similarity score (SS) of the current trace to the stored
previous-sample trace is below an adaptive per-layer (per-stream, in
serving) threshold that rides the running mean of SS.

The same formula gates per-layer optimizer updates for the LM families
(``optim/sparse.py``): IA = mean |block input|, SS = cosine of the pooled
block output against its EMA (``gate_batch``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class GatingConfig:
    enabled: bool = True
    theta_ia: float = 0.005    # global input-activity threshold (spike rate)
    ss_rho: float = 0.05       # adaptation rate of the per-layer SS threshold
    ss_scale: float = 1.0      # threshold = ss_scale * running-mean SS
    ss_init: float = 1.0       # running-mean starts pessimistic: gate open early


class GatingState(NamedTuple):
    ss_mean: torch.Tensor   # [L] running mean of SS per layer
    opened: torch.Tensor    # [L] count of fired gates   (telemetry)
    offered: torch.Tensor   # [L] count of gate decisions (telemetry)


def init_state(n_layers: int, cfg: GatingConfig | None = None,
               device="cuda") -> GatingState:
    init = (cfg or GatingConfig()).ss_init
    return GatingState(
        ss_mean=torch.full((n_layers,), init, dtype=torch.float32,
                           device=device),
        opened=torch.zeros((n_layers,), device=device),
        offered=torch.zeros((n_layers,), device=device))


def gate_decide(ss_mean: torch.Tensor, ia: torch.Tensor, ss: torch.Tensor,
                cfg: GatingConfig):
    """THE gate formula; broadcasts over any common shape of
    ``(ss_mean, ia, ss)`` (``[S]`` per serving slot). Returns (open?, new
    running-mean SS threshold); the running mean adapts whether or not the
    gate fired."""
    thr = cfg.ss_scale * ss_mean
    open_ = (ia > cfg.theta_ia) & (ss < thr)
    if not cfg.enabled:
        open_ = torch.ones_like(open_, dtype=torch.bool)
    new_mean = (1 - cfg.ss_rho) * ss_mean + cfg.ss_rho * ss.abs()
    return open_, new_mean


class LayerGate(NamedTuple):
    ss_mean: torch.Tensor
    opened: torch.Tensor
    offered: torch.Tensor


def gate_update(state: GatingState, layer: int, ia: torch.Tensor,
                ss: torch.Tensor, cfg: GatingConfig):
    """One gate decision for ``layer``. Returns (open?, per-layer new state)."""
    open_, new_mean = gate_decide(state.ss_mean[layer], ia, ss, cfg)
    return open_, LayerGate(new_mean, state.opened[layer] + open_.float(),
                            state.offered[layer] + 1.0)


def merge(state: GatingState, layer_gates: Sequence[LayerGate]) -> GatingState:
    return GatingState(
        ss_mean=torch.stack([g.ss_mean for g in layer_gates]),
        opened=torch.stack([g.opened for g in layer_gates]),
        offered=torch.stack([g.offered for g in layer_gates]))


def gate_batch(state: GatingState, ia: torch.Tensor, ss: torch.Tensor,
               cfg: GatingConfig):
    """Vectorised per-layer gate decision (LM training path). ``ia``,
    ``ss``: [L]. Returns (open [L] float 0/1, new state); nothing is read
    back to the host."""
    open_, new_mean = gate_decide(state.ss_mean, ia, ss, cfg)
    new = GatingState(ss_mean=new_mean,
                      opened=state.opened + open_.float(),
                      offered=state.offered + 1.0)
    return open_.float(), new


def skip_rate(state: GatingState) -> torch.Tensor:
    """Fraction of offered WUs that were skipped (→ power saved)."""
    return 1.0 - state.opened.sum() / torch.clamp_min(state.offered.sum(), 1.0)
