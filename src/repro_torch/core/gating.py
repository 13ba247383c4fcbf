"""Activity-dependent weight-update gating (``repro.core.gating``).

A layer's update fires only when the input activity (IA) exceeds a global
threshold and the similarity score (SS) of the current trace to the stored
previous-sample trace is below an adaptive per-layer (per-stream, in
serving) threshold that rides the running mean of SS.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

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


def skip_rate(state: GatingState) -> torch.Tensor:
    """Fraction of offered WUs that were skipped (→ power saved)."""
    return 1.0 - state.opened.sum() / torch.clamp_min(state.offered.sum(), 1.0)
