"""Occupancy-driven adaptive pipeline depth for the serving grid
(``repro.serving.autopilot``).

``FleetTelemetry.record_overlap`` measures, per retired step, how much
device compute the host hid behind staging: ``hidden / (hidden + wait)``
is ~1 when the fleet is host-bound (the device finished long before the
host came back — a deeper pipeline buys throughput) and ~0 when it is
device-bound (staging hides nothing — deeper queues only add latency).
:class:`DepthAutopilot` turns that dashboard number into a control loop
over ``pipeline_depth``.

Controller state machine:

* **SERIAL** (depth 0) — unpipelined steps carry no overlap signal
  (hidden is always 0), so after ``warmup_obs`` observations the
  controller *probes* to depth 1 regardless of the EMA.
* **PIPELINED** (depth >= 1) — every ``decide_every`` grid steps, if the
  overlap EMA exceeds ``deepen_above`` and depth < ``max_depth``, deepen
  by one (host-bound: hide more); if it falls below ``relax_below`` and
  depth > ``min_pipelined_depth``, relax by one (device-bound: shorten
  the queue, but never back to 0 — that would blind the signal).
  Otherwise hold.
* **Hysteresis** — after any change the depth is frozen for
  ``hold_steps`` grid steps, and the deadband between the two thresholds
  absorbs a noisy EMA, so an oscillating overlap signal cannot flap the
  depth.

The controller itself only *proposes* depths; the scheduler applies a
proposal at a drain-safe boundary (flush every in-flight step, then
resize the empty pipelines), which is what keeps adaptive runs
bit-identical per-stream to every fixed depth they visited — pipelining
changes when host work happens, never what the card computes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional, Tuple

from ..obs.trace import NULL_TRACER, Tracer


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    """Bounds and hysteresis for :class:`DepthAutopilot`.

    The thresholds are a deadband on the overlap-ratio EMA: deepen only
    above ``deepen_above``, relax only below ``relax_below``, hold in
    between.  ``hold_steps`` freezes the depth after every change;
    ``decide_every`` rate-limits evaluations; ``warmup_obs`` observations
    must land before the first decision (and before the serial→pipelined
    probe).  ``min_pipelined_depth`` is the relax floor once pipelined.
    """
    max_depth: int = 2
    min_pipelined_depth: int = 1
    ema_alpha: float = 0.25
    deepen_above: float = 0.6
    relax_below: float = 0.05
    decide_every: int = 4
    hold_steps: int = 8
    warmup_obs: int = 2
    timeline_maxlen: int = 512

    def __post_init__(self):
        if not 0 <= self.min_pipelined_depth <= self.max_depth:
            raise ValueError(
                f"need 0 <= min_pipelined_depth <= max_depth, got "
                f"{self.min_pipelined_depth}..{self.max_depth}")
        if not 0.0 <= self.relax_below <= self.deepen_above <= 1.0:
            raise ValueError(
                "thresholds must satisfy 0 <= relax_below <= deepen_above "
                f"<= 1, got {self.relax_below}/{self.deepen_above}")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha in (0, 1], got {self.ema_alpha}")


class DepthAutopilot:
    """EMA-of-overlap pipeline-depth controller (host only: it never
    touches the card).  ``observe`` folds one retired step's
    overlap ratio; ``decide`` returns the depth to run the next step at.
    ``timeline`` is a bounded ring of ``(grid_step, depth)`` change
    points — the chosen-depth timeline."""

    def __init__(self, config: Optional[AutopilotConfig] = None,
                 tracer: Optional[Tracer] = None):
        self.cfg = config or AutopilotConfig()
        self.tracer = tracer or NULL_TRACER
        self.ema: Optional[float] = None      # None until first observation
        self.decisions = 0                    # depth changes proposed
        self.timeline: Deque[Tuple[int, int]] = deque(
            maxlen=self.cfg.timeline_maxlen)
        self._observed = 0
        self._last_eval_step = -10 ** 9
        self._last_change_step = -10 ** 9

    def note_depth(self, grid_step: int, depth: int) -> None:
        """Record a depth as current (the scheduler calls this with the
        initial depth and after applying each proposal)."""
        if not self.timeline or self.timeline[-1][1] != depth:
            self.timeline.append((int(grid_step), int(depth)))

    def observe(self, overlap_ratio: float) -> float:
        """Fold one retired step's overlap ratio into the EMA; returns
        the updated EMA (the value ``serving_overlap_ema`` exports)."""
        r = min(1.0, max(0.0, float(overlap_ratio)))
        self.ema = r if self.ema is None else (
            self.cfg.ema_alpha * r + (1.0 - self.cfg.ema_alpha) * self.ema)
        self._observed += 1
        return self.ema

    def decide(self, grid_step: int, depth: int) -> int:
        """Proposed pipeline depth for the step about to be staged.

        Returns ``depth`` unchanged while warming up, rate-limited, or
        frozen by hysteresis; otherwise applies the state machine above.
        Each evaluation emits an ``autopilot.decision`` trace span whose
        ``action`` attr is ``probe``/``deepen``/``relax``/``hold``.
        """
        c = self.cfg
        if self._observed < c.warmup_obs:
            return depth
        if grid_step - self._last_eval_step < c.decide_every:
            return depth
        self._last_eval_step = grid_step
        if grid_step - self._last_change_step < c.hold_steps:
            return depth
        ema = self.ema if self.ema is not None else 0.0
        action, new = "hold", depth
        if depth < 1 <= c.max_depth:
            # serial steps record overlap 0 by construction — there is no
            # signal to read until the fleet pipelines, so probe to 1
            action, new = "probe", 1
        elif ema > c.deepen_above and depth < c.max_depth:
            action, new = "deepen", depth + 1
        elif ema < c.relax_below and depth > c.min_pipelined_depth:
            action, new = "relax", depth - 1
        with self.tracer.span("autopilot.decision", grid_step=grid_step,
                              action=action, ema=round(ema, 4),
                              depth=depth, proposed=new):
            pass
        if new != depth:
            self._last_change_step = grid_step
            self.decisions += 1
        return new

    def depths_visited(self) -> Tuple[int, ...]:
        """Sorted unique depths the fleet actually ran at (from the
        change-point timeline) — what the bit-parity test replays as
        fixed-depth references."""
        return tuple(sorted({d for _, d in self.timeline}))
