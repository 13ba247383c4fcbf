"""Double-buffered event staging for the serving hot path
(``repro.serving.staging``).

The scheduler's grid step runs as stage (host only: clock, sources,
admission, packing the ``[C, S, n_in]`` buffers), dispatch (enqueue the
chunk step on the card and return) and retire (one device-to-host fetch,
then bookkeeping). With ``depth >= 1`` the stage phase of step ``t+1`` runs
while the card computes step ``t`` (and, deeper, while earlier steps still
wait to retire).

PyTorch tensors are mutable and the scheduler's lane surgery writes them in
place, unlike the reference's immutable arrays. So an :class:`InFlight`
step does not keep a handle on the live delta tensor: dispatch copies the
lanes that its retire phase will read (those of the sessions retiring after
the step) before any later stage can reset them. Every depth therefore
reads the same values.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class LaneRecord:
    """What one occupied lane was fed this grid step."""
    slot: int
    session: Any                 # StreamSession
    n_fed: int                   # timesteps packed into the lane
    events_in: float             # total input spikes packed (telemetry)


@dataclasses.dataclass
class StagedChunk:
    """One grid step's host-assembled inputs + scheduling decisions.

    ``events [D, C, S/D, n_in]`` f32, ``valid [D, C, S/D]`` bool and
    ``adapt_mask [D, S/D]`` bool are host tensors laid out shard-major over
    the fleet's ``D`` slot shards (``D = 1`` without a mesh), so each
    shard's block is one contiguous region; pinned when the fleet lives on
    a CUDA device, so dispatch copies each block asynchronously. ``retiring`` lists the
    ``(slot, session)`` pairs that exhaust after this step. ``merge_slots``
    snapshots the adaptive occupants a topology epoch after this step may
    fold into the base (taken here, so a pipelined retire sees the lanes
    the serial scheduler would, not later admissions).
    """
    events: Any
    valid: Any
    adapt_mask: Any
    lanes: List[LaneRecord]
    retiring: List[Tuple[int, Any]]
    merge_slots: Tuple[int, ...]
    fed: Dict[int, int]          # {slot: timesteps fed} (step() return value)


@dataclasses.dataclass
class InFlight:
    """A dispatched-but-unretired grid step: the staged host record, the
    chunk step's metrics (device tensors), and ``final_deltas``: a copy,
    taken at dispatch, of the post-step lanes of ``staged.retiring`` (in
    that order, in the fleet's delta layout: a tuple of per-shard blocks,
    joined in shard order), or None when nobody retires."""
    staged: StagedChunk
    final_deltas: Optional[Any]
    metrics: Any
    grid_step: int
    pushed_at: float = 0.0       # perf_counter when the step entered the queue
    queued_s: float = 0.0        # time in flight before retire began


class StagingPipeline:
    """Bounded FIFO of in-flight grid steps (the double buffer).

    ``depth`` is the number of dispatched steps that may be outstanding
    before the scheduler must retire the oldest: 0 retires every step inside
    ``step()`` (the reference behaviour); 1 stages step ``t+1`` while step
    ``t`` computes; deeper queues also hide retire's host bookkeeping, but
    would defer a topology epoch past steps already dispatched, so the
    scheduler clamps depth to 1 under a topology service.
    """

    def __init__(self, depth: int = 1):
        if depth < 0:
            raise ValueError(f"pipeline depth must be >= 0, got {depth}")
        self.depth = depth
        self._q: Deque[InFlight] = deque()

    def set_depth(self, depth: int) -> None:
        """Resize at a drain-safe boundary (the autopilot's apply point).
        Refuses while steps are in flight: an adaptive run equals every
        fixed depth it visited because each resize meets an empty queue."""
        if depth < 0:
            raise ValueError(f"pipeline depth must be >= 0, got {depth}")
        if self._q:
            raise RuntimeError(
                f"cannot resize with {len(self._q)} step(s) in flight — "
                "flush the pipeline first (depth changes land only at "
                "drain-safe boundaries)")
        self.depth = depth

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        """True when a dispatch must be preceded by retiring the oldest."""
        return len(self._q) >= max(self.depth, 1)

    def push(self, fl: InFlight) -> None:
        if self.depth == 0:
            raise RuntimeError("synchronous pipeline (depth=0) cannot hold "
                               "in-flight steps; retire immediately instead")
        if self.full:
            raise RuntimeError("staging pipeline full; retire first")
        fl.pushed_at = time.perf_counter()
        self._q.append(fl)

    def pop(self) -> InFlight:
        """Oldest in-flight step; stamps how long it was in flight."""
        fl = self._q.popleft()
        if fl.pushed_at:
            fl.queued_s = time.perf_counter() - fl.pushed_at
        return fl
