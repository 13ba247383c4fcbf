"""Per-stream stateful SNN sessions and lane surgery (``repro.serving.session``).

A ``StreamSession`` is the host-side record of one event stream: identity,
lifecycle, buffered-but-unprocessed chunks, emitted window predictions.
The device-side state lives in slot-leading batched tensors; a session only
remembers which lane is its own.

Lane surgery writes in place: ``write_lane``/``reset_lane`` touch exactly
one slot index of every leaf and leave every other lane's bits alone. A
slot-sharded leaf (``launch.sharding.SlotSharded``) is written in the shard
that holds the slot. The scheduler never lets a later write reach what an in-flight step still has
to read (see ``serving/staging.InFlight``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional

import numpy as np
import torch

from ..core.snn import SNNConfig, init_stream_deltas, init_stream_state
from ..launch.sharding import SlotSharded


class SessionStatus(enum.Enum):
    QUEUED = "queued"
    ACTIVE = "active"
    RETIRED = "retired"


@dataclasses.dataclass
class WindowPrediction:
    """Readout emitted when a session's T-step window closes."""
    window_idx: int
    logits: np.ndarray        # [n_out]

    @property
    def label(self) -> int:
        return int(np.argmax(self.logits))


@dataclasses.dataclass
class StreamSession:
    sid: int
    source: Any = None                      # StreamSource (stream_source.py)
    adapt: bool = True                      # OSSL adaptation on for this stream
    n_in: Optional[int] = None              # event width; learned on first
    #   push or stamped by the scheduler at submit
    tier: Optional[str] = None              # QoS tier; resolved at submit
    status: SessionStatus = SessionStatus.QUEUED
    slot: Optional[int] = None
    timesteps_fed: int = 0
    predictions: List[WindowPrediction] = dataclasses.field(default_factory=list)
    _pending: List[np.ndarray] = dataclasses.field(default_factory=list)
    # the IngestWorker holding this session's queued-but-undrained chunks
    # (set by IngestWorker.attach, cleared at detach)
    _ingest: Any = None
    # this stream's deltas at retirement, in the fleet's layout: compact
    # [n_layers, J, T, bk, bo] or dense [n_layers, Kmax, N]
    final_deltas: Optional[np.ndarray] = None

    def push_events(self, chunk: np.ndarray) -> None:
        """chunk: [c, n_in] binary spikes, any c >= 1 (stored as f32)."""
        if chunk.ndim != 2:
            raise ValueError(f"chunk must be [c, n_in], got {chunk.shape}")
        if self.n_in is None:
            self.n_in = int(chunk.shape[1])
        elif chunk.shape[1] != self.n_in:
            raise ValueError(
                f"chunk width {chunk.shape[1]} != session n_in {self.n_in}")
        self._pending.append(np.asarray(chunk, np.float32))

    def pending_timesteps(self) -> int:
        return sum(c.shape[0] for c in self._pending)

    def pop_chunk(self, max_len: int) -> np.ndarray:
        """Pop up to ``max_len`` buffered timesteps as one [c, n_in] array."""
        out, need = [], max_len
        while self._pending and need > 0:
            head = self._pending[0]
            if head.shape[0] <= need:
                out.append(self._pending.pop(0))
                need -= head.shape[0]
            else:
                out.append(head[:need])
                self._pending[0] = head[need:]
                need = 0
        if not out:
            return np.zeros((0, self.n_in or 0), np.float32)
        return np.concatenate(out, axis=0)

    @property
    def exhausted(self) -> bool:
        """True when the source has ended and no buffered events remain,
        neither here nor queued in the ingest worker. The worker polls
        ahead of the grid, so ``source.exhausted`` can flip while the tail
        chunk still waits in its queue for a later tick; without the queue
        check the session would retire before its tail was fed."""
        src_done = self.source is None or self.source.exhausted
        queued = self._ingest is not None and self._ingest.has_pending(self.sid)
        return src_done and not queued and not self._pending


# ---------------------------------------------------------------------------
# lane surgery over the slot-leading batched tensors (in place)
# ---------------------------------------------------------------------------

def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, (torch.Tensor, SlotSharded)):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _map(fn, tree):
    """``fn`` over every tensor of a tensor / (nested) NamedTuple."""
    if isinstance(tree, (torch.Tensor, SlotSharded)):
        return fn(tree)
    return type(tree)(*(_map(fn, sub) for sub in tree))


def write_lane(batched, single, slot: int):
    """Write ``single`` (same structure, leading axis 1) into lane ``slot``
    of every leaf of ``batched``, in place; returns ``batched``."""
    for b, s in zip(_leaves(batched), _leaves(single)):
        b[slot] = s[0]
    return batched


def read_lane(batched, slot: int):
    """A copy of lane ``slot`` of every leaf, keeping a leading axis of 1
    (the shape ``write_lane`` takes back)."""
    return _map(lambda b: b[slot][None].clone(), batched)


def fresh_lane_state(cfg: SNNConfig, compact: Optional[bool] = None,
                     device="cuda"):
    """A 1-slot initial ``(StreamState, deltas)`` pair (``compact`` picks
    the delta layout; None = the auto choice of ``init_stream_deltas``)."""
    return (init_stream_state(cfg, 1, device=device),
            init_stream_deltas(cfg, 1, device=device, compact=compact))


def reset_lane(state, deltas: torch.Tensor, cfg: SNNConfig, slot: int):
    """Re-initialize lane ``slot`` in place (fresh traces, ``ss_init``
    thresholds, zero delta) — the admit-time lane surgery."""
    write_lane(state, init_stream_state(cfg, 1, device=deltas.device), slot)
    deltas[slot].zero_()
    return state, deltas
