"""Streaming adapters: ragged, asynchronously-arriving event chunks
(``repro.serving.stream_source``).

Chunk lengths are uniform in [min_chunk, max_chunk], inter-arrival gaps
exponential on a virtual clock, and ``poll(now)`` releases only the chunks
that have arrived by ``now``. Seeded and deterministic: the same seed gives
the same chunks as the reference's sources. ``AERStreamSource`` stores the
same chunks address-event packed and decodes them at ``poll``, so a poll
pays a real decode cost.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..data.events import EventTask


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    min_chunk: int = 4
    max_chunk: int = 16
    mean_gap_s: float = 0.005      # exponential inter-arrival mean
    start_jitter_s: float = 0.01   # uniform offset of the first chunk


class ReplaySource:
    """Deterministic source over a pre-materialized event array."""

    def __init__(self, events: np.ndarray, chunk_len: int = 8):
        self._events = np.asarray(events, np.float32)   # [T_total, n_in]
        self._chunk_len = chunk_len
        self._cursor = 0

    @property
    def exhausted(self) -> bool:
        """True once every replayed timestep has been released."""
        return self._cursor >= self._events.shape[0]

    @property
    def n_timesteps(self) -> int:
        return int(self._events.shape[0])

    def poll(self, now: float) -> List[np.ndarray]:
        """Release the next ``chunk_len`` timesteps (ignores ``now``)."""
        if self.exhausted:
            return []
        end = min(self._cursor + self._chunk_len, self._events.shape[0])
        chunk = self._events[self._cursor:end]
        self._cursor = end
        return [chunk]


class TaskStreamSource:
    """Continuous stream over an ``EventTask``: windows back-to-back, cut
    into ragged chunks with Poisson arrivals on a virtual clock."""

    def __init__(self, task: EventTask, n_windows: int, seed: int = 0,
                 arrival: ArrivalConfig | None = None):
        self.task = task
        self.arrival = arrival or ArrivalConfig()
        rng = np.random.default_rng(seed)
        windows, labels = zip(*task.sample_stream(rng, n_windows))
        stream = np.concatenate(windows, axis=0)           # [W*T, n_in]
        self.labels = np.asarray(labels, np.int32)         # [W] per-window
        self._chunks: List[Tuple[float, np.ndarray]] = []
        t = float(rng.uniform(0.0, self.arrival.start_jitter_s))
        cursor = 0
        while cursor < stream.shape[0]:
            c = int(rng.integers(self.arrival.min_chunk,
                                 self.arrival.max_chunk + 1))
            self._chunks.append((t, stream[cursor:cursor + c]))
            cursor += c
            t += float(rng.exponential(self.arrival.mean_gap_s))
        self._next = 0

    @property
    def exhausted(self) -> bool:
        """True once every pre-cut chunk has arrived and been polled."""
        return self._next >= len(self._chunks)

    @property
    def n_timesteps(self) -> int:
        return sum(c.shape[0] for _, c in self._chunks)

    def poll(self, now: float) -> List[np.ndarray]:
        """Chunks whose arrival time is <= ``now`` (virtual seconds)."""
        out = []
        while (self._next < len(self._chunks)
               and self._chunks[self._next][0] <= now):
            out.append(self._chunks[self._next][1])
            self._next += 1
        return out


# ---------------------------------------------------------------------------
# address-event representation (AER): packed chunks with a real decode cost
# ---------------------------------------------------------------------------

def aer_encode(chunk: np.ndarray):
    """Pack a dense ``[c, n_in]`` binary spike chunk as address events:
    ``(c, n_in, t_idx, k_idx)``, one ``(t, k)`` pair per nonzero entry."""
    t, k = np.nonzero(chunk)
    return (int(chunk.shape[0]), int(chunk.shape[1]),
            t.astype(np.int32), k.astype(np.int32))


def aer_decode(c: int, n_in: int, t: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Densify one AER-packed chunk back to ``[c, n_in]`` f32 spikes."""
    out = np.zeros((c, n_in), np.float32)
    out[t, k] = 1.0
    return out


class AERStreamSource:
    """A :class:`TaskStreamSource` whose chunks are stored address-event
    packed and densified at ``poll`` time: the same arrival schedule, chunk
    cuts and labels, poll for poll, plus a decode per chunk. Spikes are
    binary, so the round trip is exact."""

    def __init__(self, task: EventTask, n_windows: int, seed: int = 0,
                 arrival: ArrivalConfig | None = None):
        inner = TaskStreamSource(task, n_windows, seed=seed, arrival=arrival)
        self.labels = inner.labels
        self._packed = [(t, aer_encode(c)) for t, c in inner._chunks]
        self._next = 0

    @property
    def exhausted(self) -> bool:
        """True once every packed chunk has arrived and been polled."""
        return self._next >= len(self._packed)

    @property
    def n_timesteps(self) -> int:
        return sum(c for _, (c, _n, _t, _k) in self._packed)

    def poll(self, now: float) -> List[np.ndarray]:
        """Densified chunks whose arrival time is <= ``now``."""
        out = []
        while (self._next < len(self._packed)
               and self._packed[self._next][0] <= now):
            out.append(aer_decode(*self._packed[self._next][1]))
            self._next += 1
        return out
