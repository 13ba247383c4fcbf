"""Asynchronous source ingestion for the serving hot path
(``repro.serving.ingest``).

Polled inline in the stage phase, a source with a real decode cost (an
AER front-end unpacking address events, a codec, a socket read) stalls
the grid step for exactly that long.  :class:`IngestWorker` moves the
polling to a dedicated
daemon thread that drains each source into a bounded per-stream chunk
queue; the stage phase's ``_poll_sources`` becomes a lock-protected
queue drain that only moves already-decoded chunks into session buffers.

**Determinism contract.**  Async ingestion must not change *what* the
grid computes, only *when* the host pays for polling.  Three rules make
the worker bit-identical to the serial path:

* the worker replays the scheduler's virtual clock exactly — it calls
  ``poll(clock_at_tick)`` once per stream per grid tick, in tick order,
  with the clock accumulated ``+= clock_dt_s`` from 0.0 so the float
  sequence matches the serial scheduler's bit for bit (``k * dt`` would
  not);
* queued chunks carry ``(seq, tick)`` stamps; :meth:`drain` releases
  only chunks stamped at or before the grid tick being staged, in
  strictly monotone ``seq`` order (a gap or reorder raises), so a
  session's ``_pending`` buffer receives exactly the chunks — in exactly
  the order — the serial poll would have pushed at that tick;
* if the worker has not yet reached the drained tick for some stream
  (cold start, or it was parked by backpressure), :meth:`drain`
  steal-polls that stream inline under the lock, so the grid never
  observes a late chunk.

**Backpressure.**  The worker polls a stream ahead of the grid only
while its queue holds fewer than ``capacity_chunks`` entries and its
poll tick is within ``lookahead_ticks`` of the published grid tick; a
slow consumer therefore parks the producer instead of growing host
memory.  The queue
itself is an unbounded deque *gated by an explicit capacity check* — a
``deque(maxlen=...)`` would silently drop chunks instead of parking.

The lock is a ``threading.Condition``: every mutation of worker state
happens inside ``with self._lock``, and the worker sleeps on the
condition (with a timeout) when it has nothing to do instead of
spinning.  The worker thread runs numpy and the sources' own code only;
it touches no tensor.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Bounds for the ingest worker.

    ``capacity_chunks``: max decoded chunks queued per stream before the
    worker parks that stream (backpressure; the grid's drain un-parks it).
    ``lookahead_ticks``: how many grid ticks ahead of the published tick
    the worker may poll — bounds both memory and how early a source's
    ``exhausted`` flag can flip (the session's EOS check compensates via
    :meth:`IngestWorker.has_pending`).
    ``idle_wait_s``: condition-wait timeout when fully caught up.
    """
    capacity_chunks: int = 64
    lookahead_ticks: int = 8
    idle_wait_s: float = 0.0005

    def __post_init__(self):
        if self.capacity_chunks < 1:
            raise ValueError("capacity_chunks must be >= 1")
        if self.lookahead_ticks < 1:
            raise ValueError("lookahead_ticks must be >= 1")


class _StreamQueue:
    """Per-stream ingest state: the bounded chunk queue plus the stream's
    private replica of the virtual clock (each stream accumulates its own
    ``+= dt`` sequence from its attach point, so poll clocks are
    bit-identical to the serial scheduler's)."""

    __slots__ = ("session", "chunks", "polled_tick", "clock", "seq",
                 "drained_seq", "peak")

    def __init__(self, session, tick: int, clock: float):
        self.session = session
        self.chunks: Deque[Tuple[int, int, Any]] = deque()  # (seq, tick, chunk)
        self.polled_tick = tick       # last tick this stream was polled for
        self.clock = clock            # virtual clock at polled_tick
        self.seq = 0                  # last sequence stamp issued
        self.drained_seq = 0          # last sequence stamp released to the grid
        self.peak = 0                 # high-water queue depth (backpressure cap)


class IngestWorker:
    """Drains ``StreamSource.poll`` into bounded per-stream chunk queues
    off the grid-step critical path.

    Lifecycle: the scheduler constructs one worker, :meth:`attach`\\ es
    each session at submit, calls :meth:`drain` once per grid tick from
    ``_poll_sources``, :meth:`detach`\\ es sessions as they retire, and
    :meth:`stop`\\ s the worker at :meth:`StreamScheduler.close`.  All
    shared state lives behind one condition lock.
    """

    def __init__(self, clock_dt_s: float,
                 config: Optional[IngestConfig] = None):
        self.cfg = config or IngestConfig()
        self._dt = float(clock_dt_s)
        self._lock = threading.Condition()
        self._streams: Dict[int, _StreamQueue] = {}
        self._tick = 0            # last grid tick published by drain()
        self._clock = 0.0         # virtual clock at _tick (+= dt replica)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._polls = 0           # background polls issued by the worker
        self._steal_polls = 0     # catch-up polls issued inline by drain()
        self._chunks_queued = 0   # chunks decoded into queues, lifetime
        self._queue_peak = 0      # max per-stream queue depth ever seen

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Start the background poll thread (idempotent)."""
        with self._lock:
            if self._thread is not None or self._stop:
                return
            self._thread = threading.Thread(
                target=self._run, name="serving-ingest", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the worker and join its thread (with a timeout); queued
        but undrained chunks are discarded (callers drain through the last
        tick first — ``run_until_drained`` does)."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    def attach(self, session) -> None:
        """Register a session's source for background polling.  The
        stream's poll clock starts at the *published* grid tick, exactly
        where the serial path would first poll a freshly submitted
        session (the next stage phase)."""
        with self._lock:
            if session.sid in self._streams:
                raise ValueError(f"stream {session.sid} already attached")
            self._streams[session.sid] = _StreamQueue(
                session, self._tick, self._clock)
            session._ingest = self
            self._lock.notify_all()
        self.start()

    def detach(self, session) -> None:
        """Unregister a retired session (no-op if never attached).  Its
        queue must already be empty — a retire with queued chunks means
        the EOS discipline broke upstream."""
        with self._lock:
            q = self._streams.pop(session.sid, None)
            session._ingest = None
            if q is not None and q.chunks:
                raise RuntimeError(
                    f"stream {session.sid} detached with {len(q.chunks)} "
                    "undrained chunks — retired before EOS")

    # -- grid-facing API -----------------------------------------------------
    def has_pending(self, sid: int) -> bool:
        """True while the worker holds queued-but-undrained chunks for
        ``sid``.  ``StreamSession.exhausted`` consults this: lookahead
        polling flips ``source.exhausted`` *early*, and without this
        check a session with a queued tail chunk would retire before the
        tail landed."""
        with self._lock:
            q = self._streams.get(sid)
            return q is not None and bool(q.chunks)

    def drain(self, tick: int) -> Tuple[int, int]:
        """Release every queued chunk stamped at or before grid ``tick``
        into its session's buffer; returns ``(chunks_pushed,
        queue_peak)``.  This is the lock-protected queue drain that
        replaced the inline poll loop in ``_poll_sources`` — the only
        ingest work left on the grid-step critical path.

        Publishing ``tick`` also advances the master virtual clock and
        wakes the worker to poll ahead of the new tick.  Streams the
        worker has not caught up to are steal-polled inline so no chunk
        arrives late.  Chunk release asserts monotone, gap-free sequence
        stamps per stream.
        """
        pushed = 0
        with self._lock:
            if self._err is not None:
                raise RuntimeError("ingest worker died") from self._err
            while self._tick < tick:      # replicate the += dt accumulation
                self._tick += 1
                self._clock += self._dt
            for q in self._streams.values():
                while q.polled_tick < tick:
                    self._steal_polls += 1
                    self._poll_one(q)
                while q.chunks and q.chunks[0][1] <= tick:
                    seq, _t, chunk = q.chunks.popleft()
                    if seq != q.drained_seq + 1:
                        raise RuntimeError(
                            f"stream {q.session.sid} sequence gap: "
                            f"expected {q.drained_seq + 1}, got {seq}")
                    q.drained_seq = seq
                    q.session.push_events(chunk)
                    pushed += 1
            peak = self._queue_peak
            self._lock.notify_all()
        return pushed, peak

    def stats(self) -> dict:
        """Lifetime worker stats: background vs steal polls, chunks
        decoded, high-water per-stream queue depth, streams attached now."""
        with self._lock:
            return {"polls": self._polls,
                    "steal_polls": self._steal_polls,
                    "chunks_queued": self._chunks_queued,
                    "queue_peak": self._queue_peak,
                    "attached": len(self._streams)}

    # -- worker internals ----------------------------------------------------
    def _poll_one(self, q: _StreamQueue) -> int:
        """Advance one stream by one grid tick: accumulate its clock
        replica, poll its source once at that clock, stamp and queue the
        resulting chunks.  Caller holds the lock; mutates only ``q``."""
        q.clock += self._dt
        q.polled_tick += 1
        src = q.session.source
        chunks = [] if src is None else src.poll(q.clock)
        for chunk in chunks:
            q.seq += 1
            q.chunks.append((q.seq, q.polled_tick, chunk))
        q.peak = max(q.peak, len(q.chunks))
        return len(chunks)

    def _poll_round(self) -> Tuple[int, int]:
        """One bounded unit of background work: poll each lagging,
        un-parked stream forward by at most one tick.  Caller holds the
        lock; returns ``(polls_issued, chunks_queued)`` so the run loop
        can fold them into ``self`` under the same lock hold."""
        target = self._tick + self.cfg.lookahead_ticks
        polls = queued = 0
        for q in self._streams.values():
            if q.polled_tick >= target:
                continue                       # caught up
            if len(q.chunks) >= self.cfg.capacity_chunks:
                continue                       # parked by backpressure
            polls += 1
            queued += self._poll_one(q)
        return polls, queued

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
                try:
                    polls, queued = self._poll_round()
                except BaseException as e:     # surface at the next drain
                    self._err = e
                    return
                self._polls += polls
                self._chunks_queued += queued
                if self._streams:
                    self._queue_peak = max(
                        self._queue_peak,
                        max(q.peak for q in self._streams.values()))
                if polls == 0:
                    # caught up (or every lagging stream is parked): sleep
                    # until a drain publishes a new tick or capacity frees
                    self._lock.wait(self.cfg.idle_wait_s)
