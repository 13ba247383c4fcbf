"""Span tracing for the serving hot path and the LM training and prefill
paths (``repro.obs.trace``).

A :class:`Tracer` records *spans* — named intervals stamped on the wall
clock (``time.time_ns``, the clock ``torch.profiler`` stamps its device
events with, so spans and device events share one timeline) — into a
bounded, thread-safe ring buffer. Spans nest: each carries a hierarchical
``span_id``/``parent_id`` pair derived from a per-thread open-span stack,
so a Chrome ``trace_event`` dump reconstructs the call tree per thread.

* **Never synchronises the device.** On a tracer with ``device_time=True``
  every span records one timing ``torch.cuda.Event`` on the current stream
  at enter and one at exit, nothing more; a 0-d tensor attribute is kept as
  it is. Both become numbers when the spans are read
  (:meth:`Tracer.spans`), which the caller does after its own synchronise:
  tracing on vs. off computes the same numbers. ``device_s`` is the
  stream's elapsed time between the two events, not the time its kernels
  were busy: where the stream runs dry inside a span (the host enqueues
  slower than the card runs, as in a step entered on an idle stream), the
  wait counts as the span's.
* **Ambient.** :func:`use` makes a tracer the process's active one (for
  every thread: autograd's backward threads record too) and :func:`active`
  returns it, or :data:`NULL_TRACER` when none is set; the model and step
  code open their spans on ``active()``.
* **Bounded.** The ring holds at most ``capacity`` finished spans; older
  spans are dropped (and counted in ``n_dropped``).
* **Cheap when off.** A disabled tracer (or the shared :data:`NULL_TRACER`)
  hands back a singleton no-op context manager: no span, no event, no lock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span (immutable record in the tracer's ring)."""
    name: str
    span_id: int
    parent_id: Optional[int]     # None for a root span
    t0_s: float                  # wall clock (time.time_ns) at __enter__, s
    dur_s: float                 # host duration (time.perf_counter_ns)
    thread: str                  # recording thread's name
    attrs: Tuple[Tuple[str, Any], ...]   # sorted (key, value) pairs
    device_s: Optional[float] = None     # stream's time between the events

    def attr(self, key: str, default=None):
        """Value of attribute ``key`` (spans store attrs as sorted pairs)."""
        for k, v in self.attrs:
            if k == key:
                return v
        return default


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """An open span: context manager that records into its tracer on exit."""
    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_c0", "_id",
                 "_parent", "_ev0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._ev0 = tracer._event(enable_timing=True) \
            if tracer._event is not None else None

    def set(self, **attrs) -> "_SpanCtx":
        """Attach attributes to the open span (e.g. counts known mid-phase;
        a 0-d tensor is read when the spans are)."""
        self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanCtx":
        tr = self._tracer
        stack = tr._stack()
        self._parent = stack[-1] if stack else None
        self._id = next(tr._ids)
        stack.append(self._id)
        if self._ev0 is not None:
            self._ev0.record()
        self._t0 = time.time_ns()
        self._c0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        c1 = time.perf_counter_ns()
        ev1 = None
        if self._ev0 is not None:
            ev1 = self._tracer._event(enable_timing=True)
            ev1.record()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        span = Span(name=self._name, span_id=self._id, parent_id=self._parent,
                    t0_s=self._t0 * 1e-9, dur_s=(c1 - self._c0) * 1e-9,
                    thread=threading.current_thread().name,
                    attrs=tuple(sorted(self._attrs.items())))
        tr._record((span, self._ev0, ev1))
        return False


def _resolved(span: Span, ev0, ev1) -> Span:
    """A ring entry (the span, its events or None) as a finished
    :class:`Span`: the stream's time between the events and the tensor
    attributes read as floats. An event the device has not reached raises
    (``cudaErrorNotReady``)."""
    torch = sys.modules.get("torch")     # a tensor attribute imported it
    tensor = torch.Tensor if torch is not None else ()
    dev = None if ev0 is None else ev0.elapsed_time(ev1) * 1e-3
    if dev is None and not any(isinstance(v, tensor) for _, v in span.attrs):
        return span
    attrs = tuple((k, float(v) if isinstance(v, tensor) else v)
                  for k, v in span.attrs)
    return dataclasses.replace(span, attrs=attrs, device_s=dev)


class Tracer:
    """Bounded, thread-safe span recorder.

    Args:
      capacity:    ring-buffer size in finished spans; the oldest are
        dropped beyond it (``n_dropped`` counts them).
      enabled:     False makes :meth:`span` return a shared no-op context
        manager — the tracer records nothing and costs one attribute read.
      device_time: every span records a CUDA event pair on the current
        stream (where CUDA is available) and carries ``device_s`` once
        read.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True,
                 device_time: bool = False):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._event = None
        if device_time:
            import torch
            if torch.cuda.is_available():
                self._event = torch.cuda.Event
        self.device_time = self._event is not None
        self.n_recorded = 0
        self.n_dropped = 0
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        """Context manager timing one named interval; nests hierarchically.

        ``attrs`` become the span's attributes (more via ``.set(...)``).
        """
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, attrs)

    def _record(self, entry) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.n_dropped += 1
            self._ring.append(entry)
            self.n_recorded += 1

    # -- reading -------------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Snapshot of retained spans, oldest first (optionally by name).
        Device times and tensor attributes are read here: call it after the
        device has finished the traced work."""
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [e for e in out if e[0].name == name]
        return [_resolved(*e) for e in out]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


NULL_TRACER = Tracer(capacity=1, enabled=False)
"""Shared disabled tracer: the default for uninstrumented callers. It
never records (``span()`` short-circuits on ``enabled``), so sharing the
instance across schedulers is safe."""

_ACTIVE: Tracer = NULL_TRACER


def active() -> Tracer:
    """The process's active tracer (:func:`use`), or :data:`NULL_TRACER`."""
    return _ACTIVE


@contextlib.contextmanager
def use(tracer: Tracer) -> Iterator[Tracer]:
    """Make ``tracer`` the active one for every thread of the process
    until the block ends (the one before it then returns)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev
