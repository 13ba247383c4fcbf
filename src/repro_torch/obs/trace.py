"""Zero-dependency span tracing for the serving hot path
(``repro.obs.trace``).

A :class:`Tracer` records *spans* — named wall-time intervals over
``time.perf_counter()`` — into a bounded, thread-safe ring buffer. Spans
nest: each carries a hierarchical ``span_id``/``parent_id`` pair derived
from a per-thread open-span stack, so a Chrome ``trace_event`` dump
reconstructs the call tree per thread.

* **Never touches the device computation.** Spans wrap host phases that
  are already synchronous; the tracer holds no tensors and issues no
  transfers, so tracing on vs. off computes the same numbers.
* **Bounded.** The ring holds at most ``capacity`` finished spans; older
  spans are dropped (and counted in ``n_dropped``).
* **Cheap when off.** A disabled tracer (or the shared :data:`NULL_TRACER`)
  hands back a singleton no-op context manager: no allocation, no lock.

``annotate=True`` additionally enters a ``torch.profiler.record_function``
for every span (the reference enters ``jax.profiler.TraceAnnotation``), so
host phases line up with the device lanes in a ``torch.profiler`` trace.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span (immutable record in the tracer's ring)."""
    name: str
    span_id: int
    parent_id: Optional[int]     # None for a root span
    t0_s: float                  # perf_counter at __enter__
    dur_s: float                 # wall duration
    thread: str                  # recording thread's name
    attrs: Tuple[Tuple[str, Any], ...]   # sorted (key, value) pairs

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
    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_id", "_parent", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._ann = None

    def set(self, **attrs) -> "_SpanCtx":
        """Attach attributes to the open span (e.g. counts known mid-phase)."""
        self._attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanCtx":
        tr = self._tracer
        stack = tr._stack()
        self._parent = stack[-1] if stack else None
        self._id = next(tr._ids)
        stack.append(self._id)
        if tr.annotate and tr._annotation is not None:
            self._ann = tr._annotation(self._name)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        tr._record(Span(
            name=self._name, span_id=self._id, parent_id=self._parent,
            t0_s=self._t0, dur_s=t1 - self._t0,
            thread=threading.current_thread().name,
            attrs=tuple(sorted(self._attrs.items()))))
        return False


class Tracer:
    """Bounded, thread-safe span recorder.

    Args:
      capacity: ring-buffer size in finished spans; the oldest are dropped
        beyond it (``n_dropped`` counts them).
      enabled:  False makes :meth:`span` return a shared no-op context
        manager — the tracer records nothing and costs one attribute read.
      annotate: also wrap each span in ``torch.profiler.record_function``.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True,
                 annotate: bool = False):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.annotate = annotate
        self.n_recorded = 0
        self.n_dropped = 0
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._annotation = None
        if annotate:
            from torch.profiler import record_function
            self._annotation = record_function

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

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.n_dropped += 1
            self._ring.append(span)
            self.n_recorded += 1

    # -- reading -------------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Snapshot of retained spans, oldest first (optionally by name)."""
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


NULL_TRACER = Tracer(capacity=1, enabled=False)
"""Shared disabled tracer: the default for uninstrumented callers. It
never records (``span()`` short-circuits on ``enabled``), so sharing the
instance across schedulers is safe."""
