"""The traced window: ``torch.profiler`` (device activity only, so that
the host's pace is not the profiler's) over a few whole steps (or
cycles), the benchmark's own host spans around its calls (``Spans``, on
the profiler's wall clock), and the reduction of that trace to what the
per-layer readers take: device busy time as the union of the device
operations' intervals, idle gaps named by the host span they fell in,
device time by kernel and by class."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

Interval = Tuple[str, float, float]         # (name, start s, end s)


def kernel_class(name: str) -> str:
    """``gemm`` (cuBLAS / CUTLASS), ``flash`` (the port's attention
    kernels) or ``other`` (elementwise, reductions, copies and the rest)."""
    if name.startswith("nvjet") or "gemm" in name or "cutlass" in name:
        return "gemm"
    return "flash" if "flash_" in name else "other"


@dataclasses.dataclass
class Trace:
    device: List[Interval]      # device operations, in the window
    spans: List[Interval]       # the benchmark's host spans
    window: Tuple[float, float]  # the traced window on the trace's clock
    window_s: float             # the window by the host's clock


class Spans:
    """The benchmark's host spans (``bench.copy``, ``bench.step``,
    ``bench.read``), kept only while a trace records: name, start and end
    in seconds of the wall clock that the profiler stamps its events
    with."""

    def __init__(self):
        self.on, self.items = False, []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0 * 1e-9, time.time_ns() * 1e-9))


def device_events(prof, kind: str = "CUDA") -> List[Interval]:
    """(name, start s, end s) of every operation of the trace on devices
    of ``kind`` (the card's; ``CPU`` in the tests), from the profiler's
    Kineto events, which are stamped in ns on the wall clock."""
    from torch.autograd import DeviceType
    want = getattr(DeviceType, kind)
    return [(e.name(), e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == want]


def clip(raw: List[Interval], spans: List[Interval], w0: float,
         wall: float) -> Trace:
    """The device operations of ``raw`` cut to the window that starts at
    ``w0`` on the wall clock and lasts ``wall`` seconds. A trace whose
    clock does not match the host's (most operations outside the window)
    is refused: the idle share would not be the window's."""
    if not raw:
        raise RuntimeError("the profiler recorded no device operation")
    w1 = w0 + wall
    inside = sum(1 for _, a, b in raw if a >= w0 and b <= w1 + 1e-3)
    if inside < len(raw) / 2:
        raise RuntimeError(
            f"only {inside} of {len(raw)} device operations fall in the "
            "host's window: the profiler's clock is not the host's")
    device = [(n, max(a, w0), min(b, w1)) for n, a, b in raw
              if b > w0 and a < w1]
    return Trace(device, list(spans), (w0, w1), wall)


def record(torch, fn: Callable[[], None], spans: Spans) -> Trace:
    """Trace one call of ``fn`` (whole steps; the device synchronised
    here after it)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    spans.items, spans.on = [], True
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0, t0 = time.time_ns() * 1e-9, time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        spans.on = False
    return clip(device_events(prof), spans.items, w0, wall)


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in merged([(a, b) for _, a, b in trace.device]))


def span_at(trace: Trace, t: float) -> str:
    """The innermost benchmark span the host was in at ``t``."""
    best: Optional[Interval] = None
    for s in trace.spans:
        if s[1] <= t < s[2] and (best is None or s[1] >= best[1]):
            best = s
    return best[0] if best else "bench.window"


def idle_gaps(trace: Trace) -> List[Tuple[str, float]]:
    """Every stretch of the window with nothing on the device, longest
    first, named by what the host was doing when it began."""
    w0, w1 = trace.window
    cur, gaps = w0, []
    for a, b in merged([(a, b) for _, a, b in trace.device]) + [(w1, w1)]:
        if a > cur:
            gaps.append((span_at(trace, cur), a - cur))
        cur = max(cur, b)
    return sorted(gaps, key=lambda g: -g[1])


def by_name(trace: Trace) -> Dict[str, Tuple[float, int]]:
    out: Dict[str, Tuple[float, int]] = {}
    for n, a, b in trace.device:
        s, c = out.get(n, (0.0, 0))
        out[n] = (s + b - a, c + 1)
    return out


def by_class(trace: Trace) -> Dict[str, float]:
    out = {"gemm": 0.0, "flash": 0.0, "other": 0.0}
    for n, a, b in trace.device:
        out[kernel_class(n)] += b - a
    return out


def breakdown(trace: Trace, n: int = 10) -> Dict[str, list]:
    ops = sorted(by_name(trace).items(), key=lambda kv: -kv[1][0])[:n]
    return {"device_ops": [[k[:120], v[0]] for k, v in ops],
            "idle_gaps": [[name, s] for name, s in idle_gaps(trace)[:n]]}
