"""Labeled metrics registry: counters, gauges, fixed-bucket histograms.

Prometheus-shaped but dependency-free: a :class:`MetricsRegistry` holds
metric *families* (one name + help + kind + label names), each family
holds one child per label-value combination, and ``obs.export`` renders
the whole registry as Prometheus text exposition or a JSON snapshot.

The histogram is the load-bearing piece: it replaces the serving
telemetry's old unbounded ``step_latencies_s`` list. Buckets are fixed at
construction (log-spaced by default), so memory is **O(buckets), not
O(observations)**, while ``sum``/``count`` stay exact and
:meth:`Histogram.percentile` recovers p50/p99 by linear interpolation
inside the owning bucket — within one bucket's relative width of the
exact value (``tests/test_obs.py`` pins the tolerance; the default
latency buckets are spaced ~10% apart).

Counters are monotone *by construction*: a negative increment raises
instead of silently un-counting — the property the CI Prometheus smoke
scrapes for.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def log_buckets(lo: float, hi: float, per_decade: int = 24) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds covering ``[lo, hi]``.

    ``per_decade=24`` gives ~10% spacing — the percentile-estimate
    relative-error bound for values inside the covered range.
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


def linear_buckets(lo: float, hi: float, n: int) -> Tuple[float, ...]:
    """``n`` evenly spaced bucket upper bounds ending at ``hi``."""
    if n < 1 or not hi > lo:
        raise ValueError(f"need n >= 1 and hi > lo, got ({lo}, {hi}, {n})")
    w = (hi - lo) / n
    return tuple(lo + w * (i + 1) for i in range(n))


# step()/phase latencies: 1 µs .. 60 s at ~10% spacing (188 buckets)
LATENCY_BUCKETS_S = log_buckets(1e-6, 60.0, per_decade=24)
# per-step host/device overlap ratio lives in [0, 1]
RATIO_BUCKETS = linear_buckets(0.0, 1.0, 50)
# bounded-queue occupancy (e.g. chunks drained per ingest poll window);
# capacities are small integers, so 4-wide linear buckets to 128 suffice
QUEUE_DEPTH_BUCKETS = linear_buckets(0.0, 128.0, 32)


class Counter:
    """Monotone child: ``inc`` of a negative amount raises."""
    __slots__ = ("_value", "_lock")
    kind = "counter"

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increments must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Set-to-current-value child (the one non-monotone kind)."""
    __slots__ = ("_value", "_lock")
    kind = "gauge"

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket child: O(buckets) memory, exact sum/count, interpolated
    percentiles. ``buckets`` are increasing upper bounds; observations above
    the last land in the implicit +inf bucket (reported at the last finite
    bound by :meth:`percentile` — widen the buckets if that matters)."""
    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock")
    kind = "histogram"

    def __init__(self, buckets: Sequence[float]):
        b = tuple(float(x) for x in buckets)
        if not b or any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)       # +1: the +inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        lo, hi = 0, len(self.buckets)
        while lo < hi:                           # first bucket with v <= ub
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def bucket_counts(self) -> List[int]:
        """Per-bucket counts (last entry is the +inf overflow bucket)."""
        with self._lock:
            return list(self._counts)

    def percentile(self, q: float) -> float:
        """Estimated ``q``-th percentile (0..100), linearly interpolated
        inside the owning bucket; 0.0 with no observations."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):       # overflow bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                frac = (rank - cum) / c
                return lo + (self.buckets[i] - lo) * frac
            cum += c
        return self.buckets[-1]


class Family:
    """One metric name: a child per label-value tuple (created on use)."""

    def __init__(self, name: str, help: str, kind: str,
                 labelnames: Tuple[str, ...], make_child):
        self.name, self.help, self.kind = name, help, kind
        self.labelnames = labelnames
        self._make_child = make_child
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **labelvalues):
        """The child for this label-value combination."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                # one child per label set (standard Prometheus semantics);
                # lint: ok OBS01 — label cardinality is caller-bounded
                child = self._children[key] = self._make_child()
        return child

    def samples(self) -> List[Tuple[Tuple[str, ...], object]]:
        """[(label_values, child)] sorted by label values."""
        with self._lock:
            return sorted(self._children.items())

    # label-less families proxy straight to their single child
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled {self.labelnames}; "
                             "use .labels(...)")
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def value(self) -> float:
        return self._solo().value

    def percentile(self, q: float) -> float:
        return self._solo().percentile(q)

    @property
    def sum(self) -> float:
        return self._solo().sum

    @property
    def count(self) -> int:
        return self._solo().count

    def total(self) -> float:
        """Sum of all children's values (counters/gauges)."""
        return sum(c.value for _, c in self.samples())


class MetricsRegistry:
    """Create-or-get metric families; the unit ``obs.export`` renders.

    Getting an existing name validates kind/labels match — two subsystems
    can share a registry without silently shadowing each other's metrics.
    """

    def __init__(self):
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, help: str, kind: str,
                labels: Sequence[str], make_child) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                # families are code-defined (one per metric name in source);
                # lint: ok OBS01 — the registry cannot grow unbounded
                fam = self._families[name] = Family(
                    name, help, kind, labels, make_child)
                if not labels:
                    # Prometheus convention: a label-less metric exists at
                    # 0 from registration, so scrapes see it before first
                    # use (rates/absence alerts work from step one)
                    fam.labels()
            elif fam.kind != kind or fam.labelnames != labels:
                raise ValueError(
                    f"metric {name} already registered as {fam.kind}"
                    f"{fam.labelnames}, not {kind}{labels}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._family(name, help, "counter", labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._family(name, help, "gauge", labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Family:
        b = tuple(buckets) if buckets is not None else LATENCY_BUCKETS_S
        return self._family(name, help, "histogram", labels,
                            lambda: Histogram(b))

    def collect(self) -> List[Family]:
        """All families, name-sorted (the exporters' iteration order)."""
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)

    def snapshot(self) -> dict:
        """JSON-able dump: per family, kind/help and every child's value
        (histograms as count/sum/p50/p99 — the artifact form, not the
        full bucket vector)."""
        out = {}
        for fam in self.collect():
            samples = []
            for values, child in fam.samples():
                rec = {"labels": dict(zip(fam.labelnames, values))}
                if fam.kind == "histogram":
                    rec.update(count=child.count, sum=child.sum,
                               p50=child.percentile(50),
                               p99=child.percentile(99))
                else:
                    rec["value"] = child.value
                samples.append(rec)
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "samples": samples}
        return out
