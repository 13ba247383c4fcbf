"""Observability for the port (``repro.obs``): the span tracer
(``obs/trace.py``: the reference's, with device time, the wall clock
(``time.time_ns``, the profiler's) and an active tracer that the LM training
and prefill paths open their spans on), the metrics registry
(``obs/metrics.py``, which the serving telemetry sits on) and exporters
(``obs/export.py``: Prometheus text, a JSONL log, a Chrome trace).

Instrumentation never touches the device computation and adds no
host-device sync: tracing on and off serve and train the same bits.
"""
from .export import (chrome_trace, parse_prometheus_text, prometheus_text,
                     read_jsonl, span_records, write_chrome_trace,
                     write_jsonl)
from .metrics import (LATENCY_BUCKETS_S, RATIO_BUCKETS, Counter, Family,
                      Gauge, Histogram, MetricsRegistry, linear_buckets,
                      log_buckets)
from .trace import NULL_TRACER, Span, Tracer, active, use

__all__ = [
    "Counter", "Family", "Gauge", "Histogram", "LATENCY_BUCKETS_S",
    "MetricsRegistry", "NULL_TRACER", "RATIO_BUCKETS", "Span", "Tracer",
    "active", "chrome_trace", "linear_buckets", "log_buckets", "parse_prometheus_text",
    "prometheus_text", "read_jsonl", "span_records", "write_chrome_trace",
    "use", "write_jsonl",
]
