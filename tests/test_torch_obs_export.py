"""The port's observability layer against the reference's, and its exporters.

Against the reference (both are host-only Python over the same registry
and span records, so no tolerance): the same sequence of registry
operations scrapes to the same Prometheus text byte for byte, parses back
to the same samples and snapshots to the same dict; the same spans give
the same JSONL records and Chrome trace structure. Within the port: the
JSONL log round trips, the Chrome trace nests and orders its events, and
label values are escaped.
"""
import json

import numpy as np
import pytest

from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Span as JSpan
from repro.obs import chrome_trace as jchrome_trace
from repro.obs import prometheus_text as jprometheus_text
from repro.obs import span_records as jspan_records
from repro_torch.obs import (MetricsRegistry, Span, Tracer, chrome_trace,
                             parse_prometheus_text, prometheus_text,
                             read_jsonl, span_records, write_chrome_trace,
                             write_jsonl)
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, RATIO_BUCKETS


def _registry_ops(reg, seed):
    """One seeded sequence of registry operations: labelled counters,
    gauges, histograms on the serving buckets, unlabelled families."""
    rng = np.random.default_rng(seed)
    c = reg.counter("serving_stream_events_in_total", "input spikes",
                    labels=("sid",))
    g = reg.gauge("serving_pipeline_depth", "depth")
    h = reg.histogram("serving_phase_seconds", "phase wall",
                      labels=("phase",), buckets=LATENCY_BUCKETS_S)
    r = reg.histogram("serving_overlap_ratio", "overlap",
                      buckets=RATIO_BUCKETS)
    steps = reg.counter("serving_grid_steps_total", "steps")
    for i in range(int(rng.integers(20, 60))):
        c.labels(sid=str(int(rng.integers(0, 5)))).inc(
            float(rng.integers(0, 40)) if i % 3 else float(rng.random()))
        g.set(float(rng.integers(0, 4)))
        h.labels(phase=("stage", "dispatch", "retire")[i % 3]).observe(
            float(np.exp(rng.normal(np.log(3e-3), 1.0))))
        r.observe(float(rng.random()))
        steps.inc()
    reg.counter("escaped_total", 'help with "quotes"\nand a newline',
                labels=("p",)).labels(p='a"b\\c\nd').inc(2)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_equals_reference_byte_for_byte(seed):
    port = _registry_ops(MetricsRegistry(), seed)
    ref = _registry_ops(JMetricsRegistry(), seed)
    text = prometheus_text(port)
    assert text == jprometheus_text(ref)
    parsed = parse_prometheus_text(text)
    assert parsed["serving_grid_steps_total"] == \
        ref.get("serving_grid_steps_total").value
    assert parsed['escaped_total{p="a\\"b\\\\c\\nd"}'] == 2.0
    assert port.snapshot() == ref.snapshot()
    json.dumps(port.snapshot())


def test_prometheus_text_golden():
    """The reference's golden (tests/test_obs.py), through the port."""
    reg = MetricsRegistry()
    c = reg.counter("events_total", "events seen", labels=("sid",))
    c.labels(sid="0").inc(3)
    c.labels(sid="1").inc(1.5)
    reg.gauge("depth", "queue depth").set(2)
    reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0)).observe(0.05)
    reg.histogram("lat_seconds").observe(10.0)
    golden = "\n".join([
        '# HELP depth queue depth',
        '# TYPE depth gauge',
        'depth 2',
        '# HELP events_total events seen',
        '# TYPE events_total counter',
        'events_total{sid="0"} 3',
        'events_total{sid="1"} 1.5',
        '# HELP lat_seconds latency',
        '# TYPE lat_seconds histogram',
        'lat_seconds_bucket{le="0.1"} 1',
        'lat_seconds_bucket{le="1"} 1',
        'lat_seconds_bucket{le="+Inf"} 2',
        'lat_seconds_sum 10.05',
        'lat_seconds_count 2',
    ]) + "\n"
    assert prometheus_text(reg) == golden
    parsed = parse_prometheus_text(golden)
    assert parsed['events_total{sid="0"}'] == 3.0
    assert parsed['lat_seconds_bucket{le="+Inf"}'] == 2.0


def _spans(cls):
    """A small fixed span tree, two threads, as either package's Span."""
    return [
        cls("sched.stage", 2, 1, 10.001, 0.002, "MainThread",
            (("grid_step", 1), ("tier", "default"))),
        cls("sched.step", 1, None, 10.0, 0.01, "MainThread",
            (("grid_step", 1),)),
        cls("autopilot.decision", 3, None, 10.02, 0.0001, "serving-ingest",
            (("action", "probe"), ("ema", 0.25))),
    ]


def test_span_records_and_chrome_trace_equal_reference():
    assert span_records(_spans(Span)) == jspan_records(_spans(JSpan))
    assert chrome_trace(_spans(Span), pid=3) == \
        jchrome_trace(_spans(JSpan), pid=3)


def test_chrome_trace_structure(tmp_path):
    tr = Tracer()
    with tr.span("step", grid_step=1):
        with tr.span("stage"):
            pass
    doc = chrome_trace(tr)
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    xs = {e["name"]: e for e in events if e["ph"] == "X"}
    assert len(meta) == 1 and meta[0]["name"] == "thread_name"
    assert set(xs) == {"step", "stage"}
    step, stage = xs["step"], xs["stage"]
    assert step["args"]["grid_step"] == 1
    assert stage["args"]["parent_id"] == step["args"]["span_id"]
    assert step["ts"] == 0.0 and stage["ts"] >= 0.0
    assert stage["ts"] + stage["dur"] <= step["ts"] + step["dur"] + 1e-3
    path = str(tmp_path / "trace.json")
    write_chrome_trace(path, tr)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(doc))


def test_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "log.jsonl")
    tr = Tracer()
    with tr.span("stage", grid_step=3):
        pass
    n = write_jsonl(path, span_records(tr.spans()))
    n += write_jsonl(path, [{"kind": "rollup", "events_per_s": 10.0}])
    assert n == 2
    recs = read_jsonl(path)
    assert len(recs) == 2
    assert recs[0]["kind"] == "span" and recs[0]["name"] == "stage"
    assert recs[0]["grid_step"] == 3 and recs[0]["dur_s"] >= 0.0
    assert recs[1] == {"kind": "rollup", "events_per_s": 10.0}
    write_jsonl(path, [{"a": 1}], append=False)         # truncates
    assert read_jsonl(path) == [{"a": 1}]
    with open(path, "a") as f:                          # a caller's handle
        assert write_jsonl(f, [{"b": 2}]) == 1
    assert read_jsonl(path) == [{"a": 1}, {"b": 2}]
