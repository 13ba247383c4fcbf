"""Exporters: Prometheus text exposition, JSONL event log, Chrome trace
(``repro.obs.export``).

Three read-only views over the same in-process state:

* :func:`prometheus_text` renders a :class:`~.metrics.MetricsRegistry`
  in the Prometheus text exposition format (``# HELP``/``# TYPE`` headers,
  ``name{label="v"} value`` samples, histograms as cumulative
  ``_bucket{le=...}`` + ``_sum`` + ``_count``) — scrape it from a debug
  endpoint or dump it after a run.
* :func:`write_jsonl` / :func:`span_records` append structured events —
  one JSON object per line — the greppable long-term log.
* :func:`chrome_trace` converts tracer spans into the Chrome
  ``trace_event`` JSON format: load the file at ``chrome://tracing`` or
  https://ui.perfetto.dev to see stage/dispatch/retire lanes per thread,
  pipelined steps overlapping, and topology epochs as long blocks.

All three are pure functions of already-recorded state: exporting never
synchronises the card, so it is safe at any point of a serving run (a span
with device time is read once the card has passed its end event:
``Tracer.spans``).
"""
from __future__ import annotations

import json
from typing import IO, Iterable, List, Sequence, Union

from .metrics import MetricsRegistry
from .trace import Span, Tracer


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render without exponent."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return f"{int(f)}"
    return repr(f)


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelstr(names: Sequence[str], values: Sequence[str],
              extra: Sequence[tuple] = ()) -> str:
    pairs = [f'{n}="{_esc(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_esc(str(v))}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def prometheus_text(registry: MetricsRegistry) -> str:
    """The registry in Prometheus text exposition format (one scrape)."""
    lines: List[str] = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_esc(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for values, child in fam.samples():
            if fam.kind == "histogram":
                cum = 0
                counts = child.bucket_counts()
                for ub, c in zip(child.buckets, counts):
                    cum += c
                    le = _labelstr(fam.labelnames, values, [("le", _fmt(ub))])
                    lines.append(f"{fam.name}_bucket{le} {cum}")
                cum += counts[-1]
                le = _labelstr(fam.labelnames, values, [("le", "+Inf")])
                lines.append(f"{fam.name}_bucket{le} {cum}")
                ls = _labelstr(fam.labelnames, values)
                lines.append(f"{fam.name}_sum{ls} {_fmt(child.sum)}")
                lines.append(f"{fam.name}_count{ls} {child.count}")
            else:
                ls = _labelstr(fam.labelnames, values)
                lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """``{sample_name_with_labels: value}`` from one text scrape — the
    minimal parser the monotonicity smoke (and tests) diff scrapes with."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out


# -- JSONL -------------------------------------------------------------------

def _device(s: Span) -> dict:
    return {} if s.device_s is None else {"device_s": s.device_s}


def span_records(spans: Iterable[Span]) -> List[dict]:
    """Spans as flat JSON-able dicts (the JSONL form of the trace), with
    ``device_s`` where the span has a device time."""
    return [{
        "kind": "span", "name": s.name, "span_id": s.span_id,
        "parent_id": s.parent_id, "t0_s": s.t0_s, "dur_s": s.dur_s,
        "thread": s.thread, **_device(s), **dict(s.attrs),
    } for s in spans]


def write_jsonl(path_or_file: Union[str, IO], records: Iterable[dict],
                append: bool = True) -> int:
    """Write one JSON object per line; returns the number written.

    ``append=True`` (default) lets successive runs accumulate into one
    log; pass a file object to control the handle yourself.
    """
    n = 0
    if hasattr(path_or_file, "write"):
        f, close = path_or_file, False
    else:
        f, close = open(path_or_file, "a" if append else "w"), True
    try:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            n += 1
    finally:
        if close:
            f.close()
    return n


def read_jsonl(path: str) -> List[dict]:
    """Load every record of a JSONL log (the test/analysis helper)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- Chrome trace_event ------------------------------------------------------

def chrome_trace(spans_or_tracer: Union[Tracer, Iterable[Span]],
                 pid: int = 0) -> dict:
    """Spans as a Chrome ``trace_event`` document (complete ``"X"`` events).

    Timestamps are microseconds relative to the earliest span, one trace
    row (tid) per recording thread, span attributes (and ``device_s``
    where set) under ``args`` —
    open the JSON at ``chrome://tracing`` / ui.perfetto.dev.
    """
    spans = (spans_or_tracer.spans()
             if isinstance(spans_or_tracer, Tracer) else list(spans_or_tracer))
    t_base = min((s.t0_s for s in spans), default=0.0)
    tids = {}
    events: List[dict] = []
    for s in spans:
        tid = tids.setdefault(s.thread, len(tids))
        events.append({
            "name": s.name, "ph": "X", "pid": pid, "tid": tid,
            "ts": (s.t0_s - t_base) * 1e6, "dur": s.dur_s * 1e6,
            "args": {**dict(s.attrs), **_device(s), "span_id": s.span_id,
                     "parent_id": s.parent_id},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": thread}} for thread, tid in tids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       spans_or_tracer: Union[Tracer, Iterable[Span]],
                       pid: int = 0) -> None:
    """Dump :func:`chrome_trace` to ``path`` (a ``.json`` timeline file)."""
    with open(path, "w") as f:
        json.dump(chrome_trace(spans_or_tracer, pid=pid), f)
