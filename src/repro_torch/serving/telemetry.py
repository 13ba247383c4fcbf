"""Per-stream and fleet-level serving telemetry (``repro.serving.telemetry``).

The counters and rollup the port's single-tier scheduler uses, on the
port's own copy of the metrics registry. Per-stream counters are monotone
(a negative increment raises) and separable (a slot's counters only get
that slot's lane of the chunk metrics); step and phase wall times land in
bounded fixed-bucket histograms; the host/device overlap ratio is
``hidden / (hidden + wait)`` per retired step. Tier, topology, ingest and
pipeline-depth families come with those scheduler features.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..core.energy import OperatingPoint, report
from ..obs.metrics import LATENCY_BUCKETS_S, RATIO_BUCKETS, MetricsRegistry

# every per-stream counter family: attribute name -> (metric name, help)
STREAM_COUNTER_FAMILIES = {
    "timesteps": ("serving_stream_timesteps_total",
                  "valid timesteps advanced"),
    "events_in": ("serving_stream_events_in_total",
                  "input spikes consumed"),
    "sop_forward": ("serving_stream_sop_forward_total",
                    "forward synaptic ops"),
    "sop_wu": ("serving_stream_sop_wu_total",
               "weight-update MACs actually paid"),
    "sop_wu_offered": ("serving_stream_sop_wu_offered_total",
                       "weight-update MACs offered to the gate"),
    "gate_opened": ("serving_stream_gate_opened_total",
                    "gate-open decisions"),
    "gate_offered": ("serving_stream_gate_offered_total",
                     "gate decisions offered"),
    "windows": ("serving_stream_windows_total",
                "completed T-step windows (predictions)"),
}

# cumulative but NOT monotone (a local loss can be negative) — gauge-backed
STREAM_GAUGE_FAMILIES = {
    "local_loss": ("serving_stream_local_loss_sum",
                   "summed local OSSL loss"),
}

class StreamCounters:
    """Monotone per-stream event counters (energy-model inputs): a view
    over one ``sid``'s children of the registry's labeled families."""

    def __init__(self, sid: int, registry: Optional[MetricsRegistry] = None):
        self.sid = sid
        registry = registry or MetricsRegistry()
        self._c = {
            attr: registry.counter(name, help, labels=("sid",))
                          .labels(sid=str(sid))
            for attr, (name, help) in STREAM_COUNTER_FAMILIES.items()}
        self._c.update({
            attr: registry.gauge(name, help, labels=("sid",))
                          .labels(sid=str(sid))
            for attr, (name, help) in STREAM_GAUGE_FAMILIES.items()})

    def __getattr__(self, attr):
        try:
            child = self.__dict__["_c"][attr]
        except KeyError:
            raise AttributeError(attr) from None
        return int(child.value) if attr == "windows" else child.value

    def add_chunk(self, *, steps, events_in, sop_forward, sop_wu,
                  sop_wu_offered, gate_opened, gate_offered, windows,
                  local_loss) -> None:
        """Fold one grid step's slice of the chunk metrics into this
        stream's counters (a negative quantity raises)."""
        self._c["timesteps"].inc(float(steps))
        self._c["events_in"].inc(float(events_in))
        self._c["sop_forward"].inc(float(sop_forward))
        self._c["sop_wu"].inc(float(sop_wu))
        self._c["sop_wu_offered"].inc(float(sop_wu_offered))
        self._c["gate_opened"].inc(float(gate_opened))
        self._c["gate_offered"].inc(float(gate_offered))
        self._c["windows"].inc(int(windows))
        self._c["local_loss"].inc(float(local_loss))

    @property
    def wu_skip_rate(self) -> float:
        """Fraction of offered WU MACs the activity gate skipped."""
        if self.sop_wu_offered <= 0:
            return 0.0
        return 1.0 - self.sop_wu / self.sop_wu_offered

    def energy(self, op: Optional[OperatingPoint] = None) -> dict:
        """This stream's counters priced at operating point ``op``."""
        rep = report(self.sop_forward, self.sop_wu, self.sop_wu_offered,
                     self.timesteps, op=op)
        out = rep.as_dict()
        out["sid"] = self.sid
        out["timesteps"] = self.timesteps
        out["windows"] = self.windows
        return out


class FleetTelemetry:
    """Rollup across streams + host-side step/phase latency + overlap."""

    def __init__(self, op: Optional[OperatingPoint] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.op = op or OperatingPoint.low_power()
        self.registry = registry or MetricsRegistry()
        self.streams: Dict[int, StreamCounters] = {}
        self._lock = threading.Lock()
        self._steps = self.registry.counter(
            "serving_grid_steps_total", "scheduler grid steps dispatched")
        self._step_hist = self.registry.histogram(
            "serving_step_latency_seconds",
            "host wall time of one StreamScheduler.step() call",
            buckets=LATENCY_BUCKETS_S)
        self._phase_hist = self.registry.histogram(
            "serving_phase_seconds",
            "per-phase host wall time, attributed to the owning grid step",
            labels=("phase",), buckets=LATENCY_BUCKETS_S)
        self._flush_wall = self.registry.counter(
            "serving_flush_seconds_total",
            "pipeline-flush wall (retires after the last grid step)")
        self._overlap_hist = self.registry.histogram(
            "serving_overlap_ratio",
            "per-step host/device overlap: hidden / (hidden + wait)",
            buckets=RATIO_BUCKETS)
        self._hidden_s = self.registry.counter(
            "serving_overlap_hidden_seconds_total",
            "device compute hidden behind host staging")
        self._wait_s = self.registry.counter(
            "serving_device_wait_seconds_total",
            "retire-phase blocks on device results")
        self._bytes_held = self.registry.gauge(
            "serving_bytes_held",
            "resident bytes of serving weight state (params = the exec "
            "weight rep, deltas = the per-stream adaptation tensor)",
            labels=("kind",))

    @property
    def steps(self) -> int:
        """Grid steps recorded (dispatches; flush retires excluded)."""
        return int(self._steps.value)

    def stream(self, sid: int) -> StreamCounters:
        """The (created-on-first-use) per-stream counter record for ``sid``."""
        with self._lock:
            if sid not in self.streams:
                self.streams[sid] = StreamCounters(sid, self.registry)
            return self.streams[sid]

    def record_step(self, latency_s: float) -> None:
        """Log one ``step()`` call's host wall time."""
        self._steps.inc()
        self._step_hist.observe(float(latency_s))

    def record_flush(self, latency_s: float) -> None:
        """Log pipeline-flush wall: not a grid step, but part of the
        throughput wall so pipelined events/s get no free final step."""
        self._flush_wall.inc(float(latency_s))

    def record_phase(self, phase: str, latency_s: float) -> None:
        """Log one phase's host wall time (stage/dispatch/retire/flush)."""
        self._phase_hist.labels(phase=phase).observe(float(latency_s))

    def record_overlap(self, hidden_s: float, wait_s: float) -> float:
        """Log one retired step's host/device overlap; returns the ratio."""
        hidden_s, wait_s = max(0.0, float(hidden_s)), max(0.0, float(wait_s))
        denom = hidden_s + wait_s
        ratio = hidden_s / denom if denom > 0 else 0.0
        self._hidden_s.inc(hidden_s)
        self._wait_s.inc(wait_s)
        self._overlap_hist.observe(ratio)
        return ratio

    def record_bytes_held(self, params_bytes: int, delta_bytes: int) -> None:
        """Log the resident serving weight-state bytes."""
        self._bytes_held.labels(kind="params").set(float(params_bytes))
        self._bytes_held.labels(kind="deltas").set(float(delta_bytes))
        self._bytes_held.labels(kind="total").set(
            float(params_bytes + delta_bytes))

    def bytes_held(self) -> dict:
        """Last-recorded resident bytes {params, deltas, total}."""
        out = {"params": 0.0, "deltas": 0.0, "total": 0.0}
        for values, child in self._bytes_held.samples():
            out[values[0]] = float(child.value)
        return out

    # -- rollup --------------------------------------------------------------
    def latency_percentiles(self) -> dict:
        """p50/p99 of recorded grid-step wall times, in milliseconds."""
        if self._step_hist.count == 0:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        return {"p50_ms": self._step_hist.percentile(50) * 1e3,
                "p99_ms": self._step_hist.percentile(99) * 1e3}

    def phase_percentiles(self) -> dict:
        """Per-phase ``{phase: {"p50_ms", "p99_ms", "total_s"}}``."""
        out = {}
        for values, child in self._phase_hist.samples():
            if child.count:
                out[values[0]] = {"p50_ms": child.percentile(50) * 1e3,
                                  "p99_ms": child.percentile(99) * 1e3,
                                  "total_s": child.sum}
        return out

    def overlap_ratio(self) -> float:
        """Aggregate host/device overlap over the whole run (0.0 serial)."""
        denom = self._hidden_s.value + self._wait_s.value
        return self._hidden_s.value / denom if denom > 0 else 0.0

    def rollup(self) -> dict:
        """Fleet-level summary: summed stream counters, throughput over the
        recorded step + flush wall, latency percentiles, overlap, energy."""
        def fam_total(attr):
            fam = self.registry.get(STREAM_COUNTER_FAMILIES[attr][0])
            return fam.total() if fam is not None else 0.0

        timesteps = fam_total("timesteps")
        events_in = fam_total("events_in")
        sop_forward = fam_total("sop_forward")
        sop_wu = fam_total("sop_wu")
        sop_wu_offered = fam_total("sop_wu_offered")
        wall = self._step_hist.sum + self._flush_wall.value
        return {
            "n_streams": len(self.streams),
            "grid_steps": self.steps,
            "timesteps": timesteps,
            "events_in": events_in,
            "windows": int(fam_total("windows")),
            "wu_skip_rate": (1.0 - sop_wu / sop_wu_offered
                             if sop_wu_offered > 0 else 0.0),
            "fleet_energy": report(sop_forward, sop_wu, sop_wu_offered,
                                   timesteps, op=self.op).as_dict(),
            "events_per_s": events_in / wall if wall > 0 else 0.0,
            "timesteps_per_s": timesteps / wall if wall > 0 else 0.0,
            "overlap_ratio": self.overlap_ratio(),
            "bytes_held": self.bytes_held(),
            **self.latency_percentiles(),
        }

    def per_stream(self) -> List[dict]:
        """Each stream's energy report (sid-sorted)."""
        return [c.energy(self.op) for _, c in sorted(self.streams.items())]
