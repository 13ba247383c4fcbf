"""Per-stream and fleet-level serving telemetry (``repro.serving.telemetry``),
on the port's own copy of the metrics registry. Per-stream counters are
monotone (a negative increment raises) and separable (a slot's counters
only get that slot's lane of the chunk metrics); step and phase wall times
land in bounded fixed-bucket histograms; the host/device overlap ratio is
``hidden / (hidden + wait)`` per retired step; live topology epochs land
in counters (totals) and a bounded ring of recent events, each with the
epoch's host wall. QoS tiers get ``tier``-labelled families of their own
(step and phase walls, summed chunk counters), beside the pipeline depth,
the autopilot's overlap EMA and the ingest queues' drains.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional

from ..core.energy import OperatingPoint, report
from ..obs.metrics import (LATENCY_BUCKETS_S, QUEUE_DEPTH_BUCKETS,
                           RATIO_BUCKETS, MetricsRegistry)

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

# per-tier counter families, beside the per-stream ones (which keep their
# one ``sid`` label): attribute name -> (metric name, help)
TIER_COUNTER_FAMILIES = {
    "timesteps": ("serving_tier_timesteps_total",
                  "valid timesteps advanced, by QoS tier"),
    "events_in": ("serving_tier_events_in_total",
                  "input spikes consumed, by QoS tier"),
    "sop_forward": ("serving_tier_sop_forward_total",
                    "forward synaptic ops, by QoS tier"),
    "sop_wu": ("serving_tier_sop_wu_total",
               "weight-update MACs actually paid, by QoS tier"),
    "sop_wu_offered": ("serving_tier_sop_wu_offered_total",
                       "weight-update MACs offered to the gate, by QoS tier"),
    "windows": ("serving_tier_windows_total",
                "completed T-step windows (predictions), by QoS tier"),
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
                 registry: Optional[MetricsRegistry] = None,
                 max_epoch_events: int = 256):
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
        self._topo_epochs = self.registry.counter(
            "serving_topology_epochs_total", "live DSST prune/regrow epochs")
        self._topo_pruned = self.registry.counter(
            "serving_topology_pruned_total", "connections pruned by epochs")
        self._topo_regrown = self.registry.counter(
            "serving_topology_regrown_total", "connections regrown by epochs")
        self._topo_merged = self.registry.counter(
            "serving_streams_merged_total", "hot streams folded into base")
        self._topo_mask_change = self.registry.gauge(
            "serving_topology_mask_change", "last epoch's mask-change frac")
        self._topo_mask_change_sum = self.registry.counter(
            "serving_topology_mask_change_sum",
            "summed per-epoch mask-change fractions (mean = sum / epochs)")
        self._topo_wall = self.registry.counter(
            "serving_topology_epoch_seconds_total",
            "host wall of the live epochs (fold, evolve, project, swap)")
        # -- QoS tiers / adaptive depth / async ingest ------------------------
        self._tier_step_hist = self.registry.histogram(
            "serving_tier_step_seconds",
            "host wall of one tier's slice of a grid step",
            labels=("tier",), buckets=LATENCY_BUCKETS_S)
        self._tier_phase_hist = self.registry.histogram(
            "serving_tier_phase_seconds",
            "per-tier per-phase host wall time",
            labels=("tier", "phase"), buckets=LATENCY_BUCKETS_S)
        self._tier_counters = {
            attr: self.registry.counter(name, help, labels=("tier",))
            for attr, (name, help) in TIER_COUNTER_FAMILIES.items()}
        self._depth_gauge = self.registry.gauge(
            "serving_pipeline_depth",
            "current staging pipeline depth (autopilot-set or fixed)")
        self._depth_changes = self.registry.counter(
            "serving_pipeline_depth_changes_total",
            "adaptive depth changes applied at drain-safe boundaries")
        self._overlap_ema = self.registry.gauge(
            "serving_overlap_ema",
            "the depth autopilot's EMA of the per-step overlap ratio")
        self._ingest_chunks = self.registry.counter(
            "serving_ingest_chunks_total",
            "source chunks drained from the async ingest queues")
        self._ingest_queue_peak = self.registry.gauge(
            "serving_ingest_queue_peak_chunks",
            "high-water per-stream ingest queue depth (backpressure caps "
            "it at the configured capacity)")
        self._ingest_drain_hist = self.registry.histogram(
            "serving_ingest_drained_chunks",
            "chunks released to session buffers per poll-window drain",
            buckets=QUEUE_DEPTH_BUCKETS)
        # the per-epoch log is a bounded ring; the totals live in the
        # counters above, which topology_rollup() reads
        self.topology_epochs: Deque[dict] = deque(maxlen=max_epoch_events)

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

    def record_tier_step(self, tier: str, latency_s: float) -> None:
        """Log one tier's slice of a grid step's host wall."""
        self._tier_step_hist.labels(tier=tier).observe(float(latency_s))

    def record_tier_phase(self, tier: str, phase: str,
                          latency_s: float) -> None:
        """Per-tier per-phase host wall (the ``tier``-labelled companion of
        ``record_phase``)."""
        self._tier_phase_hist.labels(tier=tier, phase=phase).observe(
            float(latency_s))

    def record_tier_chunk(self, tier: str, *, timesteps, events_in,
                          sop_forward, sop_wu, sop_wu_offered,
                          windows) -> None:
        """Fold one retired grid step's tier-summed metrics into the
        ``tier``-labelled counter families."""
        c = self._tier_counters
        c["timesteps"].labels(tier=tier).inc(float(timesteps))
        c["events_in"].labels(tier=tier).inc(float(events_in))
        c["sop_forward"].labels(tier=tier).inc(float(sop_forward))
        c["sop_wu"].labels(tier=tier).inc(float(sop_wu))
        c["sop_wu_offered"].labels(tier=tier).inc(float(sop_wu_offered))
        c["windows"].labels(tier=tier).inc(int(windows))

    def record_depth(self, depth: int, changed: bool = False) -> None:
        """Log the pipeline depth in force; ``changed=True`` counts an
        autopilot change applied at a drain-safe boundary."""
        self._depth_gauge.set(float(depth))
        if changed:
            self._depth_changes.inc()

    def record_overlap_ema(self, ema: float) -> None:
        """Export the autopilot's overlap-ratio EMA (its control signal)."""
        self._overlap_ema.set(float(ema))

    def record_ingest(self, chunks: int, queue_peak: int) -> None:
        """Log one drain of the async ingest queues: chunks released to
        session buffers this tick, and the worker's lifetime high-water
        per-stream queue depth (at most the configured capacity)."""
        self._ingest_chunks.inc(int(chunks))
        self._ingest_queue_peak.set(float(queue_peak))
        self._ingest_drain_hist.observe(float(chunks))

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

    def record_topology_epoch(self, *, grid_step: int, pruned: int,
                              regrown: int, mask_change: float,
                              merged_streams: int,
                              wall_s: float = 0.0) -> None:
        """Log one live DSST prune/regrow epoch and its host wall."""
        self._topo_epochs.inc()
        self._topo_pruned.inc(int(pruned))
        self._topo_regrown.inc(int(regrown))
        self._topo_merged.inc(int(merged_streams))
        self._topo_mask_change.set(float(mask_change))
        self._topo_mask_change_sum.inc(float(mask_change))
        self._topo_wall.inc(float(wall_s))
        with self._lock:
            self.topology_epochs.append({
                "grid_step": int(grid_step), "pruned": int(pruned),
                "regrown": int(regrown), "mask_change": float(mask_change),
                "merged_streams": int(merged_streams),
                "wall_s": float(wall_s)})

    def topology_rollup(self) -> dict:
        """Aggregate topology-epoch stats from the registry counters (exact
        past the event ring's horizon); all zeros for a frozen fleet."""
        epochs = int(self._topo_epochs.value)
        return {
            "topology_epochs": epochs,
            "topology_pruned": int(self._topo_pruned.value),
            "topology_regrown": int(self._topo_regrown.value),
            "topology_mask_change_mean":
                (float(self._topo_mask_change_sum.value) / epochs
                 if epochs else 0.0),
            "streams_merged": int(self._topo_merged.value),
            "topology_epoch_wall_s": float(self._topo_wall.value),
        }

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

    def tier_percentiles(self) -> dict:
        """Per-tier ``{tier: {"p50_ms", "p99_ms", "total_s"}}`` of the
        tier-step wall histogram."""
        out = {}
        for values, child in self._tier_step_hist.samples():
            if child.count:
                out[values[0]] = {"p50_ms": child.percentile(50) * 1e3,
                                  "p99_ms": child.percentile(99) * 1e3,
                                  "total_s": child.sum}
        return out

    def per_tier(self) -> dict:
        """Per-tier counter rollup and energy: ``{tier: {timesteps,
        events_in, windows, wu_skip_rate, energy}}`` for every tier that
        retired at least one chunk."""
        acc: Dict[str, dict] = {}
        for attr, (name, _help) in TIER_COUNTER_FAMILIES.items():
            for values, child in self.registry.get(name).samples():
                acc.setdefault(values[0], {})[attr] = float(child.value)
        out = {}
        for tier, c in sorted(acc.items()):
            offered = c.get("sop_wu_offered", 0.0)
            out[tier] = {
                "timesteps": c.get("timesteps", 0.0),
                "events_in": c.get("events_in", 0.0),
                "windows": int(c.get("windows", 0)),
                "wu_skip_rate": (1.0 - c.get("sop_wu", 0.0) / offered
                                 if offered > 0 else 0.0),
                "energy": report(c.get("sop_forward", 0.0),
                                 c.get("sop_wu", 0.0), offered,
                                 c.get("timesteps", 0.0),
                                 op=self.op).as_dict(),
            }
        return out

    def tier_rollup(self) -> dict:
        """The QoS part of :meth:`rollup`: per-tier counters and energy,
        per-tier step-wall percentiles, the depth and ingest state."""
        return {
            "tiers": self.per_tier(),
            "tier_latency": self.tier_percentiles(),
            "pipeline_depth": float(self._depth_gauge.value),
            "depth_changes": int(self._depth_changes.value),
            "ingest_chunks": int(self._ingest_chunks.value),
            "ingest_queue_peak": int(self._ingest_queue_peak.value),
        }

    def overlap_ratio(self) -> float:
        """Aggregate host/device overlap over the whole run (0.0 serial)."""
        denom = self._hidden_s.value + self._wait_s.value
        return self._hidden_s.value / denom if denom > 0 else 0.0

    def rollup(self) -> dict:
        """Fleet-level summary: summed stream counters, throughput over the
        recorded step + flush wall, latency percentiles, overlap, energy,
        the topology rollup and the tier rollup."""
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
            **self.topology_rollup(),
            **self.tier_rollup(),
        }

    def per_stream(self) -> List[dict]:
        """Each stream's energy report (sid-sorted)."""
        return [c.energy(self.op) for _, c in sorted(self.streams.items())]
