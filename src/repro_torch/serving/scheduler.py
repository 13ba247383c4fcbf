"""Slot-multiplexed micro-batching for stateful SNN streams
(``repro.serving.scheduler``).

One chunk step with fixed shapes — events ``[chunk_len, n_slots, n_in]``,
valid ``[chunk_len, n_slots]`` — advances every active stream by up to
``chunk_len`` timesteps; admitted streams claim a lane (reset in place),
retired streams free it. Idle or ragged tails are masked invalid, so an
empty slot costs exactly zero counted events.

Each grid step runs stage → dispatch → retire (see ``serving/staging.py``).
Stage and dispatch never wait for the card: events are packed into pinned
host buffers and copied with ``non_blocking=True``, and the step is only
enqueued. Retire makes the one device-to-host transfer: every metric, and
the final lanes of retiring sessions, packed into one buffer and fetched
with one ``.cpu()``. ``pipeline_depth`` 0 retires each step inside
``step()``; 1 stages step ``t+1`` while the card computes step ``t``;
deeper queues keep more steps in flight. Every step is enqueued on one
CUDA stream, in order, so the in-place lane resets of a later stage land
after the steps already dispatched; a step's retiring lanes are copied at
its dispatch. Every depth gives bit-identical trajectories.

**QoS tiers.** ``tiers=[TierConfig(...), ...]`` splits the fleet into
per-tier slot grids, each with its own lane-batched state and deltas, its
own chunk fn and its own staging pipeline, over the same exec weights: an
``interactive`` tier with a short ``chunk_len`` (windows close after fewer
staged timesteps) beside a ``bulk`` tier with a long one (fewer dispatches
per timestep). A session's tier is fixed at ``submit``. The clock advances,
and sources are polled, once per grid step, in the first tier's stage.
``step()`` returns fleet-global slot ids (``slot0`` offsets). Without
``tiers`` there is one tier, "default", built from ``n_slots`` and
``chunk_len``.

**Async ingestion.** ``ingest=True`` (or an :class:`~.ingest.IngestConfig`
or :class:`~.ingest.IngestWorker`) moves source polling to a worker thread;
the stage phase then only drains its queues. The worker replays the
virtual clock exactly, so ingestion on and off are bit-identical. Call
:meth:`close` to stop the thread.

**Adaptive depth.** ``autopilot=True`` (or an
:class:`~.autopilot.AutopilotConfig` / :class:`~.autopilot.DepthAutopilot`)
retunes ``pipeline_depth`` from the EMA of the measured overlap ratio; a
change flushes every tier and resizes the empty pipelines, so an adaptive
run equals every fixed depth it visited, bit for bit.

**Tracing.** ``tracer=`` (an ``obs.Tracer``) records the phase spans
``sched.step/stage/poll_sources/admit/dispatch/retire/device_wait``,
``autopilot.decision/apply`` and ``topology.epoch``. Spans and telemetry
read host clocks only and add no sync: ``sched.device_wait`` wraps the one
``.cpu()``. Stage-side spans name the grid step being staged; a retire
span names the step that produced its results.

With a :class:`~.topology_service.TopologyService` attached (single-tier
fleets only), the chunk fn carries the DSST factors (``want_factors=True``):
every retire feeds the service, and a due prune/regrow epoch runs between
grid steps. The epoch of grid step ``t`` lands after ``t`` retires and
before ``t+1`` dispatches, with ``t``'s snapshot of the merge-eligible
lanes; the depth (and the autopilot's range) is clamped to 1 to keep that
order. The evolved ``(params, deltas)`` keep their shapes, dtypes and
device; the exec weight rep is re-derived from the new mask and the chunk
fn is never rebuilt (``n_compiles`` counts, per tier, the distinct chunk
fns the grid steps ran: it stays 1).

``compact`` picks the delta layout: compact ``[S, L, J, T, bk, bo]`` (the
default for uniform layer geometry) or dense ``[S, L, Kmax, N]`` (the A/B
baseline, whose exec rep carries the dense mask).

**Slot sharding.** With a ``("slots",)`` mesh
(``launch.mesh.make_serving_mesh``) every tier's grid shards over the
mesh's entries: its width is padded per entry
(``launch.sharding.tier_slot_allocation``), its state and deltas are
``launch.sharding.SlotSharded`` (entry ``i`` holds slots ``[i·w,
(i+1)·w)`` on its device), the base is replicated to every entry, and the
chunk fn runs each entry's slots on its own device with no communication,
bit for bit the 1-device fleet's step. Lane surgery writes a global slot in
the shard that holds it, the staging buffers are laid out shard-major (each
shard's block one contiguous pinned region, copied to its device without
waiting), and retire reads each device's metrics back once. ``state`` and
``deltas`` gather the full slot-leading tensors, so callers read a sharded
fleet as they read a 1-device one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import engine
from ..core.snn import (ChunkMetrics, SNNConfig, init_stream_deltas,
                        init_stream_state, serving_params)
from ..launch import sharding
from ..launch.batching import SlotGrid
from ..launch.sharding import SlotSharded
from ..obs.trace import NULL_TRACER, Tracer
from .adapt import AdaptConfig, make_chunk_fn
from .autopilot import AutopilotConfig, DepthAutopilot
from .ingest import IngestConfig, IngestWorker
from .session import SessionStatus, StreamSession, WindowPrediction, reset_lane
from .staging import InFlight, LaneRecord, StagedChunk, StagingPipeline
from .telemetry import FleetTelemetry


def _layout(x) -> list:
    """``(shape, dtype, device)`` of a tensor, or of each of its shards."""
    parts = x.shards if isinstance(x, SlotSharded) else (x,)
    return [(tuple(p.shape), p.dtype, p.device) for p in parts]


def _staging(tier: "_Tier") -> int:
    """The grid step ``tier``'s next dispatch will get (``grid.tick`` runs
    at dispatch, and every tier ticks once a grid step): what its
    stage-side spans name. The reference names every tier's by the first
    tier's count, which is one ahead for the later tiers once the first
    has dispatched."""
    return tier.grid.stats["steps"] + 1


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """One QoS tier's grid geometry: ``chunk_len`` trades latency (a short
    chunk closes windows after fewer staged timesteps) for dispatches per
    timestep; ``n_slots`` is the tier's lane count."""
    name: str
    chunk_len: int
    n_slots: int

    def __post_init__(self):
        if not self.name:
            raise ValueError("tier name must be non-empty")
        if self.chunk_len < 1 or self.n_slots < 1:
            raise ValueError(
                f"tier {self.name!r} needs chunk_len >= 1 and n_slots >= 1, "
                f"got {self.chunk_len}/{self.n_slots}")


class _Tier:
    """Runtime state of one tier: its slot grid, lane-batched state and
    deltas, chunk fn (and the distinct chunk fns its steps ran), and staging
    pipeline. ``slot0`` is the tier's offset in the fleet-global slot
    numbering; everything inside is tier-local."""

    __slots__ = ("name", "chunk_len", "n_slots", "slot0", "grid", "state",
                 "deltas", "chunk_fn", "fns_run", "pipeline")

    def __init__(self, name: str, chunk_len: int, n_slots: int, slot0: int):
        self.name, self.chunk_len = name, chunk_len
        self.n_slots, self.slot0 = n_slots, slot0
        self.fns_run: List[Callable] = []


class StreamScheduler:
    """Drives a fleet of :class:`StreamSession`\\ s over per-tier slot grids.

    Args:
      params:   frozen shared base params (stacked dense layout,
        ``core.snn``), on the fleet's device.
      cfg:      the fleet's :class:`SNNConfig`.
      n_slots:  grid width of the default tier (ignored with ``tiers``).
      chunk_len: timesteps per grid step of the default tier.
      adapt:    per-stream delta hygiene (:class:`AdaptConfig`).
      clock_dt_s: virtual seconds per grid step (drives source arrivals).
      telemetry: a :class:`FleetTelemetry` to fill (fresh one by default).
      pipeline_depth: 0 = serial phases, 1 = double-buffered staging, > 1 =
        a deeper queue (clamped to 1 with a topology service).
      device:   where the fleet's tensors live (``"cuda"`` by default);
        with ``mesh``, the mesh's entries hold them instead.
      mesh:     optional 1-D ``("slots",)`` mesh: shard every tier's grid
        over its entries (widths padded per entry).
      topology: optional :class:`TopologyService`, live DSST epochs; it
        must be built for ``cfg``, on a single-tier fleet.
      want_factors: the chunk fn's DSST-factor mode; None = True iff a
        non-frozen topology service is attached (which requires it).
      compact:  delta layout; None = compact iff the layer geometry is
        uniform, False = the dense baseline.
      tracer:   an ``obs.Tracer`` for the phase spans (``NULL_TRACER`` by
        default).
      tiers:    QoS tier geometries (:class:`TierConfig`, unique names);
        None = one tier "default" from ``n_slots`` / ``chunk_len``.
      ingest:   async source ingestion: True, an :class:`IngestConfig` or an
        :class:`IngestWorker`; None / False polls inline in stage.
      autopilot: adaptive depth: True, an :class:`AutopilotConfig` or a
        :class:`DepthAutopilot`; None / False keeps the depth fixed.
    """

    def __init__(self, params, cfg: SNNConfig, n_slots: int,
                 chunk_len: int = 8, adapt: Optional[AdaptConfig] = None,
                 clock_dt_s: float = 0.002,
                 telemetry: Optional[FleetTelemetry] = None,
                 pipeline_depth: int = 0, device="cuda", *, mesh=None,
                 topology=None, want_factors: Optional[bool] = None,
                 compact: Optional[bool] = None,
                 tracer: Optional[Tracer] = None,
                 tiers: Optional[Sequence[TierConfig]] = None,
                 ingest=None, autopilot=None):
        if topology is not None and topology.cfg != cfg:
            raise ValueError("topology service was built for a different "
                             "SNNConfig than this scheduler's")
        live = topology is not None and not topology.frozen
        if want_factors is None:
            want_factors = live
        if live and not want_factors:
            raise ValueError("a live topology service consumes the chunk "
                             "step's DSST factors; want_factors=False would "
                             "starve it")
        if topology is not None:
            # an epoch due after step t must land before step t+1 is
            # dispatched; depth 1 keeps that order, deeper queues would not
            pipeline_depth = min(pipeline_depth, 1)
        if tiers is None:
            tier_cfgs = [TierConfig("default", chunk_len=chunk_len,
                                    n_slots=n_slots)]
        else:
            tier_cfgs = list(tiers)
            if not tier_cfgs:
                raise ValueError("tiers must be a non-empty TierConfig list")
            names = [t.name for t in tier_cfgs]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate tier names in {names}")
            if topology is not None and len(tier_cfgs) > 1:
                raise ValueError(
                    "a topology service folds one fleet-wide delta grid "
                    "into the shared base; attach it to a single-tier "
                    "scheduler")
        if mesh is not None:
            # padded to a multiple of the entry count so every entry owns an
            # equal shard (padding lanes just idle: an empty slot is free),
            # and floored at 2 slots an entry, the reference's rule
            widths = sharding.tier_slot_allocation(
                [t.n_slots for t in tier_cfgs], mesh)
            tier_cfgs = [dataclasses.replace(t, n_slots=w)
                         for t, w in zip(tier_cfgs, widths)]
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None \
            else mesh.devices[0]
        self.params, self.cfg = params, cfg
        self.topology, self.want_factors = topology, want_factors
        self.compact = engine.geometry(cfg).uniform if compact is None \
            else compact
        self._tiers: List[_Tier] = []
        slot0 = 0
        for tc in tier_cfgs:
            tier = _Tier(tc.name, tc.chunk_len, tc.n_slots, slot0)
            slot0 += tc.n_slots
            tier.grid = SlotGrid(tc.n_slots)
            tier.state, tier.deltas = self._new_lanes(tc.n_slots)
            tier.chunk_fn = make_chunk_fn(cfg, adapt,
                                          want_factors=want_factors,
                                          mesh=mesh)
            tier.pipeline = StagingPipeline(depth=pipeline_depth)
            self._tiers.append(tier)
        self._by_name = {t.name: t for t in self._tiers}
        self.n_slots = slot0                     # fleet-wide lane count
        self.chunk_len = self._tiers[0].chunk_len
        self.pipeline_depth = pipeline_depth
        self.clock = 0.0
        self.clock_dt_s = clock_dt_s
        self.telemetry = telemetry or FleetTelemetry()
        self.tracer = tracer or NULL_TRACER
        self.retired: List[StreamSession] = []
        self._pin = self.device.type == "cuda"
        self._n_shards = 1 if mesh is None else mesh.size

        self.ingest: Optional[IngestWorker] = None
        if ingest:
            if isinstance(ingest, IngestWorker):
                self.ingest = ingest
            elif isinstance(ingest, IngestConfig):
                self.ingest = IngestWorker(clock_dt_s, ingest)
            else:
                self.ingest = IngestWorker(clock_dt_s)
            if self.ingest._dt != float(clock_dt_s):
                raise ValueError(
                    "ingest worker clock_dt_s disagrees with the "
                    "scheduler's — the virtual-clock replay would diverge")

        self.autopilot: Optional[DepthAutopilot] = None
        if autopilot:
            if isinstance(autopilot, DepthAutopilot):
                ap = autopilot
            elif isinstance(autopilot, AutopilotConfig):
                ap = DepthAutopilot(autopilot, tracer=self.tracer)
            else:
                ap = DepthAutopilot(tracer=self.tracer)
            if topology is not None and ap.cfg.max_depth > 1:
                # the constructor's clamp, for the controller's range
                ap = DepthAutopilot(
                    dataclasses.replace(ap.cfg, max_depth=1),
                    tracer=ap.tracer)
            ap.note_depth(0, pipeline_depth)
            self.autopilot = ap

        self._refresh_exec_params()

    def _refresh_exec_params(self) -> None:
        """(Re)derive the weight rep the chunk fns consume from the dense
        ``self.params`` (the compact rep; the dense layout's adds its
        ``mask_f``) and re-measure the resident bytes. Runs at construction
        and after every topology swap, the only times the base changes."""
        rep = serving_params(self.params, self.cfg, compact=self.compact)
        self._params_bytes = sum(t.nbytes for t in rep.values())
        # on a mesh: one replica an entry, whether or not devices repeat
        self._exec_params = rep if self.mesh is None \
            else sharding.replicate(rep, self.mesh)
        # a tensor's bytes, or a SlotSharded's summed over its shards
        self._delta_bytes = sum(t.deltas.nbytes for t in self._tiers)

    def _new_lanes(self, n_slots: int):
        """A tier's fresh ``(state, deltas)``: on a mesh, each entry's shard
        made on its device."""
        def lanes(n, dev):
            return (init_stream_state(self.cfg, n, device=dev),
                    init_stream_deltas(self.cfg, n, device=dev,
                                       compact=self.compact))
        if self.mesh is None:
            return lanes(n_slots, self.device)
        w = n_slots // self.mesh.size
        s0 = sharding.slot_spec(0)
        return sharding.stack_shards(
            [lanes(w, dev) for dev in self.mesh.devices], (s0, s0),
            self.mesh)

    def _place(self, tree):
        """A caller's slot-leading tree, sharded over the mesh (as it is
        without one)."""
        if self.mesh is None:
            return tree
        return sharding.device_put(tree, sharding.slot_sharding(self.mesh))

    def _replace_lanes(self, tier: _Tier, deltas: torch.Tensor) -> None:
        """Install swapped deltas on ``tier``: a tensor (or shards) of the
        live one's shape, dtype and device, so the chunk fn takes it as it
        took the old one."""
        old = tier.deltas
        if type(deltas) is not type(old) or _layout(deltas) != _layout(old):
            raise ValueError(f"swapped deltas {_layout(deltas)} do not match "
                             f"the fleet's {_layout(old)}")
        tier.deltas = deltas

    # -- lifecycle -----------------------------------------------------------
    def submit(self, session: StreamSession,
               tier: Optional[str] = None) -> None:
        """Queue a session for admission at the next stage phase, on
        ``tier``, else the session's own ``tier``, else the first tier."""
        name = tier or session.tier or self._tiers[0].name
        if name not in self._by_name:
            raise ValueError(
                f"unknown tier {name!r}; have {sorted(self._by_name)}")
        session.tier = name
        session.status = SessionStatus.QUEUED
        if session.n_in is None:
            session.n_in = self.cfg.n_in
        elif session.n_in != self.cfg.n_in:
            raise ValueError(
                f"session {session.sid} n_in={session.n_in} != "
                f"cfg.n_in={self.cfg.n_in}")
        if self.ingest is not None:
            self.ingest.attach(session)
        self._by_name[name].grid.submit(session)

    def close(self) -> None:
        """Stop the ingest worker thread (a no-op without one; safe to call
        twice). A closed scheduler still drains correctly: the drain then
        steal-polls inline, the serial semantics."""
        if self.ingest is not None:
            self.ingest.stop()

    def _admit(self, tier: _Tier) -> None:
        with self.tracer.span("sched.admit", grid_step=_staging(tier),
                              tier=tier.name) as sp:
            n = 0

            def on_admit(slot: int, sess: StreamSession):
                nonlocal n
                n += 1
                sess.slot, sess.status = slot, SessionStatus.ACTIVE
                reset_lane(tier.state, tier.deltas, self.cfg, slot)
            tier.grid.admit(on_admit)
            sp.set(admitted=n)

    def _poll_sources(self) -> None:
        """Move newly arrived chunks into session buffers, fleet-wide: a
        lock-protected drain of the ingest queues, or inline polls."""
        with self.tracer.span("sched.poll_sources",
                              grid_step=self._staging_step) as sp:
            if self.ingest is not None:
                n, peak = self.ingest.drain(self._staging_step)
                self.telemetry.record_ingest(n, peak)
            else:
                n = 0
                for tier in self._tiers:
                    for sess in (list(tier.grid.occupant)
                                 + list(tier.grid.queue)):
                        if sess is not None and sess.source is not None:
                            for chunk in sess.source.poll(self.clock):
                                sess.push_events(chunk)
                                n += 1
            sp.set(chunks=n)

    @property
    def _staging_step(self) -> int:
        """The grid step the first tier's next dispatch will get: what the
        fleet-wide stage-side spans name."""
        return _staging(self._tiers[0])

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pin)

    # -- phase 1: stage ------------------------------------------------------
    def _stage(self, tier: _Tier) -> StagedChunk:
        """Host-only assembly of one tier's grid step."""
        t0 = time.perf_counter()
        with self.tracer.span("sched.stage", grid_step=_staging(tier),
                              tier=tier.name):
            staged = self._stage_body(tier)
        dt = time.perf_counter() - t0
        self.telemetry.record_phase("stage", dt)
        self.telemetry.record_tier_phase(tier.name, "stage", dt)
        return staged

    def _stage_body(self, tier: _Tier) -> StagedChunk:
        """Advance the clock and poll the sources (first tier only: both
        are fleet-wide), admit into free lanes, pack the buffers, and decide
        which sessions exhaust after this step."""
        if tier is self._tiers[0]:
            self.clock += self.clock_dt_s
            self._poll_sources()
        self._admit(tier)
        # shard-major: shard i's block [i] is one contiguous (pinned) region
        C, D = tier.chunk_len, self._n_shards
        w = tier.n_slots // D
        events_t = self._host_buffer((D, C, w, self.cfg.n_in), torch.float32)
        valid_t = self._host_buffer((D, C, w), torch.bool)
        amask_t = self._host_buffer((D, w), torch.bool)
        events, valid, amask = events_t.numpy(), valid_t.numpy(), amask_t.numpy()
        lanes: List[LaneRecord] = []
        retiring = []
        fed: Dict[int, int] = {}
        for slot, sess in enumerate(tier.grid.occupant):
            if sess is None:
                continue
            chunk = sess.pop_chunk(C)
            n = chunk.shape[0]
            i, j = divmod(slot, w)
            if n:
                events[i, :n, j] = chunk
                valid[i, :n, j] = True
            amask[i, j] = sess.adapt
            fed[slot] = n
            lanes.append(LaneRecord(slot=slot, session=sess, n_fed=n,
                                    events_in=float(chunk.sum())))
            if sess.exhausted:        # a host fact: source done, buffers empty
                retiring.append((slot, sess))
        gone = {slot for slot, _ in retiring}
        merge_slots = tuple(
            slot for slot, sess in enumerate(tier.grid.occupant)
            if sess is not None and sess.adapt and slot not in gone)
        return StagedChunk(events=events_t, valid=valid_t, adapt_mask=amask_t,
                           lanes=lanes, retiring=retiring,
                           merge_slots=merge_slots, fed=fed)

    # -- phase 2: dispatch ---------------------------------------------------
    def _dispatch(self, tier: _Tier, staged: StagedChunk) -> InFlight:
        """Enqueue the tier's chunk step (no host wait), copy the lanes the
        retire phase will read, then free retiring sessions' lanes so the
        next stage phase can re-admit into them."""
        t0 = time.perf_counter()
        with self.tracer.span("sched.dispatch", grid_step=_staging(tier),
                              tier=tier.name) as sp:
            events = self._to_device(staged.events, 1)
            valid = self._to_device(staged.valid, 1)
            amask = self._to_device(staged.adapt_mask, 0)
            fn = tier.chunk_fn
            if not any(f is fn for f in tier.fns_run):
                tier.fns_run.append(fn)
            tier.deltas, tier.state, metrics = fn(
                self._exec_params, tier.deltas, tier.state, events, valid,
                amask)
            final = None
            if staged.retiring:
                # a copy: a later stage may reset these lanes in place
                # before this step retires
                final = self._copy_lanes(tier.deltas,
                                         [s for s, _ in staged.retiring])
            tier.grid.tick()
            for slot, _ in staged.retiring:
                tier.grid.retire(slot)
            sp.set(lanes=len(staged.lanes), retiring=len(staged.retiring))
            fl = InFlight(staged=staged, final_deltas=final, metrics=metrics,
                          grid_step=tier.grid.stats["steps"])
        dt = time.perf_counter() - t0
        self.telemetry.record_phase("dispatch", dt)
        self.telemetry.record_tier_phase(tier.name, "dispatch", dt)
        return fl

    def _to_device(self, blocks: torch.Tensor, slot_dim: int):
        """Staged shard-major host blocks onto the fleet without waiting:
        block ``i`` to entry ``i``'s device (a ``SlotSharded`` along
        ``slot_dim``), or the one block to the fleet's device."""
        if self.mesh is None:
            return blocks[0].to(self.device, non_blocking=True)
        return SlotSharded([blocks[i].to(dev, non_blocking=True)
                            for i, dev in enumerate(self.mesh.devices)],
                           self.mesh, slot_dim)

    def _copy_lanes(self, deltas, slots: List[int]) -> Tuple:
        """Copies of the lanes ``slots`` (ascending) of a tier's deltas: one
        block a shard that holds any, in shard order, so the blocks joined
        are the lanes in ``slots`` order."""
        shards = deltas.shards if isinstance(deltas, SlotSharded) \
            else (deltas,)
        w = shards[0].shape[0]
        out = []
        for i, d in enumerate(shards):
            local = [s - i * w for s in slots if i * w <= s < (i + 1) * w]
            if local:
                idx = torch.tensor(local, dtype=torch.long,
                                   pin_memory=self._pin)
                out.append(d.index_select(
                    0, idx.to(d.device, non_blocking=True)))
        return tuple(out)

    # -- phase 3: retire -----------------------------------------------------
    def _fetch(self, fl: InFlight):
        """The device-to-host transfer of a step: every metric (and the
        retiring lanes) flattened into one f32 buffer a device, one
        ``.cpu()`` each (one a step without a mesh); sharded values are
        joined along their slot axis on the host."""
        named = [(k, v) for k, v in fl.metrics._asdict().items()
                 if v is not None]
        if fl.final_deltas is not None:
            named.append(("final_deltas", fl.final_deltas))
        pieces, by_dev = [], {}
        for k, v in named:
            if isinstance(v, SlotSharded):
                parts, dim = v.shards, v.slot_dim
            else:
                parts, dim = (v if isinstance(v, tuple) else (v,)), 0
            pieces.append((k, parts, dim))
            for p in parts:
                by_dev.setdefault(p.device, []).append(p)
        host = {}
        for dev, ts in by_dev.items():
            flat = torch.cat([t.reshape(-1).to(torch.float32) for t in ts])
            host[dev] = flat.cpu().numpy()
        off = dict.fromkeys(host, 0)
        out = {}
        for k, parts, dim in pieces:
            arrs = []
            for p in parts:
                n, o = p.numel(), off[p.device]
                a = host[p.device][o:o + n].reshape(tuple(p.shape))
                arrs.append(a.astype(bool) if p.dtype == torch.bool else a)
                off[p.device] = o + n
            out[k] = arrs[0] if len(arrs) == 1 else np.concatenate(arrs, dim)
        return out

    def _retire(self, tier: _Tier, fl: InFlight) -> None:
        """Consume one in-flight step: fetch (the only device wait), route
        window predictions, fold telemetry, finalize retiring sessions. The
        span names ``fl.grid_step``, the step that produced the results."""
        t0 = time.perf_counter()
        with self.tracer.span("sched.retire", grid_step=fl.grid_step,
                              tier=tier.name):
            with self.tracer.span("sched.device_wait",
                                  grid_step=fl.grid_step):
                tw0 = time.perf_counter()
                m = self._fetch(fl)
                wait_s = time.perf_counter() - tw0
            ratio = self.telemetry.record_overlap(hidden_s=fl.queued_s,
                                                  wait_s=wait_s)
            if self.autopilot is not None:
                self.telemetry.record_overlap_ema(
                    self.autopilot.observe(ratio))
            self._retire_body(tier, fl, m)
        dt = time.perf_counter() - t0
        self.telemetry.record_phase("retire", dt)
        self.telemetry.record_tier_phase(tier.name, "retire", dt)

    def _retire_body(self, tier: _Tier, fl: InFlight, m) -> None:
        staged = fl.staged
        logits, wend = m["logits"], m["window_end"]           # [C,S,·], [C,S]
        tsum = {"timesteps": 0.0, "events_in": 0.0, "sop_forward": 0.0,
                "sop_wu": 0.0, "sop_wu_offered": 0.0, "windows": 0}
        for rec in staged.lanes:
            slot, sess = rec.slot, rec.session
            sess.timesteps_fed += rec.n_fed
            steps = float(m["steps"][slot])
            sop_forward = float(m["sop_forward"][slot])
            sop_wu = float(m["sop_wu"][slot])
            sop_wu_offered = float(m["sop_wu_offered"][slot])
            windows = int(wend[:, slot].sum())
            self.telemetry.stream(sess.sid).add_chunk(
                steps=steps, events_in=rec.events_in,
                sop_forward=sop_forward, sop_wu=sop_wu,
                sop_wu_offered=sop_wu_offered,
                gate_opened=m["gate_opened"][slot].sum(),
                gate_offered=m["gate_offered"][slot].sum(),
                windows=windows, local_loss=m["local_loss"][slot])
            tsum["timesteps"] += steps
            tsum["events_in"] += rec.events_in
            tsum["sop_forward"] += sop_forward
            tsum["sop_wu"] += sop_wu
            tsum["sop_wu_offered"] += sop_wu_offered
            tsum["windows"] += windows
            for t in np.nonzero(wend[:, slot])[0]:
                sess.predictions.append(WindowPrediction(
                    window_idx=len(sess.predictions),
                    logits=logits[t, slot].copy()))
        if staged.lanes:
            self.telemetry.record_tier_chunk(tier.name, **tsum)
        for i, (slot, sess) in enumerate(staged.retiring):
            sess.final_deltas = m["final_deltas"][i].copy()
            sess.status, sess.slot = SessionStatus.RETIRED, None
            if self.ingest is not None:
                self.ingest.detach(sess)
            self.retired.append(sess)
        svc = self.topology
        if svc is not None and not svc.frozen and "pre_mag" in m:
            svc.observe(ChunkMetrics(**{f: m.get(f)
                                        for f in ChunkMetrics._fields}))
            self.maybe_evolve_topology(merge_slots=staged.merge_slots,
                                       grid_step=fl.grid_step)

    # -- adaptive depth ------------------------------------------------------
    def _apply_autopilot(self) -> None:
        """Evaluate the depth controller and, on a change, apply it at a
        drain-safe boundary: flush every in-flight step, then resize the
        empty pipelines."""
        step = self._staging_step
        new = self.autopilot.decide(step, self.pipeline_depth)
        if new == self.pipeline_depth:
            return
        with self.tracer.span("autopilot.apply", grid_step=step,
                              depth=self.pipeline_depth, new_depth=new):
            self.flush()
            for tier in self._tiers:
                tier.pipeline.set_depth(new)
        self.pipeline_depth = new
        self.autopilot.note_depth(step, new)
        self.telemetry.record_depth(new, changed=True)

    # -- the one grid step ---------------------------------------------------
    def step(self) -> Dict[int, int]:
        """One grid step across every tier; returns {global slot: timesteps
        fed} for the step staged (and dispatched) by this call. Pipelined,
        its bookkeeping lands in a later ``step()`` or at :meth:`flush`."""
        t0 = time.perf_counter()
        self.telemetry.record_bytes_held(self._params_bytes, self._delta_bytes)
        if self.autopilot is not None:
            self._apply_autopilot()
        fed: Dict[int, int] = {}
        with self.tracer.span("sched.step", grid_step=self._staging_step):
            for tier in self._tiers:
                tt0 = time.perf_counter()
                staged = self._stage(tier)
                if tier.pipeline.depth == 0:
                    self._retire(tier, self._dispatch(tier, staged))
                else:
                    while tier.pipeline.full:
                        self._retire(tier, tier.pipeline.pop())
                    tier.pipeline.push(self._dispatch(tier, staged))
                self.telemetry.record_tier_step(
                    tier.name, time.perf_counter() - tt0)
                for slot, n in staged.fed.items():
                    fed[tier.slot0 + slot] = n
        self.telemetry.record_step(time.perf_counter() - t0)
        return fed

    def flush(self) -> None:
        """Retire every in-flight step of every tier (no-op in serial
        mode)."""
        for tier in self._tiers:
            while len(tier.pipeline):
                t0 = time.perf_counter()
                self._retire(tier, tier.pipeline.pop())
                self.telemetry.record_flush(time.perf_counter() - t0)

    # -- live topology evolution --------------------------------------------
    def maybe_evolve_topology(self, force: bool = False, merge_slots=None,
                              grid_step: Optional[int] = None):
        """Run a due DSST prune/regrow epoch between grid steps and swap its
        ``(params, deltas)`` in. The retire phase passes the staged step's
        ``merge_slots`` snapshot and ``grid_step``; a manual call may omit
        both (the current adaptive occupants, the current step). Returns the
        ``TopologyEpochEvent`` when an epoch ran, else None."""
        svc = self.topology
        tier = self._tiers[0]             # topology fleets are single-tier
        step = tier.grid.stats["steps"] if grid_step is None else grid_step
        if svc is None or not (force or svc.due(step)):
            return None
        if merge_slots is None:
            merge_slots = tuple(
                slot for slot, sess in enumerate(tier.grid.occupant)
                if sess is not None and sess.adapt)
        t0 = time.perf_counter()
        with self.tracer.span("topology.epoch", grid_step=step,
                              epoch=svc.epoch_idx) as sp:
            params, deltas, event = svc.evolve(self.params, tier.deltas,
                                               merge_slots=merge_slots,
                                               grid_step=step)
            sp.set(pruned=event.pruned, regrown=event.regrown,
                   merged=len(event.merged_slots))
        self.params = params
        self._replace_lanes(tier, deltas)
        self._refresh_exec_params()   # new mask -> new compact wc/idx
        self.telemetry.record_topology_epoch(
            grid_step=event.grid_step, pruned=event.pruned,
            regrown=event.regrown, mask_change=event.mask_change,
            merged_streams=len(event.merged_slots),
            wall_s=time.perf_counter() - t0)
        return event

    def run_until_drained(self, max_steps: int = 100_000) -> List[StreamSession]:
        """Step until every submitted session is served, then flush;
        returns the retired sessions (bookkeeping complete)."""
        while not all(t.grid.drained for t in self._tiers):
            self.step()
            if self._tiers[0].grid.stats["steps"] >= max_steps:
                break
        self.flush()
        return self.retired

    # -- introspection -------------------------------------------------------
    @property
    def grid(self) -> SlotGrid:
        """The first tier's slot grid (the fleet's, on one tier)."""
        return self._tiers[0].grid

    @property
    def pipeline(self) -> StagingPipeline:
        """The first tier's staging pipeline (every tier runs the same
        depth)."""
        return self._tiers[0].pipeline

    @property
    def chunk_fn(self):
        """The first tier's chunk step."""
        return self._tiers[0].chunk_fn

    @chunk_fn.setter
    def chunk_fn(self, value):
        self._tiers[0].chunk_fn = value

    @property
    def state(self):
        """The first tier's lane-batched ``StreamState`` (on a mesh, the
        full tensors gathered from its shards: a copy)."""
        return sharding.gather(self._tiers[0].state)

    @state.setter
    def state(self, value):
        self._tiers[0].state = self._place(value)

    @property
    def deltas(self) -> torch.Tensor:
        """The first tier's slot-leading delta tensor (on a mesh, gathered
        from its shards: a copy)."""
        return sharding.gather(self._tiers[0].deltas)

    @deltas.setter
    def deltas(self, value):
        self._tiers[0].deltas = self._place(value)

    @property
    def tiers(self) -> Tuple[str, ...]:
        """Tier names, in grid order (``slot0`` ascending)."""
        return tuple(t.name for t in self._tiers)

    def tier_grid(self, name: str) -> SlotGrid:
        """The named tier's slot grid."""
        return self._by_name[name].grid

    @property
    def drained(self) -> bool:
        """No session queued or active on any tier, and no step in flight."""
        return all(t.grid.drained and len(t.pipeline) == 0
                   for t in self._tiers)

    @property
    def n_compiles(self) -> int:
        """The most distinct chunk fns any tier's grid steps have run,
        however they were built: 0 before the first step, then 1 for the
        life of the fleet, topology swaps included. The counterpart of the
        reference's one-trace-per-geometry guarantee, per tier."""
        return max(len(t.fns_run) for t in self._tiers)

    @property
    def n_compiles_by_tier(self) -> Dict[str, int]:
        """Per-tier count of the distinct chunk fns run."""
        return {t.name: len(t.fns_run) for t in self._tiers}

    @property
    def utilization(self) -> float:
        """Mean fraction of lanes occupied at dispatch, over all steps and
        tiers (slot-weighted)."""
        num = sum(t.grid.stats["slot_busy"] for t in self._tiers)
        den = sum(t.grid.stats["steps"] * t.n_slots for t in self._tiers)
        return num / den if den else 0.0
