"""Slot-multiplexed micro-batching for stateful SNN streams
(``repro.serving.scheduler``, one tier).

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
``step()``; 1 stages step ``t+1`` while the card computes step ``t``. Both
give bit-identical trajectories.

With a :class:`~.topology_service.TopologyService` attached, the chunk fn
carries the DSST factors (``want_factors=True``): every retire feeds the
service, and a due prune/regrow epoch runs between grid steps. The epoch
of grid step ``t`` lands after ``t`` retires and before ``t+1`` dispatches,
with ``t``'s snapshot of the merge-eligible lanes, so a pipelined fleet
with epochs equals the serial one bit for bit. The evolved ``(params,
deltas)`` keep their shapes, dtypes and device; the exec weight rep is
re-derived from the new mask and the chunk fn is never rebuilt
(``n_compiles`` counts the distinct chunk fns the grid steps ran: it
stays 1).

``compact`` picks the delta layout: compact ``[S, L, J, T, bk, bo]`` (the
default for uniform layer geometry) or dense ``[S, L, Kmax, N]`` (the A/B
baseline, whose exec rep carries the dense mask).

Not ported yet: QoS tiers, async ingestion, the depth autopilot, the span
tracer, slot sharding over a mesh and pipeline depths above 1. Passing any
of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import engine
from ..core.snn import (ChunkMetrics, SNNConfig, init_stream_deltas,
                        init_stream_state, serving_params)
from ..launch.batching import SlotGrid
from .adapt import AdaptConfig, make_chunk_fn
from .session import SessionStatus, StreamSession, WindowPrediction, reset_lane
from .staging import InFlight, LaneRecord, StagedChunk, StagingPipeline
from .telemetry import FleetTelemetry


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StreamScheduler:
    """Drives a fleet of :class:`StreamSession`\\ s over one slot grid.

    Args:
      params:   frozen shared base params (stacked dense layout,
        ``core.snn``), on the fleet's device.
      cfg:      the fleet's :class:`SNNConfig`.
      n_slots:  grid width.
      chunk_len: timesteps per grid step.
      adapt:    per-stream delta hygiene (:class:`AdaptConfig`).
      clock_dt_s: virtual seconds per grid step (drives source arrivals).
      telemetry: a :class:`FleetTelemetry` to fill (fresh one by default).
      pipeline_depth: 0 = serial phases, 1 = double-buffered staging.
      device:   where the fleet's tensors live (``"cuda"`` by default).
      topology: optional :class:`TopologyService`, live DSST epochs; it
        must be built for ``cfg``.
      want_factors: the chunk fn's DSST-factor mode; None = True iff a
        non-frozen topology service is attached (which requires it).
      compact:  delta layout; None = compact iff the layer geometry is
        uniform, False = the dense baseline.
    """

    def __init__(self, params, cfg: SNNConfig, n_slots: int,
                 chunk_len: int = 8, adapt: Optional[AdaptConfig] = None,
                 clock_dt_s: float = 0.002,
                 telemetry: Optional[FleetTelemetry] = None,
                 pipeline_depth: int = 0, device="cuda", *, mesh=None,
                 topology=None, want_factors: Optional[bool] = None,
                 compact: Optional[bool] = None, tracer=None, tiers=None,
                 ingest=None, autopilot=None):
        unported = {"mesh": mesh, "tracer": tracer, "tiers": tiers,
                    "ingest": ingest, "autopilot": autopilot}
        for name, value in unported.items():
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"StreamScheduler({name}=...) is not ported yet")
        if pipeline_depth not in (0, 1):
            raise NotImplementedError(
                f"pipeline_depth {pipeline_depth}: only 0 and 1 are ported")
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
        self.device = torch.device(device)
        self.params, self.cfg = params, cfg
        self.topology, self.want_factors = topology, want_factors
        self.compact = engine.geometry(cfg).uniform if compact is None \
            else compact
        self.n_slots, self.chunk_len = n_slots, chunk_len
        self.grid: SlotGrid = SlotGrid(n_slots)
        self.state = init_stream_state(cfg, n_slots, device=self.device)
        self.deltas = init_stream_deltas(cfg, n_slots, device=self.device,
                                         compact=self.compact)
        self.chunk_fn = make_chunk_fn(cfg, adapt, want_factors=want_factors)
        self._fns_run: List[Callable] = []
        self.pipeline = StagingPipeline(depth=pipeline_depth)
        self.clock = 0.0
        self.clock_dt_s = clock_dt_s
        self.telemetry = telemetry or FleetTelemetry()
        self.retired: List[StreamSession] = []
        self._pin = self.device.type == "cuda"
        self._refresh_exec_params()

    def _refresh_exec_params(self) -> None:
        """(Re)derive the weight rep the chunk fn consumes from the dense
        ``self.params`` (the compact rep; the dense layout's adds its
        ``mask_f``) and re-measure the resident bytes. Runs at construction
        and after every topology swap, the only times the base changes."""
        self._exec_params = serving_params(self.params, self.cfg,
                                           compact=self.compact)
        self._params_bytes = sum(_nbytes(t) for t in self._exec_params.values())
        self._delta_bytes = _nbytes(self.deltas)

    def _replace_lanes(self, deltas: torch.Tensor) -> None:
        """Install swapped deltas: a tensor of the live one's shape, dtype
        and device, so the chunk fn takes it as it took the old one."""
        old = self.deltas
        if (deltas.shape, deltas.dtype, deltas.device) != (
                old.shape, old.dtype, old.device):
            raise ValueError(f"swapped deltas {tuple(deltas.shape)} "
                             f"{deltas.dtype} {deltas.device} do not match "
                             f"the fleet's {tuple(old.shape)} {old.dtype} "
                             f"{old.device}")
        self.deltas = deltas

    # -- lifecycle -----------------------------------------------------------
    def submit(self, session: StreamSession) -> None:
        """Queue a session for admission at the next stage phase."""
        session.status = SessionStatus.QUEUED
        if session.n_in is None:
            session.n_in = self.cfg.n_in
        elif session.n_in != self.cfg.n_in:
            raise ValueError(
                f"session {session.sid} n_in={session.n_in} != "
                f"cfg.n_in={self.cfg.n_in}")
        self.grid.submit(session)

    def _admit(self) -> None:
        def on_admit(slot: int, sess: StreamSession):
            sess.slot, sess.status = slot, SessionStatus.ACTIVE
            reset_lane(self.state, self.deltas, self.cfg, slot)
        self.grid.admit(on_admit)

    def _poll_sources(self) -> None:
        """Move newly arrived chunks into session buffers."""
        for sess in list(self.grid.occupant) + list(self.grid.queue):
            if sess is not None and sess.source is not None:
                for chunk in sess.source.poll(self.clock):
                    sess.push_events(chunk)

    def _host_buffer(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pin)

    # -- phase 1: stage ------------------------------------------------------
    def _stage(self) -> StagedChunk:
        """Host-only assembly of one grid step: advance the clock, poll the
        sources, admit into free lanes, pack the buffers, and decide which
        sessions exhaust after this step."""
        t0 = time.perf_counter()
        self.clock += self.clock_dt_s
        self._poll_sources()
        self._admit()
        C, S = self.chunk_len, self.n_slots
        events_t = self._host_buffer((C, S, self.cfg.n_in), torch.float32)
        valid_t = self._host_buffer((C, S), torch.bool)
        amask_t = self._host_buffer((S,), torch.bool)
        events, valid, amask = events_t.numpy(), valid_t.numpy(), amask_t.numpy()
        lanes: List[LaneRecord] = []
        retiring = []
        fed: Dict[int, int] = {}
        for slot, sess in enumerate(self.grid.occupant):
            if sess is None:
                continue
            chunk = sess.pop_chunk(C)
            n = chunk.shape[0]
            if n:
                events[:n, slot] = chunk
                valid[:n, slot] = True
            amask[slot] = sess.adapt
            fed[slot] = n
            lanes.append(LaneRecord(slot=slot, session=sess, n_fed=n,
                                    events_in=float(chunk.sum())))
            if sess.exhausted:        # a host fact: source done, buffers empty
                retiring.append((slot, sess))
        gone = {slot for slot, _ in retiring}
        merge_slots = tuple(
            slot for slot, sess in enumerate(self.grid.occupant)
            if sess is not None and sess.adapt and slot not in gone)
        self.telemetry.record_phase("stage", time.perf_counter() - t0)
        return StagedChunk(events=events_t, valid=valid_t, adapt_mask=amask_t,
                           lanes=lanes, retiring=retiring,
                           merge_slots=merge_slots, fed=fed)

    # -- phase 2: dispatch ---------------------------------------------------
    def _dispatch(self, staged: StagedChunk) -> InFlight:
        """Enqueue the chunk step (no host wait), copy the lanes the retire
        phase will read, then free retiring sessions' lanes so the next
        stage phase can re-admit into them."""
        t0 = time.perf_counter()
        dev = self.device
        events = staged.events.to(dev, non_blocking=True)
        valid = staged.valid.to(dev, non_blocking=True)
        amask = staged.adapt_mask.to(dev, non_blocking=True)
        if not any(fn is self.chunk_fn for fn in self._fns_run):
            self._fns_run.append(self.chunk_fn)
        self.deltas, self.state, metrics = self.chunk_fn(
            self._exec_params, self.deltas, self.state, events, valid, amask)
        final = None
        if staged.retiring:
            # a copy: a later stage may reset these lanes in place before
            # this step retires
            slots = torch.tensor([s for s, _ in staged.retiring],
                                 dtype=torch.long, pin_memory=self._pin)
            slots = slots.to(dev, non_blocking=True)
            final = self.deltas.index_select(0, slots)
        self.grid.tick()
        for slot, _ in staged.retiring:
            self.grid.retire(slot)
        fl = InFlight(staged=staged, final_deltas=final, metrics=metrics,
                      grid_step=self.grid.stats["steps"])
        self.telemetry.record_phase("dispatch", time.perf_counter() - t0)
        return fl

    # -- phase 3: retire -----------------------------------------------------
    def _fetch(self, fl: InFlight):
        """The one device-to-host transfer of a step: every metric (and the
        retiring lanes) flattened into one f32 buffer, one ``.cpu()``."""
        named = [(k, v) for k, v in fl.metrics._asdict().items()
                 if v is not None]
        if fl.final_deltas is not None:
            named.append(("final_deltas", fl.final_deltas))
        flat = torch.cat([v.reshape(-1).to(torch.float32) for _, v in named])
        host = flat.cpu().numpy()
        out, off = {}, 0
        for k, v in named:
            n = v.numel()
            a = host[off:off + n].reshape(tuple(v.shape))
            out[k] = a.astype(bool) if v.dtype == torch.bool else a
            off += n
        return out

    def _retire(self, fl: InFlight) -> None:
        """Consume one in-flight step: fetch (the only device wait), route
        window predictions, fold telemetry, finalize retiring sessions."""
        t0 = time.perf_counter()
        m = self._fetch(fl)
        wait_s = time.perf_counter() - t0
        self.telemetry.record_overlap(hidden_s=fl.queued_s, wait_s=wait_s)
        logits, wend = m["logits"], m["window_end"]           # [C,S,·], [C,S]
        for rec in fl.staged.lanes:
            slot, sess = rec.slot, rec.session
            sess.timesteps_fed += rec.n_fed
            self.telemetry.stream(sess.sid).add_chunk(
                steps=m["steps"][slot], events_in=rec.events_in,
                sop_forward=m["sop_forward"][slot], sop_wu=m["sop_wu"][slot],
                sop_wu_offered=m["sop_wu_offered"][slot],
                gate_opened=m["gate_opened"][slot].sum(),
                gate_offered=m["gate_offered"][slot].sum(),
                windows=int(wend[:, slot].sum()),
                local_loss=m["local_loss"][slot])
            for t in np.nonzero(wend[:, slot])[0]:
                sess.predictions.append(WindowPrediction(
                    window_idx=len(sess.predictions),
                    logits=logits[t, slot].copy()))
        for i, (slot, sess) in enumerate(fl.staged.retiring):
            sess.final_deltas = m["final_deltas"][i].copy()
            sess.status, sess.slot = SessionStatus.RETIRED, None
            self.retired.append(sess)
        svc = self.topology
        if svc is not None and not svc.frozen and "pre_mag" in m:
            svc.observe(ChunkMetrics(**{f: m.get(f)
                                        for f in ChunkMetrics._fields}))
            self.maybe_evolve_topology(merge_slots=fl.staged.merge_slots,
                                       grid_step=fl.grid_step)
        self.telemetry.record_phase("retire", time.perf_counter() - t0)

    # -- the one grid step ---------------------------------------------------
    def step(self) -> Dict[int, int]:
        """One grid step; returns {slot: timesteps fed} for the step staged
        (and dispatched) by this call. Pipelined, its bookkeeping lands one
        ``step()`` later or at :meth:`flush`."""
        t0 = time.perf_counter()
        self.telemetry.record_bytes_held(self._params_bytes, self._delta_bytes)
        staged = self._stage()
        if self.pipeline.depth == 0:
            self._retire(self._dispatch(staged))
        else:
            while self.pipeline.full:
                self._retire(self.pipeline.pop())
            self.pipeline.push(self._dispatch(staged))
        self.telemetry.record_step(time.perf_counter() - t0)
        return staged.fed

    def flush(self) -> None:
        """Retire every in-flight step (no-op in serial mode)."""
        while len(self.pipeline):
            t0 = time.perf_counter()
            self._retire(self.pipeline.pop())
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
        step = self.grid.stats["steps"] if grid_step is None else grid_step
        if svc is None or not (force or svc.due(step)):
            return None
        if merge_slots is None:
            merge_slots = tuple(
                slot for slot, sess in enumerate(self.grid.occupant)
                if sess is not None and sess.adapt)
        t0 = time.perf_counter()
        params, deltas, event = svc.evolve(self.params, self.deltas,
                                           merge_slots=merge_slots,
                                           grid_step=step)
        self.params = params
        self._replace_lanes(deltas)
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
        while not self.grid.drained:
            self.step()
            if self.grid.stats["steps"] >= max_steps:
                break
        self.flush()
        return self.retired

    # -- introspection -------------------------------------------------------
    @property
    def drained(self) -> bool:
        """No session queued or active and no step in flight."""
        return self.grid.drained and len(self.pipeline) == 0

    @property
    def n_compiles(self) -> int:
        """Distinct chunk fns this scheduler's grid steps have run, however
        they were built: 0 before the first step, then 1 for the life of
        the fleet, topology swaps included. The counterpart of the
        reference's one-trace-per-geometry guarantee."""
        return len(self._fns_run)

    @property
    def utilization(self) -> float:
        """Mean fraction of lanes occupied at dispatch."""
        return self.grid.utilization
