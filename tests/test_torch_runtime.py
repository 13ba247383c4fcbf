"""The port's serving runtime: QoS tiers, async ingestion, pipeline depths
above 1, the depth autopilot and the scheduler's span tracer.

Against the reference (same weights, same numpy event streams): a mixed
fleet (``ReplaySource``, ``TaskStreamSource``, ``AERStreamSource``) served
with ingestion on, pipeline depth 2 and two tiers through both schedulers;
window predictions agree in argmax, logits and final deltas within
``atol = 1e-4`` and each stream's counters within ``rtol = 1e-5`` (the
tolerances of tests/test_torch_serving.py: two frameworks' rounding over a
trajectory). Host-only helpers with no floating-point work of their own
(``pack_events``, ``unpack_events``, ``DelayBuffer``, the AER codec and
source, the ingest worker's drains, the autopilot's decisions, the tier
telemetry) must equal the reference's exactly.

Within the port, with no tolerance (bit for bit), as the reference's own
tests hold it (tests/test_serving_qos.py, test_serving_pipeline.py,
test_obs_serving.py): ingestion ≡ inline polling, at depths 1 and 2 and
under thread-switch stress; depths 2 and 3 ≡ serial; an adaptive run ≡
every fixed depth it visited; a tiered fleet ≡ single-grid schedulers with
each tier's geometry; tracing on ≡ off. Every wait on an ingest worker
has a timeout and every scheduler with a worker is closed in a
``finally``, so a failing test fails instead of hanging.
"""
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import snn as jsnn
from repro.data import events as jevents
from repro.obs import Tracer as JTracer
from repro.serving import AERStreamSource as JAERStreamSource
from repro.serving import AutopilotConfig as JAutopilotConfig
from repro.serving import DepthAutopilot as JDepthAutopilot
from repro.serving import IngestConfig as JIngestConfig
from repro.serving import IngestWorker as JIngestWorker
from repro.serving import ReplaySource as JReplaySource
from repro.serving import StreamScheduler as JStreamScheduler
from repro.serving import StreamSession as JStreamSession
from repro.serving import TaskStreamSource as JTaskStreamSource
from repro.serving import TierConfig as JTierConfig
from repro.serving import aer_decode as jaer_decode
from repro.serving import aer_encode as jaer_encode
from repro.serving.stream_source import ArrivalConfig as JArrivalConfig
from repro.serving.telemetry import FleetTelemetry as JFleetTelemetry
from repro_torch import convert
from repro_torch.core.dsst import DSSTConfig
from repro_torch.core.snn import SNNConfig, init_params
from repro_torch.data import events
from repro_torch.data.events import make_task
from repro_torch.obs import Tracer, parse_prometheus_text, prometheus_text
from repro_torch.obs.metrics import LATENCY_BUCKETS_S
from repro_torch.serving import (AERStreamSource, ArrivalConfig,
                                 AutopilotConfig, DepthAutopilot,
                                 IngestConfig, IngestWorker, ReplaySource,
                                 SessionStatus, StreamScheduler,
                                 StreamSession, TaskStreamSource, TierConfig,
                                 TopologyService, TopologyServiceConfig,
                                 aer_decode, aer_encode)
from repro_torch.serving.staging import InFlight, StagedChunk, StagingPipeline
from repro_torch.serving.telemetry import FleetTelemetry

torch.set_num_threads(1)

KW = dict(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=16)
CFG = SNNConfig(**KW)
EVOLVE_CFG = SNNConfig(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=12,
                       dsst=DSSTConfig(period=4, prune_frac=0.5))
JOIN_S = 10.0      # every thread join and poll-wait in this file is bounded

# jittered arrivals: ragged chunks, bursty gaps
JITTER = dict(min_chunk=3, max_chunk=13, mean_gap_s=0.004, start_jitter_s=0.02)

COUNTERS = ("timesteps", "events_in", "sop_forward", "sop_wu",
            "sop_wu_offered", "gate_opened", "gate_offered", "windows",
            "local_loss")


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, device="cpu")


def _events(seed, t, rate=0.25):
    rng = np.random.default_rng(seed)
    return (rng.random((t, CFG.n_in)) < rate).astype(np.float32)


def _mixed_sessions(n=4, ref=False):
    """A fleet mixing replay, jittered-task and AER-packed sources, built
    from the port's classes or (``ref``) from the reference's."""
    if ref:
        mk_task, arrival = jevents.make_task, JArrivalConfig(**JITTER)
        replay, task_src, aer, session = (JReplaySource, JTaskStreamSource,
                                          JAERStreamSource, JStreamSession)
    else:
        mk_task, arrival = make_task, ArrivalConfig(**JITTER)
        replay, task_src, aer, session = (ReplaySource, TaskStreamSource,
                                          AERStreamSource, StreamSession)
    task = mk_task("gesture", n_in=CFG.n_in, t_steps=CFG.t_steps)
    out = []
    for sid in range(n):
        if sid % 3 == 0:
            src = replay(_events(sid, (2 + sid % 2) * CFG.t_steps,
                                 rate=0.25 + 0.03 * sid), chunk_len=7)
        elif sid % 3 == 1:
            src = task_src(task, n_windows=2, seed=sid, arrival=arrival)
        else:
            src = aer(task, n_windows=2, seed=sid, arrival=arrival)
        out.append(session(sid=sid, source=src, adapt=(sid % 2 == 0)))
    return out


def _serve(sched, sessions, tier_of=None):
    """Submit, drain and close (in a ``finally``); {sid: session}."""
    try:
        for s in sessions:
            sched.submit(s, tier=None if tier_of is None else tier_of(s.sid))
        return {s.sid: s for s in sched.run_until_drained()}
    finally:
        sched.close()


def _run_fleet(params, sessions, cfg=CFG, **kw):
    sched = StreamScheduler(params, cfg, device="cpu", **kw)
    return _serve(sched, sessions), sched


def _assert_fleet_identical(a, b):
    """Bit-for-bit per-stream identity: fed timesteps, predictions, final
    deltas."""
    assert set(a) == set(b)
    for sid in a:
        sa, sb = a[sid], b[sid]
        assert sa.timesteps_fed == sb.timesteps_fed, sid
        assert len(sa.predictions) == len(sb.predictions), sid
        for pa, pb in zip(sa.predictions, sb.predictions):
            np.testing.assert_array_equal(pa.logits, pb.logits)
        np.testing.assert_array_equal(sa.final_deltas, sb.final_deltas)


@pytest.fixture(scope="module")
def serial4(params):
    return _run_fleet(params, _mixed_sessions(4), n_slots=2, chunk_len=6)[0]


@pytest.fixture(scope="module")
def serial6(params):
    return _run_fleet(params, _mixed_sessions(6), n_slots=2, chunk_len=6)[0]


# ------------------------------------------------------ against the reference

TIERS = [("interactive", 4, 2), ("bulk", 12, 2)]


def test_fleet_with_ingest_depth2_tiers_matches_reference():
    jcfg = jsnn.SNNConfig(**KW)
    jparams = jax.device_get(jsnn.init_params(jax.random.PRNGKey(0), jcfg))
    kw = dict(n_slots=2, ingest=True, pipeline_depth=2)
    jsched = JStreamScheduler(jparams, jcfg,
                              tiers=[JTierConfig(*t) for t in TIERS], **kw)
    tsched = StreamScheduler(convert.params_from_numpy(jparams, CFG, "cpu"),
                             CFG, tiers=[TierConfig(*t) for t in TIERS],
                             device="cpu", **kw)

    def tier_of(sid):
        return "interactive" if sid % 2 else "bulk"
    want = _serve(jsched, _mixed_sessions(6, ref=True), tier_of)
    got = _serve(tsched, _mixed_sessions(6), tier_of)
    assert tsched.tiers == jsched.tiers == ("interactive", "bulk")
    for name, _, _ in TIERS:
        assert tsched.tier_grid(name).stats == jsched.tier_grid(name).stats
    assert tsched.n_compiles_by_tier == {"interactive": 1, "bulk": 1}
    assert sorted(got) == sorted(want) == list(range(6))
    for sid in want:
        a, b = got[sid], want[sid]
        assert a.tier == b.tier and a.timesteps_fed == b.timesteps_fed
        assert len(a.predictions) == len(b.predictions) > 0
        for pa, pb in zip(a.predictions, b.predictions):
            assert pa.label == pb.label
            np.testing.assert_allclose(pa.logits, pb.logits, atol=1e-4)
        np.testing.assert_allclose(a.final_deltas, b.final_deltas, atol=1e-4)
        tc, jc = tsched.telemetry.stream(sid), jsched.telemetry.stream(sid)
        for attr in COUNTERS:
            np.testing.assert_allclose(getattr(tc, attr), getattr(jc, attr),
                                       rtol=1e-5, err_msg=attr)
    tp, jp = tsched.telemetry.per_tier(), jsched.telemetry.per_tier()
    assert sorted(tp) == sorted(jp) == ["bulk", "interactive"]
    for name in jp:
        for key in ("timesteps", "events_in", "windows"):
            np.testing.assert_allclose(tp[name][key], jp[name][key],
                                       rtol=1e-5)
    tr, jr = tsched.telemetry.tier_rollup(), jsched.telemetry.tier_rollup()
    assert tr["ingest_chunks"] == jr["ingest_chunks"] > 0
    assert tsched.ingest.stats()["attached"] == 0


@pytest.mark.parametrize("shape", [(10, 100), (3, 30), (7, 512), (1, 1)])
def test_pack_unpack_events_equal_reference(shape):
    rng = np.random.default_rng(shape[1])
    spikes = (rng.random(shape) < 0.2).astype(np.float32)
    packets = events.pack_events(spikes)
    want = jevents.pack_events(spikes)
    assert packets.dtype == want.dtype and packets.shape == want.shape
    np.testing.assert_array_equal(packets, want)
    assert packets.shape == (shape[0], -(-shape[1] // events.PAYLOAD_BITS))
    back = events.unpack_events(packets, shape[1])
    np.testing.assert_array_equal(back, jevents.unpack_events(want, shape[1]))
    np.testing.assert_array_equal(back, spikes)


def test_delay_buffer_equals_reference():
    buf, jbuf = events.DelayBuffer(8), jevents.DelayBuffer(8)
    rng = np.random.default_rng(0)
    for step in range(12):
        x = (rng.random(8) < 0.4).astype(np.float32)
        taps = ((0, 1, 2, 3), (0, 2, 3, 1))[step % 2]
        got, want = buf.push(x, delay_taps=taps), jbuf.push(x, delay_taps=taps)
        np.testing.assert_array_equal(got, want)
    assert buf.push(np.zeros(8, np.float32)).dtype == \
        jbuf.push(np.zeros(8, np.float32)).dtype


@pytest.mark.parametrize("shape,rate", [((13, 32), 0.2), ((4, 512), 0.05),
                                        ((6, 16), 0.0)])
def test_aer_codec_equals_reference(shape, rate):
    chunk = (np.random.default_rng(1).random(shape) < rate).astype(np.float32)
    enc, jenc = aer_encode(chunk), jaer_encode(chunk)
    assert enc[:2] == jenc[:2] == shape
    for a, b in zip(enc[2:], jenc[2:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    dec = aer_decode(*enc)
    np.testing.assert_array_equal(dec, jaer_decode(*jenc))
    np.testing.assert_array_equal(dec, chunk)


@pytest.mark.parametrize("task_name", ["nav_cue", "gesture"])
def test_aer_source_polls_equal_reference_and_dense_twin(task_name):
    """Poll for poll: the port's AER source against the reference's and
    against its own dense twin, chunks bit for bit at the same times."""
    task = make_task(task_name, n_in=CFG.n_in, t_steps=CFG.t_steps)
    jtask = jevents.make_task(task_name, n_in=CFG.n_in, t_steps=CFG.t_steps)
    aer = AERStreamSource(task, 3, seed=5, arrival=ArrivalConfig(**JITTER))
    dense = TaskStreamSource(task, 3, seed=5, arrival=ArrivalConfig(**JITTER))
    jaer = JAERStreamSource(jtask, 3, seed=5, arrival=JArrivalConfig(**JITTER))
    assert aer.n_timesteps == dense.n_timesteps == jaer.n_timesteps
    np.testing.assert_array_equal(aer.labels, jaer.labels)
    np.testing.assert_array_equal(aer.labels, dense.labels)
    now, polls = 0.0, 0
    while not dense.exhausted:
        now += 0.002
        a, d, j = aer.poll(now), dense.poll(now), jaer.poll(now)
        assert len(a) == len(d) == len(j)
        for ca, cd, cj in zip(a, d, j):
            np.testing.assert_array_equal(ca, cd)
            np.testing.assert_array_equal(ca, cj)
        polls += len(a)
    assert aer.exhausted and jaer.exhausted and polls > 3


def test_ingest_worker_drains_equal_reference():
    """Tick by tick, the port's worker releases the same chunks in the same
    order as the reference's, however far either thread polled ahead."""
    cfg = dict(capacity_chunks=4, lookahead_ticks=3)
    w, jw = (IngestWorker(0.002, IngestConfig(**cfg)),
             JIngestWorker(0.002, JIngestConfig(**cfg)))
    try:
        port, ref = _mixed_sessions(6), _mixed_sessions(6, ref=True)
        for s, js in zip(port, ref):
            w.attach(s)
            jw.attach(js)
        for tick in range(1, 40):
            assert w.drain(tick)[0] == jw.drain(tick)[0]
            for s, js in zip(port, ref):
                assert len(s._pending) == len(js._pending), (tick, s.sid)
                for a, b in zip(s._pending, js._pending):
                    np.testing.assert_array_equal(a, b)
                s._pending.clear()
                js._pending.clear()
        st = w.stats()
        assert st["queue_peak"] <= 4 and st["attached"] == 6
        assert all(s.source.exhausted and not w.has_pending(s.sid)
                   for s in port)
    finally:
        w.stop()
        jw.stop()
    assert not (w._thread and w._thread.is_alive())


def test_autopilot_decisions_equal_reference():
    """One seeded overlap sequence (numpy) through both controllers: the
    EMA, every proposed depth, the timeline and the decision spans."""
    acfg = dict(max_depth=3, decide_every=2, hold_steps=5, warmup_obs=2,
                deepen_above=0.55, relax_below=0.2)
    tr, jtr = Tracer(), JTracer()
    ap = DepthAutopilot(AutopilotConfig(**acfg), tracer=tr)
    jap = JDepthAutopilot(JAutopilotConfig(**acfg), tracer=jtr)
    rng = np.random.default_rng(7)
    ratios = np.clip(np.concatenate([rng.normal(0.8, 0.15, 60),
                                     rng.normal(0.05, 0.05, 60),
                                     rng.random(60)]), 0.0, 1.0)
    depth, jdepth = 0, 0
    ap.note_depth(0, depth)
    jap.note_depth(0, jdepth)
    for step, r in enumerate(ratios, start=1):
        assert ap.observe(float(r)) == jap.observe(float(r))
        depth, jdepth = ap.decide(step, depth), jap.decide(step, jdepth)
        assert depth == jdepth, step
        ap.note_depth(step, depth)
        jap.note_depth(step, jdepth)
    assert list(ap.timeline) == list(jap.timeline)
    assert ap.decisions == jap.decisions >= 3
    assert ap.depths_visited() == jap.depths_visited() == (0, 1, 2, 3)
    assert [s.attrs for s in tr.spans("autopilot.decision")] == \
        [s.attrs for s in jtr.spans("autopilot.decision")]


def test_tier_telemetry_equals_reference():
    """The same recording sequence gives the same tier rollup, tier
    percentiles and per-tier energy as the reference's telemetry."""
    tel, jtel = FleetTelemetry(), JFleetTelemetry()
    rng = np.random.default_rng(3)
    for i in range(50):
        tier = ("interactive", "bulk")[i % 2]
        kw = dict(timesteps=float(rng.integers(0, 96)),
                  events_in=float(rng.integers(0, 900)),
                  sop_forward=float(rng.integers(0, 10 ** 6)),
                  sop_wu=float(rng.integers(0, 1000)),
                  sop_wu_offered=float(rng.integers(1000, 3000)),
                  windows=int(rng.integers(0, 3)))
        wall = float(np.exp(rng.normal(np.log(4e-3), 0.7)))
        drained = int(rng.integers(0, 9))
        for t in (tel, jtel):
            t.record_tier_chunk(tier, **kw)
            t.record_tier_step(tier, wall)
            t.record_tier_phase(tier, "stage", wall / 3)
            t.record_ingest(drained, 5)
            t.record_depth(i % 3, changed=i % 7 == 0)
            t.record_overlap_ema(wall * 100)
    assert tel.tier_rollup() == jtel.tier_rollup()
    assert tel.per_tier() == jtel.per_tier()
    assert tel.tier_percentiles() == jtel.tier_percentiles()
    for fam in ("serving_tier_phase_seconds", "serving_overlap_ema",
                "serving_pipeline_depth_changes_total",
                "serving_ingest_drained_chunks"):
        assert tel.registry.snapshot()[fam] == jtel.registry.snapshot()[fam]


# ------------------------------------------------------- async ingestion

def test_ingest_bit_identical_to_serial(params, serial4):
    got, sched = _run_fleet(params, _mixed_sessions(4), n_slots=2,
                            chunk_len=6, ingest=True)
    _assert_fleet_identical(serial4, got)
    st = sched.ingest.stats()
    assert st["chunks_queued"] > 0          # the worker actually worked
    assert st["attached"] == 0              # every stream detached at retire
    assert sched.telemetry.tier_rollup()["ingest_chunks"] > 0
    assert not sched.ingest._thread.is_alive()      # close() joined it


def test_ingest_with_depth2_bit_identical(params, serial4):
    got, sched = _run_fleet(params, _mixed_sessions(4), n_slots=2,
                            chunk_len=6, ingest=True, pipeline_depth=2)
    assert sched.pipeline.depth == 2
    _assert_fleet_identical(serial4, got)


def test_ingest_under_thread_switch_stress(params, serial6):
    """Three ingesting fleets served at once from three threads (six
    threads with their workers), with the interpreter switching threads
    every microsecond: each fleet equals the serial run, bit for bit."""
    results, errors = {}, []

    def serve(k):
        try:
            results[k] = _run_fleet(params, _mixed_sessions(6), n_slots=2,
                                    chunk_len=6, ingest=IngestConfig(
                                        capacity_chunks=2, lookahead_ticks=3),
                                    pipeline_depth=k % 3)[0]
        except BaseException as e:          # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads), "a fleet hung"
    assert not errors, errors
    for k in range(3):
        _assert_fleet_identical(serial6, results[k])


def test_eos_exactly_once_with_lookahead(params, serial6):
    """Lookahead polling flips ``source.exhausted`` while the tail chunk
    still sits in the worker queue: each session retires exactly once, with
    its tail fed."""
    got, sched = _run_fleet(params, _mixed_sessions(6), n_slots=2,
                            chunk_len=6, ingest=IngestConfig(
                                capacity_chunks=256, lookahead_ticks=128))
    _assert_fleet_identical(serial6, got)
    sids = [s.sid for s in sched.retired]
    assert sorted(sids) == sorted(set(sids)) == sorted(got)
    for s in sched.retired:
        assert s.status is SessionStatus.RETIRED
        assert s.timesteps_fed == s.source.n_timesteps, s.sid
        assert s._pending == [] and s._ingest is None


def _wait_for(cond):
    deadline = time.monotonic() + JOIN_S
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.001)
    return cond()


def test_session_exhausted_consults_ingest_queue():
    w = IngestWorker(0.002, IngestConfig(capacity_chunks=8,
                                         lookahead_ticks=64))
    try:
        sess = StreamSession(sid=0, source=ReplaySource(_events(0, 24),
                                                        chunk_len=8))
        w.attach(sess)
        assert _wait_for(lambda: sess.source.exhausted)   # lookahead ran on
        assert w.has_pending(0)
        assert not sess.exhausted         # the queued tail counts
        w.drain(64)
        assert not w.has_pending(0)
        assert sess.pending_timesteps() == 24
        sess.pop_chunk(24)
        assert sess.exhausted
        w.detach(sess)
    finally:
        w.stop()


def test_detach_with_undrained_chunks_raises():
    w = IngestWorker(0.002, IngestConfig(lookahead_ticks=64))
    try:
        sess = StreamSession(sid=0, source=ReplaySource(_events(1, 24),
                                                        chunk_len=8))
        w.attach(sess)
        assert _wait_for(lambda: w.has_pending(0))
        with pytest.raises(RuntimeError, match="undrained"):
            w.detach(sess)
    finally:
        w.stop()


def test_bounded_queue_backpressure():
    """With no drain published the worker queues a stream at most
    ``capacity_chunks`` deep and parks; a drain un-parks it."""
    cap = 3
    w = IngestWorker(0.002, IngestConfig(capacity_chunks=cap,
                                         lookahead_ticks=100))
    try:
        sess = StreamSession(sid=0, source=ReplaySource(_events(2, 400),
                                                        chunk_len=8))
        w.attach(sess)
        assert _wait_for(lambda: w.stats()["chunks_queued"] >= cap)
        time.sleep(0.02)                  # rope to overshoot
        st = w.stats()
        assert st["queue_peak"] == cap, st
        assert st["chunks_queued"] == cap, "a parked stream was polled"
        pushed, peak = w.drain(1)
        assert pushed == 1 and peak == cap
        assert _wait_for(lambda: w.stats()["chunks_queued"] >= cap + 1)
        assert w.stats()["queue_peak"] == cap
    finally:
        w.stop()


def test_backpressure_invariant_via_telemetry(params):
    cap = 2
    _, sched = _run_fleet(params, _mixed_sessions(4), n_slots=2, chunk_len=6,
                          ingest=IngestConfig(capacity_chunks=cap,
                                              lookahead_ticks=16))
    roll = sched.telemetry.tier_rollup()
    assert 0 < roll["ingest_queue_peak"] <= cap
    fam = sched.telemetry.registry.get("serving_ingest_queue_peak_chunks")
    assert fam is not None and fam.value <= cap


def test_ingest_config_validation(params):
    with pytest.raises(ValueError):
        IngestConfig(capacity_chunks=0)
    with pytest.raises(ValueError):
        IngestConfig(lookahead_ticks=0)
    w = IngestWorker(0.002)
    try:
        s = StreamSession(sid=7, source=ReplaySource(_events(3, 8)))
        w.attach(s)
        with pytest.raises(ValueError, match="already attached"):
            w.attach(s)
        w.drain(4)
        w.detach(s)
    finally:
        w.stop()
    with pytest.raises(ValueError, match="clock_dt_s"):
        StreamScheduler(params, CFG, n_slots=2, device="cpu",
                        ingest=IngestWorker(0.001))


# ------------------------------------------------------------- autopilot

def test_autopilot_hysteresis_no_oscillation():
    ap = DepthAutopilot(AutopilotConfig(max_depth=3, decide_every=1,
                                        hold_steps=10, warmup_obs=1,
                                        deepen_above=0.6, relax_below=0.05))
    depth, changes = 1, []
    ap.note_depth(0, depth)
    for step in range(1, 200):
        ap.observe(0.9 if step % 2 else 0.1)   # violently noisy signal
        new = ap.decide(step, depth)
        if new != depth:
            changes.append(step)
            ap.note_depth(step, new)
            depth = new
    for a, b in zip(changes, changes[1:]):
        assert b - a >= 10, f"changes {a}->{b} inside the hold window"
    assert len(changes) <= 2, changes


def test_autopilot_bounds_and_probe():
    cfg = AutopilotConfig(max_depth=2, decide_every=1, hold_steps=1,
                          warmup_obs=1, deepen_above=0.5, relax_below=0.2)
    ap = DepthAutopilot(cfg)
    ap.note_depth(0, 0)
    assert ap.decide(1, 0) == 0            # warming up: no observations yet
    ap.observe(0.0)
    depth = ap.decide(2, 0)
    assert depth == 1                      # serial probes regardless of EMA
    ap.note_depth(2, depth)
    for step in range(3, 40):
        ap.observe(1.0)
        depth = ap.decide(step, depth)
        ap.note_depth(step, depth)
    assert depth == cfg.max_depth          # bounded above
    for step in range(40, 120):
        ap.observe(0.0)
        depth = ap.decide(step, depth)
        ap.note_depth(step, depth)
    assert depth == cfg.min_pipelined_depth  # floored, never back to 0
    assert ap.depths_visited() == (0, 1, 2)


def test_autopilot_config_validation():
    with pytest.raises(ValueError):
        AutopilotConfig(min_pipelined_depth=3, max_depth=2)
    with pytest.raises(ValueError):
        AutopilotConfig(deepen_above=0.2, relax_below=0.5)
    with pytest.raises(ValueError):
        AutopilotConfig(ema_alpha=0.0)


def test_set_depth_only_at_drain_safe_boundary():
    p = StagingPipeline(depth=1)
    staged = StagedChunk(events=None, valid=None, adapt_mask=None, lanes=[],
                         retiring=[], merge_slots=(), fed={})
    p.push(InFlight(staged=staged, final_deltas=None, metrics=None,
                    grid_step=1))
    with pytest.raises(RuntimeError, match="flush"):
        p.set_depth(2)
    p.pop()
    p.set_depth(2)
    assert p.depth == 2
    with pytest.raises(ValueError):
        p.set_depth(-1)


def test_adaptive_bit_identical_to_every_fixed_depth(params):
    ap_cfg = AutopilotConfig(max_depth=2, decide_every=1, hold_steps=2,
                             warmup_obs=1, deepen_above=0.0,
                             relax_below=0.0)   # deepen on any overlap > 0
    tr = Tracer(capacity=65536)
    got, sched = _run_fleet(params, _mixed_sessions(6), n_slots=2,
                            chunk_len=6, ingest=True, autopilot=ap_cfg,
                            tracer=tr)
    visited = sched.autopilot.depths_visited()
    assert len(visited) > 1, "the autopilot never moved"
    roll = sched.telemetry.tier_rollup()
    assert roll["depth_changes"] == len(tr.spans("autopilot.apply")) >= 1
    assert roll["pipeline_depth"] == sched.pipeline_depth == visited[-1]
    assert list(sched.autopilot.timeline)[0] == (0, 0)
    assert len(tr.spans("autopilot.decision")) >= 1
    for depth in visited:
        ref, _ = _run_fleet(params, _mixed_sessions(6), n_slots=2,
                            chunk_len=6, pipeline_depth=depth)
        _assert_fleet_identical(ref, got)


def test_autopilot_clamped_by_topology_service():
    p = init_params(0, EVOLVE_CFG, device="cpu")
    svc = TopologyService(EVOLVE_CFG, TopologyServiceConfig(epoch_every=50))
    sched = StreamScheduler(p, EVOLVE_CFG, n_slots=2, chunk_len=6,
                            device="cpu", topology=svc,
                            autopilot=AutopilotConfig(max_depth=3))
    assert sched.autopilot.cfg.max_depth == 1
    sched.close()


# ------------------------------------------------------------------ depth

def _drive(params, cfg, depth, tracer=None, n_streams=5, n_slots=3,
           chunk_len=6, topology_every=0):
    svc = None
    if topology_every:
        svc = TopologyService(cfg, TopologyServiceConfig(
            epoch_every=topology_every, merge_top=1))
    sched = StreamScheduler(params, cfg, n_slots=n_slots, chunk_len=chunk_len,
                            topology=svc, pipeline_depth=depth, tracer=tracer,
                            device="cpu")
    for sid in range(n_streams):
        sched.submit(StreamSession(
            sid=sid,
            source=ReplaySource(_events(sid, (3 + sid % 2) * cfg.t_steps,
                                        rate=0.25 + 0.03 * sid),
                                chunk_len=7),
            adapt=(sid % 2 == 0)))
    done = {s.sid: s for s in sched.run_until_drained()}
    return sched, svc, done


def _assert_runs_identical(a, b):
    """(sched, svc, done) triples: bit-identical per-stream outcomes,
    counters, base params and live deltas."""
    (sa, _, da), (sb, _, db) = a, b
    _assert_fleet_identical(da, db)
    for sid in da:
        assert len(da[sid].predictions) > 0
        ca, cb = sa.telemetry.stream(sid), sb.telemetry.stream(sid)
        for f in COUNTERS:
            assert getattr(ca, f) == getattr(cb, f), (sid, f)
    assert torch.equal(sa.params["hidden"]["w"], sb.params["hidden"]["w"])
    assert torch.equal(sa.params["hidden"]["mask"],
                       sb.params["hidden"]["mask"])
    assert torch.equal(sa.params["readout"], sb.params["readout"])
    assert torch.equal(sa.deltas, sb.deltas)


@pytest.fixture(scope="module")
def frozen_runs(params):
    """The same frozen-fleet workload: serial, depth 1 traced and untraced."""
    return {"serial": _drive(params, CFG, depth=0),
            "off": _drive(params, CFG, depth=1),
            "on": _drive(params, CFG, depth=1, tracer=Tracer(capacity=65536))}


@pytest.fixture(scope="module")
def evolve_runs():
    """The same evolving-fleet workload: serial, depth 1 untraced and
    traced."""
    p = init_params(1, EVOLVE_CFG, device="cpu")
    kw = dict(n_slots=4, topology_every=3)
    return {"serial": _drive(p, EVOLVE_CFG, depth=0, **kw),
            "off": _drive(p, EVOLVE_CFG, depth=1, **kw),
            "on": _drive(p, EVOLVE_CFG, depth=1,
                         tracer=Tracer(capacity=65536), **kw)}


@pytest.mark.parametrize("depth", [2, 3])
def test_deep_pipeline_frozen_fleet_bit_identical_to_serial(params, depth,
                                                            frozen_runs):
    deep = _drive(params, CFG, depth=depth)
    assert deep[0].pipeline.depth == depth and deep[0].n_compiles == 1
    _assert_runs_identical(frozen_runs["serial"], deep)


def test_depth2_with_live_topology_clamped_and_bit_identical(evolve_runs):
    p = init_params(1, EVOLVE_CFG, device="cpu")
    deep = _drive(p, EVOLVE_CFG, depth=2, n_slots=4, topology_every=3)
    assert deep[0].pipeline_depth == deep[0].pipeline.depth == 1
    serial = evolve_runs["serial"]
    assert deep[1].epoch_idx == serial[1].epoch_idx >= 2
    assert [(e.grid_step, e.pruned, e.regrown) for e in deep[1].events] == \
        [(e.grid_step, e.pruned, e.regrown) for e in serial[1].events]
    _assert_runs_identical(serial, deep)


# ------------------------------------------------------------------ tiers

def test_tiered_fleet_matches_single_grid_references(params):
    tiers = [TierConfig("interactive", chunk_len=4, n_slots=2),
             TierConfig("bulk", chunk_len=12, n_slots=2)]

    def tier_of(sid):
        return "interactive" if sid % 2 else "bulk"
    multi = StreamScheduler(params, CFG, n_slots=2, tiers=tiers, ingest=True,
                            device="cpu")
    got = _serve(multi, _mixed_sessions(6), tier_of)
    assert multi.tiers == ("interactive", "bulk")
    assert multi.n_slots == 4 and multi.chunk_len == 4
    assert multi.n_compiles_by_tier == {"interactive": 1, "bulk": 1}
    assert multi.n_compiles == 1
    per_tier = multi.telemetry.per_tier()
    assert set(per_tier) == {"interactive", "bulk"}
    assert per_tier["interactive"]["timesteps"] > 0
    assert set(multi.telemetry.tier_percentiles()) == {"interactive", "bulk"}
    assert multi.tier_grid("bulk") is not multi.grid
    assert multi.drained and 0.0 < multi.utilization <= 1.0

    ref = {}
    for name, C in [("interactive", 4), ("bulk", 12)]:
        solo = StreamScheduler(params, CFG, n_slots=2, chunk_len=C,
                               device="cpu")
        ref.update(_serve(solo, [s for s in _mixed_sessions(6)
                                 if tier_of(s.sid) == name]))
    _assert_fleet_identical(ref, got)


def test_step_returns_fleet_global_slot_ids(params):
    sched = StreamScheduler(params, CFG, n_slots=2, device="cpu",
                            tiers=[TierConfig("a", 4, 2),
                                   TierConfig("b", 8, 3)])
    for sid in range(5):
        sched.submit(StreamSession(sid=sid, source=ReplaySource(
            _events(sid, 16), chunk_len=16)), tier="ab"[sid % 2])
    fed = sched.step()
    # a: global slots 0-1 (sids 0, 2; sid 4 queued), b: 2-4 (sids 1, 3)
    assert fed == {0: 4, 1: 4, 2: 8, 3: 8}
    assert sched.tier_grid("b").occupant[1].sid == 3   # tier-local slot 1
    sched.run_until_drained()


def test_tier_validation(params):
    with pytest.raises(ValueError, match="duplicate"):
        StreamScheduler(params, CFG, n_slots=2, device="cpu",
                        tiers=[TierConfig("a", 4, 2), TierConfig("a", 8, 2)])
    with pytest.raises(ValueError, match="non-empty"):
        StreamScheduler(params, CFG, n_slots=2, device="cpu", tiers=[])
    with pytest.raises(ValueError):
        TierConfig("x", chunk_len=0, n_slots=2)
    with pytest.raises(ValueError):
        TierConfig("x", chunk_len=4, n_slots=0)
    with pytest.raises(ValueError):
        TierConfig("", chunk_len=4, n_slots=2)
    sched = StreamScheduler(params, CFG, n_slots=2, device="cpu",
                            tiers=[TierConfig("a", 4, 2)])
    with pytest.raises(ValueError, match="unknown tier"):
        sched.submit(StreamSession(sid=0, source=ReplaySource(_events(0, 8))),
                     tier="b")


def test_topology_requires_single_tier():
    svc = TopologyService(EVOLVE_CFG, TopologyServiceConfig(epoch_every=50))
    with pytest.raises(ValueError, match="single-tier"):
        StreamScheduler(init_params(0, EVOLVE_CFG, device="cpu"), EVOLVE_CFG,
                        n_slots=2, topology=svc, device="cpu",
                        tiers=[TierConfig("a", 4, 2), TierConfig("b", 8, 2)])


# ---------------------------------------------------------------- tracing

def test_tracing_on_off_bit_identical(frozen_runs):
    off, on = frozen_runs["off"], frozen_runs["on"]
    assert off[0].n_compiles == on[0].n_compiles == 1
    _assert_runs_identical(off, on)
    _assert_runs_identical(frozen_runs["serial"], on)
    assert off[0].tracer.spans() == []          # NULL_TRACER records nothing
    assert on[0].tracer.n_recorded > 0 and on[0].tracer.n_dropped == 0


def test_tracing_on_off_bit_identical_evolving(evolve_runs):
    off, on = evolve_runs["off"], evolve_runs["on"]
    va, vb = off[1], on[1]
    assert va.epoch_idx >= 2 and va.epoch_idx == vb.epoch_idx
    assert [(e.grid_step, e.pruned, e.regrown) for e in va.events] == \
        [(e.grid_step, e.pruned, e.regrown) for e in vb.events]
    _assert_runs_identical(off, on)
    _assert_runs_identical(evolve_runs["serial"], on)


def test_span_taxonomy_one_of_each_phase_per_grid_step(frozen_runs):
    sched = frozen_runs["on"][0]
    tr = sched.tracer
    steps = sched.grid.stats["steps"]
    assert steps >= 4
    for name in ("sched.stage", "sched.dispatch", "sched.retire",
                 "sched.poll_sources", "sched.admit", "sched.device_wait"):
        got = sorted(s.attr("grid_step") for s in tr.spans(name))
        assert got == list(range(1, steps + 1)), (name, got)
    assert len(tr.spans("sched.step")) == steps
    by_id = {s.span_id: s for s in tr.spans()}
    for s in tr.spans("sched.poll_sources") + tr.spans("sched.admit"):
        assert by_id[s.parent_id].name == "sched.stage"
    for s in tr.spans("sched.device_wait"):
        assert by_id[s.parent_id].name == "sched.retire"
    for s in tr.spans("sched.stage") + tr.spans("sched.dispatch"):
        assert s.attr("tier") == "default"


def test_retire_attributed_to_earlier_grid_step_under_pipelining(frozen_runs):
    sched = frozen_runs["on"][0]
    tr = sched.tracer
    by_id = {s.span_id: s for s in tr.spans()}
    crossed = 0
    for s in tr.spans("sched.retire"):
        parent = by_id.get(s.parent_id)
        if parent is not None and parent.name == "sched.step":
            assert parent.attr("grid_step") == s.attr("grid_step") + 1
            crossed += 1
        else:
            assert parent is None       # a flush-time retire has no step
    assert crossed >= 2, "the pipeline never overlapped a retire with a step"
    tel = sched.telemetry
    assert 0.0 < tel.overlap_ratio() <= 1.0
    assert tel.rollup()["overlap_ratio"] == tel.overlap_ratio()


def test_phase_walls_reconcile_with_step_walls(frozen_runs):
    tel = frozen_runs["on"][0].telemetry
    pp = tel.phase_percentiles()
    assert set(pp) >= {"stage", "dispatch", "retire"}
    phases = sum(pp[k]["total_s"] for k in ("stage", "dispatch", "retire"))
    walls = (tel.registry.get("serving_step_latency_seconds").sum
             + tel.registry.get("serving_flush_seconds_total").value)
    assert phases <= walls + 1e-6, (phases, walls)
    assert phases >= 0.7 * walls, (phases, walls)
    for k in ("stage", "dispatch", "retire"):
        assert pp[k]["p99_ms"] >= pp[k]["p50_ms"] > 0.0
    tiers = tel.registry.get("serving_tier_phase_seconds")
    for k in ("stage", "dispatch", "retire"):
        assert tiers.labels(tier="default", phase=k).count == \
            tel.registry.get("serving_phase_seconds").labels(phase=k).count


def test_topology_epoch_spans(evolve_runs):
    sched, svc, _ = evolve_runs["on"]
    spans = sched.tracer.spans("topology.epoch")
    assert len(spans) == svc.epoch_idx >= 2
    for s, e in zip(spans, svc.events):
        assert s.attr("grid_step") == e.grid_step
        assert s.attr("pruned") == e.pruned
        assert s.attr("regrown") == e.regrown
    roll = sched.telemetry.rollup()
    assert roll["topology_epochs"] == svc.epoch_idx
    assert roll["topology_epoch_wall_s"] >= sum(s.dur_s for s in spans)


def test_depth2_tracing_parity_and_spans(params, frozen_runs):
    deep = _drive(params, CFG, depth=2, tracer=Tracer(capacity=65536))
    assert deep[0].pipeline.depth == 2
    _assert_runs_identical(frozen_runs["off"], deep)
    steps = deep[0].grid.stats["steps"]
    for name in ("sched.stage", "sched.retire", "sched.device_wait"):
        got = sorted(s.attr("grid_step")
                     for s in deep[0].tracer.spans(name))
        assert got == list(range(1, steps + 1)), (name, got)
    by_id = {s.span_id: s for s in deep[0].tracer.spans()}
    lags = {by_id[s.parent_id].attr("grid_step") - s.attr("grid_step")
            for s in deep[0].tracer.spans("sched.retire") if s.parent_id}
    assert lags == {2}                  # depth 2: two steps in flight


def test_tiered_spans_one_stage_per_tier_per_grid_step(params):
    tr = Tracer(capacity=65536)
    sched = StreamScheduler(params, CFG, n_slots=2, device="cpu", tracer=tr,
                            tiers=[TierConfig("i", 4, 2),
                                   TierConfig("b", 12, 2)])
    _serve(sched, _mixed_sessions(4), lambda sid: "ib"[sid % 2])
    steps = sched.grid.stats["steps"]
    assert sched.tier_grid("b").stats["steps"] == steps
    for name in ("sched.stage", "sched.dispatch", "sched.retire",
                 "sched.admit"):
        for tier in ("i", "b"):
            got = sorted(s.attr("grid_step") for s in tr.spans(name)
                         if s.attr("tier") == tier)
            assert got == list(range(1, steps + 1)), (name, tier)
    # the clock and the sources: once a grid step, in the first tier's stage
    by_id = {s.span_id: s for s in tr.spans()}
    polls = tr.spans("sched.poll_sources")
    assert len(polls) == steps
    assert {by_id[s.parent_id].attr("tier") for s in polls} == {"i"}
    assert sched.clock == pytest.approx(steps * sched.clock_dt_s)


def test_prometheus_scrape_of_live_run(frozen_runs):
    sched = frozen_runs["on"][0]
    parsed = parse_prometheus_text(prometheus_text(sched.telemetry.registry))
    assert parsed["serving_grid_steps_total"] == sched.grid.stats["steps"]
    assert parsed["serving_step_latency_seconds_count"] == \
        sched.grid.stats["steps"]
    for required in ("serving_overlap_ratio_count",
                     "serving_device_wait_seconds_total",
                     'serving_phase_seconds_count{phase="retire"}',
                     'serving_stream_timesteps_total{sid="0"}',
                     'serving_stream_windows_total{sid="4"}',
                     'serving_tier_step_seconds_count{tier="default"}',
                     'serving_tier_timesteps_total{tier="default"}',
                     "serving_pipeline_depth", "serving_ingest_chunks_total"):
        assert required in parsed, required
    c0 = sched.telemetry.stream(0)
    assert parsed['serving_stream_timesteps_total{sid="0"}'] == c0.timesteps
    assert parsed['serving_tier_timesteps_total{tier="default"}'] == \
        sum(sched.telemetry.stream(s).timesteps for s in range(5))


# ------------------------------------------------------- telemetry

def test_overlap_ratio_accounting():
    tel = FleetTelemetry()
    assert tel.overlap_ratio() == 0.0
    assert tel.record_overlap(0.0, 0.01) == 0.0  # serial: nothing hidden
    assert tel.record_overlap(0.02, 0.01) == pytest.approx(2 / 3)
    assert tel.record_overlap(0.01, 0.0) == 1.0  # fully hidden
    assert tel.overlap_ratio() == pytest.approx(0.03 / 0.05)
    assert tel.registry.get("serving_overlap_ratio").count == 3


def test_fleet_telemetry_memory_is_bounded():
    tel = FleetTelemetry()
    rng = np.random.default_rng(0)
    vals = np.exp(rng.normal(loc=np.log(2e-3), scale=0.8, size=20_000))
    for i, v in enumerate(vals):
        tel.record_step(v)
        tel.record_tier_step(("a", "b")[i % 2], v)
    assert not any(isinstance(v, list) and len(v) > 100
                   for v in vars(tel).values())
    hist = tel.registry.get("serving_step_latency_seconds").labels()
    assert len(hist.bucket_counts()) == len(LATENCY_BUCKETS_S) + 1
    assert hist.count == 20_000 and tel.steps == 20_000
    lp = tel.latency_percentiles()
    for key, q in (("p50_ms", 50), ("p99_ms", 99)):
        exact = float(np.percentile(vals, q)) * 1e3
        assert abs(lp[key] - exact) / exact < 0.12, (key, lp[key], exact)
    assert set(tel.tier_percentiles()) == {"a", "b"}


def test_topology_epoch_log_bounded_rollup_exact():
    tel = FleetTelemetry(max_epoch_events=32)
    n = 500
    for i in range(n):
        tel.record_topology_epoch(grid_step=i, pruned=2, regrown=1,
                                  mask_change=0.01 * (i % 7),
                                  merged_streams=i % 2)
    assert len(tel.topology_epochs) == 32
    assert tel.topology_epochs[-1]["grid_step"] == n - 1
    r = tel.topology_rollup()
    assert r["topology_epochs"] == n
    assert r["topology_pruned"] == 2 * n and r["topology_regrown"] == n
    assert r["streams_merged"] == sum(i % 2 for i in range(n))
    exact_mean = sum(0.01 * (i % 7) for i in range(n)) / n
    assert r["topology_mask_change_mean"] == pytest.approx(exact_mean)


def test_fleet_telemetry_thread_safe_mutation():
    """Racing threads on ``stream()`` creation, epoch recording and tier
    counters lose nothing."""
    tel = FleetTelemetry()
    n_threads, per_thread, sids = 8, 50, range(6)
    seen = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads)

    def worker(t):
        start.wait(timeout=JOIN_S)
        for i in range(per_thread):
            seen[t].append(tel.stream(sids[i % len(sids)]))
            tel.record_topology_epoch(grid_step=i, pruned=1, regrown=1,
                                      mask_change=0.0, merged_streams=0)
            tel.record_tier_chunk("t", timesteps=1, events_in=0,
                                  sop_forward=0, sop_wu=0, sop_wu_offered=0,
                                  windows=1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert sorted(tel.streams) == list(sids)
    for t in range(n_threads):
        for i, rec in enumerate(seen[t]):
            assert rec is tel.streams[sids[i % len(sids)]]
    assert tel.topology_rollup()["topology_epochs"] == n_threads * per_thread
    assert tel.per_tier()["t"]["windows"] == n_threads * per_thread
