"""The port's stream scheduler, against the JAX reference and against itself.

Against the reference (same weights, same ``ReplaySource`` events): window
predictions must agree in argmax and their logits within ``atol = 1e-4``,
the trajectory tolerance of tests/test_torch_engine.py (rounding
differences between two frameworks, accumulated over windows); each
stream's telemetry counters and energy report within ``rtol = 1e-5`` (f32
sums of the same per-step counts; the local loss carries the trajectory's
rounding).

Within the port, with no tolerance at all (bit-exact): pipeline depth 0 and
1 give identical predictions, final deltas and counters, and a stream
served beside others in a grid gives exactly what it gives alone in a grid
of the same width.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import snn as jsnn
from repro.serving import AdaptConfig as JAdaptConfig
from repro.serving import ReplaySource as JReplaySource
from repro.serving import StreamScheduler as JStreamScheduler
from repro.serving import StreamSession as JStreamSession
from repro_torch import convert
from repro_torch.core.snn import SNNConfig, init_params
from repro_torch.data.events import make_task
from repro_torch.serving import (AdaptConfig, ReplaySource, StreamScheduler,
                                 StreamSession, TaskStreamSource, delta_norms,
                                 make_chunk_fn)

torch.set_num_threads(1)

KW = dict(n_in=16, n_hidden=16, n_layers=2, n_out=4, t_steps=6)
CFG = SNNConfig(**KW)


def _events(seed, t, rate=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((t, 16)) < rate).astype(np.float32)


STREAMS = [(0, _events(1, 12), 5), (1, _events(2, 18, 0.4), 4),
           (2, _events(3, 12, 0.2), 7)]


def test_scheduler_predictions_match_reference():
    jcfg = jsnn.SNNConfig(**KW)
    jparams = jax.device_get(jsnn.init_params(jax.random.PRNGKey(0), jcfg))
    jsched = JStreamScheduler(jparams, jcfg, n_slots=2, chunk_len=4)
    tsched = StreamScheduler(convert.params_from_numpy(jparams, CFG, "cpu"),
                             CFG, n_slots=2, chunk_len=4, device="cpu")
    for sid, ev, cl in STREAMS:
        jsched.submit(JStreamSession(sid=sid, source=JReplaySource(ev, cl)))
        tsched.submit(StreamSession(sid=sid, source=ReplaySource(ev, cl)))
    want = {s.sid: s for s in jsched.run_until_drained()}
    got = {s.sid: s for s in tsched.run_until_drained()}
    assert tsched.grid.stats == jsched.grid.stats
    for sid, ev, _ in STREAMS:
        assert len(got[sid].predictions) == len(want[sid].predictions) \
            == ev.shape[0] // CFG.t_steps
        for a, b in zip(got[sid].predictions, want[sid].predictions):
            assert a.label == b.label
            np.testing.assert_allclose(a.logits, b.logits, atol=1e-4)
        np.testing.assert_allclose(got[sid].final_deltas,
                                   want[sid].final_deltas, atol=1e-4)
        assert tsched.telemetry.stream(sid).timesteps == ev.shape[0]


COUNTERS = ("timesteps", "events_in", "sop_forward", "sop_wu",
            "sop_wu_offered", "gate_opened", "gate_offered", "local_loss")


def test_stream_counters_and_energy_match_reference():
    """Per-stream telemetry and its energy report against the reference, on
    a fleet with decay, clip and one frozen stream (it adapts nothing and is
    billed no weight updates)."""
    jcfg = jsnn.SNNConfig(**KW)
    jparams = jax.device_get(jsnn.init_params(jax.random.PRNGKey(1), jcfg))
    kw = dict(delta_decay=0.9, delta_clip=0.05)
    jsched = JStreamScheduler(jparams, jcfg, n_slots=2, chunk_len=4,
                              adapt=JAdaptConfig(**kw))
    tsched = StreamScheduler(convert.params_from_numpy(jparams, CFG, "cpu"),
                             CFG, n_slots=2, chunk_len=4, device="cpu",
                             adapt=AdaptConfig(**kw))
    for sid, ev, cl in STREAMS:
        jsched.submit(JStreamSession(sid=sid, source=JReplaySource(ev, cl),
                                     adapt=sid != 1))
        tsched.submit(StreamSession(sid=sid, source=ReplaySource(ev, cl),
                                    adapt=sid != 1))
    want = {s.sid: s for s in jsched.run_until_drained()}
    got = {s.sid: s for s in tsched.run_until_drained()}
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for sid, _, _ in STREAMS:
        assert [p.label for p in got[sid].predictions] == \
            [p.label for p in want[sid].predictions]
        tc, jc = tsched.telemetry.stream(sid), jsched.telemetry.stream(sid)
        for attr in COUNTERS:
            np.testing.assert_allclose(getattr(tc, attr), getattr(jc, attr),
                                       rtol=1e-5, err_msg=attr)
        te, je = tc.energy(), jc.energy()
        assert sorted(te) == sorted(je)
        for key, val in je.items():
            if isinstance(val, str):
                assert te[key] == val, key
            else:
                np.testing.assert_allclose(te[key], val, rtol=1e-5, err_msg=key)
    assert tsched.telemetry.stream(1).sop_wu_offered == 0.0
    assert tsched.telemetry.stream(0).sop_wu > 0.0


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, device="cpu")


def _task_fleet(params, depth, n_streams=6, n_slots=4, adapt=None):
    task = make_task("gesture", n_in=16, t_steps=6)
    sched = StreamScheduler(params, CFG, n_slots=n_slots, chunk_len=4,
                            pipeline_depth=depth, device="cpu", adapt=adapt)
    for sid in range(n_streams):
        sched.submit(StreamSession(sid=sid, source=TaskStreamSource(
            task, 3, seed=sid), adapt=sid != 3))
    return sched, {s.sid: s for s in sched.run_until_drained()}


def test_pipeline_on_off_bit_exact(params):
    adapt = AdaptConfig(delta_decay=0.99, delta_clip=0.3)
    s0, r0 = _task_fleet(params, 0, adapt=adapt)
    s1, r1 = _task_fleet(params, 1, adapt=adapt)
    assert sorted(r0) == sorted(r1) == list(range(6))
    for sid in r0:
        a, b = r0[sid], r1[sid]
        assert len(a.predictions) == len(b.predictions) == 3
        for pa, pb in zip(a.predictions, b.predictions):
            np.testing.assert_array_equal(pa.logits, pb.logits)
        np.testing.assert_array_equal(a.final_deltas, b.final_deltas)
        ca, cb = s0.telemetry.stream(sid), s1.telemetry.stream(sid)
        for attr in ("timesteps", "sop_forward", "sop_wu", "gate_opened",
                     "local_loss"):
            assert getattr(ca, attr) == getattr(cb, attr), attr
    assert torch.equal(s0.deltas, s1.deltas)
    assert s0.drained and s1.drained and s0.n_compiles == s1.n_compiles == 1
    # the frozen stream never adapted, and was billed no weight updates
    assert not r0[3].final_deltas.any()
    assert s0.telemetry.stream(3).sop_wu_offered == 0.0


def test_interleaved_matches_solo_bit_exact(params):
    ev = _events(5, 2 * CFG.t_steps)

    def run(extra):
        sched = StreamScheduler(params, CFG, n_slots=3, chunk_len=5,
                                device="cpu")
        sched.submit(StreamSession(sid=0, source=ReplaySource(ev, 7)))
        if extra:
            sched.submit(StreamSession(sid=1, source=ReplaySource(
                _events(6, 20, 0.4), 9)))
            sched.submit(StreamSession(sid=2, source=ReplaySource(
                _events(7, 9, 0.5), 3)))
        return {s.sid: s for s in sched.run_until_drained()}[0]

    solo, inter = run(False), run(True)
    assert len(solo.predictions) == len(inter.predictions) == 2
    for a, b in zip(solo.predictions, inter.predictions):
        np.testing.assert_array_equal(a.logits, b.logits)
    np.testing.assert_array_equal(solo.final_deltas, inter.final_deltas)


def test_chunk_fn_freezes_idle_and_frozen_lanes(params):
    """Decay/clip touch live lanes only; a frozen lane keeps its delta and
    is neither billed nor offered weight updates."""
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      serving_params)
    fn = make_chunk_fn(CFG, AdaptConfig(delta_decay=0.5, delta_clip=0.01),
                       want_factors=True)
    sp = serving_params(params, CFG)
    deltas = 0.001 * torch.ones_like(init_stream_deltas(CFG, 3, "cpu"))
    ev = torch.tensor(np.stack([_events(s, 6, 0.5) for s in range(3)], 1))
    valid = torch.tensor([[True, True, False]] * 6)
    amask = torch.tensor([True, False, True])
    out, _, m = fn(sp, deltas, init_stream_state(CFG, 3, "cpu"), ev, valid,
                   amask)
    assert torch.equal(out[1], deltas[1]) and torch.equal(out[2], deltas[2])
    assert not torch.equal(out[0], deltas[0])
    assert float(out[0].abs().max()) <= 0.01
    assert float(m.sop_wu_offered[1]) == 0.0 == float(m.gate_offered[1].sum())
    assert tuple(m.pre_mag.shape) == (CFG.n_layers, 16)   # slot-reduced
    assert float(delta_norms(out)[2]) == float(delta_norms(deltas)[2])


def test_run_chunk_never_writes_its_input_deltas(params):
    """The chunk adds its weight updates in place into its own copy of the
    deltas: across a chunk whose windows reach ``t >= t_wu`` (WU on), the
    caller's deltas and state stay bit for bit as they were, and the
    returned deltas are a fresh tensor that did learn."""
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      run_chunk, serving_params)
    g = torch.Generator().manual_seed(4)
    sp = serving_params(params, CFG)
    deltas = 0.01 * torch.randn(init_stream_deltas(CFG, 3, "cpu").shape,
                                generator=g)
    st = init_stream_state(CFG, 3, "cpu")
    before = deltas.clone(), [t.clone() for t in st.layers]
    ev = torch.tensor(np.stack([_events(s, 6, 0.5) for s in range(3)], 1))
    assert int(CFG.t_steps * CFG.wu_start_frac) < 6         # WU in the chunk
    out, _, m = run_chunk(sp, deltas, st, ev, torch.ones((6, 3), dtype=bool),
                          CFG)
    assert torch.equal(deltas, before[0])
    assert all(torch.equal(a, b) for a, b in zip(st.layers, before[1]))
    assert out.data_ptr() != deltas.data_ptr() and out.is_contiguous()
    assert float(m.sop_wu.sum()) > 0.0 and not torch.equal(out, deltas)


def test_lane_surgery_touches_one_lane_only(params):
    from repro_torch.core.snn import init_stream_deltas, init_stream_state
    from repro_torch.serving import read_lane, reset_lane, write_lane
    g = torch.Generator().manual_seed(0)
    st = init_stream_state(CFG, 3, "cpu")
    st = type(st)(type(st.layers)(*(torch.rand(t.shape, generator=g)
                                    for t in st.layers)), *st[1:])
    dl = torch.rand(init_stream_deltas(CFG, 3, "cpu").shape, generator=g)
    before = read_lane(st, 0), read_lane(st, 2), dl[0].clone(), dl[2].clone()
    write_lane(st, read_lane(st, 2), 1)
    assert torch.equal(read_lane(st, 1).layers.v, before[1].layers.v)
    reset_lane(st, dl, CFG, 1)
    assert not dl[1].any() and not st.layers.v[1].any()
    assert torch.equal(st.ss_mean[1], torch.full((2,), CFG.gating.ss_init))
    assert torch.equal(read_lane(st, 0).x_tr, before[0].x_tr)
    assert torch.equal(dl[0], before[2]) and torch.equal(dl[2], before[3])


@pytest.mark.parametrize("option", ["topology"])
def test_unported_scheduler_options_raise(params, option):
    """Every scheduler option is ported now (slot sharding over a mesh is
    held in tests/test_torch_sharding.py). The live topology service: the
    scheduler refuses a service built for another config (``ValueError``)
    and clamps the pipeline depth to 1 under one, as the reference does."""
    import dataclasses
    from repro_torch.serving import TopologyService
    other = TopologyService(dataclasses.replace(CFG, n_out=3))
    with pytest.raises(ValueError, match="different SNNConfig"):
        StreamScheduler(params, CFG, n_slots=2, device="cpu",
                        **{option: other})
    sched = StreamScheduler(params, CFG, n_slots=2, device="cpu",
                            topology=TopologyService(CFG),
                            pipeline_depth=2)
    assert sched.pipeline_depth == sched.pipeline.depth == 1
