"""The port's slot-sharded serving fleet (``launch.mesh``,
``launch.sharding``, ``make_chunk_fn(mesh=)``, ``StreamScheduler(mesh=)``)
against its 1-device fleet, and that against the JAX reference; live
topology, checkpoints, remeshing and the registry's sharded entry are in
tests/test_torch_sharding_topology.py.

The reference fakes eight CPU devices (``--xla_force_host_platform_device
_count=8``); the port's counterpart is a mesh that lists the CPU eight
times, through the code that runs shards on distinct cards. Within the
port, with no tolerance at all: the 8-shard chunk step (three carried
chunks, decay and clip, ragged valid, a mixed adapt mask, both delta
layouts), the scheduler end to end, pipelined, with two tiers, traced, with
live topology epochs, its checkpoints and a remesh all equal the 1-device
fleet bit for bit. The 1-device fleet against the reference's, from the
same params and events, within the serving trajectory tolerance of
tests/test_torch_serving.py (logits and deltas ``atol = 1e-4``, argmax
equal). The slot rules against ``repro.launch.sharding``'s on the same
counts, error messages included.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import snn as jsnn
from repro.launch import sharding as JSH
from repro.serving import ReplaySource as JReplaySource
from repro.serving import StreamScheduler as JStreamScheduler
from repro.serving import StreamSession as JStreamSession
from repro.serving.adapt import AdaptConfig as JAdaptConfig
from repro.serving.adapt import make_chunk_fn as jmake_chunk_fn
from repro_torch import convert
from repro_torch.core import snn
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import SlotMesh, make_serving_mesh
from repro_torch.serving import (AdaptConfig, ReplaySource, StreamScheduler,
                                 StreamSession, make_chunk_fn, read_lane,
                                 reset_lane, write_lane)
from repro_torch.serving.adapt import chunk_fns_built

torch.set_num_threads(1)

KW = dict(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=16)
CFG = snn.SNNConfig(**KW)
JCFG = jsnn.SNNConfig(**KW)
N_DEV = 8


def _mesh(n=N_DEV):
    return make_serving_mesh(devices=["cpu"] * n)


def _events(seed, t, rate=0.3):
    r = np.random.default_rng(seed)
    return (r.random((t, CFG.n_in)) < rate).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jsnn.init_params(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def params(jparams):
    return convert.params_from_numpy(jparams, CFG, "cpu")


def _same_sessions(a, b, windows=None):
    """Two fleets' retired sessions, bit for bit."""
    assert sorted(a) == sorted(b)
    for sid in a:
        assert a[sid].timesteps_fed == b[sid].timesteps_fed
        assert len(a[sid].predictions) == len(b[sid].predictions) > 0
        if windows is not None:
            assert len(a[sid].predictions) == windows
        for pa, pb in zip(a[sid].predictions, b[sid].predictions):
            np.testing.assert_array_equal(pa.logits, pb.logits)
        np.testing.assert_array_equal(a[sid].final_deltas,
                                      b[sid].final_deltas)


def _close_sessions(got, want):
    """The port's 1-device fleet against the reference's: the serving
    trajectory tolerance."""
    assert sorted(got) == sorted(want)
    for sid in want:
        assert len(got[sid].predictions) == len(want[sid].predictions) > 0
        for pa, pb in zip(got[sid].predictions, want[sid].predictions):
            assert pa.label == pb.label
            np.testing.assert_allclose(pa.logits, pb.logits, atol=1e-4)
        np.testing.assert_allclose(got[sid].final_deltas,
                                   want[sid].final_deltas, atol=1e-4)


# ------------------------------------------------------------ the slot rules

class _JMesh:
    """What the reference's slot rules read of a mesh: ``shape["slots"]``."""

    def __init__(self, n):
        self.shape = {"slots": n}


def _error(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_slot_rules_match_reference(n_dev):
    mesh, jmesh = _mesh(n_dev), _JMesh(n_dev)
    assert SH.slot_devices(mesh) == JSH.slot_devices(jmesh) == n_dev
    for n in (1, 2, 5, 6, 16, 17, 1000, 1024):
        assert SH.round_up_slots(n, mesh) == JSH.round_up_slots(n, jmesh)
        if n % n_dev:
            assert _error(SH.check_slot_divisible, n, mesh) == \
                _error(JSH.check_slot_divisible, n, jmesh)
        else:
            SH.check_slot_divisible(n, mesh)
    for counts in ([1], [6], [4, 12], [1, 9, 16, 1024]):
        assert SH.tier_slot_allocation(counts, mesh) == \
            JSH.tier_slot_allocation(counts, jmesh)
    for d in (0, 1, 2):
        assert tuple(SH.slot_spec(d)) == tuple(JSH.slot_spec(d))


@pytest.mark.parametrize("want_factors", [True, False])
def test_chunk_step_specs_match_reference(want_factors):
    (pin, pout), (jin, jout) = (SH.chunk_step_specs(want_factors),
                                JSH.chunk_step_specs(want_factors))
    assert [tuple(s) for s in pin] == [tuple(s) for s in jin]
    assert tuple(pout[0]) == tuple(jout[0]) and tuple(pout[1]) == \
        tuple(jout[1])
    assert pout[2]._fields == jout[2]._fields
    for p, j in zip(pout[2], jout[2]):
        assert (p is None and j is None) or tuple(p) == tuple(j)


def test_make_serving_mesh_lists_and_refusals():
    mesh = _mesh()
    assert isinstance(mesh, SlotMesh) and mesh.axis_names == ("slots",)
    assert mesh.shape == {"slots": 8} and len(mesh.devices) == 8
    assert make_serving_mesh(3, devices=["cpu"] * 8).shape == {"slots": 3}
    with pytest.raises(RuntimeError, match="serving mesh needs 9 devices"):
        make_serving_mesh(9, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="visible CUDA devices"):
            make_serving_mesh()
    with pytest.raises(ValueError, match="one device type"):
        make_serving_mesh(devices=["cpu", "meta"])
    with pytest.raises(AttributeError):        # frozen
        mesh.devices = ()


def test_slot_sharded_tensor_places_and_reads_lanes():
    mesh = _mesh(4)
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    x = SH.shard(full, mesh)
    assert x.shape == full.shape and x.width == 2 and x.spec == SH.P("slots")
    assert all(s.data_ptr() != full.data_ptr() for s in x.shards)
    assert x.locate(5) == (2, 1) and torch.equal(x[5], full[5])
    x[5] = torch.zeros(3)
    assert not x.shards[2][1].any() and torch.equal(x.shards[2][0], full[4])
    assert SH.shard(x, mesh) is x
    back = SH.shard(x, _mesh(2))
    assert back.width == 4 and torch.equal(back.full()[:5], full[:5])
    ev = SH.shard(torch.ones((3, 8, 2)), mesh, 1)
    assert ev.shape == (3, 8, 2) and ev.shards[0].shape == (3, 2, 2)
    with pytest.raises(TypeError):
        ev[0]
    with pytest.raises(ValueError, match="not divisible"):
        SH.shard(torch.ones(6), mesh)
    rep = SH.replicate({"w": full}, mesh)
    assert len({r["w"].data_ptr() for r in rep.replicas}) == 4
    assert torch.equal(SH.gather(rep)["w"], full)


def test_lane_surgery_touches_one_lane_of_one_shard():
    mesh = _mesh(4)
    g = torch.Generator().manual_seed(0)
    st = snn.init_stream_state(CFG, 8, "cpu")
    st = type(st)(type(st.layers)(*(torch.rand(t.shape, generator=g)
                                    for t in st.layers)), *st[1:])
    dl = torch.rand(snn.init_stream_deltas(CFG, 8, "cpu").shape, generator=g)
    sst = SH.device_put(st, SH.stream_shardings(st, mesh))
    sdl = SH.shard(dl, mesh)
    write_lane(sst, read_lane(sst, 6), 3)
    reset_lane(sst, sdl, CFG, 5)
    write_lane(st, read_lane(st, 6), 3)
    reset_lane(st, dl, CFG, 5)
    assert torch.equal(sdl.full(), dl) and not sdl.shards[2][1].any()
    for a, b in zip(torch.utils._pytree.tree_leaves(st),
                    torch.utils._pytree.tree_leaves(SH.gather(sst))):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the chunk step

@pytest.mark.parametrize("compact", [True, False])
def test_sharded_chunk_step_bit_identical(jparams, params, compact):
    """3 carried chunk steps, ragged valid, mixed adapt mask, decay + clip:
    8 shards ≡ 1 device bit for bit, every output; 1 device ≡ the
    reference's step within the serving tolerance."""
    S, C = 16, 6
    rng = np.random.default_rng(0)
    adapt = AdaptConfig(delta_decay=0.95, delta_clip=0.3)
    built = chunk_fns_built()
    fn1, fn8 = make_chunk_fn(CFG, adapt), make_chunk_fn(CFG, adapt,
                                                        mesh=_mesh())
    assert chunk_fns_built() == built + 2 and fn8.mesh.size == N_DEV
    jfn = jmake_chunk_fn(JCFG, JAdaptConfig(delta_decay=0.95, delta_clip=0.3))
    ex = snn.serving_params(params, CFG, compact=compact)
    st1 = snn.init_stream_state(CFG, S, "cpu")
    dl1 = snn.init_stream_deltas(CFG, S, "cpu", compact=compact)
    st8, dl8 = st1, dl1
    jst = jsnn.init_stream_state(JCFG, S)
    jdl = jsnn.init_stream_deltas(JCFG, S, compact=compact)
    for _ in range(3):
        ev = (rng.random((C, S, CFG.n_in)) < 0.3).astype(np.float32)
        va, am = rng.random((C, S)) < 0.8, rng.random(S) < 0.7
        args = torch.from_numpy(ev), torch.from_numpy(va), \
            torch.from_numpy(am)
        dl1, st1, m1 = fn1(ex, dl1, st1, *args)
        dl8, st8, m8 = fn8(ex, dl8, st8, *args)
        jdl, jst, jm = jfn(jparams, jdl, jst, ev, va, am)
    assert isinstance(dl8, SH.SlotSharded) and dl8.spec == SH.slot_spec(0)
    assert m8.logits.spec == SH.slot_spec(1) and m8.logits.width == 2
    assert torch.equal(dl1, dl8.full())
    for a, b in zip(torch.utils._pytree.tree_leaves(st1),
                    torch.utils._pytree.tree_leaves(SH.gather(st8))):
        assert torch.equal(a, b)
    for name, a, b in zip(m1._fields, m1, SH.gather(m8)):
        assert torch.equal(a, b), name
    assert float(m1.sop_wu.sum()) > 0
    np.testing.assert_allclose(dl1.numpy(), np.asarray(jdl), atol=1e-4)
    np.testing.assert_allclose(m1.logits.numpy(), np.asarray(jm.logits),
                               atol=1e-4)
    np.testing.assert_allclose(m1.pre_mag.numpy(), np.asarray(jm.pre_mag),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("compact,width", [(True, 1), (True, 2),
                                           (False, 2)])
def test_narrow_shards_at_paper_width_bit_identical(compact, width):
    """Shards of 1 and 2 slots at the paper's layer width (512 hidden),
    across a whole window so the OSSL update runs: 8 shards ≡ the 1-device
    step bit for bit. A reduction kernel's row order may follow the row
    count, so serving takes every per-slot sum in an order fixed by the
    widths alone (``engine.serving_ossl_terms``, ``ordered_readout``). The
    dense layout's base on the CPU is a matmul, a gemv at one row: the
    reference's floor of 2 slots an entry (``tier_slot_allocation``); on
    the card both layouts hold at 1 (tests/test_torch_cuda.py)."""
    cfg = snn.SNNConfig(n_in=512, n_hidden=512, n_layers=2, n_out=16,
                        t_steps=20)
    p = snn.init_params(0, cfg, device="cpu")
    S, C = N_DEV * width, 8
    rng = np.random.default_rng(1)
    adapt = AdaptConfig(delta_decay=0.95, delta_clip=0.3)
    fn1 = make_chunk_fn(cfg, adapt)
    fn8 = make_chunk_fn(cfg, adapt, mesh=_mesh())
    ex = snn.serving_params(p, cfg, compact=compact)
    st1 = st8 = snn.init_stream_state(cfg, S, "cpu")
    dl1 = dl8 = snn.init_stream_deltas(cfg, S, "cpu", compact=compact)
    opened = 0.0
    for _ in range(3):
        args = (torch.from_numpy((rng.random((C, S, cfg.n_in)) < 0.3)
                                 .astype(np.float32)),
                torch.from_numpy(rng.random((C, S)) < 0.9),
                torch.ones(S, dtype=torch.bool))
        dl1, st1, m1 = fn1(ex, dl1, st1, *args)
        dl8, st8, m8 = fn8(ex, dl8, st8, *args)
        opened += float(m1.sop_wu.sum())
        assert torch.equal(dl1, dl8.full())
        for a, b in zip(torch.utils._pytree.tree_leaves(st1),
                        torch.utils._pytree.tree_leaves(SH.gather(st8))):
            assert torch.equal(a, b)
        for name, a, b in zip(m1._fields, m1, SH.gather(m8)):
            assert torch.equal(a, b), name
    assert opened > 0


def test_sharded_chunk_step_refuses_an_indivisible_grid(params):
    fn = make_chunk_fn(CFG, mesh=_mesh(3))
    ex = snn.serving_params(params, CFG)
    with pytest.raises(ValueError, match="not divisible by the 3-device"):
        fn(ex, snn.init_stream_deltas(CFG, 4, "cpu"),
           snn.init_stream_state(CFG, 4, "cpu"), torch.zeros((2, 4, 32)),
           torch.ones((2, 4), dtype=torch.bool),
           torch.ones(4, dtype=torch.bool))


# ------------------------------------------------------------ the scheduler

def _drive(params, mesh, n_slots, n_streams=6, **kw):
    sched = StreamScheduler(params, CFG, n_slots=n_slots, chunk_len=5,
                            mesh=mesh, device="cpu", **kw)
    for sid in range(n_streams):
        sched.submit(StreamSession(
            sid=sid, source=ReplaySource(_events(sid, 2 * CFG.t_steps)),
            adapt=(sid % 2 == 0)))
    return sched, {s.sid: s for s in sched.run_until_drained()}


def test_sharded_scheduler_end_to_end(jparams, params):
    """Admits, lane surgery on the shards, retires: 6 requested slots pad to
    16 (2 a shard); bit for bit the 1-device fleet, one chunk fn each; that
    fleet against the reference's."""
    s1, d1 = _drive(params, None, 16)
    s8, d8 = _drive(params, _mesh(), 6)
    assert s8.n_slots == 16 and s8.chunk_fn.mesh.size == N_DEV
    assert s1.n_compiles == 1 and s8.n_compiles == 1
    _same_sessions(d1, d8, windows=2)
    assert torch.equal(s1.deltas, s8.deltas)
    assert isinstance(s8._tiers[0].deltas, SH.SlotSharded)
    jsched = JStreamScheduler(jparams, JCFG, n_slots=16, chunk_len=5)
    for sid in range(6):
        jsched.submit(JStreamSession(
            sid=sid, source=JReplaySource(_events(sid, 2 * CFG.t_steps)),
            adapt=(sid % 2 == 0)))
    _close_sessions(d1, {s.sid: s for s in jsched.run_until_drained()})
    assert s8.telemetry.stream(0).sop_wu == s1.telemetry.stream(0).sop_wu


def test_sharded_pipeline_depth1_equals_serial(params):
    s1, d1 = _drive(params, None, 16)
    s8, d8 = _drive(params, _mesh(), 16, pipeline_depth=1)
    assert s8.pipeline.depth == 1 and s8.n_compiles == 1
    _same_sessions(d1, d8, windows=2)


def test_sharded_tiers_ingest_autopilot_equal_single_grids(params):
    """Two tiers with ingestion and the depth autopilot on 8 shards (each
    tier padded to 16) against solo 1-device grids per tier."""
    from repro_torch.data.events import make_task
    from repro_torch.serving import (AERStreamSource, ArrivalConfig,
                                     AutopilotConfig, TierConfig)
    task = make_task("gesture", n_in=CFG.n_in, t_steps=CFG.t_steps)
    jit = ArrivalConfig(min_chunk=3, max_chunk=13, mean_gap_s=0.004,
                        start_jitter_s=0.02)

    def sessions():
        return [StreamSession(sid=sid, source=AERStreamSource(
            task, n_windows=2, seed=sid, arrival=jit), adapt=sid % 2 == 0)
            for sid in range(10)]

    def tier_of(sid):
        return "interactive" if sid % 2 else "bulk"
    sched = StreamScheduler(
        params, CFG, n_slots=8, device="cpu", mesh=_mesh(), ingest=True,
        tiers=[TierConfig("interactive", chunk_len=4, n_slots=8),
               TierConfig("bulk", chunk_len=12, n_slots=8)],
        autopilot=AutopilotConfig(max_depth=2, decide_every=1, hold_steps=2,
                                  warmup_obs=1, deepen_above=0.0,
                                  relax_below=0.0))
    try:
        for s in sessions():
            sched.submit(s, tier=tier_of(s.sid))
        got = {s.sid: s for s in sched.run_until_drained()}
    finally:
        sched.close()
    assert sched.n_slots == 32
    assert sched.n_compiles_by_tier == {"interactive": 1, "bulk": 1}
    assert len(sched.autopilot.depths_visited()) > 1
    want = {}
    for name, c in (("interactive", 4), ("bulk", 12)):
        solo = StreamScheduler(params, CFG, n_slots=8, chunk_len=c,
                               device="cpu")
        for s in sessions():
            if tier_of(s.sid) == name:
                solo.submit(s)
        want.update({s.sid: s for s in solo.run_until_drained()})
    _same_sessions(want, got, windows=2)


def test_sharded_tracing_is_bit_identical_with_one_span_a_phase(params):
    from repro_torch.obs import Tracer
    tr = Tracer(capacity=65536)
    s1, d1 = _drive(params, None, 16)
    s8, d8 = _drive(params, _mesh(), 16, pipeline_depth=1, tracer=tr)
    _same_sessions(d1, d8, windows=2)
    steps = s8.grid.stats["steps"]
    for phase in ("sched.step", "sched.stage", "sched.dispatch",
                  "sched.retire", "sched.device_wait"):
        assert len(tr.spans(phase)) == steps > 0, phase


def test_sharded_staging_is_shard_major_and_contiguous(params):
    sched = StreamScheduler(params, CFG, n_slots=16, chunk_len=5,
                            mesh=_mesh(), device="cpu")
    for sid in range(3):
        sched.submit(StreamSession(sid=sid, source=ReplaySource(
            _events(sid, 10))))
    staged = sched._stage(sched._tiers[0])
    assert staged.events.shape == (N_DEV, 5, 2, CFG.n_in)
    assert staged.valid.shape == (N_DEV, 5, 2)
    assert staged.adapt_mask.shape == (N_DEV, 2)
    for buf in (staged.events, staged.valid, staged.adapt_mask):
        assert not buf.is_pinned()        # pinning applies to CUDA fleets
        for block in buf:
            assert block.is_contiguous()
    # sessions 0..2 took slots 0..2: shard 0 lanes 0-1, shard 1 lane 0
    assert staged.valid[0].all() and staged.valid[1, :, 0].all()
    assert not staged.valid[1, :, 1].any() and not staged.valid[2:].any()
    ev = sched._to_device(staged.events, 1)
    assert isinstance(ev, SH.SlotSharded) and ev.shape == (5, 16, CFG.n_in)
