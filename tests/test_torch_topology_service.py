"""Live DSST topology under serving traffic in the port
(``serving/topology_service``, the scheduler's epochs, the dense delta
layout) against the JAX reference, and against itself.

Against the reference, from the same params (the reference's, carried
across as numpy) and the same ``ReplaySource`` events: the masks after
every epoch are equal and each epoch prunes, regrows and folds the same
(the regrow ranks units by ``|pre trace|``, sums of binary spikes times
powers of ``beta``, identical in both frameworks; the prune ranks ``|w|``,
identical until a fold adds a lane), predictions agree in argmax with
logits within ``atol = 1e-4`` and the deltas within ``1e-4`` (the serving
trajectory tolerance of tests/test_torch_serving.py), the base weights
within ``1e-5``.

Within the port, bitwise (no tolerance): surviving deltas across a swap,
the scheduler ≡ the same chunks driven by hand with the same epochs, a
pipelined fleet ≡ the serial one, the fold at ``merge_weight = 1``. Dense
and compact layouts: the storage operations (projection, merge) bitwise at
kept coordinates; whole trajectories within ``1e-5``, the tolerance of
tests/test_compact_serving.py (the two layouts sum in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsst as jdsst, engine as jengine, snn as jsnn
from repro.core import sparsity as jsparsity, topology as jtopology
from repro.serving import ReplaySource as JReplaySource
from repro.serving import StreamScheduler as JStreamScheduler
from repro.serving import StreamSession as JStreamSession
from repro.serving import TopologyService as JTopologyService
from repro.serving import TopologyServiceConfig as JServiceConfig
from repro.serving import fresh_lane_state as jfresh_lane_state
from repro.serving import merge_lane_into_base as jmerge
from repro_torch import convert
from repro_torch.core import dsst, engine, snn, sparsity, topology
from repro_torch.core.dsst import DSSTConfig
from repro_torch.serving import (AdaptConfig, FleetTelemetry, ReplaySource,
                                 StreamScheduler, StreamSession,
                                 TopologyService, TopologyServiceConfig,
                                 delta_norms, fresh_lane_state, make_chunk_fn,
                                 merge_lane_into_base)

torch.set_num_threads(1)

KW = dict(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=12)
CFG = snn.SNNConfig(**KW, dsst=DSSTConfig(period=4, prune_frac=0.5))
JCFG = jsnn.SNNConfig(**KW, dsst=jdsst.DSSTConfig(period=4, prune_frac=0.5))
CHUNK = 6


def _events(seed, t, rate=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((t, CFG.n_in)) < rate).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jsnn.init_params(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def params(jparams):
    return convert.params_from_numpy(jparams, CFG, "cpu")


def _port(sched_params, **kw):
    return StreamScheduler(sched_params, CFG, device="cpu", **kw)


# ------------------------------------------------------- against the reference

def _drive_both(jparams, params, svc_cfg, n_streams=2, n_steps=9,
                compact=None, depth=0):
    lens = [(n_steps - (2 * s if n_streams > 2 else 0)) * CHUNK
            for s in range(n_streams)]
    evs = [_events(10 + s, lens[s], rate=0.3 + 0.05 * s)
           for s in range(n_streams)]
    jsvc = JTopologyService(JCFG, JServiceConfig(**svc_cfg))
    jsched = JStreamScheduler(jparams, JCFG, n_slots=n_streams,
                              chunk_len=CHUNK, topology=jsvc, compact=compact)
    svc = TopologyService(CFG, TopologyServiceConfig(**svc_cfg))
    sched = _port(params, n_slots=n_streams, chunk_len=CHUNK, topology=svc,
                  compact=compact, pipeline_depth=depth)
    masks = {"ref": [], "port": []}
    for s, key in ((jsched, "ref"), (sched, "port")):
        orig = s.maybe_evolve_topology

        def spy(*a, _orig=orig, _s=s, _key=key, **k):
            ev = _orig(*a, **k)
            if ev is not None:
                masks[_key].append(np.asarray(_s.params["hidden"]["mask"]))
            return ev
        s.maybe_evolve_topology = spy
    for sid in range(n_streams):
        jsched.submit(JStreamSession(sid=sid, source=JReplaySource(
            evs[sid], chunk_len=CHUNK), adapt=sid != 1 or n_streams < 3))
        sched.submit(StreamSession(sid=sid, source=ReplaySource(
            evs[sid], chunk_len=CHUNK), adapt=sid != 1 or n_streams < 3))
    want = {s.sid: s for s in jsched.run_until_drained()}
    got = {s.sid: s for s in sched.run_until_drained()}
    return (jsched, jsvc, want), (sched, svc, got), masks


def _assert_same_epochs(jsvc, svc, masks):
    assert svc.epoch_idx == jsvc.epoch_idx >= 2
    assert [(e.epoch, e.grid_step, e.pruned, e.regrown, e.merged_slots)
            for e in svc.events] == \
        [(e.epoch, e.grid_step, e.pruned, e.regrown, e.merged_slots)
         for e in jsvc.events]
    for e, je in zip(svc.events, jsvc.events):
        assert e.mask_change == pytest.approx(je.mask_change, rel=1e-6)
    assert len(masks["port"]) == len(masks["ref"]) == svc.epoch_idx
    for a, b in zip(masks["port"], masks["ref"]):
        np.testing.assert_array_equal(a, b)


def _assert_same_serving(want, got, jsched, sched):
    for sid in want:
        assert len(got[sid].predictions) == len(want[sid].predictions) > 0
        for a, b in zip(got[sid].predictions, want[sid].predictions):
            assert a.label == b.label
            np.testing.assert_allclose(a.logits, b.logits, atol=1e-4)
        np.testing.assert_allclose(got[sid].final_deltas,
                                   want[sid].final_deltas, atol=1e-4)
    np.testing.assert_array_equal(sched.params["hidden"]["mask"].numpy(),
                                  np.asarray(jsched.params["hidden"]["mask"]))
    np.testing.assert_allclose(sched.params["hidden"]["w"].numpy(),
                               np.asarray(jsched.params["hidden"]["w"]),
                               atol=1e-5)
    np.testing.assert_allclose(sched.deltas.numpy(), np.asarray(jsched.deltas),
                               atol=1e-4)


def test_epochs_complete_under_traffic_one_compile(jparams, params):
    """Epochs land under traffic with ONE chunk fn built; every epoch
    evolves the masks as the reference's does, and telemetry mirrors the
    service's log."""
    (jsched, jsvc, want), (sched, svc, got), masks = _drive_both(
        jparams, params, dict(epoch_every=3, merge_top=1))
    _assert_same_epochs(jsvc, svc, masks)
    _assert_same_serving(want, got, jsched, sched)
    assert sched.n_compiles == 1 and jsched.n_compiles == 1
    assert sum(e.pruned for e in svc.events) > 0
    assert topology.check(sched.params["hidden"]["mask"], CFG)
    assert not torch.equal(sched.params["hidden"]["mask"],
                           params["hidden"]["mask"])
    r, jr = sched.telemetry.rollup(), jsched.telemetry.rollup()
    for key in ("topology_epochs", "topology_pruned", "topology_regrown",
                "streams_merged"):
        assert r[key] == jr[key], key
    assert r["topology_mask_change_mean"] == pytest.approx(
        jr["topology_mask_change_mean"], rel=1e-6)
    assert r["topology_epoch_wall_s"] > 0
    for s in got.values():
        assert len(s.predictions) == 9 * CHUNK // CFG.t_steps


@pytest.mark.parametrize("compact", [True, False])
def test_pipelined_with_epochs_equals_serial_and_the_reference(jparams, params,
                                                               compact):
    """Depth 1 with epochs: the epoch of step t lands after t retires and
    before t+1 dispatches, with t's merge snapshot. Three streams (one
    frozen) of unequal lengths, so lanes retire and epochs fold mid-run;
    the pipelined fleet equals the serial one bit for bit, and both match
    the reference's epochs, in either delta layout."""
    svc_cfg = dict(epoch_every=2, merge_top=1)
    (jsched, jsvc, want), (s0, v0, r0), masks = _drive_both(
        jparams, params, svc_cfg, n_streams=3, compact=compact)
    _assert_same_epochs(jsvc, v0, masks)
    _, (s1, v1, r1), _ = _drive_both(jparams, params, svc_cfg, n_streams=3,
                                     compact=compact, depth=1)
    assert [e for e in v0.events] == [e for e in v1.events]
    for sid in r0:
        for a, b in zip(r0[sid].predictions, r1[sid].predictions):
            np.testing.assert_array_equal(a.logits, b.logits)
        np.testing.assert_array_equal(r0[sid].final_deltas,
                                      r1[sid].final_deltas)
    assert torch.equal(s0.deltas, s1.deltas)
    for a, b in zip(s0.params["hidden"].values(), s1.params["hidden"].values()):
        assert torch.equal(a, b)
    assert s0.n_compiles == s1.n_compiles == 1
    assert s0.deltas.dim() == (6 if compact else 4)


def test_service_epoch_matches_reference_from_one_state(jparams, params):
    """Both services seeded with one accumulated state (``convert.
    seed_topology_service``) evolve the same params and deltas to the same
    mask, weights and projected deltas, bitwise."""
    jsvc = JTopologyService(JCFG, JServiceConfig(epoch_every=1))
    fn = jsnn.run_chunk
    S = 2
    ev = np.stack([_events(21 + s, CFG.t_steps) for s in range(S)], 1)
    dl, _, m = fn(jparams, jsnn.init_stream_deltas(JCFG, S),
                  jsnn.init_stream_state(JCFG, S), jnp.asarray(ev),
                  jnp.ones((CFG.t_steps, S), bool), JCFG)
    jsvc.observe(jax.device_get(m))
    jsvc.epoch_idx = 3
    svc = convert.seed_topology_service(TopologyService(CFG), jsvc)
    jdl = np.asarray(dl)
    jp2, jdl2, jev = jsvc.evolve(jparams, jnp.asarray(jdl), grid_step=7)
    p2, dl2, ev2 = svc.evolve(params, convert.deltas_from_numpy(jdl, "cpu"),
                              grid_step=7)
    assert (ev2.epoch, ev2.pruned, ev2.regrown) == (3, jev.pruned, jev.regrown)
    np.testing.assert_array_equal(p2["hidden"]["mask"].numpy(),
                                  np.asarray(jp2["hidden"]["mask"]))
    np.testing.assert_array_equal(p2["hidden"]["w"].numpy(),
                                  np.asarray(jp2["hidden"]["w"]))
    np.testing.assert_array_equal(dl2.numpy(), np.asarray(jdl2))
    assert svc.epoch_idx == 4 and svc.observed_steps == 0.0


# ----------------------------------------------------------- within the port

def test_swap_matches_drain_and_restart_reference(params):
    """Scheduler with live swaps == ``run_chunk`` driven by hand with the
    same epochs applied between chunk calls, bitwise: params, deltas and
    every window prediction."""
    n_streams, n_steps = 2, 9
    evs = [_events(10 + s, n_steps * CHUNK, rate=0.3 + 0.05 * s)
           for s in range(n_streams)]
    svc_cfg = TopologyServiceConfig(epoch_every=3, merge_top=1)
    svc = TopologyService(CFG, svc_cfg)
    sched = _port(params, n_slots=n_streams, chunk_len=CHUNK, topology=svc)
    for sid in range(n_streams):
        sched.submit(StreamSession(
            sid=sid, source=ReplaySource(evs[sid], chunk_len=CHUNK)))
    done = {s.sid: s for s in sched.run_until_drained()}
    assert svc.epoch_idx >= 2 and sched.n_compiles == 1

    ref_svc = TopologyService(CFG, svc_cfg)
    fn = make_chunk_fn(CFG, AdaptConfig())
    p = params
    st = snn.init_stream_state(CFG, n_streams, "cpu")
    dl = snn.init_stream_deltas(CFG, n_streams, "cpu")
    amask = torch.ones(n_streams, dtype=torch.bool)
    ref_preds = {s: [] for s in range(n_streams)}
    for i in range(n_steps):
        events = np.zeros((CHUNK, n_streams, CFG.n_in), np.float32)
        for s in range(n_streams):
            events[:, s] = evs[s][i * CHUNK:(i + 1) * CHUNK]
        dl, st, m = fn(snn.serving_params(p, CFG), dl, st,
                       torch.from_numpy(events),
                       torch.ones((CHUNK, n_streams), dtype=torch.bool), amask)
        for s in range(n_streams):
            for t in np.nonzero(m.window_end[:, s].numpy())[0]:
                ref_preds[s].append(m.logits[t, s].numpy().copy())
        ref_svc.observe(m)
        active = tuple(s for s in range(n_streams)
                       if (i + 1) * CHUNK < evs[s].shape[0])
        if ref_svc.due(i + 1):
            p, dl, _ = ref_svc.evolve(p, dl, merge_slots=active,
                                      grid_step=i + 1)
    assert ref_svc.events == svc.events
    for a, b in zip(sched.params["hidden"].values(), p["hidden"].values()):
        assert torch.equal(a, b)
    assert torch.equal(sched.deltas, dl)
    for sid in range(n_streams):
        got = done[sid].predictions
        assert len(got) == len(ref_preds[sid]) > 0
        for a, b in zip(got, ref_preds[sid]):
            np.testing.assert_array_equal(a.logits, b)


@pytest.mark.parametrize("compact", [True, False])
def test_deltas_bit_exact_across_swap(params, compact):
    """One evolve on live factors keeps surviving delta bits and zeroes the
    rest, in either layout; the inputs are not written."""
    svc = TopologyService(CFG, TopologyServiceConfig(epoch_every=1))
    S = 2
    ev = torch.from_numpy(_events(21, CFG.t_steps)[:, None, :].repeat(S, 1))
    dl, _, m = snn.run_chunk(snn.serving_params(params, CFG, compact=compact),
                             snn.init_stream_deltas(CFG, S, "cpu",
                                                    compact=compact),
                             snn.init_stream_state(CFG, S, "cpu"), ev,
                             torch.ones((CFG.t_steps, S), dtype=torch.bool),
                             CFG)
    svc.observe(m)                       # raw [S, L, .] factors
    assert float(dl.abs().max()) > 0, "no adaptation accumulated"
    before = dl.clone()
    old_mask = params["hidden"]["mask"]
    p2, dl2, event = svc.evolve(params, dl, grid_step=1)
    assert event.pruned > 0 and torch.equal(dl, before)
    assert dl2.shape == dl.shape and dl2.dtype == dl.dtype
    new_mask = p2["hidden"]["mask"]
    if compact:
        dl = engine.densify_deltas(dl, topology.stacked_kept_ids(old_mask,
                                                                 CFG), CFG)
        dl2 = engine.densify_deltas(dl2, topology.stacked_kept_ids(new_mask,
                                                                   CFG), CFG)
    surv = topology.survivors_dense(old_mask, new_mask, CFG)
    assert torch.equal(dl2[:, surv], dl[:, surv])
    assert not dl2[:, ~surv].any()


def test_frozen_config_never_evolves(params):
    for frozen_cfg in (
            dataclasses.replace(CFG, dsst_enabled=False),
            dataclasses.replace(CFG, dense=True),
            dataclasses.replace(CFG, dsst=DSSTConfig(
                period=4, prune_frac=0.5, stop_step=0))):
        svc = TopologyService(frozen_cfg, TopologyServiceConfig(epoch_every=1))
        svc.observed_steps = 100.0
        assert svc.frozen and not svc.due(10)
        with pytest.raises(ValueError, match="frozen"):
            svc.evolve(params, snn.init_stream_deltas(CFG, 2, "cpu"),
                       grid_step=1)
    cfg = dataclasses.replace(CFG, dsst=DSSTConfig(
        period=4, prune_frac=0.5, stop_step=5))
    svc = TopologyService(cfg, TopologyServiceConfig(epoch_every=1))
    assert not svc.frozen
    svc.epoch_idx = 2                          # virtual step 8 >= stop_step
    assert svc.frozen and not svc.due(100)
    # a frozen service asks for no factors: the chunk fn runs without them
    frozen = TopologyService(dataclasses.replace(CFG, dsst_enabled=False))
    sched = StreamScheduler(params, frozen.cfg, n_slots=2, device="cpu",
                            topology=frozen)
    assert sched.want_factors is False


def test_no_epoch_without_traffic(params):
    svc = TopologyService(CFG, TopologyServiceConfig(epoch_every=1))
    sched = _port(params, n_slots=2, chunk_len=CHUNK, topology=svc)
    for _ in range(3):
        sched.step()       # no sessions: all slots idle
    assert svc.epoch_idx == 0 and svc.events == []
    assert torch.equal(sched.params["hidden"]["mask"],
                       params["hidden"]["mask"])


@pytest.mark.parametrize("compact", [True, False])
def test_fold_hot_stream_exact_and_generic(compact):
    """merge_weight=1: the hot lane's delta moves into the base and its lane
    zeroes, so its effective weights keep their bits (k rounds to 0, so the
    fold is alone); ``merge_lane_into_base`` keeps unknown keys and equals
    the reference's merge bitwise."""
    cfg = snn.SNNConfig(**KW, dsst=DSSTConfig(period=4, prune_frac=0.01))
    jcfg = jsnn.SNNConfig(**KW, dsst=jdsst.DSSTConfig(period=4,
                                                      prune_frac=0.01))
    jp = jax.device_get(jsnn.init_params(jax.random.PRNGKey(1), jcfg))
    p = convert.params_from_numpy(jp, cfg, "cpu")
    svc = TopologyService(cfg, TopologyServiceConfig(epoch_every=1,
                                                     merge_top=1))
    fn = make_chunk_fn(cfg, AdaptConfig())
    ev = torch.from_numpy(_events(31, cfg.t_steps, 0.4)[:, None, :]
                          .repeat(2, 1))
    dl, _, m = fn(snn.serving_params(p, cfg, compact=compact),
                  snn.init_stream_deltas(cfg, 2, "cpu", compact=compact),
                  snn.init_stream_state(cfg, 2, "cpu"), ev,
                  torch.ones((cfg.t_steps, 2), dtype=torch.bool),
                  torch.tensor([True, False]))        # lane 1 frozen
    svc.observe(m)
    assert float(dl[0].abs().max()) > 0 and not dl[1].any()
    dense = dl if not compact else engine.densify_deltas(
        dl, topology.stacked_kept_ids(p["hidden"]["mask"], cfg), cfg)
    want_w = p["hidden"]["w"] + dense[0]
    p2, dl2, event = svc.evolve(p, dl, merge_slots=(0,), grid_step=1)
    assert event.merged_slots == (0,) and event.pruned == 0
    assert torch.equal(p2["hidden"]["mask"], p["hidden"]["mask"])
    assert torch.equal(p2["hidden"]["w"], want_w)
    assert not dl2[0].any() and torch.equal(dl2[1], dl[1])
    # the reference's merge on the same lane, bitwise
    jw = jmerge(jp, jnp.asarray(dl.numpy()), 0, jcfg)["hidden"]["w"]
    np.testing.assert_array_equal(
        merge_lane_into_base(p, dl, 0, cfg)["hidden"]["w"].numpy(),
        np.asarray(jw))
    fat = {**p, "aux_head": torch.ones(3),
           "hidden": {**p["hidden"], "scales": torch.ones(2)}}
    out = merge_lane_into_base(fat, dl, 0, cfg)
    assert "aux_head" in out and "scales" in out["hidden"]
    np.testing.assert_allclose(delta_norms(dense).numpy(),
                               delta_norms(dl).numpy(), rtol=1e-6)


def test_topology_telemetry_unit():
    tel = FleetTelemetry()
    assert tel.rollup()["topology_epochs"] == 0
    tel.record_topology_epoch(grid_step=10, pruned=24, regrown=24,
                              mask_change=0.125, merged_streams=2, wall_s=0.5)
    tel.record_topology_epoch(grid_step=20, pruned=12, regrown=12,
                              mask_change=0.0625, merged_streams=0)
    r = tel.topology_rollup()
    assert r["topology_epochs"] == 2
    assert r["topology_pruned"] == 36 and r["topology_regrown"] == 36
    assert r["streams_merged"] == 2 and r["topology_epoch_wall_s"] == 0.5
    np.testing.assert_allclose(r["topology_mask_change_mean"], 0.09375)
    assert tel.rollup()["topology_epochs"] == 2
    assert [e["grid_step"] for e in tel.topology_epochs] == [10, 20]


# ------------------------------------------------------------- one compile

def test_n_compiles_counts_chunk_fns_built(params):
    """``n_compiles`` is a real counter: 0 before the first step, 1 after
    epochs, and more if a swap rebuilt the chunk fn (planted here by a swap
    that builds a fresh one with ``make_chunk_fn`` and installs it)."""
    def fleet(rebuild):
        svc = TopologyService(CFG, TopologyServiceConfig(epoch_every=2))
        sched = _port(params, n_slots=2, chunk_len=CHUNK, topology=svc)
        if rebuild:
            orig = sched._refresh_exec_params

            def refresh():
                orig()
                sched.chunk_fn = make_chunk_fn(
                    CFG, None, want_factors=sched.want_factors)
            sched._refresh_exec_params = refresh
        assert sched.n_compiles == 0
        sched.submit(StreamSession(sid=0, source=ReplaySource(
            _events(3, 6 * CHUNK), chunk_len=CHUNK)))
        sched.run_until_drained()
        return sched, svc
    sched, svc = fleet(False)
    assert svc.epoch_idx >= 2 and sched.n_compiles == 1
    sched, svc = fleet(True)
    assert svc.epoch_idx >= 2 and 2 <= sched.n_compiles <= 1 + svc.epoch_idx


def test_scheduler_refuses_a_service_it_cannot_feed(params):
    other = TopologyService(dataclasses.replace(CFG, n_out=4))
    with pytest.raises(ValueError, match="different SNNConfig"):
        _port(params, n_slots=2, topology=other)
    with pytest.raises(ValueError, match="want_factors"):
        _port(params, n_slots=2, topology=TopologyService(CFG),
              want_factors=False)
    with pytest.raises(ValueError, match="DSST factors"):
        TopologyService(CFG).observe(snn.ChunkMetrics(*([None] * 11)))


# ------------------------------------------------------ dense delta layout

DKW = dict(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=8,
           dsst_enabled=False)
DCFG, JDCFG = snn.SNNConfig(**DKW), jsnn.SNNConfig(**DKW)


@pytest.mark.parametrize("backend", ["ref", "kernels"])
def test_dense_baseline_runs_and_matches(backend):
    """Dense deltas through ``run_chunk`` against the reference's dense path
    (``1e-5``) and against the port's compact path (``1e-5``)."""
    cfg = dataclasses.replace(DCFG, backend=backend)
    S, Cn = 4, 8
    jp = jax.device_get(jsnn.init_params(jax.random.PRNGKey(0), JDCFG))
    p = convert.params_from_numpy(jp, cfg, "cpu")
    ev = (np.random.default_rng(1).random((Cn, S, 32)) < 0.3).astype(np.float32)
    valid = np.random.default_rng(2).random((Cn, S)) < 0.85
    jd, _, jm = jsnn.run_chunk(jp, jsnn.init_stream_deltas(JDCFG, S,
                                                           compact=False),
                               jsnn.init_stream_state(JDCFG, S),
                               jnp.asarray(ev), jnp.asarray(valid), JDCFG)
    st0 = snn.init_stream_state(cfg, S, "cpu")
    args = (st0, torch.from_numpy(ev), torch.from_numpy(valid), cfg)
    dd, _, md = snn.run_chunk(snn.serving_params(p, cfg, compact=False),
                              snn.init_stream_deltas(cfg, S, "cpu",
                                                     compact=False), *args)
    dc, _, mc = snn.run_chunk(snn.serving_params(p, cfg),
                              snn.init_stream_deltas(cfg, S, "cpu"), *args)
    assert dd.shape == (S, 2, 32, 32) and float(dd.abs().max()) > 0
    np.testing.assert_allclose(dd.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_allclose(md.logits.numpy(), np.asarray(jm.logits),
                               atol=1e-5)
    idx = topology.stacked_kept_ids(p["hidden"]["mask"], cfg)
    np.testing.assert_allclose(engine.densify_deltas(dc, idx, cfg).numpy(),
                               dd.numpy(), atol=1e-5)
    np.testing.assert_allclose(mc.logits.numpy(), md.logits.numpy(),
                               atol=1e-5)
    # the dense training layout is turned into the dense rep by run_chunk
    dd2, _, _ = snn.run_chunk(p, snn.init_stream_deltas(cfg, S, "cpu",
                                                        compact=False), *args)
    assert torch.equal(dd2, dd)
    with pytest.raises(ValueError, match="mask-free"):
        snn.run_chunk(snn.serving_params(p, cfg),
                      snn.init_stream_deltas(cfg, S, "cpu", compact=False),
                      *args)


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_project_deltas_compact_matches_dense_bitwise(seed):
    cfg = dataclasses.replace(DCFG, dsst=DSSTConfig(period=4, prune_frac=0.5),
                              dsst_enabled=True)
    old = snn.init_params(seed, cfg, device="cpu")["hidden"]["mask"]
    new = snn.init_params(seed + 1, cfg, device="cpu")["hidden"]["mask"]
    old_ids = topology.stacked_kept_ids(old, cfg)
    new_ids = topology.stacked_kept_ids(new, cfg)
    dm_old = topology.dense_masks(old, cfg)
    g = torch.Generator().manual_seed(seed)
    dense = torch.randn((3,) + tuple(dm_old.shape), generator=g) * dm_old[None]
    compact = engine.compact_deltas(dense, old_ids, cfg)
    proj_dense = topology.project_deltas(dense, old, new, cfg)
    proj_compact = topology.project_deltas(compact, old, new, cfg)
    assert torch.equal(engine.densify_deltas(proj_compact, new_ids, cfg),
                       proj_dense)
    assert torch.equal(engine.compact_deltas(proj_dense, new_ids, cfg),
                       proj_compact)
    # the reference's dense projection, bitwise
    want = jtopology.project_deltas(jnp.asarray(dense.numpy()),
                                    jnp.asarray(old.numpy()),
                                    jnp.asarray(new.numpy()), JDCFG)
    np.testing.assert_array_equal(proj_dense.numpy(), np.asarray(want))


def test_merge_lane_into_base_both_layouts_bitwise():
    jp = jax.device_get(jsnn.init_params(jax.random.PRNGKey(0), JDCFG))
    p = convert.params_from_numpy(jp, DCFG, "cpu")
    idx = topology.stacked_kept_ids(p["hidden"]["mask"], DCFG)
    g = torch.Generator().manual_seed(3)
    dc = torch.randn(snn.init_stream_deltas(DCFG, 2, "cpu").shape,
                     generator=g)
    dd = engine.densify_deltas(dc, idx, DCFG)
    wc = merge_lane_into_base(p, dc, 1, DCFG, weight=0.5)["hidden"]["w"]
    wd = merge_lane_into_base(p, dd, 1, DCFG, weight=0.5)["hidden"]["w"]
    assert torch.equal(wc, wd)
    dm = topology.dense_masks(p["hidden"]["mask"], DCFG)
    assert not wd[dm == 0].any()
    jw = jmerge(jp, jnp.asarray(dd.numpy()), 1, JDCFG, weight=0.5)
    np.testing.assert_array_equal(wd.numpy(), np.asarray(jw["hidden"]["w"]))


def test_scheduler_dense_vs_compact_trajectory_parity_evolving():
    """A fleet with live epochs in both layouts: the same epoch decisions,
    every prediction within ``1e-5``, and the compact fleet holds less."""
    cfg = dataclasses.replace(DCFG, t_steps=12,
                              dsst=DSSTConfig(period=4, prune_frac=0.5),
                              dsst_enabled=True)
    params = snn.init_params(0, cfg, device="cpu")

    def drive(compact):
        svc = TopologyService(cfg, TopologyServiceConfig(epoch_every=3,
                                                         merge_top=1))
        sched = StreamScheduler(params, cfg, n_slots=4, chunk_len=6,
                                topology=svc, compact=compact, device="cpu")
        for sid in range(4):
            ev = (np.random.default_rng(sid).random((36, cfg.n_in))
                  < 0.35).astype(np.float32)
            sched.submit(StreamSession(sid=sid, source=ReplaySource(
                ev, chunk_len=6), adapt=(sid % 2 == 0)))
        return sched, svc, {s.sid: s for s in sched.run_until_drained()}

    sc, vc, dc = drive(True)
    sd, vd, dd = drive(False)
    assert sc.compact and not sd.compact and sd.deltas.dim() == 4
    assert vc.epoch_idx == vd.epoch_idx >= 1
    assert [(e.pruned, e.regrown, e.merged_slots) for e in vc.events] == \
        [(e.pruned, e.regrown, e.merged_slots) for e in vd.events]
    assert torch.equal(sc.params["hidden"]["mask"], sd.params["hidden"]["mask"])
    assert sc.n_compiles == sd.n_compiles == 1
    for sid in dc:
        assert len(dc[sid].predictions) == len(dd[sid].predictions) > 0
        for a, b in zip(dc[sid].predictions, dd[sid].predictions):
            np.testing.assert_allclose(a.logits, b.logits, atol=1e-5)
    idx = topology.stacked_kept_ids(sc.params["hidden"]["mask"], cfg)
    np.testing.assert_allclose(engine.densify_deltas(sc.deltas, idx,
                                                     cfg).numpy(),
                               sd.deltas.numpy(), atol=1e-5)
    assert sc.telemetry.bytes_held()["total"] \
        < sd.telemetry.bytes_held()["total"]


# ------------------------------------------------------------- helpers

def test_sparsity_helpers_match_reference():
    spec = jsparsity.NMSpec(n=2, m=4, block=2, out_tile=4)
    tspec = sparsity.NMSpec(n=2, m=4, block=2, out_tile=4)
    k, o = 16, 8
    jmask = np.asarray(jsparsity.random_unit_mask(jax.random.PRNGKey(0), spec,
                                                  k, o))
    mask = torch.from_numpy(np.array(jmask))
    jidx = np.asarray(jsparsity.compact_indices(jnp.asarray(jmask), spec))
    idx = sparsity.compact_indices(mask, tspec)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert torch.equal(sparsity.indices_to_unit_mask(idx, tspec), mask)
    w = np.random.default_rng(1).standard_normal((k, o)).astype(np.float32)
    jv = np.asarray(jsparsity.compact_values(jnp.asarray(w), jnp.asarray(jidx),
                                             spec))
    v = sparsity.compact_values(torch.from_numpy(w), idx, tspec)
    np.testing.assert_array_equal(v.numpy(), jv)
    back = sparsity.densify_values(v, idx, tspec, k, o)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jsparsity.densify_values(
            jnp.asarray(jv), jnp.asarray(jidx), spec, k, o)))
    np.testing.assert_array_equal(
        back.numpy(), w * np.asarray(jsparsity.expand_unit_mask(
            jnp.asarray(jmask), spec, k, o)))


def test_topology_and_dsst_helpers_match_reference(jparams, params):
    assert topology.specs(CFG) == tuple(
        sparsity.NMSpec(**dataclasses.asdict(s)) for s in jtopology.specs(JCFG))
    for l in range(CFG.n_layers):
        np.testing.assert_array_equal(
            topology.layer_mask(params["hidden"]["mask"], l, CFG).numpy(),
            np.asarray(jtopology.layer_mask(jparams["hidden"]["mask"], l,
                                            JCFG)))
    t, jt = topology.from_params(params, CFG), jtopology.from_params(jparams,
                                                                     JCFG)
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(jt.idx))
    g = np.random.default_rng(4).standard_normal((32, 32)).astype(np.float32)
    spec = CFG.spec(32)
    np.testing.assert_array_equal(
        dsst.dense_grad_unit_score(torch.from_numpy(g), spec).numpy(),
        np.asarray(jdsst.dense_grad_unit_score(jnp.asarray(g),
                                               JCFG.spec(32))))
    # maybe_dsst: the identity off-cycle, one factored event on it
    w, m = engine.hidden_slice(params, 0, CFG)
    jw, jm = jengine.hidden_slice(jparams, 0, JCFG)
    r = np.random.default_rng(5)
    pre, post = (r.random(n).astype(np.float32) for n in m.shape)
    acc = dsst.DSSTAccumulator(torch.from_numpy(pre), torch.from_numpy(post))
    jacc = jdsst.DSSTAccumulator(jnp.asarray(pre), jnp.asarray(post))
    dcfg, jdcfg = CFG.dsst, JCFG.dsst
    assert dsst.maybe_dsst(0, dcfg, spec, w, m, acc)[3] is False
    for step in (3, 7):
        w2, m2, acc2, did = dsst.maybe_dsst(step, dcfg, spec, w, m, acc)
        jw2, jm2, jacc2, jdid = jdsst.maybe_dsst(step, jdcfg, JCFG.spec(32),
                                                 jw, jm, jacc)
        assert did is True and bool(jdid)
        np.testing.assert_array_equal(m2.numpy(), np.asarray(jm2))
        np.testing.assert_array_equal(w2.numpy(), np.asarray(jw2))
        assert not acc2.pre.any() and acc2.pre.shape == acc.pre.shape


def test_stack_params_and_fresh_lane_state_match_reference(jparams, params):
    legacy = engine.unstack_params(params, CFG)
    jlegacy = jengine.unstack_params(jparams, JCFG)
    for a, b in zip(legacy["hidden"], jlegacy["hidden"]):
        np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))
        np.testing.assert_array_equal(a["mask"].numpy(), np.asarray(b["mask"]))
    back = engine.stack_params(legacy, CFG)
    for k in ("w", "mask"):
        assert torch.equal(back["hidden"][k], params["hidden"][k])
    assert torch.equal(back["readout"], params["readout"])
    for compact in (None, True, False):
        st, d = fresh_lane_state(CFG, compact, device="cpu")
        jst, jd = jfresh_lane_state(JCFG, compact)
        assert tuple(d.shape) == jd.shape and not d.any()
        for a, b in zip(jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(jst)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_non_uniform_fleet_serves_dense_with_epochs_as_reference():
    """Fan-ins that differ across layers (48 -> 32 -> 32) have no compact
    layout: the fleet picks the dense one, serves through ``pre @ w`` and
    evolves with the per-layer epoch. Same epochs and masks as the
    reference; predictions within ``1e-4`` (the serving tolerance)."""
    kw = dict(n_in=48, n_hidden=32, n_layers=2, n_out=8, t_steps=12)
    cfg = snn.SNNConfig(**kw, dsst=DSSTConfig(period=4, prune_frac=0.5))
    jcfg = jsnn.SNNConfig(**kw, dsst=jdsst.DSSTConfig(period=4,
                                                      prune_frac=0.5))
    jp = jax.device_get(jsnn.init_params(jax.random.PRNGKey(2), jcfg))
    p = convert.params_from_numpy(jp, cfg, "cpu")
    svc_cfg = dict(epoch_every=3, merge_top=1)
    jsvc = JTopologyService(jcfg, JServiceConfig(**svc_cfg))
    svc = TopologyService(cfg, TopologyServiceConfig(**svc_cfg))
    jsched = JStreamScheduler(jp, jcfg, n_slots=2, chunk_len=CHUNK,
                              topology=jsvc)
    sched = StreamScheduler(p, cfg, n_slots=2, chunk_len=CHUNK, device="cpu",
                            topology=svc)
    assert not sched.compact and sched.deltas.shape == (2, 2, 48, 32)
    for sid in range(2):
        ev = (np.random.default_rng(40 + sid).random((8 * CHUNK, 48))
              < 0.3).astype(np.float32)
        jsched.submit(JStreamSession(sid=sid, source=JReplaySource(
            ev, chunk_len=CHUNK)))
        sched.submit(StreamSession(sid=sid, source=ReplaySource(
            ev, chunk_len=CHUNK)))
    want = {s.sid: s for s in jsched.run_until_drained()}
    got = {s.sid: s for s in sched.run_until_drained()}
    assert svc.epoch_idx == jsvc.epoch_idx >= 2 and sched.n_compiles == 1
    assert [(e.pruned, e.regrown, e.merged_slots) for e in svc.events] == \
        [(e.pruned, e.regrown, e.merged_slots) for e in jsvc.events]
    _assert_same_serving(want, got, jsched, sched)
    assert topology.check(sched.params["hidden"]["mask"], cfg)
