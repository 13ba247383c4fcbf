"""The port's serving engine against the JAX reference on the same weights.

Tolerances: one teacher-forced layer step ``atol = 1e-5`` — the same f32
operations in the same order, up to the summation order of the sparse
product and the norms. A spike may differ only where the pre-reset
membrane is within ``1e-5`` of the threshold, and such slots are then
excluded from the state comparison (the reset moves ``v`` by ``θ``). Over
many steps the rounding differences can flip threshold crossings, which
then propagate, so trajectories are held to ``>= 99 %`` spike agreement
and logits ``atol = 1e-4``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import snn as jsnn
from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.snn import (SNNConfig, init_stream_deltas,
                                  init_stream_state, run_chunk,
                                  serving_params)

torch.set_num_threads(1)

KW = dict(n_in=16, n_hidden=16, n_layers=2, n_out=4, t_steps=6)
JCFG = jsnn.SNNConfig(**KW)
CFG = SNNConfig(**KW)
S = 4


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(jsnn.init_params(jax.random.PRNGKey(0), JCFG))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_serving_params_match_reference(jparams):
    want = _np(jsnn.serving_params(jparams, JCFG))
    got = serving_params(convert.params_from_numpy(jparams, CFG, "cpu"), CFG)
    for k in ("wc", "idx", "readout"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def _layer_inputs(jparams, seed):
    rng = np.random.default_rng(seed)
    sp = _np(jsnn.serving_params(jparams, JCFG))
    j, t = sp["idx"].shape[1:]
    f32 = np.float32
    st = [rng.uniform(0.0, 1.2, (S, 16)).astype(f32)] + \
        [rng.uniform(0.0, 2.0, (S, 16)).astype(f32) for _ in range(3)]
    return dict(
        wc=sp["wc"][0], idx=sp["idx"][0], readout=sp["readout"][0], st=st,
        ss_mean=rng.uniform(0.1, 1.0, S).astype(f32),
        delta=(0.05 * rng.standard_normal((S, j, t, 1, 1))).astype(f32),
        pre=(rng.random((S, 16)) < 0.4).astype(f32),
        pre_tr=rng.uniform(0.0, 2.0, (S, 16)).astype(f32),
        t_row=np.array([3, 4, 5, 1], np.int32),     # t_pc = 3, t_wu = 3
        valid=np.array([True, True, False, True]))


def _run_jax(inp, learn):
    geo = jengine.geometry(JCFG)
    xs = jengine.LayerSlice(
        w={"wc": jnp.asarray(inp["wc"]), "idx": jnp.asarray(inp["idx"])},
        readout=jnp.asarray(inp["readout"]),
        st=jengine.LayerState(*map(jnp.asarray, inp["st"])),
        ss_mean=jnp.asarray(inp["ss_mean"]), gate_opened=None,
        gate_offered=None, delta=jnp.asarray(inp["delta"]),
        fanin=jnp.float32(16.0), density=jnp.float32(JCFG.spec(16).density))
    z = jnp.zeros(S)
    carry = jengine.LayerCarry(jnp.asarray(inp["pre"]), jnp.asarray(inp["pre_tr"]),
                               jnp.zeros((S, 4)), z, z, z, z)
    t_pc, t_wu = jengine._windows(JCFG)
    return _np(jengine._layer_timestep(
        JCFG, jengine.make_backend(JCFG), geo, learn, True, True, t_pc, t_wu,
        jnp.asarray(inp["t_row"]), jnp.asarray(inp["valid"]), carry, xs))


def _run_torch(inp, learn, backend):
    cfg = SNNConfig(**KW, backend=backend)
    t = lambda a: torch.tensor(a)
    xs = engine.LayerSlice(
        w={"wc": t(inp["wc"]), "idx": t(inp["idx"])}, readout=t(inp["readout"]),
        st=engine.LayerState(*map(t, inp["st"])), ss_mean=t(inp["ss_mean"]),
        delta=t(inp["delta"]), fanin=torch.tensor(16.0),
        density=torch.tensor(cfg.spec(16).density))
    z = torch.zeros(S)
    carry = engine.LayerCarry(t(inp["pre"]), t(inp["pre_tr"]),
                              torch.zeros((S, 4)), z, z, z, z)
    t_pc, t_wu = engine._windows(cfg)
    c, o = engine._layer_timestep(cfg, engine.make_backend(cfg),
                                  engine.geometry(cfg), learn, True, t_pc,
                                  t_wu, t(inp["t_row"]), t(inp["valid"]),
                                  carry, xs)
    to_np = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x
    return (type(c)(*map(to_np, c)),
            o._replace(st=type(o.st)(*map(to_np, o.st)),
                       **{k: to_np(getattr(o, k)) for k in
                          ("delta", "ss_mean", "open_", "pre_mag", "post_mag")}))


@pytest.mark.parametrize("learn", [True, False])
@pytest.mark.parametrize("backend", ["ref", "kernels"])
@pytest.mark.parametrize("seed", [0, 1])
def test_teacher_forced_layer_step(jparams, seed, learn, backend):
    inp = _layer_inputs(jparams, seed)
    jc, jo = _run_jax(inp, learn)
    tc, to = _run_torch(inp, learn, backend)
    # spikes may flip only at the threshold
    cur = engine.fwd_current(torch.tensor(inp["pre"]),
                             {"wc": torch.tensor(inp["wc"]),
                              "idx": torch.tensor(inp["idx"])},
                             torch.tensor(inp["delta"])).numpy()
    v_pre = CFG.alpha * inp["st"][0] + cur
    flips = tc.pre_spikes != jc.pre_spikes
    assert not (flips & (np.abs(v_pre - CFG.theta) >= 1e-5)).any()
    keep = ~flips.any(1)                              # slots without a flip
    for name in ("logits", "sop_fwd", "sop_wu", "sop_wu_off", "loss"):
        np.testing.assert_allclose(getattr(tc, name)[keep],
                                   getattr(jc, name)[keep], atol=1e-5,
                                   err_msg=name)
    for a, b in zip(to.st, jo.st):
        np.testing.assert_allclose(a[keep], b[keep], atol=1e-5)
    np.testing.assert_allclose(to.delta[keep], jo.delta[keep], atol=1e-5)
    np.testing.assert_allclose(to.ss_mean, jo.ss_mean, atol=1e-5)
    np.testing.assert_array_equal(to.open_, jo.open_)
    np.testing.assert_allclose(to.pre_mag, jo.pre_mag, atol=1e-5)
    np.testing.assert_allclose(to.post_mag[keep], jo.post_mag[keep], atol=1e-5)


def _events(seed, c, s, rate=0.35):
    rng = np.random.default_rng(seed)
    ev = (rng.random((c, s, 16)) < rate).astype(np.float32)
    valid = rng.random((c, s)) < 0.85
    return ev, valid


def _spikes(tr_old, st_new, beta):
    """Per-layer spikes of the step that moved ``tr_old`` to ``st_new``:
    ``tr' = β·tr + s``, read from ``tr_cc`` where the window rolled."""
    tr_new = np.where(np.asarray(st_new.t_in_window)[:, None, None] == 0,
                      np.asarray(st_new.layers.tr_cc),
                      np.asarray(st_new.layers.tr))
    return np.rint(tr_new - beta * np.asarray(tr_old))


def test_run_chunk_trajectory_matches_reference(jparams):
    """18 single-timestep chunks (3 windows) of 4 slots, ragged validity:
    per-step spikes >= 99 % equal, logits close, deltas close at the end."""
    sp_j = jsnn.serving_params(jparams, JCFG)
    sp_t = serving_params(convert.params_from_numpy(jparams, CFG, "cpu"), CFG)
    js, jd = jsnn.init_stream_state(JCFG, S), jsnn.init_stream_deltas(JCFG, S)
    ts, td = init_stream_state(CFG, S, "cpu"), init_stream_deltas(CFG, S, "cpu")
    ev, valid = _events(5, 18, S)
    agree, total = 0, 0
    for c in range(18):
        jtr, ttr = np.asarray(js.layers.tr), ts.layers.tr.numpy()
        jd, js, jm = jsnn.run_chunk(sp_j, jd, js, jnp.asarray(ev[c:c + 1]),
                                    jnp.asarray(valid[c:c + 1]), JCFG)
        td, ts, tm = run_chunk(sp_t, td, ts, torch.tensor(ev[c:c + 1]),
                               torch.tensor(valid[c:c + 1]), CFG)
        sj, st_ = _spikes(jtr, js, CFG.beta), _spikes(ttr, ts, CFG.beta)
        vm = valid[c][:, None, None]
        agree += int(((sj == st_) & vm).sum())
        total += int(np.broadcast_to(vm, sj.shape).sum())
        np.testing.assert_allclose(tm.logits.numpy(), np.asarray(jm.logits),
                                   atol=1e-4)
        np.testing.assert_array_equal(tm.window_end.numpy(),
                                      np.asarray(jm.window_end))
    assert agree / total >= 0.99, agree / total
    assert int(ts.sample_idx.sum()) == int(np.asarray(js.sample_idx).sum()) > 0
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


@pytest.mark.parametrize("jbackend,backend", [("ref", "ref"),
                                              ("pallas-interpret", "kernels")])
def test_run_chunk_multi_step_chunks_match_reference(jparams, jbackend,
                                                      backend):
    """Chunks of several timesteps, with the DSST factors on; the
    reference's kernel path (Pallas in interpret mode) for one chunk."""
    import dataclasses
    jcfg = dataclasses.replace(JCFG, backend=jbackend)
    cfg = SNNConfig(**KW, backend=backend)
    n_chunks = 3 if jbackend == "ref" else 1
    sp_j = jsnn.serving_params(jparams, jcfg)
    sp_t = convert.serving_params_from_numpy(_np(sp_j), "cpu")
    js, jd = jsnn.init_stream_state(jcfg, S), jsnn.init_stream_deltas(jcfg, S)
    ts = convert.stream_state_from_numpy(_np(js), "cpu")
    td = convert.deltas_from_numpy(np.asarray(jd), "cpu")
    ev, valid = _events(7, 5 * n_chunks, S)
    for c in range(n_chunks):
        sl = slice(5 * c, 5 * c + 5)
        jd, js, jm = jsnn.run_chunk(sp_j, jd, js, jnp.asarray(ev[sl]),
                                    jnp.asarray(valid[sl]), jcfg)
        td, ts, tm = run_chunk(sp_t, td, ts, torch.tensor(ev[sl]),
                               torch.tensor(valid[sl]), cfg)
        np.testing.assert_allclose(tm.logits.numpy(), np.asarray(jm.logits),
                                   atol=1e-4)
        for name in ("sop_forward", "sop_wu", "gate_opened", "steps",
                     "pre_mag", "post_mag"):
            np.testing.assert_allclose(getattr(tm, name).numpy(),
                                       np.asarray(getattr(jm, name)),
                                       atol=1e-4, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_allclose(ts.layers.v.numpy(), np.asarray(js.layers.v),
                               atol=1e-4)
    np.testing.assert_array_equal(ts.t_in_window.numpy(),
                                  np.asarray(js.t_in_window))


def test_all_invalid_chunk_is_exact_noop(jparams):
    sp = serving_params(convert.params_from_numpy(jparams, CFG, "cpu"), CFG)
    st, dl = init_stream_state(CFG, 2, "cpu"), init_stream_deltas(CFG, 2, "cpu")
    ev, _ = _events(4, 5, 2)
    dl2, st2, m = run_chunk(sp, dl, st, torch.tensor(ev),
                            torch.zeros((5, 2), dtype=torch.bool), CFG)
    assert torch.equal(dl2, dl)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(st)),
                    jax.tree_util.tree_leaves(tuple(st2))):
        assert torch.equal(a, b)
    assert float(m.sop_forward.sum()) == 0.0 == float(m.steps.sum())


def test_ordered_slot_sum_matches_reference_bitwise():
    x = np.random.default_rng(0).standard_normal((7, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        engine.ordered_slot_sum(torch.tensor(x)).numpy(),
        np.asarray(jengine.ordered_slot_sum(jnp.asarray(x))))
