"""The port's training path (``snn.run_sample`` over ``engine.scan_sample``)
against the JAX reference, and train ≡ serve inside the port.

Tolerances: ``1e-5`` on logits, weights, gate state and DSST accumulators:
the same f32 operations, up to the summation order of the products and
norms. That holds only while no spike flips (a flip moves a membrane by θ
and then propagates), and a spike may flip only where the pre-reset
membrane is within rounding of θ: so the tests record every pre-reset
membrane of the port's LIF calls and assert that none lies within ``1e-5``
of θ, which makes a flip impossible and the strict comparison valid.
Masks after each DSST epoch and the gate's open counts must be exactly
equal. Train ≡ serve inside the port follows
``tests/test_train_serve_equivalence.py`` (``1e-5``; ``rtol 1e-6`` on the
energy counters).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsst as jdsst
from repro.core import engine as jengine
from repro.core import gating as jgating
from repro.core import snn as jsnn
from repro.serving import adapt as jadapt
from repro_torch import convert
from repro_torch.core import dsst, engine, gating, snn, topology
from repro_torch.serving import merge_lane_into_base

torch.set_num_threads(1)

KW = dict(n_in=32, n_hidden=32, n_layers=2, n_out=4, t_steps=12)
B = 4
N_SAMPLES = 8          # DSST period 4: epochs after samples 3 and 7


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _cfgs(jbackend="ref", backend="ref", **kw):
    kw = {**KW, **kw}
    return (jsnn.SNNConfig(**kw, backend=jbackend,
                           dsst=jdsst.DSSTConfig(period=4, prune_frac=0.5)),
            snn.SNNConfig(**kw, backend=backend,
                          dsst=dsst.DSSTConfig(period=4, prune_frac=0.5)))


def _samples(seed, n, cfg, b=B):
    rng = np.random.default_rng(seed)
    return [((rng.random((cfg.t_steps, b, cfg.n_in)) < 0.3).astype(np.float32),
             rng.integers(0, cfg.n_out, b).astype(np.int32)) for _ in range(n)]


class _MembraneRecorder:
    """Wraps ``engine.lif`` to keep the pre-reset membrane of every call."""

    def __init__(self, monkeypatch, theta):
        self.near, self.calls, self.theta = 0, 0, theta
        orig = engine.lif

        def lif(*args, **kw):
            v, tr, s = orig(*args, **kw)
            pre_reset = v + s * self.theta
            self.near += int(((pre_reset - self.theta).abs() < 1e-5).sum())
            self.calls += 1
            return v, tr, s
        monkeypatch.setattr(engine, "lif", lif)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                               rtol=1e-5, err_msg=what)


@pytest.mark.parametrize("jbackend,backend,fanin", [
    ("ref", "ref", 32), ("pallas-interpret", "kernels", 32),
    ("ref", "ref", 64)])          # n_in 64 > n_hidden: non-uniform fan-in
def test_run_sample_matches_reference_across_dsst_epochs(
        monkeypatch, jbackend, backend, fanin):
    jcfg, cfg = _cfgs(jbackend, backend, n_in=fanin)
    jp = jsnn.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_numpy(_np(jp), cfg, "cpu")
    js = jsnn.init_state(jcfg, B)
    ts = convert.net_state_from_numpy(_np(js), "cpu")
    assert ts.sample_idx == 0 and isinstance(ts.sample_idx, int)
    jstep, tstep = jsnn.make_train_fn(jcfg), snn.make_train_fn(cfg)
    rec = _MembraneRecorder(monkeypatch, cfg.theta)
    mask0 = tp["hidden"]["mask"].clone()
    for i, (ev, lab) in enumerate(_samples(1, N_SAMPLES, cfg)):
        jp, js, jm = jstep(jp, js, jnp.asarray(ev), jnp.asarray(lab))
        tp, ts, tm = tstep(tp, ts, torch.tensor(ev), torch.tensor(lab))
        np.testing.assert_array_equal(tp["hidden"]["mask"].numpy(),
                                      np.asarray(jp["hidden"]["mask"]))
        _close(tm.logits, jm.logits, f"logits, sample {i}")
        _close(tp["hidden"]["w"], jp["hidden"]["w"], f"weights, sample {i}")
        _close(tp["readout"], jp["readout"], f"readout, sample {i}")
        for name in ("sop_forward", "sop_wu", "sop_wu_offered",
                     "gate_open_frac", "local_loss"):
            np.testing.assert_allclose(float(getattr(tm, name)),
                                       float(getattr(jm, name)), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        _close(ts.gate.ss_mean, js.gate.ss_mean, "ss_mean")
        np.testing.assert_array_equal(ts.gate.opened.numpy(),
                                      np.asarray(js.gate.opened))
        np.testing.assert_array_equal(ts.gate.offered.numpy(),
                                      np.asarray(js.gate.offered))
        for a, b in zip(ts.acc, js.acc):
            _close(a.pre, b.pre, "acc.pre")
            _close(a.post, b.post, "acc.post")
        for a, b in zip(ts.layers, js.layers):
            _close(a, b, "layers")
        assert ts.sample_idx == int(js.sample_idx) == i + 1
    assert rec.calls == N_SAMPLES * cfg.t_steps * cfg.n_layers
    assert rec.near == 0, "a membrane within rounding of θ: pick another seed"
    # both epochs fired and changed the topology
    assert not torch.equal(tp["hidden"]["mask"], mask0)
    assert topology.check(tp["hidden"]["mask"], cfg)
    assert float(gating.skip_rate(ts.gate)) == \
        pytest.approx(float(jgating.skip_rate(js.gate)))


def test_eval_fn_and_accuracy_match_reference():
    jcfg, cfg = _cfgs()
    jp = jsnn.init_params(jax.random.PRNGKey(3), jcfg)
    tp = convert.params_from_numpy(_np(jp), cfg, "cpu")
    (ev, lab), = _samples(4, 1, cfg, b=16)
    js, jm = jsnn.make_eval_fn(jcfg)(jp, jsnn.init_state(jcfg, 16),
                                     jnp.asarray(ev))
    ts, tm = snn.make_eval_fn(cfg)(tp, snn.init_state(cfg, 16, "cpu"),
                                   torch.tensor(ev))
    _close(tm.logits, jm.logits, "logits")
    assert float(snn.accuracy(tm.logits, torch.tensor(lab))) == \
        float(jsnn.accuracy(jm.logits, jnp.asarray(lab)))
    assert ts.sample_idx == 1 and float(tm.sop_wu) == 0.0


def _layer_inputs(seed, jcfg, compact):
    rng = np.random.default_rng(seed)
    jp = _np(jsnn.init_params(jax.random.PRNGKey(seed), jcfg))
    f32 = np.float32
    st = [rng.uniform(0.0, 1.2, (B, 32)).astype(f32)] + \
        [rng.uniform(0.0, 2.0, (B, 32)).astype(f32) for _ in range(3)]
    if compact:
        w = {k: v[0] for k, v in _np(jsnn.serving_params(jp, jcfg)).items()
             if k in ("wc", "idx")}
    else:
        w = {"w": jp["hidden"]["w"][0],
             "mask_f": np.asarray(jengine.dense_masks(
                 jnp.asarray(jp["hidden"]["mask"]), jcfg))[0]}
    return dict(w=w, readout=jp["readout"][0], st=st,
                ss_mean=f32(rng.uniform(0.1, 1.0)),
                opened=f32(3.0), offered=f32(5.0),
                pre=(rng.random((B, 32)) < 0.4).astype(f32),
                pre_tr=rng.uniform(0.0, 2.0, (B, 32)).astype(f32))


@pytest.mark.parametrize("t_row", [6, 8])            # t_pc = 6, t_wu = 7
@pytest.mark.parametrize("jbackend,backend", [("ref", "ref"),
                                              ("pallas-interpret", "kernels")])
def test_teacher_forced_training_layer_step(jbackend, backend, t_row):
    jcfg, cfg = _cfgs(jbackend, backend)
    inp = _layer_inputs(2, jcfg, compact=backend == "kernels")
    density = jcfg.spec(32).density
    jxs = jengine.LayerSlice(
        w={k: jnp.asarray(v) for k, v in inp["w"].items()},
        readout=jnp.asarray(inp["readout"]),
        st=jengine.LayerState(*map(jnp.asarray, inp["st"])),
        ss_mean=jnp.asarray(inp["ss_mean"]),
        gate_opened=jnp.asarray(inp["opened"]),
        gate_offered=jnp.asarray(inp["offered"]), delta=None,
        fanin=jnp.float32(32.0), density=jnp.float32(density))
    z = jnp.zeros(B)
    jcarry = jengine.LayerCarry(jnp.asarray(inp["pre"]),
                                jnp.asarray(inp["pre_tr"]),
                                jnp.zeros((B, 4)), z, z, z, z)
    t_pc, t_wu = jengine._windows(jcfg)
    jc, jo = _np(jengine._layer_timestep(
        jcfg, jengine.make_backend(jcfg), jengine.geometry(jcfg), True,
        False, False, t_pc, t_wu, jnp.int32(t_row), None, jcarry, jxs))

    t = torch.tensor
    xs = engine.LayerSlice(
        w={k: t(v) for k, v in inp["w"].items()}, readout=t(inp["readout"]),
        st=engine.LayerState(*map(t, inp["st"])), ss_mean=t(inp["ss_mean"]),
        delta=None, fanin=t(32.0), density=t(density),
        gate_opened=t(inp["opened"]), gate_offered=t(inp["offered"]))
    zt = torch.zeros(B)
    carry = engine.LayerCarry(t(inp["pre"]), t(inp["pre_tr"]),
                              torch.zeros((B, 4)), zt, zt, zt, zt)
    tc, to = engine._layer_timestep(cfg, engine.make_backend(cfg),
                                    engine.geometry(cfg), True, False, t_pc,
                                    t_wu, t_row, None, carry, xs)
    cur = engine.fwd_current(t(inp["pre"]), xs.w, None)
    v_pre = cfg.alpha * t(inp["st"][0]) + cur
    assert not bool(((v_pre - cfg.theta).abs() < 1e-5).any())
    for name in tc._fields:
        _close(getattr(tc, name).numpy(), getattr(jc, name), name)
    for a, b in zip(to.st, jo.st):
        _close(a.numpy(), b, "state")
    for k in inp["w"]:
        _close(to.w[k].numpy(), jo.w[k], k)
    _close(to.ss_mean.numpy(), jo.ss_mean, "ss_mean")
    assert bool(to.open_) == bool(jo.open_)
    assert float(to.gate_opened) == float(jo.gate_opened)
    assert float(to.gate_offered) == float(jo.gate_offered) == 6.0
    assert to.delta is None and to.pre_mag is None
    if t_row >= t_wu and bool(to.open_):      # the update really happened
        key = "wc" if "wc" in inp["w"] else "w"
        assert not torch.equal(to.w[key], xs.w[key])


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_train_equals_serve_inside_the_port(depth):
    """All-valid window-aligned serving chunks from zero deltas retrace the
    training path: logits, weight drift ≡ accumulated compact delta,
    carried state, thresholds and energy counters."""
    cfg = snn.SNNConfig(n_in=32, n_hidden=32, n_layers=depth, n_out=8,
                        t_steps=12, dsst_enabled=False)
    T, t_wu, chunk, n_windows = 12, int(12 * cfg.wu_start_frac), 6, 2
    params = snn.init_params(0, cfg, device="cpu")
    ev = (np.random.default_rng(3).random((n_windows * T, 1, 32)) < 0.3) \
        .astype(np.float32)

    ps, st = params, snn.init_state(cfg, 1, "cpu")
    tr = {"logits": [], "fwd": 0.0, "wu": 0.0, "off": 0.0, "loss": 0.0,
          "opens": 0.0}
    for w in range(n_windows):
        ps, st, m = snn.run_sample(ps, st, torch.tensor(ev[w * T:(w + 1) * T]),
                                   None, cfg, learn=True)
        tr["logits"].append(m.logits[0])
        tr["fwd"] += float(m.sop_forward)
        tr["wu"] += float(m.sop_wu)
        tr["off"] += float(m.sop_wu_offered)
        tr["loss"] += float(m.local_loss) * (T - t_wu)
        tr["opens"] += float(m.gate_open_frac) * T * depth

    ss = snn.init_stream_state(cfg, 1, "cpu")
    dl = snn.init_stream_deltas(cfg, 1, "cpu")
    sv = {"logits": [], "fwd": 0.0, "wu": 0.0, "off": 0.0, "loss": 0.0,
          "opens": 0.0}
    for c in range(0, n_windows * T, chunk):
        dl, ss, cm = snn.run_chunk(params, dl, ss, torch.tensor(ev[c:c + chunk]),
                                   torch.ones((chunk, 1), dtype=torch.bool),
                                   cfg, learn=True)
        for t in torch.nonzero(cm.window_end[:, 0]).flatten().tolist():
            sv["logits"].append(cm.logits[t, 0])
        sv["fwd"] += float(cm.sop_forward[0])
        sv["wu"] += float(cm.sop_wu[0])
        sv["off"] += float(cm.sop_wu_offered[0])
        sv["loss"] += float(cm.local_loss[0])
        sv["opens"] += float(cm.gate_opened[0].sum())

    assert len(tr["logits"]) == len(sv["logits"]) == n_windows
    for a, b in zip(tr["logits"], sv["logits"]):
        _close(a, b, "window logits")
    idx = topology.stacked_kept_ids(params["hidden"]["mask"], cfg)
    drift = ps["hidden"]["w"] - params["hidden"]["w"]
    _close(drift, engine.densify_deltas(dl, idx, cfg)[0], "weight drift")
    assert float(drift.abs().max()) > 0.0          # something was learned
    assert torch.equal(ps["readout"], params["readout"])
    _close(st.layers.tr_cc[:, 0], ss.layers.tr_cc[0], "tr_cc")
    _close(st.x_tr[0], ss.x_tr[0], "x_tr")
    _close(st.gate.ss_mean, ss.ss_mean[0], "ss_mean")
    assert st.sample_idx == int(ss.sample_idx[0]) == n_windows
    for k in ("fwd", "wu", "off"):
        np.testing.assert_allclose(tr[k], sv[k], rtol=1e-6)
    np.testing.assert_allclose(tr["opens"], sv["opens"], atol=1e-6)
    np.testing.assert_allclose(tr["loss"], sv["loss"], atol=1e-4)


def test_merge_lane_into_base_matches_reference():
    jcfg, cfg = _cfgs()
    jp = jsnn.init_params(jax.random.PRNGKey(5), jcfg)
    deltas = np.random.default_rng(6).standard_normal(
        jsnn.init_stream_deltas(jcfg, 3).shape).astype(np.float32)
    want = jadapt.merge_lane_into_base(jp, jnp.asarray(deltas), 1, jcfg,
                                       weight=0.5)
    tp = {**convert.params_from_numpy(_np(jp), cfg, "cpu"), "extra": 7}
    got = merge_lane_into_base(tp, torch.tensor(deltas), 1, cfg, weight=0.5)
    np.testing.assert_array_equal(got["hidden"]["w"].numpy(),
                                  np.asarray(want["hidden"]["w"]))
    assert got["extra"] == 7 and got["hidden"]["mask"] is tp["hidden"]["mask"]
    # the base stays exactly zero off the mask
    off = engine.dense_masks(tp["hidden"]["mask"], cfg) == 0
    assert float(got["hidden"]["w"][off].abs().max()) == 0.0


def test_prepare_and_finalize_weights_roundtrip_bitwise():
    _, cfg = _cfgs(backend="kernels")
    params = snn.init_params(1, cfg, device="cpu")
    w = params["hidden"]["w"]
    for backend in ("ref", "kernels"):
        b = engine.make_backend(dataclasses.replace(cfg, backend=backend))
        rep = engine.prepare_weights(w, params["hidden"]["mask"], cfg, b)
        assert ("wc" in rep) == (backend == "kernels")
        assert torch.equal(engine.finalize_weights(rep, cfg, b), w)
    wl, ml = engine.hidden_slice(params, 1, cfg)
    assert wl.shape == (32, 32) and ml.shape == (32, 32)
