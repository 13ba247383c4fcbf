"""The port's checkpoints (``repro_torch.checkpoint``, ``serving.save_fleet``
/ ``restore_fleet``) against the JAX reference's, and against themselves.

Both packages write one layout (``step_%09d/{manifest.json, arrays.npz}``,
leaves keyed by the same path strings), so each restores what the other
saved. Every comparison here is bitwise (no tolerance): a checkpoint moves
stored numbers, it computes none. The reference writes bf16 leaves as raw
2-byte words (numpy ``|V2``) and cannot read them back (its ``restore``
casts them with ``jnp.asarray``); the port reads them, and writes its own
bf16 leaves the same way.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro import checkpoint as jckpt
from repro.core import engine as jengine, snn as jsnn, topology as jtopology
from repro.launch import train as jtrain
from repro.optim import optimizer as jopt
from repro.serving import restore_fleet as jrestore_fleet
from repro.serving import save_fleet as jsave_fleet
import repro_torch.configs as C
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.core import engine, snn, topology
from repro_torch.launch import train
from repro_torch.optim import optimizer as opt
from repro_torch.serving import restore_fleet, save_fleet

torch.set_num_threads(1)

KW = dict(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=8,
          dsst_enabled=False)
JCFG, CFG = jsnn.SNNConfig(**KW), snn.SNNConfig(**KW)


def _tree():
    """The reference test's tree (tests/test_substrate.py), in torch."""
    return {"a": torch.arange(10, dtype=torch.float32),
            "nested": {"b": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                       "c": [torch.ones(2), torch.zeros(3)]}}


def _leaves(tree):
    return [v for _, v in ckpt.checkpoint._flatten(tree)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_equal(got, want):
    """Bitwise, leaf by leaf in flatten order; dtypes equal too."""
    ga, wa = _leaves(got), _leaves(want)
    assert len(ga) == len(wa)
    for a, b in zip(ga, wa):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
        else:
            assert a == b


def _assert_port_equals_ref(port_tree, ref_tree):
    """Port leaves against the reference's, bitwise, in flatten order (the
    two flatteners must walk the same paths)."""
    want = jax.tree_util.tree_leaves(ref_tree)
    got = _leaves(port_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# ------------------------------------------------- the reference's properties

def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, extra={"data_pos": 123})
    step, back, extra = ckpt.restore(str(tmp_path), t)
    assert step == 7 and extra["data_pos"] == 123
    _assert_trees_equal(back, t)


def test_checkpoint_keep_k_and_latest(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, t, keep=3)
    assert ckpt.list_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_checkpoint_corruption_falls_back(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 2, t)
    with open(os.path.join(str(tmp_path), "step_000000002", "arrays.npz"),
              "wb") as f:
        f.write(b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 1
    step, _, _ = ckpt.restore(str(tmp_path), t)
    assert step == 1


def test_truncated_arrays_skipped_and_no_checkpoint_raises(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 2, t)
    path = os.path.join(str(tmp_path), "step_000000002", "arrays.npz")
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    assert ckpt.latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), t)


# --------------------------------------------------------- keys and dtypes

def _snn_train_states(seed=0):
    jp = jax.device_get(jsnn.init_params(jax.random.PRNGKey(seed), JCFG))
    js = jax.device_get(jsnn.init_state(JCFG, 3))
    r = np.random.default_rng(seed)
    js = jax.tree.map(lambda a: (r.standard_normal(a.shape).astype(a.dtype)
                                 if a.dtype == np.float32 else a), js)
    js = js._replace(sample_idx=np.asarray(17, np.int32))
    tp = convert.params_from_numpy(jp, CFG, "cpu")
    ts = convert.net_state_from_numpy(js, "cpu")
    return {"params": jp, "state": js}, {"params": tp, "state": ts}


def test_manifest_keys_equal_the_reference(tmp_path):
    jtree, ttree = _snn_train_states()
    jckpt.save(str(tmp_path / "j"), 3, jtree)
    ckpt.save(str(tmp_path / "t"), 3, ttree)
    man = [json.load(open(str(tmp_path / d / "step_000000003"
                              / "manifest.json"))) for d in ("j", "t")]
    assert man[0]["keys"] == man[1]["keys"]
    assert "state/.layers/.v" in man[1]["keys"]
    assert "state/.acc/1/.pre" in man[1]["keys"]
    # the stored arrays are the same bytes with the same dtypes (the host
    # int sample_idx as a 0-d int32)
    with np.load(str(tmp_path / "j/step_000000003/arrays.npz")) as zj, \
            np.load(str(tmp_path / "t/step_000000003/arrays.npz")) as zt:
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
            assert zj[k].tobytes() == zt[k].tobytes(), k


# ------------------------------------------------------- across the packages

@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snn_training_state_restores_across_packages(tmp_path, direction):
    jtree, ttree = _snn_train_states(seed=1)
    d = str(tmp_path)
    if direction == "ref_to_port":
        jckpt.save(d, 5, jtree, extra={"pos": 9})
        template = {"params": snn.init_params(5, CFG, device="cpu"),
                    "state": snn.init_state(CFG, 3, device="cpu")}
        step, back, extra = ckpt.restore(d, template)
        assert isinstance(back["state"].sample_idx, int)
        assert back["state"].sample_idx == 17
        assert back["params"]["hidden"]["mask"].dtype == torch.bool
        _assert_port_equals_ref(back, jtree)
    else:
        ckpt.save(d, 5, ttree, extra={"pos": 9})
        template = jax.tree.map(np.zeros_like, jtree)
        step, back, extra = jckpt.restore(d, template)
        assert back["state"].sample_idx.dtype == jnp.int32
        _assert_port_equals_ref(ttree, back)
    assert step == 5 and extra == {"pos": 9}


def _lm_states():
    jc, tc = JC.get_reduced("stablelm_12b"), C.get_reduced("stablelm_12b")
    jhp = jtrain.TrainHParams(opt=jopt.AdamWConfig(lr=1e-3))
    jp, jo, js = jax.device_get(jtrain.init_train_state(
        jax.random.PRNGKey(0), jc, jhp))
    r = np.random.default_rng(2)
    rand = lambda a: (r.standard_normal(a.shape).astype(a.dtype)  # noqa: E731
                      if a.dtype == np.float32 else a)
    jo = jopt.AdamWState(step=np.asarray(11, np.int32),
                         m=jax.tree.map(rand, jo.m), v=jax.tree.map(rand, jo.v))
    js = jax.tree.map(rand, js)
    tp = convert.lm_params_from_numpy(jp, tc, "cpu")
    to, ts = convert.train_state_from_numpy(jo, js, "cpu")
    return tc, (jp, jo, js), (tp, to, ts)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_lm_training_state_restores_across_packages(tmp_path, direction):
    """A reduced f32 LM's ``(params, AdamWState, SparseTrainState)``, the
    host-int ``step`` included."""
    tc, jtree, ttree = _lm_states()
    d = str(tmp_path)
    if direction == "ref_to_port":
        jckpt.save(d, 4, jtree)
        template = train.init_train_state(torch.Generator().manual_seed(9),
                                          tc, train.TrainHParams(), "cpu")
        _, back, _ = ckpt.restore(d, template)
        assert isinstance(back[1].step, int) and back[1].step == 11
        _assert_port_equals_ref(back, jtree)
        for a, b in zip(_leaves(back), _leaves(template)):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype
    else:
        ckpt.save(d, 4, ttree)
        _, back, _ = jckpt.restore(d, jax.tree.map(np.zeros_like, jtree))
        assert back[1].step.dtype == jnp.int32 and int(back[1].step) == 11
        _assert_port_equals_ref(ttree, back)


def test_port_reads_a_reference_bf16_leaf_bitwise(tmp_path):
    x = jax.random.normal(jax.random.PRNGKey(3), (5, 7)).astype(jnp.bfloat16)
    jckpt.save(str(tmp_path), 0, {"w": x, "n": jnp.arange(3)})
    _, shapes, _ = ckpt.peek(str(tmp_path))
    assert shapes["w"] == ((5, 7), "|V2")
    _, back, _ = ckpt.restore(str(tmp_path), {
        "w": torch.zeros((5, 7), dtype=torch.bfloat16),
        "n": torch.zeros(3, dtype=torch.int32)})
    assert back["w"].dtype == torch.bfloat16
    want = np.asarray(x).view(np.uint16)
    assert np.array_equal(back["w"].view(torch.int16).numpy().view(np.uint16),
                          want)


def test_bf16_round_trip_in_the_port(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn((33, 9), generator=g).to(torch.bfloat16)
    w[0, :3] = torch.tensor([float("inf"), -0.0, float("nan")])
    t = {"w": w, "rows": torch.arange(4), "step": 3}
    ckpt.save(str(tmp_path), 1, t)
    with np.load(str(tmp_path / "step_000000001/arrays.npz")) as z:
        assert z["w"].dtype == np.dtype("V2")
        assert z["rows"].dtype == np.int32 and z["step"].dtype == np.int32
    _, back, _ = ckpt.restore(str(tmp_path), t)
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))
    assert back["rows"].dtype == torch.int64 and back["step"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_zero_dim_leaves_keep_their_shape(tmp_path, dtype):
    """A 0-d tensor leaf (a scalar state) restores 0-d, also into a
    ``meta`` template onto a device."""
    t = {"s": torch.tensor(3, dtype=dtype), "v": torch.arange(2, dtype=dtype)}
    ckpt.save(str(tmp_path), 0, t)
    _, back, _ = ckpt.restore(str(tmp_path), t)
    _assert_trees_equal(back, t)
    tpl = {k: torch.empty_like(v, device="meta") for k, v in t.items()}
    _, back, _ = ckpt.restore(str(tmp_path), tpl, device="cpu")
    _assert_trees_equal(back, t)


# -------------------------------------------------------------- fleets

def _fleet(seed=0, compact=True):
    """A fleet state after one learning chunk, in both packages."""
    jp = jax.device_get(jsnn.init_params(jax.random.PRNGKey(seed), JCFG))
    tp = convert.params_from_numpy(jp, CFG, "cpu")
    S, Cn = 3, 8
    ev = (np.random.default_rng(seed + 6).random((Cn, S, CFG.n_in))
          < 0.3).astype(np.float32)
    d, st, _ = snn.run_chunk(snn.serving_params(tp, CFG),
                             snn.init_stream_deltas(CFG, S, "cpu"),
                             snn.init_stream_state(CFG, S, "cpu"),
                             torch.tensor(ev), torch.ones((Cn, S), dtype=bool),
                             CFG)
    if not compact:
        idx = topology.stacked_kept_ids(tp["hidden"]["mask"], CFG)
        d = engine.densify_deltas(d, idx, CFG)
    return jp, tp, d, st


def test_fleet_checkpoint_roundtrip_and_migration(tmp_path):
    _, tp, dc, stc = _fleet()
    idx = topology.stacked_kept_ids(tp["hidden"]["mask"], CFG)
    dd = engine.densify_deltas(dc, idx, CFG)
    # compact-stored -> compact fleet: bitwise
    save_fleet(str(tmp_path / "c"), 5, tp, dc, stc)
    step, p2, d2, s2, extra = restore_fleet(str(tmp_path / "c"), CFG,
                                            device="cpu")
    assert step == 5 and extra == {"n_slots": 3, "delta_layout": "compact"}
    assert torch.equal(d2, dc)
    _assert_trees_equal((p2, s2), (tp, stc))
    # dense-stored -> compact fleet: migrated, bitwise at kept coordinates
    save_fleet(str(tmp_path / "d"), 9, tp, dd, stc)
    step, _, d3, _, extra = restore_fleet(str(tmp_path / "d"), CFG,
                                          compact=True, device="cpu")
    assert step == 9 and extra["delta_layout"] == "dense"
    assert torch.equal(d3, dc)
    # compact-stored -> dense fleet densifies (zeros off the mask)
    _, _, d4, _, _ = restore_fleet(str(tmp_path / "c"), CFG, compact=False,
                                   device="cpu")
    assert torch.equal(d4, dd)
    dm = topology.dense_masks(tp["hidden"]["mask"], CFG)
    assert not d4[dm[None].expand_as(d4) == 0].any()


@pytest.mark.parametrize("layout", ["compact", "dense"])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_fleet_restores_across_packages(tmp_path, direction, layout):
    jp, tp, d, st = _fleet(seed=2, compact=layout == "compact")
    jd = d.numpy()
    jst = jsnn.StreamState(
        layers=type(jsnn.init_stream_state(JCFG, 1).layers)(
            *(t.numpy() for t in st.layers)),
        x_tr=st.x_tr.numpy(), ss_mean=st.ss_mean.numpy(),
        t_in_window=st.t_in_window.numpy(), sample_idx=st.sample_idx.numpy())
    dpath = str(tmp_path)
    compact = layout == "compact"
    if direction == "ref_to_port":
        jsave_fleet(dpath, 3, jp, jnp.asarray(jd), jst)
        step, p2, d2, s2, extra = restore_fleet(dpath, CFG, compact=compact,
                                                device="cpu")
        _assert_port_equals_ref((p2, d2, s2), (jp, jd, jst))
    else:
        save_fleet(dpath, 3, tp, d, st)
        step, p2, d2, s2, extra = jrestore_fleet(dpath, JCFG, compact=compact)
        _assert_port_equals_ref((tp, d, st), (p2, d2, s2))
    assert step == 3 and extra["delta_layout"] == layout
    # the other layout migrates to the same bits on both sides
    if direction == "port_to_ref":
        got = restore_fleet(dpath, CFG, compact=not compact, device="cpu")[2]
        want = jrestore_fleet(dpath, JCFG, compact=not compact)[2]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_restore_fleet_template_holds_no_memory(tmp_path):
    """The fleet template is built from the stored shapes on the ``meta``
    device (no weights drawn, nothing allocated), and the restore lands on
    the device asked for."""
    from repro_torch.serving import checkpointing
    _, tp, dc, stc = _fleet()
    save_fleet(str(tmp_path), 1, tp, dc, stc)
    _, shapes, _ = ckpt.peek(str(tmp_path))
    template = checkpointing._template(CFG, shapes)
    assert {t.device.type for t in _leaves(template)} == {"meta"}
    _, p2, d2, s2, _ = restore_fleet(str(tmp_path), CFG, device="cpu")
    assert {t.device.type for t in _leaves((p2, d2, s2))} == {"cpu"}
