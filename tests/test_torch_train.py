"""The port's LM training path (``optim``, ``core/ossl``, ``data/pipeline``,
``launch/train``, the training half of ``models/transformer``) against the
JAX reference, on the reference's weights and states carried across as
numpy.

Tolerances (f32 reduced configs): single functions on identical inputs
``1e-5`` relative (the same f32 arithmetic, summed in other orders); the
train step's loss ``rtol 1e-5`` and each gradient leaf within ``1e-4`` of
its largest element (a whole forward and backward deep: products summed in
other orders at every layer). AdamW is held on identical inputs only:
``m/(sqrt(v)+eps)`` turns the sign of a gradient that is rounding noise
into a full ``±lr`` step, so params after two frameworks' gradients are
not compared element by element. Batches, masks and gate decisions on
identical inputs are exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.base import SparsityConfig as JSparsityConfig
from repro.core import gating as jgating, ossl as jossl
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.optim import optimizer as jopt, sparse as jsparse
import repro_torch.configs as C
from repro_torch import convert
from repro_torch.configs.base import SparsityConfig
from repro_torch.core import gating, ossl
from repro_torch.data import pipeline as pipe
from repro_torch.kernels.adamw import ref as adamw_ref
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt, sparse

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    x = torch.tensor(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=rtol * max(1e-30, float(np.abs(want).max())))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _jflat(tree):
    return {tuple(str(getattr(p, "key", p)) for p in k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,host,hosts", [(0, 0, 1), (7, 1, 2), (123, 3, 4)])
def test_pipeline_batches_equal_reference(step, host, hosts):
    kw = dict(vocab=151936, seq_len=64, global_batch=8, seed=3)
    got = pipe.synthetic_lm_batch(pipe.PipelineConfig(**kw), step, host, hosts)
    want = jpipe.synthetic_lm_batch(jpipe.PipelineConfig(**kw), step, host, hosts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_token_pipeline_iterates_and_restores_as_reference():
    kw = dict(vocab=256, seq_len=16, global_batch=4)
    tp, jp = (m.TokenPipeline(m.PipelineConfig(**kw)) for m in (pipe, jpipe))
    for _ in range(5):
        (s1, b1), (s2, b2) = next(tp), next(jp)
        assert s1 == s2
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert tp.state() == jp.state()
    r = pipe.TokenPipeline.restore(pipe.PipelineConfig(**kw), tp.state())
    np.testing.assert_array_equal(next(r)[1]["labels"], next(jp)[1]["labels"])


# ---------------------------------------------------------------------------
# OSSL, gating, optimizer pieces on identical inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 3])
def test_local_loss_and_block_stats_match_reference(b):
    rng = np.random.default_rng(b)
    h_in, h_out = (rng.standard_normal((b, 24, 16)).astype(np.float32)
                   for _ in range(2))
    head = {"p": rng.standard_normal((16, 16)).astype(np.float32) * 0.25}
    ema = rng.standard_normal(16).astype(np.float32)
    want = jossl.local_loss(jnp.asarray(h_out), jax.tree.map(jnp.asarray, head),
                            jossl.OSSLConfig())
    got = ossl.local_loss(_t(h_out), {"p": _t(head["p"])}, ossl.OSSLConfig())
    _close(got, want)
    for g, w in zip(ossl.block_stats(_t(h_in), _t(h_out), _t(ema)),
                    jossl.block_stats(*map(jnp.asarray, (h_in, h_out, ema)))):
        _close(g, w)


@pytest.mark.parametrize("step", [0, 1, 2, 50, 99, 150])
def test_cosine_schedule_matches_reference(step):
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    got = opt.cosine_schedule(opt.AdamWConfig(**kw), step)
    want = jopt.cosine_schedule(jopt.AdamWConfig(**kw), jnp.asarray(step))
    assert got == pytest.approx(float(want), rel=1e-6)


def _param_tree(rng):
    return {"layers": {"w": rng.standard_normal((2, 8, 4)).astype(np.float32),
                       "umask": rng.random((2, 4, 1)) < 0.5},
            "head": rng.standard_normal((4, 3)).astype(np.float32)}


@pytest.mark.parametrize("scaled,step", [(False, 0), (False, 3), (True, 3)])
def test_adamw_update_matches_reference(scaled, step):
    rng = np.random.default_rng(step)
    p = _param_tree(rng)
    g = {"layers": {"w": rng.standard_normal((2, 8, 4)).astype(np.float32)},
         "head": rng.standard_normal((4, 3)).astype(np.float32)}
    m = jax.tree.map(lambda a: np.abs(a) * 0.1 if a.dtype != bool
                     else np.zeros((), np.int8), p)
    v = jax.tree.map(lambda a: np.abs(a) * 0.01 if a.dtype != bool
                     else np.zeros((), np.int8), p)
    scale = None
    if scaled:
        scale = {"layers": {"w": np.array([1.0, 0.0], np.float32)[:, None, None],
                            "umask": np.ones((), np.float32)},
                 "head": np.full((), 0.5, np.float32)}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jg = {"layers": {"w": g["layers"]["w"],
                     "umask": np.zeros(p["layers"]["umask"].shape, jax.dtypes.float0)},
          "head": g["head"]}
    jp, jst, jm = jopt.adamw_update(
        jg, jax.tree.map(jnp.asarray, p),
        jopt.AdamWState(jnp.asarray(step, jnp.int32), jax.tree.map(jnp.asarray, m),
                        jax.tree.map(jnp.asarray, v)),
        jopt.AdamWConfig(**cfg),
        None if scale is None else jax.tree.map(jnp.asarray, scale))
    tg = {"layers": {"w": _t(g["layers"]["w"]), "umask": None}, "head": _t(g["head"])}
    tp, tst, tm = opt.adamw_update(
        tg, jax.tree.map(_t, p),
        opt.AdamWState(step, jax.tree.map(_t, m), jax.tree.map(_t, v)),
        opt.AdamWConfig(**cfg), None if scale is None else jax.tree.map(_t, scale))
    assert tst.step == int(jst.step) == step + 1
    _close(tm["grad_norm"], jm["grad_norm"])
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    for a, b in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        fa, fb = _flat(a), _jflat(b)
        assert fa.keys() == fb.keys()
        for k in fb:
            if fa[k].dtype == torch.bool:
                assert np.array_equal(fa[k].numpy(), np.asarray(fb[k]))
            else:
                _close(fa[k], fb[k])


@pytest.mark.parametrize("slab", [4, 400])
@pytest.mark.parametrize("gated", [False, True])
def test_adamw_slab_update_equals_whole_leaf_bitwise(monkeypatch, gated, slab):
    """A leaf above ``ADAMW_SLAB`` elements is updated in slabs of its
    leading axis (a single row split again: slab 4; two rows at a time:
    400): params and moments equal the whole-leaf update bit for bit, with
    a per-layer gate and an expert leaf's shared mask."""
    rng = np.random.default_rng(9)
    shapes = {"w": (3, 4, 8, 5), "b": (6, 7), "s": (5,)}
    p = {k: _t(rng.standard_normal(v).astype(np.float32)) for k, v in shapes.items()}
    g = {k: _t(rng.standard_normal(v).astype(np.float32)) for k, v in shapes.items()}
    scale = None
    if gated:
        mask = _t((rng.random((3, 1, 8, 1)) < 0.5).astype(np.float32))
        scale = {"w": mask * _t(np.array([1.0, 0.0, 1.0], np.float32)).reshape(3, 1, 1, 1),
                 "b": torch.ones(()), "s": torch.ones(())}
    out = []
    for size in (adamw_ref.ADAMW_SLAB, slab):
        monkeypatch.setattr(adamw_ref, "ADAMW_SLAB", size)
        pp = {k: v.clone() for k, v in p.items()}
        st = opt.adamw_init(pp)
        for _ in range(2):
            pp, st, _ = opt.adamw_update(g, pp, st, opt.AdamWConfig(lr=1e-2), scale)
        out.append((pp, st))
    (pa, sa), (pb, sb) = out
    for a, b in ((pa, pb), (sa.m, sb.m), (sa.v, sb.v)):
        for k in shapes:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("cfg_kw", [{}, {"enabled": False}, {"theta_ia": 0.5}])
def test_compute_gates_matches_reference(cfg_kw):
    rng = np.random.default_rng(4)
    L, D = 5, 8
    ia = rng.random(L).astype(np.float32)
    pooled = rng.standard_normal((L, D)).astype(np.float32)
    ema = pooled + 0.05 * rng.standard_normal((L, D)).astype(np.float32)
    ema[0] = 0.0
    ss_mean = np.full(L, 0.99, np.float32)
    ss_mean[1] = 0.5
    jst = jsparse.SparseTrainState(
        jgating.GatingState(jnp.asarray(ss_mean), jnp.ones(L), jnp.full(L, 2.0)),
        jnp.asarray(ema))
    jg, jnew = jsparse.compute_gates(jst, jnp.asarray(ia), jnp.asarray(pooled),
                                     jgating.GatingConfig(**cfg_kw))
    tst = sparse.SparseTrainState(
        gating.GatingState(_t(ss_mean), torch.ones(L), torch.full((L,), 2.0)),
        _t(ema))
    tg, tnew = sparse.compute_gates(tst, _t(ia), _t(pooled),
                                    gating.GatingConfig(**cfg_kw))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for a, b in zip(tnew.gate, jnew.gate):
        _close(a, b)
    _close(tnew.pooled_ema, jnew.pooled_ema)


def test_gate_update_and_merge_match_reference():
    st = np.array([0.5, 0.99, 1.0], np.float32)
    jstate = jgating.GatingState(jnp.asarray(st), jnp.zeros(3), jnp.zeros(3))
    tstate = gating.GatingState(_t(st), torch.zeros(3), torch.zeros(3))
    cfg = dict(theta_ia=0.1)
    jl = [jgating.gate_update(jstate, i, jnp.float32(0.2), jnp.float32(0.9),
                              jgating.GatingConfig(**cfg)) for i in range(3)]
    tl = [gating.gate_update(tstate, i, torch.tensor(0.2), torch.tensor(0.9),
                             gating.GatingConfig(**cfg)) for i in range(3)]
    assert [bool(o) for o, _ in tl] == [bool(o) for o, _ in jl]
    merged_t = gating.merge(tstate, [g for _, g in tl])
    merged_j = jgating.merge(jstate, [g for _, g in jl])
    for a, b in zip(merged_t, merged_j):
        _close(a, b)


def _masked_tree(rng, lead=(3,), k=32, o=6, kb=8):
    """A params-like tree with a masked N:M weight (n=2 of m=4, block 4)."""
    um = np.zeros((*lead, kb, 1), bool)
    for idx in np.ndindex(*lead):
        for grp in range(kb // 4):
            um[idx + (slice(grp * 4, grp * 4 + 4), 0)][rng.permutation(4)[:2]] = True
    w = rng.standard_normal((*lead, k, o)).astype(np.float32)
    return {"layers": {"mlp": {"w1": {"w": w, "umask": um}},
                       "norm1": np.ones((*lead, o), np.float32)},
            "final_norm": np.ones(o, np.float32)}


@pytest.mark.parametrize("gated", [False, True])
def test_gated_scale_tree_matches_reference(gated):
    rng = np.random.default_rng(5)
    p = _masked_tree(rng)
    gv = np.array([1.0, 0.0, 1.0], np.float32) if gated else None
    sp_j = JSparsityConfig(n=2, m=4, block=4, mode="masked")
    sp_t = SparsityConfig(n=2, m=4, block=4, mode="masked")
    want = jsparse.gated_scale_tree(jax.tree.map(jnp.asarray, p),
                                    None if gv is None else jnp.asarray(gv), sp_j)
    got = sparse.gated_scale_tree(jax.tree.map(_t, p),
                                  None if gv is None else _t(gv), sp_t)
    fg, fw = _flat(got), _jflat(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        np.testing.assert_array_equal(
            np.broadcast_to(fg[k].numpy(), np.shape(fw[k])), np.asarray(fw[k]))


@pytest.mark.parametrize("lead,bf16", [((3,), False), ((), False),
                                       ((3,), True)])
def test_lm_dsst_event_masks_equal_reference(lead, bf16):
    """Masks (and surviving weights) equal the reference's, planted ties
    included; in bf16 too, where the unit scores are summed and ranked in
    bf16 as the reference ranks them."""
    rng = np.random.default_rng(6)
    p = _masked_tree(rng, lead=lead)
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32)
                     if a.dtype != bool else np.zeros(a.shape, jax.dtypes.float0), p)
    # planted ties: two units with equal weight and equal grad scores
    p["layers"]["mlp"]["w1"]["w"][..., 0:4, :] = 0.5
    sp_j = JSparsityConfig(n=2, m=4, block=4, mode="masked")
    sp_t = SparsityConfig(n=2, m=4, block=4, mode="masked")
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jcast = lambda a: jnp.asarray(a) if a.dtype in (bool, jax.dtypes.float0) \
        else jnp.asarray(a, jdt)                                 # noqa: E731
    jp, jst = jsparse.lm_dsst_event(jax.tree.map(jcast, p), jax.tree.map(jcast, g), sp_j)
    tcast = lambda a: _t(a) if a.dtype == bool else _t(a).to(tdt)  # noqa: E731
    tg = jax.tree.map(lambda a: None if a.dtype == jax.dtypes.float0 else tcast(a), g)
    tp, tst = sparse.lm_dsst_event(jax.tree.map(tcast, p), tg, sp_t)
    node_t, node_j = tp["layers"]["mlp"]["w1"], jp["layers"]["mlp"]["w1"]
    np.testing.assert_array_equal(node_t["umask"].numpy(), np.asarray(node_j["umask"]))
    np.testing.assert_array_equal(node_t["w"].float().numpy(),
                                  np.asarray(node_j["w"], np.float32))
    assert not np.array_equal(np.asarray(node_j["umask"]), p["layers"]["mlp"]["w1"]["umask"])
    _close(tst["dsst_mask_change"], jst["dsst_mask_change"])


def test_lm_loss_and_chunked_match_reference():
    rng = np.random.default_rng(7)
    b, s, d, v = 2, 12, 8, 20
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    head = rng.standard_normal((d, v)).astype(np.float32)
    tgt = rng.integers(0, v, (b, s)).astype(np.int32)
    jl, jgl = jax.value_and_grad(lambda x: JT.lm_loss(x, jnp.asarray(tgt)))(
        jnp.asarray(h) @ jnp.asarray(head))
    logits = (_t(h) @ _t(head)).requires_grad_()
    tl = T.lm_loss(logits, _t(tgt).long())
    tl.backward()
    _close(tl, jl)
    _close(logits.grad, jgl)
    jc, (jgh, jghead) = jax.value_and_grad(
        lambda x, w: JT.lm_loss_chunked(x, w, jnp.asarray(tgt), 4), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th, thead = _t(h).requires_grad_(), _t(head).requires_grad_()
    tc = T.lm_loss_chunked(th, thead, _t(tgt).long(), 4)
    tc.backward()
    _close(tc, jc)
    _close(th.grad, jgh)
    _close(thead.grad, jghead)
    _close(tc, jl)                                  # chunking changes nothing


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

MASKED = dict(n=2, m=4, block=8, targets=("mlp",), mode="masked")
MASKED_EXPERTS = dict(MASKED, targets=("expert",))
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEP_CASES = {
    "backprop": ("stablelm_12b", {}, None),
    "gating": ("qwen2_vl_2b", {"gating": True}, None),
    "masked_dsst": ("stablelm_12b", {"dsst_every": 1}, MASKED),
    "local": ("qwen2_vl_2b", {"mode": "local"}, None),
    "microbatch": ("qwen2_vl_2b", {"microbatch": 2, "gating": True}, None),
    # moe: Mixtral's window of 8 inside S 16, top 2 of 4 experts
    "mixtral_backprop": ("mixtral_8x7b", {}, None),
    "moonshot_gating": ("moonshot_v1_16b_a3b", {"gating": True}, None),
    "moonshot_masked_experts_dsst": ("moonshot_v1_16b_a3b",
                                     {"dsst_every": 1, "gating": True},
                                     MASKED_EXPERTS),
    "moonshot_local": ("moonshot_v1_16b_a3b", {"mode": "local"}, None),
    # ssm and hybrid: S 16 is two SSD chunks of 8; Zamba2's 4 layers call
    # the shared block twice
    "mamba2_backprop": ("mamba2_2p7b", {}, None),
    "mamba2_masked_dsst": ("mamba2_2p7b", {"dsst_every": 1}, MASKED),
    "zamba2_gating": ("zamba2_1p2b", {"gating": True}, None),
    "zamba2_microbatch": ("zamba2_1p2b", {"microbatch": 2}, None),
}


def _cfgs(arch, sp):
    jc, tc = JC.get_reduced(arch), C.get_reduced(arch)
    if sp is not None:
        jc, tc = jc.with_sparsity(JSparsityConfig(**sp)), tc.with_sparsity(
            SparsityConfig(**sp))
    return jc, tc


def _hps(hp):
    kw = dict(hp)
    gated = kw.pop("gating", False)
    return (jtrain.TrainHParams(opt=jopt.AdamWConfig(**OPT),
                                gating=jgating.GatingConfig() if gated else None, **kw),
            train.TrainHParams(opt=opt.AdamWConfig(**OPT),
                               gating=gating.GatingConfig() if gated else None, **kw))


def _jax_loss_fn(cfg, hp):
    """The reference step's ``loss_fn``: (loss, (ce, aux))."""
    def loss_fn(p, bt):
        logits, aux = JT.forward(p, cfg, tokens=bt["tokens"],
                                 local_mode=hp.mode == "local")
        ce = JT.lm_loss(logits, bt["labels"])
        loss = ce + hp.moe_aux_weight * aux["moe_aux"]
        if hp.mode == "local":
            loss = loss + aux["local_loss"]
        return loss, (ce, aux)
    return loss_fn


def _jax_loss_and_grads(cfg, hp, params, batch):
    """The reference step's loss and gradients (``make_train_step``'s
    ``loss_fn``, with its microbatch mean)."""
    loss_fn = _jax_loss_fn(cfg, hp)
    vg = jax.value_and_grad(lambda p, bt: loss_fn(p, bt)[0], allow_int=True)
    k = hp.microbatch
    parts = [{n: x[i * x.shape[0] // k:(i + 1) * x.shape[0] // k]
              for n, x in batch.items()} for i in range(k)]
    outs = [vg(params, bt) for bt in parts]
    loss = sum(l for l, _ in outs) / k
    grads = jax.tree.map(lambda *g: sum(np.asarray(x, np.float32) for x in g) / k
                         if g[0].dtype != jax.dtypes.float0 else None,
                         *[g for _, g in outs])
    return loss, grads


def _expert_paths(tree, path=()):
    """The paths of the masked expert nodes: ``w [L, E, K, O]`` beside one
    ``umask [L, KB, 1]`` a layer for all its experts."""
    if not isinstance(tree, dict):
        return []
    if "umask" in tree and "w" in tree:
        return [path] if np.ndim(tree["w"]) == np.ndim(tree["umask"]) + 1 else []
    return [p for k, v in tree.items() for p in _expert_paths(v, path + (k,))]


def _expert_layout(tree, paths, real, to_flat):
    """``tree`` with each expert node's ``w`` laid out ``[L, K, E·O]``
    (``to_flat``), or back to the layout of the same node in ``real``."""
    def at(node, path):
        if path in paths:
            w = node["w"]
            if to_flat:
                w = jnp.swapaxes(w, 1, 2).reshape(w.shape[0], w.shape[2], -1)
            else:
                real_w = real
                for k in path:
                    real_w = real_w[k]
                _, e, k_in, o = real_w["w"].shape
                w = jnp.swapaxes(w.reshape(w.shape[0], k_in, e, o), 1, 2)
            return {**node, "w": w}
        if not isinstance(node, dict):
            return node
        return {k: at(v, path + (k,)) for k, v in node.items()}
    return at(tree, ())


def _jax_step_flat_experts(cfg, hp, params, opt_state, sparse_state, batch):
    """The reference's train step (``dsst_every=1``) for masked experts,
    which ``make_train_step`` cannot take: its ``gated_scale_tree`` and
    ``lm_dsst_event`` broadcast a layer's ``[L, K, 1]`` mask against ``w
    [L, E, K, O]`` and fail. One pattern for all experts of a layer is the
    pattern of the leaf laid out ``[L, K, E·O]``, so the update and the
    event run through the reference's own functions on that layout, and
    the leaves go back after. Loss and gradients: the reference's, on the
    real tree."""
    assert hp.dsst_every == 1 and hp.microbatch == 1
    paths = set(_expert_paths(params))
    (loss, (ce, aux)), grads = jax.value_and_grad(
        _jax_loss_fn(cfg, hp), has_aux=True, allow_int=True)(params, batch)

    def fl(t):
        return _expert_layout(t, paths, params, True)

    def back(t):
        return _expert_layout(t, paths, params, False)
    fp, fg = fl(params), fl(grads)
    fo = jopt.AdamWState(opt_state.step, fl(opt_state.m), fl(opt_state.v))
    gates = None
    if hp.gating is not None:
        gates, sparse_state = jsparse.compute_gates(
            sparse_state, aux["ia"], aux["pooled"], hp.gating)
    scale = jsparse.gated_scale_tree(fp, gates, cfg.sparsity)
    fp, fo, om = jopt.adamw_update(fg, fp, fo, hp.opt, scale)
    fp, stats = jsparse.lm_dsst_event(fp, fg, cfg.sparsity)
    metrics = {"loss": loss, "ce": ce,
               "gate_frac": jnp.ones(()) if gates is None else gates.mean(),
               "moe_dropped": aux["moe_dropped"], **om,
               "dsst_mask_change": stats["dsst_mask_change"]}
    return (back(fp), jopt.AdamWState(fo.step, back(fo.m), back(fo.v)),
            sparse_state, metrics)


@functools.lru_cache(maxsize=None)
def _step_case(name):
    """Both packages' loss, gradients and one train step from the same
    params and batch."""
    arch, hp, sp = STEP_CASES[name]
    jc, tc = _cfgs(arch, sp)
    jhp, thp = _hps(hp)
    jp, jo, js = jtrain.init_train_state(jax.random.PRNGKey(0), jc, jhp)
    rng = np.random.default_rng(1)
    bt = {"tokens": rng.integers(0, jc.vocab, (4, 16)).astype(np.int32),
          "labels": rng.integers(0, jc.vocab, (4, 16)).astype(np.int32)}
    jb = jax.tree.map(jnp.asarray, bt)
    jloss, jgrads = _jax_loss_and_grads(jc, jhp, jp, jb)
    jstep = jtrain.make_train_step(jc, jhp) if not _expert_paths(jp) \
        else functools.partial(_jax_step_flat_experts, jc, jhp)
    jout = jax.jit(jstep)(jp, jo, js, jb)
    tp = convert.lm_params_from_numpy(_np(jp), tc, "cpu")
    to, ts = convert.train_state_from_numpy(_np(jo), _np(js), "cpu")
    tb = {k: _t(v).long() for k, v in bt.items()}
    step = train.make_train_step(tc, thp, attn="flash")
    tloss, _, tgrads = step.loss_and_grads(tp, tb)
    tout = step(tp, to, ts, tb)
    return dict(jp=_np(jp), jloss=jloss, jgrads=jgrads, jout=_np(jout),
                tloss=tloss, tgrads=tgrads, tout=tout)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_loss_and_grads_match_reference(name):
    r = _step_case(name)
    _close(r["tloss"], r["jloss"], rtol=1e-5)
    ft, fj = _flat(r["tgrads"]), _jflat(r["jgrads"])
    assert {k for k, v in ft.items() if v is not None} == \
        {k for k, v in fj.items() if v is not None}
    for k, g in fj.items():
        if g is not None:
            _close(ft[k], g, rtol=1e-4)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_metrics_and_state_match_reference(name):
    r = _step_case(name)
    jp2, jo2, js2, jm = r["jout"]
    tp2, to2, ts2, tm = r["tout"]
    assert tm.keys() == jm.keys()
    _close(tm["loss"], jm["loss"], rtol=1e-5)
    _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    assert float(tm["gate_frac"]) == float(jm["gate_frac"])
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert to2.step == int(jo2.step) == 1
    for a, b in zip(ts2.gate, js2.gate):
        _close(a, b, rtol=1e-4)
    ft, fj = _flat(tp2), _jflat(jp2)
    assert ft.keys() == fj.keys()
    for k, w in fj.items():
        if w.dtype == bool:               # DSST masks: exactly the reference's
            np.testing.assert_array_equal(ft[k].numpy(), w)
        else:
            assert bool(torch.isfinite(ft[k]).all())
    if "dsst_mask_change" in jm:
        _close(tm["dsst_mask_change"], jm["dsst_mask_change"])
        masks = {k: v for k, v in ft.items() if k[-1] == "umask"}
        assert masks
        moved = 0
        for k, um in masks.items():
            moved += not np.array_equal(um.numpy(), _jflat(r["jp"])[k])
            g = um.reshape(*um.shape[:-2], -1, 4)      # m = 4 units a group
            assert bool((g.sum(-1) == 2).all())        # n = 2 kept of each
            w = ft[k[:-1] + ("w",)]
            block = w.shape[-2] // um.shape[-2]
            off = ~um.repeat_interleave(block, dim=-2)
            if w.dim() > um.dim():                     # experts share it
                off = off.unsqueeze(-3)
            assert float(torch.where(off, w, 0).abs().max()) == 0.0
        assert moved


@pytest.mark.parametrize("arch,mode", [("qwen2_vl_2b", "local"),
                                       ("moonshot_v1_16b_a3b", "backprop"),
                                       ("zamba2_1p2b", "backprop")])
def test_remat_gives_the_same_loss_and_grads(arch, mode):
    """Remat recomputes each block in the backward (the MoE's routing, the
    hybrid's shared block inside each checkpointed block that calls it):
    loss and gradients equal bit for bit without it."""
    cfg = C.get_reduced(arch)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                           local_heads=mode == "local")
    rng = np.random.default_rng(2)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab, (2, 16))) for k in
             ("tokens", "labels")}
    out = {}
    for remat in (False, True):
        step = train.make_train_step(dataclasses.replace(cfg, remat=remat),
                                     train.TrainHParams(mode=mode))
        out[remat] = step.loss_and_grads(params, batch)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(opt.tree_leaves(out[True][2]), opt.tree_leaves(out[False][2])):
        assert torch.equal(a, b)


def test_backprop_loss_decreases():
    cfg = C.get_reduced("stablelm_12b")
    hp = train.TrainHParams(opt=opt.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                total_steps=200))
    p = pipe.TokenPipeline(pipe.PipelineConfig(vocab=cfg.vocab, seq_len=32,
                                               global_batch=8))
    _, hist = train.run_training(cfg, hp, p, 40, log_every=5, device="cpu")
    assert hist["loss"][-1] < hist["loss"][0] - 0.5


def test_local_mode_no_cross_block_grads():
    """OSSL local mode: block-0 params get no gradient from the final CE
    (only from their own local loss)."""
    cfg = C.get_reduced("stablelm_12b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                           local_heads=True)
    rng = np.random.default_rng(3)
    tok, lab = (torch.tensor(rng.integers(0, cfg.vocab, (2, 16))) for _ in range(2))
    leaves = {"wq": params["layers"]["attn"]["wq"]["w"], "head": params["lm_head"]}
    for x in leaves.values():
        x.requires_grad_()
    logits, _ = T.forward(params, cfg, tokens=tok, local_mode=True)
    g = torch.autograd.grad(T.lm_loss(logits, lab), list(leaves.values()),
                            allow_unused=True, materialize_grads=True)
    assert float(g[0].abs().max()) == 0.0          # CE never reaches blocks
    assert float(g[1].abs().max()) > 0             # readout does learn


def test_resume_from_checkpoint_identical(tmp_path):
    """An interrupted run (checkpoint after step 3, stopped after step 4)
    resumed to step 6 from a replayed pipeline equals the uninterrupted
    run bit for bit: the last loss and every param and AdamW leaf."""
    cfg = C.get_reduced("stablelm_12b")
    hp = train.TrainHParams(opt=opt.AdamWConfig(**OPT),
                            gating=gating.GatingConfig())

    def mk():
        return pipe.TokenPipeline(pipe.PipelineConfig(vocab=cfg.vocab,
                                                      seq_len=16,
                                                      global_batch=4))
    ref, h_ref = train.run_training(cfg, hp, mk(), 6, log_every=1,
                                    device="cpu")
    d = str(tmp_path / "ck")
    train.run_training(cfg, hp, mk(), 5, ckpt_dir=d, ckpt_every=4,
                       log_every=1, device="cpu")
    p2 = mk()
    for _ in range(4):            # a restart replays the pipeline position
        next(p2)
    got, h_res = train.run_training(cfg, hp, p2, 6, ckpt_dir=d, ckpt_every=4,
                                    log_every=1, device="cpu")
    assert h_res["step"] == [4, 5]
    assert h_res["loss"][-1] == h_ref["loss"][-1]
    assert got[1].step == ref[1].step == 6
    for tree_got, tree_ref in ((got[0], ref[0]), (got[1].m, ref[1].m),
                               (got[1].v, ref[1].v)):
        fg, fr = _flat(tree_got), _flat(tree_ref)
        assert fg.keys() == fr.keys()
        for k in fr:
            assert torch.equal(fg[k], fr[k]), k


@pytest.mark.parametrize("arch,sp", [("stablelm_12b", MASKED),
                                     ("moonshot_v1_16b_a3b", MASKED_EXPERTS),
                                     ("mamba2_2p7b", MASKED),
                                     ("zamba2_1p2b", None)])
def test_train_state_from_numpy_matches_reference_init(arch, sp):
    """The reference's state carried across has the port's own init's trees,
    shapes and dtypes: params and AdamW moments of the expert, mixer and
    shared leaves included."""
    jc, tc = _cfgs(arch, sp)
    jhp, thp = _hps({"mode": "local"})
    jp, jo, js = jtrain.init_train_state(jax.random.PRNGKey(0), jc, jhp)
    tp = convert.lm_params_from_numpy(_np(jp), tc, "cpu")
    to, ts = convert.train_state_from_numpy(_np(jo), _np(js), "cpu")
    # the port's own init has the same trees, shapes and dtypes
    p2, o2, s2 = train.init_train_state(torch.Generator().manual_seed(0), tc,
                                        thp, "cpu")
    for a, b in ((tp, p2), (to.m, o2.m), (to.v, o2.v)):
        fa, fb = _flat(a), _flat(b)
        assert {k: (tuple(v.shape), v.dtype) for k, v in fa.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in fb.items()}
    assert ("local_heads", "p") in _flat(tp)
    masks = [v for k, v in _flat(tp).items() if k[-1] == "umask"]
    assert all(m.dtype == torch.bool for m in masks) and len(masks) == (
        0 if sp is None else 2 if arch == "mamba2_2p7b" else 3)
    if arch == "zamba2_1p2b":
        assert _flat(to.m)[("shared", "attn", "wq", "w")].shape == \
            tuple(np.shape(jo.m["shared"]["attn"]["wq"]["w"]))
    assert to.step == o2.step == 0
    assert ts.pooled_ema.shape == s2.pooled_ema.shape == (tc.n_layers, tc.d_model)
    for a, b in zip(ts.gate, s2.gate):
        assert torch.equal(a, b)
