"""The port's MoE layer (``models/moe.py``) and the moe family on the LM
serving path against the JAX reference, on the reference's weights carried
across as numpy.

Exact: ``capacity``, the dispatch's slots, expert ids and ranks (ties
included: equal router columns, on inputs whose logits are exact in f32,
so both sides see equal probabilities) and ``moe_dropped``; greedy tokens.
``moe_aux`` and ``moe_load`` within ``1e-6`` (f32 means over other
orders). ``moe_apply`` within ``2e-5`` (one layer deep, as the port's
single-layer tests); forward, prefill and decode within ``1e-4`` (f32
reduced configs, the bound of tests/test_torch_lm.py). ``moe_apply``'s
gradients within ``2e-5`` of each tensor's largest element (one layer,
forward and backward); inside the port, the slot gathers' backward equals
plain indexing's and repeats bit for bit.
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
from repro.launch import serve as jserve
from repro.models import moe as JMOE, transformer as JT
import repro_torch.configs as C
from repro_torch import convert
from repro_torch.configs.base import SparsityConfig
from repro_torch.launch import serve
from repro_torch.models import moe as MOE, transformer as T

torch.set_num_threads(1)

MOE_ARCHS = ["mixtral_8x7b", "moonshot_v1_16b_a3b"]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = JC.get_reduced(arch)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, convert.lm_params_from_numpy(_np_tree(jp), cfg, "cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _sp_pair(form):
    """(reference, port) SparsityConfig for an expert form."""
    if form == "dense":
        return None, None
    kw = dict(n=1, m=2, block=8, targets=("expert",), mode=form)
    return JSparsityConfig(**kw), SparsityConfig(**kw)


# ---------------------------------------------------------------------------
# capacity and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_equals_reference(arch):
    for cfg in (JC.get_config(arch), JC.get_reduced(arch)):
        for factor in (0.25, 1.25, 8.0):
            c = dataclasses.replace(cfg, moe_capacity_factor=factor)
            for n in (1, 2, 4, 7, 8, 24, 33, 512, 1000, 8192):
                assert MOE.capacity(n, c) == JMOE.capacity(n, c), (factor, n)
    full = C.get_config("moonshot_v1_16b_a3b")
    assert (MOE.capacity(4 * 2048, full), MOE.capacity(4, full)) == (960, 8)


def _dispatch_case(case):
    """(cfg, flat [N, D], router [D, E]) as numpy for one dispatch case."""
    rng = np.random.default_rng({"no_drop": 3, "overflow": 4, "ties": 5}[case])
    cfg = JC.get_reduced("moonshot_v1_16b_a3b")
    if case == "ties":
        # 8 experts, top 3; columns 1 = 5 and 2 = 3 = 6. Small integers
        # times powers of two keep every logit exact in f32, so the tied
        # experts get equal probabilities on both sides.
        cfg = dataclasses.replace(cfg, moe_experts=8, moe_top_k=3)
        flat = rng.integers(-3, 4, (40, cfg.d_model)).astype(np.float32) / 4
        router = rng.integers(-3, 4, (cfg.d_model, 8)).astype(np.float32) / 16
        router[:, 5] = router[:, 1]
        router[:, 3] = router[:, 6] = router[:, 2]
        return cfg, flat, router
    factor = {"no_drop": 8.0, "overflow": 0.25}[case]
    cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
    flat = rng.standard_normal((48, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.moe_experts))
              * cfg.d_model ** -0.5).astype(np.float32)
    return cfg, flat, router


@pytest.mark.parametrize("case", ["no_drop", "overflow", "ties"])
def test_dispatch_slots_ids_ranks_and_drops_equal_reference(case):
    cfg, flat, router = _dispatch_case(case)
    n, e, k = flat.shape[0], cfg.moe_experts, cfg.moe_top_k
    c = MOE.capacity(n, cfg)
    if case == "ties":
        logits = np.asarray(jnp.asarray(flat) @ jnp.asarray(router))
        assert np.array_equal(logits[:, 1], logits[:, 5])
        assert np.array_equal(logits[:, 2], logits[:, 6])
        got = (_t(flat) @ _t(router)).numpy()
        assert np.array_equal(got, logits)
    # at the call's capacity, and at one that keeps every choice, where the
    # slot is expert·C + rank for every (token, choice)
    slots, drops = {}, {}
    for cap in (c, n * k):
        slot, gate, aux = MOE._dispatch(_t(flat), _t(router), cfg, cap)
        jslot, jgate, jaux = JMOE._dispatch(jnp.asarray(flat),
                                            jnp.asarray(router), cfg, cap)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        _close(gate, jgate, 1e-6)
        assert float(aux["moe_dropped"]) == float(jaux["moe_dropped"])
        _close(aux["moe_aux"], jaux["moe_aux"], 1e-6)
        _close(aux["moe_load"], jaux["moe_load"], 1e-6)
        assert aux["moe_dropped"].dtype == aux["moe_aux"].dtype == torch.float32
        slots[cap], drops[cap] = slot.numpy(), float(aux["moe_dropped"])
    eids, ranks = slots[n * k] // (n * k), slots[n * k] % (n * k)
    jids = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(flat) @ jnp.asarray(router), -1), k)[1]).reshape(-1)
    np.testing.assert_array_equal(eids, jids)
    for ex in range(e):                 # ranks count up in token order
        np.testing.assert_array_equal(ranks[eids == ex],
                                      np.arange((eids == ex).sum()))
    assert drops[n * k] == 0.0
    # moe_dropped is the host's count of trash slots over N·K
    slot_c = slots[c]
    assert drops[c] == float(np.float32((slot_c == e * c).sum())
                             / np.float32(n * k))
    if case == "overflow":
        assert (slot_c == e * c).any()
    if case == "ties":                  # lower expert first on a tie
        probs = torch.softmax(_t(flat) @ _t(router), -1)
        ids = eids.reshape(n, k)
        tie = (probs[:, 1] == probs[:, 5]).numpy() & np.isin(ids, 5).any(1)
        assert tie.any()
        for row in ids[tie]:
            assert 1 in row and list(row).index(1) < list(row).index(5)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["dense", "masked", "compact"])
@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_moe_apply_matches_reference(form, act):
    jsp_, sp = _sp_pair(form)
    # capacity factor 0.5: some choices are dropped
    kw = dict(act=act, moe_capacity_factor=0.5)
    jcfg = dataclasses.replace(JC.get_reduced("mixtral_8x7b"), sparsity=jsp_, **kw)
    cfg = dataclasses.replace(C.get_reduced("mixtral_8x7b"), sparsity=sp, **kw)
    jp = JMOE.moe_init(jax.random.PRNGKey(2), jcfg, jnp.float32, jsp_)
    tp = convert.lm_params_from_numpy(_np_tree(jp), cfg, "cpu")
    if form == "compact":
        assert tp["w1"]["rows"].dtype == torch.int64
    x = np.random.default_rng(7).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    out, aux = MOE.moe_apply(tp, _t(x), cfg)
    want, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg, jsp_)
    _close(out, want, 2e-5)
    assert float(aux["moe_dropped"]) == float(jaux["moe_dropped"]) > 0.0
    _close(aux["moe_aux"], jaux["moe_aux"], 1e-6)
    _close(aux["moe_load"], jaux["moe_load"], 1e-6)


def test_moe_matches_dense_gather_loop():
    """Scatter dispatch equals a per-token loop through each token's top-k
    experts with renormalised gates; a dropped choice adds 0."""
    cfg = dataclasses.replace(C.get_reduced("mixtral_8x7b"),
                              moe_capacity_factor=0.5)
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, aux = MOE.moe_apply(p, x, cfg)
    assert float(aux["moe_dropped"]) > 0.0
    flat = x.reshape(-1, cfg.d_model)
    c = MOE.capacity(flat.shape[0], cfg)
    slot, _, _ = MOE._dispatch(flat, p["router"], cfg, c)
    slot = slot.reshape(-1, cfg.moe_top_k)
    probs = torch.softmax(flat @ p["router"], -1)
    gate, eids = probs.topk(cfg.moe_top_k, -1)
    gate = gate / gate.sum(-1, keepdim=True)
    ref = torch.zeros_like(flat)
    for t in range(flat.shape[0]):
        for j in range(cfg.moe_top_k):
            if int(slot[t, j]) == cfg.moe_experts * c:
                continue                                   # dropped
            e = int(eids[t, j])
            h = torch.nn.functional.silu(flat[t] @ p["w1"]["w"][e]) \
                * (flat[t] @ p["w3"]["w"][e])
            ref[t] += gate[t, j] * (h @ p["w2"]["w"][e])
    torch.testing.assert_close(out.reshape(-1, cfg.d_model), ref,
                               atol=2e-5, rtol=2e-5)


def test_load_balance_loss_range_and_load_sums_to_one():
    cfg = C.get_reduced("mixtral_8x7b")
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, aux = MOE.moe_apply(p, x, cfg)
    assert 0.9 < float(aux["moe_aux"]) < cfg.moe_experts
    assert abs(float(aux["moe_load"].sum()) - 1.0) < 1e-5
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("form", ["dense", "masked", "compact"])
def test_init_params_tree_matches_reference(form):
    """The port's own draw has the reference's paths, shapes and dtypes
    (compact ``rows`` int64 where the reference's are int32); compact rows
    are sorted and keep n blocks of every m; masked umasks keep n of m."""
    jsp_, sp = _sp_pair(form)
    jcfg = dataclasses.replace(JC.get_reduced("moonshot_v1_16b_a3b"), sparsity=jsp_)
    cfg = dataclasses.replace(C.get_reduced("moonshot_v1_16b_a3b"), sparsity=sp)
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jax.eval_shape(lambda r: JT.init_params(r, jcfg), jax.random.PRNGKey(0))
    dt = {"float32": torch.float32, "bool": torch.bool, "int32": torch.int64}
    flat_t = {k: (tuple(v.shape), v.dtype) for k, v in _flatten(tp).items()}
    flat_j = {"/".join(str(getattr(p, "key", p)) for p in k):
              (tuple(v.shape), dt[str(v.dtype)])
              for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat_t == flat_j
    moe = tp["layers"]["moe"]
    for w in ("w1", "w2", "w3"):
        if form == "compact":
            rows = moe[w]["rows"]
            assert bool((rows[:, 1:] > rows[:, :-1]).all())
            n_groups = rows.shape[-1] // (sp.n * sp.block)
            blocks = rows[:, ::sp.block] // sp.block      # kept block ids
            assert bool((rows.reshape(*blocks.shape, sp.block) // sp.block
                         == blocks[..., None]).all())
            for b in blocks:
                assert bool((torch.bincount(b // sp.m, minlength=n_groups)
                             == sp.n).all())
        elif form == "masked":
            um = moe[w]["umask"]
            assert um.shape[-1] == 1
            assert bool((um.reshape(cfg.n_layers, -1, sp.m).sum(-1) == sp.n).all())


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


# ---------------------------------------------------------------------------
# the family on the LM serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(arch):
    cfg, jp, tp = _model(arch)
    tok = _tokens(cfg, 2, 12)
    want, jaux = JT.forward(jp, cfg, tokens=jnp.asarray(tok))
    for attn in ("flash", "plain"):
        got, aux = T.forward(tp, cfg, tokens=_t(tok).long(), attn=attn)
        _close(got, want, 1e-4)
        for key in ("moe_aux", "moe_dropped", "ia", "pooled"):
            _close(aux[key], jaux[key], 1e-4)
    assert float(aux["moe_dropped"]) == float(jaux["moe_dropped"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_cache_and_decode_match_reference(arch):
    """Mixtral's reduced window is 8: the prefill fills the ring and the
    decode steps run past it."""
    cfg, jp, tp = _model(arch)
    tok = _tokens(cfg, 2, 12)
    max_seq = 16
    jl, jc = JT.prefill(jp, cfg, jnp.asarray(tok), max_seq)
    tl, tc = T.prefill(tp, cfg, _t(tok).long(), max_seq)
    _close(tl, jl, 1e-4)
    assert tc["pos"] == int(jc["pos"]) == 12
    _close(tc["k"], jc["k"], 1e-4)
    _close(tc["v"], jc["v"], 1e-4)
    nxt = _tokens(cfg, 4, 2, seed=2)
    for t in range(4):
        jl, jc = JT.decode_step(jp, jc, jnp.asarray(nxt[t]), cfg)
        tl, tc = T.decode_step(tp, tc, _t(nxt[t]).long(), cfg)
        _close(tl, jl, 1e-4)
        _close(tc["k"], jc["k"], 1e-4)
        _close(tc["v"], jc["v"], 1e-4)
    assert tc["pos"] == 16


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_generate_tokens_equal_reference(arch):
    cfg, jp, tp = _model(arch)
    tok = _tokens(cfg, 2, 10, seed=3)
    want = jserve.generate(jp, cfg, jnp.asarray(tok), 6)
    got = serve.generate(tp, cfg, _t(tok).long(), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# gradients through the dispatch
# ---------------------------------------------------------------------------

def _close_rel(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=rtol * max(1e-30, float(np.abs(want).max())))


def _grad_case(form, case):
    """(reference cfg, port cfg, reference params, x [2, 20, D]) for a
    gradient case: ``drops`` at capacity factor 0.5; ``ties`` with
    ``_dispatch_case``'s tied router columns (8 experts, top 3) on inputs
    whose logits are exact in f32."""
    jsp_, sp = _sp_pair(form)
    if case == "ties":
        base, flat, router = _dispatch_case("ties")
        x = flat.reshape(2, 20, -1)
    else:
        base = dataclasses.replace(JC.get_reduced("moonshot_v1_16b_a3b"),
                                   moe_capacity_factor=0.5)
        x = np.random.default_rng(8).standard_normal(
            (2, 20, base.d_model)).astype(np.float32)
        router = None
    jcfg = dataclasses.replace(base, sparsity=jsp_)
    cfg = dataclasses.replace(C.get_reduced("moonshot_v1_16b_a3b"), sparsity=sp,
                              moe_experts=jcfg.moe_experts,
                              moe_top_k=jcfg.moe_top_k,
                              moe_capacity_factor=jcfg.moe_capacity_factor)
    jp = JMOE.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32, jsp_)
    if router is not None:
        jp["router"] = jnp.asarray(router)
    return jcfg, cfg, jp, x


def _moe_loss_weights(x):
    return np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)


def _port_grads(cfg, jp, x, r):
    """The port's gradients of ``sum(out · r) + 0.01 · moe_aux`` with
    respect to x, the router and each expert ``w``."""
    tp = convert.lm_params_from_numpy(_np_tree(jp), cfg, "cpu")
    leaves = {"x": _t(x), "router": tp["router"],
              **{w: tp[w]["w"] for w in ("w1", "w2", "w3")}}
    for v in leaves.values():
        v.requires_grad_()
    out, aux = MOE.moe_apply(tp, leaves["x"], cfg)
    loss = (out * _t(r)).sum() + 0.01 * aux["moe_aux"]
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())))), aux


@pytest.mark.parametrize("case", ["drops", "ties"])
@pytest.mark.parametrize("form", ["dense", "masked", "compact"])
def test_moe_apply_grads_match_reference(form, case):
    """Gradients of ``sum(out · r) + 0.01 · moe_aux`` with respect to the
    input, the router and every expert matrix (each storage form; masked is
    straight-through) equal ``jax.grad`` of the reference's ``moe_apply``,
    with choices dropped at capacity and with tied router columns."""
    jcfg, cfg, jp, x = _grad_case(form, case)
    r = _moe_loss_weights(x)

    def jloss(xx, router, w1, w2, w3):
        p = dict(jp, router=router, w1=dict(jp["w1"], w=w1),
                 w2=dict(jp["w2"], w=w2), w3=dict(jp["w3"], w=w3))
        out, aux = JMOE.moe_apply(p, xx, jcfg, jcfg.sparsity)
        return (out * r).sum() + 0.01 * aux["moe_aux"]
    want = jax.grad(jloss, argnums=tuple(range(5)))(
        jnp.asarray(x), jp["router"], jp["w1"]["w"], jp["w2"]["w"], jp["w3"]["w"])
    got, aux = _port_grads(cfg, jp, x, r)
    if case == "drops":
        assert float(aux["moe_dropped"]) > 0.0
    for name, w in zip(("x", "router", "w1", "w2", "w3"), want):
        assert float(np.abs(np.asarray(w)).max()) > 0.0, name
        _close_rel(got[name], w, 2e-5)


def _plain_moe_apply(p, x, cfg):
    """``moe_apply`` with the buffer written by index and read back by
    index (autograd's own scatter and gather backward)."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.moe_experts, cfg.moe_top_k
    c = MOE.capacity(n, cfg)
    flat = x.reshape(n, d)
    slot, gate, aux = MOE._dispatch(flat, p["router"], cfg, c)
    buf = flat.new_zeros((e * c + 1, d))
    buf[slot] = flat.repeat_interleave(k, dim=0)
    eout = MOE._expert_ffn(p, buf[:e * c].view(e, c, d), cfg)
    flat_out = torch.cat([eout.reshape(e * c, d), flat.new_zeros((1, d))])
    routed = flat_out[slot].reshape(n, k, d)
    return (routed * gate[..., None]).sum(1).reshape(b, s, d), aux


def test_slot_gathers_backward_equals_plain_indexing_and_repeats():
    """The slot gathers compute plain indexing's function and gradient: the
    output and the experts' gradients bit for bit (each buffer row is read
    by one choice or none), the input's within 1e-6 (its k choices summed
    in another order); two backward calls equal bit for bit."""
    _, cfg, jp, x = _grad_case("dense", "drops")
    r = _moe_loss_weights(x)
    tp = convert.lm_params_from_numpy(_np_tree(jp), cfg, "cpu")
    runs = []
    for fn in (MOE.moe_apply, _plain_moe_apply, MOE.moe_apply):
        xx = _t(x).requires_grad_()
        ws = [tp[w]["w"].detach().requires_grad_() for w in ("w1", "w2", "w3")]
        p = dict(tp, **{w: {"w": v} for w, v in zip(("w1", "w2", "w3"), ws)})
        out, _ = fn(p, xx, cfg)
        runs.append((out, torch.autograd.grad((out * _t(r)).sum(), [xx] + ws)))
    (o1, g1), (o2, g2), (o3, g3) = runs
    assert torch.equal(o1, o2) and torch.equal(o1, o3)
    for a, b in zip(g1[1:], g2[1:]):
        assert torch.equal(a, b)
    _close_rel(g1[0], g2[0].numpy(), 1e-6)
    for a, b in zip(g1, g3):
        assert torch.equal(a, b)


def test_slot_maps_invert_the_slots():
    """Each kept slot's row reads back its (token, choice); empty slots read
    the zero rows; every (token, choice) maps to one slot or the trash."""
    cfg, flat, router = _dispatch_case("overflow")
    n, e, k = flat.shape[0], cfg.moe_experts, cfg.moe_top_k
    c = MOE.capacity(n, cfg)
    slot, _, _ = MOE._dispatch(_t(flat), _t(router), cfg, c)
    token, row = MOE._slot_maps(slot, e * c, k)
    kept = slot < e * c
    assert 0 < int(kept.sum()) < n * k
    assert torch.equal(row[slot[kept]], torch.arange(n * k)[kept])
    assert torch.equal(token[slot[kept]], torch.arange(n * k)[kept] // k)
    empty = torch.ones(e * c, dtype=torch.bool)
    empty[slot[kept]] = False
    assert bool((row[empty] == n * k).all()) and bool((token[empty] == n).all())
