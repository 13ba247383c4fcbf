"""The port's Mamba2 mixer (``models/mamba2.py``) and the ssm and hybrid
families (Mamba2, Zamba2) on the LM serving path against the JAX
reference, on the reference's weights carried across as numpy.

Tolerances (f32 reduced configs): ``1e-5`` for the mixer, ``forward`` and
its aux, the two sides summing the same f32 products in other orders;
``1e-4`` for chunked ≡ recurrent inside the port (the reference's own
bound, tests/test_models_smoke.py::test_mamba2_ssd_duality_long) and for
the chunked prefill's state and conv window against a replay; ``2e-4``
for prefill and decode against the reference (its own prefill
tolerance). Greedy tokens must be equal; tree paths and shapes exact.
Gradients (the mixer's, the shared block's) within ``1e-4`` of each
tensor's largest element, the train step's bound
(tests/test_torch_train.py); the in-place SSD (no autograd) and the
out-of-place one equal bit for bit.

The reference's ``prefill`` runs ``forward`` first, which asserts
``S % ssm_chunk == 0``, and then replays the prompt through
``decode_step``; for a ragged prompt the tests run that replay
(``_ref_replay``) as the reference's algorithm.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.launch import serve as jserve
from repro.models import mamba2 as JM, transformer as JT
import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import mamba2 as M, transformer as T

torch.set_num_threads(1)

ARCHS = ["mamba2_2p7b", "zamba2_1p2b"]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _model(arch, local_heads=False):
    cfg = JC.get_reduced(arch)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg, local_heads=local_heads)
    return cfg, jp, convert.lm_params_from_numpy(_np_tree(jp), cfg, "cpu")


@functools.lru_cache(maxsize=None)
def _ref_step(cfg):
    return jax.jit(lambda p, c, t: JT.decode_step(p, c, t, cfg))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _mixer(arch):
    cfg, jp, tp = _model(arch)
    return (cfg, jax.tree.map(lambda a: a[0], jp["layers"]["mixer"]),
            T.layer_view(tp["layers"], 0)["mixer"])


def _ref_replay(jp, cfg, tok, max_seq):
    """The reference's prefill algorithm for ssm and hybrid: the prompt
    replayed through its ``decode_step`` (its ``prefill`` does this after a
    ``forward`` that takes only whole chunks)."""
    cache = JT.init_cache(cfg, tok.shape[0], max_seq)
    step = _ref_step(cfg)
    for t in range(tok.shape[1]):
        logits, cache = step(jp, cache, jnp.asarray(tok[:, t]))
    return logits, cache


def _check_cache(tc, jc, cfg, tol):
    conv = convert.lm_cache_from_numpy(_np_tree(jc), cfg, "cpu")
    assert set(tc) == set(conv) and tc["pos"] == conv["pos"]
    for k in tc:
        if k != "pos":
            assert tc[k].dtype == conv[k].dtype and tc[k].shape == conv[k].shape, k
            _close(tc[k], conv[k], tol)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_forward_matches_reference(arch):
    cfg, jlp, lp = _mixer(arch)
    x = np.random.default_rng(2).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    _close(M.mamba2_forward(lp, _t(x), cfg), JM.mamba2_forward(jlp, x, cfg), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba2_decode_matches_reference(arch):
    """Six steps from an empty cache (the conv window fills after three):
    outputs, conv window and SSM state."""
    cfg, jlp, lp = _mixer(arch)
    rng = np.random.default_rng(3)
    jc = JM.mamba2_init_cache(cfg, 2, jnp.float32)
    tc = M.mamba2_init_cache(cfg, 2, torch.float32, "cpu")
    for _ in range(6):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, jc = JM.mamba2_decode(jlp, x, jc, cfg)
        to, tc = M.mamba2_decode(lp, _t(x), tc, cfg)
        _close(to, jo, 1e-5)
        _close(tc["conv"], jc["conv"], 1e-5)
        _close(tc["ssm"], jc["ssm"], 1e-5)
    assert tc["ssm"].dtype == torch.float32


@pytest.mark.parametrize("s", [2, 8, 13, 32])
def test_prefill_state_and_conv_window_equal_replay(s):
    """``mamba2_prefill`` (padded to whole chunks where S is ragged; S = 2
    leaves a conv window left-padded with zeros) against the same sequence
    replayed through ``mamba2_decode``."""
    cfg, _, lp = _mixer("mamba2_2p7b")
    x = _t(np.random.default_rng(4).standard_normal((2, s, cfg.d_model)).astype(np.float32))
    out, state, window = M.mamba2_prefill(lp, x, cfg)
    cache = M.mamba2_init_cache(cfg, 2, torch.float32, "cpu")
    outs = [M.mamba2_decode(lp, x[:, t:t + 1], cache, cfg)[0] for t in range(s)]
    _close(out, torch.cat(outs, 1), 1e-4)
    _close(state, cache["ssm"], 1e-4)
    _close(window, cache["conv"], 1e-4)
    assert window.shape == cache["conv"].shape and state.dtype == torch.float32
    if s < cfg.ssm_conv - 1:
        assert not bool(window[:, : cfg.ssm_conv - 1 - s].any())


def test_forward_takes_only_whole_chunks():
    cfg, _, tp = _model("mamba2_2p7b")
    with pytest.raises(ValueError, match="chunk"):
        T.forward(tp, cfg, tokens=torch.zeros((1, 12), dtype=torch.long))


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn", ["flash", "plain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, attn):
    """Logits, ``ia`` and ``pooled`` (taken after the shared block, as the
    reference takes them), and ``local_mode``'s ``local_loss``."""
    cfg, jp, tp = _model(arch, local_heads=True)
    tok = _tokens(cfg, 2, 16)
    for local in (False, True):
        want, jaux = JT.forward(jp, cfg, tokens=jnp.asarray(tok), local_mode=local)
        got, aux = T.forward(tp, cfg, tokens=_t(tok).long(), attn=attn,
                             local_mode=local)
        _close(got, want, 1e-5)
        for k in ("ia", "pooled", "local_loss"):
            _close(aux[k], jaux[k], 1e-5)
    assert float(aux["local_loss"]) != 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_equals_recurrent_within_port(arch):
    """``forward`` over 4 chunks against ``decode_step`` token by token, at
    every position (Zamba2's shared-block ring of 8 wraps three times)."""
    cfg, _, tp = _model(arch)
    b, s = 2, 32
    tok = _t(_tokens(cfg, b, s, seed=5)).long()
    logits, _ = T.forward(tp, cfg, tokens=tok)
    cache = T.init_cache(cfg, b, s, device="cpu")
    for t in range(s):
        lg, cache = T.decode_step(tp, cache, tok[:, t], cfg)
        assert float((lg - logits[:, t]).abs().max()) < 1e-4, t


@pytest.mark.parametrize("s,max_seq", [(12, 16), (13, 16), (16, 24)])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_reference(arch, s, max_seq):
    """The chunked prefill (ragged at 12 and 13; Zamba2's ring of 8 wraps)
    against the reference's (its ``prefill`` at 16, its replay otherwise):
    the last logits and every cache tensor, then 4 decode steps."""
    cfg, jp, tp = _model(arch)
    tok = _tokens(cfg, 2, s)
    if s % cfg.ssm_chunk:
        jl, jc = _ref_replay(jp, cfg, tok, max_seq)
    else:
        jl, jc = JT.prefill(jp, cfg, jnp.asarray(tok), max_seq)
    tl, tc = T.prefill(tp, cfg, _t(tok).long(), max_seq)
    _close(tl, jl, 2e-4)
    assert tc["pos"] == int(jc["pos"]) == s
    _check_cache(tc, jc, cfg, 2e-4)
    nxt = _tokens(cfg, 4, 2, seed=2)
    for t in range(4):
        jl, jc = _ref_step(cfg)(jp, jc, jnp.asarray(nxt[t]))
        tl, tc = T.decode_step(tp, tc, _t(nxt[t]).long(), cfg)
        _close(tl, jl, 2e-4)
        _check_cache(tc, jc, cfg, 2e-4)
    assert tc["pos"] == s + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_tokens_equal_reference(arch):
    cfg, jp, tp = _model(arch)
    tok = _tokens(cfg, 2, 8, seed=3)
    want = jserve.generate(jp, cfg, jnp.asarray(tok), 6)
    got = serve.generate(tp, cfg, _t(tok).long(), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """Paths and shapes (``shared`` for the hybrid; ``local_heads``), and
    the mixer's constant leaves equal to the reference's."""
    cfg = C.get_reduced(arch)
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                       local_heads=True)
    jp = jax.eval_shape(lambda r: JT.init_params(r, JC.get_reduced(arch),
                                                 local_heads=True),
                        jax.random.PRNGKey(0))
    flat_t = {"/".join(k): tuple(v.shape) for k, v in _flatten(tp).items()}
    flat_j = {"/".join(str(getattr(p, "key", p)) for p in k): tuple(v.shape)
              for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert flat_t == flat_j
    assert ("shared/attn/wq/w" in flat_t) == (cfg.family == "hybrid")
    _, jvals, _ = _model(arch)
    for leaf in ("conv_b", "a_log", "d_skip", "dt_bias", "norm_g"):
        _close(tp["layers"]["mixer"][leaf], jvals["layers"]["mixer"][leaf], 1e-6)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _flip_a_log(tp):
    mixer = dict(tp["layers"]["mixer"], a_log=-tp["layers"]["mixer"]["a_log"])
    return dict(tp, layers=dict(tp["layers"], mixer=mixer))


def _drop_shared(tp):
    return {k: v for k, v in tp.items() if k != "shared"}


@pytest.mark.parametrize("arch,fault", [("mamba2_2p7b", _flip_a_log),
                                        ("zamba2_1p2b", _drop_shared)])
def test_a_planted_fault_fails_the_parity(arch, fault):
    """``a_log`` with its sign flipped (decays of exp(-a) in place of
    exp(a)), or the hybrid without its shared block: ``forward`` leaves the
    reference's bound by far."""
    cfg, jp, tp = _model(arch)
    tok = _tokens(cfg, 2, 16)
    want, _ = JT.forward(jp, cfg, tokens=jnp.asarray(tok))
    got, _ = T.forward(fault(tp), cfg, tokens=_t(tok).long())
    with pytest.raises(AssertionError):
        _close(got, want, 1e-5)
    assert float((got - _t(want)).abs().max()) > 1e-2


def test_cache_from_numpy_keeps_the_ssm_state_f32():
    """A bf16 hybrid's reference cache through ``lm_cache_from_numpy``:
    ``ssm`` f32, ``conv`` and the shared rings bf16, the port's own cache
    alike."""
    cfg = dataclasses.replace(JC.get_reduced("zamba2_1p2b"), dtype="bfloat16")
    got = convert.lm_cache_from_numpy(_np_tree(JT.init_cache(cfg, 2, 16)), cfg, "cpu")
    own = T.init_cache(cfg, 2, 16, device="cpu")
    assert {k: v.dtype for k, v in got.items() if k != "pos"} == {
        "conv": torch.bfloat16, "ssm": torch.float32,
        "shared_k": torch.bfloat16, "shared_v": torch.bfloat16}
    assert {k: (v.dtype, v.shape) for k, v in own.items() if k != "pos"} == \
        {k: (v.dtype, v.shape) for k, v in got.items() if k != "pos"}
    assert got["pos"] == own["pos"] == 0


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _close_rel(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=rtol * max(1e-30, float(np.abs(want).max())))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, prefix + (k,))]
    return [(prefix, tree)]


@pytest.mark.parametrize("s", [16, 24])
def test_mamba2_forward_grads_match_reference(s):
    """Two and three SSD chunks of 8: the gradients of ``sum(out · r)`` with
    respect to the input and every float leaf of the mixer equal
    ``jax.grad`` of the reference's ``mamba2_forward``."""
    cfg, jlp, lp = _mixer("mamba2_2p7b")
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jgx, jgp = jax.grad(lambda xx, p: (JM.mamba2_forward(p, xx, cfg) * r).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jlp)
    paths = [k for k, v in _leaves(lp) if v.is_floating_point()]
    tracked = {k: v.detach().requires_grad_() for k, v in _leaves(lp)
               if k in paths}
    tp = {k[0]: {k[1]: v} if len(k) > 1 else v for k, v in tracked.items()}
    xx = _t(x).requires_grad_()
    out = M.mamba2_forward(tp, xx, cfg)
    grads = torch.autograd.grad((out * _t(r)).sum(), [xx, *tracked.values()])
    _close_rel(grads[0], jgx, 1e-4)
    jflat = dict(_leaves(jgp))
    assert len(paths) == 8
    for k, g in zip(paths, grads[1:]):
        assert float(np.abs(np.asarray(jflat[k])).max()) > 0.0, k
        _close_rel(g, jflat[k], 1e-4)


def test_ssd_in_place_equals_out_of_place():
    """Where autograd is off the SSD updates its decay tensor in place (the
    serving prefill's peak); with autograd on it runs out of place. The two
    forwards are equal bit for bit, and the backward is finite."""
    rng = np.random.default_rng(11)
    b, s, h, p, n, q = 2, 24, 3, 4, 5, 8
    xdt, bm, cm = (_t(rng.standard_normal(shape).astype(np.float32))
                   for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    da = -_t(rng.random((b, s, h)).astype(np.float32)) * 4
    with torch.no_grad():
        y0, st0 = M._ssd(xdt, da, bm, cm, q)
    leaves = [t.clone().requires_grad_() for t in (xdt, da, bm, cm)]
    y1, st1 = M._ssd(*leaves, q)
    assert torch.equal(y0, y1) and torch.equal(st0, st1)
    grads = torch.autograd.grad(y1.sum() + st1.sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_padded_prefill_passes_gradients_only_to_real_positions():
    """A ragged sequence is padded inside the SSD to whole chunks: the
    gradients of the real positions' outputs with respect to the real
    inputs equal those of a caller-padded sequence run as whole chunks
    (the mixer is causal), and the padding gets none."""
    cfg, _, lp = _mixer("mamba2_2p7b")
    rng = np.random.default_rng(12)
    s = 13
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    r = _t(rng.standard_normal((2, s, cfg.d_model)).astype(np.float32))
    xr = _t(x).requires_grad_()
    (g_ragged,) = torch.autograd.grad(
        (M.mamba2_prefill(lp, xr, cfg)[0] * r).sum(), [xr])
    xp = _t(np.pad(x, ((0, 0), (0, 16 - s), (0, 0)))).requires_grad_()
    (g_whole,) = torch.autograd.grad(
        (M.mamba2_forward(lp, xp, cfg)[:, :s] * r).sum(), [xp])
    _close_rel(g_ragged, g_whole[:, :s].numpy(), 1e-5)
    assert float(g_whole[:, s:].abs().max()) == 0.0


def test_shared_block_grads_match_reference():
    """Zamba2's shared block called twice in a row (one set of params, as
    after layers 1 and 3 of the reduced config): the gradients of its
    params and of the input are the reference's, summed over the calls."""
    cfg, jp, tp = _model("zamba2_1p2b")
    b, s = 2, 16
    rng = np.random.default_rng(13)
    h = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jang = JT._angles_for(cfg, None, b, s)

    def jloss(hh, shared):
        from repro.models import layers as JL
        for _ in range(2):
            hh = JT._shared_apply(shared, hh, jang, cfg, JL.attn_full)
        return (hh * r).sum()
    jgh, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jp["shared"])
    from repro_torch.models import layers as L
    shared = {k: v for k, v in _leaves(tp["shared"])}
    tracked = {k: v.detach().requires_grad_() for k, v in shared.items()}
    tree = {}
    for k, v in tracked.items():
        node = tree
        for part in k[:-1]:
            node = node.setdefault(part, {})
        node[k[-1]] = v
    hh = _t(h).requires_grad_()
    ang = T._angles_for(cfg, None, b, s, "cpu")
    out = hh
    for _ in range(2):
        out, _ = T._shared_apply(tree, out, ang, cfg, L.attn_full_flash)
    grads = torch.autograd.grad((out * _t(r)).sum(), [hh, *tracked.values()])
    _close_rel(grads[0], jgh, 1e-4)
    jflat = dict(_leaves(jgs))
    assert set(jflat) == set(tracked)
    for k, g in zip(tracked, grads[1:]):
        _close_rel(g, jflat[k], 1e-4)


def test_ssd_grads_stay_finite_where_the_decay_overflows_above_the_diagonal():
    """With a large step (``dt_bias`` 8: a decay of up to 16·8 a position)
    ``exp(cs_i - cs_j)`` above the diagonal overflows in f32. The port masks
    before the ``exp``, so its gradients stay finite; the reference takes
    ``where(tri, exp(seg), 0)``, whose gradient there is ``0 · inf = NaN``
    (a reference-side caveat, ROADMAP Queue 3). The forwards agree."""
    cfg, jlp, _ = _mixer("mamba2_2p7b")
    jlp = dict(jlp, dt_bias=jnp.full_like(jlp["dt_bias"], 8.0))
    lp = convert.lm_params_from_numpy(_np_tree(jlp), cfg, "cpu")
    x = np.random.default_rng(14).standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    jout = JM.mamba2_forward(jlp, jnp.asarray(x), cfg)
    jg = jax.grad(lambda p: JM.mamba2_forward(p, jnp.asarray(x), cfg).sum())(jlp)
    a_log = lp["a_log"].requires_grad_()
    xx = _t(x).requires_grad_()
    out = M.mamba2_forward(lp, xx, cfg)
    _close(out, jout, 1e-5)
    grads = torch.autograd.grad(out.sum(), [xx, a_log])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert not bool(np.isfinite(np.asarray(jg["a_log"])).all())
