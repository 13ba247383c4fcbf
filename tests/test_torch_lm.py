"""The port's LM serving path (configs, layers, transformer, serve) against
the JAX reference, on the reference's weights carried across as numpy.

Tolerance ``1e-4`` for logits, caches and aux (f32 reduced configs), the
bound of the reference's own decode ≡ forward test: both packages run the
same f32 products and softmaxes, summed in other orders. Single layers
``2e-5`` (one op deep; the reference's flash-vs-oracle bound). Greedy
tokens must be equal; configs and sparse row ids exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core import sparsity as jsp
from repro.launch import serve as jserve
from repro.models import layers as JL, transformer as JT
import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch import serve, train
from repro_torch.models import layers as L, transformer as T

torch.set_num_threads(1)

ATTN_ARCHS = ["phi3_medium_14b", "stablelm_12b", "nemotron_4_15b",
              "deepseek_67b", "qwen2_vl_2b", "musicgen_large"]


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _t(a):
    return torch.tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _model(arch, swa=None):
    cfg = JC.get_reduced(arch)
    if swa is not None:
        cfg = dataclasses.replace(cfg, swa_window=swa)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_get_config_and_reduced_match_reference(arch):
    assert C.normalize(arch) == JC.normalize(arch)
    for get in ("get_config", "get_reduced"):
        got, want = getattr(C, get)(arch), getattr(JC, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("head_dim", "d_inner", "ssm_heads", "subquadratic",
                     "is_attention_free"):
            assert getattr(got, prop) == getattr(want, prop)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        for shape in JC.SHAPES:
            assert C.shape_applicable(got, C.SHAPES[shape])[0] == \
                JC.shape_applicable(want, JC.SHAPES[shape])[0]
    assert list(C.all_configs()) == list(JC.all_configs()) == C.ARCH_IDS


def test_phi3_full_width_numbers():
    cfg = C.get_config("phi3_medium_14b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (40, 5120, 40, 10, 128,
                                                   17920, 100352)
    assert cfg.param_count() == 14_659_502_080


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3
    g = rng.standard_normal(32).astype(np.float32)
    _close(L.rmsnorm(_t(g), _t(x), 1e-5), JL.rmsnorm(g, x, 1e-5), 2e-5)


def test_rope_mrope_and_rotary_match_reference():
    pos = np.arange(24, dtype=np.int32).reshape(2, 12)
    _close(L.rope_angles(_t(pos), 16, 1e4), JL.rope_angles(pos, 16, 1e4), 2e-5)
    pos3 = np.stack([pos, pos // 2, pos % 5])
    got = L.mrope_angles(_t(pos3), 16, 1e6, (2, 3, 3))
    want = JL.mrope_angles(jnp.asarray(pos3), 16, 1e6, (2, 3, 3))
    _close(got, want, 2e-5)
    x = np.random.default_rng(1).standard_normal((2, 12, 3, 16)).astype(np.float32)
    _close(L.apply_rotary(_t(x), got), JL.apply_rotary(x, want), 2e-5)


@pytest.mark.parametrize("mode", ["dense", "masked", "compact"])
def test_linear_apply_matches_reference(mode):
    sp = (None if mode == "dense"
          else JC.SparsityConfig(n=1, m=2, block=4, mode=mode))
    p = JL.linear_init(jax.random.PRNGKey(3), 32, 8, jnp.float32, sp)
    if mode == "compact":
        umask = jsp.random_unit_mask(jax.random.PRNGKey(4),
                                     jsp.NMSpec(n=1, m=2, block=4, out_tile=8), 32, 8)
        rows = L._rows_from_umask(_t(umask)[:, 0], 4, n=1, m=2)
        np.testing.assert_array_equal(
            rows.numpy(), np.asarray(JL._rows_from_umask(umask[:, 0], 4, n=1, m=2)))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, p),
                                      JC.get_reduced("phi3_medium_14b"), "cpu")
    x = np.random.default_rng(5).standard_normal((3, 32)).astype(np.float32)
    _close(L.linear_apply(tp, _t(x), sp), JL.linear_apply(p, x, sp), 2e-5)


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "nemotron_4_15b",
                                  "musicgen_large"])                # swiglu, relu2, gelu
def test_mlp_matches_reference(arch):
    cfg, jp, tp = _model(arch)
    x = np.random.default_rng(6).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    lp = T.layer_view(tp["layers"], 0)["mlp"]
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])["mlp"]
    _close(L.mlp_apply(lp, _t(x), cfg), JL.mlp_apply(jlp, x, cfg), 2e-5)


@pytest.mark.parametrize("swa", [None, 5])
def test_full_chunked_and_flash_attention_match_reference(swa):
    cfg, jp, tp = _model("phi3_medium_14b", swa)
    s = 16
    x = np.random.default_rng(7).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s))
    jang = JL.rope_angles(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    ang = L.rope_angles(_t(pos), cfg.head_dim, cfg.rope_theta)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    lp = T.layer_view(tp["layers"], 0)["attn"]
    want, (wk, wv) = JL.attn_full(jlp, x, jang, cfg)
    for fn in (L.attn_full, L.attn_full_flash,
               functools.partial(L.attn_full_chunked, q_chunk=4)):
        got, (k, v) = fn(lp, _t(x), ang, cfg)
        _close(got, want, 2e-5)
        _close(k, wk, 2e-5)
        _close(v, wv, 2e-5)


def test_attn_decode_swa_ring_matches_reference():
    cfg, jp, tp = _model("phi3_medium_14b", 8)
    c = T.cache_len(cfg, 20)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    lp = T.layer_view(tp["layers"], 0)["attn"]
    rng = np.random.default_rng(8)
    jk = jv = jnp.zeros((2, c, cfg.n_kv_heads, cfg.head_dim))
    tk, tv = torch.zeros(tuple(jk.shape)), torch.zeros(tuple(jk.shape))
    for pos in range(13):                          # past the 8-slot ring
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        p = np.full((2, 1), pos, np.int32)
        jo, jk, jv = JL.attn_decode(jlp, x, JL.rope_angles(p, cfg.head_dim, 1e4),
                                    jk, jv, jnp.int32(pos), cfg)
        o, tk, tv = L.attn_decode(lp, _t(x), L.rope_angles(_t(p), cfg.head_dim, 1e4),
                                  tk, tv, pos, cfg)
        _close(o, jo, 2e-5)
        _close(tk, jk, 2e-5)


# ---------------------------------------------------------------------------
# transformer and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_matches_reference(arch):
    cfg, jp, tp = _model(arch)
    b, s = 2, 12
    if cfg.frontend:
        e = np.random.default_rng(9).standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
        want, jaux = JT.forward(jp, cfg, embeds=jnp.asarray(e))
        got, aux = T.forward(tp, cfg, embeds=_t(e))
    else:
        tok = _tokens(cfg, b, s)
        want, jaux = JT.forward(jp, cfg, tokens=jnp.asarray(tok))
        got, aux = T.forward(tp, cfg, tokens=_t(tok).long())
    _close(got, want)
    _close(aux["ia"], jaux["ia"])
    _close(aux["pooled"], jaux["pooled"])
    plain, _ = T.forward(tp, cfg, tokens=None if cfg.frontend else _t(tok).long(),
                         embeds=_t(e) if cfg.frontend else None, attn="plain")
    _close(plain, want)


@pytest.mark.parametrize("arch,swa", [("phi3_medium_14b", None),
                                      ("phi3_medium_14b", 8),
                                      ("qwen2_vl_2b", None)])
def test_prefill_cache_and_decode_match_reference(arch, swa):
    cfg, jp, tp = _model(arch, swa)
    tok = _tokens(cfg, 2, 12)
    max_seq = 16
    jl, jc = JT.prefill(jp, cfg, jnp.asarray(tok), max_seq)
    tl, tc = T.prefill(tp, cfg, _t(tok).long(), max_seq)
    _close(tl, jl)
    assert tc["pos"] == int(jc["pos"]) == 12
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    conv = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, jc), cfg, "cpu")
    assert conv["pos"] == 12 and torch.equal(conv["k"], _t(jc["k"]))
    nxt = _tokens(cfg, 4, 2, seed=2)
    for t in range(4):                             # SWA: slots 4..7 of the ring
        jl, jc = JT.decode_step(jp, jc, jnp.asarray(nxt[t]), cfg)
        tl, tc = T.decode_step(tp, tc, _t(nxt[t]).long(), cfg)
        _close(tl, jl)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
    assert tc["pos"] == 16


@pytest.mark.parametrize("arch", ["phi3_medium_14b", "musicgen_large"])
def test_greedy_generate_tokens_equal_reference(arch):
    cfg, jp, tp = _model(arch)
    tok = _tokens(cfg, 2, 8, seed=3)
    want = jserve.generate(jp, cfg, jnp.asarray(tok), 6)
    got = serve.generate(tp, cfg, _t(tok).long(), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_in_range_and_repeats_per_seed():
    cfg, _, tp = _model("phi3_medium_14b")
    tok = _t(_tokens(cfg, 2, 6, seed=4)).long()

    def run(seed):
        return serve.generate(tp, cfg, tok, 5, temperature=0.8,
                              generator=torch.Generator().manual_seed(seed))
    a, b = run(11), run(11)
    assert torch.equal(a, b) and torch.equal(a[:, :6], tok)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    gens = serve.sample_key_chain(torch.Generator().manual_seed(11), 5)
    assert len(gens) == 5 and len({g.initial_seed() for g in gens}) == 5


@pytest.mark.parametrize("swa", [None, 4])
def test_decode_matches_forward_within_port(swa):
    cfg, _, tp = _model("phi3_medium_14b", swa)
    b, s = 2, 8
    tok = _t(_tokens(cfg, b, s, seed=5)).long()
    logits, _ = T.forward(tp, cfg, tokens=tok)
    cache = T.init_cache(cfg, b, s, device="cpu")
    for t in range(s):
        lg, cache = T.decode_step(tp, cache, tok[:, t], cfg)
        assert float((lg - logits[:, t]).abs().max()) < 1e-4, t


def test_init_params_tree_matches_reference_and_local_modes_raise():
    """The params tree, with and without the OSSL ``local_heads``, has the
    reference's paths and shapes (local modes no longer raise: LM training
    brought them)."""
    cfg = C.get_reduced("qwen2_vl_2b")
    for local in (False, True):
        tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                           local_heads=local)
        jp = jax.eval_shape(lambda r: JT.init_params(
            r, JC.get_reduced("qwen2_vl_2b"), local_heads=local),
            jax.random.PRNGKey(0))
        flat_t = {"/".join(map(str, k)): tuple(v.shape) for k, v in
                  _flatten(tp).items()}
        flat_j = {"/".join(str(getattr(p, "key", p)) for p in k): tuple(v.shape)
                  for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        assert flat_t == flat_j
        assert ("local_heads/p" in flat_t) == local
    assert flat_t["local_heads/p"] == (cfg.n_layers, cfg.d_model, cfg.d_model)
    logits, aux = T.forward(tp, cfg, tokens=torch.zeros((1, 12), dtype=torch.long),
                            local_mode=True)
    assert logits.shape == (1, 12, cfg.vocab) and float(aux["local_loss"]) != 0.0


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out
