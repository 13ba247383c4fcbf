"""The port's gradient compression (``repro_torch.runtime.compression``)
against the JAX reference's (``repro.runtime.compression``).

Every payload is compared bit for bit (no tolerance): int8 quantisation is
f32 ``max|chunk| / 127 + 1e-12``, one division and a round half to even in
both packages; top-k selects and orders the same elements (planted ties
included: ``jax.lax.top_k`` puts the lower index first) and copies their
values. ``ErrorFeedback`` over five steps is then bit for bit too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import compression as J
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import compression as P
from repro_torch.runtime.compression import (CompressionConfig, ErrorFeedback,
                                             compress, compressed_bytes,
                                             decompress)

torch.set_num_threads(1)


def _pair(kind, **kw):
    return J.CompressionConfig(kind=kind, **kw), P.CompressionConfig(kind=kind, **kw)


def _both(a, bf16=False):
    """One numpy array as a jax array and a torch tensor (bf16 in both, or
    f32)."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()
    return jnp.asarray(a), torch.tensor(a)


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.dtype, a.shape, a.tobytes()


def _assert_payload_equal(cj, ct):
    assert len(cj.payload) == len(ct.payload)
    for a, b in zip(cj.payload, ct.payload):
        assert _bits(a) == _bits(b)
    assert tuple(cj.meta[0]) == tuple(ct.meta[0]) and cj.meta[1] == ct.meta[1]


def _grad(shape, seed, ties=False):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if ties:
        # equal magnitudes (both signs) across the top and at the cut, zeros
        flat = g.reshape(-1)
        flat[::7] = 2.5
        flat[3::11] = -2.5
        flat[5::13] = 0.0
        flat[1::17] = np.sort(np.abs(flat))[-len(flat) // 5]
    return g


SHAPES = [(37, 53), (5,), (256,), (257,), (3, 300), (2, 4, 33)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("chunk", [256, 64])
def test_int8_payload_and_round_trip_bitwise(shape, bf16, chunk):
    cfgj, cfgt = _pair("int8", chunk=chunk)
    gj, gt = _both(_grad(shape, 1, ties=True), bf16)
    cj, ct = J.compress(gj, cfgj), compress(gt, cfgt)
    _assert_payload_equal(cj, ct)
    assert ct.payload[0].dtype == torch.int8 and ct.payload[1].dtype == torch.float32
    assert _bits(J.decompress(cj, cfgj)) == _bits(decompress(ct, cfgt))
    assert J.compressed_bytes(cj, cfgj) == compressed_bytes(ct, cfgt)


def test_int8_rounds_half_to_even():
    """A chunk whose absmax is 127 has scale 1 (+1e-12): x.5 values land on
    the even neighbour in both packages."""
    cfgj, cfgt = _pair("int8", chunk=8)
    a = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -3.5], np.float32)
    cj, ct = J.compress(jnp.asarray(a), cfgj), compress(torch.tensor(a), cfgt)
    _assert_payload_equal(cj, ct)
    assert ct.payload[0].tolist() == [[127, 0, 2, 2, 0, -2, 126, -4]]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("frac", [0.05, 0.2, 0.9])
def test_topk_payload_equal_with_planted_ties(shape, bf16, frac):
    cfgj, cfgt = _pair("topk", topk_frac=frac)
    gj, gt = _both(_grad(shape, 2, ties=True), bf16)
    cj, ct = J.compress(gj, cfgj), compress(gt, cfgt)
    _assert_payload_equal(cj, ct)
    assert ct.payload[1].dtype == torch.int32
    assert _bits(J.decompress(cj, cfgj)) == _bits(decompress(ct, cfgt))
    assert J.compressed_bytes(cj, cfgj) == compressed_bytes(ct, cfgt)


def test_topk_all_equal_and_all_zero():
    """Every magnitude tied: the lowest indices, in order."""
    for a in (np.full(50, -1.0, np.float32), np.zeros(50, np.float32),
              np.tile(np.float32([1.0, -1.0]), 25)):
        cfgj, cfgt = _pair("topk", topk_frac=0.1)
        cj = J.compress(jnp.asarray(a), cfgj)
        ct = compress(torch.tensor(a), cfgt)
        _assert_payload_equal(cj, ct)
        assert ct.payload[1].tolist() == [0, 1, 2, 3, 4]


def test_topk_indices_order():
    a = torch.tensor([1.0, 3.0, 3.0, 0.5, 3.0, 2.0])
    assert P.topk_indices(a, 4).tolist() == [1, 2, 4, 5]
    assert P.topk_indices(a, 6).tolist() == [1, 2, 4, 5, 0, 3]


def test_none_passes_through():
    cfgj, cfgt = _pair("none")
    g = _grad((4, 5), 3)
    ct = compress(torch.tensor(g), cfgt)
    assert torch.equal(decompress(ct, cfgt), torch.tensor(g))
    assert compressed_bytes(ct, cfgt) == J.compressed_bytes(
        J.compress(jnp.asarray(g), cfgj), cfgj) == g.size * 4


# ---------------------------------------------------------------------------
# the reference's substrate tests, mirrored
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_roundtrip_bounded(kind):
    cfg = CompressionConfig(kind=kind, topk_frac=0.2)
    g = torch.randn((37, 53), generator=torch.Generator().manual_seed(0))
    rec = decompress(compress(g, cfg), cfg)
    assert rec.shape == g.shape
    if kind == "int8":
        assert float((rec - g).abs().max()) < float(g.abs().max()) / 100
    assert compressed_bytes(compress(g, cfg), cfg) < g.numel() * 4


@pytest.mark.parametrize("seed,rows,cols", [(0, 1, 1), (5, 40, 40), (9, 13, 27),
                                            (77, 1, 39), (123, 31, 2)])
def test_int8_error_bound(seed, rows, cols):
    cfg = CompressionConfig(kind="int8")
    g = torch.randn((rows, cols), generator=torch.Generator().manual_seed(seed))
    rec = decompress(compress(g, cfg), cfg)
    # per-chunk absmax scaling bounds error by scale/2 = absmax/254
    assert float((rec - g).abs().max()) <= float(g.abs().max()) / 127 + 1e-6


def test_error_feedback_preserves_signal():
    """With EF, the *sum* of applied gradients tracks the true sum (top-k
    alone would lose the small coordinates forever)."""
    cfg = CompressionConfig(kind="topk", topk_frac=0.1)
    g = {"w": torch.linspace(0.01, 1.0, 64).reshape(8, 8)}
    ef = ErrorFeedback.init(g)
    applied = torch.zeros((8, 8))
    for _ in range(30):
        rec, ef = ef.step(g, cfg)
        applied += rec["w"]
    true_sum = g["w"] * 30
    rel = float((applied - true_sum).abs().max() / true_sum.max())
    assert rel < 0.25
    plain = torch.zeros((8, 8))
    for _ in range(30):
        plain += decompress(compress(g["w"], cfg), cfg)
    rel_plain = float((plain - true_sum).abs().max() / true_sum.max())
    assert rel < rel_plain


# ---------------------------------------------------------------------------
# error feedback against the reference, and convergence
# ---------------------------------------------------------------------------

def _grad_tree(step, bf16):
    rng = np.random.default_rng(100 + step)
    tree = {"a": rng.standard_normal((7, 45)).astype(np.float32),
            "n": {"b": rng.standard_normal((300,)).astype(np.float32),
                  "c": rng.standard_normal((2, 3, 5)).astype(np.float32)}}
    tree["a"][0, :9] = 1.25                       # ties
    j = jax.tree.map(lambda a: _both(a, bf16)[0], tree)
    t = {"a": _both(tree["a"], bf16)[1],
         "n": {k: _both(v, bf16)[1] for k, v in tree["n"].items()}}
    return j, t


@pytest.mark.parametrize("kind", ["int8", "topk"])
@pytest.mark.parametrize("bf16", [False, True])
def test_error_feedback_five_steps_bitwise(kind, bf16):
    cfgj, cfgt = _pair(kind, topk_frac=0.1)
    gj, gt = _grad_tree(0, bf16)
    efj, eft = J.ErrorFeedback.init(gj), ErrorFeedback.init(gt)
    for step in range(5):
        gj, gt = _grad_tree(step, bf16)
        recj, efj = efj.step(gj, cfgj)
        rect, eft = eft.step(gt, cfgt)
        for path, a in jax.tree_util.tree_flatten_with_path(recj)[0]:
            keys = [p.key for p in path]
            b = rect
            r = eft.residual
            e = efj.residual
            for k in keys:
                b, r, e = b[k], r[k], e[k]
            assert _bits(a if not bf16 else jnp.asarray(a, jnp.float32)) == \
                _bits(b if not bf16 else b.float()), (step, keys)
            assert b.dtype == (torch.bfloat16 if bf16 else torch.float32)
            assert _bits(e) == _bits(r), (step, keys)


def test_error_feedback_skips_integer_leaves():
    """A gradient tree of the port's training step holds None at integer
    leaves (masks, kept rows): none in, none out."""
    g = {"w": torch.ones((4, 4)), "rows": None}
    ef = ErrorFeedback.init(g)
    assert ef.residual["rows"] is None
    rec, ef = ef.step(g, CompressionConfig(kind="int8"))
    assert rec["rows"] is None and ef.residual["rows"] is None
    assert torch.equal(rec["w"], g["w"])


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_adamw_converges_quadratic_through_compression(kind):
    """The reference's AdamW quadratic (tests/test_substrate.py) with every
    gradient compressed under error feedback (top-k keeps one of the two
    coordinates a step): it still converges, and the integer leaf stays
    untouched."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    ccfg = CompressionConfig(kind=kind, topk_frac=0.5)
    params = {"w": torch.tensor([3.0, -2.0]),
              "mask": torch.tensor([1, 1], dtype=torch.int32)}
    state = adamw_init(params)
    ef = ErrorFeedback.init({"w": params["w"], "mask": None})
    for _ in range(100):
        grads = {"w": 2 * params["w"], "mask": None}
        grads, ef = ef.step(grads, ccfg)
        params, state, _ = adamw_update(grads, params, state, cfg)
    assert float(params["w"].abs().max()) < 0.05
    assert params["mask"].dtype == torch.int32 and params["mask"].tolist() == [1, 1]
