"""The port's flash-attention package against the JAX reference, on the
same numpy inputs.

Tolerances: the plain kernel-layout ``flash_fwd`` against the reference
kernel in interpret mode ``atol = rtol = 2e-5``, the reference's own bound
for its kernel against its oracle (f32: one pass vs online tiles, sums in
another order). The op against the reference oracle ``2e-5`` (the same
f32 einsums and softmax); gradients ``5e-5``, the reference's own
flash-backward bound. Layouts, traffic models and launch geometry are
exact.

Tests marked ``cuda`` hold the CUDA kernel against its plain version on
the card and skip where there is none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ops as jops, ref as jref
from repro.kernels.flash_attn.kernel import flash_fwd as jflash_fwd
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.kernels.flash_attn import ops, ref

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(seed, b, s, h, kv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)))


# the reference's kernel sweep (tests/test_kernels.py)
SWEEP = [(2, 32, 4, 2, 16, 8, 8),
         (1, 64, 2, 2, 32, 16, 16),
         (2, 16, 4, 1, 8, 16, 16)]


@pytest.mark.parametrize("b,s,h,kv,dh,bq,bk", SWEEP)
@pytest.mark.parametrize("window", [None, 8])
def test_plain_flash_fwd_matches_reference_kernel(b, s, h, kv, dh, bq, bk, window):
    q, k, v = _qkv(0, b, s, h, kv, dh)
    jq, jk, jv = jops._to_kernel_layout(*map(jnp.asarray, (q, k, v)))
    jo, jlse = jflash_fwd(jq, jk, jv, bq=bq, bk=bk, window=window,
                          interpret=True)
    tq, tk, tv = ops._to_kernel_layout(*map(torch.tensor, (q, k, v)))
    o, lse = ref.flash_fwd(tq, tk, tv, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5,
                               rtol=2e-5)


def test_kernel_layout_matches_reference():
    q, k, v = _qkv(1, 2, 8, 6, 2, 4)
    want = jops._to_kernel_layout(*map(jnp.asarray, (q, k, v)))
    got = ops._to_kernel_layout(*map(torch.tensor, (q, k, v)))
    for a, c in zip(want, got):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    o = np.asarray(want[0])
    np.testing.assert_array_equal(
        ops._from_kernel_layout(torch.tensor(o), 2, 8, 6, 4).numpy(),
        np.asarray(jops._from_kernel_layout(jnp.asarray(o), 2, 8, 6, 4)))


@pytest.mark.parametrize("b,s,h,kv,dh,window", [
    (2, 16, 4, 2, 8, None),      # GQA
    (1, 24, 4, 1, 16, None),     # MQA
    (2, 20, 4, 2, 8, 5),         # sliding window
])
def test_flash_attention_op_matches_reference_attention(b, s, h, kv, dh, window):
    q, k, v = _qkv(2, b, s, h, kv, dh)
    want = jref.attention(*map(jnp.asarray, (q, k, v)), window)
    got = ops.flash_attention(*map(torch.tensor, (q, k, v)), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_flash_attention_cpu_grads_match_reference(window):
    q, k, v = _qkv(3, 2, 32, 4, 2, 16)
    dout = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda *a: (jref.attention(*a, window) * dout).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (ops.flash_attention(tq, tk, tv, window) * torch.tensor(dout)).sum().backward()
    for a, c in zip(want, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("b,s,h,dh,bq,bk,backward", [
    (16, 4096, 4, 128, 128, 128, True),
    (4, 2048, 40, 128, 128, 128, False),
    (2, 1024, 8, 64, 64, 128, True),
])
def test_traffic_models_match_reference(b, s, h, dh, bq, bk, backward):
    assert ops.hbm_bytes(b, s, h, dh, bq=bq, bk=bk, with_backward=backward) \
        == jops.hbm_bytes(b, s, h, dh, bq=bq, bk=bk, with_backward=backward)
    assert ops.xla_score_path_bytes(b, s, h, dh) \
        == jops.xla_score_path_bytes(b, s, h, dh)


@pytest.mark.parametrize("dh", [64, 128, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,window", [(200, None), (200, 37), (64, 1),
                                      (200, 65), (200, 66),  # tile edges
                                      (2048, 512)])
def test_launch_covers_every_row_once_and_visits_only_open_tiles(dh, dtype, s,
                                                                 window):
    cfg = fk.launch_config(4, s, 40, dh, dtype)
    assert cfg.smem_bytes <= fk.SMEM_LIMIT
    assert cfg.nbh == 4 * 40
    rows = [list(range(i * cfg.bq, min(s, (i + 1) * cfg.bq)))
            for i in range(cfg.nq)]
    assert sorted(r for blk in rows for r in blk) == list(range(s))
    for blk in rows:
        lo, hi = fk.kv_tile_range(blk[0], blk[-1] + 1, s, window, cfg.bk)
        # row i sees keys max(0, i - window + 1) .. i
        open_tiles = {tile for i in blk for tile in range(
            (0 if window is None else max(0, i - window + 1)) // cfg.bk,
            i // cfg.bk + 1)}
        assert set(range(lo, hi)) == open_tiles


def test_launch_config_rejects_what_has_no_kernel():
    with pytest.raises(ValueError):
        fk.launch_config(1, 8, 1, 96, torch.bfloat16)
    with pytest.raises(TypeError):
        fk.launch_config(1, 8, 1, 64, torch.float16)


def _tiled_fwd_bf16(q, k, v, window, drop_tile=None, bq=64, bk=64):
    """The CUDA kernel's bf16 arithmetic, tile by tile in plain torch
    (kernel layout): online max and sum over the KV tiles a query tile
    visits, p rounded to bf16 against the running max. ``drop_tile`` leaves
    that KV tile out of the last query tile (a planted kernel fault)."""
    n, s, dh = q.shape
    ok = ref.causal_ok(s, s, window, "cpu")
    out = torch.empty_like(q)
    for q0 in range(0, s, bq):
        q1 = min(s, q0 + bq)
        m = torch.full((n, q1 - q0), float("-inf"))
        l = torch.zeros(n, q1 - q0)
        acc = torch.zeros(n, q1 - q0, dh)
        lo, hi = fk.kv_tile_range(q0, q1, s, window, bk)
        for kt in range(lo, hi):
            if q1 == s and kt == drop_tile:
                continue
            k0, k1 = kt * bk, min(s, kt * bk + bk)
            sc = q[:, q0:q1].float() @ k[:, k0:k1].float().transpose(1, 2)
            sc = torch.where(ok[q0:q1, k0:k1], sc * dh ** -0.5, float("-inf"))
            mn = torch.maximum(m, sc.amax(-1))
            base = torch.where(mn == float("-inf"), 0.0, mn)
            alpha, m = torch.exp(m - base), mn
            p = torch.exp(sc - base[..., None])
            l = l * alpha + p.sum(-1)
            acc = (acc * alpha[..., None]
                   + p.to(torch.bfloat16).float() @ v[:, k0:k1].float())
        out[:, q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


@pytest.mark.parametrize("s,window,drop_tile", [
    (512, None, None), (500, 100, None),      # the kernel's own rounding
    (512, None, 3), (500, 100, 6),            # one KV tile left out
])
def test_bf16_out_tolerance_admits_rounding_and_catches_a_lost_tile(
        s, window, drop_tile):
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in _qkv(7, 4, s, 1, 1, 128))
    q, k, v = (a[:, :, 0] for a in (q, k, v))                 # [N=4, S, dh]
    o_r, _ = ref.flash_fwd(q, k, v, window)
    o = _tiled_fwd_bf16(q, k, v, window, drop_tile)
    over = (o.float() - o_r.float()).abs() > ref.bf16_out_tolerance(o_r)
    if drop_tile is None:
        assert not bool(over.any())
    else:
        assert float(over[:, -(s % 64 or 64):].float().mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,kv,dh,window", [
    (torch.bfloat16, 2, 256, 8, 2, 128, None),
    (torch.float32, 2, 256, 8, 2, 64, None),
    (torch.bfloat16, 1, 300, 4, 4, 160, 37),
    (torch.bfloat16, 2, 1000, 4, 1, 64, None),     # ragged, MQA
])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, b, s, h, kv, dh, window):
    q, k, v = (torch.tensor(a).to(cuda, dtype) for a in _qkv(5, b, s, h, kv, dh))
    before = fk.flash_fwd_cuda.launches
    o, lse = fk.flash_fwd_cuda(q, k, v, window)
    assert fk.flash_fwd_cuda.launches == before + 1
    o_r, lse_r = ref.flash_fwd(*ops._to_kernel_layout(q, k, v), window)
    o_r = ops._from_kernel_layout(o_r, b, s, h, dh)
    # f32: sums in another order; bf16: ref.bf16_out_tolerance per element
    tol = 1e-5 if dtype == torch.float32 else ref.bf16_out_tolerance(o_r)
    assert bool(((o.float() - o_r.float()).abs() <= tol).all())
    assert float((lse - lse_r).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_flash_backward_raises_on_card(cuda):
    q, k, v = (torch.tensor(a).to(cuda).requires_grad_()
               for a in _qkv(6, 1, 16, 2, 1, 64))
    out = ops.flash_attention(q, k, v)
    with pytest.raises(NotImplementedError):
        out.sum().backward()
