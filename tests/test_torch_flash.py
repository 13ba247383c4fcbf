"""The port's flash-attention package against the JAX reference, on the
same numpy inputs.

Tolerances: the plain kernel-layout ``flash_fwd`` against the reference
kernel in interpret mode ``atol = rtol = 2e-5``, the reference's own bound
for its kernel against its oracle (f32: one pass vs online tiles, sums in
another order); the plain ``flash_bwd`` against the reference's backward
kernels ``5e-5``, its own flash-backward bound. The op against the
reference oracle ``2e-5`` (the same f32 einsums and softmax); gradients
``5e-5``. Layouts, traffic models and launch geometry are exact. The bf16
bounds the kernels are held to on the card (``ref.bf16_out_tolerance``,
``ref.bf16_grad_tolerance``) are checked here against tile-by-tile plain
emulations of the kernels' rounding, with and without a planted fault.

The CUDA kernels meet their plain versions on the card in
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ops as jops, ref as jref
from repro.kernels.flash_attn.kernel import (flash_bwd as jflash_bwd,
                                             flash_fwd as jflash_fwd)
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.kernels.flash_attn import ops, ref
from test_torch_cuda import f32_grads_and_tolerances as _f32_grads_and_tolerances

torch.set_num_threads(1)


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
    """Blocks cover every (batch, query head, row) once, each reading its
    own KV head, and visit exactly the KV tiles that hold a visible key."""
    b, h, kvh = 4, 40, 10
    cfg = fk.launch_config(b, s, h, dh, dtype)
    assert cfg.smem_bytes <= fk.SMEM_LIMIT
    assert cfg.nbh == b * h
    assert cfg.threads == (384 if dtype == torch.bfloat16 else 128)
    # grid y: n = batch * H + head, read from KV head head // G
    heads = [(n // h, n % h, (n % h) // (h // kvh)) for n in range(cfg.nbh)]
    assert sorted((bi, hi) for bi, hi, _ in heads) == \
        [(bi, hi) for bi in range(b) for hi in range(h)]
    assert all(kv == hi * kvh // h for _, hi, kv in heads)
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


@pytest.mark.parametrize("s", [64, 200, 300, 1000])
@pytest.mark.parametrize("window", [None, 1, 37, 65])
@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_tile_needs_mask_never_skips_an_invisible_pair(s, window, kernel):
    """Every tile the bf16 kernels visit and call mask-free holds only
    visible pairs: the forward's and dQ's 64-row consumer halves by their KV
    tiles, the dK/dV query tiles by the 64-key consumer halves of its key
    blocks (which also mask a query tile past S; the forward and dQ compute
    rows past S but write none). Windows 1, 37 and
    65 fall off the tile edges, s 200, 300 and 1000 leave ragged last tiles.
    Wholly visible tiles exist wherever the causal band is wider than a
    tile."""
    ok = ref.causal_ok(s, s, window, "cpu")
    free = 0
    if kernel in ("fwd", "dq"):
        if kernel == "fwd":
            cfg = fk.launch_config(1, s, 1, 128, torch.bfloat16)
            bq, bk = cfg.bq, cfg.bk
        else:
            cfg = fk.bwd_launch_config("dq", 1, s, s, 2, 1, 128, torch.bfloat16)
            bq, bk = cfg.block_rows, cfg.tile
        tiles = []
        for q0 in range(0, s, bq):
            lo, hi = fk.kv_tile_range(q0, min(s, q0 + bq), s, window, bk)
            tiles += [(r0, r0 + 64, kt * bk, kt * bk + bk, False)
                      for r0 in range(q0, q0 + bq, 64) for kt in range(lo, hi)]
    else:
        cfg = fk.bwd_launch_config("dkv", 1, s, s, 2, 1, 128, torch.bfloat16)
        tiles = []
        for k0 in range(0, s, cfg.block_rows):
            lo, hi = fk.q_tile_range(k0, min(s, k0 + cfg.block_rows), s, window,
                                     cfg.tile)
            tiles += [(qt * cfg.tile, qt * cfg.tile + cfg.tile, kc0, kc0 + 64, True)
                      for kc0 in range(k0, k0 + cfg.block_rows, 64)
                      for qt in range(lo, hi)]
    for q0, q1, k0, k1, past_s in tiles:
        needs = fk.tile_needs_mask(q0, q1, k0, k1, s, window) \
            or (past_s and q1 > s)
        if not needs:              # rows past S are not written
            free += 1
            assert k1 <= s
            assert bool(ok[q0:q1, k0:k1].all()), (q0, q1, k0, k1)
    if s >= 300 and window is None:
        assert free > 0


def test_launch_config_rejects_what_has_no_kernel():
    with pytest.raises(ValueError):
        fk.launch_config(1, 8, 1, 96, torch.bfloat16)
    with pytest.raises(TypeError):
        fk.launch_config(1, 8, 1, 64, torch.float16)


def _tiled_fwd_bf16(q, k, v, window, drop_tile=None):
    """The CUDA kernel's bf16 arithmetic, tile by tile in plain torch
    (kernel layout), at the kernel's tiles (``launch_config``): online max
    and sum over the KV tiles a query tile visits, p rounded to bf16 against
    the running max, scores masked only in the 64-row consumer halves that
    ``tile_needs_mask`` names. ``drop_tile`` leaves that KV tile out of the
    last query tile (a planted kernel fault)."""
    n, s, dh = q.shape
    cfg = fk.launch_config(1, s, 1, dh, torch.bfloat16)
    bq, bk = cfg.bq, cfg.bk
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
            keep = ok[q0:q1, k0:k1].clone()
            for r0 in range(q0, q1, 64):
                if not fk.tile_needs_mask(r0, r0 + 64, k0, k0 + bk, s, window):
                    keep[r0 - q0:r0 - q0 + 64] = True
            sc = q[:, q0:q1].float() @ k[:, k0:k1].float().transpose(1, 2)
            sc = torch.where(keep, sc * dh ** -0.5, float("-inf"))
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
    (512, None, 1), (500, 100, 2),            # one KV tile left out
])
def test_bf16_out_tolerance_admits_rounding_and_catches_a_lost_tile(
        s, window, drop_tile):
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in _qkv(7, 4, s, 1, 1, 128))
    q, k, v = (a[:, :, 0] for a in (q, k, v))                 # [N=4, S, dh]
    o_r, _ = ref.flash_fwd(q, k, v, window)
    o = _tiled_fwd_bf16(q, k, v, window, drop_tile)
    over = (o.float() - o_r.float()).abs() > ref.bf16_out_tolerance(o_r)
    bq = fk.launch_config(1, s, 1, 128, torch.bfloat16).bq
    if drop_tile is None:
        assert not bool(over.any())
    else:                              # the last query tile's rows
        assert float(over[:, -(s % bq or bq):].float().mean()) > 0.5


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kv,dh,bq,bk", SWEEP)
@pytest.mark.parametrize("window", [None, 8])
def test_plain_flash_bwd_matches_reference_kernels(b, s, h, kv, dh, bq, bk,
                                                   window):
    q, k, v = _qkv(8, b, s, h, kv, dh)
    dout = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = jops._to_kernel_layout(*map(jnp.asarray, (q, k, v)))
    jo, jlse = jflash_fwd(jq, jk, jv, bq=bq, bk=bk, window=window,
                          interpret=True)
    jdo = jnp.asarray(dout).transpose(0, 2, 1, 3).reshape(b * h, s, dh)
    want = jflash_bwd(jq, jk, jv, jo, jlse, jdo, bq=bq, bk=bk, window=window,
                      interpret=True)
    tq, tk, tv = ops._to_kernel_layout(*map(torch.tensor, (q, k, v)))
    got = ref.flash_bwd(tq, tk, tv, torch.tensor(np.asarray(jo)),
                        torch.tensor(np.asarray(jlse)),
                        torch.tensor(np.asarray(jdo)), window)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=5e-5,
                                   rtol=5e-5)


@pytest.mark.parametrize("b,s,h,kv,dh,window", [
    (1, 24, 6, 1, 16, None),     # MQA
    (2, 20, 6, 2, 8, 5),         # GQA, sliding window
])
def test_flash_attention_gqa_grads_match_reference(b, s, h, kv, dh, window):
    q, k, v = _qkv(10, b, s, h, kv, dh)
    dout = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda *a: (jref.attention(*a, window) * dout).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (ops.flash_attention(tq, tk, tv, window) * torch.tensor(dout)).sum().backward()
    for a, c in zip(want, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("dh", [64, 128, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,window", [(200, None), (200, 37), (64, 1),
                                      (200, 65), (200, 66), (200, 33),
                                      (4096, 500)])
def test_bwd_launch_covers_every_visible_pair_once(dh, dtype, s, window):
    """The dK/dV blocks and the query tiles each visits (``q_tile_range``)
    cover every visible (query, key) pair exactly once and visit only tiles
    holding one, and the head split (``dkv_heads``) gives every query head
    of a KV head's group to exactly one block of each key tile; the dQ
    blocks cover every row once, visit only open KV tiles, and so every
    visible pair once."""
    b, h, kvh = 2, 12, 2
    g = h // kvh
    dkv = fk.bwd_launch_config("dkv", b, s, s, h, kvh, dh, dtype)
    dq = fk.bwd_launch_config("dq", b, s, s, h, kvh, dh, dtype)
    assert max(dkv.smem_bytes, dq.smem_bytes) <= fk.SMEM_LIMIT
    if dtype == torch.bfloat16:      # 128 query rows, two 64-row consumers
        assert dq.block_rows == 128 and dq.tile == fk.DQ_KTILE[dh]
        assert dq.smem_bytes == (2 * 2 * 128 * dh + fk.DQ_STAGES * 2 * 2
                                 * dq.tile * dh + fk.SMEM_EXTRA)
    assert dkv.grid == (b * kvh * dkv.gsplit, -(-s // dkv.block_rows))
    assert dq.grid == (-(-s // dq.block_rows), b * h)
    assert g % dkv.gsplit == 0
    if dtype == torch.bfloat16:     # the smallest split that fills the card
        assert dkv.grid[0] * dkv.grid[1] >= fk.DKV_MIN_BLOCKS \
            or dkv.gsplit == g
        assert all(b * kvh * d * dkv.grid[1] < fk.DKV_MIN_BLOCKS
                   for d in range(1, dkv.gsplit) if g % d == 0)
    else:
        assert dkv.gsplit == 1
    # block x = (batch * KV + kv head) * gsplit + split
    heads = torch.zeros(b, h, dtype=torch.int32)
    for x in range(dkv.grid[0]):
        gs, bkv = x % dkv.gsplit, x // dkv.gsplit
        for hh in fk.dkv_heads(bkv % kvh, gs, g, dkv.gsplit):
            assert hh // g == bkv % kvh
            heads[bkv // kvh, hh] += 1
    assert bool((heads == 1).all())
    ok = ref.causal_ok(s, s, window, "cpu")
    seen = torch.zeros(s, s, dtype=torch.int32)
    for kt in range(dkv.grid[1]):
        k0, k1 = kt * dkv.block_rows, min(s, (kt + 1) * dkv.block_rows)
        lo, hi = fk.q_tile_range(k0, k1, s, window, dkv.tile)
        for qt in range(lo, hi):
            q0, q1 = qt * dkv.tile, min(s, (qt + 1) * dkv.tile)
            assert bool(ok[q0:q1, k0:k1].any())          # an open tile
            seen[q0:q1, k0:k1] += 1
    assert bool((seen[ok] == 1).all())
    rows = torch.zeros(s, dtype=torch.int32)
    seen_q = torch.zeros(s, s, dtype=torch.int32)
    for i in range(dq.grid[0]):
        q0, q1 = i * dq.block_rows, min(s, (i + 1) * dq.block_rows)
        rows[q0:q1] += 1
        lo, hi = fk.kv_tile_range(q0, q1, s, window, dq.tile)
        open_tiles = {kt for kt in range(-(-s // dq.tile))
                      if bool(ok[q0:q1, kt * dq.tile:(kt + 1) * dq.tile].any())}
        assert set(range(lo, hi)) == open_tiles
        for kt in range(lo, hi):
            seen_q[q0:q1, kt * dq.tile:(kt + 1) * dq.tile] += 1
    assert bool((rows == 1).all())
    assert bool((seen_q[ok] == 1).all())


def test_bwd_launch_config_rejects_what_has_no_kernel():
    with pytest.raises(ValueError):
        fk.bwd_launch_config("dkv", 1, 8, 8, 1, 1, 96, torch.bfloat16)
    with pytest.raises(TypeError):
        fk.bwd_launch_config("dq", 1, 8, 8, 1, 1, 64, torch.float16)


def _tiled_bwd_bf16(q, k, v, dout, window, drop=None):
    """The CUDA kernels' bf16 arithmetic, tile by tile in plain torch, in the
    model layout, at the kernels' tiles (``bwd_launch_config``): dK/dV per
    key block and head split over the split's heads (``dkv_heads``) and the
    query tiles ``q_tile_range`` gives, masked only in the 64-key consumer
    halves ``tile_needs_mask`` names, p and ds rounded to bf16 for the products, f32
    sums; the splits' f32 partials summed in split order and rounded once.
    dQ per 128-query block over the key tiles ``kv_tile_range`` gives, masked
    only in the 64-row consumer halves ``tile_needs_mask`` names, ds rounded
    to bf16. ``drop`` plants a kernel fault:
    ``("q_tile", kt, qt)`` leaves a query tile out of key tile kt's sum,
    ``("head", g)`` a GQA head out of every dK/dV sum, ``("split", gs)``
    head split gs's partial out of the final sum, ``("kv_tile", kt)`` a KV
    tile out of the last query tile's dQ sum."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sc = dh ** -0.5
    ok = ref.causal_ok(s, s, window, "cpu")
    qk, kk, vk = ops._to_kernel_layout(q, k, v)
    dok = dout.transpose(1, 2).reshape(b * h, s, dh)
    o, lse = ref.flash_fwd(qk, kk, vk, window)
    delta = (dok.float() * o.float()).sum(-1)
    qk, kk, vk, dok = (x.float() for x in (qk, kk, vk, dok))

    def tile(n, q0, q1, k0, k1, masked=True):
        st = qk[n, q0:q1] @ kk[n, k0:k1].T * sc
        p = torch.exp(st - lse[n, q0:q1, None])
        if masked:
            p = torch.where(ok[q0:q1, k0:k1], p, 0.0)
        dp = dok[n, q0:q1] @ vk[n, k0:k1].T
        return p, p * (dp - delta[n, q0:q1, None]) * sc

    cfg = fk.bwd_launch_config("dkv", b, s, s, h, kvh, dh, torch.bfloat16)
    bk, bq = cfg.block_rows, cfg.tile
    part = torch.zeros(2, cfg.gsplit, b, s, kvh, dh)
    for bi in range(b):
        for kh in range(kvh):
            for gs in range(cfg.gsplit):
                for k0 in range(0, s, bk):
                    k1 = min(s, k0 + bk)
                    lo, hi = fk.q_tile_range(k0, k1, s, window, bq)
                    for hh in fk.dkv_heads(kh, gs, g, cfg.gsplit):
                        if drop == ("head", hh % g):
                            continue
                        n = bi * h + hh
                        for qt in range(lo, hi):
                            if drop == ("q_tile", k0 // bk, qt):
                                continue
                            q0, q1 = qt * bq, min(s, qt * bq + bq)
                            for c0 in range(k0, k1, 64):      # consumer halves
                                c1 = min(s, c0 + 64)
                                masked = fk.tile_needs_mask(
                                    q0, q0 + bq, c0, c0 + 64, s, window) \
                                    or q0 + bq > s
                                p, ds = tile(n, q0, q1, c0, c1, masked)
                                part[1, gs, bi, c0:c1, kh] += \
                                    p.bfloat16().float().T @ dok[n, q0:q1]
                                part[0, gs, bi, c0:c1, kh] += \
                                    ds.bfloat16().float().T @ qk[n, q0:q1]
    dk = torch.zeros(b, s, kvh, dh)
    dv = torch.zeros(b, s, kvh, dh)
    for gs in range(cfg.gsplit):
        if drop != ("split", gs):
            dk += part[0, gs]
            dv += part[1, gs]
    cq = fk.bwd_launch_config("dq", b, s, s, h, kvh, dh, torch.bfloat16)
    dq = torch.zeros(b * h, s, dh)
    for n in range(b * h):
        for q0 in range(0, s, cq.block_rows):
            q1 = min(s, q0 + cq.block_rows)
            lo, hi = fk.kv_tile_range(q0, q1, s, window, cq.tile)
            for kt in range(lo, hi):
                if q1 == s and drop == ("kv_tile", kt):
                    continue
                k0, k1 = kt * cq.tile, min(s, kt * cq.tile + cq.tile)
                for r0 in range(q0, q1, 64):                  # consumer halves
                    r1 = min(s, r0 + 64)
                    masked = fk.tile_needs_mask(r0, r0 + 64, k0, kt * cq.tile
                                                + cq.tile, s, window)
                    _, ds = tile(n, r0, r1, k0, k1, masked)
                    dq[n, r0:r1] += ds.bfloat16().float() @ kk[n, k0:k1]
    dq = ops._from_kernel_layout(dq, b, s, h, dh)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("s,window,drop", [
    (256, None, None), (250, 70, None),           # the kernels' own rounding
    (256, None, ("q_tile", 0, 2)),                # a query tile out of dK/dV
    (256, None, ("head", 2)),                     # a GQA head out of dK/dV
    (256, None, ("split", 1)),                    # a head split's partial left out
    (250, 70, ("kv_tile", 1)),                    # a KV tile out of dQ
])
def test_bf16_grad_tolerance_admits_rounding_and_catches_a_lost_term(
        s, window, drop):
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in _qkv(12, 1, s, 6, 2, 128))
    dout = torch.tensor(np.random.default_rng(13).standard_normal(
        q.shape).astype(np.float32)).to(torch.bfloat16)
    got = _tiled_bwd_bf16(q, k, v, dout, window, drop)
    want = _f32_grads_and_tolerances(q, k, v, dout, window)
    over = [(x.float() - r).abs() > tol for x, (r, tol) in zip(got, want)]
    if drop is None:
        assert not any(bool(o.any()) for o in over)
    elif drop[0] == "q_tile":          # keys 0..127 lose queries 128..191
        assert not bool(over[0].any())
        for o in over[1:]:
            assert float(o[:, :128].float().mean()) > 0.5
            assert not bool(o[:, 128:].any())
    elif drop[0] in ("head", "split"):
        assert not bool(over[0].any())
        assert all(float(o.float().mean()) > 0.5 for o in over[1:])
    else:                              # the last query tile of dQ: 128..249
        assert float(over[0][:, 128:].float().mean()) > 0.5
        assert not bool(over[0][:, :128].any())
        assert not bool(over[1].any()) and not bool(over[2].any())
