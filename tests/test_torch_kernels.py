"""The port's kernel packages against the JAX reference, on the same numpy
inputs.

Tolerances: f32 products ``atol = rtol = 1e-5`` — the two packages sum the
same terms in different orders, so only the last bits may differ. bf16
``5e-2``, the reference's own kernel-test tolerance: both round the f32 sum
to an 8-bit mantissa. ``wu_outer`` f32 ``1e-5`` (batch sums of up to 16
terms in another order), also with the add into the weights fused in
(``wu_outer_apply``). ``make_compact`` ids, ``wu_outer_slots`` and the
in-place ``wu_outer_slots_update`` must be bitwise equal: a stable argsort and elementwise products in one fixed
association leave nothing to round differently. The LIF step in f32:
``1e-4``, the reference's kernel-sweep tolerance (only an FMA contraction
may differ); in bf16 ``5e-2``: XLA keeps the fused intermediates in f32
while torch rounds every operation to bf16, one bf16 ulp apart at
``|v| <= 4``.

The fused base + per-row delta product (``ref.nm_spmm_fused``) against
the reference's ``nm_spmm_batched + nm_spmm_deltas``: f32 ``rtol 1e-5, atol
1e-6`` (sums of the same terms in another order). Launch geometry is exact.
The hand-written kernels meet their plain versions on the card in
``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro.kernels.lif import ops as jlif_ops
from repro.kernels.nm_spmm import ops as jnm_ops, ref as jnm_ref
from repro.kernels.nm_spmm.kernel import nm_spmm_pallas
from repro.kernels.wu_outer import ref as jwu_ref
from repro.kernels.wu_outer.kernel import wu_outer_pallas
from repro_torch.kernels.lif import ops as lif_ops, ref as lif_ref
from repro_torch.kernels.nm_spmm import kernel as nm_kernel
from repro_torch.kernels.nm_spmm import ops as nm_ops, ref as nm_ref
from repro_torch.kernels.wu_outer import kernel as wu_kernel
from repro_torch.kernels.wu_outer import ops as wu_ops, ref as wu_ref
from test_kernels import NM_CASES

torch.set_num_threads(1)

TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _sparse_case(seed, k, o, bk, bo, n, m, b=16, spikes=False):
    """Mask from the reference's sampler, weights and x from numpy; both
    packages compact the same dense weights."""
    spec = jsp.NMSpec(n=n, m=m, block=bk, out_tile=bo)
    mask = np.asarray(jsp.random_unit_mask(jax.random.PRNGKey(seed), spec,
                                           k, o))
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, o)).astype(np.float32)
    x = ((rng.random((b, k)) < 0.2) if spikes
         else rng.standard_normal((b, k))).astype(np.float32)
    return x, w, mask


@pytest.mark.parametrize("k,o,bk,bo,n,m,bm", NM_CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_nm_spmm_matches_pallas_interpret(k, o, bk, bo, n, m, bm, dtype):
    x, w, mask = _sparse_case(0, k, o, bk, bo, n, m)
    wc_j, idx_j = jnm_ops.make_compact(jnp.asarray(w), jnp.asarray(mask), bk, bo)
    wc_t, idx_t = nm_ops.make_compact(_t(w), torch.tensor(mask), bk, bo)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(wc_t.numpy(), np.asarray(wc_j))
    y_j = nm_spmm_pallas(jnp.asarray(x, dtype), wc_j.astype(dtype), idx_j,
                         bm=bm, interpret=True)
    tdt = TORCH_DT[dtype]
    y_t = nm_ops.nm_spmm_batched(_t(x, tdt), wc_t.to(tdt), idx_t)
    tol = 1e-5 if dtype == jnp.float32 else 5e-2
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), atol=tol, rtol=tol)
    np.testing.assert_array_equal(
        nm_ref.densify(wc_t, idx_t, k).numpy(),
        np.asarray(jnm_ref.densify(wc_j, idx_j, k)))


def test_nm_spmm_paper_shape_matches_jnp_ref():
    """K = J = 512, T = 104, bk = bo = 1 (the serving path's shape), B=16
    spike rows, against the jnp oracle (interpret mode would walk 53k grid
    steps per row tile here)."""
    spec_t = jsp.paper_spec_4groups(512, 0.8)
    x, w, mask = _sparse_case(3, 512, 512, 1, 1, spec_t.n, spec_t.m,
                              spikes=True)
    wc_j, idx_j = jnm_ops.make_compact(jnp.asarray(w), jnp.asarray(mask), 1, 1)
    wc_t, idx_t = nm_ops.make_compact(_t(w), torch.tensor(mask), 1, 1,
                                      n_kept=104)
    assert tuple(idx_t.shape) == (512, 104) and idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    y_j = jnm_ref.nm_spmm(jnp.asarray(x), wc_j, idx_j)
    y_t = nm_ops.nm_spmm_batched(_t(x), wc_t, idx_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)


def test_nm_spmm_autograd_matches_reference_custom_vjp():
    x, w, mask = _sparse_case(1, 64, 32, 8, 16, 1, 2)
    dy = np.random.default_rng(7).standard_normal((16, 32)).astype(np.float32)
    wc_j, idx_j = jnm_ops.make_compact(jnp.asarray(w), jnp.asarray(mask), 8, 16)
    gx_j, gw_j = jax.grad(lambda a, b: (jnm_ops.nm_spmm(a, b, idx_j) * dy).sum(),
                          argnums=(0, 1))(jnp.asarray(x), wc_j)
    wc_t, idx_t = nm_ops.make_compact(_t(w), torch.tensor(mask), 8, 16)
    xt = _t(x).requires_grad_()
    wt = wc_t.clone().requires_grad_()
    (nm_ops.nm_spmm(xt, wt, idx_t) * _t(dy)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 128), (16, 256), (8, 250), (5, 64)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lif_matches_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(0)
    v = rng.standard_normal(shape)
    tr = rng.random(shape)
    cur = rng.standard_normal(shape)
    kw = dict(alpha=0.9, beta=0.85, theta=1.0)
    want = jlif_ops.lif_step(*(jnp.asarray(a, dtype) for a in (v, tr, cur)),
                             force_pallas=True, interpret=True, **kw)
    ins = [_t(a, TORCH_DT[dtype]) for a in (v, tr, cur)]
    got = lif_ops.lif_step(*ins, **kw)
    # a spike may flip only where the pre-reset membrane sits within
    # rounding of the threshold (one bf16 ulp is 2**-7 at 1.0)
    v_pre = kw["alpha"] * ins[0].float() + ins[2].float()
    near = (v_pre - kw["theta"]).abs().numpy() < 1e-2
    flips = got[2].float().numpy() != np.asarray(want[2], np.float32)
    assert not (flips & ~near).any()
    for g, w_ in zip(got, want):
        assert g.shape == tuple(shape) and g.dtype == TORCH_DT[dtype]
        np.testing.assert_allclose(g.float().numpy()[~flips],
                                   np.asarray(w_, np.float32)[~flips],
                                   atol=1e-4 if dtype == jnp.float32 else 5e-2)


def _wu_case(seed, s, k, o, bk, bo):
    spec = jsp.NMSpec(n=1, m=2, block=bk, out_tile=bo)
    mask = jsp.random_unit_mask(jax.random.PRNGKey(seed), spec, k, o)
    _, idx = jnm_ops.make_compact(jnp.zeros((k, o)), mask, bk, bo)
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal((s, k)).astype(np.float32)
    mod = rng.standard_normal((s, o)).astype(np.float32)
    scale = np.where(rng.random(s) < 0.5, 0.02, 0.0).astype(np.float32)
    return pre, mod, np.asarray(idx), scale


@pytest.mark.parametrize("s,k,o,bk,bo", [(4, 16, 16, 1, 1), (8, 32, 16, 4, 8),
                                         (3, 64, 32, 8, 16)])
def test_wu_outer_slots_bitwise_equal_to_reference(s, k, o, bk, bo):
    pre, mod, idx, scale = _wu_case(2, s, k, o, bk, bo)
    want = jwu_ref.wu_outer_slots(jnp.asarray(pre), jnp.asarray(mod),
                                  jnp.asarray(idx), jnp.asarray(scale), bk, bo)
    got = wu_ops.wu_outer_slots(_t(pre), _t(mod), torch.tensor(idx),
                                _t(scale), bk=bk, bo=bo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,k,o,bk,bo", [(4, 16, 16, 1, 1), (8, 32, 16, 4, 8),
                                         (3, 64, 32, 8, 16)])
def test_wu_outer_slots_update_bitwise_through_a_slot_strided_view(s, k, o, bk,
                                                                     bo):
    """The in-place op on one layer of slot-leading ``[S, L, ...]`` deltas
    (slots ``L·J·T·bk·bo`` elements apart) equals the reference's ``delta +
    wu_outer_slots`` bit for bit, with some slots closed; the other layers
    are untouched."""
    pre, mod, idx, scale = _wu_case(3, s, k, o, bk, bo)
    scale[0], scale[-1] = 0.0, 0.02          # at least one closed, one open
    j, t = idx.shape
    rng = np.random.default_rng(3)
    big = (0.01 * rng.standard_normal((s, 3, j, t, bk, bo))).astype(np.float32)
    want = big[:, 1] + np.asarray(jwu_ref.wu_outer_slots(
        jnp.asarray(pre), jnp.asarray(mod), jnp.asarray(idx),
        jnp.asarray(scale), bk, bo))
    deltas = torch.tensor(big)
    view = deltas[:, 1]
    assert view.stride(0) == 3 * j * t * bk * bo
    got = wu_ops.wu_outer_slots_update(view, _t(pre), _t(mod),
                                       torch.tensor(idx), _t(scale), bk=bk,
                                       bo=bo)
    assert got.data_ptr() == view.data_ptr()
    np.testing.assert_array_equal(deltas[:, 1].numpy(), want)
    np.testing.assert_array_equal(deltas[:, 0].numpy(), big[:, 0])
    np.testing.assert_array_equal(deltas[:, 2].numpy(), big[:, 2])
    np.testing.assert_array_equal(deltas[0, 1].numpy(), big[0, 1])   # closed


def test_wu_outer_batch_summed_matches_reference():
    pre, mod, idx, _ = _wu_case(4, 8, 32, 16, 4, 8)
    want = jwu_ref.wu_outer(jnp.asarray(pre), jnp.asarray(mod),
                            jnp.asarray(idx), jnp.float32(0.05), 4, 8)
    got = wu_ref.wu_outer(_t(pre), _t(mod), torch.tensor(idx),
                          torch.tensor(0.05), 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# the reference's wu_outer kernel sweep (tests/test_kernels.py)
WU_CASES = [(8, 32, 16, 4, 8, 4), (16, 64, 32, 8, 16, 8), (4, 16, 8, 4, 8, 4)]


@pytest.mark.parametrize("b,k,o,bk,bo,bb", WU_CASES)
def test_wu_outer_matches_pallas_interpret(b, k, o, bk, bo, bb):
    pre, mod, idx, _ = _wu_case(5, b, k, o, bk, bo)
    want = wu_outer_pallas(jnp.asarray(pre), jnp.asarray(mod), jnp.asarray(idx),
                           jnp.float32(0.05), bk=bk, bo=bo, bb=bb,
                           interpret=True)
    got = wu_ops.wu_outer(_t(pre), _t(mod), torch.tensor(idx), 0.05, bk=bk,
                          bo=bo)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_wu_outer_paper_shape_matches_jnp_ref():
    """B = 16, K = N = 512, T = 104, bk = bo = 1: the training path's shape,
    against the jnp oracle (interpret mode would walk 53k grid steps)."""
    spec = jsp.paper_spec_4groups(512, 0.8)
    x, _, mask = _sparse_case(6, 512, 512, 1, 1, spec.n, spec.m, spikes=True)
    _, idx = jnm_ops.make_compact(jnp.zeros((512, 512)), jnp.asarray(mask), 1, 1)
    mod = np.random.default_rng(6).standard_normal((16, 512)).astype(np.float32)
    want = jwu_ref.wu_outer(jnp.asarray(x), jnp.asarray(mod), idx,
                            jnp.float32(0.02 / 16), 1, 1)
    got = wu_ops.wu_outer(_t(x), _t(mod), torch.tensor(np.asarray(idx)),
                          torch.tensor(0.02 / 16), bk=1, bo=1)
    assert tuple(got.shape) == (512, 104, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_wu_outer_apply_paper_shape_matches_reference():
    """The training path's update with the add into the compact weights
    (``ops.wu_outer_apply``) against the reference's ``wc + wu_outer`` at B
    = 16, K = N = 512, T = 104: ``atol = rtol = 1e-5`` (the batch sum of 16
    terms in another order; the add rounds alike). A closed gate returns
    ``wc`` itself, bit for bit, in a fresh tensor."""
    spec = jsp.paper_spec_4groups(512, 0.8)
    x, w, mask = _sparse_case(9, 512, 512, 1, 1, spec.n, spec.m, spikes=True)
    wc, idx = jnm_ops.make_compact(jnp.asarray(w), jnp.asarray(mask), 1, 1)
    mod = np.random.default_rng(9).standard_normal((16, 512)).astype(np.float32)
    lr = jnp.float32(0.02 / 16)
    want = wc + jwu_ref.wu_outer(jnp.asarray(x), jnp.asarray(mod), idx, lr, 1, 1)
    wct = _t(wc)
    got = wu_ops.wu_outer_apply(wct, _t(x), _t(mod),
                                torch.tensor(np.asarray(idx)),
                                torch.tensor(0.02 / 16), bk=1, bo=1)
    assert tuple(got.shape) == (512, 104, 1, 1)
    assert not bool((got == wct).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    closed = wu_ops.wu_outer_apply(wct, _t(x), _t(mod),
                                   torch.tensor(np.asarray(idx)), 0.0, bk=1,
                                   bo=1)
    assert closed.data_ptr() != wct.data_ptr() and torch.equal(closed, wct)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wu_outer_closed_gate_is_exactly_zero(dtype):
    pre, mod, idx, _ = _wu_case(7, 8, 32, 16, 4, 8)
    got = wu_ops.wu_outer(_t(pre, dtype), _t(mod, dtype), torch.tensor(idx),
                          torch.tensor(0.0), bk=4, bo=8)
    assert got.dtype == dtype and bool((got == 0).all())


@pytest.mark.parametrize("b,k,j,t,bk,bo,esize", [
    (16, 512, 512, 104, 1, 1, 4),    # the training path (paper spec)
    (16, 512, 512, 104, 1, 1, 2),    # same, bf16
    (128, 512, 16, 8, 16, 32, 4),    # tiled spec
    (13, 512, 512, 104, 1, 1, 4),    # ragged batch
    (4, 16, 1, 2, 4, 8, 4),          # fewer elements than one block
    (64, 4096, 4, 8, 64, 128, 4),    # a kept block spans several blocks
    (1000, 30000, 8, 4, 1, 1, 4),    # must shrink the row chunk to fit
])
def test_wu_outer_launch_config_covers_every_output_within_shared_memory(
        b, k, j, t, bk, bo, esize):
    cfg = wu_kernel.launch_config(b, k, j, t, bk, bo, esize)
    e = wu_kernel.ELEMS_PER_BLOCK
    total = j * t * bk * bo
    assert cfg.nblocks * e >= total > (cfg.nblocks - 1) * e
    assert cfg.smem_bytes <= wu_kernel.SMEM_LIMIT
    assert 1 <= cfg.bc <= min(b, wu_kernel.ROW_TARGET) or b == 0
    # every block's out tiles fit the staged mod columns
    per_tile = t * bk * bo
    for blk in range(cfg.nblocks):
        lo = blk * e // per_tile
        hi = min(total, (blk + 1) * e) - 1
        assert (hi // per_tile - lo + 1) * bo <= cfg.mw


@pytest.mark.parametrize("b,k,j,t", [
    (16, 512, 512, 104),     # the training path (paper spec)
    (13, 512, 512, 104),     # ragged batch
    (1, 16, 1, 1),           # one output
    (64, 48, 5, 128),        # two row chunks, a full pass of t
    (16, 48, 7, 129),        # a second pass of t
    (16, 512, 512, 1024),    # eight passes
    (16, 30000, 4, 8),       # must shrink the row chunk to fit
])
def test_wu_outer_gather_launch_config_covers_every_output_once(b, k, j, t):
    """A warp per output neuron, its lanes on t: every (j, t) is owned by
    exactly one (block, warp, pass, lane, position); the staged rows of pre
    fit one block's shared memory."""
    assert wu_kernel.takes_gather_kernel(1, 1)
    assert not wu_kernel.takes_gather_kernel(4, 8)
    cfg = wu_kernel.gather_launch_config(b, k, j, t)
    assert 1 <= cfg.bc <= min(b, wu_kernel.ROW_TARGET)
    assert cfg.smem_bytes <= wu_kernel.SMEM_LIMIT
    assert cfg.smem_bytes >= 4 * cfg.bc * (k + wu_kernel.GATHER_WARPS)
    w, tpl = wu_kernel.GATHER_WARPS, wu_kernel.GATHER_T_PER_LANE
    assert cfg.threads == 32 * w
    assert cfg.nblocks * w >= j > (cfg.nblocks - 1) * w
    assert cfg.passes * 32 * tpl >= t > (cfg.passes - 1) * 32 * tpl
    seen = np.zeros(t, np.int64)
    for p in range(cfg.passes):
        for lane in range(32):
            for i in range(tpl):
                tt = p * 32 * tpl + lane + 32 * i
                if tt < t:
                    seen[tt] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("s,j,t,bk,bo,aligned,vec", [
    (1024, 512, 104, 1, 1, True, 4),     # the serving path (paper spec)
    (1024, 512, 104, 1, 1, False, 1),    # misaligned: scalar vectors
    (9, 6, 6, 1, 1, True, 1),            # T not a multiple of 4
    (37, 6, 8, 4, 8, True, 4),           # tiled spec
    (3, 5, 3, 1, 3, True, 1),            # rows of 9 elements
    (70000, 2, 4, 1, 1, True, 4),        # more slots than a grid column
    (0, 512, 104, 1, 1, True, 4),        # no slots: an empty grid
])
def test_wu_outer_slots_launch_config_covers_every_element_once(
        s, j, t, bk, bo, aligned, vec):
    cfg = wu_kernel.slots_launch_config(s, j, t, bk, bo, aligned)
    assert cfg.vec == vec
    gx, gy = cfg.grid
    per_block = wu_kernel.SLOT_THREADS * wu_kernel.SLOT_VECTORS
    nvec = j * t * bk * bo // vec
    assert gx * per_block >= nvec > (gx - 1) * per_block
    assert gy == min(s, wu_kernel.MAX_GRID_Y)
    # a column of blocks walks slots y, y + gy, ...: every slot once
    walked = sorted(sl for y in range(gy) for sl in range(y, s, gy))
    assert walked == list(range(s))


def test_wu_outer_launch_config_rejects_shapes_that_cannot_fit():
    with pytest.raises(ValueError):
        wu_kernel.launch_config(16, 1 << 17, 4, 4, 1, 1, 4)
    with pytest.raises(ValueError):
        wu_kernel.gather_launch_config(16, 1 << 16, 4, 4)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("b,k,j,t,bk,bo,esize", [
    (1024, 512, 512, 104, 1, 1, 4),  # the serving path (paper spec)
    (16, 512, 512, 104, 1, 1, 4),    # the SNN training path
    (1000, 512, 512, 104, 1, 1, 2),  # ragged slots, bf16
    (1, 512, 512, 104, 1, 1, 4),     # one slot
    (37, 48, 6, 8, 1, 1, 4),         # few columns
    (37, 48, 6, 6, 1, 1, 4),         # T not a multiple of 4
    (37, 50, 6, 6, 1, 1, 4),         # K not a multiple of 4: the tiled kernel
    (1024, 4096, 8, 1024, 1, 1, 4),  # wide fan-in, must shrink rows to fit
    (16, 512, 16, 8, 16, 32, 2),     # tiled regime, bf16
    (16, 48, 6, 6, 4, 8, 4),         # NM_CASES: bo below the column target
    (16, 512, 4, 8, 16, 96, 4),      # bo above the target, not a multiple
    (16, 2048, 8, 1024, 1, 128, 4),  # must shrink the column group to fit
])
def test_launch_config_covers_every_column_within_shared_memory(
        b, k, j, t, bk, bo, esize, fused):
    """The gather kernel (bk = bo = 1; base, or fused with the deltas)
    covers every (row, column) once; the tiled kernel every column once,
    with its rows masked in the kernel."""
    cfg = nm_kernel.launch_config(b, k, j, t, bk, bo, esize, fused)
    assert cfg.smem_bytes <= nm_kernel.SMEM_LIMIT
    if not nm_kernel.takes_gather_kernel(k, bk, bo):
        assert isinstance(cfg, nm_kernel.TiledConfig)
        assert cfg.bn == cfg.jg * cfg.bnc <= nm_kernel.COLUMN_TARGET
        assert cfg.jg == 1 or cfg.bnc == bo   # whole tiles, or a tile slice
        assert bo % cfg.bnc == 0
        assert cfg.ngroups * cfg.bn >= j * bo > (cfg.ngroups - 1) * cfg.bn
        return
    bm, bn = cfg.block_rows, cfg.block_cols
    assert 4 <= bm <= 32                      # 4 rows a lane, up to 8 lanes ...
    assert cfg.lanes_per_col <= 32            # ... times 4 t-chunk lanes: one warp
    assert bm & (bm - 1) == 0 and bn & (bn - 1) == 0     # shifts, no divides
    assert cfg.threads in nm_kernel.ELL_THREADS
    assert cfg.threads == nm_kernel.ELL_THREADS[0] or not fused
    groups = cfg.threads // cfg.lanes_per_col
    assert bn <= nm_kernel.ELL_MAX_PASSES * groups
    assert cfg.smem_bytes == 4 * (k * bm + bm * (bn + 1))
    seen = torch.zeros(b, j, dtype=torch.int32)
    for gx in range(cfg.grid[0]):
        for gy in range(cfg.grid[1]):
            seen[gy * bm:(gy + 1) * bm, gx * bn:(gx + 1) * bn] += 1
    assert bool((seen == 1).all())
    assert cfg.grid[0] * bn < j + bn and cfg.grid[1] * bm < b + bm


@pytest.mark.parametrize("b,fused", [(16, False), (1024, False), (1024, True)])
def test_launch_config_fills_the_card_at_the_paper_shape(b, fused):
    """At the SNN training batch (16) and the serving grid (1024 slots) the
    gather kernel's grid gives all but a few of the card's 132 SMs a block
    (the old kernel gave 8 blocks at B = 16), with the widest column groups
    that do so: one step wider would leave a quarter of the card idle."""
    cfg = nm_kernel.launch_config(b, 512, 512, 104, 1, 1, 4, fused)
    blocks = cfg.grid[0] * cfg.grid[1]
    assert nm_kernel.ELL_MIN_BLOCKS <= blocks <= nm_kernel.NUM_SMS
    assert nm_kernel.NUM_SMS - blocks <= nm_kernel.NUM_SMS // 32
    assert cfg.grid[1] * -(-512 // (2 * cfg.block_cols)) < nm_kernel.ELL_MIN_BLOCKS


def test_launch_config_rejects_shapes_that_cannot_fit():
    with pytest.raises(ValueError):
        nm_kernel.launch_config(16, 1 << 16, 4, 4, 1, 1, 4)
    with pytest.raises(ValueError):
        nm_kernel.launch_config(16, 1 << 16, 4, 4, 2, 1, 4)


@pytest.mark.parametrize("s,k,o,bk,bo,n,m", [
    (16, 512, 512, 1, 1, 26, 128),    # the serving path's layer (paper spec)
    (13, 64, 32, 1, 1, 4, 16),        # ragged slot count
    (5, 64, 32, 8, 16, 1, 2),         # tiled
    (7, 48, 24, 4, 8, 3, 4),          # tiled, ragged
])
def test_nm_spmm_fused_matches_reference_base_plus_deltas(s, k, o, bk, bo, n, m):
    x, w, mask = _sparse_case(5, k, o, bk, bo, n, m, b=s, spikes=True)
    wc_j, idx_j = jnm_ops.make_compact(jnp.asarray(w), jnp.asarray(mask), bk, bo)
    delta = 0.05 * np.random.default_rng(6).standard_normal(
        (s, *wc_j.shape)).astype(np.float32)
    want = (jnm_ops.nm_spmm_batched(jnp.asarray(x), wc_j, idx_j)
            + jnm_ops.nm_spmm_deltas(jnp.asarray(x), jnp.asarray(delta), idx_j))
    wc_t, idx_t = nm_ops.make_compact(_t(w), torch.tensor(mask), bk, bo)
    got = nm_ops.nm_spmm_fused(_t(x), wc_t, idx_t, _t(delta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the association the kernel keeps: base + delta product
    assert torch.equal(got, nm_ref.nm_spmm(_t(x), wc_t, idx_t)
                       + nm_ref.nm_spmm_deltas(_t(x), _t(delta), idx_t))
