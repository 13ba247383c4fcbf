"""The port's hand-written kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips where there is none. The file
imports neither ``jax`` nor ``repro``, so the machine with the card runs it
as it is::

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax). ``chip_smoke.py``
runs it so, as a phase whose failure fails the run.

Tolerances: f32 ``1e-5`` on small shapes and ``1e-4`` at the paper shape
(104-term sums in another order than the plain einsum); bf16 ``5e-2`` for
``nm_spmm`` (both round the f32 sum to an 8-bit mantissa) and ``2e-2`` for
``wu_outer`` (the plain version rounds twice, the kernel once), with or
without the add into the weights; the per-slot ``wu_outer_slots`` update
in place bit for bit (the kernel rounds as the plain version does); the LIF step
``1e-5`` (the kernel may fuse ``αv + I`` into one FMA); flash attention per
element within ``ref.bf16_out_tolerance`` / ``ref.bf16_grad_tolerance``
(bf16) or ``1e-5`` / ``1e-4`` of the largest element (f32). A row of
``nm_spmm`` computed alone and in a batch must agree bit for bit. The MoE
layer (no kernel of its own: ``torch.bmm`` over the dispatch buffer) on
the card against the CPU in f32: slots equal, output within ``1e-5``; a
reduced MoE training step's gradients equal bit for bit across two calls.
The slot-sharded chunk step and fleet on four mesh entries of the card
against the 1-device ones, bit for bit, at 64, 2 and 1 slots a shard. The
data-parallel LM step over a one-rank NCCL group against the plain step,
bit for bit. The MoE family data-parallel (two gloo ranks on the card):
the DP gradients bit for bit the mean of the 1-process halves', ZeRO-1
and its remeshed moments bit for bit, expert parallelism within ``1e-5``
/ ``1e-4`` of the 1-process layer, the compressed mean bit for bit the
host's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sparsity import NMSpec, paper_spec_4groups, random_unit_mask
from repro_torch.kernels.flash_attn import kernel as fk
from repro_torch.kernels.flash_attn import ops as fops, ref as fref
from repro_torch.kernels.lif import ops as lif_ops, ref as lif_ref
from repro_torch.kernels.nm_spmm import kernel as nm_kernel
from repro_torch.kernels.nm_spmm import ops as nm_ops, ref as nm_ref
from repro_torch.kernels.wu_outer import kernel as wu_kernel
from repro_torch.kernels.wu_outer import ops as wu_ops, ref as wu_ref

# the reference's kernel sweep (tests/test_kernels.py): (k, o, bk, bo, n, m, bm)
NM_CASES = [(32, 16, 4, 8, 2, 4, 8),
            (64, 32, 8, 16, 1, 2, 16),
            (128, 128, 16, 32, 2, 8, 8),
            (48, 24, 4, 8, 3, 4, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sparse_case(seed, k, o, spec, b, spikes=False):
    """A compact weight rep from the port's mask sampler and numpy x."""
    mask = random_unit_mask(torch.Generator().manual_seed(seed), spec, k, o)
    rng = np.random.default_rng(seed)
    w = torch.tensor(rng.standard_normal((k, o)).astype(np.float32))
    x = ((rng.random((b, k)) < 0.2) if spikes
         else rng.standard_normal((b, k))).astype(np.float32)
    wc, idx = nm_ops.make_compact(w, mask, spec.block, spec.out_tile)
    return torch.tensor(x), wc, idx


# ----------------------------------------------------------------- nm_spmm

@pytest.mark.cuda
@pytest.mark.parametrize("k,o,bk,bo,n,m,bm", NM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_spmm_kernel_matches_plain_on_card(cuda, k, o, bk, bo, n, m, bm,
                                              dtype):
    x, wc, idx = _sparse_case(0, k, o, NMSpec(n=n, m=m, block=bk, out_tile=bo),
                              b=37)                            # ragged rows
    x, wc, idx = x.to(cuda, dtype), wc.to(cuda, dtype), idx.to(cuda)
    before = nm_kernel.nm_spmm_cuda.launches
    got = nm_ops.nm_spmm_batched(x, wc, idx)
    assert nm_kernel.nm_spmm_cuda.launches == before + 1
    want = nm_ref.nm_spmm(x, wc, idx)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _paper_case(b, dtype, cuda, delta_scale=0.05):
    spec = paper_spec_4groups(512, 0.8)
    x, wc, idx = _sparse_case(3, 512, 512, spec, b, spikes=True)
    g = torch.Generator().manual_seed(4)
    delta = delta_scale * torch.randn((b, *wc.shape), generator=g)
    return (x.to(cuda, dtype), wc.to(cuda, dtype), idx.to(cuda),
            delta.to(cuda, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 16, 65, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_spmm_gather_kernel_matches_plain_at_paper_shape(cuda, b, dtype):
    """bk = bo = 1, K = J = 512, T = 104 (the SNN paths): base and fused,
    every row count the launch config tells apart, ragged ones too."""
    x, wc, idx, delta = _paper_case(b, dtype, cuda)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    before = (nm_kernel.nm_spmm_cuda.launches,
              nm_kernel.nm_spmm_fused_cuda.launches)
    got = nm_ops.nm_spmm_batched(x, wc, idx)
    fused = nm_ops.nm_spmm_fused(x, wc, idx, delta)
    assert (nm_kernel.nm_spmm_cuda.launches,
            nm_kernel.nm_spmm_fused_cuda.launches) == (before[0] + 2,
                                                       before[1] + 1)
    torch.testing.assert_close(got.float(), nm_ref.nm_spmm(x, wc, idx).float(),
                               atol=tol, rtol=tol)
    want = nm_ref.nm_spmm_fused(x.float(), wc.float(), idx, delta.float())
    torch.testing.assert_close(fused.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_nm_spmm_row_alone_equals_row_in_a_batch_bitwise(cuda, fused):
    """A row's association depends on T alone, whatever the batch: rows
    computed alone (and in a batch of 16) equal the same rows of a batch of
    1024."""
    x, wc, idx, delta = _paper_case(1024, torch.float32, cuda)

    def run(rows):
        if fused:
            return nm_ops.nm_spmm_fused(x[rows].contiguous(), wc, idx,
                                        delta[rows].contiguous())
        return nm_ops.nm_spmm_batched(x[rows].contiguous(), wc, idx)
    full = run(slice(None))
    for r in (0, 1, 517, 1023):
        assert torch.equal(run(slice(r, r + 1)), full[r:r + 1]), r
    assert torch.equal(run(slice(500, 516)), full[500:516])


@pytest.mark.cuda
def test_nm_spmm_fused_takes_one_layer_of_slot_leading_deltas(cuda):
    """The engine hands the kernel ``deltas[:, l]`` of ``[S, L, J, T, 1, 1]``:
    rows apart, each row contiguous; the result equals the contiguous copy's
    bit for bit."""
    x, wc, idx, _ = _paper_case(40, torch.float32, cuda)
    g = torch.Generator().manual_seed(9)
    deltas = (0.05 * torch.randn((40, 2, *wc.shape), generator=g)).to(cuda)
    for layer in range(2):
        view = deltas[:, layer]
        assert not view.is_contiguous()
        got = nm_ops.nm_spmm_fused(x, wc, idx, view)
        assert torch.equal(got, nm_ops.nm_spmm_fused(x, wc, idx,
                                                     view.contiguous()))
        torch.testing.assert_close(got, nm_ref.nm_spmm_fused(x, wc, idx, view),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_nm_spmm_fused_raises_for_tiled_specs(cuda):
    x, wc, idx = _sparse_case(1, 32, 16, NMSpec(n=2, m=4, block=4, out_tile=8), 5)
    delta = torch.zeros((5, *wc.shape))
    with pytest.raises(ValueError):
        nm_ops.nm_spmm_fused(x.to(cuda), wc.to(cuda), idx.to(cuda), delta.to(cuda))


# -------------------------------------------------------------- lif, wu_outer

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 512), (1000, 500), (3, 7)])
def test_lif_kernel_matches_plain_on_card(cuda, shape):
    g = torch.Generator().manual_seed(0)
    v, tr, cur = (torch.randn(shape, generator=g).to(cuda) for _ in range(3))
    got = lif_ops.lif_step(v, tr, cur, alpha=0.9, beta=0.85, theta=1.0)
    want = lif_ref.lif_step(v, tr, cur, alpha=0.9, beta=0.85, theta=1.0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_counters_count_only_real_launches(cuda):
    """An empty problem returns an empty result and launches nothing, so the
    counters that the smoke run checks count launches, not calls."""
    from repro_torch.kernels.lif.kernel import lif_cuda
    before = (nm_kernel.nm_spmm_cuda.launches,
              nm_kernel.nm_spmm_fused_cuda.launches, lif_cuda.launches)
    wc = torch.zeros((4, 4, 1, 1), device=cuda)
    idx = torch.zeros((4, 4), dtype=torch.int32, device=cuda)
    y = nm_ops.nm_spmm_batched(torch.zeros((0, 8), device=cuda), wc, idx)
    assert tuple(y.shape) == (0, 4)
    y = nm_ops.nm_spmm_fused(torch.zeros((0, 8), device=cuda), wc, idx,
                             torch.zeros((0, 4, 4, 1, 1), device=cuda))
    assert tuple(y.shape) == (0, 4)
    v = torch.zeros((0, 16), device=cuda)
    outs = lif_ops.lif_step(v, v, v, alpha=0.9, beta=0.85, theta=1.0)
    assert all(tuple(o.shape) == (0, 16) for o in outs)
    assert (nm_kernel.nm_spmm_cuda.launches,
            nm_kernel.nm_spmm_fused_cuda.launches, lif_cuda.launches) == before
    lif_ops.lif_step(*(torch.zeros((2, 3), device=cuda),) * 3,
                     alpha=0.9, beta=0.85, theta=1.0)
    assert lif_cuda.launches == before[2] + 1


WU_CASES = [(16, 512, 512, 1, 1, 26, 128),     # the training path (paper spec)
            (13, 512, 512, 1, 1, 26, 128),     # ragged batch
            (128, 512, 512, 16, 32, 2, 8),     # tiled spec
            (37, 64, 48, 4, 8, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o,bk,bo,n,m", WU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wu_outer_kernel_matches_plain_on_card(cuda, b, k, o, bk, bo, n, m,
                                               dtype):
    _, _, idx = _sparse_case(8, k, o, NMSpec(n=n, m=m, block=bk, out_tile=bo), b)
    g = torch.Generator().manual_seed(8)
    pre = torch.rand((b, k), generator=g).to(cuda, dtype)
    mod = torch.randn((b, o), generator=g).to(cuda, dtype)
    idx = idx.to(cuda)
    before = wu_kernel.wu_outer_cuda.launches
    got = wu_ops.wu_outer(pre, mod, idx, 0.02, bk=bk, bo=bo)
    assert wu_kernel.wu_outer_cuda.launches == before + 1
    scale = torch.tensor(0.02, dtype=dtype).float()
    want = wu_ref.wu_outer(pre.float(), mod.float(), idx, scale, bk, bo)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    zero = wu_ops.wu_outer(pre, mod, idx, torch.zeros((), device=cuda),
                           bk=bk, bo=bo)
    assert bool((zero == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,o,bk,bo,n,m", WU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wu_outer_apply_matches_plain_on_card(cuda, b, k, o, bk, bo, n, m,
                                              dtype):
    """The training path's update with the add fused in: ``wc + dw`` in a
    fresh tensor from one launch, against the plain ``wc + wu_outer`` in
    f32; a closed gate gives ``wc`` bit for bit."""
    _, wc, idx = _sparse_case(10, k, o, NMSpec(n=n, m=m, block=bk, out_tile=bo), b)
    g = torch.Generator().manual_seed(10)
    pre = torch.rand((b, k), generator=g).to(cuda, dtype)
    mod = torch.randn((b, o), generator=g).to(cuda, dtype)
    wc, idx = wc.to(cuda, dtype), idx.to(cuda)
    before = wu_kernel.wu_outer_cuda.launches
    got = wu_ops.wu_outer_apply(wc, pre, mod, idx, 0.02, bk=bk, bo=bo)
    assert wu_kernel.wu_outer_cuda.launches == before + 1
    assert got.dtype == dtype and got.data_ptr() != wc.data_ptr()
    scale = torch.tensor(0.02, dtype=dtype).float()
    want = wc.float() + wu_ref.wu_outer(pre.float(), mod.float(), idx, scale,
                                        bk, bo)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    closed = wu_ops.wu_outer_apply(wc, pre, mod, idx,
                                   torch.zeros((), device=cuda), bk=bk, bo=bo)
    assert torch.equal(closed, wc) and closed.data_ptr() != wc.data_ptr()


# (S, K, N, bk, bo, n, m): the serving path (T 104, 16-byte vectors), a
# tiled spec (16-byte vectors over kept blocks), T = 6 (scalar vectors)
WU_SLOT_CASES = [(1024, 512, 512, 1, 1, 26, 128),
                 (37, 64, 48, 4, 8, 1, 2),
                 (9, 12, 6, 1, 1, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,k,o,bk,bo,n,m", WU_SLOT_CASES)
def test_wu_outer_slots_kernel_bitwise_through_the_slot_stride(cuda, s, k, o,
                                                               bk, bo, n, m):
    """The in-place per-slot kernel on one layer of slot-leading deltas
    ``[S, 2, J, T, bk, bo]`` equals ``delta + ref.wu_outer_slots`` bit for
    bit, with mixed gates; closed slots and the other layer are not
    written (a -0 stays -0); a slot updated alone equals the same slot
    updated in the batch."""
    _, wc, idx = _sparse_case(12, k, o, NMSpec(n=n, m=m, block=bk, out_tile=bo), 1)
    g = torch.Generator().manual_seed(12)
    pre = torch.rand((s, k), generator=g).to(cuda)
    mod = torch.randn((s, o), generator=g).to(cuda)
    gate = torch.rand(s, generator=g) < 0.4
    gate[0], gate[-1] = False, True
    scale = torch.where(gate, 0.02, 0.0).to(cuda)
    deltas = 0.01 * torch.randn((s, 2, *wc.shape), generator=g)
    deltas[0, 1].view(-1)[:3] = -0.0
    deltas, idx = deltas.to(cuda), idx.to(cuda)
    before = deltas.clone()
    view = deltas[:, 1]
    want = view + wu_ref.wu_outer_slots(pre, mod, idx, scale, bk, bo)
    n0 = wu_kernel.wu_outer_slots_cuda.launches
    got = wu_ops.wu_outer_slots_update(view, pre, mod, idx, scale, bk=bk, bo=bo)
    assert wu_kernel.wu_outer_slots_cuda.launches == n0 + 1
    assert got.data_ptr() == view.data_ptr()
    assert torch.equal(deltas[:, 1], want)
    closed = ~gate.to(cuda)
    assert torch.equal(deltas[closed, 1].view(torch.int32),
                       before[closed, 1].view(torch.int32))
    assert torch.equal(deltas[:, 0].view(torch.int32),
                       before[:, 0].view(torch.int32))
    for r in (0, s // 2, s - 1):
        alone = before[r:r + 1, 1].clone()
        wu_ops.wu_outer_slots_update(alone, pre[r:r + 1], mod[r:r + 1], idx,
                                     scale[r:r + 1], bk=bk, bo=bo)
        assert torch.equal(alone.view(torch.int32),
                           deltas[r:r + 1, 1].view(torch.int32)), r


@pytest.mark.cuda
def test_wu_outer_slots_kernel_raises_on_what_it_does_not_take(cuda):
    _, wc, idx = _sparse_case(13, 512, 512, paper_spec_4groups(512, 0.8), 1)
    s = 4
    pre, mod = torch.rand((s, 512), device=cuda), torch.rand((s, 512), device=cuda)
    scale, idx = torch.full((s,), 0.02, device=cuda), idx.to(cuda)
    delta = torch.zeros((s, *wc.shape), device=cuda)
    n0 = wu_kernel.wu_outer_slots_cuda.launches
    with pytest.raises(TypeError):              # bf16 deltas: f32 only
        wu_ops.wu_outer_slots_update(delta.bfloat16(), pre.bfloat16(),
                                     mod.bfloat16(), idx, scale, bk=1, bo=1)
    with pytest.raises(ValueError):             # slots overlap
        wu_ops.wu_outer_slots_update(delta[:1].expand(s, *wc.shape), pre, mod,
                                     idx, scale, bk=1, bo=1)
    with pytest.raises(ValueError):             # a slot's block not contiguous
        wu_ops.wu_outer_slots_update(
            delta.transpose(1, 2).contiguous().transpose(1, 2), pre, mod, idx,
            scale, bk=1, bo=1)
    with pytest.raises(ValueError):             # idx out of shape
        wu_ops.wu_outer_slots_update(delta, pre, mod, idx[:, :8], scale, bk=1,
                                     bo=1)
    assert wu_kernel.wu_outer_slots_cuda.launches == n0


@pytest.mark.cuda
def test_serving_chunk_through_the_wu_kernel_equals_the_plain_update(
        cuda, monkeypatch):
    """One full-width serving chunk (512-512-512-16, T 50, 1024 slots) with
    every window past ``t_wu`` and random traces, so gates open and the WU
    moves the deltas: through the in-place kernel and again through the
    plain ``delta + ref.wu_outer_slots``, deltas and logits equal bit for
    bit (the other kernels are deterministic, without atomics)."""
    import dataclasses
    from repro_torch.configs.elfcore_snn import CONFIG
    from repro_torch.core import engine
    from repro_torch.core.snn import (init_params, init_stream_deltas,
                                      init_stream_state, run_chunk,
                                      serving_params)
    cfg = dataclasses.replace(CONFIG, backend="kernels")
    s, c = 1024, 8
    params = serving_params(init_params(0, cfg, device=cuda), cfg)
    g = torch.Generator().manual_seed(11)
    deltas = 0.01 * torch.randn(init_stream_deltas(cfg, s, "cpu").shape,
                                generator=g)
    st = init_stream_state(cfg, s, "cpu")
    t_wu = int(cfg.t_steps * cfg.wu_start_frac)
    st = st._replace(
        layers=type(st.layers)(*(torch.rand(t.shape, generator=g)
                                 for t in st.layers)),
        t_in_window=torch.randint(t_wu, cfg.t_steps - c + 1, (s,), generator=g,
                                  dtype=torch.int32))
    st = type(st)(type(st.layers)(*(t.to(cuda) for t in st.layers)),
                  *(t.to(cuda) for t in st[1:]))
    events = (torch.rand((c, s, cfg.n_in), generator=g) < 0.05).float().to(cuda)
    valid = (torch.rand((c, s), generator=g) < 0.9).to(cuda)
    deltas = deltas.to(cuda)
    before = deltas.clone()
    n0 = wu_kernel.wu_outer_slots_cuda.launches
    d_k, _, m_k = run_chunk(params, deltas, st, events, valid, cfg)
    assert wu_kernel.wu_outer_slots_cuda.launches == n0 + c * cfg.n_layers

    def plain(delta, pre, mod, idx, scale, *, bk, bo):
        return delta.add_(wu_ref.wu_outer_slots(pre, mod, idx, scale, bk, bo))
    monkeypatch.setattr(engine.wu_ops, "wu_outer_slots_update", plain)
    d_p, _, m_p = run_chunk(params, deltas, st, events, valid, cfg)
    assert wu_kernel.wu_outer_slots_cuda.launches == n0 + c * cfg.n_layers
    assert torch.equal(deltas, before)           # the input is never written
    assert float(m_k.sop_wu.sum()) > 0.0 and not torch.equal(d_k, before)
    assert torch.equal(d_k, d_p)
    assert torch.equal(m_k.logits, m_p.logits)


@pytest.mark.cuda
def test_topology_epoch_on_the_card_and_the_kernels_on_its_ids(cuda):
    """One live prune/regrow epoch at full width (512-512-512-16, 80 % N:M,
    64 slots of compact deltas) on the card: the masks and projected deltas
    equal the CPU's bit for bit, survivors keep their bits (compared by
    old and new kept ids on the card) and regrown blocks are exactly 0;
    the new ids ascend per out tile, and the fused ``nm_spmm`` and the
    in-place ``wu_outer_slots`` launched on them equal their plain
    versions (``1e-4``; bit for bit)."""
    import dataclasses
    from repro_torch.configs.elfcore_snn import CONFIG
    from repro_torch.core import topology
    from repro_torch.core.snn import init_params, init_stream_deltas, serving_params
    cfg = dataclasses.replace(CONFIG, backend="kernels")
    s = 64
    params = init_params(0, cfg, device="cpu")
    g = torch.Generator().manual_seed(21)
    deltas = 0.01 * torch.randn(init_stream_deltas(cfg, s, "cpu").shape,
                                generator=g)
    pre, post = torch.rand((2, 512), generator=g), torch.rand((2, 512),
                                                             generator=g)
    out = {}
    for dev in ("cpu", cuda):
        p = {"hidden": {k: v.to(dev) for k, v in params["hidden"].items()},
             "readout": params["readout"].to(dev)}
        p2, stats = topology.topology_epoch(p, pre.to(dev), post.to(dev), cfg,
                                            step=0)
        d2 = topology.project_deltas(deltas.to(dev), p["hidden"]["mask"],
                                     p2["hidden"]["mask"], cfg)
        out[str(dev)] = (p2, d2, stats)
    (pc, dc, _), (pg, dg, stats) = out["cpu"], out[str(cuda)]
    assert torch.equal(pg["hidden"]["mask"].cpu(), pc["hidden"]["mask"])
    assert torch.equal(pg["hidden"]["w"].cpu(), pc["hidden"]["w"])
    assert torch.equal(dg.cpu(), dc)
    spec = cfg.spec(512)
    k = cfg.dsst.k_per_group(spec, 0)
    assert int(stats.total_pruned) == int(stats.total_regrown) == \
        2 * (512 // spec.m) * 512 * k
    assert topology.check(pg["hidden"]["mask"], cfg)
    old_ids = topology.stacked_kept_ids(params["hidden"]["mask"].to(cuda), cfg)
    new_ids = topology.stacked_kept_ids(pg["hidden"]["mask"], cfg)
    eq = new_ids[..., :, None] == old_ids[..., None, :]       # [L, J, T, T]
    hit, pos = eq.any(-1), eq.to(torch.uint8).argmax(-1)
    old = torch.take_along_dim(deltas.to(cuda), pos[None, ..., None, None],
                               dim=3)
    assert torch.equal(dg[:, hit], old[:, hit])
    assert not dg[:, ~hit].any() and bool((~hit).any())
    assert bool((new_ids[..., 1:] > new_ids[..., :-1]).all())
    rep = serving_params(pg, cfg)
    assert torch.equal(rep["idx"], new_ids)
    x = (torch.rand((s, 512), generator=g) < 0.05).float().to(cuda)
    for layer in range(2):
        got = nm_ops.nm_spmm_fused(x, rep["wc"][layer], rep["idx"][layer],
                                   dg[:, layer])
        torch.testing.assert_close(
            got, nm_ref.nm_spmm_fused(x, rep["wc"][layer], rep["idx"][layer],
                                      dg[:, layer]), atol=1e-4, rtol=1e-4)
    trace = torch.rand((s, 512), generator=g).to(cuda)
    mod = torch.randn((s, 512), generator=g).to(cuda)
    scale = torch.where(torch.rand(s, generator=g) < 0.5, 0.02, 0.0).to(cuda)
    view = dg[:, 1]
    want = view + wu_ref.wu_outer_slots(trace, mod, rep["idx"][1], scale, 1, 1)
    n0 = wu_kernel.wu_outer_slots_cuda.launches
    wu_ops.wu_outer_slots_update(view, trace, mod, rep["idx"][1], scale,
                                 bk=1, bo=1)
    assert wu_kernel.wu_outer_slots_cuda.launches == n0 + 1
    assert torch.equal(dg[:, 1], want)


# ------------------------------------------------------------ flash attention

def qkv(seed, b, s, h, kv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)))


def f32_grads_and_tolerances(q, k, v, dout, window, out=None, lse=None):
    """The f32 plain gradients in the model layout (GQA groups summed in
    f32), from the forward's ``out`` and ``lse`` in the inputs' dtype (what
    the op saves for its backward; by default ``ref.flash_fwd``'s), and
    their ``ref.bf16_grad_tolerance``."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    kl = fops._to_kernel_layout(q, k, v)
    if out is None:
        o, lse = fref.flash_fwd(*kl, window)
    else:
        o = fops._to_kernel_layout(out, k, v)[0]
    kl = [x.float() for x in kl]
    dok = dout.transpose(1, 2).reshape(b * h, s, dh).float()
    grads = fref.flash_bwd(*kl, o, lse, dok, window)
    sigmas = fref.bwd_rounding_sigmas(*kl, o, lse, dok, window)

    def group(x):                          # [B·H, T, dh] -> [B, T, KV, dh]
        return x.reshape(b, kvh, h // kvh, s, dh).sum(2).transpose(1, 2)
    dq = fops._from_kernel_layout(grads[0], b, s, h, dh)
    sq = fops._from_kernel_layout(sigmas[0], b, s, h, dh)
    out = [(dq, fref.bf16_grad_tolerance(dq, sq))]
    for gr, sg in zip(grads[1:], sigmas[1:]):
        gr = group(gr)
        out.append((gr, fref.bf16_grad_tolerance(gr, group(sg * sg).sqrt())))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,kv,dh,window", [
    (torch.bfloat16, 2, 256, 8, 2, 128, None),
    (torch.float32, 2, 256, 8, 2, 64, None),
    (torch.bfloat16, 1, 300, 4, 4, 160, 37),
    (torch.bfloat16, 2, 1000, 4, 1, 64, None),     # ragged, MQA
    (torch.bfloat16, 2, 256, 4, 4, 128, None),     # group 1, as Moonlight
    # Zamba2's shared block: 32 query and 32 KV heads of 64, window past S
    (torch.bfloat16, 2, 256, 32, 32, 64, 4096),
    # the training shapes of Moonlight and of Zamba2's shared block
    (torch.bfloat16, 2, 4096, 16, 16, 128, None),
    (torch.bfloat16, 2, 4096, 32, 32, 64, 4096),
])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, b, s, h, kv, dh, window):
    q, k, v = (torch.tensor(a).to(cuda, dtype) for a in qkv(5, b, s, h, kv, dh))
    before = fk.flash_fwd_cuda.launches
    o, lse = fk.flash_fwd_cuda(q, k, v, window)
    assert fk.flash_fwd_cuda.launches == before + 1
    o_r, lse_r = fref.flash_fwd(*fops._to_kernel_layout(q, k, v), window)
    o_r = fops._from_kernel_layout(o_r, b, s, h, dh)
    # f32: sums in another order; bf16: ref.bf16_out_tolerance per element
    tol = 1e-5 if dtype == torch.float32 else fref.bf16_out_tolerance(o_r)
    assert bool(((o.float() - o_r.float()).abs() <= tol).all())
    assert float((lse - lse_r).abs().max()) <= 1e-4


def _op_grads(cuda, dtype, b, s, h, kv, dh, window, seed=14):
    q, k, v = (torch.tensor(a).to(cuda, dtype) for a in qkv(seed, b, s, h, kv, dh))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed + 1)
                       ).to(cuda, dtype)
    before = (fk.flash_bwd_dkv_cuda.launches, fk.flash_bwd_dq_cuda.launches)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    (fops.flash_attention(qr, kr, vr, window).float() * dout.float()).sum().backward()
    assert (fk.flash_bwd_dkv_cuda.launches, fk.flash_bwd_dq_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    return q, k, v, dout, (qr.grad, kr.grad, vr.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,s,h,kv,dh,window", [
    (torch.bfloat16, 2, 256, 12, 2, 128, None),
    (torch.float32, 2, 256, 8, 2, 64, None),
    (torch.bfloat16, 1, 300, 4, 4, 160, 37),
    (torch.bfloat16, 2, 1000, 4, 1, 64, None),     # ragged, MQA
    # dQ's 128-query blocks: windows off its key-tile edges, ragged S
    (torch.bfloat16, 1, 520, 6, 2, 128, 130),
    (torch.bfloat16, 2, 333, 4, 2, 128, None),
    (torch.bfloat16, 1, 260, 4, 1, 160, 65),
    # the training shapes of Moonlight (group 1, dh 128) and of Zamba2's
    # shared block (group 1, dh 64, its window of 4096 = S)
    (torch.bfloat16, 2, 4096, 16, 16, 128, None),
    (torch.bfloat16, 2, 4096, 32, 32, 64, 4096),
])
def test_flash_bwd_kernels_match_plain_on_card(cuda, dtype, b, s, h, kv, dh,
                                               window):
    """The plain f32 gradients are computed on the card (the training
    shapes' [B·H, S, S] products would take minutes on the host)."""
    q, k, v, dout, got = _op_grads(cuda, dtype, b, s, h, kv, dh, window)
    out, lse = fk.flash_fwd_cuda(q, k, v, window)
    want = f32_grads_and_tolerances(q, k, v, dout, window, out, lse)
    for x, (r, tol) in zip(got, want):
        if dtype == torch.float32:   # sums in another order
            tol = 1e-4 * (1 + r.abs().max())
        assert bool(((x.float() - r).abs() <= tol).all())
    del want
    torch.cuda.empty_cache()


# The absolute bound at window 1: each row sees only its own key, so p = 1
# and dp - delta cancels to the rounding of two f32 sums of the same dh
# products (at most dh * 2^-24 of the sum of their magnitudes, in any order);
# 2^-14 leaves 8x room at dh 128. A lost or wrong term moves dq or dk by O(1).
WINDOW1_REL = 2.0 ** -14


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 160])
def test_flash_bwd_window1_within_absolute_bound(cuda, dh):
    """At window 1 the exact dq and dk are zero and dv = dO: the kernels'
    dq and dk stay within the absolute bound above, per row, and dv within
    ``ref.bf16_grad_tolerance``."""
    b, s, h, kv = 1, 300, 4, 2
    q, k, v, dout, (dq, dk, dv) = _op_grads(cuda, torch.bfloat16, b, s, h, kv,
                                            dh, 1, seed=21)
    scale = dh ** -0.5
    g = h // kv
    kf, vf, qf, df = (x.float() for x in (k, v, q, dout))
    vh = vf.repeat_interleave(g, dim=2)                     # [B, S, H, dh]
    mag = (df * vh).abs().sum(-1, keepdim=True)             # sum |dO_i v_i|
    bound_q = WINDOW1_REL * scale * mag * kf.abs().amax(-1, keepdim=True) \
        .repeat_interleave(g, dim=2)
    assert bool((dq.float().abs() <= bound_q).all())
    # dk_i sums the G heads' ds_i q_i
    bound_k = (WINDOW1_REL * scale * mag * qf.abs().amax(-1, keepdim=True)) \
        .reshape(b, s, kv, g, 1).sum(3)
    assert bool((dk.float().abs() <= bound_k).all())
    _, _, (r, tol) = f32_grads_and_tolerances(q.cpu(), k.cpu(), v.cpu(),
                                              dout.cpu(), 1)
    assert bool(((dv.cpu().float() - r).abs() <= tol).all())


# ------------------------------------------------------------ MoE routing

def _moe_cfg(**kw):
    import dataclasses
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced("moonshot_v1_16b_a3b"), **kw)


@pytest.mark.cuda
def test_moe_apply_on_card_matches_cpu(cuda):
    """f32, capacity factor 0.5 so that choices are dropped: the same slots
    on both devices (a different token dropped at capacity would move every
    later rank of its expert) and the output within 1e-5."""
    from repro_torch.models import moe
    cfg = _moe_cfg(moe_experts=8, moe_top_k=3, moe_capacity_factor=0.5)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pc = {k: v.to(cuda) if torch.is_tensor(v) else {m: t.to(cuda) for m, t in v.items()}
          for k, v in p.items()}
    out, aux = moe.moe_apply(p, x, cfg)
    out_c, aux_c = moe.moe_apply(pc, x.to(cuda), cfg)
    c = moe.capacity(48, cfg)
    slot = moe._dispatch(x.reshape(48, -1), p["router"], cfg, c)[0]
    slot_c = moe._dispatch(x.to(cuda).reshape(48, -1), pc["router"], cfg, c)[0]
    assert torch.equal(slot, slot_c.cpu()) and bool((slot == 8 * c).any())
    assert float(aux_c["moe_dropped"]) == float(aux["moe_dropped"]) > 0.0
    assert float((out_c.cpu() - out).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_moe_ties_put_the_lower_expert_first_on_card(cuda):
    """Equal router columns (1 = 5, 2 = 3 = 6) on inputs whose logits are
    exact in f32: tied experts come in index order, as on the CPU."""
    from repro_torch.models import moe
    cfg = _moe_cfg(moe_experts=8, moe_top_k=3)
    rng = np.random.default_rng(5)
    flat = torch.tensor(rng.integers(-3, 4, (64, cfg.d_model)).astype(np.float32) / 4)
    router = torch.tensor(rng.integers(-3, 4, (cfg.d_model, 8)).astype(np.float32) / 16)
    router[:, 5] = router[:, 1]
    router[:, 3] = router[:, 6] = router[:, 2]
    c = 64 * 3                                   # keeps every choice
    slot = moe._dispatch(flat.to(cuda), router.to(cuda), cfg, c)[0].cpu()
    assert torch.equal(slot, moe._dispatch(flat, router, cfg, c)[0])
    ids = (slot // c).reshape(64, 3).tolist()
    ties = 0
    for row in ids:
        for lo, hi in ((1, 5), (2, 3), (2, 6), (3, 6)):
            if lo in row and hi in row:
                ties += 1
                assert row.index(lo) < row.index(hi)
    assert ties > 0


@pytest.mark.cuda
def test_moe_train_step_grads_repeat_bit_for_bit_on_card(cuda):
    """A reduced Moonshot (bf16, heads of 64 so that the flash kernels run,
    capacity factor 0.5 so that choices drop) through ``loss_and_grads``
    twice, deterministic algorithms off: every gradient leaf equal bit for
    bit. The dispatch and the combine backward by gathers, so no row sum
    depends on the order of atomics."""
    import dataclasses
    from repro_torch.launch import train
    cfg = dataclasses.replace(_moe_cfg(moe_capacity_factor=0.5), d_head=64,
                              dtype="bfloat16")
    hp = train.TrainHParams()
    params, _, _ = train.init_train_state(
        torch.Generator(device=cuda).manual_seed(0), cfg, hp, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 256), generator=g, device=cuda)
             for k in ("tokens", "labels")}
    assert not torch.are_deterministic_algorithms_enabled()
    step = train.make_train_step(cfg, hp)
    before = fk.flash_bwd_dkv_cuda.launches
    runs = [step.loss_and_grads(params, batch) for _ in range(2)]
    assert fk.flash_bwd_dkv_cuda.launches == before + 2 * cfg.n_layers
    (l1, a1, g1), (l2, a2, g2) = runs
    assert torch.equal(l1, l2) and float(a1[1]["moe_dropped"]) > 0.0

    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] \
            if isinstance(t, dict) else [t]
    pairs = [(x, y) for x, y in zip(leaves(g1), leaves(g2)) if x is not None]
    assert len(pairs) > 10
    for x, y in pairs:
        assert torch.equal(x, y)


# ------------------------------------------------------------ ssm and hybrid

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_1p2b"])
def test_chunked_prefill_equals_replay_on_card(cuda, arch):
    """The chunked prefill (a ragged 13-token prompt, the hybrid's ring of 8
    wrapped) against the same prompt replayed through ``decode_step`` on
    the card, f32 at a small width with heads of 64 so the hybrid's shared
    block runs the flash kernel: last logits and every cache tensor within
    1e-4, and ``flash_fwd`` launched once per shared-block call."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_reduced(arch), d_head=64)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    tok = torch.randint(0, cfg.vocab, (2, 13),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    before = fk.flash_fwd_cuda.launches
    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, tok, 16)
        calls = fk.flash_fwd_cuda.launches - before
        replay = T.init_cache(cfg, 2, 16, device=cuda)
        for t in range(tok.shape[1]):
            want, replay = T.decode_step(params, replay, tok[:, t], cfg)
    every = cfg.hybrid_attn_every
    assert calls == (cfg.n_layers // every if every else 0)
    assert float((logits - want).abs().max()) <= 1e-4
    assert cache["pos"] == replay["pos"] == 13
    for k in ("conv", "ssm", "shared_k", "shared_v"):
        if k in replay:
            assert cache[k].dtype == replay[k].dtype
            assert float((cache[k] - replay[k]).abs().max()) <= 1e-4, k


# ---------------------------------------------------- the serving runtime

def _card_fleet(cuda, aer, sids=range(6), tier_of=None, **kw):
    """Gesture streams ``sids`` (AER-packed or their dense twins) through a
    small kernels-backend fleet on the card; {sid: session}, and the
    ``nm_spmm`` launches the run made."""
    from repro_torch.core.snn import SNNConfig, init_params
    from repro_torch.data.events import make_task
    from repro_torch.serving import (AERStreamSource, StreamScheduler,
                                     StreamSession, TaskStreamSource)
    cfg = SNNConfig(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=16,
                    backend="kernels")
    task = make_task("gesture", n_in=cfg.n_in, t_steps=cfg.t_steps)
    source = AERStreamSource if aer else TaskStreamSource
    sched = StreamScheduler(init_params(0, cfg, device=cuda), cfg,
                            device=cuda, **kw)
    before = nm_kernel.nm_spmm_cuda.launches
    try:
        for sid in sids:
            sched.submit(StreamSession(sid=sid, source=source(
                task, n_windows=2, seed=sid), adapt=sid % 2 == 0),
                tier=None if tier_of is None else tier_of(sid))
        done = {s.sid: s for s in sched.run_until_drained()}
    finally:
        sched.close()
    assert sched.drained and sorted(done) == sorted(sids)
    return done, nm_kernel.nm_spmm_cuda.launches - before


def _assert_same_streams(a, b):
    assert sorted(a) == sorted(b)
    for sid in a:
        assert a[sid].timesteps_fed == b[sid].timesteps_fed
        assert len(a[sid].predictions) == len(b[sid].predictions) == 2
        for pa, pb in zip(a[sid].predictions, b[sid].predictions):
            np.testing.assert_array_equal(pa.logits, pb.logits)
        np.testing.assert_array_equal(a[sid].final_deltas, b[sid].final_deltas)


@pytest.mark.cuda
def test_ingest_depth2_aer_fleet_equals_serial_dense_fleet_on_card(cuda):
    """AER sources through the ingest worker at pipeline depth 2 against
    their dense twins polled inline at depth 0, on the card: bit for bit,
    every step through the kernels."""
    serial, n0 = _card_fleet(cuda, aer=False, n_slots=4, chunk_len=6)
    deep, n1 = _card_fleet(cuda, aer=True, n_slots=4, chunk_len=6,
                           ingest=True, pipeline_depth=2)
    _assert_same_streams(serial, deep)
    assert n0 == n1 > 0


@pytest.mark.cuda
def test_two_tier_fleet_equals_single_grids_on_card(cuda):
    """A two-tier fleet (chunks of 2 and 8) against single-grid fleets with
    each tier's geometry, on the card: bit for bit."""
    from repro_torch.serving import TierConfig

    def tier_of(sid):
        return "interactive" if sid % 3 == 0 else "bulk"
    tiered, _ = _card_fleet(
        cuda, aer=True, tier_of=tier_of, n_slots=2, ingest=True,
        tiers=[TierConfig("interactive", chunk_len=2, n_slots=2),
               TierConfig("bulk", chunk_len=8, n_slots=4)])
    solo = {}
    for name, c, s in (("interactive", 2, 2), ("bulk", 8, 4)):
        solo.update(_card_fleet(cuda, aer=True, n_slots=s, chunk_len=c,
                                sids=[i for i in range(6)
                                      if tier_of(i) == name])[0])
    _assert_same_streams(solo, tiered)


# ------------------------------------------------------- the static checks

def _registry_names():
    from repro_torch.analysis import registry
    return registry.names()


@pytest.mark.cuda
@pytest.mark.parametrize("name", _registry_names())
def test_registry_entry_passes_on_card(cuda, name):
    """Every registry entry at its small geometry on the card; the compact
    SNN entries launch the fused ``nm_spmm`` (counted on both ``nm_spmm``
    counters), ``lif`` and ``wu_outer_slots`` kernels C x L times a call,
    on each entry of a sharded one's mesh."""
    from repro_torch.analysis import dispatch_contracts as dc
    from repro_torch.analysis import registry
    from repro_torch.kernels.lif.kernel import lif_cuda
    from repro_torch.kernels.wu_outer.kernel import wu_outer_slots_cuda
    fn, args, contracts, kwargs = registry.build(name, "cuda")
    counters = (nm_kernel.nm_spmm_cuda, nm_kernel.nm_spmm_fused_cuda,
                lif_cuda, wu_outer_slots_cuda)
    before = [c.launches for c in counters]
    report = dc.check(fn, args, contracts, kwargs=kwargs, name=name)
    assert report.ok, str(report)
    got = [c.launches - b for c, b in zip(counters, before)]
    if name.startswith(("serving.", "snn.")) and "dense" not in name:
        mesh = getattr(fn, "mesh", None)
        per_call = args[3].shape[0] * registry.snn_cfg().n_layers * (
            1 if mesh is None else mesh.size)
        assert got == [report.calls * per_call] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(pipeline_depth=1),
    dict(pipeline_depth=2, ingest=True, autopilot=True),
    dict(pipeline_depth=1, ingest=True, tiers="two")],
    ids=["depth1_inline", "depth2_ingest_autopilot", "tiers"])
def test_stage_and_dispatch_make_no_device_sync_on_card(cuda, kw):
    """A small fleet drained with its stage-side phases under the sync debug
    mode raises nothing. The chunk step's per-layer fan-in and density are
    built afresh here, inside a guarded dispatch: built from a host list
    with ``torch.tensor(..., device="cuda")`` they made a sync on every
    chunk."""
    from repro_torch.analysis.sync_guard import guard_syncs
    from repro_torch.core import engine
    from repro_torch.core.snn import SNNConfig, init_params
    from repro_torch.data.events import make_task
    from repro_torch.serving import (StreamScheduler, StreamSession,
                                     TaskStreamSource, TierConfig)
    engine._layer_arrays_on.cache_clear()
    cfg = SNNConfig(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=16,
                    backend="kernels")
    task = make_task("gesture", n_in=cfg.n_in, t_steps=cfg.t_steps)
    kw = dict(kw)
    if kw.get("tiers"):
        kw["tiers"] = [TierConfig("interactive", chunk_len=2, n_slots=2),
                       TierConfig("bulk", chunk_len=8, n_slots=4)]
    sched = StreamScheduler(init_params(0, cfg, device=cuda), cfg, n_slots=4,
                            chunk_len=6, device=cuda, **kw)
    try:
        for sid in range(6):
            sched.submit(StreamSession(sid=sid, source=TaskStreamSource(
                task, n_windows=2, seed=sid)),
                tier=("interactive" if sid % 3 == 0 else "bulk")
                if kw.get("tiers") else None)
        guard_syncs(sched)
        done = sched.run_until_drained()
    finally:
        sched.close()
        torch.cuda.set_sync_debug_mode("default")
    assert len(done) == 6
    assert all(len(s.predictions) == 2 for s in done)


# ---------------------------------------------------------------------------
# the runtime on the card: recovery, compression, placement
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_recovery_restores_into_meta_without_a_second_state(cuda, tmp_path):
    """A restart frees the lost state's card memory before it restores the
    checkpoint straight onto the card: the peak across the run stays one
    state (the step is in place), and the result equals the straight run
    bit for bit. The donated initial state's storage is released."""
    from repro_torch.runtime import run_with_recovery
    n = 1 << 22                                     # 16 MiB a leaf

    def init():
        g = torch.Generator(device=cuda).manual_seed(0)
        return {"w": torch.randn(n, generator=g, device=cuda),
                "m": (torch.zeros(n, device=cuda), 0)}

    def step(state, i):
        state["w"].mul_(0.5).add_(float(i))
        state["m"][0].add_(state["w"])
        return {"w": state["w"], "m": (state["m"][0], state["m"][1] + 1)}, {}

    want = init()
    for i in range(6):
        want, _ = step(want, i)
    start = init()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, log = run_with_recovery(step, start, 6, str(tmp_path), ckpt_every=2,
                                 fail_at={1: 1, 4: 1})
    torch.cuda.synchronize()
    assert log == {"restarts": 2, "restored_from": [-1, 3]}
    assert torch.cuda.max_memory_allocated() - base < (1 << 20)
    assert torch.equal(got["w"], want["w"]) and torch.equal(got["m"][0], want["m"][0])
    assert got["m"][1] == 6 and got["w"].device.type == "cuda"
    assert start["w"].untyped_storage().nbytes() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_on_card_equals_host(cuda, kind):
    """int8 and top-k payloads on the card equal the host's bit for bit
    (ties and a ragged size included), and so does error feedback."""
    from repro_torch.runtime.compression import (CompressionConfig,
                                                 ErrorFeedback, compress)
    cfg = CompressionConfig(kind=kind, topk_frac=0.05)
    g = torch.Generator().manual_seed(3)
    tree = {"a": torch.randn((300, 257), generator=g),
            "b": {"c": torch.randn(4099, generator=g).bfloat16()}}
    tree["a"][::3, ::5] = 1.5
    for leaf in (tree["a"], tree["b"]["c"]):
        ch, cc = compress(leaf, cfg), compress(leaf.to(cuda), cfg)
        for h, c in zip(ch.payload, cc.payload):
            assert h.dtype == c.dtype and torch.equal(h, c.cpu())
    efh = ErrorFeedback.init(tree)
    card = {"a": tree["a"].to(cuda), "b": {"c": tree["b"]["c"].to(cuda)}}
    efc = ErrorFeedback.init(card)
    for _ in range(3):
        rh, efh = efh.step(tree, cfg)
        rc, efc = efc.step(card, cfg)
    assert torch.equal(rh["a"], rc["a"].cpu())
    assert torch.equal(rh["b"]["c"], rc["b"]["c"].cpu())
    assert torch.equal(efh.residual["a"], efc.residual["a"].cpu())


@pytest.mark.cuda
def test_elastic_remesh_moves_a_tree_onto_the_card(cuda):
    from repro_torch.runtime import elastic_remesh
    tree = {"w": torch.randn((64, 8)), "opt": (torch.arange(5), 3)}
    out = elastic_remesh(tree, [cuda], lambda path: None)
    assert out["w"].device.type == "cuda" and out["opt"][0].device.type == "cuda"
    assert torch.equal(out["w"].cpu(), tree["w"])
    assert torch.equal(out["opt"][0].cpu(), tree["opt"][0]) and out["opt"][1] == 3
    # a mesh holds one device type: a card and the host stay a refusal
    with pytest.raises(ValueError, match="one device type"):
        elastic_remesh(tree, [cuda, torch.device("cpu")], lambda path: None)


# ------------------------------------------- the slot-sharded serving fleet
# On the card, 4 mesh entries of the one device, 64 slots a shard; and
# shards of 1 and 2 slots, where torch's row reductions may pick another
# launch shape, in both delta layouts. The "ref" backend's dense base GEMM
# is refused on a slot mesh of the card.

SHARDS, SHARD_SLOTS = 4, 64


def _card_mesh(cuda):
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh(devices=[cuda] * SHARDS)


def _sharded_step_against_one_card(cuda, compact, width, cfg=None):
    """Three carried chunk steps (decay and clip, ragged valid, a mixed
    adapt mask, factors on) on 4 shards of ``width`` slots against the
    1-device step: every output bit for bit, and each shard launching the
    kernels once a layer-timestep."""
    from repro_torch.core.snn import (SNNConfig, init_params,
                                      init_stream_deltas, init_stream_state,
                                      serving_params)
    from repro_torch.kernels.lif.kernel import lif_cuda
    from repro_torch.launch import sharding
    from repro_torch.serving.adapt import AdaptConfig, make_chunk_fn
    cfg = cfg or SNNConfig(n_in=32, n_hidden=32, n_layers=2, n_out=8,
                           t_steps=16, backend="kernels")
    S, C = SHARDS * width, 6
    ex = serving_params(init_params(0, cfg, device=cuda), cfg,
                        compact=compact)
    adapt = AdaptConfig(delta_decay=0.95, delta_clip=0.3)
    fn1, fn4 = make_chunk_fn(cfg, adapt), make_chunk_fn(cfg, adapt,
                                                        mesh=_card_mesh(cuda))
    st1 = init_stream_state(cfg, S, device=cuda)
    dl1 = init_stream_deltas(cfg, S, device=cuda, compact=compact)
    st4, dl4 = st1, dl1
    rng = np.random.default_rng(0)
    opened = 0.0
    for _ in range(3):
        ev = torch.tensor(rng.random((C, S, cfg.n_in)) < 0.3,
                          dtype=torch.float32, device=cuda)
        va = torch.tensor(rng.random((C, S)) < 0.8, device=cuda)
        am = torch.tensor(rng.random(S) < 0.7, device=cuda)
        am[0] = True
        dl1, st1, m1 = fn1(ex, dl1, st1, ev, va, am)
        opened += float(m1.sop_wu.sum())
        before = lif_cuda.launches
        dl4, st4, m4 = fn4(ex, dl4, st4, ev, va, am)
        assert lif_cuda.launches - before == \
            SHARDS * C * cfg.n_layers
        assert isinstance(dl4, sharding.SlotSharded)
        assert torch.equal(dl1, dl4.full())
        for a, b in zip(torch.utils._pytree.tree_leaves(st1),
                        torch.utils._pytree.tree_leaves(
                            sharding.gather(st4))):
            assert torch.equal(a, b)
        for name, a, b in zip(m1._fields, m1, sharding.gather(m4)):
            assert torch.equal(a, b), name
    assert opened > 0


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [True, False])
def test_sharded_chunk_step_equals_one_card_on_card(cuda, compact):
    """4 shards of 64 slots against the 1-device step, bit for bit."""
    _sharded_step_against_one_card(cuda, compact, SHARD_SLOTS)


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("width", [1, 2])
def test_narrow_shards_equal_one_card_on_card(cuda, compact, width):
    """Shards of 1 and 2 slots at the paper's layer width (512), where
    torch's row reductions take another launch shape than at 4 or 8 rows:
    the step, across a window's weight updates, still equals the 1-device
    step bit for bit, in both delta layouts (serving sums each slot's OSSL
    terms in an order fixed by N: ``engine.serving_ossl_terms``)."""
    from repro_torch.core.snn import SNNConfig
    _sharded_step_against_one_card(cuda, compact, width, cfg=SNNConfig(
        n_in=512, n_hidden=512, n_layers=2, n_out=16, t_steps=16,
        backend="kernels"))


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [True, False])
def test_fleet_at_two_slots_a_shard_equals_one_card_on_card(cuda, compact):
    """The scheduler at its floor of 2 slots an entry, both delta layouts,
    against the 1-device fleet of the same width: bit for bit."""
    n = SHARDS * 2
    one, k1 = _card_fleet(cuda, aer=False, n_slots=n, chunk_len=6,
                          pipeline_depth=1, compact=compact)
    four, k4 = _card_fleet(cuda, aer=False, n_slots=n, chunk_len=6,
                           pipeline_depth=1, compact=compact,
                           mesh=_card_mesh(cuda))
    _assert_same_streams(one, four)
    assert k4 == SHARDS * k1 > 0


@pytest.mark.cuda
def test_slot_mesh_refuses_the_dense_base_gemm_on_card(cuda):
    """The "ref" backend's dense layout (base ``pre @ w``) is refused on a
    slot mesh of the card, whose GEMM rounds by the shard's row count."""
    from repro_torch.core.snn import (SNNConfig, init_params,
                                      init_stream_deltas, init_stream_state,
                                      serving_params)
    from repro_torch.serving.adapt import make_chunk_fn
    cfg = SNNConfig(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=16,
                    backend="ref")
    ex = serving_params(init_params(0, cfg, device=cuda), cfg, compact=False)
    S = SHARDS * 2
    fn = make_chunk_fn(cfg, mesh=_card_mesh(cuda))
    with pytest.raises(ValueError, match="dense base GEMM"):
        fn(ex, init_stream_deltas(cfg, S, device=cuda, compact=False),
           init_stream_state(cfg, S, device=cuda),
           torch.zeros((2, S, cfg.n_in), device=cuda),
           torch.ones((2, S), dtype=torch.bool, device=cuda),
           torch.ones(S, dtype=torch.bool, device=cuda))


@pytest.mark.cuda
def test_sharded_fleet_equals_one_card_fleet_on_card(cuda):
    """The scheduler on 4 shards of one card against the 1-device fleet:
    gesture streams at depth 1, bit for bit, one chunk fn, and each
    shard's staged block one contiguous pinned region."""
    n = SHARDS * SHARD_SLOTS
    one, k1 = _card_fleet(cuda, aer=False, n_slots=n, chunk_len=6,
                          pipeline_depth=1)
    four, k4 = _card_fleet(cuda, aer=False, n_slots=n, chunk_len=6,
                           pipeline_depth=1, mesh=_card_mesh(cuda))
    _assert_same_streams(one, four)
    assert k4 == SHARDS * k1 > 0


@pytest.mark.cuda
def test_sharded_staging_blocks_are_pinned_and_contiguous_on_card(cuda):
    from repro_torch.core.snn import SNNConfig, init_params
    from repro_torch.serving import ReplaySource, StreamScheduler, StreamSession
    cfg = SNNConfig(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=16,
                    backend="kernels")
    sched = StreamScheduler(init_params(0, cfg, device=cuda), cfg,
                            n_slots=SHARDS * 2, chunk_len=4,
                            mesh=_card_mesh(cuda))
    ev = (np.random.default_rng(0).random((8, cfg.n_in)) < 0.3)
    for sid in range(3):
        sched.submit(StreamSession(sid=sid, source=ReplaySource(
            ev.astype(np.float32))))
    staged = sched._stage(sched._tiers[0])
    for buf in (staged.events, staged.valid, staged.adapt_mask):
        assert buf.shape[0] == SHARDS
        for block in buf:
            assert block.is_contiguous() and block.is_pinned()


# ------------------------------------- data-parallel LM training (slice 16)

@pytest.fixture
def nccl_world_of_one(cuda, monkeypatch):
    """A one-rank NCCL group joined through fleet_init's variables, torn
    down after the test."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.launcher import fleet_init
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"localhost:{port}")
    monkeypatch.setenv("PROCESS_COUNT", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    assert fleet_init("cuda") == (0, 1) and dist.get_backend() == "nccl"
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "stablelm_12b",
                                  "moonshot_v1_16b_a3b"])
def test_dp_step_over_one_nccl_rank_equals_the_plain_step_on_card(
        cuda, nccl_world_of_one, arch):
    """The data-parallel step on the host mesh of a one-rank NCCL group
    (every collective issued; a sum over one rank and a divide by 1 are
    exact), ZeRO-1 on and the gate on, under ``shardmap_moe`` (one device:
    the plain dispatch), against ``make_train_step``'s three steps from
    the same state: params, moments and losses bit for bit."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.core.gating import GatingConfig
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.optimizer import tree_leaves
    # bf16 at a head width the flash kernels have (64)
    cfg = dataclasses.replace(C.get_reduced(arch), dtype="bfloat16",
                              d_head=64)
    if cfg.rope_mode == "mrope":
        cfg = dataclasses.replace(cfg, mrope_sections=(8, 12, 12))
    hp = TrainHParams(opt=AdamWConfig(lr=1e-2, warmup_steps=1),
                      gating=GatingConfig(), zero1=True)
    mesh = make_host_mesh()
    assert tuple(mesh.shape) == (1, 1) and mesh.get_group("data").size() == 1
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.tensor(rng.integers(0, cfg.vocab, (2, 64)),
                                       device=cuda),
                "labels": torch.tensor(rng.integers(0, cfg.vocab, (2, 64)),
                                       device=cuda)} for _ in range(3)]
    if cfg.frontend:
        for b in batches:
            b["embeds"] = torch.tensor(
                rng.standard_normal((2, 64, cfg.frontend_dim)),
                dtype=torch.bfloat16, device=cuda)
            del b["tokens"]
    runs = []
    for dp in (False, True):
        gen = torch.Generator(device=cuda).manual_seed(0)
        with spmd.activate(mesh, flash_attn=True, seq_shard=True,
                           shardmap_moe=True):
            state = init_train_state(gen, cfg, hp, cuda,
                                     mesh=mesh if dp else None)
            step = make_train_step(cfg, hp, mesh=mesh if dp else None)
            losses = []
            for b in batches:
                p, o, s, m = step(*state, b)
                state = (p, o, s)
                losses.append(float(m["loss"]))
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    assert la == lb
    for x, y in zip(tree_leaves(a[0]) + tree_leaves(a[1].m)
                    + tree_leaves(a[1].v),
                    tree_leaves(b[0]) + tree_leaves(b[1].m)
                    + tree_leaves(b[1].v)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------- the MoE family data-parallel (slice 17)

# one of two gloo ranks on the card: argv = (out,); phase 26's gates at a
# reduced width, f32, the plain attention route
_DP_MOE_WORKER = r"""
import faulthandler, sys, json, dataclasses, torch
faulthandler.enable()
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch import configs as C
from repro_torch.core.gating import GatingConfig
from repro_torch.launch import spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import TrainHParams, init_train_state, make_train_step
from repro_torch.models import moe as MOE
from repro_torch.optim import AdamWConfig
from repro_torch.optim.optimizer import tree_leaves, tree_map
from repro_torch.runtime.compression import (CompressionConfig, compress,
                                             compressed_mean, decompress)
from repro_torch.runtime.fault_tolerance import elastic_remesh
torch.use_deterministic_algorithms(True)
rank, world = fleet_init("cuda", backend="gloo")
dev = torch.device("cuda")
mesh = make_host_mesh(device="cuda")
cfg = dataclasses.replace(C.get_reduced("moonshot_v1_16b_a3b"),
                          moe_capacity_factor=1.0)
hp = TrainHParams(opt=AdamWConfig(lr=1e-2, warmup_steps=1),
                  gating=GatingConfig())
gen = torch.Generator().manual_seed(1)
batch = {{k: torch.randint(0, cfg.vocab, (2, 32), generator=gen).to(dev)
         for k in ("tokens", "labels")}}
half = lambda r: {{k: v[r:r + 1] for k, v in batch.items()}}
rec = {{}}
# (a) the DP gradients against the 1-process halves, bit for bit
state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                         hp, dev)
one = make_train_step(cfg, hp, attn="plain")
g0, g1 = (one.loss_and_grads(state[0], half(r))[2] for r in (0, 1))
want = tree_map(lambda a, b: None if a is None else
                ((a.float() + b.float()) / 2).to(a.dtype), g0, g1)
finals = {{}}
with spmd.activate(mesh, shardmap_moe=True):
    for zero1 in (False, True):
        hpz = dataclasses.replace(hp, zero1=zero1)
        step = make_train_step(cfg, hpz, mesh=mesh, attn="plain")
        st = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                              hpz, dev, mesh=mesh)
        if not zero1:
            got = step.dp.mean_grads(step.loss_and_grads(st[0], half(rank))[2])
            rec["grads_equal"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got), tree_leaves(want)) if b is not None)
        for i in range(2):
            st = step(*st, half(rank))[:3]
        finals[zero1] = st
        if zero1:
            placed = step.dp.placed_opt_state(st[1], step.dp.zero1_layout(st[0]))
            whole = elastic_remesh({{"m": placed.m, "v": placed.v}}, dev,
                                   lambda path: None)
            rec["remesh_equal"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(whole), tree_leaves({{"m": finals[False][1].m,
                                                 "v": finals[False][1].v}})))
rec["zero1_equal"] = all(torch.equal(a, b) for a, b in zip(
    tree_leaves(finals[False][0]), tree_leaves(finals[True][0])))
rec["params"] = [float(t.double().sum()) for t in tree_leaves(finals[True][0])]
# (b) expert parallelism on (data 1, model 2) against the 1-process layer
p = MOE.moe_init(torch.Generator(device=dev).manual_seed(3), cfg, torch.float32)
x = torch.randn((2, 16, cfg.d_model), device=dev,
                generator=torch.Generator(device=dev).manual_seed(4))
leaves = [x, p["router"]] + [p[k]["w"] for k in ("w1", "w2", "w3")]
for t in leaves:
    t.requires_grad_()
def fwd_bwd():
    out, aux = MOE.moe_apply(p, x, cfg)
    return out, torch.autograd.grad((out * out).mean() + aux["moe_aux"], leaves)
o1, gr1 = fwd_bwd()
with spmd.activate(make_host_mesh(model=2, device="cuda"), shardmap_moe=True):
    o2, gr2 = fwd_bwd()
el = cfg.moe_experts // 2
close = lambda a, b, t: float((a - b).abs().max()) <= t * float(b.abs().max())
rec["ep_equal"] = close(o2, o1, 1e-5) and all(
    close(a, b, 1e-4) for a, b in zip(gr2[:2], gr1[:2])) and all(
    close(a.narrow(0, rank * el, el), b.narrow(0, rank * el, el), 1e-4)
    for a, b in zip(gr2[2:], gr1[2:]))
# (c) the compressed mean against the host's, bit for bit
def grads_of(r):
    g = torch.Generator().manual_seed(100 + r)
    return {{"a": torch.randn((64, 300), generator=g),
            "b": torch.randn((1000,), generator=g)}}
for kind in ("int8", "topk"):
    ccfg = CompressionConfig(kind=kind)
    mean, _ = compressed_mean(tree_map(lambda t: t.to(dev), grads_of(rank)),
                              ccfg, spmd.dp_groups(mesh))
    host = {{}}
    for k in ("a", "b"):
        s = sum(decompress(compress(grads_of(r)[k], ccfg), ccfg)
                for r in range(world))
        host[k] = s / torch.full_like(s, float(world))
    rec["compressed_" + kind] = all(torch.equal(mean[k].cpu(), host[k])
                                    for k in host)
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_dp_moe_two_gloo_ranks_on_card(cuda, tmp_path):
    """Phase 26's gates at a reduced width (f32, plain attention), two gloo
    ranks on the card: the DP gradients bit for bit the mean of the
    1-process halves', ZeRO-1 bit for bit, its moments remeshed onto one
    device bit for bit the replicated ones, the ranks' params equal; one
    MoE layer on (data 1, model 2) within 1e-5 (output) and 1e-4
    (gradients) of the 1-process layer; the compressed mean, int8 and
    top-k, bit for bit the host's."""
    import json
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    env = dict(os.environ, PYTHONPATH=src, PROCESS_COUNT="2",
               COORDINATOR_ADDRESS=f"localhost:{port}",
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_MOE_WORKER.format(src=src), outs[r]],
        env=dict(env, PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, logs):
        assert p.returncode == 0, so + se
    recs = []
    for o in outs:
        with open(o) as f:
            recs.append(json.load(f))
    for r in recs:
        assert {k: v for k, v in r.items() if k != "params"} == {
            "grads_equal": True, "remesh_equal": True, "zero1_equal": True,
            "ep_equal": True, "compressed_int8": True,
            "compressed_topk": True}, r
    assert recs[0]["params"] == recs[1]["params"]


# ----------------------------------------------------------------- tracing

@pytest.mark.cuda
def test_tracer_device_time_nests_on_card(cuda):
    """A span's device time lies between its two events on the stream:
    positive, nested spans summing to at most their parent (each reading
    within the events' 0.5 µs resolution)."""
    from repro_torch.obs import Tracer, active, use
    tr = Tracer(device_time=True)
    a = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with use(tr):
        with active().span("outer"):
            for name in ("one", "two"):
                with active().span(name):
                    for _ in range(4):
                        a = (a @ a).tanh_()
    torch.cuda.synchronize()
    got = {s.name: s for s in tr.spans()}
    assert got["one"].device_s > 0 and got["two"].device_s > 0
    assert got["one"].device_s + got["two"].device_s \
        <= got["outer"].device_s + 1e-6


@pytest.mark.cuda
def test_tracer_never_synchronises_on_card(cuda):
    """Opening spans and setting a tensor attribute under
    ``set_sync_debug_mode("error")``: no synchronise. Reading a span whose
    end the card has not reached raises; after a synchronise it reads."""
    from repro_torch.obs import Tracer, active, use
    tr = Tracer(device_time=True)
    x = torch.randn(256, 256, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with use(tr):
            with active().span("outer", rows=256) as sp:
                y = x @ x
                sp.set(total=y.sum())
                with active().span("inner"):
                    y = y.relu()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = {s.name: s for s in tr.spans()}
    assert got["outer"].attr("total") == pytest.approx(
        float((x @ x).sum()), rel=1e-4, abs=1e-2)
    assert got["outer"].attr("rows") == 256
    late = Tracer(device_time=True)
    with late.span("sleep"):
        torch.cuda._sleep(500_000_000)          # about 0.25 s of cycles
    with pytest.raises(RuntimeError):
        late.spans()
    torch.cuda.synchronize()
    assert late.spans()[0].device_s > 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "zamba2_1p2b"])
def test_traced_lm_paths_match_untraced_on_card(cuda, arch):
    """Two gated train steps with remat and a ``generate`` of a reduced
    MoE and hybrid config on the card, with and without an active tracer
    that keeps device time: the same bits, as many synchronises (counted
    by ``set_sync_debug_mode("warn")``); the step's parts fit inside it,
    and remat's recompute runs on autograd's own thread, as roots."""
    import contextlib
    import dataclasses
    import threading
    import warnings
    from repro_torch import configs as C
    from repro_torch.core.gating import GatingConfig
    from repro_torch.launch import train
    from repro_torch.launch.serve import generate
    from repro_torch.obs import Tracer, use
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.optimizer import tree_leaves
    cfg = dataclasses.replace(C.get_reduced(arch), remat=True)
    hp = train.TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=100),
                            gating=GatingConfig())
    rng = np.random.default_rng(3)
    batches = [{k: torch.tensor(rng.integers(0, cfg.vocab, (2, 16)),
                                device=cuda) for k in ("tokens", "labels")}
               for _ in range(2)]

    def run(tracer):
        state = train.init_train_state(
            torch.Generator(device=cuda).manual_seed(0), cfg, hp,
            device=cuda)
        step = train.make_train_step(cfg, hp, attn="plain")
        torch.cuda.synchronize()
        ms = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with (use(tracer) if tracer else contextlib.nullcontext()):
                    for b in batches:
                        *state, m = step(*state, b)
                        ms.append(m)
                    tok = generate(state[0], cfg, batches[0]["tokens"][:, :11],
                                   3, attn="plain")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        leaves = (tree_leaves(state[0]) + tree_leaves(state[1].m)
                  + tree_leaves(state[1].v) + [m["loss"] for m in ms])
        return leaves, tok, sum("synchroniz" in str(w.message)
                                for w in caught)

    tr = Tracer(capacity=1 << 16, device_time=True)
    on, off = run(tr), run(None)
    assert torch.equal(on[1], off[1]) and on[2] == off[2]
    assert len(on[0]) == len(off[0])
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    spans = tr.spans()
    assert tr.n_dropped == 0
    by_id = {s.span_id: s for s in spans}
    for step in tr.spans("train.step"):
        parts = [s for s in spans if s.parent_id == step.span_id]
        assert {s.name for s in parts} >= {"train.forward", "train.backward",
                                           "train.grads_stack", "train.gates",
                                           "train.adamw"}
        assert 0 < sum(s.device_s for s in parts) <= step.device_s + 1e-5
    block = {"moe.route", "ssm.ssd"}
    roots = [s for s in spans if s.name in block and s.parent_id is None]
    assert roots and all(s.thread != threading.current_thread().name
                         for s in roots)
    fwd = [s for s in spans if s.name in block and s.parent_id is not None
           and by_id[s.parent_id].name == "train.forward"]
    assert len(fwd) == len(roots) == 2 * cfg.n_layers
    assert all(s.device_s > 0 for s in fwd + roots)


# ------------------------------------------------------------------ adamw

# (p dtype, g dtype, leaf shape, scale, ZeRO-1 dim)
ADAMW_CASES = {
    "f32": (torch.float32, torch.float32, (3, 40, 72), None, None),
    "bf16": (torch.bfloat16, torch.bfloat16, (3, 40, 72), None, None),
    "p_bf16_g_f32": (torch.bfloat16, torch.float32, (3, 40, 72), None, None),
    "p_f32_g_bf16": (torch.float32, torch.bfloat16, (3, 40, 72), None, None),
    "scalar_scale": (torch.bfloat16, torch.bfloat16, (3, 40, 72), "one", None),
    "layer_gate": (torch.bfloat16, torch.bfloat16, (4, 64, 96), "layer", None),
    "expert_mask": (torch.bfloat16, torch.bfloat16, (4, 8, 64, 48), "mask",
                    None),
    "closed_gate": (torch.bfloat16, torch.bfloat16, (4, 64, 96), "closed",
                    None),
    "zero1_dim1": (torch.bfloat16, torch.bfloat16, (4, 8, 64, 48), "mask", 1),
    "zero1_last": (torch.float32, torch.bfloat16, (4, 64, 96), "layer", 2),
    "odd": (torch.float32, torch.bfloat16, (3, 5, 7), "layer", None),
    "large": (torch.bfloat16, torch.bfloat16, (2, 16384, 16400), "layer", None),
}


def _adamw_scale(kind, shape, cuda):
    gate = torch.tensor([1.0, 0.0, 1.0, 1.0] * 2, device=cuda)[:shape[0]]
    lgate = gate.reshape((-1,) + (1,) * (len(shape) - 1))
    if kind == "one":
        return torch.ones((), device=cuda)
    if kind == "layer":
        return lgate
    if kind == "closed":
        return torch.zeros_like(lgate)
    if kind == "mask":              # an expert leaf's N:M mask, per layer
        mask = torch.rand((shape[0], 1, shape[2], 1), device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(2))
        return (mask < 0.5).float() * lgate
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_kernel_bitwise_the_plain_update_on_card(cuda, case):
    """Three steps of the fused update against ``kernels/adamw/ref.py`` on
    the card, given the same clip: ``p``, ``m`` and ``v`` bit for bit, for
    f32 and bf16 parameters and gradients, no scale, a 0-d one, a per-layer
    gate, an expert leaf's per-layer N:M mask ``[L, 1, K, 1]``, a closed
    gate, ZeRO-1 blocks narrowed on dim 1 and on the last dim (the rest of
    the parameter untouched), a shape off the vector path, and a leaf of
    2.15 GB of ``m`` (64-bit offsets; the plain path in slabs)."""
    from repro_torch.kernels.adamw import kernel as ak, ref as aref
    from repro_torch.optim.optimizer import AdamWConfig, cosine_schedule
    pd, gd, shape, kind, zdim = ADAMW_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(11)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2)
    s = _adamw_scale(kind, shape, cuda)
    w = None if zdim is None else shape[zdim] // 2

    def view(x):
        return x if zdim is None else x.narrow(zdim, w, w)
    sv = s if zdim is None else torch.broadcast_to(s, shape).narrow(zdim, w, w)
    p = torch.randn(shape, device=cuda, generator=gen).to(pd)
    m = torch.randn(view(p).shape, device=cuda, generator=gen) * 0.01
    v = torch.rand(view(p).shape, device=cuda, generator=gen) * 1e-4
    kp, km, kv = p.clone(), m.clone(), v.clone()
    for step in range(1 if case == "large" else 3):
        g = (3 * torch.randn(shape, device=cuda, generator=gen)).to(gd)
        clip = torch.tensor(0.7, device=cuda)
        t = np.float32(step + 1)
        hyper = (cosine_schedule(cfg, step),
                 float(np.float32(1) - np.float32(cfg.b1) ** t),
                 float(np.float32(1) - np.float32(cfg.b2) ** t))
        aref.update(view(g), view(p), m, v, sv, clip, cfg, *hyper)
        ak.adamw_update_cuda([(view(g), view(kp), km, kv, sv)], clip, cfg,
                             *hyper)
        del g
    torch.cuda.synchronize()
    assert torch.equal(kp, p), case
    assert torch.equal(km, m) and torch.equal(kv, v), case


@pytest.mark.cuda
def test_adamw_norm_kernel_within_1e6_of_f64_and_repeatable_on_card(cuda):
    """The sums of squares of bf16 and f32 blocks (one narrowed, rows of
    runs; one off the vector path; one of a single element; one above a
    chunk), the model-split ones apart: within 1e-6 relative of the f64
    sums, and the same bits on a second run."""
    from repro_torch.kernels.adamw import kernel as ak, ops as aops
    gen = torch.Generator(device=cuda).manual_seed(3)
    blocks = [torch.randn((3, 5, 7), device=cuda, generator=gen),
              torch.randn((200_003,), device=cuda, generator=gen).bfloat16(),
              4 * torch.randn((4, 64, 2048), device=cuda,
                              generator=gen).bfloat16(),
              torch.randn((1,), device=cuda, generator=gen),
              torch.randn((4, 8, 64, 48), device=cuda,
                          generator=gen).narrow(1, 2, 4),
              torch.randn((163840, 64), device=cuda, generator=gen).bfloat16()]
    split = [False, True, False, True, True, False]
    out = ak.adamw_norm_cuda(blocks, split)
    again = ak.adamw_norm_cuda(blocks, split)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    for k, want_split in enumerate((False, True)):
        want = sum(float(b.double().square().sum())
                   for b, sp in zip(blocks, split) if sp == want_split)
        assert abs(float(out[k]) - want) <= 1e-6 * want, (k, float(out[k]), want)
    rep, part = aops.sq_sums(blocks[:1], [False])
    assert part is None and float(rep) == pytest.approx(
        float(blocks[0].double().square().sum()), rel=1e-6)


@pytest.mark.cuda
def test_adamw_span_counts_two_launches_over_every_element_on_card(cuda):
    """A gated train step of a reduced MoE config on the card: its
    ``train.adamw`` span counts the fused AdamW's two launches (the norm,
    the update) and every trainable element of the tree."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.core.gating import GatingConfig
    from repro_torch.launch import train
    from repro_torch.obs import Tracer, use
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.optimizer import tree_leaves, trainable
    cfg = dataclasses.replace(C.get_reduced("moonshot_v1_16b_a3b"), remat=True)
    hp = train.TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=100),
                            gating=GatingConfig())
    rng = np.random.default_rng(3)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab, (2, 16)), device=cuda)
             for k in ("tokens", "labels")}
    state = train.init_train_state(torch.Generator(device=cuda).manual_seed(0),
                                   cfg, hp, device=cuda)
    n = sum(x.numel() for x in tree_leaves(state[0]) if trainable(x))
    step = train.make_train_step(cfg, hp, attn="plain")
    tr = Tracer(capacity=1 << 12)
    with use(tr):
        for _ in range(2):
            *state, _m = step(*state, batch)
    torch.cuda.synchronize()
    spans = tr.spans("train.adamw")
    assert [(s.attr("launches"), s.attr("elems")) for s in spans] == \
        [(2, n)] * 2


@pytest.mark.cuda
def test_adamw_kernel_raises_on_what_it_does_not_take_on_card(cuda):
    from repro_torch.kernels.adamw import kernel as ak
    from repro_torch.optim.optimizer import AdamWConfig
    cfg, clip = AdamWConfig(), torch.tensor(1.0, device=cuda)

    def leaf(**kw):
        t = {k: torch.zeros((4, 8), device=cuda) for k in "gpmv"}
        t.update(kw)
        return (t["g"], t["p"], t["m"], t["v"], None)
    for bad, err in ((leaf(p=torch.zeros((4, 8), device=cuda,
                                         dtype=torch.float16)), TypeError),
                     (leaf(g=torch.zeros((4, 8), device=cuda,
                                         dtype=torch.float64)), TypeError),
                     (leaf(m=torch.zeros((4, 8), device=cuda,
                                         dtype=torch.bfloat16)), TypeError),
                     (leaf(v=torch.zeros((4, 8))), ValueError)):
        with pytest.raises(err):
            ak.adamw_update_cuda([bad], clip, cfg, 1e-3, 0.1, 0.05)
    with pytest.raises(TypeError):
        ak.adamw_norm_cuda([torch.zeros(8, device=cuda, dtype=torch.int32)],
                           [False])
    with pytest.raises(TypeError):
        ak.adamw_update_cuda([leaf()], clip.double(), cfg, 1e-3, 0.1, 0.05)
