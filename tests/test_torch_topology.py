"""The port's sparsity, gating, DSST and topology code against the JAX
reference, on the same numpy inputs.

No tolerance here except for ``unit_scores``' block sums (``atol 1e-5``,
another summation order): masks, kept ids, compact index views, counts
and schedule levels must be equal, and the weight/delta remaps bitwise
(survivors are kept by ``where``, never by a multiply, so no bit may
move). Scores are planted with ties, exact zeros and ``-0.0`` to pin the
tie order: ``jax.lax.top_k`` gives the lower index first and puts ``+0.0``
above ``-0.0``; its argsort compares the two zeros equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsst as jdsst
from repro.core import engine as jengine
from repro.core import gating as jgating
from repro.core import snn as jsnn
from repro.core import sparsity as jsp
from repro.core import topology as jtopo
from repro_torch import convert
from repro_torch.core import dsst, engine, gating, snn, sparsity as sp, topology

torch.set_num_threads(1)

KW = dict(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=12)
JCFG = jsnn.SNNConfig(**KW, dsst=jdsst.DSSTConfig(period=4, prune_frac=0.5))
CFG = snn.SNNConfig(**KW, dsst=dsst.DSSTConfig(period=4, prune_frac=0.5))
# the paper's 4 groups at a narrow width: m = 8, n = 4
SPEC_J, SPEC = jsp.NMSpec(n=4, m=8), sp.NMSpec(n=4, m=8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _mask(seed, lead=(), kb=32, j=16, spec=SPEC_J):
    keys = jax.random.split(jax.random.PRNGKey(seed), max(1, int(np.prod(lead))))
    ms = [np.asarray(jsp.random_unit_mask(k, spec, kb, j)) for k in keys]
    return np.stack(ms).reshape(*lead, kb, j) if lead else ms[0]


def _tied_scores(seed, shape):
    """Scores with many exact ties, exact zeros and negative zeros."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 3, shape).astype(np.float32)      # 0, 1, 2: ties
    s[rng.random(shape) < 0.3] = -0.0
    return s


# ------------------------------------------------------------- sparsity

@pytest.mark.parametrize("lead", [(), (3,)])
def test_check_unit_mask_and_compact_indices_match_reference(lead):
    m = _mask(0, lead)
    assert bool(sp.check_unit_mask(torch.tensor(m), SPEC)) \
        is bool(jsp.check_unit_mask(jnp.asarray(m), SPEC_J)) is True
    broken = m.copy()
    broken[..., 0, 0] = ~broken[..., 0, 0]
    assert not bool(sp.check_unit_mask(torch.tensor(broken), SPEC))
    flat = m.reshape(-1, *m.shape[-2:])
    for one in flat:
        np.testing.assert_array_equal(
            sp.compact_indices(torch.tensor(one), SPEC).numpy(),
            np.asarray(jsp.compact_indices(jnp.asarray(one), SPEC_J)))


@pytest.mark.parametrize("spec_kw", [dict(n=26, m=128),
                                     dict(n=2, m=8, block=16, out_tile=32)])
def test_memory_bits_matches_reference(spec_kw):
    assert sp.memory_bits(512, 512, sp.NMSpec(**spec_kw)) == \
        jsp.memory_bits(512, 512, jsp.NMSpec(**spec_kw))


@pytest.mark.parametrize("reduce", ["abs_sum", "sum", "max"])
def test_unit_scores_match_reference(reduce):
    x = np.random.default_rng(1).standard_normal((64, 96)).astype(np.float32)
    got = sp.unit_scores(torch.tensor(x), sp.NMSpec(1, 2, 4, 8), 64, 96, reduce)
    want = jsp.unit_scores(jnp.asarray(x), jsp.NMSpec(1, 2, 4, 8), 64, 96,
                           reduce)
    # 32-term sums taken in another order: the last bits may differ
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_gating_state_and_skip_rate_match_reference():
    cfg = gating.GatingConfig(ss_init=0.7)
    st = gating.init_state(3, cfg, device="cpu")
    jst = jgating.init_state(3, jgating.GatingConfig(ss_init=0.7))
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    st = st._replace(opened=torch.tensor([1.0, 4.0, 0.0]),
                     offered=torch.tensor([8.0, 8.0, 8.0]))
    jst = jst._replace(opened=jnp.asarray([1.0, 4.0, 0.0]),
                       offered=jnp.asarray([8.0, 8.0, 8.0]))
    assert float(gating.skip_rate(st)) == float(jgating.skip_rate(jst))


# ------------------------------------------------------------------ DSST

def test_top_k_ids_follow_jax_tie_order():
    x = _tied_scores(2, (5, 7, 16))
    x[0, 0, :4] = [-np.inf, -0.0, 0.0, -0.0]
    for k in (1, 3, 8):
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        np.testing.assert_array_equal(
            dsst._top_k_ids(torch.tensor(x), k).numpy(), want)


def test_factored_group_order_matches_reference_with_signed_zeros():
    pre = _tied_scores(3, (2, 32))
    got = dsst.factored_group_order(torch.tensor(pre), SPEC)
    for l in range(2):
        np.testing.assert_array_equal(
            got[l].numpy(),
            np.asarray(jdsst.factored_group_order(jnp.asarray(pre[l]), SPEC_J)))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_prune_regrow_same_masks_as_reference_on_ties(seed, k):
    m = _mask(seed, (2,))
    ws, gs = _tied_scores(seed, m.shape), _tied_scores(seed + 10, m.shape)
    ws = np.where(m, ws, 0.0).astype(np.float32)   # recycled units score 0
    got, gst = topology.prune_regrow_stacked(
        torch.tensor(m), torch.tensor(ws), torch.tensor(gs), SPEC, k)
    want, wst = jtopo.prune_regrow_stacked(
        jnp.asarray(m), jnp.asarray(ws), jnp.asarray(gs), SPEC_J, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(gst, wst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for l in range(2):
        one, _ = dsst.prune_regrow(torch.tensor(m[l]), torch.tensor(ws[l]),
                                   torch.tensor(gs[l]), SPEC, k)
        np.testing.assert_array_equal(one.numpy(), np.asarray(want[l]))


@pytest.mark.parametrize("k", [0, 1, 3])
def test_prune_regrow_factored_same_masks_as_reference(k):
    m = _mask(4, (2,))
    ws = np.where(m, _tied_scores(5, m.shape), 0.0).astype(np.float32)
    pre, post = _tied_scores(6, (2, 32)), np.abs(_tied_scores(7, (2, 16)))
    got, gst = topology.prune_regrow_factored_stacked(
        *map(torch.tensor, (m, ws, pre, post)), SPEC, k)
    want, wst = jtopo.prune_regrow_factored_stacked(
        *map(jnp.asarray, (m, ws, pre, post)), SPEC_J, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(gst, wst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(sp.check_unit_mask(got, SPEC))


def test_prune_regrow_rejects_k_at_n():
    m = torch.tensor(_mask(0))
    with pytest.raises(ValueError):
        dsst.prune_regrow(m, m.float(), m.float(), SPEC, SPEC.n)


@pytest.mark.parametrize("decay,start", [(1.0, 0), (0.5, 0), (0.5, 6)])
def test_schedule_methods_match_reference(decay, start):
    kw = dict(period=4, prune_frac=0.75, frac_decay=decay, start_step=start)
    port, ref = dsst.DSSTConfig(**kw), jdsst.DSSTConfig(**kw)
    spec = sp.NMSpec(n=8, m=16)
    assert port.k_levels(spec) == ref.k_levels(jsp.NMSpec(n=8, m=16))
    for step in range(40):
        assert port.k_per_group(spec, step) == \
            ref.k_per_group(jsp.NMSpec(n=8, m=16), step)
        assert port.is_update_step(step) == bool(ref.is_update_step(step))


def test_scheduled_k_apply_host_int_matches_traced_switch():
    """The port decides ``k`` on the host from the sample counter; the
    reference traces the step and picks a ``lax.switch`` branch. Over
    several epochs of a decaying schedule both give the same masks."""
    kw = dict(period=4, prune_frac=0.5, frac_decay=0.5)
    port, ref = dsst.DSSTConfig(**kw), jdsst.DSSTConfig(**kw)
    spec_j = jsp.NMSpec(n=8, m=16)
    spec = sp.NMSpec(n=8, m=16)
    assert len(ref.k_levels(spec_j)) >= 3
    m = _mask(8, (), 64, 16, spec_j)
    ws = np.where(m, _tied_scores(9, m.shape), 0.0).astype(np.float32)
    pre = _tied_scores(10, (64,))
    post = np.ones(16, np.float32)

    traced = jax.jit(lambda step: jdsst.scheduled_k_apply(
        step, ref, spec_j, lambda k: jdsst.prune_regrow_factored(
            jnp.asarray(m), jnp.asarray(ws), jnp.asarray(pre),
            jnp.asarray(post), spec_j, k)))
    ks = set()
    for step in range(3, 40, 4):                       # every epoch step
        want, wst = traced(jnp.int32(step))
        got, gst = dsst.scheduled_k_apply(
            step, port, spec, lambda k: dsst.prune_regrow_factored(
                *map(torch.tensor, (m, ws, pre, post)), spec, k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(gst.pruned) == int(wst.pruned)
        ks.add(int(gst.pruned))
    assert len(ks) >= 3                                # k really decayed
    with pytest.raises(TypeError):
        dsst.scheduled_k_apply(torch.tensor(3), port, spec, lambda k: k)


def test_accumulator_and_apply_dsst_match_reference():
    rng = np.random.default_rng(11)
    pre, post = rng.random(32).astype(np.float32), rng.random(16).astype(np.float32)
    acc = dsst.DSSTAccumulator.init(32, 16, device="cpu").update(
        torch.tensor(pre), torch.tensor(post)).update(
        torch.tensor(post.repeat(2)), torch.tensor(pre[:16]))
    jacc = jdsst.DSSTAccumulator.init(32, 16).update(pre, post).update(
        post.repeat(2), pre[:16])
    for a, b in zip(acc, jacc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    old, new = _mask(12), _mask(13)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        dsst.apply_dsst_to_weights(torch.tensor(w), torch.tensor(old),
                                   torch.tensor(new), SPEC).numpy(),
        np.asarray(jdsst.apply_dsst_to_weights(
            jnp.asarray(w), jnp.asarray(old), jnp.asarray(new), SPEC_J)))


# -------------------------------------------------------------- topology

@pytest.fixture(scope="module")
def jparams():
    return _np(jsnn.init_params(jax.random.PRNGKey(0), JCFG))


def test_from_mask_check_and_dense_masks_match_reference(jparams):
    mask = torch.tensor(jparams["hidden"]["mask"])
    topo = topology.from_mask(mask, CFG)
    jt = jtopo.from_mask(jnp.asarray(jparams["hidden"]["mask"]), JCFG)
    np.testing.assert_array_equal(topo.idx.numpy(), np.asarray(jt.idx))
    assert topology.check(topo, CFG) and jtopo.check(jt, JCFG)
    broken = mask.clone()
    broken[0, 0, 0] = ~broken[0, 0, 0]
    assert not topology.check(broken, CFG)
    np.testing.assert_array_equal(
        engine.dense_masks(mask, CFG).numpy(),
        np.asarray(jengine.dense_masks(jnp.asarray(mask.numpy()), JCFG)))
    fat = {"extra": 1, "hidden": {"w": 0, "mask": None, "scales": 2}}
    out = topology.install(topo, fat)
    assert out["extra"] == 1 and out["hidden"]["scales"] == 2
    assert out["hidden"]["mask"] is mask


def _evolved(jparams, seed=1):
    rng = np.random.default_rng(seed)
    pre = (np.abs(rng.standard_normal((2, 32))) + 0.01).astype(np.float32)
    post = (np.abs(rng.standard_normal((2, 32))) + 0.01).astype(np.float32)
    return pre, post


@pytest.mark.parametrize("step", [3, 7, 11])
def test_topology_epoch_same_masks_and_bitwise_weights(jparams, step):
    cfg = dataclasses.replace(CFG, dsst=dsst.DSSTConfig(
        period=4, prune_frac=0.75, frac_decay=0.5))
    jcfg = dataclasses.replace(JCFG, dsst=jdsst.DSSTConfig(
        period=4, prune_frac=0.75, frac_decay=0.5))
    pre, post = _evolved(jparams)
    # zero some weights so recycled-like ties on |w| = 0 appear
    jp = {**jparams, "hidden": {**jparams["hidden"],
                                "w": np.where(np.arange(32)[None, :, None] % 5
                                              == 0, 0.0,
                                              jparams["hidden"]["w"])
                                .astype(np.float32)}}
    want, wst = jtopo.topology_epoch(jax.tree_util.tree_map(jnp.asarray, jp),
                                     jnp.asarray(pre), jnp.asarray(post),
                                     jcfg, step=jnp.int32(step))
    tp = convert.params_from_numpy(jp, cfg, "cpu")
    got, gst = topology.topology_epoch(tp, torch.tensor(pre),
                                       torch.tensor(post), cfg, step=step)
    np.testing.assert_array_equal(got["hidden"]["mask"].numpy(),
                                  np.asarray(want["hidden"]["mask"]))
    np.testing.assert_array_equal(got["hidden"]["w"].numpy(),
                                  np.asarray(want["hidden"]["w"]))
    for a, b in zip(gst, wst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert topology.check(got["hidden"]["mask"], cfg)
    assert got["readout"] is tp["readout"]


def test_topology_epoch_non_uniform_geometry_matches_reference():
    kw = dict(n_in=64, n_hidden=32, n_layers=2, n_out=4, t_steps=8)
    cfg = snn.SNNConfig(**kw, dsst=dsst.DSSTConfig(period=4, prune_frac=0.5))
    jcfg = jsnn.SNNConfig(**kw, dsst=jdsst.DSSTConfig(period=4, prune_frac=0.5))
    jp = _np(jsnn.init_params(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(3)
    pre = np.abs(_tied_scores(4, (2, 64)))
    post = rng.random((2, 32)).astype(np.float32)
    want, wst = jtopo.topology_epoch(jax.tree_util.tree_map(jnp.asarray, jp),
                                     jnp.asarray(pre), jnp.asarray(post),
                                     jcfg, step=3)
    got, gst = topology.topology_epoch(convert.params_from_numpy(jp, cfg, "cpu"),
                                       torch.tensor(pre), torch.tensor(post),
                                       cfg, step=3)
    for key in ("mask", "w"):
        np.testing.assert_array_equal(got["hidden"][key].numpy(),
                                      np.asarray(want["hidden"][key]))
    for a, b in zip(gst, wst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert topology.check(got["hidden"]["mask"], cfg)


def test_kept_ids_project_deltas_and_remap_bitwise(jparams):
    pre, post = _evolved(jparams, 5)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    new, _ = jtopo.topology_epoch(jp, jnp.asarray(pre), jnp.asarray(post),
                                  JCFG, step=3)
    old_m, new_m = jparams["hidden"]["mask"], np.asarray(new["hidden"]["mask"])
    assert (old_m != new_m).any()
    for m in (old_m, new_m):
        np.testing.assert_array_equal(
            topology.stacked_kept_ids(torch.tensor(m), CFG).numpy(),
            np.asarray(jtopo.stacked_kept_ids(jnp.asarray(m), JCFG)))
    deltas = jsnn.init_stream_deltas(JCFG, 3)
    deltas = np.random.default_rng(6).standard_normal(deltas.shape) \
        .astype(np.float32)
    got = topology.project_deltas(torch.tensor(deltas), torch.tensor(old_m),
                                  torch.tensor(new_m), CFG)
    want = jtopo.project_deltas(jnp.asarray(deltas), jnp.asarray(old_m),
                                jnp.asarray(new_m), JCFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = jparams["hidden"]["w"]
    np.testing.assert_array_equal(
        topology.remap_weights(torch.tensor(w), torch.tensor(old_m),
                               torch.tensor(new_m), CFG).numpy(),
        np.asarray(jtopo.remap_weights(jnp.asarray(w), jnp.asarray(old_m),
                                       jnp.asarray(new_m), JCFG)))
    np.testing.assert_array_equal(
        topology.survivors_dense(torch.tensor(old_m), torch.tensor(new_m),
                                 CFG).numpy(),
        np.asarray(jtopo.survivors_dense(jnp.asarray(old_m),
                                         jnp.asarray(new_m), JCFG)))


def test_compact_and_densify_deltas_bitwise(jparams):
    mask = jnp.asarray(jparams["hidden"]["mask"])
    idx = jtopo.stacked_kept_ids(mask, JCFG)
    dense = np.random.default_rng(7).standard_normal((3, 2, 32, 32)) \
        .astype(np.float32)
    dense = dense * np.asarray(jengine.dense_masks(mask, JCFG))[None]
    comp_j = jengine.compact_deltas(jnp.asarray(dense), idx, JCFG)
    comp_t = engine.compact_deltas(torch.tensor(dense),
                                   torch.tensor(np.asarray(idx)), CFG)
    np.testing.assert_array_equal(comp_t.numpy(), np.asarray(comp_j))
    back = engine.densify_deltas(comp_t, torch.tensor(np.asarray(idx)), CFG)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jengine.densify_deltas(comp_j, idx, JCFG)))
    np.testing.assert_array_equal(back.numpy(), dense)
