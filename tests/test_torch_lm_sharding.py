"""The port's logical-axis placement rules (``repro_torch.launch.sharding``)
against the reference's (``repro.launch.sharding``), leaf by leaf.

For every arch of the pool at its **full** config, on the production
meshes (16 x 16 and 2 x 16 x 16), the reference's rules run on
``jax.eval_shape`` trees and a ``jax.sharding.AbstractMesh``; the port's on
``init_params_shaped`` / ``meta`` trees and its own ``AbstractMesh``.
Held equal: every leaf's path and shape (a shape of another rank would
shift the right-aligned rules), its spec under ``tree_shardings`` (params),
``opt_state_shardings`` (ZeRO-1 moments) and ``tree_shardings`` of the
moments, ``batch_shardings`` of each shape's batch, ``cache_shardings`` of
each decode shape's cache, ``logits_sharding``, and the demotions warned
(the same text). Then each leaf's local block from ``placements`` on a
``DeviceMesh`` of a fake 512-rank group (torch's own shard-shape rule)
equals the reference's ``NamedSharding.shard_shape``. Sparse variants
(compact and masked N:M on the MLP, attention and experts) and the OSSL
``local_heads`` cover the ``rows``, ``umask`` and ``local_heads/p`` rules.
"""
import logging

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

import repro.configs as JC
from repro.launch import sharding as JSH
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as C
from repro_torch.configs.base import SparsityConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import AbstractMesh, init_fake_group, \
    make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
JLOG, LOG = "repro.launch.sharding", "repro_torch.launch.sharding"


def _jcfg(arch, sparsity=None):
    cfg = JC.get_config(arch)
    return cfg.with_sparsity(JC.SparsityConfig(**sparsity)) if sparsity \
        else cfg


def _cfg(arch, sparsity=None):
    cfg = C.get_config(arch)
    return cfg.with_sparsity(SparsityConfig(**sparsity)) if sparsity else cfg


def _jpath(path) -> str:
    return JSH._path_str(path)


def _jflat(shardings, tree):
    """{path: (shape, spec)} of a reference shardings tree."""
    sh = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, JNamedSharding))[0]
    leaves = dict((_jpath(p), l) for p, l in
                  jax.tree_util.tree_flatten_with_path(tree)[0])
    return {_jpath(p): (tuple(np.shape(leaves[_jpath(p)])), tuple(s.spec))
            for p, s in sh}


def _flat(shardings, tree):
    """{path: (shape, spec)} of a port shardings tree."""
    out = {}

    def one(path, leaf):
        out[SH._path_str(path)] = leaf
    SH.tree_map_with_path(one, shardings)
    shapes = {}
    SH.tree_map_with_path(lambda p, x: shapes.__setitem__(
        SH._path_str(p), tuple(x.shape) if hasattr(x, "shape") else ()), tree)
    return {k: (shapes[k], tuple(s.spec)) for k, s in out.items()}


def _demotions(caplog, name):
    return sorted(r.getMessage() for r in caplog.records if r.name == name)


def _both(caplog, jfn, fn):
    """Run the reference's and the port's rule; (ref, port, ref
    demotions, port demotions)."""
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        j = jfn()
        jd = _demotions(caplog, JLOG)
        caplog.clear()
        t = fn()
        td = _demotions(caplog, LOG)
    return j, t, jd, td


def _ref_batch(cfg, shape):
    b, s = shape.global_batch, shape.seq_len
    lab = jax.ShapeDtypeStruct((b, s), np.int32)
    if cfg.frontend:
        return {"embeds": jax.ShapeDtypeStruct((b, s, cfg.frontend_dim),
                                               getattr(np, "float32")),
                "labels": lab}
    return {"tokens": jax.ShapeDtypeStruct((b, s), np.int32), "labels": lab}


CASES = [(a, None, False) for a in C.ARCH_IDS] + [
    ("phi3_medium_14b", dict(targets=("mlp", "attn"), mode="compact"), False),
    ("stablelm_12b", dict(targets=("mlp",), mode="masked"), True),
    ("mixtral_8x7b", dict(targets=("expert",), mode="compact"), False),
    ("mixtral_8x7b", dict(targets=("expert", "attn"), mode="masked"),
     False),
    ("mamba2_2p7b", dict(targets=("mlp",), mode="compact"), True),
]


def _case_id(case):
    arch, sp, heads = case
    return arch + ("" if sp is None else f"-{sp['mode']}") + \
        ("-heads" if heads else "")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_rules_equal_the_reference_leaf_by_leaf(caplog, case, mesh_name):
    arch, sp, heads = case
    jcfg, cfg = _jcfg(arch, sp), _cfg(arch, sp)
    jmesh = JAbstractMesh(*MESHES[mesh_name])
    mesh = AbstractMesh(*MESHES[mesh_name])
    jparams = JT.init_params_shaped(jax.random.PRNGKey(0), jcfg,
                                    local_heads=heads)
    params = T.init_params_shaped(cfg, local_heads=heads)
    jopt = jax.eval_shape(jadamw_init, jparams)
    opt = adamw_init(params)

    # params: path, shape and spec of every leaf, and the demotions
    j, t, jd, td = _both(caplog,
                         lambda: JSH.tree_shardings(jparams, jcfg, jmesh),
                         lambda: SH.tree_shardings(params, cfg, mesh))
    assert _flat(t, params) == _jflat(j, jparams)
    assert td == jd
    # the moments, replicated over DP and under ZeRO-1
    for jfn, fn in (
            (lambda: JSH.tree_shardings(jopt, jcfg, jmesh),
             lambda: SH.tree_shardings(opt, cfg, mesh)),
            (lambda: JSH.opt_state_shardings(jopt, jparams, jcfg, jmesh),
             lambda: SH.opt_state_shardings(opt, params, cfg, mesh))):
        j, t, jd, td = _both(caplog, jfn, fn)
        assert _flat(t, opt) == _jflat(j, jopt)
        assert td == jd

    for shape in C.SHAPES.values():
        b = shape.global_batch
        if shape.kind in ("train", "prefill"):
            jb, tb = _ref_batch(jcfg, shape), D.input_specs(cfg, shape)
            assert _flat(SH.batch_shardings(tb, mesh), tb) == \
                _jflat(JSH.batch_shardings(jb, jmesh), jb)
        elif C.shape_applicable(cfg, shape)[0]:
            jc = jax.eval_shape(lambda: JT.init_cache(jcfg, b,
                                                      shape.seq_len))
            tc = T.init_cache(cfg, b, shape.seq_len, device="meta")
            assert _flat(SH.cache_shardings(tc, cfg, mesh), tc) == \
                _jflat(JSH.cache_shardings(jc, jcfg, jmesh), jc)
        for with_seq in (True, False):
            assert tuple(SH.logits_sharding(mesh, b, cfg, with_seq).spec) \
                == tuple(JSH.logits_sharding(jmesh, b, jcfg, with_seq).spec)
    assert tuple(SH.replicated(mesh).spec) == \
        tuple(JSH.replicated(jmesh).spec)


@pytest.fixture(scope="module")
def fake_group():
    assert not dist.is_initialized()
    init_fake_group(512)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("case", CASES[:len(C.ARCH_IDS)], ids=_case_id)
def test_local_blocks_equal_the_reference_shard_shapes(fake_group, case):
    """Each leaf's local block under ``placements`` on a DeviceMesh (torch's
    rule for a DTensor's local shape, rank 0) and under the port's
    ``shard_shape``, against the reference's ``NamedSharding.shard_shape``:
    params, ZeRO-1 moments and the train batch, on both meshes."""
    arch, sp, heads = case
    jcfg, cfg = _jcfg(arch, sp), _cfg(arch, sp)
    jparams = JT.init_params_shaped(jax.random.PRNGKey(0), jcfg)
    params = T.init_params_shaped(cfg)
    shape = C.SHAPES["train_4k"]
    for multi in (False, True):
        name = "2x16x16" if multi else "16x16"
        jmesh = JAbstractMesh(*MESHES[name])
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        trees = (
            (SH.tree_shardings(params, cfg, mesh), params,
             JSH.tree_shardings(jparams, jcfg, jmesh), jparams),
            (SH.opt_state_shardings(params, params, cfg, mesh), params,
             JSH.opt_state_shardings(jparams, jparams, jcfg, jmesh), jparams),
            (SH.batch_shardings(D.input_specs(cfg, shape), mesh),
             D.input_specs(cfg, shape),
             JSH.batch_shardings(_ref_batch(jcfg, shape), jmesh),
             _ref_batch(jcfg, shape)))
        for t_sh, t_tree, j_sh, j_tree in trees:
            jflat = _jflat(j_sh, j_tree)
            n = 0
            for path, (shp, spec) in _flat(t_sh, t_tree).items():
                want = JNamedSharding(jmesh, JP(*jflat[path][1])).shard_shape(
                    jflat[path][0])
                local, _ = compute_local_shape_and_global_offset(
                    shp, mesh, SH.placements(SH.P(*spec), mesh))
                assert tuple(local) == tuple(want), (path, spec)
                assert SH.shard_shape(SH.P(*spec), shp, mesh) == tuple(want)
                n += 1
            assert n == len(jflat)


def test_placements_of_a_pod_data_tuple():
    """``("pod", "data")`` on one dim is a Shard of it on each of the two
    mesh dims, pod major; an axis on two dims is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh(*MESHES["2x16x16"])
    spec = SH.P(("pod", "data"), None, "model")
    assert SH.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert SH.placements(SH.P(), mesh) == (Replicate(),) * 3
    assert SH.shard_shape(spec, (64, 3, 32), mesh) == (2, 3, 2)
    with pytest.raises(ValueError, match="splits dims"):
        SH.placements(SH.P("model", "model"), mesh)
    with pytest.raises(ValueError, match="does not split"):
        SH.shard_shape(SH.P("model"), (24,), mesh)


def test_spec_slot_dim_on_lm_and_slot_meshes():
    """On an LM mesh an LM axis names no slot dim (the mesh places by its
    own axes); on a slot mesh (or None, read as one) it is refused: a slot
    mesh has no model or data axis."""
    from repro_torch.launch.mesh import make_serving_mesh
    spec = SH.P(None, "model")
    assert SH.spec_slot_dim(spec, AbstractMesh(*MESHES["16x16"])) is None
    for mesh in (None, make_serving_mesh(devices=["cpu"] * 2)):
        with pytest.raises(ValueError, match="slot mesh"):
            SH.spec_slot_dim(spec, mesh)
    assert SH.spec_slot_dim(SH.slot_spec(1)) == 1


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_demotions_warn_as_the_reference(caplog, arch):
    """The pool's full configs divide everywhere; reduced configs with a
    vocab and width of 8 mod 16 do not: the same leaves are demoted to the
    same specs, with the reference's text."""
    import dataclasses
    kw = dict(vocab=248, d_model=72)
    jcfg = dataclasses.replace(JC.get_reduced(arch), **kw)
    cfg = dataclasses.replace(C.get_reduced(arch), **kw)
    jmesh = JAbstractMesh(*MESHES["16x16"])
    mesh = AbstractMesh(*MESHES["16x16"])
    jparams = JT.init_params_shaped(jax.random.PRNGKey(0), jcfg)
    params = T.init_params_shaped(cfg)
    j, t, jd, td = _both(caplog,
                         lambda: JSH.tree_shardings(jparams, jcfg, jmesh),
                         lambda: SH.tree_shardings(params, cfg, mesh))
    assert _flat(t, params) == _jflat(j, jparams)
    assert td == jd and any("embed/tok" in m for m in td)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("zero1", [False, True])
def test_dry_run_bytes_per_device_sum_the_reference_blocks(mesh_name, zero1):
    """``dryrun.argument_bytes_per_device`` at Qwen2-VL-2B's full config
    (phase 25c's cell: B 256, S 4096): each argument leaf's bytes over the
    reference's ``NamedSharding.shard_shape`` of that leaf, summed; and
    ``lower_cell(mesh=)`` records it (reduced config, on meta)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import TrainHParams
    arch = "qwen2_vl_2b"
    jcfg, cfg = _jcfg(arch), _cfg(arch)
    jmesh = JAbstractMesh(*MESHES[mesh_name])
    mesh = AbstractMesh(*MESHES[mesh_name])
    hp = TrainHParams(zero1=zero1)
    shape = ShapeConfig("validate", 4096, 256, "train")
    parts = D.cell_arguments(cfg, shape, hp)
    jparams = JT.init_params_shaped(jax.random.PRNGKey(0), jcfg)
    jopt = jax.eval_shape(jadamw_init, jparams)
    jb = _ref_batch(jcfg, shape)
    ref = [(JSH.tree_shardings(jparams, jcfg, jmesh), jparams,
            parts["params"]),
           (JSH.opt_state_shardings(jopt, jparams, jcfg, jmesh) if zero1
            else JSH.tree_shardings(jopt, jcfg, jmesh), jopt,
            parts["opt_state"]),
           (JSH.batch_shardings(jb, jmesh), jb, parts["batch"])]
    want = sum(x.numel() * x.element_size()
               for x in D.tensors(parts["sparse_state"]))
    for j_sh, j_tree, t_tree in ref:
        jflat = _jflat(j_sh, j_tree)
        items = {}
        SH.tree_map_with_path(lambda p, x: items.__setitem__(
            SH._path_str(p), x), t_tree)
        for path, x in items.items():
            if isinstance(x, torch.Tensor):
                shp, spec = jflat[path]
                want += int(np.prod(JNamedSharding(jmesh, JP(*spec))
                                    .shard_shape(shp))) * x.element_size()
    assert D.argument_bytes_per_device(cfg, parts, hp, mesh) == want
    rec = D.lower_cell(C.get_reduced(arch), ShapeConfig("t", 16, 32, "train"),
                       hp=hp, mesh=mesh)
    assert rec["mesh"] == mesh_name and rec["n_devices"] == mesh.size()
    mem = rec["memory"]
    assert 0 < mem["argument_bytes_per_device"] < mem["argument_bytes"]
    assert mem["temp_scope"] == "one device, unsharded step"
