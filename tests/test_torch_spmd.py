"""The port's SPMD context (``repro_torch.launch.spmd``), mirroring the
reference's tests/test_spmd_ctx.py: inert without a context, the forward
unchanged by the flags on one device, the flash flag routing attention;
and ``constrain_seq``'s placement of a DTensor on the production meshes (a
fake process group) against the spec the reference's ``constrain_seq``
puts into its jaxpr on an ``AbstractMesh`` of the same shape."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh

import repro.configs as JC
from repro.launch import spmd as jspmd
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch import convert
from repro_torch.launch import sharding as SH
from repro_torch.launch import spmd
from repro_torch.launch.mesh import (AbstractMesh, init_fake_group,
                                     make_host_mesh, make_production_mesh)
from repro_torch.launch.train import TrainHParams, make_train_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

torch.set_num_threads(1)


def _model(arch):
    """The reference's params (numpy) and the port's copy, tokens [2, 16]."""
    jcfg, cfg = JC.get_reduced(arch), C.get_reduced(arch)
    jparams = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    params = convert.lm_params_from_numpy(jparams, cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16))
    return jcfg, cfg, jparams, params, toks


def test_inert_without_context():
    assert spmd.current() is None
    h = torch.ones((2, 16, 8))
    assert spmd.constrain_seq(h) is h          # strict no-op by default
    with spmd.activate(make_host_mesh(device="cpu")):    # seq_shard off
        assert spmd.constrain_seq(h) is h
    assert spmd.current() is None


def test_forward_unchanged_by_flags_single_device():
    """On the 1 x 1 host mesh, ``seq_shard`` and ``loss_chunk`` change
    nothing: the forward and the step's loss equal the bare ones bit for
    bit, and both the reference's forward within 1e-5."""
    jcfg, cfg, jparams, params, toks = _model("stablelm_12b")
    a, _ = T.forward(params, cfg, tokens=torch.tensor(toks), attn="plain")
    mesh = make_host_mesh(device="cpu")
    with spmd.activate(mesh, seq_shard=True, loss_chunk=8) as ctx:
        assert ctx.dp_axes == ("data",) and spmd.current() is ctx
        b, _ = T.forward(params, cfg, tokens=torch.tensor(toks))
        h = torch.ones((2, 16, 8))
        assert spmd.constrain_seq(h) is h      # a model axis of 1
    assert torch.equal(a, b)
    ja, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    np.testing.assert_allclose(b.numpy(), np.asarray(ja), atol=1e-5,
                               rtol=1e-5)
    # the step reads loss_chunk from the context: chunked equals whole
    batch = {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)}
    step = make_train_step(cfg, TrainHParams(), attn="plain")
    whole = step.loss_and_grads(params, batch)[0]
    with spmd.activate(mesh, loss_chunk=8):
        chunked = step.loss_and_grads(params, batch)[0]
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=0)


def test_flash_flag_routes_attention(monkeypatch):
    """With ``flash_attn`` and no ``attn`` the attention goes through the
    flash route (its plain version on the CPU), once a layer; without the
    flag through the plain one; an explicit ``attn`` wins. Numerics as the
    reference's test holds them (2e-4 against its default forward)."""
    jcfg, cfg, jparams, params, toks = _model("phi3_medium_14b")
    calls = []
    orig = L.attn_full_flash

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(L, "attn_full_flash", counted)
    tok = torch.tensor(toks)
    mesh = make_host_mesh(device="cpu")
    with spmd.activate(mesh, flash_attn=True):
        b, _ = T.forward(params, cfg, tokens=tok)
        assert len(calls) == cfg.n_layers
        T.forward(params, cfg, tokens=tok, attn="plain")
        assert len(calls) == cfg.n_layers
    with spmd.activate(mesh):
        a, _ = T.forward(params, cfg, tokens=tok)
    assert len(calls) == cfg.n_layers
    T.forward(params, cfg, tokens=tok)           # no context: flash
    assert len(calls) == 2 * cfg.n_layers
    ja, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    assert float(np.abs(b.numpy() - np.asarray(ja)).max()) < 2e-4
    assert float((a - b).abs().max()) < 2e-4


def _ref_spec(shape, names, b):
    """The spec the reference's constrain_seq constrains ``[b, 64, 8]`` to
    (read off its jaxpr; a fresh function, so no trace is reused)."""
    with jspmd.activate(JAbstractMesh(shape, names), seq_shard=True):
        jp = jax.make_jaxpr(lambda h: jspmd.constrain_seq(h))(
            jax.ShapeDtypeStruct((b, 64, 8), jnp.float32))
    (eqn,) = [e for e in jp.eqns if e.primitive.name == "sharding_constraint"]
    return tuple(eqn.params["sharding"].spec)


@pytest.fixture
def fake_group():
    assert not dist.is_initialized()
    init_fake_group(512)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("b", [32, 3])
def test_constrain_seq_places_a_dtensor_as_the_reference(fake_group,
                                                         multi_pod, b):
    """A replicated DTensor ``[b, 64, 8]`` comes out placed as the
    reference's spec says (DP on B only where it divides); a plain tensor on
    a model axis of 16 is refused (the caller placed nothing: the
    parameters are placed by tree_shardings); a sequence the model axis
    does not divide passes through."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    shape, names = tuple(mesh.shape), mesh.mesh_dim_names
    h = DTensor.from_local(torch.zeros((b, 64, 8)), mesh,
                           [Replicate()] * mesh.ndim)
    with spmd.activate(mesh, seq_shard=True) as ctx:
        out = spmd.constrain_seq(h)
        want = SH.P(*_ref_spec(shape, names, b))
        assert tuple(spmd.seq_spec(ctx, b)) == tuple(want)
        assert tuple(out.placements) == SH.placements(want, mesh)
        with pytest.raises(NotImplementedError, match="tree_shardings"):
            spmd.constrain_seq(torch.zeros((b, 64, 8)))
        odd = torch.zeros((b, 60, 8))
        assert spmd.constrain_seq(odd) is odd


def test_moe_shard_map_refused_beyond_one_device():
    """``shardmap_moe`` on a mesh of one device is today's ``moe_apply``
    (the reference's shard map at one shard). On more, each rank runs the
    shard map's body (tests/test_torch_moe_shardmap.py), which an abstract
    mesh, with no process group, cannot: refused."""
    cfg = C.get_reduced("mixtral_8x7b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    tok = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab,
                                                         (2, 16)))
    a, _ = T.forward(params, cfg, tokens=tok, attn="plain")
    with spmd.activate(make_host_mesh(device="cpu"), shardmap_moe=True):
        b, _ = T.forward(params, cfg, tokens=tok, attn="plain")
    assert torch.equal(a, b)
    with spmd.activate(AbstractMesh((2, 1), ("data", "model")),
                       shardmap_moe=True):
        with pytest.raises(ValueError, match="abstract mesh"):
            T.forward(params, cfg, tokens=tok, attn="plain")
