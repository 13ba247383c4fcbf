"""Tensor parallelism of the attention families over ``DTensor`` s
(``launch/spmd.TensorParallel``, ``launch/train``, ``models/transformer``,
``optim``), on the CPU over gloo: 2 ranks on ``(data 1, model 2)`` and 4 on
``(data 2, model 2)``.

Each mesh's ranks are spawned once (a module fixture) and run every case
below on parameters the reference drew (``jtrain.init_train_state``),
carried across by ``convert.lm_params_from_numpy`` and placed by the rules
(``launch/train.place_params``); each DP rank takes its rows of the global
batch. The tests read what the ranks wrote:

* the forward's logits, gathered over the vocab, against the reference's
  ``forward`` on one device (``rtol 1e-5`` of the largest logit: the same
  f32 products summed in two partial halves), and each rank's logits
  ``V / model`` columns wide;
* three train steps (the gate on; ZeRO-1 off and on; masked N:M with DSST;
  ``mode="local"``; sequence parallelism) against the port's 1-process step
  on the whole batch and the reference's ``make_train_step`` on one
  device: the losses within ``1e-3`` (the reference's own bound for its
  sharded step, ``tests/test_sharding_multidevice.py``), the step-0
  gradients within ``1e-4`` of each leaf's largest element (the LM
  training tolerance of ``tests/test_torch_train.py``), the params after
  the steps within ``1e-4`` relative L2 of the 1-process params and of
  the reference's (AdamW
  turns the sign of a rounding-noise gradient into a full ``lr`` step, so
  they are not held element by element), DSST masks exactly; every
  gradient in its parameter's placements, every moment of its
  parameter's local shape (ZeRO-1: its DP block), the ranks bit-identical
  on every leaf the model axis replicates and on every leaf across the DP
  axis, ZeRO-1 bit for bit the replicated update;
* the vocab-parallel cross entropy, whole and in slabs, and its gradients
  against the reference's ``lm_loss`` / ``lm_loss_chunked``;
* the sequence-parallel collectives of ``spmd.TensorParallel`` (``leave``:
  ``Partial -> Shard(1)`` as an ``all_reduce`` and a slice; ``split``;
  ``gather``) bit for bit ``DTensor.redistribute``, values and gradients;
  ``flash_attention`` refuses a ``DTensor`` (the model hands it each
  rank's own heads);
* the moe, ssm and hybrid families' steps built at a model axis above 1
  (``tests/test_torch_tp_families.py`` trains them), and the launcher
  training the moe family there.

Each spawned process runs under its own timeout.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.base import SparsityConfig as JSparsityConfig
from repro.core import gating as jgating
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.optim import optimizer as jopt
import repro_torch.configs as C
from repro_torch import convert
from repro_torch.configs.base import SparsityConfig
from repro_torch.core.gating import GatingConfig
from repro_torch.launch import spmd
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.train import (DataParallel, TrainHParams,
                                      make_train_step)
from repro_torch.optim import AdamWConfig, SparseTrainState, adamw_init

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLEET_ENV = ("COORDINATOR_ADDRESS", "PROCESS_COUNT", "PROCESS_ID")
SEQ, BATCH, STEPS = 16, 4, 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
MASKED = dict(n=2, m=4, block=8, targets=("mlp",), mode="masked")
LOSS_REL, GRAD_RTOL, PARAM_REL_L2, LOGIT_RTOL = 1e-3, 1e-4, 1e-4, 1e-5

torch.set_num_threads(1)

# name: (arch, hparams, sparsity, seq_shard, meshes); "_remat" in a name
# recomputes each block in the backward (the full configs' setting)
TRAIN_CASES = {
    "stablelm_gate_zero1": ("stablelm_12b", {"gating": True, "zero1": True},
                            None, False, (2, 4)),
    "phi3_seq_remat": ("phi3_medium_14b", {"gating": True}, None, True,
                       (2, 4)),
    "qwen_local_seq": ("qwen2_vl_2b", {"mode": "local"}, None, True, (2,)),
    "stablelm_masked_dsst": ("stablelm_12b", {"gating": True,
                                              "dsst_every": 1},
                             MASKED, False, (2, 4)),
    "musicgen_seq_zero1": ("musicgen_large", {"gating": True, "zero1": True},
                           None, True, (4,)),
}
FORWARD_ARCHS = ("stablelm_12b", "phi3_medium_14b", "qwen2_vl_2b",
                 "musicgen_large")

# one rank: argv = (spec, out dir); runs every case of the spec
WORKER = r"""
import dataclasses, json, os, sys, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch import configs as C, convert
from repro_torch.configs.base import SparsityConfig
from repro_torch.core.gating import GatingConfig
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.launch import spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import TrainHParams, make_train_step, place_params
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, SparseTrainState, adamw_init
from repro_torch.optim.optimizer import tree_map
torch.set_num_threads(1)
spec = torch.load(sys.argv[1], weights_only=False)
out_dir = sys.argv[2]
rank, world = fleet_init("cpu")
mesh = make_host_mesh(model=2, device="cpu")
dpr, dp = spmd.dp_rank(mesh), world // 2
mr = mesh.get_local_rank("model")
def cfg_of(c):
    cfg = dataclasses.replace(C.get_reduced(c["arch"]),
                              remat=c.get("remat", False))
    return cfg if c["sparsity"] is None else cfg.with_sparsity(
        SparsityConfig(**c["sparsity"]))
def mine(b):
    w = b[next(iter(b))].shape[0] // dp
    return {{k: torch.as_tensor(v[dpr * w:(dpr + 1) * w]) for k, v in b.items()}}
def local(x):
    return x.to_local().clone() if hasattr(x, "to_local") else x
def locals_(tree):
    return tree_map(lambda x: None if x is None else local(x), tree)
def placements_equal(a, b):
    return all(x is None or tuple(x.placements) == tuple(y.placements)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
from repro_torch.optim.optimizer import tree_leaves
out = {{"rank": rank, "dp_rank": dpr, "model_rank": mr}}
for c in spec["train"]:
    cfg = cfg_of(c)
    p0 = convert.lm_params_from_numpy(c["params"], cfg, "cpu")
    batches = [mine(b) for b in c["batches"]]
    rec = {{}}
    for zero1 in ((False, True) if c["hp"].get("zero1") else (False,)):
        kw = dict(c["hp"], zero1=zero1)
        gated = kw.pop("gating", False)
        hp = TrainHParams(opt=AdamWConfig(**c["opt"]),
                          gating=GatingConfig() if gated else None, **kw)
        with spmd.activate(mesh, seq_shard=c["seq"], flash_attn=True):
            step = make_train_step(cfg, hp, mesh=mesh)
            params = place_params(p0, cfg, mesh)
            opt = adamw_init(params, step.dp.zero1_layout(params))
            sparse = SparseTrainState.init(cfg.n_layers, cfg.d_model, "cpu")
            r = {{"moment_shapes": [(tuple(local(m).shape), tuple(local(p).shape))
                                   for m, p in zip(tree_leaves(opt.m),
                                                   tree_leaves(params))
                                   if p.is_floating_point()]}}
            if not zero1:
                loss, _, g = step.loss_and_grads(params, batches[0])
                r["placements_equal"] = placements_equal(g, params)
                g = step.dp.mean_grads(g)
                r["grads"] = locals_(g)
            losses = []
            for b in batches:
                params, opt, sparse, m = step(params, opt, sparse, b)
                losses.append(float(m["loss"]))
            r.update(losses=losses, params=locals_(params),
                     model_dims=tree_map(spmd.model_dim, params))
        rec[zero1] = r
    out[c["name"]] = rec
for c in spec["forward"]:
    cfg = cfg_of(c)
    params = place_params(convert.lm_params_from_numpy(c["params"], cfg, "cpu"),
                          cfg, mesh)
    with spmd.activate(mesh, seq_shard=c["seq"]):
        logits, aux = T.forward(params, cfg, attn=c["attn"],
                                **{{k: torch.as_tensor(v) for k, v in
                                    mine(c["inputs"]).items()}})
    out[c["name"]] = {{"logits": logits.to_local().detach(),
                      "global": tuple(logits.shape),
                      "model_dim": spmd.model_dim(logits),
                      "ia": aux["ia"], "pooled": aux["pooled"]}}
for c in spec["ce"]:
    tp = spmd.TensorParallel(mesh, mesh.get_group("model"), mr, 2)
    from torch.distributed.tensor import Shard
    v = c["logits"].shape[-1] // 2
    loc = torch.as_tensor(c["logits"][..., mr * v:(mr + 1) * v]).requires_grad_()
    t = torch.as_tensor(c["targets"])
    whole = T.lm_loss(tp.wrap(loc, Shard(2)), t)
    gl, = torch.autograd.grad(whole, [loc])
    h = torch.as_tensor(c["h"]).requires_grad_()
    hd = torch.as_tensor(c["head"][:, mr * v:(mr + 1) * v]).requires_grad_()
    sl = T.lm_loss_chunked(tp.wrap(h), tp.wrap(hd, Shard(1)), t, c["chunk"])
    gh, ghd = torch.autograd.grad(sl, [h, hd])
    out["ce"] = {{"whole": whole.detach(), "grad_logits": gl, "slabs": sl.detach(),
                 "grad_h": gh, "grad_head": ghd}}
for c in spec["redistribute"]:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    tp = spmd.TensorParallel(mesh, mesh.get_group("model"), mr, 2, seq=True)
    def dt(a, p):
        return DTensor.from_local(a, mesh, tp.placements(p), run_check=False)
    # op: (this rank's input, its placement, the output's, TensorParallel's)
    ops = {{"leave": (c["parts"][rank], Partial(), Shard(1), tp.leave),
            "split": (c["whole"], None, Shard(1), lambda a: tp.split(a, 1)),
            "gather": (c["whole"][:, mr * 4:(mr + 1) * 4], Shard(1), None,
                       lambda a: tp.gather(a, 1))}}
    res = {{}}
    for name, (x, src, dst, ours) in ops.items():
        got = []
        for fn in (ours, lambda a: dt(a, src).redistribute(
                mesh, tp.placements(dst)).to_local()):
            a = torch.as_tensor(x).clone().requires_grad_()
            y = fn(a)
            w = torch.as_tensor(c["weight"])[:, :y.shape[1]]
            g, = torch.autograd.grad((y * w).sum(), [a])
            got.append((y.detach(), g))
        res[name] = got
    q = dt(torch.zeros((1, 8, 2, 4)), Shard(2))
    try:
        flash_attention(q, q, q)
        refused = False
    except TypeError:
        refused = True
    out["redistribute"] = {{"ops": res, "flash_refused": refused}}
torch.save(out, os.path.join(out_dir, f"rank{{rank}}.pt"))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, args, timeout=420):
    env = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    env.update(PYTHONPATH=os.path.join(_ROOT, "src"),
               COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
               PROCESS_COUNT=str(world))
    procs = [subprocess.Popen([sys.executable] + args,
                              env=dict(env, PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, so + se[-6000:]


def _cfgs(arch, sp, remat=False):
    jc, tc = JC.get_reduced(arch), C.get_reduced(arch)
    if sp is not None:
        jc = jc.with_sparsity(JSparsityConfig(**sp))
        tc = tc.with_sparsity(SparsityConfig(**sp))
    return (dataclasses.replace(jc, remat=remat),
            dataclasses.replace(tc, remat=remat))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(cfg, rng, b=BATCH, s=SEQ):
    if cfg.frontend:
        return {"embeds": rng.standard_normal((b, s, cfg.frontend_dim))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)}


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    return [dict(_inputs(cfg, rng), labels=rng.integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int64)) for _ in range(STEPS)]


def _hps(hp):
    kw = {k: v for k, v in hp.items() if k not in ("gating", "zero1")}
    gated = hp.get("gating", False)
    return (jtrain.TrainHParams(opt=jopt.AdamWConfig(**OPT),
                                gating=jgating.GatingConfig() if gated
                                else None, **kw),
            TrainHParams(opt=AdamWConfig(**OPT),
                         gating=GatingConfig() if gated else None, **kw))


def _reference_train(jc, jhp, jp, batches):
    """The reference: step-0 loss and gradients, and STEPS jitted steps'
    losses from ``init_train_state``'s state, on one device."""
    def loss_fn(p, bt):
        logits, aux = JT.forward(p, jc, tokens=bt.get("tokens"),
                                 embeds=bt.get("embeds"),
                                 local_mode=jhp.mode == "local")
        loss = JT.lm_loss(logits, bt["labels"]) + jhp.moe_aux_weight * \
            aux["moe_aux"]
        return loss + aux["local_loss"] if jhp.mode == "local" else loss
    jb = [jax.tree.map(jnp.asarray, {k: (v.astype(np.int32) if v.dtype ==
                                         np.int64 else v)
                                     for k, v in b.items()}) for b in batches]
    loss0, g0 = jax.value_and_grad(loss_fn, allow_int=True)(jp, jb[0])
    _, jo, js = jtrain.init_train_state(jax.random.PRNGKey(0), jc, jhp)
    step = jax.jit(jtrain.make_train_step(jc, jhp))
    state, losses = (jp, jo, js), []
    for b in jb:
        *state, m = step(*state, b)
        losses.append(float(m["loss"]))
    grads = jax.tree.map(lambda g: None if g.dtype == jax.dtypes.float0
                         else np.asarray(g), g0)
    return float(loss0), grads, losses, _np(state[0])


def _port_train(tc, thp, np_params, batches):
    """The port's 1-process step on the whole batch: step-0 gradients,
    losses, params after the steps."""
    params = convert.lm_params_from_numpy(np_params, tc, "cpu")
    step = make_train_step(tc, thp, attn="flash")
    tb = [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches]
    grads = step.loss_and_grads(params, tb[0])[2]
    opt = adamw_init(params)
    sparse = SparseTrainState.init(tc.n_layers, tc.d_model, "cpu")
    losses = []
    for b in tb:
        params, opt, sparse, m = step(params, opt, sparse, b)
        losses.append(float(m["loss"]))
    return grads, losses, params


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _jflat(tree):
    return {tuple(str(getattr(p, "key", p)) for p in k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x:
                                                 x is None)[0]}


def _whole(ranks, get, dim):
    """One leaf whole from the ranks of DP index 0, in model-rank order."""
    parts = sorted(((r["model_rank"], get(r)) for r in ranks
                    if r["dp_rank"] == 0), key=lambda t: t[0])
    if dim is None:
        return parts[0][1]
    return torch.cat([p for _, p in parts], dim=dim)


_REF: dict = {}          # the one-device results, shared by both meshes


def _train_ref(name):
    if name not in _REF:
        arch, hp, sp, _, _ = TRAIN_CASES[name]
        jc, tc = _cfgs(arch, sp, "_remat" in name)
        jhp, thp = _hps(hp)
        jp = jtrain.init_train_state(jax.random.PRNGKey(0), jc, jhp)[0]
        batches = _batches(tc, 7)
        np_params = _np(jp)
        _REF[name] = dict(params=np_params, batches=batches,
                          reference=_reference_train(jc, jhp, jp, batches),
                          port=_port_train(tc, thp, np_params, batches))
    return _REF[name]


def _forward_ref(arch):
    key = ("forward", arch)
    if key not in _REF:
        jc, tc = _cfgs(arch, None)
        jp = JT.init_params(jax.random.PRNGKey(1), jc)
        inputs = _inputs(tc, np.random.default_rng(3))
        want = np.asarray(JT.forward(jp, jc, **{
            k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in inputs.items()})[0])
        _REF[key] = (_np(jp), inputs, want)
    return _REF[key]


def _run_mesh(world, tmp):
    spec = {"train": [], "forward": [], "ce": [], "redistribute": []}
    ref = {"train": {}, "forward": {}}
    for name, (arch, hp, sp, seq, meshes) in TRAIN_CASES.items():
        if world not in meshes:
            continue
        r = _train_ref(name)
        spec["train"].append(dict(name=name, arch=arch, sparsity=sp, hp=hp,
                                  remat="_remat" in name,
                                  opt=OPT, seq=seq, params=r["params"],
                                  batches=r["batches"]))
        ref["train"][name] = r
    for arch in FORWARD_ARCHS:
        np_params, inputs, want = _forward_ref(arch)
        for seq in (False, True):
            name = f"fwd_{arch}_{seq}"
            spec["forward"].append(dict(name=name, arch=arch, sparsity=None,
                                        params=np_params, inputs=inputs,
                                        seq=seq, attn="flash" if seq
                                        else "plain"))
            ref["forward"][name] = want
    rng = np.random.default_rng(11)
    b, s, d, v = 2, 16, 8, 64
    ce = dict(logits=rng.standard_normal((b, s, v)).astype(np.float32) * 3,
              targets=rng.integers(0, v, (b, s)).astype(np.int64),
              h=rng.standard_normal((b, s, d)).astype(np.float32),
              head=rng.standard_normal((d, v)).astype(np.float32), chunk=4)
    spec["ce"].append(ce)
    ref["ce"] = ce
    red = dict(parts=[rng.standard_normal((2, 8, 6)).astype(np.float32)
                      for _ in range(world)],
               whole=rng.standard_normal((2, 8, 6)).astype(np.float32),
               weight=rng.standard_normal((2, 8, 6)).astype(np.float32))
    spec["redistribute"].append(red)
    ref["redistribute"] = red
    path = os.path.join(tmp, "spec.pt")
    torch.save(spec, path)
    code = WORKER.format(src=os.path.join(_ROOT, "src"))
    _spawn(world, ["-c", code, path, tmp])
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    return ranks, ref


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    """The ranks of (data 1, model 2)."""
    return (2,) + _run_mesh(2, str(tmp_path_factory.mktemp("tp2")))


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    """The ranks of (data 2, model 2)."""
    return (4,) + _run_mesh(4, str(tmp_path_factory.mktemp("tp4")))


MESHES = [pytest.param(2, id="mesh1x2"), pytest.param(4, id="mesh2x2")]
TRAIN_RUNS = [pytest.param(w, n, id=f"mesh{w // 2}x2-{n}")
              for n, c in TRAIN_CASES.items() for w in c[4]]


def _mesh(request, world):
    return request.getfixturevalue(f"run{world}")


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _close(got, want, rtol):
    want = torch.as_tensor(np.array(want, np.float32))
    assert float((got.float() - want).abs().max()) <= \
        rtol * max(1e-30, float(want.abs().max()))


@pytest.mark.parametrize("world,name", TRAIN_RUNS)
def test_train_losses_match_one_process_and_reference(request, world, name):
    world, ranks, ref = _mesh(request, world)
    r0 = ranks[0][name][False]
    loss0, _, jlosses, _ = ref["train"][name]["reference"]
    _, plosses, _ = ref["train"][name]["port"]
    for got, want in ((r0["losses"], jlosses), (r0["losses"], plosses)):
        assert np.allclose(got, want, rtol=LOSS_REL, atol=0), (got, want)
    assert abs(jlosses[0] - loss0) <= LOSS_REL * abs(loss0)
    for r in ranks:      # every rank reads the same metrics
        assert r[name][False]["losses"] == r0["losses"]


def _check_grads(world, ranks, ref, name):
    r0 = ranks[0][name][False]
    dims = _flat(r0["model_dims"])
    got = {k: _whole(ranks, lambda r, k=k: _flat(r[name][False]["grads"])[k],
                     dims[k]) for k, g in _flat(r0["grads"]).items()
           if g is not None}
    pgrads = _flat(ref["train"][name]["port"][0])
    jgrads = _jflat(ref["train"][name]["reference"][1])
    assert got.keys() == {k for k, g in pgrads.items() if g is not None}
    for k, g in got.items():
        _close(g, pgrads[k].detach(), GRAD_RTOL)
        _close(g, jgrads[k], GRAD_RTOL)
    assert all(r[name][False]["placements_equal"] for r in ranks)


@pytest.mark.parametrize("world,name", TRAIN_RUNS)
def test_train_grads_match_and_keep_their_placements(request, world, name):
    world, ranks, ref = _mesh(request, world)
    _check_grads(world, ranks, ref, name)


@pytest.mark.parametrize("world,name", TRAIN_RUNS)
def test_train_params_moments_and_replicas(request, world, name):
    """The params after the steps against the 1-process ones; DSST masks
    exactly; moments of their parameters' local shapes; the ranks
    bit-identical where the model axis replicates a leaf, and across the
    DP axis everywhere; ZeRO-1 bit for bit."""
    world, ranks, ref = _mesh(request, world)
    r0 = ranks[0][name][False]
    dims = _flat(r0["model_dims"])
    want = _flat(ref["train"][name]["port"][2])
    jwant = _jflat(ref["train"][name]["reference"][3])
    for k, d in dims.items():
        got = _whole(ranks, lambda r, k=k: _flat(r[name][False]["params"])[k],
                     d)
        if not got.is_floating_point():
            assert torch.equal(got, want[k])
            np.testing.assert_array_equal(got.numpy(), jwant[k])
            continue
        assert _rel_l2(got, want[k]) <= PARAM_REL_L2, k
        assert _rel_l2(got, torch.as_tensor(np.array(jwant[k], np.float32))
                       ) <= PARAM_REL_L2, k
        for r in ranks:
            mine = _flat(r[name][False]["params"])[k]
            twin = [x for x in ranks if x["model_rank"] == r["model_rank"]
                    or d is None]
            for x in twin:
                assert torch.equal(_flat(x[name][False]["params"])[k], mine)
    for r in ranks:
        assert all(m == p for m, p in r[name][False]["moment_shapes"])
        if True in r[name]:
            z = r[name][True]
            assert z["losses"] == r[name][False]["losses"]
            for a, b in zip(_flat(z["params"]).values(),
                            _flat(r[name][False]["params"]).values()):
                assert torch.equal(a, b)
            split = [(m, p) for m, p in z["moment_shapes"] if m != p]
            assert (len(split) > 0) == (world > 2)
            assert all(math_prod(p) == 2 * math_prod(m) for m, p in split)


def math_prod(shape):
    n = 1
    for d in shape:
        n *= d
    return n


@pytest.mark.parametrize("world", MESHES)
@pytest.mark.parametrize("arch", FORWARD_ARCHS)
@pytest.mark.parametrize("seq", [False, True])
def test_forward_logits_are_vocab_parallel_and_match_reference(request, world,
                                                               arch, seq):
    world, ranks, ref = _mesh(request, world)
    name = f"fwd_{arch}_{seq}"
    want = ref["forward"][name]
    w = BATCH // (world // 2)
    for r in ranks:
        out = r[name]
        assert out["model_dim"] == 2
        assert out["logits"].shape[-1] == out["global"][-1] // 2
    for dp in range(world // 2):
        parts = sorted(((r["model_rank"], r[name]["logits"]) for r in ranks
                        if r["dp_rank"] == dp), key=lambda t: t[0])
        got = torch.cat([p for _, p in parts], dim=-1)
        _close(got, want[dp * w:(dp + 1) * w], LOGIT_RTOL)
    for r in ranks:         # the gating statistics whole on every rank
        twin = next(x for x in ranks if x["dp_rank"] == r["dp_rank"])
        assert torch.equal(r[name]["ia"], twin[name]["ia"])
        assert torch.equal(r[name]["pooled"], twin[name]["pooled"])


@pytest.mark.parametrize("world", MESHES)
def test_vocab_parallel_cross_entropy_matches_reference(request, world):
    world, ranks, ref = _mesh(request, world)
    c = ref["ce"]
    logits, t = jnp.asarray(c["logits"]), jnp.asarray(c["targets"])
    whole, gl = jax.value_and_grad(JT.lm_loss)(logits, t)
    sl, (gh, ghd) = jax.value_and_grad(JT.lm_loss_chunked, argnums=(0, 1))(
        jnp.asarray(c["h"]), jnp.asarray(c["head"]), t, c["chunk"])
    v = c["logits"].shape[-1] // 2
    for r in ranks:
        o, m = r["ce"], r["model_rank"]
        _close(o["whole"], whole, 1e-6)
        _close(o["slabs"], sl, 1e-6)
        _close(o["grad_logits"], np.asarray(gl)[..., m * v:(m + 1) * v], 1e-5)
        _close(o["grad_h"], gh, 1e-5)
        _close(o["grad_head"], np.asarray(ghd)[:, m * v:(m + 1) * v], 1e-5)


@pytest.mark.parametrize("world", MESHES)
@pytest.mark.parametrize("op", ["leave", "split", "gather"])
def test_sequence_parallel_collectives_match_dtensor_redistribute(
        request, world, op):
    """``TensorParallel``'s gloo-safe collectives at the sequence-parallel
    boundaries ≡ ``DTensor.redistribute`` between the same placements, bit
    for bit, values and gradients; ``leave`` on (data 1, model 2) is the
    sum of the ranks' parts, this rank's half of the sequence."""
    world, ranks, ref = _mesh(request, world)
    for r in ranks:
        (y, g), (y_dt, g_dt) = r["redistribute"]["ops"][op]
        assert torch.equal(y, y_dt) and torch.equal(g, g_dt)
    if op == "leave" and world == 2:
        total = sum(torch.as_tensor(p) for p in ref["redistribute"]["parts"])
        got = torch.cat([r["redistribute"]["ops"]["leave"][0][0] for r in
                         sorted(ranks, key=lambda r: r["model_rank"])], 1)
        assert torch.equal(got, total)


@pytest.mark.parametrize("world", MESHES)
def test_flash_attention_refuses_dtensors(request, world):
    """The kernels take raw pointers: under tensor parallelism the model
    hands the op each rank's own heads, and a ``DTensor`` raises."""
    world, ranks, _ = _mesh(request, world)
    assert all(r["redistribute"]["flash_refused"] for r in ranks)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "moonshot_v1_16b_a3b",
                                  "mamba2_2p7b", "zamba2_1p2b"])
def test_other_families_at_a_model_axis_are_refused(arch):
    """These families were refused at a model axis above 1 until slice 19;
    now the same calls build their data- and tensor-parallel steps (they
    train in ``tests/test_torch_tp_families.py``), and no family check is
    left to refuse them."""
    cfg = C.get_reduced(arch)
    mesh = AbstractMesh((1, 2), ("data", "model"))
    dp = DataParallel(mesh, cfg, TrainHParams())
    assert dp.size == 1 and dp.groups == [] and not dp.zero1
    assert not hasattr(spmd, "check_tp_family")
    make_train_step(cfg, TrainHParams(), mesh=mesh)
    make_train_step(cfg, TrainHParams(), mesh=AbstractMesh(
        (1, 1), ("data", "model")))
    assert dataclasses.is_dataclass(cfg)


# launch_train on a "production" mesh of 2 ranks: the production mesh
# constructor and the config registry swapped for a (data 1, model 2) host
# mesh and the reduced config, so that the launcher's tensor-parallel path
# runs here
LAUNCHER = r"""
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch import configs as C
from repro_torch.launch import launcher, mesh
full = C.get_config
C.get_config = lambda name: C.make_reduced(full(name))
mesh.make_production_mesh = lambda multi_pod=False, device=None: \
    mesh.make_host_mesh(model=2, device="cpu")
try:
    launcher.launch_train(sys.argv[1], multi_pod=False, opt="zero1,seq,flash",
                          steps=2, seq_len=16, global_batch=4, ckpt_dir=None,
                          validate_only=False, device="cpu", backend="gloo")
except NotImplementedError as e:
    print("refused:", e)
finally:
    import torch.distributed as dist
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["stablelm_12b", "moonshot_v1_16b_a3b"])
def test_launch_train_on_a_model_axis(arch, tmp_path):
    """The launcher trains an attention family and the moe family on a mesh
    whose model axis is 2 (rank 0 prints its loss; the moe family was
    refused there until slice 19)."""
    outs = []
    env = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    env.update(PYTHONPATH=os.path.join(_ROOT, "src"),
               COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
               PROCESS_COUNT="2")
    code = LAUNCHER.format(src=os.path.join(_ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code, arch],
                              env=dict(env, PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    assert "mesh={'data': 1, 'model': 2}" in outs[0][0]
    assert "step 0 loss" in outs[0][0] and "refused" not in outs[0][0]
    assert not any("refused" in o for o, _ in outs)
