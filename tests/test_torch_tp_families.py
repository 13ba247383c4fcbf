"""Tensor parallelism of the moe, ssm and hybrid families over ``DTensor`` s,
and the MoE dispatch over the global batch (``models/mamba2``'s mixer,
``models/moe``, ``models/transformer``, ``launch/train``,
``launch/serve``), on the CPU over gloo: 2 ranks on ``(data 1, model 2)``,
4 on ``(data 2, model 2)`` and 2 on ``(data 2, model 1)``.

Each mesh's ranks are spawned once (a module fixture) and run every case
below on parameters the reference drew, carried across by
``convert.lm_params_from_numpy`` and placed by the rules
(``launch/train.place_params``; at a model axis of 1 nothing is placed);
each DP rank takes its rows of the global batch. The tests read what the
ranks wrote:

* three train steps of reduced Mamba2, Zamba2, Moonlight (EP) and Mixtral
  (TP inside the experts), dense and masked N:M (DSST every step), with
  ``seq_shard`` on and off, against the port's 1-process step on the
  whole batch and the reference's one-device ``make_train_step``: the
  losses within ``1e-3``, the step-0 gradients within ``1e-4`` of each
  leaf's largest element, the params after the steps within ``1e-4``
  relative L2, DSST masks exactly (phase 27's CPU bounds,
  ``tests/test_torch_tp.py``); every gradient in its parameter's
  placements, the ranks bit-identical where a leaf replicates, ZeRO-1 bit
  for bit the replicated update. The reference's ``make_train_step``
  cannot take masked experts (``tests/test_torch_train.py``): those cases
  hold its loss and gradients, and the port's 1-process steps;
* at a DP size of 1 the MoE under ``shardmap_moe`` bit for bit the MoE
  without it (one function there);
* the global-batch dispatch at ``(data 2, model 1)``: the DP step of
  Moonlight and Mixtral, each rank on its half, against the reference's
  one-device step on the whole batch (one capacity, slots in global batch
  order, ``moe_dropped`` the global batch's);
* ``forward``'s vocab-parallel logits against the reference's (``1e-5`` of
  the largest logit), compact experts under ``shardmap_moe`` included
  (they take the plain dispatch);
* ``prefill``, ``decode_step`` and greedy ``generate`` against the
  reference's on the whole batch (``1e-5``; the tokens equal), with every
  cache leaf placed as ``cache_shardings`` places it.

Each spawned process runs under its own timeout.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import repro.configs as JC  # noqa: E402
from repro.configs.base import SparsityConfig as JSparsityConfig  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.configs as C  # noqa: E402
from repro_torch.configs.base import SparsityConfig  # noqa: E402
from test_torch_tp import (_FLEET_ENV, OPT, _close, _flat,  # noqa: E402
                           _free_port, _hps, _jflat, _np, _port_train,
                           _rel_l2, _whole)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, STEPS, PROMPT, NEW = 16, 4, 3, 16, 6
MASKED = dict(n=2, m=4, block=8, targets=("mlp",), mode="masked")
MASKED_EXPERTS = dict(MASKED, targets=("expert",))
COMPACT_EXPERTS = dict(MASKED, targets=("expert",), mode="compact")
LOSS_REL, GRAD_RTOL, PARAM_REL_L2, LOGIT_RTOL = 1e-3, 1e-4, 1e-4, 1e-5
MESHES = {"1x2": (2, 2), "2x2": (4, 2), "2x1": (2, 1)}   # id: (world, model)

torch.set_num_threads(1)

# name: (arch, hparams, sparsity, seq_shard, shardmap_moe, meshes)
TRAIN_CASES = {
    "mamba2_gate": ("mamba2_2p7b", {"gating": True}, None, False, False,
                    ("1x2", "2x2")),
    "mamba2_masked_dsst_seq": ("mamba2_2p7b", {"dsst_every": 1,
                                               "zero1": True},
                               MASKED, True, False, ("1x2", "2x2")),
    "zamba2_gate_seq_zero1": ("zamba2_1p2b", {"gating": True, "zero1": True},
                              None, True, False, ("1x2", "2x2")),
    "moonshot_ep_gate_zero1": ("moonshot_v1_16b_a3b", {"gating": True,
                                                       "zero1": True},
                               None, False, False, ("1x2", "2x2", "2x1")),
    "moonshot_ep_shardmap": ("moonshot_v1_16b_a3b", {"gating": True}, None,
                             False, True, ("1x2",)),
    "moonshot_ep_masked_seq": ("moonshot_v1_16b_a3b", {"dsst_every": 1},
                               MASKED_EXPERTS, True, False, ("1x2", "2x2")),
    "mixtral_tp_seq_zero1": ("mixtral_8x7b", {"gating": True, "zero1": True},
                             None, True, False, ("1x2", "2x2", "2x1")),
    "mixtral_tp_shardmap_seq": ("mixtral_8x7b", {"gating": True}, None, True,
                                True, ("1x2",)),
    "mixtral_tp_masked": ("mixtral_8x7b", {"dsst_every": 1}, MASKED_EXPERTS,
                          False, False, ("1x2",)),
}
# the shard-mapped case and its plain twin (the same params and batches)
SHARDMAP_TWINS = {"moonshot_ep_shardmap": "moonshot_ep_gate_zero1",
                  "mixtral_tp_shardmap_seq": "mixtral_tp_seq_zero1"}
# name: (arch, sparsity, seq_shard, shardmap_moe)
FORWARD_CASES = {
    "mamba2": ("mamba2_2p7b", None, False, False),
    "mamba2_seq": ("mamba2_2p7b", None, True, False),
    "zamba2": ("zamba2_1p2b", None, False, False),
    "zamba2_seq": ("zamba2_1p2b", None, True, False),
    "moonshot": ("moonshot_v1_16b_a3b", None, False, False),
    "mixtral_seq": ("mixtral_8x7b", None, True, False),
    "moonshot_compact_shardmap": ("moonshot_v1_16b_a3b", COMPACT_EXPERTS,
                                  False, True),
    "mixtral_compact_shardmap": ("mixtral_8x7b", COMPACT_EXPERTS, False,
                                 True),
}
# name: (arch, seq_shard in the prefill); max_seq PROMPT + NEW
SERVE_CASES = {
    "mamba2": ("mamba2_2p7b", False),
    "zamba2_seq": ("zamba2_1p2b", True),
    "moonshot": ("moonshot_v1_16b_a3b", False),
    "mixtral": ("mixtral_8x7b", False),
}
# the dim each placed cache leaf splits over the model axis
CACHE_DIMS = {"mamba2": {"ssm": 3, "conv": 3},
              "zamba2_seq": {"ssm": 3, "conv": 3, "shared_k": 2,
                             "shared_v": 2},
              "moonshot": {"k": 2, "v": 2}, "mixtral": {"k": 2, "v": 2}}

# one rank: argv = (spec, out dir); runs every case of the spec
WORKER = r"""
import dataclasses, os, sys, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch import configs as C, convert
from repro_torch.configs.base import SparsityConfig
from repro_torch.core.gating import GatingConfig
from repro_torch.launch import sharding as SH, spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import generate
from repro_torch.launch.train import TrainHParams, make_train_step, place_params
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, SparseTrainState, adamw_init
from repro_torch.optim.optimizer import tree_leaves, tree_map
torch.set_num_threads(1)
spec = torch.load(sys.argv[1], weights_only=False)
out_dir = sys.argv[2]
rank, world = fleet_init("cpu")
mesh = make_host_mesh(model=spec["model"], device="cpu")
dpr, dp = spmd.dp_rank(mesh), world // spec["model"]
mr = mesh.get_local_rank("model")
placed = spec["model"] > 1
def cfg_of(c):
    cfg = C.get_reduced(c["arch"])
    return cfg if c["sparsity"] is None else cfg.with_sparsity(
        SparsityConfig(**c["sparsity"]))
def mine(b):
    w = b[next(iter(b))].shape[0] // dp
    return {{k: torch.as_tensor(v[dpr * w:(dpr + 1) * w]) for k, v in b.items()}}
def local(x):
    return (x.to_local() if hasattr(x, "to_local") else x).clone()
def locals_(tree):
    return tree_map(lambda x: None if x is None else local(x), tree)
def place(p, cfg):
    # the step updates its params in place: each run starts from a copy
    return place_params(p, cfg, mesh) if placed else tree_map(
        lambda x: x.clone(), p)
def placements_equal(a, b):
    return all(x is None or not hasattr(y, "placements")
               or tuple(x.placements) == tuple(y.placements)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
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
        with spmd.activate(mesh, seq_shard=c["seq"], flash_attn=True,
                           shardmap_moe=c["shardmap"]):
            step = make_train_step(cfg, hp, mesh=mesh)
            params = place(p0, cfg)
            opt = adamw_init(params, step.dp.zero1_layout(params))
            sparse = SparseTrainState.init(cfg.n_layers, cfg.d_model, "cpu")
            r = {{}}
            if not zero1:
                loss, (ce, aux), g = step.loss_and_grads(params, batches[0])
                r["placements_equal"] = placements_equal(g, params)
                r["moe_dropped"] = float(aux["moe_dropped"])
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
    params = place(convert.lm_params_from_numpy(c["params"], cfg, "cpu"), cfg)
    with torch.no_grad(), spmd.activate(mesh, seq_shard=c["seq"],
                                        shardmap_moe=c["shardmap"]):
        logits, aux = T.forward(params, cfg, attn="flash",
                                tokens=mine(c["inputs"])["tokens"])
    out[c["name"]] = {{"logits": logits.to_local(),
                      "model_dim": spmd.model_dim(logits),
                      "moe_dropped": float(aux["moe_dropped"])}}
for c in spec["serve"]:
    cfg = cfg_of(c)
    params = place(convert.lm_params_from_numpy(c["params"], cfg, "cpu"), cfg)
    prompt = mine({{"p": c["prompt"]}})["p"]
    with torch.no_grad(), spmd.activate(mesh, seq_shard=c["seq"]):
        logits, cache = T.prefill(params, cfg, prompt, c["max_seq"],
                                  attn="flash")
        tp = spmd.tensor_parallel(logits)
        steps, toks = [logits.to_local()], []
        for i in range({new}):
            tok = spmd.vocab_argmax(logits.to_local(), tp)
            toks.append(tok)
            logits, cache = T.decode_step(params, cache, tok, cfg)
            steps.append(logits.to_local())
        greedy = generate(params, cfg, prompt, {new}, max_seq=c["max_seq"])
    leaves = {{k: v for k, v in cache.items() if k != "pos"}}
    meta = {{k: torch.empty(v.shape, device="meta") for k, v in leaves.items()}}
    want = SH.cache_shardings(meta, cfg, mesh)
    out["serve_" + c["name"]] = {{
        "logits": steps, "tokens": torch.stack(toks, 1), "greedy": greedy,
        "placements_equal": all(tuple(v.placements) == SH.placements(
            want[k].spec, mesh) for k, v in leaves.items()),
        "cache_dims": {{k: spmd.model_dim(v) for k, v in leaves.items()}}}}
torch.save(out, os.path.join(out_dir, f"rank{{rank}}.pt"))
dist.destroy_process_group()
"""


def _cfgs(arch, sp):
    jc, tc = JC.get_reduced(arch), C.get_reduced(arch)
    if sp is not None:
        jc = jc.with_sparsity(JSparsityConfig(**sp))
        tc = tc.with_sparsity(SparsityConfig(**sp))
    return jc, tc


def _jb(b):
    return {k: jnp.asarray(v.astype(np.int32)) for k, v in b.items()}


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (BATCH, SEQ)),
             "labels": rng.integers(0, cfg.vocab, (BATCH, SEQ))}
            for _ in range(STEPS)]


def _masked_experts(sp):
    return sp is not None and "expert" in sp["targets"]


def _reference_train(jc, jhp, jp, batches, steps: bool):
    """The reference on one device: the step-0 loss, gradients and
    ``moe_dropped``; with ``steps``, STEPS jitted ``make_train_step``
    steps' losses and params."""
    def loss_fn(p, bt):
        logits, aux = JT.forward(p, jc, tokens=bt["tokens"])
        return JT.lm_loss(logits, bt["labels"]) + jhp.moe_aux_weight * \
            aux["moe_aux"], aux
    jb = [_jb(b) for b in batches]
    (loss0, aux0), g0 = jax.value_and_grad(loss_fn, has_aux=True,
                                           allow_int=True)(jp, jb[0])
    grads = jax.tree.map(lambda g: None if g.dtype == jax.dtypes.float0
                         else np.asarray(g), g0)
    losses, params = None, None
    if steps:
        _, jo, js = jtrain.init_train_state(jax.random.PRNGKey(0), jc, jhp)
        step = jax.jit(jtrain.make_train_step(jc, jhp))
        state, losses = (jp, jo, js), []
        for b in jb:
            *state, m = step(*state, b)
            losses.append(float(m["loss"]))
        params = _np(state[0])
    return dict(loss0=float(loss0), grads=grads, losses=losses,
                params=params, moe_dropped=float(aux0["moe_dropped"]))


_REF: dict = {}          # the one-device results, shared by the meshes


def _train_key(name):
    """Cases that differ only in ZeRO-1 or ``shardmap_moe`` share their
    one-device runs (neither changes the function)."""
    arch, hp, sp, _, _, _ = TRAIN_CASES[name]
    return ("train", arch, tuple(sorted((k, v) for k, v in hp.items()
                                        if k != "zero1")), str(sp))


def _train_inputs(name):
    """The reference's initial params (numpy) and the batches."""
    key = _train_key(name) + ("inputs",)
    if key not in _REF:
        arch, hp, sp, _, _, _ = TRAIN_CASES[name]
        jc, tc = _cfgs(arch, sp)
        jhp, _ = _hps(hp)
        jp = jtrain.init_train_state(jax.random.PRNGKey(0), jc, jhp)[0]
        _REF[key] = (_np(jp), _batches(tc, 7))
    return _REF[key]


def _train_ref(name):
    key = _train_key(name)
    if key not in _REF:
        arch, hp, sp, _, _, _ = TRAIN_CASES[name]
        jc, tc = _cfgs(arch, sp)
        jhp, thp = _hps(hp)
        np_params, batches = _train_inputs(name)
        jp = jax.tree.map(jnp.asarray, np_params)
        _REF[key] = dict(
            port=_port_train(tc, thp, np_params, batches),
            reference=_reference_train(jc, jhp, jp, batches,
                                       not _masked_experts(sp)))
    return _REF[key]


def _forward_inputs(name):
    key = ("forward", name)
    if key not in _REF:
        arch, sp, _, _ = FORWARD_CASES[name]
        jc, tc = _cfgs(arch, sp)
        _REF[key] = (_np(JT.init_params(jax.random.PRNGKey(1), jc)),
                     _inputs(tc))
    return _REF[key]


def _inputs(cfg, seed=3):
    return {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, SEQ))}


def _forward_ref(name):
    """The reference's logits and ``moe_dropped`` on the whole batch."""
    key = ("forward_ref", name)
    if key not in _REF:
        arch, sp, _, _ = FORWARD_CASES[name]
        jc, _ = _cfgs(arch, sp)
        np_params, inputs = _forward_inputs(name)
        logits, aux = JT.forward(jax.tree.map(jnp.asarray, np_params), jc,
                                 **_jb(inputs))
        _REF[key] = (np.asarray(logits), float(aux["moe_dropped"]))
    return _REF[key]


def _serve_inputs(name):
    key = ("serve", name)
    if key not in _REF:
        jc, tc = _cfgs(SERVE_CASES[name][0], None)
        _REF[key] = (_np(JT.init_params(jax.random.PRNGKey(2), jc)),
                     np.random.default_rng(5).integers(0, tc.vocab,
                                                       (BATCH, PROMPT)))
    return _REF[key]


def _serve_ref(name):
    """The reference's prefill and greedy decode steps on one device, on
    the whole batch: every step's logits and the tokens (its ``generate``
    is this loop: ``tests/test_torch_lm.py``)."""
    key = ("serve_ref", name)
    if key not in _REF:
        jc, _ = _cfgs(SERVE_CASES[name][0], None)
        np_params, prompt = _serve_inputs(name)
        jp = jax.tree.map(jnp.asarray, np_params)
        logits, cache = JT.prefill(jp, jc, jnp.asarray(prompt.astype(np.int32)),
                                   PROMPT + NEW)
        steps, toks = [np.asarray(logits)], []
        for _ in range(NEW):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            logits, cache = JT.decode_step(jp, cache, tok, jc)
            steps.append(np.asarray(logits))
        _REF[key] = (steps, np.stack(toks, 1))
    return _REF[key]


def _start_mesh(mesh_id, tmp):
    """Spawn a mesh's ranks on every case that runs there (they run while
    the test process computes the one-device runs)."""
    world, model = MESHES[mesh_id]
    spec = {"model": model, "train": [], "forward": [], "serve": []}
    for name, (arch, hp, sp, seq, sm, meshes) in TRAIN_CASES.items():
        if mesh_id in meshes:
            np_params, batches = _train_inputs(name)
            spec["train"].append(dict(name=name, arch=arch, sparsity=sp,
                                      hp=hp, opt=OPT, seq=seq, shardmap=sm,
                                      params=np_params, batches=batches))
    if model > 1:
        for name, (arch, sp, seq, sm) in FORWARD_CASES.items():
            np_params, inputs = _forward_inputs(name)
            spec["forward"].append(dict(name=name, arch=arch, sparsity=sp,
                                        seq=seq, shardmap=sm,
                                        params=np_params, inputs=inputs))
        for name, (arch, seq) in SERVE_CASES.items():
            np_params, prompt = _serve_inputs(name)
            spec["serve"].append(dict(name=name, arch=arch, sparsity=None,
                                      seq=seq, params=np_params,
                                      prompt=prompt, max_seq=PROMPT + NEW))
    path = os.path.join(tmp, "spec.pt")
    torch.save(spec, path)
    code = WORKER.format(src=os.path.join(_ROOT, "src"), new=NEW)
    env = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    env.update(PYTHONPATH=os.path.join(_ROOT, "src"),
               COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
               PROCESS_COUNT=str(world))
    return [subprocess.Popen([sys.executable, "-c", code, path, tmp],
                             env=dict(env, PROCESS_ID=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(world)]


def _finish(procs, tmp, deadline):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline -
                                                  time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, so + se[-6000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The ranks of every mesh: all spawned at once, then the one-device
    runs computed here while they run; each process under a timeout."""
    deadline = time.monotonic() + 420
    started = {}
    try:
        for m in MESHES:
            tmp = str(tmp_path_factory.mktemp(f"tp{m}"))
            started[m] = (_start_mesh(m, tmp), tmp)
        for name in TRAIN_CASES:
            _train_ref(name)
        for name in FORWARD_CASES:
            _forward_ref(name)
        for name in SERVE_CASES:
            _serve_ref(name)
        return {m: _finish(procs, tmp, deadline)
                for m, (procs, tmp) in started.items()}
    finally:
        for procs, _ in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


TRAIN_RUNS = [pytest.param(m, n, id=f"mesh{m}-{n}")
              for n, c in TRAIN_CASES.items() for m in c[5]]
TP_MESHES = [pytest.param(m, id=f"mesh{m}") for m in ("1x2", "2x2")]


@pytest.mark.parametrize("mesh_id,name", TRAIN_RUNS)
def test_train_losses_match_one_process_and_reference(meshes, mesh_id, name):
    ranks = meshes[mesh_id]
    r0 = ranks[0][name][False]
    ref = _train_ref(name)
    _, plosses, _ = ref["port"]
    jref = ref["reference"]
    wants = [plosses] + ([jref["losses"]] if jref["losses"] else [])
    for want in wants:
        assert np.allclose(r0["losses"], want, rtol=LOSS_REL, atol=0), \
            (r0["losses"], want)
    assert abs(r0["losses"][0] - jref["loss0"]) <= LOSS_REL * abs(
        jref["loss0"])
    # the global batch's drops, the same on every rank
    assert abs(r0["moe_dropped"] - jref["moe_dropped"]) <= 1e-6
    for r in ranks:
        assert r[name][False]["losses"] == r0["losses"]
        assert r[name][False]["moe_dropped"] == r0["moe_dropped"]


@pytest.mark.parametrize("mesh_id,name", TRAIN_RUNS)
def test_train_grads_match_and_keep_their_placements(meshes, mesh_id, name):
    ranks = meshes[mesh_id]
    r0 = ranks[0][name][False]
    dims = _flat(r0["model_dims"])
    got = {k: _whole(ranks, lambda r, k=k: _flat(r[name][False]["grads"])[k],
                     dims[k]) for k, g in _flat(r0["grads"]).items()
           if g is not None}
    pgrads = _flat(_train_ref(name)["port"][0])
    jgrads = _jflat(_train_ref(name)["reference"]["grads"])
    assert got.keys() == {k for k, g in pgrads.items() if g is not None}
    for k, g in got.items():
        _close(g, pgrads[k].detach(), GRAD_RTOL)
        _close(g, jgrads[k], GRAD_RTOL)
    assert all(r[name][False]["placements_equal"] for r in ranks)


@pytest.mark.parametrize("mesh_id,name", TRAIN_RUNS)
def test_train_params_and_replicas(meshes, mesh_id, name):
    """The params after the steps against the 1-process ones (and the
    reference's where it steps); DSST masks exactly; the ranks
    bit-identical where the model axis replicates a leaf and across the DP
    axis everywhere; ZeRO-1 bit for bit."""
    ranks = meshes[mesh_id]
    r0 = ranks[0][name][False]
    dims = _flat(r0["model_dims"])
    want = _flat(_train_ref(name)["port"][2])
    jparams = _train_ref(name)["reference"]["params"]
    jwant = _jflat(jparams) if jparams is not None else None
    for k, d in dims.items():
        got = _whole(ranks, lambda r, k=k: _flat(r[name][False]["params"])[k],
                     d)
        if not got.is_floating_point():
            assert torch.equal(got, want[k]), k
            continue
        assert _rel_l2(got, want[k]) <= PARAM_REL_L2, k
        if jwant is not None:
            assert _rel_l2(got, torch.as_tensor(np.array(jwant[k], np.float32))
                           ) <= PARAM_REL_L2, k
        for r in ranks:
            mine = _flat(r[name][False]["params"])[k]
            for x in ranks:
                if x["model_rank"] == r["model_rank"] or d is None:
                    assert torch.equal(_flat(x[name][False]["params"])[k],
                                       mine), k
    for r in ranks:
        if True in r[name]:
            z = r[name][True]
            assert z["losses"] == r[name][False]["losses"]
            for a, b in zip(_flat(z["params"]).values(),
                            _flat(r[name][False]["params"]).values()):
                assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SHARDMAP_TWINS))
def test_shardmap_moe_at_one_dp_rank_is_the_plain_dispatch(meshes, name):
    """At a DP size of 1 the shard-mapped MoE and the one without it are
    one function: losses, gradients and params bit for bit."""
    ranks = meshes["1x2"]
    twin = SHARDMAP_TWINS[name]
    for r in ranks:
        a, b = r[name][False], r[twin][False]
        assert a["losses"] == b["losses"]
        assert a["moe_dropped"] == b["moe_dropped"]
        for tree in ("grads", "params"):
            fa, fb = _flat(a[tree]), _flat(b[tree])
            assert fa.keys() == fb.keys()
            for k in fa:
                assert (fa[k] is None and fb[k] is None) or \
                    torch.equal(fa[k], fb[k]), (tree, k)


@pytest.mark.parametrize("mesh_id", TP_MESHES)
@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_logits_are_vocab_parallel_and_match_reference(meshes, mesh_id,
                                                               name):
    ranks = meshes[mesh_id]
    world, model = MESHES[mesh_id]
    want, dropped = _forward_ref(name)
    w = BATCH // (world // model)
    for dp in range(world // model):
        parts = sorted(((r["model_rank"], r[name]["logits"]) for r in ranks
                        if r["dp_rank"] == dp), key=lambda t: t[0])
        got = torch.cat([p for _, p in parts], dim=-1)
        _close(got, want[dp * w:(dp + 1) * w], LOGIT_RTOL)
    for r in ranks:
        assert r[name]["model_dim"] == 2
        assert r[name]["logits"].shape[-1] == want.shape[-1] // model
        if not FORWARD_CASES[name][3]:      # the global batch's drops
            assert abs(r[name]["moe_dropped"] - dropped) <= 1e-6


@pytest.mark.parametrize("mesh_id", TP_MESHES)
@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_prefill_decode_and_generate_match_reference(meshes, mesh_id, name):
    """Every step's logits, gathered over the vocab, against the
    reference's on the rank's rows; the greedy tokens (step by step and
    ``generate``'s) equal to its; every cache leaf placed by
    ``cache_shardings``."""
    ranks = meshes[mesh_id]
    world, model = MESHES[mesh_id]
    steps, toks = _serve_ref(name)
    w = BATCH // (world // model)
    key = "serve_" + name
    for dp in range(world // model):
        mine = sorted((r for r in ranks if r["dp_rank"] == dp),
                      key=lambda r: r["model_rank"])
        rows = slice(dp * w, (dp + 1) * w)
        for i, want in enumerate(steps):
            got = torch.cat([r[key]["logits"][i] for r in mine], dim=-1)
            _close(got, want[rows], LOGIT_RTOL)
        for r in mine:
            assert torch.equal(r[key]["tokens"],
                               torch.as_tensor(toks[rows], dtype=torch.long))
            assert torch.equal(r[key]["greedy"][:, PROMPT:],
                               torch.as_tensor(toks[rows], dtype=torch.long))
    for r in ranks:
        assert r[key]["placements_equal"]
        assert r[key]["cache_dims"] == CACHE_DIMS[name]


def test_the_model_axis_splits_every_family_as_the_rules_do(meshes):
    """The leaves the TP step splits, on (data 1, model 2): the mixer's
    projections, conv and gated norm, the experts (EP on E, TP inside on
    F), each to its rule's dim; ``a_log``, ``d_skip``, ``dt_bias``, the
    router and the masks replicate."""
    ranks = meshes["1x2"]
    want = {
        "mamba2_gate": {("layers", "mixer", "in_proj", "w"): 2,
                        ("layers", "mixer", "out_proj", "w"): 1,
                        ("layers", "mixer", "conv_w"): 2,
                        ("layers", "mixer", "conv_b"): 1,
                        ("layers", "mixer", "norm_g"): 1,
                        ("layers", "mixer", "a_log"): None,
                        ("layers", "mixer", "d_skip"): None,
                        ("layers", "mixer", "dt_bias"): None},
        "moonshot_ep_masked_seq": {("layers", "moe", "w1", "w"): 1,
                                   ("layers", "moe", "w2", "w"): 1,
                                   ("layers", "moe", "w1", "umask"): None,
                                   ("layers", "moe", "router"): None},
        "mixtral_tp_masked": {("layers", "moe", "w1", "w"): 3,
                              ("layers", "moe", "w2", "w"): 2,
                              ("layers", "moe", "w3", "w"): 3},
        "zamba2_gate_seq_zero1": {("shared", "attn", "wq", "w"): 1,
                            ("shared", "mlp", "w2", "w"): 0},
    }
    for name, dims in want.items():
        got = _flat(ranks[0][name][False]["model_dims"])
        for k, d in dims.items():
            assert got[k] == d, (name, k)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "mixtral_8x7b"])
@pytest.mark.parametrize("dp", [2, 4])
def test_the_global_dispatch_buffers_only_this_ranks_rows(arch, dp):
    """``moe._own_runs`` on each DP rank's share of the one-device
    dispatch of the whole batch: the same choices kept, each expert's rows
    packed from 0 in global slot order, ``C_buf`` the longest run rounded
    up to 8, and the expert FFN's row of every kept choice the one it has
    in the global ``[E, C, D]`` buffer (``1e-6`` of the largest row)."""
    from repro_torch.models import moe as MOE
    cfg = C.get_reduced(arch)
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    n, d, e, k = 64 * dp, cfg.d_model, cfg.moe_experts, cfg.moe_top_k
    flat = torch.randn(n, d, generator=torch.Generator().manual_seed(1))
    c = MOE.capacity(n, cfg)
    slot_g, _, _ = MOE._dispatch(flat, p["router"], cfg, c)
    token_g, _ = MOE._slot_maps(slot_g, e * c, k)
    out_g = MOE._expert_ffn(p, MOE._SlotGather.apply(
        flat, token_g, slot_g, k).view(e, c, d), cfg).reshape(e * c, d)
    scale = out_g.abs().max()
    nk = n * k // dp
    for r in range(dp):
        mine = slot_g[r * nk:(r + 1) * nk]
        rows = flat[r * n // dp:(r + 1) * n // dp]
        slot, c_buf = MOE._own_runs(mine, e, c)
        kept = mine < e * c
        assert torch.equal(kept, slot < e * c_buf)
        run = torch.bincount(mine[kept] // c, minlength=e)
        assert c_buf == max(8, -(-int(run.max()) // 8) * 8) and c_buf <= c
        for x in range(e):
            sel = kept & (mine // c == x)
            order = torch.argsort(mine[sel])
            assert torch.equal(slot[sel][order] - x * c_buf,
                               torch.arange(int(sel.sum())))
        token, _ = MOE._slot_maps(slot, e * c_buf, k)
        out = MOE._expert_ffn(p, MOE._SlotGather.apply(
            rows, token, slot, k).view(e, c_buf, d), cfg).reshape(-1, d)
        assert (out[slot[kept]] - out_g[mine[kept]]).abs().max() \
            <= 1e-6 * scale
