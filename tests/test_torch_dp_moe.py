"""Data-parallel MoE training (``launch/train``'s DP step under
``spmd.activate(mesh, shardmap_moe=True)``) against the reference's
shard-mapped step, on the CPU.

The reference runs in a subprocess on a forced 2-device host mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``; mesh (data 2,
model 1)): ``make_train_step`` jitted under ``spmd.activate(mesh,
shardmap_moe=True)`` with the batch placed on ``data``, and the step's
loss and gradients by ``jax.value_and_grad`` of its loss function there.
The port runs in two gloo processes (``launcher.fleet_init``'s variables,
``make_host_mesh()``), each on its half of the batch, from the reference's
initial state carried across as numpy. Reduced Moonlight and reduced
Mixtral, f32, the gating engine on:

* the DP loss within ``rtol 1e-5``, every all-reduced gradient within
  ``1e-4`` of the leaf's largest element, ``moe_dropped`` within ``1e-5``;
* the params after the update within ``1e-5`` of the leaf's largest
  element where ``|g|`` clears ``1e-3`` of the leaf's largest (AdamW's
  first step is ``lr * sign(g)`` elsewhere), and within ``2 lr``
  everywhere; the two ranks' params bit-identical;
* ZeRO-1 over two steps bit for bit the replicated update; its moments,
  placed on the mesh as ``DTensor`` s (``DataParallel.placed_opt_state``)
  and remeshed onto one device by ``elastic_remesh``, bit for bit the
  replicated run's.

Each spawned process runs under its own timeout.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "src")
_FLEET_ENV = ("COORDINATOR_ADDRESS", "PROCESS_COUNT", "PROCESS_ID")
ARCHS = ["moonshot_v1_16b_a3b", "mixtral_8x7b"]
B, S, WORLD, LR = 4, 16, 2, 1e-2
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4

COMMON = r"""
import numpy as np
def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: tree}
def batch_of(vocab):
    rng = np.random.default_rng(1)
    return {"tokens": rng.integers(0, vocab, (%d, %d)).astype(np.int32),
            "labels": rng.integers(0, vocab, (%d, %d)).astype(np.int32)}
""" % (B, S, B, S)

REFERENCE = r"""
import sys, pickle, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, {src!r})
import repro.configs as JC
from repro.core.gating import GatingConfig
from repro.launch import spmd
from repro.launch.train import TrainHParams, init_train_state, make_train_step
from repro.models import transformer as JT
from repro.optim import AdamWConfig
mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
out = {{}}
for arch in {archs!r}:
    cfg = JC.get_reduced(arch)
    hp = TrainHParams(opt=AdamWConfig(lr={lr}, warmup_steps=1),
                      gating=GatingConfig(ss_scale=0.5))
    p, o, s = init_train_state(jax.random.PRNGKey(0), cfg, hp)
    bt = batch_of(cfg.vocab)
    def loss_fn(p, b):
        logits, aux = JT.forward(p, cfg, tokens=b["tokens"])
        ce = JT.lm_loss(logits, b["labels"])
        return ce + hp.moe_aux_weight * aux["moe_aux"], aux
    with mesh, spmd.activate(mesh, shardmap_moe=True):
        jb = jax.device_put(bt, NamedSharding(mesh, P("data", None)))
        (loss, aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            p, jb)
        p2, o2, s2, m = jax.jit(make_train_step(cfg, hp))(p, o, s, jb)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    out[arch] = {{"init": (np_(p), np_(o), np_(s)), "batch": bt,
                 "loss": float(loss), "moe_dropped": float(m["moe_dropped"]),
                 "step_loss": float(m["loss"]),
                 "grads": {{k: np.asarray(v) for k, v in flat(g).items()}},
                 "params": {{k: np.asarray(v) for k, v in flat(p2).items()}}}}
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""

WORKER = r"""
import sys, pickle, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
import repro_torch.configs as C
from repro_torch import convert
from repro_torch.core.gating import GatingConfig
from repro_torch.launch import spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import TrainHParams, make_train_step
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.fault_tolerance import elastic_remesh
torch.set_num_threads(1)
rank, world = fleet_init("cpu")
mesh = make_host_mesh(device="cpu")
with open(sys.argv[2], "rb") as fh:
    ref = pickle.load(fh)
out = {{}}
for arch in {archs!r}:
    cfg = C.get_reduced(arch)
    jp, jo, js = ref[arch]["init"]
    half = {{k: torch.from_numpy(v[rank * {bl}:(rank + 1) * {bl}]).long()
            for k, v in ref[arch]["batch"].items()}}
    def state():
        return (convert.lm_params_from_numpy(jp, cfg, "cpu"),
                *convert.train_state_from_numpy(jo, js, "cpu"))
    rec = {{}}
    for zero1 in (False, True):
        hp = TrainHParams(opt=AdamWConfig(lr={lr}, warmup_steps=1),
                          gating=GatingConfig(ss_scale=0.5), zero1=zero1)
        with spmd.activate(mesh, shardmap_moe=True):
            step = make_train_step(cfg, hp, mesh=mesh, attn="flash")
            p, o, s = state()
            if zero1:
                o = adamw_init(p, step.dp.zero1_layout(p))
            else:
                g = step.dp.mean_grads(step.loss_and_grads(p, half)[2])
                rec["grads"] = {{k: v.numpy() for k, v in flat(g).items()
                                if v is not None}}
            for i in range(2):
                p, o, s, m = step(p, o, s, half)
                if i == 0 and not zero1:
                    rec["loss"] = float(m["loss"])
                    rec["moe_dropped"] = float(m["moe_dropped"])
                    rec["params"] = {{k: v.clone().numpy()
                                     for k, v in flat(p).items()}}
        rec["zero1" if zero1 else "replicated"] = {{
            k: v.numpy() for k, v in flat(p).items()}}
        if zero1:
            o = elastic_remesh(step.dp.placed_opt_state(
                o, step.dp.zero1_layout(p)), torch.device("cpu"),
                lambda path: None)
        rec["moments_zero1" if zero1 else "moments"] = {{
            k: v.numpy() for k, v in flat({{"m": o.m, "v": o.v}}).items()}}
    out[arch] = rec
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(jobs, timeout=300):
    try:
        logs = [p.communicate(timeout=timeout) for p in jobs]
    finally:
        for p in jobs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(jobs, logs):
        assert p.returncode == 0, so + se


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference, [rank 0, rank 1]): the reference's subprocess, then the
    port's two processes from its initial state."""
    import pickle
    tmp = tmp_path_factory.mktemp("dp_moe")
    fmt = dict(src=_SRC, archs=ARCHS, lr=LR, bl=B // WORLD)
    base = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    env = dict(base, PYTHONPATH=_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("JAX_PLATFORMS", None)
    ref_path = str(tmp / "ref.pkl")
    _wait([subprocess.Popen(
        [sys.executable, "-c", COMMON + REFERENCE.format(**fmt), ref_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
    env = dict(base, PYTHONPATH=_SRC, PROCESS_COUNT=str(WORLD),
               COORDINATOR_ADDRESS=f"localhost:{_free_port()}")
    paths = [str(tmp / f"rank{r}.pkl") for r in range(WORLD)]
    _wait([subprocess.Popen(
        [sys.executable, "-c", COMMON + WORKER.format(**fmt), paths[r],
         ref_path], env=dict(env, PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)])

    def load(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    return load(ref_path), [load(p) for p in paths]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_moe_loss_and_grads_equal_the_reference(results, arch):
    ref, ranks = results
    want = ref[arch]
    assert want["moe_dropped"] > 0          # capacity drops choices
    for r in ranks:
        got = r[arch]
        assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
        assert abs(got["loss"] - want["step_loss"]) <= \
            LOSS_TOL * abs(want["step_loss"])
        assert abs(got["moe_dropped"] - want["moe_dropped"]) <= \
            LOSS_TOL * want["moe_dropped"]
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in want["grads"].items():
            _close(got["grads"][k], g, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_moe_update_equals_the_reference(results, arch):
    ref, ranks = results
    want = ref[arch]
    held = total = 0
    for k, w in want["params"].items():
        a, g = ranks[0][arch]["params"][k], want["grads"][k]
        np.testing.assert_array_equal(a, ranks[1][arch]["params"][k])
        firm = np.abs(g) > 1e-3 * np.abs(g).max()
        held += int(firm.sum())
        total += g.size
        assert float(np.abs(a - w)[firm].max(initial=0)) <= \
            LOSS_TOL * float(np.abs(w).max())
        assert float(np.abs(a - w).max()) <= 2 * LR
    assert held > 0.75 * total


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_moe_zero1_equals_the_replicated_update_bit_for_bit(results, arch):
    _, ranks = results
    for r in ranks:
        rep, z = r[arch]["replicated"], r[arch]["zero1"]
        assert rep.keys() == z.keys()
        for k in rep:
            assert rep[k].dtype == z[k].dtype
            np.testing.assert_array_equal(rep[k], z[k])
    for k, v in ranks[0][arch]["zero1"].items():
        np.testing.assert_array_equal(v, ranks[1][arch]["zero1"][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_moe_zero1_moments_remesh_to_the_replicated_ones(results, arch):
    _, ranks = results
    for r in ranks:
        rep, z = r[arch]["moments"], r[arch]["moments_zero1"]
        assert rep.keys() == z.keys()
        for k in rep:
            assert rep[k].shape == z[k].shape and rep[k].dtype == z[k].dtype
            np.testing.assert_array_equal(rep[k], z[k])
