"""Data-parallel LM training across processes (``launch/train``'s
``make_train_step(mesh=)``, ``launch/launcher``), on the CPU over gloo.

Two processes join a gloo group through ``launcher.fleet_init``'s
variables, build ``make_host_mesh()`` (``data`` 2, ``model`` 1) and train
reduced StableLM-12B in f32, each on its half of the global batch
(``synthetic_lm_batch(pcfg, step, rank, 2)``), with the gating engine on:

* one DP step against the 1-process step on the two halves concatenated:
  the loss and every gradient (all-reduced) within ``rtol 1e-5`` of the
  leaf's largest element (the two sum the batch in other orders), and the
  parameters after the update so wherever the gradient clears its
  rounding of zero (AdamW's first step is ``lr * sign(g)`` there);
* ZeRO-1 against the replicated update over three steps: bit for bit, and
  the two ranks' params bit-identical to each other;
* ``python -m repro_torch.launch.launcher`` at world size 2, ``--device
  cpu``: only rank 0 prints, and it prints its loss.

Each spawned process runs under its own timeout. The MoE family under a
DP size above 1 trains with ``shardmap_moe`` (``tests/test_torch_dp_moe.py``
holds the step) and without it, one dispatch over the global batch
(``tests/test_torch_tp_families.py``).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.core.gating import GatingConfig
from repro_torch.data.pipeline import PipelineConfig, synthetic_lm_batch
from repro_torch.launch import spmd
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.train import (TrainHParams, init_train_state,
                                      make_train_step)
from repro_torch.optim import AdamWConfig
from repro_torch.optim.optimizer import tree_leaves

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLEET_ENV = ("COORDINATOR_ADDRESS", "PROCESS_COUNT", "PROCESS_ID")
ARCH, SEQ, GLOBAL_BATCH, WORLD = "stablelm_12b", 16, 4, 2
RTOL = 1e-5

torch.set_num_threads(1)

# one rank: argv = (rank, mode, out); writes what the test compares
WORKER = r"""
import sys, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch import configs as C
from repro_torch.core.gating import GatingConfig
from repro_torch.data.pipeline import PipelineConfig, synthetic_lm_batch
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import TrainHParams, init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
torch.set_num_threads(1)
mode, out_path = sys.argv[1], sys.argv[2]
rank, world = fleet_init("cpu")
assert dist.get_backend() == "gloo"
cfg = C.get_reduced({arch!r})
pcfg = PipelineConfig(vocab=cfg.vocab, seq_len={seq}, global_batch={gb})
mesh = make_host_mesh(device="cpu")
out = {{"rank": rank, "world": world, "mesh": tuple(mesh.shape)}}
def batch(i):
    return {{k: torch.from_numpy(v).long()
            for k, v in synthetic_lm_batch(pcfg, i, rank, world).items()}}
def hp(zero1):
    return TrainHParams(opt=AdamWConfig(lr=1e-2, warmup_steps=1),
                        gating=GatingConfig(ss_scale=0.5), zero1=zero1)
if mode == "step":
    h = hp(False)
    p, o, s = init_train_state(torch.Generator().manual_seed(0), cfg, h,
                               "cpu", mesh=mesh)
    step = make_train_step(cfg, h, mesh=mesh)
    out["grads"] = step.dp.mean_grads(step.loss_and_grads(p, batch(0))[2])
    p, o, s, m = step(p, o, s, batch(0))
    out["params"], out["loss"] = p, m["loss"]
else:
    for zero1 in (False, True):
        h = hp(zero1)
        st = init_train_state(torch.Generator().manual_seed(0), cfg, h,
                              "cpu", mesh=mesh)
        step = make_train_step(cfg, h, mesh=mesh)
        gates = []
        for i in range(3):
            p, o, s, m = step(*st, batch(i))
            st = (p, o, s)
            gates.append(float(m["gate_frac"]))
        out[zero1] = {{"params": st[0], "m": st[1].m, "gates": gates}}
torch.save(out, out_path)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(args_of, timeout=300):
    """WORLD processes, rank r running ``args_of(r)``, joined through the
    scheduler's variables; each waited for under ``timeout``."""
    env = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    env.update(PYTHONPATH=os.path.join(_ROOT, "src"),
               COORDINATOR_ADDRESS=f"localhost:{_free_port()}",
               PROCESS_COUNT=str(WORLD))
    procs = [subprocess.Popen([sys.executable] + args_of(r),
                              env=dict(env, PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
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
        assert p.returncode == 0, so + se
    return [so for so, _ in outs]


def _run_workers(mode, tmp_path):
    code = WORKER.format(src=os.path.join(_ROOT, "src"), arch=ARCH, seq=SEQ,
                         gb=GLOBAL_BATCH)
    paths = [str(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    _spawn(lambda r: ["-c", code, mode, paths[r]])
    return [torch.load(p) for p in paths]


def _global_batch(pcfg, i):
    parts = [synthetic_lm_batch(pcfg, i, r, WORLD) for r in range(WORLD)]
    return {k: torch.cat([torch.from_numpy(p[k]).long() for p in parts])
            for k in parts[0]}


def _close(a, b):
    """Within RTOL of the leaf's largest element."""
    return float((a - b).abs().max()) <= RTOL * float(b.abs().max())


def test_dp_step_equals_the_one_process_step(tmp_path):
    ranks = _run_workers("step", tmp_path)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["mesh"] == (WORLD, 1) for r in ranks)
    cfg = C.get_reduced(ARCH)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-2, warmup_steps=1),
                      gating=GatingConfig(ss_scale=0.5))
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                          global_batch=GLOBAL_BATCH)
    p, o, s = init_train_state(torch.Generator().manual_seed(0), cfg, hp,
                               "cpu")
    step = make_train_step(cfg, hp)
    batch = _global_batch(pcfg, 0)
    grads = step.loss_and_grads(p, batch)[2]
    p, o, s, m = step(p, o, s, batch)
    for r in ranks:
        torch.testing.assert_close(r["loss"], m["loss"], rtol=RTOL, atol=0)
        got, want = tree_leaves(r["grads"]), tree_leaves(grads)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if b is not None:
                assert _close(a, b)
        # AdamW's first step moves an element by lr * g / (|g| + eps): where
        # |g| lies within the gradients' rounding of 0 its sign may differ,
        # so the params are held where |g| clears 1e-3 of the leaf's
        # largest, and everywhere within the update's range of 2 lr
        lr = hp.opt.lr
        held = 0
        for a, b, g in zip(tree_leaves(r["params"]), tree_leaves(p),
                           tree_leaves(grads)):
            if not b.is_floating_point():
                assert torch.equal(a, b)
                continue
            firm = g.abs() > 1e-3 * g.abs().max()
            held += int(firm.sum())
            assert float((a - b)[firm].abs().max()) <= \
                RTOL * float(b.abs().max())
            assert float((a - b).abs().max()) <= 2 * lr
        assert held > 0.75 * sum(g.numel() for g in tree_leaves(grads)
                                 if g is not None)


def test_zero1_equals_the_replicated_update_bit_for_bit(tmp_path):
    ranks = _run_workers("zero1", tmp_path)
    for r in ranks:
        gates = r[False]["gates"]
        assert gates == r[True]["gates"] and min(gates) < 1.0
        assert max(gates) > 0.0
        for a, b in zip(tree_leaves(r[False]["params"]),
                        tree_leaves(r[True]["params"])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        # each rank holds half of every split moment
        split = [(a.shape, b.shape) for a, b in
                 zip(tree_leaves(r[False]["m"]), tree_leaves(r[True]["m"]))
                 if a.shape != b.shape]
        assert split and all(
            sum(x != y for x, y in zip(a, b)) == 1
            and a.numel() == WORLD * b.numel() for a, b in split)
    for zero1 in (False, True):
        for a, b in zip(tree_leaves(ranks[0][zero1]["params"]),
                        tree_leaves(ranks[1][zero1]["params"])):
            assert torch.equal(a, b)


def test_launch_train_with_two_processes():
    """The launcher's CLI through fleet_init's variables: the host mesh
    over both ranks, data-parallel, only rank 0 printing."""
    outs = _spawn(lambda r: [
        "-m", "repro_torch.launch.launcher", "--arch", ARCH, "--steps", "2",
        "--seq-len", "32", "--global-batch", "4", "--opt", "zero1,seq,flash",
        "--device", "cpu", "--backend", "gloo"])
    assert "step 0 loss" in outs[0] and "backend=gloo" in outs[0]
    assert "mesh={'data': 2, 'model': 1}" in outs[0] and "hosts=2" in outs[0]
    assert outs[1] == ""


def test_launch_moe_with_two_processes():
    """``--opt moe``: the MoE family trains data-parallel at world size 2,
    each process dispatching its own tokens."""
    outs = _spawn(lambda r: [
        "-m", "repro_torch.launch.launcher", "--arch", "moonshot_v1_16b_a3b",
        "--steps", "2", "--seq-len", "16", "--global-batch", "4", "--opt",
        "zero1,moe", "--device", "cpu", "--backend", "gloo"])
    assert "step 0 loss" in outs[0] and "'shardmap_moe': True" in outs[0]
    assert "mesh={'data': 2, 'model': 1}" in outs[0] and outs[1] == ""


def test_moe_under_data_parallelism_is_refused():
    """Refused until slice 19: without ``shardmap_moe`` the reference
    dispatches the global batch at once. The same calls now build and run
    the step (on an abstract mesh, with no process group, each rank's own
    batch; over gloo ``tests/test_torch_tp_families.py`` holds the global
    dispatch), with and without ``shardmap_moe``, and a model axis above 1
    builds the moe family's tensor-parallel step too."""
    mesh = AbstractMesh((2, 1), ("data", "model"))
    for arch in ("mixtral_8x7b", "moonshot_v1_16b_a3b"):
        cfg = C.get_reduced(arch)
        step = make_train_step(cfg, TrainHParams(), mesh=mesh)
        with spmd.activate(mesh, shardmap_moe=True):
            make_train_step(cfg, TrainHParams(), mesh=mesh)
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 TrainHParams(), "cpu", mesh=mesh)
        batch = {k: torch.zeros((2, 8), dtype=torch.long)
                 for k in ("tokens", "labels")}
        m = step(*state, batch)[3]
        assert torch.isfinite(m["loss"]) and float(m["moe_dropped"]) >= 0
    make_train_step(C.get_reduced("mixtral_8x7b"), TrainHParams(),
                    mesh=AbstractMesh((1, 1), ("data", "model")))
    make_train_step(C.get_reduced(ARCH), TrainHParams(),
                    mesh=AbstractMesh((16, 16), ("data", "model")))
    make_train_step(C.get_reduced("mixtral_8x7b"), TrainHParams(),
                    mesh=AbstractMesh((16, 16), ("data", "model")))
    assert np.isfinite(GLOBAL_BATCH)
