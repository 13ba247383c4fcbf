"""Checkpoints of a tensor-parallel state (``checkpoint.save`` /
``restore`` over ``DTensor`` leaves, ``launch/launcher``'s resume), on the
CPU over gloo: 2 ranks on ``(data 1, model 2)`` and 4 on ``(data 2,
model 2)``, reduced Mamba2 and Moonlight (EP) in f32.

Each rank builds the train state placed by the rules
(``init_train_state(mesh=)``; ZeRO-1 on, so at a DP size of 2 each moment
is also split over ``data``), takes one step and saves it; the test
process takes the same step in one process and saves that. Then:

* the TP checkpoint holds the unsharded layout of a 1-process one (the
  same keys, shapes and dtypes), and restores in one process bit for bit
  into the leaves the ranks hold (gathered over the model and DP axes);
* it restores onto the ranks bit for bit, each rank keeping its block;
* the 1-process checkpoint restores onto the ranks, each leaf the block of
  the stored tensor that the rules give this rank (bit for bit the whole
  tensor placed by the template's placements);
* ``launch_train(ckpt_dir=)`` on a model axis of 2 resumed after step 1
  writes a step-2 checkpoint bit for bit the straight run's.

Each spawned process runs under its own timeout.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from repro_torch import checkpoint as ckpt  # noqa: E402
import repro_torch.configs as C  # noqa: E402
from repro_torch.launch.train import (TrainHParams, init_train_state,  # noqa: E402
                                      make_train_step)
from repro_torch.optim import AdamWConfig  # noqa: E402
from test_torch_tp import _spawn  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mamba2_2p7b", "moonshot_v1_16b_a3b")
B, S = 4, 16

torch.set_num_threads(1)

WORKER = r"""
import os, sys, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch import checkpoint as ckpt, configs as C
from repro_torch.launch import spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import (TrainHParams, init_train_state,
                                      make_train_step)
from repro_torch.optim import AdamWConfig
from repro_torch.optim.optimizer import tree_leaves
from torch.distributed.tensor import Shard
torch.set_num_threads(1)
base = sys.argv[1]
rank, world = fleet_init("cpu")
mesh = make_host_mesh(model=2, device="cpu")
dpr, dp = spmd.dp_rank(mesh), world // 2
out = {{"rank": rank, "dp_rank": dpr, "model_rank": mesh.get_local_rank("model")}}
def local(x):
    return x.to_local().clone() if hasattr(x, "to_local") else x
def flat(tree):
    return [local(v) if isinstance(v, torch.Tensor) else v
            for _, v in ckpt.checkpoint._flatten(tree)]
def equal(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(flat(a), flat(b)))
for arch in {archs!r}:
    cfg = C.get_reduced(arch)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3), zero1=True)
    batch = torch.load(os.path.join(base, arch + ".batch.pt"))
    w = batch["tokens"].shape[0] // dp
    mine = {{k: v[dpr * w:(dpr + 1) * w] for k, v in batch.items()}}
    with spmd.activate(mesh):
        step = make_train_step(cfg, hp, mesh=mesh)
        state = init_train_state(torch.Generator().manual_seed(0), cfg, hp,
                                 "cpu", mesh=mesh)
        state = step(*state, mine)[:3]
        tp_dir = os.path.join(base, arch, "tp")
        ckpt.save(tp_dir, 1, state)
        fresh = init_train_state(torch.Generator().manual_seed(1), cfg, hp,
                                 "cpu", mesh=mesh)
        _, back, _ = ckpt.restore(tp_dir, fresh)
        _, one, _ = ckpt.restore(os.path.join(base, arch, "one"), fresh)
    leaves = ckpt.checkpoint._flatten(state)
    out[arch] = {{
        "blocks": {{k: local(v) for k, v in leaves
                   if isinstance(v, torch.Tensor)}},
        "placements": {{k: [p.dim if isinstance(p, Shard) else None
                           for p in v.placements] for k, v in leaves
                       if hasattr(v, "placements")}},
        "placed_leaves": sum(hasattr(v, "placements") for _, v in leaves),
        "tp_round_trip": equal(back, state),
        "placements_kept": all(
            tuple(a.placements) == tuple(b.placements)
            for a, b in zip(tree_leaves(back[0]), tree_leaves(state[0]))),
        "one_blocks": {{k: local(v) for k, v in ckpt.checkpoint._flatten(one)
                       if isinstance(v, torch.Tensor)}},
        "one_step": one[1].step}}
torch.save(out, os.path.join(base, f"rank{{rank}}.pt"))
dist.destroy_process_group()
"""


def _batch(cfg):
    rng = np.random.default_rng(4)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))
            for k in ("tokens", "labels")}


def _one_process(arch, base):
    """The same step in one process on the whole batch, saved."""
    cfg = C.get_reduced(arch)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3), zero1=True)
    batch = _batch(cfg)
    torch.save(batch, os.path.join(base, arch + ".batch.pt"))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, hp, "cpu")
    state = make_train_step(cfg, hp)(*state, batch)[:3]
    ckpt.save(os.path.join(base, arch, "one"), 1, state)
    return state


def _run(world, base):
    states = {arch: _one_process(arch, base) for arch in ARCHS}
    code = WORKER.format(src=os.path.join(_ROOT, "src"), archs=ARCHS)
    _spawn(world, ["-c", code, base])
    ranks = [torch.load(os.path.join(base, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    return ranks, states


@pytest.fixture(scope="module", params=[2, 4], ids=["mesh1x2", "mesh2x2"])
def run(request, tmp_path_factory):
    base = str(tmp_path_factory.mktemp(f"ckpt{request.param}"))
    return (request.param, base) + _run(request.param, base)


def _joined(ranks, get, placements):
    """One leaf whole from the ranks' blocks (``get(rank record)``): joined
    over ``model`` within each DP index, then over ``data``, along the dim
    that the leaf's placement on that mesh dim shards (``placements``:
    that dim or None, for ``data`` and ``model``)."""
    by = {(r["dp_rank"], r["model_rank"]): get(r) for r in ranks}
    n_dp = 1 + max(d for d, _ in by)
    d_data, d_model = placements
    rows = [by[(i, 0)] if d_model is None else
            torch.cat([by[(i, 0)], by[(i, 1)]], d_model) for i in range(n_dp)]
    return rows[0] if d_data is None else torch.cat(rows, d_data)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_checkpoint_restores_in_one_process(run, arch):
    """The ranks' checkpoint has a 1-process checkpoint's keys, shapes and
    dtypes, and restores into the 1-process template as the leaves the
    ranks hold, gathered."""
    world, base, ranks, states = run
    _, shapes, _ = ckpt.peek(os.path.join(base, arch, "tp"))
    _, one_shapes, _ = ckpt.peek(os.path.join(base, arch, "one"))
    assert shapes == one_shapes
    _, back, _ = ckpt.restore(os.path.join(base, arch, "tp"), states[arch])
    r0 = ranks[0][arch]
    assert r0["placed_leaves"] > 0
    for key, leaf in ckpt.checkpoint._flatten(back):
        if not isinstance(leaf, torch.Tensor):
            continue
        pls = r0["placements"].get(key)
        want = r0["blocks"][key] if pls is None else _joined(
            ranks, lambda r, k=key: r[arch]["blocks"][k], pls)
        assert torch.equal(leaf, want), key


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_checkpoint_restores_onto_the_ranks(run, arch):
    world, base, ranks, _ = run
    for r in ranks:
        assert r[arch]["tp_round_trip"] and r[arch]["placements_kept"]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_checkpoint_restores_under_tp(run, arch):
    """Each rank's restored leaf is its block of the 1-process state (the
    blocks joined give the stored tensor back), bit for bit."""
    world, base, ranks, states = run
    want = dict(ckpt.checkpoint._flatten(states[arch]))
    r0 = ranks[0][arch]
    for key, pls in r0["placements"].items():
        got = _joined(ranks, lambda r, k=key: r[arch]["one_blocks"][k], pls)
        assert torch.equal(got, want[key].to(got.dtype)), key
    for r in ranks:
        assert r[arch]["one_step"] == states[arch][1].step


# launch_train on a (data DP, model 2) host mesh in place of the production
# mesh, the reduced config in place of the full one
LAUNCHER = r"""
import sys
sys.path.insert(0, {src!r})
from repro_torch import configs as C
from repro_torch.launch import launcher, mesh
full = C.get_config
C.get_config = lambda name: C.make_reduced(full(name))
mesh.make_production_mesh = lambda multi_pod=False, device=None: \
    mesh.make_host_mesh(model=2, device="cpu")
launcher.CKPT_EVERY = 1         # a checkpoint after every step
launcher.main(["--arch", sys.argv[1], "--opt", "zero1,seq,flash", "--steps",
               sys.argv[2], "--seq-len", "16", "--global-batch", "4",
               "--ckpt-dir", sys.argv[3], "--device", "cpu", "--backend",
               "gloo"])
"""


@pytest.mark.parametrize("arch", ["mamba2_2p7b"])
def test_launch_train_resumes_a_tp_run_bit_for_bit(arch, tmp_path):
    """Straight: steps 0-2, a checkpoint after each. Resumed: steps 0-1,
    then a second launch that restores step 1 and runs step 2. The two
    step-2 checkpoints are equal array for array (2 ranks: (data 1, model
    2); the ranks' own test above holds ZeRO-1's moments split over
    ``data`` at (data 2, model 2))."""
    code = LAUNCHER.format(src=os.path.join(_ROOT, "src"))
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    _spawn(2, ["-c", code, arch, "3", straight])
    _spawn(2, ["-c", code, arch, "2", resumed])
    assert ckpt.latest_step(resumed) == 1
    _spawn(2, ["-c", code, arch, "3", resumed])
    a = np.load(os.path.join(straight, "step_000000002", "arrays.npz"))
    b = np.load(os.path.join(resumed, "step_000000002", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 0
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
