"""``runtime/fault_tolerance.elastic_remesh`` onto LM meshes, against the
reference's placements, on the CPU.

The reference places reduced Phi-3's params by ``tree_shardings`` and a
moment tree (twice the params) by ZeRO-1's ``opt_state_shardings`` on a
forced 4-device host mesh, (data 2, model 2) and (data 4, model 1), in a
subprocess, and records each device's block (``addressable_shards[i].data``
for device ``i``). Four gloo processes (``make_host_mesh(model=...)``; rank
``i`` sits where device ``i`` does) take the same tree (the reference's,
as numpy), remesh the plain tree onto (2, 2) by the port's specs, that
``DTensor`` tree onto (4, 1), and that onto one device:

* on each mesh every rank's local block equals the reference's block of
  the device of its index, bit for bit, and the specs are the reference's;
* on each mesh some leaf is split (model on (2, 2), the moments' data
  split on (4, 1));
* the tree on one device equals the tree bit for bit.

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
ARCH, WORLD = "phi3_medium_14b", 4
SHAPES = [(2, 2), (4, 1)]

COMMON = r"""
def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (str(k),)))
        return out
    return {prefix: tree}
"""

REFERENCE = r"""
import sys, pickle, jax, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, {src!r})
import repro.configs as JC
from repro.launch import sharding as SH
from repro.models import transformer as JT
cfg = JC.get_reduced({arch!r})
params = JT.init_params(jax.random.PRNGKey(0), cfg)
m = jax.tree.map(lambda x: x * 2, params)
out = {{"params": jax.tree.map(np.asarray, params)}}
for shape in {shapes!r}:
    mesh = Mesh(np.asarray(jax.devices()[:{world}]).reshape(shape),
                ("data", "model"))
    placed = jax.device_put({{"params": params, "m": m}}, {{
        "params": SH.tree_shardings(params, cfg, mesh),
        "m": SH.opt_state_shardings(m, params, cfg, mesh)}})
    out[shape] = {{k: (tuple(v.sharding.spec),
                      [np.asarray(s.data) for s in sorted(
                          v.addressable_shards, key=lambda s: s.device.id)])
                  for k, v in flat(placed).items()}}
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""

WORKER = r"""
import sys, pickle, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch import sharding as SH
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.fault_tolerance import elastic_remesh
torch.set_num_threads(1)
rank, world = fleet_init("cpu")
with open(sys.argv[2], "rb") as fh:
    ref = pickle.load(fh)
cfg = C.get_reduced({arch!r})
params = convert.lm_params_from_numpy(ref["params"], cfg, "cpu")
from repro_torch.optim.optimizer import tree_map
start = {{"params": params, "m": tree_map(lambda x: x * 2, params)}}
tree = start
out = {{}}
for shape in {shapes!r}:
    mesh = make_host_mesh(model=shape[1], device="cpu")
    specs = flat({{"params": SH.tree_shardings(params, cfg, mesh),
                  "m": SH.opt_state_shardings(start["m"], params, cfg,
                                              mesh)}})
    tree = elastic_remesh(tree, mesh, lambda path: specs[path].spec)
    out[shape] = {{k: (tuple(specs[k].spec), v.to_local().numpy(),
                      type(v).__name__) for k, v in flat(tree).items()}}
whole = elastic_remesh(tree, torch.device("cpu"), lambda path: None)
out["whole"] = {{k: v.numpy() for k, v in flat(whole).items()}}
out["start"] = {{k: v.numpy() for k, v in flat(start).items()}}
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
    """(reference, [rank 0 .. rank 3]): the reference's subprocess, then
    the port's four processes on its params."""
    import pickle
    tmp = tmp_path_factory.mktemp("elastic_lm")
    fmt = dict(src=_SRC, arch=ARCH, shapes=SHAPES, world=WORLD)
    base = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    env = dict(base, PYTHONPATH=_SRC,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
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


def _norm(spec):
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


@pytest.mark.parametrize("shape", SHAPES)
def test_local_blocks_equal_the_reference_devices(results, shape):
    ref, ranks = results
    want = ref[shape]
    split = 0
    for i, r in enumerate(ranks):
        got = r[shape]
        assert got.keys() == want.keys()
        for k, (spec, blocks) in want.items():
            gspec, block, kind = got[k]
            assert kind == "DTensor"
            assert _norm(gspec) == _norm(spec), k
            assert block.shape == blocks[i].shape, k
            np.testing.assert_array_equal(block, blocks[i])
            split += block.size < r["start"][k].size
    assert split          # some leaf is split on this mesh


def test_remesh_to_one_device_keeps_every_value(results):
    _, ranks = results
    for r in ranks:
        assert r["whole"].keys() == r["start"].keys()
        for k, v in r["start"].items():
            assert r["whole"][k].dtype == v.dtype
            np.testing.assert_array_equal(r["whole"][k], v)
