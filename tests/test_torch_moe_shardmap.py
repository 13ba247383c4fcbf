"""The shard-mapped MoE (``models/moe._moe_apply_shardmap``) against the
reference's ``_moe_apply_shardmap``, on the CPU.

The reference runs in a subprocess on a forced 4-device host mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_sharding_multidevice.py`` does), calling ``moe_apply`` under
``spmd.activate(Mesh, shardmap_moe=True)`` inside ``jax.jit``. The port
runs in gloo processes (``launcher.fleet_init``'s variables,
``make_host_mesh(model=...)``), each on its block of the batch along the
data axis, the expert leaves whole. Both read the same numpy inputs, drawn
from a seed, in f32, with a capacity factor of 1 so that choices drop.

Cases: reduced Moonlight (EP: each model rank runs E / tp experts) at
(data, model) = (2, 1), (1, 2) and (2, 2); reduced Mixtral (TP inside the
experts: ``w1`` / ``w3`` split on F, ``w2`` on F's rows) at (2, 2).

* the output block and ``moe_aux``, ``moe_dropped``, ``moe_load`` within
  ``1e-5`` of the tensor's largest element;
* gradients of ``mean(out * wt) + moe_aux`` within ``1e-4`` of the
  leaf's largest element (``tests/test_torch_train.py``'s bound): each
  rank's loss is its own block's mean plus the DP-mean aux, whose
  gradient is the rank's own, so the reference's gradients are the DP
  mean of the ranks' parameter gradients (what the DP step's all-reduce
  computes) and the rank's input gradient over the DP size; each rank's
  expert gradient is its block, zero outside it. A model-axis sum whose
  backward all-reduced would double every expert block's gradient here.

The processes of each world size run together, under their own timeouts.
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
B, S, SEED = 4, 8, 0
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
CASES = [("moonshot_v1_16b_a3b", (2, 1)), ("moonshot_v1_16b_a3b", (1, 2)),
         ("moonshot_v1_16b_a3b", (2, 2)), ("mixtral_8x7b", (2, 2))]
EXPERTS = ("w1", "w2", "w3")

# both sides: the reduced config with a capacity factor of 1, and the
# numpy inputs of a case
COMMON = r"""
import dataclasses, numpy as np
def case_cfg(C, arch):
    return dataclasses.replace(C.get_reduced(arch), moe_capacity_factor=1.0)
def case_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w1": {"w": rng.standard_normal((e, d, f)) * d ** -0.5},
         "w2": {"w": rng.standard_normal((e, f, d)) * f ** -0.5},
         "w3": {"w": rng.standard_normal((e, d, f)) * d ** -0.5}}
    x = rng.standard_normal((b, s, d))
    wt = rng.standard_normal((b, s, d))
    f32 = lambda a: a.astype(np.float32)
    return ({k: f32(v) if k == "router" else {"w": f32(v["w"])}
             for k, v in p.items()}, f32(x), f32(wt))
"""

REFERENCE = r"""
import sys, pickle, jax, jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, {src!r})
import repro.configs as JC
from repro.launch import spmd
from repro.models import moe as M
out = {{}}
for arch, shape in {cases!r}:
    cfg = case_cfg(JC, arch)
    p, x, wt = case_inputs(cfg, {b}, {s}, {seed})
    mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]])
                .reshape(shape), ("data", "model"))
    def f(p, x):
        o, aux = M.moe_apply(p, x, cfg)
        return (o * wt).mean() + aux["moe_aux"], (o, aux)
    with spmd.activate(mesh, shardmap_moe=True):
        (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, x)
    out[(arch, shape)] = jax.tree.map(np.asarray, {{
        "out": o, "aux": aux, "gx": gx, "router": gp["router"],
        **{{k: gp[k]["w"] for k in {experts!r}}}}})
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""

WORKER = r"""
import sys, pickle, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
import repro_torch.configs as C
from repro_torch.launch import spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as MOE
torch.set_num_threads(1)
rank, world = fleet_init("cpu")
out = {{}}
for arch, shape in {cases!r}:
    if shape[0] * shape[1] != world:
        continue
    cfg = case_cfg(C, arch)
    p, x, wt = case_inputs(cfg, {b}, {s}, {seed})
    mesh = make_host_mesh(model=shape[1], device="cpu")
    di, m = spmd.dp_rank(mesh), spmd.model_rank(mesh)
    bl = {b} // shape[0]
    tp = {{k: torch.from_numpy(v).requires_grad_() if k == "router" else
          {{"w": torch.from_numpy(v["w"]).requires_grad_()}}
          for k, v in p.items()}}
    xl = torch.from_numpy(x[di * bl:(di + 1) * bl]).requires_grad_()
    wl = torch.from_numpy(wt[di * bl:(di + 1) * bl])
    with spmd.activate(mesh, shardmap_moe=True) as ctx:
        o, aux = MOE.moe_apply(tp, xl, cfg)
        loss = (o * wl).mean() + aux["moe_aux"]
        leaves = [tp["router"]] + [tp[k]["w"] for k in {experts!r}]
        g = torch.autograd.grad(loss, [xl] + leaves)
        dp = spmd.dp_size(ctx)
        gp = [spmd._all_reduce(t, spmd.dp_groups(mesh)) / dp for t in g[1:]]
    out[(arch, shape)] = {{
        "di": di, "m": m, "out": o.detach().numpy(),
        "aux": {{k: v.detach().numpy() for k, v in aux.items()}},
        "gx": (g[0] / dp).numpy(), "router": gp[0].numpy(),
        **{{k: t.numpy() for k, t in zip({experts!r}, gp[1:])}}}}
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(code, path, env):
    return subprocess.Popen([sys.executable, "-c", code, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference results, {world: per-rank results}): the reference's
    subprocess and the port's processes of both world sizes, run at once,
    each waited for under its own timeout."""
    import pickle
    tmp = tmp_path_factory.mktemp("moe_shardmap")
    fmt = dict(src=_SRC, cases=CASES, b=B, s=S, seed=SEED, experts=EXPERTS)
    base = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    ref_env = dict(base, PYTHONPATH=_SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_env.pop("JAX_PLATFORMS", None)
    jobs = [("ref", _start(COMMON + REFERENCE.format(**fmt), str(tmp / "ref.pkl"),
                           ref_env))]
    for world in (2, 4):
        env = dict(base, PYTHONPATH=_SRC, PROCESS_COUNT=str(world),
                   COORDINATOR_ADDRESS=f"localhost:{_free_port()}")
        for r in range(world):
            jobs.append(((world, r), _start(
                COMMON + WORKER.format(**fmt), str(tmp / f"w{world}_{r}.pkl"),
                dict(env, PROCESS_ID=str(r)))))
    try:
        logs = [(name, p.communicate(timeout=300)) for name, p in jobs]
    finally:
        for _, p in jobs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (name, p), (_, (so, se)) in zip(jobs, logs):
        assert p.returncode == 0, (name, so + se)

    def load(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    ranks = {w: [load(tmp / f"w{w}_{r}.pkl") for r in range(w)]
             for w in (2, 4)}
    return load(tmp / "ref.pkl"), ranks


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def _case_ranks(results, arch, shape):
    ref, ranks = results
    return ref[(arch, shape)], [r[(arch, shape)]
                                for r in ranks[shape[0] * shape[1]]]


@pytest.mark.parametrize("arch,shape", CASES)
def test_output_and_aux_equal_the_reference(results, arch, shape):
    want, ranks = _case_ranks(results, arch, shape)
    bl = B // shape[0]
    assert sorted((r["di"], r["m"]) for r in ranks) == \
        [(i, j) for i in range(shape[0]) for j in range(shape[1])]
    for r in ranks:
        i = r["di"]
        _close(r["out"], want["out"][i * bl:(i + 1) * bl], OUT_TOL)
        for k in ("moe_aux", "moe_dropped", "moe_load"):
            _close(r["aux"][k], want["aux"][k], OUT_TOL)
    # the case drops choices at its capacity
    assert float(want["aux"]["moe_dropped"]) > 0


@pytest.mark.parametrize("arch,shape", CASES)
def test_gradients_equal_the_reference(results, arch, shape):
    want, ranks = _case_ranks(results, arch, shape)
    bl = B // shape[0]
    cfg_ep = arch == "moonshot_v1_16b_a3b"
    for r in ranks:
        i, m = r["di"], r["m"]
        _close(r["gx"], want["gx"][i * bl:(i + 1) * bl], GRAD_TOL)
        _close(r["router"], want["router"], GRAD_TOL)
        for k in EXPERTS:
            dim = 0 if cfg_ep else (1 if k == "w2" else 2)
            w = want[k].shape[dim] // shape[1]
            block = np.take(r[k], np.arange(m * w, (m + 1) * w), axis=dim)
            _close(block, np.take(want[k], np.arange(m * w, (m + 1) * w),
                                  axis=dim), GRAD_TOL)
            # nothing outside the rank's block
            rest = np.delete(r[k], np.arange(m * w, (m + 1) * w), axis=dim)
            assert not rest.any()


def test_masked_experts_and_abstract_meshes_are_refused():
    """The reference's in_specs name each expert's ``w`` alone (a masked
    expert's ``umask`` does not fit them), and an abstract mesh of more
    than one device has no process group to run on."""
    import torch
    import repro_torch.configs as C
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import moe as MOE
    cfg = C.get_reduced("moonshot_v1_16b_a3b")
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.zeros((2, 4, cfg.d_model))
    with spmd.activate(AbstractMesh((2, 1), ("data", "model")),
                       shardmap_moe=True):
        with pytest.raises(ValueError, match="abstract mesh"):
            MOE.moe_apply(p, x, cfg)
    p["w1"]["umask"] = torch.ones((cfg.d_model // 8, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="dense experts"):
        MOE._local_experts(p, cfg, 2, 0)
