"""The compressed DP mean (``runtime/compression.compressed_mean``) against
the reference's pattern, on the CPU.

The reference's compressed all-reduce (``tests/test_sharding_multidevice.py``'s
``test_compressed_dp_allreduce_shardmap``) is ``pmean(decompress(compress(g)),
"data")`` under ``shard_map`` on a data mesh; here it runs in a subprocess on
a forced 4-device host mesh, and with error feedback as the reference's
``ErrorFeedback.step`` inside the same ``shard_map`` (each device its own
residual), three steps. The port runs in four gloo processes
(``make_host_mesh()``: data 4), each rank its own gradient tree drawn from
a numpy seed (f32 leaves of ragged sizes and an integer leaf's ``None``):

* int8 and top-k means within ``1e-6`` of each leaf's largest element (the
  reference's ``psum`` adds the four reconstructions in its own order, the
  port in rank order), bit-identical across the ranks;
* three error-feedback steps: each step's mean as above, and each rank's
  residual equal to its device's in the reference within ``1e-6`` of the
  rank's largest gradient element (a residual is the difference of two
  values of the gradient's size, rounded at that size).

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
WORLD, EF_STEPS, TOL = 4, 3, 1e-6
KINDS = ["int8", "topk"]

# both sides: rank r's gradient leaves at step t, by path
COMMON = r"""
import numpy as np
SHAPES = {"a": (8, 64), "b/c": (300,), "b/d": (3, 5, 7)}
def grads_of(rank, t):
    rng = np.random.default_rng(1000 * t + rank)
    return {k: (rng.standard_normal(s) * (1 + k.count("/"))).astype(np.float32)
            for k, s in SHAPES.items()}
"""

REFERENCE = r"""
import sys, pickle, functools, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
sys.path.insert(0, {src!r})
from repro.runtime.compression import (CompressionConfig, ErrorFeedback,
                                       compress, decompress)
mesh = Mesh(np.asarray(jax.devices()[:{world}]), ("data",))
out = {{}}
for kind in {kinds!r}:
    cfg = CompressionConfig(kind=kind)
    stack = lambda t: {{k: jnp.stack([grads_of(r, t)[k] for r in
                                     range({world})]) for k in SHAPES}}

    @functools.partial(shard_map, mesh=mesh, in_specs=P("data"),
                       out_specs=P(None))
    def mean_compressed(gl):
        return {{k: jax.lax.pmean(decompress(compress(v[0], cfg), cfg),
                                 "data")[None] for k, v in gl.items()}}

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P(None), P("data")))
    def mean_ef(gl, el):
        rec, ef = ErrorFeedback({{k: v[0] for k, v in el.items()}}).step(
            {{k: v[0] for k, v in gl.items()}}, cfg)
        return ({{k: jax.lax.pmean(v, "data")[None] for k, v in rec.items()}},
                {{k: v[None] for k, v in ef.residual.items()}})

    res = {{"mean": {{k: np.asarray(v[0]) for k, v in
                    jax.jit(mean_compressed)(stack(0)).items()}}, "ef": []}}
    e = {{k: jnp.zeros(({world},) + s, jnp.float32) for k, s in SHAPES.items()}}
    for t in range({steps}):
        m, e = jax.jit(mean_ef)(stack(t), e)
        res["ef"].append(({{k: np.asarray(v[0]) for k, v in m.items()}},
                          {{k: np.asarray(v) for k, v in e.items()}}))
    out[kind] = res
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""

WORKER = r"""
import sys, pickle, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch.launch import spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.compression import (CompressionConfig, ErrorFeedback,
                                             compressed_mean)
torch.set_num_threads(1)
rank, world = fleet_init("cpu")
groups = spmd.dp_groups(make_host_mesh(device="cpu"))
def tree(t):
    g = {{k: torch.from_numpy(v) for k, v in grads_of(rank, t).items()}}
    return {{"a": g["a"], "b": {{"c": g["b/c"], "d": g["b/d"]}}, "n": None}}
def flat(tr):
    return {{"a": tr["a"].numpy(), "b/c": tr["b"]["c"].numpy(),
            "b/d": tr["b"]["d"].numpy()}}
out = {{}}
for kind in {kinds!r}:
    cfg = CompressionConfig(kind=kind)
    mean, none = compressed_mean(tree(0), cfg, groups)
    assert none is None and mean["n"] is None
    res = {{"mean": flat(mean), "ef": []}}
    ef = ErrorFeedback.init(tree(0))
    for t in range({steps}):
        mean, ef = compressed_mean(tree(t), cfg, groups, ef)
        res["ef"].append((flat(mean), flat(ef.residual)))
    own, _ = compressed_mean(tree(0), cfg, [])
    res["own"] = flat(own)
    out[kind] = res
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(reference, [rank 0 .. rank 3]), the five processes run at once."""
    import pickle
    tmp = tmp_path_factory.mktemp("compressed_dp")
    fmt = dict(src=_SRC, world=WORLD, kinds=KINDS, steps=EF_STEPS)
    base = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    ref_env = dict(base, PYTHONPATH=_SRC, XLA_FLAGS=
                   f"--xla_force_host_platform_device_count={WORLD}")
    ref_env.pop("JAX_PLATFORMS", None)
    env = dict(base, PYTHONPATH=_SRC, PROCESS_COUNT=str(WORLD),
               COORDINATOR_ADDRESS=f"localhost:{_free_port()}")
    paths = [str(tmp / "ref.pkl")] + [str(tmp / f"rank{r}.pkl")
                                       for r in range(WORLD)]
    jobs = [subprocess.Popen(
        [sys.executable, "-c", COMMON + REFERENCE.format(**fmt), paths[0]],
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)]
    jobs += [subprocess.Popen(
        [sys.executable, "-c", COMMON + WORKER.format(**fmt), paths[r + 1]],
        env=dict(env, PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300) for p in jobs]
    finally:
        for p in jobs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(jobs, logs):
        assert p.returncode == 0, so + se

    def load(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    return load(paths[0]), [load(p) for p in paths[1:]]


def _close(got, want, scale=None):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max()) if scale is None else scale
    assert err <= TOL * scale, err


_INPUTS: dict = {}
exec(COMMON, _INPUTS)


def _same_on_every_rank(trees):
    for t in trees[1:]:
        for k, v in trees[0].items():
            np.testing.assert_array_equal(t[k], v)


@pytest.mark.parametrize("kind", KINDS)
def test_compressed_mean_equals_the_reference_pattern(results, kind):
    ref, ranks = results
    for r in ranks:
        for k, want in ref[kind]["mean"].items():
            _close(r[kind]["mean"][k], want)
    _same_on_every_rank([r[kind]["mean"] for r in ranks])
    # without groups: the rank's own reconstruction, not the mean
    assert any(not np.array_equal(r[kind]["own"]["a"],
                                  r[kind]["mean"]["a"]) for r in ranks)


@pytest.mark.parametrize("kind", KINDS)
def test_compressed_mean_with_error_feedback_equals_the_reference(results,
                                                                  kind):
    ref, ranks = results
    for t in range(EF_STEPS):
        want_mean, want_res = ref[kind]["ef"][t]
        for i, r in enumerate(ranks):
            mean, res = r[kind]["ef"][t]
            for k in want_mean:
                _close(mean[k], want_mean[k])
                _close(res[k], want_res[k][i],
                       float(np.abs(_INPUTS["grads_of"](i, t)[k]).max()))
        _same_on_every_rank([r[kind]["ef"][t][0] for r in ranks])
        # the residual carries what compression lost
        assert any(np.abs(r[kind]["ef"][t][1]["a"]).max() > 0 for r in ranks)
