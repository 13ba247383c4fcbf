"""LM serving under tensor parallelism (``transformer.prefill`` /
``decode_step``, ``launch/serve.generate`` over ``DTensor`` parameters and
caches placed by ``launch.sharding.cache_shardings``), on the CPU over
gloo: 2 ranks on ``(data 1, model 2)`` and 4 on ``(data 2, model 2)``, each
DP rank serving its rows of the prompt batch.

Each mesh's ranks are spawned once (a module fixture) and serve every case
(the parameters drawn by the reference, ``init_params``, carried across by
``convert.lm_params_from_numpy`` and placed by the rules): prefill and 8
greedy decode steps, then ``generate`` greedy and sampled. The cases cover
a cache split over its slots (C even), over its head dim (C odd), a
sliding window's ring (8 slots), M-RoPE (Qwen2-VL), KV heads split whole
(MusicGen) and sequence parallelism in the prefill. Held against the
port's 1-process run and the reference's ``prefill`` / ``decode_step`` /
``generate`` on one device, each on the whole batch: every step's logits,
gathered over the vocab, within ``1e-5`` of the largest logit (the same f32
products summed in two partial halves; the decode merges the ranks'
softmax partials in f32); the greedy tokens equal to theirs and on every
rank; the sampled tokens equal on every rank; each rank's logits
``V / model`` columns wide.
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
from repro.launch import serve as jserve
from repro.models import transformer as JT
import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLEET_ENV = ("COORDINATOR_ADDRESS", "PROCESS_COUNT", "PROCESS_ID")
BATCH, PROMPT, NEW, LOGIT_RTOL = 4, 12, 8, 1e-5

torch.set_num_threads(1)

# name: (arch, config changes, max_seq, seq_shard, meshes)
CASES = {
    "phi3_slots": ("phi3_medium_14b", {}, 20, False, (2, 4)),
    "phi3_window8": ("phi3_medium_14b", {"swa_window": 8}, 20, False, (2,)),
    "stablelm_dh": ("stablelm_12b", {}, 21, False, (2,)),
    "qwen_mrope_seq": ("qwen2_vl_2b", {}, 20, True, (2,)),
    "musicgen_kv_heads": ("musicgen_large", {}, 20, False, (4,)),
}

WORKER = r"""
import dataclasses, os, sys, torch
import torch.distributed as dist
sys.path.insert(0, {src!r})
from repro_torch import configs as C
from repro_torch import convert
from repro_torch.launch import spmd
from repro_torch.launch.launcher import fleet_init
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import generate
from repro_torch.launch.train import place_params
from repro_torch.models import transformer as T
torch.set_num_threads(1)
spec = torch.load(sys.argv[1], weights_only=False)
rank, world = fleet_init("cpu")
mesh = make_host_mesh(model=2, device="cpu")
dpr, dp = spmd.dp_rank(mesh), world // 2
out = {{"rank": rank, "dp_rank": dpr, "model_rank": mesh.get_local_rank("model")}}
for c in spec:
    cfg = dataclasses.replace(C.get_reduced(c["arch"]), **c["changes"])
    params = place_params(convert.lm_params_from_numpy(c["params"], cfg, "cpu"),
                          cfg, mesh)
    w = c["prompt"].shape[0] // dp
    prompt = torch.as_tensor(c["prompt"][dpr * w:(dpr + 1) * w])
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
        sampled = generate(params, cfg, prompt, {new}, max_seq=c["max_seq"],
                           temperature=0.7,
                           generator=torch.Generator().manual_seed(5))
    out[c["name"]] = {{"logits": steps, "tokens": torch.stack(toks, 1),
                      "greedy": greedy, "sampled": sampled,
                      "cache_dim": spmd.model_dim(cache["k"]),
                      "cache_local": tuple(cache["k"].to_local().shape)}}
torch.save(out, os.path.join(sys.argv[2], f"rank{{rank}}.pt"))
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


def _cfg(name):
    arch, changes, _, _, _ = CASES[name]
    return dataclasses.replace(C.get_reduced(arch), **changes)


def _prompt(cfg):
    return np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)


_REF: dict = {}          # the one-device runs, shared by both meshes


def _params(name):
    """The reference's parameters (numpy), drawn on one device."""
    if ("params", name) not in _REF:
        arch, changes, _, _, _ = CASES[name]
        jcfg = dataclasses.replace(JC.get_reduced(arch), **changes)
        _REF[("params", name)] = jax.tree.map(
            np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    return _REF[("params", name)]


def _one_process(name):
    """The port's 1-process run on the whole batch: the logits of the
    prefill and each greedy decode step, the tokens, ``generate``'s."""
    if ("port", name) in _REF:
        return _REF[("port", name)]
    cfg = _cfg(name)
    max_seq = CASES[name][2]
    params = convert.lm_params_from_numpy(_params(name), cfg, "cpu")
    prompt = torch.as_tensor(_prompt(cfg))
    with torch.no_grad():
        logits, cache = T.prefill(params, cfg, prompt, max_seq, attn="flash")
        steps, toks = [logits], []
        for _ in range(NEW):
            tok = logits.argmax(-1)
            toks.append(tok)
            logits, cache = T.decode_step(params, cache, tok, cfg)
            steps.append(logits)
        greedy = generate(params, cfg, prompt, NEW, max_seq=max_seq)
    _REF[("port", name)] = (steps, torch.stack(toks, 1), greedy)
    return _REF[("port", name)]


def _reference(name):
    """The reference's run on one device, as :func:`_one_process`."""
    if ("ref", name) in _REF:
        return _REF[("ref", name)]
    arch, changes, max_seq, _, _ = CASES[name]
    jcfg = dataclasses.replace(JC.get_reduced(arch), **changes)
    jp = jax.tree.map(jnp.asarray, _params(name))
    prompt = jnp.asarray(_prompt(_cfg(name)).astype(np.int32))
    logits, cache = JT.prefill(jp, jcfg, prompt, max_seq)
    steps, toks = [logits], []
    for _ in range(NEW):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(tok)
        logits, cache = JT.decode_step(jp, cache, tok, jcfg)
        steps.append(logits)
    greedy = jserve.generate(jp, jcfg, prompt, NEW, max_seq=max_seq)
    _REF[("ref", name)] = ([torch.as_tensor(np.array(x)) for x in steps],
                           torch.as_tensor(np.asarray(jnp.stack(toks, 1)),
                                           dtype=torch.long),
                           torch.as_tensor(np.asarray(greedy),
                                           dtype=torch.long))
    return _REF[("ref", name)]


def _run_mesh(world, tmp):
    spec = [dict(name=n, arch=c[0], changes=c[1], max_seq=c[2], seq=c[3],
                 prompt=_prompt(_cfg(n)), params=_params(n))
            for n, c in CASES.items() if world in c[4]]
    path = os.path.join(tmp, "spec.pt")
    torch.save(spec, path)
    _spawn(world, ["-c", WORKER.format(src=os.path.join(_ROOT, "src"),
                                       new=NEW), path, tmp])
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    return _run_mesh(2, str(tmp_path_factory.mktemp("serve2")))


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    return _run_mesh(4, str(tmp_path_factory.mktemp("serve4")))


RUNS = [pytest.param(w, n, id=f"mesh{w // 2}x2-{n}")
        for n, c in CASES.items() for w in c[4]]


def _check_steps(ranks, world, name, steps, toks):
    """Every rank's logits, gathered over the vocab, against ``steps`` on
    its DP rows; its greedy tokens equal to ``toks``."""
    w = BATCH // (world // 2)
    cfg = _cfg(name)
    for dp in range(world // 2):
        mine = sorted((r for r in ranks if r["dp_rank"] == dp),
                      key=lambda r: r["model_rank"])
        rows = slice(dp * w, (dp + 1) * w)
        for i, want in enumerate(steps):
            got = torch.cat([r[name]["logits"][i] for r in mine], dim=-1)
            assert all(r[name]["logits"][i].shape[-1] == cfg.vocab // 2
                       for r in mine)
            assert float((got - want[rows]).abs().max()) <= \
                LOGIT_RTOL * float(want[rows].abs().max()), (name, i)
        for r in mine:
            assert torch.equal(r[name]["tokens"], toks[rows])


@pytest.mark.parametrize("world,name", RUNS)
def test_prefill_and_decode_logits_match_one_process(request, world, name):
    ranks = request.getfixturevalue(f"run{world}")
    steps, toks, _ = _one_process(name)
    _check_steps(ranks, world, name, steps, toks)


@pytest.mark.parametrize("world,name", RUNS)
def test_prefill_decode_and_generate_match_reference(request, world, name):
    """The same against the reference's ``prefill`` and ``decode_step`` on
    one device, and ``generate``'s greedy tokens equal to its."""
    ranks = request.getfixturevalue(f"run{world}")
    steps, toks, greedy = _reference(name)
    _check_steps(ranks, world, name, steps, toks)
    w = BATCH // (world // 2)
    for r in ranks:
        rows = slice(r["dp_rank"] * w, (r["dp_rank"] + 1) * w)
        assert torch.equal(r[name]["greedy"], greedy[rows])


@pytest.mark.parametrize("world,name", RUNS)
def test_generate_tokens_equal_on_every_rank(request, world, name):
    ranks = request.getfixturevalue(f"run{world}")
    _, _, greedy = _one_process(name)
    w = BATCH // (world // 2)
    cache_dim = {"phi3_slots": 2, "phi3_window8": 2, "stablelm_dh": 4,
                 "qwen_mrope_seq": 2, "musicgen_kv_heads": 2}[name]
    for r in ranks:
        rows = slice(r["dp_rank"] * w, (r["dp_rank"] + 1) * w)
        assert torch.equal(r[name]["greedy"], greedy[rows])
        twin = next(x for x in ranks if x["dp_rank"] == r["dp_rank"])
        assert torch.equal(r[name]["sampled"], twin[name]["sampled"])
        assert r[name]["cache_dim"] == cache_dim
        assert r[name]["sampled"].shape == (w, PROMPT + NEW)
