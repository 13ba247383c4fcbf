"""Dry run on ``meta`` tensors (``repro.launch.dryrun``): the memory and
flops of every (arch × shape) cell, computed on no device.

The reference lowers and compiles each cell for its production meshes on
512 forced host devices and reads XLA's memory and cost analyses. Eager
torch has no such lowering; here the cell's step runs once on ``meta``
tensors (shapes and dtypes, no data, no memory), which needs no card:

* ``memory.argument_bytes`` — exact: the params
  (``transformer.init_params_shaped``), and for a train cell the AdamW
  moments, the ``SparseTrainState`` and the batch; for prefill the batch;
  for decode the cache and the tokens (``argument_bytes_by_part``). Host
  ints (AdamW's step, the cache's position) take no device bytes, where
  the reference counts a 4-byte scalar; token and label ids are int64, the
  width the port's steps index with (the reference's are int32).
* ``memory.peak_estimate_bytes`` — the argument bytes plus
  ``temp_bytes``, the most bytes that the step's own tensors hold at once:
  :class:`LiveBytes` adds a storage when an op creates it and takes it off
  when it is freed.
* ``flops_per_device`` — ``torch.utils.flop_counter.FlopCounterMode``
  over the step (matmuls, as XLA's count is dominated by them). On
  ``meta`` the flash op takes its plain route (``kernels/flash_attn/ops``),
  which computes the full ``S×S`` products, twice the causal half that the
  kernels compute, and recomputes its forward in its backward; so does its
  memory. ``flash_flops`` is that route's share of ``flops_per_device``,
  counted the same way on one call and multiplied by the calls.
* ``memory.argument_bytes_per_device`` (with ``mesh``) — each argument
  leaf's local block under the reference's placements on that mesh
  (``launch.sharding``: ``tree_shardings`` for the params,
  ``opt_state_shardings`` for the moments with ``zero1`` and
  ``tree_shardings`` without, ``batch_shardings``, ``cache_shardings``;
  the gating state replicates), summed.
* collectives and per-device memory (with a ``DeviceMesh``): the cell's
  step runs a second time, tensor-parallel on ``meta`` as rank 0 of the
  mesh runs it (:func:`tensor_parallel_cell`) over a fake process group
  of the mesh's size (``mesh.init_fake_group``: every collective is a
  no-op that returns at once): the parameters placed by the rules
  (``train.place_params``), their moments, the batch's and the tokens'
  blocks, the cache placed (``init_cache(mesh=)``), the train step
  data- and tensor-parallel, ``forward`` for prefill, the serve step for
  decode. ``spmd.count_collectives`` counts what it issues:
  ``collectives.per_op[op] = {count, payload_bytes, wire_bytes}``,
  ``collective_payload_bytes`` and ``collective_wire_bytes_per_device``,
  by the reference's ring model over the group each call names
  (``spmd.CollectiveCounter``). Every rank of the SPMD step issues the
  same calls, so rank 0's are a device's. The same run's
  :class:`LiveBytes` gives ``memory.temp_bytes_per_device`` and
  ``peak_estimate_bytes_per_device`` (its argument bytes plus those):
  the per-device counterpart of the reference's ``memory_analysis()``.
  ``temp_bytes`` and ``peak_estimate_bytes`` stay the one-device,
  unsharded step's (``temp_scope`` says which is which).

The CLI records, for each mesh of ``--mesh`` (16 × 16, 2 × 16 × 16),
``argument_bytes_per_device_by_mesh``, ``collectives_by_mesh`` and
``peak_estimate_bytes_per_device_by_mesh`` (and ``temp_bytes_..``); the
reference's top-level keys hold the first mesh's (``collectives_mesh``).
One process holds one default group, so each mesh's fake group is built,
serves every cell, and is destroyed before the next. The cells are shared
among up to MAX_WORKERS processes (no more than the host's cores or the
cells), whose tallies are summed; a process that ends without its tally
counts as a failed cell. A failed cell writes its ``.err`` and counts as
``fail``.

Neither step has a host read inside (``launch/train``; the MoE dispatch
over the global batch takes its static bound on ``meta``,
``models/moe._own_runs``), so every cell runs on ``meta``; an op that
needed data would fail here.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out build/dryrun [--sparsity] [--force]

Not ported, by design: ``parse_collectives`` (it parses XLA HLO; here the
eager calls are counted as they are issued) and the reference's probe
compiles (``cost_analysis`` counts a loop body once; eager counting sees
every layer).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from .. import configs as C
from ..checkpoint.checkpoint import _flatten
from ..configs.base import ModelConfig, ShapeConfig, SparsityConfig
from ..kernels.flash_attn.ops import flash_attention
from ..models import transformer as T
from ..optim import SparseTrainState, adamw_init
from . import sharding as SH
from . import spmd
from .mesh import AbstractMesh
from .serve import make_serve_step
from .train import TrainHParams, make_train_step

META = torch.device("meta")
MESH_NAME = "1"                      # the step runs on one device
PRODUCTION_MESHES = {"16x16": ((16, 16), ("data", "model")),
                     "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops create inside the mode: each is
    added when an op first returns it and taken off when it is freed;
    ``peak`` is the most at once. Storages of ``known`` tensors (the
    arguments, which in-place ops and views return) are never counted."""

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in known:
            self._seen[t.untyped_storage()] = None

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                t = getattr(t, "_local_tensor", t)  # a DTensor: its block
                st = t.untyped_storage()
                if st not in self._seen:
                    self._seen[st] = None
                    n = st.nbytes()
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, n)
        return out


def tensors(tree):
    return [x for _, x in _flatten(tree) if isinstance(x, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Device bytes of a tree's tensor leaves (host ints take none)."""
    return sum(x.numel() * x.element_size() for x in tensors(tree))


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    ids = torch.int64
    if shape.kind in ("train", "prefill"):
        labels = torch.empty((b, s), dtype=ids, device=META)
        if cfg.frontend:  # vlm/audio: precomputed patch/frame embeddings (stub)
            return {"embeds": torch.empty((b, s, cfg.frontend_dim),
                                          dtype=getattr(torch, cfg.dtype),
                                          device=META),
                    "labels": labels}
        return {"tokens": torch.empty((b, s), dtype=ids, device=META),
                "labels": labels}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": torch.empty((b,), dtype=ids, device=META),
            "cache": T.init_cache(cfg, b, s, device=META)}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def attn_calls(cfg: ModelConfig) -> int:
    """Flash-op calls in one forward: one a layer for the attention
    families, one a shared-block call for the hybrid, none for ssm."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    return cfg.n_layers


def _flash_call_flops(cfg: ModelConfig, b: int, s: int, grad: bool) -> int:
    """FlopCounterMode's count of one flash-op call on ``meta`` (its plain
    route), with its backward when ``grad``."""
    dt = getattr(torch, cfg.dtype)
    q = torch.empty((b, s, cfg.n_heads, cfg.head_dim), dtype=dt, device=META,
                    requires_grad=grad)
    k, v = (torch.empty((b, s, cfg.n_kv_heads, cfg.head_dim), dtype=dt,
                        device=META, requires_grad=grad) for _ in range(2))
    with FlopCounterMode(display=False) as fc, torch.set_grad_enabled(grad):
        out = flash_attention(q, k, v, cfg.swa_window)
        if grad:
            out.backward(torch.empty_like(out))
    return fc.get_total_flops()


def flash_flops(cfg: ModelConfig, shape: ShapeConfig, hp: TrainHParams) -> int:
    """The flash op's share of the cell's count: per call, forward (and
    for training its backward, plus one more forward under remat), times
    the calls (times the microbatches)."""
    calls = attn_calls(cfg)
    if not calls or shape.kind == "decode":
        return 0
    if shape.kind == "prefill":
        return calls * _flash_call_flops(cfg, shape.global_batch,
                                         shape.seq_len, False)
    k = hp.microbatch
    b = shape.global_batch // k
    per = _flash_call_flops(cfg, b, shape.seq_len, True)
    if cfg.remat:
        per += _flash_call_flops(cfg, b, shape.seq_len, False)
    return calls * k * per


def cell_arguments(cfg: ModelConfig, shape: ShapeConfig,
                   hp: TrainHParams) -> Dict[str, Any]:
    """The cell's step arguments on ``meta``, by part: params, and for
    train ``opt_state``, ``sparse_state`` and ``batch``; for prefill
    ``batch`` (no labels); for decode ``cache`` and ``tokens``."""
    spec = input_specs(cfg, shape)
    if shape.kind == "train":
        params = T.init_params_shaped(cfg, local_heads=hp.mode == "local")
        return {"params": params, "opt_state": adamw_init(params),
                "sparse_state": SparseTrainState.init(cfg.n_layers,
                                                      cfg.d_model, META),
                "batch": spec}
    params = T.init_params_shaped(cfg)
    if shape.kind == "prefill":
        return {"params": params,
                "batch": {k: v for k, v in spec.items() if k != "labels"}}
    return {"params": params, "cache": spec["cache"], "tokens": spec["tokens"]}


def _leaf_pairs(tree, shardings):
    """(leaf, its NamedSharding) over a tree and its shardings tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaf_pairs(tree[k], shardings[k])
    elif isinstance(tree, (tuple, list)):
        for a, b in zip(tree, shardings):
            yield from _leaf_pairs(a, b)
    else:
        yield tree, shardings


def argument_shardings(cfg: ModelConfig, parts: Dict[str, Any],
                       hp: TrainHParams, mesh) -> Dict[str, Any]:
    """The reference's placements of the cell's arguments, by part."""
    out = {"params": SH.tree_shardings(parts["params"], cfg, mesh)}
    if "opt_state" in parts:
        out["opt_state"] = (
            SH.opt_state_shardings(parts["opt_state"], parts["params"], cfg,
                                   mesh) if hp.zero1 else
            SH.tree_shardings(parts["opt_state"], cfg, mesh))
        out["sparse_state"] = SH.tree_map_with_path(
            lambda _p, _x: SH.replicated(mesh), parts["sparse_state"])
    if "batch" in parts:
        out["batch"] = SH.batch_shardings(parts["batch"], mesh)
    if "cache" in parts:
        out["cache"] = SH.cache_shardings(parts["cache"], cfg, mesh)
        out["tokens"] = SH.batch_shardings(parts["tokens"], mesh)
    return out


def argument_bytes_per_device(cfg: ModelConfig, parts: Dict[str, Any],
                              hp: TrainHParams, mesh) -> int:
    """One device's bytes of the cell's arguments under the reference's
    placements on ``mesh``: each tensor leaf's local block."""
    shardings = argument_shardings(cfg, parts, hp, mesh)
    return sum(math.prod(sh.shard_shape(x.shape)) * x.element_size()
               for k in parts for x, sh in _leaf_pairs(parts[k], shardings[k])
               if isinstance(x, torch.Tensor))


def _block(x: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of a ``meta`` tensor under ``sharding``."""
    return torch.empty(SH.shard_shape(sharding.spec, tuple(x.shape),
                                      sharding.mesh), dtype=x.dtype,
                       device=META)


def placed_arguments(cfg: ModelConfig, shape: ShapeConfig, hp: TrainHParams,
                     mesh) -> Dict[str, Any]:
    """The cell's step arguments on ``meta`` placed by the rules on a
    ``DeviceMesh``, as each rank holds them: the params ``DTensor`` s
    (``train.place_params``), the moments of their placements (ZeRO-1's
    blocks with ``hp.zero1``), the batch's and the tokens' blocks
    (``batch_shardings``), the cache placed (``init_cache(mesh=)``:
    ``cache_shardings``)."""
    from .train import DataParallel, place_params
    parts = cell_arguments(cfg, shape, hp)
    out = {"params": place_params(parts["params"], cfg, mesh)}
    if shape.kind == "train":
        dp = DataParallel(mesh, cfg, hp)
        out["opt_state"] = adamw_init(out["params"],
                                      dp.zero1_layout(out["params"]))
        out["sparse_state"] = parts["sparse_state"]
    if "batch" in parts:
        sh = SH.batch_shardings(parts["batch"], mesh)
        out["batch"] = {k: _block(v, sh[k]) for k, v in parts["batch"].items()}
        return out
    tokens = _block(parts["tokens"], SH.batch_shardings(parts["tokens"], mesh))
    out["tokens"] = tokens
    out["cache"] = T.init_cache(cfg, tokens.shape[0], shape.seq_len,
                                device=META, mesh=mesh)
    return out


def _locals(tree):
    """The tensors of a placed tree, each ``DTensor`` as its local block."""
    return [getattr(x, "_local_tensor", x) for x in tensors(tree)]


def cell_step(cfg: ModelConfig, shape: ShapeConfig, hp: TrainHParams,
              attn: str, loss_chunk: Optional[int], parts: Dict[str, Any],
              mesh=None):
    """The cell's step on ``parts`` as a thunk: the train step, ``forward``
    for prefill, the serve step for decode (the data-parallel step over
    ``mesh`` where one is given)."""
    if shape.kind == "train":
        step = make_train_step(cfg, hp, attn=attn, loss_chunk=loss_chunk,
                               mesh=mesh)
        return lambda: step(parts["params"], parts["opt_state"],
                            parts["sparse_state"], parts["batch"])
    if shape.kind == "prefill":
        def run():
            with torch.no_grad():
                return T.forward(parts["params"], cfg,
                                 tokens=parts["batch"].get("tokens"),
                                 embeds=parts["batch"].get("embeds"),
                                 attn=attn)[0]
        return run
    serve = make_serve_step(cfg)

    def run():
        with torch.no_grad():
            return serve(parts["params"], parts["cache"], parts["tokens"])
    return run


def tensor_parallel_cell(cfg: ModelConfig, shape: ShapeConfig,
                         hp: TrainHParams, attn: str,
                         loss_chunk: Optional[int], mesh,
                         spmd_opts: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """The cell's step run tensor-parallel on ``meta`` as one rank of
    ``mesh`` (a ``DeviceMesh``: a fake process group of its size serves)
    runs it, under ``spmd.activate(mesh, **spmd_opts)``: its collectives
    (``spmd.count_collectives``), the most bytes its own tensors hold at
    once (``LiveBytes``) and its wall."""
    parts = placed_arguments(cfg, shape, hp, mesh)
    run = cell_step(cfg, shape, hp, attn, loss_chunk, parts, mesh=mesh)
    live = LiveBytes(_locals(parts))
    t0 = time.perf_counter()
    with spmd.activate(mesh, **(spmd_opts or {})), \
            spmd.count_collectives() as counter, live:
        out = run()
    del out
    return {"lower_s": time.perf_counter() - t0, "temp_bytes": live.peak,
            "collectives": counter.record()}


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, *,
               hp: Optional[TrainHParams] = None, attn: str = "flash",
               loss_chunk: Optional[int] = None, mesh=None,
               spmd_opts: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run the cell's step once on ``meta`` and return the reference's
    record keys that have a meaning on one device (module docstring). With
    ``mesh`` (an LM mesh of any kind) also the per-device argument bytes
    under its placements; with a ``DeviceMesh`` (a real or fake process
    group) the step also runs tensor-parallel on ``meta`` as one of its
    ranks (:func:`tensor_parallel_cell`, under ``spmd_opts``): the
    collectives, the per-device temp bytes and peak estimate."""
    hp = hp or TrainHParams()
    rec: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name,
                           "mesh": MESH_NAME, "n_devices": 1, "kind": shape.kind,
                           "n_layers": cfg.n_layers, "attn": attn,
                           "loss_chunk": loss_chunk}
    parts = cell_arguments(cfg, shape, hp)
    run = cell_step(cfg, shape, hp, attn, loss_chunk, parts)
    live = LiveBytes(tensors(parts))
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, live:
        out = run()
    rec["lower_s"] = time.perf_counter() - t0
    del out
    by_part = {k: tree_bytes(v) for k, v in parts.items()}
    arg_bytes = sum(by_part.values())
    rec["memory"] = {"argument_bytes": arg_bytes,
                     "argument_bytes_by_part": by_part,
                     "temp_bytes": live.peak,
                     "peak_estimate_bytes": arg_bytes + live.peak}
    rec["flops_per_device"] = float(fc.get_total_flops())
    rec["flash_flops"] = float(flash_flops(cfg, shape, hp))
    coll = {"per_op": {}, "payload_bytes": 0.0, "wire_bytes_per_device": 0.0}
    if mesh is not None:
        rec["mesh"] = "x".join(str(n) for n in mesh.shape)
        rec["n_devices"] = mesh.size()
        mem = rec["memory"]
        mem["argument_bytes_per_device"] = \
            argument_bytes_per_device(cfg, parts, hp, mesh)
        if hasattr(mesh, "get_group"):
            tp = tensor_parallel_cell(cfg, shape, hp, attn, loss_chunk, mesh,
                                      spmd_opts)
            rec["tp_lower_s"] = tp["lower_s"]
            coll = tp["collectives"]
            mem["temp_bytes_per_device"] = tp["temp_bytes"]
            mem["peak_estimate_bytes_per_device"] = \
                mem["argument_bytes_per_device"] + tp["temp_bytes"]
        mem["temp_scope"] = "one device, unsharded step" + (
            "; *_per_device: one rank's tensor-parallel step on meta"
            if hasattr(mesh, "get_group") else "")
    rec["collective_wire_bytes_per_device"] = coll["wire_bytes_per_device"]
    rec["collective_payload_bytes"] = coll["payload_bytes"]
    rec["collectives"] = coll
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def cell_id(arch: str, shape: str, mesh_name: str, tag: str = "") -> str:
    return f"{arch}__{shape}__{mesh_name}" + (f"__{tag}" if tag else "")


def parse_opt(opt: str):
    """``--opt`` as the reference reads it: (opts, TrainHParams kwargs).
    ``seq`` and ``moe`` are recorded and change nothing on one device."""
    opts = {"seq_shard": False, "shardmap_moe": False, "loss_chunk": 0}
    hp_kw: Dict[str, Any] = {}
    for o in filter(None, opt.split(",")):
        if o == "seq":
            opts["seq_shard"] = True
        elif o == "moe":
            opts["shardmap_moe"] = True
        elif o.startswith("losschunk"):
            opts["loss_chunk"] = int(o.split(":")[1]) if ":" in o else 512
        elif o == "zero1":
            hp_kw["zero1"] = True
        elif o.startswith("mb"):
            hp_kw["microbatch"] = int(o.split(":")[1])
    return opts, hp_kw


MESH_CHOICES = {"single": ["16x16"], "multi": ["2x16x16"],
                "both": ["16x16", "2x16x16"]}


def _fake_mesh(name: str):
    """A fake process group of the production mesh ``name``'s size in this
    process (one default group a process: the caller destroys it) and the
    mesh over it."""
    from .mesh import init_fake_group, make_production_mesh
    shape, _ = PRODUCTION_MESHES[name]
    init_fake_group(math.prod(shape))
    return make_production_mesh(multi_pod=len(shape) == 3, device="cpu")


# the processes that share the CLI's cells: the 40 cells on both meshes
# take ~110 s with 3 on the 8 cores of an H100 host beside other work
MAX_WORKERS = 3


def _run_jobs(argv, jobs: int) -> int:
    """``main`` over ``jobs`` processes, each its share of the cells
    (``--part i/jobs``); their output passed through, the tallies summed.
    A process that printed no tally (it crashed outside a cell's ``try``)
    or that exited with another code than 0 or 1 counts as one failed
    cell."""
    import subprocess
    import sys
    import tempfile
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    tally = [0, 0, 0]
    with tempfile.TemporaryDirectory() as tmp:
        logs = [os.path.join(tmp, f"part{i}.log") for i in range(jobs)]
        procs = []
        for i, path in enumerate(logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                     "--part", f"{i}/{jobs}"],
                    stdout=f, text=True, env=env))
        for i, (proc, path) in enumerate(zip(procs, logs)):
            proc.wait()
            tallied = False
            with open(path) as f:
                for line in f.read().splitlines():
                    if line.startswith("done: "):
                        tallied = True
                        for j, kv in enumerate(line[6:].split()):
                            tally[j] += int(kv.split("=")[1])
                    else:
                        print(line)
            if not tallied or proc.returncode not in (0, 1):
                tally[2] += 1
                print(f"[FAIL]   part {i}/{jobs} exited {proc.returncode}"
                      + ("" if tallied else " without its tally"))
    print(f"done: ok={tally[0]} skip={tally[1]} fail={tally[2]}")
    return 1 if tally[2] else 0


def main(argv=None) -> int:
    import sys
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=list(MESH_CHOICES),
                    help="the production meshes each cell also runs on, "
                         "tensor-parallel on meta over a fake process group "
                         "of their size")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sparsity", action="store_true",
                    help="compact block-N:M on MLP projections")
    ap.add_argument("--mode", default="backprop", choices=["backprop", "local"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", default="",
                    help="comma list: seq (sequence-parallel boundaries on "
                         "the meshes), moe (shard-mapped dispatch), "
                         "losschunk[:N] (chunked CE), zero1, mb:N")
    # a worker's share of the cells (set by _run_jobs)
    ap.add_argument("--part", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = C.ARCH_IDS if args.arch == "all" else [C.normalize(args.arch)]
    shapes = list(C.SHAPES) if args.shape == "all" else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]
    if args.part is None:
        workers = min(MAX_WORKERS, os.cpu_count() or 1, len(cells))
        if workers > 1:
            return _run_jobs(sys.argv[1:] if argv is None else list(argv),
                             workers)
    part, n_parts = map(int, (args.part or "0/1").split("/"))
    opts, hp_kw = parse_opt(args.opt)

    os.makedirs(args.out, exist_ok=True)
    mesh_names = MESH_CHOICES[args.mesh]
    meshes = {name: AbstractMesh(*PRODUCTION_MESHES[name])
              for name in mesh_names}

    n_ok = n_skip = n_fail = 0
    todo = []                 # (cell id, path, cfg, shape, hp, record)
    for arch, shape_name in cells[part::n_parts]:
        cfg = C.get_config(arch)
        if args.sparsity:
            cfg = cfg.with_sparsity(SparsityConfig(n=2, m=8, block=128,
                                                   targets=("mlp",), mode="compact"))
        hp = TrainHParams(mode=args.mode, **hp_kw)
        shape = C.SHAPES[shape_name]
        ok, why = C.shape_applicable(cfg, shape)
        cid = cell_id(arch, shape_name, MESH_NAME, args.tag)
        path = os.path.join(args.out, cid + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[cached] {cid}")
            n_ok += 1
            continue
        if not ok:
            with open(path, "w") as f:
                json.dump({"arch": cfg.name, "shape": shape_name,
                           "mesh": MESH_NAME, "skipped": why}, f, indent=1)
            print(f"[skip]   {cid}: {why}")
            n_skip += 1
            continue
        try:
            rec = lower_cell(cfg, shape, hp=hp,
                             loss_chunk=opts["loss_chunk"] or None)
            rec["opts"] = dict(opts, mesh_requested=args.mesh)
            parts = cell_arguments(cfg, shape, hp)
            rec["memory"]["argument_bytes_per_device_by_mesh"] = {
                name: argument_bytes_per_device(cfg, parts, hp, m)
                for name, m in meshes.items()}
            todo.append((cid, path, cfg, shape, hp, rec))
        except Exception as e:  # a failed cell is a bug in the port
            n_fail += 1
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"[FAIL]   {cid}: {type(e).__name__}: {e}")

    # each mesh's tensor-parallel steps over a fake group of its size (one
    # default group a process: built, used by every cell, destroyed)
    import torch.distributed as dist
    failed = set()
    for name in mesh_names:
        if not todo:
            break
        mesh = _fake_mesh(name)
        try:
            for cid, path, cfg, shape, hp, rec in todo:
                if cid in failed:
                    continue
                try:
                    # sequence-parallel boundaries only where activations
                    # are saved for a backward (the reference's choice)
                    tp = tensor_parallel_cell(
                        cfg, shape, hp, "flash", opts["loss_chunk"] or None,
                        mesh, {"seq_shard": opts["seq_shard"]
                               and shape.kind == "train",
                               "shardmap_moe": opts["shardmap_moe"]})
                except Exception as e:
                    failed.add(cid)
                    n_fail += 1
                    with open(path + ".err", "w") as f:
                        f.write(f"mesh {name}\n" + traceback.format_exc())
                    print(f"[FAIL]   {cid} on {name}: {type(e).__name__}: {e}")
                    continue
                mem = rec["memory"]
                rec.setdefault("collectives_by_mesh", {})[name] = \
                    tp["collectives"]
                mem.setdefault("temp_bytes_per_device_by_mesh", {})[name] = \
                    tp["temp_bytes"]
                mem.setdefault("peak_estimate_bytes_per_device_by_mesh", {})[
                    name] = mem["argument_bytes_per_device_by_mesh"][name] \
                    + tp["temp_bytes"]
                rec.setdefault("tp_lower_s_by_mesh", {})[name] = \
                    tp["lower_s"]
        finally:
            dist.destroy_process_group()
    for cid, path, cfg, shape, hp, rec in todo:
        if cid in failed:
            continue
        first = mesh_names[0]           # the reference's keys: this mesh's
        coll = rec["collectives_by_mesh"][first]
        rec.update(collectives=coll, collectives_mesh=first,
                   collective_payload_bytes=coll["payload_bytes"],
                   collective_wire_bytes_per_device=coll[
                       "wire_bytes_per_device"])
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        peak = rec["memory"]["peak_estimate_bytes_per_device_by_mesh"]
        print(f"[ok]     {cid}: lower {rec['lower_s']:.1f}s "
              f"flops/dev {rec['flops_per_device']:.3e} peak/dev "
              f"{rec['memory']['peak_estimate_bytes'] / 1e9:.2f} GB; "
              + "; ".join(f"{m}: coll wire/dev {c['wire_bytes_per_device']:.3e}B"
                          f" peak/dev {peak[m] / 1e9:.2f} GB"
                          for m, c in rec["collectives_by_mesh"].items()))
        n_ok += 1
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
