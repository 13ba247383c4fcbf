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
  the gating state replicates), summed. ``temp_bytes`` and the peak
  estimate stay the one-device, unsharded step's (``temp_scope`` says
  so): the step runs unsharded on ``meta``. The CLI records this figure
  for each mesh of ``--mesh`` (16 × 16, 2 × 16 × 16) as
  ``argument_bytes_per_device_by_mesh``, on an ``AbstractMesh``.
* collectives: none counted yet. The step runs unsharded on ``meta``
  here; every family's tensor-parallel step (``launch/spmd``) runs over
  real ranks, and counting its collectives on the fake 256- and 512-rank
  meshes is ``ROADMAP.md`` Queue 1 item 10e.

The step has no host reads inside (``launch/train``), so every cell runs
on ``meta``; an op that needed data would fail here.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out build/dryrun [--sparsity] [--force]

Not ported: ``parse_collectives`` (it parses XLA HLO) and the reference's
probe compiles (``cost_analysis`` counts a loop body once; eager counting
sees every layer).
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


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, *,
               hp: Optional[TrainHParams] = None, attn: str = "flash",
               loss_chunk: Optional[int] = None, mesh=None) -> Dict[str, Any]:
    """Run the cell's step once on ``meta`` and return the reference's
    record keys that have a meaning on one device (module docstring); with
    ``mesh`` (an LM mesh of any kind) also the per-device argument bytes
    under its placements."""
    hp = hp or TrainHParams()
    rec: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name,
                           "mesh": MESH_NAME, "n_devices": 1, "kind": shape.kind,
                           "n_layers": cfg.n_layers, "attn": attn,
                           "loss_chunk": loss_chunk}
    parts = cell_arguments(cfg, shape, hp)
    args = [x for p in parts.values() for x in tensors(p)]
    if shape.kind == "train":
        step = make_train_step(cfg, hp, attn=attn, loss_chunk=loss_chunk)

        def run():
            return step(parts["params"], parts["opt_state"],
                        parts["sparse_state"], parts["batch"])
    elif shape.kind == "prefill":
        def run():
            with torch.no_grad():
                return T.forward(parts["params"], cfg,
                                 tokens=parts["batch"].get("tokens"),
                                 embeds=parts["batch"].get("embeds"),
                                 attn=attn)[0]
    else:
        serve = make_serve_step(cfg)

        def run():
            with torch.no_grad():
                return serve(parts["params"], parts["cache"], parts["tokens"])
    live = LiveBytes(args)
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
    if mesh is not None:
        rec["mesh"] = "x".join(str(n) for n in mesh.shape)
        rec["n_devices"] = mesh.size()
        rec["memory"]["argument_bytes_per_device"] = \
            argument_bytes_per_device(cfg, parts, hp, mesh)
        rec["memory"]["temp_scope"] = "one device, unsharded step"
    rec["flops_per_device"] = float(fc.get_total_flops())
    rec["flash_flops"] = float(flash_flops(cfg, shape, hp))
    rec["collective_wire_bytes_per_device"] = 0.0
    rec["collective_payload_bytes"] = 0.0
    rec["collectives"] = {"per_op": {}, "payload_bytes": 0.0,
                          "wire_bytes_per_device": 0.0}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"],
                    help="the production meshes whose per-device argument "
                         "bytes each cell records")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sparsity", action="store_true",
                    help="compact block-N:M on MLP projections")
    ap.add_argument("--mode", default="backprop", choices=["backprop", "local"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", default="",
                    help="comma list: seq, moe (recorded), losschunk[:N] "
                         "(chunked CE), zero1, mb:N")
    args = ap.parse_args(argv)
    opts, hp_kw = parse_opt(args.opt)

    os.makedirs(args.out, exist_ok=True)
    archs = C.ARCH_IDS if args.arch == "all" else [C.normalize(args.arch)]
    shapes = list(C.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {name: AbstractMesh(*PRODUCTION_MESHES[name]) for name in
              {"single": ["16x16"], "multi": ["2x16x16"],
               "both": ["16x16", "2x16x16"]}[args.mesh]}

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        cfg = C.get_config(arch)
        if args.sparsity:
            cfg = cfg.with_sparsity(SparsityConfig(n=2, m=8, block=128,
                                                   targets=("mlp",), mode="compact"))
        hp = TrainHParams(mode=args.mode, **hp_kw)
        for shape_name in shapes:
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
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[ok]     {cid}: lower {rec['lower_s']:.1f}s "
                      f"flops/dev {rec['flops_per_device']:.3e} peak/dev "
                      f"{rec['memory']['peak_estimate_bytes'] / 1e9:.2f} GB")
                n_ok += 1
            except Exception as e:  # a failed cell is a bug in the port
                n_fail += 1
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"[FAIL]   {cid}: {type(e).__name__}: {e}")
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
