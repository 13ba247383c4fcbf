"""Fleet launcher (``repro.launch.launcher``): the entry point a
multi-host deployment runs; every process runs the same program.

* ``fleet_init()`` — env-driven distributed init: with
  ``COORDINATOR_ADDRESS``, ``PROCESS_COUNT`` and ``PROCESS_ID`` set it
  joins ``torch.distributed`` over ``tcp://COORDINATOR_ADDRESS`` with the
  backend asked for (``--backend``; by default NCCL on the card, gloo on
  the CPU); without them it is single host and initialises nothing;
* ``launch_train()`` — the mesh, the SPMD context, a data shard per
  process, checkpoint and resume around ``launch/train.make_train_step``;
* the CLI: ``python -m repro_torch.launch.launcher --arch <id>
  [--multi-pod] [--opt seq,losschunk,zero1,mb:4,moe,flash] [--validate]
  [--device cpu] [--backend gloo] ...``.

As the reference does, ``launch_train`` tries the production mesh
(``launch.mesh.make_production_mesh``: 256 or 512 ranks); where it cannot
be built it takes the host mesh (``make_host_mesh(model=1)``: data over
every process) and the reduced config, and trains data-parallel on it.
Each process takes the rows of its DP index,
``synthetic_lm_batch(pcfg, step, dp_rank, dp_size)`` (the ranks of one
model group share them); only rank 0 prints and saves. A production mesh
has a model axis of 16: every family trains on it tensor-parallel, its
parameters placed as ``DTensor`` s by the rules
(``launch/train.place_params``), and a checkpoint of that state is written
whole by rank 0 after every rank gathered its blocks
(``checkpoint.save``); a resume restores each rank's blocks. The MoE
family at more than one process trains under ``--opt moe`` with the
shard-mapped dispatch (each process dispatches its own tokens), and
without it with one dispatch over the global batch (the reference's
``pjit`` step). With ``--ckpt-dir`` it saves after every step ``s``
with ``s % CKPT_EVERY == CKPT_EVERY - 1``, as the reference does.

``--validate`` runs ``dryrun.lower_cell`` on the **full** config with the
production mesh: with no process group it builds one of fake ranks (the
counterpart of the reference's forced host device count), so the line
prints the per-device argument bytes under the mesh's placements beside
the one-device, unsharded peak estimate of the step on ``meta``.
``--opt``: ``losschunk`` → chunked cross entropy (512), ``flash`` → the
flash route (else plain attention), ``mb:N`` microbatches, ``zero1`` →
DP-split moments, ``seq`` → sequence-parallel boundaries (nothing to
place on a model axis of 1), ``moe`` → the MoE shard map.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

BACKENDS = ("nccl", "gloo")
CKPT_EVERY = 50         # the reference's cadence


def fleet_init(device="cuda", backend: Optional[str] = None
               ) -> tuple[int, int]:
    """Initialise ``torch.distributed`` from scheduler env vars with
    ``backend`` (default: NCCL for a CUDA ``device``, gloo otherwise).
    Returns (rank, world size); ``(0, 1)`` on a single host, where nothing
    is initialised."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    if not coord:
        return 0, 1
    import torch.distributed as dist
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend=backend, init_method="tcp://" + coord,
            world_size=int(os.environ["PROCESS_COUNT"]),
            rank=int(os.environ["PROCESS_ID"]))
    return dist.get_rank(), dist.get_world_size()


def parse_opt(opt: str):
    """``--opt`` as the reference's launcher reads it: (step kwargs,
    TrainHParams kwargs, the SPMD context's options)."""
    parts = opt.split(",")
    step_kw = {"attn": "flash" if "flash" in opt else "plain",
               "loss_chunk": 512 if "losschunk" in opt else None}
    hp_kw = {"zero1": "zero1" in opt,
             "microbatch": next((int(o.split(":")[1]) for o in parts
                                 if o.startswith("mb:")), 1)}
    shown = {"seq_shard": "seq" in opt, "shardmap_moe": "moe" in opt,
             **step_kw}
    return step_kw, hp_kw, shown


def _ctx_opts(shown) -> dict:
    return {"seq_shard": shown["seq_shard"],
            "shardmap_moe": shown["shardmap_moe"],
            "loss_chunk": shown["loss_chunk"] or 0,
            "flash_attn": shown["attn"] == "flash"}


def launch_train(arch: str, *, multi_pod: bool, opt: str, steps: int,
                 seq_len: int, global_batch: int, ckpt_dir: Optional[str],
                 validate_only: bool, device="cuda",
                 backend: Optional[str] = None) -> int:
    import torch.distributed as dist
    from .. import checkpoint as ckpt
    from .. import configs as C
    from ..configs.base import ShapeConfig
    from ..data.pipeline import PipelineConfig, synthetic_lm_batch
    from ..optim import adamw_init
    from . import spmd
    from .mesh import (axis_sizes, dp_size, init_fake_group, make_host_mesh,
                       make_production_mesh)
    from .train import TrainHParams, init_train_state, make_train_step

    pid, pcount = fleet_init(device, backend)
    cfg = C.get_config(arch)
    step_kw, hp_kw, shown = parse_opt(opt)
    hp = TrainHParams(**hp_kw)
    if validate_only and not dist.is_initialized():
        init_fake_group(512 if multi_pod else 256)
    # the dry run computes on meta: its mesh only names axes and sizes
    mesh_dev = "cpu" if validate_only else device
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=mesh_dev)
    except RuntimeError:
        mesh = make_host_mesh(model=1, device=mesh_dev)   # whatever we have
        cfg = C.make_reduced(cfg)
    group = dist.get_backend() if dist.is_initialized() else None
    if pid == 0:
        print(f"[launcher] {cfg.name} mesh={axis_sizes(mesh)} "
              f"device={torch.device(device)} backend={group} hosts={pcount} "
              f"opts={shown} zero1={hp.zero1} mb={hp.microbatch} "
              f"multi_pod={multi_pod}")

    if validate_only:
        from .dryrun import lower_cell
        shape = ShapeConfig("validate", seq_len, global_batch, "train")
        rec = lower_cell(cfg, shape, hp=hp, mesh=mesh, spmd_opts=_ctx_opts(
            shown), **step_kw)
        if pid == 0:
            mem = rec["memory"]
            per_op = ", ".join(f"{op} {d['count']} calls {d['wire_bytes']:.4e} B"
                               for op, d in rec["collectives"]["per_op"].items())
            print(f"[launcher] validate OK: lower {rec['lower_s']:.1f}s, "
                  f"argument bytes/dev {mem['argument_bytes_per_device']} on "
                  f"{rec['mesh']}, peak/dev "
                  f"{mem['peak_estimate_bytes'] / 1e9:.1f} GB (one device, "
                  f"unsharded)")
            if "peak_estimate_bytes_per_device" in mem:
                print(f"[launcher] tensor-parallel on {rec['mesh']}: "
                      f"collective wire bytes/dev "
                      f"{rec['collective_wire_bytes_per_device']:.4e} "
                      f"({per_op}), peak/dev "
                      f"{mem['peak_estimate_bytes_per_device'] / 1e9:.1f} GB "
                      f"(lower {rec['tp_lower_s']:.1f}s)")
        return 0

    dev = torch.device(device)
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch)
    with spmd.activate(mesh, **_ctx_opts(shown)):
        step_fn = make_train_step(cfg, hp, mesh=mesh, **step_kw)
        dp = step_fn.dp
        params, opt_state, sparse_state = init_train_state(
            torch.Generator(device=dev).manual_seed(0), cfg, hp, dev,
            mesh=mesh)
        layout = dp.zero1_layout(params)
        placed = axis_sizes(mesh).get("model", 1) > 1
        rows, n_rows = spmd.dp_rank(mesh), dp_size(mesh)
        start = 0
        if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
            # a checkpoint holds whole moments; under ZeRO-1 each rank
            # restores them into a meta template and keeps its blocks (a
            # placed state's own moments are the template: each rank keeps
            # its blocks by their placements)
            tpl = adamw_init(_meta_like(params)) if dp.zero1 and not placed \
                else opt_state
            start, (params, opt_state, sparse_state), _ = ckpt.restore(
                ckpt_dir, (params, tpl, sparse_state), device=dev)
            opt_state = dp.local_opt_state(opt_state, layout)
            start += 1
        for step in range(start, steps):
            batch = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in
                     synthetic_lm_batch(pcfg, step, rows, n_rows).items()}
            params, opt_state, sparse_state, m = step_fn(
                params, opt_state, sparse_state, batch)
            if pid == 0 and step % 10 == 0:
                print(f"  step {step} loss {float(m['loss']):.4f}")
            if ckpt_dir and step % CKPT_EVERY == CKPT_EVERY - 1:
                whole = dp.full_opt_state(opt_state, layout)
                if pid == 0 or placed:      # a placed state: a collective
                    ckpt.save(ckpt_dir, step, (params, whole, sparse_state))
                del whole
    return 0


def _meta_like(params):
    """``params``'s tree on ``meta`` (a restore template costs nothing)."""
    from ..optim.optimizer import tree_map
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", default="seq,losschunk,zero1,mb:4,moe")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--validate", action="store_true",
                    help="dry run on meta tensors (CI gate), no execution")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="the process group's backend (default: nccl on "
                         "cuda, gloo on the CPU)")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    try:
        return launch_train(args.arch, multi_pod=args.multi_pod,
                            opt=args.opt, steps=args.steps,
                            seq_len=args.seq_len,
                            global_batch=args.global_batch,
                            ckpt_dir=args.ckpt_dir,
                            validate_only=args.validate, device=args.device,
                            backend=args.backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
