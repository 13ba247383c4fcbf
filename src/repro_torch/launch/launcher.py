"""Fleet launcher (``repro.launch.launcher``): the entry point a
multi-host deployment runs.

* ``fleet_init()`` — env-driven distributed init: with
  ``COORDINATOR_ADDRESS``, ``PROCESS_COUNT`` and ``PROCESS_ID`` set it
  joins ``torch.distributed`` over ``tcp://COORDINATOR_ADDRESS`` (NCCL on
  the card, gloo on the CPU); without them it is single host and
  initialises nothing;
* ``launch_train()`` — config, data shard per host, checkpoint and resume
  around ``launch/train.make_train_step``;
* the CLI: ``python -m repro_torch.launch.launcher --arch <id>
  [--opt losschunk,flash,zero1,mb:4] [--validate] [--device cpu] ...``.

The reference reduces the config (``make_reduced``) when its production
mesh (256 or 512 devices) cannot be built and trains on what it has. The
port has no LM mesh until ``ROADMAP.md`` Queue 1 item 10b, so a run always
takes that local branch, on ``--device`` (default ``cuda``), and a fleet
of more than one process is refused there (its replicas would train
apart, with no gradient all-reduce). ``--validate`` runs
``dryrun.lower_cell`` on the **full** config: a dry run on ``meta``
tensors needs no devices, where the reference's lowering for a mesh did.
``--opt``: ``losschunk`` → chunked cross entropy (512), ``flash`` → the
flash route (else plain attention), ``mb:N`` microbatches, ``zero1``
(no effect on one device); ``seq`` and ``moe`` are accepted and printed.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch


def fleet_init(device="cuda") -> tuple[int, int]:
    """Initialise ``torch.distributed`` from scheduler env vars. Returns
    (rank, world size); ``(0, 1)`` on a single host, where nothing is
    initialised."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    if not coord:
        return 0, 1
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group(
            backend="nccl" if torch.device(device).type == "cuda" else "gloo",
            init_method="tcp://" + coord,
            world_size=int(os.environ["PROCESS_COUNT"]),
            rank=int(os.environ["PROCESS_ID"]))
    return dist.get_rank(), dist.get_world_size()


def parse_opt(opt: str):
    """``--opt`` as the reference's launcher reads it: (step kwargs,
    TrainHParams kwargs, the options printed)."""
    parts = opt.split(",")
    step_kw = {"attn": "flash" if "flash" in opt else "plain",
               "loss_chunk": 512 if "losschunk" in opt else None}
    hp_kw = {"zero1": "zero1" in opt,
             "microbatch": next((int(o.split(":")[1]) for o in parts
                                 if o.startswith("mb:")), 1)}
    shown = {"seq_shard": "seq" in opt, "shardmap_moe": "moe" in opt,
             **step_kw}
    return step_kw, hp_kw, shown


def launch_train(arch: str, *, multi_pod: bool, opt: str, steps: int,
                 seq_len: int, global_batch: int, ckpt_dir: Optional[str],
                 validate_only: bool, device="cuda") -> int:
    from .. import checkpoint as ckpt
    from .. import configs as C
    from ..configs.base import ShapeConfig
    from ..data.pipeline import PipelineConfig, synthetic_lm_batch
    from .train import TrainHParams, init_train_state, make_train_step

    pid, pcount = fleet_init(device)
    cfg = C.get_config(arch)
    step_kw, hp_kw, shown = parse_opt(opt)
    hp = TrainHParams(**hp_kw)

    if validate_only:
        from .dryrun import lower_cell
        shape = ShapeConfig("validate", seq_len, global_batch, "train")
        rec = lower_cell(cfg, shape, hp=hp, **step_kw)
        if pid == 0:
            print(f"[launcher] {cfg.name} hosts={pcount} opts={shown} "
                  f"zero1={hp.zero1} mb={hp.microbatch} multi_pod={multi_pod}")
            print(f"[launcher] validate OK: lower {rec['lower_s']:.1f}s, "
                  f"peak/dev {rec['memory']['peak_estimate_bytes'] / 1e9:.1f}"
                  f" GB (one device, unsharded)")
        return 0

    if pcount > 1:
        raise NotImplementedError(
            f"{pcount} processes would train apart: data parallelism needs "
            "the LM mesh of ROADMAP.md Queue 1 item 10b")
    cfg = C.make_reduced(cfg)        # no production mesh: the local branch
    dev = torch.device(device)
    if pid == 0:
        print(f"[launcher] {cfg.name} device={dev} hosts={pcount} "
              f"opts={shown} zero1={hp.zero1} mb={hp.microbatch}")
    params, opt_state, sparse_state = init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, hp, dev)
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch)
    step_fn = make_train_step(cfg, hp, **step_kw)
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        start, (params, opt_state, sparse_state), _ = ckpt.restore(
            ckpt_dir, (params, opt_state, sparse_state))
        start += 1
    for step in range(start, steps):
        batch = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in
                 synthetic_lm_batch(pcfg, step, pid, pcount).items()}
        params, opt_state, sparse_state, m = step_fn(
            params, opt_state, sparse_state, batch)
        if pid == 0 and step % 10 == 0:
            print(f"  step {step} loss {float(m['loss']):.4f}")
        if ckpt_dir and step % 50 == 49 and pid == 0:
            ckpt.save(ckpt_dir, step, (params, opt_state, sparse_state))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--multi-pod", action="store_true",
                    help="recorded only: the port has no LM mesh yet")
    ap.add_argument("--opt", default="seq,losschunk,zero1,mb:4,moe")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--validate", action="store_true",
                    help="dry run on meta tensors (CI gate), no execution")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return launch_train(args.arch, multi_pod=args.multi_pod, opt=args.opt,
                        steps=args.steps, seq_len=args.seq_len,
                        global_batch=args.global_batch,
                        ckpt_dir=args.ckpt_dir, validate_only=args.validate,
                        device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
