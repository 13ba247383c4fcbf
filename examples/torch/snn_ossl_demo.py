"""The paper, end-to-end on the port: ElfCore's (512)-512-512-16 SNN
learning a gesture stream online — no labels for the hidden layers (OSSL),
sparse-to-sparse connectivity learning (DSST), activity-gated weight
updates, and the modeled power at the chip's 0.6 V / 20 MHz operating
point. The timestep engine takes its kernel backend: on the card every
layer-timestep launches ``nm_spmm``, ``lif`` and ``wu_outer``.

    PYTHONPATH=src python examples/torch/snn_ossl_demo.py [--full-size] \\
        [--samples 200] [--device cpu]

Default runs the reduced (64-neuron) chip; --full-size runs the real
512-512-512-16 network. The last line counts the kernels' launches.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch.configs.elfcore_snn import CONFIG, reduced        # noqa: E402
from repro_torch.core.energy import OperatingPoint, report         # noqa: E402
from repro_torch.core.gating import skip_rate                      # noqa: E402
from repro_torch.core.snn import (accuracy, init_params,           # noqa: E402
                                  init_state, make_eval_fn, make_train_fn)
from repro_torch.data.events import make_task                      # noqa: E402
from repro_torch.kernels import launch_counts                      # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--task", default="gesture")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = CONFIG if args.full_size else reduced(t_steps=20)
    task = make_task(args.task, n_in=cfg.n_in, t_steps=cfg.t_steps)
    cfg = dataclasses.replace(cfg, n_out=max(task.n_classes, cfg.n_out),
                              backend="kernels")
    dev = torch.device(args.device)

    print(f"network ({cfg.n_in})-{cfg.n_hidden}-{cfg.n_hidden}-{cfg.n_out}, "
          f"{cfg.sparsity:.0%} sparse, {cfg.t_steps} TS/sample, task={args.task}")

    params = init_params(0, cfg, device=dev)
    state = init_state(cfg, batch=16, device=dev)
    step = make_train_fn(cfg)
    eval_fn = make_eval_fn(cfg)
    rng = np.random.default_rng(1)

    def on_dev(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    sop_f = sop_w = sop_off = 0.0
    t0 = time.time()
    for i in range(args.samples):
        ev, lab = on_dev(*task.sample(rng, 16))
        params, state, m = step(params, state, ev, lab)
        sop_f += float(m.sop_forward)
        sop_w += float(m.sop_wu)
        sop_off += float(m.sop_wu_offered)
        if i % 50 == 0 or i == args.samples - 1:
            ev_e, lab_e = on_dev(*task.sample(np.random.default_rng(7), 64))
            _, me = eval_fn(params, init_state(cfg, batch=64, device=dev), ev_e)
            acc = float(accuracy(me.logits, lab_e))
            print(f"  sample {i:4d}: eval acc {acc:.3f}  "
                  f"gate open {float(m.gate_open_frac):.2f}  "
                  f"local loss {float(m.local_loss):+.3f}")
    wall = time.time() - t0

    per_sample = args.samples * 16
    rep = report(sop_f / per_sample, sop_w / per_sample, sop_off / per_sample,
                 cfg.t_steps, OperatingPoint.low_power())
    print(f"\nmodeled power @0.6V/20MHz: {rep.power_w*1e6:.1f} µW "
          f"(paper: <50 µW all tasks)")
    print(f"WU skip rate (gating): {rep.wu_skip_rate:.2f} "
          f"(gate-level: {float(skip_rate(state.gate)):.2f})")
    print(f"wall time: {wall:.1f}s for {args.samples} samples")
    print("kernels " + json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
