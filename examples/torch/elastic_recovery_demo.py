"""Fault-tolerance drill on the port: kill the training 'fleet' twice,
watch it resume bitwise-identically from checkpoints; flag a straggling
replica.

    PYTHONPATH=src python examples/torch/elastic_recovery_demo.py [--device cpu]

On the card the reduced config's heads widen to 64 (``configs.flash_ready``)
so that every step runs the flash kernels; the last line counts their
launches.
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import repro_torch.configs as C                                       # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, synthetic_lm_batch  # noqa: E402
from repro_torch.kernels import launch_counts                         # noqa: E402
from repro_torch.launch.train import (TrainHParams, init_train_state,  # noqa: E402
                                      make_train_step)
from repro_torch.optim import AdamWConfig                             # noqa: E402
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,    # noqa: E402
                                                 run_with_recovery)


def leaves(tree):
    """The tensors and host values of a state (dicts, tuples, NamedTuples)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    cfg = C.get_reduced("phi3_medium_14b")
    if dev.type != "cpu":
        cfg = C.flash_ready(cfg)
    hp = TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100))
    pcfg = PipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    step = make_train_step(cfg, hp)

    def step_fn(state, i):
        params, opt, ss = state
        batch = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in synthetic_lm_batch(pcfg, i).items()}
        params, opt, ss, m = step(params, opt, ss, batch)
        return (params, opt, ss), {"loss": float(m["loss"])}

    def init():
        # the state is donated to run_with_recovery: a fresh one a run
        return init_train_state(torch.Generator(device=dev).manual_seed(0),
                                cfg, hp, dev)

    n, every = args.steps, max(1, args.steps // 3)
    faults = {int(n * 0.4): 1, int(n * 0.77): 1}
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        print("reference run (no failures)...")
        ref, _ = run_with_recovery(step_fn, init(), n, d1, ckpt_every=every)
        print(f"faulty run: nodes lost at steps {sorted(faults)}...")
        out, log = run_with_recovery(step_fn, init(), n, d2, ckpt_every=every,
                                     fail_at=faults)
        print(f"  restarts: {log['restarts']}, restored from {log['restored_from']}")
        same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                   for a, b in zip(leaves(ref), leaves(out)))
        print(f"  final states bitwise identical: {same}")
        assert same

    mon = HeartbeatMonitor(8)
    rng = np.random.default_rng(0)
    for _ in range(10):
        for r in range(8):
            mon.record(r, (2.4 if r == 3 else 1.0) + rng.normal() * 0.02)
    print(f"straggler policy flags replicas: {mon.stragglers()} (injected: [3])")
    print("kernels " + json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
