"""Quickstart on the port: train a tiny LM dense vs block-N:M sparse (DSST
and gating), on the card (``--device cuda``, the default) or the CPU.

    PYTHONPATH=src python examples/torch/quickstart.py [--steps 60] [--device cpu]

On the card the reduced config's heads widen to 64 (``configs.flash_ready``)
so that attention takes the flash kernels; the last line but one counts
the kernels' launches.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import repro_torch.configs as C                                    # noqa: E402
from repro_torch.configs.base import SparsityConfig                # noqa: E402
from repro_torch.core.gating import GatingConfig                   # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import launch_counts                      # noqa: E402
from repro_torch.launch.train import TrainHParams, run_training    # noqa: E402
from repro_torch.optim import AdamWConfig                          # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    base = C.get_reduced("stablelm_12b")
    if args.device != "cpu":
        base = C.flash_ready(base)
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=args.steps)

    runs = {
        "dense": (base, TrainHParams(opt=opt)),
        "nm_sparse+dsst+gating": (
            base.with_sparsity(SparsityConfig(n=1, m=2, block=8,
                                              targets=("mlp",), mode="masked")),
            TrainHParams(opt=opt, gating=GatingConfig(), dsst_every=10)),
    }
    for name, (cfg, hp) in runs.items():
        pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=64,
                                            global_batch=8))
        _, hist = run_training(cfg, hp, pipe, args.steps, log_every=10,
                               device=args.device)
        print(f"[{name}] loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
              f"({sum(hist['step_time'])/len(hist['step_time'])*1e3:.0f} ms/step)")
    print("kernels " + json.dumps(launch_counts()))
    print("done — sparse run stores 50% of MLP weights and skips gated updates.")


if __name__ == "__main__":
    main()
