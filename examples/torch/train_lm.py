"""End-to-end LM training on the port: any pool arch, any size, on
the card (``--device cuda``, the default) or the CPU.

    # CPU-friendly smoke of the same script:
    PYTHONPATH=src python examples/torch/train_lm.py --preset cpu-small \\
        --steps 60 --device cpu

    # ~100M-param model, a few hundred steps, on the card:
    PYTHONPATH=src python examples/torch/train_lm.py --preset 100m --steps 300

    # any assigned arch at reduced size, with the paper's add-ons:
    PYTHONPATH=src python examples/torch/train_lm.py --arch mixtral_8x7b \\
        --reduced --sparse --gating --mode local --steps 40

Checkpoints + auto-resume: pass --ckpt-dir and re-run the same command after
killing it mid-run; training continues from the last step (bitwise). On the
card a reduced config's heads widen to 64 (``configs.flash_ready``), so
that attention takes the flash kernels; the last line counts the kernels'
launches.
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import repro_torch.configs as C                                      # noqa: E402
from repro_torch.configs.base import ModelConfig, SparsityConfig     # noqa: E402
from repro_torch.core.gating import GatingConfig                     # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import launch_counts                        # noqa: E402
from repro_torch.launch.train import TrainHParams, run_training      # noqa: E402
from repro_torch.optim import AdamWConfig                            # noqa: E402

PRESETS = {
    # ~104M params: 12L d=768 llama-style
    "100m": ModelConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                        vocab=32000, dtype="float32", remat=False),
    # ~8M params: CPU smoke of the same script
    "cpu-small": ModelConfig(name="lm-8m", family="dense", n_layers=4,
                             d_model=256, n_heads=4, n_kv_heads=2, d_ff=688,
                             vocab=4096, dtype="float32", remat=False),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default=None)
    ap.add_argument("--arch", default=None, help="assigned arch id")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mode", choices=["backprop", "local"], default="backprop")
    ap.add_argument("--sparse", action="store_true",
                    help="block-N:M (2:8) on MLPs with DSST")
    ap.add_argument("--gating", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.arch:
        cfg = C.get_reduced(args.arch) if args.reduced else C.get_config(args.arch)
        cfg = dataclasses.replace(cfg, dtype="float32") if args.reduced else cfg
    else:
        cfg = PRESETS[args.preset or "cpu-small"]
    if args.device != "cpu":
        cfg = C.flash_ready(cfg)
    if args.sparse:
        block = 8 if cfg.d_ff <= 1024 else 128
        cfg = cfg.with_sparsity(SparsityConfig(n=2, m=8, block=block,
                                               targets=("mlp",), mode="masked"))
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"mode={args.mode} sparse={bool(cfg.sparsity)} gating={args.gating}")

    hp = TrainHParams(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                        total_steps=args.steps),
        mode=args.mode,
        gating=GatingConfig() if args.gating else None,
        dsst_every=25 if args.sparse else 0)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch))

    def cb(step, m):
        if step % 10 == 0:
            print(f"  step {step:4d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  gate {float(m['gate_frac']):.2f}")

    _, hist = run_training(cfg, hp, pipe, args.steps, ckpt_dir=args.ckpt_dir,
                           log_every=max(1, args.steps // 20), callback=cb,
                           device=args.device)
    print(f"final: loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}, "
          f"{sum(hist['step_time'])/len(hist['step_time'])*1e3:.0f} ms/step")
    print("kernels " + json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
