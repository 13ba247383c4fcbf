"""Batched serving on the port: prefill a prompt batch (the flash kernel on
the card), decode with KV/SSM caches.

    PYTHONPATH=src python examples/torch/serve_decode.py --arch mixtral_8x7b \\
        --new 24 [--device cpu]

The config is the arch's reduced one (Mixtral-8x7B's serving weights, 93.4
GB, do not fit one card); on the card its heads widen to 64
(``configs.flash_ready``). Weights and prompt come from ``--seed``, so two
runs give the same tokens; the last line counts the kernels' launches.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import repro_torch.configs as C                      # noqa: E402
from repro_torch.kernels import launch_counts        # noqa: E402
from repro_torch.launch.serve import generate        # noqa: E402
from repro_torch.models import transformer as T      # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral_8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = torch.device(args.device)
    cfg = C.get_reduced(args.arch)
    if dev.type != "cpu":
        cfg = C.flash_ready(cfg)
    params = T.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                           cfg, device=dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(
                               args.seed + 1)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    out = generate(params, cfg, prompt, args.new,
                   temperature=args.temperature)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    toks = args.batch * args.new
    print(f"arch={cfg.name} family={cfg.family} "
          f"cache_len={T.cache_len(cfg, args.prompt_len + args.new)}")
    print(f"generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. the kernels' first build)")
    print("first sequence:", out[0].tolist())
    print("kernels " + json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
