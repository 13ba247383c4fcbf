"""LM serving (``repro.launch.serve``): batched prefill + KV-cache decode.

``make_serve_step`` is the one-token step; ``generate`` the local loop
(greedy, or temperature sampling with one generator per position).
Greedy tokens equal the reference's for the same weights and prompt;
sampled ones come from torch's own random bits. Under an active tracer
(``obs.trace.use``) ``generate`` records ``serve.generate`` (``rows``,
``seq``) over ``serve.prefill``, each with its device time.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..obs.trace import active
from . import spmd


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens):
        """tokens [B] -> (logits [B, V], cache advanced by one position)."""
        return T.decode_step(params, cache, tokens, cfg)
    return serve_step


def sample_key_chain(generator: Optional[torch.Generator], n_new: int,
                     device="cpu") -> List[torch.Generator]:
    """Per-position sampling generators on ``device``: seeds split from
    ``generator`` (a CPU generator; seed 0 when None), one per position.

    The root itself is never used to sample, so the first sample shares no
    stream with the later ones."""
    root = generator if generator is not None else torch.Generator().manual_seed(0)
    seeds = torch.randint(0, 2 ** 62, (max(n_new, 1),), generator=root)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_new: int,
             max_seq: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             attn: str = "flash") -> torch.Tensor:
    """prompt [B, S] -> [B, S + n_new] (greedy when temperature == 0), on
    the prompt's device. ``attn`` routes the prefill's attention
    (``transformer.forward``); decode reads the KV cache in plain torch.

    ``DTensor`` parameters (tensor parallelism): the caches are placed,
    ``prompt`` is this rank's rows, and every rank of the model axis
    picks the same tokens: greedy by ``spmd.vocab_argmax`` over its vocab
    block, sampling from the ``[B, V]`` logits gathered."""
    b, s = prompt.shape
    with active().span("serve.generate", rows=b, seq=s):
        return _generate(params, cfg, prompt, n_new, max_seq or (s + n_new),
                         temperature, generator, attn)


def _generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_new: int,
              max_seq: int, temperature: float,
              generator: Optional[torch.Generator], attn: str
              ) -> torch.Tensor:
    step = make_serve_step(cfg)
    gens = (sample_key_chain(generator, n_new, prompt.device)
            if temperature > 0.0 else None)

    def pick(logits, i):
        tp = spmd.tensor_parallel(logits)
        if tp is not None:
            local = logits.to_local()
            if local.shape[-1] == logits.shape[-1]:
                logits = local
            elif temperature <= 0.0:
                return spmd.vocab_argmax(local, tp).to(prompt.dtype)
            else:
                logits = tp.all_gather(local, -1)
        if temperature <= 0.0:
            return logits.argmax(-1).to(prompt.dtype)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gens[i])[:, 0].to(prompt.dtype)

    with active().span("serve.prefill"):
        last_logits, cache = T.prefill(params, cfg, prompt, max_seq,
                                       attn=attn)
        toks = [pick(last_logits, 0)]
    for i in range(1, n_new):
        logits, cache = step(params, cache, toks[-1])
        toks.append(pick(logits, i))
    return torch.cat([prompt, torch.stack(toks, 1)], dim=1)
