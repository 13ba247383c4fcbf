"""OSSL for deep nets (``repro.core.ossl``): local self-supervised losses
per transformer block, the LM-scale form of the chip's layer-local learning.

* ``local_head_init`` — a small predictor head per block.
* ``local_loss`` — per-block loss: PC (the block output at position t
  predicts its own representation ``predict_offset`` tokens ahead, cosine
  through the predictor) plus CC (pooled representations of the batch's
  sequences pushed apart: in-batch negatives).
* ``block_stats`` — the IA / SS quantities the gating engine consumes.

``models/transformer.forward(local_mode=True)`` detaches every block input,
so the total loss is a sum of independent per-block problems plus a
supervised readout on frozen features.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class OSSLConfig:
    predict_offset: int = 8     # d: how many tokens ahead PC predicts
    cc_weight: float = 0.5
    temperature: float = 0.1


def local_head_init(gen: torch.Generator, d_model: int, dtype=torch.float32,
                    lead=()) -> Dict[str, torch.Tensor]:
    """``{"p": [*lead, D, D]}`` drawn from ``gen`` on its device (a meta
    ``gen``, ``models.layers.MetaGenerator``: the shape only)."""
    shape = (*lead, d_model, d_model)
    if gen.device.type == "meta":
        return {"p": torch.empty(shape, dtype=dtype, device="meta")}
    p = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return {"p": p * (d_model ** -0.5)}


def _l2n(x: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def local_loss(h_out: torch.Tensor, head: Dict[str, torch.Tensor],
               cfg: OSSLConfig, proj=None) -> torch.Tensor:
    """Per-block OSSL loss. ``h_out``: [B, S, D] block output (the caller
    detached the block input; the PC targets are detached here). ``proj``:
    the predictor's product where it is not ``x @ head["p"]`` (a
    tensor-parallel caller's, over its column block of ``p``)."""
    d = cfg.predict_offset
    x = h_out[:, :-d]
    pred = _l2n(proj(x) if proj is not None else x @ head["p"])  # [B, S-d, D]
    tgt = _l2n(h_out[:, d:].detach())
    pc = -(pred * tgt).sum(-1).mean()

    pooled = _l2n(h_out.mean(dim=1))                            # [B, D]
    sim = pooled @ pooled.T / cfg.temperature                   # [B, B]
    b = pooled.shape[0]
    off = sim - 1e9 * torch.eye(b, dtype=sim.dtype, device=sim.device)
    # push in-batch negatives apart (previous-sample contrast generalised)
    cc = torch.logsumexp(off, dim=-1).mean() \
        - torch.tensor(math.log(max(b - 1, 1)), dtype=sim.dtype)
    return pc + cfg.cc_weight * cc


def block_stats(h_in: torch.Tensor, h_out: torch.Tensor, ema: torch.Tensor):
    """(IA, SS, pooled) for the gating engine: IA = mean |block input|, SS =
    cosine of the pooled block output against its running EMA."""
    ia = h_in.abs().mean()
    pooled = h_out.mean(dim=(0, 1))
    ss = (_l2n(pooled, dim=0) * _l2n(ema, dim=0)).sum()
    return ia, ss, pooled
