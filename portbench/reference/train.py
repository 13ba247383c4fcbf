"""The reference's training steps: the family's loss, its gradients by
autograd in f32, and the gated AdamW update, as the cell's settings state
them. Parameters are stored in the configuration's type (bf16, each
update rounded to it) and computed on in f32; the moments are f32.

The gate (ElfCore's activity-dependent update, per layer): input
activity ia = mean |block input|, similarity ss = cosine of the block's
mean output with its running mean; the layer's update runs where
ia > theta_ia and ss < ss_scale · (running mean of |ss|)."""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from ..core.weights import layer_of
from . import common as C


def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up, then a cosine down to ``min_lr_frac`` of the peak."""
    warm = min(1.0, (step + 1) / max(1, opt["warmup_steps"]))
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(1, opt["total_steps"] - opt["warmup_steps"])))
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_frac"]
                               + (1 - opt["min_lr_frac"]) * cos)


def loss_fn(model, p: Dict, get: Callable, batch: Dict, settings: Dict,
            prec: C.Prec):
    """(loss, ia [L], pooled [L, D]): mean cross entropy plus the MoE
    load-balance term's weight times its mean over the layers."""
    h, aux, ia, pooled = C.lm_forward(get, p, batch["tokens"], model.block,
                                      prec)
    chunk = settings.get("loss_chunk") or h.shape[1]
    ce = C.chunked_ce(h, get("head"), batch["labels"], chunk, prec)
    return ce + settings.get("moe_aux_weight", 0.01) * aux, ia, pooled


class Gate:
    def __init__(self, cfg: Dict, n_layers: int, d: int, device):
        self.cfg = cfg
        self.ss_mean = torch.full((n_layers,), cfg["ss_init"], device=device)
        self.ema = torch.zeros((n_layers, d), device=device)

    def __call__(self, ia: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        def unit(x):
            return x / (x.norm(dim=-1, keepdim=True) + 1e-6)
        c = self.cfg
        ss = (unit(pooled) * unit(self.ema)).sum(-1)
        opened = (ia > c["theta_ia"]) & (ss < c["ss_scale"] * self.ss_mean)
        self.ss_mean = (1 - c["ss_rho"]) * self.ss_mean + c["ss_rho"] * ss.abs()
        self.ema = 0.95 * self.ema + 0.05 * pooled
        return opened.float()


def train(model, p: Dict, get0: Callable, batches: List[Dict],
          settings: Dict, prec: C.Prec, store=None) -> Dict:
    """Run ``len(batches)`` steps from the weights ``get0`` gives.
    Returns each step's loss, the norm of each leaf's gradient at the first
    step, and the norm of each leaf's change over the steps."""
    opt, gating = settings["opt"], settings.get("gating")
    store = store or getattr(torch, p.get("dtype", "bfloat16"))
    names = [leaf.name for leaf in model.layout(p)]
    params = {n: get0(n).float().requires_grad_() for n in names}
    m = {n: torch.zeros_like(x) for n, x in params.items()}
    v = {n: torch.zeros_like(x) for n, x in params.items()}
    dev = params[names[0]].device
    gate = Gate(gating, p["n_layers"], p["d_model"], dev) if gating else None
    losses, grad_norms = [], {}
    for t, batch in enumerate(batches):
        loss, ia, pooled = loss_fn(model, p, params.__getitem__, batch,
                                   settings, prec)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        if t == 0:
            grad_norms = {n: float(g.norm()) for n, g in zip(names, grads)}
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            clip = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            opened = gate(ia, pooled) if gate is not None else None
            lr = lr_at(opt, t)
            bc1 = 1 - opt["b1"] ** (t + 1)
            bc2 = 1 - opt["b2"] ** (t + 1)
            for n, g in zip(names, grads):
                g = g * clip
                m[n].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                v[n].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                upd = lr * (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"])
                upd = upd + lr * opt["weight_decay"] * params[n]
                layer = layer_of(n)
                if opened is not None and layer is not None:
                    upd = upd * opened[layer]
                params[n].copy_((params[n] - upd).to(store).float())
        del grads, loss
    change = {n: float((params[n].detach() - get0(n).float()).norm())
              for n in names}
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}


def last_logits(model, p: Dict, get: Callable, batches: List[torch.Tensor],
                prec: C.Prec) -> List[torch.Tensor]:
    """The last position's logits [B, V] of each batch of prompts [B, S]
    (a batch passes each layer whole: an expert's capacity is that of the
    batch's tokens), layer by layer over all the batches (a layer's
    weights are read while every batch passes it)."""
    eps = p.get("norm_eps", 1e-5)
    with torch.no_grad():
        hs = [get("embed")[t] for t in batches]
        for i in range(p["n_layers"]):
            hs = [model.block(get, i, h, p, prec)[0] for h in hs]
        return [prec.mm(C.rmsnorm(get("final_norm"), h[:, -1], eps),
                        get("head")) for h in hs]
