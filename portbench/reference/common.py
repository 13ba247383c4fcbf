"""Plain building blocks of the reference, in float32.

``Prec`` is how the reference multiplies: in f32, or for the control in
fp8 (e4m3, one scale a tensor: each operand of every matmul rounded to
fp8 and multiplied in f32; the gradient passes the rounding straight
through), the nearest precision below the configurations' bf16."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def strict_f32() -> None:
    """No TF32 in any f32 product of the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Prec:
    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        with torch.no_grad():
            scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
            xq = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (xq - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half form, positions 0..S-1. x [B, S, H, dh]."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(get: Callable, pre: str, x: torch.Tensor, p: dict,
              prec: Prec) -> torch.Tensor:
    """Causal multi-head attention (GQA; sliding window where the
    configuration has one), one row of the batch at a time."""
    b, s, _ = x.shape
    h, kvh = p["n_heads"], p["n_kv_heads"]
    dh = p.get("d_head") or p["d_model"] // h
    q = rope(prec.mm(x, get(pre + "wq")).view(b, s, h, dh), p["rope_theta"])
    k = rope(prec.mm(x, get(pre + "wk")).view(b, s, kvh, dh), p["rope_theta"])
    v = prec.mm(x, get(pre + "wv")).view(b, s, kvh, dh)
    i = torch.arange(s, device=x.device)
    ok = i[None, :] <= i[:, None]
    if p.get("swa_window"):
        ok &= (i[:, None] - i[None, :]) < p["swa_window"]
    rows = []
    for r in range(b):
        qr = q[r].transpose(0, 1)                                 # [H, S, dh]
        kr = k[r].transpose(0, 1).repeat_interleave(h // kvh, 0)
        vr = v[r].transpose(0, 1).repeat_interleave(h // kvh, 0)
        sc = prec.mm(qr, kr.transpose(1, 2)) / math.sqrt(dh)
        pr = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
        rows.append(prec.mm(pr, vr).transpose(0, 1).reshape(s, h * dh))
    return prec.mm(torch.stack(rows), get(pre + "wo"))


def swiglu(get: Callable, pre: str, x: torch.Tensor, prec: Prec):
    return prec.mm(F.silu(prec.mm(x, get(pre + "w_gate")))
                   * prec.mm(x, get(pre + "w_up")), get(pre + "w_down"))


def chunked_ce(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               chunk: int, prec: Prec) -> torch.Tensor:
    """Mean next-token cross entropy, the logits made a slab of
    ``chunk`` positions at a time (recomputed in the backward)."""
    def part(hc, lc):
        logits = prec.mm(hc, head)
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lc[..., None])[..., 0]).sum()
    b, s, _ = h.shape
    total = h.new_zeros(())
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        total = total + (checkpoint(part, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else part(*args))
    return total / (b * s)


def maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def lm_forward(get: Callable, p: dict, tokens: torch.Tensor, block,
               prec: Prec, want: str = "hidden"):
    """Embedding, the blocks (``block(get, i, h, p, prec) -> (h, aux)``,
    each checkpointed under autograd) and the final norm. Returns (final
    normed hidden states [B, S, D], or with ``want="last"`` the last
    position's logits [B, V]; the mean of the blocks' aux terms; ia [L];
    pooled [L, D])."""
    h = get("embed")[tokens]
    ia, pooled, aux = [], [], []
    for i in range(p["n_layers"]):
        h_in = h
        h, a = maybe_checkpoint(lambda x, i=i: block(get, i, x, p, prec), h)
        # the gate's statistics: mean |block input|, the mean block output
        ia.append(h_in.detach().abs().mean())
        pooled.append(h.detach().mean(dim=(0, 1)))
        if a is not None:
            aux.append(a)
    aux_mean = torch.stack(aux).mean() if aux else h.new_zeros(())
    eps = p.get("norm_eps", 1e-5)
    if want == "last":
        hl = rmsnorm(get("final_norm"), h[:, -1], eps)
        return prec.mm(hl, get("head")), aux_mean, torch.stack(ia), \
            torch.stack(pooled)
    return rmsnorm(get("final_norm"), h, eps), aux_mean, torch.stack(ia), \
        torch.stack(pooled)
