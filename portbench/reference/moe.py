"""The reference of the ``moe`` family: pre-norm blocks of causal
attention and a token-choice top-k mixture of SwiGLU experts, as the
configuration's ``port`` group and ``departures`` describe them (for
Moonlight-16B-A3B: multi-head attention in place of MLA, no shared
experts, every layer MoE, softmax routing).

Routing: softmax over the router's logits, the top k experts, their
probabilities renormalised to sum to 1. Each expert takes at most
``capacity`` choices, in (token, choice) order; a choice past it adds
nothing. The load-balance term is E · Σ_e mean_prob_e · load_e (the load
a count, with no gradient)."""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F

from ..core.weights import Leaf
from . import common as C


def layout(p: dict) -> List[Leaf]:
    d, h, kvh, f = p["d_model"], p["n_heads"], p["n_kv_heads"], p["d_ff"]
    dh, e, v = p.get("d_head") or d // h, p["moe_experts"], p["vocab"]
    out = [Leaf("embed", (v, d), "normal", 0.02)]
    for i in range(p["n_layers"]):
        pre = f"l{i}."
        out += [Leaf(pre + "norm1", (d,), "ones"),
                Leaf(pre + "wq", (d, h * dh), "normal", d ** -0.5),
                Leaf(pre + "wk", (d, kvh * dh), "normal", d ** -0.5),
                Leaf(pre + "wv", (d, kvh * dh), "normal", d ** -0.5),
                Leaf(pre + "wo", (h * dh, d), "normal", (h * dh) ** -0.5),
                Leaf(pre + "norm2", (d,), "ones"),
                Leaf(pre + "router", (d, e), "normal", d ** -0.5),
                Leaf(pre + "w_gate", (e, d, f), "normal", d ** -0.5),
                Leaf(pre + "w_up", (e, d, f), "normal", d ** -0.5),
                Leaf(pre + "w_down", (e, f, d), "normal", f ** -0.5)]
    out += [Leaf("final_norm", (d,), "ones"),
            Leaf("head", (d, v), "normal", d ** -0.5)]
    return out


def capacity(n_tokens: int, p: dict) -> int:
    c = int(n_tokens * p["moe_top_k"] * p["moe_capacity_factor"]
            / p["moe_experts"])
    return max(8, -(-c // 8) * 8)


def moe(get: Callable, pre: str, x: torch.Tensor, p: dict, prec: C.Prec):
    """x [N, D] -> (out [N, D], load-balance term)."""
    n, _ = x.shape
    e, k = p["moe_experts"], p["moe_top_k"]
    probs = torch.softmax(prec.mm(x, get(pre + "router")), dim=-1)
    top, eids = probs.topk(k, dim=-1)
    gate = (top / top.sum(-1, keepdim=True)).reshape(-1)
    flat = eids.reshape(-1)                                  # (token, choice)
    onehot = F.one_hot(flat, e)
    rank = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    cap = capacity(n, p)
    kept = torch.nonzero(rank < cap)[:, 0]
    tok = torch.arange(n, device=x.device).repeat_interleave(k)[kept]
    # each kept choice's row of an [E, capacity, D] buffer of the experts'
    # inputs; the experts run as batched products over it
    row = flat[kept] * cap + rank[kept]
    buf = x.new_zeros((e * cap, x.shape[1])).index_copy(0, row, x[tok])
    buf = buf.view(e, cap, -1)
    h = F.silu(prec.mm(buf, get(pre + "w_gate"))) \
        * prec.mm(buf, get(pre + "w_up"))
    y = prec.mm(h, get(pre + "w_down")).reshape(e * cap, -1)
    out = torch.zeros_like(x).index_add(0, tok, y[row] * gate[kept, None])
    load = onehot.sum(0).float() / flat.numel()
    return out, e * (probs.mean(0) * load).sum()


def block(get: Callable, i: int, h: torch.Tensor, p: dict, prec: C.Prec):
    pre, eps = f"l{i}.", p.get("norm_eps", 1e-5)
    h = h + C.attention(get, pre, C.rmsnorm(get(pre + "norm1"), h, eps), p,
                        prec)
    b, s, d = h.shape
    f, aux = moe(get, pre, C.rmsnorm(get(pre + "norm2"), h, eps).reshape(-1, d),
                 p, prec)
    return h + f.view(b, s, d), aux
