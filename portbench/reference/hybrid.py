"""The reference of the ``hybrid`` family (Zamba2): a trunk of Mamba2
blocks and one shared attention + SwiGLU block, whose one set of weights
runs after every ``hybrid_attn_every``-th block, as the configuration's
``port`` group and ``departures`` describe them.

Mamba2 (arXiv:2405.21060) with one group of B and C: the input
projection gives z, x·B·C and dt; a depthwise causal conv of width W and
SiLU over x·B·C; dt = softplus(dt + dt_bias), A = -exp(a_log); the SSD
scan h_t = exp(A·dt_t) h_{t-1} + dt_t x_t B_tᵀ, y_t = h_t C_t + D x_t,
computed by chunks (the diagonal blocks as masked products, the states
carried between chunks); then rmsnorm(y · silu(z)) and the output
projection. Written here from the paper's chunked form, independently of
the program's."""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F

from ..core.weights import Leaf
from . import common as C


def layout(p: dict) -> List[Leaf]:
    d, h, kvh, f, v = (p["d_model"], p["n_heads"], p["n_kv_heads"],
                       p["d_ff"], p["vocab"])
    dh = p.get("d_head") or d // h
    di, n = p["ssm_expand"] * d, p["ssm_state"]
    heads = di // p["ssm_head_dim"]
    out = [Leaf("embed", (v, d), "normal", 0.02)]
    for i in range(p["n_layers"]):
        pre = f"l{i}."
        out += [Leaf(pre + "norm1", (d,), "ones"),
                Leaf(pre + "in_proj", (d, 2 * di + 2 * n + heads), "normal",
                     d ** -0.5),
                Leaf(pre + "conv_w", (p["ssm_conv"], di + 2 * n), "normal",
                     0.2),
                Leaf(pre + "conv_b", (di + 2 * n,), "zeros"),
                Leaf(pre + "a_log", (heads,), "a_log"),
                Leaf(pre + "d_skip", (heads,), "ones"),
                Leaf(pre + "dt_bias", (heads,), "dt_bias"),
                Leaf(pre + "norm_g", (di,), "ones"),
                Leaf(pre + "out_proj", (di, d), "normal", di ** -0.5)]
    if p.get("hybrid_attn_every"):
        out += [Leaf("s.norm1", (d,), "ones"),
                Leaf("s.wq", (d, h * dh), "normal", d ** -0.5),
                Leaf("s.wk", (d, kvh * dh), "normal", d ** -0.5),
                Leaf("s.wv", (d, kvh * dh), "normal", d ** -0.5),
                Leaf("s.wo", (h * dh, d), "normal", (h * dh) ** -0.5),
                Leaf("s.norm2", (d,), "ones"),
                Leaf("s.w_gate", (d, f), "normal", d ** -0.5),
                Leaf("s.w_up", (d, f), "normal", d ** -0.5),
                Leaf("s.w_down", (f, d), "normal", f ** -0.5)]
    out += [Leaf("final_norm", (d,), "ones"),
            Leaf("head", (d, v), "normal", d ** -0.5)]
    return out


def segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T]: sum of x over (j, i] where j <= i, -inf
    above the diagonal."""
    t = x.shape[-1]
    cs = x.cumsum(-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd(x, a, bm, cm, q: int):
    """x [B, S, H, P], a [B, S, H] (log decay), bm, cm [B, S, N]; S a
    multiple of ``q`` -> y [B, S, H, P] (no skip term)."""
    b, s, h, pd = x.shape
    c, n = s // q, bm.shape[-1]
    x = x.view(b, c, q, h, pd)
    a = a.view(b, c, q, h).permute(0, 3, 1, 2)                 # [B, H, C, Q]
    bm, cm = bm.view(b, c, q, n), cm.view(b, c, q, n)
    acs = a.cumsum(-1)
    decay = torch.exp(segsum(a))                               # [B, H, C, Q, Q]
    cb = cm @ bm.transpose(-1, -2)                             # [B, C, Q, Q]
    w = decay * cb[:, None]
    y = torch.einsum("bhcls,bcshp->bclhp", w, x)
    to_end = torch.exp(acs[..., -1:] - acs).permute(0, 2, 3, 1)  # [B, C, Q, H]
    states = torch.einsum("bcln,bclhp->bchpn", bm, x * to_end[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    chunk = torch.exp(segsum(F.pad(acs[..., -1], (1, 0))))     # [B, H, C+1, C+1]
    entering = torch.einsum("bhzc,bchpn->bzhpn", chunk, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn->bclhp", cm, entering) \
        * torch.exp(acs).permute(0, 2, 3, 1)[..., None]
    return (y + y_off).reshape(b, s, h, pd)


def mamba2(get: Callable, pre: str, x: torch.Tensor, p: dict, prec: C.Prec):
    b, s, _ = x.shape
    di, n = p["ssm_expand"] * p["d_model"], p["ssm_state"]
    pd = p["ssm_head_dim"]
    heads = di // pd
    zxbcdt = prec.mm(x, get(pre + "in_proj"))
    z, xbc, dt = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
                  zxbcdt[..., 2 * di + 2 * n:])
    w = get(pre + "conv_w")
    width = w.shape[0]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(padded[:, i:i + s] * w[i] for i in range(width))
    xbc = F.silu(conv + get(pre + "conv_b"))
    xs = xbc[..., :di].reshape(b, s, heads, pd)
    bm, cm = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt + get(pre + "dt_bias"))                 # [B, S, H]
    a = -torch.exp(get(pre + "a_log")) * dt
    q = p["ssm_chunk"]
    pad = -s % q
    xdt = F.pad(xs * dt[..., None], (0, 0, 0, 0, 0, pad))
    a, bm, cm = (F.pad(t, (0, 0, 0, pad)) for t in (a, bm, cm))
    y = ssd(xdt, a, bm, cm, q)[:, :s] + get(pre + "d_skip")[:, None] * xs
    y = C.rmsnorm(get(pre + "norm_g"), y.reshape(b, s, di) * F.silu(z),
                  p.get("norm_eps", 1e-5))
    return prec.mm(y, get(pre + "out_proj"))


def block(get: Callable, i: int, h: torch.Tensor, p: dict, prec: C.Prec):
    pre, eps = f"l{i}.", p.get("norm_eps", 1e-5)
    h = h + mamba2(get, pre, C.rmsnorm(get(pre + "norm1"), h, eps), p, prec)
    every = p.get("hybrid_attn_every")
    if every and (i + 1) % every == 0:
        h = h + C.attention(get, "s.", C.rmsnorm(get("s.norm1"), h, eps), p,
                            prec)
        h = h + C.swiglu(get, "s.", C.rmsnorm(get("s.norm2"), h, eps), prec)
    return h, None
