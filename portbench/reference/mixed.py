"""The reference of the ``mixed`` family (Nemotron-H): single-mixer layers
``h + mixer(rmsnorm(h))`` whose kinds follow the configuration's
``layer_pattern``, ``M`` Mamba2, ``E`` a mixture of experts, ``*``
attention, as the configuration's ``port`` group, ``departures`` and
``assumed`` describe them. Written from Nemotron-H's published equations,
independently of the program's.

Mamba2 with G groups of B and C (arXiv:2405.21060): the input projection
gives z [d_inner], x·B·C [d_inner + 2·G·N] and dt [H]; a depthwise causal
conv of width W and SiLU over x·B·C; head h reads B and C of group
h // (H / G); dt = softplus(dt + dt_bias), A = -exp(a_log); the scan
h_t = exp(A·dt_t) h_{t-1} + dt_t x_t B_tᵀ, y_t = h_t C_t + D x_t by chunks
(``hybrid.ssd`` on B and C repeated to each head); then the gated norm
rmsnorm(y · silu(z)) over each group's d_inner / G channels, and the
output projection.

MoE: scores σ(x·W_router) in f32; each token's top k of scores + bias
(the bias chooses and does not weigh); gates = the chosen scores over
their sum, times ``moe_route_scale``. Each expert takes at most
``capacity`` choices in (token, choice) order and a choice past it adds
nothing; an expert is up, relu², down. One shared expert of width
``moe_shared_ff`` (up, relu², down) sees every token.

Attention: causal GQA without position embedding, computed a block of
queries at a time so that no [H, S, S] score tensor exists.

Layout: each kind's matrices are one leaf stacked over that kind's layers
(``mamba.in_proj`` [n_M, D, 2·d_inner + 2·G·N + H], ``moe.w_up`` [n_E, E,
D, F], ``attn.wq`` [n_A, D, H·dh], ...); the norm, ``a_log`` and
``dt_bias`` are per layer (``l<i>.``), the last two on every layer and
read on the Mamba2 layers only."""
from __future__ import annotations

import math
from typing import Callable, List

import torch
import torch.nn.functional as F

from ..core.weights import Leaf
from . import common as C
from .hybrid import ssd
from .moe import capacity

BIAS_SCALE = 0.02       # the router bias's draw: changes some top-k choices
Q_BLOCK = 1024          # queries a block of the reference's attention


def counts(p: dict) -> dict:
    return {k: p["layer_pattern"].count(k) for k in "ME*"}


def mamba_sizes(p: dict):
    """(d_inner, G·N, heads)."""
    heads = p["ssm_n_heads"]
    return heads * p["ssm_head_dim"], p["ssm_groups"] * p["ssm_state"], heads


def layout(p: dict) -> List[Leaf]:
    d, h, kvh, v = p["d_model"], p["n_heads"], p["n_kv_heads"], p["vocab"]
    dh, e, f, fs = p["d_head"], p["moe_experts"], p["d_ff"], p["moe_shared_ff"]
    di, gn, heads = mamba_sizes(p)
    n = counts(p)
    out = [Leaf("embed", (v, d), "normal", 0.02)]
    for i in range(p["n_layers"]):
        out += [Leaf(f"l{i}.norm", (d,), "ones"),
                Leaf(f"l{i}.a_log", (heads,), "a_log"),
                Leaf(f"l{i}.dt_bias", (heads,), "dt_bias")]
    if n["M"]:
        m = n["M"]
        out += [Leaf("mamba.in_proj", (m, d, 2 * di + 2 * gn + heads),
                     "normal", d ** -0.5),
                Leaf("mamba.conv_w", (m, p["ssm_conv"], di + 2 * gn),
                     "normal", 0.2),
                Leaf("mamba.conv_b", (m, di + 2 * gn), "zeros"),
                Leaf("mamba.d_skip", (m, heads), "ones"),
                Leaf("mamba.norm_g", (m, di), "ones"),
                Leaf("mamba.out_proj", (m, di, d), "normal", di ** -0.5)]
    if n["E"]:
        m = n["E"]
        out += [Leaf("moe.router", (m, d, e), "normal", d ** -0.5),
                Leaf("moe.bias", (m, e), "normal", BIAS_SCALE),
                Leaf("moe.w_up", (m, e, d, f), "normal", d ** -0.5),
                Leaf("moe.w_down", (m, e, f, d), "normal", f ** -0.5),
                Leaf("moe.shared_up", (m, d, fs), "normal", d ** -0.5),
                Leaf("moe.shared_down", (m, fs, d), "normal", fs ** -0.5)]
    if n["*"]:
        m = n["*"]
        out += [Leaf("attn.wq", (m, d, h * dh), "normal", d ** -0.5),
                Leaf("attn.wk", (m, d, kvh * dh), "normal", d ** -0.5),
                Leaf("attn.wv", (m, d, kvh * dh), "normal", d ** -0.5),
                Leaf("attn.wo", (m, h * dh, d), "normal", (h * dh) ** -0.5)]
    out += [Leaf("final_norm", (d,), "ones"),
            Leaf("head", (d, v), "normal", d ** -0.5)]
    return out


def mamba2(get: Callable, i: int, j: int, x: torch.Tensor, p: dict,
           prec: C.Prec):
    b, s, _ = x.shape
    di, gn, heads = mamba_sizes(p)
    g, n, pd = p["ssm_groups"], p["ssm_state"], p["ssm_head_dim"]
    zxbcdt = prec.mm(x, get("mamba.in_proj")[j])
    z, xbc, dt = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn],
                  zxbcdt[..., 2 * di + 2 * gn:])
    w = get("mamba.conv_w")[j]
    width = w.shape[0]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(padded[:, k:k + s] * w[k] for k in range(width))
    xbc = F.silu(conv + get("mamba.conv_b")[j])
    xs = xbc[..., :di].reshape(b, s, heads, pd)
    # each head its group's B and C: [B, S, H, N]
    bm = xbc[..., di:di + gn].reshape(b, s, g, n)
    cm = xbc[..., di + gn:].reshape(b, s, g, n)
    bm, cm = (t.repeat_interleave(heads // g, dim=2) for t in (bm, cm))
    dt = F.softplus(dt + get(f"l{i}.dt_bias"))                 # [B, S, H]
    a = -torch.exp(get(f"l{i}.a_log")) * dt
    q = p["ssm_chunk"]
    pad = -s % q
    xdt = F.pad(xs * dt[..., None], (0, 0, 0, 0, 0, pad))
    a = F.pad(a, (0, 0, 0, pad))
    bm, cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (bm, cm))
    y = heads_ssd(xdt, a, bm, cm, q)[:, :s] \
        + get("mamba.d_skip")[j][:, None] * xs
    gated = (y.reshape(b, s, di) * F.silu(z)).reshape(b, s, g, di // g)
    normed = C.rmsnorm(get("mamba.norm_g")[j].reshape(g, di // g), gated,
                       p.get("norm_eps", 1e-5))
    return prec.mm(normed.reshape(b, s, di), get("mamba.out_proj")[j])


def heads_ssd(x, a, bm, cm, q: int):
    """``hybrid.ssd`` with B and C of their own for each head: x [B, S, H,
    P], a [B, S, H], bm and cm [B, S, H, N], one head at a time."""
    return torch.stack([ssd(x[:, :, k:k + 1], a[:, :, k:k + 1], bm[:, :, k],
                            cm[:, :, k], q)[:, :, 0]
                        for k in range(x.shape[2])], dim=2)


def moe(get: Callable, j: int, x: torch.Tensor, p: dict, prec: C.Prec):
    """x [N, D] -> [N, D]: the routed experts and the shared one."""
    n, _ = x.shape
    e, k = p["moe_experts"], p["moe_top_k"]
    scores = torch.sigmoid(prec.mm(x, get("moe.router")[j]))
    eids = (scores + get("moe.bias")[j]).topk(k, dim=-1).indices
    top = scores.gather(-1, eids)
    gate = (top / top.sum(-1, keepdim=True) * p["moe_route_scale"]).reshape(-1)
    flat = eids.reshape(-1)                                  # (token, choice)
    onehot = F.one_hot(flat, e)
    rank = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    del onehot
    cap = capacity(n, p)
    kept = torch.nonzero(rank < cap)[:, 0]
    tok = torch.arange(n, device=x.device).repeat_interleave(k)[kept]
    row = flat[kept] * cap + rank[kept]
    buf = x.new_zeros((e * cap, x.shape[1])).index_copy(0, row, x[tok])
    hid = F.relu(prec.mm(buf.view(e, cap, -1), get("moe.w_up")[j])).square()
    y = prec.mm(hid, get("moe.w_down")[j]).reshape(e * cap, -1)
    out = torch.zeros_like(x).index_add(0, tok, y[row] * gate[kept, None])
    shared = F.relu(prec.mm(x, get("moe.shared_up")[j])).square()
    return out + prec.mm(shared, get("moe.shared_down")[j])


def attention(get: Callable, j: int, x: torch.Tensor, p: dict,
              prec: C.Prec):
    """Causal GQA, no position embedding, ``Q_BLOCK`` queries at a time
    against the keys up to the block's last."""
    b, s, _ = x.shape
    h, kvh, dh = p["n_heads"], p["n_kv_heads"], p["d_head"]
    q = prec.mm(x, get("attn.wq")[j]).view(b, s, h, dh)
    kk = prec.mm(x, get("attn.wk")[j]).view(b, s, kvh, dh)
    vv = prec.mm(x, get("attn.wv")[j]).view(b, s, kvh, dh)
    rows = []
    for r in range(b):
        kr = kk[r].transpose(0, 1).repeat_interleave(h // kvh, 0)  # [H, S, dh]
        vr = vv[r].transpose(0, 1).repeat_interleave(h // kvh, 0)
        outs = []
        for q0 in range(0, s, Q_BLOCK):
            q1 = min(s, q0 + Q_BLOCK)
            qr = q[r, q0:q1].transpose(0, 1)                      # [H, Qb, dh]
            sc = prec.mm(qr, kr[:, :q1].transpose(1, 2)) / math.sqrt(dh)
            i = torch.arange(q0, q1, device=x.device)[:, None]
            ok = torch.arange(q1, device=x.device)[None, :] <= i
            pr = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
            outs.append(prec.mm(pr, vr[:, :q1]).transpose(0, 1))
        rows.append(torch.cat(outs).reshape(s, h * dh))
    return prec.mm(torch.stack(rows), get("attn.wo")[j])


def block(get: Callable, i: int, h: torch.Tensor, p: dict, prec: C.Prec):
    kind = p["layer_pattern"][i]
    j = p["layer_pattern"][:i].count(kind)
    x = C.rmsnorm(get(f"l{i}.norm"), h, p.get("norm_eps", 1e-5))
    if kind == "M":
        return h + mamba2(get, i, j, x, p, prec), None
    if kind == "E":
        b, s, d = x.shape
        return h + moe(get, j, x.reshape(-1, d), p, prec).view(b, s, d), None
    return h + attention(get, j, x, p, prec), None
