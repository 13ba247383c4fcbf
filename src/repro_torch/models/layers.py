"""Primitive layers (``repro.models.layers``): norms, rotary embeddings,
GQA/SWA attention, MLPs, and the (optionally block-N:M sparse) linear
projection.

Sparse linear parameter forms (``configs.SparsityConfig.mode``):

* dense    : {"w": [K, O]}
* masked   : {"w": [K, O], "umask": bool [K/block, 1]} — dense storage,
             pattern applied at use.
* compact  : {"w": [Kc, O], "rows": int64 [Kc]} — only kept rows stored
             (Kc = K·n/m); forward is gather + dense matmul.

Random draws come from an explicit ``torch.Generator`` and land on its
device; sparsity masks are drawn on the CPU from a seed taken from it, so
a seed gives the same mask on every device. A :class:`MetaGenerator` in
its place draws nothing: every leaf comes back empty on the ``meta``
device, with its shape and dtype (the dry run's params). Layouts are the
reference's: activations ``[B, S, D]``, heads ``[B, S, H, dh]``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SparsityConfig
from ..core.sparsity import NMSpec, random_unit_mask
from ..launch import spmd


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only shapes are wanted:
    the init functions then draw nothing and return ``meta`` tensors."""
    device = torch.device("meta")


def _randn(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def _cpu_gen(gen: torch.Generator) -> torch.Generator:
    """A CPU generator seeded from ``gen`` (for masks drawn on the CPU)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen, device=gen.device))
    return torch.Generator().manual_seed(seed)


def unit_masks(gen: torch.Generator, spec: NMSpec, k: int, o: int,
               n: int) -> torch.Tensor:
    """``n`` random N:M unit masks, bool ``[n, KB, J]`` on the CPU, drawn
    from a CPU generator seeded from ``gen`` (a meta ``gen``: their shape
    on ``meta``, nothing drawn)."""
    if gen.device.type == "meta":
        return torch.empty((n, *spec.unit_counts(k, o)), dtype=torch.bool,
                           device="meta")
    mgen = _cpu_gen(gen)
    return torch.stack([random_unit_mask(mgen, spec, k, o) for _ in range(n)])


# ---------------------------------------------------------------------------
# (sparse) linear
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, k: int, o: int, dtype,
                sp: Optional[SparsityConfig] = None,
                scale: Optional[float] = None, lead: Tuple[int, ...] = ()):
    """One projection, or ``lead`` stacked ones (leaves ``[*lead, ...]``)."""
    scale = (k ** -0.5) if scale is None else scale
    if sp is not None and (k % sp.block or (k // sp.block) % sp.m):
        # input dim doesn't tile into N:M groups — stay dense rather than mis-mask
        sp = None
    if sp is None:
        return {"w": _randn(gen, (*lead, k, o), dtype) * scale}
    spec = NMSpec(n=sp.n, m=sp.m, block=sp.block, out_tile=o)
    n_stack = 1
    for d in lead:
        n_stack *= d
    umask = unit_masks(gen, spec, k, o, n_stack).reshape(*lead, k // sp.block, 1)
    umask = umask.to(gen.device)
    scale = scale / (sp.density ** 0.5)                           # variance-preserving
    if sp.mode == "masked":
        return {"w": _randn(gen, (*lead, k, o), dtype) * scale, "umask": umask}
    kc = k * sp.n // sp.m
    rows = torch.stack([_rows_from_umask(u[:, 0], sp.block, n=sp.n, m=sp.m)
                        for u in umask.reshape(-1, k // sp.block, 1)])
    return {"w": _randn(gen, (*lead, kc, o), dtype) * scale,
            "rows": rows.reshape(*lead, kc)}


def _rows_from_umask(block_mask: torch.Tensor, block: int, *, n: int,
                     m: int) -> torch.Tensor:
    """bool [KB] -> int64 [KB·n/m·block] kept dense-row indices (sorted).
    Torch sorts no bool, so the mask is cast before the stable argsort."""
    kb = block_mask.shape[0]
    t = kb * n // m
    order = torch.argsort((~block_mask).to(torch.int8), stable=True)
    blocks = torch.sort(order[:t]).values                          # kept block ids
    rows = blocks[:, None] * block + torch.arange(block, device=blocks.device)
    return rows.reshape(-1)


def linear_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 sp: Optional[SparsityConfig] = None) -> torch.Tensor:
    """x [..., K] @ W -> [..., O] for any storage form.

    Under tensor parallelism (``launch.spmd.TensorParallel``) ``p`` holds
    this rank's block; a row-parallel block of a compact or masked weight
    reads its own rows of the replicated ``rows`` / ``umask`` (a compact
    one gathers the input's column blocks first: its kept rows index the
    whole input)."""
    if "rows" in p:
        rows, w = p["rows"], p["w"]
        if rows.shape[-1] != w.shape[-2]:            # a row-parallel block
            tp = spmd.active_tp()
            x = tp.enter_cols(x)
            rows = rows.narrow(-1, tp.rank * w.shape[-2], w.shape[-2])
        return x.index_select(-1, rows) @ w
    if "umask" in p:
        # straight-through: forward sees w·mask, the gradient stays dense
        w, tp = p["w"], spmd.active_tp()
        rows = sp.block if tp is not None and sp is not None \
            else w.shape[-2] // p["umask"].shape[-2]
        maskf = p["umask"].repeat_interleave(rows, dim=-2).to(w.dtype)
        if maskf.shape[-2] != w.shape[-2]:           # a row-parallel block
            maskf = maskf.narrow(-2, tp.rank * w.shape[-2], w.shape[-2])
        return x @ (w - (w * (1.0 - maskf)).detach())
    return x @ p["w"]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    return torch.ones((*lead, d), dtype=dtype, device=device)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * g


# ---------------------------------------------------------------------------
# rotary position embeddings (RoPE and Qwen2-VL's M-RoPE)
# ---------------------------------------------------------------------------

def _inv_freq(d_half: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                   device=device) / d_half)


def rope_angles(pos: torch.Tensor, d_head: int, theta: float) -> torch.Tensor:
    """pos [B, S] -> angles [B, S, d_head//2]."""
    return pos[..., None].float() * _inv_freq(d_head // 2, theta, pos.device)


def mrope_angles(pos3: torch.Tensor, d_head: int, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multi-axis RoPE: pos3 [3, B, S] (temporal, height, width); frequency
    slot i takes its position from the section it falls in."""
    d_half = d_head // 2
    assert sum(sections) == d_half, (sections, d_half)
    # output_size: the length is known, so no read of the repeats (and a
    # meta tensor, the dry run's, needs none)
    sec_id = torch.repeat_interleave(torch.arange(3, device=pos3.device),
                                     torch.tensor(sections, device=pos3.device),
                                     output_size=d_half)
    pos_per_freq = pos3[sec_id].movedim(0, -1)                  # [B, S, d_half]
    return pos_per_freq.float() * _inv_freq(d_half, theta, pos3.device)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, dh], angles [B, S, dh//2] — rotate-half convention."""
    d_half = x.shape[-1] // 2
    x1, x2 = x[..., :d_half], x[..., d_half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# attention (GQA, optional sliding window, full + cached decode paths)
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype,
              sp: Optional[SparsityConfig] = None, lead: Tuple[int, ...] = ()):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp_attn = sp if (sp and "attn" in sp.targets) else None
    return {
        "wq": linear_init(gen, d, h * dh, dtype, sp_attn, lead=lead),
        "wk": linear_init(gen, d, kv * dh, dtype, sp_attn, lead=lead),
        "wv": linear_init(gen, d, kv * dh, dtype, sp_attn, lead=lead),
        "wo": linear_init(gen, h * dh, d, dtype, sp_attn, lead=lead),
    }


def _gqa_scores(q, k):
    """q [B,S,H,dh], k [B,T,KV,dh] -> [B, KV, H/KV, S, T]."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / (dh ** 0.5)


def _gqa_out(probs, v):
    """probs [B,KV,G,S,T], v [B,T,KV,dh] -> [B,S,H,dh]."""
    b, kvh, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, kvh * g, -1)


def causal_mask(s: int, window: Optional[int] = None, dtype=torch.float32,
                device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    ok = j <= i
    if window is not None:
        ok &= (i - j) < window
    return torch.where(ok, 0.0, float("-inf")).to(dtype)


def _kv_heads(y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A K or V projection ``[B, S, ·]`` as heads ``[B, S, KV', dh]``: all
    KV heads, or under tensor parallelism this rank's block of whole heads.
    Where the model axis divides ``KV · dh`` but not ``KV``, the column
    split lands inside a head: the blocks are gathered whole
    (``TensorParallel.enter_cols``)."""
    b, s, width = y.shape
    tp = spmd.active_tp()
    if tp is not None and width < cfg.n_kv_heads * cfg.head_dim and \
            cfg.n_kv_heads % tp.size:
        y = tp.enter_cols(y)
    return y.reshape(b, s, -1, cfg.head_dim)


def head_cut(cfg: ModelConfig):
    """The active ``TensorParallel`` where its model axis cuts inside a
    query head (the rules split ``wq``'s ``H · dh`` columns, and the axis
    does not divide ``H``), else None."""
    tp = spmd.active_tp()
    return tp if tp is not None and tp.size > 1 and cfg.n_heads % tp.size \
        else None


def q_span(cfg: ModelConfig, tp) -> Tuple[int, int, int, int]:
    """``(h0, h1, first, width)`` under a head cut: this rank's block of
    ``wq``'s columns (and of ``wo``'s rows) is ``width`` columns from
    column ``first`` of heads ``[h0, h1)``, the whole heads that it
    touches."""
    dh = cfg.head_dim
    width = cfg.n_heads * dh // tp.size
    c0 = tp.rank * width
    h0, h1 = c0 // dh, -(-(c0 + width) // dh)
    return h0, h1, c0 - h0 * dh, width


def _kv(p, x, angles, cfg: ModelConfig, sp):
    """The K/V heads (``_kv_heads``), K rotated."""
    k = _kv_heads(linear_apply(p["wk"], x, sp), cfg)
    v = _kv_heads(linear_apply(p["wv"], x, sp), cfg)
    return (k if angles is None else apply_rotary(k, angles)), v


def _qkv(p, x, angles, cfg: ModelConfig, sp):
    """q ``[B, S, H', dh]`` (H' = H, this rank's block of heads, or under a
    head cut the heads ``[h0, h1)`` of :func:`q_span`: the column blocks
    gathered whole, the partial cotangents summed) and the K/V heads
    (``_kv_heads``), rotated."""
    b, s, _ = x.shape
    q = linear_apply(p["wq"], x, sp)
    cut = head_cut(cfg)
    if cut is not None:
        h0, h1, _, _ = q_span(cfg, cut)
        q = cut.enter_cols(q)[..., h0 * cfg.head_dim:h1 * cfg.head_dim]
    q = q.reshape(b, s, -1, cfg.head_dim)
    k, v = _kv(p, x, angles, cfg, sp)
    if angles is not None:
        q = apply_rotary(q, angles)
    return q, k, v


def _group_kv(q, k, v, cfg: ModelConfig):
    """The K/V heads that ``q``'s heads read: all of them, or under tensor
    parallelism, where K/V were gathered whole, the block of this rank's
    query heads (GQA groups stay whole: ``TensorParallel.local_kv_heads``);
    under a head cut, the KV heads of heads ``[h0, h1)``: one group's
    head, whole groups, or one KV head a query head where the span cuts a
    group."""
    if q.shape[2] == cfg.n_heads or k.shape[2] != cfg.n_kv_heads:
        return k, v
    cut = head_cut(cfg)
    if cut is None:
        first, n = spmd.active_tp().local_kv_heads(cfg.n_heads,
                                                   cfg.n_kv_heads)
        return k[:, :, first:first + n], v[:, :, first:first + n]
    h0, h1, _, _ = q_span(cfg, cut)
    g = cfg.n_heads // cfg.n_kv_heads
    if h0 // g == (h1 - 1) // g:
        return k[:, :, h0 // g:h0 // g + 1], v[:, :, h0 // g:h0 // g + 1]
    if h0 % g == 0 and h1 % g == 0:
        return k[:, :, h0 // g:h1 // g], v[:, :, h0 // g:h1 // g]
    idx = torch.arange(h0, h1, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _own_cols(out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Attention's output ``[B, S, H' · dh]`` -> the columns of this rank's
    rows of ``wo`` (all of it but under a head cut)."""
    cut = head_cut(cfg)
    if cut is None:
        return out
    _, _, first, width = q_span(cfg, cut)
    return out[..., first:first + width]


def attn_full(p, x, angles, cfg: ModelConfig, sp=None):
    """Training / prefill attention over the whole sequence."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, angles, cfg, sp)
    ka, va = _group_kv(q, k, v, cfg)
    scores = _gqa_scores(q, ka)
    scores = scores + causal_mask(s, cfg.swa_window, scores.dtype, x.device)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = _gqa_out(probs, va).reshape(b, s, -1)
    return linear_apply(p["wo"], _own_cols(out, cfg), sp), (k, v)


def attn_full_chunked(p, x, angles, cfg: ModelConfig, sp=None,
                      q_chunk: int = 512):
    """Query-chunked causal attention — O(q_chunk · S) live memory: a loop
    over query chunks keeps a ``[qc, S]`` score slab live, not ``[S, S]``."""
    b, s, _ = x.shape
    qc = min(q_chunk, s)
    assert s % qc == 0, (s, qc)
    q, k, v = _qkv(p, x, angles, cfg, sp)
    ka, va = _group_kv(q, k, v, cfg)
    j_abs = torch.arange(s, device=x.device)
    outs = []
    for c0 in range(0, s, qc):
        i_abs = c0 + torch.arange(qc, device=x.device)
        ok = j_abs[None, :] <= i_abs[:, None]
        if cfg.swa_window is not None:
            ok &= (i_abs[:, None] - j_abs[None, :]) < cfg.swa_window
        scores = _gqa_scores(q[:, c0:c0 + qc], ka)              # [B,KV,G,qc,S]
        scores = torch.where(ok, scores, float("-inf"))
        probs = torch.softmax(scores.float(), -1).to(x.dtype)
        outs.append(_gqa_out(probs, va))                        # [B,qc,H,dh]
    out = torch.cat(outs, dim=1).reshape(b, s, -1)
    return linear_apply(p["wo"], _own_cols(out, cfg), sp), (k, v)


def attn_full_flash(p, x, angles, cfg: ModelConfig, sp=None):
    """Training/prefill attention through the flash op
    (``kernels/flash_attn``): the CUDA kernel on the card, the plain
    version on the CPU; under tensor parallelism on this rank's heads."""
    from ..kernels.flash_attn.ops import flash_attention
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, angles, cfg, sp)
    ka, va = _group_kv(q, k, v, cfg)
    out = flash_attention(q, ka, va, cfg.swa_window).reshape(b, s, -1)
    return linear_apply(p["wo"], _own_cols(out, cfg), sp), (k, v)


def attn_decode(p, x, angles, cache_k, cache_v, pos: int, cfg: ModelConfig,
                sp=None):
    """One-token decode against a (possibly ring-buffered SWA) KV cache.

    ``cache_k/v``: [B, C, KV, dh] with C = min(max_seq, swa_window or inf),
    written IN PLACE at slot ``pos % C`` (the reference returns updated
    copies; a copy of the cache per layer and token is what the port
    avoids). ``pos``: host int — tokens already in the cache.
    Returns (out [B,1,D], cache_k, cache_v).
    """
    b, s, _ = x.shape
    assert s == 1
    c = cache_k.shape[1]
    q, k, v = _qkv(p, x, angles, cfg, sp)
    slot = pos % c                                   # ring write (SWA) / linear (full)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]

    scores = _gqa_scores(q, cache_k)                 # [B,KV,G,1,C]
    slot_ids = torch.arange(c, device=x.device)
    # absolute position each slot currently holds
    abs_pos = torch.where(slot_ids <= slot, pos - slot + slot_ids,
                          pos - slot + slot_ids - c)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if cfg.swa_window is not None:
        valid &= (pos - abs_pos) < cfg.swa_window
    scores = torch.where(valid, scores, float("-inf"))
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = _gqa_out(probs, cache_v).reshape(b, 1, -1)
    return linear_apply(p["wo"], out, sp), cache_k, cache_v


def attn_decode_tp(p, x, angles, cache_k, cache_v, split: str, pos: int,
                   cfg: ModelConfig, sp=None):
    """``attn_decode`` under tensor parallelism: ``cache_k/v`` are this
    rank's blocks of the layer's ``[B, C, KV, dh]`` caches, placed by
    ``launch.sharding.cache_shardings``: ``split`` ``"slots"`` (C on the
    model axis) or ``"dh"`` (the head dim). Every rank
    writes the new token's K/V for all heads into its block (gathered over
    the heads: ``2·B·KV·dh`` elements a layer), so each rank reads all the
    query heads (this rank's columns of ``wq`` gathered, ``B·H·dh``; whole
    heads or, under a head cut, blocks inside them):

    * ``"slots"``: flash-decoding: each rank's softmax over its own slots,
      its row max, its sum of ``exp`` and its unnormalised output in f32,
      merged exactly over the model axis (an ``all_reduce`` of the max,
      then one of the rescaled sums and outputs, ``B·H·(dh + 1)`` f32);
    * ``"dh"``: the scores' partial dot products summed (``B·H·C`` f32),
      the output's head-dim blocks gathered;

    then this rank's columns of the output go through its rows of ``wo``:
    the caller sums the partial result over the model axis. Returns the
    partial ``[B, 1, D]``."""
    tp = spmd.active_tp()
    b = x.shape[0]
    dh = cfg.head_dim
    width = cfg.n_heads * dh // tp.size
    qa = tp.all_gather(linear_apply(p["wq"], x, sp), -1).reshape(
        b, 1, cfg.n_heads, dh)                        # [B, 1, H, dh]
    if angles is not None:
        qa = apply_rotary(qa, angles)
    k, v = _kv(p, x, angles, cfg, sp)
    kw = k if k.shape[2] == cfg.n_kv_heads else tp.all_gather(k, 2)
    vw = v if v.shape[2] == cfg.n_kv_heads else tp.all_gather(v, 2)
    if split == "slots":
        cl = cache_k.shape[1]
        c, r0 = cl * tp.size, tp.rank * cl
        slot = pos % c
        if r0 <= slot < r0 + cl:
            cache_k[:, slot - r0], cache_v[:, slot - r0] = kw[:, 0], vw[:, 0]
        ids = r0 + torch.arange(cl, device=x.device)
        scores = _gqa_scores(qa.float(), cache_k.float())  # [B,KV,G,1,Cl]
        scores = torch.where(_slot_valid(ids, slot, c, pos, cfg), scores,
                             float("-inf"))
        m = scores.amax(-1)                                 # [B,KV,G,1]
        top = tp.all_reduce(m, "max")
        e = torch.exp(scores - top[..., None])
        part = torch.cat([e.sum(-1, keepdim=True),
                          torch.einsum("bkgst,btkd->bkgsd", e,
                                       cache_v.float())], dim=-1)
        tot = tp.all_reduce(part)                           # [B,KV,G,1,1+dh]
        out = (tot[..., 1:] / tot[..., :1]).to(x.dtype)     # [B,KV,G,1,dh]
        out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, -1, dh)
    else:                                                   # "dh"
        c, dl = cache_k.shape[1], cache_k.shape[-1]
        d0 = tp.rank * dl
        slot = pos % c
        cache_k[:, slot] = kw[:, 0, :, d0:d0 + dl]
        cache_v[:, slot] = vw[:, 0, :, d0:d0 + dl]
        kvh = cache_k.shape[2]
        qg = qa[..., d0:d0 + dl].float().reshape(b, 1, kvh, -1, dl)
        scores = tp.all_reduce(torch.einsum("bskgd,btkd->bkgst", qg,
                                            cache_k.float())) / (dh ** 0.5)
        valid = _slot_valid(torch.arange(c, device=x.device), slot, c, pos,
                            cfg)
        probs = torch.softmax(torch.where(valid, scores, float("-inf")),
                              dim=-1).to(x.dtype)
        out = tp.all_gather(_gqa_out(probs, cache_v), 3)    # [B,1,H,dh]
    out = out.reshape(b, 1, -1)[..., tp.rank * width:(tp.rank + 1) * width]
    return linear_apply(p["wo"], out, sp)


def _slot_valid(slot_ids, slot: int, c: int, pos: int, cfg: ModelConfig):
    """Which ring slots hold a position the token at ``pos`` may read."""
    abs_pos = torch.where(slot_ids <= slot, pos - slot + slot_ids,
                          pos - slot + slot_ids - c)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if cfg.swa_window is not None:
        valid &= (pos - abs_pos) < cfg.swa_window
    return valid


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             sp: Optional[SparsityConfig] = None, d_ff: Optional[int] = None,
             lead: Tuple[int, ...] = ()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    sp_mlp = sp if (sp and "mlp" in sp.targets) else None
    p = {"w1": linear_init(gen, d, f, dtype, sp_mlp, lead=lead),
         "w2": linear_init(gen, f, d, dtype, sp_mlp, lead=lead)}
    if cfg.act == "swiglu":
        p["w3"] = linear_init(gen, d, f, dtype, sp_mlp, lead=lead)
    return p


def mlp_apply(p, x, cfg: ModelConfig, sp: Optional[SparsityConfig] = None):
    sp_mlp = sp if (sp and "mlp" in sp.targets) else None
    h = linear_apply(p["w1"], x, sp_mlp)
    if cfg.act == "swiglu":
        h = F.silu(h) * linear_apply(p["w3"], x, sp_mlp)
    elif cfg.act == "relu2":                       # Nemotron-4 squared ReLU
        h = torch.square(F.relu(h))
    elif cfg.act == "gelu":                        # jax.nn.gelu: tanh form
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.act)
    return linear_apply(p["w2"], h, sp_mlp)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    p = {"tok": _randn(gen, (cfg.vocab, cfg.d_model), dtype) * 0.02}
    if cfg.frontend:
        p["frontend_proj"] = _randn(gen, (cfg.frontend_dim, cfg.d_model),
                                    dtype) * (cfg.frontend_dim ** -0.5)
    return p


def embed_apply(p, tokens=None, embeds=None):
    if embeds is not None:
        return embeds @ p["frontend_proj"]
    return p["tok"][tokens]
