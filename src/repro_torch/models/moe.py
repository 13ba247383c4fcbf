"""Mixture-of-Experts layer (``repro.models.moe``): the Mixtral and
Moonlight families.

Token-choice top-k routing with capacity-bounded scatter dispatch: each
(token, choice) is ranked within its expert by a stable sort and scattered
into an ``[E, C, D]`` buffer; a choice ranked at or past the capacity ``C``
goes to a trash row and contributes 0. The experts run as one batched
product over the buffer (``torch.bmm``), all ``E`` of them whatever their
load, as the reference's einsum does.

Expert parameter forms (``configs.SparsityConfig`` with ``"expert"`` in
``targets``), per layer:

* dense    : {"w": [E, K, O]}
* masked   : {"w": [E, K, O], "umask": bool [K/block, 1]} — one pattern for
             all experts of the layer, applied at use (straight-through).
* compact  : {"w": [E, Kc, O], "rows": int64 [Kc]} — one kept-row pattern
             for all experts of the layer.

Ties: the router's top-k takes ``core.dsst._top_k_ids`` (descending, the
lower expert first on a tie, as ``jax.lax.top_k``), and the rank within an
expert a stable argsort, so the same choice is dropped at capacity.

Gradients: the scatter into the buffer and the gather back out are each a
gather through a slot map (``_SlotGather``) whose backward is a gather
through the inverse map, a token's choices summed over a fixed axis. Kept
slots are distinct, so no backward sums rows by atomics or depends on a
global deterministic mode: two calls of a step give the same gradients bit
for bit. ``moe_aux`` carries its gradient through ``probs.mean(0)`` (the
integer load is constant), as in the reference; ``moe_dropped`` has none.

Under an SPMD context with ``shardmap_moe`` the reference dispatches
inside ``shard_map``, each data shard's tokens local to it
(``_moe_apply_shardmap``, EP or TP inside experts). On a mesh of one
device that is this path; on more it is ``ROADMAP.md`` Queue 1 item 10c,
and ``moe_apply`` refuses it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SparsityConfig
from ..core.dsst import _top_k_ids
from ..core.sparsity import NMSpec
from ..launch import spmd
from .layers import _randn, _rows_from_umask, unit_masks


def _randn_scaled(gen: torch.Generator, shape, dtype, scale: float):
    # scaled in place: a stacked expert leaf is 17.7 GB at Moonlight's size,
    # and ``randn(...) * scale`` would hold a second copy while it scales
    return _randn(gen, shape, dtype).mul_(scale)


def _expert_mat(gen: torch.Generator, e: int, k_in: int, k_out: int, dtype,
                sp: Optional[SparsityConfig], lead: Tuple[int, ...]):
    if sp is None:
        return {"w": _randn_scaled(gen, (*lead, e, k_in, k_out), dtype,
                                   k_in ** -0.5)}
    spec = NMSpec(n=sp.n, m=sp.m, block=sp.block, out_tile=k_out)
    umask = unit_masks(gen, spec, k_in, k_out, math.prod(lead))  # [prod(lead), KB, 1]
    if sp.mode == "masked":
        return {"w": _randn_scaled(gen, (*lead, e, k_in, k_out), dtype,
                                   k_in ** -0.5),
                "umask": umask.reshape(*lead, *umask.shape[1:]).to(gen.device)}
    kc = k_in * sp.n // sp.m
    rows = torch.stack([_rows_from_umask(u[:, 0], sp.block, n=sp.n, m=sp.m)
                        for u in umask])
    return {"w": _randn_scaled(gen, (*lead, e, kc, k_out), dtype,
                               (k_in * sp.density) ** -0.5),
            "rows": rows.reshape(*lead, kc).to(gen.device)}


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             sp: Optional[SparsityConfig] = None, lead: Tuple[int, ...] = ()):
    """Router ``[*lead, D, E]`` and expert matrices ``w1``, ``w2`` (and
    ``w3`` for swiglu), drawn from ``gen`` on its device; ``lead`` stacks
    layers as ``layers.linear_init`` does."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    sp_e = sp if (sp and "expert" in sp.targets) else None
    p: Dict[str, object] = {
        "router": _randn_scaled(gen, (*lead, d, e), dtype, d ** -0.5)}
    p["w1"] = _expert_mat(gen, e, d, f, dtype, sp_e, lead)
    p["w2"] = _expert_mat(gen, e, f, d, dtype, sp_e, lead)
    if cfg.act == "swiglu":
        p["w3"] = _expert_mat(gen, e, d, f, dtype, sp_e, lead)
    return p


def _expert_apply(pm, x: torch.Tensor) -> torch.Tensor:
    """x [E, C, K] @ w [E, K', O] for any storage form."""
    if "rows" in pm:
        return torch.bmm(x.index_select(-1, pm["rows"]), pm["w"])
    if "umask" in pm:
        # straight-through, as layers.linear_apply: forward sees w·mask
        w = pm["w"]
        rows = w.shape[-2] // pm["umask"].shape[-2]
        maskf = pm["umask"].repeat_interleave(rows, dim=-2).to(w.dtype)
        return torch.bmm(x, w - (w * (1.0 - maskf)).detach())
    return torch.bmm(x, pm["w"])


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.moe_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _dispatch(flat: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
              c: int):
    """Route flat ``[N, D]`` tokens: ``(slot [N·K], gate [N, K], aux)``.
    ``slot`` is ``expert·C + rank`` for a kept choice and ``E·C`` (the
    trash row) for a dropped one."""
    n = flat.shape[0]
    e, k = cfg.moe_experts, cfg.moe_top_k
    logits = flat @ router_w.to(flat.dtype)                     # [N, E]
    probs = torch.softmax(logits.float(), dim=-1)
    eids = _top_k_ids(probs, k)                                 # [N, K]
    gate = torch.gather(probs, -1, eids)
    gate = (gate / gate.sum(-1, keepdim=True)).to(flat.dtype)

    # rank of each (token, choice) within its expert, in token order
    flat_e = eids.reshape(-1)                                   # [N·K]
    order = torch.argsort(flat_e, stable=True)
    # integer counts, exact in any order (bincount would read its max back
    # to the host on the card, once per layer)
    counts = torch.zeros(e, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n * k, device=flat.device) - starts[flat_e[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    slot = torch.where(rank < c, flat_e * c + rank, e * c)

    load = counts.float() / (n * k)
    aux = {"moe_aux": e * (probs.mean(0) * load).sum(),
           "moe_dropped": (rank >= c).sum() / (n * k),
           "moe_load": load}
    return slot, gate, aux


def _expert_ffn(p, ebuf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = _expert_apply(p["w1"], ebuf)
    if cfg.act == "swiglu":
        h = F.silu(h) * _expert_apply(p["w3"], ebuf)
    elif cfg.act == "relu2":
        h = torch.square(F.relu(h))
    elif cfg.act == "gelu":                         # jax.nn.gelu: tanh form
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.act)
    return _expert_apply(p["w2"], h)                            # [E, C, D]


class _SlotGather(torch.autograd.Function):
    """``out[i] = x[fwd[i]]``, where ``fwd[i] == len(x)`` reads a zero row.
    ``bwd`` is the inverse map (``x``'s row j was read by ``out`` row
    ``bwd[j]`` alone, or by none where ``bwd[j] == len(out)``), so the
    backward is the gather ``g_x[j] = g[bwd[j]]``. With ``group`` > 1, x's
    row j was read ``group`` times, by rows ``bwd[j·group : (j+1)·group]``,
    and its gradient sums them in that order."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, group):
        ctx.save_for_backward(bwd)
        ctx.group = group
        return _padded(x)[fwd]

    @staticmethod
    def backward(ctx, g):
        (bwd,) = ctx.saved_tensors
        gx = _padded(g)[bwd]
        if ctx.group > 1:
            gx = gx.view(-1, ctx.group, g.shape[-1]).sum(1)
        return gx, None, None, None


def _padded(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[-1]))])


def _slot_maps(slot: torch.Tensor, n_slots: int, k: int):
    """(token of each buffer slot, or N for an empty slot [E·C]; the
    (token, choice) row of each slot, or N·K [E·C]). Each map is written
    without a duplicate index: dropped choices land in rows of their own
    past the E·C slots."""
    nk = slot.shape[0]
    ar = torch.arange(nk, device=slot.device)
    dest = torch.where(slot < n_slots, slot, n_slots + ar)
    row = torch.full((n_slots + nk,), nk, dtype=torch.int64,
                     device=slot.device)
    row[dest] = ar
    row = row[:n_slots]
    return torch.where(row < nk, row // k, nk // k), row


def _combine(flat: torch.Tensor, eout: torch.Tensor, slot: torch.Tensor,
             row: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Each token's kept choices, weighted by their gates and summed; a
    dropped choice reads a zero row. ``row`` is the inverse of ``slot``
    (``_slot_maps``), the gather that carries the gradient back."""
    n, d = flat.shape
    k = gate.shape[1]
    routed = _SlotGather.apply(eout.reshape(-1, d), slot, row, 1)
    return (routed.view(n, k, d) * gate[..., None]).sum(1)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (out [B, S, D], aux): ``moe_aux`` (the load-balance
    loss), ``moe_dropped`` (share of choices past capacity) and
    ``moe_load`` [E] (share of choices per expert), f32. The capacity is
    that of the call's ``B·S`` tokens; the expert form is read off the
    params (the reference's ``sp`` argument goes unused there too)."""
    ctx = spmd.current()
    compact_experts = any("rows" in p[w] for w in ("w1", "w2") if w in p)
    if ctx is not None and ctx.shardmap_moe and not compact_experts \
            and ctx.mesh_size() > 1:
        raise NotImplementedError(
            "the MoE shard map (data-shard-local dispatch) on a mesh of "
            f"{ctx.mesh_size()} devices is ROADMAP.md Queue 1 item 10c")
    b, s, d = x.shape
    n, e, k = b * s, cfg.moe_experts, cfg.moe_top_k
    c = capacity(n, cfg)
    flat = x.reshape(n, d)
    slot, gate, aux = _dispatch(flat, p["router"], cfg, c)
    token, row = _slot_maps(slot, e * c, k)
    # the buffer gathers its tokens; a token's gradient gathers its k slots
    buf = _SlotGather.apply(flat, token, slot, k)
    eout = _expert_ffn(p, buf.view(e, c, d), cfg)
    return _combine(flat, eout, slot, row, gate).reshape(b, s, d), aux
