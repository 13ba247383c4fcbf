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

Under an SPMD context with ``shardmap_moe`` on a mesh of more than one
device, each rank runs the reference's ``shard_map`` body on its own
tokens (:func:`_moe_apply_shardmap`): its capacity from its own tokens,
the experts split over the model axis, EP (``cfg.moe_shard_experts``,
Moonlight: each rank runs ``E / tp`` experts) or TP inside the experts
(Mixtral: ``w1``, ``w3`` split on F, ``w2`` on F's rows), the combine
summed over ``model``. On one device it is this path.
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
from ..launch.mesh import AbstractMesh
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
        return _moe_apply_shardmap(p, x, cfg, ctx)
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


def _local_experts(p, cfg: ModelConfig, tp_n: int, m: int):
    """This model rank's block of each expert matrix, as ``shard_map``'s
    ``in_specs`` slice the replicated leaves: EP splits the expert axis,
    TP inside experts ``w1`` / ``w3`` on F (their last dim) and ``w2`` on
    F's rows. The reference's specs name ``w`` alone: masked experts are
    refused, as there (compact ones take the unsharded path)."""
    out = {}
    for name in ("w1", "w2", "w3"):
        if name not in p:
            continue
        if set(p[name]) != {"w"}:
            raise ValueError(
                f"the shard-mapped MoE takes dense experts; {name} holds "
                f"{sorted(p[name])} (the reference's in_specs name w alone)")
        w = p[name]["w"]
        dim = 0 if cfg.moe_shard_experts else (1 if name == "w2" else 2)
        if w.shape[dim] % tp_n:
            raise ValueError(f"{name}'s dim {dim} ({w.shape[dim]}) does not "
                             f"split over a model axis of {tp_n}")
        blk = w.shape[dim] // tp_n
        out[name] = {"w": w.narrow(dim, m * blk, blk)}
    return out


def _moe_apply_shardmap(p, x: torch.Tensor, cfg: ModelConfig, ctx
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``_moe_apply_shardmap`` body on this rank. ``x`` is
    the rank's own block of the batch along the DP axes (as the DP step's
    batch is), replicated over ``model``; the expert leaves are whole and
    this rank takes its block (:func:`_local_experts`).

    * EP: every rank scatters its tokens into the full ``[E, C, D]``
      buffer, runs its ``E / tp`` experts, writes them into a zero
      ``[E, C, D]`` output, combines and sums over ``model``;
    * TP inside experts: every rank runs its F-slice of every expert and
      the combine is summed over ``model``.

    ``C`` is the capacity of this rank's tokens. Where the DP size is
    above 1, ``moe_aux``, ``moe_dropped`` and ``moe_load`` are the means
    over the DP axes (the reference's rule: there the global batch is the
    DP size times this block, which the DP axes divide).

    Gradients, as JAX transposes the ``shard_map``: the sum over
    ``model`` passes its cotangent through (``spmd.psum_model``), and the
    tokens entering the buffer and the gates entering the combine sum their
    partial cotangents over ``model`` (``spmd.grad_psum_model``), so the
    input and router gradients are whole on every model rank and each
    rank's expert block carries its own. ``moe_aux`` carries this rank's
    gradient (``spmd.pmean_dp``): the DP step's mean of the ranks'
    gradients is the gradient of the reference's DP mean. On a model axis
    of 1 no collective runs on the tokens and the body is
    :func:`moe_apply`'s on this rank's tokens, bit for bit."""
    if isinstance(ctx.mesh, AbstractMesh):
        raise ValueError(f"an abstract mesh of {ctx.mesh.shape} has no "
                         "process group to run the MoE shard map on")
    b, s, d = x.shape
    n, e, k = b * s, cfg.moe_experts, cfg.moe_top_k
    tp_n = spmd.model_size(ctx.mesh, ctx.tp_axis)
    m = spmd.model_rank(ctx.mesh, ctx.tp_axis)
    c = capacity(n, cfg)
    flat = x.reshape(n, d)
    slot, gate, aux = _dispatch(flat, p["router"], cfg, c)
    tokens = flat
    if tp_n > 1:
        tokens, gate = spmd.grad_psum_model(flat, ctx), \
            spmd.grad_psum_model(gate, ctx)
    token, row = _slot_maps(slot, e * c, k)
    buf = _SlotGather.apply(tokens, token, slot, k).view(e, c, d)
    wl = _local_experts(p, cfg, tp_n, m)
    if cfg.moe_shard_experts and tp_n > 1:
        el = e // tp_n
        eout = _expert_ffn(wl, buf.narrow(0, m * el, el), cfg)
        eout = F.pad(eout, (0, 0, 0, 0, m * el, e - (m + 1) * el))
    else:
        eout = _expert_ffn(wl, buf, cfg)
    out = _combine(flat, eout, slot, row, gate)
    if tp_n > 1:
        out = spmd.psum_model(out, ctx)
    if spmd.dp_size(ctx) > 1:
        # one collective for the three: moe_aux's gradient is this rank's
        flat_aux = spmd.pmean_dp(torch.cat([
            aux["moe_aux"].reshape(1), aux["moe_dropped"].reshape(1).float(),
            aux["moe_load"]]), ctx)
        aux = {"moe_aux": flat_aux[0], "moe_dropped": flat_aux[1],
               "moe_load": flat_aux[2:]}
    return out.reshape(b, s, d), aux
