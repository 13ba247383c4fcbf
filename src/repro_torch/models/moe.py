"""Mixture-of-Experts layer (``repro.models.moe``): the Mixtral and
Moonlight families, and Nemotron-H's MoE layers.

Routing (``cfg.moe_scoring``): ``"softmax"``, the reference's, takes the
top k of the softmax of the router's logits and renormalises their
probabilities to sum to 1. ``"sigmoid"`` (Nemotron-H, DeepSeek-V3's
``noaux_tc`` with one group) scores each expert ``σ(x·W)`` in f32, chooses
the top k of ``score + bias`` (the ``[E]`` leaf ``bias`` steers the choice
only) and gates them by their scores, renormalised and times
``cfg.moe_route_scale``. A shared expert (``cfg.moe_shared_ff`` > 0, the
leaf ``shared``: an MLP of ``models/layers`` of that width) sees every
token and is added to the routed output.

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

Over a mesh (:func:`_moe_layer`), the experts split over the model axis,
EP (``cfg.moe_shard_experts``, Moonlight: each rank runs ``E / tp``
experts) or TP inside the experts (Mixtral: ``w1``, ``w3`` split on F,
``w2`` on F's rows), and the combine summed over ``model``:

* under an SPMD context with ``shardmap_moe`` on a mesh of more than one
  device, each rank runs the reference's ``shard_map`` body on its own
  tokens, with the capacity of its own tokens (dense experts only, as the
  reference's ``in_specs``);
* otherwise (the reference's ``pjit`` semantics) one dispatch over the
  global batch: every rank gathers the DP ranks' expert choices, so the
  capacity is the global token count's and the slots are assigned in
  global batch order, and ``moe_aux``, ``moe_dropped`` and ``moe_load``
  are the global batch's; each rank runs the experts on a buffer of its
  own tokens' rows only (:func:`_own_runs`: ``1 / DP`` of the global
  buffer; the FFN acts row by row, so the outputs are the same), in any
  expert form.

At a DP size of 1 the two are one function, bit for bit. On parameters
placed as ``DTensor`` s (``launch.spmd.TensorParallel``) the expert leaves
arrive as this rank's blocks; under sequence parallelism the layer takes
the whole sequence and hands back this rank's block. On one device, or
with no mesh, it is the plain path.

Tracing (``obs.trace``): the layer records ``moe.route`` (routing, the
slot maps and the buffer's gather; attributes ``choices`` = N·K and
``slots`` = E·C, host ints, and ``dropped``, the ``moe_dropped`` device
scalar, so ``choices · (1 - dropped) / slots`` is the buffer's useful
share), ``moe.experts``, ``moe.combine`` and, with a shared expert,
``moe.shared``. The shared expert runs on one device only (no mesh).
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
from ..launch.mesh import AbstractMesh, dp_size as mesh_dp_size
from ..obs.trace import active
from .layers import _randn, _rows_from_umask, mlp_apply, mlp_init, unit_masks


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
    layers as ``layers.linear_init`` does. Sigmoid scoring adds the
    selection bias ``[*lead, E]`` (zero), a shared expert its dense MLP
    ``shared`` (drawn last)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    sp_e = sp if (sp and "expert" in sp.targets) else None
    p: Dict[str, object] = {
        "router": _randn_scaled(gen, (*lead, d, e), dtype, d ** -0.5)}
    p["w1"] = _expert_mat(gen, e, d, f, dtype, sp_e, lead)
    p["w2"] = _expert_mat(gen, e, f, d, dtype, sp_e, lead)
    if cfg.act == "swiglu":
        p["w3"] = _expert_mat(gen, e, d, f, dtype, sp_e, lead)
    if cfg.moe_scoring == "sigmoid":
        p["bias"] = torch.zeros((*lead, e), dtype=dtype, device=gen.device)
    if cfg.moe_shared_ff:
        p["shared"] = mlp_init(gen, cfg, dtype, d_ff=cfg.moe_shared_ff,
                               lead=lead)
    return p


def _expert_apply(pm, x: torch.Tensor, k_in: int = 0) -> torch.Tensor:
    """x [E, C, K] @ w [E, K', O] for any storage form. ``k_in``: the
    whole input width, where ``w`` may be a row-parallel block under
    tensor parallelism (``w2`` split on F): a compact block gathers the
    input's column blocks and reads its own kept rows, a masked one its
    own units of the mask (as ``layers.linear_apply``)."""
    if "rows" in pm:
        rows, w = pm["rows"], pm["w"]
        if rows.shape[-1] != w.shape[-2]:            # a row-parallel block
            tp = spmd.active_tp()
            x = tp.enter_cols(x)
            rows = rows.narrow(-1, tp.rank * w.shape[-2], w.shape[-2])
        return torch.bmm(x.index_select(-1, rows), w)
    if "umask" in pm:
        # straight-through, as layers.linear_apply: forward sees w·mask
        w = pm["w"]
        rows = (k_in or w.shape[-2]) // pm["umask"].shape[-2]
        maskf = pm["umask"].repeat_interleave(rows, dim=-2).to(w.dtype)
        if maskf.shape[-2] != w.shape[-2]:           # a row-parallel block
            maskf = maskf.narrow(-2, spmd.active_tp().rank * w.shape[-2],
                                 w.shape[-2])
        return torch.bmm(x, w - (w * (1.0 - maskf)).detach())
    return torch.bmm(x, pm["w"])


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.moe_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _route(flat: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
           bias: Optional[torch.Tensor]):
    """``(eids [N, K], gate [N, K] in flat's dtype, probs [N, E] f32)``:
    the chosen experts, their gates, and each token's shares of the
    experts that ``moe_aux`` averages (module docstring)."""
    k = cfg.moe_top_k
    if cfg.moe_scoring == "softmax":
        logits = flat @ router_w.to(flat.dtype)                 # [N, E]
        probs = torch.softmax(logits.float(), dim=-1)
        eids = _top_k_ids(probs, k)                             # [N, K]
        gate = torch.gather(probs, -1, eids)
        return eids, (gate / gate.sum(-1, keepdim=True)).to(flat.dtype), probs
    if cfg.moe_scoring != "sigmoid":
        raise ValueError(f"moe_scoring must be 'softmax' or 'sigmoid', got "
                         f"{cfg.moe_scoring!r}")
    scores = torch.sigmoid(flat.float() @ router_w.float())     # [N, E]
    eids = _top_k_ids(scores if bias is None else scores + bias.float(), k)
    gate = torch.gather(scores, -1, eids)
    gate = gate / gate.sum(-1, keepdim=True) * cfg.moe_route_scale
    return eids, gate.to(flat.dtype), scores / scores.sum(-1, keepdim=True)


def _dispatch(flat: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
              c: int, mesh=None, bias: Optional[torch.Tensor] = None):
    """Route flat ``[N, D]`` tokens: ``(slot [N·K], gate [N, K], aux)``.
    ``slot`` is ``expert·C + rank`` for a kept choice and ``E·C`` (the
    trash row) for a dropped one; ``bias`` is sigmoid scoring's selection
    bias.

    ``mesh`` with DP axes above 1: these are this rank's tokens within the
    global batch (the DP ranks' tokens in DP-rank order). Every rank
    gathers the ranks' expert choices (eager ``all_gather`` of ``[N·K]``
    ints) and ranks them in global order, so the slots and drops of its
    own choices are the one-device dispatch's; ``moe_load`` and
    ``moe_dropped`` are the global batch's, and ``moe_aux`` takes the
    router's mean over the DP ranks (``spmd.mean_over``: the gradient
    this rank's own)."""
    n = flat.shape[0]
    e, k = cfg.moe_experts, cfg.moe_top_k
    eids, gate, probs = _route(flat, router_w, cfg, bias)

    # rank of each (token, choice) within its expert, in (global) token order
    mine = eids.reshape(-1)                                     # [N·K]
    groups = spmd.dp_groups(mesh) if mesh is not None else []
    flat_e = mine
    for g in groups:                       # data, then pod: DP-rank order
        flat_e = spmd.gather_group(flat_e, 0, g)
    nk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    # integer counts, exact in any order (bincount would read its max back
    # to the host on the card, once per layer)
    counts = torch.zeros(e, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(nk, device=flat.device) - starts[flat_e[order]]
    rank_all = torch.empty_like(rank_sorted)
    rank_all[order] = rank_sorted
    rank = rank_all
    me = probs.mean(0)
    if groups:
        r0 = spmd.dp_rank(mesh) * n * k
        rank = rank_all[r0:r0 + n * k]
        me = spmd.mean_over(me, groups, nk // (n * k))
    slot = torch.where(rank < c, mine * c + rank, e * c)

    load = counts.float() / nk
    aux = {"moe_aux": e * (me * load).sum(),
           "moe_dropped": (rank_all >= c).sum() / nk,
           "moe_load": load}
    return slot, gate, aux


def _own_runs(slot: torch.Tensor, e: int, c: int) -> Tuple[torch.Tensor, int]:
    """The global batch's slots of this rank's choices (:func:`_dispatch`
    given a mesh) -> ``(slot, C_buf)`` in a buffer of just this rank's
    rows. The slots are assigned in global order, DP-rank major, so this
    rank's kept choices of an expert hold one run of that expert's ``c``
    slots; the buffer keeps each run from its start, ``C_buf`` rows an
    expert (the longest run rounded up to 8: one read of the device's
    counts a layer), and the experts run on ``1 / DP`` of the global
    buffer's rows.

    On ``meta`` (the dry run) there is no count to read: ``C_buf`` is its
    static bound, ``c`` rounded up to 8, and the experts' flops and temp
    bytes are counted at that bound. The expert ids that the dispatch
    gathers, and with them its collectives, do not depend on ``C_buf``; on
    real tensors the result is the one above, bit for bit."""
    nk = slot.shape[0]
    kept = slot < e * c
    ex = torch.where(kept, slot // c, e)                # e: a dropped choice
    run = torch.zeros(e + 1, dtype=torch.int64, device=slot.device
                      ).scatter_add_(0, ex, kept.long())
    longest = c if slot.device.type == "meta" else int(run[:e].max())
    c_buf = max(8, -(-longest // 8) * 8)
    srt = torch.sort(slot).values               # kept slots are distinct
    head = srt[(torch.cumsum(run, 0) - run).clamp(max=nk - 1)]
    return torch.where(kept, ex * c_buf + slot - head[ex], e * c_buf), c_buf


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
    return _expert_apply(p["w2"], h, cfg.d_ff)                  # [E, C, D]


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
    that of the call's ``B·S`` tokens (over a mesh, of the global batch's
    or of this rank's: module docstring); the expert form is read off the
    params (the reference's ``sp`` argument goes unused there too)."""
    ctx = spmd.current()
    compact_experts = any("rows" in p[w] for w in ("w1", "w2") if w in p)
    shard_mapped = ctx is not None and ctx.shardmap_moe and \
        not compact_experts and ctx.mesh_size() > 1
    if shard_mapped and isinstance(ctx.mesh, AbstractMesh):
        raise ValueError(f"an abstract mesh of {ctx.mesh.shape} has no "
                         "process group to run the MoE shard map on")
    tp = spmd.active_tp()
    mesh = ctx.mesh if shard_mapped and tp is None else spmd.dispatch_mesh()
    return _moe_layer(p, x, cfg, mesh, tp, shard_mapped)


def _local_experts(p, cfg: ModelConfig, tp_n: int, m: int,
                   dense_only: bool = True):
    """This model rank's block of each expert matrix: EP splits the expert
    axis, TP inside experts ``w1`` / ``w3`` on F (their last dim) and
    ``w2`` on F's rows. A leaf placed by the rules arrives as that block
    already; a whole one is cut as ``shard_map``'s ``in_specs`` slice the
    replicated leaves (dense experts: the reference's specs name ``w``
    alone, so the shard map refuses masked ones, as there)."""
    out = {}
    for name in ("w1", "w2", "w3"):
        if name not in p:
            continue
        if dense_only and set(p[name]) != {"w"}:
            raise ValueError(
                f"the shard-mapped MoE takes dense experts; {name} holds "
                f"{sorted(p[name])} (the reference's in_specs name w alone)")
        w = p[name]["w"]
        dim = 0 if cfg.moe_shard_experts else (1 if name == "w2" else 2)
        whole = cfg.moe_experts if cfg.moe_shard_experts else (
            cfg.d_ff if name != "w2" or "rows" not in p[name]
            else p[name]["rows"].shape[-1])
        if tp_n == 1 or w.shape[dim] != whole:
            out[name] = p[name]          # one rank, or placed: its block
            continue
        if w.shape[dim] % tp_n:
            raise ValueError(f"{name}'s dim {dim} ({w.shape[dim]}) does not "
                             f"split over a model axis of {tp_n}")
        blk = w.shape[dim] // tp_n
        out[name] = dict(p[name], w=w.narrow(dim, m * blk, blk))
    return out


def _moe_layer(p, x: torch.Tensor, cfg: ModelConfig, mesh, tp,
               shard_mapped: bool
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE layer on this rank of ``mesh`` (module docstring; with no
    mesh, or one with no DP group and no model axis in use, the one-device
    layer). ``x`` is the rank's own block of the batch along the DP axes
    (as the DP step's batch is), replicated over ``model`` (under sequence
    parallelism its sequence block, gathered whole here).

    * EP: every rank scatters its tokens into the full ``[E, C, D]``
      buffer, runs its ``E / tp`` experts, writes them into a zero
      ``[E, C, D]`` output, combines and sums over ``model``;
    * TP inside experts: every rank runs its F-slice of every expert and
      the combine is summed over ``model``.

    With ``shard_mapped``, ``C`` is the capacity of this rank's tokens and,
    where the DP size is above 1, ``moe_aux``, ``moe_dropped`` and
    ``moe_load`` are the means over the DP axes (the reference's rule);
    otherwise the dispatch is the global batch's (:func:`_dispatch` given
    the mesh; at a DP size of 1 both are the one-device dispatch).

    Gradients, as JAX transposes the ``shard_map``: the sum over
    ``model`` passes its cotangent through (``TensorParallel.leave``, or
    ``spmd.sum_over`` on whole leaves), and the tokens entering the
    buffer and the gates entering the combine sum their partial cotangents
    over ``model`` (``spmd.grad_sum_over``), so the input and router
    gradients are whole on every model rank and each rank's expert block
    carries its own. ``moe_aux`` carries this rank's gradient
    (``spmd.mean_over``): the DP step's mean of the ranks' gradients is the
    gradient of the reference's. On a model axis of 1 no collective runs
    on the tokens and the body is :func:`moe_apply`'s on this rank's
    tokens, bit for bit."""
    tp_n = spmd.model_size(mesh) if (shard_mapped or tp is not None) else 1
    m = spmd.model_rank(mesh) if tp_n > 1 else 0
    if tp is not None and tp.seq:
        x = tp.gather(x, 1)                  # the whole sequence
    b, s, d = x.shape
    n, e, k = b * s, cfg.moe_experts, cfg.moe_top_k
    flat = x.reshape(n, d)
    dp_n = mesh_dp_size(mesh) if spmd.dp_groups(mesh) else 1
    with active().span("moe.route") as sp:
        if shard_mapped or dp_n == 1:
            c = capacity(n, cfg)
            slot, gate, aux = _dispatch(flat, p["router"], cfg, c,
                                        bias=p.get("bias"))
            if dp_n > 1:
                # one collective for the three: moe_aux's gradient is this
                # rank's
                flat_aux = spmd.mean_over(torch.cat([
                    aux["moe_aux"].reshape(1),
                    aux["moe_dropped"].reshape(1).float(), aux["moe_load"]]),
                    spmd.dp_groups(mesh), dp_n)
                aux = {"moe_aux": flat_aux[0], "moe_dropped": flat_aux[1],
                       "moe_load": flat_aux[2:]}
        else:
            c = capacity(n * dp_n, cfg)
            slot, gate, aux = _dispatch(flat, p["router"], cfg, c, mesh,
                                        p.get("bias"))
            slot, c = _own_runs(slot, e, c)
        sp.set(choices=n * k, slots=e * c, dropped=aux["moe_dropped"])
        tokens = flat
        if tp_n > 1:
            group = [spmd.model_group(mesh)]
            tokens, gate = spmd.grad_sum_over(flat, group), \
                spmd.grad_sum_over(gate, group)
        token, row = _slot_maps(slot, e * c, k)
        # the buffer gathers its tokens; a token's gradient gathers its k
        # slots
        buf = _SlotGather.apply(tokens, token, slot, k).view(e, c, d)
    wl = _local_experts(p, cfg, tp_n, m, shard_mapped)
    with active().span("moe.experts"):
        if cfg.moe_shard_experts and tp_n > 1:
            el = e // tp_n
            if el * tp_n != e:
                raise ValueError(f"{e} experts do not split over a model "
                                 f"axis of {tp_n}")
            eout = _expert_ffn(wl, buf.narrow(0, m * el, el), cfg)
            eout = F.pad(eout, (0, 0, 0, 0, m * el, e - (m + 1) * el))
        else:
            eout = _expert_ffn(wl, buf, cfg)
    with active().span("moe.combine"):
        out = _combine(flat, eout, slot, row, gate).reshape(b, s, d)
    if "shared" in p:
        if tp_n > 1 or dp_n > 1:
            raise NotImplementedError("a shared expert over a mesh")
        with active().span("moe.shared"):
            out = out + mlp_apply(p["shared"], x, cfg)
    if tp_n > 1:
        out = tp.leave(out) if tp is not None else \
            spmd.sum_over(out, [spmd.model_group(mesh)])
    return out, aux
