"""ElfCore's training-time machinery at LM scale (``repro.optim.sparse``):

* ``compute_gates`` — the activity-dependent per-layer gate (IA/SS: the
  chip's gated WU applied to AdamW; a gated-off layer's update is skipped).
* ``gated_scale_tree`` — per-leaf optimizer update scales: the gate, and
  for N:M-masked weights their expanded mask (the straight-through forward
  in ``models/layers`` gives dense grads for DSST scoring; updates stay on
  active connections).
* ``lm_dsst_event`` — one prune/regrow pass over every masked matrix of a
  parameter tree (RigL oracle on the real dense grads), through the port's
  ``core/dsst.prune_regrow``, which breaks top-k ties as ``jax.lax.top_k``.
* ``SparseTrainState`` — gating statistics carried across steps.

A masked expert leaf (``w [L, E, K, O]`` with one ``umask [L, KB, 1]`` a
layer for all its experts, as ``models/moe`` draws and applies it) takes
its mask across the expert axis, and its DSST unit scores sum over the
experts too. The reference broadcasts the ``[L, K, 1]`` mask against
``[L, E, K, O]`` and fails there (``ROADMAP.md`` Queue 3); its dense and
stacked leaves are the port's.

Everything stays on the device: no value is read back to decide anything.

Under tensor parallelism (``DTensor`` leaves placed by the LM rules) the
scales are built whole and ``adamw_update`` takes each leaf's block; the
DSST event scores a column-split matrix from its local block summed over
the model axis, a row-split one from the blocks gathered, so every rank
takes the same event and keeps its own block of the surviving weights.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import SparsityConfig
from ..core import gating as gating_lib
from ..core.sparsity import NMSpec
from ..core.topology import prune_regrow_stacked
from ..core.dsst import prune_regrow
from .optimizer import tree_leaves


class SparseTrainState(NamedTuple):
    gate: gating_lib.GatingState
    pooled_ema: torch.Tensor       # [L, D] per-layer pooled-output EMA (SS ref)

    @staticmethod
    def init(n_layers: int, d_model: int, device="cuda") -> "SparseTrainState":
        return SparseTrainState(
            gate=gating_lib.init_state(n_layers, device=device),
            pooled_ema=torch.zeros((n_layers, d_model), dtype=torch.float32,
                                   device=device))


def compute_gates(state: SparseTrainState, ia: torch.Tensor,
                  pooled: torch.Tensor, cfg: gating_lib.GatingConfig,
                  ema_rho: float = 0.05
                  ) -> Tuple[torch.Tensor, SparseTrainState]:
    """ia [L], pooled [L, D] from forward aux -> (gate [L] 0/1, new state)."""
    def _n(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)
    ss = (_n(pooled) * _n(state.pooled_ema)).sum(-1)             # [L]
    open_, gate_st = gating_lib.gate_batch(state.gate, ia, ss, cfg)
    ema = (1 - ema_rho) * state.pooled_ema + ema_rho * pooled
    return open_, SparseTrainState(gate=gate_st, pooled_ema=ema)


# ---------------------------------------------------------------------------
# update-scale tree (gate × mask)
# ---------------------------------------------------------------------------

def _lift(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A layer's mask ``[*lead, KB, 1]`` against its weight: an expert leaf
    ``[*lead, E, K, O]`` shares one pattern among its experts, so the mask
    gains a unit axis for them."""
    extra = w.dim() - m.dim()
    return m.reshape(*m.shape[:-2], *(1,) * extra, *m.shape[-2:])


def _whole(x):
    """A replicated ``DTensor`` (a mask) as its local, whole tensor."""
    return x.to_local() if hasattr(x, "to_local") else x


def _expand_mask(node) -> torch.Tensor:
    m = _whole(node["umask"])                                    # [..., KB, 1]
    block = node["w"].shape[-2] // m.shape[-2]
    return _lift(m.repeat_interleave(block, dim=-2).float(),
                 node["w"])                                      # [..., K, 1]


def gated_scale_tree(params, gate_vec: Optional[torch.Tensor],
                     sp: Optional[SparsityConfig]):
    """Tree matching ``params``: scalar/broadcast scales for
    ``adamw_update``. Leaves under the stacked ``layers`` (and
    ``local_heads``) subtree get ``gate_vec[l]`` (their leading dim is L);
    masked ``w`` leaves also get the expanded mask, so pruned entries get no
    update."""
    dev = tree_leaves(params)[0].device
    one = torch.ones((), dtype=torch.float32, device=dev)

    def lgate(ndim):
        return gate_vec.reshape((-1,) + (1,) * (ndim - 1))

    def rec(node, under_layers: bool):
        if isinstance(node, dict):
            has_mask = "umask" in node and "w" in node
            out = {}
            for k, v in node.items():
                if k == "w" and has_mask:
                    s = _expand_mask(node)
                    if under_layers and gate_vec is not None:
                        s = s * lgate(v.dim())
                    out[k] = s
                else:
                    out[k] = rec(v, under_layers)
            return out
        if under_layers and gate_vec is not None:
            return lgate(node.dim())
        return one

    return {key: rec(sub, under_layers=key in ("layers", "local_heads"))
            for key, sub in params.items()}


# ---------------------------------------------------------------------------
# DSST over a parameter tree
# ---------------------------------------------------------------------------

def _unit_score_shared(x: torch.Tensor, kb: int, experts: int = 0
                       ) -> torch.Tensor:
    """|x| summarised per mask unit for shared-pattern masks: [.., K, O] ->
    [.., KB, 1] (sum over block rows and all output columns); with
    ``experts`` axes before K (an expert leaf, one pattern for all its
    experts), over those too."""
    *lead, k, o = x.shape
    xg = x.abs().reshape(*lead, kb, k // kb, o)
    dims = tuple(range(-3 - experts, -3)) + (-1, -2)
    return xg.sum(dim=dims)[..., None]


def lm_dsst_event(params, grads, sp: SparsityConfig
                  ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Prune/regrow every masked matrix; returns (new params, stats).
    Survivors keep their weights, regrown units restart at 0."""
    spec1 = NMSpec(n=sp.n, m=sp.m)      # unit-granular view ([KB, 1] masks)
    k_re = max(0, min(sp.n - 1, int(round(sp.n * 0.3))))
    flips = []

    def event(umask, wsc, gsc):
        if umask.dim() > 2:   # stacked [L, ...]: one topology-stacked event
            shape = (-1,) + tuple(umask.shape[-2:])
            nm2, st = prune_regrow_stacked(umask.reshape(shape),
                                           wsc.reshape(shape),
                                           gsc.reshape(shape), spec1, k_re)
            flips.append(st.mask_change.float().mean())
            return nm2.reshape(umask.shape)
        new_umask, st = prune_regrow(umask, wsc, gsc, spec1, k_re)
        flips.append(st.mask_change.float())
        return new_umask

    def one(w, umask, gw):
        if hasattr(w, "to_local"):
            return _one_placed(w, umask, gw, event)
        kb, experts = umask.shape[-2], w.dim() - umask.dim()
        new_umask = event(umask, _unit_score_shared(w, kb, experts),
                          _unit_score_shared(gw, kb, experts))
        return _survivors(w, umask, new_umask, kb), new_umask

    def rec(node, gnode):
        if isinstance(node, dict):
            if "umask" in node and "w" in node:
                w, um = one(node["w"], node["umask"], gnode["w"])
                return {**node, "w": w, "umask": um}
            return {k: rec(v, gnode[k]) for k, v in node.items()}
        return node

    new_params = rec(params, grads)
    dev = tree_leaves(params)[0].device
    total = torch.stack(flips).sum() if flips else torch.zeros((), device=dev)
    return new_params, {"dsst_mask_change": total}


def _survivors(w, umask, new_umask, kb: int):
    """``w`` with the units that the event pruned zeroed (``w`` a whole
    matrix, or the local rows of one: ``umask`` then expanded to them)."""
    surv = _lift(umask & new_umask, w)
    return w * surv.repeat_interleave(w.shape[-2] // kb, dim=-2).to(w.dtype)


def _one_placed(w, umask, gw, event):
    """``lm_dsst_event``'s per-matrix event on ``DTensor`` leaves: the unit
    scores of the whole matrix from this rank's block (summed over the
    model axis for a column or expert split, gathered for a row split),
    the event taken on them (the same on every rank), this rank's block of
    the surviving weights kept."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from ..launch.spmd import model_dim
    mesh = w.device_mesh
    d = model_dim(w)
    wl, gl, um = w.to_local(), gw.to_local(), _whole(umask)
    kb, experts = um.shape[-2], w.dim() - um.dim()
    if d is None or d != w.dim() - 2:        # columns or experts split
        wsc = _unit_score_shared(wl, kb, experts)
        gsc = _unit_score_shared(gl, kb, experts)
        if d is not None:
            group = mesh.get_group("model")
            for t in (wsc, gsc):
                dist.all_reduce(t, group=group)
        new_um = event(um, wsc, gsc)
        new_w = _survivors(wl, um, new_um, kb)
    elif d == w.dim() - 2 and kb % mesh.size(
            mesh.mesh_dim_names.index("model")) == 0:
        group = mesh.get_group("model")
        n, r = dist.get_world_size(group), mesh.get_local_rank("model")

        def gathered(x):
            part = _unit_score_shared(x, kb // n, experts).contiguous()
            parts = [torch.empty_like(part) for _ in range(n)]
            dist.all_gather(parts, part, group=group)
            return torch.cat(parts, dim=-2)
        new_um = event(um, gathered(wl), gathered(gl))
        rows = kb // n                       # this rank's units of the mask
        new_w = _survivors(wl, um.narrow(-2, r * rows, rows),
                           new_um.narrow(-2, r * rows, rows), rows)
    else:
        raise ValueError(f"a mask of {kb} units does not split with the "
                         f"weight's dim {d} over the model axis")
    return (DTensor.from_local(new_w, mesh, w.placements, run_check=False),
            DTensor.from_local(new_um, mesh, umask.placements,
                               run_check=False))
