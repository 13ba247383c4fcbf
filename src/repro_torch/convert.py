"""Carry weights and state across from the JAX reference, as numpy.

Both packages then compute on the same numbers: torch and JAX draw
different values from one seed, so parity tests make their inputs once
(the reference's ``init_params``, numpy events) and convert them here,
and its LM configs (``model_config``).
SNN floating leaves become float32 at this boundary (numpy defaults to
float64), integer counters int32, masks bool; LM leaves take the config's
dtype, with compact row ids as int64 index tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .configs.base import ModelConfig, SparsityConfig
from .core.dsst import DSSTAccumulator
from .core.engine import LayerState
from .core.gating import GatingState
from .core.snn import NetState, SNNConfig, StreamState
from .optim.optimizer import AdamWState
from .optim.sparse import SparseTrainState


def _f32(a, device) -> torch.Tensor:
    # torch.tensor copies: the result never aliases (possibly read-only)
    # numpy memory, since lane surgery writes state in place
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _i32(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.int32), device=device)


def params_from_numpy(np_params: Mapping[str, Any], cfg: SNNConfig,
                      device="cuda") -> dict:
    """The reference's stacked ``init_params`` output (``hidden/{w,mask}``,
    ``readout``) as torch tensors on ``device``."""
    w = _f32(np_params["hidden"]["w"], device)
    mask = torch.tensor(np.asarray(np_params["hidden"]["mask"], bool),
                        device=device)
    readout = _f32(np_params["readout"], device)
    if w.shape[0] != cfg.n_layers or readout.shape != (
            cfg.n_layers, cfg.n_hidden, cfg.n_out):
        raise ValueError(f"params do not fit {cfg}: w {tuple(w.shape)}, "
                         f"readout {tuple(readout.shape)}")
    return {"hidden": {"w": w, "mask": mask}, "readout": readout}


def serving_params_from_numpy(np_params: Mapping[str, Any],
                              device="cuda") -> dict:
    """The reference's mask-free serving rep ``{"wc", "idx", "readout"}``."""
    return {"wc": _f32(np_params["wc"], device),
            "idx": _i32(np_params["idx"], device),
            "readout": _f32(np_params["readout"], device)}


def stream_state_from_numpy(np_state: Any, device="cuda") -> StreamState:
    """The reference's ``StreamState`` (leaves as numpy, slot-leading)."""
    layers = LayerState(*(_f32(getattr(np_state.layers, f), device)
                          for f in LayerState._fields))
    return StreamState(layers=layers, x_tr=_f32(np_state.x_tr, device),
                       ss_mean=_f32(np_state.ss_mean, device),
                       t_in_window=_i32(np_state.t_in_window, device),
                       sample_idx=_i32(np_state.sample_idx, device))


def deltas_from_numpy(np_deltas: Any, device="cuda") -> torch.Tensor:
    """Per-stream deltas: compact ``[S, L, J, T, bk, bo]`` or dense
    ``[S, L, Kmax, N]``."""
    d = _f32(np_deltas, device)
    if d.dim() not in (4, 6):
        raise ValueError("deltas are compact (rank 6) or dense (rank 4), "
                         f"got {tuple(d.shape)}")
    return d


def seed_topology_service(service: Any, ref_service: Any) -> Any:
    """Copy the reference ``TopologyService``'s accumulated state (the
    ``pre``/``post`` factors, ``observed_steps``, ``epoch_idx`` and the
    step of its last epoch) into the port's ``service``, so both continue
    from one state. Returns ``service``."""
    service.pre = np.array(ref_service.pre, np.float32)
    service.post = np.array(ref_service.post, np.float32)
    service.observed_steps = float(ref_service.observed_steps)
    service.epoch_idx = int(ref_service.epoch_idx)
    service._last_epoch_step = int(ref_service._last_epoch_step)
    return service


def net_state_from_numpy(np_state: Any, device="cuda") -> NetState:
    """The reference's training ``NetState`` (leaves as numpy): layers,
    ``x_tr``, the ``GatingState``, one ``DSSTAccumulator`` per layer and
    ``sample_idx``, which becomes a host int."""
    layers = LayerState(*(_f32(getattr(np_state.layers, f), device)
                          for f in LayerState._fields))
    gate = GatingState(*(_f32(getattr(np_state.gate, f), device)
                         for f in GatingState._fields))
    acc = tuple(DSSTAccumulator(_f32(a.pre, device), _f32(a.post, device))
                for a in np_state.acc)
    return NetState(layers=layers, x_tr=_f32(np_state.x_tr, device),
                    gate=gate, acc=acc, sample_idx=int(np_state.sample_idx))


def _tree_from_numpy(tree: Any, leaf) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_from_numpy(v, leaf) for k, v in tree.items()}
    return leaf(np.asarray(tree))


def model_config(cfg: Any) -> ModelConfig:
    """The port's ``ModelConfig`` of the reference's LM config ``cfg``: the
    same fields (its ``sparsity`` as the port's ``SparsityConfig``), the
    port's own fields at their defaults."""
    def fields(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    kw = fields(cfg)
    if kw.get("sparsity") is not None:
        kw["sparsity"] = SparsityConfig(**fields(kw["sparsity"]))
    return ModelConfig(**kw)


def lm_params_from_numpy(np_params: Mapping[str, Any], cfg: Any,
                         device="cuda") -> dict:
    """The reference's LM ``init_params`` tree (leaves as numpy, per-layer
    leaves stacked ``[L, ...]``, ``local_heads`` included) on ``device``:
    floats in ``cfg.dtype``, compact ``rows`` as an int64 index tensor,
    masked ``umask`` as bool."""
    dtype = getattr(torch, cfg.dtype)

    def leaf(a):
        if a.dtype == bool:
            return torch.tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a.astype(np.int64), device=device)
        return torch.tensor(a.astype(np.float32), device=device).to(dtype)
    return _tree_from_numpy(np_params, leaf)


def lm_cache_from_numpy(np_cache: Mapping[str, Any], cfg: Any,
                        device="cuda") -> dict:
    """The reference's decode cache: the KV cache ``{"pos", "k", "v"}``, or
    for ssm and hybrid ``{"pos", "conv", "ssm"}`` plus the hybrid's
    ``shared_k``/``shared_v``. ``ssm`` stays f32 whatever ``cfg.dtype``;
    the other tensors take ``cfg.dtype``; ``pos`` is a host int."""
    dtype = getattr(torch, cfg.dtype)
    out = {}
    for k, v in np_cache.items():
        if k != "pos":
            t = torch.tensor(np.asarray(v, np.float32), device=device)
            out[k] = t if k == "ssm" else t.to(dtype)
    out["pos"] = int(np_cache["pos"])
    return out


def train_state_from_numpy(np_opt: Any, np_sparse: Any, device="cuda"):
    """The reference's ``AdamWState`` and ``SparseTrainState`` (leaves as
    numpy) as the port's: ``step`` a host int, the moments f32 (an int8
    scalar where the param is an integer or boolean leaf, as there), the
    gate statistics and pooled EMA f32."""
    def moment(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return _f32(a, device)
        return torch.tensor(a.astype(np.int8), device=device)
    opt = AdamWState(step=int(np_opt.step),
                     m=_tree_from_numpy(np_opt.m, moment),
                     v=_tree_from_numpy(np_opt.v, moment))
    gate = GatingState(*(_f32(getattr(np_sparse.gate, f), device)
                         for f in GatingState._fields))
    return opt, SparseTrainState(gate=gate,
                                 pooled_ema=_f32(np_sparse.pooled_ema, device))
