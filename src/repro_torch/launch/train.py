"""Training step factory and the single-host loop (``repro.launch.train``).

``make_train_step`` builds the step for any config of the pool (dense,
moe, vlm, audio, ssm and hybrid):

* ``mode="backprop"`` — cross entropy + AdamW;
* ``mode="local"``    — OSSL: per-block predictive + contrastive losses
  behind detached block inputs, plus a supervised readout on frozen
  features (no backward across blocks);
* ``gating``          — activity-dependent per-layer update skipping
  (``optim/sparse.compute_gates``);
* ``dsst_every``      — connectivity prune/regrow for masked N:M configs;
* ``microbatch``      — gradient accumulation over slices of the batch.

Where the reference reads its mesh context (``spmd.current()``), the step
takes explicit arguments: ``attn`` (``"flash"``: the flash kernels on the
card; ``"plain"``) and ``loss_chunk`` (chunked cross entropy). The step
counter is a host int, so the schedule and the DSST decision are made on
the host; nothing is read back from the card inside a step. ``zero1``
only picks a sharding of the moments in the reference; on one device it
changes nothing, so the port accepts it and ignores it.

``run_training`` is the single-host loop. With ``ckpt_dir`` it resumes
from the newest valid checkpoint there (the caller replays the data
pipeline to the step after it) and saves ``(params, opt_state,
sparse_state)`` every ``ckpt_every`` steps, with ``pipeline.state()`` as
the checkpoint's ``extra``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.gating import GatingConfig
from ..models import transformer as T
from ..optim import (AdamWConfig, SparseTrainState, adamw_init, adamw_update,
                     gated_scale_tree, lm_dsst_event)
from ..optim.optimizer import tree_map, trainable
from ..optim.sparse import compute_gates


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    mode: str = "backprop"            # "backprop" | "local"
    gating: Optional[GatingConfig] = None
    dsst_every: int = 0               # 0 = static connectivity
    moe_aux_weight: float = 0.01
    microbatch: int = 1               # grad-accumulation splits of the batch
    zero1: bool = False               # a sharding choice: no effect on one device


STACKED = ("layers", "local_heads")     # subtrees whose leaves lead with L


def _grads(params, loss_fn, batch):
    """(loss, (ce, aux)) and the gradient tree (``None`` at integer and
    boolean leaves; zeros where a float leaf takes no part).

    A stacked ``[L, ...]`` leaf is tracked as L per-layer views (the model
    reads layer ``i`` as ``leaf[i]``, which a list answers too), and their
    gradients are stacked once: tracking the stacked leaf itself would make
    autograd's select backward write a full-size zero tensor per layer and
    add L of them."""
    xs = []

    def req(p):
        x = p.detach().requires_grad_()
        xs.append(x)
        return x

    def track(p, stacked):
        if not trainable(p):
            return p
        return [req(p[i]) for i in range(p.shape[0])] if stacked else req(p)
    tracked = {k: tree_map(lambda p, st=k in STACKED: track(p, st), v)
               for k, v in params.items()}
    loss, (ce, aux) = loss_fn(tracked, batch)
    gs = torch.autograd.grad(loss, xs, allow_unused=True, materialize_grads=True)
    by_id = {id(x): g for x, g in zip(xs, gs)}

    def grad_of(x):
        if isinstance(x, list):
            return torch.stack([by_id[id(v)] for v in x])
        return by_id.get(id(x))
    grads = {k: tree_map(grad_of, v) for k, v in tracked.items()}
    return loss.detach(), (ce.detach(), _detach(aux)), grads


def _detach(tree):
    return {k: v.detach() for k, v in tree.items()}


def make_train_step(cfg: ModelConfig, hp: TrainHParams, attn: str = "flash",
                    loss_chunk: Optional[int] = None):
    """The step ``(params, opt_state, sparse_state, batch) -> (params,
    opt_state, sparse_state, metrics)``; ``batch`` holds ``tokens`` (or
    ``embeds``) and ``labels`` as tensors on the params' device. Params and
    moments are updated in place (``adamw_update``); a DSST event returns
    new ``w`` and ``umask`` leaves. Metrics are device tensors, except
    ``lr`` (a float). ``step.loss_and_grads(params, batch)`` gives the
    step's ``(loss, (ce, aux), grads)`` without the update."""
    local = hp.mode == "local"
    if hp.mode not in ("backprop", "local"):
        raise ValueError(f"mode must be 'backprop' or 'local', got {hp.mode!r}")
    chunked = bool(loss_chunk) and not cfg.tie_embeddings

    def loss_fn(params, batch):
        out, aux = T.forward(params, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), attn=attn,
                             local_mode=local, want_hidden=chunked)
        if chunked:  # out is the hidden stream; CE in [B, chunk, V] slabs
            ce = T.lm_loss_chunked(out, params["lm_head"], batch["labels"],
                                   loss_chunk)
        else:
            ce = T.lm_loss(out, batch["labels"])
        loss = ce + hp.moe_aux_weight * aux["moe_aux"]
        if local:
            loss = loss + aux["local_loss"]
        return loss, (ce, aux)

    def grad_step(params, batch):
        if hp.microbatch <= 1:
            return _grads(params, loss_fn, batch)
        # gradient accumulation: running-mean f32 grads over batch slices
        k = hp.microbatch
        gsum = loss = ce = aux = None
        for part in zip(*(v.chunk(k) for v in batch.values())):
            l_, (c_, a_), g = _grads(params, loss_fn, dict(zip(batch, part)))
            g = tree_map(lambda x: None if x is None else x.float() / k, g)
            if gsum is None:
                gsum, loss, ce = g, l_ / k, c_ / k
                aux = {n: a / k for n, a in a_.items()}
            else:
                gsum = tree_map(lambda a, b: None if a is None else a + b,
                                gsum, g)
                loss, ce = loss + l_ / k, ce + c_ / k
                aux = {n: aux[n] + a / k for n, a in a_.items()}
        return loss, (ce, aux), gsum

    masked = bool(cfg.sparsity) and cfg.sparsity.mode == "masked"

    def train_step(params, opt_state, sparse_state: SparseTrainState, batch):
        if hp.microbatch > 1 and any(v.shape[0] % hp.microbatch
                                     for v in batch.values()):
            raise ValueError(f"batch does not split into {hp.microbatch} "
                             f"microbatches")
        loss, (ce, aux), grads = grad_step(params, batch)

        # activity-dependent gated updates (ElfCore WU gating at LM scale)
        if hp.gating is not None:
            gates, sparse_state = compute_gates(
                sparse_state, aux["ia"], aux["pooled"], hp.gating)
            scale = gated_scale_tree(params, gates, cfg.sparsity)
            gate_frac = gates.mean()
        else:
            scale = gated_scale_tree(params, None, cfg.sparsity) if masked \
                else None
            gate_frac = torch.ones((), device=loss.device)

        params, opt_state, om = adamw_update(grads, params, opt_state, hp.opt,
                                             scale)
        metrics = {"loss": loss, "ce": ce, "gate_frac": gate_frac,
                   "moe_dropped": aux["moe_dropped"], **om}
        # DSST connectivity event (masked N:M configs), decided on the host
        if hp.dsst_every and masked:
            if opt_state.step % hp.dsst_every == 0:
                with torch.no_grad():
                    params, stats = lm_dsst_event(params, grads, cfg.sparsity)
                metrics["dsst_mask_change"] = stats["dsst_mask_change"]
            else:
                metrics["dsst_mask_change"] = torch.zeros((), device=loss.device)
        return params, opt_state, sparse_state, metrics

    # the step's own loss and gradients, without the update (for parity)
    train_step.loss_and_grads = grad_step
    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig, hp: TrainHParams,
                     device="cuda"):
    """(params, AdamW state, SparseTrainState) on ``device``, the params
    drawn from ``gen`` (a CUDA generator draws them on the card)."""
    params = T.init_params(gen, cfg, device=device,
                           local_heads=hp.mode == "local")
    return (params, adamw_init(params),
            SparseTrainState.init(cfg.n_layers, cfg.d_model, device=device))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_training(cfg: ModelConfig, hp: TrainHParams, pipeline, n_steps: int,
                 seed: int = 0, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, log_every: int = 10, callback=None,
                 device="cuda", attn: str = "flash",
                 loss_chunk: Optional[int] = None
                 ) -> Tuple[Any, Dict[str, Any]]:
    """Single-host training loop from a fresh state drawn with ``seed``.
    Returns ((params, opt, sparse), history); ``history`` holds ``loss``,
    ``step`` and ``step_time`` (seconds, host clock around one step that
    ends in a device synchronise) at every ``log_every``-th step and the
    last. ``pipeline``: an iterator of ``(step, batch)`` or a callable
    ``step -> batch`` (numpy arrays). With ``ckpt_dir``, a run resumes
    after the newest valid checkpoint there and saves after every step
    ``s`` with ``s % ckpt_every == ckpt_every - 1``, keeping ``save``'s
    default number of the newest."""
    from .. import checkpoint as ckpt
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, opt_state, sparse_state = init_train_state(gen, cfg, hp, dev)
    step_fn = make_train_step(cfg, hp, attn=attn, loss_chunk=loss_chunk)
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        start, (params, opt_state, sparse_state), _ = ckpt.restore(
            ckpt_dir, (params, opt_state, sparse_state))
        start += 1
    history: Dict[str, list] = {"loss": [], "step": [], "step_time": []}
    for step in range(start, n_steps):
        _, batch = next(pipeline) if hasattr(pipeline, "__next__") \
            else (None, pipeline(step))
        batch = {k: torch.as_tensor(v).to(dev, torch.long) if k != "embeds"
                 else torch.as_tensor(v).to(dev) for k, v in batch.items()}
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, sparse_state, m = step_fn(
            params, opt_state, sparse_state, batch)
        _sync(dev)
        dt = time.perf_counter() - t0
        if step % log_every == 0 or step == n_steps - 1:
            history["loss"].append(float(m["loss"]))
            history["step"].append(step)
            history["step_time"].append(dt)
        if callback:
            callback(step, m)
        if ckpt_dir and step % ckpt_every == ckpt_every - 1:
            ckpt.save(ckpt_dir, step, (params, opt_state, sparse_state),
                      extra=pipeline.state() if hasattr(pipeline, "state")
                      else {})
    return (params, opt_state, sparse_state), history
