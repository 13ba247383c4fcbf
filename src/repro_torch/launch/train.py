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

The step takes ``attn`` (``"flash"``: the flash kernels on the card;
``"plain"``) and ``loss_chunk`` (chunked cross entropy); where one is not
given, the active ``launch.spmd`` context supplies it at call time, as the
reference reads its context, and with no context the route is flash and
the loss whole. The step counter is a host int, so the schedule and the
DSST decision are made on the host; nothing is read back from the card
inside a step.

Tracing: under an active tracer (``obs.trace.use``) the step records
``train.step`` (attribute ``tokens``) and in it ``train.forward``,
``train.backward``, ``train.grads_stack``, ``train.gates`` (``open``: the
step's gate fraction, a device scalar; ``layers``) and ``train.adamw``
(``launches``: the fused AdamW's kernel launches, ``elems``: the elements
it updated; 0 on the CPU), each with its device time. The blocks' spans
(``models/transformer``) sit under ``train.forward``; remat's recompute
sits under ``train.backward``, or is a root on autograd's own thread (the
card's backward).

Data parallelism: ``make_train_step(..., mesh=)`` on an LM mesh
(``launch.mesh.make_host_mesh``) runs the same body on the rank's own
batch, then

* all-reduces the gradients over the DP process groups (``data``, then
  ``pod``) in flat f32 buckets in tree order and divides by the DP size
  (integer and boolean leaves carry none);
* all-reduces, as means, what every rank must decide alike on: the gating
  engine's ``ia`` and ``pooled`` (so every rank opens the same layers) and
  the metrics ``loss``, ``ce`` and ``moe_dropped``; the clip and the DSST
  event read the reduced gradients;
* with ``hp.zero1`` (ZeRO-1, the reference's ``opt_state_shardings``),
  keeps only its block of ``m`` and ``v`` along the dim the rule names,
  updates only that block of each parameter and all-gathers the rest, bit
  for bit the replicated update (``init_train_state(mesh=)`` allocates
  the blocks). A leaf with no dividing dim stays replicated.

The MoE family at a DP size above 1 dispatches over the mesh
(``models/moe._moe_layer``; the step runs its body under
``spmd.use_dp(mesh)``): under an SPMD context with ``shardmap_moe`` each
rank dispatches its own tokens, with the capacity of its tokens, and
``moe_aux``, ``moe_dropped`` and ``moe_load`` are the DP means, the
reference's shard-mapped step; without it one dispatch covers the global
batch (the reference's ``pjit`` step): every rank gathers the ranks'
expert choices, the capacity is the global token count's and the slots
are assigned in global batch order, and each rank runs the experts on its
own tokens' rows. Each rank's loss keeps its own aux term's gradient, so
the mean of the ranks' gradients is the gradient of the reference's aux
loss; no collective in the loss is differentiated twice.

On a 1 × 1 ``AbstractMesh`` (no process group) the step issues no
collective and is ``make_train_step``'s.

Tensor parallelism: on a mesh whose model axis is above 1 every family
trains with its parameters placed as ``DTensor`` s by the rules
(``init_train_state(mesh=)``, :func:`place_params`); the model runs each
rank's shard (``launch/spmd.TensorParallel``: the Mamba2 mixer and the
MoE experts on their blocks too), the loss is the vocab-parallel cross
entropy, and

* ``_grads`` returns every gradient as a ``DTensor`` in its parameter's
  placements (a stacked leaf's per-layer blocks stacked);
* the DP buckets hold each rank's local blocks and all-reduce over the DP
  groups only; ``ia``, ``pooled`` and the metrics come out of the forward
  whole on every rank;
* the moments are ``DTensor`` s of their parameters' placements and local
  shapes; ZeRO-1 splits a leaf's local block along the dim
  ``opt_state_shardings`` names, bit for bit the replicated update;
* the clip reads every block's squares once (``optim.global_norm``);
* the masked experts' and projections' DSST event scores each matrix
  from its local block (``optim/sparse``).

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
from ..kernels import launch_counters
from ..models import transformer as T
from ..obs.trace import active
from ..optim import (AdamWConfig, SparseTrainState, adamw_init, adamw_update,
                     gated_scale_tree, lm_dsst_event)
from ..optim.optimizer import AdamWState, tree_leaves, tree_map, trainable
from ..optim.sparse import compute_gates
from . import spmd
from .mesh import axis_sizes, dp_axes, dp_size


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    mode: str = "backprop"            # "backprop" | "local"
    gating: Optional[GatingConfig] = None
    dsst_every: int = 0               # 0 = static connectivity
    moe_aux_weight: float = 0.01
    microbatch: int = 1               # grad-accumulation splits of the batch
    zero1: bool = False               # DP-split optimizer moments (ZeRO-1)


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
    with active().span("train.forward"):
        loss, (ce, aux) = loss_fn(tracked, batch)
    with active().span("train.backward"):
        gs = torch.autograd.grad(loss, xs, allow_unused=True,
                                 materialize_grads=True)
    by_id = {id(x): g for x, g in zip(xs, gs)}

    def grad_of(x, p):
        if isinstance(x, list):
            g = [by_id[id(v)] for v in x]
            if hasattr(p, "to_local"):      # a DTensor: stack the blocks
                return _placed_like(torch.stack([v.to_local() for v in g]), p)
            return torch.stack(g)
        return by_id.get(id(x))
    with active().span("train.grads_stack"):
        grads = {k: tree_map(grad_of, v, params[k])
                 for k, v in tracked.items()}
    return loss.detach(), (ce.detach(), _detach(aux)), grads


def _placed_like(local: torch.Tensor, p):
    """A local block as a ``DTensor`` in ``p``'s placements."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False)


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def _detach(tree):
    return {k: v.detach() for k, v in tree.items()}


def _adamw_counts() -> dict:
    """The fused AdamW's launches (its two kernels' in
    ``kernels.launch_counters()``) and the elements it updated, in this
    process so far."""
    c = launch_counters()
    return {"launches": c["adamw_norm"].launches + c["adamw_update"].launches,
            "elems": c["adamw_update"].elems}


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

GRAD_BUCKET = 1 << 26            # f32 elements an all-reduce bucket holds


class DataParallel:
    """The collectives of the data-parallel step on an LM mesh: the DP
    groups (``data`` first, then ``pod``), this rank's index over the DP
    axes (``pod`` major) and the ZeRO-1 layout. On an ``AbstractMesh``
    there are no groups, and nothing is communicated."""

    def __init__(self, mesh, cfg: ModelConfig, hp: "TrainHParams"):
        self.mesh, self.cfg = mesh, cfg
        self.axes, self.size = dp_axes(mesh), dp_size(mesh)
        self.groups = spmd.dp_groups(mesh)
        self.rank = spmd.dp_rank(mesh)
        # the moments split only over process groups (none on an
        # AbstractMesh, where every rank's state is whole)
        self.zero1 = hp.zero1 and self.size > 1 and bool(self.groups)

    def zero1_layout(self, params) -> Any:
        """``(dim, rank, DP size)`` for each leaf whose moments ZeRO-1
        splits (``sharding.opt_state_shardings``), else None."""
        from .sharding import dp_split_dim, opt_state_shardings
        if not self.zero1:
            return tree_map(lambda _: None, params)
        shard = opt_state_shardings(params, params, self.cfg, self.mesh)

        def one(p, sh):
            d = dp_split_dim(sh.spec, self.mesh) if trainable(p) else None
            return None if d is None else (d, self.rank, self.size)
        return tree_map(one, params, shard)

    def _all_reduce_mean(self, flat: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        for g in self.groups:
            dist.all_reduce(flat, group=g)
        return flat.div_(self.size)

    def mean_grads(self, grads):
        """Every float gradient averaged over the DP ranks, in place, in
        flat f32 buckets of at most ``GRAD_BUCKET`` elements (a larger leaf
        alone), in tree order."""
        if not self.groups:
            return grads
        bucket: list = []

        def flush():
            flat = self._all_reduce_mean(torch.cat(
                [g.reshape(-1).float() for g in bucket]))
            o = 0
            for g in bucket:
                g.copy_(flat[o:o + g.numel()].view_as(g))
                o += g.numel()
            bucket.clear()
        n = 0
        for g in tree_leaves(grads):
            if g is None:
                continue
            g = _local(g)               # a DTensor's block: its own shard
            if bucket and n + g.numel() > GRAD_BUCKET:
                flush()
                n = 0
            bucket.append(g)
            n += g.numel()
        if bucket:
            flush()
        return grads

    def mean_stats(self, named: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """f32 statistics (scalars and arrays) averaged over the DP ranks in
        one all-reduce."""
        if not self.groups:
            return named
        flat = self._all_reduce_mean(torch.cat(
            [v.reshape(-1).float() for v in named.values()]))
        out, o = {}, 0
        for k, v in named.items():
            out[k] = flat[o:o + v.numel()].view_as(v).to(v.dtype)
            o += v.numel()
        return out

    def gather_blocks(self, block: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` -> the whole tensor, the blocks
        in DP-rank order (``data`` within each ``pod``, then ``pod``)."""
        import torch.distributed as dist
        x = block.contiguous()
        for g in self.groups:
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, x, group=g)
            x = torch.cat(parts, dim=dim)
        return x

    def gather_params(self, params, layout) -> None:
        """After a ZeRO-1 update: each split leaf's blocks all-gathered
        from their ranks into the whole parameter, in place."""
        def one(p, z):
            if z is not None:
                d, i, n = z
                p = _local(p)
                w = p.shape[d] // n
                p.copy_(self.gather_blocks(p.narrow(d, i * w, w), d))
        with torch.no_grad():
            tree_map(one, params, layout)

    def full_opt_state(self, opt_state: AdamWState, layout) -> AdamWState:
        """ZeRO-1 moments gathered whole (every rank calls it; for a
        checkpoint). A ``DTensor`` moment (the TP step) stays placed:
        ``checkpoint.save`` gathers it over every mesh dim."""
        def one(m, z):
            return m if z is None or hasattr(m, "to_local") \
                else self.gather_blocks(m, z[0])
        return AdamWState(opt_state.step, tree_map(one, opt_state.m, layout),
                          tree_map(one, opt_state.v, layout))

    def placed_opt_state(self, opt_state: AdamWState, layout) -> AdamWState:
        """ZeRO-1 moments as ``DTensor`` s on the mesh, with no copy: a
        split leaf ``Shard`` on its dim over the DP axes, the rest
        ``Replicate``. ``runtime.fault_tolerance.elastic_remesh`` moves
        such a tree onto another mesh or one device."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        def one(m, z):
            if isinstance(m, DTensor):          # placed already (the TP step)
                return m
            pl = [Shard(z[0]) if z is not None and a in self.axes
                  else Replicate() for a in self.mesh.mesh_dim_names]
            return DTensor.from_local(m, self.mesh, pl, run_check=False)
        return AdamWState(opt_state.step, tree_map(one, opt_state.m, layout),
                          tree_map(one, opt_state.v, layout))

    def local_opt_state(self, opt_state: AdamWState, layout) -> AdamWState:
        """Whole moments -> this rank's ZeRO-1 blocks (copies); a
        ``DTensor`` moment is placed already (``checkpoint.restore`` into
        a placed template keeps this rank's block)."""
        def one(m, z):
            if z is None or hasattr(m, "to_local"):
                return m
            d, i, n = z
            w = m.shape[d] // n
            return m.narrow(d, i * w, w).clone()
        return AdamWState(opt_state.step, tree_map(one, opt_state.m, layout),
                          tree_map(one, opt_state.v, layout))


def make_train_step(cfg: ModelConfig, hp: TrainHParams, attn=None,
                    loss_chunk: Optional[int] = None, mesh=None):
    """The step ``(params, opt_state, sparse_state, batch) -> (params,
    opt_state, sparse_state, metrics)``; ``batch`` holds ``tokens`` (or
    ``embeds``) and ``labels`` as tensors on the params' device. Params and
    moments are updated in place (``adamw_update``); a DSST event returns
    new ``w`` and ``umask`` leaves. Metrics are device tensors, except
    ``lr`` (a float). ``step.loss_and_grads(params, batch)`` gives the
    step's ``(loss, (ce, aux), grads)`` without the update (one rank's).

    ``attn`` / ``loss_chunk``: given, they win; not given, the active SPMD
    context's ``flash_attn`` / ``loss_chunk`` apply, read at each call.
    ``mesh``: the data-parallel step over that LM mesh (module docstring),
    ``step.dp`` its :class:`DataParallel`; ``batch`` is then the rank's own
    part of the global batch."""
    if cfg.family == "mixed":
        raise NotImplementedError("the mixed family serves only: the port "
                                  "has no training step for it")
    local = hp.mode == "local"
    if hp.mode not in ("backprop", "local"):
        raise ValueError(f"mode must be 'backprop' or 'local', got {hp.mode!r}")
    dp = DataParallel(mesh, cfg, hp) if mesh is not None else None

    def loss_fn(params, batch):
        ctx = spmd.current()
        chunk = loss_chunk if loss_chunk is not None else \
            (ctx.loss_chunk if ctx is not None else None)
        chunked = bool(chunk) and not cfg.tie_embeddings
        out, aux = T.forward(params, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"), attn=attn,
                             local_mode=local, want_hidden=chunked)
        if chunked:  # out is the hidden stream; CE in [B, chunk, V] slabs
            ce = T.lm_loss_chunked(out, params["lm_head"], batch["labels"],
                                   chunk)
        else:
            ce = T.lm_loss(out, batch["labels"])
        loss = ce + hp.moe_aux_weight * aux["moe_aux"]
        if local:
            loss = loss + aux["local_loss"]
        return loss, (ce, aux)

    def grad_step(params, batch):
        if dp is not None:
            with spmd.use_dp(dp.mesh):
                return _grad_step(params, batch)
        return _grad_step(params, batch)

    def _grad_step(params, batch):
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
    layout: Dict[str, Any] = {}

    def train_step(params, opt_state, sparse_state: SparseTrainState, batch):
        with active().span("train.step", tokens=batch["labels"].numel()):
            return _train_step(params, opt_state, sparse_state, batch)

    def _train_step(params, opt_state, sparse_state: SparseTrainState, batch):
        if hp.microbatch > 1 and any(v.shape[0] % hp.microbatch
                                     for v in batch.values()):
            raise ValueError(f"batch does not split into {hp.microbatch} "
                             f"microbatches")
        loss, (ce, aux), grads = grad_step(params, batch)
        zero1 = None
        if dp is not None:
            # every rank decides the gates, the clip and the DSST event on
            # the same (reduced) numbers
            grads = dp.mean_grads(grads)
            red = dp.mean_stats({"loss": loss, "ce": ce,
                                 "moe_dropped": aux["moe_dropped"],
                                 "ia": aux["ia"], "pooled": aux["pooled"]})
            loss, ce = red["loss"], red["ce"]
            aux = dict(aux, moe_dropped=red["moe_dropped"], ia=red["ia"],
                       pooled=red["pooled"])
            if dp.zero1:
                if "params" not in layout:
                    layout["params"] = dp.zero1_layout(params)
                zero1 = layout["params"]

        # activity-dependent gated updates (ElfCore WU gating at LM scale)
        with active().span("train.gates", layers=cfg.n_layers) as sp:
            if hp.gating is not None:
                gates, sparse_state = compute_gates(
                    sparse_state, aux["ia"], aux["pooled"], hp.gating)
                scale = gated_scale_tree(params, gates, cfg.sparsity)
                gate_frac = gates.mean()
            else:
                scale = gated_scale_tree(params, None, cfg.sparsity) \
                    if masked else None
                gate_frac = torch.ones((), device=loss.device)
            sp.set(open=gate_frac)

        with active().span("train.adamw") as sp:
            before = _adamw_counts()
            params, opt_state, om = adamw_update(grads, params, opt_state,
                                                 hp.opt, scale, zero1=zero1)
            sp.set(**{k: n - before[k] for k, n in _adamw_counts().items()})
        if zero1 is not None:
            dp.gather_params(params, zero1)
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
    train_step.dp = dp
    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig, hp: TrainHParams,
                     device="cuda", mesh=None):
    """(params, AdamW state, SparseTrainState) on ``device``, the params
    drawn from ``gen`` (a CUDA generator draws them on the card; every rank
    of a data-parallel run draws the same). With ``mesh`` and ``hp.zero1``
    the moments are allocated as this rank's ZeRO-1 blocks. On a mesh whose
    model axis is above 1 the params are ``DTensor`` s placed by the rules
    (:func:`place_params`) and the moments ``DTensor`` s of their
    placements (``optim.adamw_init``)."""
    params = T.init_params(gen, cfg, device=device,
                           local_heads=hp.mode == "local")
    if mesh is not None and axis_sizes(mesh).get("model", 1) > 1:
        params = place_params(params, cfg, mesh)
    opt = adamw_init(params) if mesh is None \
        else adamw_init(params, DataParallel(mesh, cfg, hp).zero1_layout(params))
    return (params, opt,
            SparseTrainState.init(cfg.n_layers, cfg.d_model, device=device))


def place_params(params, cfg: ModelConfig, mesh):
    """``params`` (the same on every rank) as ``DTensor`` s placed by the
    LM rules (``launch.sharding.tree_shardings``), each rank keeping its
    own block: no communication."""
    from .sharding import tree_shardings
    from .spmd import place_local
    return tree_map(place_local, params, tree_shardings(params, cfg, mesh))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_training(cfg: ModelConfig, hp: TrainHParams, pipeline, n_steps: int,
                 seed: int = 0, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, log_every: int = 10, callback=None,
                 device="cuda", attn=None,
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
