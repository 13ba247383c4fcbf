"""The per-timestep layer engine shared by training and serving
(``repro.core.engine``).

:func:`_layer_timestep` is the one layer body: forward current, fused LIF
step, OSSL modulator, IA/SS gate, gated weight update and telemetry, for
ONE layer at ONE timestep. :func:`scan_chunk` (serving: per-slot gates,
updates into per-slot deltas, valid masking) and
:func:`scan_sample` (training: aligned batch, one gate decision per layer
shared across the batch, updates into the base weights) drive it over the
timesteps and the layer stack; JAX's two ``lax.scan``\\ s become Python
loops over time and layers.

Backend seam: ``SNNConfig.backend`` is ``"ref"`` or ``"kernels"`` (the
counterpart of the reference's ``"pallas"``). Serving runs by default on
the mask-free compact N:M layout (values ``wc [L, J, T, bk, bo]`` plus kept
block ids ``idx [L, J, T]``, per-slot compact deltas), whose forward
current goes through ``nm_spmm`` under either backend; ``"kernels"`` adds
the fused LIF kernel. The dense delta layout (``[S, L, Kmax, N]``, the
A/B baseline) takes the rep of :func:`prepare_weights` with its dense
mask: ``nm_spmm`` unfused (``"kernels"``) or ``pre @ w`` (``"ref"``) for
the base, an order-fixed sum of products for the deltas, and a masked
dense update. Serving sums each slot's deltas product and readout in an
order fixed by the layer's widths alone, so a slot rounds alike however
many slots share the call (what a slot-sharded fleet's bit-identity with
one device rests on); the ``"ref"`` base ``pre @ w`` stays a GEMM.
Training carries the weight rep :func:`prepare_weights` picks: ``"ref"``
the dense ``{"w", "mask_f"}`` (a plain ``pre @ w`` and a masked dense WU),
``"kernels"`` the compact rep (``nm_spmm``, ``lif`` and ``wu_outer``
kernels on CUDA tensors, their plain versions on CPU tensors).

Nothing here writes into a caller's tensors: every step returns fresh
tensors. The one update in place is the serving WU: :func:`scan_chunk`
copies the deltas once at the start of a chunk (the copy it returns, so a
chunk makes one full-delta copy, as before) and each layer-timestep adds
its per-slot update into that copy (``wu_outer_slots_update``, or the
masked outer product for dense deltas).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..kernels.lif import ops as lif_ops
from ..kernels.lif.ref import lif_step
from ..kernels.nm_spmm import ops as nm_ops
from ..kernels.nm_spmm import ref as nm_ref
from ..kernels.wu_outer import ops as wu_ops
from . import gating as gating_lib
from . import topology as topology_lib

BACKENDS = ("ref", "kernels")


# ---------------------------------------------------------------------------
# neuron math
# ---------------------------------------------------------------------------

def surrogate_grad(v, *, theta, width):
    """Triangular STE (the chip's STE LUT for the non-derivative spike fn)."""
    return torch.clamp_min(1.0 - (v - theta).abs() / (theta * width), 0.0)


def _norm(a, keepdim=False):
    return torch.linalg.vector_norm(a, dim=-1, keepdim=keepdim)


def _cos(a, b, eps=1e-6):
    return (a * b).sum(-1) / (_norm(a) * _norm(b) + eps)


def _cos_grad(a, b, eps=1e-6):
    """d cos(a,b) / d a."""
    na = _norm(a, keepdim=True) + eps
    nb = _norm(b, keepdim=True) + eps
    c = (a * b).sum(-1, keepdim=True) / (na * nb)
    return b / (na * nb) - c * a / (na * na)


def ossl_modulator(tr, tr_pc, tr_cc, v, cfg):
    """Third factor of the three-factor rule: ``-dL/dtr`` of the local loss
    ``L = -cos(tr, tr_pc) + cc_weight * cos(tr, tr_cc)``, shaped through
    the spike-function surrogate."""
    g = _cos_grad(tr, tr_pc) - cfg.cc_weight * _cos_grad(tr, tr_cc)
    return g * surrogate_grad(v, theta=cfg.theta, width=cfg.surrogate_width)


def serving_ossl_terms(tr, tr_pc, tr_cc, v, cfg, eps=1e-6):
    """Serving's OSSL terms per slot: (modulator ``[S, N]``,
    ``cos(tr, tr_pc)`` ``[S]``, ``cos(tr, tr_cc)`` ``[S]``), by the
    formulas of :func:`ossl_modulator` and :func:`_cos`. The five row sums
    they need (three squared norms, two dot products) are taken in one
    :func:`ordered_sum` over ``N``: a reduction kernel picks its launch
    shape, and with it a row's summation order, by the row count (on the
    card 2 rows sum otherwise than 8), so a slot's numbers would depend on
    how many slots share the call and a slot-sharded fleet would drift from
    the 1-device one."""
    a = torch.stack([tr, tr_pc, tr_cc, tr, tr])
    b = torch.stack([tr, tr_pc, tr_cc, tr_pc, tr_cc])
    sq, sq_pc, sq_cc, dot_pc, dot_cc = ordered_sum((a * b).movedim(-1, 0))
    n, n_pc, n_cc = sq.sqrt(), sq_pc.sqrt(), sq_cc.sqrt()

    def cos_grad(other, n_other, dot):
        na = n[:, None] + eps
        nb = n_other[:, None] + eps
        c = dot[:, None] / (na * nb)
        return other / (na * nb) - c * tr / (na * na)
    g = cos_grad(tr_pc, n_pc, dot_pc) - cfg.cc_weight * cos_grad(tr_cc, n_cc,
                                                                  dot_cc)
    mod = g * surrogate_grad(v, theta=cfg.theta, width=cfg.surrogate_width)
    return mod, dot_pc / (n * n_pc + eps), dot_cc / (n * n_cc + eps)


# ---------------------------------------------------------------------------
# state / geometry
# ---------------------------------------------------------------------------

class LayerState(NamedTuple):
    """Three-trace neuron SRAM + membrane: ``[L, S, N]`` stacked in the
    engine, ``[S, N]`` per layer inside the layer loop."""
    v: torch.Tensor        # membrane
    tr: torch.Tensor       # current trace (WU slot)
    tr_pc: torch.Tensor    # earlier-TS snapshot (PC slot)
    tr_cc: torch.Tensor    # final trace of the previous window (CC slot)


class Geometry(NamedTuple):
    fanins: Tuple[int, ...]
    k_max: int
    uniform: bool       # all layers share fan-in and spec


def geometry(cfg) -> Geometry:
    """Per-layer fan-ins, the zero-padded stack width ``k_max`` and whether
    all layers share one fan-in (which the compact layout requires)."""
    fanins = tuple(cfg.layer_fanins)
    return Geometry(fanins=fanins, k_max=max(fanins),
                    uniform=len(set(fanins)) == 1)


def _pad_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.shape[0] == k:
        return x
    return torch.cat([x, x.new_zeros((k - x.shape[0],) + tuple(x.shape[1:]))])


def _pad_cols(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.shape[-1] == k:
        return x
    return torch.nn.functional.pad(x, (0, k - x.shape[-1]))


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    use_kernels: bool     # LIF through kernels/lif; training on the compact rep


def make_backend(cfg) -> Backend:
    """Resolve ``cfg.backend`` ("ref" | "kernels") to the dispatch record."""
    name = getattr(cfg, "backend", "ref")
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of {BACKENDS}")
    return Backend(name, name == "kernels")


def compact_kept(cfg) -> int:
    """Static kept-block count per out tile (from the spec)."""
    spec = cfg.spec(cfg.layer_fanins[0])
    kb, _ = spec.unit_counts(cfg.layer_fanins[0], cfg.n_hidden)
    return (kb // spec.m) * spec.n


def compact_weights(w_stacked: torch.Tensor, mask_stacked: torch.Tensor,
                    cfg) -> Dict[str, torch.Tensor]:
    """Stacked dense weights + unit masks -> ``{"wc" [L,J,T,bk,bo], "idx"
    [L,J,T]}``. Requires uniform layer fan-in (one ``idx`` geometry)."""
    geo = geometry(cfg)
    if not geo.uniform:
        raise ValueError(
            "the compact N:M layout requires uniform layer fan-in "
            f"(got {geo.fanins})")
    spec = cfg.spec(geo.fanins[0])
    pairs = [nm_ops.make_compact(w_stacked[l], mask_stacked[l], spec.block,
                                 spec.out_tile, n_kept=compact_kept(cfg))
             for l in range(cfg.n_layers)]
    return {"wc": torch.stack([p[0] for p in pairs]),
            "idx": torch.stack([p[1] for p in pairs])}


def dense_masks(mask_stacked: torch.Tensor, cfg) -> torch.Tensor:
    """Stacked unit masks ``[L, KBmax, J]`` -> dense float ``[L, Kmax, N]``
    (zero rows where a layer's fan-in is below the stack width)."""
    return topology_lib.dense_masks(mask_stacked, cfg, dtype=torch.float32)


def hidden_slice(params, l: int, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``l``'s (w ``[fan_in, N]``, unit_mask ``[KB, J]``) view of the
    stacked params."""
    fan_in = cfg.layer_fanins[l]
    kb, jj = cfg.spec(fan_in).unit_counts(fan_in, cfg.n_hidden)
    return (params["hidden"]["w"][l, :fan_in, :],
            params["hidden"]["mask"][l, :kb, :jj])


def stack_params(legacy, cfg):
    """Per-layer layout (lists of ``{"w", "mask"}`` dicts and readouts) ->
    the stacked layout, rows padded to the stack width."""
    k_max = geometry(cfg).k_max
    return {"hidden": {
                "w": torch.stack([_pad_rows(p["w"], k_max)
                                  for p in legacy["hidden"]]),
                "mask": torch.stack([_pad_rows(p["mask"], k_max)
                                     for p in legacy["hidden"]])},
            "readout": torch.stack(list(legacy["readout"]))}


def unstack_params(params, cfg):
    """Stacked layout -> per-layer layout (views of the stacked leaves)."""
    hidden = []
    for l in range(cfg.n_layers):
        w, m = hidden_slice(params, l, cfg)
        hidden.append({"w": w, "mask": m})
    return {"hidden": hidden,
            "readout": [params["readout"][l] for l in range(cfg.n_layers)]}


def prepare_weights(w_stacked: torch.Tensor, mask_stacked: torch.Tensor, cfg,
                    backend: Backend, *,
                    include_mask: bool = False) -> Dict[str, torch.Tensor]:
    """Weight rep carried through the time loop; its *keys* drive dispatch
    downstream (``"wc" in w_l`` → compact). ``"ref"``: the dense stacked
    weights plus the dense float mask ``{"w", "mask_f"}``; ``"kernels"``:
    the compact N:M rep ``{"wc", "idx"}``, with ``mask_f [L, Kmax, N]``
    added when ``include_mask`` (dense-delta serving masks its update with
    it)."""
    if not backend.use_kernels:
        return {"w": w_stacked, "mask_f": dense_masks(mask_stacked, cfg)}
    wrep = compact_weights(w_stacked, mask_stacked, cfg)
    if include_mask:
        wrep["mask_f"] = dense_masks(mask_stacked, cfg)
    return wrep


def finalize_weights(wrep, cfg, backend: Backend) -> torch.Tensor:
    """Back to dense stacked ``[L, Kmax, N]`` after the time loop."""
    if not backend.use_kernels:
        return wrep["w"]
    k_max = geometry(cfg).k_max
    return torch.stack([nm_ref.densify(wrep["wc"][l], wrep["idx"][l], k_max)
                        for l in range(cfg.n_layers)])


def compact_deltas(deltas: torch.Tensor, idx: torch.Tensor,
                   cfg) -> torch.Tensor:
    """Dense slot-leading deltas ``[S, L, Kmax, N]`` -> compact
    ``[S, L, J, T, bk, bo]`` by gathering the kept blocks of ``idx``
    (``[L, J, T]``). A pure gather: bitwise at every kept coordinate."""
    spec = cfg.spec(cfg.layer_fanins[0])
    bk, bo = spec.block, spec.out_tile
    s, l_, k, n = deltas.shape
    db = deltas.reshape(s, l_, k // bk, bk, n // bo, bo)
    db = db.permute(0, 1, 4, 2, 3, 5)               # [S, L, J, KB, bk, bo]
    return torch.take_along_dim(db, idx.long()[None, :, :, :, None, None],
                                dim=3)


def densify_deltas(deltas_c: torch.Tensor, idx: torch.Tensor,
                   cfg) -> torch.Tensor:
    """Compact slot-leading deltas ``[S, L, J, T, bk, bo]`` -> dense
    ``[S, L, Kmax, N]`` (zeros at pruned coordinates). A pure scatter into
    disjoint block rows: bitwise at every kept coordinate."""
    k_max = geometry(cfg).k_max
    s, l_, j, t, bk, bo = deltas_c.shape
    dev = deltas_c.device
    db = torch.zeros((s, l_, j, k_max // bk, bk, bo), dtype=deltas_c.dtype,
                     device=dev)
    li = torch.arange(l_, device=dev)[:, None, None]
    ji = torch.arange(j, device=dev)[None, :, None]
    db[:, li, ji, idx.long()] = deltas_c            # disjoint ids: exact set
    return db.permute(0, 1, 3, 4, 2, 5).reshape(s, l_, k_max, j * bo)


def fwd_current(pre, w_l, delta_l):
    """Forward synaptic current for one layer, dispatched on the weight
    rep's keys and the deltas' rank: the compact rep goes through
    ``nm_spmm``, with compact per-slot deltas (``[S, J, T, bk, bo]``) on the
    same kept-block ids fused into the same pass (``nm_spmm_fused``); the
    dense rep is a plain ``pre @ w``. Dense per-slot deltas
    (``[S, Kmax, N]``) add each slot's ``pre · delta`` to either base,
    summed over ``Kmax`` by :func:`ordered_sum` (a batched GEMM's order
    depends on the slot count, as :func:`ordered_readout` says)."""
    if delta_l is not None and delta_l.dim() == 5:
        return nm_ops.nm_spmm_fused(pre, w_l["wc"], w_l["idx"], delta_l)
    cur = (nm_ops.nm_spmm_batched(pre, w_l["wc"], w_l["idx"])
           if "wc" in w_l else pre @ w_l["w"])
    if delta_l is not None:
        cur = cur + ordered_sum(pre.t()[:, :, None]
                                * delta_l.transpose(0, 1))
    return cur


def lif(backend: Backend, cfg, v, tr, current):
    """One fused LIF step through the backend seam. Returns (v', tr', s)."""
    if backend.use_kernels:
        return lif_ops.lif_step(v, tr, current, alpha=cfg.alpha,
                                beta=cfg.beta, theta=cfg.theta)
    return lif_step(v, tr, current, alpha=cfg.alpha, beta=cfg.beta,
                    theta=cfg.theta)


def train_wu(cfg, w_l, pre_trace, mod, scale):
    """Gated three-factor WU into the base weights (training path). The
    sparsity pattern comes from the weight rep: kept block ids for the
    compact rep (through ``wu_outer_apply``: the update and the add in one
    launch, into fresh weights), the dense float mask for ``ref``."""
    if "wc" in w_l:
        spec = cfg.spec(cfg.layer_fanins[0])
        wc = wu_ops.wu_outer_apply(w_l["wc"], pre_trace, mod, w_l["idx"],
                                   scale, bk=spec.block, bo=spec.out_tile)
        return {**w_l, "wc": wc}
    dw = scale * (pre_trace.T @ mod)
    return {**w_l, "w": w_l["w"] + dw * w_l["mask_f"]}


# ---------------------------------------------------------------------------
# THE per-timestep layer body (training and serving)
# ---------------------------------------------------------------------------

class LayerSlice(NamedTuple):
    """One layer's inputs to the layer body. The sparsity pattern lives in
    the weight rep ``w`` (kept block ids, or ``mask_f`` for dense)."""
    w: Any                                # weight rep (see prepare_weights)
    readout: torch.Tensor                 # [N, n_out] bypass readout
    st: LayerState                        # leaves [R, N]
    ss_mean: torch.Tensor                 # [] (train) or [S] (serve)
    delta: Optional[torch.Tensor]         # serving [S, J, T, bk, bo] or [S, Kmax, N]
    fanin: torch.Tensor                   # [] f32 — true fan-in
    density: torch.Tensor                 # [] f32 — spec density
    gate_opened: Optional[torch.Tensor] = None    # [] training telemetry
    gate_offered: Optional[torch.Tensor] = None


class LayerCarry(NamedTuple):
    """Flows down the layer stack within one timestep."""
    pre_spikes: torch.Tensor              # [R, Kmax]
    pre_trace: torch.Tensor               # [R, Kmax]
    logits: torch.Tensor                  # [R, n_out] bypass accumulator
    sop_fwd: torch.Tensor                 # [R]
    sop_wu: torch.Tensor                  # [R]
    sop_wu_off: torch.Tensor              # [R]
    loss: torch.Tensor                    # [R]


class LayerOut(NamedTuple):
    st: LayerState
    w: Any                                # updated weight rep (training)
    delta: Optional[torch.Tensor]         # updated per-slot deltas (serving)
    ss_mean: torch.Tensor
    gate_opened: Optional[torch.Tensor]   # training telemetry; None serving
    gate_offered: Optional[torch.Tensor]
    open_: torch.Tensor                   # gate decision ([] or [S])
    pre_mag: Optional[torch.Tensor]       # [S, Kmax] |pre trace|, valid-masked
    post_mag: Optional[torch.Tensor]      # [S, N] |OSSL modulator|, valid-masked


def _layer_timestep(cfg, backend: Backend, geo: Geometry, learn: bool,
                    factors: bool, t_pc: int, t_wu: int, t_row,
                    valid: Optional[torch.Tensor], carry: LayerCarry,
                    xs: LayerSlice) -> Tuple[LayerCarry, LayerOut]:
    """SI + gated WU for ONE layer at ONE timestep — training and serving.

    Serving (``valid [S]`` bool, ``t_row [S]``): every quantity is per
    slot, the update goes into the per-slot deltas in place
    (``xs.delta`` is a layer of :func:`scan_chunk`'s own copy), and invalid
    slots are exact no-ops on state and telemetry; ``factors`` selects
    whether the per-slot DSST activity magnitudes are computed at all.
    Training is the ``valid=None`` case: ``t_row`` is the host timestep
    shared by every row, the gate decision is shared across the batch (IA/SS
    reduced over rows), and the update lands in the base weights with the
    batch-mean scale ``lr/R``. The gate and the scale stay on the device.
    """
    g = cfg.gating
    serving = valid is not None
    st, pre, pre_tr = xs.st, carry.pre_spikes, carry.pre_trace

    current = fwd_current(pre, xs.w, xs.delta)
    v, tr, s = lif(backend, cfg, st.v, st.tr, current)
    if serving:
        tr_pc = torch.where((t_row == t_pc)[:, None], tr, st.tr_pc)
    else:
        tr_pc = tr if t_row == t_pc else st.tr_pc

    # ---- OSSL three-factor WU, gated, concurrent with SI ----
    if serving:
        # row sums in an order fixed by N alone (serving_ossl_terms); the
        # spike counts below are sums of 0/1, exact in any order
        mod, cos_pc, cos_cc = serving_ossl_terms(tr, tr_pc, st.tr_cc, v, cfg)
        ia = pre.mean(-1) if geo.uniform else pre.sum(-1) / xs.fanin
        ss = cos_cc
    else:
        mod = ossl_modulator(tr, tr_pc, st.tr_cc, v, cfg)
        ia = pre.mean() if geo.uniform \
            else pre.sum() / (pre.shape[0] * xs.fanin)
        ss = _cos(tr, st.tr_cc).mean()
    open_, new_mean = gating_lib.gate_decide(xs.ss_mean, ia, ss, g)

    if serving:
        open_ = open_ & valid
        new_mean = torch.where(valid, new_mean, xs.ss_mean)
        wu_on = open_ & (t_row >= t_wu) & learn
        scale = torch.where(wu_on, cfg.lr, 0.0)
        if xs.delta.dim() == 5:
            # compact per-slot WU, in place: the outer product lands only
            # in kept blocks
            spec = cfg.spec(geo.fanins[0])
            delta_new = wu_ops.wu_outer_slots_update(
                xs.delta, pre_tr, mod, xs.w["idx"], scale, bk=spec.block,
                bo=spec.out_tile)
        else:
            # dense per-slot WU: the masked outer product, added in place
            # through one [S, Kmax, N] temporary (same rounding order)
            dw = scale[:, None, None] * pre_tr[:, :, None] * mod[:, None, :]
            delta_new = xs.delta.add_(dw.mul_(xs.w["mask_f"][None]))
        w_new, opened_new, offered_new = xs.w, None, None
        if factors:
            valf = valid.to(tr.dtype)[:, None]
            pre_mag = pre_tr.abs() * valf
            post_mag = mod.abs() * valf
        else:
            pre_mag = post_mag = None
        late = (t_row >= t_wu) & valid
    else:
        late = t_row >= t_wu                          # host bool
        wu_on = open_ if late and learn else torch.zeros_like(open_)
        scale = torch.where(wu_on, cfg.lr / pre.shape[0], 0.0)
        w_new = train_wu(cfg, xs.w, pre_tr, mod, scale)
        delta_new = None
        opened_new = xs.gate_opened + open_.to(torch.float32)
        offered_new = xs.gate_offered + 1.0
        pre_mag = post_mag = None   # training accumulates its own factors

    # ---- telemetry (energy model inputs), per row ----
    offered = xs.fanin * cfg.n_hidden * xs.density
    sop_fwd = carry.sop_fwd + pre.sum(-1) * cfg.n_hidden * xs.density
    sop_wu_off = carry.sop_wu_off + offered * late
    sop_wu = carry.sop_wu + offered * wu_on
    if not serving:
        cos_pc, cos_cc = _cos(tr, tr_pc), _cos(tr, st.tr_cc)
    loss = carry.loss + (-cos_pc + cfg.cc_weight * cos_cc) * late

    # invalid slots keep their exact previous state
    if serving:
        vv = valid[:, None]
        v = torch.where(vv, v, st.v)
        tr = torch.where(vv, tr, st.tr)
        tr_pc = torch.where(vv, tr_pc, st.tr_pc)
        s = s * valid.to(s.dtype)[:, None]

    # serving sums each slot's readout in an order that does not depend on
    # how many slots share the call (the slot-sharded fleet's guarantee)
    logits = carry.logits + (ordered_readout(tr, xs.readout) if serving
                             else tr @ xs.readout)
    new_carry = LayerCarry(
        pre_spikes=_pad_cols(s, geo.k_max),
        pre_trace=_pad_cols(tr, geo.k_max),
        logits=logits, sop_fwd=sop_fwd, sop_wu=sop_wu,
        sop_wu_off=sop_wu_off, loss=loss)
    out = LayerOut(st=LayerState(v, tr, tr_pc, st.tr_cc), w=w_new,
                   delta=delta_new, ss_mean=new_mean,
                   gate_opened=opened_new, gate_offered=offered_new,
                   open_=open_, pre_mag=pre_mag, post_mag=post_mag)
    return new_carry, out


def _layer_arrays(cfg, device):
    """Per-layer fan-in and spec density, ``[L]`` f32 on ``device``."""
    geo = geometry(cfg)
    return _layer_arrays_on(tuple(float(f) for f in geo.fanins),
                            tuple(cfg.spec(f).density for f in geo.fanins),
                            torch.device(device))


@functools.lru_cache(maxsize=None)
def _layer_arrays_on(fanins, densities, device):
    """Built once per geometry and device and then shared (nothing writes
    them), so a chunk step copies nothing for them; the one copy goes from
    pinned memory without waiting, so no step syncs with the card (a
    ``torch.tensor(..., device="cuda")`` of a host list waits for its
    copy)."""
    host = torch.tensor([fanins, densities], dtype=torch.float32)
    if device.type == "cuda":
        host = host.pin_memory()
    on = host.to(device, non_blocking=True)
    return on[0], on[1]


def _windows(cfg) -> Tuple[int, int]:
    return (int(cfg.t_steps * cfg.pc_snapshot_frac),
            int(cfg.t_steps * cfg.wu_start_frac))


def _stack_layers(per_layer: List[torch.Tensor]) -> torch.Tensor:
    """Per-layer ``[S, ...]`` tensors -> engine-layout ``[L, S, ...]``,
    stored slot-leading: a transposed view of one ``[S, L, ...]`` stack, so
    the public layout ``run_chunk`` returns is contiguous without a copy."""
    return torch.stack(per_layer, dim=1).transpose(0, 1)


# ---------------------------------------------------------------------------
# time loops: training (aligned sample) and serving (chunked streams)
# ---------------------------------------------------------------------------

def scan_sample(wrep, readout, layers: LayerState, x_tr, gate, events, cfg,
                backend: Backend, learn: bool):
    """T aligned timesteps over the layer stack (training datapath).

    ``wrep``: the stacked weight rep of :func:`prepare_weights`; ``layers``
    leaves ``[L, B, N]``; ``gate`` a ``GatingState`` of ``[L]`` leaves;
    ``events [T, B, n_in]``. Returns ``(wrep', layers', x_tr', gate',
    outs)`` with per-timestep ``outs`` stacked ``[T, ...]``. The timestep
    is a host int, so nothing here reads the device.
    """
    geo = geometry(cfg)
    t_pc, t_wu = _windows(cfg)
    fan, dens = _layer_arrays(cfg, events.device)
    n_layers = cfg.n_layers
    B, dev = events.shape[1], events.device
    events = events.contiguous()     # each [B, n_in] step feeds the kernels
    st = [LayerState(*(leaf[l] for leaf in layers)) for l in range(n_layers)]
    wl = [{k: v[l] for k, v in wrep.items()} for l in range(n_layers)]
    ssm, opened, offered = ([leaf[l] for l in range(n_layers)] for leaf in gate)
    keys = ("logits", "sop_fwd", "sop_wu", "sop_wu_off", "gate", "loss")
    outs: Dict[str, list] = {k: [] for k in keys}

    for t in range(events.shape[0]):
        x = events[t]
        x_tr = cfg.beta * x_tr + x
        zeros = torch.zeros(B, device=dev)
        carry = LayerCarry(
            pre_spikes=_pad_cols(x, geo.k_max),
            pre_trace=_pad_cols(x_tr, geo.k_max),
            logits=torch.zeros((B, readout.shape[-1]), device=dev),
            sop_fwd=zeros, sop_wu=zeros, sop_wu_off=zeros, loss=zeros)
        opens = []
        for l in range(n_layers):
            xs = LayerSlice(w=wl[l], readout=readout[l], st=st[l],
                            ss_mean=ssm[l], delta=None, fanin=fan[l],
                            density=dens[l], gate_opened=opened[l],
                            gate_offered=offered[l])
            carry, out = _layer_timestep(cfg, backend, geo, learn, False,
                                         t_pc, t_wu, t, None, carry, xs)
            st[l], wl[l], ssm[l] = out.st, out.w, out.ss_mean
            opened[l], offered[l] = out.gate_opened, out.gate_offered
            opens.append(out.open_)
        outs["logits"].append(carry.logits)
        outs["sop_fwd"].append(carry.sop_fwd.sum())
        outs["sop_wu"].append(carry.sop_wu.sum())
        outs["sop_wu_off"].append(carry.sop_wu_off.sum())
        outs["gate"].append(torch.stack(opens).to(torch.float32).sum()
                            / n_layers)
        outs["loss"].append(carry.loss.mean() / n_layers)

    layers_out = LayerState(*(torch.stack([s[i] for s in st])
                              for i in range(4)))
    wrep_out = {k: torch.stack([w[k] for w in wl]) for k in wrep}
    gate_out = gating_lib.GatingState(torch.stack(ssm), torch.stack(opened),
                                      torch.stack(offered))
    return (wrep_out, layers_out, x_tr, gate_out,
            {k: torch.stack(v) for k, v in outs.items()})



def scan_chunk(wrep, readout, deltas, layers: LayerState, x_tr, ss_mean,
               t_win, samp, events, valid, cfg, backend: Backend,
               learn: bool, want_factors: bool = True):
    """Up to C timesteps of S independent streams (serving datapath).

    Engine layout: layer axis leading on ``layers``/``deltas``/``ss_mean``
    (``[L, S, ...]``); ``run_chunk`` transposes at its boundary. Returns
    ``(carry, outs)`` with ``carry = (layers, x_tr, ss_mean, t_win, samp,
    deltas[, acc_pre, acc_post])`` and per-timestep ``outs`` stacked
    ``[C, ...]``. With ``want_factors`` the per-slot DSST activity factors
    (``acc_pre [L, S, Kmax]``, ``acc_post [L, S, N]``) accumulate over the
    chunk; without, they are never computed. ``deltas`` is not written: the
    chunk copies it once, updates the copy in place every layer-timestep and
    returns it.
    """
    geo = geometry(cfg)
    t_pc, t_wu = _windows(cfg)
    fan, dens = _layer_arrays(cfg, events.device)
    n_layers = cfg.n_layers
    S = events.shape[1]
    dev = events.device
    # per-layer state, contiguous [S, N] (the LIF kernel takes dense rows)
    st = [LayerState(*(leaf[l].contiguous() for leaf in layers))
          for l in range(n_layers)]
    # the chunk's own copy of the deltas, slot-leading like the public layout
    own = deltas.transpose(0, 1).clone(
        memory_format=torch.contiguous_format).transpose(0, 1)
    ssm = [ss_mean[l] for l in range(n_layers)]
    wl = [{k: v[l] for k, v in wrep.items()} for l in range(n_layers)]
    acc_pre = [torch.zeros((S, geo.k_max), device=dev)
               for _ in range(n_layers)] if want_factors else []
    acc_post = [torch.zeros((S, cfg.n_hidden), device=dev)
                for _ in range(n_layers)] if want_factors else []
    t_w = t_win
    keys = ("logits", "at_end", "sop_fwd", "sop_wu", "sop_wu_off", "opened",
            "offered", "loss", "steps")
    outs: Dict[str, list] = {k: [] for k in keys}

    for c in range(events.shape[0]):
        x, val = events[c], valid[c]
        x = x * val.to(x.dtype)[:, None]
        x_tr = torch.where(val[:, None], cfg.beta * x_tr + x, x_tr)
        zeros = torch.zeros(S, device=dev)
        carry = LayerCarry(
            pre_spikes=_pad_cols(x, geo.k_max),
            pre_trace=_pad_cols(x_tr, geo.k_max),
            logits=torch.zeros((S, readout.shape[-1]), device=dev),
            sop_fwd=zeros, sop_wu=zeros, sop_wu_off=zeros, loss=zeros)
        opens = []
        for l in range(n_layers):
            xs = LayerSlice(w=wl[l], readout=readout[l], st=st[l],
                            ss_mean=ssm[l], delta=own[l], fanin=fan[l],
                            density=dens[l])
            carry, out = _layer_timestep(cfg, backend, geo, learn,
                                         want_factors, t_pc, t_wu, t_w, val,
                                         carry, xs)
            st[l], ssm[l] = out.st, out.ss_mean
            opens.append(out.open_)
            if want_factors:
                acc_pre[l] = acc_pre[l] + out.pre_mag
                acc_post[l] = acc_post[l] + out.post_mag

        # ---- per-slot window roll: final trace becomes the CC negative ----
        at_end = val & (t_w == cfg.t_steps - 1)
        endf = at_end[:, None]
        st = [LayerState(v=torch.where(endf, 0.0, s.v),
                         tr=torch.where(endf, 0.0, s.tr),
                         tr_pc=torch.where(endf, 0.0, s.tr_pc),
                         tr_cc=torch.where(endf, s.tr, s.tr_cc)) for s in st]
        x_tr = torch.where(endf, 0.0, x_tr)
        samp = samp + at_end.to(torch.int32)
        t_w = torch.where(val, (t_w + 1) % cfg.t_steps, t_w)

        valf = val.to(torch.float32)
        outs["logits"].append(carry.logits)
        outs["at_end"].append(at_end)
        outs["sop_fwd"].append(carry.sop_fwd)
        outs["sop_wu"].append(carry.sop_wu)
        outs["sop_wu_off"].append(carry.sop_wu_off)
        outs["opened"].append(torch.stack(opens, dim=1).to(torch.float32))
        outs["offered"].append(valf[:, None].expand(S, n_layers))
        outs["loss"].append(carry.loss / n_layers)
        outs["steps"].append(valf)

    layers_out = LayerState(*(_stack_layers([s[i] for s in st])
                              for i in range(4)))
    carry = (layers_out, x_tr, _stack_layers(ssm), t_w, samp, own)
    if want_factors:
        carry = carry + (_stack_layers(acc_pre), _stack_layers(acc_post))
    outs = {k: torch.stack(v) for k, v in outs.items()}
    _assert_slot_separable(carry, outs, events.shape[0], S, cfg, want_factors)
    return carry, outs


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis by a shape-fixed binary halving tree:
    ``(x[:n//2] + x[n//2:2*(n//2)])`` recursively, odd tails riding along
    one level. Every add is elementwise, so the association order is a
    function of ``n`` alone and each other index sums the same way whatever
    the other extents (a reduction kernel's order can depend on them)."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        paired = x[:half] + x[half:2 * half]
        x = paired if x.shape[0] % 2 == 0 else \
            torch.cat([paired, x[2 * half:]], dim=0)
    return x[0]


def ordered_slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Reduce the leading slot axis by :func:`ordered_sum`: the
    reference's association order, a function of ``S`` alone."""
    return ordered_sum(x)


def ordered_readout(tr: torch.Tensor, readout: torch.Tensor) -> torch.Tensor:
    """``tr @ readout`` (``[S, N] x [N, n_out]``) with each slot's sums in
    an order fixed by ``N`` alone: the products ``[N, S, n_out]`` summed
    over ``N`` by :func:`ordered_sum`. A GEMM library picks its algorithm by
    the row count, so a slot's logits could round otherwise with another
    number of slots in the call (cuBLAS does, 1024 rows against 256 on the
    H100), and a slot-sharded fleet would then drift from the 1-device
    one."""
    return ordered_sum(tr.t()[:, :, None] * readout[:, None, :])


def _assert_slot_separable(carry, outs, C: int, S: int, cfg,
                           want_factors: bool) -> None:
    """The chunk step's zero-collective contract: every per-stream quantity
    keeps its slot axis through the chunk. A reduction over slots, which
    would break a slot-sharded fleet, shows up here as a dropped ``S``
    dimension, on every chunk (shape checks only: no op, no sync). Thin
    wrapper over the shared checker (``analysis.dispatch_contracts``),
    imported lazily so the engine keeps no static analysis dependency."""
    from ..analysis.dispatch_contracts import \
        assert_chunk_carry_slot_separable
    assert_chunk_carry_slot_separable(carry, outs, C=C, S=S,
                                      n_layers=cfg.n_layers,
                                      want_factors=want_factors)
