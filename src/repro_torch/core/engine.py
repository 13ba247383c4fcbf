"""The per-timestep layer engine, serving half (``repro.core.engine``).

:func:`_layer_timestep` is the one layer body: forward current, fused LIF
step, OSSL modulator, per-slot IA/SS gate, per-slot compact weight update
and telemetry, for ONE layer at ONE timestep. :func:`scan_chunk` drives it
over a chunk of timesteps and the layer stack; JAX's two ``lax.scan``\\ s
become Python loops over C and L. The training half (aligned batch, shared
gate, update into the base through ``wu_outer``) comes with the training
path.

Backend seam: ``SNNConfig.backend`` is ``"ref"`` (plain torch LIF) or
``"kernels"`` (the fused LIF kernel on CUDA tensors; its plain version on
CPU tensors). The compact forward current goes through ``nm_spmm`` under
either backend, so a CUDA tensor always reaches the hand-written kernel,
as the reference always reaches Pallas on a TPU.

The weight rep is the mask-free compact N:M layout only: values
``wc [L, J, T, bk, bo]`` plus kept block ids ``idx [L, J, T]``, with
compact per-slot deltas ``[S, J, T, bk, bo]`` per layer. Every step returns
fresh tensors and never writes into its inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..kernels.lif import ops as lif_ops
from ..kernels.lif.ref import lif_step
from ..kernels.nm_spmm import ops as nm_ops
from ..kernels.wu_outer import ops as wu_ops
from . import gating as gating_lib

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
    use_kernels: bool     # route the LIF step through kernels/lif


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


def fwd_current(pre, w_l, delta_l):
    """Forward synaptic current for one layer: ``pre @ w`` on the compact
    rep through ``nm_spmm``, plus the per-slot compact deltas through
    ``nm_spmm_deltas`` on the same kept-block ids."""
    cur = nm_ops.nm_spmm_batched(pre, w_l["wc"], w_l["idx"])
    if delta_l is not None:
        cur = cur + nm_ops.nm_spmm_deltas(pre, delta_l, w_l["idx"])
    return cur


def lif(backend: Backend, cfg, v, tr, current):
    """One fused LIF step through the backend seam. Returns (v', tr', s)."""
    if backend.use_kernels:
        return lif_ops.lif_step(v, tr, current, alpha=cfg.alpha,
                                beta=cfg.beta, theta=cfg.theta)
    return lif_step(v, tr, current, alpha=cfg.alpha, beta=cfg.beta,
                    theta=cfg.theta)


# ---------------------------------------------------------------------------
# THE per-timestep layer body, serving mode
# ---------------------------------------------------------------------------

class LayerSlice(NamedTuple):
    """One layer's inputs to the layer body."""
    w: Any                                # {"wc" [J,T,bk,bo], "idx" [J,T]}
    readout: torch.Tensor                 # [N, n_out] bypass readout
    st: LayerState                        # leaves [S, N]
    ss_mean: torch.Tensor                 # [S]
    delta: torch.Tensor                   # [S, J, T, bk, bo] compact
    fanin: torch.Tensor                   # [] f32 — true fan-in
    density: torch.Tensor                 # [] f32 — spec density


class LayerCarry(NamedTuple):
    """Flows down the layer stack within one timestep."""
    pre_spikes: torch.Tensor              # [S, Kmax]
    pre_trace: torch.Tensor               # [S, Kmax]
    logits: torch.Tensor                  # [S, n_out] bypass accumulator
    sop_fwd: torch.Tensor                 # [S]
    sop_wu: torch.Tensor                  # [S]
    sop_wu_off: torch.Tensor              # [S]
    loss: torch.Tensor                    # [S]


class LayerOut(NamedTuple):
    st: LayerState
    delta: torch.Tensor
    ss_mean: torch.Tensor
    open_: torch.Tensor                   # [S] gate decision
    pre_mag: Optional[torch.Tensor]       # [S, Kmax] |pre trace|, valid-masked
    post_mag: Optional[torch.Tensor]      # [S, N] |OSSL modulator|, valid-masked


def _layer_timestep(cfg, backend: Backend, geo: Geometry, learn: bool,
                    factors: bool, t_pc: int, t_wu: int, t_row: torch.Tensor,
                    valid: torch.Tensor, carry: LayerCarry, xs: LayerSlice
                    ) -> Tuple[LayerCarry, LayerOut]:
    """SI + gated WU for ONE layer at ONE timestep, per slot.

    Every quantity is per slot; invalid slots (``valid`` False) are exact
    no-ops on state and telemetry. ``factors`` selects whether the per-slot
    DSST activity magnitudes are computed at all.
    """
    g = cfg.gating
    st, pre, pre_tr = xs.st, carry.pre_spikes, carry.pre_trace

    current = fwd_current(pre, xs.w, xs.delta)
    v, tr, s = lif(backend, cfg, st.v, st.tr, current)
    tr_pc = torch.where((t_row == t_pc)[:, None], tr, st.tr_pc)

    # ---- OSSL three-factor WU, gated, concurrent with SI ----
    mod = ossl_modulator(tr, tr_pc, st.tr_cc, v, cfg)
    ia = pre.mean(-1) if geo.uniform else pre.sum(-1) / xs.fanin
    ss = _cos(tr, st.tr_cc)
    open_, new_mean = gating_lib.gate_decide(xs.ss_mean, ia, ss, g)
    open_ = open_ & valid
    new_mean = torch.where(valid, new_mean, xs.ss_mean)
    wu_on = open_ & (t_row >= t_wu) & learn

    # compact per-slot WU: the outer product lands only in kept blocks
    spec = cfg.spec(geo.fanins[0])
    scale = torch.where(wu_on, cfg.lr, 0.0)
    delta_new = xs.delta + wu_ops.wu_outer_slots(
        pre_tr, mod, xs.w["idx"], scale, bk=spec.block, bo=spec.out_tile)
    if factors:
        valf = valid.to(tr.dtype)[:, None]
        pre_mag = pre_tr.abs() * valf
        post_mag = mod.abs() * valf
    else:
        pre_mag = post_mag = None

    # ---- telemetry (energy model inputs), per slot ----
    late = (t_row >= t_wu) & valid
    offered = xs.fanin * cfg.n_hidden * xs.density
    sop_fwd = carry.sop_fwd + pre.sum(-1) * cfg.n_hidden * xs.density
    sop_wu_off = carry.sop_wu_off + offered * late
    sop_wu = carry.sop_wu + offered * wu_on
    loss = carry.loss + \
        (-_cos(tr, tr_pc) + cfg.cc_weight * _cos(tr, st.tr_cc)) * late

    # invalid slots keep their exact previous state
    vv = valid[:, None]
    v = torch.where(vv, v, st.v)
    tr = torch.where(vv, tr, st.tr)
    tr_pc = torch.where(vv, tr_pc, st.tr_pc)
    s = s * valid.to(s.dtype)[:, None]

    logits = carry.logits + tr @ xs.readout
    new_carry = LayerCarry(
        pre_spikes=_pad_cols(s, geo.k_max),
        pre_trace=_pad_cols(tr, geo.k_max),
        logits=logits, sop_fwd=sop_fwd, sop_wu=sop_wu,
        sop_wu_off=sop_wu_off, loss=loss)
    out = LayerOut(st=LayerState(v, tr, tr_pc, st.tr_cc), delta=delta_new,
                   ss_mean=new_mean, open_=open_, pre_mag=pre_mag,
                   post_mag=post_mag)
    return new_carry, out


def _layer_arrays(cfg, device):
    geo = geometry(cfg)
    fan = torch.tensor([float(f) for f in geo.fanins], dtype=torch.float32,
                       device=device)
    dens = torch.tensor([cfg.spec(f).density for f in geo.fanins],
                        dtype=torch.float32, device=device)
    return fan, dens


def _windows(cfg) -> Tuple[int, int]:
    return (int(cfg.t_steps * cfg.pc_snapshot_frac),
            int(cfg.t_steps * cfg.wu_start_frac))


def _stack_layers(per_layer: List[torch.Tensor]) -> torch.Tensor:
    """Per-layer ``[S, ...]`` tensors -> engine-layout ``[L, S, ...]``,
    stored slot-leading: a transposed view of one ``[S, L, ...]`` stack, so
    the public layout ``run_chunk`` returns is contiguous without a copy."""
    return torch.stack(per_layer, dim=1).transpose(0, 1)


# ---------------------------------------------------------------------------
# time loop: serving (chunked streams)
# ---------------------------------------------------------------------------

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
    chunk; without, they are never computed.
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
    dls = [deltas[l] for l in range(n_layers)]
    ssm = [ss_mean[l] for l in range(n_layers)]
    wl = [{"wc": wrep["wc"][l], "idx": wrep["idx"][l]}
          for l in range(n_layers)]
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
                            ss_mean=ssm[l], delta=dls[l], fanin=fan[l],
                            density=dens[l])
            carry, out = _layer_timestep(cfg, backend, geo, learn,
                                         want_factors, t_pc, t_wu, t_w, val,
                                         carry, xs)
            st[l], dls[l], ssm[l] = out.st, out.delta, out.ss_mean
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
    carry = (layers_out, x_tr, _stack_layers(ssm), t_w, samp,
             _stack_layers(dls))
    if want_factors:
        carry = carry + (_stack_layers(acc_pre), _stack_layers(acc_post))
    return carry, {k: torch.stack(v) for k, v in outs.items()}


def ordered_slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Reduce the leading slot axis with a shape-fixed binary halving tree:
    ``(x[:S//2] + x[S//2:2*(S//2)])`` recursively, odd tails riding along
    one level — the reference's association order, a function of ``S``
    alone."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        paired = x[:half] + x[half:2 * half]
        x = paired if x.shape[0] % 2 == 0 else \
            torch.cat([paired, x[2 * half:]], dim=0)
    return x[0]
