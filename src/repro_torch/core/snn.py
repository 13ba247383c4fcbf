"""ElfCore's spiking network: config, parameters, the training sample step
and the serving chunk step (``repro.core.snn``).

:func:`run_sample` is the paper's learning loop for one aligned batch: the
engine's T timesteps with OSSL and activity-gated WU into the base weights,
the SL readout delta rule (the only place labels enter), the DSST factor
write-back and, every ``period`` samples, one prune/regrow epoch
(``topology.topology_epoch``), then the CC-slot roll. The sample counter is
a host int, so the epoch is decided on the host without reading the device.

Parameter layout (stacked; one leaf per role, leading layer axis)::

    params = {
      "hidden": {"w":    f32[L, Kmax, n_hidden],   # masked base weights
                 "mask": bool[L, KBmax, J]},       # N:M unit masks
      "readout": f32[L, n_hidden, n_out],          # bypass readouts
    }

:func:`serving_params` turns it into the mask-free serving rep
``{"wc" [L,J,T,bk,bo], "idx" [L,J,T], "readout"}`` that :func:`run_chunk`
consumes. Stream state and deltas are slot-leading (``[S, L, ...]``) so
lane surgery slices the leading axis; the engine works layer-leading.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from . import engine
from . import gating as gating_lib
from . import topology as topology_lib
from .dsst import DSSTAccumulator, DSSTConfig
from .engine import LayerState, ossl_modulator
from .sparsity import NMSpec, apply_mask, paper_spec_4groups, random_unit_mask


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    n_in: int = 512
    n_hidden: int = 512
    n_layers: int = 2          # hidden layers (bypass keeps output wired)
    n_out: int = 16
    t_steps: int = 50          # timesteps per sample
    # neuron dynamics
    alpha: float = 0.9         # membrane decay
    beta: float = 0.85         # trace decay
    theta: float = 1.0         # firing threshold (soft reset)
    surrogate_width: float = 1.0
    # learning
    lr: float = 0.02           # hidden OSSL rate
    lr_out: float = 0.1        # SL readout rate
    cc_weight: float = 1.0     # contrastive term weight
    pc_snapshot_frac: float = 0.5   # TS (fraction of T) at which tr_pc is latched
    wu_start_frac: float = 0.6      # WU runs on late TSs (traces must be formed)
    # sparsity
    sparsity: float = 0.8
    dense: bool = False        # dense baseline (Fig. 5/7 comparisons)
    dsst: DSSTConfig = dataclasses.field(default_factory=lambda: DSSTConfig(period=40, prune_frac=0.25))
    dsst_enabled: bool = True  # False = static sparse training baseline
    # gating
    gating: gating_lib.GatingConfig = dataclasses.field(default_factory=gating_lib.GatingConfig)
    # compute backend of the timestep engine (core/engine.py): "ref" (plain
    # torch LIF) or "kernels" (the fused LIF kernel on CUDA tensors)
    backend: str = "ref"

    def spec(self, fan_in: int) -> NMSpec:
        if self.dense:
            return NMSpec(n=4, m=4)  # degenerate: keep everything, 4 "groups"
        return paper_spec_4groups(fan_in, self.sparsity)

    @property
    def layer_fanins(self):
        return [self.n_in] + [self.n_hidden] * (self.n_layers - 1)


# ---------------------------------------------------------------------------
# parameters and state
# ---------------------------------------------------------------------------

def init_params(seed: Union[int, torch.Generator], cfg: SNNConfig,
                device="cuda") -> Dict[str, Any]:
    """Random weights at target sparsity from step 0 (sparse-to-sparse).

    Drawn on the CPU from ``seed`` (an int or a ``torch.Generator``), then
    moved to ``device``, so a seed gives the same weights on every device.
    Torch and JAX draw different numbers from one seed: to compute on the
    reference's weights, convert them with ``convert.params_from_numpy``.
    """
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    geo = engine.geometry(cfg)
    ws, masks = [], []
    for fan_in in cfg.layer_fanins:
        spec = cfg.spec(fan_in)
        w = torch.randn((fan_in, cfg.n_hidden), generator=gen) \
            * (1.5 / math.sqrt(fan_in * spec.density))
        mask = random_unit_mask(gen, spec, fan_in, cfg.n_hidden)
        ws.append(engine._pad_rows(apply_mask(w, mask, spec), geo.k_max))
        masks.append(engine._pad_rows(mask, geo.k_max))
    readout = torch.stack([
        torch.randn((cfg.n_hidden, cfg.n_out), generator=gen) * 0.05
        for _ in range(cfg.n_layers)])
    return {"hidden": {"w": torch.stack(ws).to(device),
                       "mask": torch.stack(masks).to(device)},
            "readout": readout.to(device)}


class NetState(NamedTuple):
    layers: LayerState                    # leaves [L, B, N]
    x_tr: torch.Tensor                    # [B, n_in] input (pre-synaptic) trace
    gate: gating_lib.GatingState
    acc: Tuple[DSSTAccumulator, ...]      # one per layer
    sample_idx: int                       # samples seen (host int)


def init_state(cfg: SNNConfig, batch: int, device="cuda") -> NetState:
    layers = LayerState(*(torch.zeros((cfg.n_layers, batch, cfg.n_hidden),
                                      device=device) for _ in range(4)))
    accs = []
    for fan_in in cfg.layer_fanins:
        kb, j = cfg.spec(fan_in).unit_counts(fan_in, cfg.n_hidden)
        accs.append(DSSTAccumulator.init(kb, j, device=device))
    return NetState(layers=layers,
                    x_tr=torch.zeros((batch, cfg.n_in), device=device),
                    gate=gating_lib.init_state(cfg.n_layers, cfg.gating,
                                               device=device),
                    acc=tuple(accs), sample_idx=0)


class SampleMetrics(NamedTuple):
    logits: torch.Tensor          # [B, n_out] (final-TS readout)
    sop_forward: torch.Tensor     # synaptic ops on the forward path
    sop_wu: torch.Tensor          # weight-update MACs actually performed
    sop_wu_offered: torch.Tensor  # WU MACs before gating (for skip-rate)
    gate_open_frac: torch.Tensor  # fraction of (layer, TS) gates that fired
    local_loss: torch.Tensor      # mean OSSL loss over late TSs


def run_sample(params: Dict[str, Any], state: NetState, events: torch.Tensor,
               label: Optional[torch.Tensor], cfg: SNNConfig, *,
               learn: bool = True
               ) -> Tuple[Dict[str, Any], NetState, SampleMetrics]:
    """One sample (``events [T, B, n_in]`` f32 spikes, ``label [B]`` int or
    None) through the network. Returns fresh ``(params', state',
    metrics)``; nothing passed in is written."""
    T, B, _ = events.shape
    backend = engine.make_backend(cfg)
    t_wu = int(cfg.t_steps * cfg.wu_start_frac)
    masks = params["hidden"]["mask"]
    wrep = engine.prepare_weights(params["hidden"]["w"], masks, cfg, backend)

    wrep, layers, x_tr, gate_st, outs = engine.scan_sample(
        wrep, params["readout"], state.layers, state.x_tr, state.gate,
        events, cfg, backend, learn)
    w_stacked = engine.finalize_weights(wrep, cfg, backend)
    logits = outs["logits"][-1]

    # ---- SL delta rule on the output layer (labels only used here) ----
    pr = params["readout"]
    if label is not None and learn:
        err = (torch.nn.functional.one_hot(label.long(), cfg.n_out)
               .to(logits.dtype) - torch.softmax(logits, -1))     # [B, n_out]
        pr = pr + (cfg.lr_out / B) * torch.einsum("lbn,bo->lno", layers.tr,
                                                  err)

    # ---- DSST statistics write-back + (maybe) stacked connectivity epoch ----
    pre_traces = [x_tr] + [layers.tr[l] for l in range(cfg.n_layers - 1)]
    new_acc = []
    for l, fan_in in enumerate(cfg.layer_fanins):
        kb, _ = cfg.spec(fan_in).unit_counts(fan_in, cfg.n_hidden)
        pre_mag = pre_traces[l].abs().mean(0)                         # [K]
        mod = ossl_modulator(layers.tr[l], layers.tr_pc[l], layers.tr_cc[l],
                             layers.v[l], cfg)
        post_mag = mod.abs().mean(0)                                  # [N]
        pre_units = pre_mag.reshape(kb, -1).sum(-1)
        new_acc.append(state.acc[l].update(pre_units, post_mag))

    new_params = {"hidden": {"w": w_stacked, "mask": masks}, "readout": pr}
    new_acc = tuple(new_acc)
    if (cfg.dsst_enabled and not cfg.dense and learn
            and cfg.dsst.is_update_step(state.sample_idx)):
        pre_stacked = torch.stack([engine._pad_rows(a.pre, masks.shape[1])
                                   for a in new_acc])                 # [L, KBmax]
        post_stacked = torch.stack([a.post for a in new_acc])         # [L, J]
        new_params, _ = topology_lib.topology_epoch(
            new_params, pre_stacked, post_stacked, cfg, step=state.sample_idx)
        new_acc = tuple(DSSTAccumulator.init(a.pre.shape[0], a.post.shape[0],
                                             device=a.pre.device)
                        for a in new_acc)

    # ---- roll the CC slot: final trace of this sample becomes the negative ----
    final_layers = LayerState(
        v=torch.zeros_like(layers.v), tr=torch.zeros_like(layers.tr),
        tr_pc=torch.zeros_like(layers.tr_pc), tr_cc=layers.tr)
    new_state = NetState(layers=final_layers, x_tr=torch.zeros_like(x_tr),
                         gate=gate_st, acc=new_acc,
                         sample_idx=state.sample_idx + 1)
    metrics = SampleMetrics(
        logits=logits,
        sop_forward=outs["sop_fwd"].sum(),
        sop_wu=outs["sop_wu"].sum(),
        sop_wu_offered=outs["sop_wu_off"].sum(),
        gate_open_frac=outs["gate"].mean(),
        local_loss=outs["loss"].sum() / max(1, T - t_wu))
    return new_params, new_state, metrics


class StreamState(NamedTuple):
    layers: LayerState               # leaves [S, L, N] (slot axis leads)
    x_tr: torch.Tensor               # [S, n_in]
    ss_mean: torch.Tensor            # [S, L] per-stream adaptive SS threshold
    t_in_window: torch.Tensor        # [S] int32, position inside the T-window
    sample_idx: torch.Tensor         # [S] int32, windows completed


def init_stream_state(cfg: SNNConfig, n_slots: int,
                      device="cuda") -> StreamState:
    layers = LayerState(*(torch.zeros((n_slots, cfg.n_layers, cfg.n_hidden),
                                      device=device) for _ in range(4)))
    return StreamState(
        layers=layers,
        x_tr=torch.zeros((n_slots, cfg.n_in), device=device),
        ss_mean=torch.full((n_slots, cfg.n_layers), cfg.gating.ss_init,
                           dtype=torch.float32, device=device),
        t_in_window=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        sample_idx=torch.zeros((n_slots,), dtype=torch.int32, device=device),
    )


def init_stream_deltas(cfg: SNNConfig, n_slots: int, device="cuda",
                       compact: Optional[bool] = None) -> torch.Tensor:
    """Per-stream weight deltas over the frozen shared base, slot axis
    leading. ``compact=None`` picks the compact N:M tensor
    ``[S, L, J, T, bk, bo]`` (storage scales with density, not ``K·N``)
    whenever the layer geometry is uniform, else the dense
    ``[S, L, Kmax, N]`` layout; ``compact=False`` forces the dense one (the
    A/B baseline)."""
    geo = engine.geometry(cfg)
    if compact is None:
        compact = geo.uniform
    if not compact:
        return torch.zeros((n_slots, cfg.n_layers, geo.k_max, cfg.n_hidden),
                           device=device)
    if not geo.uniform:
        raise ValueError(
            "compact stream deltas require uniform layer fan-in "
            f"(got {geo.fanins}); pass compact=False")
    spec = cfg.spec(geo.fanins[0])
    return torch.zeros((n_slots, cfg.n_layers, cfg.n_hidden // spec.out_tile,
                        engine.compact_kept(cfg), spec.block, spec.out_tile),
                       device=device)


def serving_params(params: Dict[str, Any], cfg: SNNConfig,
                   compact: bool = True) -> Dict[str, Any]:
    """Dense training params -> the rep :func:`run_chunk` consumes. Compact
    (the default): the mask-free ``{"wc" [L,J,T,bk,bo], "idx" [L,J,T]
    int32, "readout" [L,N,n_out]}``. ``compact=False`` (for dense deltas):
    :func:`engine.prepare_weights` with its dense mask ``mask_f
    [L, Kmax, N]``, plus the readout."""
    w, mask = params["hidden"]["w"], params["hidden"]["mask"]
    if compact:
        wrep = engine.compact_weights(w, mask, cfg)
    else:
        wrep = engine.prepare_weights(w, mask, cfg, engine.make_backend(cfg),
                                      include_mask=True)
    return {**wrep, "readout": params["readout"]}


class ChunkMetrics(NamedTuple):
    """Per-chunk serving metrics; every per-stream leaf keeps its slot axis.
    The DSST factor fields are None when the chunk ran without factors."""
    logits: torch.Tensor          # [C, S, n_out] per-timestep readout
    window_end: torch.Tensor      # [C, S] bool: logits here close a T-window
    sop_forward: torch.Tensor     # [S]
    sop_wu: torch.Tensor          # [S]
    sop_wu_offered: torch.Tensor  # [S]
    gate_opened: torch.Tensor     # [S, L]
    gate_offered: torch.Tensor    # [S, L]
    local_loss: torch.Tensor      # [S] summed OSSL loss over late TSs
    steps: torch.Tensor           # [S] valid timesteps processed
    pre_mag: Optional[torch.Tensor]   # [S, L, Kmax] summed |pre trace|
    post_mag: Optional[torch.Tensor]  # [S, L, N] summed |OSSL modulator|


def _chunk_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading chunk axis as a left fold, one elementwise add a
    timestep: every slot's order is then fixed, so a slot's sum does not
    depend on how many slots share the call (a reduction kernel's can: the
    CPU's vectorised outer sum takes another order at other widths), and a
    slot-sharded fleet sums as the 1-device one does."""
    acc = x[0]
    for t in range(1, x.shape[0]):
        acc = acc + x[t]
    return acc


def _swap(t: torch.Tensor) -> torch.Tensor:
    """Slot-leading public layout <-> layer-leading engine layout."""
    return t.transpose(0, 1)


def run_chunk(params: Dict[str, Any], deltas: torch.Tensor,
              state: StreamState, events: torch.Tensor, valid: torch.Tensor,
              cfg: SNNConfig, *, learn: bool = True,
              want_factors: bool = True
              ) -> Tuple[torch.Tensor, StreamState, ChunkMetrics]:
    """Advance S independent streams by up to C timesteps each.

    Args:
      params:  a rep from :func:`serving_params` or the dense training
        layout (turned into the rep the deltas need here, on every call).
      deltas:  per-stream adaptation, slot-leading: compact
        ``[S, L, J, T, bk, bo]`` or dense ``[S, L, Kmax, N]`` (the layout
        is read from the rank). Dense deltas need a rep with ``mask_f``.
      state:   carried :class:`StreamState` (slot-leading leaves).
      events:  ``[C, S, n_in]`` f32 binary spikes.
      valid:   ``[C, S]`` bool — ragged chunks / idle slots are exact no-ops.
      learn:   gate the per-stream OSSL delta updates on/off.
      want_factors: accumulate the DSST ``pre_mag``/``post_mag`` factors;
        False leaves them out of the loop and returns them as None.

    Returns fresh ``(deltas', state', metrics)`` of the input shapes and
    dtypes; nothing passed in is written.
    """
    backend = engine.make_backend(cfg)
    compact = deltas.dim() == 6
    if events.dtype != torch.float32:
        raise TypeError(f"events must be float32, got {events.dtype}")
    if "hidden" in params:
        wrep = serving_params(params, cfg, compact=compact)
    else:
        wrep = params
        if not compact and "mask_f" not in wrep:
            raise ValueError("the mask-free serving rep carries no dense "
                             "mask, so dense [S, L, Kmax, N] deltas cannot "
                             "be applied; use serving_params(..., "
                             "compact=False) or compact deltas")
    wrep = {k: v for k, v in wrep.items() if k != "readout"}

    (layers, x_tr, ss_mean, t_win, samp, dls, *accs), outs = engine.scan_chunk(
        wrep, params["readout"], _swap(deltas),
        LayerState(*(_swap(t) for t in state.layers)), state.x_tr,
        _swap(state.ss_mean), state.t_in_window, state.sample_idx, events,
        valid, cfg, backend, learn, want_factors)

    new_state = StreamState(layers=LayerState(*(_swap(t) for t in layers)),
                            x_tr=x_tr, ss_mean=_swap(ss_mean),
                            t_in_window=t_win, sample_idx=samp)
    metrics = ChunkMetrics(
        logits=outs["logits"],
        window_end=outs["at_end"],
        sop_forward=_chunk_sum(outs["sop_fwd"]),
        sop_wu=_chunk_sum(outs["sop_wu"]),
        sop_wu_offered=_chunk_sum(outs["sop_wu_off"]),
        gate_opened=_chunk_sum(outs["opened"]),
        gate_offered=_chunk_sum(outs["offered"]),
        local_loss=_chunk_sum(outs["loss"]),
        steps=_chunk_sum(outs["steps"]),
        pre_mag=_swap(accs[0]) if accs else None,
        post_mag=_swap(accs[1]) if accs else None,
    )
    S = events.shape[1]
    if metrics.logits.shape[1] != S or metrics.gate_opened.shape != (
            S, cfg.n_layers):
        raise AssertionError("chunk metrics lost their slot axis")
    return _swap(dls), new_state, metrics


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def make_train_fn(cfg: SNNConfig):
    """``step(params, state, events, label) -> (params', state', metrics)``:
    one learning sample, no autograd."""
    @torch.no_grad()
    def step(params, state, events, label):
        return run_sample(params, state, events, label, cfg, learn=True)
    return step


def make_eval_fn(cfg: SNNConfig):
    """``step(params, state, events) -> (state', metrics)``: inference only,
    the weights and the readout stay as they are."""
    @torch.no_grad()
    def step(params, state, events):
        _, state, m = run_sample(params, state, events, None, cfg,
                                 learn=False)
        return state, m
    return step


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()
