"""Mamba2 (``repro.models.mamba2``): the SSD block (state-space duality,
arXiv:2405.21060), with a chunked-parallel path and a recurrent decode path
over the same parameters.

* ``mamba2_init``       — the reference's leaves: the fused ``in_proj``
  (z, xBC, dt), the depthwise ``conv_w`` / ``conv_b``, ``a_log``,
  ``d_skip``, ``dt_bias``, the gated norm's ``norm_g`` and ``out_proj``;
  ``lead`` stacks layers as ``layers.linear_init`` does.
* ``mamba2_forward``    — the chunked SSD over a whole sequence, whose
  length must be a multiple of ``ssm_chunk`` (the reference asserts it).
* ``mamba2_prefill``    — the same pass for any length, which also returns
  the final SSM state and the conv window: the cache that a replay of the
  sequence through ``mamba2_decode`` leaves.
* ``mamba2_init_cache`` / ``mamba2_decode`` — the per-token recurrence.

Under tensor parallelism (``launch.spmd.TensorParallel``, parameters placed
by ``launch.sharding``'s rules) each rank holds a contiguous column block
of ``in_proj`` (which cuts across ``z | x | B | C | dt``), a channel block
of ``conv_w`` / ``conv_b`` over ``x | B | C``, a head block of ``norm_g``
and of ``out_proj``'s rows, and a cache whose SSM state is split on ``P``
and whose conv window on its channels. The mixer then runs the SSD on this
rank's ``P`` block of every head, which is the cache's placement (each
``p`` is independent given ``dt``, ``B`` and ``C``): the projection's
blocks are gathered whole, the conv runs on the channels that block
needs (from the conv weights gathered), and one ``all_to_all`` takes the
result to the head block that ``norm_g`` and ``out_proj`` hold; the gated
norm's sum of squares is summed over the ranks. ``a_log``, ``d_skip`` and
``dt_bias`` replicate, and their gradients, partial on each rank, are
summed. A decode step runs the conv on the cache's own channel block and
gathers its output; the SSM state never moves.

Within a chunk the recurrence is expanded into an attention-like quadratic
form; across chunks the small ``[B, H, P, N]`` state is carried by a loop
over the chunks. The reference's three- and four-operand einsums are
written as fixed two-operand products (``C·Bᵀ``, then ``(C·Bᵀ ⊙ L)·xdt``
per head, and so on), so the contraction order, and with it the rounding,
does not depend on whether ``opt_einsum`` is installed. ``dt``, ``da``,
the chunk math and the SSM state are f32; the conv window and the outputs
take the config's dtype, as in the reference.

Tracing (``obs.trace``): the whole-sequence mixer records ``ssm.conv``
around the causal conv and ``ssm.ssd`` from the f32 ``B`` / ``C`` and
``dt`` through the ``d_skip`` add: what a fused SSD would replace.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SparsityConfig
from ..launch import spmd
from ..obs.trace import active
from .layers import _randn, linear_apply, linear_init, rmsnorm


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype,
                sp: Optional[SparsityConfig] = None,
                lead: Tuple[int, ...] = ()) -> Dict[str, object]:
    """The mixer's params, drawn from ``gen`` on its device (``in_proj``,
    ``conv_w``, ``out_proj``, in that order); the other leaves are the
    reference's constants, computed in f32 and cast to ``dtype``."""
    d, di, ns, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ns
    sp_mlp = sp if (sp and "mlp" in sp.targets) else None
    dev = gen.device

    def const(v: torch.Tensor) -> torch.Tensor:
        return v.to(dev, dtype).expand(*lead, -1).clone()
    return {
        # z, xBC, dt: the fused input projection (the dominant matmul)
        "in_proj": linear_init(gen, d, 2 * di + 2 * ns + h, dtype, sp_mlp,
                               lead=lead),
        "conv_w": _randn(gen, (*lead, cfg.ssm_conv, conv_dim), dtype) * 0.2,
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=dev),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, h))),
        "d_skip": torch.ones((*lead, h), dtype=dtype, device=dev),
        "dt_bias": const(torch.log(torch.expm1(torch.full((h,), 0.01)))),
        "norm_g": torch.ones((*lead, di), dtype=dtype, device=dev),
        "out_proj": linear_init(gen, di, d, dtype, sp_mlp, lead=lead),
    }


def _split_proj(p, x, cfg: ModelConfig):
    di, ns = cfg.d_inner, cfg.ssm_state
    zxbcdt = linear_apply(p["in_proj"], x)
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * ns],
            zxbcdt[..., 2 * di + 2 * ns:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over time. xbc [B, S, C], w [W, C]; the W
    products summed in xbc's dtype in the order i = 0..W-1, as the
    reference sums them."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, :s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i: i + s] * w[i]
    return F.silu(out + b)


def _dt_da(p, dt: torch.Tensor):
    """The step ``dt = softplus(dt + dt_bias)`` and the log-decay
    ``da = -exp(a_log)·dt`` (<= 0), both f32."""
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["a_log"].float()) * dt


def _ssd(xdt: torch.Tensor, da: torch.Tensor, bm: torch.Tensor,
         cm: torch.Tensor, q: int):
    """The chunked SSD in f32. xdt [B, S, H, P], da [B, S, H], bm and cm
    [B, S, N], with S a multiple of the chunk ``q``. Returns y [B, S, H, P]
    (the skip term not added) and the state after the last position
    [B, H, P, N]."""
    b, s, h, pd = xdt.shape
    nc, n = s // q, bm.shape[-1]
    x_c = xdt.reshape(b, nc, q, h, pd).permute(0, 1, 3, 2, 4)       # [B,NC,H,Q,P]
    b_c = bm.reshape(b, nc, 1, q, n)
    c_c = cm.reshape(b, nc, 1, q, n)
    cs = da.reshape(b, nc, q, h).transpose(2, 3).cumsum(-1)          # [B,NC,H,Q]

    # within a chunk: y_i = sum_{j <= i} (C_i·B_j) exp(cs_i - cs_j) xdt_j.
    # The mask goes in before the exp, where exp(seg) above the diagonal
    # could overflow (and its gradient, 0 · inf, would be NaN)
    tri = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    seg = cs[..., :, None] - cs[..., None, :]
    cb = c_c @ b_c.transpose(-1, -2)
    if torch.is_grad_enabled():
        # out of place: exp saves its output for the backward
        y = (seg.masked_fill(~tri, float("-inf")).exp() * cb) @ x_c
    else:
        # one [B, NC, H, Q, Q] tensor, updated in place (671 MB at
        # Mamba2-2.7B's prefill); the same arithmetic as above
        seg.masked_fill_(~tri, float("-inf")).exp_()
        y = seg.mul_(cb) @ x_c                                        # [B,NC,H,Q,P]
    del seg, cb

    # each chunk's end state from its own inputs, and its total decay
    decay_to_end = torch.exp(cs[..., -1:] - cs)                       # [B,NC,H,Q]
    local = (x_c * decay_to_end[..., None]).transpose(-1, -2) @ b_c   # [B,NC,H,P,N]
    chunk_decay = torch.exp(cs[..., -1])                              # [B,NC,H]

    # across chunks: the state entering each chunk
    state = torch.zeros((b, h, pd, n), dtype=torch.float32, device=xdt.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = chunk_decay[:, c, :, None, None] * state + local[:, c]
    s_prev = torch.stack(entering, 1)                                 # [B,NC,H,P,N]
    y = y + (c_c @ s_prev.transpose(-1, -2)) * torch.exp(cs)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, pd), state


def _mamba2(p, x: torch.Tensor, cfg: ModelConfig, want_cache: bool):
    tp = spmd.active_tp()
    if tp is not None and tp.size > 1:
        return _mamba2_tp(p, x, cfg, want_cache, tp)
    b, s, _ = x.shape
    di, ns, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = cfg.ssm_chunk

    z, xbc_in, dt = _split_proj(p, x, cfg)
    with active().span("ssm.conv"):
        xbc = _causal_conv(xbc_in, p["conv_w"], p["conv_b"])
    xs = xbc[..., :di].reshape(b, s, h, pd)
    with active().span("ssm.ssd"):
        bm, cm = xbc[..., di: di + ns].float(), xbc[..., di + ns:].float()
        dt, da = _dt_da(p, dt)
        xdt = xs.float() * dt[..., None]
        pad = -s % q
        if pad:
            # padded positions carry da = 0 and xdt = 0: the state passes
            # them unchanged, and their rows of y are dropped
            xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
            da, bm, cm = (F.pad(t, (0, 0, 0, pad)) for t in (da, bm, cm))
        y, state = _ssd(xdt, da, bm, cm, q)
        y = y[:, :s] + p["d_skip"].float()[:, None] * xs.float()
    y = y.reshape(b, s, di).to(x.dtype)

    y = rmsnorm(p["norm_g"], y * F.silu(z), cfg.norm_eps)
    out = linear_apply(p["out_proj"], y)
    if not want_cache:
        return out
    # the conv window a replay leaves: the last W - 1 inputs, zeros before
    # the first token
    w1 = cfg.ssm_conv - 1
    tail = F.pad(xbc_in[:, max(0, s - w1):], (0, 0, max(0, w1 - s), 0))
    return out, state, tail


# ---------------------------------------------------------------------------
# tensor parallelism (module docstring)
# ---------------------------------------------------------------------------

def _sp(cfg: ModelConfig) -> Optional[SparsityConfig]:
    sp = cfg.sparsity
    return sp if (sp and "mlp" in sp.targets) else None


def _p_block(t: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """The ``x | B | C`` channels (``t``'s last dim) that this rank's SSD
    reads: its ``P`` block of every head's ``x``, then all of ``B`` and
    ``C``; slices, so the backward adds no index scatter."""
    di, h, pd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    pl = pd // tp.size
    xs = t[..., :di].unflatten(-1, (h, pd))[..., tp.rank * pl:
                                             (tp.rank + 1) * pl]
    return torch.cat([xs.flatten(-2), t[..., di:]], dim=-1)


def _replicated_ssm(p, tp):
    """``a_log``, ``d_skip``, ``dt_bias``: replicated, read on this rank's
    ``P`` block only, so their gradients are summed over the model axis."""
    return {k: tp.grad_sum(p[k]) for k in ("a_log", "d_skip", "dt_bias")}


def _gated_norm(g, y, z, eps: float, tp):
    """``rmsnorm(g, y * silu(z))`` over the whole ``d_inner`` from this
    rank's head block: the sum of squares summed over the model axis."""
    x = y * F.silu(z)
    if tp is None or tp.size == 1:
        return rmsnorm(g, x, eps)
    x32 = x.float()
    ms = tp.psum((x32 * x32).sum(-1, keepdim=True)) / (x32.shape[-1] * tp.size)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * g


def _heads_out(p, y, z, x_dtype, cfg: ModelConfig, tp, lead):
    """``y [*lead, H, P/tp]`` (this rank's ``P`` block of every head) ->
    its head block (one ``all_to_all``), gated, normed and through this
    rank's rows of ``out_proj``: the partial output."""
    # cast first (elementwise, so the same values), then exchanged
    y = tp.all_to_all(y.to(x_dtype), len(lead), len(lead) + 1)
    y = y.reshape(*lead, -1)                                 # [*lead, H/tp·P]
    y = _gated_norm(p["norm_g"], y, z, cfg.norm_eps, tp)
    return linear_apply(p["out_proj"], y, _sp(cfg))


def _mamba2_tp(p, x: torch.Tensor, cfg: ModelConfig, want_cache: bool, tp):
    """``_mamba2`` on this rank's blocks; ``x`` the replicated input. The
    output is partial (the caller sums it over the model axis); the cache
    is this rank's ``P`` block of the state and channel block of the conv
    window."""
    b, s, _ = x.shape
    di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    pl, q, dl = cfg.ssm_head_dim // tp.size, cfg.ssm_chunk, di // tp.size
    zxbcdt = tp.enter_cols(linear_apply(p["in_proj"], x, _sp(cfg)))
    z = zxbcdt[..., tp.rank * dl:(tp.rank + 1) * dl]
    xbc_in = zxbcdt[..., di: 2 * di + 2 * ns]
    with active().span("ssm.conv"):
        xbc = _causal_conv(_p_block(xbc_in, cfg, tp),
                           _p_block(tp.enter_cols(p["conv_w"]), cfg, tp),
                           _p_block(tp.enter_cols(p["conv_b"]), cfg, tp))
    xs = xbc[..., :h * pl].reshape(b, s, h, pl)
    with active().span("ssm.ssd"):
        bm = xbc[..., h * pl: h * pl + ns].float()
        cm = xbc[..., h * pl + ns:].float()
        rp = _replicated_ssm(p, tp)
        dt, da = _dt_da(rp, zxbcdt[..., 2 * di + 2 * ns:])
        xdt = xs.float() * dt[..., None]
        pad = -s % q
        if pad:
            xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
            da, bm, cm = (F.pad(t, (0, 0, 0, pad)) for t in (da, bm, cm))
        y, state = _ssd(xdt, da, bm, cm, q)
        y = y[:, :s] + rp["d_skip"].float()[:, None] * xs.float()
    out = _heads_out(p, y, z, x.dtype, cfg, tp, (b, s))
    if not want_cache:
        return out
    cw = p["conv_w"].shape[-1]               # this rank's conv channels
    w1 = cfg.ssm_conv - 1
    mine = xbc_in[..., tp.rank * cw:(tp.rank + 1) * cw]
    tail = F.pad(mine[:, max(0, s - w1):], (0, 0, max(0, w1 - s), 0))
    return out, state, tail


def _decode_tp(p, x: torch.Tensor, cache, cfg: ModelConfig, tp):
    """``mamba2_decode`` on this rank's blocks: the conv over the cache's
    channel block, its output gathered; the state's ``P`` block updated in
    place. Returns the partial ``[B, 1, D]``."""
    b = x.shape[0]
    di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    pl, dl = cfg.ssm_head_dim // tp.size, di // tp.size
    zxbcdt = tp.all_gather(linear_apply(p["in_proj"], x[:, 0, :], _sp(cfg)),
                           -1)
    z = zxbcdt[..., tp.rank * dl:(tp.rank + 1) * dl]
    cw = p["conv_w"].shape[-1]
    xbc = zxbcdt[..., di + tp.rank * cw: di + (tp.rank + 1) * cw]
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)
    conv_out = F.silu((window * p["conv_w"]).sum(dim=1) + p["conv_b"])
    cache["conv"].copy_(window[:, 1:])
    sel = _p_block(tp.all_gather(conv_out, -1), cfg, tp)
    xs = sel[..., :h * pl].reshape(b, h, pl)
    bm, cm = sel[..., h * pl: h * pl + ns].float(), sel[..., h * pl + ns:].float()
    dt, da = _dt_da(p, zxbcdt[..., 2 * di + 2 * ns:])
    xdt = xs.float() * dt[..., None]
    ssm = cache["ssm"]
    ssm.mul_(torch.exp(da)[:, :, None, None]).add_(
        xdt[..., None] * bm[:, None, None, :])
    y = (ssm @ cm[:, None, :, None])[..., 0]
    y = y + p["d_skip"].float()[:, None] * xs.float()
    return _heads_out(p, y, z, x.dtype, cfg, tp, (b,))[:, None, :]


def mamba2_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Chunked SSD over a full sequence. x [B, S, D] -> [B, S, D]; S must be
    a multiple of ``cfg.ssm_chunk``."""
    if x.shape[1] % cfg.ssm_chunk:
        raise ValueError(f"sequence {x.shape[1]} is not a multiple of the "
                         f"SSD chunk {cfg.ssm_chunk}")
    return _mamba2(p, x, cfg, want_cache=False)


def mamba2_prefill(p, x: torch.Tensor, cfg: ModelConfig):
    """``mamba2_forward`` for any S, keeping the decode cache: (out [B, S,
    D], ssm state [B, H, P, N] f32 after the last position, conv window
    [B, W-1, C] in x's dtype: the last W - 1 pre-conv inputs, left-padded
    with zeros when S < W - 1)."""
    return _mamba2(p, x, cfg, want_cache=True)


# ---------------------------------------------------------------------------
# recurrent decode
# ---------------------------------------------------------------------------

def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype, device="cuda",
                      lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``conv [*lead, B, W-1, C]`` in ``dtype``, ``ssm [*lead, B, H, P, N]``
    in f32, zero."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32, device=device),
    }


def mamba2_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  cfg: ModelConfig):
    """One token. x [B, 1, D] -> ([B, 1, D], cache). The cache's ``conv``
    and ``ssm`` are written IN PLACE (the reference returns new ones; the
    returned dict is ``cache``)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mamba2_decode takes one token, got {s}")
    tp = spmd.active_tp()
    if tp is not None and tp.size > 1:
        return _decode_tp(p, x, cache, cfg, tp), cache
    di, ns, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    z, xbc, dt = _split_proj(p, x[:, 0, :], cfg)
    # conv over the rolling window
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)        # [B, W, C]
    conv_out = F.silu((window * p["conv_w"]).sum(dim=1) + p["conv_b"])
    cache["conv"].copy_(window[:, 1:])

    xs = conv_out[..., :di].reshape(b, h, pd)
    bm, cm = conv_out[..., di: di + ns].float(), conv_out[..., di + ns:].float()
    dt, da = _dt_da(p, dt)                                             # [B, H]
    xdt = xs.float() * dt[..., None]                                   # [B, H, P]
    ssm = cache["ssm"]
    ssm.mul_(torch.exp(da)[:, :, None, None]).add_(
        xdt[..., None] * bm[:, None, None, :])
    y = (ssm @ cm[:, None, :, None])[..., 0]                           # [B, H, P]
    y = y + p["d_skip"].float()[:, None] * xs.float()
    y = y.reshape(b, di).to(x.dtype)

    y = rmsnorm(p["norm_g"], y * F.silu(z), cfg.norm_eps)
    return linear_apply(p["out_proj"], y)[:, None, :], cache
