"""Model assembly (``repro.models.transformer``) for every family of the
pool: the attention families (dense, moe, vlm, audio), ``ssm`` (Mamba2)
and ``hybrid`` (Zamba2: a Mamba2 trunk plus one shared attention and MLP
block, applied after every ``hybrid_attn_every``-th layer). All of them
serve and train. The hybrid's shared block is one set of params: under
remat each checkpointed block that calls it recomputes it, and its
gradient is the sum over its calls.

* ``init_params``   — stacked per-layer params (``[L, ...]`` leaves, the
  reference's tree; ``shared`` for the hybrid), drawn from a
  ``torch.Generator`` on its device; with ``local_heads`` the OSSL
  predictor heads ``[L, D, D]``. ``init_params_shaped``: the same tree
  on the ``meta`` device (shapes and dtypes only).
* ``forward``       — full-sequence forward: logits (or, ``want_hidden``,
  the final normed hidden states) and ``aux`` (``local_loss``, ``moe_aux``,
  ``moe_dropped``, ``ia``, ``pooled``). ``local_mode`` detaches every block
  input and adds each block's OSSL loss; ``cfg.remat`` recomputes each
  block in the backward (``torch.utils.checkpoint``).
* ``lm_loss`` / ``lm_loss_chunked`` — mean next-token cross entropy, the
  latter over sequence chunks so the ``[B, S, V]`` logits never exist.
* ``init_cache`` / ``prefill`` / ``decode_step`` — serving: GQA KV caches
  (ring buffer under SWA), the Mamba2 conv window and SSM state, and the
  shared block's ring caches, with the position a host int.

The layer loop is a Python ``for`` over views of the stacked leaves (the
reference scans), so the hybrid's "is this a shared-block layer" test is a
host ``if`` where the reference uses ``lax.cond``. Attention takes a route:
``attn="flash"`` goes through ``layers.attn_full_flash`` →
``kernels/flash_attn`` (the CUDA kernels on the card, the plain version on
the CPU), for the hybrid's shared block too (the reference routes only the
attention families through flash; it is the same causal attention with the
window); ``attn="plain"`` is the reference's path without the context,
``attn_full`` or, beyond ``CHUNKED_ATTN_THRESHOLD``, ``attn_full_chunked``.
With no ``attn`` given, an active ``launch.spmd`` context picks the route
by its ``flash_attn`` flag, as the reference's does; with none the route
is ``"flash"``. ``forward`` calls ``spmd.constrain_seq`` at every block
boundary, where the reference does.

The moe family puts ``models/moe.py``'s layer (``lp["moe"]``) where the
others have the MLP. Its capacity is that of each call's tokens, so a
decode step is not the forward at the same position once the prefill
drops a choice (as in the reference).

The ssm and hybrid prefill is one chunked pass (``mamba2.mamba2_prefill``)
that keeps each layer's final SSM state and conv window; the reference
replays the prompt token by token through ``decode_step``, which computes
the same function (chunked ≡ recurrent is the reference's own invariant).

Not here: the reference's ``probe`` mode (XLA cost accounting: it has no
counterpart in eager torch).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core import ossl as ossl_lib
from ..launch import spmd
from . import layers as L
from . import mamba2 as M
from . import moe as MOE

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")
SSM_FAMILIES = ("ssm", "hybrid")
CHUNKED_ATTN_THRESHOLD = 2048


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ATTN_FAMILIES + SSM_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _shared_slot(cfg: ModelConfig, shared, i: int):
    """The shared-block cache slot of layer ``i``, or None where the shared
    block does not run after it (every layer but each ``every``-th of a
    hybrid whose params hold the block)."""
    every = cfg.hybrid_attn_every
    if shared is None or not every or (i + 1) % every:
        return None
    return (i + 1) // every - 1


def layer_view(tree, i: int):
    """Layer ``i`` of stacked ``[L, ...]`` leaves, as views."""
    if isinstance(tree, dict):
        return {k: layer_view(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda",
                local_heads: bool = False) -> Dict[str, Any]:
    """Random params with the reference's tree and shapes, drawn from
    ``gen`` on its own device and placed on ``device`` (a CUDA generator
    draws a model for the card where it will live). ``local_heads`` adds
    one OSSL predictor head per block, ``{"p": [L, D, D]}``, drawn last."""
    _check_family(cfg)
    dtype, dev = _dtype(cfg), gen.device
    lead = (cfg.n_layers,)
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg, dtype),
        "layers": {"norm1": L.rmsnorm_init(cfg.d_model, dtype, dev, lead)},
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev),
    }
    lp = params["layers"]
    if cfg.family in SSM_FAMILIES:
        lp["mixer"] = M.mamba2_init(gen, cfg, dtype, cfg.sparsity, lead)
    else:
        lp["attn"] = L.attn_init(gen, cfg, dtype, cfg.sparsity, lead)
        lp["norm2"] = L.rmsnorm_init(cfg.d_model, dtype, dev, lead)
        if cfg.family == "moe":
            lp["moe"] = MOE.moe_init(gen, cfg, dtype, cfg.sparsity, lead)
        else:
            lp["mlp"] = L.mlp_init(gen, cfg, dtype, cfg.sparsity, lead=lead)
    if not cfg.tie_embeddings:
        params["lm_head"] = L._randn(gen, (cfg.d_model, cfg.vocab), dtype) \
            * (cfg.d_model ** -0.5)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        params["shared"] = _shared_block_init(gen, cfg, dtype)
    if local_heads:
        params["local_heads"] = ossl_lib.local_head_init(gen, cfg.d_model,
                                                         dtype, lead)
    return _to(params, device)


def init_params_shaped(cfg: ModelConfig, local_heads: bool = False
                       ) -> Dict[str, Any]:
    """``init_params``'s tree on the ``meta`` device: every leaf's shape
    and dtype, with no memory and no draw (the dry run's params)."""
    return init_params(L.MetaGenerator(), cfg, device="meta",
                       local_heads=local_heads)


def _shared_block_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    """Zamba2's shared attention + MLP block: one set of params, reused
    after every ``hybrid_attn_every``-th layer, never sparse."""
    dev = gen.device
    return {"norm1": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": L.attn_init(gen, cfg, dtype, None),
            "norm2": L.rmsnorm_init(cfg.d_model, dtype, dev),
            "mlp": L.mlp_init(gen, cfg, dtype, None)}


# ---------------------------------------------------------------------------
# rotary helpers / attention route
# ---------------------------------------------------------------------------

def _angles_for(cfg: ModelConfig, positions, b: int, s: int, device):
    if cfg.rope_mode == "none":
        return None
    if positions is None:
        pos1 = torch.arange(s, device=device)[None].expand(b, s)
        if cfg.rope_mode == "mrope":
            positions = torch.stack([pos1] * 3)                 # text-degenerate
        else:
            positions = pos1
    if cfg.rope_mode == "mrope":
        return L.mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    return L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def attn_route(attn=None) -> str:
    """``attn`` where given; else ``"flash"`` or ``"plain"`` by the active
    SPMD context's ``flash_attn``; ``"flash"`` with no context."""
    if attn is not None:
        return attn
    ctx = spmd.current()
    return "flash" if ctx is None or ctx.flash_attn else "plain"


def _attn_fn(cfg: ModelConfig, s: int, attn=None):
    attn = attn_route(attn)
    if attn == "flash":
        return L.attn_full_flash
    if attn != "plain":
        raise ValueError(f"attn must be 'flash' or 'plain', got {attn!r}")
    if s > CHUNKED_ATTN_THRESHOLD:
        return functools.partial(L.attn_full_chunked, q_chunk=512)
    return L.attn_full


def _ffn(lp, h, cfg: ModelConfig):
    """The block's second half, MLP or MoE, on the normed stream:
    (out, moe aux or None). The hybrid's shared block takes it too (its MLP
    is dense, so the sparsity config changes nothing there)."""
    hn = L.rmsnorm(lp["norm2"], h, cfg.norm_eps)
    if cfg.family == "moe":
        return MOE.moe_apply(lp["moe"], hn, cfg)
    return L.mlp_apply(lp["mlp"], hn, cfg, cfg.sparsity), None


def _block(lp, h, angles, cfg: ModelConfig, attn_fn, shared=None):
    """One block: (h_out, (k, v) or None, moe aux or None). Attention + MLP
    (or MoE); or, for ssm and hybrid, the Mamba2 mixer followed by the
    shared block where ``shared`` is given (its K/V returned)."""
    if cfg.family in SSM_FAMILIES:
        h = h + M.mamba2_forward(lp["mixer"],
                                 L.rmsnorm(lp["norm1"], h, cfg.norm_eps), cfg)
        if shared is None:
            return h, None, None
        h, kv = _shared_apply(shared, h, angles, cfg, attn_fn)
        return h, kv, None
    a, kv = attn_fn(lp["attn"], L.rmsnorm(lp["norm1"], h, cfg.norm_eps),
                    angles, cfg, cfg.sparsity)
    h = h + a
    f, aux = _ffn(lp, h, cfg)
    return h + f, kv, aux


def _shared_apply(shared, h, angles, cfg: ModelConfig, attn_fn):
    """The hybrid's shared attention + MLP block over a whole sequence:
    (h_out, (k, v))."""
    a, kv = attn_fn(shared["attn"], L.rmsnorm(shared["norm1"], h, cfg.norm_eps),
                    angles, cfg)
    h = h + a
    return h + _ffn(shared, h, cfg)[0], kv


def _shared_decode(shared, h, angles, ck, cv, pos: int, cfg: ModelConfig):
    """The shared block for one token against its slot's ring cache
    ``ck``/``cv`` [B, C, KV, dh], written in place at ``pos % C``."""
    a, _, _ = L.attn_decode(shared["attn"],
                            L.rmsnorm(shared["norm1"], h, cfg.norm_eps),
                            angles, ck, cv, pos, cfg)
    h = h + a
    return h + _ffn(shared, h, cfg)[0]


def _head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]


def _head(params, cfg: ModelConfig, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h @ _head_matrix(params, cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens=None, embeds=None, positions=None,
            attn=None, local_mode: bool = False,
            want_hidden: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward. Returns (logits [B,S,V], aux), or the final
    normed hidden states [B,S,D] in place of the logits when
    ``want_hidden`` (the chunked-loss path). ``aux``: ``local_loss`` (f32
    sum of the blocks' OSSL losses in ``local_mode``, else 0), ``moe_aux``
    and ``moe_dropped`` (f32, the mean over the MoE layers; 0 for the other
    families), ``ia`` [L] (mean |block input|)
    and ``pooled`` [L, D] (mean block output), the gating engine's
    statistics, f32 and detached.

    ``local_mode`` detaches every block input, adds each block's
    ``ossl.local_loss`` against its ``local_heads`` entry (when the params
    have them) and detaches the final hidden states, so the readout learns
    on frozen features. With ``cfg.remat`` each block (and its local loss)
    runs under ``torch.utils.checkpoint`` when gradients are on: the
    backward recomputes it, and the flash kernel launches again. For ssm
    and hybrid, ``S`` must be a multiple of ``cfg.ssm_chunk`` (``ValueError``;
    the reference asserts it); ``prefill`` takes any ``S``."""
    _check_family(cfg)
    h = L.embed_apply(params["embed"], tokens, embeds)
    b, s, _ = h.shape
    angles = _angles_for(cfg, positions, b, s, h.device)
    attn_fn = _attn_fn(cfg, s, attn)
    heads = params.get("local_heads") if local_mode else None
    shared = params.get("shared")
    remat = cfg.remat and torch.is_grad_enabled()
    lloss = torch.zeros((), dtype=torch.float32, device=h.device)
    ia, pooled, moe_aux, moe_drop = [], [], [], []
    for i in range(cfg.n_layers):
        h_in = h.detach() if local_mode else h
        head = layer_view(heads, i) if heads is not None else None
        sh = shared if _shared_slot(cfg, shared, i) is not None else None
        args = (layer_view(params["layers"], i), head, h_in, angles, cfg,
                attn_fn, sh)
        h, ll, maux = (checkpoint(_train_block, *args, use_reentrant=False)
                       if remat else _train_block(*args))
        # sequence-parallel layer boundary (launch/spmd)
        h = spmd.constrain_seq(h)
        if ll is not None:
            lloss = lloss + ll
        if maux is not None:
            moe_aux.append(maux["moe_aux"])
            moe_drop.append(maux["moe_dropped"])
        ia.append(h_in.detach().abs().mean().float())
        pooled.append(h.detach().mean(dim=(0, 1)).float())
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if local_mode:
        h = h.detach()          # readout learns on frozen features (SL layer)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = {"local_loss": lloss,
           "moe_aux": torch.stack(moe_aux).mean() if moe_aux else zero,
           "moe_dropped": torch.stack(moe_drop).mean() if moe_drop else zero,
           "ia": torch.stack(ia), "pooled": torch.stack(pooled)}
    if want_hidden:
        return h, aux
    return h @ _head_matrix(params, cfg), aux


def _train_block(lp, head, h, angles, cfg: ModelConfig, attn_fn, shared):
    """One block (with the hybrid's shared block after it where ``shared``
    is given) and, given a local head, its OSSL loss: (h_out, loss or None,
    moe aux or None)."""
    h, _, maux = _block(lp, h, angles, cfg, attn_fn, shared)
    if head is None:
        return h, None, maux
    return h, ossl_lib.local_loss(h, head, ossl_lib.OSSLConfig()), maux


def _token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy in f32: ``logsumexp(logits) - logits[target]``."""
    logits32 = logits.float()
    gold = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits32, dim=-1) - gold


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy, in f32."""
    return _token_ce(logits, targets).mean()


def _chunk_ce(h, head, t):
    return _token_ce(h @ head, t).sum()


def lm_loss_chunked(h: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Cross entropy over sequence chunks: each chunk's ``[B, chunk, V]``
    logits are recomputed in the backward (``checkpoint``), so the full
    ``[B, S, V]`` (and its f32 copies) never exists. ``S`` must be a
    multiple of ``chunk`` (as the reference's reshape requires)."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], head, targets[:, c0:c0 + chunk])
        total = total + (checkpoint(_chunk_ce, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_ce(*args))
    return total / (b * s)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode step
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.swa_window) if cfg.swa_window else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Any]:
    """The decode cache, ``pos`` a host int. Attention families:
    ``{"pos": 0, "k", "v": [L, B, C, KV, dh]}``. ssm and hybrid: ``conv [L,
    B, W-1, C]`` in the config's dtype and ``ssm [L, B, H, P, N]`` in f32;
    the hybrid adds ``shared_k``/``shared_v [L // every, B, C, KV, dh]``,
    one ring per shared-block call. ``C = cache_len(cfg, max_seq)``."""
    _check_family(cfg)
    c, dtype = cache_len(cfg, max_seq), _dtype(cfg)

    def kv(n):
        return torch.zeros((n, batch, c, cfg.n_kv_heads, cfg.head_dim),
                           dtype=dtype, device=device)
    if cfg.family in ATTN_FAMILIES:
        return {"pos": 0, "k": kv(cfg.n_layers), "v": kv(cfg.n_layers)}
    cache = {"pos": 0, **M.mamba2_init_cache(cfg, batch, dtype, device,
                                             lead=(cfg.n_layers,))}
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        slots = cfg.n_layers // cfg.hybrid_attn_every
        cache["shared_k"], cache["shared_v"] = kv(slots), kv(slots)
    return cache


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_seq: int,
            attn=None):
    """Run the full prompt and build a decode cache. Returns
    (last_logits [B, V], cache).

    One pass over the blocks collects each layer's K/V as it goes (the
    reference runs ``forward`` and then re-runs every layer for K/V), so
    ``attn="flash"`` launches the flash kernel once per attention layer on
    the card (``n_layers``; ``n_layers // hybrid_attn_every`` for the
    hybrid, none for ssm). Only the last position goes through the final
    norm and the head: the norm is per row, so its logits are the
    reference's ``logits[:, -1]``. The last ``min(S, C)`` positions land at
    ring slots ``pos % C``, as decode writes them. An MoE layer sees the
    same ``[B, S, D]`` input as in the reference's two passes, so its
    capacity and its drops are the reference's.

    ssm and hybrid: each mixer runs the chunked SSD over the prompt (any
    ``S``; ``mamba2.mamba2_prefill``) and keeps its final state and conv
    window, where the reference replays the prompt token by token through
    ``decode_step``; the two compute the same cache.
    """
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq, tokens.device)
    h = L.embed_apply(params["embed"], tokens)
    angles = _angles_for(cfg, None, b, s, h.device)
    attn_fn = _attn_fn(cfg, s, attn)
    c = cache_len(cfg, max_seq)
    take = min(s, c)
    ring = torch.tensor([(s - take + i) % c for i in range(take)],
                        device=h.device)
    shared = params.get("shared")
    for i in range(cfg.n_layers):
        lp = layer_view(params["layers"], i)
        if cfg.family in ATTN_FAMILIES:
            h, (k, v), _ = _block(lp, h, angles, cfg, attn_fn)
            ck, cv = cache["k"][i], cache["v"][i]
        else:
            o, cache["ssm"][i], cache["conv"][i] = M.mamba2_prefill(
                lp["mixer"], L.rmsnorm(lp["norm1"], h, cfg.norm_eps), cfg)
            h = h + o
            slot = _shared_slot(cfg, shared, i)
            if slot is None:
                continue
            h, (k, v) = _shared_apply(shared, h, angles, cfg, attn_fn)
            ck, cv = cache["shared_k"][slot], cache["shared_v"][slot]
        ck[:, ring] = k[:, s - take:]
        cv[:, ring] = v[:, s - take:]
    cache["pos"] = s
    return _head(params, cfg, h[:, -1]), cache


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens [B] -> (logits [B, V], cache). The cache's
    tensors are written in place (the returned dict holds the same tensors,
    with ``pos`` advanced); nothing is read back from the device. The
    hybrid's shared block after layer ``i`` attends through ring
    ``(i + 1) // every - 1``."""
    _check_family(cfg)
    h = L.embed_apply(params["embed"], tokens[:, None])          # [B,1,D]
    b = h.shape[0]
    pos = cache["pos"]
    p1 = torch.full((b, 1), pos, device=h.device)
    angles = _angles_for(cfg, torch.stack([p1] * 3)
                         if cfg.rope_mode == "mrope" else p1, b, 1, h.device)
    shared = params.get("shared")
    for i in range(cfg.n_layers):
        lp = layer_view(params["layers"], i)
        hn = L.rmsnorm(lp["norm1"], h, cfg.norm_eps)
        if cfg.family in SSM_FAMILIES:
            mc = {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}
            h = h + M.mamba2_decode(lp["mixer"], hn, mc, cfg)[0]
            slot = _shared_slot(cfg, shared, i)
            if slot is not None:
                h = _shared_decode(shared, h, angles, cache["shared_k"][slot],
                                   cache["shared_v"][slot], pos, cfg)
            continue
        a, _, _ = L.attn_decode(lp["attn"], hn, angles, cache["k"][i],
                                cache["v"][i], pos, cfg, cfg.sparsity)
        h = h + a
        h = h + _ffn(lp, h, cfg)[0]
    new_cache = dict(cache, pos=pos + 1)
    return _head(params, cfg, h)[:, 0, :], new_cache
