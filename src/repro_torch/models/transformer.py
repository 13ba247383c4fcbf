"""Model assembly (``repro.models.transformer``) for the attention families
the port serves: dense, vlm and audio.

* ``init_params``   — stacked per-layer params (``[L, ...]`` leaves, the
  reference's tree), drawn from a ``torch.Generator`` on its device.
* ``forward``       — full-sequence forward: logits and ``aux`` (``ia``,
  ``pooled``).
* ``init_cache`` / ``prefill`` / ``decode_step`` — serving: GQA KV caches
  (ring buffer under SWA), with the position a host int.

The layer loop is a Python ``for`` over views of the stacked leaves (the
reference scans). Attention takes an explicit route instead of the
reference's mesh context: ``attn="flash"`` (default) goes through
``layers.attn_full_flash`` → ``kernels/flash_attn`` (the CUDA kernel on the
card, the plain version on the CPU); ``attn="plain"`` is the reference's
path without the context, ``attn_full`` or, beyond
``CHUNKED_ATTN_THRESHOLD``, ``attn_full_chunked``.

Not here: the reference's ``probe`` mode (XLA cost accounting: it has no
counterpart in eager torch), ``lm_loss`` / ``lm_loss_chunked``,
``local_mode`` and ``local_heads`` (OSSL LM training), and the moe, ssm and
hybrid families — each raises ``NotImplementedError`` naming the ROADMAP
item that brings it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as L

ATTN_FAMILIES = ("dense", "vlm", "audio")
CHUNKED_ATTN_THRESHOLD = 2048
_LATER = {
    "moe": "models/moe.py (ROADMAP Queue 1 item 11, after LM training)",
    "ssm": "models/mamba2.py (ROADMAP Queue 1 item 11, after MoE)",
    "hybrid": "models/mamba2.py and the shared block (ROADMAP Queue 1 item 11, after MoE)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet: "
            f"{_LATER[cfg.family]}")
    if cfg.family not in ATTN_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _no_local(local: bool, what: str) -> None:
    if local:
        raise NotImplementedError(
            f"{what} belongs to OSSL LM training (core/ossl.py), which comes "
            f"with the LM training slice (ROADMAP Queue 1 item 11)")


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
    draws a model for the card where it will live)."""
    _check_family(cfg)
    _no_local(local_heads, "local_heads")
    dtype, dev = _dtype(cfg), gen.device
    lead = (cfg.n_layers,)
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg, dtype),
        "layers": {
            "norm1": L.rmsnorm_init(cfg.d_model, dtype, dev, lead),
            "attn": L.attn_init(gen, cfg, dtype, cfg.sparsity, lead),
            "norm2": L.rmsnorm_init(cfg.d_model, dtype, dev, lead),
            "mlp": L.mlp_init(gen, cfg, dtype, cfg.sparsity, lead=lead),
        },
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._randn(gen, (cfg.d_model, cfg.vocab), dtype) \
            * (cfg.d_model ** -0.5)
    return _to(params, device)


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


def _attn_fn(cfg: ModelConfig, s: int, attn: str):
    if attn == "flash":
        return L.attn_full_flash
    if attn != "plain":
        raise ValueError(f"attn must be 'flash' or 'plain', got {attn!r}")
    if s > CHUNKED_ATTN_THRESHOLD:
        return functools.partial(L.attn_full_chunked, q_chunk=512)
    return L.attn_full


def _block(lp, h, angles, cfg: ModelConfig, attn_fn):
    """One attention + MLP block: (h_out, (k, v))."""
    a, kv = attn_fn(lp["attn"], L.rmsnorm(lp["norm1"], h, cfg.norm_eps),
                    angles, cfg, cfg.sparsity)
    h = h + a
    h = h + L.mlp_apply(lp["mlp"], L.rmsnorm(lp["norm2"], h, cfg.norm_eps),
                        cfg, cfg.sparsity)
    return h, kv


def _head(params, cfg: ModelConfig, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(params, cfg: ModelConfig, tokens=None, embeds=None, positions=None,
            attn: str = "flash", local_mode: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward. Returns (logits [B,S,V], aux) with
    ``aux["ia"]`` [L] (mean |block input|) and ``aux["pooled"]`` [L, D]
    (mean block output), both f32: the gating engine's statistics."""
    _check_family(cfg)
    _no_local(local_mode, "local_mode")
    h = L.embed_apply(params["embed"], tokens, embeds)
    b, s, _ = h.shape
    angles = _angles_for(cfg, positions, b, s, h.device)
    attn_fn = _attn_fn(cfg, s, attn)
    ia, pooled = [], []
    for i in range(cfg.n_layers):
        h_in = h
        h, _ = _block(layer_view(params["layers"], i), h, angles, cfg, attn_fn)
        ia.append(h_in.abs().mean().float())
        pooled.append(h.mean(dim=(0, 1)).float())
    aux = {"ia": torch.stack(ia), "pooled": torch.stack(pooled)}
    return _head(params, cfg, h), aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode step
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.swa_window) if cfg.swa_window else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> Dict[str, Any]:
    """``{"pos": 0, "k", "v": [L, B, C, KV, dh]}``; ``pos`` is a host int."""
    _check_family(cfg)
    c = cache_len(cfg, max_seq)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_seq: int,
            attn: str = "flash"):
    """Run the full prompt and build a decode cache. Returns
    (last_logits [B, V], cache).

    One pass over the blocks collects each layer's K/V as it goes (the
    reference runs ``forward`` and then re-runs every layer for K/V), so
    ``attn="flash"`` launches the flash kernel ``n_layers`` times per
    prefill on the card. Only the last position goes through the final norm
    and the head: the norm is per row, so its logits are the reference's
    ``logits[:, -1]``. The last ``min(S, C)`` positions land at ring slots
    ``pos % C``, as decode writes them.
    """
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq, tokens.device)
    h = L.embed_apply(params["embed"], tokens)
    angles = _angles_for(cfg, None, b, s, h.device)
    attn_fn = _attn_fn(cfg, s, attn)
    c = cache["k"].shape[2]
    take = min(s, c)
    slots = torch.tensor([(s - take + i) % c for i in range(take)],
                         device=h.device)
    for i in range(cfg.n_layers):
        h, (k, v) = _block(layer_view(params["layers"], i), h, angles, cfg,
                           attn_fn)
        cache["k"][i, :, slots] = k[:, s - take:]
        cache["v"][i, :, slots] = v[:, s - take:]
    cache["pos"] = s
    return _head(params, cfg, h[:, -1]), cache


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens [B] -> (logits [B, V], cache). The cache's
    K/V are written in place (the returned dict holds the same tensors, with
    ``pos`` advanced); nothing is read back from the device."""
    _check_family(cfg)
    h = L.embed_apply(params["embed"], tokens[:, None])          # [B,1,D]
    b = h.shape[0]
    pos = cache["pos"]
    p1 = torch.full((b, 1), pos, device=h.device)
    angles = _angles_for(cfg, torch.stack([p1] * 3)
                         if cfg.rope_mode == "mrope" else p1, b, 1, h.device)
    for i in range(cfg.n_layers):
        lp = layer_view(params["layers"], i)
        hn = L.rmsnorm(lp["norm1"], h, cfg.norm_eps)
        a, _, _ = L.attn_decode(lp["attn"], hn, angles, cache["k"][i],
                                cache["v"][i], pos, cfg, cfg.sparsity)
        h = h + a
        hn = L.rmsnorm(lp["norm2"], h, cfg.norm_eps)
        h = h + L.mlp_apply(lp["mlp"], hn, cfg, cfg.sparsity)
    new_cache = dict(cache, pos=pos + 1)
    return _head(params, cfg, h)[:, 0, :], new_cache
