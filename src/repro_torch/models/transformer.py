"""Model assembly (``repro.models.transformer``) for every family of the
pool: the attention families (dense, moe, vlm, audio), ``ssm`` (Mamba2)
and ``hybrid`` (Zamba2: a Mamba2 trunk plus one shared attention and MLP
block, applied after every ``hybrid_attn_every``-th layer). All of them
serve and train. The hybrid's shared block is one set of params: under
remat each checkpointed block that calls it recomputes it, and its
gradient is the sum over its calls.

The port's own family ``mixed`` (Nemotron-H) serves only (no training,
no sharding rules): a stack of single-mixer layers ``h + mixer(norm(h))``
whose kinds follow ``cfg.layer_pattern``, ``M`` a Mamba2 mixer, ``E`` a
MoE layer, ``*`` attention (without rope where ``rope_mode`` is
``"none"``). Its tree stacks each kind's leaves over that kind's layers:
``layers.norm`` ``[L, D]``, ``mamba.*`` ``[n_M, ...]``, ``moe.*`` ``[n_E,
...]``, ``attn.*`` ``[n_A, ...]``; a Mamba2 layer's ``a_log`` and
``dt_bias`` are kept per layer, ``[L, H]`` under ``layers`` (the layout
``portbench``'s weight loader gives per-layer leaves), their rows of other
kinds holding the init's constants and never read. A layer is
viewed as a block of the other families is (``_mixed_layer``), so one
layer loop runs them all. The decode cache holds the conv window and SSM
state of the ``M`` layers and the KV caches of the ``*`` layers, each
kind's at its row in that kind's stack; an ``E`` layer keeps nothing.

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

Tracing: under an active tracer (``obs.trace.use``) each attention call of
a block or of the shared block records an ``attn`` span, the MoE layer
``moe.route`` / ``moe.experts`` / ``moe.combine`` (``models/moe``) and the
Mamba2 mixer ``ssm.conv`` / ``ssm.ssd`` (``models/mamba2``), each with its
device time; the caller's span (``train.forward``, ``serve.prefill``) is
their parent, and remat's recompute records them again in the backward.

Not here: the reference's ``probe`` mode (XLA cost accounting: it has no
counterpart in eager torch).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core import ossl as ossl_lib
from ..launch import spmd
from ..obs.trace import active
from . import layers as L
from . import mamba2 as M
from . import moe as MOE

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")
SSM_FAMILIES = ("ssm", "hybrid")
MIXED = "mixed"
KINDS = {"M": "mamba", "E": "moe", "*": "attn"}
CHUNKED_ATTN_THRESHOLD = 2048


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ATTN_FAMILIES + SSM_FAMILIES + (MIXED,):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == MIXED and (len(cfg.layer_pattern) != cfg.n_layers
                                or set(cfg.layer_pattern) - set(KINDS)):
        raise ValueError(f"layer_pattern {cfg.layer_pattern!r} is not "
                         f"{cfg.n_layers} layers of M, E and *")


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """The mixed family's layers: (kind, index in that kind's stack)."""
    seen = dict.fromkeys(KINDS, 0)
    out = []
    for c in cfg.layer_pattern:
        out.append((c, seen[c]))
        seen[c] += 1
    return out


# a mixed layer's view: (its norm's name, its mixer's name) as a block of
# another family names them
_VIEW = {"M": ("norm1", "mixer"), "*": ("norm1", "attn"), "E": ("norm2", "moe")}


def _mixed_layer(params, i: int, kind: str, j: int):
    """Layer ``i`` of the mixed family, the ``j``-th of its kind, as the
    view of a block of another family: an ``M`` layer an ssm layer's
    ``{"norm1", "mixer"}`` (with its rows of ``layers.a_log`` /
    ``layers.dt_bias``), a ``*`` layer a block's attention half ``{"norm1",
    "attn"}``, an ``E`` layer its MoE half ``{"norm2", "moe"}``."""
    lp = params["layers"]
    p = layer_view(params[KINDS[kind]], j)
    if kind == "M":
        p = dict(p, a_log=lp["a_log"][i], dt_bias=lp["dt_bias"][i])
    norm, mixer = _VIEW[kind]
    return {norm: lp["norm"][i], mixer: p}


def _layer(params, cfg: ModelConfig, i: int):
    if cfg.family == MIXED:
        return _mixed_layer(params, i, *layer_kinds(cfg)[i])
    return layer_view(params["layers"], i)


def _cache_rows(cfg: ModelConfig) -> List[int]:
    """Each layer's row in the decode cache of its kind: layer ``i``'s own
    row, or in the mixed family its index among the layers of its kind."""
    if cfg.family == MIXED:
        return [j for _, j in layer_kinds(cfg)]
    return list(range(cfg.n_layers))


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
    if cfg.family == MIXED:
        return _to(_mixed_init(gen, cfg, dtype), device)
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


def _mixed_init(gen: torch.Generator, cfg: ModelConfig, dtype):
    """The mixed family's tree (module docstring), drawn embedding, Mamba2
    stack, MoE stack, attention stack, head."""
    dev, c = gen.device, cfg.kind_counts()
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg, dtype),
        "layers": {"norm": L.rmsnorm_init(cfg.d_model, dtype, dev,
                                          (cfg.n_layers,)),
                   **M.ssm_constants(cfg, dtype, dev, (cfg.n_layers,))},
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev)}
    if c["M"]:
        mix = M.mamba2_init(gen, cfg, dtype, cfg.sparsity, (c["M"],))
        params["mamba"] = {k: v for k, v in mix.items()
                           if k not in ("a_log", "dt_bias")}
    if c["E"]:
        params["moe"] = MOE.moe_init(gen, cfg, dtype, cfg.sparsity, (c["E"],))
    if c["*"]:
        params["attn"] = L.attn_init(gen, cfg, dtype, cfg.sparsity, (c["*"],))
    if not cfg.tie_embeddings:
        params["lm_head"] = L._randn(gen, (cfg.d_model, cfg.vocab), dtype) \
            * (cfg.d_model ** -0.5)
    return params


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
    if "moe" in lp:
        return MOE.moe_apply(lp["moe"], hn, cfg)
    return _leave(L.mlp_apply(lp["mlp"], _enter(hn), cfg, cfg.sparsity)), None


def _enter(x):
    """The stream into column-parallel products (``launch.spmd``'s
    ``TensorParallel.enter``; the identity with no tensor parallelism)."""
    tp = spmd.active_tp()
    return x if tp is None else tp.enter(x)


def _leave(y):
    """A row-parallel product's partial sum back into the stream."""
    tp = spmd.active_tp()
    return y if tp is None else tp.leave(y)


def _block(lp, h, angles, cfg: ModelConfig, attn_fn, shared=None):
    """One block: (h_out, (k, v) or None, moe aux or None). Attention + MLP
    (or MoE); or, for ssm and hybrid, the Mamba2 mixer followed by the
    shared block where ``shared`` is given (its K/V returned). A mixed
    family's layer is one of these three mixers (``_mixed_layer``): the
    halves its view holds run."""
    if "mixer" in lp:
        h = h + _leave(M.mamba2_forward(
            lp["mixer"], _enter(L.rmsnorm(lp["norm1"], h, cfg.norm_eps)), cfg))
        if shared is None:
            return h, None, None
        h, kv = _shared_apply(shared, h, angles, cfg, attn_fn)
        return h, kv, None
    kv = aux = None
    if "attn" in lp:
        hn = _enter(L.rmsnorm(lp["norm1"], h, cfg.norm_eps))
        with active().span("attn"):
            a, kv = attn_fn(lp["attn"], hn, angles, cfg, cfg.sparsity)
        h = h + _leave(a)
    if "norm2" in lp:
        f, aux = _ffn(lp, h, cfg)
        h = h + f
    return h, kv, aux


def _shared_apply(shared, h, angles, cfg: ModelConfig, attn_fn):
    """The hybrid's shared attention + MLP block over a whole sequence:
    (h_out, (k, v))."""
    hn = _enter(L.rmsnorm(shared["norm1"], h, cfg.norm_eps))
    with active().span("attn"):
        a, kv = attn_fn(shared["attn"], hn, angles, cfg)
    h = h + _leave(a)
    return h + _ffn(shared, h, cfg)[0], kv


def _shared_decode(shared, h, angles, ck, cv, pos: int, cfg: ModelConfig,
                   split=None):
    """The shared block for one token against its slot's ring cache
    ``ck``/``cv`` [B, C, KV, dh], written in place at ``pos % C`` (under
    tensor parallelism this rank's blocks of it, ``split`` as
    ``layers.attn_decode_tp`` takes it)."""
    hn = L.rmsnorm(shared["norm1"], h, cfg.norm_eps)
    if spmd.active_tp() is not None:
        a = _leave(L.attn_decode_tp(shared["attn"], _enter(hn), angles, ck, cv,
                                    split, pos, cfg))
    else:
        a = L.attn_decode(shared["attn"], hn, angles, ck, cv, pos, cfg)[0]
    h = h + a
    return h + _ffn(shared, h, cfg)[0]


def _local(x):
    """A placed cache's block on this rank (the tensor itself otherwise)."""
    return x.to_local() if hasattr(x, "to_local") else x


def _head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]


def _head(params, cfg: ModelConfig, h):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, cfg, h)


def _logits(params, cfg: ModelConfig, h):
    """``h @ head``; under tensor parallelism (``h`` the replicated stream
    or its sequence block) this rank's vocab columns, as a ``DTensor``
    sharded on the vocab dim (vocab-parallel: never gathered); where the
    rules put the head's rows (``d_model``) on the model axis (the axis
    does not divide the vocabulary), a row-parallel product summed over
    the axis: the whole ``[.., V]`` on every rank, a replicated
    ``DTensor``."""
    tp = spmd.active_tp()
    if tp is None:
        return h @ _head_matrix(params, cfg)
    head = params["lm_head"]
    if head.shape[0] != h.shape[-1]:
        if tp.seq:
            h = tp.gather(h, 1)
        return tp.wrap(_row_logits(h, head, tp))
    from torch.distributed.tensor import Shard
    return tp.wrap(_enter(h) @ head, Shard(h.dim() - 1))


def _row_logits(h, head, tp):
    """The logits from the replicated stream and this rank's rows of the
    head: its ``d_model`` block times them, summed over the model axis
    (the cotangent, whole on every rank, passed through)."""
    return tp.all_sum(tp.split(h, -1) @ head)


def _embed(params, cfg: ModelConfig, tokens=None, embeds=None):
    """``layers.embed_apply``; under tensor parallelism from this rank's
    ``d_model`` columns of the table (or of ``frontend_proj``), gathered:
    the replicated stream."""
    tp = spmd.active_tp()
    p = params["embed"]
    if tp is None:
        return L.embed_apply(p, tokens, embeds)
    h = embeds @ p["frontend_proj"] if embeds is not None \
        else p["tok"][tokens]
    return tp.gather(h, -1)


def _enter_tp(params, cfg: ModelConfig, seq_len: int):
    """(the tensor-parallel state, the parameters as local blocks) for
    ``DTensor`` parameters; (None, params) for plain ones. Under SP the
    norms' gradients are summed over the model axis (each rank normed its
    own block of the sequence)."""
    tp = spmd.tensor_parallel(params, seq_len)
    if tp is None:
        return None, params
    if tp.size > 1:
        _check_tp_split(params, cfg, tp)
    local = spmd.local_tree(params)
    return tp, (_grad_summed_norms(local, tp) if tp.seq else local)


def _grad_summed_norms(tree, tp):
    """The norms' weights with their gradients summed over the model axis."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _grad_summed_norms(v, tp)
        elif k in ("norm1", "norm2", "final_norm"):
            out[k] = [tp.grad_sum(x) for x in v] if isinstance(v, list) \
                else tp.grad_sum(v)
        else:
            out[k] = v
    return out


_TP_SPLIT = {("embed", "tok"): (1,), ("embed", "frontend_proj"): (1,),
             ("lm_head",): (1, 0)}
# (path, dim of the unstacked leaf): a "layers" leaf leads with [L]
_BLOCK_SPLIT = ((("attn", "wq", "w"), 1), (("attn", "wk", "w"), 1),
                (("attn", "wv", "w"), 1), (("attn", "wo", "w"), 0),
                (("mlp", "w1", "w"), 1), (("mlp", "w2", "w"), 0),
                (("mlp", "w3", "w"), 1), (("mixer", "in_proj", "w"), 1),
                (("mixer", "out_proj", "w"), 0), (("mixer", "conv_w"), 1),
                (("mixer", "conv_b"), 0), (("mixer", "norm_g"), 0))
_TP_SPLIT.update({("layers", *node): (dim + 1,) for node, dim in _BLOCK_SPLIT})
_TP_SPLIT.update({("shared", *node): (dim,) for node, dim in _BLOCK_SPLIT})


def _check_tp_split(params, cfg: ModelConfig, tp) -> None:
    """Tensor parallelism needs the SSD heads and their ``P``, the
    embedding's columns and every projection split over the model axis as
    the rules split them at sizes they divide (a demoted, replicated leaf
    would take partial gradients); the head's columns, or its rows where
    the axis does not divide the vocabulary (the rules' second choice).
    The query heads need not split: where the axis cuts inside a head,
    each rank gathers ``wq``'s column blocks and runs the heads its rows
    of ``wo`` touch (``layers.head_cut``). The MoE layer checks its
    experts (``models/moe``)."""
    if cfg.tie_embeddings:
        raise NotImplementedError("tied embeddings under tensor parallelism")
    if cfg.family in SSM_FAMILIES:
        for what, n in (("SSD heads", cfg.ssm_heads),
                        ("SSD head dims", cfg.ssm_head_dim)):
            if n % tp.size:
                raise ValueError(f"{n} {what} do not split {tp.size} ways")
    for path, dims in _TP_SPLIT.items():
        node = params
        for k in path:
            node = node.get(k) if isinstance(node, dict) else None
        if isinstance(node, list):
            node, dims = node[0], tuple(d - 1 for d in dims)
        if node is not None and spmd.model_dim(node) not in dims:
            raise ValueError(f"{'/'.join(path)} is not split on dim "
                             f"{' or '.join(map(str, dims))} over the model "
                             f"axis of {tp.size} (the rules demoted it): "
                             "place the parameters on a mesh whose model "
                             "axis divides it")


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
    tp, params = _enter_tp(params, cfg, (tokens if tokens is not None
                                         else embeds).shape[1])
    with spmd.use_tp(tp):
        return _forward(params, cfg, tokens, embeds, positions, attn,
                        local_mode, want_hidden, tp)


def _forward(params, cfg: ModelConfig, tokens, embeds, positions, attn,
             local_mode: bool, want_hidden: bool, tp):
    h = _embed(params, cfg, tokens, embeds)
    b, s, _ = h.shape
    angles = _angles_for(cfg, positions, b, s, h.device)
    attn_fn = _attn_fn(cfg, s, attn)
    heads = params.get("local_heads") if local_mode else None
    shared = params.get("shared")
    remat = cfg.remat and torch.is_grad_enabled()
    lloss = torch.zeros((), dtype=torch.float32, device=h.device)
    ia, pooled, moe_aux, moe_drop = [], [], [], []
    if tp is not None and tp.seq:
        h = tp.split(h, 1)      # the stream's sequence block (Megatron SP)
    for i in range(cfg.n_layers):
        h_in = h.detach() if local_mode else h
        head = layer_view(heads, i) if heads is not None else None
        sh = shared if _shared_slot(cfg, shared, i) is not None else None
        args = (_layer(params, cfg, i), head, h_in, angles, cfg,
                attn_fn, sh, spmd.scope())
        h, ll, maux = (checkpoint(_train_block, *args, use_reentrant=False)
                       if remat else _train_block(*args))
        # sequence-parallel layer boundary (launch/spmd); under tensor
        # parallelism the stream keeps its layout (tp.seq) throughout
        if tp is None:
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
    ia, pooled = torch.stack(ia), torch.stack(pooled)
    if tp is not None and tp.seq:       # the statistics of the whole sequence
        both = tp.mean(torch.cat([ia, pooled.reshape(-1)]))
        ia, pooled = both[:ia.numel()], both[ia.numel():].view_as(pooled)
    aux = {"local_loss": lloss,
           "moe_aux": torch.stack(moe_aux).mean() if moe_aux else zero,
           "moe_dropped": torch.stack(moe_drop).mean() if moe_drop else zero,
           "ia": ia, "pooled": pooled}
    if want_hidden:
        if tp is None:
            return h, aux
        return tp.wrap(tp.gather(h, 1) if tp.seq else h), aux
    return _logits(params, cfg, h), aux


def _train_block(lp, head, h, angles, cfg: ModelConfig, attn_fn, shared,
                 sc):
    """One block (with the hybrid's shared block after it where ``shared``
    is given) and, given a local head, its OSSL loss: (h_out, loss or None,
    moe aux or None). The SPMD state ``sc`` (``spmd.scope()``) is passed
    in, not read from the thread: under remat the backward recomputes the
    block, maybe on another thread."""
    tp = sc.tp
    with spmd.entered(sc):
        h, _, maux = _block(lp, h, angles, cfg, attn_fn, shared)
    if head is None:
        return h, None, maux
    if tp is None:
        return h, ossl_lib.local_loss(h, head, ossl_lib.OSSLConfig()), maux
    # the whole sequence on every rank; the predictor's column block
    # gathered (its gradient, partial a rank, summed)
    p = head["p"]
    proj = None if p.shape[-1] == cfg.d_model else \
        (lambda x: tp.gather(tp.grad_sum(x) @ p, -1))
    return h, ossl_lib.local_loss(tp.gather(h, 1) if tp.seq else h, head,
                                  ossl_lib.OSSLConfig(), proj=proj), maux


def _token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy in f32: ``logsumexp(logits) - logits[target]``.
    Logits placed as a ``DTensor`` whose vocab dim is split over the model
    axis take the vocab-parallel form (:class:`_VocabParallelCE`)."""
    tp = spmd.tensor_parallel(logits)
    if tp is not None:
        local = logits.to_local()
        if local.shape[-1] != logits.shape[-1]:
            return _VocabParallelCE.apply(local, targets, tp)
        logits = local
    logits32 = logits.float()
    gold = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
    return torch.logsumexp(logits32, dim=-1) - gold


class _VocabParallelCE(torch.autograd.Function):
    """Cross entropy of vocab-sharded logits (Megatron's pattern, f32): the
    row max and the sum of ``exp`` all-reduced over the model axis, the
    gold logit taken on the rank that holds the target and all-reduced;
    the backward is this rank's ``softmax - onehot``, with no collective.
    The ``[.., V]`` logits are never gathered."""

    @staticmethod
    def forward(ctx, local, targets, tp):
        x = local.float()
        v = x.shape[-1]
        m = tp.all_reduce(x.max(-1).values, "max")
        e = torch.exp(x - m[..., None])
        se = tp.all_reduce(e.sum(-1))
        t = targets.long() - tp.rank * v
        own = (t >= 0) & (t < v)
        tc = t.clamp(0, v - 1)
        gold = tp.all_reduce(torch.gather(x, -1, tc[..., None])[..., 0]
                             * own)
        ctx.save_for_backward(e, se, tc, own)
        ctx.dtype = local.dtype
        return torch.log(se) + m - gold

    @staticmethod
    def backward(ctx, g):
        e, se, tc, own = ctx.saved_tensors
        grad = e / se[..., None]
        grad.scatter_add_(-1, tc[..., None], -own[..., None].float())
        return (grad * g[..., None]).to(ctx.dtype), None, None


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy, in f32 (vocab-parallel for logits
    placed on the model axis, as the reference's "vocab dim may be
    model-sharded")."""
    return _token_ce(logits, targets).mean()


def _chunk_ce(h, head, t):
    return _token_ce(h @ head, t).sum()


def _chunk_ce_tp(h, head, t, tp):
    """A chunk's vocab-parallel CE from the replicated stream and this
    rank's head columns (``h``'s gradient, partial a rank, summed)."""
    return _VocabParallelCE.apply(tp.grad_sum(h) @ head, t, tp).sum()


def _chunk_ce_rows(h, head, t, tp):
    """A chunk's cross entropy from the replicated stream and this rank's
    rows of the head (``_row_logits``: the logits whole on every rank)."""
    return _token_ce(_row_logits(h, head, tp), t).sum()


def lm_loss_chunked(h: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Cross entropy over sequence chunks: each chunk's ``[B, chunk, V]``
    logits are recomputed in the backward (``checkpoint``), so the full
    ``[B, S, V]`` (and its f32 copies) never exists. ``S`` must be a
    multiple of ``chunk`` (as the reference's reshape requires). A head
    placed on the model axis: vocab-parallel over its columns, or a
    row-parallel product over its rows."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    fn, extra = _chunk_ce, ()
    tp = spmd.tensor_parallel(head)
    if tp is not None:          # the replicated stream, this rank's block
        vocab, d = head.shape[-1], head.shape[0]
        h, head = h.to_local(), head.to_local()
        if head.shape[0] != d:
            fn, extra = _chunk_ce_rows, (tp,)
        elif head.shape[-1] != vocab:
            fn, extra = _chunk_ce_tp, (tp,)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], head, targets[:, c0:c0 + chunk], *extra)
        total = total + (checkpoint(fn, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else fn(*args))
    return total / (b * s)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode step
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.swa_window) if cfg.swa_window else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda", mesh=None) -> Dict[str, Any]:
    """The decode cache, ``pos`` a host int. Attention families:
    ``{"pos": 0, "k", "v": [L, B, C, KV, dh]}``. ssm and hybrid: ``conv [L,
    B, W-1, C]`` in the config's dtype and ``ssm [L, B, H, P, N]`` in f32;
    the hybrid adds ``shared_k``/``shared_v [L // every, B, C, KV, dh]``,
    one ring per shared-block call. mixed: ``conv`` and ``ssm`` ``[n_M,
    ...]`` and ``k``, ``v`` ``[n_A, ...]``, present where the pattern has
    such layers. ``C = cache_len(cfg, max_seq)``.

    ``mesh`` (a ``DeviceMesh``; tensor parallelism): every tensor is a
    ``DTensor`` placed by ``launch.sharding.cache_shardings``, each rank
    holding its zeroed block; ``batch`` is this rank's rows, its block of
    the global batch over the DP axes."""
    _check_family(cfg)
    c, dtype = cache_len(cfg, max_seq), _dtype(cfg)
    if mesh is not None and hasattr(mesh, "get_group"):
        return _placed_cache(cfg, batch, c, mesh, device)

    def kv(n):
        return torch.zeros((n, batch, c, cfg.n_kv_heads, cfg.head_dim),
                           dtype=dtype, device=device)
    if cfg.family in ATTN_FAMILIES:
        return {"pos": 0, "k": kv(cfg.n_layers), "v": kv(cfg.n_layers)}
    if cfg.family == MIXED:
        n = cfg.kind_counts()
        cache = {"pos": 0}
        if n["M"]:
            cache.update(M.mamba2_init_cache(cfg, batch, dtype, device,
                                             lead=(n["M"],)))
        if n["*"]:
            cache["k"], cache["v"] = kv(n["*"]), kv(n["*"])
        return cache
    cache = {"pos": 0, **M.mamba2_init_cache(cfg, batch, dtype, device,
                                             lead=(cfg.n_layers,))}
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        slots = cfg.n_layers // cfg.hybrid_attn_every
        cache["shared_k"], cache["shared_v"] = kv(slots), kv(slots)
    return cache


def _placed_cache(cfg: ModelConfig, batch: int, c: int, mesh, device):
    """``init_cache``'s tree at the global batch on ``meta``, each tensor
    placed by ``cache_shardings`` as this rank's zeroed block."""
    from torch.distributed.tensor import DTensor
    from ..launch import sharding as SH
    from ..launch.mesh import axis_sizes, dp_size
    meta = init_cache(cfg, batch * dp_size(mesh), c, device="meta")
    out = {"pos": 0}
    shardings = SH.cache_shardings({k: v for k, v in meta.items()
                                    if k != "pos"}, cfg, mesh)
    for name, sh in shardings.items():
        shape = tuple(meta[name].shape)
        if axis_sizes(mesh)["model"] > 1 and "model" not in sh.spec:
            raise ValueError(f"the rules leave the {name} cache {shape} "
                             "replicated over the model axis: no dim of it "
                             "splits")
        local = torch.zeros(SH.shard_shape(sh.spec, shape, mesh),
                            dtype=meta[name].dtype, device=device)
        out[name] = DTensor.from_local(local, mesh, SH.placements(sh.spec,
                                                                  mesh),
                                       run_check=False)
    return out


_CACHE_SPLIT = {2: "slots", 4: "dh"}      # a placed [L, B, C, KV, dh] cache


def _tp_write(cache, i: int, k, v, slots, cfg: ModelConfig, tp,
              names=("k", "v")) -> None:
    """Prompt K/V ``[B, n, KV', dh]`` (this rank's heads, or all of them)
    written at ring ``slots`` (host ints) into this rank's blocks of entry
    ``i`` of the placed caches ``names``: the heads gathered whole, each
    rank keeping its own slots or head-dim block."""
    for name, x in zip(names, (k, v)):
        if x.shape[2] != cfg.n_kv_heads:
            x = tp.all_gather(x, 2)
        split = _CACHE_SPLIT.get(spmd.model_dim(cache[name]))
        local = cache[name].to_local()[i]                  # [B, C', KV, dh']
        if split == "slots":
            cl = local.shape[1]
            r0 = tp.rank * cl
            mine = [j for j, sl in enumerate(slots) if r0 <= sl < r0 + cl]
            if mine:
                dst = torch.tensor([slots[j] - r0 for j in mine],
                                   device=x.device)
                local[:, dst] = x[:, torch.tensor(mine, device=x.device)]
            continue
        dl = local.shape[-1]                               # split "dh"
        local[:, torch.tensor(slots, device=x.device)] = \
            x[..., tp.rank * dl:(tp.rank + 1) * dl]


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

    ``DTensor`` parameters (tensor parallelism): the caches are placed
    (``init_cache(mesh=)``), each mixer keeps this rank's blocks of its
    state and conv window, ``tokens`` are this rank's rows, and the logits
    come back vocab-parallel.
    """
    b, s = tokens.shape
    _check_family(cfg)
    tp, params = _enter_tp(params, cfg, s)
    with spmd.use_tp(tp):
        return _prefill(params, cfg, tokens, max_seq, attn, tp)


def _prefill(params, cfg: ModelConfig, tokens, max_seq: int, attn, tp):
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq, tokens.device,
                       mesh=None if tp is None else tp.mesh)
    h = _embed(params, cfg, tokens)
    if tp is not None and tp.seq:
        h = tp.split(h, 1)
    angles = _angles_for(cfg, None, b, s, h.device)
    attn_fn = _attn_fn(cfg, s, attn)
    c = cache_len(cfg, max_seq)
    take = min(s, c)
    slots = [(s - take + i) % c for i in range(take)]     # host ints
    ring = torch.tensor(slots, device=h.device)
    shared = params.get("shared")
    for i, r in enumerate(_cache_rows(cfg)):
        lp = _layer(params, cfg, i)
        if "mixer" not in lp:
            h, kv, _ = _block(lp, h, angles, cfg, attn_fn)
            if kv is None:                  # a mixed family's MoE layer
                continue
            k, v = kv
            ck, cv = (cache["k"][r], cache["v"][r]) if tp is None \
                else (None, None)
        else:
            o, st, tail = M.mamba2_prefill(
                lp["mixer"], _enter(L.rmsnorm(lp["norm1"], h, cfg.norm_eps)),
                cfg)
            h = h + _leave(o)
            _local(cache["ssm"])[r] = st
            _local(cache["conv"])[r] = tail
            slot = _shared_slot(cfg, shared, i)
            if slot is None:
                continue
            h, (k, v) = _shared_apply(shared, h, angles, cfg, attn_fn)
            if tp is not None:
                _tp_write(cache, slot, k[:, s - take:], v[:, s - take:],
                          slots, cfg, tp, ("shared_k", "shared_v"))
                continue
            ck, cv = cache["shared_k"][slot], cache["shared_v"][slot]
        if tp is not None:
            _tp_write(cache, r, k[:, s - take:], v[:, s - take:], slots,
                      cfg, tp)
            continue
        ck[:, ring] = k[:, s - take:]
        cv[:, ring] = v[:, s - take:]
    cache["pos"] = s
    if tp is not None and tp.seq:       # the last position, whole
        h = tp.gather(h, 1)
        tp = dataclasses.replace(tp, seq=False)
    with spmd.use_tp(tp):
        return _head(params, cfg, h[:, -1]), cache


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens [B] -> (logits [B, V], cache). The cache's
    tensors are written in place (the returned dict holds the same tensors,
    with ``pos`` advanced); nothing is read back from the device. The
    hybrid's shared block after layer ``i`` attends through ring
    ``(i + 1) // every - 1``. ``DTensor`` parameters and placed caches:
    ``layers.attn_decode_tp`` and the mixer on this rank's blocks, the
    logits vocab-parallel."""
    _check_family(cfg)
    tp, params = _enter_tp(params, cfg, 1)
    with spmd.use_tp(tp):
        return _decode_step(params, cache, tokens, cfg, tp)


def _decode_step(params, cache, tokens, cfg: ModelConfig, tp):
    h = _embed(params, cfg, tokens[:, None])                     # [B,1,D]
    b = h.shape[0]
    pos = cache["pos"]
    p1 = torch.full((b, 1), pos, device=h.device)
    angles = _angles_for(cfg, torch.stack([p1] * 3)
                         if cfg.rope_mode == "mrope" else p1, b, 1, h.device)
    shared = params.get("shared")
    for i, r in enumerate(_cache_rows(cfg)):
        lp = _layer(params, cfg, i)
        if "mixer" in lp:
            hn = L.rmsnorm(lp["norm1"], h, cfg.norm_eps)
            mc = {"conv": _local(cache["conv"])[r],
                  "ssm": _local(cache["ssm"])[r]}
            h = h + _leave(M.mamba2_decode(lp["mixer"], _enter(hn), mc,
                                           cfg)[0])
            slot = _shared_slot(cfg, shared, i)
            if slot is not None:
                h = _shared_decode(
                    shared, h, angles, _local(cache["shared_k"])[slot],
                    _local(cache["shared_v"])[slot], pos, cfg,
                    _CACHE_SPLIT.get(spmd.model_dim(cache["shared_k"])))
            continue
        if "attn" in lp:
            hn = L.rmsnorm(lp["norm1"], h, cfg.norm_eps)
            if tp is not None:
                a = L.attn_decode_tp(
                    lp["attn"], _enter(hn), angles, cache["k"].to_local()[r],
                    cache["v"].to_local()[r],
                    _CACHE_SPLIT.get(spmd.model_dim(cache["k"])), pos, cfg,
                    cfg.sparsity)
                h = h + _leave(a)
            else:
                a, _, _ = L.attn_decode(lp["attn"], hn, angles, cache["k"][r],
                                        cache["v"][r], pos, cfg, cfg.sparsity)
                h = h + a
        if "norm2" in lp:
            h = h + _ffn(lp, h, cfg)[0]
    new_cache = dict(cache, pos=pos + 1)
    return _head(params, cfg, h)[:, 0, :], new_cache
