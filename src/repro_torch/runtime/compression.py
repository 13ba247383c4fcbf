"""Gradient compression for the data-parallel all-reduce, with error
feedback (``repro.runtime.compression``).

Two compressors, both with **error feedback** (the residual of this
step's compression is added to the next step's gradient):

* ``int8`` — per-256-chunk absmax scaling, 4× over f32, 2× over bf16;
* ``topk`` — keep the top ``frac`` magnitudes per leaf (f32 values and
  int32 indices).

Payloads equal the reference's bit for bit: ``torch.round`` rounds half to
even as ``jnp.round`` does, and the scale is the reference's f32
``max|chunk| / 127 + 1e-12``, a true division on the card too (a tensor
divisor: CUDA turns a division by a Python scalar into a product with its
reciprocal). ``jax.lax.top_k`` puts the lower index first
among equal magnitudes, which ``torch.topk`` does not promise; top-k here
takes the k-th largest magnitude from ``torch.topk``, orders the indices
above it by a stable descending sort and appends the lowest indices equal
to it, so the payload (values, indices and their order) is the
reference's.

``ErrorFeedback.step`` wraps either around a gradient tree (nested dicts,
``None`` at the integer leaves, as ``launch/train`` gives them).

``compressed_mean`` is the compressed DP all-reduce, the reference's
pattern ``pmean(decompress(compress(g)))`` over the data axis: each rank
compresses its leaves (with error feedback, given an ``ErrorFeedback``),
the payloads are all-gathered over the DP process groups, and every rank
decompresses each rank's payload and sums them in rank order, so that
every rank holds the same mean bit for bit. ``make_train_step`` does not
call it (the reference's step does not compress either); a caller swaps it
in for ``DataParallel.mean_grads``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..optim.optimizer import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "int8"          # "int8" | "topk" | "none"
    chunk: int = 256
    topk_frac: float = 0.05


class Compressed(NamedTuple):
    payload: Any
    meta: Any


def _int8_compress(g: torch.Tensor, chunk: int) -> Compressed:
    flat = g.float().reshape(-1)
    pad = (-flat.numel()) % chunk
    chunks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, chunk)
    amax = chunks.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds otherwise than the reference's division
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(chunks / scale), -127, 127).to(torch.int8)
    return Compressed((q, scale), (tuple(g.shape), pad))


def _int8_decompress(c: Compressed) -> torch.Tensor:
    (q, scale), (shape, pad) = c.payload, c.meta
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def topk_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of the 1-d ``a``, largest first, the
    lower index first among equals (``jax.lax.top_k``'s order), int64.
    Only the elements above the k-th largest value are sorted; those equal
    to it follow in index order."""
    kth = torch.topk(a, k, sorted=False).values.min()
    gt = torch.nonzero(a > kth).reshape(-1)                 # ascending
    eq = torch.nonzero(a == kth).reshape(-1)[:k - gt.numel()]
    order = torch.sort(a[gt], descending=True, stable=True).indices
    return torch.cat([gt[order], eq])


def _topk_compress(g: torch.Tensor, frac: float) -> Compressed:
    flat = g.float().reshape(-1)
    k = max(1, int(flat.numel() * frac))
    idx = topk_indices(flat.abs(), k)
    return Compressed((flat[idx], idx.to(torch.int32)),
                      (tuple(g.shape), flat.numel()))


def _topk_decompress(c: Compressed) -> torch.Tensor:
    (vals, idx), (shape, size) = c.payload, c.meta
    out = torch.zeros((size,), dtype=torch.float32, device=vals.device)
    out[idx.long()] = vals
    return out.reshape(shape)


def compress(g: torch.Tensor, cfg: CompressionConfig) -> Compressed:
    if cfg.kind == "int8":
        return _int8_compress(g, cfg.chunk)
    if cfg.kind == "topk":
        return _topk_compress(g, cfg.topk_frac)
    return Compressed(g, None)


def decompress(c: Compressed, cfg: CompressionConfig) -> torch.Tensor:
    if cfg.kind == "int8":
        return _int8_decompress(c)
    if cfg.kind == "topk":
        return _topk_decompress(c)
    return c.payload


def compressed_bytes(c: Compressed, cfg: CompressionConfig) -> int:
    """Bytes on the wire, counted as the reference counts them: int8 plus
    an f32 scale a chunk; f32 values plus int32 indices."""
    if cfg.kind == "int8":
        q, scale = c.payload
        return q.numel() + scale.numel() * 4
    if cfg.kind == "topk":
        vals, idx = c.payload
        return vals.numel() * 4 + idx.numel() * 4
    return c.payload.numel() * c.payload.element_size()


class ErrorFeedback(NamedTuple):
    """Per-leaf residual memory. g_eff = g + e; e' = g_eff - decomp(comp(g_eff))."""
    residual: Any

    @staticmethod
    def init(grads) -> "ErrorFeedback":
        return ErrorFeedback(tree_map(
            lambda g: None if g is None else torch.zeros(
                g.shape, dtype=torch.float32, device=g.device), grads))

    def step(self, grads, cfg: CompressionConfig) -> Tuple[Any, "ErrorFeedback"]:
        """Returns (compressed-then-decompressed grads, new state)."""
        def one(g, e):
            if g is None:
                return None, None
            geff = g.float() + e
            rec = decompress(compress(geff, cfg), cfg)
            return rec.to(g.dtype), geff - rec

        out = tree_map(one, grads, self.residual)
        return _unzip(out, 0), ErrorFeedback(_unzip(out, 1))


def _unzip(tree, i):
    """Element ``i`` of every ``(rec, residual)`` pair of a tree of pairs."""
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return tree[i]


def _gather(x: torch.Tensor, groups: Sequence[Any]) -> List[torch.Tensor]:
    """``x`` of every rank of ``groups`` (``data`` first, then ``pod``), in
    DP-rank order (``pod`` major)."""
    import torch.distributed as dist
    parts = [x.contiguous()]
    for g in groups:
        n = dist.get_world_size(g)
        stacked = torch.stack(parts)
        out = [torch.empty_like(stacked) for _ in range(n)]
        dist.all_gather(out, stacked, group=g)
        parts = [p for o in out for p in o.unbind(0)]
    return parts


def _payload_parts(c: Compressed) -> Tuple[torch.Tensor, ...]:
    return c.payload if isinstance(c.payload, tuple) else (c.payload,)


def compressed_mean(grads, cfg: CompressionConfig, groups: Sequence[Any],
                    ef: Optional[ErrorFeedback] = None):
    """``(mean, ef')``: every float leaf of ``grads`` replaced by the mean
    over the DP ranks of ``decompress(compress(g + e))`` (``e`` the
    residual of ``ef``, else 0), in the leaf's dtype; ``ef'`` the new
    residuals (None without ``ef``). ``groups``: the DP process groups
    (``launch.spmd.dp_groups(mesh)``); none gives this rank's own
    reconstruction. The payload parts of every leaf are packed into one
    buffer a part dtype and all-gathered together (an int8 payload: int8
    values and f32 scales; a top-k one: f32 values and int32 indices), and
    each rank's reconstructions are summed in rank order, then divided by
    the number of ranks."""
    live = [g for g in tree_leaves(grads) if g is not None]
    res = [None] * len(live) if ef is None else \
        [e for e in tree_leaves(ef.residual) if e is not None]
    geff = [g.float() if e is None else g.float() + e
            for g, e in zip(live, res)]
    comps = [compress(g, cfg) for g in geff]
    # pack: one flat buffer for each payload part, the leaves in order
    n_parts = len(_payload_parts(comps[0])) if comps else 0
    packed = [torch.cat([_payload_parts(c)[i].reshape(-1) for c in comps])
              for i in range(n_parts)]
    gathered = [_gather(buf, groups) for buf in packed]
    n_ranks = len(gathered[0]) if gathered else 1
    sums: List[Optional[torch.Tensor]] = [None] * len(comps)
    for r in range(n_ranks):
        offs = [0] * n_parts
        for j, c in enumerate(comps):
            parts = []
            for i, p in enumerate(_payload_parts(c)):
                parts.append(gathered[i][r][offs[i]:offs[i] + p.numel()]
                             .view(p.shape))
                offs[i] += p.numel()
            rec = decompress(Compressed(
                tuple(parts) if isinstance(c.payload, tuple) else parts[0],
                c.meta), cfg).float()
            sums[j] = rec if sums[j] is None else sums[j].add_(rec)
    # a tensor divisor, as _int8_compress's: the same rounding on every
    # device
    means = iter([s.div_(torch.full_like(s, float(n_ranks))).to(g.dtype)
                  for s, g in zip(sums, live)])
    mean = tree_map(lambda g: None if g is None else next(means), grads)
    if ef is None:
        return mean, None
    resid = iter([g - decompress(c, cfg) for g, c in zip(geff, comps)])
    return mean, ErrorFeedback(tree_map(
        lambda g: None if g is None else next(resid), grads))
