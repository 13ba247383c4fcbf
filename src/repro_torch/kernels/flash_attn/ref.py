"""Plain torch versions of causal (optionally sliding-window) GQA attention
(``repro.kernels.flash_attn.ref`` and what ``kernel.flash_fwd`` computes).

``attention`` is the reference's oracle in model layout, f32 softmax.
``flash_fwd`` is the CUDA kernel's plain version in the kernel layout
``[N, S, dh]``: the same arithmetic as the Pallas ``_fwd_kernel`` done in
one pass instead of over tiles, returning ``(out, lse)``.
``bf16_out_tolerance`` is the per-element bound within which the kernel's
bf16 ``out`` must agree with ``flash_fwd``'s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30          # the reference kernel's mask value


def causal_ok(s: int, t: int, window: Optional[int], device) -> torch.Tensor:
    """bool ``[S, T]``: key ``j`` is visible from query ``i`` (``j <= i``,
    and ``i - j < window`` when a window is given)."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    ok = j <= i
    if window is not None:
        ok &= (i - j) < window
    return ok


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """q [B,S,H,dh], k/v [B,S,KV,dh] -> [B,S,H,dh]. Causal."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / (dh ** 0.5)
    ok = causal_ok(s, s, window, q.device)
    scores = torch.where(ok, scores.float(), float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [N,S,dh], k/v [N,T,dh] -> (out [N,S,dh] in q's dtype, lse [N,S] f32).

    ``s = (q·kᵀ)·dh^-0.5`` with f32 products and sums, masked to
    ``NEG_INF``; ``p = exp(s - m)`` in f32, summed in f32 for ``l``
    (clamped at 1e-30) and cast to v's dtype for the ``p·v`` product
    (f32 sums); ``lse = m + log l``.
    """
    dh = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    ok = causal_ok(q.shape[1], k.shape[1], window, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l[..., None]).to(q.dtype)
    return out, m + torch.log(l)


def bf16_out_tolerance(out: torch.Tensor) -> torch.Tensor:
    """Per-element bound on ``|out_kernel - out|`` for a bf16 ``out`` of
    :func:`flash_fwd` (any layout with ``dh`` last).

    ``2^-7·|out|`` is one bf16 ulp of the element: both sides round an f32
    value to bf16. ``2^-6·rms`` of the element's row (over ``dh``) bounds
    the rest: the kernel rounds each ``p`` to bf16 (relative ``2^-9``)
    against its running max, this version against the final max, so the
    two sums differ by independent rounding terms whose spread is about
    ``2^-9·rms``; the bound is eight times that. One KV tile left out of a
    late row moves most of its elements past the bound
    (``tests/test_torch_flash.py`` plants one).
    """
    o = out.float()
    rms = o.pow(2).mean(-1, keepdim=True).sqrt()
    return 2 ** -7 * o.abs() + 2 ** -6 * rms
