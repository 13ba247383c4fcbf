"""Plain torch versions of causal (optionally sliding-window) GQA attention
(``repro.kernels.flash_attn.ref`` and what ``kernel.flash_fwd`` computes).

``attention`` is the reference's oracle in model layout, f32 softmax.
``flash_fwd`` is the CUDA kernel's plain version in the kernel layout
``[N, S, dh]``: the same arithmetic as the Pallas ``_fwd_kernel`` done in
one pass instead of over tiles, returning ``(out, lse)``.
``bf16_out_tolerance`` is the per-element bound within which the kernel's
bf16 ``out`` must agree with ``flash_fwd``'s. ``flash_bwd`` is the plain
version of the two backward kernels (``_dkv_kernel``, ``_dq_kernel``) in
the same layout, and ``bf16_grad_tolerance`` with ``bwd_rounding_sigmas``
the per-element bound for their bf16 gradients.
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


def _bwd_parts(q, k, v, out, lse, dout, window):
    """The backward's f32 tiles in one pass: ``(qf, kf, dof, p, ds)``."""
    dh = q.shape[-1]
    scale = dh ** -0.5
    qf, kf, vf, dof = (a.float() for a in (q, k, v, dout))
    delta = (dof * out.float()).sum(-1)                          # [N, S]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    ok = causal_ok(q.shape[1], k.shape[1], window, q.device)
    p = torch.exp(torch.where(ok, s, NEG_INF) - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return qf, kf, dof, p, ds


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, out, dout [N,S,dh], k/v [N,T,dh], lse [N,S] f32 -> (dq, dk, dv) in
    the inputs' dtypes, per query head (the reference's layout: the caller
    sums a GQA group's dk/dv).

    With ``delta = rowsum(dout·out)``: ``s = (q·kᵀ)·dh^-0.5`` masked to
    ``NEG_INF``, ``p = exp(s - lse)``, ``dv = pᵀ·dout``, ``dp = dout·vᵀ``,
    ``ds = p·(dp - delta)·dh^-0.5``, ``dk = dsᵀ·q``, ``dq = ds·k``: f32
    products and sums throughout (the kernel rounds ``p`` and ``ds`` to bf16
    for its products on bf16 inputs; :func:`bf16_grad_tolerance`).
    """
    qf, kf, dof, p, ds = _bwd_parts(q, k, v, out, lse, dout, window)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dq = torch.matmul(ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_rounding_sigmas(q, k, v, out, lse, dout, window=None):
    """Per element of ``(dq, dk, dv)`` (layout of :func:`flash_bwd`, f32),
    the root sum of squares of the terms the kernel rounds to bf16 before
    its product: ``sqrt(ds²·k²)``, ``sqrt(dsᵀ²·q²)``, ``sqrt(pᵀ²·dout²)``.
    Summed in squares over a GQA group, they scale the spread of the
    kernel's bf16 rounding noise (:func:`bf16_grad_tolerance`)."""
    qf, kf, dof, p, ds = _bwd_parts(q, k, v, out, lse, dout, window)
    ds2, p2 = ds * ds, p * p
    return (torch.matmul(ds2, kf * kf).sqrt(),
            torch.matmul(ds2.transpose(-1, -2), qf * qf).sqrt(),
            torch.matmul(p2.transpose(-1, -2), dof * dof).sqrt())


def bf16_grad_tolerance(grad: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Per-element bound on ``|grad_kernel - grad|`` for a bf16 gradient of
    the backward kernels against the f32 plain version ``grad`` (GQA groups
    summed in f32), with ``sigma`` from :func:`bwd_rounding_sigmas`.

    ``2^-7·|grad|`` is one bf16 ulp of the element: the kernel rounds its
    f32 sum once. ``2^-6·sigma`` bounds the rounding inside: the kernel
    rounds each ``p`` (for dv) or ``ds`` (for dk, dq) to bf16, a relative
    error of at most ``2^-8`` with random sign, so the error of the sum has
    a spread of about ``2^-9·sigma``; the bound is eight times that.
    ``2^-16·max|grad|`` covers f32 sums taken in another order where
    ``dp - delta`` cancels (the first query row, whose ``out`` is one row
    of ``v``: its ``ds`` is rounding noise on both sides). A query tile or
    a GQA head left out of a dk/dv sum, or a KV tile out of a dq sum, moves
    the element by a share of ``sigma`` itself, far past the bound
    (``tests/test_torch_flash.py`` plants each).
    """
    g = grad.float().abs()
    return 2 ** -7 * g + 2 ** -6 * sigma + 2 ** -16 * g.max()
