"""Public flash-attention op (``repro.kernels.flash_attn.ops``).

``flash_attention(q, k, v, window)`` takes and returns the model layout
(q ``[B,S,H,dh]``, k/v ``[B,S,KV,dh]``). Dispatch is by the tensor's
device: a CUDA tensor launches the hand-written kernel
(``kernel.flash_fwd_cuda``), which reads K/V per GQA group through strides,
or raises; a CPU tensor runs the plain ``ref.attention``, as the
reference falls back off the TPU. There is no fallback between them.

On the card the forward saves ``q, k, v, out, lse`` and the backward
computes ``delta = rowsum(dout·out)`` in torch and launches the two
backward kernels (``kernel.flash_bwd_dkv_cuda``, which sums each GQA
group's dK/dV in f32, inside the kernel or over its head split's partials,
and ``kernel.flash_bwd_dq_cuda``); ``dout``
is copied only where its rows break the kernels' 16-byte rule. On the CPU
gradients flow through the plain version (the reference's ``_vjp_bwd`` ref
branch). Under tensor parallelism the op runs on each rank's own heads:
``models/layers`` hands it the local blocks, so a CUDA block launches the
kernels; a ``DTensor`` is refused.

``_to_kernel_layout`` / ``_from_kernel_layout`` (the reference's
``[B·H, S, dh]`` layout with K/V broadcast per group) stay for the tests,
which hold the kernel-layout functions of both packages against each
other; the op itself needs no transpose. ``hbm_bytes`` and
``xla_score_path_bytes`` are the reference's traffic models, copied.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref


def _to_kernel_layout(q, k, v):
    b, s, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qk = q.transpose(1, 2).reshape(b * h, s, dh)
    t = k.shape[1]
    kk = k.transpose(1, 2)[:, :, None].expand(b, kv, g, t, dh).reshape(b * h, t, dh)
    vk = v.transpose(1, 2)[:, :, None].expand(b, kv, g, t, dh).reshape(b * h, t, dh)
    return qk, kk, vk


def _from_kernel_layout(o, b, s, h, dh):
    return o.reshape(b, h, s, dh).transpose(1, 2)


def bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dout·out)`` of model-layout ``[B, S, H, dh]``
    tensors, in f32 as the backward kernels read it: contiguous
    ``[B·H, S]``."""
    b, s, h, _ = out.shape
    return (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous().view(b * h, s)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        if q.is_cuda:
            from .kernel import flash_fwd_cuda
            out, lse = flash_fwd_cuda(q, k, v, window)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return ref.attention(q, k, v, window)

    @staticmethod
    def backward(ctx, dout):
        if dout.is_cuda:
            from .kernel import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                 row_aligned)
            q, k, v, out, lse = ctx.saved_tensors
            if not row_aligned(dout):
                dout = dout.contiguous()
            delta = bwd_delta(out, dout)     # outside the kernels, as there
            dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, ctx.window)
            dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, ctx.window)
            return dq, dk, dv, None
        q, k, v = (a.detach().requires_grad_() for a in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.attention(q, k, v, ctx.window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention, model layout in and out. Under tensor
    parallelism the caller hands each rank's own heads as plain tensors;
    a ``DTensor`` raises (the kernels take raw pointers)."""
    if any(hasattr(x, "to_local") for x in (q, k, v)):
        raise TypeError("flash_attention takes plain tensors: under tensor "
                        "parallelism each rank's own heads (the local "
                        "blocks), not DTensors")
    return _FlashAttention.apply(q, k, v, window)


def hbm_bytes(b: int, s: int, h: int, dh: int, *, bq: int = 128, bk: int = 128,
              dtype_bytes: int = 2, causal: bool = True,
              with_backward: bool = True) -> int:
    """Exact HBM traffic of the reference's flash kernels from their
    BlockSpec schedule: per (n, i) the q block loads once; k/v blocks load
    per visited (i, j) pair (only j <= i under the causal mask)."""
    n = b * h
    nq, nk = s // bq, s // bk
    tiles = (nq * (nq + 1)) // 2 if causal and nq == nk else nq * nk
    f32 = 4
    fwd = (n * s * dh * dtype_bytes                 # q once
           + 2 * n * tiles * bk * dh * dtype_bytes  # k, v per visited tile
           + n * s * dh * dtype_bytes               # out
           + n * s * f32)                           # lse
    if not with_backward:
        return fwd
    # dkv kernel: k/v/dk/dv once per (n, j); q/do/lse/delta per visited tile
    dkv = (4 * n * s * dh * dtype_bytes
           + 2 * n * tiles * bq * dh * dtype_bytes
           + 2 * n * tiles * bq * f32)
    # dq kernel: q/do/dq once per (n, i); k/v per visited tile
    dq = (3 * n * s * dh * dtype_bytes
          + 2 * n * tiles * bk * dh * dtype_bytes
          + 2 * n * s * f32)
    return fwd + dkv + dq


def xla_score_path_bytes(b: int, s: int, h: int, dh: int,
                         dtype_bytes: int = 2) -> int:
    """HBM traffic of the unfused score path: scores f32 write+read, probs
    write+read (fwd), and the backward's recompute + dprobs/dscores round
    trips — what flash removes."""
    n = b * h
    f32 = 4
    s2 = n * s * s
    fwd = s2 * (f32 + f32 + dtype_bytes + dtype_bytes)
    bwd = 2 * fwd + s2 * 2 * f32
    return fwd + bwd
