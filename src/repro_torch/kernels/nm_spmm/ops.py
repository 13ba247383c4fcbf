"""Public ops for the block-N:M sparse matmul (``repro.kernels.nm_spmm.ops``).

Dispatch is by the tensor's device: a CPU tensor runs the plain torch
version in ``ref.py``; a CUDA tensor launches the hand-written kernel
(``kernel.nm_spmm_cuda``) or raises. There is no fallback between them.
The per-slot ``nm_spmm_deltas`` has no kernel in the reference either, so
it is plain torch on every device.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref


def nm_spmm_batched(x: torch.Tensor, w_compact: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Forward product for any row count (no autograd). Ragged rows are
    masked inside the CUDA kernel, so nothing is padded here."""
    if x.is_cuda:
        from .kernel import nm_spmm_cuda
        return nm_spmm_cuda(x, w_compact, idx)
    return ref.nm_spmm(x, w_compact, idx)


class _NMSpmm(torch.autograd.Function):
    """Sparse-to-sparse gradients: ``dx`` scatters transposed block products
    into the kept rows only, ``dw_compact`` exists only for kept blocks."""

    @staticmethod
    def forward(ctx, x, w_compact, idx):
        ctx.save_for_backward(x, w_compact, idx)
        return nm_spmm_batched(x, w_compact, idx)

    @staticmethod
    def backward(ctx, dy):
        x, w_compact, idx = ctx.saved_tensors
        j, t, bk, bo = w_compact.shape
        b, k = x.shape
        dyt = dy.reshape(b, j, bo)
        dxg = torch.einsum("bjo,jtko->bjtk", dyt, w_compact)      # [B, J, T, bk]
        dxb = torch.zeros((b, k // bk, bk), dtype=x.dtype, device=x.device)
        dxb.index_add_(1, idx.reshape(-1).long(),
                       dxg.reshape(b, j * t, bk).to(x.dtype))
        xg = x.reshape(b, k // bk, bk)[:, idx, :]                  # [B, J, T, bk]
        dwc = torch.einsum("bjtk,bjo->jtko", xg, dyt).to(w_compact.dtype)
        return dxb.reshape(b, k), dwc, None


def nm_spmm(x: torch.Tensor, w_compact: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """Differentiable block-N:M product (the reference's ``custom_vjp`` op)."""
    return _NMSpmm.apply(x, w_compact, idx)


def make_compact(w_dense: torch.Tensor, unit_mask: torch.Tensor, bk: int,
                 bo: int, n_kept: Optional[int] = None):
    """Dense [K, O] + unit mask [K/bk, O/bo] -> (w_compact [J,T,bk,bo], idx [J,T] int32).

    Kept block ids come from a stable argsort of ``~mask`` (kept units
    first, ascending), cast to int first since torch does not sort bool;
    the reference orders them the same way, so both packages agree on
    ``idx`` exactly. ``n_kept`` (= G·n from the spec) skips reading the
    count off the mask.
    """
    k, o = w_dense.shape
    kb, j = unit_mask.shape
    if kb != k // bk or j != o // bo:
        raise ValueError(f"mask {tuple(unit_mask.shape)} does not tile "
                         f"[{k}, {o}] by ({bk}, {bo})")
    t = int(unit_mask[:, 0].sum()) if n_kept is None else n_kept
    order = torch.argsort((~unit_mask).to(torch.int8), dim=0, stable=True)
    idx = order[:t].T.to(torch.int32).contiguous()                     # [J, T]
    wb = w_dense.reshape(kb, bk, j, bo).permute(2, 0, 1, 3)            # [J, KB, bk, bo]
    w_compact = torch.take_along_dim(wb, idx.long()[:, :, None, None], dim=1)
    return w_compact.contiguous(), idx


def nm_spmm_deltas(x: torch.Tensor, delta_compact: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """Per-slot compact delta product: ``y[s] = x[s] @ densify(delta[s])``.

    ``x [S, K]`` with per-slot compact deltas ``[S, J, T, bk, bo]`` sharing
    one ``idx [J, T]``; the per-stream current never passes through a dense
    ``[K, N]`` tensor.
    """
    s, k = x.shape
    _, j, t, bk, bo = delta_compact.shape
    xg = x.reshape(s, k // bk, bk)[:, idx, :]                      # [S, J, T, bk]
    y = torch.einsum("sjtk,sjtko->sjo", xg, delta_compact)
    return y.reshape(s, j * bo)
