"""Public ops for the block-N:M sparse matmul (``repro.kernels.nm_spmm.ops``).

Dispatch is by the tensor's device: a CPU tensor runs the plain torch
version in ``ref.py``; a CUDA tensor launches the hand-written kernel
(``kernel.nm_spmm_cuda``, ``kernel.nm_spmm_fused_cuda``) or raises. There is
no fallback between them. The per-slot ``ref.nm_spmm_deltas`` has no
kernel of its own (none in the reference either): on the card it runs fused
into the base product (:func:`nm_spmm_fused`); alone it is the plain
version and the tests' oracle.
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


def nm_spmm_fused(x: torch.Tensor, w_compact: torch.Tensor,
                  idx: torch.Tensor, delta_compact: torch.Tensor) -> torch.Tensor:
    """The serving forward current in one pass: the shared base product plus
    each row's compact delta ``[S, J, T, bk, bo]`` on the same ``idx``
    (``ref.nm_spmm_fused``). On the card: one launch of the gather kernel,
    which takes bk = bo = 1."""
    if x.is_cuda:
        from .kernel import nm_spmm_fused_cuda
        return nm_spmm_fused_cuda(x, w_compact, idx, delta_compact)
    return ref.nm_spmm_fused(x, w_compact, idx, delta_compact)
