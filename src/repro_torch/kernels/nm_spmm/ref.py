"""Plain torch version of the block-N:M sparse matmul (``repro.kernels.nm_spmm.ref``).

Layouts (shared with kernel.py / ops.py):

* ``x``         : [B, K] activations.
* ``w_compact`` : [J, T, bk, bo] — for each of J output tiles (bo columns),
                  the T kept K-blocks of bk rows each.
* ``idx``       : [J, T] int32 — global K-block index of each kept block.

``y[:, j·bo:(j+1)·bo] = Σ_t x[:, idx[j,t]·bk : +bk] @ w_compact[j, t]``.

The serving path adds each row's own compact delta ``[S, J, T, bk, bo]`` on
the same ``idx`` (:func:`nm_spmm_deltas`); :func:`nm_spmm_fused` is the
base and that delta product, summed as the kernel sums them.
"""
from __future__ import annotations

import torch


def densify(w_compact: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Compact [J, T, bk, bo] + idx [J, T] -> dense [K, O] with zeros."""
    j, t, bk, bo = w_compact.shape
    dense = torch.zeros((k // bk, j, bk, bo), dtype=w_compact.dtype,
                        device=w_compact.device)
    jj = torch.arange(j, device=idx.device)[:, None].expand(j, t)
    dense.index_put_((idx.long(), jj), w_compact)       # ids are distinct per tile
    return dense.permute(0, 2, 1, 3).reshape(k, j * bo)


def nm_spmm(x: torch.Tensor, w_compact: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """Gather the kept x blocks, then one dense product per out tile."""
    j, t, bk, bo = w_compact.shape
    b, k = x.shape
    xg = x.reshape(b, k // bk, bk)[:, idx, :]               # [B, J, T, bk]
    y = torch.einsum("bjtk,jtko->bjo", xg, w_compact)
    return y.reshape(b, j * bo)


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


def nm_spmm_fused(x: torch.Tensor, w_compact: torch.Tensor, idx: torch.Tensor,
                  delta_compact: torch.Tensor) -> torch.Tensor:
    """The shared base and each row's compact delta: ``nm_spmm(x, w_compact,
    idx) + nm_spmm_deltas(x, delta_compact, idx)``, in that association."""
    return nm_spmm(x, w_compact, idx) + nm_spmm_deltas(x, delta_compact, idx)
