"""Launch of the hand-written CUDA flash-attention forward
(``flash_attn.cu`` beside this file).

Replaces ``src/repro/kernels/flash_attn/kernel.py`` (``flash_fwd``, body
``_fwd_kernel``). The design note (what bounds it, how a block walks its
KV tiles) heads the CUDA source. This module holds what surrounds the
kernel and the CPU tests can reach: the grid, tile sizes and shared memory
(:func:`launch_config`), the KV tiles a query tile visits
(:func:`kv_tile_range`, mirrored from the source), argument checks, and
the launch counter.

The backward kernels (``flash_bwd``: ``_dkv_kernel``, ``_dq_kernel``) are
not ported yet: they come with LM training.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional, Tuple

import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flash_attn.cu")
THREADS = 128
TILES = {torch.bfloat16: (64, 64), torch.float32: (32, 32)}   # (query rows, keys)
PAD = 8                          # bf16 elements of row padding (bf16 path)
HEAD_DIMS = (64, 128, 160)       # head widths with a kernel instance
SMEM_LIMIT = 232448              # opt-in shared memory per block on sm_90
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    bq: int          # query rows per block
    bk: int          # keys per KV tile
    nq: int          # query tiles (grid x); grid y is B*H
    nbh: int         # batch * query heads
    smem_bytes: int


def launch_config(b: int, s: int, h: int, dh: int,
                  dtype: torch.dtype) -> LaunchConfig:
    """Grid and shared memory of one launch: one block per (batch*head,
    query tile). bf16 stages the q tile and one K and one V tile, rows
    padded by ``PAD``; f32 stages one K and one V tile."""
    if dtype not in TILES:
        raise TypeError(f"flash_fwd: no kernel for {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: no kernel instance for head width {dh} "
                         f"(have {HEAD_DIMS})")
    bq, bk = TILES[dtype]
    if dtype == torch.bfloat16:
        smem = 2 * (bq + 2 * bk) * (dh + PAD)
    else:
        smem = 4 * 2 * bk * dh
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_fwd: head width {dh} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    return LaunchConfig(bq=bq, bk=bk, nq=-(-s // bq), nbh=b * h,
                        smem_bytes=smem)


def kv_tile_range(q0: int, q1: int, t: int, window: Optional[int],
                  bk: int) -> Tuple[int, int]:
    """KV tiles ``[lo, hi)`` the block of query rows ``[q0, q1)`` visits:
    those holding a key ``j <= q1 - 1`` and, with a window,
    ``j >= q0 - window + 1`` (``kv_tile_range`` in ``flash_attn.cu``)."""
    end = min(t, q1)
    start = max(0, q0 - window + 1) if window is not None else 0
    return start // bk, -(-end // bk)


@functools.cache
def _lib():
    from .._build import load_library
    lib = load_library("flash_attn", SOURCE)
    lib.flash_fwd_launch.restype = ctypes.c_int
    lib.flash_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 7
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_fwd_tiles.restype = None
    lib.flash_fwd_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
    tiles = (ctypes.c_int * 6)()
    lib.flash_fwd_tiles(tiles)
    want = (THREADS, *TILES[torch.bfloat16], PAD, *TILES[torch.float32])
    if tuple(tiles) != want:
        raise RuntimeError(f"flash_attn.cu tiles {tuple(tiles)} disagree with "
                           f"kernel.py {want}")
    return lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _lib()


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention on the card in the model layout: ``q [B, S, H, dh]``,
    ``k, v [B, T, KV, dh]`` of one dtype (f32 or bf16), ``H`` a multiple of
    ``KV``, the last dim contiguous and every other stride a multiple of 16
    bytes. Returns ``(out [B, S, H, dh], lse [B*H, S] f32)``. Raises on
    anything else."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd: need q [B,S,H,dh], k/v [B,T,KV,dh]")
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, t, kvh, dh) or v.shape != k.shape \
            or kvh == 0 or h % kvh:
        raise ValueError(f"flash_fwd: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd: q/k/v must share f32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_fwd: window must be >= 1, got {window}")
    es = q.element_size()
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_cuda or a.device != q.device:
            raise ValueError(f"flash_fwd: {name} is not on {q.device}")
        if a.stride(3) != 1 or any(st * es % 16 for st in a.stride()[:3]) \
                or a.data_ptr() % 16:
            raise ValueError(f"flash_fwd: {name} needs a contiguous last dim "
                             f"and 16-byte aligned rows, strides {a.stride()}")
    if t == 0 and q.numel():
        raise ValueError("flash_fwd: no keys to attend to")
    cfg = launch_config(b, s, h, dh, q.dtype)
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse          # nothing to compute: no launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], b, s, t, h, kvh, dh,
            window or 0, dh ** -0.5, cfg.nq, cfg.smem_bytes,
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0
