"""Launch of the hand-written CUDA flash-attention kernels: the forward
(``flash_attn.cu``) and the two backward kernels (``flash_bwd.cu``), each
source its own library, so the two build in parallel.

Replaces ``src/repro/kernels/flash_attn/kernel.py``: ``flash_fwd`` (body
``_fwd_kernel``) and ``flash_bwd`` (``_dkv_kernel``, ``_dq_kernel``). The
design notes (what bounds each kernel, how a block walks its tiles) head
the CUDA sources. This module holds what surrounds the kernels and the CPU
tests can reach: grids, tile sizes and shared memory (:func:`launch_config`,
:func:`bwd_launch_config`), the tiles a block visits (:func:`kv_tile_range`,
:func:`q_tile_range`, mirrored from the sources), argument checks, and one
launch counter per kernel.
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


def row_aligned(a: torch.Tensor) -> bool:
    """Whether the kernels can read ``a`` through its strides: a contiguous
    last dim, every other stride and the base a multiple of 16 bytes."""
    es = a.element_size()
    return (a.stride(-1) == 1 and a.data_ptr() % 16 == 0
            and not any(st * es % 16 for st in a.stride()[:-1]))


def _check_qkv(what: str, q, k, v, window, **more) -> Tuple[int, int, int, int]:
    """Shapes, dtypes, devices and strides of the model-layout operands
    (``more``: further tensors laid out as ``q``). Returns ``(B, S, H, dh)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: need q [B,S,H,dh], k/v [B,T,KV,dh]")
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, t, kvh, dh) or v.shape != k.shape \
            or kvh == 0 or h % kvh \
            or any(a.shape != q.shape for a in more.values()):
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         + " ".join(f"{n}{tuple(a.shape)}" for n, a in more.items()))
    tensors = {"q": q, "k": k, "v": v, **more}
    if q.dtype not in _DTYPES or any(a.dtype != q.dtype for a in tensors.values()):
        raise TypeError(f"{what}: operands must share f32 or bf16, got "
                        + "/".join(str(a.dtype) for a in tensors.values()))
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    for name, a in tensors.items():
        if not a.is_cuda or a.device != q.device:
            raise ValueError(f"{what}: {name} is not on {q.device}")
        if not row_aligned(a):
            raise ValueError(f"{what}: {name} needs a contiguous last dim "
                             f"and 16-byte aligned rows, strides {a.stride()}")
    if t == 0 and q.numel():
        raise ValueError(f"{what}: no keys to attend to")
    return b, s, h, dh


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention on the card in the model layout: ``q [B, S, H, dh]``,
    ``k, v [B, T, KV, dh]`` of one dtype (f32 or bf16), ``H`` a multiple of
    ``KV``, the last dim contiguous and every other stride a multiple of 16
    bytes. Returns ``(out [B, S, H, dh], lse [B*H, S] f32)``. Raises on
    anything else."""
    b, s, h, dh = _check_qkv("flash_fwd", q, k, v, window)
    t, kvh = k.shape[1], k.shape[2]
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


# ---------------------------------------------------------------------------
# backward: flash_bwd.cu (dK/dV and dQ)
# ---------------------------------------------------------------------------

BWD_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "flash_bwd.cu")
# bf16 (mma.sync): dK/dV blocks of 64 keys over 32-query tiles, dQ blocks of
# 64 queries over 32-key tiles; f32 (FMA): 32 rows and 32-row tiles for both
BWD_TILES = {torch.bfloat16: {"dkv": (64, 32), "dq": (64, 32)},
             torch.float32: {"dkv": (32, 32), "dq": (32, 32)}}


@dataclasses.dataclass(frozen=True)
class BwdLaunchConfig:
    block_rows: int  # keys (dK/dV) or queries (dQ) a block owns
    tile: int        # queries (dK/dV) or keys (dQ) per inner tile
    grid: Tuple[int, int]
    smem_bytes: int


def bwd_launch_config(which: str, b: int, s: int, t: int, h: int, kvh: int,
                      dh: int, dtype: torch.dtype) -> BwdLaunchConfig:
    """Grid and shared memory of one backward launch. ``which="dkv"``: one
    block per (batch·KV head, key tile), grid ``(B·KV, key tiles)``; bf16
    stages its K and V tiles and one q and one do tile (rows padded by
    ``PAD``) plus the tile's lse and delta, f32 the q, do, lse and delta
    tiles. ``which="dq"``: one block per (query tile, batch·head), grid
    ``(query tiles, B·H)``; bf16 stages its q and do tiles and one K and one
    V tile, f32 one K and one V tile."""
    if dtype not in BWD_TILES:
        raise TypeError(f"flash_bwd: no kernel for {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_bwd: no kernel instance for head width {dh} "
                         f"(have {HEAD_DIMS})")
    rows, tile = BWD_TILES[dtype][which]
    if dtype == torch.bfloat16:
        smem = 2 * 2 * (rows + tile) * (dh + PAD) + (8 * tile if which == "dkv" else 0)
    else:
        smem = 4 * 2 * tile * dh + (8 * tile if which == "dkv" else 0)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_bwd: head width {dh} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    grid = ((b * kvh, -(-t // rows)) if which == "dkv"
            else (-(-s // rows), b * h))
    return BwdLaunchConfig(block_rows=rows, tile=tile, grid=grid, smem_bytes=smem)


def q_tile_range(k0: int, k1: int, s: int, window: Optional[int],
                 bq: int) -> Tuple[int, int]:
    """Query tiles ``[lo, hi)`` the dK/dV block of keys ``[k0, k1)`` visits:
    those holding a row ``i >= k0`` and, with a window, ``i <= k1 - 2 +
    window``, all below ``s`` (``q_tile_range`` in ``flash_bwd.cu``)."""
    end = min(s, k1 - 1 + window) if window is not None else s
    return k0 // bq, -(-end // bq)


@functools.cache
def _bwd_lib():
    from .._build import load_library
    lib = load_library("flash_bwd", BWD_SOURCE)
    lib.flash_bwd_launch.restype = ctypes.c_int
    lib.flash_bwd_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 18
        + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    lib.flash_bwd_tiles.restype = None
    lib.flash_bwd_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
    tiles = (ctypes.c_int * 7)()
    lib.flash_bwd_tiles(tiles)
    bf, f32 = BWD_TILES[torch.bfloat16], BWD_TILES[torch.float32]
    want = (THREADS, PAD, *bf["dkv"], *bf["dq"], f32["dkv"][0])
    if tuple(tiles) != want or f32["dkv"] != f32["dq"] \
            or f32["dkv"][0] != f32["dkv"][1]:
        raise RuntimeError(f"flash_bwd.cu tiles {tuple(tiles)} disagree with "
                           f"kernel.py {want}")
    return lib


def build_bwd() -> None:
    """Compile and load the backward library now (otherwise: at first launch)."""
    _bwd_lib()


def _check_rows(what: str, q, lse, delta) -> None:
    b, s, h, _ = q.shape
    for name, a in (("lse", lse), ("delta", delta)):
        if a.dtype != torch.float32 or tuple(a.shape) != (b * h, s) \
                or not a.is_contiguous() or a.device != q.device:
            raise ValueError(f"{what}: {name} must be contiguous f32 [B*H, S] "
                             f"= ({b * h}, {s}) on {q.device}, got "
                             f"{a.dtype} {tuple(a.shape)}")


def _bwd_launch(which: str, q, k, v, dout, lse, delta, window, dq, dk, dv):
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    cfg = bwd_launch_config(which, b, s, t, h, kvh, dh, q.dtype)
    zero = (0, 0, 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_lib().flash_bwd_launch(
            0 if which == "dkv" else 1, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr() if dq is not None else None,
            dk.data_ptr() if dk is not None else None,
            dv.data_ptr() if dv is not None else None,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3],
            *(dq.stride()[:3] if dq is not None else zero),
            *(dk.stride()[:3] if dk is not None else zero),
            s, t, h, kvh, dh, window or 0, dh ** -0.5, *cfg.grid,
            cfg.smem_bytes, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_{which} kernel launch failed: "
                           f"cudaError {err}")


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, window: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV on the card in the model layout: ``q, dout [B, S, H, dh]``,
    ``k, v [B, T, KV, dh]`` of one dtype (f32 or bf16; strides as for
    :func:`flash_fwd_cuda`), the forward's ``lse`` and ``delta =
    rowsum(dout·out)`` as contiguous f32 ``[B*H, S]``. Returns ``(dk, dv)``
    ``[B, T, KV, dh]`` in k's dtype, each summed over the G query heads of
    its KV head inside the kernel. Raises on anything else."""
    _check_qkv("flash_bwd_dkv", q, k, v, window, dout=dout)
    _check_rows("flash_bwd_dkv", q, lse, delta)
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    if dk.numel() == 0:
        return dk, dv                # nothing to compute: no launch
    if q.numel() == 0:
        return dk.zero_(), dv.zero_()
    _bwd_launch("dkv", q, k, v, dout, lse, delta, window, None, dk, dv)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, window: Optional[int] = None
                      ) -> torch.Tensor:
    """dQ on the card, operands as for :func:`flash_bwd_dkv_cuda`. Returns
    ``dq [B, S, H, dh]`` in q's dtype. Raises on anything else."""
    _check_qkv("flash_bwd_dq", q, k, v, window, dout=dout)
    _check_rows("flash_bwd_dq", q, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:
        return dq                    # nothing to compute: no launch
    _bwd_launch("dq", q, k, v, dout, lse, delta, window, dq, None, None)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
