"""Fused LIF neuron update as a Triton kernel.

Replaces ``src/repro/kernels/lif/kernel.py`` (``lif_pallas``):
``v' = αv + I``, ``s = [v' ≥ θ]``, ``v'' = v' − sθ``, ``tr' = βtr + s``.

What bounds it: three loads and three stores per neuron and about six
flops, so it is bound by bytes (24 B per f32 neuron) and the floor is
``6·B·N·size / 3.35 TB/s``. Design: one pass over the flattened ``[B, N]``
tensors in 1024-element blocks, every intermediate in registers, computed
in f32 whatever the storage type, masked tail; no (8, 128) padding, which
was a TPU tile artefact. Triton is imported and the kernel built only when
it is first launched, so CPU-only processes can import this module.
"""
# No ``from __future__ import annotations`` here: Triton reads the
# ``tl.constexpr`` annotation of the kernel as an object.
import functools
import os

import torch

from .._build import BUILD_DIR

BLOCK = 1024


@functools.cache
def _kernel():
    # keep Triton's compile cache inside the checkout, beside the CUDA builds
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    global tl   # Triton resolves names in the kernel through module globals
    import triton
    import triton.language as tl

    @triton.jit
    def lif_kernel(v_ptr, tr_ptr, i_ptr, vo_ptr, tro_ptr, s_ptr, n,
                   alpha, beta, theta, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        v = tl.load(v_ptr + offs, mask=m).to(tl.float32)
        tr = tl.load(tr_ptr + offs, mask=m).to(tl.float32)
        cur = tl.load(i_ptr + offs, mask=m).to(tl.float32)
        v = alpha * v + cur
        s = (v >= theta).to(tl.float32)
        v = v - s * theta
        tr = beta * tr + s
        ty = vo_ptr.dtype.element_ty
        tl.store(vo_ptr + offs, v.to(ty), mask=m)
        tl.store(tro_ptr + offs, tr.to(ty), mask=m)
        tl.store(s_ptr + offs, s.to(ty), mask=m)

    return triton, lif_kernel


def n_specializations() -> int:
    """Triton specialisations of the LIF kernel compiled in this process
    (0 before its first launch), summed over devices."""
    if not _kernel.cache_info().currsize:
        return 0
    _, lif_kernel = _kernel()
    caches = getattr(lif_kernel, "device_caches", None)
    if caches is not None:        # newer Triton: {device: (kernels, ...)}
        return sum(len(c[0]) for c in caches.values())
    return sum(len(c) for c in lif_kernel.cache.values())


def lif_cuda(v: torch.Tensor, tr: torch.Tensor, current: torch.Tensor, *,
             alpha: float, beta: float, theta: float):
    """``(v', tr', s)`` on the card for contiguous CUDA tensors of one shape,
    dtype (f32 or bf16) and device. Raises on anything else."""
    for name, a in (("tr", tr), ("current", current)):
        if a.shape != v.shape or a.dtype != v.dtype or a.device != v.device:
            raise ValueError(f"lif: {name} {tuple(a.shape)}/{a.dtype} does not "
                             f"match v {tuple(v.shape)}/{v.dtype}")
    if not v.is_cuda:
        raise ValueError("lif: tensors must be on a CUDA device")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lif: f32 or bf16 only, got {v.dtype}")
    if not (v.is_contiguous() and tr.is_contiguous()
            and current.is_contiguous()):
        raise ValueError("lif: inputs must be contiguous")
    triton, lif_kernel = _kernel()
    vo, tro, s = (torch.empty_like(v) for _ in range(3))
    n = v.numel()
    if n:
        with torch.cuda.device(v.device):
            lif_kernel[(triton.cdiv(n, BLOCK),)](
                v, tr, current, vo, tro, s, n, float(alpha), float(beta),
                float(theta), BLOCK=BLOCK, num_warps=4)
        lif_cuda.launches += 1
    return vo, tro, s


lif_cuda.launches = 0
