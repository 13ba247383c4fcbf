"""Public per-slot sparse-WU op (``repro.kernels.wu_outer.ops``).

``wu_outer_slots`` has no kernel in the reference (it is jnp only there),
so it is plain torch on every device. The batch-summed ``wu_outer``, whose
Pallas kernel serves the training path, is ported with that path; its plain
version is in ``ref.py``.
"""
from __future__ import annotations

import torch

from . import ref


def wu_outer_slots(pre: torch.Tensor, mod: torch.Tensor, idx: torch.Tensor,
                   scale, *, bk: int, bo: int) -> torch.Tensor:
    """Per-slot compact WU: each slot keeps its own ``[J, T, bk, bo]`` update."""
    scale = torch.as_tensor(scale, dtype=pre.dtype, device=pre.device)
    return ref.wu_outer_slots(pre, mod, idx, scale, bk, bo)
