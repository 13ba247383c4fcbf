"""What the per-layer readers (``metrics/<name>.py``) share. Each reader
takes the traced run's context (``drivers/<kind>.py``'s ``layer_ctx``)
and returns its number, or None where the run holds nothing to read (a
cell of another kind, a trace without the kernels): the harness then
leaves the metric out of the line."""
from __future__ import annotations

from typing import Dict, Optional

from . import counts
from . import trace as trace_lib
from .peaks import PEAK_FLOPS


def mfu_pct(ctx: Dict, kind: str) -> Optional[float]:
    """Model flops of every step (or prefill) in the window over the
    window's time and the bf16 peak, in %."""
    if ctx.get("kind") != kind or not ctx.get("window_s"):
        return None
    peak = PEAK_FLOPS[ctx["port"].get("dtype", "bfloat16")]
    return 100.0 * ctx["work_flops"] / ctx["window_s"] / peak


def nongemm_us_per_token(ctx: Dict, kind: str) -> Optional[float]:
    """Device time of kernels that are neither GEMMs nor flash kernels,
    per token of the traced steps, in µs."""
    if ctx.get("kind") != kind:
        return None
    other = trace_lib.by_class(ctx["trace"])["other"]
    return 1e6 * other / ctx["trace_tokens"]


def flash_roofline_pct(ctx: Dict, kind: str) -> Optional[float]:
    """The flash kernels' bounds (each call's, from its shape) over their
    device time, in %. A training step's calls all have the cell's shape;
    a prefill's come in the order of ``flash_shapes`` ([(kind, b, s)])."""
    if ctx.get("kind") != kind:
        return None
    calls = sorted((a, n, b - a) for n, a, b in ctx["trace"].device
                   if counts.flash_kind(n))
    if not calls:
        return None
    shapes = ctx.get("flash_shapes")
    if shapes is not None and len(shapes) != len(calls):
        return None
    bound = busy = 0.0
    for j, (_, name, dur) in enumerate(calls):
        kname = counts.flash_kind(name)
        if shapes is not None:
            want, b, s = shapes[j]
            if want != kname:
                return None
        else:
            b, s = ctx["flash_b"], ctx["flash_s"]
        bound += counts.flash_bound_s(kname, ctx["port"], b, s)
        busy += dur
    return 100.0 * bound / busy


def device_idle_pct(ctx: Dict, kind: str) -> Optional[float]:
    if ctx.get("kind") != kind:
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - trace_lib.busy_s(tr) / tr.window_s)
