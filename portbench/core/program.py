"""The program's own spans (``repro_torch.obs.trace``: ``train.*``,
``serve.*``, ``attn``, ``moe.*``, ``ssm.*``, each with its device time and
its counts) reduced to what per-layer readers take.

A traced pass that runs under :func:`record` (``core/trace.record`` with
a fresh ``obs.trace.Tracer(device_time=True)`` made active) puts the
tracer's spans under ``layer_ctx["program"]``; each reader here returns
None where that is missing or holds nothing of its layer, as
``core/readers`` do.

A block's span is a forward one when its parent chain reaches
``train.forward`` or ``serve.prefill``; remat's recompute of a block sits
under ``train.backward`` (on the host's thread) or is a root (on
autograd's own thread, the card's backward), and is not.

A span's ``device_s`` is the stream's time between its two events, host
waits inside it included. The first traced step (``train.step``) or batch
(``serve.generate``) enters a stream the benchmark left idle, so its spans
carry the host's enqueue; the readers of device time read the steps after
it, and the counters every step."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from . import trace as trace_lib

CAPACITY = 1 << 16          # spans a traced pass may record
UNDER = {"train": "train.forward", "prefill": "serve.prefill"}
STEP = {"train": "train.step", "prefill": "serve.generate"}


def under(spans: List, root: str) -> Set[int]:
    """The ids of the spans whose parent chain reaches a span named
    ``root`` (the root itself not counted)."""
    return below(spans, lambda s: s.name == root)


def below(spans: List, is_root: Callable) -> Set[int]:
    """The ids of the spans whose parent chain reaches a span for which
    ``is_root`` holds (that span itself not counted)."""
    by_id = {s.span_id: s for s in spans}
    memo: Dict[int, bool] = {}      # id -> its chain, itself in, has a root

    def reaches(sid: Optional[int]) -> bool:
        path, hit = [], False
        while sid is not None and sid in by_id:
            if sid in memo:
                hit = memo[sid]
                break
            if is_root(by_id[sid]):
                hit = True
                break
            path.append(sid)
            sid = by_id[sid].parent_id
        for p in path:
            memo[p] = hit
        return hit

    return {s.span_id for s in spans if reaches(s.parent_id)}


def named(spans: List, names: Iterable[str],
          root: Optional[str] = None) -> List:
    """The spans of ``names``, only those under ``root`` where given."""
    names = set(names)
    keep = under(spans, root) if root is not None else None
    return [s for s in spans if s.name in names
            and (keep is None or s.span_id in keep)]


def later_steps(spans: List, kind: str) -> List:
    """The traced steps (or batches) of ``kind`` after the first, by their
    start on the host."""
    steps = sorted((s for s in spans if s.name == STEP[kind]
                    and s.parent_id is None), key=lambda s: s.t0_s)
    return steps[1:]


def step_tokens(step) -> int:
    """The tokens of a ``train.step`` or ``serve.generate`` span."""
    if step.name == STEP["train"]:
        return step.attr("tokens")
    return step.attr("rows") * step.attr("seq")


def device_s(spans: List) -> float:
    """The spans' device seconds; every one must have a device time."""
    missing = [s.name for s in spans if s.device_s is None]
    if missing:
        raise ValueError(f"spans without a device time: {missing[:4]}")
    return sum(s.device_s for s in spans)


def host_intervals(spans: List) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of each span on the wall clock, as the
    benchmark's own spans are given to ``core/trace.Trace``."""
    return [(s.name, s.t0_s, s.t0_s + s.dur_s) for s in spans]


def record(torch, fn: Callable[[], None], spans: trace_lib.Spans
           ) -> Tuple[trace_lib.Trace, List]:
    """``core/trace.record`` of ``fn`` with a fresh program tracer that
    keeps device time made active (``obs.trace.use``). Returns the trace,
    its host spans joined by the program's (so that an idle gap is named
    by the innermost of either), and the program's spans. A tracer that
    dropped spans fails the run."""
    from repro_torch.obs.trace import Tracer, use
    tracer = Tracer(capacity=CAPACITY, device_time=True)
    with use(tracer):
        traced = trace_lib.record(torch, fn, spans)
    if tracer.n_dropped:
        raise RuntimeError(f"the program tracer dropped {tracer.n_dropped} "
                           f"of {tracer.n_recorded} spans (CAPACITY)")
    program = tracer.spans()
    traced.spans += host_intervals(program)
    return traced, program


def _spans(ctx: Dict, kind: str) -> Optional[List]:
    if ctx.get("kind") != kind or not ctx.get("program"):
        return None
    return ctx["program"]


def _later(spans: List, kind: str) -> Tuple[List, Set[int]]:
    """The traced steps after the first, and the ids of their spans."""
    steps = later_steps(spans, kind)
    ids = {s.span_id for s in steps}
    return steps, below(spans, lambda s: s.span_id in ids)


def adamw_pct(ctx: Dict) -> Optional[float]:
    """``train.adamw``'s device time over ``train.step``'s, the traced
    steps after the first, in %."""
    spans = _spans(ctx, "train")
    if spans is None:
        return None
    steps, ids = _later(spans, "train")
    opt = [s for s in named(spans, ["train.adamw"]) if s.span_id in ids]
    if not steps or not opt:
        return None
    return 100.0 * device_s(opt) / device_s(steps)


def forward_us_per_token(ctx: Dict, kind: str,
                         names: Iterable[str]) -> Optional[float]:
    """Device time of the forward spans of ``names`` per token, the traced
    steps (or batches) after the first, in µs: ``moe.route`` and
    ``moe.combine`` for the MoE dispatch, ``ssm.ssd`` and ``ssm.conv`` for
    the SSD."""
    spans = _spans(ctx, kind)
    if spans is None:
        return None
    steps, ids = _later(spans, kind)
    got = [s for s in named(spans, names, UNDER[kind]) if s.span_id in ids]
    if not got:
        return None
    return 1e6 * device_s(got) / sum(step_tokens(s) for s in steps)


def moe_fill_pct(ctx: Dict, kind: str) -> Optional[float]:
    """The expert buffer's useful rows over its rows, forward calls:
    Σ choices · (1 − dropped) / Σ slots, in %."""
    spans = _spans(ctx, kind)
    if spans is None:
        return None
    got = named(spans, ["moe.route"], UNDER[kind])
    if not got:
        return None
    kept = sum(s.attr("choices") * (1.0 - s.attr("dropped")) for s in got)
    return 100.0 * kept / sum(s.attr("slots") for s in got)


def gate_open_pct(ctx: Dict) -> Optional[float]:
    """The mean over the traced steps of ``train.gates``' ``open`` (the
    share of layers whose update the gate let through), in %."""
    spans = _spans(ctx, "train")
    if spans is None:
        return None
    got = named(spans, ["train.gates"])
    if not got:
        return None
    return 100.0 * sum(s.attr("open") for s in got) / len(got)
