"""The reduction of the program's own spans (``core/program.py``) on spans
made by hand: forward spans told from remat's recompute by the parent
chain, each reader's number and its None where there is nothing to read,
the readers of device time reading past the first traced step, the
traced pass's program tracer, and the traced window's idle gaps named by a
program span."""
import pytest
import torch

from portbench.core import program as P
from portbench.core import trace as T
from repro_torch.obs import Span, active


def sp(name, sid, parent, t0, dur, dev=None, thread="MainThread", **attrs):
    return Span(name, sid, parent, t0, dur, thread,
                tuple(sorted(attrs.items())), device_s=dev)


def train_spans(o=0, t=0.0, wait=0.0, open=0.5):
    """One training step of one MoE layer with remat: the forward's block
    spans, the recompute under the backward (the host's thread) and as a
    root (autograd's thread), the gates and AdamW. Span ids start past
    ``o``, times at ``t``; ``wait`` s of host enqueue fall inside the
    forward's ``moe.route`` (a step entered on an idle stream)."""
    return [
        sp("moe.route", o + 1, o + 3, t + 0.10, 0.02, 0.010 + wait,
           choices=600, slots=800, dropped=0.1),
        sp("moe.experts", o + 2, o + 3, t + 0.12, 0.02, 0.030),
        sp("moe.combine", o + 4, o + 3, t + 0.14, 0.01, 0.005),
        sp("train.forward", o + 3, o + 10, t + 0.05, 0.15, 0.100 + wait),
        sp("moe.route", o + 5, o + 6, t + 0.22, 0.02, 0.011, choices=600,
           slots=800, dropped=0.1),
        sp("train.backward", o + 6, o + 10, t + 0.20, 0.10, 0.150),
        sp("moe.route", o + 7, None, t + 0.23, 0.02, 0.012,
           thread="autograd-0", choices=600, slots=800, dropped=0.1),
        sp("train.gates", o + 8, o + 10, t + 0.30, 0.01, 0.001, open=open,
           layers=4),
        sp("train.adamw", o + 9, o + 10, t + 0.31, 0.08, 0.200),
        sp("train.step", o + 10, None, t + 0.05, 0.40, 0.400 + wait,
           tokens=1000),
    ]


def two_steps():
    """A first step whose ``moe.route`` read a 50 ms host wait, and a
    second one queued behind it, listed second first."""
    return train_spans(100, 1.0, open=0.0) + train_spans(wait=0.05,
                                                          open=1.0)


def test_forward_spans_are_told_by_the_parent_chain():
    spans = train_spans()
    assert P.under(spans, "train.forward") == {1, 2, 4}
    assert P.under(spans, "train.backward") == {5}
    assert P.under(spans, "train.step") == {1, 2, 3, 4, 5, 6, 8, 9}
    assert [s.span_id for s in P.named(spans, ["moe.route"])] == [1, 5, 7]
    assert [s.span_id for s in P.named(spans, ["moe.route"],
                                       "train.forward")] == [1]


def test_readers_on_a_training_step():
    ctx = {"kind": "train", "program": two_steps()}
    assert P.adamw_pct(ctx) == pytest.approx(50.0)
    assert P.forward_us_per_token(ctx, "train", ["moe.route", "moe.combine"]
                                  ) == pytest.approx(1e6 * 0.015 / 1000)
    assert P.moe_fill_pct(ctx, "train") == pytest.approx(100 * 540 / 800)
    assert P.gate_open_pct(ctx) == pytest.approx(50.0)
    # another kind, no program spans, or none of the layer: nothing to read
    assert P.adamw_pct(dict(ctx, kind="prefill")) is None
    assert P.moe_fill_pct(dict(ctx, program=[]), "train") is None
    assert P.moe_fill_pct({"kind": "train"}, "train") is None
    assert P.forward_us_per_token(ctx, "train", ["ssm.ssd", "ssm.conv"]) \
        is None
    assert P.moe_fill_pct(ctx, "prefill") is None


def test_readers_on_prefill_batches():
    spans = []
    for j in range(2):                     # two batches of two layers
        o = 100 * j                        # the first with a host wait
        spans += [sp("ssm.conv", o + 1, o + 5, j, 0.1, 0.002),
                  sp("ssm.ssd", o + 2, o + 5, j, 0.1, 0.020 + 0.01 * (j == 0)),
                  sp("ssm.conv", o + 3, o + 5, j, 0.1, 0.002),
                  sp("ssm.ssd", o + 4, o + 5, j, 0.1, 0.020),
                  sp("serve.prefill", o + 5, o + 6, j, 0.5, 0.050),
                  sp("serve.generate", o + 6, None, j, 0.6, 0.051, rows=4,
                     seq=512)]
    ctx = {"kind": "prefill", "program": spans}
    assert P.forward_us_per_token(ctx, "prefill", ["ssm.ssd", "ssm.conv"]) \
        == pytest.approx(1e6 * 0.044 / 2048)
    assert P.forward_us_per_token(ctx, "prefill",
                                  ["moe.route", "moe.combine"]) is None
    assert P.gate_open_pct(ctx) is None
    ctx["program"] = spans + [sp("ssm.ssd", 999, None, 0.0, 0.1)]
    with pytest.raises(ValueError, match="device time"):
        P.device_s(P.named(ctx["program"], ["ssm.ssd"]))


def test_time_readers_drop_the_first_step():
    """The first step's host wait reaches no reading of device time, the
    counters read every step, and one step alone gives no device time."""
    ctx = {"kind": "train", "program": two_steps()}
    second = {"kind": "train", "program": train_spans(100, 1.0)}
    first = {"kind": "train", "program": train_spans(wait=0.05)}
    assert [s.span_id for s in P.later_steps(two_steps(), "train")] == [110]
    assert P.step_tokens(P.later_steps(two_steps(), "train")[0]) == 1000
    both = two_steps() + train_spans(200, 2.0)
    assert P.adamw_pct(ctx) == P.adamw_pct(dict(second, program=both)) \
        == pytest.approx(50.0)
    dispatch = ["moe.route", "moe.combine"]
    assert P.forward_us_per_token(ctx, "train", dispatch) \
        == pytest.approx(15.0)
    assert P.forward_us_per_token(dict(ctx, program=both), "train",
                                  dispatch) == pytest.approx(15.0)
    # what the first step alone would have read, had it been kept
    assert 1e6 * P.device_s(P.named(first["program"], dispatch,
                                    "train.forward")) / 1000 \
        == pytest.approx(65.0)
    for one in (first, second):
        assert P.adamw_pct(one) is None
        assert P.forward_us_per_token(one, "train", dispatch) is None
        assert P.moe_fill_pct(one, "train") == pytest.approx(67.5)
    assert P.gate_open_pct(ctx) == pytest.approx(50.0)


def test_idle_gaps_are_named_by_program_spans():
    spans = train_spans()
    # the card busy but for 0.32-0.36 (inside train.adamw on the host) and
    # 0.45-0.50 (after the step, in the benchmark's own bench.read)
    dev = [("gemm", 0.0, 0.32), ("elementwise", 0.36, 0.45)]
    bench = [("bench.step", 0.04, 0.45), ("bench.read", 0.45, 0.5)]
    tr = T.Trace(dev, bench + P.host_intervals(spans), (0.0, 0.5), 0.5)
    gaps = T.idle_gaps(tr)
    assert [g[0] for g in gaps] == ["bench.read", "train.adamw"]
    assert [g[1] for g in gaps] == pytest.approx([0.05, 0.04])
    assert P.host_intervals(spans)[-1] == ("train.step", 0.05,
                                           pytest.approx(0.45))


def test_record_runs_the_pass_under_a_program_tracer(monkeypatch):
    """``record`` makes a tracer active for the pass alone, joins its host
    intervals to the trace's spans and hands its spans back; a pass that
    overflows the tracer fails."""
    def fake_record(torch_, fn, spans):
        fn()
        return T.Trace([], [("bench.step", 0.0, 1.0)], (0.0, 1.0), 1.0)
    monkeypatch.setattr(T, "record", fake_record)

    def step():
        with active().span("train.step", tokens=8):
            with active().span("train.adamw"):
                pass
    traced, program = P.record(torch, step, T.Spans())
    assert [s.name for s in program] == ["train.adamw", "train.step"]
    assert active().span("x") is active().span("y")   # none active after
    assert [s[0] for s in traced.spans] == ["bench.step", "train.adamw",
                                             "train.step"]
    assert traced.spans[1:] == P.host_intervals(program)
    monkeypatch.setattr(P, "CAPACITY", 1)
    with pytest.raises(RuntimeError, match="dropped 1 of 2"):
        P.record(torch, step, T.Spans())
