"""The port's span tracer (``obs/trace.py``) and its spans on the LM
training and prefill paths, on the CPU.

The tracer: host stamps on the wall clock that ``torch.profiler`` stamps
its device events with (``time.time_ns``) and durations on the monotonic
clock, no device time without CUDA, a
0-d tensor attribute read back as a float, the active tracer reached from
another thread, nothing recorded where none is active, the exporters
carrying ``device_s``. The paths: a train step and ``generate`` of reduced
Moonshot (MoE) and Zamba2 (hybrid) with remat give the same bits with
tracing on and off; each step records its step spans once, each forward
its block spans once a layer, and remat's recompute is told apart from the
forward by the parent chain. The card's side (device times, no
synchronise) is in ``tests/test_torch_cuda.py``.
"""
import contextlib
import dataclasses
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

import repro_torch.configs as C
from repro_torch.core.gating import GatingConfig
from repro_torch.launch import train
from repro_torch.launch.serve import generate
from repro_torch.obs import (NULL_TRACER, Span, Tracer, active, chrome_trace,
                             span_records, use)
from repro_torch.optim import AdamWConfig
from repro_torch.optim.optimizer import tree_leaves

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_host_stamps_lie_on_the_wall_clock():
    tr = Tracer()
    before = time.time_ns()
    with tr.span("outer"):
        with tr.span("inner"):
            time.sleep(0.002)
    after = time.time_ns()
    for s in tr.spans():
        assert before * 1e-9 <= s.t0_s <= s.t0_s + s.dur_s <= after * 1e-9
    inner, outer = tr.spans()
    assert inner.dur_s >= 0.002 and outer.dur_s >= inner.dur_s


def test_duration_ignores_a_wall_clock_step(monkeypatch):
    """The wall clock stepped back an hour inside a span (an NTP step)
    moves neither its duration nor its start."""
    tr = Tracer()
    wall = [time.time_ns()]
    monkeypatch.setattr(time, "time_ns", lambda: wall[0])
    c0 = time.perf_counter()
    with tr.span("a"):
        wall[0] -= 3600 * 10 ** 9
        time.sleep(0.002)
    c1 = time.perf_counter()
    (s,) = tr.spans()
    assert s.t0_s == (wall[0] + 3600 * 10 ** 9) * 1e-9
    assert 0.002 <= s.dur_s <= c1 - c0


def test_no_device_time_without_cuda():
    tr, off = Tracer(device_time=True), Tracer()
    for t in (tr, off):
        with t.span("a"):
            torch.ones(4).sum()
        with t.span("b"):
            pass
    assert [s.device_s for s in off.spans()] == [None, None]
    if torch.cuda.is_available():
        return                          # the card's side: test_torch_cuda
    assert [s.device_s for s in tr.spans()] == [None, None]
    assert not tr.device_time


def test_tensor_attribute_reads_as_a_float():
    tr = Tracer()
    with tr.span("moe.route", choices=12) as sp:
        sp.set(dropped=torch.tensor(0.25), open=torch.tensor(1))
    (s,) = tr.spans()
    assert s.attr("dropped") == 0.25 and type(s.attr("dropped")) is float
    assert s.attr("open") == 1.0 and type(s.attr("open")) is float
    assert s.attr("choices") == 12 and type(s.attr("choices")) is int


def test_use_reaches_other_threads_and_restores():
    tr, inner = Tracer(), Tracer()
    assert active() is NULL_TRACER
    seen = []

    def work():
        seen.append(active())
        with active().span("worker"):
            pass

    with use(tr):
        th = threading.Thread(target=work, name="autograd-like")
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with use(inner):
            assert active() is inner
        assert active() is tr
    assert active() is NULL_TRACER and seen == [tr]
    (s,) = tr.spans()
    assert s.name == "worker" and s.thread == "autograd-like"
    assert s.parent_id is None and inner.spans() == []


def test_no_active_tracer_records_nothing():
    assert active() is NULL_TRACER
    assert active().span("a") is active().span("b", x=1)
    with active().span("c") as sp:
        sp.set(open=torch.tensor(1.0))
    assert NULL_TRACER.spans() == [] and NULL_TRACER.n_recorded == 0


def test_exporters_carry_device_time():
    spans = [Span("train.step", 1, None, 10.0, 0.5, "MainThread",
                  (("tokens", 64),), device_s=0.4),
             Span("bench.read", 2, None, 10.5, 0.1, "MainThread", ())]
    recs = span_records(spans)
    assert recs[0]["device_s"] == 0.4 and recs[0]["tokens"] == 64
    assert "device_s" not in recs[1]
    doc = chrome_trace(spans)
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert xs["train.step"]["args"]["device_s"] == 0.4
    assert "device_s" not in xs["bench.read"]["args"]


# ---------------------------------------------------------------------------
# the LM training and prefill paths
# ---------------------------------------------------------------------------

ARCHS = {"moe": "moonshot_v1_16b_a3b", "hybrid": "zamba2_1p2b"}
BLOCK_SPANS = {"moe": ("attn", "moe.route", "moe.experts", "moe.combine"),
               "hybrid": ("attn", "ssm.conv", "ssm.ssd")}
STEP_SPANS = ("train.step", "train.forward", "train.backward",
              "train.grads_stack", "train.gates", "train.adamw")


def _run(family, tracer):
    """Two gated train steps of a reduced config with remat, then a
    three-token ``generate`` from the trained params, under ``tracer``
    (None: no tracer active). Returns (cfg, outputs)."""
    cfg = dataclasses.replace(C.get_reduced(ARCHS[family]), remat=True)
    hp = train.TrainHParams(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=100),
                            gating=GatingConfig())
    rng = np.random.default_rng(3)
    batches = [{k: torch.tensor(rng.integers(0, cfg.vocab, (2, 16)))
                for k in ("tokens", "labels")} for _ in range(2)]
    state = train.init_train_state(torch.Generator().manual_seed(0), cfg, hp,
                                   device="cpu")
    step = train.make_train_step(cfg, hp)
    outs = []
    with (use(tracer) if tracer is not None else contextlib.nullcontext()):
        for b in batches:
            *state, m = step(*state, b)
            outs.append(m)
        tokens = generate(state[0], cfg, batches[0]["tokens"][:, :11], 3)
    return cfg, (state, outs, tokens)


def _chain(spans):
    """span id -> the names of its ancestors, nearest first."""
    by_id = {s.span_id: s for s in spans}

    def up(s):
        names = []
        while s.parent_id is not None:
            s = by_id[s.parent_id]
            names.append(s.name)
        return names
    return {s.span_id: up(s) for s in spans}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def traced(request):
    family = request.param
    tr = Tracer(capacity=1 << 16, device_time=True)
    cfg, on = _run(family, tr)
    _, off = _run(family, None)
    return family, cfg, tr, on, off


def test_tracing_changes_no_bit(traced):
    _, _, _, on, off = traced
    (s_on, m_on, tok_on), (s_off, m_off, tok_off) = on, off
    assert torch.equal(tok_on, tok_off)
    assert s_on[1].step == s_off[1].step == 2

    def leaves(s):
        return (tree_leaves(s[0]) + tree_leaves(s[1].m) + tree_leaves(s[1].v)
                + list(s[2].gate) + [s[2].pooled_ema])
    assert len(leaves(s_on)) == len(leaves(s_off)) > 0
    for a, b in zip(leaves(s_on), leaves(s_off)):
        assert torch.equal(a, b)
    for a, b in zip(m_on, m_off):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))


def test_each_step_records_its_spans_once(traced):
    family, cfg, tr, _, _ = traced
    spans = tr.spans()
    assert tr.n_dropped == 0
    names = Counter(s.name for s in spans)
    for name in STEP_SPANS:
        assert names[name] == 2, name               # two steps
    chain = _chain(spans)
    for s in spans:
        if s.name in STEP_SPANS[1:]:
            assert chain[s.span_id][-1] == "train.step"
        if not torch.cuda.is_available():
            assert s.device_s is None
    steps = tr.spans("train.step")
    assert [s.attr("tokens") for s in steps] == [32, 32]
    gates = tr.spans("train.gates")
    assert [g.attr("layers") for g in gates] == [cfg.n_layers] * 2
    assert all(0.0 <= g.attr("open") <= 1.0 for g in gates)
    # the fused AdamW's counters: nothing launched on the CPU
    assert [(a.attr("launches"), a.attr("elems"))
            for a in tr.spans("train.adamw")] == [(0, 0)] * 2
    gen = tr.spans("serve.generate")
    assert [(g.attr("rows"), g.attr("seq")) for g in gen] == [(2, 11)]
    assert names["serve.prefill"] == 1


def test_block_spans_forward_and_recompute(traced):
    family, cfg, tr, _, _ = traced
    spans = tr.spans()
    chain = _chain(spans)
    per_layer = {"attn": cfg.n_layers // cfg.hybrid_attn_every
                 if family == "hybrid" else cfg.n_layers}
    for name in BLOCK_SPANS[family]:
        want = per_layer.get(name, cfg.n_layers)
        mine = [s for s in spans if s.name == name]
        fwd = [s for s in mine if "train.forward" in chain[s.span_id]]
        pre = [s for s in mine if "serve.prefill" in chain[s.span_id]]
        # remat: the backward recomputes each block, on this thread here
        again = [s for s in mine if "train.backward" in chain[s.span_id]]
        assert len(fwd) == 2 * want and len(pre) == want, name
        assert len(again) == 2 * want, name
        assert not any("train.forward" in chain[s.span_id] for s in again)
        # no block span nests in another: its parent is the forward
        assert all(chain[s.span_id][0] == "train.forward" for s in fwd)
    if family == "moe":
        routes = [s for s in spans if s.name == "moe.route"
                  and "train.forward" in chain[s.span_id]]
        e, k = cfg.moe_experts, cfg.moe_top_k
        for s in routes:
            assert s.attr("choices") == 32 * k
            assert s.attr("slots") % e == 0 and s.attr("slots") >= 8 * e
            assert 0.0 <= s.attr("dropped") < 1.0
