"""The port's continuous batcher (``launch/batching.ContinuousBatcher``) and
span tracer (``obs/trace.py``).

The batcher: the invariants of tests/test_batching.py on the port, and the
port's batcher against the reference's on the same weights (reduced Phi-3,
Moonshot, Mamba2 and Zamba2, f32), token for token, slot reuse included.
Greedy tokens must be equal; no tolerance.
"""
import functools
import threading

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.launch import batching as jbatching
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.launch.batching import ContinuousBatcher, Request
from repro_torch.launch.serve import generate
from repro_torch.obs import NULL_TRACER, Tracer

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = convert.model_config(JC.get_reduced(arch))
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                                 cfg, "cpu")


def _prompt(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).tolist()


def _lone(cfg, params, prompt, n_new):
    return generate(params, cfg, torch.tensor([prompt]), n_new)[0, len(prompt):].tolist()


def _batcher(cfg, params, **kw):
    return ContinuousBatcher(params, cfg, n_slots=kw.pop("n_slots", 2),
                             max_seq=32, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the invariants of tests/test_batching.py
# ---------------------------------------------------------------------------

def test_matches_single_request_generate():
    cfg, _, tp = _model("phi3_medium_14b")
    prompt = _prompt(cfg, 1, 6)
    b = _batcher(cfg, tp)
    b.submit(Request(rid=0, prompt=prompt, max_new=5))
    done = b.run_until_drained()
    assert len(done) == 1 and done[0].out == _lone(cfg, tp, prompt, 5)


def test_concurrent_requests_isolated():
    """Two prompts decoded in adjacent slots each equal their lone runs:
    the slots' cache lanes do not leak."""
    cfg, _, tp = _model("phi3_medium_14b")
    p1, p2 = _prompt(cfg, 2, 5), _prompt(cfg, 3, 5)
    b = _batcher(cfg, tp)
    b.submit(Request(rid=1, prompt=p1, max_new=4))
    b.submit(Request(rid=2, prompt=p2, max_new=4))
    done = {r.rid: r for r in b.run_until_drained()}
    assert done[1].out == _lone(cfg, tp, p1, 4)
    assert done[2].out == _lone(cfg, tp, p2, 4)


def test_max_new_1_emits_exactly_one_token():
    cfg, _, tp = _model("phi3_medium_14b")
    prompt = _prompt(cfg, 4, 6)
    b = _batcher(cfg, tp)
    b.submit(Request(rid=0, prompt=prompt, max_new=1))
    done = b.run_until_drained()
    assert len(done) == 1 and done[0].done
    assert done[0].out == _lone(cfg, tp, prompt, 1)
    assert b.stats["tokens_out"] == 1 and b.grid.drained


def test_eos_as_first_generated_token_retires_immediately():
    cfg, _, tp = _model("phi3_medium_14b")
    prompt = _prompt(cfg, 5, 5)
    first = _lone(cfg, tp, prompt, 1)[0]
    b = _batcher(cfg, tp, eos_id=first)
    b.submit(Request(rid=0, prompt=prompt, max_new=8))
    done = b.run_until_drained()
    assert len(done) == 1 and done[0].done and done[0].out == [first]


def test_slot_reuse_more_requests_than_slots():
    cfg, _, tp = _model("phi3_medium_14b")
    b = _batcher(cfg, tp)
    for i in range(5):
        b.submit(Request(rid=i, prompt=_prompt(cfg, 10 + i, 4), max_new=3))
    done = b.run_until_drained()
    assert len(done) == 5 and all(len(r.out) == 3 for r in done)
    assert b.grid.stats["admitted"] == b.grid.stats["retired"] == 5
    assert 0 < b.utilization <= 1.0 and b.grid.drained


# ---------------------------------------------------------------------------
# against the reference's batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi3_medium_14b", "moonshot_v1_16b_a3b",
                                  "mamba2_2p7b", "zamba2_1p2b"])
def test_batcher_tokens_equal_reference(arch):
    """Five requests of mixed lengths through two slots (reused three
    times), the first stopped at once by ``eos_id``: the same tokens, finish
    order and grid statistics as the reference's batcher (reused slots
    included, whose requests see the previous occupant's K/V, or for
    Mamba2 and Zamba2 its SSM state and conv window, there too)."""
    cfg, jp, tp = _model(arch)
    specs = [(_prompt(cfg, 20 + i, 3 + 2 * i % 5), 2 + i % 3) for i in range(5)]
    eos = _lone(cfg, tp, specs[0][0], 1)[0]      # request 0 stops at once
    mine = _batcher(cfg, tp, eos_id=eos)
    ref = jbatching.ContinuousBatcher(jp, cfg, n_slots=2, max_seq=32,
                                      eos_id=eos)
    for i, (prompt, n_new) in enumerate(specs):
        mine.submit(Request(rid=i, prompt=prompt, max_new=n_new))
        ref.submit(jbatching.Request(rid=i, prompt=prompt, max_new=n_new))
    got = [(r.rid, r.out) for r in mine.run_until_drained()]
    want = [(r.rid, [int(t) for t in r.out]) for r in ref.run_until_drained()]
    assert got == want
    assert len(got) == 5 and dict(got)[0] == [eos]
    assert mine.grid.stats == ref.grid.stats
    assert mine.stats == ref.stats and mine.utilization == ref.utilization


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_batcher_spans_names_and_tags():
    cfg, _, tp = _model("phi3_medium_14b")

    def drive(tracer):
        b = _batcher(cfg, tp, tracer=tracer)
        b.submit(Request(rid=0, prompt=[1, 2, 3], max_new=3))
        return b, b.run_until_drained()

    tr = Tracer()
    b_on, done_on = drive(tr)
    _, done_off = drive(None)
    assert done_on[0].out == done_off[0].out         # tracing changes nothing
    steps = b_on.grid.stats["steps"]
    admits, decodes = tr.spans("batch.admit"), tr.spans("batch.decode_step")
    assert len(admits) == len(decodes) == steps == 5
    assert {s.name for s in tr.spans()} == {"batch.admit", "batch.decode_step"}
    assert [a.attr("admitted") for a in admits] == [1, 0, 0, 0, 0]
    assert [(d.attr("prefill_slots"), d.attr("decode_slots")) for d in decodes] \
        == [(1, 0), (1, 0), (1, 0), (0, 1), (0, 1)]
    assert [d.attr("grid_step") for d in decodes] == list(range(1, steps + 1))
    assert [a.attr("grid_step") for a in admits] == list(range(1, steps + 1))
    assert all(s.parent_id is None and s.dur_s >= 0.0 for s in tr.spans())


def test_span_nesting_ids_and_attrs():
    tr = Tracer()
    with tr.span("outer", step=1):
        with tr.span("inner") as sp:
            sp.set(count=3)
        with tr.span("inner2"):
            pass
    spans = {s.name: s for s in tr.spans()}
    outer = spans["outer"]
    assert outer.parent_id is None and outer.attr("step") == 1
    assert spans["inner"].parent_id == spans["inner2"].parent_id == outer.span_id
    assert spans["inner"].attr("count") == 3 and spans["inner"].attr("x", 7) == 7
    assert outer.dur_s >= spans["inner"].dur_s >= 0.0
    assert outer.t0_s <= spans["inner"].t0_s
    assert [s.name for s in tr.spans()] == ["inner", "inner2", "outer"]


def test_ring_bound_and_drop_count():
    tr = Tracer(capacity=8)
    for i in range(20):
        with tr.span("s", i=i):
            pass
    spans = tr.spans()
    assert len(spans) == 8
    assert tr.n_recorded == 20 and tr.n_dropped == 12
    assert [s.attr("i") for s in spans] == list(range(12, 20))
    tr.clear()
    assert tr.spans() == []
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_null_and_disabled_tracer_record_nothing():
    tr = Tracer(enabled=False)
    with tr.span("x") as sp:
        sp.set(a=1)
    assert tr.spans() == [] and tr.n_recorded == 0
    with NULL_TRACER.span("y"):
        pass
    assert NULL_TRACER.spans() == [] and not NULL_TRACER.enabled
    assert tr.span("a") is tr.span("b") is NULL_TRACER.span("c")


def test_tracer_threads_keep_their_own_parents():
    tr = Tracer(capacity=10_000)

    def work(t):
        for _ in range(100):
            with tr.span("outer", t=t):
                with tr.span("inner", t=t):
                    pass

    threads = [threading.Thread(target=work, args=(t,), name=f"w{t}")
               for t in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    spans = tr.spans()
    assert len(spans) == tr.n_recorded == 6 * 100 * 2
    assert len({s.span_id for s in spans}) == len(spans)
    outers = {s.span_id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            assert outers[s.parent_id].thread == s.thread
