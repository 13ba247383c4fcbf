"""The reduction of a traced window to the per-layer metrics, on a trace
made by hand, and the result line's shape."""
import json

import pytest

from portbench import run as run_mod
from portbench.core import counts, readers, spec
from portbench.core import trace as T

PORT = {"family": "moe", "n_layers": 1, "d_model": 2048, "n_heads": 16,
        "n_kv_heads": 16, "d_head": 128, "d_ff": 1408, "vocab": 163840,
        "moe_experts": 64, "moe_top_k": 6, "dtype": "bfloat16"}


def hand_trace():
    fwd = counts.flash_bound_s("flash_fwd", PORT, 2, 1024)
    dev = [("nvjet_tst_128x64", 0.0, 0.2),
           ("void flash_fwd_wgmma<128>(x)", 0.25, 0.25 + 2 * fwd),
           ("elementwise_kernel<add>", 0.3, 0.55),
           ("Memcpy HtoD", 0.45, 0.6),
           ("void flash_fwd_wgmma<128>(x)", 0.8, 0.8 + 2 * fwd)]
    spans = [("bench.copy", 0.6, 0.65), ("bench.step", 0.65, 0.95)]
    return T.Trace(dev, spans, (0.0, 1.0), 1.0), fwd


def test_busy_gaps_and_classes():
    tr, fwd = hand_trace()
    assert T.busy_s(tr) == pytest.approx(0.2 + 0.3 + 4 * fwd)
    gaps = T.idle_gaps(tr)
    assert gaps[0] == ("bench.copy", pytest.approx(0.2))
    assert sum(g for _, g in gaps) == pytest.approx(1.0 - T.busy_s(tr))
    cls = T.by_class(tr)
    assert cls["gemm"] == pytest.approx(0.2)
    assert cls["flash"] == pytest.approx(4 * fwd)
    assert cls["other"] == pytest.approx(0.4)
    b = T.breakdown(tr)
    assert b["device_ops"][0][0] == "elementwise_kernel<add>"
    assert len(b["idle_gaps"]) <= 10


def test_readers():
    tr, fwd = hand_trace()
    ctx = {"kind": "prefill", "port": PORT, "trace": tr, "window_s": 2.0,
           "work_flops": 989.4e12, "trace_tokens": 4096,
           "flash_shapes": [("flash_fwd", 2, 1024)] * 2}
    assert readers.flash_roofline_pct(ctx, "prefill") == pytest.approx(50.0)
    assert readers.mfu_pct(ctx, "prefill") == pytest.approx(50.0)
    assert readers.nongemm_us_per_token(ctx, "prefill") == \
        pytest.approx(0.4e6 / 4096)
    assert readers.device_idle_pct(ctx, "prefill") == \
        pytest.approx(100 * (1 - T.busy_s(tr)))
    # another kind, or shapes that do not match the calls: nothing to read
    assert readers.mfu_pct(ctx, "train") is None
    assert readers.flash_roofline_pct(dict(ctx, flash_shapes=[]),
                                      "prefill") is None
    nofl = T.Trace([("nvjet", 0.0, 0.1)], [], (0.0, 1.0), 1.0)
    assert readers.flash_roofline_pct(dict(ctx, trace=nofl),
                                      "prefill") is None


def test_result_line_puts_checks_last():
    bench = spec.benchmark()
    cell = spec.cell(bench["workloads"][0]["name"], bench)
    res = {"correct": True, "attempted": 8, "failed": 0,
           "metrics": {m["name"]: 1.5 for m in cell.end_to_end},
           "device": {"platform": "gpu", "kind": "H100", "count": 1,
                      "memory_peak_bytes": 1},
           "checks": {"gap": {"value": 0.1, "limit": 0.3}}}
    line = run_mod.result_line(cell, res, traced=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert json.loads(json.dumps(line)) == line


def test_clip_cuts_to_the_window_and_refuses_another_clock():
    raw = [("a", 9.5, 10.2), ("b", 10.3, 10.6), ("d", 10.7, 10.8),
           ("c", 10.9, 11.4)]
    spans = [("bench.step", 10.0, 10.8)]
    tr = T.clip(raw, spans, 10.0, 1.0)
    assert tr.window == (10.0, 11.0) and tr.window_s == 1.0
    assert tr.device == [("a", 10.0, 10.2), ("b", 10.3, 10.6),
                         ("d", 10.7, 10.8), ("c", 10.9, 11.0)]
    assert tr.spans == spans
    assert T.busy_s(tr) == pytest.approx(0.7)
    # stamped on another clock: most operations outside the window
    with pytest.raises(RuntimeError, match="clock"):
        T.clip([(n, a + 50, b + 50) for n, a, b in raw], spans, 10.0, 1.0)
    with pytest.raises(RuntimeError, match="no device operation"):
        T.clip([], spans, 10.0, 1.0)


def test_device_events_are_stamped_on_the_host_wall_clock():
    """The profiler's events and the host's spans share one clock, so the
    gaps are named by what the host was doing (on the CPU's events here;
    the card's are read from the same Kineto records)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w0, t0 = time.time_ns() * 1e-9, time.perf_counter()
        (torch.ones(256, 256) @ torch.ones(256, 256)).sum()
        wall = time.perf_counter() - t0
    raw = T.device_events(prof, "CPU")
    assert raw and all(b >= a for _, a, b in raw)
    assert T.device_events(prof) == []           # no card on this host
    tr = T.clip(raw, [], w0, wall)
    assert tr.device and T.busy_s(tr) <= wall
