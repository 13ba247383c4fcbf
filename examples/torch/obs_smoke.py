"""Observability smoke on the port: scrape a live pipelined serving run,
twice.

Runs a short double-buffered serving loop with a span tracer attached,
takes a Prometheus text scrape mid-run and again after the fleet drains,
and asserts the contract the exporters promise operators:

* every required serving metric family is present in the scrape;
* counters are monotone — no sample of a ``*_total``/``*_count``/
  ``*_bucket`` series ever decreases between scrapes;
* the span trace carries exactly one stage/dispatch/retire span per
  grid step (per-phase attribution survives pipelining);
* the whole run built the chunk fn exactly once.

Exit 0 + ``OK`` on success (on the card the chunk step launches the fused
``nm_spmm``, ``lif`` and ``wu_outer_slots``; the line before ``OK`` counts
the kernels' launches):

    PYTHONPATH=src python examples/torch/obs_smoke.py [--device cpu]
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch.core.snn import SNNConfig, init_params            # noqa: E402
from repro_torch.kernels import launch_counts                      # noqa: E402
from repro_torch.obs import (Tracer, parse_prometheus_text,        # noqa: E402
                             prometheus_text)
from repro_torch.serving import (ReplaySource, StreamScheduler,    # noqa: E402
                                 StreamSession)

REQUIRED_FAMILIES = (
    "serving_grid_steps_total",
    "serving_step_latency_seconds",
    "serving_phase_seconds",
    "serving_flush_seconds_total",
    "serving_overlap_ratio",
    "serving_overlap_hidden_seconds_total",
    "serving_device_wait_seconds_total",
    "serving_stream_timesteps_total",
    "serving_stream_events_in_total",
    "serving_stream_windows_total",
)

# sample-name suffixes that must never decrease between scrapes
_MONOTONE = ("_total", "_count", "_bucket")


def monotone_samples(parsed: dict) -> dict:
    return {k: v for k, v in parsed.items()
            if any(suffix in k for suffix in _MONOTONE)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    cfg = SNNConfig(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=16,
                    backend="kernels")
    params = init_params(0, cfg, device=dev)
    tracer = Tracer(capacity=65536)
    sched = StreamScheduler(params, cfg, n_slots=3, chunk_len=6,
                            pipeline_depth=1, tracer=tracer, device=dev)
    rng = np.random.default_rng(0)
    for sid in range(5):
        spikes = (rng.random(((3 + sid % 2) * cfg.t_steps, cfg.n_in))
                  < 0.3).astype(np.float32)
        sched.submit(StreamSession(sid=sid, source=ReplaySource(spikes),
                                   adapt=(sid % 2 == 0)))

    try:
        # scrape 1: mid-run, with steps in flight
        for _ in range(4):
            sched.step()
        first = parse_prometheus_text(prometheus_text(sched.telemetry.registry))

        missing = [f for f in REQUIRED_FAMILIES
                   if not any(k.startswith(f) for k in first)]
        assert not missing, f"missing metric families mid-run: {missing}"

        # scrape 2: drained — every monotone series must be >= scrape 1
        sched.run_until_drained()
    finally:
        sched.close()
    second = parse_prometheus_text(prometheus_text(sched.telemetry.registry))
    regressed = [k for k, v in monotone_samples(first).items()
                 if second.get(k, float("-inf")) < v]
    assert not regressed, f"counters decreased between scrapes: {regressed}"

    steps = sched.grid.stats["steps"]
    assert second["serving_grid_steps_total"] == steps
    for name in ("sched.stage", "sched.dispatch", "sched.retire"):
        owned = sorted(s.attr("grid_step") for s in tracer.spans(name))
        assert owned == list(range(1, steps + 1)), (name, owned)
    assert sched.n_compiles == 1
    assert 0.0 < sched.telemetry.overlap_ratio() <= 1.0

    roll = sched.telemetry.rollup()
    print(f"grid steps {steps} | events/s {roll['events_per_s']:.0f} | "
          f"overlap {roll['overlap_ratio']:.2f} | "
          f"p50/p99 {roll['p50_ms']:.2f}/{roll['p99_ms']:.2f} ms | "
          f"monotone series checked {len(monotone_samples(first))}")
    print("kernels " + json.dumps(launch_counts()))
    print("OK")


if __name__ == "__main__":
    main()
