"""Event-stream serving demo on the port: many live SNN sessions on one
slot grid.

Eight gesture streams arrive asynchronously (Poisson chunk arrivals) and
are multiplexed onto a 4-slot grid: one chunk step advances every active
stream, the activity-dependent gate decides per stream when its OSSL delta
absorbs an update, and telemetry prices each stream at the chip's 0.6 V
operating point. A ``TopologyService`` keeps DSST alive under this
traffic: every 10 grid steps the hottest stream's adaptation is folded
into the shared base and a prune/regrow epoch evolves the N:M topology —
with one chunk fn for the whole run. The scheduler runs with
``pipeline_depth=1``: host event staging for step t+1 overlaps the device
compute of step t (bit-identical results to the serial path). On the card
each chunk step launches the fused ``nm_spmm``, ``lif`` and
``wu_outer_slots`` once a layer-timestep.

    PYTHONPATH=src python examples/torch/stream_serving_demo.py [--device cpu]

The last line counts the kernels' launches.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

from repro_torch.core.snn import SNNConfig, init_params            # noqa: E402
from repro_torch.data.events import make_task                      # noqa: E402
from repro_torch.kernels import launch_counts                      # noqa: E402
from repro_torch.serving import (AdaptConfig, ArrivalConfig,       # noqa: E402
                                 StreamScheduler, StreamSession,
                                 TaskStreamSource, TopologyService,
                                 TopologyServiceConfig)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    cfg = SNNConfig(n_in=64, n_hidden=64, n_layers=2, n_out=10, t_steps=20,
                    backend="kernels")
    params = init_params(0, cfg, device=dev)
    task = make_task("gesture", n_in=cfg.n_in, t_steps=cfg.t_steps)

    topo = TopologyService(cfg, TopologyServiceConfig(epoch_every=10,
                                                      merge_top=1))
    sched = StreamScheduler(params, cfg, n_slots=4, chunk_len=8,
                            adapt=AdaptConfig(delta_clip=0.5),
                            topology=topo, pipeline_depth=1, device=dev)
    arrival = ArrivalConfig(min_chunk=4, max_chunk=10, mean_gap_s=0.003)
    for sid in range(8):
        sched.submit(StreamSession(
            sid=sid,
            source=TaskStreamSource(task, n_windows=3, seed=sid,
                                    arrival=arrival),
            adapt=(sid % 2 == 0)))   # every other stream serves frozen

    try:
        done = sched.run_until_drained()
    finally:
        sched.close()

    print(f"retired {len(done)} streams | grid steps "
          f"{sched.grid.stats['steps']} | utilization "
          f"{sched.utilization:.2f} | compiled variants {sched.n_compiles}")
    print(f"{'sid':>3} {'adapt':>5} {'windows':>7} {'pred labels':>12} "
          f"{'skip':>6} {'uW':>7} {'|delta|':>8}")
    for sess in sorted(done, key=lambda s: s.sid):
        c = sched.telemetry.stream(sess.sid)
        e = c.energy()
        dn = sum(float((d ** 2).sum()) for d in sess.final_deltas) ** 0.5
        labels = ",".join(str(p.label) for p in sess.predictions)
        print(f"{sess.sid:>3} {str(sess.adapt):>5} {c.windows:>7} "
              f"{labels:>12} {c.wu_skip_rate:>6.2f} {e['power_uW']:>7.1f} "
              f"{dn:>8.4f}")

    r = sched.telemetry.rollup()
    print(f"\nfleet: {r['events_per_s']:.0f} events/s | "
          f"p50 {r['p50_ms']:.1f} ms / p99 {r['p99_ms']:.1f} ms per grid "
          f"step | WU skip {r['wu_skip_rate']:.2f} | modeled "
          f"{r['fleet_energy']['power_uW']:.1f} uW")
    print(f"topology: {r['topology_epochs']} live epochs | "
          f"{r['topology_pruned']} pruned / {r['topology_regrown']} regrown "
          f"| mask change {r['topology_mask_change_mean']:.4f} | "
          f"{r['streams_merged']} hot streams folded into the base")
    print("kernels " + json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
