#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each raising on failure:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: compile the hand-written kernels from the sources in the
   checkout (``nm_spmm``: CUDA C++ with ``nvcc``; ``lif``: Triton).
3. kernel parity: each kernel against its plain torch version on the card,
   at the serving path's shapes and at a tiled / ragged shape, with its
   device time (summed kernel durations in a ``torch.profiler`` trace, L2
   flushed before each call; ``wall_ms`` is back-to-back calls by CUDA
   events, L2 warm, host launch gaps included), the plain version's, the
   least time the card could take
   (bytes over 3.35 TB/s or flops over the dtype's peak, whichever is
   larger) and, where one PyTorch call computes the same function, that
   call's time (timed only; the port never calls it).
4. serving at full width: the paper network (512-512-512-16, T=50, 80 %
   N:M sparsity, gating on, backend "kernels") serves 1024 gesture streams
   of 4 windows each through ``StreamScheduler`` (1024 slots, chunk 8,
   pipeline depth 1) until drained. Every stream must get 4 predictions,
   each kernel must have launched grid steps x 8 x 2 times in that run,
   and the deltas must be finite. Then, for the record, one full-grid chunk
   step under ``torch.profiler``: host wall, enqueue time, device busy time.
5. path parity: one 8-step chunk of 64 slots through backend "kernels"
   and backend "ref" (plain LIF): logits close; spikes equal up to a first
   flip within rounding of the threshold, and >= 99.9 % equal over the
   neuron-steps where either side spiked.

Prints the kernels line (JSON), the card line, and last
``{"ok": true, "device": {...}}``; the full record goes to
``chiprun_out/chip_smoke.json``. Exits non-zero, printing no result, when
no CUDA device is present or the port's sources are missing.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # CUDA-core f32, dense bf16
N_STREAMS, N_WINDOWS, CHUNK_LEN = 1024, 4, 8


def log(msg):
    print(msg, flush=True)


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_kernels(torch, fn, iters=1):
    """The device-side events (kernels, copies) of ``iters`` calls of ``fn``
    in a ``torch.profiler`` trace, after one warm-up call, and the host wall
    time in ms of those same traced calls up to the end of their device
    work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA], wall


def device_ms(torch, fn, iters=20):
    """Device time of one call of ``fn``: the summed durations of the
    kernels it launches, so the host's launch gaps between them do not
    count (they do in ``wall_ms``). The 50 MB L2 is flushed before every
    call, as the serving step's ~1 GB working set leaves it; the flush's
    own kernels are left out of the sum."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush_names = {e.name for e in device_kernels(torch, scratch.zero_)[0]}

    def flushed():
        scratch.zero_()
        fn()
    kernels = [e for e in device_kernels(torch, flushed, iters)[0]
               if e.name not in flush_names]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / iters


def wall_ms(torch, fn, iters=20):
    """Time per call of ``iters`` back-to-back calls, by CUDA events: the
    device time plus whatever gaps the host's launches leave (L2 warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings(torch, prefix, fn):
    return {f"{prefix}ms": device_ms(torch, fn),
            f"{prefix}wall_ms": wall_ms(torch, fn)}


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def nm_case(torch, name, dtype, b, k, o, spec, sparse_x):
    from repro_torch.core.sparsity import random_unit_mask
    from repro_torch.kernels.nm_spmm import ops, ref
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm_cuda
    gen = torch.Generator().manual_seed(0)
    mask = random_unit_mask(gen, spec, k, o)
    w = torch.randn((k, o), generator=gen)
    wc, idx = ops.make_compact(w, mask, spec.block, spec.out_tile)
    x = ((torch.rand((b, k), generator=gen) < 0.1).float() if sparse_x
         else torch.randn((b, k), generator=gen))
    x, wc, idx = (x.to("cuda", dtype), wc.to("cuda", dtype), idx.cuda())
    dense = ref.densify(wc, idx, k)
    y_k = nm_spmm_cuda(x, wc, idx)
    y_r = ref.nm_spmm(x, wc, idx)
    torch.cuda.synchronize()
    err = max_err(y_k, y_r)
    # f32: only the summation order differs; bf16: both round the f32 sum
    # to bf16 (8-bit mantissa), so allow a few of its ulps at |y|
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * (1 + float(y_r.float().abs().max()))
    if not err <= tol:
        raise AssertionError(f"nm_spmm {name}: max |kernel - plain| {err} > {tol}")
    j, t, bk, bo = wc.shape
    es = x.element_size()
    nbytes = (x.numel() + wc.numel() + y_k.numel()) * es + idx.numel() * 4
    flops = 2 * b * j * t * bk * bo
    dname = str(dtype).split(".")[-1]
    bound_ms, bound_by = bound(nbytes, flops, dname)
    rec = {"case": name, "dtype": dname, "shape": [b, k, j, t, bk, bo],
           "max_abs_err": err, "tol": tol,
           **timings(torch, "", lambda: nm_spmm_cuda(x, wc, idx)),
           **timings(torch, "plain_", lambda: ref.nm_spmm(x, wc, idx)),
           **timings(torch, "library_", lambda: torch.matmul(x, dense)),
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"parity nm_spmm {json.dumps(rec)}")
    return rec


def lif_case(torch, shape):
    from repro_torch.kernels.lif import ref
    from repro_torch.kernels.lif.kernel import lif_cuda
    gen = torch.Generator().manual_seed(1)
    v, cur = (torch.randn(shape, generator=gen).cuda() for _ in range(2))
    tr = torch.rand(shape, generator=gen).cuda()
    kw = dict(alpha=0.9, beta=0.85, theta=1.0)
    got = lif_cuda(v, tr, cur, **kw)
    want = ref.lif_step(v, tr, cur, **kw)
    torch.cuda.synchronize()
    err = max(max_err(a, b) for a, b in zip(got, want))
    # the kernel may fuse αv + I into one FMA (one rounding, not two)
    if not err <= 1e-5:
        raise AssertionError(f"lif {shape}: max |kernel - plain| {err} > 1e-5")
    n = v.numel()
    bound_ms, bound_by = bound(6 * n * 4, 7 * n, "float32")
    rec = {"case": "x".join(map(str, shape)), "dtype": "float32",
           "max_abs_err": err, "tol": 1e-5,
           **timings(torch, "", lambda: lif_cuda(v, tr, cur, **kw)),
           **timings(torch, "plain_", lambda: ref.lif_step(v, tr, cur, **kw)),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"parity lif {json.dumps(rec)}")
    return rec


def paper_config(backend):
    from repro_torch.core.dsst import DSSTConfig
    from repro_torch.core.gating import GatingConfig
    from repro_torch.core.snn import SNNConfig
    return SNNConfig(n_in=512, n_hidden=512, n_layers=2, n_out=16,
                     t_steps=50, sparsity=0.8,
                     dsst=DSSTConfig(period=40, prune_frac=0.25),
                     gating=GatingConfig(enabled=True), backend=backend)


def serve(torch, params, task):
    from repro_torch.kernels.lif.kernel import lif_cuda
    from repro_torch.kernels.nm_spmm.kernel import nm_spmm_cuda
    from repro_torch.serving import (StreamScheduler, StreamSession,
                                     TaskStreamSource)
    cfg = paper_config("kernels")
    t0 = time.perf_counter()
    sources = [TaskStreamSource(task, N_WINDOWS, seed=sid)
               for sid in range(N_STREAMS)]
    sched = StreamScheduler(params, cfg, n_slots=N_STREAMS,
                            chunk_len=CHUNK_LEN, pipeline_depth=1,
                            device="cuda")
    for sid, src in enumerate(sources):
        sched.submit(StreamSession(sid=sid, source=src))
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nm_spmm_cuda.launches = 0
    lif_cuda.launches = 0
    t0 = time.perf_counter()
    done = sched.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"nm_spmm": nm_spmm_cuda.launches, "lif": lif_cuda.launches}
    steps = sched.grid.stats["steps"]
    want = steps * CHUNK_LEN * cfg.n_layers
    if len(done) != N_STREAMS:
        raise AssertionError(f"{len(done)} of {N_STREAMS} streams retired")
    short = [s.sid for s in done if len(s.predictions) != N_WINDOWS]
    if short:
        raise AssertionError(f"streams without {N_WINDOWS} predictions: {short[:8]}")
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name} launched {n} times, want {want} "
                                 f"(= {steps} steps x {CHUNK_LEN} x {cfg.n_layers})")
    if not bool(torch.isfinite(sched.deltas).all()):
        raise AssertionError("non-finite serving deltas")
    if not all(bool(torch.isfinite(torch.from_numpy(s.final_deltas)).all())
               for s in done):
        raise AssertionError("non-finite final deltas")
    roll = sched.telemetry.rollup()
    rec = {"streams": N_STREAMS, "windows_per_stream": N_WINDOWS,
           "grid_steps": steps, "chunk_len": CHUNK_LEN, "n_slots": N_STREAMS,
           "pipeline_depth": 1, "launches": launches, "wall_s": wall,
           "setup_s": setup_s, "events_in": roll["events_in"],
           "timesteps": roll["timesteps"],
           "events_per_s": roll["events_per_s"],
           "timesteps_per_s": roll["timesteps_per_s"],
           "p50_step_ms": roll["p50_ms"], "p99_step_ms": roll["p99_ms"],
           "overlap_ratio": roll["overlap_ratio"],
           "phases": sched.telemetry.phase_percentiles(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "deltas_bytes": sched.deltas.numel() * 4}
    log(f"serving {json.dumps(rec)}")
    return rec, launches


def step_breakdown(torch, params):
    """Where one full-grid chunk step goes (1024 slots, all valid, 8
    timesteps). One untraced call gives the host's enqueue time and its wall
    to completion; one call under ``torch.profiler`` gives the device busy
    time (summed kernel durations), the device span (first kernel start to
    last kernel end) and that same call's wall, from which the idle share
    is taken; with the largest kernels by name."""
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      serving_params)
    from repro_torch.serving import make_chunk_fn
    cfg = paper_config("kernels")
    fn = make_chunk_fn(cfg, want_factors=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    S = N_STREAMS
    args = (serving_params(params, cfg), init_stream_deltas(cfg, S, "cuda"),
            init_stream_state(cfg, S, "cuda"),
            (torch.rand((CHUNK_LEN, S, cfg.n_in), device="cuda", generator=g)
             < 0.05).float(),
            torch.ones((CHUNK_LEN, S), dtype=torch.bool, device="cuda"),
            torch.ones(S, dtype=torch.bool, device="cuda"))
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    kernels, traced_ms = device_kernels(torch, lambda: fn(*args))
    by_name = {}
    for e in kernels:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    rec = {"slots": S, "chunk_len": CHUNK_LEN, "wall_ms": step_ms,
           "enqueue_ms": enqueue_ms, "traced_wall_ms": traced_ms,
           "device_busy_ms": busy_ms, "device_span_ms": span_ms,
           "device_idle_share": 1.0 - busy_ms / traced_ms,
           "device_launches": len(kernels),
           "top": [{"name": k[:90], "ms": us / 1e3, "count": n}
                   for k, (us, n) in top]}
    log(f"step_breakdown {json.dumps(rec)}")
    return rec


def path_parity(torch, params, task):
    """One chunk through backend "kernels" and backend "ref", recording the
    spikes and pre-reset membranes of every LIF call through the engine's
    seam.

    Both backends take the same ``nm_spmm`` kernel for the current, so they
    differ only in how ``αv + I`` is rounded (the Triton kernel may fuse it
    into one FMA). So: the LIF calls must agree on every spike until a first
    call where they differ, and there every flipped neuron's membrane must
    lie within 1e-5 of θ; a flip there may change what follows, so from then
    on agreement is counted over the neuron-steps where either side spiked
    (not over all of them, where silent neurons would hide flips) and must
    be at least 99.9 %."""
    import numpy as np
    from repro_torch.core import engine
    from repro_torch.core.snn import (init_stream_deltas, init_stream_state,
                                      run_chunk, serving_params)
    n_slots = 64
    rng = np.random.default_rng(0)
    ev = np.stack([task.sample(rng, 1)[0][:CHUNK_LEN, 0]
                   for _ in range(n_slots)], axis=1)           # [C, S, n_in]
    events = torch.from_numpy(ev).cuda()
    valid = torch.ones((CHUNK_LEN, n_slots), dtype=torch.bool, device="cuda")
    out = {}
    orig = engine.lif
    for backend in ("kernels", "ref"):
        cfg = paper_config(backend)
        spikes, pre = [], []

        def recording_lif(*args, **kw):
            res = orig(*args, **kw)
            v, _, s = res
            spikes.append(s)
            pre.append(v + s * cfg.theta)      # membrane before the reset
            return res
        engine.lif = recording_lif
        try:
            _, _, m = run_chunk(serving_params(params, cfg),
                                init_stream_deltas(cfg, n_slots, "cuda"),
                                init_stream_state(cfg, n_slots, "cuda"),
                                events, valid, cfg)
        finally:
            engine.lif = orig
        out[backend] = (m.logits, torch.stack(spikes), torch.stack(pre))
    (lk, sk, _), (lr, sr, pr) = out["kernels"], out["ref"]
    calls_equal = [bool(torch.equal(a, b)) for a, b in zip(sk, sr)]
    first = calls_equal.index(False) if False in calls_equal else None
    near_theta = True
    if first is not None:
        flips = sk[first] != sr[first]
        near_theta = bool(((pr[first] - cfg.theta).abs()[flips] < 1e-5).all())
    fired = (sk > 0) | (sr > 0)
    agree = (float((sk == sr)[fired].float().mean()) if bool(fired.any())
             else 1.0)
    err = max_err(lk, lr)
    ok = torch.allclose(lk, lr, atol=1e-4, rtol=1e-4)
    rec = {"slots": n_slots, "chunk_len": CHUNK_LEN, "lif_calls": len(sk),
           "logits_max_abs_err": err,
           "spike_agreement_where_fired": agree,
           "first_differing_call": first, "first_flips_near_theta": near_theta,
           "spikes": float(sk.sum()), "fired_either": int(fired.sum())}
    log(f"path_parity {json.dumps(rec)}")
    if not ok or not near_theta or agree < 0.999:
        raise AssertionError(f"kernels vs ref path: {rec}")
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.core.snn import init_params
    from repro_torch.core.sparsity import NMSpec, paper_spec_4groups
    from repro_torch.data.events import make_task
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif.kernel import lif_cuda
    from repro_torch.kernels.nm_spmm import kernel as nm_kernel

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}

    # 2. build
    t0 = time.perf_counter()
    nm_kernel.build()
    nm_s = time.perf_counter() - t0
    for line in _build.load_library.ptxas_log.get("nm_spmm", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    t0 = time.perf_counter()
    z = torch.zeros((1024, 512), device="cuda")
    lif_cuda(z, z, z, alpha=0.9, beta=0.85, theta=1.0)
    torch.cuda.synchronize()
    lif_s = time.perf_counter() - t0
    record["build_s"] = {"nm_spmm": nm_s, "lif": lif_s}
    log(f"build {json.dumps(record['build_s'])}")

    # 3. kernel parity on the card
    paper = paper_spec_4groups(512, 0.8)
    tiled = NMSpec(n=2, m=8, block=16, out_tile=32)
    nm_recs = [nm_case(torch, name, dt, 1024, 512, 512, spec, sparse)
               for name, spec, sparse in (("paper", paper, True),
                                          ("tiled", tiled, False))
               for dt in (torch.float32, torch.bfloat16)]
    lif_recs = [lif_case(torch, shape) for shape in ((1024, 512), (1000, 500))]
    record["parity"] = {"nm_spmm": nm_recs, "lif": lif_recs}

    # 4. serving at full width
    cfg = paper_config("kernels")
    params = init_params(0, cfg, device="cuda")
    task = make_task("gesture", n_in=cfg.n_in, t_steps=cfg.t_steps)
    record["serving"], launches = serve(torch, params, task)
    record["step_breakdown"] = step_breakdown(torch, params)

    # 5. path parity
    record["path_parity"] = path_parity(torch, params, task)

    def row(name, route, source, replaces, rec):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
    kernels = {"kernels": [
        row("nm_spmm", "cuda", "src/repro_torch/kernels/nm_spmm/nm_spmm.cu",
            "src/repro/kernels/nm_spmm/kernel.py:47", nm_recs[0]),
        row("lif", "triton", "src/repro_torch/kernels/lif/kernel.py",
            "src/repro/kernels/lif/kernel.py:27", lif_recs[0])]}
    record.update(kernels)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(kernels))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
