"""Prefill cells: a scoring server (classification, reranking) that
batches prompts of one length to a fixed budget of ``batch_tokens``
tokens and takes one token back for each. A batch goes to the program's
``launch/serve.generate(..., n_new=1, attn="flash")`` (greedy) when the
previous batch's tokens are on the host, a closed loop; prompt lengths
follow the traffic's fixed cycle, token ids are uniform over the
vocabulary from the seed (``core/traffic.prompt_batches``).

Set-up draws the weights, hands them to the program and runs one batch
of each length the cycle holds (every shape the window uses). The
window then sends batches until ``--seconds`` have passed and the length
cycle is whole (the window holds whole cycles, so that where it ends in
the cycle does not move the mix it measures): ``prefill_tokens_per_s``
is every prompt token of every request over the window's time,
``ttft_p95_ms`` the 95th percentile over every request of the time from
when it was due (its batch was sent) to its token on the host.

After the window the program's weights are freed, and a sample of the
batches it served, drawn from the seed with one of the longest among
them, goes through the reference (``reference/train.last_logits``, f32):
the numbers are the widest gap by which a served token's reference logit
lies below the reference's best (``gap``), and the mean and the root mean
square of those gaps over the sample (``mean_gap``, ``rms_gap``); each
cell's settings give the limits of the numbers it is held to."""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import counts, traffic
from ..core.compare import judge
from ..core import trace as trace_lib
from ..core.spec import Cell
from ..reference import common as ref_common
from ..reference import train as ref_train
from .common import Family, LayerCache, device_record, free, sync


def make_pool(cell: Cell, seed: int, device) -> List[torch.Tensor]:
    t, port = cell.traffic, cell.config["port"]
    pool = [torch.from_numpy(b) for b in traffic.prompt_batches(
        seed, port["vocab"], t["batch_tokens"], t["lengths"], t["pool"])]
    if torch.device(device).type == "cuda":
        pool = [b.pin_memory() for b in pool]
    return pool


def log_setup(t_start: float, marks) -> None:
    """Where set-up went, on standard error: imports and process start,
    then each phase."""
    parts = [f"imports {marks[0][1] - t_start:.2f}"]
    parts += [f"{name} {t - prev:.2f}" for (_, prev), (name, t)
              in zip(marks, marks[1:])]
    print("setup_s: " + ", ".join(parts), file=sys.stderr, flush=True)


def log_latency(lengths: List[int], per_batch: List[float]) -> None:
    """Each prompt length's batch latencies in the window (median and
    largest, ms, and how many), on standard error."""
    by: Dict[int, List[float]] = {}
    for j, v in enumerate(per_batch):
        by.setdefault(lengths[j % len(lengths)], []).append(1e3 * v)
    print("batch_ms: " + ", ".join(
        f"{L}: {float(np.median(v)):.2f} / {max(v):.2f} ({len(v)})"
        for L, v in sorted(by.items())), file=sys.stderr, flush=True)


def sample_batches(served: List, seed: int, n: int, pool: int) -> List[int]:
    """``n`` of the served batches (each request ``(batch, row, token,
    length)``), drawn from the seed, no two of the same prompts (batch
    ``i`` sends ``pool[i % pool]``), one of the longest among them. A
    batch is compared whole: its rows share the experts' capacity."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5A3]))
    length = {}
    for r in served:
        length.setdefault(r[0], r[3])
    first = {}
    for b in sorted(length):
        first.setdefault(b % pool, b)
    ids = sorted(first.values())
    longest = [b for b in ids if length[b] == max(length.values())]
    pick = [longest[int(rng.integers(len(longest)))]]
    rest = [b for b in ids if b != pick[0]]
    pick += [rest[j] for j in rng.choice(len(rest), size=min(n - 1, len(rest)),
                                         replace=False)]
    return sorted(pick)


def gap_numbers(g: List[float]) -> Dict[str, float]:
    """The widest gap, the mean gap and the root mean square gap of a
    sample."""
    return {"gap": max(g), "mean_gap": sum(g) / len(g),
            "rms_gap": (sum(x * x for x in g) / len(g)) ** 0.5}


def gaps(logits: List[torch.Tensor], tokens: List[int]) -> List[float]:
    """How far each served token's reference logit lies below the best."""
    return [float(lg.max() - lg[t]) for lg, t in zip(logits, tokens)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, wrap_generate: Optional[Callable] = None,
        prec: Optional[ref_common.Prec] = None) -> Dict:
    """One run of the cell. ``wrap_generate`` (tests) replaces the
    program's ``generate`` by a broken one."""
    from repro_torch.launch.serve import generate

    port, t, settings = cell.config["port"], cell.traffic, cell.settings
    fam = Family(port)
    cfg = fam.model_config()
    spans = trace_lib.Spans()
    marks = [("start", time.perf_counter())]
    params = fam.port_params(seed, device)
    sync(device)
    marks.append(("weights", time.perf_counter()))
    gen = wrap_generate(generate) if wrap_generate else generate
    pool = make_pool(cell, seed, device)
    marks.append(("prompts", time.perf_counter()))

    def one(i: int) -> torch.Tensor:
        with spans("bench.copy"):
            prompt = pool[i % len(pool)].to(device, non_blocking=True)
        with spans("bench.step"):
            out = gen(params, cfg, prompt, t["n_new"], attn="flash")
        with spans("bench.read"):
            return out[:, prompt.shape[1]].cpu()

    lengths = t["lengths"]
    for L in sorted(set(lengths)):            # every shape of the window
        one(lengths.index(L))
    sync(device)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    marks.append(("warm-up", t0))
    log_setup(t_start, marks)
    due, i, ttft, served, tokens, per_batch = t0, 0, [], [], 0, []
    while True:
        first = one(i)
        back = time.perf_counter()
        b = pool[i % len(pool)]
        per_batch.append(back - due)
        for row in range(b.shape[0]):
            ttft.append(back - due)
            served.append((i, row, int(first[row]), b.shape[1]))
        tokens += b.numel()
        due, i = back, i + 1
        if back - t0 >= seconds and i % len(lengths) == 0:
            break
    window_s = time.perf_counter() - t0
    log_latency(lengths, per_batch)
    dev = device_record(device, cell.entry["chips"])
    q = sorted(ttft)
    out = {"attempted": len(served), "failed": 0, "device": dev,
           "metrics": {"prefill_tokens_per_s": tokens / window_s,
                       "ttft_p95_ms": 1e3 * float(np.percentile(q, 95)),
                       "setup_s": setup_s}}
    if trace:
        base = i
        n = len(lengths)
        traced = trace_lib.record(torch, lambda: [one(base + j)
                                                  for j in range(n)],
                                   spans)
        shapes = []
        for j in range(n):
            b = pool[(base + j) % len(pool)]
            shapes += [("flash_fwd", b.shape[0], b.shape[1])] \
                * counts.attn_calls(port)
        work = sum(counts.model_flops(port, pool[j % len(pool)].shape[0],
                                      pool[j % len(pool)].shape[1], "prefill")
                   for j in range(i))
        out["device"]["busy_s"] = trace_lib.busy_s(traced)
        out["device"]["window_s"] = traced.window_s
        out["breakdown"] = trace_lib.breakdown(traced)
        out["layer_ctx"] = {
            "kind": "prefill", "port": port, "window_s": window_s,
            "work_flops": work, "trace": traced,
            "trace_tokens": sum(pool[(base + j) % len(pool)].numel()
                                for j in range(n)),
            "flash_shapes": shapes}
    del params
    free(device)

    # the reference, on a sample of what the window served
    ref_common.strict_f32()
    picked = sample_batches(served, seed, settings["sample_batches"],
                            len(pool))
    logits = ref_train.last_logits(
        fam.model, port, LayerCache(fam.getter(seed, device)),
        [pool[b % len(pool)].to(device) for b in picked],
        prec or ref_common.Prec())
    tok = {(r[0], r[1]): r[2] for r in served}
    g = [gap for b, lg in zip(picked, logits)
         for gap in gaps(list(lg), [tok[(b, row)] for row in range(len(lg))])]
    numbers = gap_numbers(g)
    out.update(judge(numbers, settings["limits"]))
    out["numbers"] = numbers
    out["readings"] = {"batches": picked, "gaps": g}
    return out


def control(cell: Cell, seed: int, device):
    """The control: the reference computed in fp8 put in the program's
    place. At the last position of a sample of the cell's batches (drawn
    from its pool of lockstep batches as a run draws what it served), the
    token that fp8 puts first, and its gap in the f32 reference.
    Returns (numbers, readings)."""
    port = cell.config["port"]
    fam = Family(port)
    pool = make_pool(cell, seed, "cpu")
    served = [(i, r, -1, b.shape[1]) for i, b in enumerate(pool)
              for r in range(b.shape[0])]
    batches = [pool[i].to(device) for i in
               sample_batches(served, seed, cell.settings["sample_batches"],
                              len(pool))]
    ref_common.strict_f32()
    ref, low = (ref_train.last_logits(fam.model, port,
                                      LayerCache(fam.getter(seed, device)),
                                      batches, ref_common.Prec(fp8=fp8))
                for fp8 in (False, True))
    ref = [row for lg in ref for row in lg]
    g = gaps(ref, [int(row.argmax()) for lg in low for row in lg])
    top2 = [float(x.topk(2).values[0] - x.topk(2).values[1]) for x in ref]
    return gap_numbers(g), {"gaps": g, "ref_top2": top2}
