"""Training cells: a closed loop of back-to-back steps of the program's
``launch/train.make_train_step``.

Set-up draws the weights from the seed (``core/weights``), hands them to
the program (``adapters/<family>``), builds the step and its AdamW and
gating state once, makes a pool of batches on the host
(``core/traffic.lm_batch``) and runs the first steps through the same
call and feed as the window: they warm up every shape, and from them the
program's side of the check is read (each step's loss; each leaf's first
gradient from its AdamW first moment, m / (1 - b1) / clip; each leaf's
change over those steps). The window then runs whole steps until
``--seconds`` have passed and ends in a device synchronise: the rate is
every token of every step over the window's time.

After the window (and, with ``--trace 1``, a traced pass of a few steps
and the optimizer's own time), the program's state is freed and the
reference (``reference/train.py``) runs the first steps from the same
weights and batches."""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from ..core import compare, counts, traffic
from ..core import trace as trace_lib
from ..core.spec import Cell
from ..reference import common as ref_common
from ..reference import train as ref_train
from .common import Family, device_record, free, sync
from .prefill import log_setup


def _hparams(settings: Dict):
    from repro_torch.core.gating import GatingConfig
    from repro_torch.launch.train import TrainHParams
    from repro_torch.optim import AdamWConfig
    gating = settings.get("gating")
    return TrainHParams(opt=AdamWConfig(**settings["opt"]),
                        gating=GatingConfig(**gating) if gating else None,
                        moe_aux_weight=settings.get("moe_aux_weight", 0.01))


def make_pool(cell: Cell, seed: int, device) -> list:
    """The window's batches, made ahead on the host (pinned for the
    card); the window cycles through them."""
    pool = [make_pool_rows(cell, seed, i) for i in range(cell.traffic["pool"])]
    if torch.device(device).type == "cuda":
        pool = [{k: v.pin_memory() for k, v in b.items()} for b in pool]
    return pool


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, wrap_step: Optional[Callable] = None,
        prec: Optional[ref_common.Prec] = None) -> Dict:
    """One run of the cell. ``wrap_step`` (tests) replaces the program's
    step by a broken one; ``prec`` sets the reference's precision."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim import adamw_init, adamw_update, gated_scale_tree
    from repro_torch.optim.sparse import SparseTrainState

    port, t, settings = cell.config["port"], cell.traffic, cell.settings
    fam = Family(port)
    cfg = fam.model_config()
    spans = trace_lib.Spans()
    hp = _hparams(settings)
    b1 = settings["opt"]["b1"]
    params = fam.port_params(seed, device)
    state = [params, adamw_init(params),
             SparseTrainState.init(port["n_layers"], port["d_model"],
                                   device=device)]
    step = make_train_step(cfg, hp, attn="flash",
                           loss_chunk=settings.get("loss_chunk"))
    if wrap_step is not None:
        step = wrap_step(step)
    pool = make_pool(cell, seed, device)
    names = [leaf.name for leaf in fam.leaves]
    sync(device)
    t_built = time.perf_counter()

    def feed(i: int) -> Dict:
        with spans("bench.copy"):
            return {k: v.to(device, non_blocking=True)
                    for k, v in pool[i % len(pool)].items()}

    def one(i: int) -> Dict:
        batch = feed(i)
        with spans("bench.step"):
            state[0], state[1], state[2], m = step(*state, batch)
        return m

    # the first steps: warm-up, and the program's side of the check
    first = t["first_steps"]
    losses, grad_norm = [], None
    for i in range(first):
        m = one(i)
        losses.append(m["loss"].detach().float())
        if i == 0:
            clip = torch.clamp(settings["opt"]["grad_clip"]
                               / (m["grad_norm"].float() + 1e-9), max=1.0)
            grad_norm = torch.stack([
                fam.view(state[1].m, n).float().norm() for n in names]) \
                / (1 - b1) / clip
    get0 = fam.getter(seed, device)
    change = torch.stack([(fam.view(state[0], n).float()
                           - get0(n).float()).norm() for n in names])
    prog = {"loss": [float(x) for x in losses],
            "grad_norm": dict(zip(names, grad_norm.tolist())),
            "change_norm": dict(zip(names, change.tolist()))}
    del change, grad_norm
    sync(device)

    # the window
    tokens_step = t["batch"] * t["seq"]
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    log_setup(t_start, [("start", t_built), ("first steps", t0)])
    n, window_losses = 0, []
    while True:
        window_losses.append(one(first + n)["loss"].detach())
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    dev = device_record(device, cell.entry["chips"])

    out = {"attempted": n, "failed": failed, "device": dev,
           "metrics": {"train_tokens_per_s": n * tokens_step / window_s,
                       "setup_s": setup_s}}
    if trace:
        k = t["trace_steps"]
        base = first + n
        traced = trace_lib.record(
            torch, lambda: [one(base + j) for j in range(k)], spans)
        batch = feed(base + k)
        sync(device)
        ta = time.perf_counter()
        _, _, grads = step.loss_and_grads(state[0], batch)
        sync(device)
        tb = time.perf_counter()
        ones = torch.ones(port["n_layers"], device=device)
        adamw_update(grads, state[0], state[1], hp.opt,
                     gated_scale_tree(state[0], ones, cfg.sparsity))
        sync(device)
        adamw_s = time.perf_counter() - tb
        del grads, batch
        out["device"]["busy_s"] = trace_lib.busy_s(traced)
        out["device"]["window_s"] = traced.window_s
        out["breakdown"] = trace_lib.breakdown(traced)
        out["layer_ctx"] = {
            "kind": "train", "port": port, "window_s": window_s,
            "steps": n, "work_flops": n * counts.model_flops(
                port, t["batch"], t["seq"], "train"),
            "trace": traced, "trace_tokens": k * tokens_step,
            "flash_shapes": None, "flash_b": t["batch"], "flash_s": t["seq"],
            "adamw_s": adamw_s, "loss_and_grads_s": tb - ta}
    del state, step, params, pool
    free(device)

    # the reference, from the same weights and batches
    ref_common.strict_f32()
    batches = [{k: v.to(device) for k, v in make_pool_rows(cell, seed, i)
                .items()} for i in range(first)]
    ref = ref_train.train(fam.model, port, get0, batches, settings,
                          prec or ref_common.Prec())
    numbers = compare.train_numbers(prog, ref)
    out.update(compare.judge(numbers, settings["limits"]))
    out["numbers"] = numbers
    out["readings"] = {"program": prog, "reference": ref}
    return out


def make_pool_rows(cell: Cell, seed: int, i: int) -> Dict:
    """Batch ``i`` of the seed's pool, on the host."""
    t, port = cell.traffic, cell.config["port"]
    b = traffic.lm_batch(seed, i, port["vocab"], t["batch"], t["seq"],
                         t["zipf_a"], t["zipf_q"])
    return {k: torch.from_numpy(v) for k, v in b.items()}


def control(cell: Cell, seed: int, device):
    """The control: the reference computed in fp8 put in the program's
    place, judged against the f32 reference on the same first steps.
    Returns (numbers, readings)."""
    port = cell.config["port"]
    fam = Family(port)
    ref_common.strict_f32()
    batches = [{k: v.to(device) for k, v in make_pool_rows(cell, seed, i)
                .items()} for i in range(cell.traffic["first_steps"])]
    get0 = fam.getter(seed, device)
    ref = ref_train.train(fam.model, port, get0, batches, cell.settings,
                          ref_common.Prec())
    free(device)
    low = ref_train.train(fam.model, port, get0, batches, cell.settings,
                          ref_common.Prec(fp8=True))
    return compare.train_numbers(low, ref), {"control": low,
                                             "reference": ref}
