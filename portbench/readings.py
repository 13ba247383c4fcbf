"""The readings that a cell's limits are set from, on the card at the
cell's own size (the benchmark's runs never do this):

    python3 portbench/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--out <file>]

* each of ``--seeds``: a sound run of the program (training: set-up, its
  first steps, one step of window, the reference; prefill: a window of
  one length cycle, which serves as many requests as a run compares):
  the numbers it is judged by;
* each of ``--control-seeds``: the control, the reference computed in fp8
  (``reference/common.Prec``) put in the program's place and judged
  against the f32 reference (prefill: the token that fp8 puts first at
  the last position of the same sample of prompts);
* each of ``--fault-seeds``: each fault of ``faults.py`` that reads a
  number (``half_batch``; ``token_altered``, ``rows_left_out``) planted
  under the program.

Prints one JSON line per reading and writes them all to ``--out``."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench.core import env, spec  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    env.prepare()
    import torch
    env.need_devices(torch, 1)
    import importlib
    from portbench import faults
    from portbench.drivers.common import free
    cell = spec.cell(args.workload)
    driver = importlib.import_module(f"portbench.drivers.{cell.kind}")
    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    prefill = cell.kind == "prefill"
    window = 3.0 if prefill else 0.01
    for s in args.seeds:
        t0 = time.perf_counter()
        res = driver.run(cell, s, window, False, "cuda", t0)
        emit({"what": "program", "seed": s, "numbers": res["numbers"],
              "setup_s": res["metrics"].get("setup_s"),
              "readings": res["readings"], "s": time.perf_counter() - t0})
        free("cuda")
    for s in args.control_seeds:
        t0 = time.perf_counter()
        numbers, readings = driver.control(cell, s, "cuda")
        emit({"what": "control_fp8", "seed": s, "numbers": numbers,
              "readings": readings, "s": time.perf_counter() - t0})
        free("cuda")
    for s in args.fault_seeds:
        for name in faults.PREFILL_FAULTS if prefill else ("half_batch",):
            t0 = time.perf_counter()
            kw = ({"wrap_generate": faults.PREFILL_FAULTS[name]} if prefill
                  else {"wrap_step": faults.TRAIN_FAULTS[name]})
            res = driver.run(cell, s, window, False, "cuda", t0, **kw)
            emit({"what": name, "seed": s, "numbers": res["numbers"],
                  "s": time.perf_counter() - t0})
            free("cuda")
    print(f"peak {torch.cuda.max_memory_allocated()}", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
