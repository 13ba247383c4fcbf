"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; last, under
``checks``, each number that decided ``correct`` beside its limit, which
also end standard error. Without a CUDA device, or with fewer than the
cell asks for, it exits with code 2 and prints no result; so it does when
the process holds JAX or the JAX package once the window has closed
(code 3)."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench.core import env, spec  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def layer_metrics(cell: spec.Cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = spec.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: spec.Cell, res: dict, traced: bool) -> dict:
    if traced:
        metrics = layer_metrics(cell, res.get("layer_ctx", {}))
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in res["metrics"].items() if k in units}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": res["device"]}
    if traced and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    env.prepare()
    cell = spec.cell(args.workload)
    import torch
    try:
        env.need_devices(torch, cell.entry["chips"])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    driver = importlib.import_module(f"portbench.drivers.{cell.kind}")
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     T_START)
    found = env.forbidden_loaded()
    if found:
        print(f"the run's process holds {found}: the port must not load JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    line = result_line(cell, res, bool(args.trace))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
