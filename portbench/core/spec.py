"""What a run reads: ``BENCHMARK.json`` and the files that its names point
at. Every configuration, traffic mix, cell and per-layer metric is a file
of its own, found by its name, so a later cell or metric is added as files
and nothing here changes:

* ``configs/<config>.json``   — the sizes as run (``BENCHMARK.json`` names
  the file);
* ``traffic/<traffic>.json``  — the mix, with its ``kind``;
* ``workloads/<cell>.json``   — the cell's program settings and the limits
  of its correctness check;
* ``drivers/<kind>.py``       — one entry kind (``train``, ``prefill``);
* ``metrics/<name>.py``       — one per-layer metric's reader;
* ``reference/<family>.py``, ``adapters/<family>.py`` — one model family.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from typing import Any, Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[1]          # portbench/
REPO = ROOT.parent
BENCHMARK = REPO / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict[str, Any]           # the cell's entry in BENCHMARK.json
    config: Dict[str, Any]          # configs/<config>.json
    traffic: Dict[str, Any]         # traffic/<traffic>.json
    settings: Dict[str, Any]        # workloads/<cell>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(BENCHMARK)


def _reported_in(metric: Dict[str, Any], cell: str,
                 e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def cell(name: str, bench: Dict[str, Any] = None) -> Cell:
    """The cell ``name`` with every file it names loaded, and the metrics
    it reports (a metric with a ``workloads`` key where it lists the cell;
    an end-to-end one without it in every cell; a per-layer one without it
    wherever its ``moves`` metric is reported)."""
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(REPO / configs[entry["config"]]["file"])
    traffic = load_json(ROOT / "traffic" / f"{entry['traffic']}.json")
    wl = ROOT / "workloads" / f"{name}.json"
    settings = load_json(wl) if wl.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reported_in(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reported_in(m, name, e2e_names)]
    return Cell(name, entry, conf, traffic, settings, e2e, per_layer)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so it is loaded by path, not imported by name)."""
    path = ROOT / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.name} in "
                                f"portbench/{kind}/")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_names(bench: Dict[str, Any]) -> List[str]:
    """Every name and unit of ``bench`` against the allowed characters;
    the faults found (empty when it is sound)."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            if not NAME.match(e["name"]):
                bad.append(f"{group}: name {e['name']!r}")
            if "unit" in e and not UNIT.match(e["unit"]):
                bad.append(f"{group}: unit {e['unit']!r}")
            for key in ("config", "traffic"):
                if key in e and not NAME.match(e[key]):
                    bad.append(f"{group}: {key} {e[key]!r}")
            for key in e.get("reduced", []):
                if not NAME.match(key):
                    bad.append(f"{group}: reduced key {key!r}")
    return bad
