"""The harness is driven by data: BENCHMARK.json against the contract's
shapes and characters, every name it holds found as a file, and a cell
and a per-layer metric added as new files found with no other file
edited."""
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

from portbench.core import spec

REPO = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_and_units_have_allowed_characters():
    assert spec.check_names(BENCH) == []
    assert spec.check_names({"configs": [], "workloads": [
        {"name": "a b", "config": "x/y", "traffic": "t"}],
        "end_to_end": [{"name": "m", "unit": "tokens per s"}],
        "per_layer": [{"name": "µs", "unit": "us"}]}) == [
        "workloads: name 'a b'", "workloads: config 'x/y'",
        "end_to_end: unit 'tokens per s'", "per_layer: name 'µs'"]


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_name_is_a_file_and_every_cell_reports_enough():
    used = set()
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        used.add(w["config"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert (spec.ROOT / "drivers" / f"{cell.kind}.py").exists()
        fam = cell.config["port"]["family"]
        assert (spec.ROOT / "reference" / f"{fam}.py").exists()
        assert (spec.ROOT / "adapters" / f"{fam}.py").exists()
        assert "limits" in cell.settings
        for m in cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"]).read)
            assert m["moves"] in names
    assert used == {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells


def test_config_files_lie_under_paths_and_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and (REPO / f).exists()


NEW_METRIC = '''
def read(ctx):
    return None if ctx.get("kind") != "prefill" else 42.0
'''


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    repo = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", repo / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    base = bench["workloads"][-1]
    bench["workloads"].append(dict(base, name="added.cell",
                                   traffic="added_mix"))
    bench["per_layer"].append({
        "name": "added_metric.prefill", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": bench["end_to_end"][0]["name"],
        "workloads": ["added.cell"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((REPO / "portbench" / "traffic" /
                      f"{base['traffic']}.json").read_text())
    (repo / "portbench" / "traffic" / "added_mix.json").write_text(
        json.dumps(mix))
    (repo / "portbench" / "workloads" / "added.cell.json").write_text(
        (REPO / "portbench" / "workloads" / f"{base['name']}.json")
        .read_text())
    (repo / "portbench" / "metrics" / "added_metric.prefill.py").write_text(
        NEW_METRIC)
    probe = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench.core import spec\n"
        "c = spec.cell('added.cell')\n"
        "names = [m['name'] for m in c.per_layer]\n"
        "assert 'added_metric.prefill' in names, names\n"
        "r = spec.load_module('metrics', 'added_metric.prefill')"
        ".read({'kind': c.kind})\n"
        "print(c.kind, r, spec.BENCHMARK)\n")
    out = subprocess.run([sys.executable, "-c", probe, str(repo)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    kind, value, where = out.stdout.split()
    assert kind == mix["kind"] and pathlib.Path(where) == \
        repo / "BENCHMARK.json"
    assert kind != "prefill" or float(value) == 42.0


def test_unknown_cell_and_metric_are_refused():
    with pytest.raises(KeyError):
        spec.cell("no.such.cell", BENCH)
    with pytest.raises(FileNotFoundError):
        spec.load_module("metrics", "no_such_metric")
