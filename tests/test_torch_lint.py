"""The port's host-path lint (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``).

On the same planted snippets both linters report the same rule ids at the
same lines: ``OBS01``, ``OBS02``, ``DOC01``, ``.item()`` under ``SYNC01``
(each at its package's scheduler path) and ``HOST01`` (``import torch`` in
the port where the reference has ``import jax``). The port's ``SYNC01``
also flags ``.tolist()``, ``torch.cuda.synchronize()``, a stream's or
event's ``.synchronize()``, and ``.cpu()`` / ``.numpy()`` / ``bool()`` of
device state, but not the pinned host staging buffers' ``.numpy()`` nor
retire's fetch. The port's own tree lints clean against its baseline.
"""
import json
import pathlib

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint

ROOT = pathlib.Path(__file__).resolve().parents[1]

OBS01_SNIPPET = '''\
class Hist:
    def __init__(self):
        self.samples = []

    def observe(self, x):
        self.samples.append(x)
'''

OBS02_SNIPPET = '''\
import threading


class Reg:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        self.n += 1
        with self._lock:
            self.n += 1
'''

SYNC_ITEM_SNIPPET = '''\
class Sched:
    def _stage(self, tier):
        n = tier.metrics.item()
        return n

    def _retire(self, fl):
        return fl.metrics.item()
'''

HOST_SNIPPET = '''\
"""host-only module"""
import os
import {runtime}


def f():
    return os.getpid()
'''

DOC_SNIPPET = '''\
# Title

```
import numpy as np
x = np.zeros(3)
```

```python
print("tagged")
```
'''


def _ids(violations):
    return [(v.rule, v.line) for v in violations]


@pytest.mark.parametrize("case", ["OBS01", "OBS02", "SYNC01", "HOST01",
                                  "DOC01"])
def test_same_findings_as_the_reference(case):
    port_path, ref_path, port_src, ref_src = {
        "OBS01": ("src/repro_torch/obs/hist.py", "src/repro/obs/hist.py",
                  OBS01_SNIPPET, OBS01_SNIPPET),
        "OBS02": ("src/repro_torch/obs/reg.py", "src/repro/obs/reg.py",
                  OBS02_SNIPPET, OBS02_SNIPPET),
        "SYNC01": ("src/repro_torch/serving/scheduler.py",
                   "src/repro/serving/scheduler.py",
                   SYNC_ITEM_SNIPPET, SYNC_ITEM_SNIPPET),
        "HOST01": ("src/repro_torch/serving/staging.py",
                   "src/repro/serving/staging.py",
                   HOST_SNIPPET.format(runtime="torch"),
                   HOST_SNIPPET.format(runtime="jax")),
        "DOC01": ("docs/x.md", "docs/x.md", DOC_SNIPPET, DOC_SNIPPET),
    }[case]
    port = lint.lint_source(port_path, port_src)
    ref = jlint.lint_source(ref_path, ref_src)
    assert _ids(port) == _ids(ref)
    assert port and {v.rule for v in port} == {case}


def test_host01_also_flags_triton_and_accepts_lazy_imports():
    src = ("import triton\n\n\ndef f():\n    import torch\n"
           "    return torch.zeros(1)\n")
    assert _ids(lint.lint_source("src/repro_torch/obs/x.py", src)) == \
        [("HOST01", 1)]
    # outside the host-only scope a module-level torch import is fine
    assert not lint.lint_source("src/repro_torch/serving/scheduler.py",
                                "import torch\n")


SYNC_PORT_SNIPPET = '''\
import numpy as np
import torch


class Sched:
    def _dispatch(self, tier, staged):
        a = tier.deltas.tolist()
        torch.cuda.synchronize()
        self.stream.synchronize()
        b = tier.state.cpu()
        c = staged.metrics.numpy()
        d = bool(tier.deltas.any())
        e = np.asarray(tier.logits)
        return a, b, c, d, e

    def _stage_body(self, tier):
        events_t = torch.zeros(3, pin_memory=False)
        events = events_t.numpy()
        n = int(events.sum())
        return n

    def _fetch(self, fl):
        return fl.flat.cpu().numpy()

    def step(self):
        # lint: ok SYNC01 the one sanctioned read-back
        return self.metrics.item()
'''


def test_sync01_port_rules():
    got = _ids(lint.lint_source("src/repro_torch/serving/scheduler.py",
                                SYNC_PORT_SNIPPET))
    assert got == [("SYNC01", n) for n in (7, 8, 9, 10, 11, 12, 13)]


def test_sync01_passes_the_schedulers_staging_buffers_and_fetch():
    """The real scheduler: ``_stage_body`` turns its pinned host buffers
    into numpy views and ``_fetch`` makes the one ``.cpu()``; neither is a
    finding."""
    path = "src/repro_torch/serving/scheduler.py"
    text = (ROOT / path).read_text()
    assert "events_t.numpy()" in text and "flat.cpu()" in text
    assert not lint.lint_source(path, text)


def test_port_tree_lints_clean_against_its_baseline():
    violations = lint.lint_paths(ROOT, lint.DEFAULT_PATHS)
    entries = lint.load_baseline(ROOT / lint.DEFAULT_BASELINE)
    new, stale = lint.apply_baseline(violations, entries)
    assert not new, "\n".join(v.render() for v in new)
    assert not stale
    assert [(v.rule, v.path) for v in violations] == [
        ("OBS01", "src/repro_torch/serving/telemetry.py")]


def test_baseline_keeps_the_references_reason():
    port = json.loads((ROOT / lint.DEFAULT_BASELINE).read_text())["entries"]
    ref = json.loads((ROOT / jlint.DEFAULT_BASELINE).read_text())["entries"]
    assert [(e["rule"], e["line_text"], e["reason"]) for e in port] == \
        [(e["rule"], e["line_text"], e["reason"]) for e in ref]


def test_cli_exit_status_and_json(capsys):
    assert lint.main(["--baseline", "--json", "-"]) == 0
    doc = json.loads(capsys.readouterr().out.split("\n0 violation")[0])
    assert doc["schema"] == "repro-lint/1" and doc["violations"] == []
    assert lint.main(["src/repro_torch/serving/telemetry.py"]) == 1
