"""The reference's seven demos on the port (``examples/torch/``), each run
with ``--device cpu`` at its smallest flags in a subprocess of its own:
exit 0, the reference demo's contract, and a ``kernels {...}`` line whose
counts are all 0 (on the CPU every kernel wrapper runs its plain version;
the card's launches are gated by ``chip_smoke.py``).

* ``quickstart``: both runs' losses fall;
* ``train_lm``: the loss falls;
* ``serve_decode``: two runs give the same tokens;
* ``snn_ossl_demo``: the modeled power and the skip rate are printed;
* ``stream_serving_demo``: every stream retires and one chunk fn serves
  the run (``compiled variants 1``);
* ``obs_smoke``: ``OK``;
* ``elastic_recovery_demo``: the run with two lost nodes resumes bit for
  bit (``final states bitwise identical: True``) and the straggler is
  flagged.

The demos run in parallel (two threads each).
"""
import concurrent.futures
import json
import os
import re
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLEET_ENV = ("COORDINATOR_ADDRESS", "PROCESS_COUNT", "PROCESS_ID")

# name: (demo, flags)
RUNS = {
    "quickstart": ("quickstart", ["--steps", "20"]),
    "train_lm": ("train_lm", ["--preset", "cpu-small", "--steps", "20",
                              "--seq", "32", "--batch", "4"]),
    "serve_decode": ("serve_decode", ["--new", "6"]),
    "serve_decode_again": ("serve_decode", ["--new", "6"]),
    "snn_ossl_demo": ("snn_ossl_demo", ["--samples", "3"]),
    "stream_serving_demo": ("stream_serving_demo", []),
    "obs_smoke": ("obs_smoke", []),
    "elastic_recovery_demo": ("elastic_recovery_demo", ["--steps", "9"]),
}


def _run(demo, flags):
    env = {k: v for k, v in os.environ.items() if k not in _FLEET_ENV}
    env.update(PYTHONPATH=os.path.join(_ROOT, "src"), OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, os.path.join(_ROOT, "examples", "torch",
                                      demo + ".py"), *flags,
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)


@pytest.fixture(scope="module")
def outputs():
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(_run, *spec) for name, spec in RUNS.items()}
        return {name: f.result() for name, f in futs.items()}


def _stdout(outputs, name):
    out = outputs[name]
    assert out.returncode == 0, out.stdout + out.stderr[-4000:]
    kern = [l for l in out.stdout.splitlines() if l.startswith("kernels ")]
    assert len(kern) == 1, out.stdout
    counts = json.loads(kern[0][len("kernels "):])
    assert {"nm_spmm", "lif", "wu_outer", "wu_outer_slots", "flash_fwd",
            "flash_bwd_dkv", "flash_bwd_dq"} <= set(counts)
    assert not any(counts.values())     # the CPU launches no kernel
    return out.stdout


def _losses(text, pattern):
    return [(float(a), float(b)) for a, b in re.findall(pattern, text)]


def test_quickstart_losses_fall(outputs):
    text = _stdout(outputs, "quickstart")
    runs = _losses(text, r"loss ([\d.]+) -> ([\d.]+)")
    assert len(runs) == 2 and all(b < a for a, b in runs), text
    assert "[dense]" in text and "[nm_sparse+dsst+gating]" in text
    assert text.rstrip().splitlines()[-1].startswith("done")


def test_train_lm_loss_falls(outputs):
    text = _stdout(outputs, "train_lm")
    assert "arch=lm-8m" in text
    (a, b), = _losses(text, r"final: loss ([\d.]+) -> ([\d.]+)")
    assert b < a, text


def test_serve_decode_gives_the_same_tokens_twice(outputs):
    first = _stdout(outputs, "serve_decode")
    again = _stdout(outputs, "serve_decode_again")
    assert "arch=mixtral-8x7b-reduced family=moe" in first

    def seq(text):
        line, = [l for l in text.splitlines()
                 if l.startswith("first sequence:")]
        return json.loads(line.split(":", 1)[1])
    assert seq(first) == seq(again) and len(seq(first)) == 16 + 6


def test_snn_ossl_demo_reports_power_and_gating(outputs):
    text = _stdout(outputs, "snn_ossl_demo")
    assert "network (64)-64-64-10" in text
    assert re.search(r"modeled power @0.6V/20MHz: [\d.]+ µW", text)
    assert re.search(r"WU skip rate \(gating\): [\d.]+", text)


def test_stream_serving_demo_builds_one_chunk_fn(outputs):
    text = _stdout(outputs, "stream_serving_demo")
    assert re.search(r"retired 8 streams .* compiled variants 1$", text,
                     re.M), text
    assert re.search(r"topology: [1-9]\d* live epochs", text), text


def test_obs_smoke_ok(outputs):
    text = _stdout(outputs, "obs_smoke")
    assert text.rstrip().splitlines()[-1] == "OK"


def test_elastic_recovery_resumes_bit_for_bit(outputs):
    text = _stdout(outputs, "elastic_recovery_demo")
    assert "restarts: 2" in text
    assert "final states bitwise identical: True" in text
    assert "straggler policy flags replicas: [3]" in text
