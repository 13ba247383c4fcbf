"""The check's control and its planted faults come out not correct.

The control is the reference computed in fp8, put in the program's place
(``drivers/<kind>.control``); each fault is planted under the timed path
(``faults.py``) while the rest of a run goes on as the harness drives it
(only its look for a card is skipped). The cells are held to the limits
of the benchmark's own cells of their family and kind; the hybrid
family's training, which has no cell and no limits, to the readings of a
sound run of the same size."""
import time

import pytest

from portbench import faults
from portbench.core import compare
from portbench.drivers import prefill, train

SEEDS = (2**31 + 12345, 3_000_000_007)


@pytest.mark.parametrize("fault", sorted(faults.PREFILL_FAULTS))
@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_prefill_faults_are_not_correct(cell_factory, family, fault):
    cell = cell_factory(family, "prefill")
    res = prefill.run(cell, SEEDS[0], 0.1, False, "cpu", time.perf_counter(),
                      wrap_generate=faults.PREFILL_FAULTS[fault])
    assert not res["correct"]
    for name, limit in cell.settings["limits"].items():
        assert res["numbers"][name] > 2 * limit


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_prefill_control_is_not_correct(cell_factory, family):
    # every batch of two cycles compared, so that fp8 puts another token
    # first somewhere
    cell = cell_factory(family, "prefill", vocab=4096, d_model=128)
    cell.settings["sample_batches"] = cell.traffic["pool"]
    for name, limit in cell.settings["limits"].items():
        worst = max(prefill.control(cell, s, "cpu")[0][name] for s in SEEDS)
        assert worst > limit, (name, worst, limit)


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_training_faults_read_far_above_a_sound_run(cell_factory, family):
    cell = cell_factory(family, "train")
    t0 = time.perf_counter()
    sound = train.run(cell, SEEDS[0], 0.01, False, "cpu", t0)["numbers"]
    still = train.run(cell, SEEDS[0], 0.01, False, "cpu", t0,
                      wrap_step=faults.state_unchanged)["numbers"]
    half = train.run(cell, SEEDS[0], 0.01, False, "cpu", t0,
                     wrap_step=faults.half_batch)["numbers"]
    assert still["grad"] == pytest.approx(1.0)
    assert still["change"] == pytest.approx(1.0)
    assert max(half.values()) > 100 * max(sound.values())


@pytest.mark.parametrize("fault", sorted(faults.TRAIN_FAULTS))
def test_training_faults_are_not_correct(cell_factory, fault):
    cell = cell_factory("moe", "train")
    assert cell.settings["limits"]
    t0 = time.perf_counter()
    assert train.run(cell, SEEDS[0], 0.01, False, "cpu", t0)["correct"]
    res = train.run(cell, SEEDS[0], 0.01, False, "cpu", t0,
                    wrap_step=faults.TRAIN_FAULTS[fault])
    assert not res["correct"]
    assert any(res["numbers"][n] > 2 * lim
               for n, lim in cell.settings["limits"].items())


def test_training_control_is_not_correct(cell_factory):
    cell = cell_factory("moe", "train")
    for s in SEEDS:
        numbers, _ = train.control(cell, s, "cpu")
        assert not compare.judge(numbers, cell.settings["limits"])["correct"]
