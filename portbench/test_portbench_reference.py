"""The reference against the port's plain path at reduced sizes on the
CPU, through the harness's own drivers and adapters: in f32 the program
and the reference compute the same function, so the training numbers
read round-off and the served tokens are the reference's best."""
import time

import pytest
import torch

from portbench.adapters import common as adapt
from portbench.core import compare
from portbench.drivers import prefill, train
from portbench.drivers.common import Family

SEED = 2**31 + 12345          # more than 32 signed bits hold


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_adapter_gives_the_ports_tree(cell_factory, family):
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import tree_map
    cell = cell_factory(family, "train")
    fam = Family(cell.config["port"])
    tree = fam.port_params(SEED, "cpu")
    want = T.init_params_shaped(fam.model_config())
    shapes = tree_map(lambda x: (tuple(x.shape), x.dtype), tree)
    assert shapes == tree_map(lambda x: (tuple(x.shape), x.dtype), want)
    for leaf in fam.leaves:
        assert torch.equal(fam.view(tree, leaf.name),
                           fam.getter(SEED, "cpu")(leaf.name))
    assert adapt.view(tree, fam.adapter.MAP, "l1.norm1").shape == (64,)


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_training_step_matches_the_reference_in_f32(cell_factory, family):
    cell = cell_factory(family, "train")
    res = train.run(cell, SEED, 0.05, False, "cpu", time.perf_counter())
    assert res["attempted"] >= 1 and res["failed"] == 0
    for name, value in res["numbers"].items():
        assert value < 1e-5, (name, value)
    ref, prog = res["readings"]["reference"], res["readings"]["program"]
    assert len(ref["loss"]) == 3 and prog["loss"][0] == \
        pytest.approx(ref["loss"][0], rel=1e-6)
    assert set(ref["grad_norm"]) == {leaf.name for leaf in
                                     Family(cell.config["port"]).leaves}


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_prefill_serves_the_references_best_token_in_f32(cell_factory,
                                                         family):
    cell = cell_factory(family, "prefill")
    res = prefill.run(cell, SEED, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"] and res["numbers"]["gap"] == 0.0
    t = cell.traffic
    assert len(res["readings"]["gaps"]) == sum(
        t["batch_tokens"] // t["lengths"][b % 8]
        for b in res["readings"]["batches"])
    assert len(res["readings"]["batches"]) == min(
        8, cell.settings["sample_batches"])
    assert res["metrics"]["prefill_tokens_per_s"] > 0
    assert 64 in [cell.traffic["lengths"][b % 8]
                  for b in res["readings"]["batches"]]


def test_comparison_measures():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    assert compare.norm_gap({"a": 1.1, "b": 2.0, "c": 1e-6}, ref) == \
        pytest.approx(0.1)
    # a leaf far below the median is measured against the median
    assert compare.norm_gap({"a": 1.0, "b": 2.0, "c": 0.1}, ref) == \
        pytest.approx(0.1, rel=1e-4)
    assert compare.quiet_leaves({"a": 1.0, "b": 2.0, "c": 1e-6}) == ["c"]
    # the leaves' 90th percentile: of 20 leaves, the 3rd widest gap
    gaps = compare.leaf_gaps({f"l{i}": 1.0 + i / 100 for i in range(20)},
                             {f"l{i}": 1.0 for i in range(20)})
    assert compare.p90(gaps) == pytest.approx(0.18)
    assert gaps[-1] == pytest.approx(0.19)
    assert compare.p90([0.5]) == 0.5
    assert compare.loss_gap([10.0, 9.0], [10.0, 9.9]) == \
        pytest.approx(0.9 / 9.9)
    out = compare.judge({"x": float("nan"), "y": 0.5}, {"x": 1.0, "y": 1.0})
    assert not out["correct"] and out["checks"]["y"] == \
        {"value": 0.5, "limit": 1.0}
    assert compare.judge({"y": 0.5}, {"y": 1.0})["correct"]
    assert not compare.judge({"y": 0.5}, {})["correct"]
